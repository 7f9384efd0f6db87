"""Dense co-occurrence sweep: the quadratic pair phase as a blocked int8 product.

The CIND test ``cooc(d, r) == support(d)`` is read off the co-occurrence matrix
cooc = Mᵀ M of the 0/1 line x capture membership matrix M.  The port holds Mᵀ
(captures x lines): a dep tile is a row slice, and both operands of every product
are contiguous along the lines, the K-major layout the card's int8 tensor cores
take.  Mᵀ is int8 on every device and every product accumulates in int32 (or an
exact float64 widening in the plain versions): one exact formulation.  The sweep
walks dep tiles; for each it launches K1 (``kernels.fused_cind_blocks``), which
sums the counts over the non-empty line blocks only and applies the verdict in
its epilogue, so the count matrix never reaches device memory.  The packed
verdict bits are then decoded to (dep, ref) index pairs on the device and only
those reach the host.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..obs import metrics

# Dep-tile width cap of the plan (the tile policy of the JAX package, kept so that
# both packages plan identical shapes).
DEFAULT_TILE = 4096
# Membership budget on the CPU: the JAX package's default, so that plans match.
CPU_M_BUDGET_BYTES = 6 << 30
# Row padding granule of M and column granule (every dep tile is a multiple).
LINE_MULT = 256
CAP_MULT = 128
# Widest capture axis the dense verification of the approximate strategies
# takes (the JAX package's one-shot ceiling, allatonce.SINGLE_SHOT_C).
SINGLE_SHOT_C = 16384
# Dep columns one kernel launch covers at most: the sweep joins adjacent
# scheduled tiles up to this width, so a narrow plan tile still fills the card.
LAUNCH_COLS = 1024


def round_up(n: int, mult: int) -> int:
    """Smallest multiple of `mult` >= max(n, 1)."""
    return -(-max(int(n), 1) // mult) * mult


def tile_for(c_pad: int, tile_max: int = DEFAULT_TILE) -> int:
    """Largest dep-tile width that divides `c_pad`, is a power-of-two multiple of
    CAP_MULT, and stays <= tile_max."""
    if c_pad % CAP_MULT:
        raise ValueError(f"c_pad {c_pad} is not a multiple of {CAP_MULT}")
    m = c_pad // CAP_MULT
    t = CAP_MULT * (m & -m)  # largest pow2 divisor of m, in columns
    return max(CAP_MULT, min(t, tile_max, c_pad))


def line_block_for(l_pad: int, cap: int = 1024) -> int:
    """Line-block granule of the sweep: the largest pow2 multiple of LINE_MULT
    dividing `l_pad`, capped at `cap` rows; `l_pad` itself when it is not a
    multiple of LINE_MULT.  Divisibility keeps every block start exact."""
    if l_pad % LINE_MULT:
        return l_pad
    m = l_pad // LINE_MULT
    return min(LINE_MULT * (m & -m), cap)


def cap_pad(num_caps: int, mult: int = CAP_MULT) -> int:
    """Capture-axis padding: the next multiple of the column granule."""
    return round_up(num_caps, mult)


@dataclasses.dataclass(frozen=True)
class DensePlan:
    """Shape plan + tile schedule for the dense sweep.

    ``dep_tile_starts`` enumerates the dep tiles that contain at least one real
    capture; all-padding tiles are never launched.
    """

    l_pad: int
    c_pad: int
    tile: int
    n_lines: int
    num_caps: int
    line_block: int
    dtype: str = "int8"

    @property
    def dep_tile_starts(self) -> tuple:
        return tuple(lo for lo in range(0, self.c_pad, self.tile)
                     if lo < self.num_caps)

    @property
    def n_tiles(self) -> int:
        return self.c_pad // self.tile

    @property
    def n_line_blocks(self) -> int:
        return self.l_pad // self.line_block

    @property
    def n_blocks(self) -> int:
        """(scheduled dep tile x line block) pairs of the full-range sweep."""
        return self.n_line_blocks * len(self.dep_tile_starts)

    @property
    def issued_flops(self) -> int:
        """2 x MACs of the scheduled tile sweep without block skipping."""
        return 2 * self.l_pad * self.c_pad * self.tile \
            * len(self.dep_tile_starts)

    @property
    def real_flops(self) -> int:
        return 2 * self.n_lines * self.num_caps * self.num_caps

    def describe(self) -> dict:
        return {
            "dtype": self.dtype,
            "l_real": self.n_lines, "l_pad": self.l_pad,
            "c_real": self.num_caps, "c_pad": self.c_pad,
            "tile": self.tile, "n_tiles": self.n_tiles,
            "n_tiles_skipped": self.n_tiles - len(self.dep_tile_starts),
            "line_block": self.line_block, "n_blocks": self.n_blocks,
            "issued_flops": self.issued_flops, "real_flops": self.real_flops,
        }


def m_budget_bytes(device) -> int:
    """Bytes M may take: half the card's free memory on CUDA, the JAX package's
    6 GiB on the CPU."""
    device = torch.device(device)
    if device.type == "cuda":
        return torch.cuda.mem_get_info(device)[0] // 2
    return CPU_M_BUDGET_BYTES


def dense_plan(n_lines: int, num_caps: int, device, tile: int = DEFAULT_TILE):
    """DensePlan for the dense sweep, or None when M does not fit the budget."""
    if n_lines == 0 or num_caps == 0:
        return None
    l_pad = round_up(n_lines, LINE_MULT)
    c_pad = cap_pad(num_caps)
    if l_pad * c_pad > m_budget_bytes(device):
        return None
    return DensePlan(l_pad=l_pad, c_pad=c_pad, tile=tile_for(c_pad, tile),
                     n_lines=n_lines, num_caps=num_caps,
                     line_block=line_block_for(l_pad))


def build_membership(line_gid, cap_id, valid, *, l_pad: int, c_pad: int):
    """Scatter the valid (line, capture) rows into the (c_pad, l_pad) int8 0/1
    matrix Mᵀ: row c holds capture c's lines.  Rows are masked before the
    scatter; duplicates set the same 1."""
    m_t = torch.zeros((c_pad, l_pad), dtype=torch.int8, device=line_gid.device)
    li = line_gid[valid].long()
    ci = cap_id[valid].long()
    if li.numel() and (int(li.max()) >= l_pad or int(ci.max()) >= c_pad
                       or int(li.min()) < 0 or int(ci.min()) < 0):
        raise ValueError("membership row out of the planned shape")
    m_t.view(-1)[ci * l_pad + li] = 1
    return m_t


def pack_bool(x):
    """(R, C) bool/0-1 -> (R, ceil(C/32)) int32 words, little bit order per word:
    bit r of word w is column 32 w + r (the uint32 words held as int32).  One
    int32 pass per bit position, so no temporary is wider than the words."""
    r, c = x.shape
    if c % 32:
        x = torch.nn.functional.pad(x.to(torch.uint8), (0, 32 - c % 32))
    lanes = x.reshape(r, -1, 32)
    words = torch.zeros(lanes.shape[:2], dtype=torch.int32, device=x.device)
    for b in range(32):
        words |= lanes[:, :, b].to(torch.int32) << b
    return words


def cooc_dot(a, b):
    """Exact (M, N) int32 product ``a @ b.T`` of 0/1 int8 operands a (M, K) and
    b (N, K), both contiguous along K.

    A plain product outside any kernel (the JAX package leaves its twin to XLA):
    ``torch._int_mm`` on the card (int8 in, int32 out; it takes M > 16 and K, N
    multiples of 8, and ``b.T`` is the column-major operand it wants), a float64
    widening on the CPU (exact: every count is at most K < 2^53).
    """
    if a.dtype != torch.int8 or b.dtype != torch.int8 or a.dim() != 2 \
            or b.dim() != 2 or a.shape[1] != b.shape[1]:
        raise ValueError(f"cooc_dot takes int8 (M, K) and (N, K), got "
                         f"{tuple(a.shape)} {a.dtype} and {tuple(b.shape)} "
                         f"{b.dtype}")
    if a.device.type == "cuda":
        (m, k), n = a.shape, b.shape[0]
        if m <= 16 or k % 8 or n % 8 or not a.is_contiguous() \
                or not b.is_contiguous():
            raise ValueError(f"torch._int_mm needs M > 16, K and N multiples "
                             f"of 8 and contiguous operands: M={m} K={k} N={n}")
        return torch._int_mm(a, b.T)
    return (a.to(torch.float64) @ b.to(torch.float64).T).to(torch.int32)


def stage_block_counts(m_t, *, kl: int, tile: int):
    """(l_pad//kl, c_pad//tile) int32 membership popcounts per (line block x dep
    tile) of Mᵀ: the record the block-skip schedule is built from."""
    c_pad, l_pad = m_t.shape
    blocks = m_t.reshape(c_pad // tile, tile, l_pad // kl, kl)
    return blocks.sum(dim=(1, 3), dtype=torch.int32).T.contiguous()


@dataclasses.dataclass(frozen=True)
class Launch:
    """One K1 launch of the sweep: dep columns [lo, lo + width) against every ref
    column, over the line blocks `block_ids` (host int32 array)."""

    lo: int
    width: int
    block_ids: np.ndarray


def sweep_launches(block_counts: np.ndarray, los, tile: int) -> list:
    """The sweep's launch schedule from the block popcounts.

    Dep tiles with no member in any line block are dropped (no verdict bit can
    set).  Adjacent scheduled tiles join into one launch up to LAUNCH_COLS
    columns; a launch visits the union of its tiles' non-empty line blocks, which
    is exact because a block that is empty for a tile adds zero to its counts.
    """
    out = []
    cur = None
    for lo in los:
        nz = np.flatnonzero(block_counts[:, lo // tile])
        if nz.size == 0:
            continue
        if cur is not None and cur[0] + cur[1] == lo \
                and cur[1] + tile <= max(LAUNCH_COLS, tile):
            cur = (cur[0], cur[1] + tile, np.union1d(cur[2], nz))
        else:
            if cur is not None:
                out.append(cur)
            cur = (lo, tile, nz)
    if cur is not None:
        out.append(cur)
    return [Launch(lo, w, np.asarray(b, np.int32)) for lo, w, b in out]


def _inbounds(packed, rows: int, cols: int):
    """Zero out words outside the [0, rows) x [0, cols) bit region."""
    word_idx = torch.arange(packed.shape[1], device=packed.device)
    partial = torch.clamp(cols - word_idx * 32, 0, 32).to(torch.int64)
    col_mask = (torch.ones_like(partial) << partial) - 1  # int64: 32 is fine
    col_mask = torch.where(col_mask >= 1 << 31, col_mask - (1 << 32), col_mask) \
        .to(torch.int32)
    row_ok = torch.arange(packed.shape[0], device=packed.device) < rows
    return torch.where(row_ok[:, None], packed & col_mask[None, :], 0)


def unpack_bits(packed):
    """(R, W) int32 words -> (R, 32 W) bool, little bit order."""
    shifts = torch.arange(32, dtype=torch.int32, device=packed.device)
    bits = (packed[:, :, None] >> shifts) & 1
    return bits.reshape(packed.shape[0], -1).bool()


def packed_count(packed, rows: int, cols: int) -> int:
    """Set bits in the in-bounds region."""
    return int(unpack_bits(_inbounds(packed, rows, cols)).sum())


def packed_nonzero(packed, rows: int, cols: int):
    """(row, col) int64 indices of the in-bounds set bits, row-major order."""
    idx = torch.nonzero(unpack_bits(_inbounds(packed, rows, cols)))
    return idx[:, 0], idx[:, 1]


# Bits of packed relation one decode batch holds on the device (each tile is
# unpacked to one byte per bit for its count and its nonzero); a larger
# relation decodes in row strips.  The JAX package's bound.
EXTRACT_DEVICE_ELEMS = 1 << 28
# Device bytes of decoded index pairs pending before one batched pull.
PULL_BYTES_BUDGET = 1 << 28


def extract_packed(packed, rows: int, cols: int):
    """Decode a packed bool relation -> host (row, col) int64 index arrays.

    The set bits are counted and decoded on the device, so only their index
    pairs reach the host, never the bit matrix.  A relation over
    EXTRACT_DEVICE_ELEMS bits decodes in row strips that each stay under it.
    """
    words = packed.shape[1]
    total_bits = packed.shape[0] * words * 32
    if total_bits <= EXTRACT_DEVICE_ELEMS:
        return extract_packed_iter([lambda: (packed, rows, cols)],
                                   total_bits)[0]
    h = max(1, EXTRACT_DEVICE_ELEMS // (words * 32))
    los = list(range(0, min(rows, packed.shape[0]), h))

    def make(lo):
        return lambda: (packed[lo:lo + h], min(rows - lo, h), cols)

    strips = extract_packed_iter([make(lo) for lo in los],
                                 min(h * words * 32, EXTRACT_DEVICE_ELEMS))
    out_d = [d + lo for lo, (d, _) in zip(los, strips) if d.size]
    out_r = [r for d, r in strips if d.size]
    if not out_d:
        z = np.zeros(0, np.int64)
        return z, z
    return np.concatenate(out_d), np.concatenate(out_r)


def extract_packed_iter(thunks, tile_bits: int):
    """Decode a stream of packed tiles with batched host pulls.

    thunks: callables that each return one tile (packed, rows, cols); tiles may
    differ in shape, and `tile_bits` bounds every tile's packed bits.  Tiles go
    in batches of EXTRACT_DEVICE_ELEMS bits: one pull brings a batch's set-bit
    counts, empty tiles are skipped, and the index pairs of the others come in
    pulls of at most PULL_BYTES_BUDGET bytes (``torch.nonzero`` itself reads
    each tile's size on the host, which the JAX package's sized nonzero does
    not).  Returns [(rows, cols)] host int64 arrays in thunk order.
    """
    if tile_bits > EXTRACT_DEVICE_ELEMS:
        return [extract_packed(*t()[:3]) for t in thunks]
    out = [None] * len(thunks)
    batch = max(1, EXTRACT_DEVICE_ELEMS // max(tile_bits, 1))
    empty = (np.zeros(0, np.int64), np.zeros(0, np.int64))
    for lo in range(0, len(thunks), batch):
        group = [(lo + j, *t()[:3]) for j, t in enumerate(thunks[lo:lo + batch])]
        counts = torch.stack([
            unpack_bits(_inbounds(p, r, c)).sum() for _, p, r, c in group])
        pend, pend_bytes = [], 0

        def drain():
            nonlocal pend, pend_bytes
            if pend:
                flat = torch.cat([x for _, d, r in pend for x in (d, r)]).cpu()
                at = 0
                for k, d, _ in pend:
                    n = d.numel()
                    out[k] = (flat[at:at + n].numpy(),
                              flat[at + n:at + 2 * n].numpy())
                    at += 2 * n
            pend, pend_bytes = [], 0

        for n, (k, p, r, c) in zip(counts.tolist(), group):
            if not n:
                out[k] = empty
                continue
            pend.append((k, *packed_nonzero(p, r, c)))
            pend_bytes += 16 * n
            if pend_bytes >= PULL_BYTES_BUDGET:
                drain()
        drain()
    return out


def union_line_counts(m_t, mask, rows_per_step: int = 2048):
    """Per-line count of the mask-flagged captures: the (l_pad,) int32
    product maskᵀ Mᵀ, summed over row slices of Mᵀ so that no temporary
    exceeds `rows_per_step` rows.  A plain torch product; no host sync."""
    out = torch.zeros(m_t.shape[1], dtype=torch.int32, device=m_t.device)
    mask = mask.to(torch.int8)
    for lo in range(0, m_t.shape[0], rows_per_step):
        sl = slice(lo, lo + rows_per_step)
        out += (m_t[sl] * mask[sl, None]).sum(dim=0, dtype=torch.int32)
    return out


def fused_cind_tile(m_t, lo: int, width: int, cols: dict, rows: dict,
                    block_ids, n_real):
    """One launch of K1 over dep rows [lo, lo + width) of Mᵀ and every ref.

    `cols` holds the per-capture int32 columns over the whole capture axis
    (sup, ok, gid, code, v1, v2) and `rows` the per-ref rows (ridx, code, v1);
    the schedule is as ``kernels.fused_cind_blocks`` takes it.  Returns (packed
    (width, c_pad // 32) int32, popc (width,) int32).
    """
    from . import kernels

    sl = slice(lo, lo + width)
    return kernels.fused_cind_blocks(
        m_t[sl], m_t, cols["sup"][sl], cols["ok"][sl], cols["gid"][sl],
        cols["code"][sl], cols["v1"][sl], cols["v2"][sl],
        rows["ridx"], rows["code"], rows["v1"], block_ids, n_real,
        ref_lo=0, ref_chunk=m_t.shape[0])


def sweep_operands(dep_count, cap_code, cap_v1, cap_v2, min_support: int):
    """The kernel's per-capture columns and per-ref rows from the (c_pad,)
    capture tables (all int32 on M's device)."""
    sup = dep_count.to(torch.int32).contiguous()
    code = cap_code.to(torch.int32).contiguous()
    v1 = cap_v1.to(torch.int32).contiguous()
    v2 = cap_v2.to(torch.int32).contiguous()
    ridx = torch.arange(sup.numel(), dtype=torch.int32, device=sup.device)
    cols = dict(sup=sup, ok=(sup >= int(min_support)).to(torch.int32),
                gid=ridx, code=code, v1=v1, v2=v2)
    rows = dict(ridx=ridx, code=code, v1=v1)
    return cols, rows


def discover_pairs_dense(m_t, dep_count, cap_code, cap_v1, cap_v2,
                         min_support: int, plan: DensePlan, stats=None):
    """Run the tiled CIND sweep; return host (dep_id, ref_id, support) int64 arrays.

    m_t: (c_pad, l_pad) int8 membership Mᵀ; dep_count/cap_*: (c_pad,)
    per-capture support and identity columns on its device.  The block
    popcounts prune the schedule first (dep tiles whose captures occur in no
    line are dropped, and each launch visits only its non-empty line blocks);
    all launches' schedules are checked on the host and reach the device in one
    copy, then every launch is queued back to back with no host sync between
    them, one host pull brings all launches' set-bit counts, and only launches
    with set bits are decoded.
    """
    from . import kernels

    kl, tile, num_caps = plan.line_block, plan.tile, plan.num_caps
    los = plan.dep_tile_starts
    block_counts = stage_block_counts(m_t, kl=kl, tile=tile).cpu().numpy()
    launches = sweep_launches(block_counts, los, tile)
    empty = block_counts[:, [lo // tile for lo in los]] == 0
    n_blocks_skipped = int(empty.sum())
    n_tiles_data_skipped = int(empty.all(axis=0).sum())
    metrics.gauge_set(stats, "n_blocks_skipped", n_blocks_skipped)
    metrics.struct_update(stats, "dense_plan",
                          n_blocks_skipped=n_blocks_skipped,
                          n_tiles_data_skipped=n_tiles_data_skipped,
                          n_launches=len(launches))

    cols, rows = sweep_operands(dep_count, cap_code, cap_v1, cap_v2,
                                min_support)
    schedules = kernels.upload_schedules(
        [(ln.block_ids, ln.block_ids.size) for ln in launches],
        plan.n_line_blocks, m_t.device)
    outs = [fused_cind_tile(m_t, ln.lo, ln.width, cols, rows, *sched)
            for ln, sched in zip(launches, schedules)]
    counts = (torch.stack([popc.sum() for _, popc in outs]).cpu().numpy()
              if outs else np.zeros(0, np.int64))
    deps, refs = [], []
    for ln, (packed, _), n in zip(launches, outs, counts):
        if not n:
            continue
        d, r = packed_nonzero(packed, min(num_caps - ln.lo, ln.width), num_caps)
        deps.append(d + ln.lo)
        refs.append(r)
    if not deps:
        z = np.zeros(0, np.int64)
        return z, z, z
    dep_id = torch.cat(deps)
    ref_id = torch.cat(refs)
    support = dep_count[dep_id].long()
    return (dep_id.cpu().numpy(), ref_id.cpu().numpy(),
            support.cpu().numpy())
