"""Dense co-occurrence sweep: the quadratic pair phase as a blocked int8 product.

The CIND test ``cooc(d, r) == support(d)`` is read off the co-occurrence matrix
cooc = Mᵀ M of the 0/1 line x capture membership matrix M.  M is int8 on every
device and every product accumulates in int32 (or an exact float64 widening in the
plain versions): one exact formulation.  The sweep walks dep tiles; for each it
launches K1 (``kernels.fused_cind_blocks``), which sums the counts over the
non-empty line blocks only and applies the verdict in its epilogue, so the count
matrix never reaches device memory.  The packed verdict bits are then decoded to
(dep, ref) index pairs on the device and only those reach the host.
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
    """Scatter the valid (line, capture) rows into the (l_pad, c_pad) int8 0/1
    matrix.  Rows are masked before the scatter; duplicates set the same 1."""
    m = torch.zeros((l_pad, c_pad), dtype=torch.int8, device=line_gid.device)
    li = line_gid[valid].long()
    ci = cap_id[valid].long()
    if li.numel() and (int(li.max()) >= l_pad or int(ci.max()) >= c_pad
                       or int(li.min()) < 0 or int(ci.min()) < 0):
        raise ValueError("membership row out of the planned shape")
    m.view(-1)[li * c_pad + ci] = 1
    return m


def pack_bool(x):
    """(R, C) bool/0-1 -> (R, ceil(C/32)) int32 words, little bit order per word:
    bit r of word w is column 32 w + r (the uint32 words held as int32)."""
    r, c = x.shape
    x = x.to(torch.int64)
    if c % 32:
        x = torch.nn.functional.pad(x, (0, 32 - c % 32))
        c = x.shape[1]
    lanes = x.reshape(r, c // 32, 32)
    weights = torch.ones(32, dtype=torch.int64, device=x.device) \
        << torch.arange(32, device=x.device)
    words = (lanes * weights).sum(dim=2)
    return torch.where(words >= 1 << 31, words - (1 << 32), words) \
        .to(torch.int32)


def stage_block_counts(m, *, kl: int, tile: int):
    """(l_pad//kl, c_pad//tile) int32 membership popcounts per (line block x dep
    tile): the record the block-skip schedule is built from."""
    l_pad, c_pad = m.shape
    blocks = m.reshape(l_pad // kl, kl, c_pad // tile, tile)
    return blocks.sum(dim=(1, 3), dtype=torch.int32)


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


def fused_cind_tile(m, lo: int, width: int, cols: dict, rows: dict,
                    block_ids: np.ndarray):
    """One launch of K1 over dep columns [lo, lo + width) and every ref column.

    `cols` holds the per-capture int32 columns over the whole capture axis
    (sup, ok, gid, code, v1, v2) and `rows` the per-ref rows (ridx, code, v1).
    Returns (packed (width, c_pad // 32) int32, popc (width,) int32).
    """
    from . import kernels

    dev = m.device
    c_pad = m.shape[1]
    sl = slice(lo, lo + width)
    bids = torch.as_tensor(block_ids, dtype=torch.int32).to(dev)
    n_real = torch.tensor([block_ids.size], dtype=torch.int32).to(dev)
    return kernels.fused_cind_blocks(
        m[:, sl], m, cols["sup"][sl], cols["ok"][sl], cols["gid"][sl],
        cols["code"][sl], cols["v1"][sl], cols["v2"][sl],
        rows["ridx"], rows["code"], rows["v1"], bids, n_real,
        ref_lo=0, ref_chunk=c_pad)


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


def discover_pairs_dense(m, dep_count, cap_code, cap_v1, cap_v2,
                         min_support: int, plan: DensePlan, stats=None):
    """Run the tiled CIND sweep; return host (dep_id, ref_id, support) int64 arrays.

    m: (l_pad, c_pad) int8 membership; dep_count/cap_*: (c_pad,) per-capture
    support and identity columns on M's device.  The block popcounts prune the
    schedule first (dep tiles whose captures occur in no line are dropped, and
    each launch visits only its non-empty line blocks); then every launch is
    issued, one host pull brings all launches' set-bit counts, and only launches
    with set bits are decoded.
    """
    kl, tile, num_caps = plan.line_block, plan.tile, plan.num_caps
    los = plan.dep_tile_starts
    block_counts = stage_block_counts(m, kl=kl, tile=tile).cpu().numpy()
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
    outs = [fused_cind_tile(m, ln.lo, ln.width, cols, rows, ln.block_ids)
            for ln in launches]
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
