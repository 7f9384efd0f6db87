"""Hand-written CUDA kernels of the port, their wrappers and plain versions.

Each wrapper takes the inputs of the TPU kernel it replaces.  A tensor on the CPU
goes to the kernel's plain PyTorch version in this module; a tensor on a CUDA device
launches the kernel (built from ``csrc/`` at first use) or raises.  ``LAUNCHES``
counts the kernel launches per wrapper, so a run can show that its main path went
through the kernels.

K1 ``fused_cind_blocks`` replaces ``rdfind_tpu/ops/pallas_kernels.py:
fused_cind_blocks``: one (tile x ref_chunk) block of the dense CIND sweep on the
K-major membership Mᵀ, with the co-occurrence counts summed over the scheduled
line blocks only and the CIND verdict packed to 32-bit words
(``cooc.pack_bool``'s layout).  Given K3's block counts, each 128 x 256 piece
of the block sums only the scheduled line blocks where both its dep rows and
its ref rows have members (``k1_visits``), and counts the blocks it visits.

K2 ``packed_contains_matrix`` replaces ``pallas_kernels.packed_contains_matrix``:
the Bloom containment test of the approximate strategies on packed words.  P1
``repeat_probe`` and P2 ``pipeline_probe`` replace the TPU compiler probes
``_repeat_is_tile`` and ``emit_pipeline_supported``; they are built into K2's
library and ``check_contains_library`` runs both before the first candidate pass
on a device.

K3 ``membership_counts`` replaces no TPU kernel: the sums the JAX package leaves
to XLA reductions over M (a capture's support, the frequent captures of each
line, the block popcounts of the sweep's schedule), read off the int8 Mᵀ in
place.  A torch sum with ``dtype=torch.int32`` casts its whole input first, an
int32 copy of Mᵀ four times its size; K3 writes nothing wider than its int32
outputs, and its plain versions widen one bounded slab of rows at a time.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import conditions as cc
from . import build, cooc

CIND_BLOCK_D = 128
CIND_BLOCK_R = 128
CIND_KC = 128  # lines per pipeline stage of K1: a line block is a multiple
# Dep and ref rows of one K1 CTA: the pieces whose line blocks k1_visits judges.
CIND_CTA_D = 128
CIND_CTA_R = 256
# Most CTAs (a cluster) that share one K1 piece, and the line blocks each CTA
# of a shared piece keeps at least (k1_split).  On one H100, LUBM(100)'s sweep
# took 230 / 202 / 193 / 204 ms at 1 / 2 / 4 / 8 CTAs a piece, and LUBM(1)'s
# 1.16 / 1.41 / 2.67 / 6.35 ms (schedules of at most 92 blocks).
K1_SPLIT_MAX = 4
K1_SPLIT_BLOCKS = 64
CONTAINS_BLOCK_D = 64
CONTAINS_BLOCK_R = 64

# Elements of Mᵀ that K3's plain versions widen to int32 at a time.
MEMBERSHIP_SLAB_ELEMS = 1 << 24

LAUNCHES = {"fused_cind_blocks": 0, "packed_contains_matrix": 0,
            "repeat_probe": 0, "pipeline_probe": 0, "membership_counts": 0}
# The CUDA symbol of each wrapper's kernel (csrc/), as a profiler trace names
# its device events (K3's two kernels share one prefix).
SYMBOLS = {"fused_cind_blocks": "fused_cind_kernel",
           "packed_contains_matrix": "contains_kernel",
           "repeat_probe": "repeat_probe_kernel",
           "pipeline_probe": "pipeline_probe_kernel",
           "membership_counts": "membership_counts_"}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _fused_kl(l_pad: int) -> int:
    """Rows per line block: the dense plan's granule, so kernel and schedule agree."""
    return cooc.line_block_for(l_pad)


def check_schedule(block_ids: np.ndarray, n_real: int, n_blocks: int) -> None:
    """Raise unless the first `n_real` entries of the host array `block_ids` are
    line-block ids in [0, n_blocks).  Host numpy only: no device sync."""
    block_ids = np.asarray(block_ids)
    if block_ids.ndim != 1 or not 0 <= n_real <= block_ids.size or (
            n_real and (block_ids[:n_real].min() < 0
                        or block_ids[:n_real].max() >= n_blocks)):
        raise ValueError(f"block schedule out of range: n_real={n_real}, "
                         f"{block_ids.size} entries, {n_blocks} line blocks")


def upload_schedules(schedules, n_blocks: int, device) -> list:
    """Each (block_ids host array, n_real) pair as K1's device operands, checked
    on the host and moved in one copy: [(block_ids (nk,) int32, n_real (1,)
    int32), ...], views of one buffer on `device`."""
    parts, spans, at = [], [], 0
    for block_ids, n_real in schedules:
        check_schedule(block_ids, n_real, n_blocks)
        parts += [np.array([n_real], np.int32),
                  np.asarray(block_ids, np.int32).reshape(-1)]
        spans.append((at, at + 1, at + 1 + parts[-1].size))
        at = spans[-1][2]
    if not spans:
        return []
    buf = torch.as_tensor(np.concatenate(parts)).to(device)
    return [(buf[b:e], buf[a:b]) for a, b, e in spans]


def _check_fused_inputs(m_dep, m, cols, rows, block_ids, n_real, ref_lo,
                        ref_chunk, block_counts, dep_lo, split, visited):
    if m_dep.dtype != torch.int8 or m.dtype != torch.int8:
        raise TypeError("membership operands must be int8")
    if m_dep.dim() != 2 or m.dim() != 2 or m_dep.shape[1] != m.shape[1]:
        raise ValueError(f"bad membership shapes {tuple(m_dep.shape)} and "
                         f"{tuple(m.shape)}")
    tile, l_pad = m_dep.shape
    c_pad = m.shape[0]
    kl = _fused_kl(l_pad)
    if m_dep.stride(1) != 1 or m.stride(1) != 1:
        raise ValueError("membership operands must be contiguous along the "
                         "lines")
    if (tile % CIND_BLOCK_D or ref_chunk <= 0 or ref_chunk % CIND_BLOCK_R
            or ref_lo % CIND_BLOCK_R or ref_lo < 0
            or ref_lo + ref_chunk > c_pad or l_pad % kl or kl % CIND_KC
            or dep_lo % CIND_BLOCK_D or dep_lo < 0 or dep_lo + tile > c_pad
            or not 1 <= split <= K1_SPLIT_MAX):
        raise ValueError(f"fused tile not block-aligned: tile={tile} "
                         f"dep_lo={dep_lo} ref_lo={ref_lo} "
                         f"ref_chunk={ref_chunk} c_pad={c_pad} l_pad={l_pad} "
                         f"split={split}")
    dev = m.device
    for name, t, n in ([(k, v, tile) for k, v in cols.items()]
                       + [(k, v, c_pad) for k, v in rows.items()]
                       + ([] if visited is None else [("visited", visited, 1)])):
        if t.dtype != torch.int32 or t.numel() != n or not t.is_contiguous() \
                or t.device != dev:
            raise ValueError(f"{name}: expected {n} contiguous int32 values on "
                             f"{dev}, got {tuple(t.shape)} {t.dtype} on {t.device}")
    shape = tuple(block_counts.shape)
    if block_counts.dtype != torch.int32 or len(shape) != 2 \
            or shape[0] != l_pad // kl or not shape[1] or c_pad % shape[1] \
            or (c_pad // shape[1]) % CIND_BLOCK_D \
            or not block_counts.is_contiguous() or block_counts.device != dev:
        raise ValueError(f"block_counts: expected contiguous int32 (line "
                         f"blocks {l_pad // kl}, plan tiles) on {dev} with "
                         f"tiles of 128 x k of the {c_pad} captures, got "
                         f"{tuple(block_counts.shape)} {block_counts.dtype} "
                         f"on {block_counts.device}")
    if m_dep.device != dev or block_ids.device != dev or n_real.device != dev:
        raise ValueError("all operands must be on one device")
    if block_ids.dtype != torch.int32 or block_ids.dim() != 1 \
            or not block_ids.is_contiguous():
        raise ValueError("block_ids must be a contiguous 1-D int32 tensor")
    if n_real.dtype != torch.int32 or n_real.numel() != 1:
        raise ValueError("n_real must be a one-element int32 tensor")
    if dev.type == "cpu":  # reading CPU values needs no device sync
        check_schedule(block_ids.numpy(), int(n_real.reshape(-1)[0]),
                       l_pad // kl)


def k1_visits(block_counts, blocks, *, count_tile: int, dep_lo: int,
              tile: int, ref_lo: int, ref_chunk: int):
    """Which scheduled line blocks each 128 x 256 piece of a K1 launch
    multiplies, as (dep (n, G), ref (n, H)) bool over the n line blocks
    `blocks` (int64), the G = tile / 128 dep pieces (rows dep_lo + [128 g,
    128 g + 128)) and the H = ceil(ref_chunk / 256) ref pieces (rows ref_lo +
    [256 h, 256 h + 256), within the chunk): piece (g, h) multiplies block i
    where dep[i, g] and ref[i, h].

    `block_counts` are K3's (line blocks, c_pad // count_tile) member counts.
    dep[i, g] says they are non-zero for the plan tile of the dep piece's rows,
    ref[i, h] for one of the (at most two) plan tiles the ref piece's rows
    span.  Elsewhere one side has no member in the block, which then adds zero
    to every count of the piece.
    """
    dev = block_counts.device
    live = block_counts[blocks] != 0  # (n, plan tiles)
    dep_tiles = (dep_lo + CIND_CTA_D * torch.arange(tile // CIND_CTA_D,
                                                    device=dev)) // count_tile
    first = CIND_CTA_R * torch.arange(-(-ref_chunk // CIND_CTA_R), device=dev)
    last = torch.clamp(first + CIND_CTA_R, max=ref_chunk) - 1
    return live[:, dep_tiles], (live[:, (ref_lo + first) // count_tile]
                                | live[:, (ref_lo + last) // count_tile])


def k1_split(dep, ref, n_sms: int) -> int:
    """CTAs that share each 128 x 256 output piece of a K1 launch (one
    thread-block cluster), from the line blocks its pieces multiply
    (``k1_visits``) on a card of `n_sms` SMs (0: no card, no split).

    With one CTA on an SM at a time, a launch lasts about its work spread over
    the SMs, or its heaviest piece if that is longer, and heavy pieces that
    start late add their length to the end.  S CTAs cut a piece S-fold, but
    each still judges the whole schedule, the cluster sums 128 KB of counts,
    and CTAs that load different blocks share less of L2 (a full membership
    split 4-fold took 848 ms against 617-659 unsplit, LUBM(100), one H100).
    So S doubles, up to K1_SPLIT_MAX, only while the heaviest piece is longer
    than half the spread work and keeps K1_SPLIT_BLOCKS blocks a CTA.
    """
    per_piece = dep.T.to(torch.float64) @ ref.to(torch.float64)  # (G, H)
    heaviest = int(per_piece.max()) if per_piece.numel() else 0
    total = int(per_piece.sum())
    split = 1
    while (split < K1_SPLIT_MAX and heaviest >= 2 * split * K1_SPLIT_BLOCKS
           and 2 * n_sms * heaviest > split * total):
        split *= 2
    return split


def fused_cind_blocks(m_dep, m, sup_col, ok_col, gid_col, dcode_col, dv1_col,
                      dv2_col, ridx_row, rcode_row, rv1_row, block_ids, n_real,
                      *, ref_lo: int, ref_chunk: int, block_counts,
                      dep_lo: int, split: int, visited=None):
    """(tile x ref_chunk) fused CIND verdict, packed, plus the per-dep popcount.

    m: (c_pad, l_pad) int8 K-major membership Mᵀ (captures x lines); m_dep:
    (tile, l_pad) int8 dep rows (a row slice ``m[lo:lo + tile]`` is fine: only
    its line stride must be 1).  The ``*_col`` operands are per-dep int32 columns
    of ``tile`` values (support, support >= min_support, global capture id,
    code, v1, v2), the ``*_row`` operands per-ref int32 rows of ``c_pad`` values
    (global id, code, v1).  The schedule is ``block_ids`` (nk,) int32 line-block
    ids of which the first ``n_real`` (a one-element int32 tensor) are visited,
    both on m's device, as ``upload_schedules`` makes them after checking them
    on the host.  A CUDA schedule is not read back here (that would sync the
    host): the kernel checks it itself and traps on a bad one.

    ``block_counts`` (K3's (l_pad // kl, c_pad // plan tile) int32, on m's
    device) narrows the schedule per 128 x 256 piece (``k1_visits``); m_dep
    is rows [dep_lo, dep_lo + tile) of m.  ``split`` CTAs (1 to
    K1_SPLIT_MAX, ``k1_split``) share each piece.  ``visited`` (a
    one-element int32 tensor) has the number of (piece, line block) products
    added to it.  None of them changes a bit of the output.

    Returns (packed, popc): (tile, ref_chunk // 32) int32 words where bit r of word
    w in row d is the verdict for ref column ref_lo + 32 w + r, and (tile,) int32
    set-bit counts per dep row.
    """
    if m.device.type not in ("cpu", "cuda"):
        raise ValueError(f"fused_cind_blocks runs on cuda or cpu, not {m.device}")
    cols = dict(sup_col=sup_col, ok_col=ok_col, gid_col=gid_col,
                dcode_col=dcode_col, dv1_col=dv1_col, dv2_col=dv2_col)
    rows = dict(ridx_row=ridx_row, rcode_row=rcode_row, rv1_row=rv1_row)
    _check_fused_inputs(m_dep, m, cols, rows, block_ids, n_real, ref_lo,
                        ref_chunk, block_counts, dep_lo, split, visited)
    if m.device.type == "cpu":
        return fused_cind_blocks_plain(
            m_dep, m, sup_col, ok_col, gid_col, dcode_col, dv1_col, dv2_col,
            ridx_row, rcode_row, rv1_row, block_ids, n_real, ref_lo=ref_lo,
            ref_chunk=ref_chunk, block_counts=block_counts, dep_lo=dep_lo,
            visited=visited)
    for t in (m_dep, m):
        if t.data_ptr() % 16 or t.stride(0) % 16:
            raise ValueError("membership operands need 16-byte aligned rows")
    tile, l_pad = m_dep.shape
    packed = torch.empty((tile, ref_chunk // 32), dtype=torch.int32,
                         device=m.device)
    popc = torch.zeros(tile, dtype=torch.int32, device=m.device)
    n_count_tiles = block_counts.shape[1]
    lib = build.load("fused_cind")
    stream = torch.cuda.current_stream(m.device).cuda_stream
    err = lib.fused_cind_launch(
        m_dep.data_ptr(), m_dep.stride(0), m.data_ptr(), m.stride(0), l_pad,
        *(t.data_ptr() for t in cols.values()),
        *(t.data_ptr() for t in rows.values()),
        block_ids.data_ptr(), n_real.data_ptr(), tile, ref_chunk,
        _fused_kl(l_pad), ref_lo, block_ids.numel(), block_counts.data_ptr(),
        m.shape[0] // n_count_tiles, n_count_tiles, dep_lo, split,
        packed.data_ptr(), popc.data_ptr(),
        None if visited is None else visited.data_ptr(), stream)
    if err != 0:
        raise RuntimeError("fused_cind launch failed: "
                           + lib.fused_cind_error_string(err).decode())
    LAUNCHES["fused_cind_blocks"] += 1
    return packed, popc


def fused_cind_blocks_plain(m_dep, m, sup_col, ok_col, gid_col, dcode_col,
                            dv1_col, dv2_col, ridx_row, rcode_row, rv1_row,
                            block_ids, n_real, *, ref_lo: int, ref_chunk: int,
                            block_counts=None, dep_lo: int = 0, visited=None):
    """Plain PyTorch version of fused_cind_blocks (same inputs and outputs, the
    schedule as tensors; the split is the kernel's alone).

    The membership lines of the scheduled line blocks are widened to float64 for
    the product, which is exact: every count is a sum of at most l_pad < 2^53
    unit terms.  Every piece sums the whole schedule, the kernel's skip aside:
    the skipped blocks add zero.  ``visited`` is given the products the kernel
    makes, counted from ``block_counts`` (``k1_visits``).
    """
    tile, l_pad = m_dep.shape
    kl = _fused_kl(l_pad)
    n = int(n_real.reshape(-1)[0])
    blocks = block_ids[:n].long()
    if visited is not None:
        dep, ref = k1_visits(block_counts, blocks,
                             count_tile=m.shape[0] // block_counts.shape[1],
                             dep_lo=dep_lo, tile=tile, ref_lo=ref_lo,
                             ref_chunk=ref_chunk)
        visited += (dep.sum(dim=1) * ref.sum(dim=1)).sum().to(torch.int32)
    lines = (blocks[:, None] * kl
             + torch.arange(kl, device=m.device)[None, :]).reshape(-1)
    a = m_dep[:, lines].to(torch.float64)
    b = m[ref_lo:ref_lo + ref_chunk, lines].to(torch.float64)
    counts = (a @ b.T).to(torch.int32)

    def col(x):
        return x.reshape(tile, 1)

    def row(x):
        return x.reshape(-1)[ref_lo:ref_lo + ref_chunk].reshape(1, ref_chunk)

    is_cind = (counts == col(sup_col)) & (col(ok_col) != 0)
    is_cind &= col(gid_col) != row(ridx_row)  # no self-pairs
    d_code, r_code = col(dcode_col), row(rcode_row)
    implied = cc.is_subcode(r_code, d_code) & torch.where(
        cc.first_subcapture(d_code) == r_code,
        row(rv1_row) == col(dv1_col), row(rv1_row) == col(dv2_col))
    v = is_cind & ~implied
    return cooc.pack_bool(v), v.sum(dim=1, dtype=torch.int32)


def _check_membership(name: str, m_t) -> None:
    if m_t.dtype != torch.int8 or m_t.dim() != 2:
        raise TypeError(f"{name} takes the (c_pad, l_pad) int8 membership, "
                        f"got {tuple(m_t.shape)} {m_t.dtype}")
    if m_t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name} runs on cuda or cpu, not {m_t.device}")
    if m_t.shape[0] > 1 and m_t.shape[1] > 1 and m_t.stride(1) != 1:
        raise ValueError(f"{name}: the membership must be contiguous along "
                         f"the lines")


def _membership_launch(m_t, symbol: str, *args) -> None:
    """Launch one of K3's kernels on the current stream of Mᵀ's device and
    raise on a non-zero status; count the launch."""
    c_pad, l_pad = m_t.shape
    if l_pad % 16 or m_t.data_ptr() % 16 or m_t.stride(0) % 16:
        raise ValueError(f"K3 needs 16-byte aligned membership rows and lines "
                         f"in multiples of 16: l_pad={l_pad}, row stride "
                         f"{m_t.stride(0)}")
    lib = build.load("membership")
    with torch.cuda.device(m_t.device):
        err = getattr(lib, symbol)(
            m_t.data_ptr(), m_t.stride(0), c_pad, l_pad, *args,
            torch.cuda.current_stream(m_t.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{symbol} failed: "
                           + lib.membership_error_string(err).decode())
    LAUNCHES["membership_counts"] += 1


def membership_row_counts(m_t, *, kl: int, tile: int):
    """K3's row pass: (dep_count (c_pad,), block_counts (l_pad // kl, c_pad //
    tile)) int32 of the int8 Mᵀ m_t (captures x lines).

    dep_count[c] sums row c; block_counts[b, t] sums line block b (lines [b
    kl, (b + 1) kl)) over the rows of dep tile t: the popcounts the sweep's
    block-skip schedule reads.  One read of Mᵀ on the card.
    """
    _check_membership("membership_row_counts", m_t)
    c_pad, l_pad = m_t.shape
    if kl <= 0 or l_pad % kl or tile <= 0 or c_pad % tile:
        raise ValueError(f"line block {kl} and dep tile {tile} must divide "
                         f"the membership's ({c_pad}, {l_pad})")
    if m_t.device.type == "cpu":
        return membership_row_counts_plain(m_t, kl=kl, tile=tile)
    if kl % 16 or tile % 128:
        raise ValueError(f"K3 takes line blocks in multiples of 16 and dep "
                         f"tiles in multiples of 128: kl={kl} tile={tile}")
    dep_count = torch.zeros(c_pad, dtype=torch.int32, device=m_t.device)
    block_counts = torch.zeros((l_pad // kl, c_pad // tile), dtype=torch.int32,
                               device=m_t.device)
    if m_t.numel():
        _membership_launch(m_t, "membership_rows_launch", kl, tile,
                           dep_count.data_ptr(), block_counts.data_ptr())
    return dep_count, block_counts


def membership_line_counts(m_t, mask):
    """K3's line pass: lens (l_pad,) int32, lens[l] = the sum of column l of
    Mᵀ over the rows whose `mask` (c_pad,) entry is set.  Only those rows are
    read."""
    _check_membership("membership_line_counts", m_t)
    c_pad, l_pad = m_t.shape
    if mask.shape != (c_pad,) or mask.device != m_t.device:
        raise ValueError(f"mask: expected ({c_pad},) on {m_t.device}, got "
                         f"{tuple(mask.shape)} on {mask.device}")
    if m_t.device.type == "cpu":
        return membership_line_counts_plain(m_t, mask)
    lens = torch.zeros(l_pad, dtype=torch.int32, device=m_t.device)
    if m_t.numel():
        mask8 = mask.to(torch.int8).contiguous()
        _membership_launch(m_t, "membership_lines_launch", mask8.data_ptr(),
                           lens.data_ptr())
    return lens


def membership_counts(m_t, min_support: int, *, kl: int, tile: int):
    """K3 ``membership_counts``: (dep_count, lens, block_counts), the int32
    aggregates of the dense sweep, in two reads of the int8 Mᵀ: the row pass
    (``membership_row_counts``), then the line pass over the frequent rows
    (dep_count >= min_support).  No host sync."""
    dep_count, block_counts = membership_row_counts(m_t, kl=kl, tile=tile)
    lens = membership_line_counts(m_t, dep_count >= int(min_support))
    return dep_count, lens, block_counts


def _slab_rows(l_pad: int) -> int:
    return max(1, MEMBERSHIP_SLAB_ELEMS // max(l_pad, 1))


def membership_row_counts_plain(m_t, *, kl: int, tile: int):
    """Plain PyTorch version of membership_row_counts: one slab of rows
    (MEMBERSHIP_SLAB_ELEMS entries) widened to int32 at a time, summed per
    line block, then per row and per dep tile."""
    c_pad, l_pad = m_t.shape
    dev = m_t.device
    dep_count = torch.zeros(c_pad, dtype=torch.int32, device=dev)
    block_counts = torch.zeros((l_pad // kl, c_pad // tile), dtype=torch.int32,
                               device=dev)
    step = _slab_rows(l_pad)
    for lo in range(0, c_pad, step):
        slab = m_t[lo:lo + step].to(torch.int32)
        per_block = slab.reshape(slab.shape[0], l_pad // kl, kl).sum(
            dim=2, dtype=torch.int32)
        dep_count[lo:lo + step] = per_block.sum(dim=1, dtype=torch.int32)
        tiles = torch.arange(lo, lo + slab.shape[0], device=dev) // tile
        block_counts.index_add_(1, tiles, per_block.T)
    return dep_count, block_counts


def membership_line_counts_plain(m_t, mask):
    """Plain PyTorch version of membership_line_counts: the masked rows of one
    slab at a time, widened to int32 and summed down the rows."""
    c_pad, l_pad = m_t.shape
    lens = torch.zeros(l_pad, dtype=torch.int32, device=m_t.device)
    mask = mask.to(torch.bool)
    step = _slab_rows(l_pad)
    for lo in range(0, c_pad, step):
        rows = m_t[lo:lo + step][mask[lo:lo + step]]
        if rows.numel():
            lens += rows.to(torch.int32).sum(dim=0, dtype=torch.int32)
    return lens


def membership_counts_plain(m_t, min_support: int, *, kl: int, tile: int):
    """Plain PyTorch version of membership_counts (same inputs and outputs)."""
    dep_count, block_counts = membership_row_counts_plain(m_t, kl=kl,
                                                          tile=tile)
    lens = membership_line_counts_plain(m_t, dep_count >= int(min_support))
    return dep_count, lens, block_counts


def _check_device(name: str, *tensors) -> torch.device:
    dev = tensors[0].device
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"{name} runs on cuda or cpu, not {dev}")
    if any(t.device != dev for t in tensors):
        raise ValueError(f"{name}: all operands must be on one device")
    return dev


def _launch(lib, name: str, fn, *args) -> None:
    """Call a launcher of the contains library on the current stream and raise
    on a non-zero status; count the launch."""
    err = fn(*args, torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"{name} launch failed: "
                           + lib.contains_error_string(err).decode())
    LAUNCHES[name] += 1


def packed_contains_matrix(sketch_packed, ref_packed, ref_popc):
    """(D, R) uint8 containment matrix from packed words.

    sketch_packed: (D, W) int32 packed dep sketches; ref_packed: (R, W) int32
    packed ref bit sets; ref_popc: (R,) int32 set-bit count of each ref row (-1
    marks a padded ref, which never matches).  out[d, r] = 1 iff
    popcount(sketch[d] & ref[r]) == popc[r].  D and R are multiples of
    CONTAINS_BLOCK_D / CONTAINS_BLOCK_R, W a power of two.
    """
    dev = _check_device("packed_contains_matrix", sketch_packed, ref_packed,
                        ref_popc)
    if sketch_packed.dtype != torch.int32 or ref_packed.dtype != torch.int32 \
            or ref_popc.dtype != torch.int32:
        raise TypeError("packed operands and popcounts must be int32")
    if sketch_packed.dim() != 2 or ref_packed.dim() != 2 \
            or sketch_packed.shape[1] != ref_packed.shape[1] \
            or ref_popc.shape != (ref_packed.shape[0],):
        raise ValueError(f"bad shapes {tuple(sketch_packed.shape)}, "
                         f"{tuple(ref_packed.shape)}, {tuple(ref_popc.shape)}")
    (d, w), r = sketch_packed.shape, ref_packed.shape[0]
    if d % CONTAINS_BLOCK_D or r % CONTAINS_BLOCK_R or w <= 0 or w & (w - 1):
        raise ValueError(f"D={d} and R={r} must be multiples of "
                         f"{CONTAINS_BLOCK_D}/{CONTAINS_BLOCK_R}, W={w} a "
                         f"power of two")
    if not (sketch_packed.is_contiguous() and ref_packed.is_contiguous()
            and ref_popc.is_contiguous()):
        raise ValueError("packed_contains_matrix needs contiguous operands")
    align = min(16, 4 * w)  # the kernel stages rows with 16-byte copies
    if sketch_packed.data_ptr() % align or ref_packed.data_ptr() % align:
        raise ValueError(f"packed operands need {align}-byte aligned rows")
    if dev.type == "cpu":
        return packed_contains_matrix_plain(sketch_packed, ref_packed, ref_popc)
    out = torch.empty((d, r), dtype=torch.uint8, device=dev)
    lib = build.load("contains")
    with torch.cuda.device(dev):
        _launch(lib, "packed_contains_matrix", lib.contains_launch,
                sketch_packed.data_ptr(), ref_packed.data_ptr(),
                ref_popc.data_ptr(), out.data_ptr(), d, r, w)
    return out


def packed_contains_matrix_plain(sketch_packed, ref_packed, ref_popc,
                                 ref_block: int = 1024):
    """Plain PyTorch version of packed_contains_matrix (same inputs and output):
    the AND, a popcount as ``(x >> s) & 1`` summed over the 32 shifts (an
    arithmetic shift of int32 still yields bit s), then the compare.  Refs are
    taken `ref_block` at a time to bound the (D, block, W) temporaries."""
    d, r = sketch_packed.shape[0], ref_packed.shape[0]
    out = torch.empty((d, r), dtype=torch.uint8, device=sketch_packed.device)
    for lo in range(0, r, ref_block):
        x = sketch_packed[:, None, :] & ref_packed[None, lo:lo + ref_block, :]
        hits = torch.zeros(x.shape[:2], dtype=torch.int32, device=x.device)
        for s in range(32):
            hits += ((x >> s) & 1).sum(dim=2, dtype=torch.int32)
        out[:, lo:lo + ref_block] = hits == ref_popc[None, lo:lo + ref_block]
    return out


def repeat_probe(x):
    """(1, n) int32 -> (1, 2n): out[j] = x[j % n], the word order K2's staging
    reads (P1, the counterpart of the TPU lane-order probe)."""
    dev = _check_device("repeat_probe", x)
    if x.dtype != torch.int32 or x.dim() != 2 or x.shape[0] != 1 \
            or not x.is_contiguous():
        raise ValueError("repeat_probe takes a contiguous (1, n) int32 tensor")
    if dev.type == "cpu":
        return repeat_probe_plain(x)
    out = torch.empty((1, 2 * x.shape[1]), dtype=torch.int32, device=dev)
    lib = build.load("contains")
    with torch.cuda.device(dev):
        _launch(lib, "repeat_probe", lib.repeat_probe_launch, x.data_ptr(),
                out.data_ptr(), x.shape[1], 2)
    return out


def repeat_probe_plain(x):
    return x.repeat(1, 2)


def pipeline_probe(x):
    """(8 nb, 128) float32 -> (8, 128): the sum of its nb (8, 128) blocks,
    streamed through shared memory by double-buffered cp.async copies (P2, the
    counterpart of the TPU pipeline probe)."""
    dev = _check_device("pipeline_probe", x)
    if x.dtype != torch.float32 or x.dim() != 2 or x.shape[1] != 128 \
            or x.shape[0] % 8 or x.shape[0] == 0 or not x.is_contiguous() \
            or x.data_ptr() % 16:
        raise ValueError("pipeline_probe takes a contiguous, 16-byte aligned "
                         "(8 nb, 128) float32 tensor")
    if dev.type == "cpu":
        return pipeline_probe_plain(x)
    out = torch.empty((8, 128), dtype=torch.float32, device=dev)
    lib = build.load("contains")
    with torch.cuda.device(dev):
        _launch(lib, "pipeline_probe", lib.pipeline_probe_launch,
                x.data_ptr(), out.data_ptr(), x.shape[0] // 8)
    return out


def pipeline_probe_plain(x):
    return x.reshape(-1, 8, 128).sum(dim=0)


# Devices whose contains library passed check_contains_library in this process.
_CHECKED = set()


def check_contains_library(device) -> None:
    """Run P1 and P2 on `device` at the TPU probes' shapes and raise unless they
    give the expected answers ([0, 1, 0, 1] and 2.0 everywhere).

    Once per device and process, as the JAX package runs its probes once
    (``functools.lru_cache``): a passed check is remembered, a failed one
    raises and is not.  ``reset_contains_check`` forgets the passes."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    if device in _CHECKED:
        return
    x = torch.arange(2, dtype=torch.int32, device=device).reshape(1, 2)
    lanes = repeat_probe(x).cpu().tolist()
    total = pipeline_probe(torch.ones((16, 128), dtype=torch.float32,
                                      device=device))
    if lanes != [[0, 1, 0, 1]] or not bool((total == 2.0).all()):
        raise RuntimeError(f"contains library self-check failed: repeat probe "
                           f"{lanes}, pipeline probe min {float(total.min())} "
                           f"max {float(total.max())} (want 2.0)")
    _CHECKED.add(device)


def reset_contains_check() -> None:
    _CHECKED.clear()
