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
(``cooc.pack_bool``'s layout).

K2 ``packed_contains_matrix`` replaces ``pallas_kernels.packed_contains_matrix``:
the Bloom containment test of the approximate strategies on packed words.  P1
``repeat_probe`` and P2 ``pipeline_probe`` replace the TPU compiler probes
``_repeat_is_tile`` and ``emit_pipeline_supported``; they are built into K2's
library and ``check_contains_library`` runs both before the first candidate pass
on a device.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import conditions as cc
from . import build, cooc

CIND_BLOCK_D = 128
CIND_BLOCK_R = 128
CIND_KC = 128  # lines per pipeline stage of K1: a line block is a multiple
CONTAINS_BLOCK_D = 64
CONTAINS_BLOCK_R = 64

LAUNCHES = {"fused_cind_blocks": 0, "packed_contains_matrix": 0,
            "repeat_probe": 0, "pipeline_probe": 0}


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
                        ref_chunk):
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
            or ref_lo + ref_chunk > c_pad or l_pad % kl or kl % CIND_KC):
        raise ValueError(f"fused tile not block-aligned: tile={tile} "
                         f"ref_lo={ref_lo} ref_chunk={ref_chunk} c_pad={c_pad} "
                         f"l_pad={l_pad}")
    dev = m.device
    for name, t, n in ([(k, v, tile) for k, v in cols.items()]
                       + [(k, v, c_pad) for k, v in rows.items()]):
        if t.dtype != torch.int32 or t.numel() != n or not t.is_contiguous() \
                or t.device != dev:
            raise ValueError(f"{name}: expected {n} contiguous int32 values on "
                             f"{dev}, got {tuple(t.shape)} {t.dtype} on {t.device}")
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


def fused_cind_blocks(m_dep, m, sup_col, ok_col, gid_col, dcode_col, dv1_col,
                      dv2_col, ridx_row, rcode_row, rv1_row, block_ids, n_real,
                      *, ref_lo: int, ref_chunk: int):
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
                        ref_chunk)
    if m.device.type == "cpu":
        return fused_cind_blocks_plain(
            m_dep, m, sup_col, ok_col, gid_col, dcode_col, dv1_col, dv2_col,
            ridx_row, rcode_row, rv1_row, block_ids, n_real, ref_lo=ref_lo,
            ref_chunk=ref_chunk)
    for t in (m_dep, m):
        if t.data_ptr() % 16 or t.stride(0) % 16:
            raise ValueError("membership operands need 16-byte aligned rows")
    tile, l_pad = m_dep.shape
    packed = torch.empty((tile, ref_chunk // 32), dtype=torch.int32,
                         device=m.device)
    popc = torch.zeros(tile, dtype=torch.int32, device=m.device)
    lib = build.load("fused_cind")
    stream = torch.cuda.current_stream(m.device).cuda_stream
    err = lib.fused_cind_launch(
        m_dep.data_ptr(), m_dep.stride(0), m.data_ptr(), m.stride(0), l_pad,
        *(t.data_ptr() for t in cols.values()),
        *(t.data_ptr() for t in rows.values()),
        block_ids.data_ptr(), n_real.data_ptr(), tile, ref_chunk,
        _fused_kl(l_pad), ref_lo, block_ids.numel(), packed.data_ptr(),
        popc.data_ptr(), stream)
    if err != 0:
        raise RuntimeError("fused_cind launch failed: "
                           + lib.fused_cind_error_string(err).decode())
    LAUNCHES["fused_cind_blocks"] += 1
    return packed, popc


def fused_cind_blocks_plain(m_dep, m, sup_col, ok_col, gid_col, dcode_col,
                            dv1_col, dv2_col, ridx_row, rcode_row, rv1_row,
                            block_ids, n_real, *, ref_lo: int, ref_chunk: int):
    """Plain PyTorch version of fused_cind_blocks (same inputs and outputs, the
    schedule as tensors).

    The membership lines of the scheduled line blocks are widened to float64 for
    the product, which is exact: every count is a sum of at most l_pad < 2^53
    unit terms.
    """
    tile, l_pad = m_dep.shape
    kl = _fused_kl(l_pad)
    n = int(n_real.reshape(-1)[0])
    blocks = block_ids[:n].long()
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
