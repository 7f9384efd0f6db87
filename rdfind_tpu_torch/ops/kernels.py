"""Hand-written CUDA kernels of the port, their wrappers and plain versions.

Each wrapper takes the inputs of the TPU kernel it replaces.  A tensor on the CPU
goes to the kernel's plain PyTorch version in this module; a tensor on a CUDA device
launches the kernel (built from ``csrc/`` at first use) or raises.  ``LAUNCHES``
counts the kernel launches per wrapper, so a run can show that its main path went
through the kernels.

K1 ``fused_cind_blocks`` replaces ``rdfind_tpu/ops/pallas_kernels.py:
fused_cind_blocks``: one (tile x ref_chunk) block of the dense CIND sweep, with the
co-occurrence counts summed over the scheduled line blocks only and the CIND
verdict packed to 32-bit words (``cooc.pack_bool``'s layout).
"""

from __future__ import annotations

import torch

from .. import conditions as cc
from . import build, cooc

CIND_BLOCK_D = 128
CIND_BLOCK_R = 128

LAUNCHES = {"fused_cind_blocks": 0}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _fused_kl(l_pad: int) -> int:
    """Rows per line block: the dense plan's granule, so kernel and schedule agree."""
    return cooc.line_block_for(l_pad)


def _check_fused_inputs(m_dep, m, cols, rows, block_ids, n_real, ref_lo,
                        ref_chunk):
    if m_dep.dtype != torch.int8 or m.dtype != torch.int8:
        raise TypeError("membership operands must be int8")
    if m_dep.dim() != 2 or m.dim() != 2 or m_dep.shape[0] != m.shape[0]:
        raise ValueError(f"bad membership shapes {tuple(m_dep.shape)} and "
                         f"{tuple(m.shape)}")
    l_pad, tile = m_dep.shape
    c_pad = m.shape[1]
    if m_dep.stride(1) != 1 or m.stride(1) != 1:
        raise ValueError("membership operands must have unit column stride")
    if (tile % CIND_BLOCK_D or ref_chunk <= 0 or ref_chunk % CIND_BLOCK_R
            or ref_lo % CIND_BLOCK_R or ref_lo < 0
            or ref_lo + ref_chunk > c_pad or l_pad % _fused_kl(l_pad)):
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
    n = int(n_real.reshape(-1)[0])
    n_blocks = l_pad // _fused_kl(l_pad)
    if not 0 <= n <= block_ids.numel() or not bool(
            ((block_ids[:n] >= 0) & (block_ids[:n] < n_blocks)).all()):
        raise ValueError(f"block schedule out of range: n_real={n}, "
                         f"{block_ids.numel()} entries, {n_blocks} line blocks")


def fused_cind_blocks(m_dep, m, sup_col, ok_col, gid_col, dcode_col, dv1_col,
                      dv2_col, ridx_row, rcode_row, rv1_row, block_ids, n_real,
                      *, ref_lo: int, ref_chunk: int):
    """(tile x ref_chunk) fused CIND verdict, packed, plus the per-dep popcount.

    m_dep: (l_pad, tile) int8 dep slice of the membership matrix (a column slice of
    ``m`` is fine: only its column stride must be 1); m: (l_pad, c_pad) int8.  The
    ``*_col`` operands are per-dep int32 columns of ``tile`` values (support,
    support >= min_support, global capture id, code, v1, v2), the ``*_row``
    operands per-ref int32 rows of ``c_pad`` values (global id, code, v1);
    ``block_ids`` (nk,) int32 line-block ids of which the first ``n_real`` (a
    one-element int32 tensor) are visited.

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
    l_pad, tile = m_dep.shape
    packed = torch.empty((tile, ref_chunk // 32), dtype=torch.int32,
                         device=m.device)
    popc = torch.zeros(tile, dtype=torch.int32, device=m.device)
    lib = build.load("fused_cind")
    stream = torch.cuda.current_stream(m.device).cuda_stream
    err = lib.fused_cind_launch(
        m_dep.data_ptr(), m_dep.stride(0), m.data_ptr(), m.stride(0),
        *(t.data_ptr() for t in cols.values()),
        *(t.data_ptr() for t in rows.values()),
        block_ids.data_ptr(), n_real.data_ptr(), tile, ref_chunk,
        _fused_kl(l_pad), ref_lo, packed.data_ptr(), popc.data_ptr(), stream)
    if err != 0:
        raise RuntimeError("fused_cind launch failed: "
                           + lib.fused_cind_error_string(err).decode())
    LAUNCHES["fused_cind_blocks"] += 1
    return packed, popc


def fused_cind_blocks_plain(m_dep, m, sup_col, ok_col, gid_col, dcode_col,
                            dv1_col, dv2_col, ridx_row, rcode_row, rv1_row,
                            block_ids, n_real, *, ref_lo: int, ref_chunk: int):
    """Plain PyTorch version of fused_cind_blocks (same inputs and outputs).

    The membership rows of the scheduled line blocks are widened to float64 for the
    product, which is exact: every count is a sum of at most l_pad < 2^53 unit
    terms.
    """
    l_pad, tile = m_dep.shape
    kl = _fused_kl(l_pad)
    n = int(n_real.reshape(-1)[0])
    blocks = block_ids[:n].long()
    lines = (blocks[:, None] * kl
             + torch.arange(kl, device=m.device)[None, :]).reshape(-1)
    a = m_dep[lines].to(torch.float64)
    b = m[lines, ref_lo:ref_lo + ref_chunk].to(torch.float64)
    counts = (a.T @ b).to(torch.int32)

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
