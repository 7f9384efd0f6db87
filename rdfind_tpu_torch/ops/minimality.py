"""Implied-CIND removal (clean_implied) as one sort-merge join on the device.

A CIND is dropped when a *directly* implying CIND exists —

  pass A: a 2/1 whose dep has a unary subcapture forming a 1/1 with the same ref;
  pass B: a 2/1 whose ref is a unary subcapture of a 2/2's ref with the same dep;
  pass C: a 1/1 whose ref is a unary subcapture of a 1/2's ref with the same dep;
  pass D: a 2/2 whose dep has a unary subcapture forming a 1/2 with the same ref.

All 1/2 CINDs are kept, and only direct implications are checked (the reference's
documented limitation).  All four passes are membership tests of 7-column keys
(pass id + 6), so they fuse into one tag-sorted merge join: the implying side and
the query side are each 6 segments of n rows, and one masked_unique +
masked_table_index answers every pass at once.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import conditions as cc
from ..data import NO_VALUE, CindTable
from . import segments

_N_SEG = 6  # key segments per side (see _implying_keys/_query_keys)


def _families(dep_code, ref_code):
    dep_bin = cc.is_binary(dep_code)
    ref_bin = cc.is_binary(ref_code)
    return dict(f11=~dep_bin & ~ref_bin, f12=~dep_bin & ref_bin,
                f21=dep_bin & ~ref_bin, f22=dep_bin & ref_bin)


def _implying_keys(cols, fam):
    """(7 key columns, valid) of the implying side: 6 segments of n rows.

      A (0): 1/1 rows as   (ref, dep)
      B (1): 2/2 rows as   (dep, ref-subcapture-q)   for q = 1, 2
      C (2): 1/2 rows as   (dep, ref-subcapture-q)   for q = 1, 2
      D (3): 1/2 rows as   (ref, dep)
    """
    dc, d1, d2, rc, r1, r2 = cols
    no_v = torch.full_like(d1, NO_VALUE)
    sub1_r, sub2_r = cc.first_subcapture(rc), cc.second_subcapture(rc)
    segs = [
        (0, fam["f11"], (rc, r1, r2, dc, d1, d2)),
        (1, fam["f22"], (dc, d1, d2, sub1_r, r1, no_v)),
        (1, fam["f22"], (dc, d1, d2, sub2_r, r2, no_v)),
        (2, fam["f12"], (dc, d1, d2, sub1_r, r1, no_v)),
        (2, fam["f12"], (dc, d1, d2, sub2_r, r2, no_v)),
        (3, fam["f12"], (rc, r1, r2, dc, d1, d2)),
    ]
    return _stack_segments(segs)


def _query_keys(cols, fam):
    """(7 key columns, valid) of the query side: 6 segments of n rows.

      A (0): 2/1 rows as   (ref, dep-subcapture-q)   for q = 1, 2
      B (1): 2/1 rows as   (dep, ref)
      C (2): 1/1 rows as   (dep, ref)
      D (3): 2/2 rows as   (ref, dep-subcapture-q)   for q = 1, 2
    """
    dc, d1, d2, rc, r1, r2 = cols
    no_v = torch.full_like(d1, NO_VALUE)
    sub1_d, sub2_d = cc.first_subcapture(dc), cc.second_subcapture(dc)
    segs = [
        (0, fam["f21"], (rc, r1, r2, sub1_d, d1, no_v)),
        (0, fam["f21"], (rc, r1, r2, sub2_d, d2, no_v)),
        (1, fam["f21"], (dc, d1, d2, rc, r1, r2)),
        (2, fam["f11"], (dc, d1, d2, rc, r1, r2)),
        (3, fam["f22"], (rc, r1, r2, sub1_d, d1, no_v)),
        (3, fam["f22"], (rc, r1, r2, sub2_d, d2, no_v)),
    ]
    return _stack_segments(segs)


def _stack_segments(segs):
    n = segs[0][2][0].shape[0]
    dev = segs[0][2][0].device
    pass_col = torch.cat([torch.full((n,), p, dtype=torch.int64, device=dev)
                          for p, _, _ in segs])
    key_cols = [pass_col] + [torch.cat([s[2][i] for s in segs])
                             for i in range(6)]
    valid = torch.cat([s[1] for s in segs])
    return key_cols, valid


def keep_mask(cols):
    """Per-row keep mask of the six (n,) int64 code/value columns."""
    n = cols[0].shape[0]
    fam = _families(cols[0], cols[3])
    imp_cols, imp_valid = _implying_keys(cols, fam)
    qry_cols, qry_valid = _query_keys(cols, fam)
    tab_cols, _, _ = segments.masked_unique(imp_cols, imp_valid)
    found = segments.masked_table_index(tab_cols, qry_cols, qry_valid) >= 0
    seg = [found[i * n:(i + 1) * n] for i in range(_N_SEG)]
    killed = seg[0] | seg[1] | seg[2] | seg[3] | seg[4] | seg[5]
    return ~killed


def implication_possible(table: CindTable) -> bool:
    """Whether any row of `table` can be killed by passes A-D at all: each pass
    joins a query family against an implying family (A: 2/1 vs 1/1, B: 2/1 vs
    2/2, C: 1/1 vs 1/2, D: 2/2 vs 1/2)."""
    dep_bin = np.asarray(cc.is_binary(np.asarray(table.dep_code)))
    ref_bin = np.asarray(cc.is_binary(np.asarray(table.ref_code)))
    n11 = int((~dep_bin & ~ref_bin).sum())
    n12 = int((~dep_bin & ref_bin).sum())
    n21 = int((dep_bin & ~ref_bin).sum())
    n22 = int((dep_bin & ref_bin).sum())
    return bool((n21 or n12) and (n11 or n22))


def minimize_table(table: CindTable, device) -> CindTable:
    """Drop implied CINDs (sort-merge join on `device`)."""
    if len(table) == 0 or not implication_possible(table):
        return table
    cols = [torch.as_tensor(np.asarray(c, np.int64)).to(device)
            for c in table.columns()[:6]]
    return table.select(keep_mask(cols).cpu().numpy())


# ---------------------------------------------------------------------------
# Sharded variant: the membership join hash-partitioned over the rank mesh.
# ---------------------------------------------------------------------------

_MINIMALITY_SEED = 11


def _keep_sharded(mesh, cols, valid, capacity: int):
    """One rank's block: route both sides' keys to their hash owner, join
    there, pull the verdicts back along the reply.  Returns (keep,
    overflow)."""
    from ..parallel import exchange
    from . import hashing

    n = cols[0].shape[0]
    fam = {k: v & valid for k, v in _families(cols[0], cols[3]).items()}
    imp_cols, imp_valid = _implying_keys(cols, fam)
    qry_cols, qry_valid = _query_keys(cols, fam)
    imp_cols = [c.to(torch.int32) for c in imp_cols]
    qry_cols = [c.to(torch.int32) for c in qry_cols]
    d = mesh.size
    imp_bkt = hashing.bucket_of(imp_cols, d, seed=_MINIMALITY_SEED)
    qry_bkt = hashing.bucket_of(qry_cols, d, seed=_MINIMALITY_SEED)
    recv_imp, recv_imp_v, ovf_i, _ = exchange.route(
        imp_cols, imp_valid, imp_bkt, mesh, capacity)
    recv_qry, recv_qry_v, ovf_q, state = exchange.route(
        qry_cols, qry_valid, qry_bkt, mesh, capacity)
    tab_cols, _, _, n_tab = segments.padded_unique(recv_imp, recv_imp_v)
    found = segments.padded_table_index(tab_cols, n_tab, recv_qry,
                                        recv_qry_v) >= 0
    back = exchange.route_reply(found.to(torch.int32), state, mesh) == 1
    seg = [back[i * n:(i + 1) * n] for i in range(_N_SEG)]
    killed = seg[0] | seg[1] | seg[2] | seg[3] | seg[4] | seg[5]
    return valid & ~killed, ovf_i + ovf_q


def minimize_table_sharded(table: CindTable, mesh) -> CindTable:
    """Drop implied CINDs with the join hash-partitioned over `mesh`.

    Every rank holds the whole table: each takes its row block, the four
    coGroups run as one fixed-capacity exchange per side (capacity planned
    from the expected per-owner volume, doubled on overflow), and the keep
    mask is gathered back in rank order.  The family pre-filter reads the
    replicated table, so every rank takes the same branch.
    """
    from ..parallel.mesh import host_gather, host_value, make_global

    n = len(table)
    if n == 0 or not implication_possible(table):
        return table
    num_dev = mesh.size
    if num_dev == 1:
        return minimize_table(table, mesh.device)

    blk = max(64, segments.pow2_capacity(-(-n // num_dev)))
    cols = []
    for c in table.columns()[:6]:
        a = np.full(num_dev * blk, segments.SENTINEL, np.int32)
        a[:n] = np.asarray(c, np.int64).astype(np.int32)
        cols.append(make_global(a, mesh))
    valid = np.zeros(num_dev * blk, bool)
    valid[:n] = True
    valid = make_global(valid, mesh)
    capacity = segments.pow2_capacity(
        max(64, (6 * blk) // num_dev + (6 * blk) // (num_dev * 4)))
    max_retries = 4
    for _ in range(max_retries):
        if num_dev * capacity > (1 << 31) - 1:
            raise RuntimeError(
                f"minimality exchange capacity {capacity} x {num_dev} "
                f"devices exceeds the int32 buffer budget; rerun with more "
                f"devices")
        keep, ovf = _keep_sharded(mesh, cols, valid, capacity)
        ovf = int(host_value(ovf))
        if ovf == 0:
            break
        capacity = segments.pow2_capacity(2 * capacity + ovf)
    else:
        raise RuntimeError(
            f"minimality exchange overflow persisted after {max_retries} "
            f"retries (ovf={ovf})")
    keep = host_gather(mesh, keep.to(torch.int32)).reshape(-1)[:n] == 1
    return table.select(keep)
