"""AllAtOnce traversal strategy (strategy 0) on a single device, dense path.

One pass over the data: emit join candidates, group them into join lines, build the
0/1 line x capture membership matrix M, and read every CIND off cooc = Mᵀ M with
the fused sweep (ops/cooc.py, kernel K1).  The frequent-condition prefilter runs at
emission; captures with fewer than min_support lines are dead columns of M that
can never pass the CIND test.

Shapes are exact at every stage (PyTorch runs eagerly); the host reads a few
scalars between stages, the set-bit index pairs of the verdict, and the final
capture-table columns.
"""

from __future__ import annotations

import numpy as np
import torch
from torch.profiler import record_function

from .. import devices
from ..data import CindTable
from ..obs import integrity, metrics
from ..ops import cooc, frequency, minimality, segments
from ..ops.emission import emit_join_candidates


class DensePlanTooLarge(RuntimeError):
    """The membership matrix does not fit the device budget.  The chunked
    sort-and-count fallback of the JAX package is not ported yet."""


def _stage_prepare(triples, min_support: int, *, projections: str,
                   use_fc_filter: bool, use_ars: bool = False):
    """Candidate emission + capture interning + dense line ids.

    triples: (N, 3) int32 tensor.  Returns (line_gid, cap_id, valid, n_lines,
    cap_code, cap_v1, cap_v2, num_caps): the first three per candidate row (ids
    are -1 on invalid rows), the capture table columns with exactly num_caps
    rows in ascending (code, v1, v2) order.
    """
    n = triples.shape[0]
    freq = (frequency.triple_frequencies(triples, min_support,
                                         find_ar_implied=use_ars)
            if use_fc_filter else frequency.no_filter(n, triples.device))
    cands = emit_join_candidates(triples, freq, projections)
    cap_cols, cap_id, num_caps = segments.masked_unique(
        [cands.code, cands.v1, cands.v2], cands.valid)
    line_gid, n_lines = segments.masked_dense_ids(cands.join_val, cands.valid)
    return (line_gid, cap_id, cands.valid, n_lines,
            cap_cols[0], cap_cols[1], cap_cols[2], num_caps)


def _stage_membership(line_gid, cap_id, valid, min_support: int, *,
                      l_pad: int, c_pad: int):
    """Membership matrix + the aggregates that fall out of it.

    Returns (m, dep_count, lens): dep_count[c] = distinct join values containing
    capture c (column sums); lens[l] = frequent captures in line l.
    """
    m = cooc.build_membership(line_gid, cap_id, valid, l_pad=l_pad,
                              c_pad=c_pad)
    dep_count = m.sum(dim=0, dtype=torch.int32)
    freq_mask = (dep_count >= min_support).to(torch.int8)
    lens = (m * freq_mask[None, :]).sum(dim=1, dtype=torch.int32)
    return m, dep_count, lens


def _fit(arr, length: int):
    """Slice-or-zero-pad a 1-D tensor to `length`."""
    if arr.shape[0] >= length:
        return arr[:length]
    return torch.nn.functional.pad(arr, (0, length - arr.shape[0]))


def filter_ar_implied_cinds(table: CindTable, mined_rules) -> CindTable:
    """Drop 1/1 CIND pairs that restate a perfect-confidence association rule
    (dep = antecedent capture, ref = consequent capture, shared projection)."""
    if len(table) == 0:
        return table
    return table.select(~frequency.ar_implied_pair_mask(
        table.dep_code, table.ref_code, table.dep_v1, table.ref_v1,
        mined_rules))


def _discover_dense(triples, min_support: int, projections: str,
                    use_fc_filter: bool, use_ars: bool, clean_implied: bool,
                    stats) -> CindTable:
    # Each stage is a named profiler range ("rdfind.<stage>"): a few
    # microseconds when no profiler runs, the per-stage breakdown when one does.
    with record_function("rdfind.prepare"):
        (line_gid, cap_id, cand_valid, n_lines, cap_code, cap_v1, cap_v2,
         num_caps) = _stage_prepare(triples, min_support,
                                    projections=projections,
                                    use_fc_filter=use_fc_filter,
                                    use_ars=use_ars)
    n = triples.shape[0]
    if n_lines == 0 or num_caps == 0:
        return CindTable.empty()
    plan = cooc.dense_plan(n_lines, num_caps, triples.device)
    if plan is None:
        raise DensePlanTooLarge(
            f"the {cooc.round_up(n_lines, cooc.LINE_MULT)} x "
            f"{cooc.cap_pad(num_caps)} membership matrix exceeds the device "
            f"budget of {cooc.m_budget_bytes(triples.device)} bytes; the "
            f"chunked fallback is the next slice of the port (ROADMAP.md)")
    metrics.struct_set(stats, "dense_plan", plan.describe())
    metrics.gauge_set(stats, "cooc_dtype", plan.dtype)

    with record_function("rdfind.membership"):
        m, dep_count, lens = _stage_membership(
            line_gid, cap_id, cand_valid, min_support, l_pad=plan.l_pad,
            c_pad=plan.c_pad)
    with record_function("rdfind.sweep"):
        dep_id, ref_id, support = cooc.discover_pairs_dense(
            m, dep_count, _fit(cap_code, plan.c_pad), _fit(cap_v1, plan.c_pad),
            _fit(cap_v2, plan.c_pad), min_support, plan, stats=stats)
    del m
    lens_h = lens[:n_lines].cpu().numpy().astype(np.int64)
    code_h, v1_h, v2_h = (c.cpu().numpy() for c in (cap_code, cap_v1, cap_v2))
    dep_count_h = dep_count[:num_caps].cpu().numpy().astype(np.int64)

    # Stat semantics of the JAX package's dense path: n_lines counts lines that
    # kept >= 1 frequent capture, n_line_rows the distinct (value, capture) rows.
    metrics.set_many(
        stats, n_triples=n, n_frequent_rows=int(lens_h.sum()),
        n_line_rows=int(dep_count_h.sum()),
        n_lines=int((lens_h > 0).sum()), n_captures=num_caps,
        total_pairs=int((lens_h * (lens_h - 1)).sum()),
        max_line=int(lens_h.max()), pair_backend="matmul")
    if dep_id.size == 0:
        return CindTable.empty()
    table = CindTable(
        dep_code=code_h[dep_id].astype(np.int64),
        dep_v1=v1_h[dep_id].astype(np.int64),
        dep_v2=v2_h[dep_id].astype(np.int64),
        ref_code=code_h[ref_id].astype(np.int64),
        ref_v1=v1_h[ref_id].astype(np.int64),
        ref_v2=v2_h[ref_id].astype(np.int64),
        support=support.astype(np.int64),
    )
    with record_function("rdfind.postprocess"):
        return _postprocess(table, triples, min_support, use_ars,
                            clean_implied, stats)


def _postprocess(table, triples, min_support, use_ars, clean_implied, stats):
    if use_ars:
        rules = frequency.mine_association_rules(triples, min_support)
        metrics.struct_set(stats, "association_rules", rules)
        table = filter_ar_implied_cinds(table, rules)
    if clean_implied:
        table = minimality.minimize_table(table, triples.device)
    integrity.publish_output(stats, table)
    return table


def discover(triples, min_support: int, projections: str = "spo",
             use_frequent_condition_filter: bool = True,
             use_association_rules: bool = False,
             clean_implied: bool = False,
             pair_backend: str = "auto",
             stats: dict | None = None,
             device=None) -> CindTable:
    """Discover all CINDs in an (N, 3) int32 triple-id table.

    ``triples`` is a numpy array or a tensor; it moves to ``device`` (CUDA unless
    the caller passes "cpu").  ``pair_backend`` "auto" and "matmul" both run the
    dense sweep; when M does not fit the device budget, DensePlanTooLarge is
    raised (the chunked backend is not ported yet, and there is no silent
    fallback).  If ``stats`` is a dict it is filled with pipeline statistics.
    """
    if pair_backend not in ("auto", "matmul"):
        raise ValueError(f"pair_backend {pair_backend!r} is not ported yet; "
                         f"the port runs the dense sweep ('auto' or 'matmul')")
    dev = devices.resolve(device)
    triples = torch.as_tensor(np.asarray(triples, np.int32)
                              if not isinstance(triples, torch.Tensor)
                              else triples).to(device=dev, dtype=torch.int32)
    if triples.shape[0] == 0 or not any(ch in projections for ch in "spo"):
        return CindTable.empty()
    min_support = max(int(min_support), 1)
    use_ars = use_association_rules and use_frequent_condition_filter
    return _discover_dense(triples, min_support, projections,
                           use_frequent_condition_filter, use_ars,
                           clean_implied, stats)
