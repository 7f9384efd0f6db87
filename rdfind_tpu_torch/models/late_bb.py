"""LateBB traversal strategy (strategy 3) on a single device.

Two rounds over the join lines, on the approximate strategy's round 1 (the
Bloom refset sketches and one K2 candidate pass for all frequent captures):

  round 1 — unary dependents only, verified exactly: every 1/1 and 1/2 CIND;
  round 2 — binary dependents, minus the candidates (d1 ^ d2 in r) whose
      value-matching unary subcapture already has a round-1 CIND (d1 in r),
      which are implied; the rest verified exactly.

Raw output = raw strategy 0 minus the non-minimal 2/x CINDs implied by a 1/x CIND
on a value-substituted dep subcapture; with clean_implied both are the same
minimal set.  Association rules filter the final table only.
"""

from __future__ import annotations

import numpy as np

from .. import conditions as cc
from .. import devices
from ..data import CindTable
from ..obs import metrics, tracer
from ..ops import sketch
from . import allatonce, approximate, small_to_large


def discover(triples, min_support: int, projections: str = "spo",
             use_frequent_condition_filter: bool = True,
             use_association_rules: bool = False,
             clean_implied: bool = False,
             pair_chunk_budget: int = allatonce.PAIR_CHUNK_BUDGET,
             sketch_bits: int = sketch.DEFAULT_BITS,
             sketch_hashes: int = sketch.DEFAULT_HASHES,
             pair_backend: str = "auto",
             stats: dict | None = None,
             device=None) -> CindTable:
    """Discover CINDs in two rounds: unary dependents first, binary pruned after.

    Arguments as approximate.discover.  ``stats`` receives the round statistics
    ``n_round{1,2}_candidates``, ``n_round{1,2}_cinds`` and
    ``pairs_round{1,2}``.
    """
    allatonce.check_pair_backend(pair_backend)
    dev = devices.resolve(device)
    triples = allatonce.triples_on(triples, dev)
    min_support = max(int(min_support), 1)
    use_ars = use_association_rules and use_frequent_condition_filter
    with tracer.profile_range("rdfind.prepare"):
        st = allatonce.prepare_join_lines(triples, min_support, projections,
                                          use_frequent_condition_filter,
                                          use_ars, stats)
    if st is None:
        return CindTable.empty()
    cap_code, cap_v1, cap_v2 = st["cap_code"], st["cap_v1"], st["cap_v2"]
    with tracer.profile_range("rdfind.sketch"):
        sketches = approximate._build_sketches(
            st["line_val_h"], st["line_cap_h"], st["num_caps"],
            bits=sketch_bits, num_hashes=sketch_hashes, device=dev)
    # One candidate pass for all frequent captures, split by dep arity after.
    frequent = st["dep_count"] >= min_support
    with tracer.profile_range("rdfind.candidates"):
        cand_dep, cand_ref = approximate._candidate_pairs(
            sketches, st["num_caps"], bits=sketch_bits,
            num_hashes=sketch_hashes, dep_mask=frequent, ref_mask=frequent)
    del sketches
    dep_is_unary = np.asarray(cc.is_unary(cap_code))[cand_dep]

    with tracer.profile_range("rdfind.verify"):
        # Round 1: unary dependents, refs of both arities.
        c1_dep, c1_ref = cand_dep[dep_is_unary], cand_ref[dep_is_unary]
        d1, r1, sup1 = approximate.verify_candidates(
            st, c1_dep, c1_ref, min_support, pair_backend=pair_backend,
            pair_chunk_budget=pair_chunk_budget, stats=stats,
            stat_key="pairs_round1", device=dev)
        metrics.set_many(stats, n_round1_candidates=len(c1_dep),
                         n_round1_cinds=len(d1))
        # Round 2: binary dependents, pruned by the round-1 CINDs.
        c2_dep, c2_ref = cand_dep[~dep_is_unary], cand_ref[~dep_is_unary]
        keep = small_to_large._prune_22_vs_12(c2_dep, c2_ref, d1, r1,
                                              cap_code, cap_v1, cap_v2, dev)
        c2_dep, c2_ref = c2_dep[keep], c2_ref[keep]
        d2, r2, sup2 = approximate.verify_candidates(
            st, c2_dep, c2_ref, min_support, pair_backend=pair_backend,
            pair_chunk_budget=pair_chunk_budget, stats=stats,
            stat_key="pairs_round2", device=dev)
        metrics.set_many(stats, n_round2_candidates=len(c2_dep),
                         n_round2_cinds=len(d2))

    table = approximate.table_of(st, np.concatenate([d1, d2]),
                                 np.concatenate([r1, r2]),
                                 np.concatenate([sup1, sup2]))
    with tracer.profile_range("rdfind.postprocess"):
        return allatonce._postprocess(table, triples, min_support, use_ars,
                                      clean_implied, stats)
