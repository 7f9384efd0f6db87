"""ApproximateAllAtOnce traversal strategy (strategy 2) on a single device.

Two rounds, exact end to end:

  round 1 — a fixed-width Bloom refset sketch per dependent capture: the OR of
      each join line's capture hash bits is the line's Bloom, and a dependent's
      sketch is the AND of the Blooms of every line containing it
      (ops/sketch.py), a conservative superset of its exact refset;
  candidate generation — "which captures r could be in dep d's refset" for all
      (d, r) at once: kernel K2 (``kernels.packed_contains_matrix``) on the
      packed sketches, one launch per dep tile;
  round 2 — exact verification by co-occurrence counting restricted to the
      candidates: the membership matrix of the rows whose capture is a candidate
      dep or ref, one exact int8 product per dep tile (``cooc.cooc_dot``), and the
      CIND test cooc(d, r) == |d| on the gathered counts.

False positives of round 1 cost round-2 work only, never correctness, so the raw
output equals strategy 0's raw output.  Phase A (the join-line rows) is
``allatonce.prepare_join_lines``, shared with strategy 3.

The host holds the (value, capture)-sorted rows and the capture table; the
sketches, K2's tiles and the products stay on the device, and only candidate
index pairs and their counts reach the host.  Where the dense verification does
not apply (capture axis above SINGLE_SHOT_C, or the membership above the device
budget), or ``pair_backend="chunked"`` asks for it, round 2 counts the
candidates' co-occurrence pairs chunk by chunk instead
(``small_to_large._chunked_cooc``).
"""

from __future__ import annotations

import numpy as np
import torch
from torch.profiler import record_function

from .. import devices
from ..data import CindTable
from ..obs import metrics
from ..ops import cooc, kernels, sketch
from . import allatonce, small_to_large

DEP_TILE = 1 << 12


def _line_starts(line_val_h) -> np.ndarray:
    """First-row flags of the join lines of (value, capture)-sorted rows."""
    starts = np.empty(line_val_h.shape[0], bool)
    starts[0] = True
    starts[1:] = line_val_h[1:] != line_val_h[:-1]
    return starts


def _build_sketches(line_val_h, line_cap_h, num_caps, *, bits, num_hashes,
                    device, row_budget=sketch.BUILD_ROW_BUDGET):
    """Packed (cap_pad, bits // 32) int32 refset sketches, on `device`.

    Rows arrive sorted by (join value, capture).  Line Blooms are built per
    chunk of whole lines of at most `row_budget` rows (a longer line is a chunk
    of its own), and the dependents' sketches are AND-accumulated across chunks
    in place on the device.  Padded captures (num_caps <= c < cap_pad) keep the
    all-ones empty-AND sketch; _candidate_pairs masks them out.
    """
    n = line_val_h.shape[0]
    starts = _line_starts(line_val_h)
    line_gid = torch.as_tensor(np.cumsum(starts) - 1).to(device)
    line_cap = torch.as_tensor(line_cap_h).to(device)
    line_start_rows = np.flatnonzero(starts)
    line_end_rows = np.append(line_start_rows[1:], n)
    num_lines = line_start_rows.shape[0]

    sketches = torch.full((cooc.cap_pad(num_caps), bits // 32), -1,
                          dtype=torch.int32, device=device)
    first = 0
    while first < num_lines:
        rs = int(line_start_rows[first])
        last = max(first + 1, int(np.searchsorted(
            line_end_rows, rs + row_budget, side="right")))
        re = int(line_end_rows[last - 1])
        gid = line_gid[rs:re] - first
        cap = line_cap[rs:re]
        valid = torch.ones(re - rs, dtype=torch.bool, device=device)
        blooms = sketch.build_line_blooms(gid, cap, valid,
                                          num_lines=last - first, bits=bits,
                                          num_hashes=num_hashes)
        sketch.intersect_dep_sketches_acc(sketches, cap, gid, blooms, valid)
        first = last
    return sketches


def _stage_cand_tile(sketches, lo, dep_ok, ref_ok, ref_ids, ref_pack, *,
                     tile: int, bits: int, num_hashes: int):
    """One (tile x cap_pad) bool candidate block: K2 on dep rows [lo, lo +
    tile), then the dep and ref masks and the no-self-pair diagonal."""
    cand = sketch.contains_matrix(sketches[lo:lo + tile], ref_ids, ref_ok,
                                  bits=bits, num_hashes=num_hashes,
                                  ref_pack=ref_pack)
    d_idx = lo + torch.arange(tile, device=cand.device)
    cand &= dep_ok[d_idx][:, None]
    cand &= d_idx[:, None] != ref_ids[None, :]
    return cand


def _candidate_pairs(sketches, num_caps, *, bits, num_hashes, dep_mask=None,
                     ref_mask=None, dep_tile=DEP_TILE):
    """All (dep, ref) capture-id pairs passing the sketch test, dep != ref, as
    host int64 arrays in dep-major, ref-ascending order.

    Tiled over dependents, one K2 launch per tile.  The tile width divides
    cap_pad, so every tile start is exact.  Each tile's bool block is decoded to
    index pairs on the device (the JAX package bit-packs it first so that only
    the pairs cross its host link; torch.nonzero does that job here), and all
    pairs reach the host in one copy.  Optional host bool masks dep_mask /
    ref_mask restrict either side.
    """
    dev = sketches.device
    kernels.check_contains_library(dev)
    cap_pad = sketches.shape[0]
    tile = cooc.tile_for(cap_pad, dep_tile)
    ref_ids = torch.arange(cap_pad, dtype=torch.int32, device=dev)

    def side_ok(mask):
        ok = np.zeros(cap_pad, bool)
        ok[:num_caps] = True if mask is None else mask[:num_caps]
        return torch.as_tensor(ok).to(dev)

    dep_ok, ref_ok = side_ok(dep_mask), side_ok(ref_mask)
    ref_pack = sketch.pack_ref_bits(ref_ids, bits=bits, num_hashes=num_hashes)
    deps, refs = [], []
    for lo in range(0, num_caps, tile):
        if dep_mask is not None and not dep_mask[lo:lo + tile].any():
            continue
        d, r = torch.nonzero(_stage_cand_tile(
            sketches, lo, dep_ok, ref_ok, ref_ids, ref_pack, tile=tile,
            bits=bits, num_hashes=num_hashes), as_tuple=True)
        deps.append(d + lo)
        refs.append(r)
    if not deps:
        z = np.zeros(0, np.int64)
        return z, z
    return (torch.cat(deps).cpu().numpy().astype(np.int64),
            torch.cat(refs).cpu().numpy().astype(np.int64))


def _stage_tile_counts(m_t, lo, d_local, r_idx, *, tile: int):
    """Exact co-occurrence counts of candidate pairs inside one dep tile.

    m_t: (c_pad, l_pad) int8 membership, captures x lines; one (tile x c_pad)
    product gives the tile's cooc block, and the candidates' (dep, ref)
    positions are gathered on the device."""
    return cooc.cooc_dot(m_t[lo:lo + tile], m_t)[d_local, r_idx]


def _dense_verify_counts(line_val_h, line_cap_h, num_caps, cand_dep, cand_ref,
                         dep_ok, ref_ok, stats, stat_key, device):
    """Exact cooc counts for the candidate pairs, or None when the membership
    matrix does not fit the budget or its capture axis exceeds SINGLE_SHOT_C.

    Rows flagged for neither side belong to captures in no candidate pair, so
    dropping them cannot change any candidate's count.
    """
    row_keep = dep_ok[line_cap_h] | ref_ok[line_cap_h]
    lv, lc = line_val_h[row_keep], line_cap_h[row_keep]
    n = lv.shape[0]
    if n == 0:
        return np.zeros(len(cand_dep), np.int64)
    starts = _line_starts(lv)
    line_gid = np.cumsum(starts) - 1
    plan = cooc.dense_plan(int(line_gid[-1]) + 1, num_caps, device)
    if plan is None or plan.c_pad > cooc.SINGLE_SHOT_C:
        return None
    if stats is not None:
        lens = np.diff(np.append(np.flatnonzero(starts), n))
        tot = int((lens * (lens - 1)).sum())
        metrics.counter_add(stats, stat_key, tot)
        metrics.counter_add(stats, "total_pairs", tot)
        metrics.struct_set(stats, "dense_plan", plan.describe())
        metrics.gauge_set(stats, "cooc_dtype", plan.dtype)

    # Mᵀ (captures x lines): a dep tile is a row slice, and both operands of
    # the product are contiguous along the lines.
    m_t = cooc.build_membership(
        torch.as_tensor(line_gid).to(device), torch.as_tensor(lc).to(device),
        torch.ones(n, dtype=torch.bool, device=device), l_pad=plan.l_pad,
        c_pad=plan.c_pad)
    # Candidates grouped by dep tile (_candidate_pairs emits them dep-ascending;
    # the sort keeps this function order-insensitive).  Every tile's gather is
    # issued first and all counts reach the host in one copy.
    order = np.argsort(cand_dep, kind="stable")
    d_sorted, r_sorted = cand_dep[order], cand_ref[order]
    spans, outs = [], []
    for lo in plan.dep_tile_starts:
        a = np.searchsorted(d_sorted, lo)
        b = np.searchsorted(d_sorted, lo + plan.tile)
        if a == b:
            continue
        spans.append((a, b))
        outs.append(_stage_tile_counts(
            m_t, lo, torch.as_tensor(d_sorted[a:b] - lo).to(device),
            torch.as_tensor(r_sorted[a:b]).to(device), tile=plan.tile))
    got = torch.cat(outs).cpu().numpy()
    cnt_sorted = np.zeros(len(cand_dep), np.int64)
    at = 0
    for a, b in spans:
        cnt_sorted[a:b] = got[at:at + b - a]
        at += b - a
    cnt = np.empty_like(cnt_sorted)
    cnt[order] = cnt_sorted
    return cnt


def _record_backend(stats, stat_key, backend):
    """Per-call backend attribution + a run-level scalar ("mixed" when a
    multi-round strategy's rounds land on different backends)."""
    if stats is None:
        return
    metrics.gauge_set(stats, stat_key + "_backend", backend)
    prev = stats.get("pair_backend")
    metrics.gauge_set(stats, "pair_backend",
                      backend if prev in (None, backend) else "mixed")


def verify_candidates(st, cand_dep, cand_ref, min_support, *, pair_backend,
                      pair_chunk_budget, stats, stat_key, device):
    """Exact verification of candidate (dep, ref) pairs: host (d, r, sup) int64
    arrays of the pairs that are CINDs, minus the trivially implied ones.

    Shared by the approximate and LateBB strategies: the dense product's
    gathered counts when it applies ("auto", "matmul"; "matmul" raises
    ValueError when it does not), otherwise the chunked loop of the
    small-to-large strategy.
    """
    if len(cand_dep) == 0:
        z = np.zeros(0, np.int64)
        return z, z, z
    num_caps = st["num_caps"]
    cnt = None
    if pair_backend != "chunked":
        dep_ok = np.zeros(num_caps, bool)
        dep_ok[cand_dep] = True
        ref_ok = np.zeros(num_caps, bool)
        ref_ok[cand_ref] = True
        cnt = _dense_verify_counts(st["line_val_h"], st["line_cap_h"],
                                   num_caps, cand_dep, cand_ref, dep_ok,
                                   ref_ok, stats, stat_key, device)
        if cnt is None and pair_backend == "matmul":
            raise ValueError("pair_backend='matmul' but the dense plan does "
                             "not fit the single-shot budget")
    if cnt is not None:
        _record_backend(stats, stat_key, "matmul")
        sup_all = st["dep_count"][cand_dep]
        is_cind = (cnt == sup_all) & (sup_all >= min_support)
        is_cind &= ~small_to_large._implied_mask(
            cand_dep, cand_ref, st["cap_code"], st["cap_v1"], st["cap_v2"],
            device)
        return cand_dep[is_cind], cand_ref[is_cind], sup_all[is_cind]

    _record_backend(stats, stat_key, "chunked")

    def cooc_fn(dep_ok, ref_ok, key):
        return small_to_large._chunked_cooc(
            st["line_val_h"], st["line_cap_h"], dep_ok, ref_ok,
            pair_chunk_budget, stats, key, device)

    return small_to_large._verify_level(
        cooc_fn, cand_dep, cand_ref, num_caps, st["dep_count"],
        st["cap_code"], st["cap_v1"], st["cap_v2"], min_support, stat_key,
        device)


def table_of(st, d, r, sup) -> CindTable:
    """CindTable of host (dep, ref, support) capture-id arrays."""
    code, v1, v2 = st["cap_code"], st["cap_v1"], st["cap_v2"]
    return CindTable(dep_code=code[d], dep_v1=v1[d], dep_v2=v2[d],
                     ref_code=code[r], ref_v1=v1[r], ref_v2=v2[r],
                     support=sup)


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
    """Discover all CINDs; raw output equals allatonce.discover's raw output.

    ``triples`` is an (N, 3) int32 array or tensor; it moves to ``device`` (CUDA
    unless the caller passes "cpu").  ``pair_backend`` selects round 2's
    verification: "matmul" the dense product, "chunked" the chunk loop (at most
    ``pair_chunk_budget`` pairs per chunk), "auto" the dense product when it
    applies.  Round 1 does not depend on it.  If ``stats`` is a dict it is
    filled with pipeline statistics, ``n_sketch_candidates`` among them.
    """
    allatonce.check_pair_backend(pair_backend)
    dev = devices.resolve(device)
    triples = allatonce.triples_on(triples, dev)
    min_support = max(int(min_support), 1)
    use_ars = use_association_rules and use_frequent_condition_filter
    with record_function("rdfind.prepare"):
        st = allatonce.prepare_join_lines(triples, min_support, projections,
                                          use_frequent_condition_filter,
                                          use_ars, stats)
    if st is None:
        return CindTable.empty()
    with record_function("rdfind.sketch"):
        sketches = _build_sketches(st["line_val_h"], st["line_cap_h"],
                                   st["num_caps"], bits=sketch_bits,
                                   num_hashes=sketch_hashes, device=dev)
    # Infrequent captures were row-filtered out of the join lines: their
    # sketches stay all-ones and they can be in no CIND on either side.
    frequent = st["dep_count"] >= min_support
    with record_function("rdfind.candidates"):
        cand_dep, cand_ref = _candidate_pairs(
            sketches, st["num_caps"], bits=sketch_bits,
            num_hashes=sketch_hashes, dep_mask=frequent, ref_mask=frequent)
    metrics.gauge_set(stats, "n_sketch_candidates", len(cand_dep))
    del sketches  # free the device memory before the membership of round 2
    with record_function("rdfind.verify"):
        d, r, sup = verify_candidates(
            st, cand_dep, cand_ref, min_support, pair_backend=pair_backend,
            pair_chunk_budget=pair_chunk_budget, stats=stats,
            stat_key="pairs_verify", device=dev)
    with record_function("rdfind.postprocess"):
        return allatonce._postprocess(table_of(st, d, r, sup), triples,
                                      min_support, use_ars, clean_implied,
                                      stats)
