"""Multi-device discovery, sharded over the rank mesh: all four strategies.

The JAX package's sharded dataflow (``models/sharded.py``), run SPMD: every rank
runs this host code on its own row block, and each step's collectives go over
``torch.distributed`` (``parallel/mesh.py``):

  triples (row blocks, one per rank)
    -> [optional] distributed frequency filter     [count exchanges]
    -> emit join candidates, local dedupe          [rank-local]
    -> exchange A: route by hash(join value)       [all_to_all]
    -> join-line dedupe at the value owner         [rank-local]
    -> load-aware placement of the hot tail        [all_to_all of moved lines]
    -> exchange B: route (capture, 1) by hash(capture); owner counts support
    -> skew split: oversized join lines -> all ranks, sliced  [all_gather]
    -> pair emission + local pair counts           [rank-local]
    -> exchange C: route pair partials by hash(dependent capture)
    -> merge counts, sorted-join against support, CIND test   [rank-local]

Capacities are planned from measured per-(source, destination) loads before
any exchange runs; overflow is mesh-summed at every site and the host retries
with grown capacities (grow -> split the pair phase into more dep-slice passes
-> the single-device fallback).  Buffers keep the JAX package's fixed shapes,
slot math and row order, so the CIND table, the planned capacities, the skew
statistics and the exchange ledger equal the JAX package's on the same triples
and mesh size.

Every host decision reads only mesh-reduced values (overflow lanes, plan
maxima, resume agreement), so all ranks take the same branch and issue the same
collectives.  Every rank ends with the whole CIND table: a pulled block is an
all_gather of the ranks' fixed-shape blocks in rank order.

Strategies 1-3 keep the join lines resident on the ranks and drive the
single-device strategies' host logic over the mesh-wide capture table:

  * SmallToLarge (1): each lattice level's (dep?, ref?) capture flags are
    joined onto the resident rows and only flagged rows enter the pair phase
    (``run_cooc``); with RDFIND_SHARDED_HALF_APPROX on, a round of per-rank
    count-min partials, saturating-folded and all-reduced, first cuts the
    sub-support pairs before exchange C (bit-identical output);
  * Approximate (2) and LateBB (3): every rank builds the Bloom refset sketches
    of its lines, the ranks AND them per dependent block, and each rank runs
    the containment kernel K2 on its own block of dependents against every ref
    (``_sharded_sketch_candidates``); the candidates verify as masked pair
    phases.

``preshard`` feeds rows that no host ever held whole (the sharded multi-host
ingest, ``runtime/multihost_ingest.py``): each rank passes its own row block.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import hashlib
import os
import sys
import time
import zlib

import numpy as np
import torch

from .. import conditions as cc
from ..data import CindTable
from ..obs import datastats, forecast, integrity
from ..obs import memory as obs_memory
from ..obs import metrics, tracer
from ..ops import (cooc as cooc_ops, frequency, hashing, kernels, minimality,
                   pairs, segments, sketch)
from ..ops.emission import emit_join_candidates
from ..parallel import exchange
from ..parallel.mesh import (allgather_host_values, dcn_chunks as
                             env_dcn_chunks, hier_spec, host_gather,
                             host_value, make_global, make_mesh,
                             maybe_link_probe, topology_hosts)
from ..runtime import dispatch, faults, watchdog

SENTINEL = segments.SENTINEL
_F32 = torch.float32


def _masked_counts(valid, inverse, num_segments):
    """Multiplicity of each distinct row produced by padded_unique."""
    ids = torch.clamp(inverse, 0, num_segments - 1)
    return segments.segment_sum(valid.to(torch.int32), ids, num_segments)


REBALANCE_FACTOR = 8.0
_MIN_SPLIT_LOAD = 256


@dataclasses.dataclass(frozen=True)
class SkewPolicy:
    """Skew-engine policy (the reference's --rebalance-* flags).

    strategy  -- 1 = hash-slice a split line's dependents across ranks,
                 2 = contiguous range-slice;
    factor    -- a line splits when its quadratic load exceeds
                 factor * global average (--rebalance-threshold scales this);
    max_load  -- absolute load above which a line always splits
                 (--rebalance-max-load).
    """

    strategy: int = 1
    factor: float = REBALANCE_FACTOR
    max_load: float = 10_000.0 * 10_000.0

    def __post_init__(self):
        if self.strategy not in (1, 2):
            raise ValueError(
                f"rebalance strategy must be 1 (hash-slice) or 2 "
                f"(range-slice), got {self.strategy}")

    def split_threshold(self, avg_load, cap_pairs=None):
        """The giant-split load threshold, in float32 in the JAX package's
        order: min(max(avg * factor, 256), max_load), then min with the pair
        budget's quarter (floor-divided in float32) when one is given."""
        avg_load = torch.as_tensor(avg_load, dtype=_F32)
        dev = avg_load.device
        t = torch.minimum(
            torch.maximum(avg_load * self.factor,
                          torch.tensor(float(_MIN_SPLIT_LOAD), dtype=_F32,
                                       device=dev)),
            torch.tensor(self.max_load, dtype=_F32, device=dev))
        if cap_pairs is not None:
            cap = torch.as_tensor(cap_pairs, dtype=_F32).to(dev)
            t = torch.minimum(t, torch.floor_divide(cap, 4))
        return t


DEFAULT_SKEW = SkewPolicy()

# Hash seeds shared between the planning histograms and the exchanges (the
# JAX package's): planning is exact because both sides bucket identically.
_SEED_VALUE = 1     # exchange A: join value
_SEED_CAPTURE = 2   # exchange B + exchange C: capture key
_SEED_GIANT = 5     # giant-line dependent ownership
_SEED_PASS = 7      # dep-slice selection for bounded-memory pair passes
_SEED_UNARY = 11    # +f, f in 0..2: frequency count exchanges
_SEED_BINARY = 17   # +k, k in 0..2
_SEED_HA = 23       # count-min pair keys of the sharded half-approximate round


def _exact_sum_f32(values, mesh):
    """Mesh-wide sum of float32 `values` as the correctly rounded float32 of
    the exact sum (summed in float64, exact for integer-valued loads below
    2^53), identical on every rank and for every world size."""
    return mesh.psum(values.to(torch.float64).sum()).to(_F32)


def _no_filter(valid):
    ok = valid[:, None].expand(-1, 3).contiguous()
    return frequency.TripleFrequency(ok, ok, torch.zeros_like(ok))


def _freq_key_sets(triples):
    """The 6 key sets of the frequency filter, with their exchange seeds."""
    sets = [([triples[:, f]], _SEED_UNARY + f) for f in range(3)]
    sets += [([triples[:, a], triples[:, b]], _SEED_BINARY + k)
             for k, (a, b) in enumerate(frequency._FIELD_PAIRS)]
    return sets


def _distributed_frequency(mesh, triples, valid_t, min_support, cap_freq,
                           find_ar_implied, *, cap_freq_dcn=0, hier=None,
                           dcn_chunks=1):
    """Frequency verdicts from GLOBAL condition counts: six count exchanges
    (3 unary fields + 3 field pairs) against the keys' hash owners.  Returns
    (TripleFrequency, overflow); overflow > 0 makes the verdicts unusable."""
    counts = []
    ovf = torch.zeros((), dtype=torch.int64, device=mesh.device)
    for key_cols, seed in _freq_key_sets(triples):
        c, o = exchange.global_row_counts(key_cols, valid_t, mesh, cap_freq,
                                          seed=seed, hier=hier,
                                          dcn_capacity=cap_freq_dcn,
                                          dcn_chunks=dcn_chunks)
        counts.append(c)
        ovf = ovf + o
    unary_cnt, binary_cnt = counts[:3], counts[3:]
    unary_ok = torch.stack([c >= min_support for c in unary_cnt], dim=1)
    binary_ok = torch.stack([c >= min_support for c in binary_cnt], dim=1)
    if find_ar_implied:
        ar = torch.stack([
            (binary_cnt[k] == unary_cnt[a]) | (binary_cnt[k] == unary_cnt[b])
            for k, (a, b) in enumerate(frequency._FIELD_PAIRS)], dim=1) \
            & binary_ok
    else:
        ar = torch.zeros_like(binary_ok)
    return frequency.TripleFrequency(unary_ok=unary_ok, binary_ok=binary_ok,
                                     binary_ar_implied=ar), ovf


# ---------------------------------------------------------------------------
# Capacity planning: measure bucket loads before any exchange runs.
# ---------------------------------------------------------------------------


def _bucket_max(mesh, cols, valid, seed):
    """Mesh-wide max over (src, dst) of a rank's valid-row count per bucket."""
    d = mesh.size
    b = torch.where(valid, hashing.bucket_of(cols, d, seed=seed), d)
    hist = torch.bincount(b.to(torch.int64), minlength=d + 1)
    return mesh.pmax(hist[:d].max())


def _gather_intra(mesh, t, intra):
    return mesh.all_gather(t, intra).reshape(-1)


def _combined_bucket_max(mesh, bucket_ix, cols, valid, seed, hier):
    """Mesh-wide max per (relay, final destination) of HOST-combined distinct
    rows: the exact inter-host load of a route_combined at this site."""
    d = mesh.size
    intra, _ = mesh.hier_groups(hier)
    g_cols = [_gather_intra(mesh, c, intra) for c in cols]
    g_valid = _gather_intra(mesh, valid.to(torch.int32), intra) == 1
    u_cols, u_valid, _, _ = segments.padded_unique(g_cols, g_valid)
    b = torch.where(u_valid, hashing.bucket_of([u_cols[i] for i in bucket_ix],
                                               d, seed=seed), d)
    hist = torch.bincount(b.to(torch.int64), minlength=d + 1)
    return mesh.pmax(hist[:d].max())


def _candidate_rows(triples, freq, projections, combine):
    cands = emit_join_candidates(triples, freq, projections)
    cols = [cands.join_val, cands.code, cands.v1, cands.v2]
    if combine:
        cols, valid, _, _ = segments.padded_unique(cols, cands.valid)
        return cols, valid
    return cols, cands.valid


def _plan_step(mesh, triples, n_valid, *, projections, use_fis, combine=True,
               hier=None):
    """Measured capacity needs of the frequency exchanges and exchange A (and
    their inter-host budgets when hierarchical; zeros otherwise)."""
    t = triples.shape[0]
    valid_t = torch.arange(t, device=triples.device) < n_valid
    zero = torch.zeros((), dtype=torch.int64, device=triples.device)
    cap_f = cap_fd = zero
    if use_fis:
        for key_cols, seed in _freq_key_sets(triples):
            u_cols, u_valid, _, _ = segments.padded_unique(key_cols, valid_t)
            cap_f = torch.maximum(cap_f, _bucket_max(mesh, u_cols, u_valid,
                                                     seed))
            if hier is not None:
                cap_fd = torch.maximum(cap_fd, _combined_bucket_max(
                    mesh, range(len(u_cols)), u_cols, u_valid, seed, hier))
    # Exchange A's load: the unfiltered emission bounds the filtered one.
    cols, valid = _candidate_rows(triples, _no_filter(valid_t), projections,
                                  combine)
    cap_a = _bucket_max(mesh, [cols[0]], valid, _SEED_VALUE)
    cap_ad = (_combined_bucket_max(mesh, (0,), cols, valid, _SEED_VALUE, hier)
              if hier is not None else zero)
    return cap_f, cap_a, cap_fd, cap_ad


# ---------------------------------------------------------------------------
# Line building: emission -> exchange A -> join-line dedupe + load measurement.
# ---------------------------------------------------------------------------


def _line_loads(mesh, jv, n_rows):
    """(valid, pos, length, start_idx, is_start, load_f, avg_load) of the
    value-sorted line rows; avg_load is the mesh-wide float32 average."""
    n = jv.shape[0]
    valid = torch.arange(n, device=jv.device) < n_rows
    pos, length, start_idx, _ = pairs.padded_line_layout(jv, n_rows)
    is_start = valid & (pos == 0)
    len_f = length.to(_F32)
    load_f = len_f * (len_f - 1.0)
    total_load = _exact_sum_f32(torch.where(is_start, load_f, 0.0), mesh)
    total_lines = mesh.psum(is_start.sum())
    avg_load = total_load / torch.clamp(total_lines, min=1).to(_F32)
    return valid, pos, length, start_idx, is_start, load_f, avg_load


def _lines_step(mesh, triples, n_valid, min_support, *, projections, use_fis,
                use_ars, cap_freq, cap_exchange_a, skew=DEFAULT_SKEW,
                combine=True, cap_freq_dcn=0, cap_exchange_a_dcn=0, hier=None,
                dcn_chunks=1):
    t = triples.shape[0]
    dev = triples.device
    valid_t = torch.arange(t, device=dev) < n_valid
    d = mesh.size
    if use_fis:
        freq, ovf_f = _distributed_frequency(mesh, triples, valid_t,
                                             min_support, cap_freq, use_ars,
                                             cap_freq_dcn=cap_freq_dcn,
                                             hier=hier, dcn_chunks=dcn_chunks)
    else:
        freq = _no_filter(valid_t)
        ovf_f = torch.zeros((), dtype=torch.int64, device=dev)

    # Emission + local dedupe (the combiner side of the join); combine=False
    # ships raw candidate rows (--no-combinable-join): same output.
    cols, valid = _candidate_rows(triples, freq, projections, combine)

    # Exchange A: co-locate equal join values.
    bucket = hashing.bucket_of([cols[0]], d, seed=_SEED_VALUE)
    if hier is None:
        cols, valid, ovf_a = exchange.bucket_exchange(cols, valid, bucket,
                                                      mesh, cap_exchange_a)
    else:
        cols, _, valid, (ovf_a1, ovf_a2), _ = exchange.route_combined(
            cols, None, valid, bucket, mesh, cap_exchange_a,
            cap_exchange_a_dcn, hier, dcn_chunks=dcn_chunks)
        ovf_a = ovf_a1 + ovf_a2

    # Join lines: distinct (value, capture), sorted by value at the owner.
    cols, valid, _, n_rows = segments.padded_unique(cols, valid)
    jv, code, v1, v2 = cols

    # Downstream load measurement (the planning half of the skew engine).
    cap_b = _bucket_max(mesh, [code, v1, v2], valid, _SEED_CAPTURE)
    cap_bd = (_combined_bucket_max(mesh, (0, 1, 2), [code, v1, v2], valid,
                                   _SEED_CAPTURE, hier)
              if hier is not None else torch.zeros_like(cap_b))
    valid, pos, length, _, is_start, load_f, avg_load = _line_loads(
        mesh, jv, n_rows)
    # No pair-budget backstop here (it is what is being planned).
    thresh = skew.split_threshold(avg_load)
    is_giant = valid & (load_f > thresh)
    norm_pairs = torch.where(valid & ~is_giant, length - 1, 0)
    cap_p = mesh.pmax(pairs.saturating_cumsum(norm_pairs)[-1])
    cap_g = mesh.pmax(is_giant.sum())
    giant_load = _exact_sum_f32(torch.where(is_start & is_giant, load_f, 0.0),
                                mesh)
    # Each rank owns ~1/D of every giant line's dependents.
    g_share = torch.minimum(giant_load / d,
                            torch.tensor(float(pairs.SAT), dtype=_F32,
                                         device=dev))
    overflow = torch.stack([ovf_f, ovf_a])
    plan = torch.stack([t_.to(torch.int64) for t_ in
                        (cap_b, cap_bd, cap_p, cap_g,
                         g_share.to(torch.int32))])
    return (jv, code, v1, v2), n_rows, plan, overflow


# ---------------------------------------------------------------------------
# Load-aware placement: greedy least-loaded reassignment of hot lines.
# ---------------------------------------------------------------------------

_HOT_FACTOR = 2.0
_CAP_HOT = 256
_REBALANCE_MIN_GAIN = 0.9


def _hotlines_step(mesh, jv, n_rows, *, skew=DEFAULT_SKEW, cap_pairs=None):
    """Heaviest above-average lines (jv, length) + the movable load of this
    rank.  Lines over the giant-split threshold are left out: the split
    engine already spreads their pair work across every rank."""
    n = jv.shape[0]
    valid, pos, length, _, is_start, load_f, avg_load = _line_loads(
        mesh, jv, n_rows)
    giant_thresh = skew.split_threshold(avg_load, cap_pairs)
    movable = is_start & (load_f <= giant_thresh)
    hot = movable & (load_f > avg_load * _HOT_FACTOR)
    key = torch.where(hot, -load_f, torch.tensor(float("inf"), dtype=_F32,
                                                 device=jv.device))
    order = torch.argsort(key, stable=True)[:min(_CAP_HOT, n)]
    hot_jv = torch.where(hot[order], jv[order], SENTINEL)
    hot_len = torch.where(hot[order], length[order], 0).to(torch.int32)
    dev_load = torch.where(movable, load_f, 0.0).to(torch.float64).sum().to(
        _F32)
    return hot_jv, hot_len, dev_load


def _rebalance_step(mesh, jv, code, v1, v2, n_rows, moved_jv, moved_dest, *,
                    cap_move, hier=None, dcn_chunks=1):
    """Ship the rows of reassigned lines to their new owners; keep the rest.
    Destinations are the host's greedy placement, so hierarchical mode takes
    the slot-preserving two-hop route, never the combiner."""
    n = jv.shape[0]
    valid = torch.arange(n, device=jv.device) < n_rows
    my_idx = mesh.rank
    h = moved_jv.shape[0]
    i = torch.clamp(torch.searchsorted(moved_jv, jv), 0, h - 1)
    match = valid & (moved_jv[i] == jv)
    dest = torch.where(match, moved_dest[i], my_idx)
    moving = match & (dest != my_idx)
    stay = valid & ~moving
    mcols, mvalid, ovf = exchange.bucket_exchange(
        [jv, code, v1, v2], moving, dest, mesh, cap_move, hier=hier,
        dcn_chunks=dcn_chunks)
    cols_all = [torch.cat([a, b]) for a, b in zip([jv, code, v1, v2], mcols)]
    valid_all = torch.cat([stay, mvalid])
    cols, _, _, n2 = segments.padded_unique(cols_all, valid_all)
    return cols, n2, ovf


# ---------------------------------------------------------------------------
# Capture table: exchange B support counting at the capture owner.
# ---------------------------------------------------------------------------


def _captures_step(mesh, jv, code, v1, v2, n_rows, *, cap_exchange_b,
                   cap_exchange_b_dcn=0, hier=None, dcn_chunks=1):
    d = mesh.size
    n = jv.shape[0]
    valid = torch.arange(n, device=jv.device) < n_rows
    cap_bucket = hashing.bucket_of([code, v1, v2], d, seed=_SEED_CAPTURE)
    if hier is None:
        ccols, cvalid, ovf_b = exchange.bucket_exchange(
            [code, v1, v2], valid, cap_bucket, mesh, cap_exchange_b)
        cw = cvalid.to(torch.int32)
    else:
        # Each host pre-sums its duplicate captures before the inter-host
        # hop; the owner sums received multiplicities: the same totals.
        ccols, cw, cvalid, (ovf_b1, ovf_b2), _ = exchange.route_combined(
            [code, v1, v2], torch.ones(n, dtype=torch.int32, device=jv.device),
            valid, cap_bucket, mesh, cap_exchange_b, cap_exchange_b_dcn,
            hier, dcn_chunks=dcn_chunks)
        ovf_b = ovf_b1 + ovf_b2
    tbl_cols, _, tbl_inv, n_caps = segments.padded_unique(ccols, cvalid)
    m = tbl_cols[0].shape[0]
    tbl_counts = segments.segment_sum(torch.where(cvalid, cw, 0),
                                      torch.clamp(tbl_inv, 0, m - 1), m)
    return (tbl_cols[0], tbl_cols[1], tbl_cols[2], tbl_counts), n_caps, ovf_b


# ---------------------------------------------------------------------------
# Pair phase: skew-aware masked pair counting + exchange C merge.
# ---------------------------------------------------------------------------


def _emit_local_pairs(mesh, jv, code, v1, v2, n_rows, dep_f, ref_f, *,
                      cap_pairs, cap_giant, cap_giant_pairs,
                      skew=DEFAULT_SKEW, pass_idx=None, n_pass=None):
    """Pair emission + rank-local pre-count of one dep-slice pass: skew
    stats, the giant-line split and gather, masked pair emission and the
    local dedupe, everything before the pair exchange.

    Returns (pcols(6), pvalid2, pcnt, (ovf_p, ovf_g, ovf_gp),
    n_giant_lines, n_giant_pairs, n_pairs_total)."""
    d = mesh.size
    my_idx = mesh.rank
    dev = jv.device
    n = jv.shape[0]
    valid, pos, length, start_idx, is_start, load_f, avg_load = _line_loads(
        mesh, jv, n_rows)
    dep_f = dep_f & valid
    ref_f = ref_f & valid
    if n_pass is not None:
        dep_f = dep_f & (hashing.bucket_of([code, v1, v2], n_pass,
                                           seed=_SEED_PASS) == pass_idx)
    full_budget = torch.tensor(float(cap_pairs), dtype=_F32, device=dev)
    if n_pass is not None:
        full_budget = full_budget * torch.tensor(float(n_pass), dtype=_F32,
                                                 device=dev)
    thresh = skew.split_threshold(avg_load, full_budget)
    is_giant = valid & (load_f > thresh)
    n_giant_lines = mesh.psum((is_start & is_giant).sum())

    # Pair emission for normal lines (giant rows get length 1: no pairs);
    # only dep-flagged rows take output slots.
    length_n = torch.where(is_giant, 1, length)
    total_norm = pairs.saturating_cumsum(
        torch.where(dep_f, length_n - 1, 0))[-1]
    ovf_p = mesh.psum(torch.clamp(total_norm - cap_pairs, min=0))
    row, partner, pvalid = pairs.emit_pair_indices(pos, length_n, start_idx,
                                                   cap_pairs, emit=dep_f)
    pvalid = pvalid & dep_f[row] & ref_f[partner]

    # Giant lines: extract whole lines, all_gather, process an owned slice.
    cap_giant = min(cap_giant, n)
    flag = dep_f.to(torch.int32) * 2 + ref_f.to(torch.int32)
    g_cols, n_g = segments.padded_compact([jv, code, v1, v2, flag], is_giant)
    ovf_g = mesh.psum(torch.clamp(n_g - cap_giant, min=0))
    g_valid = torch.arange(cap_giant, device=dev) < n_g
    lanes = torch.stack([c[:cap_giant].to(torch.int32) for c in g_cols]
                        + [g_valid.to(torch.int32)])
    gathered = mesh.all_gather(lanes)             # (D, 6, cap_giant)
    gg = [gathered[:, k].reshape(-1) for k in range(5)]
    gg_valid = gathered[:, 5].reshape(-1) == 1
    # jv is globally unique per line, so sorting by it alone re-forms lines.
    permg = segments.lexsort([torch.where(gg_valid, gg[0], SENTINEL)])
    jv_g, code_g, v1_g, v2_g, flag_g = (c[permg] for c in gg)
    gv = gg_valid[permg]
    dep_fg = gv & (flag_g >= 2)
    ref_fg = gv & (flag_g % 2 == 1)
    posg, leng, startg, _ = pairs.padded_line_layout(jv_g, gv.sum())
    if skew.strategy == 2:
        # Contiguous range-slice: rank r owns positions [r*block,
        # (r+1)*block) with block = ceil(len / D).
        block = torch.clamp(-((-leng) // d), min=1)
        own = dep_fg & (posg // block == my_idx)
    else:
        own = dep_fg & (hashing.bucket_of([code_g, v1_g, v2_g], d,
                                          seed=_SEED_GIANT) == my_idx)
    (posd, lend, startd, dc, dv1, dv2), n_own = segments.padded_compact(
        [posg, leng, startg, code_g, v1_g, v2_g], own)
    lend = torch.where(torch.arange(lend.shape[0], device=dev) < n_own,
                       lend, 1)
    total_g = pairs.saturating_cumsum(lend - 1)[-1]
    ovf_gp = mesh.psum(torch.clamp(total_g - cap_giant_pairs, min=0))
    growp, gpart, gpvalid = pairs.emit_pair_indices(posd, lend, startd,
                                                    cap_giant_pairs)
    gpvalid = gpvalid & ref_fg[gpart]
    n_giant_pairs = mesh.psum(total_g)
    n_pairs_total = mesh.psum(total_norm) + n_giant_pairs

    # Local partial counts over the combined (normal + giant-slice) stream.
    pair_cols = [torch.cat([a[row], b[growp]])
                 for a, b in ((code, dc), (v1, dv1), (v2, dv2))]
    pair_cols += [torch.cat([a[partner], b[gpart]])
                  for a, b in ((code, code_g), (v1, v1_g), (v2, v2_g))]
    pair_cols = [c.to(torch.int32) for c in pair_cols]
    pvalid_all = torch.cat([pvalid, gpvalid])
    pcols, pvalid2, pinv, _ = segments.padded_unique(pair_cols, pvalid_all)
    pcnt = _masked_counts(pvalid_all, pinv, pcols[0].shape[0])
    return (pcols, pvalid2, pcnt, (ovf_p, ovf_g, ovf_gp),
            n_giant_lines, n_giant_pairs, n_pairs_total)


def _ha_pair_keys(pcols):
    """32-bit count-min key of each (dep capture, ref capture) pair row (held
    in int64): a pure function of the six key columns, so a pair has one key
    on every rank and in every pass."""
    return hashing.hash_cols(pcols, seed=_SEED_HA)


def _pair_phase(mesh, jv, code, v1, v2, n_rows, dep_f, ref_f, *, cap_pairs,
                cap_exchange_c, cap_giant, cap_giant_pairs,
                skew=DEFAULT_SKEW, pass_idx=None, n_pass=None,
                cap_exchange_c_dcn=0, hier=None, dcn_chunks=1, ha_cut=None):
    """Skew-aware masked pair counting over value-sorted line rows, then
    exchange C to the dependent capture's owner and the merge there.

    pass_idx/n_pass select one dep-slice pass: only rows whose capture
    hashes to pass_idx (mod n_pass) emit, so every buffer shrinks by ~n_pass
    and the per-pass outputs concatenate with no cross-pass merge.

    ha_cut = (table, bits, num_hashes, thresh) arms the half-approximate
    round's cut: pair rows whose count-min estimate is below thresh leave
    before exchange C.  The all-reduced table upper-bounds min(global cooc,
    cap) and thresh <= min(min_support, cap), so a cut pair has a cooc below
    the support and every partial row of a pair shares its key: the output
    is the same with the cut on or off.

    Returns (ucols(6), uvalid, cooc, (ovf_p, ovf_c, ovf_g, ovf_gp, ovf_cd),
    n_giant_lines, n_giant_pairs, n_pairs_total, n_ha_cut)."""
    d = mesh.size
    (pcols, pvalid2, pcnt, (ovf_p, ovf_g, ovf_gp),
     n_giant_lines, n_giant_pairs, n_pairs_total) = _emit_local_pairs(
        mesh, jv, code, v1, v2, n_rows, dep_f, ref_f, cap_pairs=cap_pairs,
        cap_giant=cap_giant, cap_giant_pairs=cap_giant_pairs, skew=skew,
        pass_idx=pass_idx, n_pass=n_pass)
    n_ha_cut = torch.zeros((), dtype=torch.int64, device=jv.device)
    if ha_cut is not None:
        table, ha_bits, ha_hashes, ha_thresh = ha_cut
        est = sketch.count_min_query(table, _ha_pair_keys(pcols), bits=ha_bits,
                                     num_hashes=ha_hashes)
        keep = est >= ha_thresh
        n_ha_cut = mesh.psum((pvalid2 & ~keep).sum())
        pvalid2 = pvalid2 & keep

    pair_bucket = hashing.bucket_of(pcols[0:3], d, seed=_SEED_CAPTURE)
    if hier is None:
        mcols, mvalid, ovf_c = exchange.bucket_exchange(
            pcols + [pcnt], pvalid2, pair_bucket, mesh, cap_exchange_c)
        mkeys, mcnt_in = mcols[0:6], mcols[6]
        ovf_cd = torch.zeros_like(ovf_c)
    else:
        mkeys, mcnt_in, mvalid, (ovf_c, ovf_cd), _ = exchange.route_combined(
            pcols, pcnt, pvalid2, pair_bucket, mesh, cap_exchange_c,
            cap_exchange_c_dcn, hier, dcn_chunks=dcn_chunks)

    # Merge partial counts across sources.
    ucols, uvalid, uinv, _ = segments.padded_unique(mkeys, mvalid)
    m = ucols[0].shape[0]
    cooc = segments.segment_sum(torch.where(mvalid, mcnt_in, 0),
                                torch.clamp(uinv, 0, m - 1), m)
    return (ucols, uvalid, cooc, (ovf_p, ovf_c, ovf_g, ovf_gp, ovf_cd),
            n_giant_lines, n_giant_pairs, n_pairs_total, n_ha_cut)


# Packed per-pass control lanes (exchange.pack_counters): 5 overflow counters
# then the tail counters; the integrity digest lanes ride at the end.
_TELE_LANES = 11  # [ovf_p, ovf_c, ovf_g, ovf_gp, ovf_cd, n_giant_lines,
#                   n_giant_pairs, n_pairs_total, n_ha_cut, dig_a, dig_b]
_N_OVF = 5
_N_TAIL = _TELE_LANES - _N_OVF


def _digest_lanes(mesh, cols, valid):
    """The two mesh-summed integrity-digest lanes over a masked row set:
    uint32 wraparound sums (int64 reduce, masked once), identical on every
    rank.  Computed unconditionally: the same steps run with the integrity
    knob on or off."""
    a = mesh.psum(hashing.digest_fold(cols, valid, seed=integrity.SEED_A))
    b = mesh.psum(hashing.digest_fold(cols, valid, seed=integrity.SEED_B))
    return a & integrity.MASK32, b & integrity.MASK32


def _cind_step(mesh, lines, n_rows, tbl, n_caps, min_support, pass_idx,
               n_pass, *, cap_pairs, cap_exchange_c, cap_giant,
               cap_giant_pairs, skew=DEFAULT_SKEW, cap_exchange_c_dcn=0,
               hier=None, dcn_chunks=1):
    """AllAtOnce finish of one pass: all-flag pair phase + support join +
    CIND test.  Returns (out_cols(7), n_out, telemetry lanes)."""
    jv, code, v1, v2 = lines
    tc, tv1, tv2, tcnt = tbl
    n = jv.shape[0]
    dev = jv.device
    valid = torch.arange(n, device=dev) < n_rows
    (ucols, uvalid, cooc, (ovf_p, ovf_c, ovf_g, ovf_gp, ovf_cd),
     n_giant_lines, n_giant_pairs, n_pairs_total, n_ha_cut) = _pair_phase(
        mesh, jv, code, v1, v2, n_rows, valid, valid, cap_pairs=cap_pairs,
        cap_exchange_c=cap_exchange_c, cap_giant=cap_giant,
        cap_giant_pairs=cap_giant_pairs, skew=skew, pass_idx=pass_idx,
        n_pass=n_pass, cap_exchange_c_dcn=cap_exchange_c_dcn, hier=hier,
        dcn_chunks=dcn_chunks)

    # Support lookup + CIND test (same rank by the shared _SEED_CAPTURE).
    tbl_valid = torch.arange(tc.shape[0], device=dev) < n_caps
    dep_count = exchange.sorted_join_counts([tc, tv1, tv2], tcnt, tbl_valid,
                                            ucols[0:3], uvalid)
    is_cind = uvalid & (cooc == dep_count) & (dep_count >= min_support)
    d_code, d_v1, d_v2, r_code, r_v1, _ = ucols
    implied = cc.is_subcode(r_code, d_code) & torch.where(
        cc.first_subcapture(d_code) == r_code, r_v1 == d_v1, r_v1 == d_v2)
    keep = is_cind & ~implied

    out_cols, n_out = segments.padded_compact(list(ucols) + [dep_count],
                                              keep)
    dig_a, dig_b = _digest_lanes(
        mesh, out_cols, torch.arange(out_cols[0].shape[0], device=dev) < n_out)
    tele = exchange.pack_counters([ovf_p, ovf_c, ovf_g, ovf_gp, ovf_cd,
                                   n_giant_lines, n_giant_pairs,
                                   n_pairs_total, n_ha_cut, dig_a, dig_b])
    return out_cols, n_out, tele


def _s2l_flag_rows(lines, n_rows, flags):
    """Join a level's (dep?, ref?) flag table onto the resident rows and move
    the flagged rows to the front, order kept: dropping never-relevant rows
    before the quadratic layout is the strategy's saving.  The verification
    step and the round-1 sketch build share it, so both see one pair
    stream.  Returns ((jv, code, v1, v2, dep_f, ref_f), n_keep)."""
    jv, code, v1, v2 = lines
    fcode, fv1, fv2, fflag, n_flags = flags
    dev = jv.device
    valid = torch.arange(jv.shape[0], device=dev) < n_rows
    fvalid = torch.arange(fcode.shape[0], device=dev) < n_flags
    flag = exchange.sorted_join_counts([fcode, fv1, fv2], fflag, fvalid,
                                       [code, v1, v2], valid)
    dep_f = valid & (flag >= 2)
    ref_f = valid & (flag % 2 == 1)
    return segments.padded_compact([jv, code, v1, v2, dep_f, ref_f],
                                   dep_f | ref_f)


def _s2l_cooc_step(mesh, lines, n_rows, flags, pass_idx, n_pass, *,
                   cap_pairs, cap_exchange_c, cap_giant, cap_giant_pairs,
                   skew=DEFAULT_SKEW, cap_exchange_c_dcn=0, hier=None,
                   dcn_chunks=1, ha_cut=None):
    """One pass of a level's verification: flag join, masked pair phase
    (with the half-approximate cut when `ha_cut` is set).  Returns
    (out_cols (6 keys + cooc), n_out, telemetry lanes)."""
    (jv2, code2, v12, v22, df2, rf2), n_keep = _s2l_flag_rows(lines, n_rows,
                                                              flags)
    (ucols, uvalid, cooc, ovfs, n_giant_lines, n_giant_pairs, n_pairs_total,
     n_ha_cut) = _pair_phase(
        mesh, jv2, code2, v12, v22, n_keep, df2, rf2, cap_pairs=cap_pairs,
        cap_exchange_c=cap_exchange_c, cap_giant=cap_giant,
        cap_giant_pairs=cap_giant_pairs, skew=skew, pass_idx=pass_idx,
        n_pass=n_pass, cap_exchange_c_dcn=cap_exchange_c_dcn, hier=hier,
        dcn_chunks=dcn_chunks, ha_cut=ha_cut)
    out_cols, n_out = segments.padded_compact(list(ucols) + [cooc], uvalid)
    dig_a, dig_b = _digest_lanes(
        mesh, out_cols,
        torch.arange(out_cols[0].shape[0], device=jv2.device) < n_out)
    tele = exchange.pack_counters([*ovfs, n_giant_lines, n_giant_pairs,
                                   n_pairs_total, n_ha_cut, dig_a, dig_b])
    return out_cols, n_out, tele


def _s2l_sketch_build_step(mesh, lines, n_rows, flags, pass_idx, n_pass, *,
                           cap_pairs, cap_giant, cap_giant_pairs,
                           skew=DEFAULT_SKEW, ha_bits, ha_hashes):
    """One pass of round 1 of the half-approximate round: the level's pair
    stream (the verification's flag join, emission, caps and dep slices)
    folded into this rank's count-min partial table.  The pairs never leave
    the rank; summed over ranks and passes the partial counts are each
    pair's global cooc.  Returns ([table], ha_bits, telemetry lanes)."""
    (jv2, code2, v12, v22, df2, rf2), n_keep = _s2l_flag_rows(lines, n_rows,
                                                              flags)
    (pcols, pvalid2, pcnt, (ovf_p, ovf_g, ovf_gp), n_giant_lines,
     n_giant_pairs, n_pairs_total) = _emit_local_pairs(
        mesh, jv2, code2, v12, v22, n_keep, df2, rf2, cap_pairs=cap_pairs,
        cap_giant=cap_giant, cap_giant_pairs=cap_giant_pairs, skew=skew,
        pass_idx=pass_idx, n_pass=n_pass)
    table = sketch.count_min_partial(_ha_pair_keys(pcols), pcnt, pvalid2,
                                     bits=ha_bits, num_hashes=ha_hashes)
    dev = jv2.device
    # (local position, value) rows: the mesh-summed lanes equal
    # integrity.digest_sketch_rows over the stacked partials at any mesh size.
    dig_a, dig_b = _digest_lanes(
        mesh, [torch.arange(ha_bits, dtype=torch.int32, device=dev), table],
        torch.ones(ha_bits, dtype=torch.bool, device=dev))
    z = torch.zeros((), dtype=torch.int64, device=dev)
    tele = exchange.pack_counters([ovf_p, z, ovf_g, ovf_gp, z, n_giant_lines,
                                   n_giant_pairs, n_pairs_total, z, dig_a,
                                   dig_b])
    return [table], torch.tensor(ha_bits, device=dev), tele


def _ha_reduce_step(mesh, parts, *, cap: int, hier=None):
    """Fold this rank's (k, bits) partial tables with min(acc + row, cap) in
    int32 (each partial is already capped, so no sum wraps), then the
    saturating all-reduce: every rank gets min(cap, global sum) per counter
    (the saturation lemma, ``ops/sketch.py``)."""
    acc = torch.zeros(parts.shape[-1], dtype=torch.int32, device=parts.device)
    for row in parts:
        acc = torch.clamp(acc + row.to(torch.int32), max=cap)
    return exchange.sketch_allreduce(acc, mesh, cap=cap, hier=hier)


def _stage_datastats(mesh, jv, n_rows, tcnt, n_caps, giant_load: int):
    """The data plane's one-shot distribution snapshot over the resident
    state: the 32-bin log2 join-line size histogram, the 32-bin capture
    support spectrum and [n_lines, max_line, n_giant_lines, n_captures,
    max_support], all mesh-reduced."""
    dev = jv.device
    r = jv.shape[0]
    valid = torch.arange(r, device=dev) < n_rows
    # Rebalancing may interleave value buckets; a local sort restores runs.
    jv_s = torch.sort(torch.where(valid, jv, SENTINEL)).values
    sizes = segments.masked_weighted_row_counts(
        [jv_s], torch.ones(r, dtype=torch.int32, device=dev), valid)
    line = segments.run_starts([jv_s]) & valid & (sizes > 0)

    def log2_bin(x):
        return torch.clamp(torch.floor(torch.log2(
            torch.clamp(x, min=1).to(torch.float64))).to(torch.int64), 0, 31)

    hist = mesh.psum(torch.zeros(32, dtype=torch.int64, device=dev)
                     .index_add_(0, log2_bin(sizes), line.to(torch.int64)))
    load = sizes.to(_F32) * (sizes - 1).to(_F32)
    n_giant = mesh.psum((line & (load > float(giant_load))).sum())
    n_lines = mesh.psum(line.sum())
    max_line = mesh.pmax(torch.where(line, sizes, 0).max())
    c = tcnt.shape[0]
    cvalid = (torch.arange(c, device=dev) < n_caps) & (tcnt > 0)
    chist = mesh.psum(torch.zeros(32, dtype=torch.int64, device=dev)
                      .index_add_(0, log2_bin(tcnt), cvalid.to(torch.int64)))
    n_capt = mesh.psum(cvalid.sum())
    max_sup = mesh.pmax(torch.where(cvalid, tcnt, 0).max())
    sc = torch.stack([t.to(torch.int64) for t in
                      (n_lines, max_line, n_giant, n_capt, max_sup)])
    return hist, chist, sc


def _stage_digest(mesh, lines, n_rows, tbl, n_caps):
    """The integrity plane's stage digests of the resident state: two lanes
    each for the join-line rows and the capture table."""
    jv = lines[0]
    dev = jv.device
    lvalid = torch.arange(jv.shape[0], device=dev) < n_rows
    la, lb = _digest_lanes(mesh, list(lines), lvalid)
    cvalid = torch.arange(tbl[0].shape[0], device=dev) < n_caps
    ca, cb = _digest_lanes(mesh, list(tbl), cvalid)
    return torch.stack([la, lb, ca, cb])


# ---------------------------------------------------------------------------
# Host orchestration.
# ---------------------------------------------------------------------------

T_LOC_FLOOR = 256
CAP_FLOOR = 512
PAIR_ROW_BUDGET = 1 << 25

# The sharded half-approximate round: count-min depth and default width.
_HA_HASHES = 2
_HA_DEF_BITS = 1 << 16


def sharded_half_approx_enabled() -> bool:
    """RDFIND_SHARDED_HALF_APPROX: run SmallToLarge's level verification as
    the two-round count-min cut (auto/0/1; auto, the default, is off).  The
    output is the same either way."""
    v = os.environ.get("RDFIND_SHARDED_HALF_APPROX", "auto").strip().lower()
    return v in ("1", "on", "true", "yes")


def sharded_ha_bits() -> int:
    """RDFIND_SHARDED_HA_BITS: count-min table width of the round (a power
    of two, at least 32; default 2^16 int32 counters, one table per rank)."""
    v = int(os.environ.get("RDFIND_SHARDED_HA_BITS", _HA_DEF_BITS))
    return max(32, segments.pow2_capacity(max(v, 1)))


def _shard_triples(triples, num_dev, t_loc: int | None = None):
    """Contiguous per-rank split, padded to a shared power-of-two block."""
    n = triples.shape[0]
    if t_loc is None:
        t_loc = max(T_LOC_FLOOR, segments.pow2_capacity(-(-n // num_dev)))
    padded = np.full((num_dev * t_loc, 3), np.iinfo(np.int32).max, np.int32)
    n_valid = np.zeros(num_dev, np.int32)
    for dev in range(num_dev):
        lo, hi = dev * t_loc, min((dev + 1) * t_loc, n)
        hi = max(hi, lo)
        take = triples[lo:hi] if lo < n else triples[:0]
        padded[dev * t_loc: dev * t_loc + take.shape[0]] = take
        n_valid[dev] = take.shape[0]
    return padded, n_valid, t_loc


MAX_EXCHANGE_ROWS = (1 << 31) - 1


def _check_caps(**total_rows) -> None:
    """Every named buffer's TOTAL rows must stay int32-indexable."""
    for name, rows in total_rows.items():
        if int(rows) > MAX_EXCHANGE_ROWS:
            raise RuntimeError(
                f"planned buffer {name}={int(rows)} rows exceeds the int32 "
                f"indexing budget; this workload's pair volume needs more "
                f"devices, a higher --support, or --use-fis pruning")


def _check_exchange_caps(num_dev: int, **caps) -> None:
    _check_caps(**{name: num_dev * int(c) for name, c in caps.items()})


def _headroom(measured: int, floor: int = CAP_FLOOR) -> int:
    """Measured load -> planned capacity: +12.5% margin, pow2-bucketed."""
    measured = int(measured)
    return segments.pow2_capacity(max(measured + max(measured // 8, floor),
                                      floor))


class _PairCapsExhausted(Exception):
    """Internal ladder signal: a pass exhausted its grow retries."""

    def __init__(self, msg: str):
        super().__init__(msg)
        self.msg = msg


# Exchange-site lane counts for the communication ledger (the JAX package's).
_LANES_FREQ = 27
_LANES_FREQ_REPLY = 6
_LANES_EXCHANGE_A = 5
_LANES_EXCHANGE_B = 4
_LANES_REBALANCE = 5
_LANES_EXCHANGE_C = 8
_LANES_GIANT = 6


class _SkewMeter:
    """Straggler/skew attribution across hosts, one sample per committed
    pass: this host's phase breakdown (exchange, compute, pull, commit) rides
    the per-pass host allgather; ``publish`` lands the run-level
    ``host_skew`` struct.  `active` must agree on every rank."""

    PHASES = ("exchange", "compute", "pull", "commit")

    def __init__(self, stats, what: str, mesh, active: bool):
        self.active = active
        self.stats = stats
        self.what = what
        self.mesh = mesh
        self.totals = np.zeros(len(self.PHASES) + 1)
        self.n_committed = 0

    def vec(self, phase_ms: dict) -> list:
        v = [float(phase_ms.get(ph, 0.0)) for ph in self.PHASES]
        v.append(sum(v))
        return v

    def pass_committed_rows(self, vec: list, m: np.ndarray) -> None:
        self.totals += np.asarray(vec)
        self.n_committed += 1
        walls = m[:, -1]
        slowest = int(walls.argmax())
        skew = float(walls.max() / max(float(walls.mean()), 1e-9))
        tracer.counter("host_skew", skew=round(skew, 3), slowest=slowest)
        tracer.counter("pass_phase_ms",
                       **{ph: round(v, 3) for ph, v in zip(self.PHASES, vec)})
        for ph, v in zip(self.PHASES, vec):
            metrics.observe(f"pass_{ph}_ms", v)

    def publish(self) -> None:
        if not self.active or not self.n_committed:
            return
        m = allgather_host_values(self.mesh, self.totals.tolist())
        walls = m[:, -1]
        slowest = int(walls.argmax())
        cause = self.PHASES[int(np.argmax(m[slowest, :-1]))]
        metrics.struct_set(self.stats, "host_skew", {
            "n_hosts": int(m.shape[0]),
            "n_passes": int(self.n_committed),
            "skew_index": round(float(walls.max()
                                      / max(float(walls.mean()), 1e-9)), 4),
            "slowest_host": slowest,
            "cause": cause,
            "per_host_ms": [round(float(x), 3) for x in walls],
            "phase_ms": {ph: [round(float(x), 3) for x in m[:, i]]
                         for i, ph in enumerate(self.PHASES)},
        })


def _reshard_pass_rows(cols, num_dev: int):
    """Re-shard one committed pass's host rows for a `num_dev` mesh: an
    uninterrupted run's rows per pass are in (exchange-C owner, key lex)
    order, so recomputing the owner for the new mesh and re-sorting gives
    exactly the rows a run at that mesh size would have committed."""
    key = [np.asarray(c) for c in cols[:6]]
    bucket = hashing.host_bucket_of(key[0:3], num_dev, seed=_SEED_CAPTURE)
    order = np.lexsort(tuple(reversed(key)) + (bucket,))
    return [np.asarray(c)[order] for c in cols]


def _sync(mesh) -> None:
    if mesh.device.type == "cuda":
        torch.cuda.synchronize(mesh.device)


def _obs_flags(mesh) -> tuple[bool, bool, bool]:
    """(skew meter, data plane, integrity plane) gates, made uniform across
    ranks: each enables collectives, and only a host's local rank 0 traces
    or exports, so one rank's "on" turns them on everywhere."""
    local = [tracer.enabled() or metrics.export_requested()
             or exchange.collective_timing_enabled(),
             datastats.enabled(), integrity.enabled()]
    if mesh.size == 1:
        return tuple(bool(x) for x in local)
    agreed = mesh.pmax(torch.tensor([int(x) for x in local],
                                    dtype=torch.int64, device=mesh.device))
    return tuple(bool(x) for x in agreed.cpu().tolist())


class _Pipeline:
    """Planned, retrying execution of the sharded steps (host side of one
    rank).  Holds the rank's resident line rows + capture table and the
    capacity plan; every stage checks its mesh-summed overflow counters and
    retries with grown capacities."""

    def __init__(self, mesh, triples, min_support, projections, use_fis,
                 use_ars, max_retries, stats, skew=None, combine=True,
                 preshard=None, progress=None):
        self.mesh = mesh
        self.num_dev = mesh.size
        self.min_support = min_support
        self.max_retries = max_retries
        self.stats = stats
        watchdog.bind_stats(stats)
        self.skew = skew if skew is not None else DEFAULT_SKEW
        self.combine = combine
        self.hier = hier_spec(self.num_dev)
        self.hosts = topology_hosts(self.num_dev)
        self.dcn_chunks = env_dcn_chunks()
        maybe_link_probe(mesh)
        self._timed = exchange.collective_timing_enabled()
        self.stage_ms: dict = {}
        self.progress = progress
        self._phase_seq = 0
        self._pull_base = faults.pull_stats()
        if preshard is not None:
            # This rank's block of rows no host held whole (sharded ingest).
            self._triples = preshard[0].to(mesh.device)
            self._n_valid = int(preshard[1])
        else:
            padded, n_valid, _ = _shard_triples(triples, self.num_dev)
            self._triples = make_global(padded, mesh)
            self._n_valid = int(n_valid[mesh.rank])
        self._meter_on, self._datastats_on, self._integrity_on = \
            _obs_flags(mesh)
        # The half-approximate round, resolved once for every lattice level;
        # the cut threshold is clamped to the counters' cap.
        self.ha_on = sharded_half_approx_enabled()
        self.ha_bits = sharded_ha_bits()
        self.ha_hashes = _HA_HASHES
        self.ha_thresh = min(int(min_support), sketch.MAX_COUNT_MIN_CAP)
        if stats is not None:
            metrics.gauge_set(stats, "dist_backend", mesh.backend)
            metrics.gauge_set(stats, "staged", int(mesh.staged))
            metrics.gauge_set(stats, "world_size", self.num_dev)

        # Measured plan for the pre-exchange capacities.
        with self._stage("plan"):
            cap_f, cap_a, cap_fd, cap_ad = _plan_step(
                mesh, self._triples, self._n_valid, projections=projections,
                use_fis=use_fis, combine=combine, hier=self.hier)
        self._plan_and_build(cap_f, cap_a, cap_fd, cap_ad, min_support,
                             projections, use_fis, use_ars, max_retries)

    def _plan_and_build(self, cap_f, cap_a, cap_fd, cap_ad, min_support,
                        projections, use_fis, use_ars, max_retries):
        """Capacities from the measured plan, then the resident state."""
        raw_f = int(host_value(cap_f)) if use_fis else 0
        raw_a = int(host_value(cap_a))
        self.cap_f = _headroom(raw_f) if use_fis else 1
        self.cap_a = _headroom(raw_a)
        raw_fd = raw_ad = 0
        if self.hier is not None:
            raw_fd = int(host_value(cap_fd)) if use_fis else 0
            raw_ad = int(host_value(cap_ad))
            self.cap_f_dcn = _headroom(raw_fd) if use_fis else 1
            self.cap_a_dcn = _headroom(raw_ad)
        else:
            self.cap_f_dcn = 0
            self.cap_a_dcn = 0

        # Lines + downstream load measurement, hot-line placement, the
        # capture table.
        with self._stage("lines"):
            plan = self._build_lines(min_support, projections, use_fis,
                                     use_ars, max_retries)
        with self._stage("rebalance"):
            self._maybe_rebalance()
        with self._stage("captures"):
            self._build_captures(max_retries)
        self._publish_plan(plan, raw_f, raw_a, raw_fd, raw_ad)

    def _build_lines(self, min_support, projections, use_fis, use_ars,
                     max_retries):
        """Exchange A and the join lines, retried on freq/A overflow; then
        the pair-phase plan.  Returns the measured plan maxima."""
        mesh, stats = self.mesh, self.stats
        hier_on = self.hier is not None
        for _ in range(max_retries):
            pend = []
            if use_fis:
                pend.append(exchange.log_exchange(
                    stats, "freq", num_dev=self.num_dev, capacity=self.cap_f,
                    lanes=_LANES_FREQ, reply_lanes=_LANES_FREQ_REPLY,
                    hosts=self.hosts, hier=hier_on,
                    dcn_capacity=self.cap_f_dcn if hier_on else None))
            pend.append(exchange.log_exchange(
                stats, "exchange_a", num_dev=self.num_dev,
                capacity=self.cap_a, lanes=_LANES_EXCHANGE_A,
                hosts=self.hosts, hier=hier_on,
                dcn_capacity=self.cap_a_dcn if hier_on else None))
            t0 = time.perf_counter() if self._timed else 0.0
            with watchdog.collective(
                    "freq", sum(e.get("bytes", 0) for e in pend)):
                line_cols, n_rows, plan, overflow = _lines_step(
                    mesh, self._triples, self._n_valid, min_support,
                    projections=projections, use_fis=use_fis,
                    use_ars=use_ars, cap_freq=self.cap_f,
                    cap_exchange_a=self.cap_a, skew=self.skew,
                    combine=self.combine, cap_freq_dcn=self.cap_f_dcn,
                    cap_exchange_a_dcn=self.cap_a_dcn, hier=self.hier,
                    dcn_chunks=self.dcn_chunks)
                if self._timed:
                    _sync(mesh)
                    exchange.log_dispatch_timing(
                        stats, pend, (time.perf_counter() - t0) * 1e3)
                ovf = host_value(overflow)
            if faults.overflow_injected("overflow@lines"):
                ovf = np.maximum(ovf, 1)
            if int(ovf.sum()) == 0:
                break
            self._count_overflow_retry(
                "line-building",
                site="freq" if int(ovf[0]) > 0 else "exchange_a")
            if ovf[0] > 0:
                self.cap_f = segments.pow2_capacity(2 * self.cap_f
                                                    + int(ovf[0]))
                if hier_on:
                    self.cap_f_dcn = segments.pow2_capacity(
                        2 * self.cap_f_dcn + int(ovf[0]))
            if ovf[1] > 0:
                self.cap_a = segments.pow2_capacity(2 * self.cap_a
                                                    + int(ovf[1]))
                if hier_on:
                    self.cap_a_dcn = segments.pow2_capacity(
                        2 * self.cap_a_dcn + int(ovf[1]))
            _check_exchange_caps(self.num_dev, freq=self.cap_f,
                                 exchange_a=self.cap_a)
        else:
            self._overflow_exhausted(
                "line-building",
                f"freq={int(ovf[0])}, exchange_a={int(ovf[1])}")
        self.lines = line_cols  # jv, code, v1, v2: resident on the rank
        self.n_rows = n_rows
        plan = host_value(plan)
        if os.environ.get("RDFIND_DEBUG_PLAN"):
            print(f"debug plan (per-device maxima): lines_b={int(plan[0])} "
                  f"lines_b_dcn={int(plan[1])} pairs={int(plan[2])} "
                  f"giant_rows={int(plan[3])} giant_pairs={int(plan[4])}",
                  file=sys.stderr, flush=True)
        self.cap_b = _headroom(plan[0])
        self.cap_b_dcn = _headroom(plan[1]) if hier_on else 0
        # Bounded-memory streaming: the pair phase runs as n_pass dep-slice
        # passes when the measured per-rank pair load exceeds the budget.
        budget = int(os.environ.get("RDFIND_PAIR_ROW_BUDGET",
                                    PAIR_ROW_BUDGET))
        full_load = int(plan[2]) + 2 * int(plan[4])
        self.n_pass = max(1, -(-full_load // budget))
        self._plan_pairs = int(plan[2])
        self._plan_giant_pairs = int(plan[4])
        self.cap_p = _headroom(int(plan[2]) // self.n_pass, floor=1 << 10)
        self.cap_g = _headroom(plan[3])
        self.cap_gp = _headroom(2 * int(plan[4]) // self.n_pass,
                                floor=1 << 10)
        self.cap_c = _headroom((self.cap_p + self.cap_gp)
                               // max(self.num_dev, 1), floor=1 << 10)
        self.cap_c_dcn = (_headroom(
            self.hier[1] * ((self.cap_p + self.cap_gp)
                            // max(self.num_dev, 1)) // 2,
            floor=1 << 10) if hier_on else 0)
        self._check_pair_caps()
        if stats is not None:
            metrics.gauge_set(stats, "n_pair_passes", self.n_pass)
        return plan

    def _build_captures(self, max_retries):
        """Exchange B and the capture table (retried on B overflow)."""
        mesh, stats = self.mesh, self.stats
        hier_on = self.hier is not None
        for _ in range(max_retries):
            pend = [exchange.log_exchange(
                stats, "exchange_b", num_dev=self.num_dev,
                capacity=self.cap_b,
                lanes=_LANES_EXCHANGE_B + (1 if hier_on else 0),
                hosts=self.hosts, hier=hier_on,
                dcn_capacity=self.cap_b_dcn if hier_on else None)]
            t0 = time.perf_counter() if self._timed else 0.0
            with watchdog.collective(
                    "captures", sum(e.get("bytes", 0) for e in pend)):
                tbl, n_caps, ovf_b = _captures_step(
                    mesh, *self.lines, self.n_rows,
                    cap_exchange_b=self.cap_b,
                    cap_exchange_b_dcn=self.cap_b_dcn, hier=self.hier,
                    dcn_chunks=self.dcn_chunks)
                if self._timed:
                    _sync(mesh)
                    exchange.log_dispatch_timing(
                        stats, pend, (time.perf_counter() - t0) * 1e3)
                ovf_b = int(host_value(ovf_b))
            if faults.overflow_injected("overflow@captures"):
                ovf_b = max(ovf_b, 1)
            if ovf_b == 0:
                break
            self._count_overflow_retry("capture-count", site="exchange_b")
            self.cap_b = segments.pow2_capacity(2 * self.cap_b + ovf_b)
            if hier_on:
                self.cap_b_dcn = segments.pow2_capacity(
                    2 * self.cap_b_dcn + ovf_b)
            _check_caps(exchange_b=self.num_dev * self.cap_b)
        else:
            self._overflow_exhausted("capture-count", f"exchange_b={ovf_b}")
        self.tbl = tbl  # tc, tv1, tv2, tcnt: resident, capture-owned
        self.n_caps = n_caps

    def _publish_plan(self, plan, raw_f, raw_a, raw_fd, raw_ad):
        """The planned capacities, the data plane's snapshot and the
        integrity plane's stage digests."""
        stats = self.stats
        hier_on = self.hier is not None
        # The plan-time capacities: deterministic per workload + config, and
        # part of every progress fingerprint.
        self._planned_caps = dict(
            freq=self.cap_f, exchange_a=self.cap_a, exchange_b=self.cap_b,
            pairs=self.cap_p, exchange_c=self.cap_c, giant_rows=self.cap_g,
            giant_pairs=self.cap_gp)
        if hier_on:
            self._planned_caps.update(
                freq_dcn=self.cap_f_dcn, exchange_a_dcn=self.cap_a_dcn,
                exchange_b_dcn=self.cap_b_dcn, exchange_c_dcn=self.cap_c_dcn)
        if stats is not None:
            metrics.struct_set(stats, "planned_caps",
                               dict(self._planned_caps))
            # The dtype and kernel modes of the sketch and containment stages
            # (strategies 2 and 3), recorded on every sharded run as the JAX
            # package does.
            metrics.gauge_set(stats, "cooc_dtype", "int8")
            metrics.struct_set(stats, "kernel_resolution",
                               cooc_ops.resolution_report(self.mesh.device))

        if self._datastats_on and stats is not None:
            used = dict(freq=raw_f, exchange_a=raw_a,
                        exchange_b=int(plan[0]),
                        pairs=int(plan[2]) // self.n_pass,
                        giant_rows=int(plan[3]),
                        giant_pairs=2 * int(plan[4]) // self.n_pass)
            if hier_on:
                used.update(freq_dcn=raw_fd, exchange_a_dcn=raw_ad,
                            exchange_b_dcn=int(plan[1]))
            datastats.publish_cap_utilization(stats, self._planned_caps,
                                              used)
            self._collect_datastats()
        if self._integrity_on and stats is not None:
            self._collect_stage_digests()

    @contextlib.contextmanager
    def _stage(self, name: str):
        """One pipeline stage: a named profiler range ("rdfind.sharded.<name>")
        and its host milliseconds in stats["stage_host_ms"]."""
        t0 = time.perf_counter()
        with tracer.profile_range(f"rdfind.sharded.{name}"):
            yield
        self.stage_ms[name] = (time.perf_counter() - t0) * 1e3
        if self.stats is not None:
            metrics.struct_set(self.stats, "stage_host_ms",
                               dict(self.stage_ms))

    def _collect_datastats(self):
        hist, chist, sc = _stage_datastats(
            self.mesh, self.lines[0], self.n_rows, self.tbl[3], self.n_caps,
            giant_load=max(int(self.cap_p) // 4, 1))
        hist, chist = host_value(hist), host_value(chist)
        n_lines, max_line, n_giant, n_capt, max_sup = (
            int(x) for x in host_value(sc))
        datastats.publish_line_stats(
            self.stats, hist=datastats.hist_from_bins(hist),
            n_lines=n_lines, max_line=max_line, giant_lines=n_giant,
            source="sharded")
        datastats.publish_capture_spectrum(
            self.stats, hist=datastats.hist_from_bins(chist),
            n_captures=n_capt, max_support=max_sup, source="sharded")

    def _collect_stage_digests(self):
        lanes = host_value(_stage_digest(self.mesh, self.lines, self.n_rows,
                                         self.tbl, self.n_caps))
        la, lb, ca, cb = (int(x) & integrity.MASK32 for x in lanes)
        integrity.publish_stage(self.stats, "lines", la, lb)
        integrity.publish_stage(self.stats, "captures", ca, cb)

    def _host_digest(self, blocks, block_layout="rows"):
        """Host replica of one pass's digest lanes over its blocks."""
        if block_layout == "sketch":
            return integrity.digest_sketch_rows(blocks[0], self.ha_bits)
        return integrity.digest_rows(blocks)

    def _on_any_rank(self, flags):
        """The mesh-wide OR of per-rank flags (one pmax): a decision that
        leads to collectives, or that must keep the ranks' passes in step,
        is taken on every rank or on none."""
        t = torch.as_tensor(np.asarray(flags, np.int64), device=self.mesh.device)
        return self.mesh.pmax(t).cpu().numpy() != 0

    def _verify_snapshot(self, resumed, what, block_layout="rows"):
        """Digest-attested resume: each loaded pass's content digest (after
        any re-shard; the digest is order-invariant) against the lanes
        persisted with it.  A mismatch on any rank is a clean miss for that
        pass on every rank, plus a named `integrity` degradation;
        RDFIND_INTEGRITY_STRICT=1 fails."""
        passes = sorted(resumed)
        bad = []
        for p in passes:
            blocks_p, tele_p = resumed[p]
            blocks_p = faults.maybe_flip("flip@snapshot", blocks_p,
                                         pass_idx=p)
            resumed[p] = (blocks_p, tele_p)
            ok = len(tele_p) >= _N_TAIL
            if ok:
                want = integrity.lanes_to_digest(tele_p[-2], tele_p[-1])
                ok = self._host_digest(blocks_p, block_layout) == want
            bad.append(not ok)
        out = {}
        for p, miss in zip(passes, self._on_any_rank(bad) if passes else []):
            if not miss:
                out[p] = resumed[p]
                continue
            if integrity.strict():
                raise integrity.IntegrityError(
                    f"{what}: snapshot digest mismatch at pass {p} "
                    f"(RDFIND_INTEGRITY_STRICT=1)")
            faults.record_degradation(self.stats, what, "integrity_miss",
                                      site="snapshot", **{"pass": p})
            integrity.note_mismatch(self.stats, site="snapshot", stage=what,
                                    pass_idx=p)
        return out

    def _verify_pull(self, blocks, tele, p, what, cols, n_out,
                     block_layout="rows"):
        """Verify one freshly pulled pass against its digest lanes.  Pulls
        are pure reads, so a mismatch re-pulls (RDFIND_PULL_RETRIES) before
        it is accepted as real: a transient flip is repaired.  A flip is
        local to one rank's copy, but the re-pull is collective, so the
        verdict is the mesh's: every rank re-pulls while any rank's copy
        mismatches."""
        want = integrity.lanes_to_digest(tele[-2], tele[-1])
        blocks = faults.maybe_flip("flip@host_pull", blocks, pass_idx=p)
        if not self._on_any_rank(
                [self._host_digest(blocks, block_layout) != want])[0]:
            return blocks
        if integrity.strict():
            raise integrity.IntegrityError(
                f"{what}: host-pull digest mismatch at pass {p} "
                f"(RDFIND_INTEGRITY_STRICT=1)")
        tries = max(1, int(os.environ.get("RDFIND_PULL_RETRIES", "3")))
        for _ in range(tries):
            blocks = self.collect_blocks(cols, n_out)
            if not self._on_any_rank(
                    [self._host_digest(blocks, block_layout) != want])[0]:
                integrity.note_mismatch(self.stats, site="host_pull",
                                        stage=what, pass_idx=p,
                                        repaired=True)
                return blocks
        faults.record_degradation(self.stats, what, "integrity_miss",
                                  site="host_pull", **{"pass": p})
        integrity.note_mismatch(self.stats, site="host_pull", stage=what,
                                pass_idx=p)
        return blocks

    def _agreement_payload(self, blocks, p, block_layout="rows") -> list:
        a, b = self._host_digest(blocks, block_layout)
        return [float(p), float(a), float(b)]

    def _agreement_check(self, rows, p, what) -> None:
        """A divergent replica fails on every host alike (each decides from
        the same gathered rows)."""
        if bool((rows.max(axis=0) != rows.min(axis=0)).any()):
            raise integrity.IntegrityError(
                f"{what}: replica digest divergence at pass {p}: "
                f"{rows.tolist()}")

    def _maybe_rebalance(self):
        """Greedy least-loaded reassignment of hot lines over measured
        loads (the reference's LoadBasedPartitioner semantics)."""
        if self.num_dev <= 1:
            return
        mesh = self.mesh
        hot_jv, hot_len, dev_load = _hotlines_step(
            mesh, self.lines[0], self.n_rows, skew=self.skew,
            cap_pairs=self.cap_p * self.n_pass)
        hot_jv = host_gather(mesh, hot_jv).reshape(self.num_dev, -1)
        hot_len = host_gather(mesh, hot_len).reshape(self.num_dev, -1)
        cur = host_gather(mesh, dev_load.reshape(1)).astype(np.float64)
        mask = hot_jv != int(SENTINEL)
        if not mask.any():
            return
        src = np.nonzero(mask)[0]
        jvs = hot_jv[mask]
        lens = hot_len[mask].astype(np.int64)
        loads = lens.astype(np.float64) * (lens - 1)

        base = cur.copy()
        np.add.at(base, src, -loads)
        bins = base.copy()
        dest = np.empty(len(jvs), np.int64)
        for k in np.argsort(-loads):  # heaviest first, least-loaded bin wins
            d = int(np.argmin(bins))
            dest[k] = d
            bins[d] += loads[k]
        if self.stats is not None:
            mean = max(cur.mean(), 1.0)
            metrics.struct_set(self.stats, "rebalance", dict(
                hot_lines=int(len(jvs)),
                moved_lines=int((dest != src).sum()),
                load_max_over_mean_before=round(cur.max() / mean, 3),
                load_max_over_mean_planned=round(bins.max() / mean, 3)))
        if bins.max() >= cur.max() * _REBALANCE_MIN_GAIN:
            metrics.struct_update(self.stats, "rebalance", moved_lines=0)
            return  # hash placement is already close enough to balanced
        moving = dest != src
        if not moving.any():
            return
        mj, md = jvs[moving], dest[moving]
        order = np.argsort(mj)
        mj, md = mj[order], md[order]
        vol = np.zeros((self.num_dev, self.num_dev), np.int64)
        np.add.at(vol, (src[moving], dest[moving]), lens[moving])
        cap_move = _headroom(int(vol.max()), floor=1 << 8)
        h = segments.pow2_capacity(len(mj))
        moved_jv = np.full(h, int(SENTINEL), np.int32)
        moved_jv[:len(mj)] = mj
        moved_dest = np.zeros(h, np.int32)
        moved_dest[:len(mj)] = md
        moved_jv = torch.as_tensor(moved_jv).to(mesh.device)
        moved_dest = torch.as_tensor(moved_dest).to(mesh.device)
        for _ in range(self.max_retries):
            pend = [exchange.log_exchange(self.stats, "rebalance",
                                          num_dev=self.num_dev,
                                          capacity=cap_move,
                                          lanes=_LANES_REBALANCE,
                                          rows=int(lens[moving].sum()),
                                          hosts=self.hosts,
                                          hier=self.hier is not None)]
            t0 = time.perf_counter() if self._timed else 0.0
            with watchdog.collective(
                    "rebalance", sum(e.get("bytes", 0) for e in pend)):
                cols, n_rows, ovf = _rebalance_step(
                    mesh, *self.lines, self.n_rows, moved_jv, moved_dest,
                    cap_move=cap_move, hier=self.hier,
                    dcn_chunks=self.dcn_chunks)
                if self._timed:
                    _sync(mesh)
                    exchange.log_dispatch_timing(
                        self.stats, pend, (time.perf_counter() - t0) * 1e3)
                ovf = int(host_value(ovf))
            if faults.overflow_injected("overflow@rebalance"):
                ovf = max(ovf, 1)
            if ovf == 0:
                break
            self._count_overflow_retry("rebalance", site="rebalance")
            cap_move = segments.pow2_capacity(2 * cap_move + ovf)
        else:
            # Rebalancing is output-neutral placement, so the cheapest safe
            # degradation is to keep hash placement.
            if faults.strict_mode():
                raise RuntimeError(
                    f"rebalance overflow persisted after {self.max_retries} "
                    f"retries ({ovf})")
            faults.record_degradation(self.stats, "rebalance", "skip",
                                      overflow=int(ovf))
            metrics.struct_update(self.stats, "rebalance", moved_lines=0)
            return
        self.lines = cols
        self.n_rows = n_rows

    def _count_overflow_retry(self, phase: str, site: str | None = None,
                              pass_idx: int | None = None) -> None:
        if self.stats is not None:
            metrics.counter_add(self.stats, "n_overflow_retries")
            if site is not None:
                exchange.log_exchange_retry(self.stats, site)
        detail = {} if pass_idx is None else {"pass": int(pass_idx)}
        faults.record_degradation(self.stats, phase, "grow", **detail)

    def _overflow_exhausted(self, phase: str, detail: str):
        msg = (f"{phase} overflow persisted after {self.max_retries} retries "
               f"({detail})")
        if faults.strict_mode():
            raise RuntimeError(msg)
        raise faults.FallbackRequired(phase, detail)

    def _pair_caps(self):
        return dict(cap_pairs=self.cap_p, cap_exchange_c=self.cap_c,
                    cap_giant=self.cap_g, cap_giant_pairs=self.cap_gp,
                    skew=self.skew, cap_exchange_c_dcn=self.cap_c_dcn,
                    hier=self.hier, dcn_chunks=self.dcn_chunks)

    def _grow_pair_caps(self, ovf):
        if ovf[0] > 0:
            self.cap_p = segments.pow2_capacity(2 * self.cap_p + int(ovf[0]))
        if ovf[1] > 0:
            self.cap_c = segments.pow2_capacity(2 * self.cap_c + int(ovf[1]))
        if ovf[2] > 0:
            self.cap_g = segments.pow2_capacity(2 * self.cap_g + int(ovf[2]))
        if ovf[3] > 0:
            self.cap_gp = segments.pow2_capacity(2 * self.cap_gp
                                                 + int(ovf[3]))
        if ovf[4] > 0:
            self.cap_c_dcn = segments.pow2_capacity(
                2 * self.cap_c_dcn + int(ovf[4]))
        self._check_pair_caps()

    def _check_pair_caps(self):
        caps = dict(pair_stream=self.cap_p + self.cap_gp,
                    exchange_b=self.num_dev * self.cap_b,
                    exchange_c=self.num_dev * self.cap_c,
                    giant_gather=self.num_dev * self.cap_g)
        if self.hier is not None:
            caps.update(exchange_b_dcn=self.hosts * self.cap_b_dcn,
                        exchange_c_dcn=self.hosts * self.cap_c_dcn)
        _check_caps(**caps)

    def _reset_pass_caps(self):
        """The per-pass caps for the current n_pass, from the plan maxima
        (the formulas __init__ used)."""
        self.cap_p = _headroom(self._plan_pairs // self.n_pass,
                               floor=1 << 10)
        self.cap_gp = _headroom(2 * self._plan_giant_pairs // self.n_pass,
                                floor=1 << 10)
        self._reset_exchange_c()

    def _reset_exchange_c(self):
        self.cap_c = _headroom((self.cap_p + self.cap_gp)
                               // max(self.num_dev, 1), floor=1 << 10)
        if self.hier is not None:
            self.cap_c_dcn = _headroom(
                self.hier[1] * ((self.cap_p + self.cap_gp)
                                // max(self.num_dev, 1)) // 2,
                floor=1 << 10)
        self._check_pair_caps()

    def _adopt_n_pass(self, n_pass: int) -> None:
        """Re-derive the per-pass plan for a snapshot's pass count, so a
        resumed attempt computes what a fresh run at that n_pass would."""
        if int(n_pass) == self.n_pass:
            return
        self.n_pass = int(n_pass)
        self._reset_pass_caps()
        if self.stats is not None:
            metrics.gauge_set(self.stats, "n_pair_passes", self.n_pass)

    def _note_resume(self, *, vote_rounds=0, resharded_blocks=0,
                     resharded_bytes=0, **fields):
        if self.stats is None:
            return
        cur = self.stats.get("elastic_resume") or {}
        fields.update(
            to_num_dev=self.num_dev,
            vote_rounds=int(cur.get("vote_rounds", 0)) + int(vote_rounds),
            resharded_blocks=(int(cur.get("resharded_blocks", 0))
                              + int(resharded_blocks)),
            resharded_bytes=(int(cur.get("resharded_bytes", 0))
                             + int(resharded_bytes)))
        metrics.struct_update(self.stats, "elastic_resume", **fields)

    def _snapshot_signature(self, snap, has: bool) -> int:
        """One int naming what this rank read from the snapshot files."""
        if not has:
            return 0
        seen = (snap.num_dev, snap.n_pass,
                [(p, snap.parts[p][1]) for p in sorted(snap.parts)])
        return zlib.crc32(repr(seen).encode()) + 1

    def _ranks_agree(self, snap, has: bool) -> bool:
        """All ranks of one host read the same snapshot file; confirm they
        saw the same content before any rank skips a pass (a torn read on
        one rank would otherwise desynchronize the collectives)."""
        if self.num_dev == 1:
            return True
        sig = torch.tensor(self._snapshot_signature(snap, has),
                           dtype=torch.int64, device=self.mesh.device)
        lo = int(self.mesh.pmin(sig))
        hi = int(self.mesh.pmax(sig))
        return lo == hi

    def _resolve_resume(self, snap, *, allow_adopt: bool) -> dict:
        """Which committed passes to skip, under which pass count.  One
        host: a local decision (after the ranks' agreement check).  Several
        hosts: the all-hosts-agree vote, batched into one host allgather of
        [has, stored n_pass, committed-pass bitmap as eight 32-bit words]."""
        has = (snap is not None and bool(snap.parts) and snap.n_pass > 0
               and snap.num_dev > 0)
        if not self._ranks_agree(snap, has):
            return {}
        if self.mesh.num_hosts == 1:
            if not has:
                return {}
            if snap.n_pass != self.n_pass:
                if not allow_adopt:
                    return {}
                self._adopt_n_pass(snap.n_pass)
                self._note_resume(adopted_n_pass=self.n_pass)
            return dict(snap.parts)
        n_words = 8
        if has and snap.n_pass > 32 * n_words:
            has = False
        vote = np.zeros(2 + n_words, np.float64)
        if has:
            vote[0] = 1.0
            vote[1] = float(snap.n_pass)
            for p in snap.parts:
                if 0 <= p < snap.n_pass:
                    w, bit = divmod(int(p), 32)
                    vote[2 + w] = float(int(vote[2 + w]) | (1 << bit))
        votes = allgather_host_values(self.mesh, vote, site="resume_vote")
        self._note_resume(vote_rounds=1)
        holders = votes[votes[:, 0] > 0]
        if holders.shape[0] == 0:
            return {}
        stored = {int(v) for v in holders[:, 1]}
        if len(stored) != 1:
            return {}
        cand = stored.pop()
        if cand != self.n_pass and not allow_adopt:
            return {}
        words = [-1] * n_words
        for row in votes:
            for w in range(n_words):
                words[w] &= int(row[2 + w])
        passes = [p for p in range(cand)
                  if words[p // 32] & (1 << (p % 32))]
        if not passes:
            return {}
        if cand != self.n_pass:
            self._adopt_n_pass(cand)
            self._note_resume(adopted_n_pass=self.n_pass)
        return {p: snap.parts[p] for p in passes}

    def collect_blocks(self, cols, n_out):
        """Per-rank compacted outputs -> the host rows of every rank, in
        rank order (one all_gather of the counts, one of the rows padded to
        the largest count).  The gathers run once on every rank; only the
        local copies to the host go through the fault gate's bounded retry
        (a retry decided on one rank must not re-enter a collective)."""
        mesh = self.mesh
        counts_d = mesh.all_gather(torch.as_tensor(n_out).to(torch.int64)
                                   .reshape(1).to(mesh.device)).reshape(-1)
        counts = faults.guarded_pull(lambda: counts_d.cpu().numpy(),
                                     gate=False)
        top = max(int(counts.max()), 1)
        lanes = torch.stack([_pad_rows(c[:top].to(torch.int32), top)
                             for c in cols])
        rows_d = mesh.all_gather(lanes)                    # (D, K, top)
        rows = faults.guarded_pull(lambda: rows_d.cpu().numpy())
        return [np.concatenate([rows[r, k, :int(counts[r])]
                                for r in range(rows.shape[0])])
                for k in range(len(cols))]

    def capture_table(self):
        """The host capture table (code, v1, v2, support) in (code, v1, v2)
        order, identical on every rank; each capture lives on exactly one
        rank.  The lattice and candidate logic of strategies 1-3 run on it
        host-side, so it must fit one host: RDFIND_HOST_CAPTURES_BUDGET
        (default 2^27 captures) guards it."""
        total = int(self.mesh.psum(torch.as_tensor(self.n_caps)))
        budget = int(os.environ.get("RDFIND_HOST_CAPTURES_BUDGET", 1 << 27))
        if total > budget:
            raise ValueError(
                f"capture table ({total} captures) exceeds the host-side "
                f"lattice budget ({budget}); raise "
                f"RDFIND_HOST_CAPTURES_BUDGET or use strategy 0 "
                f"(fully device-resident)")
        tc, tv1, tv2, tcnt = self.collect_blocks(self.tbl, self.n_caps)
        cap_code, cap_v1, cap_v2, dep_count = (
            a.astype(np.int64) for a in (tc, tv1, tv2, tcnt))
        order = np.lexsort((cap_v2, cap_v1, cap_code))
        return (cap_code[order], cap_v1[order], cap_v2[order],
                dep_count[order])

    def _run_passes(self, step, what: str, *, site: str = "cind",
                    phase_key: str | None = None, fp_extra=None,
                    ledger_sites=("exchange_c", "giant_gather"),
                    block_layout: str = "rows"):
        """Pipelined dep-slice pass executor with the degradation ladder:
        exhausted grow retries double n_pass (up to RDFIND_MAX_PASS_SPLITS
        times), then FallbackRequired.  `ledger_sites` names the exchanges
        the step dispatches; `block_layout` "sketch" marks per-rank count-min
        partials (digested by position, folded rather than re-sharded on an
        elastic resume).  Returns (host blocks, tail counters transposed to
        per-counter tuples of ints)."""
        phase_key = phase_key or site
        seq = self._phase_seq
        self._phase_seq += 1
        n_splits = 0
        while True:
            try:
                return self._attempt_passes(step, what, site, phase_key, seq,
                                            fp_extra, ledger_sites,
                                            block_layout=block_layout,
                                            allow_adopt=(n_splits == 0))
            except _PairCapsExhausted as e:
                if faults.strict_mode():
                    raise RuntimeError(e.msg) from None
                if n_splits < faults.max_pass_splits():
                    n_splits += 1
                    faults.record_degradation(self.stats, what, "split",
                                              n_pass=self.n_pass * 2)
                    self.n_pass *= 2
                    self.cap_p = max(
                        segments.pow2_capacity(self.cap_p // 2), 1 << 10)
                    self.cap_gp = max(
                        segments.pow2_capacity(self.cap_gp // 2), 1 << 10)
                    self._reset_exchange_c()
                    if self.stats is not None:
                        metrics.gauge_set(self.stats, "n_pair_passes",
                                          self.n_pass)
                    continue
                raise faults.FallbackRequired(what, e.msg) from None

    def _load_resume(self, phase_key, seq, fp_extra, what, allow_adopt,
                     block_layout="rows"):
        """(stage, fp, resumed passes) of the progress snapshots."""
        progress = self.progress
        if progress is None:
            return None, None, {}
        stage, fp = progress.phase_fp(
            phase_key, seq,
            extra=dict(what=what, min_support=int(self.min_support),
                       **(fp_extra or {})))
        snap = progress.load(stage, fp)
        resumed = self._resolve_resume(snap, allow_adopt=allow_adopt)
        if resumed and snap.num_dev != self.num_dev:
            if block_layout == "rows":
                nbytes = sum(np.asarray(b).nbytes
                             for blocks_p, _ in resumed.values()
                             for b in blocks_p)
                resumed = {p: (_reshard_pass_rows(blocks_p, self.num_dev),
                               tele_p)
                           for p, (blocks_p, tele_p) in resumed.items()}
                self._note_resume(from_num_dev=int(snap.num_dev),
                                  resharded_blocks=len(resumed),
                                  resharded_bytes=nbytes)
            else:
                # Count-min partials fold by a saturating add, which is
                # grouping-insensitive: _ha_build_table absorbs any count.
                self._note_resume(from_num_dev=int(snap.num_dev))
        if resumed and self._integrity_on:
            resumed = self._verify_snapshot(resumed, what, block_layout)
        return stage, fp, resumed

    def _attempt_passes(self, step, what, site, phase_key, seq, fp_extra,
                        ledger_sites=("exchange_c", "giant_gather"), *,
                        block_layout="rows", allow_adopt=True):
        """One ladder attempt of the pipelined pass loop: pass p+1 is
        dispatched before pass p is pulled (dispatch.pass_depth passes in
        flight); on overflow the in-flight successors are discarded, caps
        grow, and execution resumes from the failed pass."""
        d = dispatch.DispatchStats(pull_base=self._pull_base)
        t_attempt = time.perf_counter()
        meter = _SkewMeter(self.stats, what, self.mesh, self._meter_on)
        progress = self.progress
        stage, fp, resumed = self._load_resume(phase_key, seq, fp_extra,
                                               what, allow_adopt,
                                               block_layout)
        fc = (forecast.Forecaster(self.stats, self.n_pass, phase=what)
              if self.stats is not None and forecast.enabled() else None)
        now = time.perf_counter if meter.active else (lambda: 0.0)
        parts = [None] * self.n_pass
        teles = [None] * self.n_pass
        tries = [0] * self.n_pass
        for p, (blocks_p, tele_p) in resumed.items():
            if 0 <= p < self.n_pass:
                parts[p] = [np.asarray(b) for b in blocks_p]
                teles[p] = tuple(int(x) for x in tele_p)
        n_res = sum(1 for x in parts if x is not None)
        if n_res:
            if self.stats is not None:
                metrics.counter_add(self.stats, "resumed_passes", n_res)
            tracer.instant("elastic_resume", cat=tracer.CAT_RUN,
                           stage=stage or "", what=what,
                           resumed_passes=n_res, num_dev=self.num_dev)
        depth = dispatch.pass_depth()
        inflight = collections.deque()  # (p, cols, n_out, staged telemetry)
        p_next = 0
        hier_on = self.hier is not None
        while p_next < self.n_pass or inflight:
            head = inflight[0][0] if inflight else p_next
            with tracer.span("pass", cat=tracer.CAT_PASS, what=what,
                             **{"pass": head}):
                t_fill = now()
                while p_next < self.n_pass and len(inflight) < depth:
                    if parts[p_next] is not None:  # resumed from a snapshot
                        p_next += 1
                        continue
                    with tracer.span("dispatch", cat=tracer.CAT_DISPATCH,
                                     what=what, **{"pass": p_next}):
                        # Every dispatched pass moves its full fixed-shape
                        # exchange-C and giant-gather buffers, discarded
                        # optimistic dispatches included.
                        pend = []
                        if "exchange_c" in ledger_sites:
                            pend.append(exchange.log_exchange(
                                self.stats, "exchange_c",
                                num_dev=self.num_dev, capacity=self.cap_c,
                                lanes=_LANES_EXCHANGE_C, hosts=self.hosts,
                                hier=hier_on,
                                dcn_capacity=(self.cap_c_dcn if hier_on
                                              else None)))
                        if "giant_gather" in ledger_sites:
                            pend.append(exchange.log_exchange(
                                self.stats, "giant_gather",
                                num_dev=self.num_dev,
                                capacity=min(
                                    self.cap_g,
                                    self.lines[0].shape[0]),
                                lanes=_LANES_GIANT, hosts=self.hosts))
                        t0 = time.perf_counter() if self._timed else 0.0
                        cols, n_out, tele = step(p_next)
                        if self._timed:
                            _sync(self.mesh)
                            exchange.log_dispatch_timing(
                                self.stats, pend,
                                (time.perf_counter() - t0) * 1e3)
                        staged = dispatch.stage_to_host([tele])
                    inflight.append((p_next, cols, n_out, staged))
                    p_next += 1
                if not inflight:
                    break  # everything left was already resumed
                d.saw_in_flight(len(inflight))
                p, cols, n_out, staged = inflight.popleft()
                t_counters = now()
                pass_nbytes = self.num_dev * (
                    self.cap_c * _LANES_EXCHANGE_C + self.cap_g * _LANES_GIANT
                ) * 4
                with watchdog.collective("pairs", pass_nbytes):
                    tele_h = d.timed_pull(
                        lambda: exchange.unpack_counters(
                            faults.guarded_pull(
                                lambda: _read_staged(staged)), _TELE_LANES),
                        overlapped=bool(inflight), what="pull-counters")
                ovf = tele_h[:_N_OVF]
                if faults.overflow_injected(f"overflow@{site}", pass_idx=p):
                    ovf = np.maximum(np.asarray(ovf), 1)
                if int(ovf.sum()) != 0:
                    tries[p] += 1
                    if tries[p] >= self.max_retries:
                        if self.stats is not None:
                            d.publish(self.stats)
                        raise _PairCapsExhausted(
                            f"{what} overflow persisted after "
                            f"{self.max_retries} retries "
                            f"({np.asarray(ovf).tolist()})")
                    self._count_overflow_retry(what, site="exchange_c",
                                               pass_idx=p)
                    inflight.clear()  # discard optimistic successors
                    self._grow_pair_caps(ovf)
                    d.n_cap_retries += 1
                    p_next = p  # resume from the failed pass only
                    continue
                t_blocks = now()
                with watchdog.collective("pairs", pass_nbytes):
                    parts[p] = d.timed_pull(
                        lambda: self.collect_blocks(cols, n_out),
                        overlapped=bool(inflight), what="pull-blocks")
                teles[p] = tuple(int(x) for x in tele_h[_N_OVF:])
                agree_payload = None
                if self._integrity_on:
                    parts[p] = self._verify_pull(parts[p], teles[p], p, what,
                                                 cols, n_out, block_layout)
                    agree_payload = self._agreement_payload(parts[p], p,
                                                            block_layout)
                if self._datastats_on or fc is not None:
                    ngl_p, ngp_p, npt_p = teles[p][:3]
                    fr = {"pairs": ((npt_p - ngp_p)
                                    / max(self.num_dev * self.cap_p, 1)),
                          "giant_pairs": (ngp_p
                                          / max(self.num_dev * self.cap_gp,
                                                1))}
                    metrics.gauge_set(None, "run_pass", p)
                    if self._datastats_on:
                        datastats.publish_pass_utilization(self.stats, p, fr)
                    if fc is not None:
                        fc.step(p, fr)
                t_commit = now()
                if tracer.enabled() or metrics.export_requested():
                    obs_memory.sample(self.stats, label=f"{what} pass {p}")
                if progress is not None:
                    progress.submit(stage, fp, {
                        i: (parts[i], teles[i]) for i in range(self.n_pass)
                        if parts[i] is not None},
                        num_dev=self.num_dev, n_pass=self.n_pass)
                if meter.active or agree_payload is not None:
                    # One per-pass host collective carries the digest
                    # agreement and the skew sample.
                    t_end = now()
                    vec = meter.vec({
                        "exchange": (t_counters - t_fill) * 1e3,
                        "compute": (t_blocks - t_counters) * 1e3,
                        "pull": (t_commit - t_blocks) * 1e3,
                        "commit": (t_end - t_commit) * 1e3,
                    }) if meter.active else []
                    agree_head = agree_payload or []
                    rows = allgather_host_values(self.mesh, agree_head + vec,
                                                 site="pass_commit")
                    if agree_payload is not None:
                        self._agreement_check(rows[:, :3], p, what)
                    if meter.active:
                        meter.pass_committed_rows(
                            vec, rows[:, len(agree_head):])
                if faults.fires("preempt@discover", pass_idx=p):
                    if progress is not None:
                        progress.flush()  # the SIGTERM handler's analog
                    raise faults.Preempted(
                        f"injected preemption after {what} pass {p}")
        blocks = [np.concatenate([part[i] for part in parts])
                  for i in range(len(parts[0]))]
        if self.stats is not None:
            d.publish(self.stats)
            watchdog.publish(self.stats)
            metrics.gauge_set(self.stats, "cap_p_final", self.cap_p)
            metrics.struct_set(
                self.stats, "overlap",
                d.overlap_report((time.perf_counter() - t_attempt) * 1e3,
                                 n_passes=self.n_pass))
        meter.publish()
        if self._integrity_on and self.stats is not None:
            # The passes partition the phase's rows, so the wraparound sum
            # of the per-pass lanes is the phase's digest.
            da = sum(int(t[-2]) for t in teles) & integrity.MASK32
            db = sum(int(t[-1]) for t in teles) & integrity.MASK32
            integrity.publish_stage(self.stats, phase_key, da, db,
                                    what=what, n_pass=self.n_pass)
        return blocks, tuple(zip(*teles))

    def run_cinds(self):
        """AllAtOnce finish over the resident lines."""
        def step(p):
            return _cind_step(self.mesh, self.lines, self.n_rows, self.tbl,
                              self.n_caps, self.min_support, p, self.n_pass,
                              **self._pair_caps())

        with self._stage("passes"):
            blocks, (ngl, ngp, npt, *_) = self._run_passes(
                step, "pair-phase", site="cind", phase_key="cind")
        if self.stats is not None:
            # max across passes: a mid-run cap_p growth shifts the giant
            # threshold between passes.
            metrics.gauge_set(self.stats, "n_giant_lines", max(ngl))
            metrics.gauge_set(self.stats, "n_giant_pairs", sum(ngp))
            metrics.counter_add(self.stats, "total_pairs", sum(npt))
        return blocks

    def _flag_table(self, fcode, fv1, fv2, fflag, n_flags):
        dev = self.mesh.device
        return tuple(torch.as_tensor(np.ascontiguousarray(a)).to(dev)
                     for a in (fcode, fv1, fv2, fflag)) + (int(n_flags[0]),)

    def _ha_build_table(self, flags, stat_key, digest):
        """Round 1 of the half-approximate round: per-pass, per-rank
        count-min partials over the level's pair stream (the verification
        passes' ladder and progress snapshots: an incomplete build would make
        the cut unsound), then one saturating fold + all-reduce.  Returns the
        global (ha_bits,) int32 table on the rank's device."""
        def step(p):
            return _s2l_sketch_build_step(
                self.mesh, self.lines, self.n_rows, flags, p, self.n_pass,
                cap_pairs=self.cap_p, cap_giant=self.cap_g,
                cap_giant_pairs=self.cap_gp, skew=self.skew,
                ha_bits=self.ha_bits, ha_hashes=self.ha_hashes)

        blocks, (ngl, ngp, npt, *_) = self._run_passes(
            step, "HA sketch build", site="cooc", phase_key=f"{stat_key}:ha1",
            fp_extra={"flags": digest,
                      "ha": [self.ha_bits, self.ha_hashes, self.ha_thresh]},
            ledger_sites=("giant_gather",), block_layout="sketch")
        # The pulled partials may come from another mesh size (an elastic
        # resume): each is one row, zero-padded to the mesh (zero is the
        # fold's identity) and split evenly; the saturating add folds any
        # arrangement to the same min(cap, true sum) table.
        parts = np.asarray(blocks[0], np.int32).reshape(-1, self.ha_bits)
        pad = -parts.shape[0] % self.num_dev
        if pad:
            parts = np.concatenate(
                [parts, np.zeros((pad, self.ha_bits), np.int32)])
        mine = parts.reshape(self.num_dev, -1, self.ha_bits)[self.mesh.rank]
        pend = [exchange.log_sketch_allreduce(
            self.stats, num_dev=self.num_dev, bits=self.ha_bits,
            hosts=self.hosts, hier=self.hier is not None)]
        t0 = time.perf_counter() if self._timed else 0.0
        with watchdog.collective(
                "sketch", sum(e.get("bytes", 0) for e in pend)):
            table = _ha_reduce_step(
                self.mesh, torch.as_tensor(np.ascontiguousarray(mine)).to(
                    self.mesh.device),
                cap=sketch.MAX_COUNT_MIN_CAP, hier=self.hier)
            if self._timed:
                _sync(self.mesh)
                exchange.log_dispatch_timing(
                    self.stats, pend, (time.perf_counter() - t0) * 1e3)
        if self.stats is not None:
            metrics.counter_add(self.stats, "ha_build_rounds")
            metrics.counter_add(self.stats, "total_pairs", sum(npt))
            metrics.counter_max(self.stats, "n_giant_lines", max(ngl))
            metrics.counter_add(self.stats, "n_giant_pairs", sum(ngp))
            metrics.gauge_set(self.stats, "ha_sketch_bits", self.ha_bits)
            metrics.gauge_set(self.stats, "ha_sketch_bytes",
                              self.ha_bits * 4)
            if self._datastats_on:
                # The table's load factor: the dial for RDFIND_SHARDED_HA_BITS.
                datastats.publish_cap_utilization(
                    self.stats, {"ha_sketch": self.ha_bits},
                    {"ha_sketch": int((table != 0).sum())})
        return table

    def run_cooc(self, fcode, fv1, fv2, fflag, n_flags, stat_key):
        """One SmallToLarge level's verification over the resident lines:
        the level's flag table (host arrays, replicated) joined onto the rows
        and the masked pair phase.  Returns the host blocks (dep key, ref
        key, cooc).  With the half-approximate round on, the round-1 table's
        cut runs inside the pair phase (the same output)."""
        # The flag table names the level: a progress snapshot of one level
        # never satisfies another (the JAX package's fingerprint bytes).
        digest = hashlib.sha256(b"".join(
            np.ascontiguousarray(a).tobytes()
            for a in (fcode, fv1, fv2, fflag, n_flags))).hexdigest()
        flags = self._flag_table(fcode, fv1, fv2, fflag, n_flags)
        ha_cut = None
        if self.ha_on:
            ha_cut = (self._ha_build_table(flags, stat_key, digest),
                      self.ha_bits, self.ha_hashes, self.ha_thresh)

        def step(p):
            return _s2l_cooc_step(self.mesh, self.lines, self.n_rows, flags,
                                  p, self.n_pass, ha_cut=ha_cut,
                                  **self._pair_caps())

        fp_extra = {"flags": digest}
        if ha_cut is not None:
            # The cut changes exchange C's contents: round-2 snapshots and
            # knob-off ones never satisfy each other.
            fp_extra["ha"] = [self.ha_bits, self.ha_hashes, self.ha_thresh]
        blocks, (ngl, ngp, npt, nha, *_) = self._run_passes(
            step, "sharded S2L cooc", site="cooc", phase_key=stat_key,
            fp_extra=fp_extra)
        if self.stats is not None:
            metrics.gauge_set(self.stats, stat_key, sum(npt))
            metrics.counter_add(self.stats, "total_pairs", sum(npt))
            metrics.counter_max(self.stats, "n_giant_lines", max(ngl))
            metrics.counter_add(self.stats, "n_giant_pairs", sum(ngp))
            if ha_cut is not None:
                metrics.counter_add(self.stats, "ha_cut_pairs", sum(nha))
        return blocks


def _pad_rows(t, n: int):
    """`t` zero-padded along dim 0 to `n` rows (a rank's variable-length
    output on the fixed-shape wire of an all_gather)."""
    if t.shape[0] >= n:
        return t
    return torch.nn.functional.pad(t, (0, n - t.shape[0]))


def _read_staged(staged) -> np.ndarray:
    host, done = staged
    if done is not None:
        done.synchronize()
    return host[0].numpy()


def _gather_rows(mesh, block, n_rows) -> np.ndarray:
    """Every rank's valid prefix of its (t, ...) row block, concatenated in
    rank order, on the host of every rank."""
    counts = host_gather(mesh, torch.tensor([int(n_rows)], dtype=torch.int64,
                                            device=mesh.device))
    top = max(int(counts.max()), 1)
    rows = host_gather(mesh, block[:top].contiguous())
    rows = rows.reshape((mesh.size, -1) + tuple(block.shape[1:]))
    return np.concatenate([rows[r, :int(counts[r])]
                           for r in range(mesh.size)])


def _gather_preshard_triples(mesh, preshard) -> np.ndarray:
    """The host triple table of a preshard (the fallback rung trades the
    no-host-table property for finishing the run: at a size one device
    finishes, the table fits one host)."""
    block, n_valid = preshard
    return _gather_rows(mesh, block.to(mesh.device), n_valid)


def _single_device_fallback(kind: str, exc, triples, preshard, min_support,
                            projections, use_fis, use_ars, clean_implied,
                            stats, mesh, **kwargs) -> CindTable:
    """The degradation ladder's last rung: re-run the workload on the
    strategy family's output-identical single-device strategy (every rank
    alike, no collectives after the preshard gather)."""
    from . import allatonce, approximate, late_bb, small_to_large

    fn = {"allatonce": allatonce.discover,
          "small_to_large": small_to_large.discover,
          "approximate": approximate.discover,
          "late_bb": late_bb.discover}[kind]
    print(f"rdfind: sharded {exc.phase} could not complete ({exc.detail}); "
          f"degrading to the single-device {kind} strategy",
          file=sys.stderr)
    faults.record_degradation(stats, exc.phase, "fallback", strategy=kind,
                              reason=exc.detail)
    if triples is None and preshard is not None:
        triples = _gather_preshard_triples(mesh, preshard)
    if triples is None or np.asarray(triples).shape[0] == 0:
        return CindTable.empty()
    return fn(np.asarray(triples, np.int32), min_support,
              projections=projections, use_frequent_condition_filter=use_fis,
              use_association_rules=use_ars, clean_implied=clean_implied,
              stats=stats, device=mesh.device, **kwargs)


def _publish_output_digest(stats, table):
    """Stamp the run's output digest (order-invariant over the final CIND
    set, so equal across mesh sizes) into the integrity stages."""
    if stats is not None and integrity.enabled():
        integrity.publish_stage(
            stats, "output", *integrity.digest_table(table),
            rows=int(np.asarray(table.support).shape[0]))


def _publish_transport(mesh, stats, wire0: int) -> None:
    """What crossed the exchange wire, summed over the ranks (the ledger's
    exchange_sites count the fixed-shape buffers), and on the card every
    rank's peak device memory (collectives on every rank)."""
    wire = mesh.psum(torch.tensor(exchange.wire_bytes() - wire0))
    metrics.gauge_set(stats, "exchange_wire_bytes", int(wire))
    if mesh.device.type == "cuda":
        peak = torch.tensor([torch.cuda.max_memory_allocated(mesh.device)],
                            dtype=torch.int64, device=mesh.device)
        metrics.struct_set(stats, "peak_mem_bytes_per_rank",
                           mesh.all_gather(peak).reshape(-1).tolist())


def _check_preshard(triples, preshard, use_ars, use_fis):
    """Host table xor a preshard: (triples as int32 or None, use_ars).  With
    a preshard, association rules are mined by the distributed miner."""
    use_ars = use_ars and use_fis
    if preshard is not None:
        return None, use_ars
    triples = np.asarray(triples, np.int32).reshape(-1, 3)
    if triples.shape[0] == 0:
        return None, use_ars
    return triples, use_ars


def _mine_rules(triples, preshard, min_support, mesh):
    """The rule table of the AR filter: host mining over a host table, the
    distributed miner over a preshard."""
    if preshard is not None:
        return mine_ars_sharded(preshard[0], preshard[1], min_support, mesh)
    from . import allatonce
    return frequency.mine_association_rules(
        allatonce.triples_on(triples, mesh.device), min_support)


def _finish_table(table, triples, preshard, min_support, use_ars,
                  clean_implied, stats, mesh) -> CindTable:
    """The AR filter, sharded minimality and the output digest."""
    if use_ars:
        from . import allatonce
        rules = _mine_rules(triples, preshard, min_support, mesh)
        if stats is not None:
            metrics.struct_set(stats, "association_rules", rules)
        table = allatonce.filter_ar_implied_cinds(table, rules)
    if clean_implied:
        table = minimality.minimize_table_sharded(table, mesh)
    _publish_output_digest(stats, table)
    return table


def discover_sharded(triples, min_support: int, mesh=None,
                     projections: str = "spo", use_fis: bool = False,
                     use_ars: bool = False, clean_implied: bool = False,
                     max_retries: int = 4, stats: dict | None = None,
                     skew: SkewPolicy | None = None, combine: bool = True,
                     preshard=None, progress=None, device=None) -> CindTable:
    """Discover all CINDs with the AllAtOnce step sharded over the rank mesh.

    Call it on every rank of a launch (``parallel/launch.py``; ``discover_on``
    does both); with no mesh and no launch it runs on a one-rank mesh on
    `device`.  Every rank returns the whole table, identical to
    ``allatonce.discover`` with matching flags.  `stats` receives the skew
    counters (n_giant_lines, n_giant_pairs), the capacity plan
    (planned_caps), the exchange ledger (exchange_sites), the bytes that
    crossed the wire (exchange_wire_bytes) and the transport (dist_backend,
    staged).  `preshard` = (this rank's (t, 3) int32 row block, its valid
    row count) replaces `triples` (which may then be None).
    """
    if mesh is None:
        mesh = make_mesh(device)
    triples, use_ars = _check_preshard(triples, preshard, use_ars, use_fis)
    if triples is None and preshard is None:
        return CindTable.empty()
    if not any(ch in projections for ch in "spo"):
        return CindTable.empty()
    min_support = max(int(min_support), 1)

    wire0 = exchange.wire_bytes()
    try:
        pipe = _Pipeline(mesh, triples, min_support, projections, use_fis,
                         use_ars, max_retries, stats, skew=skew,
                         combine=combine, preshard=preshard,
                         progress=progress)
        d_code, d_v1, d_v2, r_code, r_v1, r_v2, support = pipe.run_cinds()
    except faults.FallbackRequired as e:
        return _single_device_fallback(
            "allatonce", e, triples, preshard, min_support, projections,
            use_fis, use_ars, clean_implied, stats, mesh)
    _publish_transport(mesh, stats, wire0)
    table = CindTable(
        dep_code=d_code.astype(np.int64), dep_v1=d_v1.astype(np.int64),
        dep_v2=d_v2.astype(np.int64), ref_code=r_code.astype(np.int64),
        ref_v1=r_v1.astype(np.int64), ref_v2=r_v2.astype(np.int64),
        support=support.astype(np.int64))
    return _finish_table(table, triples, preshard, min_support, use_ars,
                         clean_implied, stats, mesh)


# ---------------------------------------------------------------------------
# Strategies 1-3 over the resident join lines.
# ---------------------------------------------------------------------------


class _ShardedCooc:
    """The verification backend of the lattice and of the candidate rounds:
    each call ships the flagged captures as a replicated flag table and runs
    the masked pair phase on the mesh (the analog of the reference's
    broadcast candidate Bloom filters)."""

    def __init__(self, pipe: _Pipeline, cap_table):
        self.pipe = pipe
        self.cap_code, self.cap_v1, self.cap_v2, self.dep_count = cap_table

    def cooc(self, dep_ok, ref_ok, stat_key):
        """Global (dep, ref) -> co-occurrence counts of flagged capture
        pairs, as capture ids of the table."""
        from .small_to_large import _lookup_capture_ids

        sel = np.flatnonzero(dep_ok | ref_ok)
        z = np.zeros(0, np.int64)
        if sel.size == 0:
            return z, z, z
        flag = dep_ok[sel].astype(np.int32) * 2 + ref_ok[sel].astype(np.int32)
        cap_f = segments.pow2_capacity(sel.size)

        def pad(a, fill):
            return np.concatenate([a, np.full(cap_f - a.shape[0], fill,
                                              a.dtype)])

        d_code, d_v1, d_v2, r_code, r_v1, r_v2, cnt = self.pipe.run_cooc(
            pad(self.cap_code[sel].astype(np.int32), SENTINEL),
            pad(self.cap_v1[sel].astype(np.int32), SENTINEL),
            pad(self.cap_v2[sel].astype(np.int32), SENTINEL),
            pad(flag, 0), np.full(1, sel.size, np.int32), stat_key)
        d = _lookup_capture_ids(self.cap_code, self.cap_v1, self.cap_v2,
                                d_code.astype(np.int64),
                                d_v1.astype(np.int64), d_v2.astype(np.int64))
        r = _lookup_capture_ids(self.cap_code, self.cap_v1, self.cap_v2,
                                r_code.astype(np.int64),
                                r_v1.astype(np.int64), r_v2.astype(np.int64))
        ok = (d >= 0) & (r >= 0)
        return d[ok], r[ok], cnt[ok].astype(np.int64)


# Dependents per K2 launch of the sketch stage (the single-device tile).
SKETCH_DEP_TILE = 1 << 12
# The sketch stage holds (rows x bits) Bloom bytes on a rank at once.
SKETCH_PLANES_BUDGET = int(os.environ.get("RDFIND_SKETCH_PLANES_BUDGET",
                                          4 << 30))
# When set, the sketch stage keeps its first K2 operands in K2_TILE (the
# chip check's real tile); off by default.
KEEP_K2_TILE = False
K2_TILE: dict = {}


def _and_blocks(mesh, partial, block: int) -> torch.Tensor:
    """The AND over ranks of `partial`'s rows [rank * block, (rank + 1) *
    block): one all_to_all of packed words sends block j to rank j (a
    reduce-scatter by AND; the JAX package takes the pmin of the 0/1 planes
    and slices its block)."""
    d = mesh.size
    if d == 1:
        return partial
    w = partial.shape[1]
    recv = mesh.all_to_all(partial.reshape(d, block * w))
    own = recv[0].clone()
    for j in range(1, d):
        own &= recv[j]
    return own.reshape(block, w)


def _sketch_step(mesh, lines, n_rows, cap_cols, n_caps: int, *, c_pad: int,
                 bits: int, num_hashes: int):
    """This rank's candidate pairs of the sketch round: the Bloom rows of its
    lines, the per-dependent AND of those (partial across ranks, then the
    AND of the rank's own dependent block), and K2 on the block against
    every ref, tile by tile.  Returns (dep ids, ref ids, count) as int32
    tensors in dep-major, ref-ascending order; rank order is dep order."""
    jv, code, v1, v2 = lines
    dev = jv.device
    n = jv.shape[0]
    valid = torch.arange(n, device=dev) < n_rows
    cap_idx = segments.padded_table_index(list(cap_cols), n_caps,
                                          [code, v1, v2], valid)
    ok = valid & (cap_idx >= 0)
    cap_id = torch.clamp(cap_idx, min=0).to(torch.int32)
    starts = segments.run_starts([torch.where(valid, jv, SENTINEL)]) & valid
    line_gid = torch.cumsum(starts.to(torch.int64), 0) - 1
    n_lines = int(starts.sum())
    partial = torch.full((c_pad, bits // 32), -1, dtype=torch.int32,
                         device=dev)
    if n_lines:
        blooms = sketch.build_line_blooms(line_gid, cap_id, ok,
                                          num_lines=n_lines, bits=bits,
                                          num_hashes=num_hashes)
        sketch.intersect_dep_sketches_acc(partial, cap_id, line_gid, blooms,
                                          ok)
    block = c_pad // mesh.size
    own = _and_blocks(mesh, partial, block)
    dep_lo = mesh.rank * block

    kernels.check_contains_library(dev)
    ref_ids = torch.arange(c_pad, dtype=torch.int32, device=dev)
    ref_ok = ref_ids < n_caps
    ref_pack = sketch.pack_ref_bits(ref_ids, bits=bits, num_hashes=num_hashes)
    tile = cooc_ops.tile_for(block, SKETCH_DEP_TILE)
    deps, refs = [], []
    for lo in range(0, block, tile):
        if KEEP_K2_TILE and lo == 0:
            K2_TILE.update(sketch=own[:tile].contiguous(),
                           ref_packed=ref_pack[0], ref_popc=ref_pack[1])
        cand = sketch.contains_matrix(own[lo:lo + tile], ref_ids, ref_ok,
                                      bits=bits, num_hashes=num_hashes,
                                      ref_pack=ref_pack)
        g = dep_lo + lo + torch.arange(tile, dtype=torch.int32, device=dev)
        cand &= (g < n_caps)[:, None]
        cand &= g[:, None] != ref_ids[None, :]
        d, r = torch.nonzero(cand, as_tuple=True)
        deps.append((d + dep_lo + lo).to(torch.int32))
        refs.append(r.to(torch.int32))
    dep = torch.cat(deps)
    return dep, torch.cat(refs), dep.shape[0]


def _sharded_sketch_candidates(pipe, cap_table, bits: int, num_hashes: int,
                               stats):
    """(cand_dep, cand_ref) capture-id pairs of the mesh-tiled containment
    test over the frequent-capture table, in the JAX package's order."""
    rows_cap = pipe.lines[0].shape[0]
    if rows_cap * bits > SKETCH_PLANES_BUDGET:
        raise ValueError(
            f"sharded sketch stage would materialize ~{rows_cap * bits >> 30} "
            f"GiB of line-bloom planes per rank; lower sketch_bits or use "
            f"strategy 0/1 (RDFIND_SKETCH_PLANES_BUDGET overrides)")
    cap_code, cap_v1, cap_v2, _ = cap_table
    num_caps = cap_code.shape[0]
    # A multiple of 128 per rank: the rank blocks tile the table exactly.
    c_pad = cooc_ops.cap_pad(num_caps, mult=128 * pipe.num_dev)
    if stats is not None:
        metrics.struct_set(stats, "sketch_plan",
                           {"c_real": int(num_caps), "c_pad": int(c_pad)})

    def pad(a):
        return torch.as_tensor(np.concatenate(
            [a.astype(np.int32),
             np.full(c_pad - num_caps, SENTINEL, np.int32)])).to(
                 pipe.mesh.device)

    with pipe._stage("sketch"):
        dep, ref, n = _sketch_step(
            pipe.mesh, pipe.lines, pipe.n_rows,
            (pad(cap_code), pad(cap_v1), pad(cap_v2)), num_caps, c_pad=c_pad,
            bits=bits, num_hashes=num_hashes)
        d, r = pipe.collect_blocks([dep, ref], n)
    if stats is not None:
        metrics.gauge_set(stats, "n_sketch_candidates", int(d.size))
    return d.astype(np.int64), r.astype(np.int64)


def _frequent_captures(pipe, min_support, stats, n_triples):
    """The pipeline's capture table cut to the frequent captures (no other
    capture is in a CIND on either side), with the run's table statistics;
    None when none is frequent."""
    cap_code, cap_v1, cap_v2, dep_count = pipe.capture_table()
    freq = dep_count >= min_support
    cap_table = tuple(a[freq] for a in (cap_code, cap_v1, cap_v2, dep_count))
    if cap_table[0].shape[0] == 0:
        return None
    if stats is not None:
        metrics.set_many(stats, n_triples=n_triples,
                         n_captures=int(cap_table[0].shape[0]),
                         total_pairs=0)
    return cap_table


def _n_triples(mesh, triples, preshard) -> int:
    if preshard is None:
        return int(triples.shape[0])
    return int(mesh.psum(torch.tensor(int(preshard[1]))))


def _table_of(cap_table, d, r, sup) -> CindTable:
    cap_code, cap_v1, cap_v2, _ = cap_table
    return CindTable(dep_code=cap_code[d], dep_v1=cap_v1[d],
                     dep_v2=cap_v2[d], ref_code=cap_code[r],
                     ref_v1=cap_v1[r], ref_v2=cap_v2[r], support=sup)


def _sharded_prep_approx(triples, min_support, mesh, projections, use_fis,
                         use_ars, max_retries, sketch_bits, sketch_hashes,
                         stats, skew=None, combine=True, preshard=None,
                         progress=None):
    """Shared set-up of strategies 2 and 3: the pipeline, the frequent
    capture table, the sketch candidates and the verification backend; None
    when no capture is frequent."""
    pipe = _Pipeline(mesh, triples, min_support, projections, use_fis,
                     use_ars, max_retries, stats, skew=skew, combine=combine,
                     preshard=preshard, progress=progress)
    cap_table = _frequent_captures(pipe, min_support, stats,
                                   _n_triples(mesh, triples, preshard))
    if cap_table is None:
        return None
    cand_dep, cand_ref = _sharded_sketch_candidates(
        pipe, cap_table, sketch_bits, sketch_hashes, stats)
    return cap_table, cand_dep, cand_ref, _ShardedCooc(pipe, cap_table)


def discover_sharded_approx(triples, min_support: int, mesh=None,
                            projections: str = "spo", use_fis: bool = False,
                            use_ars: bool = False, clean_implied: bool = False,
                            max_retries: int = 4,
                            sketch_bits: int = sketch.DEFAULT_BITS,
                            sketch_hashes: int = sketch.DEFAULT_HASHES,
                            stats: dict | None = None,
                            skew: SkewPolicy | None = None,
                            combine: bool = True, preshard=None,
                            progress=None, device=None) -> CindTable:
    """Sharded ApproximateAllAtOnce (strategy 2): the mesh-tiled sketch
    containment (K2 on every rank's dependent block) for candidates, the
    sharded pair phase for their exact verification.  Output equals
    ``approximate.discover`` (= the raw AllAtOnce output)."""
    from . import small_to_large

    if mesh is None:
        mesh = make_mesh(device)
    triples, use_ars = _check_preshard(triples, preshard, use_ars, use_fis)
    if triples is None and preshard is None:
        return CindTable.empty()
    if not any(ch in projections for ch in "spo"):
        return CindTable.empty()
    min_support = max(int(min_support), 1)

    wire0 = exchange.wire_bytes()
    try:
        prep = _sharded_prep_approx(
            triples, min_support, mesh, projections, use_fis, use_ars,
            max_retries, sketch_bits, sketch_hashes, stats, skew=skew,
            combine=combine, preshard=preshard, progress=progress)
        if prep is None:
            return CindTable.empty()
        cap_table, cand_dep, cand_ref, backend = prep
        cap_code, cap_v1, cap_v2, dep_count = cap_table
        with backend.pipe._stage("verify"):
            d, r, sup = small_to_large._verify_level(
                backend.cooc, cand_dep, cand_ref, cap_code.shape[0],
                dep_count, cap_code, cap_v1, cap_v2, min_support,
                "pairs_verify", mesh.device)
    except faults.FallbackRequired as e:
        return _single_device_fallback(
            "approximate", e, triples, preshard, min_support, projections,
            use_fis, use_ars, clean_implied, stats, mesh,
            sketch_bits=sketch_bits, sketch_hashes=sketch_hashes)
    _publish_transport(mesh, stats, wire0)
    return _finish_table(_table_of(cap_table, d, r, sup), triples, preshard,
                         min_support, use_ars, clean_implied, stats, mesh)


def discover_sharded_late_bb(triples, min_support: int, mesh=None,
                             projections: str = "spo", use_fis: bool = False,
                             use_ars: bool = False,
                             clean_implied: bool = False,
                             max_retries: int = 4,
                             sketch_bits: int = sketch.DEFAULT_BITS,
                             sketch_hashes: int = sketch.DEFAULT_HASHES,
                             stats: dict | None = None,
                             skew: SkewPolicy | None = None,
                             combine: bool = True, preshard=None,
                             progress=None, device=None) -> CindTable:
    """Sharded LateBB (strategy 3): one mesh-tiled sketch round, then the
    unary-dependent round and the 1/x-pruned binary round verify on the
    mesh.  Output equals ``late_bb.discover``."""
    from . import small_to_large

    if mesh is None:
        mesh = make_mesh(device)
    triples, use_ars = _check_preshard(triples, preshard, use_ars, use_fis)
    if triples is None and preshard is None:
        return CindTable.empty()
    if not any(ch in projections for ch in "spo"):
        return CindTable.empty()
    min_support = max(int(min_support), 1)

    wire0 = exchange.wire_bytes()
    dev = mesh.device
    try:
        prep = _sharded_prep_approx(
            triples, min_support, mesh, projections, use_fis, use_ars,
            max_retries, sketch_bits, sketch_hashes, stats, skew=skew,
            combine=combine, preshard=preshard, progress=progress)
        if prep is None:
            return CindTable.empty()
        cap_table, cand_dep, cand_ref, backend = prep
        cap_code, cap_v1, cap_v2, dep_count = cap_table
        num_caps = cap_code.shape[0]
        dep_is_unary = np.asarray(cc.is_unary(cap_code))[cand_dep]
        with backend.pipe._stage("verify"):
            d1, r1, sup1 = small_to_large._verify_level(
                backend.cooc, cand_dep[dep_is_unary], cand_ref[dep_is_unary],
                num_caps, dep_count, cap_code, cap_v1, cap_v2, min_support,
                "pairs_round1", dev)
            c2_dep = cand_dep[~dep_is_unary]
            c2_ref = cand_ref[~dep_is_unary]
            keep = small_to_large._prune_22_vs_12(
                c2_dep, c2_ref, d1, r1, cap_code, cap_v1, cap_v2, dev)
            d2, r2, sup2 = small_to_large._verify_level(
                backend.cooc, c2_dep[keep], c2_ref[keep], num_caps,
                dep_count, cap_code, cap_v1, cap_v2, min_support,
                "pairs_round2", dev)
    except faults.FallbackRequired as e:
        return _single_device_fallback(
            "late_bb", e, triples, preshard, min_support, projections,
            use_fis, use_ars, clean_implied, stats, mesh,
            sketch_bits=sketch_bits, sketch_hashes=sketch_hashes)
    if stats is not None:
        metrics.set_many(stats, n_round1_cinds=len(d1),
                         n_round2_cinds=len(d2))
    _publish_transport(mesh, stats, wire0)
    table = _table_of(cap_table, np.concatenate([d1, d2]),
                      np.concatenate([r1, r2]), np.concatenate([sup1, sup2]))
    return _finish_table(table, triples, preshard, min_support, use_ars,
                         clean_implied, stats, mesh)


def discover_sharded_s2l(triples, min_support: int, mesh=None,
                         projections: str = "spo", use_fis: bool = True,
                         use_ars: bool = False, clean_implied: bool = False,
                         max_retries: int = 4, stats: dict | None = None,
                         skew: SkewPolicy | None = None,
                         combine: bool = True, preshard=None, progress=None,
                         device=None) -> CindTable:
    """Sharded SmallToLarge (strategy 1, the reference's default): the join
    lines are built once and stay resident; every rank drives the
    single-device lattice logic (``small_to_large._run_lattice``) over the
    replicated capture table, each level's verification a masked pair phase
    over the mesh.  Output equals ``small_to_large.discover``."""
    from . import small_to_large

    if mesh is None:
        mesh = make_mesh(device)
    triples, use_ars = _check_preshard(triples, preshard, use_ars, use_fis)
    if triples is None and preshard is None:
        return CindTable.empty()
    if not any(ch in projections for ch in "spo"):
        return CindTable.empty()
    min_support = max(int(min_support), 1)

    wire0 = exchange.wire_bytes()
    try:
        pipe = _Pipeline(mesh, triples, min_support, projections, use_fis,
                         use_ars, max_retries, stats, skew=skew,
                         combine=combine, preshard=preshard,
                         progress=progress)
        cap_table = _frequent_captures(pipe, min_support, stats,
                                       _n_triples(mesh, triples, preshard))
        if cap_table is None:
            return CindTable.empty()
        cap_code, cap_v1, cap_v2, dep_count = cap_table
        backend = _ShardedCooc(pipe, cap_table)
        rules = (_mine_rules(triples, preshard, min_support, mesh)
                 if use_ars else None)
        if use_ars and stats is not None:
            metrics.struct_set(stats, "association_rules", rules)
        with pipe._stage("lattice"):
            table = small_to_large._run_lattice(
                backend.cooc, cap_code, cap_v1, cap_v2, dep_count,
                cap_code.shape[0], min_support, use_ars, rules,
                clean_implied, stats, mesh.device, mesh=mesh)
    except faults.FallbackRequired as e:
        return _single_device_fallback(
            "small_to_large", e, triples, preshard, min_support, projections,
            use_fis, use_ars, clean_implied, stats, mesh)
    _publish_transport(mesh, stats, wire0)
    _publish_output_digest(stats, table)
    return table


# The entry point of each strategy id on the mesh.
STRATEGIES = {0: discover_sharded, 1: discover_sharded_s2l,
              2: discover_sharded_approx, 3: discover_sharded_late_bb}


# ---------------------------------------------------------------------------
# Preshard stages: the driver's stages over rows no host held whole.
# ---------------------------------------------------------------------------


def _preshard_valid(block, n_valid, mesh):
    block = block.to(mesh.device)
    return block, torch.arange(block.shape[0], device=mesh.device) < n_valid


def _retry_exchange(what: str, cap_name: str, attempt, capacity: int,
                    num_dev: int, max_retries: int):
    """Run `attempt(capacity)` -> (result, overflow) until the mesh-summed
    overflow is 0, growing the capacity; RuntimeError when it persists."""
    for _ in range(max_retries):
        out, ovf = attempt(capacity)
        ovf = int(ovf)
        if ovf == 0:
            return out
        capacity = segments.pow2_capacity(2 * capacity + ovf)
        _check_exchange_caps(num_dev, **{cap_name: capacity})
    raise RuntimeError(f"{what} exchange overflow persisted after "
                       f"{max_retries} retries (ovf={ovf})")


def count_fcs_sharded(g_triples, g_valid, min_support: int, mesh,
                      include_binary: bool, max_retries: int = 4):
    """(n_unary, n_binary or None) distinct frequent conditions over a
    preshard (the distributed --find-only-fcs report): per field group the
    distinct keys meet at their hash owner, which counts its frequent ones."""
    block, valid = _preshard_valid(g_triples, g_valid, mesh)
    groups = [(f,) for f in range(3)]
    if include_binary:
        groups += [(0, 1), (0, 2), (1, 2)]
    ms = max(int(min_support), 1)

    def attempt(capacity):
        counts, ovf = [], 0
        for i, fields in enumerate(groups):
            n_u, o = exchange.global_distinct_frequent(
                [block[:, f] for f in fields], valid, ms, mesh, capacity,
                seed=101 + i)
            counts.append(int(n_u))
            ovf += int(o)
        return counts, ovf

    counts = _retry_exchange(
        "frequent-condition", "fcs", attempt,
        _headroom(-(-block.shape[0] // mesh.size)), mesh.size, max_retries)
    return (int(sum(counts[:3])),
            int(sum(counts[3:])) if include_binary else None)


def join_histogram_sharded(g_triples, g_valid, projections: str, mesh,
                           max_retries: int = 4):
    """(line size, number of lines of that size) pairs over a preshard (the
    distributed --create-join-histogram pass): the distinct join rows meet at
    their value's owner, where each line is one run."""
    block, valid = _preshard_valid(g_triples, g_valid, mesh)
    d = mesh.size
    cands = emit_join_candidates(block, _no_filter(valid), projections)
    u_cols, u_valid, _, _ = segments.padded_unique(
        [cands.join_val, cands.code, cands.v1, cands.v2], cands.valid)
    bucket = hashing.bucket_of([u_cols[0]], d, seed=433)

    def attempt(capacity):
        recv, recv_valid, ovf, _ = exchange.route(u_cols, u_valid, bucket,
                                                  mesh, capacity)
        return (recv, recv_valid), ovf

    recv, recv_valid = _retry_exchange(
        "join-histogram", "histogram", attempt,
        _headroom(-(-9 * block.shape[0] // d)), d, max_retries)
    r_cols, r_valid, _, _ = segments.padded_unique(recv, recv_valid)
    sizes = segments.masked_weighted_row_counts(
        [r_cols[0]], torch.ones_like(r_cols[0]), r_valid)
    is_rep = segments.run_starts([r_cols[0]]) & r_valid
    sizes_h = host_gather(mesh, torch.where(is_rep, sizes, 0))
    sizes_h = sizes_h[sizes_h > 0]
    sizes, times = np.unique(sizes_h, return_counts=True)
    return list(zip(sizes.tolist(), times.tolist()))


def mine_ars_sharded(g_triples, g_valid, min_support: int, mesh,
                     max_retries: int = 4):
    """Association rules over a preshard: the rule table of
    ``frequency.mine_association_rules`` (as a set of rows), mined from count
    exchanges and one route of the rule rows to their owner."""
    block, valid = _preshard_valid(g_triples, g_valid, mesh)
    d = mesh.size
    ms = max(int(min_support), 1)
    cap_counts = _headroom(-(-block.shape[0] // d))
    cap_rules = _headroom(CAP_FLOOR)
    for _ in range(max_retries):
        ovf_c = 0
        unary, binary = [], []
        for f in range(3):
            cnt, o = exchange.global_row_counts([block[:, f]], valid, mesh,
                                                cap_counts, seed=401 + f)
            unary.append(cnt.to(torch.int64))
            ovf_c += int(o)
        for k, (a, b) in enumerate(frequency._FIELD_PAIRS):
            cnt, o = exchange.global_row_counts(
                [block[:, a], block[:, b]], valid, mesh, cap_counts,
                seed=404 + k)
            binary.append(cnt.to(torch.int64))
            ovf_c += int(o)
        # Invalid rows count 0 < min_support: they emit no rule.
        cols = [c.to(torch.int32) for c in
                frequency.emit_rule_rows(block, ms, unary, binary)]
        ok = torch.ones(cols[0].shape[0], dtype=torch.bool,
                        device=mesh.device)
        bucket = hashing.bucket_of(cols[:4], d, seed=419)
        recv, recv_valid, o_r, _ = exchange.route(cols, ok, bucket, mesh,
                                                  cap_rules)
        o_r = int(o_r)
        if ovf_c == 0 and o_r == 0:
            break
        if ovf_c:
            cap_counts = segments.pow2_capacity(2 * cap_counts + ovf_c)
        if o_r:
            cap_rules = segments.pow2_capacity(2 * cap_rules + o_r)
        _check_exchange_caps(d, ar_counts=cap_counts, ar_rules=cap_rules)
    else:
        raise RuntimeError(
            f"association-rule exchange overflow persisted after "
            f"{max_retries} retries (ovf={ovf_c}+{o_r})")
    r_cols, r_valid, _, _ = segments.padded_unique(recv, recv_valid)
    keep = host_gather(mesh, r_valid)
    return [host_gather(mesh, c)[keep] for c in r_cols]


def dedupe_preshard(g_triples, g_valid, mesh, max_retries: int = 4):
    """Global distinct rows over a preshard (the distributed
    --distinct-triples pass): rows meet at their hash owner, which keeps one
    copy.  Returns (this rank's new block, its valid count, the total)."""
    block, valid = _preshard_valid(g_triples, g_valid, mesh)
    t_loc = block.shape[0]
    d = mesh.size
    cols = [block[:, i] for i in range(3)]
    bucket = hashing.bucket_of(cols, d, seed=31)

    def attempt(capacity):
        recv, recv_valid, ovf, _ = exchange.route(cols, valid, bucket, mesh,
                                                  capacity)
        return (recv, recv_valid), ovf

    recv, recv_valid = _retry_exchange(
        "distinct-triples", "distinct", attempt, _headroom(-(-t_loc // d)),
        d, max_retries)
    u_cols, _, _, n_u = segments.padded_unique(recv, recv_valid)
    n_u = int(n_u)
    top = int(mesh.pmax(torch.tensor(n_u)))
    if top > t_loc:
        # A skewed hash can land more than t_loc distinct rows on one
        # owner; the block slice must never truncate them.
        raise RuntimeError(
            f"distinct-triples owner block overflow (max owner rows={top} > "
            f"t_loc={t_loc}); rerun with more devices")
    out = torch.stack(u_cols[:3], dim=1)[:t_loc].contiguous()
    return out, n_u, int(mesh.psum(torch.tensor(n_u)))


def _rank_discover(mesh, strategy, triples, min_support, kwargs):
    stats: dict = {}
    table = STRATEGIES[strategy](triples, min_support, mesh=mesh,
                                 stats=stats, **kwargs)
    return table, stats


def discover_on(triples, min_support: int, world: int, *, strategy: int = 0,
                device=None, **kwargs):
    """Spawn `world` ranks on this host, run strategy `strategy` sharded on
    each (``STRATEGIES``) and return rank 0's (table, stats).  CUDA ranks
    unless `device` is "cpu": NCCL, one GPU per rank (or gloo staged through
    host memory under RDFIND_TORCH_DIST_BACKEND=gloo); "cpu" runs gloo
    ranks."""
    from ..parallel import launch
    if strategy not in STRATEGIES:
        raise ValueError(f"unknown traversal strategy {strategy}")
    return launch.spawn(_rank_discover, world, device=device,
                        args=(strategy, np.asarray(triples, np.int32),
                              min_support, kwargs))
