"""SmallToLarge traversal strategy (strategy 1, the CLI's default) on one device.

Walks the CIND lattice level by level — 1/1 overlaps -> 1/1 CINDs -> 1/2 -> 2/1 ->
2/2 — generating each level's candidates from the previous one and verifying only
those, instead of counting every co-occurrence pair at once (AllAtOnce).  Two
verification backends:

  dense ("matmul") — one resident co-occurrence matrix cooc = Mᵀ M (``cooc_dot``
      of the K-major Mᵀ with itself) answers every level: candidate generation
      becomes subcapture-indexed gathers of boolean relations on the device (a
      binary capture IS the merge of its two unary subcaptures), and every
      level's statistics are pulled in one batch at the end of the walk;
  chunked — per level, the join lines' co-occurrence pairs restricted to the
      level's dep and ref captures are counted chunk by chunk on the device
      (``allatonce.iter_chunk_pairs``) and merged on the host; candidate
      generation is host numpy over the level's pairs.

"auto" runs the dense backend when its capture axis is at most SINGLE_SHOT_C and
Mᵀ fits the device budget, the chunked one otherwise.  Output is the JAX
package's strategy 1: raw output keeps only minimal 2/1 CINDs and 2/2 CINDs not
implied by a 1/2 CIND; with clean_implied it equals AllAtOnce's minimal set.  With
use_association_rules the AR filter runs on the 1/1 CINDs before they seed the
higher levels, as in the reference.  ``explicit_threshold`` selects the
half-approximate 1/1 round on the chunked backend (``_half_approx_cooc_11``):
bounded exact counters per dependent, the tail in a count-min sketch, an exact
second round for the inexact dependents; the output is the same.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import conditions as cc
from .. import devices
from ..data import NO_VALUE, CindTable
from ..obs import datastats, integrity, metrics, tracer
from ..ops import cooc, frequency, minimality, sketch
from . import allatonce


def _up(a, device):
    """A host array (or tensor) as a tensor on `device`."""
    return torch.as_tensor(a).to(device)


# ---------------------------------------------------------------------------
# Chunked backend: masked pair counting per level.
# ---------------------------------------------------------------------------


def _iter_chunk_pairs(line_val_h, line_cap_h, dep_ok, ref_ok, budget, stats,
                      stat_key, device, balanced=False):
    """Yield per-chunk (dep, ref, cnt) host arrays of the flagged pairs.

    Rows flagged for neither side are dropped before the quadratic emission;
    the pair slots of the kept lines (halved when balanced) add to
    stats[stat_key] and stats["total_pairs"].
    """
    row_keep = dep_ok[line_cap_h] | ref_ok[line_cap_h]
    lv, lc = line_val_h[row_keep], line_cap_h[row_keep]
    if lv.shape[0] == 0:
        return
    _, lens = allatonce.line_runs(lv)
    n_pairs = int((lens * (lens - 1)).sum())
    if balanced:
        n_pairs //= 2
    metrics.counter_add(stats, stat_key, n_pairs)
    metrics.counter_add(stats, "total_pairs", n_pairs)
    if n_pairs == 0:
        return
    yield from allatonce.iter_chunk_pairs(
        lv, lc, budget, device, dep_f_h=dep_ok[lc], ref_f_h=ref_ok[lc],
        balanced=balanced, stats=stats)


def _sorted_unique(keys):
    """The distinct int64 keys, ascending, by one sort (numpy's np.unique hashes
    first in recent releases, several times slower at tens of millions)."""
    keys = np.sort(keys)
    first = np.empty(len(keys), bool)
    first[:1] = True
    first[1:] = keys[1:] != keys[:-1]
    return keys[first]


def _sum_by_key(keys, cnt, device):
    """(distinct keys ascending, the sum of `cnt` over each key's rows) of host
    int64 arrays, sorted and summed on `device`."""
    keys, inv = torch.unique(_up(keys, device), return_inverse=True)
    sums = torch.zeros(len(keys), dtype=torch.int64, device=device)
    sums.index_add_(0, inv, _up(cnt, device))
    return keys.cpu().numpy(), sums.cpu().numpy()


def _merge_pair_parts(parts, device):
    """Exact cross-chunk merge: summed counts per distinct (dep, ref), in
    (dep, ref) order."""
    if not parts:
        z = np.zeros(0, np.int64)
        return z, z, z
    d = np.concatenate([p[0] for p in parts])
    r = np.concatenate([p[1] for p in parts])
    c = np.concatenate([p[2] for p in parts])
    if d.size == 0:
        return d, r, c
    key, cnt = _sum_by_key((d << 32) | r, c, device)
    return key >> 32, key & 0xFFFFFFFF, cnt


def _chunked_cooc(line_val_h, line_cap_h, dep_ok, ref_ok, budget, stats,
                  stat_key, device, balanced=False):
    """Global (dep, ref) -> co-occurrence counts of the flagged capture pairs,
    as merged host arrays (dep, ref, cnt).

    balanced=True halves the 1/1 emission (each unordered pair once) and
    symmetrises the merged counts; only valid when dep_ok == ref_ok.
    """
    with tracer.profile_range("rdfind.chunks"):
        parts = list(_iter_chunk_pairs(line_val_h, line_cap_h, dep_ok, ref_ok,
                                       budget, stats, stat_key, device,
                                       balanced=balanced))
    with tracer.profile_range("rdfind.merge"):
        d, r, c = _merge_pair_parts(parts, device)
        if not balanced or d.size == 0:
            return d, r, c
        # Ownership is positional, so a capture pair can be owned in either
        # direction across lines: fold by the unordered key, emit both ways.
        lo, hi = np.minimum(d, r), np.maximum(d, r)
        uniq, cnt = _sum_by_key((lo << 32) | hi, c, device)
        ld, lr = uniq >> 32, uniq & 0xFFFFFFFF
        return (np.concatenate([ld, lr]), np.concatenate([lr, ld]),
                np.concatenate([cnt, cnt]))


# ---------------------------------------------------------------------------
# The half-approximate 1/1 round (explicit_threshold != -1).
# ---------------------------------------------------------------------------

# 0x9E3779B97F4A7C15 (2^64 / golden ratio) as a signed int64.
_GOLDEN64 = 0x9E3779B97F4A7C15 - (1 << 64)


def _sbf_cap(sbf_bits: int) -> int:
    """Saturation value of an `sbf_bits`-wide count-min counter, clamped to
    the implementation maximum."""
    return min((1 << max(1, sbf_bits)) - 1, sketch.MAX_COUNT_MIN_CAP)


def _pair_hash32(key64) -> torch.Tensor:
    """int64 pair keys -> well-mixed non-negative int32 count-min keys: bits
    32-62 of key * 0x9E3779B97F4A7C15 modulo 2^64.  The JAX package multiplies
    in uint64; a wrapped int64 multiply has the same bits, and the mask drops
    the sign bits of the arithmetic shift."""
    return (((key64 * _GOLDEN64) >> 32) & 0x7FFFFFFF).to(torch.int32)


def _half_approx_cooc_11(line_val_h, line_cap_h, dep_ok, ref_ok, budget,
                         stats, min_support, explicit_threshold, sbf_bits,
                         sbf_width, device):
    """Two-round half-approximate 1/1 overlap evaluation (the reference's
    spectral-Bloom round, SmallToLargeTraversalStrategy.scala:178-260).

    Round 1 keeps at most `explicit_threshold` exact (dep, ref) counters per
    dependent, admitted in key order within each chunk, and spills the rest
    into a count-min sketch of `sbf_width` counters saturating at
    ``_sbf_cap(sbf_bits)``, held on `device`.  Each explicit pair is then exact
    (no sketch contribution), infrequent (explicit + sketch bound below
    min_support: dropped) or unknown.  Round 2 re-counts exactly every pair of
    the dependents with a spilled or unknown pair, dropping chunk rows whose
    upper bound is below min_support before the merge.

    Returns host (dep, ref, cnt) in (dep, ref) order: exactly the pairs with
    cnt >= min_support, with exact counts, which every consumer of the 1/1
    level treats as the full exact result.  The ``ha_*`` statistics equal the
    JAX package's because the chunks have its boundaries and rows.
    """
    cap = _sbf_cap(sbf_bits)
    threshold = max(0, int(explicit_threshold))
    num_caps = len(dep_ok)
    exp_keys = np.zeros(0, np.int64)  # sorted (dep << 32) | ref
    exp_cnt = np.zeros(0, np.int64)
    exp_per_dep = np.zeros(num_caps, np.int64)
    spilled = np.zeros(num_caps, bool)
    cm_sum = torch.zeros(sbf_width, dtype=torch.int64, device=device)
    n_spilled = 0

    def match_explicit(key):
        """(hit mask, clamped positions) of `key` in the explicit store."""
        if len(exp_keys) == 0:
            return np.zeros(len(key), bool), np.zeros(len(key), np.int64)
        pos = np.minimum(np.searchsorted(exp_keys, key), len(exp_keys) - 1)
        return exp_keys[pos] == key, pos

    def chunks(dep_flags):
        return _iter_chunk_pairs(line_val_h, line_cap_h, dep_flags, ref_ok,
                                 budget, stats, "pairs_11", device)

    with tracer.profile_range("rdfind.half_approx_round1"):
        # A chunk's keys are distinct and ascending (dep-major).
        for d, r, c in chunks(dep_ok):
            key = (d << 32) | r
            hit, pos_c = match_explicit(key)
            exp_cnt[pos_c[hit]] += c[hit]  # explicit counts sum exactly
            new = ~hit
            if not new.any():
                continue
            new_d, new_key, new_c = d[new], key[new], c[new]
            first = np.empty(len(new_d), bool)
            first[0] = True
            first[1:] = new_d[1:] != new_d[:-1]
            run_start = np.flatnonzero(first)
            run_len = np.diff(np.append(run_start, len(new_d)))
            rank = np.arange(len(new_d)) - np.repeat(run_start, run_len)
            left = np.maximum(threshold - exp_per_dep[new_d[run_start]], 0)
            admit = rank < np.repeat(left, run_len)
            if admit.any():
                a_key = new_key[admit]
                at = np.searchsorted(exp_keys, a_key)
                exp_keys = np.insert(exp_keys, at, a_key)
                exp_cnt = np.insert(exp_cnt, at, new_c[admit])
                deps, n_new = np.unique(new_d[admit], return_counts=True)
                exp_per_dep[deps] += n_new
            spill = ~admit
            if spill.any():
                n_spilled += int(spill.sum())
                spilled[new_d[spill]] = True
                sketch.count_min_scatter(
                    cm_sum, _pair_hash32(_up(new_key[spill], device)),
                    _up(np.minimum(new_c[spill], cap), device),
                    num_hashes=sketch.DEFAULT_HASHES)

    if len(exp_keys) == 0 and not spilled.any():
        z = np.zeros(0, np.int64)
        return z, z, z
    cm_table = cm_sum.clamp_(max=cap).to(torch.int32)

    def cm_query(key64):
        if key64.size == 0:
            return np.zeros(0, np.int64)
        q = sketch.count_min_query(cm_table, _pair_hash32(_up(key64, device)),
                                   bits=sbf_width,
                                   num_hashes=sketch.DEFAULT_HASHES)
        return q.cpu().numpy().astype(np.int64)

    # Classify the explicit pairs (EvaluateHalfApproximateOverlapSets).
    approx = cm_query(exp_keys)
    exp_dep = exp_keys >> 32
    exact_pair = approx == 0
    frequent_exact = exact_pair & (exp_cnt >= min_support)
    infrequent = exp_cnt + approx < min_support
    unknown = ~exact_pair & ~infrequent

    # Round 2: exact re-evaluation of the inexact dependents only.
    r2 = spilled.copy()
    r2[exp_dep[unknown]] = True
    n_r2_rows = 0
    d2 = r2_ = c2 = np.zeros(0, np.int64)
    if r2.any():
        parts = []
        with tracer.profile_range("rdfind.half_approx_round2"):
            for d, r, c in chunks(r2 & dep_ok):
                key = (d << 32) | r
                # Explicit part + sketch part bound the total: below
                # min_support the pair is dropped before the merge.
                hit, pos_c = match_explicit(key)
                e_part = (np.where(hit, exp_cnt[pos_c], 0) if len(exp_cnt)
                          else np.zeros(len(key), np.int64))
                keep = e_part + cm_query(key) >= min_support
                n_r2_rows += int(keep.sum())
                if keep.any():
                    parts.append((d[keep], r[keep], c[keep]))
        with tracer.profile_range("rdfind.merge"):
            d2, r2_, c2 = _merge_pair_parts(parts, device)
        k2 = c2 >= min_support
        d2, r2_, c2 = d2[k2], r2_[k2], c2[k2]

    # Round 2 recounted every surviving pair of its dependents, so round 1
    # keeps only the exact frequent pairs of the other dependents.
    keep1 = frequent_exact & ~r2[exp_dep]
    metrics.set_many(stats, ha_spilled=n_spilled,
                     ha_round2_deps=int(r2.sum()),
                     ha_explicit_pairs=len(exp_keys),
                     ha_round2_merged_pairs=int(d2.size),
                     ha_round2_rows=n_r2_rows)
    d_out = np.concatenate([exp_dep[keep1], d2])
    r_out = np.concatenate([exp_keys[keep1] & 0xFFFFFFFF, r2_])
    c_out = np.concatenate([exp_cnt[keep1], c2])
    order = np.argsort((d_out << 32) | r_out, kind="stable")
    return d_out[order], r_out[order], c_out[order]


# ---------------------------------------------------------------------------
# Dense backend: every level is boolean algebra on the resident cooc matrix.
# ---------------------------------------------------------------------------


class _DenseCooc:
    """The dense lattice's device state: Mᵀ (dropped once no level needs it),
    the resident (c_pad, c_pad) int32 cooc = Mᵀ M, the (c_pad,) int32
    per-capture supports, and the shape scalars of the host loop."""

    def __init__(self, m_t, cooc_m, support_d, c_pad, n_lines):
        self.m_t = m_t
        self.cooc = cooc_m
        self.support_d = support_d
        self.c_pad = c_pad
        self.n_lines = n_lines


def _prepare_dense(triples, min_support, projections, use_fc_filter, use_ars,
                   stats):
    """Device prep of the dense backend.  Returns (dc, cap_code, cap_v1,
    cap_v2, dep_count, num_caps) with host int64 capture columns, () for an
    empty plan, or None when the dense plan does not apply."""
    (line_gid, cap_id, valid, n_lines, code, v1, v2,
     num_caps) = allatonce._stage_prepare(triples, min_support,
                                          projections=projections,
                                          use_fc_filter=use_fc_filter,
                                          use_ars=use_ars)
    if n_lines == 0 or num_caps == 0:
        return ()
    # Beside the strategy-0 footprint: the resident (c_pad, c_pad) int32 cooc.
    c_pad = cooc.padded_shape(n_lines, num_caps)[1]
    plan = cooc.dense_plan(n_lines, num_caps, triples.device,
                           scatter_rows=valid.shape[0],
                           extra_bytes=4 * c_pad * c_pad)
    if plan is None or plan.c_pad > cooc.SINGLE_SHOT_C:
        return None
    m_t, dep_count_d, lens, _ = allatonce._stage_membership(
        line_gid, cap_id, valid, min_support, l_pad=plan.l_pad,
        c_pad=plan.c_pad, tile=plan.tile)
    with tracer.profile_range("rdfind.cooc"):
        cooc_m = cooc.cooc_dot(m_t, m_t)
    host = [t.cpu().numpy().astype(np.int64)
            for t in (code, v1, v2, dep_count_d[:num_caps], lens[:n_lines])]
    cap_code, cap_v1, cap_v2, dep_count, lens_h = host
    metrics.set_many(
        stats, n_triples=triples.shape[0], n_lines=int((lens_h > 0).sum()),
        n_frequent_rows=int(lens_h.sum()), n_line_rows=int(dep_count.sum()),
        n_captures=num_caps, total_pairs=0, max_line=int(lens_h.max()),
        pair_backend="matmul", dense_plan=plan.describe(),
        cooc_dtype=plan.dtype)
    metrics.struct_set(stats, "kernel_resolution",
                       cooc.resolution_report(triples.device))
    if stats is not None and datastats.enabled():
        allatonce.publish_datastats(stats, lens_h, dep_count)
    # Past the product only the per-level line statistics read Mᵀ.
    dc = _DenseCooc(m_t if stats is not None else None, cooc_m, dep_count_d,
                    plan.c_pad, n_lines)
    return dc, cap_code, cap_v1, cap_v2, dep_count, num_caps


def _lat11(cooc_m, support, u_freq, ms):
    """1/1 level: K = CIND matrix, P = proper-overlap matrix (both unary and
    frequent, off the diagonal).  Returns (K, P, packed K, |P|)."""
    c = cooc_m.shape[0]
    idx = torch.arange(c, device=cooc_m.device)
    base = u_freq[:, None] & u_freq[None, :] & (idx[:, None] != idx[None, :])
    full = cooc_m == support[:, None]
    k = base & full
    p = base & (cooc_m >= ms) & ~full
    return k, p, cooc.pack_bool(k), p.sum()


def _scatter_pairs(dep_idx, ref_idx, template):
    """Rebuild a (c, c) bool relation from host pair lists (the AR-filtered K)."""
    dev = template.device
    out = torch.zeros_like(template)
    out[_up(dep_idx, dev), _up(ref_idx, dev)] = True
    return out


def _scatter_any(c, ids, flags):
    """(c,) bool with flags[i] at ids[i] (ids distinct and in range)."""
    out = torch.zeros(c, dtype=torch.bool, device=flags.device)
    out[ids] = flags
    return out


def _lat12(k, cooc_m, support, ms, bin_ids, s1, s2, sub_ok):
    """1/2 level: candidates K[d, s1[m]] & K[d, s2[m]] plus the trivial-merge
    refinement (d = a subcapture of m: (a, m) iff K[a, b]), verified as
    cooc == support.  Returns (cind12 (c x nb), its packed form, the candidate
    count, the union of the level's dep and ref captures)."""
    c = cooc_m.shape[0]
    ar_b = torch.arange(bin_ids.shape[0], device=k.device)
    cand = k[:, s1] & k[:, s2] & sub_ok[None, :]
    # (s1[b], b) and (s2[b], b) are distinct cells, so the ORs do not collide.
    cand[s1, ar_b] |= k[s1, s2] & sub_ok
    cand[s2, ar_b] |= k[s2, s1] & sub_ok
    cind = cand & (cooc_m[:, bin_ids] == support[:, None]) \
        & (support[:, None] >= ms)
    union = cand.any(dim=1) | _scatter_any(c, bin_ids, cand.any(dim=0))
    return cind, cooc.pack_bool(cind), cand.sum(), union


def _lat21(k, p, cooc_m, support, ms, bin_ids, s1, s2, sub_ok):
    """2/1 level: candidates from pairs of proper overlaps sharing the ref, and
    the inferred non-minimal 2/1s from pairs with a 1/1 CIND among them;
    verified, with the implied pairs (ref a subcapture of dep) masked.
    Returns (cind | inferred (nb x c), packed cind, |inferred|, the candidate
    count, the level's capture union)."""
    c = cooc_m.shape[0]
    o = k | p
    cand = p[s1, :] & p[s2, :] & sub_ok[:, None]
    inf = ((k[s1, :] & o[s2, :]) | (o[s1, :] & k[s2, :])) & sub_ok[:, None]
    support_b = support[bin_ids]
    idx = torch.arange(c, device=k.device)
    implied = (idx[None, :] == s1[:, None]) | (idx[None, :] == s2[:, None])
    cind = (cand & (cooc_m[bin_ids, :] == support_b[:, None])
            & (support_b[:, None] >= ms) & ~implied)
    union = _scatter_any(c, bin_ids, cand.any(dim=1)) | cand.any(dim=0)
    return cind | inf, cooc.pack_bool(cind), inf.sum(), cand.sum(), union


def _lat22(rel_all, cind12, cooc_m, support, ms, bin_ids, s1, s2, sub_ok,
           code_b, v1_b, v2_b):
    """2/2 level: candidates rel21[b, s1[m]] & rel21[b, s2[m]] plus the
    substituted-subcapture refinement, pruned against the 1/2 CINDs and the
    equal-code implied quirk, verified.  Returns (packed cind (nb x nb), the
    candidate count, the level's capture union)."""
    c = cooc_m.shape[0]
    nb = bin_ids.shape[0]
    g1 = rel_all[:, s1]
    g2 = rel_all[:, s2]
    same_code = code_b[:, None] == code_b[None, :]
    eq1 = s1[None, :] == s1[:, None]
    eq2 = s2[None, :] == s2[:, None]
    cand = (g1 & g2) | (same_code & ((eq2 & g1) | (eq1 & g2)))
    cand &= sub_ok[:, None] & sub_ok[None, :]
    cand &= ~torch.eye(nb, dtype=torch.bool, device=cand.device)
    # Equal-code implied quirk (Condition.isImpliedBy).
    cand &= ~(same_code & (v1_b[None, :] == v2_b[:, None]))
    # Implied by a 1/2 CIND on a value-matched dep subcapture.
    cand &= ~(cind12[s1, :] | cind12[s2, :])
    support_b = support[bin_ids]
    cind = cand & (cooc_m[bin_ids][:, bin_ids] == support_b[:, None]) \
        & (support_b[:, None] >= ms)
    union = _scatter_any(c, bin_ids, cand.any(dim=1) | cand.any(dim=0))
    return cooc.pack_bool(cind), cand.sum(), union


def _run_lattice_dense(dc, cap_code, cap_v1, cap_v2, dep_count, num_caps,
                       min_support, use_ars, rules, clean_implied,
                       stats) -> CindTable:
    """The lattice walk on the resident cooc matrix (dense backend)."""
    c_pad, cooc_m, support_d = dc.c_pad, dc.cooc, dc.support_d
    dev = cooc_m.device
    ms = min_support

    unary = np.asarray(cc.is_unary(cap_code))
    freq = dep_count >= min_support
    u_freq = np.zeros(c_pad, bool)
    u_freq[:num_caps] = unary & freq
    freq_pad = np.zeros(c_pad, bool)
    freq_pad[:num_caps] = freq
    freq_d = _up(freq_pad, dev)
    u_freq_d = _up(u_freq, dev)

    # Deferred stats: each level's line-union vector and candidate count stay
    # on the device and come to the host in one pull after the walk.
    pending = []  # (key, per-line union counts, candidate count or None)

    def stat_add(key, union, n_cand=None):
        if stats is not None:
            pending.append((key, cooc.union_line_counts(dc.m_t, union & freq_d),
                            n_cand))

    def flush_stats(extras=()):
        """One pull of every deferred level stat and of `extras` (0-d device
        tensors); returns the extras.  A level's pair count is written only
        when it had candidates, as the chunked backend does."""
        vals = [x for _, u, nc in pending
                for x in (u,) + (() if nc is None else (nc,))] + list(extras)
        if not vals:
            return ()
        flat = torch.cat([v.reshape(-1).to(torch.int64) for v in vals]) \
            .cpu().numpy()
        at = 0
        for key, u, nc in pending:
            lines = flat[at:at + u.numel()][:dc.n_lines]
            at += u.numel()
            n_cand = None
            if nc is not None:
                n_cand = int(flat[at])
                at += 1
            if n_cand == 0:
                continue
            n_pairs = int((lines * (lines - 1)).sum())
            metrics.gauge_set(stats, key, n_pairs)
            metrics.counter_add(stats, "total_pairs", n_pairs)
        return tuple(int(x) for x in flat[at:])

    with tracer.profile_range("rdfind.level11"):
        k, p, k_packed, n_prop = _lat11(cooc_m, support_d, u_freq_d, ms)
        stat_add("pairs_11", u_freq_d)
    cind11 = None
    if use_ars:
        # The AR filter rewrites K before the 1/2 generation, so this decode
        # cannot wait for the end of the walk.
        cind11_d, cind11_r = cooc.extract_packed(k_packed, num_caps, num_caps)
        keep = ~frequency.ar_implied_pair_mask(
            cap_code[cind11_d], cap_code[cind11_r],
            cap_v1[cind11_d], cap_v1[cind11_r], rules)
        cind11 = (cind11_d[keep], cind11_r[keep])
        k = _scatter_pairs(cind11[0], cind11[1], k)

    bin_ids_h, s1_h, s2_h = _binary_subcaptures(cap_code, cap_v1, cap_v2)
    nb = len(bin_ids_h)
    if nb == 0:
        if cind11 is None:
            cind11 = cooc.extract_packed(k_packed, num_caps, num_caps)
        (n_prop_h,) = flush_stats((n_prop,)) if stats is not None else (0,)
        cind11_d, cind11_r = cind11
        metrics.set_many(stats, n_cinds_11=len(cind11_d),
                         n_proper_overlaps=n_prop_h, n_cinds_12=0,
                         n_cinds_21=0, n_inferred_21=0, n_cinds_22=0)
        table = CindTable(
            dep_code=cap_code[cind11_d], dep_v1=cap_v1[cind11_d],
            dep_v2=cap_v2[cind11_d], ref_code=cap_code[cind11_r],
            ref_v1=cap_v1[cind11_r], ref_v2=cap_v2[cind11_r],
            support=dep_count[cind11_d])
        return minimality.minimize_table(table, dev) if clean_implied \
            else table
    bin_ids = _up(bin_ids_h, dev)
    s1, s2 = _up(np.maximum(s1_h, 0), dev), _up(np.maximum(s2_h, 0), dev)
    sub_ok = _up((s1_h >= 0) & (s2_h >= 0), dev)
    code_b, v1_b, v2_b = (_up(a[bin_ids_h], dev)
                          for a in (cap_code, cap_v1, cap_v2))

    with tracer.profile_range("rdfind.level12"):
        cind12, cind12_packed, n_cand12, u12 = _lat12(
            k, cooc_m, support_d, ms, bin_ids, s1, s2, sub_ok)
        stat_add("pairs_12", u12, n_cand12)
    with tracer.profile_range("rdfind.level21"):
        rel_all, cind21_packed, n_inf, n_cand21, u21 = _lat21(
            k, p, cooc_m, support_d, ms, bin_ids, s1, s2, sub_ok)
        stat_add("pairs_21", u21, n_cand21)
        del p
    with tracer.profile_range("rdfind.level22"):
        cind22_packed, n_cand22, u22 = _lat22(
            rel_all, cind12, cooc_m, support_d, ms, bin_ids, s1, s2, sub_ok,
            code_b, v1_b, v2_b)
        stat_add("pairs_22", u22, n_cand22)
    del rel_all, cind12
    dc.m_t = None

    with tracer.profile_range("rdfind.decode"):
        # The deferred 1/1 and the three binary relations through one batched
        # decode; an oversized 1/1 relation strip-decodes on its own.
        relations = [(cind12_packed, num_caps, nb),
                     (cind21_packed, nb, num_caps), (cind22_packed, nb, nb)]

        def bits(rel):
            return max(q.shape[0] * q.shape[1] * 32 for q, _, _ in rel)

        def thunks(rel):
            return [lambda t=t: t for t in rel]

        with_k = [(k_packed, num_caps, num_caps)] + relations
        if cind11 is None and bits(with_k) <= cooc.EXTRACT_DEVICE_ELEMS:
            cind11, *decoded = cooc.extract_packed_iter(thunks(with_k),
                                                        bits(with_k))
        else:
            if cind11 is None:
                cind11 = cooc.extract_packed(k_packed, num_caps, num_caps)
            decoded = cooc.extract_packed_iter(thunks(relations),
                                               bits(relations))
        (n_prop_h, n_inf_h) = flush_stats((n_prop, n_inf)) \
            if stats is not None else (0, 0)
    cind11_d, cind11_r = cind11
    (d12, r12b), (d21b, r21), (d22b, r22b) = decoded
    r12 = bin_ids_h[r12b]
    d21 = bin_ids_h[d21b]
    d22, r22 = bin_ids_h[d22b], bin_ids_h[r22b]
    metrics.set_many(stats, n_cinds_11=len(cind11_d),
                     n_proper_overlaps=n_prop_h, n_cinds_12=len(d12),
                     n_cinds_21=len(d21), n_inferred_21=n_inf_h,
                     n_cinds_22=len(d22))

    all_d = np.concatenate([cind11_d, d12, d21, d22])
    all_r = np.concatenate([cind11_r, r12, r21, r22])
    table = CindTable(
        dep_code=cap_code[all_d], dep_v1=cap_v1[all_d], dep_v2=cap_v2[all_d],
        ref_code=cap_code[all_r], ref_v1=cap_v1[all_r], ref_v2=cap_v2[all_r],
        support=dep_count[all_d])
    return minimality.minimize_table(table, dev) if clean_implied else table


# ---------------------------------------------------------------------------
# Host-side candidate generation (the Generate*/Infer* group-reduces) and the
# helpers the approximate strategies share.
# ---------------------------------------------------------------------------


def _mergeable(code_a, code_b):
    """Two unary captures can merge into a valid binary capture."""
    return ((cc.secondary(code_a) == cc.secondary(code_b))
            & (cc.primary(code_a) != cc.primary(code_b)))


def _binary_subcaptures(cap_code, cap_v1, cap_v2):
    """(bin_ids, s1, s2): the binary captures of the table and the ids of their
    first and second unary subcaptures (-1 where one is not in the table)."""
    bin_ids = np.flatnonzero(np.asarray(cc.is_binary(cap_code)))
    code = cap_code[bin_ids]
    none = np.full(len(bin_ids), NO_VALUE, np.int64)
    s1 = _lookup_capture_ids(cap_code, cap_v1, cap_v2,
                             np.asarray(cc.first_subcapture(code)),
                             cap_v1[bin_ids], none)
    s2 = _lookup_capture_ids(cap_code, cap_v1, cap_v2,
                             np.asarray(cc.second_subcapture(code)),
                             cap_v2[bin_ids], none)
    return bin_ids, s1, s2


def _merge_join(shared, unary, subs, device, marked=None):
    """Merge candidates of a relation {(shared[k], unary[k])} of unary captures.

    Returns the (shared, b) pairs, one per binary capture b of ``subs`` (the
    output of _binary_subcaptures) whose two unary subcaptures both pair with
    the same shared capture; with ``marked`` (bool per relation row), at least
    one of the two rows must be marked.  This is the reference's group-reduce
    (all pairs of unary captures in a group whose codes merge, the merged
    capture looked up in the table) as a join: a pair of unary captures merges
    into a capture of the table exactly when they are that capture's first
    and second subcapture, so each binary capture is expanded over the rows of
    its rarer subcapture and the other one is looked up, instead of
    enumerating every pair of each group.  The join runs on `device` (tens of
    millions of binary searches on the card at full size) and returns host
    int64 arrays.
    """
    bin_ids, s1, s2 = subs
    z = np.zeros(0, np.int64)
    ok = (s1 >= 0) & (s2 >= 0)
    if len(shared) == 0 or not ok.any():
        return z, z
    shared, unary, bin_ids, s1, s2 = (_up(a, device) for a in (
        shared, unary, bin_ids[ok], s1[ok], s2[ok]))
    key_s, order = torch.sort((shared << 32) | unary)
    u_sorted, by_u = torch.sort(unary)
    lo1, lo2 = (torch.searchsorted(u_sorted, s) for s in (s1, s2))
    n1 = torch.searchsorted(u_sorted, s1, right=True) - lo1
    n2 = torch.searchsorted(u_sorted, s2, right=True) - lo2
    first = n1 <= n2
    lo, cnt = torch.where(first, lo1, lo2), torch.where(first, n1, n2)
    other = torch.where(first, s2, s1)
    total = int(cnt.sum())
    if total == 0:
        return z, z
    rep = torch.repeat_interleave(torch.arange(len(cnt), device=device), cnt,
                                  output_size=total)
    rows = by_u[torch.repeat_interleave(lo - (torch.cumsum(cnt, 0) - cnt), cnt,
                                        output_size=total)
                + torch.arange(total, device=device)]
    x = shared[rows]
    q = (x << 32) | other[rep]
    pos = torch.clamp(torch.searchsorted(key_s, q), max=len(key_s) - 1)
    hit = key_s[pos] == q
    if marked is not None:
        marked = _up(marked, device)
        hit &= marked[rows] | marked[order[pos]]
    return x[hit].cpu().numpy(), bin_ids[rep[hit]].cpu().numpy()


def _lookup_capture_ids_structured(cap_code, cap_v1, cap_v2, q_code, q_v1, q_v2):
    """Exact fallback at any value-space size (structured unique; slow)."""
    table = np.stack([cap_code, cap_v1, cap_v2], axis=1).astype(np.int64)
    query = np.stack([q_code, q_v1, q_v2], axis=1).astype(np.int64)
    allr = np.concatenate([table, query])
    uniq, inv = np.unique(allr, axis=0, return_inverse=True)
    inv = inv.reshape(-1)
    pos = np.full(len(uniq), -1, np.int64)
    pos[inv[:len(table)]] = np.arange(len(table))
    return pos[inv[len(table):]]


def _lookup_capture_ids(cap_code, cap_v1, cap_v2, q_code, q_v1, q_v2):
    """Ids of query captures in the canonical capture table; -1 when absent.

    Rank-compresses the value space so each (code, v1, v2) row packs into one
    int64 key, then matches with a sorted-key searchsorted; past ~2^28 distinct
    values the keys would not fit and the structured lookup takes over.
    """
    if len(cap_code) == 0 or len(q_code) == 0:
        return np.full(len(q_code), -1, np.int64)
    q_v1 = np.asarray(q_v1, np.int64)
    q_v2 = np.asarray(q_v2, np.int64)
    uniq = np.unique(np.concatenate([cap_v1, cap_v2, q_v1, q_v2]))
    bits = max(1, int(uniq.size).bit_length())
    if 6 + 2 * bits > 63:
        return _lookup_capture_ids_structured(cap_code, cap_v1, cap_v2,
                                              q_code, q_v1, q_v2)

    def key(c, v1, v2):
        r1 = np.searchsorted(uniq, v1).astype(np.int64)
        r2 = np.searchsorted(uniq, v2).astype(np.int64)
        return (np.asarray(c, np.int64) << (2 * bits)) | (r1 << bits) | r2

    tk = key(cap_code, cap_v1, cap_v2)
    order = np.argsort(tk, kind="stable")
    tks = tk[order]
    qk = key(q_code, q_v1, q_v2)
    pos = np.minimum(np.searchsorted(tks, qk), len(tks) - 1)
    return np.where(tks[pos] == qk, order[pos], -1).astype(np.int64)


def _search(table, q, device):
    """Binary search of the int64 keys `q` in the sorted, non-empty int64
    `table` on `device`: (clamped positions, found) as device tensors.  At
    tens of millions of keys the host's search was the chunked walk's largest
    cost."""
    table, q = _up(table, device), _up(q, device)
    pos = torch.clamp(torch.searchsorted(table, q), max=len(table) - 1)
    return pos, table[pos] == q


def _semi_join(dep, ref, cnt, cand_dep, cand_ref, device):
    """Keep the (dep, ref, cnt) rows whose (dep, ref) is a candidate pair.

    The rows are few and distinct, the candidates many and repeated: each
    candidate is looked up among the sorted row keys, so the candidates are
    never sorted themselves."""
    if len(cand_dep) == 0 or len(dep) == 0:
        z = np.zeros(0, np.int64)
        return z, z, z
    keys = (dep << 32) | ref
    order = np.argsort(keys)
    pos, found = _search(keys[order], (cand_dep << 32) | cand_ref, device)
    keep = np.zeros(len(keys), bool)
    keep[order[torch.unique(pos[found]).cpu().numpy()]] = True
    return dep[keep], ref[keep], cnt[keep]


def _implied_mask(dep_id, ref_id, cap_code, cap_v1, cap_v2, device):
    """Condition.isImpliedBy per pair of capture ids, including dep == ref (and
    the equal-code quirk: a ref whose code equals the dep's is implied when the
    values match).  Host arrays in and out; the gathers run on `device`."""
    if len(dep_id) == 0:
        return np.zeros(0, bool)
    dep_id, ref_id, code, v1, v2 = (_up(a, device) for a in (
        dep_id, ref_id, cap_code, cap_v1, cap_v2))
    dcode, rcode = code[dep_id], code[ref_id]
    vmatch = torch.where(cc.first_subcapture(dcode) == rcode,
                         v1[ref_id] == v1[dep_id], v1[ref_id] == v2[dep_id])
    implied = (dep_id == ref_id) | (cc.is_subcode(rcode, dcode) & vmatch)
    return implied.cpu().numpy()


def _prune_22_vs_12(cand_dep, cand_ref, cind12_d, cind12_r,
                    cap_code, cap_v1, cap_v2, device, subs=None):
    """Keep the 2/x candidates (binary deps) NOT implied by a 1/2 CIND: implied
    when a 1/2 CIND (a, ref) exists with a a value-matching unary subcapture of
    the candidate dep.  ``subs`` is _binary_subcaptures' output, when the
    caller has it.  Host arrays in and out; the lookups run on `device`."""
    if len(cand_dep) == 0:
        return np.zeros(0, bool)
    if len(cind12_d) == 0:
        return np.ones(len(cand_dep), bool)
    bin_ids, s1, s2 = subs if subs is not None else \
        _binary_subcaptures(cap_code, cap_v1, cap_v2)
    # 1/2 CINDs keyed by (ref_id, dep unary capture id).
    cind_keys = _sorted_unique((cind12_r << 32) | cind12_d)
    cand_dep, cand_ref = _up(cand_dep, device), _up(cand_ref, device)
    implied = torch.zeros(len(cand_dep), dtype=torch.bool, device=device)
    sub_of = np.full(len(cap_code), -1, np.int64)
    for sub in (s1, s2):
        sub_of[bin_ids] = sub
        sub_ids = _up(sub_of, device)[cand_dep]
        present = sub_ids >= 0
        key = (cand_ref << 32) | torch.where(present, sub_ids, 0)
        implied |= present & _search(cind_keys, key, device)[1]
    return (~implied).cpu().numpy()


def _verify_level(cooc_fn, cand_dep, cand_ref, num_caps, dep_count,
                  cap_code, cap_v1, cap_v2, min_support, stat_key, device):
    """Verify candidate (dep, ref) pairs by counting: a CIND iff
    cooc(dep, ref) == |dep| (>= min_support), minus the implied pairs."""
    if len(cand_dep) == 0:
        z = np.zeros(0, np.int64)
        return z, z, z
    dep_ok = np.zeros(num_caps, bool)
    dep_ok[cand_dep] = True
    ref_ok = np.zeros(num_caps, bool)
    ref_ok[cand_ref] = True
    d, r, cnt = cooc_fn(dep_ok, ref_ok, stat_key)
    d, r, cnt = _semi_join(d, r, cnt, cand_dep, cand_ref, device)
    is_cind = (cnt == dep_count[d]) & (dep_count[d] >= min_support)
    is_cind &= ~_implied_mask(d, r, cap_code, cap_v1, cap_v2, device)
    return d[is_cind], r[is_cind], dep_count[d[is_cind]]


def _run_lattice(cooc_fn, cap_code, cap_v1, cap_v2, dep_count, num_caps,
                 min_support, use_ars, rules, clean_implied, stats, device,
                 cooc_fn_11=None, mesh=None) -> CindTable:
    """The lattice walk on the chunked backend, or on the sharded one.

    cooc_fn(dep_ok, ref_ok, stat_key) -> (dep, ref, count): merged
    co-occurrence counts of the flagged capture pairs.  cooc_fn_11, when given,
    replaces it on the 1/1 level (the balanced emission).  `mesh` (the sharded
    strategy's rank mesh) makes --clean-implied minimise over the mesh.
    """
    unary = np.asarray(cc.is_unary(cap_code))

    # --- 1/1: unary-unary overlaps.  Frequent overlaps only; the dep side is
    # frequent by the capture filter.
    with tracer.profile_range("rdfind.level11"):
        d11, r11, c11 = (cooc_fn_11 or cooc_fn)(unary, unary, "pairs_11")
    freq_ov = c11 >= min_support
    is_cind_11 = c11 == dep_count[d11]
    cind11_d, cind11_r = d11[is_cind_11], r11[is_cind_11]
    cind11_sup = c11[is_cind_11]
    if use_ars:
        keep = ~frequency.ar_implied_pair_mask(
            cap_code[cind11_d], cap_code[cind11_r],
            cap_v1[cind11_d], cap_v1[cind11_r], rules)
        cind11_d, cind11_r, cind11_sup = (cind11_d[keep], cind11_r[keep],
                                          cind11_sup[keep])
    prop = freq_ov & ~is_cind_11
    prop_d, prop_r = d11[prop], r11[prop]
    metrics.set_many(stats, n_cinds_11=len(cind11_d),
                     n_proper_overlaps=len(prop_d))

    subs = _binary_subcaptures(cap_code, cap_v1, cap_v2)

    def unique_pairs(a, b):
        key = _sorted_unique((a << 32) | b)
        return key >> 32, key & 0xFFFFFFFF

    # --- 1/2: x/2 candidates from 1/1 CINDs sharing a dep, plus the trivial
    # 1/1 merge d < r  =>  d < merge(d, r).
    with tracer.profile_range("rdfind.level12"):
        j12_dep, j12_ref = _merge_join(cind11_d, cind11_r, subs, device)
        dcode, rcode = cap_code[cind11_d], cap_code[cind11_r]
        refn = _mergeable(dcode, rcode)
        lo_is_dep = cc.primary(dcode) < cc.primary(rcode)
        ref_mv1 = np.where(lo_is_dep, cap_v1[cind11_d], cap_v1[cind11_r])
        ref_mv2 = np.where(lo_is_dep, cap_v1[cind11_r], cap_v1[cind11_d])
        r12 = _lookup_capture_ids(cap_code, cap_v1, cap_v2,
                                  (dcode | rcode)[refn], ref_mv1[refn],
                                  ref_mv2[refn])
        ok = r12 >= 0  # the merged capture exists (and is frequent)
        cind12_d, cind12_r, cind12_sup = _verify_level(
            cooc_fn, np.concatenate([j12_dep, cind11_d[refn][ok]]),
            np.concatenate([j12_ref, r12[ok]]), num_caps, dep_count,
            cap_code, cap_v1, cap_v2, min_support, "pairs_12", device)

    # --- 2/1: pairs of proper overlaps sharing the ref.
    with tracer.profile_range("rdfind.level21"):
        ref21, dep21 = _merge_join(prop_r, prop_d, subs, device)
        c21_dep, c21_ref = unique_pairs(dep21, ref21)
        cind21_d, cind21_r, cind21_sup = _verify_level(
            cooc_fn, c21_dep, c21_ref, num_caps, dep_count,
            cap_code, cap_v1, cap_v2, min_support, "pairs_21", device)
        # Inferred non-minimal 2/1s: pairs of {1/1 CINDs, proper overlaps} on
        # the same ref with at least one CIND.
        ref_inf, dep_inf = _merge_join(
            np.concatenate([cind11_r, prop_r]),
            np.concatenate([cind11_d, prop_d]), subs, device,
            marked=np.concatenate([np.ones(len(cind11_d), bool),
                                   np.zeros(len(prop_d), bool)]))
        inf21_dep, inf21_ref = unique_pairs(dep_inf, ref_inf)
    all21_dep = np.concatenate([cind21_d, inf21_dep])
    all21_ref = np.concatenate([cind21_r, inf21_ref])

    # --- 2/2: x/2 candidates from the 2/1 relation, plus the 2/1s whose ref
    # is a value-substituted subcapture of the dep.
    with tracer.profile_range("rdfind.level22"):
        j22_dep, j22_ref = _merge_join(all21_dep, all21_ref, subs, device)
        dcode, rcode = cap_code[all21_dep], cap_code[all21_ref]
        refn = np.asarray(cc.is_subcode(cc.primary(rcode), cc.primary(dcode))) \
            & (cc.secondary(rcode) == cc.secondary(dcode))
        first_is_ref = cc.first_subcapture(dcode) == rcode
        ref_mv1 = np.where(first_is_ref, cap_v1[all21_ref], cap_v1[all21_dep])
        ref_mv2 = np.where(first_is_ref, cap_v2[all21_dep], cap_v1[all21_ref])
        r22 = _lookup_capture_ids(cap_code, cap_v1, cap_v2, dcode[refn],
                                  ref_mv1[refn], ref_mv2[refn])
        ok = r22 >= 0
        c22_dep = np.concatenate([j22_dep, all21_dep[refn][ok]])
        c22_ref = np.concatenate([j22_ref, r22[ok]])
        # Self pairs and implied pairs (the equal-code quirk included): the
        # evidence extractors never emit those.
        ok = ~_implied_mask(c22_dep, c22_ref, cap_code, cap_v1, cap_v2,
                            device)
        c22_dep, c22_ref = c22_dep[ok], c22_ref[ok]
        keep = _prune_22_vs_12(c22_dep, c22_ref, cind12_d, cind12_r,
                               cap_code, cap_v1, cap_v2, device, subs)
        cind22_d, cind22_r, cind22_sup = _verify_level(
            cooc_fn, c22_dep[keep], c22_ref[keep], num_caps, dep_count,
            cap_code, cap_v1, cap_v2, min_support, "pairs_22", device)

    metrics.set_many(stats, n_cinds_12=len(cind12_d), n_cinds_21=len(cind21_d),
                     n_inferred_21=len(inf21_dep), n_cinds_22=len(cind22_d))
    all_d = np.concatenate([cind11_d, cind12_d, cind21_d, cind22_d])
    all_r = np.concatenate([cind11_r, cind12_r, cind21_r, cind22_r])
    table = CindTable(
        dep_code=cap_code[all_d], dep_v1=cap_v1[all_d], dep_v2=cap_v2[all_d],
        ref_code=cap_code[all_r], ref_v1=cap_v1[all_r], ref_v2=cap_v2[all_r],
        support=np.concatenate([cind11_sup, cind12_sup, cind21_sup,
                                cind22_sup]))
    if not clean_implied:
        return table
    if mesh is not None:
        return minimality.minimize_table_sharded(table, mesh)
    return minimality.minimize_table(table, device)


# ---------------------------------------------------------------------------
# The strategy.
# ---------------------------------------------------------------------------


def discover(triples, min_support: int, projections: str = "spo",
             use_frequent_condition_filter: bool = True,
             use_association_rules: bool = False,
             clean_implied: bool = False,
             pair_chunk_budget: int = allatonce.PAIR_CHUNK_BUDGET,
             pair_backend: str = "auto",
             explicit_threshold: int = -1,
             sbf_bits: int = -1,
             sbf_width: int = 1 << 20,
             balanced_11: bool = False,
             stats: dict | None = None,
             device=None) -> CindTable:
    """Discover CINDs level by level (SmallToLargeTraversalStrategy semantics).

    ``triples`` is an (N, 3) int32 array or tensor; it moves to ``device`` (CUDA
    unless the caller passes "cpu").  ``pair_backend`` "matmul" verifies every
    level on the resident cooc matrix and raises ValueError when it does not
    apply, "chunked" runs the per-level chunk loop, "auto" the first when it
    applies.  balanced_11 (--balanced-overlap-candidates) emits each unordered
    1/1 pair once and implies the chunked backend; the output is the same.

    ``explicit_threshold`` other than -1 selects the half-approximate 1/1 round
    (``_half_approx_cooc_11``) and implies the chunked backend: at most that
    many exact counters per dependent in round 1, the tail in a count-min
    sketch of ``sbf_width`` counters of ``sbf_bits`` bits (-1: enough bits to
    hold min_support; ValueError when the counters saturate below it), then an
    exact round 2 for the inexact dependents.  The output is the same;
    balanced_11 is then ignored, as in the JAX package.
    """
    allatonce.check_pair_backend(pair_backend)
    min_support = max(int(min_support), 1)
    if explicit_threshold != -1 or balanced_11:
        pair_backend = "chunked"
    if sbf_bits == -1:
        # The reference's default: enough bits to encode min_support.
        sbf_bits = min_support.bit_length() + 1
    if explicit_threshold != -1 and _sbf_cap(sbf_bits) < min_support:
        raise ValueError(
            f"sbf_bits={sbf_bits} saturates below min_support {min_support}")
    dev = devices.resolve(device)
    triples = allatonce.triples_on(triples, dev)
    if triples.shape[0] == 0 or not any(ch in projections for ch in "spo"):
        return CindTable.empty()
    use_ars = use_association_rules and use_frequent_condition_filter

    dense = None
    if pair_backend != "chunked":
        with tracer.profile_range("rdfind.prepare"):
            dense = _prepare_dense(triples, min_support, projections,
                                   use_frequent_condition_filter, use_ars,
                                   stats)
        if dense == ():
            return CindTable.empty()
        if dense is None and pair_backend == "matmul":
            raise ValueError("pair_backend='matmul' but the dense plan does "
                             "not fit the single-shot budget")
    rules = None
    if use_ars:
        rules = frequency.mine_association_rules(triples, min_support)
        metrics.struct_set(stats, "association_rules", rules)
    if dense is not None:
        dc, cap_code, cap_v1, cap_v2, dep_count, num_caps = dense
        table = _run_lattice_dense(dc, cap_code, cap_v1, cap_v2, dep_count,
                                   num_caps, min_support, use_ars, rules,
                                   clean_implied, stats)
        integrity.publish_output(stats, table)
        return table

    with tracer.profile_range("rdfind.prepare"):
        st = allatonce.prepare_join_lines(triples, min_support, projections,
                                          use_frequent_condition_filter,
                                          use_ars, stats)
    if st is None:
        return CindTable.empty()
    metrics.gauge_set(stats, "pair_backend", "chunked")
    line_val_h, line_cap_h = st["line_val_h"], st["line_cap_h"]

    def cooc_fn(dep_ok, ref_ok, stat_key, balanced=False):
        return _chunked_cooc(line_val_h, line_cap_h, dep_ok, ref_ok,
                             pair_chunk_budget, stats, stat_key, dev,
                             balanced=balanced)

    cooc_fn_11 = None
    if explicit_threshold != -1:
        def cooc_fn_11(dep_ok, ref_ok, stat_key):
            return _half_approx_cooc_11(
                line_val_h, line_cap_h, dep_ok, ref_ok, pair_chunk_budget,
                stats, min_support, explicit_threshold, sbf_bits, sbf_width,
                dev)
    elif balanced_11:
        def cooc_fn_11(dep_ok, ref_ok, stat_key):
            return cooc_fn(dep_ok, ref_ok, stat_key, balanced=True)

    table = _run_lattice(cooc_fn, st["cap_code"], st["cap_v1"], st["cap_v2"],
                         st["dep_count"], st["num_caps"], min_support, use_ars,
                         rules, clean_implied, stats, dev,
                         cooc_fn_11=cooc_fn_11)
    integrity.publish_output(stats, table)
    return table
