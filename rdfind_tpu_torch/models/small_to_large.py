"""The host-side helpers of the SmallToLarge strategy that the approximate
strategies share: capture-id lookup, the trivially-implied pair mask and the 2/2
vs. 1/2 prune.  Numpy code, copied from the JAX package's module of the same name;
the strategy itself is not ported yet (ROADMAP.md, queue 1 item 3).
"""

from __future__ import annotations

import numpy as np

from .. import conditions as cc
from ..data import NO_VALUE


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


def _implied_mask(dep_id, ref_id, cap_code, cap_v1, cap_v2):
    """Condition.isImpliedBy per pair of capture ids, including dep == ref (and
    the equal-code quirk: a ref whose code equals the dep's is implied when the
    values match)."""
    if len(dep_id) == 0:
        return np.zeros(0, bool)
    dcode, rcode = cap_code[dep_id], cap_code[ref_id]
    same = dep_id == ref_id
    sub = np.asarray(cc.is_subcode(rcode, dcode))
    first = cc.first_subcapture(dcode) == rcode
    vmatch = np.where(first, cap_v1[ref_id] == cap_v1[dep_id],
                      cap_v1[ref_id] == cap_v2[dep_id])
    return same | (sub & vmatch)


def _prune_22_vs_12(cand_dep, cand_ref, cind12_d, cind12_r,
                    cap_code, cap_v1, cap_v2):
    """Keep 2/2 candidates NOT implied by any 1/2 CIND: implied when a 1/2 CIND
    (a, ref) exists with a a value-matching unary subcapture of the candidate dep."""
    if len(cand_dep) == 0:
        return np.zeros(0, bool)
    if len(cind12_d) == 0:
        return np.ones(len(cand_dep), bool)
    # 1/2 CINDs keyed by (ref_id, dep unary capture id).
    cind_keys = np.unique((cind12_r.astype(np.int64) << 32)
                          | cind12_d.astype(np.int64))
    keep = np.ones(len(cand_dep), bool)
    dcode = cap_code[cand_dep]
    for sub_fn, val in ((cc.first_subcapture, cap_v1[cand_dep]),
                        (cc.second_subcapture, cap_v2[cand_dep])):
        sub_code = np.asarray(sub_fn(dcode))
        sub_ids = _lookup_capture_ids(
            cap_code, cap_v1, cap_v2, sub_code, val,
            np.full(len(cand_dep), NO_VALUE, np.int64))
        present = sub_ids >= 0
        key = (cand_ref.astype(np.int64) << 32) | np.where(present, sub_ids, 0)
        keep &= ~(present & np.isin(key, cind_keys))
    return keep
