"""Frequent-condition mining + association rules as segment counting.

A condition (field=value, or field-pair=value-pair) is *frequent* when at least
``min_support`` triples satisfy it.  Frequency is a conservative prefilter — a
capture can never be larger than its condition's triple count — so pruning on it
never changes the final CIND set.  Counts are exact group-by counts mapped straight
back onto the triple rows that asked.  The perfect-confidence test for the rule
(a=va) -> (b=vb) is count(a=va ∧ b=vb) == count(a=va), evaluable per row from the
same counts.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .. import conditions as cc
from . import segments

_FIELD_PAIRS = ((0, 1), (0, 2), (1, 2))  # (s,p), (s,o), (p,o) in ascending bit order
_FIELD_BITS = (cc.SUBJECT, cc.PREDICATE, cc.OBJECT)


@dataclasses.dataclass
class TripleFrequency:
    """Per-triple-row frequency verdicts.

    unary_ok[i, f]          -- field f's value in row i occurs >= min_support times;
    binary_ok[i, k]         -- row i's value pair for field-pair k occurs >= min_support
                               times (k indexes _FIELD_PAIRS);
    binary_ar_implied[i, k] -- the pair condition is implied by a perfect-confidence
                               association rule (either direction).
    """

    unary_ok: torch.Tensor  # (N, 3) bool
    binary_ok: torch.Tensor  # (N, 3) bool
    binary_ar_implied: torch.Tensor  # (N, 3) bool


def _condition_counts(triples, valid=None):
    """Per-row counts of each unary and each binary condition.  With a
    `valid` mask, only valid rows count and invalid rows get 0, through the
    fixed-shape segment count (no host sync)."""
    if valid is None:
        ones = torch.ones(triples.shape[0], dtype=torch.bool,
                          device=triples.device)

        def count(cols):
            return segments.masked_row_counts(cols, ones)
    else:
        def count(cols):
            return segments.masked_weighted_row_counts(cols, valid, valid)
    unary = [count([triples[:, f]]) for f in range(3)]
    binary = [count([triples[:, a], triples[:, b]]) for a, b in _FIELD_PAIRS]
    return unary, binary


def triple_frequencies(triples, min_support, find_ar_implied: bool = False,
                       valid=None) -> TripleFrequency:
    """Exact unary + binary condition frequencies, evaluated on the triples' own rows.

    `valid` (bool per row, optional) masks padding rows, which count as 0;
    then `min_support` may be a 0-d tensor and nothing syncs the host.
    """
    unary_cnt, binary_cnt = _condition_counts(triples, valid)
    unary_ok = torch.stack([c >= min_support for c in unary_cnt], dim=1)
    binary_ok = torch.stack([c >= min_support for c in binary_cnt], dim=1)
    if find_ar_implied:
        # Rule (a -> b) or (b -> a) with confidence 1 over frequent conditions:
        # emission then suppresses the redundant binary capture.
        ar = torch.stack([
            (binary_cnt[k] == unary_cnt[a]) | (binary_cnt[k] == unary_cnt[b])
            for k, (a, b) in enumerate(_FIELD_PAIRS)
        ], dim=1) & binary_ok
    else:
        ar = torch.zeros_like(binary_ok)
    return TripleFrequency(unary_ok=unary_ok, binary_ok=binary_ok,
                           binary_ar_implied=ar)


def no_filter(n: int, device, valid=None) -> TripleFrequency:
    """All-pass verdicts (the path without frequent-item-set pruning); with
    a `valid` mask, for the valid rows only."""
    if valid is None:
        ok = torch.ones((n, 3), dtype=torch.bool, device=device)
    else:
        ok = valid[:, None].expand(n, 3).clone()
    return TripleFrequency(ok, ok, torch.zeros_like(ok))


def emit_rule_rows(triples, min_support: int, unary_counts, binary_counts):
    """Distinct perfect-confidence rule rows from per-row condition counts.

    Returns five columns (ant_bit, cons_bit, ant_val, cons_val, support), one row
    per distinct directed rule, in ascending row order.
    """
    n = triples.shape[0]
    dev = triples.device
    parts = []
    for k, (a, b) in enumerate(_FIELD_PAIRS):
        cnt_ab = binary_counts[k]
        for ant, con, cnt_u in ((a, b, unary_counts[a]), (b, a, unary_counts[b])):
            is_rule = (cnt_ab == cnt_u) & (cnt_u >= min_support)
            parts.append((torch.full((n,), _FIELD_BITS[ant], dtype=torch.int64,
                                     device=dev),
                          torch.full((n,), _FIELD_BITS[con], dtype=torch.int64,
                                     device=dev),
                          triples[:, ant].long(), triples[:, con].long(),
                          cnt_ab, is_rule))
    cols = [torch.cat([p[i] for p in parts]) for i in range(5)]
    mask = torch.cat([p[5] for p in parts])
    # Support (cnt_ab) is constant within a rule group, so it rides along as a
    # fifth key column without affecting uniqueness.
    out_cols, _, _ = segments.masked_unique(cols, mask)
    return out_cols


def count_frequent_conditions(triples, min_support: int,
                              include_binary: bool):
    """Distinct frequent unary (and optionally binary) condition counts of an
    (N, 3) int32 triple tensor: the --find-only-fcs report.  Returns
    (n_unary, n_binary), n_binary None when not requested."""
    if triples.shape[0] == 0:
        return 0, (0 if include_binary else None)
    ms = max(int(min_support), 1)
    valid = torch.ones(triples.shape[0], dtype=torch.bool,
                       device=triples.device)

    def count(field_groups):
        total = 0
        for fields in field_groups:
            cols = [triples[:, f] for f in fields]
            ok = segments.masked_row_counts(cols, valid) >= ms
            total += segments.masked_unique(cols, ok)[2]
        return total

    n_unary = count(((0,), (1,), (2,)))
    return n_unary, (count(_FIELD_PAIRS) if include_binary else None)


def mine_association_rules(triples, min_support: int):
    """(N, 3) int32 triple tensor -> numpy rule table (ant_bit, cons_bit, ant_val,
    cons_val, support): every directed rule (a=va) -> (b=vb) with
    count(a=va ∧ b=vb) == count(a=va) and the antecedent frequent."""
    if triples.shape[0] == 0:
        return [np.zeros(0, np.int32)] * 5
    unary, binary = _condition_counts(triples)
    cols = emit_rule_rows(triples, max(int(min_support), 1), unary, binary)
    return [c.cpu().numpy().astype(np.int32) for c in cols]


def ar_implied_pair_mask(dep_code, ref_code, dep_v1, ref_v1, mined_rules):
    """True where a capture pair restates a mined perfect-confidence rule.

    Host-side numpy: the suppressed pairs are unary/unary with the same projection,
    whose (antecedent-field, consequent-field, antecedent-value, consequent-value)
    matches a rule.
    """
    dep_code = np.asarray(dep_code)
    ref_code = np.asarray(ref_code)
    out = np.zeros(len(dep_code), bool)
    ants, cons, avs, cvs, _ = mined_rules
    if len(ants) == 0 or len(dep_code) == 0:
        return out
    cand = np.flatnonzero(
        np.asarray(cc.is_unary(dep_code) & cc.is_unary(ref_code)
                   & (cc.secondary(dep_code) == cc.secondary(ref_code))
                   & (cc.primary(dep_code) != cc.primary(ref_code))))
    if cand.size == 0:
        return out
    dep_v1 = np.asarray(dep_v1)
    ref_v1 = np.asarray(ref_v1)
    # Membership of candidate rows in the rule table via one row-wise unique.
    rule_rows = np.stack([ants, cons, avs, cvs], axis=1).astype(np.int64)
    cand_rows = np.stack([
        np.asarray(cc.primary(dep_code[cand]), np.int64),
        np.asarray(cc.primary(ref_code[cand]), np.int64),
        dep_v1[cand].astype(np.int64), ref_v1[cand].astype(np.int64)], axis=1)
    allr = np.concatenate([rule_rows, cand_rows])
    uniq, inv = np.unique(allr, axis=0, return_inverse=True)
    inv = inv.reshape(-1)
    in_rules = np.zeros(len(uniq), bool)
    in_rules[inv[:len(rule_rows)]] = True
    out[cand] = in_rules[inv[len(rule_rows):]]
    return out
