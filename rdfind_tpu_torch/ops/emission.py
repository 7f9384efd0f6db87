"""Join-candidate emission: triples -> (join_value, capture) rows, fully vectorized.

Per triple and enabled projection field there are up to 3 captures sharing the
projected value as join value: two unary (condition on one other field) and one
binary (condition on both, values in ascending field-bit order).  Output rows carry
a validity mask (the frequency verdict) instead of being compacted.
"""

from __future__ import annotations

import dataclasses

import torch

from .. import conditions as cc
from ..data import NO_VALUE
from .frequency import _FIELD_PAIRS, TripleFrequency

_FIELD_BITS = (cc.SUBJECT, cc.PREDICATE, cc.OBJECT)
_PAIR_INDEX = {pair: k for k, pair in enumerate(_FIELD_PAIRS)}


@dataclasses.dataclass
class JoinCandidates:
    """Columnar join candidates with validity mask (3 rows per triple per enabled
    projection)."""

    join_val: torch.Tensor  # (C,) int32
    code: torch.Tensor  # (C,) int32 capture code
    v1: torch.Tensor  # (C,) int32
    v2: torch.Tensor  # (C,) int32 (NO_VALUE for unary captures)
    valid: torch.Tensor  # (C,) bool


def emit_join_candidates(triples, freq: TripleFrequency,
                         projections: str = "spo") -> JoinCandidates:
    """Emit all join candidates for an (N, 3) int32 triple tensor.

    Rows whose condition fails the frequency filter are emitted with valid=False.
    """
    n = triples.shape[0]
    dev = triples.device
    parts = []  # (join_val, code_scalar, v1, v2, mask)
    for proj_char, proj_bit in zip("spo", _FIELD_BITS):
        if proj_char not in projections:
            continue
        pi = cc.FIELD_INDEX[proj_bit]
        a, b = [i for i in range(3) if i != pi]
        bit_a, bit_b = _FIELD_BITS[a], _FIELD_BITS[b]
        join_val = triples[:, pi]
        ok_a, ok_b = freq.unary_ok[:, a], freq.unary_ok[:, b]
        k = _PAIR_INDEX[(a, b)]
        ok_ab = ok_a & ok_b & freq.binary_ok[:, k] & ~freq.binary_ar_implied[:, k]
        no_val = torch.full((n,), NO_VALUE, dtype=torch.int32, device=dev)
        parts.append((join_val, cc.create(bit_a, secondary_condition=proj_bit),
                      triples[:, a], no_val, ok_a))
        parts.append((join_val, cc.create(bit_b, secondary_condition=proj_bit),
                      triples[:, b], no_val, ok_b))
        parts.append((join_val, cc.create(bit_a, bit_b, proj_bit),
                      triples[:, a], triples[:, b], ok_ab))

    if not parts:
        e = torch.zeros(0, dtype=torch.int32, device=dev)
        return JoinCandidates(e, e, e, e, torch.zeros(0, dtype=torch.bool,
                                                      device=dev))
    return JoinCandidates(
        join_val=torch.cat([p[0] for p in parts]),
        code=torch.cat([torch.full((n,), p[1], dtype=torch.int32, device=dev)
                        for p in parts]),
        v1=torch.cat([p[2] for p in parts]),
        v2=torch.cat([p[3] for p in parts]),
        valid=torch.cat([p[4] for p in parts]),
    )
