"""Pure-Python oracles for CIND discovery — the golden reference for every kernel.

Two independent implementations with identical outputs:

* `discover_cinds_definitional` — brute force straight from the CIND definition:
  enumerate every capture's extension set, test pairwise containment.  Slow, obviously
  correct, mechanism-free.

* `discover_cinds_joinline` — mirrors the reference's dataflow mechanics
  (join-partner emission with frequency pruning -> join lines -> per-line evidences ->
  refset intersection; rdfind-algorithm/.../operators/CreateJoinPartners.scala:86-147,
  CreateAllCindCandidates.scala:106-121, IntersectCindCandidates.scala:14-51), with
  dict-of-sets instead of Flink shuffles.

Every device pipeline is golden-tested against these on random datasets.

Triples are (s, p, o) tuples of hashable values (strings or interned ints).

The JAX package's ``oracle.py``, copied (it is pure Python): the delta engine
(``runtime/delta.py``) uses its implication rule and minimality pass.
"""

from __future__ import annotations

from collections import Counter, defaultdict

from . import conditions as cc
from .data import NO_VALUE

_FIELD_BITS = (cc.SUBJECT, cc.PREDICATE, cc.OBJECT)


def capture_extensions(triples, projections="spo"):
    """Map capture (code, v1, v2) -> set of projected values.

    Unary captures use v2 = NO_VALUE.  Only captures whose projection field is in
    `projections` exist (the reference's --projection-attributes flag,
    RDFind.scala:639-721).
    """
    ext = defaultdict(set)
    proj_bits = [b for ch, b in zip("spo", _FIELD_BITS) if ch in projections]
    for t in triples:
        for proj_bit in proj_bits:
            pi = cc.FIELD_INDEX[proj_bit]
            proj_val = t[pi]
            others = [i for i in range(3) if i != pi]
            a, b = others  # field indices in ascending bit order
            bit_a, bit_b = _FIELD_BITS[a], _FIELD_BITS[b]
            ext[(cc.create(bit_a, secondary_condition=proj_bit), t[a], NO_VALUE)].add(proj_val)
            ext[(cc.create(bit_b, secondary_condition=proj_bit), t[b], NO_VALUE)].add(proj_val)
            ext[(cc.create(bit_a, bit_b, proj_bit), t[a], t[b])].add(proj_val)
    return ext


def _implies(dep, ref):
    """dep implies ref: ref is dep itself or a value-matching subcapture of dep.

    Reference: data/Condition.scala:35-43 (isImpliedBy, with roles swapped).

    Inherited quirk, kept for output parity: for two *distinct* binary captures with
    the same code, the subcode test degenerates to ``ref_v1 == dep_v2``, so e.g.
    p[s=x,o=y] vs p[s=y,o=z] is (wrongly, per the pure definition) treated as implied
    and the pair is suppressed.  The reference behaves identically, so "identical
    output" requires mirroring it (pinned by test_implies_equal_code_quirk).
    """
    if dep == ref:
        return True
    dep_code, dep_v1, dep_v2 = dep
    ref_code, ref_v1, ref_v2 = ref
    if not cc.is_subcode(ref_code, dep_code):
        return False
    if cc.first_subcapture(dep_code) == ref_code:
        return ref_v1 == dep_v1
    return ref_v1 == dep_v2


def discover_cinds_definitional(triples, min_support, projections="spo"):
    """All CINDs (dep, ref, support) by definition.

    A CIND dep ⊆ ref holds when ext(dep) ⊆ ext(ref), |ext(dep)| >= min_support and
    dep does not trivially imply ref.  Returns a set of 7-tuples
    (dep_code, dep_v1, dep_v2, ref_code, ref_v1, ref_v2, support).
    """
    ext = capture_extensions(triples, projections)
    items = list(ext.items())
    out = set()
    for dep, dep_ext in items:
        support = len(dep_ext)
        if support < min_support:
            continue
        for ref, ref_ext in items:
            if _implies(dep, ref):
                continue
            if dep_ext <= ref_ext:
                out.add((*dep, *ref, support))
    return out


def discover_cinds_joinline(triples, min_support, projections="spo",
                            use_frequent_condition_filter=True,
                            use_association_rules=False):
    """All CINDs via the reference's join-line mechanics.

    Without association rules, output must equal `discover_cinds_definitional` — the
    frequency filters are pure pruning (a referenced capture of a valid CIND is at
    least as large as the dependent, hence frequent).  With use_association_rules
    (requires the frequency filter, as in the reference where ARs are mined from the
    frequent-item sets), AR-implied binary captures are suppressed and AR-restating
    1/1 pairs removed (CreateJoinPartners.scala:100-146,
    CreateDependencyCandidates.scala:125-130).
    """
    # -- Frequent-condition mining (FrequentConditionPlanner.scala:291-311,374-394).
    if use_frequent_condition_filter:
        unary_counts = Counter()
        binary_counts = Counter()
        for s, p, o in triples:
            t = (s, p, o)
            for i in range(3):
                unary_counts[(_FIELD_BITS[i], t[i])] += 1
            for a, b in ((0, 1), (0, 2), (1, 2)):
                binary_counts[(_FIELD_BITS[a] | _FIELD_BITS[b], t[a], t[b])] += 1
        unary_freq = {k for k, v in unary_counts.items() if v >= min_support}
        binary_freq = {k for k, v in binary_counts.items() if v >= min_support}
        rules = set()
        if use_association_rules:
            # Perfect-confidence rules over frequent conditions:
            # (a=va) -> (b=vb) iff count(a=va ∧ b=vb) == count(a=va) >= min_support.
            for (code, va, vb), cab in binary_counts.items():
                if cab < min_support:
                    continue
                bits = [b for b in _FIELD_BITS if code & b]
                for (ba, bb, x, y) in ((bits[0], bits[1], va, vb),
                                       (bits[1], bits[0], vb, va)):
                    if cab == unary_counts[(ba, x)]:
                        rules.add((ba, bb, x, y))

        def u_ok(bit, val):
            return (bit, val) in unary_freq

        def b_ok(code, va, vb):
            return (code, va, vb) in binary_freq
    else:
        rules = set()

        def u_ok(bit, val):
            return True

        def b_ok(code, va, vb):
            return True

    # -- Join-partner emission (CreateJoinPartners.scala:86-147).  The reference
    # suppresses one unary partner when the binary partner is emitted and re-splits
    # binary captures at consumption (CreateDependencyCandidates.scala:90-105); always
    # emitting both unaries + dedup yields the same join-line capture sets.
    proj_bits = [b for ch, b in zip("spo", _FIELD_BITS) if ch in projections]
    join_lines = defaultdict(set)
    for t in triples:
        for proj_bit in proj_bits:
            pi = cc.FIELD_INDEX[proj_bit]
            join_val = t[pi]
            a, b = [i for i in range(3) if i != pi]
            bit_a, bit_b = _FIELD_BITS[a], _FIELD_BITS[b]
            if u_ok(bit_a, t[a]):
                join_lines[join_val].add(
                    (cc.create(bit_a, secondary_condition=proj_bit), t[a], NO_VALUE))
            if u_ok(bit_b, t[b]):
                join_lines[join_val].add(
                    (cc.create(bit_b, secondary_condition=proj_bit), t[b], NO_VALUE))
            ar_implied = ((bit_a, bit_b, t[a], t[b]) in rules
                          or (bit_b, bit_a, t[b], t[a]) in rules)
            if (u_ok(bit_a, t[a]) and u_ok(bit_b, t[b])
                    and b_ok(bit_a | bit_b, t[a], t[b]) and not ar_implied):
                join_lines[join_val].add((cc.create(bit_a, bit_b, proj_bit), t[a], t[b]))

    # -- Evidence extraction + intersection (CreateAllCindCandidates.scala:106-121,
    # IntersectCindCandidates.scala:14-51): refset(dep) = ∩ over lines of the line's
    # capture set; depCount = number of lines containing dep.
    dep_count = Counter()
    refsets = {}
    for line in join_lines.values():
        for dep in line:
            dep_count[dep] += 1
            if dep in refsets:
                refsets[dep] &= line
            else:
                refsets[dep] = set(line)

    out = set()
    for dep, refs in refsets.items():
        support = dep_count[dep]
        if support < min_support:
            continue
        for ref in refs:
            if _implies(dep, ref):
                continue
            if rules and cc.is_unary(dep[0]) and cc.is_unary(ref[0]) \
                    and cc.secondary(dep[0]) == cc.secondary(ref[0]) \
                    and (cc.primary(dep[0]), cc.primary(ref[0]),
                         dep[1], ref[1]) in rules:
                continue
            out.add((*dep, *ref, support))
    return out


def minimize_cinds(cinds):
    """Remove implied CINDs (the reference's --clean-implied pass).

    Reference: TraversalStrategy.scala:126-168 with RemoveNonMinimalDoubleXxxCinds /
    RemoveNonMinimalXxxSingleCinds.  Note the reference's documented limitation: only
    direct implications are checked (a 2/1 implied by a 1/2 without the corresponding
    1/1 or 2/2 survives), and ALL 1/2 CINDs are kept.  Input/output: sets of 7-tuples.
    """
    def fam(c):
        dep_bin = cc.is_binary(c[0])
        ref_bin = cc.is_binary(c[3])
        return (2 if dep_bin else 1, 2 if ref_bin else 1)

    c11 = {c for c in cinds if fam(c) == (1, 1)}
    c12 = {c for c in cinds if fam(c) == (1, 2)}
    c21 = {c for c in cinds if fam(c) == (2, 1)}
    c22 = {c for c in cinds if fam(c) == (2, 2)}

    def dep_subcaptures(c):
        code, v1, v2 = c[0], c[1], c[2]
        return ((cc.first_subcapture(code), v1, NO_VALUE),
                (cc.second_subcapture(code), v2, NO_VALUE))

    def ref_subcaptures(c):
        code, v1, v2 = c[3], c[4], c[5]
        return ((cc.first_subcapture(code), v1, NO_VALUE),
                (cc.second_subcapture(code), v2, NO_VALUE))

    # 2/1 implied by 1/1: same ref, 1/1's dep is a subcapture of the 2/1's dep.
    implying = {((c[3], c[4], c[5]), (c[0], c[1], c[2])) for c in c11}
    m21 = {c for c in c21
           if not any(((c[3], c[4], c[5]), sub) in implying for sub in dep_subcaptures(c))}
    # ... and 2/1 implied by 2/2: same dep, 2/1's ref is a subcapture of the 2/2's ref.
    implying = {((c[0], c[1], c[2]), sub) for c in c22 for sub in ref_subcaptures(c)}
    m21 = {c for c in m21 if ((c[0], c[1], c[2]), (c[3], c[4], c[5])) not in implying}

    # 1/1 implied by 1/2: same dep, 1/1's ref is a subcapture of the 1/2's ref.
    implying = {((c[0], c[1], c[2]), sub) for c in c12 for sub in ref_subcaptures(c)}
    m11 = {c for c in c11 if ((c[0], c[1], c[2]), (c[3], c[4], c[5])) not in implying}

    # 2/2 implied by 1/2: same ref, 1/2's dep is a subcapture of the 2/2's dep.
    implying = {((c[3], c[4], c[5]), (c[0], c[1], c[2])) for c in c12}
    m22 = {c for c in c22
           if not any(((c[3], c[4], c[5]), sub) in implying for sub in dep_subcaptures(c))}

    return m11 | m21 | c12 | m22
