"""CountConditions: histogram of capture sizes per condition type.

The reference (programs/CountConditions.scala:192-214) counts, for each unary and
binary condition type, how many conditions reach each size (distinct projected
values).  Used as a ground-truth oracle for pruning thresholds.
"""

from __future__ import annotations

import argparse
import sys
from collections import Counter, defaultdict

from .. import conditions as cc
from ..io import ntriples, reader

_FIELD_BITS = (cc.SUBJECT, cc.PREDICATE, cc.OBJECT)


def condition_size_histograms(triples, projections="spo"):
    """capture code -> {size -> count of conditions with that many distinct values}."""
    ext = defaultdict(set)
    proj_bits = [b for chx, b in zip("spo", _FIELD_BITS) if chx in projections]
    for t in triples:
        for proj_bit in proj_bits:
            pi = cc.FIELD_INDEX[proj_bit]
            a, b = [i for i in range(3) if i != pi]
            bit_a, bit_b = _FIELD_BITS[a], _FIELD_BITS[b]
            ext[(cc.create(bit_a, secondary_condition=proj_bit), t[a], None)].add(t[pi])
            ext[(cc.create(bit_b, secondary_condition=proj_bit), t[b], None)].add(t[pi])
            ext[(cc.create(bit_a, bit_b, proj_bit), t[a], t[b])].add(t[pi])
    hists: dict[int, Counter] = defaultdict(Counter)
    for (code, _, _), values in ext.items():
        hists[code][len(values)] += 1
    return hists


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="count-conditions")
    p.add_argument("inputs", nargs="+")
    p.add_argument("--projection", default="spo")
    args = p.parse_args(argv)
    paths = reader.resolve_path_patterns(args.inputs)
    is_nq = paths[0].endswith((".nq", ".nq.gz"))
    triples = [t for _, line in reader.iter_lines(paths)
               if (t := ntriples.parse_line(line, expect_quad=is_nq)) is not None]
    hists = condition_size_histograms(triples, args.projection)
    for code in sorted(hists):
        total = sum(hists[code].values())
        kind = "unary" if cc.is_unary(code) else "binary"
        print(f"capture code {code} ({kind}): {total} conditions")
        for size in sorted(hists[code]):
            print(f"  size {size}: {hists[code][size]}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
