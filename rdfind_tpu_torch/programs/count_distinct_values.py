"""CountDistinctValues: distinct URLs vs literals (programs/CountDistinctValues.scala:112-119)."""

from __future__ import annotations

import argparse
import sys

from ..io import ntriples, reader


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="count-distinct-values")
    p.add_argument("inputs", nargs="+")
    args = p.parse_args(argv)
    paths = reader.resolve_path_patterns(args.inputs)
    is_nq = paths[0].endswith((".nq", ".nq.gz"))
    urls, literals = set(), set()
    for _, line in reader.iter_lines(paths):
        t = ntriples.parse_line(line, expect_quad=is_nq)
        if t is None:
            continue
        for v in t:
            (urls if v.startswith("<") else literals).add(v)
    print(f"Distinct URLs: {len(urls)}")
    print(f"Distinct literals: {len(literals)}")
    print(f"Distinct values: {len(urls) + len(literals)}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
