"""CountTriples: count non-comment input lines (programs/CountTriples.scala:46-66)."""

from __future__ import annotations

import argparse
import sys

from ..io import reader


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="count-triples")
    p.add_argument("inputs", nargs="+")
    args = p.parse_args(argv)
    paths = reader.resolve_path_patterns(args.inputs)
    n = sum(1 for _ in reader.iter_lines(paths, skip_comments=True))
    print(f"Counted {n} triples.")
    return 0


if __name__ == "__main__":
    sys.exit(main())
