"""CheckHashCollisions: measure hash collision rate over all values.

The reference (programs/CheckHashCollisions.scala:59-67) validated its
hash-dictionary-compression assumption by 32-bit-hashing every distinct *string*
value and counting collisions.  Same here, with a CRC32-based string hash (the TPU
build's interning is exact, so this is purely a data-statistics oracle — e.g. for
deciding whether a hash-compressed ingest path would be safe).
"""

from __future__ import annotations

import argparse
import sys
import zlib

import numpy as np

from ..dictionary import intern_triples
from ..io import ntriples, reader


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="check-hash-collisions")
    p.add_argument("inputs", nargs="+")
    args = p.parse_args(argv)
    paths = reader.resolve_path_patterns(args.inputs)
    is_nq = paths[0].endswith((".nq", ".nq.gz"))
    triples = [t for _, line in reader.iter_lines(paths)
               if (t := ntriples.parse_line(line, expect_quad=is_nq)) is not None]
    _, dictionary = intern_triples(np.asarray(triples, dtype=object))
    hashes = np.fromiter(
        (zlib.crc32(str(v).encode("utf-8")) for v in dictionary.values),
        dtype=np.uint32, count=len(dictionary))
    n = len(dictionary)
    n_distinct_hashes = len(np.unique(hashes))
    print(f"Values: {n}")
    print(f"Distinct 32-bit hashes: {n_distinct_hashes}")
    print(f"Colliding values: {n - n_distinct_hashes} "
          f"({100.0 * (n - n_distinct_hashes) / max(n, 1):.4f}%)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
