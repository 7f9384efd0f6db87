"""Order-invariant content digest of a CIND table.

A table's digest is two 32-bit lanes, each a wraparound (mod 2^32) sum over the
per-row splitmix32 mixes of the row's column tuple under two independent seeds.
The sum is commutative, so the digest does not depend on row order; it equals the
JAX package's ``obs/integrity.digest_table`` bit for bit, which is how a run of the
port is checked against a run of the reference.
"""

from __future__ import annotations

import numpy as np

from . import metrics

SEED_A = 29
SEED_B = 43
MASK32 = 0xFFFFFFFF


def _mix32(x):
    x = np.asarray(x).astype(np.uint32)
    x = (x ^ (x >> np.uint32(16))) * np.uint32(0x85EBCA6B)
    x = (x ^ (x >> np.uint32(13))) * np.uint32(0xC2B2AE35)
    return x ^ (x >> np.uint32(16))


def row_mixes(cols, seed: int):
    """Per-row mixes (uint32 array): the summands of a digest lane."""
    with np.errstate(over="ignore"):
        h = np.uint32(0x9E3779B9 * (seed + 1) & MASK32)
        for c in cols:
            h = _mix32(np.asarray(c).astype(np.uint32)
                       ^ (h + np.uint32(0x9E3779B9)))
        return np.asarray(h, np.uint32)


def _fold(cols, seed: int) -> int:
    h = row_mixes(cols, seed)
    if h.ndim == 0:
        return int(h)
    return int(np.sum(h.reshape(-1), dtype=np.uint32))


def digest_rows(cols) -> tuple[int, int]:
    """Order-invariant (lane_a, lane_b) digest of rows given as aligned columns."""
    return _fold(cols, SEED_A), _fold(cols, SEED_B)


def digest_table(table) -> tuple[int, int]:
    """Order-invariant digest of a CindTable (the run's output digest)."""
    return digest_rows(list(table.columns()))


def digest_hex(a: int, b: int) -> str:
    return f"{a & MASK32:08x}{b & MASK32:08x}"


def publish_output(stats: dict | None, table) -> None:
    """Record the final table's digest as the ``output`` integrity stage."""
    if stats is None:
        return
    metrics.mapping_set(stats, "integrity_stages", "output",
                        digest_hex(*digest_table(table)))
