"""Integer mixing hashes: the splitmix32 finalizer of the JAX package, bit for bit.

The JAX package computes on uint32 lanes.  torch has no ``>>`` or ``%`` for uint32
on every device, so the port holds each 32-bit value in an int64 tensor and masks
with ``& MASK32`` after every multiply and add: the low 32 bits of a wrapped
int64 product are those of the uint32 product, and every shift sees a value in
[0, 2^32).  Results are int64 tensors holding values in [0, 2^32).

``bucket_of`` routes rows to ranks in the sharded exchanges and ``digest_fold``
folds a masked row set into one integrity lane; ``host_bucket_of`` is the same
routing law on host numpy arrays (the delta engine's evidence layout and the
elastic-resume re-shard).
"""

from __future__ import annotations

import torch

MASK32 = 0xFFFFFFFF
GOLDEN = 0x9E3779B9


def as_u32(x) -> torch.Tensor:
    """int32 (or any integer) tensor -> int64 tensor of its uint32 bit patterns."""
    return x.to(torch.int64) & MASK32


def mix32(x) -> torch.Tensor:
    """splitmix32 finalizer over the uint32 values held in int64 `x`."""
    x = as_u32(x)
    x = ((x ^ (x >> 16)) * 0x85EBCA6B) & MASK32
    x = ((x ^ (x >> 13)) * 0xC2B2AE35) & MASK32
    return x ^ (x >> 16)


def hash_cols(cols, seed: int = 0) -> torch.Tensor:
    """Combine several integer columns into one well-mixed 32-bit hash."""
    h = (GOLDEN * (seed + 1)) & MASK32
    for c in cols:
        h = mix32(as_u32(c) ^ ((h + GOLDEN) & MASK32))
    return h


def host_bucket_of(cols, num_buckets: int, seed: int = 0):
    """Bucket id in [0, num_buckets) of each row of integer key columns: the
    JAX package's ``ops/hashing.host_bucket_of`` bit for bit, as an int32
    numpy array.  Held in int64 and masked to 32 bits after every multiply
    and add, as the tensor law above."""
    import numpy as np
    h = np.int64((GOLDEN * (seed + 1)) & MASK32)
    for c in cols:
        x = (np.asarray(c).astype(np.int64) & MASK32) ^ ((h + GOLDEN) & MASK32)
        x = ((x ^ (x >> 16)) * 0x85EBCA6B) & MASK32
        x = ((x ^ (x >> 13)) * 0xC2B2AE35) & MASK32
        h = x ^ (x >> 16)
    return (np.asarray(h, np.int64) % int(num_buckets)).astype(np.int32)


def bucket_of(cols, num_buckets: int, seed: int = 0) -> torch.Tensor:
    """Bucket id in [0, num_buckets) of each row of integer key columns (int32),
    the JAX package's device routing law bit for bit (``host_bucket_of`` is the
    same law on numpy arrays)."""
    return (hash_cols(cols, seed) % int(num_buckets)).to(torch.int32)


def digest_fold(cols, valid, seed: int = 0) -> torch.Tensor:
    """One order-invariant content-digest lane over a masked row set: the
    per-row ``hash_cols`` mixes, invalid rows zeroed, summed mod 2^32.

    Returned as a 0-d int64 tensor holding the uint32 sum.  A sum over
    per-rank partials, masked to 32 bits, equals the uint32 wraparound sum over
    all rows: ranks reduce these lanes as int64 and mask once."""
    h = torch.where(valid, hash_cols(cols, seed), 0)
    return h.sum() & MASK32
