"""Integer mixing hashes: the splitmix32 finalizer of the JAX package, bit for bit.

The JAX package computes on uint32 lanes.  torch has no ``>>`` or ``%`` for uint32
on every device, so the port holds each 32-bit value in an int64 tensor and masks
with ``& MASK32`` after every multiply and add: the low 32 bits of a wrapped
int64 product are those of the uint32 product, and every shift sees a value in
[0, 2^32).  Results are int64 tensors holding values in [0, 2^32).
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
