"""Host-side string interning: the global value dictionary.

Every string is interned exactly once into a dense int32 id, its rank in sorted
order.  One dictionary spans all three triple fields, because join lines group
captures by shared value across fields.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class Dictionary:
    """Sorted unique values; id = rank in sorted order."""

    values: np.ndarray  # sorted 1-D array of str

    def __len__(self) -> int:
        return len(self.values)

    def value(self, idx: int):
        return self.values[idx]


def intern_triples(triples) -> tuple[np.ndarray, Dictionary]:
    """Intern an iterable/array of (s, p, o) values into an (N, 3) int32 id table."""
    arr = np.asarray(triples)
    if arr.size == 0:
        return np.zeros((0, 3), np.int32), Dictionary(np.zeros(0, object))
    if arr.ndim != 2 or arr.shape[1] != 3:
        raise ValueError(f"expected (N, 3) triples, got shape {arr.shape}")
    uniques, inverse = np.unique(arr.reshape(-1), return_inverse=True)
    if len(uniques) >= np.iinfo(np.int32).max:
        raise ValueError("dictionary exceeds int32 id space")
    ids = inverse.reshape(arr.shape).astype(np.int32)
    return ids, Dictionary(uniques)
