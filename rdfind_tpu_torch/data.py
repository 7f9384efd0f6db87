"""Table-oriented data model: CIND results as host numpy columns.

Strings are interned once on the host (dictionary.py); ``-1`` is the sentinel for
"no value", e.g. the second condition value of a unary capture.  Results leave the
device as numpy columns so that tables from the JAX package and from this port
compare directly.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from . import conditions as cc

NO_VALUE = -1


@dataclasses.dataclass(frozen=True)
class Cind:
    """One conditional inclusion dependency: dep ⊆ ref with |dep| = support."""

    dep_code: int
    dep_v1: object
    dep_v2: object
    ref_code: int
    ref_v1: object
    ref_v2: object
    support: int

    def pretty(self) -> str:
        """The reference's Cind.toString format."""
        dep = cc.pretty(self.dep_code, self.dep_v1, self.dep_v2)
        ref = cc.pretty(self.ref_code, self.ref_v1, self.ref_v2)
        sup = "unknown support" if self.support == -1 else f"support={self.support}"
        return f"{dep} < {ref} ({sup})"


@dataclasses.dataclass
class CindTable:
    """Columnar CIND set: 7 aligned int64 columns."""

    dep_code: np.ndarray
    dep_v1: np.ndarray
    dep_v2: np.ndarray
    ref_code: np.ndarray
    ref_v1: np.ndarray
    ref_v2: np.ndarray
    support: np.ndarray

    def __len__(self) -> int:
        return len(self.dep_code)

    @staticmethod
    def empty() -> "CindTable":
        z = np.zeros(0, np.int64)
        return CindTable(z, z, z, z, z, z, z)

    def columns(self) -> tuple:
        return (self.dep_code, self.dep_v1, self.dep_v2, self.ref_code,
                self.ref_v1, self.ref_v2, self.support)

    def select(self, keep: np.ndarray) -> "CindTable":
        """The rows where the boolean mask `keep` is set."""
        return CindTable(*(np.asarray(c)[keep] for c in self.columns()))

    def to_rows(self):
        """Set of 7-tuples, canonical for equality testing."""
        return {tuple(int(v) for v in row) for row in zip(*self.columns())}

    def decoded(self, dictionary) -> list[Cind]:
        """Resolve interned ids back to strings via `dictionary`."""

        def dec(v):
            v = int(v)
            return None if v == NO_VALUE else dictionary.value(v)

        return [
            Cind(int(dc), dec(d1), dec(d2), int(rc), dec(r1), dec(r2), int(s))
            for dc, d1, d2, rc, r1, r2, s in zip(*self.columns())
        ]
