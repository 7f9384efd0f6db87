"""The yardstick of kernel rooflines: the card's peaks and the work each
kernel's task needs, counted from the cell's input alone.

Peaks: NVIDIA's data sheet for the H100 SXM part (dense rates, at the full
700 W power limit).  A run records the card's ``power.limit`` beside them.

K1's task (the dense CIND sweep) is, for every pair of frequent captures,
their overlap and the verdict "dep's extension lies inside ref's".  What the
input needs, whatever the schedule, tiling or block skipping:

* operations: 2 x sum over join lines (values) of n_f(line)**2, where
  n_f(line) counts the frequent captures (extension >= min_support) holding
  that value: one multiply-add per (dep, ref) increment of the overlap, the
  dependent's own size on the diagonal included;
* bytes: each membership entry (a frequent capture holding a value) read
  once as one byte, and one verdict bit per (dep, ref) pair of frequent
  captures written once.

The least time is the larger of operations / int8 peak and bytes / memory
bandwidth; the share is that over K1's measured device time.
"""

from __future__ import annotations

import numpy as np

PEAKS = {
    "NVIDIA H100": {"int8_ops_per_s": 1979e12, "bf16_flops_per_s": 989e12,
                    "hbm_bytes_per_s": 3.35e12},
}


def peaks_for(device_name: str) -> dict | None:
    """The peak table of a card by its ``torch.cuda.get_device_name()``."""
    for key, row in PEAKS.items():
        if device_name.startswith(key):
            return row
    return None


def incidence_counts(triples, min_support: int, projections: str = "spo"):
    """(n_f per value holding a frequent capture, number of frequent
    captures) of a triple table, in NumPy."""
    t = np.asarray(triples, np.int64).reshape(-1, 3)
    vals, ranks = np.unique(t, return_inverse=True)
    tr = ranks.reshape(-1, 3)
    radix = len(vals) + 1
    keys, proj = [], []
    for ch in projections:
        pi = "spo".index(ch)
        a, b = [i for i in range(3) if i != pi]
        # Capture kinds by condition field(s); the projection sets the code.
        for kind, v1, v2 in ((0, tr[:, a], 0), (1, tr[:, b], 0),
                             (2, tr[:, a], tr[:, b] + 1)):
            code = pi * 3 + kind
            keys.append((code * radix + v1 + 1) * radix + v2)
            proj.append(tr[:, pi])
    cap, cap_of = np.unique(np.concatenate(keys), return_inverse=True)
    pair = np.unique(cap_of.astype(np.int64) * radix + np.concatenate(proj))
    pcap, pval = pair // radix, pair % radix
    size = np.bincount(pcap, minlength=len(cap))
    freq = size >= min_support
    keep = freq[pcap]
    n_f = np.bincount(pval[keep], minlength=radix)
    return n_f[n_f > 0], int(freq.sum())


def k1_work(triples, min_support: int, projections: str = "spo"):
    """(operations, bytes) that K1's task needs on this input."""
    n_f, n_caps = incidence_counts(triples, min_support, projections)
    ops = 2 * int((n_f.astype(np.int64) ** 2).sum())
    nbytes = int(n_f.sum()) + (n_caps * n_caps + 7) // 8
    return ops, nbytes


def least_seconds(ops: int, nbytes: int, peaks: dict) -> float:
    return max(ops / peaks["int8_ops_per_s"],
               nbytes / peaks["hbm_bytes_per_s"])
