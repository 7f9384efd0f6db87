"""Kernel K3's share of its roofline (percent): the least time the card
needs for the work the input asks of K3, counted from the cell's triples
(never from K3's launch arguments) on ``k1_roofline``'s yardstick, over K3's
measured device time per job.

K3's task is each frequent capture's support and each line's number of
frequent captures (and the block popcounts of the sweep's schedule, which
the same read gives).  What the input needs, whatever the layout: each
membership entry (a frequent capture holding a value) read once as one byte
(the sum of ``roofline.incidence_counts``'s n_f), and one 4-byte count
written per frequent capture and per line (a value that a frequent capture
holds).  There is no tensor-core work, so the least time is those bytes over
the card's HBM peak (``roofline.PEAKS``).  None where the program launches
no K3."""

import numpy as np

from benchmark import roofline

SYMBOL = "membership_counts_"


def k3_bytes(triples, min_support: int, projections: str = "spo",
             device=None) -> int:
    """Bytes K3's task needs on this input: the entries read, the counts
    written.  The counts of ``roofline.incidence_counts``, taken with torch
    on `device` (the card where there is one: NumPy's sorts took 442 s on
    LUBM(100)'s 13.6M triples on the card machine's host)."""
    import torch

    if device is None:
        device = "cuda" if torch.cuda.is_available() else "cpu"
    t = torch.as_tensor(np.asarray(triples, np.int64).reshape(-1, 3),
                        device=device)
    vals, ranks = torch.unique(t.reshape(-1), return_inverse=True)
    tr = ranks.reshape(-1, 3)
    radix = len(vals) + 1
    keys, proj = [], []
    for ch in projections:
        pi = "spo".index(ch)
        a, b = [i for i in range(3) if i != pi]
        # Capture kinds by condition field(s); the projection sets the code.
        for kind, v1, v2 in ((0, tr[:, a], 0), (1, tr[:, b], 0),
                             (2, tr[:, a], tr[:, b] + 1)):
            keys.append(((pi * 3 + kind) * radix + v1 + 1) * radix + v2)
            proj.append(tr[:, pi])
    _, cap_of = torch.unique(torch.cat(keys), return_inverse=True)
    pair = torch.unique(cap_of * radix + torch.cat(proj))
    pcap, pval = pair // radix, pair % radix
    freq = torch.bincount(pcap) >= min_support
    keep = freq[pcap]
    n_lines = int((torch.bincount(pval[keep], minlength=radix) > 0).sum())
    return int(keep.sum()) + 4 * (int(freq.sum()) + n_lines)


def read(ctx):
    s = ctx.trace.kernel_s(SYMBOL) if ctx.trace else None
    peaks = roofline.peaks_for(ctx.device_name)
    if not s or not ctx.n_jobs or peaks is None:
        return None
    nbytes = k3_bytes(ctx.triples, int(ctx.config["min_support"]),
                      ctx.config.get("projections", "spo"))
    return 100.0 * nbytes / peaks["hbm_bytes_per_s"] / (s / ctx.n_jobs)
