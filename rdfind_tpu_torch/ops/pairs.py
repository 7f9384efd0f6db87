"""CIND-evidence pair generation: every ordered co-occurrence pair, as rotations.

For captures d, r:  CIND d ⊆ r  <=>  cooc(d, r) == |lines containing d|  (and
support >= min_support), so the evidence phase becomes emitting all ordered
co-occurrence pairs of the join lines and counting them.

Pair enumeration is rotation-based: for a line of length L laid out contiguously,
rotation j (1 <= j < L) pairs each element with the one j slots ahead (mod L).  The
whole enumeration is one flat searchsorted + gather whose output size the caller
gives, however skewed the line sizes are.  Total work is sum_l L_l (L_l - 1), the
evidence count itself.

The prefix sums run in int64 and saturate at SAT, the JAX package's bound, so the
counts this module reports equal the JAX package's at any size.
"""

from __future__ import annotations

import torch

from . import segments

# Saturation bound of the pair-count prefix sums (the JAX package's): far above
# any real chunk capacity, and small enough that no int32 consumer can wrap.
SAT = 1 << 30


def saturating_cumsum(x) -> torch.Tensor:
    """Inclusive int64 prefix sum of a non-negative integer tensor, clamped at SAT.

    For non-negative inputs min(cumsum, SAT) equals the JAX package's saturating
    associative scan: the plain prefix sum is monotone, so once it reaches SAT
    the saturating one stays pinned there too."""
    x = torch.clamp(x.to(torch.int64), max=SAT)
    return torch.clamp(torch.cumsum(x, 0), max=SAT)


def line_layout(line_val):
    """Run layout of rows sorted by join value (every row valid).

    Returns (pos, length, start_idx, total_pairs): each row's position within
    its line, its line's length, the index of its line's first row (int64
    tensors), and the saturated sum of length * (length - 1) over lines as a
    0-d tensor.
    """
    n = line_val.shape[0]
    if n == 0:
        z = torch.zeros(0, dtype=torch.int64, device=line_val.device)
        return z, z, z, torch.zeros((), dtype=torch.int64,
                                    device=line_val.device)
    starts = segments.run_starts([line_val])
    idx = torch.arange(n, device=line_val.device)
    start_idx = torch.cummax(torch.where(starts, idx, 0), 0).values
    gid = torch.cumsum(starts, 0) - 1
    length = torch.bincount(gid)[gid]
    pos = idx - start_idx
    total = saturating_cumsum(length - 1)[-1]
    return pos, length, start_idx, total


def emit_pair_indices(pos, length, start_idx, capacity: int,
                      balanced: bool = False, emit=None):
    """Row / partner indices of the ordered co-occurrence pairs, `capacity` slots.

    Returns (row, partner, pair_valid): gather payload columns at `row`
    (dependent) and `partner` (referenced).  Slots past the true total repeat
    clamped rows and are masked by pair_valid; a total above `capacity` is
    truncated, so callers size the capacity from the line layout.

    `emit` (optional bool per row) suppresses emission for rows where it is
    False: they take no output slot, but stay partners of emitting rows.

    balanced=True emits each *unordered* pair once: rotations j <= (L-1)//2 per
    row, plus, for even L, the antipodal rotation L/2 for the first half of the
    positions.  Every element owns about half its partners; the total is
    L (L-1) / 2 per line, and callers symmetrise the merged counts.
    """
    n = pos.shape[0]
    dev = pos.device
    if balanced:
        reps = (length - 1) // 2 + ((length % 2 == 0)
                                    & (pos < length // 2)).to(length.dtype)
    else:
        reps = length - 1
    if emit is not None:
        reps = torch.where(emit, reps, 0)
    cum = saturating_cumsum(reps)
    out_idx = torch.arange(capacity, dtype=torch.int64, device=dev)
    if n == 0:
        z = torch.zeros(capacity, dtype=torch.int64, device=dev)
        return z, z, torch.zeros(capacity, dtype=torch.bool, device=dev)
    pair_valid = out_idx < cum[-1]
    # The row owning slot k: the first row whose inclusive prefix sum exceeds k.
    row = torch.clamp(torch.searchsorted(cum, out_idx, right=True), 0, n - 1)
    j = out_idx - (cum[row] - reps[row]) + 1
    partner = start_idx[row] + (pos[row] + j) % length[row]
    return row, torch.clamp(partner, 0, n - 1), pair_valid
