"""Sorted-run / segment algebra: group-by as sort + run detection.

Every group-by of the pipeline becomes a lexicographic sort of integer key columns,
run detection and a segment reduction.  Shapes are exact (PyTorch runs eagerly, so
there is no compiled program to reuse across sizes): a function that keeps only the
valid rows returns exactly those rows, in ascending key order.
"""

from __future__ import annotations

import torch


def _packed_keys(cols) -> list:
    """Adjacent int32 key columns packed pairwise into one int64 key (the
    major column in the high word, the minor one offset into the low word),
    which orders rows exactly as the two columns do: half the sorts for the
    same permutation."""
    out, i = [], 0
    while i < len(cols):
        a = cols[i]
        if (i + 1 < len(cols) and a.dtype == torch.int32
                and cols[i + 1].dtype == torch.int32):
            # a * 2^32 + (b + 2^31) spans exactly the int64 range.
            out.append((a.to(torch.int64) << 32)
                       + (cols[i + 1].to(torch.int64) + (1 << 31)))
            i += 2
        else:
            out.append(a)
            i += 1
    return out


def lexsort(cols) -> torch.Tensor:
    """Permutation sorting rows by the given key columns (first column = major key).

    A chain of stable sorts from the minor key to the major one, so equal keys keep
    their input order.  Returns int64 indices.
    """
    cols = _packed_keys(list(cols))
    perm = torch.argsort(cols[-1], stable=True)
    for c in reversed(cols[:-1]):
        perm = perm[torch.argsort(c[perm], stable=True)]
    return perm


def run_starts(sorted_cols) -> torch.Tensor:
    """Boolean mask marking the first row of each distinct-key run in sorted rows."""
    n = sorted_cols[0].shape[0]
    starts = torch.ones(n, dtype=torch.bool, device=sorted_cols[0].device)
    if n > 1:
        neq = torch.zeros(n - 1, dtype=torch.bool, device=starts.device)
        for c in sorted_cols:
            neq |= c[1:] != c[:-1]
        starts[1:] = neq
    return starts


def masked_unique(cols, valid):
    """Distinct valid rows in ascending key order.

    Returns (out_cols, inverse, n_unique): ``out_cols`` hold exactly the n_unique
    distinct keys; ``inverse[i]`` is the id (rank) of row i's key, and -1 for an
    invalid row.
    """
    n = cols[0].shape[0]
    idx = torch.nonzero(valid).reshape(-1)
    vcols = [c[idx] for c in cols]
    perm = lexsort(vcols)
    sorted_cols = [c[perm] for c in vcols]
    is_new = run_starts(sorted_cols)
    gid = torch.cumsum(is_new, 0) - 1
    inverse = torch.full((n,), -1, dtype=torch.int64, device=valid.device)
    inverse[idx[perm]] = gid
    out_cols = [c[is_new] for c in sorted_cols]
    return out_cols, inverse, int(is_new.sum())


def masked_row_counts(cols, valid) -> torch.Tensor:
    """For each row, how many valid rows share its key (0 for invalid rows)."""
    _, inverse, n_unique = masked_unique(cols, valid)
    counts = torch.bincount(inverse[valid], minlength=n_unique)
    out = torch.zeros(valid.shape[0], dtype=torch.int64, device=valid.device)
    out[valid] = counts[inverse[valid]]
    return out


def masked_dense_ids(col, valid):
    """Dense ids (0..n_ids-1, in ascending key order) for one key column.

    Returns (inverse, n_ids); invalid rows get -1.
    """
    _, inverse, n_ids = masked_unique([col], valid)
    return inverse, n_ids


def masked_table_index(table_cols, query_cols, query_valid) -> torch.Tensor:
    """For each query row, the index of its key in a sorted table, else -1.

    ``table_cols`` are distinct keys in ascending order (masked_unique's output).
    A sort-merge join: table rows carry tag 0 and sort before equal-key query rows
    (tag 1), so each run's first row donates its table index to the whole run.
    """
    n_t = table_cols[0].shape[0]
    q_idx = torch.nonzero(query_valid).reshape(-1)
    out = torch.full((query_valid.shape[0],), -1, dtype=torch.int64,
                     device=query_valid.device)
    if n_t == 0 or q_idx.numel() == 0:
        return out
    cols = [torch.cat([tc, qc[q_idx]]) for tc, qc in zip(table_cols, query_cols)]
    n_q = q_idx.numel()
    tag = torch.cat([torch.zeros(n_t, dtype=torch.int32, device=out.device),
                     torch.ones(n_q, dtype=torch.int32, device=out.device)])
    perm = lexsort(cols + [tag])
    starts = run_starts([c[perm] for c in cols])
    pos = torch.arange(n_t + n_q, device=out.device)
    start_pos = torch.cummax(torch.where(starts, pos, 0), 0).values
    first_orig = perm[start_pos]
    run_idx = torch.where(first_orig < n_t, first_orig, -1)
    found = torch.empty_like(run_idx)
    found[perm] = run_idx
    out[q_idx] = found[n_t:]
    return out


def compact(cols, keep):
    """Rows with keep=True, in order.  Returns (out_cols, n_kept)."""
    return [c[keep] for c in cols], int(keep.sum())


# ---------------------------------------------------------------------------
# Fixed-shape (mask-based) variants, the JAX package's conventions: invalid
# rows carry SENTINEL in every key column, outputs keep the input's length and
# the distinct / kept rows come first.  The sharded pipeline runs on these, so
# every rank's buffers have the JAX package's shapes and row order (an
# exchange's slot layout depends on both).
# ---------------------------------------------------------------------------

SENTINEL = (1 << 31) - 1


def pow2_capacity(n: int) -> int:
    """Smallest power of two >= n (>= 1)."""
    return 1 << max(0, int(n) - 1).bit_length() if n > 1 else 1


def padded_unique(cols, valid):
    """Distinct valid rows, compacted to the front in ascending key order.

    Returns (out_cols, out_valid, inverse, n_unique): rows [0, n_unique) of the
    length-n ``out_cols`` are the distinct keys, the rest SENTINEL; ``inverse``
    maps each valid row to its key's id (garbage for invalid rows); n_unique is
    a 0-d int64 tensor (no host sync).
    """
    n = cols[0].shape[0]
    dev = valid.device
    cols = [torch.where(valid, c, SENTINEL) for c in cols]
    perm = lexsort(cols)
    sorted_cols = [c[perm] for c in cols]
    v_sorted = valid[perm]
    is_new = run_starts(sorted_cols) & v_sorted
    gid = torch.cumsum(is_new, 0) - 1
    n_unique = is_new.sum()
    inverse = torch.empty(n, dtype=torch.int64, device=dev)
    inverse[perm] = gid
    target = torch.where(is_new, gid, n)  # slot n collects the dropped rows
    out_cols = []
    for c in sorted_cols:
        out = torch.full((n + 1,), SENTINEL, dtype=c.dtype, device=dev)
        out[target] = c
        out[n] = SENTINEL
        out_cols.append(out[:n])
    out_valid = torch.arange(n, device=dev) < n_unique
    return out_cols, out_valid, inverse, n_unique


def masked_weighted_row_counts(cols, weights, valid) -> torch.Tensor:
    """For each row, the sum of `weights` over the valid rows sharing its key
    (0 for invalid rows), as int32: the reduce side of a distributed count
    whose combiner pre-summed local multiplicities."""
    n = cols[0].shape[0]
    dev = valid.device
    cols = [torch.where(valid, c, SENTINEL) for c in cols]
    perm = lexsort(cols)
    sorted_cols = [c[perm] for c in cols]
    v_sorted = valid[perm]
    w_sorted = torch.where(v_sorted, weights[perm].to(torch.int64), 0)
    gid = torch.cumsum(run_starts(sorted_cols), 0) - 1
    sums = torch.zeros(n, dtype=torch.int64, device=dev).index_add_(
        0, gid, w_sorted)
    per_row = torch.where(v_sorted, sums[gid], 0)
    out = torch.empty(n, dtype=torch.int64, device=dev)
    out[perm] = per_row
    return out.to(torch.int32)


def segment_sum(values, ids, num_segments: int) -> torch.Tensor:
    """Sum of int `values` per segment id in [0, num_segments), as int32."""
    out = torch.zeros(num_segments, dtype=torch.int64, device=values.device)
    return out.index_add_(0, ids, values.to(torch.int64)).to(torch.int32)


def padded_compact(cols, keep):
    """Rows with keep=True moved to the front, order kept (the rest follow in
    their order).  Returns (out_cols, n_kept) with n_kept a 0-d tensor."""
    order = torch.argsort((~keep).to(torch.int8), stable=True)
    return [c[order] for c in cols], keep.sum()


def padded_table_index(table_cols, n_table, query_cols, query_valid):
    """For each query row, the index of its key in a padded sorted table
    (rows [0, n_table) distinct ascending), else -1.  A tag-sorted merge join:
    valid table rows tag 0 < query rows 1 < padded table rows 2."""
    n_t = table_cols[0].shape[0]
    n_q = query_cols[0].shape[0]
    dev = query_valid.device
    t_valid = torch.arange(n_t, device=dev) < n_table
    cols = [torch.cat([torch.where(t_valid, tc, SENTINEL),
                       torch.where(query_valid, qc, SENTINEL)])
            for tc, qc in zip(table_cols, query_cols)]
    tag = torch.cat([torch.where(t_valid, 0, 2).to(torch.int32),
                     torch.ones(n_q, dtype=torch.int32, device=dev)])
    perm = lexsort(cols + [tag])
    starts = run_starts([c[perm] for c in cols])
    idx = torch.arange(n_t + n_q, device=dev)
    start_pos = torch.cummax(torch.where(starts, idx, 0), 0).values
    first_orig = perm[start_pos]
    run_idx = torch.where(first_orig < n_t, first_orig, -1)
    out = torch.empty(n_t + n_q, dtype=torch.int64, device=dev)
    out[perm] = run_idx
    return torch.where(query_valid, out[n_t:], -1)
