"""Sorted-run / segment algebra: group-by as sort + run detection.

Every group-by of the pipeline becomes a lexicographic sort of integer key columns,
run detection and a segment reduction.  Shapes are exact (PyTorch runs eagerly, so
there is no compiled program to reuse across sizes): a function that keeps only the
valid rows returns exactly those rows, in ascending key order.
"""

from __future__ import annotations

import torch


def lexsort(cols) -> torch.Tensor:
    """Permutation sorting rows by the given key columns (first column = major key).

    A chain of stable sorts from the minor key to the major one, so equal keys keep
    their input order.  Returns int64 indices.
    """
    cols = list(cols)
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
