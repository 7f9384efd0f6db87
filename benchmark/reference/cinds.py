"""The plain reference: every CIND of a triple table, from its definition.

A capture is a projected field under an equality condition on one or two of
the other fields; its extension is the set of projected values.  dep < ref
is a CIND when ext(dep) is a subset of ext(ref), |ext(dep)| >= min_support,
and dep does not imply ref (``implies``, the reference rdfind's rule with its
equal-code quirk).  The overlaps |ext(dep) & ext(ref)| are counted exactly in
int32: every value adds one to each pair of frequent captures that hold it,
in blocks of dependents on the given device.

``lattice=True`` applies the small-to-large traversal's output rule (rdfind's
strategies 1 and 3 without --clean-implied): a 2/1 CIND implied by a 1/1
CIND on the same referenced capture and a 2/2 CIND implied by a 1/2 CIND on
the same referenced capture are left out.

Plain PyTorch and NumPy.  It imports nothing of the program and takes only
the triples the benchmark made.
"""

from __future__ import annotations

import numpy as np
import torch

from . import codes

DEP_BLOCK = 4096
PAIR_BLOCK = 1 << 26
COLUMNS = ("dep_code", "dep_v1", "dep_v2", "ref_code", "ref_v1", "ref_v2",
           "support")


def incidence(triples, projections: str, device):
    """The distinct (capture, value) incidences of a triple table.

    Returns (cap_key, cap_of, val_of, vals, radix): the sorted distinct
    capture keys code * radix**2 + (v1 + 1) * radix + (v2 + 1) over value
    ranks (v2 = -1 on unary captures), each incidence's capture index and
    value rank, and the distinct values (rank -> value).
    """
    t = torch.as_tensor(np.asarray(triples, np.int64), device=device)
    vals, ranks = torch.unique(t.reshape(-1), return_inverse=True)
    tr = ranks.reshape(-1, 3)
    radix = len(vals) + 1
    keys, proj = [], []
    for ch in projections:
        pi = "spo".index(ch)
        a, b = [i for i in range(3) if i != pi]
        pbit, abit, bbit = (codes.FIELD_BITS[i] for i in (pi, a, b))
        for bits, v1, v2 in ((abit, tr[:, a], None), (bbit, tr[:, b], None),
                             (abit | bbit, tr[:, a], tr[:, b])):
            code = codes.create(bits, pbit)
            key = code * radix * radix + (v1 + 1) * radix
            keys.append(key if v2 is None else key + v2 + 1)
            proj.append(tr[:, pi])
    cap_key, cap_of = torch.unique(torch.cat(keys), return_inverse=True)
    pair = torch.unique(cap_of * radix + torch.cat(proj))
    return cap_key, pair // radix, pair % radix, vals, radix


def decode_keys(key, radix: int, vals):
    """Capture keys -> (code, v1, v2) int64 tensors of the original values."""
    code = key // (radix * radix)
    r1 = (key // radix) % radix - 1
    r2 = key % radix - 1

    def value(r):
        return torch.where(r >= 0, vals[r.clamp(min=0)], torch.full_like(r, -1))
    return code, value(r1), value(r2)


def implies(dc, d1, d2, rc, r1, r2):
    """dep implies ref: ref is dep, or a value-matching subcapture of it
    (two distinct binary captures of one code compare ref_v1 with dep_v2,
    the reference's quirk)."""
    same = (dc == rc) & (d1 == r1) & (d2 == r2)
    sub = codes.is_subcode(rc, dc)
    first = codes.first_subcapture(dc) == rc
    return same | (sub & torch.where(first, r1 == d1, r1 == d2))


def overlaps_equal_support(cap_of, val_of, size, min_support: int, device):
    """(dep, ref) index pairs of frequent captures whose overlap equals the
    dependent's extension size, dep != ref, over frequent-capture indices.

    Each value (join line) adds one to the overlap of every (dep, ref) pair
    of frequent captures holding it: the pairs are made line by line, for
    ``DEP_BLOCK`` dependents at a time and at most ``PAIR_BLOCK`` pairs at
    once, and counted exactly in int32.
    """
    freq = size >= min_support
    fid = torch.cumsum(freq.to(torch.int64), 0) - 1
    keep = freq[cap_of]
    f_of, v_of = fid[cap_of[keep]], val_of[keep]
    n_f = int(freq.sum())
    if n_f == 0:
        z = torch.zeros(0, dtype=torch.int64, device=device)
        return z, z, freq
    order = torch.argsort(v_of * n_f + f_of)
    f_of, v_of = f_of[order], v_of[order]
    _, line, count = torch.unique_consecutive(v_of, return_inverse=True,
                                              return_counts=True)
    start = torch.cumsum(count, 0) - count
    size_f = size[freq]
    deps, refs = [], []
    for d0 in range(0, n_f, DEP_BLOCK):
        d1 = min(n_f, d0 + DEP_BLOCK)
        acc = torch.zeros((d1 - d0) * n_f, dtype=torch.int32, device=device)
        entries = torch.nonzero((f_of >= d0) & (f_of < d1)).flatten()
        n_pairs = count[line[entries]]
        ends = torch.cumsum(n_pairs, 0)
        lo = 0
        while lo < len(entries):
            done = int(ends[lo - 1]) if lo else 0
            hi = max(lo + 1, int(torch.searchsorted(
                ends, done + PAIR_BLOCK, right=True)))
            e, k = entries[lo:hi], n_pairs[lo:hi]
            first = torch.repeat_interleave(start[line[e]], k)
            step = torch.arange(int(k.sum()), device=device) \
                - torch.repeat_interleave(torch.cumsum(k, 0) - k, k)
            key = torch.repeat_interleave(f_of[e] - d0, k) * n_f \
                + f_of[first + step]
            acc.index_add_(0, key, torch.ones_like(key, dtype=torch.int32))
            lo = hi
        acc = acc.view(d1 - d0, n_f)
        hit = acc == size_f[d0:d1].to(torch.int32)[:, None]
        rows = torch.arange(d0, d1, device=device)
        hit[rows - d0, rows] = False
        d, r = hit.nonzero(as_tuple=True)
        deps.append(d + d0)
        refs.append(r)
        del acc, hit
    return torch.cat(deps), torch.cat(refs), freq


def _lookup(sorted_keys, q):
    """Index of each query key in `sorted_keys`, -1 where absent."""
    pos = torch.searchsorted(sorted_keys, q).clamp(max=len(sorted_keys) - 1)
    return torch.where(sorted_keys[pos] == q, pos, torch.full_like(pos, -1))


def _lattice_keep(dep, ref, f_key, radix: int, n_f: int):
    """The small-to-large output rule over frequent-capture index pairs."""
    rr = radix * radix
    code_of = f_key // rr
    dcode, rcode = code_of[dep], code_of[ref]
    du, ru = codes.is_unary(dcode), codes.is_unary(rcode)
    dkey = f_key[dep]
    r1 = (dkey // radix) % radix  # rank + 1
    r2 = dkey % radix
    sub1 = _lookup(f_key, codes.first_subcapture(dcode) * rr + r1 * radix)
    sub2 = _lookup(f_key, codes.second_subcapture(dcode) * rr + r2 * radix)
    keep = torch.ones_like(du)
    for dep_fam, ref_unary in ((du & ru, True), (du & ~ru, False)):
        implying = dep[dep_fam] * n_f + ref[dep_fam]
        target = ~du & (ru if ref_unary else ~ru)
        hit = torch.zeros_like(du)
        for sub in (sub1, sub2):
            ok = target & (sub >= 0)
            hit[ok] |= torch.isin(sub[ok] * n_f + ref[ok], implying)
        keep &= ~hit
    return keep


def discover(triples, min_support: int, projections: str = "spo", *,
             lattice: bool = False, device="cpu") -> dict:
    """Every CIND of `triples` as sorted int64 numpy columns (``COLUMNS``).

    ``lattice`` applies the small-to-large output rule.
    """
    min_support = max(int(min_support), 1)
    device = torch.device(device)
    triples = np.asarray(triples).reshape(-1, 3)
    if triples.shape[0] == 0:
        return {c: np.zeros(0, np.int64) for c in COLUMNS}
    cap_key, cap_of, val_of, vals, radix = incidence(triples, projections,
                                                     device)
    size = torch.bincount(cap_of, minlength=len(cap_key))
    dep, ref, freq = overlaps_equal_support(cap_of, val_of, size, min_support,
                                            device)
    f_key, f_size = cap_key[freq], size[freq]
    dc, d1, d2 = decode_keys(f_key[dep], radix, vals)
    rc, r1, r2 = decode_keys(f_key[ref], radix, vals)
    keep = ~implies(dc, d1, d2, rc, r1, r2)
    if lattice:
        keep &= _lattice_keep(dep, ref, f_key, radix, len(f_key))
    cols = [c[keep].cpu().numpy().astype(np.int64)
            for c in (dc, d1, d2, rc, r1, r2, f_size[dep])]
    order = np.lexsort(cols[::-1])
    return {name: c[order] for name, c in zip(COLUMNS, cols)}


def map_ids(table: dict, ids: np.ndarray) -> dict:
    """The table of the triples with every id v replaced by ``ids[v]`` (ids
    are values; -1 marks no value)."""
    out = dict(table)
    for c in ("dep_v1", "dep_v2", "ref_v1", "ref_v2"):
        v = table[c]
        out[c] = np.where(v >= 0, np.asarray(ids, np.int64)[
            np.maximum(v, 0)], v)
    return out


def rows(table: dict) -> np.ndarray:
    """(n, 7) int64 rows of a column table, in ``COLUMNS`` order."""
    return np.stack([np.asarray(table[c], np.int64) for c in COLUMNS], 1) \
        if len(table["dep_code"]) else np.zeros((0, 7), np.int64)


def mismatched_rows(got: np.ndarray, want: np.ndarray) -> int:
    """Rows in one (n, 7) table and not the other, as multisets."""
    if got.shape == want.shape:
        g = got[np.lexsort(got.T[::-1])]
        w = want[np.lexsort(want.T[::-1])]
        if np.array_equal(g, w):
            return 0
    from collections import Counter
    a = Counter(map(tuple, got.tolist()))
    b = Counter(map(tuple, want.tolist()))
    return sum(((a - b) + (b - a)).values())


def lines(table: dict, token) -> list[str]:
    """The sorted output lines of a table (``dep < ref (support=n)``), ids
    printed by `token`."""
    def cap(code, v1, v2):
        return codes.pretty(int(code), token(v1),
                            None if v2 < 0 else token(v2))
    out = [f"{cap(a, b, c)} < {cap(d, e, f)} (support={int(s)})"
           for a, b, c, d, e, f, s in zip(*(table[k].tolist()
                                            for k in COLUMNS))]
    out.sort()
    return out
