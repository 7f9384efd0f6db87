"""Bitset sketches: the fixed-width Bloom rows of the approximate strategies.

  * a join line's capture set   -> one ``bits``-wide Bloom row (the OR of its
    captures' hash bits);
  * a dependent's refset sketch -> the AND of the Bloom rows of every join line
    containing the dependent: a conservative superset of the exact refset;
  * candidate generation        -> "are all hash bits of capture r set in
    sketch[d]?" for every (d, r) at once: kernel K2 (``kernels.
    packed_contains_matrix``) on packed words;
  * the spectral filter         -> a count-min sketch (saturating counters,
    min-of-k query): plain tensor operations, as in the JAX package.

Rows are packed 32 bits per word (``bits // 32`` words), little bit order, the
uint32 patterns held in int32 tensors (``cooc.pack_bool``'s layout).  The AND of
line Blooms is computed as a count: bit b of dep c's sketch is set iff every line
containing c has bit b, i.e. iff (lines of c with bit b) == (lines of c), and the
left side for all (c, b) at once is the exact int8 product Mᵀ P of the line x
capture membership M and the line x bit Bloom planes P (``cooc.cooc_dot``).
"""

from __future__ import annotations

import torch

from . import cooc, hashing, kernels

DEFAULT_BITS = 2048
DEFAULT_HASHES = 4

# Rows per chunk of the sketch build (models/approximate.py:_build_sketches).
BUILD_ROW_BUDGET = 1 << 18
# Bytes of the membership operand and of the count matrix of one product of the
# sketch AND: dependents are taken in groups that keep both under this budget.
AND_BYTES_BUDGET = 1 << 28


def bit_positions(ids, *, bits: int, num_hashes: int) -> torch.Tensor:
    """(n, k) int32 hash-bit positions in [0, bits) for int32 ids.

    Double hashing (h1 + i h2, as in Guava's BloomFilterStrategies), computed
    modulo 2^32 as the JAX package does on uint32 lanes.  `bits` must be a power
    of two >= 32: positions are masked with ``bits - 1`` and rows are packed 32
    bits per word.
    """
    if bits < 32 or bits & (bits - 1):
        raise ValueError(f"sketch bits must be a power of two >= 32, got {bits}")
    h1 = hashing.hash_cols([ids], seed=1)
    h2 = hashing.hash_cols([ids], seed=2) | 1  # odd => full period
    i = torch.arange(num_hashes, dtype=torch.int64, device=h1.device)
    pos = h1[:, None] + i[None, :] * h2[:, None]
    return (pos & (bits - 1)).to(torch.int32)


def pack_planes(planes) -> torch.Tensor:
    """(m, bits) 0/1 planes -> (m, bits // 32) packed int32 words."""
    return cooc.pack_bool(planes)


def unpack_planes(packed) -> torch.Tensor:
    """(m, W) packed words -> (m, 32 W) 0/1 uint8 planes."""
    return cooc.unpack_bits(packed).to(torch.uint8)


def _unpack_planes_t(packed, n_pad: int) -> torch.Tensor:
    """(m, W) packed words -> (32 W, n_pad) int8 planes, transposed and
    zero-padded along m: the K-contiguous Bloom operand of the AND product."""
    m, w = packed.shape
    shifts = torch.arange(32, dtype=torch.int32, device=packed.device)
    planes = (packed.T[:, None, :] >> shifts[None, :, None]) & 1  # (W, 32, m)
    out = torch.zeros((32 * w, n_pad), dtype=torch.int8, device=packed.device)
    out[:, :m] = planes.reshape(32 * w, m)
    return out


def build_line_blooms(line_gid, cap_id, valid, *, num_lines: int, bits: int,
                      num_hashes: int) -> torch.Tensor:
    """Packed Bloom row per join line from (line, capture) membership rows.

    line_gid: line id per row (< num_lines); cap_id: capture id per row.  Rows
    with ``valid`` False are dropped before the scatter.  Returns
    (num_lines, bits // 32) int32 words.
    """
    pos = bit_positions(cap_id[valid], bits=bits, num_hashes=num_hashes)
    li = line_gid[valid].to(torch.int64)
    planes = torch.zeros(num_lines * bits, dtype=torch.uint8,
                         device=line_gid.device)
    planes[(li[:, None] * bits + pos).reshape(-1)] = 1
    return pack_planes(planes.reshape(num_lines, bits))


def intersect_dep_sketches_acc(acc, cap_id, line_gid, line_blooms,
                               valid) -> torch.Tensor:
    """AND-accumulate one chunk's per-dependent sketches into `acc`, in place.

    acc: (num_caps, W) packed sketches; rows (cap_id[i], line_gid[i]) with
    ``valid`` True say that capture cap_id[i] occurs in line line_gid[i], whose
    packed Bloom is line_blooms[line_gid[i]].  (The JAX package takes the
    gathered per-row Blooms ``line_blooms[line_gid]``; taking the lines and their
    ids lets the product run over lines, not rows.)  A dependent with no valid
    row keeps its sketch: the empty AND is all ones.  Returns `acc`.
    """
    num_caps, w = acc.shape
    bits = 32 * w
    ci = cap_id[valid].to(torch.int64)
    li = line_gid[valid].to(torch.int64)
    n_pad = cooc.round_up(line_blooms.shape[0], 8)
    planes_t = _unpack_planes_t(line_blooms, n_pad)
    # Dependents in groups whose membership (group x lines) and counts
    # (group x bits, int32) stay under the budget; _int_mm wants > 16 rows.
    group = max(32, AND_BYTES_BUDGET // max(n_pad, 4 * bits) // 8 * 8)
    for g0 in range(0, num_caps, group):
        g = min(group, num_caps - g0)
        sel = (ci >= g0) & (ci < g0 + g)
        m_t = torch.zeros((max(32, cooc.round_up(g, 8)), n_pad),
                          dtype=torch.int8, device=acc.device)
        m_t[ci[sel] - g0, li[sel]] = 1
        counts = cooc.cooc_dot(m_t, planes_t)[:g]
        n_lines = m_t[:g].sum(dim=1, dtype=torch.int32)
        acc[g0:g0 + g] &= pack_planes(counts == n_lines[:, None])
    return acc


def intersect_dep_sketches(cap_id, line_bloom_rows, valid, *, num_caps: int,
                           bits: int) -> torch.Tensor:
    """Per-dependent refset sketch: the AND of the Blooms of its rows.

    line_bloom_rows: (n_rows, W) packed Bloom of each row's line.  Returns
    (num_caps, W) int32; dependents with no valid row keep the all-ones sketch.
    """
    acc = torch.full((num_caps, bits // 32), -1, dtype=torch.int32,
                     device=cap_id.device)
    rows = torch.arange(cap_id.shape[0], device=cap_id.device)
    return intersect_dep_sketches_acc(acc, cap_id, rows, line_bloom_rows, valid)


def pack_ref_bits(ref_ids, *, bits: int, num_hashes: int):
    """Packed (R, bits // 32) int32 bit sets of each ref id's hash positions,
    plus (R,) int32 popcounts: the ref-side operand of K2."""
    pos = bit_positions(ref_ids, bits=bits, num_hashes=num_hashes)
    planes = torch.zeros((ref_ids.shape[0], bits), dtype=torch.uint8,
                         device=ref_ids.device)
    planes.scatter_(1, pos.to(torch.int64), 1)
    return pack_planes(planes), planes.sum(dim=1, dtype=torch.int32)


def contains_matrix(sketch_tile, ref_ids, ref_valid, *, bits: int,
                    num_hashes: int, ref_pack=None) -> torch.Tensor:
    """(D, R) bool: True where every hash bit of ref r is set in sketch d.

    sketch_tile: (D, W) packed dep sketches; ref_ids: (R,) capture ids;
    ref_valid: (R,) bool.  K2 runs on the packed words (on a CUDA tensor always,
    whatever `bits` is).  Both sides are zero-padded to K2's block; padded refs
    get popc -1 so that they never match.  `ref_pack` supplies a precomputed
    pack_ref_bits result, so that a loop over dep tiles packs the refs once.
    """
    d, r = sketch_tile.shape[0], ref_ids.shape[0]
    ref_packed, popc = (ref_pack if ref_pack is not None else
                        pack_ref_bits(ref_ids, bits=bits,
                                      num_hashes=num_hashes))
    dp = -d % kernels.CONTAINS_BLOCK_D
    rp = -r % kernels.CONTAINS_BLOCK_R
    if dp:
        sketch_tile = torch.nn.functional.pad(sketch_tile, (0, 0, 0, dp))
    if rp:
        ref_packed = torch.nn.functional.pad(ref_packed, (0, 0, 0, rp))
        popc = torch.nn.functional.pad(popc, (0, rp), value=-1)
    out = kernels.packed_contains_matrix(sketch_tile.contiguous(),
                                         ref_packed.contiguous(),
                                         popc.contiguous())
    return (out[:d, :r] == 1) & ref_valid[None, :]


# ---------------------------------------------------------------------------
# Spectral filter analog: count-min sketch (saturating counts, min-of-k query).
# ---------------------------------------------------------------------------

MAX_COUNT_MIN_CAP = (1 << 16) - 1


def count_min_scatter(table, keys, counts, *, num_hashes: int) -> torch.Tensor:
    """Add each key's count to its ``num_hashes`` counters of the int64
    `table` in place, with no clamp; returns `table`.

    Counts are summed exactly in int64 (no realistic input reaches 2^63), so a
    caller that clips each row's count to ``cap`` and clamps the table once at
    the end gets the JAX package's counters bit for bit: by the saturation
    lemma min(sum_i min(s_i, cap), cap) == min(sum_i s_i, cap), which is what
    its clamp after every chunk of 2^14 rows computes.
    """
    pos = bit_positions(keys, bits=table.shape[0], num_hashes=num_hashes)
    c = counts.to(torch.int64)
    table.index_add_(0, pos.reshape(-1).to(torch.int64),
                     c[:, None].expand(-1, num_hashes).reshape(-1))
    return table


def count_min_add(keys, counts, valid, *, bits: int, num_hashes: int,
                  cap: int = MAX_COUNT_MIN_CAP) -> torch.Tensor:
    """A count-min sketch row: (bits,) int32 counters saturating at `cap`.

    Each counter ends at exactly min(true_sum, cap), every row's count clipped
    to [0, cap] first and rows with ``valid`` False counting 0 (the JAX
    package's contract).  Summed in int64 and clamped once
    (``count_min_scatter``).
    """
    if not 0 < cap <= MAX_COUNT_MIN_CAP:
        raise ValueError(f"cap must be in (0, {MAX_COUNT_MIN_CAP}]")
    c = torch.where(valid, counts.to(torch.int64), 0).clamp(0, cap)
    table = torch.zeros(bits, dtype=torch.int64, device=keys.device)
    count_min_scatter(table, keys, c, num_hashes=num_hashes)
    return table.clamp_(max=cap).to(torch.int32)


def count_min_partial(keys, counts, valid, *, bits: int, num_hashes: int,
                      cap: int = MAX_COUNT_MIN_CAP, table=None) -> torch.Tensor:
    """One shard's partial count-min table, folded into `table` when given.

    Partial tables built with the same (bits, num_hashes, cap) are summable:
    the saturating fold min(table + part, cap) of partials equals one
    ``count_min_add`` over the concatenated rows (the saturation lemma above).
    """
    part = count_min_add(keys, counts, valid, bits=bits,
                         num_hashes=num_hashes, cap=cap)
    if table is None:
        return part
    return torch.minimum(table.to(torch.int32) + part,
                         torch.tensor(cap, dtype=torch.int32,
                                      device=part.device))


def count_min_query(table, keys, *, bits: int, num_hashes: int) -> torch.Tensor:
    """Upper bound on each key's count: the min over its k counters."""
    pos = bit_positions(keys, bits=bits, num_hashes=num_hashes)
    return table[pos.to(torch.int64)].min(dim=1).values


def merge_count_min(tables, cap: int = MAX_COUNT_MIN_CAP) -> torch.Tensor:
    """Sum of count-min tables, saturating: the exact int64 sum capped once."""
    acc = torch.zeros_like(torch.as_tensor(tables[0]), dtype=torch.int64)
    for t in tables:
        acc += torch.as_tensor(t).to(device=acc.device, dtype=torch.int64)
    return acc.clamp_(max=cap).to(torch.int32)


def kernel_selfcheck(n_rows: int = 1024, n_bits: int = 4096, device=None,
                     num_hashes: int = DEFAULT_HASHES,
                     repeats: int = 5) -> dict:
    """K2 against its plain version on one synthetic case (the JAX package's
    ``sketch.kernel_selfcheck`` inputs: Bloom rows of ``n_rows`` random dep
    ids against ``n_rows`` random ref ids, from numpy seed 11).

    Returns parity (kernel output equal to the plain version's), the hits and
    a content hash of the output — equal to the JAX selfcheck's ``out_hash``
    on the same arguments — and, on the card, the mean time per call of the
    kernel's wrapper and of the plain version over `repeats` back-to-back
    calls (CUDA events, host enqueue included) with their ratio.  On the CPU
    the wrapper runs the plain version, so parity holds trivially and nothing
    is timed.
    """
    import hashlib

    import numpy as np

    from .. import devices

    dev = devices.resolve(device)
    rng = np.random.default_rng(11)
    dep_ids = torch.as_tensor(rng.integers(0, 1 << 30, n_rows,
                                           dtype=np.int32)).to(dev)
    ref_ids = torch.as_tensor(rng.integers(0, 1 << 30, n_rows,
                                           dtype=np.int32)).to(dev)
    every = torch.ones(n_rows, dtype=torch.bool, device=dev)
    sketches = build_line_blooms(torch.arange(n_rows, device=dev), dep_ids,
                                 every, num_lines=n_rows, bits=n_bits,
                                 num_hashes=num_hashes)
    ref_packed, popc = pack_ref_bits(ref_ids, bits=n_bits,
                                     num_hashes=num_hashes)
    dp = -n_rows % kernels.CONTAINS_BLOCK_D
    rp = -n_rows % kernels.CONTAINS_BLOCK_R
    args = (torch.nn.functional.pad(sketches, (0, 0, 0, dp)).contiguous(),
            torch.nn.functional.pad(ref_packed, (0, 0, 0, rp)).contiguous(),
            torch.nn.functional.pad(popc, (0, rp), value=-1).contiguous())
    got = kernels.packed_contains_matrix(*args)[:n_rows, :n_rows]
    want = kernels.packed_contains_matrix_plain(*args)[:n_rows, :n_rows]
    out = got.cpu().numpy().astype(np.uint8)
    result = {"parity": bool(torch.equal(got, want)), "n_rows": n_rows,
              "bits": n_bits, "backend": dev.type, "hits": int(out.sum()),
              "out_hash": hashlib.sha1(out.tobytes()).hexdigest()[:16]}
    if dev.type == "cuda":
        for key, fn in (("kernel_ms", kernels.packed_contains_matrix),
                        ("plain_ms", kernels.packed_contains_matrix_plain)):
            fn(*args)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            torch.cuda.synchronize(dev)
            start.record()
            for _ in range(repeats):
                fn(*args)
            end.record()
            torch.cuda.synchronize(dev)
            result[key] = start.elapsed_time(end) / repeats
        result["speedup"] = result["plain_ms"] / result["kernel_ms"]
    return result
