"""ops/pairs.py of the port and the chunk stage built on it, against the JAX
package's, on the CPU.  Same numpy inputs into both; every index, count and
boundary must be equal."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rdfind_tpu.models import allatonce as jallatonce
from rdfind_tpu.models import small_to_large as js2l
from rdfind_tpu.ops import pairs as jpairs
from rdfind_tpu_torch.models import allatonce as tallatonce
from rdfind_tpu_torch.ops import pairs as tpairs

N_ROWS = 96  # one padded size for every case, so XLA compiles few programs
CAPACITY = 2048


@pytest.fixture(autouse=True, scope="module")
def _release_jax_programs():
    """Drop the XLA programs compiled in and before this module: each keeps
    executable memory mappings, and a test process that gathers too many hits
    the kernel's per-process map limit (vm.max_map_count) inside XLA."""
    jax.clear_caches()
    yield
    jax.clear_caches()


def _lines(seed, n, max_len):
    """Sorted join values of n rows in lines of 1..max_len rows, and capture ids
    (distinct within a line, ascending)."""
    rng = np.random.default_rng(seed)
    lens = []
    while sum(lens) < n:
        lens.append(int(rng.integers(1, max_len + 1)))
    lens[-1] -= sum(lens) - n
    val = np.repeat(np.arange(len(lens)) * 3 + 5, lens).astype(np.int32)
    cap = np.concatenate([np.sort(rng.choice(40, k, replace=False))
                          for k in lens]).astype(np.int32)
    return val, cap


def _jax_layout(val):
    pad = np.full(N_ROWS, np.iinfo(np.int32).max, np.int32)
    pad[:val.size] = val
    return jpairs.line_layout(jnp.asarray(pad), jnp.int32(val.size))


@pytest.mark.parametrize("seed,max_len", [(0, 1), (1, 4), (2, 9), (3, 30)])
def test_line_layout_matches_jax(seed, max_len):
    val, _ = _lines(seed, 80, max_len)
    j_pos, j_len, j_start, j_total = _jax_layout(val)
    pos, length, start, total = tpairs.line_layout(torch.as_tensor(val))
    n = val.size
    np.testing.assert_array_equal(pos.numpy(), np.asarray(j_pos)[:n])
    np.testing.assert_array_equal(length.numpy(), np.asarray(j_len)[:n])
    np.testing.assert_array_equal(start.numpy(), np.asarray(j_start)[:n])
    assert int(total) == int(j_total)


@pytest.mark.parametrize("balanced", [False, True])
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("seed,max_len", [(4, 5), (5, 12), (6, 33)])
def test_emit_pair_indices_matches_jax(seed, max_len, balanced, masked):
    val, _ = _lines(seed, 80, max_len)
    j_pos, j_len, j_start, _ = _jax_layout(val)
    pos, length, start, _ = tpairs.line_layout(torch.as_tensor(val))
    emit = np.random.default_rng(seed).random(val.size) < 0.6 if masked \
        else None
    j_emit = None
    if masked:
        j_emit = np.zeros(N_ROWS, bool)
        j_emit[:val.size] = emit
        j_emit = jnp.asarray(j_emit)
    jr, jp, jv = jpairs.emit_pair_indices(j_pos, j_len, j_start, CAPACITY,
                                          balanced=balanced, emit=j_emit)
    row, partner, valid = tpairs.emit_pair_indices(
        pos, length, start, CAPACITY, balanced=balanced,
        emit=None if emit is None else torch.as_tensor(emit))
    jv = np.asarray(jv)
    assert 0 < jv.sum() < CAPACITY
    np.testing.assert_array_equal(valid.numpy(), jv)
    np.testing.assert_array_equal(row.numpy()[jv], np.asarray(jr)[jv])
    np.testing.assert_array_equal(partner.numpy()[jv], np.asarray(jp)[jv])


def test_balanced_emission_owns_each_unordered_pair_once():
    val, _ = _lines(7, 80, 11)
    pos, length, start, total = tpairs.line_layout(torch.as_tensor(val))
    row, partner, valid = tpairs.emit_pair_indices(pos, length, start,
                                                   CAPACITY, balanced=True)
    r, p = row[valid].numpy(), partner[valid].numpy()
    assert 2 * r.size == int(total)
    pairs = set(zip(np.minimum(r, p), np.maximum(r, p)))
    assert len(pairs) == r.size and all(val[a] == val[b] for a, b in pairs)


@pytest.mark.parametrize("values", [
    [5, 0, 7, 1],
    [(1 << 30) - 3, 1, 1, 1, 0, 9],          # reaches SAT exactly, then past
    [(1 << 31) - 1, 1, 2],                   # an input above SAT
    [(1 << 30) - 1] + [1] * 7,               # pinned at SAT over many adds
])
def test_saturating_cumsum_matches_jax_at_the_sat_edge(values):
    x = np.asarray(values, np.int32)
    want = np.asarray(jpairs.saturating_cumsum(jnp.asarray(x)))
    got = tpairs.saturating_cumsum(torch.as_tensor(x))
    np.testing.assert_array_equal(got.numpy(), want)
    assert int(got.max()) <= tpairs.SAT == int(jpairs.SAT)


def test_saturating_cumsum_never_wraps():
    """Two partial sums at SAT: the JAX package's int32 scan adds them to 2^31,
    which wraps negative there; the port's int64 prefix sum stays at SAT."""
    sat = tpairs.SAT
    got = tpairs.saturating_cumsum(torch.tensor([sat, sat, sat, 1],
                                                dtype=torch.int32))
    assert got.tolist() == [sat] * 4
    quarter = torch.full((8,), 1 << 29, dtype=torch.int32)
    assert tpairs.saturating_cumsum(quarter).tolist() == \
        [1 << 29, sat] + [sat] * 6


@pytest.mark.parametrize("budget", [1, 7, 40, 1 << 22])
def test_chunk_boundaries_match_jax(budget):
    rng = np.random.default_rng(budget)
    ppl = rng.integers(0, 30, 50).astype(np.int64) * 2
    assert tallatonce._chunk_boundaries(ppl, budget) == \
        jallatonce._chunk_boundaries(ppl, budget)


def _jax_chunk(cap, val, dep_f, ref_f, balanced):
    """The JAX package's masked chunk stage over one padded chunk."""
    j_pos, j_len, j_start, _ = _jax_layout(val)
    pad_cap = np.full(N_ROWS, np.iinfo(np.int32).max, np.int32)
    pad_cap[:cap.size] = cap

    def flags(f):
        out = np.zeros(N_ROWS, bool)
        out[:cap.size] = f
        return jnp.asarray(out)

    d, r, c, n = js2l._stage_pair_counts_masked(
        jnp.asarray(pad_cap), flags(dep_f), flags(ref_f), j_pos, j_len,
        j_start, capacity=CAPACITY, balanced=balanced)
    n = int(n)
    return (np.asarray(d)[:n].astype(np.int64),
            np.asarray(r)[:n].astype(np.int64),
            np.asarray(c)[:n].astype(np.int64))


@pytest.mark.parametrize("seed,balanced,mask", [
    (8, False, "none"), (9, False, "dep"), (10, False, "both"),
    (11, True, "none")])
def test_stage_pair_counts_matches_jax(seed, balanced, mask):
    val, cap = _lines(seed, 80, 10)
    rng = np.random.default_rng(seed)
    ones = np.ones(val.size, bool)
    dep_f = rng.random(val.size) < 0.5 if mask != "none" else ones
    ref_f = rng.random(val.size) < 0.5 if mask == "both" else ones
    want = _jax_chunk(cap, val, dep_f, ref_f, balanced)
    pos, length, start, _ = tpairs.line_layout(torch.as_tensor(val))
    reps = (length - 1) // 2 + ((length % 2 == 0) & (pos < length // 2)) \
        if balanced else torch.where(torch.as_tensor(dep_f), length - 1, 0)
    key, cnt, n_out = tallatonce._stage_pair_counts(
        torch.as_tensor(cap), pos, length, start, capacity=int(reps.sum()),
        dep_f=torch.as_tensor(dep_f), ref_f=torch.as_tensor(ref_f),
        balanced=balanced)
    n = int(n_out)
    assert n == want[0].size > 0
    key = key[:n].numpy()
    np.testing.assert_array_equal(key >> 32, want[0])
    np.testing.assert_array_equal(key & 0xFFFFFFFF, want[1])
    np.testing.assert_array_equal(cnt[:n].numpy(), want[2])
