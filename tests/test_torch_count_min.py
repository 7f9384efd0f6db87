"""The port's count-min sketch against the JAX package's, on the CPU, bit for bit.

The contract of both: every counter ends at exactly min(true_sum, cap), each row's
count clipped to [0, cap] first.  The JAX package clamps after every chunk of 2^14
rows (it has no int64); the port sums in int64 and clamps once.  The saturation
lemma says the two agree; these tests hold them equal below, at and past the cap
(the host-side cases of tests/test_sketch_saturation.py).  Tolerance: exact.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rdfind_tpu.ops import sketch as jsketch
from rdfind_tpu_torch.ops import sketch as tsketch
from torch_harness import port_module, time_limit  # noqa: F401

CAP = tsketch.MAX_COUNT_MIN_CAP
BITS = 256
K = 2


def _rows(seed, n, lo, hi, n_keys=40):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, n_keys, n).astype(np.int32),
            rng.integers(lo, hi, n).astype(np.int32), rng.random(n) < 0.9)


def _jax_add(keys, cnts, valid, bits=BITS, k=K, cap=CAP):
    return np.array(jsketch.count_min_add(
        jnp.asarray(keys), jnp.asarray(cnts), jnp.asarray(valid), bits=bits,
        num_hashes=k, cap=cap))


def _torch_add(keys, cnts, valid, bits=BITS, k=K, cap=CAP):
    t = tsketch.count_min_add(torch.as_tensor(keys), torch.as_tensor(cnts),
                              torch.as_tensor(valid), bits=bits, num_hashes=k,
                              cap=cap)
    assert t.dtype == torch.int32
    return t.numpy()


@pytest.mark.parametrize("lo,hi,cap", [
    (1, 50, CAP),              # far below the cap
    (CAP // 3, CAP // 2, CAP),  # sums cross the cap
    (CAP - 5, CAP + 5, CAP),    # single rows at and past the cap (clipped)
    (1, 50, 100),               # a small cap saturates too
    (-20, 30, 100),             # negative counts clip to 0
])
def test_count_min_add_matches_jax(lo, hi, cap):
    keys, cnts, valid = _rows(0, 400, lo, hi)
    want = _jax_add(keys, cnts, valid, cap=cap)
    got = _torch_add(keys, cnts, valid, cap=cap)
    np.testing.assert_array_equal(got, want)
    if lo >= CAP // 3:
        assert int(want.max()) == cap


def test_count_min_add_past_the_jax_chunk():
    """More than one 2^14-row chunk of the JAX scan, every row at the clip
    bound: the JAX package clamps between chunks, the port once; both end at
    exactly cap, never a wrapped negative."""
    n = (1 << 14) + 7
    keys = np.zeros(n, np.int32)
    cnts = np.full(n, CAP, np.int32)
    valid = np.ones(n, bool)
    want = _jax_add(keys, cnts, valid, bits=32, k=1)
    got = _torch_add(keys, cnts, valid, bits=32, k=1)
    np.testing.assert_array_equal(got, want)
    assert int(got.max()) == CAP and (got >= 0).all()


@pytest.mark.parametrize("bits,k", [(32, 1), (64, 4), (1 << 20, 4)])
def test_count_min_query_matches_jax(bits, k):
    keys, cnts, valid = _rows(1, 300, 1, 9, n_keys=1 << 20)
    table_j = jsketch.count_min_add(jnp.asarray(keys), jnp.asarray(cnts),
                                    jnp.asarray(valid), bits=bits,
                                    num_hashes=k)
    table_t = tsketch.count_min_add(torch.as_tensor(keys),
                                    torch.as_tensor(cnts),
                                    torch.as_tensor(valid), bits=bits,
                                    num_hashes=k)
    np.testing.assert_array_equal(table_t.numpy(), np.asarray(table_j))
    q = np.random.default_rng(2).integers(0, 1 << 20, 500).astype(np.int32)
    q[:300] = keys  # every inserted key, and others
    want = np.asarray(jsketch.count_min_query(table_j, jnp.asarray(q),
                                              bits=bits, num_hashes=k))
    got = tsketch.count_min_query(table_t, torch.as_tensor(q), bits=bits,
                                  num_hashes=k).numpy()
    np.testing.assert_array_equal(got, want)
    # An upper bound on each key's true count.
    true = np.zeros(1 << 20, np.int64)
    np.add.at(true, keys[valid], cnts[valid])
    assert (got.astype(np.int64) >= true[q]).all()


@pytest.mark.parametrize("seed,lo,hi", [(3, 1, 50), (4, CAP // 3, CAP // 2)])
def test_merge_count_min_matches_jax(seed, lo, hi):
    """Sum of partial tables capped once, below and past the cap."""
    parts = [_jax_add(*_rows(seed + 10 * i, 200, lo, hi)) for i in range(8)]
    want = jsketch.merge_count_min(parts, cap=CAP)
    got = tsketch.merge_count_min([torch.as_tensor(p) for p in parts],
                                  cap=CAP).numpy()
    np.testing.assert_array_equal(got, want)
    # The lemma: merging partials == one build over all rows.
    rows = [_rows(seed + 10 * i, 200, lo, hi) for i in range(8)]
    whole = _torch_add(*(np.concatenate(c) for c in zip(*rows)))
    np.testing.assert_array_equal(whole, want)


def test_count_min_partial_fold_matches_jax():
    keys, cnts, valid = _rows(5, 100, 1, CAP // 2, n_keys=30)
    prev = np.full(BITS, CAP - 10, np.int32)
    want = np.asarray(jsketch.count_min_partial(
        jnp.asarray(keys), jnp.asarray(cnts), jnp.asarray(valid), bits=BITS,
        num_hashes=K, table=jnp.asarray(prev)))
    got = tsketch.count_min_partial(
        torch.as_tensor(keys), torch.as_tensor(cnts), torch.as_tensor(valid),
        bits=BITS, num_hashes=K, table=torch.as_tensor(prev)).numpy()
    np.testing.assert_array_equal(got, want)
    part = tsketch.count_min_partial(
        torch.as_tensor(keys), torch.as_tensor(cnts), torch.as_tensor(valid),
        bits=BITS, num_hashes=K).numpy()
    np.testing.assert_array_equal(part, _jax_add(keys, cnts, valid))


def test_count_min_scatter_accumulates_unclamped():
    """The int64 accumulation under the half-approximate round: several
    scatters then one clamp equal one count_min_add over all rows."""
    rows = [_rows(6 + i, 150, CAP // 4, CAP) for i in range(4)]
    acc = torch.zeros(BITS, dtype=torch.int64)
    for keys, cnts, valid in rows:
        c = np.where(valid, np.minimum(cnts, CAP), 0)
        tsketch.count_min_scatter(acc, torch.as_tensor(keys),
                                  torch.as_tensor(c), num_hashes=K)
    assert int(acc.max()) > CAP  # the sum itself is not clamped
    want = _jax_add(*(np.concatenate(c) for c in zip(*rows)))
    np.testing.assert_array_equal(acc.clamp(max=CAP).to(torch.int32).numpy(),
                                  want)


@pytest.mark.parametrize("cap", [0, CAP + 1])
def test_count_min_add_rejects_a_bad_cap(cap):
    z = torch.zeros(4, dtype=torch.int32)
    with pytest.raises(ValueError, match="cap"):
        tsketch.count_min_add(z, z, z == 0, bits=32, num_hashes=1, cap=cap)
