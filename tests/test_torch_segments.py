"""Parity of the port's segment algebra with the JAX package's, on the CPU.

Inputs are made with numpy from a seed and handed to both packages; every output
is an integer (a permutation, an id, a count or a mask), so the tolerance is
exact.  The JAX functions work at fixed shapes with a validity mask; the port's at
exact shapes, so they are compared on the valid prefix.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rdfind_tpu.ops import segments as jseg
from rdfind_tpu_torch.ops import segments as tseg
from torch_harness import port_module, time_limit  # noqa: F401


# (seed, rows, key columns, key range): keys in [-1, hi) so NO_VALUE = -1 occurs.
CASES = [(0, 60, 1, 6), (1, 200, 2, 7), (2, 300, 3, 4), (3, 1, 2, 3),
         (4, 129, 3, 50)]


def _inputs(seed, n, k, hi):
    rng = np.random.default_rng(seed)
    cols = [rng.integers(-1, hi, n).astype(np.int32) for _ in range(k)]
    valid = rng.random(n) < 0.8
    return cols, valid


def _t(a):
    return torch.as_tensor(np.asarray(a))


@pytest.mark.parametrize("case", CASES)
def test_lexsort_permutation_matches(case):
    cols, _ = _inputs(*case)
    want = np.asarray(jseg.lexsort([jnp.asarray(c) for c in cols]))
    got = tseg.lexsort([_t(c) for c in cols]).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("case", CASES)
def test_run_starts_matches(case):
    cols, _ = _inputs(*case)
    order = np.lexsort(tuple(reversed(cols)))
    srt = [c[order] for c in cols]
    want = np.asarray(jseg.run_starts([jnp.asarray(c) for c in srt]))
    got = tseg.run_starts([_t(c) for c in srt]).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("case", CASES)
def test_masked_unique_matches_on_valid_prefix(case):
    cols, valid = _inputs(*case)
    (j_cols, _, j_inv, j_n) = jseg.masked_unique(
        [jnp.asarray(c) for c in cols], jnp.asarray(valid))
    t_cols, t_inv, t_n = tseg.masked_unique([_t(c) for c in cols], _t(valid))
    assert t_n == int(j_n)
    for jc, tc in zip(j_cols, t_cols):
        np.testing.assert_array_equal(tc.numpy(), np.asarray(jc)[:t_n])
    np.testing.assert_array_equal(t_inv.numpy()[valid], np.asarray(j_inv)[valid])
    assert (t_inv.numpy()[~valid] == -1).all()


@pytest.mark.parametrize("case", CASES)
def test_masked_dense_ids_matches(case):
    cols, valid = _inputs(*case)
    j_inv, j_n = jseg.masked_dense_ids(jnp.asarray(cols[0]), jnp.asarray(valid))
    t_inv, t_n = tseg.masked_dense_ids(_t(cols[0]), _t(valid))
    assert t_n == int(j_n)
    np.testing.assert_array_equal(t_inv.numpy()[valid], np.asarray(j_inv)[valid])


@pytest.mark.parametrize("case", CASES)
def test_masked_row_counts_matches(case):
    cols, valid = _inputs(*case)
    want = np.asarray(jseg.masked_row_counts([jnp.asarray(c) for c in cols],
                                             jnp.asarray(valid)))
    got = tseg.masked_row_counts([_t(c) for c in cols], _t(valid)).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("case", CASES)
def test_compact_matches_on_valid_prefix(case):
    cols, keep = _inputs(*case)
    (j_cols, j_n) = jseg.compact([jnp.asarray(c) for c in cols],
                                 jnp.asarray(keep))
    t_cols, t_n = tseg.compact([_t(c) for c in cols], _t(keep))
    assert t_n == int(j_n)
    for jc, tc in zip(j_cols, t_cols):
        np.testing.assert_array_equal(tc.numpy(), np.asarray(jc)[:t_n])


@pytest.mark.parametrize("case", CASES)
def test_masked_table_index_matches(case):
    seed, n, k, hi = case
    table_src, t_valid = _inputs(seed, n, k, hi)
    query, q_valid = _inputs(seed + 100, n, k, hi)
    j_tab, _, _, j_nt = jseg.masked_unique(
        [jnp.asarray(c) for c in table_src], jnp.asarray(t_valid))
    want = np.asarray(jseg.masked_table_index(
        j_tab, j_nt, [jnp.asarray(c) for c in query], jnp.asarray(q_valid)))
    t_tab, _, _ = tseg.masked_unique([_t(c) for c in table_src], _t(t_valid))
    got = tseg.masked_table_index(t_tab, [_t(c) for c in query],
                                  _t(q_valid)).numpy()
    np.testing.assert_array_equal(got, want)


def test_empty_inputs():
    e = torch.zeros(0, dtype=torch.int32)
    v = torch.zeros(0, dtype=torch.bool)
    cols, inv, n = tseg.masked_unique([e, e], v)
    assert n == 0 and inv.numel() == 0 and cols[0].numel() == 0
    assert tseg.masked_row_counts([e], v).numel() == 0
    assert tseg.masked_table_index(cols, [e, e], v).numel() == 0
    none_valid = torch.zeros(5, dtype=torch.bool)
    _, inv, n = tseg.masked_unique([torch.arange(5, dtype=torch.int32)],
                                   none_valid)
    assert n == 0 and (inv == -1).all()
