"""Parity of candidate preparation (frequency, emission, capture interning, dense
line ids) between the port and the JAX package, on the CPU.

The same numpy triples go through ``rdfind_tpu.models.allatonce._stage_prepare``
and its port; all outputs are integer ids and masks, compared exactly.  The JAX
stage pads the triples to a power of two and emits one candidate block per padded
triple and projection part; the port emits exact blocks, so the JAX blocks are cut
to the real rows before comparing.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rdfind_tpu.models import allatonce as jallatonce
from rdfind_tpu.ops import frequency as jfrequency
from rdfind_tpu.ops import segments as jseg
from rdfind_tpu_torch.models import allatonce as tallatonce
from rdfind_tpu_torch.ops import frequency as tfrequency
from rdfind_tpu_torch.utils import synth


@pytest.fixture(autouse=True, scope="module")
def _release_jax_programs():
    """Drop the XLA programs compiled in and before this module: each keeps
    executable memory mappings, and a test process that gathers too many hits
    the kernel's per-process map limit (vm.max_map_count) inside XLA."""
    jax.clear_caches()
    yield
    jax.clear_caches()


MIN_SUPPORT = 3


def _triples(seed=3):
    return synth.generate_triples(500, seed=seed, n_predicates=6,
                                  n_entities=40)


def _padded(triples):
    n = triples.shape[0]
    cap = jseg.pow2_capacity(n)
    return jnp.asarray(np.pad(triples, ((0, cap - n), (0, 0)),
                              constant_values=np.iinfo(np.int32).max)), cap


@pytest.mark.parametrize("projections", ["spo", "s", "po"])
@pytest.mark.parametrize("fc,ars", [(False, False), (True, False),
                                    (True, True)])
def test_stage_prepare_matches(projections, fc, ars):
    triples = _triples()
    n = triples.shape[0]
    padded, cap = _padded(triples)
    (j_gid, j_cap, j_valid, j_nl, j_code, j_v1, j_v2, j_nc) = \
        jallatonce._stage_prepare(padded, jnp.int32(n), jnp.int32(MIN_SUPPORT),
                                  projections=projections, use_fc_filter=fc,
                                  use_ars=ars)
    (t_gid, t_cap, t_valid, t_nl, t_code, t_v1, t_v2, t_nc) = \
        tallatonce._stage_prepare(torch.as_tensor(triples), MIN_SUPPORT,
                                  projections=projections, use_fc_filter=fc,
                                  use_ars=ars)
    assert (t_nl, t_nc) == (int(j_nl), int(j_nc))
    for jc, tc in ((j_code, t_code), (j_v1, t_v1), (j_v2, t_v2)):
        np.testing.assert_array_equal(tc.numpy(), np.asarray(jc)[:t_nc])

    def real_rows(a):  # JAX (parts * cap,) -> the port's (parts * n,)
        return np.asarray(a).reshape(-1, cap)[:, :n].reshape(-1)

    valid = t_valid.numpy()
    np.testing.assert_array_equal(valid, real_rows(j_valid))
    np.testing.assert_array_equal(t_gid.numpy()[valid], real_rows(j_gid)[valid])
    np.testing.assert_array_equal(t_cap.numpy()[valid], real_rows(j_cap)[valid])


@pytest.mark.parametrize("find_ar_implied", [False, True])
def test_triple_frequencies_match(find_ar_implied):
    triples = _triples(seed=5)
    padded, _ = _padded(triples)
    n = triples.shape[0]
    valid = jnp.arange(padded.shape[0]) < n
    want = jfrequency.triple_frequencies(padded, valid, MIN_SUPPORT,
                                         find_ar_implied=find_ar_implied)
    got = tfrequency.triple_frequencies(torch.as_tensor(triples), MIN_SUPPORT,
                                        find_ar_implied=find_ar_implied)
    for field in ("unary_ok", "binary_ok", "binary_ar_implied"):
        np.testing.assert_array_equal(getattr(got, field).numpy(),
                                      np.asarray(getattr(want, field))[:n])


@pytest.mark.parametrize("seed,min_support", [(1, 2), (7, 3), (11, 1)])
def test_mine_association_rules_matches(seed, min_support):
    triples = _triples(seed=seed)
    want = jfrequency.mine_association_rules(triples, min_support)
    got = tfrequency.mine_association_rules(torch.as_tensor(triples),
                                            min_support)
    assert len(want[0]) > 0
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g, np.asarray(w))


def test_ar_implied_pair_mask_matches():
    triples = _triples(seed=1)
    rules = jfrequency.mine_association_rules(triples, 2)
    rng = np.random.default_rng(0)
    codes = np.array([17, 20, 10, 12, 33, 34, 35, 19, 44])
    k = 400
    dep_code, ref_code = rng.choice(codes, k), rng.choice(codes, k)
    pool = np.unique(np.concatenate([rules[2], rules[3]]))
    dep_v1, ref_v1 = rng.choice(pool, k), rng.choice(pool, k)
    want = jfrequency.ar_implied_pair_mask(dep_code, ref_code, dep_v1, ref_v1,
                                           rules)
    got = tfrequency.ar_implied_pair_mask(dep_code, ref_code, dep_v1, ref_v1,
                                          rules)
    np.testing.assert_array_equal(got, want)
