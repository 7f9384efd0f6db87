"""The half-approximate 1/1 round of strategy 1 (``explicit_threshold``) in the port
against the JAX package's, on the CPU, on the same id triples.

Rows (``to_rows()``), the output digest and the five ``ha_*`` statistics must be
equal, bit for bit.  The statistics depend on the chunking (round 1 admits the
first ``explicit_threshold`` new pairs of a dependent in key order within each
chunk), so they also check that the port's chunks have the JAX package's
boundaries and rows.  The output must also equal the exact path's.
"""

import random

import numpy as np
import pytest
import torch

import rdfind_tpu_torch
from rdfind_tpu.dictionary import intern_triples
from rdfind_tpu.models import small_to_large as js2l
from rdfind_tpu.obs import integrity as jintegrity
from rdfind_tpu_torch.models import small_to_large as ts2l
from rdfind_tpu_torch.obs import integrity as tintegrity
from rdfind_tpu_torch.utils import synth

from test_allatonce import random_triples
from torch_harness import port_module, time_limit  # noqa: F401

HA_KEYS = ("ha_spilled", "ha_round2_deps", "ha_explicit_pairs",
           "ha_round2_merged_pairs", "ha_round2_rows")
STAT_KEYS = HA_KEYS + ("n_cinds_11", "n_proper_overlaps", "n_cinds_12",
                       "n_cinds_21", "n_inferred_21", "n_cinds_22",
                       "pairs_11", "total_pairs", "pair_backend")


@pytest.fixture(scope="module")
def ids():
    return synth.generate_triples(400, seed=5, n_predicates=6,
                                  n_entities=60)


def both(ids, min_support, **kw):
    """Strategy 1 of both packages; asserts equal rows, digest and
    statistics, and the exact path's rows; returns the port's stats."""
    j_stats, t_stats = {}, {}
    want = js2l.discover(ids, min_support, stats=j_stats, **kw)
    got = rdfind_tpu_torch.discover(ids, min_support, strategy=1,
                                    device="cpu", stats=t_stats, **kw)
    assert got.to_rows() == want.to_rows()
    assert tintegrity.digest_table(got) == jintegrity.digest_table(want)
    for key in STAT_KEYS:
        assert t_stats.get(key) == j_stats.get(key), key
    exact = {k: v for k, v in kw.items()
             if k not in ("explicit_threshold", "sbf_bits", "sbf_width")}
    assert got.to_rows() == rdfind_tpu_torch.discover(
        ids, min_support, strategy=1, device="cpu", **exact).to_rows()
    return t_stats


@pytest.mark.parametrize("budget", [512, 1 << 22])
@pytest.mark.parametrize("sbf_width", [64, 1 << 20])
@pytest.mark.parametrize("threshold", [0, 1, 3, 10 ** 6])
def test_half_approx_matches_jax(ids, threshold, sbf_width, budget):
    """sbf_width 64 forces collisions (more unknown pairs, more round 2);
    budget 512 cuts the lines into many chunks."""
    stats = both(ids, 3, explicit_threshold=threshold, sbf_width=sbf_width,
                 pair_chunk_budget=budget)
    assert stats["pair_backend"] == "chunked"
    if threshold == 10 ** 6:
        assert stats["ha_spilled"] == 0 and stats["ha_round2_deps"] == 0
    else:
        assert stats["ha_spilled"] > 0 and stats["ha_round2_deps"] > 0
    if budget == 512:
        assert stats["n_pair_chunks"] > 5


@pytest.mark.parametrize("kw", [
    dict(use_frequent_condition_filter=False),
    dict(use_association_rules=True, clean_implied=True),
    dict(projections="so"),
    dict(balanced_11=True),  # ignored under the half-approximate round
    dict(sbf_bits=3),        # cap 7: saturating counters, support 3
])
def test_half_approx_options_match_jax(ids, kw):
    both(ids, 3, explicit_threshold=2, pair_chunk_budget=1024, **kw)


@pytest.mark.parametrize("seed", range(3))
def test_half_approx_random_small_inputs(seed):
    triples = random_triples(random.Random(seed + 200), 120, 7, 3, 5)
    ids, _ = intern_triples(np.asarray(triples, dtype=object))
    both(ids, 2, explicit_threshold=seed, sbf_width=64,
         pair_chunk_budget=64)


def test_half_approx_forces_the_chunked_backend(ids):
    """With the dense plan fitting, "auto" would take it; the half-approximate
    round is a chunked-backend round, as in the JAX package."""
    stats = {}
    rdfind_tpu_torch.discover(ids, 3, strategy=1, device="cpu",
                              explicit_threshold=4, stats=stats)
    assert stats["pair_backend"] == "chunked"
    assert all(k in stats for k in HA_KEYS)


def test_half_approx_sbf_bits_guard():
    ids, _ = intern_triples(np.asarray([("a", "p", "b")], dtype=object))
    with pytest.raises(ValueError, match="saturates"):
        js2l.discover(ids, 100, explicit_threshold=2, sbf_bits=3)
    with pytest.raises(ValueError, match="saturates"):
        rdfind_tpu_torch.discover(ids, 100, strategy=1, device="cpu",
                                  explicit_threshold=2, sbf_bits=3)
    # The default width holds min_support; without the round no guard.
    rdfind_tpu_torch.discover(ids, 100, strategy=1, device="cpu",
                              explicit_threshold=2)
    rdfind_tpu_torch.discover(ids, 100, strategy=1, device="cpu", sbf_bits=3)


@pytest.mark.parametrize("sbf_bits", [-5, 0, 1, 3, 16, 17, 40])
def test_sbf_cap_matches_jax(sbf_bits):
    assert ts2l._sbf_cap(sbf_bits) == js2l._sbf_cap(sbf_bits)


def test_pair_hash32_matches_numpy_on_bit_63():
    """The JAX package multiplies in uint64; the port's wrapped int64 multiply
    must give the same bits, keys with bit 63 set included."""
    rng = np.random.default_rng(9)
    keys = rng.integers(-(1 << 63), (1 << 63) - 1, 4096, dtype=np.int64)
    keys[:6] = [0, 1, -1, -(1 << 63), (1 << 63) - 1, (7 << 32) | 11]
    assert (keys < 0).sum() > 1000  # bit 63 set
    want = js2l._pair_hash32(keys)
    got = ts2l._pair_hash32(torch.as_tensor(keys))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    assert (want >= 0).all()


def test_half_approx_round_matches_jax_directly(ids):
    """The round itself on one join-line table with random dep/ref flags:
    the same (dep, ref, cnt) rows and statistics."""
    from rdfind_tpu.models import allatonce as jallatonce

    st = jallatonce.prepare_join_lines(ids, 2, "spo", True, False, None)
    lv, lc = st["line_val_h"], st["line_cap_h"]
    rng = np.random.default_rng(4)
    ok = rng.random(st["num_caps"]) < 0.6
    j_stats, t_stats = {}, {}
    want = js2l._half_approx_cooc_11(lv, lc, ok, ok, 512, j_stats, 2, 2, 3,
                                     64)
    got = ts2l._half_approx_cooc_11(lv, lc, ok, ok, 512, t_stats, 2, 2, 3, 64,
                                    "cpu")
    assert want[0].size > 0
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    for key in HA_KEYS + ("pairs_11", "total_pairs"):
        assert t_stats[key] == j_stats[key], key
