"""Strategy 1 (SmallToLarge) of the port against the JAX package's, on the CPU,
on both pair backends: the scenarios of tests/test_small_to_large.py, each run
through both packages on the same interned triples.  Rows (``to_rows()``), the
output digest and the lattice statistics must be equal, bit for bit; where the
JAX tests hold S2L against the raw-output oracle or AllAtOnce, so does the port.
"""

import random

import numpy as np
import pytest

import rdfind_tpu_torch
from rdfind_tpu.dictionary import intern_triples
from rdfind_tpu.models import allatonce as jallatonce
from rdfind_tpu.models import small_to_large as js2l
from rdfind_tpu.obs import integrity as jintegrity
from rdfind_tpu_torch.models import allatonce as tallatonce
from rdfind_tpu_torch.models import small_to_large as ts2l
from rdfind_tpu_torch.obs import integrity as tintegrity
from rdfind_tpu_torch.ops import cooc as tcooc
from rdfind_tpu_torch.utils import synth

from test_allatonce import random_triples
from test_small_to_large import s2l_raw_oracle
from torch_harness import port_module, time_limit  # noqa: F401


BACKENDS = ["matmul", "chunked"]
# Statistics both packages publish on both backends.
STAT_KEYS = ("n_cinds_11", "n_proper_overlaps", "n_cinds_12", "n_cinds_21",
             "n_inferred_21", "n_cinds_22", "pairs_11", "pairs_12", "pairs_21",
             "pairs_22", "total_pairs", "pair_backend", "n_triples",
             "n_line_rows", "n_frequent_rows", "n_captures")


def _intern(triples):
    return intern_triples(np.asarray(triples, dtype=object))


def _decoded(table, dct):
    """The oracle's row format: (dep code, v1, v2, ref code, v1, v2, support)
    with -1 for a missing value."""
    return {(c.dep_code, c.dep_v1, -1 if c.dep_v2 is None else c.dep_v2,
             c.ref_code, c.ref_v1, -1 if c.ref_v2 is None else c.ref_v2,
             c.support) for c in table.decoded(dct)}


def both(ids, min_support, **kw):
    """S2L of both packages on the same id triples; asserts equal rows, digest
    and statistics and returns the port's table and stats."""
    j_stats, t_stats = {}, {}
    want = js2l.discover(ids, min_support, stats=j_stats, **kw)
    got = rdfind_tpu_torch.discover(ids, min_support, strategy=1,
                                    device="cpu", stats=t_stats, **kw)
    assert got.to_rows() == want.to_rows()
    assert len(got) == len(want)
    assert tintegrity.digest_table(got) == jintegrity.digest_table(want)
    for key in STAT_KEYS:
        assert t_stats.get(key) == j_stats.get(key), key
    return got, t_stats


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("min_support", [1, 2, 4])
@pytest.mark.parametrize("seed", range(3))
def test_raw_output_matches_oracle_and_jax(seed, min_support, backend):
    triples = random_triples(random.Random(seed), 90, 6, 3, 5)
    ids, dct = _intern(triples)
    got, stats = both(ids, min_support, pair_backend=backend)
    assert stats["pair_backend"] == backend
    assert _decoded(got, dct) == s2l_raw_oracle(triples, min_support)


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("seed", range(2))
def test_clean_implied_equals_allatonce(seed, backend):
    triples = random_triples(random.Random(100 + seed), 80, 5, 3, 4)
    ids, _ = _intern(triples)
    got, _ = both(ids, 2, clean_implied=True, pair_backend=backend)
    aao = rdfind_tpu_torch.discover(ids, 2, strategy=0, device="cpu",
                                    clean_implied=True)
    assert len(got) > 0 and got.to_rows() == aao.to_rows()


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("projections", ["s", "o", "sp", "spo"])
def test_projections(projections, backend):
    triples = random_triples(random.Random(11), 70, 5, 3, 4)
    ids, dct = _intern(triples)
    got, _ = both(ids, 2, projections=projections, pair_backend=backend)
    assert _decoded(got, dct) == s2l_raw_oracle(triples, 2,
                                                projections=projections)


@pytest.mark.parametrize("backend", BACKENDS)
def test_fc_filter_invariant(backend):
    triples = random_triples(random.Random(3), 120, 7, 3, 6)
    ids, _ = _intern(triples)
    with_f, _ = both(ids, 3, pair_backend=backend)
    without_f, _ = both(ids, 3, pair_backend=backend,
                        use_frequent_condition_filter=False)
    assert len(with_f) > 0 and with_f.to_rows() == without_f.to_rows()


def test_skewed_data_chunked():
    """A hub join value puts many captures into one line, above the budget:
    the line becomes a chunk of its own among many small ones."""
    triples = [("hub", f"p{i % 3}", f"o{i}") for i in range(40)]
    triples += random_triples(random.Random(7), 60, 4, 3, 4)
    ids, dct = _intern(triples)
    got, stats = both(ids, 2, pair_backend="chunked", pair_chunk_budget=1 << 8)
    assert stats["n_pair_chunks"] > 4
    assert _decoded(got, dct) == s2l_raw_oracle(triples, 2)


@pytest.mark.parametrize("seed", range(2))
def test_dense_matches_chunked_with_ars(seed):
    """The dense backend's AR branch (host filter, K rebuilt on the device)
    equals the chunked one's: the ARs gate the 1/1 CINDs that seed 1/2
    generation and 2/1 inference."""
    triples = random_triples(random.Random(seed + 80), 120, 4, 3, 3)
    ids, _ = _intern(triples)
    a, _ = both(ids, 2, use_association_rules=True, pair_backend="matmul")
    b, _ = both(ids, 2, use_association_rules=True, pair_backend="chunked")
    assert len(a) > 0 and a.to_rows() == b.to_rows()


def test_dense_matches_chunked_tiny():
    """One triple: the 2/1 and 2/2 levels have no candidates, and both
    backends leave those stat keys unset."""
    ids, _ = _intern([("a", "p", "b")])
    _, s_d = both(ids, 1, pair_backend="matmul")
    _, s_c = both(ids, 1, pair_backend="chunked")
    for key in ("pairs_11", "pairs_12", "pairs_21", "pairs_22", "total_pairs"):
        assert s_d.get(key) == s_c.get(key), key


@pytest.mark.parametrize("seed", range(2))
def test_balanced_11_matches_exact(seed):
    """Rotation ownership: the same output from half the 1/1 pair slots."""
    triples = random_triples(random.Random(seed + 300), 120, 7, 3, 5)
    ids, _ = _intern(triples)
    a, s_b = both(ids, 2, balanced_11=True)
    b, s_c = both(ids, 2, pair_backend="chunked")
    assert len(a) > 0 and a.to_rows() == b.to_rows()
    assert s_b["pairs_11"] * 2 == s_c["pairs_11"]
    assert s_b["pair_backend"] == "chunked"


def test_balanced_11_skewed_chunked():
    triples = [("hub", f"p{i % 3}", f"o{i}") for i in range(40)]
    ids, _ = _intern(triples)
    a, _ = both(ids, 2, balanced_11=True, pair_chunk_budget=1 << 8)
    b, _ = both(ids, 2, pair_backend="chunked")
    assert a.to_rows() == b.to_rows()


@pytest.mark.parametrize("seed", range(2))
def test_dense_matches_chunked(seed):
    """The resident-cooc backend and the per-level emission agree, the
    per-level pair accounting included."""
    triples = random_triples(random.Random(seed + 60), 120, 7, 3, 5)
    ids, _ = _intern(triples)
    a, s_d = both(ids, 2, pair_backend="matmul")
    b, s_c = both(ids, 2, pair_backend="chunked")
    assert (s_d["pair_backend"], s_c["pair_backend"]) == ("matmul", "chunked")
    assert len(a) > 0 and a.to_rows() == b.to_rows()
    for key in ("pairs_11", "pairs_12", "pairs_21", "pairs_22", "total_pairs",
                "n_cinds_11", "n_proper_overlaps"):
        assert s_d.get(key) == s_c.get(key), key


@pytest.mark.parametrize("backend", BACKENDS)
def test_empty_and_tiny(backend):
    empty = rdfind_tpu_torch.discover(np.zeros((0, 3), np.int32), 2,
                                      strategy=1, device="cpu",
                                      pair_backend=backend)
    assert len(empty) == 0
    triples = [("a", "b", "c")]
    ids, dct = _intern(triples)
    got, _ = both(ids, 1, pair_backend=backend)
    assert _decoded(got, dct) == s2l_raw_oracle(triples, 1)
    got, _ = both(ids, 5, pair_backend=backend)  # no frequent capture
    assert len(got) == 0


@pytest.mark.parametrize("fc", [True, False])
@pytest.mark.parametrize("backend", BACKENDS)
def test_stats_match_jax_on_synth_triples(backend, fc, monkeypatch):
    """A synth workload through the public entry point: every lattice count,
    and fewer pairs checked than AllAtOnce's full quadratic."""
    monkeypatch.setenv("RDFIND_INTEGRITY", "1")  # publish the output stage
    triples = synth.generate_triples(600, seed=5, n_predicates=7,
                                     n_entities=60)
    got, stats = both(triples, 3, pair_backend=backend,
                      use_frequent_condition_filter=fc)
    aao = {}
    tallatonce.discover(triples, 3, device="cpu", stats=aao)
    assert len(got) > 0
    assert 0 < stats["pairs_11"] <= aao["total_pairs"]
    assert stats["integrity_stages"]["output"] == \
        tintegrity.digest_hex(*tintegrity.digest_table(got))


@pytest.mark.parametrize("balanced,budget", [(False, 64), (False, 1 << 22),
                                             (True, 64)])
def test_chunked_cooc_matches_jax(balanced, budget):
    """The chunk loop and the host merge on phase A's rows, flagged 1/1
    (unary x unary) or restricted to random dep and ref sets."""
    triples = synth.generate_triples(500, seed=9, n_predicates=6,
                                     n_entities=50)
    st = jallatonce.prepare_join_lines(triples, 2, "spo", True, False, None)
    lv = np.asarray(st["line_val_h"], np.int64)
    lc = np.asarray(st["line_cap_h"], np.int64)
    rng = np.random.default_rng(budget)
    num_caps = st["num_caps"]
    if balanced:
        dep_ok = ref_ok = rng.random(num_caps) < 0.7
    else:
        dep_ok, ref_ok = rng.random(num_caps) < 0.5, rng.random(num_caps) < 0.5
    j_stats, t_stats = {}, {}
    want = js2l._chunked_cooc(st["line_val_h"], st["line_cap_h"], dep_ok,
                              ref_ok, budget, j_stats, "pairs_x",
                              balanced=balanced)
    got = ts2l._chunked_cooc(lv, lc, dep_ok, ref_ok, budget, t_stats,
                             "pairs_x", "cpu", balanced=balanced)
    assert want[0].size > 0
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert t_stats["pairs_x"] == j_stats["pairs_x"]
    assert t_stats["n_pair_chunks"] >= (5 if budget == 64 else 1)


def test_auto_falls_back_to_chunked_past_single_shot(monkeypatch):
    """A capture axis above SINGLE_SHOT_C takes the chunked walk under "auto"
    and makes "matmul" raise."""
    triples = random_triples(random.Random(5), 120, 7, 3, 5)
    ids, _ = _intern(triples)
    want = js2l.discover(ids, 2, pair_backend="chunked")
    monkeypatch.setattr(tcooc, "SINGLE_SHOT_C", 64)
    stats = {}
    got = rdfind_tpu_torch.discover(ids, 2, strategy=1, device="cpu",
                                    stats=stats)
    assert stats["pair_backend"] == "chunked"
    assert len(got) > 0 and got.to_rows() == want.to_rows()
    with pytest.raises(ValueError, match="matmul"):
        rdfind_tpu_torch.discover(ids, 2, strategy=1, device="cpu",
                                  pair_backend="matmul")
