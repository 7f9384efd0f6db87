"""Strategy 3 (LateBB) of the port against the JAX package's, on the CPU: rows,
digests and the round statistics must be equal, bit for bit; with clean_implied
the output must equal strategy 0's."""

import pytest

import rdfind_tpu_torch
from rdfind_tpu.models import late_bb as jlate_bb
from rdfind_tpu.obs import integrity as jintegrity
from rdfind_tpu_torch.models import late_bb as tlate_bb
from rdfind_tpu_torch.obs import integrity as tintegrity
from rdfind_tpu_torch.ops import cooc as tcooc
from rdfind_tpu_torch.utils import synth
from torch_harness import port_module, time_limit  # noqa: F401


def _triples(seed):
    return synth.generate_triples(700, seed=seed, n_predicates=8,
                                  n_entities=80)


ROUND_STATS = ("n_round1_candidates", "n_round1_cinds", "n_round2_candidates",
               "n_round2_cinds", "pairs_round1", "pairs_round2", "total_pairs",
               "pair_backend")

CASES = [
    (41, 2, {}),
    (42, 3, dict(clean_implied=True)),
    (43, 3, dict(use_association_rules=True)),
    (44, 2, dict(use_frequent_condition_filter=False, sketch_bits=512)),
]


@pytest.mark.parametrize("seed,min_support,kw", CASES)
def test_discover_matches_jax(seed, min_support, kw):
    triples = _triples(seed)
    want_stats, got_stats = {}, {}
    want = jlate_bb.discover(triples, min_support, stats=want_stats, **kw)
    got = tlate_bb.discover(triples, min_support, stats=got_stats,
                            device="cpu", **kw)
    assert len(want) > 0 and want_stats["n_round2_candidates"] > 0
    assert got.to_rows() == want.to_rows()
    assert len(got) == len(want)
    assert tintegrity.digest_table(got) == jintegrity.digest_table(want)
    for key in ROUND_STATS:
        assert got_stats[key] == want_stats[key], key


@pytest.mark.parametrize("seed", [45, 46])
def test_clean_late_bb_equals_clean_strategy0(seed):
    triples = _triples(seed)
    got = rdfind_tpu_torch.discover(triples, 2, strategy=3, device="cpu",
                                    clean_implied=True)
    want = rdfind_tpu_torch.discover(triples, 2, strategy=0, device="cpu",
                                     clean_implied=True)
    assert len(want) > 0 and got.to_rows() == want.to_rows()


def _small_triples(seed):
    """Fewer triples for the chunked verification: with a 256-bit sketch the
    plain K2 stays cheap, and the chunk loop still takes tens of chunks."""
    return synth.generate_triples(400, seed=seed, n_predicates=8,
                                  n_entities=80)


@pytest.mark.parametrize("seed,kw", [
    (41, dict(pair_chunk_budget=256)),
    (44, dict(use_frequent_condition_filter=False)),
])
def test_chunked_backend_matches_jax(seed, kw):
    triples = _small_triples(seed)
    want_stats, got_stats = {}, {}
    want = jlate_bb.discover(triples, 2, pair_backend="chunked",
                             sketch_bits=256, stats=want_stats, **kw)
    got = tlate_bb.discover(triples, 2, pair_backend="chunked",
                            sketch_bits=256, stats=got_stats,
                                device="cpu", **kw)
    assert len(want) > 0 and want_stats["n_round2_candidates"] > 0
    assert got.to_rows() == want.to_rows()
    assert tintegrity.digest_table(got) == jintegrity.digest_table(want)
    for key in ROUND_STATS:
        assert got_stats[key] == want_stats[key], key
    assert got_stats["pair_backend"] == "chunked"


def test_oversized_verification_falls_back_to_chunked(monkeypatch):
    want = jlate_bb.discover(_small_triples(41), 2, sketch_bits=256,
                             pair_backend="chunked")
    monkeypatch.setattr(tcooc, "SINGLE_SHOT_C", 64)
    stats = {}
    got = tlate_bb.discover(_small_triples(41), 2, device="cpu",
                            sketch_bits=256, stats=stats)
    assert stats["pair_backend"] == "chunked"
    assert len(got) > 0 and got.to_rows() == want.to_rows()
