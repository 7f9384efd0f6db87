"""Strategy 2 (ApproximateAllAtOnce) of the port against the JAX package's, on the
CPU: phase A, the sketch build, the candidate pass on the JAX package's own
sketches, and discover as a whole.  Same numpy triples into both; rows, digests,
the sketch-candidate count and the verification stats must be equal, bit for bit.
"""

import jax
import numpy as np
import pytest

from rdfind_tpu.models import allatonce as jallatonce
from rdfind_tpu.models import approximate as japproximate
from rdfind_tpu.obs import integrity as jintegrity
from rdfind_tpu_torch import state
from rdfind_tpu_torch.models import allatonce as tallatonce
from rdfind_tpu_torch.models import approximate as tapproximate
from rdfind_tpu_torch.obs import integrity as tintegrity
from rdfind_tpu_torch.ops import cooc as tcooc
from rdfind_tpu_torch.utils import synth


@pytest.fixture(autouse=True, scope="module")
def _release_jax_programs():
    """Drop the XLA programs compiled in and before this module: each keeps
    executable memory mappings, and a test process that gathers too many hits
    the kernel's per-process map limit (vm.max_map_count) inside XLA."""
    jax.clear_caches()
    yield
    jax.clear_caches()


def _triples(seed):
    return synth.generate_triples(700, seed=seed, n_predicates=8,
                                  n_entities=80)


@pytest.fixture(scope="module")
def phase_a():
    """The JAX package's phase-A state for one workload, and its triples."""
    triples = _triples(21)
    st = jallatonce.prepare_join_lines(triples, 3, "spo", True, False, None)
    return triples, st


def test_prepare_join_lines_matches_jax(phase_a):
    triples, want = phase_a
    stats = {}
    got = tallatonce.prepare_join_lines(
        tallatonce.triples_on(triples, "cpu"), 3, "spo", True, False, stats)
    want = state.phase_a_state(want)
    assert got.keys() == want.keys()
    for key in state.HOST_FIELDS:
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    assert got["num_caps"] == want["num_caps"]
    assert stats["n_frequent_rows"] == len(want["line_val_h"])


@pytest.mark.parametrize("bits,num_hashes,row_budget", [
    (2048, 4, 1 << 18),  # one chunk
    (256, 3, 64),        # many chunks of whole lines
    (32, 1, 1),          # one line per chunk
])
def test_build_sketches_matches_jax(phase_a, bits, num_hashes, row_budget):
    _, st = phase_a
    want = japproximate._build_sketches(
        st["line_val_h"], st["line_cap_h"], st["num_caps"], bits=bits,
        num_hashes=num_hashes, row_budget=row_budget)
    host = state.phase_a_state(st)
    got = tapproximate._build_sketches(
        host["line_val_h"], host["line_cap_h"], host["num_caps"], bits=bits,
        num_hashes=num_hashes, device="cpu", row_budget=row_budget)
    np.testing.assert_array_equal(got.numpy(),
                                  np.array(want).view(np.int32))


@pytest.mark.parametrize("masked", [False, True])
def test_candidate_pairs_on_the_jax_sketches(phase_a, masked):
    """The JAX package's sketches, carried across by state.py, give the same
    candidate pairs in the same order."""
    _, st = phase_a
    num_caps, bits = st["num_caps"], 512
    sk = japproximate._build_sketches(st["line_val_h"], st["line_cap_h"],
                                      num_caps, bits=bits, num_hashes=4)
    mask = (np.asarray(st["dep_count"]) >= 4) if masked else None
    kw = dict(bits=bits, num_hashes=4, dep_mask=mask, ref_mask=mask)
    want_d, want_r = japproximate._candidate_pairs(sk, num_caps, **kw)
    dev = state.stage_state_to_device({"sketches": np.asarray(sk)}, "cpu")
    got_d, got_r = tapproximate._candidate_pairs(dev["sketches"], num_caps,
                                                 **kw)
    assert len(want_d) > 0
    np.testing.assert_array_equal(got_d, want_d)
    np.testing.assert_array_equal(got_r, want_r)


CASES = [
    # (seed, min_support, keyword arguments)
    (31, 2, {}),
    (32, 4, dict(clean_implied=True)),
    (33, 3, dict(use_association_rules=True)),
    (34, 3, dict(use_frequent_condition_filter=False, sketch_bits=512)),
    (35, 2, dict(projections="po", sketch_bits=256, sketch_hashes=2)),
]


@pytest.mark.parametrize("seed,min_support,kw", CASES)
def test_discover_matches_jax(seed, min_support, kw):
    triples = _triples(seed)
    want_stats, got_stats = {}, {}
    want = japproximate.discover(triples, min_support, stats=want_stats, **kw)
    got = tapproximate.discover(triples, min_support, stats=got_stats,
                                device="cpu", **kw)
    assert len(want) > 0
    assert got.to_rows() == want.to_rows()
    assert len(got) == len(want)
    assert tintegrity.digest_table(got) == jintegrity.digest_table(want)
    for key in ("n_sketch_candidates", "pairs_verify", "total_pairs",
                "n_frequent_rows", "n_line_rows", "n_captures",
                "pair_backend", "pairs_verify_backend"):
        assert got_stats[key] == want_stats[key], key
    assert got_stats["dense_plan"]["c_pad"] <= tcooc.SINGLE_SHOT_C


def test_discover_with_no_frequent_capture_is_empty():
    want_stats, got_stats = {}, {}
    want = japproximate.discover(_triples(31), 10_000, stats=want_stats)
    got = tapproximate.discover(_triples(31), 10_000, stats=got_stats,
                                device="cpu")
    assert len(got) == len(want) == 0
    assert "n_sketch_candidates" not in got_stats
    assert "n_sketch_candidates" not in want_stats


CHUNK_KEYS = ("n_sketch_candidates", "pairs_verify", "total_pairs",
              "pair_backend", "pairs_verify_backend")


def _small_triples(seed):
    """Fewer triples for the chunked verification: with a 256-bit sketch the
    plain K2 stays cheap, and the chunk loop still takes tens of chunks."""
    return synth.generate_triples(400, seed=seed, n_predicates=8,
                                  n_entities=80)


@pytest.mark.parametrize("seed,kw", [
    (31, dict(pair_chunk_budget=256)),
    (34, dict(use_frequent_condition_filter=False)),
])
def test_chunked_backend_matches_jax(seed, kw):
    triples = _small_triples(seed)
    want_stats, got_stats = {}, {}
    want = japproximate.discover(triples, 2, pair_backend="chunked",
                                 sketch_bits=256, stats=want_stats, **kw)
    got = tapproximate.discover(triples, 2, pair_backend="chunked",
                                sketch_bits=256, stats=got_stats,
                                device="cpu", **kw)
    assert len(want) > 0
    assert got.to_rows() == want.to_rows()
    assert tintegrity.digest_table(got) == jintegrity.digest_table(want)
    for key in CHUNK_KEYS:
        assert got_stats[key] == want_stats[key], key
    assert got_stats["pairs_verify_backend"] == "chunked"


def test_oversized_verification_falls_back_to_chunked(monkeypatch):
    """Past SINGLE_SHOT_C "auto" verifies on the chunked loop (as the JAX
    package does) and "matmul" raises."""
    want = japproximate.discover(_small_triples(31), 2, sketch_bits=256,
                                 pair_backend="chunked")
    monkeypatch.setattr(tcooc, "SINGLE_SHOT_C", 64)
    stats = {}
    got = tapproximate.discover(_small_triples(31), 2, device="cpu",
                                sketch_bits=256, stats=stats)
    assert stats["pairs_verify_backend"] == "chunked"
    assert len(got) > 0 and got.to_rows() == want.to_rows()
    with pytest.raises(ValueError, match="matmul"):
        tapproximate.discover(_small_triples(31), 2, device="cpu",
                              sketch_bits=256, pair_backend="matmul")
