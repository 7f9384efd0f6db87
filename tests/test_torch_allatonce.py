"""The slice as a whole: strategy 0 of the port against the JAX package's, on the
CPU.  Same numpy triples into both; the CIND sets (``to_rows()``) and the output
digests (``integrity.digest_table``) must be equal, bit for bit.
"""

import jax
import numpy as np
import pytest

import rdfind_tpu
import rdfind_tpu_torch
from rdfind_tpu import oracle
from rdfind_tpu.obs import integrity as jintegrity
from rdfind_tpu.ops import minimality as jminimality
from rdfind_tpu_torch import state
from rdfind_tpu_torch.data import CindTable
from rdfind_tpu_torch.dictionary import intern_triples
from rdfind_tpu_torch.models import allatonce as tallatonce
from rdfind_tpu_torch.obs import integrity as tintegrity
from rdfind_tpu_torch.ops import cooc as tcooc
from rdfind_tpu_torch.ops import minimality as tminimality
from rdfind_tpu_torch.utils import synth


@pytest.fixture(autouse=True, scope="module")
def _release_jax_programs():
    """Drop the XLA programs compiled in and before this module: each keeps
    executable memory mappings, and a test process that gathers too many hits
    the kernel's per-process map limit (vm.max_map_count) inside XLA."""
    jax.clear_caches()
    yield
    jax.clear_caches()


WORKLOADS = {
    "triples": (lambda: synth.generate_triples(700, seed=11, n_predicates=7,
                                               n_entities=60), 3),
    "planted": (lambda: synth.generate_planted_cinds(2, 6, seed=0)[0], 6),
}
# (use_frequent_condition_filter, use_association_rules): ARs need the filter.
FILTERS = [(False, False), (True, False), (True, True)]


@pytest.mark.parametrize("clean_implied", [False, True])
@pytest.mark.parametrize("fc,ars", FILTERS)
@pytest.mark.parametrize("workload", sorted(WORKLOADS))
def test_strategy0_matches_jax(workload, fc, ars, clean_implied):
    make, min_support = WORKLOADS[workload]
    triples = make()
    kw = dict(use_frequent_condition_filter=fc, use_association_rules=ars,
              clean_implied=clean_implied)
    want = rdfind_tpu.discover(triples, min_support, strategy=0, **kw)
    stats = {}
    got = rdfind_tpu_torch.discover(triples, min_support, strategy=0,
                                    device="cpu", stats=stats, **kw)
    assert len(want) > 0
    assert got.to_rows() == want.to_rows()
    assert len(got) == len(want)  # no duplicate rows either
    digest = tintegrity.digest_table(got)
    assert digest == jintegrity.digest_table(want)
    assert stats["integrity_stages"]["output"] == tintegrity.digest_hex(*digest)
    assert stats["pair_backend"] == "matmul"


def test_oracle_on_a_tiny_case():
    triples = [("alice", "bornIn", "berlin"), ("bob", "bornIn", "berlin"),
               ("alice", "livesIn", "berlin"), ("bob", "livesIn", "berlin"),
               ("carol", "livesIn", "paris"), ("dave", "bornIn", "rome"),
               ("dave", "livesIn", "rome")]
    ids, _ = intern_triples(np.asarray(triples, dtype=object))
    for clean in (False, True):
        want = oracle.discover_cinds_definitional(ids, 2)
        if clean:
            want = oracle.minimize_cinds(want)
        got = rdfind_tpu_torch.discover(ids, 2, strategy=0, device="cpu",
                                        clean_implied=clean)
        assert got.to_rows() == set(want)
        assert len(want) > 0


def test_minimize_table_matches_jax():
    triples, _ = synth.generate_planted_cinds(3, 5, seed=0)
    raw = rdfind_tpu.discover(triples, 5, strategy=0)
    want = jminimality.minimize_table(raw)
    got = tminimality.minimize_table(CindTable(*(
        raw.dep_code, raw.dep_v1, raw.dep_v2, raw.ref_code, raw.ref_v1,
        raw.ref_v2, raw.support)), "cpu")
    assert len(got) < len(raw)
    assert got.to_rows() == want.to_rows()


def test_projection_subsets_match_jax():
    triples = synth.generate_triples(500, seed=2, n_predicates=5,
                                     n_entities=40)
    for proj in ("s", "po"):
        want = rdfind_tpu.discover(triples, 3, strategy=0, projections=proj)
        got = rdfind_tpu_torch.discover(triples, 3, strategy=0, device="cpu",
                                        projections=proj)
        assert got.to_rows() == want.to_rows()


def test_accepts_handed_over_triples_and_empty_input():
    triples = synth.generate_triples(300, seed=1)
    a = rdfind_tpu_torch.discover(triples, 3, strategy=0, device="cpu")
    b = rdfind_tpu_torch.discover(state.triples_to_device(triples, "cpu"), 3,
                                  strategy=0, device="cpu")
    assert a.to_rows() == b.to_rows()
    empty = rdfind_tpu_torch.discover(np.zeros((0, 3), np.int32), 2,
                                      strategy=0, device="cpu")
    assert len(empty) == 0


def test_too_large_plan_names_the_missing_fallback(monkeypatch):
    monkeypatch.setattr(tcooc, "CPU_M_BUDGET_BYTES", 1024)
    with pytest.raises(tallatonce.DensePlanTooLarge, match="chunked"):
        rdfind_tpu_torch.discover(synth.generate_triples(300, seed=1), 2,
                                  strategy=0, device="cpu")


@pytest.mark.parametrize("strategy", [1, 2, 3])
def test_unported_strategies_raise(strategy):
    with pytest.raises(ValueError, match="not yet ported"):
        rdfind_tpu_torch.discover(synth.generate_triples(100, seed=1), 2,
                                  strategy=strategy, device="cpu")


def test_chunked_backend_is_not_ported():
    with pytest.raises(ValueError, match="not ported"):
        rdfind_tpu_torch.discover(synth.generate_triples(100, seed=1), 2,
                                  strategy=0, device="cpu",
                                  pair_backend="chunked")
