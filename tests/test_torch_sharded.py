"""The port's sharded AllAtOnce pipeline against the JAX package, on the CPU.

``discover_sharded`` runs on gloo rank groups of 2, 4 and 8 (one launch per
group, several cases each; the rank side is ``torch_rank_cases.sharded_cases``).
Its CIND table (``to_rows()``) and output digest must equal the JAX package's
single-device ``allatonce.discover`` on the same triples (JAX's own tests hold
that equal to its ``discover_sharded``).  On one workload the planned
capacities, the skew statistics, the pass count and the exchange ledger's
bytes per site must equal the JAX package's ``discover_sharded`` at 4 and at 8
devices.  The 8-rank group also runs the twin of the JAX package's
``__graft_entry__.dryrun_multichip`` strategy-0 part, held against the port's
oracle.  Tolerance: exact equality throughout.
"""

import jax
import numpy as np
import pytest

import torch_rank_cases
from rdfind_tpu.models import allatonce as jallatonce
from rdfind_tpu.models import sharded as jsharded
from rdfind_tpu.obs import integrity as jintegrity
from rdfind_tpu.parallel.mesh import make_mesh
from rdfind_tpu_torch import oracle as toracle
from rdfind_tpu_torch.parallel import launch
from rdfind_tpu_torch.utils import synth


@pytest.fixture(autouse=True, scope="module")
def _release_jax_programs():
    """Drop the XLA programs compiled in and before this module (each keeps
    executable mappings; a test process has a per-process map limit)."""
    jax.clear_caches()
    yield
    jax.clear_caches()


def _plain():
    return np.asarray(synth.generate_triples(400, seed=11, n_predicates=7,
                                             n_entities=40), np.int32)


def _hot():
    """The dryrun workload: a grafted hot object value makes giant lines."""
    t = np.asarray(synth.generate_triples(200, seed=3, n_predicates=6,
                                          n_entities=24), np.int32)
    hot = np.stack([np.arange(100, 140, dtype=np.int32),
                    np.arange(40, dtype=np.int32) % 4 + 500,
                    np.full(40, 999, dtype=np.int32)], axis=1)
    return np.concatenate([t, hot])


def _small():
    return np.asarray(synth.generate_triples(150, seed=7, n_predicates=5,
                                             n_entities=30), np.int32)


EMPTY = np.zeros((0, 3), np.int32)
BUDGET64 = {"RDFIND_PAIR_ROW_BUDGET": "64"}

# name -> (world, triples, support, kwargs, env).  Every case's table is
# checked against JAX; "stats4"/"stats8" also against JAX discover_sharded.
CASES = {
    "projection_so": (2, _plain, 3, dict(projections="so"), {}),
    "projection_p": (2, _plain, 3, dict(projections="p"), {}),
    "empty": (2, lambda: EMPTY, 2, {}, {}),
    "no_combine": (2, _plain, 3, dict(combine=False, minimize=True), {}),
    "clean_implied": (2, _plain, 3, dict(clean_implied=True), {}),
    "fis_ars": (4, _plain, 3, dict(use_fis=True, use_ars=True), {}),
    "hot_giant_split": (4, _hot, 2, {}, {}),
    "range_slice_max_load": (4, _hot, 2, dict(skew=dict(strategy=2,
                                                        max_load=500.0)),
                             {}),
    "multipass_budget64": (4, _small, 2, {}, BUDGET64),
    "stats4": (4, _hot, 2, dict(use_fis=True), {}),
    "dryrun_twin": (8, _hot, 2, dict(minimize=True), BUDGET64),
    "stats8": (8, _hot, 2, dict(use_fis=True), {}),
}
STATS = ("planned_caps", "n_giant_lines", "n_giant_pairs", "n_pair_passes",
         "rebalance")


def _jax_kwargs(kwargs):
    kw = {k: v for k, v in kwargs.items() if k != "minimize"}
    out = dict(projections=kw.pop("projections", "spo"),
               use_frequent_condition_filter=kw.pop("use_fis", False),
               use_association_rules=kw.pop("use_ars", False),
               clean_implied=kw.pop("clean_implied", False))
    return out


def _port_results(world):
    cases = [(name, f(), s, kw, env)
             for name, (w, f, s, kw, env) in CASES.items() if w == world]
    return launch.spawn(torch_rank_cases.sharded_cases, world, args=(cases,),
                        device="cpu")


@pytest.fixture(scope="module")
def port(tmp_path_factory):
    """Case name -> the port's result, one launch per rank group, each
    launched the first time a test needs one of its cases."""
    cache = {}

    class Results(dict):
        def __missing__(self, name):
            world = CASES[name][0]
            if world not in cache:
                cache[world] = torch_rank_cases.shared_result(
                    tmp_path_factory, f"torch_sharded_{world}",
                    lambda: _port_results(world))
            return cache[world][name]

    return Results()


def _jax_table(name):
    _, f, support, kwargs, _ = CASES[name]
    t = f()
    if t.shape[0] == 0:
        return set(), None
    table = jallatonce.discover(t, support, **_jax_kwargs(kwargs))
    return (table.to_rows(),
            jintegrity.digest_hex(*jintegrity.digest_table(table)))


def _jax_stats(world):
    _, f, support, kwargs, _ = CASES[f"stats{world}"]
    stats = {}
    jsharded.discover_sharded(f(), support, mesh=make_mesh(world),
                              stats=stats, use_fis=kwargs["use_fis"])
    return ({k: stats[k] for k in STATS},
            {k: v["bytes"] for k, v in stats["exchange_sites"].items()})


@pytest.mark.parametrize("case", sorted(CASES))
def test_discover_sharded_equals_jax(port, case):
    rows, digest = _jax_table(case)
    got = port[case]
    assert got["rows"] == rows
    if rows:
        assert got["digest"] == digest
    if case != "empty":
        assert got["stats"]["dist_backend"] == "gloo"
        assert got["stats"]["staged"] == 0


@pytest.mark.parametrize("world", [4, 8])
def test_plan_skew_and_ledger_equal_jax_discover_sharded(port, world):
    want_stats, want_ledger = _jax_stats(world)
    got = port[f"stats{world}"]
    assert {k: got["stats"][k] for k in STATS} == want_stats
    assert got["ledger"] == want_ledger
    assert got["stats"]["n_giant_lines"] > 0  # the split path really ran


def test_skew_cases_really_split(port):
    assert port["hot_giant_split"]["stats"]["n_giant_lines"] >= 1
    assert port["range_slice_max_load"]["stats"]["n_giant_lines"] >= 1
    assert port["multipass_budget64"]["stats"]["n_pair_passes"] > 1


def test_dryrun_twin_on_eight_ranks(port):
    """The strategy-0 part of the JAX package's dryrun_multichip(8), on the
    port: multi-pass streaming, the port's definitional oracle, sharded
    minimality against oracle.minimize_cinds."""
    t = _hot()
    got = port["dryrun_twin"]
    assert got["stats"]["n_pair_passes"] > 1
    want = {tuple(int(x) for x in c) for c in
            toracle.discover_cinds_definitional(
                [tuple(int(x) for x in row) for row in t], 2)}
    assert got["rows"] == want
    assert got["minimized"] == toracle.minimize_cinds(got["rows"])


def test_minimize_table_sharded_equals_oracle(port):
    """minimize_table_sharded on a 2-rank mesh: the oracle's minimal set,
    and the table discover_sharded(clean_implied=True) returns."""
    got = port["no_combine"]
    assert got["minimized"] == toracle.minimize_cinds(got["rows"])
    assert got["minimized"] == port["clean_implied"]["rows"]
