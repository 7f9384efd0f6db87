"""The port's sharded strategies against the JAX package, on the CPU.

The four sharded strategies run on gloo rank groups of 2, 4 and 8 (one launch
per group, several cases each; the rank side is
``torch_rank_cases.sharded_cases``).  Every CIND table (``to_rows()``) and
output digest must equal the JAX package's single-device twin on the same
triples (``allatonce``, ``small_to_large``, ``approximate``, ``late_bb``:
JAX's own tests hold those equal to its ``discover_sharded*``), also where the
ladder falls back to one device.  On one workload per strategy the planned
capacities, the skew, sketch, lattice, round and half-approximate statistics
and the exchange ledger's bytes per site must equal the JAX package's
``discover_sharded*`` at 4 devices (strategy 0 also at 8).  The 8-rank group
also runs the twin of the JAX package's ``__graft_entry__.dryrun_multichip``
strategy-0 part, held against the port's oracle, and the rank side of the
port's own ``entry.dryrun_multichip``, checked by ``entry.check_dryrun``.
Tolerance: exact equality throughout.
"""

import numpy as np
import pytest

import torch_rank_cases
from rdfind_tpu.models import allatonce as jallatonce
from rdfind_tpu.models import approximate as japproximate
from rdfind_tpu.models import late_bb as jlate_bb
from rdfind_tpu.models import sharded as jsharded
from rdfind_tpu.models import small_to_large as jsmall_to_large
from rdfind_tpu.obs import integrity as jintegrity
from rdfind_tpu.parallel.mesh import make_mesh
from rdfind_tpu_torch import entry
from rdfind_tpu_torch import oracle as toracle
from rdfind_tpu_torch.parallel import launch
from rdfind_tpu_torch.utils import synth
from torch_harness import port_module, time_limit  # noqa: F401

# A rank group launches in whichever test first needs one of its cases.
pytestmark = pytest.mark.time_limit(400)


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


def _tiny():
    return np.asarray(synth.generate_triples(60, seed=7, n_predicates=4,
                                             n_entities=16), np.int32)


EMPTY = np.zeros((0, 3), np.int32)
BUDGET64 = {"RDFIND_PAIR_ROW_BUDGET": "64"}
HA = {"RDFIND_SHARDED_HALF_APPROX": "1"}
# The 2-host factorization (2, 2) of a 4-rank mesh, and the flat exchange
# attributed to the same two hosts.
HIER = {"RDFIND_HIER_EXCHANGE": "1", "RDFIND_HIER_HOSTS": "2"}
FLAT2 = {"RDFIND_HIER_EXCHANGE": "0", "RDFIND_HIER_HOSTS": "2"}
# Every pass of the verification overflows: with one try per pass and no
# split the ladder falls back to the single-device twin at once.
FALLBACK = {"RDFIND_FAULTS": "overflow@cooc:times=-1",
            "RDFIND_MAX_PASS_SPLITS": "0", "RDFIND_BACKOFF_BASE_MS": "1"}


def _s(strategy, **kw):
    """kwargs of a strategy 1-3 case (use_fis explicit: the sharded and the
    single-device strategy 1 default it differently)."""
    return dict(strategy=strategy, use_fis=kw.pop("use_fis", False), **kw)


# name -> (world, triples, support, kwargs, env).  Every case's table is
# checked against JAX; "stats4"/"stats8" and "s{1,2,3}stats4"/"s1ha_stats4"
# also against JAX's discover_sharded*.
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
    # entry.dryrun_multichip's rank side: its five checks in this launch.
    "dryrun_multichip": (8, _hot, 2, dict(dryrun=True), {}),
    "stats8": (8, _hot, 2, dict(use_fis=True), {}),
    # Strategies 1-3 (SmallToLarge, Approximate, LateBB).
    "s1_projection_so": ("2s", _plain, 3, _s(1, projections="so"), {}),
    "s2_projection_p": ("2s", _plain, 3, _s(2, projections="p"), {}),
    "s3_projection_po": ("2s", _plain, 3, _s(3, projections="po"), {}),
    "s1_empty": ("2s", lambda: EMPTY, 2, _s(1), {}),
    "s1_clean_implied": ("2s", _plain, 3, _s(1, clean_implied=True), {}),
    "s2_clean_implied": ("2s", _plain, 3, _s(2, clean_implied=True), {}),
    "s3_clean_implied": ("2s", _plain, 3, _s(3, clean_implied=True), {}),
    "s1_fallback": ("2s", _small, 2, _s(1, max_retries=1), FALLBACK),
    "s2_fallback": ("2s", _small, 2, _s(2, max_retries=1), FALLBACK),
    "s3_fallback": ("2s", _small, 2, _s(3, max_retries=1), FALLBACK),
    "s1_fis_ars": ("4s", _plain, 3, _s(1, use_fis=True, use_ars=True), {}),
    "s2_fis_ars": ("4s", _plain, 3, _s(2, use_fis=True, use_ars=True), {}),
    "s3_fis_ars": ("4s", _plain, 3, _s(3, use_fis=True, use_ars=True), {}),
    "s1_hot": ("4s", _hot, 2, _s(1), {}),
    "s2_hot": ("4s", _hot, 2, _s(2), {}),
    "s1_budget64": ("4s", _tiny, 2, _s(1), BUDGET64),
    "s2_budget64": ("4s", _tiny, 2, _s(2), BUDGET64),
    "s3_budget64": ("4s", _tiny, 2, _s(3), BUDGET64),
    "s1_ha": ("4s", _hot, 2, _s(1), HA),
    "s2_ha": ("4s", _hot, 2, _s(2), HA),
    "s1_ha_hier": ("4s", _hot, 2, _s(1), {**HA, **HIER}),
    "s1_ha_flat2": ("4s", _hot, 2, _s(1), {**HA, **FLAT2}),
    "s1_flat_hier": ("4s", _hot, 2, _s(1), HIER),
    "s1stats4": ("4s", _hot, 2, _s(1, use_fis=True), {}),
    "s2stats4": ("4s", _hot, 2, _s(2, use_fis=True), {}),
    "s3stats4": ("4s", _hot, 2, _s(3, use_fis=True), {}),
    "s1ha_stats4": ("4s", _hot, 2, _s(1, use_fis=True), HA),
    "s1_eight": ("8s", _plain, 3, _s(1), {}),
    "s2_eight": ("8s", _hot, 2, _s(2, use_fis=True), {}),
    "s3_eight": ("8s", _hot, 2, _s(3), {}),
}
STATS = ("planned_caps", "n_giant_lines", "n_giant_pairs", "n_pair_passes",
         "rebalance")
# The statistics of strategies 1-3 held against JAX's discover_sharded_*.
S123_STATS = STATS + tuple(
    k for k in torch_rank_cases.SUMMARY_STATS
    if k not in STATS + ("dist_backend", "staged", "degradations"))
TWINS = {0: jallatonce.discover, 1: jsmall_to_large.discover,
         2: japproximate.discover, 3: jlate_bb.discover}
JAX_SHARDED = {1: jsharded.discover_sharded_s2l,
               2: jsharded.discover_sharded_approx,
               3: jsharded.discover_sharded_late_bb}


def _jax_kwargs(kwargs):
    kw = {k: v for k, v in kwargs.items() if k != "minimize"}
    out = dict(projections=kw.pop("projections", "spo"),
               use_frequent_condition_filter=kw.pop("use_fis", False),
               use_association_rules=kw.pop("use_ars", False),
               clean_implied=kw.pop("clean_implied", False))
    return out


def _world(group) -> int:
    """A case's launch group: its rank count, with a suffix for a second
    group of that size (the groups launch in parallel under xdist)."""
    return int(str(group).rstrip("s"))


def _port_results(group):
    cases = [(name, f(), s, kw, env)
             for name, (g, f, s, kw, env) in CASES.items() if g == group]
    return launch.spawn(torch_rank_cases.sharded_cases, _world(group),
                        args=(cases,), device="cpu", timeout_s=360)


@pytest.fixture(scope="module")
def port(tmp_path_factory):
    """Case name -> the port's result, one launch per rank group, each
    launched the first time a test needs one of its cases."""
    cache = {}

    class Results(dict):
        def __missing__(self, name):
            group = CASES[name][0]
            if group not in cache:
                cache[group] = torch_rank_cases.shared_result(
                    tmp_path_factory, f"torch_sharded_{group}",
                    lambda: _port_results(group))
            return cache[group][name]

    return Results()


def _jax_table(name):
    _, f, support, kwargs, _ = CASES[name]
    t = f()
    if t.shape[0] == 0:
        return set(), None
    table = TWINS[kwargs.get("strategy", 0)](t, support, **_jax_kwargs(kwargs))
    return (table.to_rows(),
            jintegrity.digest_hex(*jintegrity.digest_table(table)))


def _jax_stats(world):
    _, f, support, kwargs, _ = CASES[f"stats{world}"]
    stats = {}
    jsharded.discover_sharded(f(), support, mesh=make_mesh(world),
                              stats=stats, use_fis=kwargs["use_fis"])
    return ({k: stats[k] for k in STATS},
            {k: v["bytes"] for k, v in stats["exchange_sites"].items()})


@pytest.mark.parametrize("case", sorted(set(CASES) - {"dryrun_multichip"}))
def test_discover_sharded_equals_jax(port, case):
    rows, digest = _jax_table(case)
    got = port[case]
    assert got["rows"] == rows
    if rows:
        assert got["digest"] == digest
    if not case.endswith("empty"):
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


@pytest.mark.parametrize("strategy", [1, 2, 3])
def test_s123_plan_sketch_and_ledger_equal_jax(port, strategy):
    """Strategies 1-3 at 4 ranks: the plan, skew, sketch, lattice and round
    statistics and the ledger's bytes per site are JAX's discover_sharded_*
    at 4 devices."""
    _, f, support, kwargs, _ = CASES[f"s{strategy}stats4"]
    stats = {}
    JAX_SHARDED[strategy](f(), support, mesh=make_mesh(4), stats=stats,
                          use_fis=kwargs["use_fis"])
    got = port[f"s{strategy}stats4"]
    assert {k: got["stats"].get(k) for k in S123_STATS} == \
        {k: stats.get(k) for k in S123_STATS}
    assert got["ledger"] == {k: v["bytes"]
                             for k, v in stats["exchange_sites"].items()}
    assert got["stats"]["n_giant_lines"] > 0
    if strategy > 1:
        assert got["stats"]["n_sketch_candidates"] > 0


def test_half_approx_stats_equal_jax(port, monkeypatch):
    """The half-approximate round of strategy 1 at 4 ranks: its ha_*
    statistics and the sketch_allreduce site's bytes are JAX's."""
    monkeypatch.setenv("RDFIND_SHARDED_HALF_APPROX", "1")
    _, f, support, kwargs, _ = CASES["s1ha_stats4"]
    stats = {}
    jsharded.discover_sharded_s2l(f(), support, mesh=make_mesh(4),
                                  stats=stats, use_fis=True)
    got = port["s1ha_stats4"]
    assert {k: got["stats"].get(k) for k in S123_STATS} == \
        {k: stats.get(k) for k in S123_STATS}
    assert got["ledger"] == {k: v["bytes"]
                             for k, v in stats["exchange_sites"].items()}
    assert got["stats"]["ha_cut_pairs"] > 0
    assert got["stats"]["ha_build_rounds"] == 4  # one per lattice level


@pytest.mark.parametrize("on,off", [("s1_ha", "s1_hot"),
                                    ("s2_ha", "s2_hot"),
                                    ("s1_ha_hier", "s1_hot")])
def test_half_approx_is_bit_identical(port, on, off):
    """The knob changes no output bit (strategies 1 and 2, flat and
    hierarchical), while its cut really drops pairs."""
    assert port[on]["rows"] == port[off]["rows"]
    assert port[on]["digest"] == port[off]["digest"]
    assert port[on]["stats"]["ha_cut_pairs"] > 0
    assert "ha_cut_pairs" not in port[off]["stats"]
    assert "sketch_allreduce" not in port[off]["ledger"]


def test_hier_sketch_reduce_splits_dcn_bytes(port):
    """At the (2, 2) factorization the hierarchical sketch reduce moves the
    flat all-reduce's ICI bytes and half its DCN bytes (one pre-reduced table
    per host crosses instead of one per rank: d=4, local=2, flat DCN =
    d*(d-local)*B, hierarchical d*(hosts-1)*B)."""
    hier = port["s1_ha_hier"]["ledger_split"]["sketch_allreduce"]
    flat = port["s1_ha_flat2"]["ledger_split"]["sketch_allreduce"]
    assert port["s1_ha_flat2"]["rows"] == port["s1_hot"]["rows"]
    assert hier[0] == flat[0]
    assert hier[1] * 2 == flat[1] > 0
    assert port["s1_flat_hier"]["rows"] == port["s1_hot"]["rows"]


@pytest.mark.parametrize("strategy,kind", [(1, "small_to_large"),
                                           (2, "approximate"),
                                           (3, "late_bb")])
def test_exhausted_caps_fall_back_to_the_single_device_twin(port, strategy,
                                                           kind):
    got = port[f"s{strategy}_fallback"]
    fell = [d for d in got["stats"]["degradations"]
            if d.get("action") == "fallback"]
    assert fell and fell[0]["strategy"] == kind
    assert got["rows"]  # and equal to the twin: test_discover_sharded_...


def test_s123_skew_cases_really_split(port):
    assert port["s1_hot"]["stats"]["n_giant_lines"] >= 1
    for s in (1, 2, 3):
        assert port[f"s{s}_budget64"]["stats"]["n_pair_passes"] > 1


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


def test_dryrun_multichip_on_eight_ranks(port):
    """The port's entry.dryrun_multichip on the eight-rank group: its checks
    (strategy 0 in several passes and Approximate against the definitional
    oracle, sharded minimality against its minimal set, SmallToLarge with the
    distributed filter and LateBB against their single-device runs), and
    each table equal to the JAX package's single-device twin."""
    t = _hot()
    got = port["dryrun_multichip"]
    entry.check_dryrun(t, got)
    np.testing.assert_array_equal(t, entry.dryrun_triples())
    assert got["allatonce"] == got["approx"] == port["dryrun_twin"]["rows"]
    assert got["minimized"] == port["dryrun_twin"]["minimized"]
    assert got["s2l"] == jsmall_to_large.discover(t, 2).to_rows()
    assert got["late_bb"] == jlate_bb.discover(t, 2).to_rows()


def test_minimize_table_sharded_equals_oracle(port):
    """minimize_table_sharded on a 2-rank mesh: the oracle's minimal set,
    and the table discover_sharded(clean_implied=True) returns."""
    got = port["no_combine"]
    assert got["minimized"] == toracle.minimize_cinds(got["rows"])
    assert got["minimized"] == port["clean_implied"]["rows"]
