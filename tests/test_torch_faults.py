"""The port's fault plane against the JAX package's, on the CPU: the fault plan
and its sites, guarded pulls, and the chunk loop under an injected host-pull
failure and under the serial schedule (RDFIND_SYNC_PASSES)."""

import dataclasses

import pytest

import rdfind_tpu
import rdfind_tpu_torch
from rdfind_tpu.runtime import faults as jfaults
from rdfind_tpu_torch.obs import metrics as tmetrics
from rdfind_tpu_torch.runtime import dispatch as tdispatch
from rdfind_tpu_torch.runtime import faults as tfaults
from rdfind_tpu_torch.utils import synth
from torch_harness import port_module, time_limit  # noqa: F401


@pytest.fixture(autouse=True)
def _fresh_plans(monkeypatch):
    """Every test starts and ends with no cached fault plan, fast backoff."""
    monkeypatch.setenv("RDFIND_BACKOFF_BASE_MS", "1")
    tfaults.reset()
    jfaults.reset()
    yield
    tfaults.reset()
    jfaults.reset()


def test_sites_match_jax():
    assert tfaults.SITES == jfaults.SITES
    assert "host_pull" in tfaults.SITES and "checkpoint_write" in tfaults.SITES


SPECS = ["host_pull", "host_pull:nth=2", "overflow@cind:pass=2:times=-1",
         "checkpoint_write;host_pull:nth=3:times=2",
         "flip@host_pull:p=0.5", "preempt@discover:pass=0;overflow@cooc:nth=2"]


@pytest.mark.parametrize("spec", SPECS)
def test_plan_parser_and_firing_match_jax(spec):
    got = tfaults.FaultPlan(spec, seed=3)
    want = jfaults.FaultPlan(spec, seed=3)
    assert [dataclasses.asdict(s) for s in got.specs] == \
        [dataclasses.asdict(s) for s in want.specs]
    for i in range(12):
        for site in tfaults.SITES[:10]:
            p = i % 4
            assert got.fires(site, p) == want.fires(site, p), (site, i)


@pytest.mark.parametrize("bad", ["nosuchsite", "host_pull:nth=0",
                                 "host_pull:when=3"])
def test_bad_plans_raise_like_jax(bad):
    with pytest.raises(ValueError):
        jfaults.FaultPlan(bad)
    with pytest.raises(ValueError):
        tfaults.FaultPlan(bad)


def test_guarded_pull_retries_then_returns(monkeypatch):
    monkeypatch.setenv("RDFIND_FAULTS", "host_pull:times=2")
    base = tfaults.pull_stats()
    calls = []
    assert tfaults.guarded_pull(lambda: calls.append(1) or 42) == 42
    assert calls == [1]  # the faults fire before the pull: two re-runs
    now = tfaults.pull_stats()
    assert now["n_host_pull_retries"] - base["n_host_pull_retries"] == 2
    assert now["backoff_ms_total"] > base["backoff_ms_total"]


def test_guarded_pull_gives_up_after_its_retries(monkeypatch):
    monkeypatch.setenv("RDFIND_FAULTS", "host_pull:times=-1")
    monkeypatch.setenv("RDFIND_PULL_RETRIES", "2")
    with pytest.raises(tfaults.InjectedFault):
        tfaults.guarded_pull(lambda: 1)


def test_strict_mode_fails_fast(monkeypatch):
    monkeypatch.setenv("RDFIND_FAULTS", "host_pull")
    monkeypatch.setenv("RDFIND_STRICT", "1")
    base = tfaults.pull_stats()
    with pytest.raises(tfaults.InjectedFault, match="host_pull"):
        tfaults.guarded_pull(lambda: 1)
    assert tfaults.pull_stats() == base


def test_control_flow_faults_pass_through(monkeypatch):
    def preempt():
        raise tfaults.Preempted("now")

    monkeypatch.setenv("RDFIND_FAULTS", "")
    base = tfaults.pull_stats()
    with pytest.raises(tfaults.Preempted):
        tfaults.guarded_pull(preempt)
    assert tfaults.pull_stats() == base


def test_degradation_ledger_matches_jax():
    from rdfind_tpu.obs import metrics as jmetrics

    got, want = {}, {}
    for mod, stats in ((tfaults, got), (jfaults, want)):
        mod.record_degradation(stats, "cind", "grow", caps=2)
        mod.record_degradation(stats, "cind", "split", n_pass=4)
    assert got == want
    assert got["ladder_rung"] == {"cind": "split"}
    tmetrics.reset()
    jmetrics.reset()


TRIPLES = synth.generate_triples(900, seed=7, n_predicates=7, n_entities=70)
# (strategy, extra discover kwargs): strategy 1's chunked walk, strategy 0
# forced onto the chunk loop, strategy 2's chunked verification.
CHUNKED = [(1, dict(pair_backend="chunked")),
           (0, dict(pair_backend="chunked")),
           (2, dict(pair_backend="chunked"))]


def _run(strategy, kw, stats=None):
    return rdfind_tpu_torch.discover(TRIPLES, 3, strategy=strategy,
                                     device="cpu", pair_chunk_budget=1 << 11,
                                     stats=stats, **kw)


@pytest.mark.parametrize("strategy,kw", CHUNKED[:2])
def test_chunk_loop_retries_an_injected_host_pull(strategy, kw, monkeypatch):
    clean_stats = {}
    clean = _run(strategy, kw, clean_stats)
    assert clean_stats["n_pair_chunks"] > 3
    assert "n_host_pull_retries" not in clean_stats
    monkeypatch.setenv("RDFIND_FAULTS", "host_pull:nth=2")
    stats = {}
    got = _run(strategy, kw, stats)
    assert got.to_rows() == clean.to_rows()
    assert stats["n_host_pull_retries"] == 1
    assert stats["backoff_ms_total"] > 0
    assert stats["n_pair_chunks"] == clean_stats["n_pair_chunks"]
    want = rdfind_tpu.discover(TRIPLES, 3, strategy=strategy, **kw)
    assert got.to_rows() == want.to_rows()


def test_chunk_loop_fails_when_every_pull_fails(monkeypatch):
    monkeypatch.setenv("RDFIND_FAULTS", "host_pull:times=-1")
    with pytest.raises(tfaults.InjectedFault):
        _run(*CHUNKED[0])


@pytest.mark.parametrize("strategy,kw", CHUNKED)
def test_serial_schedule_is_bit_identical(strategy, kw, monkeypatch):
    pipelined_stats = {}
    pipelined = _run(strategy, kw, pipelined_stats)
    monkeypatch.setenv("RDFIND_SYNC_PASSES", "1")
    assert tdispatch.sync_passes_forced() and tdispatch.pass_depth() == 1
    stats = {}
    got = _run(strategy, kw, stats)
    assert len(got) > 0 and got.to_rows() == pipelined.to_rows()
    assert stats["n_pair_chunks"] == pipelined_stats["n_pair_chunks"] > 3
    monkeypatch.setenv("RDFIND_SYNC_PASSES", "0")
    assert not tdispatch.sync_passes_forced() and tdispatch.pass_depth() == 2


def test_serial_schedule_pulls_each_chunk_before_the_next(monkeypatch):
    """Under RDFIND_SYNC_PASSES the loop pulls chunk i before it stages chunk
    i + 1; the pipelined loop stages chunk i + 1 first."""
    from rdfind_tpu_torch.models import allatonce

    order = []
    stage, pull = allatonce.dispatch.stage_to_host, allatonce._pull_chunk
    monkeypatch.setattr(allatonce.dispatch, "stage_to_host",
                        lambda c: order.append("stage") or stage(c))
    monkeypatch.setattr(allatonce, "_pull_chunk",
                        lambda s: order.append("pull") or pull(s))
    for sync, want in (("1", ["stage", "pull"] * 3),
                       ("0", ["stage", "stage", "pull", "stage", "pull"])):
        monkeypatch.setenv("RDFIND_SYNC_PASSES", sync)
        order.clear()
        _run(0, dict(pair_backend="chunked"))
        assert order[:len(want)] == want, sync


def test_dispatch_stats_publish_like_jax(monkeypatch):
    from rdfind_tpu.obs import metrics as jmetrics
    from rdfind_tpu.runtime import dispatch as jdispatch

    got, want = {}, {}
    for mod, stats in ((tdispatch, got), (jdispatch, want)):
        ds = mod.DispatchStats(pull_base={"n_host_pull_retries": 0,
                                          "backoff_ms_total": 0.0})
        ds.saw_in_flight(2)
        ds.pulled(0.004, overlapped=True)
        ds.pulled(0.002, overlapped=False)
        ds.publish(stats)
        stats["overlap"] = ds.overlap_report(10.0, n_passes=2)
    assert got.keys() == want.keys()
    for k in got:
        if k not in ("n_host_pull_retries", "backoff_ms_total"):
            assert got[k] == want[k], k
    tmetrics.reset()
    jmetrics.reset()
