"""The port's program ranges on the CPU: every stretch of a strategy-0 job
falls under a named ``rdfind.*`` profiler range, each nested under its
parent; the range helper is the shared no-op outside a profiler; a JSONL span
and its profiler range share one clock reading; and the benchmark's trace
reader finds the new ranges."""

import ast
import json
from pathlib import Path

import pytest
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile, record_function

import rdfind_tpu_torch
from rdfind_tpu_torch.models import allatonce
from rdfind_tpu_torch.obs import tracer
from rdfind_tpu_torch.utils import synth
from torch_harness import port_module, time_limit  # noqa: F401

PACKAGE = Path(rdfind_tpu_torch.__file__).parent

# Each range of a strategy-0 job and the range it nests under (None: a stage
# of the job itself).
PARENT = {
    "rdfind.upload": None,
    "rdfind.prepare": None,
    "rdfind.prepare.filter": "rdfind.prepare",
    "rdfind.prepare.emit": "rdfind.prepare",
    "rdfind.prepare.intern": "rdfind.prepare",
    "rdfind.prepare.lines": "rdfind.prepare",
    "rdfind.plan": None,
    "rdfind.membership": None,
    "rdfind.membership.scatter": "rdfind.membership",
    "rdfind.membership.counts": "rdfind.membership",
    "rdfind.sweep": None,
    "rdfind.sweep.schedule": "rdfind.sweep",
    "rdfind.sweep.launch": "rdfind.sweep",
    "rdfind.sweep.decode": "rdfind.sweep",
    "rdfind.answer": None,
    "rdfind.postprocess": None,
}
# The job's stages in the order they run.
STAGES = ["rdfind.upload", "rdfind.prepare", "rdfind.plan",
          "rdfind.membership", "rdfind.sweep", "rdfind.answer",
          "rdfind.postprocess"]


@pytest.fixture(scope="module")
def triples():
    return synth.generate_triples(400, seed=7, n_predicates=5,
                                  n_entities=40)


def _host_ranges(prof):
    """(start_ns, end_ns, name) of the host-side rdfind.* ranges."""
    return sorted((e.start_ns(), e.end_ns(), e.name())
                  for e in prof.profiler.kineto_results.events()
                  if e.device_type() == DeviceType.CPU
                  and e.name().startswith("rdfind."))


def _profiled_job(triples, **opts):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with record_function("bench.job"):
            table = rdfind_tpu_torch.discover(triples, 3, strategy=0,
                                              device="cpu", **opts)
    assert len(table) > 0
    return prof


def test_a_dense_job_opens_every_range_under_its_parent(triples):
    ranges = _host_ranges(_profiled_job(triples, pair_backend="matmul"))
    names = {n for _, _, n in ranges}
    assert names == set(PARENT)
    for lo, hi, name in ranges:
        parents = {n for a, b, n in ranges
                   if (a, b, n) != (lo, hi, name) and a <= lo and hi <= b}
        want = PARENT[name]
        assert parents == ({want} if want else set()), name
    # The job's stages run one after another, each once.
    stages = [(lo, hi, n) for lo, hi, n in ranges if PARENT[n] is None]
    assert [n for _, _, n in stages] == STAGES
    assert all(a[1] <= b[0] for a, b in zip(stages, stages[1:]))


def test_the_chunked_backend_names_its_answer(triples):
    names = {n for _, _, n in _host_ranges(
        _profiled_job(triples, pair_backend="chunked"))}
    assert {"rdfind.upload", "rdfind.prepare", "rdfind.prepare.lines",
            "rdfind.chunks", "rdfind.merge", "rdfind.answer",
            "rdfind.postprocess"} <= names


def test_the_range_helper_is_the_shared_noop_outside_a_profiler():
    assert not torch._C._autograd._profiler_enabled()
    assert tracer.profile_range("rdfind.prepare") is tracer._NULL_SPAN
    with profile(activities=[ProfilerActivity.CPU]):
        rng = tracer.profile_range("rdfind.prepare")
        assert rng is not tracer._NULL_SPAN
        with rng:
            pass


def test_no_range_calls_the_profiler_when_none_runs(triples, monkeypatch):
    calls = []

    def counting(name, *a, **k):
        calls.append(name)
        return record_function(name, *a, **k)

    monkeypatch.setattr(torch.profiler, "record_function", counting)
    for backend in ("matmul", "chunked"):
        rdfind_tpu_torch.discover(triples, 3, strategy=0, device="cpu",
                                  pair_backend=backend)
    for strategy in (1, 2, 3):
        rdfind_tpu_torch.discover(triples, 3, strategy=strategy,
                                  device="cpu")
    assert calls == []
    # Under a profiler the same helper does reach it.
    with profile(activities=[ProfilerActivity.CPU]):
        allatonce.triples_on(triples, "cpu")
    assert calls == ["rdfind.upload"]


def test_every_program_range_goes_through_the_helper():
    """No module of the port opens a profiler range itself: only the
    helper in obs/tracer.py names record_function."""
    offenders = []
    for path in sorted(PACKAGE.rglob("*.py")):
        if path == PACKAGE / "obs" / "tracer.py":
            continue
        for node in ast.walk(ast.parse(path.read_text())):
            name = (node.id if isinstance(node, ast.Name)
                    else node.attr if isinstance(node, ast.Attribute)
                    else node.name if isinstance(node, ast.alias) else None)
            if name == "record_function":
                offenders.append(f"{path.relative_to(PACKAGE)}:"
                                 f"{node.lineno}")
    assert offenders == []


def test_a_span_and_its_profiler_range_share_one_clock(tmp_path):
    tracer.start(str(tmp_path))
    try:
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            with tracer.span("discover"):
                pass
    finally:
        tracer.stop()
    (path,) = tmp_path.glob(f"{tracer.EVENTS_PREFIX}*.jsonl")
    events = [json.loads(line) for line in path.read_text().splitlines()]
    b_us = next(e["ts"] for e in events
                if e["name"] == "discover" and e["ph"] == "B")
    e_us = next(e["ts"] for e in events
                if e["name"] == "discover" and e["ph"] == "E")
    (rng,) = [e for e in prof.profiler.kineto_results.events()
              if e.name() == "discover"
              and e.device_type() == DeviceType.CPU]
    assert abs(b_us * 1000 - rng.start_ns()) < 2_000_000
    assert abs(e_us * 1000 - rng.end_ns()) < 2_000_000


def test_the_benchmark_reader_times_the_answer_and_the_sweep(triples):
    from benchmark import tracing

    tr = tracing.read(_profiled_job(triples, pair_backend="matmul"))
    assert tr.window_s > 0
    for name in ("rdfind.answer", "rdfind.sweep", "rdfind.upload",
                 "rdfind.plan"):
        assert tr.range_s(name) > 0, name
    assert tr.range_s("rdfind.sweep") >= tr.range_s(
        "rdfind.sweep.schedule", "rdfind.sweep.launch", "rdfind.sweep.decode")
    assert tr.range_s("rdfind.membership") >= tr.range_s(
        "rdfind.membership.scatter", "rdfind.membership.counts") > 0
