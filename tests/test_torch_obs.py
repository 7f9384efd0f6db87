"""The port's observability plane against the JAX package's, on the CPU: the
span tree and the Prometheus exposition of a CLI run with ``--trace`` and
``--metrics-file``, histograms, the flight recorder, heartbeats, the data plane's
histograms and the memory watermark record."""

import contextlib
import io
import json
import os

import numpy as np
import pytest

import rdfind_tpu
import rdfind_tpu_torch
from rdfind_tpu.obs import datastats as jdatastats
from rdfind_tpu.obs import forecast as jforecast
from rdfind_tpu.obs import heartbeat as jheartbeat
from rdfind_tpu.obs import memory as jmemory
from rdfind_tpu.obs import metrics as jmetrics
from rdfind_tpu.obs import report as jreport
from rdfind_tpu.programs import rdfind as jcli
from rdfind_tpu_torch.obs import datastats as tdatastats
from rdfind_tpu_torch.obs import flightrec as tflightrec
from rdfind_tpu_torch.obs import forecast as tforecast
from rdfind_tpu_torch.obs import heartbeat as theartbeat
from rdfind_tpu_torch.obs import memory as tmemory
from rdfind_tpu_torch.obs import metrics as tmetrics
from rdfind_tpu_torch.obs import report as treport
from rdfind_tpu_torch.obs import tracer as ttracer
from rdfind_tpu_torch.programs import rdfind as tcli
from rdfind_tpu_torch.runtime import faults as tfaults
from rdfind_tpu_torch.utils import synth
from torch_harness import port_module, time_limit  # noqa: F401


@pytest.fixture(scope="module")
def nt_file(tmp_path_factory):
    path = tmp_path_factory.mktemp("nt") / "data.nt"
    t = synth.generate_triples(500, seed=4, n_predicates=6, n_entities=50)
    path.write_text("".join(f"<e{s}> <e{p}> <e{o}> .\n" for s, p, o in t))
    return str(path)


# Registry keys one package exports and the other does not: the JAX package's
# TPU plane-width and fused-verdict gauges (the port's K1 has one mode, which
# its kernel_resolution record states), its watchdog record, and the port's
# block-skip records (its dense sweep always runs the block-skip schedule).
JAX_ONLY = {"rdfind_plane_bits", "rdfind_fuse_verdict", "rdfind_watchdog"}
PORT_ONLY = {"rdfind_n_blocks_skipped", "rdfind_datastats_block_skip"}
# Deterministic counters that both packages export: equal values.
DETERMINISTIC = ("n_triples", "n_captures", "n_lines", "n_line_rows",
                 "n_frequent_rows", "max_line", "total_pairs", "n_cinds_11",
                 "n_cinds_12", "n_cinds_21", "n_cinds_22", "n_inferred_21",
                 "n_proper_overlaps", "pairs_11", "n_sketch_candidates",
                 "n_round1_candidates", "n_round2_candidates",
                 "integrity_verified")


def run_cli(cli, metrics_mod, argv):
    """One in-process CLI run with a fresh registry; returns its stderr."""
    metrics_mod.reset()
    err = io.StringIO()
    with contextlib.redirect_stderr(err):
        assert cli.main(argv) == 0
    return err.getvalue()


@pytest.fixture(scope="module", params=["0", "1", "2", "3"])
def traced_runs(request, nt_file, tmp_path_factory):
    """Both CLIs on the fixture file with --trace and --metrics-file, per
    strategy: {"jax"|"torch": directory of trace/, metrics.prom, out.txt}."""
    out = {}
    for tag, cli, mod, extra in (("jax", jcli, jmetrics, []),
                                 ("torch", tcli, tmetrics,
                                  ["--device", "cpu"])):
        d = tmp_path_factory.mktemp(f"{tag}{request.param}")
        run_cli(cli, mod, [nt_file, "--support", "3", "--traversal-strategy",
                           request.param, "--trace", str(d / "trace"),
                           "--metrics-file", str(d / "metrics.prom"),
                           "--output", str(d / "out.txt"), *extra])
        out[tag] = d
    return out


def stage_spans(trace_dir):
    events = treport.load_events(os.path.join(trace_dir,
                                              "events-host0.jsonl"))
    roots, unclosed = treport.build_span_tree(events)
    assert not unclosed
    assert [r["name"] for r in roots] == ["run"]
    return [(n["name"], p["name"] if p else None)
            for n, p in treport.walk_spans(roots)]


def prom_samples(path):
    """{metric name: {labels: value}} of a Prometheus text file."""
    out = {}
    for line in open(path):
        if line.startswith("#") or not line.strip():
            continue
        key, value = line.rsplit(" ", 1)
        name, _, labels = key.partition("{")
        out.setdefault(name, {})[labels] = float(value)
    return out


def test_cli_span_tree_matches_jax(traced_runs):
    got = stage_spans(traced_runs["torch"] / "trace")
    want = stage_spans(traced_runs["jax"] / "trace")
    assert got == want
    names = [n for n, _ in got]
    assert {"read+parse", "discover", "write-output",
            "write-certificate"} <= set(names)
    assert (traced_runs["torch"] / "out.txt").read_bytes() == \
        (traced_runs["jax"] / "out.txt").read_bytes()


def test_chrome_trace_export_loads(traced_runs):
    trace = json.load(open(traced_runs["torch"] / "trace" / "trace.json"))
    events = trace["traceEvents"]
    assert events[0] == {"name": "process_name", "ph": "M", "pid": 0,
                         "tid": 0, "args": {"name": "host 0"}}
    begins = [e for e in events if e.get("ph") == "B"]
    assert min(e["ts"] for e in begins) >= 0
    assert len(begins) == len([e for e in events if e.get("ph") == "E"])
    assert os.path.exists(traced_runs["torch"] / "trace" /
                          "heartbeat-host0.json")


def test_prometheus_names_and_counters_match_jax(traced_runs):
    got = prom_samples(traced_runs["torch"] / "metrics.prom")
    want = prom_samples(traced_runs["jax"] / "metrics.prom")
    assert all(n.startswith("rdfind_") for n in got)
    assert set(got) - set(want) <= PORT_ONLY
    assert set(want) - set(got) <= JAX_ONLY
    assert "rdfind_stage_discover_ms_count" in got
    shared = [k for k in DETERMINISTIC if f"rdfind_{k}" in want]
    assert "total_pairs" in shared
    for key in shared:
        assert got[f"rdfind_{key}"] == want[f"rdfind_{key}"], key
    for group in ("rdfind_datastats_lines", "rdfind_datastats_captures"):
        assert got[group] == want[group], group


def test_report_main_exports_the_trace(traced_runs, tmp_path, capsys):
    out = tmp_path / "merged.json"
    assert treport.main([str(traced_runs["torch"] / "trace"), "-o",
                         str(out)]) == 0
    assert "1 host lane(s)" in capsys.readouterr().out
    assert json.load(open(out))["displayTimeUnit"] == "ms"
    assert treport.main([str(tmp_path)]) == 1


def test_tracer_writes_begin_and_end_events(tmp_path):
    d = str(tmp_path / "t")
    ttracer.start(d)
    try:
        with ttracer.span("stage-a", cat=ttracer.CAT_STAGE):
            with ttracer.span("pass-0", cat=ttracer.CAT_PASS, **{"pass": 0}):
                ttracer.instant("tick", cat=ttracer.CAT_PULL, n=1)
            ttracer.counter("hbm_bytes_in_use", dev=7)
    finally:
        ttracer.stop()
    assert not ttracer.enabled()
    events = treport.load_events(os.path.join(d, "events-host0.jsonl"))
    assert [(e["name"], e["ph"]) for e in events] == [
        ("stage-a", "B"), ("pass-0", "B"), ("tick", "i"), ("pass-0", "E"),
        ("hbm_bytes_in_use", "C"), ("stage-a", "E")]
    roots, unclosed = treport.build_span_tree(events)
    assert not unclosed and roots[0]["children"][0]["name"] == "pass-0"
    assert ttracer.span("off") is ttracer.span("off too")  # the no-op span
    path = treport.export_chrome_trace(d)
    assert len(json.load(open(path))["traceEvents"]) == len(events) + 1


SAMPLES = [0.0, -1.0, 1e-3, 0.5, 1.0, 2.0, 3.7, 10.0, 10.0, 1234.5, 9e6]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_histogram_quantiles_match_jax(seed):
    rng = np.random.default_rng(seed)
    values = SAMPLES + list(rng.lognormal(2.0, 3.0, 200)) \
        + list(rng.integers(0, 50, 50).astype(float))
    th, jh = tmetrics.Histogram(), jmetrics.Histogram()
    for v in values:
        th.observe(v)
        jh.observe(v)
        assert tmetrics.hist_bucket(v) == jmetrics.hist_bucket(v)
    assert th.describe() == jh.describe()
    for q in (0.0, 0.25, 0.5, 0.95, 0.99, 1.0):
        assert th.quantile(q) == jh.quantile(q)
        assert tmetrics.bucket_quantile(th._buckets, q, 0.0, 9e6) == \
            jmetrics.bucket_quantile(jh._buckets, q, 0.0, 9e6)


def test_registry_mirrors_every_shim_like_jax():
    """The same shim calls leave equal stats dicts and equal exposition text
    in both packages' registries."""
    def drive(m):
        m.reset()
        stats = {}
        m.counter_add(stats, "n_pair_chunks")
        m.counter_add(stats, "n_pair_chunks", 4)
        m.counter_max(stats, "peak", 3)
        m.time_add(stats, "host_sync_ms", 1.23456)
        m.gauge_set(stats, "pair_backend", "chunked")
        m.set_many(stats, n_lines=7, max_line=5)
        m.struct_set(stats, "dense_plan", {"tile": 128, "l_pad": 256})
        m.struct_update(stats, "dense_plan", n_launches=2)
        m.list_append(stats, "degradations", {"phase": "cind"})
        m.mapping_set(stats, "integrity_stages", "output", "ab")
        m.restore(stats, {"resumed": 1})
        m.observe("stage_discover_ms", 12.5)
        return stats, m.registry().prometheus_text(), \
            m.registry().snapshot(jsonable=True)

    got, want = drive(tmetrics), drive(jmetrics)
    assert got == want
    tmetrics.reset()
    jmetrics.reset()


def test_flight_recorder_dumps_on_an_injected_fault(tmp_path, monkeypatch):
    monkeypatch.setenv("RDFIND_FLIGHTREC", str(tmp_path))
    monkeypatch.setenv("RDFIND_FAULTS", "preempt@discover:pass=1")
    tfaults.reset()
    assert tflightrec.configure()
    try:
        tflightrec.reset()
        with ttracer.span("discover", cat=ttracer.CAT_STAGE):
            tfaults.maybe_preempt("preempt@discover", 0)
            with pytest.raises(tfaults.Preempted):
                tfaults.maybe_preempt("preempt@discover", 1)
        dump = tflightrec.load(tflightrec.dump_path(str(tmp_path)))
        assert dump["reason"].startswith("preempted: injected preemption")
        assert [e["name"] for e in dump["events"]] == ["discover"]
        assert set(dump) == {"host", "reason", "dumped_at", "n_events",
                             "events"}
        assert tflightrec.find_dumps(str(tmp_path)) == {
            0: tflightrec.dump_path(str(tmp_path))}
    finally:
        monkeypatch.delenv("RDFIND_FLIGHTREC")
        tflightrec.configure()
        tfaults.reset()
    assert not tflightrec.enabled()


def test_heartbeat_files_have_the_jax_fields(tmp_path):
    status = {"stage": "discover", "pass": None, "mode": "full"}
    theartbeat.write(str(tmp_path / "t"), status)
    jheartbeat.write(str(tmp_path / "j"), status)
    got = theartbeat.read(str(tmp_path / "t"))
    want = jheartbeat.read(str(tmp_path / "j"))
    assert set(got) == set(want)
    assert {k: got[k] for k in got if k != "ts"} == \
        {k: want[k] for k in want if k != "ts"}
    assert theartbeat.assess(str(tmp_path / "t"))["state"] == \
        jheartbeat.assess(str(tmp_path / "j"))["state"] == "alive"


@pytest.mark.parametrize("strategy,backend", [
    (0, "matmul"), (0, "chunked"), (1, "matmul"), (1, "chunked")])
def test_datastats_histograms_match_jax(strategy, backend, monkeypatch):
    monkeypatch.setenv("RDFIND_DATASTATS", "1")
    assert tdatastats.enabled() and jdatastats.enabled()
    triples = synth.generate_triples(700, seed=11, n_predicates=7,
                                     n_entities=60)
    got, want = {}, {}
    rdfind_tpu_torch.discover(triples, 3, strategy=strategy, device="cpu",
                              pair_backend=backend, stats=got)
    rdfind_tpu.discover(triples, 3, strategy=strategy, pair_backend=backend,
                        stats=want)
    for key in ("datastats_lines", "datastats_captures"):
        assert got[key] == want[key], key
    assert got["datastats_lines"]["hist_log2"]
    monkeypatch.setenv("RDFIND_DATASTATS", "0")
    off = {}
    rdfind_tpu_torch.discover(triples, 3, strategy=strategy, device="cpu",
                              pair_backend=backend, stats=off)
    assert "datastats_lines" not in off


def test_log2_buckets_match_jax():
    sizes = [0, -3, 1, 2, 3, 4, 7, 8, 1023, 1024, 2 ** 31 - 1]
    assert tdatastats.log2_bucket_counts(sizes) == \
        jdatastats.log2_bucket_counts(sizes)
    assert tdatastats.hist_from_bins([0, 2, 0, 5]) == \
        jdatastats.hist_from_bins([0, 2, 0, 5])


def test_memory_sample_is_none_on_the_cpu_and_matches_jax_via_the_seam():
    tmemory.reset()
    assert tmemory.sample(None, label="stage x") is None
    per_dev = [("cuda:0", {"bytes_in_use": 900, "peak_bytes_in_use": 1500,
                           "bytes_limit": 1000}),
               ("cuda:1", {"bytes_in_use": 200, "peak_bytes_in_use": 300,
                           "bytes_limit": 4000})]
    records = []
    for mod, m in ((tmemory, tmetrics), (jmemory, jmetrics)):
        mod.reset()
        mod._stats_fn = lambda: per_dev
        try:
            stats = {}
            err = io.StringIO()
            with contextlib.redirect_stderr(err):
                first = mod.sample(stats, label="stage a")
                per_dev[0][1]["bytes_in_use"] = 950
                second = mod.sample(stats, label="stage b")
                per_dev[0][1]["bytes_in_use"] = 900
            records.append((first, second, stats, err.getvalue()))
        finally:
            mod._stats_fn = None
            mod.reset()
    assert records[0] == records[1]
    first, second, stats, err = records[0]
    assert first == {"in_use_bytes": 900, "peak_bytes": 1500,
                     "limit_bytes": 1000, "frac": 0.9, "delta_bytes": 0}
    assert second["delta_bytes"] == 50
    assert stats["hbm_near_cap_warnings"] == 1 and "near cap" in err


def test_forecast_verdicts_match_jax():
    traj = [(0, 0.5), (1, 0.6), (2, 0.72)]
    assert tforecast.predict_exhaustion(traj) == \
        jforecast.predict_exhaustion(traj) == 5
    stats_t, stats_j = {}, {}
    for mod, stats in ((tforecast, stats_t), (jforecast, stats_j)):
        f = mod.Forecaster(stats, n_pass=8, phase="cind")
        for p, frac in traj:
            f.step(p, {"pairs": frac, "lines": 0.9})
    assert stats_t == stats_j
    assert tforecast.format_lines(stats_t) == jforecast.format_lines(stats_j)


def test_debug_lines_render_like_jax():
    stats = {"ingest": {"n_threads": 2, "n_units": 3},
             "n_host_pull_retries": 1, "backoff_ms_total": 1.5,
             "hbm": {"in_use_bytes": 1, "peak_bytes": 2, "limit_bytes": 3,
                     "frac": 0.3, "delta_bytes": 0},
             "datastats_lines": {"n_lines": 4, "max_line": 9,
                                 "giant_lines": 0, "giant_share": 0.0,
                                 "source": "single"},
             "cap_forecast": {"pairs": {"cap": "pairs", "phase": "", "pass": 1,
                                        "predicted_pass": 3, "frac": 0.9,
                                        "n_pass": 4, "reason": "warn"}}}
    assert treport.format_debug_lines(stats) == \
        jreport.format_debug_lines(stats)
    assert treport.dispatch_row(stats) == jreport.dispatch_row(stats)
