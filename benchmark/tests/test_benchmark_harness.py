"""The harness on the CPU: files found by name, BENCHMARK.json within its
contract, the one-line result of a tiny run of each traffic, and a run that
finds no card."""

import json
import re
import subprocess
import sys
from pathlib import Path

import pytest

from benchmark import cells, run
from conftest import bench_with_held, tiny_cell

ROOT = Path(__file__).resolve().parents[2]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def bench():
    return cells.benchmark()


def test_every_cell_finds_its_files():
    b = bench_with_held()
    for w in b["workloads"]:
        c = cells.cell(w["name"], b)
        assert c["config_file"]["name"] == w["config"]
        assert c["traffic_file"]["entry"] in ("discover", "cli")
        assert cells.entry(c["traffic_file"]["entry"]) is not None
    for kind in ("end_to_end", "per_layer"):
        for m in b[kind]:
            assert callable(cells.reader(m["name"]))


def test_benchmark_json_keeps_its_contract():
    b = bench()
    assert set(b) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert 1 <= b["run_seconds"] <= 51
    cfg_names = {c["name"] for c in b["configs"]}
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and c["file"].startswith("benchmark/")
        f = cells.load_json(ROOT / c["file"])
        assert f["reduced"] == c["reduced"] and f["source"] == c["source"]
    names = set()
    for w in b["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and w["config"] in cfg_names
        assert w["chips"] == 1 and len(w["why"]) <= 200
        names.add(w["name"])
    e2e = {m["name"] for m in b["end_to_end"]}
    assert "setup_s" in e2e
    for kind in ("end_to_end", "per_layer"):
        for m in b[kind]:
            assert NAME.match(m["name"]) and UNIT.match(m["unit"])
            assert m["better"] in ("lower", "higher")
            assert set(m.get("workloads", names)) <= names
            if kind == "end_to_end":
                assert m["source"] in ("host_clock", "device_trace")
                assert 0.01 <= m["bound"] <= 0.25
            else:
                assert m["moves"] in e2e and "bound" not in m
    for w in names:  # every cell: setup_s, another e2e, a per-layer metric
        got = {m["name"] for m in cells.metrics_of(w, b, "end_to_end")}
        assert "setup_s" in got and len(got) >= 2
        assert cells.metrics_of(w, b, "per_layer")
    assert len(json.dumps(b)) < 64 * 1024


@pytest.mark.parametrize("name", [w["name"] for w in
                                  bench_with_held()["workloads"]])
@pytest.mark.parametrize("trace", [False, True])
def test_tiny_run_prints_the_result_shape(name, trace):
    b = bench_with_held()
    c = tiny_cell(name)
    res, checks = run.run_cell(c, 3000000011, 0.5, trace, device="cpu",
                               bench=b)
    assert list(res)[:5] == ["correct", "attempted", "failed", "metrics",
                             "device"]
    assert list(res)[-1] == "checks"
    assert res["correct"] is True and res["failed"] == 0
    assert res["attempted"] >= 1 and checks["judged_jobs"]["value"] >= 1
    kind = "per_layer" if trace else "end_to_end"
    want = {m["name"] for m in cells.metrics_of(name, b, kind)}
    # Off the card no device metric is read; the host ones are.
    host_only = {m["name"] for m in cells.metrics_of(name, b, kind)
                 if m["source"] != "device_trace" and m["name"] != "peak_gb"}
    assert host_only <= set(res["metrics"]) <= want
    for v in res["metrics"].values():
        assert v["value"] > 0 and UNIT.match(v["unit"])
    if trace:
        assert {"busy_s", "window_s"} <= set(res["device"])
        assert res["device"]["window_s"] > 0
        assert set(res["breakdown"]) == {"device_ops", "idle_gaps"}


def test_a_run_without_a_card_prints_no_result():
    """On a machine with no card the command exits non-zero, silent on
    standard output."""
    import torch
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    p = subprocess.run([sys.executable, str(ROOT / "benchmark" / "run.py"),
                        "--workload", "lubm1_s10.s0_dense", "--seed", "1",
                        "--seconds", "1", "--trace", "0"],
                       capture_output=True, text=True, cwd=ROOT, timeout=300)
    assert p.returncode != 0 and p.stdout == ""
    assert "no CUDA device" in p.stderr


def test_an_unknown_cell_prints_no_result():
    p = subprocess.run([sys.executable, str(ROOT / "benchmark" / "run.py"),
                        "--workload", "nope.none", "--seed", "1",
                        "--seconds", "1", "--trace", "0"],
                       capture_output=True, text=True, cwd=ROOT, timeout=300)
    assert p.returncode != 0 and p.stdout == ""


def test_forbidden_modules_compare_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "rdfind_tpu_torchx", object())
    assert "rdfind_tpu" not in run.forbidden_modules()
    monkeypatch.setitem(sys.modules, "jax.numpy", object())
    assert "jax" in run.forbidden_modules()
