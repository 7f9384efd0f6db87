"""The readers of kernel K3's per-layer metrics (``membership.device_ms``,
``membership_roofline``) on the CPU: K3's byte count against a count from
the definition, the values they read off a trace, and none where a run
launched no K3 (the parent of the change that added K3, or a run off the
card).  Then the faults and the control of ``test_benchmark_faults.py`` in
the cell of LUBM(100), at test size."""

import itertools

import numpy as np
import pytest

import rdfind_tpu_torch
from benchmark import cells, gen, readings, roofline, run
from benchmark.tracing import Trace
from conftest import bench_with_held, tiny_cell
from test_benchmark_faults import altered, run_tiny

H100 = "NVIDIA H100 80GB HBM3"
ROWS = "(anonymous namespace)::membership_counts_rows_kernel(signed char)"
LINES = "(anonymous namespace)::membership_counts_lines_kernel(signed char)"


def _roofline_module():
    return cells._load_module(cells.HERE / "metrics" / "membership_roofline.py",
                              "benchmark_metric_membership_roofline_test")


def _brute_bytes(triples, support):
    """Entries of the frequent captures (one byte each) and a 4-byte count
    per frequent capture and per line, from the CIND definition."""
    ext = {}
    for s, p, o in triples.tolist():
        t = (s, p, o)
        for pi, (a, b) in ((0, (1, 2)), (1, (0, 2)), (2, (0, 1))):
            for key in ((pi, a, t[a]), (pi, b, t[b]), (pi, a, t[a], b, t[b])):
                ext.setdefault(key, set()).add(t[pi])
    freq = {k: v for k, v in ext.items() if len(v) >= support}
    entries = sum(len(v) for v in freq.values())
    lines = set(itertools.chain.from_iterable(freq.values()))
    return entries + 4 * (len(freq) + len(lines))


def test_k3_bytes_match_the_definition_and_incidence_counts():
    t = gen.generate_lubm(1, seed=3, departments=1)
    for support in (5, 20):
        got = _roofline_module().k3_bytes(t, support, device="cpu")
        assert got == _brute_bytes(t, support)
        n_f, n_caps = roofline.incidence_counts(t, support)
        assert got == int(n_f.sum()) + 4 * (n_caps + n_f.size)
    t = gen.generate_lubm(1, seed=4, departments=3)
    for support, proj in ((10, "spo"), (3, "so")):
        n_f, n_caps = roofline.incidence_counts(t, support, proj)
        assert _roofline_module().k3_bytes(t, support, proj, "cpu") == \
            int(n_f.sum()) + 4 * (n_caps + n_f.size)


def _ctx(kernels_s, device=H100, n_jobs=4):
    t = gen.generate_lubm(1, seed=3, departments=1)
    jobs = [{"seconds": 1.0, "triples": len(t), "peak_bytes": 0, "ok": True,
             "phases": ()}] * n_jobs
    return run.Context({"min_support": 5, "projections": "spo"}, t, jobs, 1.0,
                       Trace(kernels_s=kernels_s), device)


def test_readers_take_both_k3_kernels():
    ctx = _ctx({ROWS: 0.004, LINES: 0.002, "fused_cind_kernel": 1.0})
    assert cells.reader("membership.device_ms")(ctx) == 1e3 * 0.006 / 4
    nbytes = _roofline_module().k3_bytes(ctx.triples, 5)
    want = 100.0 * nbytes / roofline.PEAKS["NVIDIA H100"][
        "hbm_bytes_per_s"] / (0.006 / 4)
    assert abs(cells.reader("membership_roofline")(ctx) - want) < 1e-9 * want


def test_readers_read_nothing_without_k3():
    for ctx in (_ctx({"fused_cind_kernel": 1.0}), _ctx({ROWS: 0.1}, "cpu")):
        assert cells.reader("membership_roofline")(ctx) is None
    assert cells.reader("membership.device_ms")(
        _ctx({"fused_cind_kernel": 1.0})) is None
    no_trace = _ctx({})
    no_trace.trace = None
    for name in ("membership.device_ms", "membership_roofline"):
        assert cells.reader(name)(no_trace) is None


# The fault and control tests of ``test_benchmark_faults.py`` on the cell of
# LUBM(100) at test size.
LUBM100 = "lubm100_s100.s0_dense"


def test_sound_run_of_the_lubm100_cell_is_correct():
    res, checks = run_tiny(LUBM100)
    assert res["correct"] and checks["mismatched_rows"]["value"] == 0
    assert checks["reference_rows"]["value"] > 0


@pytest.mark.parametrize("fault", ["unchanged", "half", "altered"])
def test_fault_in_the_lubm100_cell_is_not_correct(fault, monkeypatch):
    real = rdfind_tpu_torch.discover
    first = {}

    def broken(triples, *a, **kw):
        if fault == "half":
            return real(np.asarray(triples)[: len(triples) // 2], *a, **kw)
        out = real(triples, *a, **kw)
        if fault == "altered":
            return altered(out)
        return first.setdefault("table", out)  # the first answer, always

    monkeypatch.setattr(rdfind_tpu_torch, "discover", broken)
    res, checks = run_tiny(LUBM100)
    assert not res["correct"]
    assert checks["mismatched_rows"]["value"] > 0


def test_control_in_place_of_the_lubm100_cell_is_not_correct():
    """The control at lubm10_s100's test size (two departments, support
    30): the configurations share generator and support."""
    c = tiny_cell(LUBM100, 2, 30)
    with readings.control_in_place():
        res, checks = run.run_cell(c, 3000000031, 0.1, False, device="cpu",
                                   bench=bench_with_held())
    assert not res["correct"]
    assert checks["mismatched_rows"]["value"] > 0
