"""A run with the timed path broken underneath comes out not correct.

Each test skips the harness's look for a card (``run.run_cell`` on the CPU)
and drives the rest of a run of a tiny cell with one fault planted in the
program: a job that returns its state unchanged, half of the input left
out, an answer altered where it is produced; and the control (the plain
reference with its support threshold one lower) in the program's place.
No cell spans chips, so no exchange can be left out.
"""

import dataclasses

import numpy as np
import pytest

import rdfind_tpu_torch
from benchmark import readings, run
from conftest import bench_with_held, tiny_cell
from rdfind_tpu_torch.runtime import driver

DISCOVER_CELLS = ["lubm10_s100.s0_dense", "lubm1_s10.s0_dense"]
CLI_CELL = "lubm1_s10.cli_default"


def run_tiny(name, seed=3000000021):
    c = tiny_cell(name)
    res, checks = run.run_cell(c, seed, 0.5, False, device="cpu",
                               bench=bench_with_held())
    return res, checks


def altered(table):
    cols = [np.array(c, copy=True) for c in table.columns()]
    if len(cols[6]):
        cols[6][len(cols[6]) // 2] += 1
    return dataclasses.replace(table, **dict(zip(
        ("dep_code", "dep_v1", "dep_v2", "ref_code", "ref_v1", "ref_v2",
         "support"), cols)))


@pytest.mark.parametrize("name", DISCOVER_CELLS)
def test_sound_run_is_correct(name):
    res, checks = run_tiny(name)
    assert res["correct"] and checks["mismatched_rows"]["value"] == 0
    assert checks["reference_rows"]["value"] > 0


@pytest.mark.parametrize("name", DISCOVER_CELLS)
@pytest.mark.parametrize("fault", ["unchanged", "half", "altered"])
def test_discover_fault_is_not_correct(name, fault, monkeypatch):
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
    res, checks = run_tiny(name)
    assert not res["correct"]
    assert checks["mismatched_rows"]["value"] > 0


@pytest.mark.parametrize("fault", ["unchanged", "half", "altered"])
def test_cli_fault_is_not_correct(fault, monkeypatch):
    if fault == "unchanged":
        monkeypatch.setattr(driver, "write_output", lambda *a, **k: None)
    elif fault == "half":
        real = driver._discover
        monkeypatch.setattr(driver, "_discover", lambda cfg, ids, dev, st:
                            real(cfg, ids[: len(ids) // 2], dev, st))
    else:
        real = driver.write_output
        monkeypatch.setattr(driver, "write_output", lambda path, table, d:
                            real(path, altered(table), d))
    res, checks = run_tiny(CLI_CELL)
    assert not res["correct"]
    assert checks["mismatched_rows"]["value"] > 0


@pytest.mark.parametrize("name", DISCOVER_CELLS + [CLI_CELL])
def test_control_in_place_is_not_correct(name):
    """The control at a size a test run holds: one department of
    lubm1_s10 at its support 10; two of lubm10_s100 at support 30 (so small
    a draw holds no CIND of support 99)."""
    n, s = {"lubm10_s100": (2, 30),
            "lubm1_s10": (1, 10)}[name.split(".")[0]]
    c = tiny_cell(name, n, s)
    with readings.control_in_place():
        res, checks = run.run_cell(c, 3000000031, 0.1, False, device="cpu",
                                   bench=bench_with_held())
    assert not res["correct"]
    assert checks["mismatched_rows"]["value"] > 0
