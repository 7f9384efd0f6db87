"""The benchmark's own tests: run them from the repository root with
``python -m pytest benchmark/tests -q``; the card's with ``-m cuda`` on a
machine that has one.  They import torch and the port, never JAX."""

import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


@pytest.fixture(autouse=True)
def _few_threads():
    """Small CPU runs are many small tensor ops: one thread each."""
    import torch
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def card():
    """Skip unless this machine has a CUDA card."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.cuda.get_device_name(0)


# The CLI cell, held out of BENCHMARK.json (its rate spreads too widely
# between runs on the card machine), with its per-layer metrics: the tests
# still drive its entry, traffic file and readers.
HELD_CELLS = [{"name": "lubm1_s10.cli_default", "config": "lubm1_s10",
               "traffic": "cli_default", "chips": 1}]
HELD_PER_LAYER = [
    {"name": "driver.write_output_ms", "unit": "ms", "better": "lower",
     "source": "program_span", "layer": "CLI / driver",
     "moves": "triples_per_s", "workloads": ["lubm1_s10.cli_default"]},
    {"name": "s1.walk_host_ms", "unit": "ms", "better": "lower",
     "source": "program_span", "layer": "strategy 1",
     "moves": "triples_per_s", "workloads": ["lubm1_s10.cli_default"]}]


def bench_with_held() -> dict:
    """BENCHMARK.json with the held-back cell and its metrics."""
    from benchmark import cells
    b = cells.benchmark()
    return dict(b, workloads=b["workloads"] + HELD_CELLS,
                per_layer=b["per_layer"] + HELD_PER_LAYER)


# CPU sizes of each configuration that still hold CINDs: (departments of
# one university, support).
TINY = {"lubm10_s100": (2, 20), "lubm1_s10": (1, 3)}


def tiny_cell(name: str, departments: int | None = None,
              min_support: int | None = None) -> dict:
    """The workload `name` of BENCHMARK.json cut to a CPU run's size
    (``TINY`` unless given): one university of a few departments."""
    from benchmark import cells
    c = cells.cell(name, bench_with_held())
    d, s = TINY[c["config"]]
    c["config_file"] = dict(
        c["config_file"], min_support=min_support or s,
        generator_args={"universities": 1, "departments": departments or d})
    return c
