"""On the card: each cell's command runs, prints its one line, and is
correct.  Run on a machine with a CUDA card:
``python -m pytest -m cuda benchmark/tests/test_benchmark_card.py``."""

import json
import subprocess
import sys
from pathlib import Path

import pytest

from benchmark import cells

ROOT = Path(__file__).resolve().parents[2]


@pytest.mark.cuda
@pytest.mark.parametrize("name", [w["name"] for w in
                                  cells.benchmark()["workloads"]])
def test_cell_runs_on_the_card(card, name):
    p = subprocess.run([sys.executable, "benchmark/run.py", "--workload", name,
                        "--seed", "2147483659", "--seconds", "2",
                        "--trace", "0"], capture_output=True, text=True,
                       cwd=ROOT, timeout=1200)
    assert p.returncode == 0, p.stderr[-4000:]
    res = json.loads(p.stdout.strip().splitlines()[-1])
    assert res["correct"], p.stderr[-4000:]
    assert res["device"]["platform"] == "gpu" and res["device"]["kind"] == card
    assert "setup_s" in res["metrics"] and "triples_per_s" in res["metrics"]
