"""Find a cell's pieces by name: its entry in ``BENCHMARK.json``, its
configuration file, its traffic file, its job entry and its metric readers.

Everything that belongs to one configuration, one traffic mix or one metric
sits in a file of its own, so a cell, a configuration, a mix or a metric is
added by adding files and ``BENCHMARK.json`` entries:

* ``configs/<config>.json``: the deployment (generator, sizes, support,
  guarantees, ``reduced``, ``assumed``);
* ``traffic/<mix>.json``: the job entry and its options;
* ``entries/<entry>.py``: a job entry (``Entry`` class; see ``entries/``);
* ``metrics/<metric>.py``: ``read(ctx)`` returning the metric's value, or
  None where the run holds nothing to read.
"""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark(root: Path = ROOT) -> dict:
    return load_json(root / "BENCHMARK.json")


def cell(name: str, bench: dict) -> dict:
    """The workload entry `name` with its config and traffic files loaded."""
    for w in bench["workloads"]:
        if w["name"] == name:
            break
    else:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json (one of "
                       f"{', '.join(x['name'] for x in bench['workloads'])})")
    cfg_entry = next(c for c in bench["configs"] if c["name"] == w["config"])
    return dict(w, config_file=load_json(ROOT / cfg_entry["file"]),
                traffic_file=load_json(HERE / "traffic" / f"{w['traffic']}.json"))


def metrics_of(cell_name: str, bench: dict, kind: str) -> list[dict]:
    """The `kind` ("end_to_end" or "per_layer") metrics this cell reports:
    those that list it under ``workloads``, and those with no such list."""
    return [m for m in bench[kind]
            if "workloads" not in m or cell_name in m["workloads"]]


def _load_module(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def reader(metric: str):
    """The ``read(ctx)`` function of ``metrics/<metric>.py``."""
    mod = _load_module(HERE / "metrics" / f"{metric}.py",
                       "benchmark_metric_" + metric.replace(".", "_"))
    return mod.read


def entry(name: str):
    """The ``Entry`` class of ``entries/<name>.py``."""
    return _load_module(HERE / "entries" / f"{name}.py",
                        "benchmark_entry_" + name).Entry
