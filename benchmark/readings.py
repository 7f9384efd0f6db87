#!/usr/bin/env python3
"""The readings that the limits of ``correct`` are set from.

    python3 benchmark/readings.py --workload <cell> --seeds 1,2,3 --seconds 3 [--control]

For each seed, one short run of the cell in this process (the cell's own
sizes, load and checks, as ``run.py`` makes them) and one JSON line of its
checks.  With ``--control`` the program is replaced underneath by the
control: the plain reference with one guarantee that the configuration
states broken, its support threshold taken one lower (``min_support - 1``),
which has to come out as not correct.  The benchmark's own runs never run
this script.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


class ControlTable:
    """The control's answer in the shape of the program's ``CindTable``."""

    def __init__(self, table: dict):
        from benchmark.reference import cinds
        self._cols = tuple(table[c] for c in cinds.COLUMNS)

    def __len__(self):
        return len(self._cols[0])

    def columns(self):
        return self._cols


def control_answer(triples, min_support: int, strategy: int,
                   projections: str, device) -> dict:
    """The reference with its support threshold one lower."""
    from benchmark.reference import cinds
    return cinds.discover(triples, int(min_support) - 1, projections,
                          lattice=int(strategy) in (1, 3), device=device)


def control_discover(triples, min_support=10, strategy=1, *, device=None,
                     projections="spo", **_):
    import numpy as np
    return ControlTable(control_answer(np.asarray(triples), min_support,
                                       strategy, projections,
                                       device or "cpu"))


def control_cli_main(argv) -> int:
    """The CLI's place: read the N-Triples file of ``<v%09d>`` tokens,
    write the control's sorted lines to ``--output``."""
    import numpy as np

    from benchmark import gen
    from benchmark.reference import cinds

    p = argparse.ArgumentParser()
    p.add_argument("inputs", nargs="*")
    p.add_argument("--output")
    p.add_argument("--support", type=int, default=10)
    p.add_argument("--traversal-strategy", type=int, default=1)
    p.add_argument("--projection", default="spo")
    p.add_argument("--device", default="cuda")
    a = p.parse_args(argv)
    rows = []
    for path in a.inputs:
        with open(path) as f:
            rows += [[int(tok[2:-1]) for tok in line.split()[:3]]
                     for line in f if line.strip()]
    t = np.asarray(rows, np.int64).reshape(-1, 3)
    table = control_answer(t, a.support, a.traversal_strategy, a.projection,
                           a.device)
    with open(a.output, "w") as f:
        f.writelines(line + "\n" for line in cinds.lines(table, gen.token))
    return 0


@contextlib.contextmanager
def control_in_place():
    """The program's entry points replaced by the control."""
    import rdfind_tpu_torch
    from rdfind_tpu_torch.programs import rdfind
    saved = rdfind_tpu_torch.discover, rdfind.main
    rdfind_tpu_torch.discover, rdfind.main = control_discover, control_cli_main
    try:
        yield
    finally:
        rdfind_tpu_torch.discover, rdfind.main = saved


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True, help="comma-separated")
    p.add_argument("--seconds", type=float, default=3.0)
    p.add_argument("--control", action="store_true")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    from benchmark import cells, run
    bench = cells.benchmark()
    cell = cells.cell(args.workload, bench)
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        with (control_in_place() if args.control
              else contextlib.nullcontext()):
            result, checks = run.run_cell(cell, seed, args.seconds, False,
                                          device=args.device, bench=bench,
                                          t_start=t0)
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "control": args.control,
                          "correct": result["correct"],
                          "attempted": result["attempted"],
                          "checks": {k: c["value"] for k, c in checks.items()},
                          "seconds": time.perf_counter() - t0}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
