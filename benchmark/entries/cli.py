"""The ``cli`` entry: the rdfind CLI in-process, file to output.

A job is ``rdfind_tpu_torch.programs.rdfind.main([<input.nt>, --output
<file>, --support <n>, *argv])``: the parser and ``Config`` that ``main``
builds, run through ``runtime/driver.run``, every flag not named at its
default (strategy 1, ``spo``, frequent-condition filter off).  The driver's
``RunResult`` is recorded on its way back to ``main`` for its phase timings.

Before each job, outside its time, ``prepare`` writes the N-Triples file
anew under the job's own ids (``gen.job_ids``), so every job parses,
interns and writes an answer of its own, and removes the last output.  A
job kept for the check has its file moved aside.
"""

from __future__ import annotations

import os
import sys

import numpy as np


class Entry:
    def __init__(self, config: dict, traffic: dict, triples: np.ndarray,
                 device, workdir: str):
        import torch

        from rdfind_tpu_torch.programs import rdfind
        from rdfind_tpu_torch.runtime import driver

        self._torch = torch
        self._main = rdfind.main
        self._driver = driver
        self.device = device
        self.support = int(config["min_support"])
        self.workdir = workdir
        self.base = np.asarray(triples)
        self.in_path = os.path.join(workdir, "input.nt")
        self.out_path = os.path.join(workdir, "cinds.txt")
        self.argv = [str(a) for a in traffic.get("argv", [])]
        if config.get("projections", "spo") != "spo":
            self.argv += ["--projection", config["projections"]]
        if torch.device(device).type != "cuda":
            self.argv += ["--device", str(device)]
        self.triples_per_job = int(triples.shape[0])
        self.ids = None

    def prepare(self, ids: np.ndarray) -> None:
        from benchmark import gen

        self.ids = ids
        gen.write_nt(self.in_path, np.take(ids, self.base))
        if os.path.exists(self.out_path):
            os.remove(self.out_path)

    def job(self) -> dict:
        got = {}
        run = self._driver.run

        def recording(cfg):
            got["result"] = run(cfg)
            return got["result"]

        self._driver.run = recording
        try:
            rc = self._main([self.in_path, "--output", self.out_path,
                             "--support", str(self.support), *self.argv])
        finally:
            self._driver.run = run
        if rc != 0:
            raise RuntimeError(f"rdfind exited {rc}")
        if self._torch.device(self.device).type == "cuda":
            self._torch.cuda.synchronize()
        timings = got["result"].timings if "result" in got else {}
        return {"ids": self.ids, "path": self.out_path,
                "phases": tuple(timings.items())}

    def retain(self, out: dict, slot: int) -> dict:
        kept = os.path.join(self.workdir, f"judged-{slot}.txt")
        if os.path.exists(out["path"]):
            os.replace(out["path"], kept)
        elif os.path.exists(kept):
            os.remove(kept)
        return dict(out, path=kept)

    def mismatches(self, out: dict, want: dict) -> int:
        """Lines of the job's output file and of the reference's `want`
        (for the dense ids), under the job's ids and printed with the
        input's tokens, that the other lacks."""
        from collections import Counter

        from benchmark import gen
        from benchmark.reference import cinds

        try:
            with open(out["path"]) as f:
                got = f.read().splitlines()
        except FileNotFoundError:
            print(f"judged job wrote no output ({out['path']})",
                  file=sys.stderr)
            got = []
        want = cinds.lines(cinds.map_ids(want, out["ids"]), gen.token)
        if got == want:
            return 0
        a, b = Counter(got), Counter(want)
        return sum(((a - b) + (b - a)).values())

    def close(self) -> None:
        pass
