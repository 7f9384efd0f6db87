"""The ``discover`` entry: one library call per job.

A job is ``rdfind_tpu_torch.discover(triples, support, strategy=s,
device=..., **options)`` on a host (N, 3) int32 id array, ended by a device
synchronize; the host-to-device copy of the triples is part of the job, as
it is for a caller.  Before each job, outside its time, ``prepare`` puts the
rows under the job's own ids (``gen.job_ids``): the same work in the same
order (the map keeps every order among ids), and an input and an answer no
earlier job had, so a cached answer cannot pass the check.
"""

from __future__ import annotations

import numpy as np


class Entry:
    def __init__(self, config: dict, traffic: dict, triples: np.ndarray,
                 device, workdir: str):
        import torch

        import rdfind_tpu_torch

        self._torch = torch
        self._discover = rdfind_tpu_torch.discover
        self.device = device
        self.support = int(config["min_support"])
        self.projections = config.get("projections", "spo")
        self.strategy = int(traffic["strategy"])
        self.options = dict(traffic.get("options", {}))
        self.base = np.ascontiguousarray(triples, dtype=np.int32)
        self.triples_per_job = int(triples.shape[0])
        self.ids = self.input = None

    def prepare(self, ids: np.ndarray) -> None:
        self.ids = ids
        self.input = np.take(ids, self.base)

    def job(self) -> dict:
        table = self._discover(self.input, self.support,
                               strategy=self.strategy, device=self.device,
                               projections=self.projections, **self.options)
        if self._torch.device(self.device).type == "cuda":
            self._torch.cuda.synchronize()
        return {"ids": self.ids, "table": table, "phases": ()}

    def retain(self, out: dict, slot: int) -> dict:
        return out

    def mismatches(self, out: dict, want: dict) -> int:
        """Rows of the job's table and of the reference's `want` (for the
        dense ids), under the job's ids, that the other lacks."""
        from benchmark.reference import cinds

        t = out["table"]
        got = (np.stack([np.asarray(c, np.int64) for c in t.columns()], 1)
               if len(t) else np.zeros((0, 7), np.int64))
        return cinds.mismatched_rows(
            got, cinds.rows(cinds.map_ids(want, out["ids"])))

    def close(self) -> None:
        self.base = self.input = None
