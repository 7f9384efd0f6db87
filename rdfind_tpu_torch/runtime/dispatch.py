"""Pipelined dispatch: overlap device compute with host pulls.

CUDA work is asynchronous: a queued operation returns at once, and the host
blocks only when it reads a device value.  A serial schedule (queue chunk i,
pull it, only then queue chunk i + 1) leaves the card idle during every host
round trip.  The helpers here are the shared machinery of the pipelined
executors (the port's chunk loop, ``models/allatonce.iter_chunk_pairs``):

  * `stage_to_host` starts a device-to-host copy the moment an output is
    queued: non-blocking into pinned host memory, fenced by a CUDA event, so
    the later blocking read mostly finds the bytes already on the host;
  * `sync_passes_forced` reads RDFIND_SYNC_PASSES — the forced-serial mode
    used by the differential tests (the pipelined output must be
    bit-identical to the serial schedule) and by measurements of the overlap;
  * `DispatchStats` counts blocking host syncs, the time spent in them, and
    how much of that time was overlapped with already-queued successor work.

The JAX package's ``runtime/dispatch.py``, with the staging translated to CUDA
streams and events.  Import-light (stdlib, the stdlib-only obs package; torch
only inside `stage_to_host`).
"""

from __future__ import annotations

import os
import time

from ..obs import metrics, tracer


def sync_passes_forced() -> bool:
    """True when RDFIND_SYNC_PASSES forces the serial (pull-then-dispatch)
    schedule.  Read at call time so tests and benches can flip modes without
    rebuilding pipelines."""
    return os.environ.get("RDFIND_SYNC_PASSES", "") not in ("", "0")


def pass_depth(default: int = 2) -> int:
    """How many passes the pipelined executor keeps in flight (>= 1 enqueued
    successor while the head pass is read back).  RDFIND_PASS_INFLIGHT
    overrides; forced-sync mode always runs depth 1."""
    if sync_passes_forced():
        return 1
    return max(2, int(os.environ.get("RDFIND_PASS_INFLIGHT", default)))


def stage_to_host(arrays):
    """Start the device-to-host copy of already-queued outputs.

    Returns ``(host, done)``: `host` the tensors' pinned host copies, queued
    non-blocking on the current stream, and `done` a CUDA event recorded
    after them (wait on it before reading `host`).  Tensors on the CPU pass
    through as they are, with `done` None.  Each call allocates fresh host
    buffers, so a pull that is retried re-reads bytes no later call reuses.
    """
    import torch

    arrays = tuple(arrays)
    if not arrays or arrays[0].device.type != "cuda":
        return arrays, None
    host = tuple(torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
                 for t in arrays)
    for h, t in zip(host, arrays):
        h.copy_(t, non_blocking=True)
    done = torch.cuda.Event()
    done.record()
    return host, done


class DispatchStats:
    """Per-run dispatch telemetry accumulated by a pipelined executor.

    n_host_syncs    -- blocking host reads issued (a batched device_get of
                       many arrays counts ONCE: one round trip);
    host_sync_ms    -- wall time spent blocked in those reads;
    pull_overlap_ms -- the subset of host_sync_ms during which at least one
                       successor pass was already enqueued on the device,
                       i.e. readback time that ran concurrently with compute;
    max_in_flight   -- peak number of enqueued-but-unread passes;
    n_cap_retries   -- optimistic dispatches rolled back by a capacity
                       overflow (grow caps, discard in-flight successors,
                       re-run the failed pass).
    """

    __slots__ = ("n_host_syncs", "host_sync_ms", "pull_overlap_ms",
                 "max_in_flight", "n_cap_retries", "_pull_base",
                 "_pull_absolute")

    def __init__(self, pull_base: dict | None = None):
        from . import faults

        self.n_host_syncs = 0
        self.host_sync_ms = 0.0
        self.pull_overlap_ms = 0.0
        self.max_in_flight = 0
        self.n_cap_retries = 0
        # Baseline of the module-wide pull-retry counters (faults.guarded_pull
        # wraps every host pull): publish() reports the delta since this
        # baseline.  Callers whose pulls start before the executor pass their
        # own earlier baseline; those publishes OVERWRITE the stats keys with
        # the cumulative-since-base value instead of accumulating, so
        # repeated publishes stay monotone without double counting.
        self._pull_absolute = pull_base is not None
        self._pull_base = pull_base if pull_base is not None \
            else faults.pull_stats()

    def saw_in_flight(self, n: int) -> None:
        self.max_in_flight = max(self.max_in_flight, n)

    def pulled(self, seconds: float, overlapped: bool) -> None:
        """Record one blocking host read of `seconds`, `overlapped` when a
        successor pass was enqueued while it blocked."""
        self.n_host_syncs += 1
        self.host_sync_ms += seconds * 1e3
        if overlapped:
            self.pull_overlap_ms += seconds * 1e3

    def timed_pull(self, fn, overlapped: bool, what: str = "pull"):
        """Run a blocking pull `fn()` under the sync clock; returns its value.
        The pull rides a host span (+ a matching profiler range) so a merged
        trace shows exactly which reads blocked and for how long."""
        t0 = time.perf_counter()
        with tracer.span(what, cat=tracer.CAT_PULL, overlapped=overlapped):
            out = fn()
        dt = time.perf_counter() - t0
        self.pulled(dt, overlapped)
        metrics.observe("host_pull_ms", dt * 1e3)
        return out

    def overlap_report(self, wall_ms: float, n_passes: int = 0) -> dict:
        """The overlap-efficiency row of one executor run: measured wall vs
        the ideal serial/parallel bounds the same pulls imply.

        serial_bound_ms    what the wall would have been with NO overlap —
                           every overlapped pull re-serialized onto the
                           critical path (measured + overlap);
        parallel_bound_ms  the wall with PERFECT overlap — every blocking
                           pull hidden behind enqueued compute (measured
                           minus the non-overlapped pull time);
        overlap_efficiency where the measured wall sits between the two
                           bounds (1.0 = perfect overlap, 0.0 = fully
                           serial); equals overlap_ms / pull_ms, since the
                           bounds differ by exactly pull_ms.

        """
        pull_ms = self.host_sync_ms
        overlap_ms = self.pull_overlap_ms
        serial = wall_ms + overlap_ms
        parallel = wall_ms - (pull_ms - overlap_ms)
        eff = overlap_ms / pull_ms if pull_ms > 0 else None
        return {"n_passes": int(n_passes),
                "measured_ms": round(wall_ms, 3),
                "pull_ms": round(pull_ms, 3),
                "overlap_ms": round(overlap_ms, 3),
                "serial_bound_ms": round(serial, 3),
                "parallel_bound_ms": round(parallel, 3),
                "overlap_efficiency": (round(eff, 4)
                                       if eff is not None else None)}

    def publish(self, stats: dict | None) -> None:
        """Accumulate into a run-level stats dict (multiple pipelines per run:
        the small-to-large lattice runs one per level)."""
        if stats is None:
            return
        metrics.counter_add(stats, "n_host_syncs", self.n_host_syncs)
        metrics.time_add(stats, "host_sync_ms", self.host_sync_ms)
        metrics.time_add(stats, "pull_overlap_ms", self.pull_overlap_ms)
        metrics.counter_max(stats, "n_passes_in_flight", self.max_in_flight)
        metrics.counter_add(stats, "n_pair_cap_retries", self.n_cap_retries)
        from . import faults

        pulls = faults.pull_stats()
        d_retries = (pulls["n_host_pull_retries"]
                     - self._pull_base["n_host_pull_retries"])
        d_backoff = (pulls["backoff_ms_total"]
                     - self._pull_base["backoff_ms_total"])
        if self._pull_absolute:
            metrics.gauge_set(stats, "n_host_pull_retries", d_retries)
            metrics.gauge_set(stats, "backoff_ms_total", round(d_backoff, 3))
        else:
            metrics.counter_add(stats, "n_host_pull_retries", d_retries)
            metrics.time_add(stats, "backoff_ms_total", d_backoff)
            # The delta is consumed; re-baseline so a second publish (one per
            # lattice level) never double-counts.
            self._pull_base = pulls
