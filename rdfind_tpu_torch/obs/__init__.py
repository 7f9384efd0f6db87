"""Unified observability: span tracing, metrics registry, memory watermarks.

  tracer    hierarchical host spans (run -> stage -> pass -> dispatch/pull/
            exchange/checkpoint) recorded as JSONL events per host and
            exportable as Chrome-trace JSON (Perfetto); each span also opens a
            torch.profiler range of its name, so a --profile-dir trace lines
            up with the host timeline.  Off by default and near-free when off.
  metrics   typed counters/gauges/histograms mirroring every ``stats`` key
            (the publish shims update both), with optional Prometheus text
            exposition to a file.
  memory    stage high-water marks + allocation deltas from the CUDA caching
            allocator, with a near-cap warning.
  report    the per-host trace merge tool, Chrome-trace export, and the ONE
            formatter behind --debug-level / --counters rendering.
  heartbeat the run's liveness/status file (current stage, pass, last-event
            timestamp) so a wedged run is distinguishable from a slow one.
  flightrec crash-surviving bounded ring of the last N events, dumped
            atomically on signals and fault-ladder rungs.
  datastats the data plane: join-line and capture-support histograms.
  forecast  cap-exhaustion advisories from per-pass utilization.
  integrity order-invariant content digests and the run certificate.
  sentinel  the BENCH_HISTORY.jsonl perf series + the noise-aware regression
            gate, and the provenance block of a certificate.
  console   the live run console (loopback HTTP: /metrics, /status,
            /progress, /datastats, /integrity, /flightrec), grown by the
            serving process into the query plane (/query/*, /slo,
            /debug/slowlog).
  servestats the serving process's per-thread request counters, latency
            histograms, slow-query ring and SLO engine.

The JAX package's ``obs`` package, module for module.
Every submodule is stdlib-only at import time (torch is imported lazily at
call sites), so runtime/dispatch.py and runtime/faults.py can depend on obs
without widening their import footprint.
"""

from __future__ import annotations

from . import (console, datastats, flightrec, forecast,  # noqa: F401
               heartbeat, integrity, memory, metrics, report, sentinel,
               servestats, tracer)


def active() -> bool:
    """Whether any obs output is live (tracing, metrics exposition or the
    run console) — the gate for sampling work that is pure overhead without
    a consumer."""
    return (tracer.enabled() or metrics.export_requested()
            or console.serving())


def snapshot() -> dict:
    """One JSON-able snapshot of everything obs knows right now: the metrics
    registry and the current device-memory watermarks."""
    return {
        "metrics": metrics.registry().snapshot(jsonable=True),
        "memory": memory.sample(None, publish=False),
    }
