"""Hierarchical host-span tracing, recorded as per-host JSONL event files.

Span model: run -> stage -> pass -> dispatch / pull / exchange / checkpoint.
Every span is written as a Chrome-trace B/E event pair the moment it opens
and closes (never buffered until run end), so a wedged run's trace still
shows exactly which span it died inside.  ``report.export_chrome_trace``
turns the event files into one Chrome-trace JSON with per-host lanes,
viewable in Perfetto (ui.perfetto.dev) or chrome://tracing.

Timestamps are epoch microseconds (time.time_ns) — the only clock multiple
hosts share — and the merge tool rebases them to the earliest event.

Host/device alignment: when tracing is enabled and a profiler runs, each span
also enters a ``torch.profiler`` range of the same name, so a profiler trace
(``--profile-dir``) carries the host span names on its timeline.  The span's B
stamp is read right after the range is entered (its E stamp right after the
range is left), and the profiler's events carry epoch nanoseconds too, so a
span's JSONL time and its range share one clock reading.

Program ranges: ``profile_range(name)`` is the one way the port opens a named
profiler range (the ``rdfind.*`` stages a benchmark trace reads).  It returns
the shared no-op object unless a profiler runs, so a range costs one flag
check when none does.  torch is imported lazily, at the first range.

Disabled cost: ``span()`` returns a shared no-op context manager after one
module-global check — the hot path pays a function call and a branch.

The JAX package's ``obs/tracer.py`` with the annotation and the host index
translated.  Stdlib only at import time (``runtime/dispatch.py`` imports this
module).
"""

from __future__ import annotations

import json
import os
import threading
import time

from . import flightrec, heartbeat

# Span categories (the `cat` field of every event) — the fixed vocabulary the
# report tool and the tests nest-check against.
CAT_RUN = "run"
CAT_STAGE = "stage"
CAT_PASS = "pass"
CAT_DISPATCH = "dispatch"
CAT_PULL = "pull"
CAT_EXCHANGE = "exchange"
CAT_CHECKPOINT = "checkpoint"

EVENTS_PREFIX = "events-host"


class _NullSpan:
    """The shared disabled-path context manager (one instance, no state)."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NULL_SPAN = _NullSpan()


def profile_range(name: str):
    """A ``torch.profiler`` range named `name` (a context manager) while a
    profiler runs, else the shared no-op ``_NULL_SPAN``."""
    import torch

    if not torch._C._autograd._profiler_enabled():
        return _NULL_SPAN
    return torch.profiler.record_function(name)


class _Span:
    """One open span: writes its E event (and pops the thread stack) on exit."""

    __slots__ = ("_tracer", "name", "_annotation")

    def __init__(self, tracer: "Tracer", name: str, annotation):
        self._tracer = tracer
        self.name = name
        self._annotation = annotation

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        if self._annotation is not None:
            try:
                self._annotation.__exit__(*exc)
            except Exception:
                pass
        self._tracer._close_span(self.name, time.time_ns() // 1000)
        return False


class Tracer:
    """One per-process tracer bound to a trace directory.

    Not instantiated directly in pipeline code — use the module functions
    (``start`` / ``span`` / ``instant`` / ``stop``), which also keep the
    disabled path free.
    """

    def __init__(self, trace_dir: str, host_index: int = 0,
                 annotate: bool = True):
        self.dir = trace_dir
        self.host_index = int(host_index)
        os.makedirs(trace_dir, exist_ok=True)
        self._path = os.path.join(trace_dir,
                                  f"{EVENTS_PREFIX}{self.host_index}.jsonl")
        self._f = open(self._path, "a", buffering=1)  # line-buffered
        self._lock = threading.Lock()
        self._local = threading.local()
        self.n_events = 0
        self.n_mismatched = 0  # __exit__ order violations (bugs, not faults)
        self._status = {"stage": None, "pass": None}
        self._beat = heartbeat.Heartbeat(trace_dir, host_index=self.host_index)
        self._annotate = annotate  # spans open profiler ranges too

    # -- internals ----------------------------------------------------------

    def _stack(self) -> list:
        st = getattr(self._local, "stack", None)
        if st is None:
            st = self._local.stack = []
        return st

    def _emit(self, ev: dict) -> None:
        if flightrec._ENABLED:
            flightrec.record(ev)
        line = json.dumps(ev, separators=(",", ":"), default=str)
        with self._lock:
            self._f.write(line + "\n")
            self.n_events += 1

    def _tid(self) -> int:
        return threading.get_ident() & 0xFFFF

    def open_span(self, name: str, cat: str, args: dict):
        annotation = None
        if self._annotate:
            try:
                annotation = profile_range(name)
                annotation.__enter__()
            except Exception:
                annotation = None
        ts = time.time_ns() // 1000  # next to the range's own start
        stack = self._stack()
        stack.append(name)
        if cat == CAT_STAGE:
            self._status["stage"] = name
            self._status["pass"] = None
        elif cat == CAT_PASS:
            self._status["pass"] = args.get("pass")
        self._emit({"name": name, "cat": cat, "ph": "B", "ts": ts,
                    "pid": self.host_index, "tid": self._tid(),
                    "args": args})
        self._beat.maybe_beat(self._status)
        return _Span(self, name, annotation)

    def _close_span(self, name: str, ts: int) -> None:
        stack = self._stack()
        if stack and stack[-1] == name:
            stack.pop()
        else:  # exits out of order: record, never raise mid-pipeline
            self.n_mismatched += 1
            if name in stack:
                stack.remove(name)
        self._emit({"name": name, "ph": "E", "ts": ts,
                    "pid": self.host_index, "tid": self._tid()})
        self._beat.maybe_beat(self._status)

    def instant(self, name: str, cat: str, args: dict) -> None:
        self._emit({"name": name, "cat": cat, "ph": "i", "s": "t",
                    "ts": time.time_ns() // 1000, "pid": self.host_index,
                    "tid": self._tid(), "args": args})

    def counter(self, name: str, values: dict) -> None:
        """A Chrome-trace counter sample (e.g. HBM bytes over time)."""
        self._emit({"name": name, "ph": "C", "ts": time.time_ns() // 1000,
                    "pid": self.host_index, "tid": 0, "args": values})

    def open_spans(self) -> int:
        return len(self._stack())

    def close(self) -> None:
        self._beat.beat(self._status, final=True)
        with self._lock:
            self._f.flush()
            self._f.close()


_TRACER: Tracer | None = None
_ENABLED = False


def enabled() -> bool:
    return _ENABLED


def current() -> Tracer | None:
    return _TRACER


def trace_dir() -> str | None:
    return _TRACER.dir if _TRACER is not None else None


def default_host_index() -> int:
    """This process's host index: the launch's (a host, not a rank, as a
    JAX "process" is one), else 0."""
    import sys
    mesh = sys.modules.get("rdfind_tpu_torch.parallel.mesh")
    return mesh.process_index() if mesh is not None else 0


def start(directory: str, host_index: int | None = None) -> Tracer:
    """Enable tracing into `directory` (idempotent per directory).

    `host_index` defaults to the launch's host index (0 outside a launch),
    passed explicitly by callers that know better.
    """
    global _TRACER, _ENABLED
    if _TRACER is not None and _TRACER.dir == directory:
        _ENABLED = True
        return _TRACER
    if _TRACER is not None:
        _TRACER.close()
    if host_index is None:
        host_index = default_host_index()
    _TRACER = Tracer(directory, host_index=host_index)
    flightrec.set_host(host_index)
    _ENABLED = True
    return _TRACER


def stop() -> None:
    global _TRACER, _ENABLED
    if _TRACER is not None:
        _TRACER.close()
    _TRACER = None
    _ENABLED = False


def span(name: str, cat: str = CAT_STAGE, **args):
    """Open a span (context manager).  The disabled path returns a shared
    no-op object after one global check (plus one flight-recorder flag
    check — the ring records span opens even when the jsonl tracer is off,
    so post-mortem dumps exist for untraced runs)."""
    if not _ENABLED:
        if flightrec._ENABLED:
            flightrec.record({"name": name, "cat": cat, "ph": "B",
                              "ts": time.time_ns() // 1000, "args": args})
        return _NULL_SPAN
    return _TRACER.open_span(name, cat, args)


def instant(name: str, cat: str = CAT_EXCHANGE, **args) -> None:
    """A zero-duration event (e.g. one exchange dispatch's ledger entry)."""
    if not _ENABLED:
        if flightrec._ENABLED:
            flightrec.record({"name": name, "cat": cat, "ph": "i",
                              "ts": time.time_ns() // 1000, "args": args})
        return
    _TRACER.instant(name, cat, args)


def counter(name: str, **values) -> None:
    if not _ENABLED:
        if flightrec._ENABLED:
            flightrec.record({"name": name, "ph": "C",
                              "ts": time.time_ns() // 1000, "args": values})
        return
    _TRACER.counter(name, values)


def set_status(**kv) -> None:
    """Attach extra fields to this host's heartbeat status — cap-utilization
    fractions and forecast advisories ride the next beat so a watcher can
    surface them.  No-op (one global check) when tracing is
    off: the heartbeat file only exists under an armed tracer."""
    if _TRACER is not None:
        _TRACER._status.update(kv)


def heartbeat_now() -> None:
    """Force an immediate (unthrottled) heartbeat write carrying the
    current status (a fire path must land its stamp before the process
    potentially exits)."""
    if _TRACER is not None:
        _TRACER._beat.beat(_TRACER._status)
