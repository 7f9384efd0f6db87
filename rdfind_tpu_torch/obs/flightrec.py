"""Crash-surviving flight recorder: a bounded in-memory event ring.

The jsonl tracer answers "what happened" only when it was armed before the
run; signals and fault-ladder rungs hit runs that fly with tracing off.  The
flight recorder closes that gap: a per-host ring of the last N
span/instant/counter events, fed from the tracer module's cheap disabled path,
dumped atomically to ``flightrec-host<N>.json`` when something goes wrong (the
driver's signal handler, fault-ladder rungs, injected faults).  Post-mortems
then start from the final seconds of the run even when no tracer file exists.

Knobs (read by :func:`configure`, re-read at every run start):

* ``RDFIND_FLIGHTREC`` — "" / "0" off (default); "1" on (dumps land in the
  trace dir when tracing is armed, else the cwd); any other value is a
  directory path to dump into.
* ``RDFIND_FLIGHTREC_EVENTS`` — ring capacity (default 512).

The JAX package's ``obs/flightrec.py``, copied.  Stdlib only; the tracer
imports this module, never the reverse.
"""

from __future__ import annotations

import collections
import json
import os
import threading
import time

DUMP_PREFIX = "flightrec-host"
DEFAULT_EVENTS = 512

# Module-level fast gate: the tracer's disabled path checks this attribute
# per event, so it must be a plain bool, not an env read.
_ENABLED = False
_DIR: str | None = None
_RING: collections.deque | None = None
_HOST = 0
_N_DROPPED = 0
_lock = threading.Lock()


def configure(host_index: int | None = None) -> bool:
    """(Re-)read the env knobs; returns whether recording is on.

    Called at import, at every driver run start, and by tests after
    flipping the env.  Reconfiguring keeps any already-recorded events
    that fit the (possibly new) capacity.
    """
    global _ENABLED, _DIR, _RING, _HOST
    raw = os.environ.get("RDFIND_FLIGHTREC", "")
    with _lock:
        if host_index is not None:
            _HOST = host_index
        if raw in ("", "0"):
            _ENABLED = False
            _DIR = None
            _RING = None
            return False
        _DIR = None if raw == "1" else raw
        try:
            cap = int(os.environ.get("RDFIND_FLIGHTREC_EVENTS",
                                     str(DEFAULT_EVENTS)))
        except ValueError:
            cap = DEFAULT_EVENTS
        cap = max(1, cap)
        if _RING is None or _RING.maxlen != cap:
            _RING = collections.deque(_RING or (), maxlen=cap)
        _ENABLED = True
        return True


def enabled() -> bool:
    return _ENABLED


def set_host(host_index: int) -> None:
    global _HOST
    _HOST = host_index


def record(ev: dict) -> None:
    """Append one event (deque.append is atomic; no lock on the hot path)."""
    ring = _RING
    if ring is not None:
        ring.append(ev)


def snapshot() -> list[dict]:
    ring = _RING
    return list(ring) if ring is not None else []


def reset() -> None:
    """Drop recorded events (run boundaries, tests); keeps configuration."""
    ring = _RING
    if ring is not None:
        ring.clear()


def dump_path(directory: str, host_index: int | None = None) -> str:
    h = _HOST if host_index is None else host_index
    return os.path.join(directory, f"{DUMP_PREFIX}{h}.json")


def dump(directory: str | None = None, reason: str = "",
         host_index: int | None = None) -> str | None:
    """Atomically write the ring to ``flightrec-host<N>.json``; returns the
    path, or None when recording is off.  Never raises (dump sites are
    signal handlers and exception paths) — a failed write is recorded as a
    dropped dump, not a crash."""
    if not _ENABLED:
        return None
    try:
        out_dir = directory or _DIR
        if out_dir is None:
            from . import tracer
            out_dir = tracer.trace_dir() or "."
        h = _HOST if host_index is None else host_index
        events = snapshot()
        payload = {"host": h, "reason": reason,
                   "dumped_at": round(time.time(), 3),
                   "n_events": len(events), "events": events}
        os.makedirs(out_dir, exist_ok=True)
        path = dump_path(out_dir, h)
        tmp = f"{path}.tmp.{os.getpid()}"
        with open(tmp, "w") as f:
            json.dump(payload, f, default=str)
        os.replace(tmp, path)
        return path
    except Exception:
        global _N_DROPPED
        _N_DROPPED += 1
        return None


def load(path: str) -> dict | None:
    """Parse a dump file (post-mortem tooling)."""
    try:
        with open(path) as f:
            return json.load(f)
    except (OSError, ValueError):
        return None


def find_dumps(directory: str) -> dict[int, str]:
    """{host_index: path} of every dump file in a directory."""
    out: dict[int, str] = {}
    try:
        names = os.listdir(directory)
    except OSError:
        return out
    for name in names:
        if not (name.startswith(DUMP_PREFIX) and name.endswith(".json")):
            continue
        try:
            out[int(name[len(DUMP_PREFIX):-len(".json")])] = (
                os.path.join(directory, name))
        except ValueError:
            continue
    return out


configure()
