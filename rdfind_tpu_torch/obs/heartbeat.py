"""Run heartbeat/status file: is that long-running job wedged, or just slow?

The tracer updates ``heartbeat-host<N>.json`` in the run's obs directory on
every span boundary (throttled), recording the current stage, the pass index,
and the last-event wall timestamp.  A watcher reads it back: a recent
timestamp means the run is alive however slow; a stale one means it is wedged
inside whatever stage/pass the file names.  Writes are atomic (tmp + replace)
so a reader never sees a torn file.

The JAX package's ``obs/heartbeat.py``, copied (same file names and fields).
Stdlib only.
"""

from __future__ import annotations

import json
import os
import time

FILE_PREFIX = "heartbeat-host"

# Default staleness horizon: sharded passes on real workloads commit well
# under this; a heartbeat older than it means no span boundary fired at all.
DEFAULT_STALE_S = 300.0


def _path(directory: str, host_index: int) -> str:
    return os.path.join(directory, f"{FILE_PREFIX}{host_index}.json")


class Heartbeat:
    """Throttled status writer (at most one write per `min_interval_s`)."""

    def __init__(self, directory: str, host_index: int = 0,
                 min_interval_s: float = 1.0):
        self.dir = directory
        self.host_index = int(host_index)
        self.min_interval_s = float(min_interval_s)
        self._last = 0.0

    def maybe_beat(self, status: dict) -> None:
        now = time.monotonic()
        if now - self._last < self.min_interval_s:
            return
        self._last = now
        self.beat(status)

    def beat(self, status: dict, final: bool = False) -> None:
        payload = {**status, "host": self.host_index, "pid": os.getpid(),
                   "ts": time.time(), "final": bool(final)}
        tmp = _path(self.dir, self.host_index) + ".tmp"
        try:
            with open(tmp, "w") as f:
                json.dump(payload, f)
            os.replace(tmp, _path(self.dir, self.host_index))
        except OSError:
            pass  # liveness reporting must never fail the run


def write(directory: str, status: dict, host_index: int = 0) -> None:
    """One unthrottled heartbeat write (standalone writers)."""
    os.makedirs(directory, exist_ok=True)
    Heartbeat(directory, host_index=host_index).beat(status)


def read(directory: str, host_index: int = 0) -> dict | None:
    """The host's last status, or None when absent/torn."""
    try:
        with open(_path(directory, host_index)) as f:
            return json.load(f)
    except (OSError, ValueError):
        return None


def read_all(directory: str) -> dict:
    """{host_index: status} for every heartbeat file in the directory."""
    out = {}
    try:
        names = os.listdir(directory)
    except OSError:
        return out
    for name in names:
        if not (name.startswith(FILE_PREFIX) and name.endswith(".json")):
            continue
        try:
            h = int(name[len(FILE_PREFIX):-len(".json")])
        except ValueError:
            continue
        status = read(directory, h)
        if status is not None:
            out[h] = status
    return out


def assess(directory: str, stale_s: float = DEFAULT_STALE_S,
           now: float | None = None) -> dict:
    """Liveness verdict over every host's heartbeat in the obs directory.

    Returns {"state": "missing"|"done"|"alive"|"wedged", "age_s", "hosts"}:
    `alive` = every heartbeat is fresh (the run may be slow, but spans are
    still closing); `wedged` = at least one NON-final host's last event is
    older than `stale_s` — a host that wrote its final beat is finished, not
    stuck, however old that beat is (an all-final set is "done", so a
    final-but-old host must never flip a still-working peer's run to
    "wedged"); `done` = every host wrote its final beat.  Hosts whose
    clocks run ahead of the assessor's produce negative ages, which are
    trivially fresh.  Hosts beating ``mode="serve"`` are exempt from the
    wedge check: a serving process is a long-lived idle loop with no pass
    progress by design, so an old-but-not-final serve beat means "idle",
    never "stuck" (its staleness is the watcher's SERVING-STALE concern,
    not a liveness verdict).
    """
    beats = read_all(directory)
    if not beats:
        return {"state": "missing", "age_s": None, "hosts": {}}
    now = time.time() if now is None else now
    ages = {h: round(now - b.get("ts", 0.0), 1) for h, b in beats.items()}
    if all(b.get("final") for b in beats.values()):
        state = "done"
    elif any(age > stale_s for h, age in ages.items()
             if not beats[h].get("final")
             and beats[h].get("mode") != "serve"):
        state = "wedged"
    else:
        state = "alive"
    return {"state": state, "age_s": max(ages.values()),
            "hosts": {h: {**beats[h], "age_s": ages[h]} for h in beats}}
