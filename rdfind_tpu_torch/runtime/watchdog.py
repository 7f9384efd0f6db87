"""In-run collective watchdog: a wedged collective becomes a recoverable
preemption instead of a silent multi-hour hang.

The pipeline survives preemption (elastic resume), corruption (the integrity
plane) and cap exhaustion (the degradation ladder); a *hung* collective would
otherwise block a run forever.  This module is the inside observer.  Every
host-side collective dispatch / blocking pull wraps itself in
``collective(site, nbytes)`` — a deadman
timer registered with one per-process monitor thread.  The timeout scales
with the payload: ``max(RDFIND_COLLECTIVE_TIMEOUT_S, slack * nbytes /
link_capacity)`` where the capacity is the measured ``mesh.link_probe``
peak when one exists (so a 10 GiB exchange is never declared wedged on the
floor a 40-byte vote uses).  On expiry the monitor:

  1. dumps the flight recorder and flushes every registered ProgressStore
     (the committed passes survive),
  2. stamps a ``wedged@<site>`` degradation + heartbeat status (with
     ``recovering`` set, so ``tpu_watch --status`` reports RECOVERING) and
     writes a **wedge marker** file into the obs directory,
  3. converts the hang into the existing ``faults.Preempted`` contract —
     raised inside the blocked thread via the async-exception channel (a
     Python-level wait converts immediately; injected wedges and polling
     loops are Python-level) — so the launcher's supervisor re-enters via
     elastic resume on whatever capacity still answers,
  4. if the thread is stuck in a C-level collective that Python cannot
     interrupt (a wedged gloo or NCCL call), escalates after a grace period
     to the process form of the same contract: flush + ``os._exit(75)``
     (EX_TEMPFAIL), which the launcher reads as a preempted rank.
     Escalation arms only in a mesh of more than one rank (or with
     ``RDFIND_WATCHDOG_EXIT=1``) — a single-process test must never lose its
     interpreter.

Peer coordination rides the heartbeat directory: every fire writes
``wedge-host<N>.json`` there, and each host's monitor polls for peers'
markers — a host that sees one while armed on the *matching* site aborts
its own collective immediately instead of waiting out its full timer, so
all hosts exit the collective together rather than deadlocking on the next
barrier.

On by default in a mesh of more than one rank (every rank is a process, and
a peer can wedge); ``RDFIND_WATCHDOG=1`` forces it on (tests), ``0`` forces it
off.  The disabled path is one env read + one branch per dispatch.

Telemetry: ``stats["watchdog"]`` (armed/fired/near-miss/peer-abort
counters, per-site max observed wait), per-site wait histograms in the
metrics registry (Prometheus summaries ride the standard exposition), and
trace instants for fires and near-misses.
"""

from __future__ import annotations

import ctypes
import json
import os
import threading
import time

from ..obs import flightrec, metrics, tracer

MARKER_PREFIX = "wedge-host"

# Collective sites armed by the pipelines — the registry runtime/faults.py
# derives its wedge@<site> injection sites from, and the chaos sweep
# parametrizes over.  Names follow the exchange ledger where one exists.
COLLECTIVE_SITES = (
    "freq",          # P2 line-build: frequency + exchange-A dispatch/pull
    "captures",      # P3 exchange-B dispatch/pull
    "rebalance",     # P2b hot-line move dispatch/pull
    "pairs",         # pass-executor counters/blocks pull (exchange C + giant)
    "sketch",        # sharded half-approx count-min allreduce
    "pass_commit",   # the coalesced per-pass allgather (skew + digest agree)
    "resume_vote",   # elastic-resume snapshot vote
    "allgather",     # any other mesh.allgather_host_values rider
    "init",          # the process-group rendezvous
)

_DEFAULT_TIMEOUT_S = 120.0
_WIRE_SLACK = 16.0     # timeout = max(floor, slack * nbytes / capacity)
_POLL_MAX_S = 0.5

_LOCK = threading.Lock()
_ARMED: dict[int, "_Guard"] = {}
_NEXT_ID = 0
_MONITOR: threading.Thread | None = None
_WAKE = threading.Event()
_FIRED_SITES: dict[str, str] = {}   # site -> reason (this process, this run)
_STATS_SINK: dict | None = None     # the live run's stats dict (bind_stats)

_COUNTS = {"armed": 0, "fired": 0, "near_miss": 0, "peer_aborts": 0}
_SITE_MAX_WAIT: dict[str, float] = {}


def _multi_rank() -> bool:
    """Whether this process is one rank of a mesh of several.  Never
    initializes anything: reads the launcher's mesh only when one exists."""
    import sys
    mesh = sys.modules.get("rdfind_tpu_torch.parallel.mesh")
    return mesh is not None and mesh.world_size() > 1


def enabled() -> bool:
    """Armed?  RDFIND_WATCHDOG=1 forces on, 0 forces off; by default on
    exactly when this process is one rank of a multi-rank mesh."""
    knob = os.environ.get("RDFIND_WATCHDOG", "").strip().lower()
    if knob in ("0", "off", "false"):
        return False
    if knob in ("1", "on", "force", "true"):
        return True
    return _multi_rank()


def timeout_floor_s() -> float:
    try:
        return float(os.environ.get("RDFIND_COLLECTIVE_TIMEOUT_S",
                                    str(_DEFAULT_TIMEOUT_S)))
    except ValueError:
        return _DEFAULT_TIMEOUT_S


def timeout_s(nbytes: int = 0) -> float:
    """Deadman timeout for a collective moving `nbytes`: the configured
    floor, stretched when the payload's wire time at the measured
    link_probe capacity (slowest hop) approaches it.  With no probe cached
    the floor alone applies — a never-measured link must not invent a
    capacity."""
    floor = timeout_floor_s()
    if nbytes <= 0:
        return floor
    caps = metrics.link_caps()
    gbps = [caps[k] for k in ("dcn_gbps", "ici_gbps")
            if isinstance(caps.get(k), (int, float)) and caps[k] > 0]
    if not gbps:
        return floor
    wire_s = nbytes / (min(gbps) * 1e9)
    return max(floor, _WIRE_SLACK * wire_s)


def _near_miss_frac() -> float:
    try:
        return float(os.environ.get("RDFIND_WATCHDOG_NEARMISS_FRAC", "0.5"))
    except ValueError:
        return 0.5


def _hard_exit_allowed() -> bool:
    knob = os.environ.get("RDFIND_WATCHDOG_EXIT", "").strip().lower()
    if knob in ("0", "off", "false"):
        return False
    if knob in ("1", "on", "force", "true"):
        return True
    return _multi_rank()


def _grace_s() -> float:
    try:
        return float(os.environ.get("RDFIND_WATCHDOG_GRACE_S", "20"))
    except ValueError:
        return 20.0


def _obs_dir() -> str | None:
    """Where wedge markers live: the armed trace/heartbeat directory, or an
    explicit RDFIND_WATCHDOG_DIR (tests, untraced runs)."""
    return os.environ.get("RDFIND_WATCHDOG_DIR") or tracer.trace_dir()


def _host_index() -> int:
    tr = tracer.current()
    if tr is not None:
        return tr.host_index
    return tracer.default_host_index()


def bind_stats(stats: dict | None) -> None:
    """Point the fire path's degradation ledger at the live run's stats
    dict (the watchdog is process-global; stats are per-run)."""
    global _STATS_SINK
    _STATS_SINK = stats


class _NullGuard:
    """Shared disabled-path context manager (one instance, no state)."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NULL_GUARD = _NullGuard()


class _Guard:
    """One armed collective: registers a deadline on entry, records the
    observed wait (near-miss accounting, per-site histogram) on exit."""

    __slots__ = ("site", "nbytes", "timeout", "t0", "deadline", "tid",
                 "token", "fired", "fired_at", "reason")

    def __init__(self, site: str, nbytes: int):
        self.site = site
        self.nbytes = int(nbytes)
        self.timeout = timeout_s(nbytes)
        self.fired = False
        self.fired_at = 0.0
        self.reason = ""

    def __enter__(self):
        global _NEXT_ID
        self.t0 = time.monotonic()
        self.deadline = self.t0 + self.timeout
        self.tid = threading.get_ident()
        with _LOCK:
            _NEXT_ID += 1
            self.token = _NEXT_ID
            _ARMED[self.token] = self
            _COUNTS["armed"] += 1
        _ensure_monitor()
        _WAKE.set()
        try:
            # The deterministic wedge fault (one host sleeps "forever"
            # inside the collective) lives INSIDE the armed window, so the
            # deadman covers it exactly like a real wedge.
            from . import faults
            faults.maybe_wedge(self.site)
        except BaseException:
            self._disarm()
            raise
        return self

    def __exit__(self, exc_type, exc, tb):
        self._disarm()
        return False

    def _disarm(self):
        with _LOCK:
            _ARMED.pop(self.token, None)
        wait = time.monotonic() - self.t0
        prev = _SITE_MAX_WAIT.get(self.site, 0.0)
        if wait > prev:
            _SITE_MAX_WAIT[self.site] = wait
        metrics.observe(f"watchdog_wait_s_{self.site}", wait)
        if not self.fired and wait >= _near_miss_frac() * self.timeout:
            with _LOCK:
                _COUNTS["near_miss"] += 1
            tracer.instant("watchdog_near_miss", cat=tracer.CAT_EXCHANGE,
                           site=self.site, waited_s=round(wait, 3),
                           timeout_s=round(self.timeout, 3))


def collective(site: str, nbytes: int = 0, force: bool = False):
    """Arm the deadman around one collective dispatch/blocking pull.

    Usage: ``with watchdog.collective("pairs", nbytes): <dispatch+pull>``.
    The disabled path (single-host, or RDFIND_WATCHDOG=0) returns a shared
    no-op after one check.  `force=True` arms regardless (the
    rendezvous knows it is multi-process before the mesh exists)."""
    if not (force or enabled()):
        return _NULL_GUARD
    return _Guard(site, nbytes)


def fired(site: str | None = None) -> bool:
    """Whether the watchdog has fired (at `site`, or anywhere) in this
    process — cooperative waiters poll this to convert promptly."""
    with _LOCK:
        if site is None:
            return bool(_FIRED_SITES)
        return site in _FIRED_SITES


def snapshot() -> dict:
    """The stats["watchdog"] payload."""
    with _LOCK:
        out = dict(_COUNTS)
        out["enabled"] = enabled()
        out["timeout_floor_s"] = timeout_floor_s()
        out["max_wait_s"] = {s: round(w, 3)
                             for s, w in sorted(_SITE_MAX_WAIT.items())}
        if _FIRED_SITES:
            out["fired_sites"] = dict(_FIRED_SITES)
        return out


def publish(stats: dict | None) -> None:
    """Land the watchdog struct in a run's stats (driver/pipeline exit)."""
    metrics.struct_set(stats, "watchdog", snapshot())


def reset() -> None:
    """Forget fires/counters (tests; run boundaries keep cumulative)."""
    with _LOCK:
        _FIRED_SITES.clear()
        _SITE_MAX_WAIT.clear()
        for k in _COUNTS:
            _COUNTS[k] = 0


def clear_fired() -> None:
    """Forget fired sites but keep counters — the supervisor calls this
    (with clear_markers) before re-entering, so the recovered attempt's
    collectives are not insta-aborted by the stale fire state."""
    with _LOCK:
        _FIRED_SITES.clear()


def wedge_wait(site: str, hard: bool = False) -> None:
    """The injected wedge's sleep-"forever" loop (faults.maybe_wedge):
    blocks inside the armed collective window until the watchdog's fire
    path delivers Preempted through the async-exception channel — the SAME
    conversion a real Python-level wedge takes, never a shortcut (and never
    a second raise: a self-raised Preempted would leave the async one
    pending, to detonate at some later bytecode mid-recovery).  A hard cap
    bounds the worst case so a misconfigured test (wedge armed, watchdog
    off) fails loudly instead of hanging the suite.  `hard`: one sleep in C
    until the cap, which the async exception cannot interrupt: the shape of
    a wedged gloo or NCCL call, which only the hard exit ends."""
    cap = time.monotonic() + 8.0 * timeout_floor_s() + 30.0
    if hard:
        time.sleep(cap - time.monotonic())
    while True:
        if time.monotonic() > cap:
            raise RuntimeError(
                f"wedge@{site}: watchdog never fired within the safety cap "
                f"(is RDFIND_WATCHDOG armed?)")
        time.sleep(0.02)


# ---------------------------------------------------------------------------
# Wedge markers (peer coordination through the heartbeat directory).
# ---------------------------------------------------------------------------


def _marker_path(directory: str, host: int) -> str:
    return os.path.join(directory, f"{MARKER_PREFIX}{host}.json")


def _host_writer() -> bool:
    """Markers are host-level files: a host's local rank 0 writes them."""
    import sys
    mesh = sys.modules.get("rdfind_tpu_torch.parallel.mesh")
    cur = mesh.current() if mesh is not None else None
    return cur is None or cur.host_primary


def write_marker(site: str, reason: str = "timeout",
                 directory: str | None = None) -> None:
    directory = directory or _obs_dir()
    if not directory or not _host_writer():
        return
    host = _host_index()
    payload = {"site": site, "host": host, "reason": reason,
               "ts": time.time(), "pid": os.getpid()}
    try:
        os.makedirs(directory, exist_ok=True)
        tmp = _marker_path(directory, host) + ".tmp"
        with open(tmp, "w") as f:
            json.dump(payload, f)
        os.replace(tmp, _marker_path(directory, host))
    except OSError:
        pass  # coordination is best-effort; the local timer still bounds us


def read_markers(directory: str | None = None) -> dict:
    """{host: marker} for every wedge marker in the obs directory."""
    directory = directory or _obs_dir()
    out: dict[int, dict] = {}
    if not directory:
        return out
    try:
        names = os.listdir(directory)
    except OSError:
        return out
    for name in names:
        if not (name.startswith(MARKER_PREFIX) and name.endswith(".json")):
            continue
        try:
            host = int(name[len(MARKER_PREFIX):-len(".json")])
            with open(os.path.join(directory, name)) as f:
                out[host] = json.load(f)
        except (OSError, ValueError):
            continue
    return out


def clear_markers(directory: str | None = None) -> None:
    """Drop stale markers (run start / supervisor re-entry — a marker from
    the wedge just recovered from must not abort the new attempt)."""
    directory = directory or _obs_dir()
    if not directory:
        return
    for host in list(read_markers(directory)):
        try:
            os.unlink(_marker_path(directory, host))
        except OSError:
            pass


# ---------------------------------------------------------------------------
# The monitor thread + the fire path.
# ---------------------------------------------------------------------------


def _ensure_monitor() -> None:
    global _MONITOR
    with _LOCK:
        if _MONITOR is not None and _MONITOR.is_alive():
            return
        _MONITOR = threading.Thread(target=_monitor_loop,
                                    name="rdfind-watchdog", daemon=True)
        _MONITOR.start()


def _monitor_loop() -> None:
    while True:
        with _LOCK:
            guards = list(_ARMED.values())
        now = time.monotonic()
        if guards:
            markers = read_markers()
            me = _host_index()
            peer_sites = {m.get("site") for h, m in markers.items()
                          if h != me}
            for g in guards:
                if g.fired:
                    if (now - g.fired_at > _grace_s()
                            and _hard_exit_allowed()):
                        _hard_exit(g)
                    continue
                if now >= g.deadline:
                    _fire(g, f"timeout after {g.timeout:.1f}s")
                elif g.site in peer_sites:
                    with _LOCK:
                        _COUNTS["peer_aborts"] += 1
                    _fire(g, "peer wedge marker", peer=True)
        # Sleep until the nearest deadline (or a new arm wakes us).
        with _LOCK:
            pend = [g.deadline for g in _ARMED.values() if not g.fired]
        delay = _POLL_MAX_S
        if pend:
            delay = min(delay, max(0.02, min(pend) - time.monotonic()))
        _WAKE.wait(timeout=delay)
        _WAKE.clear()


def _fire(g: "_Guard", reason: str, peer: bool = False) -> None:
    """The recovery sequence: evidence out, progress safe, status stamped,
    then the hang becomes Preempted."""
    from . import checkpoint, faults

    with _LOCK:
        if g.token not in _ARMED:
            return  # the collective completed between the scan and the fire
    g.fired = True
    g.fired_at = time.monotonic()
    g.reason = reason
    with _LOCK:
        _COUNTS["fired"] += 1
        _FIRED_SITES[g.site] = reason
    waited = round(g.fired_at - g.t0, 3)
    tracer.instant("watchdog_fired", cat=tracer.CAT_EXCHANGE, site=g.site,
                   reason=reason, waited_s=waited,
                   timeout_s=round(g.timeout, 3), nbytes=g.nbytes)
    if not peer:
        # A peer-marker abort must not re-mark: the originating host's
        # marker is the coordination signal, and overwriting it with ours
        # would ping-pong "peer" reasons forever.
        write_marker(g.site, reason)
    flightrec.dump(reason=f"watchdog wedged@{g.site}: {reason}")
    try:
        checkpoint.flush_all_progress()
    except Exception:
        pass  # progress flush is best-effort; resume re-verifies anyway
    faults.record_degradation(_STATS_SINK, "watchdog", f"wedged@{g.site}",
                              reason=reason, waited_s=waited)
    tracer.set_status(watchdog=f"wedged@{g.site}", recovering=True)
    tracer.heartbeat_now()
    # Deliver Preempted to the blocked thread.  Python-level waits (the
    # injected wedge sleep, polling loops) convert at their next bytecode;
    # a C-level block ignores this and the grace-period escalation owns it.
    exc = faults.Preempted(f"watchdog: collective wedged@{g.site} "
                           f"({reason}, waited {waited}s)")
    try:
        ctypes.pythonapi.PyThreadState_SetAsyncExc(
            ctypes.c_ulong(g.tid), ctypes.py_object(type(exc)))
    except Exception:
        pass


def _hard_exit(g: "_Guard") -> None:
    """The escalation rung: the blocked thread never surfaced Preempted
    (C-level wedge), so take the process form of the same contract —
    flush, then EX_TEMPFAIL for the orchestrator to restart us."""
    from . import checkpoint

    flightrec.dump(reason=f"watchdog hard-exit wedged@{g.site}")
    try:
        checkpoint.flush_all_progress()
    except Exception:
        pass
    tracer.set_status(watchdog=f"wedged@{g.site}", recovering=True)
    tracer.heartbeat_now()
    os._exit(75)
