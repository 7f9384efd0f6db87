"""Per-request serving telemetry + the freshness/SLO engine.

The metrics registry takes an RLock per observation — fine for a discovery
run's per-pass cadence, fatal on a query plane answering 100k+ QPS.  This
module is the serving process's hot-path telemetry: every request lands in
a **per-thread shard** (plain dict increments under the GIL — no lock, no
allocation beyond the first touch), and the shards are merged only when a
scrape, the /slo endpoint, or the SLO engine asks.  What it records, per
endpoint (``holds``/``referenced``/``topk``) × outcome
(``ok``/``400``/``503``/``refused``):

  * request counters (Prometheus: ``rdfind_serve_requests_total``);
  * log2^0.25-bucketed latency histograms for ok answers, bit-identical to
    the registry's bucketing (metrics.hist_bucket), with p50/p95/p99
    derived at exposition time — never on the query path;
  * a bounded slow-query ring (the flightrec idiom: a deque whose append
    is atomic) holding args + latency + generation of every query slower
    than ``RDFIND_SERVE_OBS_SLOW_US``, served at ``/debug/slowlog`` and
    dumped to ``slowlog-host<N>.json`` on SIGTERM.

The SLO engine evaluates three targets over the sharded counters:

  * ``RDFIND_SLO_P99_US``   — ok-answer p99 latency ceiling;
  * ``RDFIND_SLO_ERROR_FRAC`` — non-200 fraction ceiling;
  * ``RDFIND_SLO_STALENESS_S`` — freshness ceiling (IndexService's
    bundle-commit → serving-swap lag, live-growing while a swap is
    pending or refused).

Rate targets use two burn windows (``RDFIND_SLO_FAST_S`` /
``RDFIND_SLO_SLOW_S``): **burning** means both windows exceed the target
(a sustained burn — pageable), one window alone is **warn** (a spike or a
tail still draining — visible, not pageable), which is what keeps a
flapping error burst from paging.  Windows are diffs between cumulative
snapshots the engine keeps itself; an empty window or a skewed clock
(snapshot from the future) yields no verdict rather than a false one.
The verdict is named — {"state", "slo"} — and lands on the heartbeat,
``/status``, and ``/slo``.

``RDFIND_SERVE_OBS=0`` disables recording entirely; answers are
bit-identical either way (recording never touches the payload), which
bench_serve.py and scripts/serve_obs_parity.py assert.

The JAX package's ``obs/servestats.py``, copied, with one repair: a scrape
reads each shard's latency histogram before its request counters.  ``record``
bumps the counter first, so the reverse order could see a latency sample whose
request it had not yet counted (``count > requests`` in a torn scrape).

Stdlib-only (the obs contract).
"""

from __future__ import annotations

import collections
import json
import math
import os
import threading
import time

from . import metrics

ENDPOINTS = ("holds", "referenced", "topk")
OUTCOMES = ("ok", "400", "503", "refused")

DEFAULT_SLOW_US = 10_000.0
DEFAULT_SLOWLOG_EVENTS = 64
DEFAULT_FAST_S = 60.0
DEFAULT_SLOW_S = 600.0
SLOWLOG_PREFIX = "slowlog-host"

# Module-level fast gate (the flightrec idiom): the query path checks a
# plain bool, never the environment.
_ENABLED = True
_SLOW_US = DEFAULT_SLOW_US
_SLOWLOG: collections.deque = collections.deque(
    maxlen=DEFAULT_SLOWLOG_EVENTS)
_HOST = 0

# Shard registry: the lock guards only shard creation and the scrape-side
# list copy — never a record() call.  _EPOCH invalidates thread-local
# shards across reset() so a long-lived handler thread re-registers.
_SHARDS: list["_Shard"] = []
_SHARDS_LOCK = threading.Lock()
_EPOCH = 0
_TLS = threading.local()


class _Shard:
    """One thread's private counters: (endpoint, outcome) -> count, and
    endpoint -> [count, total_us, min_us, max_us, {bucket: count}]."""

    __slots__ = ("epoch", "counts", "lat")

    def __init__(self, epoch: int):
        self.epoch = epoch
        self.counts: dict = {}
        self.lat: dict = {}


def configure(host_index: int | None = None) -> bool:
    """(Re-)read the env knobs; returns whether recording is on.  Called at
    import, by the serving process at startup, and by tests/benches after
    flipping RDFIND_SERVE_OBS."""
    global _ENABLED, _SLOW_US, _SLOWLOG, _HOST
    if host_index is not None:
        _HOST = int(host_index)
    _ENABLED = os.environ.get("RDFIND_SERVE_OBS", "").strip() != "0"
    try:
        _SLOW_US = max(0.0, float(
            os.environ.get("RDFIND_SERVE_OBS_SLOW_US", "")
            or DEFAULT_SLOW_US))
    except ValueError:
        _SLOW_US = DEFAULT_SLOW_US
    try:
        cap = int(os.environ.get("RDFIND_SERVE_OBS_SLOWLOG", "")
                  or DEFAULT_SLOWLOG_EVENTS)
    except ValueError:
        cap = DEFAULT_SLOWLOG_EVENTS
    cap = max(1, cap)
    if _SLOWLOG.maxlen != cap:
        _SLOWLOG = collections.deque(_SLOWLOG, maxlen=cap)
    return _ENABLED


def enabled() -> bool:
    return _ENABLED


def reset() -> None:
    """Drop every shard, the slowlog, and the SLO engine's history (run
    boundaries, tests).  Live threads re-register on their next record."""
    global _EPOCH, _ENGINE
    with _SHARDS_LOCK:
        _EPOCH += 1
        _SHARDS.clear()
    _SLOWLOG.clear()
    _ENGINE = None


def _shard() -> _Shard:
    s = getattr(_TLS, "shard", None)
    if s is None or s.epoch != _EPOCH:
        s = _TLS.shard = _Shard(_EPOCH)
        with _SHARDS_LOCK:
            if s.epoch == _EPOCH:
                _SHARDS.append(s)
    return s


def record(endpoint: str, outcome: str, us: float | None = None,
           generation=None, args=None) -> None:
    """The hot path: one dict increment (plus one histogram increment and
    a min/max fold for ok answers).  No lock, no registry, no allocation
    after a thread's first touch."""
    if not _ENABLED:
        return
    s = _shard()
    key = (endpoint, outcome)
    s.counts[key] = s.counts.get(key, 0) + 1
    if us is None:
        return
    lat = s.lat.get(endpoint)
    if lat is None:
        lat = s.lat[endpoint] = [0, 0.0, math.inf, -math.inf, {}]
    b = metrics.hist_bucket(us)
    buckets = lat[4]
    buckets[b] = buckets.get(b, 0) + 1
    lat[0] += 1
    lat[1] += us
    if us < lat[2]:
        lat[2] = us
    if us > lat[3]:
        lat[3] = us
    if us >= _SLOW_US:
        # deque.append is atomic; the ring bounds itself.
        _SLOWLOG.append({"endpoint": endpoint, "us": round(us, 1),
                         "generation": generation, "args": args,
                         "ts": round(time.time(), 3)})


# ---------------------------------------------------------------------------
# Scrape-side aggregation (merges the shards; holds only _SHARDS_LOCK for
# the list copy — concurrent record() calls keep landing while we read).
# ---------------------------------------------------------------------------


def _merged() -> tuple[dict, dict]:
    """(counts, lat): counts maps (endpoint, outcome) -> n; lat maps
    endpoint -> [total_us, min_us, max_us, {bucket: count}].  Histogram
    counts are derived from the bucket sums, so a scrape racing a storm is
    internally consistent (count == sum(buckets)), never torn."""
    with _SHARDS_LOCK:
        shards = list(_SHARDS)
    counts: dict = {}
    lat: dict = {}
    for s in shards:
        # Histogram first, counters second: record() bumps the counter before
        # the histogram, so every sample read here has its request counted by
        # the time the counters are read (latency count <= requests).
        for ep, row in list(s.lat.items()):
            agg = lat.setdefault(ep, [0.0, math.inf, -math.inf, {}])
            agg[0] += row[1]
            agg[1] = min(agg[1], row[2])
            agg[2] = max(agg[2], row[3])
            for b, n in list(row[4].items()):
                agg[3][b] = agg[3].get(b, 0) + n
        for k, v in list(s.counts.items()):
            counts[k] = counts.get(k, 0) + v
    return counts, lat


def aggregate() -> dict:
    """The merged view: per endpoint×outcome request counters, per-endpoint
    latency summaries with exposition-time p50/p95/p99, and the total /
    error fraction the SLO engine burns against."""
    counts, lat = _merged()
    requests: dict = {}
    total = errors = 0
    for (ep, oc), n in counts.items():
        requests.setdefault(ep, {})[oc] = (
            requests.get(ep, {}).get(oc, 0) + n)
        total += n
        if oc != "ok":
            errors += n
    latency: dict = {}
    for ep, (tot, mn, mx, buckets) in sorted(lat.items()):
        n = sum(buckets.values())
        if not n:
            continue
        row = {"count": n, "sum": round(tot, 3),
               "min": round(mn, 3), "max": round(mx, 3),
               "mean": round(tot / n, 3)}
        for q in metrics.QUANTILES:
            v = metrics.bucket_quantile(buckets, q, vmin=mn, vmax=mx)
            row[f"p{int(q * 100)}"] = round(v, 3) if v is not None else None
        latency[ep] = row
    return {"enabled": _ENABLED, "requests": requests,
            "latency_us": latency, "total": total, "errors": errors,
            "error_frac": round(errors / total, 6) if total else 0.0}


def prometheus_text(prefix: str = "rdfind_") -> str:
    """Prometheus text exposition of the sharded stats (appended to the
    registry's exposition by the serve console's /metrics)."""
    counts, lat = _merged()
    lines: list[str] = []
    name = f"{prefix}serve_requests_total"
    lines.append(f"# TYPE {name} counter")
    for (ep, oc) in sorted(counts):
        lines.append(f'{name}{{endpoint="{ep}",outcome="{oc}"}} '
                     f"{counts[(ep, oc)]}")
    for ep in sorted(lat):
        tot, mn, mx, buckets = lat[ep]
        n = sum(buckets.values())
        base = f"{prefix}serve_{ep}_latency_us"
        lines.append(f"# TYPE {base} summary")
        for q in metrics.QUANTILES:
            v = metrics.bucket_quantile(buckets, q, vmin=mn, vmax=mx)
            if v is not None:
                lines.append(f'{base}{{quantile="{q}"}} {v}')
        lines.append(f"{base}_count {n}")
        lines.append(f"{base}_sum {tot}")
    return "\n".join(lines) + "\n"


# ---------------------------------------------------------------------------
# Slow-query ring.
# ---------------------------------------------------------------------------


def slow_us() -> float:
    return _SLOW_US


def slowlog() -> list[dict]:
    """The ring's contents, oldest first (/debug/slowlog)."""
    return list(_SLOWLOG)


def dump_path(directory: str, host_index: int | None = None) -> str:
    h = _HOST if host_index is None else host_index
    return os.path.join(directory, f"{SLOWLOG_PREFIX}{h}.json")


def dump_slowlog(directory: str | None = None, reason: str = "") -> str | None:
    """Atomically write the slow-query ring (SIGTERM / shutdown path).
    Never raises — dump sites are signal handlers."""
    if not _ENABLED:
        return None
    try:
        out_dir = directory or "."
        entries = slowlog()
        payload = {"host": _HOST, "reason": reason,
                   "dumped_at": round(time.time(), 3),
                   "slow_us": _SLOW_US,
                   "n_entries": len(entries), "entries": entries}
        os.makedirs(out_dir, exist_ok=True)
        path = dump_path(out_dir)
        tmp = f"{path}.tmp.{os.getpid()}"
        with open(tmp, "w") as f:
            json.dump(payload, f, default=str)
        os.replace(tmp, path)
        return path
    except Exception:
        return None


# ---------------------------------------------------------------------------
# The SLO engine: fast/slow burn windows over the sharded counters.
# ---------------------------------------------------------------------------


def _env_float(name: str, default: float) -> float:
    try:
        v = os.environ.get(name, "").strip()
        return float(v) if v else default
    except ValueError:
        return default


class SloEngine:
    """Named SLO verdicts from cumulative snapshots of the shard merge.

    ``evaluate()`` takes one snapshot (throttled), then compares the
    current totals against the snapshot nearest each window's start.  A
    target is **burning** only when the fast AND slow windows both exceed
    it; one window alone is **warn**.  Staleness is a level, not a rate:
    it burns when the server is generations behind for longer than the
    target allows.  Thresholds <= 0 disable their target."""

    def __init__(self, p99_us: float | None = None,
                 error_frac: float | None = None,
                 staleness_s: float | None = None,
                 fast_s: float | None = None, slow_s: float | None = None):
        self.p99_us = (_env_float("RDFIND_SLO_P99_US", 0.0)
                       if p99_us is None else float(p99_us))
        self.error_frac = (_env_float("RDFIND_SLO_ERROR_FRAC", 0.0)
                           if error_frac is None else float(error_frac))
        self.staleness_s = (_env_float("RDFIND_SLO_STALENESS_S", 0.0)
                            if staleness_s is None else float(staleness_s))
        self.fast_s = max(1.0, _env_float("RDFIND_SLO_FAST_S",
                                          DEFAULT_FAST_S)
                          if fast_s is None else float(fast_s))
        self.slow_s = max(self.fast_s,
                          _env_float("RDFIND_SLO_SLOW_S", DEFAULT_SLOW_S)
                          if slow_s is None else float(slow_s))
        # (ts, total, errors, {bucket: count}) cumulative snapshots.
        self.history: collections.deque = collections.deque(maxlen=1024)
        self.last: dict | None = None

    def config(self) -> dict:
        return {"p99_us": self.p99_us, "error_frac": self.error_frac,
                "staleness_s": self.staleness_s,
                "fast_s": self.fast_s, "slow_s": self.slow_s}

    # -- snapshots -----------------------------------------------------------

    @staticmethod
    def _snap(now: float) -> tuple:
        counts, lat = _merged()
        total = sum(counts.values())
        errors = sum(n for (ep, oc), n in counts.items() if oc != "ok")
        buckets: dict = {}
        for ep, row in lat.items():
            for b, n in row[3].items():
                buckets[b] = buckets.get(b, 0) + n
        return (now, total, errors, buckets)

    def observe_snapshot(self, now: float | None = None,
                         snap: tuple | None = None) -> None:
        """Append one cumulative snapshot (throttled to >= 0.5s spacing;
        snapshots from a skewed — backwards — clock are dropped)."""
        now = time.time() if now is None else now
        snap = self._snap(now) if snap is None else snap
        if self.history and now - self.history[-1][0] < 0.5:
            return
        if self.history and now < self.history[-1][0]:
            return  # clock went backwards; never record a negative window
        self.history.append(snap)

    def _window(self, cur: tuple, now: float, w: float) -> tuple | None:
        """The cumulative diff over the trailing `w` seconds: (dt, total,
        errors, {bucket: count}), or None when the window is empty.  A
        history shorter than the window bootstraps from its oldest
        snapshot (a young server's "slow window" is its whole life)."""
        base = None
        for s in self.history:
            if s[0] > now:
                continue  # future snapshot (clock skew): unusable
            if s[0] <= now - w:
                base = s  # newest snapshot at/before the window start
            elif base is None:
                base = s  # bootstrap: oldest usable snapshot
                break
            else:
                break
        if base is None:
            return None
        dt = now - base[0]
        total = cur[1] - base[1]
        if dt <= 0 or total <= 0:
            return None
        errors = cur[2] - base[2]
        buckets = {b: n - base[3].get(b, 0)
                   for b, n in cur[3].items()
                   if n - base[3].get(b, 0) > 0}
        return (dt, total, errors, buckets)

    # -- the verdict ---------------------------------------------------------

    def evaluate(self, freshness: dict | None = None,
                 now: float | None = None) -> dict:
        """The named verdict: {"state": ok|warn|burning, "slo": name|None,
        "detail": {...}}.  Worst target wins; burning beats warn."""
        now = time.time() if now is None else now
        cur = self._snap(now)
        self.observe_snapshot(now=now, snap=cur)
        fast = self._window(cur, now, self.fast_s)
        slow = self._window(cur, now, self.slow_s)
        verdicts: list[tuple[str, str, dict]] = []

        if self.error_frac > 0:
            f_frac = fast[2] / fast[1] if fast else None
            s_frac = slow[2] / slow[1] if slow else None
            f_over = f_frac is not None and f_frac > self.error_frac
            s_over = s_frac is not None and s_frac > self.error_frac
            detail = {"fast_frac": round(f_frac, 6) if f_frac is not None
                      else None,
                      "slow_frac": round(s_frac, 6) if s_frac is not None
                      else None, "target": self.error_frac}
            if f_over and s_over:
                verdicts.append(("burning", "error_frac", detail))
            elif f_over or s_over:
                verdicts.append(("warn", "error_frac", detail))

        if self.p99_us > 0:
            f_p99 = (metrics.bucket_quantile(fast[3], 0.99)
                     if fast and fast[3] else None)
            s_p99 = (metrics.bucket_quantile(slow[3], 0.99)
                     if slow and slow[3] else None)
            f_over = f_p99 is not None and f_p99 > self.p99_us
            s_over = s_p99 is not None and s_p99 > self.p99_us
            detail = {"fast_p99_us": round(f_p99, 1) if f_p99 is not None
                      else None,
                      "slow_p99_us": round(s_p99, 1) if s_p99 is not None
                      else None, "target_us": self.p99_us}
            if f_over and s_over:
                verdicts.append(("burning", "p99", detail))
            elif f_over or s_over:
                verdicts.append(("warn", "p99", detail))

        if self.staleness_s > 0 and freshness:
            behind = int(freshness.get("generations_behind") or 0)
            stale = freshness.get("staleness_s")
            detail = {"staleness_s": stale, "generations_behind": behind,
                      "target_s": self.staleness_s}
            if behind > 0 and stale is not None \
                    and stale > self.staleness_s:
                verdicts.append(("burning", "staleness", detail))
            elif behind > 0 or (stale is not None
                                and stale > self.staleness_s):
                verdicts.append(("warn", "staleness", detail))

        state, slo, detail = "ok", None, {}
        for st, name, d in verdicts:
            if st == "burning" and state != "burning":
                state, slo, detail = st, name, d
            elif st == "warn" and state == "ok":
                state, slo, detail = st, name, d
        out = {"state": state, "slo": slo, "detail": detail,
               "windows": {"fast_s": self.fast_s, "slow_s": self.slow_s},
               "evaluated_unix": round(now, 3)}
        self.last = out
        return out


_ENGINE: SloEngine | None = None


def slo_engine() -> SloEngine:
    """The process-wide engine (created from the env on first use)."""
    global _ENGINE
    if _ENGINE is None:
        _ENGINE = SloEngine()
    return _ENGINE


def evaluate_slo(freshness: dict | None = None,
                 now: float | None = None) -> dict:
    return slo_engine().evaluate(freshness=freshness, now=now)


def slo_config() -> dict:
    return slo_engine().config()


configure()
