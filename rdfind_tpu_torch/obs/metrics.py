"""The metrics registry and the publish shims of the port.

Every pipeline site publishes its telemetry through the shims here: each applies
one mutation to the caller's ``stats`` dict (when given) and the same mutation to
the process-wide registry mirror, so

  * every ``stats`` key keeps the value and meaning the JAX package gives it (the
    port's tests compare the dicts of both packages), and
  * the registry serves what the per-run dicts cannot: Prometheus text exposition
    to a file (``--metrics-file``), typed histograms (the driver's
    ``stage_<name>_ms``) and one JSON snapshot.

Names, key groups and the exposition format are the JAX package's
``obs/metrics.py``.  Stdlib only at import time (``runtime/faults.py`` imports
this module).
"""

from __future__ import annotations

import math
import os
import threading

COUNTER = "counter"
GAUGE = "gauge"
STRUCT = "struct"

# Canonical key groups shared by the --debug formatter (obs/report.py) and
# the tests: the JAX package's key names.
DISPATCH_KEYS = ("n_pair_passes", "n_passes_in_flight", "n_host_syncs",
                 "host_sync_ms", "pull_overlap_ms", "n_pair_cap_retries",
                 "cap_p_final")
FAULT_KEYS = ("n_overflow_retries", "n_host_pull_retries", "backoff_ms_total",
              "resumed_passes")
INGEST_KEYS = ("n_threads", "n_units", "n_files", "bytes_read", "read_ms",
               "parse_ms", "intern_ms", "merge_ms", "remap_ms",
               "queue_stalls", "triples_per_sec", "bytes_per_sec")
EXCHANGE_SITE_KEYS = ("calls", "capacity", "lanes", "bytes", "rows_capacity",
                      "overflow_retries")
MEMORY_KEYS = ("in_use_bytes", "peak_bytes", "limit_bytes", "frac",
               "delta_bytes")


# Log-bucketed quantile resolution: each bucket spans a ~19% value range
# (2**0.25), so a reported p50/p95/p99 is within ~10% of the true sample —
# plenty for latency attribution, at O(distinct magnitudes) memory.
_HIST_BASE = 2.0 ** 0.25
_HIST_LOG_BASE = math.log(_HIST_BASE)
_HIST_UNDERFLOW = -(1 << 30)  # single bucket for values <= 0
QUANTILES = (0.5, 0.95, 0.99)


def hist_bucket(value: float) -> int:
    """The log-bucket index ``Histogram.observe`` files `value` under.
    Shared with the serving stats shards (the serving stats shards) so their
    scrape-time quantiles use bit-identical bucketing."""
    if value > 0.0:
        return math.floor(math.log(value) / _HIST_LOG_BASE)
    return _HIST_UNDERFLOW


def bucket_quantile(buckets: dict, q: float, vmin: float | None = None,
                    vmax: float | None = None) -> float | None:
    """Approximate q-quantile of a {bucket_index: count} map (bucket
    midpoint, clamped to [vmin, vmax] when given).  The merge-side twin of
    ``Histogram.quantile`` for histograms aggregated across shards."""
    count = sum(buckets.values())
    if not count:
        return None
    rank = q * (count - 1)
    acc = 0
    for b in sorted(buckets):
        acc += buckets[b]
        if acc > rank:
            if b == _HIST_UNDERFLOW:
                return vmin if vmin is not None else 0.0
            mid = (_HIST_BASE ** b + _HIST_BASE ** (b + 1)) / 2.0
            if vmin is not None:
                mid = max(mid, vmin)
            if vmax is not None:
                mid = min(mid, vmax)
            return mid
    return vmax if vmax is not None else None


class Histogram:
    """Fixed-size summary of an observation stream (no per-sample storage);
    sparse log buckets give approximate quantiles."""

    __slots__ = ("count", "total", "min", "max", "_buckets")

    def __init__(self):
        self.count = 0
        self.total = 0.0
        self.min = math.inf
        self.max = -math.inf
        self._buckets: dict[int, int] = {}

    def observe(self, value: float) -> None:
        value = float(value)
        self.count += 1
        self.total += value
        self.min = min(self.min, value)
        self.max = max(self.max, value)
        b = hist_bucket(value)
        self._buckets[b] = self._buckets.get(b, 0) + 1

    def quantile(self, q: float) -> float | None:
        """Approximate q-quantile from the log buckets (bucket midpoint,
        clamped to the observed [min, max] so p99 never exceeds max)."""
        if not self.count:
            return None
        rank = q * (self.count - 1)
        acc = 0
        for b in sorted(self._buckets):
            acc += self._buckets[b]
            if acc > rank:
                if b == _HIST_UNDERFLOW:
                    return self.min
                mid = (_HIST_BASE ** b + _HIST_BASE ** (b + 1)) / 2.0
                return min(max(mid, self.min), self.max)
        return self.max

    def describe(self) -> dict:
        if not self.count:
            return {"count": 0}
        out = {"count": self.count, "sum": round(self.total, 3),
               "min": round(self.min, 3), "max": round(self.max, 3),
               "mean": round(self.total / self.count, 3)}
        for q in QUANTILES:
            out[f"p{int(q * 100)}"] = round(self.quantile(q), 3)
        return out


class Registry:
    """The process-wide mirror of every shim-published stats key, plus the
    registry-only instruments (histograms)."""

    def __init__(self):
        self._lock = threading.RLock()
        self._values: dict = {}
        self._kinds: dict[str, str] = {}
        self._hists: dict[str, Histogram] = {}

    def apply(self, fn, key: str | None = None, kind: str | None = None):
        with self._lock:
            if key is not None and kind is not None:
                self._kinds.setdefault(key, kind)
            fn(self._values)

    def observe(self, name: str, value: float) -> None:
        with self._lock:
            self._hists.setdefault(name, Histogram()).observe(value)

    def get(self, key: str, default=None):
        with self._lock:
            return self._values.get(key, default)

    def reset(self) -> None:
        with self._lock:
            self._values.clear()
            self._kinds.clear()
            self._hists.clear()

    def snapshot(self, jsonable: bool = False) -> dict:
        """Every mirrored stats key (bit-identical to the legacy dicts'
        values) plus histogram summaries under "histograms".

        jsonable=True drops values with no JSON form (numpy rule tables)
        and deep-copies the rest, for embedding in JSON artifacts.
        """
        with self._lock:
            if not jsonable:
                out = dict(self._values)
            else:
                out = {}
                for k, v in self._values.items():
                    enc = _jsonable(v)
                    if enc is not None:
                        out[k] = enc
            if self._hists:
                out["histograms"] = {n: h.describe()
                                     for n, h in self._hists.items()}
            return out

    # -- Prometheus text exposition -----------------------------------------

    def prometheus_text(self, prefix: str = "rdfind_") -> str:
        lines: list[str] = []
        with self._lock:
            for key in sorted(self._values):
                value = self._values[key]
                kind = self._kinds.get(key, GAUGE)
                _prom_emit(lines, prefix, key, value, kind)
            for name in sorted(self._hists):
                h = self._hists[name]
                base = prefix + _prom_name(name)
                lines.append(f"# TYPE {base} summary")
                for q in QUANTILES:
                    v = h.quantile(q)
                    if v is not None:
                        lines.append(f'{base}{{quantile="{q}"}} {v}')
                lines.append(f"{base}_count {h.count}")
                lines.append(f"{base}_sum {h.total}")
        return "\n".join(lines) + "\n"

    def write_prometheus(self, path: str) -> None:
        """Atomic exposition write (a scraper never reads a torn file)."""
        text = self.prometheus_text()
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            f.write(text)
        os.replace(tmp, path)


def _jsonable(v):
    """JSON-ready copy of a telemetry value, or None when it has none (the
    twin of runtime/checkpoint._jsonable, so obs stays import-light)."""
    if isinstance(v, (bool, str)):
        return v
    if isinstance(v, int):
        return int(v)
    if isinstance(v, float):
        return float(v)
    # numpy scalars quack like their Python types.
    for proto, cast in ((int, int), (float, float)):
        try:
            if hasattr(v, "item") and isinstance(v.item(), proto):
                return cast(v.item())
        except Exception:
            break
    if isinstance(v, dict):
        out = {}
        for k, x in v.items():
            enc = _jsonable(x)
            if enc is None:
                return None
            out[str(k)] = enc
        return out
    if isinstance(v, (list, tuple)):
        out = [_jsonable(x) for x in v]
        return None if any(x is None for x in out) else out
    return None


def _prom_name(key: str) -> str:
    return "".join(c if c.isalnum() or c == "_" else "_" for c in key)


def _prom_emit(lines: list, prefix: str, key: str, value, kind: str,
               labels: str = "") -> None:
    """Numeric leaves become samples; one level of dict nesting becomes a
    label (site=/field=); strings and deeper structures are skipped."""
    if isinstance(value, bool):
        value = int(value)
    if isinstance(value, (int, float)):
        name = prefix + _prom_name(key)
        if not labels:
            lines.append(f"# TYPE {name} {kind if kind != STRUCT else GAUGE}")
        lines.append(f"{name}{labels} {value}")
        return
    if isinstance(value, dict) and not labels:
        for sub in sorted(value, key=str):
            v = value[sub]
            if isinstance(v, dict):
                # e.g. exchange_sites: {site: {calls: ..}} -> per-field rows.
                for field in sorted(v, key=str):
                    _prom_emit(lines, prefix, f"{key}_{field}", v[field],
                               GAUGE, labels=f'{{key="{sub}"}}')
            else:
                _prom_emit(lines, prefix, key, v, GAUGE,
                           labels=f'{{key="{sub}"}}')
    elif isinstance(value, list):
        lines.append(f"{prefix}{_prom_name(key)}_total {len(value)}")


_REGISTRY = Registry()
_EXPORT_PATH: str | None = None


def registry() -> Registry:
    return _REGISTRY


def reset() -> None:
    """Clear the process-wide mirror (run boundaries, tests)."""
    _REGISTRY.reset()


def set_export(path: str | None) -> None:
    """Arm (or disarm) Prometheus file exposition for this process."""
    global _EXPORT_PATH
    _EXPORT_PATH = path


def export_requested() -> bool:
    return _EXPORT_PATH is not None


def export_path() -> str | None:
    return _EXPORT_PATH


def flush_export() -> None:
    """Write the exposition file if armed (driver: run end + stage ends)."""
    if _EXPORT_PATH is not None:
        _REGISTRY.write_prometheus(_EXPORT_PATH)


# ---------------------------------------------------------------------------
# The sanctioned publish shims.  Every shim applies ONE mutation function to
# both containers, so the legacy dict and the registry mirror can never
# disagree on a key they both hold.
# ---------------------------------------------------------------------------


def mutate(stats: dict | None, fn, key: str | None = None,
           kind: str | None = None) -> None:
    """The root shim: apply `fn(container)` to the caller's stats dict (when
    given) and to the registry mirror.  `fn` must derive everything it
    writes from its own captures, reading the container only for
    accumulation — the two containers may hold different histories."""
    if stats is not None:
        fn(stats)
    _REGISTRY.apply(fn, key=key, kind=kind)


def counter_add(stats: dict | None, key: str, n=1) -> None:
    def fn(c):
        c[key] = c.get(key, 0) + n
    mutate(stats, fn, key=key, kind=COUNTER)


def counter_max(stats: dict | None, key: str, v) -> None:
    def fn(c):
        c[key] = max(c.get(key, 0), v)
    mutate(stats, fn, key=key, kind=GAUGE)


def time_add(stats: dict | None, key: str, ms: float, ndigits: int = 3) -> None:
    """Accumulate a duration in ms with the legacy round-to-3 convention."""
    def fn(c):
        c[key] = round(c.get(key, 0.0) + ms, ndigits)
    mutate(stats, fn, key=key, kind=COUNTER)


def gauge_set(stats: dict | None, key: str, v) -> None:
    def fn(c):
        c[key] = v
    mutate(stats, fn, key=key, kind=GAUGE)


def set_many(stats: dict | None, **kv) -> None:
    """The stats.update(...) shim (a batch of gauge assignments)."""
    def fn(c):
        c.update(kv)
    mutate(stats, fn)
    for k in kv:
        _REGISTRY._kinds.setdefault(k, GAUGE)


def struct_set(stats: dict | None, key: str, value) -> None:
    """Structured gauge (dense_plan, planned_caps, ingest, rebalance, ...)."""
    def fn(c):
        c[key] = value
    mutate(stats, fn, key=key, kind=STRUCT)


def struct_update(stats: dict | None, key: str, **kv) -> None:
    def fn(c):
        c.setdefault(key, {}).update(kv)
    mutate(stats, fn, key=key, kind=STRUCT)


def list_append(stats: dict | None, key: str, entry) -> None:
    def fn(c):
        c.setdefault(key, []).append(entry)
    mutate(stats, fn, key=key, kind=STRUCT)


def mapping_set(stats: dict | None, key: str, subkey, value) -> None:
    def fn(c):
        c.setdefault(key, {})[subkey] = value
    mutate(stats, fn, key=key, kind=STRUCT)


def restore(stats: dict | None, decoded: dict) -> None:
    """Re-publish a decoded stats dict (checkpoint resume): the resumed run
    must report the same stat-* counters as the run that produced it."""
    def fn(c):
        c.update(decoded)
    mutate(stats, fn)


def observe(name: str, value: float) -> None:
    """Registry-only histogram observation (no legacy key)."""
    _REGISTRY.observe(name, value)


# ---------------------------------------------------------------------------
# Link-capability cache (the one-shot startup probe of a device mesh).  Lives
# here, not in the mesh module, so the exchange timers can read the probed peaks
# without an import cycle, and survives registry resets within the process
# (the probe is one-shot per topology; a mid-run reset must not orphan it).
# ---------------------------------------------------------------------------

_LINK_CAPS: dict = {}


def set_link_caps(caps: dict) -> None:
    """Record the probed per-hop peaks ({"ici_gbps", "dcn_gbps", ...}) and
    mirror them into the registry for snapshots/Prometheus."""
    _LINK_CAPS.clear()
    _LINK_CAPS.update(caps)
    struct_set(None, "link_caps", dict(caps))


def link_caps() -> dict:
    """The probed per-hop peaks, or {} when no probe has run."""
    return dict(_LINK_CAPS)


def clear_link_caps() -> None:
    _LINK_CAPS.clear()
