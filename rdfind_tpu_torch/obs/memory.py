"""Device-memory watermarks from the CUDA caching allocator's statistics.

The degradation ladder (runtime/faults.py) reacts to capacity exhaustion
AFTER a buffer overflows; the watermark samples here surface pressure
BEFORE that: stage high-water marks and allocation deltas, published into
the trace (as a Chrome-trace counter lane) and the metrics registry, with a
near-cap warning once in-use bytes cross RDFIND_HBM_WARN_FRAC (default 0.9)
of the device limit.

Each visible card that the process has initialised reports
``torch.cuda.memory_stats``: in use = ``allocated_bytes.all.current``, peak =
``allocated_bytes.all.peak`` (what ``torch.cuda.max_memory_allocated``
returns), limit = the card's total memory (``torch.cuda.mem_get_info``).  A
process with no card, or one that never touched it, samples nothing and gets
None, as the JAX package's CPU backend does; the ``_stats_fn`` seam drives the
watermark logic without a card.  Record, key names and warning are the JAX
package's ``obs/memory.py``.

Stdlib only at import time; torch is imported lazily per sample.
"""

from __future__ import annotations

import os
import sys

from . import metrics, tracer

DEFAULT_WARN_FRAC = 0.9

# Test seam: replace with a callable returning [(device_label, stats_dict)]
# to drive watermark logic without a card.
_stats_fn = None

# Last-sample in-use bytes per device label (allocation deltas).
_last_in_use: dict[str, int] = {}
_warned_labels: set[str] = set()


def warn_frac() -> float:
    try:
        return float(os.environ.get("RDFIND_HBM_WARN_FRAC", DEFAULT_WARN_FRAC))
    except ValueError:
        return DEFAULT_WARN_FRAC


def _device_memory_stats() -> list[tuple[str, dict]]:
    if _stats_fn is not None:
        return list(_stats_fn())
    try:
        import torch
        if not torch.cuda.is_available() or not torch.cuda.is_initialized():
            return []
        out = []
        for d in range(torch.cuda.device_count()):
            try:
                st = torch.cuda.memory_stats(d)
                st = {"bytes_in_use": st.get("allocated_bytes.all.current", 0),
                      "peak_bytes_in_use": st.get("allocated_bytes.all.peak",
                                                  0),
                      "bytes_limit": torch.cuda.mem_get_info(d)[1]}
            except Exception:
                st = None
            if st:
                out.append((f"cuda:{d}", st))
        return out
    except Exception:
        return []


def reset() -> None:
    """Forget delta baselines and warning latches (run boundaries, tests)."""
    _last_in_use.clear()
    _warned_labels.clear()


def sample(stats: dict | None, label: str = "", publish: bool = True):
    """One watermark sample across the local devices.

    Returns the aggregate record (or None when no backend reports memory):
    {"in_use_bytes", "peak_bytes", "limit_bytes", "frac", "delta_bytes"} —
    maxima across devices (min for the limit), `frac` the worst device's
    in-use fraction of its limit, `delta_bytes` the largest in-use change
    since the previous sample (the allocation delta of whatever ran between
    the two, e.g. one stage).

    With `publish`, the record lands in stats["hbm"] / the registry (via the
    struct shim), the per-device in-use bytes ride the trace as a counter
    lane, and crossing the warn fraction emits a once-per-device stderr
    warning + trace instant + `hbm_near_cap_warnings` counter.
    """
    per_dev = _device_memory_stats()
    if not per_dev:
        return None
    in_use = peak = delta = 0
    limit = None
    frac = 0.0
    counters = {}
    warn_at = warn_frac()
    for dev, st in per_dev:
        u = int(st.get("bytes_in_use", 0))
        p = int(st.get("peak_bytes_in_use", u))
        lim = int(st.get("bytes_limit", 0))
        in_use = max(in_use, u)
        peak = max(peak, p)
        if lim > 0:
            limit = lim if limit is None else min(limit, lim)
            frac = max(frac, u / lim)
        delta = max(delta, u - _last_in_use.get(dev, u))
        _last_in_use[dev] = u
        counters[dev] = u
        if publish and lim > 0 and u / lim >= warn_at \
                and dev not in _warned_labels:
            _warned_labels.add(dev)
            print(f"warning: HBM near cap on {dev}: {u}/{lim} bytes "
                  f"({u / lim:.0%} >= {warn_at:.0%})"
                  + (f" at {label}" if label else "")
                  + "; the degradation ladder may fire next",
                  file=sys.stderr)
            tracer.instant("hbm_near_cap", cat="memory", device=dev,
                           bytes_in_use=u, bytes_limit=lim, label=label)
            metrics.counter_add(stats, "hbm_near_cap_warnings")
    record = {"in_use_bytes": in_use, "peak_bytes": peak,
              "limit_bytes": limit if limit is not None else 0,
              "frac": round(frac, 4), "delta_bytes": delta}
    if publish:
        metrics.struct_set(stats, "hbm", record)
        metrics.observe("hbm_in_use_bytes", in_use)
        tracer.counter("hbm_bytes_in_use", **counters)
        if label:
            tracer.instant("hbm_watermark", cat="memory", label=label,
                           **record)
    return record
