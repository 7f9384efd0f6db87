"""Data-distribution telemetry: what the data looked like.

Spans, the registry and the memory watermarks instrument the *mechanisms*;
this module is the data plane:

* log2-bucketed join-line size histograms (single device: from the
  host-resident length arrays),
* capture support spectra (same log2 buckets over capture cardinalities),
* per-cap utilization fractions (used/planned),
* block-skip effectiveness (``n_blocks_skipped``/total of the dense sweep's
  schedule) and giant-line share.

Everything publishes through the metrics shims so the ``stats`` dicts, the
registry mirror, the Prometheus exposition and the console's ``/datastats``
see one schema.  Sampling runs only with a consumer: :func:`enabled` is False
unless the tracer, the metrics exposition or the run console is live or the
``RDFIND_DATASTATS`` knob forces it.

The JAX package's ``obs/datastats.py``, copied.  Stdlib only at import time;
numpy is imported lazily inside the helpers that bucket host arrays.
"""

from __future__ import annotations

import os

from . import metrics, tracer

# Join lines and capture supports are int32-bounded, so 32 log2 buckets
# cover every representable size; bucket e counts values in [2^e, 2^(e+1)).
N_BUCKETS = 32


def enabled() -> bool:
    """Whether data-distribution sampling should run.

    ``RDFIND_DATASTATS=0`` forces it off, ``=1`` forces it on; by default it
    follows the consumers — live exactly when the tracer, the Prometheus
    exposition or the run console could show the result (no sampling work
    without a consumer).
    """
    v = os.environ.get("RDFIND_DATASTATS", "").strip()
    if v == "0":
        return False
    if v == "1":
        return True
    if tracer.enabled() or metrics.export_requested():
        return True
    from . import console
    return console.serving()


# ---------------------------------------------------------------------------
# Bucketing helpers (host side; a sharded run buckets on the device and only
# pulls the 32-int bin vector through hist_from_bins).
# ---------------------------------------------------------------------------


def log2_bucket_counts(sizes) -> dict[int, int]:
    """Sparse {exponent: count} histogram of positive sizes; bucket ``e``
    holds values in [2^e, 2^(e+1)).  Zero/negative entries are dropped
    (padding rows, masked lines)."""
    import numpy as np
    a = np.asarray(sizes).reshape(-1)
    if a.size == 0:
        return {}
    a = a[a > 0].astype(np.int64)
    if a.size == 0:
        return {}
    exp = np.minimum(np.int64(N_BUCKETS - 1),
                     np.floor(np.log2(a)).astype(np.int64))
    counts = np.bincount(exp, minlength=N_BUCKETS)
    return {int(e): int(c) for e, c in enumerate(counts) if c}


def hist_from_bins(bins) -> dict[int, int]:
    """Sparse dict from a dense 32-bin vector (the on-device histogram's
    pulled output)."""
    return {int(e): int(c) for e, c in enumerate(bins) if int(c)}


def _hist_struct(hist: dict[int, int]) -> dict[str, int]:
    """JSON/Prometheus-friendly key form: bucket 3 -> "b3"."""
    return {f"b{e}": int(c) for e, c in sorted(hist.items())}


# ---------------------------------------------------------------------------
# Publishers.  Each writes ONE struct key through the shims; call sites gate
# on enabled() so none of this work happens without a consumer.
# ---------------------------------------------------------------------------


def publish_line_stats(stats: dict | None, *, hist: dict[int, int],
                       n_lines: int, max_line: int, giant_lines: int = 0,
                       source: str = "host") -> None:
    """The join-line size distribution: how many lines at each log2 size,
    the largest line, and the giant-line share (the lines the sharded
    executor routes through the giant-pair path)."""
    n_lines = int(n_lines)
    metrics.struct_set(stats, "datastats_lines", {
        "n_lines": n_lines,
        "max_line": int(max_line),
        "giant_lines": int(giant_lines),
        "giant_share": round(int(giant_lines) / n_lines, 6) if n_lines else 0.0,
        "hist_log2": _hist_struct(hist),
        "source": source,
    })


def publish_capture_spectrum(stats: dict | None, *, hist: dict[int, int],
                             n_captures: int, max_support: int,
                             source: str = "host") -> None:
    """The capture support spectrum: how many captures at each log2
    support.  A spectrum dominated by the minimum support explains a
    pair-light run; a fat tail explains a cap-hungry one."""
    metrics.struct_set(stats, "datastats_captures", {
        "n_captures": int(n_captures),
        "max_support": int(max_support),
        "hist_log2": _hist_struct(hist),
        "source": source,
    })


def publish_block_skip(stats: dict | None, *, n_blocks: int,
                       n_blocks_skipped: int) -> None:
    """Block-skip effectiveness: the fraction of the dense sweep's (dep tile
    x line block) pairs that the schedule never visits."""
    n_blocks = int(n_blocks)
    skipped = int(n_blocks_skipped)
    metrics.struct_set(stats, "datastats_block_skip", {
        "n_blocks": n_blocks,
        "n_blocks_skipped": skipped,
        "skip_frac": round(skipped / n_blocks, 6) if n_blocks else 0.0,
    })


def publish_cap_utilization(stats: dict | None, planned: dict,
                            used: dict) -> None:
    """Plan-time cap utilization: for every cap with a measured demand
    (the exact pre-headroom gathers), {planned, used, frac}.  frac ~0.8 is
    the healthy steady state under the 1.25x headroom convention; frac near
    1.0 means the next skew spike rides the degradation ladder."""
    out = {}
    for cap, demand in used.items():
        cap_v = planned.get(cap)
        if not cap_v:
            continue
        out[cap] = {"planned": int(cap_v), "used": int(demand),
                    "frac": round(int(demand) / int(cap_v), 6)}
    if out:
        metrics.struct_set(stats, "cap_utilization", out)


def publish_pass_utilization(stats: dict | None, pass_idx: int,
                             fracs: dict[str, float]) -> dict:
    """Per-pass cap-utilization trajectory point (the forecaster's input):
    appended to ``cap_utilization_passes`` and emitted as a Chrome-trace
    counter so Perfetto plots the climb toward 1.0."""
    entry = {"pass": int(pass_idx)}
    entry.update({k: round(float(v), 6) for k, v in sorted(fracs.items())})
    metrics.list_append(stats, "cap_utilization_passes", entry)
    tracer.counter("cap_utilization", **entry)
    tracer.set_status(cap_util=dict(entry))
    return entry
