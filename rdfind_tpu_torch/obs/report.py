"""The run report lines of the driver, in the JAX package's formats.

The subset of the JAX package's ``obs/report.py`` that a single-device run
prints: the ``--counters`` lines, the phase timing lines with the
machine-readable CSV line, and the ``--debug-level`` ingest line.
"""

from __future__ import annotations


def format_debug_lines(stats: dict) -> list[str]:
    """The --debug-level stats lines of a single-device run (the native
    ingest's telemetry)."""
    lines: list[str] = []
    ing = stats.get("ingest")
    if ing:
        lines.append(
            f"ingest: threads={ing.get('n_threads')} "
            f"units={ing.get('n_units')} files={ing.get('n_files')} "
            f"bytes={ing.get('bytes_read')} "
            f"read_ms={ing.get('read_ms')} parse_ms={ing.get('parse_ms')} "
            f"intern_ms={ing.get('intern_ms')} "
            f"merge_ms={ing.get('merge_ms')} remap_ms={ing.get('remap_ms')} "
            f"stalls={ing.get('queue_stalls')} "
            f"triples/s={ing.get('triples_per_sec')} "
            f"bytes/s={ing.get('bytes_per_sec')}")
    return lines


def format_counter_lines(counters: dict) -> list[str]:
    """The --counters report (sorted `key: value` lines)."""
    return [f"{k}: {v}" for k, v in sorted(counters.items())]


def format_timing_lines(timings: dict, counters: dict | None = None) -> list[str]:
    """Phase wall-clock report + the machine-readable CSV line
    (read+parse, intern, discover, total milliseconds and the CIND count)."""
    total = sum(timings.values())
    lines = [f"phase {name}: {secs * 1000:.1f} ms"
             for name, secs in timings.items()]
    lines.append(f"total: {total * 1000:.1f} ms")
    counters = counters or {}
    csv = ",".join([f"{timings.get(k, 0.0) * 1000:.0f}"
                    for k in ("read+parse", "intern", "discover")]
                   + [f"{total * 1000:.0f}",
                      str(counters.get("cind-counter", 0))])
    lines.append(f"csv:{csv}")
    return lines
