"""The provenance block of a run certificate: the git sha, the core count,
the backend and the resolved RDFIND_* knob set.

The JAX package's ``obs/sentinel.py`` also keeps a BENCH_HISTORY.jsonl perf
series and its regression gate; the port's benchmark (``benchmark/``) is its
own regression record, so the port keeps only the provenance half.  Stdlib
only.
"""

from __future__ import annotations

import os
import subprocess


def _git_sha() -> str | None:
    try:
        out = subprocess.run(
            ["git", "rev-parse", "--short", "HEAD"],
            cwd=os.path.dirname(os.path.dirname(
                os.path.dirname(os.path.abspath(__file__)))),
            capture_output=True, text=True, timeout=10)
        sha = out.stdout.strip()
        return sha if out.returncode == 0 and sha else None
    except Exception:
        return None


def resolved_knobs() -> dict[str, str]:
    """The RDFIND_* env as this process sees it."""
    return {k: os.environ[k] for k in sorted(os.environ)
            if k.startswith("RDFIND_")}


def provenance(backend: str | None = None) -> dict:
    """The identity fields a run certificate carries: git sha, core count,
    backend, and the resolved knob set."""
    return {"sha": _git_sha(), "n_cores": os.cpu_count(),
            "backend": backend, "knobs": resolved_knobs()}
