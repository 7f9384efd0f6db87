"""The integrity plane: order-invariant content digests, verification and the
run certificate.

A stage's content digest is two 32-bit lanes, each a wraparound (mod 2^32) sum
over the per-row splitmix32 mixes of the row's column tuple under two
independent seeds (~64-bit collision resistance; a plain sum under ONE seed is
forgeable by swapping two rows' contributions, two independently-mixed lanes
are not).  Because the fold is a commutative sum it does not depend on row
order or on how the rows were partitioned.  A table's digest equals the JAX
package's ``obs/integrity.digest_table`` bit for bit, which is how a run of the
port is checked against a run of the reference.

Gating: ``RDFIND_INTEGRITY=0`` forces off, ``=1`` forces on, default follows the
live obs consumers (tracer, metrics exposition, run console).  ``RDFIND_INTEGRITY_STRICT=1``
turns a verification mismatch into a failed run (IntegrityError); the default
records a named ``integrity`` event and continues flagged.  The run
certificate (input signature -> stage digests -> output digest, with
provenance) goes to ``RDFIND_CERT`` or next to the heartbeat of a live trace.

The JAX package's ``obs/integrity.py``, copied.  Stdlib only at import time;
numpy is imported lazily inside the digest helpers.
"""

from __future__ import annotations

import json
import os

from . import metrics, tracer

# The two lane seeds (ops/hashing.hash_cols seed space; keep clear of the
# exchange/planner seeds in models/sharded.py — same mixer, and a digest
# colliding with a routing hash would correlate failure modes).
SEED_A = 29
SEED_B = 43

MASK32 = 0xFFFFFFFF


class IntegrityError(RuntimeError):
    """A digest verification failed under RDFIND_INTEGRITY_STRICT=1 (or a
    replica divergence that no retry can repair)."""


def enabled() -> bool:
    """Whether integrity verification should run.

    ``RDFIND_INTEGRITY=0`` forces it off, ``=1`` forces it on; by default it
    follows the consumers — live exactly when the tracer, the Prometheus
    exposition or the run console could show the result (no verification
    work without a consumer).
    """
    v = os.environ.get("RDFIND_INTEGRITY", "").strip()
    if v == "0":
        return False
    if v == "1":
        return True
    if tracer.enabled() or metrics.export_requested():
        return True
    from . import console
    return console.serving()


def strict() -> bool:
    """RDFIND_INTEGRITY_STRICT=1: a verification mismatch fails the run
    instead of degrading it."""
    return os.environ.get("RDFIND_INTEGRITY_STRICT", "").strip() == "1"


# ---------------------------------------------------------------------------
# Host digests (numpy, uint32 wraparound — the JAX package's host replicas,
# bit for bit).
# ---------------------------------------------------------------------------


def _mix32(x):
    import numpy as np
    x = np.asarray(x).astype(np.uint32)
    x = (x ^ (x >> np.uint32(16))) * np.uint32(0x85EBCA6B)
    x = (x ^ (x >> np.uint32(13))) * np.uint32(0xC2B2AE35)
    return x ^ (x >> np.uint32(16))


def row_mixes(cols, seed: int):
    """Per-row hash_cols mixes (uint32 array) — the summands of _fold.

    Exposed so incremental consumers can subtract removed rows and add
    inserted rows from a stored lane sum in O(change): the lanes are plain
    mod-2^32 sums of these mixes, so a digest update never needs the
    unchanged rows.
    """
    import numpy as np
    with np.errstate(over="ignore"):
        h = np.uint32(0x9E3779B9 * (seed + 1) & MASK32)
        for c in cols:
            h = _mix32(np.asarray(c).astype(np.uint32)
                       ^ (h + np.uint32(0x9E3779B9)))
        return np.asarray(h, np.uint32)


def _fold(cols, seed: int) -> int:
    """Wraparound-uint32 sum of the per-row hash_cols mixes of `cols`."""
    import numpy as np
    h = row_mixes(cols, seed)
    if h.ndim == 0:
        return int(h)
    return int(np.sum(h.reshape(-1), dtype=np.uint32))


def digest_rows(cols) -> tuple[int, int]:
    """Order-invariant (lane_a, lane_b) digest of a row set given as aligned
    columns (every row assumed valid — host blocks are already compacted)."""
    return _fold(cols, SEED_A), _fold(cols, SEED_B)


def digest_sketch_rows(table_rows, bits: int) -> tuple[int, int]:
    """Digest of concatenated per-device (bits,) count-min partials: each row
    hashes as its (local position, value) pair — position-dependence matters
    for a dense table, and local positions repeat every `bits` rows however
    many partials are stacked, so the fold matches the device lanes at any
    mesh size with the same `bits`."""
    import numpy as np
    t = np.asarray(table_rows).reshape(-1)
    pos = np.arange(t.shape[0], dtype=np.int64) % max(int(bits), 1)
    return digest_rows([pos, t])


def digest_table(table) -> tuple[int, int]:
    """Order-invariant digest of a CindTable (the run's output digest —
    identical across strategies, mesh sizes, and knob settings whenever the
    logical CIND set is)."""
    cols = [table.dep_code, table.dep_v1, table.dep_v2, table.ref_code,
            table.ref_v1, table.ref_v2, table.support]
    return digest_rows(cols)


def lanes_to_digest(lane_a, lane_b) -> tuple[int, int]:
    """Telemetry lanes ride as int32 (psum-friendly); read them back as the
    uint32 values the host replicas produce."""
    return int(lane_a) & MASK32, int(lane_b) & MASK32


def digest_hex(a: int, b: int) -> str:
    return f"{a & MASK32:08x}{b & MASK32:08x}"


# ---------------------------------------------------------------------------
# Publishing (through the metrics shims; every consumer — the stats dict and
# the Prometheus exposition — sees one schema).
# ---------------------------------------------------------------------------


def publish_stage(stats: dict | None, stage: str, a: int, b: int,
                  **detail) -> None:
    """Record one verified stage digest: the integrity_stages mapping (the
    run certificate's body), a trace instant, and the verified counter."""
    metrics.mapping_set(stats, "integrity_stages", stage, digest_hex(a, b))
    metrics.counter_add(stats, "integrity_verified")
    tracer.instant(f"integrity:{stage}", cat=tracer.CAT_RUN,
                   digest=digest_hex(a, b), **detail)


def publish_output(stats: dict | None, table) -> None:
    """Stamp a strategy's final-table digest as the ``output`` stage (the
    single-device models' one-line hook; the sharded strategies publish the
    same digest, so twins agree by construction)."""
    if stats is None or not enabled():
        return
    publish_stage(stats, "output", *digest_table(table))


def note_mismatch(stats: dict | None, *, site: str, stage: str,
                  pass_idx=None, repaired: bool = False) -> None:
    """Record one detected digest mismatch (named: site + stage/pass) and
    push the verdict onto the heartbeat so a watcher can report CORRUPT."""
    metrics.counter_add(stats, "integrity_mismatches")
    if repaired:
        metrics.counter_add(stats, "integrity_repaired")
    detail = {"site": site, "stage": stage, "repaired": repaired}
    if pass_idx is not None:
        detail["pass"] = int(pass_idx)
    metrics.list_append(stats, "integrity_events", detail)
    tracer.instant("integrity_mismatch", cat=tracer.CAT_RUN, **detail)
    if not repaired:
        tracer.set_status(integrity={"corrupt": True, "site": site,
                                     "stage": stage})


def summarize(stats: dict | None) -> dict:
    """Fold the counters into the ``stats["integrity"]`` struct (numeric
    leaves land in Prometheus automatically via _prom_emit)."""
    src = stats if stats is not None else {}
    summary = {
        "enabled": enabled(),
        "strict": strict(),
        "verified": int(src.get("integrity_verified", 0)),
        "mismatches": int(src.get("integrity_mismatches", 0)),
        "repaired": int(src.get("integrity_repaired", 0)),
    }
    metrics.struct_set(stats, "integrity", summary)
    return summary


# ---------------------------------------------------------------------------
# The run certificate: input signature -> per-stage digests -> output digest,
# provenance-keyed — the artifact a serving layer (or a re-run) can check a
# result set against.
# ---------------------------------------------------------------------------


def run_certificate(*, input_signature, stages: dict, output_digest: str,
                    provenance: dict, extra: dict | None = None) -> dict:
    cert = {
        "format": 1,
        "input_signature": input_signature,
        "stages": dict(stages or {}),
        "output_digest": output_digest,
        "provenance": provenance,
    }
    if extra:
        cert.update(extra)
    return cert


def write_certificate(path: str, cert: dict) -> None:
    """Atomic certificate write (tmp + rename; a reader never sees a torn
    JSON)."""
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "w") as f:
        json.dump(cert, f, indent=2, sort_keys=True)
        f.write("\n")
    os.replace(tmp, path)


def certificate_path() -> str | None:
    """Where to write the run certificate: RDFIND_CERT names a path
    explicitly; otherwise it lands next to the heartbeat in the live trace
    directory when tracing is armed; otherwise nowhere (the stats struct
    still carries the digests)."""
    p = os.environ.get("RDFIND_CERT", "").strip()
    if p:
        return p
    d = tracer.trace_dir()
    if d:
        return os.path.join(d, "run_certificate.json")
    return None
