"""Stage-boundary checkpointing of the driver's global artifacts.

The expensive artifacts of a run are few and small next to the input — the
interned triple table with its dictionary, the final CIND table — so
checkpointing them at stage boundaries is nearly free and makes re-runs over
the same dump incremental (``--checkpoint-dir``).

Each stage is one .npz written atomically (tmp + fsync + rename) and
self-describing: it embeds the fingerprint of everything that influenced it
(input file identities incl. size/mtime, and the config flags feeding that
stage).  A load with a different fingerprint, or of a torn or corrupt file, is
a miss, never a wrong answer.  No pickle: the dictionary's strings are stored
as one UTF-8 blob + offsets.

The JAX package's ``runtime/checkpoint.py``, copied: the same format version,
fingerprints and codecs, so a stage file of one package is a stage file of the
other.  ``ProgressStore`` (per-pass snapshots of the sharded pipeline) comes
along for that pipeline.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import sys
import threading
import weakref
import zipfile

import numpy as np

from ..data import CindTable
from ..dictionary import Dictionary
from ..obs import tracer
from . import faults


# Folded into every fingerprint; bumped whenever a stage codec or any
# algorithm upstream of a checkpointed artifact changes meaning, so stale
# checkpoints from older code can never satisfy a newer run.  It is the JAX
# package's version: both packages read and write the same stage files.
CHECKPOINT_FORMAT = 4


def fingerprint(payload: dict) -> str:
    """Stable digest of a JSON-serializable payload (+ the format version)."""
    blob = json.dumps({"__format__": CHECKPOINT_FORMAT, **payload},
                      sort_keys=True, default=str)
    return hashlib.sha256(blob.encode()).hexdigest()


def input_signature(paths) -> list:
    """Identity of the input files: path + size + mtime.

    A file that vanished between runs yields a [-1, -1] sentinel entry (the
    fingerprint then differs from any run that saw the file — a clean
    checkpoint miss with a diagnostic, never an unhandled traceback in the
    resume path; the actual read phase reports the missing file properly).
    """
    out = []
    for p in paths:
        try:
            st = os.stat(p)
        except OSError as e:
            print(f"note: checkpoint input {p} is not statable ({e}); "
                  f"treating dependent checkpoints as stale", file=sys.stderr)
            out.append([os.path.abspath(p), -1, -1])
            continue
        out.append([os.path.abspath(p), st.st_size, int(st.st_mtime_ns)])
    return out


class CheckpointStore:
    def __init__(self, directory: str):
        self.dir = directory
        os.makedirs(directory, exist_ok=True)

    def _path(self, stage: str) -> str:
        return os.path.join(self.dir, f"{stage}.npz")

    def save(self, stage: str, fp: str, arrays: dict) -> None:
        with tracer.span("checkpoint", cat=tracer.CAT_CHECKPOINT,
                         stage=stage):
            self._save(stage, fp, arrays)

    def _save(self, stage: str, fp: str, arrays: dict) -> None:
        faults.maybe_fail("checkpoint_write")
        # pid-unique tmp so hosts sharing one checkpoint dir never tear each
        # other's in-flight writes; .npz suffix so savez won't re-append one.
        tmp = self._path(stage) + f".tmp.{os.getpid()}.npz"
        np.savez(tmp, __fingerprint__=np.frombuffer(fp.encode(), np.uint8),
                 **arrays)
        # Durability before visibility: fsync the tmp file so a host crash
        # between write and rename can never publish a truncated .npz under
        # the final name, then fsync the directory so the rename itself
        # survives the crash.  (A stale-but-complete old file is a fine
        # outcome; a torn new one is not.)
        with open(tmp, "rb") as f:
            os.fsync(f.fileno())
        os.replace(tmp, self._path(stage))
        try:
            dfd = os.open(self.dir, os.O_RDONLY)
        except OSError:
            return  # e.g. a filesystem without directory fds; best effort
        try:
            os.fsync(dfd)
        finally:
            os.close(dfd)

    def discard(self, stage: str) -> None:
        """Remove a stage file if present (superseded progress snapshots)."""
        try:
            os.remove(self._path(stage))
        except OSError:
            pass

    def load(self, stage: str, fp: str) -> dict | None:
        """The stage's arrays, or None if absent/stale/corrupt."""
        path = self._path(stage)
        if not os.path.exists(path):
            return None
        try:
            with np.load(path) as z:
                stored = bytes(z["__fingerprint__"]).decode()
                if stored != fp:
                    return None
                return {k: z[k] for k in z.files if k != "__fingerprint__"}
        except (OSError, ValueError, KeyError, EOFError, zipfile.BadZipFile):
            # EOFError: np.load on a zero-length file (crash before any
            # bytes landed) raises it instead of BadZipFile.
            return None


# --- Stage codecs -----------------------------------------------------------

def encode_ingest(ids: np.ndarray, dictionary: Dictionary) -> dict:
    values = [str(v).encode("utf-8") for v in dictionary.values]
    offsets = np.zeros(len(values) + 1, np.int64)
    np.cumsum([len(v) for v in values], out=offsets[1:])
    return {
        "ids": np.asarray(ids, np.int32),
        "value_blob": np.frombuffer(b"".join(values), np.uint8),
        "value_offsets": offsets,
    }


def decode_ingest(arrays: dict) -> tuple[np.ndarray, Dictionary]:
    blob = arrays["value_blob"].tobytes()
    offs = arrays["value_offsets"]
    values = np.empty(len(offs) - 1, object)
    for i in range(len(offs) - 1):
        values[i] = blob[offs[i]:offs[i + 1]].decode("utf-8")
    return arrays["ids"], Dictionary(values)


_CIND_COLS = ("dep_code", "dep_v1", "dep_v2", "ref_code", "ref_v1", "ref_v2",
              "support")


def encode_cinds(table: CindTable) -> dict:
    return {c: np.asarray(getattr(table, c), np.int64) for c in _CIND_COLS}


def decode_cinds(arrays: dict) -> CindTable:
    return CindTable(*(arrays[c] for c in _CIND_COLS))


def _jsonable(v):
    """JSON-ready copy of a stats value, or None when it has no JSON form."""
    if isinstance(v, (bool, str)):
        return v
    if isinstance(v, (int, np.integer)):
        return int(v)
    if isinstance(v, (float, np.floating)):
        return float(v)
    if isinstance(v, dict):
        out = {}
        for k, x in v.items():
            enc = _jsonable(x)
            if enc is None:
                return None
            out[str(k)] = enc
        return out
    return None


def encode_stats(stats: dict) -> dict:
    """Pipeline stats ride along with the discover stage so resumed runs
    report the same stat-* counters as the run that produced the checkpoint.
    JSON-representable values (scalars and nested dicts of scalars, e.g.
    planned_caps) go into one blob; the association-rule table (numpy
    columns) is stored as npz arrays."""
    scalars = {}
    for k, v in stats.items():
        enc = _jsonable(v)
        if enc is not None:
            scalars[k] = enc
    blob = json.dumps(scalars, sort_keys=True).encode()
    out = {"__stats__": np.frombuffer(blob, np.uint8)}
    rules = stats.get("association_rules")
    if rules is not None:
        for i, col in enumerate(rules):
            out[f"__rules_{i}__"] = np.asarray(col)
    return out


# --- Mid-discover progress (preemption-safe per-pass checkpoints) -----------

# Every live ProgressStore, so signal handlers (runtime/driver.py) can flush
# in-flight snapshots before the process dies.
_PROGRESS_REGISTRY: "weakref.WeakSet[ProgressStore]" = weakref.WeakSet()


def flush_all_progress() -> None:
    """Synchronously drain every live ProgressStore's pending writes (called
    from the driver's SIGTERM/SIGINT handlers)."""
    for store in list(_PROGRESS_REGISTRY):
        try:
            store.flush()
        except Exception:
            pass  # a failed flush must never mask the signal itself


@dataclasses.dataclass
class ProgressSnapshot:
    """One decoded per-pass progress snapshot plus the partition meta a
    resuming run needs to adopt (n_pass) or re-shard (num_dev) it."""

    parts: dict     # {pass_idx: (host blocks, tail-counter tuple)}
    num_dev: int    # mesh size whose device order the blocks concatenate in
    n_pass: int     # dep-slice pass count the blocks partition under


def encode_progress(parts: dict, *, num_dev: int = 0,
                    n_pass: int = 0) -> dict:
    """{pass_idx: (host blocks, tail-counter tuple)} -> npz arrays.

    `num_dev`/`n_pass` ride along as snapshot meta (NOT fingerprinted):
    the loader re-shards blocks for a different mesh and may adopt the
    stored pass count, so neither may invalidate the snapshot."""
    out = {"done": np.asarray(sorted(parts), np.int64),
           "meta": np.asarray([num_dev, n_pass], np.int64)}
    for p, (blocks, tele) in parts.items():
        for i, b in enumerate(blocks):
            out[f"p{p}_b{i}"] = np.asarray(b)
        out[f"p{p}_tele"] = np.asarray(tele, np.int64)
    return out


def decode_progress(arrays: dict) -> ProgressSnapshot:
    out = {}
    for p in arrays.get("done", np.zeros(0, np.int64)):
        p = int(p)
        blocks = []
        while f"p{p}_b{len(blocks)}" in arrays:
            blocks.append(arrays[f"p{p}_b{len(blocks)}"])
        out[p] = (blocks, tuple(int(x) for x in arrays[f"p{p}_tele"]))
    meta = arrays.get("meta", np.zeros(2, np.int64))
    return ProgressSnapshot(parts=out, num_dev=int(meta[0]),
                            n_pass=int(meta[1]))


def _phase_slug(phase_key: str, seq: int) -> str:
    safe = "".join(c if c.isalnum() or c in "-_" else "-" for c in phase_key)
    return f"progress-{seq:03d}-{safe[:40]}"


def _writer_main(store_ref: "weakref.ref[ProgressStore]") -> None:
    """The ONE long-lived snapshot writer of a ProgressStore.

    Holds only a weakref between iterations so the store stays collectable
    (the WeakSet registry must keep working); exits when the store is gone.
    Coalescing happens in the pending map — only the newest submitted
    snapshot per stage is ever written, so a burst of pass commits costs one
    disk write, and an older snapshot can never overwrite a newer one."""
    while True:
        store = store_ref()
        if store is None:
            return
        with store._cond:
            item = store._pop_pending_locked()
            if item is None:
                # Nothing queued: sleep bounded so a GC'd store is noticed.
                store._cond.wait(timeout=1.0)
                item = store._pop_pending_locked()
        if item is not None:
            stage, fp, arrays = item
            try:
                store.store.save(stage, fp, arrays)
            except Exception as e:
                # A failed progress write (incl. an injected checkpoint_write
                # fault) only coarsens resume granularity; it must never fail
                # the run.
                print(f"warning: progress checkpoint {stage} failed "
                      f"({e}); resume granularity degrades, results do "
                      f"not", file=sys.stderr)
            with store._cond:
                store._inflight = None
                store._cond.notify_all()
        del store  # drop the strong ref before the next liveness check


class ProgressStore:
    """Preemption-safe per-pass discover checkpoints, written asynchronously.

    The sharded pass executor submits a snapshot of every committed pass's
    host blocks after each pass; ONE long-lived worker thread writes the newest snapshot per stage through
    CheckpointStore.save (atomic + fsynced) OFF the critical path, so a
    clean pass pays only the cost of handing over numpy references and a
    burst of commits coalesces to a single write.

    Fingerprints embed the base discover fingerprint plus the phase identity
    — deliberately NOT n_pass, the mesh size, or any capacity: a clean
    pass's output is capacity-independent, blocks are re-sharded on load for
    a different mesh, and the stored pass count may be adopted.  What shapes
    the partition rides in the snapshot itself (encode_progress meta)."""

    def __init__(self, store: CheckpointStore, base_fp: str,
                 writer: bool = True):
        self.store = store
        self.base_fp = base_fp
        # A host's ranks all read the snapshots; only one of them (its local
        # rank 0) writes them.
        self.writer = writer
        self._cond = threading.Condition()
        self._pending: dict = {}    # stage -> (fp, arrays), newest only
        self._inflight: str | None = None  # stage the writer holds right now
        self._writer: threading.Thread | None = None
        self._stages: set[str] = set()
        _PROGRESS_REGISTRY.add(self)

    def phase_fp(self, phase_key: str, seq: int, *, extra=None) \
            -> tuple[str, str]:
        """(stage_name, fingerprint) of one pass-executor phase.  The
        fingerprint is mesh-independent by construction (elastic resume)."""
        fp = fingerprint(dict(base=self.base_fp, phase=phase_key, seq=seq,
                              extra=extra))
        return _phase_slug(phase_key, seq), fp

    def load(self, stage: str, fp: str) -> ProgressSnapshot | None:
        arrays = self.store.load(stage, fp)
        if arrays is None:
            return None
        return decode_progress(arrays)

    def submit(self, stage: str, fp: str, parts: dict, *, num_dev: int = 0,
               n_pass: int = 0) -> None:
        """Queue a snapshot for the writer thread.  Snapshots are cumulative:
        replacing a stage's pending entry loses nothing but an already-stale
        intermediate state."""
        if not self.writer:
            return
        arrays = encode_progress(parts, num_dev=num_dev, n_pass=n_pass)
        self._stages.add(stage)
        with self._cond:
            self._pending[stage] = (fp, arrays)
            if self._writer is None or not self._writer.is_alive():
                self._writer = threading.Thread(
                    target=_writer_main, args=(weakref.ref(self),),
                    name="ckpt-progress-writer", daemon=True)
                self._writer.start()
            self._cond.notify_all()

    def _pop_pending_locked(self):
        """(stage, fp, arrays) of one pending snapshot, or None.  Caller
        holds self._cond; marks the popped stage in flight so flush() keeps
        waiting until its write lands."""
        if not self._pending:
            return None
        stage, (fp, arrays) = self._pending.popitem()
        self._inflight = stage
        return stage, fp, arrays

    def flush(self) -> None:
        """Block until every submitted snapshot has landed on disk."""
        with self._cond:
            while self._pending or self._inflight is not None:
                if self._writer is None or not self._writer.is_alive():
                    # No writer to wait for (e.g. flush from a signal handler
                    # racing a dying interpreter): drain synchronously.
                    item = self._pop_pending_locked()
                    if item is None:
                        self._inflight = None
                        return
                    stage, fp, arrays = item
                    try:
                        self.store.save(stage, fp, arrays)
                    except Exception as e:
                        print(f"warning: progress checkpoint {stage} failed "
                              f"({e}); resume granularity degrades, results "
                              f"do not", file=sys.stderr)
                    self._inflight = None
                    continue
                self._cond.wait(timeout=0.1)

    def cleanup(self) -> None:
        """Drop all progress stages (the full discover stage supersedes
        them); called by the driver after the discover checkpoint is saved."""
        self.flush()
        for stage in self._stages:
            self.store.discard(stage)
        self._stages.clear()


def decode_stats(arrays: dict) -> dict:
    decoded = json.loads(bytes(arrays["__stats__"]).decode()) \
        if "__stats__" in arrays else {}
    if "__rules_0__" in arrays:
        # Column count derives from the stored keys, not a hard-coded schema:
        # a rule-table shape change then reads back exactly what was written
        # instead of raising KeyError outside the corrupt-file guard.
        cols = []
        while f"__rules_{len(cols)}__" in arrays:
            cols.append(arrays[f"__rules_{len(cols)}__"])
        decoded["association_rules"] = cols
    return decoded
