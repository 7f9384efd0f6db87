"""Zero-copy CIND index + generation-swapped query serving.

Discovery's product is the CIND set, but until now the only read path was
re-parsing a full run's text output.  This module turns the output into a
servable artifact: a compact single-file index written at the end of every
run that persists state (``--delta-state`` / each ``--delta`` generation,
plus ``RDFIND_SERVE_INDEX``), memory-mapped by a reader whose open cost is
O(header) — the sections are never materialized, parsed, or copied; every
query is a handful of binary searches over the raw mapping.

On-disk format (``cind_index.bin``), little-endian throughout::

  [0:4)    magic  b"CNDX"
  [4:8)    u32    format version
  [8:16)   u64    meta length
  [16:..)  JSON   meta: generation, digests, knobs, and the section table
  ...      64-byte-aligned sections (raw numpy arrays)

Sections (the interner's layout, frozen to disk):

  dict_blob/dict_offsets  the value dictionary: UTF-8 bytes of every value
                          in byte-sorted order + an offset table.  Value id
                          = sorted rank, bit-for-bit the ingest ids
                          (dictionary.Dictionary's law), so index answers
                          and run outputs share one id space.
  dict_prefix8            big-endian first-8-bytes key per value — value
                          lookup is ONE C-level ``searchsorted`` plus a
                          short exact-compare run, not a Python bisect.
  cap_code/cap_v1/cap_v2  the capture table: unique (code, v1, v2) rows of
                          the output, lex-sorted columnar (capture id =
                          rank; lookup = three nested searchsorteds).
  dep_ids/dep_offsets/    per-dependent referenced-capture sets: for each
  dep_support/ref_ids     dependent capture, its sorted referenced-capture
                          ids (absolute 32-bit, not delta-coded: membership
                          must stay a zero-parse binary search, and the
                          narrow dtype already banks the delta encoding's
                          byte win) + its support.
  topk_order              CIND row indices by (support desc, row asc) —
                          top-k is a prefix walk, no sort at query time.

Every section carries a position-dependent digest built from the
integrity lanes (``obs/integrity.digest_rows`` over (position, byte)), so a
flipped byte names the section it corrupted.  Commit is meta-last twice
over: the file is assembled in a pid-unique temp file whose magic bytes are
written only after everything else is fsynced (a torn temp file
self-invalidates), then ``os.replace``d into place — a crash at any point
is a clean miss (``IndexMiss``), never a torn index.

Serving (``python -m rdfind_tpu_torch.programs.serve INDEX_DIR``) wraps a reader
in :class:`IndexService`: it polls the bundle directory, and when a delta
run commits generation N+1 it opens the new mapping, re-verifies the
section digests, checks certificate chaining (new ``base_output_digest``
== loaded ``output_digest``) and generation monotonicity, and atomically
swaps the active reader.  In-flight queries hold a refcount on the old
mapping, which is unmapped only after the last one releases — zero dropped
queries.  A verification failure refuses the swap and keeps serving the
old generation (named via integrity.note_mismatch).

Knobs: ``RDFIND_SERVE_POLL_S`` (bundle-dir poll period, default 2.0),
``RDFIND_SERVE_VERIFY`` (=0 skips section re-verification on open/swap),
``RDFIND_SERVE_CHAIN`` (=0 accepts certificate-chain breaks on swap),
``RDFIND_SERVE_CACHE`` (=0 disables the reader's lookup memo),
``RDFIND_SERVE_INDEX`` (directory: every run also emits its index there).

The JAX package's ``runtime/serving.py``, copied: host numpy only, and the
index files are byte-for-byte the JAX package's (sections and section
digests; the meta differs only in its wall-clock stamps), so either package
reads an index the other wrote.
"""

from __future__ import annotations

import contextlib
import json
import os
import struct
import threading
import time

import numpy as np

from .. import conditions as cc
from ..data import NO_VALUE
from ..obs import integrity, metrics, servestats, tracer

INDEX_FILE = "cind_index.bin"
INDEX_FORMAT = 1
_MAGIC = b"CNDX"
_ALIGN = 64

# Section names in file order; the reader requires exactly this set.
_SECTIONS = ("dict_blob", "dict_offsets", "dict_prefix8",
             "cap_code", "cap_v1", "cap_v2",
             "dep_ids", "dep_offsets", "dep_support", "ref_ids",
             "topk_order")

_DTYPES = {"dict_blob": "<u1", "dict_offsets": "<i8", "dict_prefix8": "<u8",
           "cap_code": "<i4", "cap_v1": "<i4", "cap_v2": "<i4",
           "dep_ids": "<i4", "dep_offsets": "<i8", "dep_support": "<i8",
           "ref_ids": "<i4", "topk_order": "<i8"}


class IndexMiss(RuntimeError):
    """No usable index at the path (absent, torn, truncated, or a format
    this reader does not speak).  A clean miss: callers keep the previous
    generation (or report no index), never a partial answer."""


def poll_s() -> float:
    try:
        return max(0.05, float(os.environ.get("RDFIND_SERVE_POLL_S", "")
                               or 2.0))
    except ValueError:
        return 2.0


def verify_on_swap() -> bool:
    return os.environ.get("RDFIND_SERVE_VERIFY", "").strip() != "0"


def chain_checked() -> bool:
    return os.environ.get("RDFIND_SERVE_CHAIN", "").strip() != "0"


def cache_enabled() -> bool:
    return os.environ.get("RDFIND_SERVE_CACHE", "").strip() != "0"


def env_index_dir() -> str | None:
    """RDFIND_SERVE_INDEX: a directory every run also emits its index to."""
    d = os.environ.get("RDFIND_SERVE_INDEX", "").strip()
    return d or None


def index_path(directory: str) -> str:
    return os.path.join(directory, INDEX_FILE)


# ---------------------------------------------------------------------------
# Writer.
# ---------------------------------------------------------------------------


def _section_digest(raw: np.ndarray) -> str:
    """Position-dependent digest of a section's bytes (integrity lanes over
    (position, byte) rows — same fold as the delta bundle's blob digest)."""
    b = np.asarray(raw).view(np.uint8).reshape(-1)
    pos = np.arange(b.shape[0], dtype=np.int64)
    return integrity.digest_hex(*integrity.digest_rows([pos, b]))


def _value_prefix8(blob: np.ndarray, offsets: np.ndarray) -> np.ndarray:
    """Big-endian first-8-bytes key per value (zero-padded): integer order
    == byte order, so one searchsorted narrows a lookup to the (rare) run
    of values sharing an 8-byte prefix."""
    n = len(offsets) - 1
    pad = np.zeros((n, 8), np.uint8)
    if n:
        starts = offsets[:-1]
        lens = offsets[1:] - starts
        for i in range(8):
            m = lens > i
            if not m.any():
                break
            pad[m, i] = blob[starts[m] + i]
    return pad.view(">u8").reshape(-1).astype(np.uint64)


def build_arrays(values, table) -> dict:
    """The index's section arrays from a value dictionary (sorted; ids =
    ranks) and a CindTable of that run's emitted output.  Pure — shared by
    the writer and the tests' oracles."""
    vals = np.asarray(values, object)
    enc = [str(v).encode("utf-8") for v in vals]
    offsets = np.zeros(len(enc) + 1, np.int64)
    np.cumsum([len(e) for e in enc], out=offsets[1:])
    blob = np.frombuffer(b"".join(enc), np.uint8)

    t = len(table)
    dep = np.stack([np.asarray(table.dep_code, np.int64),
                    np.asarray(table.dep_v1, np.int64),
                    np.asarray(table.dep_v2, np.int64)], axis=1)
    ref = np.stack([np.asarray(table.ref_code, np.int64),
                    np.asarray(table.ref_v1, np.int64),
                    np.asarray(table.ref_v2, np.int64)], axis=1)
    caps, inv = np.unique(np.concatenate([dep, ref]), axis=0,
                          return_inverse=True)
    inv = inv.reshape(-1)
    dep_cap, ref_cap = inv[:t], inv[t:]
    support = np.asarray(table.support, np.int64)

    # Dependent-major layout: rows sorted by (dep capture, ref capture) so
    # each dependent's refset is one contiguous, sorted slice.
    order = np.lexsort((ref_cap, dep_cap))
    d_sorted, r_sorted = dep_cap[order], ref_cap[order]
    s_sorted = support[order]
    dep_ids, dstart, dcount = np.unique(d_sorted, return_index=True,
                                        return_counts=True)
    dep_offsets = np.zeros(len(dep_ids) + 1, np.int64)
    np.cumsum(dcount, out=dep_offsets[1:])
    dep_support = (np.maximum.reduceat(s_sorted, dstart)
                   if len(dep_ids) else np.zeros(0, np.int64))
    topk_order = np.lexsort((np.arange(t, dtype=np.int64), -s_sorted))

    return {
        "dict_blob": blob,
        "dict_offsets": offsets,
        "dict_prefix8": _value_prefix8(blob, offsets),
        "cap_code": caps[:, 0].astype(np.int32) if len(caps)
        else np.zeros(0, np.int32),
        "cap_v1": caps[:, 1].astype(np.int32) if len(caps)
        else np.zeros(0, np.int32),
        "cap_v2": caps[:, 2].astype(np.int32) if len(caps)
        else np.zeros(0, np.int32),
        "dep_ids": dep_ids.astype(np.int32),
        "dep_offsets": dep_offsets,
        "dep_support": dep_support,
        "ref_ids": r_sorted.astype(np.int32),
        "topk_order": topk_order.astype(np.int64),
    }


def write_index(directory: str, values, table, *, generation: int,
                output_digest: str, base_output_digest: str | None = None,
                extra: dict | None = None) -> str:
    """Write one index generation into `directory` (atomic, meta-last).
    Returns the committed path."""
    arrays = build_arrays(values, table)
    arrays = {k: np.ascontiguousarray(arrays[k]).astype(_DTYPES[k])
              for k in _SECTIONS}
    created = round(time.time(), 3)
    meta = {
        "format": INDEX_FORMAT,
        "generation": int(generation),
        "created_unix": created,
        # The freshness anchor: when the DATA this index serves was
        # committed (delta bundle meta-write time).  `extra` overrides it
        # with the real bundle commit stamp; a standalone write (tests,
        # full runs) defaults to its own creation time.
        "bundle_commit_unix": created,
        "n_values": int(len(arrays["dict_offsets"]) - 1),
        "n_captures": int(len(arrays["cap_code"])),
        "n_deps": int(len(arrays["dep_ids"])),
        "n_cinds": int(len(arrays["ref_ids"])),
        "output_digest": str(output_digest),
        "base_output_digest": (None if base_output_digest is None
                               else str(base_output_digest)),
    }
    if extra:
        meta.update({k: v for k, v in extra.items() if v is not None})

    def _layout(header_len: int) -> list[dict]:
        off = header_len
        secs = []
        for name in _SECTIONS:
            off = (off + _ALIGN - 1) // _ALIGN * _ALIGN
            nb = int(arrays[name].nbytes)
            secs.append({"name": name, "dtype": _DTYPES[name],
                         "offset": off, "nbytes": nb,
                         "digest": _section_digest(arrays[name])})
            off += nb
        return secs

    # The meta JSON embeds the section offsets, which depend on its own
    # length — iterate the layout until the header size is a fixed point.
    header_len = 4096
    for _ in range(8):
        meta["sections"] = _layout(header_len)
        blob = json.dumps(meta, sort_keys=True).encode("utf-8")
        need = 16 + len(blob)
        if need <= header_len:
            break
        header_len = (need + _ALIGN - 1) // _ALIGN * _ALIGN
    meta_blob = json.dumps(meta, sort_keys=True).encode("utf-8")

    os.makedirs(directory, exist_ok=True)
    path = index_path(directory)
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "wb") as f:
        # Magic held back: everything lands and fsyncs first, then the 4
        # magic bytes commit the temp file's contents; the rename commits
        # the file.  A crash anywhere leaves either no file or one that
        # opens as a clean miss.
        f.write(b"\0\0\0\0" + struct.pack("<IQ", INDEX_FORMAT,
                                          len(meta_blob)))
        f.write(meta_blob)
        pos = 16 + len(meta_blob)
        for sec in meta["sections"]:
            f.write(b"\0" * (sec["offset"] - pos))
            f.write(arrays[sec["name"]].tobytes())
            pos = sec["offset"] + sec["nbytes"]
        f.flush()
        os.fsync(f.fileno())
        f.seek(0)
        f.write(_MAGIC)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)
    dfd = os.open(directory, os.O_RDONLY)
    try:
        os.fsync(dfd)
    finally:
        os.close(dfd)
    return path


def emit_index(dirs, dictionary, table, *, generation: int,
               base_output_digest: str | None, strategy: int,
               min_support: int, stats: dict | None = None,
               extra: dict | None = None) -> list[str]:
    """The driver/delta emit hook: write the run's index into every
    directory in `dirs` plus RDFIND_SERVE_INDEX when set.  `extra` rides
    into the index meta (the delta path threads its bundle commit stamp
    and batch identity through here)."""
    targets = []
    for d in list(dirs) + [env_index_dir()]:
        if d and d not in targets:
            targets.append(d)
    if not targets:
        return []
    output_digest = integrity.digest_hex(*integrity.digest_table(table))
    meta_extra = {"strategy": int(strategy), "min_support": int(min_support)}
    if extra:
        meta_extra.update(extra)
    written = []
    for d in targets:
        written.append(write_index(
            d, dictionary.values, table, generation=generation,
            output_digest=output_digest,
            base_output_digest=base_output_digest,
            extra=meta_extra))
    metrics.struct_set(stats, "serve_index", {
        "dirs": targets, "generation": int(generation),
        "n_cinds": len(table), "output_digest": output_digest})
    tracer.instant("serve_index", cat=tracer.CAT_RUN,
                   generation=int(generation), n_cinds=len(table))
    return written


# ---------------------------------------------------------------------------
# Reader.
# ---------------------------------------------------------------------------


def peek_meta(path: str) -> dict | None:
    """O(header) peek at an index file's meta (None on any miss) — how a
    watcher tells 'the bundle dir moved on' without mapping it."""
    try:
        with open(path, "rb") as f:
            head = f.read(16)
            if len(head) < 16 or head[:4] != _MAGIC:
                return None
            version, meta_len = struct.unpack("<IQ", head[4:16])
            if version != INDEX_FORMAT or meta_len > (1 << 24):
                return None
            meta = json.loads(f.read(meta_len).decode("utf-8"))
            # Still O(header): the section table bounds-checks the file, so
            # a truncated body reads as absent, not as a generation.
            size = os.path.getsize(path)
            for s in meta["sections"]:
                if int(s["offset"]) + int(s["nbytes"]) > size:
                    return None
            int(meta["generation"])
            return meta
    except (OSError, ValueError, KeyError, TypeError):
        return None


def peek_generation(path: str) -> int | None:
    meta = peek_meta(path)
    return None if meta is None else int(meta["generation"])


class IndexReader:
    """Zero-copy mmap view of one committed index generation.

    Open cost is O(header): the file is mapped, the JSON meta parsed, and
    the section views created — no section is read until a query touches
    it.  All queries are binary searches over the raw mapping; the only
    per-query allocations are the (tiny) looked-up values themselves."""

    def __init__(self, path: str):
        self.path = path
        try:
            size = os.path.getsize(path)
        except OSError as e:
            raise IndexMiss(f"no index at {path}: {e}")
        if size < 16:
            raise IndexMiss(f"index at {path} truncated below header")
        try:
            mm = np.memmap(path, np.uint8, mode="r")
        except (OSError, ValueError) as e:
            raise IndexMiss(f"cannot map {path}: {e}")
        head = bytes(mm[:16])
        if head[:4] != _MAGIC:
            raise IndexMiss(f"{path}: bad magic (torn or foreign file)")
        version, meta_len = struct.unpack("<IQ", head[4:16])
        if version != INDEX_FORMAT:
            raise IndexMiss(f"{path}: format {version} != {INDEX_FORMAT}")
        if 16 + meta_len > size:
            raise IndexMiss(f"{path}: truncated inside header")
        try:
            meta = json.loads(bytes(mm[16:16 + meta_len]).decode("utf-8"))
        except (ValueError, UnicodeDecodeError) as e:
            raise IndexMiss(f"{path}: unreadable meta: {e}")
        secs = {s.get("name"): s for s in meta.get("sections", [])}
        if set(secs) != set(_SECTIONS):
            raise IndexMiss(f"{path}: section set {sorted(secs)} != "
                            f"{sorted(_SECTIONS)}")
        self._mm = mm
        self._sec = {}
        for name in _SECTIONS:
            s = secs[name]
            off, nb = int(s["offset"]), int(s["nbytes"])
            if off < 0 or off + nb > size:
                raise IndexMiss(
                    f"{path}: truncated inside section {name}")
            # np.asarray strips the memmap subclass: still a zero-copy
            # view of the mapping, but per-access cost drops from the
            # subclass's __array_finalize__ hook to a plain ndarray index
            # (the difference between ~450 and ~100k holds/s).
            self._sec[name] = np.asarray(mm[off:off + nb]).view(
                np.dtype(s["dtype"]))
        self.meta = meta
        self.generation = int(meta["generation"])
        self.output_digest = meta.get("output_digest")
        self.base_output_digest = meta.get("base_output_digest")
        self.n_values = int(meta.get("n_values", 0))
        self.n_captures = int(meta.get("n_captures", 0))
        self.n_cinds = int(meta.get("n_cinds", 0))
        self.created_unix = meta.get("created_unix")
        # Indexes written without a commit stamp: fall back to the write
        # time so freshness degrades to index age, never crashes.
        self.bundle_commit_unix = meta.get("bundle_commit_unix",
                                           self.created_unix)
        self.batch = meta.get("batch")
        self._vcache: dict | None = {} if cache_enabled() else None
        self._ccache: dict | None = {} if cache_enabled() else None

    # -- lifecycle -----------------------------------------------------------

    def close(self) -> None:
        """Drop the section views and unmap (callers must not race queries
        against close — IndexService's refcount guarantees that)."""
        self._sec = {}
        mm, self._mm = self._mm, None
        if mm is not None:
            with contextlib.suppress(Exception):
                mm._mmap.close()

    def verify(self) -> dict:
        """Recompute every section digest from the mapping; a mismatch is
        NAMED: {"ok": bool, "mismatches": [section, ...]}."""
        bad = []
        for s in self.meta["sections"]:
            raw = self._mm[int(s["offset"]):
                           int(s["offset"]) + int(s["nbytes"])]
            if _section_digest(raw) != s.get("digest"):
                bad.append(s["name"])
        return {"ok": not bad, "mismatches": bad}

    # -- lookups -------------------------------------------------------------

    def value_id(self, token) -> int:
        """Sorted-rank id of a value string, or -1."""
        if self._vcache is not None and token in self._vcache:
            return self._vcache[token]
        b = str(token).encode("utf-8")
        key = int.from_bytes(b[:8].ljust(8, b"\0"), "big")
        pre = self._sec["dict_prefix8"]
        offs = self._sec["dict_offsets"]
        blob = self._sec["dict_blob"]
        lo = int(np.searchsorted(pre, key, side="left"))
        hi = int(np.searchsorted(pre, key, side="right"))
        # Bisect the equal-prefix8 run on full byte strings: URI-shaped
        # dictionaries share long prefixes, so the run can be most of the
        # dictionary — a linear scan here would be O(V), not O(log V).
        ans = -1
        while lo < hi:
            mid = (lo + hi) >> 1
            got = blob[int(offs[mid]):int(offs[mid + 1])].tobytes()
            if got < b:
                lo = mid + 1
            elif got > b:
                hi = mid
            else:
                ans = mid
                break
        if self._vcache is not None:
            self._vcache[token] = ans
        return ans

    def value(self, vid: int) -> str:
        offs = self._sec["dict_offsets"]
        return bytes(self._sec["dict_blob"]
                     [int(offs[vid]):int(offs[vid + 1])]).decode("utf-8")

    def _capture_id_ids(self, code: int, v1: int, v2: int) -> int:
        """Capture id from interned ids: three nested searchsorteds over
        the lex-sorted columnar capture table."""
        codes = self._sec["cap_code"]
        lo = int(np.searchsorted(codes, code, side="left"))
        hi = int(np.searchsorted(codes, code, side="right"))
        if lo == hi:
            return -1
        c1 = self._sec["cap_v1"][lo:hi]
        a = int(np.searchsorted(c1, v1, side="left"))
        b = int(np.searchsorted(c1, v1, side="right"))
        if a == b:
            return -1
        c2 = self._sec["cap_v2"][lo + a:lo + b]
        j = int(np.searchsorted(c2, v2, side="left"))
        if j < b - a and int(c2[j]) == v2:
            return lo + a + j
        return -1

    def capture_id(self, code: int, v1=None, v2=None) -> int:
        """Capture id from a (code, value-string-or-None ×2) capture; -1
        when the value or the capture is unknown."""
        key = (int(code), v1, v2)
        if self._ccache is not None and key in self._ccache:
            return self._ccache[key]
        i1 = NO_VALUE if v1 is None else self.value_id(v1)
        i2 = NO_VALUE if v2 is None else self.value_id(v2)
        ans = -1
        if (v1 is None or i1 >= 0) and (v2 is None or i2 >= 0):
            ans = self._capture_id_ids(int(code), i1, i2)
        if self._ccache is not None:
            self._ccache[key] = ans
        return ans

    def capture(self, cid: int) -> tuple:
        """(code, v1-string-or-None, v2-string-or-None) of a capture id."""
        code = int(self._sec["cap_code"][cid])
        v1 = int(self._sec["cap_v1"][cid])
        v2 = int(self._sec["cap_v2"][cid])
        return (code,
                None if v1 == NO_VALUE else self.value(v1),
                None if v2 == NO_VALUE else self.value(v2))

    def _resolve(self, cap) -> int:
        if isinstance(cap, (int, np.integer)):
            return int(cap)
        return self.capture_id(*cap)

    # -- queries -------------------------------------------------------------

    def holds_ids(self, dep: int, ref: int) -> bool:
        if dep < 0 or ref < 0:
            return False
        deps = self._sec["dep_ids"]
        i = int(np.searchsorted(deps, dep))
        if i >= len(deps) or int(deps[i]) != dep:
            return False
        offs = self._sec["dep_offsets"]
        a, b = int(offs[i]), int(offs[i + 1])
        refs = self._sec["ref_ids"]
        j = int(np.searchsorted(refs[a:b], ref))
        return j < b - a and int(refs[a + j]) == ref

    def holds(self, dep, ref) -> bool:
        """Does ``dep ⊆ ref`` hold?  `dep`/`ref` are capture ids or
        (code, v1, v2) string captures."""
        return self.holds_ids(self._resolve(dep), self._resolve(ref))

    def support(self, dep) -> int | None:
        """The dependent's support, or None when it is not a dependent."""
        d = self._resolve(dep)
        if d < 0:
            return None
        deps = self._sec["dep_ids"]
        i = int(np.searchsorted(deps, d))
        if i >= len(deps) or int(deps[i]) != d:
            return None
        return int(self._sec["dep_support"][i])

    def referenced_ids(self, dep: int) -> np.ndarray:
        """The dependent's referenced-capture ids (a zero-copy sorted view
        into the mapping)."""
        deps = self._sec["dep_ids"]
        i = int(np.searchsorted(deps, dep))
        if dep < 0 or i >= len(deps) or int(deps[i]) != dep:
            return np.zeros(0, np.int32)
        offs = self._sec["dep_offsets"]
        return self._sec["ref_ids"][int(offs[i]):int(offs[i + 1])]

    def referenced(self, dep, limit: int | None = None) -> list:
        """Decoded captures the dependent references (sorted by id)."""
        ids = self.referenced_ids(self._resolve(dep))
        if limit is not None:
            ids = ids[:max(0, int(limit))]
        return [self.capture(int(r)) for r in ids]

    def _row(self, r: int) -> tuple:
        """(dep_id, ref_id, support) of CIND row r in dependent-major
        order."""
        offs = self._sec["dep_offsets"]
        d = int(np.searchsorted(offs, r, side="right")) - 1
        return (int(self._sec["dep_ids"][d]),
                int(self._sec["ref_ids"][r]),
                int(self._sec["dep_support"][d]))

    def topk(self, k: int, decode: bool = True) -> list:
        """The k CINDs with the largest support (ties by row order):
        [(dep, ref, support), ...], captures decoded when `decode`."""
        order = self._sec["topk_order"]
        out = []
        for r in order[:max(0, int(k))]:
            d, ref, s = self._row(int(r))
            if decode:
                out.append((self.capture(d), self.capture(ref), s))
            else:
                out.append((d, ref, s))
        return out

    def iter_cinds(self):
        """Every CIND as (dep_id, ref_id, support) — differential tests'
        full-answer walk."""
        offs = self._sec["dep_offsets"]
        deps = self._sec["dep_ids"]
        refs = self._sec["ref_ids"]
        sup = self._sec["dep_support"]
        for i in range(len(deps)):
            for r in refs[int(offs[i]):int(offs[i + 1])]:
                yield int(deps[i]), int(r), int(sup[i])

    def pretty_capture(self, cap) -> str:
        code, v1, v2 = cap if isinstance(cap, tuple) else self.capture(cap)
        return cc.pretty(code, v1, v2)


# ---------------------------------------------------------------------------
# Generation swap: the refcounted active-reader handle.
# ---------------------------------------------------------------------------


class _Slot:
    """One mapped generation + the number of in-flight queries on it."""

    def __init__(self, reader: IndexReader):
        self.reader = reader
        self._refs = 0
        self._retired = False
        self._lk = threading.Lock()

    def acquire(self) -> IndexReader:
        with self._lk:
            self._refs += 1
        return self.reader

    def release(self) -> None:
        close = False
        with self._lk:
            self._refs -= 1
            close = self._retired and self._refs == 0
        if close:
            self.reader.close()

    def retire(self) -> None:
        close = False
        with self._lk:
            self._retired = True
            close = self._refs == 0
        if close:
            self.reader.close()


class IndexService:
    """The serving process's active index: poll-driven generation swap with
    zero dropped queries (queries pin their generation; the old mapping is
    unmapped after the last in-flight reference releases)."""

    def __init__(self, directory: str, *, verify: bool | None = None,
                 chain: bool | None = None):
        self.directory = directory
        self.path = index_path(directory)
        self._verify = verify_on_swap() if verify is None else bool(verify)
        self._chain = chain_checked() if chain is None else bool(chain)
        self._lock = threading.Lock()
        self._slot: _Slot | None = None
        self._stat: tuple | None = None
        self.swaps = 0
        self.refusals = 0
        self.pending: dict | None = None  # last refused/missed candidate
        self.chain: list[dict] = []       # loaded-generation lineage
        self.last_swap: dict | None = None  # staleness of the last swap

    # -- the active reader ---------------------------------------------------

    @property
    def generation(self) -> int | None:
        slot = self._slot
        return slot.reader.generation if slot else None

    @contextlib.contextmanager
    def acquire(self):
        """Context-managed query handle: yields the active IndexReader (or
        None before the first generation lands), pinned for the block."""
        with self._lock:
            slot = self._slot
            reader = slot.acquire() if slot else None
        try:
            yield reader
        finally:
            if slot is not None:
                slot.release()

    # -- swap ----------------------------------------------------------------

    def poll(self, stats: dict | None = None) -> dict:
        """One bundle-dir poll: open/verify/chain-check a changed index
        file and swap it in.  Returns a verdict dict with "action" one of
        none|miss|swapped|refused."""
        try:
            st = os.stat(self.path)
        except OSError:
            self.pending = None if self._slot else {"reason": "no-index"}
            return {"action": "none" if self._slot else "miss",
                    "reason": "no-index"}
        key = (st.st_ino, int(st.st_mtime_ns), st.st_size)
        if key == self._stat:
            return {"action": "none", "reason": "unchanged"}
        try:
            reader = IndexReader(self.path)
        except IndexMiss as e:
            # A torn/truncated candidate is a clean miss: keep serving.
            self.refusals += 1
            self.pending = {"reason": "miss", "detail": str(e)}
            metrics.counter_add(None, "serve_swap_refused")
            return {"action": "refused" if self._slot else "miss",
                    "reason": "miss", "detail": str(e)}
        verdict = self._admit(reader)
        if verdict is not None:
            cand_digest = reader.output_digest
            reader.close()
            self.refusals += 1
            self.pending = verdict
            metrics.counter_add(None, "serve_swap_refused")
            # The refusal instant chains to the candidate's certificate
            # digest, so a trace reader can tie it to the rejected bundle.
            tracer.instant("serve_swap_refused", cat=tracer.CAT_RUN,
                           reason=verdict["reason"],
                           generation=verdict.get("generation"),
                           output_digest=cand_digest)
            if verdict["reason"] == "section-digest-mismatch":
                for name in verdict["sections"]:
                    integrity.note_mismatch(stats, site="serve-swap",
                                            stage=f"index-{name}")
            return {"action": "refused", **verdict}
        loaded = round(time.time(), 3)
        # Swap staleness: how long the committed data waited before it
        # started serving (bundle-commit → serving-swap lag).
        commit = reader.bundle_commit_unix
        swap_stale = (round(max(0.0, loaded - commit), 3)
                      if commit is not None else None)
        with self._lock:
            old, self._slot = self._slot, _Slot(reader)
            self._stat = key
            self.swaps += 1
            self.pending = None
            self.last_swap = {"generation": reader.generation,
                              "loaded_unix": loaded,
                              "bundle_commit_unix": commit,
                              "staleness_s": swap_stale}
            self.chain.append({
                "generation": reader.generation,
                "output_digest": reader.output_digest,
                "base_output_digest": reader.base_output_digest,
                "loaded_unix": loaded})
        if old is not None:
            old.retire()
        metrics.gauge_set(None, "serve_generation", reader.generation)
        metrics.counter_add(None, "serve_swaps")
        if swap_stale is not None:
            metrics.gauge_set(None, "serve_swap_staleness_s", swap_stale)
        tracer.instant("serve_swap", cat=tracer.CAT_RUN,
                       generation=reader.generation,
                       output_digest=reader.output_digest,
                       base_output_digest=reader.base_output_digest,
                       staleness_s=swap_stale)
        return {"action": "swapped", "generation": reader.generation}

    def _admit(self, reader: IndexReader) -> dict | None:
        """Why the candidate must NOT replace the active reader (None =
        admit).  Order: integrity first, then monotonicity, then chain."""
        if self._verify:
            v = reader.verify()
            if not v["ok"]:
                return {"reason": "section-digest-mismatch",
                        "sections": v["mismatches"],
                        "generation": reader.generation}
        cur = self._slot.reader if self._slot else None
        if cur is not None:
            if reader.generation < cur.generation:
                return {"reason": "generation-regressed",
                        "generation": reader.generation,
                        "serving": cur.generation}
            if (self._chain and reader.generation > cur.generation
                    and reader.base_output_digest is not None
                    and reader.base_output_digest != cur.output_digest):
                return {"reason": "chain-broken",
                        "generation": reader.generation,
                        "base_output_digest": reader.base_output_digest,
                        "serving_output_digest": cur.output_digest}
        return None

    # -- status --------------------------------------------------------------

    def bundle_generation(self) -> int | None:
        """The newest committed generation ON DISK (O(header) peek) — may
        run ahead of the loaded one when a swap is pending or refused."""
        return peek_generation(self.path)

    def freshness(self, now: float | None = None) -> dict:
        """The freshness plane, in seconds and generations:

          index_age_s        now − loaded index's bundle commit time (how
                             old the data being SERVED is);
          generations_behind bundle generation on disk − loaded generation
                             (>0 while a swap is pending or refused);
          staleness_s        bundle-commit → serving-swap lag.  While
                             behind, it grows live from the PENDING
                             bundle's commit stamp (how long fresher data
                             has been waiting); once caught up it is the
                             last swap's recorded lag.
        """
        now = time.time() if now is None else now
        slot = self._slot
        r = slot.reader if slot else None
        commit = r.bundle_commit_unix if r else None
        age = (round(max(0.0, now - commit), 3)
               if commit is not None else None)
        loaded = r.generation if r else None
        disk_meta = peek_meta(self.path)
        bundle_gen = (int(disk_meta["generation"]) if disk_meta else None)
        behind = (max(0, bundle_gen - loaded)
                  if bundle_gen is not None and loaded is not None
                  else (1 if bundle_gen is not None and loaded is None
                        else 0))
        if behind > 0 and disk_meta is not None:
            pend_commit = disk_meta.get("bundle_commit_unix",
                                        disk_meta.get("created_unix"))
            stale = (round(max(0.0, now - pend_commit), 3)
                     if pend_commit is not None else None)
        else:
            stale = (self.last_swap or {}).get("staleness_s")
        return {"index_age_s": age, "generations_behind": behind,
                "staleness_s": stale}

    def status(self) -> dict:
        slot = self._slot
        r = slot.reader if slot else None
        bundle_gen = self.bundle_generation()
        loaded = r.generation if r else None
        return {
            "dir": self.directory,
            "generation": loaded,
            "bundle_generation": bundle_gen,
            "stale": (bundle_gen is not None and loaded is not None
                      and bundle_gen > loaded),
            "pending": self.pending,
            "swaps": self.swaps,
            "refusals": self.refusals,
            "output_digest": r.output_digest if r else None,
            "base_output_digest": r.base_output_digest if r else None,
            "n_cinds": r.n_cinds if r else None,
            "n_captures": r.n_captures if r else None,
            "n_values": r.n_values if r else None,
            "batch": r.batch if r else None,
            "freshness": self.freshness(),
            "chain": self.chain[-8:],
        }

    def close(self) -> None:
        with self._lock:
            slot, self._slot = self._slot, None
            self._stat = None
        if slot is not None:
            slot.retire()

    # -- instrumented queries (the console's query plane) --------------------

    def _timed(self, name: str, fn, args=None):
        """Run one query against a pinned reader, landing its latency in
        the sharded serve stats (obs/servestats: per-thread, lock-free —
        the metrics registry's RLock would serialize the query plane).  The
        slot is acquired inline rather than through ``acquire()``: at
        100k+ QPS the contextmanager frames are measurable."""
        t0 = time.perf_counter()
        with self._lock:
            slot = self._slot
            r = slot.acquire() if slot else None
        if r is None:
            # Rare path: no generation loaded.  The registry lock is fine
            # here, and the refusal must be visible in both planes.
            servestats.record(name, "refused", args=args)
            metrics.counter_add(None, "serve_refused")
            return None, None
        try:
            out = fn(r)
            gen = r.generation
        finally:
            slot.release()
        servestats.record(name, "ok", (time.perf_counter() - t0) * 1e6,
                          generation=gen, args=args)
        return out, gen

    def query_holds(self, dep, ref) -> dict:
        out, gen = self._timed("holds", lambda r: r.holds(dep, ref),
                               args=(dep, ref))
        if gen is None:
            return {"error": "no index loaded"}
        return {"holds": bool(out), "generation": gen}

    def query_referenced(self, dep, limit: int | None = None) -> dict:
        def run(r):
            refs = r.referenced(dep, limit=limit)
            return {"referenced": [
                {"code": c, "v1": v1, "v2": v2,
                 "pretty": cc.pretty(c, v1, v2)} for c, v1, v2 in refs],
                "support": r.support(dep)}
        out, gen = self._timed("referenced", run, args=(dep, limit))
        if gen is None:
            return {"error": "no index loaded"}
        return {**out, "n": len(out["referenced"]), "generation": gen}

    def query_topk(self, k: int) -> dict:
        def run(r):
            return [{"dep": r.pretty_capture(d), "ref": r.pretty_capture(f),
                     "support": s} for d, f, s in r.topk(k)]
        out, gen = self._timed("topk", run, args=(int(k),))
        if gen is None:
            return {"error": "no index loaded"}
        return {"k": int(k), "results": out, "generation": gen}
