"""ctypes bindings for the native ingest engine (``native/rdfind_native.cpp``).

The native path fuses read + gz decompression + tokenization + interning into one
C++ pass and hands back the (N, 3) int32 id table directly: the CLI's default
ingest.  The pure-Python path (``io/reader.py`` + ``io/ntriples.py`` +
``dictionary.intern_triples``) is the reference and the fallback when the library
cannot be built.

The library is built from the repository's ``native/rdfind_native.cpp`` with g++
at first use, with the flags of ``native/Makefile`` (``-O3 -DNDEBUG -std=c++17
-fPIC -pthread -shared ... -lz``), into ``build/`` at the root of the checkout,
named by a hash of source and flags like the CUDA libraries (``ops/build.py``): a
changed source rebuilds, an unchanged one loads at once.

Parallelism: ``RDFIND_INGEST_THREADS`` (default: physical cores, clamped to the
process affinity mask; ``1`` runs the single-threaded serial engine) runs the parse
as a work-stealing unit queue: byte-range chunks of plain files split at newline
boundaries (``RDFIND_INGEST_CHUNK_BYTES``; unset sizes the grain to
``input_bytes / (threads * 4)``), the members of multi-member .gz files, and
decode -> parse pipelined subtasks of large single-member .gz files.  Committed
triple blocks stream back in input order while later units still parse
(:class:`IngestStream`).  Ids are bit-identical to the serial engine: the merge
hash-partitions the per-thread interners (crc32 of the value's bytes), dedupes the
shards in parallel and byte-sort-merges them into the global rank order.

Speed knobs, resolved here and pushed into the engine with ``rdf_ingest_set_opts``:
``RDFIND_INGEST_SWAR`` (8-byte SWAR delimiter scanning; 0 = scalar),
``RDFIND_INGEST_MMAP`` (mmap plain files + zero-copy interning; 0 = fread),
``RDFIND_INGEST_GZ_PIPELINE`` (parallel gzip; 0 = one unit per .gz),
``RDFIND_INGEST_GZ_CHUNK_BYTES`` (decoded bytes per pipelined gz subtask, default
8 MiB).  ``RDFIND_NATIVE=0`` disables the native path.

Semantics: the same ids and values as the Python path for valid UTF-8 input
(byte-sort order == np.unique's code-point order).  For invalid UTF-8 the native
path is more exact: it interns raw bytes (distinct byte strings stay distinct),
while the Python reader's errors="replace" can conflate them; exported values are
decoded with errors="replace" either way.
"""

from __future__ import annotations

import ctypes
import ctypes.util
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

import numpy as np

from ..dictionary import Dictionary
from ..obs import metrics, tracer
from ..ops.build import BUILD_DIR

SOURCE = Path(__file__).resolve().parents[2] / "native" / "rdfind_native.cpp"
# native/Makefile's flags; -lz goes after the source.
CXX_FLAGS = ("-O3", "-DNDEBUG", "-std=c++17", "-fPIC", "-pthread", "-shared")

_lib = None
_lib_error: str | None = None

# rdf_ingest_stats2 lane order (native/rdfind_native.cpp).
_STAT_FIELDS = ("bytes_read", "read_ms", "parse_ms", "intern_ms", "merge_ms",
                "remap_ms", "n_threads", "n_units", "queue_stalls",
                "queue_stall_ms", "n_files", "decode_ms", "mmap_bytes",
                "n_gz_members", "n_gz_subtasks", "swar", "mmap",
                "gz_pipeline")
_N_STATS = len(_STAT_FIELDS)
_INT_STATS = ("bytes_read", "n_threads", "n_units", "queue_stalls", "n_files",
              "mmap_bytes", "n_gz_members", "n_gz_subtasks", "swar", "mmap",
              "gz_pipeline")

DEFAULT_GZ_CHUNK_BYTES = 8 << 20


class NativeIngestError(RuntimeError):
    pass


def physical_cores() -> int:
    """Physical core count (SMT siblings collapsed), via sysfs topology; falls
    back to os.cpu_count() when the topology files are absent."""
    try:
        seen = set()
        base = "/sys/devices/system/cpu"
        for name in os.listdir(base):
            if not (name.startswith("cpu") and name[3:].isdigit()):
                continue
            sib = os.path.join(base, name, "topology", "thread_siblings_list")
            with open(sib) as f:
                seen.add(f.read().strip())
        if seen:
            return len(seen)
    except OSError:
        pass
    return os.cpu_count() or 1


def ingest_threads(threads: int | None = None) -> int:
    """Resolved worker count: explicit arg > RDFIND_INGEST_THREADS > auto
    (physical cores, clamped to the process affinity mask)."""
    if threads is None:
        env = os.environ.get("RDFIND_INGEST_THREADS", "")
        if env.strip():
            threads = int(env)
        else:
            threads = physical_cores()
            try:
                threads = min(threads, len(os.sched_getaffinity(0)))
            except (AttributeError, OSError):
                pass
    return max(1, int(threads))


def ingest_chunk_bytes(chunk_bytes: int | None = None) -> int:
    """Resolved plain-file split size; 0 = auto (the engine sizes the grain to
    input_bytes / (threads * 4), clamped to [1 MiB, 64 MiB])."""
    if chunk_bytes is None:
        env = os.environ.get("RDFIND_INGEST_CHUNK_BYTES", "")
        chunk_bytes = int(env) if env.strip() else 0
    return max(0, int(chunk_bytes))


def _env_flag(name: str, default: bool = True) -> bool:
    v = os.environ.get(name, "").strip().lower()
    if not v:
        return default
    return v not in ("0", "false", "no")


def ingest_swar() -> bool:
    """RDFIND_INGEST_SWAR: 8-byte SWAR delimiter scanning (0 = scalar)."""
    return _env_flag("RDFIND_INGEST_SWAR")


def ingest_mmap() -> bool:
    """RDFIND_INGEST_MMAP: mmap plain files + zero-copy interning."""
    return _env_flag("RDFIND_INGEST_MMAP")


def ingest_gz_pipeline() -> bool:
    """RDFIND_INGEST_GZ_PIPELINE: member fan-out + decode -> parse pipeline."""
    return _env_flag("RDFIND_INGEST_GZ_PIPELINE")


def ingest_gz_chunk_bytes() -> int:
    """RDFIND_INGEST_GZ_CHUNK_BYTES: decoded bytes per gz pipeline subtask."""
    env = os.environ.get("RDFIND_INGEST_GZ_CHUNK_BYTES", "")
    return max(256, int(env)) if env.strip() else DEFAULT_GZ_CHUNK_BYTES


def cxx() -> str:
    return shutil.which("g++") or "g++"


def library_path() -> Path:
    """build/librdfind_native-<hash of source and flags>.so."""
    key = hashlib.sha256(SOURCE.read_bytes()
                         + " ".join(CXX_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"librdfind_native-{key}.so"


def toolchain_report() -> dict:
    """What the build needs: the compiler's first version line, whether
    ``zlib.h`` preprocesses and whether the linker finds libz."""
    out = dict(cxx=cxx(), version=None, zlib_h=False, libz=None)
    try:
        out["version"] = subprocess.run(
            [cxx(), "--version"], capture_output=True, text=True,
            timeout=30).stdout.splitlines()[0]
        out["zlib_h"] = subprocess.run(
            [cxx(), "-E", "-x", "c++", "-"], input="#include <zlib.h>\n",
            capture_output=True, text=True, timeout=60).returncode == 0
    except (OSError, IndexError, subprocess.TimeoutExpired):
        pass
    out["libz"] = ctypes.util.find_library("z")
    return out


def build() -> dict:
    """Compile the library unless it is built already.  Returns {"seconds": s,
    "path": ...}; raises NativeIngestError with the compiler's output when the
    build fails."""
    out = library_path()
    t0 = time.perf_counter()
    if not out.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [cxx(), *CXX_FLAGS, "-o", str(tmp), str(SOURCE), "-lz"]
        try:
            proc = subprocess.run(cmd, capture_output=True, text=True,
                                  timeout=300)
        except (OSError, subprocess.TimeoutExpired) as e:
            raise NativeIngestError(f"{' '.join(cmd)}: {e}") from e
        if proc.returncode != 0:
            raise NativeIngestError(f"{' '.join(cmd)} failed:\n"
                                    f"{proc.stdout}{proc.stderr}")
        os.replace(tmp, out)
    return dict(seconds=time.perf_counter() - t0, path=str(out))


def _bind(lib):
    lib.rdf_ingest_new.restype = ctypes.c_void_p
    lib.rdf_ingest_free.argtypes = [ctypes.c_void_p]
    lib.rdf_ingest_error.argtypes = [ctypes.c_void_p]
    lib.rdf_ingest_error.restype = ctypes.c_char_p
    lib.rdf_ingest_file.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                                    ctypes.c_int, ctypes.c_int, ctypes.c_int]
    lib.rdf_ingest_file.restype = ctypes.c_int64
    lib.rdf_ingest_finalize.argtypes = [ctypes.c_void_p]
    lib.rdf_ingest_finalize.restype = ctypes.c_int64
    lib.rdf_ingest_num_triples.argtypes = [ctypes.c_void_p]
    lib.rdf_ingest_num_triples.restype = ctypes.c_int64
    lib.rdf_ingest_get_triples.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
    lib.rdf_ingest_values_bytes.argtypes = [ctypes.c_void_p]
    lib.rdf_ingest_values_bytes.restype = ctypes.c_int64
    lib.rdf_ingest_get_values.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                          ctypes.c_void_p]
    lib.rdf_ingest_begin.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_char_p), ctypes.c_int64,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int64]
    lib.rdf_ingest_begin.restype = ctypes.c_int64
    lib.rdf_ingest_next_block.argtypes = [ctypes.c_void_p]
    lib.rdf_ingest_next_block.restype = ctypes.c_int64
    lib.rdf_ingest_block_thread.argtypes = [ctypes.c_void_p]
    lib.rdf_ingest_block_thread.restype = ctypes.c_int
    lib.rdf_ingest_block_copy.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
    lib.rdf_ingest_stream_finish.argtypes = [ctypes.c_void_p]
    lib.rdf_ingest_stream_finish.restype = ctypes.c_int64
    lib.rdf_ingest_thread_vocab.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.rdf_ingest_thread_vocab.restype = ctypes.c_int64
    lib.rdf_ingest_thread_remap.argtypes = [ctypes.c_void_p, ctypes.c_int,
                                            ctypes.c_void_p]
    lib.rdf_ingest_set_opts.argtypes = [ctypes.c_void_p, ctypes.c_int,
                                        ctypes.c_int, ctypes.c_int64,
                                        ctypes.c_int]
    lib.rdf_ingest_stats2.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                      ctypes.c_int64]
    lib.rdf_ingest_stats2.restype = ctypes.c_int64
    return lib


def _apply_opts(lib, h) -> None:
    """Push the env-resolved speed knobs into a fresh ingest handle."""
    lib.rdf_ingest_set_opts(h, int(ingest_swar()), int(ingest_mmap()),
                            ingest_gz_chunk_bytes(),
                            int(ingest_gz_pipeline()))


def load():
    """The bound library, built on first use; None if unavailable (the reason
    is in ``unavailable_reason()``)."""
    global _lib, _lib_error
    if _lib is not None or _lib_error is not None:
        return _lib
    if os.environ.get("RDFIND_NATIVE", "").lower() in ("0", "false", "no"):
        _lib_error = "disabled via RDFIND_NATIVE"
        return None
    try:
        build()
        _lib = _bind(ctypes.CDLL(str(library_path())))
    except (NativeIngestError, OSError, AttributeError) as e:
        _lib = None
        _lib_error = str(e)
    return _lib


def available() -> bool:
    return load() is not None


def unavailable_reason() -> str | None:
    return _lib_error


def _read_stats(lib, h) -> dict:
    buf = (ctypes.c_double * _N_STATS)()
    lib.rdf_ingest_stats2(h, buf, _N_STATS)
    out = {k: float(v) for k, v in zip(_STAT_FIELDS, buf)}
    for k in _INT_STATS:
        out[k] = int(out[k])
    return out


def _values_from_buffer(raw: bytes, offsets: np.ndarray):
    """Per-value UTF-8 decode of the exported dictionary blob.

    Losslessness is probed per value, not on the concatenated blob: an invalid
    suffix of one value can splice with an invalid prefix of the next into a
    valid sequence (b"\\xc3" + b"\\xa9" == "é").  Returns (values, lossless).
    """
    n_values = len(offsets) - 1
    values = np.empty(n_values, object)
    lossless = True
    for i in range(n_values):
        chunk = raw[offsets[i]:offsets[i + 1]]
        try:
            values[i] = chunk.decode("utf-8")
        except UnicodeDecodeError:
            values[i] = chunk.decode(errors="replace")
            lossless = False
    return values, lossless


def canonicalize(ids: np.ndarray, values: np.ndarray, lossless: bool):
    """Invalid UTF-8: errors="replace" can reorder or conflate values relative
    to the native byte-sort ranks, breaking Dictionary's sorted-unique
    invariant.  Re-canonicalize like the Python path (np.unique on the decoded
    strings) and remap the ids."""
    if lossless or not len(values):
        return ids, Dictionary(values)
    uniques, inverse = np.unique(values, return_inverse=True)
    ids = inverse.astype(np.int32)[ids]
    return ids, Dictionary(uniques)


class IngestStream:
    """Streaming parallel ingest: committed triple blocks while files parse.

    Usage::

        with IngestStream(paths, tabs=..., expect_quad=...) as stream:
            for block, thread_id in stream:   # provisional thread-local ids
                ...
            remaps = stream.finish()          # thread-local id -> global rank
            raw, offsets = stream.raw_values()  # the sorted distinct values

    Blocks arrive in input order, so concatenating them reproduces the serial
    triple order; applying ``remaps[thread_id]`` to each block gives the final
    global ids, bit-identical to the serial engine.
    """

    def __init__(self, paths, *, tabs: bool = False, expect_quad: bool = False,
                 skip_comments: bool = True, threads: int | None = None,
                 chunk_bytes: int | None = None):
        lib = load()
        if lib is None:
            raise NativeIngestError(f"native ingest unavailable: {_lib_error}")
        self._lib = lib
        self._h = lib.rdf_ingest_new()
        _apply_opts(lib, self._h)
        self.n_threads = ingest_threads(threads)
        encoded = [os.fspath(p).encode() for p in paths]
        arr = (ctypes.c_char_p * max(len(encoded), 1))(*encoded)
        n_units = lib.rdf_ingest_begin(
            self._h, arr, len(encoded), int(tabs), int(expect_quad),
            int(skip_comments), self.n_threads,
            ingest_chunk_bytes(chunk_bytes))
        if n_units < 0:
            msg = lib.rdf_ingest_error(self._h).decode(errors="replace")
            self.close()
            raise NativeIngestError(msg)

    def __iter__(self):
        lib, h = self._lib, self._h
        while True:
            n = lib.rdf_ingest_next_block(h)
            if n == -1:
                return
            if n < 0:
                raise NativeIngestError(
                    lib.rdf_ingest_error(h).decode(errors="replace"))
            block = np.empty((int(n), 3), np.int32)
            if n:
                lib.rdf_ingest_block_copy(
                    h, block.ctypes.data_as(ctypes.c_void_p))
            yield block, int(lib.rdf_ingest_block_thread(h))

    def finish(self) -> list[np.ndarray]:
        """Merge the per-thread interners; returns the per-thread local ->
        global remap tables.  Only valid once the blocks are exhausted."""
        n_values = self._lib.rdf_ingest_stream_finish(self._h)
        if n_values < 0:
            raise NativeIngestError(
                self._lib.rdf_ingest_error(self._h).decode(errors="replace"))
        remaps = []
        for t in range(self.n_threads):
            vocab = int(self._lib.rdf_ingest_thread_vocab(self._h, t))
            r = np.empty(max(vocab, 1), np.int32)
            if vocab:
                self._lib.rdf_ingest_thread_remap(
                    self._h, t, r.ctypes.data_as(ctypes.c_void_p))
            remaps.append(r[:vocab])
        self._n_values = int(n_values)
        return remaps

    def raw_values(self) -> tuple[bytes, np.ndarray]:
        """(concatenated byte blob, offsets) of the sorted distinct values."""
        nbytes = int(self._lib.rdf_ingest_values_bytes(self._h))
        buf = np.empty(max(nbytes, 1), np.uint8)
        offsets = np.empty(self._n_values + 1, np.int64)
        self._lib.rdf_ingest_get_values(
            self._h, buf.ctypes.data_as(ctypes.c_void_p),
            offsets.ctypes.data_as(ctypes.c_void_p))
        return buf.tobytes()[:nbytes], offsets

    def decoded_values(self):
        """(values, lossless): the sorted distinct values, UTF-8-decoded per
        value; pair with :func:`canonicalize` to build the Dictionary."""
        raw, offsets = self.raw_values()
        return _values_from_buffer(raw, offsets)

    def stats(self) -> dict:
        return _read_stats(self._lib, self._h)

    def close(self):
        if self._h is not None:
            self._lib.rdf_ingest_free(self._h)
            self._h = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class BlockAssembler:
    """Incremental (N, 3) table assembly from streamed blocks: the backing
    array grows by doubling, so each block costs one copy during the parse,
    and per-block spans let the thread-local -> global remap run per span."""

    def __init__(self):
        self._buf = np.empty((1 << 14, 3), np.int32)
        self._n = 0
        self._spans: list[tuple[int, int, int]] = []  # (lo, hi, thread)

    def add(self, block: np.ndarray, thread_id: int):
        n = block.shape[0]
        if n == 0:
            return
        while self._n + n > self._buf.shape[0]:
            grown = np.empty((self._buf.shape[0] * 2, 3), np.int32)
            grown[:self._n] = self._buf[:self._n]
            self._buf = grown
        self._buf[self._n:self._n + n] = block
        self._spans.append((self._n, self._n + n, thread_id))
        self._n += n

    def finalize(self, remaps: list[np.ndarray]) -> np.ndarray:
        """Applies the per-thread remap tables in place; returns the table."""
        ids = self._buf[:self._n]
        for lo, hi, t in self._spans:
            ids[lo:hi] = remaps[t][ids[lo:hi]]
        return ids


def _ingest_parallel(paths, tabs, expect_quad, skip_comments, threads,
                     chunk_bytes, stats):
    t_wall = time.perf_counter()
    with tracer.span("ingest-parallel", cat=tracer.CAT_STAGE,
                     files=len(paths), threads=ingest_threads(threads)):
        with IngestStream(paths, tabs=tabs, expect_quad=expect_quad,
                          skip_comments=skip_comments, threads=threads,
                          chunk_bytes=chunk_bytes) as stream:
            asm = BlockAssembler()
            with tracer.span("ingest-stream", cat=tracer.CAT_STAGE):
                for block, thread_id in stream:
                    asm.add(block, thread_id)
            with tracer.span("ingest-merge", cat=tracer.CAT_STAGE):
                remaps = stream.finish()
            with tracer.span("ingest-remap", cat=tracer.CAT_STAGE):
                t0 = time.perf_counter()
                ids = asm.finalize(remaps)
                remap_ms = (time.perf_counter() - t0) * 1000.0
            values, lossless = stream.decoded_values()
            st = stream.stats()
        ids, dictionary = canonicalize(ids, values, lossless)
    if stats is not None:
        st["remap_ms"] += remap_ms  # the host-side block rewrite
        publish_stats(stats, st, ids.shape[0], len(dictionary), t_wall)
    return ids, dictionary


def _ingest_serial(paths, tabs, expect_quad, skip_comments, stats):
    lib = load()
    t_wall = time.perf_counter()
    h = lib.rdf_ingest_new()
    _apply_opts(lib, h)
    try:
        for p in paths:
            with tracer.span("ingest-file", cat=tracer.CAT_STAGE,
                             path=os.path.basename(os.fspath(p))):
                rc = lib.rdf_ingest_file(h, os.fspath(p).encode(), int(tabs),
                                         int(expect_quad), int(skip_comments))
            if rc < 0:
                raise NativeIngestError(
                    lib.rdf_ingest_error(h).decode(errors="replace"))
        with tracer.span("ingest-finalize", cat=tracer.CAT_STAGE):
            n_values = lib.rdf_ingest_finalize(h)
        n_triples = lib.rdf_ingest_num_triples(h)
        ids = np.empty((n_triples, 3), np.int32)
        if n_triples:
            lib.rdf_ingest_get_triples(h, ids.ctypes.data_as(ctypes.c_void_p))
        nbytes = lib.rdf_ingest_values_bytes(h)
        buf = np.empty(max(nbytes, 1), np.uint8)
        offsets = np.empty(n_values + 1, np.int64)
        lib.rdf_ingest_get_values(
            h, buf.ctypes.data_as(ctypes.c_void_p),
            offsets.ctypes.data_as(ctypes.c_void_p))
        st = _read_stats(lib, h)
    finally:
        lib.rdf_ingest_free(h)
    values, lossless = _values_from_buffer(buf.tobytes()[:nbytes], offsets)
    ids, dictionary = canonicalize(ids, values, lossless)
    if stats is not None:
        publish_stats(stats, st, ids.shape[0], len(dictionary), t_wall)
    return ids, dictionary


def publish_stats(stats: dict, st: dict, n_triples: int, n_values: int,
                  t_wall: float) -> None:
    """Finish the engine's stats lanes (wall time, rates, rounded phase ms)
    and merge them into the caller's ingest dict and the registry mirror (so
    bytes/s, triples/s etc. reach the Prometheus exposition); the phase
    latencies also land in ``ingest_<phase>_ms`` histograms, as in the JAX
    package."""
    wall_s = max(time.perf_counter() - t_wall, 1e-9)
    st["wall_ms"] = round(wall_s * 1000.0, 1)
    st["triples"] = int(n_triples)
    st["values"] = int(n_values)
    st["triples_per_sec"] = round(n_triples / wall_s, 1)
    st["bytes_per_sec"] = round(st["bytes_read"] / wall_s, 1)
    for k in ("read_ms", "decode_ms", "parse_ms", "intern_ms", "merge_ms",
              "remap_ms", "queue_stall_ms"):
        if k in st:
            st[k] = round(st[k], 2)
            metrics.observe(f"ingest_{k}", st[k])
    metrics.observe("ingest_wall_ms", st["wall_ms"])
    metrics.mutate(stats, lambda c: c.update(st))


def ingest_files(paths, tabs: bool = False, expect_quad: bool = False,
                 skip_comments: bool = True, *, threads: int | None = None,
                 chunk_bytes: int | None = None, stats: dict | None = None):
    """Parse + intern all files natively.  Returns ((N, 3) int32 ids,
    Dictionary).

    ``threads`` (default: RDFIND_INGEST_THREADS, else the physical cores) > 1
    runs the parallel streaming engine; ``1`` the serial one.  The output is
    bit-identical either way.  ``stats``, when a dict, receives the ingest
    telemetry (bytes/s, triples/s, per-phase ms, thread count, queue stalls).

    Raises NativeIngestError on parse errors (the Python parser's ParseError
    surface) or if the library is unavailable.
    """
    if load() is None:
        raise NativeIngestError(f"native ingest unavailable: {_lib_error}")
    paths = list(paths)
    n_threads = ingest_threads(threads)
    with tracer.profile_range("rdfind.ingest"):
        if n_threads <= 1:
            return _ingest_serial(paths, tabs, expect_quad, skip_comments,
                                  stats)
        return _ingest_parallel(paths, tabs, expect_quad, skip_comments,
                                n_threads, chunk_bytes, stats)
