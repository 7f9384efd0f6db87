"""Multi-file, gz-aware line reading with file ids and glob resolution.

The analog of MultiFileTextInputFormat (rdfind-flink/.../persistence/
MultiFileTextInputFormat.java:49-368): many input paths, each line tagged with
its file id, .gz files transparently decompressed (gz is unsplittable there
too, :225-230), comment lines (#...) filterable, regex file-name filters
(:76-100,219-231), and per-file encodings with BOM detection (the Encoding
role, rdfind-flink/.../util/Encoding.java:15-156).

``encoding`` accepts:
  * a str — one charset for every file; ``"auto"`` sniffs a BOM per file and
    falls back to UTF-8;
  * a dict — per-file charsets keyed by full path or basename (missing keys
    fall back to the dict's ``None`` entry, then UTF-8);
  * a callable ``path -> charset``.
"""

from __future__ import annotations

import codecs
import glob
import gzip
import io
import os
import re
from collections.abc import Iterator

# Checked in order: UTF-32 BOMs start with the UTF-16 ones, so they go first.
# Mapped to the self-detecting codec names, which strip the BOM on decode.
_BOMS = (
    (codecs.BOM_UTF32_LE, "utf-32"),
    (codecs.BOM_UTF32_BE, "utf-32"),
    (codecs.BOM_UTF8, "utf-8-sig"),
    (codecs.BOM_UTF16_LE, "utf-16"),
    (codecs.BOM_UTF16_BE, "utf-16"),
)


def resolve_path_patterns(patterns, name_filter: str | None = None) -> list[str]:
    """Expand globs / directories into a sorted file list (RDFind.resolvePathPatterns).

    ``name_filter``: regex applied to file basenames, like the reference's
    file-filtered directory scan (MultiFileTextInputFormat.java:76-100).
    """
    out = []
    for pat in patterns:
        if os.path.isdir(pat):
            out.extend(sorted(
                os.path.join(pat, f) for f in os.listdir(pat)
                if os.path.isfile(os.path.join(pat, f))))
        else:
            matches = sorted(glob.glob(pat))
            if not matches and os.path.isfile(pat):
                matches = [pat]
            if not matches:
                raise FileNotFoundError(f"no input files match {pat!r}")
            out.extend(matches)
    if name_filter is not None:
        rx = re.compile(name_filter)
        out = [p for p in out if rx.search(os.path.basename(p))]
    if not out:
        raise FileNotFoundError("no input files"
                                + (f" (after filter {name_filter!r})"
                                   if name_filter else ""))
    return out


def _open_raw(path: str):
    return gzip.open(path, "rb") if path.endswith(".gz") else open(path, "rb")


def input_sizes(paths) -> list[int]:
    """On-disk byte size per input file (0 for unstatable paths).

    Feeds ingest telemetry and the parallel ingest's unit planning:
    uncompressed bytes are what the byte-range chunker splits, while .gz
    sizes only bound file-level parallelism (gz members cannot be
    seek-split, so they always parse as one unit)."""
    out = []
    for p in paths:
        try:
            out.append(os.path.getsize(p))
        except OSError:
            out.append(0)
    return out


def sniff_encoding(path: str, default: str = "utf-8") -> str:
    """Detect a BOM (gz-aware) and return the matching codec; else ``default``."""
    with _open_raw(path) as f:
        head = f.read(4)
    for bom, name in _BOMS:
        if head.startswith(bom):
            return name
    return default


def encoding_for(path: str, encoding) -> str:
    """Resolve the per-file charset from a str/dict/callable spec."""
    if callable(encoding):
        enc = encoding(path)
    elif isinstance(encoding, dict):
        enc = encoding.get(path, encoding.get(os.path.basename(path),
                                              encoding.get(None, "utf-8")))
    else:
        enc = encoding or "utf-8"
    enc = enc or "utf-8"
    if enc == "auto":
        return sniff_encoding(path)
    return enc


def is_utf8(encoding) -> bool:
    """True when ``encoding`` names UTF-8 under any alias (UTF-8, utf8, U8...).

    Gate for the UTF-8-only native ingest.  ``"auto"`` (BOM sniff) and
    dict/callable per-file specs are not statically UTF-8, so they return
    False; unknown codec names also return False rather than raising.
    """
    if not isinstance(encoding, str) or encoding == "auto":
        return False
    try:
        return codecs.lookup(encoding).name == "utf-8"
    except LookupError:
        return False


def open_text(path: str, encoding="utf-8"):
    enc = encoding_for(path, encoding)
    return io.TextIOWrapper(_open_raw(path), encoding=enc, errors="replace")


def iter_lines(paths, skip_comments: bool = True,
               encoding="utf-8") -> Iterator[tuple[int, str]]:
    """Yield (file_id, line) over all files; comment lines (leading '#') skipped."""
    for file_id, path in enumerate(paths):
        with open_text(path, encoding) as f:
            for line in f:
                if skip_comments and line.startswith("#"):
                    continue
                yield file_id, line.rstrip("\n")
