"""Multi-file, gz-aware line reading.

Many input paths (files, globs or directories), ``.gz`` files transparently
decompressed, comment lines (``#...``) skipped.  Input is read as UTF-8; bytes that
do not decode are replaced, never raised on.
"""

from __future__ import annotations

import glob
import gzip
import io
import os
from collections.abc import Iterator


def resolve_path_patterns(patterns) -> list[str]:
    """Expand globs / directories into a sorted file list."""
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
    if not out:
        raise FileNotFoundError("no input files")
    return out


def open_text(path: str):
    raw = gzip.open(path, "rb") if path.endswith(".gz") else open(path, "rb")
    return io.TextIOWrapper(raw, encoding="utf-8", errors="replace")


def iter_lines(paths, skip_comments: bool = True) -> Iterator[tuple[int, str]]:
    """Yield (file_id, line) over all files; comment lines (leading '#') skipped."""
    for file_id, path in enumerate(paths):
        with open_text(path) as f:
            for line in f:
                if skip_comments and line.startswith("#"):
                    continue
                yield file_id, line.rstrip("\n")
