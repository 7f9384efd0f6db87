"""The port's native ingest against the JAX package's native ingest and against the
port's Python ingest, on the same files: equal id tables and dictionaries, with the
serial engine (1 thread) and the parallel one (4 threads, small chunks so that
files split across workers).  Invalid UTF-8 is compared with the JAX package's
native path only: there the native path is more exact than the Python reader's
errors="replace" (io/native.py).  The cases of tests/test_native.py."""

import gzip

import numpy as np
import pytest

from rdfind_tpu.io import native as jnative
from rdfind_tpu_torch.dictionary import intern_triples
from rdfind_tpu_torch.io import native as tnative
from rdfind_tpu_torch.io import ntriples, reader
from rdfind_tpu_torch.ops.build import BUILD_DIR
from torch_harness import port_module, time_limit  # noqa: F401

NT = """\
# a comment line
<http://ex/s1> <http://ex/p1> "plain literal" .
<http://ex/s1> <http://ex/p2> "esc \\" quote"@en .
<http://ex/s2> <http://ex/p1> "typed"^^<http://www.w3.org/2001/XMLSchema#string> .
_:blank1 <http://ex/p3> <http://ex/s1> .

<http://ex/s3> <http://ex/p1> "tab\\tin literal" .
<http://ex/s4> <http://ex/p1> "ünïcödé ✓" .
"""

NQ = """\
<http://ex/s1> <http://ex/p1> <http://ex/o1> <http://ex/g1> .
<http://ex/s2> <http://ex/p1> "lit" <http://ex/g2> .
"""

THREADS = [1, 4]


@pytest.fixture(scope="module", autouse=True)
def _jax_native():
    if not jnative.available():
        pytest.skip("the JAX package's native library is unavailable")


def python_path(paths, tabs=False, expect_quad=False):
    rows = []
    for _, line in reader.iter_lines(paths):
        t = (ntriples.parse_tab_line(line) if tabs
             else ntriples.parse_line(line, expect_quad=expect_quad))
        if t is not None:
            rows.append(t)
    return intern_triples(np.asarray(rows, dtype=object))


def assert_same(got, want):
    np.testing.assert_array_equal(got[0], want[0])
    assert got[0].dtype == np.int32
    assert list(got[1].values) == list(want[1].values)


def check(paths, threads, python=True, **kw):
    """Port native == JAX native (== the port's Python ingest)."""
    got = tnative.ingest_files(paths, threads=threads, chunk_bytes=64, **kw)
    assert_same(got, jnative.ingest_files(paths, threads=threads,
                                          chunk_bytes=64, **kw))
    if python:
        assert_same(got, python_path(paths, **kw))
    return got


def test_library_builds_from_the_repo_source_into_build():
    assert tnative.available(), tnative.unavailable_reason()
    path = tnative.library_path()
    assert path.parent == BUILD_DIR and path.exists()
    assert tnative.SOURCE.name == "rdfind_native.cpp"
    assert tnative.SOURCE.parent.name == "native"


@pytest.mark.parametrize("threads", THREADS)
def test_ntriples(tmp_path, threads):
    f = tmp_path / "a.nt"
    f.write_text(NT)
    check([str(f)], threads)


@pytest.mark.parametrize("threads", THREADS)
def test_gz_and_multifile(tmp_path, threads):
    f1 = tmp_path / "a.nt"
    f1.write_text(NT)
    f2 = tmp_path / "b.nt.gz"
    with gzip.open(f2, "wt") as g:
        g.write('<http://ex/sX> <http://ex/p1> "from gz" .\n' * 3)
    f3 = tmp_path / "c.nt"
    f3.write_text('<http://ex/s1> <http://ex/p9> <http://ex/sX> .\n')
    check([str(f1), str(f2), str(f3)], threads)


@pytest.mark.parametrize("threads", THREADS)
def test_nquads(tmp_path, threads):
    f = tmp_path / "a.nq"
    f.write_text(NQ)
    check([str(f)], threads, expect_quad=True)


@pytest.mark.parametrize("threads", THREADS)
def test_tabs(tmp_path, threads):
    f = tmp_path / "a.tsv"
    f.write_text("s1\tp1\to1\ns2\tp1\to2\n\ns1\tp2\to1\textra ignored\n")
    check([str(f)], threads, tabs=True)


@pytest.mark.parametrize("threads", THREADS)
def test_crlf_and_no_trailing_newline(tmp_path, threads):
    f = tmp_path / "a.nt"
    f.write_bytes(b"<s> <p> <o1> .\r\n<s> <p> <o2> .\r\n<s> <p> <o3> .")
    check([str(f)], threads)


@pytest.mark.parametrize("threads", THREADS)
def test_parse_error_surface(tmp_path, threads):
    f = tmp_path / "bad.nt"
    f.write_text("<http://ex/s1> <http://ex/p1>\n")
    with pytest.raises(tnative.NativeIngestError, match="expected 3 terms"):
        tnative.ingest_files([str(f)], threads=threads)
    with pytest.raises(jnative.NativeIngestError, match="expected 3 terms"):
        jnative.ingest_files([str(f)], threads=threads)
    with pytest.raises(ntriples.ParseError):
        python_path([str(f)])
    f.write_text('<s> <p> "never closed .\n')
    with pytest.raises(tnative.NativeIngestError,
                       match="unterminated literal"):
        tnative.ingest_files([str(f)], threads=threads)


@pytest.mark.parametrize("threads", THREADS)
def test_large_random(tmp_path, threads):
    rng = np.random.default_rng(0)
    lines = []
    for _ in range(3000):
        s = f"<http://ex/s{rng.integers(400)}>"
        p = f"<http://ex/p{rng.integers(12)}>"
        kind = rng.integers(3)
        if kind == 0:
            o = f"<http://ex/o{rng.integers(300)}>"
        elif kind == 1:
            o = f'"value {rng.integers(200)}"'
        else:
            o = f"_:b{rng.integers(50)}"
        lines.append(f"{s} {p} {o} .")
    f = tmp_path / "big.nt"
    f.write_text("\n".join(lines) + "\n")
    stats = {}
    ids, _ = tnative.ingest_files([str(f)], threads=threads, stats=stats)
    assert ids.shape == (3000, 3)
    assert stats["n_threads"] == threads and stats["triples"] == 3000
    check([str(f)], threads)


@pytest.mark.parametrize("threads", THREADS)
def test_invalid_utf8_across_chunk_boundaries(tmp_path, threads):
    """Invalid bytes in values parsed by different workers (64-byte chunks),
    some of which splice into valid sequences in the dictionary blob
    (b'a\\xc3' + b'\\xa9b' == 'a' + 'é' + 'b'): the port decodes per value and
    canonicalizes exactly like the JAX package's native path."""
    rows = [b"a\xc3\t\xa9b\tZ\n", b"x\xff\ty\tz\n", b"a\xc3\tq\tr\n",
            b"\xe2\x82\tpad-to-cross-the-next-chunk-boundary\tw\n",
            b"\xa9b\tZ\ta\xc3\n", b"ok\tok\tok\n"] * 4
    f = tmp_path / "splice.tsv"
    f.write_bytes(b"".join(rows))
    ids, dct = check([str(f)], threads, python=False, tabs=True)
    assert len(set(dct.values)) == len(dct.values)
    assert ids.shape == (len(rows), 3)
