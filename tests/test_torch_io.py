"""The port's ingest helpers against the JAX package's, on the same files and
strings: the string trie, prefix parsing and URL shortening, asciify, and the
reader's name filter, BOM sniffing, per-file and gz encodings (the cases of
tests/test_io.py).  Every result must be equal; these modules are host Python in
both packages."""

import gzip

import pytest

from rdfind_tpu.io import prefixes as jprefixes
from rdfind_tpu.io import reader as jreader
from rdfind_tpu.utils.trie import StringTrie as JTrie
from rdfind_tpu_torch.io import prefixes as tprefixes
from rdfind_tpu_torch.io import reader as treader
from rdfind_tpu_torch.utils.trie import StringTrie as TTrie
from torch_harness import port_module, time_limit  # noqa: F401

PREFIX_LINES = [
    "@prefix dbr: <http://dbpedia.org/resource/> .",
    "@prefix dbp: <http://dbpedia.org/> .",
    "@PREFIX ex: <http://example.org/>",
    "  @prefix bare: http://bare.org/ns# .",
    "# not a prefix",
    "@prefix broken",
    "",
]
TERMS = ["<http://dbpedia.org/resource/Berlin>", "<http://dbpedia.org/ontology/x>",
         "<http://example.org/a>", "<http://other.org/>", '"literal"',
         "<http://bare.org/ns#x>", "_:b1", "<>", "<http://dbpedia.org/>"]


@pytest.mark.parametrize("squash", [False, True])
def test_trie_longest_prefix(squash):
    keys = {"http://dbpedia.org/resource/": "dbr:", "http://dbpedia.org/": "dbp:",
            "http://example.org/": "ex:", "": "root", "http://dbpedia.org/r": "r"}
    tries = []
    for cls in (JTrie, TTrie):
        t = cls()
        for k, v in keys.items():
            t[k] = v
        if squash:
            t.squash()
        tries.append(t)
    for q in [k + "x" for k in keys] + [t.strip("<>") for t in TERMS] + [""]:
        want = tries[0].longest_prefix_value(q)
        assert tries[1].longest_prefix_value(q) == want, q


@pytest.mark.parametrize("line", PREFIX_LINES)
def test_parse_prefix_line(line):
    assert tprefixes.parse_prefix_line(line) == jprefixes.parse_prefix_line(line)


def test_shorten_terms():
    pairs = [p for p in map(jprefixes.parse_prefix_line, PREFIX_LINES)
             if p is not None]
    assert len(pairs) == 4
    jt, tt = jprefixes.build_prefix_trie(pairs), tprefixes.build_prefix_trie(pairs)
    urls = dict(pairs)
    for term in TERMS:
        want = jprefixes.shorten_term(term, jt, urls)
        assert tprefixes.shorten_term(term, tt, urls) == want
    assert tprefixes.shorten_term(TERMS[0], tt, urls) == "dbr:Berlin"


@pytest.mark.parametrize("value", ["plain", "Zürich", "日本", "naïve café",
                                   '"Ångström"@de', "", "ǅemal ﬁ"])
def test_asciify(value):
    assert tprefixes.asciify(value) == jprefixes.asciify(value)


def test_reader_name_filter(tmp_path):
    (tmp_path / "a.nt").write_text("<s1> <p> <o> .\n")
    (tmp_path / "b.nt").write_text("<s2> <p> <o> .\n")
    (tmp_path / "skip.txt").write_text("junk\n")
    for rx in (r"\.nt$", r"^a", None):
        want = jreader.resolve_path_patterns([str(tmp_path)], name_filter=rx)
        assert treader.resolve_path_patterns([str(tmp_path)],
                                             name_filter=rx) == want
    with pytest.raises(FileNotFoundError, match="after filter"):
        treader.resolve_path_patterns([str(tmp_path)], name_filter=r"\.nope$")
    with pytest.raises(FileNotFoundError):
        treader.resolve_path_patterns([str(tmp_path / "none*.nt")])


def test_reader_gz_comments_and_sizes(tmp_path):
    plain = tmp_path / "a.nt"
    plain.write_text("# comment\n<s1> <p> <o> .\n")
    gz = tmp_path / "b.nt.gz"
    with gzip.open(gz, "wt") as f:
        f.write("<s2> <p> <o> .\n# another\n")
    paths = jreader.resolve_path_patterns([str(tmp_path / "*.nt*")])
    assert treader.resolve_path_patterns([str(tmp_path / "*.nt*")]) == paths
    assert list(treader.iter_lines(paths)) == list(jreader.iter_lines(paths))
    assert list(treader.iter_lines(paths, skip_comments=False)) == \
        list(jreader.iter_lines(paths, skip_comments=False))
    sizes = treader.input_sizes(paths + [str(tmp_path / "gone.nt")])
    assert sizes == jreader.input_sizes(paths + [str(tmp_path / "gone.nt")])
    assert sizes[-1] == 0 and sizes[0] > 0


@pytest.fixture
def bom_files(tmp_path):
    utf16 = tmp_path / "a.nt"
    utf16.write_bytes('<s1> <p> "héllo" .\n'.encode("utf-16"))
    utf8sig = tmp_path / "b.nt"
    utf8sig.write_bytes('<s2> <p> "x" .\n'.encode("utf-8-sig"))
    utf32 = tmp_path / "c.nt"
    utf32.write_bytes('<s3> <p> "ü" .\n'.encode("utf-32"))
    plain = tmp_path / "d.nt"
    plain.write_text('<s4> <p> "y" .\n')
    gz = tmp_path / "e.nt.gz"
    with gzip.open(gz, "wb") as f:
        f.write('<s5> <p> "zür" .\n'.encode("utf-16"))
    return [str(p) for p in (utf16, utf8sig, utf32, plain, gz)]


def test_reader_bom_sniff(bom_files):
    got = [treader.sniff_encoding(p) for p in bom_files]
    assert got == [jreader.sniff_encoding(p) for p in bom_files]
    assert got == ["utf-16", "utf-8-sig", "utf-32", "utf-8", "utf-16"]
    want = list(jreader.iter_lines(bom_files, encoding="auto"))
    assert list(treader.iter_lines(bom_files, encoding="auto")) == want
    assert [ln.split()[0] for _, ln in want] == ["<s1>", "<s2>", "<s3>",
                                                 "<s4>", "<s5>"]


def test_reader_per_file_encodings(tmp_path):
    latin = tmp_path / "latin.nt"
    latin.write_bytes('<s1> <p> "café" .\n'.encode("latin-1"))
    utf8 = tmp_path / "u.nt"
    utf8.write_text('<s2> <p> "naïve" .\n')
    paths = [str(latin), str(utf8)]
    for enc in ({"latin.nt": "latin-1", None: "utf-8"},
                {str(latin): "latin-1"},
                lambda p: "latin-1" if "latin" in p else "utf-8",
                lambda p: "auto", "latin-1", "utf-8", None):
        want = list(jreader.iter_lines(paths, encoding=enc))
        assert list(treader.iter_lines(paths, encoding=enc)) == want
        for p in paths:
            assert treader.encoding_for(p, enc) == jreader.encoding_for(p, enc)
    assert "café" in dict(treader.iter_lines(
        paths, encoding={"latin.nt": "latin-1"}))[0]


@pytest.mark.parametrize("enc", ["utf-8", "UTF-8", "utf8", "U8", "utf_8",
                                 "auto", "latin-1", "utf-16", "no-such-codec",
                                 None, {"a": "utf-8"}])
def test_is_utf8(enc):
    assert treader.is_utf8(enc) == jreader.is_utf8(enc)
