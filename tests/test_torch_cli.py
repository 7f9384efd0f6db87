"""The port's CLI against the JAX package's: byte-identical output files for the
same input and flags, the same association-rule files, standard output (plan JSON,
histogram lines, collected CINDs) and counter lines, the runtime and
observability flags accepted, every flag of the sharded pipeline and the
preemption supervisor rejected by name, and the delta flags' misuse rejected as
the JAX CLI rejects it."""

import gzip
import json

import jax
import numpy as np
import pytest

from rdfind_tpu.programs import rdfind as jcli
from rdfind_tpu.utils.synth import write_nt
from rdfind_tpu_torch.programs import rdfind as tcli
from rdfind_tpu_torch.utils import synth


@pytest.fixture(autouse=True, scope="module")
def _release_jax_programs():
    """Drop the XLA programs compiled in and before this module: each keeps
    executable memory mappings, and a test process that gathers too many hits
    the kernel's per-process map limit (vm.max_map_count) inside XLA."""
    jax.clear_caches()
    yield
    jax.clear_caches()


@pytest.fixture(scope="module")
def nt_file(tmp_path_factory):
    path = tmp_path_factory.mktemp("nt") / "data.nt"
    write_nt(path, synth.generate_triples(600, seed=4, n_predicates=6,
                                          n_entities=50))
    return str(path)


@pytest.fixture(scope="module")
def small_nt_file(tmp_path_factory):
    """Fewer triples: without --use-fis every capture is kept, and strategies
    2 and 3 then build a sketch for each."""
    path = tmp_path_factory.mktemp("nt") / "small.nt"
    write_nt(path, synth.generate_triples(300, seed=4, n_predicates=6,
                                          n_entities=40))
    return str(path)


@pytest.mark.parametrize("flags", [
    [], ["--use-fis"], ["--use-fis", "--use-ars", "--clean-implied"],
    ["--projection", "po", "--clean-implied"]])
def test_output_file_is_byte_identical(nt_file, tmp_path, flags):
    common = [nt_file, "--support", "3", "--traversal-strategy", "0", *flags]
    out_j, out_t = tmp_path / "jax.txt", tmp_path / "torch.txt"
    assert jcli.main(common + ["--output", str(out_j)]) == 0
    assert tcli.main(common + ["--output", str(out_t), "--device", "cpu"]) == 0
    want = out_j.read_bytes()
    assert want.count(b"\n") > 0
    assert out_t.read_bytes() == want


@pytest.mark.parametrize("flags", [[], ["--use-fis", "--clean-implied"]])
@pytest.mark.parametrize("strategy", ["2", "3"])
def test_approximate_strategies_write_the_jax_file(small_nt_file, tmp_path,
                                                   strategy, flags):
    common = [small_nt_file, "--support", "3", "--traversal-strategy", strategy,
              *flags]
    out_j, out_t = tmp_path / "jax.txt", tmp_path / "torch.txt"
    assert jcli.main(common + ["--output", str(out_j)]) == 0
    assert tcli.main(common + ["--output", str(out_t), "--device", "cpu"]) == 0
    want = out_j.read_bytes()
    assert want.count(b"\n") > 0
    assert out_t.read_bytes() == want


def test_count_line_and_collect_result(nt_file, capsys):
    args = [nt_file, "--support", "3", "--traversal-strategy", "0"]
    assert jcli.main(args) == 0
    want = capsys.readouterr().out
    assert tcli.main(args + ["--device", "cpu"]) == 0
    assert capsys.readouterr().out == want
    assert tcli.main(args + ["--device", "cpu", "--collect-result"]) == 0
    assert capsys.readouterr().out.count(" < ") > 0


@pytest.mark.parametrize("flags", [
    [], ["--use-fis", "--clean-implied"], ["--balanced-overlap-candidates"],
    ["--traversal-strategy", "1", "--projection", "so"]])
def test_default_strategy_writes_the_jax_file(small_nt_file, tmp_path, flags):
    """No strategy flag: small-to-large, as in the JAX package's CLI."""
    common = [small_nt_file, "--support", "3", *flags]
    out_j, out_t = tmp_path / "jax.txt", tmp_path / "torch.txt"
    assert jcli.main(common + ["--output", str(out_j)]) == 0
    assert tcli.main(common + ["--output", str(out_t), "--device", "cpu"]) == 0
    want = out_j.read_bytes()
    assert want.count(b"\n") > 0
    assert out_t.read_bytes() == want


@pytest.mark.parametrize("argv,needle", [
    # The sharded pipeline's flags are ported: their misuse is rejected.
    (["--traversal-strategy", "1", "--dop", "2"], "item 2b"),
    (["--coordinator", "127.0.0.1:1", "--host-index", "3"], "--host-index"),
    (["--num-hosts", "2"], "--num-hosts"),
    (["--host-index", "1"], "--host-index"),
    (["--sharded-ingest"], "--sharded-ingest"),
    (["--interning", "replicated"], "--interning"),
    (["--rebalance-strategy", "3"], "--rebalance-strategy"),
    (["--rebalance-max-load=x"], "--rebalance-max-load"),
    (["--rebalance-threshold", "x"], "--rebalance-threshold"),
    (["--no-combinable-join=1"], "--no-combinable-join"),
    # The delta and console flags are ported: their misuse is rejected.
    (["--delta", "bundle", "--only-read"], "--delta"),
    (["--delta-state"], "--delta-state"),
    (["--deletes", "d.nt"], "--deletes"),
    (["--console-port", "x"], "--console-port"),
    (["--retry-on-preempt", "x"], "--retry-on-preempt"),
    (["--traversal-strategy", "0", "--projection", "x"], "--projection"),
])
def test_unported_flags_are_rejected_by_name(nt_file, capsys, argv, needle):
    with pytest.raises(SystemExit) as exc:
        tcli.main([nt_file, *argv, "--device", "cpu"])
    assert exc.value.code == 2
    assert needle in capsys.readouterr().err


def test_unported_holds_exactly_the_fifteen_flags():
    """Only the sharded ingest's two flags are left, pointing to item 2b."""
    assert sorted(tcli.UNPORTED) == ["--interning", "--sharded-ingest"]
    assert all("ROADMAP.md, queue 1, item 2b" in why
               for why in tcli.UNPORTED.values())


@pytest.mark.parametrize("strategy", ["1", "2", "3"])
def test_dop_with_an_unported_strategy_names_item_2b(nt_file, capsys,
                                                      strategy):
    with pytest.raises(SystemExit) as exc:
        tcli.main([nt_file, "--traversal-strategy", strategy, "--dop", "4",
                   "--device", "cpu"])
    assert exc.value.code == 2
    err = capsys.readouterr().err
    assert "item 2b" in err and "--traversal-strategy 0" in err


def test_sharded_flags_match_the_jax_cli():
    """--dop and the skew, supervisor and multi-host flags: the JAX CLI's
    defaults and choices."""
    jargs = {a.dest: a for a in jcli.build_parser()._actions}
    targs = {a.dest: a for a in tcli.build_parser()._actions}
    for dest in ("dop", "coordinator", "num_hosts", "host_index",
                 "no_combinable_join", "rebalance_strategy",
                 "rebalance_max_load", "rebalance_threshold",
                 "retry_on_preempt"):
        assert targs[dest].default == jargs[dest].default, dest
        assert targs[dest].choices == jargs[dest].choices, dest


@pytest.mark.parametrize("flag", ["--checkpoint-dir", "--trace",
                                  "--metrics-file", "--profile-dir",
                                  "--collector"])
def test_plane_flags_are_accepted(flag):
    args = tcli.build_parser().parse_args(["d.nt", flag, "x"])
    dest = {"--trace": "trace_dir"}.get(flag, flag[2:].replace("-", "_"))
    assert getattr(args, dest) == "x"
    assert flag not in tcli.UNPORTED
    jhelp = {a.option_strings[0]: a.help
             for a in jcli.build_parser()._actions if a.option_strings}
    thelp = {a.option_strings[0]: a.help
             for a in tcli.build_parser()._actions if a.option_strings}
    # The JAX package's help texts where they do not name JAX machinery (its
    # XLA profiler, TraceAnnotations, per-pass sharded checkpoints).
    if flag in ("--collector", "--metrics-file"):
        assert thelp[flag] == jhelp[flag]
    elif flag == "--trace":
        assert thelp[flag].split("Pairs")[0] == jhelp[flag].split("Pairs")[0]


def test_profile_dir_on_the_cpu_writes_a_loadable_trace(nt_file, tmp_path,
                                                        capsys):
    prof = tmp_path / "prof"
    assert tcli.main([nt_file, "--support", "3", "--traversal-strategy", "0",
                      "--device", "cpu", "--profile-dir", str(prof),
                      "--trace", str(tmp_path / "trace")]) == 0
    capsys.readouterr()
    events = json.load(open(prof / "profile.json"))["traceEvents"]
    names = {e.get("name") for e in events}
    # The tracer's stage spans appear as profiler ranges of the same names.
    assert {"read+parse", "discover", "write-certificate"} <= names
    assert any(str(n).startswith("rdfind.") for n in names)
    assert not any(e.get("cat") == "kernel" for e in events)


# Counter and debug lines that differ between two runs of one package (times,
# rates, memory) or between the packages' dense-plan descriptions, and the
# port's own lines: the ingest path taken, its integrity stages and chunk count.
VARIES = {"peak-rss-mb", "ingest-bytes-per-sec", "ingest-triples-per-sec",
          "ingest-queue-stalls",
          "stat-ingest", "stat-cooc_dtype", "stat-dense_plan",
          "stat-kernel_resolution", "stat-plane_bits", "stat-fuse_verdict",
          "ingest", "dense plan",
          "cooc dtype", "phase", "total", "csv"}
PORT_ONLY = {"ingest-path", "stat-integrity_stages", "stat-n_pair_chunks",
             "stat-n_blocks_skipped"}


def _keyed(err):
    """stderr as {key: line}, keyed by the text before the first colon."""
    out = {}
    for line in err.splitlines():
        key = line.split(":", 1)[0]
        key = key.split(" ", 1)[0] if key.startswith("phase ") else key
        out.setdefault(key, []).append(line)
    return out


def run_both(args, capsys, tmp_path):
    """Both CLIs on the same argv (the port's output files renamed); asserts
    equal stdout, output files, AR files and stderr lines (but VARIES) and
    returns the port's stderr lines by key."""
    def files(tag):
        out = []
        for a in args:
            out.append(a.replace("@", str(tmp_path / tag)))
        return out

    assert jcli.main(files("jax")) == 0
    j = capsys.readouterr()
    assert tcli.main(files("torch") + ["--device", "cpu"]) == 0
    t = capsys.readouterr()
    assert t.out.replace(str(tmp_path / "torch"), str(tmp_path / "jax")) \
        == j.out
    for a in args:
        if "@" in a:
            got = (tmp_path / ("torch" + a.split("@", 1)[1]))
            want = (tmp_path / ("jax" + a.split("@", 1)[1]))
            assert got.exists() == want.exists(), a
            if want.exists():
                assert got.read_bytes() == want.read_bytes(), a
    jk, tk = _keyed(j.err), _keyed(t.err)
    assert set(tk) - set(jk) <= PORT_ONLY | VARIES, set(tk) - set(jk)
    assert set(jk) - set(tk) <= VARIES, set(jk) - set(tk)
    for key in set(jk) - VARIES:
        assert tk[key] == jk[key], key
    if "--counters" in args:
        assert {"total", "csv"} <= set(tk)
    return tk


@pytest.fixture(scope="module")
def dup_nt_file(tmp_path_factory):
    """A file with repeated triples, for --distinct-triples."""
    path = tmp_path_factory.mktemp("nt") / "dup.nt"
    t = synth.generate_triples(300, seed=6, n_predicates=5, n_entities=40)
    write_nt(path, list(t) + list(t[:120]))
    return str(path)


@pytest.mark.parametrize("flags,ingest_path", [
    (["--explicit-threshold", "3"], "native"),
    (["--explicit-threshold", "0", "--sbf-bytes", "3",
      "--merge-window-size", "2048"], "native"),
    (["--explicit-threshold", "2", "--traversal-strategy", "0",
      "--merge-window-size", "4096"], "native"),
    (["--sbf-bytes=4"], "native"),
    (["--use-fis", "--use-ars", "--ar-output", "@ar.txt", "--debug-level",
      "2"], "native"),
    (["--use-fis", "--ar-output", "@ar.txt", "--traversal-strategy", "0"],
     "native"),
    (["--ar-output", "@ar.txt"], "native"),
    (["--find-only-fcs", "1"], "native"),
    (["--find-only-fcs", "2", "--use-fis", "--use-ars"], "native"),
    (["--create-join-histogram", "--do-only-join"], "native"),
    (["--create-join-histogram", "--traversal-strategy", "0",
      "--projection", "po"], "native"),
    (["--only-read"], "python"),
    (["--no-native-ingest", "--traversal-strategy", "2"], "python"),
    (["--debug-level", "3", "--use-fis"], "native"),
    (["--encoding", "UTF8", "--file-filter", r"\.nt$"], "native"),
    (["--no-bulk-merge", "--hash-bytes", "4", "--find-frequent-captures",
      "--rebalance-split", "2", "--hash-function", "SHA1",
      "--rebalance-join", "--any-binary-captures"], "native"),
])
def test_single_device_flags_match_jax(nt_file, capsys, tmp_path, flags,
                                       ingest_path):
    args = [nt_file, "--support", "3", "--output", "@out.txt",
            "--counters", "1", *flags]
    tk = run_both(args, capsys, tmp_path)
    assert tk["ingest-path"] == [f"ingest-path: {ingest_path}"]


def test_distinct_triples_match_jax(dup_nt_file, capsys, tmp_path):
    tk = run_both([dup_nt_file, "--support", "2", "--distinct-triples",
                   "--output", "@out.txt", "--counters", "1"], capsys, tmp_path)
    t = synth.generate_triples(300, seed=6, n_predicates=5, n_entities=40)
    n = len(np.unique(t, axis=0))
    assert n < 300
    assert tk["distinct-triples"] == [f"distinct-triples: {n}"]
    assert tk["input-triples"] == ["input-triples: 420"]


def test_print_plan_matches_jax(nt_file, capsys, tmp_path):
    args = [nt_file, "--support", "3", "--print-plan", "--output", "@o.txt",
            "--ar-output", "@ar.txt", "--explicit-threshold", "5", "--use-fis",
            "--use-ars", "--clean-implied", "--distinct-triples",
            "--asciify-triples", "--collect-result"]
    run_both(args, capsys, tmp_path)
    assert tcli.main([nt_file, "--print-plan", "--only-read", "--prefixes",
                      nt_file, "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    plan = json.loads(out[:out.rindex("}") + 1])
    assert plan["stages"]["ingest"] == ["read+parse", "shorten-urls",
                                        "intern"]
    assert plan["n_devices"] == 1


@pytest.fixture(scope="module")
def iri_files(tmp_path_factory):
    """Triples of full IRIs under two namespaces with non-ASCII literals, as
    N-Triples, N-Triples.gz, tab-separated, N-Quads, Latin-1 and UTF-16, and
    a prefix file for both namespaces."""
    d = tmp_path_factory.mktemp("iri")
    t = synth.generate_triples(300, seed=8, n_predicates=5, n_entities=40)
    ns = ["http://example.org/res/", "http://dbpedia.org/resource/"]
    words = ["Zürich", "café", "naïve", "plain"]

    def term(i, obj):
        if obj and i % 3 == 0:
            return f'"{words[i % 4]} {i % 7}"'
        return f"<{ns[i % 2]}e{i}>"

    rows = [(term(s, False), term(p, False), term(o, True)) for s, p, o in t]
    nt = "".join(f"{s} {p} {o} .\n" for s, p, o in rows)
    files = {}
    for name, data, enc in (("data.nt", nt, "utf-8"),
                            ("latin.nt", nt, "latin-1"),
                            ("bom.nt", nt, "utf-16")):
        files[name] = d / name
        files[name].write_bytes(data.encode(enc))
    files["data.nt.gz"] = d / "data.nt.gz"
    with gzip.open(files["data.nt.gz"], "wt") as f:
        f.write(nt)
    files["data.tsv"] = d / "data.tsv"
    files["data.tsv"].write_text(
        "".join(f"{s}\t{p}\t{o}\n" for s, p, o in rows))
    files["data.nq"] = d / "data.nq"
    files["data.nq"].write_text(
        "".join(f"{s} {p} {o} <http://g/{i % 3}> .\n"
                for i, (s, p, o) in enumerate(rows)))
    files["prefixes"] = d / "prefixes.ttl"
    files["prefixes"].write_text(
        "@prefix ex: <http://example.org/res/> .\n"
        "@prefix dbr: <http://dbpedia.org/resource/> .\n")
    return {k: str(v) for k, v in files.items()}


@pytest.mark.parametrize("inputs,flags,ingest_path", [
    (["data.nt"], ["--prefixes", "prefixes"], "python"),
    (["data.nt"], ["--asciify-triples"], "python"),
    (["data.nt"], ["--asciify-triples", "--prefixes", "prefixes"], "python"),
    (["data.nt.gz"], [], "native"),
    (["data.tsv"], ["--tabs"], "native"),
    (["data.nq"], [], "native"),
    (["latin.nt"], ["--encoding", "latin-1"], "python"),
    (["bom.nt"], ["--encoding", "auto"], "python"),
    (["data.nt", "data.nt.gz"], ["--traversal-strategy", "3"], "native"),
])
def test_ingest_options_match_jax(iri_files, capsys, tmp_path, inputs, flags,
                                  ingest_path):
    flags = [iri_files.get(f, f) for f in flags]
    args = [iri_files[i] for i in inputs] + [
        "--support", "3", "--output", "@out.txt", "--counters", "1", *flags]
    tk = run_both(args, capsys, tmp_path)
    assert tk["ingest-path"] == [f"ingest-path: {ingest_path}"]
    assert (tmp_path / "torchout.txt").read_text().count(" < ") > 0
