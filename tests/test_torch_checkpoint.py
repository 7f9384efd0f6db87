"""The port's stage checkpoints against the JAX package's, on the CPU: the same
fingerprints, codec arrays and stage files for the same file and flags; a
resumed CLI run is byte-identical (from the port's own stage files and from the
JAX package's); a changed flag, a torn file and a failed write are handled as
the JAX driver handles them."""

import contextlib
import io
import os

import numpy as np
import pytest

from rdfind_tpu.data import CindTable as JCindTable
from rdfind_tpu.dictionary import Dictionary as JDictionary
from rdfind_tpu.programs import rdfind as jcli
from rdfind_tpu.runtime import checkpoint as jcheckpoint
from rdfind_tpu.runtime import driver as jdriver
from rdfind_tpu_torch.data import CindTable as TCindTable
from rdfind_tpu_torch.dictionary import Dictionary as TDictionary
from rdfind_tpu_torch.programs import rdfind as tcli
from rdfind_tpu_torch.runtime import checkpoint as tcheckpoint
from rdfind_tpu_torch.runtime import driver as tdriver
from rdfind_tpu_torch.runtime import faults as tfaults
from rdfind_tpu_torch.utils import synth
from torch_harness import port_module, time_limit  # noqa: F401


@pytest.fixture(scope="module")
def nt_file(tmp_path_factory):
    path = tmp_path_factory.mktemp("nt") / "data.nt"
    t = synth.generate_triples(500, seed=4, n_predicates=6, n_entities=50)
    path.write_text("".join(f"<e{s}> <e{p}> <e{o}> .\n" for s, p, o in t))
    return str(path)


def cli(main, argv):
    """(rc, stderr counters {key: value}, phases in order) of one run."""
    err = io.StringIO()
    with contextlib.redirect_stderr(err):
        rc = main([*argv, "--counters", "1"])
    counters, phases = {}, []
    for line in err.getvalue().splitlines():
        if line.startswith("phase "):
            phases.append(line[len("phase "):line.rindex(":")])
        elif ": " in line:
            k, v = line.split(": ", 1)
            counters[k] = v
    return rc, counters, phases


def port(argv):
    return cli(tcli.main, [*argv, "--device", "cpu"])


FLAG_SETS = [
    [], ["--traversal-strategy", "0", "--use-fis"],
    ["--explicit-threshold", "4", "--sbf-bytes", "5"],
    ["--explicit-threshold", "4", "--traversal-strategy", "2"],
    ["--distinct-triples", "--clean-implied", "--projection", "po"],
    ["--no-native-ingest", "--use-fis", "--use-ars"],
    ["--asciify-triples", "--balanced-overlap-candidates"],
]


@pytest.mark.parametrize("flags", FLAG_SETS)
def test_fingerprints_match_the_jax_driver(nt_file, flags):
    """Both CLIs' parsers build each package's Config from the same argv; the
    payloads and fingerprints of both stages are equal."""
    argv = [nt_file, "--support", "3", *flags]
    tcfg = _config(tcli, tdriver, argv + ["--device", "cpu"])
    jcfg = _config(jcli, jdriver, argv)
    for use_native in (True, False):
        assert tdriver._checkpoint_payloads(tcfg, use_native) == \
            jdriver._checkpoint_payloads(jcfg, use_native)
        assert tdriver._checkpoint_fps(tcfg, use_native) == \
            jdriver._checkpoint_fps(jcfg, use_native)
    assert tcheckpoint.CHECKPOINT_FORMAT == jcheckpoint.CHECKPOINT_FORMAT


def _config(cli_mod, driver_mod, argv):
    """The Config a CLI would run, captured at driver.run."""
    seen = []

    class Stop(Exception):
        pass

    def capture(cfg):
        seen.append(cfg)
        raise Stop

    run = driver_mod.run
    driver_mod.run = capture
    try:
        with pytest.raises(Stop), contextlib.redirect_stderr(io.StringIO()):
            cli_mod.main(argv)
    finally:
        driver_mod.run = run
    return seen[0]


def test_codecs_match_jax():
    rng = np.random.default_rng(0)
    ids = rng.integers(0, 40, (60, 3)).astype(np.int32)
    values = np.array(sorted({f"<e{i}>" for i in range(40)} | {'"Zürich"'}),
                      dtype=object)
    got = tcheckpoint.encode_ingest(ids, TDictionary(values))
    want = jcheckpoint.encode_ingest(ids, JDictionary(values))
    _equal_arrays(got, want)
    back_ids, back = tcheckpoint.decode_ingest(got)
    np.testing.assert_array_equal(back_ids, ids)
    assert list(back.values) == list(values)

    cols = [rng.integers(0, 99, 25) for _ in range(7)]
    _equal_arrays(tcheckpoint.encode_cinds(TCindTable(*cols)),
                  jcheckpoint.encode_cinds(JCindTable(*cols)))
    assert tcheckpoint.decode_cinds(tcheckpoint.encode_cinds(
        TCindTable(*cols))).to_rows() == TCindTable(*cols).to_rows()

    rules = [rng.integers(0, 9, 4) for _ in range(5)]
    stats = {"total_pairs": 7, "pair_backend": "chunked", "frac": 0.5,
             "dense_plan": {"tile": 128, "nested": {"a": 1}}, "flag": True,
             "skipped": object(), "association_rules": rules}
    got = tcheckpoint.encode_stats(stats)
    _equal_arrays(got, jcheckpoint.encode_stats(stats))
    decoded = tcheckpoint.decode_stats(got)
    assert decoded == {**jcheckpoint.decode_stats(got),
                       "association_rules": decoded["association_rules"]}
    assert "skipped" not in decoded
    for a, b in zip(decoded["association_rules"], rules):
        np.testing.assert_array_equal(a, b)


def _equal_arrays(got: dict, want: dict):
    assert sorted(got) == sorted(want)
    for k in got:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        assert np.asarray(got[k]).dtype == np.asarray(want[k]).dtype, k


def _stage(directory, name):
    with np.load(os.path.join(directory, f"{name}.npz")) as z:
        return {k: z[k] for k in z.files}


@pytest.fixture(scope="module")
def checkpointed(nt_file, tmp_path_factory):
    """The JAX CLI and the port's CLI, each with --checkpoint-dir, once."""
    d = tmp_path_factory.mktemp("ck")
    argv = [nt_file, "--support", "3", "--traversal-strategy", "0"]
    j = cli(jcli.main, [*argv, "--checkpoint-dir", str(d / "jax"),
                        "--output", str(d / "jax.txt")])
    t = port([*argv, "--checkpoint-dir", str(d / "torch"),
              "--output", str(d / "torch.txt")])
    return d, argv, j, t


def test_stage_files_match_jax(checkpointed):
    d, _, (jrc, _, jphases), (trc, _, tphases) = checkpointed
    assert jrc == trc == 0
    assert (d / "torch.txt").read_bytes() == (d / "jax.txt").read_bytes()
    assert "checkpoint-ingest" in tphases and "checkpoint-discover" in tphases
    for stage in ("ingest", "discover"):
        got, want = _stage(d / "torch", stage), _stage(d / "jax", stage)
        # Pipeline stats ride along in __stats__; the packages' stats keys
        # differ (each names its own dense plan), the rest must be equal.
        got.pop("__stats__", None)
        want.pop("__stats__", None)
        _equal_arrays(got, want)


def test_cli_resume_is_byte_identical(checkpointed, tmp_path):
    d, argv, _, _ = checkpointed
    rc, counters, phases = port([*argv, "--checkpoint-dir", str(d / "torch"),
                                 "--output", str(tmp_path / "again.txt")])
    assert rc == 0
    assert counters["resumed-ingest"] == "1"
    assert counters["resumed-discover"] == "1"
    assert phases[:2] == ["resume-ingest", "resume-discover"]
    assert "discover" not in phases and "read+parse" not in phases
    assert (tmp_path / "again.txt").read_bytes() == \
        (d / "torch.txt").read_bytes()


def test_port_resumes_from_the_jax_stage_files(checkpointed, tmp_path):
    d, argv, (_, jcounters, _), _ = checkpointed
    rc, counters, phases = port([*argv, "--checkpoint-dir", str(d / "jax"),
                                 "--output", str(tmp_path / "from_jax.txt")])
    assert rc == 0 and counters["resumed-discover"] == "1"
    assert counters["cind-counter"] == jcounters["cind-counter"]
    assert counters["input-triples"] == jcounters["input-triples"]
    assert (tmp_path / "from_jax.txt").read_bytes() == \
        (d / "jax.txt").read_bytes()


def test_a_flag_change_invalidates_discover_not_ingest(nt_file, tmp_path):
    ck = str(tmp_path / "ck")
    base = [nt_file, "--checkpoint-dir", ck, "--traversal-strategy", "0"]
    assert port([*base, "--support", "3"])[0] == 0
    rc, counters, phases = port([*base, "--support", "4",
                                 "--output", str(tmp_path / "s4.txt")])
    assert rc == 0 and counters["resumed-ingest"] == "1"
    assert "resumed-discover" not in counters and "discover" in phases
    _, fresh, _ = port([nt_file, "--support", "4", "--traversal-strategy",
                        "0", "--output", str(tmp_path / "fresh.txt")])
    assert (tmp_path / "s4.txt").read_bytes() == \
        (tmp_path / "fresh.txt").read_bytes()
    assert counters["cind-counter"] == fresh["cind-counter"]


@pytest.mark.parametrize("damage", ["truncate", "corrupt", "empty"])
def test_a_torn_stage_file_is_a_clean_miss(nt_file, tmp_path, damage):
    ck = tmp_path / "ck"
    argv = [nt_file, "--support", "3", "--checkpoint-dir", str(ck)]
    assert port([*argv, "--output", str(tmp_path / "a.txt")])[0] == 0
    for stage in ("ingest", "discover"):
        path = ck / f"{stage}.npz"
        data = path.read_bytes()
        if damage == "truncate":
            path.write_bytes(data[:len(data) // 2])
        elif damage == "corrupt":
            path.write_bytes(data[:64] + bytes(b ^ 0xFF for b in data[64:]))
        else:
            path.write_bytes(b"")
    rc, counters, phases = port([*argv, "--output", str(tmp_path / "b.txt")])
    assert rc == 0
    assert "resumed-ingest" not in counters
    assert "resumed-discover" not in counters
    assert phases[0] == "read+parse"
    assert (tmp_path / "b.txt").read_bytes() == \
        (tmp_path / "a.txt").read_bytes()
    assert tcheckpoint.CheckpointStore(str(ck)).load("discover", "x") is None


def test_a_failed_checkpoint_write_leaves_the_run_intact(nt_file, tmp_path,
                                                         monkeypatch):
    argv = [nt_file, "--support", "3"]
    assert port([*argv, "--output", str(tmp_path / "clean.txt")])[0] == 0
    monkeypatch.setenv("RDFIND_FAULTS", "checkpoint_write")
    tfaults.reset()
    try:
        rc, counters, _ = port([*argv, "--checkpoint-dir",
                                str(tmp_path / "ck"),
                                "--output", str(tmp_path / "faulty.txt")])
    finally:
        tfaults.reset()
    assert rc == 0
    assert counters["checkpoint-errors"] == "1"
    assert (tmp_path / "faulty.txt").read_bytes() == \
        (tmp_path / "clean.txt").read_bytes()
    # The ingest stage failed, the discover stage was written.
    assert not (tmp_path / "ck" / "ingest.npz").exists()
    assert (tmp_path / "ck" / "discover.npz").exists()


def test_progress_store_round_trips(tmp_path):
    store = tcheckpoint.CheckpointStore(str(tmp_path))
    progress = tcheckpoint.ProgressStore(store, base_fp="base")
    stage, fp = progress.phase_fp("pair phase/cind", 0)
    assert (stage, fp) == jcheckpoint.ProgressStore(
        jcheckpoint.CheckpointStore(str(tmp_path / "j")),
        base_fp="base").phase_fp("pair phase/cind", 0)
    parts = {0: ([np.arange(5), np.array([[1, 2]], np.int32)], (3, 4, 5)),
             2: ([np.arange(3) * 7, np.zeros((0, 2), np.int32)], (1, 0, 9))}
    _equal_arrays(tcheckpoint.encode_progress(parts, num_dev=8, n_pass=4),
                  jcheckpoint.encode_progress(parts, num_dev=8, n_pass=4))
    progress.submit(stage, fp, parts, num_dev=8, n_pass=4)
    progress.flush()
    snap = progress.load(stage, fp)
    assert (snap.num_dev, snap.n_pass) == (8, 4)
    assert sorted(snap.parts) == [0, 2]
    for p, (blocks, tele) in parts.items():
        got_blocks, got_tele = snap.parts[p]
        assert got_tele == tele
        for a, b in zip(got_blocks, blocks):
            np.testing.assert_array_equal(a, b)
    assert progress.load(stage, "other") is None
    progress.cleanup()
    assert not os.path.exists(os.path.join(str(tmp_path), f"{stage}.npz"))
