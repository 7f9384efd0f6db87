"""The port's integrity plane against the JAX package's, on the CPU: for every
strategy the run certificate of the port's CLI carries the JAX CLI's output
digest, CIND count and stage digests on the same file; the gating, the
mismatch ledger and the certificate codec behave alike."""

import contextlib
import io
import json

import pytest

from rdfind_tpu.obs import integrity as jintegrity
from rdfind_tpu.obs import metrics as jmetrics
from rdfind_tpu.programs import rdfind as jcli
from rdfind_tpu_torch.obs import integrity as tintegrity
from rdfind_tpu_torch.obs import metrics as tmetrics
from rdfind_tpu_torch.obs import tracer as ttracer
from rdfind_tpu_torch.programs import rdfind as tcli
from rdfind_tpu_torch.utils import synth
from torch_harness import port_module, time_limit  # noqa: F401


@pytest.fixture(scope="module")
def nt_file(tmp_path_factory):
    path = tmp_path_factory.mktemp("nt") / "data.nt"
    t = synth.generate_triples(400, seed=9, n_predicates=6, n_entities=45)
    path.write_text("".join(f"<e{s}> <e{p}> <e{o}> .\n" for s, p, o in t))
    return str(path)


def certify(main, argv, cert, monkeypatch):
    monkeypatch.setenv("RDFIND_INTEGRITY", "1")
    monkeypatch.setenv("RDFIND_CERT", str(cert))
    err = io.StringIO()
    with contextlib.redirect_stderr(err):
        assert main([*argv, "--counters", "1"]) == 0
    return json.load(open(cert)), err.getvalue()


@pytest.mark.parametrize("flags", [
    ["--traversal-strategy", "0"], [], ["--traversal-strategy", "2"],
    ["--traversal-strategy", "3"],
    ["--traversal-strategy", "0", "--use-fis", "--clean-implied"]])
def test_certificate_matches_the_jax_cli(nt_file, tmp_path, monkeypatch,
                                         flags):
    argv = [nt_file, "--support", "3", *flags]
    want, _ = certify(jcli.main, argv, tmp_path / "jax.json", monkeypatch)
    got, err = certify(tcli.main, [*argv, "--device", "cpu"],
                       tmp_path / "torch.json", monkeypatch)
    assert want["n_cinds"] > 0
    for key in ("output_digest", "n_cinds", "stages", "input_signature",
                "format"):
        assert got[key] == want[key], key
    assert got["summary"] == want["summary"] == {
        "enabled": True, "strict": False, "verified": 1, "mismatches": 0,
        "repaired": 0}
    assert set(got["provenance"]) == set(want["provenance"])
    assert f"output-digest: {want['output_digest']}" in err
    tmetrics.reset()
    jmetrics.reset()


def test_no_certificate_without_integrity(nt_file, tmp_path, monkeypatch):
    monkeypatch.setenv("RDFIND_INTEGRITY", "0")
    monkeypatch.setenv("RDFIND_CERT", str(tmp_path / "c.json"))
    err = io.StringIO()
    with contextlib.redirect_stderr(err):
        assert tcli.main([nt_file, "--support", "3", "--device", "cpu",
                          "--counters", "1"]) == 0
    assert not (tmp_path / "c.json").exists()
    assert "output-digest" not in err.getvalue()


def test_gating_follows_the_consumers_like_jax(tmp_path, monkeypatch):
    monkeypatch.delenv("RDFIND_INTEGRITY", raising=False)
    monkeypatch.delenv("RDFIND_CERT", raising=False)
    assert not tintegrity.enabled() and not jintegrity.enabled()
    assert tintegrity.certificate_path() is None
    tmetrics.set_export(str(tmp_path / "m.prom"))
    try:
        assert tintegrity.enabled()
    finally:
        tmetrics.set_export(None)
    ttracer.start(str(tmp_path / "trace"))
    try:
        assert tintegrity.enabled()
        assert tintegrity.certificate_path() == str(
            tmp_path / "trace" / "run_certificate.json")
    finally:
        ttracer.stop()
    monkeypatch.setenv("RDFIND_INTEGRITY_STRICT", "1")
    assert tintegrity.strict() and jintegrity.strict()


def test_mismatch_ledger_matches_jax(monkeypatch):
    monkeypatch.setenv("RDFIND_INTEGRITY", "1")
    got, want = {}, {}
    for mod, stats in ((tintegrity, got), (jintegrity, want)):
        mod.publish_stage(stats, "pairs", 0x12345678, 0x9ABCDEF0, n=3)
        mod.note_mismatch(stats, site="host_pull", stage="pairs", pass_idx=2,
                          repaired=True)
        mod.note_mismatch(stats, site="snapshot", stage="cind")
        mod.summarize(stats)
    assert got == want
    assert got["integrity"]["mismatches"] == 2
    assert tintegrity.digest_sketch_rows(list(range(10)), 4) == \
        jintegrity.digest_sketch_rows(list(range(10)), 4)
    assert tintegrity.lanes_to_digest(-1, 5) == jintegrity.lanes_to_digest(
        -1, 5)
    tmetrics.reset()
    jmetrics.reset()


def test_certificate_write_is_atomic_json(tmp_path):
    cert = tintegrity.run_certificate(
        input_signature=[["a", 1, 2]], stages={"output": "00"},
        output_digest="00", provenance={"sha": None}, extra={"n_cinds": 0})
    assert cert == jintegrity.run_certificate(
        input_signature=[["a", 1, 2]], stages={"output": "00"},
        output_digest="00", provenance={"sha": None}, extra={"n_cinds": 0})
    tintegrity.write_certificate(str(tmp_path / "c.json"), cert)
    assert json.load(open(tmp_path / "c.json")) == cert
    assert [p.name for p in tmp_path.iterdir()] == ["c.json"]
