"""The port's incremental discovery (``runtime/delta.py``, ``--delta``) against
the JAX package's: a change batch replayed through the port's CLI writes the
bytes of the port's from-scratch run and of the JAX package's delta run, for
strategies 0-3 and the ``--clean-implied`` / ``--use-fis`` knobs; bundles
written by either package are continued by the other with equal digests; the
degradation ladder (rebuild, full fallback, exit 66) behaves as the JAX
package's; and the host helpers the bundle layout rests on
(``hashing.host_bucket_of``, ``synth.grow_delta_batches`` / ``apply_delta``)
are bit-equal to the JAX package's."""

import ast
import json
import os
import shutil

import numpy as np
import pytest

from rdfind_tpu.ops import hashing as jhashing
from rdfind_tpu.programs import rdfind as jcli
from rdfind_tpu.runtime import delta as jdelta
from rdfind_tpu.utils import synth as jsynth
from rdfind_tpu_torch.ops import hashing
from rdfind_tpu_torch.programs import rdfind as tcli
from rdfind_tpu_torch.runtime import delta
from rdfind_tpu_torch.utils import synth
from torch_harness import port_module, time_limit  # noqa: F401

SUPPORT = "3"
# The new digests of a generation: equal whichever package wrote it.
DIGESTS = ("pass_digests", "full_digest", "ingest_digest", "dict_digest",
           "output_digest", "base_output_digest", "generation", "n_rows",
           "n_full", "n_triples", "n_values", "batch")


@pytest.fixture(autouse=True)
def _clean_env(monkeypatch):
    for k in ("RDFIND_DELTA_BUCKETS", "RDFIND_DELTA_PASSES",
              "RDFIND_DELTA_VERIFY", "RDFIND_DELTA_FULL_FRAC",
              "RDFIND_INTEGRITY", "RDFIND_CERT", "RDFIND_SERVE_INDEX"):
        monkeypatch.delenv(k, raising=False)


@pytest.fixture(scope="module")
def workload(tmp_path_factory):
    """~940 triples: planted CINDs over a zipf background (so the strategies'
    raw outputs differ), a 1 % insert/delete batch and the updated dataset,
    as .nt files.  The batch dirties ~3 % of the evidence: the incremental
    path."""
    d = tmp_path_factory.mktemp("tdelta")
    bg = synth.generate_triples(300, seed=3, n_predicates=8, n_entities=200)
    triples, _ = synth.generate_planted_cinds(10, 3, base_triples=bg, seed=3)
    ins, dels = synth.grow_delta_batches(triples, 0.01, seed=4)
    paths = {k: str(d / f"{k}.nt") for k in ("base", "ins", "del", "upd",
                                             "upd_del_only")}
    jsynth.write_nt(paths["base"], triples)
    jsynth.write_nt(paths["ins"], ins)
    jsynth.write_nt(paths["del"], dels)
    jsynth.write_nt(paths["upd"], synth.apply_delta(triples, ins, dels))
    jsynth.write_nt(paths["upd_del_only"], synth.apply_delta(
        triples, np.zeros((0, 3), np.int64), dels))
    return {"triples": triples, "paths": paths, "dir": d}


def _tcli(args, rc=0):
    got = tcli.main([str(a) for a in args] + ["--device", "cpu"])
    assert got == rc, (got, args)


def _jcli(args, rc=0):
    got = jcli.main([str(a) for a in args])
    assert got == rc, (got, args)


def _meta(bundle):
    return json.loads(np.load(os.path.join(bundle, "delta-meta.npz"))
                      ["meta_json"].tobytes().decode())


def _read(path):
    with open(path, "rb") as f:
        return f.read()


@pytest.fixture(scope="module")
def s0_bundle(workload):
    """A generation-0 bundle of the port (strategy 0, the cheap path); tests
    copy it, since a delta run advances it in place."""
    b = str(workload["dir"] / "s0_bundle")
    _tcli([workload["paths"]["base"], "--support", SUPPORT,
           "--traversal-strategy", "0", "--delta-state", b])
    return b


def _fresh(bundle, tmp_path, name="bundle"):
    dst = str(tmp_path / name)
    shutil.copytree(bundle, dst)
    return dst


def _delta(run, p, bundle, common, out, rc=0, deletes_only=False):
    args = ([] if deletes_only else [p["ins"]]) + [
        "--delta", bundle, "--deletes", p["del"], *common, "--output", out]
    run(args, rc)


@pytest.mark.parametrize("strategy,flags", [
    ("0", []), ("1", []), ("2", ["--use-fis"]), ("3", ["--use-fis"]),
    ("1", ["--use-fis", "--clean-implied"])])
def test_delta_output_equals_scratch_and_jax(workload, tmp_path, strategy,
                                             flags):
    """Port base + port delta == port from-scratch == the JAX package's delta
    on a copy of the same base, byte for byte, on the incremental path; both
    generation-1 bundles carry the same digests."""
    p = workload["paths"]
    common = ["--support", SUPPORT, "--traversal-strategy", strategy, *flags]
    bt = str(tmp_path / "bt")
    _tcli([p["base"], *common, "--delta-state", bt])
    bj = _fresh(bt, tmp_path, "bj")
    out = {k: str(tmp_path / f"{k}.txt") for k in ("t", "j", "scratch")}
    _delta(_tcli, p, bt, common, out["t"])
    _delta(_jcli, p, bj, common, out["j"])
    _tcli([p["upd"], *common, "--output", out["scratch"]])
    want = _read(out["scratch"])
    assert want.count(b"\n") > 50
    assert _read(out["t"]) == want
    assert _read(out["j"]) == want
    mt, mj = _meta(bt), _meta(bj)
    assert mt["generation"] == 1
    assert {k: mt[k] for k in DIGESTS} == {k: mj[k] for k in DIGESTS}


def test_delta_takes_the_incremental_path_with_pass_reuse(workload,
                                                          s0_bundle,
                                                          tmp_path, capsys):
    p = workload["paths"]
    bundle = _fresh(s0_bundle, tmp_path)
    _delta(_tcli, p, bundle, ["--support", SUPPORT, "--traversal-strategy",
                              "0", "--counters", "1"],
           str(tmp_path / "d.txt"))
    line = next(ln for ln in capsys.readouterr().err.splitlines()
                if ln.startswith("stat-delta: "))
    st = ast.literal_eval(line.split(": ", 1)[1])  # a dict
    assert st["path"] == "incremental"
    assert 0 < st["passes_rerun"] < st["n_passes"]
    assert st["passes_reused"] == st["n_passes"] - st["passes_rerun"]
    assert st["affected_captures"] > 0 and st["new_generation"] == 1


@pytest.mark.parametrize("writer,strategy", [("jax", "0"), ("port", "1")])
def test_bundles_cross_between_the_packages(workload, tmp_path, writer,
                                            strategy):
    """A bundle written by one package, advanced by the other's delta run:
    the same output and the same new digests as the writer's own delta.  A
    JAX-written generation 0 equals the port's, digest for digest."""
    p = workload["paths"]
    common = ["--support", SUPPORT, "--traversal-strategy", strategy]
    base = str(tmp_path / "base")
    first, second = (_jcli, _tcli) if writer == "jax" else (_tcli, _jcli)
    first([p["base"], *common, "--delta-state", base])
    if writer == "jax":
        twin = str(tmp_path / "twin")
        _tcli([p["base"], *common, "--delta-state", twin])
        assert {k: _meta(twin)[k] for k in DIGESTS} == \
            {k: _meta(base)[k] for k in DIGESTS}
    own, other = _fresh(base, tmp_path, "own"), _fresh(base, tmp_path, "other")
    o_own, o_other = str(tmp_path / "own.txt"), str(tmp_path / "other.txt")
    _delta(first, p, own, common, o_own)
    _delta(second, p, other, common, o_other)
    assert _read(o_other) == _read(o_own)
    assert {k: _meta(other)[k] for k in DIGESTS} == \
        {k: _meta(own)[k] for k in DIGESTS}
    assert not jdelta.load_bundle(other, min_support=3, projections="spo",
                                  distinct=False).degraded
    assert not delta.load_bundle(own, min_support=3, projections="spo",
                                 distinct=False).degraded


def test_chained_generations_stay_identical(workload, s0_bundle, tmp_path):
    """Generation 1 is itself a base: a second batch (the first undone) gives
    the from-scratch bytes of the original data."""
    p = workload["paths"]
    bundle = _fresh(s0_bundle, tmp_path)
    common = ["--support", SUPPORT, "--traversal-strategy", "0"]
    _delta(_tcli, p, bundle, common, str(tmp_path / "g1.txt"))
    g2, scratch = str(tmp_path / "g2.txt"), str(tmp_path / "s.txt")
    _tcli([p["del"], "--delta", bundle, "--deletes", p["ins"], *common,
           "--output", g2])
    _tcli([p["base"], *common, "--output", scratch])
    assert sorted(_read(g2).splitlines()) == sorted(_read(scratch).splitlines())
    assert _meta(bundle)["generation"] == 2


def test_delete_only_batch(workload, s0_bundle, tmp_path):
    p = workload["paths"]
    bundle = _fresh(s0_bundle, tmp_path)
    common = ["--support", SUPPORT, "--traversal-strategy", "0"]
    out, scratch = str(tmp_path / "d.txt"), str(tmp_path / "s.txt")
    _delta(_tcli, p, bundle, common, out, deletes_only=True)
    _tcli([p["upd_del_only"], *common, "--output", scratch])
    assert _read(out) == _read(scratch)
    assert _meta(bundle)["batch"]["inserts"] == 0


def test_large_batch_falls_back_to_a_full_run(workload, s0_bundle, tmp_path,
                                              monkeypatch, capsys):
    """A batch dirtying more than RDFIND_DELTA_FULL_FRAC of the evidence runs
    a full re-discovery: named, and still the from-scratch bytes."""
    p = workload["paths"]
    monkeypatch.setenv("RDFIND_DELTA_FULL_FRAC", "0.001")
    bundle = _fresh(s0_bundle, tmp_path)
    common = ["--support", SUPPORT, "--traversal-strategy", "0"]
    out, scratch = str(tmp_path / "d.txt"), str(tmp_path / "s.txt")
    _delta(_tcli, p, bundle, common + ["--counters", "1"], out)
    assert "'path': 'full-fallback'" in capsys.readouterr().err
    _tcli([p["upd"], *common, "--output", scratch])
    assert _read(out) == _read(scratch)


@pytest.mark.parametrize("stage,note", [
    ("delta-evidence", "evidence-stage-missing"),
    ("delta-cinds", "cinds-stage-missing")])
def test_missing_stage_degrades_named_and_exact(workload, s0_bundle,
                                                tmp_path, capsys, stage,
                                                note):
    """A lost evidence stage is rebuilt from the bundled triples, a lost
    cinds stage forces the full fallback: both named, both exact."""
    p = workload["paths"]
    bundle = _fresh(s0_bundle, tmp_path)
    os.unlink(os.path.join(bundle, f"{stage}.npz"))
    common = ["--support", SUPPORT, "--traversal-strategy", "0"]
    out, scratch = str(tmp_path / "d.txt"), str(tmp_path / "s.txt")
    _delta(_tcli, p, bundle, common + ["--counters", "1"], out)
    err = capsys.readouterr().err
    assert f"delta base degraded: {note}" in err
    if stage == "delta-cinds":
        assert "'path': 'full-fallback'" in err
    _tcli([p["upd"], *common, "--output", scratch])
    assert _read(out) == _read(scratch)


def _tamper(bundle, stage, key, flip):
    """Rewrite one stage with `key` changed and its fingerprint intact: a
    silent flip only the digests can see."""
    path = os.path.join(bundle, f"{stage}.npz")
    z = dict(np.load(path))
    z[key] = flip(z[key].copy())
    np.savez(path, **z)


def _flip_first(a):
    a.reshape(-1)[1] ^= 1
    return a


@pytest.mark.parametrize("stage,key,want", [
    ("delta-evidence", "rows", "evidence-digest-mismatch"),
    ("delta-cinds", "full", "cinds-digest-mismatch"),
    ("delta-ingest", "ids", "untrustable")])
def test_tampered_stage_is_caught_like_jax(s0_bundle, tmp_path, stage, key,
                                           want):
    """Corrupt evidence -> rebuild, corrupt cinds -> full fallback, corrupt
    ingest -> DeltaBaseError; the JAX package's loader judges the same
    bundle alike."""
    bundle = _fresh(s0_bundle, tmp_path)
    _tamper(bundle, stage, key, _flip_first)
    kw = dict(min_support=3, projections="spo", distinct=False)
    if want == "untrustable":
        with pytest.raises(delta.DeltaBaseError, match="digest mismatch"):
            delta.load_bundle(bundle, **kw)
        with pytest.raises(jdelta.DeltaBaseError, match="digest mismatch"):
            jdelta.load_bundle(bundle, **kw)
        return
    got = delta.load_bundle(bundle, **kw)
    assert got.degraded == [want]
    assert got.degraded == jdelta.load_bundle(bundle, **kw).degraded
    assert (got.rows if key == "rows" else got.full) is None


@pytest.mark.parametrize("corrupt", ["meta", "knob", "ingest", "absent"])
def test_untrustable_base_exits_66(workload, s0_bundle, tmp_path, capsys,
                                   corrupt):
    """A corrupt or stale meta, a knob the bundle was not built with, a lost
    ingest stage or no bundle at all: exit 66, naming the miss."""
    p = workload["paths"]
    bundle = _fresh(s0_bundle, tmp_path)
    support = SUPPORT
    if corrupt == "meta":
        with open(os.path.join(bundle, "delta-meta.npz"), "wb") as f:
            f.write(b"not an npz")
    elif corrupt == "knob":
        support = "4"
    elif corrupt == "ingest":
        os.unlink(os.path.join(bundle, "delta-ingest.npz"))
    else:
        bundle = str(tmp_path / "nothere")
    _delta(_tcli, p, bundle, ["--support", support], str(tmp_path / "o.txt"),
           rc=66)
    assert "delta base unusable" in capsys.readouterr().err


def test_certificate_chains_onto_the_base(workload, tmp_path, monkeypatch):
    """The delta certificate names its base (base_output_digest == the base
    certificate's output_digest) and carries the JAX delta's digest."""
    p = workload["paths"]
    common = ["--support", SUPPORT, "--traversal-strategy", "0"]
    monkeypatch.setenv("RDFIND_INTEGRITY", "1")
    certs = {k: str(tmp_path / f"{k}.json") for k in ("base", "t", "j")}
    bt, bj = str(tmp_path / "bt"), str(tmp_path / "bj")
    monkeypatch.setenv("RDFIND_CERT", certs["base"])
    _tcli([p["base"], *common, "--delta-state", bt])
    shutil.copytree(bt, bj)
    for run, bundle, key in ((_tcli, bt, "t"), (_jcli, bj, "j")):
        monkeypatch.setenv("RDFIND_CERT", certs[key])
        _delta(run, p, bundle, common, str(tmp_path / f"{key}.txt"))
    base, got, want = (json.load(open(certs[k])) for k in ("base", "t", "j"))
    assert got["base_output_digest"] == base["output_digest"]
    assert got["generation"] == 1 and "delta-evidence" in got["stages"]
    assert got["output_digest"] == want["output_digest"] != \
        base["output_digest"]
    assert got["stages"]["delta-evidence"] == want["stages"]["delta-evidence"]


def test_cli_validation_matches_jax(workload, tmp_path, capsys):
    p = workload["paths"]
    b = str(tmp_path / "b")
    for argv in ([p["base"], "--deletes", p["del"]],     # needs --delta
                 ["--support", "3"],                       # no inputs
                 [p["ins"], "--delta", b, "--only-read"],
                 [p["ins"], "--delta", b, "--checkpoint-dir", b]):
        for main in (tcli.main, jcli.main):
            with pytest.raises(SystemExit) as exc:
                main(argv)
            assert exc.value.code == 2
        err = capsys.readouterr().err.splitlines()
        assert err[-1].split(": error: ")[1] == \
            next(ln for ln in err if ": error: " in ln).split(": error: ")[1]


@pytest.mark.parametrize("seed", [0, 57, 433])
def test_host_bucket_of_equals_jax(seed):
    rng = np.random.default_rng(seed)
    cols = [rng.integers(0, 1 << 32, 4096, dtype=np.uint64).astype(np.uint32)
            for _ in range(2)]
    for n in (1, 7, 8192, (1 << 31) - 1):
        for k in (1, 2):
            got = hashing.host_bucket_of(cols[:k], n, seed=seed)
            want = jhashing.host_bucket_of(cols[:k], n, seed=seed)
            assert got.dtype == want.dtype and np.array_equal(got, want)


@pytest.mark.parametrize("frac,seed", [(0.01, 4), (0.0001, 4), (0.3, 9)])
def test_synth_delta_helpers_equal_jax(frac, seed):
    t = synth.generate_triples(2000, seed=5)
    got = synth.grow_delta_batches(t, frac, seed=seed)
    want = jsynth.grow_delta_batches(t, frac, seed=seed)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    assert np.array_equal(synth.apply_delta(t, *got),
                          jsynth.apply_delta(t, *want))
