"""The port's mmap'd CIND index and its serving process (``runtime/serving.py``,
``programs/serve.py``) against the JAX package's: every section array equal,
index files byte-equal apart from the meta's wall-clock stamps, an index
written by either package answered alike by both readers (misses included), the
corruption, torn-write and swap gates judging alike, zero dropped queries under
hot swaps, the driver's and the delta run's chained indexes, and the serving
process running under ``--max-s`` without initialising CUDA."""

import json
import os
import struct
import subprocess
import sys
import threading
import time

import numpy as np
import pytest

from rdfind_tpu import conditions as jcc
from rdfind_tpu.data import CindTable as JCindTable
from rdfind_tpu.runtime import serving as jserving
from rdfind_tpu_torch import discover
from rdfind_tpu_torch.data import NO_VALUE, CindTable
from rdfind_tpu_torch.dictionary import intern_triples
from rdfind_tpu_torch.programs import rdfind as tcli
from rdfind_tpu_torch.runtime import serving
from rdfind_tpu_torch.utils import synth
from torch_harness import port_module, time_limit  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CODES = jcc.ALL_VALID_CAPTURE_CODES[:3]
# Meta keys that hold wall-clock stamps: the only bytes two writes differ in.
STAMPS = ("created_unix", "bundle_commit_unix")


def _synthetic(n_deps=40, refs_per_dep=5, seed=7):
    """(values, rows): a CIND set over URI-shaped values sharing long
    prefixes (the dictionary lookup's bisect), unary and binary captures."""
    rng = np.random.default_rng(seed)
    dep_vals = [f"http://ex.org/dep/{i:05d}" for i in range(n_deps)]
    ref_vals = [f"http://ex.org/ref/{i:05d}"
                for i in range(n_deps * refs_per_dep)]
    values = sorted(dep_vals + ref_vals)
    vid = {v: i for i, v in enumerate(values)}
    rows = []
    for d in range(n_deps):
        sup = int(rng.integers(2, 500))
        v2 = NO_VALUE if d % 4 else vid[ref_vals[0]]
        dep = (CODES[d % len(CODES)], vid[dep_vals[d]], v2)
        for r in range(refs_per_dep):
            ref = (CODES[(d + r) % len(CODES)],
                   vid[ref_vals[d * refs_per_dep + r]], NO_VALUE)
            rows.append((*dep, *ref, sup))
    return values, rows


def _discovered():
    """(values, rows) of a real discovery: the tokens of 600 triples."""
    t = synth.generate_triples(600, seed=4, n_predicates=6, n_entities=50)
    tokens = np.array([[f"<v{int(v):09d}>" for v in row] for row in t],
                      dtype=object)
    ids, dictionary = intern_triples(tokens)
    table = discover(ids, 3, strategy=0, device="cpu")
    return list(dictionary.values), sorted(table.to_rows())


WORKLOADS = {"synthetic": _synthetic, "discovered": _discovered,
             "empty": lambda: (["a", "b"], [])}


@pytest.fixture(scope="module", params=sorted(WORKLOADS))
def workload(request):
    return WORKLOADS[request.param]()


def _tables(rows):
    return CindTable.from_rows(rows), JCindTable.from_rows(rows)


def _write_both(tmp_path, values, rows, **kw):
    kw.setdefault("generation", 0)
    kw.setdefault("output_digest", "d0")
    t, j = _tables(rows)
    pt = serving.write_index(str(tmp_path / "t"), values, t, **kw)
    pj = jserving.write_index(str(tmp_path / "j"), values, j, **kw)
    return pt, pj


def _split(path):
    """(meta without its stamps, the bytes after the meta)."""
    with open(path, "rb") as f:
        blob = f.read()
    assert blob[:4] == b"CNDX"
    meta_len = struct.unpack("<Q", blob[8:16])[0]
    meta = json.loads(blob[16:16 + meta_len])
    return ({k: v for k, v in meta.items() if k not in STAMPS},
            [blob[s["offset"]:s["offset"] + s["nbytes"]]
             for s in meta["sections"]])


def test_build_arrays_equal_jax(workload):
    values, rows = workload
    t, j = _tables(rows)
    got, want = serving.build_arrays(values, t), jserving.build_arrays(values,
                                                                       j)
    assert list(got) == list(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        assert np.array_equal(got[k], want[k]), k


def test_index_file_equals_jax_but_for_its_stamps(workload, tmp_path):
    values, rows = workload
    pt, pj = _write_both(tmp_path, values, rows, generation=3,
                         output_digest="abc", base_output_digest="def",
                         extra={"strategy": 1, "min_support": 3,
                                "batch": {"inserts": 2, "deletes": 1}})
    mt, st = _split(pt)
    mj, sj = _split(pj)
    assert mt == mj
    assert st == sj


def _captures(reader, n):
    """Up to n (code, v1, v2) string captures the index knows."""
    out = []
    for cid in range(min(n, reader.n_captures)):
        out.append(reader.capture(cid))
    return out


def _answers(reader, caps):
    """Every query kind over `caps` plus unknown values and captures."""
    misses = [(CODES[0], "no-such-value", None), (63, None, None),
              (CODES[1], "http://ex.org/dep/99999", None)]
    probe = caps + misses
    out = {"topk": reader.topk(10_000),
           "topk_ids": reader.topk(7, decode=False),
           "values": [reader.value_id(v) for v in
                      ("a", "b", "zzz", "http://ex.org/ref/00003", "")],
           "cinds": list(reader.iter_cinds())}
    for d in probe:
        out[("support", d)] = reader.support(d)
        out[("referenced", d)] = reader.referenced(d)
        out[("referenced3", d)] = reader.referenced(d, limit=3)
        for r in probe[:12]:
            out[("holds", d, r)] = reader.holds(d, r)
    out[("holds_ids", -1, 0)] = reader.holds(-1, 0)
    for d, f, _ in list(reader.iter_cinds())[::7]:
        out[("holds", d, f)] = reader.holds(reader.capture(d),
                                            reader.capture(f))
    return out


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_readers_answer_alike_across_writers(workload, tmp_path, writer):
    """An index written by one package, opened by both readers: equal answers
    on holds, referenced, topk, support and value_id, misses included."""
    values, rows = workload
    pt, pj = _write_both(tmp_path, values, rows)
    path = pj if writer == "jax" else pt
    rt, rj = serving.IndexReader(path), jserving.IndexReader(path)
    try:
        assert rt.verify() == rj.verify() == {"ok": True, "mismatches": []}
        caps = _captures(rj, 25)
        got, want = _answers(rt, caps), _answers(rj, caps)
        assert got == want
        if rows:
            assert any(v is True for k, v in want.items()
                       if k[0] == "holds")
    finally:
        rt.close()
        rj.close()


def test_flipped_byte_is_named_like_jax(tmp_path):
    values, rows = _synthetic()
    pt, _ = _write_both(tmp_path, values, rows)
    with open(pt, "rb") as f:
        clean = f.read()
    r = serving.IndexReader(pt)
    sections = [dict(s) for s in r.meta["sections"]]
    r.close()
    assert [s["name"] for s in sections] == list(serving._SECTIONS)
    for sec in sections:
        blob = bytearray(clean)
        blob[sec["offset"] + sec["nbytes"] // 2] ^= 0x40
        with open(pt, "wb") as f:
            f.write(blob)
        rt, rj = serving.IndexReader(pt), jserving.IndexReader(pt)
        v = rt.verify()
        assert v == rj.verify() == {"ok": False, "mismatches": [sec["name"]]}
        rt.close()
        rj.close()


def test_truncated_and_torn_files_are_misses_in_both(tmp_path):
    values, rows = _synthetic()
    pt, _ = _write_both(tmp_path, values, rows)
    with open(pt, "rb") as f:
        clean = f.read()
    bad = [clean[:cut] for cut in (0, 3, 15, 200, len(clean) - 1)]
    bad.append(b"\0\0\0\0" + clean[4:])                          # torn
    bad.append(clean[:4] + (99).to_bytes(4, "little") + clean[8:])  # format
    for blob in bad:
        with open(pt, "wb") as f:
            f.write(blob)
        with pytest.raises(serving.IndexMiss):
            serving.IndexReader(pt)
        with pytest.raises(jserving.IndexMiss):
            jserving.IndexReader(pt)
        assert serving.peek_generation(pt) is None
    os.unlink(pt)
    with pytest.raises(serving.IndexMiss):
        serving.IndexReader(pt)


def _touch(path, ns):
    os.utime(path, ns=(ns, ns))


def _script():
    """Index generations the swap gates are driven through: (generation,
    output digest, base digest, corrupt?) and the verdict each must get."""
    return [((0, "g0", None, False), "swapped"),
            ((1, "g1", "WRONG", False), "refused:chain-broken"),
            ((1, "g1", "g0", True), "refused:section-digest-mismatch"),
            ((1, "g1", "g0", False), "swapped"),
            ((0, "g0", None, False), "refused:generation-regressed"),
            ((2, "g2", "g1", False), "swapped")]


@pytest.mark.parametrize("pkg", ["port", "jax"])
def test_swap_gates_judge_alike(tmp_path, pkg):
    """The same sequence of generations through each package's service:
    chain breaks, corrupt candidates and regressions refused by name, the
    old generation serving meanwhile."""
    mod = serving if pkg == "port" else jserving
    values, rows = _synthetic(n_deps=6)
    table = _tables(rows)[0 if pkg == "port" else 1]
    svc = mod.IndexService(str(tmp_path))
    serving_gen = None
    for i, ((gen, out, base, corrupt), want) in enumerate(_script()):
        path = mod.write_index(str(tmp_path), values, table, generation=gen,
                               output_digest=out, base_output_digest=base)
        if corrupt:
            blob = bytearray(open(path, "rb").read())
            blob[-1] ^= 1
            with open(path, "wb") as f:
                f.write(blob)
        _touch(path, 10_000 * (i + 1))
        v = svc.poll({})
        assert (v["action"] if v["action"] == "swapped"
                else f"{v['action']}:{v['reason']}") == want, (i, v)
        if v["action"] == "swapped":
            serving_gen = gen
        assert svc.generation == serving_gen
        with svc.acquire() as reader:
            assert reader.holds(reader.capture(0), reader.capture(1)) in \
                (True, False)
    st = svc.status()
    assert [c["generation"] for c in st["chain"]] == [0, 1, 2]
    assert st["swaps"] == 3 and st["refusals"] == 3
    svc.close()


def test_no_query_dropped_under_hot_swaps(tmp_path):
    """Query threads hammer the service while the index advances ten
    generations: every query is answered by some generation, none raises."""
    values, rows = _synthetic(n_deps=12)
    table = CindTable.from_rows(rows)
    d = str(tmp_path)
    serving.write_index(d, values, table, generation=0, output_digest="g0")
    svc = serving.IndexService(d)
    assert svc.poll()["action"] == "swapped"
    with svc.acquire() as r:
        dep, ref = r.capture(0), r.capture(1)
    stop, errors, answered = threading.Event(), [], [0] * 4

    def query(i):
        while not stop.is_set():
            try:
                out = svc.query_holds(dep, ref)
                assert "generation" in out
                answered[i] += 1
            except Exception as e:  # noqa: BLE001 - collected for the assert
                errors.append(repr(e))

    threads = [threading.Thread(target=query, args=(i,)) for i in range(4)]
    for t in threads:
        t.start()
    try:
        deadline = time.monotonic() + 30
        while min(answered) == 0 and time.monotonic() < deadline:
            time.sleep(0.01)
        for gen in range(1, 11):
            path = serving.write_index(d, values, table, generation=gen,
                                       output_digest=f"g{gen}",
                                       base_output_digest=f"g{gen - 1}")
            _touch(path, 10_000 * gen)
            assert svc.poll()["action"] == "swapped"
    finally:
        stop.set()
        for t in threads:
            t.join(timeout=10)
    assert not any(t.is_alive() for t in threads)
    assert errors == [] and min(answered) > 0
    assert svc.generation == 10
    svc.close()


def test_driver_and_delta_emit_a_chained_index(tmp_path, monkeypatch):
    """--delta-state writes generation 0 next to the bundle; a --delta run
    writes generation 1 chained to it; RDFIND_SERVE_INDEX receives each
    run's index too; the served answers are the run's output."""
    for k in ("RDFIND_DELTA_FULL_FRAC", "RDFIND_INTEGRITY", "RDFIND_CERT"):
        monkeypatch.delenv(k, raising=False)
    t = synth.generate_triples(400, seed=3, n_predicates=6, n_entities=80)
    ins, dels = synth.grow_delta_batches(t, 0.01, seed=4)
    files = {}
    for name, rows in (("base", t), ("ins", ins), ("del", dels)):
        files[name] = str(tmp_path / f"{name}.nt")
        with open(files[name], "w") as f:
            f.writelines(f"<v{s}> <v{p}> <v{o}> .\n" for s, p, o in rows)
    bundle, extra = str(tmp_path / "bundle"), str(tmp_path / "extra")
    monkeypatch.setenv("RDFIND_SERVE_INDEX", extra)
    common = ["--support", "3", "--traversal-strategy", "0", "--device",
              "cpu"]
    assert tcli.main([files["base"], *common, "--delta-state", bundle]) == 0
    g0 = serving.peek_meta(serving.index_path(bundle))
    assert g0["generation"] == 0 and g0["base_output_digest"] is None
    assert serving.peek_meta(serving.index_path(extra))["generation"] == 0
    out = str(tmp_path / "d.txt")
    assert tcli.main([files["ins"], "--delta", bundle, "--deletes",
                      files["del"], *common, "--output", out]) == 0
    r = serving.IndexReader(serving.index_path(bundle))
    try:
        assert r.generation == 1
        assert r.base_output_digest == g0["output_digest"]
        assert r.batch == {"inserts": len(ins), "deletes": len(dels),
                           "base_generation": 0}
        served = sorted(
            f"{r.pretty_capture(d)} < {r.pretty_capture(f)} (support={s})"
            for d, f, s in r.iter_cinds())
        assert served == open(out).read().splitlines()
        assert r.verify()["ok"]
    finally:
        r.close()


_SERVE = """
import sys
sys.path.insert(0, {repo!r})
from rdfind_tpu_torch.programs import serve
rc = serve.main([{index!r}, "--console-port", "0", "--poll-s", "0.05",
                 "--max-s", "1", "--obs", {obs!r}])
import torch
print("rc", rc, "cuda_initialized", torch.cuda.is_initialized())
"""


def test_serve_process_runs_without_initialising_cuda(tmp_path):
    values, rows = _synthetic(n_deps=6)
    serving.write_index(str(tmp_path / "idx"), values,
                        CindTable.from_rows(rows), generation=0,
                        output_digest="g0")
    code = _SERVE.format(repo=REPO, index=str(tmp_path / "idx"),
                         obs=str(tmp_path / "obs"))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=100, cwd=REPO, env=env)
    assert r.returncode == 0, r.stderr
    assert r.stdout.split() == ["rc", "0", "cuda_initialized", "False"]
    assert "generation 0 loaded" in r.stderr
    assert "console on http://127.0.0.1:" in r.stderr
    beat = json.load(open(tmp_path / "obs" / "heartbeat-host0.json"))
    assert beat["mode"] == "serve" and beat["generation"] == 0
    assert os.path.exists(tmp_path / "obs" / "slowlog-host0.json")
