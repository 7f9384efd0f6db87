"""The port's sharded multi-host ingest (``--sharded-ingest``) on the CPU.

Two hosts of one gloo rank each (two launches joined through a TCP store on
localhost, as ``--coordinator``/``--num-hosts``/``--host-index`` join them)
parse disjoint file shards, one of them empty, with non-ASCII literals: under
partitioned and replicated interning the decoded CINDs of strategies 1 and 3
(frequent-condition filter and association rules on) must equal the JAX
package's single-device run over all files, every value must come back byte
for byte, and the partitioned ranges must partition the dictionary.  The CLI
with ``--sharded-ingest`` on two hosts, and on one process with the driver's
other stages (distinct, histogram, frequent conditions), must write and report
what the JAX single-device CLI does.  Tolerance: exact equality throughout.
"""

import os
import socket
import subprocess
import sys
import threading

import pytest

import torch_rank_cases
from rdfind_tpu.models import late_bb as jlate_bb
from rdfind_tpu.models import small_to_large as jsmall_to_large
from rdfind_tpu.programs import rdfind as jcli
from rdfind_tpu.runtime import multihost_ingest as jmultihost
from rdfind_tpu_torch.parallel import launch
from rdfind_tpu_torch.programs import rdfind as tcli
from rdfind_tpu_torch.utils import synth
from torch_harness import port_module, time_limit  # noqa: F401

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SUPPORT = 2
WORDS = ["Zürich", "café", "naïve", "東京", "plain"]


def _term(i, obj):
    if obj and i % 3 == 0:
        return f'"{WORDS[i % len(WORDS)]} {i % 7}"'
    return f"<http://example.org/e{i}>"


@pytest.fixture(scope="module")
def shards(tmp_path_factory):
    """Three N-Triples shards of one synthetic graph and an empty fourth."""
    d = tmp_path_factory.mktemp("shards")
    t = synth.generate_triples(400, seed=21, n_predicates=6, n_entities=40)
    rows = [f"{_term(s, False)} {_term(p, False)} {_term(o, True)} .\n"
            for s, p, o in t]
    paths = []
    for i in range(4):
        p = d / f"shard{i}.nt"
        p.write_text("".join(rows[i::3]) if i < 3 else "", encoding="utf-8")
        paths.append(str(p))
    return paths


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _two_hosts(paths):
    coordinator = f"127.0.0.1:{_free_port()}"
    out = [None, None]

    def host(h):
        out[h] = launch.spawn(torch_rank_cases.multihost_ingest_cases, 1,
                              args=(paths, SUPPORT, (1, 3)), device="cpu",
                              coordinator=coordinator, num_hosts=2,
                              host_index=h, timeout_s=100)

    threads = [threading.Thread(target=host, args=(h,)) for h in (0, 1)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert all(o is not None for o in out), "a host's launch failed"
    return out


@pytest.fixture(scope="module")
def hosts(shards, tmp_path_factory):
    return torch_rank_cases.shared_result(
        tmp_path_factory, "torch_multihost_ingest",
        lambda: _two_hosts(shards))


@pytest.fixture(scope="module")
def golden(shards):
    """The JAX package's single-device ingest of every file, and its CINDs."""
    ids, d = jmultihost._local_ingest(shards, False, False, "utf-8")
    cinds = {}
    for s, fn in ((1, jsmall_to_large.discover), (3, jlate_bb.discover)):
        table = fn(ids, SUPPORT, use_frequent_condition_filter=True,
                   use_association_rules=True)
        cinds[s] = sorted(c.pretty() for c in table.decoded(d))
    return ids, d, cinds


@pytest.mark.parametrize("mode", ["partitioned", "replicated"])
@pytest.mark.parametrize("strategy", [1, 3])
def test_two_host_ingest_cinds_equal_jax(hosts, golden, mode, strategy):
    _, _, cinds = golden
    assert cinds[strategy]
    for h in (0, 1):
        assert hosts[h][mode]["cinds"][strategy] == cinds[strategy]


@pytest.mark.parametrize("mode", ["partitioned", "replicated"])
def test_two_host_ingest_values_round_trip(hosts, golden, mode):
    ids, d, _ = golden
    for h in (0, 1):
        rec = hosts[h][mode]
        assert rec["total"] == ids.shape[0]
        assert rec["size"] == len(d)
        assert sorted(rec["values"]) == sorted(str(v) for v in d.values)
    assert any("東京" in v for v in hosts[0][mode]["values"])


def test_partitioned_ranges_partition_the_dictionary(hosts, golden):
    _, d, _ = golden
    recs = [hosts[h]["partitioned"] for h in (0, 1)]
    assert all(r["partitioned"] for r in recs)
    assert sum(r["own"] for r in recs) == len(d)
    assert all(0 < r["own"] < len(d) for r in recs)
    assert recs[0]["offsets"] == recs[1]["offsets"]
    assert [hosts[h]["replicated"]["own"] for h in (0, 1)] == [len(d)] * 2


def _cli_two_hosts(paths, tmp_path, flags):
    coordinator = f"127.0.0.1:{_free_port()}"
    env = {k: v for k, v in os.environ.items()
           if k not in ("RDFIND_FAULTS", "RDFIND_TORCH_DIST_BACKEND")}
    procs = [subprocess.Popen(
        [sys.executable, "-m", "rdfind_tpu_torch.programs.rdfind", *paths,
         "--support", str(SUPPORT), "--sharded-ingest", "--device", "cpu",
         "--coordinator", coordinator, "--num-hosts", "2", "--host-index",
         str(h), "--output", str(tmp_path / f"out{h}.txt"), "--counters",
         "1", *flags], cwd=_REPO, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True) for h in (0, 1)]
    try:
        outs = [p.communicate(timeout=100) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    assert [p.returncode for p in procs] == [0, 0], outs[0][1][-3000:]
    return outs


@pytest.mark.parametrize("flags", [
    ["--interning", "partitioned", "--traversal-strategy", "3", "--use-fis",
     "--use-ars"],
    ["--interning", "replicated", "--traversal-strategy", "2"],
])
def test_two_host_cli_writes_the_jax_file(shards, tmp_path, flags):
    outs = _cli_two_hosts(shards, tmp_path, flags)
    want = tmp_path / "jax.txt"
    jflags = [f for f in flags if f not in ("--interning", "partitioned",
                                            "replicated")]
    assert jcli.main([*shards, "--support", str(SUPPORT), *jflags,
                      "--output", str(want)]) == 0
    assert want.read_bytes().count(b"\n") > 0
    assert (tmp_path / "out0.txt").read_bytes() == want.read_bytes()
    err = outs[0][1]
    assert "stat-world_size: 2" in err and "stat-dist_backend: gloo" in err
    assert "phase sharded-ingest" in err
    if "partitioned" in flags:
        assert "phase resolve-dictionary" in err


def _counters(err):
    return dict(line.split(": ", 1) for line in err.splitlines()
                if ": " in line and not line.startswith("phase "))


@pytest.mark.parametrize("flags,keys", [
    (["--distinct-triples"], ["input-triples", "distinct-triples",
                              "distinct-values", "cind-counter"]),
    (["--find-only-fcs", "2", "--use-fis", "--use-ars"],
     ["frequent-single-conditions", "frequent-double-conditions",
      "association-rules", "input-triples"]),
    (["--create-join-histogram", "--do-only-join", "--projection", "po"],
     ["input-triples", "distinct-values"]),
    (["--asciify-triples", "--traversal-strategy", "0", "--use-fis"],
     ["cind-counter", "distinct-values"]),
])
def test_one_process_sharded_ingest_stages_match_jax(shards, dup_file,
                                                      capsys, tmp_path, flags,
                                                      keys):
    inputs = [*shards, dup_file]
    common = [*inputs, "--support", str(SUPPORT), "--counters", "1", *flags]
    assert jcli.main(common + ["--output", str(tmp_path / "j.txt")]) == 0
    j = capsys.readouterr()
    assert tcli.main(common + ["--output", str(tmp_path / "t.txt"),
                               "--sharded-ingest", "--device", "cpu"]) == 0
    t = capsys.readouterr()
    assert t.out == j.out
    jc, tc = _counters(j.err), _counters(t.err)
    assert {k: tc.get(k) for k in keys} == {k: jc.get(k) for k in keys}
    assert all(jc.get(k) is not None for k in keys)
    if (tmp_path / "j.txt").exists():
        assert (tmp_path / "t.txt").read_bytes() == \
            (tmp_path / "j.txt").read_bytes()


@pytest.fixture(scope="module")
def dup_file(shards, tmp_path_factory):
    """Repeated lines of the first shard: --distinct-triples has work."""
    path = tmp_path_factory.mktemp("dup") / "dup.nt"
    path.write_bytes(open(shards[0], "rb").read())
    return str(path)
