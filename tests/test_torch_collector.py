"""The port's remote result channel against the JAX package's, on the CPU:
``--collector`` streams the same CIND lines and end count as the JAX CLI, and a
dead collector costs the run nothing but a ``collector-errors`` counter."""

import contextlib
import io
import socket
import threading

import pytest

from rdfind_tpu.programs import rdfind as jcli
from rdfind_tpu.runtime import collector as jcollector
from rdfind_tpu_torch.programs import rdfind as tcli
from rdfind_tpu_torch.runtime import collector as tcollector
from rdfind_tpu_torch.utils import synth
from torch_harness import port_module, time_limit  # noqa: F401


@pytest.fixture(scope="module")
def nt_file(tmp_path_factory):
    path = tmp_path_factory.mktemp("nt") / "data.nt"
    t = synth.generate_triples(400, seed=2, n_predicates=6, n_entities=45)
    path.write_text("".join(f"<e{s}> <e{p}> <e{o}> .\n" for s, p, o in t))
    return str(path)


def collect(server_mod, main, argv):
    """Records one CLI run streams to a collector of `server_mod`, and the
    run's stderr."""
    records, done = [], threading.Event()

    def consume(rec):
        records.append(rec)
        if rec.get("kind") == "end":
            done.set()

    with server_mod.CollectorServer(consume) as server:
        host, port = server.addr
        err = io.StringIO()
        with contextlib.redirect_stderr(err):
            assert main([*argv, "--collector", f"{host}:{port}",
                         "--counters", "1"]) == 0
        assert done.wait(10)
    return records, err.getvalue()


@pytest.mark.parametrize("flags", [["--traversal-strategy", "0"], []])
def test_stream_matches_the_jax_cli(nt_file, flags):
    argv = [nt_file, "--support", "3", *flags]
    want, _ = collect(jcollector, jcli.main, argv)
    got, err = collect(tcollector, tcli.main, [*argv, "--device", "cpu"])
    assert got[-1] == want[-1] == {"kind": "end", "count": len(want) - 1}
    assert len(want) > 10
    assert {r["kind"] for r in got[:-1]} == {"cind"}
    assert sorted(r["text"] for r in got[:-1]) == \
        sorted(r["text"] for r in want[:-1])
    assert "phase collect-remote" in err
    assert "collector-errors" not in err


def test_port_stream_reaches_the_jax_server(nt_file):
    """The wire format is the JAX package's: its server reads the port's
    stream."""
    got, _ = collect(jcollector, tcli.main, [nt_file, "--support", "3",
                                             "--device", "cpu"])
    assert got[-1]["count"] == len(got) - 1 > 10


def _dead_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


@pytest.mark.parametrize("addr", ["dead", "127.0.0.1:notaport"])
def test_a_dead_collector_does_not_fail_the_run(nt_file, tmp_path, addr):
    if addr == "dead":
        addr = f"127.0.0.1:{_dead_port()}"
    out = tmp_path / "out.txt"
    err = io.StringIO()
    with contextlib.redirect_stderr(err):
        rc = tcli.main([nt_file, "--support", "3", "--device", "cpu",
                        "--collector", addr, "--output", str(out),
                        "--counters", "1"])
    assert rc == 0
    assert "collector-errors: 1" in err.getvalue()
    assert "results NOT streamed" in err.getvalue()
    assert out.read_text().count("\n") > 10


def test_garbled_lines_reach_the_consumer_flagged():
    records, done = [], threading.Event()

    def consume(rec):
        records.append(rec)
        done.set()

    with tcollector.CollectorServer(consume) as server:
        with socket.create_connection(server.addr) as s:
            s.sendall(b"{not json\n")
        assert done.wait(10)
    assert records == [{"kind": "garbled", "raw": "{not json"}]
