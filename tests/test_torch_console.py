"""The port's run console (``obs/console.py``) against the JAX package's: the
same query payloads and HTTP codes on one index, the same admin payloads, every
route over real loopback HTTP, the console as a consumer of the integrity and
data planes, and the CLI's ``--console-port`` serving ``/progress`` and
``/metrics`` for the run's duration."""

import json
import os
import re
import socket
import urllib.error
import urllib.parse
import urllib.request

import numpy as np
import pytest

from rdfind_tpu import conditions as jcc
from rdfind_tpu.obs import console as jconsole
from rdfind_tpu.obs import metrics as jmetrics
from rdfind_tpu.obs import servestats as jstats
from rdfind_tpu.runtime import serving as jserving
from rdfind_tpu_torch.data import NO_VALUE, CindTable
from rdfind_tpu_torch.obs import (console, datastats, heartbeat, integrity,
                                  metrics, servestats, tracer)
from rdfind_tpu_torch.programs import rdfind as tcli
from rdfind_tpu_torch.runtime import serving
from rdfind_tpu_torch.utils import synth
from torch_harness import port_module, time_limit  # noqa: F401

SAMPLE_RE = re.compile(r"^[a-zA-Z_:][a-zA-Z0-9_:]*(\{[^}]*\})? [^ ]+$")
CODES = jcc.ALL_VALID_CAPTURE_CODES[:3]


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    for k in ("RDFIND_CONSOLE_PORT", "RDFIND_DATASTATS", "RDFIND_INTEGRITY",
              "RDFIND_SERVE_OBS"):
        monkeypatch.delenv(k, raising=False)
    for mod in (console, jconsole):
        mod.stop()
    tracer.stop()
    for mod in (metrics, jmetrics):
        mod.reset()
    for mod in (servestats, jstats):
        mod.reset()
        mod.configure()
    yield
    for mod in (console, jconsole):
        mod.stop()
    tracer.stop()
    for mod in (metrics, jmetrics):
        mod.reset()
    monkeypatch.undo()
    for mod in (servestats, jstats):
        mod.configure()


@pytest.fixture()
def live_console():
    port = console.start(0)
    if port is None:
        pytest.skip("this host forbids listening on loopback")
    yield f"http://127.0.0.1:{port}"


def _get(url, timeout=10):
    with urllib.request.urlopen(url, timeout=timeout) as r:
        return r.status, r.headers.get("Content-Type", ""), \
            r.read().decode("utf-8")


def _index(directory, n_deps=8, refs=4, seed=3):
    """An index of n_deps dependents with `refs` referenced captures each;
    returns (values, [(dep, ref, support)] as string captures)."""
    rng = np.random.default_rng(seed)
    values = sorted([f"http://ex.org/d/{i:03d}" for i in range(n_deps)]
                    + [f"http://ex.org/r/{i:03d}" for i in range(n_deps * refs)]
                    + ["lit with space & amp"])
    vid = {v: i for i, v in enumerate(values)}
    rows, truth = [], []
    for d in range(n_deps):
        sup = int(rng.integers(2, 90))
        dv = f"http://ex.org/d/{d:03d}"
        dep = (CODES[d % 3], vid[dv],
               vid["lit with space & amp"] if d == 0 else NO_VALUE)
        for r in range(refs):
            rv = f"http://ex.org/r/{d * refs + r:03d}"
            ref = (CODES[(d + r) % 3], vid[rv], NO_VALUE)
            rows.append((*dep, *ref, sup))
            truth.append(((dep[0], dv, "lit with space & amp" if d == 0
                           else None), (ref[0], rv, None), sup))
    serving.write_index(directory, values, CindTable.from_rows(rows),
                        generation=0, output_digest="g0")
    return values, truth


def _cap_query(role, cap):
    code, v1, v2 = cap
    q = {f"{role}_code": code}
    if v1 is not None:
        q[f"{role}_v1"] = v1
    if v2 is not None:
        q[f"{role}_v2"] = v2
    return urllib.parse.urlencode(q)


def _queries(truth):
    """(route, query string) pairs: hits, misses, ids and malformed ones."""
    out = []
    for dep, ref, _ in truth[::3]:
        out.append(("holds", f"{_cap_query('dep', dep)}&"
                             f"{_cap_query('ref', ref)}"))
        out.append(("holds", f"{_cap_query('dep', ref)}&"
                             f"{_cap_query('ref', dep)}"))
        out.append(("referenced", _cap_query("dep", dep)))
        out.append(("referenced", f"{_cap_query('dep', dep)}&limit=2"))
    out += [("holds", "dep=0&ref=1"), ("holds", "dep=-1&ref=1"),
            ("holds", f"dep_code={CODES[0]}&dep_v1=nope&ref=0"),
            ("referenced", "dep=3"), ("referenced", "dep=999"),
            ("topk", "k=5"), ("topk", ""), ("topk", "k=0"),
            ("holds", "dep=1"), ("holds", "dep=x&ref=y"),
            ("referenced", "limit=2"), ("topk", "k=x")]
    return out


def _route(mod, name):
    return getattr(mod, f"query_{name}_payload")


def test_query_payloads_equal_jax(tmp_path, monkeypatch):
    # No slow-query ring: which answers pass 10 ms depends on the load.
    monkeypatch.setenv("RDFIND_SERVE_OBS_SLOW_US", "1e12")
    for mod in (servestats, jstats):
        mod.configure()
    _, truth = _index(str(tmp_path))
    svc_t, svc_j = serving.IndexService(str(tmp_path)), \
        jserving.IndexService(str(tmp_path))
    svc_t.poll()
    svc_j.poll()
    console.set_query_service(svc_t)
    jconsole.set_query_service(svc_j)
    try:
        codes = set()
        for route, q in _queries(truth):
            got = _route(console, route)(q)
            want = _route(jconsole, route)(q)
            assert got == want, (route, q)
            codes.add(got[1])
        assert codes == {200, 400}
        assert console.slowlog_payload() == jconsole.slowlog_payload()
        # Counts agree; latencies are this process's timings.
        assert servestats.aggregate()["requests"] == \
            jstats.aggregate()["requests"]
        st_t, st_j = console.status_payload(), jconsole.status_payload()
        for st in (st_t, st_j):
            si = st["serving_index"]
            si.pop("freshness")
            for link in si["chain"]:
                link.pop("loaded_unix")
            st["slo"].pop("evaluated_unix")
        assert st_t == st_j
        slo_t, slo_j = console.slo_payload(), jconsole.slo_payload()
        for slo in (slo_t, slo_j):
            slo["verdict"].pop("evaluated_unix")
            slo.pop("freshness")
            slo["requests"].pop("latency_us")
        assert slo_t == slo_j
        assert console.query_holds_payload(
            f"{_cap_query('dep', truth[0][0])}&"
            f"{_cap_query('ref', truth[0][1])}")[0]["holds"] is True
    finally:
        console.set_query_service(None)
        jconsole.set_query_service(None)
        svc_t.close()
        svc_j.close()
    assert console.query_holds_payload("dep=1&ref=2")[1] == 503


def test_no_index_and_disarmed_routes_count_like_jax(tmp_path):
    """503 without a query service or without an index, 400 on a malformed
    query: each counted in the registry and in the request counters."""
    got = {}
    for name, cmod, smod, mmod, svc_mod in (
            ("t", console, servestats, metrics, serving),
            ("j", jconsole, jstats, jmetrics, jserving)):
        cmod.set_query_service(None)
        codes = [cmod.query_holds_payload("dep=0&ref=0")[1]]
        svc = svc_mod.IndexService(str(tmp_path))  # no index on disk
        cmod.set_query_service(svc)
        codes += [cmod.query_holds_payload("dep=bogus&ref=0")[1],
                  cmod.query_holds_payload("dep=0&ref=0")[1],
                  cmod.query_topk_payload("k=2")[1]]
        cmod.set_query_service(None)
        svc.close()
        snap = mmod.registry().snapshot()
        got[name] = (codes, {k: snap.get(k) for k in (
            "serve_http_503", "serve_http_400", "serve_refused")},
            smod.aggregate()["requests"])
    assert got["t"] == got["j"]
    assert got["t"][0] == [503, 400, 503, 503]


def test_every_route_over_http(live_console, tmp_path):
    _, truth = _index(str(tmp_path))
    svc = serving.IndexService(str(tmp_path))
    svc.poll()
    console.set_query_service(svc)
    try:
        index = json.loads(_get(live_console + "/")[2])
        assert index["endpoints"] == [
            "/metrics", "/status", "/progress", "/datastats", "/integrity",
            "/flightrec", "/slo", "/debug/slowlog", "/query/holds",
            "/query/referenced", "/query/topk"]
        dep, ref, sup = truth[0]
        q = f"{_cap_query('dep', dep)}&{_cap_query('ref', ref)}"
        assert json.loads(_get(f"{live_console}/query/holds?{q}")[2]) == \
            {"holds": True, "generation": 0}
        body = json.loads(_get(f"{live_console}/query/referenced?"
                               f"{_cap_query('dep', dep)}")[2])
        assert body["support"] == sup and body["n"] == 4
        assert json.loads(_get(f"{live_console}/query/topk?k=3")[2])["k"] == 3
        for path in ("/status", "/progress", "/datastats", "/integrity",
                     "/flightrec", "/slo", "/debug/slowlog"):
            code, ctype, body = _get(live_console + path)
            assert code == 200 and ctype == "application/json", path
            json.loads(body)
        code, ctype, body = _get(live_console + "/metrics")
        assert code == 200 and ctype.startswith("text/plain")
        lines = [ln for ln in body.splitlines() if ln and ln[0] != "#"]
        assert lines and all(SAMPLE_RE.match(ln) for ln in lines)
        assert 'rdfind_serve_requests_total{endpoint="holds",outcome="ok"} 1' \
            in lines
        with pytest.raises(urllib.error.HTTPError) as exc:
            _get(f"{live_console}/query/holds?dep=1")
        assert exc.value.code == 400
        with pytest.raises(urllib.error.HTTPError) as exc:
            _get(live_console + "/nope")
        assert exc.value.code == 404
    finally:
        console.set_query_service(None)
        svc.close()


def test_lifecycle_env_port_and_bind_failure(live_console, monkeypatch):
    port = int(live_console.rsplit(":", 1)[1])
    assert console.serving() and console.port() == port
    assert console.start(0) == port
    console.stop()
    assert not console.serving() and console.port() is None
    console.stop()
    with socket.socket() as s:
        s.bind((console.DEFAULT_HOST, 0))
        s.listen(1)
        assert console.start(s.getsockname()[1]) is None
    assert not console.serving()
    for v, want in (("8080", 8080), ("  0 ", 0), ("junk", None), ("", None)):
        monkeypatch.setenv("RDFIND_CONSOLE_PORT", v)
        assert console.env_port() == jconsole.env_port() == want


def test_console_is_an_integrity_and_datastats_consumer(live_console):
    """A live console alone (no knob, no tracer, no exposition) arms the
    integrity and data planes, as in the JAX package."""
    assert integrity.enabled() and datastats.enabled()
    console.stop()
    assert not integrity.enabled() and not datastats.enabled()


def test_admin_payloads_equal_jax(live_console, tmp_path):
    """/progress, /datastats, /integrity and /status over the same registry
    entries give the JAX console's payloads."""
    for mmod, dmod, imod in ((metrics, datastats, integrity),
                             (jmetrics, __import__(
                                 "rdfind_tpu.obs.datastats",
                                 fromlist=["x"]),
                              __import__("rdfind_tpu.obs.integrity",
                                         fromlist=["x"]))):
        dmod.publish_cap_utilization(None, {"pairs": 100}, {"pairs": 80})
        dmod.publish_line_stats(None, hist={2: 4}, n_lines=4, max_line=7,
                                source="single")
        mmod.gauge_set(None, "run_stage", "discover")
        mmod.gauge_set(None, "run_pass", 1)
        imod.publish_stage(None, "lines", 0x1234, 0x5678)
    for name in ("progress_payload", "datastats_payload",
                 "integrity_payload"):
        assert getattr(console, name)() == getattr(jconsole, name)(), name
    heartbeat.write(str(tmp_path), {"stage": "discover", "pass": 2})
    console.set_obs_dir(str(tmp_path))
    status = json.loads(_get(live_console + "/status")[2])
    assert status["serving"] is True and status["pid"] == os.getpid()
    assert status["heartbeat"]["hosts"]["0"]["stage"] == "discover"


def test_cli_console_port_serves_the_run(tmp_path, capsys, monkeypatch):
    """--console-port 0 during a CLI run: the console binds, /progress (at
    the discover stage) and /metrics answer while the run is alive, and it
    stops with the run."""
    from rdfind_tpu_torch.runtime import driver

    path = str(tmp_path / "d.nt")
    t = synth.generate_triples(400, seed=4, n_predicates=6, n_entities=50)
    with open(path, "w") as f:
        f.writelines(f"<v{s}> <v{p}> <v{o}> .\n" for s, p, o in t)
    scraped, discover = {}, driver._discover

    def scrape_then_discover(*args, **kw):
        base = f"http://127.0.0.1:{console.port()}"
        for route in ("/progress", "/metrics"):
            code, _, body = _get(base + route)
            scraped[route] = (code, body)
        return discover(*args, **kw)

    monkeypatch.setattr(driver, "_discover", scrape_then_discover)
    assert tcli.main([path, "--support", "3", "--device", "cpu",
                      "--traversal-strategy", "0", "--console-port", "0",
                      "--output", str(tmp_path / "o.txt")]) == 0
    assert "rdfind: run console on http://127.0.0.1:" in \
        capsys.readouterr().err
    assert not console.serving()
    assert {k: v[0] for k, v in scraped.items()} == {"/progress": 200,
                                                     "/metrics": 200}
    assert json.loads(scraped["/progress"][1])["run_stage"] == "discover"
    assert 'rdfind_ingest{key="triples"} 400' in \
        scraped["/metrics"][1].splitlines()
