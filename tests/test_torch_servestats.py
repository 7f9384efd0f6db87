"""The port's serving telemetry (``obs/servestats.py``) against the JAX package's:
the same recorded traffic gives the same aggregate, Prometheus text, slow-query
ring and SLO verdicts; and, unlike the JAX package's copy, a scrape racing
writers never sees more latency samples than requests, even under a 1 µs
thread switch interval."""

import json
import sys
import threading

import pytest

from rdfind_tpu.obs import servestats as jstats
from rdfind_tpu_torch.obs import servestats
from torch_harness import port_module, time_limit  # noqa: F401

KNOBS = ("RDFIND_SERVE_OBS", "RDFIND_SERVE_OBS_SLOW_US",
         "RDFIND_SERVE_OBS_SLOWLOG", "RDFIND_SLO_P99_US",
         "RDFIND_SLO_ERROR_FRAC", "RDFIND_SLO_STALENESS_S",
         "RDFIND_SLO_FAST_S", "RDFIND_SLO_SLOW_S")


@pytest.fixture(autouse=True)
def _clean_stats(monkeypatch):
    for k in KNOBS:
        monkeypatch.delenv(k, raising=False)
    for mod in (servestats, jstats):
        mod.reset()
        mod.configure()
    yield
    for mod in (servestats, jstats):
        mod.reset()
        mod.configure()


def _traffic(mod):
    """A fixed mix of ok answers (latencies over four decades), refusals and
    malformed requests, recorded into `mod`."""
    for i in range(300):
        mod.record("holds", "ok", us=1.0 + (i * 37) % 4000, generation=i % 3,
                   args=(i, i + 1))
    for i in range(40):
        mod.record("referenced", "ok", us=20000.0 + i, generation=2,
                   args=(f"dep{i}", 16))
    for _ in range(7):
        mod.record("topk", "400")
    for _ in range(3):
        mod.record("holds", "refused")
    mod.record("topk", "503")


def test_aggregate_and_exposition_equal_jax():
    for mod in (servestats, jstats):
        _traffic(mod)
    assert servestats.aggregate() == jstats.aggregate()
    assert servestats.prometheus_text() == jstats.prometheus_text()
    strip = [{k: v for k, v in e.items() if k != "ts"}
             for e in servestats.slowlog()]
    assert strip == [{k: v for k, v in e.items() if k != "ts"}
                     for e in jstats.slowlog()]
    assert len(strip) == 40  # the referenced answers past 10 ms


def test_storm_counts_conserved():
    def work():
        for i in range(3000):
            servestats.record("holds", "ok", us=float(1 + i % 97))

    threads = [threading.Thread(target=work) for _ in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
    assert not any(t.is_alive() for t in threads)
    agg = servestats.aggregate()
    assert agg["requests"]["holds"]["ok"] == 24000
    assert agg["latency_us"]["holds"]["count"] == 24000


@pytest.mark.parametrize("scrape", ["aggregate", "prometheus"])
def test_concurrent_scrape_never_torn(scrape):
    """Four writers against 200 scrapes at a 1 µs switch interval: every
    scrape counts at most as many latency samples as requests, and the
    request counter never goes backwards."""
    stop = threading.Event()

    def storm():
        while not stop.is_set():
            servestats.record("holds", "ok", us=42.0)

    def read():
        if scrape == "aggregate":
            agg = servestats.aggregate()
            lat = agg["latency_us"].get("holds")
            return (agg["requests"].get("holds", {}).get("ok", 0),
                    lat["count"] if lat else 0)
        text = servestats.prometheus_text().splitlines()
        req = [ln for ln in text if ln.startswith(
            'rdfind_serve_requests_total{endpoint="holds",outcome="ok"}')]
        cnt = [ln for ln in text
               if ln.startswith("rdfind_serve_holds_latency_us_count")]
        return (int(req[0].split()[-1]) if req else 0,
                int(cnt[0].split()[-1]) if cnt else 0)

    old = sys.getswitchinterval()
    writers = [threading.Thread(target=storm) for _ in range(4)]
    sys.setswitchinterval(1e-6)
    try:
        for t in writers:
            t.start()
        last = 0
        for _ in range(200):
            n, count = read()
            assert count <= n, f"torn scrape: {count} samples, {n} requests"
            assert n >= last
            last = n
    finally:
        stop.set()
        sys.setswitchinterval(old)
        for t in writers:
            t.join(timeout=10)
    assert not any(t.is_alive() for t in writers)
    final = servestats.aggregate()
    assert final["requests"]["holds"]["ok"] == \
        final["latency_us"]["holds"]["count"] > 0


def test_disabled_records_nothing(monkeypatch):
    monkeypatch.setenv("RDFIND_SERVE_OBS", "0")
    assert servestats.configure() is False
    servestats.record("holds", "ok", us=5.0)
    assert servestats.aggregate()["total"] == 0
    assert servestats.dump_slowlog(".") is None


def test_slowlog_dump_equals_jax_layout(tmp_path, monkeypatch):
    monkeypatch.setenv("RDFIND_SERVE_OBS_SLOW_US", "1000")
    monkeypatch.setenv("RDFIND_SERVE_OBS_SLOWLOG", "3")
    out = {}
    for name, mod in (("t", servestats), ("j", jstats)):
        mod.configure()
        mod.record("holds", "ok", us=10.0)
        for i in range(5):
            mod.record("referenced", "ok", us=2000.0 + i, generation=7,
                       args=(f"dep{i}", 16))
        path = mod.dump_slowlog(str(tmp_path / name), reason="test")
        assert path.endswith("slowlog-host0.json")
        out[name] = json.load(open(path))
    for payload in out.values():
        payload.pop("dumped_at")
        for e in payload["entries"]:
            e.pop("ts")
    assert out["t"] == out["j"]
    assert [e["us"] for e in out["t"]["entries"]] == [2002.0, 2003.0, 2004.0]


def _slo_script(mod):
    """Drive one engine of `mod` through warn, burning, skew and staleness
    cases; returns every verdict."""
    eng = mod.SloEngine(p99_us=500.0, error_frac=0.05, staleness_s=10.0,
                        fast_s=60, slow_s=600)
    verdicts = [eng.evaluate(now=900.0)]  # no traffic
    t = 1000.0
    for i in range(20):
        for _ in range(50):
            mod.record("holds", "ok", us=50.0)
        eng.observe_snapshot(now=t + i * 30)
    for _ in range(10):
        mod.record("holds", "ok", us=50.0)
    for _ in range(30):
        mod.record("holds", "503")
    verdicts.append(eng.evaluate(now=t + 600))           # spike: warn
    for _ in range(200):
        mod.record("holds", "ok", us=9000.0)
    verdicts.append(eng.evaluate(now=t + 605))           # p99 burn
    verdicts.append(eng.evaluate(now=10.0))              # clock skew
    for fresh in ({"generations_behind": 1, "staleness_s": 60.0},
                  {"generations_behind": 1, "staleness_s": 2.0},
                  {"generations_behind": 0, "staleness_s": 60.0},
                  {"generations_behind": 0, "staleness_s": 1.0}):
        verdicts.append(eng.evaluate(freshness=fresh, now=t + 700))
    return verdicts, eng.config()


def test_slo_engine_verdicts_equal_jax():
    got, want = _slo_script(servestats), _slo_script(jstats)
    assert got == want
    states = [(v["state"], v["slo"]) for v in got[0]]
    assert ("warn", "error_frac") in states and ("ok", None) in states
    assert any(s == "burning" for s, _ in states)


def test_process_engine_reads_the_env(monkeypatch):
    monkeypatch.setenv("RDFIND_SLO_P99_US", "250")
    monkeypatch.setenv("RDFIND_SLO_FAST_S", "30")
    servestats.reset()
    jstats.reset()
    assert servestats.slo_config() == jstats.slo_config()
    assert servestats.slo_config()["p99_us"] == 250.0
    assert servestats.evaluate_slo(None, now=5.0)["state"] == "ok"
