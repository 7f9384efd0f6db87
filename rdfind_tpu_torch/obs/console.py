"""The live run console: an off-by-default per-host stdlib HTTP server.

Until now the only ways to watch a running job were tail-ing heartbeat
files over a shared filesystem or waiting for the Prometheus exposition
file to flush.  The console serves the same state over HTTP while the run
is alive, one server per host (``RDFIND_CONSOLE_PORT`` or
``--console-port``; port 0 binds an ephemeral port, printed at startup):

  /metrics    the exact Prometheus text ``--metrics-file`` would write
  /status     liveness: this host's serving state + heartbeat.assess()
              over the obs directory when one is armed
  /progress   where the run is: current stage/pass, per-cap utilization
              (plan-time + per-pass trajectory), forecast advisories, and
              host skew.  The skew/cap structs are already allgathered by
              the sharded executor before they reach the registry, so the
              primary host's /progress IS the aggregated multi-host view.
  /datastats  the data plane: join-line histograms, capture spectra,
              block-skip effectiveness (obs/datastats.py's structs)
  /integrity  the integrity plane: per-stage content digests, verification
              counters, mismatch events (obs/integrity.py's structs)
  /flightrec  the crash-surviving ring (obs/flightrec.py), newest last

When a serving process arms an IndexService (set_query_service), the
console grows from a diagnostics endpoint into the query plane:

  /query/holds?dep=ID&ref=ID       does the CIND hold (capture ids, or
                                   dep_code/dep_v1/dep_v2 + ref_* string
                                   captures)
  /query/referenced?dep=ID[&limit] what the dependent references + support
  /query/topk?k=N                  the k CINDs with the largest support

and /status gains a "serving_index" struct (loaded vs on-disk generation,
pending-swap verdict, freshness, the loaded-generation certificate chain)
plus the named SLO verdict; the admin plane grows two more routes:

  /slo                             the SLO engine's verdict (ok/warn/
                                   burning + which SLO), its config, the
                                   freshness plane, and the aggregated
                                   request counters
  /debug/slowlog                   the bounded slow-query ring (args,
                                   latency, generation — obs/servestats)

and /metrics appends the sharded per-request serving stats (request
counters by endpoint×outcome, latency summaries) to the registry's
exposition.  Every non-200 the query plane returns is counted
(serve_http_400/serve_http_503 + the servestats outcome counters), so
refused or malformed traffic is visible, not silent.

Everything is read-only and served from in-process state (the registry,
the flight recorder, the heartbeat directory) — the handler threads never
touch device state, so a scrape cannot perturb the run.  The server binds
loopback by default; it is a debugging surface, not a product API.

Stdlib-only (the obs contract): http.server's ThreadingHTTPServer on a
daemon thread.  The JAX package's ``obs/console.py``, copied: the same routes
and payloads.
"""

from __future__ import annotations

import json
import os
import threading
import urllib.parse
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from . import flightrec, heartbeat, metrics, servestats

DEFAULT_HOST = "127.0.0.1"

# /progress picks these registry keys (when present) — the "where is the
# run and how much headroom is left" slice of the full snapshot.
_PROGRESS_KEYS = ("run_stage", "run_pass", "n_pair_passes", "planned_caps",
                  "cap_utilization", "cap_utilization_passes",
                  "cap_forecast", "cap_forecast_active", "host_skew",
                  "degradations", "ladder_rung")

_SERVER: ThreadingHTTPServer | None = None
_THREAD: threading.Thread | None = None
_OBS_DIR: str | None = None
_QUERY_SERVICE = None  # runtime.serving.IndexService when a server arms it


def env_port() -> int | None:
    """RDFIND_CONSOLE_PORT, or None when unset/blank/non-numeric."""
    v = os.environ.get("RDFIND_CONSOLE_PORT", "").strip()
    if not v:
        return None
    try:
        return int(v)
    except ValueError:
        return None


def serving() -> bool:
    return _SERVER is not None


def port() -> int | None:
    """The bound port (resolves port-0 ephemeral binds), or None."""
    return _SERVER.server_address[1] if _SERVER is not None else None


def set_obs_dir(directory: str | None) -> None:
    """Point /status at the run's heartbeat directory (driver wires this
    when tracing and the console are both armed)."""
    global _OBS_DIR
    _OBS_DIR = directory


def set_query_service(service) -> None:
    """Arm the /query/* routes with a runtime.serving.IndexService (the
    serving process wires this; None disarms)."""
    global _QUERY_SERVICE
    _QUERY_SERVICE = service


def start(bind_port: int = 0, host: str = DEFAULT_HOST,
          obs_dir: str | None = None) -> int | None:
    """Start the console (idempotent); returns the bound port, or None when
    the bind fails — a console that cannot bind must never fail the run."""
    global _SERVER, _THREAD
    if _SERVER is not None:
        return _SERVER.server_address[1]
    try:
        server = ThreadingHTTPServer((host, int(bind_port)), _Handler)
    except OSError:
        return None
    server.daemon_threads = True
    if obs_dir is not None:
        set_obs_dir(obs_dir)
    _SERVER = server
    _THREAD = threading.Thread(target=server.serve_forever,
                               name="rdfind-console", daemon=True)
    _THREAD.start()
    return server.server_address[1]


def stop() -> None:
    global _SERVER, _THREAD
    server, _SERVER = _SERVER, None
    if server is None:
        return
    try:
        server.shutdown()
        server.server_close()
    except Exception:
        pass
    if _THREAD is not None:
        _THREAD.join(timeout=5.0)
        _THREAD = None
    set_obs_dir(None)
    set_query_service(None)


# ---------------------------------------------------------------------------
# Endpoint payload builders (module functions so tests can call them without
# a socket).
# ---------------------------------------------------------------------------


def progress_payload() -> dict:
    snap = metrics.registry().snapshot(jsonable=True)
    out = {k: snap[k] for k in _PROGRESS_KEYS if k in snap}
    out.setdefault("run_stage", None)
    out.setdefault("run_pass", None)
    return out


def datastats_payload() -> dict:
    snap = metrics.registry().snapshot(jsonable=True)
    return {k: v for k, v in sorted(snap.items())
            if k.startswith("datastats_")}


def integrity_payload() -> dict:
    """The integrity plane's live view: stage digests, verification
    counters, and any mismatch events (obs/integrity.py's structs)."""
    snap = metrics.registry().snapshot(jsonable=True)
    return {k: v for k, v in sorted(snap.items())
            if k.startswith("integrity")}


def status_payload() -> dict:
    out = {"serving": True, "pid": os.getpid(), "obs_dir": _OBS_DIR}
    if _OBS_DIR:
        out["heartbeat"] = heartbeat.assess(_OBS_DIR)
    if _QUERY_SERVICE is not None:
        out["serving_index"] = _QUERY_SERVICE.status()
        out["slo"] = servestats.evaluate_slo(
            out["serving_index"].get("freshness"))
    return out


def slo_payload() -> dict:
    """The /slo admin view: the named verdict, the engine's targets, the
    freshness plane, and the aggregated per-request counters."""
    fresh = (_QUERY_SERVICE.freshness()
             if _QUERY_SERVICE is not None else None)
    return {"verdict": servestats.evaluate_slo(fresh),
            "config": servestats.slo_config(),
            "freshness": fresh,
            "requests": servestats.aggregate()}


def slowlog_payload() -> dict:
    entries = servestats.slowlog()
    return {"enabled": servestats.enabled(),
            "slow_us": servestats.slow_us(),
            "n_entries": len(entries), "entries": entries}


def _reject(endpoint: str, payload: dict, code: int) -> tuple[dict, int]:
    """Route a non-200 query answer through the counters, so refused and
    malformed traffic is counted, never silent."""
    servestats.record(endpoint, str(code))
    metrics.counter_add(None, f"serve_http_{code}")
    return payload, code


def _capture_arg(q: dict, role: str):
    """A capture from query params: `role`=ID (capture id) or the string
    triple `role`_code/`role`_v1/`role`_v2.  Raises ValueError when absent
    or malformed."""
    if role in q:
        return int(q[role][0])
    code_key = f"{role}_code"
    if code_key not in q:
        raise ValueError(f"missing {role} (give {role}=<capture id> or "
                         f"{role}_code/{role}_v1/{role}_v2)")
    v1 = q.get(f"{role}_v1", [None])[0]
    v2 = q.get(f"{role}_v2", [None])[0]
    return (int(q[code_key][0]), v1, v2)


def _answer(endpoint: str, payload: dict) -> tuple[dict, int]:
    """An IndexService answer → (payload, HTTP code).  'no index loaded'
    is a 503, not a 200: the service already counted the refusal; the
    HTTP plane only maps the code (and counts it)."""
    if payload.get("error") == "no index loaded":
        metrics.counter_add(None, "serve_http_503")
        return payload, 503
    return payload, 200


def query_holds_payload(query: str) -> tuple[dict, int]:
    if _QUERY_SERVICE is None:
        return _reject("holds", {"error": "no query service armed"}, 503)
    q = urllib.parse.parse_qs(query)
    try:
        dep = _capture_arg(q, "dep")
        ref = _capture_arg(q, "ref")
    except ValueError as e:
        return _reject("holds", {"error": str(e)}, 400)
    return _answer("holds", _QUERY_SERVICE.query_holds(dep, ref))


def query_referenced_payload(query: str) -> tuple[dict, int]:
    if _QUERY_SERVICE is None:
        return _reject("referenced",
                       {"error": "no query service armed"}, 503)
    q = urllib.parse.parse_qs(query)
    try:
        dep = _capture_arg(q, "dep")
        limit = int(q["limit"][0]) if "limit" in q else None
    except ValueError as e:
        return _reject("referenced", {"error": str(e)}, 400)
    return _answer("referenced",
                   _QUERY_SERVICE.query_referenced(dep, limit=limit))


def query_topk_payload(query: str) -> tuple[dict, int]:
    if _QUERY_SERVICE is None:
        return _reject("topk", {"error": "no query service armed"}, 503)
    q = urllib.parse.parse_qs(query)
    try:
        k = int(q.get("k", ["10"])[0])
    except ValueError as e:
        return _reject("topk", {"error": str(e)}, 400)
    return _answer("topk", _QUERY_SERVICE.query_topk(k))


class _Handler(BaseHTTPRequestHandler):
    # A scrape must never spam the run's stderr.
    def log_message(self, fmt, *args):  # noqa: D102 (http.server API)
        pass

    def _send(self, body: str, content_type: str, code: int = 200) -> None:
        data = body.encode("utf-8")
        self.send_response(code)
        self.send_header("Content-Type", content_type)
        self.send_header("Content-Length", str(len(data)))
        self.end_headers()
        try:
            self.wfile.write(data)
        except (BrokenPipeError, ConnectionResetError):
            pass  # the scraper hung up; the run does not care

    def _send_json(self, payload, code: int = 200) -> None:
        self._send(json.dumps(payload, indent=1, default=str) + "\n",
                   "application/json", code)

    def do_GET(self):  # noqa: N802 (http.server API)
        parts = self.path.split("?", 1)
        path = parts[0].rstrip("/") or "/"
        query = parts[1] if len(parts) > 1 else ""
        try:
            if path == "/metrics":
                body = metrics.registry().prometheus_text()
                if _QUERY_SERVICE is not None:
                    body += servestats.prometheus_text()
                self._send(body, "text/plain; version=0.0.4")
            elif path == "/status":
                self._send_json(status_payload())
            elif path == "/progress":
                self._send_json(progress_payload())
            elif path == "/datastats":
                self._send_json(datastats_payload())
            elif path == "/integrity":
                self._send_json(integrity_payload())
            elif path == "/flightrec":
                self._send_json({"enabled": flightrec.enabled(),
                                 "events": flightrec.snapshot()})
            elif path == "/slo":
                self._send_json(slo_payload())
            elif path == "/debug/slowlog":
                self._send_json(slowlog_payload())
            elif path == "/query/holds":
                self._send_json(*query_holds_payload(query))
            elif path == "/query/referenced":
                self._send_json(*query_referenced_payload(query))
            elif path == "/query/topk":
                self._send_json(*query_topk_payload(query))
            elif path == "/":
                endpoints = ["/metrics", "/status", "/progress",
                             "/datastats", "/integrity", "/flightrec",
                             "/slo", "/debug/slowlog"]
                if _QUERY_SERVICE is not None:
                    endpoints += ["/query/holds", "/query/referenced",
                                  "/query/topk"]
                self._send_json({"endpoints": endpoints})
            else:
                self._send_json({"error": f"unknown path {path}"}, code=404)
        except Exception as e:  # a bad scrape must never kill the thread
            self._send_json({"error": repr(e)}, code=500)
