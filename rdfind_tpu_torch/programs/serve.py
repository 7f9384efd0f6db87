"""The CIND serving process: ``python -m rdfind_tpu_torch.programs.serve DIR``.

Long-lived query server over the mmap'd index a discovery run committed
into DIR (``--delta-state`` bundles write one per generation; any run does
with ``RDFIND_SERVE_INDEX``).  The process:

  * opens the index zero-copy (runtime/serving.IndexReader — O(header));
  * serves the loopback console grown into the query plane
    (/query/holds, /query/referenced, /query/topk, plus /status with the
    index generation, integrity verdict, and certificate chain) and its
    admin plane (/metrics with the sharded per-request stats, /slo with
    the named SLO verdict, /debug/slowlog with the slow-query ring);
  * polls DIR (RDFIND_SERVE_POLL_S) and hot-swaps generations: when a
    delta run commits N+1 the new mapping is digest-verified and
    chain-checked, then atomically swapped in with zero dropped queries;
  * beats ``mode="serve"`` heartbeats into --obs carrying the freshness
    plane (index_age_s / staleness_s / generations_behind) and the SLO
    verdict, so tpu_watch sees generation/pending-swap/SLO state and
    heartbeat.assess never wedge-flags an idle server;
  * dumps the slow-query ring to --obs on SIGTERM and clean exit
    (slowlog-host<N>.json — the flightrec idiom).

Pure host-side stdlib+numpy: it never initialises CUDA (nothing it imports
touches a device), so a serving box needs no card.  The JAX package's
``programs/serve.py``, copied.
"""

from __future__ import annotations

import argparse
import os
import signal
import sys
import time


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="rdfind-serve",
        description="Serve CIND queries from a discovery run's mmap'd "
                    "index, hot-swapping delta generations as they commit.")
    p.add_argument("index_dir",
                   help="directory holding cind_index.bin (a --delta-state "
                        "bundle dir, or an RDFIND_SERVE_INDEX target)")
    p.add_argument("--console-port", type=int, default=None, metavar="PORT",
                   help="query-plane port (loopback HTTP; 0 = ephemeral, "
                        "printed to stderr; default RDFIND_CONSOLE_PORT "
                        "or 0)")
    p.add_argument("--obs", default=None, metavar="DIR",
                   help="heartbeat directory (mode=\"serve\" beats with the "
                        "loaded + on-disk generations; tpu_watch --status "
                        "reads it)")
    p.add_argument("--poll-s", type=float, default=None,
                   help="bundle-dir poll period in seconds (default "
                        "RDFIND_SERVE_POLL_S or 2.0)")
    p.add_argument("--max-s", type=float, default=0.0,
                   help="exit cleanly after this many seconds (0 = serve "
                        "forever; tests and parity gates use this)")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    from ..obs import console, heartbeat, servestats
    from ..runtime import serving

    servestats.configure()
    poll = serving.poll_s() if args.poll_s is None else max(0.05,
                                                            args.poll_s)
    svc = serving.IndexService(args.index_dir)
    first = svc.poll()
    if first["action"] == "swapped":
        print(f"rdfind-serve: generation {svc.generation} loaded from "
              f"{args.index_dir}", file=sys.stderr)
    else:
        # No (usable) index yet is not fatal: serve 503s and keep polling —
        # the producer run may still be committing.
        print(f"rdfind-serve: no usable index in {args.index_dir} yet "
              f"({first}); polling every {poll}s", file=sys.stderr)

    bind = args.console_port
    if bind is None:
        bind = console.env_port()
    if bind is None:
        bind = 0
    console.set_query_service(svc)
    port = console.start(bind)
    if port is None:
        # A console that cannot bind must never fail the server: heartbeats
        # still publish generation state for the watcher.
        print(f"rdfind-serve: console bind failed (port {bind}); "
              f"serving heartbeat-only", file=sys.stderr)
    else:
        print(f"rdfind-serve: console on http://127.0.0.1:{port} "
              f"(/query/holds /query/referenced /query/topk /status)",
              file=sys.stderr)

    def beat(final: bool = False) -> None:
        # The SLO engine evaluates on every beat even without --obs: the
        # loop IS its snapshot cadence for the burn-rate windows.
        fresh = svc.freshness()
        slo = servestats.evaluate_slo(fresh)
        if not args.obs:
            return
        os.makedirs(args.obs, exist_ok=True)
        st = svc.status()
        heartbeat.Heartbeat(args.obs).beat({
            "stage": "serve", "mode": "serve",
            "generation": st["generation"],
            "bundle_generation": st["bundle_generation"],
            "pending_swap": st["pending"],
            "index_stale": st["stale"], "swaps": st["swaps"],
            "index_age_s": fresh["index_age_s"],
            "staleness_s": fresh["staleness_s"],
            "generations_behind": fresh["generations_behind"],
            "slo": {"state": slo["state"], "slo": slo["slo"]},
            "console_port": port}, final=final)

    def _on_term(signum, frame):
        # Dump the slow-query ring before dying; SystemExit unwinds into
        # the finally block (final beat, console stop, service close).
        servestats.dump_slowlog(args.obs or ".", reason=f"signal-{signum}")
        raise SystemExit(128 + signum)

    try:
        signal.signal(signal.SIGTERM, _on_term)
    except (ValueError, OSError):
        pass  # not the main thread, or an exotic platform: skip the hook

    beat()
    t0 = time.monotonic()
    try:
        while True:
            if args.max_s and time.monotonic() - t0 >= args.max_s:
                break
            time.sleep(min(poll, 0.2) if args.max_s else poll)
            verdict = svc.poll()
            if verdict["action"] == "swapped":
                print(f"rdfind-serve: swapped to generation "
                      f"{verdict['generation']}", file=sys.stderr)
            elif verdict["action"] == "refused":
                print(f"rdfind-serve: swap refused: {verdict}",
                      file=sys.stderr)
            beat()
    except KeyboardInterrupt:
        pass
    finally:
        beat(final=True)
        if args.obs:
            servestats.dump_slowlog(args.obs, reason="exit")
        console.stop()
        svc.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
