"""Perf-regression sentinel: BENCH_HISTORY.jsonl and a noise-aware gate.

* :func:`append` flattens one bench result line into a history row —
  headline throughput plus the detail walls — keyed by provenance (git sha,
  n_cores, backend, resolved RDFIND_* knob set) and appends it to
  ``BENCH_HISTORY.jsonl``.
* :func:`check` compares the newest row against a trailing baseline of
  rows with the SAME (n_cores, backend, knobs) key — sha may differ; that
  is the axis under test — and flags a metric when it is worse than the
  baseline median by more than a threshold factor AND worse than the
  baseline's own observed spread explains.  Exit is nonzero on regression,
  so ``python -m rdfind_tpu_torch.obs.sentinel --check`` can gate a script.
* :func:`provenance` is the identity block a run certificate carries.

Noise awareness: with a single baseline row only the ratio test applies;
with more rows the worst historical ratio (max/median) widens the gate, so
a machine whose small bench legitimately wobbles 1.4x does not page at the
default 1.5x threshold while a planted 2x slowdown still trips it.  An
output-digest change at an unchanged key and workload always regresses.

Knobs: ``RDFIND_SENTINEL_THRESHOLD`` (worse-than-median factor, default
1.5) and ``RDFIND_SENTINEL_WINDOW`` (trailing baseline rows, default 5).

The JAX package's ``obs/sentinel.py``, copied (same metric specs, row format
and verdicts).  Stdlib only.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

HISTORY_FILE = "BENCH_HISTORY.jsonl"
DEFAULT_THRESHOLD = 1.5
DEFAULT_WINDOW = 5

# (metric name, path into the bench result, direction).  "lower" = wall
# times (regression is bigger), "higher" = throughput (regression is
# smaller).  Paths that a run did not produce are simply absent from its
# row; check() only compares metrics present on both sides.
METRIC_SPECS = (
    ("headline_pairs_per_sec_per_chip", ("value",), "higher"),
    ("headline_wall_s", ("detail", "wall_s"), "lower"),
    ("s2l_wall_s", ("detail", "s2l", "wall_s"), "lower"),
    ("approx_wall_s", ("detail", "approx", "wall_s"), "lower"),
    ("pipelined_wall_s",
     ("detail", "pipelined_passes", "pipelined", "wall_s"), "lower"),
    ("sync_wall_s", ("detail", "pipelined_passes", "sync", "wall_s"),
     "lower"),
    ("exchange_flat_wall_s", ("detail", "exchange", "flat", "wall_s"),
     "lower"),
    ("exchange_hier_wall_s", ("detail", "exchange", "hier", "wall_s"),
     "lower"),
    # Ingest throughput rows (BENCH_INGEST_ONLY=1 runs promote detail.ingest
    # to the headline; full runs embed the same shape).  Keyed rows carry
    # n_cores in their provenance, so a 1-core proxy never baselines a
    # multicore box.
    ("ingest_serial_triples_per_sec",
     ("detail", "ingest", "serial", "triples_per_sec"), "higher"),
    ("ingest_parallel_triples_per_sec",
     ("detail", "ingest", "parallel", "triples_per_sec"), "higher"),
    ("ingest_parse_speedup_vs_legacy",
     ("detail", "ingest", "parse_speedup_vs_legacy"), "higher"),
    # Kernel-mode walls of the JAX package's bench (plane bits x
    # emit_pipeline K-loop), from the dict view of its per-mode rows; rows
    # without pallas_ms (CPU parity rows, the port's) simply lack them.
    ("kernel_planes8_pallas_ms",
     ("detail", "pallas_vs_jnp", "modes_by_name", "planes8", "pallas_ms"),
     "lower"),
    ("kernel_planes8_emit_pallas_ms",
     ("detail", "pallas_vs_jnp", "modes_by_name", "planes8-emit",
      "pallas_ms"), "lower"),
    ("kernel_planes4_pallas_ms",
     ("detail", "pallas_vs_jnp", "modes_by_name", "planes4", "pallas_ms"),
     "lower"),
    ("kernel_planes4_emit_pallas_ms",
     ("detail", "pallas_vs_jnp", "modes_by_name", "planes4-emit",
      "pallas_ms"), "lower"),
    ("kernel_planes2_pallas_ms",
     ("detail", "pallas_vs_jnp", "modes_by_name", "planes2", "pallas_ms"),
     "lower"),
    ("kernel_planes2_emit_pallas_ms",
     ("detail", "pallas_vs_jnp", "modes_by_name", "planes2-emit",
      "pallas_ms"), "lower"),
    ("kernel_fused_wall_s",
     ("detail", "pallas_vs_jnp", "modes_by_name", "fused", "wall_s"),
     "lower"),
    ("kernel_materialized_wall_s",
     ("detail", "pallas_vs_jnp", "modes_by_name", "materialized", "wall_s"),
     "lower"),
    # Multi-chip kernel-feed rows: per-chip throughput and the
    # stall fraction (exchange-wait ms / dense-compute ms — "can the
    # exchange plane keep the kernels fed"; lower is better, >= 1 means
    # exchange-bound).  overlap/scaling efficiencies regress downward.
    ("kernel_feed_mesh1_pairs_per_sec_per_chip",
     ("detail", "kernel_feed", "mesh1", "pairs_per_sec_per_chip"), "higher"),
    ("kernel_feed_mesh8_pairs_per_sec_per_chip",
     ("detail", "kernel_feed", "mesh8", "pairs_per_sec_per_chip"), "higher"),
    ("kernel_feed_mesh1_stall_fraction",
     ("detail", "kernel_feed", "mesh1", "kernel_feed_stall_fraction"),
     "lower"),
    ("kernel_feed_mesh8_stall_fraction",
     ("detail", "kernel_feed", "mesh8", "kernel_feed_stall_fraction"),
     "lower"),
    ("kernel_feed_mesh8_overlap_efficiency",
     ("detail", "kernel_feed", "mesh8", "overlap_efficiency"), "higher"),
    ("kernel_feed_scaling_efficiency",
     ("detail", "kernel_feed", "scaling_efficiency"), "higher"),
    # Sharded half-approximate two-round rows (bench_half_approx.py): mesh
    # {1,4,8} throughput, the mesh-8 per-device working set (pair buffers +
    # replicated sketch — the equal-memory bound), and the sketch
    # all-reduce's DCN bytes on the 2-host proxy, flat vs hierarchical (the
    # hier reduce must keep paying its factor-`local` cut).
    ("half_approx_mesh1_triples_per_sec",
     ("detail", "half_approx", "mesh1", "triples_per_sec"), "higher"),
    ("half_approx_mesh4_triples_per_sec",
     ("detail", "half_approx", "mesh4", "triples_per_sec"), "higher"),
    ("half_approx_mesh8_triples_per_sec",
     ("detail", "half_approx", "mesh8", "triples_per_sec"), "higher"),
    ("half_approx_mesh8_working_set_bytes",
     ("detail", "half_approx", "mesh8", "working_set_bytes_per_device"),
     "lower"),
    ("half_approx_sketch_dcn_bytes_flat",
     ("detail", "half_approx", "sketch_reduce", "dcn_bytes_flat"), "lower"),
    ("half_approx_sketch_dcn_bytes_hier",
     ("detail", "half_approx", "sketch_reduce", "dcn_bytes_hier"), "lower"),
    # Incremental-discovery rows (bench_delta.py): full-rerun wall over
    # --delta wall per change-batch size, plus the fraction of the pass
    # partition the 1% batch had to re-run (the "time proportional to the
    # change" claim made falsifiable — a regression here means the dirty
    # set stopped being sparse).
    ("delta_speedup_01pct",
     ("detail", "delta", "d01pct", "delta_speedup"), "higher"),
    ("delta_speedup_1pct",
     ("detail", "delta", "d1pct", "delta_speedup"), "higher"),
    ("delta_speedup_10pct",
     ("detail", "delta", "d10pct", "delta_speedup"), "higher"),
    ("delta_frac_passes_rerun_1pct",
     ("detail", "delta", "d1pct", "frac_passes_rerun"), "lower"),
    ("delta_wall_1pct_s",
     ("detail", "delta", "d1pct", "delta_wall_s"), "lower"),
    # Serving rows (bench_serve.py): the query plane's hot path gates like
    # a kernel — single-thread holds() QPS over the mmap'd index, the
    # O(header) open time (a regression here means something started
    # materializing sections at open), and the holds() tail latency.
    ("serve_qps", ("detail", "serve", "holds_qps"), "higher"),
    ("serve_open_ms", ("detail", "serve", "open_ms"), "lower"),
    ("serve_p99_us", ("detail", "serve", "holds_p99_us"), "lower"),
    # The serving observability plane's own contract: instrumented
    # service-path QPS, the telemetry overhead fraction, and the
    # bundle-commit -> serving-swap staleness across a live hot swap.
    ("serve_obs_qps",
     ("detail", "serve", "holds_qps_svc_obs"), "higher"),
    ("serve_obs_overhead_frac",
     ("detail", "serve", "obs_overhead_frac"), "lower"),
    ("serve_swap_staleness_s",
     ("detail", "serve", "swap_staleness_s"), "lower"),
)
_DIRECTIONS = {name: d for name, _, d in METRIC_SPECS}


def _git_sha() -> str | None:
    try:
        out = subprocess.run(
            ["git", "rev-parse", "--short", "HEAD"],
            cwd=os.path.dirname(os.path.dirname(
                os.path.dirname(os.path.abspath(__file__)))),
            capture_output=True, text=True, timeout=10)
        sha = out.stdout.strip()
        return sha if out.returncode == 0 and sha else None
    except Exception:
        return None


def resolved_knobs() -> dict[str, str]:
    """The RDFIND_* env as this process sees it — the knob half of a
    history row's identity (two rows with different knobs never compare)."""
    return {k: os.environ[k] for k in sorted(os.environ)
            if k.startswith("RDFIND_")}


def provenance(backend: str | None = None) -> dict:
    """The identity fields every bench row carries: git sha, core count,
    backend, and the resolved knob set."""
    return {"sha": _git_sha(), "n_cores": os.cpu_count(),
            "backend": backend, "knobs": resolved_knobs()}


def _dig(result: dict, path: tuple):
    cur = result
    for p in path:
        if not isinstance(cur, dict) or p not in cur:
            return None
        cur = cur[p]
    return cur


def extract_metrics(result: dict) -> dict[str, float]:
    out = {}
    for name, path, _direction in METRIC_SPECS:
        if path == ("value",) and result.get(
                "metric") != "cind_pairs_checked_per_sec_per_chip":
            # The top-level value is only the pairs/s headline on a full
            # bench.py row.  Promoted standalone rows (ingest-only,
            # kernel-modes, bench_delta) reuse the slot for a different
            # unit under the SAME provenance key — recording it as the
            # headline would fake a regression against the real headline
            # baseline.  Their numbers ride their own detail.* specs.
            continue
        v = _dig(result, path)
        if isinstance(v, (int, float)) and not isinstance(v, bool) and v > 0:
            out[name] = float(v)
    return out


def build_row(result: dict, backend: str | None = None) -> dict:
    if backend is None:
        backend = _dig(result, ("detail", "backend"))
    row = {"ts": round(time.time(), 3), **provenance(backend=backend),
           "metrics": extract_metrics(result)}
    # Integrity plane (obs/integrity.py): the run's output digest plus the
    # workload it was computed over.  Digests only ever compare between rows
    # with the same provenance key AND the same workload — the tiny
    # verify.sh bench and a full bench must never cross-compare.
    dig = _dig(result, ("detail", "output_digest"))
    if dig:
        row["output_digest"] = str(dig)
        row["workload"] = _dig(result, ("detail", "workload"))
    return row


def default_history_path() -> str:
    return os.path.join(
        os.path.dirname(os.path.dirname(
            os.path.dirname(os.path.abspath(__file__)))), HISTORY_FILE)


def append(result: dict, path: str | None = None,
           backend: str | None = None) -> dict:
    """Append one bench result as a history row; returns the row."""
    row = build_row(result, backend=backend)
    path = path or default_history_path()
    with open(path, "a") as f:
        f.write(json.dumps(row, default=str) + "\n")
    return row


def load_history(path: str | None = None) -> list[dict]:
    path = path or default_history_path()
    rows = []
    try:
        with open(path) as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                try:
                    rows.append(json.loads(line))
                except ValueError:
                    continue  # torn tail line (a killed bench) is not fatal
    except OSError:
        pass
    return rows


def _row_key(row: dict) -> str:
    return json.dumps([row.get("n_cores"), row.get("backend"),
                       row.get("knobs", {})], sort_keys=True, default=str)


def check_verdict(path: str | None = None, threshold: float | None = None,
                  window: int | None = None) -> dict:
    """The structured verdict behind :func:`check` (and ``--json``).

    Returns {"ok", "status", "threshold", "window", "n_baseline", "sha",
    "metrics": {name: {value, median, worse_ratio, gate, regressed}},
    "regressions": [name...]}, where status is one of "no-history" /
    "no-baseline" / "ok" / "regression".
    """
    if threshold is None:
        threshold = float(os.environ.get("RDFIND_SENTINEL_THRESHOLD",
                                         str(DEFAULT_THRESHOLD)))
    if window is None:
        window = int(os.environ.get("RDFIND_SENTINEL_WINDOW",
                                    str(DEFAULT_WINDOW)))
    verdict = {"ok": True, "status": "no-history", "threshold": threshold,
               "window": window, "n_baseline": 0, "sha": None,
               "metrics": {}, "regressions": []}
    rows = load_history(path)
    if not rows:
        return verdict
    newest = rows[-1]
    verdict["sha"] = newest.get("sha")
    verdict["n_cores"] = newest.get("n_cores")
    verdict["backend"] = newest.get("backend")
    key = _row_key(newest)
    baseline = [r for r in rows[:-1] if _row_key(r) == key][-window:]
    if not baseline:
        verdict["status"] = "no-baseline"
        return verdict
    verdict["n_baseline"] = len(baseline)
    for name, value in sorted(newest.get("metrics", {}).items()):
        hist = [r["metrics"][name] for r in baseline
                if isinstance(r.get("metrics", {}).get(name), (int, float))]
        if not hist or value <= 0:
            continue
        hist.sort()
        median = hist[len(hist) // 2]
        if median <= 0:
            continue
        # worse-ratio > 1 means this row regressed vs the median.
        if _DIRECTIONS[name] == "lower":
            worse = value / median
            spread = max(hist) / median
        else:
            worse = median / value
            spread = median / min(hist)
        # Noise-aware gate: the baseline's own worst wobble (plus 10%
        # margin) widens the threshold — a jittery metric needs a bigger
        # excursion to page than a historically stable one.
        gate = max(threshold, spread * 1.1)
        regressed = worse > gate
        verdict["metrics"][name] = {
            "value": value, "median": median,
            "worse_ratio": round(worse, 3), "gate": round(gate, 3),
            "regressed": regressed}
        if regressed:
            verdict["regressions"].append(name)
    # Correctness gate (the integrity plane): an output-digest change at an
    # unchanged provenance key + workload is never noise — the run computed
    # a DIFFERENT result set on the same inputs.  No threshold, no spread:
    # any change regresses.
    new_dig = newest.get("output_digest")
    if new_dig:
        wl = json.dumps(newest.get("workload"), sort_keys=True, default=str)
        prior = sorted({r["output_digest"] for r in baseline
                        if r.get("output_digest")
                        and json.dumps(r.get("workload"), sort_keys=True,
                                       default=str) == wl})
        changed = bool(prior) and new_dig not in prior
        verdict["correctness"] = {"output_digest": new_dig,
                                  "baseline_digests": prior,
                                  "regressed": changed}
        if changed:
            verdict["regressions"].append("output_digest")
    verdict["ok"] = not verdict["regressions"]
    verdict["status"] = "ok" if verdict["ok"] else "regression"
    return verdict


def check(path: str | None = None, threshold: float | None = None,
          window: int | None = None) -> tuple[bool, list[str]]:
    """(ok, report_lines): newest row vs the trailing same-key baseline —
    the prose rendering of :func:`check_verdict` (exit semantics
    unchanged)."""
    v = check_verdict(path=path, threshold=threshold, window=window)
    if v["status"] == "no-history":
        return True, ["sentinel: no history rows — nothing to check"]
    if v["status"] == "no-baseline":
        return True, [f"sentinel: no baseline rows match "
                      f"(n_cores={v.get('n_cores')}, "
                      f"backend={v.get('backend')}) — pass by default"]
    lines = [f"sentinel: newest sha={v['sha']} vs "
             f"{v['n_baseline']} baseline row(s), threshold "
             f"{v['threshold']}x"]
    for name, m in sorted(v["metrics"].items()):
        verdict = "REGRESSION" if m["regressed"] else "ok"
        lines.append(f"  {name}: {m['value']} vs median {m['median']} "
                     f"(worse-ratio {m['worse_ratio']:.3f}, "
                     f"gate {m['gate']:.3f}) {verdict}")
    corr = v.get("correctness")
    if corr:
        verdict = ("CORRECTNESS REGRESSION" if corr["regressed"] else "ok")
        lines.append(f"  output_digest: {corr['output_digest']} vs baseline "
                     f"{corr['baseline_digests'] or ['(none)']} {verdict}")
    if v["regressions"]:
        lines.append(f"sentinel: REGRESSION in {', '.join(v['regressions'])}")
        return False, lines
    lines.append("sentinel: ok")
    return True, lines


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m rdfind_tpu_torch.obs.sentinel",
        description="Append bench.py result lines to BENCH_HISTORY.jsonl "
                    "and gate on noise-aware regression thresholds.")
    ap.add_argument("--check", action="store_true",
                    help="compare the newest history row against the "
                         "trailing baseline; exit 1 on regression")
    ap.add_argument("--append", metavar="FILE", default=None,
                    help="append the bench JSON line in FILE ('-' = stdin)")
    ap.add_argument("--history", default=None,
                    help=f"history path (default: repo {HISTORY_FILE})")
    ap.add_argument("--threshold", type=float, default=None,
                    help="worse-than-median factor that flags a regression "
                         f"(default {DEFAULT_THRESHOLD} or "
                         "RDFIND_SENTINEL_THRESHOLD)")
    ap.add_argument("--window", type=int, default=None,
                    help=f"trailing baseline rows (default {DEFAULT_WINDOW} "
                         "or RDFIND_SENTINEL_WINDOW)")
    ap.add_argument("--json", action="store_true",
                    help="--check: print ONE machine-readable JSON verdict "
                         "line (status, offending metrics, window size) "
                         "instead of the prose report; exit codes are "
                         "identical")
    args = ap.parse_args(argv)
    did = False
    if args.append is not None:
        text = (sys.stdin.read() if args.append == "-"
                else open(args.append).read())
        result = json.loads(text.strip().splitlines()[-1])
        row = append(result, path=args.history)
        print(f"sentinel: appended row sha={row['sha']} "
              f"metrics={sorted(row['metrics'])}")
        did = True
    if args.check:
        if args.json:
            v = check_verdict(path=args.history, threshold=args.threshold,
                              window=args.window)
            print(json.dumps(v, sort_keys=True, default=str))
            return 0 if v["ok"] else 1
        ok, lines = check(path=args.history, threshold=args.threshold,
                          window=args.window)
        print("\n".join(lines))
        return 0 if ok else 1
    if not did:
        ap.print_help()
        return 2
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
