"""Trace merging/export and the one formatter behind every counter report.

Two jobs live here:

* **Trace tooling.**  Each host's tracer writes ``events-host<N>.jsonl``;
  ``export_chrome_trace`` merges them into one Chrome-trace JSON (per-host
  lanes via the pid field, timestamps rebased to the earliest event) that
  loads in Perfetto (ui.perfetto.dev) or chrome://tracing.  Run standalone:
  ``python -m rdfind_tpu_torch.obs.report TRACE_DIR``.  ``build_span_tree``
  reconstructs the span hierarchy from the B/E stream (every open span
  closes, passes nest under stages).

* **Counter formatting.**  ``format_debug_lines`` / ``format_counter_lines`` /
  ``format_timing_lines`` are the single rendering of the stats keys (the key
  lists themselves live in obs/metrics.py), in the JAX package's formats.

The JAX package's ``obs/report.py``, copied.  Stdlib only.
"""

from __future__ import annotations

import json
import os

from . import forecast, metrics
from .tracer import EVENTS_PREFIX

TRACE_FILE = "trace.json"


# ---------------------------------------------------------------------------
# Trace loading / merging / export.
# ---------------------------------------------------------------------------


def load_events(path: str) -> list[dict]:
    """Events from one per-host JSONL file (torn tail lines are skipped —
    a preempted run's file ends mid-write by design)."""
    out = []
    try:
        with open(path) as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                try:
                    out.append(json.loads(line))
                except ValueError:
                    continue
    except OSError:
        pass
    return out


def host_event_files(trace_dir: str) -> dict[int, str]:
    """{host_index: path} of every per-host event file in the directory."""
    out = {}
    try:
        names = os.listdir(trace_dir)
    except OSError:
        return out
    for name in names:
        if not (name.startswith(EVENTS_PREFIX) and name.endswith(".jsonl")):
            continue
        try:
            h = int(name[len(EVENTS_PREFIX):-len(".jsonl")])
        except ValueError:
            continue
        out[h] = os.path.join(trace_dir, name)
    return out


def merge_traces(trace_dir: str) -> dict:
    """All hosts' events as one Chrome-trace object with per-host lanes.

    Every event's pid is forced to the host index from its FILE name (the
    authoritative lane assignment; a mislabeled event cannot jump lanes),
    timestamps are rebased to the earliest event across hosts, and each
    lane gets a process_name metadata record so Perfetto shows "host N".
    """
    events: list[dict] = []
    files = host_event_files(trace_dir)
    for h in sorted(files):
        for ev in load_events(files[h]):
            ev["pid"] = h
            events.append(ev)
    t0 = min((ev["ts"] for ev in events if "ts" in ev), default=0)
    for ev in events:
        if "ts" in ev:
            ev["ts"] = ev["ts"] - t0
    meta = [{"name": "process_name", "ph": "M", "pid": h, "tid": 0,
             "args": {"name": f"host {h}"}} for h in sorted(files)]
    return {"traceEvents": meta + events, "displayTimeUnit": "ms"}


def export_chrome_trace(trace_dir: str, out_path: str | None = None) -> str:
    """Write the merged Chrome-trace JSON next to the event files."""
    trace = merge_traces(trace_dir)
    out_path = out_path or os.path.join(trace_dir, TRACE_FILE)
    tmp = out_path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(trace, f, default=str)
    os.replace(tmp, out_path)
    return out_path


def build_span_tree(events: list[dict]) -> tuple[list[dict], list[dict]]:
    """(roots, unclosed) span trees from a B/E event stream.

    Spans nest per (pid, tid) lane in stream order.  Each node is
    {"name", "cat", "ts", "dur", "args", "children"}; `unclosed` lists
    spans whose E event never arrived (empty on a clean run — the span-tree
    integrity contract).
    """
    stacks: dict[tuple, list[dict]] = {}
    roots: list[dict] = []
    unclosed: list[dict] = []
    for ev in events:
        lane = (ev.get("pid"), ev.get("tid"))
        stack = stacks.setdefault(lane, [])
        ph = ev.get("ph")
        if ph == "B":
            node = {"name": ev.get("name"), "cat": ev.get("cat"),
                    "ts": ev.get("ts"), "dur": None,
                    "args": ev.get("args", {}), "children": []}
            (stack[-1]["children"] if stack else roots).append(node)
            stack.append(node)
        elif ph == "E":
            while stack:
                node = stack.pop()
                node["dur"] = ev.get("ts", node["ts"]) - node["ts"]
                if node["name"] == ev.get("name"):
                    break
        elif ph == "i":
            node = {"name": ev.get("name"), "cat": ev.get("cat"),
                    "ts": ev.get("ts"), "dur": 0,
                    "args": ev.get("args", {}), "children": []}
            (stack[-1]["children"] if stack else roots).append(node)
    for stack in stacks.values():
        unclosed.extend(stack)
    return roots, unclosed


def walk_spans(roots: list[dict]):
    """Depth-first (node, parent) pairs over a span forest."""
    todo = [(n, None) for n in roots]
    while todo:
        node, parent = todo.pop()
        yield node, parent
        todo.extend((c, node) for c in node["children"])


# ---------------------------------------------------------------------------
# The one counter formatter (--debug-level and --counters share these).
# ---------------------------------------------------------------------------


def format_debug_lines(stats: dict) -> list[str]:
    """Every --debug stats line the driver prints, in fixed order, rendered
    from the canonical key groups in obs/metrics.py."""
    lines: list[str] = []
    ing = stats.get("ingest")
    if ing:
        # Parallel-ingest telemetry: phase split (worker phases are sums
        # across threads), throughput, and the consumer-side stall count.
        lines.append(
            f"ingest: threads={ing.get('n_threads')} "
            f"units={ing.get('n_units')} files={ing.get('n_files')} "
            f"bytes={ing.get('bytes_read')} "
            f"read_ms={ing.get('read_ms')} parse_ms={ing.get('parse_ms')} "
            f"intern_ms={ing.get('intern_ms')} "
            f"merge_ms={ing.get('merge_ms')} remap_ms={ing.get('remap_ms')} "
            f"stalls={ing.get('queue_stalls')} "
            f"triples/s={ing.get('triples_per_sec')} "
            f"bytes/s={ing.get('bytes_per_sec')}")
    if stats.get("exchange_sites"):
        # Per-exchange communication ledger: fixed-shape collective volume
        # per site, split by interconnect tier (intra-host ICI vs inter-host
        # DCN) — the input to multi-chip bandwidth projections.
        for site, e in sorted(stats["exchange_sites"].items()):
            # Timing keys exist only under RDFIND_COLLECTIVE_TIMING — the
            # suffix is additive so untimed runs render the historical line.
            timing = ""
            if "wall_ms" in e:
                timing = (f" wall_ms={e['wall_ms']} gbps={e.get('gbps', 0)} "
                          f"link_util={e.get('link_util', 0)}")
            lines.append(
                f"exchange[{site}]: calls={e['calls']} "
                f"capacity={e['capacity']} lanes={e['lanes']} "
                f"bytes={e['bytes']} ici_bytes={e.get('ici_bytes', 0)} "
                f"dcn_bytes={e.get('dcn_bytes', 0)} "
                f"reply_bytes={e.get('reply_bytes', 0)} "
                f"hier={e.get('hier', 0)} "
                f"rows_capacity={e['rows_capacity']} "
                f"overflow_retries={e['overflow_retries']}" + timing)
    if "overlap" in stats:
        # The overlap-efficiency row: where the measured wall sits between
        # the no-overlap and perfect-overlap bounds (dispatch.overlap_report).
        ov = stats["overlap"]
        lines.append(
            f"overlap: passes={ov['n_passes']} "
            f"measured_ms={ov['measured_ms']} pull_ms={ov['pull_ms']} "
            f"overlap_ms={ov['overlap_ms']} "
            f"serial_bound_ms={ov['serial_bound_ms']} "
            f"parallel_bound_ms={ov['parallel_bound_ms']} "
            f"efficiency={ov['overlap_efficiency']}")
    if "host_skew" in stats:
        # Straggler verdict: slowest host, how much slower, and which phase.
        hs = stats["host_skew"]
        lines.append(
            f"host skew: hosts={hs['n_hosts']} passes={hs['n_passes']} "
            f"skew_index={hs['skew_index']} "
            f"slowest_host={hs['slowest_host']} cause={hs['cause']}")
    if "dense_plan" in stats:
        # Dense cooc occupancy: the roofline-correcting record (issued vs
        # real FLOPs of the scheduled tile sweep) plus the resolved dtype.
        # The kernel_resolution struct (cooc.resolution_report) folds the
        # remaining kernel-mode decisions — emit-pipeline K schedule and
        # the actual plane element type — onto the same line, so every
        # plane-bits/emit/fuse choice reads in one place.
        dp = stats["dense_plan"]
        kr = stats.get("kernel_resolution", {})
        res = ""
        if kr:
            res = (f"kernel={kr.get('kernel_dtype')}"
                   f"/{kr.get('plane_elem')} "
                   f"emit={1 if kr.get('emit_pipeline') else 0} ")
        lines.append(
            f"dense plan: dtype={stats.get('cooc_dtype')} "
            f"policy={dp['policy']} "
            f"planes={dp.get('plane_bits', 8)}b " + res +
            f"fused={1 if dp.get('fuse_verdict') else 0} "
            f"lines={dp['l_real']}/{dp['l_pad']} "
            f"caps={dp['c_real']}/{dp['c_pad']} tile={dp['tile']} "
            f"tiles={dp['n_tiles'] - dp['n_tiles_skipped']}"
            f"/{dp['n_tiles']} "
            f"blocks_skipped={dp.get('n_blocks_skipped', 0)}"
            f"/{dp.get('n_blocks', 0)} occupancy={dp['occupancy']}")
    elif "cooc_dtype" in stats:
        kr = stats.get("kernel_resolution", {})
        if kr:
            lines.append(
                f"cooc dtype: {stats['cooc_dtype']} "
                f"planes={kr.get('plane_bits')}b "
                f"kernel={kr.get('kernel_dtype')}/{kr.get('plane_elem')} "
                f"emit={1 if kr.get('emit_pipeline') else 0} "
                f"fused={1 if kr.get('fuse_verdict') else 0}")
        else:
            lines.append(f"cooc dtype: {stats['cooc_dtype']}")
    if "n_host_syncs" in stats:
        # Dispatch telemetry of the pipelined pass executor: proof the
        # compute/readback overlap happened, not an assertion of it.
        lines.append(
            f"dispatch: passes={stats.get('n_pair_passes', 1)} "
            f"in_flight={stats.get('n_passes_in_flight', 1)} "
            f"host_syncs={stats['n_host_syncs']} "
            f"sync_ms={stats.get('host_sync_ms', 0.0):.1f} "
            f"overlap_ms={stats.get('pull_overlap_ms', 0.0):.1f} "
            f"cap_retries={stats.get('n_pair_cap_retries', 0)} "
            f"cap_p={stats.get('cap_p_final', 0)}")
    if stats.get("hbm"):
        hbm = stats["hbm"]
        lines.append(
            f"hbm: in_use={hbm.get('in_use_bytes')} "
            f"peak={hbm.get('peak_bytes')} limit={hbm.get('limit_bytes')} "
            f"frac={hbm.get('frac')} delta={hbm.get('delta_bytes')}")
    if stats.get("degradations"):
        # The degradation ledger: every ladder rung the run took instead of
        # dying (grow / split / skip / fallback), in order.
        for step in stats["degradations"]:
            lines.append(f"degradation: {step}")
        lines.append(f"ladder rungs: {stats.get('ladder_rung', {})}")
    if (stats.get("n_overflow_retries") or stats.get("n_host_pull_retries")
            or stats.get("resumed_passes")):
        lines.append(
            f"fault recovery: overflow_retries="
            f"{stats.get('n_overflow_retries', 0)} "
            f"host_pull_retries={stats.get('n_host_pull_retries', 0)} "
            f"backoff_ms={stats.get('backoff_ms_total', 0.0):.1f} "
            f"resumed_passes={stats.get('resumed_passes', 0)}")
    if stats.get("elastic_resume"):
        # Resume lineage: what mesh the snapshots came from, what got
        # re-sharded, and how the hosts agreed (models/sharded
        # _resolve_resume + the driver's preemption supervisor).
        er = stats["elastic_resume"]
        lines.append(
            f"elastic resume: from_dev={er.get('from_num_dev', '-')} "
            f"to_dev={er.get('to_num_dev', '-')} "
            f"resharded_blocks={er.get('resharded_blocks', 0)} "
            f"resharded_bytes={er.get('resharded_bytes', 0)} "
            f"vote_rounds={er.get('vote_rounds', 0)} "
            f"adopted_n_pass={er.get('adopted_n_pass', '-')} "
            f"supervisor_attempts={er.get('supervisor_attempts', 0)}")
    if stats.get("datastats_lines"):
        # The data plane: what the join-line / capture distributions looked
        # like (obs/datastats.py), not just what the machinery did to them.
        dl = stats["datastats_lines"]
        lines.append(
            f"datastats[lines]: n={dl.get('n_lines')} "
            f"max={dl.get('max_line')} giants={dl.get('giant_lines')} "
            f"giant_share={dl.get('giant_share')} "
            f"source={dl.get('source')}")
    if stats.get("datastats_captures"):
        dc = stats["datastats_captures"]
        lines.append(
            f"datastats[captures]: n={dc.get('n_captures')} "
            f"max_support={dc.get('max_support')} "
            f"source={dc.get('source')}")
    if stats.get("datastats_block_skip"):
        bs = stats["datastats_block_skip"]
        lines.append(
            f"datastats[block_skip]: skipped={bs.get('n_blocks_skipped')}"
            f"/{bs.get('n_blocks')} frac={bs.get('skip_frac')}")
    if stats.get("cap_utilization"):
        caps = " ".join(
            f"{cap}={row.get('used')}/{row.get('planned')}"
            f"({row.get('frac')})"
            for cap, row in sorted(stats["cap_utilization"].items()))
        lines.append(f"cap utilization: {caps}")
    # Forecast advisories render through the one shared formatter — the
    # --debug output and `report --summary` cannot drift apart.
    lines.extend(forecast.format_lines(stats))
    return lines


def summarize_passes(trace_dir: str) -> dict[int, dict]:
    """Per-host per-pass rows joined from the trace counter lanes.

    Reads each host's ``events-host<N>.jsonl`` and rebuilds the pass table
    the run printed live: one row per ``pass_phase_ms`` counter sample, the
    preceding ``host_skew`` sample attached to it (the skew meter emits
    skew, then phases, per committed pass), the matching
    ``cap_utilization`` sample joined on its own pass index, and every
    ``cap_forecast`` instant collected as advisories.  Returns
    {host: {"passes": [row...], "advisories": [adv...]}}.
    """
    out: dict[int, dict] = {}
    for h, path in sorted(host_event_files(trace_dir).items()):
        rows: list[dict] = []
        util_by_pass: dict[int, dict] = {}
        advisories: list[dict] = []
        pending_skew: dict | None = None
        for ev in load_events(path):
            name, ph = ev.get("name"), ev.get("ph")
            args = ev.get("args", {})
            if ph == "C" and name == "host_skew":
                pending_skew = args
            elif ph == "C" and name == "pass_phase_ms":
                row = {"pass": len(rows), "phase_ms": dict(args)}
                if pending_skew is not None:
                    row["skew"] = pending_skew.get("skew")
                    row["slowest"] = pending_skew.get("slowest")
                    pending_skew = None
                rows.append(row)
            elif ph == "C" and name == "cap_utilization":
                util_by_pass[args.get("pass")] = {
                    k: v for k, v in args.items() if k != "pass"}
            elif ph == "i" and name == "cap_forecast":
                advisories.append(dict(args))
        for row in rows:
            if row["pass"] in util_by_pass:
                row["cap_util"] = util_by_pass[row["pass"]]
        out[h] = {"passes": rows, "advisories": advisories}
    return out


def format_summary_lines(summary: dict[int, dict]) -> list[str]:
    """The `report --summary` rendering: one line per committed pass (total
    + phase split + host skew + cap-utilization fractions), then the
    forecast advisories through the shared advisory formatter."""
    lines: list[str] = []
    for h in sorted(summary):
        for row in summary[h]["passes"]:
            pm = row["phase_ms"]
            total = sum(v for v in pm.values()
                        if isinstance(v, (int, float)))
            phases = " ".join(f"{k}={v}" for k, v in pm.items())
            skew = (f" skew={row['skew']} slowest={row['slowest']}"
                    if row.get("skew") is not None else "")
            util = ""
            if row.get("cap_util"):
                util = " | util " + " ".join(
                    f"{k}={v}" for k, v in sorted(row["cap_util"].items()))
            lines.append(f"host {h} pass {row['pass']}: {total:.1f} ms "
                         f"({phases}){skew}{util}")
        for adv in summary[h]["advisories"]:
            lines.append(f"host {h} " + forecast.advisory_line(adv))
    if not lines:
        lines.append("no committed passes recorded (was the run traced "
                     "with --trace, and did it reach the pair passes?)")
    return lines


def format_counter_lines(counters: dict) -> list[str]:
    """The -c counter report (sorted `key: value` lines)."""
    return [f"{k}: {v}" for k, v in sorted(counters.items())]


def format_timing_lines(timings: dict, counters: dict | None = None) -> list[str]:
    """Phase wall-clock report + the machine-readable CSV line
    (AbstractFlinkProgram.java:149-182)."""
    total = sum(timings.values())
    lines = [f"phase {name}: {secs * 1000:.1f} ms"
             for name, secs in timings.items()]
    lines.append(f"total: {total * 1000:.1f} ms")
    counters = counters or {}
    csv = ",".join([f"{timings.get(k, 0.0) * 1000:.0f}"
                    for k in ("read+parse", "intern", "discover")]
                   + [f"{total * 1000:.0f}",
                      str(counters.get("cind-counter", 0))])
    lines.append(f"csv:{csv}")
    return lines


def dispatch_row(stats: dict) -> dict:
    """The dispatch+fault telemetry row of one run, built from the canonical
    key groups so the driver and the tests cannot drift."""
    return {k: stats.get(k)
            for k in metrics.DISPATCH_KEYS + metrics.FAULT_KEYS[:3]}


def kernel_feed_stall_fraction(host_skew: dict | None) -> float | None:
    """Kernel-feed stall fraction: exchange-wait ms ÷ dense-compute ms.

    Derived from the _SkewMeter phase vectors (stats["host_skew"]
    ["phase_ms"], per-host totals over the committed passes): the fraction
    of the dense compute wall the exchange machinery spends feeding it.
    0.1 means the exchange costs 10% of the kernel time it feeds — the
    hierarchical exchange "can feed the kernel"; >= 1.0 means the
    sweep is exchange-bound and more chips will not help until the feed
    path improves.  Summed across hosts so multi-host skew does not hide
    in a mean.  None when the meter never armed (no obs consumer) or no
    compute was recorded — callers must treat absence as "not measured",
    never as 0 (a genuinely stall-free run reports 0.0, not None)."""
    phases = (host_skew or {}).get("phase_ms") or {}
    exchange = phases.get("exchange")
    compute = phases.get("compute")
    if not exchange or not compute:
        return None
    compute_ms = float(sum(compute))
    if compute_ms <= 0:
        return None
    return round(float(sum(exchange)) / compute_ms, 4)


def profile_kernel_counts(path: str, symbols: dict) -> dict:
    """{name: device kernel events whose name holds symbols[name]} of a
    torch.profiler Chrome trace (``--profile-dir``'s ``profile.json``)."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    kernels = [str(e.get("name", "")) for e in events
               if e.get("cat") == "kernel"]
    return {name: sum(sym in k for k in kernels)
            for name, sym in symbols.items()}


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(
        prog="python -m rdfind_tpu_torch.obs.report",
        description="Merge per-host trace event files into one Chrome-trace "
                    "JSON (open in Perfetto: ui.perfetto.dev).")
    ap.add_argument("trace_dir", help="directory holding events-host*.jsonl")
    ap.add_argument("-o", "--output", default=None,
                    help="output path (default: TRACE_DIR/trace.json)")
    ap.add_argument("--summary", action="store_true",
                    help="print the per-pass table (phase ms, host skew, "
                         "cap utilization, forecast advisories) instead of "
                         "exporting the Chrome trace")
    args = ap.parse_args(argv)
    files = host_event_files(args.trace_dir)
    if not files:
        print(f"no {EVENTS_PREFIX}*.jsonl files in {args.trace_dir}")
        return 1
    if args.summary:
        for line in format_summary_lines(summarize_passes(args.trace_dir)):
            print(line)
        return 0
    out = export_chrome_trace(args.trace_dir, args.output)
    n = sum(len(load_events(p)) for p in files.values())
    print(f"wrote {out} ({len(files)} host lane(s), {n} events)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
