"""The RDFind job driver of the port: read -> parse -> intern -> discover -> sink.

The JAX package's single-device driver: native fused ingest (``io/native.py``) by
default, the Python ingest with ``--tabs``, ``--asciify-triples``, ``--prefixes``
and per-file encodings, ``--distinct-triples``, the early stops (``--only-read``,
``--do-only-join``, ``--find-only-fcs``), the join-size histogram, the four
strategies on one device, and the sinks and reports in the JAX package's formats
(sorted ``Cind.pretty()`` output lines, association-rule lines, ``--counters`` and
timing lines, ``--print-plan`` JSON).

The runtime and observability planes run here as in the JAX package: each stage
is a tracer span with a ``stage_<name>_ms`` histogram, a memory watermark and an
exposition flush (``--trace``, ``--metrics-file``); ``--checkpoint-dir`` keeps
the ingest and discover stages (``resume-*`` / ``checkpoint-*`` phases, a failed
write counted in ``checkpoint-errors``); ``--collector`` streams the CINDs to a
remote sink; the integrity plane writes the run certificate (``RDFIND_CERT``);
``--profile-dir`` wraps the run in ``torch.profiler``; ``--console-port`` serves
the live run console for the run's duration.  ``--delta-state`` makes a full run
persist the delta base bundle and its servable index; ``--delta`` replays a
change batch against such a bundle (``runtime/delta.py``), and
``RDFIND_SERVE_INDEX`` names one more directory every run writes its index to
(``runtime/serving.py``).

``--dop N`` runs strategy 0 sharded over N ranks (``models/sharded.py``): the
launcher (``parallel/launch.py``) spawns one process per rank, each runs this
driver SPMD, global rank 0 writes the run's sinks and each host's local rank 0
its host-level files (checkpoints, progress snapshots, trace, metrics export,
heartbeat).  The preemption supervisor (``--retry-on-preempt``) runs in the
launcher's parent: a preempted attempt's ranks exit 75, and the parent backs
off and relaunches them, resuming from the progress snapshots.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import signal
import sys
import threading
import time

import numpy as np
import torch

from .. import conditions as cc
from .. import devices
from ..data import CindTable
from ..dictionary import Dictionary, intern_triples
from ..io import native, ntriples, prefixes, reader
from ..models import allatonce, approximate, late_bb, small_to_large
from ..obs import memory as obs_memory
from ..obs import console, flightrec, integrity, metrics, report, tracer
from ..ops import frequency, segments
from ..ops.emission import emit_join_candidates
from ..parallel import mesh as mesh_mod
from . import checkpoint, delta, serving

# Strategy ids follow the reference: 0 = all-at-once, 1 = small-to-large,
# 2 = approximate all-at-once, 3 = late-BB.
STRATEGIES = {0: allatonce.discover, 1: small_to_large.discover,
              2: approximate.discover, 3: late_bb.discover}


@dataclasses.dataclass
class Config:
    """The single-device subset of the JAX package's driver Config."""

    input_paths: list[str] = dataclasses.field(default_factory=list)
    prefix_paths: list[str] = dataclasses.field(default_factory=list)
    min_support: int = 10
    traversal_strategy: int = 1
    projections: str = "spo"
    use_frequent_item_set: bool = False
    use_association_rules: bool = False
    clean_implied: bool = False
    distinct_triples: bool = False
    asciify_triples: bool = False
    tabs: bool = False
    only_read: bool = False
    only_join: bool = False
    output_file: str | None = None
    ar_output_file: str | None = None
    collect_result: bool = False
    debug_level: int = 0
    counter_level: int = 0
    native_ingest: bool = True  # C++ fused read+parse+intern when applicable
    explicit_threshold: int = -1  # != -1: half-approximate 1/1 (strategy 1)
    sbf_bits: int = -1  # count-min counter bits (-1 = sized to min_support)
    balanced_11: bool = False  # strategy 1: each unordered 1/1 pair once
    print_plan: bool = False  # dump the logical plan as JSON before executing
    encoding: str = "utf-8"  # input charset; "auto" sniffs a BOM per file
    file_filter: str | None = None  # regex on input-file basenames
    merge_window_size: int = -1  # pairs per chunk of the chunked backend
    find_only_fcs: int = 0  # >= 1: stop after frequent-condition mining
    create_join_histogram: bool = False  # print join-line size histogram
    checkpoint_dir: str | None = None  # stage-boundary checkpoints (resume)
    profile_dir: str | None = None  # torch.profiler trace of the whole run
    collector: str | None = None  # "host:port" remote result sink
    trace_dir: str | None = None  # obs: host span trace + heartbeat directory
    metrics_file: str | None = None  # obs: Prometheus text exposition file
    console_port: int | None = None  # obs: live HTTP console (0 = ephemeral)
    # Incremental discovery (runtime/delta.py): --delta runs a change batch
    # against a persisted base bundle; --delta-state makes a full run write
    # one; --deletes names the delete batch files for a delta run.
    delta_base: str | None = None
    delta_state: str | None = None
    delete_paths: list[str] = dataclasses.field(default_factory=list)
    device: str | None = None  # None: the CUDA card
    # The sharded pipeline (--dop > 1, strategy 0) and its supervisor.
    n_devices: int = 1  # ranks in the mesh (the reference's -dop)
    retry_on_preempt: int = 0  # supervisor retry budget
    rebalance_strategy: int = 1  # 1 = hash-slice, 2 = range-slice ownership
    rebalance_threshold: float = 1.0  # scales the avg-load split factor
    rebalance_max_load: float = 10_000.0 * 10_000.0  # absolute split trigger
    combinable_join: bool = True  # False: ship raw join candidates
    coordinator: str | None = None  # "host:port" of the multi-host store
    num_hosts: int = 1
    host_index: int = 0
    attempt: int = 0  # supervisor attempt this run is (set by the parent)


@dataclasses.dataclass
class RunResult:
    table: CindTable
    dictionary: Dictionary | None
    triples: np.ndarray | None
    counters: dict
    timings: dict  # phase -> seconds


class _Phases:
    def __init__(self):
        self.timings = {}

    def run(self, name, fn):
        t0 = time.perf_counter()
        # Registry-only position gauge (never written into a stats dict).
        metrics.gauge_set(None, "run_stage", name)
        with tracer.span(name, cat=tracer.CAT_STAGE):
            out = fn()
        self.timings[name] = time.perf_counter() - t0
        metrics.observe(f"stage_{name}_ms", self.timings[name] * 1e3)
        if tracer.enabled() or metrics.export_requested():
            # Stage-boundary memory watermark and a fresh exposition
            # snapshot, so a scraper sees progress mid-run.
            obs_memory.sample(None, label=f"stage {name}")
            metrics.flush_export()
        return out


def _load_prefix_trie(cfg: Config):
    """(trie, url_of) from the --prefixes files."""
    pairs = []
    for _, line in reader.iter_lines(
            reader.resolve_path_patterns(cfg.prefix_paths)):
        p = prefixes.parse_prefix_line(line)
        if p is not None:
            pairs.append(p)
    return prefixes.build_prefix_trie(pairs), dict(pairs)


def _resolve_inputs(cfg: Config):
    """Input paths + the quad-format sniff (N-Quads when the first input is
    ``.nq``/``.nq.gz``: the graph term is dropped).  Empty inputs are legal
    only for delete-only delta runs (the CLI enforces that), so the sniff
    defaults to triples then."""
    paths = (reader.resolve_path_patterns(cfg.input_paths, cfg.file_filter)
             if cfg.input_paths else [])
    return paths, bool(paths) and paths[0].endswith((".nq", ".nq.gz"))


def load_triples(cfg: Config, phases: _Phases, counters: dict) -> list:
    """The Python ingest: files -> list of (s, p, o) string tokens, then
    asciified and prefix-shortened when asked."""
    paths, is_nq = _resolve_inputs(cfg)

    def parse_all():
        out = []
        for _, line in reader.iter_lines(paths, encoding=cfg.encoding):
            t = (ntriples.parse_tab_line(line) if cfg.tabs
                 else ntriples.parse_line(line, expect_quad=is_nq))
            if t is not None:
                out.append(t)
        return out

    triples = phases.run("read+parse", parse_all)
    counters["input-triples"] = len(triples)
    if cfg.asciify_triples:
        triples = phases.run("asciify", lambda: [
            tuple(prefixes.asciify(v) for v in t) for t in triples])
    if cfg.prefix_paths:
        def shorten():
            trie, url_of = _load_prefix_trie(cfg)
            return [tuple(prefixes.shorten_term(v, trie, url_of) for v in t)
                    for t in triples]

        triples = phases.run("shorten-urls", shorten)
    return triples


def write_output(path: str, table: CindTable, dictionary: Dictionary) -> None:
    """One ``Cind.pretty()`` line per CIND, sorted."""
    lines = sorted(c.pretty() for c in table.decoded(dictionary))
    with open(path, "w") as f:
        for line in lines:
            f.write(line + "\n")


def _join_histogram(ids: np.ndarray, projections: str, device):
    """(line size, number of lines of that size) over the unfiltered join."""
    if ids.shape[0] == 0:
        return []
    t = allatonce.triples_on(ids, device)
    cands = emit_join_candidates(
        t, frequency.no_filter(t.shape[0], t.device), projections)
    cols, _, _ = segments.masked_unique(
        [cands.join_val, cands.code, cands.v1, cands.v2], cands.valid)
    _, line_sizes = torch.unique_consecutive(cols[0], return_counts=True)
    sizes, times = torch.unique(line_sizes, return_counts=True)
    return list(zip(sizes.tolist(), times.tolist()))


def _half_approx_active(cfg: Config) -> bool:
    """Whether --explicit-threshold reaches a strategy: the half-approximate
    1/1 round belongs to small-to-large (1)."""
    return cfg.explicit_threshold != -1 and cfg.traversal_strategy == 1


# Logical stages of each traversal strategy, for --print-plan.
_STRATEGY_PLANS = {
    0: ["emit-join-candidates", "group-by-join-value",
        "pair-phase (co-occurrence matmul / chunked counts)",
        "intersect-refsets", "support-filter", "split-cind-sets"],
    1: ["emit-join-candidates", "group-by-join-value",
        "overlap-1/1", "cind-1/1",
        "generate-1/2", "extract-1/2",
        "generate-2/1", "extract-2/1", "infer-2/1 (from 1/1)",
        "generate-2/2", "prune-2/2-vs-1/2", "extract-2/2",
        "union-families"],
    2: ["emit-join-candidates", "group-by-join-value",
        "round-1: bloom refset sketches + containment matmul",
        "round-2: exact re-verification of sketch candidates",
        "support-filter", "split-cind-sets"],
    3: ["emit-join-candidates", "group-by-join-value",
        "round-1: half-approximate unary-dependent CINDs",
        "round-2: binary dependents pruned by round-1 CINDs",
        "union-rounds", "split-cind-sets"],
}


def describe_plan(cfg: Config) -> dict:
    """A JSON-able description of the stages this config will execute."""
    pre = ["read+parse"]
    if cfg.asciify_triples:
        pre.append("asciify")
    if cfg.prefix_paths:
        pre.append("shorten-urls")
    pre.append("intern")
    if cfg.distinct_triples:
        pre.append("distinct")
    discover = list(_STRATEGY_PLANS.get(cfg.traversal_strategy, ["unknown"]))
    if cfg.use_frequent_item_set:
        discover.insert(0, "frequent-item-sets (condition-support filter)")
    if cfg.use_association_rules and cfg.use_frequent_item_set:
        discover.insert(1, "association-rules (emission suppression + filter)")
    if _half_approx_active(cfg):
        for i, s in enumerate(discover):
            if s == "overlap-1/1":
                discover[i] = ("overlap-1/1 (half-approximate: explicit top-K "
                               "+ count-min spill, two-round)")
    if cfg.clean_implied:
        discover.append("remove-implied-cinds")
    sinks = []
    if cfg.output_file:
        sinks.append(f"write-output -> {cfg.output_file}")
    if cfg.ar_output_file:
        sinks.append(f"write-ar-output -> {cfg.ar_output_file}")
    if cfg.collector:
        sinks.append(f"collect-remote -> {cfg.collector}")
    if cfg.collect_result:
        sinks.append("collect-result (stdout)")
    return {
        "strategy": cfg.traversal_strategy,
        "n_devices": cfg.n_devices,
        "backend": "sharded" if cfg.n_devices > 1 else "single-device",
        "min_support": cfg.min_support,
        "projections": cfg.projections,
        "stages": {"ingest": pre, "discover": discover, "sinks": sinks},
    }


def _trivial_cind_mask(table: CindTable) -> np.ndarray:
    """True where a CIND is trivially implied by its own dependent capture:
    same projection and the referenced condition is a value-matching
    sub-condition of the dependent one.  These must never appear in the
    output; --debug-level 2 counts them."""
    dep = np.asarray(table.dep_code)
    ref = np.asarray(table.ref_code)
    same_proj = cc.secondary(dep) == cc.secondary(ref)
    sub = cc.is_subcode(cc.primary(ref), cc.primary(dep))
    d1, d2, _ = cc.decode(dep)
    r1, r2, _ = cc.decode(ref)
    dv1 = np.asarray(table.dep_v1)
    dv2 = np.asarray(table.dep_v2)
    rv1 = np.asarray(table.ref_v1)
    rv2 = np.asarray(table.ref_v2)

    def dep_val(field):  # the dependent's value on a single-bit field
        return np.where(field == d1, dv1, np.where(field == d2, dv2, -1))

    v_ok = np.where(r1 != 0, dep_val(r1) == rv1, True) & np.where(
        r2 != 0, dep_val(r2) == rv2, True)
    return same_proj & sub & v_ok


def _native_ingest(cfg: Config) -> bool:
    """Whether this run reads through the native fused ingest: whenever no
    option needs the raw tokens, the input is UTF-8 and the library builds
    (a note on stderr says when it does not)."""
    wants_native = (cfg.native_ingest and not cfg.asciify_triples
                    and not cfg.prefix_paths and not cfg.only_read
                    and reader.is_utf8(cfg.encoding))
    use_native = wants_native and native.available()
    if wants_native and not use_native:
        print(f"note: native ingest unavailable "
              f"({native.unavailable_reason()}); using the Python ingest",
              file=sys.stderr)
    return use_native


def _ingest(cfg: Config, use_native: bool, phases: _Phases, counters: dict,
            stats: dict):
    """(ids, dictionary), or None after an --only-read report.
    counters["ingest-path"] says which ingest ran."""
    counters["ingest-path"] = "native" if use_native else "python"
    if use_native:
        paths, is_nq = _resolve_inputs(cfg)
        ingest_stats: dict = {}
        ids, dictionary = phases.run(
            "read+parse", lambda: native.ingest_files(
                paths, tabs=cfg.tabs, expect_quad=is_nq, stats=ingest_stats))
        metrics.struct_set(stats, "ingest", ingest_stats)
        _ingest_counters(counters, ingest_stats)
        counters["input-triples"] = ids.shape[0]
        phases.timings["intern"] = 0.0  # folded into the native pass
    else:
        raw = load_triples(cfg, phases, counters)
        if cfg.only_read:
            return None
        ids, dictionary = phases.run(
            "intern", lambda: intern_triples(np.asarray(raw, dtype=object)))
        del raw
    if cfg.distinct_triples:
        ids = phases.run("distinct", lambda: np.unique(ids, axis=0))
        counters["distinct-triples"] = ids.shape[0]
    return ids, dictionary


def _checkpoint_payloads(cfg: Config, use_native: bool):
    """(ingest_payload, discover_payload): everything feeding each stage, key
    for key the JAX driver's, so both packages fingerprint a run alike."""
    paths, is_nq = _resolve_inputs(cfg)
    ingest_payload = dict(
        inputs=checkpoint.input_signature(paths), is_nq=is_nq, tabs=cfg.tabs,
        asciify=cfg.asciify_triples, encoding=cfg.encoding,
        prefixes=(checkpoint.input_signature(
            reader.resolve_path_patterns(cfg.prefix_paths))
            if cfg.prefix_paths else []),
        distinct=cfg.distinct_triples,
        # The two ingest implementations agree on valid UTF-8 but may differ
        # on degenerate inputs: a checkpoint from one must not satisfy a run
        # asking for the other.
        native=use_native)
    discover_payload = dict(
        ingest=ingest_payload, min_support=cfg.min_support,
        strategy=cfg.traversal_strategy, projections=cfg.projections,
        use_fis=cfg.use_frequent_item_set, use_ars=cfg.use_association_rules,
        clean_implied=cfg.clean_implied)
    if _half_approx_active(cfg):
        # Only knobs that reach the strategy: a no-effect flag must not
        # invalidate an identical-output checkpoint.
        discover_payload.update(explicit_threshold=cfg.explicit_threshold,
                                sbf_bits=cfg.sbf_bits)
    # balanced_11 and the chunk budget are output-neutral: not fingerprinted.
    return ingest_payload, discover_payload


def _checkpoint_fps(cfg: Config, use_native: bool):
    """(ingest_fp, discover_fp): digests of everything feeding each stage."""
    ingest_payload, discover_payload = _checkpoint_payloads(cfg, use_native)
    return (checkpoint.fingerprint(ingest_payload),
            checkpoint.fingerprint(discover_payload))


def _safe_save(ckpt: checkpoint.CheckpointStore, stage: str, fp: str,
               arrays: dict, counters: dict) -> None:
    """A failed checkpoint write never fails an otherwise complete run: it
    only costs the next run its resume (counted and warned, never raised)."""
    try:
        ckpt.save(stage, fp, arrays)
    except Exception as e:
        counters["checkpoint-errors"] = counters.get("checkpoint-errors",
                                                     0) + 1
        print(f"warning: checkpoint stage {stage} not written ({e}); "
              f"the next run will recompute it", file=sys.stderr)


def _ingest_counters(counters: dict, ingest_stats: dict) -> None:
    """Headline native-ingest telemetry -> counters."""
    for k in ("n_threads", "n_units", "triples_per_sec", "bytes_per_sec",
              "queue_stalls"):
        if k in ingest_stats:
            counters[f"ingest-{k.replace('_', '-')}"] = ingest_stats[k]


def _mine_fcs(cfg: Config, ids, dev, counters: dict) -> None:
    """--find-only-fcs: level >= 1 counts the frequent single conditions,
    level >= 2 also the double ones and the association rules."""
    t = allatonce.triples_on(ids, dev)
    n_unary, n_binary = frequency.count_frequent_conditions(
        t, cfg.min_support, include_binary=cfg.find_only_fcs >= 2)
    counters["frequent-single-conditions"] = n_unary
    if n_binary is not None:
        counters["frequent-double-conditions"] = n_binary
        if cfg.use_association_rules and cfg.use_frequent_item_set:
            rules = frequency.mine_association_rules(t, cfg.min_support)
            counters["association-rules"] = len(rules[0])


def skew_from_cfg(cfg: Config):
    """The one cfg -> SkewPolicy mapping (defaults compare equal to
    sharded.DEFAULT_SKEW)."""
    from ..models import sharded
    return sharded.SkewPolicy(
        strategy=cfg.rebalance_strategy,
        factor=sharded.REBALANCE_FACTOR * cfg.rebalance_threshold,
        max_load=cfg.rebalance_max_load)


def _discover_sharded(cfg: Config, ids, mesh, stats: dict, progress):
    """Strategy 0 sharded over the launch's mesh."""
    from ..models import sharded
    if cfg.traversal_strategy != 0:
        raise ValueError(
            f"traversal strategy {cfg.traversal_strategy} is not ported to "
            f"the sharded pipeline yet (ROADMAP.md, queue 1, item 2b); "
            f"--dop > 1 runs strategy 0")
    if cfg.merge_window_size > 0:
        print("note: --merge-window-size only affects the single-device "
              "chunked backend; the sharded run sizes its merge buffers from "
              "measured loads", file=sys.stderr)
    if cfg.explicit_threshold != -1:
        print("note: --explicit-threshold configures the single-device "
              "small-to-large strategy only; sharded runs bound 1/1 memory "
              "via planned capacities + dep-slice passes "
              "(RDFIND_PAIR_ROW_BUDGET)", file=sys.stderr)
    if cfg.balanced_11:
        print("note: --balanced-overlap-candidates is single-device only; "
              "the sharded pair phase splits emission across ranks "
              "(giant-line slicing)", file=sys.stderr)
    use_ars = cfg.use_association_rules and cfg.use_frequent_item_set
    return sharded.discover_sharded(
        ids, cfg.min_support, mesh=mesh, skew=skew_from_cfg(cfg),
        combine=cfg.combinable_join, progress=progress,
        projections=cfg.projections, use_fis=cfg.use_frequent_item_set,
        use_ars=use_ars, clean_implied=cfg.clean_implied, stats=stats)


def _discover(cfg: Config, ids, dev, stats: dict) -> CindTable:
    strategy = STRATEGIES.get(cfg.traversal_strategy)
    if strategy is None:
        raise ValueError(f"unknown traversal strategy {cfg.traversal_strategy} "
                         f"(one of {sorted(STRATEGIES)})")
    try:
        from ..models import sharded
        if (skew_from_cfg(cfg) != sharded.DEFAULT_SKEW
                or not cfg.combinable_join):
            print("note: --rebalance-*/--no-combinable-join only affect "
                  "sharded runs (--dop > 1)", file=sys.stderr)
    except ValueError as e:
        print(f"note: invalid rebalance settings ignored on this "
              f"single-device run; a sharded run (--dop > 1) would reject "
              f"them ({e})", file=sys.stderr)
    kwargs = {}
    if cfg.explicit_threshold != -1:
        if not _half_approx_active(cfg):
            print("note: --explicit-threshold only affects the "
                  "small-to-large strategy (1)", file=sys.stderr)
        else:
            kwargs = dict(explicit_threshold=cfg.explicit_threshold,
                          sbf_bits=cfg.sbf_bits)
    if cfg.balanced_11:
        if cfg.traversal_strategy != 1:
            print("note: --balanced-overlap-candidates only affects the "
                  "small-to-large strategy (1)", file=sys.stderr)
        else:
            kwargs["balanced_11"] = True
    if cfg.merge_window_size > 0:
        # The pair budget of one chunk of the chunked backend.
        kwargs["pair_chunk_budget"] = cfg.merge_window_size
    use_ars = cfg.use_association_rules and cfg.use_frequent_item_set
    return strategy(
        ids, cfg.min_support, projections=cfg.projections,
        use_frequent_condition_filter=cfg.use_frequent_item_set,
        use_association_rules=use_ars, clean_implied=cfg.clean_implied,
        stats=stats, device=dev, **kwargs)


def _mesh():
    return mesh_mod.current()


def _is_primary() -> bool:
    """Global rank 0 (or no launch): writes the run's sinks and reports."""
    m = _mesh()
    return m is None or m.primary


def _is_host_primary() -> bool:
    """A host's local rank 0 (or no launch): writes the host's files."""
    m = _mesh()
    return m is None or m.host_primary


def _sharded(cfg: Config) -> bool:
    return (cfg.n_devices > 1 or cfg.coordinator is not None) \
        and not cfg.delta_base


def run(cfg: Config) -> RunResult:
    """One run: in this process on one device, or, for --dop > 1, on the
    ranks the launcher spawns, under the preemption supervisor."""
    if _sharded(cfg) and _mesh() is None:
        return _run_launched(cfg)
    m = _mesh()
    # A launched rank records its transport at the start of the run.
    transport = ({} if m is None else
                 dict(dist_backend=m.backend, staged=int(m.staged)))
    with _obs_session(cfg):
        with _flush_progress_on_signal(bool(cfg.checkpoint_dir)):
            with tracer.span("run", cat=tracer.CAT_RUN,
                             strategy=cfg.traversal_strategy,
                             n_devices=cfg.n_devices, attempt=cfg.attempt,
                             **transport):
                return _run_profiled(cfg)


def _rank_run(mesh, cfg: Config) -> RunResult:
    """Entry point of one rank of a launched run."""
    out = run(cfg)
    # The parent needs the table and the reports; the triples stay here.
    return dataclasses.replace(out, triples=None)


def _run_launched(cfg: Config) -> RunResult:
    """Spawn the ranks (this host's share of --dop) under the supervisor."""
    from ..parallel import launch
    if cfg.n_devices % max(cfg.num_hosts, 1):
        raise ValueError(f"--dop {cfg.n_devices} does not divide over "
                         f"{cfg.num_hosts} hosts")
    world_local = max(cfg.n_devices // max(cfg.num_hosts, 1), 1)
    device = devices.resolve(cfg.device).type

    def args_for(attempt: int, local: int):
        return (dataclasses.replace(
            cfg, attempt=attempt, n_devices=local * max(cfg.num_hosts, 1)),)

    marker_dirs = [d for d in (os.environ.get("RDFIND_WATCHDOG_DIR"),
                               cfg.trace_dir or os.environ.get("RDFIND_TRACE"))
                   if d]
    return launch.supervise(_rank_run, world_local, args_for=args_for,
                            budget=launch.retry_budget(cfg.retry_on_preempt),
                            device=device, coordinator=cfg.coordinator,
                            num_hosts=cfg.num_hosts,
                            host_index=cfg.host_index,
                            marker_dirs=marker_dirs)


@contextlib.contextmanager
def _flush_progress_on_signal(enabled: bool):
    """SIGTERM/SIGINT flush every live ProgressStore before the process dies
    and, when the flight recorder is armed, dump its ring.  Installed only on
    the main thread and only when there is work to do; the previous handlers
    are restored on exit and re-invoked after the flush."""
    if ((not enabled and not flightrec.enabled())
            or threading.current_thread() is not threading.main_thread()):
        yield
        return
    installed = {}

    def handler(signum, frame):
        flightrec.dump(reason=f"signal {signum}")
        if enabled:
            checkpoint.flush_all_progress()
        signal.signal(signum, installed[signum])
        if signum == signal.SIGINT:
            raise KeyboardInterrupt
        os.kill(os.getpid(), signum)  # re-deliver to the restored handler

    for sig in (signal.SIGTERM, signal.SIGINT):
        try:
            installed[sig] = signal.signal(sig, handler)
        except (ValueError, OSError):
            pass
    try:
        yield
    finally:
        for sig, prev in installed.items():
            try:
                signal.signal(sig, prev)
            except (ValueError, OSError):
                pass


@contextlib.contextmanager
def _obs_session(cfg: Config):
    """Arm the obs layer for one run — span tracing and heartbeat when
    --trace/RDFIND_TRACE names a directory, Prometheus exposition when
    --metrics-file/RDFIND_METRICS_FILE names a file, the live console when
    --console-port/RDFIND_CONSOLE_PORT names a port (0 binds an ephemeral
    port, printed to stderr) — and tear it down, exporting the merged Chrome
    trace, however the run ends.  With no knob set the run pays only the
    disabled-path checks."""
    trace_dir = cfg.trace_dir or os.environ.get("RDFIND_TRACE") or None
    metrics_file = (cfg.metrics_file
                    or os.environ.get("RDFIND_METRICS_FILE") or None)
    console_port = (cfg.console_port if cfg.console_port is not None
                    else console.env_port())
    if not _is_host_primary():
        # Host-level files and the console belong to the host's local rank 0.
        trace_dir = metrics_file = console_port = None
    obs_memory.reset()
    flightrec.configure()  # re-read RDFIND_FLIGHTREC at every run start
    flightrec.reset()
    if metrics_file:
        metrics.set_export(metrics_file)
    if trace_dir:
        tracer.start(trace_dir)
    console_started = False
    if console_port is not None:
        bound = console.start(console_port, obs_dir=trace_dir)
        if bound is None:
            print(f"warning: run console could not bind port {console_port};"
                  f" continuing without it", file=sys.stderr)
        else:
            console_started = True
            print(f"rdfind: run console on http://{console.DEFAULT_HOST}:"
                  f"{bound}/ (/metrics /status /progress /datastats "
                  f"/flightrec)", file=sys.stderr, flush=True)
    try:
        yield
    finally:
        if console_started:
            console.stop()
        if metrics_file:
            try:
                metrics.flush_export()
            finally:
                metrics.set_export(None)
        if trace_dir:
            tracer.stop()
            try:
                if _is_primary():
                    report.export_chrome_trace(trace_dir)
            except OSError as e:
                print(f"warning: trace export failed ({e}); the raw "
                      f"event files remain in {trace_dir}", file=sys.stderr)


PROFILE_FILE = "profile.json"


def _run_profiled(cfg: Config) -> RunResult:
    """--profile-dir: the whole run under torch.profiler (host activity, and
    the card's when the run computes on one), written as a Chrome trace
    ``profile.json`` into the directory; the tracer's spans appear in it as
    ``record_function`` ranges of the same names."""
    if not cfg.profile_dir or not _is_host_primary():
        return _run(cfg)
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if devices.resolve(cfg.device).type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(cfg.profile_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        out = _run(cfg)
    prof.export_chrome_trace(os.path.join(cfg.profile_dir, PROFILE_FILE))
    return out


def _run(cfg: Config) -> RunResult:
    phases = _Phases()
    counters: dict = {}
    stats: dict = {}
    mesh = _mesh()
    dev = mesh.device if mesh is not None else devices.resolve(cfg.device)

    if cfg.print_plan and _is_primary():
        print(json.dumps(describe_plan(cfg), indent=2))
    if cfg.delta_base:
        # Incremental discovery: the change batch replays against the
        # persisted base bundle host-side; a full fallback discovers on the
        # run's device.  It emits through the same sinks as a full run.
        return delta.run_delta(cfg, phases, counters, stats, dev)
    tracer.set_status(mode="full")

    use_native = _native_ingest(cfg)
    ckpt = ingest_fp = discover_fp = progress = None
    if cfg.checkpoint_dir and not cfg.only_read:
        ckpt = checkpoint.CheckpointStore(cfg.checkpoint_dir)
        ingest_fp, discover_fp = _checkpoint_fps(cfg, use_native)
        if mesh is not None:
            # Mid-discover per-pass snapshots (sharded runs): a preempted
            # discover resumes from its last committed pass.
            progress = checkpoint.ProgressStore(
                ckpt, discover_fp, writer=_is_host_primary())

    ingested = None
    if ckpt is not None:
        stored = ckpt.load("ingest", ingest_fp)
        if stored is not None:
            ingested = phases.run(
                "resume-ingest", lambda: checkpoint.decode_ingest(stored))
            counters["input-triples"] = int(stored["input_triples"])
            if "distinct_triples" in stored:
                counters["distinct-triples"] = int(stored["distinct_triples"])
            counters["resumed-ingest"] = 1
    if ingested is None:
        ingested = _ingest(cfg, use_native, phases, counters, stats)
        if ingested is None:  # --only-read
            _report(cfg, counters, phases.timings)
            return RunResult(CindTable.empty(), None, None, counters,
                             phases.timings)
        if ckpt is not None:
            def save_ingest():
                arrays = checkpoint.encode_ingest(*ingested)
                # Counter state rides along so resumed runs report alike.
                arrays["input_triples"] = np.int64(counters["input-triples"])
                if "distinct-triples" in counters:
                    arrays["distinct_triples"] = np.int64(
                        counters["distinct-triples"])
                _safe_save(ckpt, "ingest", ingest_fp, arrays, counters)
            if _is_host_primary():
                phases.run("checkpoint-ingest", save_ingest)
    ids, dictionary = ingested
    counters["distinct-values"] = len(dictionary)

    if cfg.create_join_histogram:
        # An extra pass over the unfiltered join, before the --do-only-join
        # return, as in the reference.
        def histogram():
            hist = _join_histogram(ids, cfg.projections, dev)
            if _is_primary():
                for size, times in hist:
                    print(f"Join size {size} encountered {times}x")
        phases.run("join-histogram", histogram)

    if cfg.only_join:
        _report(cfg, counters, phases.timings)
        return RunResult(CindTable.empty(), dictionary, ids, counters,
                         phases.timings)

    if cfg.find_only_fcs >= 1:
        phases.run("frequent-conditions",
                   lambda: _mine_fcs(cfg, ids, dev, counters))
        _report(cfg, counters, phases.timings)
        return RunResult(CindTable.empty(), dictionary, ids, counters,
                         phases.timings)

    if cfg.use_association_rules and not cfg.use_frequent_item_set:
        # Association rules are mined from the frequent-item sets.
        print("note: --use-ars has no effect without --use-fis "
              "(association rules are mined from the frequent-item sets)",
              file=sys.stderr)
    # Per-host stage file when several hosts may share a checkpoint dir.
    discover_stage = ("discover" if mesh is None or mesh.num_hosts == 1
                      else f"discover-host{mesh.host_index}")
    table = None
    if ckpt is not None:
        stored = ckpt.load(discover_stage, discover_fp)
        # Discovery is collective: resume only when every rank hit, or the
        # misses would enter the collectives alone.
        if _all_ranks_agree(stored is not None):
            table = phases.run("resume-discover",
                               lambda: checkpoint.decode_cinds(stored))
            metrics.restore(stats, checkpoint.decode_stats(stored))
            counters["resumed-discover"] = 1
    if table is None:
        if mesh is not None:
            table = phases.run("discover", lambda: _discover_sharded(
                cfg, ids, mesh, stats, progress))
        else:
            table = phases.run("discover",
                               lambda: _discover(cfg, ids, dev, stats))
        if ckpt is not None and _is_host_primary():
            def save_discover():
                arrays = checkpoint.encode_cinds(table)
                arrays.update(checkpoint.encode_stats(stats))
                _safe_save(ckpt, discover_stage, discover_fp, arrays,
                           counters)
                if progress is not None:
                    progress.cleanup()  # the stage supersedes the passes
            phases.run("checkpoint-discover", save_discover)
    counters["cind-counter"] = len(table)
    if cfg.attempt:
        # A supervisor re-entry: the parent relaunched this attempt.
        counters["supervisor-attempts"] = cfg.attempt
        metrics.counter_add(None, "preempt_supervisor_retries", cfg.attempt)
        metrics.struct_update(None, "elastic_resume",
                              supervisor_attempts=cfg.attempt)
    if not _is_primary():
        # The run's sinks and reports belong to global rank 0.
        return RunResult(table, dictionary, ids, counters, phases.timings)
    base_meta: dict = {}
    if cfg.delta_state:
        # Persist the base bundle (generation 0) the incremental runs load.
        base_meta = phases.run("delta-state", lambda: delta.write_base_bundle(
            cfg, ids, dictionary, table, stats, phases.timings, dev))
    if cfg.delta_state or serving.env_index_dir():
        # The servable artifact: the generation-0 index next to the bundle
        # (and/or into RDFIND_SERVE_INDEX).  The bundle's commit stamp and
        # batch identity ride into the index meta (None values are dropped).
        phases.run("serve-index", lambda: serving.emit_index(
            [cfg.delta_state] if cfg.delta_state else [],
            dictionary, table, generation=0, base_output_digest=None,
            strategy=cfg.traversal_strategy, min_support=cfg.min_support,
            stats=stats,
            extra={"bundle_commit_unix": base_meta.get("commit_unix"),
                   "batch": base_meta.get("batch")}))
    counters.update({f"stat-{k}": v for k, v in stats.items()})
    _emit_sinks(cfg, phases, counters, table, dictionary, stats, ids, dev)
    _report(cfg, counters, phases.timings)
    return RunResult(table, dictionary, ids, counters, phases.timings)


def _all_ranks_agree(flag: bool) -> bool:
    """True iff `flag` is True on every rank of the launch (one tiny
    all-reduce, deadman-armed); the flag itself outside a launch."""
    from . import watchdog
    m = _mesh()
    if m is None or m.size == 1:
        return flag
    with watchdog.collective("allgather", 8 * m.size):
        return bool(m.pmin(torch.tensor(int(flag), dtype=torch.int64,
                                        device=m.device)))


def _emit_sinks(cfg: Config, phases: _Phases, counters: dict, table,
                dictionary, stats: dict, ids, dev) -> None:
    """Debug reports and every result sink."""
    if cfg.debug_level >= 1:
        for line in report.format_debug_lines(stats):
            print(line, file=sys.stderr)
    if cfg.debug_level >= 1 and len(table):
        fams = table.family_counts()
        print("CIND families: " + ", ".join(
            f"{k[0]}/{k[1]}: {v}" for k, v in fams.items()), file=sys.stderr)
        counters.update({f"cinds-{k}": v for k, v in fams.items()})
    if cfg.debug_level >= 2 and len(table):
        # Trivial CINDs in the output indicate a pipeline bug.
        n_trivial = int(np.count_nonzero(_trivial_cind_mask(table)))
        counters["sanity-trivial-cinds"] = n_trivial
        if n_trivial:
            print(f"SANITY VIOLATION: {n_trivial} trivial CINDs in output",
                  file=sys.stderr)

    if cfg.ar_output_file and not cfg.use_frequent_item_set:
        # Without --use-fis there are no frequent-item sets to mine rules
        # from: write nothing.
        print("note: --ar-output requires --use-fis; no rules written",
              file=sys.stderr)
    if cfg.ar_output_file and cfg.use_frequent_item_set:
        def write_ars():
            mined = stats.get("association_rules")
            if mined is None:
                mined = frequency.mine_association_rules(
                    allatonce.triples_on(ids, dev), cfg.min_support)
            ants, cons, avs, cvs, sups = mined
            counters["association-rules"] = len(ants)
            with open(cfg.ar_output_file, "w") as f:
                for i in range(len(ants)):
                    ant = cc.pretty(int(ants[i]), dictionary.value(int(avs[i])))
                    con = cc.pretty(int(cons[i]), dictionary.value(int(cvs[i])))
                    f.write(f"{ant} -> {con} (support={int(sups[i])},"
                            f"confidence=100.00%)\n")
        phases.run("write-ar-output", write_ars)

    if cfg.output_file:
        phases.run("write-output",
                   lambda: write_output(cfg.output_file, table, dictionary))
    if cfg.collector:
        phases.run("collect-remote",
                   lambda: _send_remote(cfg, table, dictionary, counters))
    if cfg.collect_result or cfg.debug_level >= 3:
        for c in table.decoded(dictionary):
            print(c.pretty())

    if integrity.enabled():
        # Fold the counters into stats["integrity"] and, when a destination
        # (RDFIND_CERT or a live trace dir) is set, write the run certificate:
        # input signature -> stage digests -> output digest.
        summary = integrity.summarize(stats)
        stages = dict(stats.get("integrity_stages") or {})
        stages.setdefault("output", integrity.digest_hex(
            *integrity.digest_table(table)))
        counters["output-digest"] = stages["output"]
        dest = integrity.certificate_path()
        if dest:
            def write_cert():
                from ..obs import sentinel
                paths, _ = _resolve_inputs(cfg)
                if cfg.delete_paths:
                    paths = list(paths) + reader.resolve_path_patterns(
                        cfg.delete_paths)
                extra = {"summary": summary, "n_cinds": len(table)}
                delta_info = stats.get("delta") or {}
                if delta_info.get("base_output_digest"):
                    # Chain the incremental run onto its base: a verifier
                    # walks base_output_digest links back to generation 0.
                    extra["base_output_digest"] = \
                        delta_info["base_output_digest"]
                    extra["generation"] = delta_info.get("new_generation")
                cert = integrity.run_certificate(
                    input_signature=checkpoint.input_signature(paths),
                    stages=stages, output_digest=stages["output"],
                    provenance=sentinel.provenance(), extra=extra)
                integrity.write_certificate(dest, cert)
            phases.run("write-certificate", write_cert)


def _send_remote(cfg: Config, table, dictionary, counters: dict) -> None:
    """Stream the CINDs to the --collector sink.  A dead collector never
    fails an otherwise complete run: the results are already computed (and
    perhaps written to --output); it is counted in collector-errors."""
    from .collector import RemoteSink
    try:
        # Only the sink's construction is shielded (ValueError: a malformed
        # host:port), so a decoding bug in the results still fails loudly.
        sink = RemoteSink(cfg.collector)
    except (OSError, ValueError) as e:
        counters["collector-errors"] = 1
        print(f"warning: remote collector {cfg.collector} unreachable ({e}); "
              f"results NOT streamed", file=sys.stderr)
        return
    try:
        with sink:
            for c in table.decoded(dictionary):
                sink.send_cind(c.pretty())
    except OSError as e:  # stream dropped mid-send
        counters["collector-errors"] = 1
        print(f"warning: remote collector {cfg.collector} dropped the stream "
              f"({e}); results may be truncated", file=sys.stderr)


def _report(cfg: Config, counters: dict, timings: dict) -> None:
    """Post-run statistics: the counter lines, the timing lines and the CSV
    line (global rank 0 only)."""
    if not _is_primary():
        return
    try:
        import resource
        counters["peak-rss-mb"] = (
            resource.getrusage(resource.RUSAGE_SELF).ru_maxrss // 1024)
    except Exception:
        pass
    if cfg.counter_level >= 1:
        for line in report.format_counter_lines(counters):
            print(line, file=sys.stderr)
    if cfg.debug_level >= 1 or cfg.counter_level >= 1:
        for line in report.format_timing_lines(timings, counters):
            print(line, file=sys.stderr)
