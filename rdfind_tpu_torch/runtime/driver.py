"""The RDFind job driver of the port: read -> parse -> intern -> discover -> sink.

The JAX package's single-device driver: native fused ingest (``io/native.py``) by
default, the Python ingest with ``--tabs``, ``--asciify-triples``, ``--prefixes``
and per-file encodings, ``--distinct-triples``, the early stops (``--only-read``,
``--do-only-join``, ``--find-only-fcs``), the join-size histogram, the four
strategies on one device, and the sinks and reports in the JAX package's formats
(sorted ``Cind.pretty()`` output lines, association-rule lines, ``--counters`` and
timing lines, ``--print-plan`` JSON).  The sharded path, the runtime planes
(checkpoints, supervisor, collector, certificates, delta, tracing) are not here.
"""

from __future__ import annotations

import dataclasses
import json
import sys
import time

import numpy as np
import torch

from .. import conditions as cc
from .. import devices
from ..data import CindTable
from ..dictionary import Dictionary, intern_triples
from ..io import native, ntriples, prefixes, reader
from ..models import allatonce, approximate, late_bb, small_to_large
from ..obs import metrics, report
from ..ops import frequency, segments
from ..ops.emission import emit_join_candidates

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
    device: str | None = None  # None: the CUDA card


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
        out = fn()
        self.timings[name] = time.perf_counter() - t0
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
    ``.nq``/``.nq.gz``: the graph term is dropped)."""
    paths = reader.resolve_path_patterns(cfg.input_paths, cfg.file_filter)
    return paths, paths[0].endswith((".nq", ".nq.gz"))


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
    if cfg.collect_result:
        sinks.append("collect-result (stdout)")
    return {
        "strategy": cfg.traversal_strategy,
        "n_devices": 1,
        "backend": "single-device",
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


def _ingest(cfg: Config, phases: _Phases, counters: dict, stats: dict):
    """(ids, dictionary), or None after an --only-read report.  Native fused
    ingest whenever no option needs the raw tokens and the input is UTF-8;
    counters["ingest-path"] says which ran."""
    wants_native = (cfg.native_ingest and not cfg.asciify_triples
                    and not cfg.prefix_paths and not cfg.only_read
                    and reader.is_utf8(cfg.encoding))
    use_native = wants_native and native.available()
    if wants_native and not use_native:
        print(f"note: native ingest unavailable "
              f"({native.unavailable_reason()}); using the Python ingest",
              file=sys.stderr)
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


def _discover(cfg: Config, ids, dev, stats: dict) -> CindTable:
    strategy = STRATEGIES.get(cfg.traversal_strategy)
    if strategy is None:
        raise ValueError(f"unknown traversal strategy {cfg.traversal_strategy} "
                         f"(one of {sorted(STRATEGIES)})")
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


def run(cfg: Config) -> RunResult:
    phases = _Phases()
    counters: dict = {}
    stats: dict = {}
    dev = devices.resolve(cfg.device)

    if cfg.print_plan:
        print(json.dumps(describe_plan(cfg), indent=2))

    ingested = _ingest(cfg, phases, counters, stats)
    if ingested is None:  # --only-read
        _report(cfg, counters, phases.timings)
        return RunResult(CindTable.empty(), None, None, counters,
                         phases.timings)
    ids, dictionary = ingested
    counters["distinct-values"] = len(dictionary)

    if cfg.create_join_histogram:
        # An extra pass over the unfiltered join, before the --do-only-join
        # return, as in the reference.
        def histogram():
            for size, times in _join_histogram(ids, cfg.projections, dev):
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
    table = phases.run("discover", lambda: _discover(cfg, ids, dev, stats))
    counters["cind-counter"] = len(table)
    counters.update({f"stat-{k}": v for k, v in stats.items()})
    _emit_sinks(cfg, phases, counters, table, dictionary, stats, ids, dev)
    _report(cfg, counters, phases.timings)
    return RunResult(table, dictionary, ids, counters, phases.timings)


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
    if cfg.collect_result or cfg.debug_level >= 3:
        for c in table.decoded(dictionary):
            print(c.pretty())


def _report(cfg: Config, counters: dict, timings: dict) -> None:
    """Post-run statistics: the counter lines, the timing lines and the CSV
    line."""
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
