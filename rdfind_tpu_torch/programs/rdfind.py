"""The RDFind CLI of the port: discover CINDs in RDF datasets on an NVIDIA GPU.

The argument surface is the JAX package's CLI: the same flags, names,
defaults and messages, small-to-large (1) the default strategy, native fused
ingest the default read path.  The runtime and observability flags
(``--checkpoint-dir``, ``--trace``, ``--metrics-file``, ``--profile-dir``,
``--collector``) work as in the JAX package.  Flags whose behaviour is built in
are accepted for compatibility and noted when set.  Incremental discovery
works as in the JAX package: ``--delta-state DIR`` makes a full run persist its
base bundle and servable index, ``--delta DIR INSERTS --deletes DELETES``
replays a change batch against it (exit 66 when the bundle cannot be trusted),
and ``--console-port`` serves the live run console.  ``--dop N`` runs the strategy
sharded over N ranks (one process each: NCCL on the card, gloo with
``--device cpu``), with the skew-engine flags, ``--no-combinable-join``,
``--coordinator``/``--num-hosts``/``--host-index`` for several hosts and the
preemption supervisor ``--retry-on-preempt``.  ``--sharded-ingest`` makes each
host parse only its own file subset (``--interning`` partitioned or
replicated); no host then holds the whole triple table.

    python -m rdfind_tpu_torch.programs.rdfind data.nt --support 10 \\
        --output cinds.txt [--traversal-strategy 0|1|2|3] [--device cpu]
    python -m rdfind_tpu_torch.programs.rdfind data.nt --support 10 \\
        --dop 4 [--traversal-strategy 0|1|2|3] [--device cpu] \\
        [--retry-on-preempt 2] [--sharded-ingest --interning partitioned]
"""

from __future__ import annotations

import argparse
import sys

STRATEGIES = (0, 1, 2, 3)
# Flags of the JAX package's CLI whose machinery the port does not have yet,
# rejected with a pointer to the work queue: none is left.
UNPORTED: dict = {}
# Accepted for compatibility: behaviour built in or subsumed, noted when set.
_NO_EFFECT = (
    ("no_bulk_merge", "merging is always windowed segment-sum here"),
    ("frequent_condition_strategy",
     "frequency uses exact segment counts; both reference strategies produce "
     "identical verdicts"),
    ("rebalance_split",
     "split lines always fan out to every device in the mesh"),
    ("hash_bytes", "hash dictionary subsumed by exact interning"),
    ("apply_hash", "hash dictionary subsumed by exact interning"),
    ("hash_dictionary", "hash dictionary subsumed by exact interning"),
    ("hash_function", "hash dictionary subsumed by exact interning"),
    ("find_frequent_captures", "exact capture-support pruning is always on"),
    ("rebalance_join",
     "the skew engine is always on for sharded runs; tune it with "
     "--rebalance-threshold/--rebalance-max-load"),
    ("only_read_compat", "use --only-read"),
    ("any_binary_captures",
     "binary condition frequencies are computed exactly in the same pass as "
     "unary ones; there is no pre-pass to skip"))
_NO_EFFECT_DEFAULTS = {"rebalance_split": 1, "frequent_condition_strategy": 0,
                       "hash_bytes": -1, "hash_function": "MD5"}


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="rdfind-torch",
        description="Discover Conditional Inclusion Dependencies in RDF datasets "
                    "(PyTorch/CUDA port).")
    p.add_argument("inputs", nargs="*",
                   help="input .nt/.nq[.gz] files or globs (for --delta "
                        "runs these are the INSERT batch; may be empty for "
                        "a delete-only batch)")
    p.add_argument("--delta", default=None, metavar="BASE_DIR",
                   dest="delta_base",
                   help="incremental run: apply the insert (positional) and "
                        "--deletes batches against the base bundle in "
                        "BASE_DIR (written by a full run with "
                        "--delta-state); output is bit-identical to a "
                        "from-scratch run on the updated dataset, and the "
                        "bundle advances one generation in place")
    p.add_argument("--delta-state", default=None, metavar="DIR",
                   help="full run: persist the delta base bundle (interned "
                        "dictionary + per-bucket join-line rows + per-pass "
                        "digests + the definitional CIND set) into DIR for "
                        "later --delta runs")
    p.add_argument("--deletes", nargs="*", default=[], metavar="FILE",
                   help="delete batch files for a --delta run (same formats "
                        "as the inputs; each line retracts one matching "
                        "triple)")
    p.add_argument("--prefixes", nargs="*", default=[],
                   help="nt-prefix files for URL shortening")
    p.add_argument("--support", type=int, default=10,
                   help="minimum support for CINDs (default 10)")
    p.add_argument("--traversal-strategy", type=int, default=1,
                   choices=STRATEGIES,
                   help="0=all-at-once 1=small-to-large 2=approx 3=late-bb "
                        "(default 1)")
    p.add_argument("--projection", default="spo",
                   help="fields to project captures on (subset of 'spo')")
    p.add_argument("--use-fis", action="store_true",
                   help="mine + use frequent item sets for pruning")
    p.add_argument("--use-ars", action="store_true",
                   help="mine + use association rules (needs --use-fis)")
    p.add_argument("--clean-implied", action="store_true",
                   help="remove implied CINDs (minimality cleanup)")
    p.add_argument("--distinct-triples", action="store_true")
    p.add_argument("--asciify-triples", action="store_true")
    p.add_argument("--tabs", action="store_true", help="tab-separated input")
    p.add_argument("--only-read", action="store_true")
    p.add_argument("--do-only-join", action="store_true", dest="only_join")
    p.add_argument("--output", default=None, help="CIND output file")
    p.add_argument("--ar-output", default=None,
                   help="association-rule output file")
    p.add_argument("--collect-result", action="store_true",
                   help="print CINDs to stdout")
    p.add_argument("--collector", default=None, metavar="HOST:PORT",
                   help="stream CINDs to a remote collector (JSON lines over "
                        "TCP; the reference's RMI result channel)")
    p.add_argument("--debug-level", type=int, default=0,
                   help="1: phase timings; 2: + sanity checks (trivial-CIND "
                        "count); 3: + print every CIND")
    p.add_argument("--print-plan", action="store_true",
                   help="dump the logical plan as JSON before executing")
    p.add_argument("--profile-dir", default=None, metavar="DIR",
                   help="write a torch.profiler trace of the run (host "
                        "operators and, on the card, every kernel with its "
                        "device time) as DIR/profile.json; open in Perfetto "
                        "(ui.perfetto.dev) or chrome://tracing")
    p.add_argument("--trace", default=None, metavar="DIR", dest="trace_dir",
                   help="obs: record host span traces (run/stage/pass/"
                        "dispatch/pull/exchange/checkpoint) + a heartbeat "
                        "file into DIR; a merged Chrome-trace JSON "
                        "(DIR/trace.json, per-host lanes) is written at run "
                        "end — open in Perfetto (ui.perfetto.dev).  Pairs "
                        "with --profile-dir: host spans emit matching "
                        "torch.profiler.record_function ranges")
    p.add_argument("--metrics-file", default=None, metavar="FILE",
                   help="obs: write the metrics registry as Prometheus text "
                        "exposition to FILE (atomically refreshed at every "
                        "stage boundary and at run end)")
    p.add_argument("--console-port", type=int, default=None, metavar="PORT",
                   help="obs: serve the live run console on this port "
                        "(loopback HTTP: /metrics /status /progress "
                        "/datastats /flightrec; 0 binds an ephemeral port, "
                        "printed to stderr; RDFIND_CONSOLE_PORT is the env "
                        "form)")
    p.add_argument("--counters", type=int, default=0, dest="counter_level")
    p.add_argument("--dop", type=int, default=1,
                   help="degree of parallelism = number of ranks in the mesh "
                        "(every strategy; one process per rank: one GPU each "
                        "on the card, gloo processes with --device cpu)")
    p.add_argument("--sharded-ingest", action="store_true",
                   help="each host parses only its file subset and donates "
                        "rows to its own devices (multi-host; no host holds "
                        "the full triple table; all four traversal "
                        "strategies run on the presharded arrays)")
    p.add_argument("--interning", choices=("auto", "partitioned",
                                           "replicated"), default="auto",
                   help="sharded-ingest dictionary mode: partitioned = each "
                        "host stores only its value-hash range (multi-host "
                        "default; decode is a collective), replicated = "
                        "every host holds the union; auto picks partitioned "
                        "when multi-host")
    p.add_argument("--coordinator", default=None, metavar="HOST:PORT",
                   help="multi-host run: the rendezvous store's address on "
                        "host 0 (every host runs the same command with its "
                        "own --host-index)")
    p.add_argument("--num-hosts", type=int, default=1,
                   help="multi-host run: total number of hosts")
    p.add_argument("--host-index", type=int, default=0,
                   help="multi-host run: this host's index in [0, "
                        "num-hosts)")
    p.add_argument("--no-combinable-join", action="store_true",
                   help="plan ablation: ship raw join candidates instead of "
                        "combiner-deduped ones (sharded runs; same output)")
    p.add_argument("--rebalance-strategy", type=int, default=1,
                   choices=(1, 2),
                   help="split-line dependent ownership: 1 = hash-slice, "
                        "2 = contiguous range-slice (sharded runs)")
    p.add_argument("--rebalance-max-load", type=float, default=10000.0 * 10000,
                   help="absolute quadratic load above which a join line "
                        "always splits across ranks (sharded runs)")
    p.add_argument("--rebalance-threshold", type=float, default=1.0,
                   help="scales the average-load factor above which a join "
                        "line splits (sharded runs; default 1.0)")
    p.add_argument("--retry-on-preempt", type=int, default=0, metavar="N",
                   help="preemption supervisor: on a preempted attempt (or "
                        "an escaped fallback request), back off and "
                        "relaunch the ranks up to N times, resuming from "
                        "the progress snapshots of --checkpoint-dir, "
                        "re-sharded when the rank count changed "
                        "(RDFIND_RETRY_ON_PREEMPT is the env form)")
    for flag in ("--find-frequent-captures", "--no-bulk-merge",
                 "--rebalance-join", "--apply-hash",
                 "--hash-dictionary", "--only-read-compat",
                 "--any-binary-captures"):
        p.add_argument(flag, action="store_true", help=argparse.SUPPRESS)
    p.add_argument("--balanced-overlap-candidates", action="store_true",
                   dest="balanced_11",
                   help="halve the 1/1 overlap emission via pair ownership "
                        "(strategy 1; runs the chunked backend)")
    p.add_argument("--merge-window-size", type=int, default=-1,
                   help="pair-merge window: max pairs materialized per chunk "
                        "in the chunked backend (-1 = auto)")
    p.add_argument("--create-join-histogram", action="store_true",
                   help="print a join-line size histogram "
                        "('Join size N encountered Mx')")
    p.add_argument("--find-only-fcs", type=int, default=0,
                   help="1: stop after frequent-condition mining, reporting "
                        "unary counts; 2: also mine binary (double) "
                        "conditions and association rules")
    for flag, dv in (("--rebalance-split", 1), ("--hash-bytes", -1),
                     ("--frequent-condition-strategy", 0)):
        p.add_argument(flag, type=int, default=dv, help=argparse.SUPPRESS)
    p.add_argument("--explicit-threshold", type=int, default=-1,
                   help="half-approximate 1/1 round: max exact per-dependent "
                        "counters (strategy 1, chunked backend; -1 = exact "
                        "overlaps)")
    p.add_argument("--sbf-bytes", type=int, default=-1, dest="sbf_bits",
                   help="bits per spectral (count-min) counter for the "
                        "half-approximate round (-1 = sized to support)")
    p.add_argument("--hash-function", default="MD5", help=argparse.SUPPRESS)
    p.add_argument("--encoding", default="utf-8",
                   help="input charset; 'auto' sniffs a BOM per file "
                        "(default utf-8)")
    p.add_argument("--file-filter", default=None,
                   help="regex on input-file basenames")
    p.add_argument("--no-native-ingest", action="store_true",
                   help="force the pure-Python ingest path")
    p.add_argument("--checkpoint-dir", default=None,
                   help="directory for stage-boundary checkpoints (ingest and "
                        "discover) and, on sharded runs, per-pass progress "
                        "snapshots; re-runs with unchanged inputs/flags "
                        "resume from them (a preempted sharded discover "
                        "replays only its unfinished passes).  "
                        "Fault-tolerance knobs ride the "
                        "environment: RDFIND_STRICT=1 fail-fast, "
                        "RDFIND_FAULTS=... deterministic fault injection "
                        "(see README, 'Fault tolerance & resume')")
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                   help="where to run (default cuda; cpu runs the kernels' "
                        "plain PyTorch versions)")
    return p


def _local_ranks(device: str) -> int:
    """Ranks one host runs by default: one per GPU (one on the CPU)."""
    if device == "cpu":
        return 1
    import torch
    return max(torch.cuda.device_count(), 1)


def main(argv=None) -> int:
    parser = build_parser()
    args, unknown = parser.parse_known_args(argv)
    for flag, what in UNPORTED.items():
        if any(u == flag or u.startswith(flag + "=") for u in unknown):
            parser.error(f"{flag} ({what}) is not ported to the PyTorch/CUDA "
                         f"package yet")
    if unknown:
        parser.error(f"not ported to the PyTorch/CUDA package yet: "
                     f"{' '.join(unknown)} (see ROADMAP.md)")
    if not args.projection or not set(args.projection) <= set("spo"):
        parser.error(f"--projection {args.projection!r} must be a non-empty "
                     f"subset of 'spo'")
    if args.deletes and not args.delta_base:
        parser.error("--deletes only applies to incremental runs; pass "
                     "--delta BASE_DIR")
    if not args.inputs and not (args.delta_base and args.deletes):
        parser.error("no input files (positional inputs may only be empty "
                     "for a delete-only --delta run with --deletes)")
    if args.delta_base:
        for flag, bad in (("--sharded-ingest", args.sharded_ingest),
                          ("--only-read", args.only_read),
                          ("--do-only-join", args.only_join),
                          ("--find-only-fcs", args.find_only_fcs),
                          ("--checkpoint-dir", args.checkpoint_dir)):
            if bad:
                parser.error(f"{flag} is not supported with --delta "
                             f"(the delta engine replays host-side against "
                             f"the base bundle)")
        if args.delta_state:
            print("note: --delta-state is ignored with --delta (the run "
                  "advances the base bundle in place)", file=sys.stderr)
            args.delta_state = None
    if args.coordinator is None and (args.num_hosts != 1
                                     or args.host_index != 0):
        parser.error("--num-hosts/--host-index require --coordinator "
                     "(without it this would run a full independent "
                     "single-host job)")
    if args.coordinator is not None:
        if not 0 <= args.host_index < args.num_hosts:
            parser.error(f"--host-index {args.host_index} is outside [0, "
                         f"{args.num_hosts})")
        if args.dop == 1:
            args.dop = args.num_hosts * _local_ranks(args.device)
        if args.dop % args.num_hosts:
            parser.error(f"--dop {args.dop} does not divide over "
                         f"{args.num_hosts} hosts")
    if args.dop < 1:
        parser.error(f"--dop must be >= 1, got {args.dop}")
    if args.dop > 1 and args.delta_base:
        parser.error("--dop is not supported with --delta (the delta engine "
                     "replays host-side against the base bundle)")
    from ..parallel import launch
    from ..runtime import delta, driver, faults

    cfg = driver.Config(
        input_paths=args.inputs,
        prefix_paths=args.prefixes,
        min_support=args.support,
        traversal_strategy=args.traversal_strategy,
        projections=args.projection,
        use_frequent_item_set=args.use_fis,
        use_association_rules=args.use_ars,
        clean_implied=args.clean_implied,
        distinct_triples=args.distinct_triples,
        asciify_triples=args.asciify_triples,
        tabs=args.tabs,
        only_read=args.only_read,
        only_join=args.only_join,
        output_file=args.output,
        ar_output_file=args.ar_output,
        collect_result=args.collect_result,
        debug_level=args.debug_level,
        counter_level=args.counter_level,
        native_ingest=not args.no_native_ingest,
        explicit_threshold=args.explicit_threshold,
        sbf_bits=args.sbf_bits,
        balanced_11=args.balanced_11,
        print_plan=args.print_plan,
        encoding=args.encoding,
        file_filter=args.file_filter,
        merge_window_size=args.merge_window_size,
        find_only_fcs=args.find_only_fcs,
        create_join_histogram=args.create_join_histogram,
        checkpoint_dir=args.checkpoint_dir,
        profile_dir=args.profile_dir,
        collector=args.collector,
        trace_dir=args.trace_dir,
        metrics_file=args.metrics_file,
        console_port=args.console_port,
        delta_base=args.delta_base,
        delta_state=args.delta_state,
        delete_paths=args.deletes,
        device=args.device,
        n_devices=args.dop,
        retry_on_preempt=args.retry_on_preempt,
        rebalance_strategy=args.rebalance_strategy,
        rebalance_threshold=args.rebalance_threshold,
        rebalance_max_load=args.rebalance_max_load,
        combinable_join=not args.no_combinable_join,
        sharded_ingest=args.sharded_ingest,
        interning=args.interning,
        coordinator=args.coordinator,
        num_hosts=args.num_hosts,
        host_index=args.host_index,
    )
    for name, why in _NO_EFFECT:
        v = getattr(args, name)
        if v not in (_NO_EFFECT_DEFAULTS.get(name, False), None):
            print(f"note: --{name.replace('_', '-')} has no effect ({why})",
                  file=sys.stderr)
    try:
        result = driver.run(cfg)
    except delta.DeltaBaseError as e:
        # A clean miss, never a wrong incremental answer: name the failure
        # and tell the caller how to rebuild.
        print(f"rdfind: delta base unusable ({e}); re-run a full build "
              f"with --delta-state to rebuild the bundle", file=sys.stderr)
        return 66  # EX_NOINPUT: the base bundle cannot serve this run
    except faults.Preempted as e:
        # In-flight progress was flushed before the ranks exited; the same
        # command resumes the run.
        print(f"rdfind: preempted ({e}); re-run with the same "
              f"--checkpoint-dir to resume from the last committed pass "
              f"(or pass --retry-on-preempt N to let the launcher retry)",
              file=sys.stderr)
        return 75  # EX_TEMPFAIL: transient, retry the same invocation
    except launch.RankFailed as e:
        print(f"rdfind: {e}", file=sys.stderr)
        return 1
    if not (cfg.output_file or cfg.collect_result):
        print(f"Detected {len(result.table)} CINDs.")
    return 0


if __name__ == "__main__":
    sys.exit(main())
