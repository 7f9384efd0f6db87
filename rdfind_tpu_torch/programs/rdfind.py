"""The RDFind CLI of the port: discover CINDs in RDF datasets on an NVIDIA GPU.

The argument surface is the JAX package's CLI on one device: the same flags, names,
defaults and messages, small-to-large (1) the default strategy, native fused
ingest the default read path.  The runtime and observability flags
(``--checkpoint-dir``, ``--trace``, ``--metrics-file``, ``--profile-dir``,
``--collector``) work as in the JAX package.  Flags whose behaviour is built in
are accepted for compatibility and noted when set.  Incremental discovery
works as in the JAX package: ``--delta-state DIR`` makes a full run persist its
base bundle and servable index, ``--delta DIR INSERTS --deletes DELETES``
replays a change batch against it (exit 66 when the bundle cannot be trusted),
and ``--console-port`` serves the live run console.  The flags of the sharded
pipeline and the preemption supervisor are rejected with a message naming
them; none is silently ignored.

    python -m rdfind_tpu_torch.programs.rdfind data.nt --support 10 \\
        --output cinds.txt [--traversal-strategy 0|1|2|3] [--device cpu]
"""

from __future__ import annotations

import argparse
import sys

STRATEGIES = (0, 1, 2, 3)
_MESH = "the sharded multi-device pipeline (ROADMAP.md, queue 1, item 2)"
_SUPERVISOR = ("the preemption supervisor, which comes with the sharded "
               "pipeline (ROADMAP.md, queue 1, item 2a)")
# Flags of the JAX package's CLI whose machinery the port does not have yet,
# rejected with a pointer to the work queue.
UNPORTED = {
    "--dop": _MESH, "--coordinator": _MESH, "--num-hosts": _MESH,
    "--host-index": _MESH, "--sharded-ingest": _MESH, "--interning": _MESH,
    "--rebalance-strategy": _MESH, "--rebalance-max-load": _MESH,
    "--rebalance-threshold": _MESH, "--no-combinable-join": _MESH,
    "--retry-on-preempt": _SUPERVISOR,
}
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
                    "(PyTorch/CUDA port; one device).")
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
                        "discover); re-runs with unchanged inputs/flags "
                        "resume from them.  Fault-tolerance knobs ride the "
                        "environment: RDFIND_STRICT=1 fail-fast, "
                        "RDFIND_FAULTS=... deterministic fault injection "
                        "(see README, 'Fault tolerance & resume')")
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                   help="where to run (default cuda; cpu runs the kernels' "
                        "plain PyTorch versions)")
    return p


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
        for flag, bad in (("--only-read", args.only_read),
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
    from ..runtime import delta, driver

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
    if not (cfg.output_file or cfg.collect_result):
        print(f"Detected {len(result.table)} CINDs.")
    return 0


if __name__ == "__main__":
    sys.exit(main())
