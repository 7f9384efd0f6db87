"""The RDFind CLI of the port: discover CINDs in RDF datasets on an NVIDIA GPU.

The argument surface is the JAX package's CLI, restricted to what the port runs:
the four traversal strategies on one device, small-to-large (1) by default.  Any
other flag is rejected with a message naming it; none is silently ignored.

    python -m rdfind_tpu_torch.programs.rdfind data.nt --support 10 \\
        --output cinds.txt [--traversal-strategy 0|1|2|3] [--device cpu]
"""

from __future__ import annotations

import argparse
import sys

STRATEGIES = (0, 1, 2, 3)
# Flags of the JAX package's CLI whose machinery the port does not have yet,
# rejected with a pointer to the work queue.
UNPORTED = {"--explicit-threshold": "the half-approximate 1/1 round",
            "--sbf-bytes": "the half-approximate 1/1 round"}


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="rdfind-torch",
        description="Discover Conditional Inclusion Dependencies in RDF datasets "
                    "(PyTorch/CUDA port; the four strategies on one device).")
    p.add_argument("inputs", nargs="+", help="input .nt/.nq[.gz] files or globs")
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
    p.add_argument("--balanced-overlap-candidates", action="store_true",
                   dest="balanced_11",
                   help="halve the 1/1 overlap emission via pair ownership "
                        "(strategy 1; runs the chunked backend)")
    p.add_argument("--output", default=None, help="CIND output file")
    p.add_argument("--collect-result", action="store_true",
                   help="print CINDs to stdout")
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
                         f"package yet (ROADMAP.md, queue 1)")
    if unknown:
        parser.error(f"not ported to the PyTorch/CUDA package yet: "
                     f"{' '.join(unknown)} (see ROADMAP.md)")
    if not args.projection or not set(args.projection) <= set("spo"):
        parser.error(f"--projection {args.projection!r} must be a non-empty "
                     f"subset of 'spo'")
    if args.use_ars and not args.use_fis:
        print("note: --use-ars has no effect without --use-fis "
              "(association rules are mined from the frequent-item sets)",
              file=sys.stderr)
    from ..runtime import driver

    cfg = driver.Config(
        input_paths=args.inputs,
        min_support=args.support,
        traversal_strategy=args.traversal_strategy,
        projections=args.projection,
        use_frequent_item_set=args.use_fis,
        use_association_rules=args.use_ars,
        clean_implied=args.clean_implied,
        balanced_11=args.balanced_11,
        output_file=args.output,
        collect_result=args.collect_result,
        device=args.device,
    )
    result = driver.run(cfg)
    if not (cfg.output_file or cfg.collect_result):
        print(f"Detected {len(result.table)} CINDs.")
    return 0


if __name__ == "__main__":
    sys.exit(main())
