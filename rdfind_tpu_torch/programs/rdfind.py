"""The RDFind CLI of the port: discover CINDs in RDF datasets on an NVIDIA GPU.

The argument surface is the JAX package's CLI, restricted to what the port runs:
strategies 0, 2 and 3 on one device.  Any other flag or strategy is rejected with
a message naming it; none is silently ignored.

    python -m rdfind_tpu_torch.programs.rdfind data.nt --traversal-strategy 2 \\
        --support 10 --output cinds.txt [--device cpu]
"""

from __future__ import annotations

import argparse
import sys

PORTED_STRATEGIES = (0, 2, 3)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="rdfind-torch",
        description="Discover Conditional Inclusion Dependencies in RDF datasets "
                    "(PyTorch/CUDA port; strategies 0, 2 and 3 on one device).")
    p.add_argument("inputs", nargs="+", help="input .nt/.nq[.gz] files or globs")
    p.add_argument("--support", type=int, default=10,
                   help="minimum support for CINDs (default 10)")
    p.add_argument("--traversal-strategy", type=int, default=1,
                   help="0=all-at-once, 2=approximate all-at-once, "
                        "3=late-BB (1, the default, is not ported yet and is "
                        "rejected)")
    p.add_argument("--projection", default="spo",
                   help="fields to project captures on (subset of 'spo')")
    p.add_argument("--use-fis", action="store_true",
                   help="mine + use frequent item sets for pruning")
    p.add_argument("--use-ars", action="store_true",
                   help="mine + use association rules (needs --use-fis)")
    p.add_argument("--clean-implied", action="store_true",
                   help="remove implied CINDs (minimality cleanup)")
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
    if unknown:
        parser.error(f"not ported to the PyTorch/CUDA package yet: "
                     f"{' '.join(unknown)} (see ROADMAP.md)")
    if args.traversal_strategy not in PORTED_STRATEGIES:
        parser.error(f"--traversal-strategy {args.traversal_strategy} is not "
                     f"ported yet; pass --traversal-strategy 0, 2 or 3 "
                     f"(see ROADMAP.md)")
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
