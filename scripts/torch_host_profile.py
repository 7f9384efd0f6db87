"""Host-side profile of one discovery run of the PyTorch/CUDA port.

Runs ``rdfind_tpu_torch.discover`` once to warm up, then once more under
cProfile, on the synth headline triples (``generate_triples(200_000, seed=42)``,
support 10), and prints the wall time and the functions with the most host time.
It needs the CUDA card unless ``--device cpu`` is given, and imports nothing of
JAX or of the JAX package.

    python scripts/torch_host_profile.py --strategy 1 --no-fc-filter
    python scripts/torch_host_profile.py --strategy 2 --pair-backend chunked
"""

from __future__ import annotations

import argparse
import cProfile
import io
import os
import pstats
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

import rdfind_tpu_torch  # noqa: E402
from rdfind_tpu_torch.utils import synth  # noqa: E402


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--strategy", type=int, default=1)
    p.add_argument("--pair-backend", default="auto")
    p.add_argument("--no-fc-filter", action="store_true",
                   help="skip the frequent-condition filter (the CLI default)")
    p.add_argument("--triples", type=int, default=200_000)
    p.add_argument("--support", type=int, default=10)
    p.add_argument("--device", default="cuda")
    p.add_argument("--top", type=int, default=20)
    args = p.parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        print("no CUDA device; pass --device cpu", file=sys.stderr)
        return 2
    triples = synth.generate_triples(args.triples, seed=42)
    kw = dict(strategy=args.strategy, device=device,
              pair_backend=args.pair_backend,
              use_frequent_condition_filter=not args.no_fc_filter)

    def run():
        t0 = time.perf_counter()
        stats = {}
        table = rdfind_tpu_torch.discover(triples, args.support, stats=stats,
                                          **kw)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        return time.perf_counter() - t0, len(table), stats

    run()
    prof = cProfile.Profile()
    prof.enable()
    wall, n, stats = run()
    prof.disable()
    out = io.StringIO()
    pstats.Stats(prof, stream=out).sort_stats("tottime").print_stats(args.top)
    print(f"strategy {args.strategy} {kw['pair_backend']} fc_filter="
          f"{not args.no_fc_filter}: wall {wall:.3f} s under cProfile, "
          f"{n} CINDs, {stats.get('n_pair_chunks', 0)} chunks, "
          f"device {torch.cuda.get_device_name(0) if device.type == 'cuda' else 'cpu'}")
    print(out.getvalue())
    return 0


if __name__ == "__main__":
    sys.exit(main())
