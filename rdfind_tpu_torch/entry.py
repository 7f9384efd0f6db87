"""Entry points: the fused single-device step and a multi-rank dry run.

entry(device)        -> (fn, example_args): ``allatonce.fused_step`` on the
                        flagship AllAtOnce configuration, with device tensors;
                        ``fn(*example_args)`` runs it.
dryrun_multichip(n)  -> one launch of n gloo CPU ranks running every sharded
                        strategy on a small workload with a hot join value,
                        each held against the definitional oracle or the
                        single-device strategy.

``python -m rdfind_tpu_torch.entry`` runs ``entry()`` on the card and prints
its CIND count (``--device cpu`` on the CPU).
"""

from __future__ import annotations

import argparse
import functools
import os

import numpy as np
import torch

from . import devices
from .utils import synth

# The flagship configuration of the step.
ENTRY_TRIPLES = 512
ENTRY_SEED = 7
ENTRY_SUPPORT = 2
ENTRY_PAIR_CAPACITY = 1 << 17
DRYRUN_SUPPORT = 2
# Pair rows per rank and pass of the dry run's strategy-0 check: small enough
# that it streams in several passes.
DRYRUN_PAIR_ROW_BUDGET = "64"


def entry(device=None):
    """(fn, example_args) of the fused single-device step on the flagship
    configuration: 512 generated triples (seed 7), support 2, every
    projection, the frequent-condition filter on, 2^17 pair slots."""
    from .models.allatonce import fused_step

    dev = devices.resolve(device)
    triples = torch.as_tensor(synth.generate_triples(ENTRY_TRIPLES,
                                                     seed=ENTRY_SEED),
                              device=dev)
    fn = functools.partial(fused_step, projections="spo", use_fc_filter=True,
                           pair_capacity=ENTRY_PAIR_CAPACITY)
    example_args = (triples, torch.tensor(ENTRY_TRIPLES, device=dev),
                    torch.tensor(ENTRY_SUPPORT, device=dev))
    return fn, example_args


def dryrun_triples() -> np.ndarray:
    """200 generated triples with a hot object value grafted on (40 triples
    share it), so the sharded skew engine splits a giant line."""
    triples = synth.generate_triples(200, seed=3, n_predicates=6,
                                     n_entities=24)
    hot = np.stack([np.arange(100, 140, dtype=np.int32),
                    np.arange(40, dtype=np.int32) % 4 + 500,
                    np.full(40, 999, dtype=np.int32)], axis=1)
    return np.concatenate([np.asarray(triples, np.int32), hot])


def dryrun_rank(mesh, triples):
    """Every rank's part of the dry run: strategy 0 streamed in several
    passes, sharded minimality, SmallToLarge with the distributed frequency
    filter, Approximate and LateBB.  Returns {check: CIND rows} plus
    strategy 0's pass count."""
    from .models import sharded
    from .ops import minimality

    prev = os.environ.get("RDFIND_PAIR_ROW_BUDGET")
    os.environ["RDFIND_PAIR_ROW_BUDGET"] = DRYRUN_PAIR_ROW_BUDGET
    stats: dict = {}
    try:
        table = sharded.discover_sharded(triples, DRYRUN_SUPPORT, mesh=mesh,
                                         stats=stats)
    finally:
        if prev is None:
            os.environ.pop("RDFIND_PAIR_ROW_BUDGET", None)
        else:
            os.environ["RDFIND_PAIR_ROW_BUDGET"] = prev
    return dict(
        allatonce=table.to_rows(), n_pair_passes=stats.get("n_pair_passes", 1),
        minimized=minimality.minimize_table_sharded(table, mesh).to_rows(),
        s2l=sharded.discover_sharded_s2l(triples, DRYRUN_SUPPORT, mesh=mesh,
                                         use_fis=True).to_rows(),
        approx=sharded.discover_sharded_approx(triples, DRYRUN_SUPPORT,
                                               mesh=mesh).to_rows(),
        late_bb=sharded.discover_sharded_late_bb(triples, DRYRUN_SUPPORT,
                                                 mesh=mesh).to_rows())


def check_dryrun(triples, got: dict) -> None:
    """Raise AssertionError unless a dry run's results hold: more than one
    strategy-0 pass, strategy 0 and Approximate equal to the definitional
    oracle, the minimized table to the oracle's minimal set, SmallToLarge and
    LateBB to their single-device runs on the CPU."""
    from . import oracle
    from .models import late_bb, small_to_large

    assert got["n_pair_passes"] > 1, \
        f"dryrun expected multi-pass streaming (budget " \
        f"{DRYRUN_PAIR_ROW_BUDGET} rows), got {got['n_pair_passes']} pass"
    want = {tuple(int(x) for x in c) for c in
            oracle.discover_cinds_definitional(
                [tuple(int(x) for x in row) for row in triples],
                DRYRUN_SUPPORT)}
    assert got["allatonce"] == want, (
        f"sharded result mismatch: {len(got['allatonce'])} vs {len(want)} "
        f"CINDs")
    assert got["minimized"] == oracle.minimize_cinds(want), \
        "sharded minimality mismatch"
    assert got["s2l"] == small_to_large.discover(
        triples, DRYRUN_SUPPORT, device="cpu").to_rows(), "sharded S2L mismatch"
    assert got["approx"] == want, "sharded approximate mismatch"
    assert got["late_bb"] == late_bb.discover(
        triples, DRYRUN_SUPPORT, device="cpu").to_rows(), \
        "sharded late-BB mismatch"


def dryrun_multichip(n_devices: int) -> dict:
    """Run the dry run on one launch of `n_devices` gloo CPU ranks, check it
    and return rank 0's results."""
    from .parallel import launch

    triples = dryrun_triples()
    got = launch.spawn(dryrun_rank, int(n_devices), args=(triples,),
                       device="cpu")
    check_dryrun(triples, got)
    print(f"dryrun_multichip({n_devices}): OK - {len(got['allatonce'])} "
          f"CINDs (allatonce+approx), {len(got['s2l'])} raw (s2l), "
          f"{len(got['late_bb'])} raw (late-bb) on {n_devices} ranks")
    return got


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m rdfind_tpu_torch.entry")
    ap.add_argument("--device", default=None,
                    help="device of the step (default: the CUDA card)")
    args = ap.parse_args(argv)
    fn, example_args = entry(args.device)
    out = fn(*example_args)
    print(f"entry(): OK - {int(out[-2])} CINDs, overflow {int(out[-1])}, on "
          f"{example_args[0].device}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
