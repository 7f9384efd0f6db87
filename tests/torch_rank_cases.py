"""Rank-side halves of the port's multi-rank CPU tests.

The launcher spawns fresh processes that import a rank function by name; this
module imports only torch and the port (never JAX), so the ranks start fast and
never touch the JAX package.  Each function runs a batch of cases on one launch,
so a test module spawns few process groups.
"""

import os

import numpy as np
import torch


def _block(a, mesh):
    from rdfind_tpu_torch.parallel.mesh import shard_rows
    return torch.as_tensor(np.ascontiguousarray(shard_rows(a, mesh)))


def _gather(mesh, x):
    """This rank's array -> every rank's, concatenated in rank order."""
    t = torch.as_tensor(np.asarray(x))
    if t.dtype == torch.bool:
        return mesh.all_gather(t.to(torch.int32)).reshape(-1).numpy() == 1
    return mesh.all_gather(t).reshape(-1).numpy()


def exchange_cases(mesh, data):
    """Every exchange primitive on this rank's block of `data` (the same
    inputs the JAX side shards over its devices), on both wires: the trimmed
    one a gloo mesh sends, and NCCL's fixed-shape one (keys "fixed/...").
    Per-rank outputs come back concatenated in rank order, as a P(AXIS)
    output of shard_map does."""
    out = {}
    for prefix, trim in (("", True), ("fixed/", False)):
        mesh.trim_wire = trim
        out.update({prefix + k: v
                    for k, v in _exchange_cases(mesh, data).items()})
    return out


def _exchange_cases(mesh, data):
    from rdfind_tpu_torch.ops import hashing
    from rdfind_tpu_torch.parallel import exchange

    a, b, w = (_block(data[k], mesh) for k in ("a", "b", "w"))
    valid = _block(data["valid"], mesh)
    d = mesh.size
    bucket = hashing.bucket_of([a], d, seed=3)
    out = {}
    for name, cap, hier in (("flat", 32, None), ("flat_tight", 8, None),
                            ("hier", 32, (2, 2)), ("hier_tight", 8, (2, 2))):
        cols, ov, ovf, st = exchange.route([a, b], valid, bucket, mesh, cap,
                                           hier=hier)
        answer = torch.where(ov, cols[0] * 3 + cols[1], 0)
        back = exchange.route_reply(answer, st, mesh)
        out[f"route_{name}"] = [cols[0].numpy(), cols[1].numpy(),
                                ov.numpy(), int(ovf), back.numpy()]
        counts, c_ovf = exchange.global_row_counts(
            [a], valid, mesh, cap, seed=5, hier=hier, dcn_capacity=cap)
        out[f"counts_{name}"] = [counts.numpy(), int(c_ovf)]
    for name, cap, dcap in (("roomy", 32, 32), ("tight", 32, 8)):
        cols, cw, ov, (o1, o2), st = exchange.route_combined(
            [a], w, valid, bucket, mesh, cap, dcap, (2, 2))
        back = exchange.route_combined_reply(
            torch.where(ov, cols[0] + cw, 0), st, mesh)
        out[f"combined_{name}"] = [cols[0].numpy(), cw.numpy(), ov.numpy(),
                                   int(o1), int(o2), back.numpy()]
    n_freq, f_ovf = exchange.global_distinct_frequent(
        [a], valid, 3, mesh, 32, seed=5)
    out["distinct_frequent"] = [int(n_freq), int(f_ovf)]
    table = (b[:16] % 7).to(torch.int32)
    out["sketch_allreduce"] = [
        exchange.sketch_allreduce(table, mesh, cap=9).numpy(),
        exchange.sketch_allreduce(table, mesh, cap=9, hier=(2, 2)).numpy()]
    return {k: [_gather(mesh, x) if isinstance(x, np.ndarray) else x
                for x in v] for k, v in out.items()}


# The statistics a case reports: the plan and skew of strategy 0's cases, the
# sketch, lattice, round and half-approximate statistics of strategies 1-3.
SUMMARY_STATS = (
    "planned_caps", "n_giant_lines", "n_giant_pairs", "n_pair_passes",
    "rebalance", "dist_backend", "staged", "n_captures", "n_sketch_candidates",
    "sketch_plan", "n_round1_cinds", "n_round2_cinds", "n_cinds_11",
    "n_proper_overlaps", "n_cinds_12", "n_cinds_21", "n_inferred_21",
    "n_cinds_22", "pairs_11", "pairs_12", "pairs_21", "pairs_22",
    "pairs_verify", "pairs_round1", "pairs_round2", "total_pairs",
    "ha_cut_pairs", "ha_build_rounds", "ha_sketch_bits", "degradations")


def _table_summary(table, stats):
    from rdfind_tpu_torch.obs import integrity
    keep = SUMMARY_STATS
    sites = stats.get("exchange_sites", {})
    return dict(rows=table.to_rows(),
                digest=integrity.digest_hex(*integrity.digest_table(table)),
                stats={k: stats[k] for k in keep if k in stats},
                ledger={k: v["bytes"] for k, v in sites.items()},
                ledger_split={k: (v.get("ici_bytes"), v.get("dcn_bytes"))
                              for k, v in sites.items()})


def sharded_cases(mesh, cases):
    """The sharded strategy kwargs["strategy"] (default 0: discover_sharded)
    on each (name, triples, support, kwargs, env) case; `env` is set around
    the case.  A case with kwargs {"dryrun": True} runs
    ``entry.dryrun_rank`` instead.  Returns {name: summary}."""
    from rdfind_tpu_torch.models import sharded
    from rdfind_tpu_torch.ops import minimality
    from rdfind_tpu_torch.runtime import faults

    out = {}
    for name, triples, support, kwargs, env in cases:
        kwargs = dict(kwargs)
        if kwargs.pop("dryrun", False):
            # entry.dryrun_multichip's rank side (its own strategies and
            # support).
            from rdfind_tpu_torch import entry
            out[name] = entry.dryrun_rank(mesh, triples)
            continue
        minimize = kwargs.pop("minimize", False)
        discover = sharded.STRATEGIES[kwargs.pop("strategy", 0)]
        saved = {k: os.environ.get(k) for k in env}
        os.environ.update(env)
        try:
            stats = {}
            if "skew" in kwargs:
                kwargs["skew"] = sharded.SkewPolicy(**kwargs["skew"])
            faults.reset()
            table = discover(triples, support, mesh=mesh, stats=stats,
                             **kwargs)
            out[name] = _table_summary(table, stats)
            if minimize:
                out[name]["minimized"] = minimality.minimize_table_sharded(
                    table, mesh).to_rows()
        finally:
            for k, v in saved.items():
                if v is None:
                    os.environ.pop(k, None)
                else:
                    os.environ[k] = v
    return out


def preshard_cases(mesh, triples, support):
    """The preshard stages and the four strategies over this rank's block of
    `triples` (the contiguous split a one-host sharded ingest makes).
    Returns the results of every stage, host-side."""
    from rdfind_tpu_torch.models import sharded

    padded, n_valid, t_loc = sharded._shard_triples(triples, mesh.size)
    block = torch.as_tensor(padded[mesh.rank * t_loc:(mesh.rank + 1) * t_loc])
    g = (block, int(n_valid[mesh.rank]))
    dup = np.concatenate([triples, triples[: len(triples) // 2]])
    padded, n_valid, t_loc = sharded._shard_triples(dup, mesh.size)
    dup_block = torch.as_tensor(
        padded[mesh.rank * t_loc:(mesh.rank + 1) * t_loc])
    d_block, d_n, d_total = sharded.dedupe_preshard(
        dup_block, int(n_valid[mesh.rank]), mesh)
    out = dict(
        fcs=sharded.count_fcs_sharded(*g, support, mesh, include_binary=True),
        fcs_unary=sharded.count_fcs_sharded(*g, support, mesh,
                                            include_binary=False),
        histogram=sharded.join_histogram_sharded(*g, "spo", mesh),
        histogram_po=sharded.join_histogram_sharded(*g, "po", mesh),
        rules=[np.asarray(c) for c in
               sharded.mine_ars_sharded(*g, support, mesh)],
        dedupe_total=d_total,
        dedupe_rows=sharded._gather_rows(mesh, d_block, d_n),
        dedupe_counts=_gather(mesh, np.asarray([d_n])).tolist(),
        tables={})
    for s, discover in sharded.STRATEGIES.items():
        out["tables"][s] = discover(None, support, mesh=mesh, use_fis=True,
                                    use_ars=True, preshard=g).to_rows()
    return out if mesh.rank == 0 else None


def multihost_ingest_cases(mesh, paths, support, strategies):
    """One host of a multi-host launch: the sharded ingest of `paths` under
    both interning modes, the strategies over the ranks' row blocks, their
    CINDs decoded (a collective under partitioned interning) and every
    dictionary value.  Returns this host's view for local rank 0."""
    from rdfind_tpu_torch.models import sharded
    from rdfind_tpu_torch.runtime import multihost_ingest as mi

    out = {}
    for mode in ("partitioned", "replicated"):
        block, n_valid, d, total = mi.sharded_ingest(
            paths, mesh, partition_dictionary=mode == "partitioned")
        part = isinstance(d, mi.PartitionedDictionary)
        rec = dict(total=total, size=len(d), partitioned=part,
                   own=len(d.own_values) if part else len(d.values),
                   offsets=d.offsets.tolist() if part else None, cinds={})
        for s in strategies:
            table = sharded.STRATEGIES[s](None, support, mesh=mesh,
                                          preshard=(block, n_valid),
                                          use_fis=True, use_ars=True)
            view = d.resolve_table(table) if part else d
            rec["cinds"][s] = sorted(c.pretty() for c in table.decoded(view))
        view = d.resolve(np.arange(len(d))) if part else d
        rec["values"] = [view.value(i) for i in range(len(d))]
        out[mode] = rec
    return out


def launches_case(mesh, strategy, triples, support, kwargs):
    """A sharded strategy with every kernel count set to 0 just before:
    rank 0's rows and statistics, and every rank's K2 launches."""
    from rdfind_tpu_torch.models import sharded
    from rdfind_tpu_torch.ops import kernels
    from rdfind_tpu_torch.parallel.mesh import host_gather

    kernels.reset_contains_check()
    kernels.reset_launches()
    stats = {}
    table = sharded.STRATEGIES[strategy](triples, support, mesh=mesh,
                                         stats=stats, **kwargs)
    k2 = host_gather(mesh, torch.tensor(
        [kernels.LAUNCHES["packed_contains_matrix"]], dtype=torch.int64,
        device=mesh.device))
    if mesh.rank != 0:
        return None
    return dict(rows=table.to_rows(), stats=stats, k2_launches=k2.tolist())


def hard_exit_first(mesh, attempt):
    """Every rank leaves as the collective watchdog's hard exit does (exit 75,
    no report) on the first attempt, and returns the attempt after."""
    if attempt == 0:
        os._exit(75)
    mesh.barrier()
    return attempt


def fail_on_rank(mesh, bad_rank):
    """Rank `bad_rank` raises; the others block in a collective it never
    joins (the launcher must not wait for them)."""
    if mesh.rank == bad_rank:
        raise ValueError(f"planted failure on rank {bad_rank}")
    mesh.barrier()
    return "unreachable"


def shared_result(tmp_path_factory, key, compute):
    """compute() once per test session, shared by the xdist workers (each
    worker would otherwise rebuild a module's fixture, spawning its rank
    group again): the first worker computes under a file lock in the
    session's shared temp root and the others read the pickle."""
    import pickle

    if not os.environ.get("PYTEST_XDIST_WORKER"):
        return compute()
    import filelock
    root = tmp_path_factory.getbasetemp().parent
    path = root / f"{key}.pkl"
    with filelock.FileLock(str(path) + ".lock"):
        if path.exists():
            with open(path, "rb") as f:
                return pickle.load(f)
        out = compute()
        with open(path, "wb") as f:
            pickle.dump(out, f)
        return out
