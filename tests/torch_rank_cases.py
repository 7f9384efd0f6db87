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


def _table_summary(table, stats):
    from rdfind_tpu_torch.obs import integrity
    keep = ("planned_caps", "n_giant_lines", "n_giant_pairs",
            "n_pair_passes", "rebalance", "dist_backend", "staged")
    return dict(rows=table.to_rows(),
                digest=integrity.digest_hex(*integrity.digest_table(table)),
                stats={k: stats[k] for k in keep if k in stats},
                ledger={k: v["bytes"] for k, v in
                        stats.get("exchange_sites", {}).items()})


def sharded_cases(mesh, cases):
    """discover_sharded on each (name, triples, support, kwargs, env) case;
    `env` is set around the case.  Returns {name: summary}."""
    from rdfind_tpu_torch.models import sharded
    from rdfind_tpu_torch.ops import minimality

    out = {}
    for name, triples, support, kwargs, env in cases:
        kwargs = dict(kwargs)
        minimize = kwargs.pop("minimize", False)
        saved = {k: os.environ.get(k) for k in env}
        os.environ.update(env)
        try:
            stats = {}
            if "skew" in kwargs:
                kwargs["skew"] = sharded.SkewPolicy(**kwargs["skew"])
            table = sharded.discover_sharded(triples, support, mesh=mesh,
                                             stats=stats, **kwargs)
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
