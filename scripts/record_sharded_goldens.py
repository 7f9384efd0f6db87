"""Record the JAX package's plan and skew statistics of the sharded pipeline.

``chip_smoke.py`` holds the port's ``discover_sharded`` on the card to these
numbers (``GOLDEN_SHARDED``): for each workload and mesh size, the capacity
plan (``planned_caps``), the pass count (``n_pair_passes``) and the giant-line
statistics (``n_giant_lines``, ``n_giant_pairs``) of the JAX package's
``discover_sharded`` on a CPU mesh of fake devices.

A full-size pair phase does not fit a CPU run (dbpedia2m's giant lines alone
emit 3.1e8 pairs), so the script builds the JAX package's ``_Pipeline`` (plan,
lines, placement, captures; ``planned_caps`` and ``n_pair_passes`` come from
its stats) and reads the giant statistics off its resident lines with the
JAX package's own arithmetic: the float32 line loads, the mesh sums and
``SkewPolicy.split_threshold`` with the full pair budget, as
``_emit_local_pairs`` computes them, under ``shard_map`` on the same mesh.
AllAtOnce flags every row as dependent, so a giant line of length L emits
L * (L - 1) pairs over all passes.  ``--check`` first holds that reading
against the statistics of a complete ``discover_sharded`` on a small workload.

    python scripts/record_sharded_goldens.py --check            # ~1 min
    python scripts/record_sharded_goldens.py headline:1 headline:4
    python scripts/record_sharded_goldens.py dbpedia2m:1 dbpedia2m:4

Each WORKLOAD:DEVICES argument prints one JSON line.  Four devices run with
the pair row budget of chip_smoke's four-rank runs (2^23 rows per pass), one
device with the default.  The frequent-condition filter is on, as there.
dbpedia2m takes 35-80 s and 4.3 GB of host memory per run, the headline
15 s and 0.8 GB (one CPU core's run).
"""

import argparse
import hashlib
import json
import os
import sys
import time

os.environ.setdefault("JAX_PLATFORMS", "cpu")
_flags = os.environ.get("XLA_FLAGS", "")
if "host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (
        _flags + " --xla_force_host_platform_device_count=8").strip()
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import functools  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

jax.config.update("jax_platforms", "cpu")

from rdfind_tpu.models import sharded  # noqa: E402
from rdfind_tpu.ops import pairs  # noqa: E402
from rdfind_tpu.parallel.mesh import AXIS, make_mesh, shard_map  # noqa: E402
from rdfind_tpu.utils import synth  # noqa: E402
# chip_smoke.py's triples come from the port's generator (numpy only; its zipf
# draws do not depend on the numpy release).
from rdfind_tpu_torch.utils import synth as port_synth  # noqa: E402

# (generator, min_support, sha1 prefix of the triples), as in chip_smoke.py.
WORKLOADS = {
    "headline": (lambda: port_synth.generate_triples(200_000, seed=42), 10,
                 "09c3a25da6b8"),
    "dbpedia2m": (lambda: port_synth.generate_dbpedia_shaped(2_000_000,
                                                             seed=42),
                  100, "f40ea3cfaf10"),
}
FOUR_RANK_BUDGET = 1 << 23


def _giant_device(jv, n_rows, full_budget, *, skew):
    """_emit_local_pairs' skew prologue: (giant lines, their pairs) of this
    device's lines, summed over the mesh."""
    n = jv.shape[0]
    valid = jnp.arange(n, dtype=jnp.int32) < n_rows[0]
    pos, length, _, _ = pairs.line_layout(jv, n_rows[0])
    is_start = valid & (pos == 0)
    len_f = length.astype(jnp.float32)
    load_f = len_f * (len_f - 1.0)
    total_load = jax.lax.psum(jnp.where(is_start, load_f, 0.0).sum(), AXIS)
    total_lines = jax.lax.psum(is_start.sum(), AXIS)
    avg_load = total_load / jnp.maximum(total_lines, 1).astype(jnp.float32)
    thresh = skew.split_threshold(avg_load, full_budget[0])
    giant_start = is_start & valid & (load_f > thresh)
    n_lines = jax.lax.psum(giant_start.sum(), AXIS)
    return jnp.full(1, n_lines, jnp.int32), jnp.where(giant_start, length, 0)


def giant_stats(pipe) -> tuple[int, int]:
    fn = functools.partial(_giant_device, skew=pipe.skew)
    p = jax.sharding.PartitionSpec(AXIS)
    r = jax.sharding.PartitionSpec()
    step = jax.jit(shard_map(fn, mesh=pipe.mesh, in_specs=(p, p, r),
                             out_specs=p, check_vma=False))
    budget = jnp.full(1, np.float32(pipe.cap_p) * np.float32(pipe.n_pass),
                      jnp.float32)
    n_lines, lengths = step(pipe.lines[0], pipe.n_rows, budget)
    lengths = np.asarray(lengths).astype(np.int64)  # L * (L - 1) in int64
    return int(np.asarray(n_lines)[0]), int((lengths * (lengths - 1)).sum())


def record(triples, support, devices: int) -> dict:
    stats = {}
    pipe = sharded._Pipeline(make_mesh(devices), triples, support, "spo",
                             True, False, 4, stats)
    n_lines, n_pairs = giant_stats(pipe)
    return dict(n_pair_passes=int(stats["n_pair_passes"]),
                n_giant_lines=n_lines, n_giant_pairs=n_pairs,
                planned_caps={k: int(v)
                              for k, v in stats["planned_caps"].items()})


def check() -> None:
    """The reading above against a complete discover_sharded, at a pair row
    budget small enough for giant lines and hundreds of passes."""
    os.environ["RDFIND_PAIR_ROW_BUDGET"] = "4096"
    t = synth.generate_triples(3000, seed=42)
    for devices in (1, 4):
        got = record(t, 2, devices)
        st = {}
        sharded.discover_sharded(t, 2, mesh=make_mesh(devices), stats=st,
                                 use_fis=True)
        want = {k: st[k] for k in ("n_pair_passes", "n_giant_lines",
                                   "n_giant_pairs")}
        want["planned_caps"] = dict(st["planned_caps"])
        if got != want:
            raise SystemExit(f"{devices} devices: read {got}, the complete "
                             f"run gives {want}")
        print(f"check {devices} devices: {got}", flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("runs", nargs="*", metavar="WORKLOAD:DEVICES")
    ap.add_argument("--check", action="store_true")
    args = ap.parse_args()
    if args.check:
        check()
    for run in args.runs:
        name, devices = run.split(":")
        gen, support, sha = WORKLOADS[name]
        t = np.asarray(gen(), np.int32)
        got_sha = hashlib.sha1(t.tobytes()).hexdigest()[:12]
        if got_sha != sha:
            raise SystemExit(f"{name}: triples {got_sha}, want {sha}")
        if int(devices) > 1:
            os.environ["RDFIND_PAIR_ROW_BUDGET"] = str(FOUR_RANK_BUDGET)
        else:
            os.environ.pop("RDFIND_PAIR_ROW_BUDGET", None)
        t0 = time.perf_counter()
        out = record(t, support, int(devices))
        print(json.dumps(dict(workload=name, devices=int(devices),
                              seconds=round(time.perf_counter() - t0, 1),
                              **out)), flush=True)
        jax.clear_caches()
    return 0


if __name__ == "__main__":
    sys.exit(main())
