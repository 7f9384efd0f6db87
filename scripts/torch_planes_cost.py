"""What the runtime and observability planes cost the port's CLI.

Writes the synth headline triples (``generate_triples(200_000, seed=42)``) as an
N-Triples file of ``<e{id}>`` IRIs under ``build/planes_cost/``, then runs the
CLI's default configuration (``--support 10``: strategy 1, native ingest) on it
in alternating order, plain and with the planes on, ``--rounds`` times each
(plain, planes, planes, plain, ...), in one process.  "Planes on" is ``--trace``,
``--metrics-file`` and ``RDFIND_CERT`` (which turn on the data plane and the
integrity plane too); ``--profile`` adds ``--profile-dir`` as a third
configuration.  Every run's output must equal the first plain run's, byte for
byte.  Prints one JSON line per run and a summary line with the median wall and
phase times of each configuration and the median overhead of the planes.
It needs the CUDA card unless ``--device cpu`` is given (then use fewer
``--triples``), and imports nothing of JAX or of the JAX package.

    python scripts/torch_planes_cost.py --rounds 3 --profile
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import re
import shutil
import statistics
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import numpy as np  # noqa: E402
import torch  # noqa: E402

from rdfind_tpu_torch.obs import metrics  # noqa: E402
from rdfind_tpu_torch.programs import rdfind as cli  # noqa: E402
from rdfind_tpu_torch.utils import synth  # noqa: E402

OUT_DIR = os.path.join(REPO, "build", "planes_cost")


def write_file(n_triples: int) -> str:
    os.makedirs(OUT_DIR, exist_ok=True)
    t = synth.generate_triples(n_triples, seed=42)
    terms = np.array([f"<e{i}>" for i in range(int(t.max()) + 1)],
                     dtype=object)
    path = os.path.join(OUT_DIR, "headline.nt")
    with open(path, "w") as f:
        f.write("".join(f"{s} {p} {o} .\n"
                        for s, p, o in terms[np.asarray(t, np.int64)]))
    return path


def run_once(config: str, nt: str, device: str, support: int, i: int):
    """One CLI run of `config`; returns (wall s, phases s, output bytes)."""
    d = os.path.join(OUT_DIR, f"{config}{i}")
    shutil.rmtree(d, ignore_errors=True)
    out = os.path.join(OUT_DIR, "out.txt")
    argv = [nt, "--support", str(support), "--device", device, "--output",
            out, "--counters", "1"]
    env = {}
    if config != "plain":
        argv += ["--trace", os.path.join(d, "trace"), "--metrics-file",
                 os.path.join(d, "metrics.prom")]
        env["RDFIND_CERT"] = os.path.join(d, "cert.json")
    if config == "profiled":
        argv += ["--profile-dir", os.path.join(d, "prof")]
    metrics.reset()
    os.environ.update(env)
    err = io.StringIO()
    try:
        t0 = time.perf_counter()
        with contextlib.redirect_stderr(err):
            rc = cli.main(argv)
        wall = time.perf_counter() - t0
    finally:
        for k in env:
            os.environ.pop(k, None)
    if rc != 0:
        raise SystemExit(f"{config} run {i}: rc {rc}")
    phases = {m.group(1): float(m.group(2)) / 1e3
              for m in re.finditer(r"phase (.+): ([0-9.]+) ms",
                                   err.getvalue())}
    with open(out, "rb") as f:
        return wall, phases, f.read()


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--rounds", type=int, default=3)
    p.add_argument("--triples", type=int, default=200_000)
    p.add_argument("--support", type=int, default=10)
    p.add_argument("--device", default="cuda")
    p.add_argument("--profile", action="store_true",
                   help="also time the planes with --profile-dir")
    args = p.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        print("no CUDA device; pass --device cpu", file=sys.stderr)
        return 2
    nt = write_file(args.triples)
    configs = ["plain", "traced"] + (["profiled"] if args.profile else [])
    order = []
    for r in range(args.rounds):
        order += configs if r % 2 == 0 else configs[::-1]
    walls = {c: [] for c in configs}
    phases = {c: [] for c in configs}
    want = None
    for i, config in enumerate(order):
        wall, ph, out = run_once(config, nt, args.device, args.support, i)
        if want is None:
            want = out
        if out != want:
            raise SystemExit(f"{config} run {i}: output differs")
        walls[config].append(wall)
        phases[config].append(ph)
        print(json.dumps(dict(run=i, config=config, wall_s=wall,
                              phases_s=ph)), flush=True)
    med = {c: statistics.median(w) for c, w in walls.items()}
    summary = dict(
        summary=True, rounds=args.rounds, n_triples=args.triples,
        median_wall_s=med,
        median_phases_s={c: {k: statistics.median(x[k] for x in phases[c])
                             for k in phases[c][0]} for c in configs},
        overhead_s={c: med[c] - med["plain"] for c in configs[1:]},
        overhead_frac={c: med[c] / med["plain"] - 1 for c in configs[1:]},
        walls_s=walls)
    print(json.dumps(summary), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
