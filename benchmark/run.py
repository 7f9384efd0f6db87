#!/usr/bin/env python3
"""Benchmark of the PyTorch/CUDA port ``rdfind_tpu_torch``: one run of one cell.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

One process, one client in a closed loop:

1. makes the cell's input with the benchmark's own generator (``gen.py``):
   the configuration's fixed draw in a row order drawn from ``--seed``; and
   sets up the cell's job entry (``entries/``);
2. warms up with one whole job;
3. runs jobs back to back until they have taken ``--seconds``; the job in
   flight then is finished and counted.  Before each job, outside its time,
   the entry puts the input under ids of the job's own, drawn from the seed
   (``gen.job_ids``): the window is the jobs' own time;
4. checks a sample of the window's jobs, drawn from the seed, against the
   plain reference (``reference/``), which runs after the window on the
   benchmark's own triples;
5. prints one JSON line: the cell's end-to-end metrics with ``--trace 0``,
   its per-layer metrics, read from a ``torch.profiler`` trace of the
   window, with ``--trace 1``.

The cell's pieces are found by name (``cells.py``).  The run exits non-zero
and prints no result when the card is missing or has fewer devices than the
cell asks for, when the program cannot be imported, and when JAX or the JAX
package is loaded once the window has closed.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import shutil  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
if sys.path and sys.path[0] and Path(sys.path[0]).resolve() == HERE:
    sys.path[0] = str(ROOT)  # import `benchmark.*`, never its files bare
elif str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

# Every build and kernel cache at a fixed path inside the checkout.
CACHE_DIRS = {"TORCH_EXTENSIONS_DIR": "build/torch_extensions",
              "TRITON_CACHE_DIR": "build/triton"}
FORBIDDEN = ("jax", "jaxlib", "flax", "rdfind_tpu")


class RunError(Exception):
    """A run that cannot report a result."""


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def check_devices(chips: int) -> None:
    import torch

    if not torch.cuda.is_available():
        raise RunError("no CUDA device: this benchmark measures the card")
    if torch.cuda.device_count() < chips:
        raise RunError(f"the cell needs {chips} CUDA devices, "
                       f"{torch.cuda.device_count()} visible")


def holds(check: dict) -> bool:
    """A check's value against its limit."""
    return (check["value"] <= check["limit"] if check["op"] == "<="
            else check["value"] >= check["limit"])


def power_limit() -> str | None:
    """The card's ``name, power.limit`` as nvidia-smi reports it."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
    except (OSError, subprocess.SubprocessError):
        return None
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 \
        and out.stdout.strip() else None


class Context:
    """What a metric reader reads: the configuration, the input, the
    window's jobs, the set-up time, the trace and the card's name."""

    def __init__(self, config, triples, jobs, setup_s, trace, device_name):
        self.config = config
        self.triples = triples
        self.jobs = jobs
        self.setup_s = setup_s
        self.trace = trace
        self.device_name = device_name

    @property
    def n_jobs(self) -> int:
        return len(self.jobs)


def _memory(torch, cuda: bool):
    """(reset, allocated, peak) of the device allocator; zeros off CUDA."""
    if not cuda:
        return (lambda: None), (lambda: 0), (lambda: 0)
    return (torch.cuda.reset_peak_memory_stats, torch.cuda.memory_allocated,
            torch.cuda.max_memory_allocated)


def run_cell(cell: dict, seed: int, seconds: float, trace: bool, *,
             device: str = "cuda", bench: dict | None = None,
             t_start: float = T_START) -> tuple[dict, dict]:
    """One run of `cell`.  Returns (result line, checks)."""
    import numpy as np
    import torch

    from benchmark import cells, gen, tracing
    from benchmark.reference import cinds

    bench = bench if bench is not None else cells.benchmark()
    cfg, traffic = cell["config_file"], cell["traffic_file"]
    cuda = torch.device(device).type == "cuda"
    seed = int(seed) % 2 ** 64
    triples = gen.make_input(cfg, seed)
    workdir = tempfile.mkdtemp(prefix="rdfind-bench-")
    try:
        entry = cells.entry(traffic["entry"])(cfg, traffic, triples, device,
                                              workdir)
        reset, allocated, peak = _memory(torch, cuda)
        n_ids = int(triples.max()) + 1

        def job_ids(i):
            return gen.job_ids(n_ids, np.random.default_rng([seed, 2, i]))

        launches = None
        if cuda:
            from rdfind_tpu_torch.ops import kernels
            before = dict(kernels.LAUNCHES)
        entry.prepare(job_ids(0))
        entry.job()  # warm-up: builds, loads and allocates what jobs use
        if cuda:
            launches = {k: kernels.LAUNCHES[k] - before.get(k, 0)
                        for k in traffic.get("kernels", [])}
        gc.collect()
        if cuda:
            torch.cuda.synchronize()
        process_peak = peak()

        rng = np.random.default_rng([seed, 1])
        n_judged = int(traffic["judged_jobs"])
        judged: list = []
        jobs: list = []
        failed = 0
        prof = None
        if trace:
            from torch.profiler import ProfilerActivity, profile
            acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA]
                                             if cuda else [])
            prof = profile(activities=acts)
            prof.start()
        from torch.profiler import record_function
        t_window = time.perf_counter()
        busy = 0.0  # the jobs' own seconds: the window
        i = 0
        while busy < seconds:
            entry.prepare(job_ids(i + 1))  # the job's input, outside its time
            process_peak = max(process_peak, peak())
            reset()
            base = allocated()
            t0 = time.perf_counter()
            out = None
            try:
                with record_function(tracing.JOB_RANGE):
                    out = entry.job()
            except Exception as e:  # a failed job is counted, not fatal
                failed += 1
                print(f"job {i} failed: {type(e).__name__}: {e}",
                      file=sys.stderr)
            t1 = time.perf_counter()
            busy += t1 - t0
            jobs.append({"seconds": t1 - t0, "triples": entry.triples_per_job,
                         "peak_bytes": peak() - base, "ok": out is not None,
                         "phases": out["phases"] if out else ()})
            if out is not None:
                # Reservoir sample of the window's jobs, drawn from the seed.
                if len(judged) < n_judged:
                    judged.append(entry.retain(out, len(judged)))
                else:
                    slot = int(rng.integers(0, i + 1))
                    if slot < n_judged:
                        judged[slot] = entry.retain(out, slot)
            del out
            i += 1
        process_peak = max(process_peak, peak())
        setup_s = t_window - t_start
        tr = None
        if prof is not None:
            prof.stop()
            tr = tracing.read(prof, [j["phases"] for j in jobs])
            del prof
        entry.close()
        gc.collect()
        if cuda:
            torch.cuda.empty_cache()

        # The check, after the window and the memory reading.
        want = cinds.discover(triples, int(cfg["min_support"]),
                              cfg.get("projections", "spo"),
                              lattice=int(traffic["strategy"]) in (1, 3),
                              device=device)
        mismatched = sum(entry.mismatches(out, want) for out in judged)
        checks = {"mismatched_rows": {"value": mismatched, "limit": 0,
                                      "op": "<="},
                  "failed_jobs": {"value": failed, "limit": 0, "op": "<="},
                  "judged_jobs": {"value": len(judged), "limit": 1,
                                  "op": ">="},
                  "reference_rows": {"value": len(want["support"]),
                                     "limit": 1, "op": ">="}}
        for name, n in (launches or {}).items():
            checks[f"launches.{name}"] = {"value": n, "limit": 1, "op": ">="}
        correct = all(holds(c) for c in checks.values())

        device_name = torch.cuda.get_device_name(0) if cuda else "cpu"
        ctx = Context(cfg, triples, jobs, setup_s, tr, device_name)
        kind = "per_layer" if trace else "end_to_end"
        metrics = {}
        for m in cells.metrics_of(cell["name"], bench, kind):
            value = cells.reader(m["name"])(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        dev = {"platform": "gpu" if cuda else "cpu", "kind": device_name,
               "count": int(cell.get("chips", 1)),
               "memory_peak_bytes": int(process_peak)}
        result = {"correct": bool(correct), "attempted": len(jobs),
                  "failed": failed, "metrics": metrics, "device": dev}
        if tr is not None:
            dev["busy_s"] = tr.busy_s
            dev["window_s"] = tr.window_s
            if cuda:
                dev["power"] = power_limit()
            result["breakdown"] = tr.breakdown()
        result["checks"] = checks
        return result, checks
    finally:
        shutil.rmtree(workdir, ignore_errors=True)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    for var, rel in CACHE_DIRS.items():
        os.environ[var] = str(ROOT / rel)
    try:
        from benchmark import cells
        bench = cells.benchmark()
        cell = cells.cell(args.workload, bench)
        check_devices(int(cell.get("chips", 1)))
        import rdfind_tpu_torch  # noqa: F401  (the program under test)
        result, checks = run_cell(cell, args.seed, args.seconds,
                                  bool(args.trace), bench=bench)
    except (RunError, KeyError, ImportError, FileNotFoundError) as e:
        print(f"benchmark: {type(e).__name__}: {e}", file=sys.stderr)
        return 2
    bad = forbidden_modules()
    if bad:
        print(f"benchmark: loaded after the window: {', '.join(bad)} "
              f"(the port must not load JAX or the JAX package)",
              file=sys.stderr)
        return 3
    print(json.dumps(result))
    sys.stdout.flush()
    for name, c in checks.items():
        print(f"check {name} {c['value']} {c['op']} {c['limit']} "
              f"{'ok' if holds(c) else 'FAILED'}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
