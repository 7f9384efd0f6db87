"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

It needs one CUDA card and fails (non-zero exit, no result line) without one.  It
imports nothing of JAX or of the JAX package.  Phases, each printed as JSON lines:

1. the card (``nvidia-smi`` name and power limit, torch's device name);
2. the build of every kernel library from ``rdfind_tpu_torch/csrc`` with nvcc
   (sm_90a), one nvcc process per source, all started together, with ptxas'
   registers, shared memory and spills for every kernel;
3. each kernel against its plain PyTorch version on the card, bit-exact, at the
   main paths' shapes and at edge cases, with its time on the device, the plain
   version's time, the time of one library call for the same function (a
   yardstick the port never calls), the least time the card could take
   (``bound_ms``), the rate reached (``tops``) and ``share_of_bound``: K1
   (strategy 0's fused sweep on the K-major membership Mᵀ), K2 (the Bloom
   containment of strategies 2 and 3, on the sketches the port builds) and the
   probes P1 and P2;
4. the main paths, ``rdfind_tpu_torch.discover(..., strategy=0|1|2|3)``, on the
   headline workload and on the real-size workload, with the kernel launch
   counts and the peak device memory of each run; the CIND count and output
   digest of each must equal the JAX package's (and the candidate counts of
   strategies 2 and 3, and the lattice counts of strategy 1, too).  Strategy 1
   (small-to-large, on its dense lattice here) launches no hand-written kernel:
   its product is ``torch._int_mm``.  Every launch of the real-size strategy-0
   sweep must also equal the plain version;
5. one more run of each strategy on each workload under torch.profiler:
   device busy time, idle share, host time per ``rdfind.*`` range (summed over
   repeats, such as the chunks), the operators with the most device time;
6. the CLI's default configuration: the headline without the frequent-condition
   filter (~20x the captures), through strategy 0 and through strategy 1, whose
   capture axis takes its chunked lattice walk; both must equal the filtered
   goldens.  Strategy 1 with clean_implied must equal strategy 0 with it;
7. the chunked pair backend forced on the headline for strategies 0, 2 and 3:
   each must equal its golden, candidate counts included, with its chunk count;
8. ``half_approx``: strategy 1's half-approximate 1/1 round
   (``explicit_threshold`` 0 and 64, the default count-min sketch) on the
   headline, on the real-size workload and on the unfiltered headline: the
   CIND count, digest and lattice counts of strategy 1, and on the filtered
   headline the five ``ha_*`` statistics of the JAX package; each with one
   profiled run;
9. ``ingest``: the compiler and zlib the native ingest needs, its build from
   ``native/rdfind_native.cpp``, then the headline written as N-Triples,
   gzipped N-Triples and tab-separated text, each read by the native engine
   (threads as configured, and 1) and by the Python ingest: equal ids and
   dictionaries, with seconds, MB/s and the engine's phase times;
10. ``cli``: the CLI's default run on the N-Triples file (native ingest, its
   read+parse / intern / discover split), one with ``--explicit-threshold 64
   --counters 1`` and one with ``--prefixes`` on a prefix file written here;
   each output file must equal the strategy-1 golden's CINDs decoded to the
   same terms, line for line;
11. ``planes``: the runtime and observability planes through the CLI on that
   file.  Strategy 0 with ``--trace``, ``--metrics-file``, ``--profile-dir``,
   ``--checkpoint-dir`` and ``RDFIND_CERT``: the output equals the strategy-0
   golden line for line, the certificate's output digest the JAX package's,
   the span tree holds the stage spans, the exposition ``rdfind_*`` metrics,
   and the profiler trace one K1 device event per counted launch.  The same
   command again resumes both stages, byte for byte.  The CLI default with an
   injected ``host_pull`` fault (one retry) and with a failed
   ``checkpoint_write`` (rc 0, ``checkpoint-errors`` 1), output unchanged.
   Strategy 2 under ``--profile-dir``: K2, P1 and P2 events equal to their
   launch counts; ``sketch.kernel_selfcheck``.  The CLI default with tracing,
   metrics and the certificate on, beside the plain ``cli`` row (the planes'
   cost), and its stage-boundary ``hbm`` record against
   ``torch.cuda.max_memory_allocated``;
12. ``delta``: incremental discovery through the CLI on the card.  The
   headline file as a base bundle (``--delta-state``, strategy 1), a 1 % batch
   (``synth.grow_delta_batches``, 2,000 changes) through ``--delta ...
   --deletes ...``: the full-fallback path, K1 launched, output byte-identical
   to a from-scratch CLI run (itself run with ``--console-port 0`` and scraped
   at ``/progress`` and ``/metrics``), certificate chained onto the base's;
   the same batch at strategy 0 with ``--use-fis`` on a copy of that base.
   Strategies 2 and 3 on a 20,000-triple input in-process through
   ``driver.run`` (one bundle, full fallback, K2 launched).  The real-size
   workload with ``--projection so`` and a 0.01 % batch (200 changes): the
   incremental path with passes reused, byte-identical output, the
   certificate chained and the new bundle reloading with no degradation.  The
   same batch with ``--projection spo`` once, in a subprocess under a wall
   cap: whether the incremental re-intersection finishes, and where it was;
13. ``serve``: ``programs.serve`` in a subprocess on the headline bundle:
   1,000 sampled CINDs answered true with their support, 1,000 non-CINDs
   false, unknown values and captures as misses, top-k equal to the table's;
   then a strategy-0 ``--use-fis`` delta generation that undoes the batch
   (full fallback, K1 launched, output byte-identical to the strategy-0
   golden) while a thread keeps querying: the hot swap drops no query,
   ``/status`` shows the chain, ``/metrics`` and ``/slo`` answer, the new
   answers equal the new table; SIGTERM dumps the slow-query ring.  Index
   open, verify and swap times, and the server's p50/p99 query latency;
14. ``sharded``: the sharded strategy-0 pipeline (``models/sharded.py``)
   through the launcher, with the frequent-condition filter: a one-rank NCCL
   group on the headline and the real-size workload, each equal to its golden;
   four ranks on the one card over gloo staged through host memory
   (``RDFIND_TORCH_DIST_BACKEND=gloo``), equal to the goldens and with the
   JAX package's plan and skew statistics at 4 devices; the CLI with
   ``--dop 4`` on the headline file, equal to the strategy-0 CLI output; the
   same preempted after pass 0 under ``--retry-on-preempt 2``: one
   supervisor retry, resumed passes, byte-identical.  Each run's wall, host ms
   per pipeline stage, exchange bytes per site, idle share, peak memory per
   rank and transport;
15. a ``kernels`` line, then the last line ``{"ok": true, "device": ...}``.
   The kernel phase also times an empty launch (``launch_floor``), the
   practical floor under the probes P1 and P2.

To stay within its time, the script runs the unfiltered strategy-1 walk, the
forced chunked backend and the half-approximate round once each (the main
paths on the two filtered workloads take the median of 3).

Any mismatch raises, so the script exits non-zero without the last line.
"""

from __future__ import annotations

import ast
import contextlib
import gzip
import hashlib
import io
import json
import os
import re
import shutil
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.parse
import urllib.request

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import rdfind_tpu_torch  # noqa: E402
from rdfind_tpu_torch import conditions  # noqa: E402
from rdfind_tpu_torch.dictionary import Dictionary, intern_triples  # noqa: E402
from rdfind_tpu_torch.io import native, ntriples, reader  # noqa: E402
from rdfind_tpu_torch.models import allatonce, approximate  # noqa: E402
from rdfind_tpu_torch.obs import console, integrity, metrics, report  # noqa: E402
from rdfind_tpu_torch.ops import build, cooc, kernels, sketch  # noqa: E402
from rdfind_tpu_torch.parallel import launch  # noqa: E402
from rdfind_tpu_torch.programs import rdfind as cli  # noqa: E402
from rdfind_tpu_torch.runtime import delta, driver, faults, serving  # noqa: E402
from rdfind_tpu_torch.utils import synth  # noqa: E402

# Published dense peaks of one H100 SXM (NVIDIA data sheet), at a 700 W limit.
PEAK_INT8_OPS = 1979e12
PEAK_BYTES_PER_S = 3.35e12

# Goldens, recorded once from the JAX package on the CPU, on the triples that
# rdfind_tpu_torch.utils.synth generates (its zipf draws do not depend on the
# numpy release, so these triples are the same on every machine):
#   t = rdfind_tpu_torch.utils.synth.generate_triples(200000, seed=42)
#   table = rdfind_tpu.discover(t, 10, strategy=0)           # ~10 s on one core
#   len(table), rdfind_tpu.obs.integrity.digest_hex(*digest_table(table))
# and the same with generate_dbpedia_shaped(2000000, seed=42) at support 100
# (~50 s).  "triples" is the first 12 hex digits of the sha1 of the (N, 3) int32
# array's bytes, so a generator drift is told apart from a wrong result.
GOLDEN = {
    "headline": dict(triples="09c3a25da6b8", n_cinds=622016,
                     digest="d4689a6b896a697f"),
    "dbpedia2m": dict(triples="f40ea3cfaf10", n_cinds=1397,
                      digest="0264f31fbfec8876"),
}

# Strategies 2 and 3, recorded the same way from the JAX package's
#   rdfind_tpu.models.approximate.discover(t, s, stats=st)   (strategy 2)
#   rdfind_tpu.models.late_bb.discover(t, s, stats=st)       (strategy 3)
# with the candidate counts from `st`.  Raw strategy 2 equals raw strategy 0.  The
# sketch-candidate count depends on every bit of the hash, the sketch build and
# K2, so it checks them at full size; false positives never reach the digest.
GOLDEN_APPROX = {
    ("headline", 2): dict(n_cinds=622016, digest="d4689a6b896a697f",
                          n_sketch_candidates=2628346),
    ("headline", 3): dict(n_cinds=384272, digest="01f997b4baf6fa93",
                          n_round1_candidates=1215133,
                          n_round2_candidates=1170724),
    ("dbpedia2m", 2): dict(n_cinds=1397, digest="0264f31fbfec8876",
                           n_sketch_candidates=1405),
    ("dbpedia2m", 3): dict(n_cinds=1397, digest="0264f31fbfec8876",
                           n_round1_candidates=1405, n_round2_candidates=0),
}
# Strategy 1 (small-to-large), recorded the same way from the JAX package's
#   rdfind_tpu.discover(t, s, strategy=1, stats=st)   # dense lattice
# (~15 s for the headline, ~70 s for dbpedia2m on one core), with the lattice
# counts from `st`.  The JAX package gives the same CINDs and digest without the
# frequent-condition filter: at 20,000 triples of the same generator (seed 42,
# support 10) its filtered run (dense) and unfiltered run (chunked walk) both
# give 8,396 CINDs, digest 714cca23adf4fe3b.  With clean_implied the headline
# gives 316,739 CINDs, digest d45fdf70356a9b01.
GOLDEN_S2L = {
    "headline": dict(n_cinds=384272, digest="01f997b4baf6fa93",
                     n_cinds_11=170308, n_proper_overlaps=661660,
                     n_cinds_12=123378, n_cinds_21=48672,
                     n_inferred_21=235765, n_cinds_22=41914,
                     total_pairs=230404144),
    "dbpedia2m": dict(n_cinds=1397, digest="0264f31fbfec8876",
                      n_cinds_11=1397, n_proper_overlaps=115799,
                      n_cinds_12=0, n_cinds_21=0, n_inferred_21=0,
                      n_cinds_22=0, total_pairs=79284596),
}
GOLDEN_S2L_CLEAN = dict(n_cinds=316739, digest="d45fdf70356a9b01")
# The CLI's strategy-0 run on build/smoke/headline.nt: its ids are the file's
# (the terms <e{id}> interned in sorted order), so its output digest differs
# from GOLDEN's.  Recorded from the JAX package's library on those interned
# ids, with the frequent-condition filter on (it prunes only captures that
# cannot be in a CIND; ~12 s on one core):
#   ids, _ = rdfind_tpu.dictionary.intern_triples(terms_of(t)[t])
#   table = rdfind_tpu.discover(ids, 10, strategy=0)
GOLDEN_CLI_S0 = dict(output_digest="e43e14947a4bc087", n_cinds=622016)
# The half-approximate 1/1 round of strategy 1, recorded the same way from
#   rdfind_tpu.models.small_to_large.discover(t, 10, explicit_threshold=th,
#                                             stats=st)   # ~7 min on one core
# on the (filtered) headline with the default sketch (sbf_width 2^20, sbf_bits
# 5) and pair_chunk_budget 2^22.  Its CINDs, digest and lattice counts are
# strategy 1's; these statistics depend on the chunking as well.
GOLDEN_HA = {
    0: dict(ha_spilled=5023110, ha_round2_deps=2042, ha_explicit_pairs=0,
            ha_round2_merged_pairs=831968, ha_round2_rows=5011517,
            pairs_11=42536208),
    64: dict(ha_spilled=4688835, ha_round2_deps=2042, ha_explicit_pairs=130688,
             ha_round2_merged_pairs=831968, ha_round2_rows=5004455,
             pairs_11=42536208),
}
# The kernels each main path must launch.  Strategy 1 launches none: its
# lattice is torch ops and torch._int_mm, and the JAX package has no Pallas
# kernel on that path either.  Nor does strategy 0's chunked backend
# (path_kernels); strategies 2 and 3 reach K2 on either backend.
K2_PATH = ("packed_contains_matrix", "repeat_probe", "pipeline_probe")
PATH_KERNELS = {0: ("fused_cind_blocks",), 1: (), 2: K2_PATH, 3: K2_PATH}


def path_kernels(strategy: int, kw: dict) -> tuple:
    if strategy == 0 and kw.get("pair_backend") == "chunked":
        return ()
    return PATH_KERNELS[strategy]


# Where the script writes its files: inside the checkout, ignored by git.
SCRATCH = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build",
                       "smoke")

# (name, triples generator, min_support).
WORKLOADS = [
    ("headline", lambda: synth.generate_triples(200_000, seed=42), 10),
    ("dbpedia2m", lambda: synth.generate_dbpedia_shaped(2_000_000, seed=42),
     100),
]
# The workload whose main-path run the kernels line reports.
REAL_SIZE = "dbpedia2m"


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


# Cycles of the pre-fill sleep per queued call: ~0.1 ms at the card's clock,
# more than the host takes to enqueue one wrapper call.
SLEEP_CYCLES_PER_CALL = 200_000


def time_ms(fn, device, reps: int, warmup: int = 1,
            device_only: bool = False) -> float:
    """Mean milliseconds of fn() over `reps` calls (CUDA events on the card).

    With ``device_only`` the stream first runs a sleep kernel long enough for
    the host to enqueue all `reps` calls behind it, so the events time the
    device's work back to back and not the host's enqueue rate (a wrapper call
    costs tens of microseconds of host time, more than a small kernel runs).
    Only for functions that never sync the host."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    if device_only:
        torch.cuda._sleep(SLEEP_CYCLES_PER_CALL * (reps + 10))
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def rate_fields(ops: int, nbytes: int, ms: float) -> dict:
    """bound_ms (the larger of the operations and bytes floors at the card's
    published peaks), what bounds it, the rate reached and the share of the
    bound that `ms` achieves."""
    t_ops, t_bytes = ops / PEAK_INT8_OPS, nbytes / PEAK_BYTES_PER_S
    bound = max(t_ops, t_bytes) * 1e3
    return dict(bound_ms=bound,
                bound_by="operations" if t_ops >= t_bytes else "bytes",
                tops=ops / ms / 1e9, share_of_bound=bound / ms)


KERNEL_NAMES = ("fused_cind_kernel", "contains_kernel", "repeat_probe_kernel",
                "pipeline_probe_kernel")


def ptxas_report(log: str) -> list:
    """One entry per compiled kernel from nvcc's ``-Xptxas -v`` output: its
    registers, static shared memory and spill bytes."""
    out = []
    for ln in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", ln)
        if m:
            name = next((k for k in KERNEL_NAMES if k in m.group(1)),
                        m.group(1))
            out.append(dict(kernel=name, registers=None, smem_bytes=0,
                            spill_stores=None, spill_loads=None))
        elif out:
            m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                          ln)
            if m:
                out[-1].update(spill_stores=int(m.group(1)),
                               spill_loads=int(m.group(2)))
            m = re.search(r"Used (\d+) registers", ln)
            if m:
                out[-1]["registers"] = int(m.group(1))
                m = re.search(r"(\d+) bytes smem", ln)
                out[-1]["smem_bytes"] = int(m.group(1)) if m else 0
    return out


def prepare(triples, support: int, device) -> dict:
    """The dense sweep's inputs for a workload, through the port's own stages."""
    t = torch.as_tensor(np.asarray(triples, np.int32)).to(device)
    (line_gid, cap_id, valid, n_lines, code, v1, v2,
     num_caps) = allatonce._stage_prepare(t, support, projections="spo",
                                          use_fc_filter=True)
    plan = cooc.dense_plan(n_lines, num_caps, device)
    m_t, dep_count, _ = allatonce._stage_membership(
        line_gid, cap_id, valid, support, l_pad=plan.l_pad, c_pad=plan.c_pad)
    cols, rows = cooc.sweep_operands(
        dep_count, allatonce._fit(code, plan.c_pad),
        allatonce._fit(v1, plan.c_pad), allatonce._fit(v2, plan.c_pad), support)
    counts = cooc.stage_block_counts(m_t, kl=plan.line_block,
                                     tile=plan.tile).cpu().numpy()
    return dict(m=m_t, plan=plan, cols=cols, rows=rows, counts=counts,
                launches=cooc.sweep_launches(counts, plan.dep_tile_starts,
                                             plan.tile))


def k1_case(name, m, cols, rows, lo, width, block_ids, n_real, ref_lo,
            ref_chunk) -> dict:
    """Arguments of one fused_cind_blocks call on Mᵀ `m`: dep rows [lo, lo +
    width), ref rows [ref_lo, ref_lo + ref_chunk), the given block schedule."""
    dev = m.device
    sl = slice(lo, lo + width)
    args = (m[sl], m, cols["sup"][sl], cols["ok"][sl], cols["gid"][sl],
            cols["code"][sl], cols["v1"][sl], cols["v2"][sl], rows["ridx"],
            rows["code"], rows["v1"],
            torch.as_tensor(np.asarray(block_ids, np.int32)).to(dev),
            torch.tensor([n_real], dtype=torch.int32).to(dev))
    return dict(name=name, args=args,
                kw=dict(ref_lo=ref_lo, ref_chunk=ref_chunk))


def equal_code_case(device) -> dict:
    """A synthetic block where dep and ref captures share codes, so the
    trivially-implied rule (with its equal-code quirk) decides many verdicts."""
    rng = np.random.default_rng(7)
    l_pad, c_pad = 2048, 512
    m = (rng.random((l_pad, c_pad)) < 0.01).astype(np.int8)
    m[:, 256:384] |= m[:, 0:128]  # plant containments j < 256 + j
    code = rng.choice([17, 35], c_pad).astype(np.int32)
    v1 = rng.integers(0, 3, c_pad).astype(np.int32)
    v2 = rng.integers(0, 3, c_pad).astype(np.int32)
    mt = torch.as_tensor(m.T.copy()).to(device)
    cols, rows = cooc.sweep_operands(
        mt.sum(dim=1, dtype=torch.int32), torch.as_tensor(code).to(device),
        torch.as_tensor(v1).to(device), torch.as_tensor(v2).to(device), 1)
    kl = cooc.line_block_for(l_pad)
    return k1_case("equal_code_implied", mt, cols, rows, 0, 256,
                   np.arange(l_pad // kl), l_pad // kl, 0, c_pad)


def k1_cases(preps: dict, device) -> list:
    """Kernel-vs-plain cases: one launch of each workload's sweep as the main
    path issues it, the TPU plan's own dep tile with a pow2-padded schedule, an
    empty schedule, a square diagonal block, and the equal-code case."""
    out = []
    for name, p in preps.items():
        ln = p["launches"][0]
        out.append(k1_case(f"{name}_launch0", p["m"], p["cols"], p["rows"],
                           ln.lo, ln.width, ln.block_ids, ln.block_ids.size, 0,
                           p["plan"].c_pad))
    h = preps["headline"]
    plan = h["plan"]
    nz = np.flatnonzero(h["counts"][:, 0])
    bucket = 1 << int(np.ceil(np.log2(max(nz.size, 1))))
    padded = np.pad(nz, (0, bucket - nz.size + 1))  # always n_real < nk
    out.append(k1_case("headline_tile0_padded_schedule", h["m"], h["cols"],
                       h["rows"], 0, plan.tile, padded, nz.size, 0,
                       plan.c_pad))
    out.append(k1_case("headline_tile0_n_real_0", h["m"], h["cols"], h["rows"],
                       0, plan.tile, np.zeros(4), 0, 0, plan.c_pad))
    lo = plan.dep_tile_starts[min(8, len(plan.dep_tile_starts) - 1)]
    nz = np.flatnonzero(h["counts"][:, lo // plan.tile])
    out.append(k1_case("headline_diagonal_block", h["m"], h["cols"], h["rows"],
                       lo, plan.tile, nz, nz.size, lo, plan.tile))
    out.append(equal_code_case(device))
    return out


def work_of(case) -> tuple:
    """(int8 operations, bytes) the call needs at this run's data: the scheduled
    lines of both operands read once, the columns, and the outputs written once."""
    m_dep = case["args"][0]
    n_real = int(case["args"][12][0])
    tile, l_pad = m_dep.shape
    ref_chunk = case["kw"]["ref_chunk"]
    k = n_real * cooc.line_block_for(l_pad)
    ops = 2 * tile * ref_chunk * k
    nbytes = k * (tile + ref_chunk) + 4 * (6 * tile + 3 * ref_chunk) \
        + tile * ref_chunk // 8 + 4 * tile
    return ops, nbytes


def library_product(case):
    """torch._int_mm of the same cooc product (the product alone, no verdict),
    as a yardstick; None when the schedule is empty."""
    m_dep, m = case["args"][0], case["args"][1]
    block_ids, n_real = case["args"][11], int(case["args"][12][0])
    if n_real == 0:
        return None
    kl = cooc.line_block_for(m.shape[1])
    lines = (block_ids[:n_real].long()[:, None] * kl
             + torch.arange(kl, device=m.device)[None, :]).reshape(-1)
    ref_lo, ref_chunk = case["kw"]["ref_lo"], case["kw"]["ref_chunk"]
    a = m_dep[:, lines].contiguous()
    b = m[ref_lo:ref_lo + ref_chunk, lines].contiguous().T
    return lambda: torch._int_mm(a, b)


def compare_k1(args, kw) -> int:
    """Kernel vs plain on the same inputs; the largest absolute difference over
    the unpacked verdict bits and the popcounts (raises unless 0)."""
    packed_k, popc_k = kernels.fused_cind_blocks(*args, **kw)
    packed_p, popc_p = kernels.fused_cind_blocks_plain(*args, **kw)
    err = max(int((cooc.unpack_bits(packed_k).int()
                   - cooc.unpack_bits(packed_p).int()).abs().max()),
              int((popc_k - popc_p).abs().max()))
    if err or not torch.equal(packed_k, packed_p) \
            or not torch.equal(popc_k, popc_p):
        raise AssertionError(f"fused_cind_blocks disagrees with its plain "
                             f"version (max abs err {err})")
    return err


def run_k1_cases(cases, device) -> list:
    rows = []
    for case in cases:
        args, kw = case["args"], case["kw"]
        err = compare_k1(args, kw)
        ops, nbytes = work_of(case)
        big = ops > 1e12
        reps = 5 if big else 20
        k_ms = time_ms(lambda: kernels.fused_cind_blocks(*args, **kw), device,
                       reps=reps, device_only=True)
        call_ms = time_ms(lambda: kernels.fused_cind_blocks(*args, **kw),
                          device, reps=reps)
        p_ms = time_ms(lambda: kernels.fused_cind_blocks_plain(*args, **kw),
                       device, reps=2 if big else 5)
        lib = library_product(case)
        lib_ms = None if lib is None else time_ms(lib, device, reps=reps,
                                                  device_only=True)
        row = dict(phase="kernel", kernel="fused_cind_blocks", case=case["name"],
                   l_pad=args[0].shape[1], tile=args[0].shape[0],
                   ref_lo=kw["ref_lo"], ref_chunk=kw["ref_chunk"],
                   nk=args[11].numel(), n_real=int(args[12][0]),
                   ops=ops, bytes=nbytes, match=True, max_abs_err=err,
                   kernel_ms=k_ms, call_ms=call_ms, plain_ms=p_ms,
                   library_ms=lib_ms,
                   library="torch._int_mm, the int8 product alone",
                   **rate_fields(ops, nbytes, k_ms))
        emit(row)
        rows.append(row)
    return rows


def sketch_prepare(triples, support: int, device) -> dict:
    """K2's inputs on the strategy-2 main path, through the port's own stages:
    the packed sketches, the packed ref bit sets of every capture and the
    dep-tile width."""
    t = allatonce.triples_on(triples, device)
    st = allatonce.prepare_join_lines(t, support, "spo", True, False, None)
    sk = approximate._build_sketches(
        st["line_val_h"], st["line_cap_h"], st["num_caps"],
        bits=sketch.DEFAULT_BITS, num_hashes=sketch.DEFAULT_HASHES,
        device=device)
    ref_ids = torch.arange(sk.shape[0], dtype=torch.int32, device=device)
    words, popc = sketch.pack_ref_bits(ref_ids, bits=sketch.DEFAULT_BITS,
                                       num_hashes=sketch.DEFAULT_HASHES)
    return dict(sk=sk, words=words, popc=popc,
                tile=cooc.tile_for(sk.shape[0], approximate.DEP_TILE))


def synthetic_contains(seed: int, d: int, r: int, bits: int, device,
                       density: int) -> tuple:
    """K2 operands of random ids: each dep sketch holds the bit sets of 3 refs
    (planted containments) over random words in which ~1/2^density of the bits
    are set (density 0: ~3/4 of them)."""
    gen = torch.Generator(device=device).manual_seed(seed)
    ids = torch.randint(0, 1 << 30, (r,), generator=gen, device=device,
                        dtype=torch.int32)
    words, popc = sketch.pack_ref_bits(ids, bits=bits,
                                       num_hashes=sketch.DEFAULT_HASHES)

    def rand_words():
        return torch.randint(-(1 << 31), 1 << 31, (d, bits // 32),
                             generator=gen, device=device, dtype=torch.int32)

    sk = rand_words() | rand_words() if density == 0 else rand_words()
    for _ in range(density - 1):
        sk &= rand_words()
    pick = torch.randint(0, r, (d, 3), generator=gen, device=device)
    sk |= words[pick[:, 0]] | words[pick[:, 1]] | words[pick[:, 2]]
    return sk, words, popc


def k2_cases(sk_preps: dict, device) -> list:
    """Kernel-vs-plain cases of K2: the first dep tile of each workload as the
    main path issues it (real sketches, every capture as a ref), the headline
    tile with its last 64 refs padded (zero words, popc -1), W = 1, W = 512
    (16 word chunks), and planted containments among dense words."""
    out = []
    for name, p in sk_preps.items():
        out.append(dict(name=f"{name}_tile0",
                        args=(p["sk"][:p["tile"]], p["words"], p["popc"])))
    h = sk_preps["headline"]
    words, popc = h["words"].clone(), h["popc"].clone()
    words[-64:] = 0
    popc[-64:] = -1
    out.append(dict(name="headline_tile0_padded_refs",
                    args=(h["sk"][:h["tile"]], words, popc)))
    out.append(dict(name="w1_bits32",
                    args=synthetic_contains(1, 256, 2048, 32, device, 2)))
    out.append(dict(name="w512_bits16384",
                    args=synthetic_contains(2, 128, 1024, 16384, device, 3)))
    out.append(dict(name="planted_dense",
                    args=synthetic_contains(3, 256, 4096, 2048, device, 0)))
    return out


def compare_k2(args) -> int:
    got = kernels.packed_contains_matrix(*args)
    want = kernels.packed_contains_matrix_plain(*args)
    err = int((got.int() - want.int()).abs().max())
    if err or not torch.equal(got, want):
        raise AssertionError(f"packed_contains_matrix disagrees with its plain "
                             f"version (max abs err {err})")
    return err


def run_k2_cases(cases, device) -> list:
    """Each case: bit-exact against the plain version, then timed on the
    device.  The bound counts K2's function as the TPU kernel does it, 2 D R
    bits operations at the int8 tensor-core peak, against the packed inputs read
    once and the uint8 output written once; the library yardstick is
    torch._int_mm of the unpacked 0/1 planes, (D x bits) @ (bits x R), the
    product alone."""
    rows = []
    for case in cases:
        args = case["args"]
        sk, words, popc = args
        (d, w), r = sk.shape, words.shape[0]
        bits = 32 * w
        err = compare_k2(args)
        k_ms = time_ms(lambda: kernels.packed_contains_matrix(*args), device,
                       reps=50, device_only=True)
        call_ms = time_ms(lambda: kernels.packed_contains_matrix(*args),
                          device, reps=50)
        p_ms = time_ms(lambda: kernels.packed_contains_matrix_plain(*args),
                       device, reps=3)
        a = sketch.unpack_planes(sk).to(torch.int8)
        b = sketch.unpack_planes(words).to(torch.int8)
        lib_ms = lib_call_ms = None
        if d > 16:  # torch._int_mm takes M > 16
            lib_ms = time_ms(lambda: torch._int_mm(a, b.T), device, reps=50,
                             device_only=True)
            lib_call_ms = time_ms(lambda: torch._int_mm(a, b.T), device,
                                  reps=50)
        del a, b
        ops = 2 * d * r * bits
        nbytes = 4 * (d + r) * w + 4 * r + d * r
        row = dict(phase="kernel", kernel="packed_contains_matrix",
                   case=case["name"], d=d, r=r, w=w, ops=ops, bytes=nbytes,
                   hits=int(kernels.packed_contains_matrix(*args).sum()),
                   match=True, max_abs_err=err, kernel_ms=k_ms, call_ms=call_ms,
                   plain_ms=p_ms, library_ms=lib_ms,
                   library_call_ms=lib_call_ms,
                   library="torch._int_mm of the unpacked 0/1 planes",
                   **rate_fields(ops, nbytes, k_ms))
        emit(row)
        rows.append(row)
    return rows


def run_probe_cases(device) -> dict:
    """P1 and P2 against their plain versions at the TPU probes' shapes; the
    plain version of each is itself one PyTorch call, timed again as the
    library yardstick.  Both are bytes-bound: a few kilobytes each."""
    x = torch.arange(2, dtype=torch.int32, device=device).reshape(1, 2)
    y = torch.ones((16, 128), dtype=torch.float32, device=device)
    cases = [
        ("repeat_probe", x, kernels.repeat_probe, kernels.repeat_probe_plain,
         lambda: x.repeat(1, 2), 8 + 16),
        ("pipeline_probe", y, kernels.pipeline_probe,
         kernels.pipeline_probe_plain,
         lambda: y.reshape(2, 8, 128).sum(dim=0), 4 * (16 + 8) * 128),
    ]
    rows = {}
    for name, arg, fn, plain, lib, nbytes in cases:
        got, want = fn(arg), plain(arg)
        err = float((got.double() - want.double()).abs().max())
        if err or not torch.equal(got, want):
            raise AssertionError(f"{name} disagrees with its plain version "
                                 f"(max abs err {err})")
        row = dict(phase="kernel", kernel=name, case="tpu_probe_shape",
                   match=True, max_abs_err=err, result=got.flatten()[:4]
                   .tolist(), kernel_ms=time_ms(lambda: fn(arg), device,
                                                reps=50, device_only=True),
                   call_ms=time_ms(lambda: fn(arg), device, reps=50),
                   plain_ms=time_ms(lambda: plain(arg), device, reps=50),
                   library_ms=time_ms(lib, device, reps=50, device_only=True),
                   bound_ms=nbytes / PEAK_BYTES_PER_S * 1e3, bound_by="bytes")
        emit(row)
        rows[name] = row
    return rows


def launch_floor(device) -> dict:
    """The device time of one empty kernel launch (``torch.cuda._sleep(0)``),
    back to back: the practical floor under any launch, beside which the
    bytes bound of a kernel as small as P1 or P2 means nothing."""
    reps = 500
    ms = time_ms(lambda: torch.cuda._sleep(0), device, reps=reps,
                 device_only=True)
    row = dict(phase="launch_floor", kernel="torch.cuda._sleep(0)", reps=reps,
               kernel_ms=ms)
    emit(row)
    return row


def triples_sha1(triples) -> str:
    return hashlib.sha1(np.ascontiguousarray(triples, np.int32)
                        .tobytes()).hexdigest()[:12]


def golden_of(name, strategy, kw) -> dict:
    """The golden a run must match.  The filter and the pair backend do not
    change the output, so one golden serves every configuration of a
    strategy; with clean_implied strategies 0 and 1 give the same minimal set.
    Strategy 1's inferred-2/1 count and pair total depend on the backend and
    the filter (the dense lattice counts over every capture of its table), so
    only its default configuration checks them."""
    if kw.get("clean_implied"):
        return GOLDEN_S2L_CLEAN
    if strategy == 1:
        golden = GOLDEN_S2L[name]
        if kw:
            golden = {k: v for k, v in golden.items()
                      if k not in ("n_inferred_21", "total_pairs")}
        if (name == "headline" and "explicit_threshold" in kw
                and kw.get("use_frequent_condition_filter", True)):
            golden = {**golden, **GOLDEN_HA[kw["explicit_threshold"]]}
        return golden
    return GOLDEN[name] if strategy == 0 else GOLDEN_APPROX[(name, strategy)]


def check_run(label, table, stats, golden) -> dict:
    """Raise unless the run's CIND count, digest and the golden's statistics
    (candidate or lattice counts) equal the JAX package's."""
    digest = integrity.digest_hex(*integrity.digest_table(table))
    got = dict(n_cinds=len(table), digest=digest,
               **{k: stats.get(k) for k in golden
                  if k not in ("triples", "n_cinds", "digest")})
    want = {k: v for k, v in golden.items() if k != "triples"}
    if got != want:
        raise AssertionError(f"{label}: {got}, the JAX package gives {want}")
    return want


def run_main_path(name, triples, support, device, strategy: int = 0,
                  reps: int = 3, phase: str = "main", **kw) -> dict:
    """discover(strategy=...) through the public entry point, `reps` times; each
    run has the kernel launch counts set to 0 just before and read just after
    (and the probes' once-per-process check forgotten, so a run that reaches
    K2 probes again), every kernel of the path must have launched, and the
    CIND count, output digest and the golden's statistics must equal the JAX
    package's.  Extra keywords go to discover (pair backend, filter)."""
    if triples_sha1(triples) != GOLDEN[name]["triples"]:
        raise AssertionError(f"{name}: generated triples differ from the "
                             f"ones the golden was recorded on")
    golden = golden_of(name, strategy, kw)
    label = f"{name}, strategy {strategy} {kw}"
    walls, peaks = [], []
    for _ in range(reps):
        stats = {}
        kernels.reset_contains_check()
        kernels.reset_launches()
        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)
        base = torch.cuda.memory_allocated(device)
        t0 = time.perf_counter()
        table = rdfind_tpu_torch.discover(triples, support, strategy=strategy,
                                          device=device, stats=stats, **kw)
        torch.cuda.synchronize(device)
        walls.append(time.perf_counter() - t0)
        peaks.append(torch.cuda.max_memory_allocated(device) - base)
        launches = dict(kernels.LAUNCHES)
        idle = [k for k in path_kernels(strategy, kw) if launches[k] <= 0]
        if idle:
            raise AssertionError(f"{label}: the main path launched no {idle} "
                                 f"kernel")
        want = check_run(label, table, stats, golden)
    wall = sorted(walls)[len(walls) // 2]
    row = dict(phase=phase, workload=name, strategy=strategy, options=kw,
               n_triples=len(triples), min_support=support, wall_s=wall,
               wall_s_runs=walls, n_cinds=len(table), digest=want["digest"],
               golden_match=True, checked=want,
               cinds_per_s=len(table) / wall,
               pairs_per_s=stats["total_pairs"] / wall,
               total_pairs=stats["total_pairs"],
               pair_backend=stats.get("pair_backend"),
               n_pair_chunks=stats.get("n_pair_chunks", 0),
               peak_mem_bytes=max(peaks), launches=launches,
               ha={k: v for k, v in stats.items() if k.startswith("ha_")},
               kernels_on_path=list(path_kernels(strategy, kw)) or
               "none: this path launches no hand-written kernel",
               dense_plan=stats.get("dense_plan"))
    emit(row)
    return row


def profile_main_path(name, triples, support, device, strategy: int,
                      **kw) -> dict:
    """One more discover under torch.profiler (launches not counted): the
    device's busy time (union of its kernel and copy intervals) and idle share
    of the wall time, the host time of each named range (summed over its
    repeats, with their count), and the device time by kernel name."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        rdfind_tpu_torch.discover(triples, support, strategy=strategy,
                                  device=device, **kw)
        torch.cuda.synchronize(device)
        wall_ms = (time.perf_counter() - t0) * 1e3
    stages, counts, spans, by_name = {}, {}, [], {}
    for e in prof.events():
        if e.name.startswith("rdfind."):
            if e.device_type == DeviceType.CPU:
                stages[e.name] = stages.get(e.name, 0.0) \
                    + e.time_range.elapsed_us() / 1e3
                counts[e.name] = counts.get(e.name, 0) + 1
        elif e.device_type == DeviceType.CUDA:
            spans.append((e.time_range.start, e.time_range.end))
            key = e.name[:80]
            ms, calls = by_name.get(key, (0.0, 0))
            by_name[key] = (ms + e.time_range.elapsed_us() / 1e3, calls + 1)
    busy_us, reach = 0.0, None
    for lo, hi in sorted(spans):
        if reach is None or lo > reach:
            busy_us += hi - lo
            reach = hi
        elif hi > reach:
            busy_us += hi - reach
            reach = hi
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:10]
    row = dict(phase="profile", workload=name, strategy=strategy, options=kw,
               wall_ms=wall_ms,
               device_busy_ms=busy_us / 1e3,
               idle_share=1.0 - busy_us / 1e3 / wall_ms,
               stages_host_ms=stages,
               stage_calls={k: v for k, v in counts.items() if v > 1},
               top_device_ops=[dict(name=k, device_ms=v[0], calls=v[1])
                               for k, v in top])
    emit(row)
    return row


def terms_of(triples) -> np.ndarray:
    """The IRI ``<e{id}>`` of every id up to the largest in `triples`."""
    return terms_upto(int(np.max(triples)) + 1)


def terms_upto(n: int) -> np.ndarray:
    """The IRI ``<e{id}>`` of every id below n."""
    return np.array([f"<e{i}>" for i in range(n)], dtype=object)


def write_inputs(triples) -> dict:
    """The id triples as files of IRIs ``<e{id}>`` (N-Triples, gzipped
    N-Triples, tab-separated) and a prefix file; returns their paths."""
    os.makedirs(SCRATCH, exist_ok=True)
    terms = terms_of(triples)
    rows = terms[np.asarray(triples, np.int64)]
    paths = {k: os.path.join(SCRATCH, f"headline.{k}")
             for k in ("nt", "nt.gz", "tsv")}
    nt = "".join(f"{s} {p} {o} .\n" for s, p, o in rows)
    with open(paths["nt"], "w") as f:
        f.write(nt)
    with gzip.open(paths["nt.gz"], "wt", compresslevel=1) as f:
        f.write(nt)
    with open(paths["tsv"], "w") as f:
        f.write("".join(f"{s}\t{p}\t{o}\n" for s, p, o in rows))
    paths["prefixes"] = os.path.join(SCRATCH, "prefixes.ttl")
    with open(paths["prefixes"], "w") as f:
        f.write("@prefix a: <e1> .\n@prefix b: <e> .\n")
    return paths


def shortened(terms) -> np.ndarray:
    """`terms` as the prefix file shortens them: ``<e1...>`` -> ``a:...``,
    other ``<e...>`` -> ``b:...`` (the longest matching prefix wins)."""
    return np.array([f"a:{t[3:-1]}" if t.startswith("<e1") else f"b:{t[2:-1]}"
                     for t in terms], dtype=object)


def python_ingest(path, tabs: bool):
    """The port's Python ingest of one file: reader, parser, interning."""
    rows = []
    for _, line in reader.iter_lines([path]):
        t = ntriples.parse_tab_line(line) if tabs else ntriples.parse_line(line)
        if t is not None:
            rows.append(t)
    return intern_triples(np.asarray(rows, dtype=object))


def run_ingest(triples, paths) -> list:
    """The native ingest against the Python ingest on each file of the
    headline: equal ids and dictionaries, and the ids decode to the
    generator's terms.  Fails when the native library does not build."""
    toolchain = native.toolchain_report()
    print(f"g++: {toolchain['version']}; zlib.h found: {toolchain['zlib_h']};"
          f" libz: {toolchain['libz']}", flush=True)
    emit(dict(phase="ingest_toolchain", **toolchain))
    built = native.build()
    emit(dict(phase="ingest_build", **built))
    if not native.available():
        raise AssertionError(f"native ingest unavailable: "
                             f"{native.unavailable_reason()}")
    want_terms = terms_of(triples)[np.asarray(triples, np.int64)]
    env_threads = os.environ.pop("RDFIND_INGEST_THREADS", None)
    rows = []
    try:
        for kind in ("nt", "nt.gz", "tsv"):
            path, tabs = paths[kind], kind == "tsv"
            mb = os.path.getsize(path) / 1e6
            t0 = time.perf_counter()
            ids_py, dict_py = python_ingest(path, tabs)
            py_s = time.perf_counter() - t0
            if not np.array_equal(dict_py.values[ids_py], want_terms):
                raise AssertionError(f"{kind}: the Python ingest does not "
                                     f"decode to the generator's terms")
            for threads in (None, 1):
                stats = {}
                t0 = time.perf_counter()
                ids, dct = native.ingest_files([path], tabs=tabs,
                                               threads=threads, stats=stats)
                secs = time.perf_counter() - t0
                if not (np.array_equal(ids, ids_py)
                        and list(dct.values) == list(dict_py.values)):
                    raise AssertionError(f"{kind}, threads {threads}: native "
                                         f"ingest differs from the Python one")
                row = dict(phase="ingest", file=kind, mb=mb,
                           n_triples=int(ids.shape[0]),
                           n_values=len(dct), threads=stats["n_threads"],
                           read_parse_s=secs, mb_per_s=mb / secs,
                           python_read_parse_intern_s=py_s,
                           python_mb_per_s=mb / py_s, match=True,
                           **{k: stats[k] for k in
                              ("n_units", "read_ms", "decode_ms", "parse_ms",
                               "intern_ms", "merge_ms", "remap_ms",
                               "triples_per_sec")})
                emit(row)
                rows.append(row)
    finally:
        if env_threads is not None:
            os.environ["RDFIND_INGEST_THREADS"] = env_threads
    return rows


def run_cli(argv, want_lines, ingest_path: str) -> dict:
    """One CLI run with ``--counters 1``: its output file must equal
    `want_lines`, its counters must name `ingest_path`; returns its row with
    the phase split that the CLI reports."""
    out = os.path.join(SCRATCH, "cli_out.txt")
    err = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stderr(err):
        rc = cli.main([*argv, "--output", out, "--counters", "1"])
    wall = time.perf_counter() - t0
    report = err.getvalue().splitlines()
    with open(out) as f:
        got_lines = f.read().splitlines()
    if rc != 0 or got_lines != want_lines:
        raise AssertionError(f"CLI {argv}: rc {rc}, {len(got_lines)} lines, "
                             f"want {len(want_lines)} golden lines")
    if f"ingest-path: {ingest_path}" not in report:
        raise AssertionError(f"CLI {argv}: ingest path is not {ingest_path}: "
                             f"{[ln for ln in report if 'ingest' in ln]}")
    phases = {}
    for ln in report:
        m = re.match(r"phase (.+): ([0-9.]+) ms$", ln)
        if m:
            phases[m.group(1)] = float(m.group(2)) / 1e3
    stats = {k: v for k, v in (ln.split(": ", 1) for ln in report
                               if ln.startswith(("stat-ha_", "ingest-")))}
    row = dict(phase="cli", argv=[os.path.basename(a) if os.sep in a else a
                                  for a in argv],
               wall_s=wall, phases_s=phases, n_lines=len(got_lines),
               golden_match=True, ingest_path=ingest_path, counters=stats)
    emit(row)
    return row


def run_cli_phase(triples, paths, device) -> tuple:
    """The CLI with no flag but ``--support 10`` (strategy 1 without the
    filter: the chunked walk; native ingest), with the half-approximate
    round, and with the prefix file (Python ingest), each held line for line
    against the filtered strategy-1 run's CINDs decoded to the same terms.
    Returns the rows and those golden lines."""
    want = rdfind_tpu_torch.discover(triples, 10, strategy=1, device=device)
    check_run("headline, strategy 1 (for the CLI)", want, {},
              {k: GOLDEN_S2L["headline"][k] for k in ("n_cinds", "digest")})
    terms = terms_of(triples)
    lines = sorted(c.pretty() for c in want.decoded(Dictionary(terms)))
    short = sorted(c.pretty() for c in
                   want.decoded(Dictionary(shortened(terms))))
    nt = paths["nt"]
    rows = [
        run_cli([nt, "--support", "10"], lines, "native"),
        run_cli([nt, "--support", "10", "--explicit-threshold", "64"], lines,
                "native"),
        run_cli([nt, "--support", "10", "--prefixes", paths["prefixes"]],
                short, "python"),
    ]
    return rows, lines


@contextlib.contextmanager
def environ(**kv):
    """Set environment variables for one CLI run (and forget any cached fault
    plan before and after it)."""
    saved = {k: os.environ.get(k) for k in kv}
    os.environ.update(kv)
    faults.reset()
    try:
        yield
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        faults.reset()


def parse_report(text: str) -> tuple:
    """(counters, phases) from a --counters 1 report; stat-delta is a dict."""
    counters, phases = {}, {}
    for ln in text.splitlines():
        m = re.match(r"phase (.+): ([0-9.]+) ms$", ln)
        if m:
            phases[m.group(1)] = float(m.group(2)) / 1e3
        elif ": " in ln:
            k, v = ln.split(": ", 1)
            counters[k] = v
    if "stat-delta" in counters:
        counters["stat-delta"] = ast.literal_eval(counters["stat-delta"])
    return counters, phases


def plane_cli(label, argv, want_lines, **env) -> dict:
    """One in-process CLI run with ``--counters 1`` under `env`: rc 0 and its
    output file equal to `want_lines`, or raise.  Returns its wall, counters,
    phases and output path."""
    out = os.path.join(SCRATCH, f"planes_{label}.txt")
    err = io.StringIO()
    metrics.reset()
    with environ(**env):
        t0 = time.perf_counter()
        with contextlib.redirect_stderr(err):
            rc = cli.main([*argv, "--output", out, "--counters", "1"])
        wall = time.perf_counter() - t0
    counters, phases = parse_report(err.getvalue())
    with open(out) as f:
        got = f.read().splitlines()
    if rc != 0 or got != want_lines:
        raise AssertionError(f"planes {label}: rc {rc}, {len(got)} lines, "
                             f"want {len(want_lines)} golden lines")
    return dict(wall_s=wall, counters=counters, phases_s=phases, out=out)


def profile_counts(profile_dir, label) -> dict:
    """Kernel events by wrapper in a --profile-dir trace; fails when the card
    gave the profiler no device event at all."""
    path = os.path.join(profile_dir, "profile.json")
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    n_device = sum(e.get("cat") == "kernel" for e in events)
    if n_device == 0:
        raise AssertionError(f"planes {label}: the profiler trace holds no "
                             f"device event")
    return dict(device_events=n_device,
                by_kernel=report.profile_kernel_counts(path, kernels.SYMBOLS))


def check_traced_run(trace_dir, metrics_file, cert_path) -> dict:
    """The span tree of --trace, the Prometheus text of --metrics-file and
    the certificate; returns what was checked."""
    with open(os.path.join(trace_dir, "trace.json")) as f:
        json.load(f)
    roots, unclosed = report.build_span_tree(report.load_events(
        os.path.join(trace_dir, "events-host0.jsonl")))
    stages = [n["name"] for n in roots[0]["children"]
              if n["cat"] == "stage"] if roots else []
    if unclosed or [r["name"] for r in roots] != ["run"] or stages[:1] != \
            ["read+parse"] or "discover" not in stages \
            or "write-output" not in stages:
        raise AssertionError(f"planes: span tree {stages}, "
                             f"{len(unclosed)} unclosed")
    with open(metrics_file) as f:
        prom = [ln for ln in f.read().splitlines()
                if ln and not ln.startswith("#")]
    names = {ln.split(" ")[0].split("{")[0] for ln in prom}
    if not prom or not all(n.startswith("rdfind_") for n in names) \
            or "rdfind_total_pairs" not in names:
        raise AssertionError(f"planes: metrics file holds {sorted(names)}")
    with open(cert_path) as f:
        cert = json.load(f)
    return dict(stage_spans=stages, prometheus_metrics=len(names),
                prometheus_samples=len(prom), cert=cert)


def run_planes_phase(triples, paths, device, s1_lines, cli_row) -> list:
    """The runtime and observability planes through the CLI on the headline
    file: a traced, exported, profiled and checkpointed strategy-0 run, its
    resume, the fault gate on the CLI default, K2 in a profiler trace with
    kernel_selfcheck, and what the planes cost against the plain CLI default
    (``cli_row``)."""
    terms = terms_of(triples)
    s0 = rdfind_tpu_torch.discover(triples, 10, strategy=0, device=device)
    check_run("headline, strategy 0 (for the planes)", s0, {},
              {k: GOLDEN["headline"][k] for k in ("n_cinds", "digest")})
    s0_lines = sorted(c.pretty() for c in s0.decoded(Dictionary(terms)))
    del s0
    nt, rows = paths["nt"], []
    d = {k: os.path.join(SCRATCH, "planes", k)
         for k in ("trace", "prof", "ckpt", "ckpt_fault", "prof_k2",
                   "trace_cost")}
    for k in d:
        shutil.rmtree(d[k], ignore_errors=True)
    cert, cert_cost = (os.path.join(SCRATCH, "planes", f)
                       for f in ("cert.json", "cert_cost.json"))
    metrics_file = os.path.join(SCRATCH, "planes", "metrics.prom")

    # 1. Tracing, export, profiler and checkpoints on strategy 0.
    argv = [nt, "--traversal-strategy", "0", "--support", "10", "--trace",
            d["trace"], "--metrics-file", metrics_file, "--profile-dir",
            d["prof"], "--checkpoint-dir", d["ckpt"]]
    kernels.reset_launches()
    run1 = plane_cli("traced_s0", argv, s0_lines, RDFIND_CERT=cert)
    launches = dict(kernels.LAUNCHES)
    traced = check_traced_run(d["trace"], metrics_file, cert)
    prof = profile_counts(d["prof"], "traced_s0")
    got_cert = {k: traced["cert"][k] for k in ("output_digest", "n_cinds")}
    if got_cert != GOLDEN_CLI_S0:
        raise AssertionError(f"planes: certificate {got_cert}, the JAX "
                             f"package gives {GOLDEN_CLI_S0}")
    k1 = launches["fused_cind_blocks"]
    if k1 <= 0 or prof["by_kernel"]["fused_cind_blocks"] != k1:
        raise AssertionError(f"planes: {k1} K1 launches counted, "
                             f"{prof['by_kernel']} in the profiler trace")
    rows.append(dict(phase="planes", run="traced_s0", wall_s=run1["wall_s"],
                     phases_s=run1["phases_s"], n_lines=len(s0_lines),
                     golden_match=True, certificate=got_cert,
                     stage_spans=traced["stage_spans"],
                     prometheus_metrics=traced["prometheus_metrics"],
                     k1_launches=k1, profile=prof))

    # 2. The same command again resumes both stages.
    run2 = plane_cli("resumed_s0", argv, s0_lines, RDFIND_CERT=cert)
    with open(run1["out"], "rb") as a, open(run2["out"], "rb") as b:
        identical = a.read() == b.read()
    if not (identical and run2["counters"].get("resumed-ingest") == "1"
            and run2["counters"].get("resumed-discover") == "1"
            and "resume-ingest" in run2["phases_s"]
            and "resume-discover" in run2["phases_s"]):
        raise AssertionError(f"planes: resume {run2['phases_s']}, "
                             f"byte-identical {identical}")
    rows.append(dict(phase="planes", run="resumed_s0", wall_s=run2["wall_s"],
                     first_run_wall_s=run1["wall_s"],
                     phases_s=run2["phases_s"], byte_identical=True))

    # 3. The fault gate on the CLI default (strategy 1's chunked walk).
    fault = plane_cli("host_pull_fault", [nt, "--support", "10"], s1_lines,
                      RDFIND_FAULTS="host_pull:nth=2",
                      RDFIND_BACKOFF_BASE_MS="1")
    if fault["counters"].get("stat-n_host_pull_retries") != "1":
        raise AssertionError(f"planes: host_pull retries "
                             f"{fault['counters'].get('stat-n_host_pull_retries')}")
    ck = plane_cli("checkpoint_write_fault", [nt, "--support", "10",
                                              "--checkpoint-dir",
                                              d["ckpt_fault"]],
                   s1_lines, RDFIND_FAULTS="checkpoint_write")
    if ck["counters"].get("checkpoint-errors") != "1":
        raise AssertionError(f"planes: checkpoint-errors "
                             f"{ck['counters'].get('checkpoint-errors')}")
    rows.append(dict(phase="planes", run="faults",
                     host_pull_wall_s=fault["wall_s"],
                     n_host_pull_retries=1,
                     backoff_ms_total=fault["counters"].get(
                         "stat-backoff_ms_total"),
                     checkpoint_write_wall_s=ck["wall_s"],
                     checkpoint_errors=1, output_unchanged=True))

    # 4. K2 and the probes in a profiler trace; K2's selfcheck.
    kernels.reset_contains_check()
    kernels.reset_launches()
    k2 = plane_cli("k2_profile", [nt, "--support", "10", "--use-fis",
                                  "--traversal-strategy", "2",
                                  "--profile-dir", d["prof_k2"]], s0_lines)
    launches = dict(kernels.LAUNCHES)
    prof2 = profile_counts(d["prof_k2"], "k2_profile")
    for name in K2_PATH:
        if launches[name] <= 0 or prof2["by_kernel"][name] != launches[name]:
            raise AssertionError(f"planes: {name} launched {launches[name]}"
                                 f", {prof2['by_kernel']} in the trace")
    selfcheck = sketch.kernel_selfcheck(device=device)
    if not selfcheck["parity"]:
        raise AssertionError(f"planes: kernel_selfcheck {selfcheck}")
    rows.append(dict(phase="planes", run="k2_profile", wall_s=k2["wall_s"],
                     launches={k: launches[k] for k in K2_PATH},
                     profile=prof2, kernel_selfcheck=selfcheck))

    # 5. What the planes cost: the CLI default with --trace, --metrics-file
    # and RDFIND_CERT, against the plain cli row; the stage watermark.
    torch.cuda.synchronize(device)
    torch.cuda.reset_peak_memory_stats(device)
    cost = plane_cli("cost", [nt, "--support", "10", "--trace",
                              d["trace_cost"], "--metrics-file",
                              metrics_file], s1_lines, RDFIND_CERT=cert_cost)
    hbm = metrics.registry().get("hbm")
    peak = torch.cuda.max_memory_allocated(device)
    if not hbm or hbm["peak_bytes"] != peak:
        raise AssertionError(f"planes: hbm record {hbm}, "
                             f"max_memory_allocated {peak}")
    rows.append(dict(phase="planes", run="cost", wall_s=cost["wall_s"],
                     plain_wall_s=cli_row["wall_s"],
                     overhead_s=cost["wall_s"] - cli_row["wall_s"],
                     phases_s=cost["phases_s"],
                     plain_phases_s=cli_row["phases_s"], hbm=hbm,
                     max_memory_allocated=peak))
    for row in rows:
        emit(row)
    return rows, s0_lines


# ---------------------------------------------------------------------------
# Incremental discovery and the serving process.
# ---------------------------------------------------------------------------

# Change batches (synth.grow_delta_batches, seed 4): 1 % of the headline is
# 2,000 changes, 0.01 % of the real-size workload 200.
HEADLINE_DELTA_FRAC = 0.01
REAL_SIZE_DELTA_FRAC = 0.0001
SMALL_DELTA_TRIPLES = 20_000
# Wall cap of the --projection spo delta run on the real-size workload.
SPO_CAP_S = 60
# Queries of the serve phase.
N_HOLD_QUERIES = 1000
N_REFERENCED_QUERIES = 200


def write_nt(path, triples, terms) -> None:
    rows = terms[np.asarray(triples, np.int64)]
    with open(path, "w") as f:
        f.write("".join(f"{s} {p} {o} .\n" for s, p, o in rows))


def read_bytes(path) -> bytes:
    with open(path, "rb") as f:
        return f.read()


class Scraper:
    """A thread that GETs /progress and /metrics from the in-process run
    console while it is up; `codes` holds every answer's status."""

    def __init__(self):
        self.codes = {"/progress": [], "/metrics": []}
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)

    def _run(self):
        while not self._stop.is_set():
            port = console.port()
            if port is not None:
                for route in self.codes:
                    try:
                        with urllib.request.urlopen(
                                f"http://127.0.0.1:{port}{route}",
                                timeout=10) as r:
                            r.read()
                            self.codes[route].append(r.status)
                    except OSError as e:
                        self.codes[route].append(repr(e))
            self._stop.wait(0.5)

    def __enter__(self):
        self._thread.start()
        return self

    def __exit__(self, *exc):
        self._stop.set()
        self._thread.join(timeout=30)
        if self._thread.is_alive():
            raise AssertionError("console scraper did not stop")
        return False


def delta_cli(label, argv, scrape: bool = False, **env) -> dict:
    """One in-process CLI run with ``--counters 1`` under `env`, the kernel
    launch counts set to 0 just before it; rc 0 or raise."""
    err = io.StringIO()
    metrics.reset()
    kernels.reset_contains_check()
    kernels.reset_launches()
    scraper = Scraper() if scrape else contextlib.nullcontext()
    with environ(**env), scraper:
        t0 = time.perf_counter()
        with contextlib.redirect_stderr(err):
            rc = cli.main([*argv, "--counters", "1"])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    if rc != 0:
        raise AssertionError(f"delta {label}: rc {rc}\n{err.getvalue()[-3000:]}")
    counters, phases = parse_report(err.getvalue())
    out = dict(wall_s=wall, counters=counters, phases_s=phases,
               launches=dict(kernels.LAUNCHES))
    if scrape:
        out["scrapes"] = scraper.codes
    return out


def delta_row(run, base, dl, **extra) -> dict:
    """The printed row of one delta run: its wall beside the base run's, its
    path and the dirtiness and reuse figures of stat-delta."""
    st = dl["counters"]["stat-delta"]
    return dict(phase="delta", run=run, path=st["path"], wall_s=dl["wall_s"],
                base_wall_s=base["wall_s"] if base else None,
                wall_vs_base=(base["wall_s"] / dl["wall_s"]) if base else None,
                speedup_vs_base=st.get("speedup_vs_base"),
                dirty_row_frac=st["dirty_row_frac"],
                dirty_lines=st["dirty_lines"],
                affected_captures=st["affected_captures"],
                passes_rerun=st["passes_rerun"],
                passes_reused=st["passes_reused"], inserts=st["inserts"],
                deletes=st["deletes"], new_values=st["new_values"],
                delta_phases_s={k: v for k, v in dl["phases_s"].items()},
                launches=dl["launches"], **extra)


def check_chain(label, cert0, cert1) -> dict:
    with open(cert0) as f:
        base = json.load(f)
    with open(cert1) as f:
        got = json.load(f)
    if got.get("base_output_digest") != base["output_digest"] or \
            got.get("generation") != 1:
        raise AssertionError(f"delta {label}: certificate chain "
                             f"{got.get('base_output_digest')} -> base "
                             f"{base['output_digest']}, generation "
                             f"{got.get('generation')}")
    return dict(base_output_digest=got["base_output_digest"],
                output_digest=got["output_digest"])


def run_headline_delta(headline, paths, root) -> dict:
    """The headline file as a strategy-1 base bundle, a 1 % batch through the
    CLI, the from-scratch CLI run on the updated file (console scraped); then
    the same batch at strategy 0 with --use-fis on a copy of generation 0 (a
    bundle holds the full definitional set, whichever strategy wrote it)."""
    ins, dels = synth.grow_delta_batches(headline, HEADLINE_DELTA_FRAC, seed=4)
    upd = synth.apply_delta(headline, ins, dels)
    terms = terms_upto(int(max(headline.max(), ins.max())) + 1)
    f = {k: os.path.join(root, f"headline_{k}.nt") for k in ("ins", "del",
                                                            "upd")}
    write_nt(f["ins"], ins, terms)
    write_nt(f["del"], dels, terms)
    write_nt(f["upd"], upd, terms)
    bundle = os.path.join(root, "headline_bundle")
    out = {k: os.path.join(root, f"headline_{k}.txt")
           for k in ("base", "delta", "scratch")}
    cert = [os.path.join(root, f"headline_cert{i}.json") for i in (0, 1)]
    base = delta_cli("headline base", [paths["nt"], "--support", "10",
                                       "--delta-state", bundle, "--output",
                                       out["base"]],
                     RDFIND_INTEGRITY="1", RDFIND_CERT=cert[0])
    bundle_s0 = os.path.join(root, "headline_bundle_s0")
    shutil.copytree(bundle, bundle_s0)
    dl = delta_cli("headline s1", [f["ins"], "--delta", bundle, "--deletes",
                                   f["del"], "--support", "10", "--output",
                                   out["delta"]],
                   RDFIND_INTEGRITY="1", RDFIND_CERT=cert[1])
    scratch = delta_cli("headline scratch", [f["upd"], "--support", "10",
                                             "--output", out["scratch"],
                                             "--console-port", "0"],
                        scrape=True)
    st = dl["counters"]["stat-delta"]
    k1 = dl["launches"]["fused_cind_blocks"]
    if st["path"] != "full-fallback" or k1 <= 0:
        raise AssertionError(f"delta headline: path {st['path']}, {k1} K1 "
                             f"launches")
    if read_bytes(out["delta"]) != read_bytes(out["scratch"]):
        raise AssertionError("delta headline: output differs from the "
                             "from-scratch run")
    codes = scratch["scrapes"]
    if not all(codes.values()) or any(c != 200 for v in codes.values()
                                      for c in v):
        raise AssertionError(f"console scrapes during the CLI run: {codes}")
    row = delta_row("headline_s1_full_fallback", base, dl,
                    k1_launches=k1, byte_identical=True,
                    n_lines=read_bytes(out["delta"]).count(b"\n"),
                    certificate=check_chain("headline", *cert),
                    base_phases_s=base["phases_s"],
                    scratch_wall_s=scratch["wall_s"],
                    console_scrapes={k: len(v) for k, v in codes.items()})
    emit(row)

    s0 = ["--support", "10", "--traversal-strategy", "0", "--use-fis"]
    out_d0, out_s0 = (os.path.join(root, f"headline_s0_{k}.txt")
                      for k in ("delta", "scratch"))
    dl0 = delta_cli("headline s0", [f["ins"], "--delta", bundle_s0,
                                    "--deletes", f["del"], *s0, "--output",
                                    out_d0])
    scratch0 = delta_cli("headline s0 scratch", [f["upd"], *s0, "--output",
                                                 out_s0])
    st0 = dl0["counters"]["stat-delta"]
    k1_0 = dl0["launches"]["fused_cind_blocks"]
    if st0["path"] != "full-fallback" or k1_0 <= 0 or \
            read_bytes(out_d0) != read_bytes(out_s0):
        raise AssertionError(f"delta headline s0: path {st0['path']}, {k1_0}"
                             f" K1 launches, or output differs from the "
                             f"from-scratch run")
    emit(delta_row("headline_s0_fis_full_fallback", base, dl0,
                   k1_launches=k1_0, byte_identical=True,
                   n_lines=read_bytes(out_d0).count(b"\n"),
                   scratch_wall_s=scratch0["wall_s"]))
    return dict(bundle=bundle, ins=f["ins"], dels=f["del"], upd=f["upd"],
                out=out["delta"], row=row)


def run_small_delta(device, root) -> list:
    """Strategies 2 and 3 in-process through driver.run on 20,000 triples:
    one base bundle (strategy-agnostic), each strategy's delta on its own
    copy, each against its from-scratch run."""
    t = synth.generate_triples(SMALL_DELTA_TRIPLES, seed=42)
    ins, dels = synth.grow_delta_batches(t, HEADLINE_DELTA_FRAC, seed=4)
    terms = terms_upto(int(max(t.max(), ins.max())) + 1)
    f = {k: os.path.join(root, f"small_{k}.nt")
         for k in ("base", "ins", "del", "upd")}
    for k, rows in (("base", t), ("ins", ins), ("del", dels),
                    ("upd", synth.apply_delta(t, ins, dels))):
        write_nt(f[k], rows, terms)
    base_dir = os.path.join(root, "small_bundle")
    common = dict(min_support=10, device=device.type)
    driver.run(driver.Config(input_paths=[f["base"]], traversal_strategy=2,
                             delta_state=base_dir, **common))
    rows = []
    for strategy in (2, 3):
        bundle = os.path.join(root, f"small_bundle_s{strategy}")
        shutil.copytree(base_dir, bundle)
        out_d, out_s = (os.path.join(root, f"small_s{strategy}_{k}.txt")
                        for k in ("delta", "scratch"))
        kernels.reset_contains_check()
        kernels.reset_launches()
        t0 = time.perf_counter()
        res = driver.run(driver.Config(
            input_paths=[f["ins"]], delete_paths=[f["del"]],
            delta_base=bundle, traversal_strategy=strategy,
            output_file=out_d, **common))
        wall = time.perf_counter() - t0
        launches = dict(kernels.LAUNCHES)
        driver.run(driver.Config(input_paths=[f["upd"]],
                                 traversal_strategy=strategy,
                                 output_file=out_s, **common))
        st = res.counters["stat-delta"]
        if read_bytes(out_d) != read_bytes(out_s):
            raise AssertionError(f"delta small s{strategy}: output differs")
        if st["path"] == "full-fallback" and any(
                launches[k] <= 0 for k in K2_PATH):
            raise AssertionError(f"delta small s{strategy}: full fallback "
                                 f"launched {launches}")
        row = delta_row(f"small_s{strategy}", None,
                        dict(wall_s=wall, counters=res.counters,
                             phases_s=res.timings, launches=launches),
                        n_triples=SMALL_DELTA_TRIPLES, byte_identical=True,
                        n_lines=read_bytes(out_d).count(b"\n"))
        emit(row)
        rows.append(row)
    return rows


def trace_stages(trace_dir) -> dict:
    """Stage spans of an --trace event file: closed ones with their seconds,
    and the one still open when the process was stopped."""
    path = os.path.join(trace_dir, "events-host0.jsonl")
    opened, done = {}, {}
    last_ts = None
    with open(path) as f:
        for ln in f:
            try:
                ev = json.loads(ln)
            except ValueError:
                continue
            last_ts = ev.get("ts", last_ts)
            if ev.get("cat") == "stage" and ev.get("ph") == "B":
                opened[ev["name"]] = ev["ts"]
            elif ev.get("ph") == "E" and ev.get("name") in opened:
                done[ev["name"]] = (ev["ts"] - opened.pop(ev["name"])) / 1e6
    return dict(done_s=done, open=sorted(opened), open_since_s={
        k: (time.time_ns() // 1000 - v) / 1e6 for k, v in opened.items()})


def run_real_size_delta(triples, root) -> dict:
    """The real-size workload with --projection so: base, a 0.01 % batch on
    the incremental path, the from-scratch run, the chain and the reload.
    Then the same batch with --projection spo, once, under SPO_CAP_S."""
    ins, dels = synth.grow_delta_batches(triples, REAL_SIZE_DELTA_FRAC, seed=4)
    terms = terms_upto(int(max(triples.max(), ins.max())) + 1)
    f = {k: os.path.join(root, f"real_{k}.nt")
         for k in ("base", "ins", "del", "upd")}
    t0 = time.perf_counter()
    for k, rows in (("base", triples), ("ins", ins), ("del", dels),
                    ("upd", synth.apply_delta(triples, ins, dels))):
        write_nt(f[k], rows, terms)
    write_s = time.perf_counter() - t0
    bundle = os.path.join(root, "real_bundle_so")
    out = {k: os.path.join(root, f"real_{k}.txt") for k in ("delta",
                                                             "scratch")}
    cert = [os.path.join(root, f"real_cert{i}.json") for i in (0, 1)]
    so = ["--support", "100", "--projection", "so"]
    base = delta_cli("real-size base", [f["base"], *so, "--delta-state",
                                        bundle],
                     RDFIND_INTEGRITY="1", RDFIND_CERT=cert[0])
    dl = delta_cli("real-size so", [f["ins"], "--delta", bundle, "--deletes",
                                    f["del"], *so, "--output", out["delta"]],
                   RDFIND_INTEGRITY="1", RDFIND_CERT=cert[1])
    scratch = delta_cli("real-size scratch", [f["upd"], *so, "--output",
                                              out["scratch"]])
    st = dl["counters"]["stat-delta"]
    if st["path"] != "incremental" or st["passes_reused"] <= 0:
        raise AssertionError(f"delta real-size so: {st}")
    if read_bytes(out["delta"]) != read_bytes(out["scratch"]):
        raise AssertionError("delta real-size so: output differs from the "
                             "from-scratch run")
    t0 = time.perf_counter()
    reloaded = delta.load_bundle(bundle, min_support=100, projections="so",
                                 distinct=False)
    reload_s = time.perf_counter() - t0
    if reloaded.degraded or int(reloaded.meta["generation"]) != 1:
        raise AssertionError(f"delta real-size so: reload {reloaded.degraded}"
                             f", generation {reloaded.meta['generation']}")
    row = delta_row("real_size_so_incremental", base, dl,
                    byte_identical=True,
                    n_lines=read_bytes(out["delta"]).count(b"\n"),
                    certificate=check_chain("real-size so", *cert),
                    reload_degradations=0, reload_s=reload_s,
                    n_rows=int(reloaded.meta["n_rows"]),
                    base_phases_s=base["phases_s"],
                    scratch_wall_s=scratch["wall_s"], write_inputs_s=write_s)
    emit(row)

    # --projection spo: the quadratic re-intersection, capped.
    spo_bundle = os.path.join(root, "real_bundle_spo")
    spo_base = delta_cli("real-size spo base", [
        f["base"], "--support", "100", "--traversal-strategy", "0",
        "--delta-state", spo_bundle])
    trace_dir = os.path.join(root, "real_spo_trace")
    cmd = [sys.executable, "-m", "rdfind_tpu_torch.programs.rdfind",
           f["ins"], "--delta", spo_bundle, "--deletes", f["del"],
           "--support", "100", "--traversal-strategy", "0", "--trace",
           trace_dir, "--counters", "1", "--output",
           os.path.join(root, "real_spo_delta.txt")]
    t0 = time.perf_counter()
    try:
        res = subprocess.run(cmd, capture_output=True, text=True,
                             timeout=SPO_CAP_S,
                             cwd=os.path.dirname(os.path.abspath(__file__)))
        finished, rc = True, res.returncode
        counters, phases = parse_report(res.stderr)
    except subprocess.TimeoutExpired:
        finished, rc, counters, phases = False, None, {}, {}
    wall = time.perf_counter() - t0
    if finished and rc != 0:
        raise AssertionError(f"delta real-size spo: rc {rc}\n"
                             f"{res.stderr[-3000:]}")
    spo = dict(phase="delta", run="real_size_spo_capped", cap_s=SPO_CAP_S,
               finished=finished, wall_s=wall, base_wall_s=spo_base["wall_s"],
               base_phases_s=spo_base["phases_s"],
               stages=trace_stages(trace_dir), delta_phases_s=phases,
               stat_delta=counters.get("stat-delta"))
    emit(spo)
    return dict(row=row, spo=spo)


def http_json(base_url, route, timeout=30):
    try:
        with urllib.request.urlopen(base_url + route, timeout=timeout) as r:
            body = r.read().decode("utf-8")
            return r.status, (json.loads(body) if r.headers.get(
                "Content-Type", "").startswith("application/json") else body)
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read().decode("utf-8"))


def cap_query(role, cap) -> str:
    code, v1, v2 = cap
    q = {f"{role}_code": code}
    if v1 is not None:
        q[f"{role}_v1"] = v1
    if v2 is not None:
        q[f"{role}_v2"] = v2
    return urllib.parse.urlencode(q)


def served_truth(path, strategy, device) -> tuple:
    """(pretty lines, {(dep, ref): support}) of `strategy` on a file's ids,
    captures as (code, v1, v2) strings: what an index of that run serves."""
    ids, dictionary = native.ingest_files([path])
    table = rdfind_tpu_torch.discover(ids, 10, strategy=strategy,
                                      device=device)
    decoded = table.decoded(dictionary)
    truth = {((c.dep_code, c.dep_v1, c.dep_v2),
              (c.ref_code, c.ref_v1, c.ref_v2)): c.support for c in decoded}
    return sorted(c.pretty() for c in decoded), truth


def check_answers(label, url, truth, rng, n_holds) -> dict:
    """Sampled CINDs answered true with their support, as many non-CINDs
    false, unknown values and captures as misses, top-k equal to the
    table's; returns the client-side seconds per query."""
    pairs = list(truth)
    deps = sorted({d for d, _ in pairs})
    refs = sorted({r for _, r in pairs})
    sample = [pairs[i] for i in rng.choice(len(pairs), n_holds,
                                           replace=False)]
    non = []
    while len(non) < n_holds:
        d = deps[int(rng.integers(len(deps)))]
        r = refs[int(rng.integers(len(refs)))]
        if (d, r) not in truth and d != r:
            non.append((d, r))
    t0, n = time.perf_counter(), 0
    for (d, r), want in [(p, True) for p in sample] + [(p, False)
                                                       for p in non]:
        code, body = http_json(url, f"/query/holds?{cap_query('dep', d)}&"
                                    f"{cap_query('ref', r)}")
        n += 1
        if code != 200 or body["holds"] is not want:
            raise AssertionError(f"serve {label}: holds {d} < {r} gave "
                                 f"{code} {body}, want {want}")
    for d, r in sample[:N_REFERENCED_QUERIES]:
        code, body = http_json(url, f"/query/referenced?{cap_query('dep', d)}")
        n += 1
        pretty = {x["pretty"] for x in body.get("referenced", ())}
        if code != 200 or body["support"] != truth[(d, r)] or \
                conditions.pretty(*r) not in pretty:
            raise AssertionError(f"serve {label}: referenced {d} gave {code}"
                                 f" support {body.get('support')}, want "
                                 f"{truth[(d, r)]}")
    d = sample[0][0]
    misses = [f"/query/holds?{cap_query('dep', (d[0], '<nope>', None))}&"
              f"{cap_query('ref', sample[0][1])}",
              f"/query/holds?dep=2147483647&ref=0",
              f"/query/holds?dep_code=63&ref_code=63"]
    for route in misses:
        code, body = http_json(url, route)
        n += 1
        if code != 200 or body["holds"] is not False:
            raise AssertionError(f"serve {label}: miss {route}: {code} {body}")
    code, body = http_json(url, f"/query/referenced?"
                                f"{cap_query('dep', (d[0], '<nope>', None))}")
    if code != 200 or body["n"] != 0 or body["support"] is not None:
        raise AssertionError(f"serve {label}: referenced miss {body}")
    code, body = http_json(url, "/query/topk?k=10")
    got = [row["support"] for row in body["results"]]
    if code != 200 or got != sorted(truth.values(), reverse=True)[:10]:
        raise AssertionError(f"serve {label}: topk supports {got}")
    return dict(queries=n + 2, client_s_per_query=(time.perf_counter() - t0)
                / (n + 2))


def run_serve_phase(hd, paths, device, s0_lines, root) -> dict:
    """programs.serve on the headline bundle (generation 1): the answers
    against the table; then a strategy-0 --use-fis delta that undoes the
    batch, under query load, and the hot swap to generation 2."""
    want_lines, truth1 = served_truth(hd["upd"], 1, device)
    if "\n".join(want_lines) + "\n" != read_bytes(hd["out"]).decode():
        raise AssertionError("serve: the strategy-1 truth is not the delta "
                             "output")
    bundle = hd["bundle"]
    index = serving.index_path(bundle)
    t0 = time.perf_counter()
    reader_ = serving.IndexReader(index)
    open_ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    verified = reader_.verify()
    verify_ms = (time.perf_counter() - t0) * 1e3
    reader_.close()
    if not verified["ok"]:
        raise AssertionError(f"serve: index verify {verified}")

    obs_dir = os.path.join(root, "serve_obs")
    proc = subprocess.Popen(
        [sys.executable, "-m", "rdfind_tpu_torch.programs.serve", bundle,
         "--console-port", "0", "--poll-s", "0.2", "--max-s", "600",
         "--obs", obs_dir],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        cwd=os.path.dirname(os.path.abspath(__file__)))
    lines = []
    reader_thread = threading.Thread(
        target=lambda: lines.extend(iter(proc.stderr.readline, "")),
        daemon=True)
    reader_thread.start()
    try:
        deadline = time.time() + 60
        url = None
        while url is None and time.time() < deadline:
            for ln in list(lines):
                m = re.search(r"console on (http://127\.0\.0\.1:\d+)", ln)
                if m:
                    url = m.group(1)
            if proc.poll() is not None:
                raise AssertionError(f"serve: exited {proc.returncode}: "
                                     f"{lines}")
            time.sleep(0.05)
        if url is None:
            raise AssertionError(f"serve: no console line in {lines}")
        rng = np.random.default_rng(7)
        before = check_answers("generation 1", url, truth1, rng,
                               N_HOLD_QUERIES)
        code, st = http_json(url, "/status")
        if code != 200 or st["serving_index"]["generation"] != 1:
            raise AssertionError(f"serve: status {code} {st}")

        # Query load while the next generation commits and swaps in.
        probe = next(iter(truth1))
        route = (f"/query/holds?{cap_query('dep', probe[0])}&"
                 f"{cap_query('ref', probe[1])}")
        load = dict(ok=0, failed=[], gens=set())
        stop = threading.Event()

        def hammer():
            while not stop.is_set():
                try:
                    code, body = http_json(url, route, timeout=10)
                    if code == 200 and "generation" in body:
                        load["ok"] += 1
                        load["gens"].add(body["generation"])
                    else:
                        load["failed"].append((code, body))
                except OSError as e:
                    load["failed"].append(repr(e))

        th = threading.Thread(target=hammer, daemon=True)
        th.start()
        undo_out = os.path.join(root, "headline_undo.txt")
        undo = delta_cli("headline undo s0", [
            hd["dels"], "--delta", bundle, "--deletes", hd["ins"],
            "--support", "10", "--traversal-strategy", "0", "--use-fis",
            "--output", undo_out])
        t_commit = time.time()
        swapped_at = None
        while time.time() - t_commit < 60:
            code, st = http_json(url, "/status")
            if code == 200 and st["serving_index"]["generation"] == 2:
                swapped_at = time.time()
                break
            time.sleep(0.05)
        time.sleep(0.5)
        stop.set()
        th.join(timeout=30)
        if swapped_at is None:
            raise AssertionError(f"serve: no swap to generation 2: {st}")
        if load["failed"] or load["ok"] == 0 or load["gens"] != {1, 2}:
            raise AssertionError(f"serve: under swap {load['ok']} answered, "
                                 f"generations {load['gens']}, failed "
                                 f"{load['failed'][:5]}")
        ust = undo["counters"]["stat-delta"]
        k1 = undo["launches"]["fused_cind_blocks"]
        undo_lines = read_bytes(undo_out).decode().splitlines()
        if ust["path"] != "full-fallback" or k1 <= 0 or \
                undo_lines != s0_lines:
            raise AssertionError(f"delta undo s0: path {ust['path']}, {k1} K1"
                                 f" launches, {len(undo_lines)} lines against"
                                 f" {len(s0_lines)} golden lines")
        undo_row = delta_row("headline_undo_s0_fis_full_fallback", None,
                             undo, k1_launches=k1, byte_identical=True,
                             n_lines=len(undo_lines))
        emit(undo_row)
        si = st["serving_index"]
        chain = si["chain"]
        if [c["generation"] for c in chain[-2:]] != [1, 2] or \
                chain[-1]["base_output_digest"] != chain[-2]["output_digest"]:
            raise AssertionError(f"serve: chain {chain}")
        _, truth2 = served_truth(paths["nt"], 0, device)
        after = check_answers("generation 2", url, truth2, rng, 200)
        code_m, prom = http_json(url, "/metrics")
        code_s, slo = http_json(url, "/slo")
        if code_m != 200 or "rdfind_serve_requests_total" not in prom or \
                code_s != 200 or "verdict" not in slo:
            raise AssertionError(f"serve: /metrics {code_m}, /slo {code_s}")
        lat = slo["requests"]["latency_us"]
    finally:
        if proc.poll() is None:
            proc.terminate()
        try:
            rc = proc.wait(timeout=30)
        except subprocess.TimeoutExpired:
            proc.kill()
            rc = proc.wait(timeout=30)
        reader_thread.join(timeout=10)
    if rc != 143 or not os.path.exists(os.path.join(obs_dir,
                                                    "slowlog-host0.json")):
        raise AssertionError(f"serve: SIGTERM exit {rc}, slowlog dumped "
                             f"{os.path.exists(obs_dir)}")
    svc = serving.IndexService(bundle)
    t0 = time.perf_counter()
    verdict = svc.poll()
    swap_ms = (time.perf_counter() - t0) * 1e3
    svc.close()
    row = dict(phase="serve", open_ms=open_ms, verify_ms=verify_ms,
               swap_ms=swap_ms, swap_verdict=verdict,
               index_bytes=os.path.getsize(index),
               swap_lag_s=si["freshness"]["staleness_s"],
               status_to_swap_s=swapped_at - t_commit,
               n_cinds_gen1=len(truth1), n_cinds_gen2=len(truth2),
               queries_gen1=before, queries_gen2=after,
               under_swap=dict(answered=load["ok"], failed=0,
                               generations=sorted(load["gens"])),
               latency_us={ep: {k: v[k] for k in ("count", "p50", "p99",
                                                   "mean")}
                           for ep, v in lat.items()},
               chain=[{k: c[k] for k in ("generation", "output_digest",
                                         "base_output_digest")}
                      for c in chain], slo=slo["verdict"]["state"],
               sigterm_rc=rc)
    emit(row)
    return row


def run_delta_phases(data, paths, device, s0_lines) -> dict:
    root = os.path.join(SCRATCH, "delta")
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    headline = data["headline"][0]
    hd = run_headline_delta(headline, paths, root)
    small = run_small_delta(device, root)
    serve = run_serve_phase(hd, paths, device, s0_lines, root)
    real = run_real_size_delta(data[REAL_SIZE][0], root)
    return dict(headline=hd["row"], small=small, serve=serve, real=real)


# The sharded pipeline (models/sharded.py, --dop).  The 4-rank runs use a pair
# row budget of 2^23 per rank and pass (RDFIND_PAIR_ROW_BUDGET): 4 ranks share
# the one card, and the default 2^25 would hold ~10 GB of exchange buffers per
# rank.  The one-rank runs keep the default.  Their plan and skew statistics
# are the JAX package's at 1 and 4 devices with the same budgets, recorded on
# the CPU by scripts/record_sharded_goldens.py (planned_caps and n_pair_passes
# from JAX's _Pipeline; n_giant_lines / n_giant_pairs read off its resident
# lines with the pair phase's own float32 arithmetic; --check holds that
# reading against a complete discover_sharded at 3,000 triples).  Both
# workloads run with the frequent-condition filter: without it dbpedia2m's hub
# lines hold 3.4e11 giant pairs (the JAX plan at 4 devices), which no explicit
# pair phase finishes.
SHARDED_BUDGET = 1 << 23
GOLDEN_SHARDED = {
    ("headline", 1): dict(
        n_pair_passes=10, n_giant_lines=119, n_giant_pairs=159945792,
        planned_caps=dict(freq=65536, exchange_a=1048576, exchange_b=524288,
                          pairs=1048576, exchange_c=134217728,
                          giant_rows=131072, giant_pairs=67108864)),
    ("dbpedia2m", 1): dict(
        n_pair_passes=22, n_giant_lines=205, n_giant_pairs=310417174,
        planned_caps=dict(freq=2097152, exchange_a=16777216,
                          exchange_b=4194304, pairs=8388608,
                          exchange_c=67108864, giant_rows=262144,
                          giant_pairs=33554432)),
    ("headline", 4): dict(
        n_pair_passes=10, n_giant_lines=119, n_giant_pairs=159945792,
        planned_caps=dict(freq=8192, exchange_a=65536, exchange_b=32768,
                          pairs=262144, exchange_c=8388608, giant_rows=65536,
                          giant_pairs=16777216)),
    ("dbpedia2m", 4): dict(
        n_pair_passes=22, n_giant_lines=205, n_giant_pairs=310417174,
        planned_caps=dict(freq=131072, exchange_a=1048576, exchange_b=262144,
                          pairs=2097152, exchange_c=4194304, giant_rows=65536,
                          giant_pairs=8388608)),
}
SHARDED_STAGES = ("plan", "lines", "rebalance", "captures", "passes")


class DeviceUtilization:
    """The card's busy share over a block, from NVML: ``nvidia-smi`` samples
    ``utilization.gpu`` (the share of its sample period in which a kernel ran
    on the card, any process's) every 100 ms in a child process that the
    block ends."""

    def __enter__(self):
        self.proc = subprocess.Popen(
            ["nvidia-smi", "--query-gpu=utilization.gpu",
             "--format=csv,noheader,nounits", "-i", "0", "-lms", "100"],
            stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)
        return self

    def __exit__(self, *exc):
        self.proc.terminate()
        out, _ = self.proc.communicate(timeout=30)
        self.samples = [float(x) for x in out.split()
                        if x.replace(".", "", 1).isdigit()]
        return False

    @property
    def busy_share(self):
        if not self.samples:
            return None
        return sum(self.samples) / len(self.samples) / 100.0


def sharded_rank(mesh, triples, support, kw):
    """One rank of a sharded run (spawned by the launcher, which imports it by
    name): discover_sharded, with rank 0 sampling the card's utilization.
    Returns rank 0's table, stats (with every rank's peak device memory),
    wall and the card's busy share."""
    from rdfind_tpu_torch.models import sharded

    t_enter = time.time()
    dev = mesh.device
    stats = {}
    util = (DeviceUtilization() if mesh.rank == 0
            else contextlib.nullcontext())
    with util:
        t0 = time.perf_counter()
        table = sharded.discover_sharded(triples, support, mesh=mesh,
                                         stats=stats, **kw)
        torch.cuda.synchronize(dev)
        wall = time.perf_counter() - t0
    if mesh.rank != 0:
        return None
    return dict(table=table, stats=stats, wall_s=wall,
                busy_share=util.busy_share, n_util_samples=len(util.samples),
                t_enter=t_enter, t_leave=time.time())


def run_sharded(label, name, triples, support, world, kw, env) -> dict:
    """discover_sharded on `world` ranks on the card under `env` (the
    transport): the CIND count and digest must equal the golden, the plan and
    skew statistics the JAX package's at as many devices, and the pipeline
    must have finished its own passes (no fallback to one device)."""
    torch.cuda.empty_cache()
    with environ(**env):
        t0, t_spawn = time.perf_counter(), time.time()
        out = launch.spawn(sharded_rank, world, device="cuda",
                           args=(triples, support, kw))
        launch_s = time.perf_counter() - t0
        t_done = time.time()
    stats = out["stats"]
    want = check_run(f"sharded {label}", out["table"], stats,
                     {k: GOLDEN[name][k] for k in ("n_cinds", "digest")})
    got_plan = {k: stats.get(k) for k in ("n_pair_passes", "n_giant_lines",
                                          "n_giant_pairs", "planned_caps")}
    if got_plan != GOLDEN_SHARDED[name, world]:
        raise AssertionError(f"sharded {label}: {got_plan}, the JAX package "
                             f"gives {GOLDEN_SHARDED[name, world]} at {world} "
                             f"devices")
    check_no_fallback(f"sharded {label}", stats.get("degradations") or [],
                      stats.get("n_pair_passes"))
    row = dict(phase="sharded", run=label, workload=name, world=world,
               options=kw, wall_s=out["wall_s"], launch_wall_s=launch_s,
               rank_startup_s=out["t_enter"] - t_spawn,
               rank_teardown_s=t_done - out["t_leave"],
               n_cinds=want["n_cinds"], digest=want["digest"],
               golden_match=True, plan_match_jax=True,
               degradations=stats.get("degradations") or [],
               exchange_wire_bytes=stats.get("exchange_wire_bytes"),
               dist_backend=stats.get("dist_backend"),
               staged=stats.get("staged"),
               stages_host_ms={k: stats.get("stage_host_ms", {}).get(k)
                               for k in SHARDED_STAGES},
               idle_share=(None if out["busy_share"] is None
                           else 1.0 - out["busy_share"]),
               n_util_samples=out["n_util_samples"],
               peak_mem_bytes_per_rank=stats.get("peak_mem_bytes_per_rank"),
               exchange_bytes={k: v["bytes"] for k, v in
                               stats.get("exchange_sites", {}).items()},
               total_pairs=stats.get("total_pairs"), **got_plan)
    emit(row)
    return row


def check_no_fallback(what, degradations, n_pair_passes) -> None:
    """The sharded pipeline ran its own passes: no step of the ladder fell
    back to the single-device strategy (same card, same output, so the
    goldens alone cannot tell)."""
    if any(d.get("action") == "fallback" for d in degradations):
        raise AssertionError(f"{what}: fell back to one device: "
                             f"{degradations}")
    if not n_pair_passes or int(n_pair_passes) <= 0:
        raise AssertionError(f"{what}: no pair pass ran ({n_pair_passes})")


def sharded_cli(label, argv, want_lines, env, timeout=900) -> dict:
    """The CLI with --dop in a subprocess (its ranks report through the
    process's stderr): rc 0 and its output equal to `want_lines`, or raise.
    Returns its row fields: wall, phases, counters, the card's idle share
    over the run, host ms per pipeline stage, exchange bytes per site and
    peak memory per rank."""
    out = os.path.join(SCRATCH, f"sharded_{label}.txt")
    with DeviceUtilization() as util:
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "rdfind_tpu_torch.programs.rdfind", *argv,
             "--output", out, "--counters", "1"],
            capture_output=True, text=True, timeout=timeout,
            env={**os.environ, **env},
            cwd=os.path.dirname(os.path.abspath(__file__)))
        wall = time.perf_counter() - t0
    counters, phases = parse_report(proc.stderr)
    got = open(out).read().splitlines() if os.path.exists(out) else []
    if proc.returncode != 0 or got != want_lines:
        raise AssertionError(f"sharded CLI {label}: rc {proc.returncode}, "
                             f"{len(got)} lines, want {len(want_lines)}: "
                             f"{proc.stderr[-2000:]}")

    def parsed(key):
        v = counters.get(f"stat-{key}")
        return ast.literal_eval(v) if v else None

    sites = parsed("exchange_sites") or {}
    if counters.get("stat-dist_backend") != env.get(
            "RDFIND_TORCH_DIST_BACKEND", "nccl"):
        raise AssertionError(f"sharded CLI {label}: transport "
                             f"{counters.get('stat-dist_backend')}")
    check_no_fallback(f"sharded CLI {label}", parsed("degradations") or [],
                      counters.get("stat-n_pair_passes"))
    return dict(wall_s=wall, phases_s=phases, n_lines=len(got),
                golden_match=True,
                dist_backend=counters.get("stat-dist_backend"),
                staged=counters.get("stat-staged"),
                n_pair_passes=counters.get("stat-n_pair_passes"),
                stages_host_ms=parsed("stage_host_ms"),
                exchange_bytes={k: v["bytes"] for k, v in sites.items()},
                exchange_wire_bytes=counters.get("stat-exchange_wire_bytes"),
                degradations=parsed("degradations") or [],
                idle_share=(None if util.busy_share is None
                            else 1.0 - util.busy_share),
                peak_mem_bytes_per_rank=parsed("peak_mem_bytes_per_rank"),
                counters=counters, stderr=proc.stderr)


def run_sharded_phase(data, paths, s0_lines) -> list:
    """The sharded pipeline on the card: (a) a one-rank NCCL group, (b) four
    ranks on the one card over gloo staged through host memory, each on the
    headline and dbpedia2m (frequent-condition filter on); (c) the CLI with
    --dop 4 on the headline file, equal to the strategy-0 CLI output; (d) the
    same preempted after pass 0 under --retry-on-preempt 2."""
    rows = []
    fis = dict(use_fis=True)
    for name in ("headline", REAL_SIZE):
        triples, support = data[name]
        rows.append(run_sharded(f"nccl1_{name}", name, triples, support, 1,
                                fis, {}))
    staged = dict(RDFIND_TORCH_DIST_BACKEND="gloo",
                  RDFIND_PAIR_ROW_BUDGET=str(SHARDED_BUDGET))
    for name in ("headline", REAL_SIZE):
        triples, support = data[name]
        rows.append(run_sharded(f"gloo4_{name}", name, triples, support, 4,
                                fis, staged))

    argv = [paths["nt"], "--traversal-strategy", "0", "--support", "10",
            "--use-fis", "--dop", "4"]
    cli_env = dict(staged)
    run_c = sharded_cli("cli_dop4", argv, s0_lines, cli_env)
    rows.append(dict(phase="sharded", run="cli_dop4",
                     **{k: v for k, v in run_c.items()
                        if k not in ("counters", "stderr")}))
    emit(rows[-1])

    ckpt = os.path.join(SCRATCH, "sharded_ckpt")
    shutil.rmtree(ckpt, ignore_errors=True)
    fault_env = dict(cli_env, RDFIND_FAULTS="preempt@discover:pass=0",
                     RDFIND_BACKOFF_BASE_MS="1")
    run_d = sharded_cli("cli_preempt", argv + [
        "--checkpoint-dir", ckpt, "--retry-on-preempt", "2"], s0_lines,
        fault_env)
    c = run_d["counters"]
    retries = run_d["stderr"].count("supervisor retry")
    resumed = int(c.get("stat-resumed_passes", 0))
    if retries != 1 or c.get("supervisor-attempts") != "1" or resumed <= 0:
        raise AssertionError(f"sharded preempt: {retries} supervisor retries,"
                             f" attempts {c.get('supervisor-attempts')}, "
                             f"resumed passes {resumed}")
    rows.append(dict(phase="sharded", run="cli_preempt",
                     supervisor_retries=retries, resumed_passes=resumed,
                     **{k: v for k, v in run_d.items()
                        if k not in ("counters", "stderr")}))
    emit(rows[-1])
    return rows


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this smoke run needs the card",
              file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()
    print(smi[0], flush=True)
    emit(dict(phase="card", nvidia_smi=smi[0],
              name=torch.cuda.get_device_name(0),
              count=torch.cuda.device_count(), torch=torch.__version__,
              cuda=torch.version.cuda))

    t0 = time.perf_counter()
    built = build.build()
    emit(dict(phase="build", seconds=time.perf_counter() - t0,
              compiled=sorted(built), cached=sorted(set(build.SIGNATURES)
                                                    - set(built)),
              kernels=[k for name in build.SIGNATURES
                       for k in ptxas_report(build.build_log(name))],
              fused_cind_dynamic_smem_bytes=build.load("fused_cind")
              .fused_cind_smem_bytes()))

    data = {name: (gen(), support) for name, gen, support in WORKLOADS}
    preps = {name: prepare(t, s, device) for name, (t, s) in data.items()}
    k1_rows = run_k1_cases(k1_cases(preps, device), device)
    del preps
    sk_preps = {name: sketch_prepare(t, s, device)
                for name, (t, s) in data.items()}
    k2_rows = run_k2_cases(k2_cases(sk_preps, device), device)
    del sk_preps
    probe_rows = run_probe_cases(device)
    floor = launch_floor(device)

    main_rows = {}
    for strategy in (0, 1, 2, 3):
        for name, (triples, support) in data.items():
            main_rows[(name, strategy)] = run_main_path(
                name, triples, support, device, strategy=strategy)

    for strategy in (0, 1, 2, 3):
        for name, (triples, support) in data.items():
            profile_main_path(name, triples, support, device, strategy)

    # Every launch of the real-size sweep, kernel against plain on the card
    # (after the main-path counts were read, so these launches do not count).
    p = prepare(*data[REAL_SIZE], device)

    for ln in p["launches"]:
        case = k1_case("", p["m"], p["cols"], p["rows"], ln.lo, ln.width,
                       ln.block_ids, ln.block_ids.size, 0, p["plan"].c_pad)
        compare_k1(case["args"], case["kw"])
    emit(dict(phase="sweep_check", workload=REAL_SIZE,
              launches_checked=len(p["launches"]), match=True))
    del p

    # The CLI's default skips the frequent-condition filter: on the headline
    # triples that is ~20x the captures.  The filter only prunes captures that
    # cannot be in a CIND, so the output must still equal the headline golden.
    # Strategy 1's capture axis is then past SINGLE_SHOT_C: its chunked walk.
    headline, support = data["headline"]
    unfiltered = dict(use_frequent_condition_filter=False)
    run_main_path("headline", headline, support, device, strategy=0,
                  reps=1, phase="unfiltered", **unfiltered)
    run_main_path("headline", headline, support, device, strategy=1, reps=1,
                  phase="unfiltered", **unfiltered)
    profile_main_path("headline", headline, support, device, 1, **unfiltered)
    run_main_path("headline", headline, support, device, strategy=1, reps=1,
                  phase="clean_implied", clean_implied=True)
    run_main_path("headline", headline, support, device, strategy=0, reps=1,
                  phase="clean_implied", clean_implied=True)

    # The chunked pair backend, forced where "auto" would take the dense one.
    for strategy in (0, 2, 3):
        run_main_path("headline", headline, support, device,
                      strategy=strategy, reps=1, phase="chunked",
                      pair_backend="chunked")
        profile_main_path("headline", headline, support, device, strategy,
                          pair_backend="chunked")

    # Strategy 1's half-approximate 1/1 round: the output is strategy 1's.
    runs = [(name, t, sup, {}) for name, (t, sup) in data.items()]
    runs.append(("headline", headline, support, unfiltered))
    for name, triples, sup, extra in runs:
        for threshold in (0, 64):
            run_main_path(name, triples, sup, device, strategy=1, reps=1,
                          phase="half_approx", explicit_threshold=threshold,
                          **extra)
        profile_main_path(name, triples, sup, device, 1,
                          explicit_threshold=64, **extra)

    # Native ingest against the Python ingest, then the CLI on those files.
    paths = write_inputs(headline)
    run_ingest(headline, paths)
    cli_rows, s1_lines = run_cli_phase(headline, paths, device)
    _, s0_lines = run_planes_phase(headline, paths, device, s1_lines,
                                   cli_rows[0])

    # Incremental discovery through the CLI, then the serving process.
    run_delta_phases(data, paths, device, s0_lines)

    # The sharded pipeline: one NCCL rank, four staged gloo ranks, the CLI.
    run_sharded_phase(data, paths, s0_lines)

    # Each kernel's row: its time at the real-size main path's shape, its
    # launches in that path's checked run, its largest error over all cases.
    real = next(r for r in k1_rows if r["case"] == f"{REAL_SIZE}_launch0")
    real2 = next(r for r in k2_rows if r["case"] == f"{REAL_SIZE}_tile0")
    launches0 = main_rows[(REAL_SIZE, 0)]["launches"]
    launches2 = main_rows[(REAL_SIZE, 2)]["launches"]
    line = [
        dict(name="fused_cind_blocks", route="cuda",
             source="rdfind_tpu_torch/csrc/fused_cind.cu",
             replaces="rdfind_tpu/ops/pallas_kernels.py:555",
             launches=launches0["fused_cind_blocks"],
             max_abs_err=max(r["max_abs_err"] for r in k1_rows),
             ms=real["kernel_ms"], plain_ms=real["plain_ms"],
             bound_ms=real["bound_ms"], bound_by=real["bound_by"],
             library_ms=real["library_ms"], tops=real["tops"],
             share_of_bound=real["share_of_bound"]),
        dict(name="packed_contains_matrix", route="cuda",
             source="rdfind_tpu_torch/csrc/contains.cu",
             replaces="rdfind_tpu/ops/pallas_kernels.py:336",
             launches=launches2["packed_contains_matrix"],
             max_abs_err=max(r["max_abs_err"] for r in k2_rows),
             ms=real2["kernel_ms"], plain_ms=real2["plain_ms"],
             bound_ms=real2["bound_ms"], bound_by=real2["bound_by"],
             library_ms=real2["library_ms"], tops=real2["tops"],
             share_of_bound=real2["share_of_bound"]),
    ]
    for name, replaces in (("repeat_probe", "pallas_kernels.py:113"),
                           ("pipeline_probe", "pallas_kernels.py:249")):
        r = probe_rows[name]
        line.append(dict(name=name, route="cuda",
                         source="rdfind_tpu_torch/csrc/contains.cu",
                         replaces=f"rdfind_tpu/ops/{replaces}",
                         launches=launches2[name],
                         max_abs_err=r["max_abs_err"], ms=r["kernel_ms"],
                         plain_ms=r["plain_ms"], bound_ms=r["bound_ms"],
                         bound_by=r["bound_by"], library_ms=r["library_ms"],
                         launch_floor_ms=floor["kernel_ms"]))
    emit({"kernels": line})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
