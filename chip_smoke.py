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
   (strategy 0's fused sweep on the K-major membership Mᵀ, with the share of
   its CTA x line-block products that its block skip keeps,
   ``visited_share``; ``--only k1`` runs the build and K1's rows alone), K3 (the
   membership counts, on each workload's Mᵀ; ``--only membership`` runs the
   build and K3's rows alone, with no result line), K2 (the Bloom
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
   --counters 1`` and one with ``--prefixes`` on a prefix file written here
   (with ``--use-fis``, which leaves the output as it is);
   each output file must equal the strategy-1 golden's CINDs decoded to the
   same terms, line for line;
11. ``planes``: the runtime and observability planes through the CLI on that
   file.  Strategy 0 with ``--trace``, ``--metrics-file``, ``--profile-dir``,
   ``--checkpoint-dir`` and ``RDFIND_CERT``: the output equals the strategy-0
   golden line for line, the certificate's output digest the JAX package's,
   the span tree holds the stage spans, the exposition ``rdfind_*`` metrics,
   and the profiler trace one K1 device event per counted launch.  The same
   command again resumes both stages, byte for byte.  The CLI default with an
   injected ``host_pull`` fault (one retry) and, with ``--use-fis``, a
   failed ``checkpoint_write`` (rc 0, ``checkpoint-errors`` 1), output
   unchanged.
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
   workload with ``--projection so`` and a 0.005 % batch (100 changes): the
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
15. ``sharded_s123``: sharded strategies 1-3 with the frequent-condition
   filter: strategy 2 on the headline on one NCCL rank, then on four ranks
   over staged gloo strategies 2 and 3 and strategy 1 with the
   half-approximate round off and on on the headline, and strategy 1 on the
   real-size workload, each equal to its golden with the JAX package's plan
   and sketch or round statistics and no fallback; K2, P1 and P2 launched on
   every rank of strategies 2 and 3 (counts read on every rank), K2
   bit-exact against its plain version on rank 0's real tile; the CLI with
   ``--dop 4`` (the default strategy), with ``--sharded-ingest`` on the
   headline split into four files, and as two hosts of two ranks on the one
   card (``--coordinator``), each byte-identical to the single-device CLI.
   Each run's wall, host ms per stage, exchange bytes per site, idle share
   and peak memory per rank (``--only sharded_s123`` runs the build and this
   phase alone, with no result line);
16. ``fused_step``: ``allatonce.fused_step``, strategy 0's pair path as one
   step with fixed shapes and no host sync, at 2^27 pair slots on both
   workloads: its CINDs equal ``discover``'s (strategy 0, dense) and the
   golden, with overflow 0; one capture (``capture_fused_step``) at the
   headline's size replayed on the headline, on a second input of that size
   with fewer valid rows, and at another support, each equal to the eager
   step on the same input; a capture at 2^26 slots on the headline, whose
   overflow equals the eager step's and the truncated pair count; ``entry()``
   on the card.  Eager and replay walls (median of 5), the ``discover``
   walls (dense and chunked) on the same input, peak device memory and the
   device's idle share under the eager step and under a replay
   (``--only fused_step`` runs the build and this phase alone, with no
   result line);
17. a ``kernels`` line, then the last line ``{"ok": true, "device": ...}``.
   The kernel phase also times an empty launch (``launch_floor``), the
   practical floor under the probes P1 and P2.

To stay within its time, the script runs the unfiltered strategy-1 walk, the
forced chunked backend and the half-approximate round once each (the main
paths on the two filtered workloads take the median of 3), caps the
real-size ``spo`` delta, which does not finish, at SPO_CAP_S, runs the
``--prefixes`` CLI and the ``checkpoint_write`` drill with the filter, and
takes a 100-change batch on the real-size workload.

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
from rdfind_tpu_torch import conditions, entry  # noqa: E402
from rdfind_tpu_torch.data import CindTable  # noqa: E402
from rdfind_tpu_torch.dictionary import Dictionary, intern_triples  # noqa: E402
from rdfind_tpu_torch.io import native, ntriples, reader  # noqa: E402
from rdfind_tpu_torch.models import allatonce, approximate  # noqa: E402
from rdfind_tpu_torch.obs import console, integrity, metrics, report  # noqa: E402
from rdfind_tpu_torch.ops import build, cooc, kernels, sketch  # noqa: E402
from rdfind_tpu_torch.parallel import exchange, launch  # noqa: E402
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
# The kernels each main path must launch.  Strategy 1 must launch none: its
# lattice is torch ops and torch._int_mm, and the JAX package has no Pallas
# kernel on that path either (its dense lattice counts the membership with
# K3, its chunked walk does not).  Nor does strategy 0's chunked backend
# (path_kernels); strategies 2 and 3 reach K2 on either backend.
K2_PATH = ("packed_contains_matrix", "repeat_probe", "pipeline_probe")
PATH_KERNELS = {0: ("fused_cind_blocks", "membership_counts"), 1: (),
                2: K2_PATH, 3: K2_PATH}


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
                "pipeline_probe_kernel", "membership_counts_rows_kernel",
                "membership_counts_lines_kernel")


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
    m_t, dep_count, _, counts = allatonce._stage_membership(
        line_gid, cap_id, valid, support, l_pad=plan.l_pad, c_pad=plan.c_pad,
        tile=plan.tile)
    cols, rows = cooc.sweep_operands(
        dep_count, allatonce._fit(code, plan.c_pad),
        allatonce._fit(v1, plan.c_pad), allatonce._fit(v2, plan.c_pad), support)
    counts_h = counts.cpu().numpy()
    return dict(m=m_t, plan=plan, support=support, cols=cols, rows=rows,
                counts=counts_h, block_counts=counts,
                launches=cooc.sweep_launches(counts_h, plan.dep_tile_starts,
                                             plan.tile))


def k1_case(name, m, cols, rows, lo, width, block_ids, n_real, ref_lo,
            ref_chunk, block_counts) -> dict:
    """Arguments of one fused_cind_blocks call on Mᵀ `m`: dep rows [lo, lo +
    width), ref rows [ref_lo, ref_lo + ref_chunk), the given block schedule,
    narrowed per CTA by K3's `block_counts` and split over clusters as the
    sweep narrows and splits it."""
    dev = m.device
    sl = slice(lo, lo + width)
    args = (m[sl], m, cols["sup"][sl], cols["ok"][sl], cols["gid"][sl],
            cols["code"][sl], cols["v1"][sl], cols["v2"][sl], rows["ridx"],
            rows["code"], rows["v1"],
            torch.as_tensor(np.asarray(block_ids, np.int32)).to(dev),
            torch.tensor([n_real], dtype=torch.int32).to(dev))
    kw = dict(ref_lo=ref_lo, ref_chunk=ref_chunk, block_counts=block_counts,
              dep_lo=lo)
    split = kernels.k1_split(
        *visits_of(args, kw),
        torch.cuda.get_device_properties(dev).multi_processor_count)
    return dict(name=name, args=args, kw=kw, split=split)


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
    counts = kernels.membership_row_counts(mt, kl=kl, tile=128)[1]
    return k1_case("equal_code_implied", mt, cols, rows, 0, 256,
                   np.arange(l_pad // kl), l_pad // kl, 0, c_pad, counts)


def k1_cases(preps: dict, device) -> list:
    """Kernel-vs-plain cases: one launch of each workload's sweep as the main
    path issues it, the TPU plan's own dep tile with a pow2-padded schedule, an
    empty schedule, a square diagonal block, and the equal-code case."""
    out = []
    for name, p in preps.items():
        ln = p["launches"][0]
        out.append(k1_case(f"{name}_launch0", p["m"], p["cols"], p["rows"],
                           ln.lo, ln.width, ln.block_ids, ln.block_ids.size, 0,
                           p["plan"].c_pad, p["block_counts"]))
    h = preps["headline"]
    plan, counts = h["plan"], h["block_counts"]
    nz = np.flatnonzero(h["counts"][:, 0])
    bucket = 1 << int(np.ceil(np.log2(max(nz.size, 1))))
    padded = np.pad(nz, (0, bucket - nz.size + 1))  # always n_real < nk
    out.append(k1_case("headline_tile0_padded_schedule", h["m"], h["cols"],
                       h["rows"], 0, plan.tile, padded, nz.size, 0,
                       plan.c_pad, counts))
    out.append(k1_case("headline_tile0_n_real_0", h["m"], h["cols"], h["rows"],
                       0, plan.tile, np.zeros(4), 0, 0, plan.c_pad, counts))
    lo = plan.dep_tile_starts[min(8, len(plan.dep_tile_starts) - 1)]
    nz = np.flatnonzero(h["counts"][:, lo // plan.tile])
    out.append(k1_case("headline_diagonal_block", h["m"], h["cols"], h["rows"],
                       lo, plan.tile, nz, nz.size, lo, plan.tile, counts))
    out.append(equal_code_case(device))
    return out


def visits_of(args, kw) -> tuple:
    """``kernels.k1_visits`` of one fused_cind_blocks call: (dep, ref) bool,
    on the host, over its scheduled line blocks."""
    m_dep, m = args[0], args[1]
    block_ids, n_real = args[11], int(args[12][0])
    counts = kw["block_counts"]
    dep, ref = kernels.k1_visits(
        counts, block_ids[:n_real].long(),
        count_tile=m.shape[0] // counts.shape[1], dep_lo=kw["dep_lo"],
        tile=m_dep.shape[0], ref_lo=kw["ref_lo"], ref_chunk=kw["ref_chunk"])
    return dep.cpu(), ref.cpu()


def work_of(case) -> tuple:
    """(int8 operations, bytes, CTA x line-block products, products the
    schedule alone gives) of the call at this run's data: each CTA's product
    over the line blocks it visits (``kernels.k1_visits``), the lines of
    those blocks read once per operand row, the columns, and the outputs
    written once."""
    tile, l_pad = case["args"][0].shape
    kl = cooc.line_block_for(l_pad)
    ref_chunk = case["kw"]["ref_chunk"]
    dep, ref = (v.long() for v in visits_of(case["args"], case["kw"]))
    ref_rows = torch.clamp(ref_chunk - kernels.CIND_CTA_R
                           * torch.arange(ref.shape[1]), max=kernels.CIND_CTA_R)
    ops = 2 * kernels.CIND_CTA_D * kl * int(
        (dep.sum(dim=1) * (ref * ref_rows).sum(dim=1)).sum())
    dep_any, ref_any = dep.any(dim=1, keepdim=True), ref.any(dim=1, keepdim=True)
    nbytes = kl * (kernels.CIND_CTA_D * int((dep * ref_any).sum())
                   + int((ref * ref_rows * dep_any).sum())) \
        + 4 * (6 * tile + 3 * ref_chunk) + tile * ref_chunk // 8 + 4 * tile
    return (ops, nbytes, int((dep.sum(dim=1) * ref.sum(dim=1)).sum()),
            dep.shape[0] * dep.shape[1] * ref.shape[1])


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


def compare_k1(args, kw, split: int) -> int:
    """Kernel (its CTAs split `split`-fold) vs plain on the same inputs; the
    largest absolute difference over the unpacked verdict bits, the popcounts
    and the visited-block counts (raises unless 0)."""
    dev = args[1].device
    visited = [torch.zeros(1, dtype=torch.int32, device=dev) for _ in "kp"]
    packed_k, popc_k = kernels.fused_cind_blocks(*args, **kw, split=split,
                                                 visited=visited[0])
    packed_p, popc_p = kernels.fused_cind_blocks_plain(*args, **kw,
                                                       visited=visited[1])
    err = max(int((cooc.unpack_bits(packed_k).int()
                   - cooc.unpack_bits(packed_p).int()).abs().max()),
              int((popc_k - popc_p).abs().max()),
              int((visited[0] - visited[1]).abs().max()))
    if err or not torch.equal(packed_k, packed_p) \
            or not torch.equal(popc_k, popc_p):
        raise AssertionError(f"fused_cind_blocks disagrees with its plain "
                             f"version (max abs err {err})")
    return err


def run_k1_cases(cases, device) -> list:
    rows = []
    for case in cases:
        args, kw, split = case["args"], case["kw"], case["split"]
        err = compare_k1(args, kw, split)
        ops, nbytes, visited, scheduled = work_of(case)
        big = ops > 1e12
        reps = 5 if big else 20
        k_ms = time_ms(lambda: kernels.fused_cind_blocks(*args, **kw,
                                                         split=split),
                       device, reps=reps, device_only=True)
        call_ms = time_ms(lambda: kernels.fused_cind_blocks(*args, **kw,
                                                            split=split),
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
                   visited_share=visited / scheduled if scheduled else 0.0,
                   split=split,
                   ops=ops, bytes=nbytes, match=True, max_abs_err=err,
                   kernel_ms=k_ms, call_ms=call_ms, plain_ms=p_ms,
                   library_ms=lib_ms,
                   library="torch._int_mm, the int8 product alone",
                   **rate_fields(ops, nbytes, k_ms))
        emit(row)
        rows.append(row)
    return rows


def run_k3_cases(preps: dict, device) -> list:
    """K3 against its plain version on each workload's Mᵀ, bit-exact, with
    its device time, the plain version's, and the widened torch sums it
    replaces as the yardstick (each an int32 copy of Mᵀ).  Its bound: Mᵀ read
    once, the frequent rows once more, the int32 outputs written once."""
    rows = []
    for name, p in preps.items():
        m, plan, support = p["m"], p["plan"], p["support"]
        kw = dict(kl=plan.line_block, tile=plan.tile)
        got = kernels.membership_counts(m, support, **kw)
        want = kernels.membership_counts_plain(m, support, **kw)
        err = max(int((g - w).abs().max()) for g, w in zip(got, want))
        if err or not all(torch.equal(g, w) for g, w in zip(got, want)):
            raise AssertionError(f"membership_counts disagrees with its plain "
                                 f"version on {name} (max abs err {err})")

        def widened():
            c_pad, l_pad = m.shape
            dep = m.sum(dim=1, dtype=torch.int32)
            mask = (dep >= support).to(torch.int8)
            blocks = m.reshape(c_pad // plan.tile, plan.tile,
                               l_pad // plan.line_block, plan.line_block)
            return (dep, (m * mask[:, None]).sum(dim=0, dtype=torch.int32),
                    blocks.sum(dim=(1, 3), dtype=torch.int32).T)

        k_ms = time_ms(lambda: kernels.membership_counts(m, support, **kw),
                       device, reps=20, device_only=True)
        p_ms = time_ms(lambda: kernels.membership_counts_plain(m, support,
                                                               **kw),
                       device, reps=3)
        lib_ms = time_ms(widened, device, reps=3)
        c_pad, l_pad = m.shape
        n_freq = int((got[0] >= support).sum())
        nbytes = (c_pad + n_freq) * l_pad + 4 * (c_pad + l_pad
                                                 + got[2].numel())
        row = dict(phase="kernel", kernel="membership_counts",
                   case=f"{name}_membership", c_pad=c_pad, l_pad=l_pad,
                   kl=plan.line_block, tile=plan.tile, frequent_rows=n_freq,
                   ops=0, bytes=nbytes, match=True, max_abs_err=err,
                   kernel_ms=k_ms, plain_ms=p_ms, library_ms=lib_ms,
                   library="the widened torch sums K3 replaces",
                   **rate_fields(0, nbytes, k_ms))
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


def union_us(spans) -> float:
    """Microseconds covered by the union of (start, end) intervals."""
    busy_us, reach = 0.0, None
    for lo, hi in sorted(spans):
        if reach is None or lo > reach:
            busy_us += hi - lo
            reach = hi
        elif hi > reach:
            busy_us += hi - reach
            reach = hi
    return busy_us


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
    busy_us = union_us(spans)
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
        run_cli([nt, "--support", "10", "--use-fis", "--prefixes",
                 paths["prefixes"]], short, "python"),
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
    # (with the filter: the same output, without the chunked walk's time)
    ck = plane_cli("checkpoint_write_fault", [nt, "--support", "10",
                                              "--use-fis", "--checkpoint-dir",
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
# 2,000 changes, 0.005 % of the real-size workload 100.
HEADLINE_DELTA_FRAC = 0.01
REAL_SIZE_DELTA_FRAC = 0.00005
SMALL_DELTA_TRIPLES = 20_000
# Wall cap of the --projection spo delta run on the real-size workload.
SPO_CAP_S = 10
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
    if not os.path.exists(path):  # stopped before its tracer wrote a line
        return dict(done_s=done, open=[], open_since_s={})
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
    """The real-size workload with --projection so: base, a 0.005 % batch on
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


# The sharded strategies 1-3 (the sharded_s123 phase).  Strategy 2's sketch
# stage (its capture table, padded to 128 x ranks, and its candidates) and
# strategy 3's round counts, recorded from the JAX package on the CPU with
#   python scripts/record_sharded_goldens.py headline:1:2 headline:4:2 \
#       headline:1:3
# (its --check holds each reading against complete runs).  Every strategy's
# pipeline is strategy 0's, so its plan (planned_caps, n_pair_passes) is
# GOLDEN_SHARDED's.  The half-approximate round's ha_cut_pairs needs a
# complete sharded pair phase, which a CPU run of the JAX package does not
# finish at this size: the CPU tests hold it equal at small size, and here
# its table width, build rounds and all-reduce bytes are checked.
GOLDEN_SHARDED_S123 = {
    ("headline", 2, 1): dict(sketch_plan=dict(c_real=5215, c_pad=5248),
                             n_sketch_candidates=2750411, n_captures=5215),
    ("headline", 2, 4): dict(sketch_plan=dict(c_real=5215, c_pad=5632),
                             n_sketch_candidates=2750411, n_captures=5215),
    ("headline", 3): dict(n_round1_cinds=293686, n_round2_cinds=90586),
}
S123_STAGES = SHARDED_STAGES + ("sketch", "verify", "lattice")
K2_PATH_KERNELS = ("packed_contains_matrix", "repeat_probe", "pipeline_probe")
HA_LEVELS = 4  # one count-min build per lattice level


def k2_tile_row(tile, device) -> dict:
    """K2 on a rank's real tile of the sharded sketch stage (its own dep
    block's first tile against every ref) and its plain version on the same
    inputs: bit-exact, each timed on the card."""
    args = (tile["sketch"], tile["ref_packed"], tile["ref_popc"])
    err = compare_k2(args)
    (d, w), r = args[0].shape, args[1].shape[0]
    k_ms = time_ms(lambda: kernels.packed_contains_matrix(*args), device,
                   reps=50, device_only=True)
    p_ms = time_ms(lambda: kernels.packed_contains_matrix_plain(*args),
                   device, reps=3)
    a = sketch.unpack_planes(args[0]).to(torch.int8)
    b = sketch.unpack_planes(args[1]).to(torch.int8)
    lib_ms = time_ms(lambda: torch._int_mm(a, b.T), device, reps=50,
                     device_only=True)
    ops = 2 * d * r * 32 * w
    nbytes = 4 * (d + r) * w + 4 * r + d * r
    return dict(d=d, r=r, w=w, max_abs_err=err, match=True, kernel_ms=k_ms,
                plain_ms=p_ms, library_ms=lib_ms,
                library="torch._int_mm of the unpacked 0/1 planes",
                **rate_fields(ops, nbytes, k_ms))


def s123_rank(mesh, runs):
    """The ranks of a batch of sharded strategy 1-3 runs on the card (spawned
    by the launcher, which imports it by name).  Per run: every kernel count
    set to 0 just before and read just after on every rank, the wall, rank
    0's card utilization, the table's count and digest, and rank 0's first
    real K2 tile through K2 and through the plain version (after the counts
    were read, so those launches do not count)."""
    from rdfind_tpu_torch.models import sharded
    from rdfind_tpu_torch.parallel.mesh import host_gather

    dev = mesh.device
    out = []
    for label, name, triples, support, strategy, kw, env in runs:
        with environ(**env):
            kernels.reset_contains_check()
            kernels.reset_launches()
            sharded.KEEP_K2_TILE = strategy in (2, 3)
            sharded.K2_TILE.clear()
            stats = {}
            util = (DeviceUtilization() if mesh.rank == 0
                    else contextlib.nullcontext())
            torch.cuda.synchronize(dev)
            torch.cuda.reset_peak_memory_stats(dev)
            with util:
                t0 = time.perf_counter()
                table = sharded.STRATEGIES[strategy](
                    triples, support, mesh=mesh, stats=stats, **kw)
                torch.cuda.synchronize(dev)
                wall = time.perf_counter() - t0
            counts = torch.tensor([kernels.LAUNCHES[k]
                                   for k in K2_PATH_KERNELS],
                                  dtype=torch.int64, device=dev)
            launches = host_gather(mesh, counts.reshape(1, -1))
            tile = dict(sharded.K2_TILE)
            sharded.KEEP_K2_TILE = False
            sharded.K2_TILE.clear()
        if mesh.rank == 0:
            out.append(dict(
                label=label, wall_s=wall, n_cinds=len(table),
                digest=integrity.digest_hex(*integrity.digest_table(table)),
                stats=stats, busy_share=util.busy_share,
                n_util_samples=len(util.samples),
                launches={k: launches[:, i].tolist()
                          for i, k in enumerate(K2_PATH_KERNELS)},
                k2_tile=k2_tile_row(tile, dev) if tile else None))
        del table, tile
    return out if mesh.rank == 0 else None


def s123_golden(name, strategy, world, kw, env) -> dict:
    """What a sharded strategy 1-3 run must give: the single-device golden's
    count and digest (and strategy 1's exact lattice counts), the JAX
    package's sketch or round statistics, the plan of GOLDEN_SHARDED."""
    if strategy == 1:
        want = {k: v for k, v in GOLDEN_S2L[name].items()
                if k not in ("n_inferred_21", "total_pairs")}
    else:
        want = {k: GOLDEN_APPROX[(name, strategy)][k]
                for k in ("n_cinds", "digest")}
    if strategy == 2:
        want.update(GOLDEN_SHARDED_S123[(name, 2, world)])
    if strategy == 3:
        want.update(GOLDEN_SHARDED_S123[(name, 3)])
    plan = GOLDEN_SHARDED[(name, world)]
    want.update(n_pair_passes=plan["n_pair_passes"],
                planned_caps=plan["planned_caps"])
    if env.get("RDFIND_SHARDED_HALF_APPROX") == "1":
        want.update(ha_build_rounds=HA_LEVELS, ha_sketch_bits=1 << 16)
    return want


def run_s123_batch(label, world, batch, transport) -> list:
    """One launch of `world` ranks on the card under `transport` running the
    runs of `batch` in turn; each run's golden, JAX statistics, launches on
    every rank and no fallback are checked, and its row printed."""
    torch.cuda.empty_cache()
    with environ(**transport):
        t0 = time.perf_counter()
        out = launch.spawn(s123_rank, world, device="cuda", args=(batch,))
        launch_s = time.perf_counter() - t0
    rows = []
    for (run, name, _, _, strategy, kw, env), got in zip(batch, out):
        stats = got["stats"]
        want = s123_golden(name, strategy, world, kw, env)
        have = dict(n_cinds=got["n_cinds"], digest=got["digest"],
                    **{k: stats.get(k) for k in want
                       if k not in ("n_cinds", "digest")})
        what = f"sharded_s123 {label}/{run}"
        if have != want:
            raise AssertionError(f"{what}: {have}, the JAX package gives "
                                 f"{want}")
        check_no_fallback(what, stats.get("degradations") or [],
                          stats.get("n_pair_passes"))
        if strategy in (2, 3):
            idle = {k: v for k, v in got["launches"].items()
                    if min(v) <= 0}
            if idle:
                raise AssertionError(f"{what}: a rank launched no "
                                     f"{sorted(idle)}: {got['launches']}")
        sites = stats.get("exchange_sites", {})
        if env.get("RDFIND_SHARDED_HALF_APPROX") == "1":
            one = exchange.log_sketch_allreduce(None, num_dev=world,
                                                bits=1 << 16)["bytes"]
            if (sites.get("sketch_allreduce", {}).get("bytes")
                    != HA_LEVELS * one or "ha_cut_pairs" not in stats):
                raise AssertionError(f"{what}: half-approximate round "
                                     f"{sites.get('sketch_allreduce')}, "
                                     f"cut {stats.get('ha_cut_pairs')}")
        row = dict(phase="sharded_s123", run=f"{label}/{run}", workload=name,
                   strategy=strategy, world=world, options=kw, env=env,
                   wall_s=got["wall_s"], launch_wall_s=launch_s,
                   golden_match=True, plan_match_jax=True, checked=want,
                   dist_backend=stats.get("dist_backend"),
                   staged=stats.get("staged"),
                   stages_host_ms={k: stats.get("stage_host_ms", {}).get(k)
                                   for k in S123_STAGES},
                   exchange_bytes={k: v["bytes"] for k, v in sites.items()},
                   exchange_wire_bytes=stats.get("exchange_wire_bytes"),
                   idle_share=(None if got["busy_share"] is None
                               else 1.0 - got["busy_share"]),
                   n_util_samples=got["n_util_samples"],
                   peak_mem_bytes_per_rank=stats.get(
                       "peak_mem_bytes_per_rank"),
                   launches_per_rank=got["launches"],
                   k2_tile=got["k2_tile"], total_pairs=stats.get(
                       "total_pairs"),
                   ha={k: v for k, v in stats.items()
                       if k.startswith("ha_")},
                   degradations=stats.get("degradations") or [])
        emit(row)
        rows.append(row)
    return rows


def two_host_cli(label, argv, want_lines, env, timeout=600) -> dict:
    """The CLI as two hosts of two ranks each on the one card (two
    processes joined through --coordinator): rc 0 on both, host 0's output
    equal to `want_lines`.  Returns host 0's row fields."""
    port = free_port()
    outs = [os.path.join(SCRATCH, f"{label}_host{h}.txt") for h in (0, 1)]
    with DeviceUtilization() as util:
        t0 = time.perf_counter()
        procs = [subprocess.Popen(
            [sys.executable, "-m", "rdfind_tpu_torch.programs.rdfind", *argv,
             "--coordinator", f"127.0.0.1:{port}", "--num-hosts", "2",
             "--host-index", str(h), "--output", outs[h], "--counters", "1"],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
            env={**os.environ, **env},
            cwd=os.path.dirname(os.path.abspath(__file__))) for h in (0, 1)]
        try:
            res = [p.communicate(timeout=timeout) for p in procs]
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        wall = time.perf_counter() - t0
    got = (open(outs[0]).read().splitlines() if os.path.exists(outs[0])
           else [])
    if [p.returncode for p in procs] != [0, 0] or got != want_lines:
        raise AssertionError(f"sharded_s123 CLI {label}: rc "
                             f"{[p.returncode for p in procs]}, {len(got)} "
                             f"lines, want {len(want_lines)}: "
                             f"{res[0][1][-2000:]} {res[1][1][-2000:]}")
    counters, phases = parse_report(res[0][1])
    return dict(wall_s=wall, phases_s=phases, n_lines=len(got),
                golden_match=True, counters=counters,
                idle_share=(None if util.busy_share is None
                            else 1.0 - util.busy_share))


def free_port() -> int:
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_sharded_s123_phase(data, paths, s0_lines, s1_lines) -> list:
    """Sharded strategies 1-3 on the card with the frequent-condition filter:
    (a) strategy 2 on the headline on one NCCL rank; (b) on four ranks over
    staged gloo: strategies 2 and 3 and strategy 1 with the half-approximate
    round off and on, on the headline, and strategy 1 on the real-size
    workload; (c) the CLI with --dop 4 and the default strategy, with
    --sharded-ingest on the headline split into four files, and as two
    hosts of two ranks (replicated interning), both with strategy 2 (the
    shortest: its output is strategy 0's), each byte-identical to the
    single-device CLI."""
    fis = dict(use_fis=True)
    headline, support = data["headline"]
    real, real_support = data[REAL_SIZE]
    rows = run_s123_batch("nccl1", 1, [
        ("headline_s2", "headline", headline, support, 2, fis, {})], {})
    staged = dict(RDFIND_TORCH_DIST_BACKEND="gloo",
                  RDFIND_PAIR_ROW_BUDGET=str(SHARDED_BUDGET))
    ha = dict(RDFIND_SHARDED_HALF_APPROX="1")
    rows += run_s123_batch("gloo4", 4, [
        ("headline_s2", "headline", headline, support, 2, fis, {}),
        ("headline_s3", "headline", headline, support, 3, fis, {}),
        ("headline_s1", "headline", headline, support, 1, fis, {}),
        ("headline_s1_ha", "headline", headline, support, 1, fis, ha),
        (f"{REAL_SIZE}_s1", REAL_SIZE, real, real_support, 1, fis, {}),
    ], staged)

    shards = []
    terms = terms_of(headline)
    for i in range(4):
        shards.append(os.path.join(SCRATCH, f"headline.part{i}.nt"))
        write_nt(shards[-1], headline[i::4], terms)
    base = ["--support", "10", "--use-fis"]
    runs = [("cli_dop4", [paths["nt"], *base, "--dop", "4"], s1_lines),
            ("cli_sharded_ingest4", [*shards, *base, "--dop", "4",
                                     "--traversal-strategy", "2",
                                     "--sharded-ingest", "--interning",
                                     "partitioned"], s0_lines)]
    for label, argv, want in runs:
        r = sharded_cli(label, argv, want, staged, timeout=600)
        row = dict(phase="sharded_s123", run=label,
                   world_size=r["counters"].get("stat-world_size"),
                   **{k: v for k, v in r.items()
                      if k not in ("counters", "stderr")})
        emit(row)
        rows.append(row)
    r = two_host_cli("cli_two_hosts", [*shards, *base, "--dop", "4",
                                       "--traversal-strategy", "2",
                                       "--sharded-ingest", "--interning",
                                       "replicated"], s0_lines, staged)
    c = r.pop("counters")
    if (c.get("stat-world_size"), c.get("stat-dist_backend")) != ("4",
                                                                 "gloo"):
        raise AssertionError(f"two-host CLI: {c.get('stat-world_size')} "
                             f"ranks over {c.get('stat-dist_backend')}")
    row = dict(phase="sharded_s123", run="cli_two_hosts",
               dist_backend=c.get("stat-dist_backend"),
               staged=c.get("stat-staged"),
               world_size=c.get("stat-world_size"),
               stages_host_ms=ast.literal_eval(c["stat-stage_host_ms"])
               if c.get("stat-stage_host_ms") else None, **r)
    emit(row)
    rows.append(row)
    return rows


# ---------------------------------------------------------------------------
# The fused single-device step, eager and replayed from a CUDA graph.
# ---------------------------------------------------------------------------

# Pair slots of the step: the headline has 118,255,758 pairs of frequent
# captures and dbpedia2m 79,284,596 (the port's prepare_join_lines), so 2^27
# leaves no overflow on either; at 2^26 the headline truncates that many
# minus 2^26.
FUSED_PAIR_CAPACITY = 1 << 27
FUSED_OVERFLOW_CAPACITY = 1 << 26
FUSED_TOTAL_PAIRS = {"headline": 118_255_758, "dbpedia2m": 79_284_596}
# The second input of the captured graph (fewer valid rows, padded to the
# headline's size) and the other support it replays at.
FUSED_SECOND_INPUT = (150_000, 43)
FUSED_SECOND_SUPPORT = 20
FUSED_REPS = 5
# entry() on the port's generator (the release-stable
# rdfind_tpu_torch.utils.synth.generate_triples(512, seed=7)), recorded from
# the JAX package's fused_step on the same triples on the CPU
# (tests/test_torch_fused_step.py holds both packages equal on it).
GOLDEN_ENTRY = dict(n_cinds=3490, overflow=0)


def fused_table(out) -> CindTable:
    """The CIND rows of a fused_step output (its first n_cinds rows)."""
    n = int(out[7])
    cols = [o[:n].cpu().numpy().astype(np.int64) for o in out[:7]]
    return CindTable(*cols)


def same_step_output(label, got, want) -> None:
    """Raise unless two fused_step outputs agree: n_cinds, overflow and the
    first n_cinds rows of the seven columns."""
    n = int(want[7])
    if int(got[7]) != n or int(got[8]) != int(want[8]) or not all(
            torch.equal(g[:n], w[:n]) for g, w in zip(got[:7], want[:7])):
        raise AssertionError(f"{label}: {int(got[7])} CINDs, overflow "
                             f"{int(got[8])}; the eager step gives {n}, "
                             f"overflow {int(want[8])}")


def wall_runs(fn, device, reps: int = FUSED_REPS) -> list:
    """Host-clock seconds of `reps` calls, each to a synchronize."""
    walls = []
    for _ in range(reps):
        torch.cuda.synchronize(device)
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize(device)
        walls.append(time.perf_counter() - t0)
    return walls


def idle_share(fn, device) -> dict:
    """One call under torch.profiler: wall ms, device busy ms (the union of
    its kernel and copy intervals) and the idle share; None where the
    profiler saw no device event."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize(device)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize(device)
        wall_ms = (time.perf_counter() - t0) * 1e3
    spans = [(e.time_range.start, e.time_range.end) for e in prof.events()
             if e.device_type == DeviceType.CUDA]
    busy_ms = union_us(spans) / 1e3
    return dict(wall_ms=wall_ms, device_busy_ms=busy_ms if spans else None,
                idle_share=1.0 - busy_ms / wall_ms if spans else None,
                device_events=len(spans))


def median(xs) -> float:
    return sorted(xs)[len(xs) // 2]


def run_fused_step_phase(data, device) -> list:
    """fused_step eager against discover and the goldens on both workloads,
    one captured graph replayed on three inputs, the overflow run, entry()."""
    rows = []
    eager = {}

    def step(t, n_valid, support, capacity=FUSED_PAIR_CAPACITY):
        return allatonce.fused_step(
            t, torch.tensor(n_valid, device=device),
            torch.tensor(support, device=device), pair_capacity=capacity)

    for name, (triples, support) in data.items():
        t = torch.as_tensor(triples, device=device)
        n = t.shape[0]
        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)
        base = torch.cuda.memory_allocated(device)
        out = step(t, n, support)
        torch.cuda.synchronize(device)
        peak = torch.cuda.max_memory_allocated(device) - base
        table = fused_table(out)
        want = check_run(f"fused_step {name}", table, {}, GOLDEN[name])
        walls = wall_runs(lambda: step(t, n, support), device)
        ref_walls = {}
        for backend in ("matmul", "chunked"):
            reps = 3 if backend == "matmul" else 1
            got = None

            def run():
                nonlocal got
                got = rdfind_tpu_torch.discover(
                    triples, support, strategy=0, device=device,
                    pair_backend=backend)
            ref_walls[backend] = wall_runs(run, device, reps)
            if (len(got), integrity.digest_hex(*integrity.digest_table(got))) \
                    != (len(table), want["digest"]):
                raise AssertionError(f"fused_step {name}: {len(table)} CINDs "
                                     f"against discover's {len(got)} "
                                     f"({backend})")
            del got
        if int(out[8]) != 0:
            raise AssertionError(f"fused_step {name}: overflow {int(out[8])} "
                                 f"at {FUSED_PAIR_CAPACITY} pair slots")
        prof = idle_share(lambda: step(t, n, support), device)
        eager[name] = out
        rows.append(dict(
            phase="fused_step", run=f"eager/{name}", n_triples=n,
            min_support=support, pair_capacity=FUSED_PAIR_CAPACITY,
            total_pairs=FUSED_TOTAL_PAIRS[name], n_cinds=len(table),
            digest=want["digest"], overflow=int(out[8]),
            equals_discover=True, golden_match=True, wall_s=median(walls),
            wall_s_runs=walls, discover_dense_wall_s=median(ref_walls["matmul"]),
            discover_dense_wall_s_runs=ref_walls["matmul"],
            discover_chunked_wall_s=ref_walls["chunked"][0],
            peak_mem_bytes=peak, profile=prof))
        emit(rows[-1])
        del out, t
    del eager["dbpedia2m"]
    torch.cuda.empty_cache()

    # One capture at the headline's size, replayed on three inputs.
    headline, support = data["headline"]
    n_cap = headline.shape[0]
    reserved = torch.cuda.memory_reserved(device)
    t0 = time.perf_counter()
    captured = allatonce.capture_fused_step(
        n_cap, pair_capacity=FUSED_PAIR_CAPACITY, device=device)
    torch.cuda.synchronize(device)
    capture_s = time.perf_counter() - t0
    # The warm-up's blocks go back to the card; the graph's pool stays.
    torch.cuda.empty_cache()
    graph_pool = torch.cuda.memory_reserved(device) - reserved
    second = synth.generate_triples(FUSED_SECOND_INPUT[0],
                                    seed=FUSED_SECOND_INPUT[1])
    padded = torch.full((n_cap, 3), torch.iinfo(torch.int32).max,
                        dtype=torch.int32, device=device)
    padded[:second.shape[0]] = torch.as_tensor(second, device=device)
    head_t = torch.as_tensor(headline, device=device)
    replays = [
        ("headline", headline, support, None, eager["headline"]),
        ("second_input", padded, support, second.shape[0],
         step(padded, second.shape[0], support)),
        ("other_support", headline, FUSED_SECOND_SUPPORT, None,
         step(head_t, n_cap, FUSED_SECOND_SUPPORT)),
    ]
    for label, t, sup, n_valid, want in replays:
        got = captured(t, sup, n_valid)
        same_step_output(f"replay {label}", got, want)
        rows.append(dict(phase="fused_step", run=f"replay/{label}",
                         n_valid=n_valid or n_cap, min_support=sup,
                         n_cinds=int(got[7]), overflow=int(got[8]),
                         equals_eager=True))
        emit(rows[-1])
        del got
    del replays, want
    walls = wall_runs(lambda: captured(headline, support), device)
    prof = idle_share(lambda: captured(headline, support), device)
    rows.append(dict(phase="fused_step", run="replay_wall/headline",
                     capture_s=capture_s, wall_s=median(walls),
                     wall_s_runs=walls, profile=prof,
                     graph_pool_bytes=graph_pool))
    emit(rows[-1])
    del captured, eager
    torch.cuda.empty_cache()

    # Overflow: 2^26 slots on the headline, captured and eager.
    want = step(head_t, n_cap, support, FUSED_OVERFLOW_CAPACITY)
    expected = FUSED_TOTAL_PAIRS["headline"] - FUSED_OVERFLOW_CAPACITY
    captured = allatonce.capture_fused_step(
        n_cap, pair_capacity=FUSED_OVERFLOW_CAPACITY, device=device)
    got = captured(headline, support)
    same_step_output("overflow replay", got, want)
    if int(want[8]) != expected:
        raise AssertionError(f"fused_step overflow {int(want[8])}, expected "
                             f"{expected}")
    rows.append(dict(phase="fused_step", run="overflow/headline",
                     pair_capacity=FUSED_OVERFLOW_CAPACITY,
                     overflow=int(got[8]), n_cinds=int(got[7]),
                     equals_eager=True))
    emit(rows[-1])
    del captured, got, want, head_t, padded
    torch.cuda.empty_cache()

    fn, args = entry.entry()
    out = fn(*args)
    got = dict(n_cinds=int(out[7]), overflow=int(out[8]))
    if got != GOLDEN_ENTRY:
        raise AssertionError(f"entry(): {got}, the JAX package gives "
                             f"{GOLDEN_ENTRY}")
    rows.append(dict(phase="fused_step", run="entry", **got,
                     golden_match=True))
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
    if sys.argv[1:] == ["--only", "fused_step"]:
        run_fused_step_phase(data, device)
        emit({"partial": "fused_step", "ok": True})
        return 0
    if sys.argv[1:] == ["--only", "sharded_s123"]:
        # A shorter run for working on the phase alone (no result line).
        headline, support = data["headline"]
        paths = write_inputs(headline)
        lines = []
        for strategy in (0, 1):
            want = rdfind_tpu_torch.discover(headline, support,
                                             strategy=strategy, device=device)
            lines.append(sorted(c.pretty() for c in
                                want.decoded(Dictionary(terms_of(headline)))))
            del want
        run_sharded_s123_phase(data, paths, *lines)
        emit({"partial": "sharded_s123", "ok": True})
        return 0
    preps = {name: prepare(t, s, device) for name, (t, s) in data.items()}
    if sys.argv[1:] == ["--only", "membership"]:
        run_k3_cases(preps, device)
        emit({"partial": "membership", "ok": True})
        return 0
    if sys.argv[1:] == ["--only", "k1"]:
        run_k1_cases(k1_cases(preps, device), device)
        emit({"partial": "k1", "ok": True})
        return 0
    k1_rows = run_k1_cases(k1_cases(preps, device), device)
    k3_rows = run_k3_cases(preps, device)
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
                       ln.block_ids, ln.block_ids.size, 0, p["plan"].c_pad,
                       p["block_counts"])
        compare_k1(case["args"], case["kw"], case["split"])
    emit(dict(phase="sweep_check", workload=REAL_SIZE,
              launches_checked=len(p["launches"]), match=True))
    del p

    # Strategy 0's pair path as one sync-free step, eager and from a graph.
    run_fused_step_phase(data, device)

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
    # Sharded strategies 1-3, the sharded ingest and two hosts on one card.
    s123_rows = run_sharded_s123_phase(data, paths, s0_lines, s1_lines)

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
    real3 = next(r for r in k3_rows if r["case"] == f"{REAL_SIZE}_membership")
    line.append(dict(name="membership_counts", route="cuda",
                     source="rdfind_tpu_torch/csrc/membership.cu",
                     replaces="none: the XLA sums of _stage_membership",
                     launches=launches0["membership_counts"],
                     max_abs_err=max(r["max_abs_err"] for r in k3_rows),
                     ms=real3["kernel_ms"], plain_ms=real3["plain_ms"],
                     bound_ms=real3["bound_ms"], bound_by=real3["bound_by"],
                     library_ms=real3["library_ms"],
                     share_of_bound=real3["share_of_bound"]))
    for name, replaces in (("repeat_probe", "pallas_kernels.py:114"),
                           ("pipeline_probe", "pallas_kernels.py:250")):
        r = probe_rows[name]
        line.append(dict(name=name, route="cuda",
                         source="rdfind_tpu_torch/csrc/contains.cu",
                         replaces=f"rdfind_tpu/ops/{replaces}",
                         launches=launches2[name],
                         max_abs_err=r["max_abs_err"], ms=r["kernel_ms"],
                         plain_ms=r["plain_ms"], bound_ms=r["bound_ms"],
                         bound_by=r["bound_by"], library_ms=r["library_ms"],
                         launch_floor_ms=floor["kernel_ms"]))
    # The sharded strategy-2 path on four staged ranks: K2 on every rank's
    # dep block (launches summed over the ranks, rank 0's real tile timed),
    # the probes once per rank process.
    s2 = next(r for r in s123_rows if r["run"] == "gloo4/headline_s2")
    t2 = s2["k2_tile"]
    per_rank = s2["launches_per_rank"]
    line.append(dict(name="packed_contains_matrix[sharded_s123]",
                     route="cuda", source="rdfind_tpu_torch/csrc/contains.cu",
                     replaces="rdfind_tpu/ops/pallas_kernels.py:336",
                     launches=sum(per_rank["packed_contains_matrix"]),
                     launches_per_rank=per_rank["packed_contains_matrix"],
                     max_abs_err=t2["max_abs_err"], ms=t2["kernel_ms"],
                     plain_ms=t2["plain_ms"], bound_ms=t2["bound_ms"],
                     bound_by=t2["bound_by"], library_ms=t2["library_ms"],
                     tops=t2["tops"], share_of_bound=t2["share_of_bound"]))
    for name, replaces in (("repeat_probe", "pallas_kernels.py:114"),
                           ("pipeline_probe", "pallas_kernels.py:250")):
        r = probe_rows[name]
        line.append(dict(name=f"{name}[sharded_s123]", route="cuda",
                         source="rdfind_tpu_torch/csrc/contains.cu",
                         replaces=f"rdfind_tpu/ops/{replaces}",
                         launches=sum(per_rank[name]),
                         launches_per_rank=per_rank[name],
                         max_abs_err=r["max_abs_err"], ms=r["kernel_ms"],
                         plain_ms=r["plain_ms"], bound_ms=r["bound_ms"],
                         bound_by=r["bound_by"], library_ms=r["library_ms"]))
    emit({"kernels": line})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
