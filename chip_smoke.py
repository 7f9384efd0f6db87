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
   goldens.  Strategy 1 with clean_implied must equal strategy 0 with it.  Then
   the CLI itself (``programs/rdfind.py`` with only ``--support 10``) on an
   N-Triples file written from the headline triples: its output file must
   equal the strategy-1 golden's CINDs, line for line;
7. the chunked pair backend forced on the headline for strategies 0, 2 and 3:
   each must equal its golden, candidate counts included, with its chunk count;
8. a ``kernels`` line, then the last line ``{"ok": true, "device": ...}``.

Any mismatch raises, so the script exits non-zero without the last line.
"""

from __future__ import annotations

import hashlib
import json
import os
import re
import subprocess
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import rdfind_tpu_torch  # noqa: E402
from rdfind_tpu_torch.data import CindTable  # noqa: E402
from rdfind_tpu_torch.dictionary import Dictionary  # noqa: E402
from rdfind_tpu_torch.models import allatonce, approximate  # noqa: E402
from rdfind_tpu_torch.obs import integrity  # noqa: E402
from rdfind_tpu_torch.ops import build, cooc, kernels, sketch  # noqa: E402
from rdfind_tpu_torch.programs import rdfind as cli  # noqa: E402
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


def write_nt(path, triples) -> Dictionary:
    """The id triples as an N-Triples file of IRIs ``<e{id}>``, and the
    dictionary that decodes the ids to those terms."""
    ids = np.asarray(triples, np.int64)
    terms = np.array([f"<e{i}>" for i in range(int(ids.max()) + 1)],
                     dtype=object)
    with open(path, "w") as f:
        for s, p, o in ids:
            f.write(f"{terms[s]} {terms[p]} {terms[o]} .\n")
    return Dictionary(terms)


def run_cli_default(triples, device) -> dict:
    """The CLI with no flag but ``--support 10`` on the headline as N-Triples
    (strategy 1 without the filter: the chunked walk), held line for line
    against the filtered strategy-1 run's CINDs decoded to the same terms."""
    os.makedirs(SCRATCH, exist_ok=True)
    nt, out = os.path.join(SCRATCH, "headline.nt"), \
        os.path.join(SCRATCH, "cli_out.txt")
    dictionary = write_nt(nt, triples)
    want = rdfind_tpu_torch.discover(triples, 10, strategy=1, device=device)
    check_run("headline, strategy 1 (for the CLI)", want, {},
              {k: GOLDEN_S2L["headline"][k] for k in ("n_cinds", "digest")})
    want_lines = sorted(c.pretty() for c in CindTable.decoded(want,
                                                              dictionary))
    torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    rc = cli.main([nt, "--support", "10", "--output", out])
    wall = time.perf_counter() - t0
    with open(out) as f:
        got_lines = f.read().splitlines()
    if rc != 0 or got_lines != want_lines:
        raise AssertionError(f"CLI default run: rc {rc}, {len(got_lines)} "
                             f"lines, want {len(want_lines)} golden lines")
    row = dict(phase="cli", argv=["headline.nt", "--support", "10"],
               wall_s=wall, n_lines=len(got_lines), golden_match=True)
    emit(row)
    return row


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
    run_main_path("headline", headline, support, device, strategy=1,
                  phase="unfiltered", **unfiltered)
    profile_main_path("headline", headline, support, device, 1, **unfiltered)
    run_main_path("headline", headline, support, device, strategy=1, reps=1,
                  phase="clean_implied", clean_implied=True)
    run_main_path("headline", headline, support, device, strategy=0, reps=1,
                  phase="clean_implied", clean_implied=True)
    run_cli_default(headline, device)

    # The chunked pair backend, forced where "auto" would take the dense one.
    for strategy in (0, 2, 3):
        run_main_path("headline", headline, support, device,
                      strategy=strategy, phase="chunked",
                      pair_backend="chunked")
        profile_main_path("headline", headline, support, device, strategy,
                          pair_backend="chunked")

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
                         bound_by=r["bound_by"], library_ms=r["library_ms"]))
    emit({"kernels": line})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
