"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

It needs one CUDA card and fails (non-zero exit, no result line) without one.  It
imports nothing of JAX or of the JAX package.  Phases, each printed as JSON lines:

1. the card (``nvidia-smi`` name and power limit, torch's device name);
2. the build of every kernel from ``rdfind_tpu_torch/csrc`` with nvcc (sm_90a);
3. each kernel against its plain PyTorch version on the card, bit-exact, at the
   main path's shapes and at edge cases, with its time, the plain version's time,
   the time of one library call for the same product (a yardstick the port never
   calls) and the least time the card could take (``bound_ms``);
4. the main path, ``rdfind_tpu_torch.discover(..., strategy=0)``, on the headline
   workload and on the real-size workload, with the kernel launch counts of each
   run; the CIND count and output digest of each must equal the JAX package's,
   and every launch of the real-size sweep must also equal the plain version;
5. one more run of each workload under torch.profiler: device busy time, idle
   share, host time per pipeline stage, the operators with the most device time;
   then the headline without the frequent-condition filter (the CLI's default,
   ~20x the captures), whose output must still equal the headline golden;
6. a ``kernels`` line, then the last line ``{"ok": true, "device": ...}``.

Any mismatch raises, so the script exits non-zero without the last line.
"""

from __future__ import annotations

import hashlib
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import rdfind_tpu_torch  # noqa: E402
from rdfind_tpu_torch.models import allatonce  # noqa: E402
from rdfind_tpu_torch.obs import integrity  # noqa: E402
from rdfind_tpu_torch.ops import build, cooc, kernels  # noqa: E402
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


def time_ms(fn, device, reps: int, warmup: int = 1) -> float:
    """Mean milliseconds of fn() over `reps` calls (CUDA events on the card)."""
    for _ in range(warmup):
        fn()
    if device.type != "cuda":
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        return (time.perf_counter() - t0) * 1e3 / reps
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def prepare(triples, support: int, device) -> dict:
    """The dense sweep's inputs for a workload, through the port's own stages."""
    t = torch.as_tensor(np.asarray(triples, np.int32)).to(device)
    (line_gid, cap_id, valid, n_lines, code, v1, v2,
     num_caps) = allatonce._stage_prepare(t, support, projections="spo",
                                          use_fc_filter=True)
    plan = cooc.dense_plan(n_lines, num_caps, device)
    m, dep_count, _ = allatonce._stage_membership(
        line_gid, cap_id, valid, support, l_pad=plan.l_pad, c_pad=plan.c_pad)
    cols, rows = cooc.sweep_operands(
        dep_count, allatonce._fit(code, plan.c_pad),
        allatonce._fit(v1, plan.c_pad), allatonce._fit(v2, plan.c_pad), support)
    counts = cooc.stage_block_counts(m, kl=plan.line_block,
                                     tile=plan.tile).cpu().numpy()
    return dict(m=m, plan=plan, cols=cols, rows=rows, counts=counts,
                launches=cooc.sweep_launches(counts, plan.dep_tile_starts,
                                             plan.tile))


def k1_case(name, m, cols, rows, lo, width, block_ids, n_real, ref_lo,
            ref_chunk) -> dict:
    """Arguments of one fused_cind_blocks call: dep columns [lo, lo + width),
    ref columns [ref_lo, ref_lo + ref_chunk), the given block schedule."""
    dev = m.device
    sl = slice(lo, lo + width)
    args = (m[:, sl], m, cols["sup"][sl], cols["ok"][sl], cols["gid"][sl],
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
    mt = torch.as_tensor(m).to(device)
    cols, rows = cooc.sweep_operands(
        mt.sum(dim=0, dtype=torch.int32), torch.as_tensor(code).to(device),
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
    l_pad, tile = m_dep.shape
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
    kl = cooc.line_block_for(m.shape[0])
    lines = (block_ids[:n_real].long()[:, None] * kl
             + torch.arange(kl, device=m.device)[None, :]).reshape(-1)
    ref_lo, ref_chunk = case["kw"]["ref_lo"], case["kw"]["ref_chunk"]
    a = m_dep[lines].T.contiguous()
    b = m[lines, ref_lo:ref_lo + ref_chunk].T.contiguous().T
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
        k_ms = time_ms(lambda: kernels.fused_cind_blocks(*args, **kw), device,
                       reps=5 if big else 20)
        p_ms = time_ms(lambda: kernels.fused_cind_blocks_plain(*args, **kw),
                       device, reps=2 if big else 5)
        lib = library_product(case)
        lib_ms = None if lib is None else time_ms(lib, device,
                                                  reps=5 if big else 20)
        t_ops, t_bytes = ops / PEAK_INT8_OPS, nbytes / PEAK_BYTES_PER_S
        row = dict(phase="kernel", kernel="fused_cind_blocks", case=case["name"],
                   l_pad=args[0].shape[0], tile=args[0].shape[1],
                   ref_lo=kw["ref_lo"], ref_chunk=kw["ref_chunk"],
                   nk=args[11].numel(), n_real=int(args[12][0]),
                   ops=ops, bytes=nbytes, match=True, max_abs_err=err,
                   kernel_ms=k_ms, plain_ms=p_ms, library_ms=lib_ms,
                   library="torch._int_mm, the int8 product alone",
                   bound_ms=max(t_ops, t_bytes) * 1e3,
                   bound_by="operations" if t_ops >= t_bytes else "bytes")
        emit(row)
        rows.append(row)
    return rows


def triples_sha1(triples) -> str:
    return hashlib.sha1(np.ascontiguousarray(triples, np.int32)
                        .tobytes()).hexdigest()[:12]


def run_main_path(name, triples, support, device, reps: int = 3) -> dict:
    """Strategy-0 discover through the public entry point, `reps` times; each
    run has the kernel launch counts set to 0 just before and read just after,
    and its CIND count and output digest must equal the JAX package's."""
    golden = GOLDEN[name]
    if triples_sha1(triples) != golden["triples"]:
        raise AssertionError(f"{name}: generated triples differ from the "
                             f"ones the golden was recorded on")
    walls = []
    for _ in range(reps):
        stats = {}
        kernels.reset_launches()
        torch.cuda.synchronize(device)
        t0 = time.perf_counter()
        table = rdfind_tpu_torch.discover(triples, support, strategy=0,
                                          device=device, stats=stats)
        torch.cuda.synchronize(device)
        walls.append(time.perf_counter() - t0)
        launches = dict(kernels.LAUNCHES)
        if launches["fused_cind_blocks"] <= 0:
            raise AssertionError(f"{name}: the main path launched no K1 kernel")
        digest = integrity.digest_hex(*integrity.digest_table(table))
        if (len(table), digest) != (golden["n_cinds"], golden["digest"]):
            raise AssertionError(f"{name}: {len(table)} CINDs / digest "
                                 f"{digest}, the JAX package gives {golden}")
    wall = sorted(walls)[len(walls) // 2]
    row = dict(phase="main", workload=name, n_triples=len(triples),
               min_support=support, wall_s=wall, wall_s_runs=walls,
               n_cinds=len(table), digest=digest, golden_match=True,
               cinds_per_s=len(table) / wall,
               pairs_per_s=stats["total_pairs"] / wall,
               total_pairs=stats["total_pairs"], launches=launches,
               dense_plan=stats["dense_plan"])
    emit(row)
    return row


def profile_main_path(name, triples, support, device) -> dict:
    """One more discover under torch.profiler (launches not counted): the
    device's busy time (union of its kernel and copy intervals) and idle share
    of the wall time, the host time of each named stage range, and the device
    time by kernel name."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        rdfind_tpu_torch.discover(triples, support, strategy=0, device=device)
        torch.cuda.synchronize(device)
        wall_ms = (time.perf_counter() - t0) * 1e3
    stages, spans, by_name = {}, [], {}
    for e in prof.events():
        if e.name.startswith("rdfind."):
            if e.device_type == DeviceType.CPU:
                stages[e.name] = e.time_range.elapsed_us() / 1e3
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
    row = dict(phase="profile", workload=name, wall_ms=wall_ms,
               device_busy_ms=busy_us / 1e3,
               idle_share=1.0 - busy_us / 1e3 / wall_ms,
               stages_host_ms=stages,
               top_device_ops=[dict(name=k, device_ms=v[0], calls=v[1])
                               for k, v in top])
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
              ptxas=[ln.strip() for r in built.values()
                     for ln in r["log"].splitlines() if "ptxas info" in ln]))

    data = {name: (gen(), support) for name, gen, support in WORKLOADS}
    preps = {name: prepare(t, s, device) for name, (t, s) in data.items()}
    k1_rows = run_k1_cases(k1_cases(preps, device), device)

    main_rows = {}
    for name, (triples, support) in data.items():
        main_rows[name] = run_main_path(name, triples, support, device)

    for name, (triples, support) in data.items():
        profile_main_path(name, triples, support, device)

    # Every launch of the real-size sweep, kernel against plain on the card
    # (after the main-path counts were read, so these launches do not count).
    p = preps[REAL_SIZE]
    for ln in p["launches"]:
        case = k1_case("", p["m"], p["cols"], p["rows"], ln.lo, ln.width,
                       ln.block_ids, ln.block_ids.size, 0, p["plan"].c_pad)
        compare_k1(case["args"], case["kw"])
    emit(dict(phase="sweep_check", workload=REAL_SIZE,
              launches_checked=len(p["launches"]), match=True))

    # The CLI's default skips the frequent-condition filter: on the headline
    # triples that is ~20x the captures.  The filter only prunes captures that
    # cannot be in a CIND, so the output must still equal the headline golden.
    stats = {}
    kernels.reset_launches()
    t0 = time.perf_counter()
    table = rdfind_tpu_torch.discover(data["headline"][0], 10, strategy=0,
                                      device=device, stats=stats,
                                      use_frequent_condition_filter=False)
    torch.cuda.synchronize(device)
    wall = time.perf_counter() - t0
    digest = integrity.digest_hex(*integrity.digest_table(table))
    if (len(table), digest) != (GOLDEN["headline"]["n_cinds"],
                                GOLDEN["headline"]["digest"]):
        raise AssertionError(f"unfiltered headline: {len(table)} CINDs / "
                             f"digest {digest} differ from the golden")
    emit(dict(phase="unfiltered", workload="headline", wall_s=wall,
              n_cinds=len(table), digest=digest, golden_match=True,
              launches=dict(kernels.LAUNCHES), dense_plan=stats["dense_plan"]))

    real = next(r for r in k1_rows if r["case"] == f"{REAL_SIZE}_launch0")
    emit({"kernels": [dict(
        name="fused_cind_blocks", route="cuda",
        source="rdfind_tpu_torch/csrc/fused_cind.cu",
        replaces="rdfind_tpu/ops/pallas_kernels.py:555",
        launches=main_rows[REAL_SIZE]["launches"]["fused_cind_blocks"],
        max_abs_err=max(r["max_abs_err"] for r in k1_rows),
        ms=real["kernel_ms"], plain_ms=real["plain_ms"],
        bound_ms=real["bound_ms"], bound_by=real["bound_by"],
        library_ms=real["library_ms"])]})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
