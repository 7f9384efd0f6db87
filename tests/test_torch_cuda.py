"""The port's CUDA kernels on the card, each against its plain PyTorch version.

Marked ``cuda``: every test skips without a CUDA device.  This file imports
neither JAX nor the JAX package, so on a CUDA machine without JAX it runs without
the suite's conftest (which pins JAX to the CPU):

    python -m pytest -m cuda --noconftest -p no:cacheprovider tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

import rdfind_tpu_torch
from rdfind_tpu_torch.models import allatonce
from rdfind_tpu_torch.ops import cooc, kernels, sketch
from rdfind_tpu_torch.utils import synth

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda", 0)


def _block(seed, l_pad, c_pad, device, planted=96, lines=None,
           min_support=2):
    """Mᵀ (c_pad x l_pad) with members in every line block, captures
    [0, planted) planted in captures c_pad / 2 + [0, planted), and its sweep
    operands.  A dep's support is counted over all lines, or over `lines` only
    (a schedule's lines): then the planted pairs pass the support test under
    that schedule, and any count taken from another line block fails it."""
    rng = np.random.default_rng(seed)
    m = (rng.random((l_pad, c_pad)) < 0.03).astype(np.int8)
    m[:, c_pad // 2:c_pad // 2 + planted] |= m[:, :planted]
    mt = torch.as_tensor(m.T.copy()).to(device)
    sup = mt if lines is None else mt[:, torch.as_tensor(lines).to(device)]
    cols, rows = cooc.sweep_operands(
        sup.sum(dim=1, dtype=torch.int32),
        torch.as_tensor(rng.choice([12, 17, 20, 35], c_pad).astype(np.int32))
        .to(device),
        torch.as_tensor(rng.integers(0, 3, c_pad).astype(np.int32)).to(device),
        torch.as_tensor(rng.integers(-1, 3, c_pad).astype(np.int32))
        .to(device), min_support)
    return mt, cols, rows


def _k1_case(cuda, m, cols, rows, lo, width, blocks, n_real, ref_lo,
             ref_chunk):
    """One launch on Mᵀ against the plain version; returns the verdict bits
    set."""
    sl = slice(lo, lo + width)
    args = (m[sl], m, cols["sup"][sl], cols["ok"][sl], cols["gid"][sl],
            cols["code"][sl], cols["v1"][sl], cols["v2"][sl], rows["ridx"],
            rows["code"], rows["v1"],
            torch.tensor(blocks, dtype=torch.int32, device=cuda),
            torch.tensor([n_real], dtype=torch.int32, device=cuda))
    kernels.reset_launches()
    got = kernels.fused_cind_blocks(*args, ref_lo=ref_lo, ref_chunk=ref_chunk)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["fused_cind_blocks"] == 1
    want = kernels.fused_cind_blocks_plain(*args, ref_lo=ref_lo,
                                           ref_chunk=ref_chunk)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    return int(want[1].sum())


@pytest.mark.parametrize("lo,width,blocks,n_real,ref_lo,ref_chunk", [
    (0, 256, [0, 1, 2, 3, 4], 5, 0, 512),  # full schedule, full ref axis
    (128, 128, [3, 1, 0, 0], 2, 0, 512),   # padded schedule entries
    (0, 128, [0, 0], 0, 0, 512),           # empty schedule
    (256, 128, [0, 2], 2, 256, 128),       # diagonal block
])
def test_k1_kernel_matches_plain(cuda, lo, width, blocks, n_real, ref_lo,
                                 ref_chunk):
    m, cols, rows = _block(0, 1280, 512, cuda)  # five 256-line blocks
    _k1_case(cuda, m, cols, rows, lo, width, blocks, n_real, ref_lo,
             ref_chunk)


@pytest.mark.parametrize("l_pad,c_pad,lo,width,blocks,n_real,ref_lo,ref_chunk", [
    # ref axis a multiple of 128 but not of 256: a ragged last ref block
    (1280, 384, 0, 256, [0, 1, 2, 3, 4], 5, 0, 384),
    (1280, 640, 128, 128, [4, 2, 0, 3, 1], 5, 128, 384),
    # n_real < nk with padded entries, and n_real = 0, on the ragged axis
    (1280, 384, 128, 128, [3, 1, 0, 0, 0, 0, 0, 0], 2, 0, 384),
    (1280, 384, 0, 384, [2, 2, 2], 0, 0, 384),
    # several line blocks per wrap of the stage ring (256-line blocks), and
    # several ring wraps per line block (1,024-line blocks)
    (2304, 512, 0, 384, [8, 4, 7, 0, 1, 2, 3, 5, 6], 9, 0, 512),
    (4096, 768, 256, 512, [3, 0, 2, 1], 3, 0, 768),
])
def test_k1_kernel_edge_cases_match_plain(cuda, l_pad, c_pad, lo, width,
                                          blocks, n_real, ref_lo, ref_chunk):
    """Support is counted over the scheduled lines and every support passes,
    so the verdict bits are set exactly where a pair's counts are those of the
    schedule: a kernel that visits a padded entry, ignores n_real or drops a
    scheduled block clears bits the plain version sets."""
    kl = cooc.line_block_for(l_pad)
    lines = np.concatenate([np.arange(b * kl, (b + 1) * kl)
                            for b in blocks[:n_real]] or [np.zeros(0, int)])
    m, cols, rows = _block(l_pad + c_pad, l_pad, c_pad, cuda,
                           planted=c_pad // 2, lines=lines, min_support=0)
    n_set = _k1_case(cuda, m, cols, rows, lo, width, blocks, n_real, ref_lo,
                     ref_chunk)
    assert n_set > 0


_BAD_SCHEDULE = """
import sys, torch
from rdfind_tpu_torch.ops import cooc, kernels
blocks, n_real = eval(sys.argv[1])
cuda = torch.device("cuda", 0)
m = torch.zeros((512, 1280), dtype=torch.int8, device=cuda)
z = torch.zeros(512, dtype=torch.int32, device=cuda)
cols, rows = cooc.sweep_operands(z, z, z, z, 0)
try:
    cooc.fused_cind_tile(
        m, 0, 128, cols, rows,
        torch.tensor(blocks, dtype=torch.int32, device=cuda),
        torch.tensor([n_real], dtype=torch.int32, device=cuda))
    torch.cuda.synchronize()
except RuntimeError as e:
    print("refused:", e)
else:
    print("ran")
print("launches", kernels.LAUNCHES["fused_cind_blocks"])
"""


@pytest.mark.parametrize("schedule", [
    "([0, 1], 3)",   # n_real past the schedule's entries
    "([0, 5], 2)",   # a block id past the five line blocks
    "([1, -1], 2)",  # a negative block id
])
def test_k1_kernel_traps_on_a_bad_device_schedule(cuda, schedule):
    """The wrapper does not read a device schedule back; the kernel checks it
    and traps, so the launch fails rather than counting zero-filled lines.  A
    trap ends the process's CUDA context, hence the subprocess."""
    import subprocess
    import sys
    from pathlib import Path

    root = Path(rdfind_tpu_torch.__file__).resolve().parents[1]
    res = subprocess.run([sys.executable, "-c", _BAD_SCHEDULE, schedule],
                         cwd=root, capture_output=True, text=True, timeout=300)
    assert "launches 1" in res.stdout, res.stdout + res.stderr
    assert "refused:" in res.stdout, res.stdout + res.stderr


def test_k1_bad_host_schedule_raises_before_any_launch(cuda):
    with pytest.raises(ValueError, match="schedule"):
        kernels.upload_schedules([(np.array([0, 5], np.int32), 2)], 5, cuda)
    with pytest.raises(ValueError, match="schedule"):
        kernels.upload_schedules([(np.array([0], np.int32), 2)], 5, cuda)


def test_k1_sweep_launches_queue_without_host_sync(cuda, monkeypatch):
    """The sweep checks and uploads its schedules first; its launches then run
    with PyTorch's sync debug mode raising on any host sync."""
    monkeypatch.setattr(cooc, "LAUNCH_COLS", 128)  # one launch per dep tile
    m, cols, rows = _block(9, 1280, 512, cuda)
    counts = cooc.stage_block_counts(m, kl=256, tile=128).cpu().numpy()
    launches = cooc.sweep_launches(counts, range(0, 512, 128), 128)
    scheds = kernels.upload_schedules(
        [(ln.block_ids, ln.block_ids.size) for ln in launches], 5, cuda)
    torch.cuda.synchronize()
    kernels.reset_launches()
    torch.cuda.set_sync_debug_mode("error")
    try:
        outs = [cooc.fused_cind_tile(m, ln.lo, ln.width, cols, rows, *sched)
                for ln, sched in zip(launches, scheds)]
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert len(launches) == 4
    assert kernels.LAUNCHES["fused_cind_blocks"] == 4
    for ln, (packed, popc), sched in zip(launches, outs, scheds):
        want = kernels.fused_cind_blocks_plain(
            m[ln.lo:ln.lo + ln.width], m, *(cols[k][ln.lo:ln.lo + ln.width]
                                           for k in ("sup", "ok", "gid", "code",
                                                     "v1", "v2")),
            rows["ridx"], rows["code"], rows["v1"],
            *sched, ref_lo=0, ref_chunk=512)
        assert torch.equal(packed, want[0]) and torch.equal(popc, want[1])


def test_discover_on_cuda_equals_cpu(cuda):
    triples = synth.generate_triples(3000, seed=5)
    kernels.reset_launches()
    got = rdfind_tpu_torch.discover(triples, 3, strategy=0, device=cuda,
                                    clean_implied=True)
    assert kernels.LAUNCHES["fused_cind_blocks"] > 0
    want = rdfind_tpu_torch.discover(triples, 3, strategy=0, device="cpu",
                                     clean_implied=True)
    assert len(want) > 0 and got.to_rows() == want.to_rows()


def _contains_inputs(seed, d, r, bits, n_pad, device):
    """Dep sketches holding the bit sets of a few refs each (many containments),
    random words elsewhere; the last n_pad refs are padding (popc -1)."""
    rng = np.random.default_rng(seed)
    words, popc = sketch.pack_ref_bits(
        torch.as_tensor(rng.integers(0, 1 << 20, r).astype(np.int32)),
        bits=bits, num_hashes=4)
    sk = torch.as_tensor(rng.integers(-(1 << 31), 1 << 31, (d, bits // 32))
                         .astype(np.int32))
    sk &= torch.as_tensor(rng.integers(-(1 << 31), 1 << 31, (d, bits // 32))
                          .astype(np.int32))
    for i in range(d):
        for j in rng.choice(r, 3, replace=False):
            sk[i] |= words[j]
    if n_pad:
        words[-n_pad:] = 0
        popc[-n_pad:] = -1
    return sk.to(device), words.to(device), popc.to(device)


@pytest.mark.parametrize("d,r,bits,n_pad", [
    (64, 64, 32, 0),        # W = 1
    (128, 320, 2048, 64),   # W = 64, padded refs
    (256, 128, 16384, 0),   # W = 512: several word chunks
    (192, 4096, 2048, 0),   # many CTAs
    (128, 192, 32, 64),     # W = 1, padded refs
    (64, 128, 64, 0),       # W = 2 and W = 4: fewer words than one staged
    (64, 128, 128, 32),     # 16-byte copy, padded refs
    (256, 256, 16384, 64),  # W = 512, padded refs
    (64, 128, 65536, 64),   # W = 2,048, the widest sketch, padded refs
])
def test_k2_kernel_matches_plain(cuda, d, r, bits, n_pad):
    sk, words, popc = _contains_inputs(d + r, d, r, bits, n_pad, cuda)
    kernels.reset_launches()
    got = kernels.packed_contains_matrix(sk, words, popc)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["packed_contains_matrix"] == 1
    want = kernels.packed_contains_matrix_plain(sk, words, popc)
    assert torch.equal(got, want)
    assert 0 < int(want.sum()) < want.numel()
    if n_pad:
        assert not bool(got[:, -n_pad:].any())


def test_probes_match_plain(cuda):
    kernels.reset_contains_check()
    kernels.reset_launches()
    x = torch.arange(5, dtype=torch.int32, device=cuda).reshape(1, 5)
    assert torch.equal(kernels.repeat_probe(x), kernels.repeat_probe_plain(x))
    # Integer-valued floats: every sum is exact in either order.
    y = torch.randint(-100, 100, (48, 128), device=cuda).float()
    assert torch.equal(kernels.pipeline_probe(y),
                       kernels.pipeline_probe_plain(y))
    kernels.check_contains_library(cuda)
    assert kernels.LAUNCHES["repeat_probe"] == 2
    assert kernels.LAUNCHES["pipeline_probe"] == 2
    kernels.check_contains_library(cuda)  # passed once: not probed again
    assert kernels.LAUNCHES["repeat_probe"] == 2


@pytest.mark.parametrize("strategy", [2, 3])
def test_approximate_strategies_on_cuda_equal_cpu(cuda, strategy):
    triples = synth.generate_triples(3000, seed=5)
    kernels.reset_contains_check()
    kernels.reset_launches()
    stats = {}
    got = rdfind_tpu_torch.discover(triples, 3, strategy=strategy, device=cuda,
                                    stats=stats)
    assert kernels.LAUNCHES["packed_contains_matrix"] > 0
    assert kernels.LAUNCHES["repeat_probe"] == 1
    assert kernels.LAUNCHES["pipeline_probe"] == 1
    cpu_stats = {}
    want = rdfind_tpu_torch.discover(triples, 3, strategy=strategy,
                                     device="cpu", stats=cpu_stats)
    assert len(want) > 0 and got.to_rows() == want.to_rows()
    for key in ("n_sketch_candidates", "n_round1_candidates",
                "n_round2_candidates"):
        assert stats.get(key) == cpu_stats.get(key), key


S2L_KEYS = ("n_cinds_11", "n_proper_overlaps", "n_cinds_12", "n_cinds_21",
            "n_inferred_21", "n_cinds_22", "pairs_11", "pairs_12", "pairs_21",
            "pairs_22", "total_pairs", "pair_backend")


@pytest.mark.parametrize("backend,fc", [("matmul", True), ("chunked", True),
                                        ("chunked", False)])
def test_small_to_large_on_cuda_equals_cpu(cuda, backend, fc):
    triples = synth.generate_triples(3000, seed=5)
    kw = dict(strategy=1, pair_backend=backend, pair_chunk_budget=1 << 14,
              use_frequent_condition_filter=fc)
    stats, cpu_stats = {}, {}
    got = rdfind_tpu_torch.discover(triples, 3, device=cuda, stats=stats, **kw)
    want = rdfind_tpu_torch.discover(triples, 3, device="cpu",
                                     stats=cpu_stats, **kw)
    assert len(want) > 0 and got.to_rows() == want.to_rows()
    for key in S2L_KEYS:
        assert stats.get(key) == cpu_stats.get(key), key
    if backend == "chunked":
        assert stats["n_pair_chunks"] == cpu_stats["n_pair_chunks"] > 1


@pytest.mark.parametrize("strategy", [0, 2, 3])
def test_chunked_backend_on_cuda_equals_dense(cuda, strategy):
    triples = synth.generate_triples(3000, seed=5)
    stats = {}
    got = rdfind_tpu_torch.discover(triples, 3, strategy=strategy, device=cuda,
                                    pair_backend="chunked",
                                    pair_chunk_budget=1 << 14, stats=stats)
    want = rdfind_tpu_torch.discover(triples, 3, strategy=strategy,
                                     device=cuda, pair_backend="matmul")
    assert stats["pair_backend"] == "chunked" and stats["n_pair_chunks"] > 1
    assert len(want) > 0 and got.to_rows() == want.to_rows()


def test_chunk_loop_syncs_only_at_its_pulls(cuda, monkeypatch):
    """Each chunk's emission, sort, count and staged copy queue under PyTorch's
    sync debug mode "error"; only the pull of a chunk (one event wait) runs
    with it off.  The chunks equal the CPU loop's."""
    triples = synth.generate_triples(3000, seed=5)
    st = allatonce.prepare_join_lines(allatonce.triples_on(triples, "cpu"), 3,
                                      "spo", True, False, None)
    lv, lc = st["line_val_h"], st["line_cap_h"]
    rng = np.random.default_rng(0)
    dep_ok = rng.random(st["num_caps"]) < 0.5
    pull = allatonce._pull_chunk
    pulls = []

    def pull_with_sync(staged):
        torch.cuda.set_sync_debug_mode("default")
        try:
            pulls.append(1)
            return pull(staged)
        finally:
            torch.cuda.set_sync_debug_mode("error")

    want = list(allatonce.iter_chunk_pairs(lv, lc, 1 << 12, "cpu",
                                           dep_f_h=dep_ok[lc]))
    it = allatonce.iter_chunk_pairs(lv, lc, 1 << 12, cuda, dep_f_h=dep_ok[lc])
    monkeypatch.setattr(allatonce, "_pull_chunk", pull_with_sync)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = list(it)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert len(got) == len(want) == len(pulls) > 4
    for g, w in zip(got, want):
        for a, b in zip(g, w):
            np.testing.assert_array_equal(a, b)
