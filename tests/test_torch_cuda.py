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
    counts = kernels.membership_row_counts(
        m, kl=cooc.line_block_for(m.shape[1]), tile=128)[1]
    kernels.reset_launches()
    got = kernels.fused_cind_blocks(*args, ref_lo=ref_lo, ref_chunk=ref_chunk,
                                    block_counts=counts, dep_lo=lo, split=1)
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
counts = kernels.membership_row_counts(m, kl=256, tile=128)[1]
visited = torch.zeros(1, dtype=torch.int32, device=cuda)
try:
    cooc.fused_cind_tile(
        m, 0, 128, cols, rows,
        torch.tensor(blocks, dtype=torch.int32, device=cuda),
        torch.tensor([n_real], dtype=torch.int32, device=cuda), counts,
        visited, 1)
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
    block_counts = kernels.membership_row_counts(m, kl=256, tile=128)[1]
    counts = block_counts.cpu().numpy()
    launches = cooc.sweep_launches(counts, range(0, 512, 128), 128)
    scheds = kernels.upload_schedules(
        [(ln.block_ids, ln.block_ids.size) for ln in launches], 5, cuda)
    visited = torch.zeros(1, dtype=torch.int32, device=cuda)
    torch.cuda.synchronize()
    kernels.reset_launches()
    torch.cuda.set_sync_debug_mode("error")
    try:
        outs = [cooc.fused_cind_tile(m, ln.lo, ln.width, cols, rows, *sched,
                                     block_counts, visited, 1)
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


def _skip_membership(kind, device):
    """Mᵀ for the two-sided block skip (256-line blocks): "diagonal", each
    128-row band in one line block, so most (CTA, block) pairs skip;
    "full", members in every block of every band, so none skips; "heavy",
    two dense bands in every one of 257 blocks beside bands in one block
    each, a schedule long enough that k1_split shares each piece across a
    cluster.  Containments are planted inside bands."""
    rng = np.random.default_rng(len(kind))
    l_blocks, c_pad = {"diagonal": (9, 1024), "full": (9, 1024),
                       "heavy": (257, 1280)}[kind]
    m = np.zeros((c_pad, 256 * l_blocks), np.int8)
    if kind == "full":
        m[:] = rng.random(m.shape) < 0.03
    else:
        for c in range(c_pad):
            b = (c // 128) % l_blocks
            m[c, 256 * b + rng.choice(256, 12, replace=False)] = 1
    if kind == "heavy":
        m[:256] = rng.random((256, m.shape[1])) < 0.05
    for c in range(0, c_pad, 3):
        m[c // 128 * 128 + (c + 5) % 128] |= m[c]
    return torch.as_tensor(m).to(device)


def _visits_from_counts(counts, blocks, count_tile, dep_lo, tile, ref_lo,
                        ref_chunk):
    """The (CTA, block) products a launch makes, recounted on the host from
    the block counts."""
    n = 0
    for g in range(tile // 128):
        td = (dep_lo + 128 * g) // count_tile
        for h in range(-(-ref_chunk // 256)):
            tr0 = (ref_lo + 256 * h) // count_tile
            tr1 = (ref_lo + min(256 * h + 256, ref_chunk) - 1) // count_tile
            n += sum(bool(counts[b, td]) and bool(counts[b, tr0]
                                                  or counts[b, tr1])
                     for b in blocks)
    return n


@pytest.mark.parametrize("kind,count_tile,lo,width,ref_lo,ref_chunk", [
    ("diagonal", 128, 0, 512, 0, 1024),
    ("diagonal", 256, 256, 256, 128, 640),   # ragged last ref piece
    ("full", 128, 128, 384, 0, 640),
    ("full", 512, 0, 512, 128, 384),
    ("heavy", 256, 0, 512, 0, 1280),
    ("heavy", 128, 128, 256, 128, 768),
])
@pytest.mark.parametrize("split", [None, 1, 2, 3, 4])
def test_k1_block_skip_matches_plain(cuda, kind, count_tile, lo, width,
                                     ref_lo, ref_chunk, split):
    """K1 with K3's block counts against its plain version, which sums every
    scheduled block, bit for bit, at the split k1_split picks (None) and at
    every cluster size; its visited counter equals a host recount from the
    block counts."""
    m = _skip_membership(kind, cuda)
    kl = cooc.line_block_for(m.shape[1])
    counts = kernels.membership_row_counts(m, kl=kl, tile=count_tile)[1]
    counts_h = counts.cpu().numpy()
    t0, t1 = lo // count_tile, (lo + width - 1) // count_tile
    blocks = np.flatnonzero(counts_h[:, t0:t1 + 1].any(axis=1))
    ids = torch.arange(m.shape[0], dtype=torch.int32, device=cuda)
    cols, rows = cooc.sweep_operands(m.sum(dim=1, dtype=torch.int32),
                                     torch.full_like(ids, 12), ids,
                                     torch.full_like(ids, -1), 2)
    sl = slice(lo, lo + width)
    args = (m[sl], m, *(cols[k][sl] for k in ("sup", "ok", "gid", "code",
                                              "v1", "v2")),
            rows["ridx"], rows["code"], rows["v1"],
            torch.tensor(list(blocks) + [0], dtype=torch.int32, device=cuda),
            torch.tensor([blocks.size], dtype=torch.int32, device=cuda))
    kw = dict(ref_lo=ref_lo, ref_chunk=ref_chunk)
    pick = kernels.k1_split(
        *kernels.k1_visits(counts, args[11][:blocks.size].long(),
                           count_tile=count_tile, dep_lo=lo, tile=width,
                           ref_lo=ref_lo, ref_chunk=ref_chunk),
        torch.cuda.get_device_properties(cuda).multi_processor_count)
    visited = torch.zeros(1, dtype=torch.int32, device=cuda)
    kernels.reset_launches()
    got = kernels.fused_cind_blocks(*args, **kw, block_counts=counts,
                                    dep_lo=lo, split=split or pick,
                                    visited=visited)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["fused_cind_blocks"] == 1
    want = kernels.fused_cind_blocks_plain(*args, **kw)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert int(want[1].sum()) > 0
    n = _visits_from_counts(counts_h, blocks, count_tile, lo, width, ref_lo,
                            ref_chunk)
    scheduled = width // 128 * -(-ref_chunk // 256) * blocks.size
    assert int(visited) == n
    assert (n == scheduled) == (kind == "full")
    assert (pick > 1) == (kind == "heavy")


def test_discover_on_cuda_equals_cpu(cuda):
    triples = synth.generate_triples(3000, seed=5)
    kernels.reset_launches()
    got = rdfind_tpu_torch.discover(triples, 3, strategy=0, device=cuda,
                                    clean_implied=True)
    assert kernels.LAUNCHES["fused_cind_blocks"] > 0
    want = rdfind_tpu_torch.discover(triples, 3, strategy=0, device="cpu",
                                     clean_implied=True)
    assert len(want) > 0 and got.to_rows() == want.to_rows()


def _k3_case(m_t, min_support, kl, tile):
    """K3 on the card against its plain version on the same Mᵀ; returns the
    kernel's (dep_count, lens, block_counts)."""
    kernels.reset_launches()
    got = kernels.membership_counts(m_t, min_support, kl=kl, tile=tile)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["membership_counts"] == 2
    want = kernels.membership_counts_plain(m_t, min_support, kl=kl, tile=tile)
    for g, w in zip(got, want):
        assert g.dtype == torch.int32 and torch.equal(g, w)
    return got


@pytest.mark.parametrize("c_pad,l_pad,kl,tile,min_support", [
    (512, 1280, 256, 128, 30),    # five 256-line blocks, four dep tiles
    (384, 4096, 1024, 128, 100),  # lanes past a 512-byte row chunk
    (1024, 2048, 512, 256, 55),   # two warps' rows per dep tile
    (128, 256, 256, 128, 0),      # one CTA, every row counted
    (256, 768, 256, 256, 10**6),  # no frequent row: lens all zero
])
def test_k3_kernel_matches_plain(cuda, c_pad, l_pad, kl, tile, min_support):
    gen = torch.Generator(device=cuda).manual_seed(c_pad + l_pad)
    m = (torch.randint(0, 16, (c_pad, l_pad), generator=gen, device=cuda,
                       dtype=torch.int32) == 0).to(torch.int8)
    m[::3] = 0  # dead rows
    dep, lens, blocks = _k3_case(m, min_support, kl, tile)
    assert int(dep.sum()) == int(m.sum())
    assert int(blocks.sum()) == int(m.sum())
    if min_support > l_pad:
        assert int(lens.sum()) == 0


def test_k3_kernel_past_2_31_entries(cuda):
    """An Mᵀ of more than 2^31 entries (as LUBM(100)'s 4.0e10): the rows past
    the 2^31st byte are counted where the plain version counts them."""
    c_pad, l_pad = 640, 3_355_648
    assert c_pad * l_pad > 1 << 31
    gen = torch.Generator(device=cuda).manual_seed(31)
    m = torch.empty((c_pad, l_pad), dtype=torch.int8, device=cuda)
    for lo in range(0, c_pad, 64):  # a row band at a time: no wide temporary
        m[lo:lo + 64] = (torch.randint(0, 64, (64, l_pad), generator=gen,
                                       device=cuda, dtype=torch.int32) == 0)
    m[-1, -1] = 1  # the last entry, at offset c_pad * l_pad - 1
    kl = cooc.line_block_for(l_pad)
    dep, lens, blocks = _k3_case(m, 40_000, kl, 128)
    assert int(dep[-1]) > 40_000 and int(lens[-1]) >= 1
    union = torch.zeros(c_pad, dtype=torch.bool, device=cuda)
    union[c_pad // 2:] = True
    want = kernels.membership_line_counts_plain(m, union)
    assert torch.equal(cooc.union_line_counts(m, union), want)


def test_k3_membership_stage_queues_without_host_sync(cuda):
    """The membership stage's counts (K3's two launches and the frequency
    mask between them) queue with no host sync, and equal the CPU's."""
    triples = torch.as_tensor(synth.generate_triples(3000, seed=5))
    out = {}
    for dev in ("cpu", cuda):
        t = triples.to(dev)
        (gid, cap_id, valid, n_lines, *_, num_caps) = \
            allatonce._stage_prepare(t, 3, projections="spo",
                                     use_fc_filter=True)
        plan = cooc.dense_plan(n_lines, num_caps, "cpu")
        m_t = cooc.build_membership(gid, cap_id, valid, l_pad=plan.l_pad,
                                    c_pad=plan.c_pad)
        if dev != "cpu":
            torch.cuda.synchronize()
            kernels.reset_launches()
            torch.cuda.set_sync_debug_mode("error")
        try:
            counts = kernels.membership_counts(
                m_t, 3, kl=plan.line_block, tile=plan.tile)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        out[str(dev)] = [c.cpu() for c in (m_t, *counts)]
    assert kernels.LAUNCHES["membership_counts"] == 2
    for a, b in zip(out["cpu"], out[str(cuda)]):
        assert torch.equal(a, b)


def test_dense_plan_on_the_card_ignores_the_allocators_cache(cuda):
    """The plan reads the allocator's cached blocks as usable: the same plan
    with 8 GiB cached by an earlier allocation as with the cache emptied."""
    triples = synth.generate_triples(20000, seed=9)
    plans = []
    for cached in (True, False):
        if cached:
            block = torch.empty(8 << 30, dtype=torch.int8, device=cuda)
            del block
        else:
            torch.cuda.empty_cache()
        assert (torch.cuda.memory_reserved(cuda)
                - torch.cuda.memory_allocated(cuda) >= 8 << 30) == cached
        stats = {}
        rdfind_tpu_torch.discover(triples, 3, strategy=0, device=cuda,
                                  stats=stats)
        torch.cuda.synchronize()
        assert stats["pair_backend"] == "matmul"
        plans.append(stats["dense_plan"])
    keys = ("l_pad", "c_pad", "tile", "footprint_bytes")
    assert [{k: p[k] for k in keys} for p in plans][0] == \
        {k: plans[1][k] for k in keys}
    assert abs(plans[0]["budget_bytes"] - plans[1]["budget_bytes"]) < 64 << 20
    assert plans[0]["footprint_bytes"] <= plans[0]["budget_bytes"]


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


HA_KEYS = ("ha_spilled", "ha_round2_deps", "ha_explicit_pairs",
           "ha_round2_merged_pairs", "ha_round2_rows")


@pytest.mark.parametrize("threshold,width", [(0, 1 << 20), (3, 64),
                                             (64, 1 << 20)])
def test_half_approx_round_on_cuda_equals_cpu(cuda, threshold, width):
    """The count-min sketch lives on the card; rows and the ha_* statistics
    equal the CPU run's, and the output the exact path's."""
    triples = synth.generate_triples(3000, seed=5)
    kw = dict(strategy=1, explicit_threshold=threshold, sbf_width=width,
              pair_chunk_budget=1 << 14)
    stats, cpu_stats = {}, {}
    got = rdfind_tpu_torch.discover(triples, 3, device=cuda, stats=stats, **kw)
    want = rdfind_tpu_torch.discover(triples, 3, device="cpu",
                                     stats=cpu_stats, **kw)
    assert len(want) > 0 and got.to_rows() == want.to_rows()
    for key in HA_KEYS + S2L_KEYS:
        assert stats[key] == cpu_stats[key], key
    assert stats["ha_spilled"] > 0
    exact = rdfind_tpu_torch.discover(triples, 3, strategy=1, device=cuda)
    assert got.to_rows() == exact.to_rows()


def test_count_min_on_cuda_past_the_cap(cuda):
    """count_min_add on the card equals the CPU build and merge_count_min of
    per-part builds, with sums far past the cap."""
    cap = sketch.MAX_COUNT_MIN_CAP
    rng = np.random.default_rng(1)
    parts = []
    for _ in range(6):
        keys = torch.as_tensor(rng.integers(0, 50, 3000).astype(np.int32))
        cnts = torch.as_tensor(rng.integers(cap // 4, cap + 9, 3000)
                               .astype(np.int32))
        valid = torch.as_tensor(rng.random(3000) < 0.9)
        parts.append((keys, cnts, valid))
    whole = [torch.cat(c) for c in zip(*parts)]
    got = sketch.count_min_add(*(t.to(cuda) for t in whole), bits=256,
                               num_hashes=4)
    assert got.device.type == "cuda"
    want = sketch.merge_count_min(
        [sketch.count_min_add(*p, bits=256, num_hashes=4) for p in parts])
    assert int(want.max()) == cap
    assert torch.equal(got.cpu(), want)
    assert torch.equal(got.cpu(), sketch.count_min_add(*whole, bits=256,
                                                       num_hashes=4))
    q = torch.arange(60, dtype=torch.int32)
    assert torch.equal(
        sketch.count_min_query(got, q.to(cuda), bits=256, num_hashes=4).cpu(),
        sketch.count_min_query(want, q, bits=256, num_hashes=4))


def test_native_ingest_then_upload(cuda, tmp_path):
    """The native engine's ids, uploaded to the card, give the CPU run's CINDs
    and equal the Python ingest's ids and dictionary."""
    from rdfind_tpu_torch.dictionary import intern_triples
    from rdfind_tpu_torch.io import native, ntriples, reader

    triples = synth.generate_triples(3000, seed=5)
    path = tmp_path / "d.nt"
    path.write_text("".join(f"<e{s}> <e{p}> <e{o}> .\n" for s, p, o in triples))
    ids, dictionary = native.ingest_files([str(path)], threads=4)
    rows = [ntriples.parse_line(ln) for _, ln in reader.iter_lines([str(path)])]
    ids_py, dict_py = intern_triples(np.asarray(rows, dtype=object))
    np.testing.assert_array_equal(ids, ids_py)
    assert list(dictionary.values) == list(dict_py.values)
    on_card = torch.as_tensor(ids).to(cuda)
    got = rdfind_tpu_torch.discover(on_card, 3, strategy=1, device=cuda)
    want = rdfind_tpu_torch.discover(ids, 3, strategy=1, device="cpu")
    assert len(want) > 0 and got.to_rows() == want.to_rows()


def test_memory_sample_equals_the_allocator_peak(cuda):
    from rdfind_tpu_torch.obs import memory as obs_memory

    obs_memory.reset()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    x = torch.ones((1 << 20,), dtype=torch.int32, device=cuda)
    del x
    stats = {}
    rec = obs_memory.sample(stats, label="stage test")
    assert rec == stats["hbm"]
    assert rec["peak_bytes"] == torch.cuda.max_memory_allocated()
    assert rec["in_use_bytes"] == torch.cuda.memory_allocated()
    assert rec["limit_bytes"] == torch.cuda.mem_get_info()[1]
    assert rec["peak_bytes"] >= 4 << 20 and 0 <= rec["frac"] < 1


@pytest.mark.parametrize("strategy", ["0", "2"])
def test_profile_dir_trace_holds_each_kernel_launch(cuda, tmp_path, strategy):
    """--profile-dir on the card: the trace has one device event of each
    kernel's symbol per launch the wrappers counted."""
    from rdfind_tpu_torch.obs import report
    from rdfind_tpu_torch.programs import rdfind as tcli

    triples = synth.generate_triples(3000, seed=5)
    path = tmp_path / "d.nt"
    path.write_text("".join(f"<e{s}> <e{p}> <e{o}> .\n" for s, p, o in triples))
    kernels.reset_contains_check()
    kernels.reset_launches()
    assert tcli.main([str(path), "--support", "3", "--traversal-strategy",
                      strategy, "--profile-dir", str(tmp_path / "prof"),
                      "--output", str(tmp_path / "out.txt")]) == 0
    launches = dict(kernels.LAUNCHES)
    counts = report.profile_kernel_counts(
        str(tmp_path / "prof" / "profile.json"), kernels.SYMBOLS)
    on_path = (["fused_cind_blocks"] if strategy == "0" else
               ["packed_contains_matrix", "repeat_probe", "pipeline_probe"])
    for name in on_path:
        assert launches[name] > 0, name
    assert counts == launches


def test_kernel_selfcheck_parity_on_the_card(cuda):
    got = sketch.kernel_selfcheck(n_rows=1024, n_bits=4096, device=cuda)
    want = sketch.kernel_selfcheck(n_rows=1024, n_bits=4096, device="cpu")
    assert got["parity"] and got["backend"] == "cuda"
    assert got["out_hash"] == want["out_hash"]
    assert got["kernel_ms"] > 0 and got["plain_ms"] > 0


def _write_nt(path, triples):
    path.write_text("".join(f"<e{s}> <e{p}> <e{o}> .\n"
                            for s, p, o in np.asarray(triples)))


@pytest.mark.parametrize("strategy,frac", [("1", 0.3), ("0", 0.3),
                                           ("2", 0.3)])
def test_delta_on_cuda_equals_its_from_scratch_run(cuda, tmp_path, strategy,
                                                   frac):
    """A base bundle, a change batch through --delta (the full fallback
    discovers on the card) and the from-scratch run on the updated file:
    byte-identical, the fallback's kernels launched."""
    from rdfind_tpu_torch.programs import rdfind as tcli

    t = synth.generate_triples(3000, seed=5)
    ins, dels = synth.grow_delta_batches(t, frac, seed=4)
    for name, rows in (("base", t), ("ins", ins), ("del", dels),
                       ("upd", synth.apply_delta(t, ins, dels))):
        _write_nt(tmp_path / f"{name}.nt", rows)
    common = ["--support", "3", "--traversal-strategy", strategy]
    bundle = str(tmp_path / "bundle")
    assert tcli.main([str(tmp_path / "base.nt"), *common, "--delta-state",
                      bundle]) == 0
    kernels.reset_contains_check()
    kernels.reset_launches()
    assert tcli.main([str(tmp_path / "ins.nt"), "--delta", bundle,
                      "--deletes", str(tmp_path / "del.nt"), *common,
                      "--output", str(tmp_path / "delta.txt")]) == 0
    launches = dict(kernels.LAUNCHES)
    assert tcli.main([str(tmp_path / "upd.nt"), *common, "--output",
                      str(tmp_path / "scratch.txt")]) == 0
    want = (tmp_path / "scratch.txt").read_bytes()
    assert want.count(b"\n") > 0
    assert (tmp_path / "delta.txt").read_bytes() == want
    on_path = {"0": ["fused_cind_blocks"], "1": ["fused_cind_blocks"],
               "2": ["packed_contains_matrix", "repeat_probe",
                     "pipeline_probe"]}[strategy]
    for name in on_path:
        assert launches[name] > 0, name


def test_base_bundle_full_set_launches_k1(cuda, tmp_path):
    """Strategy 1 launches no hand-written kernel; its base bundle's full
    definitional set is strategy 0's dense sweep, on the card."""
    from rdfind_tpu_torch.programs import rdfind as tcli
    from rdfind_tpu_torch.runtime import delta

    _write_nt(tmp_path / "base.nt", synth.generate_triples(3000, seed=5))
    args = [str(tmp_path / "base.nt"), "--support", "3",
            "--traversal-strategy", "1"]
    kernels.reset_launches()
    assert tcli.main(args) == 0
    assert kernels.LAUNCHES["fused_cind_blocks"] == 0
    assert tcli.main(args + ["--delta-state", str(tmp_path / "b")]) == 0
    assert kernels.LAUNCHES["fused_cind_blocks"] > 0
    b = delta.load_bundle(str(tmp_path / "b"), min_support=3,
                          projections="spo", distinct=False)
    assert not b.degraded and b.full.shape[0] > 0


_SERVE = """
import sys
sys.path.insert(0, {repo!r})
from rdfind_tpu_torch.programs import serve
rc = serve.main([{index!r}, "--console-port", "0", "--poll-s", "0.05",
                 "--max-s", "1"])
import torch
print("rc", rc, "cuda_initialized", torch.cuda.is_initialized())
"""


def test_serve_never_initialises_cuda(cuda, tmp_path):
    """The serving process answers from host memory: on a machine with a
    card it still never creates a CUDA context."""
    import os
    import subprocess
    import sys

    from rdfind_tpu_torch.data import CindTable
    from rdfind_tpu_torch.runtime import serving

    rows = [(17, 0, -1, 20, 1, -1, 5), (17, 0, -1, 20, 2, -1, 5)]
    serving.write_index(str(tmp_path / "idx"), ["a", "b", "c"],
                        CindTable.from_rows(rows), generation=0,
                        output_digest="g0")
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    r = subprocess.run([sys.executable, "-c", _SERVE.format(
        repo=repo, index=str(tmp_path / "idx"))], capture_output=True,
        text=True, timeout=120, cwd=repo)
    assert r.returncode == 0, r.stderr
    assert r.stdout.split() == ["rc", "0", "cuda_initialized", "False"]


def _sharded_case():
    return synth.generate_triples(3000, seed=5), 3


def _ran_its_own_passes(stats):
    """No fallback to the single-device strategy, which gives the same
    table."""
    assert not any(d["action"] == "fallback"
                   for d in stats.get("degradations", []))
    assert stats["n_pair_passes"] > 0


def test_sharded_on_one_nccl_rank(cuda, monkeypatch):
    """discover_sharded on a one-rank NCCL group equals the single-device
    AllAtOnce on the card (exact), names its transport, and plans as one
    gloo CPU rank does."""
    from rdfind_tpu_torch.models import sharded
    from rdfind_tpu_torch.parallel import mesh

    monkeypatch.delenv(mesh.BACKEND_ENV, raising=False)
    t, s = _sharded_case()
    want = allatonce.discover(t, s, use_frequent_condition_filter=True,
                              device=cuda)
    table, stats = sharded.discover_on(t, s, 1, device="cuda", use_fis=True)
    _, cpu_stats = sharded.discover_on(t, s, 1, device="cpu", use_fis=True)
    assert table.to_rows() == want.to_rows()
    assert (stats["dist_backend"], stats["staged"]) == ("nccl", 0)
    _ran_its_own_passes(stats)
    for k in ("planned_caps", "n_giant_lines", "n_giant_pairs",
              "n_pair_passes"):
        assert stats[k] == cpu_stats[k], k


def test_sharded_on_four_staged_gloo_ranks_of_one_card(cuda, monkeypatch):
    """Four ranks on the one card over gloo staged through host memory: the
    single-device table, and the plan of four gloo CPU ranks (exact)."""
    from rdfind_tpu_torch.models import sharded
    from rdfind_tpu_torch.parallel import mesh

    t, s = _sharded_case()
    want = allatonce.discover(t, s, use_frequent_condition_filter=True,
                              device=cuda)
    monkeypatch.setenv(mesh.BACKEND_ENV, "gloo")
    table, stats = sharded.discover_on(t, s, 4, device="cuda", use_fis=True)
    _, cpu_stats = sharded.discover_on(t, s, 4, device="cpu", use_fis=True)
    assert table.to_rows() == want.to_rows()
    assert (stats["dist_backend"], stats["staged"]) == ("gloo", 1)
    _ran_its_own_passes(stats)
    for k in ("planned_caps", "n_giant_lines", "n_giant_pairs",
              "n_pair_passes", "exchange_sites"):
        assert stats[k] == cpu_stats[k], k


def test_nccl_with_more_ranks_than_cards_raises(cuda, monkeypatch):
    """No silent fallback to another transport."""
    from rdfind_tpu_torch.models import sharded
    from rdfind_tpu_torch.parallel import mesh

    monkeypatch.delenv(mesh.BACKEND_ENV, raising=False)
    n = torch.cuda.device_count() + 1
    t, s = _sharded_case()
    with pytest.raises(RuntimeError, match=f"{n} local ranks asked for"):
        sharded.discover_on(t, s, n, device="cuda")


def test_sharded_strategy2_on_one_nccl_rank_launches_k2(cuda, monkeypatch):
    """Sharded strategy 2 on a one-rank NCCL group: the rank's sketch stage
    launches K2, and the table equals the single-device strategy 2 on the
    card (exact)."""
    import torch_rank_cases
    from rdfind_tpu_torch.models import approximate
    from rdfind_tpu_torch.parallel import launch, mesh

    monkeypatch.delenv(mesh.BACKEND_ENV, raising=False)
    t, s = _sharded_case()
    want = approximate.discover(t, s, use_frequent_condition_filter=True,
                                device=cuda)
    got = launch.spawn(torch_rank_cases.launches_case, 1, device="cuda",
                       args=(2, np.asarray(t, np.int32), s,
                             dict(use_fis=True)))
    assert got["rows"] == want.to_rows()
    assert got["k2_launches"][0] > 0
    assert got["stats"]["dist_backend"] == "nccl"
    _ran_its_own_passes(got["stats"])


def test_sharded_ingest_dop2_on_the_card(cuda, tmp_path):
    """--sharded-ingest --dop 2 on the card (two ranks over staged gloo)
    writes the single-device CLI's file byte for byte."""
    import os
    import subprocess
    import sys

    t, s = _sharded_case()
    terms = [f"<e{i}>" for i in range(int(np.max(t)) + 1)]
    shards = []
    for i in range(3):
        shards.append(str(tmp_path / f"part{i}.nt"))
        with open(shards[-1], "w") as f:
            f.write("".join(f"{terms[a]} {terms[b]} {terms[c]} .\n"
                            for a, b, c in t[i::3]))
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

    def cli(out, *flags, env=None):
        r = subprocess.run(
            [sys.executable, "-m", "rdfind_tpu_torch.programs.rdfind",
             *shards, "--support", str(s), "--output", str(out), *flags],
            capture_output=True, text=True, timeout=600, cwd=repo,
            env={**os.environ, **(env or {})})
        assert r.returncode == 0, r.stderr[-3000:]
        return r.stderr

    cli(tmp_path / "one.txt")
    err = cli(tmp_path / "two.txt", "--sharded-ingest", "--dop", "2",
              "--counters", "1", env={"RDFIND_TORCH_DIST_BACKEND": "gloo"})
    want = (tmp_path / "one.txt").read_bytes()
    assert want.count(b"\n") > 0
    assert (tmp_path / "two.txt").read_bytes() == want
    assert "stat-world_size: 2" in err and "stat-staged: 1" in err


def test_captured_fused_step_replays_equal_eager(cuda):
    """capture_fused_step at entry()'s size: one CUDA graph, replayed on the
    entry input, on fewer valid rows and at another support, equals the eager
    step on the same input each time."""
    from rdfind_tpu_torch import entry

    fn, (t, n_valid, support) = entry.entry(cuda)
    step = allatonce.capture_fused_step(
        t.shape[0], pair_capacity=entry.ENTRY_PAIR_CAPACITY, device=cuda)
    for n, sup in ((512, 2), (400, 2), (512, 3)):
        want = fn(t, torch.tensor(n, device=cuda),
                  torch.tensor(sup, device=cuda))
        got = step(t[:n], sup)
        k = int(want[7])
        assert k > 0 and int(got[7]) == k and int(got[8]) == int(want[8])
        for g, w in zip(got[:7], want[:7]):
            assert torch.equal(g[:k], w[:k])
    assert int(fn(t, n_valid, support)[7]) == 3490
