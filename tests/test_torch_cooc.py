"""Parity of the port's dense sweep (ops/cooc.py) with the JAX package's, on the
CPU: shape plans, the membership matrix, block popcounts, the packed decode, and
the whole sweep run on the same membership state handed over from the JAX side.
The JAX package holds M (lines x captures), the port Mᵀ (captures x lines): the
port is given ``M.T`` of the same array.  All quantities are integers or bits:
exact.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rdfind_tpu.models import allatonce as jallatonce
from rdfind_tpu.ops import cooc as jcooc
from rdfind_tpu.ops import segments as jseg
import rdfind_tpu_torch
from rdfind_tpu_torch import state
from rdfind_tpu_torch.models import allatonce as tallatonce
from rdfind_tpu_torch.ops import cooc as tcooc
from rdfind_tpu_torch.ops import kernels
from rdfind_tpu_torch.utils import synth
from torch_harness import port_module, time_limit  # noqa: F401


@pytest.mark.parametrize("n_lines,num_caps", [(1, 1), (300, 130), (18608, 7309),
                                              (77642, 10080), (5000, 4096)])
def test_dense_plan_shapes_match(n_lines, num_caps):
    want = jcooc.dense_plan(n_lines, num_caps)
    got = tcooc.dense_plan(n_lines, num_caps, "cpu")
    assert (got.l_pad, got.c_pad, got.tile, got.line_block) == (
        want.l_pad, want.c_pad, want.tile, want.line_block)
    assert got.dep_tile_starts == want.dep_tile_starts
    assert got.issued_flops == want.issued_flops
    assert tcooc.line_block_for(got.l_pad) == jcooc.line_block_for(want.l_pad)


def test_dense_plan_refuses_past_the_budget(monkeypatch):
    monkeypatch.setattr(tcooc, "CPU_M_BUDGET_BYTES", 1 << 20)
    assert tcooc.dense_plan(2048, 1024, "cpu") is None
    assert tcooc.dense_plan(1024, 1024, "cpu") is not None


def _stage_state(seed=2, n=600, min_support=2):
    """JAX candidate prep + membership on synth triples, as numpy state."""
    triples = synth.generate_triples(n, seed=seed, n_predicates=6,
                                     n_entities=50)
    cap = jseg.pow2_capacity(n)
    padded = jnp.asarray(np.pad(triples, ((0, cap - n), (0, 0)),
                                constant_values=np.iinfo(np.int32).max))
    (gid, cap_id, valid, n_lines, code, v1, v2, num_caps) = \
        jallatonce._stage_prepare(padded, jnp.int32(n), jnp.int32(min_support),
                                  projections="spo", use_fc_filter=True)
    plan = jcooc.dense_plan(int(n_lines), int(num_caps))
    m, dep_count, lens = jallatonce._stage_membership(
        gid, cap_id, valid, jnp.int32(min_support), l_pad=plan.l_pad,
        c_pad=plan.c_pad, membership_dtype=plan.dtype)
    fit = lambda a: np.asarray(jallatonce._fit_device(a, plan.c_pad))
    return plan, dict(line_gid=np.asarray(gid), cap_id=np.asarray(cap_id),
                      valid=np.asarray(valid), m=np.asarray(m, np.float32),
                      dep_count=np.asarray(dep_count), cap_code=fit(code),
                      cap_v1=fit(v1), cap_v2=fit(v2),
                      lens=np.asarray(lens, np.float64))


def test_build_membership_and_block_counts_match():
    plan, st = _stage_state()
    t = state.stage_state_to_device(
        {k: v for k, v in st.items() if k != "lens"}, "cpu")
    m_t = tcooc.build_membership(t["line_gid"], t["cap_id"], t["valid"],
                                 l_pad=plan.l_pad, c_pad=plan.c_pad)
    assert m_t.shape == (plan.c_pad, plan.l_pad)
    np.testing.assert_array_equal(m_t.numpy(), st["m"].astype(np.int8).T)
    kl = tcooc.line_block_for(plan.l_pad)
    want = np.asarray(jcooc._stage_block_counts(jnp.asarray(st["m"]), kl=kl,
                                                tile=plan.tile))
    got = kernels.membership_row_counts(m_t, kl=kl, tile=plan.tile)[1].numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("min_support", [2, 3])
def test_stage_membership_on_mt_matches_jax(min_support):
    """The Mᵀ-built aggregates: dep_count (row sums of Mᵀ), lens (column sums
    over the frequent rows) and the block popcounts equal the JAX package's
    _stage_membership / _stage_block_counts on M."""
    plan, st = _stage_state(seed=5, n=800, min_support=min_support)
    t = state.stage_state_to_device(
        {k: st[k] for k in ("line_gid", "cap_id", "valid")}, "cpu")
    m_t, dep_count, lens, block_counts = tallatonce._stage_membership(
        t["line_gid"], t["cap_id"], t["valid"], min_support, l_pad=plan.l_pad,
        c_pad=plan.c_pad, tile=plan.tile)
    np.testing.assert_array_equal(m_t.numpy(), st["m"].astype(np.int8).T)
    np.testing.assert_array_equal(dep_count.numpy(), st["dep_count"])
    np.testing.assert_array_equal(lens.numpy(), st["lens"])
    assert lens.sum() > 0 and (dep_count.numpy() < min_support).any()
    kl = tcooc.line_block_for(plan.l_pad)
    want = np.asarray(jcooc._stage_block_counts(jnp.asarray(st["m"]), kl=kl,
                                                tile=plan.tile))
    np.testing.assert_array_equal(block_counts.numpy(), want)


@pytest.mark.parametrize("min_support", [2, 4])
def test_discover_pairs_dense_matches_on_handed_over_state(min_support):
    """Both sweeps on the same membership state: the JAX one (materialized or
    fused, as its CPU policy picks) and the port's K1 sweep."""
    jplan, st = _stage_state(seed=4, n=900)
    d_j, r_j, s_j = jcooc.discover_pairs_dense(
        jnp.asarray(st["m"]), st["dep_count"], st["cap_code"], st["cap_v1"],
        st["cap_v2"], min_support, jplan.num_caps, jplan.tile,
        starts=jplan.dep_tile_starts, plan=jplan)
    t = state.stage_state_to_device(
        {k: st[k] for k in ("m", "dep_count", "cap_code", "cap_v1",
                            "cap_v2")}, "cpu")
    tplan = tcooc.dense_plan(jplan.n_lines, jplan.num_caps, "cpu")
    m_t = t["m"].T.contiguous()
    _, block_counts = kernels.membership_row_counts(
        m_t, kl=tplan.line_block, tile=tplan.tile)
    stats = {}
    d_t, r_t, s_t = tcooc.discover_pairs_dense(
        m_t, t["dep_count"], block_counts, t["cap_code"], t["cap_v1"],
        t["cap_v2"], min_support, tplan, stats=stats)
    want = set(zip(d_j.tolist(), r_j.tolist(), s_j.tolist()))
    assert want, "the workload must produce CINDs"
    assert set(zip(d_t.tolist(), r_t.tolist(), s_t.tolist())) == want
    assert len(d_t) == len(want)
    assert stats["dense_plan"]["n_launches"] >= 1


def test_launch_union_schedule_equals_per_tile_schedules():
    """A launch over several tiles visits the union of their non-empty line
    blocks; that gives each tile exactly its own-schedule bits."""
    rng = np.random.default_rng(3)
    l_pad, c_pad, tile = 768, 512, 128
    m = np.zeros((l_pad, c_pad), np.int8)
    for j in range(c_pad):  # each tile lives in its own pair of line blocks
        rows = (j // tile) * 256 + rng.choice(512, 6, replace=False)
        m[rows % l_pad, j] = 1
    m[:, 384:448] |= m[:, 0:64]
    mt = torch.as_tensor(m.T.copy())
    cols, rows = tcooc.sweep_operands(
        mt.sum(dim=1, dtype=torch.int32),
        torch.full((c_pad,), 12, dtype=torch.int32),
        torch.arange(c_pad, dtype=torch.int32),
        torch.full((c_pad,), -1, dtype=torch.int32), 2)
    block_counts = kernels.membership_row_counts(mt, kl=256, tile=tile)[1]
    counts = block_counts.numpy()
    visited = torch.zeros(1, dtype=torch.int32)
    launches = tcooc.sweep_launches(counts, range(0, c_pad, tile), tile)
    assert len(launches) == 1 and launches[0].width == c_pad
    n_blocks = l_pad // 256
    (joint_sched,) = kernels.upload_schedules(
        [(launches[0].block_ids, launches[0].block_ids.size)], n_blocks, "cpu")
    joint, popc = tcooc.fused_cind_tile(mt, 0, c_pad, cols, rows, *joint_sched,
                                        block_counts, visited, 1)
    for lo in range(0, c_pad, tile):
        own = np.flatnonzero(counts[:, lo // tile]).astype(np.int32)
        assert own.size < launches[0].block_ids.size
        (sched,) = kernels.upload_schedules([(own, own.size)], n_blocks, "cpu")
        p, c = tcooc.fused_cind_tile(mt, lo, tile, cols, rows, *sched,
                                     block_counts, visited, 1)
        np.testing.assert_array_equal(p.numpy(), joint[lo:lo + tile].numpy())
        np.testing.assert_array_equal(c.numpy(), popc[lo:lo + tile].numpy())
    assert int(popc.sum()) >= 64


def test_packed_decode_matches():
    rng = np.random.default_rng(1)
    bits = rng.random((40, 200)) < 0.1
    packed_j = jcooc.pack_bool(jnp.asarray(bits))
    packed_t = tcooc.pack_bool(torch.as_tensor(bits))
    for rows, cols in ((40, 200), (33, 150), (40, 31), (0, 200)):
        n = int(jcooc.packed_count(packed_j, jnp.int32(rows), jnp.int32(cols)))
        assert tcooc.packed_count(packed_t, rows, cols) == n
        d, r = tcooc.packed_nonzero(packed_t, rows, cols)
        if n:
            d_j, r_j = jcooc.packed_nonzero(packed_j, jnp.int32(rows),
                                            jnp.int32(cols), cap=n)
            np.testing.assert_array_equal(d.numpy(), np.asarray(d_j))
            np.testing.assert_array_equal(r.numpy(), np.asarray(r_j))
        else:
            assert d.numel() == 0


def test_stage_state_rejects_non_binary_membership():
    with pytest.raises(ValueError):
        state.stage_state_to_device({"m": np.full((2, 2), 2.0)}, "cpu")
    with pytest.raises(KeyError):
        state.stage_state_to_device({"lines": np.zeros(2)}, "cpu")


@pytest.mark.parametrize("strip_bits", [None, 1 << 10])
def test_extract_packed_matches_jax(monkeypatch, strip_bits):
    """One relation through the port's batched decode, in one batch or (with
    a small bound) in row strips with a pull every few tiles."""
    rng = np.random.default_rng(2)
    bits = rng.random((96, 250)) < 0.05
    want_d, want_r = jcooc.extract_packed(jcooc.pack_bool(jnp.asarray(bits)),
                                          90, 240)
    if strip_bits:
        monkeypatch.setattr(tcooc, "EXTRACT_DEVICE_ELEMS", strip_bits)
        monkeypatch.setattr(tcooc, "PULL_BYTES_BUDGET", 64)
    d, r = tcooc.extract_packed(tcooc.pack_bool(torch.as_tensor(bits)), 90,
                                240)
    assert want_d.size > 0
    np.testing.assert_array_equal(d, want_d)
    np.testing.assert_array_equal(r, want_r)


def test_extract_packed_iter_keeps_tile_order():
    rng = np.random.default_rng(3)
    tiles = [(rng.random((r, c)) < 0.2, r - 1, c) for r, c in
             ((8, 40), (30, 64), (5, 33), (1, 1))]
    tiles.insert(2, (np.zeros((4, 64), bool), 4, 64))  # an empty tile
    got = tcooc.extract_packed_iter(
        [lambda b=b, rr=rr, rc=rc: (tcooc.pack_bool(torch.as_tensor(b)), rr, rc)
         for b, rr, rc in tiles], 30 * 64)
    for (b, rr, rc), (d, r) in zip(tiles, got):
        want = np.nonzero(b[:rr, :rc])
        np.testing.assert_array_equal(d, want[0])
        np.testing.assert_array_equal(r, want[1])


def test_union_line_counts_match_jax(monkeypatch):
    from rdfind_tpu.models import small_to_large as js2l

    rng = np.random.default_rng(4)
    m = (rng.random((256, 384)) < 0.1).astype(np.int8)  # lines x captures
    mask = rng.random(384) < 0.4
    want = np.asarray(js2l._union_line_counts(jnp.asarray(m),
                                              jnp.asarray(mask)))
    monkeypatch.setattr(kernels, "MEMBERSHIP_SLAB_ELEMS", 100 * 256)
    got = tcooc.union_line_counts(torch.as_tensor(m.T.copy()),
                                  torch.as_tensor(mask))
    np.testing.assert_array_equal(got.numpy(), want)


def _visit_count_brute_force(m, blocks, *, count_tile, dep_lo, tile, ref_lo,
                             ref_chunk, kl):
    """(dep piece, ref piece, block) triples where the plan tile of the dep
    piece's rows and one plan tile its ref rows span have a member in the
    block, read off Mᵀ itself."""
    def live(t, b):
        return bool(m[t * count_tile:(t + 1) * count_tile,
                      b * kl:(b + 1) * kl].any())

    n = 0
    for g in range(tile // 128):
        td = (dep_lo + 128 * g) // count_tile
        for h in range(-(-ref_chunk // 256)):
            first = ref_lo + 256 * h
            last = ref_lo + min(256 * h + 256, ref_chunk) - 1
            tiles = range(first // count_tile, last // count_tile + 1)
            n += sum(live(td, b) and any(live(t, b) for t in tiles)
                     for b in blocks)
    return n


@pytest.mark.parametrize("count_tile,dep_lo,tile,ref_lo,ref_chunk", [
    (128, 0, 256, 0, 1024),     # two dep pieces, four ref pieces
    (128, 384, 128, 128, 640),  # ref pieces across two plan tiles, ragged
    (256, 128, 384, 0, 896),    # dep pieces in two plan tiles, ragged
    (512, 512, 512, 256, 768),  # ref pieces inside one plan tile
])
def test_k1_plain_visited_equals_brute_force_count(count_tile, dep_lo, tile,
                                                   ref_lo, ref_chunk):
    """The plain K1's visited blocks are the (dep piece, ref piece, block)
    triples where both sides have members, counted over Mᵀ; counting them
    changes no verdict bit."""
    rng = np.random.default_rng(count_tile + dep_lo)
    l_pad, c_pad, kl = 2304, 1024, 256  # nine 256-line blocks
    m = np.zeros((c_pad, l_pad), np.int8)
    for c in range(c_pad):  # each 128-row band lives in two line blocks
        for b in ((c // 128) % 9, (c // 128 + 4) % 9):
            m[c, b * kl + rng.choice(kl, 8, replace=False)] = 1
    m[:128, ::97] = 1  # one dense band, in every block
    for c in range(0, c_pad, 5):  # containments inside a band
        m[c // 128 * 128 + (c + 3) % 128] |= m[c]
    mt = torch.as_tensor(m)
    blocks = [0, 2, 3, 4, 5, 7, 8]
    lines = np.concatenate([np.arange(b * kl, (b + 1) * kl) for b in blocks])
    cols, rows = tcooc.sweep_operands(  # supports over the scheduled lines
        mt[:, lines].sum(dim=1, dtype=torch.int32),
        torch.as_tensor(rng.choice([12, 17, 20], c_pad).astype(np.int32)),
        torch.as_tensor(rng.integers(0, 3, c_pad).astype(np.int32)),
        torch.as_tensor(rng.integers(-1, 3, c_pad).astype(np.int32)), 2)
    counts = kernels.membership_row_counts(mt, kl=kl, tile=count_tile)[1]
    sl = slice(dep_lo, dep_lo + tile)
    args = (mt[sl], mt, *(cols[k][sl] for k in ("sup", "ok", "gid", "code",
                                                "v1", "v2")),
            rows["ridx"], rows["code"], rows["v1"],
            torch.tensor(blocks + [1], dtype=torch.int32),
            torch.tensor([len(blocks)], dtype=torch.int32))
    kw = dict(ref_lo=ref_lo, ref_chunk=ref_chunk)
    visited = torch.zeros(1, dtype=torch.int32)
    got = kernels.fused_cind_blocks(*args, **kw, block_counts=counts,
                                    dep_lo=dep_lo, split=1, visited=visited)
    want = _visit_count_brute_force(m, blocks, count_tile=count_tile,
                                    dep_lo=dep_lo, tile=tile, ref_lo=ref_lo,
                                    ref_chunk=ref_chunk, kl=kl)
    scheduled = tile // 128 * -(-ref_chunk // 256) * len(blocks)
    assert 0 < want < scheduled
    assert int(visited) == want
    whole = kernels.fused_cind_blocks_plain(*args, **kw)
    assert torch.equal(got[0], whole[0]) and torch.equal(got[1], whole[1])
    assert int(got[1].sum()) > 0


def test_dense_discover_publishes_k1_visited_blocks():
    """A dense discover reports the blocks K1's CTAs multiplied against the
    blocks their launches schedule; on a membership with members in every
    line block of every plan tile (one line block here) nothing is skipped,
    and on a wider input the visited blocks are a share of the scheduled."""
    for n, share_one in ((400, True), (6000, False)):
        stats = {}
        rdfind_tpu_torch.discover(synth.generate_triples(n, seed=5), 2,
                                  strategy=0, device="cpu", stats=stats)
        d = stats["dense_plan"]
        assert (d["l_pad"] == d["line_block"]) == share_one
        assert 0 < d["k1_blocks_visited"] <= d["k1_blocks_scheduled"]
        assert d["k1_visited_share"] == pytest.approx(
            d["k1_blocks_visited"] / d["k1_blocks_scheduled"])
        assert (d["k1_visited_share"] == 1.0) == share_one


def _launch_pieces(n, others, *, dep_pieces=8, ref_pieces=47):
    """k1_visits of a launch over n line blocks where piece (0, 0) multiplies
    every block and every other piece the first `others`."""
    dep = torch.zeros((n, dep_pieces), dtype=torch.bool)
    ref = torch.zeros((n, ref_pieces), dtype=torch.bool)
    dep[:, 0] = ref[:, 0] = True
    dep[:others, 1:] = ref[:others, 1:] = True
    return dep, ref


@pytest.mark.parametrize("n,others,n_sms,pieces,split", [
    (3840, 3840, 132, (8, 47), 1),  # a full membership: the card is filled
    (3840, 768, 132, (8, 47), 4),   # one piece holds 5x the mean: LUBM(100)
    (1000, 600, 132, (8, 47), 2),   # 1.17x half the spread: split once
    (100, 0, 132, (8, 47), 1),      # too short to share: 50 blocks a CTA
    (128, 0, 132, (8, 47), 2),
    (3840, 768, 0, (8, 47), 1),     # no card
    (1000, 1000, 132, (2, 4), 4),   # full, but 8 pieces for 132 SMs
])
def test_k1_split_follows_the_heaviest_piece(n, others, n_sms, pieces, split):
    """A launch's pieces share a cluster only while its heaviest piece is
    longer than half its work spread over the SMs and leaves each CTA
    K1_SPLIT_BLOCKS line blocks, and never more than K1_SPLIT_MAX CTAs."""
    dep, ref = _launch_pieces(n, others, dep_pieces=pieces[0],
                              ref_pieces=pieces[1])
    assert kernels.k1_split(dep, ref, n_sms) == split
    assert split == 1 or kernels.K1_SPLIT_BLOCKS * split <= n
