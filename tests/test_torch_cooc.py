"""Parity of the port's dense sweep (ops/cooc.py) with the JAX package's, on the
CPU: shape plans, the membership matrix, block popcounts, the packed decode, and
the whole sweep run on the same membership state handed over from the JAX side.
All quantities are integers or bits: exact.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rdfind_tpu.models import allatonce as jallatonce
from rdfind_tpu.ops import cooc as jcooc
from rdfind_tpu.ops import segments as jseg
from rdfind_tpu_torch import state
from rdfind_tpu_torch.ops import cooc as tcooc
from rdfind_tpu_torch.utils import synth


@pytest.fixture(autouse=True, scope="module")
def _release_jax_programs():
    """Drop the XLA programs compiled in and before this module: each keeps
    executable memory mappings, and a test process that gathers too many hits
    the kernel's per-process map limit (vm.max_map_count) inside XLA."""
    jax.clear_caches()
    yield
    jax.clear_caches()


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
    m, dep_count, _ = jallatonce._stage_membership(
        gid, cap_id, valid, jnp.int32(min_support), l_pad=plan.l_pad,
        c_pad=plan.c_pad, membership_dtype=plan.dtype)
    fit = lambda a: np.asarray(jallatonce._fit_device(a, plan.c_pad))
    return plan, dict(line_gid=np.asarray(gid), cap_id=np.asarray(cap_id),
                      valid=np.asarray(valid), m=np.asarray(m, np.float32),
                      dep_count=np.asarray(dep_count), cap_code=fit(code),
                      cap_v1=fit(v1), cap_v2=fit(v2))


def test_build_membership_and_block_counts_match():
    plan, st = _stage_state()
    t = state.stage_state_to_device(st, "cpu")
    m = tcooc.build_membership(t["line_gid"], t["cap_id"], t["valid"],
                               l_pad=plan.l_pad, c_pad=plan.c_pad)
    np.testing.assert_array_equal(m.numpy(), st["m"].astype(np.int8))
    kl = tcooc.line_block_for(plan.l_pad)
    want = np.asarray(jcooc._stage_block_counts(jnp.asarray(st["m"]), kl=kl,
                                                tile=plan.tile))
    got = tcooc.stage_block_counts(m, kl=kl, tile=plan.tile).numpy()
    np.testing.assert_array_equal(got, want)


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
    stats = {}
    d_t, r_t, s_t = tcooc.discover_pairs_dense(
        t["m"], t["dep_count"], t["cap_code"], t["cap_v1"], t["cap_v2"],
        min_support, tplan, stats=stats)
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
    mt = torch.as_tensor(m)
    cols, rows = tcooc.sweep_operands(
        mt.sum(dim=0, dtype=torch.int32),
        torch.full((c_pad,), 12, dtype=torch.int32),
        torch.arange(c_pad, dtype=torch.int32),
        torch.full((c_pad,), -1, dtype=torch.int32), 2)
    counts = tcooc.stage_block_counts(mt, kl=256, tile=tile).numpy()
    launches = tcooc.sweep_launches(counts, range(0, c_pad, tile), tile)
    assert len(launches) == 1 and launches[0].width == c_pad
    joint, popc = tcooc.fused_cind_tile(mt, 0, c_pad, cols, rows,
                                        launches[0].block_ids)
    for lo in range(0, c_pad, tile):
        own = np.flatnonzero(counts[:, lo // tile]).astype(np.int32)
        assert own.size < launches[0].block_ids.size
        p, c = tcooc.fused_cind_tile(mt, lo, tile, cols, rows, own)
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
