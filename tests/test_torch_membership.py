"""K3 (``kernels.membership_counts``) and the dense plan's budget, on the CPU.

K3's plain versions widen one bounded slab of Mᵀ at a time; they must equal,
bit for bit, both the sums the dense path took before K3 (over an int32 copy
of the whole Mᵀ) and the JAX package's ``_stage_membership``,
``_stage_block_counts`` and ``_union_line_counts`` on the same matrix.  The
plan's CUDA rule is fed injected (free, reserved, allocated) numbers, and
``discover`` on LUBM(1) is held to the benchmark's plain reference on both
backends.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import rdfind_tpu_torch
from benchmark import gen
from benchmark.reference import cinds
from rdfind_tpu.models import allatonce as jallatonce
from rdfind_tpu.models import small_to_large as js2l
from rdfind_tpu.ops import cooc as jcooc
from rdfind_tpu_torch.models import allatonce as tallatonce
from rdfind_tpu_torch.ops import cooc as tcooc
from rdfind_tpu_torch.ops import kernels
from torch_harness import port_module, time_limit  # noqa: F401


def _widened(m_t, min_support: int, kl: int, tile: int):
    """The sums the dense path took before K3: each over an int32 copy of
    the whole Mᵀ."""
    c_pad, l_pad = m_t.shape
    dep = m_t.sum(dim=1, dtype=torch.int32)
    mask = (dep >= min_support).to(torch.int8)
    lens = (m_t * mask[:, None]).sum(dim=0, dtype=torch.int32)
    blocks = m_t.reshape(c_pad // tile, tile, l_pad // kl, kl).sum(
        dim=(1, 3), dtype=torch.int32).T
    return dep, lens, blocks


def _jax(m_t, min_support: int, kl: int, tile: int):
    """The JAX package's dep_count, lens and block counts of the same M
    (lines x captures), M rebuilt from its (line, capture) rows."""
    c_pad, l_pad = m_t.shape
    m = m_t.numpy().T
    gid, cap = np.nonzero(m)
    valid = np.ones(gid.size + 1, bool)
    valid[-1] = False  # one invalid row: the rows are never empty
    gid = np.append(gid, -1).astype(np.int32)
    cap = np.append(cap, -1).astype(np.int32)
    m_j, dep, lens = jallatonce._stage_membership(
        jnp.asarray(gid), jnp.asarray(cap), jnp.asarray(valid),
        jnp.int32(min_support), l_pad=l_pad, c_pad=c_pad,
        membership_dtype=jcooc.dense_plan(1, 1).dtype)
    np.testing.assert_array_equal(np.asarray(m_j, np.int8), m)
    blocks = jcooc._stage_block_counts(jnp.asarray(m), kl=kl, tile=tile)
    return (np.asarray(dep, np.int64), np.asarray(lens, np.int64),
            np.asarray(blocks, np.int64))


def _random_mt(seed, c_pad, l_pad, *, caps, lines, density=0.05,
               dead_rows=()):
    """(c_pad, l_pad) int8 0/1 Mᵀ with members in the first `caps` rows and
    `lines` columns only (the rest is padding), and `dead_rows` empty."""
    rng = np.random.default_rng(seed)
    m = np.zeros((c_pad, l_pad), np.int8)
    m[:caps, :lines] = rng.random((caps, lines)) < density
    m[list(dead_rows)] = 0
    return torch.as_tensor(m)


def _lubm1_mt(min_support: int):
    triples = torch.as_tensor(gen.generate_lubm(1, seed=42))
    (gid, cap_id, valid, n_lines, *_, num_caps) = tallatonce._stage_prepare(
        triples, min_support, projections="spo", use_fc_filter=True)
    plan = tcooc.dense_plan(n_lines, num_caps, "cpu")
    m_t = tcooc.build_membership(gid, cap_id, valid, l_pad=plan.l_pad,
                                 c_pad=plan.c_pad)
    return m_t, plan.line_block, plan.tile


def _case(name):
    """(Mᵀ, min_support, line block, dep tile, rows of a plain slab or None
    for MEMBERSHIP_SLAB_ELEMS's own)."""
    if name == "padded":
        return _random_mt(1, 384, 768, caps=300, lines=700), 40, 256, 128, 7
    if name == "odd":
        return _random_mt(2, 70, 300, caps=66, lines=291), 3, 60, 35, 3
    if name == "dead_rows":
        return (_random_mt(3, 256, 512, caps=256, lines=512,
                           dead_rows=range(0, 256, 2)), 10, 256, 128, None)
    if name == "all_dead":
        return (_random_mt(4, 128, 256, caps=128, lines=256,
                           dead_rows=range(128)), 1, 128, 128, 5)
    m_t, kl, tile = _lubm1_mt(100)
    return m_t, 100, kl, tile, None


@pytest.mark.parametrize("name", ["padded", "odd", "dead_rows", "all_dead",
                                  "lubm1"])
def test_membership_counts_plain_equals_widened_sums_and_jax(name,
                                                             monkeypatch):
    m_t, min_support, kl, tile, slab_rows = _case(name)
    if slab_rows:
        monkeypatch.setattr(kernels, "MEMBERSHIP_SLAB_ELEMS",
                            slab_rows * m_t.shape[1])
    got = kernels.membership_counts_plain(m_t, min_support, kl=kl, tile=tile)
    assert all(t.dtype == torch.int32 for t in got)
    for g, w in zip(got, _widened(m_t, min_support, kl, tile)):
        assert torch.equal(g, w)
    for g, w in zip(got, _jax(m_t, min_support, kl, tile)):
        np.testing.assert_array_equal(g.numpy().astype(np.int64), w)
    # The wrapper takes the plain route on the CPU, with no launch.
    for g, w in zip(kernels.membership_counts(m_t, min_support, kl=kl,
                                              tile=tile), got):
        assert torch.equal(g, w)
    assert kernels.LAUNCHES["membership_counts"] == 0
    dep = got[0]
    if name == "all_dead":
        assert int(dep.sum()) == 0 and int(got[1].sum()) == 0
    elif name != "odd":
        assert (dep < min_support).any() and int(got[1].sum()) > 0


@pytest.mark.parametrize("slab_rows", [None, 1, 33])
def test_union_line_counts_through_k3_plain_equals_jax(slab_rows,
                                                       monkeypatch):
    m_t = _random_mt(5, 384, 512, caps=350, lines=500, density=0.1)
    mask = torch.as_tensor(np.random.default_rng(6).random(384) < 0.4)
    if slab_rows:
        monkeypatch.setattr(kernels, "MEMBERSHIP_SLAB_ELEMS", slab_rows * 512)
    want = np.asarray(js2l._union_line_counts(jnp.asarray(m_t.numpy().T),
                                              jnp.asarray(mask.numpy())))
    got = tcooc.union_line_counts(m_t, mask)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        kernels.membership_line_counts_plain(m_t, mask).numpy(), want)


def test_membership_wrappers_refuse_shapes_that_do_not_divide():
    m_t = torch.zeros((256, 512), dtype=torch.int8)
    with pytest.raises(ValueError):
        kernels.membership_row_counts(m_t, kl=300, tile=128)
    with pytest.raises(ValueError):
        kernels.membership_row_counts(m_t, kl=256, tile=96)
    with pytest.raises(TypeError):
        kernels.membership_row_counts(m_t.to(torch.int32), kl=256, tile=128)
    with pytest.raises(ValueError):
        kernels.membership_line_counts(m_t, torch.ones(255, dtype=torch.bool))


def test_build_membership_in_bounded_scatters(monkeypatch):
    """Rows scattered a few at a time give the same Mᵀ as in one scatter."""
    rng = np.random.default_rng(7)
    n = 1000
    gid = torch.as_tensor(rng.integers(0, 300, n))
    cap = torch.as_tensor(rng.integers(0, 200, n))
    valid = torch.as_tensor(rng.random(n) < 0.7)
    whole = tcooc.build_membership(gid, cap, valid, l_pad=512, c_pad=256)
    monkeypatch.setattr(tcooc, "SCATTER_ROWS", 37)
    parts = tcooc.build_membership(gid, cap, valid, l_pad=512, c_pad=256)
    assert torch.equal(whole, parts)
    want = np.zeros((256, 512), np.int8)
    want[cap.numpy()[valid.numpy()], gid.numpy()[valid.numpy()]] = 1
    np.testing.assert_array_equal(parts.numpy(), want)
    with pytest.raises(ValueError, match="planned shape"):
        tcooc.build_membership(gid, cap, valid, l_pad=256, c_pad=256)


GiB = 1 << 30


def _plan_on_cuda(monkeypatch, free, reserved, allocated, **kw):
    """dense_plan's CUDA rule under injected allocator readings (no card is
    touched: device_memory is the rule's only reading of the device)."""
    monkeypatch.setattr(tcooc, "device_memory",
                        lambda device: (free, reserved, allocated))
    return tcooc.dense_plan(3_352_958, 11_917, "cuda", **kw)


def test_dense_plan_cuda_rule_on_injected_memory(monkeypatch):
    held = 2 * GiB  # allocated: the triples and prepare's outputs
    kw = dict(scatter_rows=122_658_534)
    l_pad, c_pad, tile = tcooc.padded_shape(3_352_958, 11_917)
    rest = tcooc.dense_footprint(l_pad, c_pad, tile, **kw)
    assert l_pad * c_pad == 40_344_354_816  # LUBM(100)'s Mᵀ, past 2^31 entries
    # allocated + what the path allocates = free + reserved - margin:
    # admitted, and one byte less free is refused.
    free = rest + tcooc.PLAN_MARGIN_BYTES
    plan = _plan_on_cuda(monkeypatch, free, held, held, **kw)
    assert plan is not None
    assert plan.footprint_bytes == held + rest == plan.budget_bytes
    d = plan.describe()
    assert d["footprint_bytes"] == held + rest == d["budget_bytes"]
    assert _plan_on_cuda(monkeypatch, free - 1, held, held, **kw) is None
    # Bytes the allocator holds cached count as usable: the same plan whether
    # 20 GiB are free on the card or reserved and unallocated.
    cached = _plan_on_cuda(monkeypatch, free - 20 * GiB, held + 20 * GiB,
                           held, **kw)
    assert cached == plan
    # Far under the footprint: refused; far over it: the same plan's shapes.
    # The same numbers always give the same answer.
    roomy = _plan_on_cuda(monkeypatch, 80 * GiB, held, held, **kw)
    assert (roomy.l_pad, roomy.c_pad, roomy.tile, roomy.footprint_bytes) == (
        plan.l_pad, plan.c_pad, plan.tile, plan.footprint_bytes)
    assert roomy.budget_bytes == held + 80 * GiB - tcooc.PLAN_MARGIN_BYTES
    for _ in range(2):
        assert _plan_on_cuda(monkeypatch, 30 * GiB, held, held, **kw) is None
        assert _plan_on_cuda(monkeypatch, 80 * GiB, held, held, **kw) == roomy
    # What the job holds counts in the footprint: 10 GiB more allocated out
    # of the same reserve leaves 10 GiB less room.
    assert _plan_on_cuda(monkeypatch, free, held + 10 * GiB, held + 10 * GiB,
                         **kw).footprint_bytes == plan.footprint_bytes \
        + 10 * GiB
    assert _plan_on_cuda(monkeypatch, free, held, held + 1, **kw) is None


def test_dense_footprint_counts_what_the_path_allocates():
    l_pad, c_pad, tile = tcooc.padded_shape(336_840, 2_830)
    base = tcooc.dense_footprint(l_pad, c_pad, tile)
    assert base > l_pad * c_pad
    assert tcooc.dense_footprint(l_pad, c_pad, tile, extra_bytes=7) == base + 7
    # The scatter's temporaries are bounded by its chunk of rows.
    big = tcooc.dense_footprint(l_pad, c_pad, tile, scatter_rows=10 ** 10)
    assert big > base
    assert big == tcooc.dense_footprint(l_pad, c_pad, tile,
                                        scatter_rows=tcooc.SCATTER_ROWS)
    assert big - base <= tcooc.SCATTER_ROW_BYTES * tcooc.SCATTER_ROWS


def test_cpu_plan_keeps_the_jax_rule(monkeypatch):
    """On the CPU the plan admits Mᵀ alone against the JAX package's budget,
    whatever the footprint beside it."""
    plan = tcooc.dense_plan(18608, 7309, "cpu", extra_bytes=100 * GiB)
    want = jcooc.dense_plan(18608, 7309)
    assert (plan.l_pad, plan.c_pad, plan.tile) == (want.l_pad, want.c_pad,
                                                   want.tile)
    assert plan.budget_bytes == tcooc.CPU_M_BUDGET_BYTES
    assert plan.footprint_bytes > 100 * GiB
    monkeypatch.setattr(tcooc, "CPU_M_BUDGET_BYTES", plan.l_pad * plan.c_pad)
    assert tcooc.dense_plan(18608, 7309, "cpu") is not None
    monkeypatch.setattr(tcooc, "CPU_M_BUDGET_BYTES",
                        plan.l_pad * plan.c_pad - 1)
    assert tcooc.dense_plan(18608, 7309, "cpu") is None


_LUBM1 = {}


def _lubm1(support: int):
    if "triples" not in _LUBM1:
        _LUBM1["triples"] = gen.generate_lubm(1, seed=42)
    t = _LUBM1["triples"]
    if support not in _LUBM1:
        _LUBM1[support] = cinds.rows(cinds.discover(t, support, "spo"))
    return t, _LUBM1[support]


@pytest.mark.parametrize("support,backend", [
    (100, "chunked"), (100, "matmul"), (10, "chunked"),
    pytest.param(10, "matmul", marks=pytest.mark.time_limit(400)),
])
def test_discover_on_lubm1_equals_the_reference(monkeypatch, support,
                                                backend):
    """``discover(..., pair_backend="auto")`` on LUBM(1): with the CPU budget
    forced below the plan's Mᵀ it falls back to the chunked loop, above it
    it takes the dense sweep; both equal the plain reference."""
    triples, want = _lubm1(support)
    if backend == "chunked":
        monkeypatch.setattr(tcooc, "CPU_M_BUDGET_BYTES", 1 << 10)
    stats = {}
    got = rdfind_tpu_torch.discover(triples, support, strategy=0,
                                    device="cpu", pair_backend="auto",
                                    stats=stats)
    assert stats["pair_backend"] == backend
    if backend == "matmul":
        d = stats["dense_plan"]
        assert d["budget_bytes"] == tcooc.CPU_M_BUDGET_BYTES
        assert d["footprint_bytes"] > d["l_pad"] * d["c_pad"]
    rows = np.stack([np.asarray(c, np.int64) for c in got.columns()], 1)
    assert len(want) > 0
    assert cinds.mismatched_rows(rows, want) == 0
