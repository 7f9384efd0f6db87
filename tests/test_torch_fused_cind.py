"""K1 (fused_cind_blocks): the port's plain version against the Pallas kernel.

The Pallas kernel runs in interpret mode on the CPU, as the JAX package's own tests
run it, and its uint8 verdict is packed with ``cooc.pack_bool``.  It takes the
membership M (lines x captures); the port takes the K-major Mᵀ, here
``M.T.copy()`` of the same numpy array.  The port's wrapper, given CPU tensors,
runs its plain PyTorch version, which is what the CUDA kernel is held against on
the card.  Every output is a bit or a count: exact.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rdfind_tpu.ops import cooc as jcooc
from rdfind_tpu.ops import pallas_kernels
from rdfind_tpu_torch.ops import cooc as tcooc
from rdfind_tpu_torch.ops import kernels


@pytest.fixture(autouse=True, scope="module")
def _release_jax_programs():
    """Drop the XLA programs compiled in and before this module: each keeps
    executable memory mappings, and a test process that gathers too many hits
    the kernel's per-process map limit (vm.max_map_count) inside XLA."""
    jax.clear_caches()
    yield
    jax.clear_caches()


def _block_inputs(seed, l_pad, c_pad, lo=0, tile=128, live_blocks=None,
                  codes=(12, 17, 20, 33, 35, 41), n_vals=3, min_support=2):
    """Membership whose dep tile [lo, lo + tile) has members only in
    `live_blocks` (256-line blocks; the block-skip schedule's premise), with
    64 planted containments of dep columns in other columns, and per-capture
    tables drawn from a few codes and values, so that the support test, the
    diagonal and the trivially-implied rule all decide bits."""
    rng = np.random.default_rng(seed)
    m = (rng.random((l_pad, c_pad)) < 0.04).astype(np.int8)
    live = np.zeros(l_pad, bool)
    for b in (range(l_pad // 256) if live_blocks is None else live_blocks):
        live[b * 256:(b + 1) * 256] = True
    m[~live, lo:lo + tile] = 0
    deps = lo + rng.choice(tile, 64, replace=False)
    for d, r in zip(deps, rng.choice(c_pad, 64, replace=False)):
        if d != r:
            m[:, r] |= m[:, d]
    code = rng.choice(codes, c_pad).astype(np.int32)
    v1 = rng.integers(0, n_vals, c_pad).astype(np.int32)
    v2 = rng.integers(-1, n_vals, c_pad).astype(np.int32)
    sup = m.sum(axis=0).astype(np.int32)
    return dict(m=m, code=code, v1=v1, v2=v2, sup=sup,
                ok=(sup >= min_support).astype(np.int32),
                gid=np.arange(c_pad, dtype=np.int32))


def _jax_block(x, lo, tile, block_ids, n_real, ref_lo, ref_chunk):
    col = lambda a: jnp.asarray(a[lo:lo + tile].reshape(tile, 1))
    row = lambda a: jnp.asarray(a.reshape(1, -1))
    verdict, popc = pallas_kernels.fused_cind_blocks(
        jnp.asarray(x["m"][:, lo:lo + tile]), jnp.asarray(x["m"]),
        col(x["sup"]), col(x["ok"]), col(x["gid"]), col(x["code"]),
        col(x["v1"]), col(x["v2"]), row(x["gid"]), row(x["code"]),
        row(x["v1"]), jnp.asarray(np.asarray(block_ids, np.int32)),
        jnp.asarray(np.array([n_real], np.int32)), ref_lo=ref_lo,
        ref_chunk=ref_chunk, interpret=True)
    packed = np.asarray(jcooc.pack_bool(verdict)).view(np.int32)
    return packed, np.asarray(popc).reshape(-1)


def _torch_operands(x):
    """The port's operands: Mᵀ as ``M.T.copy()``, the columns as tensors."""
    t = {k: torch.as_tensor(v) for k, v in x.items() if k != "m"}
    t["m_t"] = torch.as_tensor(x["m"].T.copy())
    return t


def _torch_block(x, lo, tile, block_ids, n_real, ref_lo, ref_chunk,
                 host_schedule=False):
    t = _torch_operands(x)
    sl = slice(lo, lo + tile)
    bids = np.asarray(block_ids, np.int32)
    n_blocks = x["m"].shape[0] // tcooc.line_block_for(x["m"].shape[0])
    schedule = kernels.upload_schedules([(bids, n_real)], n_blocks, "cpu")[0] \
        if host_schedule else (torch.as_tensor(bids),
                               torch.tensor([n_real], dtype=torch.int32))
    packed, popc = kernels.fused_cind_blocks(
        t["m_t"][sl], t["m_t"], t["sup"][sl], t["ok"][sl], t["gid"][sl],
        t["code"][sl], t["v1"][sl], t["v2"][sl], t["gid"], t["code"],
        t["v1"], *schedule, ref_lo=ref_lo, ref_chunk=ref_chunk)
    return packed.numpy(), popc.numpy()


# (name, seed, l_pad, c_pad, lo, tile, block_ids, n_real, ref_lo, ref_chunk)
CASES = [
    ("full_schedule", 0, 768, 256, 0, 128, [0, 1, 2], 3, 0, 256),
    ("partial_n_real", 1, 768, 256, 128, 128, [2, 0, 0, 0], 1, 0, 256),
    ("empty_schedule", 2, 768, 256, 0, 128, [0, 0], 0, 0, 256),
    ("second_ref_chunk", 3, 768, 384, 0, 128, [0, 1], 2, 128, 256),
    ("two_dep_blocks", 4, 768, 256, 0, 256, [1, 0], 2, 0, 256),
]


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_plain_k1_matches_pallas(case):
    _, seed, l_pad, c_pad, lo, tile, bids, n_real, ref_lo, ref_chunk = case
    x = _block_inputs(seed, l_pad, c_pad, lo, tile, bids[:n_real])
    want = _jax_block(x, lo, tile, bids, n_real, ref_lo, ref_chunk)
    got = _torch_block(x, lo, tile, bids, n_real, ref_lo, ref_chunk)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    if n_real == 0:
        assert not got[0].any() and not got[1].any()
    else:
        assert got[1].sum() > 0, "the case must set verdict bits"


def test_diagonal_block_with_equal_codes_matches_pallas():
    """A square diagonal block where every capture shares one of two codes: the
    self-pair mask and the equal-code quirk of the implied rule (unary equal
    codes compare v1 with v1, binary equal codes compare ref v1 with dep v2)."""
    x = _block_inputs(5, 768, 256, tile=256, codes=(17, 35), n_vals=2,
                      min_support=1)
    x["m"][:, 64:96] = x["m"][:, 0:32]  # equal columns inside each diagonal
    x["m"][:, 192:224] = x["m"][:, 128:160]  # block: containment both ways
    x["m"][:, 224:256] = x["m"][:, 96:128]  # and across the off-diagonal one
    x["sup"] = x["m"].sum(axis=0).astype(np.int32)
    x["ok"] = (x["sup"] >= 1).astype(np.int32)
    for lo, ref_lo in ((0, 0), (128, 128), (0, 128)):
        want = _jax_block(x, lo, 128, [0, 1, 2], 3, ref_lo, 128)
        got = _torch_block(x, lo, 128, [0, 1, 2], 3, ref_lo, 128)
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(got[1], want[1])
        assert got[1].sum() > 0


def test_full_ref_launch_equals_concatenated_chunks():
    """The sweep launches over every ref column at once; the JAX sweep walks
    ref chunks.  Same bits, and the popcounts sum."""
    x = _block_inputs(6, 768, 384)
    chunks = [_jax_block(x, 0, 128, [0, 1, 2], 3, r, 128)
              for r in (0, 128, 256)]
    got = _torch_block(x, 0, 128, [0, 1, 2], 3, 0, 384)
    assert got[1].sum() > 0
    np.testing.assert_array_equal(got[0],
                                  np.concatenate([c[0] for c in chunks], 1))
    np.testing.assert_array_equal(got[1], sum(c[1] for c in chunks))


def test_wrapper_runs_plain_on_cpu_without_counting_launches():
    x = _block_inputs(7, 512, 256)
    kernels.reset_launches()
    _torch_block(x, 0, 128, [0], 1, 0, 256)
    assert kernels.LAUNCHES["fused_cind_blocks"] == 0


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_host_schedule_equals_tensor_schedule(case):
    """A schedule handed over as a host array (checked on the host and moved
    to the operands' device by ``upload_schedules``) gives the tensor
    schedule's bits."""
    _, seed, l_pad, c_pad, lo, tile, bids, n_real, ref_lo, ref_chunk = case
    x = _block_inputs(seed, l_pad, c_pad, lo, tile, bids[:n_real])
    want = _torch_block(x, lo, tile, bids, n_real, ref_lo, ref_chunk)
    got = _torch_block(x, lo, tile, bids, n_real, ref_lo, ref_chunk,
                       host_schedule=True)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])


def test_upload_schedules_checks_on_the_host_and_shares_one_buffer():
    scheds = kernels.upload_schedules(
        [(np.array([2, 0, 1], np.int32), 3), (np.array([1, 0], np.int32), 1),
         (np.zeros(4, np.int32), 0)], 3, "cpu")
    assert [(b.tolist(), n.tolist()) for b, n in scheds] == [
        ([2, 0, 1], [3]), ([1, 0], [1]), ([0, 0, 0, 0], [0])]
    assert len({b.untyped_storage().data_ptr() for b, _ in scheds}) == 1
    assert kernels.upload_schedules([], 3, "cpu") == []
    for bids, n in (([0, 3], 2), ([0, -1], 2), ([0, 1], 3), ([0, 1], -1)):
        with pytest.raises(ValueError, match="schedule"):
            kernels.upload_schedules([(np.array(bids, np.int32), n)], 3, "cpu")
    # Entries past n_real are padding and are not checked.
    kernels.check_schedule(np.array([1, 99], np.int32), 1, 3)


@pytest.mark.parametrize("bad", ["tile", "ref_lo", "block_id", "n_real",
                                 "dtype", "device"])
def test_wrapper_rejects_what_the_kernel_does_not_take(bad):
    x = _block_inputs(8, 768, 256)
    t = _torch_operands(x)
    tile, ref_lo, bids, n_real = 128, 0, [0, 1], 2
    m = t["m_t"]
    if bad == "tile":
        tile = 64
    elif bad == "ref_lo":
        ref_lo = 64
    elif bad == "block_id":
        bids = [0, 3]
    elif bad == "n_real":
        n_real = 3
    elif bad == "dtype":
        m = m.to(torch.int32)
    args = (m[:tile], m, t["sup"][:tile], t["ok"][:tile], t["gid"][:tile],
            t["code"][:tile], t["v1"][:tile], t["v2"][:tile], t["gid"],
            t["code"], t["v1"], torch.as_tensor(np.asarray(bids, np.int32)),
            torch.tensor([n_real], dtype=torch.int32))
    if bad == "device":
        args = tuple(a.to("meta") for a in args[:11]) + args[11:]
    with pytest.raises((ValueError, TypeError)):
        kernels.fused_cind_blocks(*args, ref_lo=ref_lo, ref_chunk=128)


def test_pack_bool_matches():
    rng = np.random.default_rng(9)
    for c in (32, 96, 100):
        x = rng.random((7, c)) < 0.4
        want = np.asarray(jcooc.pack_bool(jnp.asarray(x))).view(np.int32)
        np.testing.assert_array_equal(tcooc.pack_bool(torch.as_tensor(x))
                                      .numpy(), want)
