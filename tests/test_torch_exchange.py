"""The port's bucket exchanges against the JAX package's, on the CPU.

``bucket_of`` and ``digest_fold`` run in-process against the JAX functions.  The
collectives run on one 4-rank gloo group (``parallel/launch.py``; the rank side
is ``torch_rank_cases.exchange_cases``) and on a 4-device sub-mesh of JAX's CPU
devices under ``shard_map``, on the same seeded inputs with a scattered validity
mask.  Receive buffers, validity, overflow and replies must be equal slot for
slot, flat and hierarchical (2 hosts x 2 local).  Tolerance: exact equality
throughout.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_rank_cases
from rdfind_tpu.ops import hashing as jhashing
from rdfind_tpu.parallel import exchange as jexchange
from rdfind_tpu.parallel.mesh import AXIS, make_mesh, shard_map
from rdfind_tpu_torch.ops import hashing as thashing
from rdfind_tpu_torch.ops import segments as tsegments
from rdfind_tpu_torch.parallel import exchange as texchange
from rdfind_tpu_torch.parallel import launch

N_PER_RANK = 64
WORLD = 4


@pytest.fixture(autouse=True, scope="module")
def _release_jax_programs():
    """Drop the XLA programs compiled in and before this module (each keeps
    executable mappings; a test process has a per-process map limit)."""
    jax.clear_caches()
    yield
    jax.clear_caches()


def _u32_cols(seed, n=4096, k=3):
    """Columns spanning the whole uint32 range, held as int32 bit patterns."""
    rng = np.random.default_rng(seed)
    cols = [rng.integers(0, 1 << 32, n, dtype=np.uint64).astype(np.uint32)
            .view(np.int32) for _ in range(k)]
    for c in cols:  # the extremes, explicitly
        c[:4] = np.array([0, -1, np.iinfo(np.int32).max,
                          np.iinfo(np.int32).min], np.int32)
    return cols


@pytest.mark.parametrize("seed,buckets", [(0, 1), (1, 4), (2, 7), (3, 1024),
                                          (4, (1 << 31) - 1)])
def test_bucket_of_equals_jax(seed, buckets):
    """Exact equality with JAX's device law and with host_bucket_of."""
    cols = _u32_cols(seed)
    want = np.asarray(jhashing.bucket_of([jnp.asarray(c) for c in cols],
                                         buckets, seed=seed))
    got = thashing.bucket_of([torch.as_tensor(c) for c in cols], buckets,
                             seed=seed).numpy()
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        thashing.host_bucket_of(cols, buckets, seed=seed), want)


@pytest.mark.parametrize("seed,frac", [(5, 1.0), (6, 0.5), (7, 0.0)])
def test_digest_fold_equals_jax(seed, frac):
    """The uint32 wraparound lane: exact, and split sums reduce to it."""
    cols = _u32_cols(seed)
    valid = np.random.default_rng(seed).random(cols[0].shape[0]) < frac
    want = int(np.asarray(jhashing.digest_fold(
        [jnp.asarray(c) for c in cols], jnp.asarray(valid), seed=seed))) \
        & 0xFFFFFFFF
    tcols = [torch.as_tensor(c) for c in cols]
    tvalid = torch.as_tensor(valid)
    assert int(thashing.digest_fold(tcols, tvalid, seed=seed)) == want
    half = cols[0].shape[0] // 2
    parts = [thashing.digest_fold([c[sl] for c in tcols], tvalid[sl],
                                  seed=seed)
             for sl in (slice(0, half), slice(half, None))]
    assert int(sum(parts)) & 0xFFFFFFFF == want


def test_sorted_join_counts_equals_jax():
    rng = np.random.default_rng(9)
    tk = [np.sort(rng.choice(500, 64, replace=False)).astype(np.int32)]
    tc = rng.integers(1, 9, 64).astype(np.int32)
    tv = rng.random(64) < 0.8
    qk = [rng.integers(0, 520, 200).astype(np.int32)]
    qv = rng.random(200) < 0.6
    want = np.asarray(jexchange.sorted_join_counts(
        [jnp.asarray(tk[0])], jnp.asarray(tc), jnp.asarray(tv),
        [jnp.asarray(qk[0])], jnp.asarray(qv)))
    got = texchange.sorted_join_counts(
        [torch.as_tensor(tk[0])], torch.as_tensor(tc), torch.as_tensor(tv),
        [torch.as_tensor(qk[0])], torch.as_tensor(qv)).numpy()
    np.testing.assert_array_equal(got, want)


def test_fixed_shape_segments_equal_jax():
    """padded_unique / masked_weighted_row_counts against JAX's
    masked_unique / masked_weighted_row_counts, row for row."""
    from rdfind_tpu.ops import segments as jsegments
    rng = np.random.default_rng(12)
    cols = [rng.integers(0, 12, 300).astype(np.int32) for _ in range(2)]
    w = rng.integers(0, 5, 300).astype(np.int32)
    valid = rng.random(300) < 0.7
    jc, jv, _, jn = jsegments.masked_unique([jnp.asarray(c) for c in cols],
                                            jnp.asarray(valid))
    tc, tv, _, tn = tsegments.padded_unique(
        [torch.as_tensor(c) for c in cols], torch.as_tensor(valid))
    assert int(tn) == int(jn)
    for a, b in zip(tc, jc):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    want = np.asarray(jsegments.masked_weighted_row_counts(
        [jnp.asarray(c) for c in cols], jnp.asarray(w), jnp.asarray(valid)))
    got = tsegments.masked_weighted_row_counts(
        [torch.as_tensor(c) for c in cols], torch.as_tensor(w),
        torch.as_tensor(valid)).numpy()
    np.testing.assert_array_equal(got, want)


def _data():
    rng = np.random.default_rng(3)
    n = WORLD * N_PER_RANK
    return dict(a=rng.integers(0, 40, n).astype(np.int32),
                b=rng.integers(0, 1000, n).astype(np.int32),
                w=rng.integers(1, 4, n).astype(np.int32),
                valid=rng.random(n) < 0.45)  # scattered, not a prefix


def _jax_cases(data):
    """The same cases as torch_rank_cases.exchange_cases under shard_map."""
    mesh = make_mesh(WORLD)
    names = []

    def step(a, b, w, valid):
        bucket = jhashing.bucket_of([a], WORLD, seed=3)
        outs = []
        for name, cap, hier in (("flat", 32, None), ("flat_tight", 8, None),
                                ("hier", 32, (2, 2)),
                                ("hier_tight", 8, (2, 2))):
            cols, ov, ovf, st = jexchange.route([a, b], valid, bucket, AXIS,
                                                cap, hier=hier)
            answer = jnp.where(ov, cols[0] * 3 + cols[1], 0)
            back = jexchange.route_reply(answer, st, AXIS)
            outs.append((f"route_{name}", [cols[0], cols[1], ov,
                                            jnp.full(1, ovf), back]))
            counts, c_ovf = jexchange.global_row_counts(
                [a], valid, AXIS, cap, seed=5, hier=hier, dcn_capacity=cap)
            outs.append((f"counts_{name}", [counts, jnp.full(1, c_ovf)]))
        for name, cap, dcap in (("roomy", 32, 32), ("tight", 32, 8)):
            cols, cw, ov, (o1, o2), st = jexchange.route_combined(
                [a], w, valid, bucket, AXIS, cap, dcap, (2, 2))
            back = jexchange.route_combined_reply(
                jnp.where(ov, cols[0] + cw, 0), st, AXIS)
            outs.append((f"combined_{name}", [cols[0], cw, ov,
                                               jnp.full(1, o1),
                                               jnp.full(1, o2), back]))
        n_f, f_ovf = jexchange.global_distinct_frequent(
            [a], valid, 3, AXIS, 32, seed=5)
        outs.append(("distinct_frequent", [jnp.full(1, n_f),
                                           jnp.full(1, f_ovf)]))
        table = (b[:16] % 7).astype(jnp.int32)
        outs.append(("sketch_allreduce", [
            jexchange.sketch_allreduce(table, AXIS, cap=9),
            jexchange.sketch_allreduce(table, AXIS, cap=9, hier=(2, 2))]))
        names[:] = [(k, len(v)) for k, v in outs]
        return tuple(x for _, v in outs for x in v)

    spec = jax.sharding.PartitionSpec(AXIS)
    flat = jax.jit(shard_map(step, mesh=mesh, in_specs=(spec,) * 4,
                             out_specs=spec, check_vma=False))(
        *(jnp.asarray(data[k]) for k in ("a", "b", "w", "valid")))
    out, i = {}, 0
    for name, k in names:
        vals = [np.asarray(x) for x in flat[i:i + k]]
        # Scalar lanes are replicated: one device's copy is the answer.
        out[name] = [v if v.shape[0] != WORLD else int(v[0]) for v in vals]
        i += k
    return out


@pytest.fixture(scope="module")
def both(tmp_path_factory):
    data = _data()

    def compute():
        port = launch.spawn(torch_rank_cases.exchange_cases, WORLD,
                            args=(data,), device="cpu")
        return port, _jax_cases(data)

    return torch_rank_cases.shared_result(tmp_path_factory, "torch_exchange",
                                          compute)


CASES = ["route_flat", "route_flat_tight", "route_hier", "route_hier_tight",
         "counts_flat", "counts_flat_tight", "counts_hier",
         "counts_hier_tight", "combined_roomy", "combined_tight",
         "distinct_frequent", "sketch_allreduce"]


@pytest.mark.parametrize("case", CASES)
def test_exchange_equals_jax_slot_for_slot(both, case):
    port, want = both
    got = port[case]
    assert len(got) == len(want[case])
    for g, w in zip(got, want[case]):
        if isinstance(w, int):
            assert g == w, case
        else:
            np.testing.assert_array_equal(np.asarray(g), w, err_msg=case)


@pytest.mark.parametrize("case", CASES)
def test_fixed_wire_equals_jax_slot_for_slot(both, case):
    """NCCL's wire sends whole fixed-shape blocks, with no trim: the same
    receive buffers, run here on the gloo group with the trim off."""
    port, want = both
    got = port["fixed/" + case]
    assert len(got) == len(want[case])
    for g, w in zip(got, want[case]):
        if isinstance(w, int):
            assert g == w, case
        else:
            np.testing.assert_array_equal(np.asarray(g), w, err_msg=case)


def test_tight_capacities_overflow(both):
    """The tight cases really overflow (the counters are compared above)."""
    port, _ = both
    assert port["route_flat_tight"][3] > 0
    assert port["combined_tight"][4] > 0
    assert port["route_flat"][3] == 0


def test_hierarchical_receive_equals_flat(both):
    """The two-hop path lands every row where the flat path does."""
    port, _ = both
    for a, b in zip(port["route_flat"], port["route_hier"]):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


@pytest.mark.parametrize("k", [1, 2, 3, 6, 7])
def test_lexsort_packing_keeps_numpys_stable_order(k):
    """lexsort packs adjacent int32 keys pairwise into int64 keys; the
    permutation must stay numpy's stable lexsort's at the int32 extremes."""
    rng = np.random.default_rng(k)
    vals = np.array([np.iinfo(np.int32).min, -5, -1, 0, 1, 3,
                     np.iinfo(np.int32).max], np.int64)
    cols = [rng.choice(vals, 3000).astype(np.int32) for _ in range(k)]
    if k == 3:
        cols[1] = cols[1].astype(np.int64)  # a lone int64 key in the middle
    want = np.lexsort(tuple(reversed(cols)))
    got = tsegments.lexsort([torch.as_tensor(c) for c in cols]).numpy()
    np.testing.assert_array_equal(got, want)
