"""Bloom sketches and K2: the port's ops/sketch.py and the plain version of
``kernels.packed_contains_matrix`` against the JAX package, on the CPU.

Inputs are made with numpy from a seed and handed to both packages.  The Pallas
kernel runs in interpret mode, as the JAX package's own tests run it.  Every
output is a bit, a position or a count: all comparisons are exact.  Packed words
are uint32 in the JAX package and the same bit patterns as int32 in the port.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rdfind_tpu.ops import hashing as jhashing
from rdfind_tpu.ops import pallas_kernels
from rdfind_tpu.ops import sketch as jsketch
from rdfind_tpu_torch import state
from rdfind_tpu_torch.ops import hashing as thashing
from rdfind_tpu_torch.ops import kernels
from rdfind_tpu_torch.ops import sketch as tsketch


@pytest.fixture(autouse=True, scope="module")
def _release_jax_programs():
    """Drop the XLA programs compiled in and before this module: each keeps
    executable memory mappings, and a test process that gathers too many hits
    the kernel's per-process map limit (vm.max_map_count) inside XLA."""
    jax.clear_caches()
    yield
    jax.clear_caches()


def _i32(words) -> np.ndarray:
    """JAX uint32 words -> the int32 bit patterns the port holds."""
    return np.array(words).view(np.int32)


def _edge_ids(seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    top = np.iinfo(np.int32).max
    return np.concatenate([
        np.arange(0, 16), top - np.arange(16), -np.arange(1, 17),
        [np.iinfo(np.int32).min, -top],
        rng.integers(np.iinfo(np.int32).min, top, 200)]).astype(np.int32)


@pytest.mark.parametrize("seed", [0, 1, 7])
def test_hash_cols_matches_jax(seed):
    ids = _edge_ids(seed)
    other = np.roll(ids, 3)
    want = np.asarray(jhashing.hash_cols([jnp.asarray(ids), jnp.asarray(other)],
                                         seed=seed))
    got = thashing.hash_cols([torch.as_tensor(ids), torch.as_tensor(other)],
                             seed=seed)
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))


@pytest.mark.parametrize("num_hashes", [1, 4, 7])
@pytest.mark.parametrize("bits", [32, 2048, 16384])
def test_bit_positions_match_jax(bits, num_hashes):
    ids = _edge_ids(bits + num_hashes)
    want = np.asarray(jsketch.bit_positions(jnp.asarray(ids), bits=bits,
                                            num_hashes=num_hashes))
    got = tsketch.bit_positions(torch.as_tensor(ids), bits=bits,
                                num_hashes=num_hashes)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("bits", [48, 16, 0])
def test_bit_positions_refuse_widths_that_are_not_powers_of_two(bits):
    with pytest.raises(ValueError, match="power of two"):
        tsketch.bit_positions(torch.zeros(2, dtype=torch.int32), bits=bits,
                              num_hashes=2)


@pytest.mark.parametrize("bits", [32, 256])
def test_pack_and_unpack_planes_match_jax(bits):
    rng = np.random.default_rng(bits)
    planes = (rng.random((37, bits)) < 0.4).astype(np.uint8)
    packed = _i32(jsketch.pack_planes(jnp.asarray(planes)))
    np.testing.assert_array_equal(
        tsketch.pack_planes(torch.as_tensor(planes)).numpy(), packed)
    words = rng.integers(0, 1 << 32, (37, bits // 32), dtype=np.uint32)
    np.testing.assert_array_equal(
        tsketch.unpack_planes(torch.as_tensor(_i32(words))).numpy(),
        np.asarray(jsketch.unpack_planes(jnp.asarray(words))))


def _rows(seed, n_rows, num_lines, num_caps):
    """(line, capture) rows with a fifth of them invalid."""
    rng = np.random.default_rng(seed)
    gid = rng.integers(0, num_lines, n_rows).astype(np.int32)
    cap = rng.integers(0, num_caps, n_rows).astype(np.int32)
    valid = rng.random(n_rows) < 0.8
    return gid, cap, valid


@pytest.mark.parametrize("bits,num_hashes", [(32, 1), (256, 4), (2048, 7)])
def test_build_line_blooms_matches_jax(bits, num_hashes):
    gid, cap, valid = _rows(bits, 300, 40, 90)
    want = jsketch.build_line_blooms(
        jnp.asarray(gid), jnp.asarray(cap), jnp.asarray(valid), num_lines=40,
        bits=bits, num_hashes=num_hashes)
    got = tsketch.build_line_blooms(
        torch.as_tensor(gid), torch.as_tensor(cap), torch.as_tensor(valid),
        num_lines=40, bits=bits, num_hashes=num_hashes)
    np.testing.assert_array_equal(got.numpy(), _i32(want))


@pytest.mark.parametrize("budget", [None, 1 << 12])
@pytest.mark.parametrize("bits", [32, 512])
def test_intersect_dep_sketches_acc_matches_jax(monkeypatch, bits, budget):
    """Random accumulator and rows (invalid ones included; some captures with
    no row keep their sketch); a tiny budget splits the dependents into groups."""
    if budget is not None:
        monkeypatch.setattr(tsketch, "AND_BYTES_BUDGET", budget)
    rng = np.random.default_rng(bits)
    num_caps, num_lines, w = 150, 60, bits // 32
    gid, cap, valid = _rows(bits + 1, 400, num_lines, num_caps - 20)
    # Dense line Blooms, so that ANDs of a few lines keep bits.
    blooms = rng.integers(0, 1 << 32, (num_lines, w), dtype=np.uint32)
    blooms |= rng.integers(0, 1 << 32, (num_lines, w), dtype=np.uint32)
    acc = rng.integers(0, 1 << 32, (num_caps, w), dtype=np.uint32)
    want = jsketch.intersect_dep_sketches_acc(
        jnp.asarray(acc), jnp.asarray(cap), jnp.asarray(blooms)[gid],
        jnp.asarray(valid))
    got = tsketch.intersect_dep_sketches_acc(
        torch.as_tensor(_i32(acc)), torch.as_tensor(cap),
        torch.as_tensor(gid), torch.as_tensor(_i32(blooms)),
        torch.as_tensor(valid))
    np.testing.assert_array_equal(got.numpy(), _i32(want))
    want_fresh = jsketch.intersect_dep_sketches(
        jnp.asarray(cap), jnp.asarray(blooms)[gid], jnp.asarray(valid),
        num_caps=num_caps, bits=bits)
    got_fresh = tsketch.intersect_dep_sketches(
        torch.as_tensor(cap), torch.as_tensor(_i32(blooms[gid])),
        torch.as_tensor(valid), num_caps=num_caps, bits=bits)
    np.testing.assert_array_equal(got_fresh.numpy(), _i32(want_fresh))


@pytest.mark.parametrize("bits,num_hashes", [(32, 4), (2048, 4), (1024, 7)])
def test_pack_ref_bits_matches_jax(bits, num_hashes):
    ids = _edge_ids(num_hashes)
    words, popc = jsketch.pack_ref_bits(jnp.asarray(ids), bits=bits,
                                        num_hashes=num_hashes)
    got_words, got_popc = tsketch.pack_ref_bits(
        torch.as_tensor(ids), bits=bits, num_hashes=num_hashes)
    np.testing.assert_array_equal(got_words.numpy(), _i32(words))
    np.testing.assert_array_equal(got_popc.numpy(), np.asarray(popc))


def _contains_inputs(seed, d, r, bits, num_hashes=4, n_pad=0):
    """Dep sketches that are ORs of a few refs' bit sets (so that many refs are
    contained) and random words; the last `n_pad` refs are padding (zero rows,
    popc -1)."""
    rng = np.random.default_rng(seed)
    ref_ids = rng.integers(0, 5000, r).astype(np.int32)
    words, popc = jsketch.pack_ref_bits(jnp.asarray(ref_ids), bits=bits,
                                        num_hashes=num_hashes)
    words, popc = np.array(words), np.array(popc)
    sk = rng.integers(0, 1 << 32, (d, bits // 32), dtype=np.uint32)
    sk &= rng.integers(0, 1 << 32, (d, bits // 32), dtype=np.uint32)
    for i in range(d):
        for j in rng.choice(r, 3, replace=False):
            sk[i] |= words[j]
    if n_pad:
        words[-n_pad:] = 0
        popc[-n_pad:] = -1
    return ref_ids, sk, words, popc


@pytest.mark.parametrize("bits,n_pad", [(32, 0), (2048, 0), (2048, 64),
                                        (16384, 0)])
def test_contains_plain_matches_pallas_interpret(bits, n_pad):
    """D = R = 256; W = 1, 64 and 512 (more than one of K2's 32-word chunks);
    padded refs with popc -1 never match."""
    ref_ids, sk, words, popc = _contains_inputs(bits, 256, 256, bits,
                                                n_pad=n_pad)
    want = np.asarray(pallas_kernels.packed_contains_matrix(
        jnp.asarray(sk), jnp.asarray(words), jnp.asarray(popc),
        interpret=True))
    got = kernels.packed_contains_matrix(
        torch.as_tensor(_i32(sk)), torch.as_tensor(_i32(words)),
        torch.as_tensor(popc))
    assert got.dtype == torch.uint8
    np.testing.assert_array_equal(got.numpy(), want)
    assert 0 < want.sum() < want.size
    if n_pad:
        assert not want[:, -n_pad:].any()
    else:
        jnp_out = np.asarray(jsketch._contains_matrix_jnp(
            jnp.asarray(sk), jnp.asarray(ref_ids), jnp.ones(256, bool),
            bits=bits, num_hashes=4))
        np.testing.assert_array_equal(got.numpy().astype(bool), jnp_out)


@pytest.mark.parametrize("d,r", [(100, 70), (64, 64), (5, 300)])
def test_contains_matrix_matches_jax(d, r):
    """Shapes off K2's block (the port pads both sides) and a ref mask."""
    bits = 512
    ref_ids, sk, _, _ = _contains_inputs(d * r, d, r, bits)
    valid = np.random.default_rng(d).random(r) < 0.7
    want = np.asarray(jsketch.contains_matrix(
        jnp.asarray(sk), jnp.asarray(ref_ids), jnp.asarray(valid), bits=bits,
        num_hashes=4, backend="jnp"))
    got = tsketch.contains_matrix(
        torch.as_tensor(_i32(sk)), torch.as_tensor(ref_ids),
        torch.as_tensor(valid), bits=bits, num_hashes=4)
    np.testing.assert_array_equal(got.numpy(), want)
    assert want.any()


def test_contains_wrapper_checks_its_operands():
    sk = torch.zeros((64, 2), dtype=torch.int32)
    popc = torch.zeros(64, dtype=torch.int32)
    with pytest.raises(ValueError, match="multiples"):
        kernels.packed_contains_matrix(sk[:32], sk, popc)
    with pytest.raises(ValueError, match="power of two"):
        kernels.packed_contains_matrix(torch.zeros((64, 3), dtype=torch.int32),
                                       torch.zeros((64, 3), dtype=torch.int32),
                                       popc)
    with pytest.raises(TypeError):
        kernels.packed_contains_matrix(sk.to(torch.int64), sk, popc)
    with pytest.raises(ValueError, match="shapes"):
        kernels.packed_contains_matrix(sk, sk, popc[:10])


def test_contains_wrapper_checks_row_alignment():
    """Rows of four or more words are staged with 16-byte copies: a contiguous
    view one word into its storage is refused; with one word per row, 4-byte
    alignment is enough."""
    popc = torch.full((64,), -1, dtype=torch.int32)
    buf = torch.zeros(64 * 64 + 1, dtype=torch.int32)
    odd = buf[1:].reshape(64, 64)
    assert odd.is_contiguous() and odd.data_ptr() % 16
    with pytest.raises(ValueError, match="aligned"):
        kernels.packed_contains_matrix(odd, torch.zeros_like(odd), popc)
    with pytest.raises(ValueError, match="aligned"):
        kernels.packed_contains_matrix(torch.zeros_like(odd), odd, popc)
    narrow = buf[1:65].reshape(64, 1)
    out = kernels.packed_contains_matrix(narrow, torch.zeros_like(narrow), popc)
    assert out.shape == (64, 64) and not out.any()


def test_probes_plain_versions_give_the_tpu_probes_answers():
    """P1 and P2 on the CPU: the answers the TPU probes expect."""
    x = torch.arange(2, dtype=torch.int32).reshape(1, 2)
    assert kernels.repeat_probe(x).tolist() == [[0, 1, 0, 1]]
    assert bool((kernels.pipeline_probe(torch.ones((16, 128))) == 2.0).all())
    kernels.check_contains_library(torch.device("cpu"))


def test_stage_state_carries_packed_words_bit_for_bit():
    rng = np.random.default_rng(3)
    words = rng.integers(0, 1 << 32, (128, 4), dtype=np.uint32)
    words[0, 0] = 0xFFFFFFFF
    popc = rng.integers(1, 5, 128).astype(np.int32)
    dev = state.stage_state_to_device(
        {"sketches": words, "ref_packed": words, "ref_popc": popc}, "cpu")
    for key in ("sketches", "ref_packed"):
        assert dev[key].dtype == torch.int32
        np.testing.assert_array_equal(dev[key].numpy(), _i32(words))
    assert dev["sketches"][0, 0].item() == -1
    np.testing.assert_array_equal(dev["ref_popc"].numpy(), popc)
