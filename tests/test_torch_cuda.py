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
from rdfind_tpu_torch.ops import cooc, kernels, sketch
from rdfind_tpu_torch.utils import synth

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda", 0)


def _block(seed, l_pad, c_pad, device):
    rng = np.random.default_rng(seed)
    m = (rng.random((l_pad, c_pad)) < 0.03).astype(np.int8)
    m[:, c_pad // 2:c_pad // 2 + 96] |= m[:, :96]
    mt = torch.as_tensor(m).to(device)
    cols, rows = cooc.sweep_operands(
        mt.sum(dim=0, dtype=torch.int32),
        torch.as_tensor(rng.choice([12, 17, 20, 35], c_pad).astype(np.int32))
        .to(device),
        torch.as_tensor(rng.integers(0, 3, c_pad).astype(np.int32)).to(device),
        torch.as_tensor(rng.integers(-1, 3, c_pad).astype(np.int32))
        .to(device), 2)
    return mt, cols, rows


@pytest.mark.parametrize("lo,width,blocks,n_real,ref_lo,ref_chunk", [
    (0, 256, [0, 1, 2, 3, 4], 5, 0, 512),  # full schedule, full ref axis
    (128, 128, [3, 1, 0, 0], 2, 0, 512),   # padded schedule entries
    (0, 128, [0, 0], 0, 0, 512),           # empty schedule
    (256, 128, [0, 2], 2, 256, 128),       # diagonal block
])
def test_k1_kernel_matches_plain(cuda, lo, width, blocks, n_real, ref_lo,
                                 ref_chunk):
    m, cols, rows = _block(0, 1280, 512, cuda)  # five 256-line blocks
    sl = slice(lo, lo + width)
    args = (m[:, sl], m, cols["sup"][sl], cols["ok"][sl], cols["gid"][sl],
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


@pytest.mark.parametrize("strategy", [2, 3])
def test_approximate_strategies_on_cuda_equal_cpu(cuda, strategy):
    triples = synth.generate_triples(3000, seed=5)
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
