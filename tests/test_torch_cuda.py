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
from rdfind_tpu_torch.ops import cooc, kernels
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
