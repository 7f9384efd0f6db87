"""The port's fused single-device step against the JAX package's, on the CPU.

``rdfind_tpu_torch.models.allatonce.fused_step`` and the JAX package's jitted
``fused_step`` get the same triples (numpy, from a seed) and the same
configuration; the first n_cinds rows of the seven CIND columns, n_cinds and
overflow must be equal.  Tolerance: exact equality.  The port's step must also
run without a host sync (under a dispatch mode that refuses every op which
reads a device value on the host, sizes a tensor from one or copies host data
to the device), with shapes
that do not depend on n_valid or min_support.  Its CUDA graph
(``capture_fused_step``) runs only on the card: ``tests/test_torch_cuda.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from rdfind_tpu.models import allatonce as jallatonce
from rdfind_tpu.utils import synth as jsynth
from rdfind_tpu_torch import entry
from rdfind_tpu_torch.models import allatonce
from rdfind_tpu_torch.utils import synth
from torch_harness import port_module, time_limit  # noqa: F401

PAD = np.iinfo(np.int32).max


def _entry_triples():
    return synth.generate_triples(entry.ENTRY_TRIPLES, seed=entry.ENTRY_SEED)


def _padded():
    """400 of entry's triples and 112 padding rows."""
    t = _entry_triples().copy()
    t[400:] = PAD
    return t


def _jax_generator():
    """The JAX package's generator (its zipf stream depends on the numpy
    release) on entry's seed."""
    return np.asarray(jsynth.generate_triples(512, seed=7), np.int32)


# name -> (triples, n_valid, min_support, kwargs, (n_cinds, overflow) or
# None).  Entry's join lines hold 93,262 pairs; the capacity 60,000 cuts a
# line in two (the line over slot 60,000 has pairs on both sides of it) and
# keeps 1,339 CINDs.
CASES = {
    "entry": (_entry_triples, 512, 2, {}, (3490, 0)),
    "jax_generator": (_jax_generator, 512, 2, {}, None),
    "no_fc_filter": (_entry_triples, 512, 2, dict(use_fc_filter=False),
                     (3490, 0)),
    "projections_so": (_entry_triples, 512, 2, dict(projections="so"),
                       (1897, 0)),
    "padded_n_valid_400": (_padded, 400, 2, {}, (2235, 0)),
    "overflow_1k": (_entry_triples, 512, 2, dict(pair_capacity=1 << 10),
                    (0, 93_262 - (1 << 10))),
    "overflow_1k_jax_generator": (_jax_generator, 512, 2,
                                  dict(pair_capacity=1 << 10), None),
    "mid_line_60000": (_entry_triples, 512, 2, dict(pair_capacity=60_000),
                       (1339, 93_262 - 60_000)),
}


def _config(kwargs):
    out = dict(projections="spo", use_fc_filter=True,
               pair_capacity=entry.ENTRY_PAIR_CAPACITY)
    out.update(kwargs)
    return out


@pytest.mark.parametrize("case", sorted(CASES))
def test_fused_step_equals_jax(case):
    make, n_valid, support, kwargs, expected = CASES[case]
    t = make()
    kw = _config(kwargs)
    want = [np.asarray(x) for x in jallatonce.fused_step(
        jnp.asarray(t), jnp.int32(n_valid), jnp.int32(support), **kw)]
    got = allatonce.fused_step(torch.as_tensor(t), torch.tensor(n_valid),
                               torch.tensor(support), **kw)
    n = int(want[7])
    assert int(got[7]) == n
    assert int(got[8]) == int(want[8])
    for g, w in zip(got[:7], want[:7]):
        assert g.shape == (kw["pair_capacity"],)
        np.testing.assert_array_equal(g[:n].numpy(), w[:n])
    if expected is not None:
        assert (n, int(want[8])) == expected
    if "pair_capacity" in kwargs:
        assert int(want[8]) > 0


_aten = torch.ops.aten
# Ops that read a device value on the host or size their output from one,
# and lift_fresh, which makes a tensor of host data (a scalar written into a
# device tensor by index): a CUDA graph capture refuses that copy.
_SYNC_OPS = {_aten._local_scalar_dense.default, _aten.nonzero.default,
             _aten._unique2.default, _aten.unique_dim.default,
             _aten.unique_consecutive.default, _aten.masked_select.default,
             _aten.bincount.default, _aten.repeat_interleave.Tensor,
             _aten.lift_fresh.default}
_INDEX_OPS = {_aten.index.Tensor, _aten.index_put.default,
              _aten.index_put_.default}


class _RefuseHostSyncs(TorchDispatchMode):
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func in _SYNC_OPS:
            raise AssertionError(f"fused_step called {func}")
        if func in _INDEX_OPS and any(
                i is not None and i.dtype == torch.bool for i in args[1]):
            raise AssertionError(f"fused_step indexed with a mask ({func})")
        return func(*args, **(kwargs or {}))


def test_fused_step_runs_without_a_host_sync():
    """Under the dispatch mode no forbidden op runs, and two calls with
    other n_valid and min_support give outputs of the same shapes (both
    with CINDs and overflow)."""
    t = torch.as_tensor(_padded())
    counts = [torch.tensor(x) for x in (300, 2, 400, 3)]
    with _RefuseHostSyncs():
        a = allatonce.fused_step(t, counts[0], counts[1],
                                 pair_capacity=1 << 15)
        b = allatonce.fused_step(t, counts[2], counts[3],
                                 pair_capacity=1 << 15)
    assert [x.shape for x in a] == [x.shape for x in b]
    assert a[7].shape == () and a[8].shape == ()
    assert min(int(a[7]), int(a[8]), int(b[7]), int(b[8])) > 0


def test_the_mode_catches_a_host_sync():
    """The dispatch mode refuses the ops of the dynamic stages."""
    t = torch.as_tensor(_entry_triples())
    with _RefuseHostSyncs(), pytest.raises(AssertionError):
        allatonce._stage_candidates(t, 2, projections="spo",
                                    use_fc_filter=True)


def test_entry_runs_the_step_on_its_flagship_configuration():
    fn, (t, n_valid, support) = entry.entry("cpu")
    assert fn.keywords == dict(projections="spo", use_fc_filter=True,
                               pair_capacity=1 << 17)
    assert t.shape == (512, 3) and t.dtype == torch.int32
    assert (int(n_valid), int(support)) == (512, 2)
    out = fn(t, n_valid, support)
    assert (int(out[7]), int(out[8])) == (3490, 0)


def test_capture_and_entry_need_the_card(monkeypatch):
    """capture_fused_step refuses the CPU (a graph replays on the card);
    with no device and no CUDA, entry() and capture_fused_step raise."""
    with pytest.raises(ValueError, match="CUDA"):
        allatonce.capture_fused_step(16, device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        entry.entry()
    with pytest.raises(RuntimeError, match="CUDA"):
        allatonce.capture_fused_step(16)
