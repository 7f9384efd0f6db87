"""The port's small helpers against the JAX package's, on the CPU.

The capture-code helpers (``conditions``) over every code, as ints and as int
tensors; the synth overlay and writers (equal arrays, equal file bytes); the
fixed-shape exchange volume; the launcher's bounded rendezvous retry
(``launch.join_group``, driven with a stand-in ``init_process_group`` and an
in-process store, no processes), mirroring the JAX package's
``ensure_distributed`` tests; the sharded ingest's local ingest on the
streamed engine against the serial engine and the JAX package's
``_local_ingest_streamed``; the kernel-mode record on the debug lines.  Tolerance: exact equality.
"""

import datetime

import numpy as np
import pytest
import torch
import torch.distributed as dist

from rdfind_tpu import conditions as jcc
from rdfind_tpu.parallel import exchange as jexchange
from rdfind_tpu.runtime import multihost_ingest as jmultihost_ingest
from rdfind_tpu.utils import synth as jsynth
from rdfind_tpu_torch import conditions as cc
from rdfind_tpu_torch.io import native as tnative
from rdfind_tpu_torch.obs import metrics
from rdfind_tpu_torch.parallel import exchange, launch
from rdfind_tpu_torch.runtime import faults, multihost_ingest
from rdfind_tpu_torch.utils import synth
from torch_harness import port_module, time_limit  # noqa: F401


ALL_CODES = list(range(256))
UNARY_HELPERS = ("add_secondary", "add_first_secondary",
                 "add_second_secondary", "is_valid_standard_capture")


def bits(x):
    return {b for b in (1, 2, 4) if x & b}


@pytest.mark.parametrize("name", UNARY_HELPERS)
def test_code_helper_equals_jax_on_every_code(name):
    """Each helper on all 256 codes: as ints equal to the JAX package's,
    and on one int tensor equal to the ints elementwise."""
    got = [getattr(cc, name)(c) for c in ALL_CODES]
    assert got == [getattr(jcc, name)(c) for c in ALL_CODES]
    vec = getattr(cc, name)(torch.arange(256, dtype=torch.int32))
    assert vec.tolist() == [int(g) if not isinstance(g, bool) else g
                            for g in got]


def test_merge_equals_jax_and_takes_tensors():
    pairs = [(a, b) for a in range(64) for b in range(64)]
    assert [cc.merge(a, b) for a, b in pairs] == \
        [jcc.merge(a, b) for a, b in pairs]
    a = torch.tensor([a for a, _ in pairs])
    b = torch.tensor([b for _, b in pairs])
    assert cc.merge(a, b).tolist() == [a | b for a, b in pairs]
    assert (cc.SUBJECT_PREDICATE, cc.SUBJECT_OBJECT, cc.PREDICATE_OBJECT) \
        == (jcc.SUBJECT_PREDICATE, jcc.SUBJECT_OBJECT, jcc.PREDICATE_OBJECT)


def test_valid_standard_captures_enumeration():
    """The oracle of the JAX package's own test: 1-2 primary bits, one
    secondary bit, disjoint, six bits; 6 unary and 3 binary codes."""
    expected = set()
    for code in range(64):
        prim, sec = bits(code & 7), bits((code >> 3) & 7)
        if 1 <= len(prim) <= 2 and len(sec) == 1 and not (prim & sec):
            expected.add(code)
    got = {code for code in ALL_CODES if cc.is_valid_standard_capture(code)}
    assert got == expected == set(cc.ALL_VALID_CAPTURE_CODES)
    assert cc.ALL_VALID_CAPTURE_CODES == jcc.ALL_VALID_CAPTURE_CODES
    assert len([c for c in got if cc.is_unary(c)]) == 6
    assert len([c for c in got if cc.is_binary(c)]) == 3
    codes = torch.tensor(cc.ALL_VALID_CAPTURE_CODES, dtype=torch.int32)
    assert bool(cc.is_valid_standard_capture(codes).all())


def test_secondary_helpers_pick_the_unused_fields():
    for code in range(8):
        out = cc.add_secondary(code)
        assert bits(out & 7) == bits(code)
        assert bits((out >> 3) & 7) == bits(7) - bits(code)
    for code in (1, 2, 4, 3, 5, 6):
        free = sorted(bits(7) - bits(code))
        first = cc.add_first_secondary(code)
        assert bits(first & 7) == bits(code)
        assert bits((first >> 3) & 7) == {free[0]}
        if len(free) > 1:
            second = cc.add_second_secondary(code)
            assert bits((second >> 3) & 7) == {free[1]}
    code2 = cc.add_secondary(cc.SUBJECT_PREDICATE)
    assert cc.pretty(code2, "x", "y") == "o[s=x,p=y]"


@pytest.mark.parametrize("kw", [{}, dict(n_rules=5, ref_size=20, dep_size=7)])
def test_inject_cind_structure_equals_jax(kw):
    base = synth.generate_triples(300, seed=2)
    got = synth.inject_cind_structure(base, **kw)
    want = jsynth.inject_cind_structure(base, **kw)
    assert got.dtype == want.dtype == np.int32
    np.testing.assert_array_equal(got, want)
    empty = np.zeros((0, 3), np.int32)
    np.testing.assert_array_equal(synth.inject_cind_structure(empty, **kw),
                                  jsynth.inject_cind_structure(empty, **kw))


def test_tokens_and_nt_file_equal_jax(tmp_path):
    t = synth.inject_cind_structure(synth.generate_triples(200, seed=5),
                                    n_rules=2, ref_size=8, dep_size=5)
    assert synth.triples_to_tokens(t) == jsynth.triples_to_tokens(t)
    synth.write_nt(tmp_path / "port.nt", t)
    jsynth.write_nt(tmp_path / "jax.nt", t)
    assert (tmp_path / "port.nt").read_bytes() == \
        (tmp_path / "jax.nt").read_bytes()


@pytest.mark.parametrize("num_dev,capacity,lanes",
                         [(1, 1, 1), (4, 1024, 3), (8, 1 << 20, 5)])
def test_exchange_volume_bytes_equals_jax(num_dev, capacity, lanes):
    assert exchange.exchange_volume_bytes(num_dev, capacity, lanes) == \
        jexchange.exchange_volume_bytes(num_dev, capacity, lanes)


# ---------------------------------------------------------------------------
# The bounded rendezvous retry, with no processes.
# ---------------------------------------------------------------------------


def _join(monkeypatch, init):
    """join_group on an in-process store of one rank, with `init` standing
    in for init_process_group; returns (retries, the store, the stores the
    attempts got, the process groups torn down)."""
    seen, teardowns = [], []

    def fake_init(*, store, **kw):
        seen.append(store)
        init(len(seen))

    monkeypatch.setattr(dist, "init_process_group", fake_init)
    monkeypatch.setattr(dist, "destroy_process_group",
                        lambda: teardowns.append(1))
    monkeypatch.setenv("RDFIND_BACKOFF_BASE_MS", "1")
    store = dist.HashStore()
    out = launch.join_group(store, 0, 1, backend="gloo",
                            timeout=datetime.timedelta(seconds=5))
    return out, store, seen, teardowns


def test_join_group_retries_then_joins(monkeypatch):
    metrics.reset()

    def init(attempt):
        if attempt < 3:
            raise RuntimeError("rendezvous timed out")

    out, store, seen, teardowns = _join(monkeypatch, init)
    assert out == 2 and len(seen) == 3
    assert teardowns == []  # the failed attempts never joined
    # Each attempt had its own prefix of the store: only the third wrote.
    assert store.check(["init2/joined0"])
    assert not store.check(["init0/joined0"])
    assert not store.check(["init1/joined0"])
    assert metrics.registry().snapshot()["distributed_init_retries"] == 2


def test_join_group_exhaustion_and_preempted_passthrough(monkeypatch):
    monkeypatch.setenv("RDFIND_INIT_RETRIES", "2")

    def always_fail(attempt):
        raise RuntimeError("rendezvous timed out")

    with pytest.raises(RuntimeError, match="after 2 attempts"):
        _join(monkeypatch, always_fail)

    def preempted(attempt):
        raise faults.Preempted("preempted during init")

    calls = []
    monkeypatch.setenv("RDFIND_INIT_RETRIES", "5")
    with pytest.raises(faults.Preempted):
        _join(monkeypatch, lambda a: (calls.append(a), preempted(a)))
    assert calls == [1]


def test_join_group_tears_down_a_joined_attempt_whose_barrier_fails(
        monkeypatch):
    """An attempt that joined but whose store barrier raised leaves its
    process group before the next attempt."""
    teardowns = []
    real_wait = dist.PrefixStore.wait
    waits = []

    def flaky_wait(self, keys, *args):
        waits.append(keys)
        if len(waits) == 1:
            raise RuntimeError("barrier timed out")
        return real_wait(self, keys, *args)

    monkeypatch.setattr(dist.PrefixStore, "wait", flaky_wait)
    out, _, seen, teardowns = _join(monkeypatch, lambda a: None)
    assert out == 1 and len(seen) == 2 and teardowns == [1]


# ---------------------------------------------------------------------------
# The streamed local ingest of the sharded ingest.
# ---------------------------------------------------------------------------


def test_streamed_local_ingest_equals_serial_and_jax(tmp_path, monkeypatch):
    """RDFIND_INGEST_THREADS=2: a host's local ingest runs the native
    engine's streamed loop (``native.ingest_files`` with more than one
    thread: IngestStream + BlockAssembler, the loop of the JAX package's
    ``_local_ingest_streamed``); its rows and dictionary equal the serial
    engine's and the JAX package's streamed ingest, byte for byte."""
    from test_torch_cli import settle_jax_native

    settle_jax_native()
    assert tnative.available(), tnative.unavailable_reason()
    paths = []
    for i in range(3):
        t = synth.generate_triples(400, seed=20 + i, n_predicates=5)
        p = tmp_path / f"part{i}.nt"
        synth.write_nt(p, t)
        paths.append(str(p))
    monkeypatch.setenv("RDFIND_INGEST_THREADS", "2")
    monkeypatch.setenv("RDFIND_INGEST_CHUNK_BYTES", "4096")
    streamed = []
    real = tnative._ingest_parallel
    monkeypatch.setattr(tnative, "_ingest_parallel",
                        lambda *a, **k: streamed.append(1) or real(*a, **k))
    stats = {}
    ids, dictionary = multihost_ingest._local_ingest(
        paths, False, False, "utf-8", stats=stats)
    assert streamed == [1] and stats["n_threads"] == 2
    serial = tnative.ingest_files(paths, threads=1)
    want = jmultihost_ingest._local_ingest_streamed(paths, False, False)
    for other in (serial, want):
        np.testing.assert_array_equal(ids, other[0])
        assert ids.dtype == other[0].dtype == np.int32
        assert list(dictionary.values) == list(other[1].values)


# ---------------------------------------------------------------------------
# The kernel-mode record and the --debug lines that read it.
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("strategy", [0, 1, 2, 3, "sharded"])
def test_kernel_resolution_reaches_the_debug_lines(strategy):
    """Every strategy (and the sharded pipeline on a one-rank mesh)
    publishes stats["kernel_resolution"] with the JAX package's keys; the
    dense-plan or cooc-dtype debug line carries its kernel fields."""
    from rdfind_tpu.ops import cooc as jcooc
    from rdfind_tpu_torch.models import sharded
    from rdfind_tpu_torch.obs import report

    t = synth.generate_triples(300, seed=4, n_predicates=5, n_entities=30)
    stats = {}
    if strategy == "sharded":
        sharded.discover_sharded(t, 2, device="cpu", stats=stats)
    else:
        import rdfind_tpu_torch
        rdfind_tpu_torch.discover(t, 2, strategy=strategy, device="cpu",
                                  stats=stats)
    kr = stats["kernel_resolution"]
    assert set(jcooc.resolution_report()) <= set(kr)
    assert (kr["kernel_dtype"], kr["plane_bits"], kr["k1_route"],
            kr["k2_route"]) == ("int8", 8, "plain", "plain")
    lines = [ln for ln in report.format_debug_lines(stats)
             if ln.startswith(("dense plan:", "cooc dtype:"))]
    assert len(lines) == 1
    assert "planes=8b" in lines[0] and "kernel=int8/int8 emit=0" in lines[0]
    assert "fused=1" in lines[0]
