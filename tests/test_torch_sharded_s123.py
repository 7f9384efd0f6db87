"""Sharded strategies 1-3 and the preshard stages of the port, on the CPU.

The preshard stages (``count_fcs_sharded``, ``join_histogram_sharded``,
``mine_ars_sharded``, ``dedupe_preshard``) run on one 4-rank gloo launch over
the contiguous split a one-host sharded ingest makes, and must equal the JAX
package's at 4 devices on the same split; the four strategies over that
preshard must give the JAX single-device twins' tables.  The rest runs on a
one-rank mesh in this process: the half-approximate knobs, the saturating
fold of the count-min partials against ``merge_count_min`` at, below and past
the cap, the pair keys against the JAX package's, the capture and sketch
budget guards, and the three strategies against the JAX twins.  Tolerance:
exact equality throughout.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_rank_cases
from rdfind_tpu.models import allatonce as jallatonce
from rdfind_tpu.models import approximate as japproximate
from rdfind_tpu.models import late_bb as jlate_bb
from rdfind_tpu.models import sharded as jsharded
from rdfind_tpu.models import small_to_large as jsmall_to_large
from rdfind_tpu.ops import frequency as jfrequency
from rdfind_tpu.parallel.mesh import host_gather, make_global, make_mesh
from rdfind_tpu_torch.models import sharded
from rdfind_tpu_torch.ops import sketch
from rdfind_tpu_torch.parallel import launch
from rdfind_tpu_torch.parallel.mesh import Mesh
from rdfind_tpu_torch.utils import synth
from torch_harness import port_module, time_limit  # noqa: F401

TWINS = {0: jallatonce.discover, 1: jsmall_to_large.discover,
         2: japproximate.discover, 3: jlate_bb.discover}


@pytest.fixture(autouse=True)
def _clean_env(monkeypatch):
    for k in ("RDFIND_SHARDED_HALF_APPROX", "RDFIND_SHARDED_HA_BITS",
              "RDFIND_FAULTS", "RDFIND_HOST_CAPTURES_BUDGET"):
        monkeypatch.delenv(k, raising=False)


def _ruled():
    """Triples with a planted perfect-confidence rule (s=900 -> p=901)."""
    t = np.asarray(synth.generate_triples(300, seed=13, n_predicates=5,
                                          n_entities=30), np.int32)
    rule = np.asarray([(900, 901, 950 + i) for i in range(6)], np.int32)
    return np.concatenate([t, rule])


SUPPORT = 2


@pytest.fixture(scope="module")
def port(tmp_path_factory):
    return torch_rank_cases.shared_result(
        tmp_path_factory, "torch_sharded_preshard4",
        lambda: launch.spawn(torch_rank_cases.preshard_cases, 4,
                             args=(_ruled(), SUPPORT), device="cpu",
                             timeout_s=100))


def _jax_preshard(triples, mesh):
    padded, n_valid, _ = jsharded._shard_triples(np.asarray(triples, np.int32),
                                                 mesh.devices.size)
    return make_global(padded, mesh), make_global(n_valid, mesh)


@pytest.fixture(scope="module")
def jax_mesh4():
    return make_mesh(4)


def test_count_fcs_sharded_equals_jax(port, jax_mesh4):
    g = _jax_preshard(_ruled(), jax_mesh4)
    assert port["fcs"] == jsharded.count_fcs_sharded(
        *g, SUPPORT, jax_mesh4, include_binary=True)
    assert port["fcs_unary"] == jsharded.count_fcs_sharded(
        *g, SUPPORT, jax_mesh4, include_binary=False)


@pytest.mark.parametrize("projections", ["spo", "po"])
def test_join_histogram_sharded_equals_jax(port, jax_mesh4, projections):
    g = _jax_preshard(_ruled(), jax_mesh4)
    want = jsharded.join_histogram_sharded(*g, projections, jax_mesh4)
    assert port["histogram" if projections == "spo"
                else "histogram_po"] == want
    assert want


def test_mine_ars_sharded_equals_jax(port, jax_mesh4):
    g = _jax_preshard(_ruled(), jax_mesh4)
    want = jsharded.mine_ars_sharded(*g, SUPPORT, jax_mesh4)
    got = port["rules"]
    assert [np.asarray(c).tolist() for c in got] == \
        [np.asarray(c).tolist() for c in want]
    # The same rule set as mining the whole host table.
    host = jfrequency.mine_association_rules(_ruled(), SUPPORT)
    rows = {tuple(int(c[i]) for c in host) for i in range(len(host[0]))}
    assert {tuple(int(c[i]) for c in got)
            for i in range(len(got[0]))} == rows
    assert (1, 2, 900, 901) in {r[:4] for r in rows}


def test_dedupe_preshard_equals_jax(port, jax_mesh4):
    t = _ruled()
    dup = np.concatenate([t, t[: len(t) // 2]])
    out, n_valid, total = jsharded.dedupe_preshard(
        *_jax_preshard(dup, jax_mesh4), jax_mesh4)
    rows = np.asarray(host_gather(out)).reshape(4, -1, 3)
    counts = np.asarray(host_gather(n_valid)).reshape(-1)
    assert port["dedupe_total"] == total == len(np.unique(t, axis=0))
    assert port["dedupe_counts"] == counts.tolist()
    want = np.concatenate([rows[r, :counts[r]] for r in range(4)])
    assert np.array_equal(port["dedupe_rows"], want)


@pytest.mark.parametrize("strategy", [0, 1, 2, 3])
def test_strategies_over_a_preshard_equal_the_twins(port, strategy):
    want = TWINS[strategy](_ruled(), SUPPORT,
                           use_frequent_condition_filter=True,
                           use_association_rules=True).to_rows()
    assert port["tables"][strategy] == want
    assert want


# ---------------------------------------------------------------------------
# One-rank mesh, in this process.
# ---------------------------------------------------------------------------


def test_half_approx_knobs_resolve_like_jax(monkeypatch):
    for v in (None, "0", "1", "on", "auto"):
        if v is None:
            monkeypatch.delenv("RDFIND_SHARDED_HALF_APPROX", raising=False)
        else:
            monkeypatch.setenv("RDFIND_SHARDED_HALF_APPROX", v)
        assert sharded.sharded_half_approx_enabled() == \
            jsharded.sharded_half_approx_enabled()
    for bits in ("1000", "7", "65536"):
        monkeypatch.setenv("RDFIND_SHARDED_HA_BITS", bits)
        assert sharded.sharded_ha_bits() == jsharded.sharded_ha_bits()


@pytest.mark.parametrize("scale", ["below", "at", "past"])
def test_ha_fold_saturates_as_merge_count_min(scale):
    """The saturating int32 fold of a rank's partials, then the all-reduce:
    min(cap, sum) per counter, as merge_count_min, whether the sums stay
    below the cap, reach it exactly or pass it."""
    cap = sketch.MAX_COUNT_MIN_CAP
    rng = np.random.default_rng(5)
    parts = rng.integers(0, 40, (5, 64)).astype(np.int32)
    if scale == "at":
        parts[:, 3] = 0
        parts[0, 3], parts[1, 3] = cap - 7, 7
    elif scale == "past":
        parts[:, :8] = cap - 3
    got = sharded._ha_reduce_step(Mesh(), torch.as_tensor(parts), cap=cap)
    want = np.minimum(parts.astype(np.int64).sum(0), cap)
    assert np.array_equal(got.numpy(), want)
    assert torch.equal(got, sketch.merge_count_min(list(torch.as_tensor(parts)),
                                                   cap=cap))
    if scale == "at":
        assert int(got[3]) == cap
    if scale == "past":
        assert (got[:8] == cap).all()


def test_ha_pair_keys_equal_jax():
    rng = np.random.default_rng(3)
    cols = [rng.integers(-2**31, 2**31 - 1, 200, dtype=np.int64).astype(
        np.int32) for _ in range(6)]
    want = np.asarray(jsharded._ha_pair_keys([jnp.asarray(c) for c in cols]))
    got = sharded._ha_pair_keys([torch.as_tensor(c) for c in cols]).numpy()
    assert np.array_equal(got & 0xFFFFFFFF, want.astype(np.int64) & 0xFFFFFFFF)


def _plain():
    """Small: a one-rank mesh plans every buffer for the whole load."""
    return np.asarray(synth.generate_triples(120, seed=11, n_predicates=5,
                                             n_entities=30), np.int32)


@pytest.mark.parametrize("strategy", [1, 2, 3])
def test_one_rank_strategies_equal_the_twins(strategy):
    stats = {}
    got = sharded.STRATEGIES[strategy](_plain(), 3, device="cpu",
                                       use_fis=False, stats=stats)
    want = TWINS[strategy](_plain(), 3, use_frequent_condition_filter=False)
    assert got.to_rows() == want.to_rows()
    assert stats["dist_backend"] == "none" and stats["world_size"] == 1


def test_capture_table_budget_guard(monkeypatch):
    monkeypatch.setenv("RDFIND_HOST_CAPTURES_BUDGET", "1")
    with pytest.raises(ValueError, match="RDFIND_HOST_CAPTURES_BUDGET"):
        sharded.discover_sharded_s2l(_plain(), 3, device="cpu")


def test_sketch_planes_budget_guard(monkeypatch):
    monkeypatch.setattr(sharded, "SKETCH_PLANES_BUDGET", 1)
    with pytest.raises(ValueError, match="RDFIND_SKETCH_PLANES_BUDGET"):
        sharded.discover_sharded_approx(_plain(), 3, device="cpu")


def test_discover_on_rejects_an_unknown_strategy():
    with pytest.raises(ValueError, match="unknown traversal strategy 7"):
        sharded.discover_on(_plain(), 3, 2, strategy=7, device="cpu")
