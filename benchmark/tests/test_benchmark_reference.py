"""The plain reference against the port, at tiny sizes: strategy 0 and 2
(every CIND), strategies 1 and 3 (the small-to-large output rule), the CLI's
sorted output lines, and the port's definitional oracle."""

import numpy as np
import pytest

import rdfind_tpu_torch as port
from benchmark import gen
from benchmark.reference import cinds
from rdfind_tpu_torch import oracle

def lubm(departments, seed):
    """One university of `departments` departments."""
    return gen.generate_lubm(1, seed, departments=departments)


# (seed, departments, support)
CASES = [(1, 1, 3), (2, 2, 8), (3, 1, 10)]


def port_rows(t, support, strategy, **kw):
    table = port.discover(t, support, strategy=strategy, device="cpu", **kw)
    return np.stack([np.asarray(c, np.int64) for c in table.columns()], 1) \
        if len(table) else np.zeros((0, 7), np.int64)


@pytest.mark.parametrize("seed,n,support", CASES)
def test_reference_equals_the_definition(seed, n, support):
    t = lubm(n, seed)
    want = np.array(sorted(oracle.discover_cinds_definitional(
        [tuple(r) for r in t.tolist()], support)), np.int64).reshape(-1, 7)
    got = cinds.rows(cinds.discover(t, support))
    assert len(got) > 0
    assert cinds.mismatched_rows(got, want) == 0


@pytest.mark.parametrize("strategy,kw", [
    (0, {}), (2, {}), (0, {"pair_backend": "chunked"}),
    (1, {}), (3, {}), (1, {"use_frequent_condition_filter": False}),
    (1, {"use_frequent_condition_filter": False, "pair_backend": "chunked"})])
@pytest.mark.parametrize("seed,n,support", CASES[:2])
def test_reference_equals_the_port(strategy, kw, seed, n, support):
    t = lubm(n, seed)
    want = cinds.rows(cinds.discover(t, support,
                                     lattice=strategy in (1, 3)))
    assert cinds.mismatched_rows(port_rows(t, support, strategy, **kw),
                                 want) == 0


def test_lattice_rule_leaves_out_implied_2x_cinds():
    t = lubm(1, 1)
    every = cinds.discover(t, 3)
    lat = cinds.discover(t, 3, lattice=True)
    assert 0 < len(lat["dep_code"]) < len(every["dep_code"])
    # Only binary dependents are left out.
    from benchmark.reference import codes
    dropped = cinds.mismatched_rows(cinds.rows(every), cinds.rows(lat))
    unary = codes.is_unary(every["dep_code"])
    assert dropped == len(every["dep_code"]) - len(lat["dep_code"])
    assert int(unary.sum()) == int(codes.is_unary(lat["dep_code"]).sum())


def test_blocks_give_the_same_answer(monkeypatch):
    t = lubm(1, 4)
    whole = cinds.rows(cinds.discover(t, 3))
    monkeypatch.setattr(cinds, "DEP_BLOCK", 7)
    monkeypatch.setattr(cinds, "PAIR_BLOCK", 33)
    assert cinds.mismatched_rows(cinds.rows(cinds.discover(t, 3)), whole) == 0


def test_mapped_ids_are_the_mapped_answer():
    t = lubm(1, 6)
    ids = gen.job_ids(int(t.max()) + 1, np.random.default_rng(6))
    a = cinds.rows(cinds.map_ids(cinds.discover(t, 4), ids))
    b = cinds.rows(cinds.discover(np.take(ids, t), 4))
    assert len(a) and cinds.mismatched_rows(a, b) == 0


def test_cli_output_lines(tmp_path):
    from rdfind_tpu_torch.programs import rdfind
    t = np.take(gen.job_ids(30000, np.random.default_rng(8)), lubm(1, 8))
    gen.write_nt(tmp_path / "in.nt", t)
    out = tmp_path / "out.txt"
    assert rdfind.main([str(tmp_path / "in.nt"), "--output", str(out),
                        "--support", "3", "--device", "cpu"]) == 0
    want = cinds.lines(cinds.discover(t, 3, lattice=True), gen.token)
    assert out.read_text().splitlines() == want


def test_mismatches_count_both_sides_and_duplicates():
    a = np.arange(21, dtype=np.int64).reshape(3, 7)
    assert cinds.mismatched_rows(a, a[::-1]) == 0
    assert cinds.mismatched_rows(a, a[:2]) == 1
    assert cinds.mismatched_rows(np.concatenate([a, a[:1]]), a) == 1
    b = a.copy()
    b[0, 6] += 1
    assert cinds.mismatched_rows(b, a) == 2


def test_control_breaks_the_support_guarantee():
    """The control (support one lower) is not correct at this size."""
    t = lubm(1, 11)
    want = cinds.rows(cinds.discover(t, 10))
    control = cinds.rows(cinds.discover(t, 9))
    assert cinds.mismatched_rows(control, want) > 100
