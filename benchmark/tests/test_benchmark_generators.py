"""The benchmark's LUBM generator: UBA's profile, the same draw for the same
seed, and job ids that change the input and keep the work."""

import numpy as np
import pytest

from benchmark import gen

P = dict(zip(gen.PROPERTIES, range(len(gen.PROPERTIES))))


def by_property(t):
    """The draw's rows by property: the properties are the first terms
    made and all occur, so dense id i is ``PROPERTIES[i]``."""
    return {name: t[t[:, 1] == i] for name, i in P.items()}


@pytest.mark.parametrize("seed", [0, 42, 3000000001, 2 ** 33 + 7])
def test_draw_keeps_the_profile(seed):
    t = gen.generate_lubm(1, seed, departments=2)
    rows = by_property(t)
    assert t.dtype == np.int32 and t.shape[1] == 3
    assert len(np.unique(t, axis=0)) == len(t)
    faculty = len(rows["worksFor"])  # of both departments
    lo = sum(c[0] for c, _ in gen.UBA["faculty"].values())
    hi = sum(c[1] for c, _ in gen.UBA["faculty"].values())
    assert 2 * lo <= faculty <= 2 * hi
    # Students: 8-14 undergraduates and 3-4 graduates per faculty member.
    assert (8 + 3) * faculty <= len(rows["memberOf"]) <= (14 + 4) * faculty
    # One telephone literal, one department head each, degrees from the pool.
    assert len(np.unique(rows["telephone"][:, 2])) == 1
    assert len(rows["headOf"]) == 2
    assert len(np.unique(rows["doctoralDegreeFrom"][:, 2])) <= 1000
    # Each undergraduate takes 2-4 distinct courses.
    s, n = np.unique(rows["takesCourse"][:, 0], return_counts=True)
    assert n.min() >= 1 and n.max() <= 4


def test_lubm1_is_about_a_hundred_thousand_triples():
    t = gen.generate_lubm(1, 42)
    assert 60_000 <= len(t) <= 170_000


def test_same_seed_same_draw_and_large_seeds():
    a = gen.generate_lubm(1, 2 ** 31 + 12345, departments=1)
    b = gen.generate_lubm(1, 2 ** 31 + 12345, departments=1)
    np.testing.assert_array_equal(a, b)
    assert not np.array_equal(a, gen.generate_lubm(1, 2 ** 31,
                                                   departments=1))


def test_job_ids_change_the_input_and_keep_the_work():
    """Each job's ids are another input over one structure: the same join
    lines, captures and CINDs, mapped by the increasing id map."""
    from benchmark import roofline
    from benchmark.reference import cinds
    base = gen.generate_lubm(1, 42, departments=1)
    k = int(base.max()) + 1
    ia = gen.job_ids(k, np.random.default_rng([7, 2, 1]))
    ib = gen.job_ids(k, np.random.default_rng([7, 2, 2]))
    assert ia.dtype == np.int32 and (np.diff(ia) > 0).all()
    assert 0 <= ia.min() and ia.max() < gen.ID_SPACE
    assert not np.array_equal(ia, ib)
    a, b = np.take(ia, base), np.take(ib, base)
    assert roofline.k1_work(a, 5) == roofline.k1_work(base, 5)
    want = cinds.discover(base, 5)
    for ids, t in ((ia, a), (ib, b)):
        got = cinds.rows(cinds.discover(t, 5))
        assert len(got) > 0
        assert cinds.mismatched_rows(
            got, cinds.rows(cinds.map_ids(want, ids))) == 0


def test_make_input_draws_the_configuration_once():
    cfg = {"generator": "lubm", "data_seed": 42,
           "generator_args": {"universities": 1, "departments": 1}}
    a, b = gen.make_input(cfg, 1), gen.make_input(cfg, 2)
    assert a.shape == b.shape and not np.array_equal(a, b)
    np.testing.assert_array_equal(np.unique(a, axis=0), np.unique(b, axis=0))


def test_write_nt_tokens(tmp_path):
    t = np.array([[1, 2, 300000000]], np.int32)
    gen.write_nt(tmp_path / "a.nt", t)
    assert (tmp_path / "a.nt").read_text() == \
        f"{gen.token(1)} {gen.token(2)} {gen.token(300000000)} .\n"
