"""K1's work count, from the input alone, against a brute-force count."""

from collections import defaultdict

import numpy as np
import pytest

from benchmark import gen, roofline


def brute_force(triples, min_support):
    ext = defaultdict(set)
    for t in map(tuple, np.asarray(triples).tolist()):
        for pi in range(3):
            a, b = [i for i in range(3) if i != pi]
            for cap in ((pi, "u", a, t[a]), (pi, "u", b, t[b]),
                        (pi, "b", t[a], t[b])):
                ext[cap].add(t[pi])
    freq = {c for c, e in ext.items() if len(e) >= min_support}
    per_value = defaultdict(int)
    for c in freq:
        for v in ext[c]:
            per_value[v] += 1
    ops = 2 * sum(n * n for n in per_value.values())
    nbytes = sum(per_value.values()) + (len(freq) ** 2 + 7) // 8
    return ops, nbytes


@pytest.mark.parametrize("seed,departments,support", [
    (1, 1, 3), (2, 2, 10), (3, 1, 2)])
def test_k1_work_matches_brute_force(seed, departments, support):
    t = gen.generate_lubm(1, seed, departments=departments)
    assert roofline.k1_work(t, support) == brute_force(t, support)


def test_k1_work_ignores_id_shifts_and_row_order():
    t = gen.generate_lubm(1, 9, departments=1)
    perm = np.random.default_rng(0).permutation(len(t))
    assert roofline.k1_work(t, 3) == roofline.k1_work(t[perm] + 1000, 3)


def test_least_seconds_takes_the_larger_bound():
    peaks = roofline.peaks_for("NVIDIA H100 80GB HBM3")
    assert roofline.least_seconds(1979e12, 0, peaks) == pytest.approx(1.0)
    assert roofline.least_seconds(0, 3.35e12, peaks) == pytest.approx(1.0)
    assert roofline.peaks_for("cpu") is None
