"""Synthetic RDF workload generation for benchmarks and tests.

Shapes the data like the reference's target datasets (LUBM / DBpedia, BASELINE.md):
a few predicates with zipf-ish popularity, subject/object pools with heavy reuse so
join lines have a realistic power-law size distribution (incl. hub values), and
enough value overlap across predicates that real CINDs exist.

The generators are those of the JAX package with one change: zipf variates come
from ``zipf`` below instead of ``numpy.random.Generator.zipf``, whose stream
changed between numpy releases (2.0.2 and 2.3.5 give different draws for one
seed).  ``zipf`` consumes only ``Generator.random``, whose stream numpy keeps
stable, so a seed gives the same triples under every numpy release; hand the
same array to both packages when comparing them.  The delta-batch helpers
(``grow_delta_batches``, ``apply_delta``), the overlay
``inject_cind_structure`` and the writers ``triples_to_tokens`` /
``write_nt`` are the JAX package's, copied.
"""

from __future__ import annotations

from collections import Counter

import numpy as np


def zipf(rng: np.random.Generator, a: float, size: int) -> np.ndarray:
    """``size`` Zipf(a) variates (int64, >= 1), a > 1.

    Devroye's rejection method (the one numpy's zipf uses), vectorized over
    batches of uniforms from ``rng.random``.
    """
    am1 = a - 1.0
    b = 2.0 ** am1
    out = np.empty(size, np.int64)
    filled = 0
    while filled < size:
        n = size - filled
        u = 1.0 - rng.random(n + n // 2 + 16)  # in (0, 1]
        v = rng.random(u.size)
        x = np.floor(u ** (-1.0 / am1))
        big = x >= 2.0 ** 62  # too large for int64: rejected
        x = np.where(big, 1.0, x)
        t = (1.0 + 1.0 / x) ** am1
        ok = ~big & (v * x * (t - 1.0) / (b - 1.0) <= t / b)
        acc = x[ok][:n].astype(np.int64)
        out[filled:filled + acc.size] = acc
        filled += acc.size
    return out


def generate_triples(n: int, seed: int = 0, n_predicates: int = 24,
                     n_entities: int | None = None) -> np.ndarray:
    """(n, 3) int32 id triples.  Ids are disjoint across fields except that objects
    reuse the subject pool with probability ~0.3 (URI objects), creating cross-field
    join lines like real RDF."""
    rng = np.random.default_rng(seed)
    if n_entities is None:
        n_entities = max(16, n // 8)
    n_literals = max(16, n // 4)

    # Zipf-ish predicate popularity.
    ranks = np.arange(1, n_predicates + 1, dtype=np.float64)
    p_pred = (1.0 / ranks) / (1.0 / ranks).sum()
    pred = rng.choice(n_predicates, size=n, p=p_pred).astype(np.int32)

    # Subjects: zipf-ish entity reuse.
    subj = (zipf(rng, 1.3, n) % n_entities).astype(np.int32)

    # Objects: 30% entity pool (URIs), 70% literal pool; literals skewed so a few
    # hub values produce giant join lines.
    is_uri = rng.random(n) < 0.3
    obj_uri = (zipf(rng, 1.3, n) % n_entities).astype(np.int32)
    obj_lit = (zipf(rng, 1.5, n) % n_literals).astype(np.int32)

    # Field-disjoint id spaces (except subj/obj URI sharing).
    subj_ids = subj
    pred_ids = n_entities + pred
    obj_ids = np.where(is_uri, obj_uri, n_entities + n_predicates + obj_lit)
    return np.stack([subj_ids, pred_ids, obj_ids.astype(np.int32)], axis=1)


def inject_cind_structure(triples: np.ndarray, n_rules: int = 32,
                          ref_size: int = 150,
                          dep_size: int = 120) -> np.ndarray:
    """Append a structured overlay that plants genuine high-support CINDs.

    Independent draws cannot sustain exact containment at high support (more
    triples per capture means more distinct values), while real RDF has
    structural inclusions (every <x a :Professor> is also <x a :Person>).
    For each of ``n_rules`` fresh predicate pairs (a, b), ``ref_size`` fresh
    subjects get (s, b, o_s) and the first ``dep_size`` of them also get
    (s, a, o'_s), so s[p=a] < s[p=b] holds with support ``dep_size``; every
    odd rule shares one object on the referenced side, which plants 1/2
    CINDs too.  Fresh id ranges leave the base distribution alone.
    """
    base = int(triples.max()) + 1 if triples.size else 0
    rows = []
    for k in range(n_rules):
        subj = base + np.arange(ref_size, dtype=np.int64)
        pred_a = base + ref_size + 2 * k
        pred_b = pred_a + 1
        obj_b = base + ref_size + 2 * n_rules + np.arange(ref_size)
        obj_a = obj_b + ref_size  # distinct object pool per side
        if k % 2 == 0:
            rows.append(np.stack([subj, np.full(ref_size, pred_b), obj_b], 1))
        else:
            hub = obj_b[0]
            rows.append(np.stack([subj, np.full(ref_size, pred_b),
                                  np.full(ref_size, hub)], 1))
        rows.append(np.stack([subj[:dep_size], np.full(dep_size, pred_a),
                              obj_a[:dep_size]], 1))
        base = int(max(obj_a.max(), pred_b)) + 1
    overlay = np.concatenate(rows).astype(np.int32)
    return np.concatenate([np.asarray(triples, np.int32), overlay])


def generate_planted_cinds(n_rules: int, support: int, *,
                           ref_size: int | None = None,
                           base_triples: np.ndarray | None = None,
                           seed: int = 0):
    """CIND-dense planted workload: ``n_rules`` MINIMAL CINDs per family.

    At support >= 1000 the
    zipf-shaped generators emit 5-276 CINDs, so minimality cleanup, family
    split, decode, and sinks run at toy volume while the pair phase runs at
    scale.  This generator plants inclusion structure whose CIND count
    scales with ``n_rules``: one rule per family per k, each surviving the
    implied-CIND cleanup (so the counts hold for raw AllAtOnce output AND
    for the minimal set every strategy converges to under clean_implied) —
    ``n_rules = 2500`` at ``support = 1000`` yields >= 10^4 minimal CINDs
    across all four families.

    Per rule k (fresh id ranges, so rules never interact), with S_dep the
    first ``support`` of ``ref_size`` fresh referenced subjects:

    * family 1/1: dep (s, pa, o_s) / ref (s, pb, o'_s), per-row distinct
      objects — binary captures stay infrequent, so s[pa] < s[pb] is the
      only (and minimal) planted CIND;
    * family 1/2: ref rows share object hub_b, so the minimal form is
      s[pa] < s[pb, o=hub_b] (the implied 1/1 against s[pb] is cleaned);
    * family 2/1: dep rows share object hub_a AND ``spoiler`` extra dep
      subjects outside the ref break the unary inclusion, so
      s[pa, o=hub_a] < s[pb] is minimal (no implying 1/1 exists);
    * family 2/2: both hubs plus spoilers: s[pa, o=hub_a] < s[pb, o=hub_b]
      minimal.

    Returns (triples, expected): ``expected`` maps family -> planted count,
    a LOWER bound on the CIND count per family (hub/unary ref captures of equal
    extent add a few benign same-rule CINDs on top).

    ``base_triples`` prepends a background workload (e.g. generate_triples)
    in its own id range, for realism without perturbing the planted counts.
    """
    if ref_size is None:
        ref_size = support + max(support // 4, 8)
    if ref_size <= support:
        raise ValueError("ref_size must exceed support (strict inclusion)")
    n_spoil = max(2, support // 8)
    rows = []
    base = 0
    if base_triples is not None and base_triples.size:
        rows.append(np.asarray(base_triples, np.int32))
        base = int(base_triples.max()) + 1
    del seed  # deterministic by construction; kept for API symmetry

    def fresh(n):
        nonlocal base
        out = base + np.arange(n, dtype=np.int64)
        base += n
        return out

    for _ in range(n_rules):
        for dep_binary, ref_binary in ((False, False), (False, True),
                                       (True, False), (True, True)):
            subj = fresh(ref_size)
            pa, pb = fresh(1)[0], fresh(1)[0]
            # Referenced side: hub object (binary ref capture frequent and
            # equal-extent with the unary) or per-row distinct objects
            # (binary ref captures infrequent).
            obj_b = (np.full(ref_size, fresh(1)[0]) if ref_binary
                     else fresh(ref_size))
            rows.append(np.stack([subj, np.full(ref_size, pb), obj_b], 1))
            # Dependent side over the first `support` referenced subjects.
            obj_a = (np.full(support, fresh(1)[0]) if dep_binary
                     else fresh(support))
            rows.append(np.stack([subj[:support], np.full(support, pa),
                                  obj_a], 1))
            if dep_binary:
                # Spoilers: the binary dep (pa, o=hub_a) must not be implied
                # by EITHER of its unary parents, so both get broken on
                # subjects outside the ref: pa rows with distinct non-hub
                # objects (s[pa] not included) and hub_a rows under a fresh
                # predicate (s[o=hub_a] not included).  The binary capture
                # itself stays exactly the dependent subjects.
                rows.append(np.stack([fresh(n_spoil),
                                      np.full(n_spoil, pa),
                                      fresh(n_spoil)], 1))
                rows.append(np.stack([fresh(n_spoil),
                                      np.full(n_spoil, fresh(1)[0]),
                                      np.full(n_spoil, obj_a[0])], 1))
    if base >= np.iinfo(np.int32).max:
        raise ValueError("planted workload exceeds int32 id space")
    triples = np.concatenate(rows).astype(np.int32) if rows else \
        np.zeros((0, 3), np.int32)
    expected = {f: n_rules for f in ("11", "12", "21", "22")}
    return triples, expected


def generate_dbpedia_shaped(n: int, seed: int = 0) -> np.ndarray:
    """(n, 3) int32 triples with DBpedia-like cardinalities for SCALE runs.

    What the quadratic pair phase squares over is the number of FREQUENT
    captures per join line, so the generator controls per-id degrees
    directly: zipf draws are split into degree-capped clones (subjects and
    URI objects cap at ~64 rows per generation call, literals at ~128 —
    below a support-1000 threshold, like the long tail of real DBpedia),
    plus ~200 enumeration-style hub literals (country/type names) whose
    degree is ~n * 1.5e-4: they clear support 1000 once n >= ~7M and stay
    infrequent below that (at the measured 2M scale point object conditions
    are all infrequent, so its CINDs are predicate-level).  Predicates
    follow a 1.2-exponent
    zipf over ~1.2k ids with a true rdf:type-like hub.  Total line-pair
    volume then scales like n * cap — the reference's target regime — not
    with the hottest id.
    """
    rng = np.random.default_rng(seed)
    n_subj = max(64, n // 12)
    n_pred = 1200
    n_lit = max(64, n // 6)
    n_hub_lit = 200

    def capped_zipf(a, size, n_vals, cap):
        """Zipf-shaped draws with per-id degree capped at ~cap rows.

        The per-call random base keeps independently-seeded chunks from
        stacking degrees on the same ids (rank 1 clone 0 must not map to one
        global id across every chunk of a chunked generation — that would
        grow hub degree as cap x n_chunks and void the cap).
        """
        v = zipf(rng, a, size)
        order = np.argsort(v, kind="stable")
        vs = v[order]
        run_start = np.flatnonzero(np.r_[True, vs[1:] != vs[:-1]])
        run_len = np.diff(np.append(run_start, len(vs)))
        within = np.arange(len(vs)) - np.repeat(run_start, run_len)
        clone = within // cap
        base = rng.integers(0, n_vals)
        ids = (vs * 1000003 + clone * 7919 + base) % n_vals
        out = np.empty(size, np.int64)
        out[order] = ids
        return out.astype(np.int32)

    subj = capped_zipf(1.7, n, n_subj, 64)
    ranks = np.arange(1, n_pred + 1, dtype=np.float64)
    p_pred = (1.0 / ranks ** 1.2)
    p_pred /= p_pred.sum()
    pred = rng.choice(n_pred, size=n, p=p_pred).astype(np.int32)
    is_uri = rng.random(n) < 0.4
    obj_uri = capped_zipf(1.7, n, n_subj, 64)
    obj_lit = capped_zipf(2.1, n, n_lit, 128)
    # Enumeration-style hub literals: uncapped, genuinely frequent objects.
    is_hub = (~is_uri) & (rng.random(n) < 0.05)
    obj_lit = np.where(is_hub, n_lit + rng.integers(0, n_hub_lit, n),
                       obj_lit).astype(np.int32)

    subj_ids = subj
    pred_ids = n_subj + pred
    obj_ids = np.where(is_uri, obj_uri,
                       n_subj + n_pred + obj_lit)
    return np.stack([subj_ids, pred_ids, obj_ids.astype(np.int32)], axis=1)


def triples_to_tokens(triples: np.ndarray) -> list[tuple[str, str, str]]:
    """Integer id triples -> the `<v%09d>` URI tokens the .nt writers emit.

    Zero-padded, so the tokens' lexicographic order is the ids' numeric
    order: a run that interns the file ranks the tokens as the generator
    ranked the ids."""
    return [tuple(f"<v{int(v):09d}>" for v in row)
            for row in np.asarray(triples).reshape(-1, 3)]


def write_nt(path, triples: np.ndarray) -> None:
    """Write integer id triples as an .nt file (one line per row)."""
    with open(path, "w") as f:
        for s, p, o in triples_to_tokens(triples):
            f.write(f"{s} {p} {o} .\n")


def grow_delta_batches(triples: np.ndarray, frac: float, seed: int = 0):
    """Grow an insert/delete script touching ~`frac` of the workload.

    Returns (inserts, deletes): `deletes` are rows sampled from `triples`
    (each retracts one line), `inserts` are half recombinations of existing
    values (perturbing existing join lines) and half rows over brand-new
    ids past the current maximum (minting new dictionary values — and with
    them new buckets — in the delta run).  Row counts split the change
    budget evenly; at least one of each when frac > 0."""
    t = np.asarray(triples, np.int64)
    n = t.shape[0]
    rng = np.random.default_rng(seed)
    n_changes = max(2, int(round(n * frac)))
    n_del = max(1, n_changes // 2)
    n_ins = max(1, n_changes - n_del)
    deletes = t[rng.choice(n, size=min(n_del, n), replace=False)]
    n_recomb = n_ins // 2
    pool = np.unique(t.reshape(-1))
    recomb = rng.choice(pool, size=(n_recomb, 3))
    base = int(t.max()) + 1 if n else 0
    fresh = base + np.arange((n_ins - n_recomb) * 3,
                             dtype=np.int64).reshape(-1, 3)
    inserts = np.concatenate([recomb.reshape(-1, 3), fresh])
    return inserts.astype(np.int64), deletes.astype(np.int64)


def apply_delta(triples: np.ndarray, inserts: np.ndarray,
                deletes: np.ndarray) -> np.ndarray:
    """The updated dataset a from-scratch comparator runs on: multiset
    minus one occurrence per delete row, plus the insert rows (mirrors the
    delta engine's bag semantics)."""
    t = [tuple(r) for r in np.asarray(triples, np.int64).tolist()]
    pending = Counter(map(tuple, np.asarray(deletes, np.int64).tolist()))
    kept = []
    for row in t:
        if pending.get(row, 0) > 0:
            pending[row] -= 1
            continue
        kept.append(row)
    out = kept + [tuple(r) for r in np.asarray(inserts, np.int64).tolist()]
    return (np.asarray(out, np.int64).reshape(-1, 3)
            if out else np.zeros((0, 3), np.int64))
