"""The benchmark's data: LUBM's university data, drawn by UBA's profile.

LUBM (Guo, Pan and Heflin, "LUBM: A benchmark for OWL knowledge base
systems", Journal of Web Semantics 3(2-3), 2005, section "Data Generation
and OWL Datasets") generates its data with UBA, the Univ-Bench Artificial
data generator, from a fixed profile: for each university 15-25
departments, and for each department the counts and relations in ``UBA``
below.  ``generate_lubm`` draws the same classes, properties, counts and
relations from that profile, as (N, 3) int32 term ids: one id per URI and
per literal, shared where LUBM's terms are shared (a person's name
``FullProfessor3`` recurs in every department; every telephone reads
``xxx-xxx-xxxx``; degrees point into a pool of 1,000 universities).  It
draws with NumPy, not UBA's Java random stream, so its counts are LUBM's
ranges, not UBA's exact draws.

``make_input`` draws a configuration once, at its fixed ``data_seed``, and
shuffles the rows by the run's seed.  Each job then sees the rows under
ids of its own (``job_ids``): a strictly increasing map onto random ids
below ``ID_SPACE``, which keeps every order among ids, so every job does
the same work on an input no earlier job has seen.
"""

from __future__ import annotations

import numpy as np

# UBA's profile: (least, most) counts, both inclusive.
UBA = {
    "universities_pool": 1000,   # degrees are from one of these
    "departments": (15, 25),     # per university
    "faculty": {                 # per department: count, publications
        "FullProfessor": ((7, 10), (15, 20)),
        "AssociateProfessor": ((10, 14), (10, 18)),
        "AssistantProfessor": ((8, 11), (5, 10)),
        "Lecturer": ((5, 7), (0, 5)),
    },
    "courses_per_faculty": (1, 2),
    "graduate_courses_per_faculty": (1, 2),
    "research_groups": (10, 20),
    "undergraduates_per_faculty": (8, 14),
    "graduates_per_faculty": (3, 4),
    "teaching_assistant_one_in": (4, 5),   # of the graduate students
    "research_assistant_one_in": (3, 4),
    "undergraduate_advisor_one_in": 5,
    "undergraduate_courses": (2, 4),
    "graduate_courses": (1, 3),
    "graduate_publications": (0, 5),
    "research_topics": 30,
}

PROPERTIES = ("type", "name", "emailAddress", "telephone",
              "researchInterest", "worksFor", "headOf", "teacherOf",
              "undergraduateDegreeFrom", "mastersDegreeFrom",
              "doctoralDegreeFrom", "memberOf", "takesCourse", "advisor",
              "teachingAssistantOf", "publicationAuthor",
              "subOrganizationOf")
CLASSES = ("University", "Department", "FullProfessor", "AssociateProfessor",
           "AssistantProfessor", "Lecturer", "UndergraduateStudent",
           "GraduateStudent", "TeachingAssistant", "ResearchAssistant",
           "Course", "GraduateCourse", "ResearchGroup", "Publication")


class _Terms:
    """Term ids: fresh ones for URIs and unique literals, and one id per
    literal ``kind + str(i)`` that LUBM repeats (names, topics, the
    telephone), made when first asked for."""

    def __init__(self):
        self.next = 0
        self.literals: dict = {}

    def fresh(self, n: int = 1) -> np.ndarray:
        out = np.arange(self.next, self.next + n, dtype=np.int64)
        self.next += n
        return out

    def literal(self, kind: str, index) -> np.ndarray:
        """Ids of the literals ``kind + str(i)`` for each i in `index`."""
        idx = np.atleast_1d(np.asarray(index, np.int64))
        have = self.literals.get(kind, np.zeros(0, np.int64))
        if len(idx) and idx.max() >= len(have):
            have = np.concatenate([have,
                                   self.fresh(int(idx.max()) + 1 - len(have))])
            self.literals[kind] = have
        return have[idx]


def _between(rng, lo_hi, size=None):
    lo, hi = lo_hi
    return rng.integers(lo, hi + 1, size=size)


def _choose_each(rng, counts, pool: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """For owner i, min(counts[i], len(pool)) distinct members of `pool`.
    Returns (owner, member) pairs."""
    counts = np.minimum(np.asarray(counts, np.int64), len(pool))
    pick = np.argsort(rng.random((len(counts), len(pool))), axis=1)
    owner = np.repeat(np.arange(len(counts)), counts)
    rank = np.arange(len(owner)) - np.repeat(np.cumsum(counts) - counts,
                                             counts)
    return owner, pool[pick[owner, rank]]


def generate_lubm(universities: int, seed: int = 0,
                  departments: int | None = None) -> np.ndarray:
    """(N, 3) int32 triples of LUBM(`universities`) by UBA's profile.

    `departments` caps the departments of each university (tests' small
    draws); None keeps the profile's 15-25.
    """
    rng = np.random.default_rng(seed)
    terms = _Terms()
    prop = dict(zip(PROPERTIES, terms.fresh(len(PROPERTIES))))
    cls = dict(zip(CLASSES, terms.fresh(len(CLASSES))))
    pool = terms.fresh(UBA["universities_pool"])  # University0.. URIs
    phone = terms.literal("xxx-xxx-xxxx", [0])[0]
    cols: list[tuple] = []

    def add(p, s, o):
        s, o = np.atleast_1d(s), np.atleast_1d(o)
        n = max(len(s), len(o))
        cols.append((np.broadcast_to(s, n), np.full(n, prop[p]),
                     np.broadcast_to(o, n)))

    def person(kind, ids):
        add("type", ids, cls[kind])
        add("name", ids, terms.literal(kind, np.arange(len(ids))))
        add("emailAddress", ids, terms.fresh(len(ids)))
        add("telephone", ids, phone)

    for u in range(universities):
        univ = pool[u]
        add("type", univ, cls["University"])
        add("name", univ, terms.literal("University", [u]))
        n_dept = int(_between(rng, UBA["departments"]))
        if departments is not None:
            n_dept = min(n_dept, departments)
        for d in range(n_dept):
            dept = terms.fresh()[0]
            add("type", dept, cls["Department"])
            add("name", dept, terms.literal("Department", [d]))
            add("subOrganizationOf", dept, univ)

            faculty, professors, pubs = [], [], []
            for kind, (count, n_pubs) in UBA["faculty"].items():
                ids = terms.fresh(int(_between(rng, count)))
                person(kind, ids)
                add("worksFor", ids, dept)
                add("researchInterest", ids, terms.literal(
                    "Research", rng.integers(0, UBA["research_topics"],
                                             len(ids))))
                for deg in ("undergraduateDegreeFrom", "mastersDegreeFrom",
                            "doctoralDegreeFrom"):
                    add(deg, ids, pool[rng.integers(0, len(pool), len(ids))])
                k = _between(rng, n_pubs, len(ids))
                p = terms.fresh(int(k.sum()))
                add("type", p, cls["Publication"])
                add("name", p, terms.literal("Publication", np.concatenate(
                    [np.arange(c) for c in k.tolist()] or [[]])))
                add("publicationAuthor", p, np.repeat(ids, k))
                faculty.append(ids)
                pubs.append(p)
                if kind != "Lecturer":
                    professors.append(ids)
                if kind == "FullProfessor":
                    add("headOf", ids[0], dept)
            faculty = np.concatenate(faculty)
            professors = np.concatenate(professors)
            pubs = np.concatenate(pubs)

            courses = []
            for kind, per in (("Course", "courses_per_faculty"),
                              ("GraduateCourse",
                               "graduate_courses_per_faculty")):
                k = _between(rng, UBA[per], len(faculty))
                c = terms.fresh(int(k.sum()))  # pairwise disjoint
                add("type", c, cls[kind])
                add("name", c, terms.literal(kind, np.arange(len(c))))
                add("teacherOf", np.repeat(faculty, k), c)
                courses.append(c)

            groups = terms.fresh(int(_between(rng, UBA["research_groups"])))
            add("type", groups, cls["ResearchGroup"])
            add("subOrganizationOf", groups, dept)

            n_fac = len(faculty)
            under = terms.fresh(
                n_fac * int(_between(rng, UBA["undergraduates_per_faculty"])))
            person("UndergraduateStudent", under)
            add("memberOf", under, dept)
            o, c = _choose_each(rng, _between(
                rng, UBA["undergraduate_courses"], len(under)), courses[0])
            add("takesCourse", under[o], c)
            advised = under[rng.random(len(under))
                            < 1.0 / UBA["undergraduate_advisor_one_in"]]
            add("advisor", advised,
                professors[rng.integers(0, len(professors), len(advised))])

            grad = terms.fresh(
                n_fac * int(_between(rng, UBA["graduates_per_faculty"])))
            person("GraduateStudent", grad)
            add("memberOf", grad, dept)
            add("undergraduateDegreeFrom", grad,
                pool[rng.integers(0, len(pool), len(grad))])
            add("advisor", grad,
                professors[rng.integers(0, len(professors), len(grad))])
            o, c = _choose_each(rng, _between(
                rng, UBA["graduate_courses"], len(grad)), courses[1])
            add("takesCourse", grad[o], c)
            n_ta = min(len(grad) // int(_between(
                rng, UBA["teaching_assistant_one_in"])), len(courses[0]))
            ta = rng.choice(grad, n_ta, replace=False)
            add("type", ta, cls["TeachingAssistant"])
            add("teachingAssistantOf", ta,
                rng.choice(courses[0], n_ta, replace=False))
            ra = rng.choice(grad, len(grad) // int(_between(
                rng, UBA["research_assistant_one_in"])), replace=False)
            add("type", ra, cls["ResearchAssistant"])
            o, p = _choose_each(rng, _between(
                rng, UBA["graduate_publications"], len(grad)), pubs)
            add("publicationAuthor", p, grad[o])

    t = np.stack([np.concatenate([c[i] for c in cols]) for i in range(3)], 1)
    # Dense ids 0..k-1, in the order the terms were made.
    _, dense = np.unique(t, return_inverse=True)
    return dense.reshape(-1, 3).astype(np.int32)


GENERATORS = {"lubm": generate_lubm}

# Job ids stay below this: nine decimal digits, and int32.
ID_SPACE = 1 << 28


def make_input(config: dict, seed: int) -> np.ndarray:
    """A configuration's triples in a row order drawn from `seed`: the
    generator's draw at the configuration's fixed ``data_seed``, with dense
    ids ``0..k-1`` (``job_ids`` gives each job its own)."""
    args = dict(config["generator_args"])
    base = GENERATORS[config["generator"]](seed=int(config["data_seed"]),
                                           **args)
    rng = np.random.default_rng([int(seed) % 2 ** 64, 0])
    return np.ascontiguousarray(base[rng.permutation(len(base))])


def job_ids(n_ids: int, rng: np.random.Generator) -> np.ndarray:
    """A strictly increasing map of ``0..n_ids-1`` onto random int32 ids
    below ``ID_SPACE`` (random gaps), drawn from `rng`."""
    gap = max(1, ID_SPACE // max(n_ids, 1))
    return (np.cumsum(1 + (rng.random(n_ids) * gap).astype(np.int64))
            - 1).astype(np.int32)


def token(v: int) -> str:
    """The ``<v%09d>`` URI token of id `v`: zero-padded, so the tokens'
    lexicographic order is the ids' numeric order."""
    return f"<v{int(v):09d}>"


def write_nt(path, triples: np.ndarray) -> None:
    """Write integer id triples as an N-Triples file (one line per row)."""
    t = np.asarray(triples).reshape(-1, 3)
    with open(path, "w") as f:
        f.writelines(f"<v{s:09d}> <v{p:09d}> <v{o:09d}> .\n"
                     for s, p, o in t.tolist())
