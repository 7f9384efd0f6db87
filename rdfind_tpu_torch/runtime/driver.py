"""The RDFind job driver of the port: read -> parse -> intern -> discover -> sink.

Thin: the Python ingest (no native parser, prefixes or asciify yet), single-device
strategy 0, and the output file in the JAX package's format (sorted
``Cind.pretty()`` lines).
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np

from ..data import CindTable
from ..dictionary import Dictionary, intern_triples
from ..io import ntriples, reader
from ..models import allatonce

# Strategy ids follow the reference: 0 = all-at-once.  The others are not ported.
STRATEGIES = {0: allatonce.discover}


@dataclasses.dataclass
class Config:
    """The slice's subset of the JAX package's driver Config."""

    input_paths: list[str] = dataclasses.field(default_factory=list)
    min_support: int = 10
    traversal_strategy: int = 0
    projections: str = "spo"
    use_frequent_item_set: bool = False
    use_association_rules: bool = False
    clean_implied: bool = False
    output_file: str | None = None
    collect_result: bool = False
    device: str | None = None  # None: the CUDA card


@dataclasses.dataclass
class RunResult:
    table: CindTable
    dictionary: Dictionary
    triples: np.ndarray
    timings: dict  # phase -> seconds


def load_triples(cfg: Config) -> list:
    """Files -> list of (s, p, o) string tokens (N-Quads when the first input is
    ``.nq``/``.nq.gz``: the graph term is dropped)."""
    paths = reader.resolve_path_patterns(cfg.input_paths)
    is_nq = paths[0].endswith((".nq", ".nq.gz"))
    out = []
    for _, line in reader.iter_lines(paths):
        t = ntriples.parse_line(line, expect_quad=is_nq)
        if t is not None:
            out.append(t)
    return out


def write_output(path: str, table: CindTable, dictionary: Dictionary) -> None:
    """One ``Cind.pretty()`` line per CIND, sorted."""
    lines = sorted(c.pretty() for c in table.decoded(dictionary))
    with open(path, "w") as f:
        for line in lines:
            f.write(line + "\n")


def run(cfg: Config) -> RunResult:
    strategy = STRATEGIES.get(cfg.traversal_strategy)
    if strategy is None:
        raise ValueError(f"traversal strategy {cfg.traversal_strategy} is not "
                         f"yet ported (ported: {sorted(STRATEGIES)})")
    timings = {}

    def phase(name, fn):
        t0 = time.perf_counter()
        out = fn()
        timings[name] = time.perf_counter() - t0
        return out

    raw = phase("read+parse", lambda: load_triples(cfg))
    ids, dictionary = phase(
        "intern", lambda: intern_triples(np.asarray(raw, dtype=object)))
    use_ars = cfg.use_association_rules and cfg.use_frequent_item_set
    table = phase("discover", lambda: strategy(
        ids, cfg.min_support, projections=cfg.projections,
        use_frequent_condition_filter=cfg.use_frequent_item_set,
        use_association_rules=use_ars, clean_implied=cfg.clean_implied,
        device=cfg.device))
    if cfg.output_file:
        phase("write-output",
              lambda: write_output(cfg.output_file, table, dictionary))
    if cfg.collect_result:
        for c in table.decoded(dictionary):
            print(c.pretty())
    return RunResult(table, dictionary, ids, timings)
