"""Host milliseconds per job of the ``rdfind.prepare`` range: emission,
frequent-condition filter, capture interning and join lines
(``models/allatonce.py``, ``ops/frequency.py``, ``ops/emission.py``)."""


def read(ctx):
    s = ctx.trace.range_s("rdfind.prepare") if ctx.trace else None
    return 1e3 * s / ctx.n_jobs if s is not None and ctx.n_jobs else None
