"""Host milliseconds per job of the ``rdfind.sweep`` range: the block
counts and the launch schedule, the K1 launches, and the pulls and decode of
the verdict bits (``ops/cooc.discover_pairs_dense``)."""


def read(ctx):
    s = ctx.trace.range_s("rdfind.sweep") if ctx.trace else None
    return 1e3 * s / ctx.n_jobs if s is not None and ctx.n_jobs else None
