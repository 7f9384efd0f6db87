"""Host milliseconds per job of strategy 1's lattice walk: the
``rdfind.level11/12/21/22`` ranges of ``models/small_to_large.py``."""


def read(ctx):
    s = ctx.trace.range_s("rdfind.level11", "rdfind.level12",
                          "rdfind.level21", "rdfind.level22") \
        if ctx.trace else None
    return 1e3 * s / ctx.n_jobs if s is not None and ctx.n_jobs else None
