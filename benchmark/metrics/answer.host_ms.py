"""Host milliseconds per job of the ``rdfind.answer`` range: the host pulls
of the line lengths and the capture columns, the run's stats and the
``CindTable`` build (``models/allatonce.py``).  None where the program opens
no such range."""


def read(ctx):
    s = ctx.trace.range_s("rdfind.answer") if ctx.trace else None
    return 1e3 * s / ctx.n_jobs if s is not None and ctx.n_jobs else None
