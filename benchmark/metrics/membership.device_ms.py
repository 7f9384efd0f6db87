"""Device milliseconds per job of kernel K3 (``membership_counts_rows_kernel``
and ``membership_counts_lines_kernel``, ``csrc/membership.cu``).  None where
the program launches no such kernel."""

SYMBOL = "membership_counts_"


def read(ctx):
    s = ctx.trace.kernel_s(SYMBOL) if ctx.trace else None
    return 1e3 * s / ctx.n_jobs if s and ctx.n_jobs else None
