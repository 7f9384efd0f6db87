"""Device milliseconds per job of kernel K1 (``fused_cind_kernel``,
``csrc/fused_cind.cu``)."""

SYMBOL = "fused_cind_kernel"


def read(ctx):
    s = ctx.trace.kernel_s(SYMBOL) if ctx.trace else None
    return 1e3 * s / ctx.n_jobs if s and ctx.n_jobs else None
