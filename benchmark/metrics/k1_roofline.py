"""Kernel K1's share of its roofline (percent): the least time the card
needs for the work the input asks of K1 (``roofline.k1_work``, counted from
the cell's triples, never from K1's launch arguments), over K1's measured
device time per job.  Every job's input has the same structure (each job's
ids keep every order), so one count serves them all."""

from benchmark import roofline

SYMBOL = "fused_cind_kernel"


def read(ctx):
    s = ctx.trace.kernel_s(SYMBOL) if ctx.trace else None
    peaks = roofline.peaks_for(ctx.device_name)
    if not s or not ctx.n_jobs or peaks is None:
        return None
    ops, nbytes = roofline.k1_work(ctx.triples, int(ctx.config["min_support"]),
                                   ctx.config.get("projections", "spo"))
    return 100.0 * roofline.least_seconds(ops, nbytes, peaks) \
        / (s / ctx.n_jobs)
