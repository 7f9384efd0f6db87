"""The highest device memory any window job allocated above what was
allocated before it (``torch.cuda.max_memory_allocated`` after a reset of
the peak before each job), in GB of 10**9 bytes."""


def read(ctx):
    peaks = [j["peak_bytes"] for j in ctx.jobs]
    return max(peaks) / 1e9 if peaks and max(peaks) > 0 else None
