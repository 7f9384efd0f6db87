"""95th percentile of the wall time of every job in the window (seconds)."""

import numpy as np


def read(ctx):
    secs = [j["seconds"] for j in ctx.jobs]
    return float(np.percentile(secs, 95)) if secs else None
