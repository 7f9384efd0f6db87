"""The CLI driver's ``write-output`` phase (``RunResult.timings``), mean
milliseconds per job of the traced window."""


def read(ctx):
    ms = [dict(j["phases"])["write-output"] * 1e3 for j in ctx.jobs
          if "write-output" in dict(j["phases"])]
    return sum(ms) / len(ms) if ms else None
