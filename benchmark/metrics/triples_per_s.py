"""Input triples of every completed job over the window: the summed wall
time of all its jobs, failed ones included (the harness's work between jobs,
which puts each job's input under its own ids, is no part of it)."""


def read(ctx):
    done = sum(j["triples"] for j in ctx.jobs if j["ok"])
    span = sum(j["seconds"] for j in ctx.jobs)
    return done / span if done and span > 0 else None
