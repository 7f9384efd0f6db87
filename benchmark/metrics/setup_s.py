"""Seconds from the harness's start to the window's: imports, the program's
library loads from the ``build/`` cache, input generation, the entry's
set-up and the warm-up job."""


def read(ctx):
    return ctx.setup_s
