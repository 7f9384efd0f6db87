"""What every port test module runs under, as two autouse fixtures.

A module takes them with one import::

    from torch_harness import port_module, time_limit  # noqa: F401

``port_module`` gives the module one intra-op thread (torch in this process,
OpenMP in the processes it starts) and drops the XLA programs compiled in and
before it.  The port's CPU runs are thousands of small tensor operations that
a thread pool per test worker oversubscribes, and every XLA program keeps
executable mappings, of which a process may hold only so many
(vm.max_map_count).

``time_limit`` bounds each test's wall clock: ``DEFAULT_TIME_LIMIT_S``, or
``@pytest.mark.time_limit(seconds)`` on the test or its module.  At the limit a
``TimeLimitExceeded`` is raised in the test, so its own clean-up (a
``finally``, ``subprocess.run``, ``launch.spawn``) stops the processes it
started and the test fails.  Where no signal reaches Python (a wait inside C
code), ``BACKSTOP_S`` later the process dumps every thread's stack to stderr
and exits; under xdist that fails the one test and a new worker goes on.  A
module-scoped fixture runs under its module's limit, so a mark that must cover
one goes on the module (``pytestmark``).

This module imports neither JAX nor the JAX package, so a module that takes it
still imports where they are absent.
"""

import faulthandler
import os
import signal
import sys

import pytest
import torch

DEFAULT_TIME_LIMIT_S = 120.0
BACKSTOP_S = 10.0

_stderr_fd = None


class TimeLimitExceeded(Exception):
    pass


def _release_jax_programs():
    jax = sys.modules.get("jax")
    if jax is not None:
        jax.clear_caches()


def _limit(node) -> float:
    mark = node.get_closest_marker("time_limit")
    return float(mark.args[0]) if mark else DEFAULT_TIME_LIMIT_S


def _real_stderr(config) -> int:
    """A copy of this process's stderr taken past pytest's capture, so that a
    dump reaches the terminal (or the xdist controller) before the exit."""
    global _stderr_fd
    if _stderr_fd is None:
        capman = config.pluginmanager.getplugin("capturemanager")
        with capman.global_and_fixture_disabled():
            _stderr_fd = os.dup(sys.stderr.fileno())
    return _stderr_fd


def _arm(request):
    limit = _limit(request.node)

    def expire(signum, frame):
        raise TimeLimitExceeded(f"{request.node.nodeid} ran past its time "
                                f"limit of {limit:g} s")

    signal.signal(signal.SIGALRM, expire)
    signal.setitimer(signal.ITIMER_REAL, limit)
    faulthandler.dump_traceback_later(limit + BACKSTOP_S, exit=True,
                                      file=_real_stderr(request.config))


def _disarm():
    faulthandler.cancel_dump_traceback_later()
    signal.setitimer(signal.ITIMER_REAL, 0)
    signal.signal(signal.SIGALRM, signal.SIG_DFL)


@pytest.fixture(autouse=True, scope="module")
def port_module(request):
    threads, omp = torch.get_num_threads(), os.environ.get("OMP_NUM_THREADS")
    torch.set_num_threads(1)
    os.environ["OMP_NUM_THREADS"] = "1"
    _release_jax_programs()
    _arm(request)
    yield
    _disarm()
    _release_jax_programs()
    torch.set_num_threads(threads)
    if omp is None:
        os.environ.pop("OMP_NUM_THREADS", None)
    else:
        os.environ["OMP_NUM_THREADS"] = omp


@pytest.fixture(autouse=True)
def time_limit(request):
    _arm(request)
    yield
    _disarm()
