"""The port tests' own limits (tests/torch_harness.py): a test that runs past
its time limit fails and the run goes on, and no wait written in a port test
module is as long as that module's limit.

The planted run shows both ways a limit ends a test: a test asleep in Python
gets ``TimeLimitExceeded`` at its limit, and a test that no signal reaches is
ended ``BACKSTOP_S`` later, its stacks dumped, by the exit of its worker.  The
test after them still passes.
"""

import os
import re
import subprocess
import sys
import xml.etree.ElementTree as ET
from pathlib import Path

from torch_harness import BACKSTOP_S, DEFAULT_TIME_LIMIT_S
from torch_harness import port_module, time_limit  # noqa: F401

TESTS = Path(__file__).resolve().parent
REPO = TESTS.parent

PLANTED = '''
import signal
import time

import pytest

from torch_harness import port_module, time_limit  # noqa: F401


@pytest.mark.time_limit(2)
def test_sleeps_past_its_limit():
    time.sleep(300)


@pytest.mark.time_limit(1)
def test_hangs_where_no_signal_reaches():
    signal.pthread_sigmask(signal.SIG_BLOCK, {signal.SIGALRM})
    time.sleep(300)


def test_runs_after_the_limits():
    assert True
'''


def test_a_test_past_its_limit_fails_and_the_run_goes_on(tmp_path):
    planted = tmp_path / "test_planted_limit.py"
    planted.write_text(PLANTED)
    junit = tmp_path / "junit.xml"
    env = {k: v for k, v in os.environ.items() if not k.startswith("PYTEST")}
    env["PYTHONPATH"] = str(TESTS)
    proc = subprocess.run(
        [sys.executable, "-m", "pytest", "-c", str(REPO / "pytest.ini"),
         "--rootdir", str(tmp_path), "-p", "no:cacheprovider",
         "-p", "no:randomly", "-p", "xdist", "-n", "1",
         "--junitxml", str(junit), "-q", str(planted)],
        cwd=tmp_path, env=env, capture_output=True, text=True, timeout=90)
    out = proc.stdout + proc.stderr
    assert proc.returncode == 1, out[-3000:]
    assert re.search(r"\b2 failed, 1 passed\b", out), out[-3000:]
    assert "TimeLimitExceeded" in out
    assert "ran past its time limit of 2 s" in out
    backstop = f"Timeout (0:00:{1 + BACKSTOP_S:02.0f})!"
    assert backstop in out, out[-3000:]
    assert re.search(r'test_planted_limit\.py", line \d+ in '
                     r'test_hangs_where_no_signal_reaches', out), out[-3000:]
    assert "crashed while running" in out, out[-3000:]
    times = {case.get("name"): float(case.get("time"))
             for case in ET.parse(junit).iter("testcase")}
    assert 2 <= times["test_sleeps_past_its_limit"] < 30, times


_WAIT = re.compile(r"""(?:\btimeout(?:_s)?\s*=\s*|TIMEOUT\w*["']\s*:\s*["']?)
                       (\d+(?:\.\d+)?)""", re.X)
_MODULE_LIMIT = re.compile(r"^pytestmark = pytest\.mark\.time_limit\((\d+)\)",
                           re.M)


def test_no_wait_in_a_port_test_module_reaches_its_limit():
    """Each subprocess, launch or peer wait (`timeout=`, `timeout_s=`, a
    `*TIMEOUT*` variable handed to a child) stays below the module's limit,
    so the wait, not the limit, ends a stuck peer and names it.  The card's
    module (test_torch_cuda.py) runs outside the harness."""
    bad = []
    for path in sorted(TESTS.glob("*torch_*.py")):
        if path.name == "test_torch_cuda.py":
            continue
        text = path.read_text()
        mark = _MODULE_LIMIT.search(text)
        limit = float(mark.group(1)) if mark else DEFAULT_TIME_LIMIT_S
        for m in _WAIT.finditer(text):
            if float(m.group(1)) >= limit:
                line = text.count("\n", 0, m.start()) + 1
                bad.append(f"{path.name}:{line} {m.group(0)} "
                           f"(limit {limit:g} s)")
    assert not bad, "\n".join(bad)
