"""Reading the traced run: one ``torch.profiler`` trace over the window.

From the trace: the window's length (the summed length of the
``bench.job`` ranges the harness opens around each job: the harness's own
work between jobs is no part of it), the device's busy time (the union of
its kernel and copy intervals) inside those ranges, the host time of every
``rdfind.*`` range the program opens, the device time by kernel name, and
where the device sat idle inside a job: each idle gap labelled by the
innermost ``rdfind.*`` range open at its midpoint, else by the job phase the
entry reports (``driver.<phase>`` for the CLI, laid end to end from the
job's start), else ``bench.job``.

The raw kineto events are read directly (``kineto_results.events()``), not
through the profiler's function-event tree, which takes minutes on a trace
of hundreds of thousands of events.
"""

from __future__ import annotations

import bisect
import dataclasses

JOB_RANGE = "bench.job"
PROGRAM_PREFIX = "rdfind."


def union_intervals(spans):
    """Sorted disjoint [start, end] intervals covering `spans`."""
    out = []
    for lo, hi in sorted(spans):
        if out and lo <= out[-1][1]:
            if hi > out[-1][1]:
                out[-1][1] = hi
        else:
            out.append([lo, hi])
    return out


@dataclasses.dataclass
class Trace:
    """What the reader takes from one trace; times in seconds."""

    window_s: float = 0.0
    busy_s: float = 0.0
    ranges_s: dict = dataclasses.field(default_factory=dict)
    kernels_s: dict = dataclasses.field(default_factory=dict)
    idle_by_label_s: dict = dataclasses.field(default_factory=dict)
    n_device_events: int = 0

    def range_s(self, *names) -> float | None:
        """Summed host seconds of the named ranges; None if none ran."""
        hit = [self.ranges_s[n] for n in names if n in self.ranges_s]
        return sum(hit) if hit else None

    def kernel_s(self, symbol: str) -> float | None:
        """Device seconds of the kernels whose name holds `symbol`."""
        hit = [s for k, s in self.kernels_s.items() if symbol in k]
        return sum(hit) if hit else None

    def breakdown(self, top: int = 10) -> dict:
        ops = sorted(self.kernels_s.items(), key=lambda kv: -kv[1])[:top]
        gaps = sorted(self.idle_by_label_s.items(),
                      key=lambda kv: -kv[1])[:top]
        return {"device_ops": [[k[:120], v] for k, v in ops],
                "idle_gaps": [[k, v] for k, v in gaps]}


def _label_gaps(gaps, host, jobs, job_phases) -> dict:
    """Idle seconds by label: each gap at its midpoint, by a sweep over the
    (nested) program ranges in start order."""
    out = {}
    job_starts = [j[0] for j in jobs]
    stack, nxt = [], 0
    for lo, hi in gaps:
        mid = (lo + hi) // 2
        while nxt < len(host) and host[nxt][0] <= mid:
            while stack and stack[-1][1] < host[nxt][0]:
                stack.pop()
            stack.append(host[nxt])
            nxt += 1
        while stack and stack[-1][1] < mid:
            stack.pop()
        label = stack[-1][2] if stack else JOB_RANGE
        ji = bisect.bisect_right(job_starts, mid) - 1
        if not stack and job_phases and 0 <= ji < len(job_phases):
            t = jobs[ji][0]
            for phase, secs in job_phases[ji]:
                t += secs * 1e9
                if mid <= t:
                    label = f"driver.{phase}"
                    break
        out[label] = out.get(label, 0.0) + (hi - lo) / 1e9
    return out


def busy_and_gaps(device, jobs):
    """(busy, idle) intervals of the device inside the disjoint, sorted
    `jobs` intervals."""
    dev = union_intervals(device)
    busy, gaps = [], []
    i = 0
    for j0, j1 in jobs:
        while i < len(dev) and dev[i][1] <= j0:
            i += 1
        t, k = j0, i
        while k < len(dev) and dev[k][0] < j1:
            lo, hi = max(dev[k][0], j0), min(dev[k][1], j1)
            if lo > t:
                gaps.append((t, lo))
            busy.append((lo, hi))
            t = max(t, hi)
            k += 1
        if j1 > t:
            gaps.append((t, j1))
    return busy, gaps


def read(prof, job_phases=None) -> Trace:
    """The Trace of a stopped ``torch.profiler.profile``.

    job_phases: per window job, the ordered (phase, seconds) pairs the entry
    measured (``RunResult.timings`` for the CLI).
    """
    from torch.autograd import DeviceType

    events = prof.profiler.kineto_results.events()
    jobs, host, device = [], [], []
    kernels = {}
    for e in events:
        name = e.name()
        start, end = e.start_ns(), e.end_ns()
        if e.device_type() == DeviceType.CUDA:
            if name.startswith(PROGRAM_PREFIX) or name.startswith("bench."):
                continue  # the device-side mirror of a host range
            device.append((start, end))
            kernels[name] = kernels.get(name, 0) + (end - start)
        elif name == JOB_RANGE:
            jobs.append((start, end))
        elif name.startswith(PROGRAM_PREFIX):
            host.append((start, end, name))
    tr = Trace(n_device_events=len(device))
    if not jobs:
        return tr
    jobs = [tuple(j) for j in union_intervals(jobs)]
    host.sort()
    tr.window_s = sum(hi - lo for lo, hi in jobs) / 1e9
    busy, gaps = busy_and_gaps(device, jobs)
    tr.busy_s = sum(hi - lo for lo, hi in busy) / 1e9
    for lo, hi, name in host:
        tr.ranges_s[name] = tr.ranges_s.get(name, 0.0) + (hi - lo) / 1e9
    tr.kernels_s = {k: v / 1e9 for k, v in kernels.items()}
    tr.idle_by_label_s = _label_gaps(gaps, host, jobs, job_phases)
    return tr
