"""The launcher: one process per rank, a rendezvous, and the preemption supervisor.

``spawn(fn, world, ...)`` starts `world` local ranks with the ``spawn`` start
method (no rank inherits a CUDA context), joins them in one process group and
calls ``fn(mesh, *args)`` on every rank; the parent returns local rank 0's
result.  Rendezvous is a ``FileStore`` in a fresh temporary directory (parallel
test workers never race for a port), or a TCP store at ``--coordinator
host:port`` when several hosts join: global rank = host_index * local + r.

Failure never hangs the parent: when a rank exits non-zero the parent gives its
peers a short grace to report, terminates the rest and raises the failing
rank's exception text with the rank named (``RankFailed``).  A rank that raises
``faults.Preempted`` flushes its progress snapshots and exits 75; so does the
collective watchdog's hard exit, which leaves no report.  When the rank that
failed first was preempted, the parent raises ``Preempted``.  The rendezvous has a timeout, and a collective that never
returns is bounded by the collective watchdog in the ranks.  A failed
rendezvous is retried (``join_group``: RDFIND_INIT_RETRIES attempts, each on
a fresh prefix of the store).

``supervise`` is the preemption supervisor of the JAX package's driver
(``_run_supervised``), moved to the parent: it catches ``Preempted`` /
``FallbackRequired``, backs off on the fault ladder's jittered schedule,
re-probes the capacity (``torch.cuda.device_count()`` for NCCL ranks; gloo
keeps the world size) and relaunches, and the new ranks resume from the
progress snapshots, re-sharded when the world size changed.
"""

from __future__ import annotations

import dataclasses
import datetime
import os
import pickle
import shutil
import sys
import tempfile
import time
import traceback

PREEMPT_EXIT = 75
_GRACE_S = 3.0
_POLL_S = 0.02


class RankFailed(RuntimeError):
    """A rank of a launch failed; `rank` names it, the message carries its
    exception and traceback."""

    def __init__(self, rank: int, exit_code, detail: str):
        super().__init__(f"rank {rank} failed (exit {exit_code}): {detail}")
        self.rank = rank
        self.exit_code = exit_code


@dataclasses.dataclass
class LaunchSpec:
    fn: object
    args_path: str  # the pickled args, read by each rank after it starts
    world_local: int
    device_type: str
    workdir: str
    coordinator: str | None = None
    num_hosts: int = 1
    host_index: int = 0
    init_timeout_s: float = 120.0
    fault_state: object = None  # the fault plan's counters (faults)


def _init_timeout_s() -> float:
    try:
        return float(os.environ.get("RDFIND_INIT_TIMEOUT_S", "") or 120.0)
    except ValueError:
        return 120.0


def local_capacity(device_type: str, world_local: int) -> int:
    """How many local ranks this host can run for `device_type` under the
    resolved transport; NCCL needs one GPU per local rank and raises,
    naming both counts, when there are fewer."""
    from .mesh import resolve_backend
    backend, _ = resolve_backend(device_type)
    if backend == "nccl":
        import torch
        n_gpu = torch.cuda.device_count()
        if world_local > n_gpu:
            raise RuntimeError(
                f"NCCL needs one GPU per local rank: {world_local} local "
                f"ranks asked for, {n_gpu} GPU(s) visible (set "
                f"RDFIND_TORCH_DIST_BACKEND=gloo to run several ranks on one "
                f"card, staged through host memory)")
    return world_local


def _make_store(spec: LaunchSpec, rank: int, world: int):
    import torch.distributed as dist
    timeout = datetime.timedelta(seconds=spec.init_timeout_s)
    if spec.coordinator:
        host, port = spec.coordinator.rsplit(":", 1)
        return dist.TCPStore(host, int(port), world, is_master=(rank == 0),
                             timeout=timeout)
    return dist.FileStore(os.path.join(spec.workdir, "store"), world)


def init_retries() -> int:
    """RDFIND_INIT_RETRIES: rendezvous attempts a rank makes (default 3)."""
    try:
        return max(1, int(os.environ.get("RDFIND_INIT_RETRIES", "3") or 3))
    except ValueError:
        return 3


def join_group(store, rank: int, world: int, *, backend: str, timeout,
               **kwargs) -> int:
    """``init_process_group`` with bounded retry: RDFIND_INIT_RETRIES
    attempts, the fault ladder's jittered backoff between them.  Returns the
    retries used (0: the first attempt joined), published as the
    ``distributed_init_retries`` gauge.  ``faults.Preempted`` and
    ``FallbackRequired`` pass straight through.

    Attempt k runs on its own ``PrefixStore`` ("init<k>"), so it never reads
    the keys an earlier attempt left in the store.  The ranks agree on k
    because an attempt ends, on every rank, with a store barrier that waits
    up to `timeout` for every rank's "joined" key: a rank moves on to k + 1
    only when its own join or that barrier raised, and when one rank fails
    to join, every other rank's barrier times out in the same attempt.
    """
    import torch.distributed as dist

    from ..obs import metrics
    from ..runtime import faults

    tries = init_retries()
    last: Exception | None = None
    for attempt in range(tries):
        attempt_store = dist.PrefixStore(f"init{attempt}", store)
        joined = False
        try:
            dist.init_process_group(backend=backend, store=attempt_store,
                                    rank=rank, world_size=world,
                                    timeout=timeout, **kwargs)
            joined = True
            attempt_store.set(f"joined{rank}", b"1")
            attempt_store.wait([f"joined{r}" for r in range(world)], timeout)
            metrics.gauge_set(None, "distributed_init_retries", attempt)
            return attempt
        except (faults.Preempted, faults.FallbackRequired):
            raise
        except Exception as e:  # noqa: BLE001 - any failed join is retried
            last = e
            if joined:
                try:
                    dist.destroy_process_group()
                except Exception:
                    pass
            if attempt == tries - 1:
                break
            delay_ms = faults._backoff_ms(attempt)
            print(f"rdfind: distributed init attempt {attempt + 1}/{tries} "
                  f"failed ({e}); retrying after {delay_ms:.0f} ms",
                  file=sys.stderr, flush=True)
            time.sleep(delay_ms / 1e3)
    metrics.gauge_set(None, "distributed_init_retries", tries - 1)
    raise RuntimeError(
        f"distributed init failed after {tries} attempts") from last


def _rank_main(spec: LaunchSpec, local_rank: int) -> None:
    """Entry point of one spawned rank."""
    import torch
    import torch.distributed as dist

    from ..runtime import faults
    from . import mesh as mesh_mod

    rank = spec.host_index * spec.world_local + local_rank
    faults.set_rank(rank)
    faults.import_state(spec.fault_state)
    world = spec.num_hosts * spec.world_local
    err_path = os.path.join(spec.workdir, f"rank{local_rank}.err")
    code = 0
    initialized = False
    try:
        if rank != 0:
            # One voice: rank 0 prints reports and notes; the others report
            # only through their error file.
            devnull = open(os.devnull, "w")
            sys.stdout = devnull
            sys.stderr = devnull
        backend, staged = mesh_mod.resolve_backend(spec.device_type)
        if spec.device_type == "cuda":
            n_gpu = torch.cuda.device_count()
            if backend == "nccl" and local_rank >= n_gpu:
                raise RuntimeError(
                    f"NCCL needs one GPU per local rank: local rank "
                    f"{local_rank} of {spec.world_local}, {n_gpu} GPU(s)")
            device = torch.device("cuda", local_rank % max(n_gpu, 1))
            torch.cuda.set_device(device)
        else:
            device = torch.device("cpu")
            torch.set_num_threads(1)
        if backend == "gloo" and not spec.coordinator:
            os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
        store = _make_store(spec, rank, world)
        kwargs = dict(backend=backend,
                      timeout=datetime.timedelta(seconds=spec.init_timeout_s))
        if backend == "nccl":
            kwargs["device_id"] = device
        join_group(store, rank, world, **kwargs)
        initialized = True
        mesh = mesh_mod.Mesh(rank=rank, size=world, device=device,
                             backend=backend, staged=staged,
                             num_hosts=spec.num_hosts,
                             host_index=spec.host_index,
                             local_rank=local_rank)
        mesh_mod.set_current(mesh)
        with open(spec.args_path, "rb") as f:
            args = pickle.load(f)
        out = spec.fn(mesh, *args)
        if local_rank == 0:
            tmp = os.path.join(spec.workdir, "result.tmp")
            with open(tmp, "wb") as f:
                pickle.dump(out, f)
            os.replace(tmp, os.path.join(spec.workdir, "result.pkl"))
    except BaseException as e:  # noqa: BLE001 - every failure is reported
        from ..runtime import checkpoint, faults
        preempted = isinstance(e, faults.Preempted)
        if preempted:
            checkpoint.flush_all_progress()
        code = PREEMPT_EXIT if preempted else 1
        try:
            payload = pickle.dumps(e)
        except Exception:
            payload = None
        with open(err_path + ".tmp", "wb") as f:
            pickle.dump({"type": type(e).__name__, "text": str(e),
                         "time": time.time(),
                         "traceback": traceback.format_exc(),
                         "exc": payload,
                         "fault_state": faults.export_state()}, f)
        os.replace(err_path + ".tmp", err_path)
    finally:
        if initialized:
            try:
                dist.destroy_process_group()
            except Exception:
                pass
        sys.stdout.flush()
        sys.stderr.flush()
    os._exit(code)


def _read_err(workdir: str, local_rank: int):
    path = os.path.join(workdir, f"rank{local_rank}.err")
    try:
        with open(path, "rb") as f:
            return pickle.load(f)
    except (OSError, EOFError, pickle.UnpicklingError):
        return None


def _terminate(procs) -> None:
    for p in procs:
        if p.is_alive():
            p.terminate()
    deadline = time.monotonic() + 5.0
    for p in procs:
        p.join(max(0.0, deadline - time.monotonic()))
        if p.is_alive():
            p.kill()
            p.join(1.0)


def _preempted(err, exit_code) -> bool:
    """A rank was preempted when it reported Preempted, or when it exited 75
    with no report: the collective watchdog's hard exit after a wedge that
    Python could not interrupt."""
    if err is None:
        return exit_code == PREEMPT_EXIT
    return err["type"] == "Preempted"


def _raise_failure(procs, workdir: str, exited: dict, fault_state) -> None:
    """Raise the failure of the rank that failed first: its peers' errors are
    usually the broken collective it left behind.  A rank's failure time is
    when it wrote its report, which it does before it leaves the process
    group; a rank that exited with no report (a crash, or the watchdog's hard
    exit) failed after the poll before the one that saw it exit (`exited`),
    and one the parent terminated failed last.  That rank preempted:
    Preempted, carrying the fault plan's counters of its report (else
    `fault_state`, this attempt's starting counters).  Otherwise its
    exception, as RankFailed."""
    from ..runtime import faults
    errs = {i: _read_err(workdir, i) for i in range(len(procs))}
    codes = [p.exitcode for p in procs]
    failed = [i for i in range(len(procs))
              if errs[i] is not None or codes[i] not in (0, None)] or [0]

    def failed_at(i):
        if errs[i] is not None:
            return errs[i]["time"]
        return exited.get(i, float("inf"))

    i = min(failed, key=lambda i: (failed_at(i), i))
    e = errs[i]
    if _preempted(e, codes[i]):
        if e is not None:
            exc = faults.Preempted(e["text"])
            exc.fault_state = e.get("fault_state")
        else:
            exc = faults.Preempted(
                f"rank {i} exited {PREEMPT_EXIT} with no report (the "
                f"collective watchdog's hard exit)")
            exc.fault_state = fault_state
        raise exc
    raise RankFailed(i, codes[i],
                     f"{e['type']}: {e['text']}\n{e['traceback']}" if e
                     else "exited with no report")


def spawn(fn, world_local: int, *, args=(), device=None,
          coordinator: str | None = None, num_hosts: int = 1,
          host_index: int = 0, timeout_s: float | None = None,
          fault_state=None):
    """Run ``fn(mesh, *args)`` on `world_local` spawned ranks of this host
    and return local rank 0's result.  `fn` must be importable by name (a
    module-level function).  `device`: CUDA ranks unless the caller asks
    for "cpu" (with no device and no card it raises)."""
    import multiprocessing as mp

    from .. import devices
    device_type = devices.resolve(device).type
    local_capacity(device_type, world_local)
    workdir = tempfile.mkdtemp(prefix="rdfind-launch-")
    # The arguments go through a file, not the spawn pipe: a start() blocks
    # until its child has imported its main module and read the pipe, which
    # would start large-argument ranks one after another.
    args_path = os.path.join(workdir, "args.pkl")
    with open(args_path, "wb") as f:
        pickle.dump(tuple(args), f, protocol=pickle.HIGHEST_PROTOCOL)
    spec = LaunchSpec(fn=fn, args_path=args_path,
                      world_local=int(world_local),
                      device_type=device_type, workdir=workdir,
                      coordinator=coordinator, num_hosts=int(num_hosts),
                      host_index=int(host_index),
                      init_timeout_s=_init_timeout_s(),
                      fault_state=fault_state)
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_rank_main, args=(spec, r),
                         name=f"rdfind-rank{r}", daemon=False)
             for r in range(world_local)]
    deadline = None if timeout_s is None else time.monotonic() + timeout_s
    try:
        for p in procs:
            p.start()
        # exited[i]: the time of the poll before the one that saw rank i
        # exit (it exited after it).
        failed_at, exited, t_prev = None, {}, time.time()
        while True:
            t_poll = time.time()
            codes = [p.exitcode for p in procs]
            for i, c in enumerate(codes):
                if c is not None and i not in exited:
                    exited[i] = t_prev
            t_prev = t_poll
            if all(c == 0 for c in codes):
                break
            if any(c not in (0, None) for c in codes):
                if failed_at is None:
                    failed_at = time.monotonic()
                if (all(c is not None for c in codes)
                        or time.monotonic() - failed_at > _GRACE_S):
                    _terminate(procs)
                    _raise_failure(procs, workdir, exited, fault_state)
            if deadline is not None and time.monotonic() > deadline:
                _terminate(procs)
                raise TimeoutError(
                    f"launch of {world_local} ranks exceeded {timeout_s} s")
            time.sleep(_POLL_S)
        with open(os.path.join(workdir, "result.pkl"), "rb") as f:
            return pickle.load(f)
    finally:
        _terminate(procs)
        shutil.rmtree(workdir, ignore_errors=True)


def retry_budget(flag: int = 0) -> int:
    """--retry-on-preempt, with RDFIND_RETRY_ON_PREEMPT as the env fallback
    (the flag wins when both are given)."""
    if flag > 0:
        return flag
    try:
        return max(0, int(os.environ.get("RDFIND_RETRY_ON_PREEMPT", "0")
                          or 0))
    except ValueError:
        return 0


def supervise(fn, world_local: int, *, args_for, budget: int,
              device=None, coordinator: str | None = None,
              num_hosts: int = 1, host_index: int = 0, marker_dirs=()):
    """The preemption supervisor: launch, and on ``Preempted`` (or an escaped
    ``FallbackRequired``) back off and relaunch up to `budget` times.

    ``args_for(attempt, world_local)`` builds the ranks' arguments for each
    attempt (the attempt number rides along so rank 0 reports it).  Before a
    relaunch the watchdog's wedge markers in `marker_dirs` are cleared, so a
    marker of the wedge just recovered from cannot abort the new attempt.
    A zero budget lets Preempted propagate (the CLI's exit-75 path)."""
    from ..runtime import faults, watchdog

    attempt = 0
    fault_state = None
    while True:
        try:
            return spawn(fn, world_local, args=args_for(attempt, world_local),
                         device=device, coordinator=coordinator,
                         num_hosts=num_hosts, host_index=host_index,
                         fault_state=fault_state)
        except (faults.Preempted, faults.FallbackRequired) as e:
            fault_state = getattr(e, "fault_state", fault_state)
            attempt += 1
            if attempt > budget:
                raise
            for d in marker_dirs:
                watchdog.clear_markers(d)
            delay_ms = faults._backoff_ms(attempt - 1)
            print(f"rdfind: preempted ({e}); supervisor retry "
                  f"{attempt}/{budget} after {delay_ms} ms",
                  file=sys.stderr, flush=True)
            time.sleep(delay_ms / 1e3)
            avail = _probe_capacity(device, world_local)
            if 0 < avail < world_local:
                print(f"rdfind: device set shrank to {avail}; resuming "
                      f"re-sharded", file=sys.stderr, flush=True)
                world_local = avail


def _probe_capacity(device, world_local: int) -> int:
    """Ranks the host can run now: the visible GPU count for NCCL, the same
    world size for gloo."""
    from .. import devices
    from .mesh import resolve_backend
    backend, _ = resolve_backend(devices.resolve(device).type)
    if backend == "nccl":
        import torch
        return torch.cuda.device_count()
    return world_local
