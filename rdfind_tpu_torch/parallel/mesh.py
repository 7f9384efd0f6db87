"""The rank mesh: one process per rank over ``torch.distributed``.

The JAX package runs its sharded pipeline as a single controller: one host
process drives ``shard_map`` programs over a 1-D device mesh and ``host_gather``
hands it whole arrays.  The port runs it SPMD: every rank runs the same host code
on its own row block, and a collective stands wherever a ``shard_map`` program
reduces, exchanges or gathers across the mesh axis:

    psum / pmax / pmin          -> all_reduce(SUM / MAX / MIN)
    tiled all_to_all on (D, cap) -> all_to_all_single on the (D*cap,) buffer
    all_gather                  -> all_gather (rank order)
    axis_index_groups           -> dist.new_group subgroups, made once per mesh

The transport is explicit, never a fallback: CUDA tensors go over NCCL (one GPU
per local rank), CPU tensors over gloo.  ``RDFIND_TORCH_DIST_BACKEND=gloo`` asks
for gloo with CUDA compute (several ranks on one card): every buffer is then
staged through pinned host memory on the send and on the receive side.

A JAX "process" is a host, not a rank: the mesh carries the launch's
``num_hosts`` / ``host_index`` (1 and 0 for ``--dop N`` on one machine), which
stand wherever the JAX package asks for the process count or index.  Host-level
collectives (``allgather_host_values``) still run on every rank of a multi-host
mesh and return one row per host, the row of that host's local rank 0.
"""

from __future__ import annotations

import os

import numpy as np
import torch

BACKEND_ENV = "RDFIND_TORCH_DIST_BACKEND"


def _dist():
    import torch.distributed as dist
    return dist


def resolve_backend(device_type: str) -> tuple[str, bool]:
    """(backend, staged) for ranks computing on `device_type`: NCCL for CUDA,
    gloo for the CPU, or gloo staged through host memory for CUDA compute when
    RDFIND_TORCH_DIST_BACKEND=gloo asks for it."""
    want = os.environ.get(BACKEND_ENV, "").strip().lower()
    if want not in ("", "gloo", "nccl"):
        raise ValueError(f"{BACKEND_ENV}={want!r}: expected gloo or nccl")
    if device_type == "cuda":
        backend = want or "nccl"
        return backend, backend == "gloo"
    if want == "nccl":
        raise ValueError(f"{BACKEND_ENV}=nccl needs CUDA ranks; CPU ranks "
                         f"use gloo")
    return "gloo", False


class Mesh:
    """This rank's view of a 1-D mesh of `size` ranks.

    `device` is where the rank computes; `backend` / `staged` name the
    transport.  A mesh with no process group (`group_ready` False) is a
    one-rank mesh whose collectives are identities.
    """

    def __init__(self, *, rank: int = 0, size: int = 1, device=None,
                 backend: str = "none", staged: bool = False,
                 num_hosts: int = 1, host_index: int = 0,
                 local_rank: int = 0):
        self.rank = int(rank)
        self.size = int(size)
        self.device = torch.device(device if device is not None else "cpu")
        self.backend = backend
        self.staged = bool(staged)
        self.num_hosts = max(1, int(num_hosts))
        self.host_index = int(host_index)
        self.local_rank = int(local_rank)
        self.local_size = max(1, self.size // self.num_hosts)
        self._groups: dict = {}
        self.group_ready = backend != "none"
        # Whether exchanges send only each block's occupied slots.  On gloo
        # every collective already passes through host memory, so reading
        # the occupied width (one pmax, one host read) adds no device sync;
        # NCCL keeps the JAX package's fixed-shape wire, which never syncs.
        self.trim_wire = backend == "gloo"

    def __repr__(self):
        return (f"Mesh(rank={self.rank}, size={self.size}, "
                f"device={self.device}, backend={self.backend}, "
                f"staged={self.staged}, hosts={self.num_hosts})")

    @property
    def primary(self) -> bool:
        """Global rank 0: writes the run's sinks."""
        return self.rank == 0

    @property
    def host_primary(self) -> bool:
        """Local rank 0: writes this host's files."""
        return self.local_rank == 0

    # -- transport -------------------------------------------------------

    def _wire(self, t: torch.Tensor) -> torch.Tensor:
        t = t.contiguous()
        if not self.staged:
            return t
        h = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        h.copy_(t)
        return h

    def _back(self, t: torch.Tensor) -> torch.Tensor:
        return t.to(self.device) if self.staged else t

    def _empty_wire(self, shape, dtype) -> torch.Tensor:
        if self.staged:
            return torch.empty(shape, dtype=dtype, pin_memory=True)
        return torch.empty(shape, dtype=dtype, device=self.device)

    def all_reduce(self, t: torch.Tensor, op: str = "sum") -> torch.Tensor:
        """The mesh-wide SUM / MAX / MIN of `t` (a new tensor)."""
        if self.size == 1 and not self.group_ready:
            return t.clone()
        dist = _dist()
        w = self._wire(t).clone()
        dist.all_reduce(w, op={"sum": dist.ReduceOp.SUM,
                               "max": dist.ReduceOp.MAX,
                               "min": dist.ReduceOp.MIN}[op])
        return self._back(w)

    def psum(self, t) -> torch.Tensor:
        """Integer sums reduce in int64 (no int32 wrap), floats in their
        own precision."""
        t = torch.as_tensor(t, device=self.device)
        if not t.dtype.is_floating_point:
            t = t.to(torch.int64)
        return self.all_reduce(t, "sum")

    def pmax(self, t) -> torch.Tensor:
        t = torch.as_tensor(t, device=self.device)
        if t.dtype == torch.bool:
            t = t.to(torch.int64)
        return self.all_reduce(t, "max")

    def pmin(self, t) -> torch.Tensor:
        t = torch.as_tensor(t, device=self.device)
        return self.all_reduce(t, "min")

    def all_to_all(self, buf: torch.Tensor, group=None) -> torch.Tensor:
        """Tiled all_to_all over dim 0 (of size = the group's size): slab i
        goes to the group's member i, and slab i of the result came from
        member i."""
        if group is None and self.size == 1 and not self.group_ready:
            return buf.clone()
        dist = _dist()
        src = self._wire(buf)
        out = self._empty_wire(src.shape, src.dtype)
        dist.all_to_all_single(out, src, group=group)
        return self._back(out)

    def all_gather(self, t: torch.Tensor, group=None) -> torch.Tensor:
        """(group size, *t.shape): every member's `t`, in rank order."""
        gsize = self.size if group is None else _dist().get_world_size(group)
        if group is None and self.size == 1 and not self.group_ready:
            return t.clone().unsqueeze(0)
        dist = _dist()
        src = self._wire(t)
        outs = [self._empty_wire(src.shape, src.dtype) for _ in range(gsize)]
        dist.all_gather(outs, src, group=group)
        return self._back(torch.stack(outs))

    def hier_groups(self, hier):
        """(intra, inter) process groups of this rank for a (hosts, local)
        factorization: rank d = h * local + l; intra groups one host's ranks,
        inter the same local index across hosts.  Every rank creates every
        group once, in the same order (``dist.new_group`` is collective)."""
        if hier not in self._groups:
            h, l = hier
            intra, inter = hier_rank_groups(hier)
            dist = _dist()
            made_intra = [dist.new_group(g) for g in intra]
            made_inter = [dist.new_group(g) for g in inter]
            self._groups[hier] = (made_intra[self.rank // l],
                                  made_inter[self.rank % l])
        return self._groups[hier]

    def barrier(self) -> None:
        if self.group_ready and self.size > 1:
            self.psum(torch.zeros((), dtype=torch.int64))


def hier_rank_groups(hier):
    """(intra, inter) rank lists of a (hosts, local) factorization (the JAX
    package's ``exchange.hier_groups``)."""
    h, l = hier
    intra = [[hh * l + ll for ll in range(l)] for hh in range(h)]
    inter = [[hh * l + ll for hh in range(h)] for ll in range(l)]
    return intra, inter


_CURRENT: Mesh | None = None


def set_current(mesh: Mesh | None) -> None:
    """The mesh of this process's rank (set by the launcher)."""
    global _CURRENT
    _CURRENT = mesh


def current() -> Mesh | None:
    return _CURRENT


def make_mesh(device=None) -> Mesh:
    """This rank's mesh: the launcher's when one is up, else a one-rank mesh
    with no process group on `device`."""
    if _CURRENT is not None:
        return _CURRENT
    from .. import devices
    return Mesh(device=devices.resolve(device))


def world_size() -> int:
    """Ranks of this process's mesh (1 outside a launch)."""
    return _CURRENT.size if _CURRENT is not None else 1


def process_index() -> int:
    """The host index of this process (a JAX "process" is a host)."""
    return _CURRENT.host_index if _CURRENT is not None else 0


def process_count() -> int:
    return _CURRENT.num_hosts if _CURRENT is not None else 1


def topology_hosts(num_dev: int) -> int:
    """How many hosts the `num_dev`-rank mesh spans, for ledger attribution
    and the hierarchical factorization: RDFIND_HIER_HOSTS, else the launch's
    host count; a count that does not divide the mesh degenerates to 1."""
    try:
        hosts = int(os.environ.get("RDFIND_HIER_HOSTS", "") or
                    process_count())
    except ValueError:
        hosts = process_count()
    if hosts < 1 or num_dev % hosts != 0:
        return 1
    return hosts


def hier_spec(num_dev: int):
    """RDFIND_HIER_EXCHANGE -> a (hosts, local) factorization, or None for the
    flat single-hop exchange.  auto: hierarchical only across >1 host; 1:
    forced (with RDFIND_HIER_HOSTS); 0: flat."""
    knob = os.environ.get("RDFIND_HIER_EXCHANGE", "auto").strip().lower()
    if knob in ("0", "off", "flat"):
        return None
    hosts = topology_hosts(num_dev)
    if knob in ("1", "on", "force"):
        return (hosts, num_dev // hosts)
    if hosts <= 1:
        return None
    return (hosts, num_dev // hosts)


def dcn_chunks() -> int:
    """RDFIND_HIER_DCN_CHUNKS: the inter-host hop as this many independent
    all_to_all slices of the capacity axis (``auto`` reads the last overlap
    report)."""
    knob = os.environ.get("RDFIND_HIER_DCN_CHUNKS", "1").strip().lower()
    if knob == "auto":
        from ..obs import metrics
        return dcn_chunks_auto(metrics.registry().get("overlap"))
    try:
        return max(1, int(knob or "1"))
    except ValueError:
        return 1


def dcn_chunks_auto(report) -> int:
    """Chunk count from a measured overlap report: 1 with nothing to hide or
    efficiency >= 0.85, 2 at >= 0.5, else 4."""
    if not isinstance(report, dict):
        return 1
    eff = report.get("overlap_efficiency")
    pull_ms = report.get("pull_ms") or 0.0
    if eff is None or pull_ms < 1.0:
        return 1
    if eff >= 0.85:
        return 1
    if eff >= 0.5:
        return 2
    return 4


def link_probe_enabled() -> bool:
    """RDFIND_LINK_PROBE=1 arms the startup link-capability probe."""
    return os.environ.get("RDFIND_LINK_PROBE", "") not in ("", "0")


_LINK_PROBE_KEY = None
_PROBE_CAP = 1 << 13
_PROBE_REPS = 3


def _time_a2a(mesh: Mesh, gsize: int, cap: int, group) -> float:
    """Achieved GB/s of one all_to_all of a (gsize, cap) int32 buffer per
    rank (the ledger's byte convention: self-rows included)."""
    import time
    buf = torch.zeros((gsize, cap), dtype=torch.int32, device=mesh.device)
    mesh.all_to_all(buf, group)  # warm the route
    mesh.barrier()
    t0 = time.perf_counter()
    for _ in range(_PROBE_REPS):
        buf = mesh.all_to_all(buf, group)
    if mesh.device.type == "cuda":
        torch.cuda.synchronize(mesh.device)
    dt = (time.perf_counter() - t0) / _PROBE_REPS
    nbytes = mesh.size * gsize * cap * 4
    # Every rank must publish the same number: the slowest rank's rate.
    dt = float(mesh.pmax(torch.tensor(dt, dtype=torch.float64,
                                      device=mesh.device)))
    return nbytes / max(dt, 1e-9) / 1e9


def link_probe(mesh: Mesh | None = None, force: bool = False) -> dict:
    """One-shot per-hop link-capability microbench, cached in the metrics
    registry (``metrics.link_caps``): a tiny all_to_all per hop of the
    topology, intra-host (the whole mesh on one host) and inter-host."""
    global _LINK_PROBE_KEY
    from ..obs import metrics, tracer

    mesh = mesh or make_mesh()
    hosts = topology_hosts(mesh.size)
    key = (mesh.size, hosts)
    if not force and _LINK_PROBE_KEY == key:
        return metrics.link_caps()
    caps = {"num_dev": mesh.size, "hosts": hosts, "probe_cap": _PROBE_CAP}
    if hosts > 1:
        intra, inter = mesh.hier_groups((hosts, mesh.size // hosts))
        caps["ici_gbps"] = round(
            _time_a2a(mesh, mesh.size // hosts, _PROBE_CAP, intra), 3)
        caps["dcn_gbps"] = round(_time_a2a(mesh, hosts, _PROBE_CAP, inter), 3)
    else:
        caps["ici_gbps"] = round(
            _time_a2a(mesh, mesh.size, _PROBE_CAP, None), 3)
    _LINK_PROBE_KEY = key
    metrics.set_link_caps(caps)
    tracer.instant("link_probe", cat=tracer.CAT_EXCHANGE, **caps)
    return caps


def maybe_link_probe(mesh: Mesh | None = None) -> dict:
    if not link_probe_enabled():
        return {}
    return link_probe(mesh)


def host_value(t) -> np.ndarray:
    """A mesh-reduced (replicated) device value -> host numpy, through the
    fault gate's bounded pull retry (the JAX package's ``host_gather`` of a
    replicated output: every rank holds the same answer, so no collective)."""
    from ..runtime import faults
    return faults.guarded_pull(lambda: np.asarray(torch.as_tensor(t).cpu()))


def host_gather(mesh: Mesh, t: torch.Tensor) -> np.ndarray:
    """Per-rank fixed-shape blocks -> their concatenation in rank order on the
    host, valid on every rank (one all_gather, run once on every rank; only
    the local copy to the host goes through the fault gate's bounded pull
    retry, so no rank re-enters the collective alone)."""
    from ..runtime import faults
    gathered = mesh.all_gather(t).reshape((-1,) + tuple(t.shape[1:]))
    return faults.guarded_pull(lambda: gathered.cpu().numpy())


def allgather_host_values(mesh: Mesh | None, values,
                          site: str = "allgather") -> np.ndarray:
    """(n_hosts, k) matrix of per-host floats: the identity on one host; on
    several, every rank takes part in one tiny all_gather and the row of
    each host's local rank 0 is that host's.  `site` names the caller for the
    collective watchdog (and the wedge@<site> faults)."""
    from ..runtime import watchdog

    arr = np.asarray(values, np.float64).reshape(1, -1)
    hosts = mesh.num_hosts if mesh is not None else 1
    with watchdog.collective(site, arr.nbytes * hosts):
        if hosts == 1:
            return arr
        t = torch.as_tensor(arr[0], device=mesh.device)
        rows = mesh.all_gather(t).cpu().numpy()
    return rows[::mesh.local_size].reshape(-1, arr.shape[1])


def shard_rows(host_array: np.ndarray, mesh: Mesh) -> np.ndarray:
    """This rank's row block of a host array whose rows divide evenly by the
    mesh size."""
    blk = host_array.shape[0] // mesh.size
    return host_array[mesh.rank * blk:(mesh.rank + 1) * blk]


def make_global(host_array: np.ndarray, mesh: Mesh) -> torch.Tensor:
    """This rank's row block of an identical-on-every-rank host array, on the
    rank's device (the JAX package's global row-sharded array, one block)."""
    return torch.as_tensor(np.ascontiguousarray(
        shard_rows(host_array, mesh))).to(mesh.device)
