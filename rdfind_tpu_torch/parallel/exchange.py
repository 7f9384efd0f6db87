"""Fixed-capacity bucket exchanges and sorted-join primitives over the rank mesh.

On the device a shuffle moves fixed-shape buffers: sort rows by destination
bucket, scatter them into a (D, capacity) send buffer, one tiled all_to_all,
and a validity lane.  Overflowing rows are counted, never silently dropped: the
mesh-summed overflow tells the caller to retry with a larger capacity.  Every
buffer has exactly the JAX package's ``D * capacity`` slots and slot math, so a
rank's receive layout is the JAX device's, slot for slot.  The lanes of one
exchange travel stacked in one collective, and only as wide as the fullest
block: each (source, destination) block holds its rows in its first slots and
fill values after them, so the wire carries each block's first `width` slots
(the mesh-wide most rows of any block) and the receiver puts the fill back.
That trim costs a pmax and a host read per exchange, so only a gloo mesh,
whose wire is host memory anyway, takes it (``Mesh.trim_wire``); NCCL sends
the whole blocks, as the JAX package does.  The ledger (``log_exchange``)
keeps counting the fixed-shape buffers, the JAX package's bytes; the bytes
that crossed the wire are ``stats["exchange_wire_bytes"]``.

Round trips: the all_to_all is slot-preserving (received row (src, k) came from
src's send slot (owner, k)), so ``route_reply`` sends per-row answers back along
the same slots; ``global_row_counts`` uses the pair for the distributed
group-by-count-join-back of the frequency filter.

Hierarchical mode: with a (hosts x local) factorization (``mesh.hier_spec``)
``route`` runs as an intra-host all_to_all into a relay layout, then one
inter-host exchange, with the receive layout bit-identical to the flat path;
``route_combined`` merges duplicate (key, target host) rows at the relay so only
host-distinct rows cross hosts.

The ledger helpers (``log_exchange`` and the rest) are the JAX package's,
host-only.  Functions below take the rank's ``Mesh`` where the JAX package
takes the mesh axis name.
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np
import torch

from ..obs import metrics, tracer
from ..ops import hashing, segments

SENTINEL = segments.SENTINEL


def exchange_volume_bytes(num_dev: int, capacity: int, lanes: int) -> int:
    """Global wire bytes of one fixed-shape collective at a site: every lane
    is a (D, capacity) int32 buffer per rank, moved whole however many rows
    are valid, so D ranks x D destination rows x capacity x 4 bytes a lane."""
    return int(num_dev) * int(num_dev) * int(capacity) * int(lanes) * 4


def exchange_split_bytes(num_dev: int, capacity: int, lanes: int, *,
                         hosts: int = 1, hier: bool = False,
                         dcn_capacity: int | None = None,
                         reply_lanes: int = 0):
    """(ici_bytes, dcn_bytes, reply_bytes) of ONE dispatch at this site.

    Attribution follows the physical link a buffer row crosses under the
    (hosts x local) factorization: a row whose destination shares the
    sender's host rides ICI, a cross-host row rides DCN.  Flat single-hop:
    of each device's D destination rows, `local` stay on-host.  Hierarchical:
    hop 1 (full D x capacity buffer) is all ICI by construction; hop 2 moves
    `hosts` rows of `dcn_capacity` per device, hosts-1 of them cross-host.
    Reply traffic retraces the same hops, so it splits identically;
    `reply_bytes` is its (ICI + DCN) share of the totals.
    """
    d, cap = int(num_dev), int(capacity)
    hosts = max(1, int(hosts))
    local = max(1, d // hosts)
    if not hier:
        per_ici = d * local * cap * 4
        per_dcn = d * (d - local) * cap * 4
    else:
        dcn_row = int(dcn_capacity) if dcn_capacity else local * cap
        per_ici = (d * d * cap + d * dcn_row) * 4
        per_dcn = d * (hosts - 1) * dcn_row * 4
    all_lanes = int(lanes) + int(reply_lanes)
    return (per_ici * all_lanes, per_dcn * all_lanes,
            (per_ici + per_dcn) * int(reply_lanes))


def _empty_site_entry(lanes: int = 0) -> dict:
    return dict(calls=0, capacity=0, lanes=lanes, bytes=0, ici_bytes=0,
                dcn_bytes=0, reply_bytes=0, reply_lanes=0, dcn_capacity=0,
                hier=0, rows_capacity=0, rows=0, overflow_retries=0)


def log_exchange(stats, site: str, *, num_dev: int, capacity: int,
                 lanes: int, calls: int = 1, rows: int | None = None,
                 retries: int = 0, hosts: int = 1, hier: bool = False,
                 dcn_capacity: int | None = None,
                 reply_lanes: int = 0) -> None:
    """Host-side ledger of one exchange site's communication volume.

    The device collectives are fixed-shape, so the moved bytes are fully
    determined by (num_dev, capacity, lanes) x calls — the host callers that
    plan the capacities record every dispatch here (including retried and
    optimistically-discarded ones: their buffers moved too).  `rows`, when
    the host knows it, records measured valid rows; `rows_capacity` is the
    buffer-row upper bound the volume was provisioned for.  Multi-device
    bandwidth projections divide `bytes` by the link's measured throughput.

    `hosts`/`hier`/`dcn_capacity`/`reply_lanes` drive the ICI/DCN split
    (exchange_split_bytes): `bytes` stays the grand total (forward + reply,
    both links) and always equals ici_bytes + dcn_bytes.

    Returns this dispatch's byte attribution ({site, bytes, ici, dcn,
    reply}) so a caller timing the dispatch can hand it straight to
    log_dispatch_timing.
    """
    ici1, dcn1, reply1 = exchange_split_bytes(
        num_dev, capacity, lanes, hosts=hosts, hier=hier,
        dcn_capacity=dcn_capacity, reply_lanes=reply_lanes)
    nbytes = calls * (ici1 + dcn1)
    split = {"site": site, "bytes": nbytes, "ici": calls * ici1,
             "dcn": calls * dcn1, "reply": calls * reply1}
    if stats is None:
        return split

    def fn(c):
        e = c.setdefault("exchange_sites", {}).setdefault(
            site, _empty_site_entry(lanes))
        e["calls"] += calls
        e["capacity"] = max(e["capacity"], int(capacity))
        e["lanes"] = lanes
        e["reply_lanes"] = reply_lanes
        e["bytes"] += nbytes
        e["ici_bytes"] += calls * ici1
        e["dcn_bytes"] += calls * dcn1
        e["reply_bytes"] += calls * reply1
        e["dcn_capacity"] = max(e.get("dcn_capacity", 0),
                                int(dcn_capacity or 0))
        e["hier"] = max(e.get("hier", 0), 1 if hier else 0)
        e["rows_capacity"] += calls * int(num_dev) * int(capacity)
        if rows is not None:
            e["rows"] += int(rows)
        e["overflow_retries"] += retries

    metrics.mutate(stats, fn, key="exchange_sites", kind=metrics.STRUCT)
    tracer.instant("exchange", cat=tracer.CAT_EXCHANGE, site=site,
                   calls=calls, capacity=int(capacity), bytes=nbytes,
                   dcn_bytes=calls * dcn1)
    return split


SKETCH_ALLREDUCE_SITE = "sketch_allreduce"


def sketch_allreduce_bytes(num_dev: int, bits: int, *, hosts: int = 1,
                           hier: bool = False):
    """(ici_bytes, dcn_bytes) of ONE dense (bits,) int32 table all-reduce.

    Same per-device-to-each-destination attribution as exchange_split_bytes,
    applied to a dense operand: flat, every device's table reaches d-1 peers
    (local-1 on-host rows ride ICI, d-local cross DCN).  Hierarchical, the
    intra-host psum moves the same ICI volume but each host then crosses DCN
    with ONE pre-reduced table per inter-group member — hosts-1 cross-host
    copies per device instead of d-local, a factor-`local` DCN reduction
    (the combiner shape, with summation as the combine).
    """
    d, b = int(num_dev), int(bits) * 4
    hosts = max(1, int(hosts))
    local = max(1, d // hosts)
    ici = d * (local - 1) * b
    dcn = d * (hosts - 1) * b if hier else d * (d - local) * b
    return ici, dcn


def log_sketch_allreduce(stats, *, num_dev: int, bits: int, hosts: int = 1,
                         hier: bool = False, calls: int = 1):
    """Ledger entry for the dense count-min all-reduce site.

    Mirrors log_exchange for the sharded two-round's sketch reduction: the
    site rides the same exchange_sites struct, so the --debug exchange
    lines, the Prometheus export, and log_dispatch_timing's wall/GB/s/
    link_util attribution all cover it with zero renderer changes.
    `capacity` records the table width (counters); one int32 lane.
    Returns the split part-dict for log_dispatch_timing.
    """
    ici1, dcn1 = sketch_allreduce_bytes(num_dev, bits, hosts=hosts, hier=hier)
    nbytes = calls * (ici1 + dcn1)
    split = {"site": SKETCH_ALLREDUCE_SITE, "bytes": nbytes,
             "ici": calls * ici1, "dcn": calls * dcn1, "reply": 0}
    if stats is None:
        return split

    def fn(c):
        e = c.setdefault("exchange_sites", {}).setdefault(
            SKETCH_ALLREDUCE_SITE, _empty_site_entry(1))
        e["calls"] += calls
        e["capacity"] = max(e["capacity"], int(bits))
        e["lanes"] = 1
        e["bytes"] += nbytes
        e["ici_bytes"] += calls * ici1
        e["dcn_bytes"] += calls * dcn1
        e["hier"] = max(e.get("hier", 0), 1 if hier else 0)
        e["rows_capacity"] += calls * int(num_dev) * int(bits)
        e["rows"] += calls * int(num_dev) * int(bits)

    metrics.mutate(stats, fn, key="exchange_sites", kind=metrics.STRUCT)
    tracer.instant("exchange", cat=tracer.CAT_EXCHANGE,
                   site=SKETCH_ALLREDUCE_SITE, calls=calls,
                   capacity=int(bits), bytes=nbytes, dcn_bytes=calls * dcn1)
    return split


def sketch_allreduce(table, mesh, *, cap: int, hier=None):
    """Saturating all-reduce of per-rank count-min partial tables: the cap is
    re-applied after every reduce level, so the result equals one global
    sum-then-cap (the saturation lemma).  Flat: one reduce; hierarchical:
    intra-host reduce, cap, then the per-host tables across hosts."""
    if hier is None:
        return torch.clamp(mesh.psum(table), max=cap).to(table.dtype)
    intra, inter = mesh.hier_groups(hier)
    t = _group_sum(mesh, table.to(torch.int64), intra)
    t = torch.clamp(t, max=cap)
    return torch.clamp(_group_sum(mesh, t, inter), max=cap).to(table.dtype)


def _group_sum(mesh, t, group):
    return mesh.all_gather(t, group).sum(0)


def collective_timing_enabled() -> bool:
    """Whether the per-site collective timers are armed
    (RDFIND_COLLECTIVE_TIMING=1).  Off by default: timing a dispatch means
    blocking on it (device-synchronized wall), which serializes the
    pipelined executor — measurement mode, not flight mode.  Outputs are
    bit-identical either way; only the schedule changes."""
    return os.environ.get("RDFIND_COLLECTIVE_TIMING", "") not in ("", "0")


def log_dispatch_timing(stats, parts, wall_ms: float) -> None:
    """Attribute one device-synchronized dispatch wall time across the
    exchange sites it contained.

    `parts` is the list of split dicts the dispatch's log_exchange calls
    returned (a fused device program can serve several ledger sites — e.g.
    freq + exchange_a ride one jit); the wall splits across them
    proportionally to bytes.  Per site the ledger accumulates

      wall_ms      measured wall attributed to this site,
      timed_calls / timed_bytes   how much of the site's traffic was timed,
      ideal_ms     the link-transfer lower bound of the timed traffic at the
                   probed per-hop peaks (mesh.link_probe), and derives
      gbps         achieved wire throughput (timed_bytes / wall_ms),
      link_util    ideal_ms / wall_ms — utilization-of-measured-peak; low
                   means the dispatch was compute- or latency-bound, not
                   link-bound (absent when no probe ran).

    Per-site histograms (`exchange_<site>_wall_ms`, `exchange_<site>_gbps`)
    and a trace counter track (`exchange_gbps`) ride along for p50/p95/p99
    exposition and Perfetto lanes.
    """
    parts = [p for p in parts if p]
    total = sum(p["bytes"] for p in parts)
    if not parts or total <= 0 or wall_ms <= 0:
        return
    caps = metrics.link_caps()
    ici_peak = caps.get("ici_gbps") or 0.0
    dcn_peak = caps.get("dcn_gbps") or 0.0
    for p in parts:
        share_ms = wall_ms * p["bytes"] / total
        ideal_ms = 0.0
        if ici_peak > 0:
            ideal_ms += p["ici"] / (ici_peak * 1e9) * 1e3
        if dcn_peak > 0:
            ideal_ms += p["dcn"] / (dcn_peak * 1e9) * 1e3
        gbps = p["bytes"] / (share_ms * 1e-3) / 1e9

        def fn(c, p=p, share_ms=share_ms, ideal_ms=ideal_ms):
            e = c.setdefault("exchange_sites", {}).setdefault(
                p["site"], _empty_site_entry())
            e["wall_ms"] = round(e.get("wall_ms", 0.0) + share_ms, 3)
            e["timed_calls"] = e.get("timed_calls", 0) + 1
            e["timed_bytes"] = e.get("timed_bytes", 0) + p["bytes"]
            e["ideal_ms"] = round(e.get("ideal_ms", 0.0) + ideal_ms, 3)
            wall = e["wall_ms"]
            e["gbps"] = round(e["timed_bytes"] / (wall * 1e-3) / 1e9, 3)
            if e["ideal_ms"] > 0:
                e["link_util"] = round(e["ideal_ms"] / wall, 4)

        metrics.mutate(stats, fn, key="exchange_sites", kind=metrics.STRUCT)
        metrics.observe(f"exchange_{p['site']}_wall_ms", share_ms)
        metrics.observe(f"exchange_{p['site']}_gbps", gbps)
        tracer.counter("exchange_gbps", **{p["site"]: round(gbps, 3)})


def log_exchange_retry(stats, site: str) -> None:
    """Count one overflow-retry against `site` (ledger entry created lazily
    so a retry before the first successful dispatch still lands)."""
    if stats is None:
        return

    def fn(c):
        e = c.setdefault("exchange_sites", {}).setdefault(
            site, _empty_site_entry())
        e["overflow_retries"] += 1

    metrics.mutate(stats, fn, key="exchange_sites", kind=metrics.STRUCT)
    tracer.instant("exchange_retry", cat=tracer.CAT_EXCHANGE, site=site)


def pack_counters(values) -> torch.Tensor:
    """Fuse scalar counters into ONE int32 lane array (every lane wraps to
    int32 as the JAX package's int32 psums do), so the host reads all of a
    pass's control state in one pull."""
    out = []
    for v in values:
        t = torch.as_tensor(v).to(torch.int64).reshape(())
        out.append(t)
    lanes = torch.stack([t.to(out[0].device) for t in out])
    lanes = ((lanes + (1 << 31)) & 0xFFFFFFFF) - (1 << 31)
    return lanes.to(torch.int32)


def unpack_counters(host_arr, n: int, num_dev: int = 1) -> np.ndarray:
    """Host inverse of pack_counters.  Every lane is mesh-reduced, so each
    rank holds the whole answer."""
    return np.asarray(host_arr).reshape(-1, n)[0]


# The bytes this rank has put on the exchange wire (all_to_all sends, this
# process's lifetime); the pipeline publishes their mesh-wide sum beside the
# ledger's fixed-shape bytes.
_WIRE = {"bytes": 0}


def wire_bytes() -> int:
    return _WIRE["bytes"]


def _a2a_rows(mesh, buf, group=None, chunks: int = 1):
    """Tiled all_to_all over dim 0 of `buf` (G, K, X), optionally as `chunks`
    independent collectives over slices of the last axis (each slice is
    slot-preserving, so the concatenation equals the unchunked exchange)."""
    if chunks > 1 and buf.shape[-1] % chunks == 0:
        return torch.cat([mesh.all_to_all(p.contiguous(), group)
                          for p in torch.chunk(buf, chunks, dim=-1)], dim=-1)
    return mesh.all_to_all(buf, group)


def _a2a_blocks(mesh, lanes, g: int, cap: int, width: int, fills,
                group=None, chunks: int = 1):
    """One tiled all_to_all of (K, g * B * cap) lanes: g destination slabs of
    B blocks of `cap` slots.  Every block holds its rows in its first slots
    and fill values after them, and no block holds more than `width` rows,
    so only each block's first `width` slots go on the wire; the receiver
    puts the fill values back.  The received (K, g * B * cap) lanes equal
    the whole buffers' exchange slot for slot."""
    k = lanes.shape[0]
    b = lanes.shape[1] // (g * cap)
    w = max(1, min(int(width), cap))
    buf = lanes.reshape(k, g, b, cap)[..., :w].permute(1, 0, 2, 3)
    _WIRE["bytes"] += buf.numel() * buf.element_size()
    r = _a2a_rows(mesh, buf.reshape(g, k, b * w), group, chunks)
    if w == cap:
        return r.reshape(g, k, b, cap).permute(1, 0, 2, 3).reshape(k, -1)
    out = torch.empty((k, g, b, cap), dtype=lanes.dtype, device=lanes.device)
    for i, f in enumerate(fills):
        out[i].fill_(f)
    out[..., :w] = r.reshape(g, k, b, w).permute(1, 0, 2, 3)
    return out.reshape(k, -1)


def _width(mesh, pos, ok, capacity: int) -> int:
    """How many slots of each block go on the wire: the most rows any block
    of the exchange holds, over the mesh, where the mesh trims its wire
    (``Mesh.trim_wire``), else the whole block."""
    if not mesh.trim_wire:
        return capacity
    local = (torch.where(ok, pos + 1, 0).max() if pos.numel()
             else torch.zeros((), dtype=torch.int64, device=pos.device))
    return int(mesh.pmax(local))


def _hier_fwd(mesh, lanes, hier, width: int, fills, dcn_chunks: int = 1):
    """Two-hop forward exchange of hier-slotted (K, D*cap) send lanes.

    The sender lays rows out [l_t, h_t, k].  Hop 1 (intra-host): the relay
    (h_s, l_t) collects every local source's block for local index l_t, laid
    out [l_s, h_t, k]; a transpose regroups by target host and hop 2
    (inter-host) lands [h_s, l_s, k] on the target: the flat receive layout.
    """
    h, l = hier
    intra, inter = mesh.hier_groups(hier)
    k = lanes.shape[0]
    cap = lanes.shape[1] // (h * l)
    r = _a2a_blocks(mesh, lanes, l, cap, width, fills, intra)
    r = r.reshape(k, l, h, cap).permute(0, 2, 1, 3).reshape(k, -1)
    return _a2a_blocks(mesh, r, h, cap, width, fills, inter, dcn_chunks)


def _hier_back(mesh, lanes, hier, width: int, dcn_chunks: int = 1):
    """Reverse both hops: (K, D*cap) [src, k]-layout answers back into the
    sender's [l_t, h_t, k] send-slot layout (answers past a block's rows are
    never read, so they travel as zeros)."""
    h, l = hier
    intra, inter = mesh.hier_groups(hier)
    k = lanes.shape[0]
    cap = lanes.shape[1] // (h * l)
    zeros = [0] * k
    r = _a2a_blocks(mesh, lanes, h, cap, width, zeros, inter, dcn_chunks)
    r = r.reshape(k, h, l, cap).permute(0, 2, 1, 3).reshape(k, -1)
    return _a2a_blocks(mesh, r, l, cap, width, zeros, intra)


def _scatter_lanes(values, flat, size: int, fills):
    """(K, size) send lanes: lane i holds values[i] at slots `flat` (slot
    `size` drops), `fills[i]` elsewhere."""
    dev = flat.device
    out = torch.empty((len(values), size + 1), dtype=torch.int32, device=dev)
    for i, (v, f) in enumerate(zip(values, fills)):
        out[i].fill_(f)
        out[i][flat] = v.to(torch.int32)
    return out[:, :size]


def _slots(valid, bucket, d: int, capacity: int, hier=None):
    """route()'s slotting: (perm, flat, ok, pos, overflow_local) for rows
    sorted stably by destination, each at its position within the
    destination."""
    n = valid.shape[0]
    tgt = torch.where(valid, bucket.to(torch.int64), d)
    perm = segments.lexsort([tgt])
    t_s = tgt[perm]
    v_s = valid[perm]
    idx = torch.arange(n, device=valid.device)
    starts = segments.run_starts([t_s])
    run_start = torch.cummax(torch.where(starts, idx, 0), 0).values
    pos = idx - run_start
    ok = v_s & (pos < capacity)
    if hier is None:
        slot_dev = t_s
    else:
        hh, ll = hier
        slot_dev = (t_s % ll) * hh + (t_s // ll)
    flat = torch.where(ok, slot_dev * capacity + pos, d * capacity)
    return perm, flat, ok, pos, (v_s & ~ok).sum()


@dataclasses.dataclass
class RouteState:
    """Slot mapping of one routed exchange (everything route_reply needs)."""

    perm: torch.Tensor  # sorted order -> original row index
    flat: torch.Tensor  # per sorted row: slot in the (D*capacity) send buffer
    ok: torch.Tensor    # per sorted row: survived (valid and under capacity)
    num_dev: int
    capacity: int
    width: int  # the most rows of any destination block, over the mesh
    hier: tuple | None = None
    dcn_chunks: int = 1


def route(cols, valid, bucket, mesh, capacity: int, *, hier=None,
          dcn_chunks: int = 1):
    """Route rows to the rank equal to their bucket id.

    Returns (out_cols, out_valid, overflow, state): out_cols are (D*capacity,)
    int32 columns of the rows this rank received (SENTINEL where ~out_valid);
    overflow is the mesh-wide count of rows dropped for exceeding a bucket's
    capacity (a 0-d int64 tensor); state feeds route_reply.
    """
    d = mesh.size
    perm, flat, ok, pos, ovf_local = _slots(valid, bucket, d, capacity, hier)
    overflow = mesh.psum(ovf_local)
    width = _width(mesh, pos, ok, capacity)
    # Validity travels as its own lane, so payload SENTINELs stay
    # representable; `ok` is already in sorted order, aligned with `flat`.
    fills = [SENTINEL] * len(cols) + [0]
    lanes = _scatter_lanes([c[perm] for c in cols] + [ok], flat,
                           d * capacity, fills)
    recv = (_a2a_blocks(mesh, lanes, d, capacity, width, fills)
            if hier is None
            else _hier_fwd(mesh, lanes, hier, width, fills, dcn_chunks))
    state = RouteState(perm=perm, flat=flat, ok=ok, num_dev=d,
                       capacity=capacity, width=width, hier=hier,
                       dcn_chunks=dcn_chunks)
    return list(recv[:-1]), recv[-1] == 1, overflow, state


def route_reply(answer, state: RouteState, mesh):
    """One (D*capacity,) int32 answer per received row back to the senders:
    an (N,) column in route()'s original row order (0 for dropped or invalid
    rows)."""
    n = state.perm.shape[0]
    lanes = answer.to(torch.int32).reshape(1, -1)
    if state.hier is None:
        back = _a2a_blocks(mesh, lanes, state.num_dev, state.capacity,
                           state.width, [0])[0]
    else:
        back = _hier_back(mesh, lanes, state.hier, state.width,
                          state.dcn_chunks)[0]
    safe = torch.clamp(state.flat, 0, state.num_dev * state.capacity - 1)
    vals = torch.where(state.ok, back[safe], 0)
    out = torch.zeros(n, dtype=torch.int32, device=answer.device)
    out[state.perm] = vals.to(torch.int32)
    return out


def bucket_exchange(cols, valid, bucket, mesh, capacity: int, *, hier=None,
                    dcn_chunks: int = 1):
    """route() without the reply half (the one-way shuffle)."""
    out_cols, out_valid, overflow, _ = route(cols, valid, bucket, mesh,
                                             capacity, hier=hier,
                                             dcn_chunks=dcn_chunks)
    return out_cols, out_valid, overflow


@dataclasses.dataclass
class CombinedState:
    """Slot + combine mappings of one route_combined (for the reply path)."""

    perm: torch.Tensor
    flat: torch.Tensor
    ok: torch.Tensor
    uinv: torch.Tensor
    rvalid: torch.Tensor
    perm2: torch.Tensor
    flat2: torch.Tensor
    ok2: torch.Tensor
    num_dev: int
    capacity: int
    dcn_capacity: int
    hier: tuple
    width: int   # hop 1: the most rows of any block, over the mesh
    width2: int  # hop 2: the same for the combined rows
    dcn_chunks: int = 1


def route_combined(cols, weight, valid, bucket, mesh, capacity: int,
                   dcn_capacity: int, hier, *, dcn_chunks: int = 1):
    """Two-level route with per-host pre-aggregation before the inter-host
    hop: rows ride hop 1 exactly as route(hier=...) (same overflow), pause at
    the relay where duplicate (key, target host) rows merge (`weight` sums;
    None is pure dedupe), and only host-distinct rows cross hosts into a
    (hosts, dcn_capacity) budget.  `bucket` must be a pure function of `cols`.

    Returns (out_cols, out_weight, out_valid, (overflow, overflow_dcn), state)
    with out_* of length hosts*dcn_capacity.
    """
    hh, ll = hier
    d = mesh.size
    intra, inter = mesh.hier_groups(hier)
    perm, flat, ok, pos, ovf_local = _slots(valid, bucket, d, capacity, hier)
    overflow = mesh.psum(ovf_local)
    width = _width(mesh, pos, ok, capacity)

    vals = [c[perm] for c in cols]
    fills = [SENTINEL] * len(cols)
    if weight is not None:
        vals.append(torch.where(ok, weight[perm], 0))
        fills.append(0)
    vals.append(ok)
    fills.append(0)
    r = _a2a_blocks(mesh, _scatter_lanes(vals, flat, d * capacity, fills),
                    ll, capacity, width, fills, intra)
    r_cols = list(r[:len(cols)])
    r_w = r[len(cols)] if weight is not None else None
    rvalid = r[-1] == 1

    # Relay combine: the target host of relay slot i is structural.
    m = d * capacity
    dev = valid.device
    r_ht = ((torch.arange(m, device=dev) // capacity) % hh).to(torch.int32)
    u_cols, u_valid, uinv, _ = segments.padded_unique(r_cols + [r_ht],
                                                      rvalid)
    uinv_safe = torch.clamp(uinv, 0, m - 1)
    u_w = (segments.segment_sum(torch.where(rvalid, r_w, 0), uinv_safe, m)
           if r_w is not None else None)
    u_ht = u_cols[-1]

    # Hop 2 (inter-host): slot the combined rows against the per-host budget.
    tgt2 = torch.where(u_valid, u_ht.to(torch.int64), hh)
    perm2 = segments.lexsort([tgt2])
    t2_s = tgt2[perm2]
    v2_s = u_valid[perm2]
    idx2 = torch.arange(m, device=dev)
    starts2 = segments.run_starts([t2_s])
    rs2 = torch.cummax(torch.where(starts2, idx2, 0), 0).values
    pos2 = idx2 - rs2
    ok2 = v2_s & (pos2 < dcn_capacity)
    flat2 = torch.where(ok2, t2_s * dcn_capacity + pos2, hh * dcn_capacity)
    overflow_dcn = mesh.psum((v2_s & ~ok2).sum())
    width2 = _width(mesh, pos2, ok2, dcn_capacity)

    vals2 = [c[perm2] for c in u_cols[:-1]]
    fills2 = [SENTINEL] * len(cols)
    if u_w is not None:
        vals2.append(u_w[perm2])
        fills2.append(0)
    vals2.append(ok2)
    fills2.append(0)
    out = _a2a_blocks(
        mesh, _scatter_lanes(vals2, flat2, hh * dcn_capacity, fills2), hh,
        dcn_capacity, width2, fills2, inter, dcn_chunks)
    out_cols = list(out[:len(cols)])
    out_w = out[len(cols)] if u_w is not None else None
    out_valid = out[-1] == 1
    state = CombinedState(perm=perm, flat=flat, ok=ok, uinv=uinv,
                          rvalid=rvalid, perm2=perm2, flat2=flat2, ok2=ok2,
                          num_dev=d, capacity=capacity,
                          dcn_capacity=dcn_capacity, hier=hier, width=width,
                          width2=width2, dcn_chunks=dcn_chunks)
    return out_cols, out_w, out_valid, (overflow, overflow_dcn), state


def route_combined_reply(answer, state: CombinedState, mesh):
    """Per-received-combined-row answers back to the original senders' rows:
    reverse the inter-host hop to the relay, fan each combined row's answer
    out to every relay row merged into it, reverse the intra-host hop."""
    hh, ll = state.hier
    cap, dcap = state.capacity, state.dcn_capacity
    intra, inter = mesh.hier_groups(state.hier)
    m = state.perm2.shape[0]
    dev = answer.device
    back2 = _a2a_blocks(mesh, answer.to(torch.int32).reshape(1, -1), hh,
                        dcap, state.width2, [0], inter,
                        state.dcn_chunks)[0]
    safe2 = torch.clamp(state.flat2, 0, hh * dcap - 1)
    vals2 = torch.where(state.ok2, back2[safe2], 0)
    ans_comb = torch.zeros(m, dtype=torch.int32, device=dev)
    ans_comb[state.perm2] = vals2.to(torch.int32)
    uinv_safe = torch.clamp(state.uinv, 0, m - 1)
    ans_relay = torch.where(state.rvalid, ans_comb[uinv_safe], 0)
    back1 = _a2a_blocks(mesh, ans_relay.to(torch.int32).reshape(1, -1), ll,
                        cap, state.width, [0], intra)[0]
    n = state.perm.shape[0]
    safe1 = torch.clamp(state.flat, 0, state.num_dev * cap - 1)
    vals = torch.where(state.ok, back1[safe1], 0)
    out = torch.zeros(n, dtype=torch.int32, device=dev)
    out[state.perm] = vals.to(torch.int32)
    return out


def _local_distinct(key_cols, valid):
    u_cols, u_valid, inv, _ = segments.padded_unique(key_cols, valid)
    m = u_cols[0].shape[0]
    inv_safe = torch.clamp(inv, 0, m - 1)
    local_mult = segments.segment_sum(valid.to(torch.int32), inv_safe, m)
    return u_cols, u_valid, inv_safe, local_mult


def global_row_counts(key_cols, valid, mesh, capacity: int, *, seed: int,
                      hier=None, dcn_capacity: int | None = None,
                      dcn_chunks: int = 1):
    """Per-row GLOBAL count of the row's key across all ranks: local distinct
    keys carry their multiplicities to the key's hash owner, the owner sums
    them, and the sums ride the reply back to every asking row.  Returns
    (counts (N,) int32, overflow); overflow > 0 makes the counts unusable."""
    d = mesh.size
    u_cols, u_valid, inv_safe, local_mult = _local_distinct(key_cols, valid)
    bucket = hashing.bucket_of(u_cols, d, seed=seed)
    if hier is None:
        recv, recv_valid, overflow, state = route(
            u_cols + [local_mult], u_valid, bucket, mesh, capacity)
        g = segments.masked_weighted_row_counts(recv[:-1], recv[-1],
                                                recv_valid)
        ans = route_reply(g, state, mesh)
        return torch.where(valid, ans[inv_safe], 0), overflow
    recv, recv_w, recv_valid, (ovf, ovf_dcn), state = route_combined(
        u_cols, local_mult, u_valid, bucket, mesh, capacity, dcn_capacity,
        hier, dcn_chunks=dcn_chunks)
    g = segments.masked_weighted_row_counts(recv, recv_w, recv_valid)
    ans = route_combined_reply(g, state, mesh)
    return torch.where(valid, ans[inv_safe], 0), ovf + ovf_dcn


def global_distinct_frequent(key_cols, valid, min_support, mesh,
                             capacity: int, *, seed: int, hier=None,
                             dcn_capacity: int | None = None,
                             dcn_chunks: int = 1):
    """GLOBAL number of distinct keys occurring >= min_support times.
    Returns (count, overflow); overflow > 0 invalidates the count."""
    d = mesh.size
    u_cols, u_valid, _, local_mult = _local_distinct(key_cols, valid)
    bucket = hashing.bucket_of(u_cols, d, seed=seed)
    if hier is None:
        recv, recv_valid, overflow, _ = route(u_cols + [local_mult], u_valid,
                                              bucket, mesh, capacity)
        g = segments.masked_weighted_row_counts(recv[:-1], recv[-1],
                                                recv_valid)
        ok = recv_valid & (g >= min_support)
        _, _, _, n_u = segments.padded_unique(recv[:-1], ok)
        return mesh.psum(n_u), overflow
    recv, recv_w, recv_valid, (ovf, ovf_dcn), _ = route_combined(
        u_cols, local_mult, u_valid, bucket, mesh, capacity, dcn_capacity,
        hier, dcn_chunks=dcn_chunks)
    g = segments.masked_weighted_row_counts(recv, recv_w, recv_valid)
    ok = recv_valid & (g >= min_support)
    _, _, _, n_u = segments.padded_unique(recv, ok)
    return mesh.psum(n_u), ovf + ovf_dcn


def sorted_join_counts(table_cols, table_counts, table_valid, query_cols,
                       query_valid):
    """For each query row, the count of its key in a distinct-key table (0 if
    absent): a tag-sorted merge join where each run starts with its table row
    (if present), whose count forward-fills to the run's query rows."""
    nt = table_cols[0].shape[0]
    nq = query_cols[0].shape[0]
    dev = query_valid.device
    tag = torch.cat([torch.zeros(nt, dtype=torch.int32, device=dev),
                     torch.ones(nq, dtype=torch.int32, device=dev)])
    allv = torch.cat([table_valid, query_valid])
    keys = [torch.where(allv, torch.cat([t, q]), SENTINEL)
            for t, q in zip(table_cols, query_cols)]
    cnt = torch.cat([table_counts.to(torch.int32),
                     torch.zeros(nq, dtype=torch.int32, device=dev)])
    perm = segments.lexsort(keys + [tag])
    keys_s = [k[perm] for k in keys]
    tag_s = tag[perm]
    cnt_s = cnt[perm]
    idx = torch.arange(nt + nq, device=dev)
    starts = segments.run_starts(keys_s)
    run_start = torch.cummax(torch.where(starts, idx, 0), 0).values
    filled = torch.where(tag_s[run_start] == 0, cnt_s[run_start], 0)
    out = torch.empty(nt + nq, dtype=torch.int32, device=dev)
    out[perm] = filled.to(torch.int32)
    return out[nt:]
