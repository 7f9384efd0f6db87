"""Sharded multi-host ingest: each host reads a disjoint subset of the files.

Hosts parse and intern their own file shards in parallel (the native engine
where it applies), agree on one global dictionary by exchanging their distinct
values, remap their local ids and keep their rows: each rank ends with its own
row block of the global triple table, and no host ever holds the whole table.

A host is one launch group of ranks (``--num-hosts``/``--host-index``,
``parallel/launch.py``).  Every rank of a host parses the host's files (the
parse is deterministic, so they agree with no intra-host transfer) and takes
its share of the host's rows.  Host-level exchanges run as all_gathers on
every rank of the mesh, and each host contributes the row of its local rank 0
(``parallel/mesh.allgather_host_values``'s convention).

Dictionary: with several hosts interning is hash-partitioned by default (each
host stores only the values whose crc32 falls in its range:
``partitioned_intern``), so steady host memory is O(local distinct + own
range), never the union; decoding is then a collective (``resolve``).
``partition_dictionary=False`` keeps one replicated ``Dictionary``.
"""

from __future__ import annotations

import dataclasses
import zlib

import numpy as np
import torch

from ..dictionary import Dictionary, intern_triples
from ..io import native, ntriples, reader
from ..obs import metrics, tracer


def shard_paths(paths: list[str], num_hosts: int, host_index: int) -> list[str]:
    """Round-robin file ownership (file sizes are typically uniform shards)."""
    return paths[host_index::num_hosts]


def native_parse_eligible(use_native: bool, transform, encoding) -> bool:
    """Whether the native parser takes this configuration: the one answer the
    ingest and the checkpoint fingerprint share, so a cached parse of one
    parser never satisfies a run of the other."""
    return (transform is None and use_native and native.available()
            and reader.is_utf8(encoding))


def _local_ingest(paths, tabs: bool, expect_quad: bool, encoding,
                  use_native: bool = True, transform=None, stats=None):
    """This host's file subset -> (local (N, 3) int32 ids, local Dictionary).

    `transform(token) -> token` runs per-token preprocessing (asciify, URL
    shortening) before interning; it takes the Python parser.  `stats`, when
    a dict, receives the ingest telemetry.
    """
    if not paths:
        return np.zeros((0, 3), np.int32), Dictionary(np.zeros(0, object))
    if native_parse_eligible(use_native, transform, encoding):
        return native.ingest_files(paths, tabs=tabs, expect_quad=expect_quad,
                                   stats=stats)
    rows = []
    with tracer.span("ingest-python", cat=tracer.CAT_STAGE, files=len(paths)):
        for _, line in reader.iter_lines(paths, encoding=encoding):
            t = (ntriples.parse_tab_line(line) if tabs
                 else ntriples.parse_line(line, expect_quad=expect_quad))
            if t is not None:
                rows.append(t if transform is None else tuple(
                    transform(v) for v in t))
        if not rows:
            return (np.zeros((0, 3), np.int32),
                    Dictionary(np.zeros(0, object)))
        out = intern_triples(np.asarray(rows, dtype=object))
    if stats is not None:
        metrics.set_many(stats, n_threads=1, triples=int(out[0].shape[0]),
                         values=len(out[1]), parser="python")
    return out


# ---------------------------------------------------------------------------
# Host-level exchanges over the rank mesh.
# ---------------------------------------------------------------------------


def _host_rows(mesh, arr: np.ndarray) -> np.ndarray:
    """(num_hosts, *arr.shape): each host's `arr` (its local rank 0's), from
    one all_gather on every rank; every rank's `arr` has the same shape."""
    t = torch.as_tensor(np.ascontiguousarray(arr)).to(mesh.device)
    rows = mesh.all_gather(t).cpu().numpy()
    return rows[::mesh.local_size]


def _allgather_str_arrays(mesh, local_values) -> list[np.ndarray]:
    """Every host's value array, as a list indexed by host.  Strings travel as
    one UTF-8 blob and offsets per host, padded to the largest, so the
    gathers see fixed shapes; the strings come back byte for byte."""
    encoded = [str(v).encode("utf-8") for v in local_values]
    blob = b"".join(encoded)
    offsets = np.zeros(len(encoded) + 1, np.int64)
    np.cumsum([len(e) for e in encoded], out=offsets[1:])

    sizes = _host_rows(mesh, np.asarray([len(blob), len(offsets)], np.int64))
    # Every rank pads to the largest over all ranks (one rank's shape must
    # equal every other's); the host rows are its local rank 0's.
    top = mesh.pmax(torch.as_tensor(
        np.asarray([len(blob), len(offsets)], np.int64)).to(mesh.device))
    max_blob, max_offs = (max(int(x), 1) for x in top.cpu().tolist())
    blob_pad = np.zeros(max_blob, np.uint8)
    blob_pad[:len(blob)] = np.frombuffer(blob, np.uint8)
    offs_pad = np.full(max_offs, -1, np.int64)
    offs_pad[:len(offsets)] = offsets
    all_blobs = _host_rows(mesh, blob_pad)
    all_offs = _host_rows(mesh, offs_pad)

    out = []
    for h in range(sizes.shape[0]):
        offs = all_offs[h][:int(sizes[h, 1])]
        raw = all_blobs[h].tobytes()
        out.append(np.asarray(
            [raw[offs[i]:offs[i + 1]].decode("utf-8")
             for i in range(len(offs) - 1)], object))
    return out


def _allgather_values(mesh, local_values) -> np.ndarray:
    """Union of every host's distinct values, identical on every rank."""
    if mesh.num_hosts == 1:
        return np.asarray(local_values, object)
    gathered = _allgather_str_arrays(mesh, local_values)
    return np.unique(np.concatenate(gathered)) if gathered else \
        np.zeros(0, object)


# ---------------------------------------------------------------------------
# Hash-partitioned interning: each host owns a value-hash range.
# ---------------------------------------------------------------------------


def value_shard(value, num_shards: int) -> int:
    """The hash partition of a dictionary value: crc32 over its UTF-8 bytes,
    modulo the shard count (the JAX package's ``dictionary.value_shard``, and
    the native engine's interner-merge shards)."""
    return zlib.crc32(str(value).encode("utf-8")) % num_shards


def _value_owner(values, num_hosts: int) -> np.ndarray:
    """The owner host of each value, identical on every host."""
    return np.fromiter((value_shard(v, num_hosts) for v in values),
                       np.int64, count=len(values))


@dataclasses.dataclass
class PartitionedDictionary:
    """Global dictionary with host-partitioned storage.

    Host h stores only the values whose crc32 maps to it; their global ids
    are ``offsets[h] + rank within the owner's sorted range``.  No host holds
    the union, so decoding takes a collective: ``resolve(ids)`` returns a
    ResolvedDictionary covering just those ids (every rank must call it).
    """

    offsets: np.ndarray  # (H+1,) int64: global-id range start per owner host
    own_values: np.ndarray  # sorted distinct values owned by this host
    host_index: int
    num_hosts: int
    mesh: object = dataclasses.field(repr=False, default=None)

    def __len__(self) -> int:
        return int(self.offsets[-1])

    def __getstate__(self):
        # A rank's result crosses to the launcher's parent without its mesh
        # (process groups do not pickle); only resolve() needs the mesh.
        return {**self.__dict__, "mesh": None}

    def _range(self) -> tuple[int, int]:
        return (int(self.offsets[self.host_index]),
                int(self.offsets[self.host_index + 1]))

    def value(self, idx: int):
        lo, hi = self._range()
        if not lo <= int(idx) < hi:
            raise KeyError(
                f"id {idx} is owned by another host; use resolve(ids) "
                f"(a collective) to decode across hash ranges")
        return self.own_values[int(idx) - lo]

    def resolve(self, ids) -> "ResolvedDictionary":
        """Collective: the id -> string view of `ids` (every rank calls)."""
        ids = np.unique(np.asarray(ids, np.int64).reshape(-1))
        ids = ids[(ids >= 0) & (ids < len(self))]
        lo, hi = self._range()
        mine = ids[(ids >= lo) & (ids < hi)]
        mine_vals = self.own_values[mine - lo]
        if self.num_hosts == 1:
            all_ids, all_vals = [mine], [mine_vals]
        else:
            n = len(mine)
            top = int(self.mesh.pmax(torch.tensor(n, device=self.mesh.device)))
            pad = np.full(max(top, 1), -1, np.int64)
            pad[:n] = mine
            all_ids = [row[row >= 0] for row in _host_rows(self.mesh, pad)]
            all_vals = _allgather_str_arrays(self.mesh, mine_vals)
        mapping = {}
        for id_arr, val_arr in zip(all_ids, all_vals):
            mapping.update(zip(id_arr.tolist(), val_arr.tolist()))
        return ResolvedDictionary(mapping, len(self))

    def resolve_table(self, table, extra_ids=None) -> "ResolvedDictionary":
        """Collective: the view covering a CindTable's condition values (and
        `extra_ids`, e.g. mined association-rule values)."""
        cols = [np.asarray(c, np.int64) for c in
                (table.dep_v1, table.dep_v2, table.ref_v1, table.ref_v2)]
        if extra_ids is not None:
            cols.append(np.asarray(extra_ids, np.int64).reshape(-1))
        return self.resolve(np.concatenate(cols))


@dataclasses.dataclass
class ResolvedDictionary:
    """Materialized id -> string view over a (small) id subset."""

    mapping: dict
    size: int

    def __len__(self) -> int:
        return self.size

    def value(self, idx: int):
        return self.mapping[int(idx)]


def partitioned_intern(mesh, local_values):
    """Agree on global ids without replicating the dictionary.

    local_values: this host's sorted distinct values (object array).  Returns
    (global ids aligned with local_values (int64), PartitionedDictionary).

    One owner round per host: the hosts gather the values hashing to the
    round's owner (non-owners drop them at once), the owner dedupes its range
    and shares it back, and every host ranks its own requests by
    searchsorted.  A counts gather then fixes the range offsets: global id =
    offset + rank.
    """
    num_hosts, host_index = mesh.num_hosts, mesh.host_index
    local_values = np.asarray(local_values, object)
    owner = _value_owner(local_values, num_hosts)
    ranks = np.zeros(len(local_values), np.int64)
    own_values = np.zeros(0, object)
    for g in range(num_hosts):
        sel = np.flatnonzero(owner == g)
        req = local_values[sel]  # sorted and distinct (a subset of sorted)
        all_req = _allgather_str_arrays(mesh, req)
        if host_index == g:
            own_values = (np.unique(np.concatenate(all_req))
                          if sum(len(a) for a in all_req)
                          else np.zeros(0, object))
        del all_req
        range_vals = _allgather_str_arrays(
            mesh, own_values if host_index == g else np.zeros(0, object))[g]
        ranks[sel] = np.searchsorted(range_vals, req)
        del range_vals
    counts = _host_rows(mesh, np.asarray([len(own_values)],
                                         np.int64)).reshape(-1)
    offsets = np.zeros(num_hosts + 1, np.int64)
    np.cumsum(counts, out=offsets[1:])
    return ranks + offsets[owner], PartitionedDictionary(
        offsets=offsets, own_values=own_values, host_index=host_index,
        num_hosts=num_hosts, mesh=mesh)


def sharded_ingest(paths: list[str], mesh, *, tabs: bool = False,
                   expect_quad: bool = False, encoding="utf-8",
                   use_native: bool = True,
                   partition_dictionary: bool | None = None,
                   transform=None, cache=None, cache_fp: str = "",
                   cache_hit=None, stats: dict | None = None):
    """Multi-host ingest over `mesh`.

    Returns (block, n_valid, dictionary, total_triples): `block` is this
    rank's (t_loc, 3) int32 row block on its device (its host's rows,
    contiguous per local rank), `n_valid` its valid row count, `dictionary`
    a PartitionedDictionary (several hosts, by default) or the replicated
    Dictionary (``partition_dictionary=False``, or one host).

    `cache` (a checkpoint.CheckpointStore) keeps this host's local parse
    under `cache_fp` (written by the host's local rank 0); the interning
    exchange re-runs on resume (its collectives need every host).
    `cache_hit`, when a list, receives this rank's True/False.
    """
    from ..models.sharded import T_LOC_FLOOR, _shard_triples
    from ..ops import segments

    num_hosts, host_index = mesh.num_hosts, mesh.host_index
    my_paths = shard_paths(paths, num_hosts, host_index)
    local_ids = None
    stage = f"ingest-host{host_index}"
    if cache is not None:
        from . import checkpoint
        stored = cache.load(stage, cache_fp)
        if stored is not None:
            local_ids, local_dict = checkpoint.decode_ingest(stored)
        if cache_hit is not None:
            cache_hit.append(stored is not None)
    if local_ids is None:
        ingest_stats: dict = {}
        local_ids, local_dict = _local_ingest(
            my_paths, tabs, expect_quad, encoding, use_native,
            transform=transform, stats=ingest_stats)
        if stats is not None and ingest_stats:
            metrics.struct_set(stats, "ingest", ingest_stats)
        if cache is not None and mesh.host_primary:
            from . import checkpoint
            cache.save(stage, cache_fp,
                       checkpoint.encode_ingest(local_ids, local_dict))

    if partition_dictionary is None:
        partition_dictionary = num_hosts > 1
    if partition_dictionary and num_hosts > 1:
        gids, dictionary = partitioned_intern(mesh, local_dict.values)
        if len(local_dict):
            local_ids = gids.astype(np.int32)[local_ids]
    else:
        global_values = _allgather_values(mesh, local_dict.values)
        dictionary = Dictionary(global_values)
        if len(local_dict):
            remap = np.searchsorted(global_values, local_dict.values).astype(
                np.int32)
            local_ids = remap[local_ids]

    # The host's rows split contiguously over its ranks; t_loc is agreed
    # from the largest host (any split is correct: exchange A re-routes
    # every row by its join value).
    counts = _host_rows(mesh, np.asarray([local_ids.shape[0]],
                                         np.int64)).reshape(-1)
    dev_local = mesh.local_size
    t_loc = max(T_LOC_FLOOR,
                segments.pow2_capacity(-(-int(counts.max()) // dev_local)))
    host_block, n_valid_local, _ = _shard_triples(local_ids, dev_local,
                                                  t_loc=t_loc)
    r = mesh.local_rank
    block = torch.as_tensor(np.ascontiguousarray(
        host_block[r * t_loc:(r + 1) * t_loc])).to(mesh.device)
    return block, int(n_valid_local[r]), dictionary, int(counts.sum())
