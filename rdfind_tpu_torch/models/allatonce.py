"""AllAtOnce traversal strategy (strategy 0) on a single device.

One pass over the data: emit join candidates, group them into join lines, and read
every CIND off the co-occurrence counts, by one of two pair backends:

  dense ("matmul") — build the 0/1 membership matrix as Mᵀ (captures x lines, the
      K-major layout of kernel K1) and sweep cooc = Mᵀ M with the fused kernel
      (ops/cooc.py, K1).  Captures with fewer than min_support lines are dead
      rows of Mᵀ that can never pass the CIND test;
  chunked — greedily pack whole join lines into chunks of at most
      ``pair_chunk_budget`` ordered pairs, emit each chunk's pairs on the device
      (ops/pairs.py), sort and count them there, pull the chunk's distinct
      (dep, ref, count) rows, and merge all chunks' rows on the device before
      the CIND test.  It bounds device memory by the budget, where the dense
      plan's Mᵀ would not fit.

"auto" runs the dense backend when Mᵀ fits the device budget and the chunked one
otherwise.  The frequent-condition prefilter runs at emission.  Shapes are exact
at every stage (PyTorch runs eagerly); the chunk stage keeps fixed shapes, so a
chunk queues on the device with no host sync, and the loop pulls each chunk while
the next one computes.
"""

from __future__ import annotations

import numpy as np
import torch
from torch.profiler import record_function

from .. import devices
from ..data import CindTable
from ..obs import integrity, metrics
from .. import conditions as cc
from ..ops import cooc, frequency, minimality, pairs, segments
from ..ops.emission import emit_join_candidates

# Ordered pairs one chunk of the chunked backend materializes at most (the JAX
# package's budget); a line with more pairs is a chunk of its own.
PAIR_CHUNK_BUDGET = 1 << 22
PAIR_BACKENDS = ("auto", "matmul", "chunked")
# Sort key of an invalid pair slot: after every (dep << 32) | ref key.
_KEY_SENTINEL = torch.iinfo(torch.int64).max


def check_pair_backend(pair_backend: str) -> None:
    if pair_backend not in PAIR_BACKENDS:
        raise ValueError(f"unknown pair_backend {pair_backend!r} (one of "
                         f"{', '.join(PAIR_BACKENDS)})")


def _emit_and_intern(triples, min_support: int, *, projections: str,
                     use_fc_filter: bool, use_ars: bool):
    """Frequent-condition filter + join-candidate emission + capture interning.

    Returns (cands, cap_cols, cap_id, num_caps): the candidate rows, the capture
    table columns (code, v1, v2) with exactly num_caps rows in ascending order,
    and each candidate row's capture id (-1 on invalid rows).
    """
    n = triples.shape[0]
    freq = (frequency.triple_frequencies(triples, min_support,
                                         find_ar_implied=use_ars)
            if use_fc_filter else frequency.no_filter(n, triples.device))
    cands = emit_join_candidates(triples, freq, projections)
    cap_cols, cap_id, num_caps = segments.masked_unique(
        [cands.code, cands.v1, cands.v2], cands.valid)
    return cands, cap_cols, cap_id, num_caps


def _stage_prepare(triples, min_support: int, *, projections: str,
                   use_fc_filter: bool, use_ars: bool = False):
    """Candidate emission + capture interning + dense line ids.

    triples: (N, 3) int32 tensor.  Returns (line_gid, cap_id, valid, n_lines,
    cap_code, cap_v1, cap_v2, num_caps): the first three per candidate row (ids
    are -1 on invalid rows), the capture table columns with exactly num_caps
    rows in ascending (code, v1, v2) order.
    """
    cands, cap_cols, cap_id, num_caps = _emit_and_intern(
        triples, min_support, projections=projections,
        use_fc_filter=use_fc_filter, use_ars=use_ars)
    line_gid, n_lines = segments.masked_dense_ids(cands.join_val, cands.valid)
    return (line_gid, cap_id, cands.valid, n_lines,
            cap_cols[0], cap_cols[1], cap_cols[2], num_caps)


def _stage_candidates(triples, min_support: int, *, projections: str,
                      use_fc_filter: bool, use_ars: bool = False):
    """Triples -> distinct join-line rows sorted by (value, capture) + capture
    table.  Returns (line_val, line_cap, cap_code, cap_v1, cap_v2, num_caps)."""
    cands, cap_cols, cap_id, num_caps = _emit_and_intern(
        triples, min_support, projections=projections,
        use_fc_filter=use_fc_filter, use_ars=use_ars)
    line_cols, _, _ = segments.masked_unique([cands.join_val, cap_id],
                                             cands.valid)
    return (line_cols[0], line_cols[1], cap_cols[0], cap_cols[1],
            cap_cols[2], num_caps)


def _stage_capture_filter(line_val, line_cap, num_caps: int,
                          min_support: int):
    """Exact capture support + frequent-capture pruning.

    dep_count[c] = distinct join values containing capture c (its rows, since
    rows are distinct).  Keeps the rows of frequent captures, in order.
    Returns (line_val, line_cap, dep_count).
    """
    dep_count = torch.bincount(line_cap, minlength=num_caps)
    keep = dep_count[line_cap] >= min_support
    return line_val[keep], line_cap[keep], dep_count


def prepare_join_lines(triples, min_support: int, projections: str,
                       use_frequent_condition_filter: bool, use_ars: bool,
                       stats) -> dict | None:
    """Phase A of the approximate strategies: join-line rows + capture table.

    triples: (N, 3) int32 tensor on the run's device.  Returns None when the
    plan is trivially empty, else the host dict of state.HOST_FIELDS: the
    (value, capture)-sorted frequent join-line rows ``line_val_h`` /
    ``line_cap_h``, the capture table ``cap_code/cap_v1/cap_v2``, per-capture
    exact supports ``dep_count`` (int64 numpy arrays) and ``num_caps``.
    """
    n = triples.shape[0]
    if n == 0 or not any(ch in projections for ch in "spo"):
        return None
    line_val, line_cap, code, v1, v2, num_caps = _stage_candidates(
        triples, min_support, projections=projections,
        use_fc_filter=use_frequent_condition_filter, use_ars=use_ars)
    n_rows = line_val.shape[0]
    if n_rows == 0:
        return None
    line_val, line_cap, dep_count = _stage_capture_filter(
        line_val, line_cap, num_caps, min_support)
    n_keep = line_val.shape[0]
    if n_keep == 0 or num_caps == 0:
        return None

    def host(t):
        return t.cpu().numpy().astype(np.int64)

    state = dict(line_val_h=host(line_val), line_cap_h=host(line_cap),
                 cap_code=host(code), cap_v1=host(v1), cap_v2=host(v2),
                 dep_count=host(dep_count), num_caps=num_caps)
    metrics.set_many(stats, n_triples=n, n_line_rows=n_rows,
                     n_frequent_rows=n_keep, n_captures=num_caps,
                     total_pairs=0)
    return state


def _stage_membership(line_gid, cap_id, valid, min_support: int, *,
                      l_pad: int, c_pad: int):
    """Membership matrix Mᵀ (captures x lines) + the aggregates that fall out
    of it.

    Returns (m_t, dep_count, lens): dep_count[c] = distinct join values
    containing capture c (row sums of Mᵀ); lens[l] = frequent captures in line l
    (column sums over the frequent rows).
    """
    m_t = cooc.build_membership(line_gid, cap_id, valid, l_pad=l_pad,
                                c_pad=c_pad)
    dep_count = m_t.sum(dim=1, dtype=torch.int32)
    freq_mask = (dep_count >= min_support).to(torch.int8)
    lens = (m_t * freq_mask[:, None]).sum(dim=0, dtype=torch.int32)
    return m_t, dep_count, lens


def _fit(arr, length: int):
    """Slice-or-zero-pad a 1-D tensor to `length`."""
    if arr.shape[0] >= length:
        return arr[:length]
    return torch.nn.functional.pad(arr, (0, length - arr.shape[0]))


def triples_on(triples, device) -> torch.Tensor:
    """An (N, 3) numpy array or tensor of id triples as int32 on `device`."""
    if not isinstance(triples, torch.Tensor):
        triples = torch.as_tensor(np.asarray(triples, np.int32))
    return triples.to(device=device, dtype=torch.int32)


def filter_ar_implied_cinds(table: CindTable, mined_rules) -> CindTable:
    """Drop 1/1 CIND pairs that restate a perfect-confidence association rule
    (dep = antecedent capture, ref = consequent capture, shared projection)."""
    if len(table) == 0:
        return table
    return table.select(~frequency.ar_implied_pair_mask(
        table.dep_code, table.ref_code, table.dep_v1, table.ref_v1,
        mined_rules))


def _discover_dense(triples, min_support: int, projections: str,
                    use_fc_filter: bool, use_ars: bool, clean_implied: bool,
                    stats) -> CindTable | None:
    """The dense backend; None when Mᵀ does not fit the device budget."""
    # Each stage is a named profiler range ("rdfind.<stage>"): a few
    # microseconds when no profiler runs, the per-stage breakdown when one does.
    with record_function("rdfind.prepare"):
        (line_gid, cap_id, cand_valid, n_lines, cap_code, cap_v1, cap_v2,
         num_caps) = _stage_prepare(triples, min_support,
                                    projections=projections,
                                    use_fc_filter=use_fc_filter,
                                    use_ars=use_ars)
    n = triples.shape[0]
    if n_lines == 0 or num_caps == 0:
        return CindTable.empty()
    plan = cooc.dense_plan(n_lines, num_caps, triples.device)
    if plan is None:
        return None
    metrics.struct_set(stats, "dense_plan", plan.describe())
    metrics.gauge_set(stats, "cooc_dtype", plan.dtype)

    with record_function("rdfind.membership"):
        m_t, dep_count, lens = _stage_membership(
            line_gid, cap_id, cand_valid, min_support, l_pad=plan.l_pad,
            c_pad=plan.c_pad)
    with record_function("rdfind.sweep"):
        dep_id, ref_id, support = cooc.discover_pairs_dense(
            m_t, dep_count, _fit(cap_code, plan.c_pad),
            _fit(cap_v1, plan.c_pad), _fit(cap_v2, plan.c_pad), min_support,
            plan, stats=stats)
    del m_t
    lens_h = lens[:n_lines].cpu().numpy().astype(np.int64)
    code_h, v1_h, v2_h = (c.cpu().numpy() for c in (cap_code, cap_v1, cap_v2))
    dep_count_h = dep_count[:num_caps].cpu().numpy().astype(np.int64)

    # Stat semantics of the JAX package's dense path: n_lines counts lines that
    # kept >= 1 frequent capture, n_line_rows the distinct (value, capture) rows.
    metrics.set_many(
        stats, n_triples=n, n_frequent_rows=int(lens_h.sum()),
        n_line_rows=int(dep_count_h.sum()),
        n_lines=int((lens_h > 0).sum()), n_captures=num_caps,
        total_pairs=int((lens_h * (lens_h - 1)).sum()),
        max_line=int(lens_h.max()), pair_backend="matmul")
    if dep_id.size == 0:
        return CindTable.empty()
    table = CindTable(
        dep_code=code_h[dep_id].astype(np.int64),
        dep_v1=v1_h[dep_id].astype(np.int64),
        dep_v2=v2_h[dep_id].astype(np.int64),
        ref_code=code_h[ref_id].astype(np.int64),
        ref_v1=v1_h[ref_id].astype(np.int64),
        ref_v2=v2_h[ref_id].astype(np.int64),
        support=support.astype(np.int64),
    )
    with record_function("rdfind.postprocess"):
        return _postprocess(table, triples, min_support, use_ars,
                            clean_implied, stats)


def _chunk_boundaries(pairs_per_line: np.ndarray, budget: int) -> list[int]:
    """Greedy packing of whole lines into chunks of <= budget pairs each.

    Returns line-index boundaries [0, ..., num_lines]; a single line over budget
    gets its own chunk.
    """
    bounds = [0]
    acc = 0
    for i, p in enumerate(pairs_per_line):
        if acc > 0 and acc + p > budget:
            bounds.append(i)
            acc = 0
        acc += int(p)
    bounds.append(len(pairs_per_line))
    return bounds


def _stage_pair_counts(line_cap, pos, length, start_idx, *, capacity: int,
                       dep_f=None, ref_f=None, balanced: bool = False):
    """One chunk: emit its pairs, sort and count them.  Fixed shapes, so the
    chunk queues on the device with no host sync.

    Rows are the chunk's (line-sorted) rows: capture ids, position in line, line
    length and line start (chunk-local).  With `dep_f` / `ref_f` (bool per row)
    a pair survives only when its dependent row is dep-flagged and its partner
    ref-flagged; unflagged dependent rows take no slot (``emit``), so
    `capacity` counts the slots of dep-flagged rows only.  balanced=True emits
    each unordered pair once (every row flagged on both sides).

    Returns (key, cnt, n_out): the distinct (dep << 32) | ref keys ascending in
    key[:n_out], their counts in cnt[:n_out], n_out a 0-d tensor.
    """
    dev = line_cap.device
    emit = None if balanced else dep_f
    row, partner, valid = pairs.emit_pair_indices(
        pos, length, start_idx, capacity, balanced=balanced, emit=emit)
    if balanced and dep_f is not None:
        valid &= dep_f[row]
    if ref_f is not None:
        valid &= ref_f[partner]
    cap = line_cap.to(torch.int64)
    key = torch.where(valid, (cap[row] << 32) | cap[partner], _KEY_SENTINEL)
    key = torch.sort(key).values
    real = key != _KEY_SENTINEL  # a prefix of the sorted slots
    starts = real.clone()
    starts[1:] &= key[1:] != key[:-1]
    gid = torch.cumsum(starts, 0) - 1
    n_out = starts.sum()
    # Compact the run starts to the front (slot capacity + 1 takes the other
    # rows and is never read).  A run's count is the gap to the next run's
    # first slot; `first` is pre-filled with the number of real slots, where
    # the last run ends.
    target = torch.where(starts, gid, capacity + 1)
    out_key = torch.full((capacity + 2,), _KEY_SENTINEL, dtype=torch.int64,
                         device=dev).scatter_(0, target, key)
    first = real.sum().expand(capacity + 2).clone().scatter_(
        0, target, torch.arange(capacity, device=dev))
    cnt = (first[1:capacity + 1] - first[:capacity]).to(torch.int32)
    return out_key[:capacity], cnt, n_out


def _stage_to_host(chunk):
    """Start a chunk's device-to-host copy: non-blocking into pinned host
    buffers, fenced by a CUDA event.  CPU chunks pass through."""
    key, cnt, n_out = chunk
    if key.device.type != "cuda":
        return chunk, None
    host = tuple(torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
                 for t in chunk)
    for h, t in zip(host, chunk):
        h.copy_(t, non_blocking=True)
    done = torch.cuda.Event()
    done.record()
    return host, done


def _pull_chunk(staged):
    """Wait for a staged chunk's copy (the loop's one host sync per chunk) and
    return its host (dep, ref, cnt) int64 arrays."""
    (key, cnt, n_out), done = staged
    if done is not None:
        done.synchronize()
    n = int(n_out)
    key = key[:n].numpy()
    return key >> 32, key & 0xFFFFFFFF, cnt[:n].numpy().astype(np.int64)


def line_runs(line_val_h):
    """(first row, length) int64 arrays of the runs of equal join values."""
    n = line_val_h.shape[0]
    starts = np.empty(n, bool)
    starts[:1] = True
    starts[1:] = line_val_h[1:] != line_val_h[:-1]
    first = np.flatnonzero(starts)
    return first, np.diff(np.append(first, n)).astype(np.int64)


def iter_chunk_pairs(line_val_h, line_cap_h, budget: int, device, *,
                     dep_f_h=None, ref_f_h=None, balanced: bool = False,
                     stats=None):
    """Yield each chunk's (dep, ref, cnt) host int64 arrays: the distinct
    flagged co-occurrence pairs of its lines and their counts.

    line_val_h / line_cap_h: host join-line rows sorted by (value, capture).
    Whole lines are packed into chunks of <= `budget` pairs of the full lines
    (halved when balanced), as the JAX package packs them.  Every row array
    reaches the device in one copy before the loop; then chunk i + 1 is queued
    on the device before chunk i is pulled, so the host's work on chunk i
    overlaps the device's on chunk i + 1; the pull of a chunk is the loop's
    only host sync.  ``n_pair_chunks`` counts chunks.
    """
    n = line_val_h.shape[0]
    first, lens = line_runs(line_val_h)
    pairs_per_line = lens * (lens - 1)
    if balanced:
        pairs_per_line //= 2  # each unordered pair once
    start_h = np.repeat(first, lens)
    pos_h = np.arange(n, dtype=np.int64) - start_h
    len_h = np.repeat(lens, lens)
    if balanced:
        slots_h = ((len_h - 1) // 2
                   + ((len_h % 2 == 0) & (pos_h < len_h // 2)))
    else:
        slots_h = np.where(dep_f_h, len_h - 1, 0) if dep_f_h is not None \
            else len_h - 1
    cum_slots = np.concatenate([[0], np.cumsum(slots_h)])

    def dev(a):
        # Through pinned memory, so the copy queues without a host sync.
        if a is None:
            return None
        t = torch.as_tensor(a)
        if torch.device(device).type == "cuda":
            return t.pin_memory().to(device, non_blocking=True)
        return t

    cap_d, pos_d, len_d, start_d, dep_d, ref_d = (
        dev(a) for a in (line_cap_h, pos_h, len_h, start_h, dep_f_h, ref_f_h))
    bounds = _chunk_boundaries(pairs_per_line, budget)
    row_of = np.append(first, n)
    pend = None
    for lo_line, hi_line in zip(bounds[:-1], bounds[1:]):
        rs, re = int(row_of[lo_line]), int(row_of[hi_line])
        capacity = int(cum_slots[re] - cum_slots[rs])
        if capacity == 0:
            continue
        metrics.counter_add(stats, "n_pair_chunks")
        sl = slice(rs, re)
        with record_function("rdfind.chunk"):
            staged = _stage_to_host(_stage_pair_counts(
                cap_d[sl], pos_d[sl], len_d[sl], start_d[sl] - rs,
                capacity=capacity,
                dep_f=None if dep_d is None else dep_d[sl],
                ref_f=None if ref_d is None else ref_d[sl],
                balanced=balanced))
        if pend is not None:
            yield _pull_chunk(pend)
        pend = staged
    if pend is not None:
        yield _pull_chunk(pend)


def _stage_merge(dep, ref, cnt, min_support: int, dep_count, cap_code, cap_v1,
                 cap_v2):
    """Merge the chunks' pair counts, apply the CIND test, drop trivially
    implied pairs.  Device tensors in; (dep_id, ref_id, support) device int64
    tensors out, in (dep, ref) order.

    The implied rule keeps the equal-code quirk of the reference's
    Condition.isImpliedBy: a ref whose code equals the dep's is implied when
    its v1 matches the dep's first-subcapture value.
    """
    key, inv = torch.unique((dep << 32) | ref, return_inverse=True)
    cooc_cnt = torch.zeros(key.shape[0], dtype=torch.int64,
                           device=key.device).index_add_(0, inv, cnt)
    d, r = key >> 32, key & 0xFFFFFFFF
    support = dep_count[d]
    is_cind = (cooc_cnt == support) & (support >= min_support)
    d_code, r_code = cap_code[d], cap_code[r]
    implied = cc.is_subcode(r_code, d_code) & torch.where(
        cc.first_subcapture(d_code) == r_code, cap_v1[r] == cap_v1[d],
        cap_v1[r] == cap_v2[d])
    keep = is_cind & ~implied
    return d[keep], r[keep], support[keep]


def _discover_chunked(triples, min_support: int, projections: str,
                      use_fc_filter: bool, use_ars: bool, clean_implied: bool,
                      pair_chunk_budget: int, stats) -> CindTable:
    """The chunked backend: phase A's join lines, the chunk loop, one merge."""
    with record_function("rdfind.prepare"):
        st = prepare_join_lines(triples, min_support, projections,
                                use_fc_filter, use_ars, stats)
    if st is None:
        return CindTable.empty()
    _, lens = line_runs(st["line_val_h"])
    total = int((lens * (lens - 1)).sum())
    metrics.set_many(stats, n_lines=int(lens.size), total_pairs=total,
                     max_line=int(lens.max()))
    if total == 0:
        return CindTable.empty()
    metrics.gauge_set(stats, "pair_backend", "chunked")
    dev = triples.device
    with record_function("rdfind.chunks"):
        parts = list(iter_chunk_pairs(st["line_val_h"], st["line_cap_h"],
                                      pair_chunk_budget, dev, stats=stats))
    if not any(p[0].size for p in parts):
        return CindTable.empty()
    with record_function("rdfind.merge"):
        cat = [torch.as_tensor(np.concatenate([p[k] for p in parts])).to(dev)
               for k in range(3)]

        def col(name):
            return torch.as_tensor(st[name]).to(dev)

        d, r, sup = (t.cpu().numpy() for t in _stage_merge(
            *cat, min_support, col("dep_count"), col("cap_code"),
            col("cap_v1"), col("cap_v2")))
    if d.size == 0:
        return CindTable.empty()
    code, v1, v2 = st["cap_code"], st["cap_v1"], st["cap_v2"]
    table = CindTable(dep_code=code[d], dep_v1=v1[d], dep_v2=v2[d],
                      ref_code=code[r], ref_v1=v1[r], ref_v2=v2[r],
                      support=sup)
    with record_function("rdfind.postprocess"):
        return _postprocess(table, triples, min_support, use_ars,
                            clean_implied, stats)


def _postprocess(table, triples, min_support, use_ars, clean_implied, stats):
    if use_ars:
        rules = frequency.mine_association_rules(triples, min_support)
        metrics.struct_set(stats, "association_rules", rules)
        table = filter_ar_implied_cinds(table, rules)
    if clean_implied:
        table = minimality.minimize_table(table, triples.device)
    integrity.publish_output(stats, table)
    return table


def discover(triples, min_support: int, projections: str = "spo",
             use_frequent_condition_filter: bool = True,
             use_association_rules: bool = False,
             clean_implied: bool = False,
             pair_chunk_budget: int = PAIR_CHUNK_BUDGET,
             pair_backend: str = "auto",
             stats: dict | None = None,
             device=None) -> CindTable:
    """Discover all CINDs in an (N, 3) int32 triple-id table.

    ``triples`` is a numpy array or a tensor; it moves to ``device`` (CUDA unless
    the caller passes "cpu").  ``pair_backend`` "matmul" runs the dense sweep
    and raises ValueError when Mᵀ does not fit the device budget, "chunked" the
    chunk loop (at most ``pair_chunk_budget`` pairs per chunk), "auto" the dense
    sweep when it fits and the chunk loop otherwise.  If ``stats`` is a dict it
    is filled with pipeline statistics.
    """
    check_pair_backend(pair_backend)
    triples = triples_on(triples, devices.resolve(device))
    if triples.shape[0] == 0 or not any(ch in projections for ch in "spo"):
        return CindTable.empty()
    min_support = max(int(min_support), 1)
    use_ars = use_association_rules and use_frequent_condition_filter
    if pair_backend != "chunked":
        # Whether the dense plan fits is known only after candidate prep, so
        # a fallback pays emission and interning twice.
        table = _discover_dense(triples, min_support, projections,
                                use_frequent_condition_filter, use_ars,
                                clean_implied, stats)
        if table is not None:
            return table
        if pair_backend == "matmul":
            raise ValueError("pair_backend='matmul' but the membership "
                             "matrix does not fit the device budget")
    return _discover_chunked(triples, min_support, projections,
                             use_frequent_condition_filter, use_ars,
                             clean_implied, pair_chunk_budget, stats)
