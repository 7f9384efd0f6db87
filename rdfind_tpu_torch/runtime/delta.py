"""Delta discovery: incremental CIND maintenance in time ~ the change.

Every prior run was a full batch job — one inserted or deleted triple cost a
complete re-discovery.  The RDFind evidence formulation is naturally
incremental: a join line is keyed by a join VALUE, so a changed triple
perturbs exactly the lines keyed by its projected values and no others.  A
capture's refset (intersection over its lines) and support (its line count)
can only change when one of ITS lines changed, which gives the exact
invalidation law this module runs on:

  changed triples -> dirty join values -> dirty lines -> affected captures
  (the captures on the old/new rows of those lines, nothing else).

Every output row whose dependent capture is unaffected is retained verbatim;
only the affected dependents are re-intersected, over their own lines only.
The merged set is then shaped exactly like a batch run shapes it (strategy
raw filter, optional minimality pass), so the result is bit-identical to a
from-scratch run on the updated dataset — that equality is the whole
contract, proven by scripts/delta_parity.py and tests/test_delta.py across
all four strategies.

The persisted base-run state bundle (``--delta-state DIR``) reuses the
checkpoint idiom (CheckpointStore: fsynced atomic npz + fingerprints) with
four stages:

  delta-meta      JSON header: format, knobs, generation, digests
  delta-ingest    interned triple ids + the value dictionary (internal order)
  delta-evidence  join-line/capture rows (jv, code, v1, v2), bucket-major
  delta-cinds     the full definitional CIND set (internal ids)

Internal ids are append-only across generations (base values in sorted
order, later values appended unsorted), so stored rows never need a remap;
the canonical ids a run reports (rank among present values) are derived at
emission time.  Rows are laid out bucket-major under the SAME
``hashing.bucket_of`` law the sharded exchange and the elastic-resume
replica pin (ops/hashing.host_bucket_of), grouped into passes that carry the
order-invariant two-lane integrity digests.  Because those lanes are plain
mod-2^32 sums of per-row mixes, the per-pass digests are maintained
incrementally — subtract the removed rows' mixes, add the inserted rows' —
in O(change), and re-verified on load (``RDFIND_DELTA_VERIFY``).

Degradation ladder (never a wrong incremental answer):

  * meta or ingest stage missing/stale/corrupt -> DeltaBaseError (clean miss;
    the CLI names it and exits 66 so callers re-run a full build);
  * evidence stage corrupt -> named degradation, rows rebuilt host-side from
    the bundled triples (exact);
  * cinds stage corrupt, effective --use-ars, or a change batch dirtying
    more than RDFIND_DELTA_FULL_FRAC of the evidence -> named degradation,
    full re-discovery over the updated bundle (~= batch-run cost, never
    worse; the bundle still advances a generation).

The delta run's integrity certificate chains onto the base run's
(``base_output_digest`` -> new ``output_digest``), and everything fans out
through the existing obs shims: ``stats["delta"]`` (dirty lines/captures,
passes reused vs re-run, speedup), trace spans per stage, Prometheus leaves,
the /progress console, and the heartbeat mode/generation tpu_watch shows.

The JAX package's ``runtime/delta.py``, ported.  Everything here is host numpy
and the same algorithm; the bundle's stages, fingerprints and digests are the
JAX package's, so either package continues a bundle the other wrote.  The
device work is discovery itself (the base run's full definitional set and the
full fallback), which runs on the run's device through the port's strategies.
"""

from __future__ import annotations

import json
import os
import sys
import time

import numpy as np

from .. import conditions as cc
from .. import oracle
from ..data import NO_VALUE, CindTable
from ..dictionary import Dictionary
from ..io import native, ntriples, prefixes, reader
from ..obs import integrity, metrics, tracer
from ..ops import hashing
from . import checkpoint, serving

DELTA_FORMAT = 1

# Bucket-routing seed for the delta evidence layout.  Shares the
# ops/hashing mixer with every other routing/digest seed in the system, so
# it must stay clear of all of them (sharded.py registry: 1, 2, 5, 7, 11,
# 17, 23, 31, 101+, 401+, 404+, 419, 433; integrity lanes: 29, 43).
DELTA_SEED = 57

_STAGE_META = "delta-meta"
_STAGE_INGEST = "delta-ingest"
_STAGE_EVIDENCE = "delta-evidence"
_STAGE_CINDS = "delta-cinds"

_FIELD_BITS = (cc.SUBJECT, cc.PREDICATE, cc.OBJECT)

# Pair-expansion budget for the refset re-intersection (rows per numpy
# chunk); bounds peak memory, never results.
_PAIR_BUDGET = 1 << 22


class DeltaBaseError(RuntimeError):
    """The base bundle cannot be trusted (missing, stale, or corrupt in a
    stage that has no host-side rebuild).  A clean miss: the caller must
    re-run a full build with --delta-state, never patch around it."""


def _env_int(name: str, default: int) -> int:
    try:
        return int(os.environ.get(name, "") or default)
    except ValueError:
        return default


def _env_float(name: str, default: float) -> float:
    try:
        return float(os.environ.get(name, "") or default)
    except ValueError:
        return default


def num_buckets() -> int:
    """RDFIND_DELTA_BUCKETS: evidence-layout buckets (bundle creation only;
    delta runs read the value pinned in the bundle meta)."""
    return max(1, _env_int("RDFIND_DELTA_BUCKETS", 8192))


def n_passes() -> int:
    """RDFIND_DELTA_PASSES: digest/reuse-accounting granules (pinned in the
    bundle meta like the bucket count)."""
    return max(1, min(num_buckets(), _env_int("RDFIND_DELTA_PASSES", 1024)))


def verify_on_load() -> bool:
    """RDFIND_DELTA_VERIFY=0 skips the load-time digest re-verification."""
    return os.environ.get("RDFIND_DELTA_VERIFY", "").strip() != "0"


def full_frac() -> float:
    """RDFIND_DELTA_FULL_FRAC: dirty-evidence fraction above which the delta
    degrades to a full re-discovery (the crossover where incremental
    recompute stops being cheaper than the batch pipeline)."""
    return _env_float("RDFIND_DELTA_FULL_FRAC", 0.3)


# ---------------------------------------------------------------------------
# Evidence rows: (jv, code, v1, v2) int64, one row per (join line, capture).
# Exactly oracle.discover_cinds_joinline's UNFILTERED emission, vectorized —
# the frequency filters are output-neutral pruning, so the bundle stores the
# definitional evidence and serves any filter setting.
# ---------------------------------------------------------------------------


def _proj_parts(t: np.ndarray, proj_bit: int) -> list[np.ndarray]:
    """One projection's three capture emissions for the given triples."""
    pi = cc.FIELD_INDEX[proj_bit]
    a, b = [i for i in range(3) if i != pi]
    bit_a, bit_b = _FIELD_BITS[a], _FIELD_BITS[b]
    jv = t[:, pi].astype(np.int64)
    n = t.shape[0]
    out = []
    emits = (
        (cc.create(bit_a, secondary_condition=proj_bit), t[:, a], None),
        (cc.create(bit_b, secondary_condition=proj_bit), t[:, b], None),
        (cc.create(bit_a, bit_b, proj_bit), t[:, a], t[:, b]),
    )
    for code, v1, v2 in emits:
        p = np.empty((n, 4), np.int64)
        p[:, 0] = jv
        p[:, 1] = code
        p[:, 2] = v1
        p[:, 3] = NO_VALUE if v2 is None else v2
        out.append(p)
    return out


def _emit_rows(ids: np.ndarray, projections: str,
               line_flag: np.ndarray | None = None,
               alive: np.ndarray | None = None) -> np.ndarray:
    """Deduped evidence rows; restricted to lines whose join value is
    flagged in `line_flag` (and to `alive` triples) when given."""
    ids = np.asarray(ids)
    parts = []
    for ch, proj_bit in zip("spo", _FIELD_BITS):
        if ch not in projections:
            continue
        t = ids
        m = None
        if alive is not None:
            m = alive.copy()
        if line_flag is not None:
            pm = line_flag[ids[:, cc.FIELD_INDEX[proj_bit]]]
            m = pm if m is None else (m & pm)
        if m is not None:
            t = ids[m]
        parts.extend(_proj_parts(t, proj_bit))
    if not parts:
        return np.zeros((0, 4), np.int64)
    rows = np.concatenate(parts)
    if rows.shape[0] == 0:
        return rows
    return np.unique(rows, axis=0)


# ---------------------------------------------------------------------------
# Bucket / pass layout + per-pass digests.
# ---------------------------------------------------------------------------


def _bucket_of_rows(rows: np.ndarray, n_buckets: int) -> np.ndarray:
    return hashing.host_bucket_of(
        [rows[:, 0].astype(np.uint32)], n_buckets, seed=DELTA_SEED)


def _pass_of_bucket(bucket: np.ndarray, n_buckets: int,
                    passes: int) -> np.ndarray:
    return (bucket.astype(np.int64) * passes // n_buckets).astype(np.int64)


def _pass_lane_sums(rows: np.ndarray, n_buckets: int,
                    passes: int) -> np.ndarray:
    """(passes, 2) uint64 lane sums — each pass's order-invariant digest."""
    out = np.zeros((passes, 2), np.uint64)
    if rows.shape[0] == 0:
        return out
    p = _pass_of_bucket(_bucket_of_rows(rows, n_buckets), n_buckets, passes)
    cols = [rows[:, i] for i in range(4)]
    for lane, seed in enumerate((integrity.SEED_A, integrity.SEED_B)):
        mix = integrity.row_mixes(cols, seed).astype(np.uint64)
        acc = np.zeros(passes, np.uint64)
        np.add.at(acc, p, mix)
        out[:, lane] = acc & np.uint64(integrity.MASK32)
    return out


def _lanes_to_hex(lanes: np.ndarray) -> list[str]:
    return [integrity.digest_hex(int(a), int(b)) for a, b in lanes]


def _hex_to_lanes(digests: list[str]) -> np.ndarray:
    out = np.zeros((len(digests), 2), np.uint64)
    for i, h in enumerate(digests):
        out[i, 0] = int(h[:8], 16)
        out[i, 1] = int(h[8:], 16)
    return out


def _update_pass_digests(old_hex: list[str], removed: np.ndarray,
                         added: np.ndarray, n_buckets: int) -> list[str]:
    """Incremental per-pass digest maintenance, O(change): the lanes are
    mod-2^32 sums of per-row mixes, so removed rows subtract and added rows
    add — the unchanged rows never enter the update."""
    passes = len(old_hex)
    lanes = _hex_to_lanes(old_hex).astype(np.int64)
    sub = _pass_lane_sums(removed, n_buckets, passes).astype(np.int64)
    add = _pass_lane_sums(added, n_buckets, passes).astype(np.int64)
    new = (lanes - sub + add) % np.int64(1 << 32)
    return _lanes_to_hex(new.astype(np.uint64))


def _blob_digest(blob: np.ndarray) -> str:
    """Position-dependent digest of a byte blob (the dictionary payload)."""
    n = blob.shape[0]
    pos = np.arange(n, dtype=np.int64)
    return integrity.digest_hex(*integrity.digest_rows([pos, blob]))


def _ids_digest(ids: np.ndarray) -> str:
    cols = [ids[:, i] for i in range(3)]
    return integrity.digest_hex(*integrity.digest_rows(cols))


def _full_digest(full: np.ndarray) -> str:
    cols = [full[:, i] for i in range(7)]
    return integrity.digest_hex(*integrity.digest_rows(cols))


# ---------------------------------------------------------------------------
# Bundle persistence.
# ---------------------------------------------------------------------------


class Bundle:
    """In-memory view of a loaded (or about-to-be-written) base bundle."""

    def __init__(self, meta, ids, values, rows, full, degraded):
        self.meta = meta          # decoded delta-meta JSON
        self.ids = ids            # (N, 3) int32, all rows alive on disk
        self.values = values      # (V,) object, internal-id order
        self.rows = rows          # (R, 4) int64 evidence rows (or None)
        self.full = full          # (F, 7) int64 definitional CINDs (or None)
        self.degraded = degraded  # list[str] named degradations so far


def _core_meta(min_support: int, projections: str, distinct: bool,
               buckets: int, passes: int) -> dict:
    return {"format": DELTA_FORMAT, "min_support": int(min_support),
            "projections": str(projections), "distinct": bool(distinct),
            "num_buckets": int(buckets), "n_passes": int(passes),
            "seed": DELTA_SEED}


def _meta_fp() -> str:
    return checkpoint.fingerprint({"delta_meta": DELTA_FORMAT})


def _data_fp(meta: dict) -> str:
    core = {k: meta[k] for k in ("format", "min_support", "projections",
                                 "distinct", "num_buckets", "n_passes",
                                 "seed")}
    return checkpoint.fingerprint({"delta_core": core,
                                   "generation": int(meta["generation"])})


def _encode_values(values: np.ndarray) -> dict:
    enc = [str(v).encode("utf-8") for v in values]
    offsets = np.zeros(len(enc) + 1, np.int64)
    np.cumsum([len(v) for v in enc], out=offsets[1:])
    return {"value_blob": np.frombuffer(b"".join(enc), np.uint8),
            "value_offsets": offsets}


def _decode_values(arrays: dict) -> np.ndarray:
    blob = arrays["value_blob"].tobytes()
    offs = arrays["value_offsets"]
    values = np.empty(len(offs) - 1, object)
    for i in range(len(offs) - 1):
        values[i] = blob[offs[i]:offs[i + 1]].decode("utf-8")
    return values


def save_bundle(base_dir: str, meta: dict, ids: np.ndarray,
                values: np.ndarray, rows: np.ndarray,
                full: np.ndarray) -> None:
    """Persist one generation.  `rows` must already be bucket-major sorted
    and `meta` must already carry the digests for exactly these arrays.
    delta-meta is written LAST: it is the commit point, and its embedded
    generation makes every data stage's fingerprint stale until it lands —
    a crash mid-write is a clean miss, never a torn bundle."""
    store = checkpoint.CheckpointStore(base_dir)
    fp = _data_fp(meta)
    store.save(_STAGE_INGEST, fp,
               {"ids": np.asarray(ids, np.int32), **_encode_values(values)})
    bucket = _bucket_of_rows(rows, int(meta["num_buckets"]))
    offsets = np.zeros(int(meta["num_buckets"]) + 1, np.int64)
    np.cumsum(np.bincount(bucket, minlength=int(meta["num_buckets"])),
              out=offsets[1:])
    store.save(_STAGE_EVIDENCE, fp,
               {"rows": np.asarray(rows, np.int64),
                "bucket_offsets": offsets})
    store.save(_STAGE_CINDS, fp, {"full": np.asarray(full, np.int64)})
    # The wall-clock commit stamp for the freshness plane: taken HERE, at
    # the meta write — the bundle's actual commit point — not when the
    # caller assembled the meta.  Mutates the caller's dict on purpose, so
    # downstream emit hooks see the committed time.
    meta["commit_unix"] = round(time.time(), 3)
    blob = json.dumps(meta, sort_keys=True).encode("utf-8")
    store.save(_STAGE_META, _meta_fp(),
               {"meta_json": np.frombuffer(blob, np.uint8)})


def _sort_rows(rows: np.ndarray, buckets: int) -> np.ndarray:
    """Bucket-major, then (jv, code, v1, v2) lex — the bundle's row order."""
    if rows.shape[0] == 0:
        return rows
    bucket = _bucket_of_rows(rows, buckets)
    order = np.lexsort((rows[:, 3], rows[:, 2], rows[:, 1], rows[:, 0],
                        bucket))
    return rows[order]


def load_bundle(base_dir: str, *, min_support: int, projections: str,
                distinct: bool, stats: dict | None = None) -> Bundle:
    """Load + verify a bundle; raises DeltaBaseError on an untrustable base,
    returns named degradations (rows/full = None) for rebuildable stages."""
    store = checkpoint.CheckpointStore(base_dir)
    m = store.load(_STAGE_META, _meta_fp())
    if m is None:
        raise DeltaBaseError(
            f"no usable delta bundle in {base_dir} "
            f"(delta-meta missing, stale, or corrupt)")
    try:
        meta = json.loads(m["meta_json"].tobytes().decode("utf-8"))
    except (ValueError, KeyError) as e:
        raise DeltaBaseError(f"delta-meta unreadable in {base_dir}: {e}")
    if meta.get("format") != DELTA_FORMAT:
        raise DeltaBaseError(
            f"delta bundle format {meta.get('format')} != {DELTA_FORMAT}")
    for knob, want in (("min_support", int(min_support)),
                       ("projections", str(projections)),
                       ("distinct", bool(distinct))):
        if meta.get(knob) != want:
            raise DeltaBaseError(
                f"base bundle was built with {knob}={meta.get(knob)!r}; "
                f"this run requests {want!r} — re-run a full build")
    try:
        fp = _data_fp(meta)
    except KeyError as e:
        raise DeltaBaseError(
            f"delta-meta in {base_dir} is missing field {e}")
    ing = store.load(_STAGE_INGEST, fp)
    if ing is None:
        raise DeltaBaseError(
            f"delta-ingest stage missing/stale/corrupt in {base_dir}")
    ids = np.asarray(ing["ids"], np.int32)
    values = _decode_values(ing)
    degraded: list[str] = []
    verify = verify_on_load()
    if verify:
        if _ids_digest(ids) != meta.get("ingest_digest") or \
                _blob_digest(ing["value_blob"]) != meta.get("dict_digest"):
            integrity.note_mismatch(stats, site="delta-load",
                                    stage=_STAGE_INGEST)
            raise DeltaBaseError(
                f"delta-ingest digest mismatch in {base_dir} "
                f"(silent corruption of the triple table or dictionary)")
    rows = full = None
    ev = store.load(_STAGE_EVIDENCE, fp)
    if ev is None:
        degraded.append("evidence-stage-missing")
    else:
        rows = np.asarray(ev["rows"], np.int64)
        if verify:
            got = _lanes_to_hex(_pass_lane_sums(
                rows, int(meta["num_buckets"]), int(meta["n_passes"])))
            if got != meta.get("pass_digests"):
                integrity.note_mismatch(stats, site="delta-load",
                                        stage=_STAGE_EVIDENCE)
                degraded.append("evidence-digest-mismatch")
                rows = None
    ci = store.load(_STAGE_CINDS, fp)
    if ci is None:
        degraded.append("cinds-stage-missing")
    else:
        full = np.asarray(ci["full"], np.int64).reshape(-1, 7)
        if verify and _full_digest(full) != meta.get("full_digest"):
            integrity.note_mismatch(stats, site="delta-load",
                                    stage=_STAGE_CINDS)
            degraded.append("cinds-digest-mismatch")
            full = None
    return Bundle(meta, ids, values, rows, full, degraded)


# ---------------------------------------------------------------------------
# Canonicalization: internal (append-only) ids -> the canonical ids a batch
# run reports (rank among the values actually present).
# ---------------------------------------------------------------------------


def _canonical_state(values: np.ndarray, ids: np.ndarray,
                     alive: np.ndarray | None):
    """(canon_of_internal, internal_of_canon, dictionary) for the live rows."""
    live = ids if alive is None else ids[alive]
    refc = np.bincount(live.reshape(-1).astype(np.int64),
                       minlength=len(values)) if live.size else \
        np.zeros(len(values), np.int64)
    present = np.flatnonzero(refc > 0)
    order = np.argsort(values[present], kind="stable")
    internal_of_canon = present[order]
    canon = np.full(len(values), -1, np.int64)
    canon[internal_of_canon] = np.arange(len(present))
    return canon, internal_of_canon, Dictionary(values[internal_of_canon])


def _remap_cind_cols(rows7: np.ndarray, vmap: np.ndarray) -> np.ndarray:
    """Apply an id map to the four value columns, NO_VALUE passing through."""
    out = np.asarray(rows7, np.int64).copy()
    for col in (1, 2, 4, 5):
        v = out[:, col]
        out[:, col] = np.where(v == NO_VALUE, NO_VALUE,
                               vmap[np.maximum(v, 0)])
    return out


# ---------------------------------------------------------------------------
# Output shaping: the full definitional set -> one strategy's raw output,
# or the minimal set.  Host mirrors of the device strategies' documented
# output contracts (tests/test_small_to_large.py, tests/test_late_bb.py).
# ---------------------------------------------------------------------------


def _dep_subcaptures(code: int, v1: int, v2: int):
    return ((int(cc.first_subcapture(code)), int(v1), NO_VALUE),
            (int(cc.second_subcapture(code)), int(v2), NO_VALUE))


def _filter_s2l(full: set) -> set:
    cind_pairs = {(c[0:3], c[3:6]) for c in full}
    c12_pairs = {(d, r) for d, r in cind_pairs
                 if cc.is_unary(d[0]) and cc.is_binary(r[0])}
    out = set()
    for c in full:
        dep, ref = c[0:3], c[3:6]
        if not cc.is_binary(dep[0]):
            out.add(c)
        elif not cc.is_binary(ref[0]):
            if all((s, ref) not in cind_pairs
                   for s in _dep_subcaptures(*dep)):
                out.add(c)
        else:
            if all((s, ref) not in c12_pairs
                   for s in _dep_subcaptures(*dep)):
                out.add(c)
    return out


def _filter_latebb(full: set) -> set:
    cind_pairs = {(c[0:3], c[3:6]) for c in full}
    out = set()
    for c in full:
        dep, ref = c[0:3], c[3:6]
        if cc.is_binary(dep[0]) and any(
                (s, ref) in cind_pairs for s in _dep_subcaptures(*dep)):
            continue
        out.add(c)
    return out


def shape_output(full: np.ndarray, strategy: int,
                 clean_implied: bool) -> np.ndarray:
    """Full definitional set -> the exact row set a batch run of `strategy`
    emits (raw filters for 1/3, minimize for --clean-implied)."""
    rows = {tuple(int(v) for v in r) for r in full}
    if clean_implied:
        rows = oracle.minimize_cinds(rows)
    elif strategy == 1:
        rows = _filter_s2l(rows)
    elif strategy == 3:
        rows = _filter_latebb(rows)
    out = np.array(sorted(rows), np.int64).reshape(-1, 7)
    return out


# ---------------------------------------------------------------------------
# Change-batch ingest (the native engine when eligible).
# ---------------------------------------------------------------------------


def _parse_batch(cfg, paths: list[str]) -> np.ndarray:
    """(M, 3) object array of string tokens for one change batch, through
    the same ingest selection + string transforms as the base run."""
    if not paths:
        return np.zeros((0, 3), object)
    is_nq = paths[0].endswith((".nq", ".nq.gz"))
    use_native = (cfg.native_ingest and native.available()
                  and not cfg.asciify_triples and not cfg.prefix_paths
                  and reader.is_utf8(cfg.encoding))
    if use_native:
        bids, bdict = native.ingest_files(paths, tabs=cfg.tabs,
                                          expect_quad=is_nq)
        if bids.shape[0] == 0:
            return np.zeros((0, 3), object)
        vals = np.asarray(bdict.values, object)
        return vals[np.asarray(bids, np.int64)]
    out = []
    for _, line in reader.iter_lines(paths, encoding=cfg.encoding):
        t = (ntriples.parse_tab_line(line) if cfg.tabs
             else ntriples.parse_line(line, expect_quad=is_nq))
        if t is not None:
            out.append(t)
    if cfg.asciify_triples:
        out = [tuple(prefixes.asciify(v) for v in t) for t in out]
    if cfg.prefix_paths:
        from . import driver as _driver
        trie, url_of = _driver._load_prefix_trie(cfg)
        out = [tuple(prefixes.shorten_term(v, trie, url_of) for v in t)
               for t in out]
    if not out:
        return np.zeros((0, 3), object)
    return np.asarray(out, object).reshape(-1, 3)


def _apply_batch(bundle: Bundle, ins_tok: np.ndarray, del_tok: np.ndarray,
                 distinct: bool, counters: dict):
    """Map batch tokens to internal ids (new values appended to the tail,
    ids never reassigned), mark deleted rows dead, append inserted rows.

    Returns (ids, alive, values, changed) where `changed` indexes the rows
    whose membership changed (the exact perturbation set)."""
    values = bundle.values
    v0 = len(values)
    order = np.argsort(values, kind="stable")
    sorted_vals = values[order]

    def lookup(tokens):
        if len(tokens) == 0:
            return np.zeros(0, np.int64)
        pos = np.searchsorted(sorted_vals, tokens)
        if v0 == 0:
            return np.full(len(tokens), -1, np.int64)
        pos_c = np.minimum(pos, v0 - 1)
        ok = sorted_vals[pos_c] == tokens
        return np.where(ok, order[pos_c], -1).astype(np.int64)

    # Inserts may mint new values: unique batch tokens, map the known ones,
    # append the rest to the internal tail (brand-new values = brand-new
    # ids = possibly brand-new buckets; the routing law covers them with no
    # special case).
    ins_ids = np.zeros((0, 3), np.int64)
    if ins_tok.shape[0]:
        uniq, inv = np.unique(ins_tok.reshape(-1), return_inverse=True)
        mapped = lookup(uniq)
        new_mask = mapped == -1
        n_new = int(new_mask.sum())
        if n_new:
            mapped = mapped.copy()
            mapped[new_mask] = v0 + np.arange(n_new)
            values = np.concatenate([values, uniq[new_mask]])
        counters["delta-new-values"] = n_new
        ins_ids = mapped[inv].reshape(-1, 3)
    else:
        counters["delta-new-values"] = 0

    ids = bundle.ids.astype(np.int64)
    alive = np.ones(ids.shape[0], bool)
    missing = 0
    deleted_idx = np.zeros(0, np.int64)
    if del_tok.shape[0]:
        dmapped = lookup(del_tok.reshape(-1)).reshape(-1, 3)
        known = (dmapped >= 0).all(axis=1)
        missing += int((~known).sum())
        dels = dmapped[known]
        if dels.shape[0]:
            # One live row dies per delete line (bag semantics; under
            # --distinct the table is already deduped, so this is set
            # removal).  Candidate rows share a delete's subject — a flag
            # scan, then a small exact-match dict over just those rows.
            want = np.zeros(len(values), bool)
            want[dels[:, 0]] = True
            cand = np.flatnonzero(want[ids[:, 0]])
            slots: dict = {}
            for ri in cand.tolist():
                slots.setdefault(tuple(ids[ri]), []).append(ri)
            hit = []
            for d in map(tuple, dels.tolist()):
                lst = slots.get(d)
                if lst:
                    hit.append(lst.pop())
                else:
                    missing += 1
            deleted_idx = np.asarray(sorted(hit), np.int64)
            alive[deleted_idx] = False
    counters["delta-missing-deletes"] = missing

    if distinct and ins_ids.shape[0]:
        # Match the batch pipeline's np.unique(ids, axis=0): drop duplicate
        # insert rows and rows already present among the survivors.
        ins_ids = np.unique(ins_ids, axis=0)
        want = np.zeros(len(values), bool)
        want[ins_ids[:, 0]] = True
        cand = np.flatnonzero(alive & want[ids[:, 0]])
        present = {tuple(r) for r in ids[cand].tolist()}
        keep = np.array([tuple(r) not in present for r in ins_ids.tolist()],
                        bool)
        ins_ids = ins_ids[keep]

    n0 = ids.shape[0]
    if ins_ids.shape[0]:
        ids = np.concatenate([ids, ins_ids])
        alive = np.concatenate([alive, np.ones(ins_ids.shape[0], bool)])
    changed = np.concatenate(
        [deleted_idx, n0 + np.arange(ids.shape[0] - n0, dtype=np.int64)])
    return ids.astype(np.int64), alive, values, changed


# ---------------------------------------------------------------------------
# The incremental core: dirty lines -> affected captures -> re-intersection.
# ---------------------------------------------------------------------------


def _recompute(bundle_rows: np.ndarray, full: np.ndarray, ids: np.ndarray,
               alive: np.ndarray, dirty_flag: np.ndarray, *,
               projections: str, min_support: int):
    """Re-derive the evidence + full CIND set after a change batch.

    Returns (upd_rows, old_dirty, new_dirty, merged_full, counts) where
    counts carries the dirtiness accounting for stats["delta"]."""
    old_dirty_mask = dirty_flag[bundle_rows[:, 0]]
    kept = bundle_rows[~old_dirty_mask]
    old_dirty = bundle_rows[old_dirty_mask]
    new_dirty = _emit_rows(ids, projections, line_flag=dirty_flag,
                           alive=alive)
    upd = np.concatenate([kept, new_dirty]) if new_dirty.shape[0] else kept

    # Intern captures across the updated rows AND the removed rows: a
    # capture that vanished entirely must still be "affected" (its retained
    # output rows are invalid and must not survive the merge).
    allcap = np.concatenate([upd[:, 1:4], old_dirty[:, 1:4]])
    if allcap.shape[0] == 0:
        counts = {"dirty_lines": 0, "affected_captures": 0,
                  "dirty_rows": 0, "new_rows": 0}
        return upd, old_dirty, new_dirty, full.copy(), counts
    cap_table, inv = np.unique(allcap, axis=0, return_inverse=True)
    n_caps = cap_table.shape[0]
    cap_upd = inv[:upd.shape[0]]
    support = np.bincount(cap_upd, minlength=n_caps)
    affected = np.unique(inv[kept.shape[0]:])
    aff_flag = np.zeros(n_caps, bool)
    aff_flag[affected] = True

    # Rows needed for re-intersection: every row of every line that
    # contains an affected capture (an affected capture's refset is the
    # intersection over ITS lines — other lines never enter).
    arow = aff_flag[cap_upd]
    sub_line_flag = np.zeros(len(dirty_flag), bool)
    sub_line_flag[upd[arow, 0]] = True
    sm = sub_line_flag[upd[:, 0]]
    sub = upd[sm]
    scap = cap_upd[sm]
    order = np.argsort(sub[:, 0], kind="stable")
    sjv = sub[order, 0]
    scap = scap[order]
    lvals, lstart, lcount = np.unique(sjv, return_index=True,
                                      return_counts=True)
    line_idx = np.searchsorted(lvals, sjv)
    apos = np.flatnonzero(aff_flag[scap])

    # Pair expansion, chunked at _PAIR_BUDGET rows: for each affected-cap
    # row, gather its whole line; count (cap, other) co-occurrences.  A pair
    # co-occurring on EVERY line of the cap (count == support) is a refset
    # member.
    keys_acc, cnts_acc = [], []
    lens = lcount[line_idx[apos]].astype(np.int64)
    starts = lstart[line_idx[apos]].astype(np.int64)
    i = 0
    while i < len(apos):
        j, tot = i, 0
        while j < len(apos) and (tot == 0 or tot + lens[j] <= _PAIR_BUDGET):
            tot += int(lens[j])
            j += 1
        ls, st = lens[i:j], starts[i:j]
        cs = np.cumsum(ls)
        base = np.repeat(cs - ls, ls)
        offs = np.arange(int(cs[-1]) if len(cs) else 0, dtype=np.int64) - base
        x = scap[np.repeat(st, ls) + offs].astype(np.int64)
        c = np.repeat(scap[apos[i:j]].astype(np.int64), ls)
        k, n = np.unique(c * n_caps + x, return_counts=True)
        keys_acc.append(k)
        cnts_acc.append(n)
        i = j
    new_rows: list[tuple] = []
    if keys_acc:
        keys = np.concatenate(keys_acc)
        cnts = np.concatenate(cnts_acc)
        uk, kinv = np.unique(keys, return_inverse=True)
        total = np.bincount(kinv, weights=cnts).astype(np.int64)
        c_ids = (uk // n_caps).astype(np.int64)
        x_ids = (uk % n_caps).astype(np.int64)
        sup_c = support[c_ids]
        keep = (total == sup_c) & (sup_c >= min_support)
        for ci, xi, s in zip(c_ids[keep].tolist(), x_ids[keep].tolist(),
                             sup_c[keep].tolist()):
            dep = tuple(int(v) for v in cap_table[ci])
            ref = tuple(int(v) for v in cap_table[xi])
            if oracle._implies(dep, ref):
                continue
            new_rows.append((*dep, *ref, int(s)))

    # Merge: retained rows are exactly those whose dependent is unaffected
    # (an unaffected dependent's lines are all unchanged, so its refset and
    # support are bit-identical — including refs whose own support moved).
    if full.shape[0]:
        comb = np.concatenate([cap_table[affected], full[:, 0:3]])
        u, vinv = np.unique(comb, axis=0, return_inverse=True)
        aff_u = np.zeros(u.shape[0], bool)
        aff_u[vinv[:len(affected)]] = True
        retained = full[~aff_u[vinv[len(affected):]]]
    else:
        retained = full
    merged = np.concatenate(
        [retained, np.array(new_rows, np.int64).reshape(-1, 7)])

    counts = {
        "dirty_lines": int(np.unique(np.concatenate(
            [old_dirty[:, 0], new_dirty[:, 0]])).shape[0])
        if (old_dirty.shape[0] or new_dirty.shape[0]) else 0,
        "affected_captures": int(affected.shape[0]),
        "dirty_rows": int(old_dirty.shape[0]),
        "new_rows": int(new_dirty.shape[0]),
    }
    return upd, old_dirty, new_dirty, merged, counts


# ---------------------------------------------------------------------------
# Base-bundle creation (full run with --delta-state).
# ---------------------------------------------------------------------------


def write_base_bundle(cfg, ids: np.ndarray, dictionary, table,
                      stats: dict | None, timings: dict, dev) -> dict:
    """Persist generation 0 after a full run.  At generation 0 internal ids
    == canonical ids (the dictionary is sorted), so the run's own artifacts
    are stored as-is.  A strategy whose output is not the full definitional
    set has that set discovered again, on `dev`."""
    buckets, passes = num_buckets(), n_passes()
    ids = np.asarray(ids, np.int64)
    values = np.asarray(dictionary.values, object)
    rows = _sort_rows(_emit_rows(ids, cfg.projections), buckets)
    use_ars = cfg.use_association_rules and cfg.use_frequent_item_set
    if cfg.traversal_strategy in (0, 2) and not cfg.clean_implied \
            and not use_ars:
        # Strategies 0/2 raw output IS the full definitional set.
        full = np.stack([np.asarray(getattr(table, c), np.int64)
                         for c in checkpoint._CIND_COLS], axis=1)
    else:
        from ..models import allatonce
        full_table = allatonce.discover(
            np.asarray(ids, np.int32), cfg.min_support,
            projections=cfg.projections, clean_implied=False, device=dev)
        full = np.stack([np.asarray(getattr(full_table, c), np.int64)
                         for c in checkpoint._CIND_COLS], axis=1)
    base_wall = sum(timings.get(k, 0.0) for k in
                    ("read+parse", "intern", "asciify", "shorten-urls",
                     "distinct", "discover"))
    meta = _core_meta(cfg.min_support, cfg.projections,
                      cfg.distinct_triples, buckets, passes)
    meta.update(
        generation=0,
        n_triples=int(ids.shape[0]), n_values=int(len(values)),
        n_rows=int(rows.shape[0]), n_full=int(full.shape[0]),
        ingest_digest=_ids_digest(ids),
        dict_digest=_blob_digest(_encode_values(values)["value_blob"]),
        full_digest=_full_digest(full),
        pass_digests=_lanes_to_hex(_pass_lane_sums(rows, buckets, passes)),
        output_digest=integrity.digest_hex(*integrity.digest_table(table)),
        base_output_digest=None,
        base_wall_s=round(base_wall, 6),
        created_unix=round(time.time(), 3),
        batch={"inserts": int(ids.shape[0]), "deletes": 0},
    )
    save_bundle(cfg.delta_state, meta, ids, values, rows, full)
    metrics.struct_set(stats, "delta_state", {
        "dir": cfg.delta_state, "generation": 0,
        "n_rows": int(rows.shape[0]), "n_full": int(full.shape[0]),
        "num_buckets": buckets, "n_passes": passes})
    tracer.instant("delta_state", cat=tracer.CAT_RUN, generation=0,
                   n_rows=int(rows.shape[0]))
    return meta


# ---------------------------------------------------------------------------
# The delta run.
# ---------------------------------------------------------------------------


def run_delta(cfg, phases, counters: dict, stats: dict, dev):
    """Execute `rdfind --delta BASE_DIR [inserts...] --deletes [...]`; a
    full fallback discovers on `dev`.

    Returns the driver's RunResult; raises DeltaBaseError on an untrustable
    base bundle."""
    from . import driver as _driver

    bundle = phases.run("delta-load", lambda: load_bundle(
        cfg.delta_base, min_support=cfg.min_support,
        projections=cfg.projections, distinct=cfg.distinct_triples,
        stats=stats))
    meta = bundle.meta
    generation = int(meta["generation"])
    tracer.set_status(mode="delta", generation=generation)
    metrics.struct_set(stats, "delta", {
        "mode": "delta", "generation": generation,
        "base_output_digest": meta["output_digest"],
        "n_passes": int(meta["n_passes"])})
    for reason in bundle.degraded:
        metrics.list_append(stats, "delta_degradations", reason)
        tracer.instant("delta_degraded", cat=tracer.CAT_RUN, reason=reason)
        print(f"note: delta base degraded: {reason} (rebuilding)",
              file=sys.stderr)

    def ingest():
        ins = _parse_batch(cfg, reader.resolve_path_patterns(
            cfg.input_paths, cfg.file_filter) if cfg.input_paths else [])
        dels = _parse_batch(cfg, reader.resolve_path_patterns(
            cfg.delete_paths) if cfg.delete_paths else [])
        return ins, dels

    ins_tok, del_tok = phases.run("delta-ingest", ingest)
    counters["input-triples"] = int(ins_tok.shape[0] + del_tok.shape[0])

    ids, alive, values, changed = phases.run(
        "delta-apply", lambda: _apply_batch(
            bundle, ins_tok, del_tok, cfg.distinct_triples, counters))
    counters["distinct-values"] = 0  # set after canonicalization

    # Rebuild a corrupt/missing evidence stage host-side (exact; the rows
    # are a pure function of the bundled triples).
    if bundle.rows is None:
        bundle.rows = phases.run("delta-rebuild-evidence", lambda: _sort_rows(
            _emit_rows(bundle.ids.astype(np.int64), cfg.projections),
            int(meta["num_buckets"])))

    # Dirty set: a changed triple perturbs exactly the join lines keyed by
    # its projected values (per projected field), nothing else.
    proj_fields = [cc.FIELD_INDEX[b] for ch, b in zip("spo", _FIELD_BITS)
                   if ch in cfg.projections]
    dirty_flag = np.zeros(len(values), bool)
    if changed.size:
        for f in proj_fields:
            dirty_flag[ids[changed, f]] = True
    buckets, passes = int(meta["num_buckets"]), int(meta["n_passes"])
    dirty_vals = np.flatnonzero(dirty_flag)
    dirty_buckets = np.unique(hashing.host_bucket_of(
        [dirty_vals.astype(np.uint32)], buckets, seed=DELTA_SEED)) \
        if dirty_vals.size else np.zeros(0, np.int64)
    dirty_passes = np.unique(_pass_of_bucket(dirty_buckets, buckets, passes))
    old_dirty_guess = int(dirty_flag[bundle.rows[:, 0]].sum())
    dirty_frac = old_dirty_guess / max(bundle.rows.shape[0], 1)

    use_ars = cfg.use_association_rules and cfg.use_frequent_item_set
    full_reasons = []
    if use_ars:
        full_reasons.append("use-ars-changes-evidence")
    if dirty_frac > full_frac():
        full_reasons.append(
            f"dirty-frac-{dirty_frac:.2f}-exceeds-{full_frac():.2f}")
    if bundle.full is None and not full_reasons:
        # The definitional set cannot be recomputed incrementally without
        # its previous value; a corrupt cinds stage forces the full path
        # (named above by load_bundle) — still a correct answer.
        full_reasons.append("cinds-stage-rebuild")

    canon, internal_of_canon, dictionary = _canonical_state(
        values, ids, alive)
    counters["distinct-values"] = len(dictionary)

    if full_reasons:
        path = "full-fallback"
        for reason in full_reasons:
            metrics.list_append(stats, "delta_degradations", reason)
            tracer.instant("delta_degraded", cat=tracer.CAT_RUN,
                           reason=reason)
        cids = canon[ids[alive]].astype(np.int32)
        if cfg.distinct_triples and cids.shape[0]:
            cids = np.unique(cids, axis=0)

        def full_run():
            fn = _driver.STRATEGIES[cfg.traversal_strategy]
            return fn(cids, cfg.min_support, projections=cfg.projections,
                      use_frequent_condition_filter=cfg.use_frequent_item_set,
                      use_association_rules=use_ars,
                      clean_implied=cfg.clean_implied, stats=stats,
                      device=dev)
        table = phases.run("delta-full-fallback", full_run)
        if cfg.traversal_strategy in (0, 2) and not cfg.clean_implied \
                and not use_ars:
            canon_full = np.stack(
                [np.asarray(getattr(table, c), np.int64)
                 for c in checkpoint._CIND_COLS], axis=1)
        else:
            from ..models import allatonce
            ft = phases.run("delta-full-set", lambda: allatonce.discover(
                cids, cfg.min_support, projections=cfg.projections,
                clean_implied=False, device=dev))
            canon_full = np.stack(
                [np.asarray(getattr(ft, c), np.int64)
                 for c in checkpoint._CIND_COLS], axis=1)
        merged_full = _remap_cind_cols(canon_full, internal_of_canon)
        upd_rows = _sort_rows(
            _emit_rows(ids, cfg.projections, alive=alive), buckets)
        new_digests = _lanes_to_hex(
            _pass_lane_sums(upd_rows, buckets, passes))
        rec_counts = {"dirty_lines": int(dirty_vals.size),
                      "affected_captures": -1,
                      "dirty_rows": old_dirty_guess,
                      "new_rows": int(upd_rows.shape[0])}
        passes_rerun = passes
    else:
        path = "incremental"

        def recompute():
            return _recompute(
                bundle.rows, bundle.full, ids, alive, dirty_flag,
                projections=cfg.projections, min_support=cfg.min_support)
        upd_rows, old_dirty, new_dirty, merged_full, rec_counts = phases.run(
            "delta-recompute", recompute)

        def merge():
            shaped = shape_output(merged_full, cfg.traversal_strategy,
                                  cfg.clean_implied)
            return CindTable.from_rows(
                map(tuple, _remap_cind_cols(shaped, canon).tolist()))
        table = phases.run("delta-merge", merge)
        upd_rows = _sort_rows(upd_rows, buckets)
        new_digests = _update_pass_digests(
            meta["pass_digests"], old_dirty, new_dirty, buckets)
        passes_rerun = int(dirty_passes.size)

    if integrity.enabled():
        lanes = _hex_to_lanes(new_digests).sum(axis=0) \
            % np.uint64(1 << 32)
        integrity.publish_stage(stats, "delta-evidence",
                                int(lanes[0]), int(lanes[1]),
                                passes=passes)

    # Families touched by the delta (minimality re-ran as a host hash-join
    # over the merged set — proportional to the CIND set, not the dataset).
    fam_touched: dict = {}
    if path == "incremental" and merged_full.shape[0]:
        dep_bin = cc.is_binary(merged_full[:, 0])
        ref_bin = cc.is_binary(merged_full[:, 3])
        for db, rb, label in ((0, 0, "1/1"), (0, 1, "1/2"),
                              (1, 0, "2/1"), (1, 1, "2/2")):
            n = int(np.count_nonzero((dep_bin == bool(db))
                                     & (ref_bin == bool(rb))))
            if n:
                fam_touched[label] = n

    delta_wall = sum(v for k, v in phases.timings.items()
                     if k.startswith("delta-"))
    base_wall = float(meta.get("base_wall_s") or 0.0)
    metrics.struct_update(
        stats, "delta",
        path=path,
        inserts=int(ins_tok.shape[0]), deletes=int(del_tok.shape[0]),
        missing_deletes=int(counters.get("delta-missing-deletes", 0)),
        new_values=int(counters.get("delta-new-values", 0)),
        dirty_lines=int(rec_counts["dirty_lines"]),
        dirty_buckets=int(dirty_buckets.size),
        affected_captures=int(rec_counts["affected_captures"]),
        dirty_row_frac=round(dirty_frac, 6),
        passes_rerun=passes_rerun,
        passes_reused=passes - passes_rerun,
        families=fam_touched,
        speedup_vs_base=(round(base_wall / delta_wall, 2)
                         if delta_wall > 0 and base_wall > 0 else None),
    )

    def save_state():
        ids2 = ids[alive].astype(np.int64)
        new_meta = dict(meta)
        new_meta.update(
            generation=generation + 1,
            n_triples=int(ids2.shape[0]), n_values=int(len(values)),
            n_rows=int(upd_rows.shape[0]),
            n_full=int(merged_full.shape[0]),
            ingest_digest=_ids_digest(ids2),
            dict_digest=_blob_digest(_encode_values(values)["value_blob"]),
            full_digest=_full_digest(merged_full),
            pass_digests=new_digests,
            base_output_digest=meta["output_digest"],
            output_digest=integrity.digest_hex(
                *integrity.digest_table(table)),
            created_unix=round(time.time(), 3),
            batch={"inserts": int(ins_tok.shape[0]),
                   "deletes": int(del_tok.shape[0]),
                   "base_generation": generation},
        )
        save_bundle(cfg.delta_base, new_meta, ids2, values, upd_rows,
                    merged_full)
        return new_meta
    new_meta = phases.run("delta-state", save_state)
    metrics.struct_update(stats, "delta", new_generation=generation + 1)
    # Commit the servable generation next to the advanced bundle: a serving
    # process polling the dir digest-verifies it, checks the certificate
    # chain (base_output_digest == the generation it loaded), and hot-swaps.
    # The bundle's commit stamp and batch identity ride into the index meta
    # — they are the anchors the serving freshness plane measures against.
    phases.run("serve-index", lambda: serving.emit_index(
        [cfg.delta_base], dictionary, table, generation=generation + 1,
        base_output_digest=meta["output_digest"],
        strategy=cfg.traversal_strategy, min_support=cfg.min_support,
        stats=stats,
        extra={"bundle_commit_unix": new_meta.get("commit_unix"),
               "batch": new_meta.get("batch")}))

    counters["cind-counter"] = len(table)
    counters.update({f"stat-{k}": v for k, v in stats.items()})
    cids_out = canon[ids[alive]].astype(np.int32)
    _driver._emit_sinks(cfg, phases, counters, table, dictionary, stats,
                        cids_out, dev)
    _driver._report(cfg, counters, phases.timings)
    return _driver.RunResult(table, dictionary, cids_out, counters,
                             phases.timings)
