"""Deterministic fault injection and the graceful-degradation ladder.

Every recovery path must be drivable from tests instead of hoping real
hardware misbehaves.  Two coordinated pieces live here:

Fault plan.  ``RDFIND_FAULTS`` names injection sites, e.g.::

    RDFIND_FAULTS="host_pull:nth=2;checkpoint_write"

Each clause is ``site[:key=value]*``.  Recognized keys:

  pass=K    fire when the executor is at dep-slice pass K (pass-scoped sites);
  nth=K     fire on the K-th hit of the site (1-based; default 1);
  times=N   how many times to fire after the trigger (default 1; -1 = forever);
  p=F       fire each hit with probability F from a SEEDED rng
            (RDFIND_FAULT_SEED, default 0) — deterministic across runs;
  rank=R    fire only on global rank R of a launch (every rank when absent);
  hard      (wedge sites) block in one C-level call that the watchdog's
            Preempted cannot interrupt, as a wedged gloo or NCCL call does,
            so only the watchdog's hard exit (75) ends it.

The plan is parsed once per distinct env string and keeps per-site hit
counters, so a resumed run in the same process does not re-fire an exhausted
one-shot fault.  ``SITES`` is the JAX package's list; on one device the port
reaches ``host_pull`` (each chunk pull of the chunk loop) and
``checkpoint_write`` (``CheckpointStore.save``), the others belong to the
sharded pipeline.

Degradation ladder.  Exhausted overflow retries escalate grow -> split ->
skip -> fallback (``FallbackRequired``); every rung taken is recorded in
``stats["degradations"]`` and the final rung per phase in
``stats["ladder_rung"]``.  ``RDFIND_STRICT=1`` disables the ladder and the pull
retries, restoring fail-fast behaviour.

Host pulls get bounded retry with exponential backoff + jitter
(``guarded_pull``; RDFIND_PULL_RETRIES / RDFIND_BACKOFF_BASE_MS /
RDFIND_BACKOFF_MAX_MS), with telemetry accumulated module-wide
(``pull_stats``).

The JAX package's ``runtime/faults.py``, copied.  ``maybe_wedge`` is the
simulated wedged collective the collective watchdog converts into Preempted.  Import-light: stdlib and the
stdlib-only obs package.
"""

from __future__ import annotations

import dataclasses
import os
import random
import time

from ..obs import flightrec, metrics, tracer


class FaultError(RuntimeError):
    """Base class of every injected fault."""


class InjectedFault(FaultError):
    """A generic injected failure (host pull, checkpoint write, ...)."""


class Preempted(FaultError):
    """Simulated preemption (the SIGTERM analog): the run must die NOW, and a
    re-run against the same checkpoint dir must resume, not restart.

    Raising one dumps the flight recorder (when armed): the preemption IS
    the post-mortem moment, and the exception may unwind past every other
    dump site."""

    def __init__(self, *args):
        super().__init__(*args)
        flightrec.dump(reason=f"preempted: {self}")


class FallbackRequired(FaultError):
    """The ladder's last rung: the sharded phase cannot complete; the caller
    must re-run the workload on the output-identical single-device strategy."""

    def __init__(self, phase: str, detail: str = ""):
        super().__init__(f"fallback required for {phase}"
                         + (f" ({detail})" if detail else ""))
        self.phase = phase
        self.detail = detail


# Every registered injection site, as in the JAX package.  The wedge@<site>
# family names collectives of the sharded pipeline: one host sleeps "forever"
# inside the collective's armed window until a watchdog converts the hang.
SITES = (
    "overflow@lines",      # P2 freq/exchange-A verdict (sharded._Pipeline)
    "overflow@captures",   # P3 exchange-B verdict
    "overflow@rebalance",  # P2b hot-line move verdict
    "overflow@cind",       # pair-phase pass verdict (run_cinds)
    "overflow@cooc",       # S2L/approx level pass verdict (run_cooc)
    "host_pull",           # any host pull (the chunk loop's chunk pulls)
    "checkpoint_write",    # CheckpointStore.save
    "preempt@discover",    # pass-commit boundary of the pass executor
    "flip@host_pull",      # silent corruption: one bit in a pulled block
    "flip@snapshot",       # silent corruption: one bit in a loaded snapshot
    "wedge@freq",          # P2 line-build exchange dispatch/pull
    "wedge@captures",      # P3 exchange-B dispatch/pull
    "wedge@rebalance",     # P2b hot-line move dispatch/pull
    "wedge@pairs",         # pass-executor counters/blocks pull
    "wedge@sketch",        # half-approx count-min allreduce
    "wedge@pass_commit",   # coalesced per-pass allgather (skew + digests)
    "wedge@resume_vote",   # elastic-resume snapshot vote
    "wedge@allgather",     # any other mesh.allgather_host_values rider
    "wedge@init",          # the process-group rendezvous
)


@dataclasses.dataclass
class FaultSpec:
    site: str
    pass_idx: int | None = None  # pass=K constraint
    nth: int = 1                 # fire starting at the nth hit (1-based)
    times: int = 1               # firings after the trigger; -1 = forever
    prob: float | None = None    # p=F probabilistic firing (seeded rng)
    hits: int = 0                # hits seen (matching the pass constraint)
    fired: int = 0               # times actually fired
    # The port's own keys, plain attributes: the fields are the JAX
    # package's, so a spec's fields equal JAX's spec of the same clause.
    rank = None                  # rank=R constraint
    hard = False                 # wedge: C-level block (hard exit only)


# The global rank of this process in a launch (set by the launcher); the
# rank=R constraint compares against it.
_RANK = 0


def set_rank(rank: int) -> None:
    global _RANK
    _RANK = int(rank)


def _parse_clause(clause: str) -> FaultSpec:
    parts = clause.split(":")
    site = parts[0].strip()
    if site not in SITES:
        raise ValueError(f"unknown fault site {site!r}; known: {SITES}")
    spec = FaultSpec(site=site)
    for kv in parts[1:]:
        if not kv.strip():
            continue
        key, _, val = kv.partition("=")
        key = key.strip()
        if key == "pass":
            spec.pass_idx = int(val)
        elif key == "nth":
            spec.nth = int(val)
            if spec.nth < 1:
                raise ValueError(f"nth must be >= 1 in {clause!r}")
        elif key == "times":
            spec.times = int(val)
        elif key == "p":
            spec.prob = float(val)
        elif key == "rank":
            spec.rank = int(val)
        elif key == "hard" and val.strip() in ("", "1"):
            if not site.startswith("wedge@"):
                raise ValueError(f"hard applies to wedge@ sites: {clause!r}")
            spec.hard = True
        else:
            raise ValueError(f"unknown fault key {key!r} in {clause!r}")
    return spec


class FaultPlan:
    """A parsed, stateful fault plan (per-site hit counters live here)."""

    def __init__(self, spec_str: str, seed: int = 0):
        self.spec_str = spec_str
        self.specs: list[FaultSpec] = []
        for clause in spec_str.split(";"):
            clause = clause.strip()
            if clause:
                self.specs.append(_parse_clause(clause))
        self._rng = random.Random(seed)

    def fires(self, site: str, pass_idx: int | None = None) -> bool:
        """Whether an armed fault at `site` fires now (and consume it)."""
        return bool(self.fire(site, pass_idx))

    def fire(self, site: str, pass_idx: int | None = None) -> list:
        """The specs at `site` that fire now (consumed)."""
        fired = []
        for s in self.specs:
            if s.site != site:
                continue
            if s.pass_idx is not None and pass_idx != s.pass_idx:
                continue
            if s.rank is not None and s.rank != _RANK:
                continue
            s.hits += 1
            if s.hits < s.nth:
                continue
            if s.times >= 0 and s.fired >= s.times:
                continue
            if s.prob is not None and self._rng.random() >= s.prob:
                continue
            s.fired += 1
            fired.append(s)
        return fired


_PLAN: FaultPlan | None = None
_PLAN_SRC: str | None = None


def active_plan() -> FaultPlan | None:
    """The plan for the current RDFIND_FAULTS value (None when unset).

    Re-parsed only when the env string changes, so hit counters survive
    across multiple pipelines in one process (an exhausted one-shot fault
    stays exhausted for the resumed run).
    """
    global _PLAN, _PLAN_SRC
    src = os.environ.get("RDFIND_FAULTS", "")
    if src != _PLAN_SRC:
        _PLAN_SRC = src
        seed = int(os.environ.get("RDFIND_FAULT_SEED", "0"))
        _PLAN = FaultPlan(src, seed=seed) if src else None
    return _PLAN


def export_state():
    """The active plan's hit/fire counters and rng state, so a relaunched
    rank (the launcher's supervisor starts fresh processes) carries on the
    plan where the preempted attempt left it, as one process re-entering the
    run would: an exhausted one-shot fault stays exhausted."""
    plan = active_plan()
    if plan is None:
        return None
    return (plan.spec_str, [(s.hits, s.fired) for s in plan.specs],
            plan._rng.getstate())


def import_state(state) -> None:
    """Restore export_state()'s counters into the plan of the same spec."""
    plan = active_plan()
    if plan is None or state is None or state[0] != plan.spec_str:
        return
    for s, (hits, fired) in zip(plan.specs, state[1]):
        s.hits, s.fired = hits, fired
    plan._rng.setstate(state[2])


def reset() -> None:
    """Forget the cached plan (tests re-arming the same spec string)."""
    global _PLAN, _PLAN_SRC
    _PLAN = None
    _PLAN_SRC = None


def fires(site: str, pass_idx: int | None = None) -> bool:
    plan = active_plan()
    return plan is not None and plan.fires(site, pass_idx)


def maybe_fail(site: str, pass_idx: int | None = None) -> None:
    """Raise InjectedFault when an armed fault at `site` fires."""
    if fires(site, pass_idx):
        raise InjectedFault(f"injected fault at {site}"
                            + (f" (pass={pass_idx})" if pass_idx is not None
                               else ""))


def maybe_preempt(site: str, pass_idx: int | None = None) -> None:
    """Raise Preempted when an armed preemption at `site` fires."""
    if fires(site, pass_idx):
        raise Preempted(f"injected preemption at {site}"
                        + (f" (pass={pass_idx})" if pass_idx is not None
                           else ""))


def maybe_wedge(site: str, pass_idx: int | None = None) -> None:
    """Simulated wedged collective: when an armed ``wedge@<site>`` fault
    fires, this rank blocks inside the collective's armed watchdog window
    (watchdog.wedge_wait) until the deadman converts the hang into
    Preempted.  Called from inside watchdog.collective()'s guard, so the
    timer is always armed around the sleep.  A ``hard`` wedge blocks where
    the watchdog's Preempted cannot reach it, so only its hard exit ends it."""
    plan = active_plan()
    fired = plan.fire(f"wedge@{site}", pass_idx) if plan is not None else []
    if fired:
        from . import watchdog

        watchdog.wedge_wait(site, hard=any(s.hard for s in fired))


def overflow_injected(site: str, pass_idx: int | None = None) -> bool:
    """Whether an injected overflow verdict fires at `site` (bool form: the
    caller folds it into its psum'd overflow counters)."""
    return fires(site, pass_idx)


def maybe_flip(site: str, arrays, pass_idx: int | None = None):
    """Silent-corruption injection: when an armed ``flip@*`` fault fires,
    flip ONE bit in the first non-empty array and return a new list (inputs
    are never mutated — a re-pull must see clean data).  Unlike maybe_fail
    nothing raises: the whole point is corruption that only the integrity
    plane's digest verification can notice."""
    if not fires(site, pass_idx):
        return arrays
    import numpy as np
    out = list(arrays)
    for i, a in enumerate(out):
        a = np.asarray(a)
        if a.size == 0:
            continue
        flat = a.copy().reshape(-1)
        flat[0] = np.bitwise_xor(flat[0], flat.dtype.type(1))
        out[i] = flat.reshape(a.shape)
        break
    return out


def strict_mode() -> bool:
    """RDFIND_STRICT=1: fail fast — no ladder, no pull retries (the right
    mode for debugging a real overflow)."""
    return os.environ.get("RDFIND_STRICT", "") not in ("", "0")


# ---------------------------------------------------------------------------
# Degradation ledger.
# ---------------------------------------------------------------------------


def record_degradation(stats: dict | None, phase: str, action: str,
                       **detail) -> None:
    """Append one ladder step to stats["degradations"] and set the phase's
    final rung in stats["ladder_rung"] (grow < split < skip < fallback)."""
    if stats is None:
        return
    entry = {"phase": phase, "action": action, **detail}
    metrics.list_append(stats, "degradations", entry)
    metrics.mapping_set(stats, "ladder_rung", phase, action)
    tracer.instant("degradation", cat=tracer.CAT_DISPATCH, phase=phase,
                   action=action)
    # Every ladder rung is a post-mortem moment: snapshot the flight
    # recorder (no-op when unarmed) so the events leading INTO the
    # degradation survive even if the run later dies without one.
    flightrec.dump(reason=f"degradation {phase}:{action}")


def max_pass_splits(default: int = 2) -> int:
    """How many times the ladder may double n_pass before falling back."""
    return int(os.environ.get("RDFIND_MAX_PASS_SPLITS", default))


# ---------------------------------------------------------------------------
# Bounded-retry host pulls (exponential backoff + seeded jitter).
# ---------------------------------------------------------------------------

_PULL_STATS = {"n_host_pull_retries": 0, "backoff_ms_total": 0.0}
_BACKOFF_RNG = random.Random(int(os.environ.get("RDFIND_FAULT_SEED", "0")))


def pull_stats() -> dict:
    """Cumulative module-wide pull-retry telemetry (publishers take deltas)."""
    return dict(_PULL_STATS)


def _backoff_ms(attempt: int) -> float:
    base = float(os.environ.get("RDFIND_BACKOFF_BASE_MS", "50"))
    cap = float(os.environ.get("RDFIND_BACKOFF_MAX_MS", "2000"))
    raw = min(base * (2 ** attempt), cap)
    # Full jitter (seeded): desynchronizes retry storms across hosts without
    # losing determinism under a fixed RDFIND_FAULT_SEED.
    return raw * (0.5 + 0.5 * _BACKOFF_RNG.random())


def guarded_pull(fn, what: str = "host_pull", gate: bool = True):
    """Run a blocking host pull with the host_pull fault gate and bounded
    retry on failure (exponential backoff + jitter).

    Pulls are pure reads of device state, so re-running one is always safe.
    `fn` is a local copy and never a collective: a retry is decided on one
    rank, and a collective re-entered by one rank alone deadlocks its peers.
    Preempted and FallbackRequired pass through (they are control flow, not
    transient failures); everything else gets RDFIND_PULL_RETRIES attempts
    (default 3) unless RDFIND_STRICT=1 (one attempt, fail fast).  `gate`
    False skips the host_pull fault site (the second copy of one logical
    pull, which the site counts once).
    """
    tries = 1 if strict_mode() else max(
        1, int(os.environ.get("RDFIND_PULL_RETRIES", "3")))
    for attempt in range(tries):
        try:
            if gate:
                maybe_fail("host_pull")
            return fn()
        except (Preempted, FallbackRequired):
            raise
        except Exception:
            if attempt == tries - 1:
                raise
            delay = _backoff_ms(attempt)
            _PULL_STATS["n_host_pull_retries"] += 1
            _PULL_STATS["backoff_ms_total"] += delay
            time.sleep(delay / 1e3)
    raise AssertionError("unreachable")
