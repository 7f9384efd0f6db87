"""Cap-exhaustion forecasting: name the cap BEFORE the ladder fires.

The degradation ladder (grow -> split -> skip -> fallback) reacts to an
overflow that already happened; the memory watermark warning
(obs/memory.py) predicts memory pressure but says nothing about the
pair/giant caps.  Fed the per-pass cap-utilization fractions (obs/datastats.py's
trajectory points), this module fits each cap's trajectory with a
least-squares line and emits an advisory — registry entry, trace instant,
heartbeat extra, ``--debug-level`` line — naming the cap and the predicted
exhaustion pass.

Two triggers, first one wins per cap:

* **trend**: the fitted line crosses frac >= 1.0 at a pass the run still
  has ahead of it;
* **warn**: the current fraction already exceeds ``RDFIND_FORECAST_WARN``
  (default 0.85 — above the ~0.8 steady state of the 1.25x headroom
  convention, i.e. demand ate the headroom).

``RDFIND_FORECAST=0`` disables, ``=1`` forces on; by default forecasting
follows :func:`datastats.enabled` (no consumer, no work).

The JAX package's ``obs/forecast.py``, copied.  Stdlib only.
"""

from __future__ import annotations

import math
import os

from . import metrics, tracer

DEFAULT_WARN_FRAC = 0.85
# A cap needs this many trajectory points before the trend trigger can fire
# (a one-point "trend" is noise).
MIN_TREND_POINTS = 2


def enabled() -> bool:
    """``RDFIND_FORECAST``: "0" off, "1" force on; default follows the
    datastats consumers gate."""
    v = os.environ.get("RDFIND_FORECAST", "").strip()
    if v == "0":
        return False
    if v == "1":
        return True
    from . import datastats
    return datastats.enabled()


def warn_frac() -> float:
    try:
        return float(os.environ.get("RDFIND_FORECAST_WARN",
                                    str(DEFAULT_WARN_FRAC)))
    except ValueError:
        return DEFAULT_WARN_FRAC


def predict_exhaustion(trajectory: list[tuple[int, float]]) -> int | None:
    """First pass index where the least-squares fit of (pass, frac) crosses
    1.0, or None when the trajectory is too short, flat, or falling."""
    if len(trajectory) < MIN_TREND_POINTS:
        return None
    n = len(trajectory)
    mx = sum(p for p, _ in trajectory) / n
    my = sum(f for _, f in trajectory) / n
    denom = sum((p - mx) ** 2 for p, _ in trajectory)
    if denom <= 0:
        return None
    slope = sum((p - mx) * (f - my) for p, f in trajectory) / denom
    if slope <= 0:
        return None
    intercept = my - slope * mx
    return max(trajectory[-1][0] + 1,
               math.ceil((1.0 - intercept) / slope))


class Forecaster:
    """Per-executor advisory engine: feed it each pass's utilization
    fractions; it publishes at most one advisory per cap."""

    def __init__(self, stats: dict | None, n_pass: int, phase: str = "",
                 warn: float | None = None):
        self.stats = stats
        self.n_pass = int(n_pass)
        self.phase = phase
        self.warn = warn_frac() if warn is None else float(warn)
        self._trajectories: dict[str, list[tuple[int, float]]] = {}
        self._advised: set[str] = set()

    def step(self, pass_idx: int, fracs: dict[str, float]) -> list[dict]:
        """Record one trajectory point per cap; returns the advisories
        newly raised this pass (usually empty)."""
        raised = []
        for cap in sorted(fracs):
            frac = float(fracs[cap])
            traj = self._trajectories.setdefault(cap, [])
            traj.append((int(pass_idx), frac))
            if cap in self._advised:
                continue
            predicted = predict_exhaustion(traj)
            if frac >= self.warn:
                reason = "warn"
                predicted = (int(pass_idx) + 1 if predicted is None
                             else predicted)
            elif predicted is not None and predicted < self.n_pass:
                reason = "trend"
            else:
                continue
            self._advised.add(cap)
            adv = {"cap": cap, "phase": self.phase, "pass": int(pass_idx),
                   "predicted_pass": int(predicted),
                   "frac": round(frac, 6), "n_pass": self.n_pass,
                   "reason": reason}
            publish_advisory(self.stats, adv)
            raised.append(adv)
        return raised


def publish_advisory(stats: dict | None, adv: dict) -> None:
    """One advisory's full fan-out: registry mapping + active gauge, trace
    instant, heartbeat extra (what a watcher reads as "degrading"), and a
    stderr line under --debug-level via format_lines."""
    metrics.mapping_set(stats, "cap_forecast", adv["cap"], adv)
    metrics.gauge_set(stats, "cap_forecast_active", 1)
    tracer.instant("cap_forecast", cat=tracer.CAT_PASS, **adv)
    tracer.set_status(forecast={
        "cap": adv["cap"], "predicted_pass": adv["predicted_pass"],
        "frac": adv["frac"], "reason": adv["reason"]})


def advisory_line(adv: dict) -> str:
    """The one shared rendering of an advisory (report --summary and the
    --debug formatter both call this, so they can't fork)."""
    phase = f" [{adv['phase']}]" if adv.get("phase") else ""
    return (f"forecast{phase}: cap {adv['cap']} predicted exhausted at pass "
            f"{adv['predicted_pass']}/{adv.get('n_pass', '?')} "
            f"({adv['reason']}: frac {adv['frac']:.3f} at pass "
            f"{adv['pass']})")


def format_lines(stats: dict) -> list[str]:
    """Advisory lines from a published stats dict (empty when none fired)."""
    forecast = stats.get("cap_forecast") or {}
    return [advisory_line(forecast[cap]) for cap in sorted(forecast)]
