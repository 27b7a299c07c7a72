"""Carbon-aware temporal workload shifting (Section 8.2, after
*Let's Wait Awhile* [Wiesner et al. 2021]).

Synthetic-but-calibrated hourly carbon-intensity series for the four paper
regions (gCO2e/kWh): Germany (high mean, strong solar/wind swings),
California (duck curve), Great Britain (moderate), France (nuclear: low
mean, small swings).  Deterministic per (region, seed) within a process:
the noise seed is the reference's `hash((region, seed))`, which hashes the
region's string and so follows PYTHONHASHSEED, as the reference's does.

A workload of given power profile is shifted to a policy-dependent start
slot chosen with *predicted* duration; realized emissions use the *actual*
duration — so prediction error directly costs carbon.

`shift_workload` is a decision-plane consumer: `predicted_h` may be a
runtime *distribution* (anything with `.quantile(q)`, e.g.
`sched.plane.RuntimeDist` or a `TaskDistribution.dist(node)` row) instead
of a bare float — the scheduler then books the q-quantile hours, trading
a little extra low-carbon reservation against overflow into unplanned
(arbitrary-carbon) hours when the mean under-predicts.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Tuple

import numpy as np

REGIONS = ("germany", "california", "great_britain", "france")

_PARAMS = {             # mean, daily amplitude, weekly amplitude, noise sd
    "germany": (380.0, 120.0, 40.0, 25.0),
    "california": (260.0, 110.0, 20.0, 20.0),
    "great_britain": (230.0, 70.0, 25.0, 15.0),
    "france": (60.0, 18.0, 6.0, 6.0),
}

HOURS = 24 * 28            # 4-week horizon
_T0_WEEKDAY = 2            # simulation starts Wednesday 15:00
_T0_HOUR = 15


def intensity_series(region: str, seed: int = 0) -> np.ndarray:
    mean, daily, weekly, sd = _PARAMS[region]
    rng = np.random.default_rng(abs(hash((region, seed))) % 2 ** 31)
    h = np.arange(HOURS)
    tod = ((h + _T0_HOUR) % 24)
    dow = ((h + _T0_HOUR) // 24 + _T0_WEEKDAY) % 7
    # solar dip in the afternoon, peak in the evening (duck-ish curve)
    s = (mean
         - daily * np.sin((tod - 4) / 24 * 2 * np.pi)
         + weekly * (dow >= 5)            # weekends: lower demand, mixed
         + rng.normal(0, sd, HOURS))
    return np.maximum(s, 5.0)


def emissions_g(series: np.ndarray, start_h: float, duration_h: float,
                power_kw: float) -> float:
    """integrate power * intensity over [start, start+duration] (hours)."""
    total = 0.0
    t = start_h
    end = start_h + duration_h
    while t < end:
        h = int(t)
        frac = min(end, h + 1) - t
        total += power_kw * frac * series[min(h, HOURS - 1)]
        t = h + 1.0
    return total


def candidate_starts(policy: str) -> List[float]:
    """hours-from-now of allowed starts.  t=0 is Wednesday 15:00."""
    starts = [0.0]
    for h in range(HOURS - 48):
        tod = (h + _T0_HOUR) % 24
        dow = ((h + _T0_HOUR) // 24 + _T0_WEEKDAY) % 7
        if tod != 9:
            continue
        if policy == "semi_weekly" and dow in (0, 3):      # Mon / Thu 9:00
            starts.append(float(h))
        elif policy == "next_monday" and dow == 0:
            starts.append(float(h))
    return starts


def _next_slot_and_window(policy: str) -> Tuple[int, int]:
    """first allowed slot and the window length until the following slot
    (the shifting granularity of Let's Wait Awhile): semi-weekly windows are
    ~84h (Mon<->Thu), next-monday windows a full week — the larger window is
    exactly why the Monday policy saves more (Fig. 8 vs Fig. 7)."""
    slots = [h for h in candidate_starts(policy) if h > 0]
    first = int(slots[0])
    window = int(slots[1] - slots[0]) if len(slots) > 1 else 168
    return first, window


@dataclass
class ShiftOutcome:
    region: str
    start_h: float
    emissions_now_g: float
    emissions_shifted_g: float

    @property
    def savings_pct(self) -> float:
        return 100.0 * (1.0 - self.emissions_shifted_g /
                        max(self.emissions_now_g, 1e-9))


def shift_workload(region: str, policy: str, predicted_h,
                   actual_h: float, power_kw: float,
                   seed: int = 0, q: float = 0.5) -> ShiftOutcome:
    """Let's-Wait-Awhile semantics: the workload moves to the policy's next
    slot and is *interruptible* within the window to the following slot.
    The scheduler books the ceil(predicted) lowest-carbon hours of the
    window; execution consumes booked hours chronologically for the *actual*
    duration — under-prediction overflows into unplanned (arbitrary-carbon)
    hours right after the window (prediction error costs carbon).

    `predicted_h` is a float (booked as-is; `q` ignored) or a predictive
    distribution with `.quantile(q)` (`sched.plane.RuntimeDist`): the
    booking then covers the q-quantile duration, so an uncertainty-aware
    planner reserves enough low-carbon capacity to absorb its own
    prediction error instead of overflowing at the mean."""
    if hasattr(predicted_h, "quantile"):
        predicted_h = float(predicted_h.quantile(q))
    series = intensity_series(region, seed)
    start, window = _next_slot_and_window(policy)
    window = min(window, HOURS - start - 48)
    seg = series[start:start + window]
    predicted_h = max(min(predicted_h, float(window)), 0.1)
    order = np.argsort(seg)                               # cheapest first
    # booked capacity is *reserved* (powered): predicted_h worth of the
    # cheapest hours, the last one fractional.  Over-prediction wastes
    # reserved low-carbon capacity; work beyond the booking overflows into
    # unplanned hours right after the window.
    total = 0.0
    left = predicted_h
    for h in order:
        if left <= 0:
            break
        frac = min(left, 1.0)
        total += power_kw * frac * seg[h]
        left -= frac
    remaining = actual_h - predicted_h
    h = window
    while remaining > 0:                                  # overflow (unplanned)
        frac = min(remaining, 1.0)
        total += power_kw * frac * series[min(start + h, HOURS - 1)]
        remaining -= frac
        h += 1
    now = emissions_g(series, 0.0, actual_h, power_kw)
    return ShiftOutcome(region=region, start_h=float(start),
                        emissions_now_g=now, emissions_shifted_g=total)
