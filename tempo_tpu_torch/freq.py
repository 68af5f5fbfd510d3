"""Frequency-string parsing (parity: python/tempo/resample.py:8-23,120-136).

A copy of ``tempo_tpu/freq.py`` (host-only; the port keeps its own).

``checkAllowableFreq`` semantics: bare units 'sec'|'min'|'hr'|'day' mean
period 1; otherwise '<N> <unit>' strings where the unit may be any word
starting with sec/min/hour-or-hr/day.
"""

from __future__ import annotations

from typing import Tuple

SEC = "sec"
MIN = "min"
HR = "hr"
DAY = "day"

allowableFreqs = [SEC, MIN, HR, DAY]

freq_dict = {
    "sec": "seconds",
    "min": "minutes",
    "hr": "hours",
    "day": "days",
    "hour": "hours",
}

UNIT_SECONDS = {"sec": 1, "min": 60, "hr": 3600, "hour": 3600, "day": 86400}

# aggregation function names (resample.py:13-23)
floor = "floor"
min_func = "min"
max_func = "max"
average = "mean"
ceiling = "ceil"
allowableFuncs = [floor, min_func, max_func, average, ceiling]
# scala-side lead funcs (scala resample.scala:17-20)
CLOSEST_LEAD = "closest_lead"
MIN_LEAD = "min_lead"
MAX_LEAD = "max_lead"
MEAN_LEAD = "mean_lead"


def checkAllowableFreq(freq: str) -> Tuple[int, str]:
    """Returns (periods, canonical_unit). Raises ValueError on junk."""
    if freq in allowableFreqs:
        return (1, freq)
    try:
        periods = freq.lower().split(" ")[0].strip()
        units = freq.lower().split(" ")[1].strip()
        periods = int(periods)
    except Exception:
        raise ValueError(
            "Allowable grouping frequencies are sec (second), min (minute), "
            "hr (hour), day. Reformat your frequency as <integer> <day/hour/minute/second>"
        )
    if units.startswith(SEC):
        return (periods, SEC)
    if units.startswith(MIN):
        return (periods, MIN)
    if units.startswith("hour") or units.startswith(HR):
        return (periods, "hour")
    if units.startswith(DAY):
        return (periods, DAY)
    raise ValueError(
        "Allowable grouping frequencies are sec (second), min (minute), "
        "hr (hour), day. Reformat your frequency as <integer> <day/hour/minute/second>"
    )


def freq_to_seconds(freq: str) -> int:
    periods, unit = checkAllowableFreq(freq)
    return int(periods) * UNIT_SECONDS[unit]


def validateFuncExists(func) -> None:
    if func is None:
        raise ValueError(
            "Aggregate function missing. Provide one of the allowable functions: "
            + ", ".join(allowableFuncs)
        )
    if func not in allowableFuncs + [CLOSEST_LEAD, MIN_LEAD, MAX_LEAD, MEAN_LEAD]:
        raise ValueError(
            "Aggregate function is not in the valid list. Provide one of the "
            "allowable functions: " + ", ".join(allowableFuncs)
        )
