"""HHAR-shaped phone and watch accelerometer frames from a seed.

The shape follows the dbl-tempo quickstart on UCI HHAR: 9 users, the
phone's 13,062,475 rows on the left and the watch's 3,540,962 on the
right, ``User`` as the partition column, ``x``, ``y``, ``z`` as float64
and ``event_ts`` in nanoseconds.  Each user records six activities of
``activity_secs`` with ``gap_secs`` between them; the watch's segments
start ``watch_lag_secs`` after the phone's, so the first rows of a
segment find no watch row and join to nulls.

Sizes never depend on the seed: every seed gives each user the same
rows a side and each activity the same share of them.  The seed draws
the arrival instants, the gravity orientation of each (user, activity,
device) and the motion noise.
"""

from __future__ import annotations

import numpy as np
import pandas as pd

NS_PER_S = 1_000_000_000


def _split(n: int, parts: int) -> list:
    base, rem = divmod(n, parts)
    return [base + (1 if i < rem else 0) for i in range(parts)]


def _side(rng, cfg: dict, side: dict, lag_ns: int, scale: float):
    a = cfg["assumed"]
    n_dev = int(a["devices_per_user"][side["name"]])
    n_act = len(a["activities"])
    act_ns = int(a["activity_secs"] * NS_PER_S)
    step_ns = int((a["activity_secs"] + a["gap_secs"]) * NS_PER_S)
    noise = np.asarray(a["noise_sd_by_activity"], dtype=np.float64)
    users, ts_parts, xyz_parts, counts = [], [], [], []
    for u, (user, rows) in enumerate(side["rows_by_key"].items()):
        rows = max(int(rows * scale), n_act)
        t0 = int(a["epoch_ns"]) + u * int(a["user_offset_secs"] * NS_PER_S)
        for act, m in enumerate(_split(rows, n_act)):
            # uniform order statistics over the segment: sorted without a
            # sort, from normalised cumulative exponential gaps
            gaps = rng.standard_exponential(m + 1)
            pos = np.cumsum(gaps)[:m] / gaps.sum()
            start = t0 + act * step_ns + lag_ns
            ts_parts.append(start + (pos * act_ns).astype(np.int64))
            g = rng.standard_normal((n_dev, 3))
            g *= a["gravity"] / np.linalg.norm(g, axis=1, keepdims=True)
            dev = rng.integers(0, n_dev, size=m)
            xyz_parts.append(g[dev] + noise[act] * rng.standard_normal((m, 3)))
        users.append(user)
        counts.append(rows)
    ts = np.concatenate(ts_parts)
    xyz = np.concatenate(xyz_parts)
    frame = pd.DataFrame({
        cfg["partition_col"]: np.repeat(np.asarray(users, dtype=object),
                                        counts),
        cfg["ts_col"]: ts.view("datetime64[ns]"),
    })
    for j, c in enumerate(side["columns"]):
        frame[c] = xyz[:, j]
    return frame


def make(cfg: dict, seed: int, scale: float = 1.0):
    """``(left, right)`` pandas frames of the configuration ``cfg``;
    ``scale`` < 1 shrinks every user's rows (the CPU tests only)."""
    rng = np.random.default_rng(seed % 2**63)
    lag = int(cfg["assumed"]["watch_lag_secs"] * NS_PER_S)
    left = _side(rng, cfg, cfg["left"], 0, scale)
    right = _side(rng, cfg, cfg["right"], lag, scale)
    return left, right
