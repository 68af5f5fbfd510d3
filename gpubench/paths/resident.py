"""The ``resident`` path: both frames put on the card once, at set-up,
as ``DistributedTSDF``s on a one-card mesh (``TSDF.on_mesh``, the
Spark user's ``.cache()``); each chain joins, takes the range
statistics and the exact EMA on them and ends when its output planes
are ready on the card.  ``result`` fetches a chain's output to the host
(``collect()``), after the window.

What the harness asks of every path: ``units`` (the work units one
chain completes; the mix's rate is ``units`` times the chains over
their time), ``work()`` (the least bytes and operations one chain
needs, for the roofline), ``chain(step)``, ``result(out)`` and
``close()``.
"""

from __future__ import annotations

from gpubench.lib.roofline import TS_BYTES, VALUE_BYTES

#: statistics ``withRangeStats`` writes a row
N_STATS = 7
#: float operations a row: window sums, mean, variance, stddev, zscore
#: (16 with prefix sums) and the EMA's multiply and add
OPS_PER_ROW = 18


class Path:
    def __init__(self, cfg: dict, left, right, device: str):
        from tempo_tpu_torch import TSDF, make_mesh

        self.cfg = cfg
        self.device = device
        key, ts = [cfg["partition_col"]], cfg["ts_col"]
        self.units = len(left)
        self._sizes = (len(left), len(right), len(
            [c for c in right.columns if c not in (key[0], ts)]))
        mesh = make_mesh({"series": 1}, devices=[device])
        self.left = TSDF(left, ts, key, device=device).on_mesh(mesh)
        self.right = TSDF(right, ts, key, device=device).on_mesh(mesh)

    def work(self) -> dict:
        """``{"bytes", "flops"}`` one chain needs: ``asofJoin`` reads both
        sides' timestamps and the right value columns and writes the
        joined values and the joined right timestamp a left row;
        ``withRangeStats`` reads the left timestamps and one column and
        writes seven statistics a row; ``EMA`` reads that column and
        writes one plane.  Intermediates are not counted: an ideal chain
        keeps them on chip."""
        left, right, cols = self._sizes
        read = (left * (TS_BYTES + VALUE_BYTES)
                + right * (TS_BYTES + VALUE_BYTES * cols))
        write = left * (VALUE_BYTES * cols + TS_BYTES
                        + VALUE_BYTES * N_STATS + VALUE_BYTES)
        return {"bytes": float(read + write),
                "flops": float(OPS_PER_ROW * left)}

    def chain(self, step):
        """One whole chain; ``step(name)`` opens each step's span.  The
        caller synchronises the card at the chain's end."""
        ch = self.cfg["chain"]
        with step("gpubench.join"):
            joined = self.left.asofJoin(self.right,
                                        right_prefix=ch["right_prefix"])
        with step("gpubench.stats"):
            stats = joined.withRangeStats(
                colsToSummarize=[ch["stats_col"]],
                rangeBackWindowSecs=ch["window_secs"])
        with step("gpubench.ema"):
            return stats.EMA(ch["ema_col"], exp_factor=ch["exp_factor"],
                             exact=True)

    def result(self, out):
        """The host frame of a chain's output."""
        return out.collect().df

    def close(self) -> None:
        self.left = self.right = None
