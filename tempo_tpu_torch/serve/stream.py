"""``StreamingTSDF``: the serving frame of one stream.

Counterpart of ``tempo_tpu/serve/stream.py``.  A long-lived stream over
a fixed set of series: ``push(...)`` takes right-side ticks (advancing
the AS-OF join carry, the EMA carry and the ring-buffer window state,
emitting stats and EMA for exactly the new rows), ``push_left(...)``
answers AS-OF queries for new left rows from the carry.  Emissions are
bitwise what the batch operators give over the concatenated history at
any push split, ties, NaN runs, sequence columns and ``maxLookback``
expiry across pushes included (``tests/test_torch_serve.py`` holds them
against ``ops/sortmerge.asof_merge_values``,
``serve.state.window_stats_batch`` and ``ops/scan.ema_scan``).

The state lives on the stream's device: the CUDA card by default,
``device="cpu"`` for the plain versions.  On a card each step is a CUDA
graph replayed from the planner's cache (``serve/state.py``).

**Ordering contract**: events arrive in each series' merged-stream
order, non-decreasing ``(ts, seq, side)`` with right rows before left
rows on full key ties (the batch sort's tie-break, rec_ind -1 < 1).  A
tick that breaks it raises :class:`LateTickError` naming the offender;
it is never reordered.  The constraint is per series.

**Commit after success**: a push validates the whole batch and runs the
step before anything of the stream moves; a late tick, a bad payload or
a failed step leaves the watermarks and the state as they were.

**Durability**: ``snapshot()`` writes the whole carry (CRC'd, atomic,
keep-last-K through ``checkpoint.save_state``, the reference's format,
so either package resumes the other's snapshot); ``StreamingTSDF.resume``
restores the newest intact one and reports ``acked``, the number of
events already folded in, so a restarted server replays only the tail
and lands on byte-identical output.  ``TEMPO_TPU_SERVE_CKPT_EVERY``
makes snapshots automatic.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from tempo_tpu_torch import checkpoint as ckpt
from tempo_tpu_torch import config, resilience
from tempo_tpu_torch import device as device_mod
from tempo_tpu_torch.packing import TS_PAD
from tempo_tpu_torch.serve import state as sst

_SIDE_RIGHT = 0
_SIDE_LEFT = 1
_SIDE_NAMES = {_SIDE_RIGHT: "right", _SIDE_LEFT: "left"}


class LateTickError(ValueError):
    """An event arrived behind its series' merged-stream watermark.

    The engine answers queries from a carry that only moves forward;
    accepting a late tick would change answers already given, so it is
    refused by name instead of reordered."""

    def __init__(self, series, ts, seq, side, wm):
        self.series, self.ts, self.seq, self.side = series, ts, seq, side
        super().__init__(
            f"late {_SIDE_NAMES[side]} tick for series {series!r}: key "
            f"(ts={ts}, seq={seq}) is behind the watermark "
            f"(ts={wm[0]}, seq={wm[1]}, side={_SIDE_NAMES[wm[2]]}) — "
            f"out-of-order events are rejected, not reordered")


def _bucket(n: int) -> int:
    """Padded per-series row count: the next power of two, at least 8, a
    small fixed set of shapes, so the steady state reuses a handful of
    cached steps."""
    b = 8
    while b < n:
        b *= 2
    return b


def admit_batch(series_names, wm_ts, wm_seq, wm_side, rows, ts, seq,
                side: int, n_series: int):
    """Check one side-homogeneous batch against per-series merged-stream
    watermarks and give each tick its lane in the batch.

    Returns ``(lanes, counts, (wm_ts', wm_seq', wm_side'))`` with
    advanced copies of the watermarks; the caller installs them only after
    its step succeeded (commit after success).  Raises
    :class:`LateTickError` naming the series of the first tick, in input
    order, that is behind its series' last key (the batch's earlier ticks
    of that series included).

    Vectorised (a stable sort by series, then each tick against the one
    before it in its series, or the watermark for the first), with the
    reference's per-tick loop as its meaning: the keys compared are
    ``(ts, seq, side)`` tuples, equal keys admitted."""
    rows = np.asarray(rows, np.int64)
    ts = np.asarray(ts, np.int64)
    seq = np.asarray(seq, np.float64)
    n = len(rows)
    wm_ts, wm_seq, wm_side = wm_ts.copy(), wm_seq.copy(), wm_side.copy()
    lanes = np.zeros(n, np.int64)
    counts = np.bincount(rows, minlength=n_series).astype(np.int64)
    if n == 0:
        return lanes, counts, (wm_ts, wm_seq, wm_side)
    order = np.argsort(rows, kind="stable")
    r_s, ts_s, seq_s = rows[order], ts[order], seq[order]
    first = np.ones(n, bool)
    first[1:] = r_s[1:] != r_s[:-1]
    prev_ts = np.where(first, wm_ts[r_s], np.roll(ts_s, 1))
    prev_seq = np.where(first, wm_seq[r_s], np.roll(seq_s, 1))
    prev_side = np.where(first, wm_side[r_s], side)
    late = (ts_s < prev_ts) | ((ts_s == prev_ts) & (
        (seq_s < prev_seq) | ((seq_s == prev_seq) & (side < prev_side))))
    if late.any():
        i_s = int(order[late].min())            # first late tick, input order
        j = int(np.flatnonzero(order == i_s)[0])
        k = int(rows[i_s])
        wm = ((int(wm_ts[k]), float(wm_seq[k]), int(wm_side[k])) if first[j]
              else (int(ts_s[j - 1]), float(seq_s[j - 1]), side))
        raise LateTickError(series_names[k], ts[i_s], seq[i_s], side, wm)
    starts = np.flatnonzero(first)
    run_start = np.maximum.accumulate(np.where(first, np.arange(n), 0))
    lanes[order] = np.arange(n) - run_start
    last = np.r_[starts[1:], n] - 1
    k_last = r_s[last]
    wm_ts[k_last] = ts_s[last]
    wm_seq[k_last] = seq_s[last]
    wm_side[k_last] = side
    return lanes, counts, (wm_ts, wm_seq, wm_side)


class StreamingTSDF:
    """See the module docstring.  ``series`` fixes the lane rows for the
    stream's life, ``value_cols`` the metric columns.  Operators are
    opt-in: ``window_secs`` / ``window_rows_bound`` the causal range-window
    stats (``rows_bound`` declares the most rows a window may reach back;
    wider true windows are cut and counted on ``clipped``), ``ema_alpha``
    the EMA, ``max_lookback`` the merged-row join horizon, ``skip_nulls``
    the per-column vs lockstep fill.  ``device``: the CUDA card by
    default; ``"cpu"`` runs the steps eagerly on the CPU."""

    def __init__(self, series: Sequence, value_cols: Sequence[str], *,
                 skip_nulls: bool = True, max_lookback: int = 0,
                 window_secs=None, window_rows_bound: int = 64,
                 ema_alpha=None, checkpoint_dir: Optional[str] = None,
                 ckpt_every: Optional[int] = None, keep_last: int = 3,
                 device=None):
        self.device = device_mod.resolve(device)
        if self.device.type == "cuda" and self.device.index is None:
            self.device = torch.device("cuda", torch.cuda.current_device())
        self.series = list(series)
        self.value_cols = [str(c) for c in value_cols]
        if len(set(self.series)) != len(self.series):
            raise ValueError("duplicate series keys")
        self._row = {s: k for k, s in enumerate(self.series)}
        K, C = len(self.series), len(self.value_cols)
        self.cfg = sst.StreamConfig(
            n_series=K, n_cols=C, skip_nulls=bool(skip_nulls),
            max_lookback=int(max_lookback),
            window_ns=(None if window_secs is None
                       else sst.window_ns(window_secs)),
            rows_bound=int(window_rows_bound),
            ema_alpha=(None if ema_alpha is None else float(ema_alpha)))
        self._state = sst.to_device(sst.init_state(self.cfg), self.device)
        self._wm_ts = np.full(K, sst._FAR_PAST, np.int64)
        self._wm_seq = np.full(K, -np.inf, np.float64)
        self._wm_side = np.zeros(K, np.int8)
        self.acked = 0            # events folded into the carry
        self.checkpoint_dir = checkpoint_dir
        self.keep_last = int(keep_last)
        if ckpt_every is None:
            ckpt_every = config.get_int("TEMPO_TPU_SERVE_CKPT_EVERY", 0)
        self.ckpt_every = int(ckpt_every or 0)
        self._next_ckpt = self.ckpt_every or None
        # the stream's own references to its steps, keyed (kind, bucket):
        # the planner's cache shares steps across streams and counts them,
        # but it may be off (TEMPO_TPU_PLAN_CACHE_SIZE=0) or evict them;
        # a live stream's steady state builds nothing either way
        self._exes: Dict[tuple, sst.StepExecutable] = {}

    # -- ordering ------------------------------------------------------

    def _admit(self, rows, ts, seq, side: int):
        """Check merged-stream order per series and give each tick its
        lane: ``(lanes, counts, commit)``, where ``commit()`` advances the
        watermarks; callers call it only after the step succeeded."""
        lanes, counts, wm_new = admit_batch(
            self.series, self._wm_ts, self._wm_seq, self._wm_side,
            rows, ts, seq, side, self.cfg.n_series)

        def commit():
            self._wm_ts, self._wm_seq, self._wm_side = wm_new

        return lanes, counts, commit

    def _executable(self, kind: str, Lb: int) -> sst.StepExecutable:
        exe = self._exes.get((kind, Lb))
        if exe is None:
            build = (sst.push_executable if kind == "push"
                     else sst.query_executable)
            exe = build(self.cfg, Lb, self.device)
            self._exes[(kind, Lb)] = exe
        return exe

    def _rows_of(self, series_ids) -> List[int]:
        try:
            return [self._row[s] for s in series_ids]
        except KeyError as e:
            raise ValueError(
                f"unknown series {e.args[0]!r}: a StreamingTSDF's "
                f"series set is fixed at construction") from None

    @staticmethod
    def _check_lengths(n, ts, seq):
        if len(ts) != n:
            raise ValueError(
                f"series_ids and ts are parallel arrays: got {n} "
                f"series ids but {len(ts)} timestamps")
        if seq is not None and len(seq) != n:
            raise ValueError(
                f"seq must align with series_ids: {len(seq)} != {n}")

    def _values_planes(self, values, n):
        """Every value column as an aligned float32 array, checked before
        any state (the watermarks included) moves."""
        out = []
        for col in self.value_cols:
            if col not in values:
                raise ValueError(
                    f"push() is missing value column {col!r} "
                    f"(stream columns: {self.value_cols})")
            v = np.atleast_1d(np.asarray(values[col], np.float32))
            if len(v) != n:
                raise ValueError(
                    f"values[{col!r}] must align with series_ids: "
                    f"{len(v)} != {n}")
            out.append(v)
        return out

    @staticmethod
    def _seq_array(seq, n):
        if seq is None:
            return np.full(n, -np.inf, np.float64)
        s = np.asarray(seq, np.float64)
        return np.where(np.isnan(s), -np.inf, s)   # NULLS FIRST

    def _to_device(self, *arrays) -> List[torch.Tensor]:
        return [torch.from_numpy(a).to(self.device) for a in arrays]

    # -- ingest --------------------------------------------------------

    def push(self, series_ids, ts, values: Dict[str, np.ndarray],
             seq=None) -> Dict[str, np.ndarray]:
        """Take right-side ticks (one event an element of the parallel
        arrays; ``values`` maps column name -> array, NaN = null).  Returns
        per-event emissions of the enabled operators (``<col>_ema``,
        ``<col>_mean`` ... in input order), bitwise what the batch
        operators give for those rows over the concatenated history."""
        rows = self._rows_of(series_ids)
        ts = np.atleast_1d(np.asarray(ts, np.int64))
        n = len(rows)
        self._check_lengths(n, ts, seq)
        planes = self._values_planes(values, n)
        seqf = self._seq_array(seq, n)
        lanes, counts, commit = self._admit(rows, ts, seqf, _SIDE_RIGHT)

        K, C = self.cfg.n_series, self.cfg.n_cols
        Lb = _bucket(int(counts.max()) if n else 1)
        ts_p = np.full((K, Lb), TS_PAD, np.int64)
        xs = np.full((C, K, Lb), np.nan, np.float32)
        mask = np.zeros((K, Lb), bool)
        ts_p[rows, lanes] = ts
        mask[rows, lanes] = True
        for c, v in enumerate(planes):
            xs[c, rows, lanes] = v

        exe = self._executable("push", Lb)
        names = self.cfg.state_names()
        outs = exe(*(self._state[k] for k in names),
                   *self._to_device(ts_p, xs, mask, counts))
        emit_keys = self.cfg.emit_keys()
        picked = None
        if emit_keys:
            r_t, l_t = self._to_device(np.asarray(rows, np.int64), lanes)
            picked = outs[len(names)][:, :, r_t, l_t].cpu().numpy()
        commit()
        self._state = dict(zip(names, outs[:len(names)]))
        self.acked += n
        self._maybe_snapshot()

        out: Dict[str, np.ndarray] = {}
        for e, key in enumerate(emit_keys):
            for c, col in enumerate(self.value_cols):
                out[f"{col}_{key}"] = picked[e, c]
        return out

    def push_left(self, series_ids, ts, seq=None) -> Dict[str, np.ndarray]:
        """Answer AS-OF queries for new left rows: per event, each
        column's joined value and found flag and the last right row index
        within the lookback horizon, bitwise the batch join's answer for
        these rows over the concatenated history."""
        rows = self._rows_of(series_ids)
        ts = np.atleast_1d(np.asarray(ts, np.int64))
        n = len(rows)
        self._check_lengths(n, ts, seq)
        seqf = self._seq_array(seq, n)
        lanes, counts, commit = self._admit(rows, ts, seqf, _SIDE_LEFT)
        Lb = _bucket(int(counts.max()) if n else 1)

        exe = self._executable("query", Lb)
        new_n_merged, vals, found, idx = exe(
            *(self._state[name] for name in sst._QUERY_STATE),
            *self._to_device(counts))
        r_t, l_t = self._to_device(np.asarray(rows, np.int64), lanes)
        vals = vals[:, r_t, l_t].cpu().numpy()
        found = found[:, r_t, l_t].cpu().numpy()
        idx = idx[r_t, l_t].cpu().numpy()
        commit()
        self._state["n_merged"] = new_n_merged
        self.acked += n
        self._maybe_snapshot()

        out: Dict[str, np.ndarray] = {}
        for c, col in enumerate(self.value_cols):
            out[col] = vals[c]
            out[f"{col}_found"] = found[c]
        out["right_row_idx"] = idx
        return out

    # -- introspection -------------------------------------------------

    @property
    def clipped(self) -> int:
        """Rows whose true stats window passed the declared
        ``window_rows_bound`` (cut short: the declared-bound audit)."""
        if not self.cfg.has_window:
            return 0
        return int(self._state["clipped"].sum().item())

    def warmup(self, max_rows: int) -> int:
        """Build (on a card, capture) the push and query steps of every
        padded-batch bucket up to ``max_rows``, so a fresh process is in
        the steady state before traffic.  Returns the bucket count."""
        shapes = []
        b = _bucket(1)
        while True:
            shapes.append(b)
            if b >= max_rows:
                break
            b *= 2
        for Lb in shapes:
            self._executable("push", Lb)
            self._executable("query", Lb)
        return len(shapes)

    def graph_pool_bytes(self) -> int:
        """Bytes the private pools of this stream's CUDA graphs hold (0 on
        the CPU)."""
        return sum(e.pool_bytes or 0 for e in self._exes.values())

    # -- durability ----------------------------------------------------

    def _config_meta(self) -> dict:
        return {
            "value_cols": self.value_cols,
            "skip_nulls": self.cfg.skip_nulls,
            "max_lookback": self.cfg.max_lookback,
            "window_ns": self.cfg.window_ns,
            "rows_bound": self.cfg.rows_bound,
            "ema_alpha": self.cfg.ema_alpha,
        }

    def snapshot(self) -> str:
        """Write a CRC'd atomic snapshot of the whole carry under
        ``checkpoint_dir`` (step = events acked), pruning to
        ``keep_last``.  The I/O rides the resilience retry policy."""
        if not self.checkpoint_dir:
            raise ValueError("StreamingTSDF has no checkpoint_dir")
        arrays = {k: v.cpu().numpy() for k, v in self._state.items()}
        arrays["wm_ts"] = self._wm_ts
        arrays["wm_seq"] = self._wm_seq
        arrays["wm_side"] = self._wm_side
        meta = {"serve_config": self._config_meta(),
                "series": self.series, "acked": self.acked}
        path = os.path.join(self.checkpoint_dir,
                            f"step_{self.acked:010d}")
        resilience.retrying(resilience.DEFAULT_IO_POLICY,
                            label="serve-snapshot")(ckpt.save_state)(
            arrays, path, meta)
        ckpt.prune(self.checkpoint_dir, keep_last=self.keep_last)
        return path

    def _maybe_snapshot(self):
        if self._next_ckpt is not None and self.acked >= self._next_ckpt \
                and self.checkpoint_dir:
            self.snapshot()
            self._next_ckpt = self.acked + self.ckpt_every

    @classmethod
    def resume(cls, checkpoint_dir: str, verify: bool = True,
               **overrides) -> "StreamingTSDF":
        """Restore the newest intact snapshot under ``checkpoint_dir``
        (corrupt candidates are skipped with a warning).  The returned
        stream's ``acked`` says where to restart the event source: replay
        everything after it and the output tail is byte-identical to a
        run that never died.  ``device=`` and the other constructor
        keywords pass through."""
        path = ckpt.latest(checkpoint_dir, verify=verify)
        if path is None:
            raise ckpt.CheckpointError(
                f"no intact stream snapshot under {checkpoint_dir!r}")
        arrays, meta = ckpt.load_state(path, verify=verify)
        scfg = meta["serve_config"]
        stream = cls(
            meta["series"], scfg["value_cols"],
            skip_nulls=scfg["skip_nulls"],
            max_lookback=scfg["max_lookback"],
            window_secs=None, ema_alpha=scfg["ema_alpha"],
            window_rows_bound=scfg["rows_bound"],
            checkpoint_dir=overrides.pop("checkpoint_dir",
                                         checkpoint_dir),
            **overrides)
        if scfg["window_ns"] is not None:
            # the exact integer width (window_secs would floor again; the
            # snapshot holds the folded int)
            stream.cfg = dataclasses.replace(stream.cfg,
                                             window_ns=scfg["window_ns"])
        stream._state = sst.to_device(
            {name: arrays[name] for name in stream.cfg.state_names()},
            stream.device)
        stream._wm_ts = np.asarray(arrays["wm_ts"], np.int64)
        stream._wm_seq = np.asarray(arrays["wm_seq"], np.float64)
        stream._wm_side = np.asarray(arrays["wm_side"], np.int8)
        stream.acked = int(meta["acked"])
        if stream.ckpt_every:
            stream._next_ckpt = stream.acked + stream.ckpt_every
        return stream
