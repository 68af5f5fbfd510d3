"""Spectral ops: Fourier transform and autocorrelation.

Counterpart of ``tempo_tpu/spectral.py``:

* ``fourier_transform`` (reference tsdf.py:828-902): the reference runs
  scipy's fft per series in a Python worker.  Here the series are
  grouped by exact length and each group is one batched
  ``torch.fft.fft`` on the frame's device, in its dtype (cuFFT takes
  any length, so the TPU package's matmul DFT, ``ops/fft.py``, has no
  counterpart).
* ``autocorr`` (reference tsdf.py:192-316): the row_number +
  self-join-shifted-by-lag plan is a masked shifted dot product on the
  packed arrays.  The parity quirks are kept: the pair range is bounded
  by the non-null count (tsdf.py:229) while row numbers run over all
  rows, null products drop out of the numerator, series without a pair
  are dropped, and a frame without partition columns reports one
  ``_dummy_group_col`` row.
"""

from __future__ import annotations

import numpy as np
import pandas as pd
import torch


def fourier_transform(tsdf, timestep: float, valueCol: str):
    # resolve case-insensitively like Spark's analyzer (tsdf.py:853),
    # then use the frame's actual column name
    matches = [c for c in tsdf.df.columns if c.lower() == valueCol.lower()]
    if not matches:
        raise ValueError(f"Column {valueCol} not found in Dataframe")
    valueCol = matches[0]

    layout = tsdf.layout
    sorted_df = tsdf.df.iloc[layout.order].reset_index(drop=True)
    lengths = layout.lengths
    ft_real = np.empty(layout.n_rows)
    ft_imag = np.empty(layout.n_rows)
    freq = np.empty(layout.n_rows)
    # the packed column holds the series' values in their first lanes,
    # NaN where null: a null leaves its series' transform undefined (NaN
    # in a pattern that depends on the FFT's factorisation, as numpy's)
    vals, _ = tsdf.packed_numeric(valueCol)
    for n in np.unique(lengths):
        if n == 0:
            continue
        keys = np.flatnonzero(lengths == n)
        rows = layout.starts[keys][:, None] + np.arange(n)[None, :]
        tran = torch.fft.fft(vals[tsdf._upload(keys)][:, :n], dim=-1)
        ft_real[rows] = tran.real.double().cpu().numpy()
        ft_imag[rows] = tran.imag.double().cpu().numpy()
        freq[rows] = np.fft.fftfreq(int(n), d=timestep)[None, :]

    select_cols = tsdf.partitionCols + [tsdf.ts_col]
    if tsdf.sequence_col:
        select_cols.append(tsdf.sequence_col)
    out = sorted_df[select_cols + [valueCol]].copy()
    out["freq"] = freq
    out["ft_real"] = ft_real
    out["ft_imag"] = ft_imag
    return tsdf._with_rows(out)


def autocorr(tsdf, col: str, lag: int = 1) -> pd.DataFrame:
    """A bare DataFrame of the partition columns and
    ``autocorr_lag_<lag>`` (the reference returns a DataFrame, not a
    TSDF)."""
    layout = tsdf.layout
    L = tsdf.packed_len()
    v, ok = tsdf.packed_numeric(col)
    lengths = tsdf._upload(layout.lengths.astype(np.int64))
    nan = torch.full((), float("nan"), dtype=v.dtype, device=v.device)

    cnt = ok.sum(-1)
    mean = torch.where(ok, v, 0.0).sum(-1) / torch.clamp(cnt, min=1)
    sub = torch.where(ok, v - mean[:, None], nan)
    denom = torch.where(ok, sub * sub, 0.0).sum(-1)

    if lag >= L:
        num = torch.full_like(denom, float("nan"))
        any_pair = torch.zeros(denom.shape, dtype=torch.bool,
                               device=v.device)
    else:
        pos = torch.arange(L - lag, device=v.device)
        # a pair is kept when row (pos + 1) <= non-null count - lag, the
        # row exists, and both values are non-null (tsdf.py:228-251)
        keep = ((pos[None, :] + 1 <= cnt[:, None] - lag)
                & (pos[None, :] + lag < lengths[:, None])
                & ok[:, :-lag] & ok[:, lag:])
        num = torch.where(keep, sub[:, :-lag] * sub[:, lag:], 0.0).sum(-1)
        any_pair = keep.any(-1)

    # a series yields a row only when the numerator join is non-empty
    # (the reference's inner joins drop pairless series, tsdf.py:248-253)
    present = ((lengths > lag) & (cnt > lag)).cpu().numpy()
    ac = (torch.where(any_pair, num, nan) / denom).double().cpu().numpy()

    out = layout.key_frame.copy()
    if not tsdf.partitionCols:
        out = pd.DataFrame({"_dummy_group_col": ["dummy"]})
    out[f"autocorr_lag_{lag}"] = ac
    return out[present].reset_index(drop=True)
