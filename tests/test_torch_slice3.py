"""The third slice at frame level: ``asofJoin`` past the single-program
limit (the auto pick takes the ``chunked`` engine) with ``maxLookback``,
then ``withRangeStats`` past ``TEMPO_TPU_STREAM_MAX_ROWS`` (the windowed
engine), then exact ``EMA``: the port (``device="cpu"``, float64, the
kernels' plain versions) against ``tempo_tpu.TSDF`` (JAX on the CPU,
float64) on the same pandas inputs.

Both packages read the same knobs.  On the CPU the reference's oversize
pick is its host-bracket engine (its chunked kernel needs a TPU), which
gives the same indices.  Joined columns are selections: equal, nulls
included; ``count`` is equal; the other statistics and the EMA agree
within rtol = atol = 1e-9 (the reference's CPU prefix sums and EMA are
associative scans, the port's the Hillis-Steele ladders, so float64 sums
associate differently).
"""

import numpy as np
import pandas as pd
import pytest

import tempo_tpu
from tempo_tpu_torch import TSDF as PortTSDF
from tempo_tpu_torch.ops import merge, scan

from tests.test_torch_frame import JOINED, STAT_COLS, _frames

SLICE_ENV = {"TEMPO_TPU_MAX_MERGED_LANES": "64",
             "TEMPO_TPU_STREAM_MAX_ROWS": "2"}


def _chain(tsdf_cls, left, right, with_seq, skip_nulls, ml, **kw):
    lt = tsdf_cls(left, "event_ts", ["sym"], **kw)
    rt = tsdf_cls(right, "event_ts", ["sym"],
                  sequence_col="seq" if with_seq else None, **kw)
    out = (lt.asofJoin(rt, skipNulls=skip_nulls, maxLookback=ml)
           .withRangeStats(colsToSummarize=["x"], rangeBackWindowSecs=10)
           .EMA("x", exact=True))
    return out.df.sort_values(["sym", "event_ts"], kind="stable") \
        .reset_index(drop=True)


def _spy(monkeypatch, module, name):
    calls = []
    real = getattr(module, name)

    def spy(*args, **kwargs):
        calls.append(args)
        return real(*args, **kwargs)

    monkeypatch.setattr(module, name, spy)
    return calls


@pytest.mark.parametrize("zipf,with_seq,skip_nulls,ml", [
    (False, False, True, 16),
    (False, True, False, 3),
    (True, False, False, 16),
    (True, True, True, 3),
    (False, False, True, 0),     # the chunked engine without a cap
])
def test_slice_chain_matches_reference(monkeypatch, zipf, with_seq,
                                       skip_nulls, ml):
    monkeypatch.setenv("TEMPO_TPU_BINPACK", "1" if zipf else "0")
    for k, v in SLICE_ENV.items():
        monkeypatch.setenv(k, v)
    left, right = _frames(40 + 2 * zipf + with_seq, zipf, with_seq)
    want = _chain(tempo_tpu.TSDF, left, right, with_seq, skip_nulls, ml)
    joins = _spy(monkeypatch, merge, "asof_merge_lookback_plain")
    sums = _spy(monkeypatch, scan, "cumsum3_plain")
    got = _chain(PortTSDF, left, right, with_seq, skip_nulls, ml,
                 device="cpu")
    # the port took the lookback join with the cap as given, and the
    # windowed range engine
    assert [c[3] for c in joins] == [ml]
    assert len(sums) == 1
    assert list(got.columns) == list(want.columns)
    assert len(got) == len(want)
    for c in JOINED:
        pd.testing.assert_series_equal(got[c], want[c], check_dtype=False)
    np.testing.assert_array_equal(got["count_x"].to_numpy(),
                                  want["count_x"].to_numpy())
    for c in STAT_COLS:
        np.testing.assert_allclose(got[c].to_numpy(np.float64),
                                   want[c].to_numpy(np.float64), rtol=1e-9,
                                   atol=1e-9, equal_nan=True, err_msg=c)
