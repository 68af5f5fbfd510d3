"""``tempo_tpu_torch.profiling.trace`` / ``annotate`` on the CPU: the
trace is a Chrome trace JSON under the log directory holding the
annotated span around a chain of the port's ops; a Perfetto link is
refused by name."""

import glob
import json

import numpy as np
import pandas as pd
import pytest

from tempo_tpu_torch import TSDF, profiling


def _frame():
    rng = np.random.default_rng(0)
    n = 40
    df = pd.DataFrame({
        "sym": rng.choice(["a", "b"], n),
        "event_ts": pd.to_datetime(np.sort(rng.integers(0, 600, n)) * 10**9),
        "x": rng.standard_normal(n),
    })
    return TSDF(df, "event_ts", ["sym"], device="cpu")


def test_trace_writes_a_chrome_trace_with_the_span(tmp_path):
    t = _frame()
    with profiling.trace(str(tmp_path)) as prof:
        with profiling.annotate("tempo-chain"):
            out = t.withRangeStats(colsToSummarize=["x"],
                                   rangeBackWindowSecs=30).EMA("x", exact=True)
    assert len(out.df) == 40
    files = glob.glob(str(tmp_path / "*.json"))
    assert len(files) == 1
    with open(files[0]) as f:
        events = json.load(f)["traceEvents"]
    spans = [e for e in events if e.get("name") == "tempo-chain"]
    assert spans and spans[0]["dur"] > 0
    assert any(e.key == "tempo-chain" for e in prof.key_averages())


def test_perfetto_link_raises(tmp_path):
    with pytest.raises(ValueError, match="create_perfetto_link"):
        with profiling.trace(str(tmp_path), create_perfetto_link=True):
            pass
    assert not glob.glob(str(tmp_path / "*.json"))


def test_annotate_outside_a_trace_is_a_no_op():
    with profiling.annotate("alone"):
        x = 1 + 1
    assert x == 2
