"""The generators: deterministic by seed, at the sizes the
configurations state, with the sizes independent of the seed."""

import json
from pathlib import Path

import numpy as np
import pandas as pd
import pytest

from gpubench import harness
from gpubench.generators import hhar

CONFIGS = Path(__file__).resolve().parents[1] / "configs"
BIG = 2**31 + 977


def _cfg(name):
    return json.loads((CONFIGS / f"{name}.json").read_text())


@pytest.mark.parametrize("name,scale", [("hhar_quickstart", 0.002),
                                        ("hhar_quickstart", 0.0005)])
def test_same_seed_same_frames(name, scale):
    cfg = _cfg(name)
    gen = harness.generator(cfg["generator"])
    a = gen.make(cfg, BIG, scale)
    b = gen.make(cfg, BIG, scale)
    c = gen.make(cfg, BIG + 1, scale)
    for x, y, z in zip(a, b, c):
        pd.testing.assert_frame_equal(x, y)
        assert len(x) == len(z)
        assert not x.equals(z)


def test_hhar_sizes_as_stated():
    cfg = _cfg("hhar_quickstart")
    assert sum(cfg["left"]["rows_by_key"].values()) == 13_062_475
    assert sum(cfg["right"]["rows_by_key"].values()) == 3_540_962
    assert cfg["left"]["rows"] == 13_062_475
    assert cfg["right"]["rows"] == 3_540_962
    assert len(cfg["left"]["rows_by_key"]) == 9
    scale = 0.001
    left, right = hhar.make(cfg, 5, scale)
    counts = left.groupby("User").size().to_dict()
    assert counts == {u: int(r * scale)
                      for u, r in cfg["left"]["rows_by_key"].items()}
    assert len(right) == sum(int(r * scale) for r in
                             cfg["right"]["rows_by_key"].values())
    assert list(left.columns) == ["User", "event_ts", "x", "y", "z"]
    assert left["event_ts"].dtype == np.dtype("datetime64[ns]")
    assert left["x"].dtype == np.float64
    # sorted within each user, and the watch lags the phone: some phone
    # rows precede every watch row of their segment
    assert left.groupby("User")["event_ts"].apply(
        lambda s: s.is_monotonic_increasing).all()
