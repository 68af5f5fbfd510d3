"""Repairs of the port's faults against the reference (ROADMAP C):

* grouped reductions (``ops/rolling.segment_stats``) sum each segment
  in a fixed order, so a call on the card repeats bitwise; on the CPU
  they still match the reference's ``segment_stats`` (float64 within
  1e-12 relative, as ``test_torch_bucket.py`` holds it; counts, min and
  max bitwise) and add a segment's rows left to right (float32 bitwise
  against a sequential numpy sum);
* ``on_mesh()`` with no mesh: every visible card for a CUDA frame (the
  reference's 1-D series mesh over all local devices), one shard for a
  CPU frame;
* ``DistributedTSDF.lookback_tensor`` returns one ``[K_dev, L, w, F]``
  pair, as the reference does.
"""

import numpy as np
import pandas as pd
import pytest
import torch

import jax.numpy as jnp

from tempo_tpu.ops import rolling as ref_rk
from tempo_tpu_torch import TSDF as PortTSDF
from tempo_tpu_torch import dist, make_mesh
from tempo_tpu_torch.ops import rolling as rk
from tempo_tpu_torch.parallel import Mesh, default_mesh


def _segments(seed, n, n_seg, dtype):
    rng = np.random.default_rng(seed)
    seg = np.sort(rng.integers(0, n_seg + 1, n)).astype(np.int32)
    x = (rng.standard_normal(n) * 100).astype(dtype)
    valid = rng.random(n) > 0.2
    x[~valid] = np.nan
    return seg, x, valid


@pytest.mark.parametrize("seed,n,n_seg", [(0, 500, 9), (1, 64, 40),
                                          (2, 2000, 3)])
def test_segment_stats_match_reference(seed, n, n_seg):
    """Ids run to n_seg inclusive: the last id is out of range and
    dropped on both sides; some segments are empty."""
    seg, x, valid = _segments(seed, n, n_seg, np.float64)
    want = ref_rk.segment_stats(jnp.asarray(x), jnp.asarray(valid),
                                jnp.asarray(seg), n_seg)
    got = rk.segment_stats(torch.from_numpy(x), torch.from_numpy(valid),
                           torch.from_numpy(seg), n_seg)
    for k in want:
        g, w = got[k].numpy(), np.asarray(want[k])
        if k in ("count", "min", "max"):
            np.testing.assert_array_equal(g, w, err_msg=k)
        else:
            np.testing.assert_allclose(g, w, rtol=1e-12, atol=0,
                                       equal_nan=True, err_msg=k)


def test_segment_sums_run_left_to_right():
    seg, x, valid = _segments(5, 3000, 7, np.float32)
    got = rk.segment_stats(torch.from_numpy(x), torch.from_numpy(valid),
                           torch.from_numpy(seg), 7)
    for k in range(7):
        rows = seg == k
        acc = np.float32(0)
        for v in np.where(valid[rows], x[rows], np.float32(0)):
            acc = np.float32(acc + v)
        assert got["count"][k] == valid[rows].sum()
        if valid[rows].any():
            assert got["sum"][k].numpy().view(np.int32) == \
                np.float32(acc).view(np.int32)
    # the same call twice: bitwise
    again = rk.segment_stats(torch.from_numpy(x), torch.from_numpy(valid),
                             torch.from_numpy(seg), 7)
    for k in got:
        assert torch.equal(got[k].nan_to_num(7.0), again[k].nan_to_num(7.0))


def test_default_mesh_takes_every_visible_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    mesh = default_mesh(torch.device("cuda", 0))
    assert mesh.shape == {"series": 4}
    assert [str(d) for d in mesh.axis_devices("series")] == [
        "cuda:0", "cuda:1", "cuda:2", "cuda:3"]
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    assert default_mesh("cuda").shape == {"series": 1}
    cpu = default_mesh("cpu")
    assert cpu.shape == {"series": 1}
    assert cpu.axis_devices("series") == [torch.device("cpu")]


def _frame(n=120, seed=2):
    rng = np.random.default_rng(seed)
    return pd.DataFrame({
        "symbol": rng.choice(list("abcde"), size=n),
        "event_ts": pd.to_datetime(np.sort(rng.integers(0, 600, n)) * 10**9),
        "price": rng.standard_normal(n),
        "volume": rng.integers(1, 9, n).astype(float),
    })


def test_on_mesh_without_a_mesh_takes_the_default(monkeypatch):
    t = PortTSDF(_frame(), "event_ts", ["symbol"], device="cpu")
    assert t.on_mesh().mesh == Mesh(np.array([torch.device("cpu")],
                                             dtype=object), ("series",))
    seen = []
    two = make_mesh({"series": 2}, devices=["cpu", "cpu"])
    monkeypatch.setattr(dist, "default_mesh",
                        lambda device: seen.append(device) or two)
    assert t.on_mesh().mesh == two
    assert seen == [t.device]


@pytest.mark.parametrize("n_shards", [1, 4])
def test_lookback_tensor_is_one_pair(n_shards):
    t = PortTSDF(_frame(), "event_ts", ["symbol"], device="cpu")
    mesh = make_mesh({"series": n_shards}, devices=["cpu"] * n_shards)
    d = t.on_mesh(mesh)
    vals, mask = d.lookback_tensor(["price", "volume"], 3)
    K_dev = sum(int(s.shape[0]) for s in d.ts)
    L = int(d.ts[0].shape[1])
    assert isinstance(vals, torch.Tensor) and isinstance(mask, torch.Tensor)
    assert vals.shape == mask.shape == (K_dev, L, 3, 2)
    assert vals.device == mesh.axis_devices("series")[0]
    # row t's window holds rows t-3 .. t-1 of its series, oldest first
    one, _ = t.on_mesh(make_mesh({"series": 1}, devices=["cpu"])
                       ).lookback_tensor(["price", "volume"], 3)
    K = t.layout.n_series
    assert torch.equal(vals[:K].nan_to_num(9.0), one[:K].nan_to_num(9.0))
