"""The port's layout switches (``tempo_tpu_torch/parallel/reshard.py`` and
``dist.reshard_frame``) against the reference's.

The reference's collectives run on its forced 8-device CPU host, the
port's on ``["cpu"] * 8`` meshes of the same shape.  Every comparison is
bitwise: a layout switch moves blocks and computes nothing, so each
port shard must equal the reference's shard on the device at the same
mesh coordinates (``addressable_shards``, matched by their global
index), and the global arrays must equal the reference's.
"""

import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

import tempo_tpu
from tempo_tpu import dist as ref_dist
from tempo_tpu.parallel import all_to_all_series_to_time as ref_s2t
from tempo_tpu.parallel import all_to_all_time_to_series as ref_t2s
from tempo_tpu.parallel import make_mesh as ref_mesh
from tempo_tpu.parallel import reshard as ref_reshard
from tempo_tpu_torch import TSDF, dist, make_mesh
from tempo_tpu_torch.parallel import (all_to_all_series_to_time,
                                      all_to_all_time_to_series, reshard)
from tempo_tpu_torch.parallel.mesh import block_slices, place
from tempo_tpu_torch.parallel.reshard import assemble

MESHES = [pytest.param({"series": 2, "time": 4}, id="series2xtime4"),
          pytest.param({"series": 1, "time": 8}, id="time8"),
          pytest.param({"series": 4, "time": 2}, id="series4xtime2")]
JOINT = ("series", "time")


def _pspec(spec):
    return P(*spec)


def _assert_shards(port_shards, ref_arr, mesh, spec):
    """Each port shard equals the reference's shard with the same block
    of the global array, bitwise."""
    ref_blocks = {}
    for sh in ref_arr.addressable_shards:
        key = tuple((s.start or 0, s.stop if s.stop is not None else n)
                    for s, n in zip(sh.index, ref_arr.shape))
        ref_blocks[key] = np.asarray(sh.data)
    shape = tuple(ref_arr.shape)
    for t, sl in zip(port_shards, block_slices(mesh, spec, shape)):
        key = tuple((s.start, s.stop) for s in sl)
        np.testing.assert_array_equal(t.numpy(), ref_blocks[key])


def _arr(K=16, L=32, seed=0):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((K, L))


@pytest.mark.parametrize("axes", MESHES)
def test_all_to_alls_are_the_reference_ones(axes):
    a = _arr()
    jm = ref_mesh(axes)
    pm = make_mesh(axes, devices=["cpu"] * 8)
    src = jnp.asarray(a)
    ref_in = ref_reshard(src, jm, P("series", "time"))
    ref_local = ref_s2t(ref_in, jm)
    blocks = place(a, pm, ("series", "time"))
    local = all_to_all_series_to_time(blocks, pm)
    _assert_shards(local, ref_local, pm, (JOINT, None))
    np.testing.assert_array_equal(
        assemble(local, pm, (JOINT, None)).numpy(), np.asarray(ref_local))
    back = all_to_all_time_to_series(local, pm)
    ref_back = ref_t2s(ref_local, jm)
    _assert_shards(back, ref_back, pm, ("series", "time"))
    for x, y in zip(back, blocks):
        assert torch.equal(x, y)


@pytest.mark.parametrize("axes", MESHES)
def test_all_to_alls_of_stacks(axes):
    """[C, K, L] stacks move along their last two dimensions."""
    a = np.stack([_arr(seed=s) for s in range(3)])
    pm = make_mesh(axes, devices=["cpu"] * 8)
    blocks = place(a, pm, (None, "series", "time"))
    local = all_to_all_series_to_time(blocks, pm)
    np.testing.assert_array_equal(
        assemble(local, pm, (None, JOINT, None)).numpy(), a)
    for x, y in zip(all_to_all_time_to_series(local, pm), blocks):
        assert torch.equal(x, y)


@pytest.mark.parametrize("spec", [
    ("series", None), (None, "time"), (JOINT, None), ("time", "series"),
    (None, None), (None, JOINT)], ids=str)
def test_reshard_is_the_reference_one(spec):
    axes = {"series": 2, "time": 4}
    a = _arr(K=16, L=64)
    jm = ref_mesh(axes)
    pm = make_mesh(axes, devices=["cpu"] * 8)
    ref_out = ref_reshard(ref_reshard(jnp.asarray(a), jm,
                                      P("series", "time")), jm, _pspec(spec))
    got = reshard(place(a, pm, ("series", "time")), pm, spec,
                  ("series", "time"))
    _assert_shards(got, ref_out, pm, spec)
    np.testing.assert_array_equal(assemble(got, pm, spec).numpy(), a)


def _frames():
    rng = np.random.default_rng(5)
    n = 240
    left = pd.DataFrame({
        "sym": rng.choice(["a", "b", "c", "d", "e"], n),
        "event_ts": pd.to_datetime(np.sort(rng.integers(0, 400, n))
                                   * 1_000_000_000),
        "px": np.where(rng.random(n) < 0.1, np.nan, rng.standard_normal(n)),
        "qty": rng.integers(1, 9, n),
        "seq": rng.integers(0, 5, n).astype(float),
    })
    return left


def _planes(d):
    """A frame's planes by name (either package's)."""
    planes = {"ts": d.ts, "mask": d.mask}
    for c, col in d.cols.items():
        planes[c] = col.values
        planes[c + "/valid"] = col.valid
    if d.seq is not None:
        planes["seq"] = d.seq
    return planes


@pytest.mark.parametrize("axes", MESHES)
def test_reshard_frame_is_bitwise_both_ways(axes):
    left = _frames()
    jm = ref_mesh(axes)
    pm = make_mesh(axes, devices=["cpu"] * 8)
    rd = tempo_tpu.TSDF(left, "event_ts", ["sym"], sequence_col="seq") \
        .on_mesh(jm, time_axis="time")
    pd_ = TSDF(left, "event_ts", ["sym"], sequence_col="seq",
               device="cpu").on_mesh(pm, time_axis="time")
    ref_local = ref_dist.reshard_frame(rd, ref_dist.RESHARD_SERIES_LOCAL)
    local = dist.reshard_frame(pd_, dist.RESHARD_SERIES_LOCAL)
    assert local.series_axis == JOINT and local.time_axis is None
    assert dist.reshard_frame(local, dist.RESHARD_SERIES_LOCAL) is local
    back = dist.reshard_frame(local, dist.RESHARD_TIME_SHARDED)
    assert dist.reshard_frame(back, dist.RESHARD_TIME_SHARDED) is back
    assert (back.series_axis, back.time_axis) == ("series", "time")
    ref_back = ref_dist.reshard_frame(ref_local,
                                      ref_dist.RESHARD_TIME_SHARDED)
    for name, want in _planes(ref_local).items():
        got = _planes(local)[name]
        _assert_shards(got, want, pm, (JOINT, None))
        np.testing.assert_array_equal(
            assemble(got, pm, (JOINT, None)).numpy(), np.asarray(want))
    for name, want in _planes(ref_back).items():
        got = _planes(back)[name]
        _assert_shards(got, want, pm, ("series", "time"))
        for x, y in zip(got, _planes(pd_)[name]):
            np.testing.assert_array_equal(x.numpy(), y.numpy())


@pytest.mark.parametrize("axes", MESHES)
@pytest.mark.parametrize("n_cols,has_seq", [(0, False), (3, False),
                                            (2, True)])
def test_relayout_comm_bytes_is_the_reference_model(axes, n_cols, has_seq):
    n = axes["series"] * axes["time"]
    for K, L in ((8, 64), (1024, 12768), (3, 5)):
        assert dist.relayout_comm_bytes(K, L, n_cols, n, has_seq,
                                        dtype=torch.float64) == \
            ref_dist.relayout_comm_bytes(K, L, n_cols, n, has_seq)
    # float32 on the card: 4-byte values
    assert dist.relayout_comm_bytes(8, 64, 1, 1) == 8 * 64 * (8 + 1 + 5)


def test_reference_named_sharding_of_the_series_local_layout():
    """The port's joint axis is JAX's P((series, time)): the same
    devices, series-major."""
    axes = {"series": 2, "time": 4}
    jm = ref_mesh(axes)
    pm = make_mesh(axes, devices=["cpu"] * 8)
    sh = NamedSharding(jm, P(JOINT, None))
    order = [d.id for d in sh.mesh.devices.reshape(-1)]
    assert order == sorted(order)
    assert pm.axis_devices(JOINT) == [torch.device("cpu")] * 8
    m = make_mesh(axes, devices=["cpu"] * 8, ranks=range(8))
    assert m.axis_ranks(JOINT) == list(range(8))
    assert m.axis_ranks(("time", "series")) == [0, 4, 1, 5, 2, 6, 3, 7]


def test_stream_mesh_takes_one_axis():
    m = dist.stream_mesh(2, devices=["cpu"] * 4)
    assert m.shape == {"streams": 2} and m.axis_names == ("streams",)
    assert dist.stream_mesh(devices=["cpu"] * 3, stream_axis="s").shape \
        == {"s": 3}
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            dist.stream_mesh()
