"""Plan checkpoint barriers of the port (``tempo_tpu_torch/plan/
checkpoints.py``, the optimizer's ``TEMPO_TPU_CKPT_PLACEMENT`` pass, the
executor's signed saves and resume) against the reference's.

* Barrier placement: the same steps after the same ops as the
  reference's optimizer for the same recorded chain (every boundary,
  ``every=2``, the placement knob off, uncacheable plans).
* Execution: a checkpointed run is bitwise the eager chain and writes a
  signed, CRC-chained step family; a run killed while saving a barrier
  (``testing.faults``) resumes from the newest intact barrier, re-runs
  only the ops above it with no new executable build, and is bitwise
  the uninterrupted run; a corrupt newest barrier falls back to an
  older one; a barrier stamped by another plan, or by the same plan
  over other data, is refused by name.

The reference's cases of ``tests/test_plan_checkpoint.py``, on a
``series: 2`` mesh of two CPU shards.
"""

import os

import numpy as np
import pandas as pd
import pytest

import tempo_tpu
from tempo_tpu.parallel import make_mesh as ref_mesh
from tempo_tpu.plan import checkpoints as ref_ckpt
from tempo_tpu.plan import ir as ref_ir
from tempo_tpu.plan import lazy as ref_lazy
from tempo_tpu.plan import optimizer as ref_opt
from tempo_tpu_torch import TSDF, checkpoint, make_mesh, profiling
from tempo_tpu_torch.dist import DistributedTSDF
from tempo_tpu_torch.plan import cache as plan_cache
from tempo_tpu_torch.plan import checkpoints as plan_ckpt
from tempo_tpu_torch.plan import ir, lazy, optimizer
from tempo_tpu_torch.resilience import CheckpointError
from tempo_tpu_torch.testing import faults


def _mk_df(seed, n=240):
    r = np.random.default_rng(seed)
    return pd.DataFrame({
        "sym": r.choice(["a", "b", "c", "d"], n),
        "event_ts": pd.to_datetime(
            np.sort(r.integers(0, 4000, n)) * 1_000_000_000),
        "px": r.standard_normal(n),
        "qty": r.integers(1, 50, n).astype(float),
    })


@pytest.fixture(scope="module")
def frames():
    mesh = make_mesh({"series": 2}, devices=["cpu"] * 2)
    return (TSDF(_mk_df(1), "event_ts", ["sym"], device="cpu").on_mesh(mesh),
            TSDF(_mk_df(2), "event_ts", ["sym"], device="cpu").on_mesh(mesh))


@pytest.fixture(autouse=True)
def _fresh_cache():
    plan_cache.CACHE.clear()
    yield
    plan_cache.CACHE.clear()


def _chain(left, right, extra_ema=False, mod=lazy):
    # skipNulls=False keeps the chain unfused: three device ops, three
    # barriers
    lz = lambda f: mod.wrap(mod._as_node(f))
    c = (lz(left).asofJoin(lz(right), right_prefix="q", skipNulls=False)
         .withRangeStats(colsToSummarize=["q_px", "q_qty"],
                         rangeBackWindowSecs=60)
         .EMA("q_px", exact=True))
    if extra_ema:
        c = c.EMA("q_qty", exact=True)
    return c


def _srt(df):
    return df.sort_values(["sym", "event_ts"],
                          kind="stable").reset_index(drop=True)


def _eager(left, right):
    return _srt(left.asofJoin(right, right_prefix="q", skipNulls=False)
                .withRangeStats(colsToSummarize=["q_px", "q_qty"],
                                rangeBackWindowSecs=60)
                .EMA("q_px", exact=True).collect().df)


def _barriers(opt):
    return [(n.param("step"), n.inputs[0].op) for n in opt.walk()
            if n.op == "checkpoint"]


@pytest.fixture(scope="module")
def ref_frames():
    mesh = ref_mesh({"series": 2})
    return (tempo_tpu.TSDF(_mk_df(1), "event_ts", ["sym"]).on_mesh(mesh),
            tempo_tpu.TSDF(_mk_df(2), "event_ts", ["sym"]).on_mesh(mesh))


@pytest.mark.parametrize("every", [None, 1, 2, 3])
def test_barrier_placement_is_the_reference_one(frames, ref_frames,
                                                tmp_path, every):
    def place(ckpt_mod, irm, opt_mod, lz_mod, fr):
        root = irm.Node("collect",
                        inputs=(_chain(*fr, mod=lz_mod)._node,))
        if every is None:
            return _barriers(opt_mod.optimize(root))
        with ckpt_mod.checkpointed(str(tmp_path), every=every):
            return _barriers(opt_mod.optimize(root))

    got = place(plan_ckpt, ir, optimizer, lazy, frames)
    want = place(ref_ckpt, ref_ir, ref_opt, ref_lazy, ref_frames)
    assert got == want
    if every == 1:
        assert got == [(1, "asof_join"), (2, "range_stats"), (3, "ema")]
    if every == 2:
        assert got == [(1, "range_stats"), (2, "ema")]


def test_placement_off_and_uncacheable_plans(frames, tmp_path, monkeypatch):
    left, right = frames
    monkeypatch.setenv("TEMPO_TPU_CKPT_PLACEMENT", "off")
    with plan_ckpt.checkpointed(str(tmp_path)):
        assert not _barriers(optimizer.optimize(_chain(left, right)._node))
    monkeypatch.delenv("TEMPO_TPU_CKPT_PLACEMENT")
    t = TSDF(_mk_df(3), "event_ts", ["sym"], device="cpu")
    lz = lazy.wrap(lazy._as_node(t)).withColumn("z", lambda df: df["px"])
    with plan_ckpt.checkpointed(str(tmp_path)):
        assert not _barriers(optimizer.optimize(
            lz.EMA("px", exact=True)._node))
    with pytest.raises(ValueError, match="every"):
        with plan_ckpt.checkpointed(str(tmp_path), every=0):
            pass


def test_explain_renders_barriers(frames, tmp_path):
    with plan_ckpt.checkpointed(str(tmp_path)):
        text = _chain(*frames).explain()
    assert "checkpoint[step 1]" in text and "signed step manifest" in text
    assert "B est" in text


def test_checkpointed_run_is_bitwise_and_writes_signed_chain(frames,
                                                             tmp_path):
    left, right = frames
    d = str(tmp_path / "ck")
    with plan_ckpt.checkpointed(d):
        got = _srt(_chain(left, right).collect().df)
    pd.testing.assert_frame_equal(got, _eager(left, right), check_exact=True)
    metas = {s: checkpoint.read_meta(p) for s, p in checkpoint.list_steps(d)}
    assert sorted(metas) == [1, 2, 3]
    assert len({m["pipeline_signature"] for m in metas.values()}) == 1
    assert metas[2]["prev_step"] == 1
    assert metas[3]["prev_manifest_crc"] == checkpoint.manifest_crc(
        os.path.join(d, "step_00002"))


def test_kill_mid_chain_resumes_from_newest_intact_barrier(frames,
                                                           tmp_path):
    left, right = frames
    d = str(tmp_path / "killed")
    with faults.FaultInjector() as fi:
        fi.kill_on_call(np, "savez", call_no=2)      # dies saving step 2
        with pytest.raises(faults.SimulatedKill):
            with plan_ckpt.checkpointed(d):
                _chain(left, right).collect()
    assert checkpoint.latest(d).endswith("step_00001")
    builds0 = profiling.plan_cache_stats()["builds"]
    with faults.FaultInjector() as fi:
        fi.flaky(DistributedTSDF, "asofJoin", failures=0)
        fi.flaky(DistributedTSDF, "withRangeStats", failures=0,
                 label="stats")
        with plan_ckpt.checkpointed(d):
            got = _srt(_chain(left, right).collect().df)
        joins = sum(r.target != "stats" for r in fi.records)
        stats = sum(r.target == "stats" for r in fi.records)
    assert (joins, stats) == (0, 1)
    assert profiling.plan_cache_stats()["builds"] == builds0
    pd.testing.assert_frame_equal(got, _eager(left, right), check_exact=True)


def test_corrupt_newest_barrier_falls_back(frames, tmp_path):
    left, right = frames
    d = str(tmp_path / "corrupt")
    with plan_ckpt.checkpointed(d):
        want = _srt(_chain(left, right).collect().df)
    faults.corrupt_npz_array(os.path.join(d, "step_00003", "arrays.npz"))
    with faults.FaultInjector() as fi:
        fi.flaky(DistributedTSDF, "EMA", failures=0)
        with plan_ckpt.checkpointed(d):
            got = _srt(_chain(left, right).collect().df)
        assert len(fi.records) == 1          # resumed after step 2
    pd.testing.assert_frame_equal(got, want, check_exact=True)


def test_foreign_plan_and_other_data_are_refused_by_name(frames, tmp_path):
    left, right = frames
    d = str(tmp_path / "foreign")
    with plan_ckpt.checkpointed(d):
        _chain(left, right).collect()
    with pytest.raises(CheckpointError, match="DIFFERENT pipeline"):
        with plan_ckpt.checkpointed(d):
            _chain(left, right, extra_ema=True).collect()
    df2 = _mk_df(1)
    df2["px"] = df2["px"] + 100.0           # same shapes, new values
    left2 = TSDF(df2, "event_ts", ["sym"], device="cpu").on_mesh(left.mesh)
    with pytest.raises(CheckpointError, match="DIFFERENT pipeline"):
        with plan_ckpt.checkpointed(d):
            _chain(left2, right).collect()


def test_run_outside_context_is_unaffected(frames, tmp_path):
    left, right = frames
    d = str(tmp_path / "ck2")
    with plan_ckpt.checkpointed(d):
        _chain(left, right).collect()
    n = len(checkpoint.list_steps(d))
    got = _srt(_chain(left, right).collect().df)
    assert len(checkpoint.list_steps(d)) == n
    pd.testing.assert_frame_equal(got, _eager(left, right), check_exact=True)


def test_shared_source_across_barrier_resumes(frames, tmp_path):
    left, right = frames

    def chain2():
        lr = lazy.wrap(lazy._as_node(right))
        return (lazy.wrap(lazy._as_node(left))
                .asofJoin(lr, right_prefix="q", skipNulls=False)
                .withRangeStats(colsToSummarize=["q_px"],
                                rangeBackWindowSecs=60)
                .asofJoin(lr, right_prefix="z", skipNulls=False))

    want = _srt(chain2().collect().df)
    d = str(tmp_path / "dag")
    with faults.FaultInjector() as fi:
        fi.kill_on_call(np, "savez", call_no=3)
        with pytest.raises(faults.SimulatedKill):
            with plan_ckpt.checkpointed(d):
                chain2().collect()
    assert checkpoint.latest(d).endswith("step_00002")
    with plan_ckpt.checkpointed(d):
        got = _srt(chain2().collect().df)
    pd.testing.assert_frame_equal(got, want, check_exact=True)


def test_host_chain_barriers_roundtrip(tmp_path):
    t = TSDF(_mk_df(9), "event_ts", ["sym"], device="cpu")
    d = str(tmp_path / "host")
    lz = lambda: lazy.wrap(lazy._as_node(t)).EMA("px", exact=True)
    with plan_ckpt.checkpointed(d):
        want = lz().to_pandas()
    assert checkpoint.list_steps(d)
    with plan_ckpt.checkpointed(d):
        got = lz().to_pandas()
    pd.testing.assert_frame_equal(got, want, check_exact=True)
    pd.testing.assert_frame_equal(got, t.EMA("px", exact=True).df,
                                  check_exact=True)


def test_source_fingerprint_is_content_derived(frames):
    left, right = frames
    assert plan_ckpt.source_fingerprint(left) != \
        plan_ckpt.source_fingerprint(right)
    again = TSDF(_mk_df(1), "event_ts", ["sym"], device="cpu").on_mesh(
        left.mesh)
    assert plan_ckpt.source_fingerprint(again) == \
        plan_ckpt.source_fingerprint(left)
    host = TSDF(_mk_df(1), "event_ts", ["sym"], device="cpu")
    ref = tempo_tpu.TSDF(_mk_df(1), "event_ts", ["sym"])
    # a host frame's fingerprint is the reference's (the same pandas hash)
    assert plan_ckpt.source_fingerprint(host) == \
        ref_ckpt.source_fingerprint(ref)
