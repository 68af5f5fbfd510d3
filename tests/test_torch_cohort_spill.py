"""The cohort's spill tier in the port on the CPU: a ``StreamCohort`` with
a ``resident_budget`` keeps only hot members in slots; cold members live
as CRC'd ``kind="cohort_member"`` artifacts and fault back in bit for
bit on their next tick.  The emissions are the never-spilled cohort's,
bitwise; the LRU evicts the coldest member and never one of the current
dispatch; a corrupt, foreign or stale artifact is refused by name
(``CheckpointError``) while the other members tick; snapshots reattach
spilled members on resume; and a member artifact either package spills
faults into the other.
"""

import glob
import os
import shutil

import numpy as np
import pytest

from tempo_tpu import serve as ref_serve
from tempo_tpu_torch import checkpoint
from tempo_tpu_torch.serve import StreamCohort
from tempo_tpu_torch.testing import faults
from tests.test_torch_serve import COLS

CFG = dict(max_lookback=7, window_secs=9.0, window_rows_bound=8,
           ema_alpha=0.2, slots=4)


def mk(n_streams, tmp_path, budget, tag="a", pkg=StreamCohort, **kw):
    cfg = dict(CFG)
    cfg.update(kw)
    if pkg is StreamCohort:
        cfg["device"] = "cpu"
    spill = str(tmp_path / f"spill_{tag}") if budget else None
    cohort = pkg(COLS, spill_dir=spill, resident_budget=budget, **cfg)
    members = [cohort.add_stream(f"m{i}",
                                 [f"m{i}s{k}" for k in range(1 + i % 2)])
               for i in range(n_streams)]
    return cohort, members


def tick(m, r, i):
    """One deterministic tick of member ``m`` at round ``r``."""
    return m.push([m.series[0]], [(r * 10 + i + 1) * 10 ** 9],
                  {"px": np.float32([r + i * 0.5]),
                   "qty": np.float32([1.0 + r])})


def assert_same(got, want, ctx=""):
    assert set(got) == set(want), ctx
    for k in want:
        a, b = np.asarray(got[k]), np.asarray(want[k])
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes(), f"{ctx}:{k}"


def member_npz(cohort, name):
    arts = glob.glob(os.path.join(cohort._member_artifact(name), "**",
                                  "*.npz"), recursive=True)
    assert arts, f"no npz under {cohort._member_artifact(name)}"
    return arts[0]


# ----------------------------------------------------------------------
# Registration and the budget
# ----------------------------------------------------------------------

def test_budget_without_spill_dir_refused():
    with pytest.raises(ValueError, match="spill_dir"):
        StreamCohort(COLS, resident_budget=2, device="cpu", **CFG)


def test_registration_past_budget_is_cold_and_artifact_free(tmp_path):
    cohort, members = mk(5, tmp_path, budget=2)
    st = cohort.spill_stats
    assert st["registered"] == 5 and st["resident"] == 2
    assert st["spilled_artifacts"] == 0 and st["spills"] == 0
    assert [m.resident for m in members] == [True, True, False, False,
                                             False]
    assert members[3].bucket >= len(members[3].series)


def test_first_tick_of_cold_member_equals_fresh_twin(tmp_path):
    cohort, members = mk(4, tmp_path, budget=2)
    _, twins = mk(4, tmp_path, budget=0, tag="twin")
    assert_same(tick(members[3], 0, 3), tick(twins[3], 0, 3),
                "cold-first-tick")
    assert members[3].resident
    assert cohort.spill_stats["resident"] <= 2
    assert cohort.spill_stats["spills"] == 1


def test_lru_evicts_coldest_never_this_dispatch(tmp_path):
    cohort, members = mk(4, tmp_path, budget=2)
    m0, m1, m2, m3 = members
    tick(m0, 0, 0)
    tick(m1, 0, 1)
    tick(m2, 0, 2)              # over budget -> coldest (m0) spills
    assert not m0.resident and m1.resident and m2.resident
    tick(m1, 1, 1)              # m1 becomes most recent
    tick(m3, 1, 3)              # evicts m2, never m3 itself
    assert not m2.resident and m1.resident and m3.resident
    res = cohort.dispatch("right", [
        (m, m.series[0], 10**12, None, {"px": 1.0, "qty": 1.0})
        for m in members])      # a dispatch wider than the budget
    assert not any(isinstance(r, Exception) for r in res)
    assert cohort.spill_stats["resident"] == 4


# ----------------------------------------------------------------------
# Bitwise the never-spilled cohort
# ----------------------------------------------------------------------

def test_spill_restore_bitwise_vs_unbudgeted_twin(tmp_path):
    cohort, members = mk(6, tmp_path, budget=2)
    twin_c, twins = mk(6, tmp_path, budget=0, tag="twin")
    for r in range(6):
        for i, (m, t) in enumerate(zip(members, twins)):
            assert_same(tick(m, r, i), tick(t, r, i), f"r{r}m{i}")
    st = cohort.spill_stats
    assert st["spills"] >= 4 and st["restores"] >= 4
    assert st["resident"] <= 2
    assert st["spill_s"] > 0 and st["restore_s"] > 0
    assert cohort.acked == twin_c.acked


def test_explicit_spill_artifact_survives_fault_in(tmp_path):
    cohort, members = mk(3, tmp_path, budget=0)
    cohort.spill_dir = str(tmp_path / "spill_x")
    _, twins = mk(3, tmp_path, budget=0, tag="twin")
    for i, (m, t) in enumerate(zip(members, twins)):
        tick(m, 0, i)
        tick(t, 0, i)
    path = cohort.spill("m0")
    assert os.path.isdir(path) and not members[0].resident
    with pytest.raises(ValueError, match="not resident"):
        cohort.spill("m0")
    assert_same(tick(members[0], 1, 0), tick(twins[0], 1, 0), "restored")
    assert os.path.isdir(path)
    assert cohort.spill_stats["restores"] == 1


def test_clipped_preserved_across_spill(tmp_path):
    cohort, members = mk(2, tmp_path, budget=0, window_rows_bound=2)
    cohort.spill_dir = str(tmp_path / "spill_c")
    m = members[0]
    for r in range(5):          # 5 rows inside one 9 s window, bound 2
        m.push([m.series[0]], [(r + 1) * 10 ** 9],
               {"px": np.float32([1.0]), "qty": np.float32([2.0])})
    before = m.clipped
    assert before > 0
    cohort.spill("m0")
    assert not m.resident
    assert m.clipped == before          # read from the artifact
    assert cohort.clipped == before


# ----------------------------------------------------------------------
# Refusals by name, per-member isolation
# ----------------------------------------------------------------------

def test_corrupt_artifact_refused_other_members_tick(tmp_path):
    cohort, members = mk(3, tmp_path, budget=0)
    cohort.spill_dir = str(tmp_path / "spill_k")
    _, twins = mk(3, tmp_path, budget=0, tag="twin")
    for i, (m, t) in enumerate(zip(members, twins)):
        tick(m, 0, i)
        tick(t, 0, i)
    cohort.spill("m0")
    faults.flip_byte(member_npz(cohort, "m0"), offset=120)
    with pytest.raises(checkpoint.CheckpointError):
        tick(members[0], 1, 0)
    assert not members[0].resident
    assert_same(tick(members[1], 1, 1), tick(twins[1], 1, 1),
                "isolated-sibling")


def test_foreign_artifact_refused_by_name(tmp_path):
    cohort, members = mk(4, tmp_path, budget=0)
    cohort.spill_dir = str(tmp_path / "spill_f")
    for i, m in enumerate(members):
        tick(m, 0, i)
    cohort.spill("m0")
    cohort.spill("m2")
    victim = cohort._member_artifact("m0")
    shutil.rmtree(victim)
    shutil.copytree(cohort._member_artifact("m2"), victim)
    with pytest.raises(checkpoint.CheckpointError, match="FOREIGN"):
        tick(members[0], 1, 0)


def test_stale_artifact_refused_after_old_snapshot_resume(tmp_path):
    parent = str(tmp_path / "ck")
    spill = str(tmp_path / "spill_s")
    cohort, members = mk(3, tmp_path, budget=0, checkpoint_dir=parent)
    cohort.spill_dir = spill
    for i, m in enumerate(members):
        tick(m, 0, i)
    cohort.spill("m0")
    cohort.snapshot()           # the snapshot references m0's artifact
    tick(members[0], 1, 0)
    tick(members[0], 2, 0)
    cohort.spill("m0")          # a re-spill overwrites it, newer state
    old = StreamCohort.resume(parent, spill_dir=spill, device="cpu")
    with pytest.raises(checkpoint.CheckpointError, match="newer snapshot"):
        tick(old.stream("m0"), 1, 0)


# ----------------------------------------------------------------------
# Snapshot and resume with spilled members; across the packages
# ----------------------------------------------------------------------

def test_snapshot_resume_reattaches_spilled_members(tmp_path):
    parent = str(tmp_path / "ck")
    spill = str(tmp_path / "spill_r")
    cohort, members = mk(3, tmp_path, budget=0, checkpoint_dir=parent)
    cohort.spill_dir = spill
    _, twins = mk(3, tmp_path, budget=0, tag="twin")
    for r in range(2):
        for i, (m, t) in enumerate(zip(members, twins)):
            tick(m, r, i)
            tick(t, r, i)
    cohort.spill("m1")
    cohort.snapshot()
    resumed = StreamCohort.resume(parent, spill_dir=spill, device="cpu")
    assert not resumed.stream("m1").resident
    assert resumed.spill_stats["spilled_artifacts"] == 1
    for i in range(3):
        assert_same(tick(resumed.stream(f"m{i}"), 2, i), tick(twins[i], 2, i),
                    f"resumed-m{i}")


def test_resume_without_spill_dir_refused_by_name(tmp_path):
    parent = str(tmp_path / "ck")
    cohort, members = mk(2, tmp_path, budget=0, checkpoint_dir=parent)
    cohort.spill_dir = str(tmp_path / "spill_n")
    for i, m in enumerate(members):
        tick(m, 0, i)
    cohort.spill("m0")
    cohort.snapshot()
    with pytest.raises(checkpoint.CheckpointError, match="spill_dir"):
        StreamCohort.resume(parent, device="cpu")


@pytest.mark.parametrize("writer", ["port", "ref"])
def test_member_artifact_across_packages(tmp_path, writer):
    """A member artifact either package spills holds the same arrays and
    manifest, so a snapshot of a cohort with a spilled member, written by
    one package, resumes in the other and faults that member in: the
    installed slot rows are the artifact's bytes."""
    pkg = StreamCohort if writer == "port" else ref_serve.StreamCohort
    parent = str(tmp_path / "ck")
    spill = str(tmp_path / "spill")
    cohort, members = mk(3, tmp_path, budget=0, pkg=pkg,
                         checkpoint_dir=parent)
    cohort.spill_dir = spill
    for r in range(3):
        for i, m in enumerate(members):
            tick(m, r, i)
    path = cohort.spill("m1")
    cohort.snapshot()
    arrays, meta = checkpoint.load_state(path, kind="cohort_member")
    assert meta["name"] == "m1" and meta["acked"] == 3
    if writer == "port":
        other = ref_serve.StreamCohort.resume(parent, spill_dir=spill)
    else:
        other = StreamCohort.resume(parent, spill_dir=spill, device="cpu")
    m1 = other.stream("m1")
    assert not m1.resident
    other._fault_in(m1)
    g = m1._group
    rows = (g.slot_rows(m1.slot) if writer == "ref"
            else {n: np.asarray(a)[m1.slot] for n, a in g.state.items()})
    for name, row in rows.items():
        assert row.tobytes() == arrays[f"s.{name}"].tobytes(), name
    assert g.wm_ts[m1.slot].tobytes() == arrays["wm_ts"].tobytes()
