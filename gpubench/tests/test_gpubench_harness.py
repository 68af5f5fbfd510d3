"""The harness on the CPU at a small size: it finds every cell's files
by name, prints the contract's result line, refuses to run without a
card, sees ``correct`` come out false under planted faults and under
the bfloat16 control, and takes a new cell, mix and metric as new files
and entries alone."""

import json
import os
import re
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from gpubench import harness

ROOT = Path(__file__).resolve().parents[2]
BENCH = harness.spec()
CELLS = [w["name"] for w in BENCH["workloads"]]
SCALE = {"hhar_quickstart": 0.001}
SEED = 2**31 + 4242
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")


def _scale(workload):
    return SCALE[workload.split(".")[0]]


def _run(workload, trace=False):
    return harness.run_cell(BENCH, workload, SEED, 0.2, trace,
                            device="cpu", scale=_scale(workload))


@pytest.mark.parametrize("workload", CELLS)
def test_finds_everything_by_name(workload):
    cell = harness.cell_of(BENCH, workload)
    cfg = harness.config(cell["config"])
    mix = harness.traffic(cell["traffic"])
    assert harness.generator(cfg["generator"]).make
    assert harness.path_class(mix["path"])
    assert set(harness.limits(workload)) == {"rows_bad", "stats_err",
                                             "ema_err"}
    names = [m["name"] for m in harness.per_layer_of(BENCH, workload)]
    assert names
    for m in names:
        assert callable(harness.reader(m))
    e2e = {m["name"] for m in harness.end_to_end_of(BENCH, workload)}
    assert e2e == {"setup_s", mix["rate_metric"]}


def test_benchmark_json_contract():
    keys = {"command", "paths", "run_seconds", "configs", "workloads",
            "end_to_end", "per_layer"}
    assert set(BENCH) == keys
    assert BENCH["paths"] == ["gpubench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    # a full check of 24 cells fits its 43,200 s
    rs = BENCH["run_seconds"]
    assert (2 + 14 * 24) * (rs + 60) + 24 * 180 + 1200 <= 43200
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and len(c["source"]) <= 200
        cfg = json.loads((ROOT / c["file"]).read_text())
        assert cfg["source"] == c["source"]
        assert cfg["reduced"] == c["reduced"]
        assert "assumed" in cfg and "host_threads" in cfg
    used = {w["config"] for w in BENCH["workloads"]}
    assert used == {c["name"] for c in BENCH["configs"]}
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and w["chips"] == 1
        assert len(w["why"]) <= 200
    metrics = BENCH["end_to_end"] + BENCH["per_layer"]
    assert len({m["name"] for m in metrics}) == len(metrics)
    for m in BENCH["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    assert "setup_s" in {m["name"] for m in BENCH["end_to_end"]}
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    for m in BENCH["per_layer"]:
        assert set(m) == {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["moves"] in e2e and NAME.match(m["name"])
        assert re.match(r"^[A-Za-z0-9_/%.\-]{1,16}$", m["unit"])
        for w in m["workloads"]:
            reported = {x["name"] for x in harness.end_to_end_of(BENCH, w)}
            assert m["moves"] in reported
        if m["name"].split(".")[0].endswith("_roofline"):
            assert m["unit"] == "%"
    assert len(json.dumps(BENCH)) < 64 * 1024


@pytest.mark.parametrize("workload", CELLS)
@pytest.mark.parametrize("trace", [False, True], ids=["timed", "traced"])
def test_result_line_keys(workload, trace):
    line = _run(workload, trace)
    want = ["correct", "attempted", "failed", "metrics", "device"]
    want += ["breakdown"] if trace else []
    assert list(line) == want + ["checks"]
    assert line["correct"] is True and line["failed"] == 0
    assert line["attempted"] >= 1
    dev = {"platform", "kind", "count", "memory_peak_bytes"}
    dev |= {"busy_s", "window_s"} if trace else set()
    assert set(line["device"]) == dev
    assert list(line["checks"]) == ["rows_bad", "stats_err", "ema_err"]
    json.loads(json.dumps(line))
    if trace:
        assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
        assert set(line["metrics"]) <= {
            m["name"] for m in harness.per_layer_of(BENCH, workload)}
    else:
        assert set(line["metrics"]) == {
            m["name"] for m in harness.end_to_end_of(BENCH, workload)}
        for v in line["metrics"].values():
            assert v["value"] > 0


def test_no_card_no_result():
    """Without a CUDA card the entry exits non-zero and prints nothing on
    standard output (this sandbox has none; on a card it is skipped)."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    proc = subprocess.run(
        [sys.executable, "-m", "gpubench.run", "--workload",
         BENCH["workloads"][0]["name"],
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0 and proc.stdout == ""


def test_no_program_no_result(tmp_path):
    """In a directory holding only BENCHMARK.json and gpubench/ the entry
    exits non-zero and prints no result."""
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "gpubench", tmp_path / "gpubench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run(
        [sys.executable, "-m", "gpubench.run", "--workload",
         BENCH["workloads"][0]["name"],
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        cwd=tmp_path, capture_output=True, text=True, timeout=120, env=env)
    assert proc.returncode != 0 and proc.stdout == ""


# ----------------------------------------------------------------------
# Faults planted under the timed path, and the control in its place
# ----------------------------------------------------------------------

def _plant(monkeypatch, workload, fault):
    cell = harness.cell_of(BENCH, workload)
    cfg = harness.config(cell["config"])
    cls = harness.path_class(harness.traffic(cell["traffic"])["path"])
    result = cls.result
    key, col = cfg["partition_col"], cfg["chain"]["ema_col"]

    def broken(self, out):
        df = result(self, out).copy()
        if fault == "stats_unchanged":
            df = df[[c for c in df.columns
                     if not c.endswith("_" + cfg["chain"]["stats_col"])]]
        elif fault == "half_left_out":
            keys = sorted(df[key].unique())
            df = df[df[key].isin(keys[: len(keys) // 2])]
        elif fault == "answer_altered":
            df.loc[len(df) // 2, f"EMA_{col}"] += 1.0
        elif fault == "join_shifted":
            rc = [c for c in df.columns
                  if c.startswith(cfg["chain"]["right_prefix"] + "_")
                  and df[c].dtype == np.float64][0]
            df[rc] = df[rc].shift(1)
        return df

    monkeypatch.setattr(cls, "result", broken)


@pytest.mark.parametrize("workload", CELLS)
@pytest.mark.parametrize("fault", ["stats_unchanged", "half_left_out",
                                   "answer_altered", "join_shifted"])
def test_fault_makes_correct_false(monkeypatch, workload, fault):
    _plant(monkeypatch, workload, fault)
    line = _run(workload)
    assert line["correct"] is False
    assert line["failed"] >= 1


@pytest.mark.parametrize("workload", CELLS)
def test_control_is_not_correct(monkeypatch, workload):
    """The reference in bfloat16, put in the program's place, fails the
    cell's limits."""
    from gpubench.reference.chain import chain as reference

    cell = harness.cell_of(BENCH, workload)
    cfg = harness.config(cell["config"])
    cls = harness.path_class(harness.traffic(cell["traffic"])["path"])
    left_right = {}
    init = cls.__init__

    def keep(self, cfg_, left, right, device):
        left_right["lr"] = (left, right)
        init(self, cfg_, left, right, device)

    monkeypatch.setattr(cls, "__init__", keep)
    monkeypatch.setattr(cls, "result", lambda self, out: reference(
        *left_right["lr"], cfg, precision="bfloat16"))
    line = _run(workload)
    assert line["correct"] is False
    checks = line["checks"]
    assert checks["rows_bad"]["value"] > checks["rows_bad"]["limit"]
    assert checks["stats_err"]["value"] > checks["stats_err"]["limit"]
    assert checks["ema_err"]["value"] > checks["ema_err"]["limit"]


# ----------------------------------------------------------------------
# A new cell, mix and metric are new files and entries alone
# ----------------------------------------------------------------------

def test_new_cell_mix_and_metric_need_only_new_files(tmp_path):
    """A configuration, a mix whose chain counts its work its own way
    (a new path file) and a metric that reads what the path and the
    configuration say, added as files and entries: no file changes."""
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "gpubench", tmp_path / "gpubench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    before = {p: p.read_bytes() for p in (tmp_path / "gpubench").rglob("*")
              if p.is_file()}
    g = tmp_path / "gpubench"
    cfg = json.loads((g / "configs" / "hhar_quickstart.json").read_text())
    for side in ("left", "right"):
        by_key = dict(list(cfg[side]["rows_by_key"].items())[:3])
        cfg[side].update(rows_by_key=by_key, rows=sum(by_key.values()))
    cfg.update(name="hhar_three", host_threads=2)
    (g / "configs" / "hhar_three.json").write_text(json.dumps(cfg))
    (g / "paths" / "resident_both.py").write_text(
        "from gpubench.paths.resident import Path as Resident\n\n\n"
        "class Path(Resident):\n"
        "    def __init__(self, cfg, left, right, device):\n"
        "        super().__init__(cfg, left, right, device)\n"
        "        self.units = len(left) + len(right)\n\n"
        "    def work(self):\n"
        "        return dict(super().work(), flops=0.0)\n")
    mix = json.loads((g / "traffic" / "resident_chain.json").read_text())
    mix.update(path="resident_both", trace_chains=2,
               rate_metric="both_rows_per_s")
    (g / "traffic" / "resident_both.json").write_text(json.dumps(mix))
    (g / "cells" / "hhar_three.resident_both.json").write_text(
        (g / "cells" / "hhar_quickstart.resident_chain.json").read_text())
    (g / "metrics" / "units_a_chain.both.py").write_text(
        "def read(ctx):\n"
        "    assert ctx.cfg['name'] == 'hhar_three'\n"
        "    assert ctx.work['flops'] == 0\n"
        "    return float(ctx.units)\n")
    (g / "metrics" / "ema_step_s.both.py").write_text(
        "from gpubench.lib.trace import mean_span_s\n\n\n"
        "def read(ctx):\n    return mean_span_s(ctx, 'gpubench.ema')\n")
    bench = json.loads((tmp_path / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "hhar_three", "source": "x",
                             "file": "gpubench/configs/hhar_three.json",
                             "reduced": ["rows_by_key"], "why": "x"})
    w = "hhar_three.resident_both"
    bench["workloads"].append({"name": w, "config": "hhar_three",
                               "traffic": "resident_both", "chips": 1,
                               "why": "x"})
    bench["end_to_end"].insert(0, {
        "name": "both_rows_per_s", "unit": "rows/s", "better": "higher",
        "bound": 0.1, "source": "host_clock", "workloads": [w]})
    for name, unit in (("units_a_chain.both", "rows"),
                       ("ema_step_s.both", "s")):
        bench["per_layer"].append({
            "name": name, "unit": unit, "better": "lower",
            "source": "program_span", "layer": "mesh frame",
            "moves": "both_rows_per_s", "workloads": [w]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    code = (
        "import json, sys; sys.path[:0] = [sys.argv[1], sys.argv[2]]\n"
        "from gpubench import harness\n"
        "here = __import__('pathlib').Path(sys.argv[1])\n"
        "assert harness.HERE.parent == here\n"
        "for trace in (False, True):\n"
        "    line = harness.run_cell(harness.spec(),"
        " 'hhar_three.resident_both', 3, 0.2, trace, device='cpu',"
        " scale=0.001)\n"
        "    print(json.dumps(line))\n")
    proc = subprocess.run([sys.executable, "-c", code, str(tmp_path),
                           str(ROOT)], capture_output=True, text=True,
                          timeout=600, cwd=tmp_path)
    assert proc.returncode == 0, proc.stderr[-3000:]
    timed, traced = [json.loads(x)
                     for x in proc.stdout.strip().splitlines()[-2:]]
    assert timed["correct"] is True
    assert set(timed["metrics"]) == {"both_rows_per_s", "setup_s"}
    assert traced["correct"] is True and traced["attempted"] == 2
    assert "ema_step_s.both" in traced["metrics"]
    scale = 0.001
    units = sum(int(r * scale) for side in ("left", "right")
                for r in cfg[side]["rows_by_key"].values())
    assert traced["metrics"]["units_a_chain.both"]["value"] == units
    after = {p: p.read_bytes() for p in before}
    assert after == before


@pytest.mark.card
def test_cell_on_the_card():
    """One short run of every cell on a CUDA card, through the entry."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    for w in [x["name"] for x in BENCH["workloads"]]:
        proc = subprocess.run(
            [sys.executable, "-m", "gpubench.run", "--workload", w,
             "--seed", str(SEED), "--seconds", "2", "--trace", "0"],
            cwd=ROOT, capture_output=True, text=True, timeout=900)
        assert proc.returncode == 0, proc.stderr[-3000:]
        assert json.loads(proc.stdout.splitlines()[-1])["correct"] is True


def test_calibrate_reads_program_and_control(capsys):
    from gpubench import calibrate

    assert calibrate.main(["--workload", "hhar_quickstart.resident_chain",
                           "--seeds", "5", "--control-seeds", "6",
                           "--device", "cpu", "--scale", "0.001"]) == 0
    lines = [json.loads(x) for x in capsys.readouterr().out.splitlines()]
    prog, ctl, summary = lines
    lim = harness.limits("hhar_quickstart.resident_chain")
    assert prog["kind"] == "program" and prog["rows_bad"] == 0
    assert ctl["kind"] == "control" and ctl["rows_bad"] > 0
    assert summary["ema_err"]["control_min"] > lim["ema_err"]
