"""The port's compiled contracts (``tempo_tpu_torch/plan/contracts.py``,
``plan/contract_rules.py``) on the CPU, beside the reference's
(``tests/test_compiled_contracts.py``).

Each rule with a counterpart fires on a deliberately broken program (a
float64 plane, a scalar read or copy to the CPU, a graph node with a
host end fed as stub node records, an unmodeled or mis-sized move
between mesh entries, a stage-boundary placement mismatch, an
unrecorded planned parameter), passes a good twin and is silenced by
``# lint-ok: <rule>: <reason>`` at the builder's ``@register`` site.
The moves run on a mesh of eight ``cpu`` entries.  The registry is
clean at head, and its names, rule names and bits, operands and one
modeled byte figure equal the reference's (the JAX side on the 8 host
devices of ``tests/conftest.py``).
"""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.utils._pytree import tree_map

from tempo_tpu_torch import dist, make_mesh, profiling
from tempo_tpu_torch.parallel.mesh import transfer
from tempo_tpu_torch.plan import contract_rules as rules
from tempo_tpu_torch.plan import contracts
from tempo_tpu_torch.plan.contract_rules import (
    BUILD_ERROR_CODE, COMPILED_RULES, NO_COUNTERPART,
    CollectiveInventoryRule, NoF64LeakRule, NoHostTransferRule,
    RecompileCoverageRule, StageShardingMatchRule, run_compiled)
from tempo_tpu_torch.plan.contracts import (Chain, CompiledProgram,
                                            Contract, Link, placement)

REPO = Path(__file__).resolve().parent.parent


@pytest.fixture
def f32(monkeypatch):
    """The runner's precondition, for this test only."""
    monkeypatch.setenv("TEMPO_TPU_COMPUTE_DTYPE", "float32")


def _program(fn, *args, name="fixture", contract=None, nodes=None):
    rec, _ = contracts._record(fn, *args)
    p = CompiledProgram(name, rec, contract or Contract())
    if nodes is not None:
        p._nodes = list(nodes)
    return p


def _check(rule, programs, chains=()):
    return run_compiled([rule], programs, list(chains), {}, registry=False)


def _fires(rule, programs, chains=(), text=""):
    findings, code = _check(rule, programs, chains)
    assert code == rule.code, [f.render() for f in findings]
    assert findings and all(f.rule == rule.name for f in findings)
    assert text in " | ".join(f.message for f in findings)


def _clean(rule, programs, chains=()):
    findings, code = _check(rule, programs, chains)
    assert findings == [] and code == 0, [f.render() for f in findings]


def _mesh(n=8):
    return make_mesh({"d": n}, devices=["cpu"] * n)


class _OnCard(torch.Tensor):
    """A CPU tensor that says it lies on a card: its copy to the CPU is
    what the record must see as a device-to-host copy."""

    @staticmethod
    def __new__(cls, elem):
        return torch.Tensor._make_wrapper_subclass(
            cls, elem.shape, dtype=elem.dtype, device="cuda")

    def __init__(self, elem):
        self.elem = elem

    @classmethod
    def __torch_dispatch__(cls, func, types, args=(), kwargs=None):
        un = lambda t: t.elem if isinstance(t, _OnCard) else t
        return func(*tree_map(un, args), **tree_map(un, kwargs or {}))


X32 = torch.ones(2, 4, dtype=torch.float32)


# ----------------------------------------------------------------------
# no-f64-leak (exit 1)
# ----------------------------------------------------------------------

@pytest.mark.parametrize("fn,contract,fires", [
    (lambda x: x + torch.tensor([1.0, 2.0], dtype=torch.float64).sum(),
     None, True),                                  # a float64 plane
    (lambda x: x.double() * 2, None, True),        # a widening cast
    (lambda x: x * 2.0 + 1.0, None, False),        # float32 throughout
    (lambda x: x + torch.tensor(1.0, dtype=torch.float64).float(),
     None, False),                                 # 0-d float64 tolerated
    (lambda x: x.double() * 2, Contract(allow_f64=True), False),
], ids=["f64-plane", "widening-cast", "f32", "f64-scalar", "allow_f64"])
def test_f64_leak(fn, contract, fires):
    p = _program(fn, X32, contract=contract)
    if fires:
        _fires(NoF64LeakRule(), [p], text="float64")
    else:
        _clean(NoF64LeakRule(), [p])


# ----------------------------------------------------------------------
# no-host-transfer (exit 2): the record, and the graph's stub nodes
# ----------------------------------------------------------------------

BARRIER = Contract(host_transfer_ok="fourier host fallback "
                                    "(materialization barrier)")


@pytest.mark.parametrize("fn,contract,fires", [
    (lambda x: x.sum().item(), None, True),
    (lambda x: x.cpu() + 1, None, True),
    (lambda x: torch.empty(x.shape).copy_(x), None, True),
    (lambda x: x + 1, None, False),
    (lambda x: x.sum().item(), BARRIER, False),
    (lambda x: x.cpu() + 1, BARRIER, False),
], ids=["item", "cpu", "copy_to_cpu", "clean", "barrier-item",
        "barrier-cpu"])
def test_host_transfer_in_the_record(fn, contract, fires):
    p = _program(fn, _OnCard(torch.arange(4.0)), contract=contract)
    if fires:
        _fires(NoHostTransferRule(), [p], text="host-transfer")
    else:
        _clean(NoHostTransferRule(), [p])


def _memcpy(src, dst, nbytes=1024):
    side = lambda k: "D" if k == "device" else "H"
    return {"type": "memcpy", "src": src, "dst": dst, "bytes": nbytes,
            "direction": f"{side(src)}to{side(dst)}"}


KERNEL = {"type": "kernel", "name": "_Z15ema_scan_kernelIfEv"}


@pytest.mark.parametrize("nodes,fires", [
    ([KERNEL, _memcpy("pinned", "device")], "memcpy HtoD pinned"),
    ([_memcpy("host", "device")], "memcpy HtoD host"),
    ([KERNEL, _memcpy("device", "pinned")], "memcpy DtoH"),
    ([{"type": "host"}], "host callback"),
    ([KERNEL, _memcpy("device", "device"), {"type": "memset"}], None),
    ([], None),
], ids=["HtoD-pinned", "HtoD-pageable", "DtoH", "host-node", "DtoD",
        "empty"])
def test_host_transfer_in_the_graph(nodes, fires):
    p = _program(lambda x: x + 1, X32, nodes=nodes)
    if fires:
        _fires(NoHostTransferRule(), [p], text=fires)
    else:
        _clean(NoHostTransferRule(), [p])
    p = _program(lambda x: x + 1, X32, nodes=nodes, contract=BARRIER)
    _clean(NoHostTransferRule(), [p])


def test_graph_readers_on_stub_nodes():
    nodes = [KERNEL, KERNEL, _memcpy("device", "device", 64),
             _memcpy("pinned", "device", 256), {"type": "host"}]
    assert profiling.host_transfers_from_graph(nodes) == [
        "memcpy HtoD pinned -> device 256 B", "host callback node"]
    assert profiling.graph_summary(nodes) == {
        "nodes": {"kernel": 2, "memcpy": 2, "host": 1},
        "kernels": [KERNEL["name"]],
        "memcpy_bytes": {"DtoD": 64, "HtoD": 256}}
    p = _program(lambda x: x + 1, X32, nodes=nodes)
    assert p.kernels() == [KERNEL["name"]]
    assert profiling.short_kernel_name(KERNEL["name"]) == "ema_scan_kernel"
    assert profiling.short_kernel_name(
        "_ZN44_GLOBAL__N__6c6d41c4_11_ema_scan_cu_1a0aa93615ema_scan_"
        "kernelIfEEvPKT_PKhS1_S3_PS1_S6_ii") == "ema_scan_kernel"
    assert profiling.short_kernel_name("ema_block") == "ema_block"


# ----------------------------------------------------------------------
# collective-inventory (exit 4), on a mesh of eight cpu entries
# ----------------------------------------------------------------------

def _gather(kind="all-gather"):
    """Every entry's [1, 16] float32 row to every entry (an all-gather),
    through ``mesh.transfer``: 8 * 7 moves cross entries."""
    mesh = _mesh()
    rows = [torch.full((1, 16), float(i)) for i in range(8)]
    ent = mesh.axis_entries("d")

    def fn():
        moves = [(rows[s], 0, torch.device("cpu"), 0)
                 for d in range(8) for s in range(8)]
        entries = [(ent[s], ent[d]) for d in range(8) for s in range(8)]
        return transfer(moves, kind, entries)

    return contracts._record(fn)[0]


GATHER = 8 * 7 * 16 * 4


def test_transfer_counts_moves_between_distinct_entries():
    rec = _gather()
    assert profiling.comm_bytes_from_record(rec) == {"all-gather": GATHER}
    assert profiling.collective_counts_from_record(rec) == {
        "all-gather": 56}
    # no kind, no record: nothing counted
    mesh = _mesh(2)
    t = torch.ones(4)
    rec, _ = contracts._record(lambda: transfer(
        [(t, 0, torch.device("cpu"), 0)]))
    assert rec.transfers == []
    assert mesh.axis_entries("d") == [0, 1]


@pytest.mark.parametrize("contract,text", [
    (Contract(), "UNMODELED"),
    (Contract(collectives={"all-gather": GATHER}), None),
    (Contract(collectives={"all-gather": GATHER // 2}), "outside"),
    (Contract(collectives={"all-gather": GATHER // 2},
              tolerances={"all-gather": 4.0}), None),
    (Contract(collectives={"all-gather": GATHER + 1}), "outside"),
    (Contract(collectives={"all-to-all": 1024, "all-gather": GATHER}),
     "ABSENT"),
    (Contract(incidental={"all-gather": GATHER}), None),
    (Contract(incidental={"all-gather": GATHER - 1}), "ceiling"),
], ids=["unmodeled", "exact", "model-low", "tolerance-override",
        "model-high", "vanished", "incidental-under", "incidental-over"])
def test_collective_inventory(contract, text):
    p = CompiledProgram("fixture.gather", _gather(), contract)
    if text:
        _fires(CollectiveInventoryRule(), [p], text=text)
    else:
        _clean(CollectiveInventoryRule(), [p])


# ----------------------------------------------------------------------
# stage-sharding-match (exit 16)
# ----------------------------------------------------------------------

def _stage(name, out_spec, in_spec=None, shape=(8, 16), in_shape=None):
    mesh = _mesh()
    at = lambda spec, shp: placement(mesh, spec, shp, "d")
    return CompiledProgram(
        name, profiling.ProgramRecord(), Contract(),
        inputs=(at(in_spec or out_spec, in_shape or shape),),
        outputs=(at(out_spec, shape),))


def test_stage_sharding_match_passes():
    prod = _stage("stage.a", ("d", None))
    cons = _stage("stage.b", ("d", None))
    # a whole leading axis of another length places nothing
    wide = _stage("stage.c", (None, "d", None), shape=(3, 8, 16),
                  in_shape=(3, 8, 16))
    chain = Chain("fixture.chain", (Link("stage.a", 0, "stage.b", 0),
                                    Link("stage.c", 0, "stage.b", 0)))
    _clean(StageShardingMatchRule(), [prod, cons, wide], [chain])


def _mismatch_chain():
    prod = _stage("stage.a", ("d",))
    cons = _stage("stage.b", (None,))
    return [prod, cons], Chain("fixture.chain",
                               (Link("stage.a", 0, "stage.b", 0),))


def test_stage_sharding_mismatch_fires():
    programs, chain = _mismatch_chain()
    _fires(StageShardingMatchRule(), programs, [chain], text="mismatch")


def test_stage_sharding_sharded_dropped_axis_fires():
    prod = _stage("stage.a", ("d", None))
    cons = _stage("stage.b", (None,), shape=(16,))
    chain = Chain("fixture.chain",
                  (Link("stage.a", 0, "stage.b", 0, drop_leading=1),))
    _fires(StageShardingMatchRule(), [prod, cons], [chain], text="SHARDED")
    # an unsharded leading axis drops cleanly
    prod = _stage("stage.a", (None, "d", None), shape=(3, 8, 16))
    cons = _stage("stage.b", ("d", None))
    _clean(StageShardingMatchRule(), [prod, cons], [chain])


def test_stage_sharding_finding_suppressible_at_chain_site(tmp_path):
    programs, chain = _mismatch_chain()
    src = tmp_path / "builders.py"
    src.write_text(
        "# lint-ok: stage-sharding-match: reshard lands next round\n"
        "@register('fixture.chain')\n"
        "def _build():\n"
        "    ...\n")
    chain.source_file, chain.source_line = str(src), 3
    _clean(StageShardingMatchRule(), programs, [chain])


def test_stage_sharding_bad_link_indices_fire():
    prod = _stage("stage.a", ("d",))
    cons = _stage("stage.b", ("d",))
    chain = Chain("fixture.chain", (Link("stage.a", 3, "stage.b", 0),
                                    Link("stage.a", 0, "stage.gone", 0)))
    findings, code = _check(StageShardingMatchRule(), [prod, cons], [chain])
    assert code == StageShardingMatchRule().code
    msgs = " | ".join(f.message for f in findings)
    assert "out of range" in msgs and "did not build" in msgs


# ----------------------------------------------------------------------
# recompile-coverage (exit 32)
# ----------------------------------------------------------------------

class _FakeFrame:
    def _plan_record(self, op, others=(), params=None, objs=None):
        return self

    def covered(self, colName, window):
        return self._plan_record("covered", (),
                                 dict(colName=colName, window=window))

    def leaky(self, colName, window):
        # 'window' feeds the computation but NOT the plan node
        return self._plan_record("leaky", (), dict(colName=colName))

    def waived(self, colName, window):  # lint-ok: recompile-coverage: fixture
        return self._plan_record("waived", (), dict(colName=colName))


@pytest.mark.parametrize("method,fires", [
    ("leaky", True), ("covered", False), ("waived", False)])
def test_recompile_coverage(method, fires):
    found = RecompileCoverageRule()._check_method("TSDF", _FakeFrame,
                                                  method)
    if fires:
        assert found is not None and "window" in found.message
    else:
        assert found is None


def test_recompile_coverage_live_registry_clean():
    found = RecompileCoverageRule().check_registry()
    assert found == [], "\n".join(f.render() for f in found)


# ----------------------------------------------------------------------
# engine: suppression, build-error, exit-bit OR, usage errors
# ----------------------------------------------------------------------

def test_lint_ok_at_register_site_suppresses(tmp_path):
    p = _program(lambda x: x.double(), X32, name="fixture.suppressed")
    src = tmp_path / "builders.py"
    src.write_text(
        "# lint-ok: no-f64-leak: golden-parity program, f64 by design\n"
        "@register('fixture.suppressed')\n"
        "def _build():\n"
        "    ...\n")
    p.source_file, p.source_line = str(src), 3
    _clean(NoF64LeakRule(), [p])


def test_build_error_exit_bit():
    findings, code = run_compiled(list(COMPILED_RULES), [], [],
                                  {"fixture.broken": "ValueError: boom"},
                                  registry=False)
    assert code == BUILD_ERROR_CODE
    assert findings[0].rule == "build-error"
    assert "boom" in findings[0].message


@pytest.fixture
def fixture_builder():
    added = []

    def add(name, fn):
        contracts.register(name)(fn)
        added.append(name)

    yield add
    for name in added:
        contracts._BUILDERS.pop(name)


def test_build_all_collects_builder_exceptions(f32, fixture_builder):
    def boom():
        raise ValueError("shape mismatch")

    fixture_builder("fixture.raises", boom)
    programs, chains, errors = contracts.build_all(only=["fixture.raises"],
                                                   device="cpu")
    assert programs == [] and chains == []
    assert "ValueError: shape mismatch" in errors["fixture.raises"]


def test_exit_bits_or_across_rules():
    p = _program(lambda x: (x.double(), x.sum().item()), X32,
                 name="fixture.both")
    findings, code = run_compiled([NoF64LeakRule(), NoHostTransferRule()],
                                  [p], [], {}, registry=False)
    assert code == NoF64LeakRule().code | NoHostTransferRule().code
    assert {f.rule for f in findings} == {"no-f64-leak",
                                          "no-host-transfer"}


def test_rule_bits_are_distinct_powers_of_two():
    codes = ([r.code for r in COMPILED_RULES] + [BUILD_ERROR_CODE]
             + [bit for bit, _ in NO_COUNTERPART.values()])
    assert len(set(codes)) == len(codes)
    for c in codes:
        assert c > 0 and (c & (c - 1)) == 0


def test_declared_donation_is_a_usage_error(f32, fixture_builder):
    with pytest.raises(contracts.ContractUsageError, match="alias"):
        Contract(donate_argnums=(0,))

    def donating():
        return CompiledProgram("fixture.donate", None,
                               Contract(donate_argnums=(0,)))

    fixture_builder("fixture.donate", donating)
    with pytest.raises(RuntimeError, match="counterpart"):
        contracts.build_all(only=["fixture.donate"], device="cpu")
    assert rules.main(["--only", "fixture.donate", "--device", "cpu"]) == 2


def _runner(*args, env=None):
    return subprocess.run(
        [sys.executable, "-m", "tempo_tpu_torch.plan.contracts", *args],
        capture_output=True, text=True, timeout=300, cwd=REPO,
        env=dict(os.environ, **(env or {})))


@pytest.mark.parametrize("args,env,text", [
    (("--device", "cpu"), {"TEMPO_TPU_COMPUTE_DTYPE": "float64"},
     "compiled tier cannot run"),
    (("--device", "cpu", "--rule", "no-such-rule"), None,
     "unknown compiled rule"),
    (("--device", "cpu", "--rule", "donation-applied"), None,
     "no counterpart"),
    (("--device", "cpu", "--only", "no.such.program"), None,
     "unknown contract program"),
    (("--device", "cpu"), {"TEMPO_TPU_SORT_KERNELS": "0"},
     "compiled tier cannot run"),
], ids=["f64-policy", "unknown-rule", "donation-rule", "unknown-program",
        "sort-kernels-off"])
def test_usage_errors_exit_2(args, env, text):
    proc = _runner(*args, env=env)
    assert proc.returncode == 2, proc.stdout + proc.stderr
    assert text in proc.stderr


def test_docs_rule_table_agrees():
    """The runner's docstring and the README list every rule with its
    bit, and the rule without a counterpart by name."""
    readme = (REPO / "README.md").read_text()
    for text in (rules.__doc__, readme):
        for rule in COMPILED_RULES:
            assert rule.name in text and str(rule.code) in text, rule.name
        for name, (bit, _) in NO_COUNTERPART.items():
            assert name in text and str(bit) in text
        assert "build-error" in text


# ----------------------------------------------------------------------
# the registry is clean at head
# ----------------------------------------------------------------------

def test_registry_builds_on_the_cpu_with_zero_findings(f32):
    programs, chains, errors = contracts.build_all(device="cpu")
    assert errors == {}
    findings, code = run_compiled(list(COMPILED_RULES), programs, chains,
                                  errors)
    assert findings == [] and code == 0, [f.render() for f in findings]
    assert {c.name for c in chains} == {"plan.mesh_chain",
                                        "serve.cohort_loop"}
    assert all(p.graph is None for p in programs)      # nothing captured
    moved = {p.name: profiling.comm_bytes_from_record(p.record)
             for p in programs}
    assert moved["fused.asof_stats_ema"] == {}
    assert moved["serve.cohort_push"] == {}
    assert moved["dist.align3"] == {"all-gather": 5 * 8 * 32 * 4}


def test_runner_clean_at_head():
    proc = _runner("--device", "cpu")
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "compiled contracts clean over 24 program(s), 2 chain(s)" \
        in proc.stderr


# ----------------------------------------------------------------------
# parity with the reference
# ----------------------------------------------------------------------

def test_registry_names_equal_the_reference():
    from tempo_tpu.plan import contracts as ref

    assert contracts.names() == ref.names()
    assert contracts.CONTRACT_SERIES == ref.CONTRACT_SERIES
    assert contracts.CONTRACT_ROWBOUNDS == ref.CONTRACT_ROWBOUNDS
    assert contracts.contract_lanes() == ref.contract_lanes()


def test_rules_and_bits_equal_the_reference():
    from tools.analysis.compiled import COMPILED_RULES as REF_RULES
    from tools.analysis.compiled.core import BUILD_ERROR_CODE as REF_BUILD

    port = {r.name: r.code for r in COMPILED_RULES}
    port.update({n: bit for n, (bit, _) in NO_COUNTERPART.items()})
    assert port == {r.name: r.code for r in REF_RULES}
    assert set(NO_COUNTERPART) == {"donation-applied"}
    assert BUILD_ERROR_CODE == REF_BUILD
    assert profiling.COLLECTIVE_TOLERANCE == __import__(
        "tempo_tpu.profiling", fromlist=["x"]).COLLECTIVE_TOLERANCE


def test_operands_and_modeled_bytes_equal_the_reference(f32):
    """The contract operands are the reference's from the same seeds, and
    the alignment's modeled bytes (the reference's all-gather model,
    ``_nbytes(planes)`` of ``dist.align3``) and the layout switch's
    per-shard figure (``relayout_comm_bytes``) equal the reference's at
    the same shapes."""
    from tempo_tpu import dist as ref_dist
    from tempo_tpu.plan import contracts as ref
    from tempo_tpu.plan import fused as ref_fused

    a = ref._mesh_arrays(ref._series_mesh())
    mine = contracts._arrays()
    for k in ("ts", "x", "valid", "rvals", "rvalids"):
        assert np.array_equal(np.asarray(a[k]), mine[k]), k
    planes, _ = ref_fused._right_stacks(a["ts"], a["valid"], a["rvals"],
                                        a["rvalids"])
    programs, _, errors = contracts.build_all(only=["plan.mesh_chain"],
                                              device="cpu")
    assert errors == {}
    (align,) = [p for p in programs if p.name == "dist.align3"]
    assert align.contract.collectives["all-gather"] == ref._nbytes(planes)
    K, L = mine["ts"].shape
    assert dist.relayout_comm_bytes(K, L, 2, 8) == \
        ref_dist.relayout_comm_bytes(K, L, 2, 8, has_seq=False)
