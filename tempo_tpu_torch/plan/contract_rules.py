"""The rules of the compiled contracts and their runner.

Counterpart of the reference's compiled-contract tier
(``tools/analysis/compiled/``: its engine, its rule battery and its
runner): each rule checks one guarantee of the programs
``plan/contracts.py`` builds against the contract declared beside them.
Each rule owns a power-of-two exit bit, the reference's:

==================== ====  ============================================
no-f64-leak             1  an op with a float64 output of at least one
                           dimension in the record (0-d is tolerated)
no-host-transfer        2  a scalar read or copy to the CPU in the
                           record; a graph memcpy node with a host or
                           pinned end, or a host node, on the card
collective-inventory    4  moves between distinct mesh entries by kind
                           against the declared model, within
                           ``profiling.COLLECTIVE_TOLERANCE``; no
                           unmodeled kind, no vanished kind
donation-applied        8  no counterpart (:data:`NO_COUNTERPART`); the
                           bit stays reserved
stage-sharding-match   16  chained stage N's output placement (each
                           shard's entry and block) equals stage N+1's
                           input placement; dropped axes unsharded
recompile-coverage     32  every parameter of a ``PLANNED_METHODS`` op
                           method feeds its recorded plan node
build-error            64  a registry program failed to build
==================== ====  ============================================

A finding is silenced by ``# lint-ok: <rule>: <reason>`` on (or next to)
the program builder's ``@register`` line.  The runner::

    python -m tempo_tpu_torch.plan.contracts [--only NAME ...]
        [--rule RULE ...] [--device cpu|cuda]

prints the findings and exits with the OR of their bits; an unknown rule
or program, or a missing precondition, is a usage error (exit 2), as in
the reference.
"""

from __future__ import annotations

import argparse
import ast
import inspect
import os
import re
import sys
import textwrap
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

#: exit bit of a registry program that fails to build
BUILD_ERROR_CODE = 64

#: the reference's rules that have no counterpart here, with the reason
NO_COUNTERPART = {
    "donation-applied": (
        8, "a replay copies each input into the graph's static input "
           "(plan/fused.py Captured.replay), so no caller's tensor is ever "
           "aliased; a contract that declares donation is a usage error"),
}


@dataclass(frozen=True)
class Finding:
    program: str            # registry program (or chain) name
    rule: str
    message: str

    def render(self) -> str:
        return f"compiled:{self.program}: [{self.rule}] {self.message}"


@dataclass(frozen=True)
class _Site:
    """A suppressible anchor that is not a program: a registry-level
    finding points at the offending method's def line."""

    name: str
    source_file: str
    source_line: int


def _suppressed(program, rule_name: str) -> bool:
    """True when the builder's ``@register`` site (the decorator lines
    and the def line) carries ``# lint-ok: <rule>: <reason>``."""
    src = getattr(program, "source_file", "")
    line = getattr(program, "source_line", 0)
    if not src or not line:
        return False
    try:
        lines = Path(src).read_text().splitlines()
    except OSError:
        return False
    pat = re.compile(rf"#\s*lint-ok:\s*{re.escape(rule_name)}\s*:\s*\S")
    lo, hi = max(0, line - 4), min(len(lines), line + 2)
    return any(pat.search(lines[i]) for i in range(lo, hi))


class CompiledRule:
    """One decidable bug class of a built program."""

    name: str = ""
    code: int = 0
    doc: str = ""

    def check_program(self, program) -> List[Finding]:
        return []

    def check_chains(self, programs: Sequence, chains: Sequence
                     ) -> List[Finding]:
        return []

    def check_registry(self) -> List[Finding]:
        return []

    def finding(self, program, message: str) -> Optional[Finding]:
        """A finding against ``program``, unless its site suppresses it."""
        if _suppressed(program, self.name):
            return None
        name = program if isinstance(program, str) else program.name
        return Finding(name, self.name, message)


def run_compiled(rules: Sequence[CompiledRule], programs: Sequence,
                 chains: Sequence, errors: Dict[str, str],
                 registry: bool = True) -> Tuple[List[Finding], int]:
    """Run every rule over every program (and the chain and registry
    passes); ``errors`` (builder name -> message) become ``build-error``
    findings.  Returns (findings, exit code)."""
    findings: List[Finding] = []
    exit_code = 0
    for name, msg in sorted(errors.items()):
        findings.append(Finding(
            name, "build-error",
            f"registry program failed to build: {msg}"))
        exit_code |= BUILD_ERROR_CODE
    for rule in rules:
        found: List[Finding] = []
        for program in programs:
            found += rule.check_program(program)
        found += rule.check_chains(programs, chains)
        if registry:
            found += rule.check_registry()
        findings += found
        if found:
            exit_code |= rule.code
    findings.sort(key=lambda f: (f.program, f.rule))
    return findings, exit_code


# ----------------------------------------------------------------------
# The rules
# ----------------------------------------------------------------------

class NoF64LeakRule(CompiledRule):
    name = "no-f64-leak"
    code = 1
    doc = ("no op with a float64 output of one dimension or more in a "
           "program built under the float32 compute policy")

    def check_program(self, program) -> List[Finding]:
        from tempo_tpu_torch import profiling

        if program.contract.allow_f64:
            return []
        hits = profiling.f64_ops_from_record(program.record)
        if not hits:
            return []
        f = self.finding(
            program,
            f"{len(hits)} float64 op output(s) in a float32-policy program "
            f"(a dtype-less constant or a widening cast: on the card a "
            f"float64 plane runs at 1/2 the float32 rate and breaks the "
            f"bitwise match with the reference).  First: {hits[0]}")
        return [f] if f else []


class NoHostTransferRule(CompiledRule):
    name = "no-host-transfer"
    code = 2
    doc = ("no scalar read or copy to the CPU in the record, and no graph "
           "node with a host end, outside a declared barrier")

    def check_program(self, program) -> List[Finding]:
        from tempo_tpu_torch import profiling

        if program.contract.host_transfer_ok is not None:
            return []
        hits = (profiling.host_transfers_from_record(program.record)
                + profiling.host_transfers_from_graph(program.graph_nodes()))
        if not hits:
            return []
        f = self.finding(
            program,
            f"{len(hits)} host-transfer(s) in a program declared "
            f"device-resident (declare the barrier in the contract if it "
            f"is intentional).  First: {hits[0]}")
        return [f] if f else []


class CollectiveInventoryRule(CompiledRule):
    name = "collective-inventory"
    code = 4
    doc = ("moves between distinct mesh entries match the declared "
           "per-kind byte model within the shared tolerance; no "
           "unmodeled kinds")

    def check_program(self, program) -> List[Finding]:
        from tempo_tpu_torch import profiling

        contract = program.contract
        measured = profiling.comm_bytes_from_record(program.record)
        out: List[Optional[Finding]] = []
        for kind, model in sorted(contract.collectives.items()):
            got = measured.get(kind, 0)
            tol = contract.tolerances.get(
                kind, profiling.COLLECTIVE_TOLERANCE.get(kind, 1.25))
            if got == 0:
                out.append(self.finding(
                    program,
                    f"declared collective '{kind}' ({model} B modeled) is "
                    f"ABSENT from the record: the moves the model budgets "
                    f"for no longer happen; re-derive the model"))
            elif not (model <= got <= tol * model):
                out.append(self.finding(
                    program,
                    f"collective '{kind}' moved {got} B vs the modeled "
                    f"{model} B (outside [1x, {tol}x]: an extra move or a "
                    f"wrong halo width)"))
        for kind, got in sorted(measured.items()):
            if kind in contract.collectives:
                continue
            ceiling = contract.incidental.get(kind)
            if ceiling is None:
                out.append(self.finding(
                    program,
                    f"UNMODELED collective '{kind}' ({got} B) in the "
                    f"record: declare a model (or an incidental ceiling) "
                    f"so the byte budget stays honest"))
            elif got > ceiling:
                out.append(self.finding(
                    program,
                    f"incidental collective '{kind}' moved {got} B, over "
                    f"its declared {ceiling} B ceiling"))
        return [f for f in out if f is not None]


def _placement_key(p, drop: int = 0):
    """A placement as its entries and, per dimension counted from the
    right, each shard's slice, None where every shard holds it whole
    (a whole dimension places nothing, whatever its length)."""
    blocks = [b[drop:] for b in p.blocks]
    nd = len(blocks[0]) if blocks else 0
    size = {d: max(b[d].stop for b in blocks) for d in range(nd)}
    dims = []
    for d in range(nd):
        whole = all(b[d].start == 0 and b[d].stop == size[d] for b in blocks)
        dims.append(None if whole else tuple((b[d].start, b[d].stop)
                                             for b in blocks))
    return tuple(p.entries), tuple(reversed(dims))


class StageShardingMatchRule(CompiledRule):
    name = "stage-sharding-match"
    code = 16
    doc = ("declared chain links: the producer's output placement equals "
           "the consumer's input placement (no implicit move between "
           "chained programs)")

    def check_chains(self, programs: Sequence, chains: Sequence
                     ) -> List[Finding]:
        by_name = {p.name: p for p in programs}
        out = [self._check_link(chain, link, by_name)
               for chain in chains for link in chain.links]
        return [f for f in out if f is not None]

    def _check_link(self, chain, link, by_name) -> Optional[Finding]:
        where = (f"{link.producer}[{link.out_idx}] -> "
                 f"{link.consumer}[{link.in_idx}]")
        prod = by_name.get(link.producer)
        cons = by_name.get(link.consumer)
        if prod is None or cons is None:
            return self.finding(chain, f"chain link {where} names a "
                                       f"program that did not build")
        if link.out_idx >= len(prod.outputs) \
                or link.in_idx >= len(cons.inputs):
            return self.finding(
                chain, f"chain link {where} is out of range "
                       f"({len(prod.outputs)} outputs / {len(cons.inputs)} "
                       f"inputs)")
        p = prod.outputs[link.out_idx]
        c = cons.inputs[link.in_idx]
        if link.drop_leading:
            entries, dims = _placement_key(p)
            dropped = dims[len(dims) - link.drop_leading:]
            if any(d is not None for d in dropped):
                return self.finding(
                    chain,
                    f"chain link {where}: the {link.drop_leading} "
                    f"host-sliced leading axis(es) are SHARDED: slicing "
                    f"them changes which entry holds which rows")
        pk = _placement_key(p, link.drop_leading)
        ck = _placement_key(c)
        n = min(len(pk[1]), len(ck[1]))
        extra = pk[1][n:] + ck[1][n:]
        if pk[0] != ck[0] or pk[1][:n] != ck[1][:n] \
                or any(d is not None for d in extra):
            return self.finding(
                chain,
                f"stage-boundary placement mismatch at {where}: the "
                f"producer writes entries {list(pk[0])} with blocks "
                f"{pk[1]}, the consumer expects {list(ck[0])} with "
                f"{ck[1]}: chaining these programs inserts a move")
        return None


class RecompileCoverageRule(CompiledRule):
    name = "recompile-coverage"
    code = 32
    doc = ("every parameter of a PLANNED_METHODS op method feeds the "
           "recorded plan node (params dict or frame operands): a cache "
           "hit can never replay a stale graph")

    def check_registry(self) -> List[Finding]:
        from tempo_tpu_torch import dist as dist_mod
        from tempo_tpu_torch import frame as frame_mod
        from tempo_tpu_torch.plan import ir

        classes = {"TSDF": frame_mod.TSDF,
                   "DistributedTSDF": dist_mod.DistributedTSDF}
        out: List[Optional[Finding]] = []
        for cls_name, methods in ir.PLANNED_METHODS.items():
            cls = classes.get(cls_name)
            if cls is None:
                out.append(self.finding(
                    f"registry:{cls_name}",
                    f"PLANNED_METHODS class {cls_name!r} not found"))
                continue
            out += [self._check_method(cls_name, cls, m) for m in methods]
        return [f for f in out if f is not None]

    def _check_method(self, cls_name: str, cls, method: str
                      ) -> Optional[Finding]:
        site = f"registry:{cls_name}.{method}"
        fn = getattr(cls, method, None)
        if fn is None:
            return self.finding(site, "method missing (PLANNED_METHODS "
                                      "drift)")
        try:
            sig = inspect.signature(fn)
            src = textwrap.dedent(inspect.getsource(fn))
            site = _Site(site, inspect.getsourcefile(fn) or "",
                         inspect.getsourcelines(fn)[1])
        except (OSError, TypeError, ValueError) as e:
            return self.finding(site, f"source unavailable: {e}")
        recorded, operands = self._recorded_names(src)
        if recorded is None:
            return self.finding(
                site, "no _plan_record call found in the method body")
        missing = [p.name for p in sig.parameters.values()
                   if p.name not in ("self", "cls")
                   and p.kind is not inspect.Parameter.VAR_KEYWORD
                   and p.name not in recorded and p.name not in operands]
        if missing:
            return self.finding(
                site,
                f"parameter(s) {missing} are NOT recorded into the plan "
                f"node (neither a params key nor a frame operand): two "
                f"calls differing only there share a plan signature, so a "
                f"cache hit would replay a STALE graph built for the "
                f"other value")
        return None

    @staticmethod
    def _recorded_names(src: str):
        """(params keys, operand names) of the method's
        ``_plan_record(op, others, params, objs)`` call, or (None, None)
        when there is none."""
        try:
            tree = ast.parse(src)
        except SyntaxError:
            return None, None
        for node in ast.walk(tree):
            if not (isinstance(node, ast.Call)
                    and isinstance(node.func, ast.Attribute)
                    and node.func.attr == "_plan_record"):
                continue
            others = node.args[1] if len(node.args) > 1 else None
            params = node.args[2] if len(node.args) > 2 else None
            for kw in node.keywords:
                if kw.arg == "others":
                    others = kw.value
                elif kw.arg == "params":
                    params = kw.value
            keys = set()
            if isinstance(params, ast.Call):        # dict(colName=...)
                keys |= {kw.arg for kw in params.keywords if kw.arg}
            elif isinstance(params, ast.Dict):      # {"colName": ...}
                keys |= {k.value for k in params.keys
                         if isinstance(k, ast.Constant)
                         and isinstance(k.value, str)}
            operands = set()
            if isinstance(others, (ast.Tuple, ast.List)):
                for elt in others.elts:
                    operands |= {sub.id for sub in ast.walk(elt)
                                 if isinstance(sub, ast.Name)}
            return keys, operands
        return None, None


COMPILED_RULES: Tuple[CompiledRule, ...] = (
    NoF64LeakRule(),
    NoHostTransferRule(),
    CollectiveInventoryRule(),
    StageShardingMatchRule(),
    RecompileCoverageRule(),
)


# ----------------------------------------------------------------------
# The runner
# ----------------------------------------------------------------------

def main(argv: Optional[Sequence[str]] = None) -> int:
    """Build the registry (or ``--only`` names), run the rules (or
    ``--rule`` names), print the findings; return the OR of their bits,
    or 2 on a usage error."""
    ap = argparse.ArgumentParser(
        prog="python -m tempo_tpu_torch.plan.contracts",
        description="check the port's compiled contracts")
    ap.add_argument("--only", nargs="+", metavar="NAME",
                    help="registry programs to build (default all)")
    ap.add_argument("--rule", action="append", metavar="RULE",
                    help="rules to run (default all; repeatable)")
    ap.add_argument("--device", choices=("cpu", "cuda"), default=None,
                    help="where the programs run (default the card)")
    args = ap.parse_args(argv)
    os.environ.setdefault("TEMPO_TPU_COMPUTE_DTYPE", "float32")

    from tempo_tpu_torch.plan import contracts

    battery = list(COMPILED_RULES)
    if args.rule:
        known = {r.name: r for r in COMPILED_RULES}
        unknown = [n for n in args.rule if n not in known]
        if unknown:
            why = "; ".join(f"{n}: no counterpart ({NO_COUNTERPART[n][1]})"
                            for n in unknown if n in NO_COUNTERPART)
            print(f"unknown compiled rule(s): {', '.join(unknown)} "
                  f"(known: {', '.join(known)}){'; ' + why if why else ''}",
                  file=sys.stderr)
            return 2
        battery = [known[n] for n in args.rule]
    try:
        built, chains, errors = contracts.build_all(only=args.only,
                                                    device=args.device)
    except (RuntimeError, KeyError) as e:
        # a precondition or an unknown program is a usage error (exit
        # 2, argparse's status), not a finding: exit 1 would read as the
        # no-f64-leak bit
        print(f"compiled tier cannot run: {e}", file=sys.stderr)
        return 2
    findings, exit_code = run_compiled(battery, built, chains, errors)
    for f in findings:
        print(f.render())
    summary = f"{len(built)} program(s), {len(chains)} chain(s)"
    if findings:
        by_rule: Dict[str, int] = {}
        for f in findings:
            by_rule[f.rule] = by_rule.get(f.rule, 0) + 1
        detail = ", ".join(f"{r}: {n}" for r, n in sorted(by_rule.items()))
        print(f"{len(findings)} compiled-contract finding(s) ({detail}) "
              f"over {summary}; exit code {exit_code}", file=sys.stderr)
    else:
        print(f"compiled contracts clean over {summary}", file=sys.stderr)
    return exit_code
