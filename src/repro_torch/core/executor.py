"""Plan -> program: execute a FusionPlan on live tensors.

``compile_plan`` lowers a ``planner.FusionPlan`` into a ``Program`` — a
``state -> state`` function in which every fused bundle runs as ONE launch
of the bundle kernel (``SearchResult.build()``: the tuned schedule and the
tuned block-shrink variant), every leftover op runs as a one-member launch
(``hfuse.run_single``), and operands flow through a
``binding.BindingRegistry``.  Bundles are contracted to super-nodes and the
contracted graph is topologically sorted; a cycle between bundles is an
error (the planner never forms one).

The tensors' device decides what runs: CUDA tensors launch the kernels,
CPU tensors run the plain versions.  ``plain=True`` is the explicit opt-in
that runs the plain versions on the card as well.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional, Sequence

from repro_torch.core import hfuse
from repro_torch.core.binding import BindingRegistry, State, default_bindings
from repro_torch.core.op_spec import OpSpec
from repro_torch.core.planner import FusionPlan, GraphOp


@dataclass
class ProgramStep:
    """One launch of the compiled program."""
    members: tuple[str, ...]
    call: Callable                      # fused bundle or one-op launch
    ops: tuple[OpSpec, ...]             # execution OpSpecs (tuned variant)
    fused: bool
    schedule: Optional[str] = None      # ratio label, fused steps only

    def describe(self) -> dict:
        return {"members": "+".join(self.members),
                "kind": "fused" if self.fused else "single",
                "schedule": self.schedule}


@dataclass(eq=False)
class Program:
    """Executable lowering of a FusionPlan: ``program(state) -> state``."""
    steps: list[ProgramStep]
    bindings: BindingRegistry
    graph: tuple[GraphOp, ...]

    def __call__(self, state: State) -> State:
        for step in self.steps:
            args = [a for op in step.ops
                    for a in self.bindings.inputs(op, state)]
            outs = step.call(*args)
            off = 0
            for op in step.ops:
                n = len(op.outputs)
                state = self.bindings.commit(op, state, outs[off:off + n])
                off += n
        return state

    def describe(self) -> list[dict]:
        return [s.describe() for s in self.steps]

    @property
    def n_fused(self) -> int:
        return sum(1 for s in self.steps if s.fused)

    @property
    def fused_members(self) -> list[tuple[str, ...]]:
        """Member names of each fused launch (the co-residency record)."""
        return [s.members for s in self.steps if s.fused]


def _toposort(nodes: dict[int, set[int]], order: Sequence[int]) -> list[int]:
    """Kahn's algorithm, stable in the given node order."""
    indeg = {n: len(d) for n, d in nodes.items()}
    users: dict[int, list[int]] = {n: [] for n in nodes}
    for n, deps in nodes.items():
        for d in deps:
            users[d].append(n)
    ready = [n for n in order if indeg[n] == 0]
    out: list[int] = []
    while ready:
        n = ready.pop(0)
        out.append(n)
        for u in users[n]:
            indeg[u] -= 1
            if indeg[u] == 0:
                ready.append(u)
    if len(out) != len(nodes):
        stuck = sorted(set(nodes) - set(out))
        raise ValueError(
            f"fusion plan is not executable: dependency cycle through "
            f"bundle nodes {stuck} (two bundles feed each other)")
    return out


def compile_plan(plan: FusionPlan, graph: Optional[Sequence[GraphOp]] = None,
                 bindings: Optional[BindingRegistry] = None, *,
                 plain: bool = False) -> Program:
    """Lower ``plan`` over ``graph`` (default: the graph the plan was built
    from) into an executable Program.  ``bindings`` must cover every named
    operand of every graph op."""
    graph = tuple(graph if graph is not None else (plan.graph or ()))
    if not graph:
        raise ValueError("compile_plan needs the planner graph "
                         "(plan.graph is empty and none was passed)")
    by_name = {g.op.name: g for g in graph}

    node_members: list[tuple[str, ...]] = \
        [d.members for d in plan.fused] + [(s,) for s in plan.singles]
    covered = [m for ms in node_members for m in ms]
    if sorted(covered) != sorted(by_name):
        raise ValueError(
            f"plan does not cover the graph exactly: plan={sorted(covered)} "
            f"graph={sorted(by_name)}")
    node_of = {m: i for i, ms in enumerate(node_members) for m in ms}
    deps: dict[int, set[int]] = {i: set() for i in range(len(node_members))}
    for i, ms in enumerate(node_members):
        for m in ms:
            for d in by_name[m].deps:
                if d in node_of and node_of[d] != i:
                    deps[i].add(node_of[d])

    order = _toposort(deps, range(len(node_members)))

    if bindings is None:
        bindings = default_bindings([g.op for g in graph])
    decisions = {d.members: d for d in plan.fused}
    steps: list[ProgramStep] = []
    for i in order:
        members = node_members[i]
        if members in decisions:
            res = decisions[members].result
            steps.append(ProgramStep(members, res.build(plain=plain),
                                     tuple(res.ops), True,
                                     res.best.sched.label()))
        else:
            op = by_name[members[0]].op
            steps.append(ProgramStep(members,
                                     hfuse.run_single(op, plain=plain),
                                     (op,), False))
        for op in steps[-1].ops:
            bindings.validate(op)
    return Program(steps=steps, bindings=bindings, graph=graph)
