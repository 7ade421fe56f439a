"""Graph-level fusion planner — decides WHICH independent ops to fuse.

The reference's planner (``src/repro/core/planner.py:260``), unchanged in
its decisions:

  1. contract declared epilogue chains into stitched members,
  2. classify every op by roofline bound (compute vs memory),
  3. build the dependency closure (never fuse ops on a dependent path),
  4. seed a bundle with the largest unused memory-bound op and its
     closest-native-time compute partner (the paper's Fig. 7),
  5. grow it up to ``max_ways`` members by largest marginal predicted gain,
  6. keep bundles whose tuned predicted gain clears ``min_gain_pct``.

The predicted gains are cost-model numbers under the planning profile
(``core/profile.py``), not card times.  With ``measure=`` every accepted
bundle's final schedule is picked by measurement and admitted on its
measured gain over the profiled native launches (``run_native``), unless
the measure only ranks (the step-count proxy).  ``cache=`` makes a replan
of an unchanged graph search nothing.
"""
from __future__ import annotations

import contextlib
from dataclasses import dataclass
from typing import Callable, Optional, Sequence

from repro_torch.core import autotuner, hfuse, stitch
from repro_torch.core.cost_model import native_time
from repro_torch.core.op_spec import OpSpec
from repro_torch.core.schedule_cache import ScheduleCache


@dataclass
class GraphOp:
    op: OpSpec
    deps: frozenset[str] = frozenset()       # names of ops this one reads from


@dataclass
class FusionDecision:
    members: tuple[str, ...]
    result: autotuner.SearchResult
    predicted_speedup_pct: float
    measured_speedup_pct: Optional[float] = None   # set when plan(measure=)


@dataclass
class FusionPlan:
    fused: list[FusionDecision]
    singles: list[str]
    rejected: list[tuple[str, str, str]]     # (members..., last, reason)
    graph: tuple["GraphOp", ...] = ()        # the (contracted) planned graph

    def summary(self) -> list[dict]:
        rows = [{
            "members": "+".join(d.members),
            "schedule": d.result.best.sched.label(),
            "vmem_cap": d.result.best.vmem_cap,
            "predicted_speedup_pct": round(d.predicted_speedup_pct, 1),
            "measured_speedup_pct": (None if d.measured_speedup_pct is None
                                     else round(d.measured_speedup_pct, 1)),
        } for d in self.fused]
        rows += [{"members": s, "schedule": "-", "vmem_cap": None,
                  "predicted_speedup_pct": 0.0, "measured_speedup_pct": None}
                 for s in self.singles]
        return rows


def _reachable(ops: dict[str, GraphOp]) -> dict[str, frozenset]:
    """Transitive dependency closure."""
    memo: dict[str, frozenset] = {}

    def visit(n: str) -> frozenset:
        if n in memo:
            return memo[n]
        acc = set(ops[n].deps)
        for d in ops[n].deps:
            if d in ops:
                acc |= visit(d)
        memo[n] = frozenset(acc)
        return memo[n]

    for n in ops:
        visit(n)
    return memo


def independent(ops: dict[str, GraphOp], a: str, b: str,
                clo: dict[str, frozenset] | None = None) -> bool:
    clo = clo if clo is not None else _reachable(ops)
    return b not in clo[a] and a not in clo[b]


def _independent_of_all(clo: dict[str, frozenset], bundle: Sequence[OpSpec],
                        cand: OpSpec) -> bool:
    return all(cand.name not in clo[m.name] and m.name not in clo[cand.name]
               for m in bundle)


def _contracted_acyclic(ops: dict[str, GraphOp],
                        bundles: Sequence[Sequence[str]]) -> bool:
    """True iff contracting each bundle to one super-node leaves the
    dependency graph acyclic (what ``executor`` can order)."""
    gid: dict[str, int] = {}
    for i, members in enumerate(bundles):
        for name in members:
            gid[name] = i
    n = len(bundles)
    for name in ops:
        if name not in gid:
            gid[name] = n
            n += 1
    edges: dict[int, set[int]] = {i: set() for i in range(n)}
    indeg = [0] * n
    for name, g in ops.items():
        for d in g.deps:
            if d in gid and gid[d] != gid[name] \
                    and gid[name] not in edges[gid[d]]:
                edges[gid[d]].add(gid[name])
                indeg[gid[name]] += 1
    ready = [i for i in range(n) if indeg[i] == 0]
    seen = 0
    while ready:
        seen += 1
        for w in edges[ready.pop()]:
            indeg[w] -= 1
            if indeg[w] == 0:
                ready.append(w)
    return seen == n


def _contract_chains(graph: Sequence[GraphOp]) -> tuple[GraphOp, ...]:
    """Contract declared epilogue chains (``OpSpec.epilogue``) into single
    stitched GraphOps: iff the consumer is the producer's only reader,
    ``stitch.can_stitch`` accepts the pair and the contraction stays
    acyclic.  Any other declared pair is left unstitched."""
    ops = {g.op.name: g for g in graph}
    readers: dict[str, list[str]] = {n: [] for n in ops}
    for g in graph:
        for d in g.deps:
            if d in readers:
                readers[d].append(g.op.name)

    pairs: list[tuple[str, str]] = []
    taken: set[str] = set()
    for g in graph:
        if g.op.epilogue is None:
            continue
        pname = g.op.name
        cname, operand = g.op.epilogue
        if (cname not in ops or pname in taken or cname in taken
                or readers[pname] != [cname]
                or stitch.can_stitch(g.op, ops[cname].op, operand)
                is not None
                or not _contracted_acyclic(ops, pairs + [(pname, cname)])):
            continue
        pairs.append((pname, cname))
        taken |= {pname, cname}
    if not pairs:
        return tuple(graph)

    chainof: dict[str, str] = {}
    chain_at: dict[str, GraphOp] = {}
    for pname, cname in pairs:
        p, c = ops[pname], ops[cname]
        cop = stitch.stitch(p.op, c.op, p.op.epilogue[1])
        chainof[pname] = chainof[cname] = cop.name
        deps = (set(p.deps) | set(c.deps)) - {pname, cname}
        chain_at[pname] = GraphOp(cop, frozenset(deps))

    def mapdeps(ds: frozenset[str]) -> frozenset[str]:
        return frozenset(chainof.get(d, d) for d in ds)

    consumed = {c for _p, c in pairs}
    out: list[GraphOp] = []
    for g in graph:
        n = g.op.name
        if n in consumed:
            continue
        if n in chain_at:
            ch = chain_at[n]
            out.append(GraphOp(ch.op, mapdeps(ch.deps)))
        else:
            out.append(GraphOp(g.op, mapdeps(g.deps)))
    return tuple(out)


def _bundle_search(bundle: Sequence[OpSpec],
                   memo: dict[frozenset, autotuner.SearchResult],
                   cache: Optional[ScheduleCache],
                   mesh_tag: str = "") -> autotuner.SearchResult:
    """Autotune a bundle, memoized per member-name set within one plan."""
    key = frozenset(op.name for op in bundle)
    if key not in memo:
        memo[key] = autotuner.search(tuple(bundle), cache=cache,
                                     mesh_tag=mesh_tag)
    return memo[key]


def _bundle_cost(bundle: Sequence[OpSpec],
                 memo: dict[frozenset, autotuner.SearchResult],
                 cache: Optional[ScheduleCache],
                 mesh_tag: str = "") -> float:
    return _bundle_search(bundle, memo, cache, mesh_tag).best.est.t_hfused


def _measured_speedup(res: autotuner.SearchResult, bundle: Sequence[OpSpec],
                      measure: Callable,
                      cache: Optional[ScheduleCache]) -> Optional[float]:
    """The tuned fused launch against the native baseline (one launch per
    member), both measured.  The native time rides in the bundle's cache
    entry (``native_s``), so a replan profiles nothing."""
    if res.best.measured_s is None:
        return None
    entry = (cache.entries.get(res.cache_key)
             if cache is not None and res.cache_key else None)
    t_native = entry.get("native_s") if entry else None
    if t_native is None:
        t_native = measure(hfuse.run_native(tuple(bundle)), *bundle)
        if entry is not None:
            entry["native_s"] = t_native
            cache.put(res.cache_key, entry)   # respects batched() deferral
    return 100.0 * (t_native - res.best.measured_s) / max(t_native, 1e-30)


def _starves_unseeded(graph, ops, clo, used: set[str],
                      bundle: Sequence[OpSpec], x: OpSpec) -> bool:
    """True iff absorbing ``x`` into ``bundle`` would leave some
    not-yet-seeded memory-bound op with ZERO fusion partners (the serve
    graph's {decode_attn, chunk0} must not swallow chunk1, the FFN chain's
    only partner)."""
    names_now = {b.name for b in bundle}
    taken = used | names_now | {x.name}
    for g in graph:
        mp = g.op
        if mp.bound != "memory" or mp.name in taken:
            continue
        if _independent_of_all(clo, bundle, mp):
            continue
        if not independent(ops, mp.name, x.name, clo):
            continue
        if not any(h.op.name not in taken and h.op.name != mp.name
                   and independent(ops, mp.name, h.op.name, clo)
                   for h in graph):
            return True
    return False


def plan(graph: Sequence[GraphOp], *, min_gain_pct: float = 2.0,
         allow_same_bound: bool = False, max_ways: int = 2,
         measure: Optional[Callable] = None,
         cache: Optional[ScheduleCache] = None,
         mesh_tag: str = "") -> FusionPlan:
    """Build <= ``max_ways``-way fusion bundles over the independent ops
    (epilogue chains contracted first).  ``measure``: profiling callable
    (``core/timing.make_measure``) for the accepted bundles' schedules and
    measured gains; ``cache``: every search consults it first.
    ``mesh_tag`` (``"<axis>:<extent>"``) marks a plan over one shard's op
    shapes of a tensor-parallel mesh: it keys every cached schedule, so a
    sharded replan resolves only sharded entries."""
    graph = _contract_chains(graph)
    ops = {g.op.name: g for g in graph}
    memo: dict[frozenset, autotuner.SearchResult] = {}
    batch = cache.batched() if cache is not None else contextlib.nullcontext()
    with batch:
        return _plan_inner(graph, ops, memo, min_gain_pct, allow_same_bound,
                           max_ways, measure, cache, mesh_tag)


def _plan_inner(graph, ops, memo, min_gain_pct, allow_same_bound, max_ways,
                measure, cache, mesh_tag="") -> FusionPlan:
    clo = _reachable(ops)
    mem = sorted((g.op for g in graph if g.op.bound == "memory"),
                 key=lambda o: -o.t_native)
    comp = sorted((g.op for g in graph if g.op.bound == "compute"),
                  key=lambda o: -o.t_native)

    used: set[str] = set()
    fused: list[FusionDecision] = []
    accepted: list[tuple[str, ...]] = []
    rejected: list[tuple[str, str, str]] = []

    for m in mem:
        if m.name in used:
            continue
        partners = [c for c in comp if c.name not in used
                    and independent(ops, m.name, c.name, clo)
                    and _contracted_acyclic(ops,
                                            accepted + [(m.name, c.name)])]
        if not partners and allow_same_bound:
            partners = [c.op for c in graph
                        if c.op.name not in used and c.op.name != m.name
                        and independent(ops, m.name, c.op.name, clo)
                        and _contracted_acyclic(
                            ops, accepted + [(m.name, c.op.name)])]
        if not partners:
            continue
        c = min(partners, key=lambda o: abs(o.t_native - m.t_native))
        bundle = [m, c]

        t_now = _bundle_cost(bundle, memo, cache, mesh_tag)
        while len(bundle) < max_ways:
            names_now = tuple(b.name for b in bundle)
            pool = [g.op for g in graph
                    if g.op.name not in used
                    and g.op.name not in names_now
                    and _independent_of_all(clo, bundle, g.op)
                    and _contracted_acyclic(
                        ops, accepted + [names_now + (g.op.name,)])
                    and not _starves_unseeded(graph, ops, clo, used,
                                              bundle, g.op)]
            if not pool:
                break
            scored = [(t_now + native_time(x)
                       - _bundle_cost(bundle + [x], memo, cache, mesh_tag),
                       x)
                      for x in pool]
            marginal, x = max(scored, key=lambda s: s[0])
            if marginal <= (min_gain_pct / 100.0) * native_time(x):
                break
            bundle.append(x)
            t_now = t_now + native_time(x) - marginal

        if measure is None:
            res = _bundle_search(bundle, memo, cache, mesh_tag)
        else:
            # measured final tuning (its own cache mode: the measured
            # schedule may differ from the cost-model one)
            res = autotuner.search(tuple(bundle), measure=measure,
                                   cache=cache, mesh_tag=mesh_tag)
        gain = res.best.est.speedup_pct()
        names = tuple(b.name for b in bundle)
        measured_pct = (None if measure is None
                        else _measured_speedup(res, bundle, measure, cache))
        # measurement outranks the model for admission, unless the measure
        # only ranks schedules (the step-count proxy)
        use_measured = (measured_pct is not None
                        and not getattr(measure, "rank_only", False))
        accept_gain = measured_pct if use_measured else gain
        if accept_gain >= min_gain_pct:
            fused.append(FusionDecision(names, res, gain, measured_pct))
            used |= set(names)
            accepted.append(names)
        else:
            kind = "measured" if use_measured else "predicted"
            rejected.append(("+".join(names[:-1]), names[-1],
                             f"{kind} gain {accept_gain:.1f}% "
                             f"< {min_gain_pct}%"))

    singles = [g.op.name for g in graph if g.op.name not in used]
    return FusionPlan(fused=fused, singles=singles, rejected=rejected,
                      graph=tuple(graph))
