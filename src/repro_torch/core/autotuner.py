"""The paper's Main() search (Fig. 6), adapted and generalized to bundles:
a two-stage schedule search over ratio vectors x bundle variants x working-
set caps, scored by the cost model (``core/cost_model.py``).

  1. the roofline cost model scores the whole lattice
     (ratio_candidates x variants x caps) and keeps the best;
  2. coordinate descent refines it: per coordinate, halve/double the ratio
     while it improves, at most ``cd_budget`` evaluations.

The search is the reference's (``src/repro/core/autotuner.py:212``) over the
same planning profile, so it picks the same schedules.  The measured path
(``measure=``, CUDA-event timing) and the persistent schedule cache
(``cache=``) are later work: passing either raises.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence

from repro_torch.core import hfuse
from repro_torch.core import op_spec as op_spec_mod
from repro_torch.core.cost_model import (MAX_RATIO, FusedEstimate, Schedule,
                                         hfused_cost, ratio_candidates)
from repro_torch.core.op_spec import OpSpec
from repro_torch.core.profile import VMEM_BUDGET


@dataclass
class Candidate:
    sched: Schedule
    variant: int                  # index into the bundle-variant list
    vmem_cap: Optional[int]
    est: FusedEstimate

    @property
    def score(self) -> float:
        return self.est.t_hfused


@dataclass
class SearchResult:
    best: Candidate
    log: list[Candidate]
    ops: tuple[OpSpec, ...]

    def build(self, *, plain: bool = False):
        """The tuned bundle as one launch (``hfuse.generate``)."""
        return hfuse.generate(self.ops, self.best.sched, plain=plain)


def _as_variants(variants) -> list[tuple[OpSpec, ...]]:
    variants = list(variants)
    if variants and isinstance(variants[0], OpSpec):
        return [tuple(variants)]
    return [tuple(v) for v in variants]


def _need(ops: Sequence[OpSpec]) -> int:
    """Double-buffered co-residency requirement of a bundle."""
    return 2 * sum(op.vmem_bytes for op in ops)


def _variant_fingerprint(ops: Sequence[OpSpec]) -> list:
    return [[o.name, o.grid,
             ["x".join(map(str, x.block_shape))
              for x in (*o.inputs, *o.outputs)]]
            for o in ops]


def _shrink_variants(ops: tuple[OpSpec, ...],
                     vmem_budget: int) -> list[tuple[OpSpec, ...]]:
    """Auto-generated halved-block bundle variants: per-member halving
    (largest working set first), then whole-bundle halving/quartering
    until the bundle co-resides.  At most N + 2 variants."""
    variants: list[tuple[OpSpec, ...]] = []
    seen = set()

    def fingerprint(v):
        return repr(_variant_fingerprint(v))

    def add(v):
        fp = fingerprint(v)
        if fp not in seen and fp != fingerprint(ops):
            seen.add(fp)
            variants.append(v)

    for i in sorted(range(len(ops)), key=lambda i: -ops[i].vmem_bytes):
        s = op_spec_mod.shrink_blocks(ops[i], 2)
        if s is not None:
            v = list(ops)
            v[i] = s
            add(tuple(v))
    for factor in (2, 4):
        v = tuple(op_spec_mod.shrink_blocks(op, factor) or op for op in ops)
        add(v)
        if _need(v) <= vmem_budget:
            break
    return variants


def _expand_variants(variants: list[tuple[OpSpec, ...]], vmem_budget: int,
                     auto_shrink: bool) -> list[tuple[OpSpec, ...]]:
    if auto_shrink and len(variants) == 1 and _need(variants[0]) > vmem_budget:
        variants = variants + _shrink_variants(variants[0], vmem_budget)
    return variants


def _evaluate(ops: tuple[OpSpec, ...], sched: Schedule, vi: int,
              cap: Optional[int], vmem_budget: int) -> Candidate:
    est = hfused_cost(ops, sched, vmem_budget=cap or vmem_budget)
    return Candidate(sched, vi, cap, est)


def _coordinate_descent(variants, best: Candidate, vmem_budget: int,
                        budget: int, log: list[Candidate],
                        known: dict) -> Candidate:
    """Refine the incumbent's ratio vector: per coordinate, keep halving
    (then doubling) while the score improves; at most ``budget``
    evaluations, revisits of known candidates are free."""
    known = dict(known)
    known[(best.variant, best.vmem_cap, best.sched.ratios)] = best
    evals = 0
    improved = True
    while improved and evals < budget:
        improved = False
        for i in range(best.sched.n_ops):
            for move in ((lambda r: r // 2), (lambda r: r * 2)):
                while True:
                    ratios = list(best.sched.ratios)
                    ratios[i] = move(ratios[i])
                    if not (1 <= ratios[i] <= MAX_RATIO):
                        break
                    key = (best.variant, best.vmem_cap, tuple(ratios))
                    cand = known.get(key)
                    if cand is None:
                        if evals >= budget:
                            break
                        cand = _evaluate(variants[best.variant],
                                         Schedule(ratios), best.variant,
                                         best.vmem_cap, vmem_budget)
                        evals += 1
                        log.append(cand)
                        known[key] = cand
                    if cand.score < best.score:
                        best, improved = cand, True
                    else:
                        break
    return best


def search(variants: Sequence, *, vmem_budget: int = VMEM_BUDGET,
           cd_budget: Optional[int] = None, auto_shrink: bool = True,
           measure=None, cache=None) -> SearchResult:
    """Two-stage cost-model schedule search over schedules x bundle
    variants x working-set caps.  ``variants``: one bundle or a list of
    alternative bundles; a single over-budget bundle grows shrunk-block
    variants (``auto_shrink``)."""
    if measure is not None:
        raise NotImplementedError("measured schedule search (CUDA-event "
                                  "timing) is not ported yet (ROADMAP)")
    if cache is not None:
        raise NotImplementedError("the schedule cache is not ported yet "
                                  "(ROADMAP)")
    variants = _expand_variants(_as_variants(variants), vmem_budget,
                                auto_shrink)

    # ---- stage 1: exhaustive lattice under the cost model ---------------
    log: list[Candidate] = []
    for vi, ops in enumerate(variants):
        caps: list[Optional[int]] = [None]
        if _need(ops) > vmem_budget:
            caps.append(vmem_budget)
        for sched in ratio_candidates(ops):
            for cap in caps:
                log.append(_evaluate(ops, sched, vi, cap, vmem_budget))

    # ---- stage 2: coordinate descent from the lattice's best ------------
    best = min(log, key=lambda c: c.score)
    best = _coordinate_descent(
        variants, best, vmem_budget, 24 if cd_budget is None else cd_budget,
        log, {(c.variant, c.vmem_cap, c.sched.ratios): c for c in log})
    return SearchResult(best=best, log=log, ops=variants[best.variant])
