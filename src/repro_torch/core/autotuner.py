"""The paper's Main() search (Fig. 6), adapted and generalized to bundles:
a two-stage schedule search over ratio vectors x bundle variants x working-
set caps.

  1. the roofline cost model (``core/cost_model.py``) scores the whole
     lattice (ratio_candidates x variants x caps) and prunes it to a
     ``top_k`` frontier;
  2. coordinate descent refines the winner: per coordinate, halve/double
     the ratio while it improves, at most ``cd_budget`` evaluations.

With ``measure=`` (``core/timing.make_measure``: CUDA-event device time on
the card, or the deterministic step-count proxy) stage 2 runs on measured
times — the paper's measurement-driven profiling — and calls the measure
on at most ``top_k + cd_budget`` candidates.  ``cache=``
(``core/schedule_cache.ScheduleCache``) skips the search for a bundle
tuned before.  The search is the reference's
(``src/repro/core/autotuner.py:212``) over the same planning profile, so
it picks the same schedules from the same scores.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional, Sequence

from repro_torch.core import hfuse, schedule_cache as sc
from repro_torch.core import op_spec as op_spec_mod
from repro_torch.core.cost_model import (MAX_RATIO, FusedEstimate, Schedule,
                                         hfused_cost, ratio_candidates)
from repro_torch.core.op_spec import OpSpec
from repro_torch.core.profile import VMEM_BUDGET

# Full (non-cache-hit) searches since import: a repeated plan over an
# unchanged graph with a cache must perform none (the test hook).
SEARCH_COUNT = 0


@dataclass
class Candidate:
    sched: Schedule
    variant: int                  # index into the bundle-variant list
    vmem_cap: Optional[int]
    est: FusedEstimate
    measured_s: Optional[float] = None

    @property
    def score(self) -> float:
        return (self.measured_s if self.measured_s is not None
                else self.est.t_hfused)

    def delta_pct(self) -> Optional[float]:
        """Cost-model-vs-measured disagreement (positive: model
        optimistic)."""
        if self.measured_s is None:
            return None
        return 100.0 * (self.measured_s - self.est.t_hfused) \
            / max(self.est.t_hfused, 1e-30)


@dataclass
class SearchResult:
    best: Candidate
    log: list[Candidate]
    ops: tuple[OpSpec, ...]
    lattice_size: int = 0         # exhaustive stage-1 candidate count
    n_measured: int = 0           # measure() calls (<= top_k + cd_budget)
    cache_hit: bool = False
    cache_key: Optional[str] = None   # set whenever a cache was consulted

    def build(self, *, plain: bool = False):
        """The tuned bundle as one launch (``hfuse.generate``)."""
        return hfuse.generate(self.ops, self.best.sched, plain=plain)

    def table(self) -> list[dict]:
        return [{
            "sched": c.sched.label(), "variant": c.variant,
            "vmem_cap": c.vmem_cap, "t_hfused_us": c.est.t_hfused * 1e6,
            "speedup_pct": c.est.speedup_pct(), "vmem_ok": c.est.vmem_ok,
            "measured_s": c.measured_s,
            "cm_vs_measured_delta_pct": c.delta_pct(),
        } for c in self.log]


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
              cap: Optional[int], vmem_budget: int,
              measure: Optional[Callable]) -> Candidate:
    est = hfused_cost(ops, sched, vmem_budget=cap or vmem_budget)
    cand = Candidate(sched, vi, cap, est)
    if measure is not None:
        cand.measured_s = measure(hfuse.generate(ops, sched), *ops)
    return cand


def _coordinate_descent(variants, best: Candidate, vmem_budget: int,
                        measure: Optional[Callable], budget: int,
                        log: list[Candidate],
                        known: dict) -> tuple[Candidate, int]:
    """Refine the incumbent's ratio vector: per coordinate, keep halving
    (then doubling) while the score improves; at most ``budget``
    evaluations (under ``measure`` each is one profiling run), revisits of
    known candidates are free."""
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
                                         best.vmem_cap, vmem_budget, measure)
                        evals += 1
                        log.append(cand)
                        known[key] = cand
                    if cand.score < best.score:
                        best, improved = cand, True
                    else:
                        break
    return best, evals


def _cached(cache: sc.ScheduleCache, key: str, variants,
            vmem_budget: int) -> Optional[SearchResult]:
    """The recorded best schedule for ``key``, or None.  An entry whose
    tuned variant does not resolve to the same OpSpecs in this call's
    variant list is a miss: a schedule is never remapped onto other ops."""
    entry = cache.get(key)
    if (entry is None or entry["variant"] >= len(variants)
            or entry.get("variant_fp")
            != _variant_fingerprint(variants[entry["variant"]])):
        return None
    ops = variants[entry["variant"]]
    cap = entry["vmem_cap"]
    sched = Schedule(entry["ratios"])
    est = hfused_cost(ops, sched, vmem_budget=cap or vmem_budget)
    best = Candidate(sched, entry["variant"], cap, est,
                     measured_s=entry.get("measured_s"))
    return SearchResult(best=best, log=[best], ops=ops,
                        lattice_size=entry.get("lattice_size", 0),
                        n_measured=0, cache_hit=True, cache_key=key)


def search(variants: Sequence, *, vmem_budget: int = VMEM_BUDGET,
           measure: Optional[Callable] = None, top_k: int = 3,
           cd_budget: Optional[int] = None, auto_shrink: bool = True,
           cache: Optional[sc.ScheduleCache] = None,
           mesh_tag: str = "") -> SearchResult:
    """Two-stage schedule search over schedules x bundle variants x
    working-set caps.  ``variants``: one bundle or a list of alternative
    bundles; a single over-budget bundle grows shrunk-block variants
    (``auto_shrink``).

    ``measure``: profiling callable (``core/timing.make_measure``), called
    on at most ``top_k + cd_budget`` candidates; ``cd_budget`` defaults to
    4 measured / 24 cost-model evaluations.  ``cache``: a hit returns the
    recorded schedule without searching (``SEARCH_COUNT`` does not
    move).  ``mesh_tag`` (``"<axis>:<extent>"``) marks a search for one
    shard of a tensor-parallel mesh: part of the cache signature, so a
    sharded plan never resolves a single-device schedule, nor the other
    way round."""
    global SEARCH_COUNT
    variants = _expand_variants(_as_variants(variants), vmem_budget,
                                auto_shrink)
    mode = (getattr(measure, "backend", "measured")
            if measure is not None else "costmodel")
    key = None
    if cache is not None:
        key = sc.bundle_signature(variants[0], vmem_budget=vmem_budget,
                                  mode=mode, mesh_tag=mesh_tag)
        hit = _cached(cache, key, variants, vmem_budget)
        if hit is not None:
            return hit
    SEARCH_COUNT += 1

    # ---- stage 1: exhaustive lattice under the cost model ---------------
    log: list[Candidate] = []
    for vi, ops in enumerate(variants):
        caps: list[Optional[int]] = [None]
        if _need(ops) > vmem_budget:
            caps.append(vmem_budget)
        for sched in ratio_candidates(ops):
            for cap in caps:
                log.append(_evaluate(ops, sched, vi, cap, vmem_budget, None))
    lattice_size = len(log)

    # ---- stage 2: prune + (measured) refine ------------------------------
    def _key(c):
        return (c.variant, c.vmem_cap, c.sched.ratios)

    n_measured = 0
    if measure is None:
        best = min(log, key=lambda c: c.score)
        best, _ = _coordinate_descent(
            variants, best, vmem_budget, None,
            24 if cd_budget is None else cd_budget, log,
            {_key(c): c for c in log})
    else:
        frontier = sorted(log, key=lambda c: c.est.t_hfused)[:max(1, top_k)]
        for c in frontier:
            c.measured_s = measure(
                hfuse.generate(variants[c.variant], c.sched),
                *variants[c.variant])
        n_measured = len(frontier)
        best = min(frontier, key=lambda c: c.score)
        # known = the measured frontier only: descent never compares an
        # unmeasured cost-model score with a measured one
        best, extra = _coordinate_descent(
            variants, best, vmem_budget, measure,
            4 if cd_budget is None else cd_budget, log,
            {_key(c): c for c in frontier})
        n_measured += extra

    result = SearchResult(best=best, log=log, ops=variants[best.variant],
                          lattice_size=lattice_size, n_measured=n_measured,
                          cache_key=key)
    if cache is not None:
        cache.put(key, {
            "members": [op.name for op in variants[0]],
            "ratios": list(best.sched.ratios),
            "variant": best.variant,
            "variant_fp": _variant_fingerprint(variants[best.variant]),
            "vmem_cap": best.vmem_cap,
            "predicted_s": best.est.t_hfused,
            "measured_s": best.measured_s,
            "delta_pct": best.delta_pct(),
            "lattice_size": lattice_size,
            "mode": mode,
        })
    return result
