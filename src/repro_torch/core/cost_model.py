"""Three-term roofline cost model for fusion decisions.

The planner's and autotuner's napkin math, as in the JAX reference:

    t_native(K1;..;KN) = sum_i max(tc_i, tm_i)           (N kernels, serial)
    t_hfused(K1u..uKN) ~ max(sum_i tc_i, sum_i tm_i)      (engines overlap)

plus a per-launch term and a pipeline ramp, and an on-chip working-set
cliff.  The constants are the planning profile (``core/profile.py``): the
reference's v5e numbers, so the port's plans can be held against the
reference's.  Its microseconds are model numbers, never card times.

The per-op-class correction table is the reference's: installed by
``set_corrections`` or read once from the JSON file named by
``$REPRO_COST_CORRECTIONS`` (an unreadable file is no table); with no table
every factor is exactly 1.0.
"""
from __future__ import annotations

import json
import math
import os
import re
from dataclasses import dataclass
from typing import Optional, Sequence

from repro_torch.core.op_spec import OpSpec
from repro_torch.core.profile import LAUNCH_S, VMEM_BUDGET

# Interleave-ratio domain shared by the candidate lattice and the
# autotuner's coordinate descent.
MAX_RATIO = 4096

CORRECTION_CLAMP = (0.5, 2.0)
_PARAM_SEG = re.compile(r"^[A-Za-z]{0,3}\d")
_CHAIN_SEP = "→"

_corrections: Optional[dict] = None
_corrections_env_loaded = False


def op_class(name: str) -> str:
    """Stable class key for an op name: shape/index parameters stripped."""
    if _CHAIN_SEP in name:
        return _CHAIN_SEP.join(op_class(p) for p in name.split(_CHAIN_SEP))
    kept = []
    for seg in name.split("_"):
        if _PARAM_SEG.match(seg):
            continue
        kept.append(seg.rstrip("0123456789"))
    return "_".join(s for s in kept if s) or name


def set_corrections(table: Optional[dict]) -> None:
    """Install (or clear, with None) the per-op-class correction table:
    ``{class: factor}`` or the fit-cost file schema ``{"classes": {class:
    {"correction": factor, ...}}}``.  An explicit call wins over the
    environment's file."""
    global _corrections, _corrections_env_loaded
    if table is not None and "classes" in table:
        table = {k: float(v["correction"] if isinstance(v, dict) else v)
                 for k, v in table["classes"].items()}
    _corrections = table
    _corrections_env_loaded = True


def _correction_table() -> Optional[dict]:
    """The installed table, reading ``$REPRO_COST_CORRECTIONS`` the first
    time no table was installed."""
    global _corrections_env_loaded
    if not _corrections_env_loaded:
        _corrections_env_loaded = True
        path = os.environ.get("REPRO_COST_CORRECTIONS")
        if path:
            try:
                with open(path) as fh:
                    set_corrections(json.load(fh))
            except (OSError, json.JSONDecodeError, KeyError, TypeError,
                    ValueError):
                pass                        # unreadable table == no table
    return _corrections


def correction_for(name: str) -> float:
    """Fitted factor of this op's class (1.0 without a table or class)."""
    table = _correction_table()
    if not table:
        return 1.0
    lo, hi = CORRECTION_CLAMP
    return min(hi, max(lo, float(table.get(op_class(name), 1.0))))


def native_time(op: OpSpec) -> float:
    """Standalone kernel wall-time model: roofline + ramp + launch."""
    ramp = (op.t_compute + op.t_memory) / max(op.grid, 1)
    return (max(op.t_compute, op.t_memory) + ramp) * correction_for(op.name) \
        + LAUNCH_S


class Schedule:
    """Interleave ratio vector: r_i steps of op i per super-step, in order.

    On the card the same vector partitions the bundle's CTAs: within a
    super-step of ``period`` CTAs, member i owns the phase window
    ``[off_i, off_i + r_i)`` (core/hfuse.py ``phase_table``)."""
    __slots__ = ("ratios",)

    def __init__(self, *args):
        if len(args) == 1 and not isinstance(args[0], int):
            ratios = tuple(int(r) for r in args[0])
        else:
            ratios = tuple(int(a) for a in args)
        if not ratios or any(r < 1 for r in ratios):
            raise ValueError(f"ratios must be positive ints, got {ratios}")
        object.__setattr__(self, "ratios", ratios)

    @property
    def n_ops(self) -> int:
        return len(self.ratios)

    @property
    def ra(self) -> int:
        return self.ratios[0]

    @property
    def rb(self) -> int:
        return self.ratios[1]

    @property
    def period(self) -> int:
        return sum(self.ratios)

    def offsets(self) -> tuple[int, ...]:
        offs, acc = [], 0
        for r in self.ratios:
            offs.append(acc)
            acc += r
        return tuple(offs)

    def label(self) -> str:
        return ":".join(str(r) for r in self.ratios)

    def __eq__(self, other):
        return isinstance(other, Schedule) and self.ratios == other.ratios

    def __hash__(self):
        return hash(self.ratios)

    def __repr__(self):
        return f"Schedule({self.ratios})"


@dataclass
class FusedEstimate:
    t_native: float
    t_vfused: float
    t_hfused: float
    gain_vs_native: float
    gain_vs_vfused: float
    vmem_bytes: int
    vmem_ok: bool
    overlap_eff: float

    def speedup_pct(self) -> float:
        return 100.0 * self.gain_vs_native / max(self.t_native, 1e-30)


def hfused_cost(ops: Sequence[OpSpec], sched: Schedule, *,
                vmem_budget: int = VMEM_BUDGET) -> FusedEstimate:
    """Cost of the interleaved fused bundle ``ops`` under ``sched``."""
    ops = tuple(ops)
    if sched.n_ops != len(ops):
        raise ValueError(
            f"schedule has {sched.n_ops} ratios for {len(ops)} ops")
    corr = [correction_for(op.name) for op in ops]
    tcs = [op.t_compute * c for op, c in zip(ops, corr)]
    tms = [op.t_memory * c for op, c in zip(ops, corr)]
    ramps = [(tc + tm) / max(op.grid, 1)
             for op, tc, tm in zip(ops, tcs, tms)]
    t_native = sum(native_time(op) for op in ops)       # N launches
    t_vfused = sum(max(tc, tm) for tc, tm in zip(tcs, tms)) \
        + max(ramps) + LAUNCH_S

    # full co-execution lasts until the shortest op (in super-steps) is
    # exhausted; each op's leftover runs as its un-overlapped tail
    ss = [math.ceil(op.grid / r) for op, r in zip(ops, sched.ratios)]
    co = min(ss)
    fs = [co / s for s in ss]
    t_overlap = max(sum(f * tc for f, tc in zip(fs, tcs)),
                    sum(f * tm for f, tm in zip(fs, tms)))
    t_tail = sum(max((1 - f) * tc, (1 - f) * tm)
                 for f, tc, tm in zip(fs, tcs, tms))

    vmem = 2 * sum(op.vmem_bytes for op in ops)
    vmem_ok = vmem <= vmem_budget
    ramp_fused = max(ramps)
    if vmem_ok:
        t_h = t_overlap + t_tail + ramp_fused + LAUNCH_S
        eff = 1.0
    else:
        over = min(2.0, vmem / vmem_budget)
        serial = sum(f * tc for f, tc in zip(fs, tcs)) \
            + sum(f * tm for f, tm in zip(fs, tms))
        t_h = t_tail + t_overlap + (serial - t_overlap) * (over - 1.0) \
            + ramp_fused + LAUNCH_S
        eff = max(0.0, 2.0 - over)
    return FusedEstimate(
        t_native=t_native, t_vfused=t_vfused, t_hfused=t_h,
        gain_vs_native=t_native - t_h, gain_vs_vfused=t_vfused - t_h,
        vmem_bytes=vmem, vmem_ok=vmem_ok, overlap_eff=eff)


def fusion_profitable(a: OpSpec, b: OpSpec) -> bool:
    """The paper's scenario test: different bound kinds => profitable."""
    return a.bound != b.bound


def bundle_profitable(ops: Sequence[OpSpec]) -> bool:
    """N-way scenario test: the bundle must mix bound kinds (an all-compute
    or all-memory bundle only saves launches)."""
    return len({op.bound for op in ops}) > 1


def ratio_candidates(ops: Sequence[OpSpec], *,
                     max_ratio: int = MAX_RATIO) -> list[Schedule]:
    """Candidate interleave ratio vectors (the paper's d1 sweep): all ones,
    one-op boosts, and the grid-proportional vector with its half/double
    neighbours."""
    ops = tuple(ops)
    n = len(ops)
    cands = {(1,) * n}
    for i in range(n):
        for r in (2, 4):
            v = [1] * n
            v[i] = r
            cands.add(tuple(v))
    gmin = max(1, min(op.grid for op in ops))
    for s in (0.5, 1.0, 2.0):
        cands.add(tuple(
            max(1, min(max_ratio, round(op.grid * s / gmin))) for op in ops))
    return [Schedule(v) for v in sorted(cands)]
