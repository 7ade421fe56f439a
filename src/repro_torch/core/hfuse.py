"""generate() — run N OpSpecs as ONE CUDA launch (the paper's horizontal
fusion, CTA-level partition).

  paper (CUDA thread space)             here (CTA space of one launch)
  -------------------------------------------------------------------------
  threads [0,d1) run K1, [d1,d0) K2     CTAs interleave the bundle per the
                                        Schedule (r_0 : r_1 : ... : r_N)
  branch on threadIdx.x                 branch on blockIdx.x's phase
  replace threadIdx/blockDim            member-local CTA index
  bar.sync id, d partial barriers       not needed: a CTA runs one member

Within a super-step of ``period`` CTAs, member i owns the phase window
``[off_i, off_i + r_i)``: CTA t runs member i's local CTA
``s * r_i + ph - off_i`` (s = t // period, ph = t % period) or exits when
that is past the member's ``ctas`` — the reference's ``_bundle_phase_fns``
step formula (``src/repro/core/hfuse.py:41-72``), applied to CTAs instead
of TPU grid steps.  ``phase_table`` is that map in Python, for the tests;
``csrc/bundle.cu`` is the kernel.

The bundle launcher replaces the TPU kernels ``src/repro/core/hfuse.py:87``
(generate), ``:152`` (generate_vfused, every member's CTAs in one
contiguous run) and ``:161`` (run_single, a one-member bundle with ratio 1).
``BUNDLE`` is its launch record; every launch also bumps the record of
each member kernel it carried.  Its plain version runs each member's plain
function: members of a bundle are independent, so order does not matter.

An op that declares ``aliases`` has those outputs written into the donated
inputs, by the kernel and by the plain route alike.

A callable built here runs the kernel for CUDA operands and the plain
versions for CPU operands; ``plain=True`` is the explicit opt-in that runs
the plain versions on the card too (to hold the kernels against them).
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch

from repro_torch.core.cost_model import Schedule
from repro_torch.core.op_spec import OpSpec
from repro_torch.kernels import cuda

BUNDLE = cuda.Kernel("bundle_launcher", "src/repro_torch/csrc/bundle.cu",
                     "src/repro/core/hfuse.py:87, src/repro/core/hfuse.py"
                     ":152, src/repro/core/hfuse.py:161")


def phase_table(ctas: Sequence[int],
                sched: Schedule) -> list[Optional[tuple[int, int]]]:
    """For every CTA of the launch: (member, member-local CTA), or None
    for a CTA that exits at once."""
    ctas = tuple(ctas)
    if len(ctas) != sched.n_ops:
        raise ValueError(f"schedule has {sched.n_ops} ratios for "
                         f"{len(ctas)} members")
    period, offs = sched.period, sched.offsets()
    table: list[Optional[tuple[int, int]]] = []
    for t in range(cuda.grid_size(ctas, sched.ratios)):
        s, ph = divmod(t, period)
        entry = None
        for i, (r, off, c) in enumerate(zip(sched.ratios, offs, ctas)):
            if off <= ph < off + r:
                local = s * r + ph - off
                entry = (i, local) if local < c else None
                break
        table.append(entry)
    return table


def _device_type(operands: Sequence[torch.Tensor]) -> str:
    kinds = {t.device.type for t in operands}
    if len(kinds) != 1:
        raise ValueError(f"bundle operands span devices {sorted(kinds)}")
    return kinds.pop()


def _run_plain(ops: Sequence[OpSpec], operands) -> tuple:
    outs, off = [], 0
    for op in ops:
        n = len(op.inputs)
        res = list(op.plain(*operands[off:off + n]))
        for o, i in op.aliases:
            res[o] = operands[off + i].copy_(res[o])
        outs.extend(res)
        off += n
    return tuple(outs)


def _launch(ops: Sequence[OpSpec], ratios: Sequence[int], operands) -> tuple:
    dev = operands[0].device
    ins, outs, off = [], [], 0
    for op in ops:
        n = len(op.inputs)
        ins.append(operands[off:off + n])
        alias = dict(op.aliases)
        outs.append([operands[off + alias[j]] if j in alias
                     else torch.empty(o.shape, dtype=o.dtype, device=dev)
                     for j, o in enumerate(op.outputs)])
        off += n
    with torch.cuda.device(dev):
        cuda.launch([op.member for op in ops], ins, outs, ratios)
    BUNDLE.launches += 1
    for kernel in {op.member.kernel for op in ops}:
        kernel.launches += 1
    return tuple(t for o in outs for t in o)


def _bundle(ops: tuple[OpSpec, ...], sched: Schedule,
            ratios: tuple[int, ...], plain: bool):
    """One launch of ``ops`` whose CTAs are partitioned by ``ratios``;
    ``schedule`` is the planning schedule it stands for."""
    n_in = sum(len(op.inputs) for op in ops)

    def fused(*operands):
        if len(operands) != n_in:
            raise ValueError(f"bundle takes {n_in} operands, "
                             f"got {len(operands)}")
        if plain or _device_type(operands) == "cpu":
            return _run_plain(ops, operands)
        return _launch(ops, ratios, operands)

    fused.schedule = sched
    fused.ops = ops
    fused.launch_ratios = ratios
    # the launch's CTA count; with every member's CTAs equal to its TPU grid
    # steps it is the reference's fused grid, period * max_i ceil(grid_i/r_i)
    # (a block-shrunk variant keeps its member's CTAs, so there they differ)
    fused.n_steps = cuda.grid_size([op.ctas for op in ops], ratios)
    return fused


def generate(ops: Sequence[OpSpec], sched: Schedule, *, plain: bool = False):
    """Returns fused(*op0_inputs, ..., *opN_inputs) ->
    (*op0_outputs, ..., *opN_outputs) — one launch for the bundle."""
    ops = tuple(ops)
    if sched.n_ops != len(ops):
        raise ValueError(
            f"schedule has {sched.n_ops} ratios for {len(ops)} ops")
    return _bundle(ops, sched, sched.ratios, plain)


def generate_vfused(*ops, plain: bool = False):
    """The concatenated (vertical-style) baseline, the port of
    ``src/repro/core/hfuse.py:152``: one launch running all of op 0's CTAs,
    then all of op 1's, and so on, no interleaving.  Accepts OpSpecs
    positionally or one sequence.  ``schedule`` is the reference's
    (``Schedule`` of the grids), so plans compare with it; the launch
    partitions by each member's CTA count instead, which on CTAs is that
    same degenerate schedule."""
    if len(ops) == 1 and not isinstance(ops[0], OpSpec):
        ops = tuple(ops[0])
    return _bundle(tuple(ops), Schedule(tuple(op.grid for op in ops)),
                   tuple(op.ctas for op in ops), plain)


def run_single(op: OpSpec, *, plain: bool = False):
    """One launch of one OpSpec: a one-member bundle with ratio 1."""
    return generate((op,), Schedule((1,)), plain=plain)


def run_native(ops: Sequence[OpSpec], *, plain: bool = False):
    """The native baseline: one launch per op (N launches)."""
    ops = tuple(ops)
    calls = [run_single(op, plain=plain) for op in ops]

    def native(*operands):
        outs, off = [], 0
        for op, call in zip(ops, calls):
            outs.extend(call(*operands[off:off + len(op.inputs)]))
            off += len(op.inputs)
        return tuple(outs)

    return native
