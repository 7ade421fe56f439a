"""Vertical (epilogue) stitching — a producer->consumer chain as ONE OpSpec.

A producer whose output feeds exactly one consumer row-wise runs as one
kernel with the intermediate kept on chip: the chain is just an OpSpec,
so it becomes one *member* of a horizontal bundle (one ratio coordinate
for the autotuner, one node for the planner).

On the card a chain's member is ``kernels/row.RowChain``: one descriptor
(producer, consumer, stitched slot) that the row kernel
(``csrc/row_member.cuh``) runs as one member of the bundle launch.  Every
pair that the reference's ``can_stitch`` accepts between the row family
(rmsnorm, the row GEMM, the activation, the residual add) and the AdamW
update is executable: a row-wise pair with its intermediate in shared
memory, a row-wise producer as the GEMM's prologue, the GEMM's product
handed to an activation, a residual add or the AdamW update (the dW->adamw
chain of the train update graph) in its epilogue, or to an RMSNorm through
a per-launch workspace.  A chain is bitwise equal to its two ops run
separately (the row kernel's rounding contract).  ``can_stitch`` gives the
reason for the few pairs it cannot run, which the reference accepts only
for an operand every CTA reads whole (a GEMM's weight, a norm's scale) or
for ops outside these families; the planner leaves those unstitched, and
``stitch`` raises on them.

``can_stitch``'s planning checks (equal grids, per-step block
correspondence, collision-free merged names) are the reference's
(``src/repro/core/stitch.py:127``), so the planner contracts the same
pairs.
"""
from __future__ import annotations

import math
from typing import Optional

from repro_torch.core.op_spec import Operand, OpSpec, itemsize, shrink_blocks
from repro_torch.kernels import row

CHAIN_SEP = "→"


def chain_label(*names: str) -> str:
    return CHAIN_SEP.join(names)


_PROBE_FAILED = object()


def _probe(operand: Operand, grid: int):
    steps = sorted({0, 1, 2, grid // 2, max(grid - 1, 0)})
    try:
        return {s: tuple(int(c) for c in operand.index_map(s))
                for s in steps}
    except (TypeError, ValueError, ZeroDivisionError, IndexError):
        return _PROBE_FAILED


def _row_stream(operand: Operand, grid: int) -> bool:
    """Pure row stream: the block covers every trailing dim and step s
    holds rows [s*b0, (s+1)*b0)."""
    if operand.block_shape[1:] != operand.shape[1:]:
        return False
    probes = _probe(operand, grid)
    if probes is _PROBE_FAILED:
        return False
    return all(p == (s,) + (0,) * (len(operand.block_shape) - 1)
               for s, p in probes.items())


def _blocks_identical(a: Operand, b: Operand, grid: int) -> bool:
    if a.shape != b.shape or a.block_shape != b.block_shape:
        return False
    pa, pb = _probe(a, grid), _probe(b, grid)
    return pa is not _PROBE_FAILED and pa == pb


def can_stitch(producer: OpSpec, consumer: OpSpec,
               operand: str) -> Optional[str]:
    """None iff ``producer``'s output can feed ``consumer.<operand>``
    on chip; otherwise the reason it can't."""
    if not (producer.has_signature and consumer.has_signature):
        return "both ops need operand signatures"
    if producer.chain or consumer.chain:
        return "chains do not cascade (one stitch level)"
    if len(producer.outputs) != 1:
        return f"producer has {len(producer.outputs)} outputs, need 1"
    if producer.out_names[0] in producer.in_names:
        return "producer output is in-place (cannot be eliminated)"
    if operand not in consumer.in_names:
        return f"consumer has no input named {operand!r}"
    if operand in consumer.out_names:
        return f"stitched operand {operand!r} is consumer in-place state"
    if producer.grid != consumer.grid:
        return f"grid mismatch: {producer.grid} vs {consumer.grid}"

    sidx = consumer.in_names.index(operand)
    pout, cin = producer.outputs[0], consumer.inputs[sidx]
    if pout.dtype != cin.dtype:
        return f"dtype mismatch: {pout.dtype} vs {cin.dtype}"
    if math.prod(pout.shape) != math.prod(cin.shape):
        return f"element count mismatch: {pout.shape} vs {cin.shape}"
    if not (_blocks_identical(pout, cin, producer.grid)
            or (_row_stream(pout, producer.grid)
                and _row_stream(cin, consumer.grid)
                and math.prod(pout.block_shape)
                == math.prod(cin.block_shape))):
        return ("per-step block mismatch: "
                f"{pout.block_shape}@{pout.shape} vs "
                f"{cin.block_shape}@{cin.shape}")

    merged_in = producer.in_names + tuple(n for n in consumer.in_names
                                          if n != operand)
    if len(set(merged_in)) != len(merged_in):
        return f"operand name collision in merged signature: {merged_in}"
    return row.chain_reason(producer.member, consumer.member, sidx)


def _array_bytes(o: Operand) -> float:
    return float(math.prod(o.shape)) * itemsize(o.dtype)


def stitch(producer: OpSpec, consumer: OpSpec, operand: str) -> OpSpec:
    """Contract producer->consumer into one OpSpec (``can_stitch`` must
    pass).  The chain's inputs are the producer's plus the consumer's minus
    the stitched one; its outputs are the consumer's; ``hbm_bytes`` drops
    the intermediate's write and read."""
    reason = can_stitch(producer, consumer, operand)
    if reason is not None:
        raise ValueError(
            f"cannot stitch {producer.name}{CHAIN_SEP}{consumer.name}: "
            f"{reason}")

    sidx = consumer.in_names.index(operand)
    pout = producer.outputs[0]
    cin = consumer.inputs[sidx]
    n_pi = len(producer.inputs)
    p_plain, c_plain = producer.plain, consumer.plain

    def plain(*ins):
        (mid,) = p_plain(*ins[:n_pi])
        rest = ins[n_pi:]
        mid = mid.reshape(cin.shape)
        return c_plain(*rest[:sidx], mid, *rest[sidx:])

    def shrink(factor: int) -> Optional[OpSpec]:
        ps = shrink_blocks(producer, factor)
        cs = shrink_blocks(consumer, factor)
        if ps is None or cs is None or can_stitch(ps, cs, operand):
            return None
        return stitch(ps, cs, operand)

    member = row.chain(producer.member, consumer.member, sidx)
    # the consumer's in-place outputs, at their inputs' places in the chain
    aliases = tuple((o, n_pi + i - (i > sidx)) for o, i in consumer.aliases)
    saved = _array_bytes(pout) + _array_bytes(cin)
    tag = "|".join(t for t in (producer.tag, consumer.tag) if t)
    return OpSpec(
        name=f"{producer.name}{CHAIN_SEP}{consumer.name}",
        grid=producer.grid,
        member=member,
        plain=plain,
        inputs=producer.inputs + consumer.inputs[:sidx]
        + consumer.inputs[sidx + 1:],
        outputs=consumer.outputs,
        flops=producer.flops + consumer.flops,
        hbm_bytes=max(producer.hbm_bytes + consumer.hbm_bytes - saved, 1.0),
        tag=f"chain:{tag}" if tag else "chain",
        shrink=shrink,
        in_names=producer.in_names + consumer.in_names[:sidx]
        + consumer.in_names[sidx + 1:],
        out_names=consumer.out_names,
        chain=(producer.name, consumer.name),
        extra_vmem_bytes=pout.block_bytes(),
        aliases=aliases,
    )
