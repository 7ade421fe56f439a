"""OpSpec — the fusible-kernel IR of the horizontal-fusion engine.

An OpSpec is the paper's "input kernel": a computation with a resource
profile (FLOPs / device-memory bytes / on-chip working set) that the cost
model, autotuner and planner reason about, plus what it takes to run it.

Planning metadata is kept exactly as the JAX reference has it — the 1-D
``grid``, per-operand block shapes and index maps, ``flops``,
``hbm_bytes``, names — because the planner reads them, and the port must
make the reference's decisions on the same graph.  What the reference's
Pallas ``body`` did becomes two things here:

  * ``member`` — a member descriptor (kind plus static dims, see
    ``kernels/cuda.py``) that the CUDA bundle launcher dispatches on.  It
    carries ``ctas``, the GPU launch geometry: how many thread blocks the
    member needs.  That is separate from the TPU ``grid``: the planner's
    ratios are tuned over ``grid``, the launcher partitions CTAs.
  * ``plain`` — a plain PyTorch function over the whole op,
    ``plain(*inputs) -> outputs``.  It is the CPU path and the reference
    the kernel is held against on the card.

A member computes the same function whatever block shape the planner gave
its OpSpec: block shrinking changes ``grid`` and blocks, never the result.
"""
from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass
from typing import Any, Callable, Optional

import torch

from repro_torch.core.profile import HBM_BW, PEAK_FLOPS, RIDGE


def itemsize(dtype: torch.dtype) -> int:
    return torch.empty((), dtype=dtype).element_size()


@dataclass(frozen=True)
class Operand:
    """One input or output of a fusible op."""
    shape: tuple[int, ...]
    dtype: torch.dtype
    block_shape: tuple[int, ...]
    index_map: Callable[[int], tuple]      # op-local step -> block indices

    def block_bytes(self) -> int:
        return int(math.prod(self.block_shape)) * itemsize(self.dtype)


@dataclass
class OpSpec:
    name: str
    grid: int                              # number of op-local (TPU) steps
    member: Any                            # CUDA member descriptor
    plain: Callable                        # plain(*inputs) -> tuple(outputs)
    inputs: tuple[Operand, ...]
    outputs: tuple[Operand, ...]
    flops: float                           # whole-op FLOPs
    hbm_bytes: float                       # whole-op device-memory traffic
    tag: str = ""
    shrink: Optional[Callable] = None      # factor -> OpSpec with smaller
    #                                        blocks (overrides shrink_blocks)
    # Epilogue contract (core/stitch.py): ``epilogue=(consumer, operand)`` on
    # a producer asserts its single output feeds exactly that consumer's
    # named operand and is dead afterwards.  ``chain`` marks an OpSpec that
    # IS such a chain; ``extra_vmem_bytes`` charges the resident
    # intermediate to the working set.
    epilogue: Optional[tuple[str, str]] = None
    chain: tuple[str, ...] = ()
    extra_vmem_bytes: int = 0
    # Stable operand signature (core/binding.py contract).
    in_names: tuple[str, ...] = ()
    out_names: tuple[str, ...] = ()
    # In-place outputs: ``(output index, input index)`` pairs.  The caller
    # donates that input: the launch (and the plain route) writes the output
    # into it and returns it, so an update needs no second copy of its state.
    aliases: tuple[tuple[int, int], ...] = ()

    def __post_init__(self):
        if self.in_names and len(self.in_names) != len(self.inputs):
            raise ValueError(f"{self.name}: {len(self.in_names)} in_names "
                             f"for {len(self.inputs)} inputs")
        if self.out_names and len(self.out_names) != len(self.outputs):
            raise ValueError(f"{self.name}: {len(self.out_names)} out_names "
                             f"for {len(self.outputs)} outputs")
        for o, i in self.aliases:
            a, b = self.outputs[o], self.inputs[i]
            if (a.shape, a.dtype) != (b.shape, b.dtype):
                raise ValueError(f"{self.name}: output {o} cannot be written "
                                 f"into input {i}: {a.shape} {a.dtype} vs "
                                 f"{b.shape} {b.dtype}")

    @property
    def has_signature(self) -> bool:
        return bool(self.in_names) and bool(self.out_names)

    @property
    def ctas(self) -> int:
        """Thread blocks the CUDA member launches (GPU launch geometry)."""
        return self.member.ctas

    # ------------------------------------------------------------------
    @property
    def vmem_bytes(self) -> int:
        """Per-step working set (single-buffered) plus a stitched chain's
        resident intermediate."""
        return (sum(o.block_bytes() for o in (*self.inputs, *self.outputs))
                + self.extra_vmem_bytes)

    @property
    def arithmetic_intensity(self) -> float:
        return self.flops / max(self.hbm_bytes, 1.0)

    @property
    def bound(self) -> str:
        """Roofline classification under the planning profile."""
        return "compute" if self.arithmetic_intensity >= RIDGE else "memory"

    @property
    def t_compute(self) -> float:
        return self.flops / PEAK_FLOPS

    @property
    def t_memory(self) -> float:
        return self.hbm_bytes / HBM_BW

    @property
    def t_native(self) -> float:
        return max(self.t_compute, self.t_memory)

    def step_costs(self) -> tuple[float, float]:
        """(compute, memory) seconds per grid step (uniform steps)."""
        return self.t_compute / self.grid, self.t_memory / self.grid

    def describe(self) -> dict:
        return {
            "name": self.name, "grid": self.grid, "flops": self.flops,
            "hbm_bytes": self.hbm_bytes, "vmem_bytes": self.vmem_bytes,
            "arithmetic_intensity": round(self.arithmetic_intensity, 2),
            "bound": self.bound,
            "t_compute_us": self.t_compute * 1e6,
            "t_memory_us": self.t_memory * 1e6,
            "t_native_us": self.t_native * 1e6,
        }


def make_operand(t, block_shape, index_map) -> Operand:
    """An Operand of the shape and dtype of ``t`` (a tensor, or anything
    with ``shape`` and a torch ``dtype``)."""
    return Operand(tuple(t.shape), t.dtype, tuple(block_shape), index_map)


# ---------------------------------------------------------------------------
# Automatic block shrinking (the paper's register-cap analogue)
# ---------------------------------------------------------------------------
MIN_BLOCK_ROWS = 8                # the reference's sublane floor


def _index_pattern(operand: Operand, grid: int = 8) -> Optional[str]:
    """Classify an index map by probing it at steps sampled across the
    whole ``grid`` (late steps included, so batch-major ``s // nk`` maps
    never masquerade as constant): 'const', 'stream' (unit stride in the
    leading axis) or None (not safely rewritable)."""
    steps = sorted({0, 1, 2, grid // 2, max(grid - 1, 0)})
    try:
        probes = {s: tuple(int(c) for c in operand.index_map(s))
                  for s in steps}
    except (TypeError, ValueError, ZeroDivisionError, IndexError):
        return None
    first = probes[0]
    if all(p == first for p in probes.values()):
        return "const"
    if (all(p[0] == s for s, p in probes.items())
            and all(p[1:] == first[1:] for p in probes.values())):
        return "stream"
    return None


def shrink_blocks(op: OpSpec, factor: int = 2) -> Optional[OpSpec]:
    """Divide every streamed operand's leading block dim by ``factor`` and
    scale the grid to match: the planned working set shrinks, the work and
    the member's result do not.  None when the rewrite cannot be proven
    safe (same rules as the reference)."""
    if factor <= 1:
        return op
    if op.shrink is not None:
        return op.shrink(factor)

    operands = (*op.inputs, *op.outputs)
    patterns = [_index_pattern(o, op.grid) for o in operands]
    if any(p is None for p in patterns):
        return None
    stream_leads = {o.block_shape[0]
                    for o, p in zip(operands, patterns) if p == "stream"}
    if not stream_leads:
        return None
    for o, p in zip(operands, patterns):
        if p == "stream":
            lead = o.block_shape[0]
            if lead % factor or lead // factor < MIN_BLOCK_ROWS:
                return None
        elif any(d in stream_leads for d in o.block_shape):
            return None                       # body-coupled const operand

    def shrunk(o: Operand, p: str) -> Operand:
        if p == "const":
            return o
        return dataclasses.replace(
            o, block_shape=(o.block_shape[0] // factor, *o.block_shape[1:]))

    n_in = len(op.inputs)
    new = [shrunk(o, p) for o, p in zip(operands, patterns)]
    return dataclasses.replace(
        op, grid=op.grid * factor,
        inputs=tuple(new[:n_in]), outputs=tuple(new[n_in:]),
        tag=f"{op.tag}|blocks/{factor}" if op.tag else f"blocks/{factor}")
