"""Binding registry — how a planned graph touches live tensors.

A ``BindingRegistry`` maps each graph op's named operands (the stable
``OpSpec.in_names`` / ``out_names`` signature) onto getters and setters over
a **state** — a flat ``dict[str, Tensor]`` threaded through the program.
Dataflow between ops is key sharing; model glue (RoPE, the per-slot cache
scatter, residuals, the output projections) lives in the slots.

Three slot forms, in increasing power:

  "key"                      — read/write ``state[key]`` verbatim.
  Slot(key, get=, put=)      — ``get(state[key])`` on read;
                               ``put(state[key], new) -> value`` on write.
  Slot(get=, put=) (no key)  — whole-state forms: ``get(state) -> tensor``
                               and ``put(state, new) -> state``.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Mapping, Optional, Sequence

import torch

from repro_torch.core.op_spec import OpSpec

State = dict


@dataclass(frozen=True)
class Slot:
    """One operand's route in and out of the state."""
    key: Optional[str] = None
    get: Optional[Callable] = None
    put: Optional[Callable] = None

    def read(self, state: State):
        if self.key is None:
            if self.get is None:
                raise ValueError("input slot needs a key or a get()")
            return self.get(state)
        val = state[self.key]
        return self.get(val) if self.get is not None else val

    def write(self, state: State, new) -> State:
        if self.key is None:
            if self.put is None:
                raise ValueError("output slot needs a key or a put()")
            return self.put(state, new)
        state = dict(state)
        state[self.key] = (self.put(state.get(self.key), new)
                           if self.put is not None else new)
        return state


def _as_slot(s) -> Slot:
    if isinstance(s, Slot):
        return s
    if isinstance(s, str):
        return Slot(key=s)
    raise TypeError(f"operand binding must be a key string or Slot, got {s!r}")


class BindingRegistry:
    """Per-op operand-name -> Slot table, validated against signatures."""

    def __init__(self):
        self._inputs: dict[str, dict[str, Slot]] = {}
        self._outputs: dict[str, dict[str, Slot]] = {}

    def bind(self, op_name: str, inputs: Optional[Mapping] = None,
             outputs: Optional[Mapping] = None, **shared) -> "BindingRegistry":
        ins = {k: _as_slot(v) for k, v in {**shared, **(inputs or {})}.items()}
        outs = {k: _as_slot(v) for k, v in {**shared, **(outputs or {})}.items()}
        self._inputs.setdefault(op_name, {}).update(ins)
        self._outputs.setdefault(op_name, {}).update(outs)
        return self

    def validate(self, op: OpSpec) -> None:
        if not op.has_signature:
            raise ValueError(
                f"op '{op.name}' has no operand signature "
                f"(OpSpec.in_names/out_names) — the executor cannot bind it")
        missing = [n for n in op.in_names
                   if n not in self._inputs.get(op.name, {})]
        missing += [f"{n} (out)" for n in op.out_names
                    if n not in self._outputs.get(op.name, {})]
        if missing:
            raise ValueError(
                f"op '{op.name}': unbound operands {missing} — "
                f"register them with BindingRegistry.bind()")

    def inputs(self, op: OpSpec, state: State) -> list:
        table = self._inputs[op.name]
        return [table[n].read(state) for n in op.in_names]

    def commit(self, op: OpSpec, state: State, outs: Sequence) -> State:
        table = self._outputs[op.name]
        for name, new in zip(op.out_names, outs):
            state = table[name].write(state, new)
        return state

    def describe(self, op: OpSpec) -> dict:
        def lab(slot: Slot, rw):
            fn = slot.get if rw == "r" else slot.put
            return (slot.key or "<computed>") + ("*" if fn else "")
        return {
            "inputs": {n: lab(self._inputs[op.name][n], "r")
                       for n in op.in_names},
            "outputs": {n: lab(self._outputs[op.name][n], "w")
                        for n in op.out_names},
        }


def default_bindings(ops: Sequence[OpSpec]) -> BindingRegistry:
    """One state key per (op, operand): ``"{op.name}.{operand}"``."""
    reg = BindingRegistry()
    for op in ops:
        reg.bind(op.name, **{n: f"{op.name}.{n}"
                             for n in (*op.in_names, *op.out_names)})
    return reg


def synth_state(ops: Sequence[OpSpec], seed: int = 0) -> State:
    """Operands for every *input* of ``ops`` under ``default_bindings``'
    keys, on the CPU from a seeded generator: small normals for floats,
    zeros otherwise (``core/timing.py`` ``synth_inputs``, keyed for the
    executor)."""
    gen = torch.Generator()
    gen.manual_seed(seed)
    state: State = {}
    for op in ops:
        for name, o in zip(op.in_names, op.inputs):
            k = f"{op.name}.{name}"
            if k in state:
                continue
            if o.dtype.is_floating_point:
                state[k] = (torch.randn(o.shape, generator=gen)
                            * 0.1).to(o.dtype)
            else:
                state[k] = torch.zeros(o.shape, dtype=o.dtype)
    return state
