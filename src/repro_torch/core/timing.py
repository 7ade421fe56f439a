"""Measurement harness — the profiler inside the paper's Main() loop (Fig. 6).

``make_measure(backend="auto")`` builds the ``measure(fused, *ops) ->
seconds`` callable that ``autotuner.search(measure=)`` and
``planner.plan(measure=)`` take (the reference's
``src/repro/core/timing.py``); ``resolve_backend`` maps "auto" to "gpu"
with a card and to "interpret" on the CPU, as the reference maps it to
"tpu" or "interpret":

  gpu        — device time on the card: synthesize the operands from the
               OpSpecs, ``warmup`` runs, then ``repeats`` runs each between
               two CUDA events on the current stream (``device_times``:
               the queue primed, the L2 flushed before each), and a
               trimmed mean (drop the ``trim`` fastest and slowest).
               Without a card it raises.
  interpret  — the reference's deterministic step-count proxy: the fused
               launch's CTA count (``fused.n_steps``) times the bundle's mean
               per-step roofline work.  It ranks schedules on any machine and
               gives the reference's measured plans on the CPU; its absolute
               gains are only launch amortization (``rank_only``).
               ``execute=True`` also runs each candidate on synthesized
               operands (the plain versions on the CPU): the numerics path
               exercised, for reduced-size ops only.
"""
from __future__ import annotations

import statistics
from typing import Callable, Sequence

import torch

from repro_torch.core.op_spec import OpSpec
from repro_torch.core.profile import LAUNCH_S

BACKENDS = ("gpu", "interpret")

# Device timing (``device_times``): a queued GPU sleep (~50 ms) before the
# timed runs, so the host has enqueued them all before the device reaches
# them and the events bracket device time only, not the host's launch
# overhead; and a buffer larger than the H100's 50 MB L2, zeroed before each
# run, so every run starts with its operands out of the cache, as a kernel
# of a real step does.  REPS: runs per reported kernel time (a median).
FLUSH_FLOATS = 64 * 2 ** 20
SLEEP_CYCLES = 100_000_000
REPS = 20


def resolve_backend(backend: str = "auto", device=None) -> str:
    """"auto" -> "gpu" where the operands live on a card (``device``, else
    a card being present), "interpret" on the CPU; other names pass."""
    if backend != "auto":
        return backend
    if device is not None:
        return "gpu" if torch.device(device).type == "cuda" else "interpret"
    return "gpu" if torch.cuda.is_available() else "interpret"


def synth_inputs(ops: Sequence[OpSpec], seed: int = 0,
                 device=None) -> list[torch.Tensor]:
    """One flat operand list for a bundle, from a seeded generator on
    ``device``: small normals for floats, zeros otherwise.  Timing only —
    numerics are the tests' job."""
    dev = torch.device(device or "cpu")
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    out: list[torch.Tensor] = []
    for op in ops:
        for o in op.inputs:
            if o.dtype.is_floating_point:
                out.append((torch.randn(o.shape, generator=gen, device=dev)
                            * 0.1).to(o.dtype))
            else:
                out.append(torch.zeros(o.shape, dtype=o.dtype, device=dev))
    return out


def step_time_proxy(fused, ops: Sequence[OpSpec]) -> float:
    """Fused-launch length x mean step work (the reference's proxy).
    Callables without ``n_steps`` (``run_native``) are charged the exact
    per-op work plus one launch per op."""
    total_work = sum(op.t_compute + op.t_memory for op in ops)
    total_steps = sum(op.grid for op in ops)
    n_steps = getattr(fused, "n_steps", None)
    if n_steps is None:
        return total_work + len(ops) * LAUNCH_S
    return n_steps * (total_work / max(total_steps, 1)) + LAUNCH_S


def flush_buffer(device) -> torch.Tensor:
    """The L2-evicting buffer ``device_times`` zeroes before each run."""
    return torch.empty(FLUSH_FLOATS, dtype=torch.float32, device=device)


def device_times(fn, reps: int, flush: torch.Tensor, *,
                 warmup: int = 1) -> list[float]:
    """Device seconds of each of ``reps`` calls of ``fn`` on the current
    stream, CUDA events around each, ``flush`` zeroed before each, after
    ``warmup`` untimed calls.  ``torch.cuda._sleep`` (private PyTorch API,
    a spin of the given GPU clock cycles) primes the queue."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    starts = [torch.cuda.Event(enable_timing=True) for _ in range(reps)]
    ends = [torch.cuda.Event(enable_timing=True) for _ in range(reps)]
    torch.cuda._sleep(SLEEP_CYCLES)
    for s, e in zip(starts, ends):
        flush.zero_()
        s.record()
        fn()
        e.record()
    torch.cuda.synchronize()
    return [s.elapsed_time(e) * 1e-3 for s, e in zip(starts, ends)]


def median_ms(fn, flush: torch.Tensor, reps: int = REPS) -> float:
    """Median of ``device_times`` in milliseconds: one kernel's reported
    time on the card."""
    return statistics.median(device_times(fn, reps, flush)) * 1e3


def _trimmed_mean(ts: list[float], trim: int) -> float:
    ts = sorted(ts)
    k = trim if len(ts) > 2 * trim else 0
    kept = ts[k:len(ts) - k] if k else ts
    return sum(kept) / len(kept)


def make_measure(backend: str = "auto", *, warmup: int = 2, repeats: int = 5,
                 trim: int = 1, execute: bool = False, seed: int = 0,
                 device=None) -> Callable:
    """The ``measure(fused, *ops) -> seconds`` callable of ``backend``
    (``"gpu"``, ``"interpret"``, or ``"auto"``: ``resolve_backend``)."""
    backend = resolve_backend(backend, device)
    if backend not in BACKENDS:
        raise ValueError(f"measure backend {backend!r}: one of {BACKENDS}")

    if backend == "interpret":
        def measure(fused, *ops):
            if execute and hasattr(fused, "schedule"):
                from repro_torch.core import hfuse
                hfuse.generate(ops, fused.schedule, plain=True)(
                    *synth_inputs(ops, seed))
            return step_time_proxy(fused, ops)
        measure.backend = "interpret"
        # the proxy RANKS schedules; its native-vs-fused difference is only
        # launch amortization, so the planner admits on the predicted gain
        measure.rank_only = True
        return measure

    if not torch.cuda.is_available():
        raise RuntimeError("make_measure('gpu'): no CUDA device to time on")
    dev = torch.device("cuda", torch.cuda.current_device())
    flush = flush_buffer(dev)

    def measure(fused, *ops):
        args = synth_inputs(ops, seed, dev)
        return _trimmed_mean(device_times(lambda: fused(*args),
                                          max(1, repeats), flush,
                                          warmup=max(1, warmup)), trim)

    measure.backend = "gpu"
    return measure
