"""Planning constants of the cost model.

These are the JAX package's TPU v5e planning numbers (its
``distributed/hlo_analysis.py`` hardware block and ``core/cost_model.py``
VMEM budget and launch term), copied unchanged so the port's planner makes
exactly the reference's fusion decisions on the same op graph.  They are a
*planning model*, not figures of the card this package runs on: every time
the planner predicts is a model number, and no H100 time is derived from
them.  A profile with H100 rates (shared memory per SM, occupancy, HBM rate,
tensor-core peak) is later work.
"""
from __future__ import annotations

PEAK_FLOPS = 197e12          # planning model: bf16 FLOP/s per device
HBM_BW = 819e9               # planning model: device-memory bytes/s
VMEM_BYTES = 128 * 2 ** 20   # planning model: fast on-chip memory per core
RIDGE = PEAK_FLOPS / HBM_BW  # flop/byte where compute and memory balance

VMEM_BUDGET = int(VMEM_BYTES * 0.8)   # headroom for spills/semaphores
LAUNCH_S = 2e-6                       # per-launch overhead term
