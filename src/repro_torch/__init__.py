"""PyTorch/CUDA port of the horizontal-fusion system, for NVIDIA Hopper.

The JAX package ``repro`` is the reference; this package mirrors its layout
(``repro_torch/core/planner.py`` <-> ``repro/core/planner.py``, ...) and
imports nothing of it.  Every kernel on the served path is hand-written CUDA
C++ for ``sm_90a`` (``csrc/``), launched through one bundle launcher
(``core/hfuse.py``); each has a plain PyTorch version beside it, used only
for tensors that lie on the CPU.
"""
