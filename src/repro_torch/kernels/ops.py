"""The public kernel entry points, the port of ``src/repro/kernels/ops.py``:
its signatures and return shapes.

The reference's wrappers run Pallas on a TPU, and elsewhere interpret-mode
Pallas or its jnp oracle, with ``force()`` to pick for tests.  Here the
operands' device decides, as for every wrapper of the port: CUDA tensors
launch the hand-written kernel (and raise on what it cannot take, never
falling back), CPU tensors run its plain PyTorch version.  There is no
``force()`` and no "ref" mode: interpret mode has no counterpart, and the
plain versions are the CPU route.

  matmul           the tiled matmul (``kernels/matmul.matmul``)
  rmsnorm          the row family's rmsnorm launched alone
                   (``kernels/rmsnorm.rmsnorm``)
  flash_attention  (B,S,H,D) with GQA; the kernel reads KV head h // rep
                   where the reference repeats the KV heads
                   (``kernels/flash_attention.flash_attention_bshd``)
  moe_gmm          the grouped expert FFN member (``kernels/moe_gmm``)
  hfused_adamw     the AdamW member, one bundle launch for up to
                   ``cuda.MAX_MEMBERS`` leaves (``adam.multi_tensor_adamw``);
                   it updates params, m and v IN PLACE and returns them,
                   where the reference returns new trees.
"""
from __future__ import annotations

import torch

from repro_torch import tree
from repro_torch.kernels import adam, cuda
from repro_torch.kernels import flash_attention as fa_k
from repro_torch.kernels import matmul as mm_k
from repro_torch.kernels import moe_gmm as gmm_k
from repro_torch.kernels import rmsnorm as rn_k


def matmul(x: torch.Tensor, w: torch.Tensor, bm: int = 512, bn: int = 512,
           bk: int = 512) -> torch.Tensor:
    """x (M, K) @ w (K, N) -> (M, N) in x's dtype, fp32 accumulation."""
    return mm_k.matmul(x, w, bm=bm, bn=bn, bk=bk)


def rmsnorm(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """x (R, d); scale (d,) fp32 -> (R, d) in x's dtype."""
    return rn_k.rmsnorm(x, scale)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True) -> torch.Tensor:
    """q (B,S,H,D), k, v (B,S,Hkv,D) -> (B,S,H,D), GQA."""
    return fa_k.flash_attention_bshd(q, k, v, causal=causal)


def moe_gmm(xe: torch.Tensor, w_in: torch.Tensor, w_out: torch.Tensor,
            act: str = "silu", bc: int = 128) -> torch.Tensor:
    """xe (E,C,d); w_in (E,d,2f|f); w_out (E,f,d) -> (E,C,d)."""
    return gmm_k.moe_gmm(xe, w_in, w_out, act=act, bc=bc)


def hfused_adamw(params, grads, m, v, *, lr, b1, b2, eps, wd, bc1, bc2):
    """AdamW over every leaf, the per-tensor updates fused into bundle
    launches of up to ``cuda.MAX_MEMBERS`` leaves each (one launch for the
    reference's trees of up to 8 leaves); ``lr, bc1, bc2`` travel in the
    scalars row as the reference packs them.  Updates params, m and v in
    place; returns (params, m, v)."""
    lp, lg = tree.leaves(params), tree.leaves(grads)
    lm, lv = tree.leaves(m), tree.leaves(v)
    scal = torch.zeros((1, adam.LANES), dtype=torch.float32,
                       device=lp[0].device)
    scal[0, :3] = torch.tensor([lr, bc1, bc2], dtype=torch.float32)
    for i in range(0, len(lp), cuda.MAX_MEMBERS):
        part = [dict(enumerate(leaves[i:i + cuda.MAX_MEMBERS]))
                for leaves in (lp, lg, lm, lv)]
        adam.multi_tensor_adamw(*part, scal, b1=b1, b2=b2, eps=eps, wd=wd)
    return params, m, v
