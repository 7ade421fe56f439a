"""AdamW over parameter trees (fp32 moments, bf16 or fp32 params).

The reference's ``src/repro/train/optimizer.py``, with its three update
routes:

  * ``program=``  — a ``train_loop.UpdateProgram``: the planner's fused
                    AdamW bundles on the bundle launcher (``--plan-fusion``);
                    params, m and v are updated in place.
  * ``hfused``    — ``kernels/adam.multi_tensor_adamw``, one N-way bundle,
                    for params on the card (the reference takes it on the
                    TPU only); also in place.
  * plain         — per-leaf tensor math, new tensors (the default).

The lr schedule and the bias corrections are computed in fp32 on the
params' device, as in the reference.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, NamedTuple

import numpy as np
import torch

from repro_torch import tree as tree_mod


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_frac: float = 0.1
    hfused: bool = False


class OptState(NamedTuple):
    m: Any
    v: Any
    count: torch.Tensor          # () int32


def schedule(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warmup then cosine decay, fp32."""
    step = step.float()
    warm = step / max(1.0, cfg.warmup_steps)
    prog = torch.clamp((step - cfg.warmup_steps)
                       / max(1.0, cfg.total_steps - cfg.warmup_steps), 0, 1)
    cos = cfg.min_lr_frac + (1 - cfg.min_lr_frac) * 0.5 * (
        1 + torch.cos(math.pi * prog))
    return cfg.lr * torch.minimum(warm, cos)


def init(params) -> OptState:
    def zeros(p):
        return torch.zeros(p.shape, dtype=torch.float32, device=p.device)
    first = tree_mod.leaves(params)[0]
    return OptState(m=tree_mod.map_tree(zeros, params),
                    v=tree_mod.map_tree(zeros, params),
                    count=torch.zeros((), dtype=torch.int32,
                                      device=first.device))


def opt_state_from_numpy(m: dict, v: dict, count: int, like: dict,
                         device=None) -> OptState:
    """The JAX package's moments (nested dicts of numpy arrays, the params'
    tree) as an ``OptState`` on ``device`` (default: the leaves of
    ``like``)."""
    dev = device or tree_mod.leaves(like)[0].device

    def leaf(arrs):
        def get(path):
            node = arrs
            for k in path:
                node = node[k]
            return torch.from_numpy(np.ascontiguousarray(
                np.asarray(node, np.float32))).to(dev, copy=True)
        return tree_mod.unflatten(like, [
            get(p) for p, _l in tree_mod.flatten_with_paths(like)])

    return OptState(m=leaf(m), v=leaf(v),
                    count=torch.tensor(count, dtype=torch.int32, device=dev))


def update(ocfg: AdamWConfig, grads, state: OptState, params, *,
           program=None):
    """One AdamW step -> (new_params, new_state)."""
    cnt = state.count + 1
    lr = schedule(ocfg, cnt)
    b1, b2 = ocfg.b1, ocfg.b2
    bc1 = 1 - b1 ** cnt.float()
    bc2 = 1 - b2 ** cnt.float()

    if program is not None:
        # b1/b2/eps/wd are baked into the program's members at build time
        # (lr and the bias corrections ride in the scalars operand): a
        # program built for other hyperparameters must never apply them
        built = getattr(program, "hyper", None)
        want = dict(b1=ocfg.b1, b2=ocfg.b2, eps=ocfg.eps,
                    wd=ocfg.weight_decay)
        if built is not None and built != want:
            raise ValueError(
                f"update program was built for hyperparameters {built}, "
                f"but update() was called with {want}: rebuild it with "
                f"build_update_program(params, ocfg)")
        new_p, new_m, new_v = program(params, grads, state.m, state.v,
                                      lr=lr, bc1=bc1, bc2=bc2)
        return new_p, OptState(new_m, new_v, cnt)

    first = tree_mod.leaves(params)[0]
    if ocfg.hfused and first.device.type == "cuda":
        from repro_torch.kernels.adam import multi_tensor_adamw
        new_p, new_m, new_v = multi_tensor_adamw(
            params, grads, state.m, state.v, scalars_of(lr, bc1, bc2),
            b1=b1, b2=b2, eps=ocfg.eps, wd=ocfg.weight_decay)
        return new_p, OptState(new_m, new_v, cnt)

    def upd(p, g, m, v):
        gf = g.float()
        m2 = b1 * m + (1 - b1) * gf
        v2 = b2 * v + (1 - b2) * gf * gf
        mh = m2 / bc1
        vh = v2 / bc2
        step = mh / (torch.sqrt(vh) + ocfg.eps) + ocfg.weight_decay * p.float()
        return (p.float() - lr * step).to(p.dtype), m2, v2

    out = [upd(p, g, m, v) for p, g, m, v in zip(
        tree_mod.leaves(params), tree_mod.leaves(grads),
        tree_mod.leaves(state.m), tree_mod.leaves(state.v))]
    return (tree_mod.unflatten(params, [o[0] for o in out]),
            OptState(tree_mod.unflatten(params, [o[1] for o in out]),
                     tree_mod.unflatten(params, [o[2] for o in out]), cnt))


def scalars_of(lr: torch.Tensor, bc1: torch.Tensor,
               bc2: torch.Tensor) -> torch.Tensor:
    """The AdamW members' (1, 128) fp32 scalars operand: [lr, bc1, bc2]."""
    sc = torch.zeros((1, 128), dtype=torch.float32, device=lr.device)
    sc[0, 0], sc[0, 1], sc[0, 2] = lr, bc1, bc2
    return sc
