"""Train step assembly: autograd, microbatched gradient accumulation, global
norm clipping, the AdamW update, metrics.

The reference's ``src/repro/train/train_loop.py``.  Forward and backward are
plain torch autograd (the reference computes them in plain ``jnp``), with
``torch.utils.checkpoint`` per layer under ``remat``.  The optimizer step is
the planner's: ``update_graph`` registers one AdamW OpSpec per param leaf
(and the dW GEMM each 2-D leaf's update depends on);
``build_update_program`` plans and compiles every leaf's update into fused
bundle launches that update params and moments in place.
``plan_update_fusion``'s plan, dW GEMMs included, compiles with
``core/executor.compile_plan`` as well: a stitched ``dW_w→adamw_w`` chain is
one launch (``kernels/row.RowChain``) that hands each dW product to its
AdamW update, given bindings for dW's operands.

Not ported: ``compression=`` (int8 pod-axis gradients) and ``zero=``
(ZeRO-1 moment sharding) raise; they wait for tensor parallelism (ROADMAP
item 5).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Optional

import torch

from repro_torch import tree as tree_mod
from repro_torch.configs.base import ModelConfig
from repro_torch.models import lm
from repro_torch.train import optimizer as opt_mod
from repro_torch.train.optimizer import AdamWConfig, OptState


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    optimizer: AdamWConfig = AdamWConfig()
    grad_accum: int = 1
    remat: bool = True
    compression: Optional[str] = None       # not ported (ROADMAP item 5)
    zero: bool = False                      # not ported (ROADMAP item 5)
    max_grad_norm: float = 1.0

    def __post_init__(self):
        if self.compression is not None:
            raise NotImplementedError("gradient compression (compression=) "
                                      "is not ported yet (ROADMAP item 5)")
        if self.zero:
            raise NotImplementedError("ZeRO-1 moment sharding (zero=) is not "
                                      "ported yet (ROADMAP item 5)")


def leaf_update_name(path) -> str:
    """Graph-op name stem of one param leaf: the reference's
    ``jax.tree_util.keystr`` of a dict path (``['a']['b']``) with every
    non-alphanumeric character made ``_``, outer ones stripped."""
    key = "".join(f"['{k}']" for k in path)
    return "".join(c if c.isalnum() else "_" for c in key).strip("_")


def _leaf_rows(leaf, bm: int):
    """(n, R, bm_i): flat element count, padded (R, 128) rows, block rows —
    the layout shared by ``kernels.adam._flatten_leaf`` and the adamw
    OpSpec grid."""
    from repro_torch.kernels.adam import LANES

    n = math.prod(leaf.shape) if leaf.shape else 1
    rows = math.ceil(n / LANES)
    bm_i = min(bm, rows)
    R = math.ceil(rows / bm_i) * bm_i
    return n, R, bm_i


def update_graph(params, *, tokens: int = 4096, bm: int = 1024,
                 max_tensors: Optional[int] = 8, include_dW: bool = True,
                 b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8,
                 wd: float = 0.1):
    """The optimizer-step op graph: one AdamW OpSpec per param leaf and,
    with ``include_dW``, the backward dW GEMM ``x^T @ dy`` each 2-D
    parameter's update depends on.  When the dW output's row-major layout
    lines up with the update's (R, 128) gradient, the dW op declares the
    update as its epilogue and the planner contracts the pair into one
    ``dW_w→adamw_w`` member (``kernels/row.RowChain``).

    ``params`` may be live tensors or ``device="meta"`` tensors.  Returns
    ``(graph, layout)`` with ``layout = [(name, path, n, R, bm_i), ...]``."""
    from repro_torch.core import planner
    from repro_torch.kernels.adam import LANES, adamw_op
    from repro_torch.kernels.matmul import matmul_1d_op

    flat = tree_mod.flatten_with_paths(params)
    if max_tensors is not None:
        flat = sorted(flat, key=lambda kv: -math.prod(kv[1].shape or (1,)))
        flat = flat[:max_tensors]
    graph: list[planner.GraphOp] = []
    layout: list[tuple] = []
    for path, leaf in flat:
        pname = leaf_update_name(path)
        n, R, bm_i = _leaf_rows(leaf, bm)
        deps: frozenset[str] = frozenset()
        if include_dW and leaf.ndim == 2:
            d_in, d_out = leaf.shape
            bmm = min(256, d_in)
            if d_in % bmm == 0:
                dw = matmul_1d_op(M=d_in, K=tokens, N=d_out, dtype=leaf.dtype,
                                  bm=bmm)
                dw = dataclasses.replace(dw, name=f"dW_{pname}",
                                         tag="train:dW")
                if n % LANES == 0 and (bmm * d_out) % LANES == 0:
                    # exact row-major correspondence: (d_in, d_out) is
                    # (n/128, 128) unpadded, and update blocks of bmm rows
                    # of d_out make the two grids identical
                    bm_i = bmm * d_out // LANES
                    R = n // LANES
                    dw = dataclasses.replace(
                        dw, epilogue=(f"adamw_{pname}", "g"))
                graph.append(planner.GraphOp(dw))
                deps = frozenset({dw.name})
        upd = adamw_op(R=R, dtype=leaf.dtype, bm=bm_i, name=f"adamw_{pname}",
                       b1=b1, b2=b2, eps=eps, wd=wd)
        graph.append(planner.GraphOp(upd, deps=deps))
        layout.append((f"adamw_{pname}", path, n, R, bm_i))
    return graph, layout


def plan_update_fusion(params, *, tokens: int = 4096, max_ways: int = 3,
                       bm: int = 1024, max_tensors: int = 8,
                       measure=None, cache=None):
    """Plan the optimizer's per-tensor updates together with the backward
    dW GEMMs (``planner.plan``); the planning view of optimizer/backward
    overlap.  ``measure``/``cache`` reach the autotuner."""
    from repro_torch.core import planner

    graph, _ = update_graph(params, tokens=tokens, bm=bm,
                            max_tensors=max_tensors, include_dW=True)
    return planner.plan(graph, max_ways=max_ways, measure=measure,
                        cache=cache)


class UpdateProgram:
    """The executed optimizer step: a ``FusionPlan`` over every param
    leaf's AdamW op, lowered by ``core/executor``, with the bindings
    routing each op's operands to the (R, 128) buffers of its leaves.
    Params and moments are updated in place: a leaf whose rows fill its
    blocks exactly is updated through a view, a padded one through a copy
    written back after the launch."""

    def __init__(self, plan, program, layout, hyper: dict):
        self.plan = plan
        self.program = program
        self.layout = layout
        self.hyper = hyper

    def __call__(self, params, grads, m, v, *, lr, bc1, bc2):
        from repro_torch.kernels.adam import _flatten_leaf, _write_back

        lp, lg = tree_mod.leaves(params), tree_mod.leaves(grads)
        lm, lv = tree_mod.leaves(m), tree_mod.leaves(v)
        state = {"scalars": opt_mod.scalars_of(lr, bc1, bc2)}
        for (name, _path, n, _R, bm_i), p_, g_, m_, v_ in zip(
                self.layout, lp, lg, lm, lv):
            state[f"{name}.p"], _ = _flatten_leaf(p_, bm_i)
            state[f"{name}.g"], _ = _flatten_leaf(g_.to(p_.dtype), bm_i)
            state[f"{name}.m"], _ = _flatten_leaf(m_.float(), bm_i)
            state[f"{name}.v"], _ = _flatten_leaf(v_.float(), bm_i)
        state = self.program(state)
        for (name, _path, n, _R, _bm), p_, m_, v_ in zip(self.layout, lp,
                                                         lm, lv):
            _write_back(state[f"{name}.p"], n, p_)
            _write_back(state[f"{name}.m"], n, m_)
            _write_back(state[f"{name}.v"], n, v_)
        return params, m, v

    def describe(self) -> list[dict]:
        return self.program.describe()


def build_update_program(params, ocfg: Optional[AdamWConfig] = None, *,
                         bm: int = 1024, max_ways: int = 4, measure=None,
                         cache=None, plain: bool = False) -> UpdateProgram:
    """Plan and compile the executed optimizer step for ``params`` (live or
    ``device="meta"`` tensors).  Every leaf takes part; the train step has
    no dW operands to bind (autograd computes the gradients), so the graph
    holds the updates alone, which fuse with each other
    (``allow_same_bound``: all memory-bound, the gain is launch and ramp
    amortization)."""
    from repro_torch.core import executor, planner
    from repro_torch.core.binding import BindingRegistry

    ocfg = ocfg or AdamWConfig()
    graph, layout = update_graph(
        params, bm=bm, max_tensors=None, include_dW=False,
        b1=ocfg.b1, b2=ocfg.b2, eps=ocfg.eps, wd=ocfg.weight_decay)
    plan = planner.plan(graph, max_ways=max_ways, allow_same_bound=True,
                        measure=measure, cache=cache)
    reg = BindingRegistry()
    for name, *_ in layout:
        reg.bind(name, scalars="scalars", p=f"{name}.p", g=f"{name}.g",
                 m=f"{name}.m", v=f"{name}.v")
    program = executor.compile_plan(plan, bindings=reg, plain=plain)
    return UpdateProgram(plan, program, layout,
                         hyper=dict(b1=ocfg.b1, b2=ocfg.b2, eps=ocfg.eps,
                                    wd=ocfg.weight_decay))


# ---------------------------------------------------------------------------
# Gradients
# ---------------------------------------------------------------------------
def _chunks(t: torch.Tensor, size: int = 1 << 24):
    """Flat views of ``t`` of at most ``size`` elements (bounded fp32
    temporaries over a multi-GB leaf)."""
    return t.reshape(-1).split(size)


def global_norm(tree) -> torch.Tensor:
    leaves = tree_mod.leaves(tree)
    return torch.sqrt(sum(torch.sum(torch.square(c.float()))
                          for leaf in leaves for c in _chunks(leaf)))


def clip_by_global_norm(tree, max_norm: float):
    """Scale every leaf by min(1, max_norm / norm) in fp32, in place;
    returns (tree, norm)."""
    norm = global_norm(tree)
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-12), max=1.0)
    for leaf in tree_mod.leaves(tree):
        for c in _chunks(leaf):
            c.copy_((c.float() * scale).to(c.dtype))
    return tree, norm


def _grad_tree(cfg: ModelConfig, params: dict, grads: dict) -> dict:
    """Params as autograd leaves whose ``.grad`` is a view of ``grads``.

    Every stacked (L, ...) run leaf becomes a list of L per-layer slices, each
    its own autograd leaf (``lm.layer_params`` indexes a list as it
    indexes the stacked tensor): the backward of an index into the stacked
    tensor would build a full-size zero gradient per layer.  Each leaf's
    ``.grad`` is preset to its slice of ``grads``, so the backward pass
    accumulates in place into ``grads`` (no grad mode during backward)."""
    stacked = {run.name: run.count for run in lm.layer_runs(cfg)
               if run.count > 1}

    def leaf(path, p, g):
        if path[0] in stacked:
            out = []
            for i in range(stacked[path[0]]):
                t = p[i].detach().requires_grad_(True)
                t.grad = g[i]
                out.append(t)
            return out
        t = p.detach().requires_grad_(True)
        t.grad = g
        return t

    flat = tree_mod.flatten_with_paths(params)
    gl = tree_mod.leaves(grads)
    return tree_mod.unflatten(params, [leaf(path, p, g) for (path, p), g
                                       in zip(flat, gl)])


def make_train_step(cfg: ModelConfig, tcfg: TrainConfig,
                    update_program: Optional[UpdateProgram] = None
                    ) -> Callable:
    """``train_step(params, opt_state, batch, step) -> (params, opt_state,
    metrics)``; ``batch`` holds ``tokens`` and ``labels`` (B, S) int
    tensors on the params' device.  ``update_program``
    (``build_update_program``) runs the optimizer step on the planned fused
    bundles: the ``--plan-fusion`` hot path."""
    def backward_into(params, batch, grads):
        total, aux = lm.loss_fn(cfg, _grad_tree(cfg, params, grads), batch,
                                remat=tcfg.remat)
        total.backward()
        return total.detach(), {k: v.detach() for k, v in aux.items()}

    def compute_grads(params, batch):
        grads = tree_mod.map_tree(torch.zeros_like, params)
        if tcfg.grad_accum <= 1:
            loss, aux = backward_into(params, batch, grads)
            return loss, aux, grads
        n = tcfg.grad_accum
        micro = {k: v.reshape((n, v.shape[0] // n) + v.shape[1:])
                 for k, v in batch.items()}
        acc = tree_mod.map_tree(lambda p: torch.zeros(
            p.shape, dtype=torch.float32, device=p.device), params)
        lsum = 0.0
        for i in range(n):
            for g in tree_mod.leaves(grads):
                g.zero_()
            loss, aux = backward_into(params,
                                      {k: v[i] for k, v in micro.items()},
                                      grads)
            for a, g in zip(tree_mod.leaves(acc), tree_mod.leaves(grads)):
                a.add_(g.float())
            lsum = lsum + loss
        return lsum / n, aux, tree_mod.map_tree(lambda a: a / n, acc)

    def train_step(params, opt_state: OptState, batch, step):
        loss, aux, grads = compute_grads(params, batch)
        grads, gnorm = clip_by_global_norm(grads, tcfg.max_grad_norm)
        new_params, new_opt = opt_mod.update(tcfg.optimizer, grads,
                                             opt_state, params,
                                             program=update_program)
        metrics = {"loss": loss, "grad_norm": gnorm,
                   "lr": opt_mod.schedule(tcfg.optimizer,
                                          opt_state.count + 1)}
        metrics.update(aux)
        return new_params, new_opt, metrics

    return train_step
