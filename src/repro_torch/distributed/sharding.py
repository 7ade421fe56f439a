"""Logical-axis sharding rules and the tensor-parallel serve helpers.

The port's own copy of the reference's ``src/repro/distributed/sharding.py``
for the parts that hold no compiler: the rules tables, shape-aware
``PartitionSpec`` resolution, the ambient-mesh context, and the helpers of
head-sharded serve (``serve/engine.py`` with ``mesh=``).  A mesh is either a
``torch.distributed.device_mesh.DeviceMesh`` (axis names ``mesh_dim_names``,
extents ``shape``) or any object with ``axis_names`` and a ``shape`` mapping
axis name -> extent, as the reference reads a JAX mesh.

``PartitionSpec`` is a tuple of its entries, so a spec compares equal, as a
tuple, to the reference's.  The sharding constraint inside model code
(``shard``) and the param and state sharding trees belong to the
distributed trainer and the compile dry run, which come later (ROADMAP
item 5b, 5c).
"""
from __future__ import annotations

import contextlib
import math
import threading
from typing import Optional, Sequence, Union

import torch

MeshAxes = Union[None, str, tuple]


class PartitionSpec(tuple):
    """One entry per tensor dim: ``None`` (replicated), a mesh axis name,
    or a tuple of names."""

    def __new__(cls, *parts):
        return super().__new__(cls, parts)

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple.__repr__(self)}"


# ---------------------------------------------------------------------------
# Rules
# ---------------------------------------------------------------------------
# Default single/multi-pod rules.  "data" resolves to ("pod","data") on a
# multi-pod mesh (pure DP across pods), "model" to the intra-pod model axis.
BASE_RULES: dict[str, str] = {
    # activations
    "batch": "data",
    "seq": None,
    "sp_seq": "model",       # sequence-parallel sections (norms, elementwise)
    "kv_seq": "model",       # sequence-sharded KV cache
    "embed": None,
    "act_ffn": "model",
    "act_heads": "model",
    "act_vocab": "model",
    # params
    "ffn": "model",
    "heads": "model",
    "kv_heads": "model",
    "qkv": "model",
    "vocab": "model",
    "expert": "model",
    "expert_ffn": "model",
    "capacity": None,
    "lru": "model",
    "layer": None,
    "kv_lora": None,
    "q_lora": None,
}

# Family overrides: the DeepSeek-V2 class shards its expert corpus over
# 'data' and its capacity buffers over 'model'; dense configs at train
# shapes shard every param over the whole mesh on its embed dim (FSDP).
FAMILY_OVERRIDES: dict[str, dict[str, MeshAxes]] = {
    "moe-huge": {"expert": "data", "expert_ffn": "model", "capacity": "model"},
    "fsdp-train": {
        "batch": ("data", "model"),
        "embed": ("data", "model"),
        "ffn": None, "heads": None, "kv_heads": None, "qkv": None,
        "vocab": None, "lru": None, "act_ffn": None, "act_heads": None,
        "act_vocab": None, "sp_seq": None, "kv_seq": None,
    },
}


def _axis_names(mesh) -> tuple:
    names = getattr(mesh, "axis_names", None)
    return tuple(names if names is not None else mesh.mesh_dim_names)


def mesh_shape(mesh) -> dict[str, int]:
    """Axis name -> extent, for a ``DeviceMesh`` (``mesh_dim_names`` beside
    its tuple ``shape``) or a mesh whose ``shape`` maps names to extents."""
    if getattr(mesh, "mesh_dim_names", None) is not None:
        return dict(zip(mesh.mesh_dim_names, tuple(mesh.shape)))
    return {k: int(v) for k, v in dict(mesh.shape).items()}


def rules_for(cfg, mesh, kind: str = "") -> dict[str, MeshAxes]:
    """Logical -> mesh rules, specialized per family and workload kind (the
    reference's): an MoE config whose expert corpus passes 1e9 parameters a
    layer is "moe-huge"; a dense config at train shapes is "fsdp-train";
    on a mesh with a "pod" axis, "data" becomes ("pod", "data")."""
    rules = dict(BASE_RULES)
    fam = cfg.family
    if cfg.is_moe and cfg.moe.num_experts * cfg.moe.d_ff_expert \
            * cfg.d_model * 3 > 1e9:
        fam = "moe-huge"
    if kind == "train" and not cfg.is_moe:
        fam = "fsdp-train"
    rules.update(FAMILY_OVERRIDES.get(fam, {}))
    if "pod" in _axis_names(mesh):
        def remap(v):
            if v == "data":
                return ("pod", "data")
            if isinstance(v, tuple) and "data" in v:
                out = []
                for a in v:
                    out.extend(("pod", "data") if a == "data" else (a,))
                return tuple(out)
            return v
        rules = {k: remap(v) for k, v in rules.items()}
    return rules


# ---------------------------------------------------------------------------
# Ambient mesh context
# ---------------------------------------------------------------------------
class _Ctx(threading.local):
    mesh = None
    rules: Optional[dict] = None


_CTX = _Ctx()


@contextlib.contextmanager
def use_sharding(mesh, rules: Optional[dict] = None):
    old = (_CTX.mesh, _CTX.rules)
    _CTX.mesh, _CTX.rules = mesh, rules
    try:
        yield
    finally:
        _CTX.mesh, _CTX.rules = old


def current_mesh():
    return _CTX.mesh


# ---------------------------------------------------------------------------
# Resolution
# ---------------------------------------------------------------------------
def _axis_size(mesh, axes: MeshAxes) -> int:
    if axes is None:
        return 1
    shape = mesh_shape(mesh)
    if isinstance(axes, str):
        return shape[axes]
    return math.prod(shape[a] for a in axes)


def resolve_pspec(logical: Sequence[Optional[str]], shape: Sequence[int],
                  mesh, rules: dict[str, MeshAxes]) -> PartitionSpec:
    """Shape-aware logical -> mesh resolution: a dim its mesh axes do not
    divide falls back to a divisible prefix of them, else replicates; no
    mesh axis is assigned to two dims."""
    used: set[str] = set()
    out = []
    for name, dim in zip(logical, shape):
        target = rules.get(name) if name else None
        if target is None:
            out.append(None)
            continue
        tgt = (target,) if isinstance(target, str) else tuple(target)
        if any(a in used for a in tgt):
            out.append(None)
            continue
        if dim % _axis_size(mesh, tgt) != 0:
            ok = None
            for cut in range(len(tgt) - 1, 0, -1):
                sub = tgt[:cut]
                if dim % _axis_size(mesh, sub) == 0 \
                        and not any(a in used for a in sub):
                    ok = sub
                    break
            if ok is None:
                out.append(None)
                continue
            tgt = ok
        used.update(tgt)
        out.append(tgt[0] if len(tgt) == 1 else tgt)
    return PartitionSpec(*out)


def data_shards() -> int:
    """Extent of the (pod x) data axes of the ambient mesh (1 when unset)."""
    mesh, rules = _CTX.mesh, _CTX.rules or BASE_RULES
    if mesh is None:
        return 1
    return _axis_size(mesh, rules.get("batch", "data"))


# ---------------------------------------------------------------------------
# Tensor-parallel serve helpers (head-sharded executed decode; serve/engine)
# ---------------------------------------------------------------------------
# Each shard owns H/n query heads, Hkv/n KV heads and d_ff/n FFN columns;
# activations (d_model) stay replicated, and the two row-split output
# projections (w_o, w_out) give partial products that are all-reduced.  Two
# fused weights need a column permutation before the even last-axis split
# hands each shard a self-consistent slab:
#
#   w_qkv (d, (H+2*Hkv)*D): [q_0..q_{H-1} | k_0.. | v_0..] becomes
#       shard-major [q_s | k_s | v_s], so the engine's head-split glue
#       works unchanged with local head counts;
#   w_in  (d, 2*d_ff), gated: [gate | up] becomes per-shard [gate_s | up_s]
#       (a non-gated w_in needs no permutation).
#
# Row-split weights (w_o rows are head-major, w_out rows follow the
# activation's column order) split evenly without reordering.
_TP_COL_SHARDED = ("w_qkv", "w_in")     # last axis, after the permutation
_TP_ROW_SHARDED = ("w_o", "w_out")      # axis -2; all-reduce after matmul


def tp_qkv_permutation(H: int, Hkv: int, D: int, shards: int) -> torch.Tensor:
    """Column permutation taking [q|k|v] to shard-major [q_s|k_s|v_s]."""
    if H % shards or Hkv % shards:
        raise ValueError(f"H={H}, Hkv={Hkv} not divisible by {shards} shards")
    Hl, Hkvl = H // shards * D, Hkv // shards * D
    idx = []
    for s in range(shards):
        idx.extend(range(s * Hl, (s + 1) * Hl))
        idx.extend(range(H * D + s * Hkvl, H * D + (s + 1) * Hkvl))
        idx.extend(range((H + Hkv) * D + s * Hkvl,
                         (H + Hkv) * D + (s + 1) * Hkvl))
    return torch.tensor(idx, dtype=torch.long)


def tp_gated_ffn_permutation(F: int, shards: int) -> torch.Tensor:
    """Column permutation taking [gate|up] to per-shard [gate_s|up_s]."""
    if F % shards:
        raise ValueError(f"d_ff={F} not divisible by {shards} shards")
    Fl = F // shards
    idx = []
    for s in range(shards):
        idx.extend(range(s * Fl, (s + 1) * Fl))
        idx.extend(range(F + s * Fl, F + (s + 1) * Fl))
    return torch.tensor(idx, dtype=torch.long)


def tp_permute_qkv(w: torch.Tensor, H: int, Hkv: int, D: int,
                   shards: int) -> torch.Tensor:
    """Shard-major column order for a fused QKV weight (the last axis, so
    layer-stacked ``(L, d, N)`` leaves work too)."""
    perm = tp_qkv_permutation(H, Hkv, D, shards)
    return torch.index_select(w, -1, perm.to(w.device))


def tp_permute_gated_ffn(w: torch.Tensor, F: int, shards: int) -> torch.Tensor:
    """Per-shard [gate_s|up_s] column order for a gated FFN in-projection."""
    perm = tp_gated_ffn_permutation(F, shards)
    return torch.index_select(w, -1, perm.to(w.device))


def tp_param_pspec(name: str, ndim: int, axis: str = "model") -> PartitionSpec:
    """PartitionSpec of one serve param leaf under head-sharded TP, by the
    leaf's key; anything not split (norm scales, the embedding, the head)
    replicates."""
    if name in _TP_COL_SHARDED:
        return PartitionSpec(*([None] * (ndim - 1) + [axis]))
    if name in _TP_ROW_SHARDED:
        return PartitionSpec(*([None] * (ndim - 2) + [axis, None]))
    return PartitionSpec()


def tp_cache_pspec(name: str, ndim: int, axis: str = "model") -> PartitionSpec:
    """PartitionSpec of a KV-cache leaf: k/v split their head axis (-2, for
    contiguous ``(B,S,Hkv,D)``, stacked ``(L,B,S,Hkv,D)`` and the paged
    ``(blocks,bs,Hkv,D)`` arena); positions and block tables replicate."""
    if name in ("k", "v"):
        return PartitionSpec(*([None] * (ndim - 2) + [axis, None]))
    return PartitionSpec()


def tp_shard_params(params: dict, rank: int, n: int, *, cfg) -> dict:
    """Shard ``rank`` of ``n``'s slab of a dense config's serve params, as
    the reference's ``shard_map`` hands it to one shard: ``w_qkv`` and
    ``w_in`` permuted shard-major (``w_in`` only when gated) and split on
    the last axis, ``w_o`` and ``w_out`` split on axis -2, every other
    leaf the caller's own tensor.  Each split leaf is a new contiguous
    tensor holding only the slab (the permutation's columns are gathered
    for this rank alone), so the full leaves can be freed."""
    if not 0 <= rank < n:
        raise ValueError(f"rank {rank} of {n} shards")
    gated = cfg.activation in ("silu", "gelu")

    def columns(w, perm):
        cols = perm.numel() // n
        return torch.index_select(
            w, -1, perm[rank * cols:(rank + 1) * cols].to(w.device))

    def leaf(name, w):
        if name == "w_qkv":
            return columns(w, tp_qkv_permutation(
                cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim, n))
        if name == "w_in":
            perm = (tp_gated_ffn_permutation(cfg.d_ff, n) if gated
                    else torch.arange(w.shape[-1]))
            return columns(w, perm)
        if name in _TP_ROW_SHARDED:
            rows = w.shape[-2] // n
            return w.narrow(-2, rank * rows, rows).clone(
                memory_format=torch.contiguous_format)
        return w

    def walk(tree):
        return {k: walk(v) if isinstance(v, dict) else leaf(k, v)
                for k, v in tree.items()}
    return walk(params)
