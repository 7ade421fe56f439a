"""LM assembly for the global-attention subset the port serves and trains:
one run of layers, each with RMSNorm or LayerNorm and a dense FFN or an
MoE FFN (``models/moe.py``):
the train forward and loss, and the hand-wired serve entry points
``prefill`` and ``decode_step`` (the reference's oracle for the executed
decode program).

Parameters are plain nested dicts of tensors with the JAX package's tree
and layouts: weights stay ``(K, N)``, a run of ``count > 1`` identical
layers stacks its leaves on a leading ``(L, ...)`` axis, and the KV cache
is ``(B, S, Hkv, D)`` per layer.  ``params_from_numpy`` takes the JAX
package's params as numpy arrays, so both packages compute with the same
weights in the tests.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ATTN, ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models import layers, moe as moe_mod

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32,
           "float16": torch.float16}


def torch_dtype(name: str) -> torch.dtype:
    return _DTYPES[name]


class Run(NamedTuple):
    kind: str
    is_moe: bool
    start: int
    count: int

    @property
    def name(self) -> str:
        return f"run{self.start:02d}_{self.kind}{'_moe' if self.is_moe else ''}"


def layer_runs(cfg: ModelConfig) -> list[Run]:
    runs: list[Run] = []
    for i, kind in enumerate(cfg.pattern):
        m = cfg.moe_layer(i)
        if runs and runs[-1].kind == kind and runs[-1].is_moe == m:
            runs[-1] = runs[-1]._replace(count=runs[-1].count + 1)
        else:
            runs.append(Run(kind, m, i, 1))
    return runs


def supported(cfg: ModelConfig) -> Optional[str]:
    """None when the port's model code can build, train and serve this
    config through the hand-wired ``prefill`` / ``decode_step``; else why
    not.  Whether the planned decode program serves it too is another
    question: ``serve.engine.executable_decode_supported``."""
    runs = layer_runs(cfg)
    if cfg.frontend != "none":
        return f"frontend {cfg.frontend!r} (token frontend only)"
    if len(runs) != 1 or runs[0].kind != ATTN:
        return "needs a single global-attention layer run"
    if cfg.norm not in ("rmsnorm", "layernorm"):
        return f"norm {cfg.norm!r}"
    if not cfg.is_moe and cfg.d_ff <= 0:
        return "no FFN"
    if cfg.activation not in ("silu", "gelu", "gelu_mlp", "relu2_mlp"):
        return f"activation {cfg.activation!r}"
    return None


# ---------------------------------------------------------------------------
# Parameter layout: path -> (shape, init, dtype override)
# ---------------------------------------------------------------------------
def param_layout(cfg: ModelConfig) -> dict:
    reason = supported(cfg)
    if reason is not None:
        raise NotImplementedError(f"{cfg.name}: {reason} (ROADMAP)")
    d, H, Hkv = cfg.d_model, cfg.num_heads, cfg.num_kv_heads
    D, f, V = cfg.resolved_head_dim, cfg.d_ff, cfg.vocab_size
    gated = cfg.activation in ("silu", "gelu")
    run = layer_runs(cfg)[0]
    lead = (run.count,) if run.count > 1 else ()

    def norm(lead_):
        # RMSNorm: a zero scale (applied as 1 + scale); LayerNorm: a unit
        # scale and a zero bias; both fp32
        if cfg.norm == "rmsnorm":
            return {"scale": (lead_ + (d,), "zeros", "float32")}
        return {"scale": (lead_ + (d,), "ones", "float32"),
                "bias": (lead_ + (d,), "zeros", "float32")}

    block = {
        "norm1": norm(lead),
        "attn": {"w_qkv": (lead + (d, (H + 2 * Hkv) * D), "normal", None),
                 "w_o": (lead + (H * D, d), "out_proj", None)},
        "norm2": norm(lead),
    }
    if run.is_moe:
        block["moe"] = {k: (lead + shape, kind, dt)
                        for k, (shape, kind, dt) in moe_mod.spec(cfg).items()}
    else:
        block["mlp"] = {
            "w_in": (lead + (d, 2 * f if gated else f), "normal", None),
            "w_out": (lead + (f, d), "out_proj", None)}
    layout = {"embed": {"embedding": ((V, d), "embed", None)},
              run.name: block,
              "final_norm": norm(())}
    if not cfg.tie_embeddings:
        layout["head"] = {"w": ((d, V), "normal", None)}
    return layout


def _leaves(tree, path=()):
    """(path, leaf) pairs in sorted-key order (the reference's order)."""
    if isinstance(tree, tuple):
        yield path, tree
        return
    for k in sorted(tree):
        yield from _leaves(tree[k], path + (k,))


def _set(tree: dict, path, value):
    for p in path[:-1]:
        tree = tree.setdefault(p, {})
    tree[path[-1]] = value


def init(cfg: ModelConfig, generator: torch.Generator,
         device=None) -> dict:
    """Random parameters on ``device`` (the card unless ``device="cpu"``)
    from ``generator``: normal(0, 1/sqrt(fan_in)) weights,
    1/sqrt(2 fan_in) output projections, unit-scale embeddings, zero
    RMSNorm scales, unit LayerNorm scales and zero biases — the
    reference's scheme, other random numbers."""
    dev = resolve_device(device)
    dt = torch_dtype(cfg.dtype)
    params: dict = {}
    for path, (shape, kind, dt_override) in _leaves(param_layout(cfg)):
        ldt = torch_dtype(dt_override) if dt_override else dt
        if kind in ("zeros", "ones"):
            leaf = (torch.zeros if kind == "zeros" else torch.ones)(
                shape, dtype=ldt, device=dev)
        else:
            fan_in = shape[-2] if len(shape) >= 2 else shape[-1]
            scale = {"embed": 1.0,
                     "out_proj": 1.0 / math.sqrt(2.0 * max(1, fan_in)),
                     "normal": 1.0 / math.sqrt(max(1, fan_in))}[kind]
            leaf = (torch.randn(shape, generator=generator, device=dev,
                                dtype=torch.float32) * scale).to(ldt)
        _set(params, path, leaf)
    return params


def abstract_params(cfg: ModelConfig) -> dict:
    """The params' shapes and dtypes as ``device="meta"`` tensors (the
    reference plans from ``jax.eval_shape(lm.init)``)."""
    dt = torch_dtype(cfg.dtype)
    params: dict = {}
    for path, (shape, _kind, dt_override) in _leaves(param_layout(cfg)):
        _set(params, path, torch.empty(
            shape, dtype=torch_dtype(dt_override) if dt_override else dt,
            device="meta"))
    return params


def _from_numpy(a: np.ndarray) -> torch.Tensor:
    a = np.ascontiguousarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def params_from_numpy(cfg: ModelConfig, tree: dict, device=None) -> dict:
    """The JAX package's params (nested dict of numpy arrays, stacked
    leaves ``(L, ...)``) as the port's params on ``device``."""
    dev = resolve_device(device)
    params: dict = {}
    for path, (shape, _kind, _dt) in _leaves(param_layout(cfg)):
        node = tree
        for p in path:
            node = node[p]
        t = _from_numpy(np.asarray(node))
        if tuple(t.shape) != tuple(shape):
            raise ValueError(f"{'/'.join(path)}: shape {tuple(t.shape)}, "
                             f"expected {tuple(shape)}")
        _set(params, path, t.to(dev, copy=True))   # never the caller's
    return params


def layer_params(cfg: ModelConfig, params: dict) -> list[dict]:
    """Per-layer views of the (possibly stacked) block params."""
    run = layer_runs(cfg)[0]
    blk = params[run.name]
    if run.count == 1:
        return [blk]

    def index(t, l):
        return {k: index(v, l) for k, v in t.items()} \
            if isinstance(t, dict) else t[l]
    return [index(blk, l) for l in range(run.count)]


def init_cache(cfg: ModelConfig, B: int, max_len: int, device=None) -> dict:
    """Zero KV cache: ``{"pos": () i32, run: {"k", "v": (L?, B, S, Hkv,
    D)}}``."""
    dev = resolve_device(device)
    run = layer_runs(cfg)[0]
    lead = (run.count,) if run.count > 1 else ()
    shape = lead + (B, max_len, cfg.num_kv_heads, cfg.resolved_head_dim)
    dt = torch_dtype(cfg.dtype)
    return {"pos": torch.zeros((), dtype=torch.int32, device=dev),
            run.name: {"k": torch.zeros(shape, dtype=dt, device=dev),
                       "v": torch.zeros(shape, dtype=dt, device=dev)}}


def _embed_inputs(cfg: ModelConfig, params: dict,
                  tokens: torch.Tensor) -> torch.Tensor:
    """tokens (B, S) -> x (B, S, d)."""
    return layers.embed(params["embed"], tokens, cfg.d_model)


def count_params(cfg: ModelConfig, active_only: bool = False) -> int:
    """Parameters of the model; ``active_only`` leaves out the experts a
    token does not reach (E - top_k of every MoE layer's E)."""
    layout = param_layout(cfg)
    total = sum(math.prod(shape) for _path, (shape, _k, _d)
                in _leaves(layout))
    if active_only and cfg.is_moe:
        m, spec = cfg.moe, moe_mod.spec(cfg)
        per_layer = sum(math.prod(spec[k][0]) for k in ("w_in", "w_out"))
        n_moe = sum(1 for i in range(cfg.num_layers) if cfg.moe_layer(i))
        total -= n_moe * per_layer * (m.num_experts - m.top_k) \
            // m.num_experts
    return total


def _head(cfg: ModelConfig, params: dict, x: torch.Tensor) -> torch.Tensor:
    """x (B, S, d) -> fp32 logits (B, S, V)."""
    if cfg.tie_embeddings:
        return layers.unembed(params["embed"], x, cfg.logit_softcap)
    logits = torch.matmul(x.float(), params["head"]["w"].float())
    if cfg.logit_softcap:
        logits = torch.tanh(logits / cfg.logit_softcap) * cfg.logit_softcap
    return logits


# ---------------------------------------------------------------------------
# Full-sequence (train) path
# ---------------------------------------------------------------------------
def _apply_ffn(cfg: ModelConfig, p: dict, x: torch.Tensor):
    """The block's FFN on (B, S, d): the MoE FFN when the block routes
    (with its load-balancing loss), else the dense MLP (loss 0)."""
    if "moe" in p:
        return moe_mod.apply(cfg, p["moe"], x)
    return (layers.mlp(cfg, p["mlp"], x),
            torch.zeros((), dtype=torch.float32, device=x.device))


def cache_rows(t: torch.Tensor, max_len: int) -> torch.Tensor:
    """A sequence's k or v (B, S, Hkv, D) as a cache leaf of ``max_len``
    rows: its rows first, zeros after."""
    c = t.new_zeros((t.shape[0], max_len) + tuple(t.shape[2:]))
    c[:, :t.shape[1]] = t
    return c


def block_attention_seq(cfg: ModelConfig, p: dict, x: torch.Tensor):
    """The attention half of a global-attention block over a whole
    sequence: x (B, S, d) -> (x after attention and its residual, that
    x's norm2 (the FFN's input), k, v (B, S, Hkv, D) after rope)."""
    B, S, _ = x.shape
    positions = torch.arange(S, device=x.device)[None, :]
    h = layers.apply_norm(cfg, p["norm1"], x)
    q, k, v = layers.qkv_project(cfg, p["attn"], h)
    q = layers.rope(q, positions, cfg.rope_theta, cfg.rope_fraction)
    k = layers.rope(k, positions, cfg.rope_theta, cfg.rope_fraction)
    o = layers.blockwise_attention(q, k, v, causal=True)
    x = x + o.reshape(B, S, -1) @ p["attn"]["w_o"]
    return x, layers.apply_norm(cfg, p["norm2"], x), k, v


def block_apply_seq(cfg: ModelConfig, p: dict, x: torch.Tensor, *,
                    want_cache: bool = False, max_len: int = 0):
    """One global-attention block over a whole sequence: (B, S, d) ->
    (B, S, d), its auxiliary loss (0 for a dense FFN) and, with
    ``want_cache``, its KV cache leaves ``{"k", "v"}`` (B, max_len or S,
    Hkv, D), the sequence's rows first and zeros after (else None)."""
    x, h2, k, v = block_attention_seq(cfg, p, x)
    Smax = max_len or x.shape[1]
    cache = ({"k": cache_rows(k, Smax), "v": cache_rows(v, Smax)}
             if want_cache else None)
    ff, aux = _apply_ffn(cfg, p, h2)
    return x + ff, aux, cache


def forward(cfg: ModelConfig, params: dict, batch: dict, *,
            remat: bool = False):
    """Full-sequence forward -> (logits (B, S, V) fp32, aux loss, loss
    mask or None).  ``remat`` recomputes each layer in the backward pass
    (``torch.utils.checkpoint``): only the per-layer block inputs are kept,
    as the reference's ``jax.checkpoint`` over the layer scan keeps its
    carry."""
    x = _embed_inputs(cfg, params, batch["tokens"])
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for lp in layer_params(cfg, params):
        if remat:
            x, a, _ = checkpoint(block_apply_seq, cfg, lp, x,
                                 use_reentrant=False)
        else:
            x, a, _ = block_apply_seq(cfg, lp, x)
        aux = aux + a
    x = layers.apply_norm(cfg, params["final_norm"], x)
    return _head(cfg, params, x), aux, None


def loss_fn(cfg: ModelConfig, params: dict, batch: dict, *,
            remat: bool = True):
    """Mean token cross entropy (z-loss 1e-4) plus 0.01 x the auxiliary
    loss -> (total, {"ce", "aux"})."""
    logits, aux, mask = forward(cfg, params, batch, remat=remat)
    loss = layers.cross_entropy(logits, batch["labels"], mask=mask)
    return loss + 0.01 * aux, {"ce": loss, "aux": aux}


# ---------------------------------------------------------------------------
# Hand-wired serve path: prefill and single-token decode
# ---------------------------------------------------------------------------
def block_apply_decode(cfg: ModelConfig, p: dict, x: torch.Tensor,
                       cache: dict, pos):
    """One block for one new token a row: x (B, 1, d); ``cache`` the
    layer's ``{"k", "v"}`` (B, S, Hkv, D), written in place at row ``pos``
    (an int or a 0-d tensor: the index of the token; past the cache end
    it lands on the last row, as the reference's clamped update does).
    Returns (x_out, cache)."""
    B = x.shape[0]
    positions = torch.as_tensor(pos, device=x.device).reshape(1, 1) \
        .expand(B, 1)
    h = layers.apply_norm(cfg, p["norm1"], x)
    q, k, v = layers.qkv_project(cfg, p["attn"], h)
    q = layers.rope(q, positions, cfg.rope_theta, cfg.rope_fraction)
    k = layers.rope(k, positions, cfg.rope_theta, cfg.rope_fraction)
    kc, vc = cache["k"], cache["v"]
    row = positions[:1, 0].long().clamp(max=kc.shape[1] - 1)
    kc.index_copy_(1, row, k.to(kc.dtype))
    vc.index_copy_(1, row, v.to(vc.dtype))
    o = layers.decode_attention(q, kc, vc, positions[0, 0] + 1)
    x = x + o.reshape(B, 1, -1) @ p["attn"]["w_o"]
    ff, _aux = _apply_ffn(cfg, p, layers.apply_norm(cfg, p["norm2"], x))
    return x + ff, cache


def prefill(cfg: ModelConfig, params: dict, batch: dict, max_len: int):
    """Whole prompts ``batch["tokens"]`` (B, S) -> (cache, the last
    position's fp32 logits (B, V)); the cache is ``init_cache``'s layout at
    ``max_len`` rows with the prompts' k/v first and ``pos`` = S."""
    x = _embed_inputs(cfg, params, batch["tokens"])
    S = x.shape[1]
    run = layer_runs(cfg)[0]
    caches = []
    for lp in layer_params(cfg, params):
        x, _a, c = block_apply_seq(cfg, lp, x, want_cache=True,
                                   max_len=max_len)
        caches.append(c)
    kv = caches[0] if run.count == 1 else \
        {k: torch.stack([c[k] for c in caches]) for k in ("k", "v")}
    cache = {"pos": torch.tensor(S, dtype=torch.int32, device=x.device),
             run.name: kv}
    x = layers.apply_norm(cfg, params["final_norm"], x[:, -1:])
    return cache, _head(cfg, params, x)[:, 0]


def greedy_sample(cfg: ModelConfig, logits: torch.Tensor) -> torch.Tensor:
    """The greedy token of each row: (B, V) -> (B,) int32."""
    return torch.argmax(logits, dim=-1).to(torch.int32)


def serve_step_greedy(cfg: ModelConfig, params: dict, cache: dict,
                      tokens_t: torch.Tensor):
    """``decode_step`` and the greedy token: ((B,) int32, cache)."""
    logits, new_cache = decode_step(cfg, params, cache, tokens_t)
    return greedy_sample(cfg, logits), new_cache


def decode_step(cfg: ModelConfig, params: dict, cache: dict,
                tokens_t: torch.Tensor):
    """One decode step of every row at the cache's position ``pos`` (a 0-d
    int tensor): tokens_t (B,) -> (fp32 logits (B, V), cache with pos + 1).
    The k/v leaves are written in place (the returned cache shares
    them)."""
    x = layers.embed_onehot(params["embed"], tokens_t[:, None], cfg.d_model)
    pos = cache["pos"]
    run = layer_runs(cfg)[0]
    kv = cache[run.name]
    for li, lp in enumerate(layer_params(cfg, params)):
        kv_l = kv if run.count == 1 else {k: t[li] for k, t in kv.items()}
        x, _ = block_apply_decode(cfg, lp, x, kv_l, pos)
    x = layers.apply_norm(cfg, params["final_norm"], x)
    return _head(cfg, params, x)[:, 0], {"pos": pos + 1, run.name: kv}
