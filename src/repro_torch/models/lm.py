"""LM assembly for the block kinds the port serves and trains: global
attention, local (sliding-window) attention, multi-head latent attention
(``models/mla.py``), the RG-LRU recurrent block (``models/rglru.py``) and
the xLSTM's mLSTM and sLSTM blocks (``models/xlstm.py``), in any number of
runs, each block with RMSNorm or LayerNorm and a dense FFN (the run at
layer 0 of ``dense_d_ff_first`` width where the config sets it), an MoE
FFN (``models/moe.py``) or, where ``d_ff`` is 0, none (no ``norm2`` and no
``mlp``: the xLSTM blocks carry their own projections): the train forward
and loss, and the hand-wired serve entry points ``prefill`` and
``decode_step`` (the reference's oracle for the executed decode program).

Two frontends, as the reference's stubs.  ``vision_stub``: the batch's
fp32 ``pixel_embeds`` (B, n, d), cast to the model dtype, replace the
first n = ``num_image_tokens`` rows of the token embedding (a prompt
shorter than n grows to n rows) and the loss masks those positions.
``audio_stub``: tokens (B, K, S) of K codebooks; the embedding is (K, V,
d), the K lookups summed in the model dtype in codebook order plus the
sinusoid of the position (no sqrt(d) scale), and the head one (d, K V)
product rounded to the model dtype, logits (B, S, K, V); labels (B, K,
S), decode takes (B, K) codes and greedy gives (B, K).

Parameters are plain nested dicts of tensors with the JAX package's tree
and layouts: weights stay ``(K, N)``, a run of ``count > 1`` identical
layers stacks its leaves on a leading ``(L, ...)`` axis, and the cache is
per kind: ``(B, S, Hkv, D)`` k/v for global attention, a ring of
``min(local_window, max_len)`` rows for local attention, ``latent`` (B, S,
kv_lora) and ``rope`` (B, S, rope) for MLA, ``h`` (B, W) fp32 and ``conv``
(B, K - 1, W) for RG-LRU, the fp32 state ``C`` (B, H, dk, dv), ``n`` (B, H,
dk), ``m`` (B, H) and ``conv`` (B, K - 1, f) for the mLSTM, and ``c``,
``n``, ``m``, ``h`` (B, d) fp32 and ``conv`` (B, K - 1, d) for the sLSTM;
``init_cache`` fills every ``m`` leaf with ``xlstm.NEG``, the rest with
zeros.  ``params_from_numpy`` takes the JAX package's params as numpy
arrays, so both packages compute with the same weights in the tests.

Local attention's prefill handoff writes each of the last ``Wb`` positions
p to ring slot ``p % Wb``, the slot decode reads it from.  The reference
stores the last ``Wb`` rows at slots 0..Wb-1, which is the same wherever
S < Wb or S % Wb == 0 and breaks decode elsewhere (ROADMAP §3).
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import (ATTN, LOCAL_ATTN, MLA, MLSTM, RGLRU,
                                      SLSTM, ModelConfig)
from repro_torch.device import resolve_device
from repro_torch.models import layers, mla as mla_mod, moe as moe_mod
from repro_torch.models import rglru as rglru_mod, xlstm as xlstm_mod

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


SERVED_KINDS = (ATTN, LOCAL_ATTN, MLA, RGLRU, MLSTM, SLSTM)
FRONTENDS = ("none", "vision_stub", "audio_stub")


def supported(cfg: ModelConfig) -> Optional[str]:
    """None when the port's model code can build, train and serve this
    config through the hand-wired ``prefill`` / ``decode_step``; else why
    not.  Whether the planned decode program serves it too is another
    question: ``serve.engine.executable_decode_supported``."""
    if cfg.frontend not in FRONTENDS:
        return (f"frontend {cfg.frontend!r} (none, vision_stub and "
                "audio_stub only)")
    for run in layer_runs(cfg):
        if run.kind not in SERVED_KINDS:
            return (f"block kind {run.kind!r} (global attention, local "
                    "attention, MLA, RG-LRU, mLSTM and sLSTM only)")
    if cfg.norm not in ("rmsnorm", "layernorm"):
        return f"norm {cfg.norm!r}"
    if cfg.activation not in ("silu", "gelu", "gelu_mlp", "relu2_mlp"):
        return f"activation {cfg.activation!r}"
    return None


# ---------------------------------------------------------------------------
# Parameter layout: path -> (shape, init, dtype override)
# ---------------------------------------------------------------------------
def _norm_layout(cfg: ModelConfig, lead: tuple) -> dict:
    # RMSNorm: a zero scale (applied as 1 + scale); LayerNorm: a unit scale
    # and a zero bias; both fp32
    shape = lead + (cfg.d_model,)
    if cfg.norm == "rmsnorm":
        return {"scale": (shape, "zeros", "float32")}
    return {"scale": (shape, "ones", "float32"),
            "bias": (shape, "zeros", "float32")}


def _stacked(spec: dict, lead: tuple) -> dict:
    """A module's layout (nested dicts of (shape, init, dtype) leaves) with
    ``lead`` before every shape."""
    return {k: _stacked(v, lead) if isinstance(v, dict)
            else (lead + v[0],) + tuple(v[1:]) for k, v in spec.items()}


def _dense_ff_width(cfg: ModelConfig, run: Run) -> int:
    """The dense FFN's hidden width in ``run``: ``dense_d_ff_first`` for
    the run that starts at layer 0 when the config sets it (DeepSeek's
    dense first layer), else ``d_ff`` (the reference's ``_ffn_spec``)."""
    if run.start == 0 and cfg.dense_d_ff_first:
        return cfg.dense_d_ff_first
    return cfg.d_ff


def _block_layout(cfg: ModelConfig, run: Run) -> dict:
    """One run's block (leaves stacked ``(count, ...)`` when count > 1):
    norm1, the sequence mixer (``attn`` or ``rec``), then norm2 and the
    FFN where the block has one."""
    d, H, Hkv = cfg.d_model, cfg.num_heads, cfg.num_kv_heads
    D, f = cfg.resolved_head_dim, _dense_ff_width(cfg, run)
    gated = cfg.activation in ("silu", "gelu")
    lead = (run.count,) if run.count > 1 else ()
    block = {"norm1": _norm_layout(cfg, lead)}
    if run.kind == RGLRU:
        block["rec"] = _stacked(rglru_mod.spec(cfg), lead)
    elif run.kind == MLSTM:
        block["rec"] = _stacked(xlstm_mod.mlstm_spec(cfg), lead)
    elif run.kind == SLSTM:
        block["rec"] = _stacked(xlstm_mod.slstm_spec(cfg), lead)
    elif run.kind == MLA:
        block["attn"] = _stacked(mla_mod.spec(cfg), lead)
    else:
        block["attn"] = {
            "w_qkv": (lead + (d, (H + 2 * Hkv) * D), "normal", None),
            "w_o": (lead + (H * D, d), "out_proj", None)}
    if not run.is_moe and cfg.d_ff == 0:
        return block                # no FFN (the reference's ``_ffn_spec``)
    block["norm2"] = _norm_layout(cfg, lead)
    if run.is_moe:
        block["moe"] = _stacked(moe_mod.spec(cfg), lead)
    else:
        block["mlp"] = {
            "w_in": (lead + (d, 2 * f if gated else f), "normal", None),
            "w_out": (lead + (f, d), "out_proj", None)}
    return block


def param_layout(cfg: ModelConfig) -> dict:
    reason = supported(cfg)
    if reason is not None:
        raise NotImplementedError(f"{cfg.name}: {reason} (ROADMAP)")
    d, V = cfg.d_model, cfg.vocab_size
    if cfg.frontend == "audio_stub":
        # K codebook tables and the K heads as one (d, K V) weight
        K = cfg.num_codebooks
        layout = {"embed": {"embedding": ((K, V, d), "embed", None)},
                  "head": {"w": ((d, K * V), "normal", None)}}
    else:
        layout = {"embed": {"embedding": ((V, d), "embed", None)}}
        if not cfg.tie_embeddings:
            layout["head"] = {"w": ((d, V), "normal", None)}
    for run in layer_runs(cfg):
        layout[run.name] = _block_layout(cfg, run)
    layout["final_norm"] = _norm_layout(cfg, ())
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


# A leaf of at most INIT_WHOLE_MAX elements is drawn in one fp32 draw, as
# before (the largest other leaf drawn on one card, phi3.5-moe's experts
# cut to 8 layers, is 6.7 B elements, so its seeded weights stay); a larger
# one, DeepSeek's stacked expert leaves (7 x 160 x 5120 x 3072 at 8 layers:
# 70 GB as one fp32 draw), is drawn INIT_CHUNK elements at a time into its
# leaf, in order.
INIT_WHOLE_MAX = 2 ** 33
INIT_CHUNK = 2 ** 30


def _random_leaf(shape, scale: float, dtype, generator, dev):
    n = math.prod(shape)
    if n <= INIT_WHOLE_MAX:
        return (torch.randn(shape, generator=generator, device=dev,
                            dtype=torch.float32) * scale).to(dtype)
    leaf = torch.empty(shape, dtype=dtype, device=dev)
    for chunk in leaf.view(-1).split(INIT_CHUNK):
        chunk.copy_(torch.randn(chunk.shape, generator=generator, device=dev,
                                dtype=torch.float32) * scale)
    return leaf


def init(cfg: ModelConfig, generator: torch.Generator,
         device=None) -> dict:
    """Random parameters on ``device`` (the card unless ``device="cpu"``)
    from ``generator``: normal(0, 1/sqrt(fan_in)) weights,
    1/sqrt(2 fan_in) output projections, unit-scale embeddings, zero
    RMSNorm scales, unit LayerNorm scales and zero biases — the
    reference's scheme, other random numbers.  A leaf past
    ``INIT_WHOLE_MAX`` elements is drawn in chunks (``_random_leaf``)."""
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
            leaf = _random_leaf(shape, scale, ldt, generator, dev)
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


def layer_params(cfg: ModelConfig, tree: dict) -> list[tuple[Run, dict]]:
    """(run, the layer's part of ``tree``) for every layer in order, from
    a tree keyed by run name (the params, or a cache): a stacked run's
    leaves are indexed by layer (views), a list of per-layer leaves
    likewise."""
    def index(t, l):
        return {k: index(v, l) for k, v in t.items()} \
            if isinstance(t, dict) else t[l]
    out = []
    for run in layer_runs(cfg):
        blk = tree[run.name]
        if run.count == 1:
            out.append((run, blk))
        else:
            out.extend((run, index(blk, l)) for l in range(run.count))
    return out


def _cache_leaf_shapes(cfg: ModelConfig, run: Run, B: int,
                       max_len: int) -> dict:
    """One layer's cache leaves: name -> (shape, dtype)."""
    Hkv, D = cfg.num_kv_heads, cfg.resolved_head_dim
    dt = torch_dtype(cfg.dtype)
    if run.kind == ATTN:
        return {k: ((B, max_len, Hkv, D), dt) for k in ("k", "v")}
    if run.kind == LOCAL_ATTN:
        W = min(cfg.local_window, max_len)
        return {k: ((B, W, Hkv, D), dt) for k in ("k", "v")}
    if run.kind == MLA:
        m = cfg.mla
        return {"latent": ((B, max_len, m.kv_lora_rank), dt),
                "rope": ((B, max_len, m.qk_rope_head_dim), dt)}
    f32, K = torch.float32, cfg.conv1d_width
    if run.kind == RGLRU:
        W = cfg.lru_width or cfg.d_model
        return {"h": ((B, W), f32), "conv": ((B, K - 1, W), dt)}
    if run.kind == MLSTM:
        f, _qk, H, dk, dv = xlstm_mod.mlstm_dims(cfg)
        return {"C": ((B, H, dk, dv), f32), "n": ((B, H, dk), f32),
                "m": ((B, H), f32), "conv": ((B, K - 1, f), dt)}
    if run.kind == SLSTM:
        d = cfg.d_model
        return {"c": ((B, d), f32), "n": ((B, d), f32), "m": ((B, d), f32),
                "h": ((B, d), f32), "conv": ((B, K - 1, d), dt)}
    raise ValueError(run.kind)


def init_cache(cfg: ModelConfig, B: int, max_len: int, device=None) -> dict:
    """Fresh cache: ``{"pos": () i32, run: leaves}``, a run's leaves
    ``_cache_leaf_shapes``'s, led by ``count`` when the run stacks; every
    leaf zeros but the xLSTM stabilizers ``m``, ``xlstm.NEG``."""
    dev = resolve_device(device)
    cache: dict = {"pos": torch.zeros((), dtype=torch.int32, device=dev)}
    for run in layer_runs(cfg):
        lead = (run.count,) if run.count > 1 else ()
        cache[run.name] = {
            k: torch.full(lead + shape, xlstm_mod.NEG if k == "m" else 0,
                          dtype=dt, device=dev)
            for k, (shape, dt) in _cache_leaf_shapes(cfg, run, B,
                                                      max_len).items()}
    return cache


def _codebook_sum(cfg: ModelConfig, emb: torch.Tensor,
                  tokens: torch.Tensor) -> torch.Tensor:
    """The audio frontend's K codebook lookups, tokens (B, K, ...) ->
    (B, ..., d), summed onto zeros in the table's dtype in codebook order
    (each add rounded, as the reference's)."""
    x = emb.new_zeros(tokens.shape[:1] + tokens.shape[2:] + (cfg.d_model,))
    for kk in range(cfg.num_codebooks):
        x = x + emb[kk][tokens[:, kk].long()]
    return x


def _embed_inputs(cfg: ModelConfig, params: dict, batch: dict):
    """The batch's inputs -> (x (B, S, d), loss mask (1, S) bool or None).
    Tokens (B, S) are looked up times sqrt(d); ``vision_stub`` replaces
    the first ``num_image_tokens`` rows by ``batch["pixel_embeds"]`` and
    masks them (S below n gives n rows); ``audio_stub`` sums tokens (B, K,
    S)'s codebook rows and adds the sinusoid of positions 0..S-1."""
    tokens = batch["tokens"]
    if cfg.frontend == "audio_stub":
        x = _codebook_sum(cfg, params["embed"]["embedding"], tokens)
        pos = torch.arange(x.shape[1], device=x.device)
        return x + layers.sinusoidal_embed(pos, cfg.d_model)[None].to(
            x.dtype), None
    x = layers.embed(params["embed"], tokens, cfg.d_model)
    if cfg.frontend != "vision_stub":
        return x, None
    n = cfg.num_image_tokens
    x = torch.cat([batch["pixel_embeds"].to(x.dtype), x[:, n:]], dim=1)
    return x, (torch.arange(x.shape[1], device=x.device) >= n)[None, :]


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
    """x (B, S, d) -> fp32 logits (B, S, V); the audio frontend's (B, S,
    K, V), its product rounded to the model dtype first (the reference
    multiplies without an fp32 result type there)."""
    if cfg.frontend == "audio_stub":
        B, S, _ = x.shape
        logits = torch.matmul(x, params["head"]["w"]).float()
        return logits.reshape(B, S, cfg.num_codebooks, cfg.vocab_size)
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


def ring_rows(t: torch.Tensor, rows: int) -> torch.Tensor:
    """A sequence's k or v (B, S, Hkv, D) as a local-attention ring of
    ``rows`` slots: each of the last ``rows`` positions p at slot
    ``p % rows`` (a roll of the tail), zeros where no position reached."""
    S = t.shape[1]
    if S < rows:
        return cache_rows(t, rows)
    return torch.roll(t[:, S - rows:], shifts=S % rows, dims=1)


def block_attention_seq(cfg: ModelConfig, p: dict, x: torch.Tensor, *,
                        local: bool = False):
    """The attention half of an attention block over a whole sequence
    (``local``: the sliding window of ``cfg.local_window``): x (B, S, d)
    -> (x after attention and its residual, that x's norm2 (the FFN's
    input; None for a block without an FFN), k, v (B, S, Hkv, D) after
    rope)."""
    B, S, _ = x.shape
    positions = torch.arange(S, device=x.device)[None, :]
    h = layers.apply_norm(cfg, p["norm1"], x)
    q, k, v = layers.qkv_project(cfg, p["attn"], h)
    q = layers.rope(q, positions, cfg.rope_theta, cfg.rope_fraction)
    k = layers.rope(k, positions, cfg.rope_theta, cfg.rope_fraction)
    if local:
        o = layers.local_attention(q, k, v, cfg.local_window)
    else:
        o = layers.blockwise_attention(q, k, v, causal=True)
    x = x + o.reshape(B, S, -1) @ p["attn"]["w_o"]
    h2 = layers.apply_norm(cfg, p["norm2"], x) if "norm2" in p else None
    return x, h2, k, v


def _ffn_residual(cfg: ModelConfig, p: dict, x: torch.Tensor, h2=None):
    """The block's second half: x + FFN(norm2(x)) and the FFN's auxiliary
    loss (``h2``: norm2(x) when the caller has it); x itself and loss 0
    for a block without an FFN."""
    if "norm2" not in p:
        return x, torch.zeros((), dtype=torch.float32, device=x.device)
    if h2 is None:
        h2 = layers.apply_norm(cfg, p["norm2"], x)
    ff, aux = _apply_ffn(cfg, p, h2)
    return x + ff, aux


def block_apply_seq(cfg: ModelConfig, run: Run, p: dict, x: torch.Tensor,
                    *, want_cache: bool = False, max_len: int = 0):
    """One block of ``run``'s kind over a whole sequence: (B, S, d) ->
    (B, S, d), its auxiliary loss (0 for a dense FFN) and, with
    ``want_cache``, its cache leaves (else None): global attention's
    ``{"k", "v"}`` (B, max_len or S, Hkv, D), the sequence's rows first;
    local attention's ring of ``min(local_window, max_len or S)`` rows;
    MLA's ``{"latent", "rope"}`` (B, max_len or S, .), rows first;
    RG-LRU's ``{"h", "conv"}``; the mLSTM's ``{"C", "n", "m", "conv"}``
    and the sLSTM's ``{"c", "n", "m", "h", "conv"}``."""
    S = x.shape[1]
    cache, h2 = None, None
    if run.kind == MLA:
        positions = torch.arange(S, device=x.device)[None, :]
        out, (latent, k_rope) = mla_mod.attend_full(
            cfg, p["attn"], layers.apply_norm(cfg, p["norm1"], x), positions)
        x = x + out
        if want_cache:
            cache = {"latent": cache_rows(latent, max_len or S),
                     "rope": cache_rows(k_rope, max_len or S)}
    elif run.kind == RGLRU:
        y, (h_last, conv_tail) = rglru_mod.apply_train(
            cfg, p["rec"], layers.apply_norm(cfg, p["norm1"], x))
        x = x + y
        if want_cache:
            cache = {"h": h_last.clone(), "conv": conv_tail.clone()}
    elif run.kind in (MLSTM, SLSTM):
        mlstm = run.kind == MLSTM
        apply = (xlstm_mod.mlstm_apply_train if mlstm
                 else xlstm_mod.slstm_apply_train)
        y, (state, conv_tail) = apply(
            cfg, p["rec"], layers.apply_norm(cfg, p["norm1"], x))
        x = x + y
        if want_cache:
            names = ("C", "n", "m") if mlstm else ("c", "n", "m", "h")
            cache = dict(zip(names, state))
            cache["conv"] = conv_tail.clone()
    else:
        local = run.kind == LOCAL_ATTN
        x, h2, k, v = block_attention_seq(cfg, p, x, local=local)
        if want_cache:
            if local:
                rows = min(cfg.local_window, max_len or S)
                cache = {"k": ring_rows(k, rows), "v": ring_rows(v, rows)}
            else:
                cache = {"k": cache_rows(k, max_len or S),
                         "v": cache_rows(v, max_len or S)}
    x, aux = _ffn_residual(cfg, p, x, h2)
    return x, aux, cache


def forward(cfg: ModelConfig, params: dict, batch: dict, *,
            remat: bool = False):
    """Full-sequence forward -> (logits (B, S, V) fp32 (audio: (B, S, K,
    V)), aux loss, loss mask (vision: (1, S) bool) or None).  ``remat``
    recomputes each layer in the backward pass
    (``torch.utils.checkpoint``): only the per-layer block inputs are kept,
    as the reference's ``jax.checkpoint`` over the layer scan keeps its
    carry."""
    x, mask = _embed_inputs(cfg, params, batch)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for run, lp in layer_params(cfg, params):
        if remat:
            x, a, _ = checkpoint(block_apply_seq, cfg, run, lp, x,
                                 use_reentrant=False)
        else:
            x, a, _ = block_apply_seq(cfg, run, lp, x)
        aux = aux + a
    x = layers.apply_norm(cfg, params["final_norm"], x)
    return _head(cfg, params, x), aux, mask


def loss_fn(cfg: ModelConfig, params: dict, batch: dict, *,
            remat: bool = True):
    """Mean token cross entropy (z-loss 1e-4) plus 0.01 x the auxiliary
    loss -> (total, {"ce", "aux"}); audio labels (B, K, S) are held
    against the (B, S, K, V) logits, the mean over B S K."""
    logits, aux, mask = forward(cfg, params, batch, remat=remat)
    labels = batch["labels"]
    if cfg.frontend == "audio_stub":
        labels = labels.transpose(1, 2)
    loss = layers.cross_entropy(logits, labels, mask=mask)
    return loss + 0.01 * aux, {"ce": loss, "aux": aux}


# ---------------------------------------------------------------------------
# Hand-wired serve path: prefill and single-token decode
# ---------------------------------------------------------------------------
def block_apply_decode(cfg: ModelConfig, run: Run, p: dict, x: torch.Tensor,
                       cache: dict, pos):
    """One block for one new token a row: x (B, 1, d); ``pos`` the index
    of the token (an int or a 0-d tensor).  The layer's ``cache`` leaves
    are written in place: global attention's row ``pos`` (past the cache
    end the last row, as the reference's clamped update does), local
    attention's ring slot ``pos % W`` (it attends ``min(pos + 1, W)``
    rows), MLA's latent and rope rows ``pos`` (clamped likewise; the
    absorbed path), RG-LRU's and the xLSTM blocks' state and conv window.
    Returns (x_out, cache)."""
    B = x.shape[0]
    h = layers.apply_norm(cfg, p["norm1"], x)
    if run.kind == MLA:
        positions = torch.as_tensor(pos, device=x.device).reshape(1, 1) \
            .expand(B, 1)
        out, _lc, _rc = mla_mod.attend_absorbed(
            cfg, p["attn"], h, cache["latent"], cache["rope"], pos,
            positions)
        x = x + out
    elif run.kind == RGLRU:
        out, h_new, conv = rglru_mod.apply_decode(cfg, p["rec"], h,
                                                  cache["h"], cache["conv"])
        cache["h"].copy_(h_new)
        cache["conv"].copy_(conv)
        x = x + out
    elif run.kind in (MLSTM, SLSTM):
        if run.kind == MLSTM:
            names, apply = ("C", "n", "m"), xlstm_mod.mlstm_apply_decode
        else:
            names, apply = ("c", "n", "m", "h"), xlstm_mod.slstm_apply_decode
        out, state, conv = apply(cfg, p["rec"], h,
                                 tuple(cache[k] for k in names),
                                 cache["conv"])
        for k, t in zip(names, state):
            cache[k].copy_(t)
        cache["conv"].copy_(conv)
        x = x + out
    else:
        positions = torch.as_tensor(pos, device=x.device).reshape(1, 1) \
            .expand(B, 1)
        q, k, v = layers.qkv_project(cfg, p["attn"], h)
        q = layers.rope(q, positions, cfg.rope_theta, cfg.rope_fraction)
        k = layers.rope(k, positions, cfg.rope_theta, cfg.rope_fraction)
        kc, vc = cache["k"], cache["v"]
        at = positions[:1, 0].long()
        if run.kind == LOCAL_ATTN:
            W = kc.shape[1]
            row, cur = at % W, torch.clamp(positions[0, 0] + 1, max=W)
        else:
            row, cur = at.clamp(max=kc.shape[1] - 1), positions[0, 0] + 1
        kc.index_copy_(1, row, k.to(kc.dtype))
        vc.index_copy_(1, row, v.to(vc.dtype))
        o = layers.decode_attention(q, kc, vc, cur)
        x = x + o.reshape(B, 1, -1) @ p["attn"]["w_o"]
    return _ffn_residual(cfg, p, x)[0], cache


def prefill(cfg: ModelConfig, params: dict, batch: dict, max_len: int):
    """Whole prompts ``batch`` (``tokens`` (B, S), with the frontend's
    inputs) -> (cache, the last position's fp32 logits (B, V); audio (B,
    K, V)); the cache is ``init_cache``'s layout at ``max_len`` rows with
    ``pos`` = the embedded rows (S; n for an image prompt shorter than its
    n image rows): global attention's k/v first, local attention's ring,
    the recurrent blocks' last state and conv window."""
    x, _mask = _embed_inputs(cfg, params, batch)
    S = x.shape[1]
    per_run: dict = {}
    for run, lp in layer_params(cfg, params):
        x, _a, c = block_apply_seq(cfg, run, lp, x, want_cache=True,
                                   max_len=max_len)
        per_run.setdefault(run.name, []).append(c)
    cache: dict = {"pos": torch.tensor(S, dtype=torch.int32,
                                       device=x.device)}
    for run in layer_runs(cfg):
        cs = per_run[run.name]
        cache[run.name] = cs[0] if run.count == 1 else \
            {k: torch.stack([c[k] for c in cs]) for k in cs[0]}
    x = layers.apply_norm(cfg, params["final_norm"], x[:, -1:])
    return cache, _head(cfg, params, x)[:, 0]


def greedy_sample(cfg: ModelConfig, logits: torch.Tensor) -> torch.Tensor:
    """The greedy token of each row: (B, V) -> (B,) int32; audio (B, K,
    V) -> (B, K)."""
    return torch.argmax(logits, dim=-1).to(torch.int32)


def serve_step_greedy(cfg: ModelConfig, params: dict, cache: dict,
                      tokens_t: torch.Tensor):
    """``decode_step`` and the greedy token: ((B,) int32 (audio (B, K)),
    cache)."""
    logits, new_cache = decode_step(cfg, params, cache, tokens_t)
    return greedy_sample(cfg, logits), new_cache


def decode_step(cfg: ModelConfig, params: dict, cache: dict,
                tokens_t: torch.Tensor):
    """One decode step of every row at the cache's position ``pos`` (a 0-d
    int tensor): tokens_t (B,) -> (fp32 logits (B, V), cache with pos + 1);
    audio: codes (B, K) -> logits (B, K, V), the codes' summed rows plus
    the sinusoid of ``pos``.  Every cache leaf is written in place (the
    returned cache shares them)."""
    pos = cache["pos"]
    if cfg.frontend == "audio_stub":
        x = _codebook_sum(cfg, params["embed"]["embedding"],
                          tokens_t[:, :, None])
        x = x + layers.sinusoidal_embed(pos[None].float(), cfg.d_model)[
            None].to(x.dtype)
    else:
        x = layers.embed_onehot(params["embed"], tokens_t[:, None],
                                cfg.d_model)
    for (run, lp), (_run, lc) in zip(layer_params(cfg, params),
                                     layer_params(cfg, cache)):
        x, _ = block_apply_decode(cfg, run, lp, x, lc, pos)
    x = layers.apply_norm(cfg, params["final_norm"], x)
    new_cache = {"pos": pos + 1}
    new_cache.update({run.name: cache[run.name] for run in layer_runs(cfg)})
    return _head(cfg, params, x)[:, 0], new_cache
