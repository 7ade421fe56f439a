"""Batched serving engine: executed continuous batching with chunked prefill.

The port of the JAX package's ``serve/engine.py`` executed continuous path
(``ServeEngine(plan_fusion=True, scheduling="continuous")`` ->
``_run_continuous_chunked``).  Every slot keeps its own cache position
``(B,)`` and advances, finishes (EOS / token budget / cache-full) and is
refilled independently.  A waiting prompt is admitted in chunks of
``PrefillBudget.chunk_rows`` tokens: each iteration scatters one chunk's k/v
into its slot's cache rows, and its prefill attention rides the decode
step's fused launch — up to ``max_coresident_chunks`` compute-bound chunks
beside the memory-bound decode attention and FFN weight stream, the paper's
pairing as one kernel launch (``core/hfuse.py``).

The decode step is planned (``core/planner.py``) over the six-op graph of
``decode_graph`` and executed by the plan->program executor
(``core/executor.py``); the model glue (per-slot RoPE, the act-masked cache
scatter, W_o and W_out with their residuals) lives in the binding slots.
A stacked run (``count > 1``) runs the program once per layer in a Python
loop.  Two forms of the same path:

  * **paged KV** (``paged_kv=True``): k/v live in one block arena shared by
    the slots, each slot maps its pages through a block-table row
    (``serve/kv_pool.py``: refcounts, the radix prefix cache, LRU eviction,
    per-slot sentinel blocks), and both attention ops take the table as an
    operand.  A prompt that shares a cached prefix skips those chunks.
    Single-layer configs only, as in the reference;
  * **MoE** (a config with ``moe``): the FFN side of the graph is the fp32
    router product and the grouped expert FFN (``kernels/moe_gmm.py``), with
    the softmax / top-k / dispatch / combine glue in the binding slots and
    per-expert hit counts for the ``eload`` admission policy.

Differences from the reference, by design:
  * the KV cache (contiguous or arena) is updated IN PLACE (the reference
    rebuilds it functionally each step); ``_init_slot_cache`` owns it;
  * nothing is jitted: PyTorch runs eagerly (a CUDA graph of the step is
    later work);
  * sampling with ``temperature > 0`` draws from a ``torch.Generator``
    seeded by ``rng_seed``, so only greedy decoding matches the reference
    token for token.

Tensor parallelism, wavefront scheduling and the vmapped fallback decode
are not ported yet: asking for any of them raises with the reason.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.core import executor, planner, stitch
from repro_torch.core.binding import BindingRegistry, Slot
from repro_torch.device import resolve_device
from repro_torch.kernels import elementwise
from repro_torch.kernels.decode_attention import decode_attention_op
from repro_torch.kernels.matmul import matmul_1d_op
from repro_torch.kernels.moe_gmm import moe_gmm_op
from repro_torch.kernels.prefill_attention import prefill_attention_op
from repro_torch.kernels.rmsnorm import rmsnorm_op
from repro_torch.models import layers, lm, moe as moe_mod
from repro_torch.serve.kv_pool import KVPool


@dataclass
class Request:
    rid: int
    prompt: np.ndarray                 # (S,) int32
    max_new_tokens: int = 32
    temperature: float = 0.0
    eos_token: Optional[int] = None
    arrival: int = 0                   # engine step at which the request is
    #                                    visible to the slot manager
    out_tokens: list = field(default_factory=list)
    done: bool = False


@dataclass(frozen=True)
class PrefillBudget:
    """One iteration's prefill allowance.

    ``chunk_rows``: tokens of one prompt consumed per iteration (one
    prefill-attention chunk).  ``max_coresident_chunks``: how many chunks
    from different slots may ride one fused launch.  ``pad_to``: the row
    tile a prefill FFN operand pads to beyond one tile (``pad_rows``).
    ``policy``: which
    prefilling slots chunk first when more are ready than that —
    ``"fifo"`` (lowest slot index), ``"srpf"``
    (shortest-remaining-prefill-first, ties by slot index) or ``"eload"``
    (srpf ordering, but while the running per-expert hit skew
    ``ServeStats.expert_skew`` is at least ``skew_threshold`` the step sheds
    one coresident chunk; MoE only — without expert hits the skew stays 0
    and eload is srpf)."""
    chunk_rows: int = 2048
    max_coresident_chunks: int = 2
    pad_to: int = 128
    policy: str = "fifo"
    skew_threshold: float = 1.5

    def __post_init__(self):
        for f_ in ("chunk_rows", "max_coresident_chunks", "pad_to"):
            if getattr(self, f_) < 1:
                raise ValueError(f"PrefillBudget.{f_} must be >= 1")
        if self.policy not in ("fifo", "srpf", "eload"):
            raise ValueError(f"PrefillBudget.policy {self.policy!r} "
                             "(fifo, srpf or eload)")
        if self.skew_threshold < 1.0:
            raise ValueError("PrefillBudget.skew_threshold must be >= 1.0 "
                             "(1.0 means perfectly balanced experts)")

    def pad_rows(self, rows: int) -> int:
        """Rows of a prefill FFN operand: raw up to one tile, the next
        ``pad_to`` multiple beyond (zero-padded)."""
        return rows if rows <= self.pad_to else \
            -(-rows // self.pad_to) * self.pad_to

    def effective_chunk(self, cache_len: int, multiple: int = 1) -> int:
        """Chunk rows used against a ``cache_len`` cache: the largest
        divisor of cache_len that is <= min(chunk_rows, cache_len) and a
        multiple of ``multiple`` (the paged path's block size, so a chunk is
        whole pages; ``multiple`` itself when it exceeds chunk_rows), so
        chunk offsets stay multiples of the chunk and a full-chunk scatter
        never crosses the cache end."""
        if cache_len % multiple:
            raise ValueError(f"cache_len {cache_len} is not a multiple of "
                             f"the required alignment {multiple}")
        n = cache_len // multiple
        cap = max(min(self.chunk_rows, cache_len) // multiple, 1)
        best, i = 1, 1
        while i * i <= n:
            if n % i == 0:
                for d in (i, n // i):
                    if best < d <= cap:
                        best = d
            i += 1
        return best * multiple


@dataclass
class ServeStats:
    """Slot-manager trajectory of one continuous-batching ``run()``."""
    batch: int
    steps: int = 0                # engine iterations (incl. idle/prefill-only)
    decode_steps: int = 0         # iterations that decoded >= 1 active slot
    mixed_steps: int = 0          # decode iterations that also carried a
    #                               prefill chunk
    fused_mixed_steps: int = 0    # mixed iterations whose program fused a
    #                               prefill chunk with decode-side work
    prefill_only_steps: int = 0   # admissions with no active slot to decode
    slot_steps: int = 0           # sum of active slots over decode iterations
    tokens: int = 0
    prefill_chunks: int = 0       # chunk launches (chunked admission)
    fused_prefill_chunks: int = 0  # chunks whose program fused them with a
    #                                decode-side member
    admissions: list = field(default_factory=list)   # (step, rid, slot)
    retirements: list = field(default_factory=list)  # (step, rid, reason)
    admission_latencies: list = field(default_factory=list)  # steps from
    #                                  arrival to first token, per admission
    # paged-KV trajectory (serve/kv_pool.py; zero on the contiguous path)
    prompt_tokens: int = 0        # prompt tokens across admitted requests
    prefix_hits: int = 0          # admissions that matched a cached prefix
    prefix_tokens_reused: int = 0  # prompt tokens whose prefill was skipped
    blocks_in_use: int = 0        # peak arena blocks mapped or cached
    evictions: int = 0            # prefix-cache blocks evicted under pressure
    # MoE trajectory (empty / zero for dense configs)
    expert_hits: list = field(default_factory=list)  # per-expert routed
    #                               decode-token count, layer-summed
    load_shed_steps: int = 0      # steps where eload shed a coresident chunk

    @property
    def occupancy(self) -> float:
        """Mean fraction of slots decoding per decode iteration."""
        return self.slot_steps / max(self.batch * self.decode_steps, 1)

    @property
    def mixed_fraction(self) -> float:
        """Fraction of decode iterations that carried a prefill partner."""
        return self.mixed_steps / max(self.decode_steps, 1)

    @property
    def fused_prefill_fraction(self) -> float:
        """Fraction of prefill chunks that rode a fused launch with
        decode-side work."""
        return self.fused_prefill_chunks / max(self.prefill_chunks, 1)

    @property
    def mean_admission_latency(self) -> float:
        """Mean engine steps from request arrival to its first token."""
        lat = self.admission_latencies
        return sum(lat) / len(lat) if lat else 0.0

    @property
    def prefix_hit_rate(self) -> float:
        """Fraction of prompt tokens whose prefill the prefix cache
        skipped (paged KV only)."""
        return self.prefix_tokens_reused / max(self.prompt_tokens, 1)

    def add_expert_hits(self, counts) -> None:
        """Accumulate one step's per-expert decode-token counts (an (E,)
        sequence, summed over layers)."""
        counts = [int(c) for c in counts]
        if not self.expert_hits:
            self.expert_hits = [0] * len(counts)
        for i, c in enumerate(counts):
            self.expert_hits[i] += c

    @property
    def expert_skew(self) -> float:
        """Hottest expert's load relative to a balanced one:
        max(hits) * E / sum(hits); 0.0 until any hit lands."""
        total = sum(self.expert_hits)
        if not total:
            return 0.0
        return max(self.expert_hits) * len(self.expert_hits) / total

    def describe(self) -> dict:
        return {
            "steps": self.steps, "decode_steps": self.decode_steps,
            "mixed_steps": self.mixed_steps,
            "fused_mixed_steps": self.fused_mixed_steps,
            "prefill_only_steps": self.prefill_only_steps,
            "tokens": self.tokens,
            "prefill_chunks": self.prefill_chunks,
            "fused_prefill_chunks": self.fused_prefill_chunks,
            "occupancy": round(self.occupancy, 3),
            "mixed_fraction": round(self.mixed_fraction, 3),
            "fused_prefill_fraction": round(self.fused_prefill_fraction, 3),
            "mean_admission_latency": round(self.mean_admission_latency, 3),
            "prefix_hits": self.prefix_hits,
            "prefix_hit_rate": round(self.prefix_hit_rate, 3),
            "blocks_in_use": self.blocks_in_use,
            "evictions": self.evictions,
            "expert_hits": list(self.expert_hits),
            "expert_skew": round(self.expert_skew, 3),
            "load_shed_steps": self.load_shed_steps,
        }


def executable_decode_supported(cfg: ModelConfig) -> Optional[str]:
    """None when the planned decode program serves this config; otherwise
    the reason it cannot (the reference's fallback paths are not ported, so
    the port raises with it)."""
    return lm.supported(cfg)


def _ffn_in_width(cfg: ModelConfig) -> int:
    """Width of the decode step's FFN in-projection: gated activations fuse
    gate and up into one (d, 2f) weight."""
    return 2 * cfg.d_ff if cfg.activation in ("silu", "gelu") else cfg.d_ff


def _mlp_from_h(cfg: ModelConfig, h: torch.Tensor,
                w_out: torch.Tensor) -> torch.Tensor:
    """layers.mlp minus the in-projection (the chunk post-work)."""
    act = cfg.activation
    if act in ("silu", "gelu"):
        gate, up = torch.chunk(h, 2, dim=-1)
        g = F.silu(gate) if act == "silu" else F.gelu(gate,
                                                      approximate="tanh")
        h = g * up
    elif act == "gelu_mlp":
        h = F.gelu(h, approximate="tanh")
    elif act == "relu2_mlp":
        h = torch.square(torch.relu(h))
    else:
        raise ValueError(act)
    return h @ w_out


def _not_ported(what: str) -> NotImplementedError:
    return NotImplementedError(f"{what} is not ported yet (ROADMAP)")


class ServeEngine:
    """Continuous-batching server over the executed, planned decode step.

    ``device``: where the engine runs — the card unless ``"cpu"`` is
    passed; with no device and no CUDA present the constructor raises.
    ``params`` must already live there (``lm.init`` / ``params_from_numpy``
    with the same device); planning alone (``build_decode_program``) needs
    no params.  ``plain=True`` is the explicit opt-in that runs every
    planned member's plain PyTorch version instead of its CUDA kernel, to
    hold the kernels against them on the card.  ``measure`` and
    ``schedule_cache`` reach every decode plan (``planner.plan``).

    ``paged_kv=True`` serves from a block arena of ``kv_blocks`` blocks of
    ``kv_block_size`` rows (default: every slot's full capacity plus one
    sentinel block per slot), each slot mapping up to ``kv_slot_blocks``
    pages (default: ``max_len`` rounded up to 128); the pool and its prefix
    cache persist across ``run()`` calls."""

    def __init__(self, cfg: ModelConfig, params, *, batch: int = 8,
                 max_len: int = 512, rng_seed: int = 0,
                 plan_fusion: bool = True, measure=None,
                 schedule_cache=None, scheduling: str = "continuous",
                 prefill_budget: Optional[PrefillBudget] = None,
                 reject_overlong: bool = False,
                 stitch_epilogues: bool = True, paged_kv: bool = False,
                 kv_block_size: int = 16,
                 kv_slot_blocks: Optional[int] = None,
                 kv_blocks: Optional[int] = None,
                 mesh=None, device=None, plain: bool = False):
        if scheduling != "continuous":
            raise _not_ported(f"scheduling {scheduling!r} (the port serves "
                              "continuous batching)")
        if not plan_fusion:
            raise _not_ported("the hand-wired (vmapped) fallback decode")
        if mesh is not None:
            raise _not_ported("tensor-parallel serve (mesh=)")
        self.cfg = cfg
        self.batch = batch
        self.max_len = max_len
        self.paged_kv = paged_kv
        self.kv_pool = None
        if paged_kv:
            # the reference's refusals, with its texts
            reason = executable_decode_supported(cfg)
            if reason is None and lm.layer_runs(cfg)[0].count > 1:
                reason = ("the paged arena is single-layer — stacked runs "
                          "serve from the contiguous cache")
            if reason is None and cfg.is_moe:
                reason = ("MoE decode serves from the contiguous cache "
                          "(the paged+MoE combination is untested)")
            if reason is not None:
                raise ValueError(f"paged_kv: config not executor-supported "
                                 f"({reason}) — the vmapped fallback has no "
                                 "paged cache")
            if kv_block_size < 1 or 128 % kv_block_size:
                raise ValueError(f"kv_block_size {kv_block_size} must divide "
                                 "128 (cache lengths and kv chunks are "
                                 "128-aligned)")
            self.kv_block_size = kv_block_size
            if kv_slot_blocks is None:
                kv_slot_blocks = self._aligned_len() // kv_block_size
            if (kv_slot_blocks * kv_block_size) % 128:
                raise ValueError("kv_slot_blocks * kv_block_size = "
                                 f"{kv_slot_blocks * kv_block_size} must be "
                                 "a multiple of 128")
            self.kv_slot_blocks = kv_slot_blocks
            if kv_blocks is None:
                kv_blocks = batch * kv_slot_blocks + batch
            self.kv_blocks = kv_blocks
            self.kv_pool = KVPool(num_blocks=kv_blocks,
                                  block_size=kv_block_size, slots=batch,
                                  max_blocks_per_slot=kv_slot_blocks)
        self._arena = None          # paged k/v, kept as long as the pool
        reason = executable_decode_supported(cfg)
        if reason is not None:
            raise NotImplementedError(f"{cfg.name}: the executed decode step "
                                      f"does not serve it: {reason}")
        self.device = resolve_device(device)
        self.params = params
        self.stitch_epilogues = stitch_epilogues
        self.prefill_budget = prefill_budget or PrefillBudget()
        self.reject_overlong = reject_overlong
        self.plain = plain
        self.dtype = lm.torch_dtype(cfg.dtype)
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(rng_seed)
        self._cb_steps: dict[int, object] = {}       # n chunks -> step fn
        self._cb_fused_chunks: dict[int, frozenset] = {}
        self.cb_program_info: dict[int, dict] = {}   # n chunks -> launch table
        self.stats = ServeStats(batch=batch)
        self._measure = measure
        self._schedule_cache = schedule_cache
        self.fusion_plan = self.plan_decode_fusion(measure=measure,
                                                   cache=schedule_cache)

    # ------------------------------------------------------------------
    def _aligned_len(self) -> int:
        return max(128, -(-self.max_len // 128) * 128)

    @property
    def cache_len(self) -> int:
        """Rows of cache a slot can hold, the admission and retirement
        limit: ``max_len`` rounded up to 128, or with paged KV the slot's
        table span ``kv_slot_blocks * kv_block_size`` (which may exceed
        ``max_len``)."""
        if self.paged_kv:
            return self.kv_slot_blocks * self.kv_block_size
        return self._aligned_len()

    def _chunk(self, budget: PrefillBudget) -> int:
        """Rows of one prefill chunk (paged: a whole number of pages)."""
        return budget.effective_chunk(
            self.cache_len,
            multiple=self.kv_block_size if self.paged_kv else 1)

    @property
    def chunk_rows(self) -> int:
        return self._chunk(self.prefill_budget)

    def decode_graph(self, *, budget: Optional[PrefillBudget] = None,
                     prefill_chunks: int = 0):
        """The serving step as a planner graph with stable operand
        signatures: decode_norm1 -> qkv_proj -> decode attention (per-slot
        valid prefixes in a (B, 1) int32 operand) -> decode_norm2 -> the FFN
        side, with the epilogue declaration norm1 -> qkv unless
        ``stitch_epilogues=False``; plus ``prefill_chunks`` independent
        prefill-attention ops.  Dense FFN side: ffn_proj -> decode_act
        (stitched likewise).  MoE: moe_router (fp32, B x d @ d x E) ->
        moe_gmm at capacity(cfg, B).  Paged: both attention ops take the
        block table and the arena, and a chunk is whole pages."""
        budget = budget or self.prefill_budget
        cfg = self.cfg
        d, H, Hkv = cfg.d_model, cfg.num_heads, cfg.num_kv_heads
        D = cfg.resolved_head_dim
        dt = self.dtype
        S, B = self.cache_len, self.batch
        bt = (self.kv_blocks, self.kv_block_size) if self.paged_kv else None

        norm1 = dataclasses.replace(rmsnorm_op(R=B, d=d, dtype=dt, bm=B),
                                    name="decode_norm1")
        norm2 = dataclasses.replace(rmsnorm_op(R=B, d=d, dtype=dt, bm=B),
                                    name="decode_norm2")
        # largest 128-multiple kv chunk <= 1024 dividing S (planning only:
        # the CUDA members compute the same function for any chunk; a
        # block size divides 128, so a paged chunk is whole pages)
        ck = next(c for c in range(min(1024, S), 0, -128) if S % c == 0)
        att = decode_attention_op(B=B, S=S, H=H, Hkv=Hkv, D=D, dtype=dt,
                                  ck=ck, dynamic_length=True, block_table=bt)
        qkv = dataclasses.replace(
            matmul_1d_op(M=B, K=d, N=(H + 2 * Hkv) * D, dtype=dt, bm=B),
            name="qkv_proj")
        if self.stitch_epilogues:
            norm1 = dataclasses.replace(norm1, epilogue=(qkv.name, "x"))
        if cfg.moe is not None:
            # the router's logits stay fp32 (its own matmul op) so softmax
            # and top-k see what the reference computes; capacity is static
            # per program
            m = cfg.moe
            proj = dataclasses.replace(
                matmul_1d_op(M=B, K=d, N=m.num_experts, dtype=torch.float32,
                             bm=B),
                name="moe_router")
            gated = cfg.activation in ("silu", "gelu")
            tail = moe_gmm_op(E=m.num_experts, C=moe_mod.capacity(cfg, B),
                              d=d, f=m.d_ff_expert, dtype=dt,
                              act=cfg.activation if gated else "gelu",
                              gated=gated)
        else:
            ffn_in, ffn_out = _ffn_in_width(cfg), cfg.d_ff
            proj = dataclasses.replace(
                matmul_1d_op(M=B, K=d, N=ffn_in, dtype=dt, bm=B),
                name="ffn_proj")
            act_fn = {"silu": elementwise.silu_gate,
                      "gelu": elementwise.gelu_gate,
                      "gelu_mlp": elementwise.gelu_plain,
                      "relu2_mlp": elementwise.relu2}[cfg.activation]
            tail = elementwise.activation_op(R=B, F_in=ffn_in, F_out=ffn_out,
                                             fn=act_fn, dtype=dt, bm=B,
                                             name="decode_act")
            if self.stitch_epilogues:
                proj = dataclasses.replace(proj, epilogue=(tail.name, "h"))
        graph = [planner.GraphOp(norm1),
                 planner.GraphOp(qkv, deps=frozenset({norm1.name})),
                 planner.GraphOp(att, deps=frozenset({qkv.name})),
                 planner.GraphOp(norm2, deps=frozenset({att.name})),
                 planner.GraphOp(proj, deps=frozenset({norm2.name})),
                 planner.GraphOp(tail, deps=frozenset({proj.name}))]
        if prefill_chunks:
            C = self._chunk(budget)
            sfx = f"_pg{self.kv_block_size}" if self.paged_kv else ""
            for i in range(prefill_chunks):
                graph.append(planner.GraphOp(prefill_attention_op(
                    C, S, H, Hkv, D, dtype=dt, ck=ck, block_table=bt,
                    name=f"prefill_attn{i}_C{C}_S{S}_H{H}kv{Hkv}{sfx}")))
        return graph

    def plan_decode_fusion(self, *, max_ways: Optional[int] = None,
                           budget: Optional[PrefillBudget] = None,
                           measure=None, cache=None):
        """Plan the steady mixed iteration (the budget's full chunk
        complement) — the plan shown at engine start.  With ``measure`` the
        schedules are profiled; ``cache`` makes a later start search
        nothing."""
        budget = budget or self.prefill_budget
        n = budget.max_coresident_chunks
        if max_ways is None:
            max_ways = 2 + n
        return planner.plan(self.decode_graph(budget=budget, prefill_chunks=n),
                            max_ways=max_ways, measure=measure, cache=cache)

    # ------------------------------------------------------------------
    # Executed decode step: plan -> program -> live slot state
    # ------------------------------------------------------------------
    def build_decode_program(self, *, prefill_chunks: int = 0):
        """Compile the planned decode step into an executor Program bound
        to one layer's slot state.  The norm's output slot projects QKV,
        applies RoPE at each slot's own position and scatters k/v into
        each decoding slot's cache row, in place (paged: at arena block
        ``bt[b, pos // bs]``, row ``pos % bs``); the attention output slot
        applies W_o and the residual; the FFN side's output slot applies
        W_out (MoE: the combine and the shared experts) and the second
        residual.  Each prefill chunk ``i`` reads its own slot's cache rows
        (paged: the arena through its table row) at its own offset
        (``pf{i}_slot``, ``pf{i}_off``); the step scatters the chunk's k/v
        before the program runs."""
        cfg = self.cfg
        H, Hkv = cfg.num_heads, cfg.num_kv_heads
        D = cfg.resolved_head_dim
        dt = self.dtype
        B = self.batch
        paged = self.paged_kv
        bs = self.kv_block_size if paged else 0

        graph = self.decode_graph(prefill_chunks=prefill_chunks)
        plan = planner.plan(graph, max_ways=max(3, 2 + prefill_chunks),
                            allow_same_bound=True, measure=self._measure,
                            cache=self._schedule_cache)

        def qkv_put(state, qkv):
            qkv = qkv.to(dt)[:, None, :]                        # (B, 1, N)
            q = qkv[..., :H * D].reshape(B, 1, H, D)
            k = qkv[..., H * D:(H + Hkv) * D].reshape(B, 1, Hkv, D)
            v = qkv[..., (H + Hkv) * D:].reshape(B, 1, Hkv, D)
            pos = state["pos"]
            q = layers.rope(q, pos.reshape(B, 1), cfg.rope_theta,
                            cfg.rope_fraction)
            k = layers.rope(k, pos.reshape(B, 1), cfg.rope_theta,
                            cfg.rope_fraction)
            state = dict(state)
            state["q"] = q[:, 0].contiguous()
            # act-masked in-place scatter: only decoding slots land k/v (a
            # prefilling slot's row at `pos` is live chunk data this step).
            # An idle slot's position may sit at the cache end, so its
            # (discarded) read is clamped into range, as the reference's
            # gather clamps.  Paged: an idle slot's table row holds its own
            # sentinel block, and a decoding slot's block is private, so no
            # two slots write different values to one row.
            rows = torch.arange(B, device=pos.device)
            p_ = pos.long()
            if paged:
                page = (p_ // bs).clamp(max=state["bt"].shape[1] - 1)
                rows, cols = state["bt"][rows, page].long(), p_ % bs
            else:
                cols = p_.clamp(max=state["k_cache"].shape[1] - 1)
            act = state["act"][:, None, None]
            kc, vc = state["k_cache"], state["v_cache"]
            kc[rows, cols] = torch.where(act, k[:, 0], kc[rows, cols])
            vc[rows, cols] = torch.where(act, v[:, 0], vc[rows, cols])
            return state

        def att_put(state, o):
            attn_out = o.to(dt).reshape(B, H * D) @ state["w_o"]
            state = dict(state)
            state["h_mid"] = state["x"] + attn_out               # residual 1
            return state

        def act_put(state, h_act):
            ff = h_act.to(dt) @ state["w_out"]
            state = dict(state)
            state["x_out"] = state["h_mid"] + ff                 # residual 2
            return state

        def router_put(state, logits):
            # logits (B, E) fp32 straight off the planned product: the
            # capacity dispatch and the per-expert hit counts of decoding
            # slots only (idle, prefilling and empty rows count 0)
            r = moe_mod.route_from_logits(cfg, logits)
            state = dict(state)
            state["moe_route"] = r
            state["moe_xe"] = moe_mod.dispatch(r, state["h2"])   # (E, C, d)
            act_pad = torch.cat([state["act"].to(torch.int32),
                                 state["act"].new_zeros(1, dtype=torch.int32)])
            state["expert_counts"] = act_pad[r.dispatch_idx.long()].sum(dim=1)
            return state

        def gmm_put(state, ye):
            # combine (a gather, in expert-major order), the shared experts
            # on the same normed hidden, residual 2
            out = moe_mod.combine(state["moe_route"], ye)
            if cfg.moe.num_shared_experts:
                out = out + moe_mod.shared_ffn(cfg, state, state["h2"])
            state = dict(state)
            state["x_out"] = state["h_mid"] + out.to(dt)
            return state

        # bindings follow the CONTRACTED graph: a stitched chain binds once
        # under its chain name; an unstitched pair routes its intermediate
        # through a named state key
        plan_names = {g.op.name for g in plan.graph}
        reg = BindingRegistry()
        chain1 = stitch.chain_label("decode_norm1", "qkv_proj")
        if chain1 in plan_names:
            reg.bind(chain1, x="x", scale="norm1_scale", w="w_qkv",
                     outputs={"out": Slot(put=qkv_put)})
        else:
            reg.bind("decode_norm1", x="x", scale="norm1_scale",
                     outputs={"out": "x_normed"})
            reg.bind("qkv_proj", x="x_normed", w="w_qkv",
                     outputs={"out": Slot(put=qkv_put)})
        att_name = next(g.op.name for g in graph
                        if g.op.name.startswith("decode_attn"))
        reg.bind(att_name, q="q", k="k_cache", v="v_cache",
                 inputs={"len": "len", **({"bt": "bt"} if paged else {})},
                 outputs={"o": Slot(put=att_put), "m": "attn_m",
                          "l": "attn_l"})
        reg.bind("decode_norm2", x="h_mid", scale="norm2_scale",
                 outputs={"out": "h2"})
        gmm_name = next((g.op.name for g in graph
                         if g.op.name.startswith("moe_gmm")), None)
        if gmm_name is not None:
            # the router reads h2 widened to fp32, as the reference does
            reg.bind("moe_router",
                     inputs={"x": Slot(get=lambda s: s["h2"].float()),
                             "w": "w_router"},
                     outputs={"out": Slot(put=router_put)})
            reg.bind(gmm_name, xe="moe_xe", w_in="w_in", w_out="w_out",
                     outputs={"ye": Slot(put=gmm_put)})
        else:
            chain2 = stitch.chain_label("ffn_proj", "decode_act")
            if chain2 in plan_names:
                reg.bind(chain2, x="h2", w="w_in",
                         outputs={"out": Slot(put=act_put)})
            else:
                reg.bind("ffn_proj", x="h2", w="w_in",
                         outputs={"out": "h_ffn"})
                reg.bind("decode_act", h="h_ffn",
                         outputs={"out": Slot(put=act_put)})
        for g in graph:
            if not g.op.name.startswith("prefill_attn"):
                continue
            i = int(g.op.name.split("_")[1][4:])      # prefill_attn{i}_...
            if paged:
                # the whole arena, and the chunk's slot's table row (a
                # copy: the kernel takes 16-byte aligned operands)
                pf_in = {"off": f"pf{i}_off", "q": f"pf{i}_q",
                         "k": "k_cache", "v": "v_cache",
                         "bt": Slot(get=lambda s, i=i:
                                    s["bt"][s[f"pf{i}_slot"]][None].clone())}
            else:
                pf_in = {"off": f"pf{i}_off", "q": f"pf{i}_q",
                         "k": Slot(get=lambda s, i=i:
                                   s["k_cache"][s[f"pf{i}_slot"]]),
                         "v": Slot(get=lambda s, i=i:
                                   s["v_cache"][s[f"pf{i}_slot"]])}
            reg.bind(g.op.name, inputs=pf_in,
                     outputs={"o": f"pf{i}_o", "m": f"pf{i}_m",
                              "l": f"pf{i}_l"})
        return executor.compile_plan(plan, bindings=reg, plain=self.plain)

    def _layer_state(self, p, kv, x, pos, act) -> dict:
        """State of ONE layer of the executed program: ``p`` the layer's
        block params, ``kv`` its ``{"k", "v"}`` cache views (or the arena),
        ``pos`` the per-slot position vector (B,), ``act`` the per-slot
        decoding mask (B,) bool gating the decode k/v scatter."""
        state = {
            "x": x, "pos": pos, "act": act,
            "len": (pos + 1).reshape(-1, 1).to(torch.int32),
            "norm1_scale": p["norm1"]["scale"].reshape(1, -1),
            "norm2_scale": p["norm2"]["scale"].reshape(1, -1),
            "w_qkv": p["attn"]["w_qkv"], "w_o": p["attn"]["w_o"],
            "k_cache": kv["k"], "v_cache": kv["v"],
        }
        if "moe" in p:
            # expert-major leaves: the router and the grouped FFN's (E, d,
            # fin) / (E, f, d) stacks, plus the shared experts
            mp = p["moe"]
            state["w_router"] = mp["router"]
            state["w_in"], state["w_out"] = mp["w_in"], mp["w_out"]
            if self.cfg.moe.num_shared_experts:
                state["shared_w_in"] = mp["shared_w_in"]
                state["shared_w_out"] = mp["shared_w_out"]
        else:
            state["w_in"] = p["mlp"]["w_in"]
            state["w_out"] = p["mlp"]["w_out"]
        return state

    # ------------------------------------------------------------------
    # Continuous batching
    # ------------------------------------------------------------------
    def _init_slot_cache(self) -> dict:
        """``lm.init_cache`` with the scalar position replaced by the
        per-slot position vector (B,).  Paged: the k/v leaves are the flat
        ``(kv_blocks, kv_block_size, Hkv, D)`` arena the tables index, made
        once and kept across ``run()`` calls, because the pool's prefix
        cache, which persists, indexes its blocks.  (The reference makes a
        zero arena every run, so a prefix hit from an earlier run reads
        zeros there: ROADMAP §3.)  The step updates it in place."""
        if self.paged_kv:
            if self._arena is None:
                run = lm.layer_runs(self.cfg)[0]
                shape = (self.kv_blocks, self.kv_block_size,
                         self.cfg.num_kv_heads, self.cfg.resolved_head_dim)
                self._arena = {run.name: {
                    k: torch.zeros(shape, dtype=self.dtype,
                                   device=self.device)
                    for k in ("k", "v")}}
            cache = dict(self._arena)
        else:
            cache = lm.init_cache(self.cfg, self.batch, self.cache_len,
                                  device=self.device)
        cache["pos"] = torch.zeros(self.batch, dtype=torch.int32,
                                   device=self.device)
        return cache

    def _make_cb_step(self, n_chunks: int):
        """The executed continuous step: decode every slot at its own cache
        position while ``n_chunks`` prompt chunks from prefilling slots
        ride along.  Per layer: each chunk's norm/QKV/RoPE and its k/v
        scatter into its slot's cache rows (paged: page by page into the
        arena blocks of its table row), then the planned program (the
        chunks' prefill attention shares the decode launches), then each
        chunk's W_o, FFN (MoE: ``moe.apply`` over the chunk's rows) and
        residuals.  The final chunk row's hidden yields the request's
        first-token logits.

        ``step(params, cache, tokens, active, bt=None, ch_slots, ch_offs,
        ch_valid, ch_tokens)`` -> ``(logits, cache[, pf_logits][,
        expert_counts])``: ``cache`` is updated in place; ``bt`` is the
        (B, kv_slot_blocks) int32 table on the device (paged);
        ``ch_slots``/``ch_offs``/``ch_valid`` are host ints, ``ch_tokens``
        an (n, C) int tensor; MoE returns the layer-summed (E,) counts of
        decoding slots' routed tokens last."""
        cfg = self.cfg
        d = cfg.d_model
        run = lm.layer_runs(cfg)[0]
        dt = self.dtype
        n = n_chunks
        H, Hkv = cfg.num_heads, cfg.num_kv_heads
        D = cfg.resolved_head_dim
        C = self.chunk_rows
        paged = self.paged_kv
        bs = self.kv_block_size if paged else 0
        is_moe = cfg.moe is not None
        program = self.build_decode_program(prefill_chunks=n)
        # a chunk counts as fused when it shares a launch with any
        # decode-side member (decode attention or the FFN side)
        self._cb_fused_chunks[n] = frozenset(
            i for i in range(n)
            if any(any(m.startswith(f"prefill_attn{i}_") for m in ms)
                   and any(not m.startswith("prefill_attn") for m in ms)
                   for ms in program.fused_members))
        self.cb_program_info[n] = {
            "fused_launches": program.n_fused,
            "total_launches": len(program.steps),
            "fused_members": [sorted(ms) for ms in program.fused_members],
            "steps": program.describe(),
        }

        def layer_step(p, kv, x, pos, act, bt, chs, ch_slots, ch_offs):
            state = self._layer_state(p, kv, x, pos, act)
            if paged:
                state["bt"] = bt
            kc, vc = kv["k"], kv["v"]
            for i in range(n):
                hp = layers.apply_norm(cfg, p["norm1"], chs[i][None])
                qkv = hp @ p["attn"]["w_qkv"]
                qp = qkv[..., :H * D].reshape(1, C, H, D)
                kp = qkv[..., H * D:(H + Hkv) * D].reshape(1, C, Hkv, D)
                vp = qkv[..., (H + Hkv) * D:].reshape(1, C, Hkv, D)
                positions = ch_offs[i] + torch.arange(
                    C, device=x.device)[None, :]
                qp = layers.rope(qp, positions, cfg.rope_theta,
                                 cfg.rope_fraction)
                kp = layers.rope(kp, positions, cfg.rope_theta,
                                 cfg.rope_fraction)
                b, off = ch_slots[i], ch_offs[i]
                if paged:
                    # chunk offsets are chunk-aligned (admission floors
                    # prefix reuse to whole chunks), so the chunk covers
                    # C // bs whole pages of the slot's own blocks
                    blks = bt[b, off // bs:off // bs + C // bs].long()
                    kc[blks] = kp[0].reshape(-1, bs, Hkv, D).to(kc.dtype)
                    vc[blks] = vp[0].reshape(-1, bs, Hkv, D).to(vc.dtype)
                else:
                    kc[b, off:off + C] = kp[0].to(kc.dtype)
                    vc[b, off:off + C] = vp[0].to(vc.dtype)
                state[f"pf{i}_q"] = qp[0].to(dt).contiguous()
                state[f"pf{i}_slot"] = b
                state[f"pf{i}_off"] = torch.full((1, 1), off,
                                                 dtype=torch.int32,
                                                 device=x.device)
            state = program(state)
            new_chs = []
            for i in range(n):
                o = state[f"pf{i}_o"].to(dt)                 # (C, H, D)
                xm = chs[i] + o.reshape(C, -1) @ p["attn"]["w_o"]
                h2 = layers.apply_norm(cfg, p["norm2"], xm[None])
                if is_moe:
                    # the chunk's rows route jointly (T = C), as the
                    # reference's lm._apply_ffn does
                    ff = lm._apply_ffn(cfg, p, h2)[0][0]
                else:
                    ff = _mlp_from_h(cfg, h2[0] @ p["mlp"]["w_in"],
                                     p["mlp"]["w_out"])
                new_chs.append(xm + ff)
            return state["x_out"], new_chs, state.get("expert_counts")

        def step(params, cache, tokens, active, bt=None, ch_slots=(),
                 ch_offs=(), ch_valid=(), ch_tokens=None):
            x = layers.embed_onehot(params["embed"], tokens, d)   # (B, d)
            chs = [lm._embed_inputs(cfg, params, ch_tokens[i][None])[0]
                   for i in range(n)]
            pos = cache["pos"]
            kv = cache[run.name]
            counts = None
            for li, p_l in enumerate(lm.layer_params(cfg, params)):
                kv_l = ({"k": kv["k"][li], "v": kv["v"][li]}
                        if run.count > 1 else kv)
                x, chs, c_l = layer_step(p_l, kv_l, x, pos, active, bt, chs,
                                         ch_slots, ch_offs)
                if is_moe:
                    counts = c_l if counts is None else counts + c_l
            xf = layers.apply_norm(cfg, params["final_norm"],
                                   x[:, None, :].to(dt))
            logits = lm._head(cfg, params, xf)[:, 0]
            new_pos = torch.where(active, pos + 1, pos)
            for i in range(n):
                new_pos[ch_slots[i]] = ch_offs[i] + ch_valid[i]
            cache["pos"] = new_pos
            moe_tail = (counts,) if is_moe else ()
            if not n:
                return (logits, cache) + moe_tail
            pf_logits = []
            for i in range(n):
                xlast = chs[i][ch_valid[i] - 1:ch_valid[i]]         # (1, d)
                xfp = layers.apply_norm(cfg, params["final_norm"],
                                        xlast[None])
                pf_logits.append(lm._head(cfg, params, xfp)[0, 0])
            return (logits, cache, torch.stack(pf_logits)) + moe_tail

        return step

    def _cb_step(self, n_chunks: int):
        if n_chunks not in self._cb_steps:
            self._cb_steps[n_chunks] = self._make_cb_step(n_chunks)
        return self._cb_steps[n_chunks]

    # ------------------------------------------------------------------
    def _sample(self, logits: torch.Tensor, greedy: int,
                req: Request) -> int:
        if req.temperature > 0:
            probs = torch.softmax(logits.float() / req.temperature, dim=-1)
            return int(torch.multinomial(probs, 1,
                                         generator=self.generator))
        return greedy

    def run(self, requests: list[Request]) -> list[Request]:
        for r in requests:
            if len(r.prompt) > self.cache_len:
                raise ValueError(
                    f"request {r.rid}: prompt length {len(r.prompt)} exceeds "
                    f"max_seq_len {self.cache_len} — continuous batching "
                    "cannot admit it (raise max_len"
                    + (" or kv_slot_blocks" if self.paged_kv else "")
                    + " or truncate the prompt)")
            if self.reject_overlong and len(r.prompt) > self.chunk_rows:
                raise ValueError(
                    f"request {r.rid}: prompt length {len(r.prompt)} exceeds "
                    f"the per-iteration prefill budget {self.chunk_rows} and "
                    "this engine was built with reject_overlong=True (drop "
                    "the flag to admit it in chunks)")
        self.stats = ServeStats(batch=self.batch)
        # FIFO by arrival step, submission order breaking ties
        waiting = sorted(requests, key=lambda r: r.arrival)
        return self._run_continuous_chunked(requests, waiting)

    # ------------------------------------------------------------------
    def _retire_reason(self, req: Request, tok: int, n_out: int, pos: int, *,
                       check_eos: bool = True) -> Optional[str]:
        if check_eos and req.eos_token is not None and tok == req.eos_token:
            return "eos"
        if n_out >= req.max_new_tokens:
            return "max_new"
        if pos >= self.cache_len:
            return "max_len"                 # cache full: truncate
        return None

    def _will_retire_this_step(self, req: Request, pos_now: int) -> bool:
        """A decode step always lands one token and advances the position by
        one; EOS is data-dependent and deliberately excluded."""
        return self._retire_reason(req, -1, len(req.out_tokens) + 1,
                                   pos_now + 1, check_eos=False) is not None

    def _admit(self, req: Request, slot: int, pf_logits, greedy: int,
               slots, pos_h, last):
        """First token from the prompt's last-position logits; the slot goes
        active unless the request already retires.  EOS is not checked on
        the first token (the reference's wavefront oracle contract)."""
        stats = self.stats
        tok = self._sample(pf_logits, greedy, req)
        req.out_tokens.append(tok)
        stats.tokens += 1
        stats.admissions.append((stats.steps - 1, req.rid, slot))
        stats.admission_latencies.append(stats.steps - 1 - req.arrival)
        pos_h[slot] = len(req.prompt)
        reason = self._retire_reason(req, tok, len(req.out_tokens),
                                     pos_h[slot], check_eos=False)
        if reason:
            req.done = True
            stats.retirements.append((stats.steps - 1, req.rid, reason))
        else:
            if slots[slot] is not None:
                raise RuntimeError(f"slot {slot} refilled while request "
                                   f"{slots[slot].rid} lives")
            slots[slot] = req
            last[slot] = tok

    def _run_continuous_chunked(self, requests, waiting) -> list[Request]:
        """Executed continuous batching with chunk-granular admission (the
        reference's slot manager, step for step): every step decodes all
        active slots while up to ``max_coresident_chunks`` prefilling slots
        each consume one prompt chunk inside the same fused launches.  A
        freshly emptied slot's first chunk rides the step it is claimed; a
        slot whose occupant retires deterministically this step is reserved
        and starts chunking the next step.  Paged: admission maps pages
        through the pool, a prefix-cache hit skips whole chunks, a chunk
        the arena cannot back stalls, a decoding slot it cannot extend
        retires ``pool_full``, and a completed prompt registers its blocks
        for later prompts."""
        B = self.batch
        dev = self.device
        stats = self.stats
        budget = self.prefill_budget
        pool = self.kv_pool
        paged = pool is not None
        is_moe = self.cfg.moe is not None
        C = self.chunk_rows
        if paged:
            # the pool persists across runs (the prefix cache survives);
            # this run's stats report the deltas
            pool_base = (pool.evictions, pool.prefix_hits,
                         pool.prefix_tokens_reused)
        slots: list[Optional[Request]] = [None] * B   # decoding occupants
        pref: dict[int, dict] = {}                    # slot -> prefilling
        pos_h = [0] * B                               # host mirror of pos
        last = np.zeros(B, np.int32)
        cache = self._init_slot_cache()

        def claim(b, req, now):
            ent = {"req": req, "done": 0, "ready": now}
            if paged:
                ent["done"] = pool.admit(b, req.prompt, C, now)
                stats.prompt_tokens += len(req.prompt)
            pref[b] = ent

        while waiting or any(s is not None for s in slots) or pref:
            step_i = stats.steps
            arrived = [r for r in waiting if r.arrival <= step_i]
            reserved = []
            for b in range(B):
                if not arrived:
                    break
                if slots[b] is None and b not in pref:
                    req = arrived.pop(0)
                    waiting.remove(req)
                    claim(b, req, step_i)
            for b in range(B):
                if not arrived:
                    break
                if slots[b] is not None and self._will_retire_this_step(
                        slots[b], pos_h[b]):
                    req = arrived.pop(0)
                    waiting.remove(req)
                    reserved.append((b, req))
            sel = [b for b in sorted(pref) if pref[b]["ready"] <= step_i]
            if budget.policy in ("srpf", "eload"):
                sel.sort(key=lambda b: (len(pref[b]["req"].prompt)
                                        - pref[b]["done"], b))
            sel = sel[:budget.max_coresident_chunks]
            # eload: while a few hot experts dominate the decode side's
            # weight stream, shed one coresident chunk
            if (budget.policy == "eload" and len(sel) > 1
                    and stats.expert_skew >= budget.skew_threshold):
                sel = sel[:-1]
                stats.load_shed_steps += 1
            if paged:
                # map each chunk's pages before its scatter; a chunk the
                # arena cannot back this step (even after eviction) stalls
                sel = [b for b in sel
                       if pool.ensure_rows(b, pref[b]["done"],
                                           pref[b]["done"] + C, step_i)]
                # each decoding slot writes one row this step; a slot the
                # pool cannot extend retires truncated
                for b in range(B):
                    if slots[b] is None:
                        continue
                    if not pool.ensure_rows(b, pos_h[b], pos_h[b] + 1,
                                            step_i):
                        req = slots[b]
                        req.done = True
                        slots[b] = None
                        pool.release(b)
                        stats.retirements.append((step_i, req.rid,
                                                  "pool_full"))
            active = np.array([s is not None for s in slots])
            n_active = int(active.sum())
            n = len(sel)

            if n == 0 and n_active == 0:
                ready = [b for b in pref if pref[b]["ready"] <= step_i]
                if paged and ready:
                    # arena deadlock: every schedulable chunk stalled with
                    # no decoder left to free blocks — fail the prompt with
                    # the most work left so its blocks free the others
                    b = max(ready, key=lambda b: (len(pref[b]["req"].prompt)
                                                  - pref[b]["done"], b))
                    req = pref.pop(b)["req"]
                    req.done = True
                    pool.release(b)
                    stats.retirements.append((step_i, req.rid, "pool_full"))
                stats.steps += 1                 # idle: future arrivals
                continue
            kw = {}
            if paged:
                kw["bt"] = torch.tensor(pool.table, dtype=torch.int32,
                                        device=dev)
                stats.blocks_in_use = max(stats.blocks_in_use,
                                          pool.blocks_in_use)

            tokens = torch.from_numpy(last.copy()).to(dev)
            active_t = torch.from_numpy(active).to(dev)
            if n:
                ch_valid = [min(C, len(pref[b]["req"].prompt)
                                - pref[b]["done"]) for b in sel]
                ch_offs = [pref[b]["done"] for b in sel]
                ch_tok = np.zeros((n, C), np.int32)
                for j, b in enumerate(sel):
                    off = pref[b]["done"]
                    ch_tok[j, :ch_valid[j]] = np.asarray(
                        pref[b]["req"].prompt[off:off + ch_valid[j]],
                        np.int32)
                ret = self._cb_step(n)(
                    self.params, cache, tokens, active_t, ch_slots=sel,
                    ch_offs=ch_offs, ch_valid=ch_valid,
                    ch_tokens=torch.from_numpy(ch_tok).to(dev), **kw)
                logits, cache, pf_logits = ret[:3]
            else:
                ret = self._cb_step(0)(self.params, cache, tokens, active_t,
                                       **kw)
                logits, cache = ret[:2]
            if is_moe:
                stats.add_expert_hits(ret[-1].tolist())

            stats.steps += 1
            if n_active:
                stats.decode_steps += 1
                stats.slot_steps += n_active
            else:
                stats.prefill_only_steps += 1
            if n and n_active:
                stats.mixed_steps += 1
                if self._cb_fused_chunks[n]:
                    stats.fused_mixed_steps += 1
            if n:
                stats.prefill_chunks += n
                stats.fused_prefill_chunks += len(self._cb_fused_chunks[n])

            greedy = logits.argmax(dim=-1).tolist()
            for b in range(B):
                req = slots[b]
                if req is None:
                    continue
                pos_h[b] += 1
                tok = self._sample(logits[b], greedy[b], req)
                req.out_tokens.append(tok)
                stats.tokens += 1
                last[b] = tok
                reason = self._retire_reason(req, tok, len(req.out_tokens),
                                             pos_h[b])
                if reason:
                    req.done = True
                    slots[b] = None
                    if paged:
                        pool.release(b)
                    stats.retirements.append((stats.steps - 1, req.rid,
                                              reason))
            if n:
                pf_greedy = pf_logits.argmax(dim=-1).tolist()
                for j, b in enumerate(sel):
                    ent = pref[b]
                    ent["done"] += ch_valid[j]
                    pos_h[b] = ent["done"]
                    if ent["done"] >= len(ent["req"].prompt):
                        del pref[b]                    # prefill complete
                        if paged:
                            # the prompt is in cache: index its full blocks
                            # so later prompts sharing the prefix skip them
                            pool.register(b, ent["req"].prompt, step_i)
                        self._admit(ent["req"], b, pf_logits[j],
                                    pf_greedy[j], slots, pos_h, last)
                        if paged and slots[b] is None:
                            pool.release(b)       # admitted and retired
            for b, req in reserved:
                # the retiree's final decode ran this step (paged: its
                # blocks were just released): claim now, chunk next step
                claim(b, req, stats.steps)
        if paged:
            stats.evictions = pool.evictions - pool_base[0]
            stats.prefix_hits = pool.prefix_hits - pool_base[1]
            stats.prefix_tokens_reused = (pool.prefix_tokens_reused
                                          - pool_base[2])
        return requests
