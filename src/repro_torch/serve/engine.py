"""Batched serving engine: executed continuous batching with chunked prefill,
the wavefront scheduler and the hand-wired fallback decode.

The port of the JAX package's ``serve/engine.py``.  Its main path is the
executed continuous path (``ServeEngine(plan_fusion=True,
scheduling="continuous")`` -> ``_run_continuous_chunked``).  Every slot
keeps its own cache position
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

Two oracles beside it, as in the reference:

  * **wavefront** (``scheduling="wavefront"``): requests grouped by prompt
    length into lock-step waves, the batch refilled only when a whole wave
    finishes.  Hand-wired (``lm.prefill`` + ``lm.decode_step``), or, with
    ``plan_fusion=True`` on a single-layer dense config, through the
    executed decode program, whose first step of a wave carries the next
    wave's FFN in-projection (``prefill_ffn``) in its fused launch;
  * **the hand-wired continuous fallback** (``plan_fusion=False``): the
    continuous slot manager over ``lm.decode_step``, one slot at a time at
    its own position (the reference vmaps it over the slots), with whole
    prompts prefilled by ``lm.prefill`` beside the decode.  It launches no
    kernel of the port, so on the card it is the executor-free oracle.
    It is also how the LayerNorm configs are served: the program's norm
    member is RMSNorm only, so, as in the reference, a planned engine over
    one keeps the hand-wired step (on the card it refuses instead); and so
    are recurrentgemma-2b, deepseek-v2-236b and xlstm-1.3b, whose layers
    are not one global-attention run.  The slot cache carries any run's
    leaves by name (k/v, latent/rope, the recurrent states and conv
    windows), and ``lm.init_cache`` fills each xLSTM stabilizer ``m`` with
    ``xlstm.NEG``.

Differences from the reference, by design:
  * the KV cache (contiguous or arena) is updated IN PLACE (the reference
    rebuilds it functionally each step); ``_init_slot_cache`` owns it;
  * nothing is jitted: PyTorch runs eagerly (a CUDA graph of the step is
    later work);
  * sampling with ``temperature > 0`` draws from a ``torch.Generator``
    seeded by ``rng_seed``, so only greedy decoding matches the reference
    token for token;
  * ``plan_fusion`` defaults to True: the port's engine plans and executes
    unless the hand-wired path is asked for;
  * tensor-parallel serve (``mesh=``): each shard is one process of a
    ``torch.distributed`` group holding its own slab of the weights and
    the KV cache, and the row-split projections are summed with
    ``dist.all_reduce`` where the reference traces one ``shard_map``
    program and psums (``launch/mesh.py`` starts the ranks).
"""
from __future__ import annotations

import dataclasses
import warnings
from dataclasses import dataclass, field
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F

from repro_torch.configs.base import ATTN, ModelConfig
from repro_torch.core import executor, planner, stitch
from repro_torch.core.binding import BindingRegistry, Slot
from repro_torch.device import resolve_device
from repro_torch.distributed.sharding import mesh_shape, tp_shard_params
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
    """None when the planned decode program can replace ``lm.decode_step``
    for this config; otherwise the reason for the hand-wired fallback (the
    reference's rule and texts).  Whether the port can build the config at
    all is ``lm.supported``'s question: a LayerNorm config, or one of
    several runs, is built and served hand-wired, never through the
    program."""
    runs = lm.layer_runs(cfg)
    if cfg.frontend != "none":
        return f"frontend {cfg.frontend!r} (token frontend only)"
    if len(runs) != 1 or runs[0].kind != ATTN:
        return "needs a single global-attention layer run"
    if cfg.norm != "rmsnorm":
        return f"norm {cfg.norm!r} (rmsnorm only)"
    if not cfg.is_moe and cfg.d_ff <= 0:
        return "no FFN"
    if cfg.activation not in ("silu", "gelu", "gelu_mlp", "relu2_mlp"):
        return f"activation {cfg.activation!r}"
    return None


def _ffn_in_width(cfg: ModelConfig) -> int:
    """Width of the decode step's FFN in-projection, the reference's rule:
    the router's ``num_experts`` when the model routes, ``d_model`` for a
    block without an FFN (``d_ff <= 0``), else the real ``w_in`` (gated
    activations fuse gate and up into one (d, 2f) weight)."""
    if cfg.moe is not None:
        return cfg.moe.num_experts
    if cfg.d_ff <= 0:
        return cfg.d_model
    return 2 * cfg.d_ff if cfg.activation in ("silu", "gelu") else cfg.d_ff


def pad_prefill_rows(rows: int) -> int:
    """Deprecated: use ``PrefillBudget.pad_rows``."""
    warnings.warn("pad_prefill_rows is deprecated — use "
                  "PrefillBudget.pad_rows", DeprecationWarning, stacklevel=2)
    return PrefillBudget().pad_rows(rows)


def _mlp_from_h(cfg: ModelConfig, h: torch.Tensor,
                w_out: torch.Tensor) -> torch.Tensor:
    """layers.mlp minus the in-projection (the chunk post-work)."""
    act = cfg.activation
    if act in ("silu", "gelu"):
        gate, up = torch.chunk(h, 2, dim=-1)
        g = F.silu(gate) if act == "silu" else layers.gelu_tanh(gate)
        h = g * up
    elif act == "gelu_mlp":
        h = layers.gelu_tanh(h)
    elif act == "relu2_mlp":
        h = torch.square(torch.relu(h))
    else:
        raise ValueError(act)
    return h @ w_out


def _hand_wired_reason(cfg: ModelConfig, scheduling: str) -> Optional[str]:
    """Why a planned engine keeps the hand-wired decode step, or None: a
    config the program does not serve (either scheduling), or a stacked
    or MoE wavefront engine."""
    reason = executable_decode_supported(cfg)
    if reason is not None or scheduling != "wavefront":
        return reason
    if lm.layer_runs(cfg)[0].count > 1:
        return ("stacked layer runs execute on the continuous path only "
                "(wavefront keeps the hand-wired step)")
    if cfg.is_moe:
        return ("MoE decode executes on the continuous path only (the "
                "wavefront co-prefill glue is dense-FFN shaped)")
    return None


def prompt_refusal(cfg: ModelConfig) -> Optional[str]:
    """Why the engines cannot serve ``cfg``'s prompts, or None: they take
    token prompts only, as the reference's do (its ``run`` fails on an
    image prompt, which lacks ``pixel_embeds``, and on codebook prompts;
    ROADMAP §3).  ``lm.prefill`` and ``lm.decode_step`` serve such a
    config."""
    if cfg.frontend == "none":
        return None
    need = ("pixel_embeds beside the tokens" if cfg.frontend == "vision_stub"
            else f"(B, {cfg.num_codebooks}, S) codebook tokens")
    return (f"{cfg.name}: the engines take token prompts only; frontend "
            f"{cfg.frontend!r} needs {need}: serve it through lm.prefill "
            "and lm.decode_step (ROADMAP §3)")


class ServeEngine:
    """Continuous-batching server over the executed, planned decode step
    (``scheduling="continuous"``, ``plan_fusion=True``: the default), or
    the wavefront scheduler (``scheduling="wavefront"``), or the
    hand-wired fallback (``plan_fusion=False``).  ``executed`` says
    whether the decode step runs through the planned program.  A planned
    engine over a config the program does not serve (LayerNorm, a hybrid
    of RG-LRU and local-attention runs, MLA runs, mLSTM and sLSTM runs, or
    a frontend), and a
    planned wavefront engine over a stacked or MoE config, keep the
    hand-wired step with the reference's notice on the CPU (the fallback
    graph still planned), and refuse on the card.  ``run`` refuses a
    frontend config's prompts (``prompt_refusal``: token prompts only).

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
    cache persist across ``run()`` calls.

    ``mesh``: a ``DeviceMesh`` (``launch/mesh.py`` ``make_debug_mesh``)
    whose ``shard_axis`` has extent n > 1 makes this engine one rank of
    n-way tensor-parallel serve, each rank a process of the mesh's group
    running the same trace.  Only the executed continuous step runs
    sharded: the rank keeps its slab of ``params``
    (``distributed/sharding.tp_shard_params``: H/n query heads, Hkv/n KV
    heads and d_ff/n FFN columns), plans and launches its own shard-local
    program (the plan's cache signature carries ``"<axis>:<n>"``), holds
    Hkv/n heads of the KV cache (contiguous or paged), and sums the
    row-split W_o and W_out products over the axis with
    ``torch.distributed.all_reduce`` in the activations' dtype.  The slot
    manager, positions, stats and every sampled token are replicated on
    every rank.  The engine runs where the mesh does (``device_type``);
    ``device``, if given, must agree."""

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
                 mesh=None, shard_axis: str = "model", device=None,
                 plain: bool = False):
        if scheduling not in ("continuous", "wavefront"):
            raise ValueError(f"scheduling {scheduling!r} "
                             "(continuous or wavefront)")
        # tensor-parallel serve: the reference's refusals, with its texts
        self.mesh = mesh
        self.shard_axis = shard_axis
        self.tp_shards = 1
        n_tp = mesh_shape(mesh).get(shard_axis, 1) if mesh is not None else 1
        if n_tp > 1:
            if scheduling != "continuous" or not plan_fusion:
                raise ValueError(
                    "tensor-parallel serve requires scheduling='continuous' "
                    "and plan_fusion=True (only the executed continuous "
                    "step runs under shard_map)")
            reason = executable_decode_supported(cfg)
            if reason is not None:
                raise ValueError("tensor-parallel serve: config not "
                                 f"executor-supported ({reason})")
            if cfg.is_moe:
                raise ValueError(
                    "tensor-parallel serve: MoE expert weights are "
                    "expert-major, not head/column-sharded — serve MoE "
                    "single-device (expert parallelism is a ROADMAP item)")
            for what, dim in (("num_heads", cfg.num_heads),
                              ("num_kv_heads", cfg.num_kv_heads),
                              ("d_ff", cfg.d_ff)):
                if dim % n_tp:
                    raise ValueError(
                        f"tensor-parallel serve: {what}={dim} is not "
                        f"divisible by mesh axis {shard_axis!r} extent "
                        f"{n_tp}")
            self.tp_shards = n_tp
            if device is None:
                device = mesh.device_type
            elif torch.device(device).type != mesh.device_type:
                raise ValueError(f"device {device} is not the mesh's "
                                 f"({mesh.device_type})")
        self._mesh_tag = (f"{shard_axis}:{self.tp_shards}"
                          if self.tp_shards > 1 else "")
        self.allreduce_calls = self.allreduce_bytes = 0
        self.cfg = cfg
        self.batch = batch
        self.max_len = max_len
        self.scheduling = scheduling
        self.executed = False
        self.paged_kv = paged_kv
        self.kv_pool = None
        if paged_kv:
            # the reference's refusals, with its texts
            if scheduling != "continuous" or not plan_fusion:
                raise ValueError("paged_kv requires scheduling='continuous' "
                                 "and plan_fusion=True (the paged kernels "
                                 "run only on the executed chunked path)")
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
        reason = lm.supported(cfg)
        if reason is not None:
            raise NotImplementedError(f"{cfg.name}: the port does not serve "
                                      f"it yet: {reason} (ROADMAP)")
        self.device = resolve_device(device)
        hand_reason = (_hand_wired_reason(cfg, scheduling) if plan_fusion
                       else None)
        if hand_reason is not None and self.device.type != "cpu":
            # on the card a planned engine runs its kernels or refuses: the
            # hand-wired step is reached only by asking for it
            raise ValueError(f"plan_fusion: {hand_reason} — pass "
                             "plan_fusion=False (serve CLI: --hand-wired) to "
                             "serve through lm.decode_step")
        # the executed continuous step decodes with _step_params: the params
        # on one device, this rank's slab under tensor parallelism (the only
        # params such an engine keeps)
        self._tp_group = None
        self._step_params = params
        if self.tp_shards > 1:
            self._tp_group = mesh.get_group(shard_axis)
            if params is not None:
                self._step_params = tp_shard_params(
                    params, mesh.get_local_rank(shard_axis), self.tp_shards,
                    cfg=cfg)
            params = self._step_params
        self.params = params
        self.stitch_epilogues = stitch_epilogues
        self.prefill_budget = prefill_budget or PrefillBudget()
        self.reject_overlong = reject_overlong
        self.plain = plain
        self.dtype = lm.torch_dtype(cfg.dtype)
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(rng_seed)
        self._decode = lambda p, c, t: lm.decode_step(cfg, p, c, t)
        self._prefill = lambda p, b: lm.prefill(cfg, p, b,
                                                max_len=self.cache_len)
        self._mixed_steps: dict[int, object] = {}    # prompt len -> step
        #                                              (wavefront co-prefill)
        self._cb_steps: dict[int, object] = {}       # n chunks -> step fn
        self._cb_fused_chunks: dict[int, frozenset] = {}
        self.cb_program_info: dict[int, dict] = {}   # n chunks -> launch table
        self.stats = ServeStats(batch=batch)
        self._measure = measure
        self._schedule_cache = schedule_cache
        self.fusion_plan = None
        if plan_fusion:
            if hand_reason is None:
                if scheduling == "wavefront":
                    # the continuous path builds its own per-chunk-count
                    # steps; only wavefront decodes through this program
                    self._decode = self._make_decode_step(prefill_len=0)
                self.executed = True
            else:
                print(f"[plan-fusion] decode step stays hand-wired: "
                      f"{hand_reason}")
            self.fusion_plan = self.plan_decode_fusion(measure=measure,
                                                       cache=schedule_cache)

    # ------------------------------------------------------------------
    def _aligned_len(self) -> int:
        return max(128, -(-self.max_len // 128) * 128)

    @property
    def cache_len(self) -> int:
        """Rows of cache a slot can hold, the admission and retirement
        limit: on the executed paths ``max_len`` rounded up to 128, or with
        paged KV the slot's table span ``kv_slot_blocks * kv_block_size``
        (which may exceed ``max_len``); on the hand-wired paths
        ``max_len``."""
        if self.paged_kv:
            return self.kv_slot_blocks * self.kv_block_size
        if self.executed:
            return self._aligned_len()
        return self.max_len

    def _chunk(self, budget: PrefillBudget) -> int:
        """Rows of one prefill chunk against the 128-aligned cache (paged:
        the table span, and a whole number of pages)."""
        return budget.effective_chunk(
            self.cache_len if self.paged_kv else self._aligned_len(),
            multiple=self.kv_block_size if self.paged_kv else 1)

    @property
    def chunk_rows(self) -> int:
        return self._chunk(self.prefill_budget)

    def decode_graph(self, *, budget: Optional[PrefillBudget] = None,
                     prefill_chunks: int = 0, ffn_rows: int = 0,
                     dynamic_length: bool = True,
                     prefill_rows: Optional[int] = None):
        """The serving step as a planner graph with stable operand
        signatures: decode_norm1 -> qkv_proj -> decode attention (per-slot
        valid prefixes in a (B, 1) int32 operand; ``dynamic_length=False``
        takes the whole cache instead) -> decode_norm2 -> the FFN side,
        with the epilogue declaration norm1 -> qkv unless
        ``stitch_epilogues=False``; plus ``prefill_chunks`` independent
        prefill-attention ops.  Dense FFN side: ffn_proj -> decode_act
        (stitched likewise).  MoE: moe_router (fp32, B x d @ d x E) ->
        moe_gmm at capacity(cfg, B).  Paged: both attention ops take the
        block table and the arena, and a chunk is whole pages.  A config
        the program does not serve (``executable_decode_supported``) plans
        the reference's four-op fallback graph instead: decode_norm1 ->
        attention -> decode_norm2 (after both) -> the FFN in-projection.

        ``ffn_rows > 0`` adds the wavefront co-prefill partner
        ``prefill_ffn``: the riding prompt's FFN in-projection, ``ffn_rows``
        x d @ d x the FFN width (MoE: the expert FFN's).  ``prefill_rows``
        is its deprecated alias."""
        if prefill_rows is not None:
            warnings.warn("decode_graph(prefill_rows=) is deprecated — use "
                          "ffn_rows (wavefront FFN partner) or "
                          "prefill_chunks + PrefillBudget (chunked prefill)",
                          DeprecationWarning, stacklevel=2)
            ffn_rows = prefill_rows
        budget = budget or self.prefill_budget
        cfg = self.cfg
        d, D = cfg.d_model, cfg.resolved_head_dim
        # tensor parallel: the graph is ONE SHARD's (local head counts and
        # FFN widths); d_model stays replicated, so no row count changes
        tp = self.tp_shards
        H, Hkv = cfg.num_heads // tp, cfg.num_kv_heads // tp
        dt = self.dtype
        S = self.cache_len if self.paged_kv else self._aligned_len()
        B = self.batch
        bt = (self.kv_blocks, self.kv_block_size) if self.paged_kv else None
        ffn_in = _ffn_in_width(cfg) // tp

        norm1 = dataclasses.replace(rmsnorm_op(R=B, d=d, dtype=dt, bm=B),
                                    name="decode_norm1")
        norm2 = dataclasses.replace(rmsnorm_op(R=B, d=d, dtype=dt, bm=B),
                                    name="decode_norm2")
        # largest 128-multiple kv chunk <= 1024 dividing S (planning only:
        # the CUDA members compute the same function for any chunk; a
        # block size divides 128, so a paged chunk is whole pages)
        ck = next(c for c in range(min(1024, S), 0, -128) if S % c == 0)
        att = decode_attention_op(B=B, S=S, H=H, Hkv=Hkv, D=D, dtype=dt,
                                  ck=ck, dynamic_length=dynamic_length,
                                  block_table=bt)
        if executable_decode_supported(cfg) is not None:
            # the reference's fallback graph for a config the program does
            # not serve: QKV and the activation stay glue, norm2 reads
            # norm1's output beside attention's, and the projection is
            # ``_ffn_in_width`` wide in the model dtype (named moe_router,
            # num_experts wide, when the model routes; d_model wide for a
            # block without an FFN)
            proj = dataclasses.replace(
                matmul_1d_op(M=B, K=d, N=ffn_in, dtype=dt, bm=B),
                name="moe_router" if cfg.moe is not None else "ffn_proj")
            graph = [planner.GraphOp(norm1),
                     planner.GraphOp(att, deps=frozenset({norm1.name})),
                     planner.GraphOp(norm2, deps=frozenset({norm1.name,
                                                            att.name})),
                     planner.GraphOp(proj, deps=frozenset({norm2.name}))]
        else:
            qkv = dataclasses.replace(
                matmul_1d_op(M=B, K=d, N=(H + 2 * Hkv) * D, dtype=dt, bm=B),
                name="qkv_proj")
            if self.stitch_epilogues:
                norm1 = dataclasses.replace(norm1, epilogue=(qkv.name, "x"))
            if cfg.moe is not None:
                # the router's logits stay fp32 (its own matmul op) so
                # softmax and top-k see what the reference computes;
                # capacity is static per program
                m = cfg.moe
                proj = dataclasses.replace(
                    matmul_1d_op(M=B, K=d, N=m.num_experts,
                                 dtype=torch.float32, bm=B),
                    name="moe_router")
                gated = cfg.activation in ("silu", "gelu")
                tail = moe_gmm_op(E=m.num_experts,
                                  C=moe_mod.capacity(cfg, B), d=d,
                                  f=m.d_ff_expert, dtype=dt,
                                  act=cfg.activation if gated else "gelu",
                                  gated=gated)
            else:
                ffn_out = cfg.d_ff // tp
                proj = dataclasses.replace(
                    matmul_1d_op(M=B, K=d, N=ffn_in, dtype=dt, bm=B),
                    name="ffn_proj")
                act_fn = {"silu": elementwise.silu_gate,
                          "gelu": elementwise.gelu_gate,
                          "gelu_mlp": elementwise.gelu_plain,
                          "relu2_mlp": elementwise.relu2}[cfg.activation]
                tail = elementwise.activation_op(
                    R=B, F_in=ffn_in, F_out=ffn_out, fn=act_fn, dtype=dt,
                    bm=B, name="decode_act")
                if self.stitch_epilogues:
                    proj = dataclasses.replace(proj,
                                               epilogue=(tail.name, "h"))
            graph = [planner.GraphOp(norm1),
                     planner.GraphOp(qkv, deps=frozenset({norm1.name})),
                     planner.GraphOp(att, deps=frozenset({qkv.name})),
                     planner.GraphOp(norm2, deps=frozenset({att.name})),
                     planner.GraphOp(proj, deps=frozenset({norm2.name})),
                     planner.GraphOp(tail, deps=frozenset({proj.name}))]
        if ffn_rows:
            # the co-prefill partner is a full-FFN-width product (MoE: the
            # expert FFN's in-projection, gate and up fused when gated)
            gated = cfg.activation in ("silu", "gelu")
            pf_n = ((2 if gated else 1) * cfg.moe.d_ff_expert
                    if cfg.moe is not None else ffn_in)
            graph.append(planner.GraphOp(dataclasses.replace(
                matmul_1d_op(M=ffn_rows, K=d, N=pf_n, dtype=dt,
                             bm=min(128, ffn_rows)),
                name="prefill_ffn")))
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
                           measure=None, cache=None,
                           prefill_chunk: Optional[int] = None):
        """Plan the steady mixed iteration (the budget's full chunk
        complement) — the plan shown at engine start.  With ``measure`` the
        schedules are profiled; ``cache`` makes a later start search
        nothing.  ``prefill_chunk`` is the deprecated form of
        ``budget=PrefillBudget(chunk_rows=...)``."""
        if prefill_chunk is not None:
            warnings.warn("plan_decode_fusion(prefill_chunk=) is deprecated "
                          "— pass budget=PrefillBudget(chunk_rows=...)",
                          DeprecationWarning, stacklevel=2)
            budget = dataclasses.replace(budget or self.prefill_budget,
                                         chunk_rows=prefill_chunk)
        budget = budget or self.prefill_budget
        n = budget.max_coresident_chunks
        if max_ways is None:
            max_ways = 2 + n
        return planner.plan(self.decode_graph(budget=budget, prefill_chunks=n),
                            max_ways=max_ways, measure=measure, cache=cache,
                            mesh_tag=self._mesh_tag)

    # ------------------------------------------------------------------
    # Executed decode step: plan -> program -> live slot state
    # ------------------------------------------------------------------
    def build_decode_program(self, *, prefill_chunks: int = 0,
                             ffn_rows: int = 0,
                             prefill_rows: Optional[int] = None):
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
        before the program runs.  ``ffn_rows`` adds the wavefront
        co-prefill partner ``prefill_ffn`` (state ``pf_h2`` @ ``w_in`` ->
        ``pf_ffn``); ``prefill_rows`` is its deprecated alias."""
        if prefill_rows is not None:
            warnings.warn("build_decode_program(prefill_rows=) is "
                          "deprecated — use ffn_rows (wavefront FFN "
                          "partner) or prefill_chunks (chunked prefill)",
                          DeprecationWarning, stacklevel=2)
            ffn_rows = prefill_rows
        cfg = self.cfg
        # tensor parallel: shard-local heads; the two row-split output
        # projections' partial products are summed over the shard axis
        tp = self.tp_shards
        H, Hkv = cfg.num_heads // tp, cfg.num_kv_heads // tp
        D = cfg.resolved_head_dim
        dt = self.dtype
        B = self.batch
        paged = self.paged_kv
        bs = self.kv_block_size if paged else 0

        graph = self.decode_graph(prefill_chunks=prefill_chunks,
                                  ffn_rows=ffn_rows)
        plan = planner.plan(graph, max_ways=max(3, 2 + prefill_chunks),
                            allow_same_bound=True, measure=self._measure,
                            cache=self._schedule_cache,
                            mesh_tag=self._mesh_tag)

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
            attn_out = self._tp_sum(o.to(dt).reshape(B, H * D)
                                    @ state["w_o"])
            state = dict(state)
            state["h_mid"] = state["x"] + attn_out               # residual 1
            return state

        def act_put(state, h_act):
            ff = self._tp_sum(h_act.to(dt) @ state["w_out"])
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
            # the fallback graph names its projection moe_router when the
            # model routes (a launch table only: the program serves no
            # such config)
            proj_name = "moe_router" if cfg.moe is not None else "ffn_proj"
            chain2 = stitch.chain_label(proj_name, "decode_act")
            if chain2 in plan_names:
                reg.bind(chain2, x="h2", w="w_in",
                         outputs={"out": Slot(put=act_put)})
            else:
                reg.bind(proj_name, x="h2", w="w_in",
                         outputs={"out": "h_ffn"})
                reg.bind("decode_act", h="h_ffn",
                         outputs={"out": Slot(put=act_put)})
        if ffn_rows:
            reg.bind("prefill_ffn", x="pf_h2", w="w_in",
                     outputs={"out": "pf_ffn"})
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

    def _tp_sum(self, partial: torch.Tensor) -> torch.Tensor:
        """A row-split projection's partial products summed over the shard
        axis in their own dtype (the reference's psum), in place; the
        identity on one device."""
        if self.tp_shards == 1:
            return partial
        dist.all_reduce(partial, group=self._tp_group)
        self.allreduce_calls += 1
        self.allreduce_bytes += partial.numel() * partial.element_size()
        return partial

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
    # Executed wavefront step
    # ------------------------------------------------------------------
    def _wave_state(self, params, cache, x) -> dict:
        """Wavefront form of ``_layer_state``: the wave's scalar position
        broadcast into the per-slot (B,) vector, every slot decoding."""
        B = self.batch
        run = lm.layer_runs(self.cfg)[0]
        pos = cache["pos"].reshape(1).expand(B).to(torch.int32)
        act = torch.ones(B, dtype=torch.bool, device=x.device)
        return self._layer_state(params[run.name], cache[run.name], x, pos,
                                 act)

    def _coprefill_to_ffn_in(self, params, pf_tokens, P: int, pf_rows: int):
        """A riding prompt's prefill up to the FFN in-projection's input,
        the part before the fused launch.  pf_tokens (Bp, P) -> (pf_h2
        (pf_rows, d) zero-padded, the post-attention hidden xm (Bp, P, d),
        kp, vp (Bp, P, Hkv, D))."""
        cfg = self.cfg
        p = params[lm.layer_runs(cfg)[0].name]
        xp, _ = lm._embed_inputs(cfg, params, {"tokens": pf_tokens})
        Bp = xp.shape[0]
        xm, h2p, kp, vp = lm.block_attention_seq(cfg, p, xp)
        pf_x = h2p.reshape(Bp * P, cfg.d_model)
        if pf_rows != Bp * P:
            pf_x = torch.cat([pf_x, pf_x.new_zeros(pf_rows - Bp * P,
                                                   cfg.d_model)])
        return pf_x.to(self.dtype).contiguous(), xm, kp, vp

    def _make_decode_step(self, prefill_len: int):
        """The executed decode step of wavefront scheduling:
        ``step(params, cache, tokens)`` -> (logits, cache with pos + 1),
        the cache's k/v written in place.  ``prefill_len`` P > 0 is the
        mixed form ``step(params, cache, tokens, pf_tokens)``: the pending
        wave's (B, P) prompt rides along, its FFN in-projection
        (``prefill_ffn``, B * P rows padded by the budget's ``pad_rows``)
        joins the fused launch, the rest of its prefill runs here, and
        (logits, cache, pf_cache, pf_logits) seed that wave's decode without
        ``lm.prefill``."""
        cfg = self.cfg
        B, d, dt = self.batch, cfg.d_model, self.dtype
        run = lm.layer_runs(cfg)[0]
        S = self._aligned_len()
        P = prefill_len
        rows = B * P
        pf_rows = self.prefill_budget.pad_rows(rows)
        program = self.build_decode_program(ffn_rows=pf_rows if P else 0)

        def step(params, cache, tokens, pf_tokens=None):
            p = params[run.name]
            x = layers.embed_onehot(params["embed"], tokens, d)  # (B, d)
            state = self._wave_state(params, cache, x)
            if P:
                state["pf_h2"], xm, kp, vp = self._coprefill_to_ffn_in(
                    params, pf_tokens, P, pf_rows)
            state = program(state)
            xf = layers.apply_norm(cfg, params["final_norm"],
                                   state["x_out"][:, None, :].to(dt))
            logits = lm._head(cfg, params, xf)[:, 0]
            new_cache = {"pos": cache["pos"] + 1,
                         run.name: {"k": state["k_cache"],
                                    "v": state["v_cache"]}}
            if not P:
                return logits, new_cache
            ff = _mlp_from_h(cfg, state["pf_ffn"][:rows].to(dt)
                             .reshape(B, P, -1), p["mlp"]["w_out"])
            xop = xm + ff
            pf_cache = {"pos": torch.tensor(P, dtype=torch.int32,
                                            device=x.device),
                        run.name: {"k": lm.cache_rows(kp, S),
                                   "v": lm.cache_rows(vp, S)}}
            xfp = layers.apply_norm(cfg, params["final_norm"], xop[:, -1:])
            pf_logits = lm._head(cfg, params, xfp)[:, 0]
            return logits, new_cache, pf_cache, pf_logits

        return step

    def _mixed_step(self, prefill_len: int):
        if prefill_len not in self._mixed_steps:
            self._mixed_steps[prefill_len] = self._make_decode_step(
                prefill_len)
        return self._mixed_steps[prefill_len]

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
                         self.cfg.num_kv_heads // self.tp_shards,
                         self.cfg.resolved_head_dim)
                self._arena = {run.name: {
                    k: torch.zeros(shape, dtype=self.dtype,
                                   device=self.device)
                    for k in ("k", "v")}}
            cache = dict(self._arena)
        else:
            # a tensor-parallel rank holds its Hkv/n heads
            local = dataclasses.replace(
                self.cfg, num_kv_heads=self.cfg.num_kv_heads // self.tp_shards,
                head_dim=self.cfg.resolved_head_dim)
            cache = lm.init_cache(local, self.batch, self.cache_len,
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
        decoding slots' routed tokens last.  Under tensor parallelism the
        step runs on the rank's heads and ``params`` is its slab; each
        chunk's W_o and FFN-out products are all-reduced like the decode
        side's."""
        cfg = self.cfg
        d = cfg.d_model
        run = lm.layer_runs(cfg)[0]
        dt = self.dtype
        n = n_chunks
        H, Hkv = cfg.num_heads // self.tp_shards, \
            cfg.num_kv_heads // self.tp_shards
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
                xm = chs[i] + self._tp_sum(o.reshape(C, -1)
                                           @ p["attn"]["w_o"])
                h2 = layers.apply_norm(cfg, p["norm2"], xm[None])
                if is_moe:
                    # the chunk's rows route jointly (T = C), as the
                    # reference's lm._apply_ffn does
                    ff = lm._apply_ffn(cfg, p, h2)[0][0]
                else:
                    ff = self._tp_sum(_mlp_from_h(
                        cfg, h2[0] @ p["mlp"]["w_in"], p["mlp"]["w_out"]))
                new_chs.append(xm + ff)
            return state["x_out"], new_chs, state.get("expert_counts")

        def step(params, cache, tokens, active, bt=None, ch_slots=(),
                 ch_offs=(), ch_valid=(), ch_tokens=None):
            x = layers.embed_onehot(params["embed"], tokens, d)   # (B, d)
            chs = [lm._embed_inputs(cfg, params,
                                    {"tokens": ch_tokens[i][None]})[0][0]
                   for i in range(n)]
            pos = cache["pos"]
            kv = cache[run.name]
            counts = None
            for li, (_run, p_l) in enumerate(lm.layer_params(cfg, params)):
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

    def _slot_view(self, cache: dict, b: int) -> dict:
        """Slot b's rows of the slot cache as a one-row cache (views: a
        write lands in the slot cache) at its own position; every run's
        leaves, the slot axis 1 for a stacked run and 0 otherwise."""
        view = {"pos": cache["pos"][b]}
        for run in lm.layer_runs(self.cfg):
            ax = 1 if run.count > 1 else 0
            view[run.name] = {k: t.narrow(ax, b, 1)
                              for k, t in cache[run.name].items()}
        return view

    def _cb_plain_decode(self):
        """The fallback continuous decode: ``lm.decode_step`` for each
        decoding slot at its own cache position (the reference vmaps it over
        every slot), writing the slot's rows in place; an inactive slot
        holds its position, and its logits row is zeros.
        ``step(params, cache, tokens, active)`` -> (logits (B, V), cache)."""
        cfg = self.cfg

        def step(params, cache, tokens, active):
            rows = []
            for b in range(self.batch):
                if not bool(active[b]):
                    rows.append(None)
                    continue
                lg, _ = lm.decode_step(cfg, params, self._slot_view(cache, b),
                                       tokens[b:b + 1])
                rows.append(lg[0])
            like = next(r for r in rows if r is not None)
            logits = torch.stack([torch.zeros_like(like) if r is None else r
                                  for r in rows])
            pos = cache["pos"]
            cache["pos"] = torch.where(active.to(pos.device), pos + 1, pos)
            return logits, cache

        return step

    def _cb_refill(self, cache: dict, slot: int, prompt):
        """Admit one prompt into a free slot: ``lm.prefill`` of (1, P), its
        cache rows written into the slot's, the slot's position set to P.
        Returns (cache, the last position's logits (V,))."""
        toks = torch.from_numpy(np.asarray(prompt, np.int32)[None]) \
            .to(self.device)
        c1, logits = self._prefill(self.params, {"tokens": toks})
        view = self._slot_view(cache, slot)
        for run in lm.layer_runs(self.cfg):
            for k, t in view[run.name].items():
                t.copy_(c1[run.name][k])
        cache["pos"][slot] = c1["pos"]
        return cache, logits[0]

    # ------------------------------------------------------------------
    def _sample(self, logits: torch.Tensor, greedy: int,
                req: Request) -> int:
        if req.temperature > 0:
            probs = torch.softmax(logits.float() / req.temperature, dim=-1)
            return int(torch.multinomial(probs, 1,
                                         generator=self.generator))
        return greedy

    def _wave_tokens(self, wave: list[Request]) -> torch.Tensor:
        S = len(wave[0].prompt)
        toks = np.zeros((self.batch, S), np.int32)
        for i, r in enumerate(wave):
            toks[i] = r.prompt
        return torch.from_numpy(toks).to(self.device)

    def _prefill_wave(self, wave: list[Request]):
        """A wave's prompts (one length; rows past the wave are zeros and
        ignored) -> (cache, last-position logits)."""
        return self._prefill(self.params, {"tokens": self._wave_tokens(wave)})

    def run(self, requests: list[Request]) -> list[Request]:
        refusal = prompt_refusal(self.cfg)
        if refusal is not None:
            raise NotImplementedError(refusal)
        if self.scheduling == "continuous":
            return self._run_continuous(requests)
        return self._run_wavefront(requests)

    def _run_continuous(self, requests: list[Request]) -> list[Request]:
        """Iteration-level continuous batching: prompts longer than the
        cache are refused (with ``reject_overlong``, also those longer than
        one iteration's chunk); the executed path admits by chunks
        (``_run_continuous_chunked``), the fallback whole prompts beside
        the decode (``_run_continuous_plain``)."""
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
        self.allreduce_calls = self.allreduce_bytes = 0
        # FIFO by arrival step, submission order breaking ties
        waiting = sorted(requests, key=lambda r: r.arrival)
        if self.executed:
            return self._run_continuous_chunked(requests, waiting)
        return self._run_continuous_plain(requests, waiting)

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
                    self._step_params, cache, tokens, active_t, ch_slots=sel,
                    ch_offs=ch_offs, ch_valid=ch_valid,
                    ch_tokens=torch.from_numpy(ch_tok).to(dev), **kw)
                logits, cache, pf_logits = ret[:3]
            else:
                ret = self._cb_step(0)(self._step_params, cache, tokens,
                                       active_t, **kw)
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

    def _run_continuous_plain(self, requests, waiting) -> list[Request]:
        """Fallback continuous batching (hand-wired decode): every step
        decodes all active slots, retires finished ones, and refills every
        free slot from the arrival queue (lowest free slot, arrival order
        first).  Whole prompts prefill beside the decode in the same
        iteration; a slot whose request retires deterministically this step
        (budget or cache-full) refills in that same iteration."""
        B = self.batch
        dev = self.device
        stats = self.stats
        slots: list[Optional[Request]] = [None] * B
        pos_h = [0] * B                               # host mirror of pos
        last = np.zeros(B, np.int32)
        cache = self._init_slot_cache()
        decode = self._cb_plain_decode()

        def refill(cache, slot, req):
            cache, pf_logits = self._cb_refill(cache, slot, req.prompt)
            return cache, pf_logits, int(pf_logits.argmax())

        while waiting or any(s is not None for s in slots):
            step_i = stats.steps
            # refillable: empty, or retiring deterministically this step
            # (the retiree's last decode reads the cache before the
            # refill's rows land; EOS retirements refill a step later)
            free = [i for i, s in enumerate(slots)
                    if s is None or self._will_retire_this_step(s, pos_h[i])]
            arrived = [r for r in waiting if r.arrival <= step_i]
            refills = list(zip(free, arrived))
            for _slot, r in refills:
                waiting.remove(r)
            active = np.array([s is not None for s in slots])
            n_active = int(active.sum())

            if n_active == 0:
                stats.steps += 1
                if not refills:
                    continue                          # idle: future arrivals
                stats.prefill_only_steps += 1
                for slot, req in refills:
                    cache, pf_logits, g = refill(cache, slot, req)
                    self._admit(req, slot, pf_logits, g, slots, pos_h, last)
                continue

            logits, cache = decode(self.params, cache,
                                   torch.from_numpy(last.copy()).to(dev),
                                   torch.from_numpy(active))
            extra = [refill(cache, slot, req)[1:] for slot, req in refills]
            stats.steps += 1
            stats.decode_steps += 1
            stats.slot_steps += n_active
            if refills:
                stats.mixed_steps += 1

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
                    stats.retirements.append((stats.steps - 1, req.rid,
                                              reason))
            for (slot, req), (pf_logits, g) in zip(refills, extra):
                self._admit(req, slot, pf_logits, g, slots, pos_h, last)
        return requests

    # ------------------------------------------------------------------
    def _run_wavefront(self, requests: list[Request]) -> list[Request]:
        """Lock-step waves: requests grouped by prompt length (up to
        ``batch`` a wave), each wave prefilled and decoded to its longest
        budget before the next starts.  Executed: the first decode step of
        a wave carries the next wave's prompt (``_mixed_step``), whose
        cache and logits then seed that wave."""
        by_len: dict[int, list[Request]] = {}
        for r in requests:
            by_len.setdefault(len(r.prompt), []).append(r)
        pending: list[list[Request]] = []
        for _, group in sorted(by_len.items()):
            for i in range(0, len(group), self.batch):
                pending.append(group[i: i + self.batch])
        carried = None          # (cache, logits) co-prefilled for pending[0]
        while pending:
            wave = pending.pop(0)
            if carried is not None:
                cache, logits = carried
                carried = None
            else:
                cache, logits = self._prefill_wave(wave)
            greedy = logits.argmax(dim=-1).tolist()
            for i, r in enumerate(wave):
                r.out_tokens.append(self._sample(logits[i], greedy[i], r))
            budget = max(r.max_new_tokens for r in wave)
            for step_i in range(budget - 1):
                if all(r.done or len(r.out_tokens) >= r.max_new_tokens
                       for r in wave):
                    break
                toks = np.zeros((self.batch,), np.int32)
                for i, r in enumerate(wave):
                    toks[i] = r.out_tokens[-1]
                toks = torch.from_numpy(toks).to(self.device)
                if (self.executed and step_i == 0 and pending
                        and carried is None):
                    # the next wave's prompt FFN rides this step's launch
                    nxt = pending[0]
                    logits, cache, pf_cache, pf_logits = self._mixed_step(
                        len(nxt[0].prompt))(self.params, cache, toks,
                                            self._wave_tokens(nxt))
                    carried = (pf_cache, pf_logits)
                else:
                    logits, cache = self._decode(self.params, cache, toks)
                greedy = logits.argmax(dim=-1).tolist()
                for i, r in enumerate(wave):
                    if r.done or len(r.out_tokens) >= r.max_new_tokens:
                        continue
                    tok = self._sample(logits[i], greedy[i], r)
                    r.out_tokens.append(tok)
                    if r.eos_token is not None and tok == r.eos_token:
                        r.done = True
            for r in wave:
                r.done = True
        return requests
