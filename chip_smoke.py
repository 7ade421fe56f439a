#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port (``src/repro_torch``).

  python3 chip_smoke.py

Runs on one NVIDIA card, in phases; any failing phase ends the script with a
non-zero exit code and no result line.

  1. card    the card's name and power limit (nvidia-smi).
  2. build   nvcc the kernel library from ``src/repro_torch/csrc`` for
             sm_90a (keyed by a hash of the sources, under ``build/``);
             ptxas's registers, stack and spills of the bundle kernel's six
             instances, the tiled matmul and flash kernels and the non-inlined member
             bodies (prefill, moe_gmm, the bf16 row GEMM, decode, RMSNorm's
             row_norm per type, the hash body hash_member and the ethash
             body ethash_member, which must not spill, nor may hf_paper,
             which holds the maxpool and hist bodies inlined, and hf_stream,
             which holds maxpool's), the
             tiled matmul's
             shared memory a CTA, and the HMMA (mma.sync) instructions in
             their SASS (cuobjdump; a body's span inside a bundle instance
             from the ELF symbol table): the bf16 flash kernels, the
             prefill, moe_gmm, row GEMM and ethash (3xTF32) bodies must hold
             some, the hash body, hf_stream and hf_paper outside its bodies
             none; and
             the HGMMA
             (wgmma) instructions of the bf16 tiled matmul, which must hold
             some.
  2b. paper  the paper suite (``kernels/paper_suite.py``) at the
             reference's default sizes: each of the 9 atoms at its defaults
             and at ``SMALL_KW`` (and the bf16 forms of maxpool, upsample,
             im2col, bnstats, hist) against its plain version, bitwise or
             within ``paper_suite.TOLERANCE``; maxpool with NaN and +-inf in
             either row of a pair and hist with NaN, +-inf and values past
             +-4, fp32 and bf16, against their plain versions (NaN compared
             equal); im2col at K = C - 1, C, C + 1 and 2C + 3 (C 4 fp32, C 8
             bf16) bitwise against its plain version; each timed beside its
             plain version, its bound and, for maxpool, upsample and im2col,
             one PyTorch call (``torch.amax``, ``torch.repeat_interleave``,
             ``torch.index_select`` with the rotations' index made once;
             bnstats in bf16 too, beside ``torch.var_mean`` as a same-bytes
             yardstick; maxpool, upsample, im2col and hist in bf16 too, with
             their share of the bound, their time after a flush that reads
             instead of zeroing, the instance a launch runs, and for hist
             ``torch.histc`` as a same-bytes yardstick); each hash variant's
             time a round and share of its bound; ethash_like's share of its
             3xTF32, byte and fp32 FMA bounds.  Then,
             with every launch counter reset, the path itself:
             ``launch/paper.py``'s main over the 16 pairs and 4 triples with
             ``--measure gpu`` (plan, cost-model and measured search; native,
             vertical fusion, naive 1:1, planned and measured launches
             bitwise equal; their times, gains over native, the launch's
             shared memory and resident CTAs per SM); every paper kernel
             must have launched.  Last, the quickstart pair's
             ``generate_vfused`` and planned launches timed beside their
             plain versions for the report.
  3. kernels every serve member at the full-width granite-3-2b main-path
             shapes (B=8, S=2048, chunk C=512, bf16) against its plain
             PyTorch version; each chain bitwise against its two members
             launched separately; the two fused bundles the planner picks
             bitwise against ``run_native`` of the same members, with the
             launch's shared memory and CTAs per SM.  Each is
             timed with CUDA events (median of 20 launches, L2 flushed before
             each, the queue primed so host overhead stays out of the window)
             beside its plain version, one PyTorch library call as a
             yardstick (never used by the port) and its bound from bytes and
             operations at the card's data-sheet rates.  The host's time
             to queue one decode launch, and of it the per-launch
             workspace; and to queue one qkv_proj launch.
  4. adamw   the AdamW member at granite's w_qkv leaf, (1966080, 128) bf16
             p/g and fp32 m/v, bm 1024, in place, bitwise against its plain
             version; an embedding-shaped leaf (a padded tail, copied and
             written back); timed beside its plain version.
             ``torch.optim.AdamW(fused=True)`` on the same leaf is timed on
             a line of its own: it keeps a bf16 parameter's moments in
             bf16 (14 B an element against the member's 22), another
             function, so the member's row has no library time.
  5. plan    ``plan_update_fusion`` and ``build_update_program`` at full
             width with ``make_measure("gpu")`` through a schedule cache
             (n_measured, cost-model-vs-measured deltas), then the same plans
             again from the cache file: zero new searches.
  6. bundles the full-width update program bitwise against the same plan
             run as one launch per member (``run_native``), and
             ``multi_tensor_adamw``'s 8-member launch bitwise against the 8
             singles, on synthetic full-width state; the whole update timed
             against its bound and fused ``torch.optim.AdamW`` over the same
             leaves.
  6b. update_dw  ``plan_update_fusion``'s plan (phase 5, both stacked norm
             scales' fp32 dW->AdamW chains) compiled by ``executor.compile_plan``
             with seeded x^T (d_in, 8192) and dy (8192, d_out) for the dW
             operands, run with the counters reset, together with the chain
             sweep and the bf16 dW->AdamW chain at a layer's W_o (2048 x 8192
             @ 8192 x 2048, bm 256), each once; the program held BITWISE
             against the same plan run as separate launches (each dW GEMM
             alone, its gradient stored, then the update) and timed beside
             them and its byte bound.  The chain sweep: every producer -> consumer pair
             of rmsnorm, the two activations, the residual add, the W_o /
             gate+up / down GEMMs and the AdamW update at granite decode width
             (M 8, d 2048, d_ff 8192) that the stitching contract accepts, bf16
             and fp32, each BITWISE against its two members launched
             separately and timed beside them, its plain version, its bound
             and, for the GEMM -> residual add, ``torch.addmm``.  Then
             ``BUNDLE_CHAINS`` (the chains of the bundle kernel's chain
             instance: dW -> AdamW, GEMM -> rmsnorm through the workspace, a
             row-wise pair, the fp32 GEMM's epilogues and staged producer)
             and the AdamW member in ONE ``hfuse.generate`` launch, BITWISE
             against ``run_native`` of the same members, and timed beside it.
             Row e's fp32 gate+up alone at decode width (8 x 2048 @ 2048 x
             16384) against its plain version, timed beside
             ``torch.matmul``; each fp32 GEMM's split (``[row_gemm_f32]``:
             K slices, CTAs, the partials written and read beside the
             weight's bytes).
  7. train   full-width granite-3-2b (40 layers, bf16, fp32 moments, remat,
             random weights from a seeded torch.Generator), batch 4 x seq
             2048 from ``TokenPipeline``, 4 steps of ``make_train_step`` with
             the planned update program; per step the loss, ms, tokens/s, the
             update's device time and launches, the peak memory; on the first
             step the executed update is held bitwise against the plain
             update on the first and last block of every leaf (the
             embedding's padded tail included).  One more step runs under
             torch.profiler for device time by kernel name.
  8. serve   the port's ServeEngine on full-width granite-3-2b (40 layers,
             bf16, random weights from a seeded torch.Generator), batch 8,
             max_len 2048, PrefillBudget(chunk_rows=512,
             max_coresident_chunks=2), 12 staggered requests with prompts of
             64..1500 tokens and 8..16 new tokens.  The first mixed step's
             logits are held against the same step built from the plain
             versions on the card.  The trace is then served once more under
             torch.profiler for device time by kernel name.
  8l. tp     tensor-parallel serve of full-width granite-3-2b at TP 2 and
             TP 4, the ranks (``launch/mesh.py`` ``run_ranks``, spawned
             processes, gloo) sharing the one card.  For each shard count:
             the serve members at the shard's shapes (``shard_config``: H/n,
             Hkv/n, d_ff/n) against their plain versions, timed beside them,
             a PyTorch call and their bounds, as phase 3's; then the ranks,
             each drawing phase 8's weights from the same seed and keeping
             its slab: phase 8's first mixed step again from its cache rows
             of the rank's KV heads and its tokens, the logits and the
             written k/v rows within LOGITS_REL_L2 of one device's, and
             within LOGITS_REL_L2 of the rank's plain version; phase 8's
             trace served with the launch counters reset: every rank's
             tokens and stats rank 0's, every serve kernel launched on every
             rank, a fused mixed step, and each request's first divergence
             from phase 8's tokens (if any) at a top-2 gap of at most
             TP_TIE_STEPS bf16 steps; printed: the backend, the agreement,
             all-reduces and bytes a step a rank, each rank's peak memory,
             the walls.  The ranks' launch counts, summed, are the kernels
             line's ``tp2_serve`` and ``tp4_serve``.
  8b. paged  granite-3-2b at full width cut to 1 layer (the reference's
             paged arena is single-layer), paged KV with 16-row pages and
             the default arena (8 x 128 + 8 blocks): the paged decode and
             prefill members on an arena holding the contiguous cache's
             content in shuffled blocks, each BITWISE equal to the
             contiguous member and within tolerance of its paged plain
             version, timed beside the contiguous member (the lookup's
             cost); the planner's fused paged launch bitwise against
             run_native; then 12 staggered requests sharing one
             1024-token prefix, served with the launch counters reset:
             prefix hits, fewer prefill chunks than the contiguous engine
             and its tokens, token for token.
  8c. moe    phi3.5-moe-rms at full width cut from 32 to 8 layers (all 32
             need 83 GB): the fp32 router GEMM and the grouped expert FFN
             at the decode shape (E 16, C 8) and at a chunk's capacity (C
             80) against their plain versions, timed beside them, their
             bounds and a torch.bmm yardstick; a line of its own gives the
             bytes the grouped FFN's design moves (weights per pass, fp32
             partials written and read, xe and ye), worked out from its
             passes and f-tiles; moe_gmm and a prefill chunk
             in one launch at the search's schedule, bitwise against
             run_native; decode attention (mixed lengths) and prefill
             attention (offsets 0 and 1024, contiguous and paged, the paged
             member bitwise equal to the contiguous) at phi3.5-moe's heads
             (32/8, head dim 128), each against its plain version and
             timed beside it, its bound and SDPA; then 12 staggered
             requests under the eload
             policy with the counters reset, and the first mixed step's
             logits through the 8 layers against the plain step.
  8d. ops    the public kernel entry points (``kernels/ops.py``) at
             full-width granite-3-2b train shapes (8192 rows, d_model 2048,
             32/8 heads, head dim 64, d_ff 8192): the tiled matmul (QKV,
             W_o, gate+up, down in bf16; QKV in fp32), flash attention (causal
             and not, bf16 and fp32; head dim 128 at phi3.5-moe's 32/8
             heads), the standalone rmsnorm and the residual add (bf16 and
             fp32), each against its plain version and timed beside it, its
             bound and one PyTorch call (the residual add also bitwise
             against ``torch.add``, with the instance its launch runs and
             that instance's CTAs an SM, alone and fused with another row
             member); the matmul->residual_add
             chain at
             decode (W_o, 8 rows) bitwise against its two members, bf16 and
             fp32.  Then, with the counters reset, the path: a granite-3-2b
             layer built from the ops (rmsnorm -> QKV -> flash attention ->
             W_o -> residual add -> rmsnorm -> gate+up -> SwiGLU -> down ->
             residual add) held against the same layer of plain versions
             within LOGITS_REL_L2, ``ops.moe_gmm`` at phi3.5-moe's decode
             shape and ``ops.hfused_adamw`` over the layer's six leaves.
  8e. wavefront  granite-3-2b at full width cut to 1 layer (the reference
             executes the wavefront step only on a single-layer run),
             ``scheduling="wavefront"``, B 8, max_len 2048: 16 requests in
             two waves (8 prompts of 256 tokens, 8 of 512), 8 new tokens
             each, with the counters reset: the first wave's first step
             carries the second wave's FFN in-projection (prefill_ffn, M
             4096).  The engine executes, a mixed step ran, the bundle
             launcher, the row member and decode attention launched, the
             mixed step's decode and co-prefill logits are within
             LOGITS_REL_L2 of the same step from the plain versions, and,
             without the executor, every executed step's decode logits
             (the mixed step's too) within LOGITS_REL_L2 of
             ``lm.decode_step`` on a copy of its cache and tokens, the
             co-prefill's within LOGITS_REL_L2 of ``lm.prefill`` of the
             riding prompts; the share of tokens agreeing with the
             hand-wired wavefront engine is printed.  prefill_ffn at M 4096 alone (row e) against its
             plain version, timed beside ``torch.matmul`` and its bound, and
             in one launch with decode attention at the search's schedule,
             bitwise against run_native and timed beside it (row a).
  8f. fallback  full-depth granite-3-2b, ``plan_fusion=False`` (the
             hand-wired continuous fallback: ``lm.prefill`` and
             ``lm.decode_step``, one slot at a time): 4 requests with
             prompts of 64..512 tokens, 4 new tokens each, with the counters
             reset: no kernel of the port may launch (the executor-free
             oracle), every request completes, and each prompt's first-token
             logits are within LOGITS_REL_L2 of the executed engine's
             final-chunk logits for it, and each decoding step of the
             executed engine is within LOGITS_REL_L2 of the fallback's
             decode (``lm.decode_step`` a slot) on a copy of its cache, over
             the decoding slots; the share of tokens agreeing with the
             executed engine is printed.
  8g. layernorm  the LayerNorm configs, one at a time, random weights from
             a seeded torch.Generator: stablelm-3b, starcoder2-7b and
             minitron-8b at full depth and the faithful phi3.5-moe cut to 8
             of 32 layers.  For 4 prompts of 256 tokens, ``lm.prefill``'s
             logits against ``lm.forward`` of 257 at position 255, and one
             ``lm.decode_step`` against position 256, within LOGITS_REL_L2;
             a planned engine must refuse and name ``--hand-wired``; the
             hand-wired fallback serves 4 requests (64..512 tokens, 4 new)
             with the counters reset: no kernel of the port may launch,
             each first token is ``lm.prefill``'s greedy token on its prompt
             alone, tokens/s on the host clock.  ``layers.layernorm`` on
             8192 x 4608 bf16 against the formula in fp64, within 2**-7 of
             the largest value.  stablelm-3b trained at full width and
             depth (batch 4 x seq 2048, remat, fp32 moments, the update
             program of ``build_update_program``), 3 steps with the
             counters reset: finite loss, grad norm > 0, every LayerNorm
             bias moved from zero in every layer, the AdamW member and the
             bundle launcher launched; ms per step (median of steps 1-2),
             peak memory, one more step under torch.profiler for the busy
             share.  Then its ``plan_update_fusion`` plan (the head's bf16
             and two norm leaves' fp32 dW->AdamW chains) run once with the
             counters reset on seeded state, each chain's p, m, v bitwise
             against its two members launched apart, and the head's chain
             (2560x8192 @ 8192x50304) timed.
  8h. recurrent  recurrentgemma-2b at full width and depth (26 layers:
             RG-LRU blocks and local attention of window 2048 in 17 runs,
             MQA heads of 256, vocabulary 256000), random weights from a
             seeded torch.Generator.  For 2 prompts of 2048 tokens (the
             first decode step wraps the local-attention ring) and 2 of
             2100 (a misaligned ring), ``lm.prefill`` and 4
             ``lm.decode_step``s against ``lm.forward`` of S + 4 at the
             same positions, within LOGITS_REL_L2; every local-attention
             ring after the prefill holds position p's k and v rows at
             slot p % W (bitwise against the rows the prefill's layer
             computed), each decode step writes slot pos % W alone (the
             rest bitwise unchanged) with rows within RING_ROW_REL of the
             forward's at pos; ``lm.forward`` at 1 x 4096 (two
             local-attention chunks) finite.  A planned engine
             must refuse and name ``--hand-wired``; the hand-wired
             continuous engine (batch 4, max_len 2304) serves 4 requests
             (64, 512, 2048, 2100 tokens, 4 new) with the counters reset:
             no kernel of the port may launch, each first token is
             ``lm.prefill``'s greedy token on its prompt alone, tokens/s on
             the host clock.  Trained at batch 4 x seq 2048 (RG_GRAD_ACCUM
             micro-batches, remat, fp32 moments, the update program), 3
             steps with the counters reset: finite loss, grad norm > 0,
             every ``lam``, ``gate_a``, ``conv_w`` and ``conv_b`` moved in
             every RG-LRU layer, the AdamW member and the bundle launcher
             launched; ms per step, peak memory, the busy share of one
             profiled step.  Then its ``plan_update_fusion`` plan at 4096
             tokens (the embedding's bf16 dW->AdamW, 256000x4096 @
             4096x2560) run once with the counters reset on seeded state,
             p, m, v bitwise against the two members launched apart, and
             timed beside them, its plain version and its bound.
  8i. deepseek  deepseek-v2-236b at full width (d_model 5120, 128 heads of
             multi-head latent attention, a dense first layer of d_ff
             12288, then MoE layers of 160 experts top-6 with 2 shared
             experts, vocabulary 102400), its depth cut, random weights
             from a seeded torch.Generator.  Served at 8 of 60 layers
             (29.19 B parameters): for 2 prompts of 1020 tokens,
             ``lm.prefill`` and 4 ``lm.decode_step``s against
             ``lm.forward`` of 1024 at the same positions, within
             LOGITS_REL_L2; the (token, choice) pairs the capacity drops
             are counted in the forward and the prefill, and at the
             compared positions, and printed at capacity factor 1.25; where
             any drop, the invariant runs again with the factor raised
             (weights unchanged) until none does, and says so.  After the
             prefill every MLA layer's latent and rope rows below S equal
             the rows the prefill's own layer computed, bitwise, and the
             rest are zero; each decode step writes row pos alone (every
             other row bitwise unchanged), its rows within MLA_ROW_REL of
             the forward's at pos.  ``lm.forward`` at 1 x 2048 (two query
             chunks) finite.  A planned engine must refuse and name
             ``--hand-wired``; the hand-wired continuous engine (batch 4,
             max_len 1024) serves 4 requests (64, 256, 512, 1000 tokens, 4
             new) with the counters reset: no kernel of the port may
             launch, each first token is ``lm.prefill``'s greedy token on
             its prompt alone, tokens/s on the host clock.  Trained at 2
             layers (the dense layer and one MoE layer, 5.36 B
             parameters) at batch 1 x seq 2048, remat, fp32 moments, the
             update program, 3 steps with the counters reset: finite loss,
             grad norm > 0, every ``w_q_a``, ``q_norm``, ``w_kv_a``,
             ``kv_norm``, ``w_k_b``, ``w_v_b``, ``shared_w_in`` and
             ``shared_w_out`` moved, the AdamW member and the bundle
             launcher launched; ms per step, peak memory, the busy share of
             one profiled step.  Then its ``plan_update_fusion`` plan at
             2048 tokens (six bf16 dW->AdamW chains beside the expert
             leaves' AdamW updates, the first 2.5 B elements) run once with
             the counters reset on seeded state, each chain's p, m, v
             bitwise against its two members launched apart, the expert
             w_in leaf's AdamW (2,516,582,400 elements) bitwise against
             its plain version on its last TAIL_ROWS rows, past element
             2**31, and the embedding's chain (102400x2048 @ 2048x5120)
             timed beside them, its plain version and its bound.
  8j. xlstm  xlstm-1.3b at full width and depth (48 layers, mLSTM:sLSTM
             7:1 in 12 runs, d_model 2048, 4 heads, no FFN, LayerNorm,
             vocabulary 50304; 2.90 B parameters), random weights from a
             seeded torch.Generator.  For 2 prompts of 2048 tokens (the
             prefill's mLSTM in chunks of 256, the forward's of 2052 in one
             chunk) and 2 of 2100 (one chunk each) and 2 of 2 (under the
             conv's K - 1 rows), ``lm.prefill`` and 4 ``lm.decode_step``s
             against ``lm.forward`` of S + 4 at the same positions, within
             LOGITS_REL_L2, and every layer's state and conv window after
             them (C, n, m, conv; c, n, m, h, conv) within XL_STATE_REL of
             what ``lm.prefill`` of S + 4 hands off.  ``lm.forward`` at 1 x
             8192 (32 chunks) finite.  A planned engine must refuse and
             name ``--hand-wired``; the hand-wired continuous engine (batch
             8, max_len 1024) serves 8 requests (64..1000 tokens, 16 new)
             with the counters reset: no kernel of the port may launch,
             each first token is ``lm.prefill``'s greedy token on its
             prompt alone, tokens/s on the host clock.  Trained at batch 4
             x seq 2048, remat, fp32 moments, the update program, 3 steps
             with the counters reset: finite loss, grad norm > 0, every
             ``gate_b``, ``b_zifo``, ``r_zifo``, ``out_norm``, ``conv_w``
             and ``conv_b`` moved in every layer, the AdamW member and the
             bundle launcher launched; ms per step, peak memory, one
             profiled step's busy share and kernel launches (a trace of
             the device's events only: a step launches about a million
             kernels), and one sLSTM layer's forward, recompute and
             backward at the step's shape timed and counted alone, times
             6: the sLSTM loop's share of the step.  Then its
             ``plan_update_fusion`` plan at 8192 tokens (eight AdamW
             singles, the w_up and w_v leaves of runs 00, 08, 16 and 24,
             no dW chain) run once with the counters reset on seeded state,
             each single's p, m, v bitwise against its plain version.
  8k. frontends  internvl2-1b (24 layers, d_model 896, 14/2 heads, tied
             vocabulary 151655, 256 image rows from ``pixel_embeds``;
             0.49 B parameters) and musicgen-medium (48 layers, d_model
             1536, 24 heads, LayerNorm, four codebooks of 2048: codes (B,
             4, S); 1.38 B) at full width and depth, random weights, image
             rows and codes from a seeded torch.Generator.  For 2 prompts
             of 1020 tokens and 2 of 2048, ``lm.prefill`` and 4
             ``lm.decode_step``s against ``lm.forward`` at the same
             positions (musicgen: the (B, 4, V) logits), within
             LOGITS_REL_L2; ``lm.forward`` at 1 x 4096 finite.  A planned
             engine must refuse and name ``--hand-wired``, and a
             hand-wired engine's ``run`` raise NotImplementedError (token
             prompts only); greedy serving of 4 prompts of 1000 tokens
             through ``lm.prefill`` and ``lm.serve_step_greedy``, 16 new
             tokens (16 steps of 4 codes), with the counters reset: no
             kernel of the port may launch; tokens/s on the host clock.
             Each trained at batch 4 x seq 2048 as phase 8g's (3 steps,
             the counters reset): internvl2-1b's tied embedding and all
             four of musicgen's codebook tables and its head moved, the
             AdamW member and the bundle launcher launched; ms per step,
             peak memory, one profiled step's busy share.  Each
             ``plan_update_fusion`` plan at 8192 tokens run once with the
             counters reset on seeded state: the dW->AdamW chains (the
             musicgen head's bf16 1536x8192 @ 8192x8192, two fp32 norm
             chains each) bitwise against their members launched apart,
             every AdamW single (the (4, 2048, 1536) codebook tables, the
             tied (151655, 896) embedding among them) bitwise against its
             plain version; the head's chain timed beside its members, its
             plain version and its bound.  The phase's wall printed.
  9. report  one JSON line of kernels (each row also with its kernel's
             launches on every path, ``path_launches``), then the result
             line.

Each main path (paper, update_dw, train, serve, tp2 and tp4 serve, paged,
moe, ops, wavefront, fallback, and 8g's, 8h's, 8i's, 8j's and 8k's serve,
train and update+dW)
runs with every launch counter reset just before it and read just after;
each of its kernels must have launched (the fallback's and 8g-8k's serve:
none may).  Serve, moe and ops also count the activation members their
launches carried, alone and as a chain's consumer (the row family shares
one counter).

Exits with code 1 and no result when no CUDA device is visible, and with
code 2 when the port's sources are not beside it.
"""
from __future__ import annotations

import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# Data-sheet rates of one H100 SXM (dense): device memory bytes/s, bf16 and
# TF32 tensor-core FLOP/s, fp32 FLOP/s outside the tensor cores.
HBM_BYTES_S = 3.35e12
BF16_FLOPS = 989e12
TF32_FLOPS = 495e12
FP32_FLOPS = 67e12

# Full-width granite-3-2b serve shapes of the main path.
B, S, C = 8, 2048, 512
DECODE_LENS = (1, 17, 300, 1024, 2048, 555, 64, 1999)   # mixed per-slot
PREFILL_OFFS = (0, 1024)

# Kernel vs plain: fp32 outputs to 1e-4 absolute plus 1e-3 relative (same
# bf16 products summed in fp32 in another order); bf16 outputs to 2**-7 of
# the largest reference value (fp32 sums may round to a neighbouring bf16).
F32_RTOL, F32_ATOL = 1e-3, 1e-4
BF16_REL = 2.0 ** -7
# First mixed step, kernels vs plain versions through all 40 layers: the
# relative L2 distance of the logits.  Each layer rounds the residual stream
# to bf16 (2**-8 relative) and the two sides sum in different orders, so
# they drift by a few bf16 steps per layer; a wrong kernel gives O(1).
LOGITS_REL_L2 = 5e-2
# A bf16 chain against its plain route (phase 6b): the two round the
# intermediate to bf16 after sums in other orders, so it may differ by one
# bf16 step (up to 2**-7 relative); an fp32 output behind it moves by the
# consumer's response: AdamW's v by (1 - b2) * 2|g| * dg, up to 2**-6 of its
# largest value.  Twice that.
CHAIN_BF16_REL = 2.0 ** -5
# Flash attention (phase 8d) is also held by relative L2 (whole output,
# worst query row): compare()'s limit scales with the causal output's
# largest value (row 0, which is v[0] itself) and is as large as a late
# row's typical value.  The limits are about 10x a sound kernel's reading
# on an H100 at phase 8d's shapes (bf16: whole 2.6e-5..4.1e-5, worst row
# 1.8e-3..2.3e-3; fp32: 2.6e-7..4.5e-7 and 8.7e-7); the bf16 row limit is
# also twice one bf16 step (2**-7) on every element of the row.
FLASH_REL_BF16, FLASH_REL_F32 = (5e-4, 2.0 ** -6), (5e-6, 1e-5)

# Phase 8l: tensor-parallel serve at TP 2 and TP 4, the ranks sharing the
# one card over gloo; a rank's first divergence from one device's tokens
# must sit at a top-2 gap of at most TP_TIE_STEPS bf16 steps (its logits
# move by the all-reduce's other summation order, ~1e-3..1e-2 rel L2).
TP_ARCH = "granite-3-2b"
TP_SHARDS = (2, 4)
TP_TIE_STEPS = 2.0
TP_TIMEOUT_S = 600
SERVE_KERNELS = ("bundle_launcher", "row_member", "decode_attention",
                 "prefill_attention")

# Paged KV (phase 8b): granite-3-2b cut to 1 layer (the reference's paged
# arena is single-layer), 16-row pages, a shared 1024-token prefix.
PAGED_LAYERS, KV_BS, SHARED_PREFIX = 1, 16, 1024
# MoE (phase 8c): phi3.5-moe-rms cut from 32 to 8 layers (32 need 83 GB).
MOE_LAYERS = 8

# Phase 8d: phi3.5-moe's attention heads (32/8, head dim 128) and decode
# expert shape (16 experts, capacity 8, d 4096, d_ff_expert 6400).
PHI_HEADS, PHI_HEAD_DIM = (32, 8), 128
PHI_GMM = (16, 8, 4096, 6400)

# Phase 8e: the executed wavefront step on granite-3-2b cut to 1 layer (the
# reference executes wavefront only on a single-layer run): two waves of 8
# prompts, the second wave's 8 x 512 rows riding the first wave's first
# step as prefill_ffn (M 4096).
WAVE_LAYERS, WAVE_PROMPTS, WAVE_NEW = 1, (256, 512), 8
# Phase 8f: the hand-wired continuous fallback at full depth.
FALLBACK_PROMPTS, FALLBACK_NEW = (64, 200, 350, 512), 4

# Phase 8g: the LayerNorm configs.  Served at full width, full depth, but
# the faithful phi3.5-moe cut from 32 to 8 layers (32 need about 84 GB);
# the reference's invariant on 4 prompts of 256 tokens; the fallback
# serves 4 requests; LayerNorm at starcoder2's width; stablelm-3b trained
# at full width and depth.
LN_SERVE = (("stablelm-3b", 0), ("starcoder2-7b", 0), ("minitron-8b", 0),
            ("phi3.5-moe-42b-a6.6b", 8))
LN_PROMPTS, LN_PROMPT = 4, 256
LN_SERVE_PROMPTS, LN_NEW, LN_MAX_LEN = (64, 200, 350, 512), 4, 1024
LN_NORM_SHAPE = (4 * 2048, 4608)
LN_TRAIN_ARCH, LN_TRAIN_STEPS = "stablelm-3b", 3

# Phase 8h: recurrentgemma-2b at full width and depth (26 layers, RG-LRU
# and local attention of window 2048).  The invariant on 2 prompts of 2048
# tokens (aligned: the first decode step wraps the local-attention ring)
# and 2 of 2100 (misaligned), 4 decode steps each; one forward at 1 x 4096
# (two local-attention chunks); the fallback serves 4 requests; trained at
# batch 4 x seq 2048 in RG_GRAD_ACCUM micro-batches (in one, the tied
# head's fp32 logits, 7.8 GiB a copy, took the card past 80 GB); the
# embedding's dW->AdamW planned at 4096 tokens.
RG_ARCH = "recurrentgemma-2b"
RG_PROMPTS, RG_DECODE, RG_LONG = (2048, 2100), 4, 4096
RG_SERVE_PROMPTS, RG_NEW, RG_MAX_LEN = (64, 512, 2048, 2100), 4, 2304
RG_TRAIN_STEPS, RG_GRAD_ACCUM, RG_DW_TOKENS = 3, 2, 4096
# A decode step's k or v row in a local-attention ring against the same
# position's row of the full forward (bf16, 2 x 256 values a row): the two
# differ by the residual stream's drift over up to 24 layers, a few bf16
# steps; a row of another position (independent random tokens) lies about
# sqrt(2) away.
RING_ROW_REL = 5e-2

# Phase 8i: deepseek-v2-236b at full width, its depth cut: 8 of 60 layers
# served (58.4 GB of bf16 weights; all 60 need 471 GB), 2 trained (the
# dense layer and one MoE layer: params, grads and fp32 moments 64.3 GB).
# Prompts stay at most 1024 tokens or a multiple of 1024: the blockwise
# attention's chunks (the reference asserts the same).
DS_ARCH = "deepseek-v2-236b"
DS_SERVE_LAYERS, DS_TRAIN_LAYERS = 8, 2
DS_PROMPT, DS_DECODE, DS_LONG = 1020, 4, 2048
DS_CAPACITY_FACTORS = (1.5, 2.0, 3.0)     # then E / top_k: none can drop
DS_SERVE_PROMPTS, DS_NEW, DS_MAX_LEN = (64, 256, 512, 1000), 4, 1024
DS_TRAIN_STEPS, DS_TRAIN_SEQ, DS_DW_TOKENS = 3, 2048, 2048
DS_WATCH = ("w_q_a", "w_kv_a", "w_k_b", "w_v_b", "shared_w_in",
            "shared_w_out")
# A decode step's latent (512) or rope (64) row against the same position's
# row of the full forward (bf16): the residual stream's drift over up to 7
# layers, a few bf16 steps (the absorbed path also rounds its query to
# bf16); a row of another position lies about sqrt(2) away.
MLA_ROW_REL = 5e-2
# Phase 8j: xlstm-1.3b at full width and depth (48 layers, 5.8 GB of bf16
# weights: no cut).  The invariant on 2 prompts of 2048 tokens (the
# prefill's mLSTM in chunks of 256, the forward of 2052 in one chunk), 2 of
# 2100 (one chunk each) and 2 of XL_SHORT (under the conv's K - 1 rows), 4
# decode steps each; one forward at 1 x 8192; the fallback serves 8
# requests; trained at batch 4 x seq 2048; the update plan at 8192 tokens.
XL_ARCH = "xlstm-1.3b"
XL_PROMPTS, XL_SHORT, XL_DECODE, XL_LONG = (2048, 2100), 2, 4, 8192
XL_SERVE_PROMPTS = (64, 128, 200, 333, 512, 640, 800, 1000)
XL_NEW, XL_MAX_LEN = 16, 1024
XL_TRAIN_STEPS, XL_DW_TOKENS = 3, 4 * 2048     # the train step's tokens
XL_WATCH = ("gate_b", "b_zifo", "r_zifo", "out_norm", "conv_w", "conv_b")
# Each leaf of a layer's recurrent state and conv window after prefill(S)
# and 4 decode steps against prefill(S + 4)'s, rel L2 (bf16 activations,
# fp32 states): the residual stream's drift over up to 47 layers moves the
# gates and the stabilizers by a few bf16 steps; a stale or misplaced
# handoff (a state a step behind, a conv row out of place) is O(1) off.
XL_STATE_REL = 5e-2
# Phase 8k: the frontend configs at full width and depth (internvl2-1b's
# image stub, 0.49 B parameters; musicgen-medium's four codebooks, 1.38 B;
# no cut).  The invariant on 2 prompts of 1020 tokens and 2 of 2048, each
# past the 256 image rows, 4 decode steps each, against one forward over
# the next multiple of 1024 positions at or past S + 4 (the blockwise
# attention's chunks; causal, so the later positions reach none of those
# held); one forward at 1 x 4096; greedy serving of 4 prompts of 1000
# tokens, 16 new tokens (16 steps of 4 codes); trained at batch 4 x seq
# 2048; the update plan at 8192 tokens (musicgen: the head's bf16
# dW->AdamW and two fp32 norm chains; internvl2-1b: two fp32 norm chains),
# every AdamW single bitwise its plain version.
FE_ARCHS = ("internvl2-1b", "musicgen-medium")
FE_PROMPTS, FE_DECODE, FE_LONG = (1020, 2048), 4, 4096
FE_SERVE_BATCH, FE_SERVE_PROMPT, FE_NEW = 4, 1000, 16
FE_TRAIN_STEPS, FE_DW_TOKENS = 3, 4 * 2048     # the train step's tokens
FE_CHAINS = {"internvl2-1b": (0, 2), "musicgen-medium": (1, 2)}
FE_PARAMS = {"internvl2-1b": 493_753_344, "musicgen-medium": 1_384_418_304}

# Rows (of 128) at the end of an AdamW leaf past BIG_LEAF elements held
# against the plain AdamW after the update+dW program.
BIG_LEAF, TAIL_ROWS = 2 ** 31, 1 << 16

# Full-width granite-3-2b train shapes.
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = 4, 2048, 4
QKV_ROWS = 40 * 2048 * 3072 // 128    # the w_qkv leaf as (R, 128)
ADAM_BM = 1024


class PhaseError(RuntimeError):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise PhaseError(msg)


# ---------------------------------------------------------------------------
# Timing and error helpers
# ---------------------------------------------------------------------------
def compare(torch, got, want) -> float:
    """Hold kernel outputs against the plain outputs; returns max |diff|."""
    worst = 0.0
    for a, b in zip(got, want):
        check(a.shape == b.shape and a.dtype == b.dtype,
              f"output {tuple(a.shape)} {a.dtype} vs {tuple(b.shape)} "
              f"{b.dtype}")
        check(bool(torch.isfinite(a.float()).all()), "non-finite output")
        diff = (a.float() - b.float()).abs()
        err = diff.max().item()
        if a.dtype == torch.bfloat16:
            tol = BF16_REL * b.float().abs().max().item() + 1e-6
            check(err <= tol, f"bf16 output off by {err} > {tol}")
        else:
            lim = (F32_ATOL + F32_RTOL * b.abs()).sub(diff).min().item()
            check(lim >= 0, f"fp32 output off by {err}")
        worst = max(worst, err)
    return worst


def rel_l2_rows(torch, got, want) -> tuple[float, float]:
    """Relative L2 of ``got`` against ``want`` over the whole output, and
    the worst of it over the rows of the last dim."""
    diff, ref = got.float() - want.float(), want.float()
    whole = (diff.norm() / ref.norm()).item()
    rows = (diff.norm(dim=-1) / ref.norm(dim=-1).clamp_min(1e-30)).max()
    return whole, rows.item()


def bound(nbytes: float, flops: float, peak: float) -> tuple[float, str]:
    t_b, t_f = nbytes / HBM_BYTES_S, flops / peak
    return (max(t_b, t_f) * 1e3, "bytes" if t_b >= t_f else "operations")


def kernel_row(path, name, kernel, src, replaces, err, ms, plain_ms, cost,
               peak, lib_ms, **extra) -> dict:
    """One entry of the kernels line; ``path`` names the main path whose
    launch count it reports."""
    b_ms, b_by = bound(cost[0], cost[1], peak)
    print(f"[kernels] {name}: {ms:.4f} ms (plain {plain_ms:.4f}, "
          f"library {lib_ms if lib_ms is None else round(lib_ms, 4)}, "
          f"bound {b_ms:.4f} by {b_by}) max|err| {err:.3g}", flush=True)
    return {"name": name, "path": path, "kernel": kernel, "route": "cuda",
            "source": f"src/repro_torch/csrc/{src}", "replaces": replaces,
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": lib_ms,
            **extra}


def host_us(torch, fn, n: int = 200, reps: int = 5) -> float:
    """Host microseconds a call of ``fn`` takes to queue its work: the
    median over ``reps`` of ``n`` calls in a row, the card synchronised
    before each batch (not after, so the card's time is not counted while
    it keeps up)."""
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        times.append((time.perf_counter() - t0) / n * 1e6)
    torch.cuda.synchronize()
    return statistics.median(times)


def flushed_ms(torch, fn, flush, reps: int = 20) -> float:
    """Median ms of ``fn`` (CUDA events) after a flush that reads the
    ``flush`` buffer instead of zeroing it (``core/timing.py`` median_ms):
    L2 then holds clean lines, so the kernel's misses write nothing back;
    warm, with no flush at all, when ``flush`` is None.  A spin first keeps
    the queue ahead of the events, as in ``median_ms``."""
    from repro_torch.core.timing import SLEEP_CYCLES
    fn()
    torch.cuda.synchronize()
    times = []
    torch.cuda._sleep(SLEEP_CYCLES)
    for _ in range(reps):
        if flush is not None:
            flush.sum()
        s, e = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        s.record()
        fn()
        e.record()
        times.append((s, e))
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in times)


def ulps(torch, a, b) -> int:
    """Largest distance in units in the last place between two tensors of
    one float dtype (0 when bitwise equal)."""
    view = torch.int16 if a.element_size() == 2 else torch.int32
    return int((a.view(view).long() - b.view(view).long()).abs().max())


def decode_cost(H, Hkv, D, bs=0) -> tuple[float, float]:
    """(bytes, flops) decode attention must move / do on DECODE_LENS: each
    slot's valid cache prefix (and, paged, its page-table entries), q, the
    fp32 outputs."""
    kv = sum(2 * L * Hkv * D * 2 + (-(-L // bs) * 4 if bs else 0)
             for L in DECODE_LENS)
    io = B * 4 + B * H * D * 2 + B * H * D * 4 + 2 * B * H * 4
    return kv + io, sum(4.0 * H * D * L for L in DECODE_LENS)


def prefill_cost(off, H, Hkv, D, bs=0) -> tuple[float, float]:
    """(bytes, flops) a C-row prefill chunk at ``off`` must move / do: the
    cache up to its last row (and, paged, the table entries), q, the fp32
    outputs; causal work row by row."""
    n = off + C
    kv = 2 * n * Hkv * D * 2 + (-(-n // bs) * 4 if bs else 0)
    io = 4 + C * H * D * 2 + C * H * D * 4 + 2 * C * H * 4
    return kv + io, sum(4.0 * H * D * (off + r + 1) for r in range(C))


def sdpa_decode(torch, q, k, v):
    """SDPA over DECODE_LENS (the yardstick): q (B,H,D), k, v (B,S,Hkv,D);
    the layout copies are made outside the timed call."""
    import torch.nn.functional as F
    kpos = torch.arange(k.shape[1], device=q.device)
    lens = torch.tensor(DECODE_LENS, device=q.device)
    mask = (kpos[None, :] < lens[:, None]).reshape(B, 1, 1, -1)
    qh, kh, vh = q[:, :, None, :], k.transpose(1, 2), v.transpose(1, 2)
    return lambda: F.scaled_dot_product_attention(qh, kh, vh, attn_mask=mask,
                                                  enable_gqa=True)


def sdpa_static(torch, q, k, v):
    """SDPA of one query a slot over the whole of k, v (the static forms'
    yardstick): q (B,H,D), k, v (B,L,Hkv,D), copies outside the call."""
    import torch.nn.functional as F
    qh, kh = q[:, :, None, :], k.transpose(1, 2).contiguous()
    vh = v.transpose(1, 2).contiguous()
    return lambda: F.scaled_dot_product_attention(qh, kh, vh,
                                                  enable_gqa=True)


def sdpa_prefill(torch, q, k, v, off):
    """SDPA of a C-row chunk at ``off`` (the yardstick): q (C,H,D), k, v
    (S,Hkv,D)."""
    import torch.nn.functional as F
    kpos = torch.arange(k.shape[0], device=q.device)
    mask = kpos[None, :] <= off + torch.arange(C, device=q.device)[:, None]
    qh, kh, vh = (t.transpose(0, 1)[None] for t in (q, k, v))
    return lambda: F.scaled_dot_product_attention(qh, kh, vh, attn_mask=mask,
                                                  enable_gqa=True)


def build_report() -> None:
    """Registers, stack and spills (ptxas, from the build) of the bundle
    kernel's six instances, the tiled matmul and attention kernels and the
    members' non-inlined bodies (the fp32 row GEMM's, RMSNorm's, the hash
    and the ethash body among them; a spill in RMSNorm's, the hash or ethash
    body, hf_paper (the maxpool and hist bodies are inlined there) or
    hf_stream (maxpool's) or the fp32 flash kernel fails the run),
    the tiled matmul's shared memory a CTA; the count of HMMA (mma.sync)
    instructions in each kernel's SASS and in each body inside the bundle
    instances, and of HGMMA (wgmma) in the tiled matmul's, where the
    toolkit has cuobjdump.  Fails if a tensor-core route (bf16 flash, the
    prefill, moe_gmm, bf16 row GEMM and ethash bodies; wgmma in the bf16
    tiled matmul) holds none, or if the fp32 flash kernel, the hash body,
    hf_stream or hf_paper outside its bodies holds any."""
    from repro_torch.kernels import cuda
    use = cuda.ptxas_usage()
    keys = {"hf_bundle<false>": "hf_bundleILb0E",
            "hf_bundle<true>": "hf_bundleILb1E",
            "hf_rows<false>": "hf_rowsILb0E",
            "hf_rows<true>": "hf_rowsILb1E",
            "hf_paper": "hf_paper",
            "hf_stream": "hf_stream",
            "mm_bf16_kernel": "mm_bf16_kernel",
            "mm_f32_kernel": "mm_f32_kernel",
            "flash_mma_kernel<64>": "flash_mma_kernelILi64E",
            "flash_mma_kernel<128>": "flash_mma_kernelILi128E",
            "flash_f32_kernel": "flash_f32_kernel"}
    bodies = {"prefill_mma<64>": "prefill_mmaILi64E",
              "prefill_mma<128>": "prefill_mmaILi128E",
              **{f"moe_gmm_mma<{n}>": f"moe_gmm_mmaILi{n}E"
                 for n in range(1, 6)},
              **{f"row_gemm_mma<{n},{c}>": f"row_gemm_mmaILi{n}ELb{c}E"
                 for n in (1, 2, 4, 8) for c in (0, 1)},
              "decode_split": "decode_split"}
    # RMSNorm's standalone bodies, one per type: neither may spill
    norms = {"row_norm<bf16>": "row_normI13__nv_bfloat16E",
             "row_norm<float>": "row_normIfE"}
    # the fp32 row GEMM's bodies (CUDA cores: no HMMA expected)
    f32 = {"row_gemm_f32<false>": "row_gemm_f32ILb0E",
           "row_gemm_f32<true>": "row_gemm_f32ILb1E"}
    # the paper suite's matmul bodies: the hash body (w in registers, CUDA
    # cores: no HMMA) and the ethash body (3xTF32 on mma.sync); no spill
    hashes = {"hash_member": "11hash_member",
              "ethash_member": "13ethash_member"}
    for label, key in {**keys, **bodies, **norms, **f32, **hashes}.items():
        hits = [v for k, v in use.items() if key in k]
        check(len(hits) <= 1, f"ptxas report: {len(hits)} {label}")
        check(bool(hits), f"ptxas report has no {label}")
        u = hits[0]
        print(f"[build] ptxas {label}: registers {u.get('registers', '-')}, "
              f"stack {u['stack']} B, spill stores {u['spill_stores']} B, "
              f"spill loads {u['spill_loads']} B", flush=True)
        if label in norms or label in hashes or label in (
                "flash_f32_kernel", "hf_paper", "hf_stream"):
            check(u["spill_stores"] == 0 and u["spill_loads"] == 0,
                  f"{label} spills")
    print(f"[build] mm_f32_kernel: {cuda.matmul_smem(True)} B of dynamic "
          f"shared memory a CTA (its cp.async ring); mm_bf16_kernel "
          f"{cuda.matmul_smem(False)} B", flush=True)
    hmma = cuda.sass_counts("HMMA")
    if hmma is None:
        print("[build] SASS: no cuobjdump here: HMMA not checked")
        return
    # kernels by their own entry; a body by its entries inside the two
    # bundle instances ("kernel$body")
    shown = {label: sum(n for f, n in hmma.items()
                        if key in f and ("$" in f) == (label not in keys))
             for label, key in {**keys, **bodies, **hashes}.items()}
    # a kernel's own count includes its non-inlined bodies: hf_paper's
    # outside them is its count less theirs
    paper_out = shown["hf_paper"] - sum(
        n for f, n in hmma.items() if "$" in f and "hf_paper" in f)
    print("[build] SASS HMMA instructions: " + ", ".join(
        f"{k} {v}" for k, v in shown.items())
        + f"; hf_paper outside its bodies {paper_out}", flush=True)
    check(shown["flash_mma_kernel<64>"] > 0
          and shown["flash_mma_kernel<128>"] > 0,
          "the bf16 flash kernels' SASS holds no HMMA")
    check(shown["hf_bundle<false>"] > 0 and shown["hf_bundle<true>"] > 0,
          "the bundle instances' SASS holds no HMMA")
    check(shown["flash_f32_kernel"] == 0,
          "the fp32 flash kernel's SASS holds HMMA (it multiplies in fp32)")
    check(shown["hash_member"] == 0,
          "the hash body's SASS holds HMMA (it multiplies in fp32)")
    check(paper_out == 0, "hf_paper outside its bodies holds HMMA")
    check(shown["hf_stream"] == 0, "hf_stream holds HMMA")
    check(shown["ethash_member"] > 0,
          "the ethash body's SASS holds no HMMA (3xTF32 on mma.sync)")
    for body in bodies:
        if body != "decode_split":
            check(shown[body] > 0, f"the {body} body's SASS holds no HMMA")
    hgmma = cuda.sass_counts("HGMMA")
    wg = {k: sum(n for f, n in hgmma.items() if k in f)
          for k in ("mm_bf16_kernel", "mm_f32_kernel")}
    print("[build] SASS HGMMA instructions: " + ", ".join(
        f"{k} {v}" for k, v in wg.items()), flush=True)
    check(wg["mm_bf16_kernel"] > 0,
          "the bf16 tiled matmul's SASS holds no HGMMA")


class ActTally:
    """While active, counts the activation members (``RowMember`` of sub
    "act", decode_act on the serve paths) that the bundle launches queued,
    alone and as the consumer of a chain (ffn_proj->decode_act): the row
    family shares one launch counter, so these say where the activation
    ran.  Wraps ``cuda.launch``, counting after it returns."""

    def __init__(self, what: str):
        self.what, self.alone, self.chained = what, 0, 0

    def __enter__(self):
        from repro_torch.kernels import cuda, row
        self._cuda, self._launch = cuda, cuda.launch

        def launch(members, *args):
            self._launch(members, *args)
            for m in members:
                if isinstance(m, row.RowMember) and m.sub == "act":
                    self.alone += 1
                elif isinstance(m, row.RowChain) and getattr(
                        m.consumer, "sub", None) == "act":
                    self.chained += 1
        cuda.launch = launch
        return self

    def __exit__(self, *exc):
        self._cuda.launch = self._launch
        print(f"[{self.what}] activation members launched: alone "
              f"{self.alone}, as a chain's consumer {self.chained}",
              flush=True)


def device_profile(torch, run, what: str):
    """``run()`` under torch.profiler: the device's busy share of the wall
    time, its busy seconds and the kernels launched (returned; None, None,
    None when the trace holds no device time), device time by kernel name,
    and the host's CUDA runtime calls (count and host time: the launches,
    and the copies and synchronizations that make the host wait for the
    device).  Only the device's own events (kernels, copies, fills) are
    summed: a CPU op's device time is the same kernels counted again."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_p = time.perf_counter() - t0
    dev_us = [(e.key, e.self_device_time_total) for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA]
    launches = sum(e.count for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA
                   and not e.key.startswith(("Memcpy", "Memset")))
    dev_us = sorted((kv for kv in dev_us if kv[1] > 0), key=lambda kv: -kv[1])
    busy = sum(us for _k, us in dev_us) / 1e6
    if busy:
        print(f"[profile] {what}: device busy {busy:.3f}s of {wall_p:.3f}s "
              f"wall ({busy / wall_p:.1%}); by kernel:")
        for k, us in dev_us[:12]:
            print(f"[profile]   {us / 1e3:10.2f} ms {us / 1e6 / busy:6.1%} "
                  f"{k[:90]}")
        api = sorted(((e.key, e.count, e.cpu_time_total)
                      for e in prof.key_averages()
                      if e.device_type == DeviceType.CPU
                      and e.key.startswith(("cuda", "cu"))),
                     key=lambda r: -r[2])
        print(f"[profile]   host runtime calls: "
              + ", ".join(f"{k} x{n} {us / 1e3:.1f} ms"
                          for k, n, us in api[:5]))
        return busy / wall_p, busy, launches
    print(f"[profile] {what}: no device time in the trace: not measured")
    return None, None, None


def device_events(torch, run, what: str):
    """``run()`` under torch.profiler tracing the device's events only
    (no CPU ops), read from the raw trace without building the profiler's
    event tree, which takes minutes at a million kernels: the busy share
    of the wall time, the busy seconds and the kernels launched (None,
    None, None when the trace holds no device time or this torch keeps
    its raw trace elsewhere)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_p = time.perf_counter() - t0
    try:
        events = prof.profiler.kineto_results.events()
    except AttributeError as e:
        print(f"[profile] {what}: raw trace not readable ({e}): not "
              "measured")
        return None, None, None
    busy_ns, launches = 0, 0
    for e in events:
        if e.device_type() != DeviceType.CUDA:
            continue
        busy_ns += e.end_ns() - e.start_ns()
        launches += not e.name().startswith(("Memcpy", "Memset"))
    if not busy_ns:
        print(f"[profile] {what}: no device time in the trace: not measured")
        return None, None, None
    busy = busy_ns / 1e9
    print(f"[profile] {what}: device busy {busy:.3f}s of {wall_p:.3f}s wall "
          f"({busy / wall_p:.1%}), {launches} kernels", flush=True)
    return busy / wall_p, busy, launches


# ---------------------------------------------------------------------------
# Phase 2b: the paper suite
# ---------------------------------------------------------------------------
def paper_error(ps, got, want, body) -> float:
    """``paper_suite.max_error`` as a phase check."""
    try:
        return ps.max_error(got, want, body)
    except AssertionError as e:
        raise PhaseError(str(e)) from e


def paper_specials(torch, ps, hfuse, g, dev) -> None:
    """maxpool with NaN and +-inf in either row of a pair, hist with NaN,
    +-inf and values past +-4, fp32 and bf16, at their defaults: equal to
    their plain versions, NaN compared equal; a NaN in either row of a pair
    comes out of maxpool, and hist counts every value."""
    nan, inf = float("nan"), float("inf")
    for name in ("maxpool", "hist"):
        for dtype in (torch.float32, torch.bfloat16):
            op, mk, plain = ps.ALL_KERNELS[name](dtype=dtype)
            (x,) = mk(g, dev)
            x[0, 0], x[1, 1], x[2, 2], x[3, 2] = nan, nan, nan, nan
            x[4, 3], x[5, 4], x[6, 5], x[7, 6] = inf, -inf, 9.0, -9.0
            (got,) = hfuse.run_single(op)(x)
            want = plain(x)
            check(got.shape == want.shape and got.dtype == want.dtype
                  and torch.equal(got.isnan(), want.isnan())
                  and torch.equal(got.nan_to_num(), want.nan_to_num()),
                  f"{name} {dtype} with NaN and inf differs from plain")
            if name == "maxpool":
                check(bool(got[0, :2].isnan().all())
                      and bool(got[1, 2].isnan()),
                      f"maxpool {dtype} drops a NaN")
            else:
                check(float(got.sum()) == x.numel(),
                      f"hist {dtype} does not count every value")
    # zeros of both signs in both orders of a pair: +0 wins, bit for bit
    for dtype, bits in ((torch.float32, torch.int32),
                        (torch.bfloat16, torch.int16)):
        op, mk, plain = ps.make_maxpool(dtype=dtype)
        (x,) = mk(g, dev)
        half = x.shape[1] // 2
        x[0::2, :half], x[1::2, :half] = 0.0, -0.0
        x[0::2, half:], x[1::2, half:] = -0.0, 0.0
        x[2, 0], x[3, 0], x[4, 1], x[5, 1] = nan, -0.0, 0.0, -inf
        (got,) = hfuse.run_single(op)(x)
        want = plain(x)
        check(torch.equal(got.view(bits), want.view(bits)),
              f"maxpool {dtype} signed zeros differ from plain in their bits")
        check(not bool((want.signbit() & (want == 0)).any()),
              f"maxpool {dtype} plain version keeps a -0")
    for C, dtype in ((4, torch.float32), (8, torch.bfloat16)):
        for K in (C - 1, C, C + 1, 2 * C + 3):
            op, mk, plain = ps.make_im2col(R=64, C=C, bm=64, K=K,
                                           dtype=dtype)
            (x,) = mk(g, dev)
            check(torch.equal(hfuse.run_single(op)(x)[0], plain(x)),
                  f"im2col C={C} K={K} {dtype} differs from plain")
    print("[paper] maxpool (NaN, +-inf in either row) and hist (NaN, +-inf, "
          "+-9) in fp32 and bf16 equal to their plain versions, NaN "
          "compared equal; maxpool's signed zeros (both orders) bit for bit "
          "the plain version's, fp32 and bf16, no -0 left; im2col at K = "
          "C - 1 .. 2C + 3 (C 4 fp32, C 8 bf16) bitwise equal to its plain "
          "version", flush=True)


def phase_paper(torch, dev) -> tuple[list[dict], dict]:
    from repro_torch.core import autotuner, hfuse
    from repro_torch.kernels import cuda, registry
    from repro_torch.core.timing import flush_buffer, median_ms
    from repro_torch.kernels import paper_suite as ps
    from repro_torch.launch import paper

    flush = flush_buffer(dev)
    g = torch.Generator(device=dev)
    g.manual_seed(1313)
    rows = []

    def record(*args, **extra):
        rows.append(kernel_row("paper", *args, **extra))

    # 1. the atoms against their plain versions, then timed at the defaults
    # (all checks first: they also bring the card to its clocks)
    timed = []
    for name, make in ps.ALL_KERNELS.items():
        dtypes = [torch.float32] + ([torch.bfloat16] if name in (
            "maxpool", "upsample", "im2col", "bnstats", "hist") else [])
        for kw in ({}, ps.SMALL_KW[name]):
            for dtype in dtypes:
                op, mk, plain = make(**kw, dtype=dtype)
                ins = mk(g, dev)
                (got,) = hfuse.run_single(op)(*ins)
                err = paper_error(ps, got, plain(*ins), op.member.body)
                check(torch.equal(got, hfuse.run_single(op)(*ins)[0]),
                      f"{name} differs between two launches")
                if not kw and (dtype == torch.float32 or name in (
                        "bnstats", "maxpool", "hist", "upsample", "im2col")):
                    timed.append((name, op, ins, plain, err))
    paper_specials(torch, ps, hfuse, g, dev)
    for name, op, ins, plain, err in timed:
        run = hfuse.run_single(op)
        x, m = ins[0], op.member
        lib = {"maxpool": lambda: torch.amax(
                   x.view(x.shape[0] // 2, 2, x.shape[1]), dim=1),
               "upsample": lambda: torch.repeat_interleave(x, 2, dim=0)
               }.get(name)
        if name == "im2col":
            # block k is the row rotated left by k (by 0 from k = C on):
            # one gather of K * C columns, its index made outside the call
            C = m.C
            idx = torch.cat([(torch.arange(C, device=dev) + (k if k < C
                              else 0)) % C for k in range(m.param)])
            check(torch.equal(torch.index_select(x, 1, idx), plain(x)),
                  "torch.index_select differs from the plain im2col")

            def lib():
                return torch.index_select(x, 1, idx)
        # ethash_like runs its product as three TF32 products on the
        # tensor cores: its bound is theirs (the fp32 FMA bound is printed)
        cost, peak = (op.hbm_bytes, m.ops), FP32_FLOPS
        if m.body == "ethash_like":
            cost, peak = (op.hbm_bytes, 3 * 2.0 * m.R * m.C * m.C), TF32_FLOPS
        dt = " bf16" if m.dtype == torch.bfloat16 else ""
        record(f"{m.body}:{name}{dt} ({op.ctas} CTAs)", m.kernel,
               "paper_member.cuh", m.kernel.replaces, err,
               median_ms(lambda: run(*ins), flush),
               median_ms(lambda: plain(*ins), flush), cost, peak,
               None if lib is None else median_ms(lib, flush))
        r = rows[-1]
        if m.body == "bnstats":
            # one PyTorch call reading x once for per-column moments: the
            # same bytes, other outputs (variance and mean, not the sums of
            # x and x*x), so it is no library_ms
            vm = median_ms(lambda: torch.var_mean(x, 0, correction=0), flush)
            print(f"[paper] bnstats{dt}: {r['ms']:.4f} ms, "
                  f"{r['bound_ms'] / r['ms']:.1%} of its bound "
                  f"{r['bound_ms']:.4f} ms; same-bytes yardstick "
                  f"torch.var_mean(x, 0, correction=0) {vm:.4f} ms (other "
                  f"outputs, not a library time)", flush=True)
        if m.body in ("maxpool", "upsample", "im2col", "hist"):
            read = flushed_ms(torch, lambda: run(*ins), flush)
            out = torch.empty(op.outputs[0].shape, dtype=op.outputs[0].dtype,
                              device=dev)
            inst, per_sm = cuda.launch_instance([m], [ins], [(out,)])
            extra = ""
            if m.body == "hist" and m.dtype == torch.float32:
                # one PyTorch call reading x once for counts of 128 bins:
                # the same bytes, but it drops values outside [-4, 4] where
                # hist clips them into its end bins, so it is no library_ms
                hc = median_ms(lambda: torch.histc(x, m.param, -4, 4), flush)
                extra = (f"; same-bytes yardstick torch.histc(x, {m.param}, "
                         f"-4, 4) {hc:.4f} ms (drops values outside [-4, 4]: "
                         f"not a library time)")
            elif r["library_ms"] is not None:
                call = {"maxpool": "torch.amax",
                        "upsample": "torch.repeat_interleave",
                        "im2col": "torch.index_select"}[m.body]
                extra = f"; {call} {r['library_ms']:.4f} ms"
            print(f"[paper] {m.body}{dt}: {r['ms']:.4f} ms, "
                  f"{r['bound_ms'] / r['ms']:.1%} of its bound "
                  f"{r['bound_ms']:.4f} ms; after a reading flush "
                  f"{read:.4f} ms; launch runs {inst}, {per_sm} CTAs an SM"
                  f"{extra}", flush=True)
        if m.body == "ethash_like":
            by_bytes = op.hbm_bytes / HBM_BYTES_S * 1e3
            fma = m.ops / FP32_FLOPS * 1e3
            print(f"[paper] ethash_like: {r['ms']:.4f} ms; 3xTF32 bound "
                  f"{r['bound_ms']:.4f} ms ({r['bound_ms'] / r['ms']:.1%}), "
                  f"bytes {by_bytes:.4f} ms ({by_bytes / r['ms']:.1%}), fp32 "
                  f"FMA {fma:.4f} ms ({fma / r['ms']:.1%})", flush=True)
        if m.body == "hash_like":
            rounds = m.param
            print(f"[paper] {name}: {r['ms'] / rounds * 1e3:.3f} us a round "
                  f"({rounds} rounds), {r['bound_ms'] / r['ms']:.1%} of its "
                  f"bound", flush=True)
    first = timed[0]
    del timed
    print("[paper] 9 atoms at the defaults and SMALL_KW (fp32; bf16 where "
          "the kernel takes it) within tolerance of their plain versions",
          flush=True)

    # 2, 3. the path: pairs and triples, counted
    kernels = registry()
    cuda.reset_counts(kernels)
    t0 = time.perf_counter()
    try:
        recs = paper.main(["--pairs", "--triples", "--measure", "gpu"])
    except AssertionError as e:
        raise PhaseError(str(e)) from e
    counts = {k.name: k.launches for k in kernels}
    print(f"[paper] path: {len(recs)} bundles in "
          f"{time.perf_counter() - t0:.1f}s; launches {counts}", flush=True)
    check(len(recs) == 20 and all(r["bitwise"] for r in recs),
          "a fused paper launch differs from run_native")
    for k in ("bundle_launcher", *ps.KERNELS):
        check(counts[k] > 0, f"{k} never launched on the paper path")
    print("[paper] gains over native (card), v5e planning prediction:")
    for r in recs:
        gain = r["gain_pct"]
        print(f"[paper]   {r['bundle']}: vfused {gain['vfused']:+.2f}% "
              f"naive {gain['naive']:+.2f}% planned {r['schedule']} "
              f"{gain['planned']:+.2f}% measured {r['measured_schedule']} "
              f"{gain['measured']:+.2f}%; predicted "
              f"{r['predicted_gain_pct']:.2f}%; smem {r['smem']} B, "
              f"{r['ctas_per_sm']} CTAs/SM")

    # the quickstart pair's vertical and planned launches for the report
    ops, mks, _ = ps.make_bundle(("ethash_like", "blake_like"))
    ins = [t for mk in mks for t in mk(g, dev)]
    vf, native = hfuse.generate_vfused(ops), hfuse.run_native(ops)
    planned = autotuner.search(tuple(ops)).build()
    plain = hfuse.run_native(ops, plain=True)
    want, out_n = plain(*ins), native(*ins)
    # ethash_like's products run on the tensor cores, blake_like's on the
    # fp32 pipe: the launch takes at least the longer of the two, expressed
    # in fp32 operations for bound()
    eth, hsh = (op.member for op in ops)
    tensor = 3 * 2.0 * eth.R * eth.C * eth.C / TF32_FLOPS
    cost = (sum(op.hbm_bytes for op in ops),
            max(hsh.ops, tensor * FP32_FLOPS))
    for what, fused, replaces in (
            ("generate_vfused", vf, "src/repro/core/hfuse.py:152"),
            (f"generate {planned.schedule.label()}", planned,
             "src/repro/core/hfuse.py:87")):
        out = fused(*ins)
        check(all(torch.equal(a, b) for a, b in zip(out, out_n)),
              f"{what} differs from run_native")
        err = max(paper_error(ps, a, b, op.member.body)
                  for op, a, b in zip(ops, out, want))
        record(f"bundle_launcher:{what} ethash_like+blake_like",
               hfuse.BUNDLE, "bundle.cu", replaces, err,
               median_ms(lambda: fused(*ins), flush),
               median_ms(lambda: plain(*ins), flush), cost, FP32_FLOPS,
               None, native_ms=median_ms(lambda: native(*ins), flush))
    # the first atom timed once more, at the phase's end: a spread between
    # the two is the card's state, not the kernel's
    name, op, ins, _plain, _err = first
    again = median_ms(lambda: hfuse.run_single(op)(*ins), flush)
    print(f"[paper] {name} timed again at the end of the phase: "
          f"{again:.4f} ms (first {rows[0]['ms']:.4f} ms)", flush=True)
    del flush, first
    torch.cuda.empty_cache()
    return rows, {"counts": counts, "bundles": recs}


# ---------------------------------------------------------------------------
# Phase 3: kernels at the main-path shapes
# ---------------------------------------------------------------------------
def phase_kernels(torch, dev, cfg, path: str = "serve",
                  tag: str = "") -> list[dict]:
    """The serve members at ``cfg``'s decode shapes; rows named with ``tag``
    after the case, their launches read from ``path``'s run.  With a
    shard's config (``shard_config``) these are one tensor-parallel
    shard's shapes, and the static decode forms, which no path launches,
    are left out."""
    import torch.nn.functional as F

    from repro_torch.core import hfuse
    from repro_torch.core.cost_model import Schedule
    from repro_torch.core.timing import flush_buffer, median_ms
    from repro_torch.kernels import cuda, registry
    from repro_torch.kernels.decode_attention import decode_attention_op
    from repro_torch.serve.engine import PrefillBudget, ServeEngine

    by_name = {k.name: k for k in registry()}
    bundle_k, row_k = by_name["bundle_launcher"], by_name["row_member"]
    dec_k, pf_k = by_name["decode_attention"], by_name["prefill_attention"]
    d, H, Hkv = cfg.d_model, cfg.num_heads, cfg.num_kv_heads
    D, f = cfg.resolved_head_dim, cfg.d_ff
    N_qkv = (H + 2 * Hkv) * D
    budget = PrefillBudget(chunk_rows=C, max_coresident_chunks=2)

    # the main path's own OpSpecs and schedules: the stitched program with
    # two chunks, and the unstitched graph for the standalone members
    def ops_of(stitched: bool, n: int):
        eng = ServeEngine(cfg, None, batch=B, max_len=S, prefill_budget=budget,
                          stitch_epilogues=stitched, device=dev)
        prog = eng.build_decode_program(prefill_chunks=n)
        return prog, {op.name: op for st in prog.steps for op in st.ops}

    prog, ops = ops_of(True, 2)
    _prog0, ops0 = ops_of(False, 0)
    att = next(o for n, o in ops.items() if n.startswith("decode_attn"))
    pfs = sorted((o for n, o in ops.items() if n.startswith("prefill_attn")),
                 key=lambda o: o.name)

    g = torch.Generator(device=dev)
    g.manual_seed(1234)

    def randn(shape, dtype=torch.bfloat16, scale=1.0):
        return (torch.randn(shape, generator=g, device=dev) * scale).to(dtype)

    x = randn((B, d))
    scale1, scale2 = (randn((1, d), torch.float32, 0.1) for _ in range(2))
    w_qkv = randn((d, N_qkv), scale=d ** -0.5)
    w_in = randn((d, 2 * f), scale=d ** -0.5)
    h_ffn = hfuse.run_single(ops0["ffn_proj"], plain=True)(x, w_in)[0]
    lens = torch.tensor(DECODE_LENS, dtype=torch.int32, device=dev)
    q_dec = randn((B, H, D))
    k_cache, v_cache = randn((B, S, Hkv, D)), randn((B, S, Hkv, D))
    q_pf = randn((C, H, D))
    dec_in = (lens.reshape(B, 1), q_dec, k_cache, v_cache)

    def pf_in(off):
        return (torch.full((1, 1), off, dtype=torch.int32, device=dev), q_pf,
                k_cache[3], v_cache[3])

    flush = flush_buffer(dev)
    lib_w1 = (1.0 + scale2).reshape(d).to(torch.bfloat16)

    # bytes/flops each case must move/do, from this run's inputs
    gemm_cost = lambda K, N, out: (K * N * 2 + B * K * 2 + B * out * 2,   # noqa: E731
                                   2.0 * B * K * N)
    norm_cost = (2 * B * d * 2 + d * 4, 4.0 * B * d)
    chain1 = next(o for n, o in ops.items() if n.startswith("decode_norm1"))
    chain2 = next(o for n, o in ops.items() if n.startswith("ffn_proj"))
    cases = [
        # name, kernel, csrc, replaces, op, inputs, (bytes, flops), peak, lib
        ("row_member:decode_norm2", row_k, "row_member.cuh",
         "src/repro/kernels/rmsnorm.py:38", ops["decode_norm2"],
         (x, scale2), norm_cost, FP32_FLOPS,
         lambda: F.rms_norm(x, (d,), lib_w1, 1e-6)),
        ("row_member:qkv_proj", row_k, "row_member.cuh",
         "src/repro/kernels/matmul.py:64", ops0["qkv_proj"], (x, w_qkv),
         gemm_cost(d, N_qkv, N_qkv), BF16_FLOPS, lambda: x @ w_qkv),
        ("row_member:decode_norm1->qkv_proj", row_k, "row_member.cuh",
         "src/repro/core/stitch.py:177", chain1, (x, scale1, w_qkv),
         (gemm_cost(d, N_qkv, N_qkv)[0] + d * 4,
          gemm_cost(d, N_qkv, N_qkv)[1] + 4.0 * B * d), BF16_FLOPS,
         lambda: x @ w_qkv),
        ("row_member:decode_act", row_k, "row_member.cuh",
         "src/repro/kernels/elementwise.py:20", ops0["decode_act"], (h_ffn,),
         (B * 2 * f * 2 + B * f * 2, 8.0 * B * 2 * f), FP32_FLOPS, None),
        ("row_member:ffn_proj->decode_act", row_k, "row_member.cuh",
         "src/repro/core/stitch.py:177", chain2, (x, w_in),
         gemm_cost(d, 2 * f, f), BF16_FLOPS, lambda: x @ w_in),
        ("decode_attention", dec_k, "decode_attention.cuh",
         "src/repro/kernels/decode_attention.py:44", att, dec_in,
         decode_cost(H, Hkv, D), BF16_FLOPS,
         sdpa_decode(torch, q_dec, k_cache, v_cache)),
    ]
    # decode attention's static forms: every slot's valid length a launch
    # constant (a fixed length, or the whole cache), no "len" operand
    for length in (() if tag else (555, None)):
        L = length or S
        st_op = decode_attention_op(B, S, H, Hkv, D, ck=1024, length=length)
        st_in = (q_dec, k_cache, v_cache)
        dyn = hfuse.run_single(att)(torch.full((B, 1), L, dtype=torch.int32,
                                               device=dev), *st_in)
        check(all(torch.equal(a, b) for a, b in zip(
            hfuse.run_single(st_op)(*st_in), dyn)),
            f"static decode attention (length {L}) differs from the "
            f"dynamic form at that length")
        kv_b = 2 * B * L * Hkv * D * 2
        io_b = B * H * D * 2 + B * H * D * 4 + 2 * B * H * 4
        cases.append((
            f"decode_attention:static length={L}", dec_k,
            "decode_attention.cuh",
            "src/repro/kernels/decode_attention.py:44", st_op, st_in,
            (kv_b + io_b, 4.0 * B * H * D * L), BF16_FLOPS,
            sdpa_static(torch, q_dec, k_cache[:, :L], v_cache[:, :L])))
    for off in PREFILL_OFFS:
        cases.append((f"prefill_attention:off={off}", pf_k,
                      "prefill_attention.cuh",
                      "src/repro/kernels/prefill_attention.py:40", pfs[0],
                      pf_in(off), prefill_cost(off, H, Hkv, D), BF16_FLOPS,
                      sdpa_prefill(torch, q_pf, k_cache[3], v_cache[3], off)))

    rows = []

    def record(name, *args, **extra):
        rows.append(kernel_row(path, name + tag, *args, **extra))

    for name, kernel, src, replaces, op, ins, cost, peak, lib in cases:
        run, run_plain = hfuse.run_single(op), hfuse.run_single(op, plain=True)
        err = compare(torch, run(*ins), run_plain(*ins))
        record(name, kernel, src, replaces, err,
               median_ms(lambda: run(*ins), flush),
               median_ms(lambda: run_plain(*ins), flush), cost, peak,
               None if lib is None else median_ms(lib, flush))

    # the host's time to queue one decode launch, and of it the per-launch
    # workspace (split partials, zeroed tickets); beside it qkv_proj's,
    # whose split workspace persists (nothing allocated per launch)
    run = hfuse.run_single(att)
    print(f"[kernels] decode_attention{tag} host: "
          f"{host_us(torch, lambda: run(*dec_in)):.1f} us to queue a launch, "
          f"of which the workspace "
          f"{host_us(torch, lambda: att.member.workspace(dev)):.1f} us",
          flush=True)
    run_qkv = hfuse.run_single(ops0["qkv_proj"])
    print(f"[kernels] qkv_proj{tag} host: "
          f"{host_us(torch, lambda: run_qkv(x, w_qkv)):.1f} us to queue a "
          f"launch ({ops0['qkv_proj'].ctas} CTAs, workspace kept)",
          flush=True)

    # chains: bitwise equal to the two members launched separately
    (c1,) = hfuse.run_single(chain1)(x, scale1, w_qkv)
    (mid,) = hfuse.run_single(ops0["decode_norm1"])(x, scale1)
    check(torch.equal(c1, hfuse.run_single(ops0["qkv_proj"])(mid, w_qkv)[0]),
          "decode_norm1->qkv_proj differs from its separate members")
    (c2,) = hfuse.run_single(chain2)(x, w_in)
    (hk,) = hfuse.run_single(ops0["ffn_proj"])(x, w_in)
    check(torch.equal(c2, hfuse.run_single(ops0["decode_act"])(hk)[0]),
          "ffn_proj->decode_act differs from its separate members")
    print(f"[kernels]{tag} both chains bitwise equal their separate "
          "members")

    # the planner's fused bundles: bitwise equal to run_native
    operands = {att.name: dec_in, pfs[0].name: pf_in(PREFILL_OFFS[0]),
                pfs[1].name: pf_in(PREFILL_OFFS[1]), chain2.name: (x, w_in),
                chain1.name: (x, scale1, w_qkv)}
    costs = {att.name: decode_cost(H, Hkv, D),
             pfs[0].name: prefill_cost(PREFILL_OFFS[0], H, Hkv, D),
             pfs[1].name: prefill_cost(PREFILL_OFFS[1], H, Hkv, D),
             chain2.name: gemm_cost(d, 2 * f, f)}
    fused_steps = [st for st in prog.steps if st.fused]
    check(len(fused_steps) == 2, f"expected 2 fused launches, got "
          f"{[st.members for st in fused_steps]}")
    for st in fused_steps:
        ins = tuple(t for op in st.ops for t in operands[op.name])
        sched = Schedule(tuple(int(r) for r in st.schedule.split(":")))
        fused = hfuse.generate(st.ops, sched)
        native = hfuse.run_native(st.ops)
        plain = hfuse.generate(st.ops, sched, plain=True)
        out_f, out_n = fused(*ins), native(*ins)
        check(all(torch.equal(a, b) for a, b in zip(out_f, out_n)),
              f"fused {st.members} differs from run_native")
        err = compare(torch, out_f, plain(*ins))
        label = "+".join(m.split("_B")[0].split("_C")[0] for m in st.members
                         ).replace("\u2192", "->")
        cost = tuple(sum(costs[op.name][i] for op in st.ops) for i in (0, 1))
        record(f"bundle_launcher:{label} ({st.schedule})", bundle_k,
               "bundle.cu", "src/repro/core/hfuse.py:87", err,
               median_ms(lambda: fused(*ins), flush),
               median_ms(lambda: plain(*ins), flush), cost, BF16_FLOPS,
               None, native_ms=median_ms(lambda: native(*ins), flush))
        # the launch's shared memory per CTA and its CTAs per SM
        per_in, per_out, k, j = [], [], 0, 0
        for op in st.ops:
            per_in.append(ins[k:k + len(op.inputs)])
            per_out.append(out_f[j:j + len(op.outputs)])
            k, j = k + len(op.inputs), j + len(op.outputs)
        smem = cuda.launch_smem([op.member for op in st.ops], per_in,
                                per_out)
        print(f"[kernels] {label}{tag}: launch smem {smem} B, "
              f"{cuda.occupancy(smem)} CTAs/SM", flush=True)
    print(f"[kernels]{tag} fused bundles bitwise equal run_native")
    return rows


# ---------------------------------------------------------------------------
# Phase 4: the AdamW member at the w_qkv leaf
# ---------------------------------------------------------------------------
def _adam_leaf(torch, dev, shape, seed, pdtype):
    """(scalars, p, g, m, v) of one leaf, on the card, from a seed."""
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    p = torch.randn(shape, generator=g, device=dev).mul_(0.02).to(pdtype)
    grad = torch.randn(shape, generator=g, device=dev).mul_(1e-3).to(pdtype)
    m = torch.randn(shape, generator=g, device=dev).mul_(1e-4)
    v = torch.rand(shape, generator=g, device=dev).mul_(1e-7)
    sc = torch.zeros((1, 128), device=dev)
    sc[0, :3] = torch.tensor([3e-4, 1 - 0.9, 1 - 0.95])
    return sc, p, grad, m, v


def phase_adamw(torch, dev) -> list[dict]:
    from repro_torch.core import hfuse
    from repro_torch.core.timing import flush_buffer, median_ms
    from repro_torch.kernels import adam

    bf = torch.bfloat16
    flush = flush_buffer(dev)
    op = adam.adamw_op(QKV_ROWS, bf, ADAM_BM)
    run, run_plain = hfuse.run_single(op), hfuse.run_single(op, plain=True)
    ins = _adam_leaf(torch, dev, (QKV_ROWS, 128), 7, bf)
    ref = tuple(t.clone() for t in ins)
    out, want = run(*ins), run_plain(*ref)
    check(all(o.data_ptr() == ins[i].data_ptr()
              for o, i in zip(out, (1, 3, 4))),
          "adamw outputs are not the donated p, m, v")
    check(all(bool(torch.isfinite(o.float()).all()) for o in out),
          "non-finite adamw output")
    ulp = max(ulps(torch, a, b) for a, b in zip(out, want))
    err = max((a.float() - b.float()).abs().max().item()
              for a, b in zip(out, want))
    print(f"[adamw] w_qkv leaf {tuple(ins[1].shape)} in place: "
          f"{ulp} ULP from the plain version (max|diff| {err:.3g})",
          flush=True)
    check(ulp == 0, f"adamw member differs from its plain version by {ulp} "
          "ULP")
    del ref, want

    # an embedding-shaped leaf: padded to whole blocks, written back
    emb = (49155, 2048)
    a = _adam_leaf(torch, dev, emb, 8, bf)
    b = tuple(t.clone() for t in a)
    sc = a[0]
    adam.multi_tensor_adamw({"e": a[1]}, {"e": a[2]}, {"e": a[3]},
                            {"e": a[4]}, sc, bm=ADAM_BM)
    adam.multi_tensor_adamw({"e": b[1]}, {"e": b[2]}, {"e": b[3]},
                            {"e": b[4]}, sc, bm=ADAM_BM, plain=True)
    check(all(torch.equal(x, y) for x, y in zip(a[1:], b[1:])),
          "padded embedding-shaped update differs from the plain version")
    tail = (49155 * 2048) % (ADAM_BM * 128)
    print(f"[adamw] embedding-shaped leaf {emb}: padded to "
          f"{-(-49155 * 2048 // (ADAM_BM * 128)) * ADAM_BM} rows, tail block "
          f"{tail} real elements, bitwise equal to the plain version")
    del a, b

    ms = median_ms(lambda: run(*ins), flush)
    plain_ms = median_ms(lambda: run_plain(*ins), flush)
    param = torch.nn.Parameter(ins[1].clone())
    param.grad = ins[2].clone()
    lib = torch.optim.AdamW([param], lr=3e-4, betas=(0.9, 0.95), eps=1e-8,
                            weight_decay=0.1, fused=True)
    lib.step()
    st = lib.state[param]
    print(f"[adamw] library: torch.optim.AdamW(fused=True) with param "
          f"{param.dtype}, grad {param.grad.dtype}, exp_avg "
          f"{st['exp_avg'].dtype}, exp_avg_sq {st['exp_avg_sq'].dtype}")
    lib_ms = median_ms(lib.step, flush)
    n = QKV_ROWS * 128
    # not the member's function: PyTorch keeps a bf16 parameter's moments
    # in bf16 (p, g, m, v: 14 B an element moved), the member fp32 moments
    # (22 B); no PyTorch call updates bf16 p with fp32 m and v, so the
    # member's row has no library time
    lib_bytes = n * sum(t.element_size() * k for t, k in (
        (param, 2), (param.grad, 1), (st["exp_avg"], 2),
        (st["exp_avg_sq"], 2)))
    print(f"[adamw] fused torch.optim.AdamW at the same leaf: {lib_ms:.4f} "
          f"ms, moments {st['exp_avg'].dtype} / {st['exp_avg_sq'].dtype}, "
          f"{lib_bytes / n:.0f} B an element moved (the member: 22 B, fp32 "
          "moments): another function, no yardstick", flush=True)
    row = kernel_row("train", f"adamw_member:w_qkv ({QKV_ROWS}x128, bm "
                     f"{ADAM_BM})", adam.ADAMW, "adamw_member.cuh",
                     "src/repro/kernels/adam.py:67", err, ms, plain_ms,
                     (22.0 * n, 12.0 * n), FP32_FLOPS, None, ulp=ulp)
    del ins, param, lib, st
    torch.cuda.empty_cache()
    return [row]


# ---------------------------------------------------------------------------
# Phase 5: measured planning through a schedule cache
# ---------------------------------------------------------------------------
def phase_plan(torch, dev, cfg):
    from repro_torch.core import autotuner, schedule_cache, timing
    from repro_torch.models import lm
    from repro_torch.train import train_loop as tl

    measure = timing.make_measure("gpu")
    path = ROOT / "build" / "repro_torch" / "chip_smoke_schedule_cache.json"
    path.unlink(missing_ok=True)
    abstract = lm.abstract_params(cfg)
    tokens = TRAIN_BATCH * TRAIN_SEQ

    def plans(cache):
        fplan = tl.plan_update_fusion(abstract, tokens=tokens,
                                      measure=measure, cache=cache)
        prog = tl.build_update_program(abstract, measure=measure,
                                       cache=cache)
        return fplan, prog

    n0 = autotuner.SEARCH_COUNT
    t0 = time.perf_counter()
    fplan, prog = plans(schedule_cache.ScheduleCache(path))
    searches = autotuner.SEARCH_COUNT - n0
    print(f"[plan] measured planning ({measure.backend}): {searches} "
          f"searches in {time.perf_counter() - t0:.1f}s", flush=True)
    for title, plan in (("plan_update_fusion", fplan),
                        ("build_update_program", prog.plan)):
        print(f"[plan] {title}:")
        for r in plan.summary():
            print(f"[plan]   {r}")
        for d in plan.fused:
            res = d.result
            deltas = [round(r["cm_vs_measured_delta_pct"], 1)
                      for r in res.table()
                      if r["cm_vs_measured_delta_pct"] is not None]
            print(f"[plan]   {'+'.join(d.members)}: n_measured "
                  f"{res.n_measured}, best {res.best.sched.label()} "
                  f"measured {res.best.measured_s} s, cost-model-vs-measured "
                  f"deltas % {deltas}")
        for r in plan.rejected:
            print(f"[plan]   rejected {r}")
    print(f"[plan] executed update program: {prog.describe()}")
    check(searches > 0, "the first plan searched nothing")

    n1 = autotuner.SEARCH_COUNT
    fplan2, prog2 = plans(schedule_cache.ScheduleCache(path))
    again = autotuner.SEARCH_COUNT - n1
    print(f"[plan] replan from {path.relative_to(ROOT)}: {again} new "
          "searches")
    check(again == 0, f"the cached replan searched {again} bundles")
    check(prog2.describe() == prog.describe()
          and fplan2.summary() == fplan.summary(),
          "the cached replan differs from the measured plan")
    return prog2, fplan2


# ---------------------------------------------------------------------------
# Phase 6: the full-width update bundles
# ---------------------------------------------------------------------------
def _state_trees(torch, dev, cfg):
    """(params, grads, m, v) trees of the full-width model's shapes."""
    from repro_torch import tree as tree_mod
    from repro_torch.models import lm

    abstract = lm.abstract_params(cfg)

    def like(dtype=None):
        return tree_mod.map_tree(lambda a: torch.empty(
            a.shape, dtype=dtype or a.dtype, device=dev), abstract)
    return like(), like(), like(torch.float32), like(torch.float32)


def _fill(torch, dev, trees, seed):
    from repro_torch import tree as tree_mod

    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    p, grad, m, v = (tree_mod.leaves(t) for t in trees)
    for a, b, c, d in zip(p, grad, m, v):
        a.normal_(0, 0.02, generator=g)
        b.normal_(0, 1e-3, generator=g)
        c.normal_(0, 1e-4, generator=g)
        d.uniform_(0, 1e-7, generator=g)


def phase_update_bundles(torch, dev, cfg, program) -> dict:
    from repro_torch import tree as tree_mod
    from repro_torch.core import executor, planner
    from repro_torch.core.timing import flush_buffer, median_ms
    from repro_torch.kernels import adam
    from repro_torch.train.train_loop import UpdateProgram

    plan = program.plan
    native = UpdateProgram(plan, executor.compile_plan(
        planner.FusionPlan(fused=[], singles=[g.op.name for g in plan.graph],
                           rejected=[], graph=plan.graph),
        bindings=program.program.bindings), program.layout, program.hyper)
    lr, bc1, bc2 = (torch.tensor(x, device=dev)
                    for x in (3e-4, 1 - 0.9, 1 - 0.95))
    scalars = torch.zeros((1, 128), device=dev)
    scalars[0, :3] = torch.stack([lr, bc1, bc2])
    A, B = _state_trees(torch, dev, cfg), _state_trees(torch, dev, cfg)

    def same(what):
        for i in (0, 2, 3):                   # params, m, v
            for k, (x, y) in enumerate(zip(tree_mod.leaves(A[i]),
                                           tree_mod.leaves(B[i]))):
                check(torch.equal(x, y), f"{what}: leaf {k} of tree {i} "
                      "differs")

    for T in (A, B):
        _fill(torch, dev, T, 11)
    program(*A, lr=lr, bc1=bc1, bc2=bc2)
    native(*B, lr=lr, bc1=bc1, bc2=bc2)
    same("update program vs run_native")
    print(f"[bundles] full-width update program ({program.describe()}) "
          "bitwise equal to one launch per member", flush=True)

    for T in (A, B):
        _fill(torch, dev, T, 12)
    before = adam.ADAMW.launches
    adam.multi_tensor_adamw(A[0], A[1], A[2], A[3], scalars)
    check(adam.ADAMW.launches == before + 1, "multi_tensor_adamw launched "
          f"{adam.ADAMW.launches - before} times")
    flat = [tree_mod.flatten_with_paths(t) for t in B]
    for (path, p), (_, g), (_, m), (_, v) in zip(*flat):
        adam.multi_tensor_adamw({"x": p}, {"x": g}, {"x": m}, {"x": v},
                                scalars)
    same("multi_tensor_adamw (one 8-member launch) vs 8 singles")
    print(f"[bundles] multi_tensor_adamw: one {len(flat[0])}-member launch "
          "bitwise equal to the singles")
    del B
    torch.cuda.empty_cache()

    flush = flush_buffer(dev)
    n_bytes = sum(leaf.numel() * (3 * leaf.element_size() + 16)
                  for leaf in tree_mod.leaves(A[0]))
    ms = median_ms(lambda: program(*A, lr=lr, bc1=bc1, bc2=bc2), flush)
    params = [torch.nn.Parameter(leaf) for leaf in tree_mod.leaves(A[0])]
    for prm, g in zip(params, tree_mod.leaves(A[1])):
        prm.grad = g
    lib = torch.optim.AdamW(params, lr=3e-4, betas=(0.9, 0.95), eps=1e-8,
                            weight_decay=0.1, fused=True)
    lib.step()
    lib_ms = median_ms(lib.step, flush)
    bound_ms = n_bytes / HBM_BYTES_S * 1e3
    print(f"[bundles] full update ({len(params)} leaves, {n_bytes / 1e9:.2f} "
          f"GB): {ms:.3f} ms, bound {bound_ms:.3f} ms by bytes, "
          f"torch.optim.AdamW(fused=True) {lib_ms:.3f} ms (state in the "
          "param dtype)", flush=True)
    del A, params, lib
    torch.cuda.empty_cache()
    return {"ms": ms, "bound_ms": bound_ms, "library_ms": lib_ms}


# ---------------------------------------------------------------------------
# Phase 6b: the update+dW program and the chain sweep
# ---------------------------------------------------------------------------
def _chain_inputs(torch, op, g, dev="cuda"):
    """Seeded operands of an OpSpec by name: AdamW's scalars, v >= 0, a
    weight at 1/sqrt(fan-in), small norm scales, normals otherwise."""
    ins = []
    for name, o in zip(op.in_names, op.inputs):
        if name == "scalars":
            t = torch.zeros(o.shape, device=dev)
            t[0, :3] = torch.tensor([3e-4, 1 - 0.9, 1 - 0.95])
        elif name == "v":
            t = torch.rand(o.shape, generator=g, device=dev).mul_(1e-6)
        else:
            scale = {"w": o.shape[0] ** -0.5, "scale": 0.1, "p": 0.02,
                     "m": 1e-4}.get(name, 1.0)
            t = (torch.randn(o.shape, generator=g, device=dev)
                 * scale).to(o.dtype)
        ins.append(t)
    return ins


def _io_bytes(ins, outs) -> float:
    """Each input read once, each output written once."""
    return float(sum(t.numel() * t.element_size() for t in (*ins, *outs)))


def f32_split_line(name, g) -> None:
    """The fp32 row GEMM ``g``'s split (kernels/row.py): its K slices and
    CTAs, and the fp32 partials a launch writes and reads back beside the
    weight it streams (worked out from the geometry, not measured)."""
    from repro_torch.kernels import row
    parts = row.gemm_workspace_sizes(g, False)[0] * 4
    print(f"[row_gemm_f32] {name} {g.M}x{g.K}@{g.K}x{g.N}: {g.k_slices} K "
          f"slices of {g.k_slice} rows, {g.ctas} CTAs; partials "
          f"{parts / 1e6:.3f} MB written and read, weight "
          f"{g.K * g.N * 4 / 1e6:.3f} MB", flush=True)


def _sweep_ops(torch, cfg, dt):
    """The chain sweep's ops at granite-3-2b decode width (M = B rows):
    producers and consumers of one dtype, each a whole op at grid 1."""
    import dataclasses

    from repro_torch.kernels import adam, elementwise as el
    from repro_torch.kernels.matmul import matmul_1d_op
    from repro_torch.kernels.rmsnorm import rmsnorm_op
    d, f = cfg.d_model, cfg.d_ff
    ops = {"rmsnorm": rmsnorm_op(B, d, dt, bm=B),
           "resadd": el.residual_add_op(B, d, dt, bm=B),
           "act_gelu": el.activation_op(B, d, d, el.gelu_plain, dt, bm=B),
           "act_silu": el.activation_op(B, 2 * f, f, el.silu_gate, dt, bm=B),
           "W_o": matmul_1d_op(B, d, d, dt, bm=B),
           "gate_up": matmul_1d_op(B, d, 2 * f, dt, bm=B),
           "down": matmul_1d_op(B, f, d, dt, bm=B),
           "adamw": adam.adamw_op(B * d // 128, dt, bm=B * d // 128)}
    return {k: dataclasses.replace(o, name=k) for k, o in ops.items()}


def _chain_cases(torch, cfg):
    """(dtype, producer, consumer, operand) of every pair of the sweep ops
    that the stitching contract accepts; ``down`` only consumes."""
    import dataclasses

    from repro_torch.core import stitch
    cases = []
    for dt in (torch.bfloat16, torch.float32):
        ops = _sweep_ops(torch, cfg, dt)
        for p, pop in ops.items():
            if p in ("down", "adamw"):
                continue
            for c, cop in ops.items():
                if c == p:
                    cop = dataclasses.replace(cop, name=f"{c}_2")
                for name in cop.in_names:
                    if stitch.can_stitch(pop, cop, name) is None:
                        cases.append((dt, pop, cop, name))
    return cases


def _separate(hfuse, pop, cop, name):
    """The chain's two members launched one after the other."""
    n_pi, sidx = len(pop.inputs), cop.in_names.index(name)
    shape = cop.inputs[sidx].shape
    run_p, run_c = hfuse.run_single(pop), hfuse.run_single(cop)

    def run(*ins):
        (mid,) = run_p(*ins[:n_pi])
        rest = ins[n_pi:]
        return run_c(*rest[:sidx], mid.reshape(shape), *rest[sidx:])
    return run


def _chain_label(pop, cop, name, dt):
    return (f"{pop.name}->{cop.name.removesuffix('_2')}.{name} "
            f"{str(dt)[6:]}")


def _update_dw_state(torch, dev, plan, graph, layout, seed):
    """The default-binding state of ``plan``'s program at full width, from
    a seed: each update's (R, 128) p, g (param dtype), m, v (fp32), and
    each dW chain's x^T (d_in, tokens) and dy (tokens, d_out)."""
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    sc = torch.zeros((1, 128), device=dev)
    sc[0, :3] = torch.tensor([3e-4, 1 - 0.9, 1 - 0.95])
    by_name = {gop.op.name: gop.op for gop in graph}
    bufs = {}
    for name, _path, _n, R, _bm in layout:
        dt = by_name[name].inputs[1].dtype
        p, gr = (torch.empty((R, 128), dtype=dt, device=dev)
                 for _ in range(2))
        m, v = (torch.empty((R, 128), device=dev) for _ in range(2))
        p.normal_(0, 0.02, generator=g)
        gr.normal_(0, 1e-3, generator=g)
        m.normal_(0, 1e-4, generator=g)
        v.uniform_(0, 1e-7, generator=g)
        bufs[name] = (p, gr, m, v)
    state = {}
    for gop in plan.graph:
        op = gop.op
        p, gr, m, v = bufs[op.chain[1] if op.chain else op.name]
        state.update({f"{op.name}.scalars": sc, f"{op.name}.p": p,
                      f"{op.name}.m": m, f"{op.name}.v": v})
        if op.chain:
            dw = by_name[op.chain[0]]
            (M, K), N = dw.inputs[0].shape, dw.inputs[1].shape[1]
            dt = dw.inputs[0].dtype
            state[f"{op.name}.x"] = torch.randn(
                (M, K), generator=g, device=dev).to(dt)
            state[f"{op.name}.w"] = (torch.randn(
                (K, N), generator=g, device=dev) * K ** -0.5).to(dt)
        else:
            state[f"{op.name}.g"] = gr
    return state


def compare_chain(torch, got, want, bf16_chain: bool) -> float:
    """A chain against its plain route: ``compare``, except that an fp32
    output of a chain whose intermediate is bf16 (AdamW's m and v behind a
    bf16 gradient) is held to CHAIN_BF16_REL of its largest value."""
    if not bf16_chain:
        return compare(torch, got, want)
    worst = 0.0
    for a, b in zip(got, want):
        if a.dtype == torch.bfloat16:
            worst = max(worst, compare(torch, (a,), (b,)))
            continue
        check(bool(torch.isfinite(a).all()), "non-finite output")
        err = (a - b).abs().max().item()
        tol = CHAIN_BF16_REL * b.abs().max().item() + 1e-12
        check(err <= tol, f"chain output off by {err} > {tol}")
        worst = max(worst, err)
    return worst


# the chain bundle: one chain of each kind that runs only in the bundle
# kernel's chain instance, beside a GEMM prologue chain and the AdamW member
BUNDLE_CHAINS = ("dW_w_o->adamw_w_o.g bfloat16", "W_o->rmsnorm.x bfloat16",
                 "resadd->rmsnorm.x bfloat16", "rmsnorm->gate_up.x bfloat16",
                 "W_o->adamw.g float32", "W_o->rmsnorm.x float32",
                 "rmsnorm->W_o.x float32")


def chain_bundle(torch, dev, cfg, runs, flush) -> None:
    """BUNDLE_CHAINS and the bf16 AdamW update in one fused launch
    (ratios 1), bitwise against run_native of the same members, and timed
    beside it."""
    from repro_torch.core import hfuse
    from repro_torch.core.cost_model import Schedule
    from repro_torch.core.timing import median_ms

    by_label = {_chain_label(pop, cop, name, dt): (chain, ins)
                for dt, pop, cop, name, chain, ins in runs}
    g = torch.Generator(device=dev)
    g.manual_seed(1607)
    upd = _sweep_ops(torch, cfg, torch.bfloat16)["adamw"]
    members = [by_label[k] for k in BUNDLE_CHAINS]
    members.append((upd, _chain_inputs(torch, upd, g, dev)))
    ops = [op for op, _ in members]
    ins = [t for _, i in members for t in i]
    fused = hfuse.generate(ops, Schedule((1,) * len(ops)))
    got = fused(*[t.clone() for t in ins])
    want = hfuse.run_native(ops)(*[t.clone() for t in ins])
    check(len(got) == len(want) and all(
        torch.equal(a, b) for a, b in zip(got, want)),
        "the chain bundle differs from run_native of its members")
    fused_ms = median_ms(lambda: fused(*ins), flush)
    native_ms = median_ms(lambda: hfuse.run_native(ops)(*ins), flush)
    print(f"[update_dw] chain bundle of {len(ops)} members ({fused.n_steps} "
          f"CTAs) bitwise equal to run_native: {fused_ms:.4f} ms fused, "
          f"{native_ms:.4f} ms native", flush=True)


def phase_update_dw(torch, dev, cfg, fplan) -> tuple[list[dict], dict]:
    import dataclasses

    from repro_torch.core import executor, hfuse, stitch
    from repro_torch.core.timing import flush_buffer, median_ms
    from repro_torch.kernels import adam, cuda, registry, row
    from repro_torch.kernels.matmul import matmul_1d_op
    from repro_torch.train import train_loop as tl
    from repro_torch.models import lm

    flush = flush_buffer(dev)
    tokens = TRAIN_BATCH * TRAIN_SEQ
    graph, layout = tl.update_graph(lm.abstract_params(cfg), tokens=tokens,
                                    max_tensors=8, include_dW=True)
    ops = {gop.op.name: gop.op for gop in graph}
    chains = [gop.op for gop in fplan.graph if gop.op.chain]
    check(len(chains) == 2 and all(
        ops[c.chain[0]].member.fp32 for c in chains),
        f"expected the two fp32 dW->adamw chains, got "
        f"{[c.name for c in chains]}")
    program = executor.compile_plan(fplan)
    print(f"[update_dw] program: {program.describe()}", flush=True)

    # the separated launches: each dW GEMM alone, its gradient stored, then
    # the update alone; the updates without a dW as they are
    def separated(state):
        for st in program.steps:
            for op in st.ops:
                args = [state[f"{op.name}.{n}"] for n in op.in_names]
                if not op.chain:
                    hfuse.run_single(op)(*args)
                    continue
                dw, upd = ops[op.chain[0]], ops[op.chain[1]]
                (grad,) = hfuse.run_single(dw)(*args[:2])
                sc, p, m, v = args[2:]
                hfuse.run_single(upd)(sc, p, grad.reshape(p.shape), m, v)

    # the sweep's chains and the bf16 dW->adamw at a layer's W_o shape
    cases = _chain_cases(torch, cfg)
    d = cfg.d_model
    bm = min(256, d)
    wo_dw = matmul_1d_op(d, tokens, d, torch.bfloat16, bm=bm)
    wo_upd = adam.adamw_op(d * d // 128, torch.bfloat16, bm=bm * d // 128)
    cases.append((torch.bfloat16, dataclasses.replace(wo_dw, name="dW_w_o"),
                  dataclasses.replace(wo_upd, name="adamw_w_o"), "g"))
    g = torch.Generator(device=dev)
    g.manual_seed(1606)
    runs = []
    for dt, pop, cop, name in cases:
        chain = stitch.stitch(pop, cop, name)
        runs.append((dt, pop, cop, name, chain,
                     _chain_inputs(torch, chain, g, dev)))

    # the path, counters reset: the full-width program once, each chain once
    st_a = _update_dw_state(torch, dev, fplan, graph, layout, 21)
    st_b = _update_dw_state(torch, dev, fplan, graph, layout, 21)
    kernels = registry()
    torch.cuda.synchronize()
    cuda.reset_counts(kernels)
    program(st_a)
    outs = []
    for dt, pop, cop, name, chain, ins in runs:
        outs.append(hfuse.run_single(chain)(*[t.clone() for t in ins]))
    torch.cuda.synchronize()
    counts = {k.name: k.launches for k in kernels}
    print(f"[update_dw] launches {counts}", flush=True)
    for k in ("bundle_launcher", "row_member", "adamw_member"):
        check(counts[k] > 0, f"{k} never launched on the update+dW path")
    check(counts["row_member"] == len(chains) + len(runs),
          f"row_member launched {counts['row_member']} times, expected "
          f"{len(chains) + len(runs)}")

    # the program bitwise against its separated launches
    separated(st_b)
    for gop in fplan.graph:
        for n in gop.op.out_names:
            key = f"{gop.op.name}.{n}"
            check(torch.equal(st_a[key], st_b[key]), f"update+dW program: "
                  f"{key} differs from the separated launches")
    print(f"[update_dw] program with {len(chains)} dW->adamw chains bitwise "
          f"equal to the separated launches; {program.n_fused} fused "
          "launches", flush=True)
    prog_bytes = sum(_io_bytes([st_a[f"{op.name}.{n}"] for n in op.in_names],
                               [st_a[f"{op.name}.{n}"] for n in op.out_names])
                     for st in program.steps for op in st.ops)
    prog_ms = median_ms(lambda: program(st_a), flush)
    sep_ms = median_ms(lambda: separated(st_b), flush)
    prog_bound = prog_bytes / HBM_BYTES_S * 1e3
    print(f"[update_dw] executed program {prog_ms:.4f} ms, separated "
          f"launches {sep_ms:.4f} ms, bound {prog_bound:.4f} ms by bytes "
          f"({prog_bytes / 1e9:.2f} GB)", flush=True)
    rows = []
    for chain in chains:
        dw, upd = ops[chain.chain[0]], ops[chain.chain[1]]
        f32_split_line(f"{dw.name}->adamw", dw.member)
        ins = [st_a[f"{chain.name}.{n}"] for n in chain.in_names]
        run, plain = hfuse.run_single(chain), hfuse.run_single(chain,
                                                               plain=True)
        err = compare_chain(torch, run(*[t.clone() for t in ins]),
                            plain(*[t.clone() for t in ins]), False)
        rows.append(kernel_row(
            "update_dw", f"row_member:{dw.name}->adamw {str(dw.inputs[0].dtype)[6:]} "
            f"{dw.member.M}x{dw.member.K}@{dw.member.K}x{dw.member.N}",
            row.ROW, "row_member.cuh",
            "src/repro/core/stitch.py:177 (dW matmul->adamw)", err,
            median_ms(lambda: run(*ins), flush),
            median_ms(lambda: plain(*ins), flush),
            (_io_bytes(ins, ins[3:]), dw.flops + upd.flops), FP32_FLOPS,
            None, separate_ms=median_ms(
                lambda: _separate(hfuse, dw, upd, "g")(*ins), flush)))
    del st_a, st_b
    free_card(torch)

    # each chain of the sweep bitwise against its two members, then timed
    for (dt, pop, cop, name, chain, ins), got in zip(runs, outs):
        label = _chain_label(pop, cop, name, dt)
        sep = _separate(hfuse, pop, cop, name)
        want = sep(*[t.clone() for t in ins])
        check(all(torch.equal(a, b) for a, b in zip(got, want)),
              f"chain {label} differs from its separate members")
        run, plain = hfuse.run_single(chain), hfuse.run_single(chain,
                                                               plain=True)
        err = compare_chain(torch, got, plain(*[t.clone() for t in ins]),
                            dt == torch.bfloat16)
        gemm = any(getattr(o.member, "sub", "") == "gemm"
                   for o in (pop, cop))
        peak = BF16_FLOPS if gemm and dt == torch.bfloat16 else FP32_FLOPS
        outs_ = [ins[len(pop.inputs) + i] for i in (1, 2, 3)] \
            if cop.aliases else got
        lib = None
        if gemm and getattr(cop.member, "sub", "") == "resadd":
            x, w, res = ins
            lib = median_ms(lambda: torch.addmm(res, x, w), flush)
        rows.append(kernel_row(
            "update_dw", f"row_member:{label}", row.ROW, "row_member.cuh",
            f"src/repro/core/stitch.py:177 ({pop.name}->{cop.name})", err,
            median_ms(lambda: run(*ins), flush),
            median_ms(lambda: plain(*ins), flush),
            (_io_bytes(ins, outs_), chain.flops), peak, lib,
            separate_ms=median_ms(lambda: sep(*ins), flush)))
    print(f"[update_dw] {len(runs)} chains bitwise equal their separate "
          "members", flush=True)

    # row e, fp32 at decode width: gate+up alone (8 x 2048 @ 2048 x 16384)
    sweep32 = _sweep_ops(torch, cfg, torch.float32)
    for name in ("W_o", "gate_up", "down"):
        f32_split_line(name, sweep32[name].member)
    op = sweep32["gate_up"]
    x, w = _chain_inputs(torch, op, g, dev)
    run, plain = hfuse.run_single(op), hfuse.run_single(op, plain=True)
    got = run(x, w)
    err = compare(torch, got, plain(x, w))
    check(all(torch.equal(a, b) for a, b in zip(got, run(x, w))),
          "row_member:gate_up float32 differs between two launches")
    gm = op.member
    rows.append(kernel_row(
        "update_dw", f"row_member:gate_up float32 {gm.M}x{gm.K}@{gm.K}x"
        f"{gm.N}", row.ROW, "row_member.cuh",
        "src/repro/kernels/matmul.py:64 (float32)", err,
        median_ms(lambda: run(x, w), flush),
        median_ms(lambda: plain(x, w), flush),
        (_io_bytes((x, w), got), op.flops), FP32_FLOPS,
        median_ms(lambda: torch.matmul(x, w), flush)))
    del x, w, got
    chain_bundle(torch, dev, cfg, runs, flush)
    del runs, outs
    free_card(torch)
    return rows, {"counts": counts, "program_ms": prog_ms,
                  "separated_ms": sep_ms, "bound_ms": prog_bound}


# ---------------------------------------------------------------------------
# Phase 7: train full-width granite-3-2b
# ---------------------------------------------------------------------------
class UpdateProbe:
    """Wraps the update program: CUDA events around every call and, on the
    first call, the executed update held bitwise against the plain update
    on the first and last block of every leaf."""

    def __init__(self, torch, program):
        self.torch = torch
        self.program = program
        self.hyper = program.hyper
        self.events = []
        self.checked = 0

    def __call__(self, params, grads, m, v, *, lr, bc1, bc2):
        from repro_torch import tree as tree_mod
        from repro_torch.kernels.adam import plain_adamw
        from repro_torch.train.optimizer import scalars_of

        def flat(trees):
            return [[x.reshape(-1) for x in tree_mod.leaves(t)]
                    for t in trees]

        torch = self.torch
        snaps = []
        if not self.events:
            sc = scalars_of(lr, bc1, bc2)
            before = flat((params, grads, m, v))
            for i, (name, _path, n, R, bm) in enumerate(self.program.layout):
                for a, b in ((0, min(bm * 128, n)), ((R - bm) * 128, n)):
                    snaps.append((name, i, a, b,
                                  [f[i][a:b].clone() for f in before]))
        s, e = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        s.record()
        out = self.program(params, grads, m, v, lr=lr, bc1=bc1, bc2=bc2)
        e.record()
        self.events.append((s, e))
        after = flat(out) if snaps else None
        for name, i, a, b, ins in snaps:
            want = plain_adamw(sc, *ins, **self.hyper)
            got = [f[i][a:b] for f in after]
            check(all(torch.equal(x, y) for x, y in zip(got, want)),
                  f"executed update of {name}[{a}:{b}] differs from the "
                  "plain update")
            self.checked += 1
        return out


def phase_train(torch, dev, cfg, program) -> dict:
    from repro_torch import tree as tree_mod
    from repro_torch.data.pipeline import DataConfig, TokenPipeline
    from repro_torch.kernels import cuda, registry
    from repro_torch.models import lm
    from repro_torch.train import optimizer as opt_mod
    from repro_torch.train.train_loop import TrainConfig, make_train_step

    t0 = time.perf_counter()
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    params = lm.init(cfg, gen, device=dev)
    opt_state = opt_mod.init(params)
    ocfg = opt_mod.AdamWConfig(lr=3e-4, warmup_steps=1,
                               total_steps=TRAIN_STEPS)
    probe = UpdateProbe(torch, program)
    step_fn = make_train_step(cfg, TrainConfig(optimizer=ocfg, remat=True),
                              update_program=probe)
    data = TokenPipeline(DataConfig(vocab_size=cfg.vocab_size,
                                    seq_len=TRAIN_SEQ,
                                    global_batch=TRAIN_BATCH))
    torch.cuda.synchronize()
    print(f"[train] weights + moments: {time.perf_counter() - t0:.1f}s, "
          f"{sum(t.numel() for t in tree_mod.leaves(params)):,} params",
          flush=True)

    kernels = registry()
    cuda.reset_counts(kernels)
    torch.cuda.reset_peak_memory_stats(dev)
    tokens = TRAIN_BATCH * TRAIN_SEQ
    steps = []
    t_run = time.perf_counter()
    for step in range(TRAIN_STEPS):
        before = {k.name: k.launches for k in kernels}
        batch = {k: torch.from_numpy(v).to(dev)
                 for k, v in data.batch_at(step).items()}
        t0 = time.perf_counter()
        params, opt_state, met = step_fn(params, opt_state, batch, step)
        loss = float(met["loss"])
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        s, e = probe.events[-1]
        upd_ms = s.elapsed_time(e)
        launched = {k.name: k.launches - before[k.name] for k in kernels}
        peak = torch.cuda.max_memory_allocated(dev) / 2 ** 30
        steps.append({"loss": loss, "ms": dt * 1e3, "update_ms": upd_ms,
                      "launches": launched})
        print(f"[train] step {step}: loss {loss:.4f} gnorm "
              f"{float(met['grad_norm']):.3f}, {dt * 1e3:.1f} ms, "
              f"{tokens / dt:.1f} tokens/s, update {upd_ms:.3f} ms device "
              f"in {launched['bundle_launcher']} launches, peak "
              f"{peak:.2f} GiB", flush=True)
        check(math.isfinite(loss), f"non-finite loss at step {step}")
    wall = time.perf_counter() - t_run
    counts = {k.name: k.launches for k in kernels}

    def one_more_step():
        nonlocal params, opt_state
        batch = {k: torch.from_numpy(v).to(dev)
                 for k, v in data.batch_at(TRAIN_STEPS).items()}
        params, opt_state, met = step_fn(params, opt_state, batch,
                                         TRAIN_STEPS)
        check(math.isfinite(float(met["loss"])), "non-finite profiled loss")

    # one more step under torch.profiler (counts already read)
    device_profile(torch, one_more_step, "train step")
    print(f"[train] {TRAIN_STEPS} steps in {wall:.3f}s "
          f"({TRAIN_STEPS * tokens / wall:.1f} tokens/s); first-step update "
          f"checked on {probe.checked} blocks; launches {counts}")
    check(probe.checked == 2 * len(program.layout),
          "the first-step update check did not run")
    for name in ("bundle_launcher", "adamw_member"):
        check(counts[name] > 0, f"{name} never launched in training")
    peak = torch.cuda.max_memory_allocated(dev) / 2 ** 30
    check(peak < 80, f"peak memory {peak:.1f} GiB")
    del params, opt_state, step_fn, probe
    torch.cuda.empty_cache()
    return {"counts": counts, "steps": steps, "seconds": wall,
            "peak_gib": peak}


# ---------------------------------------------------------------------------
# Phase 8: serve full-width granite-3-2b
# ---------------------------------------------------------------------------
def mixed_step_rows(torch, kv, pos, active, kw, C):
    """The k or v rows of a stacked (L, B, S, Hkv, D) cache that a step
    with positions ``pos`` wrote: each decoding slot's row at its position,
    then each riding chunk's C rows, as (L, rows, Hkv, D)."""
    parts = [kv[:, b, int(pos[b])][:, None]
             for b in range(kv.shape[1]) if bool(active[b])]
    parts += [kv[:, s, o:o + C] for s, o in zip(kw["ch_slots"],
                                                kw["ch_offs"])]
    return torch.cat(parts, 1)


def capture_first_mixed(eng) -> dict:
    """Wrap ``eng``'s step factory so the first step that decodes and
    carries a chunk keeps a copy of its inputs and its logits (kernels
    path): ``captured["inputs"]``, ``captured["out"]``, and the k and v
    rows it wrote (``captured["written"]``, a stacked run's cache)."""
    import torch

    from repro_torch.models import lm
    captured = {}
    make_step = eng._cb_step
    run = lm.layer_runs(eng.cfg)[0]

    def cb_step(n):
        step = make_step(n)

        def wrapped(params_, cache, tokens, active, **kw):
            first = n and "inputs" not in captured and bool(active.any())
            if first:
                captured["inputs"] = (
                    n, {"pos": cache["pos"].clone(),
                        **{k: {kk: vv.clone() for kk, vv in v.items()}
                           for k, v in cache.items() if k != "pos"}},
                    tokens.clone(), active.clone(), dict(kw))
            out = step(params_, cache, tokens, active, **kw)
            if first:
                captured["out"] = (out[0].clone(), out[2].clone())
                if run.count > 1:
                    pos = captured["inputs"][1]["pos"]
                    captured["written"] = {
                        k: mixed_step_rows(torch, out[1][run.name][k], pos,
                                        active, kw, eng.chunk_rows)
                        for k in ("k", "v")}
            return out
        return wrapped

    eng._cb_step = cb_step
    return captured


def first_mixed_vs_plain(torch, captured, ref, what: str) -> dict:
    """The captured first mixed step again, from ``ref``'s plain versions
    on the card: relative L2 of the decode and prefill logits, within
    ``LOGITS_REL_L2``."""
    check("out" in captured, "no mixed step ran")
    n, cache, tokens_t, active, kw = captured["inputs"]
    logits_k, pf_k = captured["out"]
    out = ref._cb_step(n)(ref.params, cache, tokens_t, active, **kw)
    rel = {}
    for name, a, b in (("decode", logits_k, out[0]),
                       ("prefill", pf_k, out[2])):
        check(bool(torch.isfinite(a).all()), f"non-finite {name} logits")
        check(a.shape == b.shape, f"{name} logits shape {a.shape} {b.shape}")
        rel[name] = ((a - b).norm() / b.norm()).item()
        agree = (a.argmax(-1) == b.argmax(-1)).float().mean().item()
        print(f"[{what}] first mixed step ({n} chunks) {name} logits "
              f"{tuple(a.shape)}: rel L2 {rel[name]:.3e} "
              f"(limit {LOGITS_REL_L2}), max|diff| "
              f"{(a - b).abs().max().item():.4g}, argmax agreement {agree:.3f}")
        check(rel[name] <= LOGITS_REL_L2,
              f"{what}: {name} logits off the plain step: rel L2 "
              f"{rel[name]}")
    return rel


def phase_serve(torch, dev, cfg) -> dict:
    from repro_torch.kernels import cuda, registry
    from repro_torch.models import lm
    from repro_torch.serve.engine import PrefillBudget, Request, ServeEngine

    t0 = time.perf_counter()
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    params = lm.init(cfg, gen, device=dev)
    budget = PrefillBudget(chunk_rows=C, max_coresident_chunks=2)
    eng = ServeEngine(cfg, params, batch=B, max_len=S, prefill_budget=budget,
                      device=dev)
    torch.cuda.synchronize()
    print(f"[serve] weights + plan: {time.perf_counter() - t0:.1f}s; plan "
          f"{eng.fusion_plan.summary()}", flush=True)

    def requests():
        return serve_requests(cfg, Request)

    reqs = requests()
    captured = capture_first_mixed(eng)
    kernels = registry()
    cuda.reset_counts(kernels)
    t0 = time.perf_counter()
    with ActTally("serve"):
        eng.run(reqs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = {k.name: k.launches for k in kernels}
    st = eng.stats
    tokens = sum(len(r.out_tokens) for r in reqs)
    print(f"[serve] {len(reqs)} requests, {tokens} tokens in {wall:.3f}s "
          f"({tokens / wall:.2f} tok/s)")
    print(f"[serve] stats {st.describe()}")
    print(f"[serve] launches {counts}")
    print(f"[serve] programs {eng.cb_program_info.get(2, {}).get('steps')}")
    check(all(counts[k] > 0 for k in SERVE_KERNELS),
          f"a kernel of the serve path never launched: {counts}")
    check(st.fused_prefill_chunks > 0 and st.fused_mixed_steps > 0,
          "no fused launch carried a prefill chunk")
    check(all(len(r.out_tokens) == r.max_new_tokens for r in reqs),
          "a request retired early")
    check(all(0 <= t < cfg.vocab_size for r in reqs for t in r.out_tokens),
          "token out of the vocabulary")

    # phase 8l's copy of the first mixed step, taken before the plain step
    # below writes its rows into the captured cache and advances its pos
    snap = first_mixed_snapshot(eng, captured)
    # the first mixed step again, from the plain versions on the card
    ref = ServeEngine(cfg, params, batch=B, max_len=S, prefill_budget=budget,
                      device=dev, plain=True)
    rel = first_mixed_vs_plain(torch, captured, ref, "serve")

    # the same trace again under torch.profiler: device time by kernel name
    # and the device's busy share of the wall time (counts already read)
    device_profile(torch, lambda: eng.run(requests()), "serve trace")
    return {"counts": counts, "tokens": tokens, "seconds": wall,
            "tokens_per_s": tokens / wall, "logits_rel_l2": rel,
            "out_tokens": [r.out_tokens for r in reqs], "first_mixed": snap}


def serve_requests(cfg, Request) -> list:
    """Phase 8's trace: 12 requests, prompts of 64..1500 tokens arriving
    every other step, 8..16 new tokens, from numpy seed 0."""
    import numpy as np
    rng = np.random.default_rng(0)
    lens = np.linspace(64, 1500, 12).round().astype(int)
    return [Request(rid=i, prompt=rng.integers(0, cfg.vocab_size,
                                               L).astype(np.int32),
                    max_new_tokens=8 + (3 * i) % 9, arrival=2 * i)
            for i, L in enumerate(lens)]


def first_mixed_snapshot(eng, captured) -> dict:
    """The captured first mixed step on the host, for phase 8l's ranks:
    its inputs (the cache's rows up to the last one the step reads or
    writes), its logits and the k/v rows it wrote."""
    from repro_torch.models import lm
    n, cache, tokens, active, kw = captured["inputs"]
    run = lm.layer_runs(eng.cfg)[0].name
    pos = cache["pos"]
    rows = max([int(pos[b]) + 1 for b in range(len(pos)) if bool(active[b])]
               + [o + eng.chunk_rows for o in kw["ch_offs"]])
    return {"n": n, "pos": pos.cpu(), "tokens": tokens.cpu(),
            "active": active.cpu(), "rows": rows,
            "kw": {**kw, "ch_tokens": kw["ch_tokens"].cpu()},
            "cache": {k: cache[run][k][:, :, :rows].cpu()
                      for k in ("k", "v")},
            "logits": captured["out"][0].cpu(),
            "pf_logits": captured["out"][1].cpu(),
            "written": {k: v.cpu() for k, v in captured["written"].items()}}


def free_card(torch) -> None:
    """Return the last phase's weights and caches to the card."""
    import gc
    gc.collect()
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# Phase 8l: tensor-parallel serve, full-width granite-3-2b, ranks on one card
# ---------------------------------------------------------------------------
def shard_config(cfg, n: int):
    """The config whose single-device decode graph is one shard's of n-way
    tensor parallelism (H/n and Hkv/n heads, d_ff/n FFN columns, the head
    dim kept): its members run at the shard's shapes."""
    import dataclasses
    return dataclasses.replace(cfg, num_heads=cfg.num_heads // n,
                               num_kv_heads=cfg.num_kv_heads // n,
                               d_ff=cfg.d_ff // n,
                               head_dim=cfg.resolved_head_dim)


def top2_steps(torch, logits) -> float:
    """A logits row's top-2 gap in bf16 steps: units in the last place of
    a bf16 number at the top logit's magnitude."""
    top = logits.float().topk(2).values.tolist()
    step = 2.0 ** (math.floor(math.log2(abs(top[0]) or 2.0 ** -126)) - 7)
    return (top[0] - top[1]) / step


def tp_rank(mesh, snap_path: str) -> dict:
    """One rank of phase 8l, in a process of its own (``launch/mesh.py``
    ``run_ranks``): phase 8's weights (the same seeded draw) sliced to the
    rank's slab, the first mixed step of phase 8 again from its captured
    cache rows of the rank's heads and its tokens (kernels, then plain
    versions), then phase 8's trace served with the launch counters reset
    just before and read just after, every token's top-2 gap recorded."""
    import gc

    import torch
    import torch.distributed as dist

    from repro_torch.configs import get_config
    from repro_torch.kernels import cuda, registry
    from repro_torch.models import lm
    from repro_torch.serve.engine import PrefillBudget, Request, ServeEngine

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    on_card = mesh.device_type == "cuda"
    dev = (torch.device("cuda", torch.cuda.current_device()) if on_card
           else torch.device("cpu"))
    cfg = get_config(TP_ARCH)
    budget = PrefillBudget(chunk_rows=C, max_coresident_chunks=2)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    params = lm.init(cfg, gen, device=dev)
    eng = ServeEngine(cfg, params, batch=B, max_len=S, prefill_budget=budget,
                      device=dev, mesh=mesh)
    del params                          # the rank keeps its slab only
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
    plain = ServeEngine(cfg, None, batch=B, max_len=S, prefill_budget=budget,
                        device=dev, mesh=mesh, plain=True)
    n, rank = eng.tp_shards, mesh.get_local_rank("model")
    hk = cfg.num_kv_heads // n
    heads = slice(rank * hk, (rank + 1) * hk)
    run = lm.layer_runs(cfg)[0].name
    snap = torch.load(snap_path, map_location=dev)
    kw = snap["kw"]

    def first_mixed(e):
        cache = e._init_slot_cache()
        for k in ("k", "v"):
            cache[run][k][:, :, :snap["rows"]] = \
                snap["cache"][k][..., heads, :]
        cache["pos"] = snap["pos"].clone()
        return e._cb_step(snap["n"])(eng._step_params, cache, snap["tokens"],
                                     snap["active"], **kw)

    out = first_mixed(eng)
    teacher = {"decode": rel_l2(out[0], snap["logits"]),
               "prefill": rel_l2(out[2], snap["pf_logits"])}
    for k in ("k", "v"):
        got = mixed_step_rows(torch, out[1][run][k], snap["pos"],
                              snap["active"], kw, C)
        teacher[f"{k} rows"] = rel_l2(got, snap["written"][k][..., heads, :])
    pout = first_mixed(plain)
    vs_plain = {"decode": rel_l2(out[0], pout[0]),
                "prefill": rel_l2(out[2], pout[2])}
    del snap, out, pout
    gc.collect()

    reqs = serve_requests(cfg, Request)
    gaps: dict = {}
    sample = eng._sample

    def recorded(logits, greedy, req):
        gaps.setdefault(req.rid, []).append(top2_steps(torch, logits))
        return sample(logits, greedy, req)

    eng._sample = recorded
    kernels = registry()
    if on_card:
        torch.cuda.synchronize()
    cuda.reset_counts(kernels)
    t1 = time.perf_counter()
    eng.run(reqs)
    if on_card:
        torch.cuda.synchronize()
    serve_s = time.perf_counter() - t1
    st = eng.stats
    return {"rank": rank, "backend": dist.get_backend(eng._tp_group),
            "teacher": teacher, "vs_plain": vs_plain,
            "tokens": [r.out_tokens for r in reqs], "gaps": gaps,
            "stats": st.describe(),
            "steps": st.decode_steps + st.prefill_only_steps,
            "allreduces": (eng.allreduce_calls, eng.allreduce_bytes),
            "peak_gib": (torch.cuda.max_memory_allocated(dev) / 2 ** 30
                         if on_card else 0.0),
            "serve_s": serve_s, "rank_s": time.perf_counter() - t0,
            "counts": {k.name: k.launches for k in kernels}}


def tp_report(n: int, ranks: list, single_tokens: list) -> dict:
    """Phase 8l's checks and printout for one shard count."""
    r0 = ranks[0]
    for r in ranks:
        print(f"[tp{n}] rank {r['rank']}: backend {r['backend']}, first "
              f"mixed step from phase 8's cache and tokens: rel L2 "
              + ", ".join(f"{k} {v:.3e}" for k, v in r["teacher"].items())
              + f" (limit {LOGITS_REL_L2}); against its plain version: "
              + ", ".join(f"{k} {v:.3e}" for k, v in r["vs_plain"].items())
              + f"; peak {r['peak_gib']:.2f} GiB; served in "
              f"{r['serve_s']:.3f}s, rank {r['rank_s']:.1f}s", flush=True)
        check(all(v <= LOGITS_REL_L2 for v in r["teacher"].values()),
              f"tp{n} rank {r['rank']}: first mixed step off one device's: "
              f"{r['teacher']}")
        check(all(v <= LOGITS_REL_L2 for v in r["vs_plain"].values()),
              f"tp{n} rank {r['rank']}: first mixed step off its plain "
              f"version: {r['vs_plain']}")
        check(r["tokens"] == r0["tokens"] and r["stats"] == r0["stats"],
              f"tp{n} rank {r['rank']} served other tokens or stats than "
              "rank 0")
        check(all(r["counts"][k] > 0 for k in SERVE_KERNELS),
              f"tp{n} rank {r['rank']}: a kernel of the serve path never "
              f"launched: {r['counts']}")
    check(r0["stats"]["fused_mixed_steps"] > 0,
          f"tp{n}: no fused launch carried a prefill chunk")
    # agreement with one device: a request's first divergence must be a
    # near-tie, its top-2 gap at most TP_TIE_STEPS bf16 steps
    same = total = 0
    firsts = []
    for rid, (a, b) in enumerate(zip(r0["tokens"], single_tokens)):
        total += len(b)
        same += sum(x == y for x, y in zip(a, b))
        i = next((i for i, (x, y) in enumerate(zip(a, b)) if x != y), None)
        if i is not None:
            firsts.append((rid, i, r0["gaps"][rid][i]))
    print(f"[tp{n}] tokens agreeing with one device: {same}/{total} "
          f"({same / total:.3f}); first divergences (request, token, top-2 "
          f"gap in bf16 steps): {firsts}", flush=True)
    check(all(len(a) == len(b) for a, b in zip(r0["tokens"], single_tokens)),
          f"tp{n}: a request served another number of tokens")
    check(all(gap <= TP_TIE_STEPS for _r, _i, gap in firsts),
          f"tp{n}: a first divergence from one device is no near-tie: "
          f"{firsts}")
    calls, nbytes = r0["allreduces"]
    tokens = sum(len(t) for t in r0["tokens"])
    print(f"[tp{n}] {r0['backend']}: {calls / r0['steps']:.1f} all-reduces "
          f"and {nbytes / r0['steps'] / 2 ** 20:.2f} MiB a step a rank "
          f"({r0['steps']} steps); {tokens} tokens in {r0['serve_s']:.3f}s "
          f"({tokens / r0['serve_s']:.2f} tok/s; ranks share one card, so "
          f"no measure of tensor-parallel speed); stats {r0['stats']}",
          flush=True)
    return {"counts": {k: sum(r["counts"][k] for r in ranks)
                       for k in r0["counts"]},
            "agreement": same / total, "firsts": firsts,
            "teacher": [r["teacher"] for r in ranks],
            "vs_plain": [r["vs_plain"] for r in ranks],
            "allreduces_a_step": calls / r0["steps"],
            "mib_a_step": nbytes / r0["steps"] / 2 ** 20,
            "peak_gib": [r["peak_gib"] for r in ranks],
            "tokens_per_s": tokens / r0["serve_s"], "backend": r0["backend"]}


def phase_tp(torch, dev, cfg, serve) -> tuple[list[dict], dict]:
    import tempfile

    from repro_torch.launch.mesh import run_ranks

    rows, runs = [], {}
    with tempfile.TemporaryDirectory() as tmp:
        snap_path = str(Path(tmp) / "first_mixed.pt")
        torch.save(serve["first_mixed"], snap_path)
        for n in TP_SHARDS:
            # the members at the shard's shapes, in this process
            rows += phase_kernels(torch, dev, shard_config(cfg, n),
                                  path=f"tp{n}_serve", tag=f" tp{n}")
            free_card(torch)
            t0 = time.perf_counter()
            ranks = run_ranks(tp_rank, n, (snap_path,), device_type="cuda",
                              timeout=TP_TIMEOUT_S)
            runs[n] = tp_report(n, ranks, serve["out_tokens"])
            runs[n]["wall"] = time.perf_counter() - t0
            print(f"[tp{n}] {n} ranks in {runs[n]['wall']:.1f}s", flush=True)
    return rows, runs


# ---------------------------------------------------------------------------
# Phase 8b: paged KV with the prefix cache, 1-layer full-width granite-3-2b
# ---------------------------------------------------------------------------
def phase_paged(torch, dev, cfg) -> tuple[list[dict], dict]:
    import dataclasses

    import numpy as np

    from repro_torch.core import hfuse
    from repro_torch.core.cost_model import Schedule
    from repro_torch.core.timing import flush_buffer, median_ms
    from repro_torch.kernels import cuda, registry
    from repro_torch.models import lm
    from repro_torch.serve.engine import PrefillBudget, Request, ServeEngine

    cfg = dataclasses.replace(cfg, num_layers=PAGED_LAYERS)
    d, H, Hkv = cfg.d_model, cfg.num_heads, cfg.num_kv_heads
    D, f = cfg.resolved_head_dim, cfg.d_ff
    budget = PrefillBudget(chunk_rows=C, max_coresident_chunks=2)
    pg = dict(paged_kv=True, kv_block_size=KV_BS)

    def program(**kw):
        eng = ServeEngine(cfg, None, batch=B, max_len=S, prefill_budget=budget,
                          device=dev, **kw)
        prog = eng.build_decode_program(prefill_chunks=2)
        return eng, prog, {op.name: op for st in prog.steps for op in st.ops}

    eng, prog, ops = program(**pg)
    _e, _p, cops = program()
    nblk = eng.kv_blocks
    check(nblk == B * (S // KV_BS) + B, f"arena of {nblk} blocks")
    att = next(o for n, o in ops.items() if n.startswith("decode_attn"))
    pfs = sorted((o for n, o in ops.items() if n.startswith("prefill_attn")),
                 key=lambda o: o.name)
    catt = next(o for n, o in cops.items() if n.startswith("decode_attn"))
    cpf = next(o for n, o in cops.items() if n.startswith("prefill_attn"))

    # the contiguous cache's content scattered into shuffled arena blocks;
    # blocks 0..B-1 stay the slots' sentinels
    g = torch.Generator(device=dev)
    g.manual_seed(1414)

    def randn(shape, dtype=torch.bfloat16, scale=1.0):
        return (torch.randn(shape, generator=g, device=dev) * scale).to(dtype)

    npg = S // KV_BS
    k_cache, v_cache = randn((B, S, Hkv, D)), randn((B, S, Hkv, D))
    perm = torch.randperm(nblk - B, generator=torch.Generator().manual_seed(
        14)).to(dev) + B
    bt = perm[:B * npg].reshape(B, npg).to(torch.int32)
    k_ar, v_ar = randn((nblk, KV_BS, Hkv, D)), randn((nblk, KV_BS, Hkv, D))
    k_ar[bt.reshape(-1).long()] = k_cache.reshape(B * npg, KV_BS, Hkv, D)
    v_ar[bt.reshape(-1).long()] = v_cache.reshape(B * npg, KV_BS, Hkv, D)
    lens = torch.tensor(DECODE_LENS, dtype=torch.int32, device=dev)
    q_dec, q_pf = randn((B, H, D)), randn((C, H, D))
    dec_in = (bt, lens.reshape(B, 1), q_dec, k_ar, v_ar)
    cdec_in = (lens.reshape(B, 1), q_dec, k_cache, v_cache)

    def pf_in(off):
        o = torch.full((1, 1), off, dtype=torch.int32, device=dev)
        return (o, bt[3:4], q_pf, k_ar, v_ar), (o, q_pf, k_cache[3],
                                                v_cache[3])

    flush = flush_buffer(dev)
    rows = []
    by_name = {k.name: k for k in registry()}
    cases = [("decode_attention:paged bs16", by_name["decode_attention"],
              "decode_attention.cuh",
              "src/repro/kernels/decode_attention.py:35, :44 (block_table=)",
              att, dec_in, catt, cdec_in, decode_cost(H, Hkv, D, KV_BS),
              sdpa_decode(torch, q_dec, k_cache, v_cache))]
    for off in PREFILL_OFFS:
        p_in, c_in = pf_in(off)
        cases.append((
            f"prefill_attention:paged bs16 off={off}",
            by_name["prefill_attention"], "prefill_attention.cuh",
            "src/repro/kernels/prefill_attention.py:40 (block_table=)",
            pfs[0], p_in, cpf, c_in, prefill_cost(off, H, Hkv, D, KV_BS),
            sdpa_prefill(torch, q_pf, k_cache[3], v_cache[3], off)))
    for name, kernel, src, replaces, op, ins, cop, cins, cost, lib in cases:
        run, run_plain = hfuse.run_single(op), hfuse.run_single(op, plain=True)
        crun = hfuse.run_single(cop)
        got = run(*ins)
        check(all(torch.equal(a, b) for a, b in zip(got, crun(*cins))),
              f"{name} differs from the contiguous member")
        err = compare(torch, got, run_plain(*ins))
        rows.append(kernel_row(
            "paged", name, kernel, src, replaces, err,
            median_ms(lambda: run(*ins), flush),
            median_ms(lambda: run_plain(*ins), flush), cost, BF16_FLOPS,
            median_ms(lib, flush),
            contiguous_ms=median_ms(lambda: crun(*cins), flush)))
    print("[paged] paged members bitwise equal the contiguous members",
          flush=True)

    # the planner's fused paged launches: bitwise equal to run_native
    operands = {att.name: dec_in, pfs[0].name: pf_in(PREFILL_OFFS[0])[0],
                pfs[1].name: pf_in(PREFILL_OFFS[1])[0]}
    for st in (st for st in prog.steps if st.fused):
        ops_in = [operands.get(op.name) for op in st.ops]
        if any(x is None for x in ops_in):
            continue
        ins = tuple(t for x in ops_in for t in x)
        sched = Schedule(tuple(int(r) for r in st.schedule.split(":")))
        out_f = hfuse.generate(st.ops, sched)(*ins)
        check(all(torch.equal(a, b) for a, b in
                  zip(out_f, hfuse.run_native(st.ops)(*ins))),
              f"fused {st.members} differs from run_native")
        print(f"[paged] fused {'+'.join(st.members)} ({st.schedule}) "
              "bitwise equal run_native")
    del k_cache, v_cache, k_ar, v_ar, dec_in, cdec_in, operands, cases
    free_card(torch)

    # the path: 12 requests sharing one 1024-token prefix
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    params = lm.init(cfg, gen, device=dev)

    def requests():
        rng = np.random.default_rng(0)
        shared = rng.integers(0, cfg.vocab_size, SHARED_PREFIX).astype(
            np.int32)
        tails = np.linspace(64, 476, 12).round().astype(int)
        return [Request(rid=i, prompt=np.concatenate(
                    [shared, rng.integers(0, cfg.vocab_size,
                                          L).astype(np.int32)]),
                        max_new_tokens=8 + (3 * i) % 9, arrival=2 * i)
                for i, L in enumerate(tails)]

    eng = ServeEngine(cfg, params, batch=B, max_len=S, prefill_budget=budget,
                      device=dev, **pg)
    reqs = requests()
    kernels = registry()
    cuda.reset_counts(kernels)
    t0 = time.perf_counter()
    eng.run(reqs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = {k.name: k.launches for k in kernels}
    st = eng.stats
    tokens = sum(len(r.out_tokens) for r in reqs)
    print(f"[paged] {len(reqs)} requests, {tokens} tokens in {wall:.3f}s "
          f"({tokens / wall:.2f} tok/s)")
    print(f"[paged] stats {st.describe()}")
    print(f"[paged] launches {counts}")
    check(all(counts[k] > 0 for k in ("bundle_launcher", "row_member",
                                      "decode_attention",
                                      "prefill_attention")),
          f"a kernel of the paged path never launched: {counts}")
    check(st.prefix_hits > 0, "no prefix-cache hit")
    check(all(len(r.out_tokens) == r.max_new_tokens for r in reqs),
          "a paged request retired early")

    contig = ServeEngine(cfg, params, batch=B, max_len=S,
                         prefill_budget=budget, device=dev)
    creqs = requests()
    contig.run(creqs)
    same = [r.out_tokens == c.out_tokens for r, c in zip(reqs, creqs)]
    print(f"[paged] tokens equal the contiguous engine's for "
          f"{sum(same)}/{len(same)} requests; prefill chunks "
          f"{st.prefill_chunks} paged vs {contig.stats.prefill_chunks} "
          "contiguous")
    check(all(same), "paged tokens differ from the contiguous engine's")
    check(st.prefill_chunks < contig.stats.prefill_chunks,
          "the prefix cache skipped no chunk")
    # the trace again under torch.profiler (counts already read; the pool,
    # and so the prefix cache, persists into this run)
    device_profile(torch, lambda: eng.run(requests()), "paged trace")
    out = {"counts": counts, "tokens": tokens, "seconds": wall,
           "tokens_per_s": tokens / wall, "prefix_hits": st.prefix_hits,
           "prefix_hit_rate": st.prefix_hit_rate,
           "prefill_chunks": (st.prefill_chunks,
                              contig.stats.prefill_chunks)}
    del params, eng, contig
    free_card(torch)
    return rows, out


# ---------------------------------------------------------------------------
# Phase 8c: MoE decode, phi3.5-moe-rms at full width, 8 of 32 layers
# ---------------------------------------------------------------------------
def phase_moe(torch, dev) -> tuple[list[dict], dict]:
    import dataclasses

    import numpy as np
    import torch.nn.functional as F

    from repro_torch.configs import get_config
    from repro_torch.core import autotuner, hfuse
    from repro_torch.core.timing import flush_buffer, median_ms
    from repro_torch.kernels import cuda, registry
    from repro_torch.kernels.moe_gmm import f_tile, moe_gmm_op, pass_rows
    from repro_torch.kernels.prefill_attention import prefill_attention_op
    from repro_torch.models import lm, moe
    from repro_torch.serve.engine import PrefillBudget, Request, ServeEngine

    cfg = dataclasses.replace(get_config("phi3.5-moe-rms"),
                              num_layers=MOE_LAYERS)
    check(cfg.d_model == 4096 and cfg.moe.num_experts == 16
          and cfg.moe.d_ff_expert == 6400, "phi3.5-moe-rms not at full width")
    d, E, f = cfg.d_model, cfg.moe.num_experts, cfg.moe.d_ff_expert
    budget = PrefillBudget(chunk_rows=C, max_coresident_chunks=2,
                           policy="eload")
    eng = ServeEngine(cfg, None, batch=B, max_len=S, prefill_budget=budget,
                      device=dev)
    prog = eng.build_decode_program(prefill_chunks=2)
    ops = {op.name: op for st in prog.steps for op in st.ops}
    router, gmm = ops["moe_router"], ops[f"moe_gmm_E{E}_C8"]
    pf = next(o for n, o in ops.items() if n.startswith("prefill_attn"))
    cap = moe.capacity(cfg, C)
    check(moe.capacity(cfg, B) == 8 and cap == 80,
          f"capacities {moe.capacity(cfg, B)}, {cap}")
    gmm_chunk = moe_gmm_op(E, cap, d, f)

    g = torch.Generator(device=dev)
    g.manual_seed(1515)

    def randn(shape, dtype=torch.bfloat16, scale=1.0):
        return (torch.randn(shape, generator=g, device=dev) * scale).to(dtype)

    flush = flush_buffer(dev)
    by_name = {k.name: k for k in registry()}
    rows = []
    x_r = randn((B, d), torch.float32)
    w_r = randn((d, E), torch.float32, d ** -0.5)
    w_in = randn((E, d, 2 * f), scale=d ** -0.5)
    w_out = randn((E, f, d), scale=f ** -0.5)

    def gmm_lib(xe):
        def run():
            h = torch.bmm(xe, w_in)
            return torch.bmm(F.silu(h[..., :f]) * h[..., f:], w_out)
        return run

    def gmm_cost(op):
        return op.hbm_bytes, op.flops

    def gmm_moved(op):
        """Device-memory bytes the member moves (its design, not the
        bound): the weights once per pass, the fp32 partials written and
        read back, xe read and ye written."""
        C = op.inputs[0].shape[1]
        streams = -(-C // pass_rows(C))
        return {"weights": streams * (E * d * 2 * f + E * f * d) * 2,
                "weight_streams": streams,
                "partials": 2 * E * (f // f_tile(f)) * C * d * 4,
                "tokens": 2 * E * C * d * 2}

    cases = [("row_member:moe_router fp32", by_name["row_member"],
              "row_member.cuh", "src/repro/kernels/matmul.py:64 (float32)",
              router, (x_r, w_r),
              ((B * d + d * E + B * E) * 4, 2.0 * B * d * E), FP32_FLOPS,
              lambda: x_r @ w_r)]
    for op in (gmm, gmm_chunk):
        xe = randn((E, op.inputs[0].shape[1], d))
        cases.append((f"moe_gmm:E{E} C{op.inputs[0].shape[1]}",
                      by_name["moe_gmm"], "moe_gmm_member.cuh",
                      "src/repro/kernels/moe_gmm.py:54, :34", op,
                      (xe, w_in, w_out), gmm_cost(op), BF16_FLOPS,
                      gmm_lib(xe)))
    f32_split_line("moe_router", router.member)
    for name, kernel, src, replaces, op, ins, cost, peak, lib in cases:
        run, run_plain = hfuse.run_single(op), hfuse.run_single(op, plain=True)
        got = run(*ins)
        err = compare(torch, got, run_plain(*ins))
        check(all(torch.equal(a, b) for a, b in zip(got, run(*ins))),
              f"{name} differs between two launches")
        rows.append(kernel_row(
            "moe", name, kernel, src, replaces, err,
            median_ms(lambda: run(*ins), flush),
            median_ms(lambda: run_plain(*ins), flush), cost, peak,
            median_ms(lib, flush)))
        if op is not router:
            mv = gmm_moved(op)
            moved = mv["weights"] + mv["partials"] + mv["tokens"]
            print(f"[moe] {name}: {op.member.ctas} CTAs, moves "
                  f"{moved / 1e9:.3f} GB: weights "
                  f"{mv['weights'] / 1e9:.3f} GB ({mv['weight_streams']} "
                  f"stream(s)), partials {mv['partials'] / 1e9:.3f} GB "
                  "written and read, xe + ye "
                  f"{mv['tokens'] / 1e9:.4f} GB", flush=True)

    # the grouped FFN beside a prefill chunk in one launch, at the
    # schedule the search picks for the pair, bitwise equal to run_native
    pair = (gmm, pf)
    res = autotuner.search(pair)
    pf_ins = (torch.full((1, 1), 1024, dtype=torch.int32, device=dev),
              randn((C, cfg.num_heads, cfg.resolved_head_dim)),
              randn((S, cfg.num_kv_heads, cfg.resolved_head_dim)),
              randn((S, cfg.num_kv_heads, cfg.resolved_head_dim)))
    ins = (cases[1][5][0], w_in, w_out) + pf_ins
    fused, native = res.build(), hfuse.run_native(pair)
    out_f = fused(*ins)
    check(all(torch.equal(a, b) for a, b in zip(out_f, native(*ins))),
          "the fused moe_gmm + prefill launch differs from run_native")
    plain = hfuse.run_native(pair, plain=True)
    err = compare(torch, out_f, plain(*ins))
    pf_c = prefill_cost(1024, cfg.num_heads, cfg.num_kv_heads,
                        cfg.resolved_head_dim)
    rows.append(kernel_row(
        "moe", f"bundle_launcher:moe_gmm+prefill_attn "
        f"({res.best.sched.label()})", by_name["bundle_launcher"],
        "bundle.cu", "src/repro/core/hfuse.py:87", err,
        median_ms(lambda: fused(*ins), flush),
        median_ms(lambda: plain(*ins), flush),
        (gmm.hbm_bytes + pf_c[0], gmm.flops + pf_c[1]), BF16_FLOPS, None,
        native_ms=median_ms(lambda: native(*ins), flush)))
    print(f"[moe] moe_gmm + prefill chunk fused at "
          f"{res.best.sched.label()} bitwise equal run_native (the planner "
          "keeps moe_gmm single at this width, as the reference's does)",
          flush=True)
    del cases, ins, w_in, w_out, pf_ins, fused, native, plain

    # rows j, l, k at phi3.5-moe's heads (32/8, head dim 128): decode and
    # prefill attention as the MoE path launches them, and the paged prefill
    # member (16-row pages, shuffled blocks) bitwise equal to the contiguous
    H, Hkv, D = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    att = next(o for n, o in ops.items() if n.startswith("decode_attn"))
    lens = torch.tensor(DECODE_LENS, dtype=torch.int32, device=dev)
    q_dec, q_pf = randn((B, H, D)), randn((C, H, D))
    k_cache, v_cache = randn((B, S, Hkv, D)), randn((B, S, Hkv, D))
    npg, nblk = S // KV_BS, B * (S // KV_BS) + B
    bt = (torch.randperm(nblk - B, generator=torch.Generator().manual_seed(
        15))[:npg] + B).reshape(1, npg).to(device=dev, dtype=torch.int32)
    k_ar = torch.zeros((nblk, KV_BS, Hkv, D), dtype=torch.bfloat16,
                       device=dev)
    v_ar = torch.zeros_like(k_ar)
    k_ar[bt.reshape(-1).long()] = k_cache[3].reshape(npg, KV_BS, Hkv, D)
    v_ar[bt.reshape(-1).long()] = v_cache[3].reshape(npg, KV_BS, Hkv, D)
    pf_paged = prefill_attention_op(C, S, H, Hkv, D, ck=1024,
                                    block_table=(nblk, KV_BS))
    pf_src = ("prefill_attention", "prefill_attention.cuh",
              "src/repro/kernels/prefill_attention.py:40")
    att_cases = [("moe", f"decode_attention:D{D}", "decode_attention",
                  "decode_attention.cuh",
                  "src/repro/kernels/decode_attention.py:44", att,
                  (lens.reshape(B, 1), q_dec, k_cache, v_cache),
                  decode_cost(H, Hkv, D),
                  sdpa_decode(torch, q_dec, k_cache, v_cache))]
    for off in PREFILL_OFFS:
        o = torch.full((1, 1), off, dtype=torch.int32, device=dev)
        c_in, p_in = (o, q_pf, k_cache[3], v_cache[3]), (o, bt, q_pf, k_ar,
                                                         v_ar)
        got = hfuse.run_single(pf_paged)(*p_in)
        check(all(torch.equal(a, b) for a, b in
                  zip(got, hfuse.run_single(pf)(*c_in))),
              f"paged prefill at D {D}, off {off} differs from contiguous")
        lib = sdpa_prefill(torch, q_pf, k_cache[3], v_cache[3], off)
        att_cases += [
            ("moe", f"prefill_attention:D{D} off={off}", *pf_src, pf, c_in,
             prefill_cost(off, H, Hkv, D), lib),
            ("paged", f"prefill_attention:paged bs16 D{D} off={off}",
             pf_src[0], pf_src[1], pf_src[2] + " (block_table=)", pf_paged,
             p_in, prefill_cost(off, H, Hkv, D, KV_BS), lib)]
    for path, name, kernel, src, replaces, op, ins, cost, lib in att_cases:
        run, run_plain = hfuse.run_single(op), hfuse.run_single(op, plain=True)
        err = compare(torch, run(*ins), run_plain(*ins))
        rows.append(kernel_row(
            path, name, by_name[kernel], src, replaces, err,
            median_ms(lambda: run(*ins), flush),
            median_ms(lambda: run_plain(*ins), flush), cost, BF16_FLOPS,
            median_ms(lib, flush)))
    print(f"[moe] attention at D {D}: paged prefill bitwise equal the "
          "contiguous member", flush=True)
    del att_cases, k_cache, v_cache, k_ar, v_ar
    free_card(torch)

    # the path: 12 staggered requests, the eload policy
    t0 = time.perf_counter()
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    params = lm.init(cfg, gen, device=dev)
    eng = ServeEngine(cfg, params, batch=B, max_len=S, prefill_budget=budget,
                      device=dev)
    torch.cuda.synchronize()
    print(f"[moe] weights ({MOE_LAYERS} layers) + plan: "
          f"{time.perf_counter() - t0:.1f}s, "
          f"{torch.cuda.memory_allocated(dev) / 2 ** 30:.2f} GiB", flush=True)
    def requests():
        return serve_requests(cfg, Request)

    reqs = requests()
    captured = capture_first_mixed(eng)
    kernels = registry()
    cuda.reset_counts(kernels)
    t0 = time.perf_counter()
    with ActTally("moe"):
        eng.run(reqs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = {k.name: k.launches for k in kernels}
    st = eng.stats
    tokens = sum(len(r.out_tokens) for r in reqs)
    print(f"[moe] {len(reqs)} requests, {tokens} tokens in {wall:.3f}s "
          f"({tokens / wall:.2f} tok/s); expert_skew {st.expert_skew:.3f}, "
          f"load_shed_steps {st.load_shed_steps}, fused_prefill_fraction "
          f"{st.fused_prefill_fraction:.3f}")
    print(f"[moe] stats {st.describe()}")
    print(f"[moe] launches {counts}")
    print(f"[moe] programs {eng.cb_program_info.get(2, {}).get('steps')}")
    check(all(counts[k] > 0 for k in ("bundle_launcher", "row_member",
                                      "decode_attention", "prefill_attention",
                                      "moe_gmm")),
          f"a kernel of the MoE path never launched: {counts}")
    check(all(len(r.out_tokens) == r.max_new_tokens for r in reqs),
          "an MoE request retired early")
    check(sum(st.expert_hits) == cfg.moe.top_k * st.slot_steps * MOE_LAYERS,
          "routed decode tokens do not add up")

    ref = ServeEngine(cfg, params, batch=B, max_len=S, prefill_budget=budget,
                      device=dev, plain=True)
    rel = first_mixed_vs_plain(torch, captured, ref, "moe")
    del ref
    device_profile(torch, lambda: eng.run(requests()), "moe trace")
    out = {"counts": counts, "tokens": tokens, "seconds": wall,
           "tokens_per_s": tokens / wall, "logits_rel_l2": rel,
           "expert_skew": st.expert_skew,
           "load_shed_steps": st.load_shed_steps}
    del params, eng, captured
    free_card(torch)
    return rows, out


# ---------------------------------------------------------------------------
# Phase 8d: the public kernel entry points at full width
# ---------------------------------------------------------------------------
def ops_layer(mm, norm, attn, resadd, x, p, dims):
    """One granite-3-2b layer from the ops: rmsnorm -> QKV -> flash
    attention -> W_o -> residual add -> rmsnorm -> gate+up -> SwiGLU ->
    down -> residual add; the four ops are the kernels' or their plain
    versions'.  The QKV split and SwiGLU are glue."""
    from repro_torch.kernels.row import silu_gate
    Bt, St, H, Hkv, D = dims
    R = x.shape[0]
    qkv = mm(norm(x, p["s1"]), p["w_qkv"])
    q = qkv[:, :H * D].reshape(Bt, St, H, D)
    k = qkv[:, H * D:(H + Hkv) * D].reshape(Bt, St, Hkv, D)
    v = qkv[:, (H + Hkv) * D:].reshape(Bt, St, Hkv, D)
    a = attn(q.contiguous(), k.contiguous(), v.contiguous())
    x2 = resadd(mm(a.reshape(R, H * D), p["w_o"]), x)
    h = silu_gate(mm(norm(x2, p["s2"]), p["w_in"])).to(x.dtype)
    return resadd(mm(h, p["w_out"]), x2)


def phase_ops(torch, dev, cfg) -> tuple[list[dict], dict]:
    import torch.nn.functional as F

    from repro_torch.core import hfuse, stitch
    from repro_torch.core.timing import flush_buffer, median_ms
    from repro_torch.kernels import adam, cuda, elementwise, ops, registry
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import row
    from repro_torch.kernels.matmul import matmul_1d_op
    from repro_torch.kernels.moe_gmm import plain_moe_gmm
    from repro_torch.kernels.rmsnorm import rmsnorm_op

    d, H, Hkv = cfg.d_model, cfg.num_heads, cfg.num_kv_heads
    D, f = cfg.resolved_head_dim, cfg.d_ff
    Bt, St = TRAIN_BATCH, TRAIN_SEQ
    R, N_qkv = Bt * St, (H + 2 * Hkv) * D
    bf, f32 = torch.bfloat16, torch.float32
    g = torch.Generator(device=dev)
    g.manual_seed(1616)

    def randn(shape, dtype=bf, scale=1.0):
        return (torch.randn(shape, generator=g, device=dev) * scale).to(dtype)

    flush = flush_buffer(dev)
    by_name = {k.name: k for k in registry()}
    peak = {bf: BF16_FLOPS, f32: FP32_FLOPS}
    rows = []

    def case(name, kernel, src, replaces, run, run_plain, cost, flops_peak,
             lib, rows_rel=None):
        """``rows_rel``: also hold the output by relative L2 within
        (whole output, worst row of its last dim)."""
        got, want = run(), run_plain()
        err = compare(torch, (got,), (want,))
        if rows_rel is not None:
            whole, row = rel_l2_rows(torch, got, want)
            print(f"[ops] {name}: rel L2 {whole:.3g}, worst row {row:.3g} "
                  f"(limits {rows_rel[0]:g}, {rows_rel[1]:g})", flush=True)
            check(whole <= rows_rel[0] and row <= rows_rel[1],
                  f"{name}: rel L2 {whole}, worst row {row} over {rows_rel}")
        rows.append(kernel_row(
            "ops", name, by_name[kernel], src, replaces, err,
            median_ms(run, flush), median_ms(run_plain, flush), cost,
            flops_peak, None if lib is None else median_ms(lib, flush)))

    # f: the tiled matmul, granite's four projections at train rows
    for label, M, K, N, dt in (("QKV", R, d, N_qkv, bf),
                               ("W_o", R, H * D, d, bf),
                               ("gate+up", R, d, 2 * f, bf),
                               ("down", R, f, d, bf),
                               ("QKV fp32", R, d, N_qkv, f32)):
        x, w = randn((M, K), dt), randn((K, N), dt, K ** -0.5)
        isz = x.element_size()
        case(f"tiled_matmul:{label} {M}x{K}@{K}x{N}", "tiled_matmul",
             "tiled_matmul.cuh", "src/repro/kernels/matmul.py:38",
             lambda: ops.matmul(x, w), lambda: row.plain_gemm(x, w, dt),
             ((M * K + K * N + M * N) * isz, 2.0 * M * K * N), peak[dt],
             lambda: torch.matmul(x, w))
        del x, w

    # o: flash attention (B,S,H,D) with GQA; SDPA takes its layout's
    # copies made outside the timed window
    for (h, hkv, dh), dt, causal in (((H, Hkv, D), bf, True),
                                     ((H, Hkv, D), bf, False),
                                     ((H, Hkv, D), f32, True),
                                     ((H, Hkv, D), f32, False),
                                     ((*PHI_HEADS, PHI_HEAD_DIM), bf, True)):
        q = randn((Bt, St, h, dh), dt)
        k, v = randn((Bt, St, hkv, dh), dt), randn((Bt, St, hkv, dh), dt)
        qh, kh, vh = (t.transpose(1, 2).contiguous() for t in (q, k, v))
        isz = q.element_size()
        pairs = St * (St + 1) // 2 if causal else St * St
        case(f"flash_attention:{'causal' if causal else 'full'} "
             f"{Bt}x{St} H{h}/{hkv} D{dh} {str(dt)[6:]}", "flash_attention",
             "flash_attention.cuh", "src/repro/kernels/flash_attention.py:54",
             lambda: ops.flash_attention(q, k, v, causal=causal),
             lambda: fa.plain_flash_attention_bshd(q, k, v, causal=causal),
             ((2 * q.numel() + 2 * k.numel()) * isz,
              4.0 * Bt * h * dh * pairs), peak[dt],
             lambda: F.scaled_dot_product_attention(
                 qh, kh, vh, is_causal=causal, enable_gqa=True),
             rows_rel=FLASH_REL_BF16 if dt == bf else FLASH_REL_F32)
        del q, k, v, qh, kh, vh

    # d: the standalone rmsnorm; h: the residual add (one-member launches)
    for dt in (bf, f32):
        x, scale = randn((R, d), dt), randn((d,), f32, 0.1)
        w_lib = (1.0 + scale).to(dt)
        isz = x.element_size()
        case(f"row_member:rmsnorm {R}x{d} {str(dt)[6:]}", "row_member",
             "row_member.cuh", "src/repro/kernels/rmsnorm.py:20",
             lambda: ops.rmsnorm(x, scale),
             lambda: row.plain_rmsnorm(x, scale),
             (2 * R * d * isz + d * 4, 4.0 * R * d), FP32_FLOPS,
             lambda: F.rms_norm(x, (d,), w_lib, 1e-6))
        res = randn((R, d), dt)
        add = elementwise.residual_add_op(R, d, dt)
        run_add = hfuse.run_single(add)
        plain_add = hfuse.run_single(add, plain=True)
        case(f"row_member:residual_add {R}x{d} {str(dt)[6:]}", "row_member",
             "row_member.cuh", "src/repro/kernels/elementwise.py:69",
             lambda: run_add(x, res)[0], lambda: plain_add(x, res)[0],
             (3 * R * d * isz, 1.0 * R * d), FP32_FLOPS,
             lambda: torch.add(x, res))
        check(torch.equal(run_add(x, res)[0], torch.add(x, res)),
              f"residual_add ({dt}) differs from torch.add")
        # the instance the launch runs and its CTAs an SM, alone and fused
        # with another row member
        out = torch.empty_like(x)
        alone = cuda.launch_instance([add.member], [(x, res)], [(out,)])
        norm_op = rmsnorm_op(R, d, dt)
        fused = cuda.launch_instance([add.member, norm_op.member],
                                     [(x, res), (x, scale.reshape(1, d))],
                                     [(out,), (torch.empty_like(x),)])
        r = rows[-1]
        print(f"[ops] residual_add {str(dt)[6:]}: {add.ctas} CTAs in "
              f"{alone[0]} at {alone[1]} CTAs/SM, {r['ms']:.4f} ms against "
              f"torch.add {r['library_ms']:.4f} ms "
              f"({r['library_ms'] / r['ms'] - 1:+.2%}); fused with a row "
              f"member it runs {fused[0]} at {fused[1]} CTAs/SM", flush=True)
        del x, res, out

    # i: matmul -> residual_add at decode (W_o, 8 rows): bitwise against
    # the GEMM and residual-add members launched separately
    for dt in (bf, f32):
        mm = matmul_1d_op(B, d, d, dt, bm=B)
        add = elementwise.residual_add_op(B, d, dt, bm=B)
        chain = stitch.stitch(mm, add, "h")
        x, res, w = randn((B, d), dt), randn((B, d), dt), \
            randn((d, d), dt, d ** -0.5)
        run = hfuse.run_single(chain)
        (got,) = run(x, w, res)
        (h,) = hfuse.run_single(mm)(x, w)
        check(torch.equal(got, hfuse.run_single(add)(h, res)[0]),
              f"matmul->residual_add ({dt}) differs from its separate "
              "members")
        if dt == bf:
            isz = x.element_size()
            case(f"row_member:W_o->residual_add {B}x{d}@{d}x{d}",
                 "row_member", "row_member.cuh",
                 "src/repro/core/stitch.py:177 (matmul->residual_add)",
                 lambda: run(x, w, res)[0],
                 lambda: hfuse.run_single(chain, plain=True)(x, w, res)[0],
                 ((3 * B * d + d * d) * isz, 2.0 * B * d * d + B * d),
                 BF16_FLOPS, lambda: torch.addmm(res, x, w))
    print("[ops] matmul->residual_add bitwise equal its separate members "
          "(bf16, fp32)", flush=True)
    free_card(torch)

    # the path: a full-width granite layer from the ops, moe_gmm at
    # phi3.5-moe's decode shape, the fused AdamW over the layer's leaves
    p = {"s1": randn((d,), f32, 0.1), "s2": randn((d,), f32, 0.1),
         "w_qkv": randn((d, N_qkv), scale=d ** -0.5),
         "w_o": randn((H * D, d), scale=(H * D) ** -0.5),
         "w_in": randn((d, 2 * f), scale=d ** -0.5),
         "w_out": randn((f, d), scale=f ** -0.5)}
    x = randn((R, d))
    E, Cg, dg, fg = PHI_GMM
    xe = randn((E, Cg, dg))
    w_in_e = randn((E, dg, 2 * fg), scale=dg ** -0.5)
    w_out_e = randn((E, fg, dg), scale=fg ** -0.5)
    grads = {k: randn(t.shape, t.dtype, 1e-2) for k, t in p.items()}
    moments = [{k: torch.zeros(t.shape, device=dev) for k, t in p.items()}
               for _ in range(2)]
    upd = dict(lr=3e-4, b1=0.9, b2=0.95, eps=1e-8, wd=0.1, bc1=0.1,
               bc2=0.05)
    copies = [{k: t.clone() for k, t in tr.items()} for tr in (p, *moments)]
    dims = (Bt, St, H, Hkv, D)

    def kernel_resadd(h, res):
        return hfuse.run_single(elementwise.residual_add_op(R, d))(h, res)[0]

    kernels = registry()
    torch.cuda.synchronize()
    cuda.reset_counts(kernels)
    with ActTally("ops"):
        t0 = time.perf_counter()
        out = ops_layer(ops.matmul, ops.rmsnorm,
                        lambda q, k, v: ops.flash_attention(q, k, v),
                        kernel_resadd, x, p, dims)
        torch.cuda.synchronize()
        layer_s = time.perf_counter() - t0
        ye = ops.moe_gmm(xe, w_in_e, w_out_e)
        ops.hfused_adamw(p, grads, *moments, **upd)
        torch.cuda.synchronize()
    counts = {k.name: k.launches for k in kernels}
    print(f"[ops] launches {counts}")
    check(all(counts[k] > 0 for k in ("bundle_launcher", "row_member",
                                      "tiled_matmul", "flash_attention",
                                      "moe_gmm", "adamw_member")),
          f"a kernel of the ops path never launched: {counts}")

    ref = ops_layer(lambda a, b: row.plain_gemm(a, b, a.dtype),
                    row.plain_rmsnorm, fa.plain_flash_attention_bshd,
                    lambda a, b: row.plain_residual_add(a, b, a.dtype),
                    x, copies[0], dims)
    check(bool(torch.isfinite(out.float()).all()), "non-finite layer output")
    rel = ((out.float() - ref.float()).norm() / ref.float().norm()).item()
    check(rel <= LOGITS_REL_L2, f"ops layer vs plain: rel L2 {rel}")
    compare(torch, (ye,), (plain_moe_gmm(xe, w_in_e, w_out_e),))
    sc = torch.zeros((1, adam.LANES), device=dev)
    sc[0, :3] = torch.tensor([upd["lr"], upd["bc1"], upd["bc2"]])
    adam.multi_tensor_adamw(*copies[:1], grads, *copies[1:], sc,
                            b1=upd["b1"], b2=upd["b2"], eps=upd["eps"],
                            wd=upd["wd"], plain=True)
    check(all(torch.equal(a[k], b[k]) for a, b in zip((p, *moments), copies)
              for k in a), "ops.hfused_adamw differs from its plain route")
    print(f"[ops] granite layer from the ops at {Bt}x{St}: {layer_s * 1e3:.1f}"
          f" ms host clock (synchronised), rel L2 vs the plain layer {rel:.3g};"
          f" moe_gmm and hfused_adamw checked", flush=True)
    del p, copies, grads, moments, x, out, ref, xe, w_in_e, w_out_e, ye
    free_card(torch)
    return rows, {"counts": counts, "layer_ms": layer_s * 1e3,
                  "layer_rel_l2": rel}


# ---------------------------------------------------------------------------
# Phase 8e: the executed wavefront step, 1-layer full-width granite-3-2b
# ---------------------------------------------------------------------------
def clone_cache(cache: dict) -> dict:
    """A copy of a serve cache: ``pos`` and each run's k/v leaves."""
    return {k: v.clone() if k == "pos" else
            {kk: vv.clone() for kk, vv in v.items()}
            for k, v in cache.items()}


def rel_l2(a, b) -> float:
    a, b = a.float(), b.float()
    return ((a - b).norm() / b.norm()).item()


def written_rows(torch, cache: dict, pos, slots) -> dict:
    """The k/v rows a decode step wrote, every layer: slot b's row at its
    position before the step, for each b in ``slots`` (``pos`` by slot)."""
    run = next(k for k in cache if k != "pos")
    out = {}
    for name, t in cache[run].items():
        ax = t.dim() - 4                     # 1 for a stacked (L, B, ...)
        out[name] = torch.stack([t.select(ax, b).select(ax, p)
                                 for b, p in zip(slots, pos)])
    return out


def step_rel(got_logits, got_rows, want_logits, want_rows, slots) -> dict:
    """Relative L2 of a decode step against another over the decoding
    slots: its logits and the k/v rows it wrote."""
    return {"logits": rel_l2(got_logits[slots], want_logits[slots]),
            **{k: rel_l2(got_rows[k], want_rows[k]) for k in got_rows}}


def worst(rels) -> dict:
    return {k: max(r[k] for r in rels) for k in rels[0]}


def capture_first_coprefill(torch, eng) -> dict:
    """Wrap ``eng``'s mixed-step factory so the first wavefront step that
    carries the next wave's prompt keeps a copy of its inputs, its decode
    logits, the k/v rows it wrote and its co-prefill logits:
    ``captured["inputs"]``, ``captured["out"]``."""
    captured = {}
    make_step = eng._mixed_step

    def mixed_step(P):
        step = make_step(P)

        def wrapped(params_, cache, tokens, pf_tokens):
            first = "inputs" not in captured
            if first:
                captured["inputs"] = (P, clone_cache(cache), tokens.clone(),
                                      pf_tokens.clone())
            out = step(params_, cache, tokens, pf_tokens)
            if first:
                pos = [int(captured["inputs"][1]["pos"])] * eng.batch
                captured["out"] = (out[0].clone(), written_rows(
                    torch, out[1], pos, range(eng.batch)), out[3].clone())
            return out
        return wrapped

    eng._mixed_step = mixed_step
    return captured


def capture_decode_steps(torch, eng) -> list:
    """Wrap the executed wavefront engine's decode step so each call keeps
    a copy of its cache and tokens, its logits and the k/v rows it
    wrote."""
    steps = []
    step = eng._decode

    def wrapped(params_, cache, tokens):
        kept = clone_cache(cache), tokens.clone()
        out = step(params_, cache, tokens)
        pos = [int(kept[0]["pos"])] * eng.batch
        steps.append((*kept, out[0].clone(), written_rows(
            torch, out[1], pos, range(eng.batch))))
        return out

    eng._decode = wrapped
    return steps


def beside_plain_decode(torch, eng) -> list:
    """Wrap the executed continuous engine's step factory so each step that
    decodes first runs the fallback's decode (``lm.decode_step`` a slot,
    no kernel of the port) on a copy of its cache; keeps ``step_rel`` of
    the two a step."""
    rels = []
    make_step = eng._cb_step
    plain_decode = eng._cb_plain_decode()

    def cb_step(n):
        step = make_step(n)

        def wrapped(params_, cache, tokens, active, **kw):
            slots = active.nonzero().flatten().tolist()
            if slots:
                pos = [int(cache["pos"][b]) for b in slots]
                want, ref = plain_decode(params_, clone_cache(cache), tokens,
                                         active)
                want_rows = written_rows(torch, ref, pos, slots)
            out = step(params_, cache, tokens, active, **kw)
            if slots:
                rels.append(step_rel(out[0], written_rows(
                    torch, out[1], pos, slots), want, want_rows, slots))
            return out
        return wrapped

    eng._cb_step = cb_step
    return rels


def token_agreement(a, b) -> float:
    """Share of positions at which two runs of the same requests gave the
    same token."""
    pairs = [(x, y) for ra, rb in zip(a, b)
             for x, y in zip(ra.out_tokens, rb.out_tokens)]
    return sum(x == y for x, y in pairs) / max(len(pairs), 1)


def phase_wavefront(torch, dev, cfg) -> tuple[list[dict], dict]:
    import dataclasses

    import numpy as np

    from repro_torch.core import autotuner, hfuse
    from repro_torch.core.timing import flush_buffer, median_ms
    from repro_torch.kernels import cuda, registry
    from repro_torch.models import lm
    from repro_torch.serve.engine import Request, ServeEngine

    cfg1 = dataclasses.replace(cfg, num_layers=WAVE_LAYERS,
                               block_pattern=None)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    params = lm.init(cfg1, gen, device=dev)
    eng = ServeEngine(cfg1, params, batch=B, max_len=S,
                      scheduling="wavefront", device=dev)
    check(eng.executed, "the wavefront engine does not execute its step")
    prog = eng.build_decode_program(ffn_rows=B * max(WAVE_PROMPTS))
    print(f"[wavefront] mixed program {prog.describe()}", flush=True)

    def requests():
        rng = np.random.default_rng(3)
        return [Request(rid=i, prompt=rng.integers(
                    0, cfg.vocab_size, WAVE_PROMPTS[i // B]).astype(np.int32),
                        max_new_tokens=WAVE_NEW)
                for i in range(B * len(WAVE_PROMPTS))]

    reqs = requests()
    captured = capture_first_coprefill(torch, eng)
    decoded = capture_decode_steps(torch, eng)
    kernels = registry()
    cuda.reset_counts(kernels)
    t0 = time.perf_counter()
    eng.run(reqs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = {k.name: k.launches for k in kernels}
    tokens = sum(len(r.out_tokens) for r in reqs)
    print(f"[wavefront] {len(reqs)} requests in {len(WAVE_PROMPTS)} waves, "
          f"{tokens} tokens in {wall:.3f}s ({tokens / wall:.2f} tok/s); "
          f"mixed steps for prompt lengths {sorted(eng._mixed_steps)}")
    print(f"[wavefront] launches {counts}", flush=True)
    check(bool(eng._mixed_steps), "no wavefront step carried a prompt")
    check(all(counts[k] > 0 for k in ("bundle_launcher", "row_member",
                                      "decode_attention")),
          f"a kernel of the wavefront path never launched: {counts}")
    check(all(len(r.out_tokens) == WAVE_NEW for r in reqs),
          "a wavefront request stopped early")
    check(all(0 <= t < cfg.vocab_size for r in reqs for t in r.out_tokens),
          "token out of the vocabulary")

    # without the executor: each executed step against lm.decode_step on a
    # copy of its cache and tokens (logits and the k/v rows written), the
    # mixed step's decode likewise and its co-prefill logits against
    # lm.prefill of the riding prompts
    check("out" in captured, "no mixed step ran")
    P, cache, toks, pf_toks = captured["inputs"]
    logits_m, rows_m, pf_logits = captured["out"]
    steps = decoded + [(clone_cache(cache), toks, logits_m, rows_m)]
    every = list(range(B))
    rels = []
    for c, t, lg, rows in steps:
        pos = [int(c["pos"])] * B
        want, c2 = lm.decode_step(cfg1, params, c, t)
        rels.append(step_rel(lg, rows, want, written_rows(torch, c2, pos,
                                                           every), every))
    hand = {**worst(rels), "co-prefill": rel_l2(pf_logits, lm.prefill(
        cfg1, params, {"tokens": pf_toks}, max_len=eng.cache_len)[1])}
    print(f"[wavefront] against lm.decode_step / lm.prefill (no executor), "
          f"{len(steps)} executed steps (the mixed one and {len(decoded)} "
          f"decode), worst rel L2: "
          + ", ".join(f"{k} {v:.3e}" for k, v in hand.items())
          + f" (limit {LOGITS_REL_L2})", flush=True)
    check(max(hand.values()) <= LOGITS_REL_L2,
          f"wavefront steps off lm.decode_step / lm.prefill: {hand}")
    del steps, decoded

    # the first mixed step again, from the plain versions on the card
    ref = ServeEngine(cfg1, params, batch=B, max_len=S,
                      scheduling="wavefront", device=dev, plain=True)
    out = ref._mixed_step(P)(params, cache, toks, pf_toks)
    rel = {}
    for name, a, b in (("decode", logits_m, out[0]),
                       ("co-prefill", pf_logits, out[3])):
        check(bool(torch.isfinite(a).all()) and a.shape == b.shape,
              f"wavefront {name} logits non-finite or misshapen")
        rel[name] = ((a - b).norm() / b.norm()).item()
        print(f"[wavefront] first mixed step (P {P}, prefill_ffn M "
              f"{B * P}) {name} logits: rel L2 {rel[name]:.3e} (limit "
              f"{LOGITS_REL_L2}), argmax agreement "
              f"{(a.argmax(-1) == b.argmax(-1)).float().mean().item():.3f}",
              flush=True)
        check(rel[name] <= LOGITS_REL_L2,
              f"wavefront {name} logits off the plain step: {rel[name]}")

    # the hand-wired wavefront engine (lm.prefill + lm.decode_step) on the
    # same requests
    hand = ServeEngine(cfg1, params, batch=B, max_len=S,
                       scheduling="wavefront", plan_fusion=False, device=dev)
    hreqs = requests()
    hand.run(hreqs)
    agree = token_agreement(reqs, hreqs)
    print(f"[wavefront] tokens agreeing with the hand-wired wavefront "
          f"engine: {agree:.3f}", flush=True)

    # the partner at M 4096 alone (row e) and fused with decode attention
    # (row a), bitwise against the native launches
    by_name = {k.name: k for k in kernels}
    d, f = cfg.d_model, cfg.d_ff
    M = B * max(WAVE_PROMPTS)
    graph = {g_.op.name: g_.op for g_ in eng.decode_graph(ffn_rows=M)}
    pf = graph["prefill_ffn"]
    att = next(o for n, o in graph.items() if n.startswith("decode_attn"))
    H, Hkv, D = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    g = torch.Generator(device=dev)
    g.manual_seed(77)

    def randn(shape, scale=1.0):
        return (torch.randn(shape, generator=g, device=dev) * scale).to(
            torch.bfloat16)

    pf_in = (randn((M, d)), randn((d, 2 * f), d ** -0.5))
    dec_in = (torch.tensor(DECODE_LENS, dtype=torch.int32,
                           device=dev).reshape(B, 1),
              randn((B, H, D)), randn((B, S, Hkv, D)), randn((B, S, Hkv, D)))
    flush = flush_buffer(dev)
    rows = []
    run, run_plain = hfuse.run_single(pf), hfuse.run_single(pf, plain=True)
    err = compare(torch, run(*pf_in), run_plain(*pf_in))
    pf_cost = (d * 2 * f * 2 + M * d * 2 + M * 2 * f * 2, 2.0 * M * d * 2 * f)
    x_, w_ = pf_in
    rows.append(kernel_row(
        "wavefront", f"row_member:prefill_ffn (M {M})", by_name["row_member"],
        "row_member.cuh", "src/repro/kernels/matmul.py:64", err,
        median_ms(lambda: run(*pf_in), flush),
        median_ms(lambda: run_plain(*pf_in), flush), pf_cost, BF16_FLOPS,
        median_ms(lambda: x_ @ w_, flush), ctas=pf.ctas))
    res = autotuner.search([pf, att])
    ops, sched = tuple(res.ops), res.best.sched
    ins = tuple(t for op in ops
                for t in (pf_in if op.name == pf.name else dec_in))
    fused = hfuse.generate(ops, sched)
    native = hfuse.run_native(ops)
    plain = hfuse.generate(ops, sched, plain=True)
    out_f = fused(*ins)
    check(all(torch.equal(a, b) for a, b in zip(out_f, native(*ins))),
          "prefill_ffn + decode attention differs from run_native")
    err = compare(torch, out_f, plain(*ins))
    cost = tuple(pf_cost[i] + decode_cost(H, Hkv, D)[i] for i in (0, 1))
    rows.append(kernel_row(
        "wavefront", f"bundle_launcher:prefill_ffn+decode_attn "
        f"({sched.label()})", by_name["bundle_launcher"], "bundle.cu",
        "src/repro/core/hfuse.py:87", err,
        median_ms(lambda: fused(*ins), flush),
        median_ms(lambda: plain(*ins), flush), cost, BF16_FLOPS, None,
        native_ms=median_ms(lambda: native(*ins), flush),
        predicted_gain_pct=res.best.est.speedup_pct()))
    print("[wavefront] prefill_ffn + decode attention fused bitwise equal "
          "to run_native", flush=True)
    return rows, {"counts": counts, "tokens": tokens, "seconds": wall,
                  "tokens_per_s": tokens / wall, "logits_rel_l2": rel,
                  "hand_wired_rel_l2": hand, "agreement": agree}


# ---------------------------------------------------------------------------
# Phase 8f: the hand-wired continuous fallback, full-depth granite-3-2b
# ---------------------------------------------------------------------------
def record_first_logits(eng) -> dict:
    """Keep each admitted request's first-token logits, by rid."""
    first = {}
    admit = eng._admit

    def wrapped(req, slot, pf_logits, *rest):
        first[req.rid] = pf_logits.float().clone()
        return admit(req, slot, pf_logits, *rest)

    eng._admit = wrapped
    return first


def phase_fallback(torch, dev, cfg) -> dict:
    import numpy as np

    from repro_torch.kernels import cuda, registry
    from repro_torch.models import lm
    from repro_torch.serve.engine import PrefillBudget, Request, ServeEngine

    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    params = lm.init(cfg, gen, device=dev)

    def requests():
        rng = np.random.default_rng(5)
        return [Request(rid=i, prompt=rng.integers(0, cfg.vocab_size,
                                                   L).astype(np.int32),
                        max_new_tokens=FALLBACK_NEW)
                for i, L in enumerate(FALLBACK_PROMPTS)]

    fb = ServeEngine(cfg, params, batch=B, max_len=S, plan_fusion=False,
                     device=dev)
    check(not fb.executed, "the fallback engine executes a program")
    fb_first = record_first_logits(fb)
    reqs = requests()
    kernels = registry()
    cuda.reset_counts(kernels)
    t0 = time.perf_counter()
    fb.run(reqs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = {k.name: k.launches for k in kernels}
    tokens = sum(len(r.out_tokens) for r in reqs)
    print(f"[fallback] {len(reqs)} requests, {tokens} tokens in {wall:.3f}s "
          f"({tokens / wall:.2f} tok/s); stats {fb.stats.describe()}")
    print(f"[fallback] launches {counts}", flush=True)
    check(not any(counts.values()),
          f"the fallback launched a kernel of the port: {counts}")
    check(all(r.done and len(r.out_tokens) == FALLBACK_NEW for r in reqs),
          "a fallback request did not complete")

    exe = ServeEngine(cfg, params, batch=B, max_len=S, device=dev,
                      prefill_budget=PrefillBudget(chunk_rows=C))
    exe_first = record_first_logits(exe)
    exe_steps = beside_plain_decode(torch, exe)
    ereqs = requests()
    exe.run(ereqs)
    check(bool(exe_steps), "the executed engine never decoded")
    dec = worst(exe_steps)
    print(f"[fallback] the executed engine's {len(exe_steps)} decoding steps "
          f"against the fallback's decode (lm.decode_step a slot, no "
          f"executor) over the decoding slots, worst rel L2: "
          + ", ".join(f"{k} {v:.3e}" for k, v in dec.items())
          + f" (limit {LOGITS_REL_L2})", flush=True)
    check(max(dec.values()) <= LOGITS_REL_L2,
          f"executed decode steps off lm.decode_step: {dec}")
    rel = {}
    for r in reqs:
        a, b = fb_first[r.rid], exe_first[r.rid]
        check(bool(torch.isfinite(a).all()) and a.shape == b.shape,
              f"fallback first logits of request {r.rid} non-finite")
        rel[r.rid] = ((a - b).norm() / b.norm()).item()
    print(f"[fallback] first-token logits (lm.prefill) against the executed "
          f"engine's final chunk, rel L2 by prompt length: "
          + ", ".join(f"{len(r.prompt)}: {rel[r.rid]:.3e}" for r in reqs)
          + f" (limit {LOGITS_REL_L2})", flush=True)
    check(max(rel.values()) <= LOGITS_REL_L2,
          f"fallback first-token logits off the executed engine: {rel}")
    agree = token_agreement(reqs, ereqs)
    print(f"[fallback] tokens agreeing with the executed engine: "
          f"{agree:.3f}", flush=True)
    return {"counts": counts, "tokens": tokens, "seconds": wall,
            "tokens_per_s": tokens / wall, "logits_rel_l2": rel,
            "decode_rel_l2": dec, "agreement": agree}


# ---------------------------------------------------------------------------
# Phase 8g: the LayerNorm configs, served hand-wired, and stablelm-3b trained
# ---------------------------------------------------------------------------
def ln_serve(torch, dev, arch: str, layers: int) -> dict:
    """One LayerNorm config at full width: the reference's invariant
    (prefill of S tokens, then one decode step, against the full-sequence
    forward of S + 1), the planned engine's refusal, and the hand-wired
    fallback serving 4 requests with the counters reset."""
    import dataclasses

    import numpy as np

    from repro_torch import tree as tree_mod
    from repro_torch.configs import get_config
    from repro_torch.kernels import cuda, registry
    from repro_torch.models import lm
    from repro_torch.serve.engine import Request, ServeEngine

    cfg = get_config(arch)
    if layers:
        cfg = dataclasses.replace(cfg, num_layers=layers, block_pattern=None)
    t0 = time.perf_counter()
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    params = lm.init(cfg, gen, device=dev)
    n_params = sum(t.numel() for t in tree_mod.leaves(params))
    toks = torch.randint(1, cfg.vocab_size, (LN_PROMPTS, LN_PROMPT + 1),
                         generator=gen, device=dev, dtype=torch.int32)
    with torch.no_grad():
        full = lm.forward(cfg, params, {"tokens": toks})[0]
        cache, pf = lm.prefill(cfg, params, {"tokens": toks[:, :-1]},
                               max_len=LN_PROMPT + 1)
        dec, _ = lm.decode_step(cfg, params, cache, toks[:, -1])
    check(bool(torch.isfinite(full).all()), f"{arch}: non-finite logits")
    inv = {"prefill": rel_l2(pf, full[:, -2]),
           "decode": rel_l2(dec, full[:, -1])}
    del full, cache, pf, dec
    print(f"[layernorm] {arch} ({cfg.num_layers} layers, {n_params:,} "
          f"params, set up in {time.perf_counter() - t0:.1f}s): "
          f"lm.prefill({LN_PROMPT}) and one lm.decode_step against "
          f"lm.forward({LN_PROMPT + 1}), {LN_PROMPTS} prompts, rel L2 "
          + ", ".join(f"{k} {v:.3e}" for k, v in inv.items())
          + f" (limit {LOGITS_REL_L2})", flush=True)
    check(max(inv.values()) <= LOGITS_REL_L2,
          f"{arch}: prefill/decode off the forward: {inv}")

    try:
        ServeEngine(cfg, params, batch=LN_PROMPTS, max_len=LN_MAX_LEN,
                    device=dev)
        refusal = None
    except ValueError as e:
        refusal = str(e)
    check(refusal is not None and "--hand-wired" in refusal,
          f"{arch}: a planned engine on the card did not refuse: {refusal}")
    print(f"[layernorm] {arch} planned engine refuses: {refusal}")

    rng = np.random.default_rng(5)
    reqs = [Request(rid=i, prompt=rng.integers(1, cfg.vocab_size,
                                               L).astype(np.int32),
                    max_new_tokens=LN_NEW)
            for i, L in enumerate(LN_SERVE_PROMPTS)]
    eng = ServeEngine(cfg, params, batch=LN_PROMPTS, max_len=LN_MAX_LEN,
                      plan_fusion=False, device=dev)
    check(not eng.executed, f"{arch}: the fallback executes a program")
    kernels = registry()
    torch.cuda.synchronize()
    cuda.reset_counts(kernels)
    t0 = time.perf_counter()
    eng.run(reqs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = {k.name: k.launches for k in kernels}
    tokens = sum(len(r.out_tokens) for r in reqs)
    check(all(r.done and len(r.out_tokens) == LN_NEW for r in reqs),
          f"{arch}: a request did not complete")
    check(not any(counts.values()),
          f"{arch}: the hand-wired path launched a kernel: {counts}")
    firsts = []
    with torch.no_grad():
        for r in reqs:
            _c, lg = lm.prefill(cfg, params, {"tokens": torch.from_numpy(
                r.prompt[None]).to(dev)}, max_len=eng.cache_len)
            firsts.append(int(lm.greedy_sample(cfg, lg)[0]))
    check(firsts == [r.out_tokens[0] for r in reqs],
          f"{arch}: first tokens {[r.out_tokens[0] for r in reqs]} are not "
          f"lm.prefill's greedy tokens {firsts}")
    print(f"[layernorm] {arch} fallback: {len(reqs)} requests, {tokens} "
          f"tokens in {wall:.3f}s ({tokens / wall:.2f} tok/s, host clock); "
          f"first tokens equal lm.prefill's greedy tokens; no kernel "
          f"launched", flush=True)
    del params, eng
    free_card(torch)
    return {"invariant": inv, "tokens_per_s": tokens / wall,
            "counts": counts, "layers": cfg.num_layers}


def ln_norm(torch, dev) -> float:
    """``layers.layernorm`` at full width (bf16) against the same formula
    in fp64: within one bf16 step (2**-7) of the largest value."""
    from repro_torch.core.timing import flush_buffer, median_ms
    from repro_torch.models import layers

    rows, d = LN_NORM_SHAPE
    g = torch.Generator(device=dev)
    g.manual_seed(3)
    x = (torch.randn((rows, d), generator=g, device=dev) * 2 + 0.5).to(
        torch.bfloat16)
    p = {"scale": 1 + 0.3 * torch.randn(d, generator=g, device=dev),
         "bias": 0.1 * torch.randn(d, generator=g, device=dev)}
    got = layers.layernorm(p, x)
    xd = x.double()
    mu = xd.mean(-1, keepdim=True)
    var = (xd - mu).square().mean(-1, keepdim=True)
    want = (xd - mu) * torch.rsqrt(var + 1e-5) * p["scale"].double() \
        + p["bias"].double()
    err = (got.double() - want).abs().max().item()
    lim = BF16_REL * want.abs().max().item()
    flush = flush_buffer(dev)
    ms = median_ms(lambda: layers.layernorm(p, x), flush)
    print(f"[layernorm] layers.layernorm {rows}x{d} bf16 against fp64: "
          f"max|err| {err:.3g} (limit {lim:.3g}); {ms:.4f} ms (glue, plain "
          f"PyTorch as in the reference)", flush=True)
    check(err <= lim, f"layernorm off the fp64 formula by {err} > {lim}")
    return err


def train_full(torch, dev, cfg, *, steps: int, tag: str, watch,
               grad_accum: int = 1, batch_size: int = TRAIN_BATCH,
               seq: int = TRAIN_SEQ, profiler=device_profile,
               groups: dict | None = None) -> tuple:
    """``cfg`` at full width, batch_size x seq (TRAIN_BATCH x TRAIN_SEQ
    unless given; ``grad_accum`` micro-batches a step): ``steps`` steps with
    remat, fp32 moments and the update program (``build_update_program``, as
    ``launch/train.py --plan-fusion``), the counters reset; finite losses,
    a grad norm > 0, and every leaf ``watch(path)`` picks moved from its
    start in every layer (``groups``: path -> the leading groups that must
    each move, such as an audio embedding's codebook tables); the AdamW
    member and the bundle launcher launched.  The data pipeline gives the
    config's frontend batches (codebooks, image embeddings), as
    ``launch/train.py`` builds it.  One more step under ``profiler`` (``device_profile``, or
    ``device_events`` for a step of a million kernels) for the busy share
    and the kernels a step launches.  Returns the run's numbers."""
    from repro_torch import tree as tree_mod
    from repro_torch.data.pipeline import DataConfig, TokenPipeline
    from repro_torch.kernels import cuda, registry
    from repro_torch.models import lm
    from repro_torch.train import optimizer as opt_mod
    from repro_torch.train import train_loop as tl

    abstract = lm.abstract_params(cfg)
    ocfg = opt_mod.AdamWConfig(lr=3e-4, warmup_steps=1, total_steps=steps)
    t0 = time.perf_counter()
    program = tl.build_update_program(abstract, ocfg)
    print(f"[{tag}] {cfg.name} update program (planned in "
          f"{time.perf_counter() - t0:.1f}s): {program.describe()}",
          flush=True)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    params = lm.init(cfg, gen, device=dev)
    start = {path: leaf.clone() for path, leaf
             in tree_mod.flatten_with_paths(params) if watch(path)}
    opt_state = opt_mod.init(params)
    step_fn = tl.make_train_step(cfg, tl.TrainConfig(
        optimizer=ocfg, remat=True, grad_accum=grad_accum),
        update_program=program)
    data = TokenPipeline(DataConfig(
        vocab_size=cfg.vocab_size, seq_len=seq, global_batch=batch_size,
        num_codebooks=cfg.num_codebooks if cfg.frontend == "audio_stub" else 0,
        num_image_tokens=cfg.num_image_tokens
        if cfg.frontend == "vision_stub" else 0, d_model=cfg.d_model))
    kernels = registry()
    torch.cuda.synchronize()
    cuda.reset_counts(kernels)
    torch.cuda.reset_peak_memory_stats(dev)
    ms = []
    for step in range(steps):
        batch = {k: torch.from_numpy(v).to(dev)
                 for k, v in data.batch_at(step).items()}
        t0 = time.perf_counter()
        params, opt_state, met = step_fn(params, opt_state, batch, step)
        loss, gnorm = float(met["loss"]), float(met["grad_norm"])
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
        print(f"[{tag}] train step {step}: loss {loss:.4f} gnorm "
              f"{gnorm:.3f}, {ms[-1]:.1f} ms", flush=True)
        check(math.isfinite(loss) and gnorm > 0,
              f"train step {step}: loss {loss}, grad norm {gnorm}")
    counts = {k.name: k.launches for k in kernels}
    peak = torch.cuda.max_memory_allocated(dev) / 2 ** 30
    layers = {r.name: r.count for r in lm.layer_runs(cfg)}
    for path, leaf in tree_mod.flatten_with_paths(params):
        if path in start:
            n = (groups or {}).get(path) or layers.get(path[0], 1)
            moved = (leaf != start[path]).reshape(n, -1).any(dim=-1)
            check(bool(moved.all()), f"{'/'.join(path)} did not move in "
                  f"{int((~moved).sum())} of {moved.numel()} layers or "
                  f"groups")
    for name in ("bundle_launcher", "adamw_member"):
        check(counts[name] > 0, f"{name} never launched in training")
    del start

    def one_more_step():
        nonlocal params, opt_state
        batch = {k: torch.from_numpy(v).to(dev)
                 for k, v in data.batch_at(steps).items()}
        params, opt_state, met = step_fn(params, opt_state, batch, steps)
        check(math.isfinite(float(met["loss"])), "non-finite profiled loss")

    # the profiler adds host time to every launch: a step of many small
    # kernels reads less busy under it than it runs, so its device time is
    # also set against the unprofiled steps' median
    busy, dev_s, launches = profiler(torch, one_more_step,
                                     f"{cfg.name} train step")
    step_ms = statistics.median(ms[1:])
    dev_ms = None if dev_s is None else dev_s * 1e3
    device = "not measured" if busy is None else (
        f"{busy:.1%} under the profiler, device time {dev_ms:.1f} ms, "
        f"{dev_ms / step_ms:.1%} of the median step, {launches} kernels")
    print(f"[{tag}] {cfg.name} train: {step_ms:.1f} ms/step (median of "
          f"steps 1-{steps - 1}), batch {batch_size} x seq {seq} in "
          f"{grad_accum} micro-batch(es), peak {peak:.2f} GiB, device busy "
          f"{device}; every watched leaf moved in every layer; launches "
          f"{counts}", flush=True)
    check(peak < 80, f"peak memory {peak:.1f} GiB")
    del params, opt_state, step_fn
    free_card(torch)
    return {"step_ms": step_ms, "steps_ms": ms, "peak_gib": peak,
            "busy": busy, "device_ms": dev_ms, "launches": launches,
            "counts": counts, "grad_accum": grad_accum, "batch": batch_size,
            "seq": seq}


def ln_train(torch, dev) -> tuple:
    """stablelm-3b at full width and depth, 3 steps: every LayerNorm bias,
    zero at the start, must have moved in every layer.  Returns
    (``plan_update_fusion``'s plan at the run's tokens, the run's
    numbers)."""
    from repro_torch import tree as tree_mod
    from repro_torch.configs import get_config
    from repro_torch.models import lm
    from repro_torch.train import train_loop as tl
    cfg = get_config(LN_TRAIN_ARCH)
    biases = [path for path, _ in tree_mod.flatten_with_paths(
        lm.abstract_params(cfg)) if path[-1] == "bias"]
    check(len(biases) == 3, f"{len(biases)} bias leaves, expected 3")
    fplan = tl.plan_update_fusion(lm.abstract_params(cfg),
                                  tokens=TRAIN_BATCH * TRAIN_SEQ)
    return fplan, train_full(torch, dev, cfg, steps=LN_TRAIN_STEPS,
                             tag="layernorm",
                             watch=lambda path: path[-1] == "bias")


def update_dw_chains(torch, dev, cfg, fplan, tokens: int, path: str,
                     want: tuple[int, int], seed: int, tag: str,
                     singles: bool = False) -> tuple[list[dict], dict]:
    """``cfg``'s ``plan_update_fusion`` plan (``want``: its bf16 and fp32
    dW->AdamW chains) compiled and run once with the counters reset on
    seeded state, each chain's p, m, v bitwise against its two members
    launched apart, and each AdamW update of a leaf past 2**31 elements
    bitwise against its plain version on its last TAIL_ROWS rows (the
    elements a 32-bit offset would miss; with ``singles``, every AdamW
    single whole); the first bf16 chain, where the plan has one, timed
    beside its plain version, its members apart and its bound (row i of
    ``path``)."""
    from repro_torch.core import executor, hfuse
    from repro_torch.core.timing import flush_buffer, median_ms
    from repro_torch.kernels import adam, cuda, registry, row
    from repro_torch.models import lm
    from repro_torch.train import train_loop as tl

    graph, layout = tl.update_graph(lm.abstract_params(cfg), tokens=tokens,
                                    max_tensors=8, include_dW=True)
    ops = {gop.op.name: gop.op for gop in graph}
    chains = [gop.op for gop in fplan.graph if gop.op.chain]
    n_bf16 = sum(not ops[c.chain[0]].member.fp32 for c in chains)
    check((n_bf16, len(chains) - n_bf16) == want,
          f"expected {want[0]} bf16 and {want[1]} fp32 dW->adamw chains, got "
          f"{[c.name for c in chains]}")
    program = executor.compile_plan(fplan)
    st = _update_dw_state(torch, dev, fplan, graph, layout, seed)
    before = {c.name: [st[f"{c.name}.{n}"].clone() for n in c.in_names]
              for c in chains}
    alone = [gop.op for gop in fplan.graph if not gop.op.chain]
    big = [op for op in alone if op.member.R * 128 > BIG_LEAF or singles]
    rows_kept = None if singles else TAIL_ROWS
    tails = {op.name: [st[f"{op.name}.{n}"][-rows_kept:].clone()
                       if rows_kept else st[f"{op.name}.{n}"].clone()
                       for n in ("scalars", "p", "g", "m", "v")]
             for op in big}
    kernels = registry()
    torch.cuda.synchronize()
    cuda.reset_counts(kernels)
    program(st)
    torch.cuda.synchronize()
    counts = {k.name: k.launches for k in kernels}
    check(counts["row_member"] == len(chains) and counts["adamw_member"] > 0
          and counts["bundle_launcher"] > 0,
          f"update+dW launches {counts}")
    for c in chains:
        ins = before[c.name]
        _separate(hfuse, ops[c.chain[0]], ops[c.chain[1]], "g")(*ins)
        for i, n in enumerate(c.out_names):
            check(torch.equal(st[f"{c.name}.{n}"], ins[3 + i]),
                  f"{c.name}.{n} differs from its separate members")
    del before
    for op in big:
        sc, *rest = tails.pop(op.name)
        mb = op.member
        want = adam.plain_adamw(sc[:1], *rest, b1=mb.b1, b2=mb.b2, eps=mb.eps,
                                wd=mb.wd)
        for n, w in zip(("p", "m", "v"), want):
            got = st[f"{op.name}.{n}"]
            check(torch.equal(got[-rows_kept:] if rows_kept else got, w),
                  f"{op.name}.{n} differs from the plain AdamW"
                  + (" past element 2**31" if rows_kept else ""))
        del sc, rest, want
    print(f"[{tag}] {cfg.name} update+dW program ({program.describe()}): "
          f"{len(chains)} dW->adamw chains bitwise equal to their separate "
          f"members; "
          + (f"{len(big)} AdamW singles (" + ", ".join(
              f"{op.member.R * 128:,}" for op in big) + " elements) each "
             "bitwise equal to the plain AdamW; " if singles else
             f"{len(big)} AdamW updates past 2**31 elements ("
             + ", ".join(f"{op.member.R * 128:,}" for op in big)
             + f") bitwise equal to the plain AdamW on their last "
             f"{TAIL_ROWS} rows; " if big else "")
          + f"launches {counts}", flush=True)
    head = next((c for c in chains if not ops[c.chain[0]].member.fp32),
                None)
    if head is None:
        del st
        free_card(torch)
        return [], {"counts": counts}
    dw, upd = ops[head.chain[0]], ops[head.chain[1]]
    ins = [st[f"{head.name}.{n}"] for n in head.in_names]
    del st                  # the timed chain's inputs alone stay on the card
    free_card(torch)
    run, plain = hfuse.run_single(head), hfuse.run_single(head, plain=True)
    err = compare_chain(torch, run(*[t.clone() for t in ins]),
                        plain(*[t.clone() for t in ins]), True)
    flush = flush_buffer(dev)
    g = dw.member
    rows = [kernel_row(
        path, f"row_member:{dw.name}->adamw bfloat16 "
        f"{g.M}x{g.K}@{g.K}x{g.N} ({cfg.name})", row.ROW, "row_member.cuh",
        "src/repro/core/stitch.py:177 (dW matmul->adamw)", err,
        median_ms(lambda: run(*ins), flush),
        median_ms(lambda: plain(*ins), flush),
        (_io_bytes(ins, ins[3:]), dw.flops + upd.flops), BF16_FLOPS, None,
        separate_ms=median_ms(lambda: _separate(hfuse, dw, upd, "g")(*ins),
                              flush))]
    del ins
    free_card(torch)
    return rows, {"counts": counts}


def ln_update_dw(torch, dev, fplan) -> tuple[list[dict], dict]:
    """stablelm-3b's plan: the head's bf16 and two norm leaves' fp32
    dW->AdamW chains; the head's chain timed."""
    from repro_torch.configs import get_config
    return update_dw_chains(torch, dev, get_config(LN_TRAIN_ARCH), fplan,
                            TRAIN_BATCH * TRAIN_SEQ, "layernorm_update_dw",
                            (1, 2), 28, "layernorm")


def phase_layernorm(torch, dev) -> tuple[list[dict], dict]:
    serve = {arch: ln_serve(torch, dev, arch, layers)
             for arch, layers in LN_SERVE}
    norm_err = ln_norm(torch, dev)
    fplan, train = ln_train(torch, dev)
    rows, update_dw = ln_update_dw(torch, dev, fplan)
    serve_counts = {}
    for r in serve.values():
        for k, n in r["counts"].items():
            serve_counts[k] = serve_counts.get(k, 0) + n
    return rows, {"serve": serve, "norm_err": norm_err, "train": train,
                  "update_dw": update_dw, "serve_counts": serve_counts}


# ---------------------------------------------------------------------------
# Phase 8h: recurrentgemma-2b, served hand-wired and trained
# ---------------------------------------------------------------------------
class local_kv_capture:
    """Within the block, each ``layers.local_attention`` call's k and v
    (B, S, Hkv, D), in call order: the rows a forward's local-attention
    layers compute at each position."""

    def __enter__(self) -> list:
        from repro_torch.models import layers
        self.layers, self.orig, seen = layers, layers.local_attention, []

        def capture(q, k, v, window, **kw):
            seen.append((k, v))
            return self.orig(q, k, v, window, **kw)

        layers.local_attention = capture
        return seen

    def __exit__(self, *exc) -> None:
        self.layers.local_attention = self.orig


def rg_prompt(torch, cfg, params, toks, S: int) -> tuple[list, list]:
    """``lm.prefill`` of ``toks[:, :S]`` and one ``lm.decode_step`` for each
    later token, against ``lm.forward`` of all of ``toks``: the logits' rel
    L2 at each step.  And every local-attention ring: after the prefill,
    each slot p % W holds the k and v rows the prefill's own layer computed
    at position p, for p the last W positions (bitwise: a handoff that puts
    them elsewhere fails); each decode step writes slot pos % W alone (every
    other slot bitwise unchanged), rows within RING_ROW_REL of the
    forward's at pos.  Returns (logits rel L2 by step, the written rows'
    worst rel L2 by decode step)."""
    from repro_torch.configs import LOCAL_ATTN
    from repro_torch.models import lm

    def rings(cache):
        return [lc for run, lc in lm.layer_params(cfg, cache)
                if run.kind == LOCAL_ATTN]

    with torch.no_grad():
        with local_kv_capture() as fwd:
            full = lm.forward(cfg, params, {"tokens": toks})[0]
        want = full[:, S - 1:].clone()
        del full
        check(bool(torch.isfinite(want).all()), f"S {S}: non-finite logits")
        with local_kv_capture() as pre:
            cache, got = lm.prefill(cfg, params, {"tokens": toks[:, :S]},
                                    max_len=toks.shape[1])
        rel, rows = [rel_l2(got, want[:, 0])], []
        check(len(rings(cache)) == len(pre) == len(fwd),
              f"S {S}: {len(rings(cache))} rings, {len(pre)} and "
              f"{len(fwd)} local-attention calls")
        for li, (lc, kv) in enumerate(zip(rings(cache), pre)):
            W = lc["k"].shape[1]
            p = torch.arange(max(0, S - W), S, device=toks.device)
            for name, t in zip(("k", "v"), kv):
                ring = torch.zeros_like(lc[name])
                ring[:, p % W] = t[:, p].to(ring.dtype)
                check(torch.equal(lc[name], ring),
                      f"S {S}: local layer {li}'s ring {name} after the "
                      f"prefill does not hold position p at slot p % {W}")
        for pos in range(S, toks.shape[1]):
            old = [{n: lc[n].clone() for n in ("k", "v")}
                   for lc in rings(cache)]
            got, cache = lm.decode_step(cfg, params, cache, toks[:, pos])
            rel.append(rel_l2(got, want[:, pos - S + 1]))
            worst = 0.0
            for li, (lc, before, kv) in enumerate(zip(rings(cache), old,
                                                      fwd)):
                W = lc["k"].shape[1]
                keep = torch.arange(W, device=toks.device) != pos % W
                for name, t in zip(("k", "v"), kv):
                    check(torch.equal(lc[name][:, keep],
                                      before[name][:, keep]),
                          f"S {S}: decode at {pos} wrote local layer {li}'s "
                          f"ring {name} outside slot {pos % W}")
                    worst = max(worst, rel_l2(lc[name][:, pos % W],
                                              t[:, pos]))
            rows.append(worst)
        check(max(rows) <= RING_ROW_REL,
              f"S {S}: decode's ring rows off the forward's: {rows}")
    return rel, rows


def rg_invariant(torch, dev, cfg, params, gen) -> dict:
    """``rg_prompt`` on two prompts of S + RG_DECODE tokens for each S of
    RG_PROMPTS, the logits within LOGITS_REL_L2; and the forward at 1 x
    RG_LONG, finite."""
    from repro_torch.models import lm

    rel, rows = {}, {}
    for S in RG_PROMPTS:
        toks = torch.randint(1, cfg.vocab_size, (2, S + RG_DECODE),
                             generator=gen, device=dev, dtype=torch.int32)
        rel[S], rows[S] = rg_prompt(torch, cfg, params, toks, S)
    with torch.no_grad():
        toks = torch.randint(1, cfg.vocab_size, (1, RG_LONG), generator=gen,
                             device=dev, dtype=torch.int32)
        long_ok = bool(torch.isfinite(
            lm.forward(cfg, params, {"tokens": toks})[0]).all())
    ring = {S: "aligned" if S % cfg.local_window == 0 else "misaligned"
            for S in rel}
    print(f"[recurrent] lm.prefill(S) and {RG_DECODE} lm.decode_steps "
          f"against lm.forward(S + {RG_DECODE}) at positions S - 1 .. S + "
          f"{RG_DECODE - 1}, 2 prompts, rel L2 by step: "
          + "; ".join(f"S {S} (ring {ring[S]}): "
                      + ", ".join(f"{x:.3e}" for x in v)
                      for S, v in rel.items())
          + f" (limit {LOGITS_REL_L2}); every local ring after the prefill "
          f"holds position p at slot p % W bitwise, each decode step wrote "
          f"slot pos % W alone, its rows off the forward's by (worst layer, "
          f"by step) "
          + "; ".join(f"S {S}: " + ", ".join(f"{x:.3e}" for x in v)
                      for S, v in rows.items())
          + f" (limit {RING_ROW_REL}); forward at 1 x {RG_LONG} "
          f"({RG_LONG // cfg.local_window} local chunks) finite: {long_ok}",
          flush=True)
    check(max(max(v) for v in rel.values()) <= LOGITS_REL_L2,
          f"prefill/decode off the forward: {rel}")
    check(long_ok, f"non-finite logits at 1 x {RG_LONG}")
    return {"logits": rel, "ring_rows": rows}


def rg_serve(torch, dev, cfg, params) -> dict:
    """recurrentgemma-2b's hand-wired serve (``hand_wired_serve``)."""
    return hand_wired_serve(torch, dev, cfg, params, RG_SERVE_PROMPTS, RG_NEW,
                            RG_MAX_LEN, "recurrent")


def hand_wired_serve(torch, dev, cfg, params, prompts, new: int,
                     max_len: int, tag: str) -> dict:
    """The planned engine refuses on the card and names --hand-wired; the
    hand-wired continuous engine (a slot a prompt) serves ``prompts``,
    ``new`` tokens each, with the counters reset: no kernel of the port
    launched, each first token ``lm.prefill``'s greedy token on its prompt
    alone."""
    import numpy as np

    from repro_torch.kernels import cuda, registry
    from repro_torch.models import lm
    from repro_torch.serve.engine import Request, ServeEngine

    B = len(prompts)
    try:
        ServeEngine(cfg, params, batch=B, max_len=max_len, device=dev)
        refusal = None
    except ValueError as e:
        refusal = str(e)
    check(refusal is not None and "--hand-wired" in refusal,
          f"a planned engine on the card did not refuse: {refusal}")
    print(f"[{tag}] planned engine refuses: {refusal}")
    rng = np.random.default_rng(5)
    reqs = [Request(rid=i, prompt=rng.integers(1, cfg.vocab_size,
                                               L).astype(np.int32),
                    max_new_tokens=new)
            for i, L in enumerate(prompts)]
    eng = ServeEngine(cfg, params, batch=B, max_len=max_len,
                      plan_fusion=False, device=dev)
    check(not eng.executed, "the fallback executes a program")
    kernels = registry()
    torch.cuda.synchronize()
    cuda.reset_counts(kernels)
    t0 = time.perf_counter()
    eng.run(reqs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = {k.name: k.launches for k in kernels}
    tokens = sum(len(r.out_tokens) for r in reqs)
    check(all(r.done and len(r.out_tokens) == new for r in reqs),
          "a request did not complete")
    check(not any(counts.values()),
          f"the hand-wired path launched a kernel: {counts}")
    firsts = []
    with torch.no_grad():
        for r in reqs:
            _c, lg = lm.prefill(cfg, params, {"tokens": torch.from_numpy(
                r.prompt[None]).to(dev)}, max_len=eng.cache_len)
            firsts.append(int(lm.greedy_sample(cfg, lg)[0]))
    check(firsts == [r.out_tokens[0] for r in reqs],
          f"first tokens {[r.out_tokens[0] for r in reqs]} are not "
          f"lm.prefill's greedy tokens {firsts}")
    print(f"[{tag}] fallback: {len(reqs)} requests (prompts "
          f"{tuple(prompts)}), {tokens} tokens in {wall:.3f}s "
          f"({tokens / wall:.2f} tok/s, host clock); first tokens equal "
          f"lm.prefill's greedy tokens; no kernel launched", flush=True)
    return {"tokens_per_s": tokens / wall, "seconds": wall,
            "counts": counts}


def phase_recurrent(torch, dev) -> tuple[list[dict], dict]:
    from repro_torch import tree as tree_mod
    from repro_torch.configs import get_config
    from repro_torch.models import lm
    from repro_torch.train import train_loop as tl

    cfg = get_config(RG_ARCH)
    check(cfg.num_layers == 26 and cfg.d_model == 2560, "not full width")
    t0 = time.perf_counter()
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    params = lm.init(cfg, gen, device=dev)
    n_params = sum(t.numel() for t in tree_mod.leaves(params))
    print(f"[recurrent] {cfg.name}: {cfg.num_layers} layers in "
          f"{len(lm.layer_runs(cfg))} runs, {n_params:,} params, set up in "
          f"{time.perf_counter() - t0:.1f}s", flush=True)
    inv = rg_invariant(torch, dev, cfg, params, gen)
    serve = rg_serve(torch, dev, cfg, params)
    del params
    free_card(torch)
    train = train_full(
        torch, dev, cfg, steps=RG_TRAIN_STEPS, tag="recurrent",
        grad_accum=RG_GRAD_ACCUM,
        watch=lambda path: path[-1] in ("lam", "gate_a", "conv_w", "conv_b"))
    fplan = tl.plan_update_fusion(lm.abstract_params(cfg),
                                  tokens=RG_DW_TOKENS)
    rows, update_dw = update_dw_chains(torch, dev, cfg, fplan, RG_DW_TOKENS,
                                       "recurrent_update_dw", (1, 0), 29,
                                       "recurrent")
    return rows, {"invariant": inv, "serve": serve, "train": train,
                  "update_dw": update_dw}


# ---------------------------------------------------------------------------
# Phase 8i: deepseek-v2-236b at full width, served hand-wired and trained
# ---------------------------------------------------------------------------
class mla_rows_capture:
    """Within the block, each ``mla.attend_full`` call's latent (B, S,
    kv_lora) and rope key (B, S, rope), in call order: the rows a full
    sequence's MLA layers compute at each position."""

    def __enter__(self) -> list:
        from repro_torch.models import mla
        self.mla, self.orig, seen = mla, mla.attend_full, []

        def capture(cfg, p, x, positions):
            out, rows = self.orig(cfg, p, x, positions)
            seen.append(rows)
            return out, rows

        mla.attend_full = capture
        return seen

    def __exit__(self, *exc) -> None:
        self.mla.attend_full = self.orig


class drops_capture:
    """Within the block, each MoE routing's dropped (token, choice) pairs:
    a (T,) count a token, in call order (``route_from_logits``'s slot is
    the capacity C where a pair was dropped)."""

    def __enter__(self) -> list:
        from repro_torch.models import moe
        self.moe, self.orig, seen = moe, moe.route_from_logits, []

        def capture(cfg, logits):
            r = self.orig(cfg, logits)
            seen.append((r.slot == r.dispatch_idx.shape[1]).sum(dim=1))
            return r

        moe.route_from_logits = capture
        return seen

    def __exit__(self, *exc) -> None:
        self.moe.route_from_logits = self.orig


def ds_prompt(torch, cfg, params, toks, S: int) -> dict:
    """``lm.prefill`` of ``toks[:, :S]`` and one ``lm.decode_step`` for each
    later token, against ``lm.forward`` of all of ``toks``: the logits' rel
    L2 at each step.  Every MLA layer's cache: after the prefill rows < S
    hold the rows the prefill's own layer computed (bitwise) and the rest
    zeros; each decode step writes row pos alone (every other row bitwise
    unchanged), its rows within MLA_ROW_REL of the forward's at pos.  And
    the (token, choice) pairs the capacity dropped: in the forward, at
    the compared positions of the forward, and in the prefill and decode.
    Returns {"logits", "rows", "drops"}."""
    from repro_torch.models import lm

    B, total = toks.shape

    def mla_caches(cache):
        return [lc for _run, lc in lm.layer_params(cfg, cache)]

    with torch.no_grad():
        with mla_rows_capture() as fwd, drops_capture() as fwd_lost:
            full = lm.forward(cfg, params, {"tokens": toks})[0]
        want = full[:, S - 1:].clone()
        del full
        check(bool(torch.isfinite(want).all()), f"S {S}: non-finite logits")
        with mla_rows_capture() as pre, drops_capture() as run_lost:
            cache, got = lm.prefill(cfg, params, {"tokens": toks[:, :S]},
                                    max_len=total)
            rel, worst = [rel_l2(got, want[:, 0])], []
            check(len(mla_caches(cache)) == len(pre) == len(fwd)
                  == cfg.num_layers, f"S {S}: {len(pre)} and {len(fwd)} "
                  f"MLA calls for {cfg.num_layers} layers")
            for li, (lc, rows) in enumerate(zip(mla_caches(cache), pre)):
                for name, t in zip(("latent", "rope"), rows):
                    check(torch.equal(lc[name][:, :S], t)
                          and not lc[name][:, S:].any(),
                          f"S {S}: MLA layer {li}'s {name} rows after the "
                          f"prefill are not the prefill layer's rows")
            for pos in range(S, total):
                old = [{n: lc[n].clone() for n in ("latent", "rope")}
                       for lc in mla_caches(cache)]
                got, cache = lm.decode_step(cfg, params, cache, toks[:, pos])
                rel.append(rel_l2(got, want[:, pos - S + 1]))
                w = 0.0
                for li, (lc, before, rows) in enumerate(zip(
                        mla_caches(cache), old, fwd)):
                    keep = torch.arange(total, device=toks.device) != pos
                    for name, t in zip(("latent", "rope"), rows):
                        check(torch.equal(lc[name][:, keep],
                                          before[name][:, keep]),
                              f"S {S}: decode at {pos} wrote MLA layer "
                              f"{li}'s {name} outside row {pos}")
                        w = max(w, rel_l2(lc[name][:, pos], t[:, pos]))
                worst.append(w)
    # the forward's tokens are (b, s) flattened: the compared positions
    # are S - 1 .. total - 1 of each row
    at = torch.zeros(total, dtype=torch.bool, device=toks.device)
    at[S - 1:] = True
    at = at.repeat(B)
    drops = {"forward": int(sum(int(x.sum()) for x in fwd_lost)),
             "compared": int(sum(int(x[at].sum()) for x in fwd_lost)),
             "prefill_decode": int(sum(int(x.sum()) for x in run_lost))}
    return {"logits": rel, "rows": worst, "drops": drops}


def ds_invariant(torch, dev, cfg, params, gen) -> dict:
    """``ds_prompt`` on 2 prompts of DS_PROMPT + DS_DECODE tokens at the
    config's capacity factor; where a pair dropped, again at each factor
    of DS_CAPACITY_FACTORS and then E / top_k (no pair can drop: each
    expert's capacity is the batch's tokens) until none did, the weights
    unchanged.  The run without drops holds the logits within
    LOGITS_REL_L2 and the written rows within MLA_ROW_REL; the forward
    at 1 x DS_LONG is finite."""
    import dataclasses

    from repro_torch.models import lm

    toks = torch.randint(1, cfg.vocab_size, (2, DS_PROMPT + DS_DECODE),
                         generator=gen, device=dev, dtype=torch.int32)
    m = cfg.moe
    runs = {}
    for cf in (m.capacity_factor, *DS_CAPACITY_FACTORS,
               m.num_experts / m.top_k):
        c = dataclasses.replace(cfg, moe=dataclasses.replace(
            m, capacity_factor=cf))
        r = runs[cf] = ds_prompt(torch, c, params, toks, DS_PROMPT)
        print(f"[deepseek] capacity factor {cf:g}: dropped (token, choice) "
              f"pairs: forward {r['drops']['forward']} (at the compared "
              f"positions {r['drops']['compared']}), prefill + decode "
              f"{r['drops']['prefill_decode']}; rel L2 by step "
              + ", ".join(f"{x:.3e}" for x in r["logits"])
              + "; decode's rows off the forward's by step "
              + ", ".join(f"{x:.3e}" for x in r["rows"]), flush=True)
        if not r["drops"]["forward"] and not r["drops"]["prefill_decode"]:
            break
    check(not r["drops"]["forward"] and not r["drops"]["prefill_decode"],
          f"pairs dropped at capacity factor {cf}")
    print(f"[deepseek] lm.prefill({DS_PROMPT}) and {DS_DECODE} "
          f"lm.decode_steps against lm.forward({DS_PROMPT + DS_DECODE}), "
          f"2 prompts, held at capacity factor {cf:g}"
          + ("" if cf == m.capacity_factor else
             f" (raised from {m.capacity_factor:g}: pairs dropped there; "
             "weights unchanged)")
          + f": rel L2 by step " + ", ".join(f"{x:.3e}" for x in r["logits"])
          + f" (limit {LOGITS_REL_L2}); after the prefill every MLA layer's "
          f"rows below S are the prefill layer's, bitwise; each decode step "
          f"wrote row pos alone, its rows off the forward's by "
          + ", ".join(f"{x:.3e}" for x in r["rows"])
          + f" (limit {MLA_ROW_REL})", flush=True)
    check(max(r["logits"]) <= LOGITS_REL_L2,
          f"prefill/decode off the forward: {r['logits']}")
    check(max(r["rows"]) <= MLA_ROW_REL,
          f"decode's latent/rope rows off the forward's: {r['rows']}")
    with torch.no_grad():
        toks = torch.randint(1, cfg.vocab_size, (1, DS_LONG), generator=gen,
                             device=dev, dtype=torch.int32)
        long_ok = bool(torch.isfinite(
            lm.forward(cfg, params, {"tokens": toks})[0]).all())
    print(f"[deepseek] forward at 1 x {DS_LONG} ({DS_LONG // 1024} query "
          f"chunks) finite: {long_ok}", flush=True)
    check(long_ok, f"non-finite logits at 1 x {DS_LONG}")
    return {"runs": runs, "capacity_factor": cf}


def phase_deepseek(torch, dev) -> tuple[list[dict], dict]:
    from repro_torch import tree as tree_mod
    from repro_torch.configs import MLA, get_config
    from repro_torch.launch.serve import cut_depth
    from repro_torch.models import lm
    from repro_torch.train import train_loop as tl

    full = get_config(DS_ARCH)
    check(full.d_model == 5120 and full.num_heads == 128
          and full.moe.num_experts == 160 and full.vocab_size == 102400,
          "not full width")
    cfg = cut_depth(full, DS_SERVE_LAYERS)
    check(cfg.pattern == (MLA,) * DS_SERVE_LAYERS, "the cut lost MLA")
    t0 = time.perf_counter()
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    params = lm.init(cfg, gen, device=dev)
    n_params = sum(t.numel() for t in tree_mod.leaves(params))
    print(f"[deepseek] {cfg.name}: {cfg.num_layers} of {full.num_layers} "
          f"layers in runs {[(r.name, r.count) for r in lm.layer_runs(cfg)]}"
          f", {n_params:,} params, {torch.cuda.memory_allocated(dev) / 2**30:.2f}"
          f" GiB, set up in {time.perf_counter() - t0:.1f}s", flush=True)
    inv = ds_invariant(torch, dev, cfg, params, gen)
    free_card(torch)
    serve = hand_wired_serve(torch, dev, cfg, params, DS_SERVE_PROMPTS,
                             DS_NEW, DS_MAX_LEN, "deepseek")
    serve["layers"] = cfg.num_layers
    del params
    free_card(torch)
    tcfg = cut_depth(full, DS_TRAIN_LAYERS)
    train = train_full(
        torch, dev, tcfg, steps=DS_TRAIN_STEPS, tag="deepseek", batch_size=1,
        seq=DS_TRAIN_SEQ, watch=lambda path: path[-1] in DS_WATCH
        or path[-2] in ("q_norm", "kv_norm"))
    fplan = tl.plan_update_fusion(lm.abstract_params(tcfg),
                                  tokens=DS_DW_TOKENS)
    rows, update_dw = update_dw_chains(torch, dev, tcfg, fplan, DS_DW_TOKENS,
                                       "deepseek_update_dw", (6, 0), 30,
                                       "deepseek")
    return rows, {"invariant": inv, "serve": serve, "train": train,
                  "update_dw": update_dw}

# ---------------------------------------------------------------------------
# Phase 8j: xlstm-1.3b at full width and depth, served hand-wired and trained
# ---------------------------------------------------------------------------
def xl_prompt(torch, cfg, params, toks, S: int) -> dict:
    """``lm.prefill`` of ``toks[:, :S]`` and one ``lm.decode_step`` for each
    later token, against ``lm.forward`` of all of ``toks``: the logits' rel
    L2 at each step.  Then every layer's cache leaves (the recurrent state
    and the conv window) after the last decode step against the leaves
    ``lm.prefill`` of all of ``toks`` hands off: the worst layer's rel L2
    by kind and leaf.  Returns {"logits", "state"}."""
    from repro_torch.models import lm

    total = toks.shape[1]
    with torch.no_grad():
        full = lm.forward(cfg, params, {"tokens": toks})[0]
        want = full[:, S - 1:].clone()
        del full
        check(bool(torch.isfinite(want).all()), f"S {S}: non-finite logits")
        cache, got = lm.prefill(cfg, params, {"tokens": toks[:, :S]},
                                max_len=total)
        rel = [rel_l2(got, want[:, 0])]
        for pos in range(S, total):
            got, cache = lm.decode_step(cfg, params, cache, toks[:, pos])
            rel.append(rel_l2(got, want[:, pos - S + 1]))
        ref, _ = lm.prefill(cfg, params, {"tokens": toks}, max_len=total)
        check(int(cache["pos"]) == int(ref["pos"]) == total,
              f"S {S}: cache positions {int(cache['pos'])}, "
              f"{int(ref['pos'])}")
        state: dict = {}
        for (run, a), (_run, b) in zip(lm.layer_params(cfg, cache),
                                       lm.layer_params(cfg, ref)):
            for name in a:
                key = f"{run.kind}.{name}"
                state[key] = max(state.get(key, 0.0), rel_l2(a[name],
                                                             b[name]))
    return {"logits": rel, "state": state}


def xl_invariant(torch, dev, cfg, params, gen) -> dict:
    """``xl_prompt`` on two prompts of S + XL_DECODE tokens for each S of
    XL_PROMPTS and XL_SHORT, the logits within LOGITS_REL_L2 and the
    handed-off state within XL_STATE_REL; and the forward at 1 x XL_LONG,
    finite."""
    from repro_torch.models import lm

    def form(S):
        return "chunks of 256" if S % 256 == 0 else "one chunk"
    runs = {}
    for S in (*XL_PROMPTS, XL_SHORT):
        toks = torch.randint(1, cfg.vocab_size, (2, S + XL_DECODE),
                             generator=gen, device=dev, dtype=torch.int32)
        r = runs[S] = xl_prompt(torch, cfg, params, toks, S)
        print(f"[xlstm] lm.prefill({S}) (mLSTM in {form(S)}) and "
              f"{XL_DECODE} lm.decode_steps against lm.forward("
              f"{S + XL_DECODE}) ({form(S + XL_DECODE)}), 2 prompts: rel "
              f"L2 by step " + ", ".join(f"{x:.3e}" for x in r["logits"])
              + f" (limit {LOGITS_REL_L2}); each layer's state after them "
              f"against lm.prefill({S + XL_DECODE})'s, worst layer: "
              + ", ".join(f"{k} {v:.3e}" for k, v in r["state"].items())
              + f" (limit {XL_STATE_REL})", flush=True)
    check(max(max(r["logits"]) for r in runs.values()) <= LOGITS_REL_L2,
          f"prefill/decode off the forward: "
          f"{ {S: r['logits'] for S, r in runs.items()} }")
    check(max(max(r["state"].values()) for r in runs.values())
          <= XL_STATE_REL, f"decode's state off prefill(S + "
          f"{XL_DECODE})'s: { {S: r['state'] for S, r in runs.items()} }")
    with torch.no_grad():
        toks = torch.randint(1, cfg.vocab_size, (1, XL_LONG), generator=gen,
                             device=dev, dtype=torch.int32)
        t0 = time.perf_counter()
        long_ok = bool(torch.isfinite(
            lm.forward(cfg, params, {"tokens": toks})[0]).all())
        long_s = time.perf_counter() - t0
    print(f"[xlstm] forward at 1 x {XL_LONG} ({XL_LONG // 256} mLSTM "
          f"chunks) finite: {long_ok}, {long_s:.1f}s", flush=True)
    check(long_ok, f"non-finite logits at 1 x {XL_LONG}")
    return {"runs": runs, "long_s": long_s}


def xl_slstm_cost(torch, dev, cfg, train: dict) -> dict:
    """The sLSTM layers' share of a train step: one sLSTM block (norm1,
    the sLSTM loop, its FFN, the residual) at the step's shape under
    remat, as the step runs it (forward, then the backward's recompute
    and backward), on seeded weights and input; its wall time (median of
    2 after a warm-up) and, from a device-only trace, its device time and
    kernels; each times the config's sLSTM layers, beside the step's."""
    import dataclasses

    from torch.utils.checkpoint import checkpoint

    from repro_torch import tree as tree_mod
    from repro_torch.configs import SLSTM
    from repro_torch.models import lm

    n_layers = sum(r.count for r in lm.layer_runs(cfg) if r.kind == SLSTM)
    one = dataclasses.replace(cfg, num_layers=1, block_pattern=(SLSTM,))
    run = lm.layer_runs(one)[0]
    gen = torch.Generator(device=dev)
    gen.manual_seed(7)
    lp = tree_mod.map_tree(lambda t: t.detach().requires_grad_(
        t.is_floating_point()), lm.init(one, gen, device=dev)[run.name])
    shape = (train["batch"], train["seq"], cfg.d_model)
    dt = lm.torch_dtype(cfg.dtype)
    x = torch.randn(shape, generator=gen, device=dev).to(dt) \
        .requires_grad_()
    dy = torch.randn(shape, generator=gen, device=dev).to(dt)

    def layer():
        y, _aux, _c = checkpoint(lm.block_apply_seq, one, run, lp, x,
                                 use_reentrant=False)
        y.backward(dy)
        for t in (x, *tree_mod.leaves(lp)):
            t.grad = None

    ms = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        layer()
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
    layer_ms = statistics.median(ms[1:])
    _busy, dev_s, launches = device_events(torch, layer,
                                           "one sLSTM layer, fwd+bwd")
    step_ms, step_launches = train["step_ms"], train["launches"]
    out = {"layers": n_layers, "layer_ms": layer_ms,
           "layer_device_ms": None if dev_s is None else dev_s * 1e3,
           "layer_launches": launches,
           "share": n_layers * layer_ms / step_ms,
           "launches": None if launches is None else n_layers * launches}
    rest = ("not measured" if step_launches is None or launches is None
            else f"{step_launches - n_layers * launches} kernels for the "
            f"rest of the step ({step_launches} in all)")
    print(f"[xlstm] one sLSTM layer at {shape[0]} x {shape[1]} under remat "
          f"(forward, recompute, backward): {layer_ms:.1f} ms (runs "
          + ", ".join(f"{v:.1f}" for v in ms) + f"), device "
          + ("not measured" if dev_s is None else f"{dev_s * 1e3:.1f} ms")
          + f", {launches} kernels; x {n_layers} layers: "
          f"{n_layers * layer_ms:.1f} ms of the {step_ms:.1f} ms step "
          f"({out['share']:.1%}), {out['launches']} kernels; {rest}",
          flush=True)
    del lp, x, dy
    free_card(torch)
    return out


def xl_update_singles(torch, dev, cfg, fplan, tokens: int, seed: int
                      ) -> dict:
    """``cfg``'s ``plan_update_fusion`` plan, eight AdamW singles and no
    dW chain, through ``update_dw_chains``: each single's p, m, v bitwise
    against its plain version."""
    want = {f"adamw_run{r:02d}_mlstm____rec____{w}"
            for r in (0, 8, 16, 24) for w in ("w_up", "w_v")}
    got = {gop.op.name for gop in fplan.graph}
    check(got == want, f"expected eight AdamW singles {sorted(want)}, got "
          f"{sorted(got)}")
    return update_dw_chains(torch, dev, cfg, fplan, tokens, "xlstm_update_dw",
                            (0, 0), seed, "xlstm", singles=True)[1]


def phase_xlstm(torch, dev) -> tuple[list[dict], dict]:
    from repro_torch import tree as tree_mod
    from repro_torch.configs import get_config
    from repro_torch.models import lm
    from repro_torch.train import train_loop as tl

    cfg = get_config(XL_ARCH)
    check(cfg.num_layers == 48 and cfg.d_model == 2048 and cfg.d_ff == 0
          and cfg.vocab_size == 50304, "not full width and depth")
    t0 = time.perf_counter()
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    params = lm.init(cfg, gen, device=dev)
    n_params = sum(t.numel() for t in tree_mod.leaves(params))
    check(n_params == lm.count_params(cfg) == 2_901_496_144,
          f"{n_params:,} params")
    print(f"[xlstm] {cfg.name}: {cfg.num_layers} layers in runs "
          f"{[(r.name, r.count) for r in lm.layer_runs(cfg)][:3]}... "
          f"({len(lm.layer_runs(cfg))} runs), {n_params:,} params, "
          f"{torch.cuda.memory_allocated(dev) / 2**30:.2f} GiB, set up in "
          f"{time.perf_counter() - t0:.1f}s", flush=True)
    walls = {}
    t0 = time.perf_counter()
    inv = xl_invariant(torch, dev, cfg, params, gen)
    walls["invariant"] = time.perf_counter() - t0
    free_card(torch)
    t0 = time.perf_counter()
    serve = hand_wired_serve(torch, dev, cfg, params, XL_SERVE_PROMPTS,
                             XL_NEW, XL_MAX_LEN, "xlstm")
    walls["serve"] = time.perf_counter() - t0
    del params
    free_card(torch)
    t0 = time.perf_counter()
    train = train_full(
        torch, dev, cfg, steps=XL_TRAIN_STEPS, tag="xlstm",
        watch=lambda path: path[-1] in XL_WATCH, profiler=device_events)
    walls["train"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    slstm = xl_slstm_cost(torch, dev, cfg, train)
    walls["slstm"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    fplan = tl.plan_update_fusion(lm.abstract_params(cfg),
                                  tokens=XL_DW_TOKENS)
    update = xl_update_singles(torch, dev, cfg, fplan, XL_DW_TOKENS, 31)
    walls["update"] = time.perf_counter() - t0
    print("[xlstm] wall s: " + ", ".join(f"{k} {v:.1f}"
                                         for k, v in walls.items()),
          flush=True)
    return [], {"invariant": inv, "serve": serve, "train": train,
                "slstm": slstm, "update_dw": update, "walls": walls}


# ---------------------------------------------------------------------------
# Phase 8k: the frontend configs (image stub, four codebooks) at full width
# ---------------------------------------------------------------------------
def fe_batch(torch, cfg, gen, dev, B: int, S: int) -> dict:
    """Seeded inputs of S positions: tokens (B, S) and fp32 pixel_embeds
    (B, n, d) for the image stub, codes (B, K, S) for the audio stub."""
    if cfg.frontend == "audio_stub":
        return {"tokens": torch.randint(
            0, cfg.vocab_size, (B, cfg.num_codebooks, S), generator=gen,
            device=dev, dtype=torch.int32)}
    return {"tokens": torch.randint(1, cfg.vocab_size, (B, S), generator=gen,
                                    device=dev, dtype=torch.int32),
            "pixel_embeds": torch.randn((B, cfg.num_image_tokens,
                                         cfg.d_model), generator=gen,
                                        device=dev)}


def fe_upto(batch: dict, S: int) -> dict:
    """The batch's first S positions (the image rows stay whole)."""
    return {k: v[..., :S] if k == "tokens" else v for k, v in batch.items()}


def fe_prompt(torch, cfg, params, batch, S: int, new: int) -> list:
    """``lm.prefill`` of the batch's first S positions and one
    ``lm.decode_step`` for each of the next ``new``, against ``lm.forward``
    of the whole batch at the same positions (attention is causal: the
    positions after S + new reach none of them): the logits' rel L2 at
    each step (audio: the (B, K, V) logits)."""
    from repro_torch.models import lm

    with torch.no_grad():
        full = lm.forward(cfg, params, batch)[0]
        want = full[:, S - 1:S + new].clone()
        del full
        check(bool(torch.isfinite(want).all()), f"S {S}: non-finite logits")
        cache, got = lm.prefill(cfg, params, fe_upto(batch, S),
                                max_len=S + new)
        rel = [rel_l2(got, want[:, 0])]
        for i in range(new):
            got, cache = lm.decode_step(cfg, params, cache,
                                        batch["tokens"][..., S + i])
            rel.append(rel_l2(got, want[:, i + 1]))
        check(int(cache["pos"]) == S + new,
              f"S {S}: cache position {int(cache['pos'])}")
    return rel


def fe_invariant(torch, dev, cfg, params, gen) -> dict:
    """``fe_prompt`` on 2 prompts of each FE_PROMPTS length, FE_DECODE
    decode steps, within LOGITS_REL_L2; the forward at 1 x FE_LONG
    finite."""
    from repro_torch.models import lm

    runs = {}
    for S in FE_PROMPTS:
        total = S + FE_DECODE
        if total > 1024:
            total = -(-total // 1024) * 1024
        rel = runs[S] = fe_prompt(torch, cfg, params,
                                  fe_batch(torch, cfg, gen, dev, 2, total),
                                  S, FE_DECODE)
        print(f"[frontends] {cfg.name}: lm.prefill({S}) and {FE_DECODE} "
              f"lm.decode_steps against lm.forward({total}) at the same "
              f"positions, 2 prompts: rel L2 by step "
              + ", ".join(f"{x:.3e}" for x in rel)
              + f" (limit {LOGITS_REL_L2})", flush=True)
    check(max(max(r) for r in runs.values()) <= LOGITS_REL_L2,
          f"{cfg.name}: prefill/decode off the forward: {runs}")
    with torch.no_grad():
        t0 = time.perf_counter()
        long_ok = bool(torch.isfinite(lm.forward(
            cfg, params, fe_batch(torch, cfg, gen, dev, 1, FE_LONG))[0])
            .all())
        long_s = time.perf_counter() - t0
    print(f"[frontends] {cfg.name}: forward at 1 x {FE_LONG} finite: "
          f"{long_ok}, {long_s:.1f}s", flush=True)
    check(long_ok, f"{cfg.name}: non-finite logits at 1 x {FE_LONG}")
    return {"runs": runs, "long_s": long_s}


def fe_serve(torch, dev, cfg, params, gen) -> dict:
    """The engines refuse: a planned one on the card names --hand-wired, a
    hand-wired one's ``run`` raises NotImplementedError (token prompts
    only, as the reference's engines fail on these configs).  Then greedy
    serving through ``lm.prefill`` and ``lm.serve_step_greedy``:
    FE_SERVE_BATCH prompts of FE_SERVE_PROMPT tokens, FE_NEW new tokens
    (audio: FE_NEW steps of K codes), with the counters reset: no kernel
    of the port launched; tokens/s on the host clock; the codes' agreement
    with ``lm.forward``'s greedy codes over the served sequence."""
    from repro_torch.kernels import cuda, registry
    from repro_torch.models import lm
    from repro_torch.serve.engine import Request, ServeEngine

    max_len = FE_SERVE_PROMPT + FE_NEW
    try:
        ServeEngine(cfg, params, batch=FE_SERVE_BATCH, max_len=max_len,
                    device=dev)
        refusal = None
    except ValueError as e:
        refusal = str(e)
    check(refusal is not None and "--hand-wired" in refusal,
          f"a planned engine on the card did not refuse: {refusal}")
    eng = ServeEngine(cfg, params, batch=FE_SERVE_BATCH, max_len=max_len,
                      plan_fusion=False, device=dev)
    try:
        eng.run([Request(rid=0, prompt=list(range(1, 9)),
                         max_new_tokens=2)])
        run_refusal = None
    except NotImplementedError as e:
        run_refusal = str(e)
    check(run_refusal is not None
          and "the engines take token prompts only" in run_refusal,
          f"the hand-wired engine's run did not refuse: {run_refusal}")
    print(f"[frontends] {cfg.name}: planned engine refuses: {refusal}; "
          f"hand-wired run refuses: {run_refusal}", flush=True)
    batch = fe_batch(torch, cfg, gen, dev, FE_SERVE_BATCH, FE_SERVE_PROMPT)
    kernels = registry()
    torch.cuda.synchronize()
    cuda.reset_counts(kernels)
    t0 = time.perf_counter()
    with torch.no_grad():
        cache, logits = lm.prefill(cfg, params, batch, max_len=max_len)
        tok = lm.greedy_sample(cfg, logits)
        out = [tok]
        for _ in range(FE_NEW - 1):
            tok, cache = lm.serve_step_greedy(cfg, params, cache, tok)
            out.append(tok)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = {k.name: k.launches for k in kernels}
    check(not any(counts.values()),
          f"greedy serving launched a kernel: {counts}")
    codes = torch.stack(out, dim=-1)            # (B, new) or (B, K, new)
    check(tuple(codes.shape[1:-1]) == ((cfg.num_codebooks,)
                                       if cfg.frontend == "audio_stub"
                                       else ())
          and bool(((codes >= 0) & (codes < cfg.vocab_size)).all()),
          f"served codes of shape {tuple(codes.shape)}")
    with torch.no_grad():
        seq = dict(batch, tokens=torch.cat([batch["tokens"],
                                            codes[..., :-1]], dim=-1))
        full = lm.forward(cfg, params, seq)[0][:, FE_SERVE_PROMPT - 1:]
        agree = float((lm.greedy_sample(cfg, full).movedim(1, -1)
                       == codes).float().mean())
        del full
    steps = FE_SERVE_BATCH * FE_NEW
    print(f"[frontends] {cfg.name}: greedy serving of {FE_SERVE_BATCH} x "
          f"{FE_SERVE_PROMPT} prompts, {FE_NEW} new "
          + (f"steps of {cfg.num_codebooks} codes" if cfg.frontend
             == "audio_stub" else "tokens")
          + f" in {wall:.3f}s ({steps / wall:.2f} tok/s, host clock); no "
          f"kernel launched; agreement with lm.forward's greedy codes over "
          f"the served sequence {agree:.3f}", flush=True)
    return {"tokens_per_s": steps / wall, "seconds": wall, "counts": counts,
            "agreement": agree}


def phase_frontends(torch, dev) -> tuple[list[dict], dict]:
    from repro_torch import tree as tree_mod
    from repro_torch.configs import get_config
    from repro_torch.models import lm
    from repro_torch.train import train_loop as tl

    out, rows, walls = {}, [], {}
    for arch in FE_ARCHS:
        cfg = get_config(arch)
        tag = "vision" if cfg.frontend == "vision_stub" else "audio"
        t0 = time.perf_counter()
        gen = torch.Generator(device=dev)
        gen.manual_seed(0)
        params = lm.init(cfg, gen, device=dev)
        n_params = sum(t.numel() for t in tree_mod.leaves(params))
        check(n_params == lm.count_params(cfg) == FE_PARAMS[arch],
              f"{arch}: {n_params:,} params")
        print(f"[frontends] {arch} ({cfg.frontend}): {cfg.num_layers} "
              f"layers, d {cfg.d_model}, {n_params:,} params, "
              f"{torch.cuda.memory_allocated(dev) / 2**30:.2f} GiB",
              flush=True)
        inv = fe_invariant(torch, dev, cfg, params, gen)
        free_card(torch)
        serve = fe_serve(torch, dev, cfg, params, gen)
        walls[f"{tag} serve"] = time.perf_counter() - t0
        del params
        free_card(torch)
        t0 = time.perf_counter()
        if cfg.frontend == "audio_stub":
            watch = {("embed", "embedding"), ("head", "w")}
            groups = {("embed", "embedding"): cfg.num_codebooks}
        else:
            watch, groups = {("embed", "embedding")}, None
        train = train_full(torch, dev, cfg, steps=FE_TRAIN_STEPS,
                           tag="frontends", watch=lambda path: path in watch,
                           groups=groups)
        walls[f"{tag} train"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        fplan = tl.plan_update_fusion(lm.abstract_params(cfg),
                                      tokens=FE_DW_TOKENS)
        r, update = update_dw_chains(
            torch, dev, cfg, fplan, FE_DW_TOKENS, f"{tag}_update_dw",
            FE_CHAINS[arch], 32, "frontends", singles=True)
        rows += r
        walls[f"{tag} update"] = time.perf_counter() - t0
        out[tag] = {"arch": arch, "invariant": inv, "serve": serve,
                    "train": train, "update_dw": update}
    print("[frontends] wall s: " + ", ".join(f"{k} {v:.1f}"
                                            for k, v in walls.items())
          + f"; phase {sum(walls.values()):.1f}", flush=True)
    serve_counts = {k: out["vision"]["serve"]["counts"][k]
                    + out["audio"]["serve"]["counts"][k]
                    for k in out["vision"]["serve"]["counts"]}
    return rows, dict(out, walls=walls, serve_counts=serve_counts)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible", file=sys.stderr)
        return 1
    if not (ROOT / "src" / "repro_torch" / "csrc").is_dir():
        print("chip_smoke: the port's sources (src/repro_torch) are not "
              "beside this script", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)

    # 1. card
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    print(f"[card] torch {torch.__version__} cuda {torch.version.cuda} "
          f"{torch.cuda.get_device_name(0)}", flush=True)

    # 2. build
    from repro_torch.configs import get_config
    from repro_torch.kernels import cuda, registry
    t0 = time.perf_counter()
    so = cuda.build()
    cuda.library()
    print(f"[build] {so.relative_to(ROOT)} in {time.perf_counter() - t0:.1f}s",
          flush=True)
    build_report()

    cfg = get_config("granite-3-2b")
    check(cfg.num_layers == 40 and cfg.d_model == 2048, "not full width")
    # 2b. paper suite, 3. serve kernels, 4. adamw, 5. measured plan,
    # 6. update bundles, 6b. update+dW, 7. train, 8. serve, 8l. tp,
    # 8b. paged,
    # 8c. moe, 8d. ops, 8e. wavefront, 8f. fallback, 8g. layernorm,
    # 8h. recurrent, 8i. deepseek, 8j. xlstm, 8k. frontends;
    # each phase's wall time is printed before the report
    walls = {}

    def timed(name, phase, *args):
        t = time.perf_counter()
        out = phase(*args)
        walls[name] = time.perf_counter() - t
        return out

    rows, paper_run = timed("paper", phase_paper, torch, dev)
    rows += timed("kernels", phase_kernels, torch, dev, cfg)
    rows += timed("adamw", phase_adamw, torch, dev)
    program, fplan = timed("plan", phase_plan, torch, dev, cfg)
    update = timed("bundles", phase_update_bundles, torch, dev, cfg, program)
    dw_rows, update_dw = timed("update_dw", phase_update_dw, torch, dev, cfg,
                               fplan)
    rows += dw_rows
    train = timed("train", phase_train, torch, dev, cfg, program)
    serve = timed("serve", phase_serve, torch, dev, cfg)
    free_card(torch)
    tp_rows, tp = timed("tp", phase_tp, torch, dev, cfg, serve)
    del serve["first_mixed"]
    free_card(torch)
    paged_rows, paged = timed("paged", phase_paged, torch, dev, cfg)
    moe_rows, moe_run = timed("moe", phase_moe, torch, dev)
    ops_rows, ops_run = timed("ops", phase_ops, torch, dev, cfg)
    free_card(torch)
    wave_rows, wave = timed("wavefront", phase_wavefront, torch, dev, cfg)
    free_card(torch)
    fallback = timed("fallback", phase_fallback, torch, dev, cfg)
    free_card(torch)
    ln_rows, ln = timed("layernorm", phase_layernorm, torch, dev)
    free_card(torch)
    rg_rows, rg = timed("recurrent", phase_recurrent, torch, dev)
    free_card(torch)
    ds_rows, ds = timed("deepseek", phase_deepseek, torch, dev)
    free_card(torch)
    xl_rows, xl = timed("xlstm", phase_xlstm, torch, dev)
    free_card(torch)
    fe_rows, fe = timed("frontends", phase_frontends, torch, dev)
    rows += (tp_rows + paged_rows + moe_rows + ops_rows + wave_rows + ln_rows
             + rg_rows + ds_rows + xl_rows + fe_rows)
    print("[phases] wall s: " + ", ".join(f"{k} {v:.1f}"
                                         for k, v in walls.items()))

    # 9. report: each row's launches come from its own main path's run
    names = {k.name: k for k in registry()}
    runs = {"serve": serve["counts"], "train": train["counts"],
            "update_dw": update_dw["counts"],
            **{f"tp{n}_serve": r["counts"] for n, r in tp.items()},
            "paper": paper_run["counts"], "paged": paged["counts"],
            "moe": moe_run["counts"], "ops": ops_run["counts"],
            "wavefront": wave["counts"], "fallback": fallback["counts"],
            "layernorm_serve": ln["serve_counts"],
            "layernorm_train": ln["train"]["counts"],
            "layernorm_update_dw": ln["update_dw"]["counts"],
            "recurrent_serve": rg["serve"]["counts"],
            "recurrent_train": rg["train"]["counts"],
            "recurrent_update_dw": rg["update_dw"]["counts"],
            "deepseek_serve": ds["serve"]["counts"],
            "deepseek_train": ds["train"]["counts"],
            "deepseek_update_dw": ds["update_dw"]["counts"],
            "xlstm_serve": xl["serve"]["counts"],
            "xlstm_train": xl["train"]["counts"],
            "xlstm_update_dw": xl["update_dw"]["counts"],
            "frontends_serve": fe["serve_counts"],
            "vision_train": fe["vision"]["train"]["counts"],
            "vision_update_dw": fe["vision"]["update_dw"]["counts"],
            "audio_train": fe["audio"]["train"]["counts"],
            "audio_update_dw": fe["audio"]["update_dw"]["counts"]}
    for r in rows:
        kernel = r.pop("kernel").name
        r["launches"] = runs[r.pop("path")][kernel]
        r["path_launches"] = {path: c[kernel] for path, c in runs.items()}
    check(all(set(c) == set(names) for c in runs.values()),
          "kernel registry changed")
    print(json.dumps({"kernels": rows}))
    st = train["steps"][1:] or train["steps"]
    step_ms = statistics.median(x["ms"] for x in st)
    upd_ms = statistics.median(x["update_ms"] for x in st)
    print(f"[train] steps 1..{TRAIN_STEPS - 1}: median {step_ms:.1f} ms/step, "
          f"{TRAIN_BATCH * TRAIN_SEQ / step_ms * 1e3:.1f} tokens/s, update "
          f"{upd_ms:.3f} ms device (bound {update['bound_ms']:.3f} ms; "
          f"{train['counts']['adamw_member'] // TRAIN_STEPS} adamw launches "
          f"per step), peak {train['peak_gib']:.2f} GiB ({smi})")
    print(f"[update_dw] program {update_dw['program_ms']:.4f} ms, "
          f"separated {update_dw['separated_ms']:.4f} ms, bound "
          f"{update_dw['bound_ms']:.4f} ms ({smi})")
    print(f"[serve] tokens/s {serve['tokens_per_s']:.3f} ({smi})")
    for n, r in tp.items():
        worst_plain = max(max(t.values()) for t in r["vs_plain"])
        print(f"[tp{n}] first mixed step from one device's cache, worst "
              f"rel L2 {max(max(t.values()) for t in r['teacher']):.3e}, "
              f"against plain {worst_plain:.3e}; tokens agreeing with one "
              f"device {r['agreement']:.3f}, first divergences "
              f"{r['firsts']}; {r['allreduces_a_step']:.1f} "
              f"all-reduces, {r['mib_a_step']:.2f} MiB a step a rank "
              f"({r['backend']}); peak {max(r['peak_gib']):.2f} GiB a rank; "
              f"{r['tokens_per_s']:.2f} tok/s with the ranks sharing the "
              f"card; phase {r['wall']:.1f}s ({smi})")
    print(f"[paged] tokens/s {paged['tokens_per_s']:.3f}, prefix hit rate "
          f"{paged['prefix_hit_rate']:.3f}, prefill chunks paged/contiguous "
          f"{paged['prefill_chunks']} ({smi})")
    print(f"[moe] tokens/s {moe_run['tokens_per_s']:.3f}, expert_skew "
          f"{moe_run['expert_skew']:.3f}, load_shed_steps "
          f"{moe_run['load_shed_steps']} ({smi})")
    print(f"[ops] granite layer {ops_run['layer_ms']:.1f} ms, rel L2 "
          f"{ops_run['layer_rel_l2']:.3g} ({smi})")
    print(f"[wavefront] tokens/s {wave['tokens_per_s']:.3f}, agreement with "
          f"the hand-wired engine {wave['agreement']:.3f} ({smi})")
    print(f"[fallback] tokens/s {fallback['tokens_per_s']:.3f}, agreement "
          f"with the executed engine {fallback['agreement']:.3f} ({smi})")
    for arch, r in ln["serve"].items():
        print(f"[layernorm] {arch} ({r['layers']} layers): tokens/s "
              f"{r['tokens_per_s']:.3f} (hand-wired), prefill/decode "
              f"against forward rel L2 {r['invariant']['prefill']:.3e} / "
              f"{r['invariant']['decode']:.3e} ({smi})")
    lt = ln["train"]
    busy = "not measured" if lt["busy"] is None else f"{lt['busy']:.1%}"
    print(f"[layernorm] {LN_TRAIN_ARCH} train {lt['step_ms']:.1f} ms/step, "
          f"peak {lt['peak_gib']:.2f} GiB, busy {busy}"
          f", adamw_member {lt['counts']['adamw_member']} and bundle "
          f"launches {lt['counts']['bundle_launcher']}; update+dW row_member "
          f"(dW->adamw chains) {ln['update_dw']['counts']['row_member']}; "
          f"layernorm max|err| {ln['norm_err']:.3g} ({smi})")
    rt = rg["train"]
    busy = "not measured" if rt["busy"] is None else \
        f"{rt['busy']:.1%} (device {rt['device_ms']:.1f} ms a step)"
    inv = rg["invariant"]
    print(f"[recurrent] {RG_ARCH}: prefill/decode against forward worst rel "
          f"L2 {max(max(v) for v in inv['logits'].values()):.3e}, rings "
          f"exact, decode's ring rows worst "
          f"{max(max(v) for v in inv['ring_rows'].values()):.3e}; "
          f"hand-wired serve {rg['serve']['tokens_per_s']:.3f} tokens/s; "
          f"train {rt['step_ms']:.1f} ms/step (batch {TRAIN_BATCH} x seq "
          f"{TRAIN_SEQ}, {rt['grad_accum']} micro-batch(es)), peak "
          f"{rt['peak_gib']:.2f} GiB, busy {busy}, adamw_member "
          f"{rt['counts']['adamw_member']} and bundle launches "
          f"{rt['counts']['bundle_launcher']}; update+dW row_member "
          f"{rg['update_dw']['counts']['row_member']} ({smi})")
    dt, di = ds["train"], ds["invariant"]
    busy = "not measured" if dt["busy"] is None else \
        f"{dt['busy']:.1%} (device {dt['device_ms']:.1f} ms a step)"
    first = di["runs"][next(iter(di["runs"]))]["drops"]
    print(f"[deepseek] {DS_ARCH} at full width: {ds['serve']['layers']} "
          f"layers served: prefill/decode against forward worst rel L2 "
          f"{max(di['runs'][di['capacity_factor']]['logits']):.3e} at "
          f"capacity factor {di['capacity_factor']:g} (drops at the first "
          f"factor: forward {first['forward']}, compared positions "
          f"{first['compared']}, prefill + decode "
          f"{first['prefill_decode']}), decode's latent/rope rows worst "
          f"{max(di['runs'][di['capacity_factor']]['rows']):.3e}; hand-wired "
          f"serve {ds['serve']['tokens_per_s']:.3f} tokens/s; "
          f"{DS_TRAIN_LAYERS} layers trained at batch {dt['batch']} x seq "
          f"{dt['seq']}: {dt['step_ms']:.1f} ms/step, peak "
          f"{dt['peak_gib']:.2f} GiB, busy {busy}, adamw_member "
          f"{dt['counts']['adamw_member']} and bundle launches "
          f"{dt['counts']['bundle_launcher']}; update+dW row_member "
          f"{ds['update_dw']['counts']['row_member']} ({smi})")
    xt, xs, xi = xl["train"], xl["slstm"], xl["invariant"]["runs"]
    busy = "not measured" if xt["busy"] is None else \
        f"{xt['busy']:.1%} (device {xt['device_ms']:.1f} ms a step)"
    print(f"[xlstm] {XL_ARCH} at full width and depth: prefill/decode "
          f"against forward worst rel L2 "
          f"{max(max(r['logits']) for r in xi.values()):.3e}, handed-off "
          f"state worst {max(max(r['state'].values()) for r in xi.values()):.3e}"
          f"; hand-wired serve {xl['serve']['tokens_per_s']:.3f} tokens/s; "
          f"train {xt['step_ms']:.1f} ms/step (batch {xt['batch']} x seq "
          f"{xt['seq']}), peak {xt['peak_gib']:.2f} GiB, busy {busy}, "
          f"{xt['launches']} kernels a step, of them the {xs['layers']} "
          f"sLSTM layers {xs['launches']} and {xs['share']:.1%} of the "
          f"step; adamw_member {xt['counts']['adamw_member']} and bundle "
          f"launches {xt['counts']['bundle_launcher']}; update plan "
          f"adamw_member {xl['update_dw']['counts']['adamw_member']} "
          f"({smi})")
    for tag in ("vision", "audio"):
        f = fe[tag]
        ft = f["train"]
        busy = "not measured" if ft["busy"] is None else \
            f"{ft['busy']:.1%} (device {ft['device_ms']:.1f} ms a step)"
        print(f"[frontends] {f['arch']} at full width and depth: "
              f"prefill/decode against forward worst rel L2 "
              f"{max(max(r) for r in f['invariant']['runs'].values()):.3e}; "
              f"greedy serve {f['serve']['tokens_per_s']:.3f} tokens/s "
              f"(no launch); train {ft['step_ms']:.1f} ms/step (batch "
              f"{ft['batch']} x seq {ft['seq']}), peak {ft['peak_gib']:.2f} "
              f"GiB, busy {busy}, adamw_member "
              f"{ft['counts']['adamw_member']} and bundle launches "
              f"{ft['counts']['bundle_launcher']}; update+dW row_member "
              f"{f['update_dw']['counts']['row_member']}, adamw_member "
              f"{f['update_dw']['counts']['adamw_member']} ({smi})")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except PhaseError as e:
        print(f"chip_smoke: FAIL: {e}", file=sys.stderr)
        sys.exit(1)
