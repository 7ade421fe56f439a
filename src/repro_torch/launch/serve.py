"""Serving launcher of the PyTorch port (runs on the card by default).

  PYTHONPATH=src python -m repro_torch.launch.serve --arch granite-3-2b \
      --scale full --requests 12 --prompt-len 64 --stagger 8 --max-new 16 \
      --batch 8 --chunk-rows 512

Continuous batching over the executed, planned decode step with chunked
prefill (``serve/engine.py``).  Weights are random, drawn on the device
from a ``torch.Generator`` seeded with ``--seed``; ``--device cpu`` runs
the plain PyTorch versions of the kernels instead of the CUDA ones.
``--kv-block-size 16 --shared-prefix 1024`` serves from the paged arena
with the prefix cache (one-layer configs: ``--layers 1``);
``--arch phi3.5-moe-rms --layers 8 --prefill-policy eload`` serves the MoE
path with its depth cut to 8 layers.  ``--scheduling wavefront`` runs the
lock-step wavefront scheduler (executed on a single-layer dense config; on
a stacked or MoE config it stays hand-wired with a notice on the CPU and
refuses on the card); ``--hand-wired`` serves through ``lm.prefill`` and
``lm.decode_step`` instead of the planned program (the fallback, no kernel
of the port launched).  The LayerNorm configs (``--arch stablelm-3b``,
``starcoder2-7b``, ``minitron-8b``, ``phi3.5-moe-42b-a6.6b``) are served
only that way, as in the reference: planned, they print its notice and stay
hand-wired on the CPU, and on the card they need ``--hand-wired`` (without
it the launcher prints the refusal and exits 1).  So is the hybrid
``--arch recurrentgemma-2b`` (RG-LRU blocks and local attention; the
program serves a single global-attention run only), and so is
``--arch deepseek-v2-236b`` (MLA blocks, a dense first layer, then MoE
layers: ``--scale full --layers 8 --hand-wired`` fits one card), and so is
``--arch xlstm-1.3b`` (mLSTM and sLSTM blocks without an FFN, 7:1; all 48
layers fit one card: ``--scale full --hand-wired``); ``--layers N`` keeps
the first N block kinds (``cut_depth``).  The two frontend configs
(``internvl2-1b``, ``musicgen-medium``) are refused with the engines'
reason (``prompt_refusal``: token prompts only, as the reference's engines
fail on them); ``lm.prefill`` and ``lm.decode_step`` serve them.
``--mesh-shape N`` serves tensor-parallel: the launcher starts N ranks
(``launch/mesh.py``), each a process serving the trace with its share of
the heads, and prints rank 0's report; ``--expect-sharded-parity`` then
serves the trace on one device and fails unless every stream matches.  The
flags keep the
reference launcher's names and checks; the port plans by default, and
``--plan-fusion`` names that default.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import time

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.device import resolve_device
from repro_torch.launch.mesh import run_ranks
from repro_torch.models import lm
from repro_torch.serve.engine import (PrefillBudget, Request, ServeEngine,
                                      prompt_refusal)


def cut_depth(cfg, layers: int):
    """``cfg`` cut to its first ``layers`` layers.  A config with a block
    pattern keeps its first N block kinds (hybrids, DeepSeek's MLA blocks)
    and its layer overrides (DeepSeek's dense layer 0); one without stays
    global attention."""
    return dataclasses.replace(
        cfg, num_layers=layers,
        block_pattern=(cfg.pattern[:layers]
                       if cfg.block_pattern is not None else None))


def build_requests(cfg, args) -> list[Request]:
    """Deterministic request trace: ``--stagger`` spreads prompt lengths
    (+i %% N) and token budgets (-i %% N) so slots retire and refill
    mid-batch; ``--arrival-rate`` > 0 draws exponential-gap arrivals."""
    rng = np.random.default_rng(args.seed)
    arrivals = np.zeros(args.requests)
    if args.arrival_rate > 0:
        arrivals = np.floor(np.cumsum(
            rng.exponential(1.0 / args.arrival_rate, args.requests)))
    shared = None
    if args.shared_prefix > 0:
        # one prefix drawn once, common to every request: the paged prefix
        # cache serves it from shared blocks after the first prompt
        shared = rng.integers(0, cfg.vocab_size,
                              args.shared_prefix).astype(np.int32)
    reqs = []
    for i in range(args.requests):
        spread = i % max(1, args.stagger)
        plen = args.prompt_len + spread
        tail = rng.integers(0, cfg.vocab_size, plen).astype(np.int32)
        reqs.append(Request(
            rid=i,
            prompt=tail if shared is None else np.concatenate([shared, tail]),
            max_new_tokens=max(1, args.max_new - spread),
            temperature=args.temperature, arrival=int(arrivals[i])))
    return reqs


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--scale", choices=["smoke", "full"], default="smoke")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--max-new", type=int, default=8)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--scheduling", choices=["continuous", "wavefront"],
                    default="continuous",
                    help="continuous = per-slot cache positions with "
                         "iteration-level refill (default); wavefront = "
                         "lock-step waves")
    ap.add_argument("--stagger", type=int, default=1,
                    help="spread request i's prompt length by +(i %% N) and "
                         "its budget by -(i %% N)")
    ap.add_argument("--arrival-rate", type=float, default=0.0,
                    help="mean request arrivals per engine step (0 = all "
                         "requests queued at step 0)")
    ap.add_argument("--chunk-rows", type=int, default=2048,
                    help="prompt rows one slot prefills per iteration")
    ap.add_argument("--coresident-chunks", type=int, default=2,
                    help="prefill chunks that may ride one decode step")
    ap.add_argument("--prefill-policy", choices=["fifo", "srpf", "eload"],
                    default="fifo",
                    help="eload: srpf, shedding one coresident chunk while "
                         "the per-expert hit skew exceeds the budget's "
                         "threshold (MoE)")
    ap.add_argument("--reject-overlong", action="store_true",
                    help="reject prompts longer than --chunk-rows instead "
                         "of admitting them across iterations")
    ap.add_argument("--layers", type=int, default=0,
                    help="cut the config's depth to N layers (0: as is)")
    ap.add_argument("--expect-stitched", action="store_true",
                    help="fail unless the executed decode program carries "
                         ">=1 epilogue chain inside a fused launch")
    ap.add_argument("--expect-moe-fused", action="store_true",
                    help="fail unless the decode program puts the grouped "
                         "expert FFN in a fused launch with a partner")
    ap.add_argument("--kv-block-size", type=int, default=0,
                    help="paged KV: arena block size in tokens (0 = "
                         "contiguous per-slot cache)")
    ap.add_argument("--kv-blocks", type=int, default=None,
                    help="paged KV: total arena blocks, per-slot sentinels "
                         "included")
    ap.add_argument("--kv-slot-blocks", type=int, default=None,
                    help="paged KV: table columns per slot (logical "
                         "capacity kv_slot_blocks * kv_block_size)")
    ap.add_argument("--shared-prefix", type=int, default=0,
                    help="prepend one shared N-token prefix to every prompt")
    ap.add_argument("--expect-prefix-hits", action="store_true",
                    help="fail unless the prefix cache served >=1 request")
    ap.add_argument("--kv-snapshot", default=None, metavar="PATH",
                    help="write the final KVPool snapshot as JSON")
    ap.add_argument("--mesh-shape", type=int, default=0, metavar="N",
                    help="tensor-parallel serve: N ranks of a 1-D mesh, "
                         "each a process serving the trace with its heads' "
                         "share of the weights and KV cache (gloo ranks; "
                         "on one card they share it)")
    ap.add_argument("--shard-axis", default="model",
                    help="mesh axis name the sharded leaves partition over "
                         "(default: model)")
    ap.add_argument("--expect-sharded-parity", action="store_true",
                    help="also serve the same trace on a single device and "
                         "fail unless every token stream matches")
    ap.add_argument("--seed", type=int, default=0)
    path = ap.add_mutually_exclusive_group()
    path.add_argument("--plan-fusion", dest="plan_fusion",
                      action="store_true", default=True,
                      help="serve through the planned decode program (the "
                           "default; the reference's spelling)")
    path.add_argument("--hand-wired", dest="plan_fusion",
                      action="store_false",
                      help="serve through lm.prefill and lm.decode_step "
                           "(plan_fusion=False): no kernel of the port runs")
    ap.add_argument("--measure", choices=["auto", "interpret", "gpu"],
                    default=None,
                    help="pick planned schedules by measurement "
                         "(core/timing.make_measure backend)")
    ap.add_argument("--device", default=None,
                    help="cuda (default when a card is present) or cpu")
    args = ap.parse_args(argv)
    if args.measure and not args.plan_fusion:
        ap.error("--measure only applies to planned schedule selection")
    if args.kv_block_size > 0 and not args.plan_fusion:
        ap.error("--kv-block-size requires the planned path (paged KV runs "
                 "only on the executed continuous path)")
    if args.kv_block_size <= 0 and (
            args.kv_blocks is not None or args.kv_slot_blocks is not None
            or args.expect_prefix_hits or args.kv_snapshot):
        ap.error("--kv-blocks/--kv-slot-blocks/--expect-prefix-hits/"
                 "--kv-snapshot require --kv-block-size > 0")

    if args.mesh_shape > 1 and not args.plan_fusion:
        ap.error("--mesh-shape requires --plan-fusion (only the executed "
                 "continuous step runs under shard_map)")
    if args.expect_sharded_parity and args.mesh_shape <= 1:
        ap.error("--expect-sharded-parity requires --mesh-shape > 1")

    dev = resolve_device(args.device)
    if args.mesh_shape > 1:
        # every rank serves the same trace; rank 0 reports
        print(f"[sharded] {args.mesh_shape}-way tensor-parallel serve over "
              f"mesh axis {args.shard_axis!r} ({dev.type} ranks)")
        outs = run_ranks(_serve_rank, args.mesh_shape, (args,),
                         axis=args.shard_axis, device_type=dev.type)
        bad = [r for r, o in enumerate(outs)
               if o["tokens"] != outs[0]["tokens"]]
        if bad:
            raise SystemExit(f"[sharded] FAIL: ranks {bad} served other "
                             "tokens than rank 0")
        report = outs[0]
        print(f"[sharded] {report['allreduces'][0]} all-reduces, "
              f"{report['allreduces'][1]} bytes a rank")
    else:
        report = serve_once(args, dev)
    _print_report(args, report)
    if args.expect_sharded_parity:
        # the same trace on one device; every stream must match
        ref = serve_once(args, dev, say=lambda *a: None)
        bad = [rid for rid, (a, b) in enumerate(zip(ref["tokens"],
                                                     report["tokens"]))
               if a != b]
        if bad:
            raise SystemExit("[sharded] FAIL: sharded token streams "
                             f"diverge from single-device for rids {bad}")
        print(f"[sharded] token-for-token parity with single-device "
              f"across {len(report['tokens'])} requests")


def _serve_rank(mesh, args) -> dict:
    rank = mesh.get_local_rank(args.shard_axis)
    return serve_once(args, resolve_device(args.device or mesh.device_type),
                      mesh=mesh, say=print if rank == 0 else
                      (lambda *a: None))


def serve_once(args, dev, mesh=None, say=print) -> dict:
    """Build the config, weights and engine ``args`` ask for (one rank of
    ``mesh`` when given), run the trace and return what the launcher
    reports; ``say`` prints the plan and the checks made before the run."""
    cfg = get_config(args.arch)
    if args.scale == "smoke":
        cfg = cfg.reduced()
    if args.layers:
        cfg = cut_depth(cfg, args.layers)
    refusal = prompt_refusal(cfg)
    if refusal is not None:
        raise SystemExit(f"[serve] {refusal}")
    gen = torch.Generator(device=dev)
    gen.manual_seed(args.seed)
    params = lm.init(cfg, gen, device=dev)
    measure = schedule_cache = None
    if args.measure:
        from repro_torch.core.schedule_cache import default_cache
        from repro_torch.core.timing import make_measure
        measure = make_measure(args.measure, device=dev)
        schedule_cache = default_cache()
    budget = PrefillBudget(chunk_rows=args.chunk_rows,
                           max_coresident_chunks=args.coresident_chunks,
                           policy=args.prefill_policy)
    try:
        engine = ServeEngine(cfg, params, batch=args.batch,
                             max_len=args.prompt_len + args.shared_prefix
                             + args.stagger + args.max_new + 8,
                             prefill_budget=budget, device=dev,
                             plan_fusion=args.plan_fusion, measure=measure,
                             schedule_cache=schedule_cache,
                             scheduling=args.scheduling,
                             reject_overlong=args.reject_overlong,
                             paged_kv=args.kv_block_size > 0,
                             kv_block_size=args.kv_block_size or 16,
                             kv_blocks=args.kv_blocks,
                             kv_slot_blocks=args.kv_slot_blocks,
                             mesh=mesh, shard_axis=args.shard_axis)
    except ValueError as e:
        # a refused engine (e.g. a planned LayerNorm engine on the card):
        # its reason, which names the opt-in, and exit status 1
        raise SystemExit(f"[serve] {cfg.name}: {e}") from None
    del params                 # a tensor-parallel rank keeps its slab only
    if engine.fusion_plan is not None:
        say("[plan-fusion] decode-step bundles:")
        for row in engine.fusion_plan.summary():
            say(f"  {row}")
    say("[plan-fusion] decode step "
        + ("EXECUTES through the plan->program executor (core/executor)"
           if engine.executed else "is hand-wired (lm.decode_step)"))
    if args.expect_stitched:
        from repro_torch.core.stitch import CHAIN_SEP
        if not engine.executed:
            raise SystemExit("[stitch] FAIL: decode step is not executed "
                             "through the program executor")
        prog = engine.build_decode_program(
            prefill_chunks=args.coresident_chunks)
        chains = sorted({m for ms in prog.fused_members for m in ms
                         if CHAIN_SEP in m})
        if not chains:
            raise SystemExit("[stitch] FAIL: no epilogue chain in any "
                             "fused launch of the decode program")
        say(f"[stitch] chains in fused launches: {', '.join(chains)}")
    if args.expect_moe_fused:
        if cfg.moe is None:
            raise SystemExit("[moe] FAIL: --expect-moe-fused on a dense "
                             f"config ({cfg.name})")
        if not engine.executed:
            raise SystemExit("[moe] FAIL: MoE decode step is not executed "
                             "through the program executor")
        prog = engine.build_decode_program(
            prefill_chunks=args.coresident_chunks)
        bundles = [sorted(ms) for ms in prog.fused_members
                   if any(m.startswith("moe_gmm") for m in ms)]
        if not bundles:
            raise SystemExit("[moe] FAIL: the grouped expert GMM is not "
                             "co-resident in any fused launch of the "
                             "decode program")
        say("[moe] expert GMM co-resident in fused launch: "
            + "; ".join("+".join(ms) for ms in bundles))
    reqs = build_requests(cfg, args)
    t0 = time.perf_counter()
    engine.run(reqs)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    seconds = time.perf_counter() - t0
    return {"arch": cfg.name, "moe": cfg.moe is not None, "device": str(dev),
            "tokens": [r.out_tokens for r in reqs], "seconds": seconds,
            "stats": engine.stats, "kv_block_size": (engine.kv_block_size
                                                     if engine.paged_kv
                                                     else 0),
            "allreduces": (engine.allreduce_calls, engine.allreduce_bytes),
            "kv_snapshot": (engine.kv_pool.snapshot() if args.kv_snapshot
                            else None)}


def _print_report(args, report: dict) -> None:
    tokens = report["tokens"]
    total_new = sum(len(t) for t in tokens)
    dt = report["seconds"]
    print(f"served {len(tokens)} requests, {total_new} tokens in {dt:.2f}s "
          f"({total_new / dt:.1f} tok/s) on {report['device']}")
    st = report["stats"]
    if args.scheduling == "continuous":
        print(f"[slots] {st.describe()}")
    if report["moe"] and st.expert_hits:
        print(f"[moe] expert hits {st.expert_hits} "
              f"(skew {st.expert_skew:.2f}), "
              f"{st.load_shed_steps} load-shed steps")
    if report["kv_block_size"]:
        print(f"[paged-kv] block_size {report['kv_block_size']}, peak "
              f"{st.blocks_in_use} blocks in use, "
              f"prefix_hit_rate {st.prefix_hit_rate:.0%} "
              f"({st.prefix_hits} hits, {st.prefix_tokens_reused} "
              f"tokens reused), {st.evictions} evictions")
    if args.kv_snapshot:
        with open(args.kv_snapshot, "w") as fh:
            json.dump(report["kv_snapshot"], fh, indent=2)
        print(f"[paged-kv] pool snapshot -> {args.kv_snapshot}")
    if args.expect_prefix_hits:
        if st.prefix_hit_rate <= 0:
            raise SystemExit("[paged-kv] FAIL: no request was served from "
                             "shared prefix blocks (prefix_hit_rate == 0)")
        print(f"[paged-kv] prefix cache hit {st.prefix_hits} request(s)")
    for rid, t in enumerate(tokens[:3]):
        print(f"  req {rid}: {t}")


if __name__ == "__main__":
    main()
