"""Serving launcher of the PyTorch port (runs on the card by default).

  PYTHONPATH=src python -m repro_torch.launch.serve --arch granite-3-2b \
      --scale full --requests 12 --prompt-len 64 --stagger 8 --max-new 16 \
      --batch 8 --chunk-rows 512

Continuous batching over the executed, planned decode step with chunked
prefill (``serve/engine.py``).  Weights are random, drawn on the device
from a ``torch.Generator`` seeded with ``--seed``; ``--device cpu`` runs
the plain PyTorch versions of the kernels instead of the CUDA ones.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.device import resolve_device
from repro_torch.models import lm
from repro_torch.serve.engine import PrefillBudget, Request, ServeEngine


def build_requests(cfg, args) -> list[Request]:
    """Deterministic request trace: ``--stagger`` spreads prompt lengths
    (+i %% N) and token budgets (-i %% N) so slots retire and refill
    mid-batch."""
    rng = np.random.default_rng(args.seed)
    reqs = []
    for i in range(args.requests):
        spread = i % max(1, args.stagger)
        plen = args.prompt_len + spread
        reqs.append(Request(
            rid=i,
            prompt=rng.integers(0, cfg.vocab_size, plen).astype(np.int32),
            max_new_tokens=max(1, args.max_new - spread)))
    return reqs


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--scale", choices=["smoke", "full"], default="smoke")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--max-new", type=int, default=8)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--stagger", type=int, default=1,
                    help="spread request i's prompt length by +(i %% N) and "
                         "its budget by -(i %% N)")
    ap.add_argument("--chunk-rows", type=int, default=2048,
                    help="prompt rows one slot prefills per iteration")
    ap.add_argument("--coresident-chunks", type=int, default=2,
                    help="prefill chunks that may ride one decode step")
    ap.add_argument("--prefill-policy", choices=["fifo", "srpf"],
                    default="fifo")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="cuda (default when a card is present) or cpu")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.scale == "smoke":
        cfg = cfg.reduced()
    gen = torch.Generator(device=dev)
    gen.manual_seed(args.seed)
    params = lm.init(cfg, gen, device=dev)
    budget = PrefillBudget(chunk_rows=args.chunk_rows,
                           max_coresident_chunks=args.coresident_chunks,
                           policy=args.prefill_policy)
    engine = ServeEngine(cfg, params, batch=args.batch,
                         max_len=args.prompt_len + args.stagger
                         + args.max_new + 8,
                         prefill_budget=budget, device=dev)
    print("[plan-fusion] decode-step bundles:")
    for row in engine.fusion_plan.summary():
        print(f"  {row}")
    reqs = build_requests(cfg, args)
    t0 = time.perf_counter()
    engine.run(reqs)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    dt = time.perf_counter() - t0
    total_new = sum(len(r.out_tokens) for r in reqs)
    print(f"served {len(reqs)} requests, {total_new} tokens in {dt:.2f}s "
          f"({total_new / dt:.1f} tok/s) on {dev}")
    st = engine.stats
    print(f"[slots] {st.describe()}")
    for r in reqs[:3]:
        print(f"  req {r.rid}: {r.out_tokens}")


if __name__ == "__main__":
    main()
