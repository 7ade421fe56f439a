"""Training launcher of the PyTorch port (runs on the card by default).

  PYTHONPATH=src python -m repro_torch.launch.train --arch granite-3-2b \
      --scale full --batch 4 --seq 2048 --steps 4 --plan-fusion \
      [--measure gpu] [--ckpt-dir DIR --resume]
  PYTHONPATH=src python -m repro_torch.launch.train --arch granite-3-2b \
      --scale smoke --device cpu --steps 4 --batch 2 --seq 32 --plan-fusion

``--arch`` takes every config the port registers: granite-3-2b, the
LayerNorm configs stablelm-3b, starcoder2-7b and minitron-8b, the hybrid
recurrentgemma-2b (RG-LRU blocks and local attention), xlstm-1.3b (mLSTM
and sLSTM blocks without an FFN; ``--scale smoke --device cpu`` on the
CPU), and the MoE configs phi3.5-moe and deepseek-v2-236b (MLA blocks, a
dense first layer, 160 experts top-6 with shared experts), whose full depth
does not fit one card.
``--scale smoke`` trains the reduced config; ``--scale full`` trains the
full-width, full-depth model on one card with remat (the port has no
production mesh: tensor parallelism is ROADMAP item 5).  Weights are random,
drawn on the device from a ``torch.Generator`` seeded with 0; data comes from
``TokenPipeline``.  ``--plan-fusion`` plans the optimizer step
(``train_loop.plan_update_fusion``, the planning view with the dW GEMMs)
and executes it as fused AdamW bundles (``build_update_program``), through a
schedule cache; ``--measure gpu`` picks their schedules by CUDA-event
timing, ``--measure interpret`` by the step-count proxy.  ``--device cpu``
runs the kernels' plain PyTorch versions.  Fault tolerance: async
checkpoints every ``--ckpt-every`` steps, auto-resume, a straggler watchdog,
a bounded restart loop.  ``--compression`` and ``--zero`` are not ported.
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch.configs import get_config
from repro_torch.data.pipeline import DataConfig, TokenPipeline
from repro_torch.device import resolve_device
from repro_torch.models import lm
from repro_torch.train import checkpoint, optimizer as opt_mod
from repro_torch.train.fault_tolerance import StepWatchdog, run_with_restarts
from repro_torch.train.optimizer import AdamWConfig
from repro_torch.train.train_loop import TrainConfig, make_train_step


def plan_update(cfg, ocfg, args, measure=None, cache=None):
    """The --plan-fusion planning: print the optimizer/backward plan (its
    planning view) and return the executed update program."""
    from repro_torch.train.train_loop import (build_update_program,
                                              plan_update_fusion)
    abstract = lm.abstract_params(cfg)
    fplan = plan_update_fusion(abstract, tokens=args.batch * args.seq,
                               measure=measure, cache=cache)
    print("[plan-fusion] optimizer/backward bundles (planning view):")
    for row in fplan.summary():
        print(f"  {row}")
    program = build_update_program(abstract, ocfg, measure=measure,
                                   cache=cache)
    print("[plan-fusion] executed update program "
          f"({program.program.n_fused} fused launches):")
    for row in program.describe():
        print(f"  {row}")
    return program


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--scale", choices=["smoke", "full"], default="smoke")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--ckpt-every", type=int, default=20)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--hfused-optimizer", action="store_true")
    ap.add_argument("--plan-fusion", action="store_true",
                    help="plan optimizer/backward fusion bundles AND execute "
                         "the optimizer step through the plan->program "
                         "executor")
    ap.add_argument("--dry-steps", type=int, default=None,
                    help="run only N steps with checkpointing disabled")
    ap.add_argument("--measure", choices=["gpu", "interpret"], default=None,
                    help="pick planned schedules by measurement "
                         "(core/timing.make_measure backend)")
    ap.add_argument("--compression", choices=["int8_pod"], default=None)
    ap.add_argument("--zero", action="store_true")
    ap.add_argument("--grad-accum", type=int, default=1)
    ap.add_argument("--max-failures", type=int, default=3)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default=None,
                    help="default: the card (raises without one); 'cpu' "
                         "runs the plain versions")
    args = ap.parse_args(argv)
    if args.measure and not args.plan_fusion:
        ap.error("--measure only applies to --plan-fusion schedule selection")
    if args.dry_steps is not None:
        args.steps = args.dry_steps
        args.ckpt_dir = ""
    dev = resolve_device(args.device)

    cfg = get_config(args.arch)
    if args.scale == "smoke":
        cfg = cfg.reduced()
    else:
        print("[scale full] one card, full width and depth; the port has no "
              "production mesh (ROADMAP item 5)")
    ocfg = AdamWConfig(lr=args.lr, total_steps=args.steps,
                       warmup_steps=max(1, args.steps // 10),
                       hfused=args.hfused_optimizer)
    tcfg = TrainConfig(optimizer=ocfg, grad_accum=args.grad_accum,
                       compression=args.compression, zero=args.zero,
                       remat=args.scale == "full")   # raises: not ported

    update_program = None
    if args.plan_fusion:
        from repro_torch.core.schedule_cache import default_cache
        from repro_torch.core.timing import make_measure
        update_program = plan_update(
            cfg, ocfg, args,
            measure=make_measure(args.measure) if args.measure else None,
            cache=default_cache())
    step_fn = make_train_step(cfg, tcfg, update_program=update_program)

    data = TokenPipeline(DataConfig(
        vocab_size=cfg.vocab_size, seq_len=args.seq,
        global_batch=args.batch,
        num_codebooks=cfg.num_codebooks if cfg.frontend == "audio_stub" else 0,
        num_image_tokens=cfg.num_image_tokens
        if cfg.frontend == "vision_stub" else 0,
        d_model=cfg.d_model))
    ckpt = (checkpoint.AsyncCheckpointer(args.ckpt_dir)
            if args.ckpt_dir else None)
    watchdog = StepWatchdog()

    def make_state():
        gen = torch.Generator(device=dev)
        gen.manual_seed(0)
        params = lm.init(cfg, gen, device=dev)
        opt_state = opt_mod.init(params)
        start = 0
        if ckpt and args.resume:
            got = checkpoint.restore_latest(
                args.ckpt_dir, {"params": params, "m": opt_state.m,
                                "v": opt_state.v})
            if got:
                start, tree, _meta = got
                params = tree["params"]
                opt_state = opt_mod.OptState(
                    m=tree["m"], v=tree["v"],
                    count=torch.tensor(start, dtype=torch.int32, device=dev))
                data.restore({"step": start, "shard": 0})
                print(f"[resume] from step {start}")
        return dict(params=params, opt=opt_state, start=start)

    def loop(state, _failures):
        params, opt_state = state["params"], state["opt"]
        tokens_per_step = args.batch * args.seq
        losses = []
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats(dev)
        for step in range(state["start"], args.steps):
            t0 = time.perf_counter()
            batch = {k: torch.from_numpy(v).to(dev)
                     for k, v in data.batch_at(step).items()}
            params, opt_state, metrics = step_fn(params, opt_state, batch,
                                                 step)
            loss = float(metrics["loss"])         # waits for the step
            losses.append(loss)
            dt = time.perf_counter() - t0
            if watchdog.observe(step, dt):
                data.skip_ahead(0)   # single-host: log only
                print(f"[straggler] step {step} took {dt:.2f}s")
            if step % args.log_every == 0:
                print(f"step {step:5d} loss {loss:.4f} "
                      f"gnorm {float(metrics['grad_norm']):.3f} "
                      f"{dt * 1e3:.0f}ms {tokens_per_step / dt:.0f} tok/s",
                      flush=True)
            if ckpt and step and step % args.ckpt_every == 0:
                ckpt.save_async(step, {"params": params, "m": opt_state.m,
                                       "v": opt_state.v}, {"loss": loss})
        if ckpt:
            ckpt.save_async(args.steps, {"params": params, "m": opt_state.m,
                                         "v": opt_state.v}, {})
            ckpt.wait()
        if losses:
            print(f"final loss {losses[-1]:.4f} (start {losses[0]:.4f}) "
                  f"on {dev}")
        else:
            print(f"nothing to do: resumed at step {state['start']} "
                  f">= --steps {args.steps}")
        if dev.type == "cuda":
            print(f"[memory] peak allocated "
                  f"{torch.cuda.max_memory_allocated(dev) / 2**30:.2f} GiB")
        return losses

    return run_with_restarts(make_state, loop, max_failures=args.max_failures,
                             on_restart=lambda n: print(f"[restart #{n}]"))


if __name__ == "__main__":
    main()
