#!/usr/bin/env python3
"""The all-reduce of tensor-parallel serve, measured on one card.

  python3 scripts/tp_allreduce.py

On a machine with one NVIDIA card, for 2 and 4 gloo ranks sharing it
(``repro_torch.launch.mesh.run_ranks``):

  * the latency of one all-reduce of a bf16 CUDA tensor the size of
    full-width granite-3-2b's decode-side partial (8 x 2048) and of a
    prefill chunk's (512 x 2048), the median of 80 in a row, with the
    ranks' default torch threads and with one thread a rank;
  * chip_smoke phase 8l's teacher-forced first mixed step (phase 8's trace
    on one device, its first step that decodes and carries a chunk, again
    on each rank's heads) with the row-split partials summed as served, in
    bf16, and summed in fp32 and rounded once: the relative L2 distance of
    the logits from one device's, by slot, and of the k and v rows the
    step wrote, layer by layer (the decoding slot's row apart from the
    chunk's rows).

Builds the kernel library first (the ranks load it).  Needs the sources
beside it; imports no JAX.
"""
from __future__ import annotations

import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]
import chip_smoke as cs  # noqa: E402  (phase 8l's helpers and shapes)

SHARDS = (2, 4)
REPEATS = 80


def _latency_us(torch, dist, group, t) -> float:
    dist.all_reduce(t, group=group)
    torch.cuda.synchronize()
    dist.barrier()
    times = []
    for _ in range(REPEATS):
        t0 = time.perf_counter()
        dist.all_reduce(t, group=group)
        times.append((time.perf_counter() - t0) * 1e6)
    torch.cuda.synchronize()
    return statistics.median(times)


def rank(mesh, snap_path: str) -> dict:
    """One rank: the all-reduce latencies, then the first mixed step with
    the partials summed in bf16 and in fp32."""
    import torch
    import torch.distributed as dist

    from repro_torch.configs import get_config
    from repro_torch.models import lm
    from repro_torch.serve.engine import PrefillBudget, ServeEngine

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", torch.cuda.current_device())
    cfg = get_config(cs.TP_ARCH)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    params = lm.init(cfg, gen, device=dev)
    eng = ServeEngine(cfg, params, batch=cs.B, max_len=cs.S, device=dev,
                      prefill_budget=PrefillBudget(chunk_rows=cs.C,
                                                   max_coresident_chunks=2),
                      mesh=mesh)
    del params
    group = mesh.get_group("model")
    out = {}
    for threads in (torch.get_num_threads(), 1):
        torch.set_num_threads(threads)
        for rows in (cs.B, cs.C):
            t = torch.ones((rows, cfg.d_model), dtype=torch.bfloat16,
                           device=dev)
            out[f"{rows} rows, {threads} threads"] = _latency_us(
                torch, dist, group, t)

    def fp32_sum(partial):
        wide = partial.float()
        dist.all_reduce(wide, group=group)
        return partial.copy_(wide)

    n, r = eng.tp_shards, mesh.get_local_rank("model")
    hk = cfg.num_kv_heads // n
    heads = slice(r * hk, (r + 1) * hk)
    run = lm.layer_runs(cfg)[0].name
    snap = torch.load(snap_path, map_location=dev)
    nact = int(snap["active"].sum())
    for label in ("bf16", "fp32"):
        if label == "fp32":
            eng._tp_sum = fp32_sum
        cache = eng._init_slot_cache()
        for k in ("k", "v"):
            cache[run][k][:, :, :snap["rows"]] = \
                snap["cache"][k][..., heads, :]
        cache["pos"] = snap["pos"].clone()
        step = eng._cb_step(snap["n"])(eng._step_params, cache,
                                       snap["tokens"], snap["active"],
                                       **snap["kw"])
        res = {"slots": [cs.rel_l2(step[0][b], snap["logits"][b])
                         for b in range(cs.B)],
               "prefill": cs.rel_l2(step[2], snap["pf_logits"])}
        for k in ("k", "v"):
            got = cs.mixed_step_rows(torch, step[1][run][k], snap["pos"],
                                     snap["active"], snap["kw"], cs.C)
            want = snap["written"][k][..., heads, :]
            res[f"{k} decode row"] = [cs.rel_l2(got[l, :nact],
                                                want[l, :nact])
                                      for l in range(got.shape[0])]
            res[f"{k} chunk rows"] = [cs.rel_l2(got[l, nact:],
                                                want[l, nact:])
                                      for l in range(got.shape[0])]
        out[label] = res
    return out


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("tp_allreduce: no CUDA device visible", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    from repro_torch.configs import get_config
    from repro_torch.kernels import cuda
    from repro_torch.launch.mesh import run_ranks
    from repro_torch.models import lm
    from repro_torch.serve.engine import PrefillBudget, Request, ServeEngine

    cuda.build()
    cuda.library()
    dev = torch.device("cuda", 0)
    cfg = get_config(cs.TP_ARCH)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    eng = ServeEngine(cfg, lm.init(cfg, gen, device=dev), batch=cs.B,
                      max_len=cs.S, device=dev,
                      prefill_budget=PrefillBudget(chunk_rows=cs.C,
                                                   max_coresident_chunks=2))
    captured = cs.capture_first_mixed(eng)
    eng.run(cs.serve_requests(cfg, Request))
    snap = cs.first_mixed_snapshot(eng, captured)
    del eng, captured
    cs.free_card(torch)
    fmt = " ".join
    with tempfile.TemporaryDirectory() as tmp:
        path = str(Path(tmp) / "first_mixed.pt")
        torch.save(snap, path)
        for n in SHARDS:
            r = run_ranks(rank, n, (path,), device_type="cuda",
                          timeout=cs.TP_TIMEOUT_S)[0]
            for key, us in r.items():
                if key not in ("bf16", "fp32"):
                    print(f"[tp{n}] all-reduce of {key}: {us:.1f} us "
                          f"(median of {REPEATS})")
            for label in ("bf16", "fp32"):
                res = r[label]
                print(f"[tp{n}] first mixed step, partials summed in "
                      f"{label}: logits rel L2 by slot "
                      f"{fmt(f'{x:.2e}' for x in res['slots'])}, prefill "
                      f"{res['prefill']:.3e}")
                for k in ("k decode row", "k chunk rows", "v decode row",
                          "v chunk rows"):
                    print(f"[tp{n}]   {k} by layer: "
                          f"{fmt(f'{x:.1e}' for x in res[k])}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
