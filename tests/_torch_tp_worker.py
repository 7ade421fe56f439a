"""The rank side of ``tests/test_torch_tp_serve.py``: run by every spawned
rank of ``repro_torch.launch.mesh.run_ranks``.  It imports ``torch`` and
``repro_torch`` only (the test module imports JAX), and pytest does not
collect it (no ``test_`` prefix).

``serve_scenarios(mesh, payload)`` runs every tensor-parallel scenario of
one mesh in one spawn and returns plain data (tokens, stats, plans, launch
tables, refusal texts) for the parent to hold against the single-device
engines of both packages.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.core import autotuner
from repro_torch.core.schedule_cache import ScheduleCache
from repro_torch.models import lm
from repro_torch.serve.engine import PrefillBudget, Request, ServeEngine

# the reference test's trace (tests/test_serve_sharded.py): prompt lengths
# and budgets, numpy seed 11; the stacked config's, seed 5
LENS, BUDGETS = (6, 11, 7, 9, 8), (4, 6, 5, 2, 3)
STACKED_LENS, STACKED_BUDGETS = (6, 9, 7), (3, 4, 2)
# the paged trace: a 32-token prefix shared by every prompt, 16-row pages
PAGED_LENS, PAGED_BUDGETS, PAGED_PREFIX = (7, 9, 5, 11), (3, 3, 3, 3), 32


def reduced(layers: int = 1, arch: str = "granite-3-2b"):
    cfg = dataclasses.replace(get_config(arch).reduced(), dtype="float32")
    if layers > 1:
        cfg = dataclasses.replace(cfg, num_layers=layers,
                                  block_pattern=("attn",) * layers)
    return cfg


def requests(vocab, lens=LENS, budgets=BUDGETS, seed=11, eos=None,
             prefix=0, mod=None):
    """The trace as Requests of ``mod`` (a module with ``Request``; the
    port's engine by default)."""
    make = (mod.Request if mod is not None else Request)
    rng = np.random.default_rng(seed)
    shared = rng.integers(1, vocab, prefix).astype(np.int32)
    return [make(rid=i, prompt=np.concatenate(
                [shared, rng.integers(1, vocab, L).astype(np.int32)]),
                 max_new_tokens=m, eos_token=eos)
            for i, (L, m) in enumerate(zip(lens, budgets))]


def stats_of(stats) -> dict:
    return {"describe": stats.describe(),
            "admissions": [list(a) for a in stats.admissions],
            "retirements": [list(r) for r in stats.retirements],
            "latencies": list(stats.admission_latencies)}


def graph_of(graph) -> list:
    """Each planner op's name, deps, grid and operand shapes and dtypes."""
    return [[g.op.name, sorted(g.deps), g.op.grid,
             [[list(o.shape), str(o.dtype).replace("torch.", "")]
              for o in (*g.op.inputs, *g.op.outputs)]]
            for g in graph]


def _engine(cfg, params, mesh, budget, max_len=48, **kw):
    return ServeEngine(cfg, params, batch=2, max_len=max_len,
                       prefill_budget=budget, device="cpu", mesh=mesh, **kw)


def _served(eng, reqs) -> dict:
    eng.run(reqs)
    return {"tokens": [r.out_tokens for r in reqs],
            "stats": stats_of(eng.stats),
            "allreduces": [eng.allreduce_calls, eng.allreduce_bytes]}


def _refusal(make) -> str:
    try:
        make()
    except ValueError as e:
        return str(e)
    return "no refusal"


def serve_scenarios(mesh, payload: dict) -> dict:
    torch.set_num_threads(1)
    cfg, cfg2 = reduced(1), reduced(2)
    params = lm.params_from_numpy(cfg, payload["params"], device="cpu")
    params2 = lm.params_from_numpy(cfg2, payload["params2"], device="cpu")
    budget = PrefillBudget(chunk_rows=8)
    out: dict = {}

    # the reference test's trace, mid-batch EOS included, through a
    # schedule cache; then a second engine replans from the warm cache
    cache = ScheduleCache()
    eng = _engine(cfg, params, mesh, budget, schedule_cache=cache)
    reqs = requests(cfg.vocab_size, eos=payload["eos"])
    out["contiguous"] = _served(eng, reqs)
    out["tp_shards"], out["executed"] = eng.tp_shards, eng.executed
    out["mesh_tag"] = eng._mesh_tag
    out["cache_heads"] = int(eng._init_slot_cache()[
        lm.layer_runs(cfg)[0].name]["k"].shape[-2])
    out["cb_program_info"] = dict(eng.cb_program_info)
    out["fused_chunks"] = {n: sorted(c)
                           for n, c in eng._cb_fused_chunks.items()}
    out["plans"] = {n: {
        "graph": graph_of(eng.decode_graph(prefill_chunks=n)),
        "describe": eng.build_decode_program(prefill_chunks=n).describe()}
        for n in (0, 1, 2)}
    out["fusion_plan"] = eng.fusion_plan.summary()
    # the full-width shard plan (planning only: no weights)
    full = ServeEngine(get_config("granite-3-2b"), None, batch=8,
                       max_len=2048, device="cpu", mesh=mesh,
                       prefill_budget=PrefillBudget(chunk_rows=512))
    out["full_width"] = {n: {
        "graph": graph_of(full.decode_graph(prefill_chunks=n)),
        "describe": full.build_decode_program(prefill_chunks=n).describe()}
        for n in (0, 1, 2)}
    n0 = autotuner.SEARCH_COUNT
    warm = _engine(cfg, params, mesh, budget, schedule_cache=cache)
    out["warm"] = _served(warm, requests(cfg.vocab_size, eos=payload["eos"]))
    out["warm_searches"] = autotuner.SEARCH_COUNT - n0

    # the stacked 2-layer config: the program once per layer
    out["stacked"] = _served(
        _engine(cfg2, params2, mesh, budget),
        requests(cfg2.vocab_size, STACKED_LENS, STACKED_BUDGETS, seed=5))

    # paged KV: the arena's Hkv/n heads, a shared prefix served from the
    # pool's prefix cache
    paged = _engine(cfg, params, mesh, PrefillBudget(chunk_rows=16),
                    max_len=64, paged_kv=True, kv_block_size=16)
    out["paged"] = _served(paged, requests(
        cfg.vocab_size, PAGED_LENS, PAGED_BUDGETS, prefix=PAGED_PREFIX))
    out["paged"]["pool"] = paged.kv_pool.snapshot()
    out["paged"]["arena_heads"] = int(paged._arena[
        lm.layer_runs(cfg)[0].name]["k"].shape[-2])

    # the refusals, each before any weight is touched
    n = eng.tp_shards
    out["refusals"] = {
        "wavefront": _refusal(lambda: _engine(cfg, None, mesh, budget,
                                              scheduling="wavefront")),
        "hand_wired": _refusal(lambda: _engine(cfg, None, mesh, budget,
                                               plan_fusion=False)),
        "layernorm": _refusal(lambda: _engine(reduced(1, "stablelm-3b"),
                                              None, mesh, budget)),
        "moe": _refusal(lambda: _engine(reduced(1, "phi3.5-moe-rms"), None,
                                        mesh, budget)),
        "d_ff": _refusal(lambda: _engine(
            dataclasses.replace(cfg, d_ff=cfg.d_ff + 1), None, mesh,
            budget)),
        "num_heads": _refusal(lambda: _engine(
            dataclasses.replace(cfg, num_heads=n + 1, num_kv_heads=1),
            None, mesh, budget)),
        "num_kv_heads": _refusal(lambda: _engine(
            dataclasses.replace(cfg, num_heads=4 * n + n, num_kv_heads=n + 1),
            None, mesh, budget)),
    }
    return out
