"""Tensor-parallel serve in the port against both packages' single-device
engines, on the CPU.

The port's sharded engine is one process a shard: ``launch/mesh.run_ranks``
spawns 2 and then 4 gloo ranks once each for the whole module, and every
scenario of ``tests/_torch_tp_worker.py`` runs in that one spawn (the ranks
import no JAX).  Reduced granite-3-2b in fp32, batch 2, the reference
test's trace (``tests/test_serve_sharded.py``: numpy seed 11, a mid-batch
EOS picked from a probe run), ``PrefillBudget(chunk_rows=8)``:

  * tokens and ServeStats equal the reference's single-device engine and
    the port's, token for token, on every rank alike: contiguous (the EOS
    retirement, fused mixed steps), a second engine replanning from the
    warm schedule cache with no search, the stacked 2-layer config, and
    paged KV (16-row pages, a shared 32-token prefix, ``max_len`` 64,
    ``chunk_rows=16``, the single-layer config the paged arena needs; the
    pool's snapshot too);
  * the shard's graph (op names, deps, grids, operand shapes and dtypes),
    its plan and its launch tables equal the reference's shard plan, at
    this size and at granite-3-2b's full width (batch 8, max_len 2048,
    chunks of 512; planning only), built
    by setting ``tp_shards`` and ``_mesh_tag`` on a reference engine made
    without a mesh (``src/repro/serve/engine.py:486`` and ``:698`` read
    nothing else of the mesh);
  * the KV cache and the paged arena hold Hkv/n heads a rank, and a rank
    all-reduces twice a layer a step and twice a layer a chunk;
  * every refusal text equals the reference's (its engine given an object
    with the mesh's ``shape``, as a JAX mesh has);
  * a sharded signature differs from the single-device one, and neither
    plan resolves the other's cache entries;
  * the serve CLI's ``--mesh-shape 2 --expect-sharded-parity``.

Both packages get the same weights: a numpy tree from a seed
(``test_torch_serve._numpy_params``).
"""
from __future__ import annotations

import dataclasses
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import pytest

import _torch_tp_worker as W
from repro.configs import get_config as jget_config
from repro.serve import engine as jengine
from repro_torch.core import autotuner, planner, schedule_cache
from repro_torch.launch import mesh as tmesh
from repro_torch.models import lm
from repro_torch.serve import engine
from test_torch_serve import _numpy_params


def _jcfg(layers: int = 1, arch: str = "granite-3-2b"):
    cfg = dataclasses.replace(jget_config(arch).reduced(), dtype="float32")
    if layers > 1:
        cfg = dataclasses.replace(cfg, num_layers=layers,
                                  block_pattern=("attn",) * layers)
    return cfg


def _trees():
    return _numpy_params(_jcfg(1)), _numpy_params(_jcfg(2), seed=1)


def _same_stats(got: dict, want: dict) -> None:
    """The port's describe() keys equal the reference's for those keys; the
    admission and retirement logs equal."""
    assert got["describe"] == {k: want["describe"][k]
                               for k in got["describe"]}
    for k in ("admissions", "retirements", "latencies"):
        assert got[k] == want[k], k


def _serve_both(make_j, make_t, reqs_kw):
    """One trace through a reference engine and a port engine (single
    device): {"ref": ..., "port": ...} of tokens, stats (and pool)."""
    out = {}
    for key, make, mod in (("ref", make_j, jengine), ("port", make_t, None)):
        eng = make()
        vocab = eng.cfg.vocab_size
        reqs = W.requests(vocab, mod=mod, **reqs_kw)
        eng.run(reqs)
        out[key] = {"tokens": [r.out_tokens for r in reqs],
                    "stats": W.stats_of(eng.stats)}
        if eng.kv_pool is not None:
            out[key]["pool"] = eng.kv_pool.snapshot()
    return out


@pytest.fixture(scope="module")
def single():
    """Every scenario on one device, in both packages, and the EOS token
    the reference test probes for."""
    tree1, tree2 = _trees()
    jc1, jc2 = _jcfg(1), _jcfg(2)
    tc1, tc2 = W.reduced(1), W.reduced(2)
    jp1, jp2 = (jax.tree_util.tree_map(jnp.asarray, t) for t in (tree1, tree2))
    tp1 = lm.params_from_numpy(tc1, tree1, device="cpu")
    tp2 = lm.params_from_numpy(tc2, tree2, device="cpu")

    def jeng(cfg, p, rows=8, max_len=48, **kw):
        return lambda: jengine.ServeEngine(
            cfg, p, batch=2, max_len=max_len, plan_fusion=True,
            prefill_budget=jengine.PrefillBudget(chunk_rows=rows), **kw)

    def teng(cfg, p, rows=8, max_len=48, **kw):
        return lambda: engine.ServeEngine(
            cfg, p, batch=2, max_len=max_len, device="cpu",
            prefill_budget=engine.PrefillBudget(chunk_rows=rows), **kw)

    probe = W.requests(jc1.vocab_size, mod=jengine)
    jeng(jc1, jp1)().run(probe)
    eos = probe[1].out_tokens[1]
    paged = dict(rows=16, max_len=64, paged_kv=True, kv_block_size=16)
    return {
        "eos": eos, "tree1": tree1, "tree2": tree2,
        "contiguous": _serve_both(jeng(jc1, jp1), teng(tc1, tp1),
                                  dict(eos=eos)),
        "stacked": _serve_both(jeng(jc2, jp2), teng(tc2, tp2),
                               dict(lens=W.STACKED_LENS,
                                    budgets=W.STACKED_BUDGETS, seed=5)),
        "paged": _serve_both(jeng(jc1, jp1, **paged), teng(tc1, tp1, **paged),
                             dict(lens=W.PAGED_LENS, budgets=W.PAGED_BUDGETS,
                                  prefix=W.PAGED_PREFIX)),
    }


@pytest.fixture(scope="module", params=[2, 4], ids=["tp2", "tp4"])
def ranks(request, single):
    payload = {"params": single["tree1"], "params2": single["tree2"],
               "eos": single["eos"]}
    return request.param, tmesh.run_ranks(W.serve_scenarios, request.param,
                                          (payload,), timeout=300)


def test_every_rank_returns_rank_zeros_results(ranks):
    """Every rank's tokens, stats, plans, launch tables and counts are
    rank 0's: gloo's all-reduce hands every rank the same sums, so the
    replicated slot managers never drift apart."""
    n, outs = ranks
    assert len(outs) == n
    for o in outs[1:]:
        assert o == outs[0]


@pytest.mark.parametrize("scenario", ["contiguous", "stacked", "paged"])
def test_tokens_and_stats_match_single_device(ranks, single, scenario):
    _n, outs = ranks
    got, want = outs[0][scenario], single[scenario]
    assert want["port"]["tokens"] == want["ref"]["tokens"]
    assert got["tokens"] == want["ref"]["tokens"]
    _same_stats(got["stats"], want["ref"]["stats"])
    _same_stats(got["stats"], want["port"]["stats"])
    if scenario == "paged":
        assert got["pool"] == want["ref"]["pool"] == want["port"]["pool"]
        assert got["stats"]["describe"]["prefix_hits"] >= 2
    if scenario == "contiguous":
        assert any(r == "eos" for _s, _rid, r in got["stats"]["retirements"])
        assert got["stats"]["describe"]["fused_mixed_steps"] >= 1


def test_warm_cache_replans_without_a_search(ranks):
    _n, outs = ranks
    out = outs[0]
    assert out["warm_searches"] == 0
    assert out["warm"]["tokens"] == out["contiguous"]["tokens"]


def _graph_of(graph):
    """``_torch_tp_worker.graph_of`` for the reference's graph."""
    return [[g.op.name, sorted(g.deps), g.op.grid,
             [[list(o.shape), jnp.dtype(o.dtype).name]
              for o in (*g.op.inputs, *g.op.outputs)]]
            for g in graph]


def test_shard_plan_matches_reference(ranks):
    """The reference's shard plan: its engine made without a mesh, then
    ``tp_shards`` and ``_mesh_tag`` set, so ``decode_graph`` and
    ``build_decode_program`` see one shard's heads and FFN widths."""
    n, outs = ranks
    out = outs[0]
    assert (out["tp_shards"], out["executed"], out["mesh_tag"]) == (
        n, True, f"model:{n}")
    je = jengine.ServeEngine(_jcfg(1), None, batch=2, max_len=48,
                             plan_fusion=True,
                             prefill_budget=jengine.PrefillBudget(
                                 chunk_rows=8))
    je.tp_shards, je._mesh_tag = n, f"model:{n}"
    for k in (0, 1, 2):
        assert out["plans"][k]["graph"] == _graph_of(
            je.decode_graph(prefill_chunks=k))
        assert out["plans"][k]["describe"] == je.build_decode_program(
            prefill_chunks=k).describe()
    assert out["fusion_plan"] == je.plan_decode_fusion().summary()
    # at granite-3-2b's full width (batch 8, max_len 2048, chunk 512)
    jf = jengine.ServeEngine(jget_config("granite-3-2b"), None, batch=8,
                             max_len=2048, plan_fusion=True,
                             prefill_budget=jengine.PrefillBudget(
                                 chunk_rows=512))
    jf.tp_shards, jf._mesh_tag = n, f"model:{n}"
    for k in (0, 1, 2):
        assert out["full_width"][k]["graph"] == _graph_of(
            jf.decode_graph(prefill_chunks=k))
        assert out["full_width"][k]["describe"] == jf.build_decode_program(
            prefill_chunks=k).describe()
    # the served programs are those plans, and the top one runs a mixed
    # prefill + decode launch
    for k, info in out["cb_program_info"].items():
        assert info["steps"] == out["plans"][k]["describe"]
    top = max(out["cb_program_info"])
    assert out["fused_chunks"][top]
    assert out["cb_program_info"][top]["fused_launches"] >= 1
    # one shard's attention: H/n query heads, Hkv/n KV heads
    cfg = W.reduced(1)
    H, Hkv = cfg.num_heads // n, cfg.num_kv_heads // n
    names = [op[0] for op in out["plans"][2]["graph"]]
    assert f"decode_attn_B2_S128_H{H}kv{Hkv}" in names


def test_cache_holds_the_local_heads_and_counts_all_reduces(ranks):
    n, outs = ranks
    out = outs[0]
    cfg = W.reduced(1)
    assert out["cache_heads"] == out["paged"]["arena_heads"] \
        == cfg.num_kv_heads // n
    # two all-reduces a layer a step (W_o, W_out) and two a layer a chunk,
    # each (rows, d_model) fp32
    for scenario, layers, C in (("contiguous", 1, 8), ("stacked", 2, 8),
                                ("paged", 1, 16)):
        st = out[scenario]["stats"]["describe"]
        steps = st["decode_steps"] + st["prefill_only_steps"]
        calls, nbytes = out[scenario]["allreduces"]
        assert calls == layers * 2 * (steps + st["prefill_chunks"])
        assert nbytes == layers * 2 * 4 * cfg.d_model * (
            2 * steps + C * st["prefill_chunks"])


def test_refusals_match_reference(ranks):
    """Each refusal's text is the reference's, for the same config and a
    mesh of the same extent."""
    n, outs = ranks
    mesh = SimpleNamespace(shape={"model": n})
    cfg = _jcfg(1)
    cases = {
        "wavefront": (cfg, dict(scheduling="wavefront")),
        "hand_wired": (cfg, dict(plan_fusion=False)),
        "layernorm": (_jcfg(1, "stablelm-3b"), {}),
        "moe": (_jcfg(1, "phi3.5-moe-rms"), {}),
        "d_ff": (dataclasses.replace(cfg, d_ff=cfg.d_ff + 1), {}),
        "num_heads": (dataclasses.replace(cfg, num_heads=n + 1,
                                          num_kv_heads=1), {}),
        "num_kv_heads": (dataclasses.replace(cfg, num_heads=5 * n,
                                             num_kv_heads=n + 1), {}),
    }
    assert set(cases) == set(outs[0]["refusals"])
    for name, (c, kw) in cases.items():
        kw = {"plan_fusion": True, **kw}
        with pytest.raises(ValueError) as e:
            jengine.ServeEngine(c, None, batch=2, max_len=48, mesh=mesh,
                                prefill_budget=jengine.PrefillBudget(
                                    chunk_rows=8), **kw)
        assert outs[0]["refusals"][name] == str(e.value), name


def test_sharded_signature_never_resolves_a_single_device_entry():
    """The same graph planned with and without the mesh tag through one
    cache: each misses the other's entries, then hits its own."""
    eng = engine.ServeEngine(W.reduced(1), None, batch=2, max_len=48,
                             device="cpu",
                             prefill_budget=engine.PrefillBudget(
                                 chunk_rows=8))
    graph = eng.decode_graph(prefill_chunks=2)
    ops = [g.op for g in graph[:2]]
    single = schedule_cache.bundle_signature(ops, vmem_budget=1 << 20)
    assert schedule_cache.bundle_signature(
        ops, vmem_budget=1 << 20, mesh_tag="model:2") != single
    assert schedule_cache.bundle_signature(
        ops, vmem_budget=1 << 20, mesh_tag="model:4") != \
        schedule_cache.bundle_signature(ops, vmem_budget=1 << 20,
                                        mesh_tag="model:2")
    cache = schedule_cache.ScheduleCache()

    def searches(tag):
        n0 = autotuner.SEARCH_COUNT
        plan = planner.plan(graph, max_ways=4, allow_same_bound=True,
                            cache=cache, mesh_tag=tag)
        return autotuner.SEARCH_COUNT - n0, plan.summary()

    first, plan1 = searches("")
    assert first > 0
    assert searches("model:2")[0] == first      # a miss for every bundle
    assert searches("") == (0, plan1)
    assert searches("model:2")[0] == 0


def test_engine_runs_where_its_mesh_does(monkeypatch):
    """A cuda mesh with no card raises, as ``device.resolve_device`` does;
    a device that is not the mesh's is refused; nothing drops to the CPU."""
    monkeypatch.setattr(tmesh.torch.cuda, "is_available", lambda: False)
    cfg = W.reduced(1)
    mesh = SimpleNamespace(mesh_dim_names=("model",), shape=(2,),
                           device_type="cuda")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        engine.ServeEngine(cfg, None, batch=2, max_len=48, mesh=mesh)
    with pytest.raises(ValueError, match="is not the mesh's"):
        engine.ServeEngine(cfg, None, batch=2, max_len=48, mesh=mesh,
                           device="cpu")


def test_backend_rule(monkeypatch):
    assert tmesh.backend_for("cpu", 4) == "gloo"
    monkeypatch.setattr(tmesh.torch.cuda, "device_count", lambda: 1)
    assert tmesh.backend_for("cuda", 4) == "gloo"     # ranks share a card
    monkeypatch.setattr(tmesh.torch.cuda, "device_count", lambda: 4)
    assert tmesh.backend_for("cuda", 4) == "nccl"     # a card a rank


@pytest.mark.parametrize("axis", ["model", "tp"])
def test_serve_cli_sharded_parity(capsys, axis):
    from repro_torch.launch import serve
    serve.main(["--arch", "granite-3-2b", "--requests", "3",
                "--prompt-len", "5", "--max-new", "3", "--batch", "2",
                "--stagger", "2", "--chunk-rows", "4", "--device", "cpu",
                "--mesh-shape", "2", "--shard-axis", axis,
                "--expect-sharded-parity"])
    out = capsys.readouterr().out
    assert f"2-way tensor-parallel serve over mesh axis '{axis}'" in out
    assert "token-for-token parity with single-device across 3" in out
    calls = int(out.split("[sharded] ")[2].split()[0])
    assert calls > 0            # the ranks all-reduced: they ran sharded


@pytest.mark.parametrize("argv,match", [
    (["--mesh-shape", "2", "--hand-wired"], "--mesh-shape requires"),
    (["--expect-sharded-parity"], "--expect-sharded-parity requires")])
def test_serve_cli_mesh_argument_errors(capsys, argv, match):
    from repro_torch.launch import serve
    with pytest.raises(SystemExit):
        serve.main(["--arch", "granite-3-2b", "--device", "cpu", *argv])
    assert match in capsys.readouterr().err
