"""The port's training slice against the JAX package's, on the CPU.

Reduced granite-3-2b in fp32 (one layer, and a 2-layer stacked variant for
the per-layer gradient slices and remat).  Both packages get the same
weights and moments: numpy trees made from a seed, handed to JAX as arrays
and to the port through ``lm.params_from_numpy`` /
``optimizer.opt_state_from_numpy``.

Tolerances (fp32): the loss to 1e-5 relative (same math, other summation
orders); gradients to 1e-4 relative plus 1e-6 absolute (a backward pass
sums more terms in other orders); the AdamW ops to 1e-6 relative (one
elementwise update); one whole train step to the reference's own bounds for
its executed step (``tests/test_executor.py``: rtol 2e-5, atol 2e-6).  bf16
params: the AdamW ops to one bf16 step (2**-8 relative) of the reference.
Plans (members, schedules, predicted and proxy-measured gains) must be
equal, at reduced width and at full width from abstract params.
"""
from __future__ import annotations

import dataclasses
import json
import math

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.core import autotuner as jtuner
from repro.core import hfuse as jhfuse
from repro.core import timing as jtiming
from repro.core.cost_model import Schedule as JSchedule
from repro.data.pipeline import DataConfig as JDataConfig
from repro.data.pipeline import TokenPipeline as JTokenPipeline
from repro.kernels import adam as jadam
from repro.models import lm as jlm
from repro.train import optimizer as jopt
from repro.train import train_loop as jtl
from repro_torch import tree as tree_mod
from repro_torch.configs import get_config
from repro_torch.core import autotuner, hfuse, schedule_cache, timing
from repro_torch.core.cost_model import Schedule
from repro_torch.data.pipeline import DataConfig, Prefetcher, TokenPipeline
from repro_torch.kernels import adam
from repro_torch.models import layers, lm
from repro_torch.train import checkpoint, optimizer as opt_mod
from repro_torch.train import train_loop as tl
from repro_torch.train.fault_tolerance import StepWatchdog, run_with_restarts

SEQ, BATCH = 16, 2


def _cfgs(layers_: int = 1, dtype: str = "float32"):
    out = []
    for get in (jget_config, get_config):
        c = dataclasses.replace(get("granite-3-2b").reduced(), dtype=dtype)
        if layers_ > 1:
            c = dataclasses.replace(c, num_layers=layers_,
                                    block_pattern=("attn",) * layers_)
        out.append(c)
    return out


def _numpy_tree(jcfg, seed=0, scale_std=0.3):
    """Params in the JAX layout from a numpy seed: weights at the
    reference's init scale, norm scales N(0, scale_std), a small
    embedding."""
    shapes = jax.eval_shape(lambda: jlm.init(jcfg, jax.random.PRNGKey(0)))
    rng = np.random.default_rng(seed)

    def leaf(path, sd):
        name = path[-1].key
        if name == "scale":
            a = rng.normal(size=sd.shape) * scale_std
        else:
            fan_in = sd.shape[-2] if len(sd.shape) >= 2 else sd.shape[-1]
            a = rng.normal(size=sd.shape) * (
                0.02 if name == "embedding" else fan_in ** -0.5)
        dt = (ml_dtypes.bfloat16 if sd.dtype == jnp.bfloat16
              else np.dtype(sd.dtype))
        return a.astype(dt)
    return jax.tree_util.tree_map_with_path(leaf, shapes)


def _moments(tree, seed=1):
    rng = np.random.default_rng(seed)
    m = jax.tree_util.tree_map(
        lambda a: (rng.normal(size=a.shape) * 1e-3).astype(np.float32), tree)
    v = jax.tree_util.tree_map(
        lambda a: (rng.random(size=a.shape) * 1e-5).astype(np.float32), tree)
    return m, v


def _to_np(t: torch.Tensor) -> np.ndarray:
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
    return t.detach().numpy()


def _batch(cfg):
    data = TokenPipeline(DataConfig(vocab_size=cfg.vocab_size, seq_len=SEQ,
                                    global_batch=BATCH))
    nb = data.batch_at(0)
    return ({k: jnp.asarray(v) for k, v in nb.items()},
            {k: torch.from_numpy(v) for k, v in nb.items()})


def _setup(layers_=1, dtype="float32"):
    jcfg, tcfg = _cfgs(layers_, dtype)
    tree = _numpy_tree(jcfg)
    jp = jax.tree_util.tree_map(jnp.asarray, tree)
    tp = lm.params_from_numpy(tcfg, tree, device="cpu")
    return jcfg, tcfg, tree, jp, tp


def _assert_trees_close(jtree, ttree, rtol, atol):
    jl = jax.tree_util.tree_leaves(jtree)
    tlv = tree_mod.leaves(ttree)
    assert len(jl) == len(tlv)
    for a, b in zip(jl, tlv):
        np.testing.assert_allclose(_to_np(b).astype(np.float32),
                                   np.asarray(a, np.float32),
                                   rtol=rtol, atol=atol)


# ---------------------------------------------------------------------------
# model: loss and gradients
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("layers_,remat", [(1, False), (2, True)])
def test_loss_matches_reference(layers_, remat):
    jcfg, tcfg, _tree, jp, tp = _setup(layers_)
    jb, tb = _batch(tcfg)
    jloss, jaux = jlm.loss_fn(jcfg, jp, jb, remat=remat)
    tloss, taux = lm.loss_fn(tcfg, tp, tb, remat=remat)
    np.testing.assert_allclose(float(tloss), float(jloss), rtol=1e-5)
    np.testing.assert_allclose(float(taux["ce"]), float(jaux["ce"]),
                               rtol=1e-5)


@pytest.mark.parametrize("layers_", [1, 2])
def test_grads_match_reference(layers_):
    """The port's gradients, accumulated in place into preset ``.grad``
    views (``train_loop._grad_tree``), equal the reference's jax.grad."""
    jcfg, tcfg, _tree, jp, tp = _setup(layers_)
    jb, tb = _batch(tcfg)
    jg = jax.grad(lambda p: jlm.loss_fn(jcfg, p, jb, remat=True)[0])(jp)
    grads = tree_mod.map_tree(torch.zeros_like, tp)
    total, _ = lm.loss_fn(tcfg, tl._grad_tree(tcfg, tp, grads), tb,
                          remat=True)
    total.backward()
    _assert_trees_close(jg, grads, rtol=1e-4, atol=1e-6)


def test_blockwise_attention_chunk_loop_matches_reference():
    """Several q and kv chunks: the running (max, sum) carry across the
    kv loop, causal mask included."""
    rng = np.random.default_rng(3)
    q = rng.normal(size=(2, 32, 4, 8)).astype(np.float32)
    k = rng.normal(size=(2, 32, 2, 8)).astype(np.float32)
    v = rng.normal(size=(2, 32, 2, 8)).astype(np.float32)
    from repro.models import layers as jlayers
    want = jlayers.blockwise_attention(jnp.asarray(q), jnp.asarray(k),
                                       jnp.asarray(v), chunk_q=8, chunk_k=8)
    got = layers.blockwise_attention(torch.from_numpy(q), torch.from_numpy(k),
                                     torch.from_numpy(v), chunk_q=8,
                                     chunk_k=8)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-6)


def test_cross_entropy_ignores_negative_labels():
    rng = np.random.default_rng(4)
    logits = rng.normal(size=(2, 5, 11)).astype(np.float32) * 3
    labels = rng.integers(-1, 11, size=(2, 5)).astype(np.int32)
    from repro.models import layers as jlayers
    want = jlayers.cross_entropy(jnp.asarray(logits), jnp.asarray(labels))
    got = layers.cross_entropy(torch.from_numpy(logits),
                               torch.from_numpy(labels))
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)


# ---------------------------------------------------------------------------
# the AdamW kernel module
# ---------------------------------------------------------------------------
ADAM_TOL = {"float32": (jnp.float32, torch.float32, 1e-6),
            "bfloat16": (jnp.bfloat16, torch.bfloat16, 2.0 ** -8)}


def _adam_inputs(R, dtype, seed=5):
    jdt, tdt, _tol = ADAM_TOL[dtype]
    rng = np.random.default_rng(seed)
    np_dt = ml_dtypes.bfloat16 if dtype == "bfloat16" else np.float32
    p = rng.normal(size=(R, 128)).astype(np_dt)
    g = (rng.normal(size=(R, 128)) * 0.1).astype(np_dt)
    m = (rng.normal(size=(R, 128)) * 1e-2).astype(np.float32)
    v = (rng.random(size=(R, 128)) * 1e-3).astype(np.float32)
    sc = np.zeros((1, 128), np.float32)
    sc[0, :3] = (3e-3, 1 - 0.9 ** 3, 1 - 0.95 ** 3)
    arrs = (p, g, m, v, sc)

    def torch_of(a):
        if a.dtype == ml_dtypes.bfloat16:
            return torch.from_numpy(a.view(np.uint16).copy()).view(
                torch.bfloat16)
        return torch.from_numpy(a.copy())
    return [jnp.asarray(a) for a in arrs], [torch_of(a) for a in arrs]


def _close(t_out, j_out, dtype):
    tol = ADAM_TOL[dtype][2]
    for a, b in zip(t_out, j_out):
        ref = np.asarray(b, np.float32)
        got = _to_np(a).astype(np.float32)
        if dtype == "bfloat16" and a.dtype == torch.bfloat16:
            assert np.abs(got - ref).max() <= tol * np.abs(ref).max()
        else:
            np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("dtype", sorted(ADAM_TOL))
def test_adamw_op_matches_reference_interpret(dtype):
    R, bm = 96, 32
    jin, tin = _adam_inputs(R, dtype)
    jdt, tdt, _ = ADAM_TOL[dtype]
    jop = jadam.adamw_op(R, dtype=jdt, bm=bm)
    top = adam.adamw_op(R, dtype=tdt, bm=bm)
    jp, jg, jm, jv, jsc = jin
    tp, tg, tm, tv, tsc = tin
    want = jhfuse.run_single(jop, interpret=True)(jsc, jp, jg, jm, jv)
    got = hfuse.run_single(top)(tsc, tp, tg, tm, tv)
    _close(got, want, dtype)
    # in place: the outputs are the donated p, m, v
    assert got[0] is tp and got[1] is tm and got[2] is tv
    assert (top.grid, top.flops, top.hbm_bytes, top.name, top.in_names,
            top.out_names) == (jop.grid, jop.flops, jop.hbm_bytes, jop.name,
                               jop.in_names, jop.out_names)


@pytest.mark.parametrize("dtype", sorted(ADAM_TOL))
def test_adamw_flat_matches_reference_interpret(dtype):
    jin, tin = _adam_inputs(64, dtype, seed=6)
    jp, jg, jm, jv, jsc = jin
    tp, tg, tm, tv, tsc = tin
    want = jadam.adamw_flat(jp, jg, jm, jv, jsc, bm=32, interpret=True)
    got = adam.adamw_flat(tp, tg, tm, tv, tsc, bm=32)
    _close(got, want, dtype)


@pytest.mark.parametrize("dtype", sorted(ADAM_TOL))
def test_multi_tensor_adamw_matches_reference_interpret(dtype):
    """Leaves of every padding case: exact rows, a ragged tail, a leaf
    smaller than one row, a leaf past one block."""
    jdt, tdt, _ = ADAM_TOL[dtype]
    np_dt = ml_dtypes.bfloat16 if dtype == "bfloat16" else np.float32
    rng = np.random.default_rng(7)
    shapes = {"a": (4, 64), "b": (3, 50), "c": (7,), "d": (40, 128)}
    p = {k: rng.normal(size=s).astype(np_dt) for k, s in shapes.items()}
    g = {k: (rng.normal(size=s) * 0.1).astype(np_dt)
         for k, s in shapes.items()}
    m, v = _moments(p, seed=8)
    sc = np.zeros((1, 128), np.float32)
    sc[0, :3] = (1e-3, 1 - 0.9, 1 - 0.95)
    want = jadam.multi_tensor_adamw(
        *(jax.tree_util.tree_map(jnp.asarray, t) for t in (p, g, m, v)),
        jnp.asarray(sc), bm=16, interpret=True)

    def tt(tree):
        return {k: (torch.from_numpy(a.view(np.uint16).copy()).view(
            torch.bfloat16) if a.dtype == ml_dtypes.bfloat16
            else torch.from_numpy(a.copy())) for k, a in tree.items()}
    tp, tm, tv = tt(p), tt(m), tt(v)
    got = adam.multi_tensor_adamw(tp, tt(g), tm, tv, torch.from_numpy(sc),
                                  bm=16)
    assert got[0] is tp                       # updated in place
    for jtree, ttree in zip(want, got):
        _close(tree_mod.leaves(ttree), jax.tree_util.tree_leaves(jtree),
               dtype)


def test_flatten_leaf_views_exact_leaves_and_copies_padded_ones():
    x = torch.arange(4 * 256, dtype=torch.float32).reshape(4, 256)
    buf, n = adam._flatten_leaf(x, row_multiple=8)
    assert n == 1024 and buf.data_ptr() == x.data_ptr()
    y = torch.arange(300, dtype=torch.float32)
    buf, n = adam._flatten_leaf(y, row_multiple=2)
    assert buf.shape == (4, 128) and buf.data_ptr() != y.data_ptr()
    assert torch.equal(buf.reshape(-1)[:300], y)
    assert not buf.reshape(-1)[300:].any()
    buf.add_(1)
    adam._write_back(buf, n, y)
    assert torch.equal(y, torch.arange(300, dtype=torch.float32) + 1)


def test_flatten_for_adam_roundtrip():
    t = {"a": torch.randn(3, 5), "b": torch.randn(7)}
    buf, n = adam.flatten_for_adam(t)
    assert buf.shape == (1, 128) and n == 22
    back = adam.unflatten_from_adam(buf, n, t)
    assert all(torch.equal(back[k], t[k]) for k in t)


# ---------------------------------------------------------------------------
# one train step, plain and program routes
# ---------------------------------------------------------------------------
def _jstep(jcfg, jp, jm, jv, jb, count, program=None):
    ocfg = jopt.AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=10)
    tcfg = jtl.TrainConfig(optimizer=ocfg, remat=False)
    opt = jopt.OptState(jm, jv, jnp.asarray(count, jnp.int32))
    step = jtl.make_train_step(jcfg, tcfg, update_program=program)
    return step(jp, opt, jb, jnp.asarray(0))


@pytest.mark.parametrize("route", ["plain", "program", "hfused_off_card"])
def test_train_step_matches_reference(route):
    jcfg, tcfg, tree, jp, tp = _setup()
    m, v = _moments(tree)
    jb, tb = _batch(tcfg)
    ocfg = opt_mod.AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=10,
                               hfused=route == "hfused_off_card")
    prog = (tl.build_update_program(lm.abstract_params(tcfg), ocfg)
            if route == "program" else None)
    step = tl.make_train_step(tcfg, tl.TrainConfig(optimizer=ocfg,
                                                   remat=False),
                              update_program=prog)
    state = opt_mod.opt_state_from_numpy(m, v, 2, tp)
    new_p, new_s, met = step(tp, state, tb, 0)
    jm_, jv_ = (jax.tree_util.tree_map(jnp.asarray, t) for t in (m, v))
    jp2, js2, jmet = _jstep(jcfg, jp, jm_, jv_, jb, 2)
    np.testing.assert_allclose(float(met["loss"]), float(jmet["loss"]),
                               rtol=1e-5)
    np.testing.assert_allclose(float(met["grad_norm"]),
                               float(jmet["grad_norm"]), rtol=1e-5)
    np.testing.assert_allclose(float(met["lr"]), float(jmet["lr"]),
                               rtol=1e-6)
    assert int(new_s.count) == int(js2.count) == 3
    _assert_trees_close(jp2, new_p, rtol=2e-5, atol=2e-6)
    _assert_trees_close(js2.m, new_s.m, rtol=2e-5, atol=2e-6)
    _assert_trees_close(js2.v, new_s.v, rtol=2e-5, atol=2e-6)
    if route == "program":
        assert new_p is tp              # the program updates in place


def test_grad_accumulation_matches_reference():
    jcfg, tcfg, tree, jp, tp = _setup()
    jb, tb = _batch(tcfg)
    ocfg = opt_mod.AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=10)
    step = tl.make_train_step(tcfg, tl.TrainConfig(optimizer=ocfg,
                                                   remat=False,
                                                   grad_accum=2))
    new_p, _s, met = step(tp, opt_mod.init(tp), tb, 0)
    jstep = jtl.make_train_step(jcfg, jtl.TrainConfig(
        optimizer=jopt.AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=10),
        remat=False, grad_accum=2))
    jp2, _js, jmet = jstep(jp, jopt.init(jp), jb, jnp.asarray(0))
    np.testing.assert_allclose(float(met["loss"]), float(jmet["loss"]),
                               rtol=1e-5)
    _assert_trees_close(jp2, new_p, rtol=2e-5, atol=2e-6)


def test_unported_train_options_raise():
    for kw in (dict(compression="int8_pod"), dict(zero=True)):
        with pytest.raises(NotImplementedError, match="ROADMAP item 5"):
            tl.TrainConfig(**kw)
    from repro_torch.launch import train
    with pytest.raises(NotImplementedError, match="ROADMAP item 5"):
        train.main(["--arch", "granite-3-2b", "--device", "cpu", "--zero"])


def test_program_rejects_other_hyperparameters():
    _j, tcfg = _cfgs()
    prog = tl.build_update_program(lm.abstract_params(tcfg),
                                   opt_mod.AdamWConfig(b1=0.8))
    params = lm.init(tcfg, torch.Generator().manual_seed(0), device="cpu")
    with pytest.raises(ValueError, match="hyperparameters"):
        opt_mod.update(opt_mod.AdamWConfig(), params, opt_mod.init(params),
                       params, program=prog)


# ---------------------------------------------------------------------------
# plans: equal to the reference's, cost-model and proxy-measured
# ---------------------------------------------------------------------------
def _plan_rows(plan):
    return [(r["members"], r["schedule"], r["vmem_cap"],
             r["predicted_speedup_pct"], r["measured_speedup_pct"])
            for r in plan.summary()]


def _abstract(scale):
    jc, tc = (c if scale == "full" else c.reduced()
              for c in (jget_config("granite-3-2b"),
                        get_config("granite-3-2b")))
    return (jax.eval_shape(lambda: jlm.init(jc, jax.random.PRNGKey(0))),
            lm.abstract_params(tc))


@pytest.mark.parametrize("scale", ["reduced", "full"])
@pytest.mark.parametrize("measured", [False, True])
def test_plan_update_fusion_equals_reference(scale, measured):
    ja, ta = _abstract(scale)
    jm = jtiming.make_measure("interpret") if measured else None
    tm = timing.make_measure("interpret") if measured else None
    jplan = jtl.plan_update_fusion(ja, tokens=4096, measure=jm)
    tplan = tl.plan_update_fusion(ta, tokens=4096, measure=tm)
    assert _plan_rows(tplan) == _plan_rows(jplan)
    assert tplan.rejected == jplan.rejected
    chains = [m for r in tplan.summary() for m in r["members"].split("+")
              if "→" in m]
    # at reduced width every 2-D leaf's dW stitches its own update; at full
    # width the weights are stacked (3-D) or indivisible (the embedding),
    # and only the two stacked (40, 2048) norm scales are 2-D
    assert len(chains) == (5 if scale == "reduced" else 2)


@pytest.mark.parametrize("scale", ["reduced", "full"])
@pytest.mark.parametrize("measured", [False, True])
def test_build_update_program_equals_reference(scale, measured):
    ja, ta = _abstract(scale)
    jm = jtiming.make_measure("interpret") if measured else None
    tm = timing.make_measure("interpret") if measured else None
    jprog = jtl.build_update_program(ja, measure=jm)
    tprog = tl.build_update_program(ta, measure=tm)
    assert tprog.describe() == jprog.describe()
    assert _plan_rows(tprog.plan) == _plan_rows(jprog.plan)
    assert tprog.layout == [(n, tuple(k.key for k in p), *rest)
                            for n, p, *rest in jprog.layout]


def test_leaf_update_names_equal_reference():
    ja, ta = _abstract("full")
    jn = [jtl.leaf_update_name(p)
          for p, _ in jax.tree_util.tree_flatten_with_path(ja)[0]]
    tn = [tl.leaf_update_name(p) for p, _ in tree_mod.flatten_with_paths(ta)]
    assert tn == jn and len(tn) == 8


def test_update_bundle_proxy_and_steps_equal_reference():
    """``fused.n_steps`` (the launch's CTA count) equals the reference's
    fused grid for AdamW members, so the proxy scores agree."""
    ops_t = [adam.adamw_op(R, bm=bm, name=f"a{i}") for i, (R, bm) in
             enumerate(((64, 32), (16, 16), (96, 32)))]
    ops_j = [jadam.adamw_op(R, bm=bm, name=f"a{i}") for i, (R, bm) in
             enumerate(((64, 32), (16, 16), (96, 32)))]
    for ratios in ((1, 1, 1), (2, 1, 3), (4, 1, 1)):
        tf = hfuse.generate(ops_t, Schedule(ratios))
        jf = jhfuse.generate(ops_j, JSchedule(ratios), interpret=True)
        assert tf.n_steps == jf.n_steps
        assert (timing.step_time_proxy(tf, ops_t)
                == jtiming.step_time_proxy(jf, ops_j))
    assert (timing.step_time_proxy(hfuse.run_native(ops_t), ops_t)
            == jtiming.step_time_proxy(jhfuse.run_native(ops_j), ops_j))


def test_measured_search_reports_measurements():
    ops = [adam.adamw_op(R, bm=bm, name=f"a{i}")
           for i, (R, bm) in enumerate(((64, 32), (16, 16), (96, 8)))]
    calls = []

    def measure(fused, *bundle):
        calls.append(fused)
        return timing.step_time_proxy(fused, bundle)
    measure.backend = "interpret"
    res = autotuner.search(ops, measure=measure)
    assert res.n_measured == len(calls) and 0 < res.n_measured <= 3 + 4
    assert res.best.measured_s is not None
    rows = [r for r in res.table() if r["measured_s"] is not None]
    assert len(rows) == res.n_measured
    assert all(r["cm_vs_measured_delta_pct"] is not None for r in rows)
    jres = jtuner.search(
        [jadam.adamw_op(R, bm=bm, name=f"a{i}")
         for i, (R, bm) in enumerate(((64, 32), (16, 16), (96, 8)))],
        measure=jtiming.make_measure("interpret"))
    assert res.best.sched.ratios == jres.best.sched.ratios
    assert res.n_measured == jres.n_measured


def test_make_measure_gpu_needs_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        timing.make_measure("gpu")
    with pytest.raises(ValueError, match="backend"):
        timing.make_measure("tpu")


# ---------------------------------------------------------------------------
# schedule cache
# ---------------------------------------------------------------------------
def test_cached_replan_performs_zero_searches(tmp_path):
    _j, tcfg = _cfgs()
    abstract = lm.abstract_params(tcfg)
    cache = schedule_cache.ScheduleCache(tmp_path / "sched.json")
    p1 = tl.build_update_program(abstract, cache=cache)
    n = autotuner.SEARCH_COUNT
    p2 = tl.build_update_program(
        abstract, cache=schedule_cache.ScheduleCache(tmp_path / "sched.json"))
    assert autotuner.SEARCH_COUNT == n, "replan re-searched a bundle"
    assert p1.describe() == p2.describe()
    # measured mode keys its own entries, and replans from them too
    m = timing.make_measure("interpret")
    tl.plan_update_fusion(abstract, measure=m, cache=cache)
    n = autotuner.SEARCH_COUNT
    again = tl.plan_update_fusion(abstract, measure=m, cache=cache)
    assert autotuner.SEARCH_COUNT == n
    assert all(d.measured_speedup_pct is not None for d in again.fused)


def test_schedule_cache_corrupt_lru_and_merge(tmp_path):
    path = tmp_path / "c.json"
    path.write_text("{not json")
    c = schedule_cache.ScheduleCache(path, max_entries=2)
    assert len(c) == 0                          # corrupt == empty
    c.put("a", {"x": 1})
    c.put("b", {"x": 2})
    c.get("a")
    c.put("c", {"x": 3})                        # evicts b, least recent
    assert set(c.entries) == {"a", "c"} and c.evictions == 1
    # two writers of one file: each save keeps the other's entries
    p2 = tmp_path / "m.json"
    w1, w2 = (schedule_cache.ScheduleCache(p2) for _ in range(2))
    w1.put("k1", {"x": 1})
    w2.put("k2", {"x": 2})
    assert set(json.loads(p2.read_text())["entries"]) == {"k1", "k2"}
    with w1.batched():
        w1.put("k3", {"x": 3})
        assert "k3" not in json.loads(p2.read_text())["entries"]
    assert "k3" in json.loads(p2.read_text())["entries"]
    blob = json.loads(p2.read_text())
    blob["version"] = -1                        # stale schema: discarded
    p2.write_text(json.dumps(blob))
    assert len(schedule_cache.ScheduleCache(p2)) == 0


def test_schedule_cache_is_not_the_reference_file(monkeypatch, tmp_path):
    from repro.core import schedule_cache as jsc
    monkeypatch.delenv("REPRO_TORCH_SCHEDULE_CACHE", raising=False)
    monkeypatch.setenv("REPRO_SCHEDULE_CACHE", str(tmp_path / "ref.json"))
    c = schedule_cache.default_cache()
    assert c.path == schedule_cache.DEFAULT_PATH
    assert c.path != jsc.default_cache().path
    ops = [adam.adamw_op(64, bm=32)]
    jops = [jadam.adamw_op(64, bm=32)]
    assert (schedule_cache.bundle_signature(ops, vmem_budget=1)
            != jsc.bundle_signature(jops, vmem_budget=1))


def test_serve_engine_measure_and_cache_reach_the_plan(tmp_path):
    """Full-width planning (no weights): the measure picks the decode
    plan's schedules and the cache makes a second engine search nothing."""
    from repro_torch.serve import engine
    cfg = get_config("granite-3-2b")
    cache = schedule_cache.ScheduleCache(tmp_path / "s.json")
    m = timing.make_measure("interpret")

    def build():
        eng = engine.ServeEngine(
            cfg, None, batch=8, max_len=2048, device="cpu", measure=m,
            schedule_cache=cache,
            prefill_budget=engine.PrefillBudget(chunk_rows=512))
        return eng, eng.build_decode_program(prefill_chunks=2)

    eng, prog = build()
    assert eng.fusion_plan.fused and len(cache) > 0
    assert all(d.measured_speedup_pct is not None
               for d in eng.fusion_plan.fused)
    n = autotuner.SEARCH_COUNT
    _eng2, prog2 = build()
    assert autotuner.SEARCH_COUNT == n
    assert prog2.describe() == prog.describe()


# ---------------------------------------------------------------------------
# the dW -> adamw chain: one member, equal to the two ops and the reference
# ---------------------------------------------------------------------------
def test_dw_adamw_chain_plain_equals_separate_ops():
    """The chain is a ``RowChain`` whose CTAs are the dW GEMM's; its plain
    route equals dW then the update bit for bit, and the reference's chain
    (``tests/test_stitch.py:127``, interpret mode) on the same numpy inputs
    within fp32 rounding (two frameworks sum dW's products in other
    orders)."""
    from repro.core import stitch as jstitch
    from repro.kernels.matmul import matmul_1d_op as jmatmul_op
    from repro_torch.core import stitch
    from repro_torch.kernels import row
    from repro_torch.kernels.matmul import matmul_1d_op
    d_in, d_out, tokens = 64, 128, 16
    dw = dataclasses.replace(matmul_1d_op(d_in, tokens, d_out,
                                          dtype=torch.float32, bm=64),
                             name="dW_w")
    upd = adam.adamw_op(d_in * d_out // 128, dtype=torch.float32,
                        bm=64 * d_out // 128, name="adamw_w")
    assert stitch.can_stitch(dw, upd, "g") is None
    chain = stitch.stitch(dw, upd, "g")
    assert isinstance(chain.member, row.RowChain)
    assert chain.member.consumer == upd.member
    assert chain.ctas == dw.ctas
    rng = np.random.default_rng(0)
    R = d_in * d_out // 128
    arrs = [rng.normal(size=(d_in, tokens)), rng.normal(size=(tokens, d_out)),
            np.zeros((1, 128)), rng.normal(size=(R, 128)),
            rng.normal(size=(R, 128)), rng.uniform(size=(R, 128))]  # v >= 0
    arrs[2][0, :3] = (1e-3, 0.1, 0.05)
    arrs = [a.astype(np.float32) for a in arrs]
    x, dy, sc, *state = [torch.from_numpy(a.copy()) for a in arrs]
    a = [t.clone() for t in state]
    out = hfuse.run_single(chain)(x, dy, sc, a[0], a[1], a[2])
    (grad,) = hfuse.run_single(dw)(x, dy)
    b = [t.clone() for t in state]
    ref = hfuse.run_single(upd)(sc, b[0], grad.reshape(R, 128), b[1], b[2])
    assert all(torch.equal(u, w) for u, w in zip(out, ref))
    jchain = jstitch.stitch(jmatmul_op(d_in, tokens, d_out, jnp.float32,
                                       bm=64),
                            jadam.adamw_op(R, jnp.float32, bm=64 * d_out
                                           // 128), "g")
    want = jhfuse.run_single(jchain, interpret=True)(
        *[jnp.asarray(a) for a in arrs])
    for u, w in zip(out, want):
        np.testing.assert_allclose(u.numpy(), np.asarray(w), rtol=1e-5,
                                   atol=1e-5)


# ---------------------------------------------------------------------------
# data, checkpoints, restarts, the launcher
# ---------------------------------------------------------------------------
def test_token_pipeline_bitwise_equal_reference():
    for kw in (dict(vocab_size=512, seq_len=16, global_batch=4),
               dict(vocab_size=49155, seq_len=64, global_batch=2, seed=3)):
        tp, jp = TokenPipeline(DataConfig(**kw)), JTokenPipeline(
            JDataConfig(**kw))
        for step in (0, 1, 7):
            a, b = tp.batch_at(step), jp.batch_at(step)
            assert a.keys() == b.keys()
            assert all(np.array_equal(a[k], b[k]) for k in a)
    tp.skip_ahead(2)
    assert tp.state()["step"] == 2
    pre = Prefetcher(iter([{"x": 1}, {"x": 2}]))
    assert [b["x"] for b in pre] == [1, 2]
    pre.close()


def _state_tree():
    g = torch.Generator().manual_seed(1)
    return {"params": {"w": torch.randn(4, 8, generator=g).to(torch.bfloat16),
                       "s": torch.randn(8, generator=g)},
            "m": {"w": torch.randn(4, 8, generator=g)}}


def test_checkpoint_roundtrip_bf16_and_corruption_skip(tmp_path):
    tree = _state_tree()
    checkpoint.save(tmp_path, 1, tree, {"loss": 1.5})
    d2 = checkpoint.save(tmp_path, 2, tree)
    like = tree_mod.map_tree(torch.zeros_like, tree)
    got, meta = checkpoint.restore(tmp_path, 1, like)
    assert meta == {"loss": 1.5}
    for a, b in zip(tree_mod.leaves(got), tree_mod.leaves(tree)):
        assert a.dtype == b.dtype and torch.equal(a, b)
    # a truncated leaf makes step 2 invalid: the latest valid step is 1
    f = next(p for p in d2.iterdir() if p.suffix == ".bin")
    f.write_bytes(f.read_bytes()[:3])
    assert checkpoint.latest_step(tmp_path) == 1
    (tmp_path / "step_0000000003").mkdir()       # no manifest: skipped
    step, _tree, _meta = checkpoint.restore_latest(tmp_path, like)
    assert step == 1
    manifest = json.loads((tmp_path / "step_0000000001" / "manifest.json")
                          .read_text())
    assert manifest["leaves"]["params/w"]["dtype"] == "bfloat16"


def test_async_checkpointer_keeps_newest(tmp_path):
    ck = checkpoint.AsyncCheckpointer(tmp_path, keep=2)
    tree = _state_tree()
    for step in range(1, 5):
        ck.save_async(step, tree)
    ck.wait()
    assert checkpoint.valid_steps(tmp_path) == [3, 4]


def test_run_with_restarts_resumes_from_checkpoint(tmp_path):
    """A loop that crashes at step 3 restarts, restores step 2 and
    finishes; the restored state is the saved one."""
    seen = []

    def make_state():
        w = {"w": torch.zeros(3)}
        got = checkpoint.restore_latest(tmp_path, w)
        return (got[0], got[1]) if got else (0, w)

    def loop(state, failures):
        start, w = state
        for step in range(start, 5):
            if step == 3 and failures == 0:
                raise RuntimeError("injected fault")
            w = {"w": w["w"] + 1}
            seen.append(step)
            checkpoint.save(tmp_path, step + 1, w)
        return w

    out = run_with_restarts(make_state, loop, max_failures=1)
    assert seen == [0, 1, 2, 3, 4] and torch.equal(out["w"], torch.full(
        (3,), 5.0))
    wd = StepWatchdog(warmup=2)
    assert not any(wd.observe(i, 1.0) for i in range(6))
    assert wd.observe(6, 50.0)


def test_train_launcher_on_cpu(capsys, tmp_path, monkeypatch):
    from repro_torch.launch import train
    monkeypatch.setenv("REPRO_TORCH_SCHEDULE_CACHE", str(tmp_path / "c.json"))
    losses = train.main(["--arch", "granite-3-2b", "--scale", "smoke",
                         "--device", "cpu", "--steps", "3", "--batch", "2",
                         "--seq", "16", "--plan-fusion", "--measure",
                         "interpret", "--log-every", "1", "--ckpt-dir",
                         str(tmp_path / "ck")])
    out = capsys.readouterr().out
    assert len(losses) == 3 and all(math.isfinite(x) for x in losses)
    assert "executed update program (2 fused launches)" in out
    assert checkpoint.latest_step(tmp_path / "ck") == 3
    resumed = train.main(["--arch", "granite-3-2b", "--device", "cpu",
                          "--steps", "4", "--batch", "2", "--seq", "16",
                          "--ckpt-dir", str(tmp_path / "ck"), "--resume"])
    assert len(resumed) == 1 and "[resume] from step 3" in \
        capsys.readouterr().out


def test_train_launcher_needs_a_device_without_cuda(monkeypatch):
    from repro_torch.launch import train
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train.main(["--arch", "granite-3-2b", "--steps", "1"])
