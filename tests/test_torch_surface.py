"""The names the port's modules had left out, and maxpool's signed zero,
against the JAX package on the CPU.

  * maxpool: the plain version's bit patterns (``.view(int32)`` fp32,
    ``.view(int16)`` bf16) equal ``repro.kernels.ref.maxpool``'s and the
    reference kernel's under ``hfuse.run_single(op, interpret=True)``, on
    SMALL_KW's shape with zeros of both signs in both orders of a pair,
    beside NaN and +-inf (``torch.equal`` takes -0 == +0, so only bits show
    the sign).
  * decode attention's static forms: ``decode_attention_op(length=...)``
    and ``(dynamic_length=False)`` (the whole cache), contiguous and paged:
    the planning metadata is the reference's, and the plain version matches
    the reference's kernel in interpret mode (fp32 to 1e-5).
  * ``core/timing.py``: ``resolve_backend`` and ``make_measure(backend=
    "auto", execute=)``; ``core/cost_model.py``: the correction table read
    from ``$REPRO_COST_CORRECTIONS``, ``fusion_profitable`` and
    ``bundle_profitable`` over the 100-pair stitch sweep, ``Schedule.ra`` and
    ``.rb``; ``core/op_spec.py``: ``OpSpec.step_costs``, ``.describe`` and
    ``make_operand``; ``core/binding.py``: ``synth_state``;
    ``ModelConfig.param_count``, ``.active_param_count`` and
    ``lm.count_params``: each equal to the reference's.
  * The serve CLI's new flags drive the engine with ``--device cpu``.
"""
from __future__ import annotations

import dataclasses
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.core import binding as jbinding
from repro.core import cost_model as jcost
from repro.core import hfuse as jhfuse
from repro.core import op_spec as jop_spec
from repro.core import timing as jtiming
from repro.kernels import paper_suite as jps
from repro.kernels import ref as jref
from repro.kernels.decode_attention import decode_attention_op as jdecode
from repro.models import lm as jlm
from repro_torch.configs import get_config
from repro_torch.core import autotuner, binding, cost_model, hfuse, op_spec
from repro_torch.core import timing
from repro_torch.core.cost_model import Schedule
from repro_torch.kernels import paper_suite as ps
from repro_torch.kernels.decode_attention import decode_attention_op
from repro_torch.models import lm
from test_torch_kernels import _planning
from test_torch_stitch import PAIRS, SWEEP_IDS, _sweep_ops

BITS = {"float32": torch.int32, "bfloat16": torch.int16}


# ---------------------------------------------------------------------------
# maxpool's signed zero
# ---------------------------------------------------------------------------
def _signed_zeros(R, C):
    """Zeros with -0 in the second row of each pair on the left half and in
    the first row on the right half (one pair of -0 in the last column),
    then NaN and +-inf in both rows."""
    x = np.zeros((R, C), np.float32)
    half = C // 2
    x[1::2, :half] = -0.0
    x[0::2, half:] = -0.0
    x[2, C - 1] = x[3, C - 1] = -0.0
    x[4, 1], x[5, 2], x[6, 3], x[7, 3] = np.nan, np.nan, np.inf, -np.inf
    x[8, 4], x[9, 4] = -np.inf, 0.0
    return x


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_maxpool_signed_zero_bits_match_the_reference(dtype):
    kw = dict(jps.SMALL_KW["maxpool"])
    x = _signed_zeros(kw["R"], kw["C"])
    jx = jnp.asarray(x).astype(jnp.dtype(dtype))
    jop, _mk, _ref = jps.make_maxpool(**kw, dtype=jnp.dtype(dtype))
    tdt = getattr(torch, dtype)
    tx = ps.inputs_from_numpy("maxpool", [x], "cpu", **kw, dtype=tdt)[0]
    got = ps.maxpool(tx)
    bits = BITS[dtype]
    for want in (jref.maxpool(jx),
                 jhfuse.run_single(jop, interpret=True)(jx)[0]):
        w = torch.from_numpy(np.array(want.astype(jnp.float32))).to(tdt)
        assert torch.equal(got.view(bits), w.view(bits))
    zero_signs = got.signbit() & (got == 0)
    assert not bool(zero_signs[:, :kw["C"] // 2].any())
    assert bool(zero_signs[1, -1])                   # the (-0, -0) pair


# ---------------------------------------------------------------------------
# decode attention's static forms
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("paged", [False, True])
@pytest.mark.parametrize("length", [1, 37, None])
def test_static_decode_attention_matches_reference(length, paged):
    B, S, H, Hkv, D, ck, bs = 2, 256, 4, 2, 16, 128, 16
    bt = (B * S // bs + 3, bs) if paged else None
    jop = jdecode(B, S, H, Hkv, D, dtype=jnp.float32, ck=ck, length=length,
                  block_table=bt)
    top = decode_attention_op(B, S, H, Hkv, D, dtype=torch.float32, ck=ck,
                              length=length, block_table=bt)
    assert _planning(top) == _planning(jop)
    assert top.in_names == (("bt",) if paged else ()) + ("q", "k", "v")
    assert top.member.length == (length or S)
    rng = np.random.default_rng(3)
    kv_shape = (bt[0], bs, Hkv, D) if paged else (B, S, Hkv, D)
    arrs = [rng.normal(size=(B, H, D)), rng.normal(size=kv_shape),
            rng.normal(size=kv_shape)]
    arrs = [a.astype(np.float32) for a in arrs]
    if paged:
        table = rng.permutation(bt[0])[:B * S // bs].reshape(B, S // bs)
        arrs.insert(0, table.astype(np.int32))
    want = jhfuse.run_single(jop, interpret=True)(*map(jnp.asarray, arrs))
    got = hfuse.run_single(top)(*map(torch.from_numpy, arrs))
    for w, g in zip(want, got):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5,
                                   atol=1e-5)


def test_decode_attention_op_refuses_both_forms():
    with pytest.raises(ValueError, match="not both"):
        decode_attention_op(2, 256, 4, 2, 16, ck=128, length=3,
                            dynamic_length=True)
    with pytest.raises(ValueError, match="must lie in"):
        decode_attention_op(2, 256, 4, 2, 16, ck=128, length=257)


# ---------------------------------------------------------------------------
# core/timing.py, core/cost_model.py, core/op_spec.py, core/binding.py
# ---------------------------------------------------------------------------
def test_resolve_backend_and_auto_measure(monkeypatch):
    assert timing.resolve_backend("gpu") == "gpu"
    assert timing.resolve_backend("auto", device="cpu") == "interpret"
    assert timing.resolve_backend("auto", device="cuda:0") == "gpu"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert timing.resolve_backend() == jtiming.resolve_backend() \
        == "interpret"
    m = timing.make_measure()
    assert m.backend == "interpret" and m.rank_only
    with pytest.raises(RuntimeError, match="no CUDA device"):
        timing.make_measure("gpu")


def test_auto_measure_with_execute_runs_and_plans_as_the_reference():
    """``execute=True`` runs each candidate's plain route on synthesized
    operands (the reference runs it in interpret mode); the schedule it
    picks is the step-count proxy's without it.  (The proxy charges the
    port's CTA counts, so on paper members it may pick another schedule
    than the reference's proxy: ROADMAP §3.)"""
    tops = [ps.ALL_KERNELS[n](**jps.SMALL_KW[n])[0]
            for n in ("maxpool", "sha_like")]
    calls = []
    measure = timing.make_measure("auto", execute=True, device="cpu")
    orig = hfuse.generate

    def spy(ops, sched, **kw):
        calls.append(kw)
        return orig(ops, sched, **kw)

    hfuse.generate, saved = spy, hfuse.generate
    try:
        got = autotuner.search(tops, measure=measure)
    finally:
        hfuse.generate = saved
    want = autotuner.search(tops, measure=timing.make_measure("interpret"))
    assert got.best.sched.ratios == want.best.sched.ratios
    assert {"plain": True} in calls
    assert jtiming.make_measure("auto", execute=True).backend \
        == measure.backend == "interpret"


def test_cost_corrections_from_the_environment(monkeypatch, tmp_path):
    table = {"classes": {"decode_attn": {"correction": 1.5},
                         "rmsnorm": 0.25}}
    path = tmp_path / "corr.json"
    path.write_text(json.dumps(table))
    for mod in (cost_model, jcost):
        monkeypatch.setattr(mod, "_corrections", None)
        monkeypatch.setattr(mod, "_corrections_env_loaded", False)
    monkeypatch.setenv("REPRO_COST_CORRECTIONS", str(path))
    for name in ("decode_attn_B8_S2048_H32kv8", "rmsnorm_R8_d64", "ffn_proj"):
        assert cost_model.correction_for(name) == jcost.correction_for(name)
    assert cost_model.correction_for("decode_attn_B2_S128_H4kv4") == 1.5
    assert cost_model.correction_for("rmsnorm") == 0.5      # clamped
    # an explicit table wins; an unreadable file is no table
    cost_model.set_corrections(None)
    assert cost_model.correction_for("decode_attn_B2") == 1.0
    path.write_text("{not json")
    monkeypatch.setattr(cost_model, "_corrections_env_loaded", False)
    assert cost_model.correction_for("decode_attn_B2") == 1.0


@pytest.mark.parametrize("pair", PAIRS, ids=SWEEP_IDS)
def test_profitability_matches_reference(pair):
    (jp, jc), (tp, tc) = _sweep_ops(*pair)
    assert cost_model.fusion_profitable(tp, tc) == \
        jcost.fusion_profitable(jp, jc)
    assert cost_model.bundle_profitable([tp, tc, tp]) == \
        jcost.bundle_profitable([jp, jc, jp])


def test_schedule_ratios_and_op_descriptions_match_reference():
    s, js = Schedule(3, 5), jcost.Schedule(3, 5)
    assert (s.ra, s.rb) == (js.ra, js.rb) == (3, 5)
    assert Schedule((2, 7, 1)).rb == 7
    for n in ("maxpool", "ethash_like", "sha_like"):
        jop = jps.ALL_KERNELS[n](**jps.SMALL_KW[n])[0]
        top = ps.ALL_KERNELS[n](**jps.SMALL_KW[n])[0]
        assert top.describe() == jop.describe()
        assert top.step_costs() == jop.step_costs()
    t = torch.zeros((4, 8), dtype=torch.bfloat16)
    o = op_spec.make_operand(t, (2, 8), lambda s: (s, 0))
    assert (o.shape, o.dtype, o.block_shape, o.index_map(3)) == \
        ((4, 8), torch.bfloat16, (2, 8), (3, 0))


def test_synth_state_keys_shapes_dtypes_match_reference():
    from repro.kernels.matmul import matmul_1d_op as jmatmul
    from repro.kernels.rmsnorm import rmsnorm_op as jrmsnorm
    from repro_torch.kernels.matmul import matmul_1d_op
    from repro_torch.kernels.rmsnorm import rmsnorm_op
    jops = [jrmsnorm(8, 64, jnp.bfloat16, bm=8),
            jmatmul(8, 64, 128, jnp.bfloat16, bm=8),
            jdecode(2, 256, 4, 2, 16, ck=128, dynamic_length=True)]
    tops = [rmsnorm_op(8, 64, torch.bfloat16, bm=8),
            matmul_1d_op(8, 64, 128, torch.bfloat16, bm=8),
            decode_attention_op(2, 256, 4, 2, 16, ck=128,
                                dynamic_length=True)]
    want = jbinding.synth_state(jops)
    got = binding.synth_state(tops)
    assert list(got) == list(want)
    for k in want:
        assert tuple(got[k].shape) == tuple(want[k].shape)
        assert str(got[k].dtype).split(".")[-1] == str(want[k].dtype)
    again = binding.synth_state(tops)
    assert all(torch.equal(got[k], again[k]) for k in got)


@pytest.mark.parametrize("arch", ["granite-3-2b", "phi3.5-moe-rms"])
@pytest.mark.parametrize("reduced", [False, True])
def test_param_counts_match_reference(arch, reduced):
    jc, tc = jget_config(arch), get_config(arch)
    if reduced:
        jc, tc = jc.reduced(), tc.reduced()
    assert tc.param_count() == jc.param_count() == lm.count_params(tc)
    assert tc.active_param_count() == jc.active_param_count() \
        == jlm.count_params(jc, active_only=True)
    assert (tc.active_param_count() < tc.param_count()) == tc.is_moe


# ---------------------------------------------------------------------------
# The serve CLI's new flags
# ---------------------------------------------------------------------------
def _serve(args, capsys):
    from repro_torch.launch import serve
    serve.main(["--arch", "granite-3-2b", "--requests", "4", "--prompt-len",
                "5", "--max-new", "3", "--batch", "2", "--stagger", "2",
                "--device", "cpu"] + args)
    return capsys.readouterr().out


def test_serve_cli_wavefront_and_stitched(capsys):
    out = _serve(["--scheduling", "wavefront", "--plan-fusion",
                  "--expect-stitched"], capsys)
    assert "EXECUTES through the plan->program executor" in out
    assert "[stitch] chains in fused launches: ffn_proj→decode_act" in out
    assert "served 4 requests" in out and "[slots]" not in out


def test_serve_cli_hand_wired_with_arrivals_and_temperature(capsys):
    out = _serve(["--hand-wired", "--arrival-rate", "0.5", "--temperature",
                  "0.7"], capsys)
    assert "is hand-wired (lm.decode_step)" in out
    assert "[plan-fusion] decode-step bundles" not in out
    slots = out.split("[slots] ")[1].splitlines()[0]
    assert "'prefill_chunks': 0" in slots and "'tokens': 10" in slots


def test_serve_cli_measure_and_refusals(capsys, monkeypatch, tmp_path):
    monkeypatch.setenv("REPRO_TORCH_SCHEDULE_CACHE", str(tmp_path / "s.json"))
    out = _serve(["--measure", "interpret"], capsys)
    assert "served 4 requests" in out and (tmp_path / "s.json").exists()
    for bad in (["--hand-wired", "--measure", "auto"],
                ["--hand-wired", "--kv-block-size", "16"],
                ["--hand-wired", "--plan-fusion"]):
        with pytest.raises(SystemExit):
            _serve(bad, capsys)
    with pytest.raises(SystemExit, match="not executed"):
        _serve(["--hand-wired", "--expect-stitched"], capsys)


def test_engine_cache_len_follows_the_path():
    """The hand-wired paths hold ``max_len`` rows, the executed ones the
    128-aligned length, as in the reference."""
    from repro.serve import engine as jengine
    from repro_torch.serve import engine
    jcfg, tcfg = (dataclasses.replace(c, dtype="float32") for c in (
        jget_config("granite-3-2b").reduced(),
        get_config("granite-3-2b").reduced()))
    for kw in (dict(plan_fusion=False), dict(plan_fusion=True),
               dict(plan_fusion=True, scheduling="wavefront"),
               dict(plan_fusion=False, scheduling="wavefront")):
        je = jengine.ServeEngine(jcfg, None, batch=2, max_len=40, **kw)
        te = engine.ServeEngine(tcfg, None, batch=2, max_len=40,
                                device="cpu", **kw)
        assert (te.cache_len, te.executed, te.chunk_rows) == \
            (je.cache_len, je.executed, je.prefill_budget.effective_chunk(
                je._aligned_len()))
