"""musicgen-medium (the audio stub: four parallel codebooks, tokens (B,
4, S), their summed embeddings plus a sinusoid, a (d, 4 V) head whose
logits are rounded to the model dtype) in the port's model, trainer and
engines against the JAX package, on the CPU.

Two forms: ``reduced()`` (one attention layer, LayerNorm, gelu MLP) and a
two-layer form whose layers stack into one run.  Both packages get the
same weights: numpy trees made from a seed (LayerNorm scales N(1, 0.3) and
biases N(0, 0.1), every weight N(0, 1/fan_in), the codebook tables N(0,
0.5) so that the codes weigh beside the unit sinusoid), handed to JAX as
arrays and to the port through ``lm.params_from_numpy``; the batches are
the port's data pipeline's (B, 4, S) codes.  Each form runs in fp32 and
in bf16.

Tolerances.  ``sinusoidal_embed``: within 2 fp32 steps of the largest
angle (2 x 2^-23 x the largest position) plus 1e-6: the two packages'
``10000 ** -x`` differ by a step on some frequencies (and the reference
jitted from itself), which a position multiplies.  The embedded input:
bitwise (codebook sums in codebook order, each add rounded; the sinusoid
cast to the model dtype at positions below 2048).  fp32: the logits, each
leaf's gradient, the train step's params, m and v, and every cache leaf
within 1e-5 relative L2 of the reference's; the loss to 1e-5 relative
(``ce``, the mean over B S K, equal in fp32 to 1e-6), the grad norm to
1e-5.  bf16: 2e-2 relative L2 of the reference's, or 1.5 times the
reference's own distance from its fp32 twin where that is larger; the loss
to 1e-3 relative.  The head's bf16 logits: at most one bf16 step apart
from the reference's (the same products summed in fp32 in another order,
then rounded).  Prefill + decode against the forward: fp32 1e-4 relative
plus 2e-5 absolute; bf16 2e-2 relative L2.  Greedy codes (B, 4) are equal
step for step; plans, op shapes, notices and launch tables are equal.
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools
import io

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.configs import SHAPES as JSHAPES
from repro.configs import get_config as jget_config
from repro.configs import shape_applicable as jshape_applicable
from repro.models import layers as jlayers
from repro.models import lm as jlm
from repro.serve import engine as jengine
from repro.train import optimizer as jopt
from repro.train import train_loop as jtl
from repro_torch import tree as tree_mod
from repro_torch.configs import ATTN, SHAPES, get_config, shape_applicable
from repro_torch.data.pipeline import DataConfig, TokenPipeline
from repro_torch.models import layers, lm
from repro_torch.serve import engine
from repro_torch.train import optimizer as opt_mod
from repro_torch.train import train_loop as tl

ARCH = "musicgen-medium"
FORMS = ["reduced", "two"]
DTYPES = ["float32", "bfloat16"]
BF16_REL_L2 = 2e-2
BF16_ACCURACY = 1.5
FP32_REL_L2 = 1e-5
SEQ, BATCH, MAX_LEN = 16, 2, 48
K, V = 4, 512                       # reduced(): four codebooks of 512


def _cfgs(form="reduced", dtype="float32"):
    out = []
    for get in (jget_config, get_config):
        c = dataclasses.replace(get(ARCH).reduced(), dtype=dtype)
        if form == "two":
            c = dataclasses.replace(c, num_layers=2, block_pattern=(ATTN,) * 2)
        out.append(c)
    return out


def _numpy_tree(jcfg, seed=0):
    shapes = jax.eval_shape(lambda: jlm.init(jcfg, jax.random.PRNGKey(0)))
    rng = np.random.default_rng(seed)

    def leaf(path, sd):
        name = path[-1].key
        if name == "scale":
            a = 1.0 + rng.normal(size=sd.shape) * 0.3
        elif name == "bias":
            a = rng.normal(size=sd.shape) * 0.1
        else:
            fan_in = sd.shape[-2] if len(sd.shape) >= 2 else sd.shape[-1]
            a = rng.normal(size=sd.shape) * (
                0.5 if name == "embedding" else fan_in ** -0.5)
        dt = (ml_dtypes.bfloat16 if sd.dtype == jnp.bfloat16
              else np.dtype(sd.dtype))
        return a.astype(dt)
    return jax.tree_util.tree_map_with_path(leaf, shapes)


@functools.cache
def _shared(form, dtype):
    jcfg, tcfg = _cfgs(form, dtype)
    tree = _numpy_tree(jcfg)
    return jcfg, jax.tree_util.tree_map(jnp.asarray, tree), tcfg, tree


@functools.cache
def _twin(form):
    """The reference in fp32 over the bf16 weights."""
    jcfg, jp, _tcfg, _tree = _shared(form, "bfloat16")
    return (dataclasses.replace(jcfg, dtype="float32"),
            jax.tree_util.tree_map(lambda a: a.astype(jnp.float32), jp))


def _model(form="reduced", dtype="float32"):
    """(jcfg, jax params, tcfg, port params afresh)."""
    jcfg, jp, tcfg, tree = _shared(form, dtype)
    return jcfg, jp, tcfg, lm.params_from_numpy(tcfg, tree, device="cpu")


def _f32(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.detach().float().numpy()
    return np.asarray(a, np.float32)


def _rel_l2(got, want) -> float:
    got, want = _f32(got), _f32(want)
    return float(np.linalg.norm(got - want)
                 / max(np.linalg.norm(want), 1e-30))


def _close(got, want, dtype, want32=None):
    err = _rel_l2(got, want)
    if dtype == "float32":
        assert err <= FP32_REL_L2, f"rel L2 {err}"
        return
    ref_err = 0.0 if want32 is None else _rel_l2(want, want32)
    assert err <= max(BF16_REL_L2, BF16_ACCURACY * ref_err), \
        f"rel L2 {err}; the reference's bf16 from fp32 {ref_err}"


def _flat(tree):
    return [(tuple(k.key for k in p), a)
            for p, a in jax.tree_util.tree_flatten_with_path(tree)[0]]


def _trees_close(jtree, ttree, dtype, jtree32=None):
    jl = _flat(jtree)
    j32 = [a for _p, a in _flat(jtree32)] if jtree32 is not None \
        else [None] * len(jl)
    tlv = tree_mod.flatten_with_paths(ttree)
    assert [p for p, _ in jl] == [p for p, _ in tlv]
    for (_path, a), a32, (p, b) in zip(jl, j32, tlv):
        try:
            _close(b, a, dtype, a32)
        except AssertionError as e:
            raise AssertionError(f"{'/'.join(p)}: {e}") from None


def _abstract_rows(jcfg, tcfg):
    shapes = jax.eval_shape(lambda: jlm.init(jcfg, jax.random.PRNGKey(0)))
    want = [(tuple(k.key for k in p), tuple(s.shape), str(s.dtype))
            for p, s in jax.tree_util.tree_flatten_with_path(shapes)[0]]
    got = [(p, tuple(t.shape), str(t.dtype).replace("torch.", ""))
           for p, t in tree_mod.flatten_with_paths(lm.abstract_params(tcfg))]
    return got, want


# ---------------------------------------------------------------------------
# the config, the sinusoid and the parameter tree
# ---------------------------------------------------------------------------
def test_config_counts_and_support():
    cfg, jcfg = get_config(ARCH), jget_config(ARCH)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    assert dataclasses.asdict(cfg.reduced()) == \
        dataclasses.asdict(jcfg.reduced())
    assert (cfg.num_layers, cfg.d_model, cfg.num_heads, cfg.num_kv_heads,
            cfg.d_ff, cfg.vocab_size, cfg.num_codebooks) == \
        (48, 1536, 24, 24, 6144, 2048, 4)
    assert (cfg.norm, cfg.activation, cfg.frontend) == \
        ("layernorm", "gelu_mlp", "audio_stub")
    assert lm.count_params(cfg) == jlm.count_params(jcfg) == 1_384_418_304
    assert lm.count_params(cfg.reduced()) == jlm.count_params(jcfg.reduced())
    assert lm.supported(cfg) is None and lm.supported(cfg.reduced()) is None
    for name, shape in SHAPES.items():
        assert shape_applicable(cfg, shape) == jshape_applicable(
            jcfg, JSHAPES[name])
    assert (engine.executable_decode_supported(cfg)
            == jengine.executable_decode_supported(jcfg)
            == "frontend 'audio_stub' (token frontend only)")


@pytest.mark.parametrize("d", [64, 1536, 7])
@pytest.mark.parametrize("kind", ["int", "float"])
def test_sinusoidal_embed_matches_reference(kind, d):
    """int positions (a range and a (3, 5) block) and fp32 ones with
    fractions, in eager and jitted reference form."""
    rng = np.random.default_rng(2)
    if kind == "int":
        cases = [np.arange(4096, dtype=np.int32),
                 rng.integers(0, 4096, (3, 5)).astype(np.int32)]
    else:
        cases = [(rng.random(300) * 4096).astype(np.float32),
                 np.asarray([0.0, 0.5, 1023.25, 4095.0], np.float32)[None]]
    for pos in cases:
        got = layers.sinusoidal_embed(torch.from_numpy(pos), d)
        assert got.dtype == torch.float32
        assert tuple(got.shape) == pos.shape + (2 * (d // 2),)
        limit = 2 * 2.0 ** -23 * float(np.abs(pos).max()) + 1e-6
        for fn in (jlayers.sinusoidal_embed,
                   jax.jit(jlayers.sinusoidal_embed, static_argnums=1)):
            want = np.asarray(fn(jnp.asarray(pos), d))
            assert want.shape == tuple(got.shape)
            np.testing.assert_allclose(got.numpy(), want, rtol=0,
                                       atol=limit)


def test_param_trees_match_reference():
    """Both forms and full width: the (K, V, d) codebook tables and the
    (d, K V) head."""
    for jcfg, tcfg in (_cfgs("reduced"), _cfgs("two"),
                       (jget_config(ARCH), get_config(ARCH))):
        got, want = _abstract_rows(jcfg, tcfg)
        assert got == want
    layout = {path: rest for path, *rest in got}
    assert layout[("embed", "embedding")] == [(4, 2048, 1536), "bfloat16"]
    assert layout[("head", "w")] == [(1536, 4 * 2048), "bfloat16"]
    assert [(r.name, r.count) for r in lm.layer_runs(_cfgs("two")[1])] == \
        [("run00_attn", 2)]


def test_params_from_numpy_keeps_the_weights():
    for form in FORMS:
        for dtype in DTYPES:
            _jcfg, _jp, tcfg, tree = _shared(form, dtype)
            tp = lm.params_from_numpy(tcfg, tree, device="cpu")
            for (path, a), (tpath, b) in zip(
                    _flat(tree), tree_mod.flatten_with_paths(tp)):
                assert path == tpath
                np.testing.assert_array_equal(_f32(b), _f32(a))


# ---------------------------------------------------------------------------
# the model: embedding, head, forward, loss, gradients, one train step
# ---------------------------------------------------------------------------
def _batch(cfg, batch=BATCH, seq=SEQ, step=0):
    nb = TokenPipeline(DataConfig(
        vocab_size=cfg.vocab_size, seq_len=seq, global_batch=batch,
        num_codebooks=cfg.num_codebooks,
        d_model=cfg.d_model)).batch_at(step)
    return ({k: jnp.asarray(v) for k, v in nb.items()},
            {k: torch.from_numpy(v) for k, v in nb.items()})


def _codes(S, B=2, seed=8):
    return np.random.default_rng(seed).integers(0, V, (B, K, S)).astype(
        np.int32)


@pytest.mark.parametrize("dtype", DTYPES)
def test_embed_inputs_and_head_match_reference(dtype):
    """The summed codebook rows plus the sinusoid, and no mask (bf16:
    bitwise; fp32: within 1e-6, the sinusoid's fp32 steps); the head's (B,
    S, K, V) logits rounded to the model dtype (bf16: one bf16 step at
    most from the reference's, fp32 within 1e-6)."""
    jcfg, jp, tcfg, tp = _model("reduced", dtype)
    toks = _codes(300)
    jx, jm = jax.jit(lambda t: jlm._embed_inputs(jcfg, jp, {"tokens": t}))(
        jnp.asarray(toks))
    tx, tm = lm._embed_inputs(tcfg, tp, {"tokens": torch.from_numpy(toks)})
    assert jm is None and tm is None
    assert tx.shape == jx.shape == (2, 300, 64)
    if dtype == "bfloat16":
        np.testing.assert_array_equal(_f32(tx), _f32(jx))
    else:
        np.testing.assert_allclose(_f32(tx), _f32(jx), rtol=0, atol=1e-6)
    x = np.random.default_rng(4).standard_normal((2, 7, 64)).astype(
        np.float32)
    dt = lm.torch_dtype(dtype)
    want = np.asarray(jlm._head(jcfg, jp, jnp.asarray(x).astype(
        jnp.bfloat16 if dtype == "bfloat16" else jnp.float32)))
    got = lm._head(tcfg, tp, torch.from_numpy(x).to(dt))
    assert got.dtype == torch.float32 and tuple(got.shape) == (2, 7, K, V)
    if dtype == "float32":
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)
    else:
        assert torch.equal(got, got.bfloat16().float())   # bf16 values
        step = 2.0 ** -7 * np.maximum(np.abs(want), 2.0 ** -126)
        assert (np.abs(got.numpy() - want) <= step).all()


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("form", FORMS)
def test_forward_loss_and_grads_match_reference(form, dtype):
    """Logits (B, S, K, V), ce over B S K and every gradient (the four
    codebook tables and the head among them)."""
    jcfg, jp, tcfg, tp = _model(form, dtype)
    jb, tb = _batch(tcfg)
    assert tb["tokens"].shape == tb["labels"].shape == (BATCH, K, SEQ)

    def reference(c, p):
        logits = jlm.forward(c, p, jb)[0]
        (loss, met), g = jax.value_and_grad(
            lambda q: jlm.loss_fn(c, q, jb, remat=True), has_aux=True)(p)
        return logits, loss, met["ce"], g
    jlogits, jloss, jce, jg = jax.jit(functools.partial(reference, jcfg))(jp)
    jl32 = jg32 = None
    if dtype == "bfloat16":
        c32, p32 = _twin(form)
        jl32, _l, _c, jg32 = jax.jit(functools.partial(reference, c32))(p32)
    tlogits, _aux, tmask = lm.forward(tcfg, tp, tb)
    assert tmask is None and tuple(tlogits.shape) == (BATCH, SEQ, K, V)
    _close(tlogits, jlogits, dtype, jl32)
    grads = tree_mod.map_tree(torch.zeros_like, tp)
    tloss, met = lm.loss_fn(tcfg, tl._grad_tree(tcfg, tp, grads), tb,
                            remat=True)
    tloss.backward()
    rtol = 1e-5 if dtype == "float32" else 1e-3
    np.testing.assert_allclose(tloss.item(), float(jloss), rtol=rtol)
    np.testing.assert_allclose(float(met["ce"].detach()), float(jce),
                               rtol=1e-6 if dtype == "float32" else 1e-3)
    _trees_close(jg, grads, dtype, jg32)
    assert bool((grads["embed"]["embedding"].reshape(K, -1) != 0)
                .any(dim=1).all())


def _moments(jp):
    rng = np.random.default_rng(1)
    leaves = jax.tree_util.tree_leaves(jp)
    m = [(rng.normal(size=a.shape) * 1e-3).astype(np.float32) for a in leaves]
    v = [(rng.random(size=a.shape) * 1e-5).astype(np.float32) for a in leaves]
    treedef = jax.tree_util.tree_structure(jp)
    return tuple(jax.tree_util.tree_unflatten(treedef, t) for t in (m, v))


OCFG = dict(lr=1e-3, warmup_steps=1, total_steps=10)


@functools.cache
def _reference_step(form, dtype, accum=1, twin=False):
    jcfg, jp, tcfg, _tree = _shared(form, dtype)
    if twin:
        jcfg, jp = _twin(form)
    jb, _tb = _batch(tcfg, batch=2 * accum)
    m, v = (jax.tree_util.tree_map(jnp.asarray, t) for t in _moments(jp))
    jstep = jax.jit(jtl.make_train_step(jcfg, jtl.TrainConfig(
        optimizer=jopt.AdamWConfig(**OCFG), remat=False, grad_accum=accum)))
    return jstep(jp, jopt.OptState(m, v, jnp.asarray(2, jnp.int32)), jb,
                 jnp.asarray(0))


@pytest.mark.parametrize("dtype,route", [("float32", "plain"),
                                         ("float32", "program"),
                                         ("float32", "accum2"),
                                         ("bfloat16", "plain")])
@pytest.mark.parametrize("form", FORMS)
def test_train_step_matches_reference(form, dtype, route):
    """One step on both update routes (the program's AdamW over the 3-D
    codebook leaf) and in two micro-batches of (B, K, S) codes; every
    codebook table and the head move."""
    _jcfg, jp, tcfg, tp = _model(form, dtype)
    accum = 2 if route == "accum2" else 1
    _jb, tb = _batch(tcfg, batch=2 * accum)
    m, v = _moments(jp)
    ocfg = opt_mod.AdamWConfig(**OCFG)
    prog = (tl.build_update_program(lm.abstract_params(tcfg), ocfg)
            if route == "program" else None)
    step = tl.make_train_step(tcfg, tl.TrainConfig(
        optimizer=ocfg, remat=False, grad_accum=accum), update_program=prog)
    emb0 = tp["embed"]["embedding"].clone()
    head0 = tp["head"]["w"].clone()
    new_p, new_s, met = step(tp, opt_mod.opt_state_from_numpy(m, v, 2, tp),
                             tb, 0)
    jp2, js2, jmet = _reference_step(form, dtype, accum)
    rtol = 1e-5 if dtype == "float32" else 1e-3
    np.testing.assert_allclose(float(met["loss"]), float(jmet["loss"]),
                               rtol=rtol)
    np.testing.assert_allclose(float(met["grad_norm"]),
                               float(jmet["grad_norm"]),
                               rtol=FP32_REL_L2 if dtype == "float32"
                               else BF16_REL_L2)
    p32 = m32 = v32 = None
    if dtype == "bfloat16":
        p32, s32, _ = _reference_step(form, dtype, twin=True)
        m32, v32 = s32.m, s32.v
    _trees_close(jp2, new_p, dtype, p32)
    _trees_close(js2.m, new_s.m, dtype, m32)
    _trees_close(js2.v, new_s.v, dtype, v32)
    moved = (new_p["embed"]["embedding"] != emb0).reshape(K, -1).any(dim=1)
    assert bool(moved.all())
    assert not torch.equal(new_p["head"]["w"], head0)
    if route == "program":
        assert new_p is tp


# ---------------------------------------------------------------------------
# the hand-wired serve path
# ---------------------------------------------------------------------------
@functools.cache
def _reference_decode(form, dtype, twin=False):
    jcfg, jp, _tcfg, _tree = _shared(form, dtype)
    if twin:
        jcfg, jp = _twin(form)
    return (jax.jit(lambda b: jlm.prefill(jcfg, jp, b, max_len=40)),
            jax.jit(lambda c, t: jlm.decode_step(jcfg, jp, c, t)))


def _cache_close(tc, jc, dtype, jc32=None):
    assert set(tc) == set(jc)
    assert int(tc["pos"]) == int(jc["pos"])
    for run, leaves in tc.items():
        if run == "pos":
            continue
        assert set(leaves) == set(jc[run])
        for k, t in leaves.items():
            assert t.shape == jc[run][k].shape and \
                t.dtype == lm.torch_dtype(str(jc[run][k].dtype)), (run, k)
            _close(t, jc[run][k], dtype,
                   None if jc32 is None else jc32[run][k])


def _near_ties(got, want_logits, want_codes, steps: int):
    """The (row, codebook) places where ``got`` codes differ from the
    reference's, each required to be a near-tie of the reference's own
    bf16 logits: the port's choice at most ``steps`` bf16 steps (2^-8 of
    the top each) below the reference's top.  Returns their count."""
    lg = _f32(want_logits)
    top = np.take_along_axis(lg, want_codes[..., None], -1)[..., 0]
    mine = np.take_along_axis(lg, got[..., None], -1)[..., 0]
    off = got != want_codes
    assert (top[off] - mine[off]
            <= steps * 2.0 ** -8 * np.abs(top[off])).all(), \
        (top[off], mine[off])
    return int(off.sum())


def _op_by_op(on: bool = True):
    """The reference run op by op (each bf16 op rounded), or compiled."""
    return jax.disable_jit() if on else contextlib.nullcontext()


@pytest.mark.parametrize("dtype,S", [("float32", 1), ("float32", 13),
                                     ("bfloat16", 13)])
@pytest.mark.parametrize("form", FORMS)
def test_prefill_and_decode_step_match_reference(form, dtype, S):
    """The prefill's (B, K, V) logits and cache, then four decode steps of
    (B, K) codes against the compiled reference's.  fp32: each side fed
    its own greedy codes, equal step for step.  bf16: both sides fed the
    reference's codes, the logits and every cache leaf within tolerance,
    and the port's greedy codes equal but at near-ties of the reference's
    logits: compiled, the reference keeps a residual sum in fp32 into the
    LayerNorm that follows it (XLA's excess precision), where the port and
    the reference run op by op round it to bf16 (the codes' equality with
    the reference run op by op: the test after this one)."""
    jcfg = _cfgs(form, dtype)[0]
    toks = _codes(S)
    prefill, decode = _reference_decode(form, dtype)
    jc, jl = prefill({"tokens": jnp.asarray(toks)})
    jc32 = jl32 = None
    if dtype == "bfloat16":
        prefill32, decode32 = _reference_decode(form, dtype, True)
        jc32, jl32 = prefill32({"tokens": jnp.asarray(toks)})
    _jcfg, _jp, tcfg, tp = _model(form, dtype)
    tc, tlog = lm.prefill(tcfg, tp, {"tokens": torch.from_numpy(toks)},
                          max_len=40)
    assert tuple(tlog.shape) == (2, K, V) and int(tc["pos"]) == S
    for _ in range(4):
        _close(tlog, jl, dtype, jl32)
        _cache_close(tc, jc, dtype, jc32)
        jt = np.array(jlm.greedy_sample(jcfg, jl))
        tt = lm.greedy_sample(tcfg, tlog)
        assert tt.shape == (2, K) and tt.dtype == torch.int32
        if dtype == "float32":
            np.testing.assert_array_equal(tt.numpy(), jt)
        else:
            _near_ties(tt.numpy(), jl, jt, 2)
            tt = torch.from_numpy(jt)
        jl, jc = decode(jc, jnp.asarray(jt))
        if jc32 is not None:
            jl32, jc32 = decode32(jc32, jnp.asarray(jt))
        tlog, tc = lm.decode_step(tcfg, tp, tc, tt)
    _close(tlog, jl, dtype, jl32)
    _cache_close(tc, jc, dtype, jc32)


@pytest.mark.parametrize("form", FORMS)
def test_bf16_greedy_codes_match_the_reference_op_by_op(form):
    """bf16: the reference run op by op (``jax.disable_jit``: each bf16
    op rounded, as the port's) and the port over a prefill of 13 and 6
    decode steps, for 4 seeds, both fed the reference's codes: the
    logits mostly bitwise (a product's fp32 sum in another order moves a
    value by a bf16 step now and then), so the (B, 4) codes are equal but
    where one such step breaks an exact tie of the reference's bf16
    logits: the port's choice at most one bf16 step below the
    reference's top, and at most 2 of the 224 codes."""
    jcfg, jp, tcfg, tp = _model(form, "bfloat16")
    flips = 0
    for seed in range(4):
        toks = _codes(13, seed=20 + seed)
        with _op_by_op():
            jc, jl = jlm.prefill(jcfg, jp, {"tokens": jnp.asarray(toks)},
                                 max_len=24)
        tc, tlog = lm.prefill(tcfg, tp, {"tokens": torch.from_numpy(toks)},
                              max_len=24)
        for _ in range(7):
            assert _rel_l2(tlog, jl) <= BF16_REL_L2
            jt = np.array(jlm.greedy_sample(jcfg, jl))
            flips += _near_ties(lm.greedy_sample(tcfg, tlog).numpy(), jl,
                                jt, 1)
            with _op_by_op():
                jl, jc = jlm.decode_step(jcfg, jp, jc, jnp.asarray(jt))
            tlog, tc = lm.decode_step(tcfg, tp, tc, torch.from_numpy(jt))
    assert flips <= 2


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("form", FORMS)
def test_prefill_and_decode_match_forward(form, dtype):
    """prefill(S) and 4 decode steps against the forward of S + 4 at the
    same positions: the (B, K, V) logits."""
    _jcfg, _jp, tcfg, tp = _model(form, dtype)
    S = 12
    toks = torch.from_numpy(_codes(S + 4, seed=9))
    full = lm.forward(tcfg, tp, {"tokens": toks})[0]
    cache, logits = lm.prefill(tcfg, tp, {"tokens": toks[..., :S]},
                               max_len=S + 4)
    got = [logits]
    for i in range(4):
        logits, cache = lm.decode_step(tcfg, tp, cache, toks[..., S + i])
        got.append(logits)
    for i, g in enumerate(got):
        want = full[:, S - 1 + i]
        if dtype == "float32":
            np.testing.assert_allclose(g.numpy(), want.numpy(), rtol=1e-4,
                                       atol=2e-5)
        else:
            assert _rel_l2(g, want) <= BF16_REL_L2, i


@pytest.mark.parametrize("dtype", DTYPES)
def test_greedy_serve_step_matches_reference(dtype):
    """lm.serve_step_greedy: (B, K) codes for 6 steps.  fp32: each side
    fed its own, equal to the compiled reference's step for step.  bf16,
    over the head's rounded logits: against the reference run op by op,
    both fed the reference's codes, equal but at a near-tie (the rule of
    ``test_bf16_greedy_codes_match_the_reference_op_by_op``)."""
    jcfg, jp, tcfg, tp = _model("two", dtype)
    toks = _codes(5, seed=10)
    bf16 = dtype == "bfloat16"
    with _op_by_op(bf16):
        jc, jl = jlm.prefill(jcfg, jp, {"tokens": jnp.asarray(toks)},
                             max_len=16)
    tc, tlog = lm.prefill(tcfg, tp, {"tokens": torch.from_numpy(toks)},
                          max_len=16)
    jt, tt = jlm.greedy_sample(jcfg, jl), lm.greedy_sample(tcfg, tlog)
    step = jax.jit(lambda c, t: jlm.decode_step(jcfg, jp, c, t))
    for _ in range(7):
        if bf16:
            _near_ties(tt.numpy(), jl, np.asarray(jt), 1)
            tt = torch.from_numpy(np.array(jt))
        else:
            np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
        with _op_by_op(bf16):
            jl, jc = step(jc, jt)
        jt = jlm.greedy_sample(jcfg, jl)
        tt, tc = lm.serve_step_greedy(tcfg, tp, tc, tt)
    assert tt.shape == (2, K) and tt.dtype == torch.int32
    assert int(tc["pos"]) == int(jc["pos"]) == 12


# ---------------------------------------------------------------------------
# the engines and the CLIs
# ---------------------------------------------------------------------------
NOTICE = ("[plan-fusion] decode step stays hand-wired: frontend "
          "'audio_stub' (token frontend only)\n")


@pytest.mark.parametrize("scheduling", ["continuous", "wavefront"])
def test_planned_engine_notice_and_plan(scheduling, capsys):
    """The reference's notice, plan and launch tables (the op shapes:
    tests/test_torch_fallback_graph.py)."""
    jcfg, tcfg = _cfgs("two")
    budget = dict(chunk_rows=8, max_coresident_chunks=2)
    je = jengine.ServeEngine(jcfg, None, batch=3, max_len=MAX_LEN,
                             plan_fusion=True, scheduling=scheduling,
                             prefill_budget=jengine.PrefillBudget(**budget))
    want = capsys.readouterr().out
    te = engine.ServeEngine(tcfg, None, batch=3, max_len=MAX_LEN,
                            device="cpu", scheduling=scheduling,
                            prefill_budget=engine.PrefillBudget(**budget))
    assert capsys.readouterr().out == want == NOTICE
    assert not (te.executed or je.executed)
    assert te.fusion_plan.summary() == je.fusion_plan.summary()
    for n in (0, 1, 2):
        assert (te.build_decode_program(prefill_chunks=n).describe()
                == je.build_decode_program(prefill_chunks=n).describe())


def test_planned_engine_refuses_on_the_card(monkeypatch):
    _, tcfg = _cfgs()
    monkeypatch.setattr(engine, "resolve_device",
                        lambda device: torch.device("cuda", 0))
    with pytest.raises(ValueError, match=r"frontend 'audio_stub' \(token "
                       r"frontend only\) — pass plan_fusion=False \(serve "
                       r"CLI: --hand-wired\)"):
        engine.ServeEngine(tcfg, None, batch=2, max_len=MAX_LEN,
                           device="cuda")


@pytest.mark.parametrize("scheduling", ["continuous", "wavefront"])
def test_engine_run_refuses_codebook_prompts(scheduling):
    """The engines take token prompts only: ``run`` raises before any
    step, where the reference's fails deep in its step (ROADMAP §3)."""
    jcfg, jp, tcfg, tp = _model()
    with contextlib.redirect_stdout(io.StringIO()):
        te = engine.ServeEngine(tcfg, tp, batch=2, max_len=MAX_LEN,
                                device="cpu", scheduling=scheduling)
    req = [engine.Request(rid=0, prompt=np.arange(1, 13, dtype=np.int32),
                          max_new_tokens=2)]
    with pytest.raises(NotImplementedError,
                       match=r"the engines take token prompts only; frontend "
                       r"'audio_stub' needs \(B, 4, S\) codebook tokens"):
        te.run(req)
    assert req[0].out_tokens == []
    je = jengine.ServeEngine(jcfg, jp, batch=2, max_len=MAX_LEN,
                             plan_fusion=False, scheduling=scheduling)
    with pytest.raises((TypeError, ValueError)):
        je.run([jengine.Request(rid=0, prompt=np.arange(1, 13,
                                                        dtype=np.int32),
                                max_new_tokens=2)])


def test_serve_cli_refuses():
    from repro_torch.launch import serve
    with pytest.raises(SystemExit, match="the engines take token prompts "
                       "only"):
        serve.main(["--arch", ARCH, "--scale", "smoke", "--device", "cpu",
                    "--hand-wired"])


def test_train_cli_smoke(capsys):
    """--scale smoke on the CPU trains on (B, 4, S) codebook batches (the
    launcher builds its DataConfig as the reference's)."""
    from repro_torch.launch import train
    losses = train.main(["--arch", ARCH, "--scale", "smoke", "--device",
                         "cpu", "--steps", "2", "--batch", "2", "--seq",
                         "16", "--plan-fusion"])
    assert len(losses) == 2 and all(np.isfinite(losses))
    assert "executed update program" in capsys.readouterr().out


# ---------------------------------------------------------------------------
# the update plan and program
# ---------------------------------------------------------------------------
def _plan_rows(plan):
    return [(r["members"], r["schedule"], r["vmem_cap"],
             r["predicted_speedup_pct"], r["measured_speedup_pct"])
            for r in plan.summary()]


def test_full_width_update_plan_matches_reference():
    """At 8192 tokens: the head's bf16 dW->AdamW chain (1536x8192 @
    8192x8192), two fp32 norm1 chains, five AdamW singles, the (4, 2048,
    1536) codebook tables among them as one 98304x128 leaf."""
    jc, tc = jget_config(ARCH), get_config(ARCH)
    ja = jax.eval_shape(lambda: jlm.init(jc, jax.random.PRNGKey(0)))
    ta = lm.abstract_params(tc)
    jgraph, jlayout = jtl.update_graph(ja, tokens=8192)
    tgraph, tlayout = tl.update_graph(ta, tokens=8192)
    assert [(g.op.name, g.deps) for g in tgraph] == \
        [(g.op.name, g.deps) for g in jgraph]
    assert [n for n, *_ in tlayout] == [n for n, *_ in jlayout]
    plan = tl.plan_update_fusion(ta, tokens=8192)
    assert _plan_rows(plan) == _plan_rows(jtl.plan_update_fusion(
        ja, tokens=8192))
    ops = {g.op.name: g.op for g in tl.update_graph(
        ta, tokens=8192, max_tensors=8, include_dW=True)[0]}
    chains = {g.op.name: g.op for g in plan.graph if g.op.chain}
    head = chains.pop("dW_head____w→adamw_head____w")
    dw = ops[head.chain[0]].member
    assert (dw.M, dw.K, dw.N, dw.fp32) == (1536, 8192, 8192, False)
    assert sorted(chains) == [
        f"dW_run00_attn____norm1____{n}→adamw_run00_attn____norm1____{n}"
        for n in ("bias", "scale")]
    assert all(ops[c.chain[0]].member.fp32 for c in chains.values())
    singles = {g.op.name: g.op for g in plan.graph if not g.op.chain}
    assert len(singles) == 5
    assert singles["adamw_embed____embedding"].member.R == \
        4 * 2048 * 1536 // 128


@pytest.mark.parametrize("form", FORMS)
def test_update_program_matches_reference(form):
    jcfg, tcfg = _cfgs(form)
    ja = jax.eval_shape(lambda: jlm.init(jcfg, jax.random.PRNGKey(0)))
    jprog = jtl.build_update_program(ja)
    tprog = tl.build_update_program(lm.abstract_params(tcfg))
    assert tprog.describe() == jprog.describe()
    assert tprog.layout == [(n, tuple(k.key for k in p), *rest)
                            for n, p, *rest in jprog.layout]
