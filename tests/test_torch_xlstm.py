"""The xLSTM blocks (``models/xlstm.py``: the mLSTM, chunked and
sequential, and the sLSTM scan) in the port against the JAX package, on the
CPU.

The blocks get numpy weights made from a seed at the reduced width of
xlstm-1.3b (d_model 64, 4 heads: the mLSTM's f 128, dk 16, dv 32; the
sLSTM's head dim 16 and FFN width 85; biases and norm scales N(0, 0.1)),
handed to JAX as arrays and to the port as tensors; the recurrences get
q, k, v ~ N(0, 1) and gates N(0, 2), N(2, 2) as in
``tests/test_models_xlstm.py``.

Tolerances.  fp32: the recurrences (h and the (C, n, m) state) to 2e-4
relative plus 2e-4 absolute, ``tests/test_models_xlstm.py``'s (the chunked
form divides by |q n|, which leaves a few fp32 steps of its sums), and
against the reference's chunked form (sums of up to 256 terms in another
order) 2e-3 relative plus 2e-3 absolute and h within 1e-4 relative L2; the
blocks' outputs to 1e-5 relative plus 1e-5 absolute (1e-4 and 1e-4 where
the mLSTM runs chunks of 256), their fp32 states to 1e-4 and 1e-4 (C sums
every step's outer product), a decode after S rows against the reference's
block over S + 4 rows to 1e-4 relative plus 2e-5 absolute; one sLSTM
step and its state to 1e-5 relative plus 1e-6 absolute, the head-major loop
against that step taken step by step to 1e-6 and 1e-6.  bf16: the blocks within 2e-2 relative L2 of the reference's,
or 1.5 times the reference's own distance from its fp32 twin (the bf16
weights and input cast up) where that is larger (the rule of
``tests/test_torch_recurrent.py``).  Conv windows are bitwise.

Last, xlstm-1.3b's update program at full width (136 leaves, 93 launches;
~20 s to plan in the reference and ~33 s in the port on the CPU), here
rather than beside the model tests in ``tests/test_torch_xlstm_lm.py`` so
the two files share the workers' time.
"""
from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

pytest.importorskip("hypothesis",
                    reason="property tests need hypothesis (see "
                           "requirements.txt)")
from hypothesis import given, settings, strategies as st

from repro.configs import get_config as jget_config
from repro.models import lm as jlm
from repro.models import xlstm as jxlstm
from repro_torch.configs import get_config
from repro_torch.models import lm, rglru, xlstm

ARCH = "xlstm-1.3b"
DTYPES = ["float32", "bfloat16"]
BF16_REL_L2 = 2e-2
BF16_ACCURACY = 1.5


def _np(dtype):
    return ml_dtypes.bfloat16 if dtype == "bfloat16" else np.float32


def _f32(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.detach().float().numpy()
    return np.asarray(a, np.float32)


def _rel_l2(got, want) -> float:
    got, want = _f32(got), _f32(want)
    return float(np.linalg.norm(got - want)
                 / max(np.linalg.norm(want), 1e-30))


def _close(got, want, dtype, rtol=1e-5, atol=1e-5, want32=None):
    if dtype == "float32":
        np.testing.assert_allclose(_f32(got), _f32(want), rtol=rtol,
                                   atol=atol)
        return
    err = _rel_l2(got, want)
    ref_err = 0.0 if want32 is None else _rel_l2(want, want32)
    assert err <= max(BF16_REL_L2, BF16_ACCURACY * ref_err), \
        f"rel L2 {err}; the reference's bf16 from fp32 {ref_err}"


def _cfgs(dtype="float32"):
    return (dataclasses.replace(jget_config(ARCH).reduced(), dtype=dtype),
            dataclasses.replace(get_config(ARCH).reduced(), dtype=dtype))


@functools.cache
def _block_params(kind, dtype, seed=1):
    """One block's ``rec`` params at the reduced width as numpy arrays."""
    jcfg, _ = _cfgs(dtype)
    shapes = jax.eval_shape(lambda: jlm.init(jcfg, jax.random.PRNGKey(0)))
    run = "run00_mlstm" if kind == "mlstm" else "run01_slstm"
    rng = np.random.default_rng(seed)
    out = {}
    for name, sd in sorted(shapes[run]["rec"].items()):
        if name in ("conv_b", "gate_b", "b_zifo", "out_norm"):
            a = rng.normal(size=sd.shape) * 0.1
        else:
            fan_in = sd.shape[-2] if len(sd.shape) >= 2 else sd.shape[-1]
            a = rng.normal(size=sd.shape) * fan_in ** -0.5
        out[name] = a.astype(ml_dtypes.bfloat16 if sd.dtype == jnp.bfloat16
                             else np.dtype(sd.dtype))
    return out


def _both(p):
    return ({k: jnp.asarray(v) for k, v in p.items()},
            {k: lm._from_numpy(v) for k, v in p.items()})


def _twin(p):
    return {k: jnp.asarray(v).astype(jnp.float32) for k, v in p.items()}


def _qkvg(seed, B, S, H, dk, dv):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(B, S, H, dk)).astype(np.float32),
            rng.normal(size=(B, S, H, dk)).astype(np.float32),
            rng.normal(size=(B, S, H, dv)).astype(np.float32),
            (rng.normal(size=(B, S, H)) * 2.0).astype(np.float32),
            (rng.normal(size=(B, S, H)) * 2.0 + 2.0).astype(np.float32))


def _state(seed, B, H, dk, dv):
    """A state past a few steps: C, n ~ N(0, 1), m ~ N(0, 1)."""
    rng = np.random.default_rng(seed)
    return tuple(rng.normal(size=s).astype(np.float32)
                 for s in ((B, H, dk, dv), (B, H, dk), (B, H)))


def _fresh(B, H, dk, dv):
    return (jxlstm.mlstm_fresh_state(B, H, dk, dv),
            xlstm.mlstm_fresh_state(B, H, dk, dv))


def _check_recurrence(got, want, rtol=2e-4, atol=2e-4):
    (gh, gs), (wh, ws) = got, want
    np.testing.assert_allclose(_f32(gh), _f32(wh), rtol=rtol, atol=atol)
    for a, b in zip(gs, ws):
        np.testing.assert_allclose(_f32(a), _f32(b), rtol=rtol, atol=atol)


# ---------------------------------------------------------------------------
# the mLSTM recurrences
# ---------------------------------------------------------------------------
def test_names_and_dims_match_reference():
    jcfg, tcfg = _cfgs()
    assert xlstm.NEG == jxlstm.NEG == -1e30
    assert xlstm.mlstm_dims(tcfg) == jxlstm.mlstm_dims(jcfg) == \
        (128, 64, 4, 16, 32)
    full = xlstm.mlstm_dims(get_config(ARCH))
    assert full == jxlstm.mlstm_dims(jget_config(ARCH)) == \
        (4096, 2048, 4, 512, 1024)
    for spec, jspec in ((xlstm.mlstm_spec, jxlstm.mlstm_spec),
                        (xlstm.slstm_spec, jxlstm.slstm_spec)):
        for c, jc in ((tcfg, jcfg), (get_config(ARCH), jget_config(ARCH))):
            got = {k: (v[0], v[2] or c.dtype) for k, v in spec(c).items()}
            want = {k: (v.shape, v.dtype or jc.dtype)
                    for k, v in jspec(jc).items()}
            assert got == want
    assert xlstm.slstm_spec(get_config(ARCH))["w_up"][0] == (2048, 5460)
    # the conv is the RG-LRU block's, as the reference reuses its own
    assert xlstm._causal_conv is rglru._causal_conv


@pytest.mark.parametrize("with_state", [False, True], ids=["fresh", "state"])
def test_mlstm_seq_matches_reference(with_state):
    B, S, H, dk, dv = 2, 9, 3, 8, 16
    a = _qkvg(0, B, S, H, dk, dv)
    if with_state:
        s = _state(1, B, H, dk, dv)
        js, ts = tuple(map(jnp.asarray, s)), tuple(map(torch.from_numpy, s))
    else:
        js, ts = _fresh(B, H, dk, dv)
    want = jxlstm.mlstm_seq(*map(jnp.asarray, a), js)
    got = xlstm.mlstm_seq(*map(torch.from_numpy, a), ts)
    _check_recurrence(got, want)


@pytest.mark.parametrize("S,chunk", [(512, 256), (40, 40)],
                         ids=["chunk256", "one_chunk"])
def test_mlstm_chunked_matches_reference(S, chunk):
    """At chunk 256 over 512 steps (two chunks, the state carried) and as
    one chunk of 40."""
    B, H, dk, dv = 2, 3, 8, 16
    a = _qkvg(2, B, S, H, dk, dv)
    js, ts = _fresh(B, H, dk, dv)
    want = jxlstm.mlstm_chunked(*map(jnp.asarray, a), js, chunk=chunk)
    got = xlstm.mlstm_chunked(*map(torch.from_numpy, a), ts, chunk=chunk)
    _check_recurrence(got, want, rtol=2e-3, atol=2e-3)
    assert _rel_l2(got[0], want[0]) < 1e-4


@pytest.mark.parametrize("S,chunk", [(16, 4), (32, 8), (64, 64), (48, 16)])
def test_mlstm_chunked_equals_sequential(S, chunk):
    """``tests/test_models_xlstm.py::test_mlstm_chunked_equals_sequential``
    in the port."""
    B, H, dk, dv = 2, 3, 8, 16
    a = [torch.from_numpy(x) for x in _qkvg(3, B, S, H, dk, dv)]
    _check_recurrence(
        xlstm.mlstm_chunked(*a, xlstm.mlstm_fresh_state(B, H, dk, dv),
                            chunk=chunk),
        xlstm.mlstm_seq(*a, xlstm.mlstm_fresh_state(B, H, dk, dv)))


@settings(max_examples=10, deadline=None)
@given(S=st.integers(2, 24), seed=st.integers(0, 2 ** 30))
def test_mlstm_chunked_property(S, seed):
    """``tests/test_models_xlstm.py::test_mlstm_chunked_property`` in the
    port: any (S, gate) draw, chunked (one chunk of S) == sequential."""
    B, H, dk, dv = 1, 2, 4, 4
    a = [torch.from_numpy(x) for x in _qkvg(seed, B, S, H, dk, dv)]
    h_seq, _ = xlstm.mlstm_seq(*a, xlstm.mlstm_fresh_state(B, H, dk, dv))
    h_chk, _ = xlstm.mlstm_chunked(*a, xlstm.mlstm_fresh_state(B, H, dk, dv),
                                   chunk=S)
    np.testing.assert_allclose(h_chk.numpy(), h_seq.numpy(), rtol=5e-4,
                               atol=5e-4)


def test_mlstm_state_carry_across_calls():
    """``tests/test_models_xlstm.py::test_mlstm_state_carry_across_calls``
    in the port: a sequence split across two chunked calls == one call."""
    B, H, dk, dv, S = 1, 2, 4, 8, 32
    a = [torch.from_numpy(x) for x in _qkvg(4, B, S, H, dk, dv)]
    st0 = xlstm.mlstm_fresh_state(B, H, dk, dv)
    h_all, _ = xlstm.mlstm_chunked(*a, st0, chunk=8)
    h1, st1 = xlstm.mlstm_chunked(*(t[:, :16] for t in a), st0, chunk=8)
    h2, _ = xlstm.mlstm_chunked(*(t[:, 16:] for t in a), st1, chunk=8)
    np.testing.assert_allclose(torch.cat([h1, h2], 1).numpy(),
                               h_all.numpy(), rtol=2e-4, atol=2e-4)


def test_chunk_gradients_are_finite_where_the_reference_overflows():
    """At chunk 256 the exponent above the diagonal reaches hundreds: the
    reference masks exp of it afterwards, so exp overflows there and the
    gates' gradients are NaN (0 x inf); the port exponentiates the masked
    exponent.  Its gradients are finite and equal the sequential form's
    (autograd through ``mlstm_seq``), and where the reference's are finite
    (q, k, v) they are the reference's."""
    B, S, H, dk, dv = 1, 512, 2, 8, 8
    a = list(_qkvg(5, B, S, H, dk, dv))
    a[4] = np.random.default_rng(6).normal(size=(B, S, H)).astype(np.float32)
    dh = np.random.default_rng(7).normal(size=(B, S, H, dv)).astype(
        np.float32)

    def ref_loss(*xs):
        h, _ = jxlstm.mlstm_chunked(*xs, jxlstm.mlstm_fresh_state(
            B, H, dk, dv), chunk=256)
        return jnp.sum(h * dh)
    jg = jax.grad(ref_loss, argnums=tuple(range(5)))(*map(jnp.asarray, a))
    assert all(np.isfinite(np.asarray(g)).all() for g in jg[:3])
    assert not all(np.isfinite(np.asarray(g)).all() for g in jg[3:])

    def port_grads(fn, **kw):
        xs = [torch.from_numpy(x).requires_grad_() for x in a]
        h, _ = fn(*xs, xlstm.mlstm_fresh_state(B, H, dk, dv), **kw)
        (h * torch.from_numpy(dh)).sum().backward()
        return [x.grad for x in xs]
    chunked = port_grads(xlstm.mlstm_chunked, chunk=256)
    seq = port_grads(xlstm.mlstm_seq)
    for c, s in zip(chunked, seq):
        assert bool(torch.isfinite(c).all())
        assert _rel_l2(c, s) < 1e-4
    for c, j in zip(chunked[:3], jg[:3]):
        assert _rel_l2(c, j) < 1e-4


# ---------------------------------------------------------------------------
# the mLSTM block
# ---------------------------------------------------------------------------
def _x(seed, B, S, dtype, d=64):
    return np.random.default_rng(seed).normal(size=(B, S, d)).astype(
        _np(dtype))


@pytest.mark.parametrize("S", [1, 2, 3, 11, 256])
@pytest.mark.parametrize("dtype", DTYPES)
def test_mlstm_apply_train_matches_reference(dtype, S):
    """The whole block over a sequence (S 256: chunks of 256; else one
    chunk of S) and its handoff: the state, and the conv tail, always K - 1
    = 3 rows: at S >= 3 the reference's, below its S rows left-padded with
    zeros."""
    jcfg, tcfg = _cfgs(dtype)
    p = _block_params("mlstm", dtype)
    jp, tp = _both(p)
    x = _x(8, 2, S, dtype)
    def run(c, q, xx):
        return jax.jit(lambda q, xx: jxlstm.mlstm_apply_train(c, q, xx))(q, xx)
    jy, (jst, jtail) = run(jcfg, jp, jnp.asarray(x))
    jy32 = None
    if dtype == "bfloat16":
        jy32 = run(dataclasses.replace(jcfg, dtype="float32"), _twin(p),
                   jnp.asarray(x).astype(jnp.float32))[0]
    ty, (tst, ttail) = xlstm.mlstm_apply_train(tcfg, tp, lm._from_numpy(x))
    assert ty.dtype == lm.torch_dtype(dtype)
    tol = 1e-4 if S >= 256 else 1e-5
    _close(ty, jy, dtype, tol, tol, want32=jy32)
    for a, b in zip(tst, jst):
        assert a.dtype == torch.float32
        _close(a, b, dtype, 1e-4, 1e-4)
    assert ttail.shape == (2, 3, 128) and jtail.shape == (2, min(S, 3), 128)
    np.testing.assert_array_equal(_f32(ttail[:, 3 - min(S, 3):]),
                                  _f32(jtail))
    assert not ttail[:, :3 - min(S, 3)].any()


def test_the_two_chunk_forms_agree():
    """S 512 runs in chunks of 256 and S 500 in one chunk (the reference's
    rule); the chunked form of 512 equals its one-chunk form."""
    _, tcfg = _cfgs()
    _, tp = _both(_block_params("mlstm", "float32"))
    x = lm._from_numpy(_x(9, 1, 512, "float32"))
    y256, st256 = xlstm.mlstm_apply_train(tcfg, tp, x)
    q, k, v, i_pre, f_pre, _z, _t = xlstm._mlstm_qkvg(tcfg, tp, x)
    h1, st1 = xlstm.mlstm_chunked(q, k, v, i_pre, f_pre,
                                  xlstm.mlstm_fresh_state(1, 4, 16, 32),
                                  chunk=512)
    h256, _ = xlstm.mlstm_chunked(q, k, v, i_pre, f_pre,
                                  xlstm.mlstm_fresh_state(1, 4, 16, 32))
    assert _rel_l2(h256, h1) < 1e-5
    for a, b in zip(st256[0], st1):
        assert _rel_l2(a, b) < 1e-5


@pytest.mark.parametrize("dtype", DTYPES)
def test_mlstm_apply_decode_matches_reference(dtype):
    """One decode step from a state and conv window: output, state and the
    shifted window."""
    jcfg, tcfg = _cfgs(dtype)
    jp, tp = _both(_block_params("mlstm", dtype))
    x = _x(10, 3, 1, dtype)
    s = _state(11, 3, 4, 16, 32)
    buf = np.random.default_rng(12).normal(size=(3, 3, 128)).astype(
        _np(dtype))
    want = jax.jit(lambda *a: jxlstm.mlstm_apply_decode(jcfg, *a))(
        jp, jnp.asarray(x), tuple(map(jnp.asarray, s)), jnp.asarray(buf))
    got = xlstm.mlstm_apply_decode(tcfg, tp, lm._from_numpy(x),
                                   tuple(map(torch.from_numpy, s)),
                                   lm._from_numpy(buf))
    _close(got[0], want[0], dtype)
    for a, b in zip(got[1], want[1]):
        _close(a, b, dtype, 1e-4, 1e-4)
    np.testing.assert_array_equal(_f32(got[2]), _f32(want[2]))
    assert torch.equal(got[2][:, :2], lm._from_numpy(buf[:, 1:]))


@pytest.mark.parametrize("kind", ["mlstm", "slstm"])
@pytest.mark.parametrize("S", [1, 2, 3, 11])
def test_block_decode_after_a_prompt_matches_the_longer_sequence(kind, S):
    """apply_train over S rows, then 4 decode steps from its handoff,
    against the reference's apply_train over all S + 4 rows (the repaired
    conv tail at S 1 and 2, where the reference's own decode raises)."""
    jcfg, tcfg = _cfgs()
    jp, tp = _both(_block_params(kind, "float32"))
    x = _x(13, 2, S + 4, "float32")
    jtrain = jxlstm.mlstm_apply_train if kind == "mlstm" \
        else jxlstm.slstm_apply_train
    ttrain, tdecode = ((xlstm.mlstm_apply_train, xlstm.mlstm_apply_decode)
                       if kind == "mlstm" else
                       (xlstm.slstm_apply_train, xlstm.slstm_apply_decode))
    want = np.asarray(jtrain(jcfg, jp, jnp.asarray(x))[0])
    tx = torch.from_numpy(x)
    y, (state, buf) = ttrain(tcfg, tp, tx[:, :S])
    outs = [y]
    for t in range(S, S + 4):
        y, state, buf = tdecode(tcfg, tp, tx[:, t:t + 1], state, buf)
        outs.append(y)
    np.testing.assert_allclose(torch.cat(outs, 1).numpy(), want, rtol=1e-4,
                               atol=2e-5)
    if S < 3:
        with pytest.raises(Exception):
            jdecode = jxlstm.mlstm_apply_decode if kind == "mlstm" \
                else jxlstm.slstm_apply_decode
            jy, (jst, jtail) = jtrain(jcfg, jp, jnp.asarray(x[:, :S]))
            jdecode(jcfg, jp, jnp.asarray(x[:, S:S + 1]), jst, jtail)


# ---------------------------------------------------------------------------
# the sLSTM
# ---------------------------------------------------------------------------
def test_slstm_cell_matches_reference():
    """One step from a state past a few steps."""
    jp, tp = _both(_block_params("slstm", "float32"))
    rng = np.random.default_rng(14)
    wx = rng.normal(size=(3, 256)).astype(np.float32)
    s = (rng.normal(size=(3, 64)), np.abs(rng.normal(size=(3, 64))) + 0.5,
         rng.normal(size=(3, 64)), rng.normal(size=(3, 64)))
    s = tuple(a.astype(np.float32) for a in s)
    want = jxlstm._slstm_cell(jp, jnp.asarray(wx), tuple(map(jnp.asarray, s)))
    got = xlstm._slstm_cell(tp, torch.from_numpy(wx),
                            tuple(map(torch.from_numpy, s)))
    for a, b in zip(got[0], want[0]):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5,
                                   atol=1e-6)
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]),
                               rtol=1e-5, atol=1e-6)


def test_slstm_scan_equals_cell_steps():
    """The head-major loop equals ``_slstm_cell`` step by step from a
    fresh state."""
    _, tp = _both(_block_params("slstm", "float32"))
    wx = torch.from_numpy(np.random.default_rng(15).normal(
        size=(2, 9, 256)).astype(np.float32))
    r = tp["r_zifo"].float()
    h, state = xlstm._slstm_scan(r, wx, xlstm.slstm_fresh_state(2, 64))
    s = xlstm.slstm_fresh_state(2, 64)
    for t in range(9):
        s, ht = xlstm._slstm_cell(tp, wx[:, t], s)
        np.testing.assert_allclose(h[:, t].numpy(), ht.numpy(), rtol=1e-6,
                                   atol=1e-6)
    for a, b in zip(state, s):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-6,
                                   atol=1e-6)


@pytest.mark.parametrize("S", [1, 2, 3, 11, 40])
@pytest.mark.parametrize("dtype", DTYPES)
def test_slstm_apply_train_matches_reference(dtype, S):
    """The block over a sequence and its handoff (the conv tail as the
    mLSTM's)."""
    jcfg, tcfg = _cfgs(dtype)
    p = _block_params("slstm", dtype)
    jp, tp = _both(p)
    x = _x(16, 2, S, dtype)
    def run(c, q, xx):
        return jax.jit(lambda q, xx: jxlstm.slstm_apply_train(c, q, xx))(q, xx)
    jy, (jst, jtail) = run(jcfg, jp, jnp.asarray(x))
    jy32 = None
    if dtype == "bfloat16":
        jy32 = run(dataclasses.replace(jcfg, dtype="float32"), _twin(p),
                   jnp.asarray(x).astype(jnp.float32))[0]
    ty, (tst, ttail) = xlstm.slstm_apply_train(tcfg, tp, lm._from_numpy(x))
    _close(ty, jy, dtype, want32=jy32)
    for a, b in zip(tst, jst):
        _close(a, b, dtype, 1e-4, 1e-4)
    assert ttail.shape == (2, 3, 64)
    np.testing.assert_array_equal(_f32(ttail[:, 3 - min(S, 3):]),
                                  _f32(jtail))


@pytest.mark.parametrize("dtype", DTYPES)
def test_slstm_apply_decode_matches_reference(dtype):
    jcfg, tcfg = _cfgs(dtype)
    jp, tp = _both(_block_params("slstm", dtype))
    rng = np.random.default_rng(17)
    x = _x(18, 3, 1, dtype)
    s = tuple(a.astype(np.float32) for a in (
        rng.normal(size=(3, 64)), np.abs(rng.normal(size=(3, 64))) + 0.5,
        rng.normal(size=(3, 64)), rng.normal(size=(3, 64))))
    buf = rng.normal(size=(3, 3, 64)).astype(_np(dtype))
    want = jax.jit(lambda *a: jxlstm.slstm_apply_decode(jcfg, *a))(
        jp, jnp.asarray(x), tuple(map(jnp.asarray, s)), jnp.asarray(buf))
    got = xlstm.slstm_apply_decode(tcfg, tp, lm._from_numpy(x),
                                   tuple(map(torch.from_numpy, s)),
                                   lm._from_numpy(buf))
    _close(got[0], want[0], dtype)
    for a, b in zip(got[1], want[1]):
        _close(a, b, dtype, 1e-5, 1e-6)
    np.testing.assert_array_equal(_f32(got[2]), _f32(want[2]))


def test_fresh_states_match_reference():
    for got, want in ((xlstm.mlstm_fresh_state(2, 3, 4, 5),
                       jxlstm.mlstm_fresh_state(2, 3, 4, 5)),
                      (xlstm.slstm_fresh_state(2, 6),
                       jxlstm.slstm_fresh_state(2, 6))):
        for a, b in zip(got, want):
            assert a.dtype == torch.float32
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_silu_is_the_reference_op_for_op():
    """``_silu`` in bf16 is ``jax.nn.silu``'s value bitwise (``F.silu``
    differs by a bf16 step on about a third of these)."""
    x = np.linspace(-8, 8, 4001).astype(ml_dtypes.bfloat16)
    got = xlstm._silu(lm._from_numpy(x))
    want = np.asarray(jax.nn.silu(jnp.asarray(x)), np.float32)
    np.testing.assert_array_equal(_f32(got), want)
    fused = _f32(torch.nn.functional.silu(lm._from_numpy(x)))
    assert (fused != want).mean() > 0.1


def test_slstm_scan_backward_matches_autograd():
    """``_SLSTMScan``'s written-out backward: ``gradcheck`` in fp64 from a
    state past a few steps (every input's gradient, the last state's
    too), and against autograd through the plain loop from a fresh state
    to 1e-12 (fp64)."""
    gen = torch.Generator()
    gen.manual_seed(0)
    H, B, dh, S = 2, 3, 4, 7

    def randn(*shape, scale=1.0):
        return (torch.randn(shape, generator=gen, dtype=torch.float64)
                * scale).requires_grad_()
    rk, xs = randn(H, dh, 4 * dh, scale=0.5), randn(S, H, B, 4 * dh)
    state = (randn(H, B, dh), (torch.rand((H, B, dh), generator=gen,
                                          dtype=torch.float64) + 0.5
                               ).requires_grad_(),
             randn(H, B, dh), randn(H, B, dh))
    assert torch.autograd.gradcheck(xlstm._SLSTMScan.apply,
                                    (rk, xs, *state))
    fresh = tuple(torch.full((H, B, dh), v, dtype=torch.float64)
                  for v in (0.0, 0.0, xlstm.NEG, 0.0))
    dhs = torch.randn((S, H, B, dh), generator=gen, dtype=torch.float64)
    got = torch.autograd.grad(
        xlstm._SLSTMScan.apply(rk, xs, *fresh)[0], (rk, xs), dhs)
    hs, _last, _kept = xlstm._scan_steps(rk, xs, fresh)
    want = torch.autograd.grad(torch.stack(hs), (rk, xs), dhs)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=1e-12,
                                   atol=1e-12)


def test_full_width_update_program_matches_reference():
    """The executed update program over all 136 leaves at full width is the
    reference's, launch for launch, its layout leaf for leaf."""
    from repro.train import train_loop as jtl
    from repro_torch.train import train_loop as tl
    jcfg = jget_config(ARCH)
    ja = jax.eval_shape(lambda: jlm.init(jcfg, jax.random.PRNGKey(0)))
    ta = lm.abstract_params(get_config(ARCH))
    jprog, tprog = jtl.build_update_program(ja), tl.build_update_program(ta)
    assert tprog.describe() == jprog.describe()
    assert len(tprog.describe()) == 93 and len(tprog.layout) == 136
    assert tprog.layout == [(n, tuple(k.key for k in p), *rest)
                            for n, p, *rest in jprog.layout]
