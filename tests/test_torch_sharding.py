"""The port's ``distributed/sharding.py`` against the reference's, on the CPU.

  * The shard-major permutations and the per-leaf PartitionSpec rules of
    tensor-parallel serve (the cases of ``tests/test_serve_sharded.py``),
    equal to the reference's as tuples.
  * ``resolve_pspec`` and ``rules_for`` on the cases of
    ``tests/test_sharding.py`` (a non-divisible dim replicates, no mesh axis
    is assigned twice, under hypothesis; the pod remap), and ``rules_for``
    on all 11 configs x {"", "train", "prefill", "decode"}, on and off a
    pod mesh.  The meshes are ``SimpleNamespace(shape=..., axis_names=...)``
    objects, which both packages read; the port also reads a
    ``DeviceMesh``'s ``mesh_dim_names`` and tuple ``shape``.
  * ``tp_shard_params``: every rank's slab bitwise equal to the reference's
    permute-then-split (``tp_permute_*`` then an even split on the last
    axis, ``w_o``/``w_out`` on axis -2), gated and not, one layer and a
    stacked two; the other leaves the caller's own tensors.
"""
from __future__ import annotations

import dataclasses
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from repro.configs import get_config as jget_config, list_archs as jlist
from repro.distributed import sharding as jshd
from repro_torch.configs import get_config, list_archs
from repro_torch.distributed import sharding as shd
from repro_torch.models import lm


def _mesh(**shape):
    return SimpleNamespace(shape=dict(shape), axis_names=tuple(shape))


# ---------------------------------------------------------------------------
# permutations and the per-leaf rules
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("H,Hkv,D,n", [(8, 4, 4, 4), (32, 8, 64, 2),
                                       (32, 8, 64, 4), (4, 4, 16, 1)])
def test_qkv_permutation_is_the_references(H, Hkv, D, n):
    perm = shd.tp_qkv_permutation(H, Hkv, D, n)
    assert perm.tolist() == jshd.tp_qkv_permutation(H, Hkv, D, n).tolist()
    assert sorted(perm.tolist()) == list(range((H + 2 * Hkv) * D))
    slabs = np.take(np.arange((H + 2 * Hkv) * D), perm.numpy()).reshape(n, -1)
    Hl, Hkvl = H // n, Hkv // n
    for s in range(n):
        q, k, v = np.split(slabs[s], [Hl * D, (Hl + Hkvl) * D])
        assert list(q) == list(range(s * Hl * D, (s + 1) * Hl * D))
        assert list(k) == list(range(H * D + s * Hkvl * D,
                                     H * D + (s + 1) * Hkvl * D))
        assert list(v) == list(range((H + Hkv) * D + s * Hkvl * D,
                                     (H + Hkv) * D + (s + 1) * Hkvl * D))


@pytest.mark.parametrize("F,n", [(12, 3), (8192, 4), (128, 2)])
def test_gated_ffn_permutation_is_the_references(F, n):
    perm = shd.tp_gated_ffn_permutation(F, n)
    assert perm.tolist() == jshd.tp_gated_ffn_permutation(F, n).tolist()
    slabs = np.take(np.arange(2 * F), perm.numpy()).reshape(n, -1)
    Fl = F // n
    for s in range(n):
        gate, up = np.split(slabs[s], 2)
        assert list(gate) == list(range(s * Fl, (s + 1) * Fl))
        assert list(up) == list(range(F + s * Fl, F + (s + 1) * Fl))


def test_permutations_refuse_what_the_axis_does_not_divide():
    for port, ref in ((lambda: shd.tp_qkv_permutation(6, 3, 4, 4),
                       lambda: jshd.tp_qkv_permutation(6, 3, 4, 4)),
                      (lambda: shd.tp_gated_ffn_permutation(10, 4),
                       lambda: jshd.tp_gated_ffn_permutation(10, 4))):
        with pytest.raises(ValueError) as a:
            port()
        with pytest.raises(ValueError) as b:
            ref()
        assert str(a.value) == str(b.value)


@pytest.mark.parametrize("shape", [(2, 24), (3, 2, 24)])
def test_permute_helpers_match_the_reference(shape):
    """``tp_permute_qkv`` / ``tp_permute_gated_ffn`` on the last axis of a
    2-D and a layer-stacked 3-D leaf, bitwise."""
    w = np.random.default_rng(0).normal(size=shape).astype(np.float32)
    got = shd.tp_permute_qkv(torch.from_numpy(w), 2, 2, 4, 2)
    want = jshd.tp_permute_qkv(jnp.asarray(w), 2, 2, 4, 2)
    assert np.array_equal(got.numpy(), np.asarray(want))
    got = shd.tp_permute_gated_ffn(torch.from_numpy(w), 12, 3)
    want = jshd.tp_permute_gated_ffn(jnp.asarray(w), 12, 3)
    assert np.array_equal(got.numpy(), np.asarray(want))


# every leaf name the serve trees hold, at every rank a leaf can have (a
# row-split leaf has at least two dims)
PSPEC_CASES = [(name, ndim)
               for name in ("w_qkv", "w_in", "w_o", "w_out", "scale",
                            "embedding", "head", "k", "v", "pos", "bt")
               for ndim in range(1, 6)
               if ndim >= 2 or name not in ("w_o", "w_out", "k", "v")]


@pytest.mark.parametrize("name,ndim", PSPEC_CASES)
def test_tp_pspec_rules_are_the_references(name, ndim):
    for port, ref in ((shd.tp_param_pspec, jshd.tp_param_pspec),
                      (shd.tp_cache_pspec, jshd.tp_cache_pspec)):
        got, want = port(name, ndim, "model"), ref(name, ndim, "model")
        assert isinstance(got, shd.PartitionSpec)
        assert tuple(got) == tuple(want)


def test_tp_pspec_cases_of_the_reference_test():
    P = shd.PartitionSpec
    assert shd.tp_param_pspec("w_qkv", 2, "model") == P(None, "model")
    assert shd.tp_param_pspec("w_qkv", 3, "model") == P(None, None, "model")
    assert shd.tp_param_pspec("w_o", 2, "model") == P("model", None)
    assert shd.tp_param_pspec("w_out", 3, "model") == P(None, "model", None)
    assert shd.tp_param_pspec("scale", 1, "model") == P()
    assert shd.tp_cache_pspec("k", 4, "model") == P(None, None, "model",
                                                    None)
    assert shd.tp_cache_pspec("v", 5, "model") == P(None, None, None,
                                                    "model", None)
    assert shd.tp_cache_pspec("pos", 1, "model") == P()
    assert repr(P(None, "model")) == "PartitionSpec(None, 'model')"


# ---------------------------------------------------------------------------
# resolution and rules
# ---------------------------------------------------------------------------
def test_resolve_drops_nondivisible():
    mesh = _mesh(data=4, model=8)
    rules = {"batch": "data", "ffn": "model"}
    spec = shd.resolve_pspec(("batch", "ffn"), (6, 64), mesh, rules)
    assert spec[0] is None          # 6 % 4 != 0 -> replicated
    assert spec[1] == "model"       # 64 % 8 == 0
    assert tuple(spec) == tuple(jshd.resolve_pspec(("batch", "ffn"),
                                                   (6, 64), mesh, rules))


@settings(max_examples=40, deadline=None)
@given(b=st.integers(1, 64), f=st.integers(1, 128),
       data=st.sampled_from([2, 4, 8]), model=st.sampled_from([2, 8, 16]),
       pod=st.sampled_from([0, 2]))
def test_resolve_never_overassigns(b, f, data, model, pod):
    mesh = (_mesh(pod=pod, data=data, model=model) if pod
            else _mesh(data=data, model=model))
    rules = {"batch": ("pod", "data") if pod else "data", "ffn": "model",
             "act_ffn": "model", "embed": ("data", "model")}
    logical = ("batch", "ffn", "act_ffn", "embed")
    spec = shd.resolve_pspec(logical, (b, f, f, b), mesh, rules)
    assert tuple(spec) == tuple(jshd.resolve_pspec(logical, (b, f, f, b),
                                                   mesh, rules))
    flat = []
    for s in spec:
        if s is not None:
            flat.extend(s if isinstance(s, tuple) else [s])
    assert len(flat) == len(set(flat))            # no axis used twice
    for s, dim in zip(spec, (b, f, f, b)):
        axes = () if s is None else (s if isinstance(s, tuple) else (s,))
        assert dim % int(np.prod([mesh.shape[a] for a in axes])) == 0


def test_device_mesh_form_resolves_alike():
    """A ``DeviceMesh`` names its dims in ``mesh_dim_names`` beside a tuple
    ``shape``: the port reads it as the name -> extent mapping."""
    dm = SimpleNamespace(mesh_dim_names=("data", "model"), shape=(4, 8))
    assert shd.mesh_shape(dm) == {"data": 4, "model": 8}
    rules = {"batch": "data", "ffn": "model"}
    assert shd.resolve_pspec(("batch", "ffn"), (8, 64), dm, rules) == \
        shd.resolve_pspec(("batch", "ffn"), (8, 64), _mesh(data=4, model=8),
                          rules)
    assert shd.rules_for(get_config("granite-3-2b"), dm) == \
        shd.rules_for(get_config("granite-3-2b"), _mesh(data=4, model=8))


def test_pod_rules_remap():
    mesh = _mesh(pod=2, data=2, model=2)
    rules = shd.rules_for(get_config("granite-3-2b"), mesh)
    assert rules["batch"] == ("pod", "data")
    rules_ds = shd.rules_for(get_config("deepseek-v2-236b"), mesh)
    assert rules_ds["expert"] == ("pod", "data")  # moe-huge FSDP experts


@pytest.mark.parametrize("arch", list_archs())
def test_rules_for_every_config_and_kind(arch):
    assert list_archs() == jlist()
    for mesh in (_mesh(data=16, model=16), _mesh(pod=2, data=16, model=16)):
        for kind in ("", "train", "prefill", "decode"):
            assert shd.rules_for(get_config(arch), mesh, kind) == \
                jshd.rules_for(jget_config(arch), mesh, kind), (arch, kind)
    assert shd.BASE_RULES == jshd.BASE_RULES
    assert shd.FAMILY_OVERRIDES == jshd.FAMILY_OVERRIDES


def test_ambient_mesh_and_data_shards():
    mesh = _mesh(pod=2, data=4, model=2)
    rules = shd.rules_for(get_config("granite-3-2b"), mesh)
    assert shd.current_mesh() is None and shd.data_shards() == 1
    with shd.use_sharding(mesh, rules), jshd.use_sharding(mesh, rules):
        assert shd.current_mesh() is mesh
        assert shd.data_shards() == jshd.data_shards() == 8
    assert shd.current_mesh() is None


# ---------------------------------------------------------------------------
# a rank's slab
# ---------------------------------------------------------------------------
def _cfg(layers: int, activation: str):
    cfg = dataclasses.replace(get_config("granite-3-2b").reduced(),
                              dtype="float32", activation=activation)
    if layers > 1:
        cfg = dataclasses.replace(cfg, num_layers=layers,
                                  block_pattern=("attn",) * layers)
    return cfg


def _split(w, n, rank, axis):
    return np.split(np.asarray(w), n, axis=axis)[rank]


@pytest.mark.parametrize("activation", ["silu", "gelu_mlp"])
@pytest.mark.parametrize("layers", [1, 2])
@pytest.mark.parametrize("n", [1, 2, 4])
def test_shard_params_is_permute_then_split(activation, layers, n):
    cfg = _cfg(layers, activation)
    gen = torch.Generator()
    gen.manual_seed(3)
    params = lm.init(cfg, gen, device="cpu")
    H, Hkv, D, F = (cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim,
                    cfg.d_ff)
    blk = params[lm.layer_runs(cfg)[0].name]
    qkv = jshd.tp_permute_qkv(jnp.asarray(blk["attn"]["w_qkv"].numpy()),
                              H, Hkv, D, n)
    w_in = jnp.asarray(blk["mlp"]["w_in"].numpy())
    if activation == "silu":
        w_in = jshd.tp_permute_gated_ffn(w_in, F, n)
    for rank in range(n):
        got = shd.tp_shard_params(params, rank, n, cfg=cfg)
        gblk = got[lm.layer_runs(cfg)[0].name]
        want = {"w_qkv": _split(qkv, n, rank, -1),
                "w_in": _split(w_in, n, rank, -1),
                "w_o": _split(blk["attn"]["w_o"].numpy(), n, rank, -2),
                "w_out": _split(blk["mlp"]["w_out"].numpy(), n, rank, -2)}
        for name, part in (("w_qkv", "attn"), ("w_o", "attn"),
                           ("w_in", "mlp"), ("w_out", "mlp")):
            t = gblk[part][name]
            assert t.is_contiguous()
            assert np.array_equal(t.numpy(), want[name]), (name, rank)
            if n > 1:   # a slab of its own, not a view of the full leaf
                assert t.untyped_storage().data_ptr() != \
                    blk[part][name].untyped_storage().data_ptr()
        assert got["embed"]["embedding"] is params["embed"]["embedding"]
        assert gblk["norm1"]["scale"] is blk["norm1"]["scale"]
    with pytest.raises(ValueError):
        shd.tp_shard_params(params, n, n, cfg=cfg)
