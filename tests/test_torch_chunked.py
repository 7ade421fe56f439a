"""The port's PrefillBudget and ServeEngine(reject_overlong=) against the
JAX package's, on the CPU.

Mirrors ``tests/test_serve_chunked_prefill.py`` (``test_budget_validates``,
``test_budget_pad_rows``, ``test_reject_overlong_restores_legacy_contract``)
with both packages side by side: the same fields by position and by name,
the same refusals, the same padded row counts, and on reduced granite-3-2b
(fp32, the ``_numpy_params`` weights of ``tests/test_torch_serve.py``) the
same tokens for a one-chunk prompt and the same ``ValueError`` for a prompt
longer than one chunk.  Also the launcher's ``--reject-overlong`` flag.
"""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.configs import get_config as jget_config
from repro.serve import engine as jengine
from repro_torch.configs import get_config
from repro_torch.launch import serve as tserve
from repro_torch.models import lm
from repro_torch.serve import engine

from test_torch_serve import _numpy_params

BUDGET = dict(chunk_rows=8, max_coresident_chunks=2)


def _fields(b):
    return dataclasses.astuple(b)


@pytest.mark.parametrize("args", [(512, 2, 64), (512, 2), (16, 1, 1, "srpf"),
                                  (8, 3, 128, "eload", 2.0)])
def test_budget_positional_fields_match_reference(args):
    """The third positional field is ``pad_to`` in both packages."""
    got, want = engine.PrefillBudget(*args), jengine.PrefillBudget(*args)
    assert _fields(got) == _fields(want)
    assert [f.name for f in dataclasses.fields(got)] == \
        [f.name for f in dataclasses.fields(want)]
    if len(args) > 2:
        assert got.pad_to == args[2]


def test_budget_validates_like_reference():
    for bad in (dict(chunk_rows=0), dict(max_coresident_chunks=0),
                dict(pad_to=-1), dict(pad_to=0)):
        for mod in (engine, jengine):
            with pytest.raises(ValueError, match="must be >= 1"):
                mod.PrefillBudget(**bad)
    for mod in (engine, jengine):
        with pytest.raises(ValueError, match="policy"):
            mod.PrefillBudget(policy="lifo")
        # a policy string in pad_to's place is refused in both
        with pytest.raises(TypeError):
            mod.PrefillBudget(512, 2, "srpf")
    assert engine.PrefillBudget(pad_to=64).pad_to == 64


@pytest.mark.parametrize("pad_to", [1, 64, 128, 512])
def test_budget_pad_rows_matches_reference(pad_to):
    got, want = (mod.PrefillBudget(pad_to=pad_to)
                 for mod in (engine, jengine))
    for rows in (1, 7, 63, 64, 65, 127, 128, 129, 511, 513, 2049):
        assert got.pad_rows(rows) == want.pad_rows(rows), rows
    b = engine.PrefillBudget(pad_to=128)
    assert (b.pad_rows(7), b.pad_rows(128), b.pad_rows(129)) == (7, 128, 256)


@pytest.fixture(scope="module")
def overlong_engines():
    cfgs = [dataclasses.replace(get("granite-3-2b").reduced(),
                                dtype="float32")
            for get in (jget_config, get_config)]
    tree = _numpy_params(cfgs[0])
    je = jengine.ServeEngine(cfgs[0], jax.tree_util.tree_map(jnp.asarray,
                                                             tree),
                             batch=2, max_len=48, plan_fusion=True,
                             prefill_budget=jengine.PrefillBudget(**BUDGET),
                             reject_overlong=True)
    te = engine.ServeEngine(cfgs[1], lm.params_from_numpy(cfgs[1], tree,
                                                          device="cpu"),
                            batch=2, max_len=48, device="cpu",
                            prefill_budget=engine.PrefillBudget(**BUDGET),
                            reject_overlong=True)
    return cfgs[1], je, te


def _requests(mod, vocab, lens, budgets, seed=11):
    rng = np.random.default_rng(seed)
    return [mod.Request(rid=i,
                        prompt=rng.integers(1, vocab, L).astype(np.int32),
                        max_new_tokens=m)
            for i, (L, m) in enumerate(zip(lens, budgets))]


def test_reject_overlong_matches_reference(overlong_engines):
    cfg, je, te = overlong_engines
    assert te.reject_overlong and je.reject_overlong
    ok_j, ok_t = (_requests(mod, cfg.vocab_size, (6,), (2,))
                  for mod in (jengine, engine))
    je.run(ok_j)
    te.run(ok_t)                            # one chunk: still admitted
    assert len(ok_t[0].out_tokens) == 2
    assert ok_t[0].out_tokens == ok_j[0].out_tokens
    msgs = []
    for mod, eng in ((jengine, je), (engine, te)):
        with pytest.raises(ValueError,
                           match="per-iteration prefill budget") as e:
            eng.run(_requests(mod, cfg.vocab_size, (15,), (2,)))
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]


def test_serve_cli_reject_overlong(capsys):
    base = ["--arch", "granite-3-2b", "--layers", "1", "--requests", "2",
            "--prompt-len", "20", "--max-new", "2", "--batch", "2",
            "--chunk-rows", "16", "--device", "cpu"]
    tserve.main(base)                      # chunked admission serves it
    assert "served 2 requests" in capsys.readouterr().out
    with pytest.raises(ValueError, match="per-iteration prefill budget 16"):
        tserve.main(base + ["--reject-overlong"])
