"""The fallback graph of every config the planned program leaves
hand-wired, op for op against the JAX package's, on the CPU.

A planned engine over a config that ``executable_decode_supported``
refuses keeps the hand-wired step and plans the reference's four-op
fallback graph: decode_norm1 -> decode attention -> decode_norm2 -> the
FFN in-projection, ``_ffn_in_width`` wide (``moe_router``, num_experts
wide, when the model routes; d_model wide for blocks without an FFN).
Names, deps, plans and launch tables alone do not show an op's width, so
every op's grid and the shapes and dtypes of its inputs and outputs are
held equal too: at the reduced width (batch 3, ``max_len`` 48,
``PrefillBudget(8, 2)``) and at full width (batch 4, ``max_len`` 1024,
``PrefillBudget(512, 2)``), for ``decode_graph(prefill_chunks=n)`` with n
in 0, 1 and 2 and for the wavefront graph with ``ffn_rows``.  (Before the
repair the port planned the dense width for ``moe_router``: (3, 256)
where the reference plans (3, 4) on reduced deepseek-v2-236b.)
"""
from __future__ import annotations

import contextlib
import io

import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.serve import engine as jengine
from repro_torch.configs import get_config, list_archs
from repro_torch.serve import engine

HAND_WIRED = ["deepseek-v2-236b", "internvl2-1b", "minitron-8b",
              "musicgen-medium", "phi3.5-moe-42b-a6.6b",
              "recurrentgemma-2b", "stablelm-3b", "starcoder2-7b",
              "xlstm-1.3b"]
WIDTHS = {"reduced": (3, 48, dict(chunk_rows=8, max_coresident_chunks=2),
                      16),
          "full": (4, 1024, dict(chunk_rows=512, max_coresident_chunks=2),
                   512)}
GRAPHS = {"chunks0": dict(prefill_chunks=0), "chunks1": dict(prefill_chunks=1),
          "chunks2": dict(prefill_chunks=2), "ffn_rows": None}


def test_the_hand_wired_configs():
    assert [a for a in list_archs()
            if engine.executable_decode_supported(get_config(a))
            is not None] == HAND_WIRED


def _dtype(dt) -> str:
    if isinstance(dt, torch.dtype):
        return str(dt).removeprefix("torch.")
    return np.dtype(dt).name


def _sig(gop):
    op = gop.op

    def operands(ops):
        return tuple((tuple(o.shape), _dtype(o.dtype)) for o in ops)
    return (op.name, gop.deps, op.grid, operands(op.inputs),
            operands(op.outputs))


def _engines(arch, width, plan_fusion, scheduling="continuous"):
    jcfg, tcfg = jget_config(arch), get_config(arch)
    if width == "reduced":
        jcfg, tcfg = jcfg.reduced(), tcfg.reduced()
    batch, max_len, budget, _rows = WIDTHS[width]
    kw = dict(batch=batch, max_len=max_len, plan_fusion=plan_fusion,
              scheduling=scheduling)
    with contextlib.redirect_stdout(io.StringIO()):
        je = jengine.ServeEngine(jcfg, None,
                                 prefill_budget=jengine.PrefillBudget(
                                     **budget), **kw)
        te = engine.ServeEngine(tcfg, None, device="cpu",
                                prefill_budget=engine.PrefillBudget(**budget),
                                **kw)
    return je, te


@pytest.mark.parametrize("graph", list(GRAPHS))
@pytest.mark.parametrize("width", list(WIDTHS))
@pytest.mark.parametrize("arch", HAND_WIRED)
def test_fallback_graph_ops_match_reference(arch, width, graph):
    """Every op: name, deps, grid, each input's and output's shape and
    dtype; and the projection's width is the reference's rule."""
    je, te = _engines(arch, width, False,
                      "wavefront" if graph == "ffn_rows" else "continuous")
    kw = GRAPHS[graph] or dict(ffn_rows=WIDTHS[width][3])
    got = [_sig(g) for g in te.decode_graph(**kw)]
    assert got == [_sig(g) for g in je.decode_graph(**kw)]
    cfg = te.cfg
    proj = next(s for s in got if s[0] in ("ffn_proj", "moe_router"))
    want = (cfg.moe.num_experts if cfg.moe is not None else cfg.d_model
            if cfg.d_ff <= 0 else engine._ffn_in_width(cfg))
    assert proj[4][0][0] == (te.batch, want)
    assert engine._ffn_in_width(cfg) == jengine._ffn_in_width(je.cfg)


@pytest.mark.parametrize("width", list(WIDTHS))
@pytest.mark.parametrize("arch", HAND_WIRED)
def test_fallback_plan_and_launch_table_match_reference(arch, width):
    """The planned engine's plan and each chunk count's launch table."""
    je, te = _engines(arch, width, True)
    assert not (te.executed or je.executed)
    assert te.fusion_plan.summary() == je.fusion_plan.summary()
    for n in (0, 1, 2):
        assert (te.build_decode_program(prefill_chunks=n).describe()
                == je.build_decode_program(prefill_chunks=n).describe())
