"""Structural rules of the PyTorch port, checked on the CPU.

  * Nothing under ``src/repro_torch/`` and nothing in ``chip_smoke.py``
    imports JAX or the JAX package ``repro`` (``repro_torch`` itself is
    fine): the port stands alone on a machine without JAX.
  * Entry points run on the card unless asked for the CPU: with no device
    and no CUDA they raise, never dropping quietly to the CPU.
  * The Python CTA->member table of a fused launch (``hfuse.phase_table``)
    covers every member's CTAs exactly once and, with ctas == grid, is the
    reference's ``_bundle_phase_fns`` step formula.
  * The core's planning functions give the reference's numbers.
"""
from __future__ import annotations

import ast
import dataclasses
from pathlib import Path
from types import SimpleNamespace

import pytest
import torch

from repro.core import cost_model as jcost
from repro.core import hfuse as jhfuse
from repro.core.cost_model import Schedule as JSchedule
from repro_torch.configs import get_config
from repro_torch.core import autotuner, cost_model, hfuse
from repro_torch.core.cost_model import Schedule
from repro_torch.models import lm
from repro_torch.serve import engine

ROOT = Path(__file__).resolve().parents[1]


def _port_files():
    return sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [
        ROOT / "chip_smoke.py"]


def _imported_roots(path: Path) -> set[str]:
    roots = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            roots |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            roots.add(node.module.split(".")[0])
    return roots


@pytest.mark.parametrize("path", _port_files(),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_port_imports_no_jax_and_no_reference(path):
    bad = _imported_roots(path) & {"jax", "jaxlib", "repro"}
    assert not bad, f"{path.relative_to(ROOT)} imports {sorted(bad)}"


def test_import_check_sees_reference_imports(tmp_path):
    """The check itself: ``repro`` trips it, ``repro_torch`` does not."""
    f = tmp_path / "m.py"
    f.write_text("import repro_torch.core\nfrom repro.core import hfuse\n"
                 "from . import sibling\n")
    assert _imported_roots(f) == {"repro_torch", "repro"}


def test_entry_points_need_a_device_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = dataclasses.replace(get_config("granite-3-2b").reduced(),
                              dtype="float32")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        engine.ServeEngine(cfg, None, batch=2, max_len=48)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        lm.init(cfg, torch.Generator())
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        lm.init_cache(cfg, 2, 128, device="cuda")
    assert engine.ServeEngine(cfg, None, batch=2, max_len=48,
                              device="cpu").device.type == "cpu"


@pytest.mark.parametrize("kw", [dict(mesh=object()),
                                dict(scheduling="wavefront"),
                                dict(plan_fusion=False)])
def test_unported_paths_raise(kw):
    cfg = get_config("granite-3-2b").reduced()
    with pytest.raises(NotImplementedError, match="not ported"):
        engine.ServeEngine(cfg, None, batch=2, max_len=48, device="cpu",
                           **kw)


@pytest.mark.parametrize("ctas,ratios", [
    ((5, 3), (1, 1)), ((64, 512), (8, 1)), ((256, 512), (1, 8)),
    ((7, 2, 9), (3, 1, 2)), ((1,), (1,)), ((48, 48), (4, 1))])
def test_phase_table_covers_each_cta_once(ctas, ratios):
    table = hfuse.phase_table(ctas, Schedule(ratios))
    seen = [e for e in table if e is not None]
    assert sorted(seen) == sorted((i, c) for i, n in enumerate(ctas)
                                  for c in range(n))
    # and it is exactly the reference's phase formula on grid steps
    ops = [SimpleNamespace(grid=n) for n in ctas]
    fns, n_steps = jhfuse._bundle_phase_fns(ops, JSchedule(ratios))
    assert n_steps == len(table)
    for t, entry in enumerate(table):
        active = [(i, int(step(t))) for i, (step, act) in enumerate(fns)
                  if bool(act(t))]
        assert active == ([] if entry is None else [entry])


def test_cost_model_and_search_match_reference():
    """On the full-width decode graph: every op's native time, every
    bundle's lattice and the tuned schedule equal the reference's."""
    from repro.configs import get_config as jget
    from repro.serve.engine import PrefillBudget as JB, ServeEngine as JE
    from repro.core import autotuner as jtuner
    je = JE(jget("granite-3-2b"), None, batch=8, max_len=2048,
            plan_fusion=True, prefill_budget=JB(chunk_rows=512))
    te = engine.ServeEngine(get_config("granite-3-2b"), None, batch=8,
                            max_len=2048, device="cpu",
                            prefill_budget=engine.PrefillBudget(
                                chunk_rows=512))
    jg = {g.op.name: g.op for g in je.decode_graph(prefill_chunks=2)}
    tg = {g.op.name: g.op for g in te.decode_graph(prefill_chunks=2)}
    assert list(jg) == list(tg)
    for name in jg:
        assert cost_model.native_time(tg[name]) == jcost.native_time(jg[name])
    for pair in (("decode_attn_B8_S2048_H32kv8",
                  "prefill_attn1_C512_S2048_H32kv8"),
                 ("ffn_proj", "prefill_attn0_C512_S2048_H32kv8")):
        jops, tops = [jg[n] for n in pair], [tg[n] for n in pair]
        assert ([s.ratios for s in cost_model.ratio_candidates(tops)]
                == [s.ratios for s in jcost.ratio_candidates(jops)])
        jr, tr = jtuner.search(jops), autotuner.search(tops)
        assert tr.best.sched.ratios == jr.best.sched.ratios
        assert tr.best.est.t_hfused == jr.best.est.t_hfused
    # the measured search (step-count proxy) stays within its budget of
    # top_k + cd_budget measurements, and a cached replan returns its
    # schedule without searching.  The
    # proxy charges the launch's CTA count, and these members launch other
    # CTA counts than their TPU grids, so the measured schedule may differ
    # (the update graph's members, whose CTAs are their grid steps, give
    # the reference's measured plans: tests/test_torch_train.py)
    from repro_torch.core import schedule_cache, timing
    cache = schedule_cache.ScheduleCache()
    n = autotuner.SEARCH_COUNT
    tr = autotuner.search(tops, measure=timing.make_measure("interpret"),
                          cache=cache)
    assert 0 < tr.n_measured <= 3 + 4 and not tr.cache_hit
    again = autotuner.search(tops, measure=timing.make_measure("interpret"),
                             cache=cache)
    assert again.cache_hit and again.best.sched.ratios == tr.best.sched.ratios
    assert autotuner.SEARCH_COUNT == n + 1


def test_sampling_with_temperature_is_seeded():
    """temperature > 0 draws from the engine's seeded torch.Generator: the
    same seed gives the same tokens, every token in the vocabulary."""
    cfg = dataclasses.replace(get_config("granite-3-2b").reduced(),
                              dtype="float32")
    gen = torch.Generator()
    gen.manual_seed(0)
    params = lm.init(cfg, gen, device="cpu")
    runs = []
    for _ in range(2):
        eng = engine.ServeEngine(cfg, params, batch=2, max_len=48,
                                 rng_seed=5, device="cpu")
        reqs = [engine.Request(rid=i, prompt=torch.arange(3 + i).numpy(),
                               max_new_tokens=4, temperature=1.0)
                for i in range(3)]
        eng.run(reqs)
        runs.append([r.out_tokens for r in reqs])
    assert runs[0] == runs[1]
    assert all(len(t) == 4 and all(0 <= x < cfg.vocab_size for x in t)
               for t in runs[0])


def test_serve_launcher_on_cpu(capsys):
    from repro_torch.launch import serve
    serve.main(["--arch", "granite-3-2b", "--requests", "3",
                "--prompt-len", "5", "--max-new", "3", "--batch", "2",
                "--stagger", "2", "--chunk-rows", "4", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "served 3 requests" in out and "on cpu" in out
