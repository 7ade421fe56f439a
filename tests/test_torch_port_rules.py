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
  * Every public name of a reference module that the port has ported
    (``src/repro/<path>`` beside ``src/repro_torch/<path>``) exists in the
    port's module: the names the reference defines at top level and the
    public methods and fields of its classes (the port may import a name
    where the reference defines it).  The exceptions are written out
    below, each with the ROADMAP queue 1 item that brings it, or the design
    that replaces it.
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


@pytest.mark.parametrize("kw,exc,match", [
    (dict(mesh=SimpleNamespace(mesh_dim_names=("model",), shape=(2,),
                               device_type="cpu"),
          scheduling="wavefront"), ValueError,
     "tensor-parallel serve requires scheduling='continuous' and "
     "plan_fusion=True"),
    (dict(scheduling="wavefront", paged_kv=True), ValueError,
     "paged_kv requires scheduling='continuous' and plan_fusion=True"),
    (dict(plan_fusion=False, paged_kv=True), ValueError,
     "the paged kernels run only on the executed chunked path")])
def test_unported_paths_raise(kw, exc, match):
    """Tensor-parallel serve and the paged arena refuse the wavefront and
    hand-wired paths with the reference's texts (tensor parallelism runs
    the executed continuous step only)."""
    cfg = get_config("granite-3-2b").reduced()
    with pytest.raises(exc, match=match):
        engine.ServeEngine(cfg, None, batch=2, max_len=48, device="cpu",
                           **kw)


# Public names of ported reference modules that the port does not have yet:
# (module, name) -> the ROADMAP queue 1 item that brings it.
NAMES_TO_PORT = {
    **{("models/layers.py", n): "item 5c (param specs for the dry run)"
       for n in ("attn_spec", "embed_spec", "layernorm_spec", "mlp_spec",
                 "norm_spec", "rmsnorm_spec")},
    **{("models/lm.py", n): "item 5c (param specs for the dry run)"
       for n in ("block_spec", "cache_logical_axes", "param_specs")},
    ("launch/train.py", "build"): "item 5c (build(mesh=))",
    ("train/optimizer.py", "abstract_init"): "item 5c (the dry run)",
    ("launch/mesh.py", "make_production_mesh"): "item 5c (the dry run)",
    ("distributed/sharding.py", "shard"):
        "item 5b (the distributed trainer's constraints)",
    **{("distributed/sharding.py", n): "item 5c (the dry run's shardings)"
       for n in ("sharding_tree", "param_shardings", "replicated")},
    **{("train/fault_tolerance.py", n): "item 5b (HeartbeatMonitor)"
       for n in ("HeartbeatMonitor", "HeartbeatMonitor.beat",
                 "HeartbeatMonitor.dead_hosts",
                 "HeartbeatMonitor.mark_suspect",
                 "HeartbeatMonitor.plan_rescale", "HostState",
                 "HostState.last_seen", "HostState.suspect_count")},
    ("core/schedule_cache.py", "ScheduleCache.stats"):
        "item 6 (cache-inspect)",
}
# Names the port's design replaces, with what replaces them.
NAMES_REPLACED = {
    ("core/op_spec.py", "OpSpec.body"):
        "the Pallas body: OpSpec.member (the CUDA member) and OpSpec.plain",
    ("kernels/ops.py", "force"):
        "interpret mode has no counterpart: the operands' device decides",
}


def _public_names(path: Path, imports: bool = True) -> set[str]:
    """Top-level public names of a module (defs, classes, assignments and,
    with ``imports``, imported names) and its classes' public methods and
    annotated fields."""
    out = set()
    for node in ast.parse(path.read_text(), str(path)).body:
        if isinstance(node, (ast.FunctionDef, ast.ClassDef)):
            out.add(node.name)
            if isinstance(node, ast.ClassDef):
                for sub in node.body:
                    if isinstance(sub, ast.FunctionDef):
                        out.add(f"{node.name}.{sub.name}")
                    elif (isinstance(sub, ast.AnnAssign)
                          and isinstance(sub.target, ast.Name)):
                        out.add(f"{node.name}.{sub.target.id}")
        elif isinstance(node, (ast.Assign, ast.AnnAssign)):
            targets = (node.targets if isinstance(node, ast.Assign)
                       else [node.target])
            out |= {n.id for t in targets for n in ast.walk(t)
                    if isinstance(n, ast.Name)}
        elif imports and isinstance(node, (ast.Import, ast.ImportFrom)):
            out |= {(a.asname or a.name).split(".")[0] for a in node.names}
    return {n for n in out if not any(p.startswith("_")
                                      for p in n.split("."))}


def _ported_modules():
    port = ROOT / "src" / "repro_torch"
    return [p.relative_to(port).as_posix() for p in sorted(port.rglob("*.py"))
            if (ROOT / "src" / "repro" / p.relative_to(port)).exists()]


@pytest.mark.parametrize("mod", _ported_modules())
def test_ported_module_has_the_reference_names(mod):
    want = _public_names(ROOT / "src" / "repro" / mod, imports=False)
    have = _public_names(ROOT / "src" / "repro_torch" / mod)
    excused = {n for (m, n) in (*NAMES_TO_PORT, *NAMES_REPLACED) if m == mod}
    missing = sorted(want - have - excused)
    assert not missing, f"{mod}: the port lacks {missing}"
    stale = sorted(excused & have)
    assert not stale, f"{mod}: {stale} are ported: drop their exceptions"


def test_name_check_sees_a_missing_name(tmp_path):
    """The check itself: a missing method and a missing function show; a
    private name, and a name the reference only imports, do not, and the
    port may import a name the reference defines."""
    ref, port = tmp_path / "ref.py", tmp_path / "port.py"
    ref.write_text("import os\nclass A:\n    x: int = 0\n    def f(self):"
                   "\n        pass\n    def _g(self):\n        pass\n"
                   "def h():\n    pass\n_p = 1\nK = 2\n")
    port.write_text("from m import K\nclass A:\n    x: int = 0\n")
    assert (_public_names(ref, imports=False) - _public_names(port)
            == {"A.f", "h"})


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
