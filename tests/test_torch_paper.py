"""The port's paper suite against the JAX package's, on the CPU.

Both packages get the same numpy inputs (normals from a seeded numpy
generator, cast to bf16 the same way on both sides).  The port runs its
plain versions here (CPU tensors); the reference runs its Pallas kernels in
interpret mode through ``hfuse.run_single``, as its own tests do.

Tolerances (``paper_suite.TOLERANCE``, |got - want| <= tol * (1 + |want|)):
maxpool, upsample, im2col and hist bitwise; bnstats 1e-3 and ethash_like
1e-4 (the reference's own, fp32 sums in another order); the hash kernels
1e-5 (24 rounds of fp32 mixing drift by at most 6.1e-7 from an fp64
computation at the defaults, so two fp32 orders differ by ~1.2e-6).  Plans
(schedules, working-set caps, variants, predicted times, planned members)
must be equal.
"""
from __future__ import annotations

import math
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import autotuner as jtuner
from repro.core import hfuse as jhfuse
from repro.core import op_spec as jop_spec
from repro.core import planner as jplanner
from repro.core import timing as jtiming
from repro.kernels import paper_suite as jps
from repro_torch.core import autotuner, hfuse, op_spec, planner, timing
from repro_torch.core.cost_model import Schedule
from repro_torch.kernels import cuda
from repro_torch.kernels import paper_suite as ps
from repro_torch.launch import paper as paper_launch

NAMES = list(jps.ALL_KERNELS)
BF16_NAMES = ["maxpool", "upsample", "im2col", "bnstats"]

# the shapes of the reference's own sweep (tests/test_kernels_paper_suite.py)
REF_SHAPES = (
    [(n, dict(R=R, C=C, bm=bm)) for n in ("maxpool", "upsample", "im2col")
     for R, C, bm in ((512, 256, 128), (1024, 512, 256), (2048, 128, 128))]
    + [("bnstats", dict(R=1024, C=256, bm=128)),
       ("bnstats", dict(R=4096, C=512, bm=512)),
       ("hist", dict(R=512, C=128, bm=64)),
       ("hist", dict(R=1024, C=256, bm=128)),
       ("ethash_like", dict(R_dag=4096, bm=256))]
    + [(n, dict(R=1024, bm=256))
       for n in ("sha_like", "blake_like", "blake2b_like")])
META_CASES = ([(n, {}) for n in NAMES]
              + [(n, dict(jps.SMALL_KW[n])) for n in NAMES] + REF_SHAPES)


def _dt_name(dt) -> str:
    return str(dt).split(".")[-1] if isinstance(dt, torch.dtype) \
        else np.dtype(dt).name


def _meta(op) -> dict:
    """Every piece of planning metadata, index maps probed at every step."""
    def operand(o):
        return (tuple(o.shape), _dt_name(o.dtype), tuple(o.block_shape),
                [tuple(int(c) for c in o.index_map(s))
                 for s in range(op.grid)])
    return {"name": op.name, "grid": op.grid, "flops": op.flops,
            "hbm_bytes": op.hbm_bytes, "tag": op.tag, "bound": op.bound,
            "vmem_bytes": op.vmem_bytes, "t_native": op.t_native,
            "inputs": [operand(o) for o in op.inputs],
            "outputs": [operand(o) for o in op.outputs]}


def _numpy_inputs(name, kw, seed=0):
    """fp32 numpy arrays of the op's input shapes, scaled as its
    make_inputs scales them."""
    op = jps.ALL_KERNELS[name](**kw)[0]
    rng = np.random.default_rng(seed)
    arrays = [rng.standard_normal(o.shape).astype(np.float32)
              for o in op.inputs]
    if name.endswith("_like"):          # 0.1 * data, w / sqrt(C)
        for a in arrays[:-1]:
            a *= 0.1
        arrays[-1] /= math.sqrt(arrays[-1].shape[0])
    return arrays


# ---------------------------------------------------------------------------
# (a) planning metadata
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("name,kw", META_CASES,
                         ids=lambda v: v if isinstance(v, str) else
                         "-".join(f"{k}{x}" for k, x in v.items()) or "default")
def test_metadata_and_shrink_match_reference(name, kw):
    jop = jps.ALL_KERNELS[name](**kw)[0]
    top = ps.ALL_KERNELS[name](**kw)[0]
    assert _meta(top) == _meta(jop)
    for factor in (2, 4, 8):
        js, ts = jop_spec.shrink_blocks(jop, factor), \
            op_spec.shrink_blocks(top, factor)
        assert (js is None) == (ts is None)
        if js is not None:
            assert _meta(ts) == _meta(js)
            assert ts.member == top.member      # same function, same CTAs


def test_registry_and_bundles_match_reference():
    assert list(ps.DL_KERNELS) == list(jps.DL_KERNELS)
    assert list(ps.CRYPTO_KERNELS) == list(jps.CRYPTO_KERNELS)
    assert ps.paper_pairs() == jps.paper_pairs()
    assert ps.paper_triples() == jps.paper_triples()
    assert ps.SMALL_KW == jps.SMALL_KW
    for small in (False, True):
        for names in jps.paper_triples():
            tops, tmks, tplains = ps.make_bundle(names, small)
            jops, _, _ = jps.make_bundle(names, small)
            assert [_meta(o) for o in tops] == [_meta(o) for o in jops]
            assert len(tmks) == len(tplains) == len(names)


def _defines(name: str) -> dict[str, int]:
    """The integer ``#define``s of a kernel source."""
    text = (Path(__file__).resolve().parents[1] / "src" / "repro_torch"
            / "csrc" / name).read_text()
    return {k: int(v) for k, v in
            re.findall(r"^#define (\w+) (\d+)\b", text, re.M)}


CUH = {**_defines("common.cuh"), **_defines("paper_member.cuh")}


def test_member_geometry():
    """At the defaults: the streaming members CTAS_PER_STEP CTAs per grid
    step, bnstats BN_CTAS_PER_STEP (256 CTAs of 64 rows x all columns: one
    wave at two CTAs an SM of the card's 132), hist HIST_CTAS_PER_STEP (128
    CTAs of 16 rows: one wave at one CTA an SM), ethash_like one per step
    (16 slices x 8 runs); the wrapper's constants are the kernel source's,
    and the carries' workspaces have a partial per CTA (bnstats: and per
    group of BN_GROUP CTAs) and a ticket per group, hist its counts and
    one ticket."""
    assert (ps.TILE_R, ps.THREADS, ps.BN_GROUP) == (
        CUH["PS_TILE_R"], CUH["HF_THREADS"], CUH["BN_GROUP"])
    assert ps.WARPS == CUH["HF_THREADS"] // 32
    ops = {n: ps.ALL_KERNELS[n]()[0] for n in NAMES}
    per_step = {"ethash_like": 1, "bnstats": ps.BN_CTAS_PER_STEP,
                "hist": ps.HIST_CTAS_PER_STEP}
    for n, op in ops.items():
        want = op.grid * per_step.get(n, ps.CTAS_PER_STEP)
        assert op.ctas == want, (n, op.ctas, op.grid)
    bn = ops["bnstats"].member
    assert bn.rows * bn.ctas == bn.R and bn.ctas <= 2 * 132
    groups = -(-bn.ctas // ps.BN_GROUP)
    assert bn.workspace_sizes() == (
        ((bn.ctas + groups) * 2 * bn.C, torch.float32),
        (groups + 1, torch.int32))
    eth = ops["ethash_like"].member
    assert (eth.param // ps.TILE_R, eth.runs) == (16, 8)
    assert eth.workspace_sizes() == (
        (eth.ctas * ps.TILE_R * ps.LANES, torch.float32),
        (eth.param // ps.TILE_R, torch.int32))
    hi = ops["hist"].member
    assert (hi.rows, hi.ctas) == (16, 128)
    assert hi.workspace_sizes() == ((hi.param, torch.int32), (1, torch.int32))
    assert ops["maxpool"].member.workspace_sizes() == ()
    for n in ("upsample", "im2col"):        # 16 rows, one wave at 2 an SM
        m = ops[n].member
        assert (m.rows, m.ctas) == (16, 256) and m.workspace_sizes() == ()


# (body, R, C, dtype, rows, param, runs): what the kernels do not take
REFUSED = [
    ("bnstats", 256, 130, torch.float32, 8, 0, 1),     # not 16-byte vectors
    ("bnstats", 256, 2048, torch.float32, 8, 0, 1),    # > 256 vectors a row
    ("bnstats", 256, 4096, torch.bfloat16, 8, 0, 1),
    ("bnstats", 250, 128, torch.float32, 8, 0, 1),     # rows per CTA
    ("ethash_like", 512, 64, torch.float32, 32, 128, 1),    # C != 128
    ("ethash_like", 480, 128, torch.float32, 32, 48, 1),    # bm % 32
    ("ethash_like", 520, 128, torch.float32, 32, 128, 1),   # R % bm
    ("ethash_like", 512, 128, torch.float32, 32, 128, 3),   # runs
    ("hash_like", 256, 256, torch.float32, 32, 16, 1),      # C != 128
    ("maxpool", 256, 128, torch.float32, 3, 0, 1),          # odd rows
    ("hist", 256, 132, torch.bfloat16, 8, 128, 1),  # not 16-byte vectors
    ("hist", 256, 128, torch.float32, 8, 0, 1),             # no bins
    ("hist", 256, 256, torch.float32, 8, ps.HIST_MAX_BINS + 1, 1),
]
# ... and the widths the new bnstats geometry takes beyond the tested ones
TAKEN = [
    ("bnstats", 256, 384, torch.float32, 8, 0, 1),     # 96 vectors, G 2
    ("bnstats", 256, 1024, torch.float32, 8, 0, 1),
    ("bnstats", 256, 2048, torch.bfloat16, 8, 0, 1),
    ("ethash_like", 512, 128, torch.float32, 32, 128, 4),
    ("hist", 256, 8, torch.bfloat16, 8, ps.HIST_MAX_BINS, 1),
    ("hist", 24, 132, torch.float32, 3, 1, 1),      # odd rows, one bin
    ("im2col", 64, 4, torch.float32, 4, 11, 1),     # K past 2C
    ("im2col", 64, 8, torch.bfloat16, 4, 19, 1),
]


@pytest.mark.parametrize("case", REFUSED, ids=lambda c: f"{c[0]}-C{c[2]}")
def test_member_describe_refuses(case):
    body, R, C, dt, rows, param, runs = case
    with pytest.raises(ValueError, match="unsupported"):
        ps.PaperMember(body, R, C, dt, rows, param, runs).describe(
            cuda.MemberDesc())


@pytest.mark.parametrize("case", TAKEN, ids=lambda c: f"{c[0]}-C{c[2]}")
def test_member_describe_takes(case):
    body, R, C, dt, rows, param, runs = case
    md = cuda.MemberDesc()
    ps.PaperMember(body, R, C, dt, rows, param, runs).describe(md)
    assert (md.i[0], md.i[1], md.i[3]) == (R, C, rows)


@pytest.mark.parametrize("name,kw", META_CASES,
                         ids=lambda v: v if isinstance(v, str) else
                         "-".join(f"{k}{x}" for k, x in v.items()) or "default")
def test_member_describes_every_tested_shape(name, kw):
    """The kernel takes every shape the tests and the path use: its
    descriptor packs, and its CTAs cover the op's rows exactly."""
    op = ps.ALL_KERNELS[name](**kw)[0]
    md = cuda.MemberDesc()
    op.member.describe(md)
    m = op.member
    assert md.kind and md.i[0] == m.R and md.i[1] == m.C
    rows = m.R if m.body == "ethash_like" else m.rows * m.ctas
    assert rows == m.R
    want_in, want_out = m.io()
    assert [(o.shape, o.dtype) for o in op.inputs] == want_in
    assert [(o.shape, o.dtype) for o in op.outputs] == want_out


# ---------------------------------------------------------------------------
# (b) plain versions against the reference's kernels (interpret mode)
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("name,dtype", [(n, "float32") for n in NAMES]
                         + [(n, "bfloat16") for n in BF16_NAMES])
def test_plain_matches_reference_interpret(name, dtype):
    kw = dict(jps.SMALL_KW[name])
    tkw, jkw = kw, kw
    if dtype == "bfloat16":
        tkw, jkw = dict(kw, dtype=torch.bfloat16), dict(kw, dtype=jnp.bfloat16)
    jop, _, _ = jps.ALL_KERNELS[name](**jkw)
    top, _, plain = ps.ALL_KERNELS[name](**tkw)
    arrays = _numpy_inputs(name, kw)
    jins = [jnp.asarray(a).astype(o.dtype) for a, o in zip(arrays, jop.inputs)]
    tins = ps.inputs_from_numpy(name, arrays, "cpu", **tkw)
    for j, t in zip(jins, tins):                 # the same bits on both sides
        assert np.array_equal(np.asarray(j.astype(jnp.float32)),
                              t.float().numpy())
    want = jhfuse.run_single(jop, interpret=True)(*jins)
    got = hfuse.run_single(top)(*tins)
    assert torch.equal(got[0], plain(*tins))
    w = torch.from_numpy(np.array(want[0].astype(jnp.float32))).to(
        got[0].dtype)
    assert str(got[0].dtype).endswith(np.dtype(want[0].dtype).name)
    ps.max_error(got[0], w, top.member.body)
    if name == "hist":
        assert float(got[0].sum()) == kw["R"] * kw["C"]


def test_max_error_raises_outside_tolerance():
    x = torch.ones(4, 4)
    assert ps.max_error(x, x.clone(), "maxpool") == 0.0
    with pytest.raises(AssertionError, match="bitwise"):
        ps.max_error(x, x + 1e-7, "im2col")
    assert ps.max_error(x + 1e-4, x, "bnstats") == pytest.approx(1e-4, rel=1e-3)
    with pytest.raises(AssertionError, match="tolerance"):
        ps.max_error(x + 1e-3, x, "hash_like")


@pytest.mark.parametrize("name", ["ethash_like", "hist", "sha_like"])
def test_bf16_only_where_the_kernel_has_it(name):
    """bf16 plans like the reference; the matmul bodies' members refuse to
    describe themselves, hist's takes it (the reference casts x to fp32)."""
    op = ps.ALL_KERNELS[name](**jps.SMALL_KW[name], dtype=torch.bfloat16)[0]
    if name == "hist":
        md = cuda.MemberDesc()
        op.member.describe(md)
        assert (md.kind, md.i[2]) == (cuda.HIST, 0)
        return
    with pytest.raises(ValueError, match="takes"):
        op.member.describe(cuda.MemberDesc())


def test_inputs_from_numpy_checks_and_needs_a_device(monkeypatch):
    arrays = _numpy_inputs("maxpool", jps.SMALL_KW["maxpool"])
    with pytest.raises(ValueError, match="shape"):
        ps.inputs_from_numpy("maxpool", [arrays[0][:8]], "cpu",
                             **jps.SMALL_KW["maxpool"])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ps.inputs_from_numpy("maxpool", arrays, **jps.SMALL_KW["maxpool"])


# ---------------------------------------------------------------------------
# (c) cost-model search and planning
# ---------------------------------------------------------------------------
BUNDLES = [tuple(p) for p in jps.paper_pairs()] + jps.paper_triples()


@pytest.mark.parametrize("names", BUNDLES, ids="+".join)
def test_costmodel_search_matches_reference(names):
    jops, _, _ = jps.make_bundle(names)
    tops, _, _ = ps.make_bundle(names)
    jr, tr = jtuner.search(tuple(jops)), autotuner.search(tuple(tops))
    assert tr.best.sched.ratios == jr.best.sched.ratios
    assert tr.best.vmem_cap == jr.best.vmem_cap
    assert tr.best.variant == jr.best.variant
    assert tr.best.est.t_hfused == jr.best.est.t_hfused
    assert tr.lattice_size == jr.lattice_size
    assert [_meta(o) for o in tr.ops] == [_meta(o) for o in jr.ops]


PLANNED = {("maxpool", "upsample", "sha_like"): ["maxpool+sha_like"],
           ("ethash_like", "hist", "blake_like"): ["ethash_like+blake_like"],
           ("bnstats", "im2col", "blake2b_like"): ["im2col+blake2b_like"],
           ("sha_like", "blake_like", "blake2b_like"): []}


@pytest.mark.parametrize("names", BUNDLES, ids="+".join)
def test_plan_matches_reference(names):
    jops, _, _ = jps.make_bundle(names)
    tops, _, _ = ps.make_bundle(names)
    jp = jplanner.plan([jplanner.GraphOp(o) for o in jops])
    tp = planner.plan([planner.GraphOp(o) for o in tops])
    assert tp.summary() == jp.summary()
    assert tp.rejected == jp.rejected
    if names in PLANNED:
        assert [d.members for d in tp.fused] == [
            tuple(m.split("+")) for m in PLANNED[names]]


def test_quickstart_pair_plans_like_the_example():
    (en, ekw), (bn, bkw) = paper_launch.QUICKSTART
    jplan = jplanner.plan([jplanner.GraphOp(jps.ALL_KERNELS[en](**ekw)[0]),
                           jplanner.GraphOp(jps.ALL_KERNELS[bn](**bkw)[0])])
    tplan = planner.plan([planner.GraphOp(ps.ALL_KERNELS[en](**ekw)[0]),
                          planner.GraphOp(ps.ALL_KERNELS[bn](**bkw)[0])])
    assert tplan.summary() == jplan.summary()
    assert [d.members for d in tplan.fused] == [("ethash_like",
                                                 "blake_like")]


# ---------------------------------------------------------------------------
# (d) measured search with the step-count proxy
# ---------------------------------------------------------------------------
# The proxy charges the launch's CTA count.  The streaming and hash members
# launch 16 CTAs per grid step, bnstats 8, hist 4 and ethash_like one: where
# bnstats, hist or ethash_like shares a bundle, or where a ratio does not
# divide 16 x grid as it divides the grid, the proxy is no longer
# proportional to the reference's, and the measured schedule may differ.
# These are the triples where it does (ROADMAP §3); hist's 4 a step adds
# none (its one triple already differs through ethash_like).
PROXY_DIFFERS = {("ethash_like", "hist", "blake_like"),
                 ("bnstats", "im2col", "blake2b_like")}


@pytest.mark.parametrize("names", jps.paper_triples(), ids="+".join)
def test_interpret_measured_search_matches_reference(names):
    jops, _, _ = jps.make_bundle(names)
    tops, _, _ = ps.make_bundle(names)
    jr = jtuner.search(tuple(jops), measure=jtiming.make_measure("interpret"))
    tr = autotuner.search(tuple(tops),
                          measure=timing.make_measure("interpret"))
    same = (tr.best.sched.ratios, tr.best.vmem_cap, tr.best.variant) == (
        jr.best.sched.ratios, jr.best.vmem_cap, jr.best.variant)
    assert same == (tuple(names) not in PROXY_DIFFERS), (
        tr.best.sched.label(), jr.best.sched.label())
    assert 0 < tr.n_measured <= 3 + 4


# ---------------------------------------------------------------------------
# (e) vertical fusion
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("names", BUNDLES, ids="+".join)
def test_generate_vfused(names):
    tops, mks, _ = ps.make_bundle(names, small=True)
    jops, _, _ = jps.make_bundle(names, small=True)
    gen = torch.Generator()
    gen.manual_seed(3)
    ins = [t for mk in mks for t in mk(gen, "cpu")]
    vf = hfuse.generate_vfused(tops)
    assert vf.schedule.ratios == jhfuse.generate_vfused(
        *jops, interpret=True).schedule.ratios
    assert hfuse.generate_vfused(*tops).schedule == vf.schedule
    got, want = vf(*ins), hfuse.run_native(tops)(*ins)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    # one contiguous run of CTAs per member, in member order
    table = hfuse.phase_table([op.ctas for op in tops],
                              Schedule(vf.launch_ratios))
    assert table == [(i, c) for i, op in enumerate(tops)
                     for c in range(op.ctas)]
    assert vf.n_steps == sum(op.ctas for op in tops)


# ---------------------------------------------------------------------------
# (f) the launcher
# ---------------------------------------------------------------------------
def test_paper_launcher_on_cpu(capsys):
    recs = paper_launch.main(["--device", "cpu", "--small", "--triples",
                              "--measure", "interpret"])
    out = capsys.readouterr().out
    assert len(recs) == 4 and "4 bundles on cpu" in out
    assert "plan fuses upsample+sha_like (1:1)" in out
    assert "v5e planning model" in out
    assert all(r["bitwise"] and "ms" not in r for r in recs)
    assert [r["schedule"] for r in recs] == [
        jtuner.search(tuple(jps.make_bundle(n, small=True)[0])
                      ).best.sched.label() for n in jps.paper_triples()]


def test_paper_launcher_quickstart_and_no_device(capsys, monkeypatch):
    (rec,) = paper_launch.main(["--device", "cpu", "--small"])
    assert rec["bundle"] == "ethash_like+blake_like"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        paper_launch.main(["--small"])


# ---------------------------------------------------------------------------
# (g) non-finite and out-of-range values
# ---------------------------------------------------------------------------
def _special(shape, seed):
    """Normals with NaN, +-inf and values outside [-4, 4] spread over both
    rows of the pairs and both ends of the bins."""
    x = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    flat = x.reshape(-1)
    vals = [np.nan, np.inf, -np.inf, 4.0, -4.0, 3.9999998, 7.5, -12.0, 1e30,
            -1e30]
    for j, v in enumerate(vals * 7):
        flat[(j * 97 + 13) % flat.size] = v
    return x


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_hist_counts_nan_as_the_reference(dtype):
    """A NaN counts in bin 0 (the reference's cast of it to int32 gives 0),
    +inf and values past 4 in the top bin, -inf and values below -4 in bin
    0: the plain hist bitwise against ``repro.kernels.ref.hist``."""
    from repro.kernels import ref as jref
    kw = dict(jps.SMALL_KW["hist"])
    x = _special((kw["R"], kw["C"]), 3)
    jx = jnp.asarray(x).astype(jnp.dtype(dtype))
    tx = ps.inputs_from_numpy("hist", [x], "cpu", **kw,
                              dtype=getattr(torch, dtype))[0]
    want = torch.from_numpy(np.array(jref.hist(jx)))
    got = ps.hist(tx)
    assert torch.equal(got, want)
    assert float(got.sum()) == x.size and float(got[0, 0]) > 0


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_maxpool_select_propagates_nan_as_the_reference(dtype):
    """The maxpool kernel's select (``csrc/paper_member.cuh`` ps_max: a when
    a is NaN, a > b, or a == b with b's sign bit set, else b), done in
    PyTorch, and the plain maxpool are
    bitwise equal to ``repro.kernels.ref.maxpool`` with NaN and +-inf in
    either row of a pair."""
    from repro.kernels import ref as jref
    x = _special((64, 128), 4)
    x[0, :2] = [np.nan, 1.0]
    x[1, :2] = [2.0, np.nan]
    jx = jnp.asarray(x).astype(jnp.dtype(dtype))
    tx = ps.inputs_from_numpy("maxpool", [x], "cpu", R=64, C=128, bm=64,
                              dtype=getattr(torch, dtype))[0]
    want = torch.from_numpy(np.array(jref.maxpool(jx).astype(jnp.float32)))
    a, b = tx[0::2], tx[1::2]
    select = torch.where(a.isnan() | (a > b) | ((a == b) & b.signbit()),
                         a, b)
    for got in (select, ps.maxpool(tx)):
        assert torch.equal(got.float().isnan(), want.isnan())
        assert torch.equal(got.float().nan_to_num(), want.nan_to_num())
    assert bool(select[0, :2].isnan().all())


@pytest.mark.parametrize("C,dtype", [(4, "float32"), (8, "bfloat16")])
def test_im2col_blocks_past_c_match_the_reference(C, dtype):
    """Block k of im2col is the row rotated left by s = k if k < C else 0
    (the reference concatenates x[:, k:] and x[:, :k], so a block with k >=
    C is the row itself).  The plain im2col and that rule as one gather
    (``torch.index_select`` by the index (arange(C) + s) % C of each block,
    the card's yardstick) are bitwise equal to ``repro.kernels.ref.im2col``
    and to the reference's kernel in interpret mode at K = C - 1, C, C + 1
    and 2C + 3; a rotation by k with one wrap, the index rule the kernel
    had before this was repaired, differs once K > C + 1."""
    from repro.kernels import ref as jref
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    x = np.random.default_rng(11).standard_normal((64, C)).astype(np.float32)
    for K in (C - 1, C, C + 1, 2 * C + 3):
        kw = dict(R=64, C=C, bm=64, K=K)
        jx = jnp.asarray(x).astype(jdt)
        tx = ps.inputs_from_numpy("im2col", [x], "cpu", **kw, dtype=tdt)[0]
        want = torch.from_numpy(np.array(
            jref.im2col(jx, K=K).astype(jnp.float32))).to(tdt)
        (kern,) = jhfuse.run_single(jps.make_im2col(**kw, dtype=jdt)[0],
                                    interpret=True)(jx)
        assert torch.equal(torch.from_numpy(np.array(
            kern.astype(jnp.float32))).to(tdt), want)
        idx = torch.cat([(torch.arange(C) + (k if k < C else 0)) % C
                         for k in range(K)])
        assert torch.equal(ps.im2col(tx, K=K), want)
        assert torch.equal(torch.index_select(tx, 1, idx), want)
        # the rule without the repair: c + k + j wrapped once (C <= k < 2C
        # rotates by k - C; from 2C on it reads past the row: cut off here)
        old = torch.cat([(torch.arange(C) + k) % (2 * C) % C
                         for k in range(K)])
        assert torch.equal(torch.index_select(tx, 1, old), want) == (
            K <= C + 1)
