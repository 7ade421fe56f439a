"""The port's CUDA kernels on the card, each against its plain PyTorch
version, at reduced and full granite-3-2b widths.

Paged attention members are held BITWISE against the contiguous members on
the same logical cache, the residual add and the matmul->residual_add
chain against their plain versions and the chain's separate members.  The grouped expert FFN differs from its plain
version only in the order of its fp32 sums (bf16 tolerance); the fp32 router
GEMM is held to the fp32 tolerance.

These tests need an NVIDIA card and the CUDA toolkit; where
``torch.cuda.is_available()`` is false they skip (the ``cuda_dev`` fixture
decides, never the import).  This file imports no JAX, so it also runs on a
machine without it:

  PYTHONPATH=src python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Tolerances (kernel vs plain, same bf16 inputs): fp32 outputs to 1e-4
absolute plus 1e-3 relative — both sum the same bf16 products in fp32, in
another order; bf16 outputs to one bf16 rounding step of the largest value
(2**-7 relative of the row's max) — the fp32 sums can round to neighbouring
bf16 values.  Chains and fused bundles are held BITWISE against their
separate launches.
"""
from __future__ import annotations

import dataclasses
import math

import pytest
import torch

from repro_torch.core import hfuse, stitch
from repro_torch.core.cost_model import Schedule
from repro_torch.kernels import cuda, elementwise
from repro_torch.kernels.decode_attention import decode_attention_op, kv_split
from repro_torch.kernels.matmul import matmul_1d_op
from repro_torch.kernels.moe_gmm import moe_gmm, moe_gmm_op, plain_moe_gmm
from repro_torch.kernels.prefill_attention import prefill_attention_op
from repro_torch.kernels.rmsnorm import rmsnorm_op

pytestmark = pytest.mark.cuda
BF = torch.bfloat16
F32 = torch.float32

# (B, d, H, Hkv, D, d_ff, S): reduced granite-3-2b, the full widths, and
# phi3.5-moe's attention and expert widths (head dim 128)
WIDTHS = {"reduced": (2, 64, 4, 4, 16, 128, 128),
          "full": (8, 2048, 32, 8, 64, 8192, 2048),
          "phi": (8, 4096, 32, 8, 128, 6400, 2048)}


@pytest.fixture(scope="module")
def cuda_dev():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the kernels run only on the card")
    torch.backends.cuda.matmul.allow_tf32 = False
    cuda.library()
    return torch.device("cuda")


def _gen(seed):
    g = torch.Generator(device="cuda")
    g.manual_seed(seed)
    return g


def _randn(shape, g, dtype=BF, scale=1.0):
    return (torch.randn(shape, generator=g, device="cuda") * scale).to(dtype)


def _close_bf16(out, ref):
    tol = 2.0 ** -7 * ref.float().abs().max().item() + 1e-6
    err = (out.float() - ref.float()).abs().max().item()
    assert err <= tol, (err, tol)


def _close_f32(out, ref):
    torch.testing.assert_close(out, ref, rtol=1e-3, atol=1e-4)


def _kernel_vs_plain(op, *ins):
    got = hfuse.run_single(op)(*ins)
    want = hfuse.run_single(op, plain=True)(*ins)
    return got, want


def test_descriptor_layout_matches(cuda_dev):
    lib = cuda.library()
    import ctypes
    ms, bs = ctypes.c_int(), ctypes.c_int()
    assert lib.hf_desc_sizes(ctypes.byref(ms), ctypes.byref(bs)) > 0
    assert (ms.value, bs.value) == (ctypes.sizeof(cuda.MemberDesc),
                                    ctypes.sizeof(cuda.BundleDesc))


@pytest.mark.parametrize("width", sorted(WIDTHS))
def test_rmsnorm_member(cuda_dev, width):
    B, d = WIDTHS[width][:2]
    g = _gen(0)
    x = _randn((B, d), g)
    scale = _randn((1, d), g, torch.float32, 0.1)
    (got,), (want,) = _kernel_vs_plain(rmsnorm_op(B, d, bm=B), x, scale)
    _close_bf16(got, want)


@pytest.mark.parametrize("width", sorted(WIDTHS))
def test_gemm_member(cuda_dev, width):
    B, d, H, Hkv, D = WIDTHS[width][:5]
    N = (H + 2 * Hkv) * D
    g = _gen(1)
    x = _randn((B, d), g)
    w = _randn((d, N), g, scale=1 / math.sqrt(d))
    (got,), (want,) = _kernel_vs_plain(matmul_1d_op(B, d, N, bm=B), x, w)
    _close_bf16(got, want)


@pytest.mark.parametrize("fn", [elementwise.silu_gate, elementwise.gelu_gate,
                                elementwise.gelu_plain, elementwise.relu2])
@pytest.mark.parametrize("width", sorted(WIDTHS))
def test_activation_member(cuda_dev, width, fn):
    B, f = WIDTHS[width][0], WIDTHS[width][5]
    gated = fn in (elementwise.silu_gate, elementwise.gelu_gate)
    f_in = 2 * f if gated else f
    h = _randn((B, f_in), _gen(2))
    op = elementwise.activation_op(B, f_in, f, fn, bm=B)
    (got,), (want,) = _kernel_vs_plain(op, h)
    _close_bf16(got, want)


@pytest.mark.parametrize("fn", [elementwise.silu_gate, elementwise.gelu_plain])
@pytest.mark.parametrize("width", sorted(WIDTHS))
def test_chains_bitwise_equal_separate_members(cuda_dev, width, fn):
    """rmsnorm->gemm (prologue) and gemm->activation (epilogue): the chain
    equals its two members launched separately, bit for bit, and matches
    the plain chain."""
    B, d, H, Hkv, D, f = WIDTHS[width][:6]
    g = _gen(3)
    x = _randn((B, d), g)
    scale = _randn((1, d), g, torch.float32, 0.1)
    # prologue chain
    N = (H + 2 * Hkv) * D
    w = _randn((d, N), g, scale=1 / math.sqrt(d))
    norm, mm = rmsnorm_op(B, d, bm=B), matmul_1d_op(B, d, N, bm=B)
    chain = stitch.stitch(norm, mm, "x")
    (got,) = hfuse.run_single(chain)(x, scale, w)
    (mid,) = hfuse.run_single(norm)(x, scale)
    (sep,) = hfuse.run_single(mm)(mid, w)
    assert torch.equal(got, sep)
    _close_bf16(got, hfuse.run_single(chain, plain=True)(x, scale, w)[0])
    # epilogue chain
    gated = fn is elementwise.silu_gate
    f_in = 2 * f if gated else f
    w_in = _randn((d, f_in), g, scale=1 / math.sqrt(d))
    proj = matmul_1d_op(B, d, f_in, bm=B)
    act = elementwise.activation_op(B, f_in, f, fn, bm=B)
    chain = stitch.stitch(proj, act, "h")
    (got,) = hfuse.run_single(chain)(x, w_in)
    (h,) = hfuse.run_single(proj)(x, w_in)
    (sep,) = hfuse.run_single(act)(h)
    assert torch.equal(got, sep)
    _close_bf16(got, hfuse.run_single(chain, plain=True)(x, w_in)[0])


def _decode_lens(kind, B, S):
    """Per-slot lengths: "spread" 1..S evenly; "edges" a zero-length slot,
    a slot at S and lengths at the 256-position split boundaries +-1 (as
    many as B slots hold, those past S left out)."""
    if kind == "spread":
        return torch.linspace(1, S, B).round().to(torch.int32)
    ks = kv_split()
    edges = [x for x in (0, S, ks - 1, ks, ks + 1, 1, S - 1, 2 * ks + 1)
             if x <= S]
    return torch.tensor((edges * B)[:B], dtype=torch.int32)


# the widths decode attention is checked at, and head dim 72 at granite's
# heads (a row of 9 16-byte chunks, 16 lanes a row)
DECODE_WIDTHS = [("full", None), ("phi", None), ("reduced", None),
                 ("full", 72)]


def _decode_shape(width, D):
    B, _d, H, Hkv, D0, _f, S = WIDTHS[width]
    return B, H, Hkv, D or D0, S


@pytest.mark.parametrize("lens", ["spread", "edges"])
@pytest.mark.parametrize("width,D", DECODE_WIDTHS)
def test_decode_attention_member(cuda_dev, width, D, lens):
    B, H, Hkv, D, S = _decode_shape(width, D)
    g = _gen(4)
    length = _decode_lens(lens, B, S).reshape(B, 1).cuda()
    q = _randn((B, H, D), g)
    k = _randn((B, S, Hkv, D), g)
    v = _randn((B, S, Hkv, D), g)
    op = decode_attention_op(B, S, H, Hkv, D, ck=min(S, 1024),
                             dynamic_length=True)
    got, want = _kernel_vs_plain(op, length, q, k, v)
    for a, b in zip(got, want):
        _close_f32(a, b)
    # the splits' fixed-order combine: the same bits launch to launch
    assert _same(got, hfuse.run_single(op)(length, q, k, v))


@pytest.mark.parametrize("off,C", [(0, None), ("mid", None), (7, 5)])
@pytest.mark.parametrize("width", sorted(WIDTHS))
def test_prefill_attention_member(cuda_dev, width, off, C):
    _B, _d, H, Hkv, D, _f, S = WIDTHS[width]
    C = C or S // 4
    off = S // 2 if off == "mid" else off
    g = _gen(5)
    q = _randn((C, H, D), g)
    k = _randn((S, Hkv, D), g)
    v = _randn((S, Hkv, D), g)
    offa = torch.full((1, 1), off, dtype=torch.int32, device="cuda")
    op = prefill_attention_op(C, S, H, Hkv, D, ck=min(S, 1024))
    got, want = _kernel_vs_plain(op, offa, q, k, v)
    for a, b in zip(got, want):
        _close_f32(a, b)


@pytest.mark.parametrize("D", [72, 128])
@pytest.mark.parametrize("H,Hkv,C,off", [(32, 8, 512, 0), (32, 8, 512, 1024),
                                         (6, 2, 100, 37)])
def test_prefill_attention_member_head_dims(cuda_dev, H, Hkv, C, off, D):
    """Head dims past granite's on the tensor-core route: 128 (two kv parts
    of 32 keys a warp) and 72 (the contraction zero-padded to 80), at
    granite's heads with a late chunk and at rep 3 with a part last row
    tile (300 rows, 64 a CTA)."""
    S = 2048
    g = _gen(16)
    q = _randn((C, H, D), g)
    k, v = _randn((S, Hkv, D), g), _randn((S, Hkv, D), g)
    offa = torch.full((1, 1), off, dtype=torch.int32, device="cuda")
    op = prefill_attention_op(C, S, H, Hkv, D, ck=1024)
    got, want = _kernel_vs_plain(op, offa, q, k, v)
    for a, b in zip(got, want):
        _close_f32(a, b)


def _device_kernels(run) -> set[str]:
    """The names of the kernels ``run()`` puts on the card (torch.profiler).
    One PyTorch kernel runs first in the session: on the H100 a session
    after the process's first one has dropped the first kernel it saw."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        torch.zeros(1, device="cuda").add_(1)
        torch.cuda.synchronize()
        run()
        torch.cuda.synchronize()
    return {e.key for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA}


def test_attention_tensor_core_routes(cuda_dev):
    """bf16 flash attention, the prefill member and the grouped expert FFN
    run on the tensor cores.  A bf16 flash launch runs flash_mma_kernel and
    an fp32 one flash_f32_kernel (the kernels' names in a profiler trace),
    each counted once.  The bf16 kernels hold HMMA in their SASS and the
    fp32 one none; so do both bundle instances, and inside each the prefill
    bodies and the moe_gmm bodies, one per 8-row group count (their spans
    from the ELF symbol table); a prefill member launch is counted."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels.prefill_attention import PREFILL
    g = _gen(17)
    for dtype, runs, not_runs in ((BF, "flash_mma_kernel", "flash_f32"),
                                  (F32, "flash_f32_kernel", "flash_mma")):
        q = _randn((1, 128, 4, 64), g, dtype)
        before = fa.FLASH.launches
        ran = _device_kernels(lambda: fa.flash_attention_bshd(q, q, q))
        assert any(runs in k for k in ran), ran
        assert not any(not_runs in k for k in ran), ran
        assert fa.FLASH.launches == before + 1
    hmma = cuda.sass_counts("HMMA")
    assert hmma is not None, "the toolkit has no cuobjdump"

    def count(key, body=False):
        return [n for f, n in hmma.items() if key in f and ("$" in f) == body]
    for key in ("flash_mma_kernelILi64E", "flash_mma_kernelILi128E",
                "hf_bundleILb0E", "hf_bundleILb1E"):
        assert count(key) and all(n > 0 for n in count(key)), (key, hmma)
    for key in ("prefill_mmaILi64E", "prefill_mmaILi128E",
                *(f"moe_gmm_mmaILi{n}E" for n in range(1, 6))):
        assert len(count(key, True)) == 2, (key, hmma)
        assert all(n > 0 for n in count(key, True)), (key, hmma)
    assert count("flash_f32_kernel") == [0]
    before = PREFILL.launches
    op = prefill_attention_op(64, 256, 4, 2, 64, ck=256)
    offa = torch.zeros((1, 1), dtype=torch.int32, device="cuda")
    hfuse.run_single(op)(offa, _randn((64, 4, 64), g),
                         _randn((256, 2, 64), g), _randn((256, 2, 64), g))
    assert PREFILL.launches == before + 1


@pytest.mark.parametrize("ratios", [(1, 1), (8, 1), (1, 8), (3, 5)])
def test_fused_bundle_bitwise_equals_native(cuda_dev, ratios):
    """decode attention + prefill attention, and the FFN chain + prefill
    attention, at full width: one fused launch equals the members launched
    alone, bit for bit, under any ratio."""
    B, d, H, Hkv, D, f, S = WIDTHS["full"]
    C = 512
    g = _gen(6)
    length = torch.linspace(1, S, B).round().to(torch.int32).reshape(B, 1)
    dec_in = (length.cuda(), _randn((B, H, D), g), _randn((B, S, Hkv, D), g),
              _randn((B, S, Hkv, D), g))
    pf_in = (torch.full((1, 1), 1024, dtype=torch.int32, device="cuda"),
             _randn((C, H, D), g), _randn((S, Hkv, D), g),
             _randn((S, Hkv, D), g))
    ffn = stitch.stitch(matmul_1d_op(B, d, 2 * f, bm=B),
                        elementwise.activation_op(B, 2 * f, f,
                                                  elementwise.silu_gate,
                                                  bm=B), "h")
    ffn_in = (_randn((B, d), g), _randn((d, 2 * f), g, scale=d ** -0.5))
    dec = decode_attention_op(B, S, H, Hkv, D, ck=1024, dynamic_length=True)
    pf = prefill_attention_op(C, S, H, Hkv, D, ck=1024)
    for ops, ins in (((dec, pf), dec_in + pf_in), ((ffn, pf), ffn_in + pf_in)):
        fused = hfuse.generate(ops, Schedule(ratios))(*ins)
        native = hfuse.run_native(ops)(*ins)
        assert len(fused) == len(native)
        for a, b in zip(fused, native):
            assert torch.equal(a, b)


def test_launch_counts_and_cpu_plain_route(cuda_dev):
    """A launch bumps the bundle launcher's count and each carried member
    kernel's once; plain=True launches nothing."""
    B, d = 8, 256
    op = rmsnorm_op(B, d, bm=B)
    x = _randn((B, d), _gen(7))
    scale = torch.zeros((1, d), device="cuda")
    kernels = (hfuse.BUNDLE, op.member.kernel)
    before = [k.launches for k in kernels]
    hfuse.run_single(op)(x, scale)
    hfuse.run_single(op, plain=True)(x, scale)
    assert [k.launches - b for k, b in zip(kernels, before)] == [1, 1]


def test_wrong_dtype_raises(cuda_dev):
    op = rmsnorm_op(8, 64, dtype=torch.float16, bm=8)
    x = torch.zeros((8, 64), dtype=torch.float16, device="cuda")
    with pytest.raises(ValueError, match="dtype"):
        hfuse.run_single(op)(x, torch.zeros((1, 64), device="cuda"))


# ---------------------------------------------------------------------------
# AdamW member (csrc/adamw_member.cuh): bitwise against its plain version
# ---------------------------------------------------------------------------
def _adam_state(R, dtype, g):
    p = _randn((R, 128), g, dtype)
    grad = _randn((R, 128), g, dtype, 0.1)
    m = _randn((R, 128), g, torch.float32, 1e-2)
    v = torch.rand((R, 128), generator=g, device="cuda") * 1e-3
    sc = torch.zeros((1, 128), device="cuda")
    sc[0, :3] = torch.tensor([3e-3, 1 - 0.9 ** 3, 1 - 0.95 ** 3])
    return sc, p, grad, m, v


@pytest.mark.parametrize("dtype", [BF, torch.float32])
@pytest.mark.parametrize("R,bm", [(1, 1), (37, 37), (3 * 1024, 1024),
                                  (5 * 48, 48)])
def test_adamw_member_bitwise_in_place(cuda_dev, R, bm, dtype):
    """Odd row counts and block sizes; p, m, v written in place; equal to
    the plain version bit for bit (same operation order, RN intrinsics)."""
    from repro_torch.kernels import adam
    ins = _adam_state(R, dtype, _gen(8))
    op = adam.adamw_op(R, dtype, bm)
    plain_ins = [t.clone() for t in ins]
    got = hfuse.run_single(op)(*ins)
    want = hfuse.run_single(op, plain=True)(*plain_ins)
    assert got[0].data_ptr() == ins[1].data_ptr()
    assert got[1].data_ptr() == ins[3].data_ptr()
    assert got[2].data_ptr() == ins[4].data_ptr()
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def test_multi_tensor_adamw_padded_leaves_bitwise(cuda_dev):
    """An 8-leaf tree with ragged tails (padded copies written back) and
    exact leaves (views): the one 8-member launch equals the 8 singles."""
    from repro_torch.kernels import adam
    g = _gen(9)
    shapes = [(3, 1000), (7,), (4, 256), (2, 3, 129), (1024, 128), (5,),
              (300, 7), (64, 64)]
    params = {f"l{i}": _randn(s, g, BF if i % 2 else torch.float32)
              for i, s in enumerate(shapes)}
    grads = {k: _randn(p.shape, g, p.dtype, 0.1) for k, p in params.items()}
    m = {k: _randn(p.shape, g, torch.float32, 1e-2)
         for k, p in params.items()}
    v = {k: torch.rand(p.shape, generator=g, device="cuda") * 1e-3
         for k, p in params.items()}
    sc = _adam_state(1, BF, g)[0]
    copies = [{k: t.clone() for k, t in tr.items()} for tr in (params, m, v)]
    singles = [{k: t.clone() for k, t in tr.items()} for tr in copies]
    before = hfuse.BUNDLE.launches
    adam.multi_tensor_adamw(params, grads, m, v, sc, bm=256)
    assert hfuse.BUNDLE.launches == before + 1
    adam.multi_tensor_adamw(*copies[:1], grads, *copies[1:], sc, bm=256,
                            plain=True)
    for got, want in zip((params, m, v), copies):
        for k in got:
            assert torch.equal(got[k], want[k]), k
    # the 8 singles, launched one by one, give the same bits
    for k in params:
        adam.multi_tensor_adamw({k: singles[0][k]}, {k: grads[k]},
                                {k: singles[1][k]}, {k: singles[2][k]}, sc,
                                bm=256)
    for got, want in zip(copies, singles):
        assert all(torch.equal(got[k], want[k]) for k in got)


@pytest.mark.parametrize("M,K,N", [(256, 64, 128), (40, 512, 256),
                                   (2048, 256, 128)])
@pytest.mark.parametrize("dtype", [BF, F32])
def test_dw_adamw_chain_launch_raises(cuda_dev, dtype, M, K, N):
    """The dW->AdamW chain launches: bitwise equal to the dW GEMM, its
    gradient stored, then the AdamW update (p, m, v in place), bf16 and
    fp32; M 256 spans four row blocks of the bf16 GEMM, M 40 is the
    stacked norm scales' shape, M 2048 a layer's dW rows."""
    from repro_torch.kernels import adam, row
    R = M * N // 128
    dw = matmul_1d_op(M, K, N, dtype, bm=M)
    upd = adam.adamw_op(R, dtype, bm=R)
    chain = stitch.stitch(dw, upd, "g")
    assert isinstance(chain.member, row.RowChain)
    g = _gen(10)
    x, dy = _randn((M, K), g, dtype), _randn((K, N), g, dtype, K ** -0.5)
    sc, p, _g, m, v = _adam_state(R, dtype, g)
    a = [t.clone() for t in (p, m, v)]
    before = row.ROW.launches
    out = hfuse.run_single(chain)(x, dy, sc, *a)
    assert row.ROW.launches == before + 1
    assert all(o.data_ptr() == t.data_ptr() for o, t in zip(out, a))
    (grad,) = hfuse.run_single(dw)(x, dy)
    b = [t.clone() for t in (p, m, v)]
    hfuse.run_single(upd)(sc, b[0], grad.reshape(R, 128), b[1], b[2])
    for got, want in zip(a, b):
        assert torch.equal(got, want)


def _sweep_ops(M, d, dtype):
    """Row-family ops of one dtype at M rows and width d (grid 1), plus
    the AdamW update of an (M, d) gradient."""
    from repro_torch.kernels import adam
    ops = {"rmsnorm": rmsnorm_op(M, d, dtype, bm=M),
           "resadd": elementwise.residual_add_op(M, d, dtype, bm=M),
           "act_silu": elementwise.activation_op(
               M, 2 * d, d, elementwise.silu_gate, dtype, bm=M),
           "act_gelu": elementwise.activation_op(
               M, d, d, elementwise.gelu_plain, dtype, bm=M),
           "mm_dd": matmul_1d_op(M, d, d, dtype, bm=M),
           "mm_d2d": matmul_1d_op(M, d, 2 * d, dtype, bm=M),
           "adamw": adam.adamw_op(M * d // 128, dtype, bm=M * d // 128)}
    return {k: _renamed(o, k) for k, o in ops.items()}


def _renamed(op, name):
    return dataclasses.replace(op, name=name)


def _chain_cases(M, d):
    """Every (producer, consumer, operand) of the sweep ops that
    ``can_stitch`` accepts, in both dtypes."""
    cases = []
    for dtype in (BF, F32):
        ops = _sweep_ops(M, d, dtype)
        for p, pop in ops.items():
            for c, cop in ops.items():
                cop = _renamed(cop, c + "_2") if c == p else cop
                for name in cop.in_names:
                    if stitch.can_stitch(pop, cop, name) is None:
                        cases.append((dtype, pop, cop, name))
    return cases


def _inputs_for(op, g):
    ins = []
    for name, o in zip(op.in_names, op.inputs):
        if name == "scalars":
            t = torch.zeros(o.shape, device="cuda")
            t[0, :3] = torch.tensor([1e-3, 0.1, 0.05])
        elif name == "v":
            t = torch.rand(o.shape, generator=g, device="cuda")
        elif name == "w":
            t = _randn(o.shape, g, o.dtype, o.shape[0] ** -0.5)
        else:
            t = _randn(o.shape, g, o.dtype, 0.3 if name == "scale" else 1.0)
        ins.append(t)
    return ins


@pytest.mark.parametrize("M,d", [(8, 256), (72, 128)])
def test_every_chain_bitwise_equal_separate_members(cuda_dev, M, d):
    """Each chain the stitching contract accepts among rmsnorm, the two
    activations, the residual add, the two GEMMs and the AdamW update, bf16
    and fp32: one launch of the row kernel, bitwise equal to its two
    members launched separately, and within tolerance of its plain route.
    M 72 spans two row blocks of the bf16 GEMM and ends in a part block."""
    from repro_torch.kernels import row
    cases = _chain_cases(M, d)
    kinds = {(p.member.sub if hasattr(p.member, "sub") else "adamw",
              c.member.sub if hasattr(c.member, "sub") else "adamw")
             for _dt, p, c, _n in cases}
    assert len(kinds) >= 15, kinds
    for dtype, pop, cop, name in cases:
        chain = stitch.stitch(pop, cop, name)
        g = _gen(40)
        ins = _inputs_for(chain, g)
        a = [t.clone() for t in ins]
        before = row.ROW.launches
        got = hfuse.run_single(chain)(*a)
        assert row.ROW.launches == before + 1
        b = [t.clone() for t in ins]
        n_pi = len(pop.inputs)
        (mid,) = hfuse.run_single(pop)(*b[:n_pi])
        sidx = cop.in_names.index(name)
        rest = b[n_pi:]
        want = hfuse.run_single(cop)(*rest[:sidx],
                                      mid.reshape(cop.inputs[sidx].shape),
                                      *rest[sidx:])
        label = f"{pop.name}->{cop.name}.{name} {dtype}"
        assert all(torch.equal(x, y) for x, y in zip(got, want)), label
        c = [t.clone() for t in ins]
        plain = hfuse.run_single(chain, plain=True)(*c)
        for x, y in zip(got, plain):
            _close(x, y)


@pytest.mark.parametrize("dtype", [BF, F32])
def test_reshaped_chains_bitwise(cuda_dev, dtype):
    """The row-stream reshape: (64, 256) producers feeding a (128, 128)
    norm, a (32, 512) gated activation and a (128, 128) residual add, and a
    GEMM's (64, 128) product into a (32, 256) norm; a (64, 256) norm and a
    (64, 256) residual add staged as the x of GEMMs of other row widths."""
    g = _gen(41)
    add = _renamed(elementwise.residual_add_op(64, 256, dtype, bm=64), "add")
    norm = rmsnorm_op(64, 256, dtype, bm=64)
    pairs = [(add, rmsnorm_op(128, 128, dtype, bm=128), "x"),
             (add, elementwise.activation_op(32, 512, 256,
                                             elementwise.silu_gate, dtype,
                                             bm=32), "h"),
             (norm, elementwise.residual_add_op(128, 128, dtype, bm=128),
              "res"),
             (matmul_1d_op(64, 64, 128, dtype, bm=64),
              rmsnorm_op(32, 256, dtype, bm=32), "x"),
             (norm, matmul_1d_op(128, 128, 128, dtype, bm=128), "x"),
             (add, matmul_1d_op(32, 512, 128, dtype, bm=32), "x")]
    for pop, cop, name in pairs:
        chain = stitch.stitch(pop, cop, name)
        ins = _inputs_for(chain, g)
        (got,) = hfuse.run_single(chain)(*ins)
        n_pi = len(pop.inputs)
        (mid,) = hfuse.run_single(pop)(*ins[:n_pi])
        sidx = cop.in_names.index(name)
        rest = ins[n_pi:]
        (want,) = hfuse.run_single(cop)(*rest[:sidx],
                                        mid.reshape(cop.inputs[sidx].shape),
                                        *rest[sidx:])
        assert torch.equal(got, want), (pop.name, cop.name)


@pytest.mark.parametrize("ratios", [(1,) * 8, (3, 1, 2, 1, 1, 2, 1, 1)])
def test_chain_bundle_bitwise_equal_native(cuda_dev, ratios):
    """Chains that run only in the bundle kernel's chain instance (a dW
    GEMM -> AdamW, GEMM -> rmsnorm through the workspace, a row-wise pair,
    the fp32 GEMM's epilogues and staged producer) beside a GEMM prologue
    chain and the AdamW member, in one launch: bitwise equal to run_native
    of the same members."""
    from repro_torch.kernels import adam
    M, d = 8, 256
    bf, f32 = _sweep_ops(M, d, BF), _sweep_ops(M, d, F32)
    dw = _renamed(matmul_1d_op(256, 64, 128, BF, bm=256), "dw")
    dw_upd = _renamed(adam.adamw_op(256, BF, bm=256), "dw_upd")
    ops = [stitch.stitch(dw, dw_upd, "g"),
           stitch.stitch(bf["mm_dd"], bf["rmsnorm"], "x"),
           stitch.stitch(bf["resadd"], bf["rmsnorm"], "x"),
           stitch.stitch(bf["rmsnorm"], bf["mm_d2d"], "x"),
           stitch.stitch(f32["mm_dd"], f32["adamw"], "g"),
           stitch.stitch(f32["mm_dd"], f32["rmsnorm"], "x"),
           stitch.stitch(f32["rmsnorm"], f32["mm_dd"], "x"),
           bf["adamw"]]
    g = _gen(42)
    ins = [t for op in ops for t in _inputs_for(op, g)]
    got = hfuse.generate(ops, Schedule(ratios))(*[t.clone() for t in ins])
    want = hfuse.run_native(ops)(*[t.clone() for t in ins])
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def test_make_measure_gpu_times_are_positive_and_repeatable(cuda_dev):
    from repro_torch.core import timing
    from repro_torch.kernels import adam
    ops = [adam.adamw_op(4096, bm=1024, name="a"),
           adam.adamw_op(2048, bm=1024, name="b")]
    measure = timing.make_measure("gpu", repeats=9)
    fused = hfuse.generate(ops, Schedule((1, 1)))
    ts = [measure(fused, *ops) for _ in range(3)]
    assert all(t > 0 for t in ts)
    assert max(ts) <= 3 * min(ts), ts


# ---------------------------------------------------------------------------
# The paper suite (tolerances: paper_suite.TOLERANCE; fused launches bitwise)
# ---------------------------------------------------------------------------
def _paper_inputs(ops, mks, seed):
    g = _gen(seed)
    return [t for mk in mks for t in mk(g, "cuda")]


@pytest.mark.parametrize("dtype", [torch.float32, BF])
@pytest.mark.parametrize("size", ["small", "default"])
@pytest.mark.parametrize("name", ["maxpool", "upsample", "bnstats", "im2col",
                                  "hist", "ethash_like", "sha_like",
                                  "blake_like", "blake2b_like"])
def test_paper_member(cuda_dev, name, size, dtype):
    from repro_torch.kernels import paper_suite as ps
    kw = dict(ps.SMALL_KW[name]) if size == "small" else {}
    op, mk, plain = ps.ALL_KERNELS[name](**kw, dtype=dtype)
    ins = _paper_inputs([op], [mk], 20)
    if dtype == BF and name not in ("maxpool", "upsample", "bnstats",
                                    "im2col", "hist"):
        with pytest.raises(ValueError, match="takes"):
            hfuse.run_single(op)(*ins)
        return
    got = hfuse.run_single(op)(*ins)
    torch.cuda.synchronize()
    ps.max_error(got[0], plain(*ins), op.member.body)
    # the carry is reproducible launch to launch (fixed-order combine)
    assert torch.equal(got[0], hfuse.run_single(op)(*ins)[0])
    if name == "hist":
        assert float(got[0].sum()) == op.inputs[0].shape[0] * \
            op.inputs[0].shape[1]


def _paper_bundle(names):
    from repro_torch.kernels import paper_suite as ps
    ops, mks, _ = ps.make_bundle(names)
    return tuple(ops), _paper_inputs(ops, mks, 21)


def _same(a, b):
    return len(a) == len(b) and all(torch.equal(x, y) for x, y in zip(a, b))


@pytest.mark.parametrize("planned", [False, True])
@pytest.mark.parametrize("names", [
    ("maxpool", "bnstats"), ("maxpool", "upsample"), ("maxpool", "im2col"),
    ("maxpool", "hist"), ("bnstats", "upsample"), ("bnstats", "im2col"),
    ("bnstats", "hist"), ("upsample", "im2col"), ("upsample", "hist"),
    ("im2col", "hist"), ("ethash_like", "sha_like"),
    ("ethash_like", "blake_like"), ("ethash_like", "blake2b_like"),
    ("sha_like", "blake_like"), ("sha_like", "blake2b_like"),
    ("blake_like", "blake2b_like")], ids="+".join)
def test_paper_pairs_bitwise_equal_native(cuda_dev, names, planned):
    from repro_torch.core import autotuner
    ops, ins = _paper_bundle(names)
    native = hfuse.run_native(ops)(*ins)
    if planned:
        res = autotuner.search(ops)
        fused = res.build()(*ins)
    else:
        fused = hfuse.generate(ops, Schedule((1, 1)))(*ins)
    assert _same(fused, native)


@pytest.mark.parametrize("names", [("ethash_like", "hist", "blake_like"),
                                   ("maxpool", "upsample", "sha_like"),
                                   ("bnstats", "im2col", "blake2b_like")],
                         ids="+".join)
def test_paper_vfused_bitwise_equal_native(cuda_dev, names):
    ops, ins = _paper_bundle(names)
    vf = hfuse.generate_vfused(ops)
    assert vf.n_steps == sum(op.ctas for op in ops)
    assert _same(vf(*ins), hfuse.run_native(ops)(*ins))


def test_paper_launch_beyond_resident_capacity_finishes(cuda_dev):
    """ethash_like + blake_like at 16:1: 2176 CTAs, far more than fit on the
    card at once (80 KB of shared memory each); no carry waits on a CTA that
    is not yet scheduled, so the launch finishes and matches native."""
    ops, ins = _paper_bundle(("ethash_like", "blake_like"))
    fused = hfuse.generate(ops, Schedule((16, 1)))
    smem = max(cuda.member_smem(op.member) for op in ops)
    resident = cuda.occupancy(smem) * torch.cuda.get_device_properties(
        0).multi_processor_count
    assert fused.n_steps > resident
    out = fused(*ins)
    torch.cuda.synchronize()
    assert _same(out, hfuse.run_native(ops)(*ins))


@pytest.mark.parametrize("rounds", [1, 24])
@pytest.mark.parametrize("R,bm", [(32, 32), (4096, 512), (4096, 256)])
def test_hash_member_w_in_registers(cuda_dev, R, bm, rounds):
    """hash_like with w held in registers (csrc/paper_member.cuh): one CTA
    (R 32), the defaults and a non-default block, x scaled x10 so that the
    first round's tanh saturates; within paper_suite.TOLERANCE of the plain
    version, two launches bitwise equal, 16 CTAs a grid step of 32 rows."""
    from repro_torch.kernels import paper_suite as ps
    op, mk, plain = ps._make_hash_like("sha_like", rounds, R=R, bm=bm)
    assert op.ctas == R // ps.TILE_R
    x, w = mk(_gen(40 + rounds), "cuda")
    x = x * 10.0
    (got,) = hfuse.run_single(op)(x, w)
    torch.cuda.synchronize()
    want = plain(x, w)
    ps.max_error(got, want, "hash_like")
    if rounds == 1:
        assert float(want.abs().max()) > 0.99
    assert torch.equal(got, hfuse.run_single(op)(x, w)[0])


@pytest.mark.parametrize("ratios", [(1, 1), (4, 1), (1, 3)])
@pytest.mark.parametrize("partner", ["maxpool", "ethash_like"])
@pytest.mark.parametrize("name", ["sha_like", "blake_like", "blake2b_like"])
def test_hash_fused_bitwise_equal_alone(cuda_dev, name, partner, ratios):
    """Each hash variant fused beside a streaming member (maxpool) and
    beside ethash_like, at three ratios: every output bitwise equal to the
    members launched alone."""
    ops, ins = _paper_bundle((partner, name))
    fused = hfuse.generate(ops, Schedule(ratios))(*ins)
    assert _same(fused, hfuse.run_native(ops)(*ins))


@pytest.mark.parametrize("names", [("ethash_like", "hist", "blake_like"),
                                   ("maxpool", "upsample", "sha_like")],
                         ids="+".join)
@pytest.mark.parametrize("ratios", [None, (1, 1, 1), (3, 1, 2)])
def test_paper_triples_bitwise_equal_native(cuda_dev, names, ratios):
    """The triples holding hist or maxpool, at the planner's schedule and
    at two fixed ones: every output bitwise equal to the members launched
    alone."""
    from repro_torch.core import autotuner
    ops, ins = _paper_bundle(names)
    fused = (autotuner.search(ops).build() if ratios is None
             else hfuse.generate(ops, Schedule(ratios)))
    assert _same(fused(*ins), hfuse.run_native(ops)(*ins))


# (kw of make_hist, data): defaults, SMALL_KW, odd rows a CTA and bins,
# every value in one bin, every value clipped, NaN and +-inf
HIST_CASES = [({}, "normal"), ("small", "normal"),
              (dict(R=192, C=264, bm=48, bins=100), "normal"),
              (dict(R=120, C=8, bm=24, bins=7), "normal"),
              ({}, "one_bin"), ({}, "clipped"), ("small", "special")]


def _hist_data(x, data):
    if data == "one_bin":
        return torch.full_like(x, 0.1)
    if data == "clipped":
        return torch.where(x > 0, 40.0, -40.0).to(x.dtype)
    if data == "special":
        x = x.clone()
        flat = x.view(-1)
        for j, v in enumerate([float("nan"), float("inf"), -float("inf"),
                               4.0, -4.0, 7.5, -12.0] * 9):
            flat[(j * 97 + 13) % flat.numel()] = v
    return x


@pytest.mark.parametrize("dtype", [F32, BF])
@pytest.mark.parametrize("kw,data", HIST_CASES,
                         ids=lambda v: v if isinstance(v, str) else
                         "-".join(f"{k}{x}" for k, x in v.items())
                         or "default")
def test_hist_one_wave(cuda_dev, kw, data, dtype):
    """hist redesigned (csrc/paper_member.cuh hist_cta): HIST_CTAS_PER_STEP
    CTAs a grid step, per-warp counts, one global copy of the counts;
    bitwise equal to the plain version in both dtypes, two launches equal,
    the counts and the ticket back at zero; a one-member launch runs
    hf_paper."""
    from repro_torch.kernels import paper_suite as ps
    kw = dict(ps.SMALL_KW["hist"]) if kw == "small" else dict(kw)
    op, mk, plain = ps.make_hist(**kw, dtype=dtype)
    assert op.ctas == op.grid * ps.HIST_CTAS_PER_STEP
    (x,) = mk(_gen(80), "cuda")
    x = _hist_data(x, data)
    run = hfuse.run_single(op)
    (got,) = run(x)
    torch.cuda.synchronize()
    want = plain(x)
    assert torch.equal(got, want)
    assert float(got.sum()) == x.numel()
    assert torch.equal(run(x)[0], got)
    torch.cuda.synchronize()
    (ws,) = _paper_workspaces(op.member)
    assert int(ws[0].abs().sum()) == 0 and int(ws[1].abs().sum()) == 0
    out = torch.empty(op.outputs[0].shape, device="cuda")
    assert cuda.launch_instance([op.member], [(x,)], [(out,)])[0] == \
        "hf_paper"


# (R, C, bm) of make_maxpool: SMALL_KW, the defaults, 24 CTAs of 4 rows at
# C 136 (17 bf16 vectors a row), 2 rows a CTA at C 8
MAXPOOL_SHAPES = [(256, 128, 64), (8192, 512, 256), (96, 136, 48),
                  (64, 8, 4)]


@pytest.mark.parametrize("dtype", [F32, BF])
@pytest.mark.parametrize("R,C,bm", MAXPOOL_SHAPES, ids=str)
def test_maxpool_propagates_nan(cuda_dev, R, C, bm, dtype):
    """maxpool with NaN in the first row of a pair, in the second, in both,
    and +-inf: bitwise equal to the plain version (torch.amax) with NaN
    compared equal, in both dtypes."""
    from repro_torch.kernels import paper_suite as ps
    op, mk, plain = ps.make_maxpool(R=R, C=C, bm=bm, dtype=dtype)
    (x,) = mk(_gen(90 + C), "cuda")
    nan, inf = float("nan"), float("inf")
    x[0, 0], x[1, 1], x[2, 2], x[3, 2] = nan, nan, nan, nan
    x[0, 3], x[1, 4], x[3, 5] = -inf, inf, nan
    x[R - 1, C - 1], x[R - 4, 0], x[R - 3, 0] = nan, inf, -inf
    (got,) = hfuse.run_single(op)(x)
    torch.cuda.synchronize()
    want = plain(x)
    assert bool(got[0, :2].isnan().all()) and bool(got[1, 2].isnan())
    assert bool(got[1, 5].isnan()) and bool(got[R // 2 - 1, C - 1].isnan())
    assert torch.equal(got.isnan(), want.isnan())
    torch.testing.assert_close(got, want, rtol=0, atol=0, equal_nan=True)


# (R, C, bm) of upsample and im2col: SMALL_KW, the defaults, 3 rows a CTA
# at C 136 (34 fp32 / 17 bf16 vectors a row), one row a CTA at C 8
STREAM_SHAPES = [(256, 128, 64), (4096, 512, 256), (96, 136, 48),
                 (32, 8, 16)]


@pytest.mark.parametrize("dtype", [F32, BF])
@pytest.mark.parametrize("R,C,bm", STREAM_SHAPES, ids=str)
@pytest.mark.parametrize("name", ["upsample", "im2col"])
def test_stream_members_bitwise(cuda_dev, name, R, C, bm, dtype):
    """upsample and im2col (csrc/paper_member.cuh upsample_member,
    im2col_rows) bitwise equal to their plain versions in both dtypes, two
    launches equal; a one-member launch runs hf_paper at two CTAs an SM or
    more and reserves no shared memory."""
    from repro_torch.kernels import paper_suite as ps
    op, mk, plain = ps.ALL_KERNELS[name](R=R, C=C, bm=bm, dtype=dtype)
    (x,) = mk(_gen(100 + C), "cuda")
    run = hfuse.run_single(op)
    (got,) = run(x)
    torch.cuda.synchronize()
    assert torch.equal(got, plain(x))
    assert torch.equal(run(x)[0], got)
    out = torch.empty(op.outputs[0].shape, dtype=dtype, device="cuda")
    inst, per_sm = cuda.launch_instance([op.member], [(x,)], [(out,)])
    assert inst == "hf_paper" and per_sm >= 2
    assert cuda.member_smem(op.member) == 0


@pytest.mark.parametrize("K", ["C-1", "C", "C+1", "2C+3"])
@pytest.mark.parametrize("C,dtype", [(4, F32), (8, BF)], ids=str)
def test_im2col_blocks_past_c(cuda_dev, C, dtype, K):
    """Blocks k >= C of im2col are the row itself, as the reference's
    x[:, k:] ++ x[:, :k] gives: bitwise equal to the plain version at K = C
    - 1, C, C + 1 and 2C + 3 (3 rows a CTA), and at the defaults.  A
    rotation by k wrapped once gives block k - C for C < k < 2C and reads
    past the row from 2C on."""
    from repro_torch.kernels import paper_suite as ps
    K = {"C-1": C - 1, "C": C, "C+1": C + 1, "2C+3": 2 * C + 3}[K]
    for kw in (dict(R=96, C=C, bm=48, K=K), {}):
        op, mk, plain = ps.make_im2col(**kw, dtype=dtype)
        (x,) = mk(_gen(110 + K), "cuda")
        (got,) = hfuse.run_single(op)(x)
        torch.cuda.synchronize()
        assert torch.equal(got, plain(x)), kw


def test_paper_instances_do_not_spill(cuda_dev):
    """hf_paper (every paper body; upsample, im2col, maxpool and hist
    inlined) and hf_stream (maxpool) spill nothing (ptxas's report of the
    build)."""
    use = cuda.ptxas_usage()
    for key in ("hf_paper", "hf_stream"):
        (u,) = [v for k, v in use.items() if key in k]
        assert u["spill_stores"] == 0 and u["spill_loads"] == 0, (key, u)


def _paper_workspaces(member):
    """The persistent workspaces (``cuda.workspace``) of a paper member's
    shape."""
    return [ws for k, ws in cuda._WORKSPACES.items()
            if k[2][0] == ("paper", member.body)
            and k[2][1] == member.workspace_sizes()]


# (R_dag, bm, runs (None: the member's), DAG scale)
ETHASH_CASES = [(512, 128, None, 1.0), (65536, 512, None, 1.0),
                (4096, 256, 1, 1.0), (4096, 256, 8, 1.0),
                (65536, 512, None, 10.0)]


@pytest.mark.parametrize("R_dag,bm,runs,scale", ETHASH_CASES,
                         ids=lambda v: str(v))
def test_ethash_3xtf32(cuda_dev, R_dag, bm, runs, scale):
    """ethash_like on 3xTF32 tensor cores (csrc/paper_member.cuh
    ethash_member): SMALL_KW, the defaults, R_dag 4096 / bm 256 at 1 and 8
    runs a slice and the DAG scaled x10 (tanh near saturation), within
    paper_suite.TOLERANCE of the plain version; two launches bitwise equal,
    the persistent workspace reused and its tickets back at zero."""
    from repro_torch.kernels import paper_suite as ps
    op, mk, plain = ps.make_ethash_like(R_dag=R_dag, bm=bm)
    if runs is not None:
        op = dataclasses.replace(op, member=dataclasses.replace(
            op.member, runs=runs))
    dag, x, w = mk(_gen(50 + R_dag // bm), "cuda")
    dag = dag * scale
    run = hfuse.run_single(op)
    (got,) = run(dag, x, w)
    torch.cuda.synchronize()
    want = plain(dag, x, w)
    ps.max_error(got, want, "ethash_like")
    if scale > 1.0:     # tanh pushed toward +-1: sums of a third of +-blocks
        assert float(want.abs().max()) > (R_dag // bm) / 4
    (again,) = run(dag, x, w)
    torch.cuda.synchronize()
    assert torch.equal(got, again)
    (ws,) = _paper_workspaces(op.member)
    assert int(ws[1].abs().sum()) == 0


BNSTATS_SHAPES = [(256, 128, 64), (1024, 256, 128), (4096, 512, 512),
                  (16384, 512, 512), (2048, 384, 256), (1024, 1024, 128)]


@pytest.mark.parametrize("dtype", [F32, BF])
@pytest.mark.parametrize("R,C,bm", BNSTATS_SHAPES, ids=str)
def test_bnstats_one_wave(cuda_dev, R, C, bm, dtype):
    """bnstats as one wave of row-run CTAs with a two-level combine: every
    tested shape (and C 384, 1024: row groups of 2 and 1) in both dtypes
    within paper_suite.TOLERANCE of the plain version, BN_CTAS_PER_STEP
    CTAs a grid step; two launches bitwise equal, every ticket back at
    zero."""
    from repro_torch.kernels import paper_suite as ps
    op, mk, plain = ps.make_bnstats(R=R, C=C, bm=bm, dtype=dtype)
    assert op.ctas == op.grid * ps.BN_CTAS_PER_STEP
    (x,) = mk(_gen(60 + C), "cuda")
    run = hfuse.run_single(op)
    (got,) = run(x)
    torch.cuda.synchronize()
    ps.max_error(got, plain(x), "bnstats")
    assert torch.equal(got, run(x)[0])
    torch.cuda.synchronize()
    (ws,) = _paper_workspaces(op.member)
    assert int(ws[1].abs().sum()) == 0


@pytest.mark.parametrize("name", ["bnstats", "ethash_like", "hist"])
def test_paper_carries_allocate_nothing(cuda_dev, name):
    """The carries' workspaces persist: launches after the first take no
    new workspace and no memory beyond their output, are bitwise equal, and
    leave every ticket (and hist's counts) at zero."""
    from repro_torch.kernels import paper_suite as ps
    op, mk, _plain = ps.ALL_KERNELS[name]()
    ins = mk(_gen(70), "cuda")
    run = hfuse.run_single(op)
    (first,) = run(*ins)
    kept = dict(cuda._WORKSPACES)
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    for _ in range(3):
        (out,) = run(*ins)
    torch.cuda.synchronize()
    assert cuda._WORKSPACES.keys() == kept.keys() and all(
        a is b for k in kept for a, b in zip(kept[k], cuda._WORKSPACES[k]))
    assert torch.cuda.memory_allocated() - before <= \
        out.numel() * out.element_size() + 512
    assert torch.equal(out, first)
    (ws,) = _paper_workspaces(op.member)
    assert int(ws[-1].abs().sum()) == 0
    if name == "hist":
        assert int(ws[0].abs().sum()) == 0


# ---------------------------------------------------------------------------
# Paged attention: bitwise against the contiguous members
# ---------------------------------------------------------------------------
def _paged(k, v, lens, bs, g):
    """An arena holding the contiguous caches k, v (B, S, Hkv, D): blocks
    0..B-1 are the slots' sentinels (random rows, as masked writes leave
    them), each slot's pages below its length sit at shuffled arena blocks
    and its pages past the length point at its own sentinel.  Returns the
    arena k, v, the table (B, S/bs) and the caches the table maps (equal to
    k, v below each length)."""
    B, S, Hkv, D = k.shape
    nper = S // bs
    used = [-(-int(L) // bs) for L in lens]
    nblk = B + sum(used) + 3
    perm = (torch.randperm(nblk - B, generator=torch.Generator().manual_seed(
        bs)) + B).tolist()
    table = torch.arange(B).repeat_interleave(nper).reshape(B, nper).clone()
    ka = _randn((nblk, bs, Hkv, D), g)
    va = _randn((nblk, bs, Hkv, D), g)
    for b in range(B):
        for p in range(used[b]):
            blk = perm.pop()
            table[b, p] = blk
            ka[blk] = k[b, p * bs:(p + 1) * bs]
            va[blk] = v[b, p * bs:(p + 1) * bs]
    bt = table.to(torch.int32).cuda()
    kl = ka[bt.long()].reshape(B, S, Hkv, D)
    vl = va[bt.long()].reshape(B, S, Hkv, D)
    return ka, va, bt, kl, vl


@pytest.mark.parametrize("lens", ["spread", "edges"])
@pytest.mark.parametrize("bs", [4, 16, 64])
@pytest.mark.parametrize("width,D", DECODE_WIDTHS)
def test_paged_decode_bitwise_equals_contiguous(cuda_dev, width, D, bs, lens):
    B, H, Hkv, D, S = _decode_shape(width, D)
    g = _gen(11)
    lens = _decode_lens(lens, B, S)           # slot 0 idle: length 1 or 0
    q = _randn((B, H, D), g)
    k, v = _randn((B, S, Hkv, D), g), _randn((B, S, Hkv, D), g)
    ka, va, bt, kl, vl = _paged(k, v, lens.tolist(), bs, g)
    ck = min(S, 1024)
    length = lens.reshape(B, 1).cuda()
    op = decode_attention_op(B, S, H, Hkv, D, ck=ck, dynamic_length=True,
                             block_table=(ka.shape[0], bs))
    base = decode_attention_op(B, S, H, Hkv, D, ck=ck, dynamic_length=True)
    assert op.ctas == base.ctas
    got, want = _kernel_vs_plain(op, bt, length, q, ka, va)
    for a, b in zip(got, want):
        _close_f32(a, b)
    assert _same(got, hfuse.run_single(base)(length, q, kl, vl))


@pytest.mark.parametrize("off", [0, "mid"])
@pytest.mark.parametrize("bs", [4, 16, 64])
@pytest.mark.parametrize("width", sorted(WIDTHS))
def test_paged_prefill_bitwise_equals_contiguous(cuda_dev, width, bs, off):
    _B, _d, H, Hkv, D, _f, S = WIDTHS[width]
    C = S // 4
    off = S // 2 if off == "mid" else off
    g = _gen(12)
    q = _randn((C, H, D), g)
    k, v = _randn((1, S, Hkv, D), g), _randn((1, S, Hkv, D), g)
    ka, va, bt, kl, vl = _paged(k, v, [off + C], bs, g)
    offa = torch.full((1, 1), off, dtype=torch.int32, device="cuda")
    ck = min(S, 1024)
    op = prefill_attention_op(C, S, H, Hkv, D, ck=ck,
                              block_table=(ka.shape[0], bs))
    base = prefill_attention_op(C, S, H, Hkv, D, ck=ck)
    got, want = _kernel_vs_plain(op, offa, bt, q, ka, va)
    for a, b in zip(got, want):
        _close_f32(a, b)
    assert _same(got, hfuse.run_single(base)(offa, q, kl[0], vl[0]))


# ---------------------------------------------------------------------------
# MoE: the grouped expert FFN and the fp32 router GEMM
# ---------------------------------------------------------------------------
def _gmm_operands(E, C, d, f, g, gated=True):
    fin = 2 * f if gated else f
    return (_randn((E, C, d), g), _randn((E, d, fin), g, scale=d ** -0.5),
            _randn((E, f, d), g, scale=f ** -0.5))


@pytest.mark.parametrize("E,C,d,f,act,gated", [
    (4, 8, 512, 1024, "silu", True), (4, 8, 256, 96, "gelu", True),
    (4, 16, 256, 512, "gelu", False), (16, 8, 4096, 6400, "silu", True),
    (16, 16, 4096, 6400, "silu", True), (16, 32, 4096, 6400, "silu", True),
    (16, 80, 4096, 6400, "silu", True), (16, 128, 4096, 6400, "silu", True),
    (16, 8, 4096, 6400, "gelu", False), (3, 41, 200, 96, "gelu", True)])
def test_moe_gmm_member(cuda_dev, E, C, d, f, act, gated):
    """Decode capacity, one pass of up to 40 token rows (C 16, 32), two and
    four passes (C 80, 128), the non-gated gelu at phi3.5-moe's width, and
    a ragged shape: 2 passes of 24 rows for C 41, d 200 (a part 16-column
    output tile), f 96 (a part 128-column sweep)."""
    ins = _gmm_operands(E, C, d, f, _gen(13), gated)
    op = moe_gmm_op(E, C, d, f, act=act, gated=gated)
    (got,), (want,) = _kernel_vs_plain(op, *ins)
    _close_bf16(got, want)
    # the fixed-order combine gives the same bits launch to launch, and the
    # one-member entry point is the same launch
    assert torch.equal(got, hfuse.run_single(op)(*ins)[0])
    if gated:
        assert torch.equal(got, moe_gmm(*ins, act=act))
    _close_bf16(got, plain_moe_gmm(*ins, act=act, gated=gated))


@pytest.mark.parametrize("N", [16, 72])
@pytest.mark.parametrize("M,K", [(8, 4096), (3, 200)])
def test_fp32_router_gemm(cuda_dev, M, K, N):
    g = _gen(14)
    x = _randn((M, K), g, torch.float32)
    w = _randn((K, N), g, torch.float32, K ** -0.5)
    (got,), (want,) = _kernel_vs_plain(
        matmul_1d_op(M, K, N, torch.float32, bm=M), x, w)
    _close_f32(got, want)


# (M, K, N): the fp32 row GEMM at its split, stage, tile and pass edges:
# W_o at decode (5 slices of 448 rows, the last one part), the router's
# narrow N 16 (64 one-stage slices), N 12 (a 16-column tile, 4 masked), M
# 40 in one pass (5 row groups of 8, 3 k residues) with a part tile (N 72)
# and K off the stage, an odd K (333), two passes (M 136: 128 rows, then 8)
# and three (M 300) over split K, K whole in one slice (132 tiles, K 520
# off the stage), and the stacked norm scales' dW (40 x 8192 @ 8192 x 2048)
F32_GEMM_EDGES = [(8, 2048, 2048), (8, 4096, 16), (3, 200, 12),
                  (40, 1000, 72), (72, 333, 200), (136, 520, 128),
                  (300, 1000, 64), (8, 520, 8448), (40, 8192, 2048)]


def _f32_workspaces(M, K, N, rows=False):
    return [ws for k, ws in cuda._WORKSPACES.items()
            if k[2][0] == ("row_gemm_f32", M, K, N, rows)]


@pytest.mark.parametrize("M,K,N", F32_GEMM_EDGES)
def test_row_gemm_f32_edges(cuda_dev, M, K, N):
    """The fp32 GEMM alone within fp32 tolerance of plain and bitwise equal
    across two launches (its workspace reused, every ticket back at zero);
    its chains bitwise equal to their separate members: the norm prologue
    (x staged by the producer), the residual add epilogue, the EPI_ROWS
    route into an RMSNorm of N columns and, where M x N fills 128-wide
    rows, the AdamW update."""
    from repro_torch.kernels import adam, row
    g = _gen(36)
    x = _randn((M, K), g, F32)
    w = _randn((K, N), g, F32, K ** -0.5)
    mm = matmul_1d_op(M, K, N, F32, bm=M)
    before = row.ROW.launches
    (got,), (want,) = _kernel_vs_plain(mm, x, w)
    assert row.ROW.launches == before + 1
    _close_f32(got, want)
    held = _f32_workspaces(M, K, N)
    (again,) = hfuse.run_single(mm)(x, w)
    assert torch.equal(got, again)
    if mm.member.k_slices > 1:
        assert len(held) == 1 and all(
            a is b for a, b in zip(held[0], _f32_workspaces(M, K, N)[0]))
        torch.cuda.synchronize()
        assert int(held[0][1].abs().sum()) == 0   # every ticket reset
    else:
        assert held == []                         # no split, no workspace
    scale = _randn((1, K), g, F32, 0.1)
    norm = rmsnorm_op(M, K, F32, bm=M)
    (mid,) = hfuse.run_single(norm)(x, scale)
    (sep,) = hfuse.run_single(mm)(mid, w)
    (chain,) = hfuse.run_single(stitch.stitch(norm, mm, "x"))(x, scale, w)
    assert torch.equal(chain, sep)
    res = _randn((M, N), g, F32)
    add = elementwise.residual_add_op(M, N, F32, bm=M)
    (sep,) = hfuse.run_single(add)(got, res)
    (chain,) = hfuse.run_single(stitch.stitch(mm, add, "h"))(x, w, res)
    assert torch.equal(chain, sep)
    nscale = _randn((1, N), g, F32, 0.1)
    norm_n = rmsnorm_op(M, N, F32, bm=M)
    (sep,) = hfuse.run_single(norm_n)(got, nscale)
    (chain,) = hfuse.run_single(stitch.stitch(mm, norm_n, "x"))(x, w, nscale)
    assert torch.equal(chain, sep)
    torch.cuda.synchronize()
    assert all(int(ws[1].abs().sum()) == 0
               for ws in _f32_workspaces(M, K, N, rows=True))
    if M * N % 128:
        return
    R = M * N // 128
    upd = adam.adamw_op(R, F32, bm=R)
    sc, p, _g, m, v = _adam_state(R, F32, g)
    a = [t.clone() for t in (p, m, v)]
    hfuse.run_single(stitch.stitch(mm, upd, "g"))(x, w, sc, *a)
    b = [t.clone() for t in (p, m, v)]
    hfuse.run_single(upd)(sc, b[0], got.reshape(R, 128), b[1], b[2])
    assert all(torch.equal(s, t) for s, t in zip(a, b))


@pytest.mark.parametrize("M,K,N", [(8, 2048, 2048), (8, 4096, 16),
                                   (40, 8192, 2048)])
def test_row_gemm_f32_allocates_nothing(cuda_dev, M, K, N):
    """W_o at decode, the router and the dW fill the card (the router as
    far as its 64 stages of K allow) and a launch after the first takes no
    new workspace: the persistent one, every ticket back at zero."""
    mm = matmul_1d_op(M, K, N, F32, bm=M)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    assert mm.member.ctas >= min(sms, -(-K // 64)), mm.member.ctas
    g = _gen(37)
    x, w = _randn((M, K), g, F32), _randn((K, N), g, F32, K ** -0.5)
    run = hfuse.run_single(mm)
    (first,) = run(x, w)
    kept = dict(cuda._WORKSPACES)
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    for _ in range(3):
        (out,) = run(x, w)
    torch.cuda.synchronize()
    assert cuda._WORKSPACES.keys() == kept.keys() and all(
        a is b for k in kept for a, b in zip(kept[k], cuda._WORKSPACES[k]))
    # the only new memory is the last output, the earlier ones freed
    assert torch.cuda.memory_allocated() - before <= out.numel() * 4 + 512
    assert torch.equal(out, first)
    assert all(int(ws[1].abs().sum()) == 0
               for ws in _f32_workspaces(M, K, N))


@pytest.mark.parametrize("ratios", [(1, 1), (1, 8), (8, 1), (2, 3)])
def test_moe_gmm_bundle_with_prefill_bitwise_equals_native(cuda_dev, ratios):
    """The grouped expert FFN (decode capacity, phi3.5-moe widths) and a
    512-row prefill chunk at head dim 128 in one launch: bit for bit the
    members launched alone."""
    B, d, H, Hkv, D, f, S = WIDTHS["phi"]
    C = 512
    g = _gen(15)
    gmm = moe_gmm_op(16, 8, d, f)
    pf = prefill_attention_op(C, S, H, Hkv, D, ck=1024)
    ins = (*_gmm_operands(16, 8, d, f, g),
           torch.full((1, 1), 1024, dtype=torch.int32, device="cuda"),
           _randn((C, H, D), g), _randn((S, Hkv, D), g),
           _randn((S, Hkv, D), g))
    fused = hfuse.generate((gmm, pf), Schedule(ratios))(*ins)
    assert _same(fused, hfuse.run_native((gmm, pf))(*ins))


@pytest.mark.parametrize("paged", [False, True])
@pytest.mark.parametrize("ratios", [(1, 1), (8, 1), (1, 8), (3, 5)])
def test_split_decode_bundle_bitwise_equals_native(cuda_dev, ratios, paged):
    """Decode attention at its split CTA count (512 at B 8, S 2048, Hkv 8)
    with lengths at the split boundaries, a zero-length slot and a slot at
    S, beside a 512-row prefill chunk at offset 1024, phi3.5-moe's head dim
    128, contiguous and paged (16-row pages): one launch, bit for bit the
    members launched alone."""
    B, _d, H, Hkv, D, _f, S = WIDTHS["phi"]
    C, bs = 512, 16
    g = _gen(18)
    lens = _decode_lens("edges", B, S)
    q = _randn((B, H, D), g)
    k, v = _randn((B, S, Hkv, D), g), _randn((B, S, Hkv, D), g)
    length = lens.reshape(B, 1).cuda()
    pf = prefill_attention_op(C, S, H, Hkv, D, ck=1024)
    pf_in = (torch.full((1, 1), 1024, dtype=torch.int32, device="cuda"),
             _randn((C, H, D), g), k[3], v[3])
    if paged:
        ka, va, bt, _kl, _vl = _paged(k, v, lens.tolist(), bs, g)
        dec = decode_attention_op(B, S, H, Hkv, D, ck=1024,
                                  dynamic_length=True,
                                  block_table=(ka.shape[0], bs))
        dec_in = (bt, length, q, ka, va)
    else:
        dec = decode_attention_op(B, S, H, Hkv, D, ck=1024,
                                  dynamic_length=True)
        dec_in = (length, q, k, v)
    assert dec.ctas == B * Hkv * (S // kv_split())
    ops, ins = (dec, pf), dec_in + pf_in
    fused = hfuse.generate(ops, Schedule(ratios))(*ins)
    assert _same(fused, hfuse.run_native(ops)(*ins))


# ---------------------------------------------------------------------------
# kernels/ops.py's surface: the tiled matmul, the standalone rmsnorm (bf16
# and fp32), the residual add and its GEMM epilogue, flash attention
# ---------------------------------------------------------------------------
def _close(out, ref):
    assert out.dtype == ref.dtype and out.shape == ref.shape
    (_close_bf16 if out.dtype == BF else _close_f32)(out, ref)


_MM_SHAPES = [
    (256, 128, 128), (512, 256, 384), (128, 512, 256), (300, 200, 136),
    # the bf16 kernel's 128 x 256 tile and 64-deep stage edges (each dim
    # under the reference's 512 tile or a multiple of it): M and N past a
    # tile, K shorter than one stage, K not a multiple of the stage, more
    # tiles than the persistent CTAs take in one round
    (129, 40, 264), (8, 8, 8), (500, 456, 488), (8192, 200, 1536),
    # granite-3-2b's four train products: QKV, W_o, gate+up, down
    (8192, 2048, 3072), (8192, 2048, 2048), (8192, 2048, 16384),
    (8192, 8192, 2048)]
# fp32 only (K and N multiples of 4, not of 8): the fp32 kernel's 128 x 128
# tile and 16-deep slab edges: K under one slab and not a multiple of it, M
# and N one past a tile, one exact slab and tile, more row blocks than a
# group of the walk and a part last group (20 row blocks)
_MM_F32_SHAPES = [(1, 4, 4), (64, 12, 36), (129, 500, 132), (128, 16, 128),
                  (255, 20, 260), (2560, 496, 388)]


@pytest.mark.parametrize("M,K,N,dtype", [
    pytest.param(*s, dt, id=f"{s[0]}-{s[1]}-{s[2]}-dtype{i}")
    for s in _MM_SHAPES for i, dt in enumerate((BF, F32))] + [
    pytest.param(*s, F32, id=f"{s[0]}-{s[1]}-{s[2]}-dtype1")
    for s in _MM_F32_SHAPES])
def test_tiled_matmul(cuda_dev, M, K, N, dtype):
    """The reference's shapes, ragged ones at the kernels' tile, stage and
    slab edges (the zeros past M, N and K, masked stores) and granite's four
    products at train rows; a launch bumps the count, and two calls are
    bitwise equal."""
    from repro_torch.kernels import matmul as mm
    g = _gen(30)
    x = _randn((M, K), g, dtype)
    w = _randn((K, N), g, dtype, K ** -0.5)
    before = mm.TILED_MATMUL.launches
    got = mm.matmul(x, w)
    assert mm.TILED_MATMUL.launches == before + 1
    _close(got, mm.row.plain_gemm(x, w, dtype))
    assert torch.equal(got, mm.matmul(x, w))      # fixed summation order


def test_matmul_and_row_gemm_tensor_core_routes(cuda_dev):
    """The bf16 tiled matmul runs mm_bf16_kernel (its name in a profiler
    trace) and its SASS holds HGMMA (wgmma); the fp32 one runs
    mm_f32_kernel, which holds none.  The bf16 row GEMM bodies hold HMMA
    inside every bundle instance that runs the row member."""
    from repro_torch.kernels import matmul as mm
    g = _gen(32)
    xb, xf = _randn((256, 256), g, BF), _randn((256, 256), g, F32)
    ran = _device_kernels(lambda: (mm.matmul(xb, xb), mm.matmul(xf, xf)))
    for runs in ("mm_bf16_kernel", "mm_f32_kernel"):
        assert sum(runs in k for k in ran) == 1, ran
    hgmma = cuda.sass_counts("HGMMA")
    assert hgmma is not None, "the toolkit has no cuobjdump"
    assert [n for f, n in hgmma.items() if "mm_bf16_kernel" in f] and all(
        n > 0 for f, n in hgmma.items() if "mm_bf16_kernel" in f), hgmma
    assert all(n == 0 for f, n in hgmma.items() if "mm_f32_kernel" in f)
    hmma = cuda.sass_counts("HMMA")
    for nt in (1, 2, 4, 8):
        for chains in (0, 1):
            body = [n for f, n in hmma.items() if "$" in f
                    and f"row_gemm_mmaILi{nt}ELb{chains}E" in f]
            # hf_rows and hf_bundle each hold the body
            assert len(body) == 2 and all(n > 0 for n in body), (nt, hmma)


# (M, K, N): the bf16 row GEMM at its split and tile edges: one part tile
# (64 of its 128 columns; 32 K slices), a whole and a part tile, K not a
# multiple of the slice or of a stage, each row-block size (8, 16, 64 with
# 40 rows in it, 64), a dW-like 2048 rows
ROW_GEMM_EDGES = [(8, 2048, 64), (8, 1000, 128), (16, 2056, 192),
                  (40, 512, 256), (256, 520, 128), (2048, 1024, 128)]


@pytest.mark.parametrize("M,K,N", ROW_GEMM_EDGES)
def test_row_gemm_split_edges(cuda_dev, M, K, N):
    """The GEMM alone within bf16 tolerance of plain and bitwise equal
    across two launches (its tickets reset, its workspace reused); the
    norm prologue, the gated activation and the residual add epilogues
    bitwise equal to their separate members."""
    from repro_torch.kernels import row
    g = _gen(33)
    x = _randn((M, K), g)
    w = _randn((K, N), g, scale=K ** -0.5)
    mm = matmul_1d_op(M, K, N, bm=M)
    (got,), (want,) = _kernel_vs_plain(mm, x, w)
    _close_bf16(got, want)
    def kept():
        return [ws for k, ws in cuda._WORKSPACES.items()
                if k[2][0] == ("row_gemm", M, K, N, False)]
    held = kept()
    (again,) = hfuse.run_single(mm)(x, w)
    assert torch.equal(got, again)
    if mm.member.k_slices > 1:
        assert len(held) == 1 and all(
            a is b for a, b in zip(held[0], kept()[0]))
        torch.cuda.synchronize()
        assert int(held[0][1].abs().sum()) == 0   # every ticket reset
    scale = _randn((1, K), g, F32, 0.1)
    norm = rmsnorm_op(M, K, bm=M)
    (mid,) = hfuse.run_single(norm)(x, scale)
    (sep,) = hfuse.run_single(mm)(mid, w)
    (chain,) = hfuse.run_single(stitch.stitch(norm, mm, "x"))(x, scale, w)
    assert torch.equal(chain, sep)
    act = elementwise.activation_op(M, N, N // 2, elementwise.silu_gate,
                                    bm=M)
    (sep,) = hfuse.run_single(act)(got)
    (chain,) = hfuse.run_single(stitch.stitch(mm, act, "h"))(x, w)
    assert torch.equal(chain, sep)
    res = _randn((M, N), g)
    add = elementwise.residual_add_op(M, N, bm=M)
    (sep,) = hfuse.run_single(add)(got, res)
    (chain,) = hfuse.run_single(stitch.stitch(mm, add, "h"))(x, w, res)
    assert torch.equal(chain, sep)
    assert row.ROW.launches > 0


def test_qkv_proj_fills_the_card_and_allocates_nothing(cuda_dev):
    """qkv_proj at decode (8 x 2048 @ 2048 x 3072) launches at least one CTA
    per SM, and a launch after the first takes no new workspace: the
    persistent one, with every ticket back at zero."""
    mm = matmul_1d_op(8, 2048, 3072, bm=8)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    assert mm.member.ctas >= sms, (mm.member.ctas, sms)
    g = _gen(34)
    x, w = _randn((8, 2048), g), _randn((2048, 3072), g, scale=2048 ** -0.5)
    run = hfuse.run_single(mm)
    (first,) = run(x, w)
    kept = dict(cuda._WORKSPACES)
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    for _ in range(3):
        (out,) = run(x, w)
    torch.cuda.synchronize()
    assert cuda._WORKSPACES.keys() == kept.keys() and all(
        a is b for k in kept for a, b in zip(kept[k], cuda._WORKSPACES[k]))
    # the only new memory is the last output, the earlier ones freed
    assert torch.cuda.memory_allocated() - before <= out.numel() * 2 + 512
    assert torch.equal(out, first)
    assert all(int(ws[1].abs().sum()) == 0 for ws in kept.values())


@pytest.mark.parametrize("dtype,K,N", [(torch.float16, 64, 64),
                                       (BF, 100, 64), (F32, 64, 66)])
def test_tiled_matmul_raises_on_what_it_cannot_take(cuda_dev, dtype, K, N):
    from repro_torch.kernels import matmul as mm
    x = torch.zeros((64, K), dtype=dtype, device="cuda")
    w = torch.zeros((K, N), dtype=dtype, device="cuda")
    with pytest.raises(ValueError, match="kernel takes"):
        mm.matmul(x, w)


@pytest.mark.parametrize("dtype", [BF, F32])
@pytest.mark.parametrize("R,d", [(256, 128), (512, 512), (128, 384),
                                 (8192, 2048)])
def test_rmsnorm_standalone(cuda_dev, R, d, dtype):
    from repro_torch.kernels import row
    from repro_torch.kernels.rmsnorm import rmsnorm
    g = _gen(31)
    x = _randn((R, d), g, dtype)
    scale = _randn((d,), g, F32, 0.1)
    before = row.ROW.launches
    got = rmsnorm(x, scale)
    assert row.ROW.launches == before + 1
    _close(got, row.plain_rmsnorm(x, scale))


@pytest.mark.parametrize("dtype", [BF, F32])
@pytest.mark.parametrize("d", [100, 2050, 4096, 8192])
def test_rmsnorm_widths_and_rows_per_cta(cuda_dev, d, dtype):
    """The RMSNorm member at widths that are not 16-byte aligned (100 bf16,
    2050), that fill the registers (4096 bf16) and past them (4096 fp32,
    8192): M one under, at and one past the rows-per-CTA threshold within
    tolerance of plain, and the same rows bitwise equal whether a CTA takes
    one (decode geometry) or row.NORM_ROWS of them, since each row is one
    warp's in one order."""
    from repro_torch.kernels import row
    from repro_torch.kernels.rmsnorm import rmsnorm
    g = _gen(35)
    P = row.NORM_PACK_M
    x = _randn((P + 1, d), g, dtype)
    scale = _randn((d,), g, F32, 0.1)
    outs = {}
    for M in (8, P - 1, P, P + 1):
        before = row.ROW.launches
        outs[M] = rmsnorm(x[:M], scale, bm=M)
        assert row.ROW.launches == before + 1
        _close(outs[M], row.plain_rmsnorm(x[:M], scale))
    assert rmsnorm_op(P - 1, d, dtype, bm=P - 1).ctas == P - 1
    assert rmsnorm_op(P + 1, d, dtype, bm=P + 1).ctas == -(-(P + 1)
                                                            // row.NORM_ROWS)
    for M in (P, P + 1):
        assert torch.equal(outs[M][:P - 1], outs[P - 1])
        assert torch.equal(outs[M][:8], outs[8])


@pytest.mark.parametrize("dtype", [BF, F32])
@pytest.mark.parametrize("R,F", [(8, 64), (37, 100), (1000, 100),
                                 (8192, 2048)])
def test_residual_add_member(cuda_dev, R, F, dtype):
    """Both rounded operands summed in fp32 and rounded once, as the plain
    version does: bitwise, and bitwise equal to torch.add; (37, 100) ends
    in a part vector, (1000, 100) mid-chunk in its last CTA.  A launch of
    the member alone runs hf_rows<false>, at least 2 CTAs an SM."""
    g = _gen(32)
    h, res = _randn((R, F), g, dtype), _randn((R, F), g, dtype)
    op = elementwise.residual_add_op(R, F, dtype, bm=R)
    (got,), (want,) = _kernel_vs_plain(op, h, res)
    assert torch.equal(got, want)
    assert torch.equal(got, torch.add(h, res))
    out = torch.empty_like(h)
    name, per_sm = cuda.launch_instance([op.member], [(h, res)], [(out,)])
    assert name == "hf_rows<false>" and per_sm >= 2


@pytest.mark.parametrize("ratios", [(1, 1), (3, 1)])
@pytest.mark.parametrize("dtype", [BF, F32])
def test_residual_add_fused_bitwise_equal_alone(cuda_dev, dtype, ratios):
    """The residual add fused with another row member (rmsnorm) runs in
    hf_rows<false>, as it does alone; both outputs are bitwise equal to the
    members launched alone."""
    g = _gen(34)
    R, d = 1000, 2048
    h, res = _randn((R, d), g, dtype), _randn((R, d), g, dtype)
    x, scale = _randn((64, d), g, dtype), _randn((1, d), g, F32, 0.1)
    ops = (elementwise.residual_add_op(R, d, dtype, bm=R),
           rmsnorm_op(64, d, dtype, bm=64))
    outs = [(torch.empty_like(h),), (torch.empty_like(x),)]
    assert cuda.launch_instance([op.member for op in ops],
                                [(h, res), (x, scale)],
                                outs)[0] == "hf_rows<false>"
    fused = hfuse.generate(ops, Schedule(ratios))(h, res, x, scale)
    assert _same(fused, hfuse.run_native(ops)(h, res, x, scale))


@pytest.mark.parametrize("dtype", [BF, F32])
@pytest.mark.parametrize("width", sorted(WIDTHS))
def test_gemm_resadd_chain_bitwise(cuda_dev, width, dtype):
    """matmul->residual_add (W_o at decode): the chain equals its GEMM and
    residual-add members launched separately, bit for bit, and matches
    the plain chain."""
    B, d = WIDTHS[width][:2]
    g = _gen(33)
    x, res = _randn((B, d), g, dtype), _randn((B, d), g, dtype)
    w = _randn((d, d), g, dtype, d ** -0.5)
    mm = matmul_1d_op(B, d, d, dtype, bm=B)
    add = elementwise.residual_add_op(B, d, dtype, bm=B)
    chain = stitch.stitch(mm, add, "h")
    (got,) = hfuse.run_single(chain)(x, w, res)
    (h,) = hfuse.run_single(mm)(x, w)
    assert torch.equal(got, hfuse.run_single(add)(h, res)[0])
    _close(got, hfuse.run_single(chain, plain=True)(x, w, res)[0])


@pytest.mark.parametrize("dtype", [BF, F32])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("D", [64, 72, 128])
@pytest.mark.parametrize("B,S,H,Hkv", [(2, 256, 4, 4), (2, 256, 8, 2),
                                       (1, 203, 6, 2), (1, 512, 8, 1)])
def test_flash_attention_kernel(cuda_dev, B, S, H, Hkv, D, causal, dtype):
    """No GQA, GQA at rep 4 and 8, a part last query tile at rep 3, head dim
    72 (the tensor-core route pads the contraction to 80): the (B,S,H,D)
    kernel against the reference's route on the plain version (KV heads
    repeated, heads flattened); the (BH,S,D) form is the same kernel at one
    head."""
    from repro_torch.kernels import flash_attention as fa
    g = _gen(34)
    q = _randn((B, S, H, D), g, dtype)
    k, v = _randn((B, S, Hkv, D), g, dtype), _randn((B, S, Hkv, D), g, dtype)
    before = fa.FLASH.launches
    got = fa.flash_attention_bshd(q, k, v, causal=causal)
    assert fa.FLASH.launches == before + 1
    want = fa.flash_attention_bshd(q.cpu(), k.cpu(), v.cpu(), causal=causal)
    _close(got, want.to("cuda"))
    qf = q.transpose(1, 2).reshape(B * H, S, D).contiguous()
    kf = k.repeat_interleave(H // Hkv, dim=2).transpose(1, 2).reshape(
        B * H, S, D).contiguous()
    vf = v.repeat_interleave(H // Hkv, dim=2).transpose(1, 2).reshape(
        B * H, S, D).contiguous()
    flat = fa.flash_attention(qf, kf, vf, causal=causal)
    _close(flat, fa.plain_flash_attention(qf, kf, vf, causal=causal))


def _rel_l2(got, want):
    """Relative L2 of got against want over the whole output and the worst
    of it over the rows of the last dim."""
    diff = (got - want).double()
    whole = (diff.norm() / want.double().norm()).item()
    rows = (diff.norm(dim=-1)
            / want.double().norm(dim=-1).clamp_min(1e-30)).max().item()
    return whole, rows


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("D", [8, 72, 128])
@pytest.mark.parametrize("B,S,H,Hkv", [(2, 200, 4, 4), (1, 300, 8, 2),
                                       (1, 77, 264, 1)])
def test_flash_attention_f32_edges(cuda_dev, B, S, H, Hkv, D, causal):
    """The fp32 kernel at its edges: head dims 8, 72 (a part second column
    group) and 128; S off the row and 64-key tiles; GQA rep 1, 4 and 264
    (more heads in a group than a CTA's 256 or 128 rows); causal, where at
    rep 1 a CTA's rows span several key tiles, so its earlier rows meet a
    tile whose keys are all masked.  Within chip_smoke's fp32 limits of the plain
    version by relative L2 (5e-6 whole, 1e-5 worst row) and fp32
    tolerance; two launches bitwise equal."""
    from repro_torch.kernels import flash_attention as fa
    g = _gen(38)
    q = _randn((B, S, H, D), g, F32)
    k, v = _randn((B, S, Hkv, D), g, F32), _randn((B, S, Hkv, D), g, F32)
    before = fa.FLASH.launches
    got = fa.flash_attention_bshd(q, k, v, causal=causal)
    assert fa.FLASH.launches == before + 1
    want = fa.plain_flash_attention_bshd(q, k, v, causal=causal)
    whole, worst = _rel_l2(got, want)
    assert whole <= 5e-6 and worst <= 1e-5, (whole, worst)
    _close_f32(got, want)
    assert torch.equal(got, fa.flash_attention_bshd(q, k, v, causal=causal))


def test_flash_attention_full_width(cuda_dev):
    """granite-3-2b's train attention: B 4, S 2048, 32/8 heads, D 64."""
    from repro_torch.kernels import flash_attention as fa
    g = _gen(35)
    q = _randn((4, 2048, 32, 64), g)
    k, v = _randn((4, 2048, 8, 64), g), _randn((4, 2048, 8, 64), g)
    got = fa.flash_attention_bshd(q, k, v)
    _close(got, fa.plain_flash_attention_bshd(q, k, v))


@pytest.mark.parametrize("dtype,D", [(torch.float16, 64), (BF, 136),
                                     (F32, 20)])
def test_flash_attention_raises_on_what_it_cannot_take(cuda_dev, dtype, D):
    from repro_torch.kernels import flash_attention as fa
    q = torch.zeros((1, 64, 2, D), dtype=dtype, device="cuda")
    with pytest.raises(ValueError, match="kernel takes"):
        fa.flash_attention_bshd(q, q, q)


def test_ops_hfused_adamw_ten_leaves(cuda_dev):
    """Ten leaves: two bundle launches of the AdamW member (at most 8
    members each), equal to the plain route bit for bit."""
    from repro_torch.kernels import adam, ops
    g = _gen(36)
    shapes = [(3 + i, 129) for i in range(10)]
    trees = [{f"l{i}": _randn(s, g, F32, 0.1) for i, s in enumerate(shapes)}
             for _ in range(4)]
    trees[3] = {k: t.abs() for k, t in trees[3].items()}      # v >= 0
    kw = dict(lr=1e-3, b1=0.9, b2=0.95, eps=1e-8, wd=0.1, bc1=0.1, bc2=0.05)
    plain = [{k: t.clone() for k, t in tr.items()} for tr in trees]
    before = adam.ADAMW.launches
    ops.hfused_adamw(*trees, **kw)
    assert adam.ADAMW.launches == before + 2
    sc = torch.zeros((1, adam.LANES), device="cuda")
    sc[0, :3] = torch.tensor([kw["lr"], kw["bc1"], kw["bc2"]])
    adam.multi_tensor_adamw(*plain, sc, b1=kw["b1"], b2=kw["b2"],
                            eps=kw["eps"], wd=kw["wd"], plain=True)
    for got, want in zip((trees[0], trees[2], trees[3]),
                         (plain[0], plain[2], plain[3])):
        for k in got:
            assert torch.equal(got[k], want[k]), k


# ---------------------------------------------------------------------------
# maxpool's signed zero; decode attention's static forms; the wavefront
# co-prefill partner (prefill_ffn) beside decode attention
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("dtype,bits", [(F32, torch.int32), (BF, torch.int16)])
@pytest.mark.parametrize("R,C,bm", MAXPOOL_SHAPES, ids=str)
def test_maxpool_signed_zero_bits(cuda_dev, R, C, bm, dtype, bits):
    """Zeros of both signs in both orders of a pair, beside NaN and +-inf:
    the kernel's bit patterns are the plain version's (which is the
    reference's: +0 wins over -0, NaN propagates)."""
    from repro_torch.kernels import paper_suite as ps
    op, _mk, plain = ps.make_maxpool(R=R, C=C, bm=bm, dtype=dtype)
    x = torch.zeros((R, C), dtype=dtype, device="cuda")
    half = C // 2
    x[1::2, :half] = -0.0            # (+0, -0) in the left half
    x[0::2, half:] = -0.0            # (-0, +0) in the right half
    x[2, 0], x[3, 1], x[4, 2], x[5, 2] = -0.0, -0.0, float("nan"), -0.0
    x[6, 3], x[7, 3] = float("inf"), -float("inf")
    (got,) = hfuse.run_single(op)(x)
    torch.cuda.synchronize()
    want = plain(x)
    assert not bool(want[0, :half].signbit().any())
    assert torch.equal(got.view(bits), want.view(bits))


@pytest.mark.parametrize("length", [1, 555, 2048, None])
@pytest.mark.parametrize("D", [64, 128])
def test_decode_attention_static_forms(cuda_dev, D, length):
    """decode_attention_op(length=...) and (dynamic_length=False, the whole
    cache) at B 8, S 2048: the member reads the length from its launch
    descriptor (no "len" operand), matches its plain version, gives the
    bits of the dynamic form at that length, and the same bits launch to
    launch."""
    B, H, Hkv, S = 8, 32, 8, 2048
    g = _gen(26)
    q = _randn((B, H, D), g)
    k, v = _randn((B, S, Hkv, D), g), _randn((B, S, Hkv, D), g)
    op = decode_attention_op(B, S, H, Hkv, D, ck=1024, length=length)
    assert op.in_names == ("q", "k", "v")
    got, want = _kernel_vs_plain(op, q, k, v)
    for a, b in zip(got, want):
        _close_f32(a, b)
    dyn = decode_attention_op(B, S, H, Hkv, D, ck=1024, dynamic_length=True)
    lens = torch.full((B, 1), length or S, dtype=torch.int32, device="cuda")
    assert _same(got, hfuse.run_single(dyn)(lens, q, k, v))
    assert _same(got, hfuse.run_single(op)(q, k, v))


@pytest.mark.parametrize("rows", [256, 4096])
def test_prefill_ffn_beside_decode_attention_bitwise(cuda_dev, rows):
    """The executed wavefront step's partner, prefill_ffn (rows x 2048 @
    2048 x 16384, granite-3-2b's gate+up), in one launch with decode
    attention at B 8, S 2048: bit for bit the two launched alone, and the
    GEMM within the bf16 tolerance of its plain version."""
    B, d, H, Hkv, D, f, S = WIDTHS["full"]
    g = _gen(27)
    pf = matmul_1d_op(M=rows, K=d, N=2 * f, dtype=BF, bm=min(128, rows))
    dec = decode_attention_op(B, S, H, Hkv, D, ck=1024, dynamic_length=True)
    pf_in = (_randn((rows, d), g), _randn((d, 2 * f), g, scale=d ** -0.5))
    dec_in = (_decode_lens("spread", B, S).reshape(B, 1).cuda(),
              _randn((B, H, D), g), _randn((B, S, Hkv, D), g),
              _randn((B, S, Hkv, D), g))
    for ops, ins in (((pf, dec), pf_in + dec_in), ((dec, pf), dec_in + pf_in)):
        fused = hfuse.generate(ops, Schedule((1, 1)))(*ins)
        assert _same(fused, hfuse.run_native(ops)(*ins))
    (out,) = hfuse.run_single(pf)(*pf_in)
    _close_bf16(out, hfuse.run_single(pf, plain=True)(*pf_in)[0])


# ---------------------------------------------------------------------------
# The LayerNorm configs: the norm is glue (plain PyTorch, as the
# reference's plain jnp); the model runs on the card and trains through the
# update program's AdamW member
# ---------------------------------------------------------------------------
def test_layernorm_bf16_against_fp64(cuda_dev):
    from repro_torch.models import layers
    g = torch.Generator(device=cuda_dev).manual_seed(3)
    d = 4608
    x = (torch.randn((512, d), generator=g, device=cuda_dev) * 2 + 0.5).to(BF)
    p = {"scale": 1 + 0.3 * torch.randn(d, generator=g, device=cuda_dev),
         "bias": 0.1 * torch.randn(d, generator=g, device=cuda_dev)}
    got = layers.layernorm(p, x)
    xd = x.double()
    mu = xd.mean(-1, keepdim=True)
    var = (xd - mu).square().mean(-1, keepdim=True)
    want = (xd - mu) * torch.rsqrt(var + 1e-5) * p["scale"].double() \
        + p["bias"].double()
    assert got.dtype == BF
    assert (got.double() - want).abs().max() <= 2 ** -7 * want.abs().max()


def _stablelm(layers_: int):
    from repro_torch.configs import get_config
    return dataclasses.replace(get_config("stablelm-3b"), num_layers=layers_,
                               block_pattern=None)


def test_stablelm_prefill_decode_equal_forward(cuda_dev):
    """stablelm-3b at full width (MHA 32 x 80, partial RoPE), 2 layers:
    prefill of 256 tokens and one decode step against forward(257), within
    the serve phases' 5e-2 relative L2."""
    from repro_torch.models import lm
    cfg = _stablelm(2)
    g = torch.Generator(device=cuda_dev).manual_seed(0)
    params = lm.init(cfg, g, device=cuda_dev)
    toks = torch.randint(1, cfg.vocab_size, (2, 257), generator=g,
                         device=cuda_dev, dtype=torch.int32)
    with torch.no_grad():
        full = lm.forward(cfg, params, {"tokens": toks})[0]
        cache, pf = lm.prefill(cfg, params, {"tokens": toks[:, :-1]},
                               max_len=300)
        dec, cache = lm.decode_step(cfg, params, cache, toks[:, -1])
    for got, want in ((pf, full[:, -2]), (dec, full[:, -1])):
        assert torch.isfinite(got).all()
        assert (got - want).norm() <= 5e-2 * want.norm()
    assert int(cache["pos"]) == 257


def test_stablelm_train_step_moves_the_biases(cuda_dev):
    """One full-width train step of a 2-layer stablelm-3b through the
    update program: finite loss, and every LayerNorm bias (zero at the
    start) moved, in every layer, by the AdamW member."""
    from repro_torch import tree as tree_mod
    from repro_torch.kernels import adam, registry
    from repro_torch.models import lm
    from repro_torch.train import optimizer as opt_mod
    from repro_torch.train import train_loop as tl
    cfg = _stablelm(2)
    g = torch.Generator(device=cuda_dev).manual_seed(0)
    params = lm.init(cfg, g, device=cuda_dev)
    ocfg = opt_mod.AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=4)
    prog = tl.build_update_program(lm.abstract_params(cfg), ocfg)
    step = tl.make_train_step(cfg, tl.TrainConfig(optimizer=ocfg,
                                                  remat=True),
                              update_program=prog)
    toks = torch.randint(1, cfg.vocab_size, (2, 512), generator=g,
                         device=cuda_dev, dtype=torch.int32)
    cuda.reset_counts(registry())
    params, _state, met = step(params, opt_mod.init(params),
                               {"tokens": toks, "labels": toks}, 0)
    assert math.isfinite(float(met["loss"])) and float(met["grad_norm"]) > 0
    assert adam.ADAMW.launches > 0
    biases = [leaf for path, leaf in tree_mod.flatten_with_paths(params)
              if path[-1] == "bias"]
    assert len(biases) == 3
    for leaf in biases:
        assert (leaf.reshape(-1, cfg.d_model) != 0).any(dim=-1).all()
