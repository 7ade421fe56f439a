"""The residual add's geometry and the bundle kernel's instance choice, on
the CPU.

The standalone residual add (``csrc/row_member.cuh`` resadd_chunk) gives
each CTA ``row.RESADD_BYTES`` of each operand, so ``RowMember.ctas`` is the
operands' bytes over that, rounded up; the last CTA takes what is left.
A launch runs the narrowest instance of the bundle kernel that holds its
members (``csrc/bundle.cu`` hf_instance): ``hf_rows<...>`` for the row
family (the residual add alone among them), ``hf_stream`` for one maxpool
member alone, ``hf_paper`` for the paper suite, ``hf_bundle<...>`` for any
other mix; ``<true>`` when a row member
needs a chain body (``csrc/row_member.cuh`` row_chain_kernel).  ``instance``
and ``chain_body`` below restate that rule in Python; the port itself asks
the library (``cuda.launch_instance``), and the card test
``test_instance_choice_matches_library`` holds the two to one answer.
"""
from __future__ import annotations

import math

import pytest
import torch

from repro_torch.core import stitch
from repro_torch.kernels import cuda, elementwise, paper_suite, row
from repro_torch.kernels.decode_attention import decode_attention_op
from repro_torch.kernels.matmul import matmul_1d_op
from repro_torch.kernels.rmsnorm import rmsnorm_op

BF, F32 = torch.bfloat16, torch.float32


@pytest.mark.parametrize("dtype", [BF, F32])
@pytest.mark.parametrize("R,F", [(8, 64), (37, 100), (8192, 2048),
                                 (1000, 100), (8, 2048)])
def test_residual_add_ctas(R, F, dtype):
    """CTAs = ceil(R F itemsize / RESADD_BYTES): 16 KB of each operand a
    CTA, 256 threads x 4 vectors of 16 bytes; 8192 x 2048 is 2048 CTAs in
    bf16 and 4096 in fp32; (37, 100) and (1000, 100) end mid-chunk."""
    assert row.RESADD_BYTES == 256 * 4 * 16
    isz = torch.tensor([], dtype=dtype).element_size()
    op = elementwise.residual_add_op(R, F, dtype, bm=R)
    want = math.ceil(R * F * isz / row.RESADD_BYTES)
    assert op.member.ctas == op.ctas == want
    if (R, F) == (8192, 2048):
        assert want == (2048 if dtype == BF else 4096)
    per_cta = row.RESADD_BYTES // isz
    last = R * F - (want - 1) * per_cta
    assert 0 < last <= per_cta


def chain_body(member) -> bool:
    """Whether ``member`` runs only in the chain instances: a row-wise
    pair, a GEMM handing its product to a row consumer or AdamW, an fp32
    GEMM's staged producer.  A GEMM alone and its residual-add and (bf16)
    activation epilogues run in the instances without chain bodies."""
    if not isinstance(member, row.RowChain):
        return False
    p, c = member.producer, member.consumer
    if p.sub == "gemm":
        return not (isinstance(c, row.RowMember) and (
            c.sub == "resadd" or (c.sub == "act" and not p.fp32
                                  and c.K == p.N)))
    if member._gemm_consumer:
        return c.fp32
    return True


def instance(members) -> str:
    """The instance of the bundle kernel a launch carrying ``members``
    runs."""
    rows = [isinstance(m, (row.RowMember, row.RowChain)) for m in members]
    chains = str(any(chain_body(m) for m, r in zip(members, rows)
                     if r)).lower()
    if all(rows):
        return f"hf_rows<{chains}>"
    if len(members) == 1 and getattr(members[0], "body", None) == "maxpool":
        return "hf_stream"
    if all(isinstance(m, paper_suite.PaperMember) for m in members):
        return "hf_paper"
    return f"hf_bundle<{chains}>"


def _members():
    add = elementwise.residual_add_op(64, 256, BF, bm=64)
    add32 = elementwise.residual_add_op(37, 100, F32)
    norm = rmsnorm_op(64, 256, BF, bm=64)
    mm = matmul_1d_op(8, 256, 256, BF, bm=8)
    mm32 = matmul_1d_op(8, 256, 256, F32, bm=8)
    add8 = elementwise.residual_add_op(8, 256, BF, bm=8)
    add8_32 = elementwise.residual_add_op(8, 256, F32, bm=8)
    norm8 = rmsnorm_op(8, 256, BF, bm=8)
    norm8_32 = rmsnorm_op(8, 256, F32, bm=8)
    paper = paper_suite.make_sha_like(**paper_suite.SMALL_KW["sha_like"])[0]
    pool = paper_suite.make_maxpool(**paper_suite.SMALL_KW["maxpool"])[0]
    hist = paper_suite.make_hist(**paper_suite.SMALL_KW["hist"],
                                 dtype=BF)[0]
    up = paper_suite.make_upsample(**paper_suite.SMALL_KW["upsample"])[0]
    im = paper_suite.make_im2col(**paper_suite.SMALL_KW["im2col"],
                                 dtype=BF)[0]
    dec = decode_attention_op(2, 128, 4, 4, 16, ck=128,
                              dynamic_length=True)
    return {
        "resadd": add, "resadd_f32": add32, "rmsnorm": norm, "gemm": mm,
        "gemm->resadd": stitch.stitch(mm, add8, "h"),
        "gemm_f32->resadd": stitch.stitch(mm32, add8_32, "h"),
        "gemm->rmsnorm": stitch.stitch(mm, norm8, "x"),
        "rmsnorm->gemm": stitch.stitch(norm8, mm, "x"),
        "rmsnorm_f32->gemm": stitch.stitch(norm8_32, mm32, "x"),
        "resadd->rmsnorm": stitch.stitch(add, norm, "x"),
        "sha_like": paper, "decode": dec, "maxpool": pool, "hist": hist,
        "upsample": up, "im2col": im,
    }


# members of one launch -> the instance it runs
LAUNCHES = [
    (("resadd",), "hf_rows<false>"),
    (("resadd_f32",), "hf_rows<false>"),
    (("resadd", "resadd_f32"), "hf_rows<false>"),
    (("resadd", "rmsnorm"), "hf_rows<false>"),
    (("rmsnorm", "resadd"), "hf_rows<false>"),
    (("resadd", "gemm"), "hf_rows<false>"),
    (("gemm->resadd",), "hf_rows<false>"),
    (("gemm_f32->resadd",), "hf_rows<false>"),
    (("rmsnorm->gemm",), "hf_rows<false>"),
    (("rmsnorm_f32->gemm",), "hf_rows<true>"),
    (("gemm->rmsnorm",), "hf_rows<true>"),
    (("resadd->rmsnorm",), "hf_rows<true>"),
    (("resadd", "gemm->rmsnorm"), "hf_rows<true>"),
    (("sha_like",), "hf_paper"),
    (("maxpool",), "hf_stream"),
    (("hist",), "hf_paper"),
    (("maxpool", "hist"), "hf_paper"),
    (("hist", "sha_like"), "hf_paper"),
    (("upsample",), "hf_paper"),
    (("im2col",), "hf_paper"),
    (("maxpool", "upsample"), "hf_paper"),
    (("im2col", "hist"), "hf_paper"),
    (("upsample", "resadd"), "hf_bundle<false>"),
    (("maxpool", "resadd"), "hf_bundle<false>"),
    (("resadd", "sha_like"), "hf_bundle<false>"),
    (("resadd", "decode"), "hf_bundle<false>"),
    (("resadd->rmsnorm", "decode"), "hf_bundle<true>"),
]


@pytest.mark.parametrize("names,want", LAUNCHES,
                         ids=lambda v: "+".join(v) if isinstance(v, tuple)
                         else v)
def test_instance_choice(names, want):
    ops = _members()
    members = [ops[n].member for n in names]
    assert instance(members) == want


def test_chain_body_matches_the_kernel_rule():
    """``chain_body``: row-wise pairs, GEMM -> row consumer through the
    workspace, and the fp32 GEMM's staged producer need the chain
    instances; the GEMM alone, its residual-add epilogue and a bf16
    producer staged into the GEMM's x do not."""
    ops = _members()
    body = {n: chain_body(op.member) for n, op in ops.items()
            if isinstance(op.member, (row.RowMember, row.RowChain))}
    assert body == {"resadd": False, "resadd_f32": False, "rmsnorm": False,
                    "gemm": False, "gemm->resadd": False,
                    "gemm_f32->resadd": False, "gemm->rmsnorm": True,
                    "rmsnorm->gemm": False, "rmsnorm_f32->gemm": True,
                    "resadd->rmsnorm": True}


@pytest.mark.cuda
def test_instance_choice_matches_library():
    """The library's instance (``cuda.launch_instance``) for every launch of
    the table above is the one ``instance`` names; each fits on an SM."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the kernels run only on the card")
    ops = _members()
    for names, want in LAUNCHES:
        members = [ops[n].member for n in names]
        ins = [[torch.zeros(o.shape, dtype=o.dtype, device="cuda")
                for o in ops[n].inputs] for n in names]
        outs = [[torch.zeros(o.shape, dtype=o.dtype, device="cuda")
                 for o in ops[n].outputs] for n in names]
        for n, i_, o_ in zip(names, ins, outs):
            for j, k in ops[n].aliases:
                o_[j] = i_[k]
        name, per_sm = cuda.launch_instance(members, ins, outs)
        assert name == instance(members) == want
        assert per_sm >= 1
