"""The port's paged KV path against the JAX package's, on the CPU.

  * Kernels: the paged decode and prefill attention ops (``block_table=``)
    run their plain versions here; they are held against the reference's
    paged ops in interpret mode on the same numpy inputs (pages scattered
    over a shuffled arena), with equal planning metadata, and BITWISE
    against the port's contiguous plain versions on the same logical cache.
  * KVPool: the port's copy and the reference's pool go through the same
    seeded admit / ensure_rows / register / release sequence (tight arenas,
    so evictions happen) and report equal values and snapshots.
  * Serve: reduced granite-3-2b in fp32, batch 2, ``PrefillBudget(
    chunk_rows=16)`` (a chunk is whole 16-row pages), token for token with
    the JAX engine and with equal ``ServeStats.describe()``: a shared
    prefix, mid-batch EOS, a prefix that survives into a second run, a
    tight pool that evicts and retires ``pool_full``; and fewer prefill
    chunks than the port's own contiguous engine at equal tokens.
  * Launch tables equal the reference's at reduced and full width.
  * Refusals: both packages raise the same ValueErrors.

Tolerances: fp32 1e-5 (same math, other summation order); bf16 2e-2 of the
largest reference value (bf16 rounds at other points in the frameworks).
"""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.core import hfuse as jhfuse
from repro.kernels.decode_attention import decode_attention_op as jdecode
from repro.kernels.prefill_attention import prefill_attention_op as jprefill
from repro.serve import engine as jengine
from repro.serve.kv_pool import KVPool as JPool
from repro_torch.configs import get_config
from repro_torch.core import hfuse
from repro_torch.kernels.decode_attention import (decode_attention_op,
                                                  gather_pages,
                                                  plain_decode_attention)
from repro_torch.kernels.prefill_attention import (plain_prefill_attention,
                                                   prefill_attention_op)
from repro_torch.models import lm
from repro_torch.serve import engine
from repro_torch.serve.kv_pool import KVPool
from test_torch_kernels import _assert_match, _planning
from test_torch_serve import _numpy_params

H, Hkv, D, BS = 4, 2, 8, 16
DTYPES = {"float32": (jnp.float32, torch.float32, np.float32, 1e-5),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, ml_dtypes.bfloat16,
                       2e-2)}


def _both(a):
    """One numpy array as a JAX array and a bit-identical torch tensor."""
    t = torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16) \
        if a.dtype == ml_dtypes.bfloat16 else torch.from_numpy(a.copy())
    return jnp.asarray(a), t


def _paged_cache(rng, B, S, num_blocks, np_dt):
    """Contiguous (B, S, Hkv, D) k/v and an arena holding the same logical
    content, each slot's pages at shuffled arena rows (table (B, S/BS))."""
    kc = rng.normal(size=(B, S, Hkv, D)).astype(np_dt)
    vc = rng.normal(size=(B, S, Hkv, D)).astype(np_dt)
    nper = S // BS
    tables = rng.permutation(num_blocks)[:B * nper].reshape(B, nper)
    ka = np.zeros((num_blocks, BS, Hkv, D), np_dt)
    va = np.zeros_like(ka)
    for b in range(B):
        for p in range(nper):
            ka[tables[b, p]] = kc[b, p * BS:(p + 1) * BS]
            va[tables[b, p]] = vc[b, p * BS:(p + 1) * BS]
    return kc, vc, ka, va, tables.astype(np.int32)


# ---------------------------------------------------------------------------
# Kernels
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("shrink", [None, 2])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_paged_decode_matches_reference(dtype, shrink):
    jdt, tdt, np_dt, tol = DTYPES[dtype]
    B, S, ck, nblk = 3, 64, 32, 3 * 4 + 3
    rng = np.random.default_rng(0)
    kc, vc, ka, va, bt = _paged_cache(rng, B, S, nblk, np_dt)
    q = rng.normal(size=(B, H, D)).astype(np_dt)
    lens = np.asarray([[1], [37], [64]], np.int32)
    jop = jdecode(B, S, H, Hkv, D, dtype=jdt, ck=ck, dynamic_length=True,
                  block_table=(nblk, BS))
    top = decode_attention_op(B, S, H, Hkv, D, dtype=tdt, ck=ck,
                              dynamic_length=True, block_table=(nblk, BS))
    if shrink:
        jop, top = jop.shrink(shrink), top.shrink(shrink)
    assert _planning(jop) == _planning(top)
    assert top.name.endswith("_pg16") and top.in_names[0] == "bt"
    ins = [_both(a) for a in (bt, lens, q, ka, va)]
    want = jhfuse.run_single(jop, interpret=True)(*(j for j, _ in ins))
    got = hfuse.run_single(top)(*(t for _, t in ins))
    _assert_match(want, got, tol)
    # bitwise: the paged plain version IS the contiguous one on the same
    # logical content
    contiguous = plain_decode_attention(ins[1][1], ins[2][1],
                                        _both(kc)[1], _both(vc)[1])
    assert all(torch.equal(a, b) for a, b in zip(got, contiguous))


@pytest.mark.parametrize("off", [0, 24, 48])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_paged_prefill_matches_reference(dtype, off):
    jdt, tdt, np_dt, tol = DTYPES[dtype]
    C, S, ck, nblk = 16, 64, 32, 4 + 2
    rng = np.random.default_rng(1)
    kc, vc, ka, va, bt = _paged_cache(rng, 1, S, nblk, np_dt)
    q = rng.normal(size=(C, H, D)).astype(np_dt)
    offs = np.full((1, 1), off, np.int32)
    jop = jprefill(C, S, H, Hkv, D, dtype=jdt, ck=ck,
                   block_table=(nblk, BS))
    top = prefill_attention_op(C, S, H, Hkv, D, dtype=tdt, ck=ck,
                               block_table=(nblk, BS))
    assert _planning(jop) == _planning(top)
    assert _planning(jop.shrink(2)) == _planning(top.shrink(2))
    assert jop.shrink(4) is None and top.shrink(4) is None   # ck 8 < bs
    assert top.in_names == ("off", "bt", "q", "k", "v")
    ins = [_both(a) for a in (offs, bt, q, ka, va)]
    want = jhfuse.run_single(jop, interpret=True)(*(j for j, _ in ins))
    got = hfuse.run_single(top)(*(t for _, t in ins))
    _assert_match(want, got, tol)
    contiguous = plain_prefill_attention(ins[0][1], ins[2][1],
                                         _both(kc)[1][0], _both(vc)[1][0])
    assert all(torch.equal(a, b) for a, b in zip(got, contiguous))


def test_gather_pages_reassembles_the_logical_cache():
    rng = np.random.default_rng(2)
    kc, _vc, ka, _va, bt = _paged_cache(rng, 2, 32, 9, np.float32)
    got = gather_pages(torch.from_numpy(ka), torch.from_numpy(bt))
    assert torch.equal(got, torch.from_numpy(kc))


# ---------------------------------------------------------------------------
# KVPool
# ---------------------------------------------------------------------------
def _drive(pool, ops):
    out = []
    for op, *args in ops:
        out.append(getattr(pool, op)(*args))
        out.append(pool.snapshot())
    return out


def _pool_ops(seed, slots, max_blocks, bs):
    """A seeded lifecycle: prompts drawn from a few shared prefixes, each
    admitted, mapped chunk by chunk, registered, grown by decode rows and
    released."""
    rng = np.random.default_rng(seed)
    prefixes = [list(rng.integers(0, 50, 3 * bs)) for _ in range(3)]
    ops, live, now = [], {}, 0
    for _ in range(40):
        now += 1
        free = [b for b in range(slots) if b not in live]
        if free and (not live or rng.random() < 0.5):
            b = free[0]
            n = int(rng.integers(1, 2 * bs))
            toks = prefixes[rng.integers(3)][:int(rng.integers(bs, 3 * bs))] \
                + list(rng.integers(0, 50, n))
            live[b] = (toks, len(toks))
            ops += [("admit", b, toks, bs, now),
                    ("ensure_rows", b, 0, len(toks), now),
                    ("register", b, toks, now)]
        else:
            b = sorted(live)[int(rng.integers(len(live)))]
            toks, pos = live[b]
            if rng.random() < 0.6 and pos < max_blocks * bs - 1:
                ops.append(("ensure_rows", b, pos, pos + 1, now))
                live[b] = (toks, pos + 1)
            else:
                ops.append(("release", b))
                del live[b]
    return ops


@pytest.mark.parametrize("seed,num_blocks", [(0, 40), (1, 14), (2, 10)])
def test_kv_pool_matches_reference(seed, num_blocks):
    kw = dict(num_blocks=num_blocks, block_size=4, slots=3,
              max_blocks_per_slot=8)
    ops = _pool_ops(seed, 3, 8, 4)
    got = _drive(KVPool(**kw), ops)
    assert got == _drive(JPool(**kw), ops)
    if num_blocks == 10:                  # the tight arena really evicts
        assert got[-1]["evictions"] > 0


def test_kv_pool_refusals_and_cow_match_reference():
    for Pool in (KVPool, JPool):
        with pytest.raises(ValueError, match="must exceed slots"):
            Pool(num_blocks=2, block_size=4, slots=2, max_blocks_per_slot=4)
    ops = [("admit", 0, list(range(12)), 4, 0),
           ("ensure_rows", 0, 0, 12, 0), ("register", 0, list(range(12)), 0),
           ("release", 0), ("admit", 1, list(range(13)), 4, 1),
           ("prepare_write", 1, 4, 2), ("prepare_write", 1, 20, 2)]
    kw = dict(num_blocks=12, block_size=4, slots=2, max_blocks_per_slot=8)
    assert _drive(KVPool(**kw), ops) == _drive(JPool(**kw), ops)


# ---------------------------------------------------------------------------
# Serve
# ---------------------------------------------------------------------------
PG = dict(paged_kv=True, kv_block_size=16)
BUDGET16 = dict(chunk_rows=16, max_coresident_chunks=2)


def _cfgs():
    return tuple(dataclasses.replace(get("granite-3-2b").reduced(),
                                     dtype="float32")
                 for get in (jget_config, get_config))


@pytest.fixture(scope="module")
def weights():
    jcfg, tcfg = _cfgs()
    tree = _numpy_params(jcfg)
    return (jcfg, tcfg, jax.tree_util.tree_map(jnp.asarray, tree),
            lm.params_from_numpy(tcfg, tree, device="cpu"))


def _pair(weights, max_len=64, budget=BUDGET16, **kw):
    jcfg, tcfg, jp, tp = weights
    je = jengine.ServeEngine(jcfg, jp, batch=2, max_len=max_len,
                             plan_fusion=True,
                             prefill_budget=jengine.PrefillBudget(**budget),
                             **kw)
    te = engine.ServeEngine(tcfg, tp, batch=2, max_len=max_len, device="cpu",
                            prefill_budget=engine.PrefillBudget(**budget),
                            **kw)
    return je, te


def _requests(mod, vocab, lens, buds, prefix=0, eos=None, seed=11):
    rng = np.random.default_rng(seed)
    shared = rng.integers(1, vocab, prefix).astype(np.int32)
    return [mod.Request(rid=i, prompt=np.concatenate(
                [shared, rng.integers(1, vocab, L).astype(np.int32)]),
                max_new_tokens=m, eos_token=eos)
            for i, (L, m) in enumerate(zip(lens, buds))]


def _serve(je, te, vocab, *args, tokens=True, **kw):
    rj = _requests(jengine, vocab, *args, **kw)
    rt = _requests(engine, vocab, *args, **kw)
    je.run(rj)
    te.run(rt)
    if tokens:
        assert [r.out_tokens for r in rt] == [r.out_tokens for r in rj]
    assert te.stats.describe() == je.stats.describe()
    assert (te.stats.admissions, te.stats.retirements,
            te.stats.admission_latencies) == (
        je.stats.admissions, je.stats.retirements,
        je.stats.admission_latencies)
    assert te.kv_pool.snapshot() == je.kv_pool.snapshot()
    return rt


@pytest.fixture(scope="module")
def paged_pair(weights):
    return _pair(weights, **PG)


def test_paged_serve_shared_prefix_matches_reference(weights, paged_pair):
    """A shared 32-token prefix, then the same prompts again: the pool and
    its prefix cache persist across runs, so every admission of the second
    run hits.  The port keeps the arena with the pool, so the second run
    gives the first run's tokens; the reference zeroes its arena each run
    (ROADMAP §3), so its second-run tokens are not the reference here: the
    schedule, stats and pool are."""
    je, te = paged_pair
    vocab = weights[0].vocab_size
    lens, buds = (7, 9, 5, 11), (3, 3, 3, 3)
    first = _serve(je, te, vocab, lens, buds, prefix=32)
    st = te.stats
    assert st.prefix_hits >= 2 and st.prefix_tokens_reused >= 64
    assert st.fused_prefill_chunks > 0 and st.blocks_in_use > 0
    again = _serve(je, te, vocab, lens[:2], buds[:2], prefix=32,
                   tokens=False)
    assert te.stats.prefix_hits == 2
    assert [r.out_tokens for r in again] == [r.out_tokens
                                            for r in first[:2]]


def test_paged_serve_mid_batch_eos_matches_reference(weights):
    je, te = _pair(weights, budget=dict(chunk_rows=8,
                                        max_coresident_chunks=2),
                   max_len=48, **PG)
    vocab = weights[0].vocab_size
    lens = (6, 15, 41, 9)
    probe = _serve(je, te, vocab, lens, (3, 4, 3, 2))
    eos = probe[1].out_tokens[1]
    je, te = _pair(weights, budget=dict(chunk_rows=8,
                                        max_coresident_chunks=2),
                   max_len=48, **PG)
    _serve(je, te, vocab, lens, (3, 4, 3, 2), eos=eos)
    assert any(r == "eos" for _s, _r, r in te.stats.retirements)


def test_paged_runs_fewer_chunks_than_contiguous_at_equal_tokens(
        weights, paged_pair):
    _je, paged = paged_pair
    contig = engine.ServeEngine(weights[1], weights[3], batch=2, max_len=64,
                                device="cpu",
                                prefill_budget=engine.PrefillBudget(
                                    **BUDGET16))
    vocab = weights[0].vocab_size
    rc = _requests(engine, vocab, (7, 9, 5, 11), (3, 3, 3, 3), prefix=32,
                   seed=5)
    rp = _requests(engine, vocab, (7, 9, 5, 11), (3, 3, 3, 3), prefix=32,
                   seed=5)
    contig.run(rc)
    paged.run(rp)
    assert [r.out_tokens for r in rp] == [r.out_tokens for r in rc]
    assert paged.stats.prefill_chunks < contig.stats.prefill_chunks


def test_tight_pool_evicts_and_retires_like_reference(weights):
    """A 7-block arena (5 usable) under prompts of 51..61 tokens that share
    a 16-token prefix: chunks stall, cached prefix blocks are evicted and
    slots retire pool_full exactly where the reference's do."""
    je, te = _pair(weights, kv_blocks=7, **PG)
    _serve(je, te, weights[0].vocab_size, (40, 35, 45, 38), (3, 3, 3, 3),
           prefix=16)
    assert te.stats.evictions > 0
    assert any(r == "pool_full" for _s, _r, r in te.stats.retirements)


# ---------------------------------------------------------------------------
# Launch tables
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("n", [0, 1, 2])
def test_paged_launch_tables_match_reference(n):
    budget = dict(chunk_rows=512, max_coresident_chunks=2)
    jcfg = dataclasses.replace(jget_config("granite-3-2b"), num_layers=1)
    tcfg = dataclasses.replace(get_config("granite-3-2b"), num_layers=1)
    je = jengine.ServeEngine(jcfg, None, batch=8, max_len=2048,
                             plan_fusion=True,
                             prefill_budget=jengine.PrefillBudget(**budget),
                             **PG)
    te = engine.ServeEngine(tcfg, None, batch=8, max_len=2048, device="cpu",
                            prefill_budget=engine.PrefillBudget(**budget),
                            **PG)
    got = te.build_decode_program(prefill_chunks=n).describe()
    assert got == je.build_decode_program(prefill_chunks=n).describe()
    assert te.cache_len == 2048 and te.kv_blocks == 8 * 128 + 8
    if n == 2:
        assert any(s["kind"] == "fused" and "_pg16" in s["members"]
                   for s in got)
    jc, tc = _cfgs()
    je = jengine.ServeEngine(jc, None, batch=2, max_len=48, plan_fusion=True,
                             prefill_budget=jengine.PrefillBudget(
                                 chunk_rows=8), **PG)
    te = engine.ServeEngine(tc, None, batch=2, max_len=48, device="cpu",
                            prefill_budget=engine.PrefillBudget(chunk_rows=8),
                            **PG)
    assert (te.build_decode_program(prefill_chunks=n).describe()
            == je.build_decode_program(prefill_chunks=n).describe())
    assert te.chunk_rows == 16          # a chunk is whole 16-row pages


# ---------------------------------------------------------------------------
# Refusals
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("what,kw,match", [
    ("stacked", dict(layers=2), "single-layer"),
    ("moe", dict(arch="phi3.5-moe-rms"), "MoE"),
    ("block size", dict(kv_block_size=12), "must divide"),
    ("slot blocks", dict(kv_slot_blocks=9), "multiple of 128")])
def test_paged_refusals_match_reference(what, kw, match):
    kw = dict(kw)
    arch, layers = kw.pop("arch", "granite-3-2b"), kw.pop("layers", 1)
    for get, mod, extra in ((jget_config, jengine, dict(plan_fusion=True)),
                            (get_config, engine, dict(device="cpu"))):
        cfg = get(arch).reduced()
        if layers > 1:
            cfg = dataclasses.replace(cfg, num_layers=layers,
                                      block_pattern=("attn",) * layers)
        with pytest.raises(ValueError, match=match):
            mod.ServeEngine(cfg, None, batch=2, max_len=48,
                            **{**PG, **kw}, **extra)


def test_paged_prompt_beyond_max_len_serves(weights):
    """kv_slot_blocks raises the logical capacity past max_len."""
    _j, tcfg, _jp, tp = weights
    kw = dict(batch=2, max_len=48, device="cpu",
              prefill_budget=engine.PrefillBudget(chunk_rows=8))
    long_req = _requests(engine, tcfg.vocab_size, (150,), (3,))
    with pytest.raises(ValueError, match="exceeds max_seq_len"):
        engine.ServeEngine(tcfg, tp, **kw).run(long_req)
    eng = engine.ServeEngine(tcfg, tp, kv_slot_blocks=16, **kw, **PG)
    assert eng.max_len == 48 and eng.cache_len == 256
    eng.run(long_req)
    assert len(long_req[0].out_tokens) == 3
