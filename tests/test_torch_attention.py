"""repro_torch's attention against repro's: the plain versions of the flash
and paged-decode kernels against the reference's Pallas kernels (interpret
mode) and its XLA versions, on the same numpy inputs; the two HBM-word
counters, the tile sizes and the attention plans (H100 and TPU_V5E presets,
JSON both ways) exactly equal; and the ops layer's attention dispatch.

Tolerances: f32 inputs 1e-5 (both sides compute logits, softmax and PV in
f32, in a different order); bf16 inputs 2e-2 (the outputs round to bf16
once: 2^-8 relative on values of magnitude up to ~2).
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.plan as jp
import repro_torch.plan as tp
from repro import ops as jops
from repro.ops.registry import xla_attention, xla_attention_decode
from repro_torch import ops as tops
from repro_torch.kernels import (KERNELS, attention_blocks,
                                 attention_hbm_words, flash_attention,
                                 flash_attention_plain,
                                 paged_decode_attention,
                                 paged_decode_hbm_words, paged_decode_plain,
                                 ref)

jfa = importlib.import_module("repro.kernels.flash_attention")
jref = importlib.import_module("repro.kernels.ref")

DTYPES = {"f32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}
J_H100 = jp.HardwareTarget.from_dict(tp.H100.to_dict())
J_CTX = jops.ExecutionContext(target=J_H100, backend="pallas", interpret=True)
CPU = tops.ExecutionContext(device="cpu")  # H100 plans, cuda backend


def _tol(dt):
    return dict(rtol=2e-2, atol=2e-2) if dt == "bf16" else \
        dict(rtol=1e-5, atol=1e-5)


def _pair(arr, dt):
    jd, td = DTYPES[dt]
    return jnp.asarray(arr, jd), torch.from_numpy(np.asarray(arr)).to(td)


def _randn(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def _close(got, want, dt):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), **_tol(dt))


# -- the flash kernel's plain version --------------------------------------

FLASH_CASES = {  # (BH, g, Lq, Lk, hd, q_offset kind)
    "g1_int": (4, 1, 13, 13, 16, "int"),
    "g4_int_offset": (2, 4, 5, 19, 16, "int"),
    "g2_ragged_blocks": (2, 2, 37, 70, 32, "int"),
    "g4_scalar": (2, 4, 3, 24, 16, "scalar"),
    "g2_rows": (4, 2, 1, 30, 16, "rows"),
    "g1_rows": (3, 1, 6, 21, 64, "rows"),
}


def _flash_inputs(case, dt, seed=0):
    BH, g, Lq, Lk, hd, kind = FLASH_CASES[case]
    rng = np.random.default_rng(seed)
    q, k, v = (_randn(rng, BH, g * Lq, hd), _randn(rng, BH, Lk, hd),
               _randn(rng, BH, Lk, hd))
    off = {"int": Lk - Lq, "scalar": np.int32(Lk - Lq - 2),
           "rows": rng.integers(0, Lk - Lq + 1, BH).astype(np.int32)}[kind]
    return (_pair(q, dt), _pair(k, dt), _pair(v, dt)), off, Lq


@pytest.mark.parametrize("case", sorted(FLASH_CASES))
@pytest.mark.parametrize("dt", sorted(DTYPES))
def test_flash_plain_matches_pallas_interpret(case, dt):
    """The plain version on the folded layout against the reference's
    flash kernel (its static or scalar-prefetch path) in interpret mode,
    with blocks small enough that several key tiles stream."""
    ((jq, tq), (jk, tk), (jv, tv)), off, Lq = _flash_inputs(case, dt)
    joff = off if isinstance(off, int) else jnp.asarray(off)
    toff = off if isinstance(off, int) else torch.from_numpy(np.asarray(off))
    want = jfa.flash_attention(jq, jk, jv, causal=True, q_offset=joff,
                               block_q=16, block_k=16, interpret=True,
                               q_seq_len=Lq)
    got = flash_attention(tq, tk, tv, causal=True, q_offset=toff,
                          q_seq_len=Lq)
    assert got.dtype == tq.dtype and got.shape == tq.shape
    _close(got, want, dt)


@pytest.mark.parametrize("dt", sorted(DTYPES))
def test_flash_plain_kv_lens_matches_pallas_interpret(dt):
    """Per-row key lengths (the dynamic kernel's ``kv_lens`` operand)."""
    rng = np.random.default_rng(1)
    (jq, tq), (jk, tk), (jv, tv) = (_pair(_randn(rng, 4, 6, 16), dt),
                                    _pair(_randn(rng, 4, 20, 16), dt),
                                    _pair(_randn(rng, 4, 20, 16), dt))
    lens = np.array([20, 7, 1, 13], np.int32)
    want = jfa.flash_attention(jq, jk, jv, causal=False, block_q=8,
                               block_k=8, interpret=True,
                               kv_lens=jnp.asarray(lens))
    got = flash_attention(tq, tk, tv, causal=False,
                          kv_lens=torch.from_numpy(lens))
    _close(got, want, dt)


ATTN_CASES = {  # (B, H, KV, Lq, Lk, hd, offset kind, key mask)
    "gqa_int": (2, 4, 2, 7, 7, 16, "int", False),
    "mha_int": (2, 3, 3, 5, 9, 16, "int", False),
    "gqa_scalar_mask": (2, 4, 2, 8, 16, 16, "scalar", True),
    "gqa_rows": (3, 8, 2, 1, 12, 32, "rows", False),
    "mha_mask": (2, 2, 2, 6, 6, 16, "int", True),
    "gqa_rows_mask": (2, 4, 1, 1, 10, 16, "rows", True),
}


def _attn_inputs(case, dt, seed=0):
    B, H, KV, Lq, Lk, hd, kind, masked = ATTN_CASES[case]
    rng = np.random.default_rng(seed)
    arrs = [_pair(_randn(rng, *s), dt) for s in
            ((B, H, Lq, hd), (B, KV, Lk, hd), (B, KV, Lk, hd))]
    off = {"int": Lk - Lq, "scalar": np.int32(Lk - Lq),
           "rows": rng.integers(0, Lk - Lq + 1, B).astype(np.int32)}[kind]
    mask = None
    if masked:  # pad tails of different lengths; key 0 always valid
        mask = np.ones((B, Lk), bool)
        for b in range(B):
            mask[b, Lk - b - 1:] = False
    return arrs, off, mask


def _as(off, mask):
    jo = off if isinstance(off, int) else jnp.asarray(off)
    to = off if isinstance(off, int) else torch.from_numpy(np.asarray(off))
    jm = None if mask is None else jnp.asarray(mask)
    tm = None if mask is None else torch.from_numpy(mask)
    return jo, to, jm, tm


@pytest.mark.parametrize("case", sorted(ATTN_CASES))
@pytest.mark.parametrize("dt", sorted(DTYPES))
def test_attention_ops_match_xla(case, dt):
    """ops.attention on the cuda entry (the kernel's plain version on the
    CPU, GQA folded) and on the torch entry against the reference's
    xla_attention, for int, scalar and per-row offsets and key masks."""
    ((jq, tq), (jk, tk), (jv, tv)), off, mask = _attn_inputs(case, dt)
    jo, to, jm, tm = _as(off, mask)
    want = xla_attention(jq, jk, jv, causal=True, q_offset=jo, key_mask=jm)
    for backend in ("cuda", "torch"):
        ctx = tops.ExecutionContext(backend=backend, device="cpu")
        with tops.record_dispatch() as log:
            got = tops.attention(tq, tk, tv, causal=True, q_offset=to,
                                 key_mask=tm, ctx=ctx)
        _close(got, want, dt)
        assert [d.chosen for d in log] == [backend]
        assert not log[0].fell_back


@pytest.mark.parametrize("case", sorted(ATTN_CASES))
def test_attention_needs_and_capabilities(case):
    """The call features are derived as in the reference; the cuda entry
    serves all three (the Pallas entry declines key masks and the reference
    falls back to xla for them)."""
    ((jq, tq), (jk, tk), (jv, tv)), off, mask = _attn_inputs(case, "f32")
    jo, to, jm, tm = _as(off, mask)
    needs = tops.attention_needs(to, tm)
    assert needs == jops.dispatch.attention_needs(jo, jm)
    d = tops.explain("attention", CPU, dtype=tq.dtype, needs=needs,
                     spec_args=(tq, tk, tv))
    assert d.chosen == "cuda" and not d.fell_back
    jd = jops.explain("attention", J_CTX, dtype=str(jq.dtype), needs=needs,
                      spec_args=(jq, jk, jv))
    assert jd.chosen == ("xla" if mask is not None else "pallas")


def test_fully_masked_rows_average_v():
    """With the finite -1e30 a row whose keys are all masked averages V, as
    the reference: neither zeros nor NaN (dead serving rows)."""
    rng = np.random.default_rng(2)
    q, k, v = (_randn(rng, 2, 4, 3, 16), _randn(rng, 2, 2, 8, 16),
               _randn(rng, 2, 2, 8, 16))
    mask = np.zeros((2, 8), bool)
    mask[1] = True
    want = xla_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                         causal=True, key_mask=jnp.asarray(mask))
    got = tops.attention(torch.from_numpy(q), torch.from_numpy(k),
                         torch.from_numpy(v), key_mask=torch.from_numpy(mask),
                         ctx=CPU)
    _close(got, want, "f32")
    mean_v = v[0].mean(axis=1)  # (KV, hd)
    np.testing.assert_allclose(got[0, :2, 0].numpy(), mean_v[[0]].repeat(2, 0),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("dt", sorted(DTYPES))
def test_flash_attention_ref_matches_reference(dt):
    rng = np.random.default_rng(3)
    (jq, tq), (jk, tk), (jv, tv) = (_pair(_randn(rng, 2, 4, 5, 16), dt),
                                    _pair(_randn(rng, 2, 2, 9, 16), dt),
                                    _pair(_randn(rng, 2, 2, 9, 16), dt))
    for off in (0, 4):
        _close(ref.flash_attention_ref(tq, tk, tv, q_offset=off),
               jref.flash_attention_ref(jq, jk, jv, q_offset=off), dt)


# -- the paged kernel's plain version --------------------------------------

def _paged_inputs(dt, B=4, KV=2, g=4, hd=16, bs=4, w=5, seed=0):
    rng = np.random.default_rng(seed)
    nb = 1 + B * w
    kp, vp = _randn(rng, nb, KV, bs, hd), _randn(rng, nb, KV, bs, hd)
    q = _randn(rng, B, KV * g, 1, hd)
    tables = (1 + rng.permutation(nb - 1)[:B * w]).reshape(B, w).astype(
        np.int32)
    tables[1, 2:] = 0   # padding points at garbage block 0
    tables[B - 1, :] = 0  # a dead row
    lengths = np.array([w * bs, 2 * bs - 1, 1, 0], np.int32)[:B]
    return [_pair(a, dt) for a in (q, kp, vp)], tables, lengths


@pytest.mark.parametrize("dt", sorted(DTYPES))
def test_paged_plain_matches_pallas_and_xla(dt):
    """Dead rows and padding at block 0, lengths {w*bs, 2*bs-1, 1, 0}."""
    ((jq, tq), (jk, tk), (jv, tv)), tables, lengths = _paged_inputs(dt)
    want = jfa.paged_decode_attention(jq, jk, jv, jnp.asarray(tables),
                                      jnp.asarray(lengths), interpret=True)
    want_x = xla_attention_decode(jq, jk, jv, jnp.asarray(tables),
                                  jnp.asarray(lengths))
    tt, tl = torch.from_numpy(tables), torch.from_numpy(lengths)
    got = paged_decode_attention(tq, tk, tv, tt, tl)
    _close(got, want, dt)
    _close(got, want_x, dt)
    for backend in ("cuda", "torch"):
        ctx = tops.ExecutionContext(backend=backend, device="cpu")
        _close(tops.attention_decode(tq, tk, tv, tt, tl, ctx=ctx), want, dt)


def test_paged_plain_g1_and_single_block():
    ((jq, tq), (jk, tk), (jv, tv)), tables, lengths = _paged_inputs(
        "f32", B=3, KV=3, g=1, hd=32, bs=8, w=1, seed=4)
    lengths = np.array([8, 3, 1], np.int32)
    want = jfa.paged_decode_attention(jq, jk, jv, jnp.asarray(tables),
                                      jnp.asarray(lengths), interpret=True)
    got = paged_decode_attention(tq, tk, tv, torch.from_numpy(tables),
                                 torch.from_numpy(lengths))
    _close(got, want, "f32")


# -- counters, tiles, plans -------------------------------------------------

WORD_SHAPES = [(8, 1, 37, 16), (8, 16, 512, 128), (4, 1664, 512, 128),
               (2, 200, 37, 64), (3, 9, 9, 32), (1, 64, 64, 128)]


@pytest.mark.parametrize("target", ["H100", "TPU_V5E"])
@pytest.mark.parametrize("p_kv", [0.5, 1.0])
def test_attention_words_and_blocks_equal(target, p_kv):
    tt = getattr(tp, target)
    jt = jp.HardwareTarget.from_dict(tt.to_dict())
    for BH, Lq, Lk, hd in WORD_SHAPES:
        blocks = attention_blocks(hd, tt, kv_word=p_kv)
        assert blocks == tuple(jfa.attention_blocks(hd, jt, kv_word=p_kv))
        for p_q in (0.5, 1.0):
            assert attention_hbm_words(BH, Lq, Lk, hd, *blocks, p_q=p_q,
                                       p_kv=p_kv, p_o=p_q) == \
                jfa.attention_hbm_words(BH, Lq, Lk, hd, *blocks, p_q=p_q,
                                        p_kv=p_kv, p_o=p_q)


def test_paged_words_equal():
    for B, KV, g, w, bs, hd in [(4, 2, 8, 32, 16, 128), (1, 1, 1, 1, 8, 16),
                                (8, 10, 4, 7, 16, 128), (3, 32, 1, 5, 4, 64)]:
        for p in (0.5, 1.0):
            assert paged_decode_hbm_words(B, KV, g, w, bs, hd, p, p, p) == \
                jfa.paged_decode_hbm_words(B, KV, g, w, bs, hd, p, p, p)


def test_h100_attention_tiles():
    """hd 128 with bf16 K/V: bq = bk = 64 in M_eff = 29,056 words; hd 16:
    128. Every H100 block the serving configs need has a compiled
    instance."""
    assert tp.H100.memory_model().M_eff == 29056.0
    assert attention_blocks(128, tp.H100, kv_word=0.5) == (64, 64)
    assert attention_blocks(16, tp.H100, kv_word=0.5) == (128, 128)
    from repro_torch.kernels.flash_attention import FLASH_INSTANCES
    for hd in (16, 32, 64, 128):
        for p_kv in (0.5, 1.0):
            assert (hd, attention_blocks(hd, tp.H100, kv_word=p_kv)[0]) in \
                FLASH_INSTANCES


ATTN_SPECS = [(1, 16, 2, 200, 512, 128), (4, 16, 2, 1, 512, 128),
              (2, 32, 32, 37, 37, 64), (4, 40, 10, 1, 256, 128),
              (1, 4, 2, 9, 9, 16)]


@pytest.mark.parametrize("target", ["H100", "TPU_V5E"])
@pytest.mark.parametrize("prec", [None, (0.5, 0.5, 0.5), (1.0, 1.0, 1.0)],
                         ids=["target_prec", "bf16", "f32"])
def test_attention_plans_equal_and_cross(target, prec):
    from repro.core.conv_model import Precision as JPrecision
    from repro_torch.core.conv_model import Precision

    tt = getattr(tp, target)
    jt = jp.HardwareTarget.from_dict(tt.to_dict())
    for B, H, KV, Lq, Lk, hd in ATTN_SPECS:
        top = tp.AttentionSpec(B, H, KV, Lq, Lk, hd,
                               prec=prec and Precision(*prec))
        jop = jp.AttentionSpec(B, H, KV, Lq, Lk, hd,
                               prec=prec and JPrecision(*prec))
        tplan, jplan = tp.Planner(tt).plan(top), jp.Planner(jt).plan(jop)
        for f in ("tiles", "grid", "blocking", "comm_volume", "lower_bound",
                  "efficiency", "dtypes"):
            assert getattr(tplan, f) == getattr(jplan, f), f
        back = jp.ExecutionPlan.from_json(tplan.to_json())
        assert back.tiles == jplan.tiles and back.op == jop
        fwd = tp.ExecutionPlan.from_json(jplan.to_json())
        assert fwd.tiles == tplan.tiles and fwd.op == top
        assert fwd.to_dict() == tplan.to_dict()


@pytest.mark.parametrize("target", ["H100", "TPU_V5E"])
def test_explain_attention_matches_reference(target):
    """measured_words, lower bound and bound ratio of the cuda entries equal
    the pallas entries' for the same shapes (meta tensors: only shapes)."""
    tt = getattr(tp, target)
    jt = jp.HardwareTarget.from_dict(tt.to_dict())
    tctx = tops.ExecutionContext(target=tt, backend="cuda", device="cpu")
    jctx = jops.ExecutionContext(target=jt, backend="pallas", interpret=True)
    for B, H, KV, Lq, Lk, hd in ATTN_SPECS:
        tq = torch.empty((B, H, Lq, hd), dtype=torch.bfloat16, device="meta")
        tk = torch.empty((B, KV, Lk, hd), dtype=torch.bfloat16, device="meta")
        jq = jax.ShapeDtypeStruct((B, H, Lq, hd), jnp.bfloat16)
        jk = jax.ShapeDtypeStruct((B, KV, Lk, hd), jnp.bfloat16)
        d = tops.explain("attention", tctx, dtype=tq.dtype,
                         spec_args=(tq, tk, tk))
        jd = jops.explain("attention", jctx, dtype="bfloat16",
                          spec_args=(jq, jk, jk))
        assert d.measured_words == jd.measured_words
        assert d.lower_bound == jd.lower_bound
        assert d.bound_ratio == jd.bound_ratio
        if Lq == 1:
            nb, bs, w = 64, 16, Lk // 16
            tkp = torch.empty((nb, KV, bs, hd), dtype=torch.bfloat16,
                              device="meta")
            tt_ = torch.empty((B, w), dtype=torch.int32, device="meta")
            tl = torch.empty((B,), dtype=torch.int32, device="meta")
            jkp = jax.ShapeDtypeStruct((nb, KV, bs, hd), jnp.bfloat16)
            jt_ = jax.ShapeDtypeStruct((B, w), jnp.int32)
            jl = jax.ShapeDtypeStruct((B,), jnp.int32)
            d = tops.explain("attention_decode", tctx, dtype=tq.dtype,
                             spec_args=(tq, tkp, tkp, tt_, tl))
            jd = jops.explain("attention_decode", jctx, dtype="bfloat16",
                              spec_args=(jq, jkp, jkp, jt_, jl))
            assert d.measured_words == jd.measured_words
            assert d.bound_ratio == jd.bound_ratio


# -- the wrappers' device rules ---------------------------------------------

def test_cuda_tensors_never_take_the_plain_versions():
    """A tensor that is not on the CPU goes to the kernel or raises."""
    q = torch.empty((4, 8, 16), device="meta")
    with pytest.raises(ValueError, match="CUDA device"):
        flash_attention(q, q, q)
    qd = torch.empty((2, 4, 1, 16), device="meta")
    pool = torch.empty((5, 2, 4, 16), device="meta")
    with pytest.raises(ValueError, match="CUDA device"):
        paged_decode_attention(qd, pool, pool,
                               torch.zeros((2, 3), dtype=torch.int32),
                               torch.ones(2, dtype=torch.int32))
    assert KERNELS["flash_attention"].launches == 0
    assert KERNELS["paged_decode"].launches == 0


def test_flash_gradient_recomputes_through_aten():
    rng = np.random.default_rng(5)
    q = torch.from_numpy(_randn(rng, 2, 4, 6, 16)).requires_grad_()
    k = torch.from_numpy(_randn(rng, 2, 2, 6, 16)).requires_grad_()
    v = torch.from_numpy(_randn(rng, 2, 2, 6, 16)).requires_grad_()
    tops.attention(q, k, v, ctx=CPU).square().sum().backward()
    grads = [t.grad.clone() for t in (q, k, v)]
    for t in (q, k, v):
        t.grad = None
    tops.torch_attention(q, k, v).square().sum().backward()
    for g, t in zip(grads, (q, k, v)):
        torch.testing.assert_close(g, t.grad, rtol=1e-5, atol=1e-5)


@pytest.mark.cuda
def test_attention_kernels_match_plain_on_the_card():
    """The two hand-written kernels against their plain versions (runs only
    where there is a GPU and nvcc; chip_smoke.py runs the full set). The
    main-path flash and paged-decode shapes are held to chip_smoke.py's
    bf16 tolerance, 2^-7 x max(1, max|plain|)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: CUDA kernels have no CPU mode")
    ((_, tq), (_, tk), (_, tv)), off, Lq = _flash_inputs("g2_ragged_blocks",
                                                         "bf16")
    tq, tk, tv = tq.cuda(), tk.cuda(), tv.cuda()
    got = flash_attention(tq, tk, tv, q_offset=off, q_seq_len=Lq)
    torch.testing.assert_close(got.float(), flash_attention_plain(
        tq, tk, tv, True, off, Lq).float(), rtol=2e-2, atol=2e-2)
    # the main path's shapes (Qwen2.5-3B, hd 128, 8 query heads a kv head):
    # a prefill of 176 queries with a pad-tail key mask, and a decode step
    # of 4 rows at their own depths, both on the tensor-core kernel
    rng = np.random.default_rng(11)
    for rows, Lq, Lk, offs, masked in (
            (2, 176, 512, np.zeros(2, np.int32), True),
            (8, 1, 512, np.repeat([230, 120, 60, 17], 2).astype(np.int32),
             False)):
        q, k, v = (torch.from_numpy(_randn(rng, rows, n, 128)).to(
            torch.bfloat16).cuda() for n in (8 * Lq, Lk, Lk))
        off = torch.from_numpy(offs).cuda()
        km = None
        if masked:
            km = torch.ones((1, Lk), dtype=torch.bool, device="cuda")
            km[0, 170:Lq] = False
        tc = KERNELS["flash_attention"].tensor_core_launches
        got = flash_attention(q, k, v, q_offset=off, q_seq_len=Lq,
                              key_mask=km)
        assert KERNELS["flash_attention"].tensor_core_launches == tc + 1
        want = flash_attention_plain(q, k, v, True, off, Lq, None, km)
        err = (got.float() - want.float()).abs().max().item()
        assert err <= 2.0 ** -7 * max(1.0, want.float().abs().max().item())
    ((_, q), (_, kp), (_, vp)), tables, lengths = _paged_inputs("bf16")
    args = (q.cuda(), kp.cuda(), vp.cuda(), torch.from_numpy(tables).cuda(),
            torch.from_numpy(lengths).cuda())
    torch.testing.assert_close(paged_decode_attention(*args).float(),
                               paged_decode_plain(*args).float(),
                               rtol=2e-2, atol=2e-2)
    # Qwen's paged decode step (B 4, KV 2, g 8, hd 128, blocks of 16, w 15)
    # at the serve's depths, on the tensor-core kernel
    ((_, q), (_, kp), (_, vp)), tables, _ = _paged_inputs(
        "bf16", B=4, KV=2, g=8, hd=128, bs=16, w=15, seed=12)
    lengths = np.array([205, 151, 120, 41], np.int32)
    for r, n in enumerate(lengths):
        tables[r, -(-n // 16):] = 0  # padding points at garbage block 0
    args = (q.cuda(), kp.cuda(), vp.cuda(), torch.from_numpy(tables).cuda(),
            torch.from_numpy(lengths).cuda())
    tc = KERNELS["paged_decode"].tensor_core_launches
    got = paged_decode_attention(*args)
    assert KERNELS["paged_decode"].tensor_core_launches == tc + 1
    want = paged_decode_plain(*args)
    err = (got.float() - want.float()).abs().max().item()
    assert err <= 2.0 ** -7 * max(1.0, want.float().abs().max().item())
