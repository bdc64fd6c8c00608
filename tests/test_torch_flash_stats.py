"""The flash kernel's launch with row statistics (``stats=True``) on the
CPU: a key shard's flash-decode partial ``(acc, m, l)`` from the plain
version (f32) and from ``flash_attention_tc_emulate`` (bf16, the
tensor-core kernel's arithmetic), with the keys split into 2-4 contiguous
shards and merged as ``repro_torch.dtensors.sequence_parallel_attention``
merges them, against the reference's flash kernel
(``repro.kernels.flash_attention.flash_attention``, interpret mode) over
the whole keys; each shard's row max and row sum against a float64 numpy
logsumexp of the same masked logits; the ``ops.attention`` entries with
statistics on both backends; the launch's word counter against its
access plan; and the key split over a thread-block cluster (S 2, 4 and
8: each rank's running max, the merge in rank order) with statistics,
against the plain version and, normalised, against the reference.

Cases: head dims 64, 80 and 128; GQA groups 1, 4 and 8 folded into the
query axis (``q_seq_len``); int, scalar and per-row offsets (each shard's
offset is the query's less the shard's first key, negative for a shard
past the query); key masks (a prefix of each row's keys, which the
reference's kernel takes as ``kv_lens``); key counts that end inside a
tile; a shard wholly past every query, which must report ``m = NEG_INF``
and weigh exactly 0.

Tolerance: merged outputs within 1e-4 (f32: both sides accumulate in f32,
in another order) or 3e-2 (bf16: the reference rounds its output to bf16,
the emulation rounds P to bf16) of max(1, max|reference|); m within 1e-4
of max(1, |m|) and l within 1e-4 relative (f32 logits of the same
operands, summed in another order).
"""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro_torch import ops
from repro_torch.kernels.flash_attention import (NEG_INF,
                                                 attention_stats_hbm_words,
                                                 flash_attention,
                                                 flash_attention_access_plan,
                                                 flash_attention_tc_emulate)
from repro_torch.ops import ExecutionContext
from repro_torch.verify.audit import audit_access_plan

jfa = importlib.import_module("repro.kernels.flash_attention")
TOL = {"f32": 1e-4, "bf16": 3e-2}
CASES = {  # (B * KV, g, Lq, Lk, hd, offset kind, key mask, shards)
    "hd64_g1_int": (3, 1, 5, 40, 64, "int", False, 2),
    "hd80_g1_rows_ragged": (2, 1, 4, 45, 80, "rows", False, 3),
    "hd128_g8_decode_rows": (4, 8, 1, 100, 128, "rows", False, 4),
    "hd128_g8_scalar_mask": (2, 8, 1, 70, 128, "scalar", True, 4),
    "hd64_g4_rows_mask": (2, 4, 3, 37, 64, "rows", True, 2),
    "hd80_g8_shard_past_query": (2, 8, 1, 64, 80, "early", False, 4),
}


def _inputs(case, dt):
    BH, g, Lq, Lk, hd, kind, masked, _ = CASES[case]
    rng = np.random.default_rng(11)
    q, k, v = (rng.standard_normal(s).astype(np.float32)
               for s in ((BH, g * Lq, hd), (BH, Lk, hd), (BH, Lk, hd)))
    if dt == "bf16":  # both sides see the same bf16 values
        q, k, v = (torch.from_numpy(a).to(torch.bfloat16).float().numpy()
                   for a in (q, k, v))
    off = {"int": Lk - Lq, "scalar": np.int32(Lk - Lq - 3),
           "rows": rng.integers(0, Lk - Lq + 1, BH).astype(np.int32),
           # every query before the third shard: shards 2 and 3 hold no key
           "early": rng.integers(0, Lk // 2 - Lq, BH).astype(np.int32)}[kind]
    lens = (rng.integers(Lk // 3, Lk + 1, BH).astype(np.int32) if masked
            else None)
    return q, k, v, off, lens


def _reference(q, k, v, off, lens, Lq, dt):
    """The reference's flash kernel over the whole keys (interpret mode;
    ``kv_lens`` for the key mask)."""
    jdt = jnp.bfloat16 if dt == "bf16" else jnp.float32
    joff = off if isinstance(off, int) else jnp.asarray(off)
    out = jfa.flash_attention(
        *(jnp.asarray(a, jdt) for a in (q, k, v)), causal=True,
        q_offset=joff, block_q=16, block_k=16, interpret=True, q_seq_len=Lq,
        kv_lens=None if lens is None else jnp.asarray(lens))
    return np.asarray(out.astype(jnp.float32))


def _logsumexp(q, k, off, lens, Lq, k0, k1):
    """Each folded row's (max, sum e^(x - max)) over keys [k0, k1), in
    float64, masked logits at NEG_INF."""
    BH, Lf, hd = q.shape
    s = np.einsum("bqd,bkd->bqk", q.astype(np.float64),
                  k[:, k0:k1].astype(np.float64)) / np.sqrt(hd)
    kpos = np.arange(k0, k1)
    offs = np.broadcast_to(np.asarray(off, np.int64).reshape(-1), (BH,))
    qpos = (np.arange(Lf) % Lq)[None, :] + offs[:, None]
    keep = kpos[None, None, :] <= qpos[:, :, None]
    if lens is not None:
        keep = keep & (kpos[None, None, :] < lens[:, None, None])
    s = np.where(keep, s, NEG_INF)
    m = s.max(-1)
    return m, np.exp(s - m[..., None]).sum(-1)


def _partial(dt, q, k, v, off, Lq, mask):
    if dt == "f32":
        return flash_attention(q, k, v, True, off, q_seq_len=Lq,
                               key_mask=mask, stats=True)
    return flash_attention_tc_emulate(
        q.to(torch.bfloat16), k.to(torch.bfloat16), v.to(torch.bfloat16),
        True, off, Lq, key_mask=mask, stats=True)


def _local(off, k0):
    if isinstance(off, int):
        return off - k0
    return torch.from_numpy(np.asarray(off - k0, np.int32))


@pytest.mark.parametrize("dt", sorted(TOL))
@pytest.mark.parametrize("case", sorted(CASES))
def test_shard_partials_merge_to_the_reference(case, dt):
    BH, g, Lq, Lk, hd, kind, masked, shards = CASES[case]
    q, k, v, off, lens = _inputs(case, dt)
    want = _reference(q, k, v, off, lens, Lq, dt)
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    mask = (None if lens is None else
            torch.arange(Lk)[None, :] < torch.from_numpy(lens)[:, None])
    bounds = np.linspace(0, Lk, shards + 1).astype(int)
    parts = []
    for k0, k1 in zip(bounds[:-1], bounds[1:]):
        acc, m, l_ = _partial(dt, tq, tk[:, k0:k1], tv[:, k0:k1],
                              _local(off, int(k0)), Lq,
                              None if mask is None else mask[:, k0:k1])
        assert acc.dtype == m.dtype == l_.dtype == torch.float32
        assert acc.shape == tq.shape and m.shape == l_.shape == (BH, g * Lq)
        m64, l64 = _logsumexp(q, k, off, lens, Lq, k0, k1)
        np.testing.assert_array_less(
            np.abs(m.double().numpy() - m64),
            1e-4 * np.maximum(1.0, np.abs(m64)) + 1e-300)
        np.testing.assert_array_less(np.abs(l_.double().numpy() - l64),
                                     1e-4 * l64)
        parts.append((acc, m, l_))
    m_all = torch.stack([p[1] for p in parts])
    top = m_all.amax(0)
    w = torch.exp(m_all - top)
    got = (sum(wi[..., None] * p[0] for wi, p in zip(w, parts))
           / (w * torch.stack([p[2] for p in parts])).sum(0)[..., None])
    err = float(np.abs(got.numpy() - want).max())
    assert np.isfinite(got.numpy()).all()
    assert err <= TOL[dt] * max(1.0, float(np.abs(want).max())), err
    if kind == "early":  # shards 2 and 3 lie wholly past every query
        for j in (2, 3):
            assert bool((m_all[j] == NEG_INF).all())
            assert bool((w[j] == 0).all())


@pytest.mark.parametrize("backend", ["cuda", "torch"])
def test_ops_attention_stats_entries(backend):
    """``ops.attention(..., stats=True)`` on the (B, H, L, hd) layout: the
    ``cuda`` entry (the kernel's plain version on the CPU, GQA folded) and
    the ``torch`` entry (aten) return the same partial as the folded plain
    version, for a per-row and a negative offset."""
    B, H, KV, Lk, hd = 2, 8, 2, 24, 64
    rng = np.random.default_rng(5)
    q, k, v = (torch.from_numpy(rng.standard_normal(s).astype(np.float32))
               for s in ((B, H, 1, hd), (B, KV, Lk, hd), (B, KV, Lk, hd)))
    ctx = ExecutionContext(backend=backend, device="cpu")
    for off in (torch.tensor([20, -3], dtype=torch.int32),
                torch.tensor(-1, dtype=torch.int32)):
        acc, m, l_ = ops.attention(q, k, v, q_offset=off, ctx=ctx,
                                   stats=True)
        rows = off[:, None].expand(B, KV).reshape(-1) if off.ndim else off
        want = flash_attention(q.reshape(B * KV, H // KV, hd),
                               k.reshape(B * KV, Lk, hd),
                               v.reshape(B * KV, Lk, hd), True, rows,
                               q_seq_len=1, stats=True)
        for got, ref in zip((acc, m, l_), want):
            assert got.shape[:2] == (B, H)
            torch.testing.assert_close(got.reshape(ref.shape), ref,
                                       rtol=1e-5, atol=1e-5)
        if not off.ndim:  # every query before the shard: no valid key
            assert bool((m == NEG_INF).all())


@pytest.mark.parametrize("shape", [(16, 8, 8192), (16, 8, 32768),
                                   (4, 24, 40)])
def test_stats_counter_is_the_access_plan(shape):
    """The port's counter of a launch with statistics (the f32 output and
    two f32 words a row on top of the reference's counter at the same
    tiles) equals its access plan's counted words, at the rank's and one
    card's decode shapes of Qwen2.5-3B and at a ragged one; the plan is
    hazard-free."""
    BH, Lq, Lk = shape
    ap = flash_attention_access_plan(BH, Lq, Lk, 128, 64, 64, 0.5, 0.5,
                                     stats=True)
    rep = audit_access_plan(ap)
    assert rep.hazards == [] and rep.problems == []
    assert rep.counted_words == attention_stats_hbm_words(
        BH, Lq, Lk, 128, 64, 64, p_q=0.5, p_kv=0.5)


SPLIT_CASES = {  # (Lk, block, S, offsets): 4 rows x 8 folded queries, hd 64
    "b64_S2_scalar": (1000, 64, 2, "scalar"),
    "b64_S4_rows": (1500, 64, 4, "rows"),
    "b32_S8_rows": (2048, 32, 8, "rows"),
    "b32_S8_negative": (1027, 32, 8, "negative"),
    "b64_S8_empty_ranks": (200, 64, 8, "rows"),
}


@pytest.mark.parametrize("case", sorted(SPLIT_CASES))
def test_split_stats_match_the_plain_version_and_the_reference(case):
    """The split launch's partial ``(acc, m, l)`` (``flash_attention_tc_
    emulate(..., stats=True, split=S)``) against the plain version's (acc
    within the bf16 tolerance of max(1, max|acc|), m and l as above), and
    acc / l against the reference's flash kernel on the rows with a valid
    key; a row (or, with the negative offset, every row) with no valid key
    reports m = NEG_INF and l = Lk, every key at weight 1."""
    Lk, block, S, kind = SPLIT_CASES[case]
    rng = np.random.default_rng(23)
    q, k, v = (torch.from_numpy(rng.standard_normal(sh).astype(np.float32))
               .to(torch.bfloat16)
               for sh in ((4, 8, 64), (4, Lk, 64), (4, Lk, 64)))
    off = {"scalar": np.int32(Lk - 10), "negative": -5,
           "rows": np.array([Lk - 1, Lk // 2, -7, 3], np.int32)}[kind]
    toff = off if isinstance(off, int) else torch.from_numpy(np.asarray(off))
    acc, m, l_ = flash_attention_tc_emulate(q, k, v, True, toff, 1,
                                            block=block, stats=True,
                                            split=S)
    pa, pm, pl = flash_attention(q.float(), k.float(), v.float(), True,
                                 toff, q_seq_len=1, stats=True)
    assert acc.dtype == m.dtype == l_.dtype == torch.float32
    err = (acc - pa).abs().max().item()
    assert err <= TOL["bf16"] * max(1.0, pa.abs().max().item()), err
    torch.testing.assert_close(m, pm, rtol=0, atol=1e-4)
    torch.testing.assert_close(l_, pl, rtol=1e-4, atol=0)
    live = np.broadcast_to(np.asarray(off), (4,)) >= 0
    assert bool((m[~live] == NEG_INF).all()) and bool((l_[~live] == Lk).all())
    if live.any():
        want = _reference(q.float().numpy(), k.float().numpy(),
                          v.float().numpy(), off, None, 1, "bf16")
        got = (acc / l_[..., None]).numpy()
        assert np.abs(got[live] - want[live]).max() <= TOL["bf16"] * max(
            1.0, float(np.abs(want[live]).max()))
