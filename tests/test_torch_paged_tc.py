"""The redesigned paged-decode kernel (``csrc/paged_decode.cu``) on the CPU:
its arithmetic, modelled by ``paged_decode_tc_emulate`` (the S CTAs of a
(row, kv head) cluster from ``paged_launch_config``, the dead-slot skip,
an online softmax in the log2 domain a slab, P rounded to bf16 on the
tensor-core instance, the warps' and the cluster's merges), against the
reference's ``_paged_decode_kernel`` in interpret mode and the port's plain
version, on the same numpy inputs; its launch configuration, which reads
the shapes only; the words it issues against the reference's counter; and
the launch constants the source and the wrapper share.

Tolerances, as ``chip_smoke.py`` states them: an output agrees when
max|got - want| <= tol x max(1, max|want|), with tol 2^-7 for bf16 (one
bf16 rounding of the output on each side; P's bf16 rounding, 2^-9 relative
a probability, well inside it) and 1e-4 for the f32 instance (both sides
sum in f32, in another order).
"""

import importlib
import inspect
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_attention import _paged_inputs

from repro_torch.kernels import (paged_decode_attention,
                                 paged_decode_hbm_words, paged_decode_plain)
from repro_torch.kernels._build import CSRC, MAX_SMEM_BYTES
from repro_torch.kernels.flash_attention import (PAGED_HEAD_DIMS,
                                                 PAGED_KEY_TILE,
                                                 PAGED_MAX_GROUP,
                                                 PAGED_MAX_SPLIT, PAGED_RING,
                                                 PAGED_TARGET_CTAS,
                                                 PAGED_WARPS,
                                                 paged_cta_keys,
                                                 paged_decode_issued_words,
                                                 paged_decode_tc_emulate,
                                                 paged_launch_config,
                                                 paged_live_slots)

jfa = importlib.import_module("repro.kernels.flash_attention")
TOL = {"bf16": 2.0 ** -7, "f32": 1e-4}
# the split at the test shapes (B 4, KV 2): 8 CTAs a cluster whenever w >= 8
S = PAGED_MAX_SPLIT
WIDTHS = (1, S - 1, S, 3 * S + 1)


def _check(got, want, dt):
    got = np.asarray(got.float().numpy(), np.float32)
    want = np.asarray(want.float().numpy() if torch.is_tensor(want) else
                      np.asarray(want, np.float32), np.float32)
    assert got.shape == want.shape and np.isfinite(got).all()
    err = np.abs(got - want).max()
    allowed = TOL[dt] * max(1.0, float(np.abs(want).max()))
    assert err <= allowed, (err, allowed)


def _case(dt, g, hd, bs, w):
    """Rows of lengths w*bs, 2*bs - 1, 1 and 0; rows 1 and 3 padded with
    garbage block 0 (row 3 dead), as the plain version's own test."""
    ((jq, tq), (jk, tk), (jv, tv)), tables, lengths = _paged_inputs(
        dt, B=4, KV=2, g=g, hd=hd, bs=bs, w=w, seed=hd + 7 * g + bs + w)
    want = jfa.paged_decode_attention(jq, jk, jv, jnp.asarray(tables),
                                      jnp.asarray(lengths), interpret=True)
    targs = (tq, tk, tv, torch.from_numpy(tables), torch.from_numpy(lengths))
    return targs, want


# -- the model of the kernel against the reference and the plain version ---

@pytest.mark.parametrize("w", WIDTHS)
@pytest.mark.parametrize("bs", [4, 16])
@pytest.mark.parametrize("hd", [16, 128])
@pytest.mark.parametrize("g", [1, 8, 16])
@pytest.mark.parametrize("dt", ["bf16", "f32"])
def test_emulate_matches_pallas_interpret(dt, g, hd, bs, w):
    """The tensor-core instance's arithmetic (bf16) and the FMA instance's
    (f32) against the reference's kernel in interpret mode and the plain
    version: g in {1, 8, 16}, hd in {16, 128}, blocks of 4 and 16 keys, w
    in {1, S - 1, S, 3S + 1} (several slots a CTA), a length-0 row."""
    targs, want = _case(dt, g, hd, bs, w)
    got = paged_decode_tc_emulate(*targs)
    assert got.dtype == targs[0].dtype and got.shape == targs[0].shape
    _check(got, want, dt)
    _check(got, paged_decode_plain(*targs), dt)


def test_emulate_g8_serving_shape():
    """Qwen2.5-3B's decode step (B 4, KV 2, g 8, hd 128, blocks of 16) at
    phase 8's table width and the serve's depths, bf16."""
    rng = np.random.default_rng(3)
    B, KV, g, hd, bs, w = 4, 2, 8, 128, 16, 13
    nb = 1 + B * w
    kp = rng.standard_normal((nb, KV, bs, hd)).astype(np.float32)
    vp = rng.standard_normal((nb, KV, bs, hd)).astype(np.float32)
    q = rng.standard_normal((B, KV * g, 1, hd)).astype(np.float32)
    tables = (1 + rng.permutation(nb - 1)[:B * w]).reshape(B, w).astype(
        np.int32)
    lengths = np.array([205, 151, 120, 41], np.int32)
    for r, n in enumerate(lengths):
        tables[r, -(-n // bs):] = 0
    want = jfa.paged_decode_attention(
        *(jnp.asarray(a, jnp.bfloat16) for a in (q, kp, vp)),
        jnp.asarray(tables), jnp.asarray(lengths), interpret=True)
    got = paged_decode_tc_emulate(
        *(torch.from_numpy(a).to(torch.bfloat16) for a in (q, kp, vp)),
        torch.from_numpy(tables), torch.from_numpy(lengths))
    _check(got, want, "bf16")


def test_length_zero_row_averages_v_over_all_slots():
    """A row of length 0 walks all w slots and averages V over them, as the
    reference's finite NEG_INF does; no other row changes it."""
    [(_, tq), (_, tk), (_, tv)], _, _ = _paged_inputs(
        "f32", B=4, KV=2, g=2, hd=16, bs=4, w=9)
    tables = torch.arange(1, 37, dtype=torch.int32).reshape(4, 9)
    lengths = torch.tensor([0, 0, 5, 0], dtype=torch.int32)
    got = paged_decode_tc_emulate(tq, tk, tv, tables, lengths)
    for b in (0, 1, 3):
        mean = tv[tables[b].long()].mean(dim=(0, 2))  # (KV, hd)
        want = mean.repeat_interleave(2, dim=0)[:, None]
        torch.testing.assert_close(got[b], want, rtol=1e-5, atol=1e-5)
    assert paged_live_slots(0, 9, 4) == 9 and paged_live_slots(-3, 9, 4) == 9


def test_cpu_wrapper_is_the_plain_version():
    """On CPU tensors the wrapper runs the plain version, never the model
    of the kernel (which only the tests call)."""
    targs, _ = _case("bf16", 8, 16, 4, S)
    torch.testing.assert_close(paged_decode_attention(*targs),
                               paged_decode_plain(*targs), rtol=0, atol=0)


# -- the launch: shapes only -----------------------------------------------

CONFIG_SHAPES = [(B, KV, w) for B in (1, 3, 4, 32, 256)
                 for KV in (1, 2, 8) for w in (1, 2, 7, 8, 9, 13, 15, 25,
                                                32, 100, 1000)]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_launch_config_gives_every_slot_to_one_cta(dtype):
    """Every table slot goes to exactly one CTA of its cluster, in order;
    no CTA is empty by shape; S <= 8 (the portable cluster size) and <= w;
    the shared memory fits one H100 block at every head dim."""
    for B, KV, w in CONFIG_SHAPES:
        cfg = paged_launch_config(B, KV, 8, 128, 16, w, dtype)
        s, spc = cfg["split"], cfg["slots_per_cta"]
        assert 1 <= s <= min(PAGED_MAX_SPLIT, w)
        taken = [j for r in range(s)
                 for j in range(r * spc, min((r + 1) * spc, w))]
        assert taken == list(range(w))
        assert all(r * spc < w for r in range(s))
        assert cfg["grid"] == (s, KV, B) and cfg["cluster"] == (s, 1, 1)
        assert cfg["ctas"] == s * KV * B
        if B * KV * min(PAGED_MAX_SPLIT, w) <= PAGED_TARGET_CTAS:
            # a small grid: the fewest slots a CTA that 8 CTAs can take
            assert spc == -(-w // min(PAGED_MAX_SPLIT, w))
    for hd in PAGED_HEAD_DIMS:
        cfg = paged_launch_config(4, 2, 16, hd, 16, 32, dtype)
        assert cfg["smem"] <= MAX_SMEM_BYTES
        assert cfg["warps"] == PAGED_WARPS
        assert cfg["kernel"] == ("tensor core" if dtype == torch.bfloat16
                                 else "fma")


def test_launch_config_at_the_serving_shapes():
    """Qwen2.5-3B's decode (B 4, KV 2): phase 8's w 13 takes 7 CTAs of 2
    slots (56 CTAs, where the first form had 8); w 15 and w 32 take 8."""
    bf16 = torch.bfloat16
    assert [(c["split"], c["slots_per_cta"], c["ctas"]) for c in
            (paged_launch_config(4, 2, 8, 128, 16, w, bf16)
             for w in (13, 15, 32))] == [(7, 2, 56), (8, 2, 64), (8, 4, 64)]


def test_launch_config_reads_no_lengths():
    """The split follows the shapes alone (and the caller's table
    capacity, an int): the host reads no length from the device, and the
    launch can be captured in a CUDA graph."""
    params = list(inspect.signature(paged_launch_config).parameters)
    assert params == ["B", "KV", "g", "hd", "bs", "w", "dtype", "capacity"]


def test_launch_config_takes_its_split_from_the_capacity():
    """The serving engine's launch at Qwen2.5-3B's decode (B 4, KV 2,
    capacity 512 / 16 = 32): 4 slots a CTA at every width, so w 5, 12, 13
    and 32 take 2, 3, 4 and 8 CTAs (at capacity w, phase 8's w 13 takes 7
    of 2 slots); every slot still goes to one CTA, in order, and S <= 8."""
    bf16 = torch.bfloat16
    got = [paged_launch_config(4, 2, 8, 128, 16, w, bf16, capacity=32)
           for w in (5, 12, 13, 32)]
    assert [(c["split"], c["slots_per_cta"], c["ctas"]) for c in got] == \
        [(2, 4, 16), (3, 4, 24), (4, 4, 32), (8, 4, 64)]
    assert paged_launch_config(4, 2, 8, 128, 16, 13, bf16, capacity=13) == \
        paged_launch_config(4, 2, 8, 128, 16, 13, bf16)
    for B, KV, cap in CONFIG_SHAPES:
        spc = None
        for w in sorted({1, (cap + 1) // 2, cap}):
            cfg = paged_launch_config(B, KV, 8, 128, 16, w, bf16,
                                      capacity=cap)
            spc = spc or cfg["slots_per_cta"]
            assert cfg["slots_per_cta"] == spc  # not a function of w
            assert cfg["split"] == -(-w // spc) <= PAGED_MAX_SPLIT
    with pytest.raises(ValueError, match="capacity"):
        paged_launch_config(4, 2, 8, 128, 16, 13, bf16, capacity=12)


def _width_row(dt, length, cap, seed=5):
    """Qwen2.5-3B's decode shapes (B 4, KV 2, g 8, hd 128, blocks of 16)
    with row 0 at ``length`` and rows 1-3 at 41, 1 and 0 keys; each row's
    blocks distinct, ``cap`` slots of table a row."""
    rng = np.random.default_rng(seed)
    B, KV, g, hd, bs = 4, 2, 8, 128, 16
    nb = 1 + B * cap
    tdt = torch.bfloat16 if dt == "bf16" else torch.float32
    kp, vp = (torch.from_numpy(rng.standard_normal(
        (nb, KV, bs, hd)).astype(np.float32)).to(tdt) for _ in range(2))
    q = torch.from_numpy(rng.standard_normal(
        (B, KV * g, 1, hd)).astype(np.float32)).to(tdt)
    tables = torch.from_numpy((1 + rng.permutation(nb - 1)[:B * cap])
                              .reshape(B, cap).astype(np.int32))
    lengths = torch.tensor([length, 41, 1, 0], dtype=torch.int32)
    return q, kp, vp, tables, lengths


@pytest.mark.parametrize("dt", ["bf16", "f32"])
def test_row_result_does_not_depend_on_the_table_width(dt):
    """A row of 70 keys (5 live slots) at every table width from 5 to the
    engine's capacity (max_len 512 / 16 = 32): bit-equal outputs when the
    launch takes its split from the capacity, as the engine's does. Without
    it (capacity = w) the split, and so the order of the row's merges,
    follows w: the row is bit-equal at w 5 and 8 (one slot a CTA) and not
    at every w of 2 and 3 slots a CTA."""
    cap = 32
    q, kp, vp, tables, lengths = _width_row(dt, 70, cap)
    outs = {w: paged_decode_tc_emulate(q, kp, vp, tables[:, :w].contiguous(),
                                       lengths, capacity=cap)[0]
            for w in range(5, cap + 1)}
    for w, out in outs.items():
        assert torch.equal(out, outs[5]), w
    torch.testing.assert_close(
        outs[5].float(),
        paged_decode_plain(q, kp, vp, tables[:, :5], lengths)[0].float(),
        rtol=0, atol=TOL[dt] * 4)
    # the fault this pins: the split from w
    at = {w: paged_decode_tc_emulate(q, kp, vp, tables[:, :w].contiguous(),
                                     lengths)[0] for w in (5, 8, 12, 16, 24)}
    assert torch.equal(at[5], at[8])
    assert not all(torch.equal(at[5], at[w]) for w in (12, 16, 24))


def test_launch_config_raises_on_shapes_it_does_not_take():
    with pytest.raises(ValueError, match="hd in"):
        paged_launch_config(4, 2, 8, 96, 16, 8, torch.bfloat16)
    with pytest.raises(ValueError):
        paged_launch_config(4, 2, PAGED_MAX_GROUP + 1, 128, 16, 8,
                            torch.bfloat16)
    with pytest.raises(ValueError):
        paged_launch_config(65536, 2, 8, 128, 16, 8, torch.bfloat16)
    with pytest.raises(TypeError):
        paged_launch_config(4, 2, 8, 128, 16, 8, torch.float16)


@pytest.mark.parametrize("bs", [1, 4, 16])
def test_cta_keys_skip_dead_slots(bs):
    """Each CTA walks its slots cut at the row's live slots; together they
    walk exactly the live slots' keys; a row of length 0 walks all w."""
    for w in (1, 7, 13, 25):
        cfg = paged_launch_config(4, 2, 8, 16, bs, w, torch.bfloat16)
        s, spc = cfg["split"], cfg["slots_per_cta"]
        for length in (0, 1, bs - 1, bs, bs + 1, 3 * bs, w * bs, w * bs + 5):
            keys = paged_cta_keys(length, w, bs, s, spc)
            assert len(keys) == s
            walked = [k for k0, k1 in keys for k in range(k0, k1)]
            live = paged_live_slots(length, w, bs)
            assert walked == list(range(live * bs))
            assert live == (w if length <= 0 else min(w, -(-length // bs)))
            for r, (k0, k1) in enumerate(keys):
                assert r * spc * bs <= k0 <= k1 <= min((r + 1) * spc, w) * bs


# -- words -------------------------------------------------------------------

@pytest.mark.parametrize("p", [0.5, 1.0])
def test_issued_words_at_most_the_counter(p):
    """The kernel issues at most paged_decode_hbm_words (unchanged, the
    reference's): equal when every row's slots are all live (and for rows of
    length 0, which walk them all), and otherwise exactly the live blocks'
    words less, with their table entries."""
    for B, KV, g, w, bs, hd in [(4, 2, 8, 13, 16, 128), (4, 2, 8, 32, 16, 128),
                                (3, 4, 1, 25, 4, 16), (1, 1, 16, 1, 8, 64)]:
        full = paged_decode_hbm_words(B, KV, g, w, bs, hd, p, p, p)
        assert full == jfa.paged_decode_hbm_words(B, KV, g, w, bs, hd, p, p, p)
        for lengths in ([w * bs] * B, [0] * B, [w * bs + 3] + [0] * (B - 1)):
            assert paged_decode_issued_words(lengths, B, KV, g, w, bs, hd,
                                             p, p, p) == full
        rng = np.random.default_rng(B + w)
        for _ in range(5):
            lengths = rng.integers(-2, w * bs + 2, B)
            got = paged_decode_issued_words(lengths, B, KV, g, w, bs, hd,
                                            p, p, p)
            dead = sum(w - paged_live_slots(int(n), w, bs) for n in lengths)
            assert got <= full
            assert got == full - 2.0 * p * KV * dead * bs * hd - dead


def test_engine_capacity_launch_audits_clean():
    """The engine's call (``ops.attention_decode(..., capacity=32)``, as
    the paged Qwen engine makes it at phase 8's lengths) audits clean: its
    access plan takes the capacity's split (4 CTAs of 4 slots at w 13),
    counts exactly the counter's words (which the capacity does not move)
    and issues the same words as the launch at capacity w."""
    from repro_torch import ops
    from repro_torch.plan import H100

    ctx = ops.ExecutionContext(target=H100, backend="cuda", device="cpu")
    B, KV, g, w, bs, hd = 4, 2, 8, 13, 16, 128
    nb = 1 + B * w
    q = torch.zeros((B, KV * g, 1, hd), dtype=torch.bfloat16)
    pool = torch.zeros((nb, KV, bs, hd), dtype=torch.bfloat16)
    tables = torch.arange(1, nb, dtype=torch.int32).reshape(B, w)
    lengths = torch.tensor([205, 151, 120, 41], dtype=torch.int32)
    args = (q, pool, pool, tables, lengths)
    at = {cap: ops.explain("attention_decode", ctx, dtype=q.dtype,
                           spec_args=args, spec_kw=kw, audit=True)
          for cap, kw in ((32, {"capacity": 32}), (w, None))}
    assert at[32].audit_report.launch.grid == (4, KV, B)
    assert at[w].audit_report.launch.grid == (7, KV, B)
    for d in at.values():
        assert d.audit_report.ok and d.audited == d.measured_words
    assert at[32].measured_words == at[w].measured_words
    assert (at[32].audit_report.issued_words
            == at[w].audit_report.issued_words)
    assert at[32].audit_report.shortfall == at[w].audit_report.shortfall > 0


# -- the source and the wrapper share the launch constants -------------------

def test_launch_constants_match_the_source():
    src = (CSRC / "paged_decode.cu").read_text()

    def const(name):
        m = re.search(rf"constexpr int {name} = (\d+);", src)
        assert m, name
        return int(m.group(1))

    assert const("WARPS") == PAGED_WARPS
    assert const("KEY_TILE") == PAGED_KEY_TILE
    assert const("RING") == PAGED_RING
    assert const("MAX_SPLIT") == PAGED_MAX_SPLIT
    assert const("TARGET_CTAS") == PAGED_TARGET_CTAS
    assert const("G_MAX") == PAGED_MAX_GROUP
