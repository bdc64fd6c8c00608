"""The tensor-core flash kernel (``flash_tc_kernel`` in
``csrc/flash_attention.cu``) on the CPU: its arithmetic, modelled by
``flash_attention_tc_emulate`` (the same q tiles, key tiles and key slabs of
the R x C warp grid, P rounded to bf16, the C partials merged), against the
reference's flash kernel in interpret mode (its XLA attention where a key
mask is given, which the Pallas kernel declines) and against the port's
plain version, on the same numpy inputs; its launch configuration; the
key split over a thread-block cluster at decode shapes (each rank's share
of the key tiles, its own running max, the merge in rank order), held to
the same two, with the split taken from the key tiles alone; and the word
counters it must keep equal to the reference's.

Tolerance: the outputs are bf16, so an output agrees when max|got - want| <=
2^-7 x max(1, max|want|): one bf16 rounding of the output on each side, and
P's bf16 rounding (2^-9 relative a probability) well inside it.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_attention import FLASH_CASES, _flash_inputs

import repro.plan as jp
import repro_torch.plan as tp
from repro import ops as jops
from repro.ops.registry import xla_attention
from repro_torch import ops as tops
from repro_torch.kernels import attention_hbm_words, flash_attention_plain
from repro_torch.kernels._build import MAX_SMEM_BYTES
from repro_torch.kernels.flash_attention import (FLASH_INSTANCES,
                                                 attention_blocks,
                                                 attention_split_hbm_words,
                                                 attention_stats_hbm_words,
                                                 flash_attention_access_plan,
                                                 flash_attention_tc_emulate,
                                                 flash_split,
                                                 flash_split_instances,
                                                 flash_tc_instances,
                                                 launch_config, split_tiles,
                                                 tc_warps, warp_grid)
from repro_torch.verify.audit import audit_access_plan

jfa = importlib.import_module("repro.kernels.flash_attention")
BF16 = torch.bfloat16
SM_SHARED = 233472  # one H100 SM's shared memory, bytes
CTA_RESERVED = 1024  # shared memory the hardware keeps a CTA


def _check(got, want):
    got = np.asarray(got.float().numpy() if torch.is_tensor(got) else got,
                     np.float32)
    want = np.asarray(want.float().numpy() if torch.is_tensor(want) else want,
                      np.float32)
    assert got.shape == want.shape and np.isfinite(got).all()
    err = np.abs(got - want).max()
    allowed = 2.0 ** -7 * max(1.0, float(np.abs(want).max()))
    assert err <= allowed, (err, allowed)


def _blocks(hd):
    return sorted(b for h, b in FLASH_INSTANCES if h == hd)


# -- the model of the kernel against the reference and the plain version ---

@pytest.mark.parametrize("case", sorted(FLASH_CASES))
def test_tc_emulate_matches_pallas_interpret(case):
    """Every case of the plain version's own test, at every compiled block
    of its head dim (so the runtime bq meets several warp grids), against
    the reference's flash kernel in interpret mode and the plain version."""
    ((jq, tq), (jk, tk), (jv, tv)), off, Lq = _flash_inputs(case, "bf16")
    joff = off if isinstance(off, int) else jnp.asarray(off)
    toff = off if isinstance(off, int) else torch.from_numpy(np.asarray(off))
    want = jfa.flash_attention(jq, jk, jv, causal=True, q_offset=joff,
                               block_q=16, block_k=16, interpret=True,
                               q_seq_len=Lq)
    fold = Lq if Lq < tq.shape[1] else None
    plain = flash_attention_plain(tq, tk, tv, True, toff, fold)
    for block in _blocks(tq.shape[2]) + [None]:
        got = flash_attention_tc_emulate(tq, tk, tv, True, toff, Lq,
                                         block=block)
        assert got.dtype == BF16 and got.shape == tq.shape
        _check(got, want)
        _check(got, plain)


TC_CASES = {  # (BH, g, Lq, Lk, hd, block, offset kind): the grid it takes
    "g1_ragged": (3, 1, 20, 45, 32, 32, "int"),           # bq 24: R 2, C 2
    "g8_decode": (4, 8, 1, 100, 64, 64, "rows"),          # bq 8: R 1, C 4
    "g8_bq24": (2, 8, 3, 70, 64, 64, "rows"),             # R 2, C 2
    "g8_bq32_block32": (2, 8, 4, 70, 16, 32, "rows"),     # R 2, C 2
    "g1_bq8_block32": (2, 1, 5, 41, 16, 32, "int"),       # 8-key slabs
    "g1_bq64": (2, 1, 130, 200, 64, 64, "int"),           # R 4, C 1
    "g1_block128": (2, 1, 200, 250, 16, 128, "rows"),     # R 8, C 1
    "g8_block128_decode": (2, 8, 1, 300, 32, 128, "rows"),  # R 1, C 8
    "g8_block128_bq24": (2, 8, 3, 60, 16, 128, "int"),    # R 2, C 4
    "g8_block128_bq40": (2, 8, 5, 90, 32, 128, "rows"),   # R 4, C 2
    "resident": (3, 1, 100, 50, 64, 64, "int"),           # n_k == 1
    "resident_g8": (2, 8, 9, 30, 16, 64, "rows"),
}


@pytest.mark.parametrize("case", sorted(TC_CASES))
def test_tc_emulate_grids_match_pallas_interpret(case):
    """GQA g = 1 and 8, ragged Lq and Lk, int and per-row offsets with
    ``q_seq_len`` folding, one resident key tile, and bq = 8 .. 128 at
    blocks 32, 64 and 128: every (R, C) the kernel compiles."""
    BH, g, Lq, Lk, hd, block, kind = TC_CASES[case]
    rng = np.random.default_rng(7)
    q = rng.standard_normal((BH, g * Lq, hd)).astype(np.float32)
    k = rng.standard_normal((BH, Lk, hd)).astype(np.float32)
    v = rng.standard_normal((BH, Lk, hd)).astype(np.float32)
    off = (max(0, Lk - Lq) if kind == "int"
           else rng.integers(0, Lk - Lq + 1, BH).astype(np.int32))
    jq, jk, jv = (jnp.asarray(a, jnp.bfloat16) for a in (q, k, v))
    tq, tk, tv = (torch.from_numpy(a).to(BF16) for a in (q, k, v))
    toff = off if isinstance(off, int) else torch.from_numpy(off)
    joff = off if isinstance(off, int) else jnp.asarray(off)
    want = jfa.flash_attention(jq, jk, jv, causal=True, q_offset=joff,
                               block_q=16, block_k=16, interpret=True,
                               q_seq_len=Lq)
    got = flash_attention_tc_emulate(tq, tk, tv, True, toff, Lq, block=block)
    _check(got, want)
    _check(got, flash_attention_plain(tq, tk, tv, True, toff,
                                      Lq if g > 1 else None))


def test_tc_emulate_kv_lens_matches_pallas_interpret():
    """Per-row key lengths (``_flash_kernel_dyn``'s ``kv_lens``), one of
    them 1, without causal masking, over several key tiles."""
    rng = np.random.default_rng(8)
    q, k, v = (rng.standard_normal(s).astype(np.float32)
               for s in ((4, 24, 32), (4, 90, 32), (4, 90, 32)))
    lens = np.array([90, 7, 1, 45], np.int32)
    want = jfa.flash_attention(*(jnp.asarray(a, jnp.bfloat16)
                                 for a in (q, k, v)),
                               causal=False, block_q=8, block_k=8,
                               interpret=True, kv_lens=jnp.asarray(lens))
    tq, tk, tv = (torch.from_numpy(a).to(BF16) for a in (q, k, v))
    for block in (32, 64):
        got = flash_attention_tc_emulate(tq, tk, tv, False,
                                         kv_lens=torch.from_numpy(lens),
                                         block=block)
        _check(got, want)
        _check(got, flash_attention_plain(tq, tk, tv, False,
                                          kv_lens=torch.from_numpy(lens)))


@pytest.mark.parametrize("Lq", [1, 3, 8])
def test_tc_emulate_key_mask_matches_xla(Lq):
    """A pad-tail key mask and one fully masked row through the folded
    layout (as ``ops.attention`` folds it), against the reference's
    ``xla_attention``: the masked row averages V over its Lk keys."""
    B, H, KV, Lk, hd = 2, 16, 2, 80, 64
    g = H // KV
    rng = np.random.default_rng(9)
    q = rng.standard_normal((B, H, Lq, hd)).astype(np.float32)
    k = rng.standard_normal((B, KV, Lk, hd)).astype(np.float32)
    v = rng.standard_normal((B, KV, Lk, hd)).astype(np.float32)
    mask = np.ones((B, Lk), bool)
    mask[0, Lk - 5:] = False
    mask[1, :] = False  # a fully masked row
    off = np.array([Lk - Lq - 3, 10], np.int32)
    want = xla_attention(*(jnp.asarray(a, jnp.bfloat16) for a in (q, k, v)),
                         causal=True, q_offset=jnp.asarray(off),
                         key_mask=jnp.asarray(mask))
    tq, tk, tv = (torch.from_numpy(a).to(BF16) for a in (q, k, v))
    fq = tq.reshape(B * KV, g * Lq, hd)
    fk, fv = tk.reshape(B * KV, Lk, hd), tv.reshape(B * KV, Lk, hd)
    toff = torch.from_numpy(off).repeat_interleave(KV)
    tmask = torch.from_numpy(mask)
    got = flash_attention_tc_emulate(fq, fk, fv, True, toff, Lq,
                                     key_mask=tmask).reshape(B, H, Lq, hd)
    _check(got, np.asarray(want.astype(jnp.float32)))
    _check(got, flash_attention_plain(fq, fk, fv, True, toff, Lq, None,
                                      tmask).reshape(B, H, Lq, hd))
    mean_v = tv[1].float().mean(dim=1)  # (KV, hd): the masked row's output
    _check(got[1, :g, 0], mean_v[0].expand(g, hd))
    _check(got[1, g:, 0], mean_v[1].expand(g, hd))


def test_tc_emulate_takes_bf16_only():
    q = torch.zeros((2, 8, 16))
    with pytest.raises(TypeError):
        flash_attention_tc_emulate(q, q, q)


# -- launch configuration ---------------------------------------------------

@pytest.mark.parametrize("hd,block", sorted(FLASH_INSTANCES))
def test_launch_config_tiles_every_row_and_key(hd, block):
    """For every runtime bq: shared memory fits a block, two CTAs fit an SM
    where the main path takes the instance, 16 R >= bq, R x C = W, every key
    of a tile goes to exactly one warp of each row slab, and the grid (with
    its stride over q tiles) covers every (row, q tile) once."""
    for bq in range(8, block + 1, 8):
        for Lq, Lk in ((bq, 3 * block + 5), (5 * block + 3, block - 3),
                       (bq, 8)):
            if Lq == 5 * block + 3 and bq != block:
                continue
            cfg = launch_config(Lq, Lk, hd, block, BF16, rows=3)
            r, c = cfg["warp_grid"]
            assert cfg["kernel"] == "tensor core"
            assert cfg["warps"] == r * c == tc_warps(block)
            assert cfg["threads"] == 32 * cfg["warps"]
            assert 16 * r >= cfg["bq"] and (r == 1 or 8 * r < cfg["bq"])
            assert cfg["smem"] <= MAX_SMEM_BYTES
            assert cfg["slots"] == 2 and (cfg["pitch"] * 2) % 32 == 16
            slab = cfg["key_slab"]
            assert slab * c == block and slab >= 8
            for col in range(block):  # in every row slab: one owner
                assert sum(j * slab <= col < (j + 1) * slab
                           for j in range(c)) == 1
            rows, ys = cfg["grid"]
            covered = [(x, t) for x in range(rows) for y in range(ys)
                       for t in range(y, cfg["n_q"], ys)]
            assert sorted(covered) == [(x, t) for x in range(3)
                                       for t in range(cfg["n_q"])]
            assert cfg["kv_resident"] == (cfg["n_k"] == 1)
            assert ys == (1 if cfg["n_k"] == 1 else cfg["n_q"])
        assert launch_config(bq, 64, hd, block, torch.float32)["kernel"] == \
            "fma"


def test_launch_config_main_path():
    """Qwen2.5-3B's prefill (2 kv heads, 8 x 176 folded rows) and decode (4
    rows x 2 kv heads, 8 folded rows) at hd 128: block 64 from the H100
    plan, R 4 x C 1 and R 1 x C 4, two CTAs an SM, the same smem as the
    source's formula (Q tile, two K/V slots, the merge of 3 key slabs)."""
    assert attention_blocks(128, tp.H100, kv_word=0.5) == (64, 64)
    pre = launch_config(8 * 176, 512, 128, 64, BF16, rows=2)
    dec = launch_config(8, 512, 128, 64, BF16, rows=8)
    assert pre["warp_grid"] == (4, 1) and pre["grid"] == (2, 22)
    assert dec["warp_grid"] == (1, 4) and dec["grid"] == (8, 1)
    assert pre["smem"] == 5 * 64 * 136 * 2
    assert dec["smem"] == 5 * 64 * 136 * 2 + 3 * 32 * (4 + 64) * 4
    for cfg in (pre, dec):
        assert 2 * (cfg["smem"] + CTA_RESERVED) <= SM_SHARED
        # no key split: 8 key tiles are below two CTAs' worth
        assert cfg["split"] == 1 and cfg["cluster"] == (1, 1, 1)
        assert cfg["ctas"] == cfg["grid"][0] * cfg["grid"][1]


def test_every_bf16_instance_takes_the_tensor_cores():
    """Every compiled (hd, block) maps bf16 to the tensor-core kernel and
    f32 to the FMA kernel; the (hd, block, C) instances phase 2 checks are
    exactly the grids some bq takes."""
    expect = set()
    for hd, b in FLASH_INSTANCES:
        assert launch_config(8, 8, hd, b, torch.float32)["kernel"] == "fma"
        for bq in range(8, b + 1, 8):
            cfg = launch_config(bq, 8, hd, b, BF16)
            assert cfg["kernel"] == "tensor core"
            expect.add((hd, b, cfg["warp_grid"][1]))
    # 28 for hd 16, 32, 64 and 128; hd 80 (HuBERT-xLarge) adds (80, 32, 2),
    # (80, 32, 4), (80, 64, 1), (80, 64, 2) and (80, 64, 4)
    assert set(flash_tc_instances()) == expect and len(expect) == 33
    assert warp_grid(8, 64) == (1, 4) and warp_grid(24, 64) == (2, 2)
    assert warp_grid(8, 128) == (1, 8) and warp_grid(128, 128) == (8, 1)
    with pytest.raises(ValueError):
        launch_config(8, 8, 128, 128, BF16)
    with pytest.raises(TypeError):
        launch_config(8, 8, 128, 64, torch.float16)


# -- the counter ------------------------------------------------------------

MAIN_SPECS = [  # (B, H, KV, Lq, Lk, hd): the serves' prefill and decode
    (1, 16, 2, 176, 512, 128), (4, 16, 2, 1, 512, 128),  # Qwen2.5-3B
    (1, 64, 8, 300, 300, 128), (1, 64, 8, 3, 3, 128),    # Jamba-1.5 prefill
    (4, 64, 8, 1, 512, 128),                              # and decode
]


@pytest.mark.parametrize("spec", MAIN_SPECS)
def test_attention_words_unchanged_on_the_main_path(spec):
    """``attention_hbm_words`` and ``ops.explain``'s measured words and
    bound ratio for attention equal the reference's at the main path's
    shapes: the kernel streams every key tile once per q tile."""
    B, H, KV, Lq, Lk, hd = spec
    g = H // KV
    jt = jp.HardwareTarget.from_dict(tp.H100.to_dict())
    blocks = attention_blocks(hd, tp.H100, kv_word=0.5)
    assert attention_hbm_words(B * KV, g * Lq, Lk, hd, *blocks, 0.5, 0.5,
                               0.5) == jfa.attention_hbm_words(
        B * KV, g * Lq, Lk, hd, *blocks, 0.5, 0.5, 0.5)
    tctx = tops.ExecutionContext(target=tp.H100, backend="cuda", device="cpu")
    jctx = jops.ExecutionContext(target=jt, backend="pallas", interpret=True)
    tq = torch.empty((B, H, Lq, hd), dtype=BF16, device="meta")
    tk = torch.empty((B, KV, Lk, hd), dtype=BF16, device="meta")
    jq = jax.ShapeDtypeStruct((B, H, Lq, hd), jnp.bfloat16)
    jk = jax.ShapeDtypeStruct((B, KV, Lk, hd), jnp.bfloat16)
    d = tops.explain("attention", tctx, dtype=BF16, spec_args=(tq, tk, tk))
    jd = jops.explain("attention", jctx, dtype="bfloat16",
                      spec_args=(jq, jk, jk))
    assert d.measured_words == jd.measured_words
    assert d.bound_ratio == jd.bound_ratio


# -- the key split at decode shapes ------------------------------------------

def test_split_launch_config_pins():
    """S from the key tiles alone: 8 (128 CTAs in clusters of 8, grid (128,
    1)) at phase 31's rank shard (8,192 keys) and one card's cache (32,768)
    of Qwen2.5-3B (16 rows x 8 folded queries, hd 128, block 64), whatever
    the rows; none at the Qwen prefill, HuBERT-xLarge's hd-80 step, the
    serve's decode (8 tiles), any launch of several q tiles or row slabs,
    or f32; every split launch takes a compiled SPLIT instance."""
    for Lk in (8192, 32768):
        for rows in (16, 1, 5):
            cfg = launch_config(8, Lk, 128, 64, BF16, rows=rows)
            assert cfg["split"] == 8 and cfg["cluster"] == (8, 1, 1)
            assert cfg["grid"] == (8 * rows, 1) and cfg["ctas"] == 8 * rows
            assert cfg["warp_grid"] == (1, 4) and cfg["n_q"] == 1
        assert launch_config(8, Lk, 128, 64, BF16, rows=16)["ctas"] == 128
        assert launch_config(8, Lk, 128, 64, torch.float32)["split"] == 1
    unsplit = {  # (Lq, Lk, hd, block, rows): the grid it keeps
        "qwen prefill": ((8 * 176, 512, 128, 64, 2), (2, 22)),
        "qwen contiguous decode": ((8, 512, 128, 64, 8), (8, 1)),
        "hubert hd 80 step": ((512, 512, 80, 64, 128), (128, 8)),
        "one card's cache fill": ((8 * 32760, 32768, 128, 64, 2),
                                  (2, 4095)),
        "40 folded queries, 4 row slabs": ((40, 2085, 64, 64, 2), (2, 1)),
    }
    for name, (shape, grid) in unsplit.items():
        cfg = launch_config(*shape[:4], BF16, rows=shape[4])
        assert cfg["split"] == 1 and cfg["cluster"] == (1, 1, 1), name
        assert cfg["grid"] == grid and cfg["ctas"] == grid[0] * grid[1]
    # the rule: the largest power of two up to 8 leaving 8 tiles a CTA
    for n_k, want in ((1, 1), (8, 1), (15, 1), (16, 2), (31, 2), (32, 4),
                      (63, 4), (64, 8), (128, 8), (512, 8)):
        assert flash_split(1, n_k) == want
        assert flash_split(2, n_k) == 1 and flash_split(1, n_k, 2) == 1
    assert split_tiles(17, 2) == [(0, 8), (8, 17)]
    split = set()
    for hd, block in FLASH_INSTANCES:
        for bq in range(8, block + 1, 8):
            cfg = launch_config(bq, 64 * block, hd, block, BF16, rows=3)
            if cfg["split"] > 1:
                assert cfg["warp_grid"] == (1, tc_warps(block))
                split.add((hd, block, cfg["warp_grid"][1]))
    assert sorted(split) == flash_split_instances() and len(split) == 12
    assert split_tiles(4, 8) == [(0, 0), (0, 1), (1, 1), (1, 2), (2, 2),
                                 (2, 3), (3, 3), (3, 4)]


SPLIT_CASES = {  # (Lk, hd, block, S, offsets, kv_lens): 4 rows x 8 folded
    # queries (q_seq_len 1); Lk 1,000-2,048 at blocks 32 and 64, S 2, 4 and
    # 8 (launch_config's own or another), keys ending inside a tile, ranks
    # with no tile (4 tiles over 8 ranks: ranks 0, 2, 4 and 6)
    "b64_S2_scalar": (1000, 64, 64, 2, "scalar", False),
    "b64_S4_rows_lens": (1500, 128, 64, 4, "rows", True),
    "b64_S8_rows": (2048, 64, 64, 8, "rows", False),
    "b32_S8_negative": (1027, 64, 32, 8, "negative", False),
    "b32_S4_scalar_lens": (1999, 64, 32, 4, "scalar", True),
    "b32_S2_rows": (1283, 128, 32, 2, "rows", False),
    "b64_S8_empty_ranks": (200, 64, 64, 8, "rows", False),
    "b32_S8_empty_ranks_lens": (100, 64, 32, 8, "rows", True),
}


def _split_inputs(Lk, hd, offsets, lens, rows=4, seed=13):
    """numpy q (rows, 8, hd), k and v (rows, Lk, hd) as bf16 values, the
    offsets (``scalar``: an int32 scalar; ``rows``: one a row, the third
    before every key so that its keys are all masked; ``negative``: -5,
    every key masked) and, with ``lens``, per-row key lengths (one of 0:
    every key masked)."""
    rng = np.random.default_rng(seed)
    q, k, v = (torch.from_numpy(rng.standard_normal(s).astype(np.float32))
               .to(BF16).float().numpy()
               for s in ((rows, 8, hd), (rows, Lk, hd), (rows, Lk, hd)))
    off = {"scalar": np.int32(Lk - 10),
           "rows": np.array([Lk - 1, Lk // 2, -7, 3] * (rows // 4),
                            np.int32),
           "negative": -5}[offsets]
    kv = (np.array([Lk, Lk // 3, 0, Lk - 1] * (rows // 4), np.int32)
          if lens else None)
    return q, k, v, off, kv


def _torch_off(off):
    return off if isinstance(off, int) else torch.from_numpy(
        np.asarray(off))


@pytest.mark.parametrize("case", sorted(SPLIT_CASES))
def test_split_emulate_matches_pallas_interpret(case):
    """The split walk (each rank's tiles, its own running max and bf16 P,
    the merge in rank order) against the reference's flash kernel in
    interpret mode (``kv_lens`` for the key lengths) on every row with a
    valid key, and against the plain version on every row; a row whose
    keys are all masked averages V over its Lk keys, as the unsplit walk
    does (the reference averages over its own padded key blocks there)."""
    Lk, hd, block, S, kind, lens = SPLIT_CASES[case]
    q, k, v, off, kv = _split_inputs(Lk, hd, kind, lens)
    joff = off if isinstance(off, int) else jnp.asarray(off)
    want = jfa.flash_attention(
        *(jnp.asarray(a, jnp.bfloat16) for a in (q, k, v)), causal=True,
        q_offset=joff, block_q=8, block_k=128, interpret=True, q_seq_len=1,
        kv_lens=None if kv is None else jnp.asarray(kv))
    tq, tk, tv = (torch.from_numpy(a).to(BF16) for a in (q, k, v))
    tkv = None if kv is None else torch.from_numpy(kv)
    toff = _torch_off(off)
    got = flash_attention_tc_emulate(tq, tk, tv, True, toff, 1, tkv,
                                     block=block, split=S)
    assert got.dtype == BF16 and got.shape == tq.shape
    live = ((np.broadcast_to(np.asarray(off), (4,)) >= 0)
            & (True if kv is None else kv > 0))
    if live.any():
        _check(got[live], np.asarray(want.astype(jnp.float32))[live])
    _check(got, flash_attention_plain(tq, tk, tv, True, toff, 1, tkv))
    for r in np.flatnonzero(~live):  # every key masked: the mean of V
        _check(got[r], tv[r].float().mean(0).expand(8, hd))
    assert (~live).any() == (kind != "scalar" or lens)


def test_split_row_is_bit_equal_alone_and_in_a_batch():
    """A row's split comes from its key tiles alone, so its bf16 output in
    the emulated walk is bit for bit the same launched alone or among 8
    rows (2,048 keys at block 64, S 4), and so are its launch's split and
    tile shares. (The f32 statistics are held to the same split by the
    shares: CPU batched products may differ in the last f32 bit with the
    batch, which the kernel's per-row walk does not.)"""
    q, k, v, off, kv = _split_inputs(2048, 64, "rows", True, rows=8,
                                     seed=17)
    tq, tk, tv = (torch.from_numpy(a).to(BF16) for a in (q, k, v))
    toff, tkv = torch.from_numpy(off), torch.from_numpy(kv)
    assert launch_config(8, 2048, 64, 64, BF16, rows=8)["split"] == 4
    assert launch_config(8, 2048, 64, 64, BF16, rows=1)["split"] == 4
    batch = flash_attention_tc_emulate(tq, tk, tv, True, toff, 1, tkv,
                                       block=64)
    for i in range(8):
        alone = flash_attention_tc_emulate(
            tq[i:i + 1], tk[i:i + 1], tv[i:i + 1], True, toff[i:i + 1], 1,
            tkv[i:i + 1], block=64)
        assert torch.equal(alone, batch[i:i + 1]), i


SPLIT_WORDS = [  # (BH, Lq, Lk, hd, stats): the split launches and others
    (16, 8, 8192, 128, True), (16, 8, 32768, 128, False),
    (4, 8, 1030, 128, True), (2, 40, 2085, 64, False),
    (8, 8, 512, 128, False), (2, 8 * 176, 512, 128, False),
    (128, 512, 512, 80, False),
]


@pytest.mark.parametrize("shape", SPLIT_WORDS)
def test_split_counter_is_the_reference_counter_and_the_plan(shape):
    """``attention_split_hbm_words`` (the words the launch moves as the key
    split walks it) differs from the reference's counter (the stats
    counter with statistics) by 0 words: rank 0 reads Q, the other ranks
    copy it through distributed shared memory. It equals the access plan's
    counted words, whose launch is launch_config's (grid, cluster), and the
    plan is hazard-free."""
    BH, Lq, Lk, hd, stats = shape
    base = (attention_stats_hbm_words(BH, Lq, Lk, hd, 64, 64, 0.5, 0.5)
            if stats else
            attention_hbm_words(BH, Lq, Lk, hd, 64, 64, 0.5, 0.5, 0.5))
    split = attention_split_hbm_words(BH, Lq, Lk, hd, 64, 64, 0.5, 0.5,
                                      0.5, stats=stats)
    assert split - base == 0
    ap = flash_attention_access_plan(BH, Lq, Lk, hd, 64, 64, 0.5, 0.5, 0.5,
                                     stats=stats)
    rep = audit_access_plan(ap)
    assert rep.hazards == [] and rep.problems == []
    assert rep.counted_words == split
    cfg = launch_config(Lq, Lk, hd, 64, BF16, rows=BH)
    assert ap.launch.grid == (*cfg["grid"], 1)
    assert ap.launch.cluster == cfg["cluster"]
    assert rep.uncounted == {"q_offset/kv_lens": 2.0 * cfg["ctas"]}
