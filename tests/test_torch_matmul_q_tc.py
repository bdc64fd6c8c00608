"""The int8 tensor-core GEMM (``matmul_q_tc_kernel`` in ``csrc/quant.cu``) on
the CPU: its geometry, modelled by ``matmul_q_tc_emulate`` (ring spans
zero-filled past m, n and k, each B stage transposed k-major in shared
memory as the kernel's lanes do it, the warp layout over the tile, the
epilogue's column map), against the reference's ``_matmul_q_kernel`` in
interpret mode and the port's plain version on the same numpy inputs; the
launch configuration of every H100 int8 plan of the main path; the bank
pattern of the shared-memory transpose; and the counters and explain
records, which stay the reference's.

Tolerance: none. Both sides sum int8 products exactly (the reference adds
int32 partials into f32, exact while every partial sum is below 2^24, as at
these sizes), then convert to f32, scale in f32 and cast the same way."""

import importlib
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.plan as jp
import repro.quant as jq
import repro_torch.plan as tp
from repro import ops as jops
from repro_torch import ops as tops
from repro_torch.core.conv_model import Precision
from repro_torch.kernels import matmul_q_hbm_words, matmul_q_plain
from repro_torch.kernels._build import MAX_SMEM_BYTES
from repro_torch.kernels.matmul import warp_tiles
from repro_torch.kernels.quant import (LINEAR, matmul_launch_config,
                                       matmul_q_tc_emulate, transpose_stage)

jquant = importlib.import_module("repro.kernels.quant")

OUT = {"f32": (jnp.float32, torch.float32),
       "bf16": (jnp.bfloat16, torch.bfloat16)}
J_H100 = jp.HardwareTarget.from_dict(tp.H100.to_dict())
J_CTX = jops.ExecutionContext(target=J_H100, backend="pallas", interpret=True)
# (m, k, n): the reference's GEMMs (scripts/verify.py) and conv5_x's Im2Col
# GEMM at batch 1000, the shapes of chip_smoke.py's phase 11
GEMMS = [(512, 384, 256), (2048, 2048, 2048), (49000, 4608, 512)]

CASES = [  # (m, k, n), tiles
    # test_torch_quant.py::test_matmul_q_matches_reference's cases
    ((100, 77, 300), None), ((130, 129, 257), None), ((1, 64, 128), None),
    ((130, 129, 257), (32, 48, 16)), ((40, 30, 20), (16, 8, 6)),
    # the main path's plans at a small m: 512 x 384 x 256's and conv5_x's
    # (128, 256, 16) with their k and n, 2048^3's (256, 128, 16) with its k
    # and a ragged n, and (128, 256, 16) over a k ragged against the span
    ((40, 384, 256), (128, 256, 16)), ((8, 4608, 512), (128, 256, 16)),
    ((24, 2048, 300), (256, 128, 16)), ((33, 1001, 300), (128, 256, 16)),
    # a bm = 1 tile over three row tiles; a tile only LINEAR covers
    ((3, 200, 256), (1, 256, 16)), ((40, 50, 30), (1024, 32, 16)),
]
# GEMMs with m or n of 16 or less (decode rows against a wide weight, and
# the transpose): their plans' narrow tiles (1 x 4096, 16 x 2048, 2048 x 16)
# are cut into CTA shares; k = 200 is ragged against bk and the span
NARROW = [(m, 200, n) for m in (1, 4, 8, 16) for n in (2048, 4096)] + [
    (2048, 64, 16)]


def _h100_int8_plan(m, k, n):
    spec = tp.MatmulSpec(m, n, k, Precision(.25, .25, .5))
    return tuple(tp.Planner(tp.H100).plan(spec).tiles)


def _operands(m, k, n, seed=5):
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((m, k)).astype(np.float32)
    b = rng.standard_normal((k, n)).astype(np.float32)
    ja, jb, js = jq.quantize_matmul_operands(jnp.asarray(a), jnp.asarray(b))
    return (ja, jb, js), tuple(torch.from_numpy(np.array(v))
                               for v in (ja, jb, js))


def _np(t):
    return t.float().numpy()


def _jnp(a):
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


# -- the model of the kernel against the reference and the plain version ---

@pytest.mark.parametrize("mkn,tiles", CASES)
@pytest.mark.parametrize("out", sorted(OUT))
def test_tc_emulate_matches_reference(mkn, tiles, out):
    m, k, n = mkn
    jo, to = OUT[out]
    (ja, jb, js), (ta, tb, ts) = _operands(m, k, n)
    if tiles is None:
        want = jops.matmul_q(ja, jb, js, ctx=J_CTX, out_dtype=jo)
    else:
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", DeprecationWarning)
            want = jquant.matmul_q(ja, jb, js, tiles=tiles, out_dtype=jo)
    got = matmul_q_tc_emulate(ta, tb, ts, to, tiles)
    assert got.dtype == to and got.shape == (m, n)
    np.testing.assert_array_equal(_np(got), _jnp(want))
    np.testing.assert_array_equal(_np(got), _np(matmul_q_plain(ta, tb, ts,
                                                               to)))


@pytest.mark.parametrize("ks,bt", [(32, 32), (128, 256), (64, 320),
                                   (128, 128)])
def test_transpose_stage_is_the_transpose(ks, bt):
    """The lanes' rotated loads, byte rotation, __byte_perm transpose and
    rotated stores give exactly B^T, every byte of it."""
    rng = np.random.default_rng(ks + bt)
    stage = rng.integers(-128, 128, (ks, bt)).astype(np.int8)
    got = transpose_stage(stage)
    assert got.shape == (bt, ks) and got.dtype == np.int8
    np.testing.assert_array_equal(got, stage.T)


def _transpose_banks(cfg):
    """Per warp-block and step, the banks of the 32 lanes' 32-bit loads from
    the B stage and stores into B^T, as ``transpose_stage`` in
    ``csrc/quant.cu`` addresses them (pitches from the config)."""
    P, Q = cfg["ldbs"] // 4, cfg["ldbt"] // 4
    lane = np.arange(32)
    cl, gl = lane & 7, lane >> 3
    sh, rot = gl & 2, cl >> 1
    for gb in range(cfg["ks"] // 16):
        for cb in range(cfg["bt"] // 32):
            g, c = 4 * gb + gl, 8 * cb + cl
            for i in range(4):
                yield "load", (4 * g + ((i + sh) & 3)) * P + c
                yield "store", (4 * c + ((i + rot) & 3)) * Q + g


@pytest.mark.parametrize("tiles", [(128, 256, 16), (256, 128, 16),
                                   (96, 288, 64), (1, 128, 64)])
def test_transpose_and_fragment_reads_hit_distinct_banks(tiles):
    """With both stage pitches 16 mod 32 bytes, each step of the transpose
    puts its 32 loads and its 32 stores in 32 distinct banks, and each
    ldmatrix phase (8 rows of 16 bytes of A or B^T) in 8 distinct bank
    groups."""
    cfg = matmul_launch_config(*tiles)
    for what, words in _transpose_banks(cfg):
        assert len(set(words % 32)) == 32, (what, tiles)
    for pitch in (cfg["lda"], cfg["ldbt"]):
        assert pitch % 32 == 16
        groups = {(r * pitch // 4) % 32 // 4 for r in range(8)}
        assert len(groups) == 8


@pytest.mark.parametrize("mkn", NARROW)
def test_tc_emulate_narrow_plans(mkn):
    """The narrow plans, through their CTA shares, bit for bit against the
    reference's kernel in interpret mode and the plain version (bf16 out,
    the int8 policy's)."""
    m, k, n = mkn
    (ja, jb, js), (ta, tb, ts) = _operands(m, k, n, seed=m + n)
    want = jops.matmul_q(ja, jb, js, ctx=J_CTX, out_dtype=jnp.bfloat16)
    cfg = matmul_launch_config(*_h100_int8_plan(m, k, n))
    assert cfg["sm"] * cfg["sn"] > 1  # the plan's tile is cut at a long k
    got = matmul_q_tc_emulate(ta, tb, ts, torch.bfloat16)
    assert got.dtype == torch.bfloat16 and got.shape == (m, n)
    np.testing.assert_array_equal(_np(got), _jnp(want))
    np.testing.assert_array_equal(
        _np(got), _np(matmul_q_plain(ta, tb, ts, torch.bfloat16)))


# -- the launch configuration ------------------------------------------------

@pytest.mark.parametrize("mkn", GEMMS)
def test_launch_config_of_main_path_plans(mkn):
    """Every H100 int8 plan of the main path: at most 512 threads of at
    most 64 int32 accumulators covering the tile, a ring that fits a
    block's shared memory, a stage span of whole k32 slices holding at
    least one plan k-step, and only the stages its spans use."""
    m, k, n = mkn
    bm, bn, bk = tiles = _h100_int8_plan(m, k, n)
    assert tiles in ((128, 256, 16), (256, 128, 16))
    for kk in (None, k):
        cfg = matmul_launch_config(bm, bn, bk, kk)
        assert cfg["variant"] == 0 and (cfg["mi"], cfg["ni"]) == (2, 8)
        assert cfg["threads"] == 512 and cfg["acc_per_thread"] == 64
        assert cfg["threads"] * cfg["acc_per_thread"] == bm * bn == 32768
        assert cfg["rows"] == bm and cfg["cols"] == bn == cfg["bt"]
        assert cfg["smem"] <= MAX_SMEM_BYTES
        assert cfg["ks"] % 32 == 0 and cfg["ks"] >= bk
        assert (cfg["cbm"], cfg["cbn"], cfg["sm"], cfg["sn"]) == (bm, bn,
                                                                  1, 1)
        assert cfg["lda"] == cfg["ldbt"] == cfg["ks"] + 16
        assert cfg["ldbs"] == cfg["bt"] + 16
        if kk is not None:
            assert cfg["n_spans"] == -(-k // cfg["ks"])
    owned = sorted(t for w in range(cfg["wm"] * cfg["wn"])
                   for t in warp_tiles(cfg, w))
    assert owned == [(i, j) for i in range(bm // 16) for j in range(bn // 8)]


@pytest.mark.parametrize("tiles", [(32, 48, 16), (16, 8, 6), (1, 128, 64),
                                   (96, 288, 64), (112, 256, 128),
                                   (1024, 32, 16)])
def test_warp_layout_covers_the_tile_once(tiles):
    """The m16n8 tiles of every warp cover the (bm, bn) tile, none twice;
    (1024, 32) takes the LINEAR layout."""
    bm, bn, bk = tiles
    cfg = matmul_launch_config(*tiles)
    owned = [t for w in range(cfg["wm"] * cfg["wn"])
             for t in warp_tiles(cfg, w)]
    assert len(owned) == len(set(owned))
    need = {(i, j) for i in range(-(-bm // 16)) for j in range(-(-bn // 8))}
    assert need <= set(owned)
    assert cfg["threads"] <= 512 and cfg["acc_per_thread"] <= 64
    assert (cfg["variant"] == LINEAR) == (tiles == (1024, 32, 16))


@pytest.mark.parametrize("m,n", [(m, n) for m in (1, 4, 8, 16)
                                  for n in (2048, 4096, 11008, 14336)]
                         + [(2048, 16), (4096, 8), (4096, 1)])
def test_narrow_plans_take_cta_shares(m, n):
    """A narrow plan's tile is cut along its longer side into shares that
    cover it once, the last share ragged, each share held by at most 16
    warps of 64 accumulators and a ring within a block's shared memory."""
    k = 4096
    bm, bn, bk = _h100_int8_plan(m, k, n)
    cfg = matmul_launch_config(bm, bn, bk, k)
    cbm, cbn, sm, sn = cfg["cbm"], cfg["cbn"], cfg["sm"], cfg["sn"]
    assert 1 in (sm, sn) and (sm - 1) * cbm < bm <= sm * cbm
    assert (sn - 1) * cbn < bn <= sn * cbn
    assert (cbn if sn > 1 else cbm if sm > 1 else 32) % 16 == 0
    assert cfg["rows"] >= cbm and cfg["cols"] >= cbn
    assert cfg["threads"] <= 512 and cfg["acc_per_thread"] <= 64
    assert cfg["smem"] <= MAX_SMEM_BYTES and cfg["ks"] % 32 == 0
    owned = [t for w in range(cfg["wm"] * cfg["wn"])
             for t in warp_tiles(cfg, w)]
    assert len(owned) == len(set(owned))
    assert {(i, j) for i in range(-(-cbm // 16))
            for j in range(-(-cbn // 8))} <= set(owned)


def test_a_tile_nothing_covers_raises():
    """More accumulators than 16 warps hold (a plan for another target), or
    a plan k-step so deep that no ring fits a block's shared memory:
    ValueError, no other kernel."""
    with pytest.raises(ValueError, match="accumulator tile"):
        matmul_launch_config(512, 512, 16)
    with pytest.raises(ValueError, match="accumulator tile"):
        matmul_launch_config(16, 8192, 16)
    with pytest.raises(ValueError, match="shared memory"):
        matmul_launch_config(8, 8, 200000)
    with pytest.raises(ValueError, match="shared memory"):
        matmul_launch_config(2048, 16, 4096)


# -- counters and explain: the reference's -----------------------------------

@pytest.mark.parametrize("mkn", GEMMS)
@pytest.mark.parametrize("out", sorted(OUT))
def test_words_and_explain_stay_the_references(mkn, out):
    """The stage span is free: ``matmul_q_hbm_words`` charges the plan's
    (bm, bk) and (bk, bn) tiles per k-step, as the reference does, and
    ``ops.explain``'s words and bound ratio stay equal to its."""
    m, k, n = mkn
    jo, to = OUT[out]
    meta = lambda *s: torch.empty(s, dtype=torch.int8, device="meta")
    sds = lambda *s: jax.ShapeDtypeStruct(s, jnp.int8)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        want = jquant.matmul_q_hbm_words(sds(m, k), sds(k, n), target=J_H100,
                                         out_dtype=jo)
    assert matmul_q_hbm_words(meta(m, k), meta(k, n), target=tp.H100,
                              out_dtype=to) == want
    jctx = jops.ExecutionContext(target=J_H100, backend="pallas")
    ctx = tops.ExecutionContext(target=tp.H100, backend="cuda", device="cpu")
    jd = jops.explain("matmul_q", jctx, dtype="int8",
                      spec_args=(sds(m, k), sds(k, n),
                                 jax.ShapeDtypeStruct((1, n), jnp.float32)),
                      spec_kw={"out_dtype": jo})
    d = tops.explain("matmul_q", ctx, dtype=torch.int8,
                     spec_args=(meta(m, k), meta(k, n),
                                torch.empty((1, n), device="meta")),
                     spec_kw={"out_dtype": to})
    assert d.chosen == "cuda" and not d.fell_back
    assert d.plan.tiles == jd.plan.tiles
    assert d.measured_words == jd.measured_words
    assert d.bound_ratio == jd.bound_ratio
