"""repro_torch.kernels against repro.kernels: conv2d, matmul and
conv2d_im2col outputs on the same numpy inputs (the reference's Pallas
kernels in interpret mode, the port's plain versions on the CPU), and the
three HBM-word counters, which must be exactly equal for equal tiles and
target. Tolerances follow tests/test_kernels.py: 1e-4 for f32, 3e-2 for
bf16 — both sides accumulate in f32, in a different order, and bf16 outputs
round once."""

import importlib
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.plan as jp
import repro_torch.plan as tp
from repro import ops as jops
from repro_torch.kernels import KERNELS, conv2d_plain, matmul_plain, ref
from repro_torch.kernels.conv2d import conv2d as tconv2d
from repro_torch.kernels.conv2d import LINEAR as CONV_LINEAR
from repro_torch.kernels.conv2d import (WINDOW_RUN, _launch_geometry,
                                        conv2d_hbm_words, gather_table,
                                        launch_config, row_offsets)
from repro_torch.kernels.im2col import (conv2d_im2col, im2col_hbm_words,
                                        im2col_patches)
from repro_torch.kernels.matmul import matmul as tmatmul
from repro_torch.kernels.matmul import matmul_hbm_words
from repro_torch.kernels.matmul import launch_config as mm_launch_config
from repro_torch.kernels.matmul import (LINEAR, TC_VARIANTS, stage_spans,
                                        vector_width, warp_layout, warp_tiles)

# the submodules: the package re-exports functions of the same names
jconv = importlib.import_module("repro.kernels.conv2d")
jim2col = importlib.import_module("repro.kernels.im2col")
jmm = importlib.import_module("repro.kernels.matmul")

DTYPES = {"f32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}
J_H100 = jp.HardwareTarget.from_dict(tp.H100.to_dict())
# the reference runs its Pallas kernels in interpret mode on the CPU
J_CTX = jops.ExecutionContext(target=J_H100, backend="pallas", interpret=True)


def _tol(dt):
    return dict(rtol=3e-2, atol=3e-2) if dt == "bf16" else \
        dict(rtol=1e-4, atol=1e-4)


def _pair(arr, dt):
    """One numpy array as (jax, torch) arrays of the same dtype (bf16 rounds
    to nearest-even on both sides, so the values are identical)."""
    jd, td = DTYPES[dt]
    return jnp.asarray(arr, jd), torch.from_numpy(arr).to(td)


def _inputs(seed, xs, ws, dt):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(xs).astype(np.float32)
    w = (rng.standard_normal(ws) / np.sqrt(np.prod(ws[1:]))).astype(np.float32)
    return _pair(x, dt), _pair(w, dt)


CONV_CASES = {  # (N, c_I, c_O, H, W, h_F, w_F, sh, sw, tiles)
    "stride1": (2, 8, 16, 12, 12, 3, 3, 1, 1, None),
    "stride2_cI3_7x7": (2, 3, 32, 20, 20, 7, 7, 2, 2, None),
    "ragged_hO": (3, 5, 7, 11, 13, 3, 5, 1, 2, None),
    "hF1": (1, 16, 8, 9, 9, 1, 1, 1, 1, None),
    "tiles_spatial_s2": (2, 4, 8, 25, 25, 3, 3, 2, 2, (1, 4, 8, 5, 7)),
    "tiles_spatial_s21": (2, 4, 8, 25, 25, 3, 3, 2, 1, (1, 4, 8, 23, 4)),
}


@pytest.mark.parametrize("case", sorted(CONV_CASES))
@pytest.mark.parametrize("dt", sorted(DTYPES))
def test_conv2d_matches_reference(case, dt):
    N, cI, cO, H, W, hF, wF, sh, sw, tiles = CONV_CASES[case]
    (jx, tx), (jw, tw) = _inputs(0, (N, cI, H, W), (cO, cI, hF, wF), dt)
    if tiles is None:
        want = jops.conv2d(jx, jw, stride=(sh, sw), ctx=J_CTX)
    else:
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", DeprecationWarning)
            want = jconv.conv2d(jx, jw, stride=(sh, sw), tiles=tiles)
    got = tconv2d(tx, tw, (sh, sw), tiles=tiles)
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **_tol(dt))


@pytest.mark.parametrize("mnk", [(100, 300, 77), (130, 257, 129),
                                 (1, 128, 64), (8, 128, 128)])
@pytest.mark.parametrize("dt", sorted(DTYPES))
def test_matmul_matches_reference(mnk, dt):
    m, n, k = mnk
    (ja, ta), (jb, tb) = _inputs(1, (m, k), (n, k), dt)
    jb, tb = jb.T, tb.t().contiguous()
    want = jops.matmul(ja, jb, ctx=J_CTX)
    got = tmatmul(ta, tb)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **_tol(dt))


@pytest.mark.parametrize("case", ["stride1", "stride2_cI3_7x7", "ragged_hO"])
@pytest.mark.parametrize("dt", sorted(DTYPES))
def test_conv2d_im2col_matches_reference(case, dt):
    N, cI, cO, H, W, hF, wF, sh, sw, _ = CONV_CASES[case]
    (jx, tx), (jw, tw) = _inputs(2, (N, cI, H, W), (cO, cI, hF, wF), dt)
    np.testing.assert_array_equal(
        im2col_patches(tx, hF, wF, (sh, sw)).float().numpy(),
        np.asarray(jim2col.im2col_patches(jx, hF, wF, (sh, sw)),
                   np.float32))
    want = jim2col.conv2d_im2col(jx, jw, stride=(sh, sw), ctx=J_CTX)
    got = conv2d_im2col(tx, tw, (sh, sw))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **_tol(dt))


# -- the counters: shape-only, exactly equal --------------------------------

COUNTER_TARGETS = ("H100", "TPU_V5E", "GEMMINI", "CPU_INTERPRET")


def _jt(name):
    return jp.HardwareTarget.from_dict(getattr(tp, name).to_dict())


def _meta(shape, dt):
    return torch.empty(shape, dtype=DTYPES[dt][1], device="meta")


def _sds(shape, dt):
    return jax.ShapeDtypeStruct(shape, DTYPES[dt][0])


WORD_CONVS = [  # (x shape, w shape, stride, tiles)
    ((1000, 3, 229, 229), (64, 3, 7, 7), (2, 2), None),
    ((1000, 64, 58, 58), (64, 64, 3, 3), (1, 1), None),
    ((1000, 512, 9, 9), (512, 512, 3, 3), (1, 1), None),
    ((2, 4, 25, 25), (8, 4, 3, 3), (2, 1), (1, 4, 8, 23, 4)),
    ((3, 5, 11, 13), (7, 5, 3, 5), (1, 2), (2, 3, 4)),
]


@pytest.mark.parametrize("target", COUNTER_TARGETS)
@pytest.mark.parametrize("out", ["f32", "bf16"])
def test_word_counters_equal(target, out):
    tt, jt = getattr(tp, target), _jt(target)
    jo, to = DTYPES[out]
    for xs, ws, stride, tiles in WORD_CONVS:
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", DeprecationWarning)
            want = jconv.conv2d_hbm_words(
                _sds(xs, "bf16"), _sds(ws, "bf16"), stride=stride,
                tiles=tiles, target=jt, out_dtype=jo)
        assert conv2d_hbm_words(_meta(xs, "bf16"), _meta(ws, "bf16"),
                                stride, tiles=tiles, target=tt,
                                out_dtype=to) == want
        assert im2col_hbm_words(_meta(xs, "bf16"), _meta(ws, "bf16"),
                                stride, target=tt, out_dtype=to) == \
            jim2col.im2col_hbm_words(_sds(xs, "bf16"), _sds(ws, "bf16"),
                                     stride=stride, target=jt, out_dtype=jo)
    for (m, n, k), tiles in [((12544000, 64, 147), None),
                             ((130, 257, 129), None),
                             ((130, 257, 129), (32, 48, 16))]:
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", DeprecationWarning)
            want = jmm.matmul_hbm_words(_sds((m, k), "f32"),
                                        _sds((k, n), "f32"), tiles=tiles,
                                        target=jt, out_dtype=jo)
        assert matmul_hbm_words(_meta((m, k), "f32"), _meta((k, n), "f32"),
                                tiles=tiles, target=tt, out_dtype=to) == want


# -- the CUDA side, where it can run --------------------------------------

def test_launch_configs_fit_the_card():
    """Every H100 plan of the main path launches: its accumulator tile fits
    256 threads x 64 registers and its stage fits a block's shared memory;
    a plan made for the TPU's 16 MiB VMEM is refused, not run."""
    from repro.core.conv_model import resnet50_layers

    for s in resnet50_layers(1000).values():
        spec = tp.ConvSpec(N=s.N, c_I=s.c_I, c_O=s.c_O, w_O=s.w_O,
                           h_O=s.h_O, w_F=s.w_F, h_F=s.h_F, sw=s.sw,
                           sh=s.sh, prec=tp.ops.Precision(0.5, 0.5, 1.0))
        bN, b_cI, b_cO, bh, bw = tp.Planner(tp.H100).plan(spec).tiles
        h_in, w_in = (bh - 1) * s.sh + s.h_F, (bw - 1) * s.sw + s.w_F
        cfg = launch_config((bN, b_cI, b_cO, bh, bw), s.h_F, s.w_F, h_in,
                            w_in, 2)
        assert cfg["threads"] <= 256 and cfg["smem"] <= 232448
        m, k = s.N * s.h_O * s.w_O, s.c_I * s.h_F * s.w_F
        bm, bn, bk = tp.Planner(tp.H100).plan(
            tp.MatmulSpec(m, s.c_O, k, tp.ops.Precision(.5, .5, 1.))).tiles
        assert mm_launch_config(bm, bn, bk, 2)["threads"] <= 256
    with pytest.raises(ValueError, match="accumulator tile"):
        launch_config((64, 8, 512, 7, 7), 3, 3, 9, 9, 2)


# -- the tensor-core GEMM's geometry (bf16 inputs) ---------------------------

def _gemm_tiles(m, n, k):
    return tuple(tp.Planner(tp.H100).plan(
        tp.MatmulSpec(m, n, k, tp.ops.Precision(.5, .5, 1.))).tiles)


# (m, n, k, tiles): the five Im2Col GEMMs at batch 1000 and chip_smoke.py's
# phase-3 GEMMs (None: the planner's tiles)
TC_GEMMS = {
    "conv1": (12544000, 64, 147, None),
    "conv2_x": (3136000, 64, 576, None),
    "conv3_x": (784000, 128, 1152, None),
    "conv4_x": (196000, 256, 2304, None),
    "conv5_x": (49000, 512, 4608, None),
    "ragged_77": (100, 300, 77, None),
    "ragged_129": (130, 257, 129, None),
    "m1": (1, 128, 64, None),
    "explicit_32x48": (130, 257, 129, (32, 48, 16)),
    "conv1_pitch": (3000, 64, 147, (128, 64, 144)),
    "k_not_span_multiple": (1000, 96, 208, None),
    "m_below_16": (5, 200, 96, None),
    "odd_pitch_spans": (257, 72, 1001, None),
}
# tiles only LINEAR covers, or that need a ragged covered tile
ODD_TILES = [(48, 336), (1024, 16), (16, 1024), (1, 8), (8, 128), (16, 16),
             (96, 128), (80, 200)]


def _tc_case(name):
    m, n, k, tiles = TC_GEMMS[name]
    return m, n, k, tiles or _gemm_tiles(m, n, k)


@pytest.mark.parametrize("name", list(TC_GEMMS))
def test_tensor_core_launch_config(name):
    """bf16 tiles of the main path and of phase 3 take a tensor-core
    variant within a CTA's threads, accumulators and shared memory."""
    m, n, k, (bm, bn, bk) = _tc_case(name)
    cfg = mm_launch_config(bm, bn, bk, 2, k)
    assert cfg["kernel"] == "tensor core"
    assert cfg["variant"] in range(len(TC_VARIANTS) + 1)
    assert cfg["threads"] <= 256 and cfg["threads"] % 32 == 0
    assert cfg["acc_per_thread"] <= 64
    assert cfg["smem"] <= 232448
    assert 2 <= cfg["slots"] <= 3 and cfg["ks"] % 16 == 0
    assert cfg["rows"] >= bm and cfg["cols"] >= bn
    # rows padded to an odd multiple of 16 bytes: ldmatrix conflict-free
    assert (cfg["lda"] * 2 // 16) % 2 == 1 and (cfg["ldb"] * 2 // 16) % 2 == 1
    if name.startswith("conv"):  # main-path tiles fit two CTAs an SM
        assert cfg["variant"] != LINEAR and cfg["smem"] <= 113 * 1024
    if k % 8 and k <= 256:  # an unaligned pitch: one span of whole rows
        assert cfg["n_spans"] == 1 and cfg["ks"] == -(-k // 16) * 16
    assert mm_launch_config(bm, bn, bk, 4, k)["kernel"] == "fma"


@pytest.mark.parametrize("tile", [_tc_case(n)[3][:2] for n in TC_GEMMS]
                         + ODD_TILES, ids=str)
def test_tensor_core_warp_layout_covers_the_tile_once(tile):
    """The warps' m16n8 tiles, as the kernel maps them, cover every
    element of the (bm, bn) tile exactly once, and stay inside the
    shared-memory extent the ring holds."""
    bm, bn = tile
    lay = warp_layout(bm, bn)
    count = np.zeros((lay["rows"], lay["cols"]), np.int64)
    warps = lay["wm"] * lay["wn"]
    for w in range(warps):
        owned = warp_tiles(lay, w)
        assert len(owned) <= lay["mi"] * lay["ni"] <= 16
        for mt, nt in owned:
            assert (mt + 1) * 16 <= lay["rows"] and (nt + 1) * 8 <= lay["cols"]
            count[mt * 16:(mt + 1) * 16, nt * 8:(nt + 1) * 8] += 1
    assert (count[:bm, :bn] == 1).all()
    assert warps * 32 <= 256


@pytest.mark.parametrize("name", list(TC_GEMMS) + ["k8", "k20"])
def test_tensor_core_stage_spans_tile_padded_k(name):
    """The ring's k-spans are multiples of 16 and tile [0, round_up(k, bk))
    exactly, so the words issued stay matmul_hbm_words'; the kernel runs
    the spans holding real k."""
    if name == "k8":
        m, n, k, (bm, bn, bk) = 40, 32, 8, (16, 32, 8)
    elif name == "k20":
        m, n, k, (bm, bn, bk) = 40, 32, 20, (16, 32, 16)
    else:
        m, n, k, (bm, bn, bk) = _tc_case(name)
    cfg = mm_launch_config(bm, bn, bk, 2, k)
    spans = stage_spans(k, bk, cfg["ks"])
    kp = -(-k // bk) * bk
    assert spans[0][0] == 0 and spans[-1][1] == kp
    assert all(a[1] == b[0] for a, b in zip(spans, spans[1:]))
    assert all((e - s) % 16 == 0 for s, e in spans[:-1])
    assert kp % 16 or (spans[-1][1] - spans[-1][0]) % 16 == 0
    assert cfg["n_spans"] == sum(s < k for s, _ in spans)


@pytest.mark.parametrize("tile", [(256, 128), (128, 256), (512, 64),
                                  (16, 2048)], ids=str)
def test_tensor_core_refuses_a_tile_no_variant_covers(tile):
    """More than 256 x 64 accumulators: ValueError, never the FMA kernel."""
    with pytest.raises(ValueError, match="accumulator tile"):
        mm_launch_config(*tile, 16, 2, 4608)


# -- the tensor-core conv's geometry and gather (bf16 inputs) ----------------

def _conv_plan(s):
    """The H100 plan's tiles and window of a ResNet-50 layer (bf16 in)."""
    spec = tp.ConvSpec(N=s.N, c_I=s.c_I, c_O=s.c_O, w_O=s.w_O, h_O=s.h_O,
                       w_F=s.w_F, h_F=s.h_F, sw=s.sw, sh=s.sh,
                       prec=tp.ops.Precision(0.5, 0.5, 1.0))
    bN, b_cI, b_cO, bh, bw = tp.Planner(tp.H100).plan(spec).tiles
    return ((bN, b_cI, b_cO, bh, bw), (bh - 1) * s.sh + s.h_F,
            (bw - 1) * s.sw + s.w_F)


H100_CONV_TILES = {  # the H100 plans of the five layers (PERF.md §4)
    "conv1": (2, 3, 32, 16, 16), "conv2_x": (4, 16, 64, 8, 8),
    "conv3_x": (1, 16, 32, 28, 14), "conv4_x": (2, 16, 32, 14, 14),
    "conv5_x": (5, 32, 64, 7, 7)}


@pytest.mark.parametrize("layer", sorted(H100_CONV_TILES))
def test_tensor_core_conv_launch_config(layer):
    """The five H100 conv plans take the tensor-core kernel in bf16: warps
    over the whole accumulator tile, at most 64 accumulators a thread, a
    ring that fits two CTAs an SM, two slots wherever c_I takes more than
    one stage; f32 inputs keep the FMA kernel."""
    from repro.core.conv_model import resnet50_layers

    s = resnet50_layers(1000)[layer]
    tiles, h_in, w_in = _conv_plan(s)
    assert tiles == H100_CONV_TILES[layer]
    bN, b_cI, b_cO, bh, bw = tiles
    H, W = (s.h_O - 1) * s.sh + s.h_F, (s.w_O - 1) * s.sw + s.w_F
    cfg = launch_config(tiles, s.h_F, s.w_F, h_in, w_in, 2, s.c_I, (H, W))
    assert cfg["kernel"] == "tensor core"
    assert cfg["variant"] == (0 if b_cO == 32 else 1)  # (4, 4) / (2, 8)
    assert cfg["threads"] == cfg["wm"] * cfg["wn"] * 32 <= 256
    assert cfg["acc_per_thread"] == 64
    assert cfg["rows"] >= bN * bh * bw and cfg["cols"] >= b_cO
    assert cfg["smem"] <= 113 * 1024 and cfg["smem"] <= 232448
    assert cfg["n_st"] == -(-s.c_I // cfg["cs"]) and b_cI % cfg["cs"] == 0
    assert cfg["slots"] == (2 if cfg["n_st"] > 1 else 1)
    assert cfg["n16"] * 16 >= cfg["ks"] == cfg["cs"] * s.h_F * s.w_F
    # filter rows padded to an odd multiple of 16 bytes: ldmatrix
    # conflict-free
    assert (cfg["ldb"] * 2 // 16) % 2 == 1 and cfg["ldb"] >= cfg["n16"] * 16
    # the epilogue stages 4-pixel stores where b_wO is a multiple of 4
    assert cfg["vst"] == (4 if bw % 4 == 0 else 0)
    if cfg["vst"]:
        assert cfg["smem"] >= b_cO * cfg["lds"] * 4 and cfg["lds"] % 16 == 4
    if layer == "conv1":  # taps folded into K: 147 -> 10 slices, one stage
        assert (cfg["ks"], cfg["n16"], cfg["n_st"]) == (147, 10, 1)
        assert cfg["planes"] == 4  # the zero plane for the padded k
    else:
        assert cfg["planes"] == cfg["cs"] and cfg["n_st"] > 1
    fma = launch_config(tiles, s.h_F, s.w_F, h_in, w_in, 4, s.c_I)
    assert fma["kernel"] == "fma" and fma["threads"] <= 256


@pytest.mark.parametrize("tile", [(1, 16, 1, 112, 112), (1, 8, 8, 64, 32),
                                  (1, 16, 16, 32, 32), (1, 16, 1024, 4, 4),
                                  (64, 8, 512, 7, 7)],
                         ids=str)
def test_tensor_core_conv_refuses_a_tile_no_variant_covers(tile):
    """A bf16 tile no rectangular warp block covers within 8 warps takes
    the LINEAR variant where its padded accumulator tile fits 8 warps x 64
    accumulators, and raises ValueError only past that (never the FMA
    kernel); f32 takes the FMA kernel where its micro-tiles fit."""
    bN, _, b_cO, bh, bw = tile
    covered = -(-bN * bh * bw // 16) * 16 * -(-b_cO // 8) * 8
    if covered <= 256 * 64:
        cfg = launch_config(tile, 3, 3, 9, 9, 2)
        assert cfg["variant"] == CONV_LINEAR and cfg["linear"]
        assert cfg["threads"] <= 256 and cfg["acc_per_thread"] == 64
    else:
        with pytest.raises(ValueError, match="accumulator tile"):
            launch_config(tile, 3, 3, 9, 9, 2)
    if tile[2] < 512:
        assert launch_config(tile, 3, 3, 9, 9, 4)["kernel"] == "fma"


# The launch of the five layers' bf16 plans, analytic and as the measured
# autotuner tuned them on the card (PERF.md §6), as the tree before the
# LINEAR conv layout computed them: warp block, warp grid, covered tile,
# threads, ring stage, window layout, shared memory, and the words
# conv2d_hbm_words charges. The LINEAR layout is taken only where no
# rectangular block fits, so none of these may move.
PINNED_KEYS = ("variant", "mi", "ni", "wm", "wn", "rows", "cols", "threads",
               "cs", "n_st", "ks", "n16", "planes", "ldb", "slots", "d_row",
               "d_ch", "d_img", "zero", "x_elems", "x_bytes", "slot_bytes",
               "koff_bytes", "rows_bytes", "vst", "lds", "smem")
PINNED_MAIN_PATH = {
    ("conv1", "analytic"): ((2, 3, 32, 16, 16), (
        0, 4, 4, 8, 1, 512, 32, 256, 3, 1, 147, 10, 4, 168, 1, 45, 1665,
        6723, 5027, 13462, 26928, 37680, 640, 1776, 4, 516, 66048),
        1119307000.0),
    ("conv1", "tuned"): ((2, 3, 64, 8, 16), (
        1, 2, 8, 8, 1, 256, 64, 256, 3, 1, 147, 10, 4, 168, 1, 45, 945,
        3843, 2867, 7702, 15408, 36912, 640, 1008, 4, 260, 66560),
        1147531000.0),
    ("conv2_x", "analytic"): ((4, 16, 64, 8, 8), (
        1, 2, 8, 8, 1, 256, 64, 256, 16, 4, 144, 9, 16, 152, 2, 18, 180,
        2936, 2912, 11760, 23520, 42976, 576, 5120, 4, 260, 91648),
        583296000.0),
    ("conv3_x", "analytic"): ((1, 16, 32, 28, 14), (
        0, 4, 4, 7, 1, 448, 32, 224, 16, 8, 144, 9, 16, 152, 2, 30, 900,
        14456, 14432, 14472, 28944, 38672, 576, 3840, 0, 452, 81760),
        493568000.0),
    ("conv3_x", "tuned"): ((1, 16, 32, 14, 28), (
        0, 4, 4, 7, 1, 448, 32, 224, 16, 8, 144, 9, 16, 152, 2, 38, 612,
        9848, 9824, 9864, 19728, 29456, 576, 2048, 4, 452, 61536),
        493568000.0),
    ("conv4_x", "analytic"): ((2, 16, 32, 14, 14), (
        0, 4, 4, 7, 1, 448, 32, 224, 16, 16, 144, 9, 16, 152, 2, 16, 256,
        4152, 4128, 8320, 16640, 26368, 576, 4096, 0, 452, 57408),
        459776000.0),
    ("conv4_x", "tuned"): ((2, 32, 32, 14, 14), (
        0, 4, 4, 7, 1, 448, 32, 224, 32, 8, 288, 18, 32, 296, 2, 16, 256,
        8248, 8224, 16512, 33024, 51968, 1152, 8192, 0, 452, 113280),
        459776000.0),
    ("conv5_x", "analytic"): ((5, 32, 64, 7, 7), (
        1, 2, 8, 8, 1, 256, 64, 256, 16, 32, 144, 9, 16, 152, 2, 9, 81,
        1352, 1328, 6776, 13552, 33008, 576, 5760, 0, 260, 72352),
        426905600.0),
    ("conv5_x", "tuned"): ((5, 16, 64, 7, 7), (
        1, 2, 8, 8, 1, 256, 64, 256, 16, 32, 144, 9, 16, 152, 2, 9, 81,
        1352, 1328, 6776, 13552, 33008, 576, 5760, 0, 260, 72352),
        426905600.0),
}


@pytest.mark.parametrize("key", sorted(PINNED_MAIN_PATH),
                         ids=lambda k: "-".join(k))
def test_tensor_core_conv_main_path_launch_is_pinned(key):
    """The main path's bf16 conv launches keep their rectangular warp
    blocks, launch configuration, shared memory and words (the analytic
    plans are the planner's own; the tuned tiles the card picked)."""
    from repro.core.conv_model import resnet50_layers

    layer, kind = key
    tiles, want, words = PINNED_MAIN_PATH[key]
    s = resnet50_layers(1000)[layer]
    if kind == "analytic":
        assert _conv_plan(s)[0] == tiles
    H, W = (s.h_O - 1) * s.sh + s.h_F, (s.w_O - 1) * s.sw + s.w_F
    h_in, w_in = (tiles[3] - 1) * s.sh + s.h_F, (tiles[4] - 1) * s.sw + s.w_F
    cfg = launch_config(tiles, s.h_F, s.w_F, h_in, w_in, 2, s.c_I, (H, W))
    assert tuple(cfg[k] for k in PINNED_KEYS) == want
    assert not cfg["linear"]
    x = torch.empty((s.N, s.c_I, H, W), dtype=torch.bfloat16, device="meta")
    w = torch.empty((s.c_O, s.c_I, s.h_F, s.w_F), dtype=torch.bfloat16,
                    device="meta")
    assert conv2d_hbm_words(x, w, (s.sh, s.sw), tiles=tiles) == words


def _emulate_tc_conv(x, w, stride, tiles):
    """The tensor-core kernel's arithmetic in plain PyTorch (f32): for each
    output tile and ring stage, the window staged as the kernel stages it
    (NCHW at window_layout's pitches from an unaligned origin, zero past the
    input, the zero plane zeroed, every other slot element NaN, which no
    product may read), the filter block as [co][k] rows zero-padded to 16
    k, A gathered through the wrapper's gather_table and the kernel's
    row_offsets, one GEMM per stage into the tile's accumulator (for the
    LINEAR layout, one m16 x n8 product per tile each warp owns, as
    warp_tiles maps them, every covered tile owned once)."""
    N, c_I, H, W = x.shape
    c_O, _, h_F, w_F = w.shape
    sh, sw = stride
    h_O, w_O = (H - h_F) // sh + 1, (W - w_F) // sw + 1
    bN, b_cI, b_cO, bh, bw = tiles
    (Np, _, cOp, hOp, wOp, Hp, Wp, h_in, w_in,
     grid) = _launch_geometry(N, c_I, c_O, H, W, h_F, w_F, sh, sw, tiles)
    g = WINDOW_RUN
    cfg = launch_config(tiles, h_F, w_F, h_in, w_in, 2, c_I, (H, W))
    cs, n16 = cfg["cs"], cfg["n16"]
    d_row, d_ch, d_img = cfg["d_row"], cfg["d_ch"], cfg["d_img"]
    koff = torch.tensor(gather_table(cs, h_F, w_F, d_row, d_ch, cfg["zero"]))
    moff = torch.tensor(row_offsets(cfg["rows"], tiles, stride, d_img,
                                    d_row))
    origin = g + g - 1  # the latest a step's window starts in its slot
    assert len(koff) == n16 * 16
    xp = torch.zeros(Np, cfg["n_st"] * cs, Hp, Wp)
    xp[:N, :c_I, :H, :W] = x.float()
    wk = torch.zeros(cOp, cfg["n_st"] * cs, h_F * w_F)
    wk[:c_O, :c_I] = w.float().reshape(c_O, c_I, -1)
    out = torch.zeros(Np, cOp, hOp, wOp)
    M = bN * bh * bw
    owned = torch.zeros(cfg["rows"], cfg["cols"])
    for n0 in range(0, Np, bN):
        for co0 in range(0, cOp, b_cO):
            for r0 in range(0, hOp, bh):
                for c0 in range(0, wOp, bw):
                    acc = torch.zeros(cfg["rows"], cfg["cols"])
                    for ci0 in range(0, cfg["n_st"] * cs, cs):
                        slot = torch.full((cfg["x_elems"],), float("nan"))
                        if cfg["planes"] > cs:  # as the kernel zeroes it
                            for n in range(bN):
                                z = n * d_img + cfg["zero"] + g
                                slot[z:z + d_ch + g] = 0
                        slot[origin:].as_strided(
                            (bN, cs, h_in, w_in), (d_img, d_ch, d_row, 1))[
                            :] = xp[n0:n0 + bN, ci0:ci0 + cs,
                                    r0 * sh:r0 * sh + h_in,
                                    c0 * sw:c0 * sw + w_in]
                        b = torch.zeros(cfg["cols"], n16 * 16)
                        b[:b_cO, :cfg["ks"]] = wk[co0:co0 + b_cO,
                                                  ci0:ci0 + cs].reshape(
                                                      b_cO, -1)
                        a = slot[origin:][moff[:, None] + koff[None, :]]
                        assert not a[:, cfg["ks"]:].any()  # the zero plane
                        assert not a.isnan().any()  # no slack is gathered
                        with ref.no_tf32():
                            if not cfg["linear"]:
                                acc += a @ b.t()
                            for wp in range(cfg["threads"] // 32
                                            if cfg["linear"] else 0):
                                for mt, nt in warp_tiles(cfg, wp):
                                    rs = slice(mt * 16, mt * 16 + 16)
                                    cs_ = slice(nt * 8, nt * 8 + 8)
                                    acc[rs, cs_] += a[rs] @ b[cs_].t()
                                    owned[rs, cs_] += 1
                    out[n0:n0 + bN, co0:co0 + b_cO, r0:r0 + bh,
                        c0:c0 + bw] = acc[:M, :b_cO].reshape(
                            bN, bh, bw, b_cO).permute(0, 3, 1, 2)
    if cfg["linear"]:  # each covered tile once a stage of each CTA
        assert (owned == owned.flatten()[0]).all() and owned.max() > 0
    return out[:N, :c_O, :h_O, :w_O]


# (N, c_I, c_O, H, W, h_F, w_F, sh, sw, tiles): the H100 plans of narrow
# convs (few output channels, many pixels a tile), which no rectangular warp
# block covers within 8 warps: they take the LINEAR layout
NARROW_CONV_CASES = {
    "narrow_784x16": (4, 8, 16, 16, 16, 3, 3, 1, 1, (4, 8, 16, 14, 14)),
    "narrow_1800x8": (4, 3, 8, 32, 32, 3, 3, 1, 1, (2, 3, 8, 30, 30)),
    "narrow_1568x8": (8, 16, 8, 30, 30, 3, 3, 1, 1, (2, 16, 8, 28, 28)),
}


def test_conv_geometry_matches_the_source():
    """The C entry's geometry array: GEOMETRY's length and order are
    csrc/conv2d.cu's N_GEOMETRY and ConvParams fields."""
    import re

    from repro_torch.kernels._build import CSRC
    from repro_torch.kernels.conv2d import GEOMETRY

    src = (CSRC / "conv2d.cu").read_text()
    n = int(re.search(r"constexpr int N_GEOMETRY = (\d+);", src).group(1))
    assert n == len(GEOMETRY) == len(set(GEOMETRY))
    assert GEOMETRY[-1] == "cn" and "&p.zero, &p.cn}" in src


@pytest.mark.parametrize("case", sorted(NARROW_CONV_CASES))
def test_narrow_conv_plans_take_the_linear_layout(case):
    """The H100 planner's tiles for each narrow conv, and their launch: the
    LINEAR variant, at most 8 warps of 16 m16n8 tiles that cover the tile."""
    N, cI, cO, H, W, hF, wF, sh, sw, tiles = NARROW_CONV_CASES[case]
    h_O, w_O = (H - hF) // sh + 1, (W - wF) // sw + 1
    spec = tp.ConvSpec(N=N, c_I=cI, c_O=cO, w_O=w_O, h_O=h_O, w_F=wF, h_F=hF,
                       sw=sw, sh=sh, prec=tp.ops.Precision(0.5, 0.5, 1.0))
    assert tuple(tp.Planner(tp.H100).plan(spec).tiles) == tiles
    bN, _, b_cO, bh, bw = tiles
    cfg = launch_config(tiles, hF, wF, (bh - 1) * sh + hF, (bw - 1) * sw + wF,
                        2, cI, (H, W))
    assert cfg["variant"] == CONV_LINEAR and cfg["linear"]
    cm, cn = -(-bN * bh * bw // 16), -(-b_cO // 8)
    assert (cfg["rows"], cfg["cols"]) == (cm * 16, cn * 8)
    assert cfg["threads"] == 32 * -(-cm * cn // 16) <= 256


# (N, c_I, c_O, H, W, h_F, w_F, sh, sw, tiles): each H100 tile shape at a
# small N, H and W that keeps ragged edges and several c_I stages
TC_CONV_CASES = {
    "conv1_tile": (3, 3, 40, 41, 41, 7, 7, 2, 2, H100_CONV_TILES["conv1"]),
    "conv2_x_tile": (5, 40, 72, 12, 12, 3, 3, 1, 1,
                     H100_CONV_TILES["conv2_x"]),
    "conv3_x_tile": (2, 20, 40, 30, 30, 3, 3, 1, 1,
                     H100_CONV_TILES["conv3_x"]),
    "conv4_x_tile": (3, 40, 36, 16, 16, 3, 3, 1, 1,
                     H100_CONV_TILES["conv4_x"]),
    "conv5_x_tile": (6, 40, 70, 9, 9, 3, 3, 1, 1,
                     H100_CONV_TILES["conv5_x"]),
    **NARROW_CONV_CASES,
}


@pytest.mark.parametrize("case", sorted(CONV_CASES) + sorted(TC_CONV_CASES))
def test_tensor_core_conv_gather_matches_reference(case):
    """The tensor-core kernel's gather tables, emulated in plain PyTorch
    (gather, then one product per tile and ring stage), equal conv2d_plain
    within 1e-4 and the Pallas kernel in interpret mode within _tol, on
    the same numpy inputs in bf16."""
    N, cI, cO, H, W, hF, wF, sh, sw, tiles = {**CONV_CASES,
                                              **TC_CONV_CASES}[case]
    (jx, tx), (jw, tw) = _inputs(3, (N, cI, H, W), (cO, cI, hF, wF), "bf16")
    h_O, w_O = (H - hF) // sh + 1, (W - wF) // sw + 1
    if tiles is None:
        tiles = tp.Planner(tp.H100).plan(tp.ConvSpec(
            N=N, c_I=cI, c_O=cO, w_O=w_O, h_O=h_O, w_F=wF, h_F=hF, sw=sw,
            sh=sh, prec=tp.ops.Precision(0.5, 0.5, 1.0))).tiles
    tiles = tuple(tiles)
    if len(tiles) == 5:
        tiles = (*tiles[:3], min(tiles[3], h_O), min(tiles[4], w_O))
    got = _emulate_tc_conv(tx, tw, (sh, sw), tiles)
    np.testing.assert_allclose(got.numpy(),
                               conv2d_plain(tx, tw, (sh, sw)).numpy(),
                               rtol=1e-4, atol=1e-4)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        want = jconv.conv2d(jx, jw, stride=(sh, sw), tiles=tiles)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **_tol("bf16"))


@pytest.mark.parametrize("case", sorted(CONV_CASES) + sorted(TC_CONV_CASES))
def test_window_covers_stay_in_their_row(case):
    """The window copies move each row as the 8-element runs of the input
    that cover it, into a slot whose origin is 8 + (the step's input offset
    mod 8): for every offset, each run lands aligned inside the slot and
    touches no element of another row and none of the zero plane."""
    N, cI, cO, H, W, hF, wF, sh, sw, tiles = {**CONV_CASES,
                                              **TC_CONV_CASES}[case]
    h_O, w_O = (H - hF) // sh + 1, (W - wF) // sw + 1
    if tiles is None:
        tiles = tp.Planner(tp.H100).plan(tp.ConvSpec(
            N=N, c_I=cI, c_O=cO, w_O=w_O, h_O=h_O, w_F=wF, h_F=hF, sw=sw,
            sh=sh, prec=tp.ops.Precision(0.5, 0.5, 1.0))).tiles
    tiles = tuple(tiles)
    if len(tiles) == 3:
        tiles = (*tiles, h_O, w_O)
    tiles = (*tiles[:3], min(tiles[3], h_O), min(tiles[4], w_O))
    bN, _, _, bh, bw = tiles
    h_in, w_in = (bh - 1) * sh + hF, (bw - 1) * sw + wF
    g = WINDOW_RUN
    cfg = launch_config(tiles, hF, wF, h_in, w_in, 2, cI, (H, W))
    cs, d_row, d_ch, d_img = cfg["cs"], cfg["d_row"], cfg["d_ch"], cfg["d_img"]
    run = h_in == H and w_in == W
    rows = [(n, 0, 0) for n in range(bN)] if run else [
        (n, c, r) for n in range(bN) for c in range(cs) for r in range(h_in)]
    length = cs * H * W if run else w_in
    for g0m in range(g):
        origin = g + g0m
        owner = np.full(cfg["x_elems"], -1)
        if cfg["planes"] > cs:
            for n in range(bN):
                z = n * d_img + cfg["zero"] + g
                owner[z:z + d_ch + g] = -2  # the zero plane
        for q, (n, c, r) in enumerate(rows):
            d = origin + n * d_img + c * d_ch + r * d_row
            assert (owner[d:d + length] == -1).all()
            owner[d:d + length] = q
        for q, (n, c, r) in enumerate(rows):
            rel = n * cI * H * W + c * H * W + r * W
            d = origin + n * d_img + c * d_ch + r * d_row
            a = (g0m + rel) % g
            assert (d - a) % g == 0  # an aligned run of x lands aligned
            for start in range(-a, length, g):
                run_ = owner[d + start:d + start + g]
                assert d + start >= 0 and d + start + g <= cfg["x_elems"]
                assert np.isin(run_, (-1, q)).all()


def test_gather_tables_index_the_staged_window():
    """koff follows OIHW k over a stage's channels at the window's pitches
    and sends the padded k to the zero plane; moff is n-major over (n, ho,
    wo) with the stride, 0 past the tile's pixels. conv1's pitches are
    congruent to its 229-wide input modulo 8 elements, with a run of slack
    a row."""
    assert gather_table(1, 1, 1, 5, 20, 44) == [0] + [44] * 15
    cfg = launch_config((2, 3, 32, 16, 16), 7, 7, 37, 37, 2, 3, (229, 229))
    d_row, d_ch, d_img = cfg["d_row"], cfg["d_ch"], cfg["d_img"]
    assert d_row >= 37 + 7 and (d_row - 229) % 8 == 0
    assert d_ch >= 36 * d_row + 37 + 7 and (d_ch - 229 ** 2) % 8 == 0
    assert d_img >= 4 * d_ch + 56 and (d_img - 3 * 229 ** 2) % 8 == 0
    koff = gather_table(3, 7, 7, d_row, d_ch, cfg["zero"])
    assert len(koff) == 160 and koff[:3] == [0, 1, 2] and koff[7] == d_row
    assert koff[49] == d_ch and koff[146] == 2 * d_ch + 6 * d_row + 6
    assert koff[147:] == [3 * d_ch + 32] * 13 == [cfg["zero"]] * 13
    moff = row_offsets(520, (2, 3, 32, 16, 16), (2, 2), d_img, d_row)
    assert moff[:2] == [0, 2] and moff[16] == 2 * d_row
    assert moff[256] == d_img and moff[512:] == [0] * 8
    # whole-plane windows keep contiguous planes: one run an image
    cfg = launch_config((5, 32, 64, 7, 7), 3, 3, 9, 9, 2, 512, (9, 9))
    assert (cfg["d_row"], cfg["d_ch"]) == (9, 81)


def test_vector_width_follows_pitch_and_alignment():
    """The global load width: 16-byte cp.async only where the pitch and
    base allow it (conv1's 147-element rows take 2-byte loads)."""
    assert vector_width(576, ptrs=(256,)) == 8
    assert vector_width(147, ptrs=(256,)) == 1
    assert vector_width(300, 128, ptrs=(0,)) == 4
    assert vector_width(576, ptrs=(258,)) == 1
    assert vector_width(576, ptrs=(260,)) == 2
    # int8 (matmul_q): up to 16 elements, the base aligned in bytes
    assert vector_width(4608, ptrs=(23040,), itemsize=1) == 16
    assert vector_width(300, 256, ptrs=(0,), itemsize=1) == 4
    assert vector_width(77, ptrs=(0,), itemsize=1) == 1
    assert vector_width(4608, ptrs=(231,), itemsize=1) == 1


def test_cuda_tensor_never_takes_the_plain_version():
    """A tensor that is not on the CPU goes to the kernel or raises; it is
    never served by the plain version."""
    x = torch.empty((2, 4, 9, 9), device="meta")
    w = torch.empty((8, 4, 3, 3), device="meta")
    with pytest.raises(ValueError, match="CUDA device"):
        tconv2d(x, w)
    with pytest.raises(ValueError, match="CUDA device"):
        tmatmul(torch.empty((4, 4), device="meta"),
                torch.empty((4, 4), device="meta"))
    assert all(k.launches == 0 for k in KERNELS.values())


@pytest.mark.cuda
def test_kernels_match_plain_on_the_card():
    """The hand-written kernels against their plain versions (runs only
    where there is a GPU and nvcc; chip_smoke.py runs the same checks at the
    main path's shapes)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: CUDA kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    # bf16 in: the tensor-core conv, one counted launch a case; f32 in: the
    # FMA kernel
    conv_tc = KERNELS["conv2d"].tensor_core_launches
    cases = {**CONV_CASES, **TC_CONV_CASES}
    for case, (N, cI, cO, H, W, hF, wF, sh, sw, tiles) in cases.items():
        for dt in ("bf16", "f32"):
            (_, tx), (_, tw) = _inputs(0, (N, cI, H, W), (cO, cI, hF, wF), dt)
            tx, tw = tx.cuda(), tw.cuda()
            got = tconv2d(tx, tw, (sh, sw), tiles=tiles)
            torch.testing.assert_close(got, conv2d_plain(tx, tw, (sh, sw)),
                                       rtol=1e-4, atol=1e-4)
    assert KERNELS["conv2d"].tensor_core_launches == conv_tc + len(cases)
    a = torch.randn(130, 129, device="cuda")
    b = torch.randn(129, 257, device="cuda")
    torch.testing.assert_close(tmatmul(a, b), matmul_plain(a, b),
                               rtol=1e-4, atol=1e-4)
    # bf16 in: the tensor-core kernel, f32 out (bf16 products are exact in
    # f32; the sums differ in order only)
    tc = KERNELS["matmul"].tensor_core_launches
    for m, n, k, tiles in [(3000, 64, 147, (128, 64, 144)),
                           (130, 257, 129, None), (100, 300, 77, None),
                           (1000, 96, 208, None), (5, 200, 96, None)]:
        a = torch.randn(m, k, device="cuda").bfloat16()
        b = (torch.randn(k, n, device="cuda") * k ** -0.5).bfloat16()
        torch.testing.assert_close(tmatmul(a, b, tiles=tiles),
                                   matmul_plain(a, b), rtol=1e-4, atol=1e-4)
    assert KERNELS["matmul"].tensor_core_launches == tc + 5


def test_oracles_keep_the_callers_tf32_setting():
    """The oracles and plain versions turn TF32 off only while they run."""
    cudnn, cuda = torch.backends.cudnn, torch.backends.cuda.matmul
    saved = (cudnn.allow_tf32, cuda.allow_tf32)
    x, w = torch.ones(1, 2, 5, 5), torch.ones(3, 2, 3, 3)
    try:
        cudnn.allow_tf32 = cuda.allow_tf32 = True
        with ref.no_tf32():
            assert not cudnn.allow_tf32 and not cuda.allow_tf32
        ref.conv2d_ref(x, w)
        ref.matmul_ref(x[0, 0], x[0, 0])
        conv2d_plain(x, w)
        matmul_plain(x[0, 0], x[0, 0])
        assert cudnn.allow_tf32 and cuda.allow_tf32
    finally:
        cudnn.allow_tf32, cuda.allow_tf32 = saved
