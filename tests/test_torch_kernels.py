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
from repro_torch.kernels.conv2d import conv2d_hbm_words, launch_config
from repro_torch.kernels.im2col import (conv2d_im2col, im2col_hbm_words,
                                        im2col_patches)
from repro_torch.kernels.matmul import matmul as tmatmul
from repro_torch.kernels.matmul import matmul_hbm_words
from repro_torch.kernels.matmul import launch_config as mm_launch_config

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
    for case, (N, cI, cO, H, W, hF, wF, sh, sw, tiles) in CONV_CASES.items():
        (_, tx), (_, tw) = _inputs(0, (N, cI, H, W), (cO, cI, hF, wF), "bf16")
        tx, tw = tx.cuda(), tw.cuda()
        got = tconv2d(tx, tw, (sh, sw), tiles=tiles)
        torch.testing.assert_close(got, conv2d_plain(tx, tw, (sh, sw)),
                                   rtol=1e-4, atol=1e-4)
    a = torch.randn(130, 129, device="cuda")
    b = torch.randn(129, 257, device="cuda")
    torch.testing.assert_close(tmatmul(a, b), matmul_plain(a, b),
                               rtol=1e-4, atol=1e-4)


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
