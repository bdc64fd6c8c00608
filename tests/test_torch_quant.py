"""repro_torch's int8 slice against repro's: the quantization numerics, the
int8 conv2d_q / matmul_q outputs on the same numpy inputs (the reference's
Pallas kernels in interpret mode and its xla entries, the port's plain
versions on the CPU), the int8 word counters, plans and explain records,
and the int8 kernels' launch configurations.

Tolerances: none. The codes and scales are computed in f32 by the same
steps on both sides (round half to even), and at these sizes every partial
sum of int8 products is below 2^24, so the reference's f32 accumulator and
the port's exact sum agree, and so do the scaled, cast outputs, bit for
bit."""

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
import repro_torch.quant as tq
from repro import ops as jops
from repro.core.conv_model import Precision as JPrecision
from repro.core.conv_model import resnet50_layers
from repro_torch import ops as tops
from repro_torch.core.conv_model import Precision
from repro_torch.kernels import (KERNELS, conv2d_q, conv2d_q_hbm_words,
                                 conv2d_q_plain, matmul_q, matmul_q_hbm_words,
                                 matmul_q_plain)
from repro_torch.kernels.quant import conv_launch_config, matmul_launch_config

jquant = importlib.import_module("repro.kernels.quant")

OUT = {"f32": (jnp.float32, torch.float32),
       "bf16": (jnp.bfloat16, torch.bfloat16)}
J_H100 = jp.HardwareTarget.from_dict(tp.H100.to_dict())
# the reference runs its Pallas kernels in interpret mode on the CPU
J_CTX = jops.ExecutionContext(target=J_H100, backend="pallas", interpret=True)
J_XLA = jops.ExecutionContext(target=J_H100, backend="xla")
CPU = tops.ExecutionContext(device="cpu")  # cuda backend: plain versions
TARGETS = ("H100", "TPU_V5E", "GEMMINI")


def _np(t: torch.Tensor) -> np.ndarray:
    return t.float().numpy() if t.dtype == torch.bfloat16 else t.numpy()


def _jnp(a) -> np.ndarray:
    a = jnp.asarray(a)
    return np.asarray(a.astype(jnp.float32) if a.dtype == jnp.bfloat16 else a)


def _jt(name):
    return jp.HardwareTarget.from_dict(getattr(tp, name).to_dict())


# -- numerics: codes and scales equal ----------------------------------------

def _with_zero_slices(shape, axis, seed):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal(shape) * rng.uniform(0.1, 10.0)).astype(
        np.float32)
    x.flat[::7] = 0.5 * np.abs(x.flat[::7])  # some exact ties after scaling
    if axis is not None:
        idx = [slice(None)] * len(shape)
        idx[axis] = 1
        x[tuple(idx)] = 0.0  # an all-zero slice: scale 1.0
    return x


@pytest.mark.parametrize("shape,axis", [
    ((6, 5, 4), None), ((6, 5, 4), 0), ((6, 5, 4), 1), ((6, 5, 4), -1),
    ((9, 3, 3, 3), 0), ((7,), 0), ((33, 17), 1)])
def test_quantize_symmetric_equal(shape, axis):
    x = _with_zero_slices(shape, axis, seed=len(shape) + (axis or 0) + 7)
    jq_, js = jq.quantize_symmetric(jnp.asarray(x), axis=axis)
    tq_, ts = tq.quantize_symmetric(torch.from_numpy(x), axis=axis)
    assert tq_.dtype == torch.int8 and ts.dtype == torch.float32
    np.testing.assert_array_equal(tq_.numpy(), np.asarray(jq_))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    np.testing.assert_array_equal(
        tq.dequantize(tq_, ts, axis=axis).numpy(),
        np.asarray(jq.dequantize(jq_, js, axis=axis)))
    zeros = tq.quantize_symmetric(torch.zeros(shape), axis=axis)
    assert (zeros[0] == 0).all() and (zeros[1] == 1.0).all()


def test_fold_and_operand_quantizers_equal():
    rng = np.random.default_rng(11)
    x = rng.standard_normal((2, 5, 9, 9)).astype(np.float32)
    w = rng.standard_normal((7, 5, 3, 3)).astype(np.float32)
    w[3] = 0.0
    want = jq.quantize_conv_operands(jnp.asarray(x), jnp.asarray(w))
    got = tq.quantize_conv_operands(torch.from_numpy(x), torch.from_numpy(w))
    a = rng.standard_normal((13, 24)).astype(np.float32)
    b = rng.standard_normal((24, 10)).astype(np.float32)
    b[:, 4] = 0.0
    want += jq.quantize_matmul_operands(jnp.asarray(a), jnp.asarray(b))
    got += tq.quantize_matmul_operands(torch.from_numpy(a),
                                       torch.from_numpy(b))
    for g, wnt in zip(got, want):
        assert g.shape == wnt.shape
        np.testing.assert_array_equal(g.numpy(), np.asarray(wnt))
    assert got[2].shape == (1, 7) and got[5].shape == (1, 10)
    s_in, s_out = np.float32(0.37), rng.uniform(0.01, 1, 6).astype(np.float32)
    np.testing.assert_array_equal(
        tq.fold_output_scales(torch.tensor(s_in),
                              torch.from_numpy(s_out)).numpy(),
        np.asarray(jq.fold_output_scales(s_in, s_out)))


# -- kernels: bit-equal outputs ----------------------------------------------

CONV_CASES = {  # (N, c_I, c_O, H, W, h_F, w_F, sh, sw, tiles)
    "stride1": (2, 8, 16, 12, 12, 3, 3, 1, 1, None),
    "stride2_cI3_7x7": (2, 3, 32, 20, 20, 7, 7, 2, 2, None),
    "ragged_cI_cO": (3, 5, 7, 11, 13, 3, 5, 1, 2, None),
    "hF1_s2": (2, 6, 8, 16, 16, 1, 1, 2, 2, (1, 6, 8, 3, 5)),
    "tiles_spatial_s2": (2, 4, 8, 25, 25, 3, 3, 2, 2, (1, 4, 8, 5, 7)),
    "tiles_spatial_s21": (2, 4, 8, 25, 25, 3, 3, 2, 1, (1, 4, 8, 23, 4)),
}
# the tensor-core conv's edge cases: each H100 int8 tile of the main path
# (PERF.md §4) at a small N, H and W that keeps ragged N, c_O, h and w
# edges (conv1: one stage of 147 k and the zero plane, the filter block as
# one run; conv2_x: 37 channels over stages of 32, the last ragged and not a
# multiple of 4, rows of a 62-byte pitch, filter rows of 333 bytes; conv3_x:
# 16-byte filter copies; conv4_x: three stages, the ring's slot 0
# refilled; conv5_x: whole-plane windows), stride 2 over two stages, and a
# tile that only the LINEAR warp layout covers
TC_CONV_CASES = {
    "conv1_tile": (3, 3, 70, 41, 41, 7, 7, 2, 2, (2, 3, 64, 16, 16)),
    "conv2_x_tile": (2, 37, 72, 12, 62, 3, 3, 1, 1, (1, 16, 64, 8, 56)),
    "conv3_x_tile": (6, 48, 70, 20, 20, 3, 3, 1, 1, (5, 16, 64, 14, 7)),
    "conv4_x_tile": (6, 72, 64, 16, 16, 3, 3, 1, 1, (5, 16, 64, 14, 7)),
    "conv5_x_tile": (11, 40, 70, 9, 9, 3, 3, 1, 1, (10, 16, 64, 7, 7)),
    "stride2_stages": (2, 36, 40, 23, 23, 3, 3, 2, 2, (1, 16, 32, 5, 6)),
    "linear_tile": (2, 8, 32, 40, 40, 3, 3, 1, 1, (1, 8, 32, 32, 32)),
}


def _conv_operands(seed, xs, ws):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(xs).astype(np.float32)
    w = rng.standard_normal(ws).astype(np.float32)
    xq, wq, s = jq.quantize_conv_operands(jnp.asarray(x), jnp.asarray(w))
    return (xq, wq, s), tuple(torch.from_numpy(np.array(a))
                              for a in (xq, wq, s))


@pytest.mark.parametrize("case", sorted(CONV_CASES))
@pytest.mark.parametrize("out", sorted(OUT))
def test_conv2d_q_matches_reference(case, out):
    N, cI, cO, H, W, hF, wF, sh, sw, tiles = CONV_CASES[case]
    jo, to = OUT[out]
    (jx, jw, js), (tx, tw, ts) = _conv_operands(3, (N, cI, H, W),
                                               (cO, cI, hF, wF))
    if tiles is None:
        want = jops.conv2d_q(jx, jw, js, stride=(sh, sw), ctx=J_CTX,
                             out_dtype=jo)
    else:
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", DeprecationWarning)
            want = jquant.conv2d_q(jx, jw, js, stride=(sh, sw), tiles=tiles,
                                   out_dtype=jo)
    xla = jops.conv2d_q(jx, jw, js, stride=(sh, sw), ctx=J_XLA, out_dtype=jo)
    got = conv2d_q(tx, tw, ts, (sh, sw), out_dtype=to, tiles=tiles)
    assert got.dtype == to and got.shape == want.shape
    np.testing.assert_array_equal(_np(got), _jnp(want))
    np.testing.assert_array_equal(_np(got), _jnp(xla))
    torch_be = tops.conv2d_q(tx, tw, ts, (sh, sw), out_dtype=to,
                             ctx=tops.ExecutionContext(backend="torch",
                                                       device="cpu"))
    np.testing.assert_array_equal(_np(torch_be), _np(got))


@pytest.mark.parametrize("mkn,tiles", [
    ((100, 77, 300), None), ((130, 129, 257), None), ((1, 64, 128), None),
    ((130, 129, 257), (32, 48, 16)), ((40, 30, 20), (16, 8, 6))])
@pytest.mark.parametrize("out", sorted(OUT))
def test_matmul_q_matches_reference(mkn, tiles, out):
    m, k, n = mkn
    jo, to = OUT[out]
    rng = np.random.default_rng(5)
    a = rng.standard_normal((m, k)).astype(np.float32)
    b = rng.standard_normal((k, n)).astype(np.float32)
    ja, jb, js = jq.quantize_matmul_operands(jnp.asarray(a), jnp.asarray(b))
    ta, tb, ts = (torch.from_numpy(np.array(v)) for v in (ja, jb, js))
    if tiles is None:
        want = jops.matmul_q(ja, jb, js, ctx=J_CTX, out_dtype=jo)
    else:
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", DeprecationWarning)
            want = jquant.matmul_q(ja, jb, js, tiles=tiles, out_dtype=jo)
    xla = jops.matmul_q(ja, jb, js, ctx=J_XLA, out_dtype=jo)
    got = tops.matmul_q(ta, tb, ts, ctx=CPU, out_dtype=to) if tiles is None \
        else matmul_q(ta, tb, ts, out_dtype=to, tiles=tiles)
    assert got.dtype == to and got.shape == (m, n)
    np.testing.assert_array_equal(_np(got), _jnp(want))
    np.testing.assert_array_equal(_np(got), _jnp(xla))


def test_plain_versions_are_exact_integer_sums():
    """The plain versions sum in float64: equal to an int64 convolution /
    product, cast to f32 once, times the scale."""
    g = torch.Generator().manual_seed(0)
    x = torch.randint(-127, 128, (2, 5, 9, 8), generator=g, dtype=torch.int8)
    w = torch.randint(-127, 128, (6, 5, 3, 2), generator=g, dtype=torch.int8)
    s = torch.rand((1, 6), generator=g)
    exact = torch.nn.functional.conv2d(x.double(), w.double(), stride=(2, 1))
    assert (exact == exact.round()).all()
    want = (exact.float() * s[0][None, :, None, None])
    torch.testing.assert_close(conv2d_q_plain(x, w, s, (2, 1), torch.float32),
                               want, rtol=0, atol=0)
    a = torch.randint(-127, 128, (9, 40), generator=g, dtype=torch.int8)
    b = torch.randint(-127, 128, (40, 7), generator=g, dtype=torch.int8)
    s = torch.rand((1, 7), generator=g)
    exact = (a.long() @ b.long()).float() * s
    torch.testing.assert_close(matmul_q_plain(a, b, s, torch.float32), exact,
                               rtol=0, atol=0)


def test_int8_ops_reject_other_dtypes_and_shapes():
    x = torch.zeros((1, 2, 5, 5), dtype=torch.int8)
    w = torch.zeros((3, 2, 3, 3), dtype=torch.int8)
    with pytest.raises(TypeError, match="int8"):
        conv2d_q(x.float(), w, torch.ones(1, 3))
    with pytest.raises(ValueError, match="scale must be"):
        conv2d_q(x, w, torch.ones(3))
    with pytest.raises(ValueError, match="scale must be"):
        matmul_q(torch.zeros((4, 5), dtype=torch.int8),
                 torch.zeros((5, 6), dtype=torch.int8), torch.ones(1, 5))
    # the cuda entry declares int8 only; on the card a float call raises
    d = tops.explain("conv2d_q", CPU, dtype=torch.float32,
                     spec_args=(x.float(), w.float(), torch.ones(1, 3)))
    assert d.chosen == "torch" and d.missing == ("dtype:float32",)


def test_cuda_tensor_never_takes_the_plain_version():
    meta = lambda *s: torch.empty(s, dtype=torch.int8, device="meta")
    before = {n: k.launches for n, k in KERNELS.items()}
    with pytest.raises(ValueError, match="CUDA device"):
        conv2d_q(meta(2, 4, 9, 9), meta(8, 4, 3, 3),
                 torch.ones((1, 8), device="meta"))
    with pytest.raises(ValueError, match="CUDA device"):
        matmul_q(meta(4, 8), meta(8, 4), torch.ones((1, 4), device="meta"))
    assert {n: k.launches for n, k in KERNELS.items()} == before


# -- counters, plans and explain: exactly equal ------------------------------

def _meta(shape, dtype=torch.int8):
    return torch.empty(shape, dtype=dtype, device="meta")


def _sds(shape, dtype=jnp.int8):
    return jax.ShapeDtypeStruct(shape, dtype)


def _resnet_convs():
    out = []
    for name, s in resnet50_layers(1000).items():
        H = (s.h_O - 1) * s.sh + s.h_F
        W = (s.w_O - 1) * s.sw + s.w_F
        out.append(((s.N, s.c_I, H, W), (s.c_O, s.c_I, s.h_F, s.w_F),
                    (s.sh, s.sw), None))
    return out


WORD_CONVS = _resnet_convs() + [
    ((2, 4, 25, 25), (8, 4, 3, 3), (2, 1), (1, 4, 8, 23, 4)),
    ((3, 5, 11, 13), (7, 5, 3, 5), (1, 2), (2, 3, 4)),
]
# (m, k, n): the reference's own GEMM shapes (scripts/verify.py) and the
# Im2Col GEMM of conv5_x at batch 1000
GEMMS = [(512, 384, 256), (2048, 2048, 2048), (49000, 4608, 512)]


@pytest.mark.parametrize("target", TARGETS)
@pytest.mark.parametrize("out", sorted(OUT))
def test_int8_word_counters_equal(target, out):
    tt, jt = getattr(tp, target), _jt(target)
    jo, to = OUT[out]
    for xs, ws, stride, tiles in WORD_CONVS:
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", DeprecationWarning)
            want = jquant.conv2d_q_hbm_words(
                _sds(xs), _sds(ws), stride=stride, tiles=tiles, target=jt,
                out_dtype=jo)
        assert conv2d_q_hbm_words(_meta(xs), _meta(ws), stride=stride,
                                  tiles=tiles, target=tt,
                                  out_dtype=to) == want
    for (m, k, n) in GEMMS + [(130, 129, 257)]:
        for tiles in (None, (32, 48, 16)):
            with warnings.catch_warnings():
                warnings.simplefilter("ignore", DeprecationWarning)
                want = jquant.matmul_q_hbm_words(
                    _sds((m, k)), _sds((k, n)), tiles=tiles, target=jt,
                    out_dtype=jo)
            assert matmul_q_hbm_words(_meta((m, k)), _meta((k, n)),
                                      tiles=tiles, target=tt,
                                      out_dtype=to) == want


def _int8_specs():
    """The int8 ConvSpecs of the five layers and MatmulSpecs of the GEMMs,
    as (name, reference spec, port spec), int8 in, bf16 out."""
    out = []
    for name, s in resnet50_layers(1000).items():
        f = dict(N=s.N, c_I=s.c_I, c_O=s.c_O, w_O=s.w_O, h_O=s.h_O,
                 w_F=s.w_F, h_F=s.h_F, sw=s.sw, sh=s.sh)
        out.append((name, jp.ConvSpec(**f, prec=JPrecision(.25, .25, .5)),
                    tp.ConvSpec(**f, prec=Precision(.25, .25, .5))))
    for m, k, n in GEMMS:
        out.append((f"gemm{m}x{k}x{n}",
                    jp.MatmulSpec(m, n, k, JPrecision(.25, .25, .5)),
                    tp.MatmulSpec(m, n, k, Precision(.25, .25, .5))))
    return out


@pytest.mark.parametrize("target", TARGETS)
def test_int8_plans_equal(target):
    jt, tt = _jt(target), getattr(tp, target)
    for name, jop, top in _int8_specs():
        jplan, tplan = jp.Planner(jt).plan(jop), tp.Planner(tt).plan(top)
        assert tplan.tiles == jplan.tiles, name
        assert tplan.dtypes == jplan.dtypes, name
        assert tplan.lower_bound == jplan.lower_bound, name
        assert tplan.comm_volume == jplan.comm_volume, name


def test_explain_conv2d_q_and_matmul_q_equal():
    jctx = jops.ExecutionContext(target=J_H100, backend="pallas")
    ctx = tops.ExecutionContext(target=tp.H100, backend="cuda", device="cpu")
    for xs, ws, stride, _ in WORD_CONVS[:5]:
        for jo, to in OUT.values():
            sc = (1, ws[0])
            want = jops.explain("conv2d_q", jctx, dtype="int8",
                                spec_args=(_sds(xs), _sds(ws),
                                           _sds(sc, jnp.float32)),
                                spec_kw={"stride": stride, "out_dtype": jo})
            got = tops.explain("conv2d_q", ctx, dtype=torch.int8,
                               spec_args=(_meta(xs), _meta(ws),
                                          _meta(sc, torch.float32)),
                               spec_kw={"stride": stride, "out_dtype": to})
            assert got.chosen == "cuda" and not got.fell_back
            assert got.measured_words == want.measured_words
            assert got.bound_ratio == want.bound_ratio
            assert got.plan.tiles == want.plan.tiles
    for m, k, n in GEMMS:
        want = jops.explain("matmul_q", jctx, dtype="int8",
                            spec_args=(_sds((m, k)), _sds((k, n)),
                                       _sds((1, n), jnp.float32)))
        got = tops.explain("matmul_q", ctx, dtype=torch.int8,
                           spec_args=(_meta((m, k)), _meta((k, n)),
                                      _meta((1, n), torch.float32)),
                           spec_kw={"out_dtype": torch.bfloat16})
        assert got.measured_words == want.measured_words
        assert got.bound_ratio == want.bound_ratio


# -- launch configurations of the H100 int8 plans ----------------------------

def test_int8_launch_configs_fit_the_card():
    """Every int8 H100 plan of the main path launches: its accumulator tile
    (up to 32,768 int32 values) is held by at most 512 threads x 64
    registers (both kernels: 16 warps of m16n8 tiles on the tensor cores)
    and its stages fit a block's shared memory; a plan for the TPU's VMEM
    is refused, not run."""
    seen = set()
    for name, _, top in _int8_specs():
        tiles = tp.Planner(tp.H100).plan(top).tiles
        if isinstance(top, tp.ConvSpec):
            bN, b_cI, b_cO, bh, bw = tiles
            h_in = (bh - 1) * top.sh + top.h_F
            w_in = (bw - 1) * top.sw + top.w_F
            hw = ((top.h_O - 1) * top.sh + top.h_F,
                  (top.w_O - 1) * top.sw + top.w_F)
            cfg = conv_launch_config(tiles, top.h_F, top.w_F, h_in, w_in,
                                     top.c_I, hw)
            rows, cols = bN * bh * bw, b_cO
            assert cfg["n32"] * 32 >= cfg["ks"], name
        else:
            bm, bn, bk = tiles
            cfg = matmul_launch_config(bm, bn, bk)
            rows, cols = bm, bn
            assert cfg["ks"] % 32 == 0 and cfg["ks"] >= bk, name
        held = cfg["acc_per_thread"]
        assert cfg["kernel"] == "tensor core", name
        assert cfg["rows"] >= rows and cfg["cols"] >= cols, name
        assert cfg["threads"] <= 512 and cfg["smem"] <= 232448, name
        assert held <= 64 and cfg["threads"] * 64 >= rows * cols, name
        seen.add(rows * cols)
    assert max(seen) == 32768  # twice the bf16 kernels' 16,384
    with pytest.raises(ValueError, match="accumulator tile"):
        conv_launch_config((64, 8, 512, 7, 7), 3, 3, 9, 9)
    with pytest.raises(ValueError, match="accumulator tile"):
        matmul_launch_config(512, 512, 16)
    with pytest.raises(ValueError, match="shared memory"):
        matmul_launch_config(8, 8, 200000)


# -- the CUDA side, where it can run -----------------------------------------

@pytest.mark.cuda
def test_int8_kernels_on_the_card():
    """Both int8 kernels against their plain versions on the card (runs only
    where there is a GPU; chip_smoke.py checks the main-path shapes)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: CUDA kernels have no CPU mode")
    cases = {**CONV_CASES, **TC_CONV_CASES}
    for case in sorted(cases):
        N, cI, cO, H, W, hF, wF, sh, sw, tiles = cases[case]
        _, (tx, tw, ts) = _conv_operands(3, (N, cI, H, W), (cO, cI, hF, wF))
        tx, tw, ts = tx.cuda(), tw.cuda(), ts.cuda()
        for to in (torch.float32, torch.bfloat16):
            got = conv2d_q(tx, tw, ts, (sh, sw), out_dtype=to, tiles=tiles)
            torch.cuda.synchronize()
            want = conv2d_q_plain(tx, tw, ts, (sh, sw), to)
            torch.testing.assert_close(got, want, rtol=0, atol=0)
    g = torch.Generator(device="cuda").manual_seed(0)
    for (m, k, n), tiles in (((130, 129, 257), None),
                             ((130, 129, 257), (32, 48, 16)),
                             ((512, 384, 256), None),
                             # a main-path tile, k ragged against its span
                             ((64, 4592, 512), (128, 256, 16)),
                             ((3, 300, 256), (1, 256, 16)),  # bm = 1
                             # narrow plans, cut into CTA shares
                             ((1, 4096, 4096), None), ((16, 4096, 2048), None),
                             ((2048, 4096, 16), None)):
        a = torch.randint(-127, 128, (m, k), generator=g, device="cuda",
                          dtype=torch.int8)
        b = torch.randint(-127, 128, (k, n), generator=g, device="cuda",
                          dtype=torch.int8)
        s = torch.rand((1, n), generator=g, device="cuda")
        for to in (torch.float32, torch.bfloat16):
            got = matmul_q(a, b, s, out_dtype=to, tiles=tiles)
            torch.cuda.synchronize()
            torch.testing.assert_close(got, matmul_q_plain(a, b, s, to),
                                       rtol=0, atol=0)
    assert KERNELS["conv2d_q"].launches > 0 < KERNELS["matmul_q"].launches
    # every int8 conv and GEMM runs on the tensor cores
    for k in (KERNELS["conv2d_q"], KERNELS["matmul_q"]):
        assert k.tensor_core_launches == k.launches
