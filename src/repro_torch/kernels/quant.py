"""Quantized (int8-stream) conv2d / matmul: the port of
``repro.kernels.quant``.

Same LP-tiled launch geometry as ``kernels/conv2d.py`` / ``kernels/matmul.py``
(the geometry helpers are imported, not restated), but the input and filter
stream from HBM as int8 — a quarter word per element — so the blocking LP,
solving against ``Precision(0.25, 0.25, p_out)``, buys bigger tiles from the
same fast memory and the Thm 2.1 bound itself drops (see
``core.bounds.mixed_precision_bound``). The folded per-output-channel scale
— one f32 vector, quantization's whole dequantization state — is applied
once at the store:

    out[n, co, h, w] = (sum_taps int8 dot) * scale[co]  ->  out_dtype

``scale`` is ``s_x * s_w[c_O]`` (``repro_torch.quant.quantize_conv_operands``),
a ``(1, c_O)`` f32 operand. The counters charge it c_O words, once per
launch, as the reference does.

On a CUDA tensor, :func:`conv2d_q` / :func:`matmul_q` launch the hand-written
kernels of ``csrc/quant.cu`` (int32 accumulators in registers, ``__dp4a``
products, up to 512 threads a CTA); on a CPU tensor they run
:func:`conv2d_q_plain` / :func:`matmul_q_plain`, the same functions in plain
PyTorch. There is no fallback between the two.

Output storage defaults to bf16 (half a word): int8-in/bf16-out is the policy
``repro_torch.quant.INT8_SPEC`` names, and it is what moves measured conv
words well below the bf16-in/f32-out baseline on the ResNet-50 shapes.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional, Sequence, Tuple

import torch

from repro_torch.core.conv_model import Precision, round_up
from repro_torch.plan import ConvSpec, ExecutionPlan, HardwareTarget, MatmulSpec
from repro_torch.plan.planner import resolve_kernel_plan

from ._build import (MAX_THREADS_Q, CudaKernel, check_cuda_operands,
                     check_smem, dtype_code, micro_tile)
from .conv2d import _launch_geometry, _normalize_tiles

_c = ctypes
CONV_KERNEL = CudaKernel("quant.cu", "repro_conv2d_q", [
    _c.c_void_p, _c.c_void_p, _c.c_void_p, _c.c_void_p,  # x, w, scale, out
    _c.c_int, _c.c_int,                                  # out dtype, variant
    _c.c_longlong, _c.c_int, _c.c_int, _c.c_int,         # N, c_I, H, W
    _c.c_int, _c.c_int, _c.c_int, _c.c_int, _c.c_int,    # c_O, h_F, w_F, sh, sw
    _c.c_int, _c.c_int, _c.c_int, _c.c_int, _c.c_int,    # tiles
    _c.c_int, _c.c_int,                                  # h_in, w_in
    _c.c_int, _c.c_int, _c.c_int,                        # cOp, hOp, wOp
    _c.c_int, _c.c_int, _c.c_int, _c.c_int, _c.c_int,    # grid
    _c.c_int, _c.c_int, _c.c_int, _c.c_int,              # nPG, ldW, x/w bytes
    _c.c_int, _c.c_int, _c.c_void_p,                     # threads, smem, stream
])
MATMUL_KERNEL = CudaKernel("quant.cu", "repro_matmul_q", [
    _c.c_void_p, _c.c_void_p, _c.c_void_p, _c.c_void_p,  # a, b, scale, out
    _c.c_int, _c.c_int,                                  # out dtype, variant
    _c.c_longlong, _c.c_int, _c.c_int,                   # m, n, k
    _c.c_int, _c.c_int, _c.c_int,                        # bm, bn, bk
    _c.c_longlong, _c.c_int, _c.c_int,                   # nMT, nNT, nKT
    _c.c_longlong, _c.c_int, _c.c_int, _c.c_int,         # ldo, nRG, ldA, ldB
    _c.c_int, _c.c_int,                                  # a/b bytes
    _c.c_int, _c.c_int, _c.c_void_p,                     # threads, smem, stream
])
# micro-tiles compiled into csrc/quant.cu, in its variant order:
# (CO_T, P_T) for conv2d_q, (TM, TN) for matmul_q
CONV_MICRO_TILES = ((8, 8), (4, 16), (16, 4), (2, 32), (1, 64))
MATMUL_MICRO_TILES = ((8, 8), (16, 4), (4, 16), (32, 2), (64, 1))


def _wordwidth(dtype) -> float:
    return dtype.itemsize / 4.0


def _conv_spec_q(N: int, c_I: int, c_O: int, h_O: int, w_O: int, h_F: int,
                 w_F: int, sh: int, sw: int, x_dtype, w_dtype,
                 out_dtype) -> ConvSpec:
    """Per-operand mixed-precision ConvSpec: the LP and the Thm 2.1 bound
    both see the stored widths (int8 = 0.25 words), unlike ``_conv_spec``
    which pins p_O to one full word."""
    return ConvSpec(N=N, c_I=c_I, c_O=c_O, w_O=w_O, h_O=h_O, w_F=w_F,
                    h_F=h_F, sw=sw, sh=sh,
                    prec=Precision(_wordwidth(x_dtype), _wordwidth(w_dtype),
                                   _wordwidth(out_dtype)))


def _matmul_spec_q(m: int, n: int, k: int, a_dtype, b_dtype,
                   out_dtype) -> MatmulSpec:
    return MatmulSpec(m=m, n=n, k=k,
                      prec=Precision(_wordwidth(a_dtype),
                                     _wordwidth(b_dtype),
                                     _wordwidth(out_dtype)))


def _check_int8(op: str, *tensors) -> None:
    for t in tensors:
        if t.dtype != torch.int8:
            raise TypeError(f"{op} takes int8 operands, got {t.dtype}")


def _check_scale(op: str, scale: torch.Tensor, like: torch.Tensor) -> None:
    """The f32 scale goes to C beside the int8 operands: on their device,
    contiguous."""
    check_cuda_operands(op, scale)
    if scale.device != like.device:
        raise ValueError(f"{op}: the scale lies on {scale.device}, the "
                         f"operands on {like.device}")


# ---------------------------------------------------------------------------
# conv2d_q
# ---------------------------------------------------------------------------

def conv2d_q_plain(x: torch.Tensor, w: torch.Tensor, scale: torch.Tensor,
                   stride: Tuple[int, int] = (1, 1),
                   out_dtype=torch.bfloat16) -> torch.Tensor:
    """The kernel's function in plain PyTorch: the int8 operands widened to
    float64 (every sum is exact), tap by tap as strided-slice matmuls, the
    sum cast to f32, times the f32 scale in f32, cast to ``out_dtype``."""
    N, c_I, H, W = x.shape
    c_O, _, h_F, w_F = w.shape
    sh, sw = stride
    h_O = (H - h_F) // sh + 1
    w_O = (W - w_F) // sw + 1
    xd = x.double().permute(0, 2, 3, 1)  # (N, H, W, c_I)
    wd = w.double()
    acc = torch.zeros((N, h_O, w_O, c_O), dtype=torch.float64,
                      device=x.device)
    for hf in range(h_F):
        for wf in range(w_F):
            tap = xd[:, hf:hf + (h_O - 1) * sh + 1:sh,
                     wf:wf + (w_O - 1) * sw + 1:sw, :]
            acc += torch.matmul(tap, wd[:, :, hf, wf].t())
    out = acc.float() * scale.float().reshape(1, 1, 1, c_O)
    return out.permute(0, 3, 1, 2).to(out_dtype)


def conv_launch_config(tiles: Tuple[int, int, int, int, int], h_F: int,
                       w_F: int, h_in: int, w_in: int) -> dict:
    """The conv kernel's launch configuration for int8 tiles: micro-tile
    variant, thread grid (up to 512 threads x 64 int32 accumulators), and
    the shared-memory layout (input window and filter block as words of
    four channels, then the tile's scale slice)."""
    bN, b_cI, b_cO, bh, bw = tiles
    variant, co_t, _, n_cg, n_pg = micro_tile(
        b_cO, bN * bh * bw, CONV_MICRO_TILES, MAX_THREADS_Q)
    ci4 = -(-b_cI // 4)
    ldw = n_cg * co_t + 1  # odd word stride: conflict-free stores
    x_bytes = round_up(bN * ci4 * h_in * w_in * 4, 16)
    w_bytes = ci4 * h_F * w_F * ldw * 4
    smem = x_bytes + w_bytes + b_cO * 4
    check_smem(smem, f"conv2d_q tiles {tiles}")
    return dict(variant=variant, n_pg=n_pg, threads=n_cg * n_pg, ldw=ldw,
                x_bytes=x_bytes, w_bytes=w_bytes, smem=smem)


def _conv_launch(x, w, scale, stride, out_dtype,
                 t: Tuple[int, int, int, int, int]) -> torch.Tensor:
    check_cuda_operands("conv2d_q", x, w)
    _check_scale("conv2d_q", scale, x)
    N, c_I, H, W = x.shape
    c_O, _, h_F, w_F = w.shape
    sh, sw = stride
    h_O = (H - h_F) // sh + 1
    w_O = (W - w_F) // sw + 1
    bN, b_cI, b_cO, bh, bw = t
    (Np, _, cOp, hOp, wOp, _, _, h_in, w_in,
     grid) = _launch_geometry(N, c_I, c_O, H, W, h_F, w_F, sh, sw, t)
    cfg = conv_launch_config(t, h_F, w_F, h_in, w_in)
    out = torch.empty((Np, cOp, hOp, wOp), dtype=out_dtype, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        CONV_KERNEL.launch(
            x.data_ptr(), w.data_ptr(), scale.data_ptr(), out.data_ptr(),
            dtype_code(out_dtype), cfg["variant"], N, c_I, H, W, c_O, h_F,
            w_F, sh, sw, bN, b_cI, b_cO, bh, bw, h_in, w_in, cOp, hOp, wOp,
            *grid, cfg["n_pg"], cfg["ldw"], cfg["x_bytes"], cfg["w_bytes"],
            cfg["threads"], cfg["smem"], stream)
    return out[:N, :c_O, :h_O, :w_O]


def conv2d_q(
    x: torch.Tensor,  # (N, c_I, H, W) int8
    w: torch.Tensor,  # (c_O, c_I, h_F, w_F) int8
    scale: torch.Tensor,  # (1, c_O) f32: folded s_x * s_w[c_O]
    stride: Tuple[int, int] = (1, 1),
    out_dtype=torch.bfloat16,
    ctx=None,  # ExecutionContext (duck-typed: .target/.autotune)
    tiles: Optional[Sequence[int]] = None,
    plan: Optional[ExecutionPlan] = None,
) -> torch.Tensor:
    """Quantized direct convolution (VALID padding): int8 operand streams,
    int32 accumulation, one folded per-output-channel scale applied at the
    store. Operands come from
    ``repro_torch.quant.quantize_conv_operands``. CUDA tensors run the
    kernel; CPU tensors run :func:`conv2d_q_plain`."""
    N, c_I, H, W = x.shape
    c_O, c_I2, h_F, w_F = w.shape
    if c_I != c_I2:
        raise ValueError(f"input has {c_I} channels, filter {c_I2}")
    if tuple(scale.shape) != (1, c_O):
        raise ValueError(f"scale must be (1, {c_O}), got "
                         f"{tuple(scale.shape)}")
    _check_int8("conv2d_q", x, w)
    sh, sw = stride
    h_O = (H - h_F) // sh + 1
    w_O = (W - w_F) // sw + 1
    t = resolve_kernel_plan(
        _conv_spec_q(N, c_I, c_O, h_O, w_O, h_F, w_F, sh, sw, x.dtype,
                     w.dtype, out_dtype),
        plan=plan, tiles=tiles, ctx=ctx)
    t = _normalize_tiles(t, h_O, w_O)
    if x.device.type == "cpu" and w.device.type == "cpu":
        return conv2d_q_plain(x, w, scale, (sh, sw), out_dtype)
    return _conv_launch(x, w, scale.float().contiguous(), (sh, sw),
                        out_dtype, t)


def conv2d_q_hbm_words(
    x,  # tensor (meta tensors work), (N, c_I, H, W) int8
    w,  # tensor, (c_O, c_I, h_F, w_F) int8
    scale=None,  # unused beyond its c_O words; keeps the spec_args signature
    stride: Tuple[int, int] = (1, 1),
    tiles: Optional[Sequence[int]] = None,
    plan: Optional[ExecutionPlan] = None,
    target: Optional[HardwareTarget] = None,
    out_dtype=torch.bfloat16,
) -> float:
    """Measured HBM words of one ``conv2d_q`` dispatch: int8 input/filter
    windows per grid step, the padded out_dtype stores, plus the scale
    vector exactly once (c_O f32 words)."""
    N, c_I, H, W = x.shape
    c_O, _, h_F, w_F = w.shape
    sh, sw = stride
    h_O = (H - h_F) // sh + 1
    w_O = (W - w_F) // sw + 1
    t = resolve_kernel_plan(
        _conv_spec_q(N, c_I, c_O, h_O, w_O, h_F, w_F, sh, sw, x.dtype,
                     w.dtype, out_dtype),
        plan=plan, target=target, tiles=tiles)
    t = _normalize_tiles(t, h_O, w_O)
    bN, b_cI, b_cO, bh, bw = t
    (Np, cIp, cOp, hOp, wOp, _, _, h_in, w_in,
     grid) = _launch_geometry(N, c_I, c_O, H, W, h_F, w_F, sh, sw, t)
    n_steps = math.prod(grid)
    p_in = _wordwidth(x.dtype)
    p_flt = _wordwidth(w.dtype)
    p_out = _wordwidth(out_dtype)
    return (n_steps * bN * b_cI * h_in * w_in * p_in
            + n_steps * b_cO * b_cI * h_F * w_F * p_flt
            + Np * cOp * hOp * wOp * p_out
            + cOp * 1.0)


# ---------------------------------------------------------------------------
# matmul_q
# ---------------------------------------------------------------------------

def matmul_q_plain(a: torch.Tensor, b: torch.Tensor, scale: torch.Tensor,
                   out_dtype=torch.bfloat16) -> torch.Tensor:
    """The kernel's function in plain PyTorch: a float64 matmul of the
    widened int8 operands (exact), cast to f32, times the f32 scale in f32,
    cast to ``out_dtype``."""
    acc = torch.matmul(a.double(), b.double())
    return (acc.float() * scale.float().reshape(1, -1)).to(out_dtype)


def matmul_launch_config(bm: int, bn: int, bk: int) -> dict:
    """The GEMM kernel's launch configuration for int8 tiles (bm, bn, bk):
    micro-tile variant, thread grid (up to 512 threads x 64 int32
    accumulators), shared-memory strides and bytes (A and B as words of four
    k, then the tile's scale slice)."""
    variant, tm, tn, n_rg, n_cg = micro_tile(bm, bn, MATMUL_MICRO_TILES,
                                             MAX_THREADS_Q)
    bk4 = -(-bk // 4)
    lda = bm + 1  # odd word stride: conflict-free stores
    ldb = n_cg * tn
    a_bytes = round_up(bk4 * lda * 4, 16)
    b_bytes = bk4 * ldb * 4
    smem = a_bytes + b_bytes + bn * 4
    check_smem(smem, f"matmul_q tiles {(bm, bn, bk)}")
    return dict(variant=variant, n_rg=n_rg, threads=n_rg * n_cg, lda=lda,
                ldb=ldb, a_bytes=a_bytes, b_bytes=b_bytes, smem=smem)


def _matmul_launch(a, b, scale, out_dtype,
                   tiles: Tuple[int, int, int]) -> torch.Tensor:
    check_cuda_operands("matmul_q", a, b)
    _check_scale("matmul_q", scale, a)
    m, k = a.shape
    n = b.shape[1]
    bm, bn, bk = tiles
    mp, np_ = round_up(m, bm), round_up(n, bn)
    cfg = matmul_launch_config(bm, bn, bk)
    out = torch.empty((mp, np_), dtype=out_dtype, device=a.device)
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        MATMUL_KERNEL.launch(
            a.data_ptr(), b.data_ptr(), scale.data_ptr(), out.data_ptr(),
            dtype_code(out_dtype), cfg["variant"], m, n, k, bm, bn, bk,
            mp // bm, np_ // bn, -(-k // bk), np_, cfg["n_rg"], cfg["lda"],
            cfg["ldb"], cfg["a_bytes"], cfg["b_bytes"], cfg["threads"],
            cfg["smem"], stream)
    return out[:m, :n]


def matmul_q(
    a: torch.Tensor,  # (m, k) int8
    b: torch.Tensor,  # (k, n) int8
    scale: torch.Tensor,  # (1, n) f32: folded s_a * s_b[n]
    out_dtype=torch.bfloat16,
    ctx=None,  # ExecutionContext (duck-typed: .target/.autotune)
    tiles: Optional[Tuple[int, int, int]] = None,
    plan: Optional[ExecutionPlan] = None,
) -> torch.Tensor:
    """Quantized GEMM: int8 A/B streams over k, int32 accumulator, folded
    per-column scale applied at the store. Operands come from
    ``repro_torch.quant.quantize_matmul_operands``. CUDA tensors run the
    kernel; CPU tensors run :func:`matmul_q_plain`."""
    m, k = a.shape
    k2, n = b.shape
    if k != k2:
        raise ValueError(f"inner dims mismatch: {k} vs {k2}")
    if tuple(scale.shape) != (1, n):
        raise ValueError(f"scale must be (1, {n}), got {tuple(scale.shape)}")
    _check_int8("matmul_q", a, b)
    t = resolve_kernel_plan(
        _matmul_spec_q(m, n, k, a.dtype, b.dtype, out_dtype),
        plan=plan, tiles=tiles, ctx=ctx)
    if a.device.type == "cpu" and b.device.type == "cpu":
        return matmul_q_plain(a, b, scale, out_dtype)
    return _matmul_launch(a, b, scale.float().contiguous(), out_dtype,
                          tuple(t))


def matmul_q_hbm_words(
    a,  # tensor (meta tensors work), (m, k) int8
    b,  # tensor, (k, n) int8
    scale=None,
    tiles: Optional[Tuple[int, int, int]] = None,
    plan: Optional[ExecutionPlan] = None,
    target: Optional[HardwareTarget] = None,
    out_dtype=torch.bfloat16,
) -> float:
    """Measured HBM words of one ``matmul_q`` dispatch (int8 streams +
    out_dtype stores + the scale vector once)."""
    m, k = a.shape
    n = b.shape[1]
    bm, bn, bk = resolve_kernel_plan(
        _matmul_spec_q(m, n, k, a.dtype, b.dtype, out_dtype),
        plan=plan, target=target, tiles=tiles)
    mp, np_, kp = round_up(m, bm), round_up(n, bn), round_up(k, bk)
    n_steps = (mp // bm) * (np_ // bn) * (kp // bk)
    p_a = _wordwidth(a.dtype)
    p_b = _wordwidth(b.dtype)
    p_out = _wordwidth(out_dtype)
    return (n_steps * (bm * bk * p_a + bk * bn * p_b)
            + mp * np_ * p_out + np_ * 1.0)
