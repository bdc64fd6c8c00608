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
kernels of ``csrc/quant.cu`` (int32 accumulators in registers, up to 512
threads a CTA): the conv multiplies with ``__dp4a`` on the CUDA cores, the
GEMM on the int8 tensor cores (``mma.sync`` m16n8k32 s8 fed by ``ldmatrix``
from a ``cp.async`` ring, B transposed k-major in shared memory; see
:func:`matmul_launch_config` and :func:`matmul_q_tc_emulate`, its model).
On a CPU tensor they run :func:`conv2d_q_plain` / :func:`matmul_q_plain`,
the same functions in plain PyTorch. There is no fallback between the two.

Output storage defaults to bf16 (half a word): int8-in/bf16-out is the policy
``repro_torch.quant.INT8_SPEC`` names, and it is what moves measured conv
words well below the bf16-in/f32-out baseline on the ResNet-50 shapes.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.conv_model import Precision, round_up
from repro_torch.plan import ConvSpec, ExecutionPlan, HardwareTarget, MatmulSpec
from repro_torch.plan.planner import resolve_kernel_plan

from ._build import (ACC_PER_THREAD, MAX_SMEM_BYTES, MAX_THREADS_Q,
                     CudaKernel, check_cuda_operands, check_smem, dtype_code,
                     micro_tile)
from .conv2d import _launch_geometry, _normalize_tiles
from .matmul import vector_width, warp_layout, warp_tiles

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
    _c.POINTER(_c.c_longlong), _c.c_int,                 # geometry, its length
    _c.c_int, _c.c_int, _c.c_void_p,                     # threads, smem, stream
])
# The launch geometry matmul_q's C entry takes, in csrc/quant.cu's
# MMQParams order.
GEOMETRY = ("m", "n", "k", "bm", "bn", "cbm", "cbn", "sm", "sn", "nMT", "nNT",
            "n_spans", "ldo", "wn", "cn", "rows", "bt", "ks", "lda", "ldbs",
            "ldbt", "vwa", "vwb", "off_bs", "off_bt", "off_sc")
# conv2d_q's (CO_T, P_T) micro-tiles, in csrc/quant.cu's conv_launch_v order
CONV_MICRO_TILES = ((8, 8), (4, 16), (16, 4), (2, 32), (1, 64))
# matmul_q's warp blocks of (MI, NI) m16n8 tiles, in mm_launch_v's order:
# (2, 8) is a 32 x 64 warp tile (64 int32 accumulators a thread), a 4 x 4
# grid of 16 warps on the (128, 256) plan and 8 x 2 on (256, 128); variant
# LINEAR gives each warp 16 tiles in row-major order of the covered tile,
# for a tile (1024 x 32) that no (2, 8) grid of 16 warps covers
TC_VARIANTS = ((2, 8),)
LINEAR = len(TC_VARIANTS)
TC_SPANS = (128, 64, 32)  # a ring stage's k-span: the first that fits
RING = (3, 2, 2)  # stages of A, of B and of B^T
PAD = 16  # bytes past a stage row: pitches an odd multiple of 16 bytes


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


def matmul_launch_config(bm: int, bn: int, bk: int,
                         k: Optional[int] = None) -> dict:
    """``matmul_q_tc_kernel``'s launch configuration for int8 tiles (bm, bn,
    bk). A CTA computes the plan's (bm, bn) tile, or, where 16 warps or a
    block's shared memory cannot hold it, an equal share of it (``cbm`` x
    ``cbn``; ``sm`` x ``sn`` CTAs a tile, cut along its longer side, as few
    as fit). Then: the warp layout of the CTA's tile (variant, warp grid,
    covered rows x cols; up to 16 warps x 64 int32 accumulators), the
    columns of B staged and transposed (``bt``, the covered columns rounded
    up to 32), the ring (k-span ``ks``, a multiple of 32 and never less than
    bk rounded up to 32; ``RING`` stages of A, B and B^T), the shared-memory
    pitches (bytes; rows of ks + 16 and bt + 16, odd multiples of 16) and
    offsets, then the CTA's scale slice. ``k=None`` sizes the ring for a
    long k; with k given, only the stages its spans use are allocated.
    Raises ValueError for a tile of more accumulators than one CTA's
    registers hold (a plan for another target), or one no ring fits."""
    if bm * bn > MAX_THREADS_Q * ACC_PER_THREAD:
        raise ValueError(
            f"a {bm} x {bn} accumulator tile does not fit one CTA's "
            f"{MAX_THREADS_Q} x {ACC_PER_THREAD} registers; plan for the "
            "H100 target")
    least = round_up(bk, 32)  # a stage holds a plan k-step at least
    spans = [ks for ks in TC_SPANS if ks >= least] or [least]
    along_n = round_up(bn, 32) >= round_up(bm, 16)
    ext, unit = (bn, 32) if along_n else (bm, 16)
    smem, last = None, None
    for parts in range(1, -(-ext // unit) + 1):
        sub = min(ext, round_up(-(-ext // parts), unit))
        if sub == last:
            continue
        last = sub
        cbm, cbn = (bm, sub) if along_n else (sub, bn)
        try:
            lay = warp_layout(cbm, cbn, TC_VARIANTS, max_threads=MAX_THREADS_Q)
        except ValueError:  # more m16n8 tiles than 16 warps hold
            continue
        rows, bt = lay["rows"], round_up(lay["cols"], 32)
        for ks in spans:
            n_spans = None if k is None else -(-k // ks)
            stages = RING if k is None else tuple(min(c, n_spans)
                                                  for c in RING)
            lda = ldbt = ks + PAD
            ldbs = bt + PAD
            off_bs = stages[0] * rows * lda
            off_bt = off_bs + stages[1] * ks * ldbs
            off_sc = off_bt + stages[2] * bt * ldbt
            smem = off_sc + 4 * cbn
            if smem <= MAX_SMEM_BYTES:
                return dict(kernel="tensor core", **lay,
                            threads=lay["wm"] * lay["wn"] * 32, cbm=cbm,
                            cbn=cbn, sm=-(-bm // cbm), sn=-(-bn // cbn),
                            bt=bt, ks=ks, n_spans=n_spans, lda=lda,
                            ldbs=ldbs, ldbt=ldbt, off_bs=off_bs,
                            off_bt=off_bt, off_sc=off_sc, smem=smem,
                            acc_per_thread=lay["mi"] * lay["ni"] * 4)
    raise ValueError(
        f"matmul_q tiles {(bm, bn, bk)} need {smem} bytes of shared memory "
        f"at the least, more than a block's {MAX_SMEM_BYTES}; plan for the "
        "H100 target")


def _matmul_launch(a, b, scale, out_dtype,
                   tiles: Tuple[int, int, int]) -> torch.Tensor:
    check_cuda_operands("matmul_q", a, b)
    _check_scale("matmul_q", scale, a)
    m, k = a.shape
    n = b.shape[1]
    bm, bn, bk = tiles
    mp, np_ = round_up(m, bm), round_up(n, bn)
    cfg = matmul_launch_config(bm, bn, bk, k)
    out = torch.empty((mp, np_), dtype=out_dtype, device=a.device)
    g = dict(m=m, n=n, k=k, bm=bm, bn=bn, nMT=mp // bm * cfg["sm"],
             nNT=np_ // bn * cfg["sn"], ldo=np_, cn=cfg["cols"] // 8,
             vwa=vector_width(k, ptrs=(a.data_ptr(),), itemsize=1),
             vwb=vector_width(n, bn, cfg["cbn"], ptrs=(b.data_ptr(),),
                              itemsize=1),
             **{key: cfg[key] for key in GEOMETRY if key in cfg})
    geometry = (ctypes.c_longlong * len(GEOMETRY))(*(g[key]
                                                     for key in GEOMETRY))
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        MATMUL_KERNEL.launch(
            a.data_ptr(), b.data_ptr(), scale.data_ptr(), out.data_ptr(),
            dtype_code(out_dtype), cfg["variant"], geometry, len(GEOMETRY),
            cfg["threads"], cfg["smem"], stream, tensor_core=True)
    return out[:m, :n]


def _byte_perm(x: np.ndarray, y: np.ndarray, sel: int) -> np.ndarray:
    """CUDA's ``__byte_perm(x, y, sel)`` on uint32 arrays: byte i of the
    result is byte ``(sel >> 4 i) & 7`` of the 8 bytes y:x."""
    v = x.astype(np.uint64) | (y.astype(np.uint64) << np.uint64(32))
    out = np.zeros(x.shape, np.uint64)
    for i in range(4):
        src = (sel >> (4 * i)) & 7
        byte = (v >> np.uint64(8 * src)) & np.uint64(0xFF)
        out |= byte << np.uint64(8 * i)
    return out.astype(np.uint32)


def transpose_stage(stage: np.ndarray) -> np.ndarray:
    """The kernel's shared-memory transpose of one B stage, as its lanes do
    it (``transpose_stage`` in ``csrc/quant.cu``): the int8 (ks, bt) stage
    read as 32-bit words, 4 x 4 byte blocks (g, c) loaded in the rotated
    row order, rotated by ``(c % 8) // 2`` bytes, transposed with
    ``__byte_perm`` and stored into rotated n rows. Returns B^T, (bt, ks)
    int8 with k contiguous."""
    ks, bt = stage.shape
    w32 = np.ascontiguousarray(stage).view(np.uint32)  # (ks, bt / 4)
    g, c = np.meshgrid(np.arange(ks // 4), np.arange(bt // 4), indexing="ij")
    sh, rot = (g % 4) & 2, (c % 8) >> 1
    w = [w32[4 * g + ((i + sh) & 3), c] for i in range(4)]
    w = [np.where(sh != 0, w[(i + 2) % 4], w[i]) for i in range(4)]
    r = (8 * rot).astype(np.uint64)
    w = [((x.astype(np.uint64) | (x.astype(np.uint64) << np.uint64(32))) >> r
          ).astype(np.uint32) for x in w]  # __funnelshift_r(x, x, 8 rot)
    u0, u1 = _byte_perm(w[0], w[1], 0x5140), _byte_perm(w[0], w[1], 0x7362)
    u2, u3 = _byte_perm(w[2], w[3], 0x5140), _byte_perm(w[2], w[3], 0x7362)
    t = [_byte_perm(u0, u2, 0x5410), _byte_perm(u0, u2, 0x7632),
         _byte_perm(u1, u3, 0x5410), _byte_perm(u1, u3, 0x7632)]
    out = np.zeros((bt, ks // 4), np.uint32)
    for j in range(4):
        out[4 * c + ((j + rot) & 3), g] = t[j]
    return out.view(np.int8)


def matmul_q_tc_emulate(a: torch.Tensor, b: torch.Tensor,
                        scale: torch.Tensor, out_dtype=torch.bfloat16,
                        tiles: Optional[Tuple[int, int, int]] = None
                        ) -> torch.Tensor:
    """A plain model of ``matmul_q_tc_kernel``'s geometry on the CPU, in
    integer arithmetic (for the tests; nothing on the main path calls it):
    per CTA (a (cbm, cbn) share of a (bm, bn) tile), the ring's k-spans
    zero-filled past m, n and k, B staged (ks, bt) and transposed by
    :func:`transpose_stage`, the k32 slices that hold real k multiplied into
    the m16n8 tiles each warp owns
    (:func:`~repro_torch.kernels.matmul.warp_tiles`), then the epilogue's
    column map: int32 -> f32, times the f32 scale, cast, the CTA's rows and
    columns within its tile stored into the padded output."""
    m, k = a.shape
    n = b.shape[1]
    if tiles is None:
        tiles = resolve_kernel_plan(
            _matmul_spec_q(m, n, k, a.dtype, b.dtype, out_dtype))
    bm, bn, bk = tiles
    cfg = matmul_launch_config(bm, bn, bk, k)
    ks, rows, bt = cfg["ks"], cfg["rows"], cfg["bt"]
    owned = [t for w in range(cfg["wm"] * cfg["wn"])
             for t in warp_tiles(cfg, w)]
    an, bn_ = a.numpy(), b.numpy()
    mp, np_ = round_up(m, bm), round_up(n, bn)
    sc = np.zeros(np_, np.float32)
    sc[:n] = scale.float().numpy().reshape(-1)
    out = np.zeros((mp, np_), np.float32)

    def ctas(total, tile, share):  # (origin, extent stored) of each CTA
        return [(t + s, min(share, tile - s)) for t in range(0, total, tile)
                for s in range(0, tile, share)]

    for row0, rl in ctas(mp, bm, cfg["cbm"]):
        rv = max(0, min(rl, m - row0))
        for col0, cl in ctas(np_, bn, cfg["cbn"]):
            nv = max(0, min(cl, n - col0))
            acc = np.zeros((rows, cfg["cols"]), np.int64)
            for k0 in range(0, k, ks):
                kv = min(ks, k - k0)
                a_st = np.zeros((rows, ks), np.int8)
                a_st[:rv, :kv] = an[row0:row0 + rv, k0:k0 + kv]
                b_st = np.zeros((ks, bt), np.int8)
                b_st[:kv, :nv] = bn_[k0:k0 + kv, col0:col0 + nv]
                b_t = transpose_stage(b_st)
                kc = -(-kv // 32) * 32  # the k32 slices that hold real k
                # int8 products summed in float64: exact (|sum| < 2^53)
                prod = (a_st[:, :kc].astype(np.float64)
                        @ b_t[:cfg["cols"], :kc].astype(np.float64).T
                        ).astype(np.int64)
                for mt, nt in owned:
                    blk = (slice(16 * mt, 16 * mt + 16),
                           slice(8 * nt, 8 * nt + 8))
                    acc[blk] += prod[blk]
            assert np.abs(acc).max(initial=0) < 2 ** 31  # int32 registers
            out[row0:row0 + rl, col0:col0 + cl] = (
                acc[:rl, :cl].astype(np.float32) * sc[col0:col0 + cl])
    return torch.from_numpy(out).to(out_dtype)[:m, :n]


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
