"""Communication-optimal direct convolution: the port of
``repro.kernels.conv2d``.

The blocking LP (core.tiling.optimize_blocking, eq. 6 + the §5 buffer model)
picks the (bN, b_cI, b_cO, b_hO, b_wO) tile; the f32 output tile is the
accumulator, held across the c_I reduction; input windows and filter blocks
stream from HBM at their stored width.

Layout: NCHW input, OIHW filter, VALID padding, arbitrary stride — the exact
7NL CNN of §2.1. Spatial tiling is halo-aware: an output row block
[i*bh, (i+1)*bh) reads the overlapping input window starting at row
i*bh*sh of (bh - 1)*sh + h_F rows, and likewise for columns.

On a CUDA tensor, :func:`conv2d` launches the hand-written kernel of
``csrc/conv2d.cu`` (one CTA per output tile, the c_I loop inside the CTA,
accumulator in registers); on a CPU tensor it runs :func:`conv2d_plain`, the
same function in plain PyTorch. There is no fallback between the two.

``conv2d_hbm_words`` reports the HBM words one launch moves, from the same
launch geometry (:func:`_launch_geometry`) the kernel uses: one input halo
window and one filter block per grid step, one output block per tile.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional, Sequence, Tuple

import torch

from repro_torch.core.conv_model import Precision, round_up
from repro_torch.plan import ConvSpec, ExecutionPlan, HardwareTarget
from repro_torch.plan.planner import resolve_kernel_plan

from ._build import (CudaKernel, check_cuda_operands, check_smem, dtype_code,
                     micro_tile)
from .ref import no_tf32

_c = ctypes
KERNEL = CudaKernel("conv2d.cu", "repro_conv2d", [
    _c.c_void_p, _c.c_void_p, _c.c_void_p,                  # x, w, out
    _c.c_int, _c.c_int, _c.c_int,                           # dtypes, variant
    _c.c_longlong, _c.c_int, _c.c_int, _c.c_int,            # N, c_I, H, W
    _c.c_int, _c.c_int, _c.c_int, _c.c_int, _c.c_int,       # c_O, h_F, w_F, sh, sw
    _c.c_int, _c.c_int, _c.c_int, _c.c_int, _c.c_int,       # tiles
    _c.c_int, _c.c_int,                                     # h_in, w_in
    _c.c_int, _c.c_int, _c.c_int,                           # cOp, hOp, wOp
    _c.c_int, _c.c_int, _c.c_int, _c.c_int, _c.c_int,       # grid
    _c.c_int, _c.c_int, _c.c_longlong,                      # nPG, ldW, x_bytes
    _c.c_int, _c.c_int, _c.c_void_p,                        # threads, smem, stream
])
# (CO_T, P_T) micro-tiles compiled into csrc/conv2d.cu, in its variant order
MICRO_TILES = ((8, 8), (4, 16), (16, 4), (2, 32), (1, 64))


def _conv_spec(N: int, c_I: int, c_O: int, h_O: int, w_O: int, h_F: int,
               w_F: int, sh: int, sw: int, in_bits: int) -> ConvSpec:
    p_in = in_bits / 32.0
    return ConvSpec(N=N, c_I=c_I, c_O=c_O, w_O=w_O, h_O=h_O, w_F=w_F, h_F=h_F,
                    sw=sw, sh=sh, prec=Precision(p_in, p_in, 1.0))


def _normalize_tiles(tiles: Sequence[int], h_O: int, w_O: int
                     ) -> Tuple[int, int, int, int, int]:
    """Accept the legacy (bN, b_cI, b_cO) triple (spatial kept whole) or the
    full (bN, b_cI, b_cO, b_hO, b_wO) planner tuple."""
    if len(tiles) == 3:
        return (*tiles, h_O, w_O)
    bN, b_cI, b_cO, bh, bw = tiles
    return (bN, b_cI, b_cO, max(1, min(bh, h_O)), max(1, min(bw, w_O)))


def _launch_geometry(N: int, c_I: int, c_O: int, H: int, W: int, h_F: int,
                     w_F: int, sh: int, sw: int,
                     tiles: Tuple[int, int, int, int, int]):
    """Padded dims, halo-window extents, and grid — the single source of
    truth shared by the kernel launch and the HBM-word counter."""
    bN, b_cI, b_cO, bh, bw = tiles
    h_O = (H - h_F) // sh + 1
    w_O = (W - w_F) // sw + 1
    Np, cIp, cOp = round_up(N, bN), round_up(c_I, b_cI), round_up(c_O, b_cO)
    hOp, wOp = round_up(h_O, bh), round_up(w_O, bw)
    # the last block's halo window reaches this far (zero-filled past H, W)
    Hp = max(H, (hOp - 1) * sh + h_F)
    Wp = max(W, (wOp - 1) * sw + w_F)
    h_in = (bh - 1) * sh + h_F
    w_in = (bw - 1) * sw + w_F
    grid = (Np // bN, cOp // b_cO, hOp // bh, wOp // bw, cIp // b_cI)
    return Np, cIp, cOp, hOp, wOp, Hp, Wp, h_in, w_in, grid


def exact_window(H: int, W: int, h_F: int, w_F: int, sh: int, sw: int
                 ) -> bool:
    """True iff an (H, W) input extent is an *exact* halo window — every row
    and column participates in some VALID output ((H - h_F) % sh == 0 and
    likewise for W)."""
    return (H - h_F) % sh == 0 and (W - w_F) % sw == 0


def conv2d_plain(x: torch.Tensor, w: torch.Tensor,
                 stride: Tuple[int, int] = (1, 1),
                 out_dtype=torch.float32) -> torch.Tensor:
    """The kernel's function in plain PyTorch: for each of the h_F * w_F
    taps, a strided slice of the input times that tap's (c_I, c_O) filter
    matrix, accumulated in f32 (TF32 off)."""
    N, c_I, H, W = x.shape
    c_O, _, h_F, w_F = w.shape
    sh, sw = stride
    h_O = (H - h_F) // sh + 1
    w_O = (W - w_F) // sw + 1
    xf = x.float().permute(0, 2, 3, 1)  # (N, H, W, c_I)
    wf = w.float()
    acc = torch.zeros((N, h_O, w_O, c_O), dtype=torch.float32, device=x.device)
    with no_tf32():
        for hf in range(h_F):
            for wf_ in range(w_F):
                tap = xf[:, hf:hf + (h_O - 1) * sh + 1:sh,
                         wf_:wf_ + (w_O - 1) * sw + 1:sw, :]  # (N,h_O,w_O,c_I)
                acc += torch.matmul(tap, wf[:, :, hf, wf_].t())
    return acc.permute(0, 3, 1, 2).to(out_dtype)


def launch_config(tiles: Tuple[int, int, int, int, int], h_F: int, w_F: int,
                  h_in: int, w_in: int, itemsize: int) -> dict:
    """The kernel's launch configuration for conv tiles: micro-tile variant,
    thread grid, shared-memory layout and bytes (one input window + one
    filter block; a single stage)."""
    bN, b_cI, b_cO, bh, bw = tiles
    variant, co_t, _, n_cg, n_pg = micro_tile(b_cO, bN * bh * bw,
                                              MICRO_TILES)
    ldw = n_cg * co_t + max(1, 4 // itemsize)  # odd word stride for stores
    x_bytes = round_up(bN * b_cI * h_in * w_in * itemsize, 16)
    smem = x_bytes + b_cI * h_F * w_F * ldw * itemsize
    check_smem(smem, f"conv2d tiles {tiles}")
    return dict(variant=variant, n_pg=n_pg, threads=n_cg * n_pg, ldw=ldw,
                x_bytes=x_bytes, smem=smem)


def _launch(x: torch.Tensor, w: torch.Tensor, stride, out_dtype,
            t: Tuple[int, int, int, int, int]) -> torch.Tensor:
    check_cuda_operands("conv2d", x, w)
    N, c_I, H, W = x.shape
    c_O, _, h_F, w_F = w.shape
    sh, sw = stride
    h_O = (H - h_F) // sh + 1
    w_O = (W - w_F) // sw + 1
    bN, b_cI, b_cO, bh, bw = t
    (Np, _, cOp, hOp, wOp, _, _, h_in, w_in,
     grid) = _launch_geometry(N, c_I, c_O, H, W, h_F, w_F, sh, sw, t)
    cfg = launch_config(t, h_F, w_F, h_in, w_in, x.element_size())
    out = torch.empty((Np, cOp, hOp, wOp), dtype=out_dtype, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        KERNEL.launch(
            x.data_ptr(), w.data_ptr(), out.data_ptr(), dtype_code(x.dtype),
            dtype_code(out_dtype), cfg["variant"], N, c_I, H, W, c_O, h_F,
            w_F, sh, sw, bN, b_cI, b_cO, bh, bw, h_in, w_in, cOp, hOp, wOp,
            *grid, cfg["n_pg"], cfg["ldw"], cfg["x_bytes"], cfg["threads"],
            cfg["smem"], stream)
    return out[:N, :c_O, :h_O, :w_O]


def conv2d(
    x: torch.Tensor,  # (N, c_I, H, W)
    w: torch.Tensor,  # (c_O, c_I, h_F, w_F)
    stride: Tuple[int, int] = (1, 1),
    out_dtype=torch.float32,
    ctx=None,  # ExecutionContext (duck-typed: .target/.autotune)
    tiles: Optional[Sequence[int]] = None,
    plan: Optional[ExecutionPlan] = None,
) -> torch.Tensor:
    """Direct convolution with paper-LP tiling. VALID padding.

    Tiles come from (in priority order) an explicit ``tiles`` tuple —
    (bN, b_cI, b_cO) or (bN, b_cI, b_cO, b_hO, b_wO) — an explicit ``plan``
    (the dispatcher's handoff), or a fresh plan for the context's target
    (default ``H100``). CUDA tensors run the kernel; CPU tensors run
    :func:`conv2d_plain`."""
    N, c_I, H, W = x.shape
    c_O, c_I2, h_F, w_F = w.shape
    if c_I != c_I2:
        raise ValueError(f"input has {c_I} channels, filter {c_I2}")
    sh, sw = stride
    h_O = (H - h_F) // sh + 1
    w_O = (W - w_F) // sw + 1
    t = resolve_kernel_plan(
        _conv_spec(N, c_I, c_O, h_O, w_O, h_F, w_F, sh, sw,
                   x.dtype.itemsize * 8),
        plan=plan, tiles=tiles, ctx=ctx)
    t = _normalize_tiles(t, h_O, w_O)
    if x.device.type == "cpu" and w.device.type == "cpu":
        return conv2d_plain(x, w, stride, out_dtype)
    return _launch(x, w, (sh, sw), out_dtype, t)


def conv2d_hbm_words(
    x,  # tensor (meta tensors work), (N, c_I, H, W)
    w,  # tensor, (c_O, c_I, h_F, w_F)
    stride: Tuple[int, int] = (1, 1),
    tiles: Optional[Sequence[int]] = None,
    plan: Optional[ExecutionPlan] = None,
    target: Optional[HardwareTarget] = None,
    out_dtype=torch.float32,
) -> float:
    """Measured HBM words (32-bit) one ``conv2d`` launch moves: one input
    halo window + one filter block per grid step, one output block per
    (n, co, h, w) tile — padding included. Only shapes/dtypes are
    consulted."""
    N, c_I, H, W = x.shape
    c_O, _, h_F, w_F = w.shape
    sh, sw = stride
    h_O = (H - h_F) // sh + 1
    w_O = (W - w_F) // sw + 1
    t = resolve_kernel_plan(
        _conv_spec(N, c_I, c_O, h_O, w_O, h_F, w_F, sh, sw,
                   x.dtype.itemsize * 8),
        plan=plan, target=target, tiles=tiles)
    t = _normalize_tiles(t, h_O, w_O)
    bN, b_cI, b_cO, bh, bw = t
    (Np, cIp, cOp, hOp, wOp, _, _, h_in, w_in,
     grid) = _launch_geometry(N, c_I, c_O, H, W, h_F, w_F, sh, sw, t)
    n_steps = math.prod(grid)
    p_in = x.dtype.itemsize / 4.0
    p_flt = w.dtype.itemsize / 4.0
    p_out = out_dtype.itemsize / 4.0
    return (n_steps * bN * b_cI * h_in * w_in * p_in
            + n_steps * b_cO * b_cI * h_F * w_F * p_flt
            + Np * cOp * hOp * wOp * p_out)
