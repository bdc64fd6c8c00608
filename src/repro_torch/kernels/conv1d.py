"""Causal depthwise conv1d (the mamba short convolution): the port of
``repro.kernels.conv1d``.

7NL view: N=B, c_I=c_O=D (depthwise), h=sequence, w_F=K, h_F=1. The blocking
LP degenerates to choosing (b_B, b_D) tiles from the target's alignment; the
sequence axis streams whole per tile (K <= 8).

On a CUDA tensor, :func:`conv1d_causal` launches the hand-written kernel of
``csrc/conv1d.cu`` (one CTA per (b_B, b_D) tile, one thread per (b, d)
walking the sequence with the last K-1 inputs in registers); on a CPU tensor
it runs :func:`conv1d_causal_plain`, the same function in plain PyTorch,
summed in the same order. There is no fallback between the two.

``conv1d_hbm_words`` is the reference's counter, unchanged: the words one
launch moves, from the launch geometry both share (``_conv1d_geometry``).
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.core.conv_model import round_up
from repro_torch.plan import H100, HardwareTarget

from ._build import MAX_THREADS, CudaKernel, check_smem, dtype_code

_c = ctypes
KERNEL = CudaKernel("conv1d.cu", "repro_conv1d_causal", [
    _c.c_void_p, _c.c_void_p, _c.c_void_p,               # x, w, out
    _c.c_int, _c.c_int,                                  # dtype, K
    _c.c_int, _c.c_int, _c.c_int,                        # B, L, D
    _c.c_longlong, _c.c_longlong,                        # x batch/time strides
    _c.c_int, _c.c_int, _c.c_int, _c.c_int,              # bB, bD, nB, nD
    _c.c_int, _c.c_int, _c.c_void_p,                     # threads, smem, stream
])
MAX_TAPS = 8  # K instances compiled into csrc/conv1d.cu


def _conv1d_geometry(x, w, tiles: Optional[Tuple[int, int]],
                     target: Optional[HardwareTarget]):
    """(bB, bD, Bp, Dp, grid) — the launch geometry :func:`conv1d_causal`
    runs, shared with the words counter. ``target`` (default ``H100``) sets
    the tiles' alignment: (min(B, sublane), min(D, lane))."""
    B, L, D = x.shape
    target = target or H100
    bB, bD = tiles or (max(1, min(B, target.align_sublane)),
                       max(1, min(D, target.align_lane)))
    Bp, Dp = round_up(B, bB), round_up(D, bD)
    return bB, bD, Bp, Dp, (Bp // bB, Dp // bD)


def conv1d_hbm_words(
    x,  # tensor (meta tensors work), (B, L, D)
    w,  # tensor, (K, D)
    tiles: Optional[Tuple[int, int]] = None,
    target: Optional[HardwareTarget] = None,
) -> float:
    """Measured HBM words (32-bit) one ``conv1d_causal`` launch moves: one
    padded input block in and one output block out per (i, j) grid step,
    plus the (K, bD) filter block — fetched once per step when the channel
    grid has > 1 column, but only once in total when nD == 1 (the
    reference's Pallas pipeline skips the re-fetch of an unchanged block).
    Shapes/dtypes only."""
    L = x.shape[1]
    K = w.shape[0]
    bB, bD, Bp, Dp, (nB, nD) = _conv1d_geometry(x, w, tiles, target)
    p_x = x.dtype.itemsize / 4.0
    p_w = w.dtype.itemsize / 4.0
    w_fetches = nB * nD if nD > 1 else 1
    return (nB * nD * bB * L * bD * p_x  # input blocks (out dtype = x dtype)
            + w_fetches * K * bD * p_w  # filter blocks
            + nB * nD * bB * L * bD * p_x)  # output stores


def conv1d_causal_plain(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The kernel's function in plain PyTorch, in the kernel's order: tap
    K-1 (the current step) first, then k = 0..K-2, each product and sum
    rounded to f32; out in x's dtype."""
    L, K = x.shape[1], w.shape[0]
    xf, wf = x.float(), w.float()
    acc = xf * wf[K - 1]
    for k in range(K - 1):
        shifted = F.pad(xf, (0, 0, K - 1 - k, 0))[:, :L]
        acc = acc + shifted * wf[k]
    return acc.to(x.dtype)


def launch_config(K: int, bB: int, bD: int) -> dict:
    """Threads and shared-memory bytes of one CTA for a (bB, bD) tile:
    one thread per (b, d) up to ``MAX_THREADS`` (threads stride beyond
    it), the (K, bD) f32 filter block staged in shared memory."""
    if not 1 <= K <= MAX_TAPS:
        raise ValueError(f"conv1d_causal takes 1..{MAX_TAPS} taps, got {K}")
    smem = K * bD * 4
    check_smem(smem, f"conv1d_causal filter block (K {K}, bD {bD})")
    return dict(threads=min(bB * bD, MAX_THREADS), smem=smem)


def _launch(x: torch.Tensor, w: torch.Tensor, bB: int, bD: int,
            grid: Tuple[int, int]) -> torch.Tensor:
    for t in (x, w):
        if t.device.type != "cuda" or t.device != x.device:
            raise ValueError("conv1d_causal: x and w must lie on one CUDA "
                             f"device, got {x.device} and {w.device}")
    if x.dtype != w.dtype:
        raise TypeError(f"conv1d_causal: x is {x.dtype}, w {w.dtype}")
    if x.stride(2) != 1 or not w.is_contiguous():
        raise ValueError("conv1d_causal: x's channel axis and w must be "
                         "contiguous")
    B, L, D = x.shape
    K = w.shape[0]
    nB, nD = grid
    if nB > 65535:
        raise ValueError(f"conv1d_causal: {nB} batch tiles exceed the grid's "
                         "65,535; raise the batch tile")
    cfg = launch_config(K, bB, bD)
    out = torch.empty((B, L, D), dtype=x.dtype, device=x.device)
    if L == 0:
        return out
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        KERNEL.launch(x.data_ptr(), w.data_ptr(), out.data_ptr(),
                      dtype_code(x.dtype), K, B, L, D, x.stride(0),
                      x.stride(1), bB, bD, nB, nD, cfg["threads"],
                      cfg["smem"], stream)
    return out


def conv1d_causal(
    x: torch.Tensor,  # (B, L, D)
    w: torch.Tensor,  # (K, D)
    tiles: Optional[Tuple[int, int]] = None,
    target: Optional[HardwareTarget] = None,
) -> torch.Tensor:
    """Causal depthwise conv1d, f32 accumulation, out in x's dtype.
    ``tiles`` = (bB, bD) overrides the target's (min(B, sublane),
    min(D, lane)). CUDA tensors run the kernel; CPU tensors run
    :func:`conv1d_causal_plain`."""
    if x.ndim != 3 or w.ndim != 2 or w.shape[1] != x.shape[2]:
        raise ValueError(f"x must be (B, L, D) and w (K, D), got "
                         f"{tuple(x.shape)} and {tuple(w.shape)}")
    bB, bD, _, _, grid = _conv1d_geometry(x, w, tiles, target)
    if x.device.type == "cpu" and w.device.type == "cpu":
        return conv1d_causal_plain(x, w)
    return _launch(x, w, bB, bD, grid)
