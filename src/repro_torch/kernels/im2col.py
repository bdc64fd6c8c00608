"""Im2Col baseline convolution: materialized patches -> LP-tiled GEMM. The
port of ``repro.kernels.im2col``.

The algorithm the paper's §5 tiling is measured against (Figs 2-4): lower the
7NL convolution to one big GEMM by materializing the patch matrix

    P[(n, ho, wo), (ci, hf, wf)] = Input[n, ci, ho*sh + hf, wo*sw + wf]

of shape (N*h_O*w_O, c_I*h_F*w_F) — every input element is copied up to
h_F*w_F times — then computing P @ Filter.T with the port's hand-written
``matmul`` kernel (never ``torch.matmul``). The patch expansion is aten
tensor code (its cost is pure data movement, which is what the baseline is
supposed to pay), as it is plain XLA in the reference.

``im2col_hbm_words`` counts the words the baseline moves: read the input,
write the expanded patch matrix, then the GEMM's measured stream/store words.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.plan import HardwareTarget

from .matmul import matmul, matmul_access_plan, matmul_hbm_words


def im2col_patches(x: torch.Tensor, h_F: int, w_F: int,
                   stride: Tuple[int, int]) -> torch.Tensor:
    """(N, c_I, H, W) -> (N*h_O*w_O, c_I*h_F*w_F) patch matrix whose column
    order (ci, hf, wf) matches ``filter.reshape(c_O, -1)``."""
    N, c_I, H, W = x.shape
    sh, sw = stride
    h_O = (H - h_F) // sh + 1
    w_O = (W - w_F) // sw + 1
    # (N, c_I, h_O, w_O, h_F, w_F) strided view, copied once into
    # (N, h_O, w_O, c_I, h_F, w_F) order
    win = x.unfold(2, h_F, sh).unfold(3, w_F, sw)
    p = win.permute(0, 2, 3, 1, 4, 5).contiguous()
    return p.reshape(N * h_O * w_O, c_I * h_F * w_F)


def conv2d_im2col(
    x: torch.Tensor,  # (N, c_I, H, W)
    w: torch.Tensor,  # (c_O, c_I, h_F, w_F)
    stride: Tuple[int, int] = (1, 1),
    out_dtype=torch.float32,
    ctx=None,
) -> torch.Tensor:
    """Im2Col convolution (VALID padding): patches -> LP-tiled GEMM. The
    GEMM's tiles are planned for ``ctx.target`` (default ``H100``)."""
    N, c_I, H, W = x.shape
    c_O, c_I2, h_F, w_F = w.shape
    if c_I != c_I2:
        raise ValueError(f"input has {c_I} channels, filter {c_I2}")
    sh, sw = stride
    h_O = (H - h_F) // sh + 1
    w_O = (W - w_F) // sw + 1
    patches = im2col_patches(x, h_F, w_F, stride)
    wmat = w.reshape(c_O, c_I * h_F * w_F).t().contiguous()  # (k, c_O)
    out = matmul(patches, wmat, out_dtype=out_dtype, ctx=ctx)  # (m, c_O)
    return out.reshape(N, h_O, w_O, c_O).permute(0, 3, 1, 2)


def im2col_hbm_words(
    x,  # tensor (meta tensors work), (N, c_I, H, W)
    w,  # tensor, (c_O, c_I, h_F, w_F)
    stride: Tuple[int, int] = (1, 1),
    target: Optional[HardwareTarget] = None,
    out_dtype=torch.float32,
) -> float:
    """Measured HBM words (32-bit) one ``conv2d_im2col`` dispatch moves:
    patch expansion (read input + write the expanded matrix) plus the GEMM's
    measured words for the tiles its plan resolves. Shapes/dtypes only."""
    N, c_I, H, W = x.shape
    c_O, _, h_F, w_F = w.shape
    sh, sw = stride
    h_O = (H - h_F) // sh + 1
    w_O = (W - w_F) // sw + 1
    m, k = N * h_O * w_O, c_I * h_F * w_F
    p_in = x.dtype.itemsize / 4.0
    expand = p_in * (N * c_I * H * W) + p_in * m * k
    gemm = matmul_hbm_words(
        torch.empty((m, k), dtype=x.dtype, device="meta"),
        torch.empty((k, c_O), dtype=w.dtype, device="meta"),
        target=target, out_dtype=out_dtype)
    return expand + gemm


def im2col_access_plan(
    x,  # tensor (meta tensors work), (N, c_I, H, W)
    w,  # tensor, (c_O, c_I, h_F, w_F)
    stride: Tuple[int, int] = (1, 1),
    target: Optional[HardwareTarget] = None,
    out_dtype=torch.float32,
):
    """The :class:`repro_torch.verify.access.KernelAccessPlan` of one
    ``conv2d_im2col`` dispatch: the hand-written GEMM's CUDA plan over the
    patch matrix (:func:`matmul_access_plan`) prefixed with the aten patch
    expansion as flat traffic (read the input once, write the (m, k) patch
    matrix once), exactly what ``im2col_hbm_words`` charges, and the
    filter's transposed copy into the GEMM's (k, c_O) operand, which it
    does not."""
    import dataclasses as _dc

    from repro_torch.verify.access import FlatAccess

    N, c_I, H, W = x.shape
    c_O, _, h_F, w_F = w.shape
    sh, sw = stride
    h_O = (H - h_F) // sh + 1
    w_O = (W - w_F) // sw + 1
    m, k = N * h_O * w_O, c_I * h_F * w_F
    p_in = x.dtype.itemsize / 4.0
    gemm = matmul_access_plan(
        torch.empty((m, k), dtype=x.dtype, device="meta"),
        torch.empty((k, c_O), dtype=w.dtype, device="meta"),
        target=target, out_dtype=out_dtype, op="conv2d[im2col]")
    p_w = w.dtype.itemsize / 4.0
    expand = (
        FlatAccess(name="im2col_input_read", kind="load",
                   words=p_in * N * c_I * H * W,
                   note="aten patch expansion reads the input once"),
        FlatAccess(name="im2col_patch_write", kind="store",
                   words=p_in * float(m) * k,
                   note="aten patch expansion writes the (m, k) matrix"),
        FlatAccess(name="filter transpose read", kind="load",
                   words=p_w * c_O * k, counted=False,
                   note="w.reshape(c_O, k).t().contiguous()"),
        FlatAccess(name="filter transpose write", kind="store",
                   words=p_w * c_O * k, counted=False),
    )
    return _dc.replace(gemm, accesses=expand + gemm.accesses,
                       note="patch expansion + LP-tiled GEMM")
