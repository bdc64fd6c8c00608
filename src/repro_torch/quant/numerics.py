"""Symmetric quantization numerics shared by kernels, serving, and tests (the
counterpart of ``repro.quant.numerics``).

Per-channel (or per-tensor) symmetric int8: q = round(x / s) with
s = amax / 127, so dequantization is exact at zero, never clips in-range
values (amax / s == qmax), and the round-trip error is bounded by s / 2.
``torch.round`` rounds half to even, as ``jnp.round`` does, and every step
runs in f32, so the codes and scales equal the reference's bit for bit.

Scale folding: conv(x_q * s_x, w_q * s_w[c_O]) = s_x * s_w[c_O] *
conv_int(x_q, w_q), so the quantized kernels read ONE folded f32 scale
vector per output channel instead of dequantizing either operand: the int8
operands stay int8 all the way into shared memory and only the store sees
full-width values.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch


def quantize_symmetric(x: torch.Tensor, axis: Optional[int] = None,
                       bits: int = 8) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric quantization to int8 storage.

    ``axis=None`` -> one per-tensor scale (a 0-d tensor); ``axis=i`` -> one
    scale per slice along axis i (per-channel), reduced over every other
    axis. Returns ``(q, scale)`` with ``q`` int8 and ``scale`` f32 shaped
    ``()`` or ``(x.shape[axis],)``, on ``x``'s device. All-zero slices get
    scale 1.0 (and quantize to 0), so dequantization is always
    well-defined."""
    xf = torch.as_tensor(x).float()
    qmax = float(2 ** (bits - 1) - 1)
    if axis is None:
        amax = xf.abs().amax()
        scale = torch.where(amax > 0, amax / qmax, torch.ones_like(amax))
        sb = scale
    else:
        axis = axis % xf.ndim
        red = tuple(d for d in range(xf.ndim) if d != axis)
        amax = xf.abs().amax(dim=red) if red else xf.abs()
        scale = torch.where(amax > 0, amax / qmax, torch.ones_like(amax))
        shape = [1] * xf.ndim
        shape[axis] = xf.shape[axis]
        sb = scale.reshape(shape)
    q = torch.clamp(torch.round(xf / sb), -qmax, qmax).to(torch.int8)
    return q, scale


def dequantize(q: torch.Tensor, scale: torch.Tensor,
               axis: Optional[int] = None,
               dtype=torch.float32) -> torch.Tensor:
    """Inverse of :func:`quantize_symmetric` (up to the <= scale/2 error)."""
    qf = torch.as_tensor(q).float()
    scale = torch.as_tensor(scale, device=qf.device)
    if axis is not None:
        shape = [1] * qf.ndim
        shape[axis % qf.ndim] = qf.shape[axis % qf.ndim]
        scale = scale.reshape(shape)
    return (qf * scale).to(dtype)


def fold_output_scales(s_in: torch.Tensor,
                       s_out_channel: torch.Tensor) -> torch.Tensor:
    """Fold a per-tensor input scale and a per-output-channel filter scale
    into the single (1, c_O) f32 vector the quantized kernels read."""
    s_out = torch.as_tensor(s_out_channel).float()
    folded = torch.as_tensor(s_in, device=s_out.device).float() * s_out
    return folded.reshape(1, -1)


def quantize_conv_operands(x: torch.Tensor, w: torch.Tensor
                           ) -> Tuple[torch.Tensor, torch.Tensor,
                                      torch.Tensor]:
    """(x_q int8, w_q int8, folded (1, c_O) scale) for ``ops.conv2d_q``:
    per-tensor input scale, per-output-channel (OIHW axis 0) filter
    scales."""
    x_q, s_x = quantize_symmetric(x, axis=None)
    w_q, s_w = quantize_symmetric(w, axis=0)
    return x_q, w_q, fold_output_scales(s_x, s_w)


def quantize_matmul_operands(a: torch.Tensor, b: torch.Tensor
                             ) -> Tuple[torch.Tensor, torch.Tensor,
                                        torch.Tensor]:
    """(a_q int8, b_q int8, folded (1, n) scale) for ``ops.matmul_q``:
    per-tensor A scale, per-column (axis 1) B scales."""
    a_q, s_a = quantize_symmetric(a, axis=None)
    b_q, s_b = quantize_symmetric(b, axis=1)
    return a_q, b_q, fold_output_scales(s_a, s_b)
