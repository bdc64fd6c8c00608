"""Aten oracles for the ``torch`` backend (the counterpart of
``repro.kernels.ref``): the ground truth the hand-written kernels are held
against. All compute in float32 with TF32 off, whatever the input dtype."""

from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F


@contextlib.contextmanager
def no_tf32():
    """float32 products in full float32 inside the block: cuDNN convolutions
    default to TF32 (about three decimal digits), which no oracle or plain
    version may use. Both global flags are restored on exit, so a caller's
    own TF32 setting survives every call into the port."""
    cudnn, cuda = torch.backends.cudnn, torch.backends.cuda.matmul
    saved = (cudnn.allow_tf32, cuda.allow_tf32)
    cudnn.allow_tf32 = cuda.allow_tf32 = False
    try:
        yield
    finally:
        cudnn.allow_tf32, cuda.allow_tf32 = saved


def matmul_ref(a: torch.Tensor, b: torch.Tensor,
               out_dtype=torch.float32) -> torch.Tensor:
    """C = A @ B with f32 accumulation regardless of input dtype."""
    with no_tf32():
        return torch.matmul(a.float(), b.float()).to(out_dtype)


def conv2d_ref(
    x: torch.Tensor,  # (N, c_I, H, W)
    w: torch.Tensor,  # (c_O, c_I, h_F, w_F)
    stride: tuple = (1, 1),
    out_dtype=torch.float32,
) -> torch.Tensor:
    """Direct 7NL convolution, VALID padding (the paper's §2.1 convention:
    h_O = (H - h_F) // sh + 1 output rows)."""
    with no_tf32():
        return F.conv2d(x.float(), w.float(),
                        stride=tuple(stride)).to(out_dtype)


def flash_attention_ref(
    q: torch.Tensor,  # (B, H, Lq, Dh)
    k: torch.Tensor,  # (B, Hkv, Lk, Dh)
    v: torch.Tensor,  # (B, Hkv, Lk, Dh)
    causal: bool = True,
    q_offset: int = 0,
) -> torch.Tensor:
    """GQA attention oracle with f32 softmax. Hkv may divide H (grouped KV).
    ``q_offset`` shifts the causal mask (decode: query position = offset).
    The ``torch`` backend's attention with no key mask."""
    from repro_torch.ops.registry import torch_attention  # imports this module
    return torch_attention(q, k, v, causal=causal, q_offset=q_offset)
