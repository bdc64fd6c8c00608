"""LP-tiled GEMM: the port of ``repro.kernels.matmul``.

Block shapes (bm, bn, bk) come from the paper's blocking LP applied to the
degenerate 7NL CNN (w_F = h_F = w_O = h_O = 1). On a CUDA tensor,
:func:`matmul` launches the hand-written kernel of ``csrc/matmul.cu`` (one
CTA per (bm, bn) tile, k looped inside the CTA, f32 accumulator in
registers); on a CPU tensor it runs :func:`matmul_plain`, the same function
in plain PyTorch. There is no fallback between the two.

``matmul_hbm_words`` reports the HBM words one launch moves, from the same
launch geometry: one (bm, bk) A tile and one (bk, bn) B tile per grid step
plus the padded output stores, exactly as the reference counts them.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from repro_torch.core.conv_model import Precision, round_up
from repro_torch.plan import ExecutionPlan, HardwareTarget, MatmulSpec
from repro_torch.plan.planner import resolve_kernel_plan

from ._build import (CudaKernel, check_cuda_operands, check_smem, dtype_code,
                     micro_tile)
from .ref import no_tf32

_c = ctypes
KERNEL = CudaKernel("matmul.cu", "repro_matmul", [
    _c.c_void_p, _c.c_void_p, _c.c_void_p,            # a, b, out
    _c.c_int, _c.c_int, _c.c_int,                     # dtypes, variant
    _c.c_longlong, _c.c_int, _c.c_int,                # m, n, k
    _c.c_int, _c.c_int, _c.c_int,                     # bm, bn, bk
    _c.c_longlong, _c.c_int, _c.c_int,                # nMT, nNT, nKT
    _c.c_longlong, _c.c_int, _c.c_int, _c.c_int,      # ldo, nRG, ldA, ldB
    _c.c_longlong, _c.c_int, _c.c_int, _c.c_void_p,   # a_bytes, threads, smem, stream
])
# (TM, TN) micro-tiles compiled into csrc/matmul.cu, in its variant order
MICRO_TILES = ((8, 8), (16, 4), (4, 16), (32, 2), (64, 1))


def _matmul_spec(m: int, n: int, k: int, in_bits: int) -> MatmulSpec:
    p_in = in_bits / 32.0
    return MatmulSpec(m=m, n=n, k=k, prec=Precision(p_in, p_in, 1.0))


def matmul_plain(a: torch.Tensor, b: torch.Tensor,
                 out_dtype=torch.float32) -> torch.Tensor:
    """The kernel's function in plain PyTorch: an f32 matmul (TF32 off)."""
    with no_tf32():
        return torch.matmul(a.float(), b.float()).to(out_dtype)


def launch_config(bm: int, bn: int, bk: int, itemsize: int) -> dict:
    """The kernel's launch configuration for tiles (bm, bn, bk): micro-tile
    variant, thread grid, shared-memory strides and bytes."""
    variant, tm, tn, n_rg, n_cg = micro_tile(bm, bn, MICRO_TILES)
    lda = bm + max(1, 4 // itemsize)  # odd word stride: conflict-free stores
    ldb = n_cg * tn
    a_bytes = round_up(bk * lda * itemsize, 16)
    smem = a_bytes + bk * ldb * itemsize
    check_smem(smem, f"matmul tiles {(bm, bn, bk)}")
    return dict(variant=variant, n_rg=n_rg, threads=n_rg * n_cg, lda=lda,
                ldb=ldb, a_bytes=a_bytes, smem=smem)


def _launch(a: torch.Tensor, b: torch.Tensor, out_dtype,
            tiles: Tuple[int, int, int]) -> torch.Tensor:
    check_cuda_operands("matmul", a, b)
    m, k = a.shape
    n = b.shape[1]
    bm, bn, bk = tiles
    mp, np_ = round_up(m, bm), round_up(n, bn)
    cfg = launch_config(bm, bn, bk, a.element_size())
    out = torch.empty((mp, np_), dtype=out_dtype, device=a.device)
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        KERNEL.launch(
            a.data_ptr(), b.data_ptr(), out.data_ptr(), dtype_code(a.dtype),
            dtype_code(out_dtype), cfg["variant"], m, n, k, bm, bn, bk,
            mp // bm, np_ // bn, -(-k // bk), np_, cfg["n_rg"], cfg["lda"],
            cfg["ldb"], cfg["a_bytes"], cfg["threads"], cfg["smem"], stream)
    return out[:m, :n]


def matmul(
    a: torch.Tensor,  # (m, k)
    b: torch.Tensor,  # (k, n)
    out_dtype=torch.float32,
    ctx=None,  # ExecutionContext (duck-typed: .target/.autotune)
    tiles: Optional[Tuple[int, int, int]] = None,
    plan: Optional[ExecutionPlan] = None,
) -> torch.Tensor:
    """C[m,n] = A @ B with LP-chosen tiles.

    Tiles come from (in priority order) an explicit ``tiles`` triple, an
    explicit ``plan`` (the dispatcher's handoff), or a fresh plan for the
    context's target (default ``H100``). CUDA tensors run the kernel; CPU
    tensors run :func:`matmul_plain`."""
    m, k = a.shape
    k2, n = b.shape
    if k != k2:
        raise ValueError(f"inner dims mismatch: {k} vs {k2}")
    t = resolve_kernel_plan(_matmul_spec(m, n, k, a.dtype.itemsize * 8),
                            plan=plan, tiles=tiles, ctx=ctx)
    if a.device.type == "cpu" and b.device.type == "cpu":
        return matmul_plain(a, b, out_dtype)
    return _launch(a, b, out_dtype, tuple(t))


def matmul_hbm_words(
    a,  # tensor (meta tensors work), (m, k)
    b,  # tensor, (k, n)
    tiles: Optional[Tuple[int, int, int]] = None,
    plan: Optional[ExecutionPlan] = None,
    target: Optional[HardwareTarget] = None,
    out_dtype=torch.float32,
) -> float:
    """Measured HBM words (32-bit) one ``matmul`` launch moves: one A and
    one B tile loaded per grid step plus the padded output stores. Only
    shapes/dtypes are consulted."""
    m, k = a.shape
    n = b.shape[1]
    bm, bn, bk = resolve_kernel_plan(
        _matmul_spec(m, n, k, a.dtype.itemsize * 8),
        plan=plan, target=target, tiles=tiles)
    mp, np_, kp = round_up(m, bm), round_up(n, bn), round_up(k, bk)
    n_steps = (mp // bm) * (np_ // bn) * (kp // bk)
    p_a = a.dtype.itemsize / 4.0
    p_b = b.dtype.itemsize / 4.0
    p_out = out_dtype.itemsize / 4.0
    return (n_steps * (bm * bk * p_a + bk * bn * p_b) + mp * np_ * p_out)
