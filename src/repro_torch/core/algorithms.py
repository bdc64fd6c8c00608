"""Modeled communication volumes for the convolution algorithms the paper
compares (§3.2 Fig 2, §4.2 Fig 3): naive, im2col, LP blocking, Winograd, FFT.

These are *symbolic* volume models, as in the paper ("we symbolically
calculate the amount of communication each one requires"), using:
  * the near-optimal GEMM volume  2 sqrt(p_A p_B p_C) mnk / sqrt(M) + IO
    ([12] Kwasniewski et al., COSMA, adapted to mixed precision), and
  * the Hong-Kung FFT bound  Theta(n log n / log M)  ([7] Elango).

All volumes are in words. The single-processor model charges HBM<->cache
traffic; the parallel model charges network words per processor.

The port of ``repro.core.algorithms``, line for line.
"""

from __future__ import annotations

import math
from typing import Dict

from .bounds import combined_parallel_bound, single_processor_bound
from .conv_model import ConvShape
from .parallel_tiling import optimize_parallel_blocking
from .tiling import MemoryModel, optimize_blocking


# ---------------------------------------------------------------------------
# Single-processor volumes (words), cache of M words.
# ---------------------------------------------------------------------------

def gemm_volume(m: int, n: int, k: int, M: float,
                p_A: float = 1.0, p_B: float = 1.0, p_C: float = 1.0) -> float:
    """Near-optimal single-processor GEMM communication (COSMA-style)."""
    io = p_A * m * k + p_B * k * n + p_C * m * n
    return 2.0 * math.sqrt(p_A * p_B * p_C) * m * n * k / math.sqrt(M) + io


def naive_volume(shape: ConvShape) -> float:
    """No blocking: every update streams its input and filter operand from
    slow memory; the output element is register-resident across the innermost
    reduction only."""
    p = shape.prec
    return (p.p_I + p.p_F) * shape.G + 2.0 * p.p_O * shape.output_size


def im2col_volume(shape: ConvShape, M: float) -> float:
    """Materialize the im2col matrix (read input, write the expanded matrix),
    then GEMM: (N wO hO) x (cI wF hF) times (cI wF hF) x cO."""
    p = shape.prec
    m = shape.N * shape.w_O * shape.h_O
    k = shape.c_I * shape.w_F * shape.h_F
    n = shape.c_O
    expand = p.p_I * (shape.input_size + m * k)  # read input + write expanded
    return expand + gemm_volume(m, n, k, M, p.p_I, p.p_F, p.p_O)


def blocking_volume(shape: ConvShape, M: float) -> float:
    """The paper's LP blocking (§3.2) under a unified cache of M words."""
    mem = MemoryModel(M=M, mode="unified", double_buffer=False)
    return optimize_blocking(shape, mem).comm_volume()


def fft_volume(shape: ConvShape, M: float) -> float:
    """FFT convolution: 2D FFTs of input (per image x channel) and filter
    (padded), frequency-domain batched GEMM over channels per frequency,
    inverse FFTs of the output. Complex data doubles the word count."""
    p = shape.prec
    wi, hi = shape.w_I, shape.h_I
    pts = wi * hi
    logM = max(math.log2(M), 1.0)

    def fft_words(batch: int, n_pts: int, prec: float) -> float:
        # Hong-Kung: n log2(n) / log2(M) per transform, complex => 2x words
        return 2.0 * prec * batch * n_pts * math.log2(max(n_pts, 2)) / logM

    vol = fft_words(shape.N * shape.c_I, pts, p.p_I)  # forward input FFTs
    vol += fft_words(shape.c_I * shape.c_O, pts, p.p_F)  # filter FFTs (padded)
    # frequency-domain contraction: for each of the pts frequencies, an
    # (N x cI) @ (cI x cO) GEMM with complex operands
    vol += pts * gemm_volume(shape.N, shape.c_O, shape.c_I, M,
                             2 * p.p_I, 2 * p.p_F, 2 * p.p_O)
    vol += fft_words(shape.N * shape.c_O, pts, p.p_O)  # inverse output FFTs
    return vol


def winograd_volume(shape: ConvShape, M: float, m_tile: int = 2) -> float:
    """Winograd F(m x m, r x r): per-tile transforms + (m+r-1)^2 batched GEMMs
    of (N * ceil(wO/m) * ceil(hO/m)) x cI x cO. Only exact for stride 1; for
    strided convs we fall back to stride-decomposed Winograd (volume scales by
    the stride product)."""
    p = shape.prec
    r = max(shape.w_F, shape.h_F)
    t = m_tile + r - 1  # transformed tile side
    tiles = shape.N * math.ceil(shape.w_O / m_tile) * math.ceil(shape.h_O / m_tile)
    # input transform: read t^2 window, write t^2 transformed, per (tile, cI)
    vol = p.p_I * tiles * shape.c_I * (2.0 * t * t)
    # filter transform: per (cI, cO), r^2 -> t^2
    vol += p.p_F * shape.c_I * shape.c_O * (r * r + t * t)
    # t^2 independent GEMMs: tiles x cI x cO
    vol += t * t * gemm_volume(tiles, shape.c_O, shape.c_I, M, p.p_I, p.p_F, p.p_O)
    # inverse transform: t^2 -> m^2 per (tile, cO)
    vol += p.p_O * tiles * shape.c_O * (t * t + m_tile * m_tile)
    return vol * (shape.sw * shape.sh)


def single_processor_volumes(shape: ConvShape, M: float) -> Dict[str, float]:
    """All algorithms + the Thm 2.1 lower bound, for Fig-2-style comparisons."""
    return {
        "lower_bound": single_processor_bound(shape, M).value,
        "naive": naive_volume(shape),
        "im2col": im2col_volume(shape, M),
        "blocking": blocking_volume(shape, M),
        "winograd": winograd_volume(shape, M),
        "fft": fft_volume(shape, M),
    }


# ---------------------------------------------------------------------------
# Parallel volumes (words per processor), P processors.
# ---------------------------------------------------------------------------

def gemm_volume_parallel(m: int, n: int, k: int, P: int,
                         p_A: float = 1.0, p_B: float = 1.0, p_C: float = 1.0) -> float:
    """Per-processor 2.5D/COSMA GEMM volume: ~ 2 (p^3 mnk / P)^{1/2}... using
    the memory-independent form  X >= 2 (p_A p_B p_C)^{1/3} (mnk/P)^{2/3} /
    ... simplified to the attainable 3D-algorithm volume 3 (mnk/P)^{2/3}."""
    pf = (p_A * p_B * p_C) ** (1.0 / 3.0)
    return 3.0 * pf * (m * n * k / P) ** (2.0 / 3.0)


def naive_volume_parallel(shape: ConvShape, P: int) -> float:
    """Owner-computes over outputs with no blocking design: each processor
    gathers the full filter and its input slab."""
    p = shape.prec
    return (p.p_F * shape.filter_size
            + p.p_I * shape.input_size / P
            + p.p_O * shape.output_size / P)


def im2col_volume_parallel(shape: ConvShape, P: int) -> float:
    """Only inter-processor words count in the distributed model: the im2col
    expansion is processor-local (each rank expands its own input shard), so
    the network cost is the distributed GEMM."""
    p = shape.prec
    m = shape.N * shape.w_O * shape.h_O
    k = shape.c_I * shape.w_F * shape.h_F
    n = shape.c_O
    return gemm_volume_parallel(m, n, k, P, p.p_I, p.p_F, p.p_O)


def blocking_volume_parallel(shape: ConvShape, P: int) -> float:
    return optimize_parallel_blocking(shape, P).comm_per_processor()


def fft_volume_parallel(shape: ConvShape, P: int) -> float:
    p = shape.prec
    pts = shape.w_I * shape.h_I
    # distributed FFT: each transform needs an all-to-all of its data (~1x
    # volume per butterfly stage across the processor boundary; model: 2 passes)
    vol = 2.0 * (2 * p.p_I * shape.N * shape.c_I * pts) / P
    vol += 2.0 * (2 * p.p_F * shape.c_I * shape.c_O * pts) / P
    # frequency-domain contraction: pts independent (N x cI)@(cI x cO) GEMMs,
    # modeled as one batched GEMM with m = N*pts distributed over P
    vol += gemm_volume_parallel(shape.N * pts, shape.c_O, shape.c_I, P,
                                2 * p.p_I, 2 * p.p_F, 2 * p.p_O)
    vol += 2.0 * (2 * p.p_O * shape.N * shape.c_O * pts) / P
    return vol


def winograd_volume_parallel(shape: ConvShape, P: int, m_tile: int = 2) -> float:
    p = shape.prec
    r = max(shape.w_F, shape.h_F)
    t = m_tile + r - 1
    tiles = shape.N * math.ceil(shape.w_O / m_tile) * math.ceil(shape.h_O / m_tile)
    vol = 2.0 * p.p_I * tiles * shape.c_I * t * t / P
    vol += 2.0 * p.p_F * shape.c_I * shape.c_O * t * t / P
    vol += t * t * gemm_volume_parallel(tiles, shape.c_O, shape.c_I, P,
                                        p.p_I, p.p_F, p.p_O)
    vol += 2.0 * p.p_O * tiles * shape.c_O * m_tile * m_tile / P
    return vol * (shape.sw * shape.sh)


def parallel_volumes(shape: ConvShape, P: int, M: float) -> Dict[str, float]:
    return {
        "lower_bound": combined_parallel_bound(shape, P, M),
        "naive": naive_volume_parallel(shape, P),
        "im2col": im2col_volume_parallel(shape, P),
        "blocking": blocking_volume_parallel(shape, P),
        "winograd": winograd_volume_parallel(shape, P),
        "fft": fft_volume_parallel(shape, P),
    }
