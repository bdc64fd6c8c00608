"""Communication-optimal blocking via linear programming (paper §3.2 eq. (6)
and the GEMMINI-adapted integer variant of §5), re-targeted at the TPU memory
hierarchy (HBM <-> VMEM).

Blocking variables (the paper's small-filter trick, i6 = sw*q6 + r6):

    B = (b_N, b_cI, b_cO, b_wO, b_hO, b_q6, b_q7, b_r6, b_r7)

with b_q6 in [1, ceil(w_F/sw)], b_r6 in [1, sw] (similarly for h). The LP works
in log space: maximize sum(log b) (updates per tile) subject to the three
arrays' blocks fitting in memory.  The input-window product
(b_wO + b_q6)(b_hO + b_q7) is expanded into four monomial terms each bounded by
M/(4 p_T), exactly as in the paper.

Memory models:
  * ``unified``  - one cache of M words shared by all three blocks (eq. 6).
  * ``split``    - GEMMINI/TPU style: scratchpad (input+filter, low precision)
                   of M words + separate accumulator (output, high precision)
                   of M_acc words; double-buffering halves both (paper §5).

Integer refinement replaces the paper's Mathematica NMaximize with a greedy
divisor-aware hill climb on the modeled communication volume under the *exact*
(non-relaxed) footprint constraints.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
from scipy.optimize import linprog

from .conv_model import ConvShape, Precision, ceil_div

AXES = ("N", "cI", "cO", "wO", "hO", "q6", "q7", "r6", "r7")


@dataclasses.dataclass(frozen=True)
class MemoryModel:
    """Capacity model for the fast memory the blocks must inhabit."""

    M: float  # words (32-bit) of scratchpad / cache / VMEM
    M_acc: Optional[float] = None  # words of accumulator (``split`` mode only)
    mode: str = "unified"  # "unified" | "split"
    double_buffer: bool = True  # paper §5: halves usable capacity

    @property
    def M_eff(self) -> float:
        return self.M / 2.0 if self.double_buffer else self.M

    @property
    def M_acc_eff(self) -> float:
        if self.M_acc is None:
            return self.M_eff
        return self.M_acc / 2.0 if self.double_buffer else self.M_acc


# TPU v5e-flavoured defaults: ~16 MiB VMEM per core -> 4 Mi words of 32 bits.
TPU_VMEM_WORDS = (16 * 1024 * 1024) // 4
TPU_VMEM = MemoryModel(M=TPU_VMEM_WORDS, mode="unified", double_buffer=True)
# GEMMINI defaults from the paper: 256 KiB scratchpad of 8-bit words and a
# 64 KiB accumulator of 32-bit words, both double buffered.
GEMMINI = MemoryModel(M=256 * 1024 / 4.0, M_acc=64 * 1024 / 4.0, mode="split",
                      double_buffer=True)


@dataclasses.dataclass(frozen=True)
class Blocking:
    """An integer blocking of the (lifted) 7NL CNN loops."""

    b: Dict[str, int]  # keys = AXES
    shape: ConvShape

    def __post_init__(self):
        for k in AXES:
            assert k in self.b, f"missing block var {k}"

    # -- lifted loop bounds ---------------------------------------------------
    @staticmethod
    def lifted_bounds(shape: ConvShape) -> Dict[str, int]:
        return {
            "N": shape.N,
            "cI": shape.c_I,
            "cO": shape.c_O,
            "wO": shape.w_O,
            "hO": shape.h_O,
            "q6": ceil_div(shape.w_F, shape.sw),
            "q7": ceil_div(shape.h_F, shape.sh),
            "r6": shape.sw,
            "r7": shape.sh,
        }

    # -- block footprints in words -------------------------------------------
    @property
    def out_block_words(self) -> float:
        b = self.b
        return self.shape.prec.p_O * b["N"] * b["cO"] * b["wO"] * b["hO"]

    @property
    def filt_block_words(self) -> float:
        b = self.b
        return self.shape.prec.p_F * b["cI"] * b["cO"] * b["q6"] * b["q7"] * b["r6"] * b["r7"]

    @property
    def in_block_words(self) -> float:
        """Exact lifted input window: (b_wO + b_q6 - 1) x b_r6 in the lifted w
        axis (sw-strided), similarly for h."""
        b = self.b
        w_win = (b["wO"] + b["q6"] - 1) * b["r6"]
        h_win = (b["hO"] + b["q7"] - 1) * b["r7"]
        return self.shape.prec.p_I * b["N"] * b["cI"] * w_win * h_win

    def fits(self, mem: MemoryModel) -> bool:
        if mem.mode == "split":
            return (
                self.in_block_words + self.filt_block_words <= mem.M_eff
                and self.out_block_words <= mem.M_acc_eff
            )
        return (
            self.in_block_words + self.filt_block_words + self.out_block_words
            <= mem.M_eff
        )

    # -- tile grid -------------------------------------------------------------
    def tile_counts(self) -> Dict[str, int]:
        d = self.lifted_bounds(self.shape)
        return {k: ceil_div(d[k], self.b[k]) for k in AXES}

    @property
    def num_tiles(self) -> int:
        t = self.tile_counts()
        return math.prod(t.values())

    @property
    def num_output_tiles(self) -> int:
        t = self.tile_counts()
        return t["N"] * t["cO"] * t["wO"] * t["hO"]

    @property
    def updates_per_tile(self) -> int:
        b = self.b
        return math.prod(b[k] for k in AXES)

    def comm_volume(self) -> float:
        """Modeled HBM<->VMEM words moved. Loop order keeps reduction axes
        (cI, q6, q7, r6, r7) innermost so the output block stays resident in
        the accumulator across the reduction (paper §5); input and filter
        blocks are (re)loaded at every tile step."""
        per_tile = self.in_block_words + self.filt_block_words
        out_words = self.shape.prec.p_O * self.shape.output_size
        return self.num_tiles * per_tile + out_words

    def as_conv_tile(self) -> Dict[str, int]:
        """Collapse the lifted (q, r) split back to filter/image tile dims for
        kernel consumption."""
        b = self.b
        return {
            "N": b["N"],
            "cI": b["cI"],
            "cO": b["cO"],
            "wO": b["wO"],
            "hO": b["hO"],
            "wF": min(b["q6"] * b["r6"], self.shape.w_F),
            "hF": min(b["q7"] * b["r7"], self.shape.h_F),
        }


# ---------------------------------------------------------------------------
# The LP (continuous relaxation, log space) - paper eq. (6).
# ---------------------------------------------------------------------------

def _lp_blocking(shape: ConvShape, mem: MemoryModel) -> Dict[str, float]:
    """Solve the log-space LP and return continuous block sizes."""
    p = shape.prec
    d = Blocking.lifted_bounds(shape)
    n = len(AXES)
    idx = {k: i for i, k in enumerate(AXES)}

    def row(keys: Sequence[str]) -> List[float]:
        r = [0.0] * n
        for k in keys:
            r[idx[k]] += 1.0
        return r

    A_ub: List[List[float]] = []
    b_ub: List[float] = []

    if mem.mode == "split":
        M_sp, M_acc = mem.M_eff, mem.M_acc_eff
        # output block alone in the accumulator
        A_ub.append(row(["N", "cO", "wO", "hO"]))
        b_ub.append(math.log(max(M_acc / p.p_O, 1.0)))
        # scratchpad shared between filter and input: give each half
        # (the integer refinement re-optimizes the split exactly)
        A_ub.append(row(["cI", "cO", "q6", "q7", "r6", "r7"]))
        b_ub.append(math.log(max(M_sp / (2.0 * p.p_F), 1.0)))
        for wk in ("wO", "q6"):
            for hk in ("hO", "q7"):
                A_ub.append(row(["N", "cI", wk, hk, "r6", "r7"]))
                b_ub.append(math.log(max(M_sp / (2.0 * 4.0 * p.p_I), 1.0)))
    else:
        M = mem.M_eff
        p_T = p.p_T
        # eq. (6): each array block gets its p_j/p_T share of M
        A_ub.append(row(["N", "cO", "wO", "hO"]))
        b_ub.append(math.log(max(M / p_T, 1.0)))
        A_ub.append(row(["cI", "cO", "q6", "q7", "r6", "r7"]))
        b_ub.append(math.log(max(M / p_T, 1.0)))
        # input term expanded into four monomials, each <= M/(4 p_T)
        for wk in ("wO", "q6"):
            for hk in ("hO", "q7"):
                A_ub.append(row(["N", "cI", wk, hk, "r6", "r7"]))
                b_ub.append(math.log(max(M / (4.0 * p_T), 1.0)))

    bounds = [(0.0, math.log(max(d[k], 1))) for k in AXES]
    c = [-1.0] * n  # maximize sum of logs
    res = linprog(c, A_ub=np.asarray(A_ub), b_ub=np.asarray(b_ub), bounds=bounds,
                  method="highs")
    if not res.success:
        raise RuntimeError(f"blocking LP failed: {res.message}")
    return {k: math.exp(res.x[idx[k]]) for k in AXES}


# ---------------------------------------------------------------------------
# Integer refinement (replaces NMaximize, paper §5).
# ---------------------------------------------------------------------------

def _candidates(dim: int, x: float) -> List[int]:
    """Integer candidates in [1, dim]: all divisors (ragged-edge-free), powers
    of two, and the continuous LP value's floor/ceil."""
    lo = max(1, min(dim, int(math.floor(x))))
    cands = {1, lo, min(lo + 1, dim), dim}
    v = 1
    while v <= dim:
        cands.add(v)
        v *= 2
    if dim <= 4096:
        for d in range(1, int(math.isqrt(dim)) + 1):
            if dim % d == 0:
                cands.add(d)
                cands.add(dim // d)
    return sorted(cands)


def _clip_to_feasible(b: Dict[str, int], shape: ConvShape, mem: MemoryModel) -> Dict[str, int]:
    """Shrink blocks (largest contributors first) until they fit."""
    b = dict(b)
    while not Blocking(b, shape).fits(mem):
        # shrink the axis whose reduction most decreases footprint
        best_k, best_gain = None, 0.0
        cur = _footprint(b, shape, mem)
        for k in AXES:
            if b[k] == 1:
                continue
            trial = dict(b)
            trial[k] = max(1, b[k] // 2)
            gain = cur - _footprint(trial, shape, mem)
            if gain > best_gain:
                best_k, best_gain = k, gain
        if best_k is None:
            break
        b[best_k] = max(1, b[best_k] // 2)
    return b


def _footprint(b: Dict[str, int], shape: ConvShape, mem: MemoryModel) -> float:
    blk = Blocking(b, shape)
    if mem.mode == "split":
        return max(blk.in_block_words + blk.filt_block_words - mem.M_eff,
                   blk.out_block_words - mem.M_acc_eff, 0.0) + (
            blk.in_block_words + blk.filt_block_words + blk.out_block_words)
    return blk.in_block_words + blk.filt_block_words + blk.out_block_words


def optimize_blocking(
    shape: ConvShape,
    mem: MemoryModel = TPU_VMEM,
    align: Optional[Dict[str, int]] = None,
    sweeps: int = 3,
) -> Blocking:
    """LP + greedy integer hill-climb -> communication-minimizing Blocking.

    ``align`` optionally maps axis -> multiple (e.g. {"cO": 128, "cI": 8} for
    MXU lane/sublane alignment); respected when the axis bound allows it.
    """
    d = Blocking.lifted_bounds(shape)
    cont = _lp_blocking(shape, mem)
    b = {k: max(1, min(d[k], int(round(cont[k])))) for k in AXES}
    if align:
        for k, m in align.items():
            if k in b and d[k] >= m:
                b[k] = max(m, (b[k] // m) * m)
    b = _clip_to_feasible(b, shape, mem)

    def cost(bb: Dict[str, int]) -> float:
        return Blocking(bb, shape).comm_volume()

    def ok_align(k: str, v: int) -> bool:
        if not align or k not in align or d[k] < align[k]:
            return True
        return v % align[k] == 0 or v == d[k]

    cands = {k: [v for v in _candidates(d[k], cont[k]) if ok_align(k, v)] for k in AXES}

    starts = [
        dict(b),
        {k: 1 for k in AXES},
        # spatial-first and channel-first seeds escape accumulator-bound optima
        {**{k: 1 for k in AXES}, "wO": d["wO"], "hO": d["hO"], "q6": d["q6"],
         "q7": d["q7"], "r6": d["r6"], "r7": d["r7"]},
        {**{k: 1 for k in AXES}, "cI": d["cI"], "cO": d["cO"]},
    ]
    best, best_cost = None, float("inf")
    for start in starts:
        cur = _clip_to_feasible(start, shape, mem)
        cur_cost = cost(cur)
        for _ in range(max(sweeps, 8)):
            improved = False
            # single-axis moves
            for k in AXES:
                for v in cands[k]:
                    trial = dict(cur)
                    trial[k] = v
                    blk = Blocking(trial, shape)
                    if not blk.fits(mem):
                        continue
                    c = blk.comm_volume()
                    if c < cur_cost - 1e-9:
                        cur, cur_cost = trial, c
                        improved = True
            # paired moves: trade capacity between two axes at once
            for ki in AXES:
                for kj in AXES:
                    if ki == kj:
                        continue
                    for vi in cands[ki]:
                        if vi <= cur[ki]:
                            continue
                        for vj in cands[kj]:
                            if vj >= cur[kj]:
                                continue
                            trial = dict(cur)
                            trial[ki], trial[kj] = vi, vj
                            blk = Blocking(trial, shape)
                            if not blk.fits(mem):
                                continue
                            c = blk.comm_volume()
                            if c < cur_cost - 1e-9:
                                cur, cur_cost = trial, c
                                improved = True
            if not improved:
                break
        if cur_cost < best_cost:
            best, best_cost = cur, cur_cost
    blk = Blocking(best, shape)
    assert blk.fits(mem), "integer refinement produced an infeasible blocking"
    return blk


# ---------------------------------------------------------------------------
# Kernel-level footprints: what the lowered conv2d kernel actually holds in
# VMEM for a (bN, b_cI, b_cO, b_hO, b_wO) tile. Differs from the lifted
# Blocking model in two ways: the kernel always unrolls the full (h_F, w_F)
# filter (no q/r blocking), and its input window is the exact halo extent
# (b_hO - 1) * sh + h_F rather than the lifted (b_hO + b_q7 - 1) * b_r7.
# ---------------------------------------------------------------------------

def conv_kernel_footprints(shape: ConvShape, tiles: Sequence[int],
                           prec: Optional[Precision] = None
                           ) -> Dict[str, float]:
    """Words each array block of the spatially-tiled conv2d kernel occupies
    in fast memory, for kernel tiles ``(bN, b_cI, b_cO, b_hO, b_wO)``.
    ``prec`` overrides the shape's own word-widths — the byte-weighted view
    a quantized storage policy (``repro.quant.PrecisionSpec.precision``)
    prices the same tiles at (int8 streams take a quarter of the VMEM the
    shape's nominal precision would charge)."""
    bN, b_cI, b_cO, b_hO, b_wO = tiles
    p = prec if prec is not None else shape.prec
    h_in = (b_hO - 1) * shape.sh + shape.h_F
    w_in = (b_wO - 1) * shape.sw + shape.w_F
    return {
        "input": p.p_I * bN * b_cI * h_in * w_in,
        "filter": p.p_F * b_cO * b_cI * shape.h_F * shape.w_F,
        "output": p.p_O * bN * b_cO * b_hO * b_wO,
    }


def conv_kernel_tiles_fit(shape: ConvShape, tiles: Sequence[int],
                          mem: MemoryModel) -> bool:
    """Whether the kernel tile's halo-window footprint obeys the same
    double-buffered capacity discipline the blocking LP planned under."""
    fp = conv_kernel_footprints(shape, tiles)
    if mem.mode == "split":
        return (fp["input"] + fp["filter"] <= mem.M_eff
                and fp["output"] <= mem.M_acc_eff)
    return sum(fp.values()) <= mem.M_eff


def fit_conv_kernel_tiles(shape: ConvShape, tiles: Sequence[int],
                          mem: MemoryModel) -> Tuple[int, int, int, int, int]:
    """Shrink kernel tiles (best-gain axis first) until the halo-window
    footprint fits; the LP solution is usually already feasible, but its
    lifted model can undercount when it blocked the filter taps."""
    b = list(tiles)
    while not conv_kernel_tiles_fit(shape, b, mem):
        cur = sum(conv_kernel_footprints(shape, b).values())
        best_i, best_gain = None, 0.0
        for i in range(5):
            if b[i] == 1:
                continue
            trial = list(b)
            trial[i] = max(1, b[i] // 2)
            gain = cur - sum(conv_kernel_footprints(shape, trial).values())
            if gain > best_gain:
                best_i, best_gain = i, gain
        if best_i is None:
            break
        b[best_i] = max(1, b[best_i] // 2)
    return tuple(b)


def blocking_efficiency(shape: ConvShape, mem: MemoryModel) -> Tuple[float, float, float]:
    """(modeled comm volume, lower bound, ratio) for the optimized blocking."""
    from .bounds import single_processor_bound

    blk = optimize_blocking(shape, mem)
    vol = blk.comm_volume()
    lb = single_processor_bound(shape, mem.M_eff).value
    return vol, lb, vol / max(lb, 1.0)


# ---------------------------------------------------------------------------
# Attention block sizing: the capacity argument of the flash kernel.
# ---------------------------------------------------------------------------

def attention_block_size(dh: int, m_eff: float, p_kv: float = 1.0) -> int:
    """The (block_q = block_k) tile of the blocked flash-attention schedule:
    f32 q/acc/stats residents plus streamed k/v tiles (``p_kv`` words per
    element) must fit the double-buffered budget ``m_eff``. The LP
    degenerates to this closed form because both attention GEMMs share the
    b_q x b_k footprint term; returns the largest MXU-saturating power of
    two <= 512 that fits."""
    for b in (512, 256, 128, 64, 32, 16, 8):
        words = 2.0 * b * dh + 2.0 * b * dh * p_kv + b * b + 2.0 * b
        if words <= m_eff:
            return b
    raise ValueError(
        f"no attention block fits: dh={dh} needs more than "
        f"M_eff={m_eff:.0f} words even at block 8")


# ---------------------------------------------------------------------------
# Matmul convenience: LP-tiled GEMM block shapes for the Pallas kernels.
# ---------------------------------------------------------------------------

def matmul_blocking(
    m: int, n: int, k: int,
    mem: Optional[MemoryModel] = None,
    prec=None,
    align_m: int = 8, align_n: int = 128, align_k: int = 128,
) -> Blocking:
    """The full Blocking for C[m,n] += A[m,k]B[k,n] as the degenerate 7NL CNN
    (N=m, c_I=k, c_O=n) under an arbitrary memory model."""
    from .conv_model import matmul_as_conv, Precision

    shape = matmul_as_conv(m, n, k, prec or Precision(0.5, 0.5, 1.0))
    if mem is None:
        mem = MemoryModel(M=TPU_VMEM_WORDS, mode="unified", double_buffer=True)
    align = {k_: v for k_, v in
             (("N", align_m), ("cO", align_n), ("cI", align_k)) if v > 1}
    return optimize_blocking(shape, mem, align=align or None)


def snap_tile(v: int, align: int, dim: int) -> int:
    """Round a tile down to the alignment multiple (whole dim when it is
    smaller than one aligned tile)."""
    if align <= 1:
        return min(v, dim)
    if dim < align:
        return dim
    v = max(align, (v // align) * align)
    return min(v, (dim // align) * align if dim % align == 0 else v)


def matmul_tiles(
    m: int, n: int, k: int,
    vmem_words: float = TPU_VMEM_WORDS,
    prec=None,
    align_m: int = 8, align_n: int = 128, align_k: int = 128,
    mem: Optional[MemoryModel] = None,
) -> Tuple[int, int, int]:
    """Block sizes (bm, bn, bk) for C[m,n] += A[m,k]B[k,n] from the 7NL LP,
    MXU-aligned. The degenerate conv has N=m, c_I=k, c_O=n."""
    if mem is None:
        mem = MemoryModel(M=vmem_words, mode="unified", double_buffer=True)
    blk = matmul_blocking(m, n, k, mem=mem, prec=prec, align_m=align_m,
                          align_n=align_n, align_k=align_k)
    bm, bk, bn = blk.b["N"], blk.b["cI"], blk.b["cO"]
    return (snap_tile(bm, align_m, m), snap_tile(bn, align_n, n),
            snap_tile(bk, align_k, k))
