"""Closed-form communication lower bounds (paper Theorems 2.1, 2.2, 2.3).

All bounds are in *words* (32-bit). Mixed precision enters through
(p_I, p_F, p_O) and the constant C_p.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict

from .conv_model import ConvShape, Precision


def C_p(prec: Precision) -> float:
    """The precision constant of Thm 2.1:

        C_p = p_T^2 / 4                 if the triangle condition holds
        C_p = p_j (p_k + p_l)           if p_j > p_k + p_l for some j

    In the standard case p_I = p_F = p_O = 1, C_p = 9/4.
    """
    if prec.triangle_ok():
        return prec.p_T ** 2 / 4.0
    p = prec.as_tuple()
    for j in range(3):
        rest = sum(p) - p[j]
        if p[j] > rest:
            return p[j] * rest
    raise AssertionError("unreachable")


@dataclasses.dataclass(frozen=True)
class BoundTerms:
    """The individual max{...} terms of a bound, in words."""

    terms: Dict[str, float]

    @property
    def value(self) -> float:
        return max(self.terms.values())

    @property
    def dominant(self) -> str:
        return max(self.terms, key=self.terms.get)  # type: ignore[arg-type]


# ---------------------------------------------------------------------------
# Theorem 2.1 — single processor, cache size M words.
# ---------------------------------------------------------------------------

def single_processor_bound(shape: ConvShape, M: float) -> BoundTerms:
    """X >= max{ p_I|I| + p_F|F| + p_O|O|,
                 C_p G / M - M,
                 2 (p_I p_F p_O)^{1/2} (sw sh)^{1/2} G (w_F h_F M)^{-1/2} - 2M }."""
    p = shape.prec
    G = shape.G
    memfree = p.p_I * shape.input_size + p.p_F * shape.filter_size + p.p_O * shape.output_size
    per_M = C_p(p) * G / M - M
    small_filter = (
        2.0 * math.sqrt(p.p_I * p.p_F * p.p_O) * math.sqrt(shape.sw * shape.sh) * G
        / math.sqrt(shape.w_F * shape.h_F * M)
        - 2.0 * M
    )
    return BoundTerms(
        {"memory_independent": memfree, "per_M": per_M, "small_filter": small_filter}
    )


def small_filter_regime(shape: ConvShape, M: float) -> bool:
    """The third bound eclipses the second iff w_F h_F < 64 M sw sh / 81
    (paper §3.1, standard precision)."""
    return shape.w_F * shape.h_F < 64.0 * M * shape.sw * shape.sh / 81.0


# ---------------------------------------------------------------------------
# Theorem 2.2 — P distributed processors, each with M words.
# ---------------------------------------------------------------------------

def parallel_bound(shape: ConvShape, P: int, M: float) -> BoundTerms:
    """X >= max{ C_p G/(P M) - M,
                 2 (p_I p_F p_O)^{1/2}(sw sh)^{1/2} G / (P (w_F h_F M)^{1/2}) - 2M }."""
    p = shape.prec
    G = shape.G
    per_M = C_p(p) * G / (P * M) - M
    small_filter = (
        2.0 * math.sqrt(p.p_I * p.p_F * p.p_O) * math.sqrt(shape.sw * shape.sh) * G
        / (P * math.sqrt(shape.w_F * shape.h_F * M))
        - 2.0 * M
    )
    return BoundTerms({"per_M": per_M, "small_filter": small_filter})


# ---------------------------------------------------------------------------
# Theorem 2.3 — memory-independent (2.5D-style), load-balanced start.
# ---------------------------------------------------------------------------

def memory_independent_parallel_bound(shape: ConvShape, P: int) -> BoundTerms:
    """X >= (p_I p_F p_O)^{1/3} max{ (G/P)^{1/2},
                                     (G sw sh)^{2/3} / (P w_F h_F)^{2/3} } - A_P/P."""
    p = shape.prec
    G = shape.G
    A_P = max(
        p.p_I * shape.input_size, p.p_F * shape.filter_size, p.p_O * shape.output_size
    )
    pf = (p.p_I * p.p_F * p.p_O) ** (1.0 / 3.0)
    t1 = pf * math.sqrt(G / P) - A_P / P
    t2 = pf * (G * shape.sw * shape.sh) ** (2.0 / 3.0) / (P * shape.w_F * shape.h_F) ** (2.0 / 3.0) - A_P / P
    return BoundTerms({"cube_root": t1, "small_filter": t2})


def combined_parallel_bound(shape: ConvShape, P: int, M: float) -> float:
    """max of Thm 2.2 and Thm 2.3 (the latter assumes load balance)."""
    return max(parallel_bound(shape, P, M).value,
               memory_independent_parallel_bound(shape, P).value)


# ---------------------------------------------------------------------------
# Attention specialization (Thm 2.1 applied to the two attention GEMMs).
# ---------------------------------------------------------------------------

def attention_bound(B: int, H: int, KV: int, Lq: int, Lk: int, hd: int,
                    M: float, prec: Precision = Precision()) -> BoundTerms:
    """Single-processor bound for GQA attention in words.

    Attention is two chained 7NL degenerates — S = QK^T and O = PV — with
    G = 2 B H Lq Lk hd total MACs. A flash-style schedule keeps S/P resident
    in fast memory (never spilled), so the memory-independent term charges
    only the four HBM-resident arrays: Q and O at ``p_I``/``p_O`` words per
    element and the un-repeated K/V streams (|K| = |V| = B KV Lk hd, GQA
    keeps them factored) at ``p_F``. The per-M and small-filter terms are the
    w_F = h_F = s = 1 specializations of Thm 2.1, exactly as
    ``matmul_bound``; for decode (Lq = 1) the memory-independent term — the
    pure KV-cache stream — dominates, which is the paper's thesis applied to
    serving."""
    G = 2.0 * B * H * Lq * Lk * hd
    memfree = (prec.p_I * B * H * Lq * hd
               + prec.p_F * 2.0 * B * KV * Lk * hd
               + prec.p_O * B * H * Lq * hd)
    per_M = C_p(prec) * G / M - M
    small_filter = (2.0 * math.sqrt(prec.p_I * prec.p_F * prec.p_O) * G
                    / math.sqrt(M) - 2.0 * M)
    return BoundTerms(
        {"memory_independent": memfree, "per_M": per_M,
         "small_filter": small_filter}
    )


# ---------------------------------------------------------------------------
# Matmul specialization (sanity anchor: classical results).
# ---------------------------------------------------------------------------

def matmul_bound(m: int, n: int, k: int, M: float, prec: Precision = Precision()) -> float:
    """Single-processor GEMM bound via the 7NL specialization
    (w_F=h_F=w_O=h_O=1). With p=1 this is max{mk+kn+mn, 9mnk/(4M)-M,
    2mnk/sqrt(M)-2M} - the familiar 2mnk/sqrt(M) Loomis-Whitney bound."""
    from .conv_model import matmul_as_conv

    return single_processor_bound(matmul_as_conv(m, n, k, prec), M).value


# ---------------------------------------------------------------------------
# Mixed-precision variants — the same theorems evaluated under a quantized
# per-operand storage policy (``repro.quant.PrecisionSpec``), so "how much
# does int8 storage move the bound" is a first-class query.
# ---------------------------------------------------------------------------

def _as_precision(prec) -> Precision:
    """Accept a ``Precision`` word-width triple or anything exposing one via
    a ``.precision`` property (``repro.quant.PrecisionSpec`` — duck-typed to
    keep ``core`` free of upward imports)."""
    if isinstance(prec, Precision):
        return prec
    p = getattr(prec, "precision", None)
    if isinstance(p, Precision):
        return p
    raise TypeError(f"expected Precision or PrecisionSpec, got {type(prec)!r}")


def mixed_precision_bound(shape: ConvShape, M: float, prec) -> BoundTerms:
    """Thm 2.1 with the shape's operands re-priced at a quantized storage
    policy's word-widths. Every term moves: the memory-independent term
    scales linearly per operand, the per-M term through C_p, the
    small-filter term through sqrt(p_I p_F p_O) — narrower storage lowers
    the attainable bound itself, not just the array sizes."""
    return single_processor_bound(shape.with_precision(_as_precision(prec)), M)


def mixed_precision_bound_ratio(shape: ConvShape, M: float, prec) -> float:
    """bound(quantized) / bound(shape's own precision): the factor by which
    the storage policy moves the Thm 2.1 bound for this shape (e.g. ~0.5 for
    int8-in/bf16-out vs bf16-in/f32-out in the memory-independent regime)."""
    base = single_processor_bound(shape, M).value
    return mixed_precision_bound(shape, M, prec).value / max(base, 1.0)


def mixed_precision_attention_bound(B: int, H: int, KV: int, Lq: int,
                                    Lk: int, hd: int, M: float,
                                    prec) -> BoundTerms:
    """:func:`attention_bound` under a quantized KV policy. For the serving
    decode regime (Lq = 1) the memory-independent term is the pure KV-cache
    stream at ``p_F`` words per element, so an int8 pool (p_F = 0.25) halves
    the decode bound relative to bf16 (p_F = 0.5) — the bound-level statement
    of what the quantized paged pool's doubled block capacity buys."""
    return attention_bound(B, H, KV, Lq, Lk, hd, M, prec=_as_precision(prec))
