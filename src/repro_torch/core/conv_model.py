"""The 7NL CNN computation model from the paper (§2.1).

A single convolution layer written as seven nested loops:

    for {i1..i7} = 0 : {N, c_I, c_O, w_O, h_O, w_F, h_F} - 1
        Output(i1,i3,i4,i5) += Input(i1,i2, sw*i4+i6, sh*i5+i7) * Filter(i2,i3,i6,i7)

Array sizes (paper §2.1):
    |I| = N * c_I * (sw*w_O + w_F) * (sh*h_O + h_F)
    |O| = N * c_O * w_O * h_O
    |F| = c_I * c_O * w_F * h_F
    G   = N * c_I * c_O * w_O * h_O * w_F * h_F     (total updates)

Precisions p_I, p_F, p_O are in *words* (the paper's unit, 32 bits); mixed
precision is first-class throughout.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Tuple


@dataclasses.dataclass(frozen=True)
class Precision:
    """Per-array word precisions (1.0 = one 32-bit word)."""

    p_I: float = 1.0
    p_F: float = 1.0
    p_O: float = 1.0

    @property
    def p_T(self) -> float:
        return self.p_I + self.p_F + self.p_O

    def triangle_ok(self) -> bool:
        """The paper's triangle condition: p_j <= p_k + p_l for all distinct j,k,l."""
        p = (self.p_I, self.p_F, self.p_O)
        return all(p[j] <= sum(p) - p[j] for j in range(3))

    def as_tuple(self) -> Tuple[float, float, float]:
        return (self.p_I, self.p_F, self.p_O)


# Common precision regimes on TPU (words of 32 bits).
FP32 = Precision(1.0, 1.0, 1.0)
BF16_ACC32 = Precision(0.5, 0.5, 1.0)  # bf16 in/filter, f32 accumulate (MXU native)
INT8_ACC32 = Precision(0.25, 0.25, 1.0)  # GEMMINI's regime (8-bit scratchpad words)


@dataclasses.dataclass(frozen=True)
class ConvShape:
    """Loop bounds of 7NL CNN.

    Paper assumptions (§2.1): w_F <= sw*w_O, h_F <= sh*h_O (filters smaller than
    images) and sw <= w_F, sh <= h_F (every input element used).
    """

    N: int  # batch (images)
    c_I: int  # input channels
    c_O: int  # output channels
    w_O: int  # output width
    h_O: int  # output height
    w_F: int  # filter width
    h_F: int  # filter height
    sw: int = 1  # horizontal stride
    sh: int = 1  # vertical stride
    prec: Precision = FP32

    def __post_init__(self):
        for name in ("N", "c_I", "c_O", "w_O", "h_O", "w_F", "h_F", "sw", "sh"):
            v = getattr(self, name)
            if not isinstance(v, int) or v < 1:
                raise ValueError(f"{name} must be a positive int, got {v!r}")

    # ---- sizes ------------------------------------------------------------
    @property
    def w_I(self) -> int:
        """Input width under the paper's convention (sw*w_O + w_F)."""
        return self.sw * self.w_O + self.w_F

    @property
    def h_I(self) -> int:
        return self.sh * self.h_O + self.h_F

    @property
    def input_size(self) -> int:
        return self.N * self.c_I * self.w_I * self.h_I

    @property
    def filter_size(self) -> int:
        return self.c_I * self.c_O * self.w_F * self.h_F

    @property
    def output_size(self) -> int:
        return self.N * self.c_O * self.w_O * self.h_O

    @property
    def G(self) -> int:
        """Total number of scalar updates."""
        return self.N * self.c_I * self.c_O * self.w_O * self.h_O * self.w_F * self.h_F

    @property
    def flops(self) -> int:
        return 2 * self.G  # one multiply + one add per update

    def words(self) -> float:
        """Total words of all three arrays (the memory-independent bound term)."""
        p = self.prec
        return p.p_I * self.input_size + p.p_F * self.filter_size + p.p_O * self.output_size

    # ---- helpers ----------------------------------------------------------
    def loop_bounds(self) -> Tuple[int, ...]:
        return (self.N, self.c_I, self.c_O, self.w_O, self.h_O, self.w_F, self.h_F)

    def with_precision(self, prec: Precision) -> "ConvShape":
        return dataclasses.replace(self, prec=prec)

    def assumptions_ok(self) -> bool:
        return (
            self.w_F <= self.sw * self.w_O
            and self.h_F <= self.sh * self.h_O
            and self.sw <= self.w_F
            and self.sh <= self.h_F
        )

    def arithmetic_intensity(self) -> float:
        """FLOPs per word touched (upper bound: each word touched once)."""
        return self.flops / self.words()


def matmul_as_conv(m: int, n: int, k: int, prec: Precision = FP32) -> ConvShape:
    """GEMM C[m,n] += A[m,k] B[k,n] as the degenerate 7NL CNN.

    Mapping: N=m (batch index = rows), c_I=k (reduction), c_O=n (cols),
    w_O=h_O=w_F=h_F=1, strides 1. Then G = m*n*k as expected and the
    second bound of Thm 2.1 becomes the classical (p_T^2/4) * mnk / M matmul
    bound (Loomis-Whitney / [12] in the paper).
    """
    return ConvShape(N=m, c_I=k, c_O=n, w_O=1, h_O=1, w_F=1, h_F=1, sw=1, sh=1, prec=prec)


# --- canonical layer shapes used by the paper's experiments -----------------
def resnet50_layers(batch: int = 1000) -> dict:
    """The five standard ResNet-50 convolution sizes [He et al. 2016], as used
    in the paper's §3.2/§5 experiments. conv1 is the 7x7/stride-2 stem; convN_x
    are the representative 3x3 convolutions of each stage.
    """
    return {
        "conv1": ConvShape(N=batch, c_I=3, c_O=64, w_O=112, h_O=112, w_F=7, h_F=7, sw=2, sh=2),
        "conv2_x": ConvShape(N=batch, c_I=64, c_O=64, w_O=56, h_O=56, w_F=3, h_F=3, sw=1, sh=1),
        "conv3_x": ConvShape(N=batch, c_I=128, c_O=128, w_O=28, h_O=28, w_F=3, h_F=3, sw=1, sh=1),
        "conv4_x": ConvShape(N=batch, c_I=256, c_O=256, w_O=14, h_O=14, w_F=3, h_F=3, sw=1, sh=1),
        "conv5_x": ConvShape(N=batch, c_I=512, c_O=512, w_O=7, h_O=7, w_F=3, h_F=3, sw=1, sh=1),
    }


def alexnet_layers(batch: int = 128) -> dict:
    """AlexNet convolution layers (paper §3.2 uses AlexNet parameters)."""
    return {
        "conv1": ConvShape(N=batch, c_I=3, c_O=96, w_O=55, h_O=55, w_F=11, h_F=11, sw=4, sh=4),
        "conv2": ConvShape(N=batch, c_I=96, c_O=256, w_O=27, h_O=27, w_F=5, h_F=5, sw=1, sh=1),
        "conv3": ConvShape(N=batch, c_I=256, c_O=384, w_O=13, h_O=13, w_F=3, h_F=3, sw=1, sh=1),
        "conv4": ConvShape(N=batch, c_I=384, c_O=384, w_O=13, h_O=13, w_F=3, h_F=3, sw=1, sh=1),
        "conv5": ConvShape(N=batch, c_I=384, c_O=256, w_O=13, h_O=13, w_F=3, h_F=3, sw=1, sh=1),
    }


def ceil_div(a: int, b: int) -> int:
    return -(-a // b)


def round_up(a: int, b: int) -> int:
    return ceil_div(a, b) * b


def prod(xs) -> int:
    return math.prod(xs)
