"""Operation specs: what the planner is asked to lower.

``OpSpec = ConvSpec | MatmulSpec | AttentionSpec`` — all hashable value
objects so the pair (op, target) keys the process-wide plan cache. ``prec=None`` defers the
precision choice to the target's policy; an explicit ``Precision`` (e.g. built
from the input dtype by the kernels) overrides it.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Union

from repro_torch.core.conv_model import ConvShape, Precision, matmul_as_conv


@dataclasses.dataclass(frozen=True)
class ConvSpec:
    """The 7NL CNN of paper §2.1 (output-size parameterization, as ConvShape)."""

    N: int
    c_I: int
    c_O: int
    w_O: int
    h_O: int
    w_F: int
    h_F: int
    sw: int = 1
    sh: int = 1
    prec: Optional[Precision] = None

    @classmethod
    def from_shape(cls, shape: ConvShape) -> "ConvSpec":
        return cls(N=shape.N, c_I=shape.c_I, c_O=shape.c_O, w_O=shape.w_O,
                   h_O=shape.h_O, w_F=shape.w_F, h_F=shape.h_F, sw=shape.sw,
                   sh=shape.sh, prec=shape.prec)

    def to_shape(self, default_prec: Precision) -> ConvShape:
        return ConvShape(N=self.N, c_I=self.c_I, c_O=self.c_O, w_O=self.w_O,
                         h_O=self.h_O, w_F=self.w_F, h_F=self.h_F, sw=self.sw,
                         sh=self.sh, prec=self.prec or default_prec)

    def to_dict(self) -> Dict[str, Any]:
        return {"kind": "conv", "N": self.N, "c_I": self.c_I, "c_O": self.c_O,
                "w_O": self.w_O, "h_O": self.h_O, "w_F": self.w_F,
                "h_F": self.h_F, "sw": self.sw, "sh": self.sh,
                "prec": None if self.prec is None else list(self.prec.as_tuple())}


@dataclasses.dataclass(frozen=True)
class MatmulSpec:
    """C[m,n] += A[m,k] B[k,n] as the degenerate 7NL CNN (N=m, c_I=k, c_O=n)."""

    m: int
    n: int
    k: int
    prec: Optional[Precision] = None

    def to_shape(self, default_prec: Precision) -> ConvShape:
        return matmul_as_conv(self.m, self.n, self.k, self.prec or default_prec)

    def to_dict(self) -> Dict[str, Any]:
        return {"kind": "matmul", "m": self.m, "n": self.n, "k": self.k,
                "prec": None if self.prec is None else list(self.prec.as_tuple())}


@dataclasses.dataclass(frozen=True)
class AttentionSpec:
    """GQA attention as two chained 7NL degenerates (QK^T then PV).

    ``Lq`` is the per-head query length *before* any GQA group folding (the
    planner accounts the fold itself); ``Lk`` the key/value length; ``KV``
    the number of distinct KV heads (``KV | H``). Decode is ``Lq == 1``.
    ``prec`` maps (p_I, p_F, p_O) -> (query, key/value, output) stream
    widths."""

    B: int
    H: int
    KV: int
    Lq: int
    Lk: int
    hd: int
    prec: Optional[Precision] = None

    def to_shape(self, default_prec: Precision) -> ConvShape:
        raise TypeError("attention ops have no single ConvShape view; "
                        "the planner bounds them via core.bounds.attention_bound")

    def to_dict(self) -> Dict[str, Any]:
        return {"kind": "attention", "B": self.B, "H": self.H, "KV": self.KV,
                "Lq": self.Lq, "Lk": self.Lk, "hd": self.hd,
                "prec": None if self.prec is None else list(self.prec.as_tuple())}


OpSpec = Union[ConvSpec, MatmulSpec, AttentionSpec]


def op_from_dict(d: Dict[str, Any]) -> OpSpec:
    prec = None if d.get("prec") is None else Precision(*d["prec"])
    if d["kind"] == "conv":
        return ConvSpec(N=d["N"], c_I=d["c_I"], c_O=d["c_O"], w_O=d["w_O"],
                        h_O=d["h_O"], w_F=d["w_F"], h_F=d["h_F"], sw=d["sw"],
                        sh=d["sh"], prec=prec)
    if d["kind"] == "matmul":
        return MatmulSpec(m=d["m"], n=d["n"], k=d["k"], prec=prec)
    if d["kind"] == "attention":
        return AttentionSpec(B=d["B"], H=d["H"], KV=d["KV"], Lq=d["Lq"],
                             Lk=d["Lk"], hd=d["hd"], prec=prec)
    raise ValueError(f"unknown op kind {d.get('kind')!r}")


def as_op_spec(op: Union[OpSpec, ConvShape]) -> OpSpec:
    """Coerce a raw ConvShape (or pass through an OpSpec)."""
    if isinstance(op, (ConvSpec, MatmulSpec, AttentionSpec)):
        return op
    if isinstance(op, ConvShape):
        return ConvSpec.from_shape(op)
    raise TypeError(f"cannot plan {type(op).__name__}; "
                    "expected ConvSpec, MatmulSpec, AttentionSpec, or ConvShape")
