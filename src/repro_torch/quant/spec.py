"""Per-operand precision policy: which dtype each operand is *stored* in.

The paper's ``Precision`` (core.conv_model) speaks word-widths — p_I, p_F,
p_O in units of 32-bit words — which is exactly what the Thm 2.1 bounds and
the blocking LP consume. A :class:`PrecisionSpec` is the dtype-level view of
the same policy: it names the storage dtype of every operand (input, filter,
output) plus the in-kernel accumulation dtype, and projects down to a
``Precision`` so the whole planning stack (LP words objective,
``conv_kernel_footprints`` VMEM fits, Thm 2.1 bounds) prices each operand at
its stored width. Narrower storage therefore *moves the bound itself* —
int8 streams buy ~2x bigger LP tiles and halve the memory-independent term
relative to bf16 (cf. "Communication Lower Bound in Convolution
Accelerators", arxiv 1911.05662) — rather than merely shrinking the
arrays after the plan is fixed.

Rules the lint (VRF013) and the constructor both enforce: a spec whose
storage includes a sub-16-bit dtype (int8 / fp8) must accumulate in f32 or
wider — low-precision operands, high-precision accumulator, the discipline
every kernel in ``kernels/`` follows.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Tuple

from repro_torch.core.conv_model import Precision

# Canonical storage widths in 32-bit words (the paper's unit). Keys are
# normalized jnp-style dtype names; fp8 variants share int8's width but keep
# distinct names so plans and benchmarks can tell them apart.
DTYPE_WORDS: Dict[str, float] = {
    "float32": 1.0,
    "int32": 1.0,
    "bfloat16": 0.5,
    "float16": 0.5,
    "int8": 0.25,
    "float8_e4m3fn": 0.25,
    "float8_e5m2": 0.25,
}

# dtypes the VRF013 lint treats as "narrow storage" (must declare f32+ accum)
NARROW_DTYPES = frozenset(
    name for name, w in DTYPE_WORDS.items() if w <= 0.25)


def dtype_words(name: str) -> float:
    """Storage width of a dtype name in 32-bit words (e.g. 'int8' -> 0.25)."""
    key = str(name).lower()
    try:
        return DTYPE_WORDS[key]
    except KeyError:
        raise ValueError(
            f"unknown storage dtype {name!r}; known: {sorted(DTYPE_WORDS)}")


@dataclasses.dataclass(frozen=True)
class PrecisionSpec:
    """Per-operand storage dtypes + accumulation dtype + scale granularity.

    ``scale_granularity`` documents how quantization scales are laid out:
    ``"per_channel"`` (one scale per output channel, folded input x filter —
    what ``kernels.quant`` streams) or ``"per_tensor"``. The accumulator is
    never narrower than f32 (enforced here and by lint rule VRF013).
    """

    input_dtype: str = "int8"
    filter_dtype: str = "int8"
    out_dtype: str = "bfloat16"
    acc_dtype: str = "float32"
    scale_granularity: str = "per_channel"

    def __post_init__(self):
        for name in (self.input_dtype, self.filter_dtype, self.out_dtype):
            dtype_words(name)  # raises on unknown dtypes
        if dtype_words(self.acc_dtype) < 1.0:
            raise ValueError(
                f"accumulation dtype {self.acc_dtype!r} is narrower than "
                "f32; quantized kernels must accumulate at full precision")
        if self.scale_granularity not in ("per_channel", "per_tensor"):
            raise ValueError(
                f"unknown scale granularity {self.scale_granularity!r}")

    @property
    def precision(self) -> Precision:
        """Project to the paper's word-width triple (feeds bounds + LP)."""
        return Precision(p_I=dtype_words(self.input_dtype),
                         p_F=dtype_words(self.filter_dtype),
                         p_O=dtype_words(self.out_dtype))

    def operand_dtypes(self) -> Tuple[Tuple[str, str], ...]:
        """The per-operand dtype map plan format v5 carries."""
        return (("input", self.input_dtype), ("filter", self.filter_dtype),
                ("output", self.out_dtype), ("accum", self.acc_dtype))

    @property
    def is_quantized(self) -> bool:
        return (self.input_dtype in NARROW_DTYPES
                or self.filter_dtype in NARROW_DTYPES)

    # -- (de)serialization (rides HardwareTarget.to_dict) --------------------
    def to_dict(self) -> Dict[str, Any]:
        return {
            "input_dtype": self.input_dtype,
            "filter_dtype": self.filter_dtype,
            "out_dtype": self.out_dtype,
            "acc_dtype": self.acc_dtype,
            "scale_granularity": self.scale_granularity,
        }

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "PrecisionSpec":
        return cls(
            input_dtype=d.get("input_dtype", "int8"),
            filter_dtype=d.get("filter_dtype", "int8"),
            out_dtype=d.get("out_dtype", "bfloat16"),
            acc_dtype=d.get("acc_dtype", "float32"),
            scale_granularity=d.get("scale_granularity", "per_channel"),
        )


# Presets. INT8_SPEC is what `ops.conv2d_q` / `ops.matmul_q` implement: int8
# input+filter streams, f32 accumulation, bf16 stores. The fp8 variants share
# its word-widths (the LP and bounds cannot tell them apart) but no kernel
# implements them yet — they exist so plans/targets can already describe
# fp8-storage hardware.
INT8_SPEC = PrecisionSpec()
FP8_E4M3_SPEC = PrecisionSpec(input_dtype="float8_e4m3fn",
                              filter_dtype="float8_e4m3fn")
KV_INT8_SPEC = PrecisionSpec(out_dtype="float32", scale_granularity="per_channel")
