"""``repro_torch.quant`` — the per-operand storage policy (``PrecisionSpec``)
that ``plan.target`` carries. Only the spec is ported; the int8 numerics and
kernels come with a later slice."""

from .spec import (  # noqa: F401
    DTYPE_WORDS,
    FP8_E4M3_SPEC,
    INT8_SPEC,
    KV_INT8_SPEC,
    NARROW_DTYPES,
    PrecisionSpec,
    dtype_words,
)
