"""``repro_torch.quant`` — mixed-precision / quantized execution policy (the
counterpart of ``repro.quant``): the per-operand storage policy
(``PrecisionSpec``) that ``plan.target`` carries, and the symmetric int8
numerics with folded per-output-channel scales that feed ``ops.conv2d_q`` /
``ops.matmul_q``."""

from .numerics import (  # noqa: F401
    dequantize,
    fold_output_scales,
    quantize_conv_operands,
    quantize_matmul_operands,
    quantize_symmetric,
)
from .spec import (  # noqa: F401
    DTYPE_WORDS,
    FP8_E4M3_SPEC,
    INT8_SPEC,
    KV_INT8_SPEC,
    NARROW_DTYPES,
    PrecisionSpec,
    dtype_words,
)
