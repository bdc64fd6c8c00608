"""Communication lower bounds and LP-optimal tilings for 7NL CNN
(Chen/Demmel/Dinh/Haberle/Holtz, PASC'22): the single-processor slice of
``repro.core`` that the port's planner needs. Plain numpy + scipy; the
multi-device modules (``hbl``, ``parallel_tiling``, ``sharding_opt``,
``algorithms``) are not ported yet.
"""

from .conv_model import (  # noqa: F401
    BF16_ACC32,
    FP32,
    INT8_ACC32,
    ConvShape,
    Precision,
    alexnet_layers,
    matmul_as_conv,
    resnet50_layers,
)
from .bounds import (  # noqa: F401
    BoundTerms,
    C_p,
    combined_parallel_bound,
    matmul_bound,
    memory_independent_parallel_bound,
    parallel_bound,
    single_processor_bound,
    small_filter_regime,
)
from .tiling import (  # noqa: F401
    GEMMINI,
    TPU_VMEM,
    TPU_VMEM_WORDS,
    Blocking,
    MemoryModel,
    blocking_efficiency,
    fit_conv_kernel_tiles,
    matmul_tiles,
    optimize_blocking,
)
