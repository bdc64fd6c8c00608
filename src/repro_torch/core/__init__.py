"""Communication lower bounds and LP-optimal tilings for 7NL CNN
(Chen/Demmel/Dinh/Haberle/Holtz, PASC'22): the port of ``repro.core``.
Plain numpy + scipy: the shape model, the bounds, the HBL machinery, the
single-device blocking LP, the §4.2 parallel blocking LP and the mesh
sharding selection, and the modeled volumes of the five algorithms.
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
from .hbl import (  # noqa: F401
    Homomorphism,
    Subspace,
    constraint_table,
    conv7nl_lifted_phis,
    conv7nl_phis,
    hbl_constraints,
    matmul_phis,
    solve_exponents,
    subgroup_lattice,
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
from .parallel_tiling import (  # noqa: F401
    ParallelBlocking,
    optimize_parallel_blocking,
    parallel_efficiency,
)
from .sharding_opt import (  # noqa: F401
    ShardingPlan,
    plan_conv_sharding,
    plan_gemm_sharding,
    rank_lm_shardings,
)
from . import algorithms  # noqa: F401
