"""``repro_torch.plan`` — the planning subsystem (HardwareTarget ->
ExecutionPlan), the port of ``repro.plan`` without the measured autotuner.

    from repro_torch.plan import ConvSpec, Planner, H100

    ep = Planner(H100).plan(ConvSpec(N=32, c_I=64, c_O=64, w_O=56, h_O=56,
                                     w_F=3, h_F=3))
    ep.tiles          # (bN, b_cI, b_cO, b_hO, b_wO) for the conv2d kernel
    ep.comm_volume    # modeled HBM <-> shared-memory words
    ep.efficiency     # vs the Thm 2.1 lower bound

    Planner.cache.save(p)  # persist plans; .load/.clear/.size
"""

from .ops import (  # noqa: F401
    AttentionSpec,
    ConvSpec,
    MatmulSpec,
    OpSpec,
    as_op_spec,
)
from .planner import (  # noqa: F401
    PLAN_FORMAT_VERSION,
    ExecutionPlan,
    PlanCache,
    Planner,
    TunedSection,
    analytic_plan,
    resolve_kernel_plan,
    resolve_plan,
)
from .target import (  # noqa: F401
    CPU_INTERPRET,
    GEMMINI,
    H100,
    TARGETS,
    TPU_V5E,
    HardwareTarget,
    get_target,
)
