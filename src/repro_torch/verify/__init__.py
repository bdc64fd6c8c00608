"""``repro_torch.verify`` — static communication auditor, copy-hazard
detector, lint: the port of ``repro.verify``.

No device required: the auditor abstractly interprets each CUDA kernel's
launch (its CTAs, the ring stages each walks, the windows each stage
copies) and computes the exact global-memory words it moves, which must
reproduce the op's ``words_fn`` to the last word, and reports what the
kernel issues beyond the counter (and what the counter charges that it does
not issue); the hazard detector simulates the kernels' ``cp.async`` rings
(commit groups, ``wait_group``, ``__syncthreads``, ``cluster.sync``)
against wait/reuse/overlap/barrier rules; the lint walks the source tree
and the live registry for structural invariants
(``python -m repro_torch.verify.lint``).

Entry points:

    from repro_torch import verify
    report = verify.audit_decision(access_plan, decision)   # one dispatch
    verify.install_plan_audit()       # validate every freshly built plan
    scripts/verify_torch.py           # the registered-op sweep + mutants
"""

from .access import (  # noqa: F401
    BlockAccess,
    CudaLaunch,
    FlatAccess,
    KernelAccessPlan,
    ScratchAlloc,
    WindowAccess,
)
from .audit import (  # noqa: F401
    AuditError,
    AuditReport,
    PlanAuditError,
    audit_access_plan,
    audit_decision,
    install_plan_audit,
    validate_execution_plan,
)
from .hazards import (  # noqa: F401
    DmaEvent,
    DmaSchedule,
    Hazard,
    Program,
    check_schedule,
    double_buffered_schedule,
    ring_schedule,
)
