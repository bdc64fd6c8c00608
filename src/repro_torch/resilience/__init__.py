"""``repro_torch.resilience`` — the typed fault taxonomy + seeded fault
injection, the port of ``repro.resilience``.

``errors`` defines the :class:`TransientFault`/:class:`FatalFault` split the
dispatcher and serving engine recover by; ``faults`` the deterministic
:class:`FaultCampaign` harness that plants failures at named sites (and
proves every one was handled). See each module's docstring, and the README
for running a campaign on the port.
"""

from .errors import (  # noqa: F401
    AdmissionImpossible,
    DeviceLost,
    DmaTimeout,
    FatalFault,
    Fault,
    FaultAccountingError,
    KernelLaunchError,
    NumericFault,
    PoolIntegrityFault,
    SchedulerStall,
    TransientFault,
)
from .faults import (  # noqa: F401
    DISPATCH_KINDS,
    FAULT_KINDS,
    FAULTS_ENV,
    DispatchFaultHook,
    FaultCampaign,
    Injection,
    activate,
    active_campaign,
    campaign_from_spec,
    install,
    install_env_campaign,
)
