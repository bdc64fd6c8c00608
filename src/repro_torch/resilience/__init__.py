"""The runtime-failure taxonomy (``errors``), copied from
``repro.resilience``. Fault-injection campaigns (``repro.resilience.faults``)
are not ported yet."""

from .errors import (  # noqa: F401
    AdmissionImpossible,
    DeviceLost,
    FatalFault,
    Fault,
    KernelLaunchError,
    NumericFault,
    PoolIntegrityFault,
    SchedulerStall,
    TransientFault,
)
