"""Structured runtime-failure taxonomy for dispatch, serving, and the mesh
(a copy of ``repro.resilience.errors``).

Every runtime failure in the execution stack is either **transient** (retry
or demote to a cheaper backend and keep serving) or **fatal** (no amount of
retrying helps; surface it). The split is the contract the graceful-
degradation machinery is built on:

  * ``repro_torch.ops.dispatch`` catches :class:`TransientFault` from a
    kernel entry, quarantines the failing ``(op, backend, shape-key)``, and
    re-dispatches down the fallback chain with the degradation re-priced
    (``DispatchDecision.degraded``/``fault``);
  * ``serving.Engine`` catches transients at admission/decode and converts
    them into bounded retries, row-level failures (``finish_reason="error"``)
    or backpressure — never a poisoned lockstep batch;
  * :class:`FatalFault` always propagates.

Everything subclasses ``RuntimeError`` so pre-taxonomy callers (and tests)
that catch ``RuntimeError`` keep working; ``serving.kv.BlockOOM`` is
reclassified as a :class:`TransientFault` subclass for the same reason.

Faults carry structured context: ``op``/``backend`` name the failing
dispatch, ``injection`` points at the :class:`repro_torch.resilience.faults.
Injection` record when a campaign planted the fault (None for organic
failures), and free-form keyword ``diagnostics`` (pool occupancy, shape
keys, deadlines) ride along for the operator instead of being baked into
the message string.
"""

from __future__ import annotations

from typing import Any, Dict, Optional


class Fault(RuntimeError):
    """Base of the typed failure taxonomy (see module docstring)."""

    transient: bool = False

    def __init__(self, message: str = "", *, op: Optional[str] = None,
                 backend: Optional[str] = None, injection: Any = None,
                 **diagnostics: Any):
        super().__init__(message)
        self.op = op
        self.backend = backend
        self.injection = injection
        self.diagnostics: Dict[str, Any] = dict(diagnostics)

    def __str__(self) -> str:
        base = super().__str__()
        ctx = []
        if self.op is not None:
            ctx.append(f"op={self.op}")
        if self.backend is not None:
            ctx.append(f"backend={self.backend}")
        ctx.extend(f"{k}={v}" for k, v in sorted(self.diagnostics.items()))
        return f"{base} [{', '.join(ctx)}]" if ctx else base


class TransientFault(Fault):
    """Recoverable: retry in place, demote along the fallback chain, or
    degrade the single affected request — the system keeps serving."""

    transient = True


class FatalFault(Fault):
    """Unrecoverable: no retry/demotion policy applies; must propagate."""

    transient = False


class KernelLaunchError(TransientFault):
    """A kernel entry failed at launch (lowering/launch-time error). The
    dispatcher demotes the call to the next backend in the chain."""


class NumericFault(TransientFault):
    """An op produced NaN/Inf output. Idempotent call sites (decode steps
    rewrite the same cache positions with the same values) retry; persistent
    non-finite logits fail only the affected batch rows."""


class DmaTimeout(TransientFault):
    """A manual DMA (async copy) never landed within its window — treated
    exactly like a launch failure: demote and quarantine."""


class PoolIntegrityFault(TransientFault):
    """A ``kv.BlockAllocator.check()`` invariant is broken (leaked block,
    dangling prefix key, phantom refcount). Transient because the engine can
    rebuild the pool from host-side request state (prompts + accepted
    tokens) without losing any request."""


class DeviceLost(FatalFault):
    """The accelerator is gone. Nothing downstream of the dispatch can
    recover this; the caller (or its supervisor) must re-plan placement."""


class AdmissionImpossible(FatalFault):
    """No schedule could ever admit this request — e.g. the paged KV pool is
    too small for the prompt even with every slot free. Retrying the same
    configuration can never succeed; the pool must be resized."""


class SchedulerStall(FatalFault):
    """The serving loop made no progress for an implausible number of
    scheduling rounds — the never-deadlock backstop for pathological
    (rate=1, unbounded) fault campaigns."""


class FaultAccountingError(FatalFault):
    """A campaign injection was swallowed: some handler caught a planted
    fault without recording a resolution. Raised by
    ``FaultCampaign.verify_accounted()`` — the check the ``fault_swallowed``
    seeded mutant exists to exercise."""
