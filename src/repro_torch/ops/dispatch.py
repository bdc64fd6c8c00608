"""The dispatcher: resolve each op call to (ExecutionPlan, backend kernel).
The counterpart of ``repro.ops.dispatch``, with its runtime-fault layer.

``resolve(op, ctx, ...)`` takes the requested backend's entry when its
declared capabilities (dtype, and the call features ``needs`` such as
``per_row_q_offset`` or ``key_mask``) cover the call. When they do not, a
``device="cpu"``
context takes the backend's one ``fallback``; a ``device="cuda"`` context
raises, so a tensor on the card runs a hand-written kernel or nothing. It then
resolves the LP plan for entries that declare a ``spec_fn`` (through the
process-wide plan cache), and returns a :class:`DispatchDecision` — the
explain/trace record tests and tools assert against.

Observability:

  * ``explain(op, ctx, ...)``    - the decision, without executing anything
                                   (meta tensors work: only shapes/dtypes
                                   are consulted);
  * ``record_dispatch()``        - context manager capturing every decision
                                   made while it is active;
  * ``capture_decisions()``      - the decisions of a CUDA graph's capture,
                                   kept out of those logs; each replay adds
                                   them with ``credit_decisions``.

Runtime-failure fallback (``repro_torch.resilience``): capability
resolution only proves an entry *claims* to serve the call. When the chosen
entry actually raises a ``TransientFault`` at execution, ``dispatch_call``
quarantines the failing ``(op, backend, shape-key)``, re-resolves (an entry
may name an instrumented ``degrade_to`` backend so the demotion stays
priced), and retries — the resulting decision records ``degraded=True`` +
the fault name, with ``measured_words``/``bound_ratio`` re-priced for the
backend that actually served the call. A quarantined combination is probed
again after ``QUARANTINE_PROBE_AFTER`` dispatches. ``FatalFault`` and every
error outside the taxonomy (a CUDA wrapper's failed launch among them)
propagate. Where the next backend is taken from differs from the reference
by device: a ``device="cpu"`` context takes the entry's ``degrade_to``, else
the backend's ``fallback``, as the reference takes ``xla``; a
``device="cuda"`` context takes ``degrade_to`` or nothing, never aten, and
with nothing retries in place. The ``REPRO_FAULTS`` env knob installs a
seeded ``resilience.FaultCampaign`` at the first dispatch.

The reference's fault hook stands down under ``jax.jit`` tracing. The
port's counterpart is :func:`traced`, a scope the engine's compiled steps
and the trainer's step run in, and a CUDA graph's capture: there the hook
makes no draw and no finiteness check; the quarantine still applies.
"""

from __future__ import annotations

import contextlib
import dataclasses
import numbers
import os
from typing import Any, Dict, List, Optional, Tuple

import torch

from repro_torch import dtensors
from repro_torch.resilience.errors import TransientFault

from .context import ExecutionContext, default_context
from .registry import Backend, OpEntry, dtype_name, get_backend

MAX_FALLBACK_DEPTH = 4  # registry misconfiguration guard, not a real limit
# runtime-fallback executor: per-call bound on demote/retry attempts
MAX_RUNTIME_ATTEMPTS = 4
# a quarantined (op, backend, shape-key) is probed again on the Nth dispatch
QUARANTINE_PROBE_AFTER = 8


@dataclasses.dataclass(frozen=True)
class DispatchDecision:
    """Why one call ran where it did — and what it moved.

    ``requested`` is the backend the context resolved to; ``chosen`` the one
    that served the call; ``missing`` the capabilities whose absence forced
    the (CPU-only) fallback; ``plan`` the ExecutionPlan the chosen entry consumed
    (None for aten entries); ``plan_source`` ``"explicit"``, ``"tuned"``
    (the measured autotuner's stored winner) or ``"analytic"``;
    ``measured_words`` the words (32-bit) the chosen
    kernel's launch geometry moves for this call (None when the entry is not
    instrumented): HBM words for single-device ops, *inter-device* words per
    device for the distributed ops, reported via ``bound_ratio`` against the
    matching bound: the plan's Thm 2.1 ``lower_bound``, or the plan's
    ``parallel`` section's Thm 2.2/2.3 bound for ``*_dist`` ops.

    ``audited`` is the static auditor's independent word count (set only
    when the call resolved with ``audit=True``): ``repro_torch.verify``
    abstractly interprets the entry's :class:`KernelAccessPlan` (the CUDA
    launch's CTAs and ring stages, the windows they copy) and raises
    ``verify.AuditError`` unless it reproduces ``measured_words`` exactly,
    fits the CTA's shared memory, stays at/below the recorded bound ratio,
    and every ring schedule is hazard-free; so when this field is set it
    *equals* ``measured_words``. ``audit_report`` keeps the auditor's whole
    report (issued words, the words the counter does not charge, the
    shortfall), which the reference's decision does not carry.

    ``degraded``/``fault`` record *runtime* demotion: a backend is
    quarantined after actually raising the named ``TransientFault``
    (``"KernelLaunchError"``, ``"NumericFault"``, ...), so the call was
    served by another backend than capabilities alone required —
    ``measured_words``/``bound_ratio`` are re-priced for the backend that
    ran, making the communication cost of degradation visible in
    ``ops.explain``."""

    op: str
    requested: str
    chosen: str
    missing: Tuple[str, ...] = ()
    plan: Optional[Any] = None
    plan_source: str = "analytic"  # "explicit" | "tuned" | "analytic"
    measured_words: Optional[float] = None
    audited: Optional[float] = None
    audit_report: Optional[Any] = dataclasses.field(default=None,
                                                    compare=False, repr=False)
    degraded: bool = False
    fault: Optional[str] = None

    @property
    def fell_back(self) -> bool:
        return self.chosen != self.requested

    @property
    def lower_bound(self) -> Optional[float]:
        """The bound ``measured_words`` is compared against: Thm 2.2/2.3
        (per-processor) for distributed ops, Thm 2.1 otherwise."""
        if self.plan is None:
            return None
        if self.op.endswith("_dist"):
            if self.plan.parallel is None:
                return None  # planned for a single-device target
            return self.plan.parallel.lower_bound
        return self.plan.lower_bound

    @property
    def bound_ratio(self) -> Optional[float]:
        """measured words / the communication lower bound."""
        lb = self.lower_bound
        if self.measured_words is None or lb is None:
            return None
        return self.measured_words / max(lb, 1.0)

    def why(self) -> str:
        if self.degraded:
            msg = (f"{self.op}: runtime {self.fault} quarantined the "
                   f"primary backend; degraded from {self.requested!r} to "
                   f"{self.chosen!r} (words re-priced)")
        elif not self.fell_back:
            msg = f"{self.op}: ran on requested backend {self.chosen!r}"
        else:
            msg = (f"{self.op}: {self.requested!r} lacks "
                   f"{', '.join(self.missing)}; fell back to {self.chosen!r}")
        if self.plan is not None:
            msg += f"; {self.plan_source} plan"
            tuned = getattr(self.plan, "tuned", None)
            if tuned is not None:
                msg += (f" ({tuned.candidates_timed} candidates timed via "
                        f"{tuned.source}, winner {tuned.winner_seconds:.2e}s "
                        f"vs analytic)")
        if self.measured_words is not None:
            kind = ("inter-device" if self.op.endswith("_dist") else "HBM")
            msg += f"; measured {self.measured_words:.3e} {kind} words"
            if self.bound_ratio is not None:
                msg += (f" = {self.bound_ratio:.2f}x the "
                        f"{self.lower_bound:.3e}-word lower bound")
        if self.audited is not None:
            msg += " (statically audited)"
        return msg


_TRACE: List[List[DispatchDecision]] = []  # stack of active recorders
_CAPTURES: List[List[DispatchDecision]] = []  # active graph captures


def _remove(stack: list, log: list) -> None:
    # remove by identity: nested recorders hold equal (e.g. empty) lists
    for i, entry in enumerate(stack):
        if entry is log:
            del stack[i]
            break


@contextlib.contextmanager
def record_dispatch():
    """Capture every DispatchDecision made while active (trace API)."""
    log: List[DispatchDecision] = []
    _TRACE.append(log)
    try:
        yield log
    finally:
        _remove(_TRACE, log)


@contextlib.contextmanager
def capture_decisions():
    """While active (a CUDA graph's capture, which executes nothing) every
    decision goes to the yielded list and to no ``record_dispatch`` log;
    each replay of the graph adds them there with
    :func:`credit_decisions`."""
    log: List[DispatchDecision] = []
    _CAPTURES.append(log)
    try:
        yield log
    finally:
        _remove(_CAPTURES, log)


def credit_decisions(decisions: List[DispatchDecision]) -> None:
    """Add one replay's captured decisions to every active
    ``record_dispatch`` log."""
    for log in _TRACE:
        log.extend(decisions)


def _publish(decision: DispatchDecision) -> None:
    if _CAPTURES:
        _CAPTURES[-1].append(decision)
        return
    for log in _TRACE:
        log.append(decision)


def _lacks(backend: Backend, op: str, dtype: Optional[str],
           needs: Tuple[str, ...]
           ) -> Tuple[Optional[OpEntry], Tuple[str, ...]]:
    entry = backend.ops.get(op)
    if entry is None:
        return None, (f"op:{op}",)
    return entry, entry.caps.missing(dtype=dtype, needs=needs)


# ---------------------------------------------------------------------------
# Runtime-failure state: the quarantine table and the fault-injection hook.
# ---------------------------------------------------------------------------

# (op, backend, shape-key) -> {"fault": taxonomy class name, "probe_in": N}.
# Populated by dispatch_call when an entry raises a TransientFault; consulted
# by _resolve_entry so subsequent calls demote past the failing backend.
# probe_in decrements only on executing dispatches; at zero the entry is
# removed and the primary backend is probed again.
_QUARANTINE: Dict[Tuple[str, str, Any], Dict[str, Any]] = {}

_FAULT_HOOK: Optional[Any] = None  # resilience.faults.DispatchFaultHook
_ENV_FAULTS_CHECKED = False
_TRACED = 0  # depth of active traced() scopes


def set_fault_hook(hook) -> None:
    """Install/remove the campaign dispatch hook (``resilience.faults``)."""
    global _FAULT_HOOK
    _FAULT_HOOK = hook


def _ensure_env_faults() -> None:
    """First-dispatch check of the ``REPRO_FAULTS`` env knob."""
    global _ENV_FAULTS_CHECKED
    if _ENV_FAULTS_CHECKED:
        return
    _ENV_FAULTS_CHECKED = True
    if os.environ.get("REPRO_FAULTS"):
        from repro_torch.resilience.faults import install_env_campaign

        install_env_campaign()


def quarantined() -> Dict[Tuple[str, str, Any], Dict[str, Any]]:
    """A snapshot of the quarantine table (introspection/tests)."""
    return {k: dict(v) for k, v in _QUARANTINE.items()}


def clear_quarantine() -> None:
    """Forget every runtime quarantine (benchmarks reset between runs)."""
    _QUARANTINE.clear()


@contextlib.contextmanager
def traced():
    """The port's counterpart of running under ``jax.jit`` tracing: while
    active, dispatches run as the reference's do inside a jitted function,
    the fault hook making no draw and no finiteness check (the quarantine
    still applies). The engine's compiled steps, the decode graphs and the
    trainer's step run inside it; a CUDA graph's capture counts as inside
    it too."""
    global _TRACED
    _TRACED += 1
    try:
        yield
    finally:
        _TRACED -= 1


def _is_tracing() -> bool:
    return _TRACED > 0 or (torch.cuda.is_initialized()
                           and torch.cuda.is_current_stream_capturing())


def _freeze_kw(v):
    """A hashable, deterministic stand-in for one spec kwarg value; None for
    ambient objects that don't shape the quarantine."""
    if v is None or isinstance(v, (bool, int, float, str)):
        return v
    if isinstance(v, tuple):
        return tuple(_freeze_kw(x) for x in v)
    if isinstance(v, torch.dtype):
        return dtype_name(v)
    return None


def _shape_key(needs: Tuple[str, ...], spec_args: Optional[tuple],
               spec_kw: Optional[dict]):
    """The quarantine granularity: a kernel that faults on one launch
    geometry is demoted for that geometry only, not for the whole op."""
    if spec_args is None:
        return (needs,)
    arrs = tuple((tuple(getattr(a, "shape", ())),
                  dtype_name(a.dtype) if hasattr(a, "dtype") else "")
                 for a in spec_args)
    kws = tuple((k, _freeze_kw(v))
                for k, v in sorted((spec_kw or {}).items()))
    return (needs, arrs, kws)


def _on_card(ctx: ExecutionContext) -> bool:
    return torch.device(ctx.device).type == "cuda"


def _demote_to(entry: OpEntry, backend: Backend,
               on_card: bool) -> Optional[str]:
    """The backend a faulting entry demotes to: its ``degrade_to``, else
    (on the CPU only) its backend's ``fallback``; None = retry in place."""
    if entry.degrade_to is not None:
        return entry.degrade_to
    return None if on_card else backend.fallback


def _resolve_entry(op: str, ctx: ExecutionContext, dtype: Optional[str],
                   needs: Tuple[str, ...], shape_key: Any = None,
                   probe: bool = False) -> Tuple[OpEntry, DispatchDecision]:
    requested = ctx.resolved_backend()
    on_card = _on_card(ctx)
    name: Optional[str] = requested
    missing: Tuple[str, ...] = ()
    degraded = False
    fault: Optional[str] = None
    for _ in range(MAX_FALLBACK_DEPTH):
        if name is None:
            break
        backend = get_backend(name)
        entry, lacks = _lacks(backend, op, dtype, needs)
        if not lacks:
            q = _QUARANTINE.get((op, name, shape_key))
            if q is not None and probe:
                q["probe_in"] -= 1
                if q["probe_in"] <= 0:  # probe the primary again
                    del _QUARANTINE[(op, name, shape_key)]
                    q = None
            nxt = _demote_to(entry, backend, on_card)
            if q is not None and nxt is not None:
                missing = missing + (f"fault:{q['fault']}",)
                degraded, fault = True, q["fault"]
                name = nxt
                continue
            return entry, DispatchDecision(op=op, requested=requested,
                                           chosen=name, missing=missing,
                                           degraded=degraded, fault=fault)
        if on_card:
            raise NotImplementedError(
                f"{op}: backend {name!r} lacks {', '.join(lacks)}; on the "
                f"card no aten op stands in for its kernel")
        missing = missing + lacks
        name = backend.fallback
    raise NotImplementedError(
        f"no registered backend can serve op {op!r} (requested "
        f"{requested!r}, dtype={dtype}, call features {needs}; missing: "
        f"{missing})")


def _attach_plan_and_words(entry: OpEntry, decision: DispatchDecision,
                           ctx: ExecutionContext,
                           spec_args: Optional[tuple],
                           spec_kw: Optional[dict],
                           plan: Optional[Any] = None) -> DispatchDecision:
    """Resolve the entry's plan (explicit ``plan`` > tuned > analytic LP)
    and its measured-HBM-words counter; both need only shapes/dtypes."""
    if spec_args is None:
        return decision
    kw = spec_kw or {}
    if plan is not None:
        decision = dataclasses.replace(decision, plan=plan,
                                       plan_source="explicit")
    elif entry.spec_fn is not None:
        resolved, source = ctx.plan_with_source(entry.spec_fn(*spec_args,
                                                              **kw))
        decision = dataclasses.replace(decision, plan=resolved,
                                       plan_source=source)
    if entry.words_fn is not None:
        decision = dataclasses.replace(
            decision,
            measured_words=entry.words_fn(ctx, decision.plan,
                                          *spec_args, **kw))
    return decision


def _maybe_audit(entry: OpEntry, decision: DispatchDecision,
                 ctx: ExecutionContext, spec_args: Optional[tuple],
                 spec_kw: Optional[dict], audit: bool) -> DispatchDecision:
    """Opt-in static audit: build the entry's KernelAccessPlan, abstractly
    interpret it, and stamp the audited word count on the decision. Raises
    ``repro_torch.verify.AuditError`` on any mismatch/violation/hazard. Lazy
    import keeps the hot dispatch path free of the verify machinery."""
    if not audit or spec_args is None or entry.access_plan_fn is None:
        return decision
    from repro_torch.verify import audit as _audit

    ap = entry.access_plan_fn(ctx, decision.plan, *spec_args,
                              **(spec_kw or {}))
    report = _audit.audit_decision(ap, decision, target=ctx.target)
    if not report.ok:
        raise _audit.AuditError(report)
    return dataclasses.replace(decision, audited=report.counted_words,
                               audit_report=report)


def _dtype(dtype) -> Optional[str]:
    return None if dtype is None else dtype_name(dtype)


def resolve(op: str, ctx: Optional[ExecutionContext] = None,
            dtype: Optional[str] = None, needs: Tuple[str, ...] = (),
            spec_args: Optional[tuple] = None, spec_kw: Optional[dict] = None,
            audit: bool = False,
            plan: Optional[Any] = None) -> Tuple[OpEntry, DispatchDecision]:
    """Capability-resolve one call; resolve the entry's plan and measured
    HBM-word counter if it declares them. ``audit=True`` also runs the
    ``repro_torch.verify`` static auditor against the chosen entry's access
    plan (raising on any mismatch or hazard). Quarantine-aware (a runtime-
    quarantined backend is skipped, the decision marked ``degraded``) but
    never consumes quarantine probes — only executing dispatches do.
    Records the decision."""
    entry, decision = _explain_entry(op, ctx, dtype, needs, spec_args,
                                     spec_kw, plan, audit)
    _publish(decision)
    return entry, decision


def _explain_entry(op, ctx=None, dtype=None, needs=(), spec_args=None,
                   spec_kw=None, plan=None, audit=False
                   ) -> Tuple[OpEntry, DispatchDecision]:
    ctx = default_context() if ctx is None else ctx
    needs = tuple(needs)
    entry, decision = _resolve_entry(
        op, ctx, _dtype(dtype), needs,
        shape_key=_shape_key(needs, spec_args, spec_kw))
    decision = _attach_plan_and_words(entry, decision, ctx, spec_args,
                                      spec_kw, plan=plan)
    return entry, _maybe_audit(entry, decision, ctx, spec_args, spec_kw,
                               audit)


def explain(op: str, ctx: Optional[ExecutionContext] = None,
            dtype: Optional[str] = None, needs: Tuple[str, ...] = (),
            spec_args: Optional[tuple] = None,
            spec_kw: Optional[dict] = None,
            audit: bool = False,
            plan: Optional[Any] = None) -> DispatchDecision:
    """The decision ``resolve`` would make, without executing anything.
    ``spec_args``/``spec_kw`` mirror the op's call (e.g. conv2d needs
    ``stride=``) so the reported plan and measured words are the ones the
    dispatched kernel would consume; meta tensors work. ``audit=True`` runs
    the static communication auditor and stamps
    ``DispatchDecision.audited``."""
    return _explain_entry(op, ctx, dtype, needs, spec_args, spec_kw, plan,
                          audit)[1]


def dispatch_call(op: str, ctx: ExecutionContext, dtype: Optional[str],
                  needs: Tuple[str, ...], spec_args: tuple,
                  spec_kw: Optional[dict] = None,
                  call_args: Optional[tuple] = None,
                  call_kw: Optional[dict] = None,
                  plan: Optional[Any] = None):
    """Resolve AND execute one op call with runtime-failure fallback.
    ``plan=`` forces an explicit ExecutionPlan onto the chosen entry.

    The public op wrappers funnel through here: resolve (quarantine-aware,
    consuming probes), price the plan/words, run the entry — through the
    fault-injection hook when a campaign is active — and on a
    ``TransientFault`` quarantine the failing ``(op, backend, shape-key)``
    and re-resolve. An entry with somewhere to demote to (module
    docstring) demotes; otherwise it retries in place, at most
    ``MAX_RUNTIME_ATTEMPTS`` executions in all. ``FatalFault`` (and
    anything not in the taxonomy) propagates. The decision lands in
    ``record_dispatch`` logs only for the execution that served the
    call."""
    _ensure_env_faults()
    spec_kw = spec_kw or {}
    call_args = spec_args if call_args is None else call_args
    call_kw = dict(spec_kw) if call_kw is None else call_kw
    needs = tuple(needs)
    key = _shape_key(needs, spec_args, spec_kw)
    on_card = _on_card(ctx)
    last_fault: Optional[TransientFault] = None
    for _ in range(MAX_RUNTIME_ATTEMPTS):
        entry, decision = _resolve_entry(op, ctx, _dtype(dtype), needs,
                                         shape_key=key, probe=True)
        decision = _attach_plan_and_words(entry, decision, ctx, spec_args,
                                          spec_kw, plan=plan)

        def runner(entry=entry, decision=decision):
            return entry.fn(ctx, decision.plan, *call_args, **call_kw)

        hook = _FAULT_HOOK
        try:
            if hook is not None:
                out = hook.run(op, decision.chosen, runner,
                               tracing=_is_tracing())
            else:
                out = runner()
        except TransientFault as e:
            last_fault = e
            nxt = _demote_to(entry, get_backend(decision.chosen), on_card)
            inj = getattr(e, "injection", None)
            if inj is not None and inj.resolution is None:
                inj.resolution = "degraded" if nxt is not None else "retried"
            if nxt is not None:
                _QUARANTINE[(op, decision.chosen, key)] = {
                    "fault": type(e).__name__,
                    "probe_in": QUARANTINE_PROBE_AFTER}
            continue  # re-resolve: demote past the quarantine, or retry
        _publish(decision)
        return out
    raise last_fault


# ---------------------------------------------------------------------------
# Public ops.
# ---------------------------------------------------------------------------

def _check_device(op: str, ctx: ExecutionContext, *tensors) -> None:
    """Tensors must lie on the context's device: nothing moves silently."""
    want = torch.device(ctx.device).type
    for t in tensors:
        if t.device.type != want:
            raise ValueError(f"{op}: tensor on {t.device} but the context "
                             f"runs on {ctx.device!r}")


def matmul(a, b, ctx: Optional[ExecutionContext] = None, out_dtype=None):
    """C[m,n] = A @ B through the dispatched backend; ``out_dtype`` defaults
    to the target precision policy's accumulator dtype."""
    ctx = default_context() if ctx is None else ctx
    _check_device("matmul", ctx, a, b)
    out_dtype = out_dtype or ctx.acc_dtype
    return dispatch_call("matmul", ctx, a.dtype, (), (a, b),
                         spec_kw={"out_dtype": out_dtype})


def conv2d(x, w, stride=(1, 1), ctx: Optional[ExecutionContext] = None,
           out_dtype=None):
    """Direct 7NL convolution (VALID padding) through the dispatched backend."""
    ctx = default_context() if ctx is None else ctx
    _check_device("conv2d", ctx, x, w)
    out_dtype = out_dtype or ctx.acc_dtype
    return dispatch_call("conv2d", ctx, x.dtype, (), (x, w),
                         spec_kw={"stride": tuple(stride),
                                  "out_dtype": out_dtype})


def conv2d_dist(x, w, stride=(1, 1), blocking=None, mesh=None,
                ctx: Optional[ExecutionContext] = None, out_dtype=None):
    """Distributed halo-exchange conv2d over a conv mesh (paper §4.2).

    ``blocking`` is the ``ParallelBlocking`` processor grid (LP-chosen when
    omitted) and ``mesh`` the matching ``repro_torch.distributed`` mesh
    (``launch.make_conv_mesh(blocking)``, in process, when omitted). The backend picks the *shard-local* kernel (``cuda`` = the
    hand-written conv); the decision's ``measured_words`` are the
    per-device inter-device words (halo + psum), ratioed against the plan's
    Thm 2.2/2.3 parallel bound."""
    ctx = default_context() if ctx is None else ctx
    _check_device("conv2d_dist", ctx, x, w)
    out_dtype = out_dtype or ctx.acc_dtype
    return dispatch_call(
        "conv2d_dist", ctx, x.dtype, (), (x, w),
        spec_kw={"stride": tuple(stride), "out_dtype": out_dtype,
                 "blocking": blocking, "mesh": mesh})


def conv1d_causal(x, w, ctx: Optional[ExecutionContext] = None):
    """Causal depthwise conv1d (the mamba short convolution): ``x`` is
    (B, L, D), ``w`` the (K, D) taps in x's dtype; out in x's dtype."""
    ctx = default_context() if ctx is None else ctx
    _check_device("conv1d_causal", ctx, x, w)
    return dispatch_call("conv1d_causal", ctx, x.dtype, (), (x, w))


def matmul_q(a, b, scale, ctx: Optional[ExecutionContext] = None,
             out_dtype=None):
    """Quantized GEMM: ``a``/``b`` int8 (from
    ``repro_torch.quant.quantize_matmul_operands``), ``scale`` the folded
    (1, n) f32 per-column dequant scales. The operands stay int8 into shared
    memory; the accumulator is scaled once at the store. ``out_dtype``
    defaults to bf16 (``repro_torch.quant.INT8_SPEC``), not the context
    accumulator: the narrower store is half of what moves the measured
    words."""
    ctx = default_context() if ctx is None else ctx
    _check_device("matmul_q", ctx, a, b, scale)
    out_dtype = out_dtype or torch.bfloat16
    return dispatch_call("matmul_q", ctx, a.dtype, (), (a, b, scale),
                         spec_kw={"out_dtype": out_dtype})


def conv2d_q(x, w, scale, stride=(1, 1),
             ctx: Optional[ExecutionContext] = None, out_dtype=None):
    """Quantized direct conv2d (VALID padding): int8 ``x``/``w`` plus the
    folded (1, c_O) f32 scale from
    ``repro_torch.quant.quantize_conv_operands``. ``out_dtype`` defaults to
    bf16 (see :func:`matmul_q`)."""
    ctx = default_context() if ctx is None else ctx
    _check_device("conv2d_q", ctx, x, w, scale)
    out_dtype = out_dtype or torch.bfloat16
    return dispatch_call("conv2d_q", ctx, x.dtype, (), (x, w, scale),
                         spec_kw={"stride": tuple(stride),
                                  "out_dtype": out_dtype})


def _refuse_mesh(op: str, *tensors) -> None:
    """A paged pool on a device mesh: the reference's ``cache_specs`` has
    no paged layout, so neither has the port."""
    if any(dtensors.is_dtensor(t) for t in tensors):
        raise NotImplementedError(f"{op}: a paged KV pool on a device mesh "
                                  "(the mesh serves contiguous caches, "
                                  "sharded by cache_specs)")


def attention_needs(q_offset=0, key_mask=None) -> Tuple[str, ...]:
    """Required capability flags of one attention call (shared with tests):
    a tensor ``q_offset`` needs ``dynamic_q_offset`` (a scalar) or
    ``per_row_q_offset`` (a (B,) vector); a key mask needs ``key_mask``."""
    needs = []
    if not isinstance(q_offset, numbers.Integral):
        needs.append("per_row_q_offset" if getattr(q_offset, "ndim", 0)
                     else "dynamic_q_offset")
    if key_mask is not None:
        needs.append("key_mask")
    return tuple(needs)


def attention(q, k, v, causal: bool = True, q_offset=0, key_mask=None,
              ctx: Optional[ExecutionContext] = None, stats: bool = False):
    """GQA attention, (B, H, L, Dh) layout; Hkv divides H.

    ``q_offset``: absolute position of the first query — an int
    (train/prefill), a tensor scalar (lockstep in-cache calls), or a (B,)
    tensor (continuous-batching decode, every slot at its own depth).
    ``key_mask`` is an optional (B, Lk) validity mask over the keys (padded
    prefill). The ``cuda`` entry serves all three call features.
    ``stats`` (plain tensors) returns a key shard's flash-decode partial
    ``(acc, m, l)`` in f32 instead (``registry.torch_attention``), from
    the flash kernel's launch with row statistics on ``cuda``.

    On DTensors (a model on a device mesh) the call runs on each device's
    local shards, heads sharded on ``model``
    (``repro_torch.dtensors.local_attention``): the chosen backend sees
    plain tensors, on the card its kernel. A decode step over K/V sharded
    along their sequence takes each shard's partial through this op with
    ``stats`` (on ``cuda`` the kernel, on ``torch`` aten) and merges the
    shards (``dtensors.sequence_parallel_attention``)."""
    ctx = default_context() if ctx is None else ctx
    if dtensors.is_dtensor(q):
        if stats:
            raise ValueError("stats= is for plain tensors (a shard's "
                             "partial)")
        return dtensors.local_attention(
            lambda q_, k_, v_, m_, q_offset=q_offset, stats=False: attention(
                q_, k_, v_, causal=causal, q_offset=q_offset, key_mask=m_,
                ctx=ctx, stats=stats), q, k, v, key_mask, q_offset=q_offset)
    _check_device("attention", ctx, q, k, v)
    return dispatch_call("attention", ctx, q.dtype,
                         attention_needs(q_offset, key_mask), (q, k, v),
                         spec_kw={"stats": True} if stats else None,
                         call_kw={"causal": causal, "q_offset": q_offset,
                                  "key_mask": key_mask, "stats": stats})


def attention_decode(q, kp, vp, tables, lengths,
                     ctx: Optional[ExecutionContext] = None,
                     capacity: Optional[int] = None):
    """One paged decode step: ``q`` is (B, H, 1, hd), ``kp``/``vp`` the
    shared (num_blocks, KV, block_size, hd) pools, ``tables`` the (B, w)
    int32 physical-block ids backing each row's logical positions, and
    ``lengths`` the (B,) valid cache lengths (current token included).

    The ``cuda`` entry follows the tables inside the kernel (no gathered
    copy); the ``torch`` entry gathers to a contiguous view first.
    ``capacity`` (not in the reference) is the widest table the caller's
    rows can reach, default w: the kernel takes its split over table slots
    from it, so that a row's result does not depend on w
    (``kernels.flash_attention.paged_launch_config``); the words charged
    do not depend on it. Not on a device mesh (``NotImplementedError``):
    the reference's ``cache_specs`` has no paged layout."""
    ctx = default_context() if ctx is None else ctx
    _refuse_mesh("attention_decode", q, kp, vp)
    _check_device("attention_decode", ctx, q, kp, vp)
    return dispatch_call("attention_decode", ctx, q.dtype, (),
                         (q, kp, vp, tables, lengths),
                         spec_kw=(None if capacity is None
                                  else {"capacity": capacity}))


def attention_decode_quant(q, kp, ks, vp, vs, tables, lengths,
                           ctx: Optional[ExecutionContext] = None):
    """One paged decode step against an int8-quantized KV pool.

    ``kp``/``vp`` are the (num_blocks, KV, block_size, hd) int8 pools and
    ``ks``/``vs`` their (num_blocks, KV, block_size) f32 per-(block, head,
    position) scales (written together by the engine's quantizing insert).
    Registered on the ``torch`` backend only, as the reference registers it
    on ``xla`` only: callers on the card request ``backend="torch"``. Not
    on a device mesh, as :func:`attention_decode`."""
    ctx = default_context() if ctx is None else ctx
    _refuse_mesh("attention_decode_quant", q, kp, vp)
    _check_device("attention_decode_quant", ctx, q, kp, ks, vp, vs)
    return dispatch_call("attention_decode_quant", ctx, q.dtype, (),
                         (q, kp, ks, vp, vs, tables, lengths))
