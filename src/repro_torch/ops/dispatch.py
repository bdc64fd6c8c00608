"""The dispatcher: resolve each op call to (ExecutionPlan, backend kernel).
The counterpart of ``repro.ops.dispatch``, without its runtime-fault layer
(quarantine, ``degrade_to``, fault injection), which is not ported yet: an
entry that raises propagates.

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
                                   made while it is active.
"""

from __future__ import annotations

import contextlib
import dataclasses
import numbers
from typing import Any, List, Optional, Tuple

import torch

from .context import ExecutionContext, default_context
from .registry import Backend, OpEntry, dtype_name, get_backend


@dataclasses.dataclass(frozen=True)
class DispatchDecision:
    """Why one call ran where it did — and what it moved.

    ``requested`` is the backend the context resolved to; ``chosen`` the one
    that served the call; ``missing`` the capabilities whose absence forced
    the (CPU-only) fallback; ``plan`` the ExecutionPlan the chosen entry consumed
    (None for aten entries); ``plan_source`` ``"explicit"`` or
    ``"analytic"``; ``measured_words`` the HBM words (32-bit) the chosen
    kernel's launch geometry moves for this call (None when the entry is not
    instrumented), reported via ``bound_ratio`` against the plan's Thm 2.1
    ``lower_bound``."""

    op: str
    requested: str
    chosen: str
    missing: Tuple[str, ...] = ()
    plan: Optional[Any] = None
    plan_source: str = "analytic"  # "explicit" | "analytic"
    measured_words: Optional[float] = None

    @property
    def fell_back(self) -> bool:
        return self.chosen != self.requested

    @property
    def lower_bound(self) -> Optional[float]:
        """The Thm 2.1 bound ``measured_words`` is compared against."""
        return None if self.plan is None else self.plan.lower_bound

    @property
    def bound_ratio(self) -> Optional[float]:
        """measured words / the communication lower bound."""
        lb = self.lower_bound
        if self.measured_words is None or lb is None:
            return None
        return self.measured_words / max(lb, 1.0)

    def why(self) -> str:
        if not self.fell_back:
            msg = f"{self.op}: ran on requested backend {self.chosen!r}"
        else:
            msg = (f"{self.op}: {self.requested!r} lacks "
                   f"{', '.join(self.missing)}; fell back to {self.chosen!r}")
        if self.plan is not None:
            msg += f"; {self.plan_source} plan"
        if self.measured_words is not None:
            msg += f"; measured {self.measured_words:.3e} HBM words"
            if self.bound_ratio is not None:
                msg += (f" = {self.bound_ratio:.2f}x the "
                        f"{self.lower_bound:.3e}-word lower bound")
        return msg


_TRACE: List[List[DispatchDecision]] = []  # stack of active recorders


@contextlib.contextmanager
def record_dispatch():
    """Capture every DispatchDecision made while active (trace API)."""
    log: List[DispatchDecision] = []
    _TRACE.append(log)
    try:
        yield log
    finally:
        # remove by identity: nested recorders hold equal (e.g. empty) lists
        for i, entry in enumerate(_TRACE):
            if entry is log:
                del _TRACE[i]
                break


def _lacks(backend: Backend, op: str, dtype: Optional[str],
           needs: Tuple[str, ...]
           ) -> Tuple[Optional[OpEntry], Tuple[str, ...]]:
    entry = backend.ops.get(op)
    if entry is None:
        return None, (f"op:{op}",)
    return entry, entry.caps.missing(dtype=dtype, needs=needs)


def _resolve_entry(op: str, ctx: ExecutionContext, dtype: Optional[str],
                   needs: Tuple[str, ...]) -> Tuple[OpEntry, DispatchDecision]:
    requested = ctx.resolved_backend()
    backend = get_backend(requested)
    entry, lacks = _lacks(backend, op, dtype, needs)
    if not lacks:
        return entry, DispatchDecision(op=op, requested=requested,
                                       chosen=requested)
    if torch.device(ctx.device).type == "cuda":
        raise NotImplementedError(
            f"{op}: backend {requested!r} lacks {', '.join(lacks)}; on the "
            f"card no aten op stands in for its kernel")
    if backend.fallback is not None:
        entry, more = _lacks(get_backend(backend.fallback), op, dtype,
                             needs)
        if not more:
            return entry, DispatchDecision(op=op, requested=requested,
                                           chosen=backend.fallback,
                                           missing=lacks)
        lacks = lacks + more
    raise NotImplementedError(
        f"no registered backend can serve op {op!r} (requested "
        f"{requested!r}, dtype={dtype}, call features {needs}; missing: "
        f"{lacks})")


def _attach_plan_and_words(entry: OpEntry, decision: DispatchDecision,
                           ctx: ExecutionContext,
                           spec_args: Optional[tuple],
                           spec_kw: Optional[dict],
                           plan: Optional[Any] = None) -> DispatchDecision:
    """Resolve the entry's plan (explicit ``plan`` > analytic LP) and its
    measured-HBM-words counter; both need only shapes/dtypes."""
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


def _dtype(dtype) -> Optional[str]:
    return None if dtype is None else dtype_name(dtype)


def resolve(op: str, ctx: Optional[ExecutionContext] = None,
            dtype: Optional[str] = None, needs: Tuple[str, ...] = (),
            spec_args: Optional[tuple] = None, spec_kw: Optional[dict] = None,
            plan: Optional[Any] = None) -> Tuple[OpEntry, DispatchDecision]:
    """Capability-resolve one call; resolve the entry's plan and measured
    HBM-word counter if it declares them. Records the decision."""
    entry, decision = _explain_entry(op, ctx, dtype, needs, spec_args,
                                     spec_kw, plan)
    for log in _TRACE:
        log.append(decision)
    return entry, decision


def _explain_entry(op, ctx=None, dtype=None, needs=(), spec_args=None,
                  spec_kw=None, plan=None) -> Tuple[OpEntry, DispatchDecision]:
    ctx = default_context() if ctx is None else ctx
    entry, decision = _resolve_entry(op, ctx, _dtype(dtype), tuple(needs))
    return entry, _attach_plan_and_words(entry, decision, ctx, spec_args,
                                         spec_kw, plan=plan)


def explain(op: str, ctx: Optional[ExecutionContext] = None,
            dtype: Optional[str] = None, needs: Tuple[str, ...] = (),
            spec_args: Optional[tuple] = None,
            spec_kw: Optional[dict] = None,
            plan: Optional[Any] = None) -> DispatchDecision:
    """The decision ``resolve`` would make, without executing anything.
    ``spec_args``/``spec_kw`` mirror the op's call (e.g. conv2d needs
    ``stride=``) so the reported plan and measured words are the ones the
    dispatched kernel would consume; meta tensors work."""
    return _explain_entry(op, ctx, dtype, needs, spec_args, spec_kw, plan)[1]


def dispatch_call(op: str, ctx: ExecutionContext, dtype: Optional[str],
                  needs: Tuple[str, ...], spec_args: tuple,
                  spec_kw: Optional[dict] = None,
                  call_args: Optional[tuple] = None,
                  call_kw: Optional[dict] = None,
                  plan: Optional[Any] = None):
    """Resolve AND execute one op call. ``plan=`` forces an explicit
    ExecutionPlan onto the chosen entry. The decision lands in
    ``record_dispatch`` logs once the entry has returned."""
    spec_kw = spec_kw or {}
    call_args = spec_args if call_args is None else call_args
    call_kw = dict(spec_kw) if call_kw is None else call_kw
    entry, decision = _explain_entry(op, ctx, dtype, needs, spec_args,
                                     spec_kw, plan)
    out = entry.fn(ctx, decision.plan, *call_args, **call_kw)
    for log in _TRACE:
        log.append(decision)
    return out


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
              ctx: Optional[ExecutionContext] = None):
    """GQA attention, (B, H, L, Dh) layout; Hkv divides H.

    ``q_offset``: absolute position of the first query — an int
    (train/prefill), a tensor scalar (lockstep in-cache calls), or a (B,)
    tensor (continuous-batching decode, every slot at its own depth).
    ``key_mask`` is an optional (B, Lk) validity mask over the keys (padded
    prefill). The ``cuda`` entry serves all three call features."""
    ctx = default_context() if ctx is None else ctx
    _check_device("attention", ctx, q, k, v)
    return dispatch_call("attention", ctx, q.dtype,
                         attention_needs(q_offset, key_mask), (q, k, v),
                         call_kw={"causal": causal, "q_offset": q_offset,
                                  "key_mask": key_mask})


def attention_decode(q, kp, vp, tables, lengths,
                     ctx: Optional[ExecutionContext] = None):
    """One paged decode step: ``q`` is (B, H, 1, hd), ``kp``/``vp`` the
    shared (num_blocks, KV, block_size, hd) pools, ``tables`` the (B, w)
    int32 physical-block ids backing each row's logical positions, and
    ``lengths`` the (B,) valid cache lengths (current token included).

    The ``cuda`` entry follows the tables inside the kernel (no gathered
    copy); the ``torch`` entry gathers to a contiguous view first."""
    ctx = default_context() if ctx is None else ctx
    _check_device("attention_decode", ctx, q, kp, vp)
    return dispatch_call("attention_decode", ctx, q.dtype, (),
                         (q, kp, vp, tables, lengths))
