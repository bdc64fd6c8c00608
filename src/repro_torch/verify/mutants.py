"""Seeded mutants — the auditor's own regression harness, the port of
``repro.verify.mutants``.

Each mutant injects a realistic kernel bug into otherwise-correct launch
metadata and asserts the static checks catch it:

  * ``halo_off_by_one``   shifts the conv2d input window's h start by one
    row — the classic stride/halo index bug. The word *totals* are
    unchanged, so only the ``requires``-coverage check can see it.
  * ``dropped_dma_wait``  removes the waits from the reference's
    double-buffered schedule — a read of data that never landed (H1).
  * ``same_slot_prefetch`` prefetches step ci + 1 into the slot step ci is
    about to consume (H2/H3).
  * ``scale_applied_twice`` makes the int8 conv fetch its folded scale
    vector at a second site per launch. Totals move (counted > words_fn),
    so the counted-vs-measured exactness check must flag it.
  * ``ring_barrier_dropped`` removes the ``__syncthreads`` from the bf16
    conv's ``cp.async`` ring at a main-path launch: a warp reads a slot
    other warps copied, and refills one other warps read, unfenced (H6).
  * ``cluster_sync_dropped`` removes paged decode's second
    ``cluster.sync``: rank 0 reads the other CTAs' partials before they
    are fenced (H7).
  * ``fault_swallowed``   a handler that catches an injected
    ``NumericFault`` and stamps no resolution; the campaign's accounting
    (``FaultCampaign.unresolved``) must report it.

``run_seeded_mutants()`` returns ``(name, caught, detail)`` triples;
``scripts/verify_torch.py --mutants`` fails unless every mutant is
caught.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, List, Tuple

import torch

from . import audit as _audit
from . import hazards as hz
from .access import KernelAccessPlan, WindowAccess



def _meta(shape, dtype):
    return torch.empty(shape, dtype=dtype, device="meta")


def _conv2d_plan() -> KernelAccessPlan:
    """A representative strided conv2d access plan (ResNet conv3_1-like),
    planned for the H100."""
    from repro_torch.kernels.conv2d import conv2d_access_plan
    from repro_torch.plan import H100

    return conv2d_access_plan(_meta((8, 64, 56, 56), torch.bfloat16),
                              _meta((128, 64, 3, 3), torch.bfloat16),
                              stride=(2, 2), target=H100)


def halo_off_by_one() -> Tuple[bool, str]:
    """Shift the input window one row down; words stay identical."""
    ap = _conv2d_plan()
    mutated = []
    for acc in ap.accesses:
        if isinstance(acc, WindowAccess) and acc.name == "input":
            orig = acc.window

            def shifted(*axes, _orig=orig):
                win = list(_orig(*axes))
                (h0, hs) = win[2]
                win[2] = (h0 + 1, hs)  # off-by-one h start
                return tuple(win)

            acc = dataclasses.replace(acc, window=shifted)
        mutated.append(acc)
    report = _audit.audit_access_plan(
        dataclasses.replace(ap, accesses=tuple(mutated)))
    caught = any("misses the required" in p or "exceeds the padded extent" in p
                 for p in report.problems)
    return caught, "; ".join(report.problems[:2]) or "not detected"


def dropped_dma_wait() -> Tuple[bool, str]:
    """Strip the waits: compute reads data the copy never landed."""
    sched = hz.double_buffered_schedule(6, name="mutant:no-wait")
    mutated = dataclasses.replace(
        sched, events=tuple(e for e in sched.events if e.kind != hz.WAIT))
    found = hz.check_schedule(mutated)
    caught = any(h.code == "H1" for h in found)
    return caught, "; ".join(str(h) for h in found[:2]) or "not detected"


def same_slot_prefetch() -> Tuple[bool, str]:
    """Prefetch ci + 1 into the slot step ci still consumes."""
    sched = hz.double_buffered_schedule(6, name="mutant:same-slot")
    mutated = dataclasses.replace(
        sched, events=tuple(
            dataclasses.replace(e, slot=0) if e.kind == hz.START else e
            for e in sched.events))
    found = hz.check_schedule(mutated)
    caught = any(h.code in ("H2", "H3") for h in found)
    return caught, "; ".join(str(h) for h in found[:2]) or "not detected"


def scale_applied_twice() -> Tuple[bool, str]:
    """The dequantize-at-every-application bug: the kernel fetches its
    scale slices at a second site (per-tap and at the final store), which
    doubles the counted scale stream past what the words_fn charges."""
    from repro_torch import ops
    from repro_torch.kernels.quant import conv2d_q_access_plan
    from repro_torch.plan import H100

    x = _meta((8, 64, 56, 56), torch.int8)
    w = _meta((128, 64, 3, 3), torch.int8)
    s = _meta((1, 128), torch.float32)
    ctx = ops.ExecutionContext(target=H100, backend="cuda", device="cpu")
    decision = ops.explain("conv2d_q", ctx=ctx, dtype="int8",
                           spec_args=(x, w, s), spec_kw={"stride": (2, 2)})
    ap = conv2d_q_access_plan(x, w, s, stride=(2, 2), plan=decision.plan)
    extra = tuple(
        dataclasses.replace(acc, name="scale(second application)")
        for acc in ap.accesses
        if isinstance(acc, WindowAccess) and acc.name == "scale")
    assert extra, "conv2d_q access plan no longer carries a scale operand"
    report = _audit.audit_decision(
        dataclasses.replace(ap, accesses=ap.accesses + extra), decision)
    caught = any("!= words_fn" in p for p in report.problems)
    return caught, "; ".join(report.problems[:2]) or "not detected"


def _mutate_schedules(ap: KernelAccessPlan, fn) -> List[hz.Hazard]:
    found: List[hz.Hazard] = []
    for sched in ap.schedules():
        found += hz.check_schedule(fn(sched))
    return found


def ring_barrier_dropped() -> Tuple[bool, str]:
    """Remove every ``__syncthreads`` from the bf16 conv's ring."""
    ap = _conv2d_plan()
    found = _mutate_schedules(ap, lambda s: hz.without(s, hz.BARRIER))
    caught = any(h.code == "H6" for h in found)
    return caught, "; ".join(str(h) for h in found[:2]) or "not detected"


def drop_cluster_sync(sched: hz.DmaSchedule, which: int) -> hz.DmaSchedule:
    """``sched`` without every CTA's ``which``-th ``cluster.sync`` (1-based)."""
    seen = {}
    kept = []
    for e in sched.events:
        if e.kind == hz.CLUSTER_SYNC:
            seen[e.rank] = seen.get(e.rank, 0) + 1
            if seen[e.rank] == which:
                continue
        kept.append(e)
    return dataclasses.replace(sched, events=tuple(kept),
                               name=f"{sched.name} without cluster.sync "
                                    f"{which}")


def cluster_sync_dropped() -> Tuple[bool, str]:
    """Remove paged decode's second ``cluster.sync`` (the one that
    publishes the partials), at the serving shape."""
    from repro_torch.kernels.flash_attention import paged_decode_access_plan

    ap = paged_decode_access_plan(4, 2, 8, 13, 16, 128, 53, p_q=0.5,
                                  p_kv=0.5, p_o=0.5,
                                  lengths=(205, 151, 120, 41))
    found = _mutate_schedules(ap, lambda s: drop_cluster_sync(s, 2))
    caught = any(h.code == "H7" for h in found)
    return caught, "; ".join(str(h) for h in found[:2]) or "not detected"


def fault_swallowed() -> Tuple[bool, str]:
    """A fault handler that catches an injected NumericFault and silently
    swallows it — the recovery bug the resolution accounting exists for.
    Every legitimate handler stamps ``Injection.resolution`` (retried /
    row_failed / degraded / ...); this one stamps nothing, so the campaign
    must report the injection as unresolved."""
    from repro_torch.resilience.errors import NumericFault
    from repro_torch.resilience.faults import FaultCampaign

    camp = FaultCampaign(seed=0, rate=1.0, kinds=("numeric",), max_faults=1)
    inj = camp.draw("dispatch/conv2d", op="conv2d")
    if inj is None:
        return False, "a rate-1.0 campaign failed to inject"
    try:
        raise camp.fault_for(inj, op="conv2d", backend="cuda")
    except NumericFault:
        pass  # the mutant: no resolve(), no retry, no row failure
    leaks = camp.unresolved()
    caught = bool(leaks)
    return caught, (f"{len(leaks)} unresolved injection(s): "
                    f"{leaks[0].kind} at {leaks[0].site}" if caught
                    else "not detected")


MUTANTS: Tuple[Tuple[str, Callable[[], Tuple[bool, str]]], ...] = (
    ("halo_off_by_one", halo_off_by_one),
    ("dropped_dma_wait", dropped_dma_wait),
    ("same_slot_prefetch", same_slot_prefetch),
    ("scale_applied_twice", scale_applied_twice),
    ("ring_barrier_dropped", ring_barrier_dropped),
    ("cluster_sync_dropped", cluster_sync_dropped),
    ("fault_swallowed", fault_swallowed),
)


def run_seeded_mutants() -> List[Tuple[str, bool, str]]:
    """``(name, caught, detail)`` per mutant."""
    return [(name, *fn()) for name, fn in MUTANTS]
