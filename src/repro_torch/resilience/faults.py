"""Deterministic seeded fault injection: :class:`FaultCampaign` + the
dispatch hook (the port of ``repro.resilience.faults``, with the same names
and signatures).

A campaign is a seeded stream of go/no-go decisions consumed at named
**sites**: the dispatcher consults it around every eager kernel launch
(``dispatch/<op>``), and the serving engine consults it at its host-side
scheduling points (``admit/launch``, ``admit/numeric``, ``admit/oom``,
``decode/numeric``, ``decode/pool``, ``finish/pool``). Each positive draw
yields an :class:`Injection` record; the handler that recovers from the
fault stamps ``Injection.resolution`` (``"degraded"``, ``"retried"``,
``"row_failed"``, ``"backpressure"``, ``"rebuilt"``, ``"fatal"``).
``unresolved()``/``verify_accounted()`` then prove no handler silently
swallowed a fault — the property the ``fault_swallowed`` seeded mutant
plants a violation of.

Fault kinds:

  * ``launch``  - raise :class:`KernelLaunchError` before the kernel runs
  * ``dma``     - raise :class:`DmaTimeout` before the kernel runs
  * ``numeric`` - let the kernel run, then poison its output with NaN
  * ``device``  - raise :class:`DeviceLost` (fatal; must propagate)
  * ``oom``     - starve the paged block pool at admission (engine site)
  * ``pool``    - corrupt the block allocator's invariants (engine site)

The decision stream is numpy's (``np.random.default_rng(seed)``), as in the
reference, for the draws and for ``corrupt_rows``' victim: the same seed
and the same visit order give the same injections in both packages.

Activation: ``with activate(FaultCampaign(...)):`` installs the campaign
process-wide (engine sites read :func:`active_campaign`; the dispatch hook
is installed on ``repro_torch.ops.dispatch``). The ``REPRO_FAULTS``
environment knob does the same persistently, read at the first dispatch,
e.g.::

    REPRO_FAULTS="rate=0.05,seed=0,kinds=launch+numeric,ops=conv2d,max=10"

The dispatch hook NEVER fires inside ``ops.dispatch.traced()`` or while a
CUDA graph is being captured, the port's counterparts of the reference's
``jax.jit`` tracing: the engine's prefill, insert, decode and sampling
steps, the decode graphs' warm-up, capture and replay, and the trainer's
step run there, as the reference jits them. A fault drawn there would be
planted in a captured graph and replayed at every step (a permanent
failure wearing a transient's name), and the finiteness check is a host
sync, which a capture refuses. Engine sites are host-side and eager, so
they are unaffected; the quarantine in ``repro_torch.ops.dispatch`` *does*
apply there, as it applies at trace time in the reference.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
from typing import Any, Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .errors import (DeviceLost, DmaTimeout, FaultAccountingError,
                     KernelLaunchError, NumericFault)

FAULTS_ENV = "REPRO_FAULTS"

FAULT_KINDS = ("launch", "dma", "numeric", "device", "oom", "pool")
# kinds the dispatch hook can realize on an eager op call
DISPATCH_KINDS = ("launch", "dma", "numeric", "device")

_FAULT_TYPES = {"launch": KernelLaunchError, "dma": DmaTimeout,
                "numeric": NumericFault, "device": DeviceLost}


@dataclasses.dataclass
class Injection:
    """One planted fault: where, what, and how the system dealt with it."""

    seq: int
    site: str
    kind: str
    op: Optional[str] = None
    resolution: Optional[str] = None  # stamped by the recovering handler
    detail: Dict[str, Any] = dataclasses.field(default_factory=dict)


def _leaves(out) -> List[Any]:
    """The leaves of an op's output in the reference's pytree order: a
    tuple or list in order, a dict by sorted key, None as no leaf."""
    if out is None:
        return []
    if isinstance(out, (tuple, list)):
        return [leaf for item in out for leaf in _leaves(item)]
    if isinstance(out, dict):
        return [leaf for k in sorted(out) for leaf in _leaves(out[k])]
    return [out]


def _replace_leaf(out, i: int, new) -> Tuple[Any, int]:
    """``out`` with its leaf ``i`` (in :func:`_leaves` order) replaced by
    ``new``, rebuilt as new containers; and how many leaves ``out`` has."""
    if out is None:
        return out, 0
    if isinstance(out, (tuple, list)):
        items, n = [], 0
        for item in out:
            item, k = _replace_leaf(item, i - n, new)
            items.append(item)
            n += k
        if isinstance(out, list):
            return items, n
        return (type(out)(*items) if hasattr(out, "_fields")
                else tuple(items)), n
    if isinstance(out, dict):
        items, n = dict(out), 0
        for key in sorted(out):
            items[key], k = _replace_leaf(out[key], i - n, new)
            n += k
        return items, n
    return (new if i == 0 else out), 1


def _is_float_tensor(leaf) -> bool:
    return isinstance(leaf, torch.Tensor) and leaf.is_floating_point()


class FaultCampaign:
    """A seeded, rate-limited fault plan.

    ``rate`` is the per-site-visit injection probability; ``kinds`` the
    fault kinds this campaign may plant (a site additionally narrows to the
    kinds it can realize); ``ops`` optionally restricts dispatch-site
    injections to the named ops; ``max_faults`` caps total injections so
    rate-1.0 chaos schedules still terminate. The decision stream is a
    ``numpy`` Generator seeded with ``seed`` — same seed, same visit order,
    same faults, which is what lets benchmarks compare a faulted run
    against its fault-free twin row by row."""

    def __init__(self, seed: int = 0, rate: float = 0.05,
                 kinds: Sequence[str] = ("launch", "numeric"),
                 ops: Optional[Sequence[str]] = None,
                 max_faults: Optional[int] = None):
        bad = set(kinds) - set(FAULT_KINDS)
        if bad:
            raise ValueError(f"unknown fault kinds {sorted(bad)}; "
                             f"known: {FAULT_KINDS}")
        if not 0.0 <= rate <= 1.0:
            raise ValueError(f"rate must be in [0, 1], got {rate}")
        self.seed = seed
        self.rate = float(rate)
        self.kinds = tuple(kinds)
        self.ops = None if ops is None else tuple(ops)
        self.max_faults = max_faults
        self._rng = np.random.default_rng(seed)
        self.injections: List[Injection] = []
        self.draws = 0

    # -- the decision stream ------------------------------------------------

    def draw(self, site: str, kinds: Optional[Sequence[str]] = None,
             op: Optional[str] = None) -> Optional[Injection]:
        """One deterministic fault decision at a named site. Returns the
        :class:`Injection` to realize, or None. Every visit consumes exactly
        one uniform draw (plus one kind choice on a hit), so the stream is a
        pure function of the visit order — not of which faults fired."""
        if op is not None and self.ops is not None and op not in self.ops:
            return None
        allowed = [k for k in self.kinds if kinds is None or k in kinds]
        self.draws += 1
        u = float(self._rng.random())
        if not allowed or u >= self.rate:
            return None
        if (self.max_faults is not None
                and len(self.injections) >= self.max_faults):
            return None
        kind = allowed[int(self._rng.integers(len(allowed)))]
        inj = Injection(seq=len(self.injections), site=site, kind=kind, op=op)
        self.injections.append(inj)
        return inj

    def fault_for(self, inj: Injection, op: Optional[str] = None,
                  backend: Optional[str] = None):
        """The taxonomy exception realizing ``inj`` (raise-style kinds)."""
        cls = _FAULT_TYPES[inj.kind]
        return cls(f"injected {inj.kind} fault at {inj.site} "
                   f"(campaign seed={self.seed}, seq={inj.seq})",
                   op=op or inj.op, backend=backend, injection=inj)

    # -- corruption helpers (realize-style kinds) ---------------------------

    def corrupt_output(self, out, inj: Injection):
        """NaN-poison the first element of the first floating leaf. The
        leaf is copied, never written in place: an op's output may be a
        CUDA graph's static buffer, which its next replay must rewrite
        clean."""
        for i, leaf in enumerate(_leaves(out)):
            if _is_float_tensor(leaf):
                bad = leaf.clone(memory_format=torch.contiguous_format)
                bad.view(-1)[0] = float("nan")
                inj.detail["leaf"] = i
                return _replace_leaf(out, i, bad)[0]
        return out

    def corrupt_rows(self, logits: torch.Tensor, rows: Sequence[int],
                     inj: Injection) -> torch.Tensor:
        """NaN an entire logits row drawn from ``rows`` (active slots), so
        the engine's per-row guard — not a whole-batch abort — must fire.
        Returns a poisoned copy (``logits`` may be a graph's static
        output)."""
        victim = int(rows[int(self._rng.integers(len(rows)))])
        inj.detail["row"] = victim
        bad = logits.clone()
        bad[victim] = float("nan")
        return bad

    def corrupt_allocator(self, alloc, inj: Optional[Injection] = None):
        """Break exactly one ``BlockAllocator`` invariant (deterministically
        picking whichever state the pool is in): leak a free block, dangle
        an evictable block's key mapping, or fabricate a phantom refcount.
        ``alloc.check()`` must then raise :class:`PoolIntegrityFault`."""
        detail = inj.detail if inj is not None else {}
        if alloc._free:
            detail["corruption"] = f"leaked free block {alloc._free[-1]}"
            alloc._free.pop()
        elif alloc._evictable:
            bid, _ = alloc._evictable.popitem()
            detail["corruption"] = f"dangled evictable block {bid}"
        else:
            detail["corruption"] = "phantom refcount on block id -1"
            alloc._rc[-1] = 1

    # -- accounting ---------------------------------------------------------

    def resolve(self, inj_or_fault, resolution: str) -> None:
        """Stamp how a planted fault was handled. Accepts the Injection or
        the taxonomy exception carrying one; a None/organic fault is a
        no-op so handlers need no injected-vs-organic branch."""
        inj = getattr(inj_or_fault, "injection", inj_or_fault)
        if isinstance(inj, Injection):
            inj.resolution = resolution

    def resolve_kind(self, kind: str, resolution: str) -> None:
        """Stamp every still-unresolved injection of one kind (e.g. all
        pending ``pool`` corruptions once a rebuild repaired the pool)."""
        for inj in self.injections:
            if inj.kind == kind and inj.resolution is None:
                inj.resolution = resolution

    def unresolved(self) -> List[Injection]:
        return [i for i in self.injections if i.resolution is None]

    def verify_accounted(self) -> None:
        """Raise :class:`FaultAccountingError` if any injection was
        swallowed without a recorded resolution."""
        leaks = self.unresolved()
        if leaks:
            first = leaks[0]
            raise FaultAccountingError(
                f"{len(leaks)} injected fault(s) were swallowed without a "
                f"resolution; first: {first.kind} at {first.site} "
                f"(seq {first.seq})", injection=first)

    def summary(self) -> Dict[str, Any]:
        by_res: Dict[str, int] = {}
        for inj in self.injections:
            key = inj.resolution or "UNRESOLVED"
            by_res[key] = by_res.get(key, 0) + 1
        return {"seed": self.seed, "rate": self.rate, "draws": self.draws,
                "injected": len(self.injections), "resolutions": by_res}


# ---------------------------------------------------------------------------
# The dispatch hook: realizes dispatch-site faults around eager op calls.
# ---------------------------------------------------------------------------

class DispatchFaultHook:
    """Installed on ``repro_torch.ops.dispatch`` while a campaign is
    active."""

    def __init__(self, campaign: FaultCampaign):
        self.campaign = campaign

    def run(self, op: str, backend: str, runner, tracing: bool):
        if tracing:
            # never plant a fault in a compiled step (module docstring)
            return runner()
        c = self.campaign
        inj = c.draw(f"dispatch/{op}", kinds=DISPATCH_KINDS, op=op)
        if inj is not None and inj.kind in ("launch", "dma", "device"):
            if inj.kind == "device":
                # fatal by construction: account it here, since no handler
                # below the caller is supposed to catch it
                inj.resolution = "fatal"
            raise c.fault_for(inj, op=op, backend=backend)
        out = runner()
        if inj is not None:  # numeric: poison after the kernel ran
            out = c.corrupt_output(out, inj)
        if not _all_finite(out):
            raise NumericFault(f"non-finite output from {op}", op=op,
                               backend=backend, injection=inj)
        return out


def _all_finite(out) -> bool:
    """Every floating leaf finite (one device read a leaf on the card)."""
    return all(bool(torch.isfinite(leaf).all())
               for leaf in _leaves(out) if _is_float_tensor(leaf))


# ---------------------------------------------------------------------------
# Activation (process-wide): context manager, persistent install, env knob.
# ---------------------------------------------------------------------------

_ACTIVE: Optional[FaultCampaign] = None


def active_campaign() -> Optional[FaultCampaign]:
    """The campaign engine-level sites should consult (None = no faults)."""
    return _ACTIVE


def install(campaign: Optional[FaultCampaign]) -> Optional[FaultCampaign]:
    """Persistently (de)activate a campaign: sets the module-level campaign
    and the dispatch hook. Prefer :func:`activate` in tests."""
    global _ACTIVE
    _ACTIVE = campaign
    from repro_torch.ops import dispatch as _dispatch  # lazy: avoids a cycle

    _dispatch.set_fault_hook(
        DispatchFaultHook(campaign) if campaign is not None else None)
    return campaign


@contextlib.contextmanager
def activate(campaign: FaultCampaign) -> Iterator[FaultCampaign]:
    """Scoped activation, restoring whatever was active before."""
    prev = _ACTIVE
    install(campaign)
    try:
        yield campaign
    finally:
        install(prev)


def campaign_from_spec(spec: str) -> FaultCampaign:
    """Parse a ``REPRO_FAULTS`` spec:
    ``rate=0.05,seed=0,kinds=launch+numeric,ops=conv2d+matmul,max=10``."""
    fields: Dict[str, str] = {}
    for part in spec.split(","):
        part = part.strip()
        if not part:
            continue
        if "=" not in part:
            raise ValueError(f"bad {FAULTS_ENV} field {part!r} "
                             "(expected key=value)")
        key, val = part.split("=", 1)
        fields[key.strip()] = val.strip()
    known = {"rate", "seed", "kinds", "ops", "max"}
    unknown = set(fields) - known
    if unknown:
        raise ValueError(f"unknown {FAULTS_ENV} field(s) {sorted(unknown)}; "
                         f"known: {sorted(known)}")
    kinds: Tuple[str, ...] = tuple(
        fields.get("kinds", "launch+numeric").split("+"))
    ops = tuple(fields["ops"].split("+")) if "ops" in fields else None
    max_faults = int(fields["max"]) if "max" in fields else None
    return FaultCampaign(seed=int(fields.get("seed", "0")),
                         rate=float(fields.get("rate", "0.05")),
                         kinds=kinds, ops=ops, max_faults=max_faults)


def install_env_campaign() -> Optional[FaultCampaign]:
    """Install the campaign the ``REPRO_FAULTS`` env var describes (no-op
    when unset). Called once from the dispatcher's first dispatch."""
    spec = os.environ.get(FAULTS_ENV)
    if not spec:
        return None
    return install(campaign_from_spec(spec))
