"""``repro_torch.plan.autotune`` — the bound-guided measured autotune stage
(the port of ``repro.plan.autotune``).

The blocking LP minimizes *words*; real launches also pay per-transfer
latency, so the words-optimal tiles are not always the fastest ones.
Following arxiv 2012.15667 (use the I/O lower bound to prune the search,
then measure the survivors; viable because, per arxiv 1802.06905, the
near-bound frontier is small):

  1. **Frontier enumeration** — walk a deterministic tile neighborhood of
     the analytic plan (axis halvings/doublings, spatial divisors), clamp
     every candidate through ``fit_conv_kernel_tiles`` and keep those that
     fit the exact halo-window budget (``conv_kernel_tiles_fit`` / the GEMM
     footprint), move words within ``policy.slack`` of the analytic optimum
     AND stay <= ``policy.bound_cap`` x the Thm 2.1 bound, and pass the
     ``repro_torch.verify`` audit of the CUDA launch they would make. The
     memory model admits tiles the H100 kernels cannot launch (more
     accumulators than a CTA's registers, more shared memory than a block's,
     windows past the conv's 16-bit offsets): such a candidate is *not
     auditable*, is never timed, and is counted by reason in the search's
     :class:`SearchReport`.
  2. **Timing** — on the card each audited candidate runs through
     ``ops.dispatch_call`` (explicit ``plan=`` override, the ``cuda``
     backend), timed as device time: a CUDA graph of its calls replayed
     best-of-k after warm calls (``repro_torch.analysis.timing``), since a
     wrapper's 30-300 us of host work would tie every small candidate.
     Without a card the offline model prices it with the alpha-beta
     roofline ``analysis.roofline.alpha_beta_seconds`` (the H100's HBM
     rate + a per-transfer latency), under which the winner is reproducible
     bit for bit. A device or kernel that fails raises; nothing falls back
     to the roofline.
  3. **Persistence** — the winner lands in the process-wide plan cache (it
     *replaces* the analytic entry for the (op, target) pair) and in the
     versioned :class:`TuningRecord` store keyed by (op spec, target).
     ``Planner.cache.save()/load()`` round-trips both, in the reference's
     format, so serving never re-searches (``search_count()`` is the
     witness).

The analytic tiles are always in the timed set, so the tuned plan is never
slower than the analytic one under the timer that ranked it.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import math
import re
import threading
from typing import Any, Dict, List, Optional, Tuple, Union

import torch

from repro_torch.analysis.roofline import alpha_beta_seconds
from repro_torch.core.conv_model import ConvShape, ceil_div, round_up
from repro_torch.core.tiling import (conv_kernel_tiles_fit,
                                     fit_conv_kernel_tiles, snap_tile)

from . import planner as _planner
from .ops import ConvSpec, MatmulSpec, OpSpec, as_op_spec, op_from_dict
from .planner import ExecutionPlan, TunedSection, analytic_plan
from .target import H100, HardwareTarget

# v1: {version, op, target, target_fingerprint, tiles, grid, tuned}.
TUNING_FORMAT_VERSION = 1

# words -> storage dtype of a spec stream (the inverse of the kernels'
# itemsize/4 spec precision); exotic widths are unsearchable.
_WIDTH_DTYPES = {1.0: torch.float32, 0.5: torch.bfloat16, 0.25: torch.int8}


@dataclasses.dataclass(frozen=True)
class AutotunePolicy:
    """Knobs of one frontier search. Frozen/hashable so it can ride
    ``ExecutionContext(autotune=...)``.

    ``slack`` bounds candidate words relative to the analytic optimum (the
    frontier width); ``bound_cap`` additionally caps words against the
    plan's Thm 2.1 lower bound (on shapes where the analytic optimum itself
    exceeds the cap, the analytic words become the cap: tuning never
    worsens the bound ratio); ``max_candidates`` limits how many frontier
    survivors are audited and timed (ranked by the offline alpha-beta model
    first); ``timer`` picks the harness — ``"device"`` (device time on the
    card, best of ``best_of`` graph replays after ``warmup`` warm calls),
    ``"roofline"`` (offline, deterministic), or ``"auto"`` (device iff
    ``torch.cuda.is_available()``)."""

    slack: float = 1.25
    bound_cap: float = 1.3
    max_candidates: int = 16
    best_of: int = 3
    warmup: int = 1
    timer: str = "auto"  # "auto" | "device" | "roofline"

    @classmethod
    def coerce(cls, value: Any) -> Optional["AutotunePolicy"]:
        """None/False -> None (autotune off); True -> defaults; a policy
        passes through. Anything else is a caller bug."""
        if value is None or value is False:
            return None
        if value is True:
            return cls()
        if isinstance(value, cls):
            return value
        raise TypeError(f"autotune policy must be None/bool/AutotunePolicy, "
                        f"got {type(value).__name__}")


@dataclasses.dataclass(frozen=True)
class TuningRecord:
    """One persisted frontier winner: the (op, target) key — op spec carries
    the shapes and dtypes, the target its fingerprint — plus the winning
    tiles/grid and the :class:`TunedSection` provenance. The reference's
    format: a record either package writes loads in the other."""

    op: OpSpec
    target: HardwareTarget
    tiles: Tuple[int, ...]
    grid: Tuple[int, ...]
    tuned: TunedSection

    @property
    def fingerprint(self) -> str:
        return target_fingerprint(self.target)

    def to_dict(self) -> Dict[str, Any]:
        return {"version": TUNING_FORMAT_VERSION,
                "op": self.op.to_dict(),
                "target": self.target.to_dict(),
                "target_fingerprint": self.fingerprint,
                "tiles": list(self.tiles),
                "grid": list(self.grid),
                "tuned": self.tuned.to_dict()}

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "TuningRecord":
        if d.get("version", 1) > TUNING_FORMAT_VERSION:
            raise ValueError(f"tuning record format {d['version']} is newer "
                             f"than supported {TUNING_FORMAT_VERSION}")
        target = HardwareTarget.from_dict(d["target"])
        fp = d.get("target_fingerprint")
        if fp is not None and fp != target_fingerprint(target):
            raise ValueError(
                f"tuning record fingerprint {fp} does not match its own "
                "target dict — the record was edited or the target "
                "serialization changed; re-tune instead of trusting it")
        return cls(op=op_from_dict(d["op"]), target=target,
                   tiles=tuple(int(v) for v in d["tiles"]),
                   grid=tuple(int(v) for v in d["grid"]),
                   tuned=TunedSection.from_dict(d["tuned"]))


@dataclasses.dataclass(frozen=True)
class TimedCandidate:
    """One audited candidate of a search and its time under the search's
    timer (``seconds``) beside the offline model's (``offline_seconds``)."""

    tiles: Tuple[int, ...]
    grid: Tuple[int, ...]
    words: float
    seconds: float
    offline_seconds: float


@dataclasses.dataclass(frozen=True)
class SearchReport:
    """What one frontier search saw, kept beside its :class:`TuningRecord`
    in the store (not persisted: a loaded record has none). Candidates
    ``enumerated``, in the ``frontier`` (slack and bound cap), ``kept`` for
    the audit (``max_candidates``, plus the analytic tiles), then split into
    ``timed`` (audited) and ``not_auditable`` ((reason, count) pairs)."""

    timer: str  # "device" | "roofline"
    enumerated: int
    frontier: int
    kept: int
    not_auditable: Tuple[Tuple[str, int], ...]
    analytic: Tuple[int, ...]
    timed: Tuple[TimedCandidate, ...]

    def _pick(self, key) -> TimedCandidate:
        return min(self.timed, key=key)

    @property
    def winner(self) -> TimedCandidate:
        return self._pick(lambda c: (c.seconds, c.words, c.tiles))

    @property
    def roofline_pick(self) -> TimedCandidate:
        """The candidate the offline model would have picked."""
        return self._pick(lambda c: (c.offline_seconds, c.words, c.tiles))

    @property
    def analytic_candidate(self) -> TimedCandidate:
        return next(c for c in self.timed if c.tiles == self.analytic)


def _normalize(op: OpSpec, target: HardwareTarget) -> OpSpec:
    """Pin ``prec=None`` (target-default precision) specs to the target's
    concrete precision: a kernel entry re-derives its spec from real dtypes
    (explicit prec), so records must key on the resolved form for both entry
    paths to share one TuningRecord."""
    if getattr(op, "prec", None) is None:
        return dataclasses.replace(op, prec=target.precision)
    return op


def target_fingerprint(target: HardwareTarget) -> str:
    """Stable 12-hex digest of the target's serialized form — the part of
    the TuningRecord key that invalidates records when the hardware model
    (shared memory, alignment, precision policy...) changes."""
    blob = json.dumps(target.to_dict(), sort_keys=True)
    return hashlib.sha256(blob.encode()).hexdigest()[:12]


# ---------------------------------------------------------------------------
# The TuningRecord store (process-wide, mirrored to disk by PlanCache).
# ---------------------------------------------------------------------------

_RECORDS: Dict[Tuple[OpSpec, HardwareTarget], TuningRecord] = {}
_REPORTS: Dict[Tuple[OpSpec, HardwareTarget], SearchReport] = {}
_LOCK = threading.Lock()
_SEARCHES = 0  # frontier searches actually run (cache hits don't count)


def search_count() -> int:
    """Frontier searches run so far in this process. Survives
    ``PlanCache.clear()`` on purpose: a save/clear/load round trip followed
    by re-planning must leave this unchanged (zero re-searches)."""
    return _SEARCHES


def reset_search_count() -> None:
    global _SEARCHES
    _SEARCHES = 0


def records() -> List[TuningRecord]:
    """Snapshot of every stored tuning record (insertion order)."""
    with _LOCK:
        return list(_RECORDS.values())


def search_report(op: Union[OpSpec, ConvShape],
                  target: HardwareTarget = H100) -> Optional[SearchReport]:
    """The report of the search this process ran for (op, target), or None
    (never searched here, or the record came from a cache load)."""
    op = _normalize(as_op_spec(op), target)
    with _LOCK:
        return _REPORTS.get((op, target))


def clear_records() -> None:
    """Drop all tuning records and search reports, and evict their
    materialized plans from the plan cache (analytic entries stay)."""
    with _LOCK:
        _RECORDS.clear()
        _REPORTS.clear()
    with _planner._CACHE_LOCK:
        for key in [k for k, p in _planner._CACHE.items()
                    if p.tuned is not None]:
            del _planner._CACHE[key]


def install_record(rec: TuningRecord) -> None:
    """Adopt a tuning record (fresh search or cache load). The stale plan-
    cache entry for its key is evicted so the winner takes over process-wide
    on the next resolve."""
    key = (rec.op, rec.target)
    with _LOCK:
        _RECORDS[key] = rec
    with _planner._CACHE_LOCK:
        _planner._CACHE.pop(key, None)


def lookup_plan(op: Union[OpSpec, ConvShape], target: HardwareTarget
                ) -> Optional[ExecutionPlan]:
    """The tuned plan for (op, target) if a record exists, else None.
    Materialization is memoized through the process-wide plan cache."""
    op = _normalize(as_op_spec(op), target)
    with _LOCK:
        rec = _RECORDS.get((op, target))
    if rec is None:
        return None
    return _materialize(rec, op, target)


def _materialize(rec: TuningRecord, op: OpSpec, target: HardwareTarget
                 ) -> ExecutionPlan:
    """Graft the record's winner onto an analytic base plan (bounds,
    blocking witness and dtypes are the base's), validate it through the
    registered plan-audit hooks, and install it as THE cached plan for the
    pair."""
    key = (op, target)
    with _planner._CACHE_LOCK:
        cached = _planner._CACHE.get(key)
    if cached is not None and cached.tuned == rec.tuned \
            and cached.tiles == rec.tiles:
        return cached
    base = cached if (cached is not None and cached.tuned is None) else None
    if base is None:
        base = (_planner._plan_conv(op, target) if isinstance(op, ConvSpec)
                else _planner._plan_matmul(op, target))
    tuned = dataclasses.replace(
        base, tiles=rec.tiles, grid=rec.grid,
        comm_volume=float(rec.tuned.winner_words),
        efficiency=float(rec.tuned.winner_words) / max(base.lower_bound, 1.0),
        tuned=rec.tuned)
    for hook in _planner._PLAN_AUDIT_HOOKS:
        hook(tuned)
    with _planner._CACHE_LOCK:
        _planner._CACHE[key] = tuned
    return tuned


# ---------------------------------------------------------------------------
# Op call derivation: OpSpec -> (op name, spec args, spec kw) for the
# registry's cuda entry — the same call shape ops.explain consumes.
# ---------------------------------------------------------------------------

def _dtype_of(width: float):
    try:
        return _WIDTH_DTYPES[float(width)]
    except KeyError:
        raise ValueError(f"no searchable dtype for stream width {width}")


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def _op_call(op: OpSpec, target: HardwareTarget
             ) -> Tuple[str, tuple, Dict[str, Any]]:
    prec = op.prec or target.precision
    if isinstance(op, ConvSpec):
        H = (op.h_O - 1) * op.sh + op.h_F  # tight VALID input extent
        W = (op.w_O - 1) * op.sw + op.w_F
        xd, wd, od = (_dtype_of(prec.p_I), _dtype_of(prec.p_F),
                      _dtype_of(prec.p_O))
        xs = _meta((op.N, op.c_I, H, W), xd)
        ws = _meta((op.c_O, op.c_I, op.h_F, op.w_F), wd)
        kw = {"stride": (op.sh, op.sw), "out_dtype": od}
        if xd == torch.int8:
            return "conv2d_q", (xs, ws, _meta((1, op.c_O), torch.float32)), kw
        return "conv2d", (xs, ws), kw
    if isinstance(op, MatmulSpec):
        ad, bd, od = (_dtype_of(prec.p_I), _dtype_of(prec.p_F),
                      _dtype_of(prec.p_O))
        a = _meta((op.m, op.k), ad)
        b = _meta((op.k, op.n), bd)
        kw = {"out_dtype": od}
        if ad == torch.int8:
            return "matmul_q", (a, b, _meta((1, op.n), torch.float32)), kw
        return "matmul", (a, b), kw
    raise TypeError(f"autotune cannot search {type(op).__name__} plans "
                    "(attention tiles are closed-form)")


def supports(op: Union[OpSpec, ConvShape],
             target: HardwareTarget = H100) -> bool:
    """True iff the frontier enumerator can search this (op, target)."""
    try:
        _op_call(as_op_spec(op), target)
        return True
    except (TypeError, ValueError):
        return False


# ---------------------------------------------------------------------------
# Frontier enumeration (the reference's sets, in its order).
# ---------------------------------------------------------------------------

def _axis_options(v: int, cap: int, spatial: bool) -> List[int]:
    opts = {1, v // 2, v, v * 2, v * 4, cap}
    if spatial:
        # divisor-aligned spatial blocks avoid padded-launch waste entirely
        opts |= {d for d in range(1, cap + 1) if cap % d == 0}
    return sorted({min(cap, max(1, o)) for o in opts if o})


def _conv_candidates(op: ConvSpec, target: HardwareTarget,
                     base: Tuple[int, ...]) -> List[Tuple[int, ...]]:
    shape = op.to_shape(target.precision)
    mem = target.memory_model()
    caps = (op.N, op.c_I, op.c_O, op.h_O, op.w_O)
    axes = [_axis_options(base[0], caps[0], False),
            _axis_options(base[1], caps[1], False),
            _axis_options(base[2], caps[2], False),
            _axis_options(base[3], caps[3], True),
            _axis_options(base[4], caps[4], True)]
    seen: Dict[Tuple[int, ...], None] = {tuple(base): None}
    for bN in axes[0]:
        for b_cI in axes[1]:
            for b_cO in axes[2]:
                for bh in axes[3]:
                    for bw in axes[4]:
                        t = fit_conv_kernel_tiles(
                            shape, (bN, b_cI, b_cO, bh, bw), mem)
                        if conv_kernel_tiles_fit(shape, t, mem):
                            seen.setdefault(tuple(t), None)
    return list(seen)


def _matmul_candidates(op: MatmulSpec, target: HardwareTarget,
                       base: Tuple[int, ...]) -> List[Tuple[int, ...]]:
    prec = op.prec or target.precision
    mem = target.memory_model()
    al = (max(target.align_sublane, 1), max(target.align_lane, 1),
          max(target.align_lane, 1))
    caps = (op.m, op.n, op.k)

    def fp(t):
        return (t[0] * t[2] * prec.p_I + t[2] * t[1] * prec.p_F
                + t[0] * t[1] * prec.p_O)

    seen: Dict[Tuple[int, ...], None] = {tuple(base): None}
    axes = [_axis_options(base[i], caps[i], False) for i in range(3)]
    for bm in axes[0]:
        for bn in axes[1]:
            for bk in axes[2]:
                t = (min(snap_tile(bm, al[0], caps[0]),
                         round_up(caps[0], al[0])),
                     min(snap_tile(bn, al[1], caps[1]),
                         round_up(caps[1], al[1])),
                     min(snap_tile(bk, al[2], caps[2]),
                         round_up(caps[2], al[2])))
                t = _planner._fit_matmul_tiles(t, prec, mem, target)
                if fp(t) <= mem.M_eff:
                    seen.setdefault(tuple(t), None)
    return list(seen)


def _candidate_grid(op: OpSpec, t: Tuple[int, ...]) -> Tuple[int, ...]:
    if isinstance(op, ConvSpec):
        return (ceil_div(op.N, t[0]), ceil_div(op.c_O, t[2]),
                ceil_div(op.h_O, t[3]), ceil_div(op.w_O, t[4]),
                ceil_div(op.c_I, t[1]))
    return (ceil_div(op.m, t[0]), ceil_div(op.n, t[1]),
            ceil_div(op.k, t[2]))


def _transfers(grid: Tuple[int, ...]) -> int:
    """Transfers of one launch: two streamed operand copies per grid step
    (both kernels stream input+filter / A+B per reduction step) plus one
    output store per outer cell (the last grid axis is the reduction)."""
    steps = math.prod(grid)
    return 2 * steps + steps // max(grid[-1], 1)


def _offline_seconds(words: float, grid: Tuple[int, ...]) -> float:
    return alpha_beta_seconds(words, _transfers(grid))


def predicted_seconds(plan: ExecutionPlan,
                      words: Optional[float] = None) -> float:
    """Offline alpha-beta wall time of one launch of ``plan`` — the model
    the roofline timer ranks candidates with, so analytic and tuned plans
    are comparable on it. ``words`` defaults to the plan's
    ``comm_volume``; pass the measured words of the exact launch geometry
    when available."""
    w = float(plan.comm_volume if words is None else words)
    return _offline_seconds(w, plan.grid)


def _candidate_plan(base: ExecutionPlan, op: OpSpec, tiles: Tuple[int, ...],
                    words: float) -> ExecutionPlan:
    return dataclasses.replace(
        base, tiles=tuple(tiles), grid=_candidate_grid(op, tiles),
        comm_volume=float(words),
        efficiency=float(words) / max(base.lower_bound, 1.0))


# ---------------------------------------------------------------------------
# The audit gate: the launch a candidate would make, as repro_torch.verify
# sees it.
# ---------------------------------------------------------------------------

# The H100 kernels' launch limits, by what their ValueError says.
_LAUNCH_LIMITS = (
    ("accumulator tile does not fit", "accumulators above a CTA's registers"),
    ("bytes of shared memory", "shared memory above a block's"),
    ("exceeds 16-bit offsets", "window above the 16-bit offsets"),
)


def _reason(message: str) -> str:
    for key, name in _LAUNCH_LIMITS:
        if key in message:
            return name
    return re.sub(r"\d+(\.\d+)?", "#", message)


def _audit_failure(entry, ctx, op_name: str, spec_args: tuple,
                   spec_kw: dict, cand: ExecutionPlan, words: float
                   ) -> Optional[str]:
    """None when the candidate's access plan reproduces its words exactly,
    fits the card and is hazard-free; else why not (the launch limit its
    ``ValueError`` names, or the audit's first problem)."""
    from repro_torch.ops.dispatch import DispatchDecision
    from repro_torch.verify import audit as _audit

    try:
        ap = entry.access_plan_fn(ctx, cand, *spec_args, **spec_kw)
    except ValueError as exc:
        return _reason(str(exc))
    decision = DispatchDecision(op=op_name, requested="cuda", chosen="cuda",
                                plan=cand, measured_words=words,
                                plan_source="explicit")
    report = _audit.audit_decision(ap, decision, target=ctx.target)
    if report.ok:
        return None
    first = report.problems[0] if report.problems else str(report.hazards[0])
    return "audit: " + _reason(first)


# ---------------------------------------------------------------------------
# The timers.
# ---------------------------------------------------------------------------

def _use_device_timer(policy: AutotunePolicy) -> bool:
    if policy.timer == "device":
        return True
    if policy.timer == "roofline":
        return False
    return torch.cuda.is_available()


def _device_operands(op: OpSpec, op_name: str, spec_args: tuple) -> tuple:
    """The search's operands on the card, made once from a generator seeded
    from the op: normal values for f32/bf16 streams, int8 codes in
    [-127, 127] and a positive folded scale for the int8 ops. Never zeros:
    an all-zero tensor-core operand draws less power and clocks otherwise."""
    blob = json.dumps(op.to_dict(), sort_keys=True).encode()
    gen = torch.Generator(device="cuda")
    gen.manual_seed(int(hashlib.sha256(blob).hexdigest()[:8], 16))
    out = []
    for i, a in enumerate(spec_args):
        if a.dtype == torch.int8:
            t = torch.randint(-127, 128, a.shape, generator=gen,
                              device="cuda", dtype=torch.int8)
        elif op_name.endswith("_q") and i == 2:
            t = (torch.rand(a.shape, generator=gen, device="cuda")
                 + 0.5) / 127.0 ** 2
        else:
            t = torch.randn(a.shape, generator=gen, device="cuda",
                            dtype=a.dtype)
        out.append(t)
    return tuple(out)


def _time_device(op_name: str, ctx, args: tuple, spec_kw: dict,
                 cand: ExecutionPlan, policy: AutotunePolicy) -> float:
    """Device seconds of one call of the candidate through the real dispatch
    path (explicit plan override: the kernel launches exactly the
    candidate's tiles): ``policy.warmup`` warm calls, then the best of
    ``policy.best_of`` replays of a CUDA graph of its calls."""
    from repro_torch import ops as _ops
    from repro_torch.analysis.timing import calls_per_graph, graph_ms_per_call

    def call():
        return _ops.dispatch_call(op_name, ctx, args[0].dtype, (), args,
                                  spec_kw=spec_kw, plan=cand)

    ms = graph_ms_per_call(call, n=calls_per_graph(call),
                           replays=max(1, policy.best_of),
                           warmup=max(1, policy.warmup), best=True)
    return ms / 1e3


# ---------------------------------------------------------------------------
# The search: enumerate -> filter (slack, bound, audit) -> time -> persist.
# ---------------------------------------------------------------------------

def _search(op: OpSpec, target: HardwareTarget, policy: AutotunePolicy
            ) -> Tuple[TuningRecord, SearchReport]:
    global _SEARCHES
    _SEARCHES += 1
    from repro_torch.ops import ExecutionContext
    from repro_torch.ops import registry as _registry

    op_name, spec_args, spec_kw = _op_call(op, target)
    device = _use_device_timer(policy)
    ctx = ExecutionContext(target=target, backend="cuda",
                           device="cuda" if device else "cpu")
    entry = _registry.get_backend("cuda").ops[op_name]
    got = entry.spec_fn(*spec_args, **spec_kw)
    if got != op:
        raise ValueError(
            f"autotune spec round-trip failed: derived call re-specs to "
            f"{got}, not {op} — refusing to tune the wrong op")

    base = analytic_plan(op, target)
    if base.tuned is not None:  # cache already holds a winner's plan: rebuild
        base = (_planner._plan_conv(op, target) if isinstance(op, ConvSpec)
                else _planner._plan_matmul(op, target))

    def words_of(cand: ExecutionPlan) -> float:
        return float(entry.words_fn(ctx, cand, *spec_args, **spec_kw))

    tiles_list = (_conv_candidates(op, target, base.tiles)
                  if isinstance(op, ConvSpec)
                  else _matmul_candidates(op, target, base.tiles))
    base_words = words_of(base)
    # The bound cap never excludes the analytic plan itself: on shapes whose
    # analytic optimum sits above bound_cap x the Thm 2.1 bound (four of
    # the five H100 conv plans of ResNet-50 do), the analytic words become
    # the cap — tuning may never *worsen* the ratio.
    cap = max(policy.bound_cap * base.lower_bound, base_words)
    frontier: List[Tuple[ExecutionPlan, float]] = []
    for t in tiles_list:
        w = words_of(_candidate_plan(base, op, t, 0.0))
        if w > policy.slack * base_words + 1e-9:
            continue
        if w > cap + 1e-9:
            continue
        frontier.append((_candidate_plan(base, op, t, w), w))
    # rank by the offline model; the analytic tiles are always kept so the
    # winner can never rank behind the plan it started from
    frontier.sort(key=lambda cw: (_offline_seconds(cw[1], cw[0].grid),
                                  cw[1], cw[0].tiles))
    keep = frontier[:max(1, policy.max_candidates)]
    if not any(c.tiles == base.tiles for c, _ in keep):
        keep.append((_candidate_plan(base, op, base.tiles, base_words),
                     base_words))

    audited: List[Tuple[ExecutionPlan, float]] = []
    refused: Dict[str, int] = {}
    for cand, w in keep:
        why = _audit_failure(entry, ctx, op_name, spec_args, spec_kw, cand, w)
        if why is None:
            audited.append((cand, w))
        elif cand.tiles == base.tiles:
            raise RuntimeError(
                f"autotune: the analytic tiles {base.tiles} of {op} on "
                f"{target.name!r} do not audit ({why})")
        else:
            refused[why] = refused.get(why, 0) + 1

    args = _device_operands(op, op_name, spec_args) if device else None
    timed: List[TimedCandidate] = []
    for cand, w in audited:
        offline = _offline_seconds(w, cand.grid)
        secs = (_time_device(op_name, ctx, args, spec_kw, cand, policy)
                if device else offline)
        timed.append(TimedCandidate(cand.tiles, cand.grid, w, secs, offline))
    report = SearchReport(timer="device" if device else "roofline",
                          enumerated=len(tiles_list), frontier=len(frontier),
                          kept=len(keep),
                          not_auditable=tuple(sorted(refused.items())),
                          analytic=tuple(base.tiles), timed=tuple(timed))
    win = report.winner
    tuned = TunedSection(source=report.timer, candidates_timed=len(timed),
                         winner_words=win.words, winner_seconds=win.seconds)
    return TuningRecord(op=op, target=target, tiles=win.tiles,
                        grid=win.grid, tuned=tuned), report


def autotune(op: Union[OpSpec, ConvShape], target: HardwareTarget = H100,
             policy: Any = None) -> ExecutionPlan:
    """Tuned plan for (op, target): reuse the stored TuningRecord, else run
    one frontier search and persist the winner (plan cache + record store).
    Raises TypeError/ValueError for unsearchable ops — guard with
    :func:`supports` when tuning opportunistically."""
    op = _normalize(as_op_spec(op), target)
    pol = AutotunePolicy.coerce(policy if policy is not None else True)
    with _LOCK:
        rec = _RECORDS.get((op, target))
    if rec is None:
        rec, report = _search(op, target, pol)
        install_record(rec)
        with _LOCK:
            _REPORTS[(op, target)] = report
    return _materialize(rec, op, target)
