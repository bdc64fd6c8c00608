"""Abstract interpretation of :class:`KernelAccessPlan`s: the static
auditor. The port of ``repro.verify.audit``.

``audit_access_plan`` walks a kernel's walk grid with numpy (row-major, last
axis innermost: the CUDA grid's CTAs in the order the hardware numbers
them, then the kernel's ring stages), evaluates every operand's index map /
window over all steps at once, and computes the exact global-memory words
the launch moves:

  * Block operands move their block only when the mapped index *changes*
    between consecutive steps, so words = transition count x block words.
  * Window operands copy every step: words = the sum over steps of the
    window's elements. Their windows are bounds-checked against the padded
    array extent and checked to *cover* the independently derived
    ``requires`` region, the check with teeth against off-by-one halo index
    maps, whose word totals are unchanged.
  * Flat operands contribute their words as-is.

The report splits the words three ways: ``counted_words`` (what the op's
``words_fn`` should report: the counted accesses plus the plan's
``skipped`` ones), ``issued_words`` (every load and store the kernel
issues, counted or not) and, within it, ``uncounted`` (per access, what the
counter does not charge); ``shortfall`` is what the counter charges and
the kernel does not issue.

``audit_decision`` then holds a ``DispatchDecision`` to account: the counted
words must equal the op's ``words_fn`` result exactly, the CTA's shared
memory must fit the target's ``vmem_words`` (232,448 bytes under ``H100``),
conv tiles must fit the plan's ``kernel_footprints`` budget, the audited
bound ratio must not exceed the recorded one, the walk grid's CTAs must be
the launch's, and every ring schedule must simulate hazard-free
(``repro_torch.verify.hazards``).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from . import hazards as hz
from .access import BlockAccess, FlatAccess, KernelAccessPlan, WindowAccess

# Counted-vs-words_fn slack: pure float-association noise. Word *models*
# drifting from the kernel show up orders of magnitude above this.
REL_TOL = 1e-6


class AuditError(RuntimeError):
    """A kernel's static audit found mismatches, violations, or hazards."""

    def __init__(self, report: "AuditReport"):
        self.report = report
        lines = [f"static audit failed for {report.op}:"]
        lines += [f"  - {p}" for p in report.problems]
        lines += [f"  - hazard {h}" for h in report.hazards]
        super().__init__("\n".join(lines))


@dataclasses.dataclass
class AuditReport:
    op: str
    grid: Tuple[int, ...]
    n_steps: int
    loaded_words: float  # all load traffic, counted or not
    stored_words: float
    counted_words: float  # what the op's words_fn should report
    per_access: Dict[str, float]
    problems: List[str]
    hazards: List[hz.Hazard]
    measured_words: Optional[float] = None
    uncounted: Dict[str, float] = dataclasses.field(default_factory=dict)
    shortfall: float = 0.0  # charged by words_fn, not issued
    launch: Optional[object] = None  # the plan's access.CudaLaunch

    @property
    def ok(self) -> bool:
        return not self.problems and not self.hazards

    @property
    def issued_words(self) -> float:
        """Every load and store the kernel issues, counted or not."""
        return self.loaded_words + self.stored_words


def _prod(xs: Sequence[int]) -> int:
    out = 1
    for x in xs:
        out *= int(x)
    return out


def _grid_axes(grid: Tuple[int, ...]) -> Tuple[List[np.ndarray], int]:
    """One int64 array per grid axis, flattened row-major (last axis
    fastest)."""
    if not grid:
        return [], 1
    idx = np.indices(tuple(int(g) for g in grid), dtype=np.int64)
    idx = idx.reshape(len(grid), -1)
    return [idx[i] for i in range(len(grid))], idx.shape[1]


def _as_steps(x, n_steps: int) -> np.ndarray:
    return np.broadcast_to(np.asarray(x, dtype=np.int64), (n_steps,))


def _audit_block(acc: BlockAccess, axes: List[np.ndarray], n_steps: int,
                 problems: List[str]) -> float:
    cols = [_as_steps(c, n_steps) for c in acc.index_map(*axes)]
    if len(cols) != len(acc.array_shape):
        problems.append(f"{acc.name}: index_map yields {len(cols)} dims for a "
                        f"{len(acc.array_shape)}-d array")
        return 0.0
    for d, (c, b, ext) in enumerate(zip(cols, acc.block_shape,
                                        acc.array_shape)):
        if int(c.min()) < 0:
            problems.append(f"{acc.name}: dim {d} block index "
                            f"{int(c.min())} < 0")
        if (int(c.max()) + 1) * int(b) > int(ext):
            problems.append(
                f"{acc.name}: dim {d} block {int(c.max())} x {b} spans past "
                f"the padded extent {ext}")
    mat = np.stack(cols)
    changed = np.ones(n_steps, dtype=bool)
    if n_steps > 1:
        changed[1:] = (mat[:, 1:] != mat[:, :-1]).any(axis=0)
    return float(changed.sum()) * _prod(acc.block_shape) * acc.word_size


def _audit_window(acc: WindowAccess, axes: List[np.ndarray], n_steps: int,
                  problems: List[str]) -> float:
    win = acc.window(*axes)
    if len(win) != len(acc.array_shape):
        problems.append(f"{acc.name}: window yields {len(win)} dims for a "
                        f"{len(acc.array_shape)}-d array")
        return 0.0
    starts, sizes = [], []
    for d, ((start, size), ext) in enumerate(zip(win, acc.array_shape)):
        start, size = _as_steps(start, n_steps), _as_steps(size, n_steps)
        starts.append(start)
        sizes.append(size)
        live = size > 0  # a step that copies nothing reads no extent
        if not live.any():
            continue
        if int(size.min()) < 0:
            problems.append(f"{acc.name}: dim {d} window size "
                            f"{int(size.min())} < 0")
        if int(start[live].min()) < 0:
            problems.append(f"{acc.name}: dim {d} window start "
                            f"{int(start[live].min())} < 0")
        end = start + size
        if int(end[live].max()) > int(ext):
            i = int(np.argmax(np.where(live, end, -1)))
            problems.append(
                f"{acc.name}: dim {d} window [{int(start[i])}, "
                f"{int(end[i])}) exceeds the padded extent {ext}")
    if acc.requires is not None:
        req = acc.requires(*axes)
        for d, ((lo, hi), start, size) in enumerate(zip(req, starts, sizes)):
            lo, hi = _as_steps(lo, n_steps), _as_steps(hi, n_steps)
            need = hi > lo
            miss_lo = need & (lo < start)
            miss_hi = need & (hi > start + size)
            if bool(miss_lo.any()) or bool(miss_hi.any()):
                i = int(np.argmax(miss_lo | miss_hi))
                problems.append(
                    f"{acc.name}: dim {d} window [{int(starts[d][i])}, "
                    f"{int(starts[d][i]) + int(size[i])}) at step {i} misses "
                    f"the required elements [{int(lo[i])}, {int(hi[i])})")
    elems = np.ones(n_steps, dtype=np.float64)
    for size in sizes:
        elems *= size
    return float(elems.sum()) * acc.word_size


def _access_words(acc, axes, n_steps, problems) -> Optional[float]:
    if isinstance(acc, BlockAccess):
        return _audit_block(acc, axes, n_steps, problems)
    if isinstance(acc, WindowAccess):
        return _audit_window(acc, axes, n_steps, problems)
    if isinstance(acc, FlatAccess):
        return float(acc.words)
    problems.append(f"unknown access type {type(acc).__name__}")
    return None


def audit_access_plan(ap: KernelAccessPlan) -> AuditReport:
    """Walk the grid; count exact words; bounds/coverage-check every operand;
    check the walk against the launch; simulate the ring schedules."""
    axes, n_steps = _grid_axes(ap.grid)
    problems: List[str] = []
    per_access: Dict[str, float] = {}
    uncounted: Dict[str, float] = {}
    loaded = stored = counted = shortfall = 0.0
    for acc in ap.accesses:
        words = _access_words(acc, axes, n_steps, problems)
        if words is None:
            continue
        per_access[acc.name] = words
        if acc.kind == "store":
            stored += words
        else:
            loaded += words
        if acc.counted:
            counted += words
        else:
            uncounted[acc.name] = uncounted.get(acc.name, 0.0) + words
    for acc in ap.skipped:
        words = _access_words(acc, axes, n_steps, problems)
        if words is None:
            continue
        per_access[f"{acc.name} (skipped)"] = words
        counted += words
        shortfall += words
    if ap.launch is not None and len(ap.grid) > 1:
        ctas = _prod(ap.grid[:-1])
        if ctas != ap.launch.ctas:
            problems.append(
                f"{ap.op}: the walk's {ctas} CTAs (grid {ap.grid}, stages "
                f"innermost) are not the launch's {ap.launch.ctas} "
                f"(grid {ap.launch.grid})")
        if ap.scratch and ap.scratch_words() * 4 != ap.launch.smem_bytes:
            problems.append(
                f"{ap.op}: the shared-memory layout's "
                f"{ap.scratch_words() * 4:.0f} bytes are not the launch's "
                f"{ap.launch.smem_bytes}")
    found: List[hz.Hazard] = []
    for sched in ap.schedules():
        found += hz.check_schedule(sched)
    return AuditReport(op=ap.op, grid=ap.grid, n_steps=n_steps,
                       loaded_words=loaded, stored_words=stored,
                       counted_words=counted, per_access=per_access,
                       problems=problems, hazards=found, uncounted=uncounted,
                       shortfall=shortfall, launch=ap.launch)


def _close(a: float, b: float) -> bool:
    return abs(a - b) <= REL_TOL * max(abs(a), abs(b), 1.0)


def audit_decision(ap: KernelAccessPlan, decision, target=None
                   ) -> AuditReport:
    """Audit one dispatch: the access plan's counted words must reproduce
    ``decision.measured_words`` exactly, the CTA's shared memory must fit
    the target's, conv tiles must fit the ``kernel_footprints`` budget, and
    the audited bound ratio must not exceed the recorded one."""
    from repro_torch.core.tiling import conv_kernel_tiles_fit
    from repro_torch.plan.ops import ConvSpec

    report = audit_access_plan(ap)
    report.measured_words = decision.measured_words
    if decision.measured_words is None:
        report.problems.append(
            f"{ap.op}: dispatch carries no measured_words (missing words_fn "
            "or spec args) — nothing to audit against")
        return report
    if not _close(report.counted_words, float(decision.measured_words)):
        report.problems.append(
            f"{ap.op}: audited words {report.counted_words:.6f} != words_fn "
            f"{float(decision.measured_words):.6f} "
            f"(delta {report.counted_words - float(decision.measured_words):+.6f})")
    tgt = target if target is not None else (
        decision.plan.target if decision.plan is not None else None)
    if tgt is not None and ap.scratch:
        if ap.scratch_words() > float(tgt.vmem_words) + 1e-9:
            report.problems.append(
                f"{ap.op}: shared-memory scratch {ap.scratch_words():.0f} "
                f"words exceeds the target's {tgt.vmem_words:.0f}")
    plan = decision.plan
    if plan is not None and isinstance(plan.op, ConvSpec) and tgt is not None:
        if not conv_kernel_tiles_fit(plan.to_shape(), plan.tiles,
                                     tgt.memory_model()):
            report.problems.append(
                f"{ap.op}: plan tiles {plan.tiles} overflow the "
                "kernel_footprints budget (conv_kernel_tiles_fit)")
    lb = decision.lower_bound
    ratio = decision.bound_ratio
    if lb is not None and ratio is not None:
        audited_ratio = report.counted_words / max(float(lb), 1.0)
        if audited_ratio > float(ratio) * (1.0 + REL_TOL):
            report.problems.append(
                f"{ap.op}: audited bound ratio {audited_ratio:.4f} exceeds "
                f"the recorded {float(ratio):.4f}")
    return report


# ---------------------------------------------------------------------------
# ExecutionPlan construction audit (the repro_torch.plan hook).
# ---------------------------------------------------------------------------

def validate_execution_plan(ep) -> List[str]:
    """Structural checks on a freshly built plan: the launch grid must cover
    the op, conv tiles must fit the exact halo-window budget, and the
    recorded efficiency must be consistent."""
    from repro_torch.core.tiling import conv_kernel_tiles_fit
    from repro_torch.plan.ops import AttentionSpec, ConvSpec, MatmulSpec

    problems: List[str] = []
    op, tiles, grid = ep.op, ep.tiles, ep.grid

    def cover(axis: str, n_blocks: int, block: int, extent: int) -> None:
        if n_blocks * block < extent:
            problems.append(f"grid does not cover {axis}: {n_blocks} x "
                            f"{block} < {extent}")

    if isinstance(op, ConvSpec):
        if len(tiles) != 5 or len(grid) != 5:
            problems.append(f"conv plan must carry 5 tiles/5 grid axes, got "
                            f"{tiles}/{grid}")
        else:
            cover("N", grid[0], tiles[0], op.N)
            cover("cO", grid[1], tiles[2], op.c_O)
            cover("hO", grid[2], tiles[3], op.h_O)
            cover("wO", grid[3], tiles[4], op.w_O)
            cover("cI", grid[4], tiles[1], op.c_I)
            if not conv_kernel_tiles_fit(ep.to_shape(), tiles,
                                         ep.target.memory_model()):
                problems.append(f"conv tiles {tiles} overflow the exact "
                                "halo-window budget")
    elif isinstance(op, MatmulSpec):
        if len(tiles) != 3 or len(grid) != 3:
            problems.append(f"matmul plan must carry 3 tiles/3 grid axes, "
                            f"got {tiles}/{grid}")
        else:
            cover("m", grid[0], tiles[0], op.m)
            cover("n", grid[1], tiles[1], op.n)
            cover("k", grid[2], tiles[2], op.k)
    elif isinstance(op, AttentionSpec):
        g = max(1, op.H // max(op.KV, 1))
        if len(tiles) != 2 or len(grid) != 3:
            problems.append(f"attention plan must carry 2 tiles/3 grid axes, "
                            f"got {tiles}/{grid}")
        else:
            if grid[0] != op.B * op.KV:
                problems.append(f"attention grid rows {grid[0]} != B*KV "
                                f"{op.B * op.KV}")
            cover("folded Lq", grid[1], tiles[0], g * op.Lq)
            cover("Lk", grid[2], tiles[1], op.Lk)
    if ep.lower_bound > 0 and not _close(
            ep.efficiency, ep.comm_volume / max(ep.lower_bound, 1.0)):
        problems.append("efficiency is not comm_volume / lower_bound")
    return problems


class PlanAuditError(RuntimeError):
    pass


def _plan_hook(ep) -> None:
    problems = validate_execution_plan(ep)
    if problems:
        raise PlanAuditError(
            "plan audit failed for " + repr(ep.op) + ":\n" +
            "\n".join(f"  - {p}" for p in problems))


def install_plan_audit() -> None:
    """Register the structural plan validator on ``repro_torch.plan``'s
    construction hook (idempotent). Every plan built afterwards is checked
    before it enters the cache."""
    from repro_torch.plan import planner

    planner.register_plan_audit_hook(_plan_hook)
