"""The planning front door: ``Planner(target).plan(op) -> ExecutionPlan``.

One discipline for the whole package (paper §3.2 eq. 6, §5): solve the
HBL-derived blocking LP against the target's memory-hierarchy model, refine to
integers, then lower the solution to kernel tile/grid shapes.

:class:`Planner` is the single public entry point: ``.plan(op)`` resolves
through :func:`resolve_plan` (explicit > analytic) and ``Planner.cache`` (a
process-wide :class:`PlanCache`) saves/loads the memoized plans. The measured
autotuner of ``repro.plan.autotune`` is not ported yet: a truthy
``autotune`` raises ``NotImplementedError``, and plans never carry a
``tuned`` section, although the section round-trips through JSON. Targets
with mesh axes (the reference's sharding leg) also raise
``NotImplementedError``. Attention ops take the closed-form leg
(:func:`_plan_attention`), as in the reference.

Plans are memoized process-wide, keyed on the (op, target) value pair. The
LP, the integer refinement and the tile lowering are the reference's, line
for line, so both packages give equal plans for equal (op, target) pairs.
"""

from __future__ import annotations

import dataclasses
import json
import threading
from typing import Any, Dict, Optional, Tuple, Union

from repro_torch.core.bounds import attention_bound, single_processor_bound
from repro_torch.core.conv_model import ConvShape, Precision, ceil_div, round_up
from repro_torch.core.tiling import (Blocking, attention_block_size,
                                     conv_kernel_footprints,
                                     fit_conv_kernel_tiles, matmul_blocking,
                                     optimize_blocking, snap_tile)

from .ops import (AttentionSpec, ConvSpec, MatmulSpec, OpSpec, as_op_spec,
                  op_from_dict)
from .target import H100, HardwareTarget

# The reference's plan format: v2 spatial conv tiles, v3 ``parallel``, v4
# attention plans, v5 ``dtypes``, v6 ``tuned``. Plans written by either
# package load in the other.
PLAN_FORMAT_VERSION = 6


def _width_dtype(width: float) -> str:
    """Storage-dtype name of a word width (int8 canonicalizes the 0.25-word
    class; other fractional widths keep their numeric form)."""
    names = {1.0: "float32", 0.5: "bfloat16", 0.25: "int8"}
    return names.get(float(width), f"words:{float(width):g}")


def _plan_dtypes(prec: Precision) -> Tuple[Tuple[str, str], ...]:
    """The per-operand dtype map a v5 plan carries. Accumulation is always
    f32."""
    return (("input", _width_dtype(prec.p_I)),
            ("filter", _width_dtype(prec.p_F)),
            ("output", _width_dtype(prec.p_O)),
            ("accum", "float32"))


@dataclasses.dataclass(frozen=True)
class TunedSection:
    """The measured-autotune provenance a v6 plan carries (None = analytic).
    The port never stamps one; it round-trips plans that have one."""

    source: str  # "device" | "roofline"
    candidates_timed: int
    winner_words: float
    winner_seconds: float

    def to_dict(self) -> Dict[str, Any]:
        return {"source": self.source,
                "candidates_timed": self.candidates_timed,
                "winner_words": self.winner_words,
                "winner_seconds": self.winner_seconds}

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "TunedSection":
        return cls(source=str(d["source"]),
                   candidates_timed=int(d["candidates_timed"]),
                   winner_words=float(d["winner_words"]),
                   winner_seconds=float(d["winner_seconds"]))


@dataclasses.dataclass(frozen=True)
class ExecutionPlan:
    """Everything a consumer needs to execute one op on one target.

    ``tiles`` is the kernel-facing tuple — (bN, b_cI, b_cO, b_hO, b_wO) for
    conv (the kernel loads overlapping halo windows of (b_hO - 1) * sh + h_F
    input rows), (bm, bn, bk) for matmul — and ``blocking`` the full 9-axis
    integer LP solution it was collapsed from. ``grid`` is the launch grid
    over the padded problem, in the reference's axis order (conv:
    (N, c_O, h_O, w_O, c_I) tiles; matmul: (m, n, k)). The reference's
    multi-device fields (``sharding``, ``parallel``) are absent: the port
    plans single-device targets only, and writes them as null.
    """

    op: OpSpec
    target: HardwareTarget
    blocking: Tuple[Tuple[str, int], ...]  # sorted (axis, block) pairs
    tiles: Tuple[int, ...]
    grid: Tuple[int, ...]
    comm_volume: float  # modeled slow<->fast words moved
    lower_bound: float  # Thm 2.1 bound at the target's effective capacity
    efficiency: float  # comm_volume / lower_bound
    dtypes: Tuple[Tuple[str, str], ...] = ()
    tuned: Optional[TunedSection] = None

    # -- views ---------------------------------------------------------------
    @property
    def blocking_dict(self) -> Dict[str, int]:
        return dict(self.blocking)

    @property
    def precision(self) -> Precision:
        return self.op.prec or self.target.precision

    def to_shape(self) -> ConvShape:
        return self.op.to_shape(self.target.precision)

    def as_blocking(self) -> Blocking:
        return Blocking(self.blocking_dict, self.to_shape())

    def conv_tiles(self) -> Tuple[int, int, int, int, int]:
        if not isinstance(self.op, ConvSpec):
            raise TypeError("conv_tiles() on a non-conv plan")
        return self.tiles  # (bN, b_cI, b_cO, b_hO, b_wO)

    def matmul_tiles(self) -> Tuple[int, int, int]:
        if not isinstance(self.op, MatmulSpec):
            raise TypeError("matmul_tiles() on a non-matmul plan")
        return self.tiles  # (bm, bn, bk)

    def conv_tile(self) -> Dict[str, int]:
        """The collapsed per-axis conv tile (as_conv_tile view)."""
        return self.as_blocking().as_conv_tile()

    def footprints(self) -> Dict[str, float]:
        """Words each array block occupies in fast memory (split-buffer
        accounting: input+filter -> scratchpad, output -> accumulator)."""
        blk = self.as_blocking()
        return {"input": blk.in_block_words, "filter": blk.filt_block_words,
                "output": blk.out_block_words}

    def kernel_footprints(self) -> Dict[str, float]:
        """Words the conv2d kernel holds per tile: the exact halo window
        ((b_hO - 1) * sh + h_F) x ((b_wO - 1) * sw + w_F) for the input and
        the full (h_F, w_F) filter block."""
        if not isinstance(self.op, ConvSpec):
            raise TypeError("kernel_footprints() on a non-conv plan")
        return conv_kernel_footprints(self.to_shape(), self.tiles)

    # -- (de)serialization ----------------------------------------------------
    def to_dict(self) -> Dict[str, Any]:
        return {
            "version": PLAN_FORMAT_VERSION,
            "op": self.op.to_dict(),
            "target": self.target.to_dict(),
            "blocking": [list(kv) for kv in self.blocking],
            "tiles": list(self.tiles),
            "grid": list(self.grid),
            "comm_volume": self.comm_volume,
            "lower_bound": self.lower_bound,
            "efficiency": self.efficiency,
            "sharding": None,
            "parallel": None,
            "dtypes": [list(kv) for kv in self.dtypes],
            "tuned": None if self.tuned is None else self.tuned.to_dict(),
        }

    def to_json(self, indent: Optional[int] = None) -> str:
        return json.dumps(self.to_dict(), indent=indent)

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "ExecutionPlan":
        if d.get("version", 1) > PLAN_FORMAT_VERSION:
            raise ValueError(f"plan format {d['version']} is newer than "
                             f"supported {PLAN_FORMAT_VERSION}")
        if d.get("sharding") is not None or d.get("parallel") is not None:
            raise NotImplementedError(
                "multi-device plans (sharding / parallel sections) need the "
                "multi-device planner, which repro_torch does not have yet")
        if d.get("version", 1) < 2 and d["op"].get("kind") == "conv":
            # v1 conv plans: 3-tuple tiles, (nN, n_cO, n_cI) grid. Upgrade to
            # the spatial-blocked form with spatial kept whole.
            op = d["op"]
            d = dict(d, tiles=list(d["tiles"]) + [op["h_O"], op["w_O"]],
                     grid=[d["grid"][0], d["grid"][1], 1, 1, d["grid"][2]])
        tuned = None
        if d.get("tuned") is not None:
            tuned = TunedSection.from_dict(d["tuned"])
        return cls(
            op=op_from_dict(d["op"]),
            target=HardwareTarget.from_dict(d["target"]),
            blocking=tuple((str(k), int(v)) for k, v in d["blocking"]),
            tiles=tuple(int(v) for v in d["tiles"]),
            grid=tuple(int(v) for v in d["grid"]),
            comm_volume=float(d["comm_volume"]),
            lower_bound=float(d["lower_bound"]),
            efficiency=float(d["efficiency"]),
            dtypes=tuple((str(k), str(v)) for k, v in d.get("dtypes", [])),
            tuned=tuned,
        )

    @classmethod
    def from_json(cls, s: str) -> "ExecutionPlan":
        return cls.from_dict(json.loads(s))


# ---------------------------------------------------------------------------
# The process-wide plan cache.
# ---------------------------------------------------------------------------

_CACHE: Dict[Tuple[OpSpec, HardwareTarget], ExecutionPlan] = {}
_CACHE_LOCK = threading.Lock()
PLAN_CACHE_MAX = 1024


class PlanCache:
    """Facade over the process-wide plan memoizer, reached as
    ``Planner.cache``. The JSON dump is the reference's ``{"format",
    "plans", "tuning"}`` dict (``tuning`` always empty here); a bare list of
    plan dicts also loads."""

    def size(self) -> int:
        with _CACHE_LOCK:
            return len(_CACHE)

    def clear(self) -> None:
        with _CACHE_LOCK:
            _CACHE.clear()

    def save(self, path: str) -> int:
        """Dump the memoized plans; returns entries written."""
        with _CACHE_LOCK:
            plans = list(_CACHE.values())
        with open(path, "w") as f:
            json.dump({"format": PLAN_FORMAT_VERSION,
                       "plans": [p.to_dict() for p in plans],
                       "tuning": []}, f, indent=1)
        return len(plans)

    def load(self, path: str) -> int:
        """Pre-populate plans from a dump; returns entries loaded. A dump
        with tuning records raises: serving them needs the autotuner."""
        with open(path) as f:
            dump = json.load(f)
        if isinstance(dump, dict) and dump.get("tuning"):
            raise NotImplementedError(
                "this dump carries autotuner records; repro_torch has no "
                "autotuner yet")
        plan_dicts = dump if isinstance(dump, list) else dump.get("plans", [])
        n = 0
        with _CACHE_LOCK:
            for d in plan_dicts:
                p = ExecutionPlan.from_dict(d)
                _CACHE.setdefault((p.op, p.target), p)
                n += 1
        return n


# ---------------------------------------------------------------------------
# Lowering: OpSpec x HardwareTarget -> ExecutionPlan.
# ---------------------------------------------------------------------------

def _conv_align(shape: ConvShape, target: HardwareTarget) -> Optional[Dict[str, int]]:
    align: Dict[str, int] = {}
    if target.align_lane > 1:
        align["cO"] = min(target.align_lane, shape.c_O)
    if target.align_sublane > 1:
        align["cI"] = min(target.align_sublane, shape.c_I)
    return align or None


def _plan_conv(op: ConvSpec, target: HardwareTarget) -> ExecutionPlan:
    shape = op.to_shape(target.precision)
    mem = target.memory_model()
    blk = optimize_blocking(shape, mem, align=_conv_align(shape, target))
    t = blk.as_conv_tile()
    # Kernel tiles carry the LP's spatial choice; the lifted LP footprint can
    # undercount the kernel's (it may block filter taps the kernel runs in
    # full), so clamp against the exact halo-window model.
    tiles = fit_conv_kernel_tiles(shape, (
        max(1, min(op.N, t["N"])), t["cI"], t["cO"],
        max(1, min(op.h_O, t["hO"])), max(1, min(op.w_O, t["wO"]))), mem)
    grid = (ceil_div(op.N, tiles[0]), ceil_div(op.c_O, tiles[2]),
            ceil_div(op.h_O, tiles[3]), ceil_div(op.w_O, tiles[4]),
            ceil_div(op.c_I, tiles[1]))
    vol = blk.comm_volume()
    lb = single_processor_bound(shape, mem.M_eff).value
    return ExecutionPlan(
        op=op, target=target, blocking=tuple(sorted(blk.b.items())),
        tiles=tiles, grid=grid, comm_volume=vol, lower_bound=lb,
        efficiency=vol / max(lb, 1.0),
        dtypes=_plan_dtypes(op.prec or target.precision))


def _fit_matmul_tiles(tiles: Tuple[int, int, int], prec, mem,
                      target: HardwareTarget) -> Tuple[int, int, int]:
    """Shrink snapped (bm, bn, bk) until the GEMM tile footprint
    ``bm*bk*p_I + bk*bn*p_F + bm*bn*p_O`` fits the double-buffered budget
    ``mem.M_eff`` (the constraint ``optimize_blocking`` solved under, which
    alignment snapping can violate). Alignment floors are respected."""
    bm, bn, bk = tiles
    aligns = (max(target.align_sublane, 1), max(target.align_lane, 1),
              max(target.align_lane, 1))

    def fp(t):
        return (t[0] * t[2] * prec.p_I + t[2] * t[1] * prec.p_F
                + t[0] * t[1] * prec.p_O)

    def shrink(v, al):
        nv = (v // 2 // al) * al if v // 2 >= al else min(v, al)
        return max(nv, 1)

    b = [bm, bn, bk]
    while fp(b) > mem.M_eff:
        best_i, best_gain = None, 0.0
        for i, al in enumerate(aligns):
            nv = shrink(b[i], al)
            if nv >= b[i]:
                continue
            trial = list(b)
            trial[i] = nv
            gain = fp(b) - fp(trial)
            if gain > best_gain:
                best_i, best_gain = i, gain
        if best_i is None:
            break  # nothing left to shrink; keep the least-bad tiles
        b[best_i] = shrink(b[best_i], aligns[best_i])
    return b[0], b[1], b[2]


def _plan_matmul(op: MatmulSpec, target: HardwareTarget) -> ExecutionPlan:
    prec = op.prec or target.precision
    mem = target.memory_model()
    blk = matmul_blocking(op.m, op.n, op.k, mem=mem, prec=prec,
                          align_m=target.align_sublane,
                          align_n=target.align_lane,
                          align_k=target.align_lane)
    bm, bk, bn = blk.b["N"], blk.b["cI"], blk.b["cO"]
    bm = snap_tile(bm, target.align_sublane, op.m)
    bn = snap_tile(bn, target.align_lane, op.n)
    bk = snap_tile(bk, target.align_lane, op.k)
    # clamp so the tiles divide the padded problem evenly
    bm = min(bm, round_up(op.m, max(target.align_sublane, 1)))
    bn = min(bn, round_up(op.n, max(target.align_lane, 1)))
    bk = min(bk, round_up(op.k, max(target.align_lane, 1)))
    # alignment can inflate a tile past the LP's feasible point; re-fit
    bm, bn, bk = _fit_matmul_tiles((bm, bn, bk), prec, mem, target)
    tiles = (bm, bn, bk)
    grid = (ceil_div(op.m, bm), ceil_div(op.n, bn), ceil_div(op.k, bk))
    shape = op.to_shape(target.precision)
    vol = blk.comm_volume()
    lb = single_processor_bound(shape, mem.M_eff).value
    return ExecutionPlan(
        op=op, target=target, blocking=tuple(sorted(blk.b.items())),
        tiles=tiles, grid=grid, comm_volume=vol, lower_bound=lb,
        efficiency=vol / max(lb, 1.0), dtypes=_plan_dtypes(prec))


def _plan_attention(op: AttentionSpec, target: HardwareTarget) -> ExecutionPlan:
    """Closed-form attention plan: the flash schedule's (bq, bk) capacity
    argument (``core.tiling.attention_block_size``) instead of the conv LP,
    bounded by Thm 2.1 applied to attention's two GEMMs
    (``core.bounds.attention_bound``). GQA group folding is accounted here:
    each of the B*KV kernel batch rows carries g = H/KV stacked query groups,
    so k/v stream once per folded q tile. The reference's formula, line for
    line (its ``repro/plan/planner.py:547``)."""
    prec = op.prec or target.precision
    mem = target.memory_model()
    blk = attention_block_size(op.hd, mem.M_eff, p_kv=prec.p_F)
    g = max(1, op.H // max(op.KV, 1))
    lqf = g * op.Lq  # the folded query axis of one (batch, kv-head) row
    sub = max(target.align_sublane, 1)
    bq = min(blk, round_up(lqf, sub))
    bk = min(blk, round_up(op.Lk, sub))
    n_q, n_k = ceil_div(lqf, bq), ceil_div(op.Lk, bk)
    rows = op.B * op.KV
    vol = (prec.p_I * rows * n_q * bq * op.hd          # q tiles, loaded once
           + 2.0 * prec.p_F * rows * n_q * n_k * bk * op.hd  # k/v per q tile
           + prec.p_O * rows * n_q * bq * op.hd)       # output stores
    lb = attention_bound(op.B, op.H, op.KV, op.Lq, op.Lk, op.hd,
                         mem.M_eff, prec).value
    return ExecutionPlan(
        op=op, target=target, blocking=(), tiles=(bq, bk),
        grid=(rows, n_q, n_k), comm_volume=vol, lower_bound=lb,
        efficiency=vol / max(lb, 1.0), dtypes=_plan_dtypes(prec))


def resolve_kernel_plan(
    op: OpSpec,
    plan: Optional[ExecutionPlan] = None,
    target: Optional[HardwareTarget] = None,
    tiles: Optional[Tuple[int, ...]] = None,
    ctx: Optional[Any] = None,
) -> Tuple[int, ...]:
    """Shared kernel-side resolution of the tiles.

    ``op`` is the spec the kernel built from its actual tensors (precision
    included). Priority: explicit ``tiles``, then a caller-supplied ``plan``
    (validated for geometry and precision), then a fresh plan via
    :func:`resolve_plan` for ``ctx.target`` or ``target`` (default ``H100``).
    Unlike the reference there is no interpret flag to resolve."""
    if ctx is not None and target is None:
        target = ctx.target
    if tiles is not None:
        return tuple(tiles)
    if plan is None:
        plan, _ = resolve_plan(op, target or H100,
                               autotune=getattr(ctx, "autotune", None))
    if not isinstance(plan.op, type(op)) or (
            dataclasses.replace(plan.op, prec=None)
            != dataclasses.replace(op, prec=None)):
        raise ValueError(f"plan was made for {plan.op}, not {op}")
    data_p = (op.prec or plan.target.precision).p_I
    if plan.precision.p_I < data_p:
        raise ValueError(
            f"plan assumed {plan.precision.p_I}-word input streams but "
            f"the data is {data_p} words: its tiles would overflow the "
            "modeled fast-memory budget")
    return plan.tiles


def _memoize_plan(key: Tuple[OpSpec, HardwareTarget], built: ExecutionPlan
                  ) -> ExecutionPlan:
    with _CACHE_LOCK:
        while len(_CACHE) >= PLAN_CACHE_MAX:
            _CACHE.pop(next(iter(_CACHE)))  # FIFO eviction of the oldest plan
        return _CACHE.setdefault(key, built)


def analytic_plan(op: Union[OpSpec, ConvShape],
                  target: HardwareTarget = H100) -> ExecutionPlan:
    """Solve the blocking LP for one (op, target) pair. Memoized: repeated
    calls with an equal pair return the identical ExecutionPlan object."""
    op = as_op_spec(op)
    if target.mesh_axes:
        raise NotImplementedError(
            f"target {target.name!r} has mesh axes {target.mesh_axes}; "
            "repro_torch plans single-device targets only")
    key = (op, target)
    with _CACHE_LOCK:
        cached = _CACHE.get(key)
    if cached is not None:
        return cached
    if isinstance(op, ConvSpec):
        built = _plan_conv(op, target)
    elif isinstance(op, MatmulSpec):
        built = _plan_matmul(op, target)
    elif isinstance(op, AttentionSpec):
        built = _plan_attention(op, target)
    else:
        raise TypeError(f"cannot plan {type(op).__name__}")
    return _memoize_plan(key, built)


def resolve_plan(
    op: Union[OpSpec, ConvShape],
    target: HardwareTarget = H100,
    explicit: Optional[ExecutionPlan] = None,
    autotune: Optional[Any] = None,
) -> Tuple[ExecutionPlan, str]:
    """The shared plan-resolution path behind ``ctx.plan()``,
    ``ops.explain``, ``resolve_kernel_plan`` and :class:`Planner`. Returns
    ``(plan, source)`` with source ``"explicit"`` (caller-supplied, returned
    untouched) or ``"analytic"``. A truthy ``autotune`` raises
    ``NotImplementedError``: the measured autotuner is not ported."""
    if explicit is not None:
        return explicit, "explicit"
    if autotune:
        raise NotImplementedError(
            "autotune is not available in repro_torch yet; pass "
            "autotune=None for the analytic LP plan")
    return analytic_plan(op, target), "analytic"


class Planner:
    """The one public planning front door.

    ``Planner(target=H100, quant=None, autotune=None)``: a non-None ``quant``
    spec is attached via ``target.with_quant``; a truthy ``autotune`` raises
    ``NotImplementedError`` (see :func:`resolve_plan`). ``.plan(op)``
    resolves the analytic plan; ``.resolve(op, explicit=...)`` also reports
    the plan source. ``Planner.cache`` is the process-wide
    :class:`PlanCache`, shared by every instance."""

    cache: PlanCache = PlanCache()

    def __init__(self, target: HardwareTarget = H100, quant: Any = None,
                 autotune: Any = None):
        if autotune:
            raise NotImplementedError(
                "autotune is not available in repro_torch yet")
        if quant is not None:
            target = target.with_quant(quant)
        self.target = target

    def plan(self, op: Union[OpSpec, ConvShape]) -> ExecutionPlan:
        return self.resolve(op)[0]

    def resolve(self, op: Union[OpSpec, ConvShape],
                explicit: Optional[ExecutionPlan] = None
                ) -> Tuple[ExecutionPlan, str]:
        return resolve_plan(op, self.target, explicit=explicit)
