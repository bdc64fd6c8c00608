"""Parallel (distributed-memory) blocking via linear programming (paper §4.2).

Each of the 7 loop axes gets a per-processor block a_j; the processor grid has
P_j = ceil(d_j / a_j) processors along axis j with prod_j P_j ~ P. Each
processor owns one block of each array:

    I_blk = p_I a_N a_cI (sw*a_wO + a_wF)(sh*a_hO + a_hF)
    F_blk = p_F a_cI a_cO a_wF a_hF
    O_blk = p_O a_N a_cO a_wO a_hO

and its communication is (up to the data it already owns, A_P/P) the sum of
the blocks it must gather plus the partial outputs it must reduce. The paper
solves a log-space LP maximizing per-processor work subject to per-array
constraints; we formulate the equivalent min-max geometric program: minimize
the largest block (communication-balancing), subject to the work-balance
equality sum_j log a_j = log(G/P). As P grows this meets the Thm 2.3
memory-independent bound (big-filter regime: all three blocks equal at
(p_I p_F p_O)^{1/3} (G/P)^{1/2}).

The integer refinement snaps the processor grid to an exact factorization of
P, which is what a mesh needs (mesh axis sizes must multiply to P).

The port of ``repro.core.parallel_tiling``, with one difference: a request
for more processors than the work G has updates (P > G) is capped at G, so
the grid uses at most G processors. The reference keeps P there, and its
work-balance equality sum log a_j = log(G/P) < 0 makes the LP infeasible
(it raises ``RuntimeError``).
"""

from __future__ import annotations

import dataclasses
import itertools
import math
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
from scipy.optimize import linprog

from .conv_model import ConvShape, ceil_div

PAR_AXES = ("N", "cI", "cO", "wO", "hO", "wF", "hF")


@dataclasses.dataclass(frozen=True)
class ParallelBlocking:
    """Per-axis processor counts (the processor grid)."""

    grid: Dict[str, int]  # axis -> number of processors splitting that axis
    shape: ConvShape

    @classmethod
    def from_grid(cls, shape: ConvShape, grid: Dict[str, int]
                  ) -> "ParallelBlocking":
        """Build from a partial axis->procs mapping (unlisted axes get 1) —
        the form tests and ``repro_torch.distributed`` pass grids around in."""
        full = {k: 1 for k in PAR_AXES}
        for k, v in grid.items():
            if k not in PAR_AXES:
                raise ValueError(f"unknown loop axis {k!r} "
                                 f"(expected one of {PAR_AXES})")
            full[k] = int(v)
        return cls(full, shape)

    @property
    def P(self) -> int:
        return math.prod(self.grid.values())

    def block(self, axis: str) -> int:
        dims = dict(zip(PAR_AXES, self.shape.loop_bounds()))
        return ceil_div(dims[axis], self.grid[axis])

    # -- per-processor array blocks (words) -----------------------------------
    @property
    def in_block_words(self) -> float:
        s = self.shape
        a = {k: self.block(k) for k in PAR_AXES}
        return s.prec.p_I * a["N"] * a["cI"] * (s.sw * a["wO"] + a["wF"]) * (
            s.sh * a["hO"] + a["hF"])

    @property
    def filt_block_words(self) -> float:
        a = {k: self.block(k) for k in PAR_AXES}
        return self.shape.prec.p_F * a["cI"] * a["cO"] * a["wF"] * a["hF"]

    @property
    def out_block_words(self) -> float:
        a = {k: self.block(k) for k in PAR_AXES}
        return self.shape.prec.p_O * a["N"] * a["cO"] * a["wO"] * a["hO"]

    def comm_per_processor(self) -> float:
        """Words in/out of one processor: gather the input+filter blocks it
        does not own, plus reduce partial outputs when the reduction axes
        (cI, wF, hF) are split (each split copy must be combined)."""
        s = self.shape
        own = max(s.prec.p_I * s.input_size, s.prec.p_F * s.filter_size,
                  s.prec.p_O * s.output_size) / self.P
        red = self.grid["cI"] * self.grid["wF"] * self.grid["hF"]
        out_traffic = self.out_block_words * (2.0 if red > 1 else 1.0)
        vol = self.in_block_words + self.filt_block_words + out_traffic - own
        return max(vol, 0.0)

    def work_per_processor(self) -> int:
        return math.prod(self.block(k) for k in PAR_AXES)

    def imbalance(self) -> float:
        """max work / mean work over the grid (1.0 = perfectly balanced)."""
        ideal = self.shape.G / self.P
        return self.work_per_processor() / ideal


def _lp_parallel(shape: ConvShape, P: int) -> Dict[str, float]:
    """Continuous log-space min-max LP. Variables: x_j = log a_j (per-processor
    block), t = log(max block words). Returns continuous block sizes a_j."""
    s = shape
    p = s.prec
    dims = dict(zip(PAR_AXES, s.loop_bounds()))
    n = len(PAR_AXES)
    idx = {k: i for i, k in enumerate(PAR_AXES)}
    NV = n + 1  # + t
    t_i = n

    A_ub: List[List[float]] = []
    b_ub: List[float] = []

    def term(keys: Sequence[str], const: float):
        """log(const) + sum_k x_k <= t"""
        r = [0.0] * NV
        for k in keys:
            r[idx[k]] += 1.0
        r[t_i] = -1.0
        A_ub.append(r)
        b_ub.append(-math.log(max(const, 1e-300)))

    term(["N", "cO", "wO", "hO"], p.p_O)
    term(["cI", "cO", "wF", "hF"], p.p_F)
    # input window expanded into 4 monomials (paper's relaxation)
    term(["N", "cI", "wO", "hO"], p.p_I * s.sw * s.sh)
    term(["N", "cI", "wO", "hF"], p.p_I * s.sw)
    term(["N", "cI", "wF", "hO"], p.p_I * s.sh)
    term(["N", "cI", "wF", "hF"], p.p_I)

    # work balance: sum_j x_j = log(G / P)
    A_eq = [[1.0] * n + [0.0]]
    b_eq = [math.log(s.G / P)]

    bounds = [(0.0, math.log(max(dims[k], 1))) for k in PAR_AXES] + [(None, None)]
    c = [0.0] * n + [1.0]  # minimize t
    res = linprog(c, A_ub=np.asarray(A_ub), b_ub=np.asarray(b_ub),
                  A_eq=np.asarray(A_eq), b_eq=np.asarray(b_eq), bounds=bounds,
                  method="highs")
    if not res.success:
        raise RuntimeError(f"parallel blocking LP failed: {res.message}")
    return {k: math.exp(res.x[idx[k]]) for k in PAR_AXES}


def _factorizations(P: int, naxes: int, max_out: int = 20000) -> List[Tuple[int, ...]]:
    """All ordered factorizations of P into naxes factors."""

    def divisors(x: int) -> List[int]:
        out = []
        for d in range(1, int(math.isqrt(x)) + 1):
            if x % d == 0:
                out.append(d)
                if d != x // d:
                    out.append(x // d)
        return sorted(out)

    results: List[Tuple[int, ...]] = []

    def rec(rem: int, k: int, acc: Tuple[int, ...]):
        if len(results) >= max_out:
            return
        if k == 1:
            results.append(acc + (rem,))
            return
        for d in divisors(rem):
            rec(rem // d, k - 1, acc + (d,))

    rec(P, naxes, ())
    return results


def optimize_parallel_blocking(
    shape: ConvShape,
    P: int,
    restrict_axes: Optional[Sequence[str]] = None,
) -> ParallelBlocking:
    """LP + exact-factorization search: processor grid minimizing the modeled
    per-processor communication. ``restrict_axes`` limits which loop axes may
    be split (e.g. ("N", "cO") for a (data, model) mesh). P is capped at the
    work G: a grid never holds more processors than updates."""
    P = min(P, shape.G)
    axes = list(restrict_axes) if restrict_axes else list(PAR_AXES)
    dims = dict(zip(PAR_AXES, shape.loop_bounds()))
    cont = _lp_parallel(shape, P)
    # target processor count per axis from the continuous solution
    target = {k: dims[k] / cont[k] for k in PAR_AXES}

    best: Optional[ParallelBlocking] = None
    best_cost = float("inf")
    for fac in _factorizations(P, len(axes)):
        grid = {k: 1 for k in PAR_AXES}
        ok = True
        for k, f in zip(axes, fac):
            if f > dims[k]:
                ok = False
                break
            grid[k] = f
        if not ok:
            continue
        pb = ParallelBlocking(grid, shape)
        # penalize imbalance from ragged splits, weight toward LP target
        cost = pb.comm_per_processor() * pb.imbalance()
        if cost < best_cost:
            best, best_cost = pb, cost
    if best is None:
        # fall back: put everything on the largest axis
        k = max(axes, key=lambda a: dims[a])
        grid = {a: 1 for a in PAR_AXES}
        grid[k] = min(P, dims[k])
        best = ParallelBlocking(grid, shape)
    _ = target  # (kept for debug/inspection)
    return best


def parallel_efficiency(shape: ConvShape, P: int, M: float) -> Tuple[float, float, float]:
    """(modeled per-processor comm, lower bound, ratio)."""
    from .bounds import combined_parallel_bound

    pb = optimize_parallel_blocking(shape, P)
    vol = pb.comm_per_processor()
    lb = combined_parallel_bound(shape, P, M)
    return vol, lb, vol / max(lb, 1.0)
