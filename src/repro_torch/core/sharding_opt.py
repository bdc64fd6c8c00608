"""Parallel-LP-driven sharding selection (paper §4.2 -> device meshes).

The paper's parallel blocking assigns loop axes to processors; on a device
mesh the processor grid is factored into named axes (pod, data, model). This
module enumerates the ways to bind 7NL loop axes to mesh axes, scores each
candidate with the ParallelBlocking communication model, and emits
PartitionSpec-style entries (one mesh axis name or None per array dimension)
for the three arrays. The port of ``repro.core.sharding_opt``, pure Python,
equal to it for equal inputs.
"""

from __future__ import annotations

import dataclasses
import itertools
import math
from typing import Dict, List, Optional, Sequence, Tuple

from .conv_model import ConvShape
from .parallel_tiling import PAR_AXES, ParallelBlocking

# Array layouts (NCHW / OIHW-as-(cI,cO,wF,hF) / NCHW) -> which loop axis each
# array dimension corresponds to.
INPUT_DIMS = ("N", "cI", "wI", "hI")  # wI/hI shard with wO/hO (halo exchange)
FILTER_DIMS = ("cI", "cO", "wF", "hF")
OUTPUT_DIMS = ("N", "cO", "wO", "hO")


@dataclasses.dataclass(frozen=True)
class ShardingPlan:
    """Loop-axis -> mesh-axis binding plus the derived partition specs."""

    binding: Dict[str, str]  # loop axis -> mesh axis name
    mesh_axes: Tuple[Tuple[str, int], ...]  # (name, size) in order
    comm_per_processor: float
    grid: Dict[str, int]

    def spec(self, dims: Sequence[str]) -> Tuple[Optional[str], ...]:
        """Partition-spec entries for an array with the given loop-axis dims."""
        out: List[Optional[str]] = []
        used = set()
        for d in dims:
            loop_axis = {"wI": "wO", "hI": "hO"}.get(d, d)
            ax = self.binding.get(loop_axis)
            if ax is not None and ax not in used:
                out.append(ax)
                used.add(ax)
            else:
                out.append(None)
        return tuple(out)

    @property
    def input_spec(self) -> Tuple[Optional[str], ...]:
        return self.spec(INPUT_DIMS)

    @property
    def filter_spec(self) -> Tuple[Optional[str], ...]:
        return self.spec(FILTER_DIMS)

    @property
    def output_spec(self) -> Tuple[Optional[str], ...]:
        return self.spec(OUTPUT_DIMS)


def _axis_dims(shape: ConvShape) -> Dict[str, int]:
    return dict(zip(PAR_AXES, shape.loop_bounds()))


def plan_conv_sharding(
    shape: ConvShape,
    mesh_axes: Sequence[Tuple[str, int]],
    shardable: Sequence[str] = ("N", "cI", "cO", "wO", "hO"),
) -> ShardingPlan:
    """Choose the loop-axis binding for each mesh axis minimizing the modeled
    per-processor communication (the parallel LP's integer analogue under the
    mesh-factorization constraint).

    Filter spatial axes (wF, hF) are never sharded: their extents are tiny and
    sharding them forces halo-heavy input replication.
    """
    dims = _axis_dims(shape)
    best: Optional[ShardingPlan] = None
    # each mesh axis independently picks one loop axis (or none -> replicate)
    options: List[List[Optional[str]]] = []
    for name, size in mesh_axes:
        opts: List[Optional[str]] = [None]
        for la in shardable:
            if dims[la] >= size and dims[la] % size == 0:
                opts.append(la)
        options.append(opts)
    for combo in itertools.product(*options):
        # a loop axis may be claimed by at most one mesh axis
        claimed = [c for c in combo if c is not None]
        if len(claimed) != len(set(claimed)):
            continue
        grid = {k: 1 for k in PAR_AXES}
        binding: Dict[str, str] = {}
        for (name, size), la in zip(mesh_axes, combo):
            if la is None:
                continue
            grid[la] *= size
            binding[la] = name
        pb = ParallelBlocking(grid, shape)
        # unbound mesh axes replicate -> pure overhead for weight traffic;
        # penalize so the planner prefers binding every axis when legal
        unbound = sum(1 for (n, s), la in zip(mesh_axes, combo) if la is None)
        cost = pb.comm_per_processor() * (1.0 + 0.5 * unbound)
        if best is None or cost < best.comm_per_processor:
            best = ShardingPlan(
                binding=binding,
                mesh_axes=tuple(mesh_axes),
                comm_per_processor=cost,
                grid=grid,
            )
    assert best is not None
    return best


def plan_gemm_sharding(
    m: int, n: int, k: int,
    mesh_axes: Sequence[Tuple[str, int]],
    prec=None,
) -> ShardingPlan:
    """GEMM C[m,n] = A[m,k] B[k,n] as the degenerate conv: N=m, c_I=k, c_O=n.
    Returns a plan whose input/filter/output specs map to A/B/C (first two
    dims of each)."""
    from .conv_model import matmul_as_conv, Precision

    shape = matmul_as_conv(m, n, k, prec or Precision())
    return plan_conv_sharding(shape, mesh_axes, shardable=("N", "cI", "cO"))


def rank_lm_shardings(
    batch: int, d_model: int, d_ff: int, n_heads: int,
    mesh_axes: Sequence[Tuple[str, int]],
) -> List[Tuple[str, float]]:
    """Rank standard LM layer sharding strategies by the summed GEMM comm
    model over a transformer block's GEMMs (QKV, out-proj, up, down).

    Strategies:
      dp_only    - batch on all axes
      megatron   - batch on data, heads/ffn on model (column->row pairing)
      weight_rep - batch on data, weights replicated
    """
    strategies = {}
    P = math.prod(s for _, s in mesh_axes)
    data = math.prod(s for n_, s in mesh_axes if n_ != "model")
    model = P // data

    def gemm_cost(m: int, n: int, k: int, grid: Dict[str, int]) -> float:
        from .conv_model import matmul_as_conv

        shape = matmul_as_conv(m, n, k)
        g = {ax: 1 for ax in PAR_AXES}
        g.update(grid)
        return ParallelBlocking(g, shape).comm_per_processor()

    gemms = [
        (batch, 3 * d_model, d_model),  # QKV
        (batch, d_model, d_model),  # out proj
        (batch, d_ff, d_model),  # up
        (batch, d_model, d_ff),  # down
    ]
    strategies["dp_only"] = sum(
        gemm_cost(m, n, k, {"N": min(P, batch)}) for m, n, k in gemms)
    strategies["megatron"] = sum(
        gemm_cost(m, n, k, {"N": min(data, batch), "cO": min(model, n)})
        for m, n, k in gemms)
    strategies["weight_rep"] = sum(
        gemm_cost(m, n, k, {"N": min(data, batch)}) for m, n, k in gemms)
    return sorted(strategies.items(), key=lambda kv: kv[1])
