"""Launch geometry of the distributed halo-exchange conv (paper §4.2).

One value object — :class:`DistConvGeometry` — is the single source of truth
shared by the executable shard bodies (``repro_torch.distributed.halo``, run
over a :class:`~repro_torch.distributed.collectives.ConvMesh`) and the
inter-device word counters (``conv2d_dist_comm_words`` /
``allgather_comm_words``), exactly as ``kernels.conv2d._launch_geometry``
ties the single-device kernel launch to its HBM-word counter. The port of
``repro.distributed.geometry``, line for line.

The scheme (Demmel & Dinh 2018, Li et al. 2021): snap the integer processor
grid of a :class:`~repro_torch.core.parallel_tiling.ParallelBlocking` onto a device
mesh with axes ``("N", "cI", "hO", "wO")`` and give each device one block of
every array:

  * the input is partitioned into *disjoint* slabs of ``bh*sh`` rows x
    ``bw*sw`` cols — exactly the rows/cols "consumed" by the device's
    ``bh x bw`` output block;
  * each output block additionally needs the ``(bh-1)*sh + h_F`` row window,
    i.e. an ``h_F - sh`` row halo owned by the *next* device along ``hO``
    (and ``w_F - sw`` cols along ``wO``) — fetched with one ``ppermute``
    per spatial axis;
  * splitting ``cI`` leaves every device with a partial output block,
    combined by a ``psum`` over the ``cI`` mesh axis.

Padding discipline: ``h_O`` is padded up so that (a) every device gets an
equal block and (b) the *owned* input slabs cover the entire tight VALID
extent ``(h_O-1)*sh + h_F`` — the ring-wraparound halo a trailing device
receives then only ever feeds padded output rows, which are sliced away.
Without (b), the last device's real outputs would consume wrapped (wrong)
rows whenever ``h_F > sh`` and ``h_O`` divides evenly.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Mapping, Tuple

from repro_torch.core.bounds import combined_parallel_bound
from repro_torch.core.conv_model import ConvShape, ceil_div
from repro_torch.core.parallel_tiling import PAR_AXES, ParallelBlocking

# Mesh axis order (canonical): the loop axes a distributed conv may split.
# cO / wF / hF splits are not lowered (cO sharding would need no comm but
# also exercises nothing; filter-tap sharding forces halo-heavy replication).
DIST_AXES = ("N", "cI", "hO", "wO")


def dist_grid(blocking_or_grid) -> Tuple[int, int, int, int]:
    """Normalize a ParallelBlocking / axis->procs mapping to (gN, gcI, ghO,
    gwO), rejecting splits on axes the distributed lowering cannot serve."""
    grid: Mapping[str, int]
    if isinstance(blocking_or_grid, ParallelBlocking):
        grid = blocking_or_grid.grid
    else:
        grid = dict(blocking_or_grid)
    for ax in grid:
        if ax not in PAR_AXES:
            raise ValueError(f"unknown loop axis {ax!r} (expected {PAR_AXES})")
        if ax not in DIST_AXES and grid[ax] > 1:
            raise ValueError(
                f"distributed conv cannot split axis {ax!r} (grid={dict(grid)}); "
                f"splittable axes: {DIST_AXES}")
    return tuple(int(grid.get(ax, 1)) for ax in DIST_AXES)


@dataclasses.dataclass(frozen=True)
class DistConvGeometry:
    """Everything the distributed conv lowers for one (shape, grid) pair."""

    N: int
    c_I: int
    c_O: int
    h_O: int
    w_O: int
    h_F: int
    w_F: int
    sh: int
    sw: int
    grid: Tuple[int, int, int, int]  # (gN, gcI, ghO, gwO), mesh axis sizes

    @classmethod
    def build(cls, N: int, c_I: int, c_O: int, h_O: int, w_O: int, h_F: int,
              w_F: int, sh: int, sw: int, grid) -> "DistConvGeometry":
        return cls(N=N, c_I=c_I, c_O=c_O, h_O=h_O, w_O=w_O, h_F=h_F, w_F=w_F,
                   sh=sh, sw=sw, grid=dist_grid(grid))

    @classmethod
    def from_shape(cls, shape: ConvShape, grid) -> "DistConvGeometry":
        return cls.build(shape.N, shape.c_I, shape.c_O, shape.h_O, shape.w_O,
                         shape.h_F, shape.w_F, shape.sh, shape.sw, grid)

    # -- processor counts -----------------------------------------------------
    @property
    def P(self) -> int:
        return math.prod(self.grid)

    # -- per-device blocks ----------------------------------------------------
    @property
    def bN(self) -> int:
        return ceil_div(self.N, self.grid[0])

    @property
    def b_cI(self) -> int:
        return ceil_div(self.c_I, self.grid[1])

    @property
    def bh(self) -> int:
        """Output rows per device. Padded beyond ceil(h_O/ghO) when needed so
        the owned input slabs (bh*sh rows each) cover the tight VALID input
        extent — see the module docstring's padding discipline."""
        ghO = self.grid[2]
        tight = (self.h_O - 1) * self.sh + self.h_F
        return max(ceil_div(self.h_O, ghO), ceil_div(tight, ghO * self.sh))

    @property
    def bw(self) -> int:
        gwO = self.grid[3]
        tight = (self.w_O - 1) * self.sw + self.w_F
        return max(ceil_div(self.w_O, gwO), ceil_div(tight, gwO * self.sw))

    # -- padded global dims (what the sharded arrays hold) --------------------
    @property
    def Np(self) -> int:
        return self.grid[0] * self.bN

    @property
    def cIp(self) -> int:
        return self.grid[1] * self.b_cI

    @property
    def hOp(self) -> int:
        return self.grid[2] * self.bh

    @property
    def wOp(self) -> int:
        return self.grid[3] * self.bw

    @property
    def Hp(self) -> int:
        """Sharded input rows: disjoint owned slabs of bh*sh rows."""
        return self.hOp * self.sh

    @property
    def Wp(self) -> int:
        return self.wOp * self.sw

    # -- halo extents ---------------------------------------------------------
    @property
    def halo_h(self) -> int:
        """Rows each device receives from its next ``hO`` neighbor (the
        overlap of consecutive halo windows)."""
        return max(self.h_F - self.sh, 0)

    @property
    def halo_w(self) -> int:
        return max(self.w_F - self.sw, 0)

    @property
    def h_ext(self) -> int:
        """Input rows of one device's haloed conv window."""
        return (self.bh - 1) * self.sh + self.h_F

    @property
    def w_ext(self) -> int:
        return (self.bw - 1) * self.sw + self.w_F

    def validate(self) -> "DistConvGeometry":
        gN, gcI, ghO, gwO = self.grid
        if self.halo_h > self.bh * self.sh and ghO > 1:
            raise ValueError(
                f"halo of {self.halo_h} rows exceeds the {self.bh * self.sh}"
                f"-row owned slab: grid hO={ghO} is too fine for filter "
                f"h_F={self.h_F} (halo must come from one neighbor)")
        if self.halo_w > self.bw * self.sw and gwO > 1:
            raise ValueError(
                f"halo of {self.halo_w} cols exceeds the {self.bw * self.sw}"
                f"-col owned slab: grid wO={gwO} is too fine for filter "
                f"w_F={self.w_F} (halo must come from one neighbor)")
        return self

    # -- inter-device word counters (32-bit words, per device) ----------------
    def halo_words(self, p_in: float = 1.0) -> float:
        """Words one device *receives* over the wire for its halos: the row
        halo over the owned column extent, then the column halo over the
        row-extended height (corners ride the second exchange)."""
        gN, gcI, ghO, gwO = self.grid
        words = 0.0
        if ghO > 1 and self.halo_h > 0:
            words += self.bN * self.b_cI * self.halo_h * (self.bw * self.sw)
        h_after = self.bh * self.sh + (self.halo_h if ghO > 1 else 0)
        if gwO > 1 and self.halo_w > 0:
            words += self.bN * self.b_cI * h_after * self.halo_w
        return p_in * words

    def psum_words(self, p_out: float = 1.0) -> float:
        """Ring all-reduce words per device combining the cI-partial output
        blocks: 2 (g-1)/g x the block size (reduce-scatter + all-gather)."""
        gcI = self.grid[1]
        if gcI <= 1:
            return 0.0
        block = self.bN * self.c_O * self.bh * self.bw
        return p_out * 2.0 * (gcI - 1) / gcI * block

    def comm_words(self, p_in: float = 1.0, p_out: float = 1.0) -> float:
        """Total measured inter-device words per device: halo + psum."""
        return self.halo_words(p_in) + self.psum_words(p_out)

    def allgather_words(self, p_in: float = 1.0, p_flt: float = 1.0) -> float:
        """Per-device words of the naive baseline: all-gather the full padded
        input over every mesh axis ((P-1)/P x |I_pad| received per device)
        plus the filter over the cI axis."""
        if self.P <= 1:
            return 0.0
        in_pad = self.Np * self.cIp * self.Hp * self.Wp
        words = p_in * in_pad * (self.P - 1) / self.P
        gcI = self.grid[1]
        if gcI > 1:
            flt_pad = self.c_O * self.cIp * self.h_F * self.w_F
            words += p_flt * flt_pad * (gcI - 1) / gcI
        return words

    # -- model hooks ----------------------------------------------------------
    def blocking(self, shape: ConvShape) -> ParallelBlocking:
        """The ParallelBlocking this geometry lowers (for model comparisons)."""
        grid = {ax: 1 for ax in PAR_AXES}
        grid.update(dict(zip(DIST_AXES, self.grid)))
        return ParallelBlocking(grid, shape)

    def lower_bound(self, shape: ConvShape, M: float) -> float:
        """Combined Thm 2.2/2.3 per-processor bound at local memory M."""
        return combined_parallel_bound(shape, self.P, M)

    def grid_dict(self) -> Dict[str, int]:
        return dict(zip(DIST_AXES, self.grid))
