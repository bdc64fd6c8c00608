"""Structured kernel-launch metadata: what each CUDA launch moves and when.
The port of ``repro.verify.access``.

Every kernel of the ``cuda`` backend exposes a ``<kernel>_access_plan``
builder returning a :class:`KernelAccessPlan`: the walk grid (the CUDA
grid's CTAs, in the order the hardware numbers them, with the kernel's
ring stages as the innermost axis), the per-operand global-memory access
pattern (windows for what a CTA stage copies, blocks for what a CTA loads
or stores once, flat counts for one-shot traffic), the CTA's shared-memory
allocations, the ``cp.async`` ring schedules, and the launch itself
(:class:`CudaLaunch`: grid, block, dynamic shared memory, cluster). The
plan is pure data built from the same launch configurations the wrappers
use, so ``repro_torch.verify.audit`` can abstractly interpret it without a
device.

Word unit everywhere: 32-bit words (``itemsize / 4`` per element), matching
the ``*_hbm_words`` counters and the Thm 2.1 bounds.

Differences from the reference: a :class:`WindowAccess` may give a size per
step (an array, 0 where the step copies nothing: a ragged last chunk, a CTA
with fewer stages than the walk's longest); a plan may list ``skipped``
accesses (what the counter charges and the kernel does not issue: paged
decode's dead slots, a GEMM span that holds no real k), ``dma`` may hold
one schedule per shared-memory buffer, and ``launch`` records the CUDA
launch the wrapper makes.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Tuple, Union


@dataclasses.dataclass(frozen=True)
class BlockAccess:
    """An operand loaded or stored by block index.

    ``index_map`` is vectorizable over numpy arrays: called with one array
    per grid axis (all the same flat length) it returns one block-index
    array/scalar per array dimension. A block moves only when the mapped
    index *changes* between consecutive steps, so audited words =
    index-transition count x block words. In the port's walk grids a block
    indexed by every CTA axis moves once a CTA: that is how an output tile
    or a query tile is declared; anything a CTA re-reads is a window."""

    name: str
    kind: str  # "load" | "store"
    block_shape: Tuple[int, ...]  # elements moved per (re)visit
    array_shape: Tuple[int, ...]  # padded element extent in HBM
    index_map: Callable  # (*grid_axes) -> per-dim block indices
    word_size: float  # 32-bit words per element
    counted: bool = True  # charged by the op's words_fn
    note: str = ""


@dataclasses.dataclass(frozen=True)
class WindowAccess:
    """What one CTA stage copies from global memory.

    ``window`` maps grid indices to one ``(start, size)`` pair per array
    dimension (vectorizable; ``size`` is an int, or in the port an array of
    one size per step). The copy issues every step, with no revisit
    elision, so words = sum over steps of the window's elements x word
    size. ``requires`` independently derives the element range the op needs
    at that step; the auditor checks requires within window, which is what
    catches an off-by-one halo index map even when the word *totals* stay
    unchanged."""

    name: str
    kind: str  # "load" | "store"
    window: Callable  # (*grid_axes) -> ((start, size), ...) per dim
    array_shape: Tuple[int, ...]
    word_size: float
    requires: Optional[Callable] = None  # (*grid_axes) -> ((lo, hi), ...)
    counted: bool = True
    note: str = ""


@dataclasses.dataclass(frozen=True)
class FlatAccess:
    """Traffic with no per-step structure: one-shot materializations (the
    im2col patch expansion), int32 tables, and totals a builder has already
    summed. ``counted`` mirrors whether the op's ``words_fn`` charges it."""

    name: str
    kind: str  # "load" | "store"
    words: float
    counted: bool = True
    note: str = ""


Access = Union[BlockAccess, WindowAccess, FlatAccess]


@dataclasses.dataclass(frozen=True)
class ScratchAlloc:
    """One buffer in a CTA's shared memory (words, 32-bit)."""

    name: str
    words: float


@dataclasses.dataclass(frozen=True)
class CudaLaunch:
    """The launch a wrapper makes: ``grid`` and ``block`` as dim3 triples,
    the dynamic shared memory in bytes, and the cluster dims ((1, 1, 1)
    for a kernel launched without clusters)."""

    kernel: str
    grid: Tuple[int, int, int]
    block: Tuple[int, int, int]
    smem_bytes: int
    cluster: Tuple[int, int, int] = (1, 1, 1)

    @property
    def ctas(self) -> int:
        return self.grid[0] * self.grid[1] * self.grid[2]


@dataclasses.dataclass(frozen=True)
class KernelAccessPlan:
    """Everything one kernel launch does to memory, as pure data."""

    op: str
    grid: Tuple[int, ...]
    accesses: Tuple[Access, ...]
    scratch: Tuple[ScratchAlloc, ...] = ()
    # cp.async ring schedules (hazards.DmaSchedule, or a tuple of them, one
    # per shared-memory buffer), None when the launch has no ring; built to
    # mirror the kernel's issue, wait and barrier order for one CTA
    dma: Optional[object] = None
    note: str = ""
    launch: Optional[CudaLaunch] = None
    # charged by the op's words_fn, not issued by the kernel
    skipped: Tuple[Access, ...] = ()

    @property
    def n_steps(self) -> int:
        n = 1
        for g in self.grid:
            n *= int(g)
        return n

    def scratch_words(self) -> float:
        return float(sum(s.words for s in self.scratch))

    def schedules(self) -> tuple:
        """The ring schedules as a tuple (empty without one)."""
        if self.dma is None:
            return ()
        return tuple(self.dma) if isinstance(self.dma, (tuple, list)) \
            else (self.dma,)
