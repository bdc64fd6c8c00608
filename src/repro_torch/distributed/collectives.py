"""Conv meshes: the port's counterpart of ``shard_map`` with ``ppermute``,
``psum`` and ``all_gather`` (the collectives ``repro.distributed.halo``
lowers to).

A :class:`ConvMesh` has the axes ``DIST_AXES`` = ("N", "cI", "hO", "wO")
and one size each (``dist_grid`` of a blocking). Its P devices are numbered
in row-major order over the axes, as ``jax.make_mesh`` lays out its device
list: device d sits at the coordinates ``mesh.coords(d)``. A shard body
(``repro_torch.distributed.halo``) is written once over this interface: it
holds one block per device of ``mesh.devices`` (the devices this process
holds) and calls the three collectives with those blocks, in that order:

  * :meth:`ConvMesh.shift_from_next` - each device receives the block of
    its successor along an axis, the last the first's (a ring);
  * :meth:`ConvMesh.psum` - the sum of the blocks along an axis, on every
    device of that axis;
  * :meth:`ConvMesh.all_gather` - the blocks along an axis concatenated in
    axis order, on every device of that axis.

Two implementations:

  * :class:`LocalConvMesh` - all P devices held in one process, their
    blocks on the device of the tensors given to it: a shift re-indexes the
    block list (the receiver copies the block into its window), a psum
    adds the blocks of an axis in axis order (device 0's block first), an
    all-gather concatenates them once a line of the axis and hands every
    device of the line that one tensor. Slices, concatenations and sums
    are autograd ops, so gradients flow through it. It takes the place of the
    reference's fake host devices (``repro.launch.fake_devices``), and is
    what runs at full width on one card, the shards in turn.
  * :class:`GroupConvMesh` - one device a rank of a ``torch.distributed``
    process group: the shift is ``batch_isend_irecv`` to the predecessor
    and from the successor, the psum ``all_reduce`` over the axis's
    subgroup, the all-gather ``all_gather`` over it. Under the ``gloo``
    backend every block is staged through host memory explicitly (a copy
    to the CPU before the collective, back to the block's device after):
    gloo's point-to-point calls take CPU tensors, and one route for all
    three keeps their sums on one path. No gradient flows across a rank.

Both count what their collectives put on the wire, in 32-bit words, per
device and by kind, under the reference counters' conventions
(``geometry.DistConvGeometry``): a shift, the block each device receives
(``"shift"``); a psum, the ring all-reduce's 2 (g - 1) / g x the operand
(``"psum"``); an all-gather, (g - 1) / g x the gathered tensor
(``"all_gather"``). A word is 4 bytes, so a bf16 element is half a word.
These counts are the port's counterpart of ``collective_bytes`` on the
reference's compiled HLO.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from .geometry import DIST_AXES

WIRE_KINDS = ("shift", "psum", "all_gather")


def _words(t: torch.Tensor) -> float:
    """32-bit words of a tensor: elements x bytes / 4."""
    return t.numel() * t.element_size() / 4.0


class ConvMesh:
    """The interface both meshes share: axes, device coordinates, the wire
    counters, and the block layout of arrays sharded over the mesh."""

    axis_names: Tuple[str, ...] = DIST_AXES

    def __init__(self, sizes: Sequence[int]):
        # the four axis sizes in DIST_AXES order (dist_grid of a blocking)
        if len(sizes) != len(DIST_AXES) or min(sizes) < 1:
            raise ValueError(f"a conv mesh takes {len(DIST_AXES)} axis "
                             f"sizes >= 1 in the order {DIST_AXES}, got "
                             f"{tuple(sizes)}")
        self.sizes: Tuple[int, ...] = tuple(int(v) for v in sizes)
        self.P = math.prod(self.sizes)
        self.devices: Tuple[int, ...] = tuple(range(self.P))
        self.wire: Dict[int, Dict[str, float]] = {}

    # -- layout ---------------------------------------------------------------
    @property
    def shape(self) -> Dict[str, int]:
        """axis -> size, as a jax mesh's ``shape``."""
        return dict(zip(DIST_AXES, self.sizes))

    def coords(self, d: int) -> Tuple[int, ...]:
        out = []
        for size in reversed(self.sizes):
            out.append(d % size)
            d //= size
        return tuple(reversed(out))

    def device_at(self, coords: Sequence[int]) -> int:
        d = 0
        for c, size in zip(coords, self.sizes):
            d = d * size + c
        return d

    def line(self, d: int, axis: str) -> List[int]:
        """The devices along ``axis`` through device d, in axis order."""
        a = DIST_AXES.index(axis)
        c = list(self.coords(d))
        out = []
        for i in range(self.sizes[a]):
            c[a] = i
            out.append(self.device_at(c))
        return out

    def neighbor(self, d: int, axis: str, step: int) -> int:
        a = DIST_AXES.index(axis)
        c = list(self.coords(d))
        c[a] = (c[a] + step) % self.sizes[a]
        return self.device_at(c)

    def axis_index(self, axis: str) -> List[int]:
        """Each held device's coordinate along ``axis``."""
        a = DIST_AXES.index(axis)
        return [self.coords(d)[a] for d in self.devices]

    def scatter(self, x: torch.Tensor, spec: Sequence[Optional[str]]
                ) -> List[torch.Tensor]:
        """The held devices' blocks of ``x``: dimension i split evenly over
        mesh axis ``spec[i]`` (None: whole). Views, no copy."""
        out = []
        for d in self.devices:
            c = self.coords(d)
            blk = x
            for dim, axis in enumerate(spec):
                if axis is None:
                    continue
                a = DIST_AXES.index(axis)
                n = x.shape[dim] // self.sizes[a]
                blk = blk.narrow(dim, c[a] * n, n)
            out.append(blk)
        return out

    def assemble(self, blocks: Dict[int, torch.Tensor],
                 spec: Sequence[Optional[str]]) -> torch.Tensor:
        """The global array from every device's block (device -> block):
        blocks along the axes of ``spec`` are concatenated in axis order;
        along the axes it leaves out the blocks are replicas, and those at
        coordinate 0 are taken."""
        return self._assemble(blocks, spec, 0, [0] * len(DIST_AXES))

    def _assemble(self, blocks, spec, dim: int, c: List[int]) -> torch.Tensor:
        # a method, not a nested recursive function: the latter's closure
        # is a reference cycle, which would hold every block until the
        # garbage collector runs
        if dim == len(spec):
            return blocks[self.device_at(c)]
        if spec[dim] is None:
            return self._assemble(blocks, spec, dim + 1, c)
        a = DIST_AXES.index(spec[dim])
        parts = []
        for i in range(self.sizes[a]):
            c2 = list(c)
            c2[a] = i
            parts.append(self._assemble(blocks, spec, dim + 1, c2))
        return parts[0] if len(parts) == 1 else torch.cat(parts, dim)

    # -- the wire counters ----------------------------------------------------
    def reset_wire(self) -> None:
        self.wire = {d: dict.fromkeys(WIRE_KINDS, 0.0) for d in self.devices}

    def wire_words(self, device: Optional[int] = None,
                   kind: Optional[str] = None) -> float:
        """Words device ``device`` (default: the first held) received, of
        one kind or (None) all."""
        counts = self.wire[self.devices[0] if device is None else device]
        return counts[kind] if kind is not None else sum(counts.values())

    def _count(self, d: int, kind: str, words: float) -> None:
        self.wire[d][kind] += words

    def _count_psum(self, d: int, t: torch.Tensor, g: int) -> None:
        # the reference's expression, in its order (geometry.psum_words)
        p = t.element_size() / 4.0
        self._count(d, "psum", p * 2.0 * (g - 1) / g * t.numel())

    def _count_gather(self, d: int, gathered_numel: int, p: float,
                      g: int) -> None:
        self._count(d, "all_gather", p * gathered_numel * (g - 1) / g)

    # -- the collectives (one block a held device) ---------------------------
    def shift_from_next(self, blocks: List[torch.Tensor], axis: str
                        ) -> List[torch.Tensor]:
        raise NotImplementedError

    def psum(self, blocks: List[torch.Tensor], axis: str
             ) -> List[torch.Tensor]:
        raise NotImplementedError

    def all_gather(self, blocks: List[torch.Tensor], axis: str, dim: int
                   ) -> List[torch.Tensor]:
        raise NotImplementedError


class LocalConvMesh(ConvMesh):
    """All P devices of the mesh held in this process, their blocks on one
    ``torch.device`` (module docstring)."""

    def __init__(self, sizes):
        super().__init__(sizes)
        self.reset_wire()

    def __repr__(self) -> str:
        return f"LocalConvMesh({self.shape})"

    def shift_from_next(self, blocks, axis):
        # the successor's block itself: the caller concatenates it into a
        # new window, so a copy here would be a second one
        out = []
        for d in self.devices:
            src = blocks[self.neighbor(d, axis, 1)]
            self._count(d, "shift", _words(src))
            out.append(src)
        return out

    def psum(self, blocks, axis):
        g = self.sizes[DIST_AXES.index(axis)]
        sums: Dict[int, torch.Tensor] = {}
        out = []
        for d in self.devices:
            line = self.line(d, axis)
            if line[0] not in sums:
                acc = blocks[line[0]]
                for e in line[1:]:
                    acc = acc + blocks[e]
                sums[line[0]] = acc
            self._count_psum(d, blocks[d], g)
            out.append(sums[line[0]])
        return out

    def all_gather(self, blocks, axis, dim):
        g = self.sizes[DIST_AXES.index(axis)]
        cats: Dict[int, torch.Tensor] = {}
        out = []
        for d in self.devices:
            line = self.line(d, axis)
            if line[0] not in cats:
                cats[line[0]] = torch.cat([blocks[e] for e in line], dim)
            t = cats[line[0]]
            self._count_gather(d, t.numel(), t.element_size() / 4.0, g)
            out.append(t)
        return out


class GroupConvMesh(ConvMesh):
    """One device a rank of a ``torch.distributed`` process group (module
    docstring). ``group`` (default: the default group) must hold exactly P
    ranks; its i-th rank is device i. Every rank must build the mesh, as
    it creates one subgroup a line of each split axis (all ranks create
    every subgroup, in one order). A received block goes back to the
    device of the block this rank put on the wire."""

    def __init__(self, sizes, group=None):
        import torch.distributed as dist

        super().__init__(sizes)
        self._dist = dist
        self.group = group if group is not None else dist.group.WORLD
        ranks = dist.get_process_group_ranks(self.group)
        if len(ranks) != self.P:
            raise ValueError(f"mesh {self.shape} needs {self.P} ranks, the "
                             f"group has {len(ranks)}")
        self.ranks = list(ranks)
        self.rank = dist.get_rank(self.group)
        self.devices = (self.rank,)
        self.staged = dist.get_backend(self.group) == "gloo"
        self._lines: Dict[str, object] = {}
        for a, axis in enumerate(DIST_AXES):
            if self.sizes[a] == 1:
                continue
            starts = sorted({self.line(d, axis)[0] for d in range(self.P)})
            for s in starts:
                members = self.line(s, axis)
                grp = dist.new_group([self.ranks[e] for e in members])
                if self.rank in members:
                    self._lines[axis] = grp
        self.reset_wire()

    def __repr__(self) -> str:
        return f"GroupConvMesh({self.shape}, rank={self.rank})"

    def _out(self, t: torch.Tensor) -> torch.Tensor:
        """A block as it goes on the wire: host memory under gloo."""
        return t.detach().contiguous().cpu() if self.staged else \
            t.detach().contiguous()

    def _back(self, t: torch.Tensor, blk: torch.Tensor) -> torch.Tensor:
        """A received tensor on the device of this rank's block ``blk``."""
        return t.to(blk.device) if self.staged else t

    def shift_from_next(self, blocks, axis):
        dist = self._dist
        (blk,) = blocks
        d = self.rank
        send = self._out(blk)
        recv = torch.empty_like(send)
        ops = [dist.P2POp(dist.isend, send,
                          self.ranks[self.neighbor(d, axis, -1)], self.group),
               dist.P2POp(dist.irecv, recv,
                          self.ranks[self.neighbor(d, axis, 1)], self.group)]
        for req in dist.batch_isend_irecv(ops):
            req.wait()
        self._count(d, "shift", _words(recv))
        return [self._back(recv, blk)]

    def psum(self, blocks, axis):
        (blk,) = blocks
        g = self.sizes[DIST_AXES.index(axis)]
        t = self._out(blk).clone()
        self._dist.all_reduce(t, op=self._dist.ReduceOp.SUM,
                              group=self._lines[axis])
        self._count_psum(self.rank, t, g)
        return [self._back(t, blk)]

    def all_gather(self, blocks, axis, dim):
        (blk,) = blocks
        g = self.sizes[DIST_AXES.index(axis)]
        t = self._out(blk)
        parts = [torch.empty_like(t) for _ in range(g)]
        self._dist.all_gather(parts, t, group=self._lines[axis])
        out = torch.cat(parts, dim)
        self._count_gather(self.rank, out.numel(), out.element_size() / 4.0,
                           g)
        return [self._back(out, blk)]
