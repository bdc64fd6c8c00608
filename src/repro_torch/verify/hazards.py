"""Hazard detector for the kernels' shared-memory copy schedules. The port of
``repro.verify.hazards``.

The reference's event kinds (``start``, ``wait``, ``read``) describe one
TPU core's two-slot DMA pipeline: :func:`double_buffered_schedule` emits it
and :func:`check_schedule` gives the same hazards on it as the reference.
A CUDA kernel's ``cp.async`` ring needs more: copies are issued in commit
groups and completed by ``cp.async.wait_group(n)`` (every group but the
newest ``n``), a thread's wait shows its own copies only, so every warp
meets the others at ``__syncthreads`` before it reads what they copied or
refills what they read, and paged decode's CTAs share a cluster whose
barrier (``cluster.sync``) fences reads of another CTA's shared memory.
:func:`ring_schedule` emits an N-slot ring with ``depth`` stages in flight
from a kernel's own ring constants; the kernels' access-plan builders add
their other buffers. Hazards:

  H1 read-before-wait      a step reads slot data that never landed
  H2 double-start          two in-flight copies target one slot
  H3 reuse-distance        a slot is refilled < n_slots steps after its
                           previous fill, or before its data was read
  H4 inflight-read         a copy is in flight into a slot being read or
                           written
  H5 dangling-start        an in-flight copy is never waited before the
                           schedule ends
  H6 missing-barrier       (more than one warp) a slot is refilled or
                           rewritten with no ``__syncthreads`` since its last
                           read, or read with no ``__syncthreads`` since it
                           landed or was written: the multi-warp form of
                           H3/H4
  H7 cluster-fence         a read of another CTA's shared memory with no
                           ``cluster.sync`` between its write and the read,
                           a CTA that may exit before another reads its
                           shared memory, or CTAs of one cluster that pass
                           different numbers of ``cluster.sync``
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

START, WAIT, READ = "start", "wait", "read"
# the cp.async ring's kinds
COMMIT = "commit"            # close the open commit group
WAIT_GROUP = "wait_group"    # cp.async.wait_group(n): all but the newest n
BARRIER = "barrier"          # __syncthreads
CLUSTER_SYNC = "cluster_sync"  # cluster.sync (also a barrier of the CTA)
WRITE = "write"              # plain shared-memory stores into a slot
REMOTE_READ = "remote_read"  # a read of slot `slot` of CTA `peer`'s memory
EXIT = "exit"                # the CTA ends

_SLOTLESS = (COMMIT, WAIT_GROUP, BARRIER, CLUSTER_SYNC, EXIT)


@dataclasses.dataclass(frozen=True)
class DmaEvent:
    kind: str
    slot: int
    step: int  # stage payload the event moves/consumes
    n: int = 0  # wait_group: the groups that may stay in flight
    rank: int = 0  # the CTA of its cluster the event runs in
    peer: int = 0  # remote_read: the CTA whose shared memory is read
    # a read or write of rows only the issuing warp touches (no other warp
    # reads or writes them in between): exempt from the barrier rules
    local: bool = False


@dataclasses.dataclass(frozen=True)
class DmaSchedule:
    """Event stream of one shared-memory buffer: ``n_slots`` slots,
    ``n_steps`` stages. ``warps`` > 1 turns on the barrier rules (H6);
    the reference's schedules are one TPU core's (1)."""

    n_slots: int
    n_steps: int
    events: Tuple[DmaEvent, ...]
    name: str = "stream"
    warps: int = 1


@dataclasses.dataclass(frozen=True)
class Hazard:
    code: str  # H1..H7
    event_index: int  # -1 for end-of-schedule hazards
    message: str

    def __str__(self) -> str:  # pragma: no cover - cosmetic
        return f"{self.code}@{self.event_index}: {self.message}"


def double_buffered_schedule(n_steps: int, n_slots: int = 2,
                             name: str = "stream") -> DmaSchedule:
    """The reference's schedule across the reduction axis (warm up slot 0,
    prefetch ci + 1, wait ci, read ci)."""
    ev: List[DmaEvent] = []
    for ci in range(n_steps):
        slot = ci % n_slots
        if ci == 0:
            ev.append(DmaEvent(START, 0, 0))
        if ci + 1 < n_steps:
            ev.append(DmaEvent(START, (ci + 1) % n_slots, ci + 1))
        ev.append(DmaEvent(WAIT, slot, ci))
        ev.append(DmaEvent(READ, slot, ci))
    return DmaSchedule(n_slots=n_slots, n_steps=n_steps, events=tuple(ev),
                       name=name)


def ring_events(n_steps: int, n_slots: int, depth: int, rank: int = 0,
                reads_prev=None, step0: int = 0,
                prologue_barrier: bool = False) -> List[DmaEvent]:
    """A ``cp.async`` ring's events for one CTA: the prologue issues stages
    0 .. depth - 1 (one commit group each, empty past the last stage); then
    stage s runs ``wait_group(depth - 1)``, ``__syncthreads``, issues stage
    s + depth into slot (s + depth) % n_slots (an empty group past the
    last), and reads slot s % n_slots, and slot (s - 1) % n_slots too where
    ``reads_prev(s)`` (a tail carried from the previous stage). Steps are
    numbered from ``step0``; ``prologue_barrier`` adds a ``__syncthreads``
    after the prologue; the caller closes the walk (``wait_group(0)``)."""
    ev: List[DmaEvent] = []

    def start(s):
        return DmaEvent(START, s % n_slots, step0 + s, rank=rank)

    for s in range(depth):
        if s < n_steps:
            ev.append(start(s))
        ev.append(DmaEvent(COMMIT, 0, 0, rank=rank))
    if prologue_barrier:
        ev.append(DmaEvent(BARRIER, 0, 0, rank=rank))
    for s in range(n_steps):
        ev.append(DmaEvent(WAIT_GROUP, 0, 0, n=depth - 1, rank=rank))
        ev.append(DmaEvent(BARRIER, 0, 0, rank=rank))
        if s + depth < n_steps:
            ev.append(start(s + depth))
        ev.append(DmaEvent(COMMIT, 0, 0, rank=rank))
        ev.append(DmaEvent(READ, s % n_slots, step0 + s, rank=rank))
        if reads_prev is not None and s > 0 and reads_prev(s):
            ev.append(DmaEvent(READ, (s - 1) % n_slots, step0 + s - 1,
                               rank=rank))
    return ev


def ring_schedule(n_steps: int, n_slots: int, depth: int, warps: int,
                  name: str = "ring", reads_prev=None,
                  drain: bool = True) -> DmaSchedule:
    """An N-slot ring with ``depth`` stages in flight (see
    :func:`ring_events`), closed by a ``wait_group(0)`` where ``drain`` (a
    kernel that waits out its trailing groups before it exits)."""
    if not 1 <= depth < n_slots + (n_slots == 1):
        raise ValueError(f"a ring of {n_slots} slots cannot keep {depth} "
                         "stages in flight")
    ev = ring_events(n_steps, n_slots, depth, reads_prev=reads_prev)
    if drain:
        ev.append(DmaEvent(WAIT_GROUP, 0, 0, n=0))
    return DmaSchedule(n_slots=n_slots, n_steps=n_steps, events=tuple(ev),
                       name=name, warps=warps)


class Program:
    """A kernel's events over several shared-memory buffers, in program
    order (one CTA, or the CTAs of a cluster by ``rank``). ``schedules``
    splits it into one :class:`DmaSchedule` a buffer: each buffer's own
    events plus every commit, wait, barrier and exit, so that a buffer's
    copies land with the commit groups they were issued in."""

    def __init__(self) -> None:
        self.events: List[Tuple[str, DmaEvent]] = []

    def add(self, buf: str, kind: str, slot: int = 0, step: int = 0,
            **kw) -> None:
        self.events.append((buf, DmaEvent(kind, slot, step, **kw)))

    def start(self, buf, slot, step, rank=0):
        self.add(buf, START, slot, step, rank=rank)

    def read(self, buf, slot, step, rank=0, local=False):
        self.add(buf, READ, slot, step, rank=rank, local=local)

    def write(self, buf, slot, step, rank=0, local=False):
        self.add(buf, WRITE, slot, step, rank=rank, local=local)

    def remote_read(self, buf, slot, step, rank, peer):
        self.add(buf, REMOTE_READ, slot, step, rank=rank, peer=peer)

    def commit(self, rank=0):
        self.add("", COMMIT, rank=rank)

    def wait_group(self, n, rank=0):
        self.add("", WAIT_GROUP, n=n, rank=rank)

    def barrier(self, rank=0):
        self.add("", BARRIER, rank=rank)

    def cluster_sync(self, rank=0):
        self.add("", CLUSTER_SYNC, rank=rank)

    def exit(self, rank=0):
        self.add("", EXIT, rank=rank)

    def ring(self, buf: str, n_steps: int, n_slots: int, depth: int,
             rank: int = 0, reads_prev=None, plain: bool = False,
             prologue_barrier: bool = False) -> None:
        """The ring of :func:`ring_events` into buffer ``buf``; ``plain``
        issues each stage as plain stores (``write``), not copies."""
        for e in ring_events(n_steps, n_slots, depth, rank=rank,
                             reads_prev=reads_prev,
                             prologue_barrier=prologue_barrier):
            if plain and e.kind == START:
                e = dataclasses.replace(e, kind=WRITE)
            self.events.append(("" if e.kind in _SLOTLESS else buf, e))

    def schedules(self, slots: Dict[str, int], warps: int,
                  name: str) -> Tuple[DmaSchedule, ...]:
        out = []
        for buf, n in slots.items():
            ev = tuple(e for b, e in self.events
                       if b == buf or (b == "" and e.kind in _SLOTLESS))
            steps = {e.step for e in ev if e.kind in (START, WRITE)}
            out.append(DmaSchedule(n_slots=n, n_steps=len(steps), events=ev,
                                   name=f"{name}: {buf}", warps=warps))
        return tuple(out)


def without(sched: DmaSchedule, kind: str, name: Optional[str] = None
            ) -> DmaSchedule:
    """``sched`` with every event of ``kind`` removed (the mutants' and
    tests' seeded faults)."""
    return dataclasses.replace(
        sched, events=tuple(e for e in sched.events if e.kind != kind),
        name=name or f"{sched.name} without {kind}")


@dataclasses.dataclass
class _Cta:
    n: int
    inflight: List[Optional[int]]
    ready: List[Optional[int]]
    unread: List[bool]
    last_fill: List[Optional[int]]
    visible: List[bool]
    read_since_barrier: List[bool]
    groups: List[List[Tuple[int, int]]]
    open_group: List[Tuple[int, int]]
    done: int = 0
    epoch: int = 0
    exit_epoch: Optional[int] = None

    @classmethod
    def fresh(cls, n: int) -> "_Cta":
        return cls(n, [None] * n, [None] * n, [False] * n, [None] * n,
                   [False] * n, [False] * n, [], [])


def check_schedule(sched: DmaSchedule) -> List[Hazard]:
    """Simulate the event stream; return every hazard found (empty =
    clean). On the reference's kinds with one warp and one CTA the result
    is the reference's."""
    n = sched.n_slots
    multi = sched.warps > 1
    ctas: Dict[int, _Cta] = {}
    landed_at: Dict[Tuple[int, int, int], int] = {}  # (rank, slot, step)
    remote: List[Tuple[int, DmaEvent]] = []
    hazards: List[Hazard] = []

    def bad(code: str, i: int, msg: str) -> None:
        hazards.append(Hazard(code, i, f"[{sched.name}] {msg}"))

    def land(c: _Cta, rank: int, slot: int, step: int) -> None:
        c.ready[slot] = step
        c.unread[slot] = True
        c.visible[slot] = not multi
        landed_at[(rank, slot, step)] = c.epoch

    def barrier(c: _Cta) -> None:
        for s in range(n):
            if c.ready[s] is not None and c.inflight[s] is None:
                c.visible[s] = True
            c.read_since_barrier[s] = False

    for i, ev in enumerate(sched.events):
        c = ctas.setdefault(ev.rank, _Cta.fresh(n))
        if ev.kind not in _SLOTLESS and (ev.slot < 0 or ev.slot >= n):
            bad("H2", i, f"event targets slot {ev.slot} outside 0..{n - 1}")
            continue
        if ev.kind == START:
            if c.inflight[ev.slot] is not None:
                bad("H2", i, f"start(step {ev.step}) while step "
                             f"{c.inflight[ev.slot]} is still in flight into "
                             f"slot {ev.slot}")
            if c.unread[ev.slot]:
                bad("H3", i, f"start(step {ev.step}) overwrites slot "
                             f"{ev.slot} before step {c.ready[ev.slot]} was "
                             f"read")
            if (c.last_fill[ev.slot] is not None
                    and ev.step - c.last_fill[ev.slot] < n):
                bad("H3", i, f"slot {ev.slot} reused after "
                             f"{ev.step - c.last_fill[ev.slot]} steps "
                             f"(< {n} buffers)")
            if multi and c.read_since_barrier[ev.slot]:
                bad("H6", i, f"start(step {ev.step}) refills slot {ev.slot} "
                             "with no __syncthreads since its last read")
            c.inflight[ev.slot] = ev.step
            c.last_fill[ev.slot] = ev.step
            c.open_group.append((ev.slot, ev.step))
        elif ev.kind == WAIT:
            if c.inflight[ev.slot] != ev.step:
                bad("H1", i, f"wait(step {ev.step}, slot {ev.slot}) without "
                             f"a matching start (in flight: "
                             f"{c.inflight[ev.slot]})")
            else:
                c.inflight[ev.slot] = None
                land(c, ev.rank, ev.slot, ev.step)
                c.visible[ev.slot] = True
        elif ev.kind == READ:
            if c.inflight[ev.slot] is not None:
                bad("H4", i, f"step {ev.step} reads slot {ev.slot} while "
                             f"step {c.inflight[ev.slot]} is being copied "
                             f"into it")
            if c.ready[ev.slot] != ev.step:
                held = ('nothing' if c.ready[ev.slot] is None
                        else f'step {c.ready[ev.slot]}')
                bad("H1", i, f"step {ev.step} reads slot {ev.slot} but the "
                             f"slot holds {held} (missing wait)")
            elif multi and not ev.local and not c.visible[ev.slot]:
                bad("H6", i, f"step {ev.step} reads slot {ev.slot} with no "
                             "__syncthreads since it landed or was written")
            c.unread[ev.slot] = False
            if multi:
                c.read_since_barrier[ev.slot] = True
        elif ev.kind == COMMIT:
            c.groups.append(c.open_group)
            c.open_group = []
        elif ev.kind == WAIT_GROUP:
            upto = len(c.groups) - ev.n
            for g in c.groups[c.done:max(upto, c.done)]:
                for slot, step in g:
                    if c.inflight[slot] == step:
                        c.inflight[slot] = None
                        land(c, ev.rank, slot, step)
            c.done = max(c.done, upto)
        elif ev.kind in (BARRIER, CLUSTER_SYNC):
            barrier(c)
            if ev.kind == CLUSTER_SYNC:
                c.epoch += 1
        elif ev.kind == WRITE:
            if c.inflight[ev.slot] is not None:
                bad("H4", i, f"write(step {ev.step}) into slot {ev.slot} "
                             f"while step {c.inflight[ev.slot]} is being "
                             "copied into it")
            if multi and not ev.local and c.read_since_barrier[ev.slot]:
                bad("H6", i, f"write(step {ev.step}) rewrites slot "
                             f"{ev.slot} with no __syncthreads since its "
                             "last read")
            land(c, ev.rank, ev.slot, ev.step)
            c.last_fill[ev.slot] = None
        elif ev.kind == REMOTE_READ:
            remote.append((i, dataclasses.replace(ev, n=c.epoch)))
        elif ev.kind == EXIT:
            c.exit_epoch = c.epoch
        else:  # pragma: no cover - malformed schedule
            bad("H1", i, f"unknown event kind {ev.kind!r}")
    for i, ev in remote:  # ev.n carries the reader's epoch
        wrote = landed_at.get((ev.peer, ev.slot, ev.step))
        if wrote is None:
            bad("H1", i, f"CTA {ev.rank} reads step {ev.step} of CTA "
                         f"{ev.peer}'s slot {ev.slot}, which never holds it")
        elif wrote >= ev.n:
            bad("H7", i, f"CTA {ev.rank} reads CTA {ev.peer}'s slot "
                         f"{ev.slot} with no cluster.sync since it was "
                         "written")
        peer = ctas.get(ev.peer)
        if ev.peer != ev.rank and peer is not None \
                and peer.exit_epoch is not None and peer.exit_epoch <= ev.n:
            bad("H7", i, f"CTA {ev.peer} may exit before CTA {ev.rank} "
                         f"reads its slot {ev.slot}")
    if len({c.epoch for c in ctas.values()}) > 1:
        bad("H7", -1, "the cluster's CTAs pass different numbers of "
                      "cluster.sync")
    for rank, c in sorted(ctas.items()):
        for slot, step in enumerate(c.inflight):
            if step is not None:
                where = f" of CTA {rank}" if len(ctas) > 1 else ""
                hazards.append(Hazard(
                    "H5", -1, f"[{sched.name}] copy of step {step} into "
                              f"slot {slot}{where} never waited before "
                              "schedule end"))
    return hazards
