"""Paged KV-cache subsystem: fixed-size blocks, block tables, prefix sharing
(a copy of ``repro.serving.kv``, pure Python).

The serving engine's decode cost is almost pure KV-cache traffic (the
memory-independent term of ``core.bounds.attention_bound`` dominates at
Lq = 1), so the pool exists to make that traffic proportional to *live*
tokens rather than to ``batch * max_len``:

- The cache is one physical pool of ``num_blocks`` fixed-size blocks
  (``block_size`` token positions each, vLLM-style); a request holds a
  *block table* — the list of physical block ids backing its logical
  positions — instead of a contiguous slice.
- Full prompt blocks are content-addressed by a chained hash key
  (``parent_key, block_tokens``), so two requests sharing a system prompt
  share physical blocks with reference counting; the pool charges the prefix
  once.
- Allocation is explicit: ``BlockAllocator.alloc`` raises :class:`BlockOOM`
  when the pool (plus the LRU pool of retained rc=0 prefix blocks) is
  exhausted, and the engine turns that into admission backpressure rather
  than silent eviction of live state.
- Block id 0 is a reserved garbage block: dead batch rows and padded table
  entries point at it, so lockstep decode can write/read it harmlessly.

``plan_pool_blocks`` sizes the pool from ``HardwareTarget.hbm_words`` the
same way ``Engine.plan_batch_size`` sizes the slot pool.
"""

from __future__ import annotations

import collections
import math
from typing import Dict, List, Optional, Sequence, Tuple

from repro_torch.resilience.errors import PoolIntegrityFault, TransientFault

DEFAULT_BLOCK_SIZE = 16
GARBAGE_BLOCK = 0

# A full prompt block's content address: (parent block's key or None, the
# block_size token ids it holds). Chaining the parent key makes equal token
# windows at different prefix positions distinct, like vLLM's hash chain.
PrefixKey = Tuple[Optional[tuple], Tuple[int, ...]]


class BlockOOM(TransientFault):
    """The pool cannot satisfy an allocation; admission must back off.

    A :class:`repro_torch.resilience.errors.TransientFault` (still a
    ``RuntimeError`` through the taxonomy base): pool pressure is the
    canonical recoverable condition — the engine answers with bounded
    backpressure, never an abort."""


def prefix_chain(tokens: Sequence[int], block_size: int) -> List[PrefixKey]:
    """Content keys for every FULL block of ``tokens``, in chain order.

    Only full blocks are shareable: a partial tail block will be appended to
    during decode, so it is always private to its request."""
    keys: List[PrefixKey] = []
    parent: Optional[PrefixKey] = None
    for s in range(0, len(tokens) - block_size + 1, block_size):
        key: PrefixKey = (parent, tuple(int(t) for t in tokens[s:s + block_size]))
        keys.append(key)
        parent = key
    return keys


class BlockAllocator:
    """Refcounted block allocator with LRU retention of shareable blocks.

    States a (non-reserved) block can be in — exactly one at any time:

    - **free**: on the free list, contents meaningless.
    - **in use**: refcount >= 1 (held by one or more requests).
    - **evictable**: refcount == 0 but registered under a prefix key; its
      contents are kept so a future request with the same prefix can revive
      it. Evicted (moved to free) lazily, oldest first, only when the free
      list runs dry.

    ``num_blocks`` counts the whole pool including reserved ids, matching the
    physical pool array's leading axis.
    """

    def __init__(self, num_blocks: int,
                 reserved: Sequence[int] = (GARBAGE_BLOCK,)):
        if num_blocks <= len(reserved):
            raise ValueError(
                f"pool of {num_blocks} blocks leaves nothing to allocate "
                f"after {len(reserved)} reserved")
        self.num_blocks = num_blocks
        self.reserved = tuple(reserved)
        self._free: collections.deque[int] = collections.deque(
            b for b in range(num_blocks) if b not in self.reserved)
        self._rc: Dict[int, int] = {}
        self._key_of: Dict[int, PrefixKey] = {}
        self._block_of: Dict[PrefixKey, int] = {}
        # rc==0 registered blocks, insertion order == LRU order
        self._evictable: "collections.OrderedDict[int, None]" = (
            collections.OrderedDict())

    # -- allocation ---------------------------------------------------------

    def alloc(self) -> int:
        """A block with refcount 1. Raises :class:`BlockOOM` when neither the
        free list nor the evictable LRU can supply one."""
        if self._free:
            bid = self._free.popleft()
        elif self._evictable:
            bid, _ = self._evictable.popitem(last=False)  # oldest first
            del self._block_of[self._key_of.pop(bid)]
        else:
            raise BlockOOM(
                f"all {self.num_blocks - len(self.reserved)} allocatable "
                f"blocks are referenced")
        self._rc[bid] = 1
        return bid

    def ref(self, bid: int) -> int:
        """Take an additional reference (reviving an evictable block)."""
        rc = self._rc.get(bid, 0)
        if rc == 0:
            if bid not in self._evictable:
                raise ValueError(f"block {bid} is not live or evictable")
            del self._evictable[bid]
        self._rc[bid] = rc + 1
        return bid

    def free(self, bid: int) -> None:
        """Drop one reference. A registered block that reaches refcount 0
        becomes evictable (contents retained for prefix reuse); an anonymous
        one returns to the free list."""
        rc = self._rc.get(bid, 0)
        if rc <= 0:
            raise ValueError(f"double free of block {bid}")
        if rc > 1:
            self._rc[bid] = rc - 1
            return
        del self._rc[bid]
        if bid in self._key_of:
            self._evictable[bid] = None  # most-recently-used end
        else:
            self._free.append(bid)

    # -- prefix sharing -----------------------------------------------------

    def lookup(self, key: PrefixKey) -> Optional[int]:
        return self._block_of.get(key)

    def register(self, bid: int, key: PrefixKey) -> None:
        """Content-address a live block so later requests can share it."""
        if self._rc.get(bid, 0) <= 0:
            raise ValueError(f"cannot register non-live block {bid}")
        other = self._block_of.get(key)
        if other is not None and other != bid:
            raise ValueError(f"key already registered to block {other}")
        prev = self._key_of.get(bid)
        if prev is not None and prev != key:
            del self._block_of[prev]
        self._key_of[bid] = key
        self._block_of[key] = bid

    # -- accounting ---------------------------------------------------------

    def refcount(self, bid: int) -> int:
        return self._rc.get(bid, 0)

    def available(self) -> int:
        """Blocks an alloc() can obtain right now (free + evictable)."""
        return len(self._free) + len(self._evictable)

    def live_blocks(self) -> int:
        """Blocks with refcount >= 1."""
        return len(self._rc)

    def used_words(self, words_per_block: float) -> float:
        """Pool occupancy in words — shared prefix blocks counted ONCE."""
        return self.live_blocks() * words_per_block

    def check(self) -> None:
        """Invariant check: every non-reserved block is in exactly one of
        {free, live, evictable}, and key maps are mutually inverse. Raises
        :class:`PoolIntegrityFault` (transient: the engine rebuilds the
        pool from host-side request state) with occupancy diagnostics."""
        free = set(self._free)
        live = set(self._rc)
        evict = set(self._evictable)
        problems: List[str] = []
        if (free & live) or (free & evict) or (live & evict):
            problems.append("a block is in two states at once")
        if free | live | evict != (
                set(range(self.num_blocks)) - set(self.reserved)):
            problems.append("free|live|evictable does not partition the pool")
        if not all(rc > 0 for rc in self._rc.values()):
            problems.append("non-positive refcount on a live block")
        if {k: b for b, k in self._key_of.items()} != self._block_of:
            problems.append("prefix-key maps are not mutually inverse")
        if not all(b in self._rc or b in self._evictable
                   for b in self._key_of):
            problems.append("a keyed block is neither live nor evictable")
        if problems:
            raise PoolIntegrityFault(
                "; ".join(problems), num_blocks=self.num_blocks,
                free=len(free), live=len(live), evictable=len(evict))


# ---------------------------------------------------------------------------
# Pool sizing (words per block, blocks per HBM budget)
# ---------------------------------------------------------------------------

def block_words(cfg, block_size: int, dtype_itemsize: int = 2,
                quantized: bool = False) -> float:
    """32-bit words one physical block occupies across all attention layers
    (K and V, un-repeated GQA heads). ``quantized`` switches to the int8
    pool layout: one byte per element plus one f32 scale per (kv_head,
    position) row — (1 + 4/hd) bytes per element, vs bf16's 2 — so a
    quantized pool packs ~2x the blocks into the same budget (the
    ``capacity_gain`` gate in benchmarks/quant_bench.py)."""
    n_attn = cfg.repeats * sum(1 for kind in cfg.pattern if kind == "attn")
    elems = n_attn * 2 * cfg.n_kv_heads * block_size * cfg.hd
    if quantized:
        return elems * (1.0 + 4.0 / cfg.hd) / 4.0
    return elems * dtype_itemsize / 4.0


def plan_pool_blocks(cfg, max_len: int, batch_size: int,
                     block_size: int = DEFAULT_BLOCK_SIZE,
                     target=None, hbm_fraction: float = 0.25,
                     dtype_itemsize: int = 2, quantized: bool = False) -> int:
    """Pool size in blocks: enough for every slot to hold ``max_len`` tokens
    (plus the reserved garbage block), clamped to ``hbm_fraction`` of the
    target's HBM — but never below one full sequence, mirroring
    ``Engine.plan_batch_size``'s budget policy. ``quantized`` prices blocks
    at the int8+scales layout (see :func:`block_words`)."""
    per_seq = math.ceil(max_len / block_size)
    want = 1 + batch_size * per_seq
    if target is None:
        return want
    budget = hbm_fraction * target.hbm_words
    cap = 1 + int(budget // max(
        block_words(cfg, block_size, dtype_itemsize, quantized=quantized),
        1.0))
    return max(min(want, cap), 1 + per_seq)
