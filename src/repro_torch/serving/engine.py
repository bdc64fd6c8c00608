"""Slot-based continuous-batching serving engine (the counterpart of
``repro.serving.engine``).

A fixed pool of ``batch_size`` KV-cache *slots* decodes in lockstep; each
slot carries its own cache depth, so the moment a request finishes its slot
is refilled from the queue mid-flight (prefill-into-slot) instead of
barriering until the whole batch drains.

Scheduling contract:
  * admission: a queued request is prefilled alone at batch 1, its prompt
    rounded up to ``prefill_bucket`` with the pad tail masked out
    (``attn_mask`` -> the attention op's ``key_mask``), then its cache row is
    spliced into the freed slot (contiguous) or its prompt blocks land in the
    paged pool, while other slots keep decoding.
  * decode: one step for the whole pool with per-slot write offsets and
    positions; a slot only attends to its own prefix. Free/finished slots
    ride along masked out: their sampled tokens are discarded.
  * accounting: per-request stop tokens, ``max_new_tokens`` and the
    cache-capacity budget are tracked per slot; ``out_tokens`` holds only
    tokens that were really generated.

Sampling is stateless: a sampled token's ``torch.Generator`` is seeded from
(engine seed, the request's ``rng_seed`` (default: its submission index),
the number of tokens that request has produced) — never from which other
requests share the batch. Greedy rows take an argmax and touch no
randomness. The draws are not the reference's (JAX's threefry has no torch
counterpart): greedy output matches the reference, sampled output keeps the
batch invariance.

The reference compiles its steps with ``jax.jit``; the port replays each
decode step as a CUDA graph (``serving.graphs``: after one eager warm-up
step, one graph per table width of a paged pool, one for a contiguous
cache), its inputs copied into static buffers, and runs prefill, insert and
sampling eagerly. Its resilience behaviour is kept where it needs
no fault-injection campaign: bounded admission retries around a non-finite
prefill, the NaN-row guard with idempotent decode retries, the
``kv.check()`` pool rebuild from host-side request state, per-request
deadlines and the stall backstop. The campaign sites wait for
``resilience.faults`` (ROADMAP queue 1, item 11).

``stats`` holds the last ``serve``'s host-clock times: each admission's
prefill (prefill, cache landing and first token) and each decode step, both
ending in a device read of the sampled tokens; and how its decode steps
ran: warm-up steps, replays, graphs and their capture seconds.
"""

from __future__ import annotations

import collections
import dataclasses
import time
from typing import Deque, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.models import transformer as T
from repro_torch.models.layers import _quantize_kv_row
from repro_torch.models.config import ModelConfig
from repro_torch.ops import ExecutionContext
from repro_torch.plan import H100, HardwareTarget
from repro_torch.resilience import errors as flt

from . import kv
from .graphs import DecodeGraphs

# never-deadlock backstop: consecutive scheduling rounds with queued work,
# no active slot, and no admission before the loop declares itself stalled
_STALL_LIMIT = 10_000
_MASK64 = (1 << 64) - 1


@dataclasses.dataclass
class Request:
    """One generation request.

    ``stop_tokens``: emitting any of these token ids ends the request; the
    stop token is kept as the last element of ``out_tokens``.
    ``rng_seed``: per-request sampling stream id (default: submission index).
    After serving, ``out_tokens`` holds exactly the generated tokens and
    ``finish_reason`` is one of ``"stop"``, ``"length"``, ``"cache_limit"``
    (the ``max_len`` cache filled first), ``"error"`` (persistent non-finite
    logits on this row, or admission retries exhausted) or ``"timeout"``
    (``deadline_s`` elapsed since admission).
    """

    prompt: np.ndarray  # (len,) int32
    max_new_tokens: int = 16
    temperature: float = 0.0  # 0 = greedy
    stop_tokens: Tuple[int, ...] = ()
    rng_seed: Optional[int] = None
    deadline_s: Optional[float] = None
    out_tokens: Optional[np.ndarray] = None
    finish_reason: Optional[str] = None


@dataclasses.dataclass
class _Slot:
    """Host-side bookkeeping for one occupied cache slot."""

    request: Request
    budget: int  # min(max_new_tokens, cache capacity left after the prompt)
    generated: List[int] = dataclasses.field(default_factory=list)
    t0: float = 0.0  # admission wall-clock (deadline anchor)


@dataclasses.dataclass
class ServeStats:
    """Host-clock seconds of the last ``serve``: one entry per admission
    prefill and per lockstep decode step (a capture's seconds are in its
    step's). How the decode steps ran (``serving.graphs``): eager warm-up
    steps and graph replays on the card, eager steps on the CPU, the
    graphs captured (their keys: table widths, or None) and each capture's
    host seconds."""

    prefill_s: List[float] = dataclasses.field(default_factory=list)
    decode_s: List[float] = dataclasses.field(default_factory=list)
    warmup_steps: int = 0
    replayed_steps: int = 0
    eager_steps: int = 0
    graphs: List[Optional[int]] = dataclasses.field(default_factory=list)
    capture_s: List[float] = dataclasses.field(default_factory=list)


def plan_batch_size(cfg: ModelConfig, max_len: int, target: HardwareTarget,
                    cap: int = 64, hbm_fraction: float = 0.25,
                    block_size: Optional[int] = None) -> int:
    """Slot-pool size from the target's memory model: how many ``max_len``
    cache rows fit in a fraction of HBM, rounded to the target's row
    alignment. ``block_size`` switches to block-granular footprints."""
    slot_words = T.cache_footprint_words(cfg, max_len, block_size=block_size)
    b = int((hbm_fraction * target.hbm_words) // max(slot_words, 1.0))
    b = max(1, min(cap, b))
    if b >= target.align_sublane > 1:
        b -= b % target.align_sublane
    return b


def _sample_seed(engine_seed: int, request_seed: int, step: int) -> int:
    """A 63-bit generator seed, a pure function of its three arguments
    (splitmix64 finalizer over a combined key)."""
    z = ((engine_seed * 0x9E3779B97F4A7C15) ^ (request_seed << 32) ^ step)
    z &= _MASK64
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _MASK64
    return (z ^ (z >> 31)) >> 1


class Engine:
    """Continuous-batching engine over a fixed slot pool.

    ``batch_size=None`` sizes the pool from the ``HardwareTarget``'s memory
    model (``plan_batch_size``); ``ctx=None`` builds the execution context
    from ``target`` (default ``H100``), on the card. ``params`` must lie on
    the context's device; the engine keeps a copy with the matmul weights
    already in the compute dtype (``transformer.compute_params``).

    Patterns with recurrent blocks (mamba, mLSTM, sLSTM) take the
    contiguous cache (their state is O(1) a row: mamba's ``h`` and conv
    ``tail``, mLSTM's ``C`` and ``n``, sLSTM's ``c`` and ``n``, spliced into
    the slot at admission with the attention rows) and exact-length prefill
    (``prefill_bucket`` 1): a pad token would enter the recurrent state. So
    does a config with ``fused_kv_cache`` (one (B, KV, L, 2, hd) leaf a
    layer): the paged pools keep K and V apart, and ``paged=True`` raises.

    ``paged`` (default: on for pure-attention models) keeps K/V in the
    ``serving.kv`` block pool: admission reserves a request's whole block
    budget up front (shared prompt-prefix blocks counted once, refcounted),
    pool exhaustion becomes backpressure, and the decode step reads K/V
    straight out of the pool through per-row block tables
    (``ops.attention_decode``).

    ``kv_dtype="int8"`` (paged only) quantizes the pool: int8 blocks plus
    per-(block, kv_head, position) f32 scales, so the same HBM budget holds
    about twice the blocks (``kv.plan_pool_blocks(quantized=True)``), and
    each decode step reads the pool through ``ops.attention_decode_quant``.
    Prefill still runs in the compute dtype into a contiguous row; its
    landing in the pool quantizes it."""

    def __init__(self, cfg: ModelConfig, params: T.Transformer,
                 max_len: int = 512, batch_size: Optional[int] = None,
                 ctx: Optional[ExecutionContext] = None,
                 seed: int = 0, target: Optional[HardwareTarget] = None,
                 prefill_bucket: Optional[int] = None,
                 paged: Optional[bool] = None,
                 block_size: int = kv.DEFAULT_BLOCK_SIZE,
                 num_blocks: Optional[int] = None,
                 kv_dtype: str = "bf16",
                 admission_retries: int = 3,
                 numeric_retries: int = 2,
                 retry_backoff_s: float = 0.001):
        if not cfg.causal:
            raise ValueError("serving requires a decoder model")
        self.admission_retries = admission_retries
        self.numeric_retries = numeric_retries
        self.retry_backoff_s = retry_backoff_s
        self.cfg = cfg
        self.max_len = max_len
        self.target = target or (ctx.target if ctx is not None else H100)
        self.ctx = ctx or ExecutionContext(target=self.target)
        self.device = torch.device(self.ctx.device)
        if params.embed.device.type != self.device.type:
            raise ValueError(f"params lie on {params.embed.device}, the "
                             f"context runs on {self.ctx.device!r}")
        self.params = T.compute_params(params, cfg)
        attn_only = set(cfg.pattern) == {"attn"}
        if paged is None:
            paged = attn_only and not cfg.fused_kv_cache
        elif paged and not attn_only:
            raise ValueError(
                "paged KV requires a pure-attention pattern; recurrent "
                f"blocks carry O(1) state (pattern={cfg.pattern})")
        elif paged and cfg.fused_kv_cache:
            raise ValueError("paged KV uses split k/v pools; "
                             "disable fused_kv_cache")
        self.paged = paged
        self.block_size = block_size
        if kv_dtype not in ("bf16", "int8"):
            raise ValueError(f"kv_dtype must be 'bf16' or 'int8', "
                             f"got {kv_dtype!r}")
        if kv_dtype == "int8" and not paged:
            raise ValueError("kv_dtype='int8' requires the paged KV pool "
                             "(the quantized layout lives on pool blocks)")
        self.kv_quant = kv_dtype == "int8"
        if batch_size is None:
            batch_size = plan_batch_size(
                cfg, max_len, self.target,
                block_size=block_size if paged else None)
        self.batch_size = batch_size
        if paged and num_blocks is None:
            num_blocks = kv.plan_pool_blocks(cfg, max_len, batch_size,
                                             block_size, target=self.target,
                                             quantized=self.kv_quant)
        self.num_blocks = num_blocks
        if prefill_bucket is None:
            prefill_bucket = 16 if attn_only else 1
        elif prefill_bucket > 1 and not attn_only:
            raise ValueError(
                "prefill_bucket > 1 requires a pure-attention pattern: "
                "recurrent blocks fold pad tokens into their state")
        self.prefill_bucket = max(1, prefill_bucket)
        self.seed = seed
        self.stats = ServeStats()

    # -- steps (the reference's jitted step functions) -----------------------
    def _prefill(self, tokens: np.ndarray, mask: np.ndarray, last: int):
        """Batch-1 prefill into a fresh contiguous cache. ``tokens`` may be
        bucket-padded with the pad tail masked out; returns the f32 logits
        of the real last token (1, V) and the cache row."""
        cache = T.init_cache(self.cfg, 1, self.max_len, device=self.device)
        x, cache, _ = T.hidden_forward(
            self.params, self.cfg,
            tokens=torch.as_tensor(tokens, device=self.device),
            cache=cache, cache_index=0,
            attn_mask=torch.as_tensor(mask, device=self.device), ctx=self.ctx)
        logits = T.lm_logits(self.params.head, x[:, last],
                             getattr(torch, self.cfg.compute_dtype))
        return logits, cache

    def _decode_forward(self, tok: torch.Tensor, idx: torch.Tensor,
                        tables: Optional[torch.Tensor], cache):
        """The lockstep decode step over the pool (``serving.graphs``'
        step function): one token a row, written at ``idx``, through the
        block ``tables`` of a paged pool; the f32 logits (B, V)."""
        logits, _, _ = T.forward(
            self.params, self.cfg, tokens=tok, cache=cache, cache_index=idx,
            ctx=self.ctx, block_tables=tables, decode=True)
        return logits[:, -1]

    def decode_graphs(self, cache) -> DecodeGraphs:
        """The static-buffer decode runner of a serve over ``cache``."""
        return DecodeGraphs(self._decode_forward, cache, self.batch_size,
                            self.device)

    def _paged_insert(self, pool, row, blocks: List[int]) -> None:
        """Land the first ``len(blocks)`` blocks of a batch-1 contiguous
        cache row in the pool's physical ``blocks``, in place. For the int8
        pool each (kv_head, position) row is quantized symmetrically over hd
        (the decode step's ``layers._quantize_kv_row`` write path, the
        reference's ``scatter_q``) and its codes and f32 scale land
        together."""
        bs = self.block_size
        nt = len(blocks)
        ids = torch.as_tensor(blocks, dtype=torch.long, device=self.device)
        for u, leaves in pool.items():
            for src, dst, sdst in (("k", "kp", "ks"), ("v", "vp", "vs")):
                r = row[u][src]  # (R, 1, KV, max_len, hd)
                R, _, KV, L, hd = r.shape
                rb = r[:, 0, :, :min(nt * bs, L)]
                if nt * bs > L:  # max_len below a whole block: zero-pad
                    rb = torch.nn.functional.pad(rb, (0, 0, 0, nt * bs - L))
                rb = rb.reshape(R, KV, nt, bs, hd).transpose(1, 2)
                if self.kv_quant:
                    leaves[dst][:, ids], leaves[sdst][:, ids] = \
                        _quantize_kv_row(rb)
                else:
                    leaves[dst][:, ids] = rb.to(leaves[dst].dtype)

    def _sample(self, logits: torch.Tensor, seeds: np.ndarray,
                steps: np.ndarray, temps: np.ndarray):
        """Row i: greedy argmax if temps[i] == 0, else a categorical draw
        from a generator seeded by (engine seed, seeds[i], steps[i]). Also
        returns the per-row non-finite flag (the numeric guard); flagged rows
        sample from zeroed logits and are never recorded."""
        bad = ~torch.isfinite(logits).all(dim=-1)
        safe = torch.where(bad[:, None], torch.zeros_like(logits), logits)
        toks = safe.argmax(dim=-1)
        for i in np.flatnonzero(temps > 0.0):
            gen = torch.Generator(device=self.device)
            gen.manual_seed(_sample_seed(self.seed, int(seeds[i]),
                                         int(steps[i])))
            probs = torch.softmax(safe[i] / max(float(temps[i]), 1e-6), -1)
            toks[i] = torch.multinomial(probs, 1, generator=gen)[0]
        return toks.cpu().numpy().astype(np.int32), bad.cpu().numpy()

    # -- scheduling policy ----------------------------------------------------
    def _admission_open(self, slots: List[Optional[_Slot]]) -> bool:
        """Continuous batching: any free slot may be refilled immediately."""
        return True

    # -- serving loop ---------------------------------------------------------
    def serve(self, requests: List[Request]) -> List[Request]:
        with torch.inference_mode():
            return self._serve(requests)

    def _serve(self, requests: List[Request]) -> List[Request]:
        B = self.batch_size
        for r in requests:
            if not 1 <= len(r.prompt) <= self.max_len:
                raise ValueError(
                    f"prompt length {len(r.prompt)} outside [1, {self.max_len}]")
            if r.max_new_tokens < 1:
                raise ValueError("max_new_tokens must be >= 1")
            if r.rng_seed is not None and not -2**31 <= r.rng_seed < 2**31:
                raise ValueError("rng_seed must fit in int32")
            if r.deadline_s is not None and r.deadline_s <= 0:
                raise ValueError("deadline_s must be positive")
        self.stats = stats = ServeStats()
        queue: Deque[Tuple[int, Request]] = collections.deque(
            enumerate(requests))
        bs = self.block_size
        dev = self.device
        if self.paged:
            cache = T.init_paged_cache(self.cfg, self.num_blocks, bs,
                                       quantized=self.kv_quant, device=dev)
            alloc = kv.BlockAllocator(self.num_blocks)
            tables = np.zeros((B, -(-self.max_len // bs)), np.int32)
            slot_blocks: List[List[int]] = [[] for _ in range(B)]
        else:
            cache = T.init_cache(self.cfg, B, self.max_len, device=dev)
        # the decode steps' static buffers and graphs; tables only change at
        # admission, finish and rebuild, which mark the device copies stale
        steps_run = self.decode_graphs(cache)
        slots: List[Optional[_Slot]] = [None] * B
        tok = np.zeros(B, np.int32)    # last accepted token per slot
        pos = np.zeros(B, np.int32)    # cache depth: next decode write offset
        seeds = np.zeros(B, np.int64)  # per-slot sampling stream ids
        temps = np.zeros(B, np.float32)

        def finish(s: int, reason: str) -> None:
            """Close slot s with ``reason``, keeping its generated tokens,
            and release its blocks."""
            slot = slots[s]
            r = slot.request
            r.out_tokens = np.asarray(slot.generated, np.int32)
            r.finish_reason = reason
            slots[s] = None
            tok[s], temps[s] = 0, 0.0  # dead row decodes greedily into void
            if self.paged:
                for bid in slot_blocks[s]:
                    alloc.free(bid)  # shared prefixes -> refcount decrements
                slot_blocks[s] = []
                tables[s, :] = 0  # dead row reads/writes garbage block 0
                steps_run.tables_changed()

        def record(s: int, t: int) -> None:
            """Account one generated token for slot s; free it when done."""
            slot = slots[s]
            slot.generated.append(int(t))
            r = slot.request
            if int(t) in r.stop_tokens:
                finish(s, "stop")
            elif len(slot.generated) >= slot.budget:
                finish(s, "length" if slot.budget >= r.max_new_tokens
                       else "cache_limit")
            else:
                tok[s] = int(t)

        def reserve(r: Request, budget: int) -> Optional[List[int]]:
            """Reserve the request's whole block budget (prompt + decode
            growth), sharing registered prompt-prefix blocks. None = the pool
            cannot cover it now -> admission backpressure."""
            plen = len(r.prompt)
            need = -(-(plen + budget - 1) // bs)
            chain = kv.prefix_chain(r.prompt, bs)
            hits: List[Tuple[kv.PrefixKey, int]] = []
            for key in chain:
                bid = alloc.lookup(key)
                if bid is None:
                    break  # chained keys: later blocks cannot match either
                hits.append((key, bid))
            fresh = need - len(hits)
            # an evictable hit leaves the available pool the moment we take a
            # reference, so it cannot also satisfy a fresh allocation
            evictable_hits = sum(1 for _, b in hits if alloc.refcount(b) == 0)
            if alloc.available() - evictable_hits < fresh:
                return None
            blocks = [alloc.ref(b) for _, b in hits]
            for key in chain[len(hits):]:
                b = alloc.alloc()
                alloc.register(b, key)  # a full prompt block: shareable
                blocks.append(b)
            while len(blocks) < need:  # partial tail + decode growth: private
                blocks.append(alloc.alloc())
            return blocks

        def bucket_inputs(written: np.ndarray):
            """Bucket-padded (1, lp) tokens and their pad mask."""
            n = len(written)
            lp = min(self.max_len,
                     -(-n // self.prefill_bucket) * self.prefill_bucket)
            tokens = np.zeros((1, lp), np.int64)
            tokens[0, :n] = written
            mask = np.zeros((1, lp), bool)
            mask[0, :n] = True
            return tokens, mask

        def rebuild_pool():
            """Fresh allocator + pool, rebuilt from host-side request state:
            every live slot re-reserves its block budget (prefix sharing
            intact, in slot order) and re-prefills exactly the tokens already
            written to the cache (``prompt + generated[:pos - plen]``)."""
            new_alloc = kv.BlockAllocator(self.num_blocks)
            new_cache = T.init_paged_cache(self.cfg, self.num_blocks, bs,
                                           quantized=self.kv_quant,
                                           device=dev)
            steps_run.reset(new_cache)  # the graphs wrote the old pool
            for s in range(B):
                slot = slots[s]
                if slot is None:
                    slot_blocks[s] = []
                    tables[s, :] = 0
                    continue
                r = slot.request
                plen = len(r.prompt)
                need = len(slot_blocks[s])
                blocks: List[int] = []
                for key in kv.prefix_chain(r.prompt, bs):
                    bid = new_alloc.lookup(key)
                    if bid is not None:
                        blocks.append(new_alloc.ref(bid))
                        continue
                    b = new_alloc.alloc()
                    new_alloc.register(b, key)
                    blocks.append(b)
                while len(blocks) < need:
                    blocks.append(new_alloc.alloc())
                slot_blocks[s] = blocks
                tables[s, :] = 0
                tables[s, :len(blocks)] = blocks
                written = int(pos[s])
                seq = np.concatenate([r.prompt, np.asarray(
                    slot.generated[:written - plen], np.int64)])
                tokens, mask = bucket_inputs(seq)
                _, row = self._prefill(tokens, mask, written - 1)
                self._paged_insert(new_cache, row,
                                   blocks[:-(-written // bs)])
            return new_alloc, new_cache

        def admit_prefill(prompt: np.ndarray):
            """Batch-1 prefill with bounded retry-with-backoff around the
            finite-logits guard. Returns ``(logits, cache_row)``, or None
            once ``admission_retries`` retries are exhausted — the caller
            then fails that one request, nobody else."""
            tokens, mask = bucket_inputs(prompt)
            for attempt in range(self.admission_retries + 1):
                logits1, row = self._prefill(tokens, mask, len(prompt) - 1)
                if bool(torch.isfinite(logits1).all()):
                    return logits1, row
                if attempt < self.admission_retries:
                    time.sleep(min(self.retry_backoff_s * (2 ** attempt),
                                   0.05))
            return None

        rounds = 0
        stall = 0  # consecutive no-slot no-admission rounds with queued work
        while queue or any(s is not None for s in slots):
            rounds += 1
            # -- deadline sweep: expire requests past their wall budget -----
            now = time.monotonic()
            for s in range(B):
                slot = slots[s]
                if (slot is not None
                        and slot.request.deadline_s is not None
                        and now - slot.t0 >= slot.request.deadline_s):
                    finish(s, "timeout")
            # -- pool integrity, periodically: a tripped invariant rebuilds
            # pool + allocator from host state
            if self.paged and rounds % 256 == 0:
                try:
                    alloc.check()
                except flt.PoolIntegrityFault:
                    alloc, cache = rebuild_pool()
            # -- admission: prefill queued requests into freed slots --------
            admitted = 0
            if queue and self._admission_open(slots):
                for s in range(B):
                    if not queue or slots[s] is not None:
                        continue
                    rid, r = queue[0]
                    plen = len(r.prompt)
                    # token 1 comes from the prefill logits; token k needs a
                    # cache write at plen + k - 2 <= max_len - 1
                    budget = min(r.max_new_tokens, self.max_len - plen + 1)
                    if self.paged:
                        blocks = reserve(r, budget)
                        if blocks is None:
                            if not any(x is not None for x in slots):
                                try:
                                    alloc.check()
                                except flt.PoolIntegrityFault:
                                    # a corrupted allocator can fake
                                    # exhaustion: repair, retry next round
                                    alloc, cache = rebuild_pool()
                                    break
                                raise flt.AdmissionImpossible(
                                    f"paged KV pool of {self.num_blocks} "
                                    f"blocks cannot ever admit a "
                                    f"{plen}-token prompt with budget "
                                    f"{budget}; raise num_blocks",
                                    num_blocks=self.num_blocks,
                                    blocks_needed=-(-(plen + budget - 1)
                                                    // bs),
                                    available_blocks=alloc.available(),
                                    live_blocks=alloc.live_blocks())
                            break  # backpressure: wait for a slot to finish
                        slot_blocks[s] = blocks
                        tables[s, :] = 0
                        tables[s, :len(blocks)] = blocks
                        steps_run.tables_changed()
                    queue.popleft()
                    admitted += 1
                    t0 = time.perf_counter()
                    out = admit_prefill(r.prompt)
                    if out is None:
                        # retries exhausted: this request alone fails; its
                        # reservation is returned
                        r.out_tokens = np.asarray([], np.int32)
                        r.finish_reason = "error"
                        if self.paged:
                            for bid in slot_blocks[s]:
                                alloc.free(bid)
                            slot_blocks[s] = []
                            tables[s, :] = 0
                            steps_run.tables_changed()
                        continue
                    logits1, row = out
                    slots[s] = _Slot(request=r, budget=budget,
                                     t0=time.monotonic())
                    seeds[s] = r.rng_seed if r.rng_seed is not None else rid
                    temps[s] = r.temperature
                    pos[s] = plen
                    if self.paged:
                        # land the prompt's blocks in the pool (a shared hit
                        # is rewritten with bit-identical K/V)
                        self._paged_insert(cache, row,
                                           slot_blocks[s][:-(-plen // bs)])
                    else:
                        T.insert_cache_slot(cache, row, s)
                    first, _ = self._sample(logits1, seeds[s:s + 1],
                                            np.zeros(1, np.int32),
                                            temps[s:s + 1])
                    record(s, int(first[0]))
                    stats.prefill_s.append(time.perf_counter() - t0)
            active = [s for s in range(B) if slots[s] is not None]
            if not active:
                # everything admitted this round finished instantly, or
                # admission backpressured with an empty pool: the stall
                # backstop turns a loop without progress into a typed fatal
                stall = 0 if admitted else stall + 1
                if stall > _STALL_LIMIT and queue:
                    raise flt.SchedulerStall(
                        f"no admission progress for {stall} rounds with "
                        f"{len(queue)} request(s) queued and no active slot",
                        queued=len(queue), rounds=rounds)
                continue
            stall = 0
            # -- one lockstep decode step over the pool ---------------------
            # Free rows ride along at offset 0; their writes land in rows
            # fully overwritten at the next insert (contiguous) or in the
            # garbage block 0 (paged), and their samples are never recorded.
            # A decode step rewrites the same cache positions with the same
            # values, so the numeric retry below can simply re-run it; a
            # recurrent state is advanced once more by it, as in the
            # reference.
            t0 = time.perf_counter()
            steps = np.array([len(slots[s].generated) if slots[s] else 0
                              for s in range(B)], np.int32)
            idx = np.where([slots[s] is not None for s in range(B)], pos, 0)
            if self.paged:
                # table width follows the deepest active row; dead rows are
                # all-zero (garbage) tables
                w = max(int(pos[s]) // bs + 1 for s in active)
                key = steps_run.load(tok, idx, tables, w)
            else:
                key = steps_run.load(tok, idx)
            for attempt in range(self.numeric_retries + 1):
                logits = steps_run.run(key)
                nxt, bad = self._sample(logits, seeds, steps, temps)
                bad_rows = [s for s in active if bad[s]]
                if not bad_rows:
                    break
                if attempt == self.numeric_retries:
                    # persistent NaN on these rows: fail them alone, keep
                    # their generated-so-far tokens, never record this step
                    for s in bad_rows:
                        finish(s, "error")
                    break
                time.sleep(min(self.retry_backoff_s * (2 ** attempt), 0.05))
            for s in active:
                if slots[s] is None:
                    continue  # failed/expired rows were closed above
                pos[s] += 1
                record(s, int(nxt[s]))
            stats.decode_s.append(time.perf_counter() - t0)
        stats.warmup_steps = steps_run.warmups
        stats.replayed_steps = steps_run.replays
        stats.eager_steps = steps_run.eager_steps
        stats.graphs = steps_run.graphs
        stats.capture_s = list(steps_run.capture_s)
        return requests


class WaveEngine(Engine):
    """Wave-lockstep baseline: admit a full batch, then barrier until every
    request in it finishes, on top of the same slot primitives."""

    def _admission_open(self, slots: List[Optional[_Slot]]) -> bool:
        return all(s is None for s in slots)
