"""Compiled decode steps: the port's counterpart of the reference's jitted
decode functions (``_make_steps`` / ``_make_paged_steps`` in
``repro.serving.engine``), as CUDA graphs.

:class:`DecodeGraphs` runs one lockstep decode step of an engine's pool,
the forward of ``transformer.forward(..., decode=True)`` on the engine's
cache, through static device buffers: before each step the token ids
``(B, 1)``, the write indices ``(B,)`` and, for a paged pool, the block
tables ``(B, w)`` are copied into buffers the step reads in place, and the
logits come out of the step's static output. On the card:

  * the first step of a serve runs eagerly, the warm-up: the libraries'
    builds, ``cudaFuncSetAttribute`` and the cuBLAS handles and workspace
    all happen there, on the stream the graphs are captured on;
  * every later step is a replay of a graph captured with
    ``torch.cuda.CUDAGraph`` (one memory pool for all of a serve's graphs;
    a capture neither synchronizes nor empties the allocator's cache):
    one graph per table width ``w`` of a paged pool, as the reference
    retraces its paged step per width (the paged-decode launch depends on
    w), and one graph for a contiguous cache. A width's graph is captured
    at its first step and replayed at once; a capture executes nothing, so
    no step runs twice;
  * a capture that fails raises: no step falls back to eager work.

A replay skips the host code that counts kernel launches and dispatch
decisions, so the capture records them (``kernels._build.record_launches``,
``ops.dispatch.capture_decisions``) and each replay credits what its
capture recorded. The sampler stays outside the graph: its read of the
sampled tokens is the one device read a step makes.

On the CPU (``device="cpu"``, the tests) CUDA graphs do not exist: the same
runner calls the step eagerly on the same static buffers, so a stale table
or index is wrong there too. Nothing turns the graphs off on the card, as
nothing turns off the reference's ``jit``, not even a fault campaign: the
step runs inside ``ops.dispatch.traced()`` (warm-up, capture and the CPU's
eager steps; a replay dispatches nothing), where the campaign's dispatch
hook stands down as the reference's does under ``jit``, so no fault is ever
captured into a graph. A pool rebuild drops the graphs (:meth:`reset`) and
the next steps capture again.
"""

from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from repro_torch.kernels import _build
from repro_torch.ops import dispatch

# (tokens (B, 1) int64, write indices (B,) int32, tables (B, w) int32 or
# None, cache) -> the step's (B, V) f32 logits
StepForward = Callable[..., torch.Tensor]


@dataclasses.dataclass
class _Captured:
    graph: "torch.cuda.CUDAGraph"
    out: torch.Tensor  # the graph's static logits
    launches: _build.LaunchRecord
    decisions: List[dispatch.DispatchDecision]


class DecodeGraphs:
    """One serve's decode steps over ``cache`` (its pool or contiguous
    cache, updated in place) for ``batch_size`` rows. ``forward`` is the
    step function (``StepForward``); it must read its inputs only from the
    buffers it is given.

    Counters: ``warmups`` (eager warm-up steps on the card), ``replays``,
    ``eager_steps`` (steps run eagerly on the CPU), ``capture_s`` (host
    seconds of each capture), ``graphs`` (the captured keys: table widths,
    or None for a contiguous cache; since the last reset) and ``resets``
    (:meth:`reset` calls)."""

    def __init__(self, forward: StepForward, cache, batch_size: int,
                 device):
        self.forward = forward
        self.cache = cache
        self.device = torch.device(device)
        self.batch_size = batch_size
        self.tok = torch.zeros((batch_size, 1), dtype=torch.long,
                               device=self.device)
        self.idx = torch.zeros((batch_size,), dtype=torch.int32,
                               device=self.device)
        self.tables: Dict[int, torch.Tensor] = {}  # width -> (B, w) buffer
        self._fresh: set = set()  # widths whose buffer holds the tables
        self._graphs: Dict[Optional[int], _Captured] = {}
        self.on_card = self.device.type == "cuda"
        self._stream = torch.cuda.Stream(self.device) if self.on_card \
            else None
        self._pool = torch.cuda.graph_pool_handle() if self.on_card else None
        self.warmups = 0
        self.replays = 0
        self.eager_steps = 0
        self.resets = 0
        self.capture_s: List[float] = []

    @property
    def graphs(self) -> List[Optional[int]]:
        return list(self._graphs)

    # -- inputs ---------------------------------------------------------------
    def load(self, tok: np.ndarray, idx: np.ndarray,
             tables: Optional[np.ndarray] = None,
             width: Optional[int] = None) -> Optional[int]:
        """Copy one step's inputs into the static buffers: ``tok`` (B,) the
        last accepted tokens, ``idx`` (B,) the write offsets and, for a
        paged pool, the first ``width`` columns of the host ``tables``
        (copied only after :meth:`tables_changed`). Returns the step's key:
        its width, or None for a contiguous cache."""
        self.tok.copy_(torch.from_numpy(
            np.asarray(tok, dtype=np.int64).reshape(-1, 1)))
        self.idx.copy_(torch.from_numpy(np.asarray(idx, dtype=np.int32)))
        if tables is None:
            return None
        buf = self.tables.get(width)
        if buf is None:
            buf = self.tables[width] = torch.empty(
                (self.batch_size, width), dtype=torch.int32,
                device=self.device)
        if width not in self._fresh:
            buf.copy_(torch.from_numpy(np.ascontiguousarray(
                tables[:, :width], dtype=np.int32)))
            self._fresh.add(width)
        return width

    def tables_changed(self) -> None:
        """The host tables changed: every width's buffer is refilled, in
        place, at its next step."""
        self._fresh.clear()

    def reset(self, cache) -> None:
        """A new cache (the pool rebuilt): the graphs, which write the old
        one, are dropped, and the next steps capture again, into a fresh
        memory pool: dropping a pool's last graph releases the pool, and a
        capture into a released pool fails."""
        self.cache = cache
        self._graphs.clear()
        if self.on_card:
            self._pool = torch.cuda.graph_pool_handle()
        self.tables_changed()
        self.resets += 1

    # -- steps ----------------------------------------------------------------
    def _forward(self, key: Optional[int]) -> torch.Tensor:
        tables = None if key is None else self.tables[key]
        with dispatch.traced():
            return self.forward(self.tok, self.idx, tables, self.cache)

    @contextlib.contextmanager
    def _on_stream(self):
        """Run on the capture stream, ordered after and before the
        caller's stream."""
        cur = torch.cuda.current_stream(self.device)
        self._stream.wait_stream(cur)
        with torch.cuda.stream(self._stream):
            yield
        cur.wait_stream(self._stream)

    def run(self, key: Optional[int]) -> torch.Tensor:
        """One decode step on the loaded buffers: eager on the CPU; on the
        card the serve's first step eager (the warm-up), every later one a
        replay of ``key``'s graph, captured first if it is new."""
        if not self.on_card:
            self.eager_steps += 1
            return self._forward(key)
        if not self.warmups:
            self.warmups += 1
            return self.eager(key)
        if key not in self._graphs:
            self.capture(key)
        return self.replay(key)

    def eager(self, key: Optional[int]) -> torch.Tensor:
        """The step run eagerly on the card, on the capture stream; its
        launches and decisions count as they run."""
        with self._on_stream():
            return self._forward(key)

    def capture(self, key: Optional[int]) -> None:
        """Capture ``key``'s step as a CUDA graph on the runner's stream
        into the serve's memory pool. Nothing runs and nothing is counted;
        the launches and decisions the capture records are credited at
        each replay. A failed capture raises. (``torch.cuda.graph`` would
        also synchronize and empty the allocator's cache at each capture,
        so that every prefill after it allocates anew.)"""
        t0 = time.perf_counter()
        graph = torch.cuda.CUDAGraph()
        with _build.record_launches() as launches, \
                dispatch.capture_decisions() as decisions, \
                self._on_stream():
            graph.capture_begin(pool=self._pool)
            try:
                out = self._forward(key)
            except BaseException:
                with contextlib.suppress(RuntimeError):
                    graph.capture_end()  # the capture is invalid anyway
                raise
            graph.capture_end()
        self._graphs[key] = _Captured(graph, out, launches, decisions)
        self.capture_s.append(time.perf_counter() - t0)

    def replay(self, key: Optional[int]) -> torch.Tensor:
        """Replay ``key``'s graph on the caller's stream and credit its
        launches and decisions; returns its static logits."""
        cap = self._graphs[key]
        cap.graph.replay()
        cap.launches.credit()
        dispatch.credit_decisions(cap.decisions)
        self.replays += 1
        return cap.out


# ---------------------------------------------------------------------------
# The replay check: one step eagerly and replayed, on equal state.
# ---------------------------------------------------------------------------

def probe_inputs(engine, seed: int = 0) -> tuple:
    """A cache of ``engine``'s kind filled from ``seed`` on its device
    (bf16 K/V or a paged pool, int8 codes with positive scales, f32 mamba
    state) and one decode step's host inputs: ``(cache, tok, idx, tables,
    width)``, every row live at a random depth below ``max_len`` (a paged
    row's blocks distinct, past the garbage block; ``tables`` and
    ``width`` None for a contiguous cache)."""
    from repro_torch.models import transformer as T

    cfg, B, dev = engine.cfg, engine.batch_size, engine.device
    rng = np.random.default_rng(seed)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    if engine.paged:
        cache = T.init_paged_cache(cfg, engine.num_blocks, engine.block_size,
                                   quantized=engine.kv_quant, device=dev)
    else:
        cache = T.init_cache(cfg, B, engine.max_len, device=dev)
    for leaves in cache.values():
        for name, t in leaves.items():
            if t.dtype == torch.int8:
                t.copy_(torch.randint(-127, 128, t.shape, generator=gen,
                                      device=dev, dtype=torch.int8))
            elif name in ("ks", "vs"):
                t.copy_(torch.rand(t.shape, generator=gen, device=dev) / 64
                        + 1e-3)
            else:
                t.copy_(torch.randn(t.shape, generator=gen, device=dev))
    idx = rng.integers(0, engine.max_len - 1, size=B).astype(np.int32)
    tok = rng.integers(0, cfg.vocab_size, size=B).astype(np.int32)
    if not engine.paged:
        return cache, tok, idx, None, None
    bs = engine.block_size
    width = int(idx.max()) // bs + 1
    tables = np.zeros((B, -(-engine.max_len // bs)), np.int32)
    for b in range(B):
        tables[b, :width] = 1 + rng.permutation(engine.num_blocks - 1)[:width]
    return cache, tok, idx, tables, width


def _clone(cache):
    return {u: {n: t.clone() for n, t in leaves.items()}
            for u, leaves in cache.items()}


def check_replay(engine, cache, tok, idx, tables=None, width=None,
                 repeats: int = 5, profile: bool = False) -> dict:
    """One decode step of ``engine`` run eagerly and as a captured graph's
    replay, each on its own clone of ``cache`` (the card only). Each runner
    first warms its stream with an eager step on a scratch clone; the
    replay runner then captures on its compared clone. Returns whether the
    logits and every written cache leaf are equal bit for bit after that
    first step, then the times of ``repeats`` more of each (on the same,
    now advanced state): the medians of the eager step's and the replay's
    host seconds to return and of their device seconds (CUDA events), and
    the capture's host seconds. ``profile`` adds ``repeats`` replays under
    ``torch.profiler``: its kernel seconds a replay beside the CUDA events'
    seconds a replay of the same traced run."""
    import statistics

    dev = engine.device
    out, caches, times = {}, {}, {}
    for mode in ("eager", "replay"):
        run = engine.decode_graphs(_clone(cache))
        key = run.load(tok, idx, tables, width)
        run.eager(key)  # the warm-up, on the runner's stream
        run.reset(_clone(cache))
        key = run.load(tok, idx, tables, width)
        if mode == "replay":
            run.capture(key)
            out["capture_s"] = run.capture_s[-1]
        step = run.eager if mode == "eager" else run.replay
        host, device = [], []
        for i in range(1 + repeats):
            torch.cuda.synchronize(dev)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            t0 = time.perf_counter()
            logits = step(key)
            host.append(time.perf_counter() - t0)
            end.record()
            torch.cuda.synchronize(dev)
            device.append(start.elapsed_time(end) / 1e3)
            if i == 0:  # the compared step
                out[mode] = logits.clone()
                caches[mode] = _clone(run.cache)
        times[mode] = (statistics.median(host[1:]),
                       statistics.median(device[1:]))
        if profile and mode == "replay":
            acts = [torch.profiler.ProfilerActivity.CPU,
                    torch.profiler.ProfilerActivity.CUDA]
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            with torch.profiler.profile(activities=acts) as prof:
                start.record()
                for _ in range(repeats):
                    run.replay(key)
                end.record()
                torch.cuda.synchronize(dev)
            kern = [e for e in prof.events()
                    if e.device_type == torch.autograd.DeviceType.CUDA]
            out["profiled"] = {
                "profiler_kernel_s": sum(e.device_time_total for e in kern)
                / 1e6 / repeats,
                "profiler_kernels": len(kern) / repeats,
                "events_s": start.elapsed_time(end) / 1e3 / repeats}
    leaves = {f"{u}.{n}": torch.equal(t, caches["replay"][u][n])
              for u, lv in caches["eager"].items() for n, t in lv.items()}
    written = {f"{u}.{n}": not torch.equal(t, cache[u][n])
               for u, lv in caches["eager"].items() for n, t in lv.items()}
    return {"logits_equal": torch.equal(out["eager"], out["replay"]),
            "leaves_equal": all(leaves.values()),
            "unequal_leaves": [k for k, ok in leaves.items() if not ok],
            "written_leaves": sum(written.values()),
            "eager_host_s": times["eager"][0],
            "eager_device_s": times["eager"][1],
            "replay_host_s": times["replay"][0],
            "replay_device_s": times["replay"][1],
            "capture_s": out["capture_s"],
            "finite": bool(torch.isfinite(out["eager"]).all()),
            **({"profiled_replay": out["profiled"]} if profile else {})}
