"""Device time of a call on the card, with the host out of the way: the
calls captured in a CUDA graph and replayed between CUDA events. A call's
host work (30-300 us in the wrappers) is not in it, so kernels of 3-60 us
can be told apart. ``torch.profiler`` traces of such short calls have come
back with kernels missing; the graph does not lose them."""

from __future__ import annotations

import math
from typing import Callable

import torch


def calls_per_graph(fn: Callable[[], object], target_ms: float = 2.0,
                    most: int = 20) -> int:
    """How many calls of ``fn`` one graph should hold so that a replay
    lasts about ``target_ms``: a warm call timed with CUDA events (host
    work included, so short kernels get more calls), at most ``most``.
    Long calls get one, which also bounds the outputs the graph's memory
    pool keeps alive."""
    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    end.synchronize()
    return max(1, min(most, math.ceil(target_ms / max(
        start.elapsed_time(end), 1e-6))))


def graph_ms_per_call(fn: Callable[[], object], n: int = 20,
                      replays: int = 5, warmup: int = 3,
                      best: bool = False) -> float:
    """Device ms of one call of ``fn``: ``warmup`` calls on a side stream,
    then ``n`` calls captured in a CUDA graph and replayed ``replays``
    times. ``best=False``: two CUDA events around all the replays, divided
    by ``n * replays``; ``best=True``: events around each replay, the least
    divided by ``n``. Raises ``RuntimeError`` where the calls cannot be
    captured (a host sync, a pageable copy)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(warmup):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(n):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    if not best:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(replays):
            graph.replay()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / (n * replays)
    times = []
    for _ in range(replays):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return min(times) / n
