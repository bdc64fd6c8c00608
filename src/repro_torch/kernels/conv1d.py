"""Causal depthwise conv1d (the mamba short convolution): the port of
``repro.kernels.conv1d``.

7NL view: N=B, c_I=c_O=D (depthwise), h=sequence, w_F=K, h_F=1. The blocking
LP degenerates to choosing (b_B, b_D) tiles from the target's alignment; the
sequence axis streams whole per tile (K <= 8).

On a CUDA tensor, :func:`conv1d_causal` launches the hand-written kernel of
``csrc/conv1d.cu``: one CTA covers one plan batch tile and a group of plan
channel tiles (128 bytes of a time row; a wider tile is split over CTAs),
and walks time in chunks of ``CHUNK`` rows through a ``cp.async`` ring of
``STAGES`` slots in shared memory (:func:`launch_config` gives the
geometry, :func:`conv1d_ring_emulate` replays it on the CPU). On a CPU
tensor it runs :func:`conv1d_causal_plain`, the same function in plain
PyTorch, summed in the same order. There is no fallback between the two.

``conv1d_hbm_words`` is the reference's counter, unchanged: the words one
launch moves, from the launch geometry both share (``_conv1d_geometry``).
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.core.conv_model import round_up
from repro_torch.plan import H100, HardwareTarget

from ._build import MAX_THREADS, CudaKernel, check_smem, dtype_code

_c = ctypes
KERNEL = CudaKernel("conv1d.cu", "repro_conv1d_causal", [
    _c.c_void_p, _c.c_void_p, _c.c_void_p,               # x, w, out
    _c.c_int, _c.c_int, _c.c_int,                        # dtype, K, vec
    _c.c_int, _c.c_int, _c.c_int,                        # B, L, D
    _c.c_longlong, _c.c_longlong,                        # x batch/time strides
    _c.c_int, _c.c_int, _c.c_int, _c.c_int, _c.c_int,    # bB, gw, span, parts, cols
    _c.c_int, _c.c_int, _c.c_int, _c.c_int, _c.c_void_p,  # grid, threads, smem, stream
])
MAX_TAPS = 8  # K instances compiled into csrc/conv1d.cu
CHUNK = 32  # time rows of a ring stage (csrc/conv1d.cu, CHUNK)
STAGES = 8  # ring slots, STAGES - 2 chunks in flight (csrc/conv1d.cu)
SPAN_BYTES = 128  # the bytes of a time row one CTA covers


def _conv1d_geometry(x, w, tiles: Optional[Tuple[int, int]],
                     target: Optional[HardwareTarget]):
    """(bB, bD, Bp, Dp, grid) — the launch geometry :func:`conv1d_causal`
    runs, shared with the words counter. ``target`` (default ``H100``) sets
    the tiles' alignment: (min(B, sublane), min(D, lane))."""
    B, L, D = x.shape
    target = target or H100
    bB, bD = tiles or (max(1, min(B, target.align_sublane)),
                       max(1, min(D, target.align_lane)))
    Bp, Dp = round_up(B, bB), round_up(D, bD)
    return bB, bD, Bp, Dp, (Bp // bB, Dp // bD)


def conv1d_hbm_words(
    x,  # tensor (meta tensors work), (B, L, D)
    w,  # tensor, (K, D)
    tiles: Optional[Tuple[int, int]] = None,
    target: Optional[HardwareTarget] = None,
) -> float:
    """Measured HBM words (32-bit) one ``conv1d_causal`` launch moves: one
    padded input block in and one output block out per (i, j) grid step,
    plus the (K, bD) filter block — fetched once per step when the channel
    grid has > 1 column, but only once in total when nD == 1 (the
    reference's Pallas pipeline skips the re-fetch of an unchanged block).
    Shapes/dtypes only."""
    L = x.shape[1]
    K = w.shape[0]
    bB, bD, Bp, Dp, (nB, nD) = _conv1d_geometry(x, w, tiles, target)
    p_x = x.dtype.itemsize / 4.0
    p_w = w.dtype.itemsize / 4.0
    w_fetches = nB * nD if nD > 1 else 1
    return (nB * nD * bB * L * bD * p_x  # input blocks (out dtype = x dtype)
            + w_fetches * K * bD * p_w  # filter blocks
            + nB * nD * bB * L * bD * p_x)  # output stores


def conv1d_causal_plain(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The kernel's function in plain PyTorch, in the kernel's order: tap
    K-1 (the current step) first, then k = 0..K-2, each product and sum
    rounded to f32; out in x's dtype."""
    L, K = x.shape[1], w.shape[0]
    xf, wf = x.float(), w.float()
    acc = xf * wf[K - 1]
    for k in range(K - 1):
        shifted = F.pad(xf, (0, 0, K - 1 - k, 0))[:, :L]
        acc = acc + shifted * wf[k]
    return acc.to(x.dtype)


def operand_width(x: torch.Tensor) -> int:
    """Elements one copy of ``x`` may move: the widest of 16, 8 or 4 bytes
    (or one bf16) that divides D, the batch and time strides the walk steps
    by, and the base address."""
    return _width(tuple(x.shape), x.stride(), x.element_size(), x.data_ptr())


def _width(shape, strides, isz: int, base: int) -> int:
    B, L, D = shape
    steps = [D] + [strides[0]] * (B > 1) + [strides[1]] * (L > 1)
    return max(1, math.gcd(16, base, *(s * isz for s in steps)) // isz)


@functools.lru_cache(maxsize=None)  # read-only: a launch copies what it sends
def launch_config(K: int, bB: int, bD: int, grid: Tuple[int, int],
                  itemsize: int, vec: Optional[int] = None) -> dict:
    """One launch's geometry for the plan's (bB, bD) tiles and (nB, nD)
    grid, with copies of at most ``vec`` elements (default 16 bytes; see
    :func:`operand_width`).

    A CTA covers ``span`` channels: G whole plan channel tiles (as many as
    fit ``SPAN_BYTES`` of a row), or, for a wider tile, one of ``parts``
    equal parts of it. ``vec`` is cut to the widest power of two that
    divides the group's width. Threads: ``cols`` = span / vec vectors a row
    times ``rows`` rows a pass. Shared memory: the ring (STAGES x CHUNK x
    span elements) and the (K, span) f32 filter block."""
    if not 1 <= K <= MAX_TAPS:
        raise ValueError(f"conv1d_causal takes 1..{MAX_TAPS} taps, got {K}")
    nB, nD = grid
    if nB > 65535:
        raise ValueError(f"conv1d_causal: {nB} batch tiles exceed the grid's "
                         "65,535; raise the batch tile")
    vec = vec or 16 // itemsize
    width = SPAN_BYTES // itemsize
    if bD <= width:  # G whole tiles a CTA
        groups = min(nD, width // bD)
        gw = span = groups * bD
        vec = math.gcd(gw, vec)
        parts = 1
    else:  # a tile split over CTAs
        groups, gw = 1, bD
        vec = math.gcd(bD, vec)
        least_parts = -(-bD // width)
        span = round_up(-(-bD // least_parts), vec)
        parts = -(-bD // span)
    cols = span // vec
    rows = min(CHUNK, MAX_THREADS // cols)
    stage = CHUNK * span * itemsize
    smem = round_up(STAGES * stage, 16) + K * span * 4
    check_smem(smem, f"conv1d_causal ring (span {span}, K {K})")
    nbytes = vec * itemsize
    return dict(
        K=K, bB=bB, bD=bD, groups=groups, parts=parts, group_width=gw,
        span=span, vec=vec, copy_bytes=nbytes,
        copy=("cp.async.cg" if nbytes == 16 else
              "cp.async.ca" if nbytes >= 4 else "ld/st"),
        cols=cols, rows=rows, threads=rows * cols, chunk=CHUNK,
        stages=STAGES, stage_bytes=stage, smem=smem,
        grid=(-(-nD // groups) * parts, nB))


def conv1d_ring_emulate(x: torch.Tensor, w: torch.Tensor, cfg: dict):
    """The kernel's walk, replayed on CPU tensors: per CTA of ``cfg``'s
    grid, the filter block, the chunks issued into ring slots (prologue,
    then chunk i + STAGES - 2 into chunk i - 2's slot before chunk i's sum),
    the K - 1 rows before a chunk read from the previous chunk's slot, zero
    rows before t = 0, ragged B, D and L masked; slots start as NaN, so an
    output that reads a row no copy brought is NaN. Every copy and store is
    checked against its width's alignment. Returns ``(y, words)``: y as the
    kernel writes it, and the 32-bit words its copies and stores issue."""
    B, L, D = x.shape
    K = w.shape[0]
    isz = x.element_size()
    T, S, vec = cfg["chunk"], cfg["stages"], cfg["vec"]
    span, gw, parts, bB = cfg["span"], cfg["group_width"], cfg["parts"], \
        cfg["bB"]
    sxb, sxt = x.stride(0), x.stride(1)
    align = vec * isz
    y = torch.full((B, L, D), float("nan"), dtype=x.dtype)
    words = 0.0
    nch = -(-L // T)
    for by in range(cfg["grid"][1]):
        for bx in range(cfg["grid"][0]):
            grp, part = divmod(bx, parts)
            c0 = grp * gw + part * span
            cw = min(c0 + span, grp * gw + gw, D) - c0
            if cw <= 0:
                continue
            assert c0 % vec == 0 and cw % vec == 0
            b0 = by * bB
            items = min(bB, B - b0) * nch
            wk = w[:, c0:c0 + cw].float()
            words += K * cw * w.element_size() / 4
            ring = torch.full((S, T, span), float("nan"))

            def issue(it):
                b, t0 = b0 + it // nch, (it % nch) * T
                rows = min(T, L - t0)
                for r in range(rows):  # one row of vectors a time step
                    off = b * sxb + (t0 + r) * sxt + c0
                    assert (x.data_ptr() + off * isz) % align == 0
                ring[it % S, :rows, :cw] = x[b, t0:t0 + rows, c0:c0 + cw]
                return rows * cw * isz / 4

            for s in range(min(S - 2, items)):
                words += issue(s)
            for it in range(items):
                if it + S - 2 < items:
                    words += issue(it + S - 2)
                b, ch = b0 + it // nch, it % nch
                t0 = ch * T
                rows = min(T, L - t0)
                before = (ring[(it - 1) % S, T - (K - 1):] if ch > 0
                          else torch.zeros((K - 1, span)))
                win = torch.cat([before, ring[it % S]])[:, :cw]
                acc = win[K - 1:K - 1 + rows] * wk[K - 1]
                for k in range(K - 1):
                    acc = acc + win[k:k + rows] * wk[k]
                assert (((b * L + t0) * D + c0) * isz) % align == 0
                assert (D * isz) % align == 0
                y[b, t0:t0 + rows, c0:c0 + cw] = acc.to(x.dtype)
                words += rows * cw * isz / 4
    return y, words


@functools.lru_cache(maxsize=None)
def _launch_args(shape: Tuple[int, int, int], strides: Tuple[int, int, int],
                 dtype, base: int, K: int, tiles: Optional[Tuple[int, int]],
                 target: Optional[HardwareTarget]) -> tuple:
    """Everything of a launch but its pointers and stream, from what it
    depends on: x's shape, strides and dtype, its base address mod 16 and
    the taps; the grid and config of :func:`launch_config` and the C
    entry's integer arguments."""
    x = torch.empty_strided(shape, strides, dtype=dtype, device="meta")
    B, L, D = shape
    isz = x.element_size()
    bB, bD, _, _, grid = _conv1d_geometry(x, None, tiles, target)
    cfg = launch_config(K, bB, bD, grid, isz, _width(shape, strides, isz,
                                                      base))
    ints = (dtype_code(dtype), K, cfg["vec"], B, L, D, strides[0],
            strides[1], bB, cfg["group_width"], cfg["span"], cfg["parts"],
            cfg["cols"], *cfg["grid"], cfg["threads"], cfg["smem"])
    return cfg, ints


def _launch(x: torch.Tensor, w: torch.Tensor, tiles, target) -> torch.Tensor:
    for t in (x, w):
        if t.device.type != "cuda" or t.device != x.device:
            raise ValueError("conv1d_causal: x and w must lie on one CUDA "
                             f"device, got {x.device} and {w.device}")
    if x.dtype != w.dtype:
        raise TypeError(f"conv1d_causal: x is {x.dtype}, w {w.dtype}")
    if x.stride(2) != 1 or not w.is_contiguous():
        raise ValueError("conv1d_causal: x's channel axis and w must be "
                         "contiguous")
    cfg, ints = _launch_args(tuple(x.shape), x.stride(), x.dtype,
                             x.data_ptr() % 16, w.shape[0],
                             None if tiles is None else tuple(tiles), target)
    out = torch.empty(x.shape, dtype=x.dtype, device=x.device)
    if x.shape[1] == 0:
        return out
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        KERNEL.launch(x.data_ptr(), w.data_ptr(), out.data_ptr(), *ints,
                      stream, grid=cfg["grid"], block=(cfg["threads"],),
                      smem=cfg["smem"])
    return out


def conv1d_causal(
    x: torch.Tensor,  # (B, L, D)
    w: torch.Tensor,  # (K, D)
    tiles: Optional[Tuple[int, int]] = None,
    target: Optional[HardwareTarget] = None,
) -> torch.Tensor:
    """Causal depthwise conv1d, f32 accumulation, out in x's dtype.
    ``tiles`` = (bB, bD) overrides the target's (min(B, sublane),
    min(D, lane)). CUDA tensors run the kernel; CPU tensors run
    :func:`conv1d_causal_plain`."""
    if x.ndim != 3 or w.ndim != 2 or w.shape[1] != x.shape[2]:
        raise ValueError(f"x must be (B, L, D) and w (K, D), got "
                         f"{tuple(x.shape)} and {tuple(w.shape)}")
    if x.device.type == "cpu" and w.device.type == "cpu":
        return conv1d_causal_plain(x, w)
    return _launch(x, w, tiles, target)


def conv1d_program(items: int, nch: int, plain: bool):
    """``conv1d_ring_kernel``'s events for one CTA of ``items`` (batch row,
    chunk) stages of ``nch`` chunks a row: the filter block written
    before the prologue's copies and the ``__syncthreads`` after them, then
    the ``STAGES``-slot ring with ``STAGES - 2`` chunks in flight
    (``wait_group(STAGES - 3)``), each chunk also reading the previous
    chunk's slot for its K - 1 tail rows except at a batch row's first
    chunk, and a ``wait_group(0)`` at exit. ``plain`` (2-byte copies)
    writes the ring with stores in the same order."""
    from repro_torch.verify.hazards import Program

    prog = Program()
    prog.write("filter", 0, 0)
    prog.ring("ring", items, STAGES, STAGES - 2, plain=plain,
              reads_prev=lambda it: it % nch != 0, prologue_barrier=True)
    prog.read("filter", 0, 0)
    prog.wait_group(0)
    return prog


def conv1d_access_plan(
    x,  # tensor (meta tensors work), (B, L, D)
    w,  # tensor, (K, D)
    tiles: Optional[Tuple[int, int]] = None,
    target: Optional[HardwareTarget] = None,
    op: str = "conv1d_causal",
):
    """The :class:`repro_torch.verify.access.KernelAccessPlan` of one
    ``conv1d_causal`` launch (``conv1d_ring_kernel``), from
    :func:`launch_config`: the walk is the CUDA grid (batch tiles, then the
    CTAs of channel groups and parts, x fastest) with the CTA's (batch row,
    chunk) stages innermost. A stage copies and stores its real rows and
    channels; the filter block once a CTA (counted once a launch when nD
    == 1, as the counter charges it; the other batch tiles' reads are
    uncounted); skipped: the padding of ragged B and D tiles, which the
    counter charges and the kernel never reads. A real ``x`` gives the copy
    width (:func:`operand_width`); a meta one the 16-byte copies."""
    import numpy as np

    from repro_torch.verify.access import (CudaLaunch, FlatAccess,
                                           KernelAccessPlan, ScratchAlloc,
                                           WindowAccess)

    B, L, D = x.shape
    K = w.shape[0]
    bB, bD, Bp, Dp, (nB, nD) = _conv1d_geometry(x, w, tiles, target)
    isz = x.dtype.itemsize
    vec = None if x.device.type == "meta" else operand_width(x)
    cfg = launch_config(K, bB, bD, (nB, nD), isz, vec)
    p_x, p_w = isz / 4.0, w.dtype.itemsize / 4.0
    gx = cfg["grid"][0]
    nch = -(-L // CHUNK)
    walk = (nB, gx, bB * nch)
    span, gw, parts = cfg["span"], cfg["group_width"], cfg["parts"]

    def chans(bx):  # the CTA's first channel and real channels
        grp, part = bx // parts, bx % parts
        c0 = grp * gw + part * span
        return c0, np.maximum(0, np.minimum(np.minimum(c0 + span,
                                                       grp * gw + gw), D)
                              - c0)

    def window(by, bx, it):
        c0, cw = chans(bx)
        b = by * bB + it // nch
        t0 = it % nch * CHUNK
        rows = np.where(b < B, np.minimum(CHUNK, L - t0), 0)
        return (np.minimum(b, B - 1), 1), (t0, rows), (c0, cw)

    def filt(first):
        def win(by, bx, it):
            c0, cw = chans(bx)
            mine = (it == 0) & (((by == 0) == first) if nD == 1 else first)
            return (0, np.where(mine, K, 0)), (c0, cw)
        return win

    accesses = [
        WindowAccess(name="x", kind="load", array_shape=(B, L, D),
                     word_size=p_x, window=window),
        WindowAccess(name="w", kind="load", array_shape=(K, D),
                     word_size=p_w, window=filt(True)),
        WindowAccess(name="out", kind="store", array_shape=(B, L, D),
                     word_size=p_x, window=window),
    ]
    if nD == 1 and nB > 1:
        accesses.append(WindowAccess(
            name="w (per-CTA fetches)", kind="load", array_shape=(K, D),
            word_size=p_w, window=filt(False), counted=False,
            note="every batch tile's CTAs read the filter block again"))
    pad = nB * nD * bB * L * bD - B * L * D
    w_pad = (nB * nD if nD > 1 else 1) * K * bD - (nB if nD > 1 else 1) * K * D
    skipped = ()
    if pad or w_pad:
        skipped = (FlatAccess(name="ragged B and D padding", kind="load",
                              words=2 * pad * p_x + w_pad * p_w),)
    ring = round_up(STAGES * cfg["stage_bytes"], 16)
    scratch = (ScratchAlloc(f"ring[{STAGES}]", ring / 4.0),
               ScratchAlloc("filter (f32)", (cfg["smem"] - ring) / 4.0))
    counts = sorted({min(bB, B - by * bB) * nch for by in range(nB)})
    plain = cfg["copy_bytes"] < 4
    dma = tuple(s for n in counts for s in conv1d_program(
        n, nch, plain).schedules({"ring": STAGES, "filter": 1},
                                 cfg["threads"] // 32, f"{op} ({n} stages)"))
    return KernelAccessPlan(
        op=op, grid=walk, accesses=tuple(accesses), scratch=scratch,
        dma=dma, skipped=skipped,
        launch=CudaLaunch("conv1d_ring_kernel", (gx, nB, 1),
                          (cfg["threads"], 1, 1), cfg["smem"]),
        note="(batch row, chunk) stages innermost")
