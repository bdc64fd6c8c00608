"""Quantized (int8-stream) conv2d / matmul: the port of
``repro.kernels.quant``.

Same LP-tiled launch geometry as ``kernels/conv2d.py`` / ``kernels/matmul.py``
(the geometry helpers are imported, not restated), but the input and filter
stream from HBM as int8 — a quarter word per element — so the blocking LP,
solving against ``Precision(0.25, 0.25, p_out)``, buys bigger tiles from the
same fast memory and the Thm 2.1 bound itself drops (see
``core.bounds.mixed_precision_bound``). The folded per-output-channel scale
— one f32 vector, quantization's whole dequantization state — is applied
once at the store:

    out[n, co, h, w] = (sum_taps int8 dot) * scale[co]  ->  out_dtype

``scale`` is ``s_x * s_w[c_O]`` (``repro_torch.quant.quantize_conv_operands``),
a ``(1, c_O)`` f32 operand. The counters charge it c_O words, once per
launch, as the reference does.

On a CUDA tensor, :func:`conv2d_q` / :func:`matmul_q` launch the hand-written
kernels of ``csrc/quant.cu`` (int32 accumulators in registers, up to 512
threads a CTA), both on the int8 tensor cores (``mma.sync`` m16n8k32 s8):
the conv as an implicit GEMM, A gathered from the halo window in shared
memory through ``conv2d``'s ``gather_table`` and ``row_offsets``, B by
``ldmatrix`` from the OIHW filter rows, a two-slot ``cp.async`` ring over
c_I (see :func:`conv_launch_config` and :func:`conv2d_q_tc_emulate`, its
model); the GEMM fed by ``ldmatrix`` from a ``cp.async`` ring, B transposed
k-major in shared memory (see :func:`matmul_launch_config` and
:func:`matmul_q_tc_emulate`). On a CPU tensor they run
:func:`conv2d_q_plain` / :func:`matmul_q_plain`, the same functions in plain
PyTorch. There is no fallback between the two.

Output storage defaults to bf16 (half a word): int8-in/bf16-out is the policy
``repro_torch.quant.INT8_SPEC`` names, and it is what moves measured conv
words well below the bf16-in/f32-out baseline on the ResNet-50 shapes.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.conv_model import Precision, round_up
from repro_torch.plan import ConvSpec, ExecutionPlan, HardwareTarget, MatmulSpec
from repro_torch.plan.planner import resolve_kernel_plan

from ._build import (ACC_PER_THREAD, MAX_SMEM_BYTES, MAX_THREADS_Q,
                     CudaKernel, check_cuda_operands, check_smem, dtype_code)
from .conv2d import (_gather_table_on, _launch_geometry, _normalize_tiles,
                     conv_access_plan, gather_table, row_offsets,
                     window_layout)
from .matmul import gemm_access_plan, vector_width, warp_layout, warp_tiles

_c = ctypes
CONV_KERNEL = CudaKernel("quant.cu", "repro_conv2d_q", [
    _c.c_void_p, _c.c_void_p, _c.c_void_p,              # x, w, koff
    _c.c_void_p, _c.c_void_p,                           # scale, out
    _c.c_int, _c.c_int,                                  # out dtype, variant
    _c.POINTER(_c.c_longlong), _c.c_int,                 # geometry, its length
    _c.c_int, _c.c_int, _c.c_void_p,                     # threads, smem, stream
])
MATMUL_KERNEL = CudaKernel("quant.cu", "repro_matmul_q", [
    _c.c_void_p, _c.c_void_p, _c.c_void_p, _c.c_void_p,  # a, b, scale, out
    _c.c_int, _c.c_int,                                  # out dtype, variant
    _c.POINTER(_c.c_longlong), _c.c_int,                 # geometry, its length
    _c.c_int, _c.c_int, _c.c_void_p,                     # threads, smem, stream
])
# The launch geometry matmul_q's C entry takes, in csrc/quant.cu's
# MMQParams order.
GEOMETRY = ("m", "n", "k", "bm", "bn", "cbm", "cbn", "sm", "sn", "nMT", "nNT",
            "n_spans", "ldo", "wn", "cn", "rows", "bt", "ks", "lda", "ldbs",
            "ldbt", "vwa", "vwb", "off_bs", "off_bt", "off_sc")
# The launch geometry conv2d_q's C entry takes, in csrc/quant.cu's
# ConvQParams order (b_cI and nCI: a ring stage's channels and the stages).
CONV_GEOMETRY = ("N", "c_I", "H", "W", "c_O", "h_F", "w_F", "sh", "sw",
                 "bN", "b_cI", "b_cO", "bh", "bw", "h_in", "w_in",
                 "cOp", "hOp", "wOp", "nN", "nCO", "nH", "nW", "nCI",
                 "n32", "ldb", "slots", "wn", "cn", "rows", "zc",
                 "off_koff", "off_rows", "off_ring", "x_bytes", "slot_bytes",
                 "run", "vwb", "b_run", "vst", "lds", "d_row", "d_ch",
                 "d_img", "zero")
# Both int8 kernels' warp blocks of (MI, NI) m16n8 tiles, in csrc/quant.cu's
# mm_launch_v / conv_launch_v order: (2, 8) is a 32 x 64 warp tile (64 int32
# accumulators a thread): matmul_q's (128, 256) plan as a 4 x 4 grid of 16
# warps and (256, 128) as 8 x 2, conv2d_q's 448-512 x 64 tiles as 14-16 x 1;
# variant LINEAR gives each warp 16 tiles in row-major order of the covered
# tile, for a tile (1024 x 32) that no (2, 8) grid of 16 warps covers
TC_VARIANTS = ((2, 8),)
LINEAR = len(TC_VARIANTS)
CONV_RUN = 16  # int8 elements a window copy moves: 16 bytes aligned in x
CONV_K = 32  # the k of an s8 MMA: a ring stage's K pads to it
TC_SPANS = (128, 64, 32)  # a ring stage's k-span: the first that fits
RING = (3, 2, 2)  # stages of A, of B and of B^T
PAD = 16  # bytes past a stage row: pitches an odd multiple of 16 bytes


def _wordwidth(dtype) -> float:
    return dtype.itemsize / 4.0


def _conv_spec_q(N: int, c_I: int, c_O: int, h_O: int, w_O: int, h_F: int,
                 w_F: int, sh: int, sw: int, x_dtype, w_dtype,
                 out_dtype) -> ConvSpec:
    """Per-operand mixed-precision ConvSpec: the LP and the Thm 2.1 bound
    both see the stored widths (int8 = 0.25 words), unlike ``_conv_spec``
    which pins p_O to one full word."""
    return ConvSpec(N=N, c_I=c_I, c_O=c_O, w_O=w_O, h_O=h_O, w_F=w_F,
                    h_F=h_F, sw=sw, sh=sh,
                    prec=Precision(_wordwidth(x_dtype), _wordwidth(w_dtype),
                                   _wordwidth(out_dtype)))


def _matmul_spec_q(m: int, n: int, k: int, a_dtype, b_dtype,
                   out_dtype) -> MatmulSpec:
    return MatmulSpec(m=m, n=n, k=k,
                      prec=Precision(_wordwidth(a_dtype),
                                     _wordwidth(b_dtype),
                                     _wordwidth(out_dtype)))


def _check_int8(op: str, *tensors) -> None:
    for t in tensors:
        if t.dtype != torch.int8:
            raise TypeError(f"{op} takes int8 operands, got {t.dtype}")


def _check_scale(op: str, scale: torch.Tensor, like: torch.Tensor) -> None:
    """The f32 scale goes to C beside the int8 operands: on their device,
    contiguous."""
    check_cuda_operands(op, scale)
    if scale.device != like.device:
        raise ValueError(f"{op}: the scale lies on {scale.device}, the "
                         f"operands on {like.device}")


# ---------------------------------------------------------------------------
# conv2d_q
# ---------------------------------------------------------------------------

def conv2d_q_plain(x: torch.Tensor, w: torch.Tensor, scale: torch.Tensor,
                   stride: Tuple[int, int] = (1, 1),
                   out_dtype=torch.bfloat16) -> torch.Tensor:
    """The kernel's function in plain PyTorch: the int8 operands widened to
    float64 (every sum is exact), tap by tap as strided-slice matmuls, the
    sum cast to f32, times the f32 scale in f32, cast to ``out_dtype``."""
    N, c_I, H, W = x.shape
    c_O, _, h_F, w_F = w.shape
    sh, sw = stride
    h_O = (H - h_F) // sh + 1
    w_O = (W - w_F) // sw + 1
    xd = x.double().permute(0, 2, 3, 1)  # (N, H, W, c_I)
    wd = w.double()
    acc = torch.zeros((N, h_O, w_O, c_O), dtype=torch.float64,
                      device=x.device)
    for hf in range(h_F):
        for wf in range(w_F):
            tap = xd[:, hf:hf + (h_O - 1) * sh + 1:sh,
                     wf:wf + (w_O - 1) * sw + 1:sw, :]
            acc += torch.matmul(tap, wd[:, :, hf, wf].t())
    out = acc.float() * scale.float().reshape(1, 1, 1, c_O)
    return out.permute(0, 3, 1, 2).to(out_dtype)


@functools.lru_cache(maxsize=None)  # read-only: a launch copies what it sends
def conv_launch_config(tiles: Tuple[int, int, int, int, int], h_F: int,
                       w_F: int, h_in: int, w_in: int,
                       c_I: Optional[int] = None,
                       hw: Optional[Tuple[int, int]] = None) -> dict:
    """``conv2d_q_tc_kernel``'s launch configuration for int8 tiles: the warp
    layout of the (bN * bh * bw) x b_cO accumulator tile (up to 16 warps of
    64 int32 accumulators; LINEAR where no (2, 8) grid covers it), a ring
    stage's channels ``cs`` (two plan c_I blocks, halved until the ring
    fits a block's shared memory) and its k (``ks``, ``n32`` slices of 32,
    a zero plane ``zc`` for the padded k), the stages ``n_st`` over ``c_I``
    and the slots, the window's layout for an input of ``hw`` = (H, W)
    (``conv2d.window_layout`` with 16-byte int8 runs, and the slack
    ``ch_pad`` between channel planes that gives the A gather the fewest
    bank conflicts, :func:`gather_conflicts`, within shared memory), the
    shared-memory offsets (the scale slice, the gather table, the row
    table, the ring; the epilogue's staged tile, ``lds`` floats a channel,
    follows the scale slice), the pixels an epilogue store moves (``vst``)
    and the threads. ``c_I=None`` sizes the ring for many stages,
    ``hw=None`` takes whole-plane windows. Raises ValueError for a tile of
    more accumulators than 16 warps hold (a plan for another target)."""
    bN, b_cI, b_cO, bh, bw = tiles
    lay = warp_layout(bN * bh * bw, b_cO, TC_VARIANTS,
                      max_threads=MAX_THREADS_Q)
    taps = h_F * w_F
    H, W = hw or (h_in, w_in)
    whole = h_in == H and w_in == W  # a whole-plane window: one run an image
    cs = 2 * b_cI if c_I is None else min(2 * b_cI, c_I)
    sc_bytes = round_up(4 * b_cO, 16)
    lds = lay["rows"] + 4  # 4 mod 16 words: conflict-free fragment writes

    def layout(cs: int, ch_pad: int) -> dict:
        ks = cs * taps
        n32 = -(-ks // CONV_K)
        zc = ks % CONV_K != 0  # a zero plane for the padded k
        n_st = 2 if c_I is None else -(-c_I // cs)
        win = window_layout(tiles, cs, zc, h_in, w_in, c_I or cs, H, W,
                            run=CONV_RUN, ch_pad=ch_pad)
        ldb = n32 * CONV_K + PAD  # an odd multiple of 16 bytes
        x_bytes = round_up(win["x_elems"], 16)
        slot_bytes = x_bytes + lay["cols"] * ldb
        koff_bytes = n32 * CONV_K * 4
        rows_bytes = round_up(8 * bN * (1 if whole else cs * h_in), 16)
        off_ring = sc_bytes + koff_bytes + rows_bytes
        slots = min(2, n_st)
        smem = max(off_ring + slots * slot_bytes, sc_bytes + b_cO * lds * 4)
        return dict(kernel="tensor core", **lay,
                    threads=lay["wm"] * lay["wn"] * 32, cs=cs, n_st=n_st,
                    ks=ks, n32=n32, zc=int(zc), ldb=ldb, slots=slots, **win,
                    ch_pad=ch_pad, x_bytes=x_bytes, slot_bytes=slot_bytes,
                    off_koff=sc_bytes, off_rows=sc_bytes + koff_bytes,
                    off_ring=off_ring, vst=4 if bw % 4 == 0 else 1, lds=lds,
                    smem=smem, acc_per_thread=lay["mi"] * lay["ni"] * 4)

    cfg = layout(cs, 0)
    while cfg["smem"] > MAX_SMEM_BYTES and cs > 1:
        cs = -(-cs // 2)
        cfg = layout(cs, 0)
    check_smem(cfg["smem"], f"conv2d_q tiles {tiles}")
    if not whole:
        # 16 more bytes between channel planes move their banks: the pad
        # (of 8, the bank pattern's period) whose gather conflicts least,
        # the smallest of equals, within shared memory; the stride is
        # (window - filter) / (tile - 1) (any where the tile is 1 wide)
        stride = tuple((n - f) // (b - 1) if b > 1 else 1
                       for n, f, b in ((h_in, h_F, bh), (w_in, w_F, bw)))
        fits = [c for c in (layout(cs, pad)
                            for pad in range(0, 8 * CONV_RUN, CONV_RUN))
                if c["smem"] <= MAX_SMEM_BYTES]
        cfg = min(fits, key=lambda c: gather_conflicts(c, tiles, stride,
                                                       h_F, w_F))
    return cfg


def gather_conflicts(cfg: dict, tiles, stride, h_F: int, w_F: int) -> float:
    """The mean bank-conflict degree of ``conv2d_q_tc_kernel``'s A gather
    under launch configuration ``cfg``: for each byte load of a warp (lane
    (g, t) = (lane / 4, lane % 4) of an m16 tile reads row g, + 8 in A
    registers 1 and 3, at k = 32 kk + 4 t, + 16 in registers 2 and 3, +
    the byte), the most distinct 32-bit words one bank serves (1:
    conflict-free), averaged over the tile's m16 tiles, the k32 slices and
    the window origin's offset mod 4 (a whole word's shift moves every
    bank alike)."""
    koff = np.array(gather_table(cfg["cs"], h_F, w_F, cfg["d_row"],
                                 cfg["d_ch"], cfg["zero"], CONV_K))
    moff = np.array(row_offsets(cfg["rows"], tiles, stride, cfg["d_img"],
                                cfg["d_row"]))
    lane, e = np.arange(32), np.arange(4)[:, None]
    rows = (16 * np.arange(cfg["rows"] // 16)[:, None, None]
            + (lane >> 2) + 8 * (e & 1))                    # (m16, e, lane)
    ks = (32 * np.arange(cfg["n32"])[:, None, None, None]
          + (4 * (lane & 3) + 16 * (e >> 1))[:, None, :]
          + np.arange(4)[:, None])                         # (kk, e, b, lane)
    addr = (np.arange(4)[:, None, None, None, None, None]
            + moff[rows][None, :, None, :, None, :]
            + koff[ks][None, None])
    words = np.sort((addr // 4).reshape(-1, 32), axis=1)
    new = np.ones(words.shape, bool)  # a word's first lane
    new[:, 1:] = words[:, 1:] != words[:, :-1]
    load = np.arange(len(words))[:, None].repeat(32, axis=1)
    per_bank = np.bincount((32 * load + words % 32)[new],
                           minlength=words.size).reshape(-1, 32)
    return float(per_bank.max(1).mean())


def _conv_launch(x, w, scale, stride, out_dtype,
                 t: Tuple[int, int, int, int, int]) -> torch.Tensor:
    check_cuda_operands("conv2d_q", x, w)
    _check_scale("conv2d_q", scale, x)
    N, c_I, H, W = x.shape
    c_O, _, h_F, w_F = w.shape
    sh, sw = stride
    h_O = (H - h_F) // sh + 1
    w_O = (W - w_F) // sw + 1
    bN, _, b_cO, bh, bw = t
    (Np, _, cOp, hOp, wOp, _, _, h_in, w_in,
     grid) = _launch_geometry(N, c_I, c_O, H, W, h_F, w_F, sh, sw, t)
    cfg = conv_launch_config(t, h_F, w_F, h_in, w_in, c_I, (H, W))
    if bN * c_I * H * W >= 2 ** 31:  # the row table's offsets are int32
        raise ValueError(f"conv2d_q tiles {t}: {bN} images of {c_I} x {H} "
                         f"x {W} exceed 32-bit window offsets")
    if x.data_ptr() % 16:
        # the window copies move 16-byte runs aligned in x: realign an input
        # whose base is not (a slice), with one copy
        x = x.clone()
    cs, taps = cfg["cs"], h_F * w_F
    koff = _gather_table_on(x.device, cs, h_F, w_F, cfg["d_row"],
                            cfg["d_ch"], cfg["zero"], CONV_K)
    out = torch.empty((Np, cOp, hOp, wOp), dtype=out_dtype, device=x.device)
    g = dict(cfg, N=N, c_I=c_I, H=H, W=W, c_O=c_O, h_F=h_F, w_F=w_F, sh=sh,
             sw=sw, bN=bN, b_cI=cs, b_cO=b_cO, bh=bh, bw=bw, h_in=h_in,
             w_in=w_in, cOp=cOp, hOp=hOp, wOp=wOp, nN=grid[0], nCO=grid[1],
             nH=grid[2], nW=grid[3], nCI=cfg["n_st"], cn=cfg["cols"] // 8,
             run=int(h_in == H and w_in == W),
             vwb=vector_width(c_I * taps, cs * taps, ptrs=(w.data_ptr(),),
                              itemsize=1),
             b_run=int(cs == c_I))
    geometry = (ctypes.c_longlong * len(CONV_GEOMETRY))(
        *(g[k] for k in CONV_GEOMETRY))
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        CONV_KERNEL.launch(
            x.data_ptr(), w.data_ptr(), koff.data_ptr(), scale.data_ptr(),
            out.data_ptr(), dtype_code(out_dtype), cfg["variant"], geometry,
            len(CONV_GEOMETRY), cfg["threads"], cfg["smem"], stream,
            tensor_core=True, grid=(math.prod(grid[:4]),),
            block=(cfg["threads"],), smem=cfg["smem"])
    return out[:N, :c_O, :h_O, :w_O]


def conv2d_q_tc_emulate(x: torch.Tensor, w: torch.Tensor,
                        scale: torch.Tensor, stride=(1, 1),
                        tiles: Optional[Sequence[int]] = None,
                        out_dtype=torch.bfloat16) -> torch.Tensor:
    """A plain model of ``conv2d_q_tc_kernel``'s walk on the CPU, in integer
    arithmetic (for the tests; nothing on the main path calls it): per
    output tile and ring stage of ``cs`` channels, the window staged as the
    kernel stages it (NCHW at :func:`conv_launch_config`'s int8 pitches,
    from the unaligned origin ``16 + (the stage's input offset mod 16)``,
    zero past the input, the zero plane zeroed, every other slot byte a
    sentinel that no product may read), the filter block as [co][k] rows
    zero-padded to 32 k, A gathered through the wrapper's gather table and
    the kernel's row offsets, the k32 slices that hold real k multiplied
    into the m16n8 tiles each warp owns; then the epilogue: int32 -> f32,
    times the f32 scale, cast to ``out_dtype``."""
    N, c_I, H, W = x.shape
    c_O, _, h_F, w_F = w.shape
    sh, sw = stride
    h_O, w_O = (H - h_F) // sh + 1, (W - w_F) // sw + 1
    if tiles is None:
        tiles = resolve_kernel_plan(
            _conv_spec_q(N, c_I, c_O, h_O, w_O, h_F, w_F, sh, sw, x.dtype,
                         w.dtype, out_dtype))
    tiles = _normalize_tiles(tiles, h_O, w_O)
    bN, _, b_cO, bh, bw = tiles
    (Np, _, cOp, hOp, wOp, Hp, Wp, h_in, w_in,
     _) = _launch_geometry(N, c_I, c_O, H, W, h_F, w_F, sh, sw, tiles)
    cfg = conv_launch_config(tiles, h_F, w_F, h_in, w_in, c_I, (H, W))
    g, cs, ks, n32 = CONV_RUN, cfg["cs"], cfg["ks"], cfg["n32"]
    d_row, d_ch, d_img = cfg["d_row"], cfg["d_ch"], cfg["d_img"]
    koff = np.array(gather_table(cs, h_F, w_F, d_row, d_ch, cfg["zero"],
                                 CONV_K))
    moff = np.array(row_offsets(cfg["rows"], tiles, stride, d_img, d_row))
    assert len(koff) == n32 * CONV_K
    owned = [t for wp in range(cfg["wm"] * cfg["wn"])
             for t in warp_tiles(cfg, wp)]
    sentinel = 1 << 20  # no int8 value: a product that reads it shows
    xp = np.zeros((Np, cfg["n_st"] * cs, Hp, Wp), np.int64)
    xp[:N, :c_I, :H, :W] = x.numpy()
    wk = np.zeros((cOp, cfg["n_st"] * cs, h_F * w_F), np.int64)
    wk[:c_O, :c_I] = w.numpy().reshape(c_O, c_I, -1)
    sc = np.zeros(cOp, np.float32)
    sc[:c_O] = scale.float().numpy().reshape(-1)
    out = np.zeros((Np, cOp, hOp, wOp), np.float32)
    M = bN * bh * bw
    for n0 in range(0, Np, bN):
        for co0 in range(0, cOp, b_cO):
            for r0 in range(0, hOp, bh):
                for c0 in range(0, wOp, bw):
                    x0 = (n0 * c_I * H + r0 * sh) * W + c0 * sw  # in x
                    acc = np.zeros((cfg["rows"], cfg["cols"]), np.int64)
                    for ci0 in range(0, cfg["n_st"] * cs, cs):
                        slot = np.full(cfg["x_elems"], sentinel, np.int64)
                        if cfg["zc"]:  # as the kernel zeroes it, per image
                            for n in range(bN):
                                z = n * d_img + cfg["zero"] + g
                                slot[z:z + d_ch + g] = 0
                        origin = g + (x0 + ci0 * H * W) % g
                        np.lib.stride_tricks.as_strided(
                            slot[origin:], (bN, cs, h_in, w_in),
                            [8 * v for v in (d_img, d_ch, d_row, 1)],
                            writeable=True)[:] = xp[
                                n0:n0 + bN, ci0:ci0 + cs,
                                r0 * sh:r0 * sh + h_in,
                                c0 * sw:c0 * sw + w_in]
                        b = np.zeros((cfg["cols"], n32 * CONV_K), np.int64)
                        b[:b_cO, :ks] = wk[co0:co0 + b_cO,
                                           ci0:ci0 + cs].reshape(b_cO, -1)
                        a = slot[origin:][moff[:, None] + koff[None, :]]
                        assert (np.abs(a) < 128).all()  # no slack is read
                        assert not a[:, ks:].any()  # the zero plane
                        # the k32 slices that hold real k (a ragged last
                        # stage's), int8 products summed in float64: exact
                        kc = min(n32, -(-(c_I - ci0) * h_F * w_F
                                        // CONV_K)) * CONV_K
                        prod = (a[:, :kc].astype(np.float64)
                                @ b[:, :kc].astype(np.float64).T
                                ).astype(np.int64)
                        for mt, nt in owned:
                            blk = (slice(16 * mt, 16 * mt + 16),
                                   slice(8 * nt, 8 * nt + 8))
                            acc[blk] += prod[blk]
                    assert np.abs(acc).max(initial=0) < 2 ** 31  # int32
                    y = acc[:M, :b_cO].astype(np.float32) * sc[co0:co0
                                                               + b_cO]
                    out[n0:n0 + bN, co0:co0 + b_cO, r0:r0 + bh,
                        c0:c0 + bw] = y.reshape(bN, bh, bw,
                                                b_cO).transpose(0, 3, 1, 2)
    return torch.from_numpy(out).to(out_dtype)[:N, :c_O, :h_O, :w_O]


def conv2d_q(
    x: torch.Tensor,  # (N, c_I, H, W) int8
    w: torch.Tensor,  # (c_O, c_I, h_F, w_F) int8
    scale: torch.Tensor,  # (1, c_O) f32: folded s_x * s_w[c_O]
    stride: Tuple[int, int] = (1, 1),
    out_dtype=torch.bfloat16,
    ctx=None,  # ExecutionContext (duck-typed: .target/.autotune)
    tiles: Optional[Sequence[int]] = None,
    plan: Optional[ExecutionPlan] = None,
) -> torch.Tensor:
    """Quantized direct convolution (VALID padding): int8 operand streams,
    int32 accumulation, one folded per-output-channel scale applied at the
    store. Operands come from
    ``repro_torch.quant.quantize_conv_operands``. CUDA tensors run the
    kernel; CPU tensors run :func:`conv2d_q_plain`."""
    N, c_I, H, W = x.shape
    c_O, c_I2, h_F, w_F = w.shape
    if c_I != c_I2:
        raise ValueError(f"input has {c_I} channels, filter {c_I2}")
    if tuple(scale.shape) != (1, c_O):
        raise ValueError(f"scale must be (1, {c_O}), got "
                         f"{tuple(scale.shape)}")
    _check_int8("conv2d_q", x, w)
    sh, sw = stride
    h_O = (H - h_F) // sh + 1
    w_O = (W - w_F) // sw + 1
    t = resolve_kernel_plan(
        _conv_spec_q(N, c_I, c_O, h_O, w_O, h_F, w_F, sh, sw, x.dtype,
                     w.dtype, out_dtype),
        plan=plan, tiles=tiles, ctx=ctx)
    t = _normalize_tiles(t, h_O, w_O)
    if x.device.type == "cpu" and w.device.type == "cpu":
        return conv2d_q_plain(x, w, scale, (sh, sw), out_dtype)
    return _conv_launch(x, w, scale.float().contiguous(), (sh, sw),
                        out_dtype, t)


def conv2d_q_hbm_words(
    x,  # tensor (meta tensors work), (N, c_I, H, W) int8
    w,  # tensor, (c_O, c_I, h_F, w_F) int8
    scale=None,  # unused beyond its c_O words; keeps the spec_args signature
    stride: Tuple[int, int] = (1, 1),
    tiles: Optional[Sequence[int]] = None,
    plan: Optional[ExecutionPlan] = None,
    target: Optional[HardwareTarget] = None,
    out_dtype=torch.bfloat16,
) -> float:
    """Measured HBM words of one ``conv2d_q`` dispatch: int8 input/filter
    windows per grid step, the padded out_dtype stores, plus the scale
    vector exactly once (c_O f32 words)."""
    N, c_I, H, W = x.shape
    c_O, _, h_F, w_F = w.shape
    sh, sw = stride
    h_O = (H - h_F) // sh + 1
    w_O = (W - w_F) // sw + 1
    t = resolve_kernel_plan(
        _conv_spec_q(N, c_I, c_O, h_O, w_O, h_F, w_F, sh, sw, x.dtype,
                     w.dtype, out_dtype),
        plan=plan, target=target, tiles=tiles)
    t = _normalize_tiles(t, h_O, w_O)
    bN, b_cI, b_cO, bh, bw = t
    (Np, cIp, cOp, hOp, wOp, _, _, h_in, w_in,
     grid) = _launch_geometry(N, c_I, c_O, H, W, h_F, w_F, sh, sw, t)
    n_steps = math.prod(grid)
    p_in = _wordwidth(x.dtype)
    p_flt = _wordwidth(w.dtype)
    p_out = _wordwidth(out_dtype)
    return (n_steps * bN * b_cI * h_in * w_in * p_in
            + n_steps * b_cO * b_cI * h_F * w_F * p_flt
            + Np * cOp * hOp * wOp * p_out
            + cOp * 1.0)


# ---------------------------------------------------------------------------
# matmul_q
# ---------------------------------------------------------------------------

def matmul_q_plain(a: torch.Tensor, b: torch.Tensor, scale: torch.Tensor,
                   out_dtype=torch.bfloat16) -> torch.Tensor:
    """The kernel's function in plain PyTorch: a float64 matmul of the
    widened int8 operands (exact), cast to f32, times the f32 scale in f32,
    cast to ``out_dtype``."""
    acc = torch.matmul(a.double(), b.double())
    return (acc.float() * scale.float().reshape(1, -1)).to(out_dtype)


def matmul_launch_config(bm: int, bn: int, bk: int,
                         k: Optional[int] = None) -> dict:
    """``matmul_q_tc_kernel``'s launch configuration for int8 tiles (bm, bn,
    bk). A CTA computes the plan's (bm, bn) tile, or, where 16 warps or a
    block's shared memory cannot hold it, an equal share of it (``cbm`` x
    ``cbn``; ``sm`` x ``sn`` CTAs a tile, cut along its longer side, as few
    as fit). Then: the warp layout of the CTA's tile (variant, warp grid,
    covered rows x cols; up to 16 warps x 64 int32 accumulators), the
    columns of B staged and transposed (``bt``, the covered columns rounded
    up to 32), the ring (k-span ``ks``, a multiple of 32 and never less than
    bk rounded up to 32; ``RING`` stages of A, B and B^T), the shared-memory
    pitches (bytes; rows of ks + 16 and bt + 16, odd multiples of 16) and
    offsets, then the CTA's scale slice. ``k=None`` sizes the ring for a
    long k; with k given, only the stages its spans use are allocated.
    Raises ValueError for a tile of more accumulators than one CTA's
    registers hold (a plan for another target), or one no ring fits."""
    if bm * bn > MAX_THREADS_Q * ACC_PER_THREAD:
        raise ValueError(
            f"a {bm} x {bn} accumulator tile does not fit one CTA's "
            f"{MAX_THREADS_Q} x {ACC_PER_THREAD} registers; plan for the "
            "H100 target")
    least = round_up(bk, 32)  # a stage holds a plan k-step at least
    spans = [ks for ks in TC_SPANS if ks >= least] or [least]
    along_n = round_up(bn, 32) >= round_up(bm, 16)
    ext, unit = (bn, 32) if along_n else (bm, 16)
    smem, last = None, None
    for parts in range(1, -(-ext // unit) + 1):
        sub = min(ext, round_up(-(-ext // parts), unit))
        if sub == last:
            continue
        last = sub
        cbm, cbn = (bm, sub) if along_n else (sub, bn)
        try:
            lay = warp_layout(cbm, cbn, TC_VARIANTS, max_threads=MAX_THREADS_Q)
        except ValueError:  # more m16n8 tiles than 16 warps hold
            continue
        rows, bt = lay["rows"], round_up(lay["cols"], 32)
        for ks in spans:
            n_spans = None if k is None else -(-k // ks)
            stages = RING if k is None else tuple(min(c, n_spans)
                                                  for c in RING)
            lda = ldbt = ks + PAD
            ldbs = bt + PAD
            off_bs = stages[0] * rows * lda
            off_bt = off_bs + stages[1] * ks * ldbs
            off_sc = off_bt + stages[2] * bt * ldbt
            smem = off_sc + 4 * cbn
            if smem <= MAX_SMEM_BYTES:
                return dict(kernel="tensor core", **lay,
                            threads=lay["wm"] * lay["wn"] * 32, cbm=cbm,
                            cbn=cbn, sm=-(-bm // cbm), sn=-(-bn // cbn),
                            bt=bt, ks=ks, n_spans=n_spans, lda=lda,
                            ldbs=ldbs, ldbt=ldbt, off_bs=off_bs,
                            off_bt=off_bt, off_sc=off_sc, smem=smem,
                            acc_per_thread=lay["mi"] * lay["ni"] * 4)
    raise ValueError(
        f"matmul_q tiles {(bm, bn, bk)} need {smem} bytes of shared memory "
        f"at the least, more than a block's {MAX_SMEM_BYTES}; plan for the "
        "H100 target")


def _matmul_launch(a, b, scale, out_dtype,
                   tiles: Tuple[int, int, int]) -> torch.Tensor:
    check_cuda_operands("matmul_q", a, b)
    _check_scale("matmul_q", scale, a)
    m, k = a.shape
    n = b.shape[1]
    bm, bn, bk = tiles
    mp, np_ = round_up(m, bm), round_up(n, bn)
    cfg = matmul_launch_config(bm, bn, bk, k)
    out = torch.empty((mp, np_), dtype=out_dtype, device=a.device)
    g = dict(m=m, n=n, k=k, bm=bm, bn=bn, nMT=mp // bm * cfg["sm"],
             nNT=np_ // bn * cfg["sn"], ldo=np_, cn=cfg["cols"] // 8,
             vwa=vector_width(k, ptrs=(a.data_ptr(),), itemsize=1),
             vwb=vector_width(n, bn, cfg["cbn"], ptrs=(b.data_ptr(),),
                              itemsize=1),
             **{key: cfg[key] for key in GEOMETRY if key in cfg})
    geometry = (ctypes.c_longlong * len(GEOMETRY))(*(g[key]
                                                     for key in GEOMETRY))
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        MATMUL_KERNEL.launch(
            a.data_ptr(), b.data_ptr(), scale.data_ptr(), out.data_ptr(),
            dtype_code(out_dtype), cfg["variant"], geometry, len(GEOMETRY),
            cfg["threads"], cfg["smem"], stream, tensor_core=True,
            grid=(g["nMT"] * g["nNT"],), block=(cfg["threads"],),
            smem=cfg["smem"])
    return out[:m, :n]


def _byte_perm(x: np.ndarray, y: np.ndarray, sel: int) -> np.ndarray:
    """CUDA's ``__byte_perm(x, y, sel)`` on uint32 arrays: byte i of the
    result is byte ``(sel >> 4 i) & 7`` of the 8 bytes y:x."""
    v = x.astype(np.uint64) | (y.astype(np.uint64) << np.uint64(32))
    out = np.zeros(x.shape, np.uint64)
    for i in range(4):
        src = (sel >> (4 * i)) & 7
        byte = (v >> np.uint64(8 * src)) & np.uint64(0xFF)
        out |= byte << np.uint64(8 * i)
    return out.astype(np.uint32)


def transpose_stage(stage: np.ndarray) -> np.ndarray:
    """The kernel's shared-memory transpose of one B stage, as its lanes do
    it (``transpose_stage`` in ``csrc/quant.cu``): the int8 (ks, bt) stage
    read as 32-bit words, 4 x 4 byte blocks (g, c) loaded in the rotated
    row order, rotated by ``(c % 8) // 2`` bytes, transposed with
    ``__byte_perm`` and stored into rotated n rows. Returns B^T, (bt, ks)
    int8 with k contiguous."""
    ks, bt = stage.shape
    w32 = np.ascontiguousarray(stage).view(np.uint32)  # (ks, bt / 4)
    g, c = np.meshgrid(np.arange(ks // 4), np.arange(bt // 4), indexing="ij")
    sh, rot = (g % 4) & 2, (c % 8) >> 1
    w = [w32[4 * g + ((i + sh) & 3), c] for i in range(4)]
    w = [np.where(sh != 0, w[(i + 2) % 4], w[i]) for i in range(4)]
    r = (8 * rot).astype(np.uint64)
    w = [((x.astype(np.uint64) | (x.astype(np.uint64) << np.uint64(32))) >> r
          ).astype(np.uint32) for x in w]  # __funnelshift_r(x, x, 8 rot)
    u0, u1 = _byte_perm(w[0], w[1], 0x5140), _byte_perm(w[0], w[1], 0x7362)
    u2, u3 = _byte_perm(w[2], w[3], 0x5140), _byte_perm(w[2], w[3], 0x7362)
    t = [_byte_perm(u0, u2, 0x5410), _byte_perm(u0, u2, 0x7632),
         _byte_perm(u1, u3, 0x5410), _byte_perm(u1, u3, 0x7632)]
    out = np.zeros((bt, ks // 4), np.uint32)
    for j in range(4):
        out[4 * c + ((j + rot) & 3), g] = t[j]
    return out.view(np.int8)


def matmul_q_tc_emulate(a: torch.Tensor, b: torch.Tensor,
                        scale: torch.Tensor, out_dtype=torch.bfloat16,
                        tiles: Optional[Tuple[int, int, int]] = None
                        ) -> torch.Tensor:
    """A plain model of ``matmul_q_tc_kernel``'s geometry on the CPU, in
    integer arithmetic (for the tests; nothing on the main path calls it):
    per CTA (a (cbm, cbn) share of a (bm, bn) tile), the ring's k-spans
    zero-filled past m, n and k, B staged (ks, bt) and transposed by
    :func:`transpose_stage`, the k32 slices that hold real k multiplied into
    the m16n8 tiles each warp owns
    (:func:`~repro_torch.kernels.matmul.warp_tiles`), then the epilogue's
    column map: int32 -> f32, times the f32 scale, cast, the CTA's rows and
    columns within its tile stored into the padded output."""
    m, k = a.shape
    n = b.shape[1]
    if tiles is None:
        tiles = resolve_kernel_plan(
            _matmul_spec_q(m, n, k, a.dtype, b.dtype, out_dtype))
    bm, bn, bk = tiles
    cfg = matmul_launch_config(bm, bn, bk, k)
    ks, rows, bt = cfg["ks"], cfg["rows"], cfg["bt"]
    owned = [t for w in range(cfg["wm"] * cfg["wn"])
             for t in warp_tiles(cfg, w)]
    an, bn_ = a.numpy(), b.numpy()
    mp, np_ = round_up(m, bm), round_up(n, bn)
    sc = np.zeros(np_, np.float32)
    sc[:n] = scale.float().numpy().reshape(-1)
    out = np.zeros((mp, np_), np.float32)

    def ctas(total, tile, share):  # (origin, extent stored) of each CTA
        return [(t + s, min(share, tile - s)) for t in range(0, total, tile)
                for s in range(0, tile, share)]

    for row0, rl in ctas(mp, bm, cfg["cbm"]):
        rv = max(0, min(rl, m - row0))
        for col0, cl in ctas(np_, bn, cfg["cbn"]):
            nv = max(0, min(cl, n - col0))
            acc = np.zeros((rows, cfg["cols"]), np.int64)
            for k0 in range(0, k, ks):
                kv = min(ks, k - k0)
                a_st = np.zeros((rows, ks), np.int8)
                a_st[:rv, :kv] = an[row0:row0 + rv, k0:k0 + kv]
                b_st = np.zeros((ks, bt), np.int8)
                b_st[:kv, :nv] = bn_[k0:k0 + kv, col0:col0 + nv]
                b_t = transpose_stage(b_st)
                kc = -(-kv // 32) * 32  # the k32 slices that hold real k
                # int8 products summed in float64: exact (|sum| < 2^53)
                prod = (a_st[:, :kc].astype(np.float64)
                        @ b_t[:cfg["cols"], :kc].astype(np.float64).T
                        ).astype(np.int64)
                for mt, nt in owned:
                    blk = (slice(16 * mt, 16 * mt + 16),
                           slice(8 * nt, 8 * nt + 8))
                    acc[blk] += prod[blk]
            assert np.abs(acc).max(initial=0) < 2 ** 31  # int32 registers
            out[row0:row0 + rl, col0:col0 + cl] = (
                acc[:rl, :cl].astype(np.float32) * sc[col0:col0 + cl])
    return torch.from_numpy(out).to(out_dtype)[:m, :n]


def matmul_q(
    a: torch.Tensor,  # (m, k) int8
    b: torch.Tensor,  # (k, n) int8
    scale: torch.Tensor,  # (1, n) f32: folded s_a * s_b[n]
    out_dtype=torch.bfloat16,
    ctx=None,  # ExecutionContext (duck-typed: .target/.autotune)
    tiles: Optional[Tuple[int, int, int]] = None,
    plan: Optional[ExecutionPlan] = None,
) -> torch.Tensor:
    """Quantized GEMM: int8 A/B streams over k, int32 accumulator, folded
    per-column scale applied at the store. Operands come from
    ``repro_torch.quant.quantize_matmul_operands``. CUDA tensors run the
    kernel; CPU tensors run :func:`matmul_q_plain`."""
    m, k = a.shape
    k2, n = b.shape
    if k != k2:
        raise ValueError(f"inner dims mismatch: {k} vs {k2}")
    if tuple(scale.shape) != (1, n):
        raise ValueError(f"scale must be (1, {n}), got {tuple(scale.shape)}")
    _check_int8("matmul_q", a, b)
    t = resolve_kernel_plan(
        _matmul_spec_q(m, n, k, a.dtype, b.dtype, out_dtype),
        plan=plan, tiles=tiles, ctx=ctx)
    if a.device.type == "cpu" and b.device.type == "cpu":
        return matmul_q_plain(a, b, scale, out_dtype)
    return _matmul_launch(a, b, scale.float().contiguous(), out_dtype,
                          tuple(t))


def matmul_q_hbm_words(
    a,  # tensor (meta tensors work), (m, k) int8
    b,  # tensor, (k, n) int8
    scale=None,
    tiles: Optional[Tuple[int, int, int]] = None,
    plan: Optional[ExecutionPlan] = None,
    target: Optional[HardwareTarget] = None,
    out_dtype=torch.bfloat16,
) -> float:
    """Measured HBM words of one ``matmul_q`` dispatch (int8 streams +
    out_dtype stores + the scale vector once)."""
    m, k = a.shape
    n = b.shape[1]
    bm, bn, bk = resolve_kernel_plan(
        _matmul_spec_q(m, n, k, a.dtype, b.dtype, out_dtype),
        plan=plan, target=target, tiles=tiles)
    mp, np_, kp = round_up(m, bm), round_up(n, bn), round_up(k, bk)
    n_steps = (mp // bm) * (np_ // bn) * (kp // bk)
    p_a = _wordwidth(a.dtype)
    p_b = _wordwidth(b.dtype)
    p_out = _wordwidth(out_dtype)
    return (n_steps * (bm * bk * p_a + bk * bn * p_b)
            + mp * np_ * p_out + np_ * 1.0)


# ---------------------------------------------------------------------------
# Access plans (repro_torch.verify)
# ---------------------------------------------------------------------------

def conv2d_q_access_plan(
    x,  # tensor (meta tensors work), (N, c_I, H, W) int8
    w,  # tensor, (c_O, c_I, h_F, w_F) int8
    scale=None,  # (1, c_O) f32; only its place in the signature matters
    stride: Tuple[int, int] = (1, 1),
    tiles: Optional[Sequence[int]] = None,
    plan: Optional[ExecutionPlan] = None,
    target: Optional[HardwareTarget] = None,
    out_dtype=torch.bfloat16,
):
    """The :class:`repro_torch.verify.access.KernelAccessPlan` of one
    ``conv2d_q`` launch (``conv2d_q_tc_kernel``): the bf16 conv's walk
    (``conv2d.conv_access_plan``) at int8 widths over the ring stages of
    :func:`conv_launch_config` (two plan c_I blocks a stage), 16-element
    window runs, the epilogue staged through shared memory, and the scale:
    the counter charges its c_O words once, while every CTA reads its
    b_cO slice, an excess of (CTAs - c_O tiles) x b_cO words."""
    N, c_I, H, W = x.shape
    c_O, _, h_F, w_F = w.shape
    sh, sw = stride
    h_O = (H - h_F) // sh + 1
    w_O = (W - w_F) // sw + 1
    t = resolve_kernel_plan(
        _conv_spec_q(N, c_I, c_O, h_O, w_O, h_F, w_F, sh, sw, x.dtype,
                     w.dtype, out_dtype),
        plan=plan, target=target, tiles=tiles)
    t = _normalize_tiles(t, h_O, w_O)
    h_in = (t[3] - 1) * sh + h_F
    w_in = (t[4] - 1) * sw + w_F
    cfg = conv_launch_config(t, h_F, w_F, h_in, w_in, c_I, (H, W))
    return conv_access_plan("conv2d_q", x, w, (sh, sw), t, out_dtype, cfg)


def matmul_q_program(n_spans: int):
    """``matmul_q_tc_kernel``'s events for one CTA: the scale slice written
    before the prologue's ``__syncthreads`` (read in the epilogue); spans 0
    and 1 issued (A into slot s % 3, B into slot s % 2, a commit group
    each), ``wait_group(1)``, ``__syncthreads``, span 0 transposed (B slot
    0 read, B^T slot 0 written); then span s: ``wait_group(0)``,
    ``__syncthreads``, span s + 2 issued (an empty group past the last),
    span s + 1 transposed, A slot s % 3 and B^T slot s % 2 read; a
    ``wait_group(0)`` at exit."""
    from repro_torch.verify.hazards import Program

    a_slots, b_slots, t_slots = RING
    prog = Program()
    prog.write("scale", 0, 0)

    def load(s):
        prog.start("A", s % a_slots, s)
        prog.start("B", s % b_slots, s)

    def transpose(s):
        prog.read("B", s % b_slots, s)
        prog.write("B^T", s % t_slots, s)

    for s in range(a_slots - 1):
        if s < n_spans:
            load(s)
        prog.commit()
    prog.wait_group(a_slots - 2)
    prog.barrier()
    if n_spans:
        transpose(0)
    for s in range(n_spans):
        prog.wait_group(a_slots - 3)
        prog.barrier()
        if s + a_slots - 1 < n_spans:
            load(s + a_slots - 1)
        prog.commit()
        if s + 1 < n_spans:
            transpose(s + 1)
        prog.read("A", s % a_slots, s)
        prog.read("B^T", s % t_slots, s)
    prog.wait_group(0)
    prog.read("scale", 0, 0)
    return prog


def matmul_q_access_plan(
    a,  # tensor (meta tensors work), (m, k) int8
    b,  # tensor, (k, n) int8
    scale=None,
    tiles: Optional[Tuple[int, int, int]] = None,
    plan: Optional[ExecutionPlan] = None,
    target: Optional[HardwareTarget] = None,
    out_dtype=torch.bfloat16,
):
    """The :class:`repro_torch.verify.access.KernelAccessPlan` of one
    ``matmul_q`` launch (``matmul_q_tc_kernel``), from
    :func:`matmul_launch_config`: the CTA shares of a narrow plan (each
    share reads the narrow operand's whole slice of the tile: the re-reads
    are uncounted), the k-spans, the 3 A, 2 B and 2 B^T stages and the
    scale slice in shared memory, the ring of :func:`matmul_q_program`,
    and the scale: the counter charges its n words once, every CTA reads
    its slice."""
    from repro_torch.verify.access import ScratchAlloc

    m, k = a.shape
    n = b.shape[1]
    bm, bn, bk = resolve_kernel_plan(
        _matmul_spec_q(m, n, k, a.dtype, b.dtype, out_dtype),
        plan=plan, target=target, tiles=tiles)
    cfg = matmul_launch_config(bm, bn, bk, k)
    scratch = (
        ScratchAlloc("A ring", cfg["off_bs"] / 4.0),
        ScratchAlloc("B ring", (cfg["off_bt"] - cfg["off_bs"]) / 4.0),
        ScratchAlloc("B^T ring", (cfg["off_sc"] - cfg["off_bt"]) / 4.0),
        ScratchAlloc("scale slice", (cfg["smem"] - cfg["off_sc"]) / 4.0),
    )
    dma = matmul_q_program(cfg["n_spans"]).schedules(
        {"A": RING[0], "B": RING[1], "B^T": RING[2], "scale": 1},
        cfg["threads"] // 32, "matmul_q")
    return gemm_access_plan(
        "matmul_q", "matmul_q_tc_kernel", m, n, k, (bm, bn, bk),
        _wordwidth(a.dtype), _wordwidth(b.dtype), _wordwidth(out_dtype),
        cfg["ks"], cfg["n_spans"], cfg["threads"], cfg["smem"], scratch, dma,
        shares=(cfg["sm"], cfg["sn"], cfg["cbm"], cfg["cbn"]), scale=True)
