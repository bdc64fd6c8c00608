"""Communication-optimal direct convolution: the port of
``repro.kernels.conv2d``.

The blocking LP (core.tiling.optimize_blocking, eq. 6 + the §5 buffer model)
picks the (bN, b_cI, b_cO, b_hO, b_wO) tile; the f32 output tile is the
accumulator, held across the c_I reduction; input windows and filter blocks
stream from HBM at their stored width.

Layout: NCHW input, OIHW filter, VALID padding, arbitrary stride — the exact
7NL CNN of §2.1. Spatial tiling is halo-aware: an output row block
[i*bh, (i+1)*bh) reads the overlapping input window starting at row
i*bh*sh of (bh - 1)*sh + h_F rows, and likewise for columns.

On a CUDA tensor, :func:`conv2d` launches the hand-written kernels of
``csrc/conv2d.cu`` (one CTA per output tile, the c_I loop inside the CTA,
accumulator in registers): bf16 inputs the tensor-core kernel (an implicit
GEMM, ``mma.sync`` m16n8k16, its A fragments gathered from the window in
shared memory through :func:`gather_table` and :func:`row_offsets`, the
window laid out by :func:`window_layout` so that 16-byte ``cp.async`` runs
fill it whatever the input's pitch, a two-slot ring over c_I; an input
whose base is not 16-byte aligned, a slice, is realigned by one copy
first), f32 inputs the FMA kernel; the dtype picks, before the launch. On a
CPU tensor it runs :func:`conv2d_plain`, the same function in plain
PyTorch. There is no fallback between them.

``conv2d_hbm_words`` reports the HBM words one launch moves, from the same
launch geometry (:func:`_launch_geometry`) the kernel uses: one input halo
window and one filter block per grid step, one output block per tile.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional, Sequence, Tuple

import torch

from repro_torch.core.conv_model import Precision, round_up
from repro_torch.plan import ConvSpec, ExecutionPlan, HardwareTarget
from repro_torch.plan.planner import resolve_kernel_plan

from ._build import (CudaKernel, check_cuda_operands, check_smem, dtype_code,
                     micro_tile)
from .matmul import SMEM_TWO_CTAS, _pad_row, vector_width, warp_layout
from .ref import no_tf32

_c = ctypes
KERNEL = CudaKernel("conv2d.cu", "repro_conv2d", [
    _c.c_void_p, _c.c_void_p, _c.c_void_p, _c.c_void_p,  # x, w, koff, out
    _c.c_int, _c.c_int, _c.c_int,                        # dtypes, variant
    _c.POINTER(_c.c_longlong), _c.c_int,                 # geometry, its length
    _c.c_int, _c.c_int, _c.c_void_p,                     # threads, smem, stream
])
# The launch geometry the C entry takes, in csrc/conv2d.cu's ConvParams
# order. b_cI and nCI are the channels a stage and the stages: the plan's
# (b_cI, c_I blocks) for the FMA kernel, a ring stage's for the tensor-core
# kernel; the fields after x_bytes are the tensor-core kernel's (0 for the
# FMA one).
GEOMETRY = ("N", "c_I", "H", "W", "c_O", "h_F", "w_F", "sh", "sw",
            "bN", "b_cI", "b_cO", "bh", "bw", "h_in", "w_in",
            "cOp", "hOp", "wOp", "nN", "nCO", "nH", "nW", "nCI",
            "n_pg", "ldw", "x_bytes",
            "n16", "ldb", "slots", "wn", "planes", "koff_bytes",
            "slot_bytes", "run", "vwb", "b_run", "vst", "ldS",
            "rows_bytes", "d_row", "d_ch", "d_img", "zero", "cn")
# f32 inputs: the FMA kernel's (CO_T, P_T) micro-tiles, in csrc/conv2d.cu's
# launch_fma order
MICRO_TILES = ((8, 8), (4, 16), (16, 4), (2, 32), (1, 64))
# bf16 inputs: the tensor-core kernel's warp blocks of (MI, NI) m16n8 tiles
# (rows: output pixels, columns: output channels), in launch_tc's order. The
# main path takes (4, 4) for its 32-channel tiles (conv1, conv3_x, conv4_x)
# and (2, 8) for its 64-channel ones (conv2_x, conv5_x). A tile neither
# covers within 8 warps (few output channels, many pixels) takes the LINEAR
# variant, index len(TC_VARIANTS) (warp w owns m16n8 tiles 16w .. 16w + 15
# in row-major order, as the GEMMs' LINEAR); a tile of more than 8 warps x
# 64 accumulators raises ValueError.
TC_VARIANTS = ((4, 4), (2, 8))
LINEAR = len(TC_VARIANTS)
# Elements a window copy of the tensor-core kernel moves: 16 bytes of bf16,
# aligned in the input (csrc/conv2d.cu's G).
WINDOW_RUN = 8


def _conv_spec(N: int, c_I: int, c_O: int, h_O: int, w_O: int, h_F: int,
               w_F: int, sh: int, sw: int, in_bits: int) -> ConvSpec:
    p_in = in_bits / 32.0
    return ConvSpec(N=N, c_I=c_I, c_O=c_O, w_O=w_O, h_O=h_O, w_F=w_F, h_F=h_F,
                    sw=sw, sh=sh, prec=Precision(p_in, p_in, 1.0))


def _normalize_tiles(tiles: Sequence[int], h_O: int, w_O: int
                     ) -> Tuple[int, int, int, int, int]:
    """Accept the legacy (bN, b_cI, b_cO) triple (spatial kept whole) or the
    full (bN, b_cI, b_cO, b_hO, b_wO) planner tuple."""
    if len(tiles) == 3:
        return (*tiles, h_O, w_O)
    bN, b_cI, b_cO, bh, bw = tiles
    return (bN, b_cI, b_cO, max(1, min(bh, h_O)), max(1, min(bw, w_O)))


def _launch_geometry(N: int, c_I: int, c_O: int, H: int, W: int, h_F: int,
                     w_F: int, sh: int, sw: int,
                     tiles: Tuple[int, int, int, int, int]):
    """Padded dims, halo-window extents, and grid — the single source of
    truth shared by the kernel launch and the HBM-word counter."""
    bN, b_cI, b_cO, bh, bw = tiles
    h_O = (H - h_F) // sh + 1
    w_O = (W - w_F) // sw + 1
    Np, cIp, cOp = round_up(N, bN), round_up(c_I, b_cI), round_up(c_O, b_cO)
    hOp, wOp = round_up(h_O, bh), round_up(w_O, bw)
    # the last block's halo window reaches this far (zero-filled past H, W)
    Hp = max(H, (hOp - 1) * sh + h_F)
    Wp = max(W, (wOp - 1) * sw + w_F)
    h_in = (bh - 1) * sh + h_F
    w_in = (bw - 1) * sw + w_F
    grid = (Np // bN, cOp // b_cO, hOp // bh, wOp // bw, cIp // b_cI)
    return Np, cIp, cOp, hOp, wOp, Hp, Wp, h_in, w_in, grid


def exact_window(H: int, W: int, h_F: int, w_F: int, sh: int, sw: int
                 ) -> bool:
    """True iff an (H, W) input extent is an *exact* halo window — every row
    and column participates in some VALID output ((H - h_F) % sh == 0 and
    likewise for W)."""
    return (H - h_F) % sh == 0 and (W - w_F) % sw == 0


def conv2d_plain(x: torch.Tensor, w: torch.Tensor,
                 stride: Tuple[int, int] = (1, 1),
                 out_dtype=torch.float32) -> torch.Tensor:
    """The kernel's function in plain PyTorch: for each of the h_F * w_F
    taps, a strided slice of the input times that tap's (c_I, c_O) filter
    matrix, accumulated in f32 (TF32 off)."""
    N, c_I, H, W = x.shape
    c_O, _, h_F, w_F = w.shape
    sh, sw = stride
    h_O = (H - h_F) // sh + 1
    w_O = (W - w_F) // sw + 1
    xf = x.float().permute(0, 2, 3, 1)  # (N, H, W, c_I)
    wf = w.float()
    acc = torch.zeros((N, h_O, w_O, c_O), dtype=torch.float32, device=x.device)
    with no_tf32():
        for hf in range(h_F):
            for wf_ in range(w_F):
                tap = xf[:, hf:hf + (h_O - 1) * sh + 1:sh,
                         wf_:wf_ + (w_O - 1) * sw + 1:sw, :]  # (N,h_O,w_O,c_I)
                acc += torch.matmul(tap, wf[:, :, hf, wf_].t())
    return acc.permute(0, 3, 1, 2).to(out_dtype)


def _fma_config(tiles, h_F: int, w_F: int, h_in: int, w_in: int,
                itemsize: int) -> dict:
    bN, b_cI, b_cO, bh, bw = tiles
    variant, co_t, _, n_cg, n_pg = micro_tile(b_cO, bN * bh * bw,
                                              MICRO_TILES)
    ldw = n_cg * co_t + max(1, 4 // itemsize)  # odd word stride for stores
    x_bytes = round_up(bN * b_cI * h_in * w_in * itemsize, 16)
    smem = x_bytes + b_cI * h_F * w_F * ldw * itemsize
    check_smem(smem, f"conv2d tiles {tiles}")
    return dict(kernel="fma", variant=variant, n_pg=n_pg,
                threads=n_cg * n_pg, ldw=ldw, x_bytes=x_bytes, smem=smem)


def window_layout(tiles, cs: int, zc: bool, h_in: int, w_in: int, c_I: int,
                  H: int, W: int, run: int = WINDOW_RUN,
                  ch_pad: int = 0) -> dict:
    """The window's shared-memory layout for a ring stage of ``cs``
    channels (+ a zero plane where ``zc``): pitches (elements) of a row
    ``d_row``, a channel plane ``d_ch`` and an image ``d_img``, the gather
    offset ``zero`` of the zero plane, and the elements ``x_elems`` of a
    slot's window. The copies move runs of ``run`` elements (16 bytes:
    ``WINDOW_RUN`` of bf16, 16 of int8) aligned in the input: each window
    row as the aligned runs that cover it. So the pitches are congruent to
    the input's modulo the run (an aligned run lands on an aligned slot),
    and each leaves a run of slack, so two rows' covers never share a run.
    A whole-plane window (h_in = H, w_in = W) is one run an image, its
    planes contiguous; else ``ch_pad`` (a multiple of the run) more
    elements of slack part two channel planes, which moves the planes'
    banks. A step's window origin lies ``run + (its input offset mod
    run)`` elements into the slot."""
    g = run

    def up(v: int, like: int) -> int:  # the least u >= v with u = like mod g
        return v + (like - v) % g

    if h_in == H and w_in == W:
        d_row, d_ch = w_in, h_in * w_in
    else:
        d_row = up(w_in + g - 1, W)
        d_ch = up((h_in - 1) * d_row + w_in + g - 1 + ch_pad, H * W)
    d_img = up((cs + zc) * d_ch + 7 * g, c_I * H * W)
    return dict(d_row=d_row, d_ch=d_ch, d_img=d_img, zero=cs * d_ch + 4 * g,
                x_elems=2 * g + tiles[0] * d_img)


def _tc_config(tiles, h_F: int, w_F: int, h_in: int, w_in: int,
               c_I: Optional[int], hw: Optional[Tuple[int, int]]) -> dict:
    bN, b_cI, b_cO, bh, bw = tiles
    lay = warp_layout(bN * bh * bw, b_cO, TC_VARIANTS)
    taps = h_F * w_F
    H, W = hw or (h_in, w_in)
    cs = b_cI if c_I is None else min(b_cI, c_I)
    while True:
        ks = cs * taps
        n16 = -(-ks // 16)
        zc = ks % 16 != 0  # a zero plane for the padded k
        n_st = 2 if c_I is None else -(-c_I // cs)
        slots = min(2, n_st)
        ldb = _pad_row(n16 * 16)
        win = window_layout(tiles, cs, zc, h_in, w_in, c_I or cs, H, W)
        x_bytes = round_up(win["x_elems"] * 2, 16)
        slot_bytes = x_bytes + lay["cols"] * ldb * 2
        koff_bytes = n16 * 16 * 4
        rows_bytes = round_up(bN * cs * h_in * 8, 16)  # the row table
        smem = koff_bytes + rows_bytes + slots * slot_bytes
        # halve the stage until two CTAs share an SM (conv5_x: 16 of 32)
        if smem <= SMEM_TWO_CTAS or cs % 2:
            break
        cs //= 2
    # the epilogue stages the tile through shared memory for 4-pixel stores
    # where output rows of the tile are whole groups of 4 (conv1, conv2_x)
    vst = 4 if bw % 4 == 0 else 0
    lds = lay["rows"] + 4  # 4 mod 16 words: conflict-free fragment writes
    if vst:
        smem = max(smem, b_cO * lds * 4)
    check_smem(smem, f"conv2d tiles {tiles}")
    if win["x_elems"] >= 1 << 16:  # the kernel's 16-bit row offsets
        raise ValueError(f"conv2d tiles {tiles}: a window of "
                         f"{win['x_elems']} elements exceeds 16-bit offsets")
    return dict(kernel="tensor core", **lay, threads=lay["wm"] * lay["wn"] * 32,
                cs=cs, n_st=n_st, ks=ks, n16=n16, planes=cs + zc, ldb=ldb,
                slots=slots, **win, x_bytes=x_bytes, slot_bytes=slot_bytes,
                koff_bytes=koff_bytes, rows_bytes=rows_bytes, vst=vst,
                lds=lds, smem=smem, acc_per_thread=lay["mi"] * lay["ni"] * 4)


def launch_config(tiles: Tuple[int, int, int, int, int], h_F: int, w_F: int,
                  h_in: int, w_in: int, itemsize: int,
                  c_I: Optional[int] = None,
                  hw: Optional[Tuple[int, int]] = None) -> dict:
    """The kernel's launch configuration for conv tiles, picked by the
    input's item size: 2 (bf16) the tensor-core kernel (warp layout, a ring
    stage's channels ``cs`` and its k (``ks``, ``n16`` slices of 16), the
    stages ``n_st`` over ``c_I`` and the slots, the window's layout for an
    input of ``hw`` = (H, W) (:func:`window_layout`); ``c_I=None`` sizes
    the ring for many stages, ``hw=None`` takes whole-plane windows), 4
    (f32) the FMA kernel
    (micro-tile variant and thread grid, one stage a plan c_I block). Both
    give shared-memory strides and bytes. Raises ValueError for a tile no
    variant covers."""
    if itemsize == 2:
        return _tc_config(tiles, h_F, w_F, h_in, w_in, c_I, hw)
    return _fma_config(tiles, h_F, w_F, h_in, w_in, itemsize)


def gather_table(cs: int, h_F: int, w_F: int, d_row: int, d_ch: int,
                 zero: int, k_step: int = 16) -> list:
    """koff: the shared-memory offset, in elements from a pixel's window
    origin, of each k = (c * h_F + hf) * w_F + wf of a ring stage of ``cs``
    channels (OIHW order, as the filter rows lie; ``d_row``, ``d_ch`` the
    window's row and plane pitches), K padded to the MMA's depth ``k_step``
    (16 for bf16, 32 for int8) with k that point at ``zero``, the zeroed
    plane of each image. The same table serves every CTA and stage of a
    launch."""
    ks = cs * h_F * w_F
    koff = [c * d_ch + hf * d_row + wf for c in range(cs)
            for hf in range(h_F) for wf in range(w_F)]
    return koff + [zero] * (-ks % k_step)


def row_offsets(rows: int, tiles, stride, d_img: int, d_row: int) -> list:
    """moff: the window origin of each of a tile's first ``rows`` GEMM rows
    in shared memory, as the tensor-core kernel computes it: row m = (n, ho,
    wo), n-major, is n * d_img + ho * sh * d_row + wo * sw (``d_img``,
    ``d_row`` the window's image and row pitches). Rows past the tile's bN
    * bh * bw pixels read offset 0 (computed, never stored). A[m, k] =
    window[moff[m] + koff[k]]."""
    bN, _, _, bh, bw = tiles
    sh, sw = stride
    out = []
    for m in range(rows):
        n, rem = divmod(m, bh * bw)
        ho, wo = divmod(rem, bw)
        out.append(n * d_img + ho * sh * d_row + wo * sw
                   if m < bN * bh * bw else 0)
    return out


_KOFF = {}  # gather tables on the device, by (table key, device)


def _gather_table_on(device, *key) -> torch.Tensor:
    k = (*key, str(device))
    if k not in _KOFF:
        _KOFF[k] = torch.tensor(gather_table(*key), dtype=torch.int32,
                                device=device)
    return _KOFF[k]


def _launch(x: torch.Tensor, w: torch.Tensor, stride, out_dtype,
            t: Tuple[int, int, int, int, int]) -> torch.Tensor:
    check_cuda_operands("conv2d", x, w)
    N, c_I, H, W = x.shape
    c_O, _, h_F, w_F = w.shape
    sh, sw = stride
    h_O = (H - h_F) // sh + 1
    w_O = (W - w_F) // sw + 1
    bN, b_cI, b_cO, bh, bw = t
    (Np, _, cOp, hOp, wOp, _, _, h_in, w_in,
     grid) = _launch_geometry(N, c_I, c_O, H, W, h_F, w_F, sh, sw, t)
    cfg = launch_config(t, h_F, w_F, h_in, w_in, x.element_size(), c_I,
                        (H, W))
    out = torch.empty((Np, cOp, hOp, wOp), dtype=out_dtype, device=x.device)
    g = dict.fromkeys(GEOMETRY, 0)
    g.update(N=N, c_I=c_I, H=H, W=W, c_O=c_O, h_F=h_F, w_F=w_F, sh=sh, sw=sw,
             bN=bN, b_cI=b_cI, b_cO=b_cO, bh=bh, bw=bw, h_in=h_in, w_in=w_in,
             cOp=cOp, hOp=hOp, wOp=wOp, nN=grid[0], nCO=grid[1], nH=grid[2],
             nW=grid[3], nCI=grid[4], x_bytes=cfg["x_bytes"])
    koff = None
    tensor_core = cfg["kernel"] == "tensor core"
    if tensor_core:
        if x.data_ptr() % 16:
            # the window copies move 16-byte runs aligned in x: realign an
            # input whose base is not (a slice), with one copy
            x = x.clone()
        if bN * c_I * H * W >= 2 ** 31:  # the row table's offsets are int32
            raise ValueError(f"conv2d tiles {t}: {bN} images of {c_I} x {H} "
                             f"x {W} exceed 32-bit window offsets")
        cs, taps = cfg["cs"], h_F * w_F
        koff = _gather_table_on(x.device, cs, h_F, w_F, cfg["d_row"],
                                cfg["d_ch"], cfg["zero"])
        g.update(b_cI=cs, nCI=cfg["n_st"], n16=cfg["n16"], ldb=cfg["ldb"],
                 slots=cfg["slots"], wn=cfg["wn"], planes=cfg["planes"],
                 koff_bytes=cfg["koff_bytes"], slot_bytes=cfg["slot_bytes"],
                 # a window of whole planes is one run an image (conv4_x,
                 # conv5_x), else one run a row
                 run=int(h_in == H and w_in == W),
                 vwb=vector_width(c_I * taps, cs * taps, ptrs=(w.data_ptr(),)),
                 b_run=int(cs == c_I), vst=cfg["vst"], ldS=cfg["lds"],
                 rows_bytes=cfg["rows_bytes"], d_row=cfg["d_row"],
                 d_ch=cfg["d_ch"], d_img=cfg["d_img"], zero=cfg["zero"],
                 cn=cfg["cols"] // 8)
    else:
        g.update(n_pg=cfg["n_pg"], ldw=cfg["ldw"])
    geometry = (ctypes.c_longlong * len(GEOMETRY))(*(g[k] for k in GEOMETRY))
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        KERNEL.launch(
            x.data_ptr(), w.data_ptr(),
            None if koff is None else koff.data_ptr(), out.data_ptr(),
            dtype_code(x.dtype), dtype_code(out_dtype), cfg["variant"],
            geometry, len(GEOMETRY), cfg["threads"], cfg["smem"], stream,
            tensor_core=tensor_core, grid=(math.prod(grid[:4]),),
            block=(cfg["threads"],), smem=cfg["smem"])
    return out[:N, :c_O, :h_O, :w_O]


def conv2d(
    x: torch.Tensor,  # (N, c_I, H, W)
    w: torch.Tensor,  # (c_O, c_I, h_F, w_F)
    stride: Tuple[int, int] = (1, 1),
    out_dtype=torch.float32,
    ctx=None,  # ExecutionContext (duck-typed: .target/.autotune)
    tiles: Optional[Sequence[int]] = None,
    plan: Optional[ExecutionPlan] = None,
) -> torch.Tensor:
    """Direct convolution with paper-LP tiling. VALID padding.

    Tiles come from (in priority order) an explicit ``tiles`` tuple —
    (bN, b_cI, b_cO) or (bN, b_cI, b_cO, b_hO, b_wO) — an explicit ``plan``
    (the dispatcher's handoff), or a fresh plan for the context's target
    (default ``H100``). CUDA tensors run the kernel; CPU tensors run
    :func:`conv2d_plain`."""
    N, c_I, H, W = x.shape
    c_O, c_I2, h_F, w_F = w.shape
    if c_I != c_I2:
        raise ValueError(f"input has {c_I} channels, filter {c_I2}")
    sh, sw = stride
    h_O = (H - h_F) // sh + 1
    w_O = (W - w_F) // sw + 1
    t = resolve_kernel_plan(
        _conv_spec(N, c_I, c_O, h_O, w_O, h_F, w_F, sh, sw,
                   x.dtype.itemsize * 8),
        plan=plan, tiles=tiles, ctx=ctx)
    t = _normalize_tiles(t, h_O, w_O)
    if x.device.type == "cpu" and w.device.type == "cpu":
        return conv2d_plain(x, w, stride, out_dtype)
    return _launch(x, w, (sh, sw), out_dtype, t)


def check_shard_window(H: int, W: int, h_F: int, w_F: int, sh: int,
                       sw: int) -> None:
    """Raise ``ValueError`` unless an (H, W) shard window is exact: the
    windows ``repro_torch.distributed`` builds are exact by construction, so
    an inexact one means halo rows were mis-exchanged upstream."""
    if not exact_window(H, W, h_F, w_F, sh, sw):
        raise ValueError(
            f"shard-local conv window ({H}, {W}) is not exact for filter "
            f"({h_F}, {w_F}) stride ({sh}, {sw}): halo rows were "
            "mis-exchanged upstream")


def conv2d_shard(
    x: torch.Tensor,  # (bN, b_cI, (b_hO-1)*sh + h_F, (b_wO-1)*sw + w_F)
    w: torch.Tensor,  # (c_O, b_cI, h_F, w_F)
    stride: Tuple[int, int] = (1, 1),
    out_dtype=torch.float32,
    ctx=None,
    plan: Optional[ExecutionPlan] = None,
) -> torch.Tensor:
    """The kernel on one shard's exact halo window: the same kernel as
    :func:`conv2d` (``conv2d_tc_kernel`` for bf16 on the card), but the
    input must be an exact window, the shape each shard assembles after
    its halo exchanges. Plans resolve for the *local* shape.

    It keeps the reference's public name and contract. The distributed
    conv does not call it: as in the reference, its shard body makes the
    same check (:func:`check_shard_window`) and then goes through
    ``ops.conv2d``, so the dispatcher's plan, counters and fault handling
    see every shard."""
    _, _, H, W = x.shape
    _, _, h_F, w_F = w.shape
    check_shard_window(H, W, h_F, w_F, *stride)
    return conv2d(x, w, stride=stride, out_dtype=out_dtype, ctx=ctx,
                  plan=plan)


def conv2d_hbm_words(
    x,  # tensor (meta tensors work), (N, c_I, H, W)
    w,  # tensor, (c_O, c_I, h_F, w_F)
    stride: Tuple[int, int] = (1, 1),
    tiles: Optional[Sequence[int]] = None,
    plan: Optional[ExecutionPlan] = None,
    target: Optional[HardwareTarget] = None,
    out_dtype=torch.float32,
) -> float:
    """Measured HBM words (32-bit) one ``conv2d`` launch moves: one input
    halo window + one filter block per grid step, one output block per
    (n, co, h, w) tile — padding included. Only shapes/dtypes are
    consulted."""
    N, c_I, H, W = x.shape
    c_O, _, h_F, w_F = w.shape
    sh, sw = stride
    h_O = (H - h_F) // sh + 1
    w_O = (W - w_F) // sw + 1
    t = resolve_kernel_plan(
        _conv_spec(N, c_I, c_O, h_O, w_O, h_F, w_F, sh, sw,
                   x.dtype.itemsize * 8),
        plan=plan, target=target, tiles=tiles)
    t = _normalize_tiles(t, h_O, w_O)
    bN, b_cI, b_cO, bh, bw = t
    (Np, cIp, cOp, hOp, wOp, _, _, h_in, w_in,
     grid) = _launch_geometry(N, c_I, c_O, H, W, h_F, w_F, sh, sw, t)
    n_steps = math.prod(grid)
    p_in = x.dtype.itemsize / 4.0
    p_flt = w.dtype.itemsize / 4.0
    p_out = out_dtype.itemsize / 4.0
    return (n_steps * bN * b_cI * h_in * w_in * p_in
            + n_steps * b_cO * b_cI * h_F * w_F * p_flt
            + Np * cOp * hOp * wOp * p_out)



# ---------------------------------------------------------------------------
# Access plan (repro_torch.verify): the launch as structured data.
# ---------------------------------------------------------------------------

def window_overhang(N: int, c_I: int, H: int, W: int, grid, tiles, stride,
                    cs: int, n_st: int, h_in: int, w_in: int,
                    run: int) -> float:
    """Elements the tensor-core kernels' window copies read beyond the
    windows the counter charges, over all CTAs of a launch of
    ``grid`` = (nN, nCO, nH, nW, ...) (:func:`_launch_geometry`) with ring
    stages of ``cs`` channels. A window row is copied as the ``run``-element
    runs aligned in x that cover it (csrc/tc_common.cuh, ``copy_window``),
    so a live row (an image below N, a channel below c_I, a row below H, a
    first column below W) also reads the (origin mod run) elements before
    its origin; past the row's end the copy is partial (src-size), so
    nothing more. A whole-plane window (h_in = H, w_in = W) is one row an
    image, the stage's channel planes, whose last run may also read on
    into the next stage's planes."""
    import numpy as np

    nN, nCO, nH, nW = grid[:4]
    bN, _, _, bh, bw = tiles
    sh, sw = stride
    HW, img = H * W, c_I * H * W
    n0 = np.arange(nN)[:, None, None] * bN
    ci0 = np.arange(n_st)[None, :, None] * cs
    if h_in == H and w_in == W:
        n_abs = n0 + np.arange(bN)[None, None, :]
        a = (n_abs * img + ci0 * HW) % run
        length = cs * HW
        reach = -(-(length + a) // run) * run - a  # the last run's end
        right = np.maximum(0, np.minimum(reach, (c_I - ci0) * HW) - length)
        live = (n_abs < N) & (ci0 < c_I)
        return float(np.where(live, a + right, 0).sum() * nCO * nH * nW)
    # rows: (n, c, r) of a window lie at n * img + c * HW + r * W from the
    # step's origin; one residue table per count of live images, channels
    # and rows, applied to the steps' origins mod run
    h0 = np.arange(nH)[None, :, None, None] * bh * sh
    col0 = np.arange(nW)[None, None, :, None] * bw * sw
    n0 = np.arange(nN)[:, None, None, None] * bN
    ci0 = np.arange(n_st)[None, None, None, :] * cs
    shape = (nN, nH, nW, n_st)
    nv = np.broadcast_to(np.clip(N - n0, 0, bN), shape)
    cv = np.broadcast_to(np.clip(c_I - ci0, 0, cs), shape)
    rv = np.broadcast_to(np.clip(H - h0, 0, h_in), shape)
    rv = np.where(col0 < W, rv, 0)
    base = (n0 * img + ci0 * HW + h0 * W + col0) % run
    total = 0
    keys = np.stack([nv, cv, rv]).reshape(3, -1)
    flat_base = np.broadcast_to(base, shape).reshape(-1)
    uniq, inv = np.unique(keys, axis=1, return_inverse=True)
    for u, (a, c, r) in enumerate(uniq.T):
        if a * c * r == 0:
            continue
        offs = (np.arange(a)[:, None, None] * img
                + np.arange(c)[None, :, None] * HW
                + np.arange(r)[None, None, :] * W) % run
        hist = np.bincount(offs.reshape(-1), minlength=run)
        table = np.array([(hist * ((b + np.arange(run)) % run)).sum()
                          for b in range(run)])
        total += int(table[flat_base[inv.reshape(-1) == u]].sum())
    return float(total * nCO)


def conv_ring_program(n_st: int, slots: int, staged: bool,
                      scale: bool = False):
    """The tensor-core convs' events for one CTA (``conv2d_tc_kernel``,
    ``conv2d_q_tc_kernel``): the tables (and for ``scale`` the CTA's scale
    slice, read in the epilogue) written before a ``__syncthreads``,
    a ring of ``slots`` slots over the ``n_st`` c_I stages with one stage
    in flight (``wait_group(0)``, ``__syncthreads``, issue stage s + 1, read
    stage s), the closing ``wait_group(0)``, and, where the epilogue is
    ``staged`` through shared memory, a ``__syncthreads``, the tile written
    over the ring, a ``__syncthreads`` and its read."""
    from repro_torch.verify.hazards import Program

    prog = Program()
    if scale:
        prog.write("scale", 0, 0)
    prog.write("tables", 0, 0)
    prog.barrier()
    prog.ring("ring", n_st, slots, 1)
    prog.read("tables", 0, 0)
    prog.wait_group(0)
    if staged:
        prog.barrier()
        prog.write("ring", 0, n_st)
        prog.barrier()
        prog.read("ring", 0, n_st)
    if scale:
        prog.read("scale", 0, 0)
    return prog


def conv_access_plan(op: str, x, w, stride, t, out_dtype, cfg):
    """The access plan of one direct-conv launch (``conv2d`` or the int8
    ``conv2d_q``, which also reads a scale) from its launch configuration
    ``cfg``: the walk is the CUDA grid's CTAs in ``tile_of`` order (n, h, w
    blocks, c_O tiles fastest) with the CTA's c_I stages innermost (a
    tensor-core ring stage of ``cfg["cs"]`` channels, or the FMA kernel's
    plan block). Counted: a stage's input window and filter block over the
    padded extents, the output tile once a CTA, and for ``conv2d_q`` one
    scale slice a c_O tile; uncounted: the other CTAs' scale slices and
    the window copies' 16-byte-run overhang (:func:`window_overhang`);
    skipped: plan channels past the stages the kernel runs."""
    import numpy as np

    from repro_torch.verify.access import (BlockAccess, CudaLaunch,
                                           FlatAccess, KernelAccessPlan,
                                           ScratchAlloc, WindowAccess)

    N, c_I, H, W = x.shape
    c_O, _, h_F, w_F = w.shape
    sh, sw = stride
    bN, b_cI, b_cO, bh, bw = t
    (Np, cIp, cOp, hOp, wOp, Hp, Wp, h_in, w_in,
     grid) = _launch_geometry(N, c_I, c_O, H, W, h_F, w_F, sh, sw, t)
    nN, nCO, nH, nW = grid[:4]
    tc = cfg["kernel"] == "tensor core"
    scale = op == "conv2d_q"
    run = 16 // x.dtype.itemsize  # a window copy: 16 bytes aligned in x
    cs, n_st = (cfg["cs"], cfg["n_st"]) if tc else (b_cI, grid[4])
    p_in = x.dtype.itemsize / 4.0
    p_flt = w.dtype.itemsize / 4.0
    p_out = out_dtype.itemsize / 4.0
    walk = (nN, nH, nW, nCO, n_st)

    def csz(s):  # a stage's plan channels (the last may be short)
        return np.clip(cIp - s * cs, 0, cs)

    def x_window(n, h, wb, co, s):
        return ((n * bN, bN), (s * cs, csz(s)),
                (h * bh * sh, h_in), (wb * bw * sw, w_in))

    def x_requires(n, h, wb, co, s):
        # first/last output row of the tile -> strided tap extent
        row_lo, row_hi = h * bh, h * bh + bh - 1
        col_lo, col_hi = wb * bw, wb * bw + bw - 1
        return ((n * bN, (n + 1) * bN), (s * cs, s * cs + csz(s)),
                (row_lo * sh, row_hi * sh + h_F),
                (col_lo * sw, col_hi * sw + w_F))

    accesses = [
        WindowAccess(name="input", kind="load",
                     array_shape=(Np, cIp, Hp, Wp), word_size=p_in,
                     window=x_window, requires=x_requires),
        WindowAccess(
            name="filter", kind="load", array_shape=(cOp, cIp, h_F, w_F),
            word_size=p_flt,
            window=lambda n, h, wb, co, s: (
                (co * b_cO, b_cO), (s * cs, csz(s)), (0, h_F), (0, w_F)),
            requires=lambda n, h, wb, co, s: (
                (co * b_cO, (co + 1) * b_cO), (s * cs, s * cs + csz(s)),
                (0, h_F), (0, w_F))),
        BlockAccess(
            name="output", kind="store", block_shape=(bN, b_cO, bh, bw),
            array_shape=(Np, cOp, hOp, wOp), word_size=p_out,
            index_map=lambda n, h, wb, co, s: (n, co, h, wb)),
    ]
    if scale:
        def first(n, h, wb, s):
            return (n == 0) & (h == 0) & (wb == 0) & (s == 0)

        accesses += [
            WindowAccess(
                name="scale", kind="load", array_shape=(1, cOp),
                word_size=1.0,
                window=lambda n, h, wb, co, s: (
                    (0, 1), (co * b_cO, np.where(first(n, h, wb, s), b_cO,
                                                 0))),
                note="one c_O slice a c_O tile, as the counter's once"),
            WindowAccess(
                name="scale (per-CTA slices)", kind="load",
                array_shape=(1, cOp), word_size=1.0, counted=False,
                window=lambda n, h, wb, co, s: (
                    (0, 1), (co * b_cO, np.where(
                        (s == 0) & ~first(n, h, wb, s), b_cO, 0))),
                note="every other CTA reads its c_O slice again"),
        ]
    skipped = []
    short = cIp - min(cIp, n_st * cs)  # plan channels no stage covers
    if short:
        tiles = nN * nCO * nH * nW
        skipped.append(FlatAccess(
            name="channels past the stages", kind="load",
            words=tiles * short * (bN * h_in * w_in * p_in
                                   + b_cO * h_F * w_F * p_flt)))
    if tc:
        accesses.append(FlatAccess(
            name="input run overhang", kind="load", counted=False,
            words=p_in * window_overhang(N, c_I, H, W, grid, t, stride, cs,
                                         n_st, h_in, w_in, run),
            note=f"{run}-element runs aligned in x (window_overhang)"))
        layout = [("gather table", cfg.get("koff_bytes", 0)),
                  ("row table", cfg.get("rows_bytes", 0)),
                  (f"ring[{cfg['slots']}]", cfg["slots"] * cfg["slot_bytes"])]
        if scale:
            layout = [("scale slice", cfg["off_koff"]),
                      ("gather table", cfg["off_rows"] - cfg["off_koff"]),
                      ("row table", cfg["off_ring"] - cfg["off_rows"]),
                      (f"ring[{cfg['slots']}]",
                       cfg["slots"] * cfg["slot_bytes"])]
        staged = bool(cfg["vst"])
    else:
        layout = [("window", cfg["x_bytes"]),
                  ("filter", cfg["smem"] - cfg["x_bytes"])]
        staged = False
    used = sum(b for _, b in layout)
    if cfg["smem"] > used:
        layout.append(("epilogue tile past the ring", cfg["smem"] - used))
    scratch = tuple(ScratchAlloc(name, nbytes / 4.0)
                    for name, nbytes in layout)
    dma = None
    if tc:
        prog = conv_ring_program(n_st, cfg["slots"], staged, scale)
        slots = {"ring": cfg["slots"], "tables": 1}
        if scale:
            slots["scale"] = 1
        dma = prog.schedules(slots, cfg["threads"] // 32, op)
    return KernelAccessPlan(
        op=op, grid=walk, accesses=tuple(accesses), scratch=scratch,
        dma=dma, skipped=tuple(skipped),
        launch=CudaLaunch(f"{op}_tc_kernel" if tc else f"{op}_kernel",
                          (nN * nCO * nH * nW, 1, 1),
                          (cfg["threads"], 1, 1), cfg["smem"]),
        note="stages innermost; the ring repeats identically per CTA")


def conv2d_access_plan(
    x,  # tensor (meta tensors work), (N, c_I, H, W)
    w,  # tensor, (c_O, c_I, h_F, w_F)
    stride: Tuple[int, int] = (1, 1),
    tiles: Optional[Sequence[int]] = None,
    plan: Optional[ExecutionPlan] = None,
    target: Optional[HardwareTarget] = None,
    out_dtype=torch.float32,
):
    """The :class:`repro_torch.verify.access.KernelAccessPlan` of one
    ``conv2d`` launch as :func:`conv2d` makes it: bf16 inputs the
    tensor-core kernel (its ring stages, window overhang, shared-memory
    layout and ring schedule from :func:`launch_config`), f32 the FMA kernel
    (one stage a plan c_I block, plain loads). The input's ``requires``
    region is derived independently of the window, from the tile's output
    rows through the strided tap arithmetic. Raises ValueError for tiles no
    kernel variant covers."""
    N, c_I, H, W = x.shape
    c_O, _, h_F, w_F = w.shape
    sh, sw = stride
    h_O = (H - h_F) // sh + 1
    w_O = (W - w_F) // sw + 1
    t = resolve_kernel_plan(
        _conv_spec(N, c_I, c_O, h_O, w_O, h_F, w_F, sh, sw,
                   x.dtype.itemsize * 8),
        plan=plan, target=target, tiles=tiles)
    t = _normalize_tiles(t, h_O, w_O)
    h_in = (t[3] - 1) * sh + h_F
    w_in = (t[4] - 1) * sw + w_F
    cfg = launch_config(t, h_F, w_F, h_in, w_in, x.dtype.itemsize, c_I,
                        (H, W))
    return conv_access_plan("conv2d", x, w, (sh, sw), t, out_dtype, cfg)
