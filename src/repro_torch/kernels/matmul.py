"""LP-tiled GEMM: the port of ``repro.kernels.matmul``.

Block shapes (bm, bn, bk) come from the paper's blocking LP applied to the
degenerate 7NL CNN (w_F = h_F = w_O = h_O = 1). On a CUDA tensor,
:func:`matmul` launches the hand-written kernels of ``csrc/matmul.cu`` (one
CTA per (bm, bn) tile, k looped inside the CTA, f32 accumulator in
registers): bf16 inputs the tensor-core kernel (``mma.sync`` m16n8k16 fed
by ``ldmatrix`` from a ``cp.async`` ring of k-spans), f32 inputs the FMA
kernel; the dtype picks, before the launch. On a CPU tensor it runs
:func:`matmul_plain`, the same function in plain PyTorch. There is no
fallback between them.

``matmul_hbm_words`` reports the HBM words one launch moves, from the same
launch geometry: one (bm, bk) A tile and one (bk, bn) B tile per grid step
plus the padded output stores, exactly as the reference counts them. The
tensor-core kernel's ring spans tile the same padded k range
(:func:`stage_spans`), so its words are the same.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from repro_torch.core.conv_model import Precision, round_up
from repro_torch.plan import ExecutionPlan, HardwareTarget, MatmulSpec
from repro_torch.plan.planner import resolve_kernel_plan

from ._build import (ACC_PER_THREAD, MAX_THREADS, CudaKernel,
                     check_cuda_operands, check_smem, dtype_code, micro_tile)
from .ref import no_tf32

_c = ctypes
KERNEL = CudaKernel("matmul.cu", "repro_matmul", [
    _c.c_void_p, _c.c_void_p, _c.c_void_p,            # a, b, out
    _c.c_int, _c.c_int, _c.c_int,                     # dtypes, variant
    _c.c_longlong, _c.c_int, _c.c_int,                # m, n, k
    _c.c_int, _c.c_int, _c.c_int,                     # bm, bn, bk
    _c.c_longlong, _c.c_int, _c.c_int,                # nMT, nNT, nKT
    _c.c_longlong, _c.c_int, _c.c_int, _c.c_int,      # ldo, nRG, ldA, ldB
    _c.c_longlong, _c.c_int, _c.c_int, _c.c_int,      # a_bytes, wn, cm, cn
    _c.c_int, _c.c_int, _c.c_int, _c.c_int,           # ks, slots, vwa, vwb
    _c.c_int, _c.c_int, _c.c_void_p,                  # threads, smem, stream
])
# f32 inputs: the FMA kernel's (TM, TN) micro-tiles, in csrc/matmul.cu's
# launch_fma order
MICRO_TILES = ((8, 8), (16, 4), (4, 16), (32, 2), (64, 1))
# bf16 inputs: the tensor-core kernel's warp blocks of (MI, NI) m16n8 tiles,
# in launch_tc's order (the main path's 128 x 128 and 256 x 64 tiles take
# (4, 4), its 128 x 64 tile (2, 4)); variant LINEAR gives each warp 16
# tiles in row-major order of the covered tile, for a tile no rectangular
# block fits within 8 warps
TC_VARIANTS = ((4, 4), (2, 4))
LINEAR = len(TC_VARIANTS)
LINEAR_TILES = ACC_PER_THREAD // 4  # m16n8 tiles a warp: 4 accumulators each
TC_SPANS = (64, 32, 16)  # a ring stage's k-span, the first that fits
TC_SLOTS = 3  # ring depth (fewer when k has fewer spans, never below 2)
WHOLE_ROWS_MAX = 256  # longest unaligned k that one span of whole rows takes
SMEM_TWO_CTAS = 113 * 1024  # a ring small enough for two CTAs an SM


def _matmul_spec(m: int, n: int, k: int, in_bits: int) -> MatmulSpec:
    p_in = in_bits / 32.0
    return MatmulSpec(m=m, n=n, k=k, prec=Precision(p_in, p_in, 1.0))


def matmul_plain(a: torch.Tensor, b: torch.Tensor,
                 out_dtype=torch.float32) -> torch.Tensor:
    """The kernel's function in plain PyTorch: an f32 matmul (TF32 off)."""
    with no_tf32():
        return torch.matmul(a.float(), b.float()).to(out_dtype)


def _fma_config(bm: int, bn: int, bk: int, itemsize: int) -> dict:
    variant, tm, tn, n_rg, n_cg = micro_tile(bm, bn, MICRO_TILES)
    lda = bm + max(1, 4 // itemsize)  # odd word stride: conflict-free stores
    ldb = n_cg * tn
    a_bytes = round_up(bk * lda * itemsize, 16)
    smem = a_bytes + bk * ldb * itemsize
    check_smem(smem, f"matmul tiles {(bm, bn, bk)}")
    return dict(kernel="fma", variant=variant, n_rg=n_rg,
                threads=n_rg * n_cg, lda=lda, ldb=ldb, a_bytes=a_bytes,
                smem=smem)


def warp_layout(bm: int, bn: int, variants=TC_VARIANTS,
                max_threads: int = MAX_THREADS) -> dict:
    """A tensor-core kernel's warp layout for a (bm, bn) tile: the
    compiled variant (an index into ``variants``, the (MI, NI) blocks of
    m16n8 tiles a warp that the kernel compiles; ``len(variants)`` is
    LINEAR), its block, the warp grid (wm x wn) and the covered tile (rows
    x cols, the shared-memory extent; rows past bm and columns past bn are
    computed, never stored). The rectangular variant that covers the least
    area wins, then the one with the most warps, then the widest block
    (fewer A fragments a product); a tile none fits within ``max_threads``
    (the bf16 kernels' 8 warps, the int8 kernels' 16) takes LINEAR. Raises
    ValueError when the tile holds more than ``max_threads`` x 64
    accumulators."""
    cm, cn = -(-bm // 16), -(-bn // 8)
    best = None
    for v, (mi, ni) in enumerate(variants):
        wm, wn = -(-cm // mi), -(-cn // ni)
        if wm * wn * 32 > max_threads:
            continue
        key = (wm * mi * wn * ni, -wm * wn, -ni)
        if best is None or key < best[0]:
            best = (key, dict(variant=v, mi=mi, ni=ni, wm=wm, wn=wn,
                              rows=wm * mi * 16, cols=wn * ni * 8,
                              linear=False))
    if best is not None:
        return best[1]
    warps = -(-cm * cn // LINEAR_TILES)
    if warps * 32 > max_threads:
        raise ValueError(
            f"a {bm} x {bn} accumulator tile does not fit one CTA's "
            f"{max_threads} x {ACC_PER_THREAD} registers; plan for the H100 "
            "target")
    return dict(variant=len(variants), mi=1, ni=LINEAR_TILES, wm=warps,
                wn=1, rows=cm * 16, cols=cn * 8, linear=True)


def warp_tiles(layout: dict, warp: int) -> list:
    """The (m16, n8) tile indices one warp accumulates, as the tensor-core
    kernels (``matmul_tc_kernel``, ``matmul_q_tc_kernel``, the convs'
    ``conv2d_tc_kernel`` and ``conv2d_q_tc_kernel``) map them (a model of
    the kernels for the tests)."""
    mi, ni, wn = layout["mi"], layout["ni"], layout["wn"]
    if layout["linear"]:
        cm, cn = layout["rows"] // 16, layout["cols"] // 8
        qs = range(warp * ni, min((warp + 1) * ni, cm * cn))
        return [divmod(q, cn) for q in qs]
    wm, wj = divmod(warp, wn)
    return [(wm * mi + i, wj * ni + j) for i in range(mi) for j in range(ni)]


def stage_spans(k: int, bk: int, ks: int) -> list:
    """The ring's k-spans ``[(start, stop), ...]``: the padded k range
    ``[0, round_up(k, bk))`` cut every ``ks``. The kernel runs the spans
    that hold real k and, in each, the 16-deep slices that do."""
    kp = round_up(k, bk)
    return [(s, min(s + ks, kp)) for s in range(0, kp, ks)]


def _pad_row(c: int) -> int:
    """A shared-memory row of c bf16 (c a multiple of 8), padded to an odd
    multiple of 16 bytes: ldmatrix's 8 rows then fall in 8 bank groups."""
    return c + 8 if (c // 8) % 2 == 0 else c + 16


def vector_width(*extents: int, ptrs=(), itemsize: int = 2) -> int:
    """Elements a global load may move at once: the widest of at most 16
    bytes (8 bf16, 16 int8), then halves down to 1, that divides every
    extent (row pitch, tile width) and whose bytes divide every base
    address. 16 bytes take the ``cp.async`` path."""
    v = 16 // itemsize
    while v > 1 and not (all(e % v == 0 for e in extents)
                         and all(p % (itemsize * v) == 0 for p in ptrs)):
        v //= 2
    return v


def _tc_config(bm: int, bn: int, bk: int, k: Optional[int]) -> dict:
    lay = warp_layout(bm, bn)
    ldb = _pad_row(lay["cols"])
    spans = TC_SPANS
    if k is not None and k % 8 and round_up(k, 16) <= WHOLE_ROWS_MAX:
        # a pitch 16-byte copies cannot take: one span of whole rows, so
        # that a tile's rows are one contiguous run (conv1's k = 147)
        spans = (round_up(k, 16),) + spans
    for ks in spans:
        n_spans = TC_SLOTS if k is None else -(-k // ks)
        slots = min(TC_SLOTS, max(2, n_spans))
        lda = _pad_row(ks)
        a_bytes = lay["rows"] * lda * 2
        # one slot holds an A and a B stage; a single span needs one slot
        smem = min(slots, n_spans) * (a_bytes + ks * ldb * 2)
        if smem <= SMEM_TWO_CTAS:
            break
    check_smem(smem, f"matmul tiles {(bm, bn, bk)}")
    return dict(kernel="tensor core", **lay, threads=lay["wm"] * lay["wn"] * 32,
                ks=ks, slots=slots, n_spans=n_spans, lda=lda, ldb=ldb,
                a_bytes=a_bytes, smem=smem,
                acc_per_thread=lay["mi"] * lay["ni"] * 4)


def launch_config(bm: int, bn: int, bk: int, itemsize: int,
                  k: Optional[int] = None) -> dict:
    """The kernel's launch configuration for tiles (bm, bn, bk), picked by
    the input's item size: 2 (bf16) the tensor-core kernel (warp layout,
    ring span, slots, spans of ``k`` holding real k; ``k=None`` sizes the
    ring for a long k), 4 (f32) the FMA kernel (micro-tile variant and
    thread grid). Both give shared-memory strides and bytes. Raises
    ValueError for a tile no variant covers."""
    if itemsize == 2:
        return _tc_config(bm, bn, bk, k)
    return _fma_config(bm, bn, bk, itemsize)


def _launch(a: torch.Tensor, b: torch.Tensor, out_dtype,
            tiles: Tuple[int, int, int]) -> torch.Tensor:
    check_cuda_operands("matmul", a, b)
    m, k = a.shape
    n = b.shape[1]
    bm, bn, bk = tiles
    mp, np_ = round_up(m, bm), round_up(n, bn)
    cfg = launch_config(bm, bn, bk, a.element_size(), k)
    out = torch.empty((mp, np_), dtype=out_dtype, device=a.device)
    if cfg["kernel"] == "tensor core":
        geometry = (cfg["n_spans"], np_, 0, cfg["lda"], cfg["ldb"],
                    cfg["a_bytes"], cfg["wn"], cfg["rows"] // 16,
                    cfg["cols"] // 8, cfg["ks"], cfg["slots"],
                    vector_width(k, ptrs=(a.data_ptr(),)),
                    vector_width(n, bn, ptrs=(b.data_ptr(),)))
    else:
        geometry = (-(-k // bk), np_, cfg["n_rg"], cfg["lda"], cfg["ldb"],
                    cfg["a_bytes"], 0, 0, 0, 0, 0, 0, 0)
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        KERNEL.launch(
            a.data_ptr(), b.data_ptr(), out.data_ptr(), dtype_code(a.dtype),
            dtype_code(out_dtype), cfg["variant"], m, n, k, bm, bn, bk,
            mp // bm, np_ // bn, *geometry, cfg["threads"], cfg["smem"],
            stream, tensor_core=cfg["kernel"] == "tensor core",
            grid=((mp // bm) * (np_ // bn),), block=(cfg["threads"],),
            smem=cfg["smem"])
    return out[:m, :n]


def matmul(
    a: torch.Tensor,  # (m, k)
    b: torch.Tensor,  # (k, n)
    out_dtype=torch.float32,
    ctx=None,  # ExecutionContext (duck-typed: .target/.autotune)
    tiles: Optional[Tuple[int, int, int]] = None,
    plan: Optional[ExecutionPlan] = None,
) -> torch.Tensor:
    """C[m,n] = A @ B with LP-chosen tiles.

    Tiles come from (in priority order) an explicit ``tiles`` triple, an
    explicit ``plan`` (the dispatcher's handoff), or a fresh plan for the
    context's target (default ``H100``). CUDA tensors run the kernel; CPU
    tensors run :func:`matmul_plain`."""
    m, k = a.shape
    k2, n = b.shape
    if k != k2:
        raise ValueError(f"inner dims mismatch: {k} vs {k2}")
    t = resolve_kernel_plan(_matmul_spec(m, n, k, a.dtype.itemsize * 8),
                            plan=plan, tiles=tiles, ctx=ctx)
    if a.device.type == "cpu" and b.device.type == "cpu":
        return matmul_plain(a, b, out_dtype)
    return _launch(a, b, out_dtype, tuple(t))


def matmul_hbm_words(
    a,  # tensor (meta tensors work), (m, k)
    b,  # tensor, (k, n)
    tiles: Optional[Tuple[int, int, int]] = None,
    plan: Optional[ExecutionPlan] = None,
    target: Optional[HardwareTarget] = None,
    out_dtype=torch.float32,
) -> float:
    """Measured HBM words (32-bit) one ``matmul`` launch moves: one A and
    one B tile loaded per grid step plus the padded output stores. Only
    shapes/dtypes are consulted."""
    m, k = a.shape
    n = b.shape[1]
    bm, bn, bk = resolve_kernel_plan(
        _matmul_spec(m, n, k, a.dtype.itemsize * 8),
        plan=plan, target=target, tiles=tiles)
    mp, np_, kp = round_up(m, bm), round_up(n, bn), round_up(k, bk)
    n_steps = (mp // bm) * (np_ // bn) * (kp // bk)
    p_a = a.dtype.itemsize / 4.0
    p_b = b.dtype.itemsize / 4.0
    p_out = out_dtype.itemsize / 4.0
    return (n_steps * (bm * bk * p_a + bk * bn * p_b) + mp * np_ * p_out)


def gemm_access_plan(op: str, kernel: str, m: int, n: int, k: int,
                     tiles: Tuple[int, int, int], p_a: float, p_b: float,
                     p_out: float, ks: int, n_spans: int, threads: int,
                     smem: int, scratch, dma, shares=(1, 1, None, None),
                     scale: bool = False):
    """The access plan of one tiled GEMM launch (``matmul``, the int8
    ``matmul_q``): the walk is the CUDA grid's CTAs (n tiles fastest; a
    narrow plan's ``shares`` = (sm, sn, cbm, cbn) CTA shares of each tile,
    the tile's shares consecutive) with the CTA's ``n_spans`` k-spans of
    ``ks`` innermost. Counted: A and B spans over the padded k range (a
    tile's rows or columns once, by its first share along the other side),
    the output once a CTA, and for ``scale`` one slice a column tile;
    uncounted: the other shares' re-reads and the other CTAs' scale
    slices; skipped: padded k past the spans the kernel runs."""
    import numpy as np

    from repro_torch.verify.access import (CudaLaunch, FlatAccess,
                                           KernelAccessPlan, WindowAccess)

    bm, bn, bk = tiles
    mp, np_, kp = round_up(m, bm), round_up(n, bn), round_up(k, bk)
    sm, sn, cbm, cbn = shares
    cbm, cbn = cbm or bm, cbn or bn
    nMT, nNT = mp // bm * sm, np_ // bn * sn
    walk = (nMT, nNT, n_spans)

    def rows(i):  # the share's first row and rows
        si = i % sm * cbm
        return i // sm * bm + si, np.minimum(cbm, bm - si)

    def cols(j):
        sj = j % sn * cbn
        return j // sn * bn + sj, np.minimum(cbn, bn - sj)

    def kspan(s):
        return s * ks, np.clip(kp - s * ks, 0, ks)

    def a_win(first):
        def window(i, j, s):
            r0, rl = rows(i)
            k0, kl = kspan(s)
            mine = (j % sn == 0) == first
            return (r0, np.where(mine, rl, 0)), (k0, kl)
        return window

    def b_win(first):
        def window(i, j, s):
            c0, cl = cols(j)
            k0, kl = kspan(s)
            mine = (i % sm == 0) == first
            return (k0, kl), (c0, np.where(mine, cl, 0))
        return window

    def a_requires(i, j, s):
        r0, rl = rows(i)
        k0, kl = kspan(s)
        return ((r0, np.where(j % sn == 0, r0 + rl, r0)), (k0, k0 + kl))

    accesses = [
        WindowAccess(name="a", kind="load", array_shape=(mp, kp),
                     word_size=p_a, window=a_win(True), requires=a_requires),
        WindowAccess(name="b", kind="load", array_shape=(kp, np_),
                     word_size=p_b, window=b_win(True)),
        WindowAccess(
            name="out", kind="store", array_shape=(mp, np_),
            word_size=p_out,
            window=lambda i, j, s: ((rows(i)[0], np.where(s == 0, rows(i)[1],
                                                          0)),
                                    (cols(j)[0], cols(j)[1]))),
    ]
    if sn > 1:
        accesses.append(WindowAccess(
            name="a (CTA-share re-reads)", kind="load", array_shape=(mp, kp),
            word_size=p_a, window=a_win(False), counted=False,
            note="each share of a tile's columns reads the tile's rows"))
    if sm > 1:
        accesses.append(WindowAccess(
            name="b (CTA-share re-reads)", kind="load",
            array_shape=(kp, np_), word_size=p_b, window=b_win(False),
            counted=False,
            note="each share of a tile's rows reads the tile's columns"))
    if scale:
        def slice_of(first):
            def window(i, j, s):
                c0, cl = cols(j)
                mine = (s == 0) & ((i == 0) == first)
                return (0, 1), (c0, np.where(mine, cl, 0))
            return window

        accesses += [
            WindowAccess(name="scale", kind="load", array_shape=(1, np_),
                         word_size=1.0, window=slice_of(True),
                         note="one slice a column tile, as the counter's "
                              "once"),
            WindowAccess(name="scale (per-CTA slices)", kind="load",
                         array_shape=(1, np_), word_size=1.0,
                         window=slice_of(False), counted=False,
                         note="every other CTA reads its slice again"),
        ]
    skipped = []
    short = kp - min(kp, n_spans * ks)  # padded k no span reaches
    if short:
        skipped.append(FlatAccess(
            name="k past the spans", kind="load",
            words=(mp // bm) * (np_ // bn) * short * (bm * p_a + bn * p_b)))
    return KernelAccessPlan(
        op=op, grid=walk, accesses=tuple(accesses), scratch=scratch,
        dma=dma, skipped=tuple(skipped),
        launch=CudaLaunch(kernel, (nMT * nNT, 1, 1), (threads, 1, 1), smem),
        note="k-spans innermost; the ring repeats identically per CTA")


def matmul_access_plan(
    a,  # tensor (meta tensors work), (m, k)
    b,  # tensor, (k, n)
    tiles: Optional[Tuple[int, int, int]] = None,
    plan: Optional[ExecutionPlan] = None,
    target: Optional[HardwareTarget] = None,
    out_dtype=torch.float32,
    op: str = "matmul",
):
    """The :class:`repro_torch.verify.access.KernelAccessPlan` of one
    ``matmul`` launch as :func:`matmul` makes it: bf16 inputs the
    tensor-core kernel (the k-spans, slots and shared memory of
    :func:`launch_config`; its ring: ``slots - 1`` spans in flight,
    ``wait_group(slots - 2)``, one ``__syncthreads`` a span, no wait at
    exit, as its trailing groups are empty), f32 the FMA kernel (one stage a
    plan k-step, plain loads). Raises ValueError for tiles no variant
    covers."""
    from repro_torch.verify.access import ScratchAlloc
    from repro_torch.verify.hazards import ring_schedule

    m, k = a.shape
    n = b.shape[1]
    bm, bn, bk = resolve_kernel_plan(
        _matmul_spec(m, n, k, a.dtype.itemsize * 8),
        plan=plan, target=target, tiles=tiles)
    cfg = launch_config(bm, bn, bk, a.dtype.itemsize, k)
    if cfg["kernel"] == "tensor core":
        kernel, ks, n_spans = "matmul_tc_kernel", cfg["ks"], cfg["n_spans"]
        held = min(cfg["slots"], n_spans)
        scratch = (ScratchAlloc(f"ring[{held}] (A and B spans)",
                                cfg["smem"] / 4.0),)
        dma = ring_schedule(n_spans, cfg["slots"], cfg["slots"] - 1,
                            cfg["threads"] // 32, name=f"{op}: ring",
                            drain=False)
    else:
        kernel, ks, n_spans = "matmul_kernel", bk, -(-k // bk)
        scratch = (ScratchAlloc("a tile", cfg["a_bytes"] / 4.0),
                   ScratchAlloc("b tile",
                                (cfg["smem"] - cfg["a_bytes"]) / 4.0))
        dma = None
    return gemm_access_plan(
        op, kernel, m, n, k, (bm, bn, bk), a.dtype.itemsize / 4.0,
        b.dtype.itemsize / 4.0, out_dtype.itemsize / 4.0, ks, n_spans,
        cfg["threads"], cfg["smem"], scratch, dma)
