"""Blocked (flash-style) attention and paged decode: the port of
``repro.kernels.flash_attention``.

Attention's two GEMMs (QK^T and PV) are 7NL degenerates; the paper's capacity
argument picks the (block_q, block_k) pair (``attention_blocks``, the closed
form ``core.tiling.attention_block_size`` the planner's attention plans use).
GQA is handled by folding the g query heads of one KV head into the query
axis, so K/V stream at their un-repeated size.

On CUDA tensors, :func:`flash_attention` launches ``csrc/flash_attention.cu``
(the reference's ``_flash_kernel`` and ``_flash_kernel_dyn`` in one source:
offsets and lengths are int32 device arrays, static ones constant arrays)
and :func:`paged_decode_attention` launches ``csrc/paged_decode.cu`` (the
reference's ``_paged_decode_kernel``). Each source has two kernels, chosen
by the input dtype: for flash (:func:`launch_config`) bf16 takes
``flash_tc_kernel`` (both products on the tensor cores with ``mma.sync``, a
two-slot ``cp.async`` K/V ring, an R x C warp grid that splits the keys of
a tile over C warps at decode shapes and, where the keys span many tiles,
a split of each row's key tiles over the CTAs of one thread-block cluster,
merged through distributed shared memory) and f32 the FMA
``flash_kernel``; for
paged decode (:func:`paged_launch_config`) bf16 takes
``paged_decode_tc_kernel`` (``mma.sync``) and f32 the FMA
``paged_decode_fma_kernel``, both a split of each row's table slots over
the CTAs of one thread-block cluster, merged through distributed shared
memory, dead slots skipped. On CPU tensors each wrapper runs its plain
PyTorch version (:func:`flash_attention_plain`, :func:`paged_decode_plain`).
There is no fallback between the two. :func:`flash_attention_tc_emulate`
and :func:`paged_decode_tc_emulate` model the kernels' arithmetic (bf16 P,
split keys, merges) for the CPU tests; nothing on the main path calls
them.

Masking follows the reference's finite ``NEG_INF = -1e30``: a query row whose
keys are all masked averages V over its keys, giving neither zeros nor NaN.
Keys past the array's end (the kernel's ragged tile edge) get zero weight.

``stats=True`` (the flash entries, their plain version and the emulation)
returns a key shard's flash-decode partial ``(acc, m, l)`` instead of the
output: the unnormalised f32 accumulator (BH, Lq, Dh), the row max in the
logits' natural units and the row sum, each f32 (BH, Lq), so that the
shards of a sequence-sharded cache merge as ``sum e^(m_j - m*) acc_j /
sum e^(m_j - m*) l_j`` (``repro_torch.dtensors``). A shard whose keys are
all masked reports ``m = NEG_INF`` and weighs 0 beside any shard with a
valid key.

``attention_hbm_words`` / ``paged_decode_hbm_words`` are the reference's
counters, unchanged: the words one launch moves, from its launch geometry.
``attention_stats_hbm_words`` is the port's for a launch with statistics,
``attention_split_hbm_words`` the port's for a launch as the key split
walks it (equal to the reference's: Q is read once a row).
``paged_decode_issued_words`` counts what the paged kernel issues, which
skips dead slots: at most the counter.
"""

from __future__ import annotations

import ctypes
import functools
import numbers
from typing import Optional, Tuple, Union

import torch

from repro_torch.core.conv_model import round_up
from repro_torch.core.tiling import attention_block_size
from repro_torch.plan import H100, HardwareTarget

from ._build import CudaKernel, check_cuda_operands, check_smem, dtype_code
from .ref import no_tf32

NEG_INF = -1e30
LOG2E = 1.4426950408889634  # the kernel's logits are scaled to base 2

_c = ctypes
_FLASH_ARGS = [
    _c.c_void_p, _c.c_void_p, _c.c_void_p, _c.c_void_p,  # q, k, v, out
    _c.c_void_p, _c.c_void_p,                            # row max, row sum
    _c.c_void_p, _c.c_void_p, _c.c_void_p,               # offsets, lens, mask
    _c.c_int, _c.c_int, _c.c_int, _c.c_int,              # dtypes in/out, hd, block
    _c.c_longlong, _c.c_int, _c.c_int,                   # rows, Lq, Lk
    _c.c_int, _c.c_int,                                  # bq, bk
    _c.c_int, _c.c_int, _c.c_int,                        # q_seq_len, rows/batch, causal
    _c.c_int,                                            # split
    _c.c_float, _c.c_void_p,                             # scale, stream
]
FLASH_KERNEL = CudaKernel("flash_attention.cu", "repro_flash_attention",
                          _FLASH_ARGS)
# the same library's launches with row statistics, counted on their own
FLASH_STATS_KERNEL = CudaKernel("flash_attention.cu", "repro_flash_attention",
                                _FLASH_ARGS)
PAGED_KERNEL = CudaKernel("paged_decode.cu", "repro_paged_decode", [
    _c.c_void_p, _c.c_void_p, _c.c_void_p,               # q, kp, vp
    _c.c_void_p, _c.c_void_p, _c.c_void_p,               # tables, lengths, out
    _c.c_int, _c.c_int,                                  # dtype, hd
    _c.c_int, _c.c_int, _c.c_int, _c.c_int, _c.c_int,    # B, KV, g, bs, w
    _c.c_int,                                            # capacity
    _c.c_float, _c.c_void_p,                             # scale, stream
])
# the (hd, block) instances compiled into csrc/flash_attention.cu; every H100
# plan for hd in {16, 32, 64, 80, 128} at bf16 or f32 K/V is one of them
# (hd 80: HuBERT-xLarge's 1280 / 16, planned at block 64)
FLASH_INSTANCES = frozenset(
    [(hd, b) for hd in (16, 32) for b in (32, 64, 128)]
    + [(hd, b) for hd in (64, 80, 128) for b in (32, 64)])
PAGED_HEAD_DIMS = (16, 32, 64, 128)
PAGED_MAX_GROUP = 16  # query heads per kv head (csrc/paged_decode.cu G_MAX)
# csrc/paged_decode.cu's launch constants (a test pins them to the source)
PAGED_WARPS = 4  # WARPS: a CTA's warps (each an 8-key slab of a tile, bf16)
PAGED_KEY_TILE = 32  # KEY_TILE: keys a ring slot holds
PAGED_RING = 4  # RING: ring slots
PAGED_MAX_SPLIT = 8  # MAX_SPLIT: CTAs a cluster, the portable cluster size
PAGED_TARGET_CTAS = 264  # TARGET_CTAS: twice the H100's 132 SMs


def attention_blocks(dh: int, target: HardwareTarget,
                     kv_word: Optional[float] = None) -> Tuple[int, int]:
    """(block_q, block_k) from the target's capacity argument: f32 q/acc/stats
    residents plus streamed k/v tiles must fit the double-buffered budget.
    ``kv_word`` is the stream width of the actual k/v arrays (words of 32
    bits); defaults to the target's policy."""
    m_eff = target.memory_model().M_eff
    p_kv = target.precision.p_I if kv_word is None else kv_word
    b = attention_block_size(dh, m_eff, p_kv=p_kv)
    return b, b


def _row_ints(value, rows: int, device) -> torch.Tensor:
    """An int or int32 tensor (scalar, or one value per row) as a contiguous
    (rows,) int32 tensor on ``device``."""
    if isinstance(value, numbers.Integral):  # a device fill, no host copy
        return torch.full((rows,), int(value), dtype=torch.int32, device=device)
    t = torch.as_tensor(value, dtype=torch.int32, device=device).reshape(-1)
    return t.expand(rows).contiguous()


def _rows_of(key_mask: torch.Tensor, rows: int) -> int:
    """Folded rows per key-mask row."""
    B = key_mask.shape[0]
    if rows % B:
        raise ValueError(f"key_mask has {B} rows, which do not divide the "
                         f"{rows} folded rows")
    return rows // B


# ---------------------------------------------------------------------------
# Flash attention.
# ---------------------------------------------------------------------------

def flash_attention_plain(
    q: torch.Tensor,  # (BH, Lq, Dh)
    k: torch.Tensor,  # (BH, Lk, Dh)
    v: torch.Tensor,  # (BH, Lk, Dh)
    causal: bool = True,
    q_offset: Union[int, torch.Tensor] = 0,
    q_seq_len: Optional[int] = None,
    kv_lens: Optional[torch.Tensor] = None,
    key_mask: Optional[torch.Tensor] = None,
    stats: bool = False,
):
    """The kernel's function in plain PyTorch: f32 logits and softmax over
    all Lk keys, masked keys at ``NEG_INF``. ``stats``: the partial
    ``(acc, m, l)`` (module docstring) in f32."""
    BH, Lq, Dh = q.shape
    Lk = k.shape[1]
    dev = q.device
    with no_tf32():
        s = torch.einsum("bqd,bkd->bqk", q.float(), k.float())
    s = s * (1.0 / Dh ** 0.5)
    kpos = torch.arange(Lk, device=dev)
    lens = _row_ints(Lk if kv_lens is None else kv_lens, BH, dev)
    keep = kpos[None, None, :] < lens[:, None, None]
    if causal:
        qidx = torch.arange(Lq, device=dev)
        if q_seq_len is not None and q_seq_len < Lq:
            qidx = qidx % q_seq_len  # GQA fold: positions wrap per group
        offs = _row_ints(q_offset, BH, dev)
        keep = keep & (kpos[None, None, :]
                       <= qidx[None, :, None] + offs[:, None, None])
    if key_mask is not None:
        km = key_mask.to(torch.bool).repeat_interleave(
            _rows_of(key_mask, BH), dim=0)
        keep = keep & km[:, None, :]
    s = torch.where(keep, s, torch.full_like(s, NEG_INF))
    if stats:
        m = s.amax(dim=-1)
        p = torch.exp(s - m[..., None])
        with no_tf32():
            acc = torch.einsum("bqk,bkd->bqd", p, v.float())
        return acc, m, p.sum(dim=-1)
    p = torch.softmax(s, dim=-1)
    with no_tf32():
        return torch.einsum("bqk,bkd->bqd", p, v.float()).to(q.dtype)


FMA_THREADS = 256  # csrc/flash_attention.cu, flash_kernel's THREADS
RING_SLOTS = 2  # K/V ring slots of flash_tc_kernel
FLASH_MAX_SPLIT = 8  # CTAs a row's cluster at most: the portable cluster size
FLASH_SPLIT_TILES = 8  # key tiles each CTA of a split walks at least


def flash_split(n_q: int, n_k: int, row_slabs: int = 1) -> int:
    """S, the CTAs of ``flash_tc_kernel``'s key split for a row of ``n_q``
    q tiles of ``row_slabs`` row slabs (R) and ``n_k`` key tiles: with one
    q tile of one row slab (decode shapes: 16 folded queries at most), the
    largest power of two up to ``FLASH_MAX_SPLIT`` that leaves every CTA
    at least ``FLASH_SPLIT_TILES`` tiles; else 1. From the tiles alone, so
    a row's walk does not depend on the rows that share its launch."""
    s = 1
    while (n_q == 1 and row_slabs == 1 and 2 * s <= FLASH_MAX_SPLIT
           and n_k // (2 * s) >= FLASH_SPLIT_TILES):
        s *= 2
    return s


def split_tiles(n_k: int, split: int) -> list:
    """The key tiles [t0, t1) rank r of a row's cluster walks, for r in
    0 .. split - 1: [r n_k // S, (r + 1) n_k // S), the kernel's shares
    (empty for a rank when n_k < S)."""
    return [(r * n_k // split, (r + 1) * n_k // split)
            for r in range(split)]


def tc_warps(block: int) -> int:
    """Warps of a ``flash_tc_kernel`` CTA (``tc_warps`` in the source)."""
    return 8 if block == 128 else 4


def warp_grid(bq: int, block: int) -> Tuple[int, int]:
    """(R, C): R row slabs of 16 folded query rows, the smallest power of
    two with 16 R >= ``bq``, by C = W / R key slabs of ``block / C`` keys."""
    w = tc_warps(block)
    r = 1
    while 16 * r < bq:
        r *= 2
    if r > w:
        raise ValueError(f"bq={bq} exceeds the block of {block}")
    return r, w // r


def flash_tc_instances() -> list:
    """The (hd, block, C) instances of ``flash_tc_kernel`` without the key
    split compiled into the source: every C that some runtime bq (a
    multiple of 8 up to the block) takes at each instance of
    ``FLASH_INSTANCES``."""
    return sorted({(hd, b, warp_grid(bq, b)[1])
                   for hd, b in FLASH_INSTANCES
                   for bq in range(8, b + 1, 8)})


def flash_split_instances() -> list:
    """The (hd, block, C) instances of ``flash_tc_kernel`` with the key
    split (its ``SPLIT`` template argument): one row slab, C = W, at each
    instance of ``FLASH_INSTANCES``."""
    return sorted((hd, b, tc_warps(b)) for hd, b in FLASH_INSTANCES)


@functools.lru_cache(maxsize=None)  # read-only: a launch copies what it sends
def launch_config(Lq: int, Lk: int, hd: int, block: int, dtype,
                  rows: int = 1) -> dict:
    """The launch of ``csrc/flash_attention.cu`` for ``rows`` folded rows of
    ``Lq`` queries and ``Lk`` keys at the compiled (hd, block) instance:
    ``kernel`` (``"tensor core"`` for bf16, ``"fma"`` for f32), ``warps``,
    ``threads``, ``grid`` (rows, q tiles; 1 when the keys fit one tile and
    the CTA walks its q tiles with them resident), the runtime tiles ``bq``
    and ``bk`` (clamped as the reference clamps them), ``n_q``, ``n_k``,
    ``kv_resident``, ``smem`` (dynamic shared-memory bytes, as the
    source computes them), ``split`` (S, :func:`flash_split`; the FMA
    kernel's is 1), ``cluster`` ((S, 1, 1)) and ``ctas``. With S > 1 the
    grid is (rows x S, 1): each row's S CTAs form one cluster and split its
    key tiles (:func:`split_tiles`). The tensor-core kernel adds
    ``warp_grid`` (R, C), ``key_slab`` (keys a warp takes of each tile),
    ``slots`` (the K/V ring's) and ``pitch`` (shared-memory row,
    elements). Raises ValueError for an instance that is not compiled,
    TypeError for another dtype."""
    if (hd, block) not in FLASH_INSTANCES:
        raise ValueError(
            f"flash_attention: no compiled kernel for hd={hd}, block={block} "
            f"(compiled: {sorted(FLASH_INSTANCES)}); plan for the H100 target")
    bq = min(block, round_up(Lq, 8))
    bk = min(block, round_up(Lk, 8))
    n_q, n_k = -(-Lq // bq), -(-Lk // bk)
    resident = n_k == 1
    grid = (rows, 1 if resident else n_q)
    cfg = dict(bq=bq, bk=bk, n_q=n_q, n_k=n_k, kv_resident=resident,
               grid=grid, split=1, cluster=(1, 1, 1),
               ctas=grid[0] * grid[1])
    if dtype == torch.float32:
        smem = 4 * (2 * block * (hd + 1) + block * hd + block * (block + 1)
                    + 3 * block)
        return dict(cfg, kernel="fma", warps=FMA_THREADS // 32,
                    threads=FMA_THREADS, smem=smem)
    if dtype != torch.bfloat16:
        raise TypeError(f"flash_attention takes float32 or bfloat16, not "
                        f"{dtype}")
    w = tc_warps(block)
    r, c = warp_grid(bq, block)
    split = flash_split(n_q, n_k, r)
    if split > 1:
        cfg.update(grid=(rows * split, 1), split=split,
                   cluster=(split, 1, 1), ctas=rows * split)
    pitch = hd + 8  # an odd multiple of 16 bytes: conflict-free ldmatrix
    merge = (c - 1) * r * 32 * (4 + hd // 2) * 4  # (m, l, O) of key slabs 1..
    smem = (1 + 2 * RING_SLOTS) * block * pitch * 2 + merge
    check_smem(smem, f"flash_attention hd={hd} block={block}")
    return dict(cfg, kernel="tensor core", warps=w, threads=32 * w,
                warp_grid=(r, c), key_slab=block // c, slots=RING_SLOTS,
                pitch=pitch, smem=smem)


def flash_attention_tc_emulate(
    q: torch.Tensor,  # (BH, Lq, Dh) bf16
    k: torch.Tensor,  # (BH, Lk, Dh) bf16
    v: torch.Tensor,  # (BH, Lk, Dh) bf16
    causal: bool = True,
    q_offset: Union[int, torch.Tensor] = 0,
    q_seq_len: Optional[int] = None,
    kv_lens: Optional[torch.Tensor] = None,
    key_mask: Optional[torch.Tensor] = None,
    block: Optional[int] = None,
    stats: bool = False,
    split: Optional[int] = None,
):
    """``flash_tc_kernel``'s arithmetic in plain PyTorch, for the CPU tests
    only: the same q tiles, key tiles and C key slabs of each tile (the R
    row slabs compute independently, so they go together), each slab an
    online softmax in the log2 domain with f32 logits of the bf16 operands,
    P rounded to bf16 before P V, l summed from the f32 probabilities, and
    the C partials merged as the kernel merges them; under a key split the
    S ranks each walk their share of the key tiles (:func:`split_tiles`)
    with their own running maxima (P rounded against the rank's), and
    their merged partials merge in rank order as the cluster merges them.
    ``block`` defaults to the H100 plan's, ``split`` to
    :func:`launch_config`'s S (another S models the kernel launched with
    it; it needs one q tile of one row slab). ``stats``: the kernel's f32 store with
    statistics, ``(acc, m, l)`` (the merged log2 max over ``LOG2E``,
    ``NEG_INF`` kept)."""
    if q.dtype != torch.bfloat16:
        raise TypeError(f"the tensor-core kernel takes bfloat16, not {q.dtype}")
    BH, Lq, Dh = q.shape
    Lk = k.shape[1]
    if q_seq_len is not None and q_seq_len >= Lq:
        q_seq_len = None
    if block is None:
        block = attention_blocks(Dh, H100, kv_word=k.element_size() / 4.0)[0]
    cfg = launch_config(Lq, Lk, Dh, block, q.dtype, rows=BH)
    bq, bk, nw = cfg["bq"], cfg["bk"], cfg["key_slab"]
    n_slabs = cfg["warp_grid"][1]
    split = cfg["split"] if split is None else split
    if split > 1 and (cfg["n_q"], cfg["warp_grid"][0]) != (1, 1):
        raise ValueError(f"a key split takes one q tile of one row slab, "
                         f"not {cfg['n_q']} of {cfg['warp_grid'][0]}")
    dev = q.device
    qf, kf, vf = q.float(), k.float(), v.float()
    offs = _row_ints(q_offset, BH, dev)
    lens = _row_ints(Lk if kv_lens is None else kv_lens, BH, dev)
    km = None
    if key_mask is not None:
        km = key_mask.to(torch.bool).repeat_interleave(
            _rows_of(key_mask, BH), dim=0)
    sl2 = torch.tensor((1.0 / Dh ** 0.5) * LOG2E, dtype=torch.float32,
                       device=dev)
    out = torch.empty((BH, Lq, Dh), dtype=torch.float32, device=dev)
    m_out = torch.empty((BH, Lq), dtype=torch.float32, device=dev)
    l_out = torch.empty((BH, Lq), dtype=torch.float32, device=dev)
    for qt in range(cfg["n_q"]):
        q0 = qt * bq
        nr = min(bq, Lq - q0)
        qi = torch.arange(q0, q0 + nr, device=dev)
        qpos = ((qi % q_seq_len if q_seq_len else qi)[None]
                + offs[:, None])  # (BH, nr)
        parts = []  # each rank's (m, l, O), its key slabs merged
        for t0, t1 in split_tiles(cfg["n_k"], split):
            m = torch.full((n_slabs, BH, nr), NEG_INF, device=dev)
            lsum = torch.zeros((n_slabs, BH, nr), device=dev)
            o = torch.zeros((n_slabs, BH, nr, Dh), device=dev)
            for kt in range(t0, t1):
                k0 = kt * bk
                kv = min(bk, Lk - k0)
                for j in range(n_slabs):
                    c0 = j * nw
                    if c0 >= kv:
                        continue  # keys past Lk: zero weight
                    kpos = torch.arange(k0 + c0, k0 + min(c0 + nw, kv),
                                        device=dev)
                    with no_tf32():
                        s = torch.einsum("bqd,bkd->bqk", qf[:, q0:q0 + nr],
                                         kf[:, kpos]) * sl2
                    keep = kpos[None, None, :] < lens[:, None, None]
                    if causal:
                        keep = keep & (kpos[None, None, :]
                                       <= qpos[:, :, None])
                    if km is not None:
                        keep = keep & km[:, kpos][:, None, :]
                    s = torch.where(keep, s, torch.full_like(s, NEG_INF))
                    mx = torch.maximum(m[j], s.amax(-1))
                    alpha = torch.exp2(m[j] - mx)
                    p = torch.exp2(s - mx[..., None])
                    lsum[j] = alpha * lsum[j] + p.sum(-1)
                    with no_tf32():
                        pv = torch.einsum("bqk,bkd->bqd",
                                          p.to(torch.bfloat16).float(),
                                          vf[:, kpos])
                    o[j] = alpha[..., None] * o[j] + pv
                    m[j] = mx
            parts.append(_merge_partials(list(zip(m, lsum, o))))
        ms, den, num = _merge_partials(parts)
        if stats:
            out[:, q0:q0 + nr] = num
            m_out[:, q0:q0 + nr] = torch.where(
                ms == NEG_INF, ms, ms / torch.tensor(LOG2E,
                                                     dtype=torch.float32))
            l_out[:, q0:q0 + nr] = den
            continue
        den = torch.where(den == 0, torch.ones_like(den), den)
        out[:, q0:q0 + nr] = num / den[..., None]
    if stats:
        return out, m_out, l_out
    return out.to(q.dtype)


_FILLS = {}  # (rows, value, device) -> a constant (rows,) int32 fill


def _row_fill(value: int, rows: int, device) -> torch.Tensor:
    """``_row_ints`` of an int, made once a (rows, value, device) and kept:
    the launch only reads it. A fill made inside a CUDA graph's capture
    holds its value only once the graph runs, so it is not kept."""
    key = (rows, value, str(device))
    t = _FILLS.get(key)
    if t is None:
        t = _row_ints(value, rows, device)
        if not torch.cuda.is_current_stream_capturing():
            _FILLS[key] = t
    return t


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """``t``, or one copy of it when its base is not on 16 bytes (the
    tensor-core kernel's cp.async copies and 16-byte stores)."""
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _flash_launch(q, k, v, causal, q_offset, q_seq_len, kv_lens, key_mask,
                  block: int, stats: bool = False):
    """One launch of ``csrc/flash_attention.cu``; ``stats``: its output
    f32 and unnormalised, with the row statistics (``(acc, m, l)``)."""
    check_cuda_operands("flash_attention", q, k, v)
    BH, Lq, Dh = q.shape
    Lk = k.shape[1]
    cfg = launch_config(Lq, Lk, Dh, block, q.dtype, rows=BH)
    tc = cfg["kernel"] == "tensor core"
    if tc:
        q, k, v = _aligned(q), _aligned(k), _aligned(v)
    bq, bk = cfg["bq"], cfg["bk"]
    dev = q.device
    offs = (_row_fill(int(q_offset), BH, dev)
            if isinstance(q_offset, numbers.Integral)
            else _row_ints(q_offset, BH, dev))
    lens = (_row_fill(Lk, BH, dev) if kv_lens is None
            else _row_ints(kv_lens, BH, dev))
    per_batch = 1
    if key_mask is not None:
        per_batch = _rows_of(key_mask, BH)
        if (key_mask.dtype != torch.bool or key_mask.device != dev
                or not key_mask.is_contiguous()):
            key_mask = key_mask.to(device=dev, dtype=torch.bool).contiguous()
        if key_mask.shape != (BH // per_batch, Lk):
            raise ValueError(f"key_mask shape {tuple(key_mask.shape)}, "
                             f"expected ({BH // per_batch}, {Lk})")
    if stats:  # torch.empty: 16-byte aligned, as the f32 pair stores need
        out = torch.empty((BH, Lq, Dh), dtype=torch.float32, device=dev)
        m, l_ = (torch.empty((BH, Lq), dtype=torch.float32, device=dev)
                 for _ in "ml")
    else:
        out, m, l_ = torch.empty_like(q), None, None
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        (FLASH_STATS_KERNEL if stats else FLASH_KERNEL).launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            None if m is None else m.data_ptr(),
            None if l_ is None else l_.data_ptr(),
            offs.data_ptr(), lens.data_ptr(),
            None if key_mask is None else key_mask.data_ptr(),
            dtype_code(q.dtype), dtype_code(out.dtype), Dh, block, BH, Lq,
            Lk, bq, bk, q_seq_len or 0, per_batch, int(bool(causal)),
            cfg["split"], 1.0 / Dh ** 0.5, stream, tensor_core=tc,
            grid=cfg["grid"], block=(cfg["threads"],), smem=cfg["smem"],
            cluster=cfg["cluster"])
    return (out, m, l_) if stats else out


def flash_attention(
    q: torch.Tensor,  # (BH, Lq, Dh) - batch*heads flattened by the caller
    k: torch.Tensor,  # (BH, Lk, Dh)
    v: torch.Tensor,  # (BH, Lk, Dh)
    causal: bool = True,
    q_offset: Union[int, torch.Tensor] = 0,  # int, or int32 scalar / (BH,)
    block_q: Optional[int] = None,
    block_k: Optional[int] = None,
    target: Optional[HardwareTarget] = None,
    q_seq_len: Optional[int] = None,
    kv_lens: Optional[torch.Tensor] = None,  # int32 (BH,): valid keys per row
    key_mask: Optional[torch.Tensor] = None,  # bool (B, Lk), B | BH
    stats: bool = False,
):
    """``q_seq_len``: set when the query axis folds GQA groups — q rows are g
    groups of ``q_seq_len`` queries stacked, each group restarting at absolute
    position ``q_offset`` (K/V stay un-repeated at (B*Hkv, Lk, Dh)). None =
    plain contiguous positions. ``key_mask`` row i covers folded rows
    [i * BH/B, (i+1) * BH/B).

    Tiles come from ``block_q``/``block_k`` or ``attention_blocks`` for
    ``target`` (default ``H100``), clamped to the padded sequence lengths
    exactly as the reference clamps them. CUDA tensors run the kernel, CPU
    tensors :func:`flash_attention_plain`. ``stats``: the key shard's
    partial ``(acc, m, l)`` in f32 (module docstring); a ``q_offset`` may
    then be negative (the shard starts past the queries)."""
    BH, Lq, Dh = q.shape
    Lk = k.shape[1]
    if k.shape != (BH, Lk, Dh) or v.shape != k.shape:
        raise ValueError(f"q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)}: expected (BH, L, Dh) each")
    if q_seq_len is not None and q_seq_len >= Lq:
        q_seq_len = None  # a single group degenerates to plain positions
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal, q_offset, q_seq_len,
                                     kv_lens, key_mask, stats)
    tq, tk = attention_blocks(Dh, target or H100,
                              kv_word=k.element_size() / 4.0)
    block_q = block_q if block_q is not None else tq
    block_k = block_k if block_k is not None else tk
    if block_q != block_k:
        raise ValueError(f"flash_attention compiles square tiles, got "
                         f"block_q={block_q}, block_k={block_k}")
    return _flash_launch(q, k, v, causal, q_offset, q_seq_len, kv_lens,
                         key_mask, block_q, stats)


# ---------------------------------------------------------------------------
# Paged decode.
# ---------------------------------------------------------------------------

def paged_decode_plain(q: torch.Tensor, kp: torch.Tensor, vp: torch.Tensor,
                       tables: torch.Tensor, lengths: torch.Tensor
                       ) -> torch.Tensor:
    """The kernel's function in plain PyTorch: gather each row's blocks (a
    copy of the live cache, which the kernel avoids) and attend in f32 over
    all w * block_size positions, those past ``lengths`` at ``NEG_INF``."""
    B, H, _, hd = q.shape
    KV, bs = kp.shape[1], kp.shape[2]
    w = tables.shape[1]
    g = H // KV
    tables = tables.long()
    qg = q.reshape(B, KV, g, hd).float()
    kb = kp[tables].float()  # (B, w, KV, bs, hd)
    vb = vp[tables].float()
    with no_tf32():
        logits = torch.einsum("bkgd,bwksd->bkgws", qg, kb)
    logits = logits * (1.0 / hd ** 0.5)
    pos = torch.arange(w * bs, device=q.device).reshape(w, bs)
    mask = pos[None] < lengths.to(q.device).long()[:, None, None]
    logits = torch.where(mask[:, None, None], logits,
                         torch.full_like(logits, NEG_INF))
    probs = torch.softmax(logits.reshape(B, KV, g, w * bs), dim=-1)
    with no_tf32():
        o = torch.einsum("bkgws,bwksd->bkgd",
                         probs.reshape(B, KV, g, w, bs), vb)
    return o.reshape(B, H, 1, hd).to(q.dtype)


def paged_launch_config(B: int, KV: int, g: int, hd: int, bs: int, w: int,
                        dtype, capacity: Optional[int] = None) -> dict:
    """The launch of ``csrc/paged_decode.cu`` for B rows of ``w`` table slots
    of ``bs`` keys, KV kv heads of ``g`` query heads and head dim ``hd``,
    from the shapes alone (never the lengths, so the host reads nothing
    from the device): ``slots_per_cta``, the table slots each CTA of a
    (row, kv head) cluster takes in order, taken from the table
    ``capacity`` (the widest table the caller's rows can reach; default
    w): as many CTAs as bring the grid to ``PAGED_TARGET_CTAS``, at most
    ``PAGED_MAX_SPLIT`` and at most ``capacity``, then as few as take
    ``capacity`` slots in shares of that size; ``split`` S, the CTAs that
    take the w slots in those shares. A row's slots then go to the same
    CTAs, and its partials merge in the same order, at every w up to the
    capacity: its result does not depend on the table width, so not on
    which other rows share a batch;
    ``grid`` (S, KV, B) and ``cluster`` (S, 1, 1); ``ctas``; ``kernel``
    (``"tensor core"`` for bf16, ``"fma"`` for f32); ``warps``,
    ``key_tile``, ``slab`` (the keys of a tile one softmax state takes: a
    warp's 8 on the tensor cores, the whole tile on the FMA pipe) and
    ``smem`` (dynamic shared-memory bytes, as the source computes them:
    the query rows and the ring's K/V rows, padded to hd + 8 bf16 or hd + 4
    f32, and the FMA kernel's scores and softmax state). Raises
    ValueError for a shape the kernel does not take (a capacity below w
    among them), TypeError for another dtype."""
    cap = w if capacity is None else capacity
    if (hd not in PAGED_HEAD_DIMS or not 1 <= g <= PAGED_MAX_GROUP
            or min(B, KV, bs, w) < 1 or max(B, KV) > 65535 or cap < w):
        raise ValueError(f"paged_decode_attention takes hd in "
                         f"{PAGED_HEAD_DIMS}, 1 to {PAGED_MAX_GROUP} query "
                         f"heads per kv head, 1 to 65535 rows and kv "
                         f"heads and a table capacity of at least w, got "
                         f"B={B}, KV={KV}, g={g}, hd={hd}, bs={bs}, w={w}, "
                         f"capacity={cap}")
    if dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"paged_decode_attention takes float32 or bfloat16, "
                        f"not {dtype}")
    want = max(1, -(-PAGED_TARGET_CTAS // (B * KV)))
    spc = -(-cap // min(PAGED_MAX_SPLIT, cap, want))
    split = -(-w // spc)
    rows = PAGED_MAX_GROUP + PAGED_RING * 2 * PAGED_KEY_TILE
    if dtype == torch.bfloat16:
        kernel, slab = "tensor core", PAGED_KEY_TILE // PAGED_WARPS
        smem = rows * (hd + 8) * 2
    else:
        kernel, slab = "fma", PAGED_KEY_TILE
        smem = 4 * (rows * (hd + 4) + PAGED_MAX_GROUP * PAGED_KEY_TILE
                    + 3 * PAGED_MAX_GROUP)
    check_smem(smem, f"paged_decode hd={hd}")
    return dict(split=split, slots_per_cta=spc, grid=(split, KV, B),
                cluster=(split, 1, 1), ctas=split * KV * B, kernel=kernel,
                warps=PAGED_WARPS, key_tile=PAGED_KEY_TILE, slab=slab,
                smem=smem)


def paged_live_slots(length: int, w: int, bs: int) -> int:
    """The table slots the kernel loads for a row: those that start before
    its length, or all ``w`` for a row of length 0 or less, which averages
    V over them as the reference does."""
    return min(w, -(-length // bs)) if length > 0 else w


def paged_cta_keys(length: int, w: int, bs: int, split: int,
                   slots_per_cta: int) -> list:
    """The keys [k0, k1) of its row that each CTA of a cluster walks (an
    empty range for a CTA with no live slot): rank r takes slots
    [r spc, (r + 1) spc), cut at the row's live slots."""
    live = paged_live_slots(length, w, bs)
    out = []
    for r in range(split):
        j0 = r * slots_per_cta
        j1 = max(j0, min(j0 + slots_per_cta, live))
        out.append((j0 * bs, j1 * bs))
    return out


def paged_decode_tc_emulate(q: torch.Tensor, kp: torch.Tensor,
                            vp: torch.Tensor, tables: torch.Tensor,
                            lengths: torch.Tensor,
                            capacity: Optional[int] = None) -> torch.Tensor:
    """``csrc/paged_decode.cu``'s arithmetic in plain PyTorch, for the CPU
    tests only: the S CTAs of ``paged_launch_config`` (at ``capacity``),
    each over its live
    keys (:func:`paged_cta_keys`) in key tiles, one online softmax in the
    log2 domain a slab (bf16: each warp's 8 keys of a tile, P rounded to
    bf16 before P V, l summed from the f32 probabilities; f32: the whole
    tile, P in f32), the slabs' (m, l, O) merged into the CTA's partial,
    then the live CTAs' partials merged as the cluster merges them."""
    B, H, _, hd = q.shape
    KV, bs = kp.shape[1], kp.shape[2]
    w = tables.shape[1]
    g = H // KV
    cfg = paged_launch_config(B, KV, g, hd, bs, w, q.dtype, capacity)
    tc = cfg["kernel"] == "tensor core"
    kt, slab = cfg["key_tile"], cfg["slab"]
    sl2 = torch.tensor((1.0 / hd ** 0.5) * LOG2E, dtype=torch.float32)
    qg = q.reshape(B, KV, g, hd).float()
    tables = tables.long()
    out = torch.empty((B, KV, g, hd), dtype=torch.float32)
    for b in range(B):
        length = int(lengths[b])
        # the row's keys in order, (KV, w * bs, hd)
        kr = kp[tables[b]].float().permute(1, 0, 2, 3).reshape(KV, w * bs, hd)
        vr = vp[tables[b]].float().permute(1, 0, 2, 3).reshape(KV, w * bs, hd)
        parts = []
        for k0, k1 in paged_cta_keys(length, w, bs, cfg["split"],
                                     cfg["slots_per_cta"]):
            if k1 == k0:
                continue  # no live slot: not read by the merge
            states = {}  # slab offset in a tile -> (m, l, O)
            for kb in range(k0, k1, kt):
                for c0 in range(0, kt, slab):
                    lo, hi = kb + c0, min(kb + c0 + slab, k1)
                    if lo >= hi:
                        continue  # no key in the slab
                    m, lsum, o = states.get(c0, (
                        torch.full((KV, g), NEG_INF),
                        torch.zeros((KV, g)), torch.zeros((KV, g, hd))))
                    with no_tf32():
                        s = torch.einsum("kgd,knd->kgn", qg[b],
                                         kr[:, lo:hi]) * sl2
                    live = torch.arange(lo, hi) < length
                    s = torch.where(live, s, torch.full_like(s, NEG_INF))
                    mx = torch.maximum(m, s.amax(-1))
                    alpha = torch.exp2(m - mx)
                    pr = torch.exp2(s - mx[..., None])
                    lsum = alpha * lsum + pr.sum(-1)
                    if tc:
                        pr = pr.to(torch.bfloat16).float()
                    with no_tf32():
                        pv = torch.einsum("kgn,knd->kgd", pr, vr[:, lo:hi])
                    states[c0] = (mx, lsum, alpha[..., None] * o + pv)
            parts.append(_merge_partials(list(states.values())))
        m, lsum, o = _merge_partials(parts)
        lsum = torch.where(lsum == 0, torch.ones_like(lsum), lsum)
        out[b] = o / lsum[..., None]
    return out.reshape(B, H, 1, hd).to(q.dtype)


def _merge_partials(parts: list) -> tuple:
    """(m*, sum e^(m_j - m*) l_j, sum e^(m_j - m*) O_j) of the partials
    (m_j, l_j, O_j), in the log2 domain: one merge of the kernel."""
    m = torch.stack([p[0] for p in parts])
    ms = m.amax(0)
    wt = torch.exp2(m - ms)
    lsum = (wt * torch.stack([p[1] for p in parts])).sum(0)
    o = (wt[..., None] * torch.stack([p[2] for p in parts])).sum(0)
    return ms, lsum, o


def paged_decode_attention(
    q: torch.Tensor,        # (B, H, 1, hd) - one new query per sequence
    kp: torch.Tensor,       # (num_blocks, KV, block_size, hd) - key pool
    vp: torch.Tensor,       # (num_blocks, KV, block_size, hd) - value pool
    tables: torch.Tensor,   # (B, w) int32 - physical block ids per sequence
    lengths: torch.Tensor,  # (B,) int32 - valid cache length per sequence
    capacity: Optional[int] = None,  # the widest table a row can reach
) -> torch.Tensor:
    """Decode attention that reads K/V directly out of the paged pool: each
    sequence moves exactly its own ``w * block_size`` cached keys/values
    once, with no repeated GQA heads and no gathered copy. Query heads are
    grouped per kv head (h = kv * g + i). CUDA tensors run the kernel, CPU
    tensors :func:`paged_decode_plain`. ``capacity`` (default w) sets the
    split over table slots (:func:`paged_launch_config`): a caller whose
    table width varies from call to call (the serving engine's follows its
    deepest row) passes its table capacity, so that a row's result does not
    depend on the width."""
    B, H, Lq, hd = q.shape
    if Lq != 1:
        raise ValueError(f"paged decode takes one query per row, got Lq={Lq}")
    if q.device.type == "cpu":
        return paged_decode_plain(q, kp, vp, tables, lengths)
    q = q.contiguous()
    check_cuda_operands("paged_decode_attention", q, kp, vp)
    KV, bs = kp.shape[1], kp.shape[2]
    w = tables.shape[1]
    g = H // KV
    if H % KV:
        raise ValueError(f"paged_decode_attention: H={H} query heads do not "
                         f"fold over KV={KV} kv heads")
    cfg = paged_launch_config(B, KV, g, hd, bs, w, q.dtype, capacity)
    q, kp, vp = _aligned(q), _aligned(kp), _aligned(vp)
    dev = q.device
    tables = tables.to(device=dev, dtype=torch.int32).contiguous()
    lengths = lengths.to(device=dev, dtype=torch.int32).contiguous()
    if tables.shape != (B, w) or lengths.shape != (B,):
        raise ValueError(f"tables {tuple(tables.shape)}, lengths "
                         f"{tuple(lengths.shape)}: expected ({B}, w), ({B},)")
    out = torch.empty((B, H, 1, hd), dtype=q.dtype, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        PAGED_KERNEL.launch(
            q.data_ptr(), kp.data_ptr(), vp.data_ptr(), tables.data_ptr(),
            lengths.data_ptr(), out.data_ptr(), dtype_code(q.dtype), hd, B,
            KV, g, bs, w, w if capacity is None else capacity,
            1.0 / hd ** 0.5, stream,
            tensor_core=cfg["kernel"] == "tensor core", grid=cfg["grid"],
            block=(32 * cfg["warps"],), smem=cfg["smem"],
            cluster=cfg["cluster"])
    return out


# ---------------------------------------------------------------------------
# Measured HBM traffic, in 32-bit words, from launch geometry (shape-only).
# ---------------------------------------------------------------------------

def attention_hbm_words(BH: int, Lq: int, Lk: int, dh: int,
                        block_q: int, block_k: int,
                        p_q: float = 1.0, p_kv: float = 1.0,
                        p_o: float = 1.0) -> float:
    """Words the flash launch moves: q tiles once, k/v streamed once per q
    tile (once per row when the keys fit one tile), o stored once — at the
    kernel's clamped and padded tiles. The int32 offsets, lengths and the
    key mask (O(BH + B*Lk) against O(BH*L*dh)) are not charged, as the
    reference leaves its scalar-prefetch operands uncharged."""
    bq = min(block_q, round_up(Lq, 8))
    bk = min(block_k, round_up(Lk, 8))
    lqp, lkp = round_up(Lq, bq), round_up(Lk, bk)
    n_q, n_k = lqp // bq, lkp // bk
    kv_fetches = n_q if n_k > 1 else 1
    return (p_q * BH * lqp * dh
            + 2.0 * p_kv * BH * kv_fetches * lkp * dh
            + p_o * BH * lqp * dh)


def attention_stats_hbm_words(BH: int, Lq: int, Lk: int, dh: int,
                              block_q: int, block_k: int, p_q: float = 1.0,
                              p_kv: float = 1.0) -> float:
    """Words a flash launch with statistics moves (the port's counter; the
    reference's kernel has no such launch): :func:`attention_hbm_words`
    with the f32 accumulator stored (``p_o = 1``), plus the row max and
    row sum, one f32 word each a folded query row, at the same padded
    rows."""
    lqp = round_up(Lq, min(block_q, round_up(Lq, 8)))
    return (attention_hbm_words(BH, Lq, Lk, dh, block_q, block_k, p_q=p_q,
                                p_kv=p_kv, p_o=1.0)
            + 2.0 * BH * lqp)


def attention_split_hbm_words(BH: int, Lq: int, Lk: int, dh: int,
                              block_q: int, block_k: int, p_q: float = 1.0,
                              p_kv: float = 1.0, p_o: float = 1.0,
                              stats: bool = False) -> float:
    """Words a flash launch moves as :func:`launch_config` walks it, key
    split included (the port's counter; bf16 when ``p_q`` is 0.5, where
    the tensor-core kernel splits): Q once a q tile (under a split rank 0
    reads it and the other ranks copy it through distributed shared
    memory), K and V of each rank's key tiles (:func:`split_tiles`) once a
    q tile (once a row when resident), O once a q tile; ``stats``: O in f32
    and the row max and sum, one f32 word each a folded query row. Equal
    to :func:`attention_hbm_words` (:func:`attention_stats_hbm_words` with
    ``stats``) at every shape: a split moves no extra word."""
    if block_k != block_q:
        raise ValueError(f"flash_attention compiles square tiles, got "
                         f"block_q={block_q}, block_k={block_k}")
    cfg = launch_config(Lq, Lk, dh, block_q, _dtype_of(p_q))
    bq, bk, n_q, n_k = cfg["bq"], cfg["bk"], cfg["n_q"], cfg["n_k"]
    kv_fetches = 1 if cfg["kv_resident"] else n_q
    tiles = sum(t1 - t0 for t0, t1 in split_tiles(n_k, cfg["split"]))
    words = (p_q * BH * n_q * bq * dh
             + 2.0 * p_kv * BH * kv_fetches * tiles * bk * dh)
    if stats:
        return words + BH * n_q * bq * (dh + 2.0)
    return words + p_o * BH * n_q * bq * dh


def paged_decode_issued_words(lengths, B: int, KV: int, g: int, w: int,
                              block_size: int, hd: int, p_q: float = 1.0,
                              p_kv: float = 1.0, p_o: float = 1.0) -> float:
    """Words ``csrc/paged_decode.cu`` issues for one step with these
    ``lengths``: each (row, kv head) cluster loads its (g, hd) query group
    once (rank 0; the other ranks copy it through distributed shared
    memory), k and v of the row's live slots only (:func:`paged_live_slots`)
    and stores the group once; no partial leaves the cluster. The int32
    table entries of the live slots and the lengths count 1 word each once
    a row, as :func:`paged_decode_hbm_words` counts the whole tables (the KV
    clusters of a row re-read them from the L2). At most that counter, and
    equal to it when every row's slots are all live."""
    live = sum(paged_live_slots(int(n), w, block_size) for n in lengths)
    return (p_q * B * KV * g * hd
            + 2.0 * p_kv * KV * live * block_size * hd
            + p_o * B * KV * g * hd
            + live + B)


def paged_decode_hbm_words(B: int, KV: int, g: int, w: int, block_size: int,
                           hd: int, p_q: float = 1.0, p_kv: float = 1.0,
                           p_o: float = 1.0) -> float:
    """Words one paged decode step moves: each (row, kv head) loads its
    (g, hd) query group, streams w blocks of k and v once, stores the group —
    plus the int32 block tables and lengths (1 word each)."""
    return (p_q * B * KV * g * hd
            + 2.0 * p_kv * B * KV * w * block_size * hd
            + p_o * B * KV * g * hd
            + B * w + B)


# ---------------------------------------------------------------------------
# Access plans (repro_torch.verify): the launches as structured data.
# ---------------------------------------------------------------------------

def _dtype_of(p: float):
    return torch.bfloat16 if p == 0.5 else torch.float32


def _flash_walk(prog, n_k: int, base: int, q_step: int, resident: bool,
                rank: int = 0) -> None:
    """``flash_tc_kernel``'s walk of ``n_k`` K/V tiles into ``prog``: tile
    kt runs ``wait_group(0)``, ``__syncthreads``, issues tile kt + 1 into
    slot (kt + 1) % 2 (none when ``resident``), reads Q (step ``q_step``,
    at kt = 0) and slot kt % 2 (step ``base + kt``)."""
    for kt in range(n_k):
        prog.wait_group(0, rank=rank)
        prog.barrier(rank=rank)
        if not resident and kt + 1 < n_k:
            prog.start("k/v", (kt + 1) % 2, base + kt + 1, rank=rank)
        prog.commit(rank=rank)
        if kt == 0:
            prog.read("q", 0, q_step, rank=rank)
        prog.read("k/v", kt % 2, base + kt, rank=rank)


def _flash_merge(prog, step: int, rank: int = 0) -> None:
    """The key slabs' merge (C > 1) of q tile ``step``: slabs 1 .. C - 1
    write the merge area, slab 0 reads it after a ``__syncthreads``."""
    prog.write("merge", 0, step, rank=rank)
    prog.barrier(rank=rank)
    prog.read("merge", 0, step, rank=rank)


def flash_program(n_q_cta: int, n_k: int, resident: bool, merge: bool,
                  staged: bool = True):
    """``flash_tc_kernel``'s events for one CTA walking ``n_q_cta`` q tiles:
    each opens with a ``__syncthreads`` (the previous tile's output was
    staged in Q's rows) and issues its Q tile and K/V tile 0 (K/V only at
    the first q tile when ``resident``) in one commit group; then K/V tile
    kt runs ``wait_group(0)``, ``__syncthreads``, issues tile kt + 1 into
    slot (kt + 1) % 2, reads Q (at kt = 0) and slot kt % 2; with C > 1 key
    slabs (``merge``) slabs 1 .. C - 1 write the merge area and slab 0
    reads it after a ``__syncthreads``; slab 0 stages its output rows in
    its own Q rows (a warp's own rows: ``__syncwarp``), unless the output
    is f32 (not ``staged``: slab 0 stores it from its registers); a
    ``wait_group(0)`` at exit."""
    from repro_torch.verify.hazards import Program

    prog = Program()
    span = n_k + n_k % 2  # K/V steps a q tile (kept even: slot = step % 2)
    for i in range(n_q_cta):
        base = 0 if resident else i * span
        prog.barrier()
        prog.start("q", 0, 2 * i)
        if not resident or i == 0:
            prog.start("k/v", 0, base)
        prog.commit()
        _flash_walk(prog, n_k, base, 2 * i, resident)
        if merge:
            _flash_merge(prog, i)
        if staged:
            prog.write("q", 0, 2 * i + 1, local=not merge)
            prog.read("q", 0, 2 * i + 1, local=True)
    prog.wait_group(0)
    return prog


def flash_split_program(tiles, merge: bool, staged: bool = True):
    """``flash_tc_kernel``'s events for one row's cluster of a key split,
    ``tiles[r]`` key tiles for rank r: after the opening ``__syncthreads``
    rank 0 issues the Q tile in a commit group of its own (empty in the
    others), every rank with a tile its first K/V tile in the next;
    ``wait_group(1)`` and the first ``cluster.sync``; each other rank with
    a tile copies Q from rank 0's shared memory into its own; then the
    rank's walk as :func:`flash_program`'s; the key slabs' merge
    (``merge``); a ``__syncthreads`` and ranks 1 .. S - 1 write their
    partial over ring slot 0; the second ``cluster.sync``; rank 0 reads
    the other ranks' partials; the third ``cluster.sync``; rank 0 stages
    its output rows (``staged``); ``wait_group(0)``; exit."""
    from repro_torch.verify.hazards import Program

    prog = Program()
    for r, n in enumerate(tiles):
        prog.barrier(rank=r)
        if r == 0:
            prog.start("q", 0, 0, rank=r)
        prog.commit(rank=r)
        if n:
            prog.start("k/v", 0, 0, rank=r)
        prog.commit(rank=r)
        prog.wait_group(1, rank=r)
        prog.cluster_sync(rank=r)
        if r and n:
            prog.remote_read("q", 0, 0, rank=r, peer=0)
            prog.write("q", 0, 0, rank=r)
        _flash_walk(prog, n, 0, 0, False, rank=r)
        if merge:
            _flash_merge(prog, 0, rank=r)
        prog.barrier(rank=r)
        if r:
            prog.write("k/v", 0, -1, rank=r)  # the partial, over slot 0
        prog.cluster_sync(rank=r)
        if r == 0:
            for k in range(1, len(tiles)):
                prog.remote_read("k/v", 0, -1, rank=r, peer=k)
        prog.cluster_sync(rank=r)
        if staged and r == 0:
            prog.write("q", 0, 1, rank=r, local=not merge)
            prog.read("q", 0, 1, rank=r, local=True)
        prog.wait_group(0, rank=r)
        prog.exit(rank=r)
    return prog


def flash_attention_access_plan(BH: int, Lq: int, Lk: int, dh: int,
                                block_q: int, block_k: int,
                                p_q: float = 1.0, p_kv: float = 1.0,
                                p_o: float = 1.0, dynamic: bool = False,
                                op: str = "attention", stats: bool = False):
    """The :class:`repro_torch.verify.access.KernelAccessPlan` of one flash
    launch over the folded (BH, Lq) view, as :func:`launch_config` gives it
    (bf16 when ``p_q`` is 0.5: ``flash_tc_kernel``; else the FMA
    ``flash_kernel``). The walk: CTAs (row, q tile) with the K/V tiles
    innermost, or, when the keys fit one tile, one CTA a row walking its q
    tiles with K/V resident. Counted: Q once a q tile, K and V once a
    (q tile, K/V tile) step (once a row when resident), O once a q tile;
    uncounted: the int32 offset and length every CTA reads (the wrapper
    always passes both; ``dynamic`` is kept for the reference's signature).
    The key mask of padded prefill is not modeled. ``stats``: the launch
    with row statistics (:func:`attention_stats_hbm_words`): O stored in
    f32 (``p_o`` 1) from the registers, and the row max and sum once a q
    tile. Under a key split (``launch_config``'s S > 1) the walk is
    (row, rank, the rank's K/V tiles): Q, O and the statistics once a row
    (rank 0 reads Q, the other ranks copy it through distributed shared
    memory), K and V of each rank's tiles, the offset and length once a
    CTA, and one schedule for a row's cluster
    (:func:`flash_split_program`). Raises ValueError for a (dh, block) the
    source does not compile."""
    import numpy as np

    from repro_torch.verify.access import (BlockAccess, CudaLaunch,
                                           FlatAccess, KernelAccessPlan,
                                           ScratchAlloc, WindowAccess)

    if block_q != block_k:
        raise ValueError(f"flash_attention compiles square tiles, got "
                         f"block_q={block_q}, block_k={block_k}")
    cfg = launch_config(Lq, Lk, dh, block_q, _dtype_of(p_q), rows=BH)
    bq, bk, n_q, n_k = cfg["bq"], cfg["bk"], cfg["n_q"], cfg["n_k"]
    lqp, lkp = n_q * bq, n_k * bk
    resident = cfg["kv_resident"]
    tc = cfg["kernel"] == "tensor core"
    S = cfg["split"]
    shares = np.array(split_tiles(n_k, S), dtype=np.int64).reshape(S, 2)
    # a split's walk is (row, rank, tile): its one q tile moves once a row
    q_idx = ((lambda b, r, t: (b, 0, 0)) if S > 1 else
             (lambda b, i, t: (b, t, 0)) if resident else
             (lambda b, i, t: (b, i, 0)))
    if stats:
        p_o = 1.0
    accesses = [
        BlockAccess(name="q", kind="load", block_shape=(1, bq, dh),
                    array_shape=(BH, lqp, dh), word_size=p_q,
                    index_map=q_idx),
        BlockAccess(name="out", kind="store", block_shape=(1, bq, dh),
                    array_shape=(BH, lqp, dh), word_size=p_o,
                    index_map=q_idx),
    ]
    if stats:
        accesses += [BlockAccess(
            name=name, kind="store", block_shape=(1, bq),
            array_shape=(BH, lqp), word_size=1.0,
            index_map=lambda b, i, t: q_idx(b, i, t)[:2])
            for name in ("row max", "row sum")]

    def split_window(b, r, t):  # rank r's t-th tile, none past its share
        t0, t1 = shares[r, 0], shares[r, 1]
        rows = np.where(t0 + t < t1, bk, 0)
        return (b, 1), (np.where(rows > 0, (t0 + t) * bk, 0), rows), (0, dh)

    for name in ("k", "v"):
        if S > 1:
            accesses.append(WindowAccess(
                name=name, kind="load", array_shape=(BH, lkp, dh),
                word_size=p_kv, window=split_window,
                note="the key tiles of each rank's share"))
        elif resident:
            accesses.append(BlockAccess(
                name=name, kind="load", block_shape=(1, bk, dh),
                array_shape=(BH, lkp, dh), word_size=p_kv,
                index_map=lambda b, i, t: (b, 0, 0),
                note="the row's one tile, resident across its q tiles"))
        else:
            accesses.append(WindowAccess(
                name=name, kind="load", array_shape=(BH, lkp, dh),
                word_size=p_kv,
                window=lambda b, i, t: ((b, 1), (t * bk, bk), (0, dh))))
    accesses.append(FlatAccess(
        name="q_offset/kv_lens", kind="load", words=2.0 * cfg["ctas"],
        counted=False, note="one int32 offset and length a CTA"))
    walk = (BH, 1, n_q) if resident else (BH, n_q, n_k)
    if S > 1:
        walk = (BH, S, int((shares[:, 1] - shares[:, 0]).max()))
    dma = None
    if tc:
        r, c = cfg["warp_grid"]
        tile = block_q * cfg["pitch"] * 2
        scratch = (ScratchAlloc("q tile", tile / 4.0),
                   ScratchAlloc(f"k/v ring[{cfg['slots']}]",
                                2 * cfg["slots"] * tile / 4.0),
                   ScratchAlloc("merge (m, l, O)",
                                (cfg["smem"] - (1 + 2 * cfg["slots"]) * tile)
                                / 4.0))
        if S > 1:
            prog = flash_split_program(
                [int(t1 - t0) for t0, t1 in shares], c > 1, staged=not stats)
        else:
            prog = flash_program(n_q if resident else 1, n_k, resident,
                                 c > 1, staged=not stats)
        bufs = {"q": 1, "k/v": cfg["slots"]}
        if c > 1:
            bufs["merge"] = 1
        dma = prog.schedules(bufs, cfg["warps"], op)
        kernel = "flash_tc_kernel"
    else:
        scratch = (ScratchAlloc("q, k, v, scores, state",
                                cfg["smem"] / 4.0),)
        kernel = "flash_kernel"
    return KernelAccessPlan(
        op=op, grid=walk, accesses=tuple(accesses), scratch=scratch,
        dma=dma, launch=CudaLaunch(kernel, (*cfg["grid"], 1),
                                   (cfg["threads"], 1, 1), cfg["smem"],
                                   cfg["cluster"]),
        note="K/V tiles (or, resident, q tiles) innermost"
        + (f"; clusters of {S} ranks" if S > 1 else ""))


def paged_program(tiles, tc: bool):
    """The events of one cluster of ``paged_decode_tc_kernel`` (``tc``) or
    ``paged_decode_fma_kernel``, ``tiles[r]`` key tiles for rank r: rank 0
    issues the query group (its own commit group; empty in the others),
    every rank the ring's prologue (tiles 0 .. RING - 2, a group each);
    ``wait_group(RING - 1)`` and the first ``cluster.sync``; each other
    live rank copies the group from rank 0's shared memory; tile t runs
    ``wait_group(RING - 2)``, ``__syncthreads``, issues tile t + RING - 1
    into slot (t - 1) % RING, reads the query (t = 0) and slot t % RING;
    a live rank then, after a ``__syncthreads``, writes its partial over
    the ring (bf16: the 4 warps' partials, a ``__syncthreads``, the CTA's
    behind them); the second ``cluster.sync``; rank 0 reads the live
    ranks' partials; the third ``cluster.sync``; ``wait_group(0)``; exit."""
    from repro_torch.verify.hazards import Program

    R = PAGED_RING
    live = sum(1 for t in tiles if t > 0)
    prog = Program()
    for r, n in enumerate(tiles):
        if r == 0:
            prog.start("q", 0, 0, rank=r)
        prog.commit(rank=r)
        for t in range(R - 1):
            if t < n:
                prog.start("ring", t % R, t, rank=r)
            prog.commit(rank=r)
        prog.wait_group(R - 1, rank=r)
        prog.cluster_sync(rank=r)
        if r and n:
            prog.remote_read("q", 0, 0, rank=r, peer=0)
            prog.write("q", 0, 0, rank=r)
        for t in range(n):
            prog.wait_group(R - 2, rank=r)
            prog.barrier(rank=r)
            if t + R - 1 < n:
                prog.start("ring", (t + R - 1) % R, t + R - 1, rank=r)
            prog.commit(rank=r)
            if t == 0:
                prog.read("q", 0, 0, rank=r)
            prog.read("ring", t % R, t, rank=r)
        if n:
            prog.barrier(rank=r)
            for s in range(R):  # the partials lie over the ring's slots
                prog.write("ring", s, -1 - s, rank=r)
            if tc:
                prog.write("warp partials", 0, 0, rank=r)
                prog.barrier(rank=r)
                prog.read("warp partials", 0, 0, rank=r)
            prog.write("part", 0, 0, rank=r)
        prog.cluster_sync(rank=r)
        if r == 0:
            for k in range(live):
                prog.remote_read("part", 0, 0, rank=r, peer=k)
        prog.cluster_sync(rank=r)
        prog.wait_group(0, rank=r)
        prog.exit(rank=r)
    return prog


def paged_decode_access_plan(B: int, KV: int, g: int, w: int,
                             block_size: int, hd: int, num_blocks: int,
                             p_q: float = 1.0, p_kv: float = 1.0,
                             p_o: float = 1.0, tables=None,
                             op: str = "attention_decode", lengths=None,
                             capacity: Optional[int] = None):
    """The :class:`repro_torch.verify.access.KernelAccessPlan` of one paged
    decode launch, as :func:`paged_launch_config` gives it at ``capacity``
    (bf16 when ``p_q`` is 0.5). The walk: the (S, KV, B) grid's CTAs
    (rank fastest) with each CTA's key tiles innermost. Counted: the query group once a
    cluster (rank 0 reads it; the others copy it from rank 0's shared
    memory), K and V of the key tiles each rank walks, read through the
    table (a window of the row's logical keys), the output group once a
    cluster, the live slots' table entries and the lengths. With
    ``lengths`` unknown (None: meta tensors, ``explain``) every slot is
    live; with concrete ``lengths`` the kernel skips the slots wholly past
    a row's length (:func:`paged_live_slots`), and their K/V and table
    words are ``skipped``: the audit's shortfall, which equals
    ``paged_decode_hbm_words - paged_decode_issued_words``. ``tables``
    (concrete) is checked for live entries inside the pool."""
    import numpy as np

    from repro_torch.verify.access import (BlockAccess, CudaLaunch,
                                           FlatAccess, KernelAccessPlan,
                                           ScratchAlloc, WindowAccess)

    bs = block_size
    cfg = paged_launch_config(B, KV, g, hd, bs, w, _dtype_of(p_q), capacity)
    S, spc = cfg["split"], cfg["slots_per_cta"]
    if lengths is None:
        live = np.full(B, w, dtype=np.int64)
    else:
        live = np.array([paged_live_slots(int(n), w, bs) for n in lengths],
                        dtype=np.int64)
    if tables is not None:
        t_np = np.asarray(tables, dtype=np.int64).reshape(B, w)
        used = np.arange(w)[None, :] < live[:, None]
        bad = used & ((t_np < 0) | (t_np >= num_blocks))
        if bad.any():
            raise ValueError(f"paged decode table entries {t_np[bad][:4]} "
                             f"lie outside the pool of {num_blocks} blocks")
    T = -(-spc * bs // PAGED_KEY_TILE)
    j0 = np.arange(S)[None, :] * spc
    j1 = np.maximum(j0, np.minimum(j0 + spc, live[:, None]))  # (B, S)
    k0, k1 = np.broadcast_to(j0 * bs, (B, S)), j1 * bs

    def kv_window(b, h, r, t):
        kb = k0[b, r] + t * PAGED_KEY_TILE
        rows = np.clip(k1[b, r] - kb, 0, PAGED_KEY_TILE)
        return (b, 1), (h, 1), (np.where(rows > 0, kb, 0), rows), (0, hd)

    accesses = [
        BlockAccess(name="q", kind="load", block_shape=(1, 1, g, hd),
                    array_shape=(B, KV, g, hd), word_size=p_q,
                    index_map=lambda b, h, r, t: (b, h, 0, 0),
                    note="rank 0 reads it; the others copy it through "
                         "distributed shared memory"),
        WindowAccess(name="k_pool", kind="load",
                     array_shape=(B, KV, w * bs, hd), word_size=p_kv,
                     window=kv_window,
                     note="the row's logical keys, read through its table"),
        WindowAccess(name="v_pool", kind="load",
                     array_shape=(B, KV, w * bs, hd), word_size=p_kv,
                     window=kv_window),
        BlockAccess(name="out", kind="store", block_shape=(1, 1, g, hd),
                    array_shape=(B, KV, g, hd), word_size=p_o,
                    index_map=lambda b, h, r, t: (b, h, 0, 0)),
        FlatAccess(name="tables", kind="load", words=float(live.sum()),
                   note="int32 entries of the live slots, once a row"),
        FlatAccess(name="lengths", kind="load", words=float(B)),
    ]
    dead = B * w - int(live.sum())
    skipped = ()
    if dead:
        skipped = (
            FlatAccess(name="dead slots' k/v", kind="load",
                       words=2.0 * p_kv * KV * dead * bs * hd),
            FlatAccess(name="dead slots' table entries", kind="load",
                       words=float(dead)),
        )
    tc = cfg["kernel"] == "tensor core"
    tiles = -(-(k1 - k0) // PAGED_KEY_TILE)  # (B, S)
    bufs = {"q": 1, "ring": PAGED_RING, "part": 1}
    if tc:
        bufs["warp partials"] = 1
    dma = tuple(
        s for pattern in sorted({tuple(int(v) for v in row)
                                 for row in tiles})
        for s in paged_program(pattern, tc).schedules(
            bufs, cfg["warps"], f"{op} (tiles {pattern})"))
    return KernelAccessPlan(
        op=op, grid=(B, KV, S, T), accesses=tuple(accesses),
        scratch=(ScratchAlloc("query rows, k/v ring (partials after the "
                              "walk)", cfg["smem"] / 4.0),),
        dma=dma, skipped=skipped,
        launch=CudaLaunch("paged_decode_tc_kernel" if tc
                          else "paged_decode_fma_kernel",
                          (S, KV, B), (32 * cfg["warps"], 1, 1),
                          cfg["smem"], cfg["cluster"]),
        note="key tiles innermost; clusters of S ranks")
