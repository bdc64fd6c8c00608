"""Blocked (flash-style) attention and paged decode: the port of
``repro.kernels.flash_attention``.

Attention's two GEMMs (QK^T and PV) are 7NL degenerates; the paper's capacity
argument picks the (block_q, block_k) pair (``attention_blocks``, the closed
form ``core.tiling.attention_block_size`` the planner's attention plans use).
GQA is handled by folding the g query heads of one KV head into the query
axis, so K/V stream at their un-repeated size.

On CUDA tensors, :func:`flash_attention` launches ``csrc/flash_attention.cu``
(the reference's ``_flash_kernel`` and ``_flash_kernel_dyn`` in one kernel:
offsets and lengths are int32 device arrays, static ones constant arrays)
and :func:`paged_decode_attention` launches ``csrc/paged_decode.cu`` (the
reference's ``_paged_decode_kernel``). On CPU tensors each runs its plain
PyTorch version (:func:`flash_attention_plain`, :func:`paged_decode_plain`).
There is no fallback between the two.

Masking follows the reference's finite ``NEG_INF = -1e30``: a query row whose
keys are all masked averages V over its keys, giving neither zeros nor NaN.
Keys past the array's end (the kernel's ragged tile edge) get zero weight.

``attention_hbm_words`` / ``paged_decode_hbm_words`` are the reference's
counters, unchanged: the words one launch moves, from its launch geometry.
"""

from __future__ import annotations

import ctypes
import numbers
from typing import Optional, Tuple, Union

import torch

from repro_torch.core.conv_model import round_up
from repro_torch.core.tiling import attention_block_size
from repro_torch.plan import H100, HardwareTarget

from ._build import CudaKernel, check_cuda_operands, dtype_code
from .ref import no_tf32

NEG_INF = -1e30

_c = ctypes
FLASH_KERNEL = CudaKernel("flash_attention.cu", "repro_flash_attention", [
    _c.c_void_p, _c.c_void_p, _c.c_void_p, _c.c_void_p,  # q, k, v, out
    _c.c_void_p, _c.c_void_p, _c.c_void_p,               # offsets, lens, mask
    _c.c_int, _c.c_int, _c.c_int,                        # dtype, hd, block
    _c.c_longlong, _c.c_int, _c.c_int,                   # rows, Lq, Lk
    _c.c_int, _c.c_int,                                  # bq, bk
    _c.c_int, _c.c_int, _c.c_int,                        # q_seq_len, rows/batch, causal
    _c.c_float, _c.c_void_p,                             # scale, stream
])
PAGED_KERNEL = CudaKernel("paged_decode.cu", "repro_paged_decode", [
    _c.c_void_p, _c.c_void_p, _c.c_void_p,               # q, kp, vp
    _c.c_void_p, _c.c_void_p, _c.c_void_p,               # tables, lengths, out
    _c.c_int, _c.c_int,                                  # dtype, hd
    _c.c_int, _c.c_int, _c.c_int, _c.c_int, _c.c_int,    # B, KV, g, bs, w
    _c.c_float, _c.c_void_p,                             # scale, stream
])
# the (hd, block) instances compiled into csrc/flash_attention.cu; every H100
# plan for hd in {16, 32, 64, 128} at bf16 or f32 K/V is one of them
FLASH_INSTANCES = frozenset(
    [(hd, b) for hd in (16, 32) for b in (32, 64, 128)]
    + [(hd, b) for hd in (64, 128) for b in (32, 64)])
PAGED_HEAD_DIMS = (16, 32, 64, 128)
PAGED_MAX_GROUP = 16  # query heads per kv head (csrc/paged_decode.cu G_MAX)


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
) -> torch.Tensor:
    """The kernel's function in plain PyTorch: f32 logits and softmax over
    all Lk keys, masked keys at ``NEG_INF``."""
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
    p = torch.softmax(s, dim=-1)
    with no_tf32():
        return torch.einsum("bqk,bkd->bqd", p, v.float()).to(q.dtype)


def _flash_launch(q, k, v, causal, q_offset, q_seq_len, kv_lens, key_mask,
                  block: int, bq: int, bk: int) -> torch.Tensor:
    check_cuda_operands("flash_attention", q, k, v)
    BH, Lq, Dh = q.shape
    Lk = k.shape[1]
    if (Dh, block) not in FLASH_INSTANCES:
        raise ValueError(
            f"flash_attention: no compiled kernel for hd={Dh}, block={block} "
            f"(compiled: {sorted(FLASH_INSTANCES)}); plan for the H100 target")
    dev = q.device
    offs = _row_ints(q_offset, BH, dev)
    lens = _row_ints(Lk if kv_lens is None else kv_lens, BH, dev)
    per_batch = 1
    if key_mask is not None:
        per_batch = _rows_of(key_mask, BH)
        key_mask = key_mask.to(device=dev, dtype=torch.bool).contiguous()
        if key_mask.shape != (BH // per_batch, Lk):
            raise ValueError(f"key_mask shape {tuple(key_mask.shape)}, "
                             f"expected ({BH // per_batch}, {Lk})")
    out = torch.empty_like(q)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        FLASH_KERNEL.launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            offs.data_ptr(), lens.data_ptr(),
            None if key_mask is None else key_mask.data_ptr(),
            dtype_code(q.dtype), Dh, block, BH, Lq, Lk, bq, bk,
            q_seq_len or 0, per_batch, int(bool(causal)), 1.0 / Dh ** 0.5,
            stream)
    return out


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
) -> torch.Tensor:
    """``q_seq_len``: set when the query axis folds GQA groups — q rows are g
    groups of ``q_seq_len`` queries stacked, each group restarting at absolute
    position ``q_offset`` (K/V stay un-repeated at (B*Hkv, Lk, Dh)). None =
    plain contiguous positions. ``key_mask`` row i covers folded rows
    [i * BH/B, (i+1) * BH/B).

    Tiles come from ``block_q``/``block_k`` or ``attention_blocks`` for
    ``target`` (default ``H100``), clamped to the padded sequence lengths
    exactly as the reference clamps them. CUDA tensors run the kernel, CPU
    tensors :func:`flash_attention_plain`."""
    BH, Lq, Dh = q.shape
    Lk = k.shape[1]
    if k.shape != (BH, Lk, Dh) or v.shape != k.shape:
        raise ValueError(f"q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)}: expected (BH, L, Dh) each")
    if q_seq_len is not None and q_seq_len >= Lq:
        q_seq_len = None  # a single group degenerates to plain positions
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal, q_offset, q_seq_len,
                                     kv_lens, key_mask)
    tq, tk = attention_blocks(Dh, target or H100,
                              kv_word=k.element_size() / 4.0)
    block_q = block_q if block_q is not None else tq
    block_k = block_k if block_k is not None else tk
    if block_q != block_k:
        raise ValueError(f"flash_attention compiles square tiles, got "
                         f"block_q={block_q}, block_k={block_k}")
    bq = min(block_q, round_up(Lq, 8))
    bk = min(block_k, round_up(Lk, 8))
    return _flash_launch(q, k, v, causal, q_offset, q_seq_len, kv_lens,
                         key_mask, block_q, bq, bk)


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


def paged_decode_attention(
    q: torch.Tensor,        # (B, H, 1, hd) - one new query per sequence
    kp: torch.Tensor,       # (num_blocks, KV, block_size, hd) - key pool
    vp: torch.Tensor,       # (num_blocks, KV, block_size, hd) - value pool
    tables: torch.Tensor,   # (B, w) int32 - physical block ids per sequence
    lengths: torch.Tensor,  # (B,) int32 - valid cache length per sequence
) -> torch.Tensor:
    """Decode attention that reads K/V directly out of the paged pool: each
    sequence moves exactly its own ``w * block_size`` cached keys/values
    once, with no repeated GQA heads and no gathered copy. Query heads are
    grouped per kv head (h = kv * g + i). CUDA tensors run the kernel, CPU
    tensors :func:`paged_decode_plain`."""
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
    if hd not in PAGED_HEAD_DIMS or g > PAGED_MAX_GROUP or H % KV:
        raise ValueError(f"paged_decode_attention takes hd in "
                         f"{PAGED_HEAD_DIMS} and at most {PAGED_MAX_GROUP} "
                         f"query heads per kv head, got hd={hd}, H={H}, "
                         f"KV={KV}")
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
            KV, g, bs, w, 1.0 / hd ** 0.5, stream)
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
