"""Shared neural layers: norms, RoPE, SwiGLU, GQA attention with KV cache
(the counterpart of ``repro.models.layers``).

Parameters live in ``nn.Module``s whose leaves carry the reference's names
and layouts (``wq`` is (d_model, H*hd) and multiplies from the right), so
``repro_torch.convert`` maps the JAX tree onto them leaf by leaf. Weights are
kept in ``cfg.param_dtype`` and cast to ``cfg.compute_dtype`` at use (a copy
made once, ``transformer.compute_params``, computes the same values);
attention logits/softmax and all reductions accumulate in f32.

KV caches are updated in place: the JAX functions return new arrays, the
port writes the cache tensors it was given and returns them, which saves a
copy of every layer's cache per step.
"""

from __future__ import annotations

import dataclasses
import numbers
from typing import Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from repro_torch import dtensors, ops
from repro_torch.ops import ExecutionContext

from . import spmd


def dtype_of(name: str) -> torch.dtype:
    """``"bfloat16"`` -> ``torch.bfloat16`` (config dtype names)."""
    return getattr(torch, name)


def truncated_normal_(t: torch.Tensor, std: float,
                      generator: Optional[torch.Generator]) -> torch.Tensor:
    """In place: std * a normal truncated to [-2, 2], as the reference."""
    with torch.no_grad():
        nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0, generator=generator)
        return t.mul_(std)


def _param(shape, std, dtype, device, generator) -> nn.Parameter:
    t = torch.empty(shape, dtype=torch.float32, device=device)
    return nn.Parameter(truncated_normal_(t, std, generator).to(dtype))


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------

def rms_norm(x: torch.Tensor, scale: torch.Tensor,
             eps: float = 1e-5) -> torch.Tensor:
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps) * scale.float()
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------

def rope_freqs(hd: int, theta: float, device=None) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, hd, 2, dtype=torch.float32,
                                         device=device) / hd))


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: (B, H, L, hd); positions: (L,) or (B, L). The head dim splits
    into halves (not interleaved pairs), as in the reference."""
    hd = x.shape[-1]
    inv = rope_freqs(hd, theta, x.device)  # (hd/2,)
    if positions.ndim == 1:
        ang = positions[:, None].float() * inv[None, :]  # (L, hd/2)
        ang = ang[None, None]  # (1, 1, L, hd/2)
    else:
        ang = positions[:, :, None].float() * inv[None, None, :]
        ang = ang[:, None]  # (B, 1, L, hd/2)
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# SwiGLU MLP
# ---------------------------------------------------------------------------

class MLP(nn.Module):
    """SwiGLU: ``w_gate``/``w_up`` (d_model, d_ff), ``w_down`` (d_ff,
    d_model)."""

    def __init__(self, d_model: int, d_ff: int, dtype=torch.float32,
                 device=None, generator: Optional[torch.Generator] = None):
        super().__init__()
        std = d_model ** -0.5
        self.w_gate = _param((d_model, d_ff), std, dtype, device, generator)
        self.w_up = _param((d_model, d_ff), std, dtype, device, generator)
        self.w_down = _param((d_ff, d_model), d_ff ** -0.5, dtype, device,
                             generator)


def mlp(p: MLP, x: torch.Tensor, compute_dtype) -> torch.Tensor:
    xc = spmd.gather_rows(x.to(compute_dtype))
    g = xc @ p.w_gate.to(compute_dtype)
    u = xc @ p.w_up.to(compute_dtype)
    h = F.silu(g.float()).to(compute_dtype) * u
    # on a mesh the row-parallel product is Partial: reduced to x's layout
    return spmd.like((h @ p.w_down.to(compute_dtype)).to(x.dtype), x)


# ---------------------------------------------------------------------------
# GQA attention
# ---------------------------------------------------------------------------

class Attention(nn.Module):
    """Projections ``wq`` (D, H*hd), ``wk``/``wv`` (D, KV*hd), ``wo`` (H*hd,
    D), and with ``cfg.qkv_bias`` the biases ``bq``/``bk``/``bv``."""

    def __init__(self, cfg, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        D, H, KV, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd
        dtype = dtype_of(cfg.param_dtype)
        std = D ** -0.5
        self.wq = _param((D, H * hd), std, dtype, device, generator)
        self.wk = _param((D, KV * hd), std, dtype, device, generator)
        self.wv = _param((D, KV * hd), std, dtype, device, generator)
        self.wo = _param((H * hd, D), (H * hd) ** -0.5, dtype, device,
                         generator)
        if cfg.qkv_bias:
            self.bq = nn.Parameter(torch.zeros(H * hd, dtype=dtype,
                                               device=device))
            self.bk = nn.Parameter(torch.zeros(KV * hd, dtype=dtype,
                                               device=device))
            self.bv = nn.Parameter(torch.zeros(KV * hd, dtype=dtype,
                                               device=device))


def _write_index(cache_index, device):
    """(python int or None, int32 tensor or None): a scalar write offset as
    an int (slicing needs no device read), a (B,) one as a tensor."""
    if cache_index is None:
        return None, None
    if isinstance(cache_index, numbers.Integral):
        return int(cache_index), None
    idx = torch.as_tensor(cache_index, dtype=torch.int32, device=device)
    if idx.ndim == 0:
        return int(idx), None
    return None, idx


def attention_block(
    p: Attention,
    x: torch.Tensor,  # (B, L, D)
    cfg,
    positions: torch.Tensor,  # (L,) or (B, L) absolute positions of x
    cache: Optional[Tuple[torch.Tensor, ...]] = None,  # k, v or (kv,)
    cache_index=None,  # int, tensor scalar or (B,) tensor: write offset(s)
    ctx: Optional[ExecutionContext] = None,
    attn_mask: Optional[torch.Tensor] = None,  # (B, L) True = real token
    block_tables: Optional[torch.Tensor] = None,  # (B, w): paged-pool tables
    table_capacity: Optional[int] = None,  # the widest w the tables reach
) -> Tuple[torch.Tensor, Optional[Tuple[torch.Tensor, ...]]]:
    """Returns (out, cache). With a cache, keys/values are written at
    cache_index (in place) and attention runs over the full cache: ``(k,
    v)``, each (B, KV, Lmax, hd), or the fused layout ``(kv,)``, one (B, KV,
    Lmax, 2, hd) tensor whose axis 3 holds K then V.

    ``block_tables`` switches the cache to the paged layout: ``cache`` is the
    shared ``(num_blocks, KV, block_size, hd)`` k/v pool, row i's keys live in
    blocks ``block_tables[i]``, and the step is decode-only (L == 1). The new
    K/V land in physical block ``tables[i, pos // bs]`` at offset ``pos % bs``;
    dead rows (tables all zero) write reserved garbage block 0. A 4-tuple
    ``(kp, ks, vp, vs)`` is the int8 pool: the new K/V rows are quantized
    per (row, kv head) over hd (:func:`_quantize_kv_row`), codes and scales
    land together, and the step reads the pool through
    ``ops.attention_decode_quant``. ``table_capacity`` (not in the
    reference) goes to ``ops.attention_decode`` as its ``capacity``.

    A scalar ``cache_index`` writes all rows at one offset (lockstep prefill)
    and attends with a scalar tensor ``q_offset`` (``dynamic_q_offset``); a
    ``(B,)`` tensor writes row i at ``cache_index[i]`` and masks row i's
    attention to its own depth (``per_row_q_offset``). ``attn_mask`` marks
    padding tokens (False) so they are never attended to (``key_mask``).

    ``ctx`` picks the attention backend through ``repro_torch.ops``."""
    B, L, D = x.shape
    H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    cd = dtype_of(cfg.compute_dtype)
    xc = spmd.gather_rows(x.to(cd))

    q = xc @ p.wq.to(cd)
    k = xc @ p.wk.to(cd)
    v = xc @ p.wv.to(cd)
    if cfg.qkv_bias:
        q = q + p.bq.to(cd)
        k = k + p.bk.to(cd)
        v = v + p.bv.to(cd)
    # on a mesh: columns gathered where the heads do not divide their axes
    q = spmd.split_heads(q, H)
    k = spmd.split_heads(k, KV)
    v = spmd.split_heads(v, KV)
    q = q.reshape(B, L, H, hd).transpose(1, 2)
    k = k.reshape(B, L, KV, hd).transpose(1, 2)
    v = v.reshape(B, L, KV, hd).transpose(1, 2)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)

    start, rows = _write_index(cache_index, x.device)

    def project_out(o):
        o = spmd.rows_like(o.transpose(1, 2).reshape(B, L, H * hd), p.wo)
        return spmd.like((o @ p.wo.to(cd)).to(x.dtype), x)

    if block_tables is not None:
        if L != 1:
            raise ValueError(
                f"paged attention is decode-only (L == 1), got L={L}")
        quantized = len(cache) == 4  # (kp, ks, vp, vs): int8 pool + scales
        kp, vp = (cache[0], cache[2]) if quantized else cache
        bs = kp.shape[2]
        pos = (rows if rows is not None
               else torch.full((B,), start, dtype=torch.int32,
                               device=x.device)).long()
        blk = torch.gather(block_tables.long(), 1, (pos // bs)[:, None])[:, 0]
        off = pos % bs
        if quantized:
            ks, vs = cache[1], cache[3]
            kp[blk, :, off], ks[blk, :, off] = _quantize_kv_row(k[:, :, 0, :])
            vp[blk, :, off], vs[blk, :, off] = _quantize_kv_row(v[:, :, 0, :])
            # The reference registers the int8-pool decode on xla only
            # (repro/ops/registry.py:407) and has no Pallas kernel for it;
            # the port registers it on torch only and asks for that backend
            # here, so the card never looks for a cuda entry.
            ctx = ctx if ctx is not None else ops.default_context()
            o = ops.attention_decode_quant(
                q.to(cd), kp, ks, vp, vs, block_tables,
                (pos + 1).to(torch.int32),
                ctx=dataclasses.replace(ctx, backend="torch"))
            return project_out(o), (kp, ks, vp, vs)
        kp[blk, :, off] = k[:, :, 0, :].to(kp.dtype)
        vp[blk, :, off] = v[:, :, 0, :].to(vp.dtype)
        o = ops.attention_decode(q.to(cd), kp, vp, block_tables,
                                 (pos + 1).to(torch.int32), ctx=ctx,
                                 capacity=table_capacity)
        return project_out(o), (kp, vp)
    if cache is not None:
        # the fused layout, one (B, KV, Lmax, 2, hd) leaf: K and V land in
        # one write of their stack
        fused = len(cache) == 1
        new = (torch.stack([k, v], dim=3),) if fused else (k, v)
        if rows is not None:  # per-slot write offsets (continuous batching)
            at = rows.long()[:, None] + torch.arange(L, device=x.device)
            b_ix = torch.arange(B, device=x.device)[:, None]
            for c, u in zip(cache, new):
                if dtensors.is_dtensor(c):  # each shard writes its rows
                    spmd.cache_write(c, u, rows)
                else:
                    c[b_ix, :, at] = u.transpose(1, 2).to(c.dtype)
            q_offset = rows
        else:
            for c, u in zip(cache, new):
                if dtensors.is_dtensor(c):  # each shard writes its positions
                    spmd.cache_write(c, u, start)
                else:
                    c[:, :, start:start + L] = u.to(c.dtype)
            # a tensor scalar: the in-cache call, as the reference's traced
            # offset (filled on the device, no host copy)
            q_offset = torch.full((), start, dtype=torch.int32,
                                  device=x.device)
        new_cache = tuple(cache)
        # strided views of the fused leaf: the cuda entry copies them
        # contiguous before the kernel reads them
        ck, cv = ((cache[0][..., 0, :], cache[0][..., 1, :]) if fused
                  else cache)
        k_att, v_att = ck.to(cd), cv.to(cd)
    else:
        new_cache = None
        k_att, v_att = k, v
        q_offset = 0

    key_mask = _expand_key_mask(attn_mask, start, rows, L, k_att.shape[2],
                                cached=cache is not None)
    o = ops.attention(q, k_att, v_att, causal=cfg.causal, q_offset=q_offset,
                      key_mask=key_mask, ctx=ctx)
    return project_out(o), new_cache


def _quantize_kv_row(r: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric int8 quantization of one decode step's (B, KV, hd) k or v
    row, one scale per (row, kv_head) reduced over hd — the granularity the
    quantized pool's (num_blocks, KV, bs) scale leaves store. All-zero rows
    get scale 1.0 (quantize to 0) so dequantization never divides by
    zero."""
    qmax = 127.0
    rf = r.float()
    amax = rf.abs().amax(dim=-1)
    scale = torch.where(amax > 0, amax / qmax, torch.ones_like(amax))
    q = torch.clamp(torch.round(rf / scale[..., None]), -qmax,
                    qmax).to(torch.int8)
    return q, scale


def _expand_key_mask(attn_mask, start: Optional[int], rows, L: int, Lk: int,
                     cached: bool):
    """(B, L) pad mask -> (B, Lk) key mask over this call's attention keys.

    Without a cache the keys are exactly this call's tokens. With a cache the
    keys span the whole cache; the call's mask lands on the written window
    [start, start + L) and everything outside it is presumed valid (unwritten
    tail entries are hidden by the causal mask)."""
    if attn_mask is None:
        return None
    attn_mask = attn_mask.to(torch.bool)
    if not cached:
        return attn_mask
    if rows is not None:
        raise NotImplementedError(
            "attn_mask with per-row cache_index is unsupported; "
            "continuous-batching decode feeds one real token per row")
    out = torch.ones((attn_mask.shape[0], Lk), dtype=torch.bool,
                     device=attn_mask.device)
    out[:, start:start + L] = attn_mask[:, :max(0, min(L, Lk - start))]
    return out


# ---------------------------------------------------------------------------
# Embedding / head
# ---------------------------------------------------------------------------

def embed(table: torch.Tensor, tokens: torch.Tensor,
          compute_dtype) -> torch.Tensor:
    if dtensors.is_dtensor(table):  # vocabulary-parallel lookup
        return spmd.embed_lookup(table, tokens, compute_dtype)
    return table[tokens.long()].to(compute_dtype)


def lm_logits(head: torch.Tensor, x: torch.Tensor,
              compute_dtype) -> torch.Tensor:
    """(B, L, D) @ (D, V) -> f32 logits."""
    return (x.to(compute_dtype) @ head.to(compute_dtype)).float()
