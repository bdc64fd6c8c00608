"""Config-driven model assembly for the dense GQA architectures (the
counterpart of ``repro.models.transformer`` for the ``("attn",)`` pattern).

The reference stacks one pattern unit's parameters on a leading ``repeats``
axis and ``lax.scan``s over it; the port holds one module per repeat in an
``nn.ModuleList`` and runs them in a Python loop, so it needs no counterpart
of ``repro.models.scan_util``. KV caches keep the reference's stacked layout
(``{"b0": {"k": (repeats, B, KV, L, hd), ...}}``) and layer r reads and
writes slice r of each leaf in place.

Block kinds: only ``attn`` (plus its SwiGLU FFN) is ported; ``mamba``,
``mlstm``, ``slstm`` and MoE FFNs raise ``NotImplementedError``.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn as nn

from repro_torch.ops import ExecutionContext

from .config import ModelConfig
from .layers import (MLP, Attention, attention_block, dtype_of, embed,
                     lm_logits, mlp, rms_norm, truncated_normal_)

Cache = Dict[str, Dict[str, torch.Tensor]]


def _check_ported(cfg: ModelConfig) -> None:
    kinds = set(cfg.pattern)
    if kinds != {"attn"}:
        raise NotImplementedError(
            f"{cfg.name}: blocks {sorted(kinds - {'attn'})} are not ported to "
            "repro_torch yet (ROADMAP queue 1, item 9)")
    if cfg.n_experts:
        raise NotImplementedError(
            f"{cfg.name}: the MoE FFN is not ported to repro_torch yet "
            "(ROADMAP queue 1, item 6: left out)")
    if cfg.inputs_are_embeddings:
        raise NotImplementedError(
            f"{cfg.name}: stub frontends are not ported to repro_torch yet")


# ---------------------------------------------------------------------------
# Init
# ---------------------------------------------------------------------------

class Block(nn.Module):
    """One ``attn`` block: ``norm1``, ``core`` (attention), ``norm2``,
    ``ffn`` (SwiGLU) — the reference's ``b0`` leaves."""

    def __init__(self, cfg: ModelConfig, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        dtype = dtype_of(cfg.param_dtype)
        self.norm1 = nn.Parameter(torch.ones(cfg.d_model, dtype=dtype,
                                             device=device))
        self.core = Attention(cfg, device, generator)
        if cfg.d_ff > 0:
            self.norm2 = nn.Parameter(torch.ones(cfg.d_model, dtype=dtype,
                                                 device=device))
            self.ffn = MLP(cfg.d_model, cfg.d_ff, dtype, device, generator)


class Transformer(nn.Module):
    """``embed`` (padded vocab, D), ``layers`` (one ``{"b0": Block}`` per
    repeat), ``final_norm`` (D,), ``head`` (D, padded vocab)."""

    def __init__(self, cfg: ModelConfig, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        _check_ported(cfg)
        dtype = dtype_of(cfg.param_dtype)
        V, D = cfg.padded_vocab, cfg.d_model
        emb = torch.empty((V, D), dtype=torch.float32, device=device)
        self.embed = nn.Parameter(
            truncated_normal_(emb, 1.0, generator).to(dtype))
        self.layers = nn.ModuleList(
            nn.ModuleDict({"b0": Block(cfg, device, generator)})
            for _ in range(cfg.repeats))
        self.final_norm = nn.Parameter(torch.ones(D, dtype=dtype,
                                                  device=device))
        head = torch.empty((D, V), dtype=torch.float32, device=device)
        self.head = nn.Parameter(
            truncated_normal_(head, D ** -0.5, generator).to(dtype))


def init_params(cfg: ModelConfig, seed: int = 0,
                device="cuda") -> Transformer:
    """Seeded random parameters on ``device`` (made there, from a
    ``torch.Generator`` of that device). Not the reference's values: JAX's
    threefry stream has no torch counterpart; carry the reference's own
    parameters over with ``repro_torch.convert.transformer_from_jax``."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    with torch.no_grad():
        return Transformer(cfg, device=device, generator=gen)


def compute_params(params: Transformer, cfg: ModelConfig) -> Transformer:
    """A copy whose matmul weights (projections, biases, FFN, embedding,
    head) are already in ``cfg.compute_dtype``; norm scales keep their
    dtype. The layers cast weights at use, so this computes the same values
    while moving each weight once instead of casting it on every step (3.4 B
    weights cast per decode step would be 20+ GB of extra traffic)."""
    cd = dtype_of(cfg.compute_dtype)
    norms = ("norm1", "norm2", "final_norm")
    state = {k: (v if k.rsplit(".", 1)[-1] in norms else v.to(cd))
             for k, v in params.state_dict().items()}
    with torch.device("meta"):
        out = Transformer(cfg)
    out.load_state_dict(state, assign=True)
    return out


# ---------------------------------------------------------------------------
# Caches
# ---------------------------------------------------------------------------

def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               dtype=torch.bfloat16, device="cuda") -> Cache:
    """Stacked (repeats-leading) contiguous KV cache for decode."""
    _check_ported(cfg)
    if cfg.fused_kv_cache:
        raise NotImplementedError(
            "the fused (B, KV, L, 2, hd) KV layout is not ported")
    shape = (cfg.repeats, batch, cfg.n_kv_heads, max_len, cfg.hd)
    return {f"b{i}": {"k": torch.zeros(shape, dtype=dtype, device=device),
                      "v": torch.zeros(shape, dtype=dtype, device=device)}
            for i in range(len(cfg.pattern))}


def init_paged_cache(cfg: ModelConfig, num_blocks: int, block_size: int,
                     dtype=torch.bfloat16, quantized: bool = False,
                     device="cuda") -> Cache:
    """Stacked paged KV pool: every attention layer gets a ``(num_blocks,
    KV, block_size, hd)`` key pool and value pool (stacked to (repeats, ...)
    like ``init_cache``). Physical block 0 is the reserved garbage block
    (``serving.kv.GARBAGE_BLOCK``): dead batch rows point their tables at
    it. ``quantized=True`` (the int8 pool) waits for the int8 slice."""
    if set(cfg.pattern) != {"attn"}:
        raise ValueError(
            f"paged cache requires a pure-attention pattern, got {cfg.pattern}")
    if quantized:
        raise NotImplementedError(
            "the int8 KV pool comes with the int8 slice (ROADMAP queue 1, "
            "item 8)")
    shape = (cfg.repeats, num_blocks, cfg.n_kv_heads, block_size, cfg.hd)
    return {f"b{i}": {"kp": torch.zeros(shape, dtype=dtype, device=device),
                      "vp": torch.zeros(shape, dtype=dtype, device=device)}
            for i in range(len(cfg.pattern))}


def insert_cache_slot(cache: Cache, row: Cache, slot: int) -> Cache:
    """Write a single-sequence cache (batch size 1) into batch slot ``slot``
    of a pooled cache, in place. Every leaf is stacked (repeats, B, ...), so
    the batch axis is axis 1: the continuous-batching admission primitive."""
    with torch.no_grad():
        for u, leaves in cache.items():
            for name, p in leaves.items():
                p[:, slot:slot + 1] = row[u][name].to(p.dtype)
    return cache


def reset_cache_slot(cache: Cache, slot: int) -> Cache:
    """Zero one batch slot of a pooled cache, in place."""
    with torch.no_grad():
        for leaves in cache.values():
            for p in leaves.values():
                p[:, slot].zero_()
    return cache


def cache_footprint_words(cfg: ModelConfig, max_len: int,
                          dtype=torch.bfloat16,
                          block_size: Optional[int] = None) -> float:
    """Per-sequence decode-cache size in 32-bit words (the paper's unit),
    from ``init_cache``'s shapes. ``block_size`` switches to block-granular
    accounting: a paged sequence occupies whole blocks."""
    _check_ported(cfg)
    if block_size is not None:
        max_len = -(-max_len // block_size) * block_size
    itemsize = torch.empty((), dtype=dtype).element_size()
    elems = (cfg.repeats * len(cfg.pattern) * 2 * cfg.n_kv_heads * max_len
             * cfg.hd)
    return elems * itemsize / 4.0


# ---------------------------------------------------------------------------
# Forward
# ---------------------------------------------------------------------------

def _positions(cache_index, L: int, device) -> torch.Tensor:
    ar = torch.arange(L, dtype=torch.int32, device=device)
    if torch.is_tensor(cache_index) and cache_index.ndim:
        return ar[None, :] + cache_index.to(device=device,
                                            dtype=torch.int32)[:, None]
    return ar + int(cache_index)


def hidden_forward(
    params: Transformer,
    cfg: ModelConfig,
    tokens: Optional[torch.Tensor] = None,  # (B, L) int
    embeds: Optional[torch.Tensor] = None,  # (B, L, D)
    cache: Optional[Cache] = None,
    cache_index=None,  # int, tensor scalar, or (B,) tensor
    ctx: Optional[ExecutionContext] = None,
    attn_mask: Optional[torch.Tensor] = None,  # (B, L) True = real token
    positions: Optional[torch.Tensor] = None,  # (L,) or (B, L)
    block_tables: Optional[torch.Tensor] = None,  # (B, w) paged tables
) -> Tuple[torch.Tensor, Optional[Cache], torch.Tensor]:
    """Backbone only: returns (final-norm hidden states, cache, aux).

    A ``block_tables`` tensor marks ``cache`` as a paged pool
    (``init_paged_cache`` layout): decode-only, one query per row, keys
    read through the table by the paged decode kernel. ``cache`` is updated
    in place and returned.

    ``cache_index`` may be a scalar (all rows at one depth: lockstep
    prefill) or a (B,) tensor (each row at its own depth: continuous-batching
    decode); positions default to ``arange(L) + cache_index`` per row.
    ``attn_mask`` marks padding (False) so attention never reads pad tokens.
    ``aux`` is the reference's auxiliary loss, zero for dense blocks."""
    _check_ported(cfg)
    cd = dtype_of(cfg.compute_dtype)
    x = embeds.to(cd) if embeds is not None else embed(params.embed, tokens,
                                                       cd)
    L = x.shape[1]
    if cache_index is None:
        cache_index = 0
    if positions is None:
        positions = _positions(cache_index, L, x.device)
    for r, unit in enumerate(params.layers):
        blk = unit["b0"]
        h = rms_norm(x, blk.norm1, cfg.norm_eps)
        bc = None if cache is None else cache["b0"]
        paged = bc is not None and "kp" in bc
        layer_cache = None
        if bc is not None:
            layer_cache = ((bc["kp"][r], bc["vp"][r]) if paged
                           else (bc["k"][r], bc["v"][r]))
        out, _ = attention_block(blk.core, h, cfg, positions,
                                 cache=layer_cache, cache_index=cache_index,
                                 ctx=ctx, attn_mask=attn_mask,
                                 block_tables=block_tables if paged else None)
        x = x + out
        if cfg.d_ff > 0:
            h = rms_norm(x, blk.norm2, cfg.norm_eps)
            x = x + mlp(blk.ffn, h, cd)
    x = rms_norm(x, params.final_norm, cfg.norm_eps)
    return x, cache, torch.zeros((), dtype=torch.float32, device=x.device)


def forward(
    params: Transformer,
    cfg: ModelConfig,
    tokens: Optional[torch.Tensor] = None,
    embeds: Optional[torch.Tensor] = None,
    cache: Optional[Cache] = None,
    cache_index=None,
    ctx: Optional[ExecutionContext] = None,
    attn_mask: Optional[torch.Tensor] = None,
    positions: Optional[torch.Tensor] = None,
    block_tables: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, Optional[Cache], torch.Tensor]:
    """Returns (logits, cache, aux_loss)."""
    x, cache, aux = hidden_forward(
        params, cfg, tokens=tokens, embeds=embeds, cache=cache,
        cache_index=cache_index, ctx=ctx, attn_mask=attn_mask,
        positions=positions, block_tables=block_tables)
    logits = lm_logits(params.head, x, dtype_of(cfg.compute_dtype))
    return logits, cache, aux
