"""Config-driven model assembly (the counterpart of
``repro.models.transformer``) for every architecture of the reference: the
dense GQA ones (``("attn",)``), the MoE ones (OLMoE, Phi-3.5-MoE), InternVL2's
language backbone, which also takes the stub frontend's patch embeddings
(``embeds=``), HuBERT's encoder (``causal=False``, no embedding table: its
stub frontend's frame embeddings are its only input), jamba's hybrid unit
(seven mamba blocks and one attention block) and xLSTM's (an mLSTM and an
sLSTM block).

The reference stacks one pattern unit's parameters on a leading ``repeats``
axis and ``lax.scan``s over it; the port holds one ``{"b0": Block, ...}``
module dict per repeat in an ``nn.ModuleList`` and runs them in a Python
loop. Caches keep the reference's stacked layout (``{"b0": {"k": (repeats,
B, KV, L, hd), ...}}`` for attention, or with ``fused_kv_cache`` one
``{"kv": (repeats, B, KV, L, 2, hd)}`` leaf; ``{"b1": {"h": ..., "tail":
...}}`` for mamba, ``{"C": ..., "n": ...}`` for mLSTM and ``{"c": ...,
"n": ...}`` for sLSTM) and layer r reads and writes slice r of each leaf in
place.

Block kinds: ``attn``, ``mamba``, ``mlstm`` and ``slstm``; each but
``mlstm`` is followed by an FFN when ``d_ff > 0``: the routed MoE
(``moe.moe_block``) at every ``moe_every``-th position of a config with
experts, a SwiGLU elsewhere.

The losses (``next_token_loss``, ``classification_loss``,
``chunked_next_token_loss``, ``loss_fn``) are the reference's; the training
step (``repro_torch.train``) differentiates ``loss_fn`` with autograd.
``remat=True`` recomputes each repeat's unit in the backward pass
(``torch.utils.checkpoint``, non-reentrant). The reference's remat saves the
products without batch dimensions
(``dots_with_no_batch_dims_saveable``); torch has no such policy, so the
port saves only each unit's input: other tensors kept, the same numbers.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import torch
import torch.nn as nn
import torch.utils.checkpoint as checkpoint_lib

from repro_torch.ops import ExecutionContext

from . import moe as moe_lib
from . import ssm, xlstm
from .config import ModelConfig
from .layers import (MLP, Attention, attention_block, dtype_of, embed,
                     lm_logits, mlp, rms_norm, truncated_normal_)

Cache = Dict[str, Dict[str, torch.Tensor]]

# each recurrent block kind: its module, its cache leaves' names, its state's
# initializer, its prefill block and its decode step
_RECURRENT = {
    "mamba": (ssm.Mamba, ("h", "tail"), ssm.init_mamba_state,
              ssm.mamba_block, ssm.mamba_decode_step),
    "mlstm": (xlstm.MLSTM, ("C", "n"), xlstm.init_mlstm_state,
              xlstm.mlstm_block, xlstm.mlstm_decode_step),
    "slstm": (xlstm.SLSTM, ("c", "n"), xlstm.init_slstm_state,
              xlstm.slstm_block, xlstm.slstm_decode_step),
}


def _has_embed(cfg: ModelConfig) -> bool:
    """A token embedding table, as the reference's ``init_params``: every
    config but a stub frontend's whose only input is ``embeds`` (the
    encoder); the ``vlm`` keeps one for its text tokens."""
    return not cfg.inputs_are_embeddings or cfg.family == "vlm"


# ---------------------------------------------------------------------------
# Init
# ---------------------------------------------------------------------------

def _has_ffn(cfg: ModelConfig, pos: int) -> bool:
    return cfg.d_ff > 0 and cfg.pattern[pos] in ("attn", "mamba", "slstm")


def _is_moe(cfg: ModelConfig, pos: int) -> bool:
    return (_has_ffn(cfg, pos) and cfg.n_experts > 0
            and pos % cfg.moe_every == 0)


class Block(nn.Module):
    """The block at pattern position ``pos``: ``norm1``, ``core``
    (attention, mamba, mLSTM or sLSTM), and with an FFN ``norm2``, ``ffn``
    (``moe.MoE`` at an MoE position, else the SwiGLU ``MLP``) — the
    reference's ``b{pos}`` leaves."""

    def __init__(self, cfg: ModelConfig, pos: int, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        dtype = dtype_of(cfg.param_dtype)
        kind = cfg.pattern[pos]
        if kind != "attn" and kind not in _RECURRENT:
            raise ValueError(f"unknown block kind {kind!r}")
        self.norm1 = nn.Parameter(torch.ones(cfg.d_model, dtype=dtype,
                                             device=device))
        core = Attention if kind == "attn" else _RECURRENT[kind][0]
        self.core = core(cfg, device, generator)
        if _has_ffn(cfg, pos):
            self.norm2 = nn.Parameter(torch.ones(cfg.d_model, dtype=dtype,
                                                 device=device))
            self.ffn = (moe_lib.MoE(cfg, device, generator)
                        if _is_moe(cfg, pos) else
                        MLP(cfg.d_model, cfg.d_ff, dtype, device, generator))


class Transformer(nn.Module):
    """``embed`` (padded vocab, D), ``layers`` (one ``{"b0": Block, ...}``
    per repeat, a block per pattern position), ``final_norm`` (D,), ``head``
    (D, padded vocab). A ``vlm`` config keeps ``embed`` for its text tokens,
    as the reference does, beside the stub frontend's ``embeds``; the
    encoder has no ``embed`` (``None``, no leaf)."""

    def __init__(self, cfg: ModelConfig, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        dtype = dtype_of(cfg.param_dtype)
        V, D = cfg.padded_vocab, cfg.d_model
        if _has_embed(cfg):
            emb = torch.empty((V, D), dtype=torch.float32, device=device)
            self.embed = nn.Parameter(
                truncated_normal_(emb, 1.0, generator).to(dtype))
        else:
            self.register_parameter("embed", None)
        self.layers = nn.ModuleList(
            nn.ModuleDict({f"b{i}": Block(cfg, i, device, generator)
                           for i in range(len(cfg.pattern))})
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


# leaves read in their own dtype: the norm scales, the MoE router (f32 in the
# reference, so routing matches it), the mamba leaves that the reference
# reads in f32 (conv_w at decode; b_dt, log_A, D_skip always) and the xLSTM
# gate biases, which it adds in f32
KEEP_DTYPE = ("norm1", "norm2", "final_norm", "router", "conv_w", "b_dt",
              "log_A", "D_skip", "b_if", "b_zifo")


def compute_params(params: Transformer, cfg: ModelConfig) -> Transformer:
    """A copy whose matmul weights (projections, biases, FFN, embedding,
    head) are already in ``cfg.compute_dtype``; the ``KEEP_DTYPE`` leaves
    keep theirs. The layers cast weights at use, so this computes the same
    values while moving each weight once instead of casting it on every step
    (3.4 B weights cast per decode step would be 20+ GB of extra traffic)."""
    cd = dtype_of(cfg.compute_dtype)
    state = {k: (v if k.rsplit(".", 1)[-1] in KEEP_DTYPE else v.to(cd))
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
    """Stacked (repeats-leading) contiguous cache for decode: ``k``/``v``
    in ``dtype`` for each attention position (with ``cfg.fused_kv_cache``
    one ``kv`` leaf, K and V stacked on axis 4 of (repeats, B, KV, L, 2,
    hd)), the f32 recurrent state for each other position: ``h``/``tail``
    (mamba), ``C``/``n`` (mLSTM), ``c``/``n`` (sLSTM)."""
    shape = (cfg.repeats, batch, cfg.n_kv_heads, max_len, cfg.hd)
    cache: Cache = {}
    for i, kind in enumerate(cfg.pattern):
        if kind == "attn" and cfg.fused_kv_cache:
            cache[f"b{i}"] = {"kv": torch.zeros(
                shape[:4] + (2, cfg.hd), dtype=dtype, device=device)}
        elif kind == "attn":
            cache[f"b{i}"] = {
                "k": torch.zeros(shape, dtype=dtype, device=device),
                "v": torch.zeros(shape, dtype=dtype, device=device)}
        else:
            _, names, init_state, _, _ = _RECURRENT[kind]
            state = init_state(cfg, cfg.repeats * batch, torch.float32,
                               device)
            cache[f"b{i}"] = {n: t.unflatten(0, (cfg.repeats, batch))
                              for n, t in zip(names, state)}
    return cache


def init_paged_cache(cfg: ModelConfig, num_blocks: int, block_size: int,
                     dtype=torch.bfloat16, quantized: bool = False,
                     device="cuda") -> Cache:
    """Stacked paged KV pool: every attention layer gets a ``(num_blocks,
    KV, block_size, hd)`` key pool and value pool (stacked to (repeats, ...)
    like ``init_cache``). Physical block 0 is the reserved garbage block
    (``serving.kv.GARBAGE_BLOCK``): dead batch rows point their tables at
    it.

    ``quantized=True`` stores the pools as int8 plus per-(block, kv_head,
    position) f32 scale leaves ``ks``/``vs`` of shape (repeats, num_blocks,
    KV, block_size) — (0.25 + 1/hd) words per cached element instead of
    bf16's 0.5, which is what roughly doubles ``serving.kv.plan_pool_blocks``'s
    block capacity from the same HBM budget. Scales start at 1.0 (the
    all-zero-row convention of ``quantize_symmetric``)."""
    if set(cfg.pattern) != {"attn"}:
        raise ValueError(
            f"paged cache requires a pure-attention pattern, got {cfg.pattern}")
    shape = (cfg.repeats, num_blocks, cfg.n_kv_heads, block_size, cfg.hd)
    if quantized:
        return {f"b{i}": {
            "kp": torch.zeros(shape, dtype=torch.int8, device=device),
            "ks": torch.ones(shape[:4], dtype=torch.float32, device=device),
            "vp": torch.zeros(shape, dtype=torch.int8, device=device),
            "vs": torch.ones(shape[:4], dtype=torch.float32, device=device)}
            for i in range(len(cfg.pattern))}
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
    from ``init_cache``'s shapes (built on the meta device: nothing is
    allocated). ``block_size`` switches to block-granular accounting: a
    paged sequence occupies whole blocks."""
    if block_size is not None:
        max_len = -(-max_len // block_size) * block_size
    cache = init_cache(cfg, 1, max_len, dtype=dtype, device="meta")
    return sum(t.numel() * t.element_size() for leaves in cache.values()
               for t in leaves.values()) / 4.0


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
    table_capacity: Optional[int] = None,  # the widest w the tables reach
    decode: bool = False,
    n_groups: int = 1,
    expert_choices: Optional[Sequence[torch.Tensor]] = None,
    remat: bool = False,
) -> Tuple[torch.Tensor, Optional[Cache], torch.Tensor]:
    """Backbone only: returns (final-norm hidden states, cache, aux).

    A ``block_tables`` tensor marks ``cache`` as a paged pool
    (``init_paged_cache`` layout): decode-only, one query per row, keys
    read through the table by the paged decode kernel (bf16 pool) or the
    int8-pool decode (``quantized=True`` pool); ``table_capacity`` (not in
    the reference) is the widest table width its rows can reach, which
    the paged decode kernel takes its split from (``ops.attention_decode``'s
    ``capacity``). ``cache`` is updated in place and returned.

    ``cache_index`` may be a scalar (all rows at one depth: lockstep
    prefill) or a (B,) tensor (each row at its own depth: continuous-batching
    decode); positions default to ``arange(L) + cache_index`` per row.
    ``attn_mask`` marks padding (False) so attention never reads pad tokens.
    Recurrent blocks (mamba, mLSTM, sLSTM) run their prefill form over the
    whole sequence (``ssm.mamba_block``, ``xlstm.mlstm_block``,
    ``xlstm.slstm_block``), or with ``decode`` one recurrence step per row
    (their ``*_decode_step``); with a cache they start from, and write back
    in place, its state leaves. They consume every position in order, so
    recurrent patterns are prefilled at their exact length (no pad tokens).
    MoE FFNs route the call's B * L tokens in ``n_groups`` groups
    (``moe.moe_block``: one group unless they divide evenly); pad tokens and
    a decode step's dead rows route and take capacity, as in the reference.
    ``aux`` is the sum of the MoE blocks' load-balancing losses, zero
    without experts. ``expert_choices`` (not in the reference) gives the
    j-th MoE block of the forward its ``choices`` (``moe.moe_block``; a
    recorded run's ``moe.Routing.gate_idx``). ``embeds`` (a stub
    frontend's (B, L, D) output) enters in place of the token embedding.
    ``remat`` recomputes each repeat's unit in the backward pass (module
    docstring); it is for the cache-less training forward and raises with a
    cache, whose in-place writes a recompute would repeat."""
    if remat and cache is not None:
        raise NotImplementedError(
            "remat recomputes a unit in the backward pass; a cache's in-place "
            "writes cannot be recomputed")
    cd = dtype_of(cfg.compute_dtype)
    if embeds is not None:
        x = embeds.to(cd)
    elif params.embed is None:
        raise ValueError(f"{cfg.name} has no embedding table: pass embeds=")
    else:
        x = embed(params.embed, tokens, cd)
    L = x.shape[1]
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if cache_index is None:
        cache_index = 0
    if positions is None:
        positions = _positions(cache_index, L, x.device)
    n_moe = sum(_is_moe(cfg, i) for i in range(len(cfg.pattern)))  # a unit's
    for r, unit in enumerate(params.layers):
        choices = (None if expert_choices is None
                   else expert_choices[r * n_moe:(r + 1) * n_moe])

        def run(x_, unit=unit, r=r, choices=choices):
            return _unit_forward(unit, x_, r, cfg, positions, cache,
                                 cache_index, ctx, attn_mask, block_tables,
                                 table_capacity, decode, n_groups, choices)

        if remat and torch.is_grad_enabled():
            x, a = checkpoint_lib.checkpoint(run, x, use_reentrant=False)
        else:
            x, a = run(x)
        aux = aux + a
    x = rms_norm(x, params.final_norm, cfg.norm_eps)
    return x, cache, aux


def _unit_forward(unit, x, r: int, cfg: ModelConfig, positions, cache,
                  cache_index, ctx, attn_mask, block_tables, table_capacity,
                  decode: bool, n_groups: int,
                  choices) -> Tuple[torch.Tensor, torch.Tensor]:
    """Repeat r's pattern unit; returns (x, the unit's MoE aux loss).
    ``choices`` holds the unit's MoE blocks' expert choices, in order."""
    cd = dtype_of(cfg.compute_dtype)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    n_moe = 0  # the unit's MoE blocks run so far
    for i, kind in enumerate(cfg.pattern):
        blk = unit[f"b{i}"]
        h = rms_norm(x, blk.norm1, cfg.norm_eps)
        bc = None if cache is None else cache[f"b{i}"]
        if kind == "attn":
            out = _attention(blk, h, cfg, positions, bc, r, cache_index,
                             ctx, attn_mask, block_tables, table_capacity)
        else:
            _, names, _, block, decode_step = _RECURRENT[kind]
            state = None if bc is None else tuple(bc[n][r] for n in names)
            step = decode_step if decode else block
            out, upd = step(blk.core, h, cfg, state, ctx=ctx)
            if upd is not None:  # in place: the decode graphs' buffers
                for leaf, new in zip(state, upd):
                    leaf.copy_(new)
        x = x + out
        if _has_ffn(cfg, i):
            h = rms_norm(x, blk.norm2, cfg.norm_eps)
            if _is_moe(cfg, i):
                f, a = moe_lib.moe_block(
                    blk.ffn, h, cfg, n_groups=n_groups, ctx=ctx,
                    choices=None if choices is None else choices[n_moe])
                n_moe += 1
                aux = aux + a
            else:
                f = mlp(blk.ffn, h, cd)
            x = x + f
    return x, aux


def _attention(blk: Block, h, cfg, positions, bc, r: int, cache_index,
               ctx, attn_mask, block_tables, table_capacity) -> torch.Tensor:
    """One attention block over repeat r's slice of its cache leaves
    (contiguous ``k``/``v`` or fused ``kv``, the paged pool, or the int8
    pool)."""
    paged = bc is not None and "kp" in bc
    layer_cache = None
    if bc is not None:
        names = (("kp", "ks", "vp", "vs") if "ks" in bc
                 else ("kp", "vp") if paged
                 else ("kv",) if "kv" in bc else ("k", "v"))
        layer_cache = tuple(bc[n][r] for n in names)
    out, _ = attention_block(blk.core, h, cfg, positions,
                             cache=layer_cache, cache_index=cache_index,
                             ctx=ctx, attn_mask=attn_mask,
                             block_tables=block_tables if paged else None,
                             table_capacity=table_capacity)
    return out


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
    table_capacity: Optional[int] = None,
    decode: bool = False,
    n_groups: int = 1,
    expert_choices: Optional[Sequence[torch.Tensor]] = None,
    remat: bool = False,
) -> Tuple[torch.Tensor, Optional[Cache], torch.Tensor]:
    """Returns (logits, cache, aux_loss)."""
    x, cache, aux = hidden_forward(
        params, cfg, tokens=tokens, embeds=embeds, cache=cache,
        cache_index=cache_index, ctx=ctx, attn_mask=attn_mask,
        positions=positions, block_tables=block_tables,
        table_capacity=table_capacity, decode=decode,
        n_groups=n_groups, expert_choices=expert_choices, remat=remat)
    logits = lm_logits(params.head, x, dtype_of(cfg.compute_dtype))
    return logits, cache, aux


# ---------------------------------------------------------------------------
# Losses (differentiated by repro_torch.train)
# ---------------------------------------------------------------------------

def _token_nll(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """logsumexp(logits) - logits[target] per position, in f32."""
    lg = logits.float()
    logz = torch.logsumexp(lg, dim=-1)
    true_logit = torch.gather(lg, -1, targets.long()[..., None])[..., 0]
    return logz - true_logit


def next_token_loss(logits: torch.Tensor,
                    tokens: torch.Tensor) -> torch.Tensor:
    """Causal LM shift-by-one cross entropy, mean over (B, L-1)."""
    return _token_nll(logits[:, :-1], tokens[:, 1:]).mean()


def classification_loss(logits: torch.Tensor,
                        labels: torch.Tensor) -> torch.Tensor:
    """Per-frame classification (encoder models)."""
    return _token_nll(logits, labels).mean()


def chunked_next_token_loss(params: Transformer, cfg: ModelConfig,
                            x: torch.Tensor, tokens: torch.Tensor,
                            n_chunks: int) -> torch.Tensor:
    """Cross entropy without materializing the full (B, L, V) logits: the
    sequence is split into ``n_chunks``, each chunk's logits are computed,
    reduced, and recomputed in the backward pass
    (``torch.utils.checkpoint``). Essential when V ~ 150k."""
    B, L, D = x.shape
    xs, tg = x[:, :-1], tokens[:, 1:].long()
    pad = (-xs.shape[1]) % n_chunks
    if pad:
        xs = torch.nn.functional.pad(xs, (0, 0, 0, pad))
        tg = torch.nn.functional.pad(tg, (0, pad), value=-1)
    c = xs.shape[1] // n_chunks
    cd = dtype_of(cfg.compute_dtype)

    def chunk_loss(xc, tc):
        lg = lm_logits(params.head, xc, cd)
        nll = _token_nll(lg, tc.clamp(min=0))
        valid = (tc >= 0).float()
        return (nll * valid).sum(), valid.sum()

    tot = torch.zeros((), dtype=torch.float32, device=x.device)
    cnt = torch.zeros((), dtype=torch.float32, device=x.device)
    for j in range(n_chunks):
        sl = slice(j * c, (j + 1) * c)
        if torch.is_grad_enabled():
            ls, ns = checkpoint_lib.checkpoint(chunk_loss, xs[:, sl], tg[:, sl],
                                               use_reentrant=False)
        else:
            ls, ns = chunk_loss(xs[:, sl], tg[:, sl])
        tot, cnt = tot + ls, cnt + ns
    return tot / torch.clamp(cnt, min=1.0)


def loss_fn(params: Transformer, cfg: ModelConfig,
            batch: Dict[str, torch.Tensor], n_groups: int = 1,
            ctx: Optional[ExecutionContext] = None, remat: bool = False,
            aux_weight: float = 0.01, loss_chunks: int = 0, act_spec=None):
    """(loss + aux_weight * aux, (loss, aux)) of one batch: ``tokens`` (a
    causal LM's next-token loss, chunked when ``loss_chunks > 1``) or
    ``embeds`` with ``labels`` (the encoder's per-frame classification).
    ``act_spec`` (a sharding of the activations) is not ported (ROADMAP
    queue 1, item 13)."""
    if act_spec is not None:
        raise NotImplementedError(
            "act_spec (sequence-parallel activations) is not ported to "
            "repro_torch yet (ROADMAP queue 1, item 13)")
    if loss_chunks > 1 and cfg.causal and "tokens" in batch:
        x, _, aux = hidden_forward(
            params, cfg, tokens=batch.get("tokens"),
            embeds=batch.get("embeds"), n_groups=n_groups, ctx=ctx,
            remat=remat)
        loss = chunked_next_token_loss(params, cfg, x, batch["tokens"],
                                       loss_chunks)
        return loss + aux_weight * aux, (loss, aux)
    logits, _, aux = forward(
        params, cfg, tokens=batch.get("tokens"), embeds=batch.get("embeds"),
        n_groups=n_groups, ctx=ctx, remat=remat)
    if cfg.causal and "tokens" in batch:
        loss = next_token_loss(logits, batch["tokens"])
    else:
        loss = classification_loss(logits, batch["labels"])
    return loss + aux_weight * aux, (loss, aux)
