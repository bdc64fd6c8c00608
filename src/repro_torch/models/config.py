"""Model configuration: one dataclass drives every assigned architecture
(a copy of ``repro.models.config``, pure Python).

A model is a repeated *pattern unit* of blocks (e.g. ("attn",) for dense LMs,
("mamba",)*7 + ("attn",) for jamba's 1:7 interleave, ("mlstm", "slstm") for
xLSTM). The port builds one module per layer and runs them in a Python loop
(``models.transformer``); only the ``("attn",)`` pattern has ported blocks.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str  # dense | moe | ssm | hybrid | encoder | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    pattern: Tuple[str, ...] = ("attn",)  # block kinds in one pattern unit
    head_dim: Optional[int] = None
    qkv_bias: bool = False
    rope_theta: float = 10000.0
    norm_eps: float = 1e-5
    # MoE
    n_experts: int = 0
    experts_per_token: int = 0
    capacity_factor: float = 1.25
    moe_every: int = 1  # apply MoE FFN on every k-th pattern position
    # SSM / recurrent
    ssm_state_dim: int = 16
    ssm_expand: int = 2
    conv_kernel: int = 4
    chunk_size: int = 256  # chunked-scan chunk length
    # encoder / frontends
    causal: bool = True
    inputs_are_embeddings: bool = False  # audio/vlm stub frontends
    # training
    param_dtype: str = "float32"
    compute_dtype: str = "bfloat16"
    vocab_pad_multiple: int = 256  # embed/head padded for TP divisibility
    # distribution hints (set by the launcher; require the named mesh axes)
    moe_shard_hints: bool = False  # constrain MoE dispatch-path shardings
    fused_kv_cache: bool = False  # one (B,KV,L,2,hd) tensor per attn layer

    def __post_init__(self):
        assert self.n_layers % len(self.pattern) == 0, (
            f"{self.name}: n_layers={self.n_layers} not divisible by pattern "
            f"unit {len(self.pattern)}")
        assert self.n_heads % max(self.n_kv_heads, 1) == 0

    @property
    def repeats(self) -> int:
        return self.n_layers // len(self.pattern)

    @property
    def hd(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def padded_vocab(self) -> int:
        m = self.vocab_pad_multiple
        return -(-self.vocab_size // m) * m

    @property
    def d_inner(self) -> int:
        """SSM inner width."""
        return self.ssm_expand * self.d_model

    def param_count(self) -> int:
        """Approximate parameter count (embeddings + blocks)."""
        D, F, V = self.d_model, self.d_ff, self.vocab_size
        H, KV, hd = self.n_heads, self.n_kv_heads, self.hd
        n = V * D  # embed
        if not self.inputs_are_embeddings:
            n += V * D  # lm head (untied)
        per_unit = 0
        for i, kind in enumerate(self.pattern):
            if kind in ("attn", "encoder_attn"):
                per_unit += D * (H * hd) + 2 * D * (KV * hd) + (H * hd) * D
                per_unit += self._ffn_params(i)
            elif kind == "mamba":
                di = self.d_inner
                per_unit += 2 * D * di  # in_proj (x, z)
                per_unit += self.conv_kernel * di
                per_unit += di * (2 * self.ssm_state_dim + 1) + di  # B,C,dt,A
                per_unit += di * D  # out proj
                per_unit += self._ffn_params(i)
            elif kind == "mlstm":
                di = self.d_inner
                per_unit += D * (4 * di) + di * D  # qkv+gates, out
            elif kind == "slstm":
                per_unit += D * (4 * D) + D * D
                per_unit += self._ffn_params(i)
        return n + per_unit * self.repeats

    def _ffn_params(self, pos: int) -> int:
        D, F = self.d_model, self.d_ff
        if F == 0:
            return 0
        dense = 3 * D * F  # SwiGLU
        if self.n_experts and pos % self.moe_every == 0:
            return self.n_experts * dense + D * self.n_experts  # + router
        return dense

    def active_param_count(self) -> int:
        """Parameters touched per token (MoE: only routed experts)."""
        if not self.n_experts:
            return self.param_count()
        full = self.param_count()
        D, F = self.d_model, self.d_ff
        moe_positions = sum(1 for i in range(len(self.pattern))
                            if self.pattern[i] in ("attn", "mamba", "slstm")
                            and i % self.moe_every == 0 and F > 0)
        dense = 3 * D * F
        inactive = (self.n_experts - self.experts_per_token) * dense
        return full - inactive * moe_positions * self.repeats


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    """One (input-shape) cell: what gets lowered in the dry-run."""

    name: str  # train_4k | prefill_32k | decode_32k | long_500k
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode

    @property
    def tokens(self) -> int:
        return self.seq_len * self.global_batch


LM_SHAPES = {
    "train_4k": ShapeSpec("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524288, 1, "decode"),
}


def reduced(cfg: ModelConfig, layers: Optional[int] = None) -> ModelConfig:
    """Smoke-test variant: same family/pattern, tiny dims."""
    unit = len(cfg.pattern)
    n_layers = layers or (2 * unit)
    n_layers = max(unit, (n_layers // unit) * unit)
    kv = max(1, min(cfg.n_kv_heads, 2))
    heads = max(kv, min(cfg.n_heads, 4))
    heads = (heads // kv) * kv or kv
    return dataclasses.replace(
        cfg,
        n_layers=n_layers,
        d_model=64,
        n_heads=heads,
        n_kv_heads=kv,
        head_dim=16,
        d_ff=cfg.d_ff and 128,
        vocab_size=min(cfg.vocab_size, 256),
        n_experts=min(cfg.n_experts, 4),
        experts_per_token=min(cfg.experts_per_token, 2),
        ssm_state_dim=8,
        chunk_size=16,
        name=cfg.name + "-smoke",
    )
