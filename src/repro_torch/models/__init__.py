"""Model substrate: the dense GQA transformer (``("attn",)`` pattern) with
contiguous and paged KV-cache decode. MoE, mamba and xLSTM blocks, and the
sharding rules, are not ported yet."""

from . import layers, transformer  # noqa: F401
from .config import LM_SHAPES, ModelConfig, ShapeSpec, reduced  # noqa: F401
