"""Model substrate: the GQA transformer with contiguous (split or fused
K/V) and paged KV-cache decode, its routed MoE FFN (``moe``), jamba's mamba
blocks (``ssm``) and xLSTM's mLSTM and sLSTM blocks (``xlstm``, over
``scan_util``). The sharding rules are not ported yet."""

from . import layers, transformer  # noqa: F401
from .config import LM_SHAPES, ModelConfig, ShapeSpec, reduced  # noqa: F401
