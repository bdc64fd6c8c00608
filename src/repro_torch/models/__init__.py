"""Model substrate: the GQA transformer with contiguous and paged KV-cache
decode, its routed MoE FFN (``moe``) and jamba's mamba blocks (``ssm``).
xLSTM blocks and the sharding rules are not ported yet."""

from . import layers, transformer  # noqa: F401
from .config import LM_SHAPES, ModelConfig, ShapeSpec, reduced  # noqa: F401
