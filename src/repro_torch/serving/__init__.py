"""Continuous-batching serving over the port's transformer: the slot engine
(paged and contiguous KV), its wave baseline, and the paged block pool."""

from .engine import (  # noqa: F401
    Engine,
    Request,
    WaveEngine,
    plan_batch_size,
)
from .kv import (  # noqa: F401
    DEFAULT_BLOCK_SIZE,
    BlockAllocator,
    BlockOOM,
    block_words,
    plan_pool_blocks,
    prefix_chain,
)
