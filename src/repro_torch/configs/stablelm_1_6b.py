"""stablelm-1.6b [dense]: 24L d_model=2048 32H (GQA kv=32) d_ff=5632
vocab=100352. [hf:stabilityai/stablelm-2-1_6b; unverified]"""
from repro_torch.models.config import ModelConfig, reduced

CONFIG = ModelConfig(
    name="stablelm-1.6b", family="dense",
    n_layers=24, d_model=2048, n_heads=32, n_kv_heads=32,
    d_ff=5632, vocab_size=100352, pattern=("attn",),
)
SMOKE = reduced(CONFIG)
