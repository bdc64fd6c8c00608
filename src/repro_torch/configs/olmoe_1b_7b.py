"""olmoe-1b-7b [moe]: 16L d_model=2048 16H (GQA kv=16) d_ff=1024
vocab=50304, MoE 64 experts top-8. [arXiv:2409.02060; hf]"""
from repro_torch.models.config import ModelConfig, reduced

CONFIG = ModelConfig(
    name="olmoe-1b-7b", family="moe",
    n_layers=16, d_model=2048, n_heads=16, n_kv_heads=16,
    d_ff=1024, vocab_size=50304, pattern=("attn",),
    n_experts=64, experts_per_token=8,
)
SMOKE = reduced(CONFIG)
