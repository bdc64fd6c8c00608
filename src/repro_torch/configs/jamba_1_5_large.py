"""jamba-1.5-large-398b [hybrid]: 72L d_model=8192 64H (GQA kv=8)
d_ff=24576, vocab=65536, MoE 16e top-2, Mamba+attn 1:7 interleave.
[arXiv:2403.19887; hf]

Pattern unit: 8 blocks (attn at position 4, mamba elsewhere) repeated 9x;
MoE FFN on every other position (moe_every=2), dense SwiGLU otherwise.
The port runs all three block kinds. At published widths one pattern unit's
four MoE FFNs hold 38.7 B parameters (77 GB in bf16), more than the card, so
the card serves a unit with experts off (``dataclasses.replace(CONFIG,
n_experts=0, experts_per_token=0, n_layers=8)``); the experts are held
against the reference on SMOKE.
"""
from repro_torch.models.config import ModelConfig, reduced

CONFIG = ModelConfig(
    name="jamba-1.5-large", family="hybrid",
    n_layers=72, d_model=8192, n_heads=64, n_kv_heads=8,
    d_ff=24576, vocab_size=65536,
    pattern=("mamba", "mamba", "mamba", "mamba", "attn",
             "mamba", "mamba", "mamba"),
    n_experts=16, experts_per_token=2, moe_every=2,
    ssm_expand=2, ssm_state_dim=16, conv_kernel=4, chunk_size=256,
)
SMOKE = reduced(CONFIG)
