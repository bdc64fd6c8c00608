"""internvl2-1b [vlm]: 24L d_model=896 14H (GQA kv=2) d_ff=4864
vocab=151655 - InternViT frontend STUBBED (input_specs provides patch
embeddings); the LM backbone decodes text. [arXiv:2404.16821; hf]"""
from repro_torch.models.config import ModelConfig, reduced

CONFIG = ModelConfig(
    name="internvl2-1b", family="vlm",
    n_layers=24, d_model=896, n_heads=14, n_kv_heads=2,
    d_ff=4864, vocab_size=151655, pattern=("attn",),
    inputs_are_embeddings=True,  # train/prefill consume stub patch embeds
)
SMOKE = reduced(CONFIG)
