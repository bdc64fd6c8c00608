"""hubert-xlarge [audio]: 48L d_model=1280 16H d_ff=5120 vocab=504 -
encoder-only backbone; the conv waveform frontend is a STUB (frame
embeddings enter through ``embeds=``). [arXiv:2106.07447; unverified]

Encoder-only: no decode shapes. Its head dim is 1280 / 16 = 80, the
``(80, 64)`` instance of the flash kernel on the H100."""
from repro_torch.models.config import ModelConfig, reduced

CONFIG = ModelConfig(
    name="hubert-xlarge", family="encoder",
    n_layers=48, d_model=1280, n_heads=16, n_kv_heads=16,
    d_ff=5120, vocab_size=504, pattern=("attn",),
    causal=False, inputs_are_embeddings=True,
)
SMOKE = reduced(CONFIG)
