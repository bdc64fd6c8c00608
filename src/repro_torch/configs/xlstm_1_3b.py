"""xlstm-1.3b [ssm]: 48L d_model=2048 4H d_ff=0 vocab=50304 - alternating
mLSTM + sLSTM blocks. [arXiv:2405.04517; unverified]

Pattern unit: an mLSTM block (hd = d_model / n_heads = 512: a (512, 512)
f32 matrix state a head) and an sLSTM block, repeated 24 times; no FFN.
``ModelConfig.param_count`` counts the mLSTM projections at ``d_inner``
(1,715,994,624, as the reference does), while the blocks hold (D, D)
projections: the model builds 1,113,229,504 parameters."""
from repro_torch.models.config import ModelConfig, reduced

CONFIG = ModelConfig(
    name="xlstm-1.3b", family="ssm",
    n_layers=48, d_model=2048, n_heads=4, n_kv_heads=4,
    d_ff=0, vocab_size=50304, pattern=("mlstm", "slstm"),
    ssm_expand=2, chunk_size=256,
)
SMOKE = reduced(CONFIG)
