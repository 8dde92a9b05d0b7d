"""mamba2-1.3b [ssm] — 48L d_model=2048, attention-free SSD
(state-space duality), ssm_state=128, vocab=50280.
[arXiv:2405.21060; unverified]"""

from ..models.common import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-1.3b", family="ssm",
    n_layers=48, d_model=2048, n_heads=1, n_kv_heads=1,  # attn-free
    d_ff=0, vocab=50280,
    ssm_state=128, ssm_heads=64, ssm_head_dim=64,        # expand=2 -> d_in=4096
)

SMOKE = CONFIG.scaled(n_layers=2, d_model=64, vocab=256,
                      ssm_state=16, ssm_heads=4, ssm_head_dim=32)
