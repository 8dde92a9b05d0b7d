"""zamba2-2.7b [hybrid] — 54L d_model=2560, Mamba2 backbone (ssm_state=64)
with ONE shared attention+MLP block applied every 6 layers (9 sites,
32H MHA, d_ff=10240), vocab=32000.  [arXiv:2411.15242; hf]

Simplification noted in DESIGN.md: the shared block is a standard
attn+MLP residual block (Zamba2 concatenates the original embedding input;
we keep the residual form — systems-equivalent compute/communication)."""

from ..models.common import ModelConfig

CONFIG = ModelConfig(
    name="zamba2-2.7b", family="hybrid",
    n_layers=54, d_model=2560, n_heads=32, n_kv_heads=32,
    d_ff=10240, vocab=32000, head_dim=80,
    ssm_state=64, ssm_heads=80, ssm_head_dim=64,   # expand=2 -> d_in=5120
    attn_every=6, rope_theta=1e4,
)

SMOKE = CONFIG.scaled(n_layers=4, d_model=64, n_heads=4, n_kv_heads=4,
                      head_dim=16, d_ff=128, vocab=256,
                      ssm_state=16, ssm_heads=4, ssm_head_dim=32,
                      attn_every=2)
