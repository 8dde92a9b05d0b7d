"""moonshot-v1-16b-a3b [moe] — 48L d_model=2048 16H (kv=16, MHA) vocab=163840,
MoE: 64 experts, top-6, per-expert d_ff=1408 (kimi/moonlight).
[hf:moonshotai/Moonlight-16B-A3B; hf]"""

from ..models.common import ModelConfig

CONFIG = ModelConfig(
    name="moonshot-v1-16b-a3b", family="moe",
    n_layers=48, d_model=2048, n_heads=16, n_kv_heads=16,
    d_ff=0, vocab=163840, head_dim=128,
    n_experts=64, top_k=6, moe_d_ff=1408, rope_theta=5e6,
)

SMOKE = CONFIG.scaled(n_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
                      head_dim=16, vocab=256, n_experts=8, top_k=2,
                      moe_d_ff=32)
