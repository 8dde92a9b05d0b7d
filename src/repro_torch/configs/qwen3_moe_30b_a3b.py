"""qwen3-moe-30b-a3b [moe] — 48L d_model=2048 32H (GQA kv=4) vocab=151936,
MoE: 128 experts, top-8, per-expert d_ff=768.  [hf:Qwen/Qwen3-30B-A3B; hf]"""

from ..models.common import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-moe-30b-a3b", family="moe",
    n_layers=48, d_model=2048, n_heads=32, n_kv_heads=4,
    d_ff=0, vocab=151936, head_dim=128,
    n_experts=128, top_k=8, moe_d_ff=768, rope_theta=1e6,
)

SMOKE = CONFIG.scaled(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
                      head_dim=16, vocab=256, n_experts=8, top_k=2,
                      moe_d_ff=32)
