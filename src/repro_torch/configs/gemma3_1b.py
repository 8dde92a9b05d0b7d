"""gemma3-1b [dense] — 26L d_model=1152 4H (GQA kv=1) d_ff=6912 vocab=262144,
5:1 local:global sliding-window attention, 128k context, tied embeddings.
[hf:google/gemma-3-1b-pt; unverified]"""

from ..models.common import ModelConfig

CONFIG = ModelConfig(
    name="gemma3-1b", family="dense",
    n_layers=26, d_model=1152, n_heads=4, n_kv_heads=1,
    d_ff=6912, vocab=262144, head_dim=256,
    sliding_window=512, global_every=6,      # 5 local : 1 global
    tie_embeddings=True, rope_theta=1e6,
)

SMOKE = CONFIG.scaled(n_layers=6, d_model=64, n_heads=4, n_kv_heads=1,
                      head_dim=16, d_ff=128, vocab=512, sliding_window=8)
