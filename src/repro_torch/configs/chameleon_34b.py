"""chameleon-34b [vlm] — early-fusion VLM: 48L d_model=8192 64H (GQA kv=8)
d_ff=22016 over a fused text+VQ-image token vocab of 65536. The VQ-VAE image
tokenizer is a STUB (task rules): the port is fed token ids in the fused
vocab, (B, S) integers in [0, 65536) as ``Model.prefill`` and
``Engine.generate`` take any decoder's prompts; no image is tokenized.
[arXiv:2405.09818; unverified]"""

from ..models.common import ModelConfig

CONFIG = ModelConfig(
    name="chameleon-34b", family="vlm",
    n_layers=48, d_model=8192, n_heads=64, n_kv_heads=8,
    d_ff=22016, vocab=65536, head_dim=128, frontend="vq_stub",
)

SMOKE = CONFIG.scaled(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
                      head_dim=16, d_ff=128, vocab=256)
