"""whisper-base [audio] — enc-dec, 6L encoder + 6L decoder, d_model=512,
8H (kv=8), d_ff=2048, vocab=51865. The conv/mel frontend is a STUB (task
rules): the port is fed stub frame embeddings, a (B, S_enc, d_model) float
tensor standing for the frontend's output (seeded normal draws in the
tests and chip_smoke.py), to ``EncDecModel.encode`` / ``prefill``.
[arXiv:2212.04356; unverified]

Decoder context for train/prefill shapes is capped at 448 tokens (whisper's
max target length); the shape's seq_len drives the AUDIO frame axis."""

from ..models.common import ModelConfig

CONFIG = ModelConfig(
    name="whisper-base", family="encdec",
    n_layers=6, encoder_layers=6, d_model=512, n_heads=8, n_kv_heads=8,
    d_ff=2048, vocab=51865, head_dim=64, frontend="audio_stub",
)

SMOKE = CONFIG.scaled(n_layers=2, encoder_layers=2, d_model=64, n_heads=4,
                      n_kv_heads=4, head_dim=16, d_ff=128, vocab=256)
