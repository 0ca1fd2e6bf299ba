"""whisper-base [audio] — enc-dec, conv frontend stub (arXiv:2212.04356).

6L d_model=512 8H (MHA) d_ff=2048 vocab=51865. The assignment specifies the
transformer BACKBONE; ``input_specs`` feeds precomputed (B, 1500, 512) frame
embeddings (the conv1d×2 + sinusoidal-position frontend is the stub).
Decoder runs at the assigned shapes; encoder at its native 1500 frames.
"""

from repro_torch.models.lm.config import ModelConfig

CONFIG = ModelConfig(
    name="whisper-base",
    family="encdec",
    num_layers=6,  # decoder layers
    num_encoder_layers=6,
    encoder_seq=1500,
    d_model=512,
    num_heads=8,
    num_kv_heads=8,
    head_dim=64,
    d_ff=2048,
    vocab_size=51_865,
)
