"""mamba2-130m [ssm] — SSD, attention-free (arXiv:2405.21060; unverified).

24L d_model=768 ssm_state=128 vocab=50280.
"""

from repro_torch.models.lm.config import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="mamba2-130m",
    family="ssm",
    num_layers=24,
    d_model=768,
    num_heads=0,
    num_kv_heads=0,
    head_dim=0,
    d_ff=0,
    vocab_size=50_280,
    ssm=SSMConfig(d_state=128, d_conv=4, expand=2, head_dim=64, chunk=256),
    tie_embeddings=True,
    subquadratic=True,  # SSM: long_500k cell applies (O(1) state per token)
    max_seq_len=524_288,
)
