"""granite-moe-1b-a400m [moe] — 32 experts top-8
(hf:ibm-granite/granite-3.0-1b-a400m-base; hf).

24L d_model=1024 16H (GQA kv=8) d_ff=512 vocab=49155, MoE 32e top-8.
"""

from repro_torch.models.lm.config import MoEConfig, ModelConfig

CONFIG = ModelConfig(
    name="granite-moe-1b-a400m",
    family="moe",
    num_layers=24,
    d_model=1024,
    num_heads=16,
    num_kv_heads=8,
    head_dim=64,
    d_ff=0,  # all FFNs are MoE
    vocab_size=49_155,
    moe=MoEConfig(
        num_experts=32,
        top_k=8,
        d_ff_expert=512,
        group_size=128,  # small d_ff ⇒ small groups keep dispatch overhead low
        capacity_factor=1.25,
    ),
    tie_embeddings=True,
)
