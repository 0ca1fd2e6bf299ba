"""minitron-8b [dense] — pruned Nemotron (arXiv:2407.14679; hf).

32L d_model=4096 32H (GQA kv=8) d_ff=16384 vocab=256000.
"""

from repro_torch.models.lm.config import ModelConfig

CONFIG = ModelConfig(
    name="minitron-8b",
    family="dense",
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    head_dim=128,
    d_ff=16384,
    vocab_size=256_000,
    fsdp=True,  # 8B params + fp32 Adam state want ZeRO sharding on v5e-16GB
    attn_chunk=2048,  # flash tile 1024->2048: -6.4% HBM term (EXPERIMENTS.md §Perf)
)
