"""jamba-1.5-large-398b [hybrid] — Mamba+attn 1:7 interleave, MoE
(arXiv:2403.19887; hf).

72L d_model=8192 64H (GQA kv=8) d_ff=24576 vocab=65536, MoE 16e top-2.
Period-8 blocks: attention at in-period index 4, Mamba elsewhere; MoE replaces
the MLP on odd in-period layers (Jamba's every-other-layer MoE).
"""

from repro_torch.models.lm.config import HybridConfig, MoEConfig, ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="jamba-1.5-large-398b",
    family="hybrid",
    num_layers=72,
    d_model=8192,
    num_heads=64,
    num_kv_heads=8,
    head_dim=128,
    d_ff=24576,
    vocab_size=65_536,
    moe=MoEConfig(
        num_experts=16,
        top_k=2,
        d_ff_expert=24576,
        group_size=256,
        capacity_factor=1.25,
    ),
    ssm=SSMConfig(d_state=128, d_conv=4, expand=2, head_dim=64, chunk=128, head_block=16),  # chunk 256->128: SSD HBM traffic -18% (EXPERIMENTS.md §Perf)
    hybrid=HybridConfig(period=8, attn_index=4, moe_every=2, moe_offset=1),
    fsdp=True,
    subquadratic=True,  # hybrid: long_500k cell applies
    max_seq_len=32_768,
    opt_state_dtype="bfloat16",  # 398B: params+mu+nu = 6B/param -> 9.3 GB/chip @256
)
