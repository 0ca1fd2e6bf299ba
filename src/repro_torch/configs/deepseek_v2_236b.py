"""deepseek-v2-236b [moe] — MLA kv_lora=512, 2 shared + 160 routed top-6
(arXiv:2405.04434; hf).

60L d_model=5120 128H d_ff(expert)=1536 vocab=102400; first layer dense
(d_ff 12288), layers 1..59 MoE. Decode uses the absorbed-MLA cache
(kv_lora 512 + rope 64 per token).
"""

from repro_torch.models.lm.config import MLAConfig, MoEConfig, ModelConfig

CONFIG = ModelConfig(
    name="deepseek-v2-236b",
    family="moe",
    num_layers=60,
    d_model=5120,
    num_heads=128,
    num_kv_heads=128,  # MLA: all heads read the shared latent
    head_dim=128,
    d_ff=12288,  # dense first layer
    vocab_size=102_400,
    mla=MLAConfig(
        kv_lora_rank=512,
        q_lora_rank=1536,
        rope_head_dim=64,
        nope_head_dim=128,
        v_head_dim=128,
    ),
    moe=MoEConfig(
        num_experts=160,
        top_k=6,
        d_ff_expert=1536,
        num_shared_experts=2,
        first_dense=1,
        group_size=256,
        capacity_factor=1.25,
    ),
    fsdp=True,
    opt_state_dtype="bfloat16",  # 236B: params+mu+nu = 6B/param -> 5.5 GB/chip @256
)
