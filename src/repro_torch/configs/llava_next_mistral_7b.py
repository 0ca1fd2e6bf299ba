"""llava-next-mistral-7b [vlm] — anyres tiling stub
(hf:llava-hf/llava-v1.6-mistral-7b-hf; unverified).

Mistral-7B backbone: 32L d_model=4096 32H (GQA kv=8) d_ff=14336 vocab=32000.
The vision tower is a STUB: ``input_specs`` supplies (B, 576, 1024) patch
embeddings (CLIP-ViT-L/14 336px grid) which a learned projector maps to
d_model and prepends to the token sequence (anyres tiling collapses to the
base 576-token grid in the stub).
"""

from repro_torch.models.lm.config import ModelConfig

CONFIG = ModelConfig(
    name="llava-next-mistral-7b",
    family="vlm",
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    head_dim=128,
    d_ff=14336,
    vocab_size=32_000,
    num_image_tokens=576,
    fsdp=True,
)
