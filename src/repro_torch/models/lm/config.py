"""Unified model configuration covering all 10 assigned architectures.

Pure data, copied whole from ``repro/models/lm/config.py`` so that
``reduced()``, ``param_count()`` and the layer indices agree with the
reference to the digit. One dataclass describes dense GQA transformers, MoE
(incl. MLA), Mamba-2 SSD, hybrid (Jamba) interleaves, encoder–decoder
(Whisper) and VLM-stub (LLaVA) backbones; ``repro_torch/configs/<arch>.py``
instantiate it with the exact assigned numbers. The port runs every family
(:mod:`repro_torch.models.lm.model`).
"""

from __future__ import annotations

import dataclasses
from typing import Literal, Optional, Tuple

Family = Literal["dense", "moe", "ssm", "hybrid", "encdec", "vlm"]

# The stub vision tower's output width: a vlm batch's ``img_embeds`` are
# (B, num_image_tokens, VISION_WIDTH), which ``img_proj`` maps to d_model
# (the reference writes 1024 at ``models/lm/model.py:291``,
# ``data/tokens.py:70`` and ``launch/serve.py:53``).
VISION_WIDTH = 1024


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    num_experts: int = 0
    top_k: int = 1
    d_ff_expert: int = 0
    num_shared_experts: int = 0  # DeepSeek shared experts (always-on)
    # which decoder layers are MoE: every `every`-th layer, skipping the
    # first `first_dense` layers (DeepSeek-V2: first layer dense).
    every: int = 1
    first_dense: int = 0
    group_size: int = 256  # GShard dispatch group size (perf-tunable)
    capacity_factor: float = 1.25
    router_normalize_topk: bool = True  # renormalize top-k weights to sum 1


@dataclasses.dataclass(frozen=True)
class MLAConfig:
    kv_lora_rank: int = 0  # compressed KV latent dim (DeepSeek-V2: 512)
    q_lora_rank: int = 0  # 0 = full-rank q projection
    rope_head_dim: int = 64  # decoupled RoPE dims per head
    nope_head_dim: int = 128  # non-RoPE q/k dims per head
    v_head_dim: int = 128


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    d_state: int = 128
    d_conv: int = 4
    expand: int = 2
    head_dim: int = 64
    chunk: int = 256  # SSD chunk length
    head_block: int = 0  # >0: lax.map the SSD core over head blocks (memory knob)
    # dt initialization bounds (softplus-space), Mamba-2 defaults
    dt_min: float = 0.001
    dt_max: float = 0.1


@dataclasses.dataclass(frozen=True)
class HybridConfig:
    """Jamba-style interleave: one period = ``period`` layers with attention at
    ``attn_index`` and Mamba elsewhere; MoE replaces the MLP on layers where
    ``layer_in_period % moe_every == moe_offset``."""

    period: int = 8
    attn_index: int = 4
    moe_every: int = 2
    moe_offset: int = 1


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: Family
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 128
    qkv_bias: bool = False
    rope_theta: float = 10_000.0
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    # sub-configs
    moe: Optional[MoEConfig] = None
    mla: Optional[MLAConfig] = None
    ssm: Optional[SSMConfig] = None
    hybrid: Optional[HybridConfig] = None
    # encoder–decoder (whisper): encoder layer count + fixed frame count;
    # the conv frontend is a STUB — input_specs() supplies frame embeddings.
    num_encoder_layers: int = 0
    encoder_seq: int = 1500
    # VLM stub: number of image patch tokens prepended to the text sequence.
    num_image_tokens: int = 0
    # numerics / performance knobs
    dtype: str = "bfloat16"  # activation/compute dtype
    param_dtype: str = "bfloat16"
    opt_state_dtype: str = "float32"  # AdamW μ/ν storage (236B/398B: bfloat16)
    # decode-time MoE: "dispatch" = capacity-based EP (weights stay put,
    # activations move — §Perf iteration 1); "gather" = per-token weight
    # gather (dropless but moves expert matrices across shards — baseline).
    moe_decode_impl: str = "dispatch"
    remat: Literal["none", "full", "dots"] = "full"
    attn_impl: Literal["einsum", "chunked"] = "chunked"
    attn_chunk: int = 1024  # KV block for chunked (flash-style) attention
    fsdp: bool = False  # additionally shard params over the data axis (ZeRO-3)
    seq_parallel: bool = False  # Megatron-SP: shard residual S axis over 'model'
    scan_layers: bool = True
    max_seq_len: int = 32_768  # serving cache bound (long_500k overrides)
    subquadratic: bool = False  # True for SSM/hybrid: long_500k cell applies

    # ---------------------------------------------------------------- sizes
    def moe_layer_indices(self) -> Tuple[int, ...]:
        if self.moe is None:
            return ()
        if self.hybrid is not None:
            idx = []
            for i in range(self.num_layers):
                if i % self.hybrid.moe_every == self.hybrid.moe_offset:
                    idx.append(i)
            return tuple(idx)
        m = self.moe
        return tuple(
            i
            for i in range(self.num_layers)
            if i >= m.first_dense and (i - m.first_dense) % m.every == 0
        )

    def attn_layer_indices(self) -> Tuple[int, ...]:
        if self.family == "ssm":
            return ()
        if self.hybrid is not None:
            return tuple(
                i
                for i in range(self.num_layers)
                if i % self.hybrid.period == self.hybrid.attn_index
            )
        return tuple(range(self.num_layers))

    def param_count(self) -> int:
        """Total parameter count (analytic, matches init shapes)."""
        return _count_params(self, active_only=False)

    def active_param_count(self) -> int:
        """Active parameters per token (MoE: only routed top-k + shared)."""
        return _count_params(self, active_only=True)


def _attn_params(cfg: ModelConfig) -> int:
    d = cfg.d_model
    if cfg.mla is not None:
        m = cfg.mla
        h = cfg.num_heads
        q_in = (
            d * m.q_lora_rank + m.q_lora_rank * h * (m.nope_head_dim + m.rope_head_dim)
            if m.q_lora_rank
            else d * h * (m.nope_head_dim + m.rope_head_dim)
        )
        kv_down = d * (m.kv_lora_rank + m.rope_head_dim)
        kv_up = m.kv_lora_rank * h * (m.nope_head_dim + m.v_head_dim)
        out = h * m.v_head_dim * d
        # RMSNorms on the compressed latents (DeepSeek-V2 places one after
        # each down-projection)
        norms = (m.q_lora_rank if m.q_lora_rank else 0) + m.kv_lora_rank
        return q_in + kv_down + kv_up + out + norms
    hd = cfg.head_dim
    q = d * cfg.num_heads * hd
    kv = 2 * d * cfg.num_kv_heads * hd
    o = cfg.num_heads * hd * d
    bias = (cfg.num_heads * hd + 2 * cfg.num_kv_heads * hd) if cfg.qkv_bias else 0
    return q + kv + o + bias


def _mlp_params(cfg: ModelConfig, d_ff: int) -> int:
    # SwiGLU: gate + up + down
    return 3 * cfg.d_model * d_ff


def _ssm_params(cfg: ModelConfig) -> int:
    s = cfg.ssm
    d = cfg.d_model
    d_inner = s.expand * d
    n_heads = d_inner // s.head_dim
    conv_dim = d_inner + 2 * s.d_state
    in_proj = d * (2 * d_inner + 2 * s.d_state + n_heads)  # split z/x/B/C/dt
    conv = conv_dim * s.d_conv + conv_dim  # per-component kernels + biases
    extras = 3 * n_heads  # A_log, dt_bias, D
    norm = d_inner
    out_proj = d_inner * d
    return in_proj + conv + extras + norm + out_proj


def _count_params(cfg: ModelConfig, active_only: bool) -> int:
    d = cfg.d_model
    total = cfg.vocab_size * d  # embed
    if not cfg.tie_embeddings:
        total += cfg.vocab_size * d  # lm head
    total += d  # final norm
    moe_layers = set(cfg.moe_layer_indices())
    attn_layers = set(cfg.attn_layer_indices())
    for i in range(cfg.num_layers):
        total += d  # ln1
        has_ffn = (i in moe_layers) or (
            cfg.d_ff > 0 and not (cfg.ssm is not None and cfg.hybrid is None)
        )
        if has_ffn:
            total += d  # ln2 (pure-Mamba blocks have no FFN, hence no ln2)
        if i in attn_layers:
            total += _attn_params(cfg)
        elif cfg.ssm is not None:
            total += _ssm_params(cfg)
        if i in moe_layers:
            m = cfg.moe
            total += d * m.num_experts  # router
            n_routed = m.top_k if active_only else m.num_experts
            total += n_routed * _mlp_params(cfg, m.d_ff_expert)
            total += m.num_shared_experts * _mlp_params(cfg, m.d_ff_expert)
        elif cfg.family != "ssm" and cfg.d_ff > 0:
            total += _mlp_params(cfg, cfg.d_ff)
    if cfg.num_encoder_layers:
        for _ in range(cfg.num_encoder_layers):
            total += 2 * d + _attn_params(cfg) + _mlp_params(cfg, cfg.d_ff)
        total += d  # enc_norm
        # decoder cross-attention (one per decoder layer)
        total += cfg.num_layers * (_attn_params(cfg) + cfg.d_model)
    if cfg.num_image_tokens:
        total += VISION_WIDTH * d  # img_proj from the stub vision-tower width
    return int(total)


def reduced(cfg: ModelConfig, **overrides) -> ModelConfig:
    """Shrink a config for CPU smoke tests, preserving the family structure."""
    changes: dict = dict(
        num_layers=min(cfg.num_layers, 4 if cfg.hybrid is None else cfg.hybrid.period),
        d_model=128,
        num_heads=4,
        num_kv_heads=min(cfg.num_kv_heads, 2),
        head_dim=32,
        d_ff=256,
        vocab_size=512,
        num_encoder_layers=min(cfg.num_encoder_layers, 2),
        encoder_seq=min(cfg.encoder_seq, 16),
        num_image_tokens=min(cfg.num_image_tokens, 8),
        max_seq_len=128,
        remat="none",
        dtype="float32",
        param_dtype="float32",
        fsdp=False,
    )
    if cfg.moe is not None:
        changes["moe"] = dataclasses.replace(
            cfg.moe,
            num_experts=min(cfg.moe.num_experts, 8),
            top_k=min(cfg.moe.top_k, 2),
            d_ff_expert=64,
            num_shared_experts=min(cfg.moe.num_shared_experts, 1),
            group_size=16,
            capacity_factor=4.0,  # dropless at smoke scale (consistency tests)
        )
    if cfg.mla is not None:
        changes["mla"] = dataclasses.replace(
            cfg.mla,
            kv_lora_rank=32,
            q_lora_rank=(48 if cfg.mla.q_lora_rank else 0),
            rope_head_dim=16,
            nope_head_dim=32,
            v_head_dim=32,
        )
    if cfg.ssm is not None:
        changes["ssm"] = dataclasses.replace(
            cfg.ssm, d_state=16, head_dim=32, chunk=16
        )
    changes.update(overrides)
    return dataclasses.replace(cfg, **changes)
