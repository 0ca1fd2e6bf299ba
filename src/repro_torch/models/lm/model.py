"""Model assembly of the LM families: forward, prefill and decode.

The counterpart of ``repro/models/lm/model.py`` for every family: the
dense family (every layer ``attn + mlp``), MoE (``attn + moe`` after an
optional dense prefix of ``moe.first_dense`` layers), the attention GQA
or, under ``cfg.mla`` (deepseek-v2), MLA; the ssm family (``mamba +
none``, mamba2-130m: Mamba-2 blocks with no FFN, hence no ``ln2``, as the
reference builds them); the hybrid (Jamba's period of
``cfg.hybrid.period`` layers: GQA at ``attn_index``, Mamba-2 elsewhere, each
followed by an MLP, or an MoE where ``layer % moe_every == moe_offset``); and
the encoder–decoder (Whisper: ``cfg.num_encoder_layers`` non-causal ``attn +
mlp`` blocks over the frame embeddings, then ``enc_norm``; every decoder
block a causal ``attn + mlp`` with cross-attention onto that memory between
the two); and the vlm (LLaVA: dense blocks behind an image prefix, the
stub vision tower's ``img_embeds`` (B, n_img, ``VISION_WIDTH``) through
``img_proj`` and put before the token embeddings, :func:`_inputs_to_h`).
The reference runs each layer group as a ``lax.scan`` over stacked
parameters; the port keeps ``layer_specs`` and ``layer_groups`` as
they are (pure data) and runs a Python loop over an ``nn.ModuleList`` of
:class:`Block`, each built for its ``layer_specs`` entry. Nothing is built
from ``layer_groups``, so a depth the reference's period assert refuses
(jamba cut to 5 of its 8-layer period, to fit one card) builds and runs.
The three execution paths share the block: ``forward`` (the whole
sequence, also the training path), ``prefill`` (forward plus each layer's
cache: k/v for GQA and the latents ``c_kv`` and ``k_rope`` for MLA, padded
to ``max_len``; for Mamba-2 the conv windows and the recurrent state,
:class:`repro_torch.models.lm.mamba2.SSMCache`, the same size at any length)
and ``decode_step`` (one token against the caches, which it updates in
place; MLA in its absorbed form, Mamba-2 one recurrent step). The encoder
runs once a prompt: ``forward`` and ``prefill`` take ``enc_frames`` (B,
T_enc, d) and encode them, ``prefill`` returns the memory, and
``decode_step`` takes it back (cross-attention projects its k and v again
every step, as the reference's does). Without frames a decoder block skips
its cross-attention, as the reference's blocks do. An MoE block's FFN is
:func:`repro_torch.models.lm.moe.moe_forward` in forward and prefill, and in
decode (``MoE.decode``) the one ``cfg.moe_decode_impl`` names
(``"dispatch"``, the default, or ``"gather"``); ``forward`` returns the sum
of the blocks' aux losses, as the reference's ``_run_groups`` does.

Remat: the reference wraps each layer group's period in ``jax.checkpoint``
under ``cfg.remat="full"`` (``_maybe_remat``, :303), the default of every
config. ``forward`` does the same per block while autograd records
(:class:`_Remat`): a block's forward runs without recording, its inputs
alone kept, and the backward runs it again recording and takes its
gradients from that, so the flash forward (or the SSD) runs twice a layer
and a training step holds one layer's activations at a time. The
gradients are those of the reference's per-period checkpoint. The encoder
is not rematerialized (the reference's ``_encode`` is not checkpointed).
``"none"`` runs plain; ``"dots"`` (save the matrix products' outputs), which
no config sets, raises.

The image prefix: ``forward`` and ``prefill`` take ``img_embeds`` (a vlm
config; ignored by the others and absent from a token-only batch, as in
the reference). The prefix and the text are one causal sequence, positions
``arange`` over both, no query offset and no padding, so every flash row
sees a kv position. A caller sizes the caches for prefix + prompt + the
tokens to generate.
"""

from __future__ import annotations

import dataclasses
from typing import List, NamedTuple, Optional, Tuple, Union

import torch
from torch import nn
from torch.autograd.function import once_differentiable

from repro_torch.models.lm import attention as attn
from repro_torch.models.lm import mamba2 as m2
from repro_torch.models.lm import moe as moe_lib
from repro_torch.models.lm.config import VISION_WIDTH, ModelConfig
from repro_torch.models.lm.placement import like, rows
from repro_torch.models.lm.layers import (
    MLP,
    dtype_of,
    embed_lookup,
    trainable,
    init_embed,
    linear_param,
    rmsnorm,
)

Cache = Union[attn.Cache, m2.SSMCache]
Caches = List[Cache]


class LayerSpec(NamedTuple):
    mixer: str  # "attn" | "mla" | "mamba"
    ffn: str  # "mlp" | "moe" | "none"
    cross: bool = False
    causal: bool = True


@dataclasses.dataclass(frozen=True)
class GroupSpec:
    specs: Tuple[LayerSpec, ...]  # one period
    repeat: int


DENSE = LayerSpec(mixer="attn", ffn="mlp")
MOE = LayerSpec(mixer="attn", ffn="moe")
MAMBA = LayerSpec(mixer="mamba", ffn="none")
DECODER = LayerSpec(mixer="attn", ffn="mlp", cross=True)  # Whisper's decoder block
ENCODER = LayerSpec(mixer="attn", ffn="mlp", causal=False)  # the reference's enc_spec
SUPPORTED = (DENSE, MOE, LayerSpec(mixer="mla", ffn="mlp"), LayerSpec(mixer="mla", ffn="moe"),
             MAMBA, LayerSpec(mixer="mamba", ffn="mlp"), LayerSpec(mixer="mamba", ffn="moe"),
             DECODER)


def layer_specs(cfg: ModelConfig) -> List[LayerSpec]:
    moe_set = set(cfg.moe_layer_indices())
    attn_set = set(cfg.attn_layer_indices())
    specs = []
    for i in range(cfg.num_layers):
        if i in attn_set:
            mixer = "mla" if cfg.mla is not None else "attn"
        else:
            mixer = "mamba"
        if mixer == "mamba" and cfg.hybrid is None:
            ffn = "none"  # pure Mamba blocks have no FFN
        elif i in moe_set:
            ffn = "moe"
        else:
            ffn = "mlp" if cfg.d_ff > 0 else "none"
        specs.append(LayerSpec(mixer=mixer, ffn=ffn, cross=(cfg.num_encoder_layers > 0)))
    return specs


def layer_groups(cfg: ModelConfig) -> List[GroupSpec]:
    specs = layer_specs(cfg)
    n = len(specs)
    if cfg.hybrid is not None:
        p = cfg.hybrid.period
        assert n % p == 0
        return [GroupSpec(specs=tuple(specs[:p]), repeat=n // p)]
    # leading irregular prefix (e.g. DeepSeek-V2 first dense layer)
    prefix = 0
    while prefix < n and specs[prefix] != specs[-1]:
        prefix += 1
    groups: List[GroupSpec] = []
    if prefix:
        groups.append(GroupSpec(specs=tuple(specs[:prefix]), repeat=1))
    if n - prefix:
        groups.append(GroupSpec(specs=(specs[-1],), repeat=n - prefix))
    return groups


def check_supported(cfg: ModelConfig) -> None:
    """Raise unless every layer of ``cfg`` is one :data:`SUPPORTED` spec: the
    dense, vlm, MoE, ssm, hybrid and encoder–decoder families, every config
    the repo has."""
    odd = sorted({f"{s.mixer}+{s.ffn}" + ("+cross" if s.cross else "")
                  for s in layer_specs(cfg) if s not in SUPPORTED})
    if odd:
        raise NotImplementedError(f"{cfg.name} ({cfg.family}) needs {', '.join(odd)}, which no "
                                  "block of the port builds")


class RMSNorm(nn.Module):
    def __init__(self, d: int, eps: float, *, dtype: torch.dtype, device=None):
        super().__init__()
        self.eps = eps
        self.scale = trainable(torch.ones((d,), dtype=dtype, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return rmsnorm(x, self.scale, self.eps)


class Block(nn.Module):
    """One layer: x + mixer(ln1(x)), then (``spec.cross``, given a memory)
    + cross(ln_cross(·), memory), then + ffn(ln2(·)). The mixer is
    :class:`~repro_torch.models.lm.attention.GQA` (causal unless
    ``spec.causal`` is False: the encoder's), ``MLA`` or Mamba-2 as
    ``spec.mixer`` says; the cross-attention
    :class:`~repro_torch.models.lm.attention.Cross`; the FFN an ``mlp``, a
    ``moe`` or, with ``ffn="none"`` (the ssm family), nothing and no
    ``ln2``."""

    def __init__(self, cfg: ModelConfig, spec: LayerSpec = DENSE, *, generator=None,
                 device=None):
        super().__init__()
        self.spec = spec
        dtype = dtype_of(cfg.param_dtype)
        self.ln1 = RMSNorm(cfg.d_model, cfg.norm_eps, dtype=dtype, device=device)
        if spec.mixer == "mamba":
            self.mamba = m2.Mamba2(cfg, generator=generator, device=device)
        else:
            mixer = attn.MLA if spec.mixer == "mla" else attn.GQA
            self.attn = mixer(cfg, generator=generator, device=device)
        if spec.cross:
            self.ln_cross = RMSNorm(cfg.d_model, cfg.norm_eps, dtype=dtype, device=device)
            self.cross = attn.Cross(cfg, generator=generator, device=device)
        if spec.ffn == "none":
            return
        self.ln2 = RMSNorm(cfg.d_model, cfg.norm_eps, dtype=dtype, device=device)
        if spec.ffn == "moe":
            self.moe = moe_lib.MoE(cfg, generator=generator, device=device)
        else:
            self.mlp = MLP(cfg.d_model, cfg.d_ff, generator=generator, dtype=dtype, device=device)

    def ffn(self, x: torch.Tensor, decode: bool = False
            ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        """x + ffn(ln2(x)), and the MoE aux loss (None for an mlp or none); ``decode``
        runs the MoE's decode-time form (:meth:`repro_torch.models.lm.moe.MoE.decode`)."""
        if self.spec.ffn == "none":
            return x, None
        if self.spec.ffn == "moe":
            y, aux = (self.moe.decode if decode else self.moe)(self.ln2(x))
            return x + rows(y), aux
        return x + rows(self.mlp(self.ln2(x))), None

    def mix_memory(self, x: torch.Tensor, memory: Optional[torch.Tensor]) -> torch.Tensor:
        """x + cross(ln_cross(x), memory); x itself without cross-attention or memory."""
        if not self.spec.cross or memory is None:
            return x
        return x + rows(self.cross(self.ln_cross(x), memory))

    def forward(self, x: torch.Tensor, positions: torch.Tensor,
                memory: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        """(the block's output, its aux loss: None unless an MoE block)."""
        h = self.ln1(x)
        if self.spec.mixer == "mamba":
            h = self.mamba(h)
        elif self.spec.causal:
            h = self.attn(h, positions)
        else:
            h = self.attn(h, positions, causal=False)
        return self.ffn(self.mix_memory(x + rows(h), memory))

    def prefill(
        self, x: torch.Tensor, positions: torch.Tensor, max_len: int,
        memory: Optional[torch.Tensor] = None,
    ) -> Tuple[torch.Tensor, Cache]:
        """Forward + this layer's cache: an attention cache zero beyond the
        prompt up to ``max_len``; Mamba-2's state after the prompt (the
        chunked forward, then ``ssm_state_after``, as the reference)."""
        h_in = self.ln1(x)
        if self.spec.mixer == "mamba":
            h = self.mamba(h_in)
            cache = m2.ssm_state_after(self.mamba, h_in)
        else:
            h, cache = self.attn.prefill(h_in, positions, max_len)
        return self.ffn(self.mix_memory(x + rows(h), memory))[0], cache

    def decode(
        self, x: torch.Tensor, cache: Cache, position: int,
        memory: Optional[torch.Tensor] = None,
    ) -> Tuple[torch.Tensor, Cache]:
        if self.spec.mixer == "mamba":
            h, cache = m2.mamba2_decode(self.mamba, self.ln1(x), cache)
        else:
            h, cache = self.attn.decode(self.ln1(x), cache, position)
        return self.ffn(self.mix_memory(x + rows(h), memory), decode=True)[0], cache


class LM(nn.Module):
    """The LM: ``embed`` (V, d), ``blocks`` (one a layer, each built for its
    ``layer_specs`` entry), ``final_norm``, and ``lm_head`` (d, V) unless
    ``cfg.tie_embeddings`` (then the head is ``embed.T``, as mamba2-130m's);
    with ``cfg.num_encoder_layers``, ``encoder`` (that many :data:`ENCODER`
    blocks) and ``enc_norm``; with ``cfg.num_image_tokens``, ``img_proj``
    (``VISION_WIDTH``, d), drawn last."""

    def __init__(self, cfg: ModelConfig, *, generator=None, device=None):
        super().__init__()
        check_supported(cfg)
        self.cfg = cfg
        dtype = dtype_of(cfg.param_dtype)
        if generator is None:
            embed = torch.zeros((cfg.vocab_size, cfg.d_model), dtype=dtype, device=device)
        else:
            embed = init_embed(cfg.vocab_size, cfg.d_model, generator=generator, device=device,
                               dtype=dtype)
        self.embed = trainable(embed)
        self.final_norm = RMSNorm(cfg.d_model, cfg.norm_eps, dtype=dtype, device=device)
        self.lm_head = None if cfg.tie_embeddings else linear_param(
            cfg.d_model, cfg.vocab_size, generator=generator, device=device, dtype=dtype)
        self.blocks = nn.ModuleList(
            Block(cfg, spec, generator=generator, device=device) for spec in layer_specs(cfg)
        )
        if cfg.num_encoder_layers:
            self.encoder = nn.ModuleList(Block(cfg, ENCODER, generator=generator, device=device)
                                         for _ in range(cfg.num_encoder_layers))
            self.enc_norm = RMSNorm(cfg.d_model, cfg.norm_eps, dtype=dtype, device=device)
        if cfg.num_image_tokens:
            self.img_proj = linear_param(VISION_WIDTH, cfg.d_model, generator=generator,
                                         device=device, dtype=dtype)

    def head(self, h: torch.Tensor) -> torch.Tensor:
        h = self.final_norm(h)
        w = self.embed.T if self.lm_head is None else self.lm_head
        return h @ w.to(h.dtype)


def init_params(
    cfg: ModelConfig, *, generator: Optional[torch.Generator] = None, device=None
) -> LM:
    """The model with weights drawn from ``generator`` (zeros without one, to be
    loaded), as the reference's ``init_params`` draws them: N(0, 1)·d_in^-½
    projections, N(0, 0.02²) embedding, unit norms, all cast to
    ``cfg.param_dtype`` (Mamba-2's ``A_log``, ``dt_bias`` and ``D`` float32).
    Other numbers than the reference's: another generator."""
    return LM(cfg, generator=generator, device=device)


def _positions(h: torch.Tensor) -> torch.Tensor:
    return like(h, torch.arange(h.shape[1], device=h.device).expand(h.shape[:2]))


def _inputs_to_h(
    model: LM, tokens: torch.Tensor, img_embeds: Optional[torch.Tensor] = None
) -> Tuple[torch.Tensor, torch.Tensor, int]:
    """(h, positions, n_prefix): the token embeddings in ``cfg.dtype``, after
    the image prefix ``img_embeds @ img_proj`` (both cast to ``cfg.dtype``
    before the product, as the reference's ``_inputs_to_h``) when the config
    has image tokens and the call gives embeddings; positions ``arange`` over
    the whole sequence."""
    compute = dtype_of(model.cfg.dtype)
    h = embed_lookup(model.embed, tokens, compute)
    n_prefix = 0
    if model.cfg.num_image_tokens and img_embeds is not None:
        vis = rows(img_embeds.to(compute) @ model.img_proj.to(compute))
        h = torch.cat([vis, h], dim=1)
        n_prefix = img_embeds.shape[1]
    return h, _positions(h), n_prefix


def _encode(model: LM, enc_frames: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
    """The encoder's memory (B, T_enc, d) from frame embeddings (B, T_enc, d)
    cast to ``cfg.dtype``, positions ``arange(T_enc)``; None for a config
    without an encoder or a call without frames."""
    if not model.cfg.num_encoder_layers or enc_frames is None:
        return None
    x = enc_frames.to(dtype_of(model.cfg.dtype))
    positions = _positions(x)
    for block in model.encoder:
        x, _ = block(x, positions)
    return model.enc_norm(x)


def _remat(cfg: ModelConfig) -> bool:
    """Whether ``forward`` recomputes each block in the backward."""
    if cfg.remat == "full":
        return True
    if cfg.remat == "none":
        return False
    raise NotImplementedError(
        f"remat={cfg.remat!r} is not ported (no config sets it); the port runs 'full' and "
        "'none', the rest is ROADMAP Queue 1 item 11"
    )


class _Remat(torch.autograd.Function):
    """One block, rematerialized: the forward runs ``block(h, positions,
    memory)`` without recording and keeps h and memory; the backward runs it
    again recording and returns the gradients of h, of memory (a decoder
    block's cross-attention input: the encoder trains through it) and of
    the block's parameters (its inputs here, after h, positions and
    memory) from that run. The recorded run
    computes what the first computed (a block draws no random numbers), so
    the gradients are the un-rematerialized ones. Unlike
    ``torch.utils.checkpoint`` (non-reentrant), the first run records no
    graph and packs no saved tensors, host work that sets the time of a
    small-batch, host-bound step. Returns the block's output and its aux
    loss (a zero for a block without one)."""

    @staticmethod
    def forward(ctx, block, h, positions, memory, *params):
        ctx.block = block
        ctx.save_for_backward(h, positions, memory)
        with torch.no_grad():
            out, aux = block(h, positions, memory)
        ctx.has_aux = aux is not None
        return out, aux if ctx.has_aux else like(out, torch.zeros((), dtype=torch.float32,
                                                                  device=out.device))

    @staticmethod
    @once_differentiable
    def backward(ctx, d_out, d_aux):
        h, positions, memory = ctx.saved_tensors
        with torch.enable_grad():
            x = h.detach().requires_grad_(ctx.needs_input_grad[1])
            mem = None if memory is None else memory.detach().requires_grad_(
                ctx.needs_input_grad[3])
            out, aux = ctx.block(x, positions, mem)
            outs, grads = [out], [d_out]
            if ctx.has_aux:
                outs.append(aux)
                grads.append(d_aux)
            inputs = [t for t in (x, mem) if t is not None and t.requires_grad]
            got = list(torch.autograd.grad(outs, inputs + list(ctx.block.parameters()), grads,
                                           allow_unused=True))
        d_h = got.pop(0) if x.requires_grad else None
        d_mem = got.pop(0) if mem is not None and mem.requires_grad else None
        return (None, d_h, None, d_mem, *got)


def forward(
    model: LM, tokens: torch.Tensor, *, img_embeds: Optional[torch.Tensor] = None,
    enc_frames: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(logits (B, n_prefix + S, V), aux loss): the MoE blocks' aux losses
    summed, 0 without MoE blocks. ``img_embeds`` (B, n_img, ``VISION_WIDTH``):
    the image prefix (vlm configs); ``enc_frames`` (B, T_enc, d): the
    encoder's input (encoder–decoder configs); each ignored by the other
    configs, as in the reference."""
    remat = _remat(model.cfg) and torch.is_grad_enabled()
    memory = _encode(model, enc_frames)
    h, positions, _ = _inputs_to_h(model, tokens, img_embeds)
    auxes = []
    for block in model.blocks:
        if remat:
            h, aux = _Remat.apply(block, h, positions, memory, *block.parameters())
        else:
            h, aux = block(h, positions, memory)
        if block.spec.ffn == "moe":
            auxes.append(aux)
    aux = torch.stack(auxes).sum() if auxes else like(h, torch.zeros((), dtype=torch.float32,
                                                                    device=h.device))
    return model.head(h), aux


def init_caches(
    cfg: ModelConfig, batch: int, max_len: int, dtype: torch.dtype, device=None
) -> Caches:
    """One cache a layer: a (B, max_len, K, hd) k/v pair (GQA), MLA's
    latents ``c_kv`` (B, max_len, kv_lora) and ``k_rope`` (B, max_len, rope),
    or Mamba-2's :class:`~repro_torch.models.lm.mamba2.SSMCache` (no
    ``max_len``: the same size at any length)."""
    check_supported(cfg)

    def one(spec):
        if spec.mixer == "mamba":
            return m2.init_mamba2_cache(cfg, batch, dtype, device)
        init = attn.init_mla_cache if spec.mixer == "mla" else attn.init_gqa_cache
        return init(cfg, batch, max_len, dtype, device)

    return [one(spec) for spec in layer_specs(cfg)]


def prefill(
    model: LM, tokens: torch.Tensor, max_len: int, *,
    img_embeds: Optional[torch.Tensor] = None, enc_frames: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, Caches, Optional[torch.Tensor]]:
    """Run the prompt (after its image prefix, given ``img_embeds``): (last-token
    logits (B, 1, V), caches of ``max_len`` positions, the prefix's included,
    the encoder's memory: None without an encoder or frames), as the
    reference's."""
    memory = _encode(model, enc_frames)
    h, positions, _ = _inputs_to_h(model, tokens, img_embeds)
    caches = []
    for block in model.blocks:
        h, cache = block.prefill(h, positions, max_len, memory)
        caches.append(cache)
    return model.head(h[:, -1:]), caches, memory


def decode_step(
    model: LM,
    token: torch.Tensor,  # (B, 1) the token generated at `position` - 1
    caches: Caches,
    position: int,  # write index into the caches
    *,
    memory: Optional[torch.Tensor] = None,  # prefill's encoder memory
) -> Tuple[torch.Tensor, Caches]:
    """One decode step → (logits (B, 1, V), the caches, updated in place)."""
    h = embed_lookup(model.embed, token, dtype_of(model.cfg.dtype))
    for block, cache in zip(model.blocks, caches):
        h, _ = block.decode(h, cache, position, memory)
    return model.head(h), caches
