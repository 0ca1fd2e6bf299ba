"""The port's LM sidecar (dense family, serving path) on the CPU against ``repro``.

Config: ``reduced(get_config("llama3_2_3b"), attn_chunk=32)`` — 4 layers,
d 128, 4/2 heads, hd 32, float32 — so an 80-token prompt takes the flash
path in prefill (S > attn_chunk, with a ragged tail of 16 past the last
full 64-row tile), and decode the einsum path over the cache. The
reference's ``init_params`` weights cross through
``repro_torch.interop.from_reference_lm_params``; tokens are drawn with
numpy from a seed and fed to both. Tolerances, float32: 1e-5 for the
layers (elementwise float32 maths, sums of ≤ 256 terms), 1e-4 on logits
of size ~1 (four layers of matrix products summed in other orders than
XLA's); bfloat16: 5e-2 on the logits (4 layers of bf16 activations, each
rounding at 2^-8 relative, in other places than XLA).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ALIASES as REF_ALIASES
from repro.configs import ARCH_IDS as REF_ARCH_IDS
from repro.configs import SHAPES as REF_SHAPES
from repro.configs import all_cells as ref_all_cells
from repro.configs import get_config as ref_get_config
from repro.models.lm import layers as ref_layers
from repro.models.lm import model as ref_mdl
from repro.models.lm.config import reduced as ref_reduced
from repro_torch.configs import ALIASES, ARCH_IDS, SHAPES, all_cells, get_config
from repro_torch.interop import from_reference_lm_params
from repro_torch.launch import serve
from repro_torch.models.lm import attention as attn
from repro_torch.models.lm import layers, steps
from repro_torch.models.lm import model as mdl
from repro_torch.models.lm.config import reduced
from test_torch_threads import pin_torch_threads

pin_torch_threads()  # this worker's share of the cores under a parallel run

ARCH = "llama3_2_3b"
# every dense config: untied heads (minitron, qwen, deepseek-coder), QKV
# biases (qwen), the tied head and RoPE θ 500,000 (llama3.2)
DENSE_ARCHS = [a for a in REF_ARCH_IDS if ref_get_config(a).family == "dense"]
PROMPT, GEN, B = 80, 4, 2


def _cfgs(dtype="float32", arch=ARCH):
    ref = ref_reduced(ref_get_config(arch), attn_chunk=32)
    port = reduced(get_config(arch), attn_chunk=32)
    if dtype != "float32":
        ref = dataclasses.replace(ref, dtype=dtype, param_dtype=dtype)
        port = dataclasses.replace(port, dtype=dtype, param_dtype=dtype)
    return ref, port


def _pair(dtype="float32", seed=0, arch=ARCH):
    """(ref cfg, ref params, port cfg, port model with the same weights)."""
    ref_cfg, cfg = _cfgs(dtype, arch)
    params = ref_mdl.init_params(jax.random.PRNGKey(seed), ref_cfg)
    model = from_reference_lm_params(jax.tree.map(np.asarray, params), cfg, device="cpu")
    return ref_cfg, params, cfg, model


def _tokens(cfg, n, seed=1):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, (B, n))


def _np(x):
    return np.asarray(jnp.asarray(x, jnp.float32))


# --------------------------------------------------------------------- configs


@pytest.mark.parametrize("arch", REF_ARCH_IDS)
def test_config_data_matches_reference(arch):
    ref, port = ref_get_config(arch), get_config(arch)
    assert dataclasses.asdict(port) == dataclasses.asdict(ref)
    assert port.param_count() == ref.param_count()
    assert port.active_param_count() == ref.active_param_count()
    assert port.attn_layer_indices() == ref.attn_layer_indices()
    assert port.moe_layer_indices() == ref.moe_layer_indices()
    assert dataclasses.asdict(reduced(port)) == dataclasses.asdict(ref_reduced(ref))
    assert mdl.layer_specs(port) == [tuple(s) for s in ref_mdl.layer_specs(ref)]
    assert [(tuple(map(tuple, g.specs)), g.repeat) for g in mdl.layer_groups(port)] == \
        [(tuple(map(tuple, g.specs)), g.repeat) for g in ref_mdl.layer_groups(ref)]


def test_registry_matches_reference():
    assert ARCH_IDS == REF_ARCH_IDS and ALIASES == REF_ALIASES
    assert [tuple(s) for s in SHAPES] == [tuple(s) for s in REF_SHAPES]
    assert [(c.arch, tuple(c.shape), c.skip) for c in all_cells()] == \
        [(c.arch, tuple(c.shape), c.skip) for c in ref_all_cells()]
    # embed 128,256·3,072 = 394,002,432; each of 28 layers 25,165,824 (attn)
    # + 75,497,472 (mlp) + 6,144 (two norms); the final norm 3,072
    assert get_config("llama3.2-3b").param_count() == 3_212_749_824
    with pytest.raises(KeyError):
        get_config("no-such-arch")


# ---------------------------------------------------------------------- layers


def test_rmsnorm_rope_mlp_match_reference():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 9, 128)).astype(np.float32)
    scale = (1 + 0.1 * rng.standard_normal(128)).astype(np.float32)
    np.testing.assert_allclose(
        layers.rmsnorm(torch.from_numpy(x), torch.from_numpy(scale), 1e-5).numpy(),
        _np(ref_layers.rmsnorm({"scale": jnp.asarray(scale)}, jnp.asarray(x), 1e-5)),
        rtol=1e-5, atol=1e-5,
    )
    xr = rng.standard_normal((2, 9, 4, 32)).astype(np.float32)
    pos = np.broadcast_to(np.arange(9) + 70, (2, 9)).copy()
    np.testing.assert_allclose(
        layers.apply_rope(torch.from_numpy(xr), torch.from_numpy(pos), 500_000.0).numpy(),
        _np(ref_layers.apply_rope(jnp.asarray(xr), jnp.asarray(pos), 500_000.0)),
        rtol=1e-5, atol=1e-5,
    )
    w = {n: (rng.standard_normal(shape) / np.sqrt(shape[0])).astype(np.float32)
         for n, shape in (("w_gate", (128, 256)), ("w_up", (128, 256)), ("w_down", (256, 128)))}
    np.testing.assert_allclose(
        layers.mlp(torch.from_numpy(x), *(torch.from_numpy(w[n]) for n in ("w_gate", "w_up", "w_down"))).numpy(),
        _np(ref_layers.mlp({n: jnp.asarray(a) for n, a in w.items()}, jnp.asarray(x))),
        rtol=1e-5, atol=1e-5,
    )


def test_sdpa_paths_agree_and_dispatch_on_attn_chunk():
    """flash (S > attn_chunk) and einsum compute the same attention; the
    dispatch is the reference's: einsum at S ≤ attn_chunk."""
    _, cfg = _cfgs()
    rng = np.random.default_rng(2)
    q = torch.from_numpy(rng.standard_normal((2, 40, 4, 32)).astype(np.float32))
    k = torch.from_numpy(rng.standard_normal((2, 40, 2, 32)).astype(np.float32))
    v = torch.from_numpy(rng.standard_normal((2, 40, 2, 32)).astype(np.float32))
    flash = attn.sdpa(cfg, q, k, v, causal=True)
    einsum = attn.sdpa(dataclasses.replace(cfg, attn_chunk=64), q, k, v, causal=True)
    torch.testing.assert_close(flash, einsum, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(einsum, attn._einsum_attention(q, k, v, causal=True),
                               rtol=0, atol=0)


# ------------------------------------------------------------------ the model


def test_weight_mapping_counts_and_round_trips():
    ref_cfg, params, cfg, model = _pair()
    assert sum(p.numel() for p in model.parameters()) == cfg.param_count() == ref_cfg.param_count()
    sd = model.state_dict()
    np.testing.assert_array_equal(sd["blocks.2.attn.w_k"].numpy(),
                                  np.asarray(params["g0"]["l0"]["attn"]["w_k"]["w"][2]))
    np.testing.assert_array_equal(sd["blocks.3.mlp.w_down"].numpy(),
                                  np.asarray(params["g0"]["l0"]["mlp"]["w_down"][3]))
    # bf16: the reference's ml_dtypes arrays cross exactly, both ways
    ref_bf, params_bf, cfg_bf, model_bf = _pair("bfloat16")
    assert model_bf.embed.dtype == torch.bfloat16
    for name, ref_leaf in (("embed", params_bf["embed"]),
                           ("blocks.1.attn.w_q", params_bf["g0"]["l0"]["attn"]["w_q"]["w"][1])):
        back = model_bf.state_dict()[name].float().numpy().astype(jnp.bfloat16)
        assert back.dtype == np.asarray(ref_leaf).dtype
        np.testing.assert_array_equal(back.view(np.uint16), np.asarray(ref_leaf).view(np.uint16))


@pytest.mark.parametrize("arch", DENSE_ARCHS)
def test_prefill_and_decode_match_reference_float32(arch):
    ref_cfg, params, cfg, model = _pair(arch=arch)
    assert sum(p.numel() for p in model.parameters()) == ref_cfg.param_count()
    tok = _tokens(cfg, PROMPT + GEN)
    want, caches, _ = ref_mdl.prefill(params, ref_cfg, jnp.asarray(tok[:, :PROMPT]), PROMPT + GEN)
    with torch.no_grad():
        got, tc, _ = mdl.prefill(model, torch.from_numpy(tok[:, :PROMPT]), PROMPT + GEN)
    assert got.shape == (B, 1, cfg.vocab_size) and len(tc) == cfg.num_layers
    assert tc[0]["k"].shape == (B, PROMPT + GEN, cfg.num_kv_heads, cfg.head_dim)
    np.testing.assert_allclose(got.numpy(), _np(want), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(tc[3]["v"].numpy(), _np(caches["g0"]["l0"]["v"][3]),
                               rtol=1e-4, atol=1e-4)
    for i in range(GEN):  # teacher forcing: both fed the same tokens
        pos = PROMPT + i
        want, caches = ref_mdl.decode_step(params, ref_cfg, jnp.asarray(tok[:, pos:pos + 1]),
                                           caches, jnp.asarray(pos, jnp.int32))
        with torch.no_grad():
            got, tc = mdl.decode_step(model, torch.from_numpy(tok[:, pos:pos + 1]), tc, pos)
        np.testing.assert_allclose(got.numpy(), _np(want), rtol=1e-4, atol=1e-4)


def test_forward_matches_reference_float32():
    ref_cfg, params, cfg, model = _pair(seed=4)
    tok = _tokens(cfg, PROMPT, seed=5)
    want, _ = ref_mdl.forward(params, ref_cfg, jnp.asarray(tok))
    with torch.no_grad():
        got, aux = mdl.forward(model, torch.from_numpy(tok))
    assert float(aux) == 0.0
    np.testing.assert_allclose(got.numpy(), _np(want), rtol=1e-4, atol=1e-4)


def test_prefill_plus_decode_equals_forward():
    """The port's own invariant (tests/test_model_consistency.py asserts it
    for the reference): teacher-forced prefill + decode×k reproduces
    forward's logits, flash in prefill and forward, einsum in decode."""
    _, _, cfg, model = _pair(seed=2)
    tok = torch.from_numpy(_tokens(cfg, PROMPT + GEN, seed=3))
    with torch.no_grad():
        full, _ = mdl.forward(model, tok)
        last, caches, _ = mdl.prefill(model, tok[:, :PROMPT], PROMPT + GEN)
        got = [last[:, 0]]
        for i in range(GEN - 1):
            logits, caches = mdl.decode_step(model, tok[:, PROMPT + i:PROMPT + i + 1], caches,
                                             PROMPT + i)
            got.append(logits[:, 0])
    torch.testing.assert_close(torch.stack(got, 1), full[:, PROMPT - 1:PROMPT + GEN - 1],
                               rtol=1e-4, atol=1e-4)


def test_prefill_and_decode_match_reference_bfloat16():
    ref_cfg, params, cfg, model = _pair("bfloat16", seed=6)
    tok = _tokens(cfg, PROMPT + 2, seed=7)
    want, caches, _ = ref_mdl.prefill(params, ref_cfg, jnp.asarray(tok[:, :PROMPT]), PROMPT + 2)
    with torch.no_grad():
        got, tc, _ = mdl.prefill(model, torch.from_numpy(tok[:, :PROMPT]), PROMPT + 2)
    assert got.dtype == torch.bfloat16 and tc[0]["k"].dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), _np(want), rtol=5e-2, atol=5e-2)
    want, _ = ref_mdl.decode_step(params, ref_cfg, jnp.asarray(tok[:, PROMPT:PROMPT + 1]), caches,
                                  jnp.asarray(PROMPT, jnp.int32))
    with torch.no_grad():
        got, _ = mdl.decode_step(model, torch.from_numpy(tok[:, PROMPT:PROMPT + 1]), tc, PROMPT)
    np.testing.assert_allclose(got.float().numpy(), _np(want), rtol=5e-2, atol=5e-2)


def test_serve_steps_are_greedy_and_match_decode_step():
    _, _, cfg, model = _pair(seed=8)
    tok = torch.from_numpy(_tokens(cfg, PROMPT, seed=9))
    state = steps.serve_prefill(model, {"tokens": tok}, PROMPT + 3)
    assert state.position == PROMPT and state.last_token.shape == (B, 1)
    assert torch.equal(state.last_token[:, 0], state.logits[:, -1].argmax(-1))
    with torch.no_grad():
        want, _, _ = mdl.prefill(model, tok, PROMPT + 3)
    assert torch.equal(state.logits, want)
    nxt, logits = steps.serve_decode_step(model, state)
    assert nxt.position == PROMPT + 1
    assert torch.equal(nxt.last_token[:, 0], logits[:, -1].argmax(-1))


@pytest.mark.parametrize("arch", [a for a in ARCH_IDS if get_config(a).family == "vlm"])
def test_vlm_config_builds_with_the_references_count(arch):
    """llava-next-mistral-7b, the last family the port refused, builds at full
    width and depth on the meta device (no memory), ``img_proj`` (1,024, d)
    included: 7,245,926,400 parameters, the reference's count; its caches
    build too."""
    cfg = get_config(arch)
    mdl.check_supported(cfg)
    model = mdl.init_params(cfg, device="meta")
    n = sum(p.numel() for p in model.parameters())
    assert n == cfg.param_count() == ref_get_config(arch).param_count() == 7_245_926_400
    assert tuple(model.img_proj.shape) == (1024, cfg.d_model)
    assert len(mdl.init_caches(reduced(cfg), 1, 8, torch.float32, device="cpu")) == 4


def test_moe_config_builds_and_counts_as_the_reference():
    """granite-moe-1b-a400m, the MoE config without MLA, builds at full width
    (on the meta device: no memory) with the reference's parameter count."""
    cfg = get_config("granite-moe-1b-a400m")
    model = mdl.init_params(cfg, device="meta")
    assert all(s == mdl.MOE for s in mdl.layer_specs(cfg))
    assert sum(p.numel() for p in model.parameters()) == cfg.param_count() == \
        ref_get_config("granite_moe_1b").param_count() == 1_334_628_352
    assert tuple(model.blocks[23].moe.experts.w_down.shape) == (32, 512, 1024)
    assert len(mdl.init_caches(reduced(cfg), 1, 8, torch.float32, device="cpu")) == 4


def test_init_params_is_seeded_and_counts():
    cfg = reduced(get_config(ARCH))
    a = mdl.init_params(cfg, generator=torch.Generator().manual_seed(3), device="cpu")
    b = mdl.init_params(cfg, generator=torch.Generator().manual_seed(3), device="cpu")
    assert sum(p.numel() for p in a.parameters()) == cfg.param_count()
    assert all(torch.equal(x, y) for x, y in zip(a.state_dict().values(), b.state_dict().values()))
    assert all(p.requires_grad for p in a.parameters())  # trainable: the training path differentiates them


def test_serve_cli_runs_on_cpu():
    out = serve.main(["--arch", "llama3.2-3b", "--reduced", "--device", "cpu",
                      "--prompt-len", "40", "--gen", "5", "--seed", "1"])
    cfg = reduced(get_config(ARCH))
    assert out["tokens"].shape == (2, 5) and out["tokens"].dtype == torch.int64
    assert bool(((out["tokens"] >= 0) & (out["tokens"] < cfg.vocab_size)).all())
    assert out["logits"].shape == (2, 5, cfg.vocab_size)
    assert torch.equal(out["tokens"], out["logits"].argmax(-1))
    assert out["prefill_s"] > 0 and out["decode_s_per_tok"] > 0
    again = serve.main(["--arch", "llama3_2_3b", "--reduced", "--device", "cpu",
                        "--prompt-len", "40", "--gen", "5", "--seed", "1"])
    assert torch.equal(again["tokens"], out["tokens"])
    assert torch.equal(again["prompt"], out["prompt"])
