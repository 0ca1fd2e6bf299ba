"""The port's vlm family (LLaVA's image prefix) on the CPU against ``repro``.

Config: ``reduced(get_config("llava_next_mistral_7b"), attn_chunk=8)`` — 4
dense layers (Mistral's ``attn + mlp``), d 128, 4/2 heads of 32, d_ff 256,
vocab 512, untied, float32, 8 image tokens: ``img_embeds`` (B, 8, 1,024)
through ``img_proj`` (1,024, 128) and put before the token embeddings,
positions ``arange`` over prefix and text. ``attn_chunk=8`` sends every
attention of 8 + 32 positions through flash (its plain version here), both
ways in training. Image embeddings and tokens are drawn with numpy from a
seed and fed to both packages; the reference's weights cross through
``repro_torch.interop.from_reference_lm_params``.

Tolerances, as ``tests/test_torch_encdec.py`` holds the same quantities:
float32 logits 1e-4 (four layers of matrix products summed in other orders
than XLA's); the port's decode against its own forward 1e-4; the loss 1e-5
relative, gradients leaf by leaf within 1e-4 of each leaf's max|g| plus
1e-4 relative; after two ``train_step``s every parameter within a tenth of
the steps' largest move (2 × 3e-4) plus 1e-5 relative; a pSGLD state's
leaves equal bit for bit (a copy).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.distributed import epmcmc as ref_epmcmc
from repro.models.lm import model as ref_mdl
from repro.models.lm import steps as ref_steps
from repro.models.lm.config import reduced as ref_reduced
from repro.optim.adamw import adamw_init as ref_adamw_init
from repro_torch.configs import get_config
from repro_torch.interop import (
    from_reference_epmcmc_state,
    from_reference_lm_params,
    from_reference_lm_tree,
    reference_lm_leaves,
    to_reference_lm_grads,
)
from repro_torch.kernels.flash_attention.ref import _mask
from repro_torch.launch import serve
from repro_torch.models.lm import attention as attn
from repro_torch.models.lm import model as mdl
from repro_torch.models.lm import steps
from repro_torch.models.lm.config import VISION_WIDTH, reduced
from repro_torch.optim import adamw_init
from test_torch_threads import pin_torch_threads
from test_torch_train import _leaf_close, _np, _port_batch, _ref_batch

pin_torch_threads()  # this worker's share of the cores under a parallel run

ARCH = "llava_next_mistral_7b"
B, PROMPT, GEN, SEQ = 2, 32, 4, 32
N_IMG = 8  # reduced()'s min(576, 8)


def _cfgs(**over):
    over = dict(dict(attn_chunk=8), **over)
    return ref_reduced(ref_get_config(ARCH), **over), reduced(get_config(ARCH), **over)


_ref_init_params = jax.jit(ref_mdl.init_params, static_argnums=1)
_ref_forward = jax.jit(ref_mdl.forward, static_argnums=1)
_ref_prefill = jax.jit(ref_mdl.prefill, static_argnums=(1, 3))
_ref_decode_step = jax.jit(ref_mdl.decode_step, static_argnums=1)


@functools.lru_cache(maxsize=None)
def _ref_params(seed):
    return _np(_ref_init_params(jax.random.PRNGKey(seed), _cfgs()[0]))


def _model_pair(seed=0, **over):
    """(ref cfg, ref params (numpy), port cfg, port model with those weights)."""
    ref_cfg, cfg = _cfgs(**over)
    params = _ref_params(seed)
    return ref_cfg, params, cfg, from_reference_lm_params(params, cfg, device="cpu")


def _tokens(cfg, n, seed=1, batch=B):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, (batch, n))


def _images(seed=2, batch=B):
    return np.random.default_rng(seed).standard_normal(
        (batch, N_IMG, VISION_WIDTH)).astype(np.float32)


def _close(got, want, tol=1e-4):
    got = got.detach().float().numpy()
    want = np.asarray(jnp.asarray(want, jnp.float32))
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol)


# ------------------------------------------------------------------ the model


def test_model_builds_and_maps_every_weight_once():
    """``img_proj`` (1,024, d) beside the dense blocks, the reference's
    parameter count, and the leaf map: every parameter once, in the port's
    order, and back to the reference's pytree leaf for leaf."""
    ref_cfg, params, cfg, model = _model_pair()
    assert cfg.num_image_tokens == N_IMG and mdl.layer_specs(cfg) == [mdl.DENSE] * 4
    assert tuple(model.img_proj.shape) == (VISION_WIDTH, cfg.d_model)
    assert sum(p.numel() for p in model.parameters()) == cfg.param_count() == ref_cfg.param_count()
    leaves = reference_lm_leaves(cfg)
    assert [n for n, _, _ in leaves] == [n for n, _ in model.named_parameters()]
    assert len({(p, i) for _, p, i in leaves}) == len(leaves)
    back = to_reference_lm_grads({n: torch.from_numpy(np.array(a))
                                  for n, a in from_reference_lm_tree(params, cfg).items()}, cfg)
    flat_back = jax.tree_util.tree_flatten_with_path(back)[0]
    flat_ref = jax.tree_util.tree_flatten_with_path(params)[0]
    assert [p for p, _ in flat_back] == [p for p, _ in flat_ref]
    for (_, a), (_, w) in zip(flat_back, flat_ref):
        np.testing.assert_array_equal(a, w)
    np.testing.assert_array_equal(model.img_proj.detach().numpy(), params["img_proj"])


def test_img_proj_is_drawn_as_the_reference_draws_it():
    """N(0, 1)·1024^-½ in float32, cast to ``param_dtype``: the port's draw
    has the reference's scale (another generator, so other numbers)."""
    _, cfg = _cfgs()
    model = mdl.init_params(cfg, generator=torch.Generator().manual_seed(0), device="cpu")
    assert model.img_proj.dtype == torch.float32  # the reduced config's param_dtype
    w = model.img_proj.detach().double()
    assert abs(float(w.mean())) < 1e-3
    np.testing.assert_allclose(float(w.std()), VISION_WIDTH ** -0.5, rtol=2e-2)
    np.testing.assert_allclose(np.asarray(_ref_params(0)["img_proj"]).std(), VISION_WIDTH ** -0.5,
                               rtol=2e-2)


def test_forward_with_images_matches_reference():
    ref_cfg, params, cfg, model = _model_pair()
    tok, img = _tokens(cfg, PROMPT, seed=3), _images(seed=4)
    want, _ = _ref_forward(params, ref_cfg, jnp.asarray(tok), img_embeds=jnp.asarray(img))
    with torch.no_grad():
        got, aux = mdl.forward(model, torch.from_numpy(tok), img_embeds=torch.from_numpy(img))
        h, positions, n_prefix = mdl._inputs_to_h(model, torch.from_numpy(tok),
                                                  torch.from_numpy(img))
    assert float(aux) == 0.0 and got.shape == (B, N_IMG + PROMPT, cfg.vocab_size)
    assert n_prefix == N_IMG and torch.equal(positions[0], torch.arange(N_IMG + PROMPT))
    want_h, want_pos, want_n = ref_mdl._inputs_to_h(params, ref_cfg, jnp.asarray(tok),
                                                    jnp.asarray(img))
    assert want_n == n_prefix
    np.testing.assert_array_equal(positions.numpy(), np.asarray(want_pos))
    _close(h, want_h, 1e-5)
    _close(got, want)


def test_without_images_the_model_is_the_text_model_as_the_reference():
    ref_cfg, params, cfg, model = _model_pair()
    tok = _tokens(cfg, PROMPT, seed=5)
    want, _ = _ref_forward(params, ref_cfg, jnp.asarray(tok))
    with torch.no_grad():
        got, _ = mdl.forward(model, torch.from_numpy(tok))
    assert got.shape == (B, PROMPT, cfg.vocab_size)
    _close(got, want)


def test_prefill_and_decode_match_reference():
    """Prefill over prefix + prompt into caches of 8 + 32 + 4 positions, then
    three teacher-forced ``decode_step``s at positions 8 + 32, 8 + 33, …: the
    logits and a layer's cache, as the reference's."""
    ref_cfg, params, cfg, model = _model_pair()
    tok, img = _tokens(cfg, PROMPT + GEN, seed=6), _images(seed=7)
    max_len = N_IMG + PROMPT + GEN
    want, caches, _ = _ref_prefill(params, ref_cfg, jnp.asarray(tok[:, :PROMPT]), max_len,
                                   img_embeds=jnp.asarray(img))
    with torch.no_grad():
        got, tc, memory = mdl.prefill(model, torch.from_numpy(tok[:, :PROMPT]), max_len,
                                      img_embeds=torch.from_numpy(img))
    assert memory is None and tc[0]["k"].shape[1] == max_len
    _close(got, want)
    _close(tc[2]["k"], caches["g0"]["l0"]["k"][2])
    for i in range(GEN - 1):
        pos = N_IMG + PROMPT + i
        t = tok[:, PROMPT + i:PROMPT + i + 1]
        want, caches = _ref_decode_step(params, ref_cfg, jnp.asarray(t), caches,
                                        jnp.asarray(pos, jnp.int32))
        with torch.no_grad():
            got, tc = mdl.decode_step(model, torch.from_numpy(t), tc, pos)
        _close(got, want)
    _close(tc[3]["v"], caches["g0"]["l0"]["v"][3])


def test_decode_equals_the_forward():
    """The port's own invariant with the prefix: teacher-forced prefill +
    decode reproduces forward's logits at the text's positions."""
    _, _, cfg, model = _model_pair(seed=1)
    tok = torch.from_numpy(_tokens(cfg, PROMPT + GEN, seed=8))
    img = torch.from_numpy(_images(seed=9))
    with torch.no_grad():
        full, _ = mdl.forward(model, tok, img_embeds=img)
        last, caches, _ = mdl.prefill(model, tok[:, :PROMPT], N_IMG + PROMPT + GEN,
                                      img_embeds=img)
        got = [last[:, 0]]
        for i in range(GEN - 1):
            logits, caches = mdl.decode_step(model, tok[:, PROMPT + i:PROMPT + i + 1], caches,
                                             N_IMG + PROMPT + i)
            got.append(logits[:, 0])
    torch.testing.assert_close(torch.stack(got, 1),
                               full[:, N_IMG + PROMPT - 1:N_IMG + PROMPT + GEN - 1],
                               rtol=1e-4, atol=1e-4)


def test_serve_steps_count_the_prefix_in_the_position():
    """``serve_prefill``'s position is S + ``num_image_tokens`` with images
    (the reference's ``serve_prefill``), S without; the next decode writes
    there."""
    ref_cfg, params, cfg, model = _model_pair()
    tok, img = _tokens(cfg, PROMPT, seed=10), _images(seed=11)
    max_len = N_IMG + PROMPT + 3
    state = steps.serve_prefill(model, {"tokens": torch.from_numpy(tok),
                                        "img_embeds": torch.from_numpy(img)}, max_len)
    ref_state = jax.jit(functools.partial(ref_steps.serve_prefill, cfg=ref_cfg,
                                          max_len=max_len))(
        params, batch={"tokens": jnp.asarray(tok), "img_embeds": jnp.asarray(img)})
    assert state.position == int(ref_state.position) == N_IMG + PROMPT
    assert torch.equal(state.last_token, torch.from_numpy(np.array(ref_state.last_token)).long())
    nxt, logits = steps.serve_decode_step(model, state)
    _, want = ref_steps.serve_decode_step(params, ref_cfg, ref_state)
    assert nxt.position == N_IMG + PROMPT + 1
    _close(logits, want)
    text = steps.serve_prefill(model, {"tokens": torch.from_numpy(tok)}, max_len)
    assert text.position == PROMPT


def test_every_flash_row_sees_a_kv_position(monkeypatch):
    """Every ``flash_attention`` call of the vlm's training step (with
    images: forward and its gradients) and its prefill is causal over prefix
    + text with no query offset and no padding, so it hands the kernel no row
    with nothing visible (ROADMAP Queue 3's masked-row divergence cannot
    arise on this path)."""
    _, _, cfg, model = _model_pair()
    calls = []
    flash = attn.flash_attention

    def watch(q, k, v, causal=True, *args):
        s, t = q.shape[1], k.shape[1]
        calls.append((s, t, causal))
        assert bool(_mask(s, t, causal, None, q.device).any(dim=1).all()), (s, t, causal)
        return flash(q, k, v, causal, *args)

    monkeypatch.setattr(attn, "flash_attention", watch)
    tok, img = torch.from_numpy(_tokens(cfg, PROMPT, seed=12)), torch.from_numpy(_images())
    total, _ = steps.loss_fn(model, cfg, {"tokens": tok, "img_embeds": img})
    steps.grads_of(total, dict(model.named_parameters()))
    with torch.no_grad():
        mdl.prefill(model, tok, N_IMG + PROMPT + 1, img_embeds=img)
    assert calls == [(N_IMG + PROMPT, N_IMG + PROMPT, True)] * (2 * cfg.num_layers)


# ------------------------------------------------------------------- training


def _batch(seed, vocab, seq=SEQ, batch=B):
    tok = np.random.default_rng(seed).integers(0, vocab, (batch, seq + 1)).astype(np.int32)
    return {"tokens": tok[:, :-1], "labels": tok[:, 1:]}


def _with_images(b, img):
    return dict(_ref_batch(b), img_embeds=jnp.asarray(img)), dict(
        _port_batch(b), img_embeds=torch.from_numpy(img))


@pytest.mark.parametrize("remat", ["none", "full"])
def test_loss_fn_value_and_every_gradient_match_the_reference(remat):
    """With images: the prefix's logits sliced off before the loss, every
    leaf's gradient, ``img_proj``'s through the prefix (nonzero)."""
    ref_cfg, params, cfg, model = _model_pair(remat=remat)
    rb, pb = _with_images(_batch(13, cfg.vocab_size), _images(seed=14))
    (want, want_m), want_g = jax.jit(jax.value_and_grad(
        functools.partial(ref_steps.loss_fn, cfg=ref_cfg), has_aux=True))(params, batch=rb)
    total, metrics = steps.loss_fn(model, cfg, pb)
    grads = steps.grads_of(total, dict(model.named_parameters()))
    np.testing.assert_allclose(float(total.detach()), float(want), rtol=1e-5)
    np.testing.assert_allclose(float(metrics["ce"].detach()), float(want_m["ce"]), rtol=1e-5)
    flat_want = jax.tree_util.tree_flatten_with_path(_np(want_g))[0]
    flat_got = jax.tree_util.tree_flatten_with_path(to_reference_lm_grads(grads, cfg))[0]
    assert [p for p, _ in flat_got] == [p for p, _ in flat_want]
    for (path, g), (_, w) in zip(flat_got, flat_want):
        _leaf_close(g, w, what=jax.tree_util.keystr(path))
    assert float(grads["img_proj"].abs().max()) > 0


def test_img_proj_gets_a_zero_gradient_without_images():
    """A batch without ``img_embeds`` (``train.py``'s): ``img_proj`` gets a
    gradient of zeros, not None, as ``jax.grad`` gives it; every other leaf
    as the reference's."""
    ref_cfg, params, cfg, model = _model_pair()
    b = _batch(15, cfg.vocab_size)
    (want, _), want_g = jax.jit(jax.value_and_grad(
        functools.partial(ref_steps.loss_fn, cfg=ref_cfg), has_aux=True))(
            params, batch=_ref_batch(b))
    total, _ = steps.loss_fn(model, cfg, _port_batch(b))
    grads = steps.grads_of(total, dict(model.named_parameters()))
    np.testing.assert_allclose(float(total.detach()), float(want), rtol=1e-5)
    assert grads["img_proj"] is not None and grads["img_proj"].shape == model.img_proj.shape
    assert not bool(grads["img_proj"].any()) and not np.asarray(want_g["img_proj"]).any()
    ref = from_reference_lm_tree(_np(want_g), cfg)
    for name, g in grads.items():
        _leaf_close(g.numpy(), ref[name], what=name)


@pytest.mark.parametrize("images", [True, False], ids=["with images", "tokens alone"])
def test_two_train_steps_match_the_reference(images):
    """Two AdamW ``train_step``s, leaf by leaf, ``img_proj`` included: moved
    by its gradient with images, by weight decay alone on tokens."""
    ref_cfg, params, cfg, model = _model_pair()
    ref_opt = ref_adamw_init(params)
    opt = adamw_init(dict(model.named_parameters()))
    b = _batch(16, cfg.vocab_size)
    rb, pb = _ref_batch(b), _port_batch(b)
    if images:
        rb, pb = _with_images(b, _images(seed=17))
    start = model.img_proj.detach().clone()
    ref_step = jax.jit(functools.partial(ref_steps.train_step, cfg=ref_cfg))
    for _ in range(2):
        params, ref_opt, want = ref_step(params, ref_opt, rb)
        model, opt, got = steps.train_step(model, opt, pb, cfg)
        np.testing.assert_allclose(float(got["loss"]), float(want["loss"]), rtol=1e-5)
    ref = from_reference_lm_tree(_np(params), cfg)
    for name, p in model.named_parameters():  # a tenth of the two steps' largest move
        np.testing.assert_allclose(p.detach().numpy(), ref[name], rtol=1e-5, atol=0.1 * 2 * 3e-4,
                                   err_msg=name)
    moved = float((model.img_proj.detach() - start).abs().max())
    assert moved > (1e-4 if images else 0.0), moved
    assert (float(opt.mu["img_proj"].abs().max()) > 0) == images


def test_epmcmc_state_carries_img_proj():
    """The reference's stacked EP-MCMC state crosses with each chain's
    ``img_proj`` (and its pSGLD accumulators) as its own leaf."""
    ref_cfg, cfg = _cfgs(d_model=64, vocab_size=128)
    ref_state = jax.jit(ref_epmcmc.init_state, static_argnums=(1, 2))(
        jax.random.PRNGKey(0), ref_cfg, 2)
    state = from_reference_epmcmc_state(_np(ref_state), cfg, device="cpu")
    want = np.asarray(ref_state.params["img_proj"])
    assert state.params["img_proj"].shape == (2, VISION_WIDTH, 64)
    np.testing.assert_array_equal(state.params["img_proj"].numpy(), want)
    assert state.v["img_proj"].shape == (2, VISION_WIDTH, 64)


# ------------------------------------------------------------------- the CLIs


def test_serve_generate_sizes_the_caches_for_the_prefix():
    """``generate``'s caches hold prefix + prompt + gen (the reference's
    ``max_len``), its prefill runs 8 + 24 positions, and it feeds zero image
    embeddings unless given some, as the reference's CLI."""
    _, _, cfg, model = _model_pair()
    prompt = torch.from_numpy(_tokens(cfg, 24, seed=18))
    out = serve.generate(model, prompt, 3)
    assert out["max_len"] == serve.cache_len(cfg, 24, 3) == 24 + 3 + N_IMG
    assert tuple(out["img_embeds"].shape) == (B, N_IMG, VISION_WIDTH)
    assert not bool(out["img_embeds"].any())
    img = torch.from_numpy(_images(seed=19))
    out = serve.generate(model, prompt, 3, img_embeds=img)
    assert out["img_embeds"] is img and tuple(out["tokens"].shape) == (B, 3)
    with torch.no_grad():
        full, _ = mdl.forward(model, torch.cat([prompt, out["tokens"][:, :-1]], 1),
                              img_embeds=img)
    torch.testing.assert_close(out["logits"], full[:, N_IMG + 23:], rtol=1e-4, atol=1e-4)
    cli = serve.main(["--arch", "llava-next-mistral-7b", "--reduced", "--device", "cpu",
                      "--prompt-len", "24", "--gen", "3"])
    assert cli["max_len"] == 35 and bool(torch.isfinite(cli["logits"]).all())
