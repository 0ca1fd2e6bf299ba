"""The port's encoder–decoder family (Whisper) on the CPU against ``repro``.

Config: ``reduced(get_config("whisper_base"), attn_chunk=8)`` — 2 encoder
layers (non-causal ``attn + mlp``) over 16 frames, 4 decoder layers (causal
``attn + mlp`` with cross-attention onto the encoder's memory), d 128, 4/2
heads of 32, d_ff 256, vocab 512, untied, float32. ``attn_chunk=8`` sends
the encoder's self-attention (16 frames, non-causal) and the decoder's (32
or more tokens, causal) through flash (its plain version here), both ways in
training; cross-attention is the einsum path in both packages. Frames and
tokens are drawn with numpy from a seed and fed to both; the reference's
weights cross through ``repro_torch.interop.from_reference_lm_params``.

Tolerances, as ``tests/test_torch_lm.py`` and ``tests/test_torch_train.py``
hold the same quantities: float32 logits and memory 1e-4; the bf16 memory
(two layers) 5e-2; the bf16 model's logits (six layers: forward, prefill,
decode) within twice the reference's own bf16 error of the float32
reference on the same weights (``chip_smoke.py`` 4d's rule; the port's
logits lie as far from float32 as the reference's, ~0.035, and up to 0.06
from the reference's at a few of 32,768, beyond ``test_torch_lm.py``'s 5e-2
for four layers); the port's decode against its own forward 1e-4 (no SSD,
no routing: four float32 layers); the loss 1e-5 relative, gradients leaf by
leaf within 1e-4 of each leaf's max|g| plus 1e-4 relative; after two
``train_step``s a tenth of the steps' largest move; the pSGLD step with the
reference's noise: losses 1e-5, gradient norms 1e-4, all but
``NOISY_MISSES`` entries of a leaf within 5 % of its move, v 1e-3 relative.
"""

import dataclasses
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
from repro_torch.distributed import epmcmc
from repro_torch.interop import (
    from_reference_epmcmc_state,
    from_reference_lm_params,
    from_reference_lm_tree,
    reference_lm_leaves,
    to_reference_lm_grads,
)
from repro_torch.kernels.flash_attention.ref import _mask
from repro_torch.launch import serve, train
from repro_torch.models.lm import attention as attn
from repro_torch.models.lm import model as mdl
from repro_torch.models.lm import steps
from repro_torch.models.lm.config import reduced
from repro_torch.optim import adamw_init
from test_torch_threads import pin_torch_threads
from test_torch_train import NOISY_MISSES, _leaf_close, _np, _port_batch, _ref_batch

pin_torch_threads()  # this worker's share of the cores under a parallel run

ARCH = "whisper_base"
B, PROMPT, GEN, SEQ = 2, 32, 4, 32


def _cfgs(dtype="float32", **over):
    over = dict(dict(attn_chunk=8), **over)
    ref, port = ref_reduced(ref_get_config(ARCH), **over), reduced(get_config(ARCH), **over)
    if dtype != "float32":
        ref = dataclasses.replace(ref, dtype=dtype, param_dtype=dtype)
        port = dataclasses.replace(port, dtype=dtype, param_dtype=dtype)
    return ref, port


_ref_init_params = jax.jit(ref_mdl.init_params, static_argnums=1)
_ref_forward = jax.jit(ref_mdl.forward, static_argnums=1)
_ref_prefill = jax.jit(ref_mdl.prefill, static_argnums=(1, 3))
_ref_decode_step = jax.jit(ref_mdl.decode_step, static_argnums=1)


@functools.lru_cache(maxsize=None)
def _ref_params(dtype, seed):
    return _np(_ref_init_params(jax.random.PRNGKey(seed), _cfgs(dtype)[0]))


def _model_pair(dtype="float32", seed=0, **over):
    """(ref cfg, ref params (numpy), port cfg, port model with those weights)."""
    ref_cfg, cfg = _cfgs(dtype, **over)
    params = _ref_params(dtype, seed)
    return ref_cfg, params, cfg, from_reference_lm_params(params, cfg, device="cpu")


def _tokens(cfg, n, seed=1, batch=B):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, (batch, n))


def _frames(cfg, seed=2, lead=(), batch=B):
    return np.random.default_rng(seed).standard_normal(
        lead + (batch, cfg.encoder_seq, cfg.d_model)).astype(np.float32)


def _close(got, want, tol=1e-4):
    got = got.detach().float().numpy()
    want = np.asarray(jnp.asarray(want, jnp.float32))
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol)


# ------------------------------------------------------------------ the model


def test_model_builds_and_maps_every_weight_once():
    """The decoder's cross blocks and the encoder, the reference's parameter
    count, and the leaf map: every parameter once, in the port's order, and
    back to the reference's pytree leaf for leaf (the encoder's leaves
    stacked (L_enc, …))."""
    ref_cfg, params, cfg, model = _model_pair()
    assert mdl.layer_specs(cfg) == [mdl.DECODER] * 4
    assert len(model.encoder) == 2 and all(b.spec == mdl.ENCODER for b in model.encoder)
    assert not hasattr(model.encoder[0], "cross") and hasattr(model.blocks[0], "ln_cross")
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
    sd = model.state_dict()
    np.testing.assert_array_equal(sd["encoder.1.attn.w_v"].numpy(),
                                  params["encoder"]["l0"]["attn"]["w_v"]["w"][1])
    np.testing.assert_array_equal(sd["blocks.2.cross.w_k"].numpy(),
                                  params["g0"]["l0"]["cross"]["w_k"]["w"][2])


@pytest.mark.parametrize("arch", ["whisper_base", "whisper-base"])
def test_full_width_config_builds_with_the_references_count(arch):
    """6 + 6 layers, d 512, 8 heads of 64: 109.7 M parameters, on the meta device."""
    cfg = get_config(arch)
    mdl.check_supported(cfg)
    model = mdl.init_params(cfg, device="meta")
    n = sum(p.numel() for p in model.parameters())
    assert n == cfg.param_count() == ref_get_config(ARCH).param_count()
    assert round(n / 1e6, 1) == 109.7


def test_encoder_memory_matches_reference():
    ref_cfg, params, cfg, model = _model_pair()
    fr = _frames(cfg)
    want = ref_mdl._encode(params, ref_cfg, jnp.asarray(fr))
    with torch.no_grad():
        got = mdl._encode(model, torch.from_numpy(fr))
    _close(got, want)
    assert mdl._encode(model, None) is None


def test_forward_prefill_and_decode_match_reference_float32():
    ref_cfg, params, cfg, model = _model_pair()
    tok, fr = _tokens(cfg, PROMPT + GEN, seed=3), _frames(cfg, seed=4)
    want_fwd, _ = _ref_forward(params, ref_cfg, jnp.asarray(tok[:, :PROMPT]),
                               enc_frames=jnp.asarray(fr))
    want, caches, mem = _ref_prefill(params, ref_cfg, jnp.asarray(tok[:, :PROMPT]), PROMPT + GEN,
                                     enc_frames=jnp.asarray(fr))
    with torch.no_grad():
        got_fwd, aux = mdl.forward(model, torch.from_numpy(tok[:, :PROMPT]),
                                   enc_frames=torch.from_numpy(fr))
        got, tc, memory = mdl.prefill(model, torch.from_numpy(tok[:, :PROMPT]), PROMPT + GEN,
                                      enc_frames=torch.from_numpy(fr))
    assert float(aux) == 0.0
    _close(got_fwd, want_fwd)
    _close(got, want)
    _close(memory, mem)
    _close(tc[3]["v"], caches["g0"]["l0"]["v"][3])
    for i in range(GEN):  # teacher forcing: both fed the same tokens
        pos = PROMPT + i
        want, caches = _ref_decode_step(params, ref_cfg, jnp.asarray(tok[:, pos:pos + 1]),
                                        caches, jnp.asarray(pos, jnp.int32), memory=mem)
        with torch.no_grad():
            got, tc = mdl.decode_step(model, torch.from_numpy(tok[:, pos:pos + 1]), tc, pos,
                                      memory=memory)
        _close(got, want)


def test_without_frames_the_decoder_skips_cross_attention_as_the_reference():
    ref_cfg, params, cfg, model = _model_pair()
    tok = _tokens(cfg, PROMPT, seed=5)
    want, _ = _ref_forward(params, ref_cfg, jnp.asarray(tok))
    want_last, _, mem = _ref_prefill(params, ref_cfg, jnp.asarray(tok), PROMPT + 1)
    with torch.no_grad():
        got, _ = mdl.forward(model, torch.from_numpy(tok))
        got_last, _, memory = mdl.prefill(model, torch.from_numpy(tok), PROMPT + 1)
    assert mem is None and memory is None
    _close(got, want)
    _close(got_last, want_last)


def test_forward_prefill_and_decode_match_reference_bfloat16():
    ref_cfg, params, cfg, model = _model_pair("bfloat16", seed=6)
    tok, fr = _tokens(cfg, PROMPT + 1, seed=7), _frames(cfg, seed=8)
    want_fwd, _ = _ref_forward(params, ref_cfg, jnp.asarray(tok[:, :PROMPT]),
                               enc_frames=jnp.asarray(fr))
    want, caches, mem = _ref_prefill(params, ref_cfg, jnp.asarray(tok[:, :PROMPT]), PROMPT + 1,
                                     enc_frames=jnp.asarray(fr))
    want_dec, _ = _ref_decode_step(params, ref_cfg, jnp.asarray(tok[:, PROMPT:]), caches,
                                   jnp.asarray(PROMPT, jnp.int32), memory=mem)
    with torch.no_grad():
        got_fwd, _ = mdl.forward(model, torch.from_numpy(tok[:, :PROMPT]),
                                 enc_frames=torch.from_numpy(fr))
        got, tc, memory = mdl.prefill(model, torch.from_numpy(tok[:, :PROMPT]), PROMPT + 1,
                                      enc_frames=torch.from_numpy(fr))
        got_dec, _ = mdl.decode_step(model, torch.from_numpy(tok[:, PROMPT:]), tc, PROMPT,
                                     memory=memory)
    assert got.dtype == memory.dtype == tc[0]["k"].dtype == torch.bfloat16
    _close(memory, mem, 5e-2)
    ref32, _ = _cfgs()
    p32 = jax.tree.map(lambda a: np.asarray(a, np.float32), params)
    fwd32, _ = _ref_forward(p32, ref32, jnp.asarray(tok[:, :PROMPT]), enc_frames=jnp.asarray(fr))
    last32, caches32, mem32 = _ref_prefill(p32, ref32, jnp.asarray(tok[:, :PROMPT]), PROMPT + 1,
                                           enc_frames=jnp.asarray(fr))
    dec32, _ = _ref_decode_step(p32, ref32, jnp.asarray(tok[:, PROMPT:]), caches32,
                                jnp.asarray(PROMPT, jnp.int32), memory=mem32)
    f32 = functools.partial(np.asarray, dtype=np.float32)
    for g, w16, w32 in ((got_fwd, want_fwd, fwd32), (got, want, last32),
                        (got_dec, want_dec, dec32)):
        err, own = np.abs(g.float().numpy() - f32(w32)).max(), np.abs(f32(w16) - f32(w32)).max()
        assert err <= 2.0 * own, (err, own)


def test_decode_equals_the_forward():
    """The port's own invariant (the reference's
    ``tests/test_model_consistency.py``): teacher-forced prefill + decode
    with the encoder's memory reproduces forward's logits."""
    _, _, cfg, model = _model_pair(seed=9)
    tok = torch.from_numpy(_tokens(cfg, PROMPT + GEN, seed=10))
    fr = torch.from_numpy(_frames(cfg, seed=11))
    with torch.no_grad():
        full, _ = mdl.forward(model, tok, enc_frames=fr)
        last, caches, memory = mdl.prefill(model, tok[:, :PROMPT], PROMPT + GEN, enc_frames=fr)
        got = [last[:, 0]]
        for i in range(GEN - 1):
            logits, caches = mdl.decode_step(model, tok[:, PROMPT + i:PROMPT + i + 1], caches,
                                             PROMPT + i, memory=memory)
            got.append(logits[:, 0])
    torch.testing.assert_close(torch.stack(got, 1), full[:, PROMPT - 1:PROMPT + GEN - 1],
                               rtol=1e-4, atol=1e-4)


def test_serve_steps_carry_the_memory():
    _, _, cfg, model = _model_pair()
    tok, fr = torch.from_numpy(_tokens(cfg, PROMPT, seed=12)), torch.from_numpy(_frames(cfg))
    state = steps.serve_prefill(model, {"tokens": tok, "enc_frames": fr}, PROMPT + 3)
    with torch.no_grad():
        want = mdl._encode(model, fr)
    assert torch.equal(state.memory, want)
    nxt, logits = steps.serve_decode_step(model, state)
    assert nxt.memory is state.memory and nxt.position == PROMPT + 1
    with torch.no_grad():
        direct, _ = mdl.decode_step(model, state.last_token, mdl.prefill(
            model, tok, PROMPT + 3, enc_frames=fr)[1], PROMPT, memory=want)
    assert torch.equal(logits, direct)


def test_every_flash_row_sees_a_kv_position(monkeypatch):
    """Every ``flash_attention`` call of the encoder (non-causal, all frames)
    and the decoder (causal, no query offset), forward and prefill, hands the
    kernel no row with nothing visible (ROADMAP Queue 3's masked-row
    divergence cannot arise on this path); cross-attention never calls it."""
    _, _, cfg, model = _model_pair()
    calls = []
    flash = attn.flash_attention

    def watch(q, k, v, causal=True, *args):
        s, t = q.shape[1], k.shape[1]
        calls.append((s, t, causal))
        assert bool(_mask(s, t, causal, None, q.device).any(dim=1).all()), (s, t, causal)
        return flash(q, k, v, causal, *args)

    monkeypatch.setattr(attn, "flash_attention", watch)
    tok, fr = torch.from_numpy(_tokens(cfg, PROMPT, seed=13)), torch.from_numpy(_frames(cfg))
    total, _ = steps.loss_fn(model, cfg, {"tokens": tok, "enc_frames": fr})
    steps.grads_of(total, dict(model.named_parameters()))
    with torch.no_grad():
        mdl.prefill(model, tok, PROMPT + 1, enc_frames=fr)
    enc, dec = (cfg.encoder_seq, cfg.encoder_seq, False), (PROMPT, PROMPT, True)
    assert sorted(set(calls)) == sorted({enc, dec})
    assert calls.count(enc) == 2 * cfg.num_encoder_layers
    assert calls.count(dec) == 2 * cfg.num_layers


# ------------------------------------------------------------------- training


def _batch(seed, vocab, lead=(), seq=SEQ, batch=B):
    tok = np.random.default_rng(seed).integers(0, vocab, lead + (batch, seq + 1)).astype(np.int32)
    return {"tokens": tok[..., :-1], "labels": tok[..., 1:]}


@pytest.mark.parametrize("remat", ["none", "full", "dots"])
def test_loss_fn_value_and_every_gradient_match_the_reference(remat):
    """With frames: every leaf, the encoder's through each decoder block's
    cross-attention (under remat full the memory's gradient comes back out
    of each recomputed block)."""
    ref_cfg, params, cfg, model = _model_pair(remat=remat)
    b = _batch(14, cfg.vocab_size)
    fr = _frames(cfg, seed=15)
    (want, _), want_g = jax.jit(jax.value_and_grad(
        functools.partial(ref_steps.loss_fn, cfg=ref_cfg), has_aux=True))(
            params, batch=dict(_ref_batch(b), enc_frames=jnp.asarray(fr)))
    total, _ = steps.loss_fn(model, cfg, dict(_port_batch(b), enc_frames=torch.from_numpy(fr)))
    grads = steps.grads_of(total, dict(model.named_parameters()))
    np.testing.assert_allclose(float(total.detach()), float(want), rtol=1e-5)
    flat_want = jax.tree_util.tree_flatten_with_path(_np(want_g))[0]
    flat_got = jax.tree_util.tree_flatten_with_path(to_reference_lm_grads(grads, cfg))[0]
    assert [p for p, _ in flat_got] == [p for p, _ in flat_want]
    for (path, g), (_, w) in zip(flat_got, flat_want):
        _leaf_close(g, w, what=jax.tree_util.keystr(path))
    assert float(grads["encoder.0.attn.w_q"].abs().max()) > 0


@pytest.mark.parametrize("frames", [True, False], ids=["with frames", "tokens alone"])
def test_two_train_steps_match_the_reference(frames):
    """Tokens alone is ``train.py``'s batch: the encoder and every cross
    weight get zero gradients, and AdamW's weight decay still moves them,
    as the reference's ``jax.grad`` zeros do."""
    ref_cfg, params, cfg, model = _model_pair()
    ref_opt = ref_adamw_init(params)
    opt = adamw_init(dict(model.named_parameters()))
    b = _batch(16, cfg.vocab_size)
    rb, pb = _ref_batch(b), _port_batch(b)
    if frames:
        fr = _frames(cfg, seed=17)
        rb, pb = dict(rb, enc_frames=jnp.asarray(fr)), dict(pb, enc_frames=torch.from_numpy(fr))
    start = model.encoder[1].mlp.w_up.detach().clone()
    ref_step = jax.jit(functools.partial(ref_steps.train_step, cfg=ref_cfg))
    for _ in range(2):
        params, ref_opt, want = ref_step(params, ref_opt, rb)
        model, opt, got = steps.train_step(model, opt, pb, cfg)
        np.testing.assert_allclose(float(got["loss"]), float(want["loss"]), rtol=1e-5)
    ref = from_reference_lm_tree(_np(params), cfg)
    for name, p in model.named_parameters():  # a tenth of the two steps' largest move
        np.testing.assert_allclose(p.detach().numpy(), ref[name], rtol=1e-5, atol=0.1 * 2 * 3e-4,
                                   err_msg=name)
    assert not torch.equal(model.encoder[1].mlp.w_up.detach(), start)


EP_OVER = dict(d_model=64, vocab_size=128)
CHAINS = 2
KW = dict(num_shards=CHAINS, shard_tokens=1e4, step_size=1e-4)


def _ref_noise(ref_state):
    """The normal draws the reference's step takes from each chain's key
    (eager: jitted, the unrolled draws take longer to compile than to run)."""
    out = []
    for c in range(CHAINS):
        params_c = jax.tree.map(lambda x: x[c], ref_state.params)
        _, knoise = jax.random.split(ref_state.key[c])
        leaves, treedef = jax.tree.flatten(params_c)
        keys = jax.random.split(knoise, len(leaves))
        out.append(jax.tree.unflatten(treedef, [jax.random.normal(k, leaf.shape, jnp.float32)
                                                for k, leaf in zip(keys, leaves)]))
    return out


def test_epmcmc_step_matches_the_reference():
    """One pSGLD step (T = 1, the reference's noise) of 2 chains on tokens
    alone (``train.py``'s batch): the encoder and cross weights move by the
    noise and the prior alone. Per-chain losses and gradient norms, θ and the
    running mean (burn-in 0) within 5 % of the reference's move but
    ``NOISY_MISSES`` entries a leaf, v within 1e-3."""
    ref_cfg, cfg = _cfgs(**EP_OVER)
    ref_state = jax.jit(ref_epmcmc.init_state, static_argnums=(1, 2))(
        jax.random.PRNGKey(0), ref_cfg, CHAINS)
    state = from_reference_epmcmc_state(_np(ref_state), cfg, device="cpu")
    init = from_reference_lm_tree(_np(ref_state.params), cfg, lead=1)
    tok = np.random.default_rng(18).integers(0, cfg.vocab_size, (CHAINS, 2, 16)).astype(np.int32)
    b = {"tokens": tok, "labels": np.roll(tok, -1, axis=-1)}
    noise = [{n: torch.from_numpy(np.array(a)) for n, a in
              from_reference_lm_tree(_np(tree), cfg).items()} for tree in _ref_noise(ref_state)]
    ref_state, want = jax.jit(functools.partial(ref_epmcmc.epmcmc_step, cfg=ref_cfg, **KW))(
        ref_state, _ref_batch(b))
    state, got = epmcmc.epmcmc_step(state, _port_batch(b), cfg, noise=noise, **KW)
    np.testing.assert_allclose(got["loss_per_chain"].numpy(), np.asarray(want["loss_per_chain"]),
                               rtol=1e-5)
    np.testing.assert_allclose(got["gnorm_per_chain"].numpy(),
                               np.asarray(want["gnorm_per_chain"]), rtol=1e-4)
    final = from_reference_lm_tree(_np(ref_state.params), cfg, lead=1)
    for key in ("params", "m_mean"):
        ref = from_reference_lm_tree(_np(getattr(ref_state, key)), cfg, lead=1)
        for name, t in getattr(state, key).items():
            err = np.abs(t.numpy().astype(np.float64) - ref[name])
            move = float(np.abs(final[name] - init[name]).max())
            assert int((err > 0.05 * move).sum()) <= NOISY_MISSES, (key, name)
    ref_v = from_reference_lm_tree(_np(ref_state.v), cfg, lead=1)
    for name, t in state.v.items():
        _leaf_close(t.numpy(), ref_v[name], rtol=1e-3, what=name)


# ------------------------------------------------------------------- the CLIs


def test_serve_cli_feeds_zero_frames():
    out = serve.main(["--arch", "whisper-base", "--reduced", "--device", "cpu", "--prompt-len",
                      "24", "--gen", "3"])
    assert tuple(out["tokens"].shape) == (2, 3) and bool(torch.isfinite(out["logits"]).all())
    assert tuple(out["enc_frames"].shape) == (2, 16, 128) and not bool(out["enc_frames"].any())


@pytest.mark.parametrize("mode", ["adamw", "epmcmc"])
def test_train_cli_runs_the_reduced_encoder_decoder(mode):
    out = train.main(["--device", "cpu", "--arch", "whisper-base", "--reduced", "--mode", mode,
                      "--steps", "2", "--batch", "2", "--seq", "32", "--chains", "2",
                      "--log-every", "2"])
    assert np.isfinite(out["loss"]) and len(out["losses"]) == 2
