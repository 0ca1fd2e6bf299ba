"""The port's Mamba-2 (the ssm family, mamba2-130m) on the CPU against ``repro``.

Config: ``reduced(get_config("mamba2_130m"))`` — 4 layers, d 128, d_inner
256, 8 SSM heads of 32, d_state 16, chunk 16, d_conv 4, tied vocab 512,
float32 — and, for the pSGLD step, ``tests/test_epmcmc.py``'s (2 layers, d
64, vocab 128). The reference's weights (``init_mamba2``, ``init_params``)
cross by name or through ``repro_torch.interop.from_reference_lm_params``;
inputs are drawn with numpy from a seed and fed to both.

Tolerances: float32 layers and logits 1e-4 (matrix products of ≤ 256 terms
and the chunk recurrence, summed in other orders than XLA's); bf16 5e-2
(``test_torch_lm.py``'s figure); the port's decode against its own forward
2e-3 (the reference's ``tests/test_model_consistency.py`` bound); gradients
leaf by leaf as ``test_torch_train.py`` holds the other families (1e-4 of
each leaf's max|g| plus 1e-4 relative), ``train_step`` and the pSGLD step as
there (a tenth of the steps' largest move; with the reference's noise, all
but ``NOISY_MISSES`` entries of a leaf within 5 % of its move); AdamW on
given gradients, per leaf in its own dtype, 1e-6 (bf16 leaves: one bf16
ulp of the result, or 1e-4 near zero).
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro.configs import get_config as ref_get_config
from repro.distributed import epmcmc as ref_epmcmc
from repro.models.lm import mamba2 as ref_m2
from repro.models.lm import model as ref_mdl
from repro.models.lm import steps as ref_steps
from repro.models.lm.config import reduced as ref_reduced
from repro.optim.adamw import adamw_init as ref_adamw_init
from repro.optim.adamw import adamw_update as ref_adamw_update
from repro_torch.configs import get_config
from repro_torch.distributed import epmcmc
from repro_torch.interop import (
    MAMBA_LEAVES,
    from_reference_epmcmc_state,
    from_reference_lm_params,
    from_reference_lm_tree,
    reference_lm_leaves,
    to_reference_lm_grads,
)
from repro_torch.launch import lm_bayes_sgld, serve, train
from repro_torch.models.lm import mamba2 as m2
from repro_torch.models.lm import model as mdl
from repro_torch.models.lm import steps
from repro_torch.models.lm.config import reduced
from repro_torch.optim import adamw_init, adamw_update
from test_torch_threads import pin_torch_threads
from test_torch_train import NOISY_MISSES, _leaf_close, _np, _port_batch, _ref_batch

pin_torch_threads()  # this worker's share of the cores under a parallel run

ARCH = "mamba2_130m"
FLOAT32_LEAVES = ("A_log", "dt_bias", "D")  # float32 whatever cfg.param_dtype is
B, PROMPT, GEN = 2, 48, 4


def _cfgs(dtype="float32", **over):
    ref, port = ref_reduced(ref_get_config(ARCH), **over), reduced(get_config(ARCH), **over)
    if dtype != "float32":
        ref = dataclasses.replace(ref, dtype=dtype, param_dtype=dtype)
        port = dataclasses.replace(port, dtype=dtype, param_dtype=dtype)
    return ref, port


def _head_block(cfg, hb):
    return dataclasses.replace(cfg, ssm=dataclasses.replace(cfg.ssm, head_block=hb))


# the reference's functions jitted: eager JAX compiles every operation at
# every new shape, several times slower on these small models
_ref_init_mamba2 = jax.jit(ref_m2.init_mamba2, static_argnums=1)
_ref_init_params = jax.jit(ref_mdl.init_params, static_argnums=1)
_ref_init_state = jax.jit(ref_epmcmc.init_state, static_argnums=(1, 2))
_ref_mamba2_forward = jax.jit(ref_m2.mamba2_forward, static_argnums=1)
_ref_forward = jax.jit(ref_mdl.forward, static_argnums=1)
_ref_prefill = jax.jit(ref_mdl.prefill, static_argnums=(1, 3))
_ref_decode_step = jax.jit(ref_mdl.decode_step, static_argnums=1)


@functools.lru_cache(maxsize=None)
def _ref_layer(dtype, seed):
    return _ref_init_mamba2(jax.random.PRNGKey(seed), _cfgs(dtype)[0])


@functools.lru_cache(maxsize=None)
def _ref_params(dtype, seed, over=()):
    """The reference's ``init_params`` (numpy leaves), drawn once a module."""
    return _np(_ref_init_params(jax.random.PRNGKey(seed), _cfgs(dtype, **dict(over))[0]))


def _layer_pair(dtype="float32", seed=0, head_block=0):
    """One Mamba-2 layer: (ref cfg, ``init_mamba2`` params, port ``Mamba2``)."""
    ref_cfg, cfg = (_head_block(c, head_block) for c in _cfgs(dtype))
    p = _ref_layer(dtype, seed)
    layer = m2.Mamba2(cfg, device="cpu")
    with torch.no_grad():
        for name, t in layer.named_parameters():
            t.copy_(torch.tensor(np.asarray(p[name], np.float32)))
    return ref_cfg, p, layer


def _model_pair(dtype="float32", seed=0, **over):
    """(ref cfg, ref params (numpy), port cfg, port model with those weights);
    ``over`` (remat) leaves the parameters' shapes alone."""
    ref_cfg, cfg = _cfgs(dtype, **over)
    params = _ref_params(dtype, seed)
    model = from_reference_lm_params(params, cfg, device="cpu")
    return ref_cfg, params, cfg, model


def _x(seed, shape, scale=1.0):
    return (scale * np.random.default_rng(seed).standard_normal(shape)).astype(np.float32)


def _tokens(cfg, n, seed=1, batch=B):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, (batch, n))


def _f32(x):
    return np.asarray(jnp.asarray(x, jnp.float32))


def _close(got, want, tol=1e-4):
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) else np.asarray(got, np.float32)
    assert got.shape == _f32(want).shape
    np.testing.assert_allclose(got, _f32(want), rtol=tol, atol=tol)


# ------------------------------------------------------------------ the layer


def test_softplus_matches_jax_in_float32():
    """F.softplus thresholds at 20 (returns x above it); jax.nn.softplus is
    logaddexp(x, 0). Equal to float32 rounding over the range dt sees."""
    x = np.concatenate([np.linspace(-60, 60, 4001), [19.99, 20.0, 20.01, 88.0, -88.0]])
    x = x.astype(np.float32)
    got = F.softplus(torch.from_numpy(x)).numpy()
    want = np.asarray(jax.nn.softplus(jnp.asarray(x)))
    np.testing.assert_allclose(got, want, rtol=2e-7, atol=1e-30)


def test_layer_parameters_are_init_mamba2s():
    """The names, shapes and dtypes of ``init_mamba2``'s leaves at bf16:
    ``A_log``, ``dt_bias`` and ``D`` float32, the rest bf16; a drawn layer's
    deterministic leaves equal the reference's (``A_log`` to one float32
    rounding)."""
    ref_cfg, cfg = _cfgs("bfloat16")
    want = _ref_init_mamba2(jax.random.PRNGKey(0), ref_cfg)
    layer = m2.Mamba2(cfg, generator=torch.Generator().manual_seed(0), device="cpu")
    got = dict(layer.named_parameters())
    assert tuple(got) == MAMBA_LEAVES and set(want) == set(MAMBA_LEAVES)
    for name, t in got.items():
        assert tuple(t.shape) == want[name].shape, name
        f32 = name in FLOAT32_LEAVES
        assert t.dtype == (torch.float32 if f32 else torch.bfloat16), name
        assert str(want[name].dtype) == ("float32" if f32 else "bfloat16"), name
    for name in ("D", "norm", "conv_bias_x"):
        np.testing.assert_array_equal(got[name].detach().float().numpy(), _f32(want[name]))
    # XLA's linspace and log round some of the 8 points to a neighbouring float32
    np.testing.assert_allclose(got["A_log"].detach().numpy(), _f32(want["A_log"]), rtol=5e-7)
    # dt_bias: softplus of it lies in [dt_min, dt_max]
    dt = F.softplus(got["dt_bias"].detach())
    assert bool(((dt >= cfg.ssm.dt_min * 0.999) & (dt <= cfg.ssm.dt_max * 1.001)).all())
    # the projections' scale: N(0, 1)·d^-½
    assert abs(float(got["w_z"].detach().float().std()) * cfg.d_model ** 0.5 - 1.0) < 0.05


@pytest.mark.parametrize("dtype,tol", [("float32", 1e-5), ("bfloat16", 5e-2)])
def test_causal_conv_matches_reference(dtype, tol):
    u = _x(3, (B, 40, 24))
    w, b = _x(4, (4, 24), 0.5), _x(5, (24,), 0.1)
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    want = ref_m2._causal_conv(jnp.asarray(w, jd), jnp.asarray(b, jd), jnp.asarray(u, jd))
    got = m2._causal_conv(torch.from_numpy(w).to(td), torch.from_numpy(b).to(td),
                          torch.from_numpy(u).to(td))
    assert got.dtype == td
    _close(got, want, tol)


@pytest.mark.parametrize("conv", [True, False], ids=["conv", "no conv"])
def test_project_matches_reference(conv):
    ref_cfg, p, layer = _layer_pair()
    x = _x(6, (B, 32, ref_cfg.d_model))
    want = ref_m2._project(p, ref_cfg, jnp.asarray(x), conv=conv)
    with torch.no_grad():
        got = m2._project(layer, torch.from_numpy(x), conv=conv)
    assert got[-1].dtype == torch.float32  # dt: a float32 softplus
    for g, w in zip(got, want):
        _close(g, w)


def test_ssd_core_matches_reference():
    """Inputs at ``_ssd_core``'s own shapes: 3 chunks of 16, 8 heads of 32,
    d_state 16; the log decays ≤ 0 and cumulative within each chunk."""
    b, L, q, h, hd, n = B, 3, 16, 8, 32, 16
    xh, bh, ch = _x(7, (b, L, q, h, hd)), _x(8, (b, L, q, n)), _x(9, (b, L, q, n))
    dtc = np.abs(_x(10, (b, L, q, h), 0.1)).astype(np.float32)
    cum = np.cumsum(-dtc * np.linspace(1, 16, h, dtype=np.float32), axis=2).astype(np.float32)
    want = ref_m2._ssd_core(*(jnp.asarray(a) for a in (xh, bh, ch, dtc, cum)), jnp.float32)
    got = m2._ssd_core(*(torch.from_numpy(a) for a in (xh, bh, ch, dtc, cum)), torch.float32)
    _close(got, want)


@pytest.mark.parametrize("head_block", [0, 2], ids=["whole", "head blocks of 2"])
@pytest.mark.parametrize("seq", [48, 10], ids=["3 chunks", "under one chunk"])
def test_mamba2_forward_matches_reference(head_block, seq):
    ref_cfg, p, layer = _layer_pair(head_block=head_block)
    x = _x(11, (B, seq, ref_cfg.d_model))
    want = _ref_mamba2_forward(p, ref_cfg, jnp.asarray(x))
    with torch.no_grad():
        got = layer(torch.from_numpy(x))
    _close(got, want)


def test_mamba2_forward_refuses_a_ragged_sequence():
    _, _, layer = _layer_pair()
    with pytest.raises(ValueError, match="SSD chunks of 16"):
        layer(torch.zeros((1, 40, layer.cfg.d_model)))


def test_mamba2_forward_matches_reference_bfloat16():
    ref_cfg, p, layer = _layer_pair("bfloat16")
    x = _x(12, (B, 32, ref_cfg.d_model))
    want = _ref_mamba2_forward(p, ref_cfg, jnp.asarray(x, jnp.bfloat16))
    with torch.no_grad():
        got = layer(torch.from_numpy(x).to(torch.bfloat16))
    assert got.dtype == torch.bfloat16
    _close(got, want, 5e-2)


def test_ssm_state_after_and_decode_match_reference():
    """The prefill's cache (conv windows and h) from the same input, then
    four decode steps from it, each step's output and cache."""
    ref_cfg, p, layer = _layer_pair()
    x = _x(13, (B, 32, ref_cfg.d_model))
    want = ref_m2.ssm_state_after(p, ref_cfg, jnp.asarray(x))
    with torch.no_grad():
        got = m2.ssm_state_after(layer, torch.from_numpy(x))
    assert isinstance(got, m2.SSMCache) and got.h.dtype == torch.float32
    for key in ("x", "B", "C"):
        _close(getattr(got, key), want["conv"][key])
    _close(got.h, want["h"])
    cache = want
    for i in range(4):
        step = _x(20 + i, (B, 1, ref_cfg.d_model))
        w_out, cache = ref_m2.mamba2_decode(p, ref_cfg, jnp.asarray(step), cache)
        with torch.no_grad():
            g_out, got = m2.mamba2_decode(layer, torch.from_numpy(step), got)
        _close(g_out, w_out)
        _close(got.h, cache["h"])
        _close(got.x, cache["conv"]["x"])


def test_decode_from_zero_cache_matches_reference():
    ref_cfg, p, layer = _layer_pair()
    _, cfg = _cfgs()
    cache = ref_m2.init_mamba2_cache(ref_cfg, B, jnp.float32)
    got = m2.init_mamba2_cache(cfg, B, torch.float32)
    assert got.nbytes() == sum(np.asarray(a).nbytes for a in jax.tree.leaves(cache))
    step = _x(30, (B, 1, ref_cfg.d_model))
    want, _ = ref_m2.mamba2_decode(p, ref_cfg, jnp.asarray(step), cache)
    with torch.no_grad():
        out, _ = m2.mamba2_decode(layer, torch.from_numpy(step), got)
    _close(out, want)


# ------------------------------------------------------------------ the model


def test_model_builds_and_maps_every_weight():
    ref_cfg, params, cfg, model = _model_pair()
    assert sum(p.numel() for p in model.parameters()) == cfg.param_count() == ref_cfg.param_count()
    assert mdl.layer_specs(cfg) == [mdl.MAMBA] * 4
    assert not hasattr(model.blocks[0], "ln2") and not hasattr(model.blocks[0], "mlp")
    assert model.lm_head is None  # tied
    sd = model.state_dict()
    np.testing.assert_array_equal(sd["blocks.2.mamba.w_x"].numpy(),
                                  np.asarray(params["g0"]["l0"]["mamba"]["w_x"][2]))
    np.testing.assert_array_equal(sd["blocks.3.mamba.dt_bias"].numpy(),
                                  np.asarray(params["g0"]["l0"]["mamba"]["dt_bias"][3]))


@pytest.mark.parametrize("arch", ["mamba2_130m", "mamba2-130m"])
def test_full_width_config_builds_with_the_references_count(arch):
    """24 layers, d 768, 24 heads of 64, d_state 128: 129.0 M parameters,
    on the meta device (no memory), bf16 but the float32 three."""
    cfg = get_config(arch)
    model = mdl.init_params(cfg, device="meta")
    n = sum(p.numel() for p in model.parameters())
    assert n == cfg.param_count() == ref_get_config("mamba2_130m").param_count()
    assert round(n / 1e6, 1) == 129.0
    dtypes = {name.split(".")[-1]: p.dtype for name, p in model.named_parameters()}
    assert dtypes["A_log"] == dtypes["D"] == dtypes["dt_bias"] == torch.float32
    assert dtypes["w_z"] == dtypes["embed"] == torch.bfloat16


def test_reference_leaf_map_covers_every_mamba_parameter_once():
    ref_cfg, cfg = _cfgs()
    params = _np(ref_mdl.init_params(jax.random.PRNGKey(0), ref_cfg))
    leaves = reference_lm_leaves(cfg)
    names = [n for n, _, _ in leaves]
    assert names == [n for n, _ in mdl.init_params(cfg, device="meta").named_parameters()]
    assert len(set((p, i) for _, p, i in leaves)) == len(leaves)
    back = to_reference_lm_grads({n: torch.from_numpy(np.asarray(a))
                                  for n, a in from_reference_lm_tree(params, cfg).items()}, cfg)
    flat_back = jax.tree_util.tree_flatten_with_path(back)[0]
    flat_ref = jax.tree_util.tree_flatten_with_path(params)[0]
    assert [p for p, _ in flat_back] == [p for p, _ in flat_ref]
    for (_, a), (_, b) in zip(flat_back, flat_ref):
        np.testing.assert_array_equal(a, b)


def test_from_reference_keeps_the_float32_leaves_at_bfloat16():
    ref_cfg, params, cfg, model = _model_pair("bfloat16")
    for name, p in model.named_parameters():
        leaf = name.split(".")[-1]
        assert p.dtype == (torch.float32 if leaf in FLOAT32_LEAVES else torch.bfloat16), name
    np.testing.assert_array_equal(model.blocks[1].mamba.dt_bias.detach().numpy(),
                                  np.asarray(params["g0"]["l0"]["mamba"]["dt_bias"][1]))


def test_forward_prefill_and_decode_match_reference_float32():
    ref_cfg, params, cfg, model = _model_pair()
    tok = _tokens(cfg, PROMPT + GEN, seed=3)
    want_fwd, _ = _ref_forward(params, ref_cfg, jnp.asarray(tok[:, :PROMPT]))
    want, caches, _ = _ref_prefill(params, ref_cfg, jnp.asarray(tok[:, :PROMPT]), PROMPT + GEN)
    with torch.no_grad():
        got_fwd, aux = mdl.forward(model, torch.from_numpy(tok[:, :PROMPT]))
        got, tc, _ = mdl.prefill(model, torch.from_numpy(tok[:, :PROMPT]), PROMPT + GEN)
    assert float(aux) == 0.0
    _close(got_fwd, want_fwd)
    _close(got, want)
    assert all(isinstance(c, m2.SSMCache) for c in tc)
    for i in range(cfg.num_layers):
        _close(tc[i].h, caches["g0"]["l0"]["h"][i])
        _close(tc[i].C, caches["g0"]["l0"]["conv"]["C"][i])
    for i in range(GEN):  # teacher forcing: both fed the same tokens
        pos = PROMPT + i
        want, caches = _ref_decode_step(params, ref_cfg, jnp.asarray(tok[:, pos:pos + 1]),
                                           caches, jnp.asarray(pos, jnp.int32))
        with torch.no_grad():
            got, tc = mdl.decode_step(model, torch.from_numpy(tok[:, pos:pos + 1]), tc, pos)
        _close(got, want)
    _close(tc[3].h, caches["g0"]["l0"]["h"][3])


def test_forward_and_prefill_match_reference_bfloat16():
    ref_cfg, params, cfg, model = _model_pair("bfloat16")
    tok = _tokens(cfg, 32, seed=4)
    want_fwd, _ = _ref_forward(params, ref_cfg, jnp.asarray(tok))
    want, caches, _ = _ref_prefill(params, ref_cfg, jnp.asarray(tok), 34)
    with torch.no_grad():
        got_fwd, _ = mdl.forward(model, torch.from_numpy(tok))
        got, tc, _ = mdl.prefill(model, torch.from_numpy(tok), 34)
    assert got.dtype == torch.bfloat16 and tc[0].x.dtype == torch.bfloat16
    assert tc[0].h.dtype == torch.float32
    _close(got_fwd, want_fwd, 5e-2)
    _close(got, want, 5e-2)
    _close(tc[0].h, caches["g0"]["l0"]["h"][0], 5e-2)


def test_decode_equals_the_chunked_forward():
    """The port's own invariant (the reference's
    ``tests/test_model_consistency.py``): teacher-forced prefill + decode
    reproduces forward's logits, the prompt three chunks and the whole
    sequence padded to a fourth (causal: the padding cannot reach them)."""
    _, _, cfg, model = _model_pair()
    tok = torch.from_numpy(_tokens(cfg, PROMPT + GEN, seed=5))
    padded = torch.cat([tok, torch.zeros((B, 64 - PROMPT - GEN), dtype=tok.dtype)], dim=1)
    with torch.no_grad():
        full, _ = mdl.forward(model, padded)
        last, caches, _ = mdl.prefill(model, tok[:, :PROMPT], PROMPT + GEN)
        got = [last[:, 0]]
        for i in range(GEN - 1):
            logits, caches = mdl.decode_step(model, tok[:, PROMPT + i:PROMPT + i + 1], caches,
                                             PROMPT + i)
            got.append(logits[:, 0])
    torch.testing.assert_close(torch.stack(got, 1), full[:, PROMPT - 1:PROMPT + GEN - 1],
                               rtol=2e-3, atol=2e-3)


def test_init_caches_are_ssm_caches_of_one_size_at_any_length():
    cfg = reduced(get_config(ARCH))
    short, long = (mdl.init_caches(cfg, 2, n, torch.float32, device="cpu") for n in (8, 4096))
    assert len(short) == cfg.num_layers and all(isinstance(c, m2.SSMCache) for c in short)
    assert sum(c.nbytes() for c in short) == sum(c.nbytes() for c in long)
    assert tuple(short[0].h.shape) == (2, 8, 32, 16) and tuple(short[0].x.shape) == (2, 3, 256)


def test_serve_steps_are_greedy_on_mamba():
    _, _, cfg, model = _model_pair()
    tok = torch.from_numpy(_tokens(cfg, 32, seed=6))
    state = steps.serve_prefill(model, {"tokens": tok}, 35)
    assert torch.equal(state.last_token[:, 0], state.logits[:, -1].argmax(-1))
    nxt, logits = steps.serve_decode_step(model, state)
    assert nxt.position == 33 and torch.equal(nxt.last_token[:, 0], logits[:, -1].argmax(-1))


# ------------------------------------------------------------------- training


def _batch(seed, vocab, lead=(), seq=32, batch=B):
    tok = np.random.default_rng(seed).integers(0, vocab, lead + (batch, seq + 1)).astype(np.int32)
    return {"tokens": tok[..., :-1], "labels": tok[..., 1:]}


@pytest.mark.parametrize("remat", ["none", "full", "dots"])
def test_loss_fn_value_and_every_gradient_match_the_reference(remat):
    """Sequence 32, two chunks: the chunk recurrence's gradient too; under
    remat full each block recomputed in the backward."""
    ref_cfg, params, cfg, model = _model_pair(remat=remat)
    params = _np(params)
    b = _batch(7, cfg.vocab_size)
    (want, _), want_g = jax.jit(jax.value_and_grad(
        functools.partial(ref_steps.loss_fn, cfg=ref_cfg), has_aux=True))(params, batch=_ref_batch(b))
    total, _ = steps.loss_fn(model, cfg, _port_batch(b))
    named = dict(model.named_parameters())
    grads = dict(zip(named, torch.autograd.grad(total, list(named.values()))))
    np.testing.assert_allclose(float(total.detach()), float(want), rtol=1e-5)
    flat_want = jax.tree_util.tree_flatten_with_path(_np(want_g))[0]
    flat_got = jax.tree_util.tree_flatten_with_path(to_reference_lm_grads(grads, cfg))[0]
    assert [p for p, _ in flat_got] == [p for p, _ in flat_want]
    for (path, g), (_, w) in zip(flat_got, flat_want):
        _leaf_close(g, w, what=jax.tree_util.keystr(path))


def test_two_train_steps_match_the_reference():
    ref_cfg, params, cfg, model = _model_pair()
    ref_opt = ref_adamw_init(params)
    opt = adamw_init(dict(model.named_parameters()))
    b = _batch(8, cfg.vocab_size)
    ref_step = jax.jit(functools.partial(ref_steps.train_step, cfg=ref_cfg))
    for _ in range(2):
        params, ref_opt, want = ref_step(params, ref_opt, _ref_batch(b))
        model, opt, got = steps.train_step(model, opt, _port_batch(b), cfg)
        np.testing.assert_allclose(float(got["loss"]), float(want["loss"]), rtol=1e-5)
    ref = from_reference_lm_tree(_np(params), cfg)
    for name, p in model.named_parameters():  # a tenth of the two steps' largest move
        np.testing.assert_allclose(p.detach().numpy(), ref[name], rtol=1e-5, atol=0.1 * 2 * 3e-4,
                                   err_msg=name)


def test_adamw_keeps_each_leafs_dtype_and_rounding_at_bfloat16():
    """AdamW over a bf16 model's leaves (the float32 three beside bf16 ones)
    on given gradients, against the reference's ``adamw_update`` on the same
    pytree: every leaf stays in its dtype, float32 leaves within 1e-6, bf16
    leaves within one bf16 ulp of the result (the float32 update is cast
    back once per leaf, in both), or 1e-4, a hundredth of a step, near zero
    (where a rounding the two take apart at step 1 is a few ulps)."""
    ref_cfg, params, cfg, model = _model_pair("bfloat16")
    ref_p = params
    ref_s = ref_adamw_init(ref_p)
    ref_update = jax.jit(functools.partial(ref_adamw_update, lr=1e-2))
    named = dict(model.named_parameters())
    state = adamw_init(named)
    rng = np.random.default_rng(9)
    for _ in range(2):
        g_tree = jax.tree.map(lambda a: jnp.asarray(
            rng.standard_normal(a.shape).astype(np.float32), a.dtype), ref_p)
        ref_p, ref_s = ref_update(ref_p, g_tree, ref_s)
        grads = {n: torch.from_numpy(np.asarray(a, np.float32)).to(named[n].dtype)
                 for n, a in from_reference_lm_tree(_np(g_tree), cfg).items()}
        _, state = adamw_update(named, grads, state, lr=1e-2)
    want = from_reference_lm_tree(_np(ref_p), cfg)
    for name, p in named.items():
        w = np.asarray(want[name], np.float32)
        if name.split(".")[-1] in FLOAT32_LEAVES:
            assert p.dtype == torch.float32
            np.testing.assert_allclose(p.detach().numpy(), w, rtol=1e-6, atol=1e-6, err_msg=name)
        else:
            assert p.dtype == torch.bfloat16
            np.testing.assert_allclose(p.detach().float().numpy(), w, rtol=2 ** -7, atol=1e-4,
                                       err_msg=name)


# the pSGLD step at tests/test_epmcmc.py's config
EP_OVER = dict(num_layers=2, d_model=64, vocab_size=128)
CHAINS = 4
KW = dict(num_shards=CHAINS, shard_tokens=1e4, step_size=1e-4)


@jax.jit
def _ref_noise(ref_state):
    """The normal draws the reference's step takes from each chain's key."""
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
    """One pSGLD step (T = 1, the reference's noise) of 4 chains on (C, 2,
    16) batches (``test_epmcmc.py``'s shapes): per-chain losses and gradient
    norms, then θ and the running mean (burn-in 0: the step folds θ), all but
    ``NOISY_MISSES`` entries of a leaf within 5 % of the reference's move
    there, and v, against the reference's."""
    temperature = 1.0
    ref_cfg, cfg = _cfgs(**EP_OVER)
    ref_state = _ref_init_state(jax.random.PRNGKey(0), ref_cfg, CHAINS)
    state = from_reference_epmcmc_state(_np(ref_state), cfg, device="cpu")
    init = from_reference_lm_tree(_np(ref_state.params), cfg, lead=1)
    tok = np.random.default_rng(10).integers(0, cfg.vocab_size, (CHAINS, 2, 16)).astype(np.int32)
    b = {"tokens": tok, "labels": np.roll(tok, -1, axis=-1)}
    noise = [{n: torch.from_numpy(np.array(a)) for n, a in
              from_reference_lm_tree(_np(tree), cfg).items()} for tree in _ref_noise(ref_state)]
    ref_state, want = jax.jit(functools.partial(
        ref_epmcmc.epmcmc_step, cfg=ref_cfg, temperature=temperature, **KW))(ref_state,
                                                                            _ref_batch(b))
    state, got = epmcmc.epmcmc_step(state, _port_batch(b), cfg, temperature=temperature,
                                    noise=noise, **KW)
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
    np.testing.assert_array_equal(state.m_count.numpy(), np.asarray(ref_state.m_count))


def test_epmcmc_state_keeps_each_leafs_dtype_at_bfloat16():
    """A bf16 config's stacked state: the float32 three stay float32 (bit for
    bit the reference's) after ``from_reference_epmcmc_state``, ``init_state``
    and a step; the other parameters bf16; v and the moments float32."""
    _, cfg = _cfgs("bfloat16", **EP_OVER)
    params = jax.tree.map(lambda a: np.stack([a, a]), _ref_params("bfloat16", 0,
                                                                   tuple(EP_OVER.items())))
    zeros = jax.tree.map(lambda a: np.zeros(a.shape, np.float32), params)
    ref_state = ref_epmcmc.EpmcmcState(params=params, v=zeros, step=np.int32(0), key=None,
                                       m_count=np.zeros((2,), np.float32), m_mean=zeros,
                                       m_var=zeros)
    crossed = from_reference_epmcmc_state(ref_state, cfg, device="cpu")
    np.testing.assert_array_equal(crossed.params["blocks.1.mamba.A_log"].numpy(),
                                  params["g0"]["l0"]["mamba"]["A_log"][:, 1])
    own = epmcmc.init_state(0, cfg, 2, device="cpu")
    tok = np.random.default_rng(11).integers(0, cfg.vocab_size, (2, 2, 16))
    stepped, _ = epmcmc.epmcmc_step(own, {"tokens": torch.from_numpy(tok)}, cfg, num_shards=2,
                                    shard_tokens=1e4, step_size=1e-4)
    for state in (crossed, stepped):
        for name, p in state.params.items():
            f32 = name.split(".")[-1] in FLOAT32_LEAVES
            assert p.dtype == (torch.float32 if f32 else torch.bfloat16), name
            assert state.v[name].dtype == state.m_mean[name].dtype == torch.float32


# ------------------------------------------------------------------- the CLIs


def test_serve_cli_runs_and_refuses_a_ragged_prompt():
    out = serve.main(["--arch", "mamba2-130m", "--reduced", "--device", "cpu", "--prompt-len",
                      "32", "--gen", "3"])
    assert tuple(out["tokens"].shape) == (2, 3) and bool(torch.isfinite(out["logits"]).all())
    with pytest.raises(ValueError, match="SSD chunks"):
        serve.main(["--arch", "mamba2-130m", "--reduced", "--device", "cpu", "--prompt-len",
                    "40"])


BASE = ["--device", "cpu", "--arch", "mamba2_130m", "--reduced", "--batch", "2", "--seq", "32",
        "--log-every", "2"]


def test_train_cli_epmcmc_then_resume(tmp_path):
    """The reference's ``tests/test_drivers.py:12``: epmcmc, then a restart
    from its checkpoint, here bit for bit the uninterrupted run."""
    run = BASE + ["--mode", "epmcmc", "--chains", "2", "--ckpt-dir", str(tmp_path),
                  "--ckpt-every", "2"]
    out = train.main(run + ["--steps", "4"])
    assert np.isfinite(out["loss"])
    resumed = train.main(run + ["--resume", "--steps", "6"])
    assert np.isfinite(resumed["loss"]) and resumed["state"].step == 6
    full = train.main(BASE + ["--mode", "epmcmc", "--chains", "2", "--steps", "6"])["state"]
    for name, t in full.params.items():
        assert torch.equal(t, resumed["state"].params[name]), name


def test_train_cli_adamw_runs():
    """The reference's ``tests/test_drivers.py:25`` (adamw, finite loss)."""
    out = train.main(BASE[:-4] + ["--mode", "adamw", "--steps", "8", "--batch", "4", "--seq", "64",
                                  "--log-every", "8"])
    assert np.isfinite(out["loss"]) and len(out["losses"]) == 8


def test_train_cli_sgd_runs_and_refuses_a_ragged_sequence():
    out = train.main(BASE + ["--mode", "sgd", "--chains", "2", "--steps", "2"])
    assert out["losses"][0].shape == (2,)
    with pytest.raises(ValueError, match="SSD chunks"):
        train.main(BASE[:-4] + ["--seq", "40", "--steps", "1"])


def test_lm_bayes_sgld_runs_the_references_model():
    out = lm_bayes_sgld.main(["--device", "cpu", "--steps", "26", "--burn-in", "10", "--chains",
                              "2", "--batch", "2", "--seq", "32"])
    assert out["state"].params["blocks.0.mamba.A_log"].dtype == torch.float32
    assert out["history"].shape == (2, 16, 128)
    assert out["restored_step"] == 25 and out["restored"].m_count.tolist() == [15.0, 15.0]
    assert bool(torch.isfinite(out["combined"].samples).all())
