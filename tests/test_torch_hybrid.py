"""The port's hybrid family (Jamba: Mamba-2, GQA, MLP and MoE layers) on the CPU against ``repro``.

Config: ``reduced(get_config("jamba_1_5_large"), attn_chunk=16)`` — one whole
period of 8 layers (the reference's ``layer_groups`` asserts a whole number
of periods): l0 mamba+mlp, l1 mamba+moe, l2 mamba+mlp, l3 mamba+moe, l4
attn+mlp, l5 mamba+moe, l6 mamba+mlp, l7 mamba+moe; d 128, 4/2 heads of 32,
d_inner 256 (8 SSM heads of 32), d_state 16, SSD chunk 16, 8 experts top-2
at capacity factor 4 (dropless), groups of 16, vocab 512, untied, float32.
``attn_chunk=16`` sends layer 4's attention through flash (its plain
version here) at sequences over 16. The reference's weights cross through
``repro_torch.interop.from_reference_lm_params``; tokens and noise are drawn
with numpy (or by the reference, for its noise) and fed to both. Weights are
the port's draws (``init_params`` from a seeded ``torch.Generator``) taken to
the reference's pytree by ``interop.to_reference_lm_grads`` and loaded back
by ``from_reference_lm_params``: the reference's own jitted ``init_params``
of this period takes ~10 s to compile, a fifth of the file's budget.

Tolerances, as ``tests/test_torch_mamba2.py`` and ``tests/test_torch_moe.py``
hold the same quantities: float32 logits 1e-4; the port's decode against its
own forward 2e-3 (the reference's ``tests/test_model_consistency.py``
bound); bf16 block by block as ``test_torch_moe.py`` holds it (each block
fed the reference's input, its output within 2^-6 of the largest |h| where
the two route alike, the router's choice alike but at near-ties under 1e-2,
at most 2 % of (position, MoE layer) pairs; the head within 5e-2), and the
whole bf16 prefill and decode within twice the reference's own bf16 error
of the float32 reference on the same weights (``chip_smoke.py`` 4d's rule:
eight bf16 layers drift ~0.1–0.2 in the logits from float32 in either
package); the loss
1e-5 relative, gradients leaf by leaf within 1e-4 of each leaf's max|g| plus
1e-4 relative; after two ``train_step``s a tenth of the steps' largest move;
the pSGLD step at T = 0 (no noise: the noise's plumbing is the families'
shared code, held with the reference's noise in ``test_torch_encdec.py``):
losses 1e-5, gradient norms 1e-4, all but ``NOISY_MISSES`` entries of a leaf
within 5 % of its move, v 1e-3 relative.
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
from repro.optim.adamw import adamw_update as ref_adamw_update
from repro_torch.configs import get_config
from repro_torch.distributed import epmcmc
from repro_torch.interop import (
    from_reference_epmcmc_state,
    from_reference_lm_params,
    from_reference_lm_tree,
    reference_lm_leaves,
    to_reference_lm_grads,
)
from repro_torch.launch import serve, train
from repro_torch.models.lm import mamba2 as m2
from repro_torch.models.lm import model as mdl
from repro_torch.models.lm import moe as moe_lib
from repro_torch.models.lm import steps
from repro_torch.models.lm.config import reduced
from repro_torch.optim import adamw_init
from test_torch_threads import pin_torch_threads
from test_torch_train import NOISY_MISSES, _leaf_close, _np, _port_batch, _ref_batch

pin_torch_threads()  # this worker's share of the cores under a parallel run

ARCH = "jamba_1_5_large"
B, PROMPT, GEN = 2, 48, 4
PERIOD = [("mamba", "mlp"), ("mamba", "moe"), ("mamba", "mlp"), ("mamba", "moe"),
          ("attn", "mlp"), ("mamba", "moe"), ("mamba", "mlp"), ("mamba", "moe")]


def _cfgs(dtype="float32", **over):
    over = dict(dict(attn_chunk=16), **over)
    ref, port = ref_reduced(ref_get_config(ARCH), **over), reduced(get_config(ARCH), **over)
    if dtype != "float32":
        ref = dataclasses.replace(ref, dtype=dtype, param_dtype=dtype)
        port = dataclasses.replace(port, dtype=dtype, param_dtype=dtype)
    return ref, port


def _head_block(cfg, hb):
    return dataclasses.replace(cfg, ssm=dataclasses.replace(cfg.ssm, head_block=hb))


_ref_forward = jax.jit(ref_mdl.forward, static_argnums=1)
_ref_block = jax.jit(ref_mdl._block_forward, static_argnums=(1, 2))
# the reference's train_step is this value_and_grad, then adamw_update: jitted
# apart, the loss test and the train-step test share one compile of the period
_ref_value_and_grad = jax.jit(jax.value_and_grad(ref_steps.loss_fn, has_aux=True),
                              static_argnums=1)
_ref_adamw_update = jax.jit(ref_adamw_update)
_ref_prefill = jax.jit(ref_mdl.prefill, static_argnums=(1, 3))
_ref_decode_step = jax.jit(ref_mdl.decode_step, static_argnums=1)


FLOAT32_LEAVES = ("A_log", "dt_bias", "D")  # Mamba-2's, float32 in either dtype


def ref_tree(named, cfg):
    """The port's ``{name: tensor}`` as the reference's pytree of numpy
    leaves, each in its parameter's dtype (``ml_dtypes.bfloat16`` for bf16)."""
    tree = to_reference_lm_grads(named, cfg)
    if cfg.param_dtype == "float32":
        return tree
    return jax.tree_util.tree_map_with_path(
        lambda path, a: a if path[-1].key in FLOAT32_LEAVES and path[-2].key == "mamba"
        else np.asarray(jnp.asarray(a, jnp.bfloat16)), tree)


@functools.lru_cache(maxsize=None)
def _ref_params(dtype, seed, over=()):
    """Weights drawn by the port from ``seed``, as the reference's pytree."""
    cfg = _cfgs(dtype, **dict(over))[1]
    model = mdl.init_params(cfg, generator=torch.Generator().manual_seed(seed), device="cpu")
    return ref_tree(dict(model.named_parameters()), cfg)


def _model_pair(dtype="float32", seed=0, **over):
    """(ref cfg, ref params (numpy), port cfg, port model with those weights);
    ``over`` (remat, head_block) leaves the parameters' shapes alone."""
    ref_cfg, cfg = _cfgs(dtype, **over)
    params = _ref_params(dtype, seed)
    return ref_cfg, params, cfg, from_reference_lm_params(params, cfg, device="cpu")


def _tokens(cfg, n, seed=1, batch=B):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, (batch, n))


def _close(got, want, tol=1e-4):
    got = got.detach().float().numpy()
    want = np.asarray(jnp.asarray(want, jnp.float32))
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol)


# ------------------------------------------------------------------ the model


def test_model_builds_and_maps_every_weight_once():
    """The period's specs, the reference's parameter count, every Mamba
    layer's ``ln2`` and FFN kept, and the leaf map: every parameter once, in
    the port's order, and back to the reference's pytree leaf for leaf."""
    ref_cfg, params, cfg, model = _model_pair()
    assert [(s.mixer, s.ffn) for s in mdl.layer_specs(cfg)] == PERIOD
    assert sum(p.numel() for p in model.parameters()) == cfg.param_count() == ref_cfg.param_count()
    assert hasattr(model.blocks[0], "ln2") and hasattr(model.blocks[0], "mlp")
    assert isinstance(model.blocks[1].moe, moe_lib.MoE) and hasattr(model.blocks[4], "attn")
    leaves = reference_lm_leaves(cfg)
    assert [n for n, _, _ in leaves] == [n for n, _ in model.named_parameters()]
    assert len({(p, i) for _, p, i in leaves}) == len(leaves)
    back = to_reference_lm_grads({n: torch.from_numpy(np.asarray(a))
                                  for n, a in from_reference_lm_tree(params, cfg).items()}, cfg)
    flat_back = jax.tree_util.tree_flatten_with_path(back)[0]
    flat_ref = jax.tree_util.tree_flatten_with_path(params)[0]
    assert [p for p, _ in flat_back] == [p for p, _ in flat_ref]
    for (_, a), (_, w) in zip(flat_back, flat_ref):
        np.testing.assert_array_equal(a, w)
    sd = model.state_dict()
    np.testing.assert_array_equal(sd["blocks.3.moe.experts.w_up"].numpy(),
                                  params["g0"]["l3"]["moe"]["experts"]["w_up"])
    np.testing.assert_array_equal(sd["blocks.6.mlp.w_down"].numpy(),
                                  params["g0"]["l6"]["mlp"]["w_down"])


@pytest.mark.parametrize("arch", ["jamba_1_5_large", "jamba-1.5-large-398b"])
def test_full_width_config_builds_with_the_references_count(arch):
    """72 layers, d 8,192, 16 experts: 398 B parameters, on the meta device."""
    cfg = get_config(arch)
    mdl.check_supported(cfg)
    model = mdl.init_params(cfg, device="meta")
    n = sum(p.numel() for p in model.parameters())
    assert n == cfg.param_count() == ref_get_config(ARCH).param_count()
    assert round(n / 1e9) == 398


def test_five_layers_build_where_the_reference_refuses():
    """The card's cut: layers 0–4 of the period (every kind it has, all 16
    experts, every width kept): 23.99 B parameters, 47.98 GB in bf16. The
    reference cannot build it (``layer_groups`` asserts whole periods); the
    port builds from ``layer_specs``."""
    cfg = dataclasses.replace(get_config(ARCH), num_layers=5)
    with pytest.raises(AssertionError):
        mdl.layer_groups(cfg)
    model = mdl.init_params(cfg, device="meta")
    assert [(s.mixer, s.ffn) for s in mdl.layer_specs(cfg)] == PERIOD[:5]
    n = sum(p.numel() for p in model.parameters())
    assert n == cfg.param_count() and round(n / 1e9, 2) == 23.99
    assert round(sum(p.numel() * p.element_size() for p in model.parameters()) / 1e9, 2) == 47.98
    assert model.blocks[1].moe.experts.w_gate.shape == (16, 8192, 24576)
    caches = mdl.init_caches(cfg, 1, 8, torch.bfloat16, device="meta")
    assert [type(c).__name__ for c in caches] == ["SSMCache"] * 4 + ["dict"]


def test_forward_prefill_and_decode_match_reference_float32():
    ref_cfg, params, cfg, model = _model_pair()
    tok = _tokens(cfg, PROMPT + GEN, seed=3)
    want_fwd, want_aux = _ref_forward(params, ref_cfg, jnp.asarray(tok[:, :PROMPT]))
    want, caches, mem = _ref_prefill(params, ref_cfg, jnp.asarray(tok[:, :PROMPT]), PROMPT + GEN)
    with torch.no_grad():
        got_fwd, aux = mdl.forward(model, torch.from_numpy(tok[:, :PROMPT]))
        got, tc, memory = mdl.prefill(model, torch.from_numpy(tok[:, :PROMPT]), PROMPT + GEN)
    assert mem is None and memory is None
    _close(got_fwd, want_fwd)
    np.testing.assert_allclose(float(aux), float(want_aux), rtol=1e-5)
    _close(got, want)
    for i in (0, 3, 7):
        assert isinstance(tc[i], m2.SSMCache)
        _close(tc[i].h, caches["g0"][f"l{i}"]["h"])
    _close(tc[4]["k"], caches["g0"]["l4"]["k"])
    for i in range(GEN):  # teacher forcing: both fed the same tokens
        pos = PROMPT + i
        want, caches = _ref_decode_step(params, ref_cfg, jnp.asarray(tok[:, pos:pos + 1]),
                                        caches, jnp.asarray(pos, jnp.int32))
        with torch.no_grad():
            got, tc = mdl.decode_step(model, torch.from_numpy(tok[:, pos:pos + 1]), tc, pos)
        _close(got, want)
    _close(tc[5].h, caches["g0"]["l5"]["h"])


def test_ssd_over_head_blocks_matches_reference():
    """``head_block`` 2 of the 8 SSM heads (the reference's ``lax.map`` over
    head blocks; jamba's own is 16 of 256): the model's forward and prefill."""
    ref_cfg, params, cfg, model = _model_pair()
    ref_cfg, cfg = _head_block(ref_cfg, 2), _head_block(cfg, 2)
    model = from_reference_lm_params(params, cfg, device="cpu")
    assert cfg.ssm.head_block < m2._dims(cfg)[1]
    tok = _tokens(cfg, 32, seed=4)
    want, _ = _ref_forward(params, ref_cfg, jnp.asarray(tok))
    want_last, _, _ = _ref_prefill(params, ref_cfg, jnp.asarray(tok), 34)
    with torch.no_grad():
        got, _ = mdl.forward(model, torch.from_numpy(tok))
        got_last, _, _ = mdl.prefill(model, torch.from_numpy(tok), 34)
    _close(got, want)
    _close(got_last, want_last)


def test_forward_prefill_and_decode_match_reference_bfloat16_block_by_block():
    """bf16, as ``test_torch_moe.py`` holds it (MoE routing is chaotic in
    bf16: a one-ulp difference flips a near-tie and spreads): every block fed
    the reference's own input, its output within 2^-6 of the largest |h|
    wherever the MoE blocks route alike, the router alike but at near-ties;
    the head within 5e-2. Then the whole prefill and a decode step against
    the reference's at the MoE tests' whole-model tolerance on the positions
    they do not route apart: prefill's last logits and the first decode
    step's within 5e-2 unless a near-tie flipped."""
    from repro.models.lm import layers as ref_layers

    ref_cfg, params, cfg, model = _model_pair("bfloat16", seed=5)
    tok = _tokens(cfg, PROMPT, seed=6)
    h, pos, _ = ref_mdl._inputs_to_h(params, ref_cfg, jnp.asarray(tok), None)
    tpos = torch.arange(PROMPT).expand(B, PROMPT)
    seen, flips, n_moe = [], 0, 0
    hooks = [blk.ln2.register_forward_hook(lambda m, a, o: seen.append(o)) for blk in model.blocks]
    for i, (block, spec) in enumerate(zip(model.blocks, ref_mdl.layer_specs(ref_cfg))):
        lp = params["g0"][f"l{i}"]
        x_in = torch.from_numpy(np.asarray(h, np.float32)).to(torch.bfloat16)
        with torch.no_grad():
            got, _ = block(x_in, tpos)
        same = np.ones((B, PROMPT), bool)
        if spec.ffn == "moe":
            n_moe += 1
            with torch.no_grad():
                _, _, idx = moe_lib.route(block.moe, seen[-1])
            h_mid, _ = _ref_block(lp, ref_cfg, spec._replace(ffn="none"), h, pos, None)
            logits = ref_layers.rmsnorm(lp["ln2"], h_mid, ref_cfg.norm_eps) @ lp["moe"]["router"]
            probs = np.asarray(jax.nn.softmax(logits.astype(jnp.float32), axis=-1))
            _, ref_idx = jax.lax.top_k(jnp.asarray(probs), cfg.moe.top_k)
            same = (np.sort(idx.numpy(), -1) == np.sort(np.asarray(ref_idx), -1)).all(-1)
            top = np.sort(probs, -1)[..., ::-1]
            margin = top[..., cfg.moe.top_k - 1] - top[..., cfg.moe.top_k]
            assert (margin[~same] < 1e-2).all(), (i, margin[~same])
            flips += int((~same).sum())
        h, _ = _ref_block(lp, ref_cfg, spec, h, pos, None)
        want = np.asarray(h, np.float32)
        err = np.abs(got.float().numpy() - want)[same]
        assert err.max() <= 2.0 ** -6 * np.abs(want).max(), (i, err.max())
    for hk in hooks:
        hk.remove()
    assert flips <= 0.02 * B * PROMPT * n_moe, flips
    with torch.no_grad():
        head = model.head(torch.from_numpy(np.asarray(h, np.float32)).to(torch.bfloat16))
    want_head = ref_layers.rmsnorm(params["final_norm"], h, ref_cfg.norm_eps) @ params["lm_head"]
    np.testing.assert_allclose(head.float().numpy(), np.asarray(want_head, np.float32),
                               rtol=5e-2, atol=5e-2)
    ref32, cfg32 = _cfgs()
    params32 = jax.tree.map(lambda a: np.asarray(a, np.float32), params)
    runs = {}
    for name, c, p in (("bf16", ref_cfg, params), ("float32", ref32, params32)):
        last, caches, _ = _ref_prefill(p, c, jnp.asarray(tok), PROMPT + 1)
        step, _ = _ref_decode_step(p, c, jnp.asarray(tok[:, -1:]), caches,
                                   jnp.asarray(PROMPT, jnp.int32))
        runs[name] = [np.asarray(jnp.asarray(x, jnp.float32)) for x in (last, step)]
    with torch.no_grad():
        got, tc, _ = mdl.prefill(model, torch.from_numpy(tok), PROMPT + 1)
        got_dec, _ = mdl.decode_step(model, torch.from_numpy(tok[:, -1:]), tc, PROMPT)
    assert got.dtype == torch.bfloat16 and tc[0].h.dtype == torch.float32
    for port, ref16, ref32_ in zip((got, got_dec), runs["bf16"], runs["float32"]):
        err, own = np.abs(port.float().numpy() - ref32_).max(), np.abs(ref16 - ref32_).max()
        assert err <= 2.0 * own, (err, own)


def test_decode_equals_the_forward():
    """The port's own invariant (the reference's
    ``tests/test_model_consistency.py``): teacher-forced prefill + decode
    reproduces forward's logits, the prompt three SSD chunks and the whole
    sequence padded to a fourth (causal: the padding cannot reach them);
    dropless at the reduced capacity factor."""
    _, _, cfg, model = _model_pair(seed=7)
    tok = torch.from_numpy(_tokens(cfg, PROMPT + GEN, seed=8))
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


def test_serve_steps_are_greedy_on_the_hybrid():
    _, _, cfg, model = _model_pair()
    tok = torch.from_numpy(_tokens(cfg, 32, seed=9))
    state = steps.serve_prefill(model, {"tokens": tok}, 35)
    assert state.memory is None
    assert torch.equal(state.last_token[:, 0], state.logits[:, -1].argmax(-1))
    nxt, logits = steps.serve_decode_step(model, state)
    assert nxt.position == 33 and torch.equal(nxt.last_token[:, 0], logits[:, -1].argmax(-1))


# ------------------------------------------------------------------- training


def _batch(seed, vocab, lead=(), seq=32, batch=B):
    tok = np.random.default_rng(seed).integers(0, vocab, lead + (batch, seq + 1)).astype(np.int32)
    return {"tokens": tok[..., :-1], "labels": tok[..., 1:]}


@pytest.mark.parametrize("remat", ["none", "full"])
def test_loss_fn_value_and_every_gradient_match_the_reference(remat):
    """Sequence 32: two SSD chunks, layer 4 through flash and its backward,
    the MoE aux loss in the total; under remat full each block recomputed
    in the backward. Both against the reference's gradient (its remat
    changes no value: ``jax.checkpoint`` of the period)."""
    _, params, cfg, model = _model_pair(remat=remat)
    b = _batch(10, cfg.vocab_size)
    (want, want_m), want_g = _ref_value_and_grad(params, _cfgs()[0], _ref_batch(b))
    total, metrics = steps.loss_fn(model, cfg, _port_batch(b))
    grads = steps.grads_of(total, dict(model.named_parameters()))
    np.testing.assert_allclose(float(total.detach()), float(want), rtol=1e-5)
    np.testing.assert_allclose(float(metrics["moe_aux"].detach()), float(want_m["moe_aux"]),
                               rtol=1e-5)
    flat_want = jax.tree_util.tree_flatten_with_path(_np(want_g))[0]
    flat_got = jax.tree_util.tree_flatten_with_path(to_reference_lm_grads(grads, cfg))[0]
    assert [p for p, _ in flat_got] == [p for p, _ in flat_want]
    for (path, g), (_, w) in zip(flat_got, flat_want):
        _leaf_close(g, w, what=jax.tree_util.keystr(path))


def test_two_train_steps_match_the_reference():
    ref_cfg, params, cfg, model = _model_pair()
    ref_opt = ref_adamw_init(params)
    opt = adamw_init(dict(model.named_parameters()))
    b = _batch(11, cfg.vocab_size)
    for _ in range(2):
        (want, _), grads = _ref_value_and_grad(params, ref_cfg, _ref_batch(b))
        params, ref_opt = _ref_adamw_update(params, grads, ref_opt)
        model, opt, got = steps.train_step(model, opt, _port_batch(b), cfg)
        np.testing.assert_allclose(float(got["loss"]), float(want), rtol=1e-5)
    ref = from_reference_lm_tree(_np(params), cfg)
    for name, p in model.named_parameters():  # a tenth of the two steps' largest move
        np.testing.assert_allclose(p.detach().numpy(), ref[name], rtol=1e-5, atol=0.1 * 2 * 3e-4,
                                   err_msg=name)


EP_OVER = dict(d_model=64, vocab_size=128)  # a whole period of 8 layers, narrower
CHAINS = 2
KW = dict(num_shards=CHAINS, shard_tokens=1e4, step_size=1e-4)


def test_epmcmc_step_matches_the_reference():
    """One pSGLD step at T = 0 of 2 chains on (C, 2, 16) batches: per-chain
    losses and gradient norms, θ and the running mean (burn-in 0) within 5 %
    of the reference's move but ``NOISY_MISSES`` entries a leaf, v within
    1e-3."""
    ref_cfg, cfg = _cfgs(**EP_OVER)
    own = epmcmc.init_state(0, cfg, CHAINS, device="cpu")
    params = ref_tree(own.params, cfg)  # (C, ...) leaves: one period, no layer axis
    zeros = jax.tree.map(np.zeros_like, params)
    ref_state = ref_epmcmc.EpmcmcState(
        params=params, v=zeros, step=jnp.int32(0), key=jax.random.split(jax.random.PRNGKey(0),
                                                                        CHAINS),
        m_count=jnp.zeros((CHAINS,), jnp.float32), m_mean=zeros, m_var=zeros)
    state = from_reference_epmcmc_state(_np(ref_state), cfg, device="cpu")
    init = from_reference_lm_tree(_np(ref_state.params), cfg, lead=1)
    tok = np.random.default_rng(12).integers(0, cfg.vocab_size, (CHAINS, 2, 16)).astype(np.int32)
    b = {"tokens": tok, "labels": np.roll(tok, -1, axis=-1)}
    ref_state, want = jax.jit(functools.partial(ref_epmcmc.epmcmc_step, cfg=ref_cfg,
                                                temperature=0.0, **KW))(ref_state, _ref_batch(b))
    state, got = epmcmc.epmcmc_step(state, _port_batch(b), cfg, temperature=0.0, **KW)
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


def test_serve_cli_runs_the_reduced_hybrid():
    out = serve.main(["--arch", "jamba-1.5-large-398b", "--reduced", "--device", "cpu",
                      "--prompt-len", "32", "--gen", "3"])
    assert tuple(out["tokens"].shape) == (2, 3) and bool(torch.isfinite(out["logits"]).all())
    assert out["enc_frames"] is None
    with pytest.raises(ValueError, match="SSD chunks"):
        serve.main(["--arch", "jamba-1.5-large-398b", "--reduced", "--device", "cpu",
                    "--prompt-len", "40"])


@pytest.mark.parametrize("mode", ["adamw", "epmcmc"])
def test_train_cli_runs_the_reduced_hybrid(mode):
    out = train.main(["--device", "cpu", "--arch", "jamba-1.5-large-398b", "--reduced",
                      "--mode", mode, "--steps", "2", "--batch", "2", "--seq", "32",
                      "--chains", "2", "--log-every", "2"])
    assert np.isfinite(out["loss"]) and len(out["losses"]) == 2
