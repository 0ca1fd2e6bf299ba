"""The port's LM training path on the CPU against ``repro``, and its own checks.

Config: ``reduced(get_config("llama3_2_3b"), attn_chunk=16)`` — 4 layers,
d 128, 4/2 heads, hd 32, vocab 512, float32, the tied head — at sequence
64, so every layer's attention takes flash (S > attn_chunk) and its
backward the flash backward's plain version. The reference's weights and
EP-MCMC state cross through ``repro_torch.interop``; gradients come back
through ``to_reference_lm_grads`` and are compared leaf by leaf. Tokens,
gradients and noise are drawn with numpy (or by the reference, for its
noise) and handed to both.

Tolerances, float32: 1e-5 on the loss and cross-entropy values; gradients
within 1e-4 of max|g| of each leaf plus 1e-4 relative (four layers of
float32 matrix products and the flash backward summed in other orders than
XLA's); AdamW on given gradients 1e-6 absolute (elementwise float32 maths on
values of size ~0.1); after three ``train_step``s, or two or three sampler
steps, a share of the largest move the steps can make (AdamW and pSGLD
divide each gradient by its own RMS, so the entries with near-zero
gradients carry their relative rounding into their moves; see
``_compare_states``); losses per chain 1e-5 relative (1e-3 with noise),
gradient norms 1e-4 (with noise at the first step only: see the test).
``TokenStream``'s draws are not JAX's (another generator): its marginal is
held to the reference's by moments, within 5 Monte Carlo standard errors.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.data.tokens import TokenStream as RefTokenStream
from repro.distributed import epmcmc as ref_epmcmc
from repro.models.lm import model as ref_mdl
from repro.models.lm import steps as ref_steps
from repro.models.lm.config import reduced as ref_reduced
from repro.models.lm.loss import cross_entropy as ref_cross_entropy
from repro.models.lm.loss import shift_labels as ref_shift_labels
from repro.optim.adamw import adamw_init as ref_adamw_init
from repro.optim.adamw import adamw_update as ref_adamw_update
from repro_torch.configs import get_config
from repro_torch.data import TokenStream
from repro_torch.distributed import epmcmc
from repro_torch.interop import (
    from_reference_epmcmc_state,
    from_reference_lm_params,
    from_reference_lm_tree,
    to_reference_lm_grads,
)
from repro_torch.launch import lm_bayes_sgld, train
from repro_torch.models.lm import model as mdl
from repro_torch.models.lm import steps
from repro_torch.models.lm.config import reduced
from repro_torch.models.lm.loss import cross_entropy, shift_labels
from repro_torch.optim import adamw_init, adamw_update
from test_torch_threads import pin_torch_threads

pin_torch_threads()  # this worker's share of the cores under a parallel run

ARCH = "llama3_2_3b"
SEQ, BATCH = 64, 2


def _cfgs(**over):
    return (ref_reduced(ref_get_config(ARCH), attn_chunk=16, **over),
            reduced(get_config(ARCH), attn_chunk=16, **over))


def _tokens(seed, shape, vocab):
    return np.random.default_rng(seed).integers(0, vocab, size=shape).astype(np.int32)


def _batch(seed, vocab, lead=()):
    tok = _tokens(seed, lead + (BATCH, SEQ + 1), vocab)
    return {"tokens": tok[..., :-1], "labels": tok[..., 1:]}


def _ref_batch(b):
    return {k: jnp.asarray(v) for k, v in b.items()}


def _port_batch(b):
    return {k: torch.from_numpy(v.astype(np.int64)) for k, v in b.items()}


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _jit(fn, **kw):
    """A reference function jitted with its static arguments bound (eager
    JAX dispatches every op of a vmapped step alone: many times slower)."""
    return jax.jit(functools.partial(fn, **kw))


def _leaf_close(got, want, rtol=1e-4, scale=1e-4, what=""):
    """|got − want| ≤ scale·max|want| + rtol·|want|, leaf by leaf."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    atol = scale * max(float(np.abs(want).max()), 1e-30)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol, err_msg=what)


def _compare_trees(port: dict, ref_tree, cfg, *, lead=0, **tol):
    ref = from_reference_lm_tree(_np(ref_tree), cfg, lead=lead)
    assert set(port) == set(ref)
    for name, t in port.items():
        _leaf_close(t.detach().float().numpy(), ref[name], what=name, **tol)


# ---------------------------------------------------------------------------
# loss
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("z", [0.0, 1e-4])
def test_cross_entropy_value_and_gradient(z):
    rng = np.random.default_rng(0)
    logits = (3 * rng.standard_normal((2, 7, 11))).astype(np.float32)
    logits[0, 0, 3] = logits[0, 0, 5] = logits[0, 0].max() + 1.0  # a tie at the max
    labels = rng.integers(0, 11, size=(2, 7)).astype(np.int32)

    def ref(x):
        loss, zl = ref_cross_entropy(x, jnp.asarray(labels), z_loss_coeff=z)
        return loss + zl, (loss, zl)

    (_, (want_ce, want_zl)), want_g = jax.value_and_grad(ref, has_aux=True)(jnp.asarray(logits))
    x = torch.from_numpy(logits).requires_grad_()
    ce, zl = cross_entropy(x, torch.from_numpy(labels.astype(np.int64)), z_loss_coeff=z)
    (ce + zl).backward()
    np.testing.assert_allclose(float(ce.detach()), float(want_ce), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(float(zl.detach()), float(want_zl), rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(want_g), rtol=1e-5, atol=1e-6)


def test_shift_labels():
    tok = _tokens(1, (3, 9), 50)
    got = shift_labels(torch.from_numpy(tok.astype(np.int64)), pad_id=7)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref_shift_labels(jnp.asarray(tok), 7)))


def _loss_pair(seed=0, **over):
    ref_cfg, cfg = _cfgs(**over)
    params = _np(ref_mdl.init_params(jax.random.PRNGKey(seed), ref_cfg))
    model = from_reference_lm_params(params, cfg, device="cpu")
    return ref_cfg, params, cfg, model


@pytest.mark.parametrize("labels", [True, False], ids=["labels", "shifted"])
def test_loss_fn_value_and_every_gradient_match_the_reference(labels):
    ref_cfg, params, cfg, model = _loss_pair()
    b = _batch(3, cfg.vocab_size)
    if not labels:
        del b["labels"]
    (want, want_m), want_g = jax.jit(jax.value_and_grad(
        functools.partial(ref_steps.loss_fn, cfg=ref_cfg), has_aux=True))(params, batch=_ref_batch(b))
    total, metrics = steps.loss_fn(model, cfg, _port_batch(b))
    named = dict(model.named_parameters())
    grads = dict(zip(named, torch.autograd.grad(total, list(named.values()))))
    np.testing.assert_allclose(float(total.detach()), float(want), rtol=1e-5)
    np.testing.assert_allclose(float(metrics["z_loss"].detach()), float(want_m["z_loss"]), rtol=1e-5)
    got_g = to_reference_lm_grads(grads, cfg)
    flat_want = jax.tree_util.tree_flatten_with_path(_np(want_g))[0]
    flat_got = jax.tree_util.tree_flatten_with_path(got_g)[0]
    assert [p for p, _ in flat_got] == [p for p, _ in flat_want]
    for (path, g), (_, w) in zip(flat_got, flat_want):
        _leaf_close(g, w, what=jax.tree_util.keystr(path))


def test_remat_full_gives_the_gradients_of_none():
    """remat="full" recomputes every block in the backward (the flash
    forward twice a layer), and "dots" recomputes it from its kept matrix
    products: the same gradients as "none", to float32 rounding of the
    recomputation (1e-6 of max|g|)."""
    _, _, cfg, model = _loss_pair(seed=1)
    b = _port_batch(_batch(4, cfg.vocab_size))
    out = {}
    for remat in ("none", "full", "dots"):
        model.cfg = dataclasses.replace(cfg, remat=remat)
        total, _ = steps.loss_fn(model, model.cfg, b)
        out[remat] = torch.autograd.grad(total, list(model.parameters()))
    for remat in ("full", "dots"):
        for a, w in zip(out[remat], out["none"]):
            assert float((a - w).abs().max()) <= 1e-6 * float(w.abs().max()), remat


def _saved_bytes(model, cfg, batch):
    """Bytes of the tensors autograd saves over one ``loss_fn`` forward."""
    n = [0]

    def pack(t):
        n[0] += t.numel() * t.element_size()
        return t

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        total, _ = steps.loss_fn(model, cfg, batch)
    torch.autograd.grad(total, list(model.parameters()))
    return n[0]


def test_remat_dots_saves_more_than_full_and_less_than_none():
    """Over a forward, "dots" saves each block's input and its matrix
    products' outputs: strictly more bytes than "full" (the input alone) and
    strictly fewer than "none" (every op's saved operands)."""
    _, _, cfg, model = _loss_pair(seed=1)
    b = _port_batch(_batch(4, cfg.vocab_size))
    got = {}
    for remat in ("none", "full", "dots"):
        model.cfg = dataclasses.replace(cfg, remat=remat)
        got[remat] = _saved_bytes(model, model.cfg, b)
    assert got["full"] < got["dots"] < got["none"], got


def test_remat_dots_replay_refuses_a_product_of_other_shapes():
    """The recomputation's products are handed back by position: each is
    checked against the op and operand shapes kept in its place, so a
    recomputation that ran its products in another order fails, and a
    kernel's plain version (flash on the CPU) is one opaque call, neither
    kept nor replayed, as its launch on the card is."""
    from repro_torch.kernels import plain_version
    from repro_torch.models.lm.remat import DotTape

    a, b, c = torch.ones(2, 3), torch.ones(3, 4), torch.ones(3, 5)
    with DotTape() as keep:
        a @ b
        a @ c
        with plain_version():
            a @ b
    kept = keep.kept()
    assert len(kept) == 2
    with DotTape(kept, keep.signatures) as replay:
        assert torch.equal(a @ b, kept[0])
        assert torch.equal(a @ c, kept[1])
    replay.check_replayed()
    with pytest.raises(RuntimeError, match="matrix product 0"):
        with DotTape(kept, keep.signatures):
            a @ c


def test_remat_dots_matches_the_reference():
    """The reference's ``jax.checkpoint(policy=checkpoint_dots)`` against the
    port's kept products: loss and every gradient at the "full" tests'
    tolerance (``_leaf_close``)."""
    ref_cfg, params, cfg, model = _loss_pair(seed=2, remat="dots")
    b = _batch(5, cfg.vocab_size)
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


# ---------------------------------------------------------------------------
# AdamW and train_step
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("clip", [0.05, 1e3], ids=["clipped", "unclipped"])
def test_adamw_update_matches_the_reference(clip):
    rng = np.random.default_rng(2)
    shapes = {"a": (5, 7), "b": (7,), "c": (3, 4, 2)}
    params = {n: (0.1 * rng.standard_normal(s)).astype(np.float32) for n, s in shapes.items()}
    ref_p, ref_s = {n: jnp.asarray(p) for n, p in params.items()}, ref_adamw_init(
        {n: jnp.asarray(p) for n, p in params.items()})
    p = {n: torch.from_numpy(a.copy()) for n, a in params.items()}
    state = adamw_init(p)
    for _ in range(3):
        grads = {n: rng.standard_normal(s).astype(np.float32) for n, s in shapes.items()}
        ref_p, ref_s = ref_adamw_update(ref_p, {n: jnp.asarray(g) for n, g in grads.items()}, ref_s,
                                        lr=1e-2, grad_clip=clip)
        p, state = adamw_update(p, {n: torch.from_numpy(g) for n, g in grads.items()}, state,
                                lr=1e-2, grad_clip=clip)
    assert state.count == int(ref_s.count) == 3
    for n in shapes:
        np.testing.assert_allclose(p[n].numpy(), np.asarray(ref_p[n]), rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(state.mu[n].numpy(), np.asarray(ref_s.mu[n]), rtol=1e-5,
                                   atol=1e-7)
        np.testing.assert_allclose(state.nu[n].numpy(), np.asarray(ref_s.nu[n]), rtol=1e-5,
                                   atol=1e-8)


def test_three_train_steps_match_the_reference():
    ref_cfg, params, cfg, model = _loss_pair(seed=2)
    ref_opt = ref_adamw_init(params)
    opt = adamw_init(dict(model.named_parameters()))
    b = _batch(5, cfg.vocab_size)
    ref_params = jax.tree.map(jnp.asarray, params)
    ref_step = _jit(ref_steps.train_step, cfg=ref_cfg)
    for _ in range(3):  # identical batches
        ref_params, ref_opt, want = ref_step(ref_params, ref_opt, _ref_batch(b))
        model, opt, got = steps.train_step(model, opt, _port_batch(b), cfg)
        np.testing.assert_allclose(float(got["loss"]), float(want["loss"]), rtol=1e-5)
    assert opt.count == 3
    # AdamW divides each gradient by its own RMS, so an entry whose gradient
    # is near zero carries its relative rounding into a move of up to lr:
    # held to a tenth of the three steps' largest move, 0.1·3·lr
    ref = from_reference_lm_tree(_np(ref_params), cfg)
    for name, p in model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), ref[name], rtol=1e-5, atol=0.1 * 3 * 3e-4,
                                   err_msg=name)


def test_init_train_state():
    _, cfg = _cfgs()
    model, opt = steps.init_train_state(torch.Generator().manual_seed(0), cfg, device="cpu")
    names = [n for n, _ in model.named_parameters()]
    assert list(opt.mu) == names and opt.count == 0
    assert all(opt.mu[n].dtype == torch.float32 and not bool(opt.nu[n].any()) for n in names)
    assert all(p.requires_grad for p in model.parameters())


# ---------------------------------------------------------------------------
# EP-MCMC
# ---------------------------------------------------------------------------

CHAINS = 2
KW = dict(num_shards=CHAINS, shard_tokens=float(BATCH * SEQ * 100), step_size=1e-5)


def _state_pair(seed=0):
    ref_cfg, cfg = _cfgs()
    ref_state = ref_epmcmc.init_state(jax.random.PRNGKey(seed), ref_cfg, CHAINS)
    state = from_reference_epmcmc_state(_np(ref_state), cfg, device="cpu")
    return ref_cfg, ref_state, cfg, state


def _compare_states(state, ref_state, cfg, *, move, noisy=False):
    """Chain state against the reference's.

    θ and the running mean: within 10 % of ``move`` (the largest move the
    steps can make) for every entry, within 5 % of it for all. v within
    1e-4 of the leaf's max plus 1e-3 relative; the running Σ(θ − mean)², a
    sum of squared moves, within 1e-2 of its max. pSGLD divides each
    gradient by its own RMS (plus 1e-4), so an entry whose gradient is near
    zero, where float32 sums in other orders differ most in relative terms,
    carries that into its move.

    ``noisy`` (``move`` then by leaf: the largest move the reference made in
    that leaf): the first step's G = 1/(0.1·|g| + 1e-4) of such an entry
    scales a noise of up to √(ε·1e4)·|ξ|, so a handful of entries end as far
    apart as the moves themselves, and every later gradient, hence v and
    the next moves, shift with them. Then in every leaf at most
    ``NOISY_MISSES`` entries may miss each of: θ and the mean within 5 % of
    the leaf's move, √Σ(θ − mean)² (a move too) within 5 % of it, v within
    5 % of the leaf's max. Measured: at most 2 entries a leaf miss; a leaf
    given the other chain's noise, another leaf's, or its own shifted by
    one row has 68–406 entries beyond.
    """
    for key in ("params", "v", "m_mean", "m_var"):
        ref = from_reference_lm_tree(_np(getattr(ref_state, key)), cfg, lead=1)
        for name, t in getattr(state, key).items():
            got, want = t.float().numpy().astype(np.float64), ref[name].astype(np.float64)
            err = np.abs(got - want)
            top = max(float(np.abs(want).max()), 1e-30)
            if noisy:
                if key in ("params", "m_mean"):
                    ok = err <= 0.05 * move[name]
                elif key == "m_var":
                    ok = np.abs(np.sqrt(got) - np.sqrt(want)) <= 0.05 * move[name]
                else:
                    ok = err <= 5e-2 * top
                assert int((~ok).sum()) <= NOISY_MISSES, (key, name, int((~ok).sum()), ok.size)
            elif key in ("params", "m_mean"):
                assert err.max() <= 0.1 * move, (key, name, err.max())
                assert (err <= 0.05 * move).all(), (key, name, err.max())
            else:
                ok = err <= (1e-4 * top + 1e-3 * np.abs(want) if key == "v" else 1e-2 * top)
                assert ok.all(), (key, name, err.max(), top)
    np.testing.assert_array_equal(state.m_count.numpy(), np.asarray(ref_state.m_count))
    assert state.step == int(ref_state.step)


NOISY_MISSES = 10  # entries a leaf; see _compare_states


def _drift_bound(steps):
    """The largest preconditioned-gradient move of ``steps`` steps:
    (ε/2)·|g|/(√v̂ + 1e-4) ≤ (ε/2)/√(1 − decay) a step, since v̂ ≥ (1 − decay)·g²."""
    return steps * 0.5 * KW["step_size"] / np.sqrt(1 - 0.99)


def _ref_noise(ref_state):
    """The normal draws the reference's step takes from each chain's key:
    split(key) → (key, knoise), one key a leaf from knoise, in flatten order."""
    out = []
    for c in range(CHAINS):
        params_c = jax.tree.map(lambda x: x[c], ref_state.params)
        _, knoise = jax.random.split(ref_state.key[c])
        leaves, treedef = jax.tree.flatten(params_c)
        keys = jax.random.split(knoise, len(leaves))
        tree = jax.tree.unflatten(treedef, [jax.random.normal(k, leaf.shape, jnp.float32)
                                            for k, leaf in zip(keys, leaves)])
        out.append(tree)
    return out


@pytest.mark.parametrize("temperature", [0.0, 1.0], ids=["T=0", "T=1 reference noise"])
def test_three_epmcmc_steps_match_the_reference(temperature):
    """At T = 1 the noise √(ε·G)·ξ reaches √(ε/1e-4)·|ξ| ≈ 0.3|ξ| on an
    entry whose gradient is near zero, where G is most sensitive to the
    gradient's rounding: there the bound is the largest move the reference
    made in each leaf, and all but ``NOISY_MISSES`` entries of every leaf
    agree within 5 % of it (see ``_compare_states``). The
    gradient norm is held at the first step, from the shared start; after
    the noise its size follows the entries the noise drove apart."""
    ref_cfg, ref_state, cfg, state = _state_pair()
    init = from_reference_lm_tree(_np(ref_state.params), cfg, lead=1)
    ref_step = _jit(ref_epmcmc.epmcmc_step, cfg=ref_cfg, temperature=temperature, burn_in=1, **KW)
    for step in range(3):
        b = _batch(10 + step, cfg.vocab_size, lead=(CHAINS,))
        noise = None
        if temperature:
            noise = [{n: torch.from_numpy(np.array(a)) for n, a in
                      from_reference_lm_tree(_np(tree), cfg).items()} for tree in _ref_noise(ref_state)]
        ref_state, want = ref_step(ref_state, _ref_batch(b))
        state, got = epmcmc.epmcmc_step(state, _port_batch(b), cfg, temperature=temperature,
                                        burn_in=1, noise=noise, **KW)
        np.testing.assert_allclose(got["loss_per_chain"].numpy(),
                                   np.asarray(want["loss_per_chain"]),
                                   rtol=1e-3 if temperature else 1e-5)
        if step == 0 or not temperature:  # see the docstring
            np.testing.assert_allclose(got["gnorm_per_chain"].numpy(),
                                       np.asarray(want["gnorm_per_chain"]), rtol=1e-4)
    if temperature:
        final = from_reference_lm_tree(_np(ref_state.params), cfg, lead=1)
        move = {n: float(np.abs(final[n] - init[n]).max()) for n in init}
        _compare_states(state, ref_state, cfg, move=move, noisy=True)
    else:
        _compare_states(state, ref_state, cfg, move=_drift_bound(3))


def test_sgd_baseline_steps_match_the_reference():
    ref_cfg, ref_state, cfg, state = _state_pair(seed=1)
    ref_step = _jit(ref_epmcmc.sgd_baseline_step, cfg=ref_cfg, **KW)
    for step in range(2):
        b = _batch(20 + step, cfg.vocab_size, lead=(CHAINS,))
        ref_state, want = ref_step(ref_state, _ref_batch(b))
        state, got = epmcmc.sgd_baseline_step(state, _port_batch(b), cfg, **KW)
        np.testing.assert_allclose(got["loss_per_chain"].numpy(),
                                   np.asarray(want["loss_per_chain"]), rtol=1e-5)
    _compare_states(state, ref_state, cfg, move=_drift_bound(2))


def test_neg_logpost_value_and_gradient_match_the_reference():
    """The steps' −log p_c and its gradient (the likelihood's by autograd,
    the prior's θ/(σ²·M) in closed form) against ``jax.value_and_grad`` of
    the reference's ``_subposterior_neg_logpost`` on chain 1: the value
    within 1e-5 relative, every gradient leaf as ``_leaf_close`` holds it."""
    ref_cfg, ref_state, cfg, state = _state_pair(seed=2)
    model = epmcmc.chain_view(cfg, state.params, 1)
    b = {k: v[1] for k, v in _batch(30, cfg.vocab_size, lead=(CHAINS,)).items()}
    value, grads = epmcmc._neg_logpost_and_grads(model, cfg, _port_batch(b), num_shards=CHAINS,
                                                 shard_tokens=KW["shard_tokens"])
    want, want_g = jax.jit(jax.value_and_grad(functools.partial(
        ref_epmcmc._subposterior_neg_logpost, cfg=ref_cfg, num_shards=CHAINS,
        shard_tokens=KW["shard_tokens"])))(jax.tree.map(lambda x: x[1], ref_state.params),
                                            batch=_ref_batch(b))
    np.testing.assert_allclose(float(value), float(want), rtol=1e-5)
    flat_want = jax.tree_util.tree_flatten_with_path(_np(want_g))[0]
    flat_got = jax.tree_util.tree_flatten_with_path(to_reference_lm_grads(grads, cfg))[0]
    assert [p for p, _ in flat_got] == [p for p, _ in flat_want]
    for (path, g), (_, w) in zip(flat_got, flat_want):
        _leaf_close(g, w, what=jax.tree_util.keystr(path))
    # the view's gradient is chain 1's: the stack's storage is the model's
    assert model.embed.data_ptr() == state.params["embed"][1].data_ptr()


def test_welford_moments_are_the_batch_statistics_of_the_draws():
    _, cfg = _cfgs()
    state = epmcmc.init_state(0, cfg, CHAINS, device="cpu")
    draws = []
    for step in range(6):
        b = _port_batch(_batch(40 + step, cfg.vocab_size, lead=(CHAINS,)))
        state, _ = epmcmc.epmcmc_step(state, b, cfg, burn_in=2, **KW)
        if step >= 2:
            draws.append({n: p.float().clone() for n, p in state.params.items()})
    assert state.m_count.tolist() == [4.0, 4.0]
    for name in ("final_norm.scale", "blocks.1.attn.w_q", "embed"):
        stack = torch.stack([d[name] for d in draws])  # (T, C, ...)
        torch.testing.assert_close(state.m_mean[name], stack.mean(0), rtol=1e-5, atol=1e-6)
        torch.testing.assert_close(state.m_var[name], stack.var(0, unbiased=False) * 4,
                                   rtol=1e-3, atol=1e-9)


def test_combine_and_gather_match_the_reference():
    ref_cfg, ref_state, cfg, _ = _state_pair(seed=3)
    ref_step = _jit(ref_epmcmc.epmcmc_step, cfg=ref_cfg, burn_in=0, **KW)
    for step in range(3):
        b = _batch(50 + step, cfg.vocab_size, lead=(CHAINS,))
        ref_state, _ = ref_step(ref_state, _ref_batch(b))
    state = from_reference_epmcmc_state(_np(ref_state), cfg, device="cpu")
    want = ref_epmcmc.combine_parametric_diag(ref_state)
    got = epmcmc.combine_parametric_diag(state)
    for key in ("mean", "cov"):
        ref = from_reference_lm_tree(_np(getattr(want, key)), cfg)
        for name, t in getattr(got, key).items():
            np.testing.assert_allclose(t.numpy(), ref[name], rtol=1e-5, atol=1e-12, err_msg=name)
    np.testing.assert_array_equal(epmcmc.gather_subset_samples(state.params).numpy(),
                                  np.asarray(ref_epmcmc.gather_subset_samples(ref_state.params)))
    hist = epmcmc.gather_subset_samples(state.params, history=True)
    assert hist.shape == (CHAINS, 1, cfg.d_model)
    window = epmcmc.gather_subset_samples(chunk=[state.params, state.params],
                                          paths=[r"blocks\.0\.ln1"])
    assert window.shape == (CHAINS, 2, cfg.d_model)
    with pytest.raises(ValueError, match="matched no parameters"):
        epmcmc.gather_subset_samples(state.params, paths=["nothing"])


# ---------------------------------------------------------------------------
# token stream, CLIs
# ---------------------------------------------------------------------------


def test_token_stream_is_deterministic_sharded_and_shaped():
    s0 = TokenStream(512, 3, 20, seed=4, shard_index=0, num_shards=2, device="cpu")
    s1 = TokenStream(512, 3, 20, seed=4, shard_index=1, num_shards=2, device="cpu")
    a, b = s0.batch(7), s0.batch(7)
    assert a["tokens"].shape == a["labels"].shape == (3, 20) and a["tokens"].dtype == torch.int64
    assert torch.equal(a["tokens"], b["tokens"]) and torch.equal(a["tokens"][:, 1:], a["labels"][:, :-1])
    assert not torch.equal(a["tokens"], s1.batch(7)["tokens"])
    assert not torch.equal(a["tokens"], s0.batch(8)["tokens"])
    assert int(a["tokens"].min()) >= 0 and int(a["tokens"].max()) < 512


def test_token_stream_marginal_matches_the_reference():
    """The u⁴ marginal: mean, variance and P(token = 0) of 40,000 draws of
    each package within 5 standard errors of each other."""
    vocab = 1000
    port = torch.cat([TokenStream(vocab, 8, 499, seed=1, device="cpu").batch(s)["tokens"].reshape(-1)
                      for s in range(10)]).double().numpy()
    ref = np.concatenate([np.asarray(RefTokenStream(vocab, 8, 499, seed=1).batch(s)["tokens"])
                          .reshape(-1) for s in range(10)]).astype(np.float64)
    for stat in (lambda x: x, lambda x: (x - x.mean()) ** 2, lambda x: (x == 0).astype(float)):
        a, b = stat(port), stat(ref)
        se = np.sqrt(a.var() / a.size + b.var() / b.size)
        assert abs(a.mean() - b.mean()) <= 5 * se
    assert abs(port.mean() - (vocab - 1) / 5) < 0.05 * vocab / 5


BASE = ["--device", "cpu", "--arch", "llama3_2_3b", "--reduced", "--batch", "2", "--seq", "32",
        "--log-every", "100"]


def test_train_cli_adamw_loss_falls():
    out = train.main(BASE + ["--mode", "adamw", "--steps", "12"])
    losses = [float(x) for x in out["losses"]]
    assert len(losses) == 12 and all(np.isfinite(losses))
    assert np.mean(losses[-3:]) < np.mean(losses[:3])


def test_train_cli_epmcmc_resumes_bit_for_bit(tmp_path):
    run = BASE + ["--mode", "epmcmc", "--chains", "2", "--burn-in", "1"]
    full = train.main(run + ["--steps", "4"])["state"]
    train.main(run + ["--steps", "2", "--ckpt-dir", str(tmp_path), "--ckpt-every", "2"])
    resumed = train.main(run + ["--steps", "4", "--ckpt-dir", str(tmp_path), "--ckpt-every", "2",
                                "--resume"])["state"]
    assert resumed.step == full.step == 4
    for key in ("params", "v", "m_mean", "m_var"):
        for name, t in getattr(full, key).items():
            assert torch.equal(t, getattr(resumed, key)[name]), (key, name)
    assert torch.equal(full.m_count, resumed.m_count)
    assert all(torch.equal(a.get_state(), b.get_state()) for a, b in zip(full.gens, resumed.gens))


def test_train_cli_sgd_runs_and_others_raise():
    """sgd runs; the vlm arch trains a reduced step on tokens alone (the
    reference's training CLI feeds no images: ``img_proj`` steps on a zero
    gradient); ``--mesh pod`` raises."""
    out = train.main(BASE + ["--mode", "sgd", "--chains", "2", "--steps", "2"])
    assert len(out["losses"]) == 2 and out["losses"][0].shape == (2,)
    vlm = train.main(["--device", "cpu", "--arch", "llava-next-mistral-7b", "--reduced",
                      "--mode", "adamw", "--steps", "1", "--batch", "2", "--seq", "32"])
    assert len(vlm["losses"]) == 1 and np.isfinite(vlm["loss"])
    model, opt = vlm["state"]
    assert float(opt.mu["img_proj"].abs().max()) == 0.0 and opt.count == 1
    with pytest.raises(RuntimeError, match="256 ranks; found no process group"):
        train.main(BASE + ["--mesh", "pod"])


def test_lm_bayes_sgld_runs_at_its_reduced_default():
    out = lm_bayes_sgld.main(["--device", "cpu", "--steps", "26", "--burn-in", "10"])
    assert out["history"].shape == (4, 16, 128)
    assert out["restored_step"] == 25 and out["restored"].m_count.tolist() == [15.0] * 4
    assert tuple(out["combined"].samples.shape) == (64, 128)
    assert bool(torch.isfinite(out["combined"].samples).all())
    assert all(bool(torch.isfinite(v).all()) for v in out["moments"].cov.values())


def test_reference_leaf_map_covers_every_parameter():
    """The dense model's map and the MoE model's (granite: router and
    experts, stacked (L, E, d, f) in the reference)."""
    moe_cfgs = (ref_reduced(ref_get_config("granite_moe_1b")),
                reduced(get_config("granite_moe_1b")))
    for ref_cfg, cfg in (_cfgs(), moe_cfgs):
        params = _np(ref_mdl.init_params(jax.random.PRNGKey(0), ref_cfg))
        port = from_reference_lm_tree(params, cfg)
        assert list(port) == [n for n, _ in mdl.init_params(cfg, device="meta").named_parameters()]
        back = to_reference_lm_grads({n: torch.from_numpy(np.asarray(a)) for n, a in port.items()},
                                     cfg)
        flat_back = jax.tree_util.tree_flatten_with_path(back)[0]
        flat_ref = jax.tree_util.tree_flatten_with_path(params)[0]
        assert len(flat_back) == len(flat_ref)
        for (p1, a), (p2, b) in zip(flat_back, flat_ref):
            assert p1 == p2
            np.testing.assert_array_equal(a, b)
    assert "blocks.3.moe.experts.w_gate" in port and "blocks.0.moe.router" in port
