"""The port's MoE LM (granite-moe-1b-a400m) on the CPU against ``repro``.

Layer config: ``reduced(get_config("granite_moe_1b"))`` — d 128, 8 experts
top-2, d_ff_expert 64, group 16, capacity factor 4.0 (dropless), float32 —
with the capacity factor cut to 0.5 where the cases want drops. Model
config: the same at 4 layers, 4/2 heads, hd 32, vocab 512, the tied head,
``attn_chunk`` cut so that prefill and training attention take flash.
Shared experts: ``reduced(get_config("deepseek_v2_236b"))``'s MoE settings
(8 experts top-2, one shared expert) on a bare layer, since the rest of
that model needs MLA. The reference's weights (``init_moe``,
``init_params``, the EP-MCMC state) cross through
``repro_torch.interop`` or the same names; inputs are drawn with numpy from
a seed and fed to both.

The reference's dispatch and combine tensors are read off its own
``moe_forward``: ``jnp.einsum`` is wrapped for the call and records the
operands of the dispatch einsum (``dispatch`` cast to the tokens' dtype,
exact at float32) and of the combine einsum. The port's come from
``moe.plan``. Dispatch (which pair holds which slot) must be **equal**;
then, float32: combine, y and aux within 1e-5 of the largest |value| plus
1e-5 relative (matrix products summed in other orders than XLA's), logits
within 1e-4 (four layers of them, as ``test_torch_lm.py``); bf16: a block
at a time (see its test: bf16 routing flips at near-ties), 2^-6 of the
largest |h| where the two route alike, 5e-2 on the head's logits
(``test_torch_lm.py``'s figure).
Gradients, optimizer and sampler steps use ``test_torch_train.py``'s
tolerances and helpers.
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
from repro.models.lm import moe as ref_moe
from repro.models.lm import steps as ref_steps
from repro.models.lm.config import reduced as ref_reduced
from repro.optim.adamw import adamw_init as ref_adamw_init
from repro_torch.configs import get_config
from repro_torch.distributed import epmcmc
from repro_torch.interop import (
    from_reference_epmcmc_state,
    from_reference_lm_params,
    from_reference_lm_tree,
    to_reference_lm_grads,
)
from repro_torch.launch import serve, train
from repro_torch.models.lm import model as mdl
from repro_torch.models.lm import moe as moe_lib
from repro_torch.models.lm import steps
from repro_torch.models.lm.config import reduced
from repro_torch.optim import adamw_init
from test_torch_threads import pin_torch_threads
from test_torch_train import (
    CHAINS,
    KW,
    _batch,
    _compare_states,
    _drift_bound,
    _jit,
    _leaf_close,
    _np,
    _port_batch,
    _ref_batch,
    _ref_noise,
)

pin_torch_threads()  # this worker's share of the cores under a parallel run

ARCH = "granite_moe_1b"
EXPERT_W = ("w_gate", "w_up", "w_down")


def _layer_cfgs(arch=ARCH, dtype="float32", **moe_over):
    ref, port = ref_reduced(ref_get_config(arch)), reduced(get_config(arch))
    if moe_over:
        ref = dataclasses.replace(ref, moe=dataclasses.replace(ref.moe, **moe_over))
        port = dataclasses.replace(port, moe=dataclasses.replace(port.moe, **moe_over))
    if dtype != "float32":
        ref = dataclasses.replace(ref, dtype=dtype, param_dtype=dtype)
        port = dataclasses.replace(port, dtype=dtype, param_dtype=dtype)
    return ref, port


def _port_moe(p, cfg):
    """The port's MoE layer holding the reference's ``init_moe`` weights."""
    moe = moe_lib.MoE(cfg, device="cpu")
    leaves = {"router": p["router"], **{f"experts.{w}": p["experts"][w] for w in EXPERT_W}}
    if "shared" in p:
        leaves.update({f"shared.{w}": p["shared"][w] for w in EXPERT_W})
    dtype = moe.router.dtype
    moe.load_state_dict({n: torch.from_numpy(np.asarray(a, np.float32)).to(dtype)
                         for n, a in leaves.items()})
    return moe


def _layer_pair(arch=ARCH, seed=0, dtype="float32", **moe_over):
    ref_cfg, cfg = _layer_cfgs(arch, dtype, **moe_over)
    p = ref_moe.init_moe(jax.random.PRNGKey(seed), ref_cfg)
    return ref_cfg, p, cfg, _port_moe(p, cfg)


def _x(cfg, b, s, seed=1):
    return (0.5 * np.random.default_rng(seed).standard_normal((b, s, cfg.d_model))).astype(
        np.float32)


def _ref_moe_with_operands(p, cfg, x, monkeypatch):
    """The reference's ``moe_forward`` run eagerly, with the dispatch and
    combine operands of its einsums recorded."""
    seen = {}
    einsum = jnp.einsum

    def recording(spec, *ops, **kw):
        if spec == "gsec,gsd->egcd":
            seen["dispatch"] = np.asarray(ops[0], np.float32)
        elif spec == "gsec,egcd->gsd":
            seen["combine"] = np.asarray(ops[0], np.float32)
        return einsum(spec, *ops, **kw)

    monkeypatch.setattr(jnp, "einsum", recording)
    y, aux = ref_moe.moe_forward(p, cfg, jnp.asarray(x))
    monkeypatch.setattr(jnp, "einsum", einsum)
    return np.asarray(y, np.float32), float(aux), seen


def _close(got, want, tol=1e-5, what=""):
    """|got − want| ≤ tol·max|want| + tol·|want|."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol * max(np.abs(want).max(), 1e-30),
                               err_msg=what)


# ------------------------------------------------------------------ the layer

MOE_CASES = {  # label: (capacity_factor, B, S); group 16, top-2 of 8
    "dropless whole groups": (4.0, 2, 16),
    "dropless padded": (4.0, 3, 7),
    "dropless n < group": (4.0, 2, 1),
    "drops whole groups": (0.5, 2, 24),
    "drops padded": (0.5, 1, 37),
}


@pytest.mark.parametrize("label", list(MOE_CASES))
def test_moe_forward_dispatch_y_and_aux_match_the_reference(label, monkeypatch):
    cf, b, s = MOE_CASES[label]
    ref_cfg, p, cfg, moe = _layer_pair(seed=len(label), capacity_factor=cf)
    x = _x(cfg, b, s, seed=s)
    want_y, want_aux, ref_ops = _ref_moe_with_operands(p, ref_cfg, x, monkeypatch)
    with torch.no_grad():
        plan = moe_lib.plan(moe, torch.from_numpy(x))
        y, aux = moe_lib.moe_forward(moe, torch.from_numpy(x))
    np.testing.assert_array_equal(plan.dispatch.numpy(), ref_ops["dispatch"])
    _close(plan.combine.numpy(), ref_ops["combine"], what="combine")
    _close(y.numpy(), want_y, what="y")
    np.testing.assert_allclose(float(aux), want_aux, rtol=1e-5)
    n, k = b * s, cfg.moe.top_k
    kept = float(plan.dispatch.reshape(-1, cfg.moe.num_experts * plan.dispatch.shape[-1])[:n].sum())
    if cf < 1:  # the cases exist to drop: some (token, slot) pairs are over capacity
        assert kept < n * k
    else:
        assert kept == n * k
    assert plan.top_idx.shape[-1] == k and y.shape == (b, s, cfg.d_model)


@pytest.mark.parametrize("b,s", [(2, 16), (1, 13)], ids=["whole groups", "padded"])
def test_zero_router_ties_go_to_the_lower_expert_and_aux_is_one(b, s, monkeypatch):
    """A zero router ties every expert (probabilities exactly 1/E): the
    port's top-k order is the reference's (experts 0..k−1 in order, as
    ``jax.lax.top_k`` breaks ties), the dispatch equal, and aux exactly 1."""
    ref_cfg, p, cfg, moe = _layer_pair(seed=3, capacity_factor=0.5)
    p = dict(p, router=jnp.zeros_like(p["router"]))
    with torch.no_grad():
        moe.router.zero_()
    x = _x(cfg, b, s, seed=4)
    _, want_aux, ref_ops = _ref_moe_with_operands(p, ref_cfg, x, monkeypatch)
    with torch.no_grad():
        plan = moe_lib.plan(moe, torch.from_numpy(x))
        _, aux = moe_lib.moe_forward(moe, torch.from_numpy(x))
    e, k = cfg.moe.num_experts, cfg.moe.top_k
    _, ref_idx = jax.lax.top_k(jax.nn.softmax(jnp.zeros((e,), jnp.float32)), k)
    assert np.asarray(ref_idx).tolist() == list(range(k))
    assert (plan.top_idx == torch.arange(k)).all()
    np.testing.assert_array_equal(plan.dispatch.numpy(), ref_ops["dispatch"])
    assert float(aux) == want_aux == 1.0


def test_aux_loss_is_constant_as_the_references():
    """ROADMAP Queue 3: the reference's ``ce`` is a scalar, so the aux loss
    is E·Σ me/E = 1 whatever the router, and its gradient rounding only.
    Both packages on a random router: aux within 1e-6 of 1, and the largest
    |∂aux/∂router| under 1e-6 of the largest |∂(Σ y²)/∂router| of the
    same layer (the gradient that routing does carry)."""
    ref_cfg, p, cfg, moe = _layer_pair(seed=10, capacity_factor=1.25)
    x = _x(cfg, 2, 24, seed=11)
    want_aux, want_g = jax.value_and_grad(
        lambda r: ref_moe.moe_forward(dict(p, router=r), ref_cfg, jnp.asarray(x))[1])(p["router"])
    y, aux = moe_lib.moe_forward(moe, torch.from_numpy(x))
    (g_aux,) = torch.autograd.grad(aux, [moe.router], retain_graph=True)
    (g_y,) = torch.autograd.grad(y.square().sum(), [moe.router])
    top = float(g_y.abs().max())
    assert top > 0
    assert abs(float(aux) - 1.0) < 1e-6 and abs(float(want_aux) - 1.0) < 1e-6
    assert float(g_aux.abs().max()) < 1e-6 * top
    assert float(np.abs(np.asarray(want_g)).max()) < 1e-6 * top


def test_top_k_breaks_ties_to_the_lower_index_like_jax():
    rng = np.random.default_rng(5)
    probs = rng.integers(0, 4, size=(64, 32)).astype(np.float32) / 4  # many exact ties
    vals, idx = moe_lib.top_k(torch.from_numpy(probs), 8)
    want_vals, want_idx = jax.lax.top_k(jnp.asarray(probs), 8)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(want_idx))
    np.testing.assert_array_equal(vals.numpy(), np.asarray(want_vals))


def test_moe_forward_gather_matches_the_reference():
    ref_cfg, p, cfg, moe = _layer_pair(seed=6)
    x = _x(cfg, 2, 5, seed=7)
    want, want_aux = ref_moe.moe_forward_gather(p, ref_cfg, jnp.asarray(x))
    with torch.no_grad():
        y, aux = moe_lib.moe_forward_gather(moe, torch.from_numpy(x))
        y_dispatch, _ = moe_lib.moe_forward(moe, torch.from_numpy(x))
    _close(y.numpy(), np.asarray(want), what="y")
    assert float(aux) == float(want_aux) == 0.0
    # dropless (capacity factor 4): dispatch and gather agree, test_moe.py's bound
    np.testing.assert_allclose(y_dispatch.numpy(), y.numpy(), rtol=2e-3, atol=2e-3)


def test_capacity_matches_the_reference_over_a_grid():
    base_ref, base = _layer_cfgs()
    for cf in (0.01, 0.5, 1.0, 1.25, 2.0, 4.0):
        for k, e in ((1, 8), (2, 8), (6, 160), (8, 32)):
            over = dict(capacity_factor=cf, top_k=k, num_experts=e)
            ref_cfg = dataclasses.replace(base_ref, moe=dataclasses.replace(base_ref.moe, **over))
            cfg = dataclasses.replace(base, moe=dataclasses.replace(base.moe, **over))
            for group in (1, 2, 7, 16, 128, 256):
                assert moe_lib._capacity(cfg, group) == ref_moe._capacity(ref_cfg, group), \
                    (cf, k, e, group)
    full = get_config(ARCH)
    assert moe_lib._capacity(full, 128) == 44 and moe_lib._capacity(full, 2) == 4
    assert moe_lib._capacity(dataclasses.replace(
        full, moe=dataclasses.replace(full.moe, capacity_factor=4.0)), 128) == 132


@pytest.mark.parametrize("cf", [4.0, 0.5], ids=["dropless", "drops"])
def test_shared_experts_match_the_reference(cf, monkeypatch):
    ref_cfg, p, cfg, moe = _layer_pair("deepseek_v2_236b", seed=8, capacity_factor=cf)
    assert "shared" in p and moe.shared is not None
    x = _x(cfg, 2, 21, seed=9)
    want_y, want_aux, ref_ops = _ref_moe_with_operands(p, ref_cfg, x, monkeypatch)
    with torch.no_grad():
        plan = moe_lib.plan(moe, torch.from_numpy(x))
        y, aux = moe_lib.moe_forward(moe, torch.from_numpy(x))
        shared = moe.shared(torch.from_numpy(x))
    np.testing.assert_array_equal(plan.dispatch.numpy(), ref_ops["dispatch"])
    _close(y.numpy(), want_y, what="y")
    np.testing.assert_allclose(float(aux), want_aux, rtol=1e-5)
    assert float(shared.abs().max()) > 0  # the shared path is on


def test_moe_init_scales_and_seeding():
    _, cfg = _layer_cfgs("deepseek_v2_236b")
    a = moe_lib.MoE(cfg, generator=torch.Generator().manual_seed(1), device="cpu")
    b = moe_lib.MoE(cfg, generator=torch.Generator().manual_seed(1), device="cpu")
    assert all(torch.equal(x, y) for x, y in zip(a.state_dict().values(), b.state_dict().values()))
    m, d = cfg.moe, cfg.d_model
    assert tuple(a.router.shape) == (d, m.num_experts)
    assert tuple(a.experts.w_gate.shape) == (m.num_experts, d, m.d_ff_expert)
    assert tuple(a.experts.w_down.shape) == (m.num_experts, m.d_ff_expert, d)
    assert tuple(a.shared.w_gate.shape) == (d, m.num_shared_experts * m.d_ff_expert)
    # N(0, 1)·d^-½ and ·f^-½: standard deviations within 5 % of the reference's scales
    for w, fan_in in ((a.router, d), (a.experts.w_up, d), (a.experts.w_down, m.d_ff_expert)):
        assert abs(float(w.std()) * fan_in ** 0.5 - 1.0) < 0.05
    zeros = moe_lib.MoE(cfg, device="cpu")
    assert all(not bool(t.any()) for t in zeros.state_dict().values())


# ------------------------------------------------------------------ the model

PROMPT, GEN, B = 40, 4, 2


def _model_cfgs(dtype="float32", **over):
    ref = ref_reduced(ref_get_config(ARCH), attn_chunk=16, **over)
    port = reduced(get_config(ARCH), attn_chunk=16, **over)
    if dtype != "float32":
        ref = dataclasses.replace(ref, dtype=dtype, param_dtype=dtype)
        port = dataclasses.replace(port, dtype=dtype, param_dtype=dtype)
    return ref, port


def _model_pair(dtype="float32", seed=0, **over):
    ref_cfg, cfg = _model_cfgs(dtype, **over)
    params = ref_mdl.init_params(jax.random.PRNGKey(seed), ref_cfg)
    model = from_reference_lm_params(jax.tree.map(np.asarray, params), cfg, device="cpu")
    return ref_cfg, params, cfg, model


def _tokens(cfg, n, seed=1):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, (B, n))


def test_model_builds_and_maps_every_weight():
    ref_cfg, params, cfg, model = _model_pair()
    assert sum(p.numel() for p in model.parameters()) == cfg.param_count() == ref_cfg.param_count()
    assert all(s == mdl.MOE for s in mdl.layer_specs(cfg))
    sd = model.state_dict()
    np.testing.assert_array_equal(sd["blocks.2.moe.experts.w_up"].numpy(),
                                  np.asarray(params["g0"]["l0"]["moe"]["experts"]["w_up"][2]))
    np.testing.assert_array_equal(sd["blocks.1.moe.router"].numpy(),
                                  np.asarray(params["g0"]["l0"]["moe"]["router"][1]))


@pytest.mark.parametrize("impl", ["dispatch", "gather"])
def test_prefill_and_decode_match_reference_float32(impl):
    ref_cfg, params, cfg, model = _model_pair(seed=1, moe_decode_impl=impl)
    tok = _tokens(cfg, PROMPT + GEN, seed=2)
    want, caches, _ = ref_mdl.prefill(params, ref_cfg, jnp.asarray(tok[:, :PROMPT]), PROMPT + GEN)
    with torch.no_grad():
        got, tc, _ = mdl.prefill(model, torch.from_numpy(tok[:, :PROMPT]), PROMPT + GEN)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-4)
    for i in range(GEN):  # teacher forcing: both fed the same tokens
        pos = PROMPT + i
        want, caches = ref_mdl.decode_step(params, ref_cfg, jnp.asarray(tok[:, pos:pos + 1]),
                                           caches, jnp.asarray(pos, jnp.int32))
        with torch.no_grad():
            got, tc = mdl.decode_step(model, torch.from_numpy(tok[:, pos:pos + 1]), tc, pos)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("cf", [4.0, 0.5], ids=["dropless", "drops"])
def test_forward_and_aux_match_reference_float32(cf):
    over = {}
    if cf != 4.0:
        over["moe"] = dataclasses.replace(reduced(get_config(ARCH)).moe, capacity_factor=cf)
    ref_over = {}
    if cf != 4.0:
        ref_over["moe"] = dataclasses.replace(ref_reduced(ref_get_config(ARCH)).moe,
                                              capacity_factor=cf)
    ref_cfg, cfg = ref_reduced(ref_get_config(ARCH), attn_chunk=16, **ref_over), \
        reduced(get_config(ARCH), attn_chunk=16, **over)
    params = ref_mdl.init_params(jax.random.PRNGKey(3), ref_cfg)
    model = from_reference_lm_params(jax.tree.map(np.asarray, params), cfg, device="cpu")
    tok = _tokens(cfg, PROMPT + 3, seed=4)  # 86 tokens: 5 groups and a padded sixth
    want, want_aux = ref_mdl.forward(params, ref_cfg, jnp.asarray(tok))
    with torch.no_grad():
        got, aux = mdl.forward(model, torch.from_numpy(tok))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(float(aux), float(want_aux), rtol=1e-5)
    assert abs(float(aux) - cfg.num_layers) < 1e-5  # each layer's aux is 1: ROADMAP Queue 3


def test_forward_matches_reference_bfloat16_block_by_block():
    """bf16 routing is chaotic: a one-ulp difference in the attention output
    (flash's sums in another order) moves a router logit by ~1e-2 of itself,
    which flips a top-k choice where the k-th and (k+1)-th probabilities
    nearly tie, and the flipped token then differs by O(1) and spreads
    through attention. So the layers are held one at a time, each fed the
    reference's own input: the router decision on the MoE input alike at
    every position but near-ties (the reference's k-th/(k+1)-th margin under
    1e-2, about three times what one bf16 ulp of the input can move it; at
    most 2 % of positions), and the block's output within 2^-6 of the
    largest |h| (a few bf16 spacings) wherever the two route alike; the
    head on the reference's last h within 5e-2 (``test_torch_lm.py``'s
    bf16 figure), and the aux loss summed over the layers within 1e-5."""
    from repro.models.lm import attention as ref_attn
    from repro.models.lm import layers as ref_layers

    ref_cfg, params, cfg, model = _model_pair("bfloat16", seed=5)
    tok = _tokens(cfg, PROMPT, seed=6)
    spec = ref_mdl.layer_specs(ref_cfg)[0]
    h, pos, _ = ref_mdl._inputs_to_h(params, ref_cfg, jnp.asarray(tok), None)
    tpos = torch.arange(PROMPT).expand(B, PROMPT)
    seen, flips = [], 0
    hook = [blk.ln2.register_forward_hook(lambda m, a, o: seen.append(o)) for blk in model.blocks]
    for i, block in enumerate(model.blocks):
        lp = jax.tree.map(lambda a, i=i: a[i], params["g0"]["l0"])
        x_in = torch.from_numpy(np.asarray(h, np.float32)).to(torch.bfloat16)
        with torch.no_grad():
            got, _ = block(x_in, tpos)
            _, _, idx = moe_lib.route(block.moe, seen[-1])
        h_mid = h + ref_attn.gqa_forward(lp["attn"], ref_cfg,
                                         ref_layers.rmsnorm(lp["ln1"], h, ref_cfg.norm_eps), pos)
        logits = ref_layers.rmsnorm(lp["ln2"], h_mid, ref_cfg.norm_eps) @ lp["moe"]["router"]
        probs = np.asarray(jax.nn.softmax(logits.astype(jnp.float32), axis=-1))
        _, ref_idx = jax.lax.top_k(jnp.asarray(probs), cfg.moe.top_k)
        h, _ = ref_mdl._block_forward(lp, ref_cfg, spec, h, pos, None)
        same = (np.sort(idx.numpy(), -1) == np.sort(np.asarray(ref_idx), -1)).all(-1)
        top = np.sort(probs, -1)[..., ::-1]
        margin = top[..., cfg.moe.top_k - 1] - top[..., cfg.moe.top_k]
        assert (margin[~same] < 1e-2).all(), (i, margin[~same])
        flips += int((~same).sum())
        want = np.asarray(h, np.float32)
        err = np.abs(got.float().numpy() - want)[same]
        assert err.max() <= 2.0 ** -6 * np.abs(want).max(), (i, err.max())
    for hk in hook:
        hk.remove()
    assert flips <= 0.02 * B * PROMPT * cfg.num_layers, flips
    with torch.no_grad():
        head = model.head(torch.from_numpy(np.asarray(h, np.float32)).to(torch.bfloat16))
    want_head = ref_layers.rmsnorm(params["final_norm"], h, ref_cfg.norm_eps) @ params["embed"].T
    np.testing.assert_allclose(head.float().numpy(), np.asarray(want_head, np.float32),
                               rtol=5e-2, atol=5e-2)
    with torch.no_grad():
        logits, aux = mdl.forward(model, torch.from_numpy(tok))
    _, want_aux = ref_mdl.forward(params, ref_cfg, jnp.asarray(tok))
    assert logits.dtype == torch.bfloat16 and aux.dtype == torch.float32
    np.testing.assert_allclose(float(aux), float(want_aux), rtol=1e-5)


def test_prefill_plus_decode_equals_forward():
    """The port's own invariant (tests/test_model_consistency.py asserts it
    for the reference), dropless at the reduced capacity factor 4: forward
    groups all B·S tokens 16 at a time, decode only the B new ones."""
    _, _, cfg, model = _model_pair(seed=7)
    tok = torch.from_numpy(_tokens(cfg, PROMPT + GEN, seed=8))
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


def test_remat_full_gives_the_loss_aux_and_gradients_of_none():
    _, _, cfg, model = _model_pair(seed=9)
    b = _port_batch(_batch(10, cfg.vocab_size))
    out = {}
    for remat in ("none", "full"):
        model.cfg = dataclasses.replace(cfg, remat=remat)
        total, metrics = steps.loss_fn(model, model.cfg, b)
        out[remat] = (float(metrics["moe_aux"]),
                      torch.autograd.grad(total, list(model.parameters())))
    assert out["full"][0] == out["none"][0]
    for a, w in zip(out["full"][1], out["none"][1]):
        assert float((a - w).abs().max()) <= 1e-6 * float(w.abs().max())


# ------------------------------------------------------------------- training


@pytest.mark.parametrize("cf", [4.0, 1.25], ids=["dropless", "granite's capacity"])
def test_loss_fn_value_and_every_gradient_match_the_reference(cf):
    over = {}
    if cf != 4.0:
        over = {"moe": dataclasses.replace(reduced(get_config(ARCH)).moe, capacity_factor=cf)}
    ref_over = {k: dataclasses.replace(ref_reduced(ref_get_config(ARCH)).moe, capacity_factor=cf)
                for k in over}
    ref_cfg = ref_reduced(ref_get_config(ARCH), attn_chunk=16, **ref_over)
    cfg = reduced(get_config(ARCH), attn_chunk=16, **over)
    params = _np(ref_mdl.init_params(jax.random.PRNGKey(11), ref_cfg))
    model = from_reference_lm_params(params, cfg, device="cpu")
    b = _batch(12, cfg.vocab_size)
    (want, want_m), want_g = jax.jit(jax.value_and_grad(
        functools.partial(ref_steps.loss_fn, cfg=ref_cfg), has_aux=True))(params, batch=_ref_batch(b))
    total, metrics = steps.loss_fn(model, cfg, _port_batch(b))
    named = dict(model.named_parameters())
    grads = dict(zip(named, torch.autograd.grad(total, list(named.values()))))
    np.testing.assert_allclose(float(total.detach()), float(want), rtol=1e-5)
    np.testing.assert_allclose(float(metrics["moe_aux"]), float(want_m["moe_aux"]), rtol=1e-5)
    flat_want = jax.tree_util.tree_flatten_with_path(_np(want_g))[0]
    flat_got = jax.tree_util.tree_flatten_with_path(to_reference_lm_grads(grads, cfg))[0]
    assert [p for p, _ in flat_got] == [p for p, _ in flat_want]
    paths = {jax.tree_util.keystr(p) for p, _ in flat_got}
    assert any("router" in p for p in paths) and any("experts" in p for p in paths)
    for (path, g), (_, w) in zip(flat_got, flat_want):
        _leaf_close(g, w, what=jax.tree_util.keystr(path))


def test_three_train_steps_match_the_reference():
    ref_cfg, cfg = _model_cfgs()
    params = _np(ref_mdl.init_params(jax.random.PRNGKey(13), ref_cfg))
    model = from_reference_lm_params(params, cfg, device="cpu")
    ref_opt, opt = ref_adamw_init(params), adamw_init(dict(model.named_parameters()))
    b = _batch(14, cfg.vocab_size)
    ref_params = jax.tree.map(jnp.asarray, params)
    ref_step = _jit(ref_steps.train_step, cfg=ref_cfg)
    for _ in range(3):  # identical batches
        ref_params, ref_opt, want = ref_step(ref_params, ref_opt, _ref_batch(b))
        model, opt, got = steps.train_step(model, opt, _port_batch(b), cfg)
        np.testing.assert_allclose(float(got["loss"]), float(want["loss"]), rtol=1e-5)
        np.testing.assert_allclose(float(got["moe_aux"]), float(want["moe_aux"]), rtol=1e-5)
    # test_torch_train.py's bound: a tenth of the three steps' largest move
    ref = from_reference_lm_tree(_np(ref_params), cfg)
    for name, p in model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), ref[name], rtol=1e-5, atol=0.1 * 3 * 3e-4,
                                   err_msg=name)


def test_three_epmcmc_steps_match_the_reference():
    """``test_torch_train.py``'s test on the MoE model at T = 0: three steps
    in a row, every leaf of the state held."""
    ref_cfg, cfg = _model_cfgs()
    ref_state = ref_epmcmc.init_state(jax.random.PRNGKey(15), ref_cfg, CHAINS)
    state = from_reference_epmcmc_state(_np(ref_state), cfg, device="cpu")
    ref_step = _jit(ref_epmcmc.epmcmc_step, cfg=ref_cfg, temperature=0.0, burn_in=1, **KW)
    for step in range(3):
        b = _batch(16 + step, cfg.vocab_size, lead=(CHAINS,))
        ref_state, want = ref_step(ref_state, _ref_batch(b))
        state, got = epmcmc.epmcmc_step(state, _port_batch(b), cfg, temperature=0.0, burn_in=1,
                                        **KW)
        np.testing.assert_allclose(got["loss_per_chain"].numpy(),
                                   np.asarray(want["loss_per_chain"]), rtol=1e-5)
        np.testing.assert_allclose(got["gnorm_per_chain"].numpy(),
                                   np.asarray(want["gnorm_per_chain"]), rtol=1e-4)
    _compare_states(state, ref_state, cfg, move=_drift_bound(3))


def test_three_epmcmc_steps_on_the_reference_noise_match_the_reference():
    """Three T = 1 steps, each fed the noise the reference draws from each
    chain's key, each from the reference's state of that step (carried over
    by ``from_reference_epmcmc_state``), held by ``_compare_states``' noisy
    rule (at most ``NOISY_MISSES`` entries a leaf beyond 5 % of the leaf's
    move in that step). Not three steps in a row, as the dense model's test
    runs them: pSGLD's noise √(ε·G)·ξ reaches ~0.3|ξ| on an entry whose
    gradient is near zero, where G follows the gradient's rounding, so after
    one noisy step a few entries stand as far apart as the moves themselves,
    and the next step's routing on the same batch differs at 3–15 of a
    layer's 128 tokens (measured with this seed: chain 1's last layer at
    step 1, chain 0's layers 1–3 at step 2). A routing flip is a jump of the loss surface:
    the dense model has none, so its divergence stays at the noisy entries;
    here the gradients of every weight the flipped tokens touch move apart."""
    ref_cfg, cfg = _model_cfgs()
    ref_state = ref_epmcmc.init_state(jax.random.PRNGKey(15), ref_cfg, CHAINS)
    ref_step = _jit(ref_epmcmc.epmcmc_step, cfg=ref_cfg, temperature=1.0, burn_in=1, **KW)
    for step in range(3):
        state = from_reference_epmcmc_state(_np(ref_state), cfg, device="cpu")
        before = from_reference_lm_tree(_np(ref_state.params), cfg, lead=1)
        b = _batch(16 + step, cfg.vocab_size, lead=(CHAINS,))
        noise = [{n: torch.from_numpy(np.array(a)) for n, a in
                  from_reference_lm_tree(_np(tree), cfg).items()} for tree in _ref_noise(ref_state)]
        ref_state, want = ref_step(ref_state, _ref_batch(b))
        state, got = epmcmc.epmcmc_step(state, _port_batch(b), cfg, temperature=1.0, burn_in=1,
                                        noise=noise, **KW)
        np.testing.assert_allclose(got["loss_per_chain"].numpy(),
                                   np.asarray(want["loss_per_chain"]), rtol=1e-5)
        np.testing.assert_allclose(got["gnorm_per_chain"].numpy(),
                                   np.asarray(want["gnorm_per_chain"]), rtol=1e-4)
        after = from_reference_lm_tree(_np(ref_state.params), cfg, lead=1)
        move = {n: float(np.abs(after[n] - before[n]).max()) for n in before}
        _compare_states(state, ref_state, cfg, move=move, noisy=True)


# ----------------------------------------------------------------------- CLIs


def test_serve_cli_runs_on_cpu():
    argv = ["--arch", "granite-moe-1b-a400m", "--reduced", "--device", "cpu", "--prompt-len",
            "40", "--gen", "5", "--seed", "1"]
    out = serve.main(argv)
    cfg = reduced(get_config(ARCH))
    assert out["tokens"].shape == (2, 5)
    assert bool(((out["tokens"] >= 0) & (out["tokens"] < cfg.vocab_size)).all())
    assert torch.equal(out["tokens"], out["logits"].argmax(-1))
    assert torch.equal(serve.main(argv)["tokens"], out["tokens"])


TRAIN = ["--device", "cpu", "--arch", "granite-moe-1b-a400m", "--reduced", "--batch", "2",
         "--seq", "32", "--log-every", "100"]


def test_train_cli_adamw_epmcmc_and_sgd_run_on_cpu():
    losses = [float(x) for x in train.main(TRAIN + ["--mode", "adamw", "--steps", "12"])["losses"]]
    assert len(losses) == 12 and all(np.isfinite(losses))
    assert np.mean(losses[-3:]) < np.mean(losses[:3])
    out = train.main(TRAIN + ["--mode", "epmcmc", "--chains", "2", "--burn-in", "1", "--steps",
                              "3"])
    assert out["state"].m_count.tolist() == [2.0, 2.0]
    assert all(bool(torch.isfinite(t).all()) for t in out["combined"].mean.values())
    assert any(".moe.experts." in n for n in out["combined"].mean)
    out = train.main(TRAIN + ["--mode", "sgd", "--chains", "2", "--steps", "2"])
    assert len(out["losses"]) == 2 and out["losses"][0].shape == (2,)


def test_train_cli_epmcmc_resumes_bit_for_bit(tmp_path):
    run = TRAIN + ["--mode", "epmcmc", "--chains", "2", "--burn-in", "1"]
    full = train.main(run + ["--steps", "4"])["state"]
    train.main(run + ["--steps", "2", "--ckpt-dir", str(tmp_path), "--ckpt-every", "2"])
    resumed = train.main(run + ["--steps", "4", "--ckpt-dir", str(tmp_path), "--ckpt-every", "2",
                                "--resume"])["state"]
    for key in ("params", "v", "m_mean", "m_var"):
        for name, t in getattr(full, key).items():
            assert torch.equal(t, getattr(resumed, key)[name]), (key, name)
    assert torch.equal(full.m_count, resumed.m_count)
