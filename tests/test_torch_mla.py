"""The port's MLA (DeepSeek-V2's multi-head latent attention) on the CPU against ``repro``.

Config: ``reduced(get_config("deepseek_v2_236b"))`` — 4 layers (layer 0
dense, 1–3 MoE), d 128, 4 heads, q_lora 48, kv_lora 32, nope 32 / rope 16 /
v 32, 8 experts top-2 and 1 shared, capacity factor 4 (dropless), vocab
512, float32 — with ``attn_chunk`` cut below the sequence where the flash
path is wanted (the reference then runs its pure-JAX flash, the port its
plain ``ref.py``), and ``q_lora_rank`` set to 0 for the full-rank q
projection. The reference's weights (``init_mla``, ``init_params``) cross
through ``repro_torch.interop.from_reference_lm_params`` or by name;
inputs are drawn with numpy from a seed and fed to both.

Tolerances: float32 layers 1e-4 (matrix products of ≤ 128 terms and a
softmax, summed in other orders than XLA's); logits 1e-4, bf16 5e-2
(``test_torch_lm.py``'s figures); the absorbed decode against the port's
own expanded forward 2e-3 (the reference's ``tests/test_model_consistency.py``
bound: the absorbed form sums the scores as q·W_ukᵀ·c_kv, another order);
gradients leaf by leaf as ``test_torch_train.py`` holds the dense and MoE
families (1e-4 of each leaf's max|g| plus 1e-4 relative); the flash
backward's plain version 3e-4 (``test_torch_flash_bwd.py``'s).
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.models.lm import attention as ref_attn
from repro.models.lm import model as ref_mdl
from repro.models.lm import steps as ref_steps
from repro.models.lm.config import reduced as ref_reduced
from repro.models.lm.flash import _flash_bwd as ref_flash_bwd
from repro_torch.configs import get_config
from repro_torch.interop import (
    from_reference_lm_params,
    from_reference_lm_tree,
    reference_lm_leaves,
    to_reference_lm_grads,
)
from repro_torch.kernels.flash_attention import flash_attention_bwd_ref
from repro_torch.launch import serve
from repro_torch.models.lm import attention as attn
from repro_torch.models.lm import model as mdl
from repro_torch.models.lm import steps
from repro_torch.models.lm.config import reduced
from test_torch_threads import pin_torch_threads
from test_torch_train import _batch, _leaf_close, _np, _port_batch, _ref_batch

pin_torch_threads()  # this worker's share of the cores under a parallel run

ARCH = "deepseek_v2_236b"
PROMPT, GEN, B = 80, 4, 2
MLA_W = ("w_dq", "q_norm", "w_uq", "w_q", "w_dkv", "kv_norm", "w_uk", "w_uv", "w_o")


def _cfgs(dtype="float32", q_lora=None, **over):
    ref, port = ref_reduced(ref_get_config(ARCH), **over), reduced(get_config(ARCH), **over)
    if q_lora is not None:
        ref = dataclasses.replace(ref, mla=dataclasses.replace(ref.mla, q_lora_rank=q_lora))
        port = dataclasses.replace(port, mla=dataclasses.replace(port.mla, q_lora_rank=q_lora))
    if dtype != "float32":
        ref = dataclasses.replace(ref, dtype=dtype, param_dtype=dtype)
        port = dataclasses.replace(port, dtype=dtype, param_dtype=dtype)
    return ref, port


def _model_pair(dtype="float32", seed=0, q_lora=None, attn_chunk=32):
    """(ref cfg, ref params, port cfg, port model with the same weights)."""
    ref_cfg, cfg = _cfgs(dtype, q_lora, attn_chunk=attn_chunk)
    params = ref_mdl.init_params(jax.random.PRNGKey(seed), ref_cfg)
    model = from_reference_lm_params(jax.tree.map(np.asarray, params), cfg, device="cpu")
    return ref_cfg, params, cfg, model


def _layer_pair(q_lora, attn_chunk, seed=0):
    """One MLA layer: (ref cfg, ``init_mla`` params, port cfg, port ``MLA``)."""
    ref_cfg, cfg = _cfgs(q_lora=q_lora, attn_chunk=attn_chunk)
    p = ref_attn.init_mla(jax.random.PRNGKey(seed), ref_cfg)
    layer = attn.MLA(cfg, device="cpu")
    layer.load_state_dict({n: torch.tensor(np.asarray(a, np.float32)) for n, a in p.items()})
    return ref_cfg, p, cfg, layer


def _tokens(cfg, n, seed=1):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, (B, n))


def _f32(x):
    return np.asarray(jnp.asarray(x, jnp.float32))


# ------------------------------------------------------------------ the layer


@pytest.mark.parametrize("path,attn_chunk", [("einsum", 64), ("flash", 16)])
@pytest.mark.parametrize("q_lora", [48, 0], ids=["q_lora 48", "full-rank q"])
def test_mla_q_latents_and_forward_match_reference(path, attn_chunk, q_lora):
    """S = 40: at attn_chunk 16 both take flash (ragged: 40 = 2·16 + 8), at
    64 the einsum path. The layer's weights are ``init_mla``'s exactly: w_dq,
    q_norm and w_uq (or w_q), w_dkv, kv_norm, w_uk, w_uv, w_o."""
    ref_cfg, p, cfg, layer = _layer_pair(q_lora, attn_chunk)
    assert set(dict(layer.named_parameters())) == set(p) <= set(MLA_W)
    rng = np.random.default_rng(q_lora + attn_chunk)
    x = rng.standard_normal((B, 40, cfg.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(40) + 3, (B, 40)).copy()
    xt, post = torch.from_numpy(x), torch.from_numpy(pos)
    xj, posj = jnp.asarray(x), jnp.asarray(pos)
    with torch.no_grad():
        q_nope, q_rope = attn._mla_q(layer, xt, post)
        c_kv, k_rope = attn._mla_latents(layer, xt, post)
        out = layer(xt, post)
    want_q = ref_attn._mla_q(p, ref_cfg, xj, posj)
    want_l = ref_attn._mla_latents(p, ref_cfg, xj, posj)
    for got, want in zip((q_nope, q_rope, c_kv, k_rope), (*want_q, *want_l)):
        assert tuple(got.shape) == tuple(want.shape)
        np.testing.assert_allclose(got.numpy(), _f32(want), rtol=1e-4, atol=1e-4)
    want = ref_attn.mla_forward(p, ref_cfg, xj, posj)
    assert tuple(out.shape) == (B, 40, cfg.d_model)
    np.testing.assert_allclose(out.numpy(), _f32(want), rtol=1e-4, atol=1e-4)


def test_mla_forward_sends_a_contiguous_k_full_to_flash_at_mlas_head_dims(monkeypatch):
    """The expanded form reaches flash at K = H, G = 1, hd = nope + rope and
    hd_v = v, with q, k (k_rope written into every head: no stride-0 axis)
    and v contiguous, so a bf16 call takes the tensor-core routes on the card."""
    _, _, cfg, layer = _layer_pair(48, 16)
    m, seen = cfg.mla, {}
    real = attn.flash_attention

    def spy(q, k, v, *args):
        seen.update(q=q, k=k, v=v)
        return real(q, k, v, *args)

    monkeypatch.setattr(attn, "flash_attention", spy)
    with torch.no_grad():
        layer(torch.randn(B, 40, cfg.d_model), torch.arange(40).expand(B, 40))
    h, qk = cfg.num_heads, m.nope_head_dim + m.rope_head_dim
    assert tuple(seen["q"].shape) == (B, 40, h, 1, qk)
    assert tuple(seen["k"].shape) == (B, 40, h, qk)
    assert tuple(seen["v"].shape) == (B, 40, h, m.v_head_dim)
    assert all(seen[n].is_contiguous() and 0 not in seen[n].stride() for n in "qkv")
    k_rope = seen["k"][..., m.nope_head_dim:]
    assert torch.equal(k_rope, k_rope[:, :, :1].expand_as(k_rope))  # one k_rope, every head


# ------------------------------------------------------------------ the model


def test_model_builds_and_maps_every_weight():
    ref_cfg, params, cfg, model = _model_pair()
    assert sum(p.numel() for p in model.parameters()) == cfg.param_count() == ref_cfg.param_count()
    assert [s.mixer for s in mdl.layer_specs(cfg)] == ["mla"] * 4
    assert [s.ffn for s in mdl.layer_specs(cfg)] == ["mlp", "moe", "moe", "moe"]
    assert isinstance(model.blocks[0].attn, attn.MLA) and hasattr(model.blocks[0], "mlp")
    sd = model.state_dict()
    np.testing.assert_array_equal(sd["blocks.0.attn.w_dq"].numpy(),
                                  np.asarray(params["g0"]["l0"]["attn"]["w_dq"]))
    np.testing.assert_array_equal(sd["blocks.2.attn.w_uk"].numpy(),
                                  np.asarray(params["g1"]["l0"]["attn"]["w_uk"][1]))
    np.testing.assert_array_equal(sd["blocks.3.attn.kv_norm"].numpy(),
                                  np.asarray(params["g1"]["l0"]["attn"]["kv_norm"][2]))


@pytest.mark.parametrize("q_lora", [48, 0], ids=["q_lora 48", "full-rank q"])
def test_reference_leaf_map_covers_every_mla_parameter_once(q_lora):
    ref_cfg, cfg = _cfgs(q_lora=q_lora)
    params = _np(ref_mdl.init_params(jax.random.PRNGKey(0), ref_cfg))
    leaves = reference_lm_leaves(cfg)
    names = [n for n, _, _ in leaves]
    assert names == [n for n, _ in mdl.init_params(cfg, device="meta").named_parameters()]
    assert len(set(names)) == len(names)
    paths = [(path, idx) for _, path, idx in leaves]
    assert len(set(paths)) == len(paths)
    want = ("w_dq", "q_norm", "w_uq") if q_lora else ("w_q",)
    for i in range(cfg.num_layers):
        got = [n.split(".")[-1] for n in names if n.startswith(f"blocks.{i}.attn.")]
        assert got == list(want) + ["w_dkv", "kv_norm", "w_uk", "w_uv", "w_o"]
    back = to_reference_lm_grads({n: torch.from_numpy(np.asarray(a))
                                  for n, a in from_reference_lm_tree(params, cfg).items()}, cfg)
    flat_back = jax.tree_util.tree_flatten_with_path(back)[0]
    flat_ref = jax.tree_util.tree_flatten_with_path(params)[0]
    assert len(flat_back) == len(flat_ref)
    for (p1, a), (p2, b) in zip(flat_back, flat_ref):
        assert p1 == p2
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("q_lora", [48, 0], ids=["q_lora 48", "full-rank q"])
def test_prefill_and_decode_match_reference_float32(q_lora):
    ref_cfg, params, cfg, model = _model_pair(seed=1, q_lora=q_lora)
    tok = _tokens(cfg, PROMPT + GEN, seed=2)
    want, caches, _ = ref_mdl.prefill(params, ref_cfg, jnp.asarray(tok[:, :PROMPT]), PROMPT + GEN)
    with torch.no_grad():
        got, tc, _ = mdl.prefill(model, torch.from_numpy(tok[:, :PROMPT]), PROMPT + GEN)
    m = cfg.mla
    assert tuple(tc[0]["c_kv"].shape) == (B, PROMPT + GEN, m.kv_lora_rank)
    assert tuple(tc[0]["k_rope"].shape) == (B, PROMPT + GEN, m.rope_head_dim)
    np.testing.assert_allclose(got.numpy(), _f32(want), rtol=1e-4, atol=1e-4)
    for i, (g, idx) in enumerate((("g0", None), ("g1", 0), ("g1", 1), ("g1", 2))):
        for key in ("c_kv", "k_rope"):
            ref_leaf = caches[g]["l0"][key]
            ref_leaf = ref_leaf if idx is None else ref_leaf[idx]
            np.testing.assert_allclose(tc[i][key].numpy(), _f32(ref_leaf), rtol=1e-4, atol=1e-4)
            assert not tc[i][key][:, PROMPT:].any()  # zero past the prompt
    for i in range(GEN):  # teacher forcing: both fed the same tokens
        pos = PROMPT + i
        want, caches = ref_mdl.decode_step(params, ref_cfg, jnp.asarray(tok[:, pos:pos + 1]),
                                           caches, jnp.asarray(pos, jnp.int32))
        with torch.no_grad():
            got, tc = mdl.decode_step(model, torch.from_numpy(tok[:, pos:pos + 1]), tc, pos)
        np.testing.assert_allclose(got.numpy(), _f32(want), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(tc[3]["c_kv"].numpy(), _f32(caches["g1"]["l0"]["c_kv"][2]),
                               rtol=1e-4, atol=1e-4)


def test_prefill_and_decode_match_reference_bfloat16():
    """Every layer MLA + MLP (``first_dense`` = 4). With the MoE layers the
    two packages' bf16 logits part by O(1) (0.64 at this seed): a bf16
    router flips its top-k at near-ties on a one-ulp difference of its input
    (``test_torch_moe.py`` holds bf16 MoE blocks one at a time for that
    reason), so the MoE layers would decide this comparison, not MLA.

    The prefill's logits and layer 0's cache within 5e-2. The absorbed
    decode rounds to bf16 at more places than the expanded form (q_eff, the
    latent context, then W_uv): there each package's bf16 logits stand
    0.05–0.07 from the float32 reference's on the same bf16 weights, and
    the two up to 0.094 apart at this seed, so a decode step is held within
    twice the reference's own bf16 error (``chip_smoke.py`` 4d's rule)."""
    def dense(c):
        return dataclasses.replace(c, moe=dataclasses.replace(c.moe, first_dense=4))

    ref_cfg, cfg = (dense(c) for c in _cfgs("bfloat16", attn_chunk=32))
    ref_f32 = dense(_cfgs(attn_chunk=32)[0])
    assert [s.ffn for s in mdl.layer_specs(cfg)] == ["mlp"] * 4
    params = ref_mdl.init_params(jax.random.PRNGKey(3), ref_cfg)
    params_f32 = jax.tree.map(lambda a: jnp.asarray(a, jnp.float32), params)
    model = from_reference_lm_params(jax.tree.map(np.asarray, params), cfg, device="cpu")
    tok = _tokens(cfg, PROMPT + 2, seed=4)
    _, caches_f32, _ = ref_mdl.prefill(params_f32, ref_f32, jnp.asarray(tok[:, :PROMPT]),
                                       PROMPT + 2)
    want, caches, _ = ref_mdl.prefill(params, ref_cfg, jnp.asarray(tok[:, :PROMPT]), PROMPT + 2)
    with torch.no_grad():
        got, tc, _ = mdl.prefill(model, torch.from_numpy(tok[:, :PROMPT]), PROMPT + 2)
    assert got.dtype == torch.bfloat16 and tc[0]["c_kv"].dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), _f32(want), rtol=5e-2, atol=5e-2)
    for key in ("c_kv", "k_rope"):  # layer 0's: the one both compute from the same input
        np.testing.assert_allclose(tc[0][key].float().numpy(), _f32(caches["g0"]["l0"][key][0]),
                                   rtol=5e-2, atol=5e-2)
    for i in range(2):
        pos, step = PROMPT + i, jnp.asarray(tok[:, PROMPT + i:PROMPT + i + 1])
        want, caches = ref_mdl.decode_step(params, ref_cfg, step, caches,
                                           jnp.asarray(pos, jnp.int32))
        exact, caches_f32 = ref_mdl.decode_step(params_f32, ref_f32, step, caches_f32,
                                                jnp.asarray(pos, jnp.int32))
        with torch.no_grad():
            got, tc = mdl.decode_step(model, torch.from_numpy(tok[:, pos:pos + 1]), tc, pos)
        own = float(np.abs(_f32(want) - _f32(exact)).max())  # the reference's bf16 error
        assert 0 < own < 0.2
        assert float(np.abs(got.float().numpy() - _f32(want)).max()) <= 2 * own


def test_absorbed_decode_equals_the_expanded_forward():
    """The port's own invariant (the reference's
    ``tests/test_model_consistency.py``): teacher-forced prefill (expanded,
    flash) + absorbed decode reproduces forward's logits (expanded), dropless
    at the reduced capacity factor 4."""
    _, _, cfg, model = _model_pair(seed=5)
    tok = torch.from_numpy(_tokens(cfg, PROMPT + GEN, seed=6))
    with torch.no_grad():
        full, _ = mdl.forward(model, tok)
        last, caches, _ = mdl.prefill(model, tok[:, :PROMPT], PROMPT + GEN)
        got = [last[:, 0]]
        for i in range(GEN - 1):
            logits, caches = mdl.decode_step(model, tok[:, PROMPT + i:PROMPT + i + 1], caches,
                                             PROMPT + i)
            got.append(logits[:, 0])
    torch.testing.assert_close(torch.stack(got, 1), full[:, PROMPT - 1:PROMPT + GEN - 1],
                               rtol=2e-3, atol=2e-3)


def test_init_caches_are_latent_for_mla_layers():
    cfg = reduced(get_config(ARCH))
    caches = mdl.init_caches(cfg, 2, 8, torch.float32, device="cpu")
    assert len(caches) == cfg.num_layers
    assert all(set(c) == {"c_kv", "k_rope"} for c in caches)
    assert tuple(caches[1]["c_kv"].shape) == (2, 8, cfg.mla.kv_lora_rank)


# ------------------------------------------------------------------- training


@pytest.mark.parametrize("q_lora,remat", [(48, "none"), (0, "none"), (48, "dots")],
                         ids=["q_lora 48", "full-rank q", "q_lora 48, remat dots"])
def test_loss_fn_value_and_every_gradient_match_the_reference(q_lora, remat):
    """Sequence 64 against attn_chunk 16: every layer's attention through
    flash and its backward through the flash backward's plain version; under
    remat dots the projections kept and flash recomputed, against the
    reference's ``checkpoint_dots``."""
    ref_cfg, cfg = _cfgs(q_lora=q_lora, attn_chunk=16, remat=remat)
    params = _np(ref_mdl.init_params(jax.random.PRNGKey(7), ref_cfg))
    model = from_reference_lm_params(params, cfg, device="cpu")
    b = _batch(8, cfg.vocab_size)
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
    want_w = ("w_dq", "q_norm", "w_uq") if q_lora else ("w_q",)
    for w in want_w + ("w_dkv", "kv_norm", "w_uk", "w_uv", "w_o"):
        assert any(f"['attn']['{w}']" in p for p in paths), w
    for (path, g), (_, w) in zip(flat_got, flat_want):
        _leaf_close(g, w, what=jax.tree_util.keystr(path))


# ------------------------------------------------------ the flash backward


@pytest.mark.parametrize("causal", [True, False])
def test_plain_flash_backward_at_mlas_head_dims_matches_reference(causal):
    """hd 192 (nope 128 ⊕ rope 64), hd_v 128, K = H = 4, G = 1, S = T = 40
    against chunks of 16: ``flash_attention_bwd_ref`` against the
    reference's ``_flash_bwd`` on the same q, k, v, out, lse and dout, all
    from numpy (lse and out the float64 softmax's)."""
    rng = np.random.default_rng(11 + causal)
    s, kh, hd, hd_v = 40, 4, 192, 128
    q = rng.standard_normal((1, s, kh, 1, hd)).astype(np.float32)
    k = rng.standard_normal((1, s, kh, hd)).astype(np.float32)
    v = rng.standard_normal((1, s, kh, hd_v)).astype(np.float32)
    dout = rng.standard_normal((1, s, kh, 1, hd_v)).astype(np.float32)
    scores = np.einsum("bskgd,btkd->bkgst", q.astype(np.float64), k.astype(np.float64)) * hd ** -0.5
    if causal:
        scores = np.where(np.tril(np.ones((s, s), bool)), scores, -np.inf)
    lse64 = np.log(np.exp(scores - scores.max(-1, keepdims=True)).sum(-1)) + scores.max(-1)
    p = np.exp(scores - lse64[..., None])
    out = np.einsum("bkgst,btkd->bskgd", p, v.astype(np.float64)).astype(np.float32)
    lse = lse64.transpose(0, 3, 1, 2).astype(np.float32)  # (B, S, K, G)
    got = flash_attention_bwd_ref(*(torch.from_numpy(a) for a in (q, k, v, out, lse, dout)),
                                  causal=causal)
    want = ref_flash_bwd(causal, 16, 16, tuple(jnp.asarray(a) for a in (q, k, v, out, lse)),
                         jnp.asarray(dout))
    for name, a, w in zip(("dq", "dk", "dv"), got, want):
        assert tuple(a.shape) == tuple(w.shape), name
        np.testing.assert_allclose(a.numpy(), np.asarray(w), rtol=3e-4, atol=3e-4, err_msg=name)


# ------------------------------------------------------------------- the CLIs


def test_serve_cli_runs_on_cpu_with_its_depth_cut():
    out = serve.main(["--arch", "deepseek-v2-236b", "--reduced", "--device", "cpu",
                      "--layers", "2", "--prompt-len", "40", "--gen", "3"])
    assert tuple(out["tokens"].shape) == (2, 3)
    assert bool(torch.isfinite(out["logits"]).all())
