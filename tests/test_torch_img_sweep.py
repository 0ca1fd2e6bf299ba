"""The kernel-mode IMG sweep as one call (``img_sweep``) against repro's.

On the CPU ``img_sweep`` takes its plain version (``img_sweep_ref``), the
port's sweep body; on the card the kernel's sweep route computes the same
function (``tests/test_torch_cuda.py``). Here both packages get the same
carry and repro's own proposals ``c`` and uniforms ``u`` (drawn from the
carry's keys exactly as repro's ``_img_kernel_sweep`` draws them), at B·M = 64
candidates so that repro scores them through its Pallas kernel in interpret
mode, for the w_t and W_t weights and for ragged counts whose rows beyond the
counts hold NaN. The W_t term in the form the card takes (one Cholesky factor,
``ImgWeightModel.state_term``) is held against the batched ``extra_logweight``
the CPU route uses.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.combiners import img as jimg
from repro_torch import kernels
from repro_torch.core.combiners import img as timg
from repro_torch.kernels.img_weights import (
    ImgSweep,
    StateTerm,
    check_sweep_fits,
    img_sweep,
    img_sweep_ref,
    sweep_agreement,
    sweep_smem_bytes,
)
from test_torch_threads import pin_torch_threads

pin_torch_threads()  # this worker's share of the cores under a parallel run

M, T, D, B = 8, 200, 5, 8
H = 0.5


def _draws(seed, ragged):
    """M Gaussian subposteriors as numpy float32, with their counts; ragged
    counts leave NaN in every row beyond them."""
    rng = np.random.default_rng(seed)
    centre = rng.standard_normal(D)
    samples = (centre + 0.15 * rng.standard_normal((M, 1, D))
               + 0.2 * rng.standard_normal((M, T, D))).astype(np.float32)
    counts = np.full((M,), T, np.int32)
    if ragged:
        counts = rng.integers(T // 4, T, size=M).astype(np.int32)
        samples[np.arange(T)[None, :] >= counts[:, None]] = np.nan
    return samples, counts


def _inputs(semiparametric, ragged, seed=3):
    """Both packages' models, repro's carry and its own c and u. repro's
    moments multiply the mask into the rows, so its model is built on the
    draws with NaN set to 0 (the same masked moments); its sweep gets the
    draws with NaN."""
    samples, counts = _draws(seed, ragged)
    js, jc = jnp.asarray(samples), jnp.asarray(counts)
    filled = jnp.asarray(np.nan_to_num(samples, nan=0.0))
    jmodel = (jimg.semiparametric_model(filled, jc) if semiparametric
              else jimg.nonparametric_model(filled))
    keys = jax.random.split(jax.random.PRNGKey(seed), B)
    carry = jax.vmap(lambda k: jimg._init_img_carry(k, js, jc, jmodel.aux))(keys)
    ks = jax.vmap(lambda k: jax.random.split(k, 3))(carry.key)
    c = jax.vmap(lambda k: jax.random.randint(k, (M,), 0, jc))(ks[:, 1])
    u = jax.vmap(lambda k: jax.random.uniform(k, (M,)))(ks[:, 2])
    ts, tc = torch.from_numpy(samples), torch.from_numpy(counts)
    tmodel = timg.semiparametric_model(ts, tc) if semiparametric else timg.nonparametric_model(ts)
    tcarry = timg._ImgCarry(
        t_idx=torch.from_numpy(np.array(carry.t_idx)).long(),
        theta_sel=torch.from_numpy(np.array(carry.theta_sel)),
        mean=torch.from_numpy(np.array(carry.mean)),
        sumsq=torch.from_numpy(np.array(carry.sumsq)),
        extra=torch.from_numpy(np.array(carry.extra, np.float32)).reshape(B),
        n_accept=torch.from_numpy(np.array(carry.n_accept, np.float32)),
    )
    tc_, tu = torch.from_numpy(np.array(c)).long(), torch.from_numpy(np.array(u))
    return (js, jc, jmodel, carry), (ts, tmodel, tcarry, tc_, tu)


@pytest.mark.parametrize("ragged", [False, True], ids=["full", "ragged"])
@pytest.mark.parametrize("semiparametric", [False, True], ids=["w_t", "W_t"])
def test_img_sweep_matches_reference_sweep(semiparametric, ragged):
    """Same carry, c and u: the same accepted set (t_idx and n_accept exact),
    the mean within 1e-5 (float32 sums in another order on values ~1), sumsq
    rtol 1e-5, the W_t per-sample sum (~1e1) rtol 1e-4; NaN rows beyond the
    counts never reach a result."""
    (js, jc, jmodel, jcarry), (ts, tmodel, tcarry, c, u) = _inputs(semiparametric, ragged)
    h = jnp.asarray(H, jnp.float32)
    j_extra = jmodel.extra_logweight(h) if semiparametric else None
    jout = jax.jit(lambda *a: jimg._img_kernel_sweep(*a, j_extra))(jcarry, js, jc, h, jmodel.aux)
    extra_lw = tmodel.extra_logweight(torch.full((B,), H)) if semiparametric else None
    kernels.reset_launches()
    out = img_sweep(tcarry, ts, c, u, torch.tensor(H), aux=tmodel.aux, extra_lw=extra_lw)
    assert kernels.launch_counts()["img_log_weights"] == 0  # the plain version, no launch
    assert isinstance(out, ImgSweep)
    accepted = np.asarray(jout.t_idx) != np.asarray(jcarry.t_idx)
    assert 0 < accepted.sum() < accepted.size  # both branches are exercised
    np.testing.assert_array_equal(out.t_idx.numpy(), np.asarray(jout.t_idx))
    np.testing.assert_array_equal(out.n_accept.numpy(), np.asarray(jout.n_accept))
    np.testing.assert_allclose(out.mean.numpy(), np.asarray(jout.mean), atol=1e-5)
    np.testing.assert_allclose(out.sumsq.numpy(), np.asarray(jout.sumsq), rtol=1e-5)
    np.testing.assert_allclose(out.extra.numpy(), np.asarray(jout.extra).reshape(B), rtol=1e-4)
    np.testing.assert_array_equal(out.theta_sel.numpy(), np.asarray(jout.theta_sel))
    for x in out:
        assert bool(torch.isfinite(x.float()).all())
    assert torch.equal(out.t_idx, torch.where(out.accept, c, tcarry.t_idx))


def _state_term_logweight(term, mean, extra):
    """The W_t state term plus the per-sample sum from one factor, in the
    plain version's arithmetic: −(|L⁻¹(θ̄ − μ̂_M)|² + logdet + d·log 2π)/2 + Σ aux."""
    sol = torch.linalg.solve_triangular(term.chol, (mean - term.mean).unsqueeze(-1),
                                        upper=False)[..., 0]
    d = mean.shape[-1]
    return -0.5 * ((sol**2).sum(dim=-1) + term.logdet + d * np.log(2.0 * np.pi)) + extra


@pytest.mark.parametrize("h", [0.3, 0.9])
@pytest.mark.parametrize("ragged", [False, True], ids=["full", "ragged"])
def test_state_term_matches_extra_logweight(ragged, h):
    """The factor the card takes, ``(L, logdet, μ̂_M)`` at one h, against the
    CPU route's batched ``extra_logweight`` at B copies of that h, on the same
    means and per-sample sums: one Cholesky factor of the same matrix and
    one solve each, so the two differ by float32 rounding of terms of size
    ~1e1 to 1e2 (rtol 1e-5)."""
    samples, counts = _draws(5, ragged)
    ts, tc = torch.from_numpy(samples), torch.from_numpy(counts)
    model = timg.semiparametric_model(ts, tc)
    rng = np.random.default_rng(6)
    mean = torch.from_numpy((model.moments.mean.numpy()
                             + 0.1 * rng.standard_normal((B, D))).astype(np.float32))
    extra = torch.from_numpy((-10.0 * rng.random(B)).astype(np.float32))
    term = model.state_term(torch.tensor(h))
    assert isinstance(term, StateTerm) and term.chol.shape == (D, D)
    assert torch.equal(term.mean, model.moments.mean)
    want = model.extra_logweight(torch.full((B,), h))(mean, extra)
    np.testing.assert_allclose(_state_term_logweight(term, mean, extra).numpy(), want.numpy(),
                               rtol=1e-5)
    assert timg.nonparametric_model(ts).state_term is None
    assert timg.semiparametric_model(ts, tc, nonparametric_weights=True).state_term is None


def test_engine_sweep_is_the_plain_sweep_on_the_cpu():
    """``_img_kernel_sweep`` on CPU tensors: the plain sweep's bits, its draws
    from the generator in the engine's order (c, then u), no launch."""
    _, (ts, tmodel, tcarry, _, _) = _inputs(True, True)
    counts = torch.from_numpy(_draws(3, True)[1])
    h = torch.tensor(H)
    extra_lw = tmodel.extra_logweight(h.expand(B))
    kernels.reset_launches()
    got = timg._img_kernel_sweep(tcarry, ts, counts, h, tmodel.aux, extra_lw,
                                 gen=torch.Generator().manual_seed(4))
    gen = torch.Generator().manual_seed(4)
    c = timg._randint_below(gen, (B, M), counts)
    u = torch.rand((B, M), generator=gen)
    want = img_sweep_ref(tcarry, ts, c, u, h, tmodel.aux, extra_lw)
    assert isinstance(got, timg._ImgCarry)
    for a, b in zip(got, want[:6]):
        assert torch.equal(a, b)
    assert kernels.launch_counts()["img_log_weights"] == 0


def test_img_sweep_checks_shapes_and_dtypes():
    _, (ts, tmodel, tcarry, c, u) = _inputs(True, False)
    h = torch.tensor(H)
    with pytest.raises(ValueError, match="theta_sel"):
        img_sweep(tcarry._replace(theta_sel=tcarry.theta_sel[:, :-1]), ts, c, u, h)
    with pytest.raises(ValueError, match="u is"):
        img_sweep(tcarry, ts, c, u[:, :-1], h)
    with pytest.raises(ValueError, match="aux"):
        img_sweep(tcarry, ts, c, u, h, aux=tmodel.aux[:, :-1])
    with pytest.raises(ValueError, match="samples"):
        img_sweep(tcarry, ts[0], c, u, h)
    with pytest.raises(TypeError, match="c must be int64"):
        img_sweep(tcarry, ts, c.int(), u, h)
    with pytest.raises(TypeError, match="t_idx must be int64"):
        img_sweep(tcarry._replace(t_idx=tcarry.t_idx.int()), ts, c, u, h)
    term = tmodel.state_term(h)
    with pytest.raises(ValueError, match="chol"):
        img_sweep(tcarry, ts, c, u, h, aux=tmodel.aux, state_term=term._replace(chol=term.chol[1:]))
    with pytest.raises(ValueError, match="extra_lw"):  # the card's form, on the CPU
        img_sweep(tcarry, ts, c, u, h, aux=tmodel.aux, state_term=term)


def test_sweep_shared_memory_limit():
    """One block holds a chain: 2·M·d floats, the mean, the Gram and seven
    per-site vectors, and for W_t the factor and its diagonal's reciprocals,
    M + 1 solves, their Gram and one more per-site vector."""
    assert sweep_smem_bytes(10, 50, False) == 4 * (2 * 10 * 50 + 50 + 100 + 70)
    assert sweep_smem_bytes(10, 50, True) == sweep_smem_bytes(10, 50, False) + 4 * (
        2500 + 50 + 550 + 121 + 10)
    check_sweep_fits(10, 50, True)  # the path's shape fits
    check_sweep_fits(1, 1, False)
    with pytest.raises(ValueError, match="shared memory"):
        check_sweep_fits(10, 300, True)  # the factor alone is 360 KB
    with pytest.raises(ValueError, match="shared memory"):
        check_sweep_fits(100, 300, False)  # 2·M·d floats are 240 KB


def test_sweep_agreement_rule():
    """The rule the card holds the sweep route to: a sweep agrees with itself;
    a flag flipped at a clear site is a fault, one flipped inside the margin
    parts its chain, which then leaves the carry check."""
    _, (ts, tmodel, tcarry, c, u) = _inputs(False, False)
    want = img_sweep(tcarry, ts, c, u, torch.tensor(H))
    report = sweep_agreement(want, want, u)
    assert report["ok"] and report["flag_faults"] == report["diverged_chains"] == 0
    assert report["sites"] == B * M and 0 < report["accepted"] < B * M
    margin = (torch.log(u) - want.log_ratio).abs()
    b, m = divmod(int(margin.argmax()), M)  # the clearest site
    flipped = want.accept.clone()
    flipped[b, m] = ~flipped[b, m]
    assert sweep_agreement(want._replace(accept=flipped), want, u)["flag_faults"] == 1
    near = want._replace(log_ratio=want.log_ratio.clone())
    near.log_ratio[b, m] = torch.log(u[b, m])  # now inside the margin
    report = sweep_agreement(want._replace(accept=flipped), near, u)
    assert report["ok"] and report["diverged_chains"] == 1 and report["inside_margin"] >= 1
    moved = want._replace(mean=want.mean + 1e-3)
    assert sweep_agreement(moved, want, u)["carry_faults"] == 1
