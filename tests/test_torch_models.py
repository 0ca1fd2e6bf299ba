"""The paper's other models against repro: linear-Gaussian, Poisson–gamma, GMM.

Every dataset is generated by ``repro`` and carried across as numpy. The
port's log-densities are batched over M chains on stacked, edge-padded
shards; the reference's are the per-shard ``make_subposterior_logpdf`` with
``count=``. The Gibbs conditionals are held to ``repro``'s on the same state:
the linear block move on the same normal (its mean and covariance against
float64 too), the Poisson q and b conditionals' shapes and rates (the gamma
draw replaced by a recorder in both packages), and the a-block's MH decisions
on the reference's own proposal normal and uniform.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.subposterior import make_subposterior_logpdf as jax_subpost
from repro.core.subposterior import partition_data as jax_partition
from repro.models.bayes import available_models as jax_available_models
from repro.models.bayes import canonical_models as jax_canonical_models
from repro.models.bayes import get_model as jax_get_model
from repro.models.bayes import gmm as jgmm
from repro.models.bayes import linear_gaussian as jlin
from repro.models.bayes import poisson_gamma as jpg
from repro_torch.core.subposterior import make_subposterior_logpdf, partition_data
from repro_torch.interop import from_reference_data
from repro_torch.models.bayes import available_models, canonical_models, get_model
from repro_torch.models.bayes import gmm as tgmm
from repro_torch.models.bayes import linear_gaussian as tlin
from repro_torch.models.bayes import poisson_gamma as tpg
from repro_torch.samplers import randgamma
from test_torch_threads import pin_torch_threads

pin_torch_threads()  # this worker's share of the cores under a parallel run


def _reference(model, n, seed=0):
    data, theta = jax_get_model(model).generate_data(jax.random.PRNGKey(seed), n)
    return {k: np.asarray(v) for k, v in data.items()}, np.asarray(theta)


def test_registry_matches_reference():
    assert available_models() == jax_available_models()
    assert canonical_models() == jax_canonical_models()
    for name in canonical_models():
        t, j = get_model(name), jax_get_model(name)
        assert (t.d, t.default_n, t.default_sampler, t.shard_keys, t.has_gibbs,
                t.gibbs_counts) == (j.d, j.default_n, j.default_sampler, j.shard_keys,
                                    j.has_gibbs, j.gibbs_counts), name


# log-likelihoods sum up to 1,500 rows of size ~1–10 in float32 in another
# order: rtol 2e-5, atol 5e-3 on totals of size ~1e3–1e4
@pytest.mark.parametrize("name,n,M", [("linear", 1501, 4), ("poisson", 1501, 4), ("gmm", 1501, 4),
                                      ("linear", 1200, 3)])
def test_subposterior_logpdf_batched_over_padded_shards(name, n, M):
    jm, tm = jax_get_model(name), get_model(name)
    data, theta_true = _reference(name, n)
    rng = np.random.default_rng(n)
    thetas = (theta_true.reshape(-1) + 0.1 * rng.standard_normal((M, tm.d))).astype(np.float32)
    jshards, jcounts = jax_partition({k: jnp.asarray(v) for k, v in data.items()}, M,
                                     only=jm.shard_keys, pad=True)
    want = []
    for m in range(M):
        shard = {k: (v[m] if jm.shard_keys is None or k in jm.shard_keys else v)
                 for k, v in jshards.items()}
        lp = jax_subpost(jm.log_prior, jm.log_lik, shard, M, count=jcounts[m],
                         per_datum=jm.shard_keys)
        want.append(float(lp(jnp.asarray(thetas[m]))))
    tdata, _ = from_reference_data(data, theta_true, device="cpu")
    shards, counts = partition_data(tdata, M, only=tm.shard_keys, pad=True)
    np.testing.assert_array_equal(counts.numpy(), np.asarray(jcounts))
    lp = make_subposterior_logpdf(tm.log_prior, tm.log_lik, tm.prepare_data(shards), M,
                                  count=counts, per_datum=tm.shard_keys)
    got = lp(torch.from_numpy(thetas))
    np.testing.assert_allclose(got.numpy(), np.array(want), rtol=2e-5, atol=5e-3)
    # the prior alone, batched, against the reference's per chain
    np.testing.assert_allclose(tm.log_prior(torch.from_numpy(thetas)).numpy(),
                               [float(jm.log_prior(jnp.asarray(t))) for t in thetas],
                               rtol=1e-6, atol=1e-5)


def test_linear_closed_forms_match_reference():
    """Posterior and batched subposterior moments on repro's data (n=1,200,
    M=3): mean atol 1e-5, covariance atol 1e-7 (entries ~1e-3)."""
    data, beta = _reference("linear", 1200)
    jdata = {k: jnp.asarray(v) for k, v in data.items()}
    tdata, _ = from_reference_data(data, beta, device="cpu")
    want = jlin.posterior_moments(jdata)
    got = tlin.posterior_moments(tdata)
    np.testing.assert_allclose(got.mean.numpy(), np.asarray(want.mean), atol=1e-5)
    np.testing.assert_allclose(got.cov.numpy(), np.asarray(want.cov), atol=1e-7)
    shards = partition_data(tdata, 3)
    sub = tlin.subposterior_moments(shards, 3)
    for m in range(3):
        w = jlin.subposterior_moments({k: v[m * 400:(m + 1) * 400] for k, v in jdata.items()}, 3)
        np.testing.assert_allclose(sub.mean[m].numpy(), np.asarray(w.mean), atol=1e-5)
        np.testing.assert_allclose(sub.cov[m].numpy(), np.asarray(w.cov), atol=1e-7)


def test_linear_gibbs_blocks_match_reference_on_the_same_normals():
    """Two blocks over d=10 on 3 padded shards (n=901): each block's move on
    the reference's own normal z equals repro's (atol 1e-4 on β ~ 1); with
    z = 0 it is the conditional mean A_SS⁻¹(b_S − A_{S,₋S}β_₋S) in float64
    (atol 1e-4), and L⁻ᵀL⁻¹ is A_SS⁻¹ in float64 (rtol 1e-4, atol 1e-7:
    3e-5 of its diagonal, ~3e-3, for the near-zero entries)."""
    data, beta_true = _reference("linear", 901)
    M = 3
    jshards, jcounts = jax_partition({k: jnp.asarray(v) for k, v in data.items()}, M, pad=True)
    tdata, _ = from_reference_data(data, beta_true, device="cpu")
    shards, counts = partition_data(tdata, M, pad=True)
    tblocks = tlin.gibbs_blocks(shards, M, count=counts)
    rng = np.random.default_rng(2)
    beta = (beta_true + 0.05 * rng.standard_normal((M, 10))).astype(np.float32)
    for i, block in enumerate(tblocks):
        s0, s1 = (0, 5) if i == 0 else (5, 10)
        got_moves, zs, want_moves = [], [], []
        for m in range(M):
            shard = {k: v[m] for k, v in jshards.items()}
            jblock = jlin.gibbs_blocks(shard, M, count=jcounts[m])[i]
            key = jax.random.PRNGKey(10 * i + m)
            want_moves.append(np.asarray(jblock(key, jnp.asarray(beta[m]))))
            zs.append(np.asarray(jax.random.normal(key, (s1 - s0,))))
        new, unresolved = block.update(torch.from_numpy(beta), torch.from_numpy(np.stack(zs)))
        assert unresolved is None
        np.testing.assert_allclose(new.numpy(), np.stack(want_moves), atol=1e-4)
        mean, _ = block.update(torch.from_numpy(beta), torch.zeros(M, s1 - s0))
        A, b = tlin.block_statistics({k: v.double() for k, v in shards.items()}, M, count=counts)
        bd = torch.from_numpy(beta).double()
        r = b[:, s0:s1] - (A[:, s0:s1] @ bd[..., None])[..., 0] + (
            A[:, s0:s1, s0:s1] @ bd[:, s0:s1, None])[..., 0]
        want_mean = torch.linalg.solve(A[:, s0:s1, s0:s1], r)
        np.testing.assert_allclose(mean[:, s0:s1].numpy(), want_mean.numpy(), atol=1e-4)
        # the noise's covariance: the move is linear in z, so its Jacobian is L⁻ᵀ
        eye = torch.eye(s1 - s0)
        cols = [block.update(torch.from_numpy(beta), eye[j].expand(M, -1))[0][:, s0:s1] - mean[:, s0:s1]
                for j in range(s1 - s0)]
        lt = torch.stack(cols, dim=-1).double()  # (M, s, s) = L⁻ᵀ
        np.testing.assert_allclose((lt @ lt.transpose(1, 2)).numpy(),
                                   torch.linalg.inv(A[:, s0:s1, s0:s1]).numpy(), rtol=1e-4,
                                   atol=1e-7)


class _Recorder:
    """Stands in for a gamma draw: records the shape, returns ones."""

    def __init__(self):
        self.alphas = []

    def jax(self, key, alpha, shape=None, dtype=jnp.float32):
        alpha = jnp.asarray(alpha, dtype)
        self.alphas.append(np.asarray(jnp.broadcast_to(alpha, alpha.shape if shape is None else shape)))
        return jnp.ones(alpha.shape if shape is None else shape, dtype)

    def torch(self, alpha, rounds):
        a = torch.broadcast_to(alpha, rounds.boost.shape)
        self.alphas.append(a.numpy().copy())
        return torch.ones_like(a), torch.zeros((), dtype=torch.int64)


def _poisson_state(M, rng, q_shape):
    theta = np.stack([np.log(rng.uniform(1.0, 3.0, M)), np.log(rng.uniform(0.5, 1.5, M))],
                     -1).astype(np.float32)
    q = rng.gamma(2.0, 1.0, (M,) + q_shape).astype(np.float32) + 0.05
    return theta, q


def test_poisson_gibbs_conditionals_match_reference(monkeypatch):
    """q_i | a,b,x and b | a,q on 3 padded shards (n=1,001): the gamma shapes
    (a + x_i; (α−1)/M + 1 + count·a) within rtol 1e-6, the rates (b + t_i;
    β/M + Σ_{i<count} q_i) through the draws' reciprocals within rtol 1e-5."""
    data, theta_true = _reference("poisson", 1001)
    M = 3
    jshards, jcounts = jax_partition({k: jnp.asarray(v) for k, v in data.items()}, M, pad=True)
    tdata, _ = from_reference_data(data, theta_true, device="cpu")
    shards, counts = partition_data(tdata, M, pad=True)
    S = shards["x"].shape[1]
    rng = np.random.default_rng(4)
    theta, q = _poisson_state(M, rng, (S,))
    rec_j, rec_t = _Recorder(), _Recorder()
    monkeypatch.setattr(jpg.randgamma, "gamma", rec_j.jax)
    monkeypatch.setattr(tpg.randgamma, "gamma_from_rounds", rec_t.torch)
    tblocks = tpg.gibbs_blocks(shards, M, count=counts)
    pos = tpg.PoissonPosition(torch.from_numpy(theta), torch.from_numpy(q))
    gen = torch.Generator().manual_seed(0)
    new_q, _ = tblocks[0].update(pos, *tblocks[0].draw(gen, pos))
    new_b, _ = tblocks[1].update(pos, *tblocks[1].draw(gen, pos))
    want_q, want_logb = [], []
    for m in range(M):
        shard = {k: v[m] for k, v in jshards.items()}
        jb = jpg.gibbs_blocks(shard, M, count=jcounts[m])
        jpos = {"theta": jnp.asarray(theta[m]), "q": jnp.asarray(q[m])}
        want_q.append(np.asarray(jb[0](jax.random.PRNGKey(m), jpos)["q"]))
        want_logb.append(float(jb[1](jax.random.PRNGKey(m), jpos)["theta"][1]))
    j_alpha_q = np.stack(rec_j.alphas[0::2])
    j_alpha_b = np.array([float(a) for a in rec_j.alphas[1::2]])
    np.testing.assert_allclose(rec_t.alphas[0], j_alpha_q, rtol=1e-6)
    np.testing.assert_allclose(rec_t.alphas[1], j_alpha_b, rtol=1e-6)
    np.testing.assert_allclose(new_q.q.numpy(), np.stack(want_q), rtol=1e-5)
    np.testing.assert_allclose(new_b.theta[:, 1].numpy(), want_logb, rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(new_b.theta[:, 0].numpy(), theta[:, 0])


def test_poisson_a_block_decisions_match_reference():
    """The a-block's random-walk MH on log a, 24 chains on one shard of 400
    rows and on a padded one: fed the reference's own proposal normal and
    uniform, the accept decisions (both outcomes occur) and new log a equal
    repro's (atol 1e-6)."""
    data, theta_true = _reference("poisson", 400)
    rng = np.random.default_rng(5)
    C = 24
    for count in (None, 300):
        theta, q = _poisson_state(C, rng, (400,))
        shards = {k: torch.tensor(v)[None].expand(C, -1).contiguous() for k, v in data.items()}
        cnt = None if count is None else torch.full((C,), count)
        tblock = tpg.gibbs_blocks(shards, 4, mh_step=0.15, count=cnt)[2]
        jblock = jpg.gibbs_blocks({k: jnp.asarray(v) for k, v in data.items()}, 4, mh_step=0.15,
                                  count=None if count is None else jnp.asarray(count))[2]
        want, noise, log_u = [], [], []
        for c in range(C):
            key = jax.random.PRNGKey(100 + c)
            k_prop, k_acc = jax.random.split(key)
            noise.append(float(jax.random.normal(k_prop)))
            log_u.append(float(jnp.log(jax.random.uniform(k_acc))))
            out = jblock(key, {"theta": jnp.asarray(theta[c]), "q": jnp.asarray(q[c])})
            want.append(float(out["theta"][0]))
        pos = tpg.PoissonPosition(torch.from_numpy(theta), torch.from_numpy(q))
        new, _ = tblock.update(pos, torch.tensor(noise), torch.tensor(log_u))
        moved = np.array(want) != theta[:, 0]
        assert moved.any() and not moved.all()
        np.testing.assert_allclose(new.theta[:, 0].numpy(), want, atol=1e-6)
        np.testing.assert_array_equal(new.theta[:, 1].numpy(), theta[:, 1])


def test_gmm_permutation_proposal_matches_reference():
    """The §8.2 move on 6 chains: the permutation drawn as the argsort of
    uniforms, fed the reference's own permutation (as keys whose argsort it
    is) and noise, gives repro's proposal (atol 1e-6); every proposal with no
    noise is a relabelling of the means."""
    rng = np.random.default_rng(6)
    theta = rng.standard_normal((6, 20)).astype(np.float32)
    jprop = jgmm.permutation_rw_proposal(10, step_size=0.05)
    tprop = tgmm.permutation_rw_proposal(10, step_size=0.05)
    keys, noises, want = [], [], []
    for c in range(6):
        key = jax.random.PRNGKey(c)
        k_perm, k_noise = jax.random.split(key)
        perm = np.asarray(jax.random.permutation(k_perm, 10))
        inv = np.empty(10, np.float32)
        inv[perm] = np.arange(10, dtype=np.float32) / 10.0  # argsort(inv) == perm
        keys.append(inv)
        noises.append(np.asarray(jax.random.normal(k_noise, (10, 2))).reshape(-1))
        want.append(np.asarray(jprop(key, jnp.asarray(theta[c]))))
    got = tprop.move(torch.from_numpy(theta), torch.from_numpy(np.stack(keys)),
                     torch.from_numpy(np.stack(noises)))
    np.testing.assert_allclose(got.numpy(), np.stack(want), atol=1e-6)
    gen = torch.Generator().manual_seed(3)
    k, _ = tprop.draw(gen, torch.from_numpy(theta))
    relabelled = tgmm.permute_means(torch.from_numpy(theta), torch.argsort(k, dim=-1), 10)
    for c in range(6):
        assert sorted(map(tuple, relabelled[c].reshape(10, 2).tolist())) == \
            sorted(map(tuple, torch.from_numpy(theta[c]).reshape(10, 2).tolist()))
    marg = tgmm.single_mean_marginal(torch.from_numpy(theta), component=3)
    np.testing.assert_array_equal(marg.numpy(), np.asarray(jgmm.single_mean_marginal(
        jnp.asarray(theta), component=3)))


@pytest.mark.parametrize("name", ["linear", "poisson", "gmm"])
def test_generated_data_shapes_and_scales(name):
    """The port's generators give repro's keys, shapes and dtypes, and data
    on the same scale (mean and std of each per-datum key within 15 %)."""
    n = 4000
    tdata, tth = get_model(name).generate_data(torch.Generator().manual_seed(0), n)
    jdata, jth = _reference(name, n)
    assert set(tdata) == set(jdata) and tuple(tth.shape) == jth.shape
    for k, v in jdata.items():
        assert tuple(tdata[k].shape) == v.shape and tdata[k].dtype == torch.float32
        if v.ndim and v.shape[0] == n:
            assert abs(float(tdata[k].mean()) - v.mean()) <= 0.15 * (abs(v.mean()) + v.std())
            assert abs(float(tdata[k].std()) - v.std()) <= 0.15 * v.std()


def test_randgamma_rounds_raise_when_unresolved():
    """A lane that accepts in none of its rounds is counted, its value NaN,
    and the eager draw raises; it is never replaced by another draw."""
    rounds = randgamma.GammaRounds(torch.full((3, 4), -50.0), torch.full((3, 4), 0.5),
                                   torch.full((4,), 0.5))
    val, unresolved = randgamma.gamma_from_rounds(torch.full((4,), 2.0), rounds)
    assert int(unresolved) == 4 and bool(torch.isnan(val).all())
