"""The hand-written CUDA kernels against their plain versions, on the card.

Every test here needs an NVIDIA card (marker ``cuda``); without one, the
``cuda_device`` fixture skips it. This file imports no JAX, so it runs on a
machine that has only the port's stack:

    PYTHONPATH=src python -m pytest -p no:cacheprovider --noconftest -m cuda tests/test_torch_cuda.py

(``--noconftest``: the repo's ``tests/conftest.py`` configures JAX.)
"""

import ctypes

import pytest
import torch

from repro_torch import kernels
from repro_torch.kernels import kde_density
from repro_torch.kernels.img_weights import (
    StateTerm,
    img_log_weights,
    img_log_weights_ref,
    img_sweep,
    img_sweep_ref,
    sweep_agreement,
    sweep_smem_bytes,
)
from repro_torch.kernels.kde_density import (
    kde_log_density,
    kde_log_density_ref,
    machine_kde_log_density,
    machine_kde_log_density_ref,
)
from repro_torch.kernels.logreg_loglik import (
    logreg_loglik,
    logreg_loglik_grad,
    logreg_loglik_grad_ref,
)
from repro_torch.kernels.flash_attention import (
    flash_attention,
    flash_attention_bwd,
    flash_attention_ref,
)
from repro_torch.kernels.online_update import online_moments_update, online_moments_update_ref
from test_torch_threads import pin_torch_threads

pin_torch_threads()  # this worker's share of the cores under a parallel run

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernels have no CPU mode")
    return torch.device("cuda", 0)


def _logreg_inputs(device, G, N, d, C, seed=0):
    gen = torch.Generator(device=device).manual_seed(seed)
    X = torch.randn((G, N, d), generator=gen, device=device)
    y = torch.where(torch.rand((G, N), generator=gen, device=device) < 0.5, -1.0, 1.0)
    beta = torch.randn((G, d, C), generator=gen, device=device)
    return X, y, beta


# ℓ sums N float32 terms in another order than the plain version: relative
# error ~1e-6 → rtol 1e-5; gradient entries can cancel → atol 1e-2 at N=50,000.
@pytest.mark.parametrize("G,N,d,C", [(10, 5000, 50, 1), (1, 50000, 50, 1), (1, 1, 50, 1),
                                     (3, 4999, 37, 2), (2, 65, 130, 3), (4, 333, 1, 1),
                                     (2, 777, 300, 2), (1, 300, 1024, 1)])
def test_logreg_kernel_matches_plain(cuda_device, G, N, d, C):
    X, y, beta = _logreg_inputs(cuda_device, G, N, d, C)
    before = kernels.KERNELS["logreg_loglik_grad"].launches
    ll, g = logreg_loglik_grad(X, y, beta, scale=0.5)
    torch.cuda.synchronize()
    assert kernels.KERNELS["logreg_loglik_grad"].launches == before + 1
    ll_r, g_r = logreg_loglik_grad_ref(X, y, beta, scale=0.5)
    torch.testing.assert_close(ll, ll_r, rtol=1e-5, atol=1e-3)
    torch.testing.assert_close(g, g_r, rtol=1e-4, atol=1e-2)


def test_logreg_tickets_belong_to_a_stream(cuda_device):
    """Launches on two streams at once (two chain groups of five of the
    path's ten problems, as phase 4h runs them on one card) give the bits of
    the same launches run one after the other: each stream has its own
    tickets, which the last block of each launch resets. Both streams wait
    behind a sleeping kernel while every launch is queued, so they start
    together and run at once (a launch takes less time on the card than
    the host takes to queue the next)."""
    X, y, beta = _logreg_inputs(cuda_device, 10, 5000, 50, 1)
    halves = [tuple(t[lo:lo + 5].contiguous() for t in (X, y, beta)) for lo in (0, 5)]
    want = [logreg_loglik_grad(*h) for h in halves]
    torch.cuda.synchronize()
    streams = [torch.cuda.Stream(device=cuda_device) for _ in halves]
    torch.cuda._sleep(200_000_000)  # ~0.1 s: the queue fills meanwhile
    for s in streams:
        s.wait_stream(torch.cuda.current_stream())
    outs = []
    for _ in range(20):
        for i, (s, h) in enumerate(zip(streams, halves)):
            with torch.cuda.stream(s):
                outs.append((i, logreg_loglik_grad(*h)))
    torch.cuda.synchronize()
    for i, out in outs:
        for a, b in zip(out, want[i]):
            assert torch.equal(a, b)


def test_two_chain_groups_on_one_card_draw_the_batched_draws(cuda_device):
    """A (2, 1) mesh with both groups on cuda:0, each on its own stream with
    its own captured loops: θ bitwise the batched run's, the likelihood once
    per init and transition of each group plus the chain-group check's eager
    transitions."""
    import dataclasses

    from repro_torch.api import Pipeline, RunSpec
    from repro_torch.api.backends import CHECK_TRANSITIONS

    spec = RunSpec(model="logreg", sampler="mala", M=4, T=60, warmup=30, n=2000, seed=0,
                   groundtruth_T=100, combiner="parametric", score_metric="logl2")
    batched = Pipeline(spec, device=cuda_device).sample()
    lr = kernels.KERNELS["logreg_loglik_grad"]
    before = lr.launches
    mesh = Pipeline(dataclasses.replace(spec, mesh_shape=(2, 1)), device=cuda_device,
                    devices=(cuda_device, cuda_device)).sample()
    torch.cuda.synchronize()
    assert mesh.backend == "mesh[cuda](2 devices)" and mesh.collectives_checked > 0
    assert torch.equal(mesh.theta, batched.theta)
    per_group = 2 + spec.warmup + spec.resolved_burn_in() + spec.T
    assert lr.launches - before == 2 * (per_group + CHECK_TRANSITIONS)


CHAIN_BLIND = {"linear/hmc": ("linear", "hmc", 10_000), "gmm/rwmh": ("gmm", "rwmh", 20_000)}


@pytest.mark.parametrize("pair", sorted(CHAIN_BLIND))
def test_log_lik_and_gradient_do_not_follow_the_chain_count(cuda_device, pair):
    """A chain's log-likelihood and its gradient at M = 10 chains equal, bit
    for bit, the same chain's in either slice of 5: the sums over a shard's
    rows take an order that the chain's own row fixes, not the batch."""
    from repro_torch.core.subposterior import partition_data
    from repro_torch.models.bayes import get_model
    from repro_torch.samplers.mala import value_and_grad

    name, _, n = CHAIN_BLIND[pair]
    model = get_model(name)
    data, _ = model.generate_data(torch.Generator(device=cuda_device).manual_seed(0), n)
    shards = partition_data(data, 10, only=model.shard_keys)
    keys = model.shard_keys or tuple(shards)
    theta = torch.randn((10, model.d), generator=torch.Generator(device=cuda_device)
                        .manual_seed(1), device=cuda_device)
    ld, g = value_and_grad(lambda th: model.log_lik(th, shards), theta)
    for half in (slice(0, 5), slice(5, 10)):
        part = {k: (v[half] if k in keys else v) for k, v in shards.items()}
        ld_h, g_h = value_and_grad(lambda th: model.log_lik(th, part), theta[half])
        assert torch.equal(ld_h, ld[half]), float((ld_h - ld[half]).abs().max())
        assert torch.equal(g_h, g[half]), float((g_h - g[half]).abs().max())


@pytest.mark.parametrize("pair", sorted(CHAIN_BLIND))
def test_linear_and_gmm_chain_groups_draw_the_batched_draws(cuda_device, pair):
    """linear/HMC and GMM/rwmh on a (2, 1) mesh of cuda:0, each group of five
    chains on its own stream: θ bit for bit the one-group run's."""
    import dataclasses

    from repro_torch.api import Pipeline, RunSpec

    name, sampler, n = CHAIN_BLIND[pair]
    spec = RunSpec(model=name, sampler=sampler, M=10, T=60, warmup=30, n=n, seed=0,
                   groundtruth_T=100, combiner="parametric", score_metric="logl2")
    batched = Pipeline(spec, device=cuda_device).sample()
    mesh = Pipeline(dataclasses.replace(spec, mesh_shape=(2, 1)), device=cuda_device,
                    devices=(cuda_device, cuda_device)).sample()
    torch.cuda.synchronize()
    assert mesh.backend == "mesh[cuda](2 devices)"
    assert torch.equal(mesh.theta, batched.theta), float((mesh.theta - batched.theta)
                                                         .abs().max())


def test_chain_groups_are_queued_before_any_is_waited_for(cuda_device):
    """Two groups on two streams of one card: the second group's work does
    not wait for the first's (it ends while the first still sleeps), and the
    caller's stream waits for both."""
    from repro_torch.api.backends import GroupStreams

    lanes = GroupStreams((cuda_device, cuda_device), cuda_device)
    done = [torch.cuda.Event(), torch.cuda.Event()]

    def slow():
        torch.cuda._sleep(400_000_000)  # ~0.2 s of one SM's clock
        done[0].record()

    lanes.run([slow, done[1].record])
    after = torch.cuda.Event()
    after.record()  # on the caller's stream
    done[1].synchronize()
    assert not done[0].query(), "the second group waited for the first"
    after.synchronize()
    assert done[0].query(), "the caller's stream did not wait for the first group"


def test_logreg_kernel_is_deterministic(cuda_device):
    X, y, beta = _logreg_inputs(cuda_device, 1, 50000, 50, 1)
    first = logreg_loglik_grad(X, y, beta)
    for _ in range(3):
        for a, b in zip(first, logreg_loglik_grad(X, y, beta)):
            assert torch.equal(a, b)


@pytest.mark.parametrize("G,N,d,C", [(10, 5000, 50, 1), (1, 300, 1024, 1)])
def test_logreg_kernel_replays_in_a_graph_with_the_same_bits(cuda_device, G, N, d, C):
    """One launch captured in a CUDA graph and replayed three times: the same
    bits as the eager launch each time (the last block resets its ticket, so
    a replay starts from zero), one launch counted per replay, none for the
    capture; eager launches after the replays still agree. At d = 1024 the
    block takes more than 48 KB of shared memory, so the entry point sets the
    kernel's attribute while the graph is captured."""
    X, y, beta = _logreg_inputs(cuda_device, G, N, d, C)
    eager = logreg_loglik_grad(X, y, beta, scale=0.5)
    k = kernels.KERNELS["logreg_loglik_grad"]
    tally = kernels.LaunchTally()
    graph = torch.cuda.CUDAGraph()
    before = k.launches
    with tally.capturing(), torch.cuda.graph(graph):
        static = logreg_loglik_grad(X, y, beta, scale=0.5)
    assert k.launches == before and tally.launches["logreg_loglik_grad"] == 1
    for _ in range(3):
        graph.replay()
        tally.replay()
        torch.cuda.synchronize()
        assert all(torch.equal(a, b) for a, b in zip(static, eager))
    assert k.launches == before + 3
    assert all(torch.equal(a, b) for a, b in zip(logreg_loglik_grad(X, y, beta, scale=0.5), eager))


def test_logreg_kernel_reads_a_misaligned_base(cuda_device):
    """X starting 4, 8 or 12 bytes past a 16-byte boundary (the tile's ends
    take 4-byte copies): the same result as an aligned copy, bit for bit."""
    X, y, beta = _logreg_inputs(cuda_device, 2, 999, 50, 1)
    want = logreg_loglik_grad(X, y, beta)
    for shift in (1, 2, 3):
        flat = torch.empty(X.numel() + shift, device=cuda_device)
        Xs = flat[shift:].view(X.shape)
        Xs.copy_(X)
        assert Xs.data_ptr() % 16 == 4 * shift
        assert all(torch.equal(a, b) for a, b in zip(logreg_loglik_grad(Xs, y, beta), want))


def test_logreg_wrapper_raises_beyond_the_kernels_width(cuda_device):
    X, y, beta = _logreg_inputs(cuda_device, 1, 10, 1025, 1)
    with pytest.raises(ValueError, match="d <= 1024"):
        logreg_loglik_grad(X, y, beta)


def _logreg_subposterior(device, M=4, n=2000):
    from repro_torch.core.subposterior import make_subposterior_logpdf, partition_data
    from repro_torch.models.bayes import get_model

    model = get_model("logreg")
    data, _ = model.generate_data(torch.Generator(device=device).manual_seed(0), n)
    shards, _ = partition_data(data, M, only=model.shard_keys, pad=True)
    lp = make_subposterior_logpdf(model.log_prior, model.log_lik, model.prepare_data(shards), M)
    return lp, torch.zeros(M, model.d, device=device)


def test_graphed_chains_match_an_eager_loop_bitwise(cuda_device):
    """Warmup, burn-in and collection on the card, each a loop of one captured
    CUDA graph (chain_setup + chain_collect), against the eager loop they
    replace, written out here: a kernel rebuilt at exp(log ε) every warmup
    step, then ``kernel.step(gen, state)`` drawing its own noise from the same
    generator. The same θ, accept flags and adapted ε, bit for bit, and one
    likelihood launch counted per transition and per init."""
    from repro_torch.samplers import chain_collect, chain_setup, da_init, da_update
    from repro_torch.samplers.mala import mala_kernel

    lp, pos0 = _logreg_subposterior(cuda_device)
    W, B, T = 30, 20, 50
    k = kernels.KERNELS["logreg_loglik_grad"]
    before = k.launches
    gen = torch.Generator(device=cuda_device).manual_seed(3)
    kern, state, eps = chain_setup(gen, lambda e: mala_kernel(lp, e), pos0, burn_in=B,
                                   warmup=W, initial_step_size=0.1, target_accept=0.55)
    _, theta, info = chain_collect(gen, kern, state, T)
    torch.cuda.synchronize()
    assert k.launches - before == 1 + W + 1 + B + T

    gen = torch.Generator(device=cuda_device).manual_seed(3)
    da = da_init(0.1, (4,), cuda_device)
    s = mala_kernel(lp, torch.exp(da.log_eps)[:, None]).init(pos0)
    for _ in range(W):
        s, i = mala_kernel(lp, torch.exp(da.log_eps)[:, None]).step(gen, s)
        da = da_update(da, i.accept_prob, 0.55)
    step = torch.exp(da.log_eps_avg)[:, None]
    eager = mala_kernel(lp, step)
    s = eager.init(s.position)
    for _ in range(B):
        s, _ = eager.step(gen, s)
    rows, accs = [], []
    for _ in range(T):
        s, i = eager.step(gen, s)
        rows.append(s.position)
        accs.append(i.is_accepted)
    assert torch.equal(eps, step)
    assert torch.equal(theta, torch.stack(rows, dim=1))
    assert torch.equal(info.is_accepted, torch.stack(accs, dim=-1))
    assert 0 < int(info.is_accepted.sum()) < info.is_accepted.numel()


def test_chunk_backend_replays_one_graph_across_chunks(cuda_device):
    """Four chunks on the card run one collection loop (one capture) and give
    the fused run's θ bitwise; launches: setup's, then one per draw."""
    from repro_torch.api.backends import BatchedChunkBackend
    from repro_torch.api.sampling import make_shard_kernel
    from repro_torch.core.subposterior import partition_data
    from repro_torch.models.bayes import get_model

    model = get_model("logreg")
    data, _ = model.generate_data(torch.Generator(device=cuda_device).manual_seed(0), 900)
    shards, counts = partition_data(data, 3, only=model.shard_keys, pad=True)
    sk = make_shard_kernel(model, 3, "mala", use_counts=False)  # 900 rows: no padding

    def backend():
        return BatchedChunkBackend(sk, shards, counts, burn_in=5, warmup=12, step_size=0.1)

    k = kernels.KERNELS["logreg_loglik_grad"]
    chunked = backend()
    gen = torch.Generator(device=cuda_device).manual_seed(9)
    state, eps = chunked.setup(gen)
    before, parts, loops = k.launches, [], []
    for n in (10, 10, 10, 7):
        state, theta, _ = chunked.next_chunk(gen, eps, state, n)
        parts.append(theta)
        loops.append(chunked._loop)
    torch.cuda.synchronize()
    assert k.launches - before == 37
    assert len({id(x) for x in loops}) == 1 and loops[0].graph is not None
    fused, _ = backend().run_fused(torch.Generator(device=cuda_device).manual_seed(9), 37)
    assert torch.equal(torch.cat(parts, dim=1), fused)


def test_logreg_autograd_on_card(cuda_device):
    X, y, beta = _logreg_inputs(cuda_device, 10, 5000, 50, 1)
    b1 = beta.clone().requires_grad_(True)
    (g1,) = torch.autograd.grad(logreg_loglik(X, y, b1).sum(), b1)
    b2 = beta.clone().requires_grad_(True)
    (g2,) = torch.autograd.grad(logreg_loglik_grad_ref(X, y, b2)[0].sum(), b2)
    torch.testing.assert_close(g1, g2, rtol=1e-4, atol=1e-2)


# log w of size up to ~1e5 at h=0.05; float32 relative error ~1e-6.
@pytest.mark.parametrize("P,M,d,h", [(160, 10, 50, 0.05), (161, 10, 37, 0.3), (1, 1, 1, 1.0),
                                     (64, 2, 130, 0.7)])
def test_img_kernel_matches_plain(cuda_device, P, M, d, h):
    gen = torch.Generator(device=cuda_device).manual_seed(P)
    theta = torch.randn((P, M, d), generator=gen, device=cuda_device)
    out = img_log_weights(theta, torch.tensor(h, device=cuda_device))
    torch.cuda.synchronize()
    torch.testing.assert_close(out, img_log_weights_ref(theta, h), rtol=1e-5, atol=1e-3)


def _sweep_case(device, B, M, T, d, *, wt, ragged=False, spread=0.3, seed=0):
    """One kernel-mode IMG sweep's inputs on the card: M machines' draws
    around a shared centre (offsets and spread ``spread``; at 0.3 the sites
    both accept and reject), with ragged counts NaN beyond them, the model,
    the engine's carry and draws (c, then u, from one generator), and h from
    the engine's schedule at its tenth sweep (a device scalar, as the engine
    passes it)."""
    from repro_torch.core.combiners import img
    from repro_torch.core.combiners.api import resolve_schedule

    gen = torch.Generator(device=device).manual_seed(seed)
    centre = torch.randn((d,), generator=gen, device=device)
    samples = (centre + spread * torch.randn((M, 1, d), generator=gen, device=device)
               + spread * torch.randn((M, T, d), generator=gen, device=device))
    counts = torch.full((M,), T, dtype=torch.int32, device=device)
    if ragged:
        counts = torch.randint(T // 2, T, (M,), generator=gen, device=device).to(torch.int32)
        rows = torch.arange(T, device=device)[None, :, None]
        samples = torch.where(rows < counts[:, None, None], samples, float("nan"))
    model = img.semiparametric_model(samples, counts) if wt else img.nonparametric_model(samples)
    carry = img._init_img_carry(gen, samples, counts, model.aux, B)
    c = img._randint_below(gen, (B, M), counts)
    u = torch.rand((B, M), generator=gen, device=device)
    h = resolve_schedule(samples, None, False)(10 * B)
    return samples, counts, model, carry, c, u, h


def _both_sweeps(samples, model, carry, c, u, h):
    """The sweep route's result and the plain version's on the same draws."""
    wt = model.extra_logweight is not None
    got = img_sweep(carry, samples, c, u, h, aux=model.aux,
                    state_term=model.state_term(h) if wt else None)
    torch.cuda.synchronize()
    extra_lw = model.extra_logweight(h.expand(carry.mean.shape[0])) if wt else None
    return got, img_sweep_ref(carry, samples, c, u, h, model.aux, extra_lw)


# The sweep route against its plain version (ops.sweep_agreement): LW within
# the generic route's rtol 1e-5, atol 1e-3; accept flags equal wherever the
# plain margin |log u − log ratio| exceeds four times that tolerance (a chain
# whose flags part inside the margin is left out of the carry check); the
# carry equal in every other chain (indices, rows, counts exactly; mean 1e-5,
# sumsq rtol 1e-5, extra rtol 1e-4).
SWEEP_CASES = {"path": (16, 10, 1200, 50, False), "d=37": (16, 10, 1200, 37, False),
               "B=1": (1, 10, 1200, 50, False), "M=1": (16, 1, 1200, 50, False),
               "ragged": (16, 10, 1200, 50, True), "d=20": (8, 6, 400, 20, False),
               "d=130": (4, 4, 600, 130, False)}  # one and five rows a lane in a solve


@pytest.mark.parametrize("wt", [False, True], ids=["w_t", "W_t"])
@pytest.mark.parametrize("case", list(SWEEP_CASES))
def test_img_sweep_route_matches_plain(cuda_device, case, wt):
    B, M, T, d, ragged = SWEEP_CASES[case]
    samples, _, model, carry, c, u, h = _sweep_case(cuda_device, B, M, T, d, wt=wt, ragged=ragged)
    k = kernels.KERNELS["img_log_weights"]
    before = dict(k.route_launches)
    got, want = _both_sweeps(samples, model, carry, c, u, h)
    assert k.route_launches == dict(before, sweep=before["sweep"] + 1)
    report = sweep_agreement(got, want, u)
    assert report["ok"], report
    if case == "path":
        assert 0 < report["accepted"] < report["sites"]  # both branches are exercised


def test_img_sweep_route_is_deterministic_and_counted_by_route(cuda_device):
    samples, _, model, carry, c, u, h = _sweep_case(cuda_device, 16, 10, 1200, 50, wt=True)
    term = model.state_term(h)
    k = kernels.KERNELS["img_log_weights"]
    before = dict(k.route_launches)
    first = img_sweep(carry, samples, c, u, h, aux=model.aux, state_term=term)
    assert k.route_launches == dict(before, sweep=before["sweep"] + 1)
    for _ in range(3):
        again = img_sweep(carry, samples, c, u, h, aux=model.aux, state_term=term)
        assert all(torch.equal(a, b) for a, b in zip(again, first))
    before = dict(k.route_launches)
    img_log_weights(torch.randn((160, 10, 50), device=cuda_device), h)
    assert k.route_launches == dict(before, generic=before["generic"] + 1)


def test_engine_sweep_is_one_sweep_launch_on_the_card(cuda_device):
    """``_img_kernel_sweep`` on the card: its draws from the generator in the
    engine's order, then one sweep-route launch and no generic one."""
    from repro_torch.core.combiners import img

    samples, counts, model, carry, _, _, h = _sweep_case(cuda_device, 16, 10, 1200, 50, wt=True)
    term = model.state_term(h)
    k = kernels.KERNELS["img_log_weights"]
    before = dict(k.route_launches)
    got = img._img_kernel_sweep(carry, samples, counts, h, model.aux,
                                gen=torch.Generator(device=cuda_device).manual_seed(7),
                                state_term=term)
    torch.cuda.synchronize()
    assert k.route_launches == dict(before, sweep=before["sweep"] + 1)
    gen = torch.Generator(device=cuda_device).manual_seed(7)
    c = img._randint_below(gen, (16, 10), counts)
    u = torch.rand((16, 10), generator=gen, device=cuda_device)
    want = img_sweep(carry, samples, c, u, h, aux=model.aux, state_term=term)
    assert all(torch.equal(a, b) for a, b in zip(got, want[:6]))
    with pytest.raises(ValueError, match="state_term"):
        img_sweep(carry, samples, c, u, h, aux=model.aux,
                  extra_lw=model.extra_logweight(h.expand(16)))


def test_img_sweep_route_rejects_what_one_block_cannot_hold(cuda_device):
    from repro_torch.kernels.img_weights.ops import _entry

    lib = _entry()[0]
    for M, d, wt in ((10, 50, 0), (10, 50, 1), (1, 1, 0), (10, 37, 1), (64, 200, 0)):
        assert lib.img_sweep_smem_bytes(M, d, wt) == sweep_smem_bytes(M, d, bool(wt))
    assert lib.img_sweep_smem_bytes(10, 300, 1) == 0
    B, M, T, d = 2, 10, 20, 300
    samples = torch.randn((M, T, d), device=cuda_device)
    carry = (torch.zeros((B, M), dtype=torch.int64, device=cuda_device),
             samples[:, 0].expand(B, M, d).contiguous(), samples[:, 0].mean(0).expand(B, d).contiguous(),
             *(torch.zeros((B,), device=cuda_device) for _ in range(3)))
    c = torch.ones((B, M), dtype=torch.int64, device=cuda_device)
    u = torch.rand((B, M), device=cuda_device)
    term = StateTerm(torch.eye(d, device=cuda_device), torch.zeros((), device=cuda_device),
                     torch.zeros((d,), device=cuda_device))
    k = kernels.KERNELS["img_log_weights"]
    before = dict(k.route_launches)
    with pytest.raises(ValueError, match="shared memory"):
        img_sweep(carry, samples, c, u, 0.5, aux=torch.zeros((M, T), device=cuda_device),
                  state_term=term)
    img_sweep(carry, samples, c, u, 0.5)  # w_t at d = 300 fits (24 KB)
    assert k.route_launches == dict(before, sweep=before["sweep"] + 1)
    with pytest.raises(TypeError):
        img_sweep(carry, samples.double(), c, u, 0.5)


def test_cuda_wrappers_check_operands(cuda_device):
    X, y, beta = _logreg_inputs(cuda_device, 2, 100, 8, 1)
    with pytest.raises(ValueError):
        logreg_loglik_grad(X.transpose(1, 2).contiguous().transpose(1, 2), y, beta)
    with pytest.raises(TypeError):
        logreg_loglik_grad(X.double(), y, beta)
    with pytest.raises(ValueError):
        img_log_weights(torch.randn(4, 3, 2, device=cuda_device).transpose(0, 2), 1.0)


def _kde_inputs(device, Q, M, T, d, *, ragged=False, seed=0):
    """Draws at the logreg path's scale: a shared centre ~N(0, I), machine
    offsets and spread 0.03; queries drawn from the pooled valid rows; NaN
    beyond counts (with an empty and a single-row machine) when ragged."""
    gen = torch.Generator(device=device).manual_seed(seed)
    centre = torch.randn((d,), generator=gen, device=device)
    s = centre + 0.03 * torch.randn((M, 1, d), generator=gen, device=device) \
        + 0.03 * torch.randn((M, T, d), generator=gen, device=device)
    q = s.reshape(M * T, d)[torch.randint(0, M * T, (Q,), generator=gen, device=device)]
    h = 0.02 + 0.03 * torch.rand((M,), generator=gen, device=device)
    counts = None
    if ragged:
        counts = torch.randint(1, T + 1, (M,), generator=gen, device=device).to(torch.int32)
        counts[1], counts[2] = 0, 1
        rows = torch.arange(T, device=device)[None, :, None]
        s = torch.where(rows < counts[:, None, None], s, float("nan"))
    return q.contiguous(), s.contiguous(), h, counts


def _as_tuple(out):
    return out if isinstance(out, tuple) else (out,)


# Against the plain version in float64: the kernel's centred 3×TF32 distances
# in float32 are off by ~1e-4 on log p̂ (sums over d and T in float32; values
# up to ~1e3), so atol 1e-3 per machine (×M for the product over machines)
# and rtol 1e-5; −inf (empty machines) in the same places. d = 300 and 264
# run the loop over 64-dim chunks; Q = 333 and 65 leave a query block part
# empty.
@pytest.mark.parametrize("Q,M,T,d,ragged", [(12000, 10, 1200, 50, False), (1000, 10, 1200, 50, False),
                                            (500, 5, 1201, 37, True), (1, 1, 1, 1, False),
                                            (300, 3, 200, 130, True), (129, 2, 33, 65, False),
                                            (333, 3, 257, 300, True), (65, 2, 129, 264, False)])
@pytest.mark.parametrize("reduce", ["none", "product", "mixture", "product_mixture"])
@pytest.mark.parametrize("weights", ["counts", "uniform"])
def test_machine_kde_kernel_matches_float64_plain(cuda_device, Q, M, T, d, ragged, reduce, weights):
    q, s, h, counts = _kde_inputs(cuda_device, Q, M, T, d, ragged=ragged)
    got = machine_kde_log_density(q, s, h, counts, reduce=reduce, mixture_weights=weights)
    torch.cuda.synchronize()
    want = machine_kde_log_density_ref(q.double(), s.double(), h.double(), counts, reduce=reduce,
                                       mixture_weights=weights)
    for i, (g, w) in enumerate(zip(_as_tuple(got), _as_tuple(want))):
        assert g.dtype == torch.float32 and not torch.isnan(g).any()
        assert torch.equal(torch.isneginf(g), torch.isneginf(w))
        fin = torch.isfinite(w)
        atol = 1e-3 * (M if reduce in ("product", "product_mixture") and i == 0 else 1)
        torch.testing.assert_close(g.double()[fin], w[fin], rtol=1e-5, atol=atol)


@pytest.mark.parametrize("d", [50, 64, 8, 1])
def test_kde_tile_cross_term_matches_float64(cuda_device, d):
    """One tile of the tensor-core cross term, raw, against float64
    (``kde_probe.check_tile``: within 2^-18 of Σ|q_c||s_c| per entry)."""
    from repro_torch.launch.kde_probe import check_tile

    assert check_tile(torch.Generator(device=cuda_device).manual_seed(d), d)


def test_kde_cloud_kernel_matches_float64_plain(cuda_device):
    gen = torch.Generator(device=cuda_device).manual_seed(3)
    for nq, ns, d in ((300, 700, 7), (1, 1, 1), (257, 100, 130)):
        q = torch.randn((nq, d), generator=gen, device=cuda_device)
        c = torch.randn((ns, d), generator=gen, device=cuda_device)
        got = kde_log_density(q, c, 0.5)
        torch.cuda.synchronize()
        want = kde_log_density_ref(q, c, 0.5)
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-4)


def test_machine_kde_kernel_is_deterministic(cuda_device):
    q, s, h, _ = _kde_inputs(cuda_device, 12000, 10, 1200, 50)
    first = machine_kde_log_density(q, s, h, reduce="product_mixture")
    for _ in range(3):
        for a, b in zip(first, machine_kde_log_density(q, s, h, reduce="product_mixture")):
            assert torch.equal(a, b)


def test_kde_kernels_count_one_launch_per_call(cuda_device):
    q, s, h, counts = _kde_inputs(cuda_device, 300, 4, 200, 9, ragged=True)
    machine = kernels.KERNELS["machine_kde_log_density"]
    cloud = kernels.KERNELS["kde_log_density"]
    for reduce in ("none", "product", "mixture", "product_mixture"):
        before = (machine.launches, cloud.launches)
        machine_kde_log_density(q, s, h, counts, reduce=reduce)
        assert (machine.launches, cloud.launches) == (before[0] + 1, before[1])
    before = (machine.launches, cloud.launches)
    kde_log_density(q, s[0], 0.3)
    assert (machine.launches, cloud.launches) == (before[0], before[1] + 1)
    torch.cuda.synchronize()


def test_kde_wrapper_raises_when_the_launch_fails(cuda_device, monkeypatch):
    """A CUDA error from the C entry point raises, and counts no launch."""
    lib, _ = kde_density.ops._entry()

    def failing(*args):
        return 9  # cudaErrorInvalidConfiguration

    monkeypatch.setattr(kde_density.ops, "_entry", lambda: (lib, failing))
    q, s, h, _ = _kde_inputs(cuda_device, 10, 2, 20, 3)
    before = kernels.KERNELS["machine_kde_log_density"].launches
    with pytest.raises(RuntimeError, match="CUDA error 9"):
        machine_kde_log_density(q, s, h)
    assert kernels.KERNELS["machine_kde_log_density"].launches == before
    with pytest.raises(TypeError):
        machine_kde_log_density(q.double(), s, h)


# online_update: the kernel sums the chunk mean and the centred Gram in
# another order than the plain version. Against the plain version in float64
# the kernel's own float32 rounding is the tolerance: count exact, mean within
# 1e-5·(1 + |mean|), m2 within 1e-5·max|m2| of each machine. Against the
# float32 plain version, whose own rounding adds as much again, 1e-4 relative
# (the reference tests' figure), 1e-4·max|m2| per machine for m2.
def _online_inputs(device, M, C, d, *, ragged=False, seed=0):
    """A running state after some draws, and a chunk shifted from it; NaN
    beyond each count (with an empty machine) when ragged."""
    gen = torch.Generator(device=device).manual_seed(seed)
    count = torch.full((M,), 240.0, device=device)
    mean = torch.randn((M, d), generator=gen, device=device)
    a = torch.randn((M, 2 * d, d), generator=gen, device=device)
    m2 = a.transpose(1, 2) @ a
    chunk = mean[:, None, :] + 0.3 + torch.randn((M, C, d), generator=gen, device=device)
    counts = None
    if ragged:
        counts = torch.randint(1, C + 1, (M,), generator=gen, device=device).to(torch.int32)
        counts[0] = 0
        rows = torch.arange(C, device=device)[None, :, None]
        chunk = torch.where(rows < counts[:, None, None], chunk, float("nan"))
    return count, mean, m2, chunk.contiguous(), counts


def _assert_online_close(got, want, *, rel):
    (c, mu, m2), (cw, muw, m2w) = got, want
    assert torch.equal(c.double(), cw.double())
    assert torch.isfinite(mu).all() and torch.isfinite(m2).all()
    mu_err = (mu.double() - muw.double()).abs() / (1.0 + muw.double().abs())
    assert float(mu_err.max()) <= rel
    scale = m2w.double().abs().amax(dim=(1, 2), keepdim=True).clamp(min=1e-30)
    assert float(((m2.double() - m2w.double()).abs() / scale).max()) <= rel


@pytest.mark.parametrize("M,C,d,ragged", [(10, 120, 50, False), (10, 120, 50, True),
                                          (3, 1, 50, False), (4, 31, 65, True), (1, 7, 1, False),
                                          (2, 300, 130, True)])
def test_online_update_kernel_matches_float64_plain(cuda_device, M, C, d, ragged):
    count, mean, m2, chunk, counts = _online_inputs(cuda_device, M, C, d, ragged=ragged)
    got = online_moments_update(count, mean, m2, chunk, counts)
    torch.cuda.synchronize()
    want64 = online_moments_update_ref(count.double(), mean.double(), m2.double(),
                                       chunk.double(), counts)
    _assert_online_close(got, want64, rel=1e-5)
    _assert_online_close(got, online_moments_update_ref(count, mean, m2, chunk, counts), rel=1e-4)


def test_online_update_kernel_empty_machine_is_bitwise_unchanged(cuda_device):
    count, mean, m2, chunk, _ = _online_inputs(cuda_device, 3, 40, 50)
    counts = torch.tensor([0, 40, 0], dtype=torch.int32, device=cuda_device)
    c, mu, s = online_moments_update(count, mean, m2, chunk, counts)
    for m in (0, 2):
        assert torch.equal(c[m], count[m]) and torch.equal(mu[m], mean[m]) and torch.equal(s[m], m2[m])


def test_online_update_kernel_counts_beyond_c_mirror_the_plain_version(cuda_device):
    count, mean, m2, chunk, _ = _online_inputs(cuda_device, 2, 20, 9)
    counts = torch.tensor([25, 20], dtype=torch.int32, device=cuda_device)
    got = online_moments_update(count, mean, m2, chunk, counts)
    want = online_moments_update_ref(count.double(), mean.double(), m2.double(), chunk.double(),
                                     counts)
    _assert_online_close(got, want, rel=1e-5)


def test_online_update_kernel_takes_a_slice_of_the_draw_buffer(cuda_device):
    """A (M, C, d) slice of a (M, T, d) buffer (machine stride T·d) folds as
    its contiguous copy does, bitwise."""
    count, mean, m2, buf, _ = _online_inputs(cuda_device, 10, 1200, 50)
    view = buf[:, 120:240]
    assert not view.is_contiguous()
    for a, b in zip(online_moments_update(count, mean, m2, view),
                    online_moments_update(count, mean, m2, view.contiguous())):
        assert torch.equal(a, b)


def test_online_update_kernel_is_deterministic_and_symmetric(cuda_device):
    count, mean, m2, chunk, counts = _online_inputs(cuda_device, 10, 120, 50, ragged=True)
    first = online_moments_update(count, mean, m2, chunk, counts)
    assert torch.equal(first[2], first[2].transpose(1, 2))
    for _ in range(3):
        for a, b in zip(first, online_moments_update(count, mean, m2, chunk, counts)):
            assert torch.equal(a, b)


def test_online_update_counts_one_launch_per_call(cuda_device):
    count, mean, m2, chunk, counts = _online_inputs(cuda_device, 4, 50, 70, ragged=True)
    k = kernels.KERNELS["online_update"]
    before = k.launches
    online_moments_update(count, mean, m2, chunk, counts)
    online_moments_update(count, mean, m2, chunk)
    assert k.launches == before + 2
    torch.cuda.synchronize()


def test_online_update_wrapper_raises_when_the_launch_fails(cuda_device, monkeypatch):
    from repro_torch.kernels.online_update import ops

    lib, _ = ops._entry()
    monkeypatch.setattr(ops, "_entry", lambda: (lib, lambda *args: 9))
    count, mean, m2, chunk, _ = _online_inputs(cuda_device, 2, 10, 3)
    before = kernels.KERNELS["online_update"].launches
    with pytest.raises(RuntimeError, match="CUDA error 9"):
        online_moments_update(count, mean, m2, chunk)
    assert kernels.KERNELS["online_update"].launches == before
    with pytest.raises(TypeError):
        online_moments_update(count, mean, m2, chunk.double())
    with pytest.raises(ValueError):
        online_moments_update(count, mean, m2, chunk.transpose(1, 2).contiguous().transpose(1, 2))


# the kernel's two routes (``ops._plan``): "whole" copies a machine's rows
# into shared memory at once, "slab" streams them; the cases of
# ``launch/online_probe.py`` (chip_smoke.py phase 3's inputs) that take each,
# at the tolerances above, and the route each took
@pytest.mark.parametrize("label,route", [("path fold", "whole"),
                                         ("slab: the draw buffer as one chunk", "slab"),
                                         ("slab: d=300 ragged", "slab"),
                                         ("unaligned: d=37 slice from row 121", "whole")])
def test_online_update_routes_match_float64_plain(cuda_device, label, route):
    from repro_torch.launch.online_probe import case_inputs

    count, mean, m2, chunk, counts = case_inputs(label, cuda_device)
    k = kernels.KERNELS["online_update"]
    before = dict(k.route_launches)
    got = online_moments_update(count, mean, m2, chunk, counts)
    torch.cuda.synchronize()
    assert {r: n - before[r] for r, n in k.route_launches.items()} == \
        {r: int(r == route) for r in k.route_launches}
    want64 = online_moments_update_ref(count.double(), mean.double(), m2.double(),
                                       chunk.double(), counts)
    _assert_online_close(got, want64, rel=1e-5)
    _assert_online_close(got, online_moments_update_ref(count, mean, m2, chunk, counts), rel=1e-4)


@pytest.mark.parametrize("label", ["path fold ragged", "slab: d=300 ragged"])
def test_online_update_both_routes_deterministic_and_alike(cuda_device, label):
    """Three more launches give the same bits on the planned route, and the
    slab route the same bits too: both add the same numbers in the same
    order."""
    from repro_torch.kernels.online_update import ops
    from repro_torch.launch.online_probe import case_inputs

    count, mean, m2, chunk, counts = case_inputs(label, cuda_device)
    first = online_moments_update(count, mean, m2, chunk, counts)
    for _ in range(3):
        for a, b in zip(first, online_moments_update(count, mean, m2, chunk, counts)):
            assert torch.equal(a, b)
    for a, b in zip(first, ops._launch(count, mean, m2, chunk, counts, route="slab")):
        assert torch.equal(a, b)


def test_online_update_refuses_a_plan_it_would_not_carve(cuda_device):
    """The source's shared memory is the plan's (ops.smem_bytes mirrors it to
    choose the route), and a whole route past its budget is refused: at d =
    50, 430 rows fit and 431 do not."""
    from repro_torch.kernels.online_update import ops

    lib = ops._entry()[0]
    for route in ops.ROUTES:
        for C, d in ((120, 50), (1200, 50), (120, 300), (120, 37), (0, 50), (1, 50), (7, 1),
                     (31, 65), (256, 3), (257, 3), (430, 50), (431, 50)):
            want = ops.smem_bytes(route, C, d)
            if route == "whole" and want > ops.WHOLE_BUDGET:
                want = 0  # the source's answer for a span it will not take whole
            assert lib.online_update_smem_bytes(ops.ROUTES.index(route), C, d) == want
    assert lib.online_update_smem_bytes(0, 431, 50) == 0
    for C, ok in ((430, True), (431, False)):
        count, mean, m2, chunk, _ = _online_inputs(cuda_device, 1, C, 50)
        if ok:
            ops._launch(count, mean, m2, chunk, None, route="whole")
        else:
            with pytest.raises(RuntimeError, match="CUDA error"):
                ops._launch(count, mean, m2, chunk, None, route="whole")


def test_stream_combine_fused_and_subscriber_agree_on_card(cuda_device):
    """A small logreg stream on the card: the same θ in both modes, bitwise
    finals for the buffered combiners, online's to merge rounding, and one
    online_update launch per fused chunk (none on the subscriber path)."""
    from repro_torch.api import Pipeline, RunSpec

    spec = RunSpec(model="logreg", sampler="mala", M=4, T=200, warmup=30, n=2000,
                   groundtruth_T=100, seed=0, stream_every=64,
                   combiner=("parametric", "online", "pool", "nonparametric", "consensus"),
                   combiner_options={"weight_eval": "kernel", "n_batch": 16})
    k = kernels.KERNELS["online_update"]
    before = k.launches
    pf = Pipeline(spec, device=cuda_device)
    sf = pf.stream_combine(n_estimate=64, score=False)
    assert k.launches == before + 4  # 64, 128, 192 and the tail to 200
    ps = Pipeline(spec, device=cuda_device)
    su = ps.stream_combine(n_estimate=64, score=False, fused=False)
    assert k.launches == before + 4
    assert torch.equal(pf.sample().theta, ps.sample().theta)
    assert pf.sample().backend == "batched[cuda,fused]"
    assert ps.sample().backend == "batched[cuda,chunked]"
    assert [(r["t"], r["combiner"]) for r in sf.trajectory] == \
        [(r["t"], r["combiner"]) for r in su.trajectory]
    for name in ("parametric", "pool", "nonparametric", "consensus"):
        assert torch.equal(sf.combined[name].samples, su.combined[name].samples), name
    torch.testing.assert_close(sf.combined["online"].moments.mean, su.combined["online"].moments.mean,
                               rtol=1e-4, atol=1e-4)


# flash_attention: each route sums q·k and P·v in float32 in another order
# than the plain version's matrix products (the float32 tensor-core route
# from 3×TF32 products, ``ref.flash_attention_ref_split``'s arithmetic).
# Against the plain version in float64, on the same inputs: float32 within
# 2e-5 (+ 2e-5·|out|) on either float32 route, bfloat16 within the output's
# own rounding, 2^-8 relative (atol 1e-2 on values of size ~1, rtol 1e-2).
# Against the float32 plain version: float32 within 1e-4 (the two roundings
# add), bfloat16 within 1e-2 as well (both round the same float32 value to
# bfloat16; they differ by at most one spacing). In float32 the shapes with
# hd, hd_v in {64, 128} take the "tf32x3" route, the others the FMA route.
# The plain versions run a slice of kv heads at a time
# (``flash_bwd_probe.plain_by_heads``: the same values, in the card's memory).
FLASH_SHAPES = [  # b, s, t, kh, g, hd, hd_v, causal, kv_len
    (2, 4096, 4096, 8, 3, 128, 128, True, None),  # the serving path (llama3.2-3b prefill)
    (1, 128, 128, 1, 1, 32, 32, True, None),  # tests/test_flash_kernel.py's four
    (2, 128, 128, 2, 2, 32, 16, True, None),
    (1, 100, 160, 1, 4, 16, 16, False, None),
    (1, 256, 256, 2, 1, 64, 64, True, None),
    (1, 300, 300, 4, 1, 192, 128, True, None),  # MLA's nope⊕rope qk with hd_v 128
    (2, 70, 90, 2, 3, 36, 20, True, 17),  # kv_len inside the causal reach; hd % 8 != 0
    (1, 65, 65, 1, 5, 8, 8, True, 0),  # every row fully masked: zeros, no NaN
    # the tensor-core routes' cases (bf16: "tensor_core"; float32: "tf32x3")
    (1, 300, 300, 2, 1, 128, 128, True, None),  # G = 1: three position slabs a block
    (1, 300, 300, 2, 3, 128, 128, True, None),  # G = 3: one slab of each head a block
    (1, 300, 300, 1, 7, 128, 128, True, None),  # G = 7: a group's heads over blocks
    (1, 300, 300, 1, 8, 128, 128, True, None),  # G = 8 (jamba)
    (2, 200, 200, 2, 3, 64, 64, True, None),  # hd 64
    (1, 1000, 1000, 2, 3, 128, 128, True, None),  # ragged S = T
    (1, 100, 4096, 2, 3, 128, 128, False, None),  # non-causal, S ≪ T
    (1, 200, 1000, 2, 3, 128, 128, False, 777),  # non-causal kv_len < T
    (1, 130, 130, 2, 3, 128, 128, True, 0),  # kv_len 0 at hd 128: every row exactly 0
    (1, 4096, 4096, 8, 2, 64, 64, True, None),  # granite-moe-1b-a400m's prefill and training
    (2, 4096, 4096, 8, 8, 128, 128, True, None),  # jamba-1.5-large-398b's layer 4 prefill
    (2, 1500, 1500, 8, 1, 64, 64, False, None),  # whisper-base's encoder: 1,500 frames, non-causal
    (2, 4672, 4672, 8, 4, 128, 128, True, None),  # llava-next-mistral-7b: 576 + 4,096, G = 4
    (2, 4096, 4096, 20, 1, 128, 128, True, None),  # qwen1.5-4b's prefill: MHA, 20 heads
]


def _flash_route(dtype, hd, hd_v):
    """The route a contiguous, aligned call must take (the route rule's
    dtype and head-dim conditions)."""
    if dtype == torch.bfloat16 and all(d % 64 == 0 and d <= 256 for d in (hd, hd_v)):
        return "tensor_core"
    if dtype == torch.float32 and hd in (64, 128) and hd_v in (64, 128):
        return "tf32x3"
    return "fma"


def test_flash_shapes_take_every_route(cuda_device):
    """FLASH_SHAPES hold each route to the tolerances: both float32 routes
    among the float32 cases, by the wrapper's own rule on card tensors."""
    from repro_torch.kernels.flash_attention import ops as flash_ops

    seen = {}
    for b, s, t, kh, g, hd, hd_v, causal, kv_len in FLASH_SHAPES:
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v = _flash_inputs(cuda_device, 1, 1, 1, 1, g, hd, hd_v, dtype)
            route = flash_ops._route(q, k, v)
            assert route == _flash_route(dtype, hd, hd_v)
            seen.setdefault(dtype, set()).add(route)
    assert seen[torch.float32] == {"tf32x3", "fma"}
    assert seen[torch.bfloat16] == {"tensor_core", "fma"}


def _flash_inputs(device, b, s, t, kh, g, hd, hd_v, dtype, seed=0):
    gen = torch.Generator(device=device).manual_seed(seed)
    q = torch.randn((b, s, kh, g, hd), generator=gen, device=device).to(dtype)
    k = torch.randn((b, t, kh, hd), generator=gen, device=device).to(dtype)
    v = torch.randn((b, t, kh, hd_v), generator=gen, device=device).to(dtype)
    return q, k, v


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,s,t,kh,g,hd,hd_v,causal,kv_len", FLASH_SHAPES)
def test_flash_kernel_matches_plain(cuda_device, b, s, t, kh, g, hd, hd_v, causal, kv_len, dtype):
    q, k, v = _flash_inputs(cuda_device, b, s, t, kh, g, hd, hd_v, dtype)
    kernel = kernels.KERNELS["flash_attention"]
    before, routes = kernel.launches, dict(kernel.route_launches)
    out = flash_attention(q, k, v, causal=causal, kv_len=kv_len)
    torch.cuda.synchronize()
    assert kernel.launches == before + 1
    route = _flash_route(dtype, hd, hd_v)
    assert kernel.route_launches == dict(routes, **{route: routes[route] + 1})
    assert out.shape == (b, s, kh, g, hd_v) and out.dtype == dtype
    assert bool(torch.isfinite(out).all())
    from repro_torch.launch.flash_bwd_probe import plain_by_heads

    want64 = plain_by_heads(flash_attention_ref, q.double(), k.double(), v.double(),
                            causal=causal, kv_len=kv_len)
    want32 = plain_by_heads(flash_attention_ref, q, k, v, causal=causal, kv_len=kv_len)
    if dtype == torch.float32:
        torch.testing.assert_close(out.double(), want64, rtol=2e-5, atol=2e-5)
        torch.testing.assert_close(out, want32, rtol=1e-4, atol=1e-4)
    else:
        torch.testing.assert_close(out.double(), want64, rtol=1e-2, atol=1e-2)
        torch.testing.assert_close(out.float(), want32.float(), rtol=1e-2, atol=1e-2)
    if kv_len == 0:
        assert torch.equal(out, torch.zeros_like(out))


def test_flash_kernel_reads_strided_operands(cuda_device):
    """q, k, v as views with padded rows and a permuted axis order: the kernel
    reads them through their strides, with no copy, as the plain version.
    Every stride is a multiple of 16 bytes, so the strided call and the
    contiguous one both take the "tf32x3" route: the same bits."""
    b, s, t, kh, g, hd = 2, 200, 230, 2, 3, 64
    gen = torch.Generator(device=cuda_device).manual_seed(3)
    q = torch.randn((b, s, kh, g, hd + 8), generator=gen, device=cuda_device)[..., :hd]
    k = torch.randn((b, kh, t, hd), generator=gen, device=cuda_device).transpose(1, 2)
    v = torch.randn((t, b, kh, hd), generator=gen, device=cuda_device).permute(1, 0, 2, 3)
    kernel = kernels.KERNELS["flash_attention"]
    before = kernel.route_launches["tf32x3"]
    out = flash_attention(q, k, v, causal=True)
    assert kernel.route_launches["tf32x3"] == before + 1
    want = flash_attention_ref(q.double(), k.double(), v.double(), causal=True)
    torch.testing.assert_close(out.double(), want, rtol=2e-5, atol=2e-5)
    torch.testing.assert_close(out, flash_attention(q.contiguous(), k.contiguous(), v.contiguous()),
                               rtol=0, atol=0)


def test_flash_kernel_reads_the_models_query_view(cuda_device):
    """q as the model hands it to flash: (B, S, H, hd) reshaped to
    (B, S, K, G, hd), here a view into a fused q|k|v projection (strides
    (S·W, W, G·hd, hd, 1) with W the fused width): read as it is, no copy."""
    b, s, kh, g, hd = 2, 500, 2, 3, 128
    h = kh * g
    gen = torch.Generator(device=cuda_device).manual_seed(5)
    qkv = torch.randn((b, s, h + 2 * kh, hd), generator=gen, device=cuda_device).to(torch.bfloat16)
    q = qkv[:, :, :h].reshape(b, s, kh, g, hd)
    k, v = qkv[:, :, h:h + kh], qkv[:, :, h + kh:]
    assert q.data_ptr() == qkv.data_ptr() and not q.is_contiguous()
    kernel = kernels.KERNELS["flash_attention"]
    before = kernel.route_launches["tensor_core"]
    out = flash_attention(q, k, v, causal=True)
    assert kernel.route_launches["tensor_core"] == before + 1
    want = flash_attention_ref(q.double(), k.double(), v.double(), causal=True)
    torch.testing.assert_close(out.double(), want, rtol=1e-2, atol=1e-2)
    assert torch.equal(out, flash_attention(q.contiguous(), k.contiguous(), v.contiguous()))


def test_flash_misaligned_bf16_takes_the_fma_route(cuda_device):
    """bf16 at hd 128 whose base sits 2 bytes off 16, or whose row stride is
    not a multiple of 16 bytes: the FMA kernel, and the same numbers."""
    b, s, kh, g, hd = 1, 200, 2, 3, 128
    gen = torch.Generator(device=cuda_device).manual_seed(6)
    flat = torch.randn((b * s * kh * g * hd + 1,), generator=gen, device=cuda_device)
    q_off = flat.to(torch.bfloat16)[1:].view(b, s, kh, g, hd)  # base 2 bytes off 16
    q_row = torch.randn((b, s, kh, g, hd + 4), generator=gen,
                        device=cuda_device).to(torch.bfloat16)[..., :hd]  # row stride 132
    k = torch.randn((b, s, kh, hd), generator=gen, device=cuda_device).to(torch.bfloat16)
    v = torch.randn((b, s, kh, hd), generator=gen, device=cuda_device).to(torch.bfloat16)
    kernel = kernels.KERNELS["flash_attention"]
    for q in (q_off, q_row):
        before = dict(kernel.route_launches)
        out = flash_attention(q, k, v, causal=True)
        assert kernel.route_launches == dict(before, fma=before["fma"] + 1)
        want = flash_attention_ref(q.double(), k.double(), v.double(), causal=True)
        torch.testing.assert_close(out.double(), want, rtol=1e-2, atol=1e-2)


def test_flash_kernel_is_deterministic(cuda_device):
    q, k, v = _flash_inputs(cuda_device, 1, 1000, 1000, 2, 3, 128, 128, torch.bfloat16, seed=4)
    kernel = kernels.KERNELS["flash_attention"]
    before = kernel.route_launches["tensor_core"]
    first = flash_attention(q, k, v)
    for _ in range(3):
        assert torch.equal(first, flash_attention(q, k, v))
    assert kernel.route_launches["tensor_core"] == before + 4


def test_flash_tf32x3_route_is_deterministic_and_masks_to_zero(cuda_device):
    """The float32 tensor-core route: three runs of one input give the same
    bits, a fully masked call (kv_len = 0) exact zeros, and a float32 q that
    no tensor map takes (a base 4 bytes off 16) the FMA route, within the
    same float32 tolerance."""
    q, k, v = _flash_inputs(cuda_device, 1, 1000, 1000, 2, 3, 128, 128, torch.float32, seed=4)
    kernel = kernels.KERNELS["flash_attention"]
    before = dict(kernel.route_launches)
    first = flash_attention(q, k, v)
    for _ in range(3):
        assert torch.equal(first, flash_attention(q, k, v))
    empty = flash_attention(q, k, v, kv_len=0)
    assert torch.equal(empty, torch.zeros_like(empty))
    assert kernel.route_launches == dict(before, tf32x3=before["tf32x3"] + 5)
    flat = torch.empty((q.numel() + 1,), device=cuda_device)
    q_off = flat[1:].view(q.shape)
    q_off.copy_(q)
    out = flash_attention(q_off, k, v)
    assert kernel.route_launches == dict(before, tf32x3=before["tf32x3"] + 5, fma=before["fma"] + 1)
    torch.testing.assert_close(out, first, rtol=1e-4, atol=1e-4)
    want = flash_attention_ref(q.double(), k.double(), v.double())
    torch.testing.assert_close(out.double(), want, rtol=2e-5, atol=2e-5)
    torch.testing.assert_close(first.double(), want, rtol=2e-5, atol=2e-5)


def test_flash_wrapper_raises_instead_of_falling_back(cuda_device, monkeypatch):
    """Bad dtypes, shapes and devices raise on the card, a failed launch
    raises on either route, and none of them counts a launch."""
    from repro_torch.kernels.flash_attention import ops as flash_ops

    q, k, v = _flash_inputs(cuda_device, 1, 64, 64, 2, 2, 32, 32, torch.float32)
    kernel = kernels.KERNELS["flash_attention"]
    before, routes = kernel.launches, dict(kernel.route_launches)
    for bad in ((q.half(), k.half(), v.half()), (q.double(), k.double(), v.double()),
                (q, k.to(torch.bfloat16), v), (q, k, v.cpu())):
        with pytest.raises(TypeError):
            flash_attention(*bad)
    with pytest.raises(ValueError):
        flash_attention(q, k[..., :16], v)  # hd disagrees
    big = torch.zeros((1, 8, 1, 1, 320), device=cuda_device)
    with pytest.raises(ValueError):
        flash_attention(big, big[:, :, :, 0], big[:, :, :, 0])  # hd > 256
    with pytest.raises(ValueError):
        flash_attention(q.transpose(-1, -2).contiguous().transpose(-1, -2), k, v)
    q16, k16, v16 = _flash_inputs(cuda_device, 1, 64, 64, 2, 2, 64, 64, torch.bfloat16)
    q32, k32, v32 = _flash_inputs(cuda_device, 1, 64, 64, 2, 2, 64, 64, torch.float32)
    assert flash_ops._route(q16, k16, v16) == "tensor_core"
    assert flash_ops._route(q32, k32, v32) == "tf32x3"
    assert flash_ops._route(q, k, v) == "fma"
    for route in flash_ops.ROUTES:
        lib, _ = flash_ops._entry(route)
    monkeypatch.setattr(flash_ops, "_entry", lambda route: (lib, lambda *args: 9))
    for args in ((q, k, v), (q16, k16, v16), (q32, k32, v32)):
        with pytest.raises(RuntimeError, match="CUDA error 9"):
            flash_attention(*args)
    assert kernel.launches == before and kernel.route_launches == routes


def test_lm_serving_path_on_card_matches_cpu(cuda_device):
    """The reduced llama3.2-3b with attn_chunk=32: prefill launches the flash
    kernel once per layer and decode never; logits match the CPU run of the
    same weights (float32, 1e-4: matrix products in another order)."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.models.lm import model as mdl
    from repro_torch.models.lm import steps
    from repro_torch.models.lm.config import reduced

    cfg = reduced(get_config("llama3_2_3b"), attn_chunk=32)
    cpu = mdl.init_params(cfg, generator=torch.Generator().manual_seed(0), device="cpu")
    card = mdl.init_params(cfg, device=cuda_device)
    card.load_state_dict(cpu.state_dict())
    tok = torch.randint(0, cfg.vocab_size, (2, 80), generator=torch.Generator().manual_seed(1))
    k = kernels.KERNELS["flash_attention"]
    before = k.launches
    state = steps.serve_prefill(card, {"tokens": tok.to(cuda_device)}, 84)
    assert k.launches == before + cfg.num_layers
    state_cpu = steps.serve_prefill(cpu, {"tokens": tok}, 84)
    torch.testing.assert_close(state.logits.cpu(), state_cpu.logits, rtol=1e-4, atol=1e-4)
    for _ in range(3):  # teacher forcing: the CPU step is fed the card's token
        fed = state.last_token
        state, logits = steps.serve_decode_step(card, state)
        state_cpu, logits_cpu = steps.serve_decode_step(
            cpu, state_cpu._replace(last_token=fed.cpu()))
        torch.testing.assert_close(logits.cpu(), logits_cpu, rtol=1e-4, atol=1e-4)
    assert k.launches == before + cfg.num_layers
    bf16 = dataclasses.replace(cfg, dtype="bfloat16", param_dtype="bfloat16")
    card16 = mdl.init_params(bf16, generator=torch.Generator(device=cuda_device).manual_seed(0),
                             device=cuda_device)
    state16 = steps.serve_prefill(card16, {"tokens": tok.to(cuda_device)}, 84)
    assert state16.logits.dtype == torch.bfloat16 and bool(torch.isfinite(state16.logits).all())


def _logreg_backend(device, *, seed=0):
    """A fresh chunk backend on logreg shards (M = 10, n = 10,000): its first
    setup captures the warmup loop and its first chunk the collection loop."""
    from repro_torch.api.backends import BatchedChunkBackend
    from repro_torch.api.sampling import make_shard_kernel
    from repro_torch.core.subposterior import partition_data
    from repro_torch.models.bayes import get_model

    model = get_model("logreg")
    data, _ = model.generate_data(torch.Generator(device=device).manual_seed(seed), 10_000)
    shards, counts = partition_data(data, 10, only=model.shard_keys, pad=True)
    sk = make_shard_kernel(model, 10, "mala", use_counts=False)
    return BatchedChunkBackend(sk, shards, counts, burn_in=20, warmup=30, step_size=0.1)


def test_reader_launches_during_captures_keep_counts_exact(cuda_device):
    """A reader thread launches the KDE kernel (under CAPTURE_LOCK, as the
    posterior server's handlers do) in a loop while the sampler thread
    builds and captures its warmup and collection loops and replays them:
    no error on either thread, both loops captured, and every count exact:
    the reader's launches all counted, none moved into the graphs' replays,
    the likelihood once per init and transition."""
    import threading

    from repro_torch.samplers.base import CAPTURE_LOCK

    gen = torch.Generator(device=cuda_device).manual_seed(3)
    q = torch.randn((1, 50), generator=gen, device=cuda_device)
    s = 0.1 * torch.randn((10, 240, 50), generator=gen, device=cuda_device)
    h = torch.full((10,), 0.05, device=cuda_device)
    want = machine_kde_log_density(q, s, h, reduce="product", mixture_weights="uniform")
    machine, lr = (kernels.KERNELS[n] for n in ("machine_kde_log_density",
                                                   "logreg_loglik_grad"))
    backend = _logreg_backend(cuda_device)
    before = (machine.launches, lr.launches)
    done, errors, reads = threading.Event(), [], []

    def reader():
        try:
            while not done.is_set() or len(reads) < 50:
                with CAPTURE_LOCK:
                    out = machine_kde_log_density(q, s, h, reduce="product",
                                                  mixture_weights="uniform")
                    reads.append(bool(torch.equal(out, want)))
        except Exception as exc:  # reported below
            errors.append(exc)

    thread = threading.Thread(target=reader)
    thread.start()
    try:
        theta, _ = backend.run_fused(torch.Generator(device=cuda_device).manual_seed(4), 60)
        torch.cuda.synchronize()
    finally:
        done.set()
        thread.join(timeout=120)
    assert not thread.is_alive() and not errors, errors
    assert all(reads) and len(reads) >= 50
    assert all(loop.graph is not None for loop in backend.loops()) and len(backend.loops()) == 2
    assert machine.launches - before[0] == len(reads)
    assert lr.launches - before[1] == 2 + 30 + 20 + 60
    assert bool(torch.isfinite(theta).all())


def test_a_queued_chunk_is_not_overwritten_by_later_chunks(cuda_device):
    """A chunk can wait in the server's queue while the chains run on: its
    θ must not view a tensor that a later replay or the loop's state
    overwrites. Each chunk kept (not copied) as it landed equals its rows of
    the final draws, and does not share storage with the loop."""
    from repro_torch.api import Pipeline, RunSpec

    spec = RunSpec(model="logreg", sampler="mala", M=4, T=200, warmup=30, n=2000,
                   groundtruth_T=100, seed=0, stream_every=40, combiner="parametric")
    pipe = Pipeline(spec, device=cuda_device)
    landed = []
    draws = pipe.sample(on_chunk=(landed.append,))
    torch.cuda.synchronize()
    assert [(ev.t0, ev.t1) for ev in landed] == [(t, t + 40) for t in range(0, 200, 40)]
    for ev in landed:
        assert torch.equal(ev.theta, draws.theta[:, ev.t0:ev.t1]), (ev.t0, ev.t1)
    ptrs = {ev.theta.untyped_storage().data_ptr() for ev in landed}
    assert len(ptrs) == len(landed)  # one fresh tensor a chunk
    assert draws.theta.untyped_storage().data_ptr() not in ptrs


# flash_attention_bwd (the training path's attention backward) and the forward's lse:
# the cases, checks and tolerances of ``repro_torch.launch.flash_bwd_probe``
# (the backward on the forward kernel's out and lse against the plain
# version in float64 and in the case's dtype: float32 2e-4, bf16 2e-2 of
# max|g| plus as much of |g|; lse 1e-4 + 1e-5·|lse|), at a few shapes. A
# case the bf16 tensor-core route takes (hd=64, G=8, kv_len=777, kv_len=0)
# runs on it and on the FMA route, each held to the plain version, the two
# to each other within the same tolerance, and one launch a call counted on
# its route; kv_len = 0 gives exactly zero gradients on both.
FLASH_BWD_CASES = ["hd=64", "float32 S=T=1000", "hd=192 hd_v=128", "G=8",
                   "non-causal kv_len=777 T=1000", "kv_len=17 hd=36 hd_v=20", "kv_len=0",
                   "granite training path", "deepseek MLA training path",
                   "jamba training path", "whisper encoder training path",
                   "whisper encoder training path float32", "G=4 S=T=4672 causal"]


@pytest.mark.parametrize("label", FLASH_BWD_CASES)
def test_flash_bwd_kernel_matches_plain(cuda_device, label):
    from repro_torch.launch import flash_bwd_probe as probe

    gen = torch.Generator(device=cuda_device).manual_seed(3)
    _, _, ok = probe.check_case(gen, label, probe.CASES[label], log=lambda m: None)
    assert ok  # kv_len = 0: every gradient exactly zero


def test_flash_bwd_kernel_is_deterministic_and_counted(cuda_device):
    """Three launches at S = T = 1,000 in bf16 give the same bits, each
    counted once, on the tensor-core route; the FMA route's three the same
    bits too."""
    from repro_torch.kernels.flash_attention import ops
    from repro_torch.launch import flash_bwd_probe as probe

    gen = torch.Generator(device=cuda_device).manual_seed(4)
    q, k, v, dout = probe.operands(gen, 1, 1000, 1000, 2, 3, 128, 128, torch.bfloat16)
    out, lse = flash_attention(q, k, v, return_lse=True)
    kernel = kernels.KERNELS["flash_attention_bwd"]
    before, routes = kernel.launches, dict(kernel.route_launches)
    runs = [flash_attention_bwd(q, k, v, out, lse, dout) for _ in range(3)]
    torch.cuda.synchronize()
    assert kernel.launches == before + 3  # one a call: both kernels counted once
    assert kernel.route_launches == dict(routes, tensor_core=routes["tensor_core"] + 3)
    assert all(torch.equal(a, b) for run in runs[1:] for a, b in zip(run, runs[0]))
    fma = [ops._launch_bwd(q, k, v, out, lse, dout, True, 1000, route="fma") for _ in range(3)]
    torch.cuda.synchronize()
    assert kernel.route_launches == dict(routes, tensor_core=routes["tensor_core"] + 3,
                                         fma=routes["fma"] + 3)
    assert all(torch.equal(a, b) for run in fma[1:] for a, b in zip(run, fma[0]))


def test_flash_bwd_tc_plan_is_the_sources_and_refusals_raise(cuda_device):
    """The wrapper's mirror of the tensor-core backward's plan (blocks,
    threads, shared memory, scratch) is the C source's at every head-dim
    pair; a pair the mirror refuses the source refuses too, and a launch of
    it raises with nothing counted. A float32 call named onto the route
    raises before the launch."""
    from repro_torch.kernels.flash_attention import ops

    lib = ops._bwd_entry("tensor_core")[0]
    plan = (ctypes.c_longlong * 4)()
    for hd in (32, 64, 96, 128, 192, 256):
        for hd_v in (64, 128, 256):
            for shape in ((1, 4096, 4096, 8, 3), (2, 70, 90, 2, 3), (1, 1, 1, 1, 64)):
                for i, kern in enumerate(("dq", "dkdv")):
                    want = ops.bwd_tc_plan(kern, *shape, hd, hd_v)
                    err = lib.flash_attention_bwd_tc_plan(i, *shape, hd, hd_v, plan)
                    if want is None:
                        assert err != 0, (kern, shape, hd, hd_v)
                    else:
                        assert err == 0 and tuple(plan) == tuple(want), (kern, shape, hd, hd_v)
                        assert want.smem <= 232_448
    kernel = kernels.KERNELS["flash_attention_bwd"]
    gen = torch.Generator(device=cuda_device).manual_seed(7)
    for hd, dtype, exc in ((96, torch.bfloat16, RuntimeError), (128, torch.float32, TypeError)):
        q, k, v, dout = (x.to(dtype) for x in _bwd_inputs(gen, cuda_device, hd))
        out, lse = flash_attention(q, k, v, return_lse=True)
        before = dict(kernel.route_launches)
        with pytest.raises(exc):
            ops._launch_bwd(q, k, v, out, lse, dout, True, 130, route="tensor_core")
        assert kernel.route_launches == before


def _bwd_inputs(gen, device, hd):
    return (torch.randn(shape, generator=gen, device=device)
            for shape in ((1, 130, 2, 3, hd), (1, 130, 2, hd), (1, 130, 2, hd),
                          (1, 130, 2, 3, hd)))


def test_flash_lse_on_every_route(cuda_device):
    from repro_torch.launch import flash_bwd_probe as probe

    gen = torch.Generator(device=cuda_device).manual_seed(5)
    assert probe.check_lse(gen, log=lambda m: None)[1]


def test_model_flash_gradient_goes_through_the_kernels(cuda_device):
    """The model's autograd Function: one forward launch (with lse) and one
    backward launch, on the tensor-core route, and the gradients of the
    plain version within bf16's tolerance."""
    from repro_torch.models.lm.flash import flash_attention as model_flash

    gen = torch.Generator(device=cuda_device).manual_seed(6)
    q, k, v = (torch.randn(shape, generator=gen, device=cuda_device).to(torch.bfloat16)
               for shape in ((1, 300, 2, 3, 128), (1, 300, 2, 128), (1, 300, 2, 128)))
    fwd, bwd = kernels.KERNELS["flash_attention"], kernels.KERNELS["flash_attention_bwd"]
    counts, routes = (fwd.launches, bwd.launches), dict(bwd.route_launches)
    leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    model_flash(*leaves).float().square().sum().backward()
    torch.cuda.synchronize()
    assert (fwd.launches, bwd.launches) == (counts[0] + 1, counts[1] + 1)
    assert bwd.route_launches == dict(routes, tensor_core=routes["tensor_core"] + 1)
    plain = [x.double().requires_grad_() for x in (q, k, v)]
    flash_attention_ref(*plain).square().sum().backward()
    for got, want in zip(leaves, plain):
        err = float((got.grad.double() - want.grad).abs().max())
        assert err <= 3e-2 * float(want.grad.abs().max())


def _moe_pair(device, *, capacity_factor=None, zero_router=False):
    """The reduced granite-moe-1b-a400m MoE layer (8 experts top-2, group 16,
    float32) on the CPU and a copy of it on ``device``."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.models.lm import moe as moe_lib
    from repro_torch.models.lm.config import reduced

    cfg = reduced(get_config("granite_moe_1b"))
    if capacity_factor is not None:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe,
                                                               capacity_factor=capacity_factor))
    cpu = moe_lib.MoE(cfg, generator=torch.Generator().manual_seed(0), device="cpu")
    if zero_router:
        with torch.no_grad():
            cpu.router.zero_()
    card = moe_lib.MoE(cfg, device=device)
    card.load_state_dict(cpu.state_dict())
    return cfg, cpu, card


@pytest.mark.parametrize("cf", [4.0, 0.5], ids=["dropless", "drops"])
def test_moe_layer_on_card_routes_as_on_cpu(cuda_device, cf):
    """The same MoE layer and tokens (a padded last group) on the card and
    on the CPU: equal routing (top-k indices and the dispatch mask: which
    pair holds which slot), y and aux within float32 rounding (1e-5 of
    max|y|; cuBLAS sums in another order)."""
    from repro_torch.models.lm import moe as moe_lib

    cfg, cpu, card = _moe_pair(cuda_device, capacity_factor=cf)
    x = torch.randn((3, 37, cfg.d_model), generator=torch.Generator().manual_seed(1)) * 0.5
    with torch.no_grad():
        want_plan, want = moe_lib.plan(cpu, x), moe_lib.moe_forward(cpu, x)
        got_plan, got = moe_lib.plan(card, x.to(cuda_device)), moe_lib.moe_forward(
            card, x.to(cuda_device))
    assert torch.equal(got_plan.top_idx.cpu(), want_plan.top_idx)
    assert torch.equal(got_plan.dispatch.cpu(), want_plan.dispatch)
    scale = float(want[0].abs().max())
    torch.testing.assert_close(got[0].cpu(), want[0], rtol=1e-5, atol=1e-5 * scale)
    torch.testing.assert_close(got[1].cpu(), want[1], rtol=1e-5, atol=0)


def test_moe_zero_router_ties_go_to_the_lower_expert_on_card(cuda_device):
    """A zero router ties all 8 experts on every token (padding included):
    the card's top-2 is experts 0 and 1, in that order, as ``jax.lax.top_k``
    gives it, and the aux loss exactly 1."""
    from repro_torch.models.lm import moe as moe_lib

    cfg, _, card = _moe_pair(cuda_device, capacity_factor=0.5, zero_router=True)
    x = torch.randn((2, 29, cfg.d_model), generator=torch.Generator().manual_seed(2))
    with torch.no_grad():
        plan = moe_lib.plan(card, x.to(cuda_device))
        y, aux = moe_lib.moe_forward(card, x.to(cuda_device))
    assert bool((plan.top_idx == torch.arange(cfg.moe.top_k, device=cuda_device)).all())
    assert float(aux) == 1.0 and bool(torch.isfinite(y).all())
    probs = torch.full((64, cfg.moe.num_experts), 1.0 / cfg.moe.num_experts, device=cuda_device)
    assert moe_lib.top_k(probs, 3)[1].tolist() == [[0, 1, 2]] * 64



def test_compress_lowrank_on_card_matches_cpu(cuda_device):
    """``compress_lowrank`` and ``error_feedback_update`` on the card against
    the same calls on the CPU, the same ``q0``: P Qᵀ and the residual within
    float32 rounding (1e-5 of max|g|; cuBLAS and cuSOLVER sum in other
    orders than the CPU's LAPACK), a bf16 leaf within one bf16 rounding,
    P up to its columns' signs."""
    from repro_torch.optim import compress_lowrank, decompress_lowrank, error_feedback_update

    gen = torch.Generator().manual_seed(5)
    g = torch.randn((512, 384), generator=gen)
    q0 = torch.randn((384, 8), generator=gen)
    pair, resid = compress_lowrank(None, g, 8, q0=q0)
    card, card_resid = compress_lowrank(None, g.to(cuda_device), 8, q0=q0.to(cuda_device))
    scale = float(g.abs().max())
    torch.testing.assert_close(decompress_lowrank(card, g.shape).cpu(),
                               decompress_lowrank(pair, g.shape), rtol=1e-5, atol=1e-5 * scale)
    torch.testing.assert_close(card_resid.cpu(), resid, rtol=1e-5, atol=1e-5 * scale)
    signs = torch.sign((card.p.cpu() * pair.p).sum(0))
    torch.testing.assert_close(card.p.cpu() * signs, pair.p, rtol=1e-4, atol=1e-4)
    grads = {"w": g, "b16": torch.randn((256, 128), generator=gen).bfloat16(),
             "v": torch.randn((64,), generator=gen)}
    err = {n: 0.1 * torch.randn(t.shape, generator=gen) for n, t in grads.items()}
    proj = {"w": q0, "b16": torch.randn((128, 8), generator=gen)}
    want_out, want_err = error_feedback_update(None, grads, err, 8, q0=proj)
    out, new_err = error_feedback_update(
        None, {n: t.to(cuda_device) for n, t in grads.items()},
        {n: t.to(cuda_device) for n, t in err.items()}, 8,
        q0={n: t.to(cuda_device) for n, t in proj.items()})
    for n in grads:
        tol = 2 ** -8 if n == "b16" else 1e-5
        s = float(want_out[n].float().abs().max())
        assert out[n].dtype == grads[n].dtype and new_err[n].dtype == torch.float32
        torch.testing.assert_close(out[n].cpu().float(), want_out[n].float(), rtol=tol,
                                   atol=tol * s)
        torch.testing.assert_close(new_err[n].cpu(), want_err[n], rtol=tol, atol=tol * s)
