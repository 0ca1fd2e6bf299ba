"""The chain loops the card runs as CUDA graphs, held on the CPU.

What a graph needs of the port's MALA transition, checked where no card is:
a step size read at every step (so the warmup can rewrite it in place inside
a captured transition), random inputs drawn apart from the step (outside the
graph, in the eager order), and launch counts that a capture does not
inflate and each replay raises. The graphed chains themselves are held
against an eager loop on the card (``tests/test_torch_cuda.py``).
"""

import sys
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.samplers.adaptation import warmup_chain as jax_warmup_chain
from repro.samplers.mala import mala_kernel as jax_mala
from repro_torch.api.backends import BatchedChunkBackend
from repro_torch.api.sampling import make_shard_kernel
from repro_torch.core.subposterior import partition_data
from repro_torch.kernels import KERNELS, Kernel, LaunchTally
from repro_torch.models.bayes import get_model
from repro_torch.samplers import (
    chain_collect,
    chain_setup,
    da_init,
    da_update,
    warmup_chain,
)
from repro_torch.samplers.base import TransitionLoop
from repro_torch.samplers.mala import mala_kernel
from test_torch_threads import pin_torch_threads

pin_torch_threads()  # this worker's share of the cores under a parallel run

MEAN = np.array([1.0, -2.0], dtype=np.float32)
STD = np.array([0.8, 1.4], dtype=np.float32)


def logpdf(theta):
    return -0.5 * (((theta - torch.from_numpy(MEAN)) / torch.from_numpy(STD)) ** 2).sum(dim=-1)


def jax_logpdf(theta):
    return -0.5 * jnp.sum(((theta - MEAN) / STD) ** 2)


def _equal(a, b):
    return all(torch.equal(x, y) for x, y in zip(a, b))


def test_step_size_rewritten_in_place_gives_the_rebuilt_kernels_bits():
    """One kernel on a (4, 1) step-size tensor, rewritten in place before each
    step, against a kernel built anew at each value: the same bits (state and
    info), on the same state and injected randomness."""
    rng = np.random.default_rng(0)
    eps = torch.full((4, 1), 0.3)
    kern = mala_kernel(logpdf, step_size=eps)
    state = kern.init(torch.from_numpy(rng.standard_normal((4, 2)).astype(np.float32)))
    for value in ([0.3, 0.3, 0.3, 0.3], [0.05, 0.7, 1.3, 0.2], [2.0, 0.01, 0.5, 0.9]):
        noise = torch.from_numpy(rng.standard_normal((4, 2)).astype(np.float32))
        log_u = torch.log(torch.from_numpy(rng.random(4).astype(np.float32)))
        eps.copy_(torch.tensor(value)[:, None])
        got = kern.step(None, state, noise, log_u)
        want = mala_kernel(logpdf, step_size=torch.tensor(value)[:, None]).step(
            None, state, noise, log_u)
        assert _equal(got[0], want[0]) and _equal(got[1], want[1])
        state = got[0]


def test_draw_gives_the_steps_own_random_inputs():
    """``step(gen, s, *draw(gen, s.position))`` is ``step(gen, s)`` bit for bit,
    with fresh tensors and with ``out=`` buffers alike."""
    kern = mala_kernel(logpdf, step_size=torch.full((3, 1), 0.4))
    state = kern.init(torch.zeros(3, 2))
    eager = kern.step(torch.Generator().manual_seed(5), state)
    gen = torch.Generator().manual_seed(5)
    fresh = kern.step(None, state, *kern.draw(gen, state.position))
    gen = torch.Generator().manual_seed(5)
    bufs = (torch.empty(3, 2), torch.empty(3))
    drawn = kern.draw(gen, state.position, out=bufs)
    assert drawn[0] is bufs[0] and drawn[1] is bufs[1]
    for got in (fresh, kern.step(None, state, *drawn)):
        assert _equal(got[0], eager[0]) and _equal(got[1], eager[1])


class _Injected:
    """A draw function that hands out fixed (noise, u) per step, in order."""

    def __init__(self, noise, u):
        self.noise, self.u, self.t = noise, u, 0

    def draw(self, gen, position, out=None):
        noise = torch.from_numpy(self.noise[self.t])
        log_u = torch.log(torch.from_numpy(self.u[self.t]))
        self.t += 1
        if out is None:
            return noise.clone(), log_u
        out[0].copy_(noise)
        out[1].copy_(log_u)
        return out


def test_warmup_with_in_place_step_size_matches_reference_on_its_draws():
    """repro's ``warmup_chain`` (dual averaging inside ``lax.scan``, the kernel
    rebuilt at the traced ε) and the port's (one kernel, ε rewritten in place
    inside each transition) on the 2-d Gaussian, 8 chains × 16 steps from
    ε0 = 1, fed JAX's own noise and uniforms. The same transitions in
    float32 in another order; dual averaging scales accept_prob's rounding by
    √t/γ, and later steps carry earlier rounding, so the comparison stops at
    16 steps (by 40 the chains part: ε swings over 0.5–10 early on). Measured
    1.0e-5 relative in ε and 3.5e-5 in position; held to 1e-3 on both."""
    W, K = 16, 8
    pos0 = np.random.default_rng(1).standard_normal((K, 2)).astype(np.float32)
    keys = jax.random.split(jax.random.PRNGKey(7), K)

    def factory(e):
        return jax_mala(jax_logpdf, step_size=e)

    def one(key, p):
        _, pos, eps = jax_warmup_chain(key, factory, p, W, initial_step_size=1.0,
                                       target_accept=0.55)
        return pos, eps

    jpos, jeps = jax.jit(jax.vmap(one))(keys, jnp.asarray(pos0))

    def draws(key):  # repro's mala step: split, normal of split(k_prop, 1)[0], uniform
        def per_step(k):
            k_prop, k_acc = jax.random.split(k)
            return (jax.random.normal(jax.random.split(k_prop, 1)[0], (2,)),
                    jax.random.uniform(k_acc))
        return jax.vmap(per_step)(jax.random.split(key, W))

    noise, u = jax.vmap(draws)(keys)  # (K, W, 2), (K, W)
    inj = _Injected(np.ascontiguousarray(np.asarray(noise).transpose(1, 0, 2)),
                    np.ascontiguousarray(np.asarray(u).T))
    kern, pos, eps = warmup_chain(
        torch.Generator(), lambda e: mala_kernel(logpdf, step_size=e)._replace(draw=inj.draw),
        torch.from_numpy(pos0), W, initial_step_size=1.0, target_accept=0.55)
    assert inj.t == W and eps.shape == (K, 1)
    np.testing.assert_allclose(eps[:, 0].numpy(), np.asarray(jeps), rtol=1e-3)
    np.testing.assert_allclose(pos.numpy(), np.asarray(jpos), atol=1e-3)


def test_warmup_loop_gives_the_bits_of_a_kernel_rebuilt_every_step():
    """The port's warmup against the loop it replaced, written out here: a
    kernel rebuilt at exp(log ε) before every step, drawing from the same
    generator. Bitwise: same position, same adapted ε."""
    pos0 = torch.from_numpy(np.random.default_rng(2).standard_normal((5, 2)).astype(np.float32))
    _, pos, eps = warmup_chain(torch.Generator().manual_seed(3),
                               lambda e: mala_kernel(logpdf, step_size=e), pos0, 50,
                               initial_step_size=2.0, target_accept=0.55)
    gen = torch.Generator().manual_seed(3)
    da = da_init(2.0, (5,))
    state = mala_kernel(logpdf, step_size=torch.exp(da.log_eps)[:, None]).init(pos0)
    for _ in range(50):
        kern = mala_kernel(logpdf, step_size=torch.exp(da.log_eps)[:, None])
        state, info = kern.step(gen, state)
        da = da_update(da, info.accept_prob, 0.55)
    assert torch.equal(pos, state.position)
    assert torch.equal(eps, torch.exp(da.log_eps_avg)[:, None])


def test_transition_loop_gives_the_eager_loops_bits_and_copies_out():
    """chain_setup + chain_collect (burn-in and collection loops) against
    ``kernel.step`` in a plain loop: the same draws, accept flags and final
    state; the state returned is a copy the loop no longer writes."""
    kern = mala_kernel(logpdf, step_size=0.6)
    pos0 = torch.zeros(3, 2)
    gen = torch.Generator().manual_seed(11)
    _, state, _ = chain_setup(gen, kern, pos0, burn_in=20)
    final, theta, info = chain_collect(gen, kern, state, 40, thin=2)
    gen = torch.Generator().manual_seed(11)
    s = kern.init(pos0)
    for _ in range(20):
        s, _ = kern.step(gen, s)
    rows, accs = [], []
    for _ in range(40):
        for _ in range(2):
            s, i = kern.step(gen, s)
        rows.append(s.position)
        accs.append(i.is_accepted)
    assert torch.equal(theta, torch.stack(rows, dim=1))
    assert torch.equal(info.is_accepted, torch.stack(accs, dim=-1))
    assert info.accept_prob.shape == (3, 40) and info.log_density.shape == (3, 40)
    assert _equal(final, s)
    loop = TransitionLoop(kern, final)
    loop.step(gen)
    assert _equal(final, s)  # the loop works on its own copy


def test_a_kernel_without_draw_runs_on_the_cpu_and_draws_in_its_step():
    kern = mala_kernel(logpdf, step_size=0.5)
    bare = kern._replace(draw=None)
    _, a, _ = chain_collect(torch.Generator().manual_seed(0), bare, kern.init(torch.zeros(2, 2)), 25)
    _, b, _ = chain_collect(torch.Generator().manual_seed(0), kern, kern.init(torch.zeros(2, 2)), 25)
    assert torch.equal(a, b)


def _kernels(**routes):
    """Stand-in kernels (never built), by name, with their routes."""
    ks = {name: Kernel(name, f"{name}.cu", replaces="") for name in routes}
    for name, rs in routes.items():
        ks[name].route_launches.update({r: 0 for r in rs})
    return ks


def test_launch_tally_discards_capture_and_adds_per_replay():
    """What wrappers count during a capture is kept apart as the graph's;
    each replay adds it, launches and launches by route alike."""
    ks = _kernels(a=(), b=("tc", "fma"))
    ks["a"].launches, ks["b"].launches, ks["b"].route_launches["fma"] = 7, 3, 3
    tally = LaunchTally(ks)
    with tally.capturing():
        ks["a"].count_launch()  # two launches of a in the captured transition
        ks["a"].count_launch()
        ks["b"].count_launch("tc")
    assert ks["a"].launches == 7 and ks["b"].launches == 3
    assert ks["b"].route_launches == {"tc": 0, "fma": 3}
    for _ in range(3):
        tally.replay()
    assert ks["a"].launches == 7 + 6 and ks["b"].launches == 3 + 3
    assert ks["b"].route_launches == {"tc": 3, "fma": 3}


def test_launch_tally_takes_back_a_failed_capture():
    ks = _kernels(a=())
    tally = LaunchTally(ks)
    with pytest.raises(RuntimeError):
        with tally.capturing():
            ks["a"].count_launch()
            raise RuntimeError("capture failed")
    assert ks["a"].launches == 0
    ks["a"].count_launch()  # the thread counts as usual after the capture
    assert ks["a"].launches == 1


def test_launch_tally_defaults_to_the_ports_kernels():
    tally = LaunchTally()
    assert tally.kernels is KERNELS
    before = {n: k.launches for n, k in KERNELS.items()}
    with tally.capturing():
        KERNELS["logreg_loglik_grad"].count_launch()
    assert {n: k.launches for n, k in KERNELS.items()} == before
    tally.replay()
    assert KERNELS["logreg_loglik_grad"].launches == before["logreg_loglik_grad"] + 1
    KERNELS["logreg_loglik_grad"].launches -= 1


def test_other_threads_count_during_a_capture():
    """A capture tallies its own thread's launches only: launches that other
    threads count meanwhile (a server's readers beside its sampler) land in
    the shared counts, none lost, none moved into the graph's replays. Many
    threads at a short switch interval raise one kernel's count at once."""
    ks = _kernels(a=("r",), b=())
    tally = LaunchTally(ks)
    n_threads, n_each = 16, 2000
    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with tally.capturing():
            ks["b"].count_launch()  # the capturing thread's own launch
            threads = [threading.Thread(target=lambda: [ks["a"].count_launch("r")
                                                        for _ in range(n_each)])
                       for _ in range(n_threads)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=60)
            assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(switch)
    assert ks["a"].launches == n_threads * n_each
    assert ks["a"].route_launches == {"r": n_threads * n_each}
    assert ks["b"].launches == 0 and tally.launches == {"b": 1}
    tally.replay()
    assert ks["b"].launches == 1 and ks["a"].launches == n_threads * n_each


def test_chunk_backend_keeps_one_collection_loop_across_chunks():
    """Four chunks of the chunk backend run one collection loop (on the card:
    one captured graph) and give the fused run's θ bitwise."""
    model = get_model("logreg")
    data, _ = model.generate_data(torch.Generator().manual_seed(0), 300)
    shards, counts = partition_data(data, 3, only=model.shard_keys, pad=True)
    sk = make_shard_kernel(model, 3, "mala")

    def backend():
        return BatchedChunkBackend(sk, shards, counts, burn_in=5, warmup=12, step_size=0.1)

    chunked = backend()
    gen = torch.Generator().manual_seed(9)
    state, eps = chunked.setup(gen)
    parts, loops = [], []
    for n in (10, 10, 10, 7):
        state, theta, _ = chunked.next_chunk(gen, eps, state, n)
        parts.append(theta)
        loops.append(chunked._loop)
    assert len({id(x) for x in loops}) == 1
    fused, _ = backend().run_fused(torch.Generator().manual_seed(9), 37)
    assert torch.equal(torch.cat(parts, dim=1), fused)
