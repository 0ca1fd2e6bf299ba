"""The port's sampler registry against repro's, and repro's conformance contract.

- The registry: the same canonical and alias names and the same metadata
  (adaptive, target acceptance) as ``repro``'s.
- ``repro``'s conformance contract (``tests/test_sampler_registry.py``)
  mirrored for every canonical sampler on the same 2-d Gaussian, over 4
  batched chains: accept_prob in [0, 1], fixed-seed determinism, the warmup
  band of every adaptive sampler, analytic moments. ``sgld`` is held to the
  analytic moments, not to the JAX ``sgld``'s output (that reference test
  fails on this stack).

The transitions themselves against ``repro``'s are in
``tests/test_torch_sampler_steps.py``.
"""

import functools

import numpy as np
import pytest
import torch

from repro.samplers import available_samplers as jax_available_samplers
from repro.samplers import canonical_samplers as jax_canonical_samplers
from repro.samplers import sampler_spec as jax_sampler_spec
from repro_torch.samplers import (
    available_samplers,
    canonical_samplers,
    filter_options,
    get_sampler,
    mh_within_gibbs_update,
    run_chain,
    run_chains,
    sampler_spec,
)
from test_torch_threads import pin_torch_threads

pin_torch_threads()  # this worker's share of the cores under a parallel run

MEAN = np.array([1.0, -2.0], np.float32)
STD = np.array([0.8, 1.4], np.float32)


def logpdf(theta):
    return -0.5 * (((theta - torch.from_numpy(MEAN)) / torch.from_numpy(STD)) ** 2).sum(dim=-1)


def _gibbs_blocks(step_size=1.2):
    """Per-coordinate MH-within-Gibbs blocks for the 2-d Gaussian target."""
    return [
        mh_within_gibbs_update(
            logpdf,
            select=lambda pos, i=i: pos[..., i:i + 1],
            replace=lambda pos, block, i=i: torch.cat([pos[..., :i], block, pos[..., i + 1:]], -1),
            step_size=step_size,
        )
        for i in (0, 1)
    ]


def _build(name):
    """Kernel + per-sampler options for the shared conformance target
    (repro's test's options)."""
    factory = get_sampler(name)
    options = {
        "rwmh": dict(step_size=0.8),
        "mala": dict(step_size=0.35),
        "hmc": dict(step_size=0.25, num_integration_steps=8),
        "gibbs": dict(block_updates=_gibbs_blocks()),
        "sgld": dict(step_size=0.05),
    }[name]
    return factory(logpdf, **filter_options(factory, options))


def test_registry_matches_reference():
    assert canonical_samplers() == jax_canonical_samplers()
    assert available_samplers() == jax_available_samplers()
    for name in available_samplers():
        t, j = sampler_spec(name), jax_sampler_spec(name)
        assert (t.name, t.adaptive, t.target_accept) == (j.name, j.adaptive, j.target_accept)
    with pytest.raises(KeyError, match="available"):
        sampler_spec("nope")


def _run(kern, seed, n=6000, burn_in=1500, **kw):
    return run_chains(torch.Generator().manual_seed(seed), kern, torch.zeros(4, 2), n,
                      burn_in=burn_in, **kw)


@pytest.mark.parametrize("name", sorted(canonical_samplers()))
def test_conformance_moments_probabilities_determinism(name):
    """4 chains of 6,000 after 1,500 burn-in: accept_prob in [0, 1], finite,
    pooled moments within repro's tolerances (mean 0.25, std 0.3), a rerun
    bitwise equal and another seed not."""
    kern = _build(name)
    pos, info = _run(kern, 0)
    assert float(info.accept_prob.min()) >= 0.0 and float(info.accept_prob.max()) <= 1.0
    assert torch.isfinite(pos).all()
    pooled = pos.reshape(-1, 2)
    np.testing.assert_allclose(pooled.mean(0).numpy(), MEAN, atol=0.25)
    np.testing.assert_allclose(pooled.std(0).numpy(), STD, atol=0.3)
    short, _ = _run(kern, 0, n=300, burn_in=100)
    assert torch.equal(short, _run(kern, 0, n=300, burn_in=100)[0])
    assert not torch.equal(short, _run(kern, 1, n=300, burn_in=100)[0])


@pytest.mark.parametrize("name", [n for n in sorted(canonical_samplers()) if sampler_spec(n).adaptive])
def test_warmup_reaches_target_acceptance_band(name):
    """From a hostile ε0 = 5 every chain lands within 0.15 of its target."""
    spec = sampler_spec(name)
    factory = functools.partial(lambda eps, f=spec.factory: f(logpdf, step_size=eps))
    _, info = _run(factory, 1, n=2000, burn_in=200, warmup=600, initial_step_size=5.0,
                   target_accept=spec.target_accept)
    acc = info.accept_prob.mean(dim=-1)
    assert torch.all((acc - spec.target_accept).abs() < 0.15), (name, acc)


def test_warmup_requires_a_factory_and_gibbs_its_blocks():
    with pytest.raises(TypeError, match="factory"):
        run_chain(torch.Generator(), _build("rwmh"), torch.zeros(2), 10, warmup=5)
    with pytest.raises(ValueError, match="block_updates"):
        get_sampler("gibbs")(logpdf)


def test_factory_filter_options_drops_unknown_keys():
    broadcast = dict(step_size=0.5, num_integration_steps=4, not_an_option=1)
    for name in canonical_samplers():
        factory = get_sampler(name)
        opts = filter_options(factory, broadcast)
        assert "not_an_option" not in opts
        if name == "gibbs":
            opts["block_updates"] = _gibbs_blocks()
        kern = factory(logpdf, **opts)
        _, info = kern.step(torch.Generator().manual_seed(0), kern.init(torch.zeros(3, 2)))
        assert torch.isfinite(info.accept_prob).all() and info.accept_prob.shape == (3,)
