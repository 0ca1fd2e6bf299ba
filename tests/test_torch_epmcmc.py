"""repro_torch.distributed.epmcmc's combine step against repro's.

``combine_gathered``, ``combine_stream`` and ``stack_subset_history`` take
the same numpy inputs in both packages. The two draw from different random
streams (a torch.Generator against a JAX key), so the deterministic part is
what is compared: the Gaussian product moments of ``parametric`` and of the
``online`` moments, within float32 tolerance (rtol 1e-4, atol 1e-5: a
product of M precision matrices rounds in a different order); the history
stack exactly. The shape errors carry repro's messages.
"""

import jax
import numpy as np
import pytest
import torch

from repro.distributed import epmcmc as ref
from repro_torch.distributed import epmcmc
from test_torch_threads import pin_torch_threads

pin_torch_threads()  # this worker's share of the cores under a parallel run

RTOL, ATOL = 1e-4, 1e-5


def _draws(M=4, T=300, d=3, seed=0):
    rng = np.random.default_rng(seed)
    centre = rng.normal(size=(M, 1, d))
    return (centre + 0.3 * rng.normal(size=(M, T, d))).astype(np.float32)


def _close(got, want):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("combiner", ["parametric", "online"])
def test_combine_gathered_moments_match_reference(combiner):
    x = _draws()
    got = epmcmc.combine_gathered(torch.Generator().manual_seed(0), torch.from_numpy(x), 200,
                                  combiner=combiner, rescale=True, n_batch=4)
    want = ref.combine_gathered(jax.random.PRNGKey(0), x, 200, combiner=combiner,
                                rescale=True, n_batch=4)
    assert tuple(got.samples.shape) == tuple(want.samples.shape) == (200, 3)
    _close(got.moments.mean, want.moments.mean)
    _close(got.moments.cov, want.moments.cov)


@pytest.mark.parametrize("combiner", ["parametric", "online"])
def test_combine_stream_moments_match_reference(combiner):
    x = _draws(T=240)
    chunks = [x[:, t:t + 60] for t in range(0, 240, 60)]
    got = epmcmc.combine_stream(torch.Generator().manual_seed(1),
                                [torch.from_numpy(c) for c in chunks], 100, combiner=combiner)
    want = ref.combine_stream(jax.random.PRNGKey(1), chunks, 100, combiner=combiner)
    _close(got.moments.mean, want.moments.mean)
    _close(got.moments.cov, want.moments.cov)


def test_combine_stream_is_combine_gathered_for_a_buffered_combiner():
    x = torch.from_numpy(_draws(T=120))
    gathered = epmcmc.combine_gathered(torch.Generator().manual_seed(2), x, 80,
                                       combiner="parametric")
    streamed = epmcmc.combine_stream(torch.Generator().manual_seed(2),
                                     [x[:, :50], x[:, 50:]], 80, combiner="parametric")
    assert torch.equal(gathered.samples, streamed.samples)


def test_stack_subset_history_matches_reference():
    rng = np.random.default_rng(3)
    snaps = [rng.normal(size=(4, 5)).astype(np.float32) for _ in range(7)]
    got = epmcmc.stack_subset_history([torch.from_numpy(s) for s in snaps])
    want = np.asarray(ref.stack_subset_history(snaps))
    assert got.shape == (4, 7, 5) and np.array_equal(got.numpy(), want)


def test_shape_errors_match_reference():
    x = torch.from_numpy(_draws())
    for fn in (lambda: epmcmc.combine_gathered(torch.Generator(), x[0], 10),
               lambda: ref.combine_gathered(jax.random.PRNGKey(0), x[0].numpy(), 10)):
        with pytest.raises(ValueError, match=r"combine_gathered needs \(M, T, d_sub\) samples"):
            fn()
    with pytest.raises(ValueError, match=r"folds \(M, C, d_sub\) chunks"):
        epmcmc.combine_stream(torch.Generator(), [x[0]], 10)
    with pytest.raises(ValueError, match="at least one chunk"):
        epmcmc.combine_stream(torch.Generator(), [], 10)
    with pytest.raises(ValueError, match="at least one snapshot"):
        epmcmc.stack_subset_history([])
