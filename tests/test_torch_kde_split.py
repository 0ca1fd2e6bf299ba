"""The arithmetic of the card's KDE kernel, modelled in PyTorch on the CPU.

``csrc/kde_density.cu`` forms the squared distances as ‖q_c‖² + ‖s_c‖² −
2q_c·s_c on operands centred by each machine's centre, with the cross term
as 3×TF32 on the tensor cores (hi·lo + lo·hi + hi·hi of TF32 halves rounded
to nearest, float32 accumulation). ``ref.machine_kde_log_density_split``
models that arithmetic; it runs here, where the kernel cannot. At the scale
of ``chip_smoke.py``'s ``kde_inputs`` (d = 50, M = 10, T = 1,200, draws
~√50 from the origin with a spread of 0.03, Silverman h ≈ 0.025), built with
numpy from a seed:

- the centred 3×TF32 model is within the card's float64 tolerance (atol
  1e-3 on log p̂, ×M for the product over machines; rtol 1e-5);
- the uncentred float32 identity and one TF32 pass are not: the ground for
  centring and for three passes;
- the model agrees with ``repro``'s reference (JAX on the CPU, the
  uncentred identity in float32) at the tolerance ``chip_smoke.py`` holds
  the kernel to against the float32 plain version: 16 × the cancellation
  term ε·(max‖q‖² + max‖s‖²)/2h², ε = 2^-23 (×M for the product);
- NaN beyond ``counts`` and an empty machine stay inert.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.kde_density import machine_kde_log_density_ref as jax_machine_ref
from repro_torch import kernels
from repro_torch.core.combiners import masked_silverman
from repro_torch.kernels.kde_density import machine_kde_log_density_ref
from repro_torch.kernels.kde_density.ref import kde_centres, machine_kde_log_density_split
from repro_torch.kernels.tf32 import tf32_round, tf32_split
from test_torch_threads import pin_torch_threads

pin_torch_threads()  # this worker's share of the cores under a parallel run

REDUCES = ["none", "product", "mixture", "product_mixture"]
M, T, D, Q = 10, 1200, 50, 400
EPS32 = 2.0**-23


def _tf32_round_np(x):
    """Round to 11 significant bits, ties away from zero, by float64
    arithmetic on the exponent and significand (not on the bit pattern)."""
    x = np.asarray(x, np.float64)
    m, e = np.frexp(x)  # x = m·2^e, 0.5 <= |m| < 1
    r = np.sign(m) * np.floor(np.abs(m) * 2.0**11 + 0.5) / 2.0**11
    return np.ldexp(r, e).astype(np.float32)


def _path_scale(seed=0, *, ragged=False):
    """kde_inputs' scale: a centre ~N(0, I), machine offsets and spread 0.03,
    queries drawn from the pooled rows, Silverman bandwidths; ragged adds
    NaN beyond counts with an empty and a single-row machine."""
    rng = np.random.default_rng(seed)
    centre = rng.standard_normal(D)
    s = (centre + 0.03 * rng.standard_normal((M, 1, D))
         + 0.03 * rng.standard_normal((M, T, D))).astype(np.float32)
    q = s.reshape(M * T, D)[rng.integers(0, M * T, Q)].copy()
    counts = np.full(M, T, np.int32)
    h = masked_silverman(torch.from_numpy(s), torch.from_numpy(counts)).numpy()
    if ragged:  # as chip_smoke.py's ragged case: bandwidths drawn in [0.02, 0.05]
        counts = rng.integers(2, T + 1, M).astype(np.int32)
        counts[1], counts[2] = 0, 1
        s = np.where(np.arange(T)[None, :, None] < counts[:, None, None], s, np.nan).astype(np.float32)
        h = (0.02 + 0.03 * rng.random(M)).astype(np.float32)
    return q, s, h, counts


def _as_tuple(out):
    return out if isinstance(out, tuple) else (out,)


def _outs(reduce):
    return reduce.split("_")  # product_mixture returns (product, mixture)


def _max_err(got, want):
    """max |got − want| over the finite entries of want, with −inf in the same
    places on both sides and no NaN in got."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert not np.isnan(got).any()
    np.testing.assert_array_equal(np.isneginf(got), np.isneginf(want))
    fin = np.isfinite(want)
    return float(np.abs(got[fin] - want[fin]).max()) if fin.any() else 0.0


def _float64(q, s, h, counts, reduce):
    return _as_tuple(machine_kde_log_density_ref(
        torch.from_numpy(q).double(), torch.from_numpy(s).double(), torch.from_numpy(h).double(),
        torch.from_numpy(counts), reduce=reduce, mixture_weights="counts"))


def _model(q, s, h, counts, reduce, **kw):
    return _as_tuple(machine_kde_log_density_split(
        torch.from_numpy(q), torch.from_numpy(s), torch.from_numpy(h), torch.from_numpy(counts),
        reduce=reduce, mixture_weights="counts", **kw))


def test_tf32_round_matches_significand_rounding():
    rng = np.random.default_rng(1)
    x = np.concatenate([
        rng.standard_normal(4096) * 10.0 ** rng.uniform(-8, 8, 4096),
        [1.0, 1.0 + 2.0**-11, -(1.0 + 2.0**-11), 1.0 + 3 * 2.0**-11, 3.14159265, -0.0, 0.0],
    ]).astype(np.float32)
    got = tf32_round(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got, _tf32_round_np(x))
    assert not (got.view(np.int32) & 0x1FFF).any()  # the 13 dropped bits are clear
    assert got[4096 + 1] == np.float32(1.0 + 2.0**-10)  # a tie rounds away from zero
    assert got[4096 + 2] == np.float32(-(1.0 + 2.0**-10))


def test_tf32_split_reconstructs_to_two_to_the_minus_22():
    rng = np.random.default_rng(2)
    x = torch.from_numpy((rng.standard_normal(100000) * 0.03).astype(np.float32))
    hi, lo = tf32_split(x)
    assert torch.equal(tf32_round(hi), hi) and torch.equal(tf32_round(lo), lo)
    err = (hi.double() + lo.double() - x.double()).abs()
    assert bool((err <= 2.0**-22 * x.double().abs()).all())


def test_centres_are_the_mean_of_evenly_spaced_valid_rows():
    rng = np.random.default_rng(3)
    s = torch.from_numpy(rng.standard_normal((3, 700, 4)).astype(np.float32))
    counts = torch.tensor([700, 100, 0], dtype=torch.int32)
    mu = kde_centres(s, counts)
    torch.testing.assert_close(mu[0], s[0, torch.arange(256) * 700 // 256].mean(0))
    torch.testing.assert_close(mu[1], s[1, :100].mean(0))  # fewer than 256 rows: all of them
    assert torch.equal(mu[2], torch.zeros(4))  # an empty machine


@pytest.mark.parametrize("reduce", REDUCES)
def test_centred_three_pass_model_meets_the_card_tolerance(reduce):
    q, s, h, counts = _path_scale()
    for out, g, w in zip(_outs(reduce), _model(q, s, h, counts, reduce),
                         _float64(q, s, h, counts, reduce)):
        scale = M if out == "product" else 1
        w = w.numpy()
        assert _max_err(g, w) <= 1e-3 * scale
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-5, atol=1e-3 * scale)


@pytest.mark.parametrize("form", ["uncentred float32 identity", "one TF32 pass"])
def test_the_forms_the_kernel_avoids_miss_the_tolerance(form):
    q, s, h, counts = _path_scale()
    if form == "one TF32 pass":
        got = _model(q, s, h, counts, "none", passes=1)[0]
    else:
        got = machine_kde_log_density_ref(torch.from_numpy(q), torch.from_numpy(s),
                                          torch.from_numpy(h), torch.from_numpy(counts))
    want = _float64(q, s, h, counts, "none")[0]
    assert _max_err(got, want) > 1e-3
    # and the centred three passes meet it on the same inputs
    assert _max_err(_model(q, s, h, counts, "none")[0], want) <= 1e-3


@pytest.mark.parametrize("reduce", REDUCES)
def test_model_matches_the_jax_reference(reduce):
    q, s, h, counts = _path_scale(seed=4)
    want = _as_tuple(jax_machine_ref(jnp.asarray(q), jnp.asarray(s), jnp.asarray(h),
                                     jnp.asarray(counts), reduce=reduce, mixture_weights="counts"))
    term = EPS32 * (float((q * q).sum(-1).max()) + float((s * s).sum(-1).max())) / (2 * float(h.min()) ** 2)
    for out, g, w in zip(_outs(reduce), _model(q, s, h, counts, reduce), want):
        scale = M if out == "product" else 1
        w = np.asarray(w)
        assert _max_err(g, w) <= 16 * term * scale
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-5, atol=16 * term * scale)


@pytest.mark.parametrize("reduce", REDUCES)
def test_nan_beyond_counts_and_an_empty_machine_stay_inert(reduce):
    q, s, h, counts = _path_scale(seed=5, ragged=True)
    assert np.isnan(s).any() and counts[1] == 0
    for out, g, w in zip(_outs(reduce), _model(q, s, h, counts, reduce),
                         _float64(q, s, h, counts, reduce)):
        scale = M if out == "product" else 1
        assert _max_err(g, w) <= 1e-3 * scale  # also: −inf in the same places, no NaN
    if reduce == "none":
        g = _model(q, s, h, counts, reduce)[0]
        assert bool(torch.isneginf(g[1]).all()) and bool(torch.isfinite(g[2]).all())


def test_library_name_hashes_the_headers_a_source_includes(tmp_path):
    (tmp_path / "a.cuh").write_text("// helper\n")
    (tmp_path / "k.cu").write_text('#include <cuda_runtime.h>\n#include "a.cuh"\n')
    k = kernels.Kernel("k", str(tmp_path / "k.cu"), replaces="-")
    assert kernels.local_sources(k.source) == [tmp_path / "k.cu", tmp_path / "a.cuh"]
    before = k.library_path()
    (tmp_path / "a.cuh").write_text("// helper, changed\n")
    assert k.library_path() != before
