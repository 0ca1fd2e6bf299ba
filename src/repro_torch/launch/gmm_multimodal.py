"""Paper §8.2: the multimodal GMM posterior, where the biased combiners fail.

The torch variant of ``examples/gmm_multimodal.py``, on the card unless told
otherwise::

    PYTHONPATH=src python -m repro_torch.launch.gmm_multimodal [--device cpu] [--T 1500]

The posterior over one component mean has K modes (the labels' permutation
symmetry). M chains, batched, sample their subposteriors by random-walk MH
under the paper's label-permuting proposal (``models/bayes/gmm.py::
permutation_rw_proposal``: a uniform permutation of the K means, then
Gaussian jitter, accepted or rejected together); the parametric (Gaussian)
combiner collapses the modes while the nonparametric and semiparametric
combiners keep them. The example's sizes: K 4, N 20,000, M 6, T 1,500.
The example's own ``partition_data(data, 6)`` raises (20,000 rows do not
divide by 6); here the shards are edge-padded and each chain's padded rows
are taken back out of its likelihood (``count=``), the repo's convention for
a ragged split.

The IMG combines run one index chain, as the example's do (``n_batch=1``),
in the engine's kernel mode (``weight_eval="kernel"``): on the card each
sweep is one launch of the ``img_log_weights`` kernel's sweep route, whose
launches by route are printed. The example runs the incremental mode,
another order of the same Algorithm 1. The chain count decides the table:
on the same subposterior draws (seed 0, T 1,500, CPU) one chain covers 1 of
the 4 modes in both packages, incremental or kernel mode, and 16 chains
cover all 4 in both, each chain settling in a mode of its own. The sampler
does not: the example relabels the means before each MH step, the port's
proposal permutes and jitters in one move (both symmetric), and either
gives the pool all 4 modes and the one-chain nonparametric combine 1 or 2
(seeds 0–4 at T 150).
"""

from __future__ import annotations

import argparse
from typing import Optional, Sequence

import torch

from repro_torch import kernels, resolve_device
from repro_torch.core.combiners import get_combiner, pool, subpost_average
from repro_torch.core.subposterior import make_subposterior_logpdf, partition_data
from repro_torch.models.bayes import gmm
from repro_torch.samplers.base import run_chain
from repro_torch.samplers.rwmh import rwmh_kernel

K, N, M, T = 4, 20_000, 6, 1500
STEP = 0.04  # the example's random-walk scale
IMG = dict(rescale=True, weight_eval="kernel", n_batch=1)


def describe(name: str, samples: torch.Tensor, true_means: torch.Tensor):
    """(modes covered, occupancy): the share of draws of mean 0's 2-d
    marginal within 2.0 of each true mean, a mode covered above 2 %."""
    marg = gmm.single_mean_marginal(samples)
    dists = torch.linalg.norm(marg[:, None, :] - true_means[None], dim=-1)
    closest = dists.argmin(dim=1)
    near = dists.min(dim=1).values < 2.0
    occupancy = torch.stack([((closest == i) & near).float().mean()
                             for i in range(true_means.shape[0])]).cpu()
    modes = int((occupancy > 0.02).sum())
    print(f"{name:22s} modes covered: {modes}/{true_means.shape[0]}   "
          f"occupancy={[round(float(o), 4) for o in occupancy]}", flush=True)
    return modes, occupancy


def main(argv: Optional[Sequence[str]] = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--T", type=int, default=T, help="draws per subposterior chain")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    gen = torch.Generator(device=device).manual_seed(args.seed)
    data, true_means = gmm.generate_data(gen, N, K)
    d = K * gmm.DIM

    # 20,000 rows do not split into 6 equal shards: edge-padded shards, the
    # padded rows' likelihood taken back out exactly (``count``)
    shards, counts = partition_data(data, M, only=("x",), pad=True)
    logpdf = make_subposterior_logpdf(gmm.log_prior, gmm.log_lik, shards, M, count=counts,
                                      per_datum=("x",))
    init = true_means.reshape(-1) + 0.3 * torch.randn((M, d), generator=gen, device=device)
    kernel = rwmh_kernel(logpdf, step_size=STEP,
                         proposal_fn=gmm.permutation_rw_proposal(K, step_size=STEP))
    sub, info = run_chain(gen, kernel, init, args.T, burn_in=args.T // 6)
    accept = info.is_accepted.float().mean(dim=-1).cpu()
    print(f"{M} subposterior chains × {args.T} samples over a {K}-mode posterior "
          f"(acceptance {[round(float(a), 3) for a in accept]})", flush=True)

    img = kernels.KERNELS["img_log_weights"]
    before = dict(img.route_launches)
    modes = {"pool": describe("groundtruth-ish pool", pool(sub), true_means)}
    for name, label in (("nonparametric", "nonparametric (§3.2)"),
                        ("semiparametric", "semiparametric (§3.3)")):
        res = get_combiner(name)(gen, sub, args.T, **IMG)
        modes[name] = describe(label, res.samples, true_means)
    img_routes = {r: n - before.get(r, 0) for r, n in img.route_launches.items()}
    res = get_combiner("parametric")(gen, sub, args.T)
    modes["parametric"] = describe("parametric (biased)", res.samples, true_means)
    modes["subpost_average"] = describe("subpostAvg (biased)", subpost_average(sub), true_means)
    print(f"img_log_weights launches by route: {img_routes} (device {device})", flush=True)
    return {"accept": accept, "modes": {k: m for k, (m, _) in modes.items()},
            "occupancy": {k: o for k, (_, o) in modes.items()}, "img_routes": img_routes,
            "samples": sub}


if __name__ == "__main__":
    main()
