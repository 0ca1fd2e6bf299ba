"""Paper §8.3: the hierarchical Poisson–gamma model, EP-MCMC end to end.

The torch variant of ``examples/hierarchical_poisson.py``, on the card
unless told otherwise::

    PYTHONPATH=src python -m repro_torch.launch.hierarchical_poisson [--device cpu] [--T 2000]

Criterion 3 ("any MCMC method per machine"): half the machines run
random-walk MH on the marginal likelihood, half run MALA, each half's
chains batched; the combination stage neither knows nor cares. Each
combiner's posterior mean and its d₂ from a long full-data random-walk
chain (the groundtruth) are printed. The example's sizes: N 50,000, M 10,
T 2,000, the groundtruth 3·T draws after T of burn-in. The IMG combines run
one index chain, as the example's do, in the engine's kernel mode
(``weight_eval="kernel"``: on the card one ``img_log_weights`` launch a
sweep), as ``launch/gmm_multimodal.py``'s.
"""

from __future__ import annotations

import argparse
from typing import Optional, Sequence

import torch

from repro_torch import kernels, resolve_device
from repro_torch.core import metrics
from repro_torch.core.combiners import get_combiner, subpost_average
from repro_torch.core.subposterior import make_subposterior_logpdf, partition_data
from repro_torch.models.bayes import poisson_gamma as pg
from repro_torch.samplers.base import run_chain
from repro_torch.samplers.mala import mala_kernel
from repro_torch.samplers.rwmh import rwmh_kernel

N, M, T = 50_000, 10, 2000
RWMH_STEP, MALA_STEP, GT_STEP = 0.04, 0.004, 0.012  # the example's
IMG = dict(rescale=True, weight_eval="kernel", n_batch=1)


def main(argv: Optional[Sequence[str]] = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--T", type=int, default=T, help="draws per subposterior chain")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    gen = torch.Generator(device=device).manual_seed(args.seed)
    data, theta_true = pg.generate_data(gen, N)
    print(f"true (log a, log b) = {theta_true.tolist()}", flush=True)

    shards = pg.prepare_data(partition_data(data, M))
    half = M // 2
    sub, accept = [], []
    for lo, hi, use_mala in ((0, half, False), (half, M, True)):
        part = {k: v[lo:hi] for k, v in shards.items()}
        logpdf = make_subposterior_logpdf(pg.log_prior, pg.log_lik, part, M)
        kern = (mala_kernel(logpdf, step_size=MALA_STEP) if use_mala
                else rwmh_kernel(logpdf, step_size=RWMH_STEP))
        init = (theta_true + 0.3).expand(hi - lo, 2).contiguous()
        pos, info = run_chain(gen, kern, init, args.T, burn_in=args.T // 6)
        sub.append(pos)
        accept.append(float(info.is_accepted.float().mean()))
    sub = torch.cat(sub)
    print(f"machines 0-{half - 1}: RWMH (acc {accept[0]:.2f}); "
          f"machines {half}-{M - 1}: MALA (acc {accept[1]:.2f})", flush=True)

    # the groundtruth: one long chain on the whole data set
    logpdf_full = make_subposterior_logpdf(pg.log_prior, pg.log_lik, pg.prepare_data(data), 1)
    gt, _ = run_chain(gen, rwmh_kernel(logpdf_full, step_size=GT_STEP), theta_true,
                      3 * args.T, burn_in=args.T)

    img = kernels.KERNELS["img_log_weights"]
    before = dict(img.route_launches)
    combined = {
        "parametric": get_combiner("parametric")(gen, sub, args.T).samples,
        "nonparametric": get_combiner("nonparametric")(gen, sub, args.T, **IMG).samples,
        "semiparametric": get_combiner("semiparametric")(gen, sub, args.T, **IMG).samples,
        "subpostAvg": subpost_average(sub),
    }
    img_routes = {r: n - before.get(r, 0) for r, n in img.route_launches.items()}
    means, d2 = {}, {}
    for name, s in combined.items():
        means[name] = s.mean(0).cpu()
        d2[name] = float(metrics.l2_distance(gt, s))
        print(f"{name:15s} posterior mean = {[round(float(v), 4) for v in means[name]]}  "
              f"d2(gt, ·) = {d2[name]:.4f}", flush=True)
    print(f"img_log_weights launches by route: {img_routes} (device {device})", flush=True)
    return {"accept": accept, "means": means, "d2": d2, "theta_true": theta_true.cpu(),
            "groundtruth_mean": gt.mean(0).cpu(), "img_routes": img_routes}


if __name__ == "__main__":
    main()
