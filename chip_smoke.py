#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (``src/repro_torch``).

    python3 chip_smoke.py

Needs one NVIDIA card (built for an H100: kernels target ``sm_90a``) and
``nvcc``. Phases, each printing its own lines; any failure ends the run with
a non-zero exit:

1. device   — the card's name and power limit (``nvidia-smi``);
2. build    — every CUDA kernel built from ``src/repro_torch/kernels/csrc``,
              with the build seconds and ptxas's register and spill report;
3. check    — each kernel against its plain PyTorch version on the card, at
              the main paths' shapes and at ragged ones, within the stated
              tolerances, plus the autograd gradient of the likelihood;
              ``logreg_loglik_grad`` (one launch, a ticket its last block
              resets) giving the same bits in three runs and in three replays
              of one captured CUDA graph at both path shapes; the MALA chain
              loops (warmup, burn-in, collection: each one captured CUDA
              graph replayed) giving the bits of the eager loop they replace,
              with one likelihood launch counted per transition; the
              KDE kernel first by one tile's tensor-core cross term against
              float64 (``kde_probe.check_tile``), then against its plain
              version in float64 too, each case's error printed beside the
              FMA design's (within twice it at the path's shapes), and
              three more launches of one input giving the same bits;
              ``img_log_weights``' sweep route (one launch a kernel-mode
              IMG sweep) against its plain sweep for w_t and W_t at the
              path's shape and at ragged ones (``sweep_agreement``: LW,
              accept flags outside the rounding margin, the carry; the
              count of sites inside the margin printed), and three more
              launches giving the same bits;
              ``online_update`` on ``online_probe.CASES`` (the stream
              path's fold, ragged counts, the slab route's two shapes, an
              unaligned slice of a draw buffer) against float64 and float32
              plain, each case checking which route's count rose and
              printing the first design's float64 error beside its own, m2
              exactly symmetric, three more launches and the slab route
              giving the same bits;
              the new transitions (rwmh, with the GMM's permutation
              proposal too, hmc, sgld, linear Gibbs, Poisson Gibbs with its
              fixed-round gamma draws and no unresolved lane), each under
              the chunk backend's captured CUDA graphs, giving the bits of
              the eager loop at M = 10 and the specs' shard sizes;
              ``img_log_weights``' both routes at d = 2, 10 and 20 too;
              ``flash_attention`` on its three routes (bf16 tensor cores at
              hd, hd_v multiples of 64; float32 as 3×TF32 on the tensor
              cores at hd, hd_v in {64, 128}, first by one tile's products
              against float64 (``flash_probe.check_tile``); FMAs otherwise),
              each case checking which route's count rose, and three more
              runs of each tensor-core route's serving case giving the same
              bits; every route's lse (``return_lse=True``, the training
              path's) against the float64 plain lse, +inf on rows with
              nothing visible; ``flash_attention_bwd`` (the hand-written
              backward) on the forward kernel's out and lse, on both its
              routes where the bf16 tensor-core route takes the case and on
              the FMA route otherwise, against its plain version in float64
              and in its own dtype and the two routes against each other
              (``flash_bwd_probe.CASES``: the training shape, three more
              runs the same bits, float32, hd 64 / 256, hd 192 with hd_v
              128, G 1 / 8 / 64, non-causal, ragged, kv_len < T, kv_len = 0
              with exactly zero gradients; one launch a call on its route);
4. main     — the paper's §8.1 logistic-regression pipeline at full width
              through ``repro_torch.api.Pipeline(PAPER_SPEC).run()``: its
              kernels must have launched, the likelihood exactly once per
              transition and init of both stages' chains (6,470), and every
              logL2 must be finite and inside the band taken from the port's
              own run on the CPU; ``sample_s`` and ``groundtruth_s`` printed
              (4b and 4c too); ``img_log_weights``' launches by route, exact
              on every MCMC path (one sweep-route launch a kernel-mode IMG
              sweep; the generic route only for weierstrass's final states);
4b. all     — the same run scoring every registered combiner
              (``ALL_SPEC``): the KDE kernel must have launched, the eleven
              logL2 values must sit inside their CPU bands and the first
              three must equal phase 4's; per-combiner seconds after it;
4c. stream  — combine-while-sampling, ``Pipeline(STREAM_SPEC)
              .stream_combine()`` (ALL_SPEC folded every 120 draws, fused):
              launch counts derived from the spec (``online_update`` once per
              fold chunk, all on its whole route), 50 finite trajectory
              values, finals equal to 4b's;
              then the subscriber path (bitwise the same finals for the
              buffered combiners, no ``online_update`` launch) and an
              interrupted-then-resumed checkpointed run (bitwise the same θ);
4d. serve   — the LM sidecar's serving path, ``python -m
              repro_torch.launch.serve --arch llama3.2-3b --batch 2
              --prompt-len 4096 --gen 16`` at full width (random weights from
              the seed), first in float32, then in bfloat16: 28
              ``flash_attention`` launches a prefill and no other kernel (all
              28 on the ``tf32x3`` route in float32, on the bf16 tensor-core
              route in bfloat16; each precision's warm prefill too), 32
              in-vocabulary tokens, and each stage's logits against the
              last-position logits of ``forward(prompt + generated[:-1])``;
4e. other   — the paper's other experiments at repro's model defaults,
              ``Pipeline(spec).run()`` for ``LINEAR_SPEC`` under mala and
              gibbs, ``POISSON_SPEC`` (gibbs) and ``GMM_SPEC`` (rwmh): stage
              seconds, acceptance, launches by kernel and route (one
              sweep-route launch a kernel-mode IMG sweep, nothing else),
              each L2 (logL2 for the GMM) inside its band from the port's CPU
              runs, MMD² beside it (as in 4b), and for ``linear`` the
              parametric mean against the closed-form posterior mean;
4h. mesh    — multi-device EP-MCMC on one card, two chain groups on two
              streams of cuda:0 (an explicit device list naming it twice):
              (a) ``Pipeline(PAPER_SPEC, mesh_shape=(2, 1))``: θ bitwise
              phase 4's, its errors exactly, the likelihood 2 x 1,602 (a
              group's G = 5 chains) + 4,868 (the groundtruth) + the
              chain-group check's eager transitions; (b) ``STREAM_SPEC``
              on the groups, fused (finals, trajectory and combine-stage
              launches 4c's), then chunked with a checkpoint every 120
              draws, interrupted and resumed bitwise; (c) 4g's eight cells
              through ``run_matrix(backend="mesh_fanout")``, every row 4g's;
              (d) ``python -m repro_torch.api.launch`` in 1 and 2 processes
              on cuda:0 (a ``TCPStore`` on a free local port), logreg/MALA
              and Poisson/Gibbs: the 2-process ``online`` samples bitwise the
              1-process ones, each rank's bytes through the store exactly
              its moments and acceptance rates; the walls of every part;
4i. train   — LM training at llama3.2-3b's full width (bf16, batch 1 x
              seq 4,096, remat "full"), through ``python -m
              repro_torch.launch.train``'s ``main``: (a) one block's
              gradients through the flash kernels against the einsum
              attention's, float32 and bf16; (b) ``--mode adamw``, 4 steps
              of 28 layers, the loss falling from step 0 to 3; (c) ``--mode
              epmcmc``, 1 chain of 28 layers and 4 chains of 2 layers
              (finite per-chain losses, the Welford count steps − burn-in,
              a finite parametric product); (d) an interrupted 4-chain
              epmcmc run resumed bit for bit (reduced config); (e) ``--mode
              sgd``, 2 steps of 4 chains of 2 layers; every full-width run's
              flash launches exact (2 forward, by the remat recompute, and
              1 backward a layer a chain a step, every one on the bf16
              tensor-core routes), s a step and peak
              ``max_memory_allocated`` printed;
5. timing   — CUDA-event times of each kernel (warm and with a cold L2,
              and the host's enqueue time) and its plain version at the
              paths' shapes (``logreg_loglik_grad`` at both the sampling and
              the groundtruth shape; ``img_log_weights``' sweep route for
              w_t and W_t on phase 4b's draws, with whole engine sweeps on
              the host clock beside the eager sweep, and at d = 2, 10 and 20
              on phase 4e's draws; ``online_update`` at
              the stream path's fold and at the slab route's shape, each
              beside its launch floor, an empty body on the same grid),
              beside the least time the card could take, and
              of PyTorch's ``scaled_dot_product_attention`` beside the flash
              kernel (a yardstick only: the port never calls it): the bf16
              tensor-core route at B=2 and B=1, and at B=2 in float32 the
              ``tf32x3`` route and the FMA route (reached through a q the
              tensor maps refuse) beside float32 SDPA, the three-TF32-pass
              bound and the float32 FMA bound; the
              KDE kernel's bound the largest of its bytes, its three TF32
              passes on the tensor cores and its exps on the MUFU;
              ``flash_attention_bwd`` at the training shape (the bf16
              tensor-core route warm, with a cold L2 and its host enqueue;
              the FMA route beside it; each route's dq / dkdv split from the
              profiler; its plain version, autograd of
              scaled_dot_product_attention's backward as the yardstick, the
              bound of the work at the bf16 tensor-core rate, the
              tensor-core design's 7-product bound and the float32 FMA
              bound) and the forward there with and without lse;
6. summary  — one JSON line of the kernels, then the device line last.

Imports nothing of JAX and nothing of the JAX package ``repro``.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
import re
import subprocess
import sys
import time

# H100 SXM published peaks (NVIDIA data sheet): HBM3 rate and float32 rate
# outside the tensor cores; the bound of a kernel is the larger of
# bytes / HBM_BYTES_PER_S and flops / F32_FLOPS. It bounds the cold-L2 time:
# on the main path the inputs stay in the 50 MB L2 between calls, and the
# data sheet gives no L2 rate to bound that warm time with.
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12
BF16_FLOPS = 989e12  # dense, tensor cores
TF32_FLOPS = 495e12  # dense, tensor cores
# exp2 results a clock per SM on the special-function units (CUDA C++
# Programming Guide, arithmetic instruction throughput, compute capability
# 9.0); times the SMs and the card's maximum SM clock, read in the run
MUFU_PER_CLOCK_PER_SM = 16

# The KDE kernel's previous design (sum (q - s)^2 on the float32 FMA pipe)
# against its plain version in float64, max abs error over every reduce mode
# and output of each case on phase 3's inputs: the largest max_abs_err of
# each case's "vs float64 plain" lines printed by python3 chip_smoke.py at
# commit 9ec7af9, the last with that design, on an NVIDIA H100 80GB HBM3,
# 700.00 W. The figure each case of the tensor-core design is printed beside,
# and held to within twice of on the path's two shapes.
FMA_KDE_ERR64 = {"importance_pool Q=M*T": 1.556e-04, "init_pool Q=1000": 1.501e-04,
                  "ragged T=1201 d=37": 4.588e-05, "Q=M=T=d=1": 1.108e-08}

# The online_update kernel's first design (a block per 32x32 tile of m2,
# sums straight from L2) against its plain version in float64 on
# online_probe.CASES' inputs: the max_abs_err of each case printed by
# PYTHONPATH=<a checkout of 308cec3>/src python src/repro_torch/launch/online_probe.py --errors
# on an NVIDIA H100 80GB HBM3, 700.00 W (commit 308cec3, the last with that
# design). Printed beside each case's error of the present design.
ONLINE_ERR64_FIRST_DESIGN = {
    "path fold": 6.089e-05, "path fold ragged": 5.536e-05, "C=1": 4.720e-06,
    "C=31 d=65 ragged": 1.523e-05, "M=d=1": 8.593e-07,
    "slab: the draw buffer as one chunk": 2.073e-03, "slab: d=300 ragged": 9.364e-05,
    "unaligned: d=37 slice from row 121": 7.101e-05,
}

# logL2 band of the main path: the port's full-width run on the CPU
# (python -m repro_torch.launch.mcmc_run --device cpu --seeds 0 1 2) gave,
# per combiner, the seeds' values below; the card's run uses other random
# streams, so it is held to [min - margin, max + margin] over those seeds,
# with margin the seeds' own range.
CPU_LOGL2 = {
    "parametric": (65.08351135253906, 67.77391052246094, 63.4933967590332),
    "nonparametric": (62.122066497802734, 65.59532928466797, 61.72703170776367),
    "semiparametric": (67.17279815673828, 69.8927993774414, 63.936588287353516),
}
# the same rule for ALL_SPEC, from
# python -m repro_torch.launch.mcmc_run --device cpu --seeds 0 1 2 --combiner all
CPU_LOGL2_ALL = {
    "consensus": (64.06085968017578, 67.2729721069336, 61.91144561767578),
    "importance_pool": (62.1065559387207, 65.81645965576172, 61.72952651977539),
    "nonparametric": (62.1065559387207, 65.81645965576172, 61.72952651977539),
    "online": (64.88431549072266, 67.75463104248047, 63.52260971069336),
    "parametric": (65.08346557617188, 67.7774658203125, 63.49346923828125),
    "pool": (62.1065559387207, 65.81645965576172, 61.72952651977539),
    "rpt": (62.1065559387207, 65.81645965576172, 61.72952651977539),
    "semiparametric": (67.17279815673828, 69.89285278320312, 63.93661880493164),
    "semiparametric_w": (67.75870513916016, 69.7479248046875, 66.40629577636719),
    "subpost_average": (62.10725784301758, 65.8286361694336, 61.729530334472656),
    "weierstrass": (62.10939025878906, 66.1889419555664, 61.72953414916992),
}


# the same rule for phase 4e's specs (L2, and logL2 for GMM_SPEC), from
# python -m repro_torch.launch.mcmc_run --device cpu --seeds 0 1 2 3 4 5 --model linear
# (and --model linear --sampler gibbs, --model poisson, --model gmm): six
# seeds, not three, since these cells are noise-dominated (the Poisson Gibbs
# chains' ESS is ~1 % of their draws; the card's seeds 0-5 span 2-3x)
CPU_L2_OTHER = {
    "linear mala": {
        "parametric": (16870210.0, 16161657.0, 16797388.0, 17213744.0, 16216311.0, 17318732.0),
        "nonparametric": (15339099.0, 15046058.0, 15592487.0, 16119727.0, 15093283.0,
                          16620038.0),
        "semiparametric": (24780698.0, 21875190.0, 21462358.0, 20785332.0, 22251270.0,
                           25910626.0)},
    "linear gibbs": {
        "parametric": (13039670.0, 12333637.0, 13225980.0, 13243903.0, 13011819.0, 12640048.0),
        "nonparametric": (11844730.0, 11830663.0, 11646135.0, 12372750.0, 11877465.0,
                          11727429.0),
        "semiparametric": (19401056.0, 20355374.0, 23416874.0, 19310900.0, 19674278.0,
                           18570792.0)},
    "poisson gibbs": {
        "parametric": (34.94477081298828, 21.929105758666992, 18.88249969482422,
                       12.859539985656738, 9.794782638549805, 11.130476951599121),
        "nonparametric": (21.323741912841797, 20.248645782470703, 16.663976669311523,
                          7.872171878814697, 22.022451400756836, 25.808683395385742),
        "semiparametric": (26.162822723388672, 21.31393814086914, 20.867267608642578,
                           7.437817573547363, 31.190990447998047, 41.622398376464844)},
    "gmm rwmh": {"nonparametric": (13.160148620605469, 23.088851928710938, 16.339683532714844,
                                   18.19670295715332, 11.92257022857666, 19.629165649414062)},
}
# The GMM's parametric and semiparametric products are degenerate: its random
# walk accepts 2-9 % of its moves at GMM_SPEC (repro 2.7 % at seed 0), so
# some chains' 1,200 draws hold fewer than d + 1 = 21 distinct points and
# their sample covariance (1e-8 added to its diagonal) has no float32
# Cholesky factor. repro's factor is then NaN, and so is the port's
# (core/gaussian.cholesky), so the Gaussian product and both combiners
# built on it are NaN. Held to that rule: NaN exactly when some chain's
# covariance has no factor (read with torch.linalg.cholesky_ex), else finite.
DEGENERATE = {"gmm rwmh": ("parametric", "semiparametric")}


def phase(name: str) -> None:
    print(f"== {name}", flush=True)


def check_close(label, got, want, *, rtol, atol):
    """Max abs error of got vs want; raises unless |got−want| ≤ atol + rtol·|want|."""
    import torch

    got, want = got.double(), want.double()
    err = (got - want).abs()
    limit = atol + rtol * want.abs()
    max_err = float(err.max())
    ok = bool(torch.isfinite(got).all()) and bool((err <= limit).all())
    print(f"  {label}: max_abs_err={max_err:.3e} (rtol={rtol:g}, atol={atol:g}) "
          f"{'ok' if ok else 'FAIL'}", flush=True)
    if not ok:
        raise AssertionError(f"{label}: kernel disagrees with its plain version")
    return max_err


def check_lp(label, got, want, *, rtol, atol):
    """check_close for log densities: −inf (an empty machine) in the same
    places on both sides, no NaN, the finite entries within the tolerance."""
    import torch

    got, want = got.double(), want.double()
    same_inf = bool(torch.equal(torch.isneginf(got), torch.isneginf(want)))
    fin = torch.isfinite(want)
    err = (got - want)[fin].abs()
    max_err = float(err.max()) if err.numel() else 0.0
    ok = (same_inf and not bool(torch.isnan(got).any())
          and bool((err <= atol + rtol * want[fin].abs()).all()))
    print(f"  {label}: max_abs_err={max_err:.3e} (rtol={rtol:g}, atol={atol:.3g}) "
          f"{'ok' if ok else 'FAIL'}", flush=True)
    if not ok:
        raise AssertionError(f"{label}: kernel disagrees with its plain version")
    return max_err


def check_bands(board, bands, degenerate=(), pipe=None):
    """Every error (L2 or logL2) of ``board`` finite and inside [min − r,
    max + r] of its CPU seeds, r their range; each ``degenerate`` name (a
    Gaussian product, see DEGENERATE) NaN exactly when some chain of
    ``pipe``'s draws has a covariance with no Cholesky factor, else finite."""
    if set(board.errors) != set(bands) | set(degenerate):
        raise AssertionError(f"scoreboard keys {sorted(board.errors)} != "
                             f"{sorted(set(bands) | set(degenerate))}")
    if degenerate:
        import torch
        from repro_torch.core.combiners.api import counts_or_full, valid_masks
        from repro_torch.core.gaussian import fit_moments

        theta = pipe.sample().theta  # the moments as the parametric combiner fits them
        mask = valid_masks(theta, counts_or_full(theta, None))
        info = torch.linalg.cholesky_ex(fit_moments(theta, mask).cov).info
        distinct = ((theta[:, 1:] != theta[:, :-1]).any(dim=-1).sum(dim=1) + 1).tolist()
        no_factor = [m for m, i in enumerate(info.tolist()) if i != 0]
        print(f"  distinct draws a chain {distinct} (d = {theta.shape[-1]}); chains whose "
              f"covariance has no Cholesky factor: {no_factor}", flush=True)
        for name in degenerate:
            err = board.errors[name]
            ok = math.isnan(err) if no_factor else math.isfinite(err)
            print(f"  {board.metric}({name}) = {err:.4f}, expected "
                  f"{'NaN' if no_factor else 'finite'} (DEGENERATE) {'ok' if ok else 'FAIL'}",
                  flush=True)
            if not ok:
                raise AssertionError(f"{board.metric}({name}) = {err}: not the reference's rule")
    for name, seeds in sorted(bands.items()):
        err = board.errors[name]
        margin = max(seeds) - min(seeds)
        lo, hi = min(seeds) - margin, max(seeds) + margin
        ok = math.isfinite(err) and lo <= err <= hi
        print(f"  {board.metric}({name}) = {err:.4f}, band [{lo:.4f}, {hi:.4f}] "
              f"{'ok' if ok else 'FAIL'}", flush=True)
        if not ok:
            raise AssertionError(f"{board.metric}({name}) = {err} outside its band")


def check_gibbs_moments(label, pipe, spec, dev):
    """The Poisson Gibbs sampler on the card against the exact moments of its
    target: 256 independent chains on shard 0 of ``spec``'s data, tempered
    by its M and stepped by its step size as the pipeline's are, 2,000
    sweeps then 1,000 kept, each pooled mean and second moment
    of θ within 4 Monte Carlo errors of ``gibbs_subposterior_moments``
    (quadrature in float64, no sampling), the rule of
    tests/test_torch_slice_poisson.py. The L2 bands cannot tell a wrong
    sampler from noise at this ESS; this can. The chains start at θ = 0 and
    creep along the (log a, log b) ridge, so the pooled mean of the burn-in
    sweeps is printed by window (in the target's standard deviations), and
    beside it the pipeline's own chain on that shard, which keeps its draws
    from sweep ``spec.warmup`` on."""
    import torch
    from repro_torch.api.sampling import sample_subposteriors
    from repro_torch.core.metrics import moment_z_scores
    from repro_torch.models.bayes import get_model
    from repro_torch.models.bayes.poisson_gamma import gibbs_subposterior_moments

    chains, burn, draws = 256, 2000, 1000
    sharded = pipe.partition()
    rows = int(sharded.counts[0])
    shard = {k: v[0, :rows] for k, v in sharded.shards.items()}
    mean, std = gibbs_subposterior_moments(shard, spec.M)
    many = {k: v.unsqueeze(0).expand((chains,) + v.shape).contiguous() for k, v in shard.items()}
    t0 = time.perf_counter()
    every = sample_subposteriors(
        torch.Generator(device=dev).manual_seed(spec.seed + 1), get_model(spec.model), many,
        spec.M, burn + draws, sampler="gibbs", warmup=0, step_size=spec.step_size, shards=many,
        counts=torch.full((chains,), rows, dtype=torch.int32, device=dev)).theta.double()
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    edges = [0] + [e for e in (200, 500, 1000, 2000) if e < burn] + [burn]
    transient = {f"{lo}-{hi}": ((every[:, lo:hi].mean(dim=(0, 1)) - mean) / std).tolist()
                 for lo, hi in zip(edges[:-1], edges[1:])}
    theta = every[:, burn:]
    z_mean, z_var = moment_z_scores(theta, mean, std)
    own = (pipe.sample().theta[0].double().mean(dim=0) - mean) / std
    ok = bool((z_mean.abs() <= 4.0).all() and (z_var.abs() <= 4.0).all())
    out = {"exact_mean": mean.tolist(), "exact_std": std.tolist(),
           "chains_mean": theta.mean(dim=(0, 1)).tolist(),
           "chains_std": ((theta - mean) ** 2).mean(dim=(0, 1)).sqrt().tolist(),
           "z_mean": z_mean.tolist(), "z_second_moment": z_var.tolist(),
           "pipeline_chain0_mean_in_std": own.tolist(), "burn_in_mean_in_std": transient,
           "seconds": secs,
           "chains": chains, "burn": burn, "draws": draws, "rows": rows}
    print(f"  {label}: Gibbs on shard 0 ({chains} chains, {burn} + {draws} sweeps, {secs:.2f} s) "
          f"against quadrature: mean {out['chains_mean']} vs {out['exact_mean']}, z "
          f"{[round(z, 3) for z in out['z_mean']]}; std {out['chains_std']} vs "
          f"{out['exact_std']}, z {[round(z, 3) for z in out['z_second_moment']]} (limit 4); "
          f"the pipeline's chain 0 at {[round(z, 3) for z in own.tolist()]} std; burn-in "
          f"by sweeps {json.dumps({k: [round(z, 3) for z in v] for k, v in transient.items()})} "
          f"std {'ok' if ok else 'FAIL'}", flush=True)
    if not ok:
        raise AssertionError(f"{label}: Gibbs moments off their target: {out}")
    return out


def mmd_lengthscale(gt):
    """The median of the nonzero pairwise distances of 1,000 groundtruth
    draws spread over the chain (the median heuristic)."""
    import torch

    sub = gt[torch.linspace(0, gt.shape[0] - 1, 1000, device=gt.device).long()]
    dist = torch.cdist(sub, sub).flatten()
    return dist[dist > 0].median()


def mmd2_lines(label, pipe, board):
    """``mmd2_rbf`` (biased, RBF) of each combiner's draws against the
    groundtruth, printed beside the scoreboard's metric; the lengthscale is
    the median of the nonzero pairwise distances of 1,000 groundtruth draws
    spread over the chain (the median heuristic; a random walk that rarely
    moves repeats its draws, and their zero distances would make it 0). Not
    a key of ``Scoreboard.errors``."""
    import torch
    from repro_torch.core.metrics import mmd2_rbf

    gt = pipe.groundtruth()
    ell = mmd_lengthscale(gt)
    out = {}
    for name, res in sorted(pipe.combine().items()):
        out[name] = float(mmd2_rbf(gt, res.samples, ell))
        print(f"  {label}: {board.metric}({name}) = {board.errors[name]:.4f}, "
              f"mmd2_rbf = {out[name]:.6e} (lengthscale {float(ell):.4g})", flush=True)
    return out


def stage_line(label, timings, wall=None):
    """The MCMC stages' seconds of one run, on a line of their own."""
    extra = "" if wall is None else f" wall_s={wall:.4f}"
    print(f"  stages {label}: sample_s={timings.get('sample_s', float('nan')):.4f} "
          f"groundtruth_s={timings.get('groundtruth_s', float('nan')):.4f}{extra}", flush=True)


def kernel_label(ptxas_line: str) -> str:
    """``name<template args>`` of the kernel a ptxas 'Compiling entry
    function' line names, from its mangled name (``flash_fwd_tc_kernel<128,
    128>``, ``flash_fwd_kernel<bf16,2>``, ``flash_fwd_tf32_kernel<128,128,0>``);
    the mangled name if none ends in 'kernel'."""
    mangled = ptxas_line.split("'")[1] if "'" in ptxas_line else ptxas_line
    for i, j in ((i, j) for i in range(len(mangled)) for j in (i + 1, i + 2, i + 3)):
        if not mangled[i:j].isdigit():
            continue
        name = mangled[j:j + int(mangled[i:j])]
        if name.endswith("kernel") and name.isidentifier():
            rest = mangled[j + len(name):].split("EEv")[0]
            args = (["float"] if rest.startswith("If") else []) + \
                (["bf16"] if rest.startswith("I13__nv_bfloat16") else []) + re.findall(r"L[ib](\d+)E", rest)
            return f"{name}<{','.join(args)}>"
    return mangled


IMG_COMBINERS = ("nonparametric", "semiparametric", "semiparametric_w")


def img_sweeps(spec):
    """The kernel-mode IMG sweeps of one run of ``spec``'s combiners:
    ceil(T / n_batch) for each IMG combiner it scores."""
    n_img = sum(name in IMG_COMBINERS for name in spec.combiner_names())
    return n_img * -(-spec.T // int(dict(spec.combiner_options)["n_batch"]))


def check_img_routes(label, routes, *, generic, sweep):
    """``img_log_weights``' launches of one path, by route, exactly."""
    want = {"generic": generic, "sweep": sweep}
    ok = routes == want
    print(f"  img_log_weights launches by route on {label}: {json.dumps(routes)} "
          f"(expected {json.dumps(want)}) {'ok' if ok else 'FAIL'}", flush=True)
    if not ok:
        raise AssertionError(f"img_log_weights routes on {label}: {routes}, expected {want}")


def sweep_work(B, M, d, wt):
    """(bytes, flop) one sweep-route launch needs: each input read once (the
    state, the gathered candidates, the mean, three scalars, t_idx and c as
    int64, u; for W_t the factor, μ̂_M, logdet and two aux gathers a site),
    each output written once (the carry, LW, the log ratios, the flags);
    Eq. 3.5 for B·M single-site states (4·M·d each), the candidates' norms
    and b_m (6·d a site), the Gram's upper triangle (2·d an entry), the mean's
    update (2·d a site), and for W_t M + 1 triangular solves (d² each) and
    their Gram's upper triangle (2·d an entry)."""
    f, i8 = 4, 8
    read = f * (2 * B * M * d + B * d + 3 * B + B * M) + i8 * 2 * B * M + f
    write = i8 * B * M + f * (B * M * d + B * d + 3 * B + 2 * B * M) + B * M
    flop = B * M * (4 * M * d + 6 * d + 2 * d) + B * M * (M + 1) * d
    if wt:
        read += f * (d * d + d + 1 + 2 * B * M)
        flop += B * (M + 1) * d * d + B * (M + 1) * (M + 2) * d
    return read + write, flop


def sweep_wall_ms(fn, n):
    """Host milliseconds a call of ``fn``, over ``n`` calls after five warm
    ones, ended by a synchronisation."""
    import torch

    for _ in range(5):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / n


def least_ms(nbytes, flops, peak=F32_FLOPS):
    """(least ms, what bounds it): bytes over the HBM rate or flops over the
    ``peak`` rate (float32 by default), whichever is larger."""
    by_bytes, by_ops = nbytes / HBM_BYTES_PER_S, flops / peak
    return max(by_bytes, by_ops) * 1e3, ("bytes" if by_bytes >= by_ops else "operations")


def device_ms(fn, *, iters=50, flush=None):
    """Mean device milliseconds per call of ``fn``, from CUDA events.

    The host needs tens of microseconds to enqueue one call, longer than the
    kernels run, so timing back-to-back calls would time the host. A GPU
    sleep longer than the whole enqueue is queued first: every call is on the
    stream before the device reaches the start event, and the calls run back
    to back (a reading the host outran is taken again behind a longer
    sleep). ``iters`` stays small enough that the stream's queue of pending
    launches never fills (a full queue would block the host until the sleep
    ends). With ``flush`` (a 256 MB write, > the 50 MB L2) between calls,
    each call is timed alone with its own events and starts from a cold L2.
    Returns ``(device_ms, host_enqueue_ms)`` per call.
    """
    import torch

    for _ in range(10):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        if flush is not None:
            flush()
        fn()
    host_ms = (time.perf_counter() - t0) * 1e3
    torch.cuda.synchronize()
    # calibrate the sleep: cycles per millisecond on this card, now
    probe = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    probe[0].record()
    torch.cuda._sleep(10_000_000)
    probe[1].record()
    torch.cuda.synchronize()
    cycles_per_ms = 10_000_000 / probe[0].elapsed_time(probe[1])
    # a sleep three times the host's enqueue time; a host busier now than when
    # it was timed can still outrun it, and then the reading is taken again
    # behind a sleep ten, then thirty times as long
    for factor in (3.0, 10.0, 30.0):
        events = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
                  for _ in range(iters if flush is not None else 1)]
        torch.cuda._sleep(int(cycles_per_ms * factor * max(host_ms, 1.0)))
        sleep_done = torch.cuda.Event()
        sleep_done.record()
        if flush is None:
            events[0][0].record()
            for _ in range(iters):
                fn()
            events[0][1].record()
        else:
            for start, end in events:
                flush()
                start.record()
                fn()
                end.record()
        covered = not sleep_done.query()
        torch.cuda.synchronize()
        if covered:
            total = sum(start.elapsed_time(end) for start, end in events)
            return total / iters, host_ms / iters
    raise AssertionError("the GPU sleep ended before the host had enqueued every call, "
                         "three times")


def posterior_session(label, server, readers, *, transitions, sweeps_per_refresh):
    """One session of the posterior server (``serve_session``: ``readers``
    TCP probe readers cycling ``PROBE_OPS`` and a one-point logpdf) with the
    counts reset; every kernel's launches checked exactly: the likelihood
    once per init and transition of the sampler (``transitions``), the IMG
    sweep route ``sweeps_per_refresh`` times a refresh (the nonparametric
    estimate), the KDE kernel once per logpdf answered, nothing else.
    Returns the summary, the counts and the session's seconds."""
    import torch
    from repro_torch import kernels
    from repro_torch.serve import serve_session

    kernels.reset_launches()
    t0 = time.perf_counter()
    summary = serve_session(server, probe_readers=readers,
                            log=lambda m: print(f"  {label}: {m}", flush=True))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = kernels.launch_counts()
    routes = {n: dict(k.route_launches) for n, k in kernels.KERNELS.items() if k.route_launches}
    state = server.state
    want = {"logreg_loglik_grad": transitions,
            "img_log_weights": sweeps_per_refresh * state.refreshes,
            "machine_kde_log_density": state.logpdf_answered, "kde_log_density": 0,
            "online_update": 0, "flash_attention": 0, "flash_attention_bwd": 0}
    ok = launches == want and routes["img_log_weights"] == {
        "generic": 0, "sweep": want["img_log_weights"]}
    st = summary["staleness"]
    fold = sorted(server.fold_s)
    print(f"  {label}: launches {json.dumps(launches)}, img_log_weights by route "
          f"{json.dumps(routes['img_log_weights'])} (expected {json.dumps(want)}: "
          f"{state.refreshes} refreshes, {state.logpdf_answered} logpdf answers) "
          f"{'ok' if ok else 'FAIL'}", flush=True)
    if not ok:
        raise AssertionError(f"{label}: launch counts {launches} {routes}, expected {want}")
    print(f"  {label}: {summary['queries']} queries in {wall:.3f} s "
          f"({summary['queries'] / wall:.1f} a second), reader p50 "
          f"{summary['reader_p50_s'] * 1e3:.3f} ms p99 {summary['reader_p99_s'] * 1e3:.3f} ms, "
          f"sample_s {summary['sample_s']:.4f}, fold {len(fold)} chunks: median "
          f"{fold[len(fold) // 2] * 1e3:.3f} ms max {fold[-1] * 1e3:.3f} ms a chunk, "
          f"{len(server.refresh_s)} refreshes {sum(server.refresh_s):.4f} s in all, "
          f"staleness {json.dumps(st)}", flush=True)
    return summary, launches, wall


def eager_shard_chains(sk, shards, counts, gen, *, burn_in, warmup, step_size, T):
    """The chains of ``sk`` written out as the eager loop: init, warmup (the
    kernel rebuilt at exp(log ε) every step, as the reference's scan does),
    burn-in, T kept draws. ``(eps, theta (M, T, d), accepted (M, T), state)``."""
    import torch
    from repro_torch.samplers import da_init, da_update

    M = counts.shape[0]
    pos = sk.init_position(gen, shards)
    eps = step_size
    if sk.adaptive and warmup > 0:
        da = da_init(step_size, (M,), counts.device)
        s = sk.build(shards, counts, torch.exp(da.log_eps)[:, None]).init(pos)
        for _ in range(warmup):
            s, i = sk.build(shards, counts, torch.exp(da.log_eps)[:, None]).step(gen, s)
            da = da_update(da, i.accept_prob, sk.target_accept)
        eps = torch.exp(da.log_eps_avg)[:, None]
        n_burn, pos = burn_in, s.position
    else:
        n_burn = burn_in + warmup
    kern = sk.build(shards, counts, eps)
    s = kern.init(pos)
    for _ in range(n_burn):
        s, _ = kern.step(gen, s)
    rows, acc = [], []
    for _ in range(T):
        s, i = kern.step(gen, s)
        rows.append(sk.extract(s.position))
        acc.append(i.is_accepted)
    return eps, torch.stack(rows, dim=1), torch.stack(acc, dim=-1), s


def check_new_transitions(dev):
    """Phase 3's graph-against-eager check of rwmh (and with the GMM's
    permutation proposal), hmc, sgld, linear Gibbs and Poisson Gibbs."""
    import torch
    from repro_torch.api.backends import BatchedChunkBackend
    from repro_torch.api.sampling import ShardKernel, make_shard_kernel
    from repro_torch.core.subposterior import make_subposterior_logpdf, partition_data
    from repro_torch.models.bayes import get_model
    from repro_torch.models.bayes.gmm import permutation_rw_proposal
    from repro_torch.samplers import get_sampler, randgamma

    def shard_kernel(model, sampler, **kw):
        return make_shard_kernel(get_model(model), 10, sampler, use_counts=False, **kw)

    gmm = get_model("gmm")
    perm_rwmh = ShardKernel(  # rwmh with the §8.2 label-permutation proposal, fixed step
        init_position=lambda g, sh: gmm.initial_position(g, (10,)),
        build=lambda sh, c, eps: get_sampler("rwmh")(
            make_subposterior_logpdf(gmm.log_prior, gmm.log_lik, sh, 10, per_datum=gmm.shard_keys),
            proposal_fn=permutation_rw_proposal(10, step_size=0.05)),
        extract=lambda pos: pos, adaptive=False, target_accept=0.35)
    cases = {  # label: (model, n, shard kernel, step size, warmup, burn-in, T)
        "rwmh gmm": ("gmm", 50_000, shard_kernel("gmm", "rwmh"), 0.1, 40, 30, 60),
        "rwmh gmm permutation proposal": ("gmm", 50_000, perm_rwmh, 0.1, 0, 30, 60),
        "hmc linear L=10": ("linear", 10_000, shard_kernel("linear", "hmc"), 0.1, 30, 20, 40),
        "sgld linear batch 256": ("linear", 10_000, shard_kernel("linear", "sgld"), 1e-4, 0, 30,
                                  60),
        "gibbs linear": ("linear", 10_000, shard_kernel("linear", "gibbs"), 0.1, 0, 30, 60),
        "gibbs poisson": ("poisson", 50_000, shard_kernel("poisson", "gibbs"), 0.1, 10, 20, 60),
    }
    for label, (model, n, sk, step, warmup, burn_in, T) in cases.items():
        tm = get_model(model)
        data, _ = tm.generate_data(torch.Generator(device=dev).manual_seed(7), n)
        shards, counts = partition_data(data, 10, only=tm.shard_keys, pad=True)
        backend = BatchedChunkBackend(sk, shards, counts, burn_in=burn_in, warmup=warmup,
                                      step_size=step)
        g = torch.Generator(device=dev).manual_seed(8)
        state, eps = backend.setup(g)
        state, theta, acc_sum = backend.next_chunk(g, eps, state, T)
        torch.cuda.synchronize()
        g = torch.Generator(device=dev).manual_seed(8)
        eps_e, theta_e, acc_e, state_e = eager_shard_chains(
            sk, shards, counts, g, burn_in=burn_in, warmup=warmup, step_size=step, T=T)
        torch.cuda.synchronize()
        same_eps = (not backend.adapts) or torch.equal(eps, eps_e)
        if not (backend._loop.graph is not None and same_eps and torch.equal(theta, theta_e)
                and torch.equal(acc_sum, acc_e.to(torch.float32).sum(dim=-1))):
            raise AssertionError(f"graphed {label} chains differ from the eager loop")
        extra = ""
        if model == "poisson":
            unresolved = (int(state.unresolved), int(state_e.unresolved))
            if unresolved != (0, 0):
                raise AssertionError(f"gibbs poisson: {unresolved} gamma lanes unresolved")
            extra = (f"; gamma draws in {randgamma.ROUNDS} rounds, 0 unresolved lanes "
                     f"({10 * shards['x'].shape[1]} latents a sweep)")
        print(f"  graphed {label} (M=10, n={n}, warmup {warmup}, burn-in {burn_in}, T={T}): θ "
              f"{tuple(theta.shape)}, accept flags ({int(acc_sum.sum())}/{10 * T} accepted)"
              f"{' and ε' if backend.adapts else ''} bitwise the eager loop's{extra}", flush=True)
        del data, shards, backend, state, theta, state_e, theta_e
    torch.cuda.empty_cache()


# each launch process's time limit; the store waits half of it for a rank
LAUNCH_TIMEOUT_S = 300


def launch_ranks(root: str, args, nproc: int, out_dir: str):
    """``python -m repro_torch.api.launch`` as ``nproc`` processes on cuda:0
    (their store on a free local port): the records, one a rank."""
    import socket

    env = dict(os.environ, PYTHONPATH=os.path.join(root, "src"))
    cmd = [sys.executable, "-m", "repro_torch.api.launch", "--device", "cuda:0", *args,
           "--timeout", str(LAUNCH_TIMEOUT_S // 2)]
    if nproc > 1:
        with socket.socket() as sock:
            sock.bind(("localhost", 0))
            port = sock.getsockname()[1]
        cmd += ["--coordinator", f"localhost:{port}", "--num-processes", str(nproc)]
    files = [os.path.join(out_dir, f"{nproc}-rank{r}.json") for r in range(nproc)]
    logs = [open(os.path.join(out_dir, f"{nproc}-rank{r}.err"), "w") for r in range(nproc)]
    procs = [subprocess.Popen(cmd + ["--process-id", str(r), "--json", files[r]],
                              stdout=subprocess.DEVNULL, stderr=logs[r], env=env)
             for r in range(nproc)]
    try:
        for r, proc in enumerate(procs):
            proc.wait(timeout=LAUNCH_TIMEOUT_S)
            if proc.returncode != 0:
                logs[r].flush()
                with open(logs[r].name) as f:
                    raise AssertionError(f"launch rank {r} of {nproc} exited {proc.returncode}:"
                                         f"\n{f.read()[-3000:]}")
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        for log in logs:
            log.close()
    records = []
    for f in files:
        with open(f) as fh:
            records.append(json.load(fh))
    return records


def npz_bytes(*shapes) -> int:
    """The size of ``numpy.savez`` of float32 zeros of these shapes, leaves
    named as the launch names them: a rank's payload in the store."""
    import io

    import numpy as np

    buf = io.BytesIO()
    np.savez(buf, **{f"a{i:03d}": np.zeros(s, np.float32) for i, s in enumerate(shapes)})
    return len(buf.getvalue())


def step_split(out, cfg, argv, dev, sync):
    """One more step after a training run, in parts, each ended by a
    synchronise: (forward + backward s, the rest s). adamw: ``loss_fn`` and
    its gradients, then ``adamw_update``, both timed. epmcmc and sgd: every
    chain's ``_neg_logpost_and_grads`` timed one after another and summed,
    then one whole ``epmcmc_step`` (or ``sgd_baseline_step``) timed; the
    rest (the pSGLD update, its noise and the Welford fold, or the chain
    mean) is that step's time less the summed forward + backward: a
    remainder, which takes any difference between the two."""
    import torch

    from repro_torch.data.tokens import TokenStream
    from repro_torch.distributed import epmcmc
    from repro_torch.models.lm import steps as lm_steps
    from repro_torch.optim import adamw_update

    mode = argv[argv.index("--mode") + 1]
    seq, batch = int(argv[argv.index("--seq") + 1]), int(argv[argv.index("--batch") + 1])
    if mode == "adamw":
        model, opt = out["state"]
        b = TokenStream(cfg.vocab_size, batch, seq, seed=1, device=dev).batch(0)
        params = dict(model.named_parameters())
        sync()
        t0 = time.perf_counter()
        total, _ = lm_steps.loss_fn(model, cfg, b)
        grads = dict(zip(params, torch.autograd.grad(total, list(params.values()))))
        sync()
        t1 = time.perf_counter()
        adamw_update(params, grads, opt)
        sync()
        return t1 - t0, time.perf_counter() - t1
    state = out["state"]
    chains = state.m_count.shape[0]
    streams = [TokenStream(cfg.vocab_size, batch, seq, seed=1, shard_index=c, device=dev)
               for c in range(chains)]
    b = {k: torch.stack([s.batch(0)[k] for s in streams]) for k in ("tokens", "labels")}
    kw = dict(num_shards=chains, shard_tokens=float(batch * seq * 100))
    fwd_bwd = 0.0
    for c in range(chains):
        sync()
        t0 = time.perf_counter()
        _, grads = epmcmc._neg_logpost_and_grads(epmcmc.chain_view(cfg, state.params, c), cfg,
                                                 {k: v[c] for k, v in b.items()}, **kw)
        sync()
        fwd_bwd += time.perf_counter() - t0
        del grads
    step = epmcmc.epmcmc_step if mode == "epmcmc" else epmcmc.sgd_baseline_step
    sync()
    t0 = time.perf_counter()
    step(state, b, cfg, step_size=1e-5, **kw)
    sync()
    return fwd_bwd, time.perf_counter() - t0 - fwd_bwd


def train_phase(dev, kernels, lm_config):
    """Phase 4i: LM training at llama3.2-3b's full width (d 3,072, 24/8 heads,
    hd 128, d_ff 8,192, vocab 128,256, bf16, remat "full"), batch 1 × seq
    4,096 (train_4k's sequence, > attn_chunk, so every layer's attention is
    flash): (a) one block's gradients through the flash kernels against the
    einsum attention's (the plain versions), float32 and bf16; (b) adamw, 4
    steps of 28 layers; (c) epmcmc, 1 chain of 28 layers and 4 chains of 2
    layers; (d) an interrupted 4-chain epmcmc run resumed bit for bit (at
    the reduced config: a full-width 4-chain checkpoint is 34 GB); (e) sgd,
    2 steps of 4 chains of 2 layers. Flash launches exact on every full-width
    run: 2 forward (the block and its remat recompute) and 1 backward a layer
    a chain a step. Returns (the full-width runs' launches, their flash
    forward launches by route, the record printed)."""
    import tempfile

    import torch

    from repro_torch.launch import train
    from repro_torch.models.lm import model as lm_model

    phase("4i train: llama3.2-3b full width, bf16, batch 1 x seq 4096, remat full")
    cfg = lm_config("llama3.2-3b")
    fwd_kernel = kernels.KERNELS["flash_attention"]
    bwd_kernel = kernels.KERNELS["flash_attention_bwd"]
    record, launches_train = {}, {name: 0 for name in kernels.KERNELS}
    routes_train = {route: 0 for route in fwd_kernel.route_launches}
    routes_train_bwd = {route: 0 for route in bwd_kernel.route_launches}

    # (a) one block, x + attn(ln1(x)) then + mlp(ln2(·)), loss Σ r·out with
    # r fixed: its gradients (input and every weight) through the kernels
    # against the same block whose attention is the einsum path (softmax
    # materialized, autograd through it): float32 (tf32x3 forward, float32
    # backward) within 1e-3 of each gradient's max, bf16 within 5e-2 (the
    # two paths round P and the attention output to bf16 in other places)
    pos = torch.arange(4096, device=dev)[None]
    block_errs = {}
    for dtype_name, tol in (("float32", 1e-3), ("bfloat16", 5e-2)):
        c = dataclasses.replace(cfg, dtype=dtype_name, param_dtype=dtype_name)
        gen = torch.Generator(device=dev).manual_seed(31)
        block = lm_model.Block(c, generator=gen, device=dev)
        plain = lm_model.Block(dataclasses.replace(c, attn_impl="einsum"), device=dev)
        plain.load_state_dict(block.state_dict())
        dtype = block.attn.w_q.dtype
        h = torch.randn((1, 4096, c.d_model), generator=gen, device=dev).to(dtype)
        r = torch.randn((1, 4096, c.d_model), generator=gen, device=dev)

        def grads(b):
            x = h.clone().requires_grad_()
            loss = (b(x, pos).float() * r).sum()
            return torch.autograd.grad(loss, [x, *b.parameters()])

        kernels.reset_launches()
        got = grads(block)
        torch.cuda.synchronize()
        counts = kernels.launch_counts()
        want_counts = {n: int(n in ("flash_attention", "flash_attention_bwd")) for n in counts}
        bwd_route = "tensor_core" if dtype_name == "bfloat16" else "fma"
        if counts != want_counts or bwd_kernel.route_launches[bwd_route] != 1:
            raise AssertionError(f"(a) one block ({dtype_name}) launched {counts}, the backward "
                                 f"by route {bwd_kernel.route_launches} (want one {bwd_route})")
        want = grads(plain)
        names = ["x", *(n for n, _ in block.named_parameters())]
        rel = {n: float((a.double() - b.double()).abs().max() / b.double().abs().max())
               for n, a, b in zip(names, got, want)}
        worst = max(rel, key=rel.get)
        ok = all(torch.isfinite(a).all() for a in got) and rel[worst] <= tol
        print(f"  (a) one block {dtype_name}: gradients through the kernels vs the einsum "
              f"attention's: worst {worst} {rel[worst]:.3e} of its max (tol {tol:g}), x "
              f"{rel['x']:.3e}, attn.w_q {rel['attn.w_q']:.3e}, attn.w_k {rel['attn.w_k']:.3e}, "
              f"attn.w_v {rel['attn.w_v']:.3e}; launches flash_attention 1, "
              f"flash_attention_bwd 1 ({bwd_route}) {'ok' if ok else 'FAIL'}", flush=True)
        if not ok:
            raise AssertionError(f"(a) one block ({dtype_name}): gradients disagree")
        block_errs[dtype_name] = rel
        del block, plain, got, want, h, r
        torch.cuda.empty_cache()
    record["block_grad_rel_err"] = {k: max(v.values()) for k, v in block_errs.items()}

    base = ["--arch", "llama3.2-3b", "--batch", "1", "--seq", "4096", "--log-every", "1",
            "--seed", "0"]

    def run(label, argv, *, layers, chains, steps):
        """train.main with the counts reset; flash launches exact."""
        kernels.reset_launches()
        t0 = time.perf_counter()
        out = train.main(base + argv)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts, routes = kernels.launch_counts(), dict(fwd_kernel.route_launches)
        routes_bwd = dict(bwd_kernel.route_launches)
        calls = layers * chains * steps
        want = {n: {"flash_attention": 2 * calls, "flash_attention_bwd": calls}.get(n, 0)
                for n in counts}
        if (counts != want or routes.get("tensor_core") != 2 * calls
                or routes_bwd != {"tensor_core": calls, "fma": 0}):
            raise AssertionError(f"{label}: launched {counts} (flash by route {routes}, its "
                                 f"backward by route {routes_bwd}), expected {want}, all on "
                                 f"the tensor-core routes")
        for n in counts:
            launches_train[n] += counts[n]
        for rt in routes:
            routes_train[rt] += routes[rt]
        for rt in routes_bwd:
            routes_train_bwd[rt] += routes_bwd[rt]
        losses = [x.tolist() for x in out["losses"]]
        if not all(math.isfinite(v) for x in losses for v in (x if isinstance(x, list) else [x])):
            raise AssertionError(f"{label}: a loss is not finite: {losses}")
        combined = out.pop("combined", None)  # epmcmc: 25.7 GB at 28 layers, checked here
        if combined is not None:
            out["combined_finite"] = all(bool(torch.isfinite(t).all())
                                         for part in (combined.mean, combined.cov)
                                         for t in part.values())
            out["combined_dims"] = sum(t.numel() for t in combined.mean.values())
            out["welford_count"] = out["state"].m_count.tolist()  # before the split's step
            del combined
            torch.cuda.empty_cache()
        fwd_bwd, rest = step_split(out, dataclasses.replace(cfg, num_layers=layers), base + argv,
                                   dev, torch.cuda.synchronize)
        adamw = argv[argv.index("--mode") + 1] == "adamw"
        rec = {"losses": losses, "step_s": out["step_s"], "wall_s": wall,
               "peak_gb": out["peak_bytes"] / 1e9, "flash_attention": counts["flash_attention"],
               "flash_attention_bwd": counts["flash_attention_bwd"],
               "flash_attention_bwd_by_route": routes_bwd,
               "split_s": {"forward_backward": fwd_bwd, "update" if adamw else "rest": rest}}
        print(f"  {label}: loss by step {json.dumps(losses)}; s a step "
              f"{json.dumps([round(t, 4) for t in out['step_s']])} (one more step split: "
              f"forward + backward {fwd_bwd:.4f} s" + (
                  f", the update {rest:.4f} s" if adamw else
                  f" (every chain's, summed), the rest {rest:.4f} s (the step less that)")
              + "); peak "
              f"max_memory_allocated "
              f"{rec['peak_gb']:.2f} GB; wall {wall:.2f} s; launches flash_attention "
              f"{counts['flash_attention']} (tensor_core), flash_attention_bwd "
              f"{counts['flash_attention_bwd']} (tensor_core; {layers} layers x {chains} chains "
              f"x {steps} steps, remat) ok", flush=True)
        record[label] = rec
        return out

    # (b) adamw at the reference's rate, 3e-4: the first step lowers the loss
    # (fresh batches of the u^4 token marginal). Later steps need not, and the
    # gate holds no more: on an NVIDIA H100 80GB HBM3, 700 W, the loss went
    # 12.47, 12.04, 13.44, 13.19, 12.73, 12.30 at this rate; with the max
    # detached outside the exponent too (no extra one-hot(argmax) term, the
    # reference's fault) 12.47, 12.70, 13.85, 28.31, so the term does not
    # cause the rise; at 1e-4 it went 12.47, 12.18, 12.42, 12.37
    out = run("(b) adamw 28 layers", ["--mode", "adamw", "--steps", "4"],
              layers=28, chains=1, steps=4)
    if not out["losses"][1] < out["losses"][0]:
        raise AssertionError(f"(b) adamw: the first step did not lower the loss: {out['losses']}")
    del out
    torch.cuda.empty_cache()

    # (c) epmcmc: per-chain losses finite, the Welford count steps − burn-in,
    # the diagonal parametric product finite
    for label, layers, chains in (("(c) epmcmc 1 chain x 28 layers", 28, 1),
                                  ("(c) epmcmc 4 chains x 2 layers", 2, 4)):
        out = run(label, ["--mode", "epmcmc", "--steps", "3", "--burn-in", "1", "--chains",
                          str(chains), "--layers", str(layers)], layers=layers, chains=chains,
                  steps=3)
        count, finite = out["welford_count"], out["combined_finite"]
        if count != [2.0] * chains or not finite:
            raise AssertionError(f"{label}: Welford count {count} (want 2 a chain), combined "
                                 f"finite {finite}")
        print(f"  {label}: Welford count {count}, combine_parametric_diag over "
              f"{out['combined_dims']} dims finite", flush=True)
        del out
        torch.cuda.empty_cache()

    # (d) an interrupted 4-chain run resumed bit for bit: reduced (4 layers,
    # d 128, float32), seq 1,088 > attn_chunk so every layer runs the flash
    # kernels (the FMA forward route at hd 32)
    reduced_run = ["--arch", "llama3.2-3b", "--reduced", "--mode", "epmcmc", "--chains", "4",
                   "--burn-in", "1", "--batch", "1", "--seq", "1088", "--log-every", "100"]
    kernels.reset_launches()
    full = train.main(reduced_run + ["--steps", "4"])["state"]
    with tempfile.TemporaryDirectory() as ckdir:
        ck = ["--ckpt-dir", ckdir, "--ckpt-every", "2"]
        train.main(reduced_run + ["--steps", "2"] + ck)
        resumed = train.main(reduced_run + ["--steps", "4", "--resume"] + ck)["state"]
    torch.cuda.synchronize()
    counts = kernels.launch_counts()
    diffs = {f"{key}/{name}": float((t.float() - getattr(resumed, key)[name].float()).abs().max())
             for key in ("params", "v", "m_mean", "m_var") for name, t in getattr(full, key).items()}
    same = (all(torch.equal(t, getattr(resumed, key)[name]) for key in ("params", "v", "m_mean",
                                                                        "m_var")
                for name, t in getattr(full, key).items())
            and torch.equal(full.m_count, resumed.m_count)
            and all(torch.equal(a.get_state(), b.get_state())
                    for a, b in zip(full.gens, resumed.gens)))
    print(f"  (d) reduced epmcmc, 4 chains: 4 steps against 2 + checkpoint + resume 2: "
          f"{'bit for bit' if same else 'DIFFERENT'} (largest |diff| {max(diffs.values()):.3e}); "
          f"launches flash_attention {counts['flash_attention']}, flash_attention_bwd "
          f"{counts['flash_attention_bwd']} (by route {bwd_kernel.route_launches})", flush=True)
    if (not same or counts["flash_attention_bwd"] != 4 * 4 * 8
            or bwd_kernel.route_launches != {"tensor_core": 0, "fma": 4 * 4 * 8}):
        raise AssertionError("(d) the resumed run differs from the uninterrupted one, or the "
                             "kernels were not launched (4 layers x 4 chains x 8 steps, the "
                             "float32 backward on the FMA route)")
    record["resume_bitwise"] = same
    del full, resumed
    torch.cuda.empty_cache()

    # (e) the synchronous baseline
    out = run("(e) sgd 4 chains x 2 layers", ["--mode", "sgd", "--steps", "2", "--chains", "4",
                                              "--layers", "2"], layers=2, chains=4, steps=2)
    del out
    torch.cuda.empty_cache()
    print(f"  train path launches {json.dumps(launches_train)}, flash_attention by route "
          f"{json.dumps(routes_train)}, flash_attention_bwd by route "
          f"{json.dumps(routes_train_bwd)}", flush=True)
    return launches_train, routes_train, routes_train_bwd, record


def flash_bwd_timing(dev, gen, flush):
    """Phase 5's flash_attention_bwd row at the training shape (B=1, K=8,
    G=3, S=T=4096, hd=hd_v=128, bf16, causal): the bf16 tensor-core route
    (the one the path takes) warm, with a cold L2 and its host enqueue; the
    FMA route on the same tensors (``ops._launch_bwd(route="fma")``, the
    first design, which float32 still takes); each route's split between its
    dq and dkdv kernels (``torch.profiler``); the plain version (float32
    arithmetic); autograd of PyTorch's scaled_dot_product_attention's
    backward on the same tensors (the library yardstick; the port never
    calls it); and the forward with and without lse. Bound: the backward's
    products, 2.5 times the forward's 2·(hd + hd_v) flop per visible pair
    (FlashAttention-2's five products), over the bf16 tensor-core rate,
    against q, k, v, out, dout and lse read once and dq, dk, dv written
    once; beside it the tensor-core design's own bound (its seven products,
    the dq kernel's recomputed S and dP included) and the float32 FMA
    bound."""
    import torch

    from repro_torch.kernels.flash_attention import (
        flash_attention,
        flash_attention_bwd,
        flash_attention_bwd_ref,
        ops,
    )
    from repro_torch.launch.flash_bwd_probe import bwd_part, kernel_split_ms

    B, K, G, hd, S = 1, 8, 3, 128, 4096
    q = torch.randn((B, S, K, G, hd), generator=gen, device=dev).to(torch.bfloat16)
    k = torch.randn((B, S, K, hd), generator=gen, device=dev).to(torch.bfloat16)
    v = torch.randn((B, S, K, hd), generator=gen, device=dev).to(torch.bfloat16)
    dout = torch.randn((B, S, K, G, hd), generator=gen, device=dev).to(torch.bfloat16)
    out, lse = flash_attention(q, k, v, return_lse=True)
    if ops._route_bwd(q, k, v, out, dout) != "tensor_core":
        raise AssertionError("flash_attention_bwd: the training shape is not on the tensor-core "
                             "route")
    run = lambda: flash_attention_bwd(q, k, v, out, lse, dout)  # noqa: E731
    run_fma = lambda: ops._launch_bwd(q, k, v, out, lse, dout, True, S, route="fma")  # noqa: E731
    ms, host = device_ms(run, iters=10)
    cold, _ = device_ms(run, iters=5, flush=flush)
    fma_ms, fma_host = device_ms(run_fma, iters=10)
    split = {}
    for route, fn in (("tensor_core", run), ("fma", run_fma)):
        parts = {"dq": 0.0, "dkdv": 0.0}
        for key, part_ms in kernel_split_ms(fn, 5).items():
            if bwd_part(key):
                parts[bwd_part(key)] += part_ms
        split[route] = {f"{part}_ms": x for part, x in parts.items()}
    plain, _ = device_ms(lambda: flash_attention_bwd_ref(q, k, v, out, lse, dout), iters=1)
    fwd_ms, _ = device_ms(lambda: flash_attention(q, k, v), iters=10)
    fwd_lse_ms, _ = device_ms(lambda: flash_attention(q, k, v, return_lse=True), iters=10)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    qh = q.reshape(B, S, K * G, hd).transpose(1, 2).detach().requires_grad_()
    kh, vh = (x.transpose(1, 2).detach().requires_grad_() for x in (k, v))
    gout = dout.reshape(B, S, K * G, hd).transpose(1, 2)
    try:
        o = sdpa(qh, kh, vh, is_causal=True, enable_gqa=True)
        how = "enable_gqa"
        lib_run = lambda: torch.autograd.grad(o, (qh, kh, vh), gout, retain_graph=True)  # noqa: E731
    except TypeError:  # an older PyTorch: repeat the KV heads for it
        kr, vr = (x.detach().repeat_interleave(G, dim=1).requires_grad_() for x in (kh, vh))
        o = sdpa(qh, kr, vr, is_causal=True)
        how = "KV heads repeated"
        lib_run = lambda: torch.autograd.grad(o, (qh, kr, vr), gout, retain_graph=True)  # noqa: E731
    lib_ms, _ = device_ms(lib_run, iters=10)
    nbytes = 2 * (3 * B * S * K * G * hd + 2 * B * S * K * hd) + 4 * B * S * K * G \
        + 2 * (B * S * K * G * hd + 2 * B * S * K * hd)
    flops = 2.5 * 2 * (hd + hd) * B * K * G * S * (S + 1) // 2
    bound, bound_by = least_ms(nbytes, flops, peak=BF16_FLOPS)
    design, _ = least_ms(nbytes, flops * 7 / 5, peak=BF16_FLOPS)
    bound32, _ = least_ms(nbytes, flops)
    tc, fm = split["tensor_core"], split["fma"]
    print(f"  flash_attention_bwd B={B} K={K} G={G} S=T={S} hd={hd} causal bf16: tensor_core "
          f"route {ms * 1e3:.2f} us (cold L2 {cold * 1e3:.2f} us; host enqueue "
          f"{host * 1e3:.2f} us/call; profiler: dq {tc['dq_ms'] * 1e3:.2f} us, dkdv "
          f"{tc['dkdv_ms'] * 1e3:.2f} us), fma route {fma_ms * 1e3:.2f} us (dq "
          f"{fm['dq_ms'] * 1e3:.2f} us, dkdv {fm['dkdv_ms'] * 1e3:.2f} us), plain "
          f"{plain * 1e3:.2f} us, scaled_dot_product_attention backward ({how}) "
          f"{lib_ms * 1e3:.2f} us, bound {bound * 1e3:.2f} us by {bound_by} at the bf16 "
          f"tensor-core rate ({flops:.4e} flop, {nbytes / 1e6:.1f} MB; the tensor-core design's "
          f"7 products {design * 1e3:.2f} us; {bound32 * 1e3:.2f} us at the float32 FMA rate); "
          f"the forward at this shape {fwd_ms * 1e3:.2f} us without lse, "
          f"{fwd_lse_ms * 1e3:.2f} us with", flush=True)
    row = {"name": "flash_attention_bwd", "ms": ms, "cold_ms": cold, "host_ms": host,
           "plain_ms": plain, "bound_ms": bound, "bound_by": bound_by,
           "bound_ms_design": design, "bound_ms_float32": bound32, "library_ms": lib_ms,
           "split_ms": split["tensor_core"],
           "fma_route": {"ms": fma_ms, "host_ms": fma_host, "split_ms": split["fma"]},
           "forward_ms": fwd_ms, "forward_lse_ms": fwd_lse_ms,
           "shape": f"B={B} K={K} G={G} S=T={S} hd={hd} causal bfloat16"}
    del q, k, v, dout, out, lse, qh, kh, vh, gout, o, lib_run
    torch.cuda.empty_cache()
    return row


def multi_device_phase(dev, kernels, img_kernel, online_kernel, *, paper_theta, paper_errors,
                       paper_timings, paper_lr, sample_lr, paper_img, stream_sr, stream_theta,
                       stream_sub, launches_stream, stream_img, n_chunks, cells, mres):
    """Phase 4h: multi-device EP-MCMC on one card. Two chain groups on two
    streams of cuda:0 (the counterpart of a forced host device count): (a)
    the paper's pipeline, (b) the fused stream and an interrupted,
    checkpointed chunked run, (c) the 8-cell sweep fanned out, (d) the launch
    in 1 and 2 processes. Returns the launches of (a) and (b) and the walls."""
    import tempfile

    import torch

    from repro_torch.api import Pipeline, run_matrix
    from repro_torch.api.backends import CHECK_TRANSITIONS
    from repro_torch.launch.mcmc_run import PAPER_SPEC, POISSON_SPEC, STREAM_SPEC

    phase("4h multi-device on one card: two chain groups on two streams of cuda:0, "
          "mesh_fanout, the launch over a TCPStore")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    print(f"  {smi}", flush=True)
    two, walls = (dev, dev), {}
    gt_lr = paper_lr - sample_lr

    # (a) the paper's pipeline on two groups of five chains
    spec_a = dataclasses.replace(PAPER_SPEC, mesh_shape=(2, 1))
    kernels.reset_launches()
    t0 = time.perf_counter()
    pipe = Pipeline(spec_a, devices=two)
    board = pipe.run()
    torch.cuda.synchronize()
    walls["a"] = time.perf_counter() - t0
    launches_a, routes_a = kernels.launch_counts(), dict(img_kernel.route_launches)
    draws = pipe.sample()
    print(board.table(), flush=True)
    print(f"  (a) backend={board.backend} collectives_checked={board.collectives_checked} "
          f"wall_s={walls['a']:.3f} timings_s={json.dumps(board.timings)}", flush=True)
    print(f"  (a) launches={json.dumps(launches_a)}", flush=True)
    print(f"  (a) sample_s on two groups {board.timings['sample_s']:.4f} s against phase 4's "
          f"one group {paper_timings['sample_s']:.4f} s (two groups on one card: no speed-up "
          "expected)", flush=True)
    if draws.backend != "mesh[cuda](2 devices)" or not board.collectives_checked:
        raise AssertionError(f"(a) backend {draws.backend}, checked {board.collectives_checked}")
    if not torch.equal(draws.theta, paper_theta):
        raise AssertionError("(a) the mesh's θ differs from phase 4's: max |diff| "
                             f"{float((draws.theta - paper_theta).abs().max())}")
    if board.errors != paper_errors:
        raise AssertionError(f"(a) errors {board.errors}, phase 4 {paper_errors}")
    want_lr = 2 * sample_lr + gt_lr + 2 * CHECK_TRANSITIONS
    if launches_a["logreg_loglik_grad"] != want_lr:
        raise AssertionError(f"(a) logreg_loglik_grad launched "
                             f"{launches_a['logreg_loglik_grad']} times, expected {want_lr}")
    if routes_a != paper_img or launches_a["flash_attention"] != 0:
        raise AssertionError(f"(a) img_log_weights by route {routes_a}, phase 4 {paper_img}")
    print(f"  (a) θ bitwise phase 4's, every error equal; logreg_loglik_grad {want_lr} = 2 x "
          f"{sample_lr} (each group's chains, G = 5) + {gt_lr} (the groundtruth chain, one "
          f"device) + 2 x {CHECK_TRANSITIONS} (the chain-group check's eager transitions)",
          flush=True)
    del pipe, draws

    # (b) the fused stream on the groups, then chunked with checkpoints
    spec_b = dataclasses.replace(STREAM_SPEC, mesh_shape=(2, 1))
    kernels.reset_launches()
    t0 = time.perf_counter()
    pipe = Pipeline(spec_b, devices=two)
    srm = pipe.stream_combine()
    board = pipe.run()
    torch.cuda.synchronize()
    walls["b_fused"] = time.perf_counter() - t0
    launches_b = kernels.launch_counts()
    routes_b, online_b = dict(img_kernel.route_launches), dict(online_kernel.route_launches)
    theta_b = pipe.sample()
    print(f"  (b) fused: backend={theta_b.backend} wall_s={walls['b_fused']:.3f} "
          f"timings_s={json.dumps(board.timings)}", flush=True)
    print(f"  (b) fused: launches={json.dumps(launches_b)}", flush=True)
    if theta_b.backend != "mesh[cuda,fused](2 devices)":
        raise AssertionError(f"(b) backend {theta_b.backend}")
    if not torch.equal(theta_b.theta, stream_theta):
        raise AssertionError("(b) the fused mesh stream's θ differs from 4c's")
    for name in STREAM_SPEC.combiner_names():
        if not torch.equal(srm.combined[name].samples, stream_sr.combined[name].samples):
            raise AssertionError(f"(b) final {name} differs from 4c's")
    if [(r["t"], r["combiner"], r["error"]) for r in srm.trajectory] != \
            [(r["t"], r["combiner"], r["error"]) for r in stream_sr.trajectory]:
        raise AssertionError("(b) trajectory differs from 4c's")
    for name in ("img_log_weights", "machine_kde_log_density", "kde_log_density",
                 "online_update", "flash_attention"):
        if launches_b[name] != launches_stream[name]:
            raise AssertionError(f"(b) {name} launched {launches_b[name]} times, 4c "
                                 f"{launches_stream[name]}")
    if routes_b != stream_img or online_b != {"whole": n_chunks, "slab": 0}:
        raise AssertionError(f"(b) routes {routes_b} / {online_b}, 4c {stream_img}")
    want_lr_b = launches_stream["logreg_loglik_grad"] + sample_lr + 2 * CHECK_TRANSITIONS
    if launches_b["logreg_loglik_grad"] != want_lr_b:
        raise AssertionError(f"(b) logreg_loglik_grad {launches_b['logreg_loglik_grad']}, "
                             f"expected {want_lr_b}")
    print(f"  (b) fused: θ, the {len(srm.combined)} finals and the {len(srm.trajectory)} "
          f"trajectory rows equal 4c's; combine-stage launches as 4c's (img_log_weights "
          f"{json.dumps(routes_b)}, machine_kde_log_density "
          f"{launches_b['machine_kde_log_density']}, online_update {json.dumps(online_b)})",
          flush=True)
    del pipe, srm
    every = STREAM_SPEC.stream_every
    with tempfile.TemporaryDirectory() as ckpt:
        t0 = time.perf_counter()
        part = Pipeline(spec_b, devices=two, checkpoint_dir=ckpt,
                        checkpoint_every=every).stream_combine(max_steps=STREAM_SPEC.T // 2,
                                                               score=False)
        pipe = Pipeline(spec_b, devices=two, checkpoint_dir=ckpt, checkpoint_every=every)
        full = pipe.stream_combine(score=False)
        torch.cuda.synchronize()
        walls["b_resume"] = time.perf_counter() - t0
        resumed = pipe.sample()
    print(f"  (b) chunked: first session {part.t_done}/{part.total} complete={part.complete}, "
          f"second {full.t_done}/{full.total} complete={full.complete} "
          f"backend={resumed.backend} wall_s={walls['b_resume']:.3f}", flush=True)
    if part.complete or part.t_done != STREAM_SPEC.T // 2 or not full.complete or \
            resumed.backend != "mesh[cuda,resumable](2 devices)":
        raise AssertionError("(b) the interrupted mesh run did not stop at max_steps and finish")
    if not torch.equal(resumed.theta, stream_theta):
        raise AssertionError("(b) the resumed mesh run's θ differs from the run without a break")
    for name in STREAM_SPEC.combiner_names():
        if not torch.equal(full.combined[name].samples, stream_sub.combined[name].samples):
            raise AssertionError(f"(b) resumed final {name} differs from 4c's subscriber run")
    print("  (b) chunked: resumed θ bitwise the run without a break (4c's); finals bitwise "
          "4c's subscriber run", flush=True)
    del pipe, resumed, full, part

    # (c) the 8-cell sweep dealt out over the two streams
    t0 = time.perf_counter()
    mres_f = run_matrix(cells, backend="mesh_fanout", devices=two)
    torch.cuda.synchronize()
    walls["c"] = time.perf_counter() - t0
    print(mres_f.table(), flush=True)
    same = [(a["spec_id"], a["combiner"], a["accept"]) == (b["spec_id"], b["combiner"],
                                                            b["accept"])
            and (a["error"] == b["error"] or (math.isnan(a["error"])
                                              and math.isnan(b["error"])))
            for a, b in zip(mres.rows, mres_f.rows)]
    if len(mres_f.rows) != len(mres.rows) or not all(same):
        raise AssertionError(f"(c) fan-out rows differ from 4g's: {same}")
    if mres_f.backend != "mesh_fanout[cuda](2 devices)" or mres_f.n_executables != 2 or \
            not mres_f.collectives_checked:
        raise AssertionError(f"(c) {mres_f.backend}, {mres_f.n_executables} fans, checked "
                             f"{mres_f.collectives_checked}")
    print(f"  (c) {len(mres_f.rows)} rows equal 4g's (error and acceptance); "
          f"{mres_f.n_executables} fans, {mres_f.n_graphs} graphs, collectives_checked="
          f"{mres_f.collectives_checked}; wall_s={walls['c']:.3f} (4g's batched sweep beside "
          "it in that phase)", flush=True)

    # (d) the launch: 1 and then 2 processes on cuda:0
    root = os.path.dirname(os.path.realpath(__file__))
    for label, spec in (("PAPER_SPEC", PAPER_SPEC), ("POISSON_SPEC", POISSON_SPEC)):
        args = ["--model", spec.model, "--sampler", spec.resolved_sampler(), "--combiner",
                "online", "--M", str(spec.M), "--T", str(spec.T), "--warmup", str(spec.warmup),
                "--step", str(spec.step_size), "--n", str(spec.n), "--seed", str(spec.seed),
                "--stream-every", "120"]
        with tempfile.TemporaryDirectory() as out:
            t0 = time.perf_counter()
            (one,) = launch_ranks(root, args, 1, out)
            walls[f"d_{label}_1"] = time.perf_counter() - t0
            t0 = time.perf_counter()
            ranks = launch_ranks(root, args, 2, out)
            walls[f"d_{label}_2"] = time.perf_counter() - t0
        d = len(one["combined"]["online"]["mean"])
        per = spec.M // 2
        want_bytes = npz_bytes((per,), (per, d), (per, d, d)) + npz_bytes((per,))
        for r, rec in enumerate(ranks):
            print(f"  (d) {label} {spec.model}/{spec.resolved_sampler()} rank {r} of 2: "
                  f"wall_s={rec['wall_s']:.3f} store_bytes={rec['store_bytes']} (its draws "
                  f"{4 * per * spec.T * d} bytes)", flush=True)
        print(f"  (d) {label} 1 process: wall_s={one['wall_s']:.3f}; processes' walls "
              f"{walls[f'd_{label}_1']:.3f} s and {walls[f'd_{label}_2']:.3f} s", flush=True)
        if one["backend"] != "torch.distributed(1 processes)" or \
                {r["backend"] for r in ranks} != {"torch.distributed(2 processes)"}:
            raise AssertionError(f"(d) {label} backends {one['backend']}, "
                                 f"{[r['backend'] for r in ranks]}")
        if {r["spec_id"] for r in ranks} != {one["spec_id"]}:
            raise AssertionError(f"(d) {label} spec ids differ")
        for r, rec in enumerate(ranks):
            if rec["combined"]["online"]["samples"] != one["combined"]["online"]["samples"] or \
                    rec["combined"]["online"]["mean"] != one["combined"]["online"]["mean"]:
                raise AssertionError(f"(d) {label} rank {r}'s online samples differ from the "
                                     "1-process run's")
            if rec["store_bytes"] != want_bytes:
                raise AssertionError(f"(d) {label} rank {r} put {rec['store_bytes']} bytes, "
                                     f"its moments and acceptance rates are {want_bytes}")
        print(f"  (d) {label}: both ranks' online samples bitwise the 1-process run's; each "
              f"rank put {want_bytes} bytes (count, mean, m2 of {per} chains at d = {d} and "
              "their acceptance rates; no shape holds T)", flush=True)
    print(f"  4h walls: {json.dumps(walls)}", flush=True)
    return launches_a, launches_b, walls


def main() -> int:
    import torch

    t_start = time.perf_counter()
    phase("1 device")
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is visible; this script runs only on an "
              "NVIDIA card", file=sys.stderr)
        return 2
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    kind = torch.cuda.get_device_name(0)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} device {kind} "
          f"count {torch.cuda.device_count()}", flush=True)

    root = os.path.dirname(os.path.realpath(__file__))
    sys.path.insert(0, os.path.join(root, "src"))
    from repro_torch import kernels
    from repro_torch.api import Pipeline
    from repro_torch.api.pipeline import combine_spec_draws
    from repro_torch.core.combiners import masked_silverman
    from repro_torch.kernels.img_weights import (
        img_log_weights,
        img_log_weights_ref,
        img_sweep,
        img_sweep_ref,
        sweep_agreement,
    )
    from repro_torch.core.combiners import img as img_engine
    from repro_torch.core.combiners.api import resolve_schedule
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
    from repro_torch.kernels.flash_attention import flash_attention, flash_attention_ref
    from repro_torch.kernels.online_update import online_moments_update, online_moments_update_ref
    from repro_torch.configs import get_config as lm_config
    from repro_torch.launch import serve
    from repro_torch.launch.mcmc_run import (
        ALL_SPEC, GMM_SPEC, LINEAR_SPEC, PAPER_SPEC, POISSON_SPEC, STREAM_SPEC)
    from repro_torch.samplers import randgamma
    from repro_torch.models.lm import model as lm_model

    dev = torch.device("cuda", 0)

    phase("2 build")
    seconds = kernels.build()
    print(f"  build: {seconds:.2f} s", flush=True)
    for source, k in {k.source.name: k for k in kernels.KERNELS.values()}.items():
        entry = ""
        for line in k.build_log.splitlines():
            if "Compiling entry function" in line:
                entry = f"{kernel_label(line)}: "
            if "(C7519)" in line:  # ptxas's notes on the arrives it adds before wgmma
                continue
            if "registers" in line or "spill" in line or "built earlier" in line \
                    or "warning" in line:
                print(f"  {source}: {entry}{line.strip()}", flush=True)

    phase("3 kernel vs plain version on the card")
    gen = torch.Generator(device=dev).manual_seed(1234)

    def logreg_inputs(G, N, d, C):
        X = torch.randn((G, N, d), generator=gen, device=dev)
        y = torch.where(torch.rand((G, N), generator=gen, device=dev) < 0.5, -1.0, 1.0)
        beta = torch.randn((G, d, C), generator=gen, device=dev)  # the data's own β scale
        return X, y, beta

    # ℓ sums up to 50,000 terms of size ~10 in another order than the plain
    # version: float32 relative error ~1e-6, so rtol 1e-5; ∇ℓ entries the same
    # with atol for entries that cancel to ~0.
    errs = {}
    flash_err64 = {}  # flash_attention's largest float64 error, by route
    shapes = {"sample": (10, 5000, 50, 1), "groundtruth": (1, 50000, 50, 1),
              "N=1": (1, 1, 50, 1), "N=4999,d=37,C=2": (3, 4999, 37, 2)}
    for label, shape in shapes.items():
        X, y, beta = logreg_inputs(*shape)
        ll, g = logreg_loglik_grad(X, y, beta, scale=0.5)
        torch.cuda.synchronize()
        ll_r, g_r = logreg_loglik_grad_ref(X, y, beta, scale=0.5)
        e1 = check_close(f"logreg_loglik_grad {label} {shape} ll", ll, ll_r, rtol=1e-5, atol=1e-3)
        e2 = check_close(f"logreg_loglik_grad {label} {shape} grad", g, g_r, rtol=1e-4, atol=1e-2)
        errs["logreg_loglik_grad"] = max(errs.get("logreg_loglik_grad", 0.0), e1, e2)
    X, y, beta = logreg_inputs(10, 5000, 50, 1)
    b1 = beta.clone().requires_grad_(True)
    (g_kernel,) = torch.autograd.grad(logreg_loglik(X, y, b1).sum(), b1)
    torch.cuda.synchronize()
    b2 = beta.clone().requires_grad_(True)
    (g_plain,) = torch.autograd.grad(logreg_loglik_grad_ref(X, y, b2)[0].sum(), b2)
    e = check_close("autograd of logreg_loglik vs autograd of the plain ℓ", g_kernel, g_plain,
                    rtol=1e-4, atol=1e-2)
    errs["logreg_loglik_grad"] = max(errs["logreg_loglik_grad"], e)

    # one launch, no float atomics: the same bits in three more runs and in
    # three replays of one captured graph (the last block resets its ticket)
    for label, shape in (("sample", shapes["sample"]), ("groundtruth", shapes["groundtruth"])):
        X, y, beta = logreg_inputs(*shape)
        first = logreg_loglik_grad(X, y, beta)
        runs = [logreg_loglik_grad(X, y, beta) for _ in range(3)]
        tally = kernels.LaunchTally()
        graph = torch.cuda.CUDAGraph()
        with tally.capturing(), torch.cuda.graph(graph):
            static = logreg_loglik_grad(X, y, beta)
        for _ in range(3):
            graph.replay()
            tally.replay()
            runs.append(tuple(t.clone() for t in static))
        torch.cuda.synchronize()
        if not all(torch.equal(a, b) for r in runs for a, b in zip(r, first)):
            raise AssertionError(f"logreg_loglik_grad {label}: runs or graph replays differ")
        if tally.launches["logreg_loglik_grad"] != 1:
            raise AssertionError(f"the captured graph holds {tally.launches} launches, not one")
        print(f"  logreg_loglik_grad {label} {shape}: three more runs and three graph replays, "
              f"the same bits", flush=True)
        del X, y, beta, first, runs, static, graph

    # the chain loops: warmup, burn-in and collection each replay one captured
    # CUDA graph; the eager loop they replace, written out here (a kernel
    # rebuilt at exp(log ε) every warmup step, then kernel.step drawing its
    # own noise), must give the same θ, accept flags and adapted ε bitwise
    from repro_torch.core.subposterior import make_subposterior_logpdf, partition_data
    from repro_torch.models.bayes import get_model
    from repro_torch.samplers import chain_collect, chain_setup, da_init, da_update
    from repro_torch.samplers.mala import mala_kernel

    lr_model = get_model("logreg")
    M_c, W_c, B_c, T_c = 10, 40, 30, 60
    data_c, _ = lr_model.generate_data(torch.Generator(device=dev).manual_seed(5), 10_000)
    shards_c, _ = partition_data(data_c, M_c, only=lr_model.shard_keys, pad=True)
    lp_c = make_subposterior_logpdf(lr_model.log_prior, lr_model.log_lik,
                                    lr_model.prepare_data(shards_c), M_c)
    pos_c = torch.zeros(M_c, lr_model.d, device=dev)
    k_lr = kernels.KERNELS["logreg_loglik_grad"]
    n0 = k_lr.launches
    g_c = torch.Generator(device=dev).manual_seed(6)
    kern_c, state_c, eps_c = chain_setup(g_c, lambda e: mala_kernel(lp_c, e), pos_c,
                                         burn_in=B_c, warmup=W_c, initial_step_size=0.1,
                                         target_accept=0.55)
    _, theta_c, info_c = chain_collect(g_c, kern_c, state_c, T_c)
    torch.cuda.synchronize()
    graphed_launches = k_lr.launches - n0
    g_c = torch.Generator(device=dev).manual_seed(6)
    da_c = da_init(0.1, (M_c,), dev)
    s_c = mala_kernel(lp_c, torch.exp(da_c.log_eps)[:, None]).init(pos_c)
    for _ in range(W_c):
        s_c, i_c = mala_kernel(lp_c, torch.exp(da_c.log_eps)[:, None]).step(g_c, s_c)
        da_c = da_update(da_c, i_c.accept_prob, 0.55)
    step_c = torch.exp(da_c.log_eps_avg)[:, None]
    eager_c = mala_kernel(lp_c, step_c)
    s_c = eager_c.init(s_c.position)
    for _ in range(B_c):
        s_c, _ = eager_c.step(g_c, s_c)
    rows_c, acc_c = [], []
    for _ in range(T_c):
        s_c, i_c = eager_c.step(g_c, s_c)
        rows_c.append(s_c.position)
        acc_c.append(i_c.is_accepted)
    torch.cuda.synchronize()
    if not (torch.equal(eps_c, step_c) and torch.equal(theta_c, torch.stack(rows_c, dim=1))
            and torch.equal(info_c.is_accepted, torch.stack(acc_c, dim=-1))):
        raise AssertionError("graphed chains differ from the eager loop")
    if graphed_launches != 2 + W_c + B_c + T_c:
        raise AssertionError(f"graphed chains counted {graphed_launches} likelihood launches, "
                             f"expected {2 + W_c + B_c + T_c}")
    print(f"  graphed chains (M={M_c}, warmup {W_c}, burn-in {B_c}, T={T_c}): θ, accept flags "
          f"({int(info_c.is_accepted.sum())}/{info_c.is_accepted.numel()} accepted) and ε bitwise "
          f"the eager loop's; {graphed_launches} likelihood launches counted", flush=True)
    del data_c, shards_c, lp_c, theta_c, rows_c

    # the new transitions, each under BatchedChunkBackend (warmup, burn-in
    # and collection replaying captured CUDA graphs) against the eager loop
    # written out (the kernel's own step drawing its inputs, the warmup's
    # kernel rebuilt at exp(log ε) every step): θ, accept flags and adapted ε
    # bitwise, at the new specs' shard shapes (M = 10). Poisson Gibbs draws
    # its gamma variates in randgamma.ROUNDS fixed rounds and counts the lanes
    # no round resolved: the count must be 0 on both sides.
    check_new_transitions(dev)

    # log w ~ −SSE/(2h²) of size ~1e5 at h=0.05: float32 relative error ~1e-6
    for label, (P, M, d, h) in {"sweep": (160, 10, 50, 0.05), "P=161,d=37": (161, 10, 37, 0.3),
                                "P=1,M=1,d=1": (1, 1, 1, 1.0), "d=2": (160, 10, 2, 0.05),
                                "d=10": (160, 10, 10, 0.05), "d=20": (160, 10, 20, 0.05)}.items():
        theta = torch.randn((P, M, d), generator=gen, device=dev)
        h_t = torch.tensor(h, device=dev)
        out = img_log_weights(theta, h_t)
        torch.cuda.synchronize()
        e = check_close(f"img_log_weights {label} {(P, M, d)} h={h}", out,
                        img_log_weights_ref(theta, h_t), rtol=1e-5, atol=1e-3)
        errs["img_log_weights"] = max(errs.get("img_log_weights", 0.0), e)

    # the sweep route (one launch a kernel-mode IMG sweep) against its plain
    # version on the same carry and draws, ops.sweep_agreement: LW within the
    # generic route's rtol 1e-5 / atol 1e-3; accept flags equal wherever the
    # plain margin |log u − log ratio| exceeds four times that tolerance (a
    # chain whose flags part inside the margin leaves the carry check); the
    # carry equal in every other chain (indices, rows, counts exactly; mean
    # 1e-5, sumsq rtol 1e-5, extra rtol 1e-4). w_t and W_t at the path's
    # shape, at the path's own scale (spread 0.03: nearly every site accepts)
    # and at spread 0.3 (sites accept and reject), and at ragged shapes.
    img_kernel = kernels.KERNELS["img_log_weights"]

    def sweep_case(B, M, T, d, *, wt, ragged=False, spread=0.3, counts=None, samples=None):
        """A sweep's inputs: draws around a centre (or ``samples``), ragged
        counts NaN beyond them, the model, the engine's carry and draws (c,
        then u), h from the engine's schedule at its tenth sweep."""
        if samples is None:
            centre = torch.randn((d,), generator=gen, device=dev)
            samples = (centre + spread * torch.randn((M, 1, d), generator=gen, device=dev)
                       + spread * torch.randn((M, T, d), generator=gen, device=dev))
            counts = torch.full((M,), T, dtype=torch.int32, device=dev)
            if ragged:
                counts = torch.randint(T // 2, T, (M,), generator=gen, device=dev).to(torch.int32)
                rows = torch.arange(T, device=dev)[None, :, None]
                samples = torch.where(rows < counts[:, None, None], samples, float("nan"))
        model = (img_engine.semiparametric_model(samples, counts) if wt
                 else img_engine.nonparametric_model(samples))
        carry = img_engine._init_img_carry(gen, samples, counts, model.aux, B)
        c = img_engine._randint_below(gen, (B, M), counts)
        u = torch.rand((B, M), generator=gen, device=dev)
        h = resolve_schedule(samples, None, False)(10 * B)
        return samples, counts, model, carry, c, u, h

    sweep_cases = {"path scale": (16, 10, 1200, 50, False, 0.03),
                   "path": (16, 10, 1200, 50, False, 0.3), "d=37": (16, 10, 1200, 37, False, 0.3),
                   "B=1": (1, 10, 1200, 50, False, 0.3), "M=1": (16, 1, 1200, 50, False, 0.3),
                   "ragged": (16, 10, 1200, 50, True, 0.3),
                   "d=130": (4, 4, 600, 130, False, 0.3),  # W_t: 87 KB of shared memory
                   # phase 4e's widths (poisson, linear, gmm) at their path's B, M, T
                   "d=2": (16, 10, 1200, 2, False, 0.3), "d=2 path scale": (16, 10, 1200, 2, False, 0.03),
                   "d=10": (16, 10, 1200, 10, False, 0.3),
                   "d=10 path scale": (16, 10, 1200, 10, False, 0.03),
                   "d=20": (16, 10, 1200, 20, False, 0.3),
                   "d=20 path scale": (16, 10, 1200, 20, False, 0.03)}
    for label, (B, M, T, d, ragged, spread) in sweep_cases.items():
        for wt in (False, True):
            samples, _, model, carry, c, u, h = sweep_case(B, M, T, d, wt=wt, ragged=ragged,
                                                           spread=spread)
            term = model.state_term(h) if wt else None
            routes = dict(img_kernel.route_launches)
            got = img_sweep(carry, samples, c, u, h, aux=model.aux, state_term=term)
            torch.cuda.synchronize()
            if img_kernel.route_launches != dict(routes, sweep=routes["sweep"] + 1):
                raise AssertionError(f"img_sweep {label}: route counts went {routes} -> "
                                     f"{img_kernel.route_launches}, not one sweep launch")
            want = img_sweep_ref(carry, samples, c, u, h, model.aux,
                                 model.extra_logweight(h.expand(B)) if wt else None)
            rep = sweep_agreement(got, want, u)
            print(f"  img_log_weights [sweep] {'W_t' if wt else 'w_t'} {label} B={B} M={M} T={T} "
                  f"d={d} spread={spread}: LW max_abs_err={rep['lw_max_abs_err']:.3e} (rtol 1e-05, "
                  f"atol 0.001); {rep['inside_margin']}/{rep['sites']} sites inside the margin, "
                  f"{rep['accepted']} accepted, {rep['diverged_chains']} chains parted inside it, "
                  f"{rep['flag_faults']} flag and {rep['carry_faults']} carry faults, mean "
                  f"max_abs_err={rep['mean_max_abs_err']:.3e} {'ok' if rep['ok'] else 'FAIL'}",
                  flush=True)
            if not rep["ok"]:
                raise AssertionError(f"img_sweep {label}: the sweep route disagrees with its "
                                     f"plain version: {rep}")
            errs["img_log_weights"] = max(errs["img_log_weights"], rep["lw_max_abs_err"])
            if label == "path":  # one launch, no atomics: the same bits three more times
                if not all(torch.equal(a, b) for _ in range(3) for a, b in zip(
                        img_sweep(carry, samples, c, u, h, aux=model.aux, state_term=term), got)):
                    raise AssertionError("img_sweep: three more launches of one input differ")
                print(f"  img_log_weights [sweep] {'W_t' if wt else 'w_t'} path: three more "
                      f"launches, the same bits", flush=True)

    # The KDE kernel forms ‖q_c‖² + ‖s_c‖² − 2q_c·s_c on centred operands with
    # the cross term as 3×TF32 on the tensor cores; its plain version mirrors
    # the reference's uncentred identity, which cancels in float32 at the
    # path's scale (draws ~√50 from the origin, spread 0.03, h ~0.025).
    # Against the float32 plain version the tolerance is that cancellation:
    # one log-kernel term is off by up to ~ε·(‖q‖² + ‖s‖²)/2h² per rounding,
    # ε = 2^-23, and a float64 numpy check (d = 50, T = 1,200) found up to
    # 0.072 at spread 0.02, i.e. ~0.2× this per-rounding figure; atol = 16× it
    # (×M for the product over machines), rtol 1e-5. Against the plain version
    # in float64 the tolerance is the kernel's own: atol 1e-3 on log p̂ (×M for
    # the product), rtol 1e-5. −inf (an empty machine) must match exactly.
    # First the probe's check of one tile's product against float64: a
    # wrong wgmma descriptor gives wrong numbers, not an error.
    eps32 = 2.0**-23
    from repro_torch.launch.kde_probe import check_tile
    # its own generator: gen's stream, and so the KDE inputs, stay those the
    # FMA design's figures were taken on
    tile_gen = torch.Generator(device=dev).manual_seed(0)
    if not all(check_tile(tile_gen, d) for d in (50, 64, 8, 1)):
        raise AssertionError("machine_kde_log_density: one tile's product disagrees with float64")

    def kde_inputs(Q, M, T, d, *, ragged=False):
        """Draws at the logreg path's scale: a centre ~N(0, I), machine
        offsets and spread 0.03; queries from the pooled valid rows."""
        centre = torch.randn((d,), generator=gen, device=dev)
        s = (centre + 0.03 * torch.randn((M, 1, d), generator=gen, device=dev)
             + 0.03 * torch.randn((M, T, d), generator=gen, device=dev))
        q = s.reshape(M * T, d)[torch.randint(0, M * T, (Q,), generator=gen, device=dev)]
        counts = None
        if ragged:
            counts = torch.randint(2, T + 1, (M,), generator=gen, device=dev).to(torch.int32)
            counts[1], counts[2] = 0, 1  # an empty and a single-row machine
            rows = torch.arange(T, device=dev)[None, :, None]
            s = torch.where(rows < counts[:, None, None], s, float("nan"))
            h = 0.02 + 0.03 * torch.rand((M,), generator=gen, device=dev)
        else:
            h = masked_silverman(s, torch.full((M,), T, dtype=torch.int32, device=dev))
        return q.contiguous(), s.contiguous(), h, counts

    kde_cases = {
        "importance_pool Q=M*T": kde_inputs(12000, 10, 1200, 50),
        "init_pool Q=1000": kde_inputs(1000, 10, 1200, 50),
        "ragged T=1201 d=37": kde_inputs(500, 5, 1201, 37, ragged=True),
        "Q=M=T=d=1": (torch.randn((1, 1), generator=gen, device=dev),
                      torch.randn((1, 1, 1), generator=gen, device=dev),
                      torch.ones((1,), device=dev), None),
    }
    err32, err64_case = {}, {}
    for label, (q, s, h, counts) in kde_cases.items():
        s_valid = torch.nan_to_num(s, nan=0.0)
        spread = (float((q * q).sum(-1).max()) + float((s_valid * s_valid).sum(-1).max()))
        term = eps32 * spread / (2.0 * float(h.min()) ** 2)
        M = s.shape[0]
        for reduce in ("none", "product", "mixture", "product_mixture"):
            for weights in ("counts", "uniform"):
                got = machine_kde_log_density(q, s, h, counts, reduce=reduce, mixture_weights=weights)
                torch.cuda.synchronize()
                plain = machine_kde_log_density_ref(q, s, h, counts, reduce=reduce,
                                                    mixture_weights=weights)
                plain64 = machine_kde_log_density_ref(q.double(), s.double(), h.double(), counts,
                                                      reduce=reduce, mixture_weights=weights)
                got, plain, plain64 = (x if isinstance(x, tuple) else (x,)
                                       for x in (got, plain, plain64))
                outs = reduce.split("_")  # "product_mixture" returns (product, mixture)
                for out, g, p32, p64 in zip(outs, got, plain, plain64):
                    scale = M if out == "product" else 1
                    tag = f"machine_kde_log_density {label} {reduce}/{weights} [{out}]"
                    e32 = check_lp(f"{tag} vs float32 plain", g, p32, rtol=1e-5,
                                   atol=16.0 * term * scale)
                    e64 = check_lp(f"{tag} vs float64 plain", g, p64, rtol=1e-5, atol=1e-3 * scale)
                    err32["machine_kde_log_density"] = max(err32.get("machine_kde_log_density", 0.0), e32)
                    errs["machine_kde_log_density"] = max(errs.get("machine_kde_log_density", 0.0), e64)
                    err64_case[label] = max(err64_case.get(label, 0.0), e64)
        if label == "importance_pool Q=M*T":  # one launch, no atomics: the same bits three more times
            first = machine_kde_log_density(q, s, h, counts, reduce="product_mixture")
            if not all(torch.equal(a, b) for _ in range(3)
                       for a, b in zip(machine_kde_log_density(q, s, h, counts,
                                                               reduce="product_mixture"), first)):
                raise AssertionError("machine_kde_log_density: three more launches of one input differ")
            print(f"  machine_kde_log_density {label}: three more launches, the same bits", flush=True)
    for label, e64 in err64_case.items():
        old = FMA_KDE_ERR64[label]
        path = label.split()[0] in ("importance_pool", "init_pool")
        ok = not path or e64 <= 2.0 * old
        print(f"  machine_kde_log_density {label}: max abs err vs float64 {e64:.3e}, the FMA "
              f"design's {old:.3e} ({e64 / old:.2f}x){'; within 2x' if path else ''} "
              f"{'ok' if ok else 'FAIL'}", flush=True)
        if not ok:
            raise AssertionError(f"machine_kde_log_density {label}: {e64:.3e} is over twice the "
                                 f"FMA design's {old:.3e}")

    # the serving path's shapes: a reader's logpdf scores Q points (1 for a
    # probe, any batch otherwise) against the draw buffer as it grows (T =
    # 120·k up to 1,200), M = 10, d = 50, reduce product or mixture with
    # uniform weights; dense counts (the buffer's) and ragged ones. Points
    # are buffer rows plus noise. Tolerances as above.
    serve_kde_cases = 0
    for Q in (1, 7, 1000):
        for T_s in (120, 600, 1200):
            for ragged in (False, True):
                q, s, h, counts = kde_inputs(Q, 10, T_s, 50, ragged=ragged)
                q = (q + 0.01 * torch.randn(q.shape, generator=gen, device=dev)).contiguous()
                s_valid = torch.nan_to_num(s, nan=0.0)
                spread = (float((q * q).sum(-1).max()) + float((s_valid * s_valid).sum(-1).max()))
                term = eps32 * spread / (2.0 * float(h.min()) ** 2)
                for reduce in ("product", "mixture"):
                    got = machine_kde_log_density(q, s, h, counts, reduce=reduce,
                                                  mixture_weights="uniform")
                    torch.cuda.synchronize()
                    scale = 10 if reduce == "product" else 1
                    tag = (f"machine_kde_log_density serving Q={Q} T={T_s} "
                           f"{'ragged' if ragged else 'dense'} {reduce}/uniform")
                    e32 = check_lp(f"{tag} vs float32 plain", got, machine_kde_log_density_ref(
                        q, s, h, counts, reduce=reduce, mixture_weights="uniform"),
                        rtol=1e-5, atol=16.0 * term * scale)
                    e64 = check_lp(f"{tag} vs float64 plain", got, machine_kde_log_density_ref(
                        q.double(), s.double(), h.double(), counts, reduce=reduce,
                        mixture_weights="uniform"), rtol=1e-5, atol=1e-3 * scale)
                    err32["machine_kde_log_density"] = max(err32["machine_kde_log_density"], e32)
                    errs["machine_kde_log_density"] = max(errs["machine_kde_log_density"], e64)
                    serve_kde_cases += 1
    print(f"  machine_kde_log_density: {serve_kde_cases} serving-shape cases within their "
          f"tolerances", flush=True)

    # single cloud: the plain version forms distances directly, in float32
    for nq, ns, d in ((300, 700, 7), (1, 1, 1)):
        q = torch.randn((nq, d), generator=gen, device=dev)
        c = torch.randn((ns, d), generator=gen, device=dev)
        got = kde_log_density(q, c, 0.5)
        torch.cuda.synchronize()
        e32 = check_close(f"kde_log_density {(nq, ns, d)} h=0.5 vs float32 plain", got,
                          kde_log_density_ref(q, c, 0.5), rtol=1e-5, atol=1e-4)
        plain64 = machine_kde_log_density_ref(q.double(), c.double()[None], 0.5)[0]
        e64 = check_close(f"kde_log_density {(nq, ns, d)} h=0.5 vs float64 plain", got, plain64,
                          rtol=1e-5, atol=1e-3)
        err32["kde_log_density"] = max(err32.get("kde_log_density", 0.0), e32)
        errs["kde_log_density"] = max(errs.get("kde_log_density", 0.0), e64)

    # online_update sums the chunk mean and the centred Gram in another order
    # than the plain version. Against the plain version in float64 the
    # tolerance is the kernel's own float32 rounding: count exact, mean within
    # 1e-5·(1 + |mean|), m2 within 1e-5·max|m2| of each machine. Against the
    # float32 plain version, whose rounding adds as much again, 1e-4 (the
    # reference tests' figure). The cases and their inputs are
    # online_probe.CASES: the path's fold, ragged counts with NaN beyond them
    # and an empty machine, C = 1, C < 32 with d = 65, M = d = 1, and the
    # slab route's two shapes (the whole draw buffer as one chunk; d = 300)
    # and a machine span off every 16-byte boundary (d = 37, a slice of a
    # draw buffer from row 121); each checks which route's count rose, each
    # error is printed beside the first design's (ONLINE_ERR64_FIRST_DESIGN); the
    # ragged cases give the same bits in three more launches, and on the
    # slab route too.
    from repro_torch.kernels.online_update import ops as online_ops
    from repro_torch.launch.online_probe import CASES as ONLINE_CASES, case_inputs

    def online_err(label, got, want, rel):
        """Max abs error of the state; raises outside the stated tolerance."""
        (c, mu, m2), (cw, muw, m2w) = got, want
        mu_err = (mu.double() - muw.double()).abs()
        m2_err = (m2.double() - m2w.double()).abs()
        scale = m2w.double().abs().amax(dim=(1, 2), keepdim=True).clamp(min=1e-30)
        ok = (bool(torch.equal(c.double(), cw.double()))
              and bool(torch.isfinite(mu).all()) and bool(torch.isfinite(m2).all())
              and bool((mu_err <= rel * (1.0 + muw.double().abs())).all())
              and bool((m2_err <= rel * scale).all()))
        max_err = max(float(mu_err.max()), float(m2_err.max()))
        print(f"  {label}: max_abs_err={max_err:.3e} (mean rel {rel:g}·(1+|mean|), "
              f"m2 rel {rel:g}·max|m2|, count exact) {'ok' if ok else 'FAIL'}", flush=True)
        if not ok:
            raise AssertionError(f"{label}: kernel disagrees with its plain version")
        return max_err

    online_kernel = kernels.KERNELS["online_update"]
    online_routes_checked = set()
    for label in ONLINE_CASES:
        count, mean, m2, chunk, counts = case_inputs(label, dev)
        plan = online_ops._plan(*chunk.shape)
        before = dict(online_kernel.route_launches)
        got = online_moments_update(count, mean, m2, chunk, counts)
        torch.cuda.synchronize()
        rose = {r for r, n in online_kernel.route_launches.items() if n != before[r]}
        if rose != {plan.route}:
            raise AssertionError(f"online_update {label}: routes {rose} rose, planned {plan.route}")
        online_routes_checked.add(plan.route)
        shape = tuple(chunk.shape)
        want64 = online_moments_update_ref(count.double(), mean.double(), m2.double(),
                                           chunk.double(), counts)
        e64 = online_err(f"online_update [{plan.route}] {label} {shape} vs float64 plain", got,
                         want64, 1e-5)
        print(f"    the first design's float64 error on these inputs: "
              f"{ONLINE_ERR64_FIRST_DESIGN[label]:.3e}", flush=True)
        e32 = online_err(f"online_update [{plan.route}] {label} {shape} vs float32 plain", got,
                         online_moments_update_ref(count, mean, m2, chunk, counts), 1e-4)
        errs["online_update"] = max(errs.get("online_update", 0.0), e64)
        err32["online_update"] = max(err32.get("online_update", 0.0), e32)
        if not torch.equal(got[2], got[2].transpose(1, 2)):
            raise AssertionError(f"online_update {label}: m2 is not exactly symmetric")
        if counts is not None:  # the empty machine comes back as it went in, bit for bit
            if not all(torch.equal(x[0], y[0]) for x, y in zip(got, (count, mean, m2))):
                raise AssertionError("online_update changed a machine whose chunk count is 0")
            again = [online_moments_update(count, mean, m2, chunk, counts) for _ in range(3)]
            again.append(online_ops._launch(count, mean, m2, chunk, counts, route="slab"))
            if not all(torch.equal(a, b) for r in again for a, b in zip(r, got)):
                raise AssertionError(f"online_update {label}: another launch or the slab route "
                                     f"gave other bits")
            print(f"  online_update {label}: three more launches and the slab route the same "
                  f"bits", flush=True)
    if online_routes_checked != set(online_ops.ROUTES):
        raise AssertionError(f"online_update: only {online_routes_checked} were checked")

    # flash_attention sums q·k and P·v in float32 in another order than the
    # plain version's matrix products on every route (the "tf32x3" route from
    # 3×TF32 products, the bf16 tensor-core route rounding P to bfloat16
    # before P·v, as the bfloat16 plain version does). Against the plain
    # version in float64 on the same inputs: float32 within 2e-5
    # (+ 2e-5·|out|) on either float32 route; bfloat16 within the output's own
    # rounding, 2^-8 relative (1e-2 on values of size ~1). Against the float32
    # plain version: float32 1e-4 (the roundings add), bfloat16 1e-2 (both
    # round one float32 value to bfloat16). First one block's first tile of
    # the "tf32x3" route against float64 (flash_probe.check_tile: its raw
    # q·kᵀ and S·v, which a wrong descriptor or fragment cannot pass). Shapes:
    # the serving path's prefill (llama3.2-3b: 8 KV heads of 3 query heads,
    # hd 128, S = T = 4096, causal) in bf16 and float32, the reference tests'
    # GQA / hd_v≠hd and ragged non-causal shapes, MLA's hd 192 with hd_v 128,
    # a kv_len inside the causal reach, and every row masked (kv_len 0: zeros,
    # no NaN), all of which but the serving path take the FMA route in
    # float32; then each tensor-core route's own cases (G = 1, 3, 7, 8; hd 64;
    # ragged S = T; S ≪ T non-causal; kv_len < T non-causal; kv_len 0 at hd
    # 128), q as the model's (B,S,H,hd) view into a fused projection, and
    # operands the tensor maps cannot take (a base 2 or 4 bytes off 16, a
    # bf16 row stride of 132), which go to the FMA route. Each case checks
    # which route's count rose; both serving-path cases give the same bits in
    # three more runs.
    from repro_torch.launch.flash_probe import check_tile as flash_check_tile

    flash_kernel = kernels.KERNELS["flash_attention"]
    tile_gen = torch.Generator(device=dev).manual_seed(19)
    if not all(flash_check_tile(tile_gen, hd, hd_v)
               for hd, hd_v in ((128, 128), (64, 64), (128, 64), (64, 128))):
        raise AssertionError("flash_attention [tf32x3]: one tile's products disagree with float64")
    bf16, f32 = torch.bfloat16, torch.float32
    flash_cases = {  # label: (b, s, t, kh, g, hd, hd_v, causal, kv_len, dtype[, layout])
        "serving path": (2, 4096, 4096, 8, 3, 128, 128, True, None, bf16),
        "serving path float32": (2, 4096, 4096, 8, 3, 128, 128, True, None, f32),
        "GQA hd_v=16": (2, 128, 128, 2, 2, 32, 16, True, None, f32),
        "ragged non-causal S=100 T=160": (1, 100, 160, 1, 4, 16, 16, False, None, f32),
        "MLA hd=192 hd_v=128": (1, 300, 300, 4, 1, 192, 128, True, None, bf16),
        "MLA hd=192 hd_v=128 float32": (1, 300, 300, 4, 1, 192, 128, True, None, f32),
        "kv_len=17 hd=36": (2, 70, 90, 2, 3, 36, 20, True, 17, f32),
        "every row masked": (1, 65, 65, 1, 5, 8, 8, True, 0, f32),
        "G=1": (1, 300, 300, 2, 1, 128, 128, True, None, bf16),
        "G=3": (1, 300, 300, 2, 3, 128, 128, True, None, bf16),
        "G=7": (1, 300, 300, 1, 7, 128, 128, True, None, bf16),
        "G=8": (1, 300, 300, 1, 8, 128, 128, True, None, bf16),
        "hd=64": (2, 200, 200, 2, 3, 64, 64, True, None, bf16),
        "ragged S=T=1000": (1, 1000, 1000, 2, 3, 128, 128, True, None, bf16),
        "non-causal S=100 T=4096": (1, 100, 4096, 2, 3, 128, 128, False, None, bf16),
        "non-causal kv_len=777 T=1000": (1, 200, 1000, 2, 3, 128, 128, False, 777, bf16),
        "kv_len=0 hd=128": (1, 130, 130, 2, 3, 128, 128, True, 0, bf16),
        "float32 G=1": (1, 300, 300, 2, 1, 128, 128, True, None, f32),
        "float32 G=7": (1, 300, 300, 1, 7, 128, 128, True, None, f32),
        "float32 G=8": (1, 300, 300, 1, 8, 128, 128, True, None, f32),
        "float32 hd=64": (2, 200, 200, 2, 3, 64, 64, True, None, f32),
        "float32 hd=64 hd_v=128": (2, 200, 200, 2, 3, 64, 128, True, None, f32),
        "float32 hd=128 hd_v=64 kv_len=150": (2, 200, 200, 2, 3, 128, 64, True, 150, f32),
        "float32 ragged S=T=1000": (1, 1000, 1000, 2, 3, 128, 128, True, None, f32),
        "float32 non-causal S=100 T=4096": (1, 100, 4096, 2, 3, 128, 128, False, None, f32),
        "float32 non-causal kv_len=777 T=1000": (1, 200, 1000, 2, 3, 128, 128, False, 777, f32),
        "float32 kv_len=0 hd=128": (1, 130, 130, 2, 3, 128, 128, True, 0, f32),
        "model's q view": (2, 500, 500, 2, 3, 128, 128, True, None, bf16, "view"),
        "float32 model's q view": (2, 500, 500, 2, 3, 128, 128, True, None, f32, "view"),
        "bf16 base 2 bytes off 16": (1, 200, 200, 2, 3, 128, 128, True, None, bf16, "offset"),
        "bf16 row stride 132": (1, 200, 200, 2, 3, 128, 128, True, None, bf16, "row"),
        "float32 base 4 bytes off 16": (1, 200, 200, 2, 3, 128, 128, True, None, f32, "offset"),
    }

    def flash_operands(b, s, t, kh, g, hd, hd_v, dtype, layout=None):
        if layout == "view":  # q of (B,S,H,hd) inside a fused q|k|v projection, reshaped
            h = kh * g
            qkv = torch.randn((b, s, h + 2 * kh, hd), generator=gen, device=dev).to(dtype)
            return qkv[:, :, :h].reshape(b, s, kh, g, hd), qkv[:, :, h:h + kh], qkv[:, :, h + kh:]
        if layout == "offset":
            flat = torch.randn((b * s * kh * g * hd + 1,), generator=gen, device=dev).to(dtype)
            q = flat[1:].view(b, s, kh, g, hd)
        elif layout == "row":
            q = torch.randn((b, s, kh, g, hd + 4), generator=gen, device=dev).to(dtype)[..., :hd]
        else:
            q = torch.randn((b, s, kh, g, hd), generator=gen, device=dev).to(dtype)
        k = torch.randn((b, t, kh, hd), generator=gen, device=dev).to(dtype)
        v = torch.randn((b, t, kh, hd_v), generator=gen, device=dev).to(dtype)
        return q, k, v

    def flash_route(dtype, hd, hd_v, layout):
        """The route the wrapper's rule gives a case."""
        if layout in ("offset", "row"):  # TMA takes neither
            return "fma"
        if dtype == bf16 and hd % 64 == 0 and hd_v % 64 == 0:
            return "tensor_core"
        if dtype == f32 and hd in (64, 128) and hd_v in (64, 128):
            return "tf32x3"
        return "fma"

    for label, (b, s, t, kh, g, hd, hd_v, causal, kv_len, dtype, *layout) in flash_cases.items():
        q, k, v = flash_operands(b, s, t, kh, g, hd, hd_v, dtype, *layout)
        route = flash_route(dtype, hd, hd_v, layout[0] if layout else None)
        routes = dict(flash_kernel.route_launches)
        out = flash_attention(q, k, v, causal=causal, kv_len=kv_len)
        torch.cuda.synchronize()
        if flash_kernel.route_launches != dict(routes, **{route: routes[route] + 1}):
            raise AssertionError(f"flash_attention {label}: expected one {route} launch, route "
                                 f"counts went {routes} -> {flash_kernel.route_launches}")
        is32 = dtype == f32
        tag = f"flash_attention [{route}] {label} {(b, s, t, kh, g, hd, hd_v)} causal={causal} " \
              f"kv_len={kv_len} {str(dtype).split('.')[-1]}"
        e64 = check_close(f"{tag} vs float64 plain", out, flash_attention_ref(
            q.double(), k.double(), v.double(), causal=causal, kv_len=kv_len),
            rtol=2e-5 if is32 else 1e-2, atol=2e-5 if is32 else 1e-2)
        e32 = check_close(f"{tag} vs {'float32' if is32 else 'bfloat16'} plain", out,
                          flash_attention_ref(q, k, v, causal=causal, kv_len=kv_len),
                          rtol=1e-4 if is32 else 1e-2, atol=1e-4 if is32 else 1e-2)
        errs["flash_attention"] = max(errs.get("flash_attention", 0.0), e64)
        err32["flash_attention"] = max(err32.get("flash_attention", 0.0), e32)
        flash_err64[route] = max(flash_err64.get(route, 0.0), e64)
        if kv_len == 0 and not bool((out == 0).all()):
            raise AssertionError(f"flash_attention [{route}]: a fully masked row is not zero")
        if label.startswith("serving path"):  # each tensor-core route is deterministic
            if not all(torch.equal(out, flash_attention(q, k, v)) for _ in range(3)):
                raise AssertionError(f"flash_attention [{route}]: three runs of one input differ")
            print(f"  flash_attention [{route}] {label}: three more runs, the same bits",
                  flush=True)
        del q, k, v, out
    torch.cuda.empty_cache()

    # flash_attention_bwd (the training path's attention backward) and the
    # forward's lse, with flash_bwd_probe's cases and tolerances: every
    # forward route's lse against the float64 plain lse (1e-4 + 1e-5·|lse|;
    # +inf exactly on the rows with nothing visible; out the same bits with
    # and without lse); the backward on the forward kernel's out and lse
    # against the plain version in float64 and in the case's dtype (float32
    # 2e-4, bf16 2e-2, of max|g| plus as much of |g|: P and dS round to bf16
    # in the kernel), at the training shape (B=1, S=T=4096, K=8, G=3, hd=128,
    # bf16, causal, three more runs the same bits), float32, hd 64 and 256,
    # hd 192 with hd_v 128, G 1, 8 and 64, non-causal, ragged S and T,
    # kv_len < T and kv_len = 0 (exactly zero gradients); one launch a call,
    # counted on its route. Every case runs on the FMA route, and those that
    # the bf16 tensor-core route takes on that route too, the two routes
    # held to each other within the same tolerance.
    from repro_torch.launch import flash_bwd_probe

    log = lambda m: print(m, flush=True)  # noqa: E731
    bwd_gen = torch.Generator(device=dev).manual_seed(23)
    lse_err, ok = flash_bwd_probe.check_lse(bwd_gen, log)
    if not ok:
        raise AssertionError("flash_attention: an lse disagrees with its plain version")
    bwd_err64 = {}
    for label, case in flash_bwd_probe.CASES.items():
        e64, e32, ok = flash_bwd_probe.check_case(bwd_gen, label, case, log, by_route=bwd_err64)
        if not ok:
            raise AssertionError(f"flash_attention_bwd {label}: the kernel disagrees with its "
                                 f"plain version")
        errs["flash_attention_bwd"] = max(errs.get("flash_attention_bwd", 0.0), e64)
        err32["flash_attention_bwd"] = max(err32.get("flash_attention_bwd", 0.0), e32)
        torch.cuda.empty_cache()

    phase("4 main path: Pipeline(PAPER_SPEC).run() on the card")
    print(f"  spec {PAPER_SPEC.to_json()}", flush=True)
    kernels.reset_launches()
    pipe_paper = Pipeline(PAPER_SPEC)
    board = pipe_paper.run()
    torch.cuda.synchronize()
    launches_paper = kernels.launch_counts()
    paper_theta, paper_timings = pipe_paper.sample().theta, dict(board.timings)
    del pipe_paper
    print(board.table(), flush=True)
    print(f"  accept={board.accept:.4f} timings_s={json.dumps(board.timings)}", flush=True)
    print(f"  launches={json.dumps(launches_paper)}", flush=True)
    stage_line("PAPER_SPEC", board.timings)
    for name in ("logreg_loglik_grad", "img_log_weights"):
        if launches_paper[name] <= 0:
            raise AssertionError(f"{name} was never launched on the main path")
    # the likelihood once per init and transition of both stages' chains:
    # init, warmup, init, burn-in, T (sampling), then the same for the
    # groundtruth chain (burn-in groundtruth_T // 6)
    want_lr = (2 + PAPER_SPEC.warmup + PAPER_SPEC.resolved_burn_in() + PAPER_SPEC.T
               + 2 + PAPER_SPEC.warmup + PAPER_SPEC.groundtruth_T // 6 + PAPER_SPEC.groundtruth_T)
    if launches_paper["logreg_loglik_grad"] != want_lr:
        raise AssertionError(f"logreg_loglik_grad launched {launches_paper['logreg_loglik_grad']} "
                             f"times on the main path, expected {want_lr}")
    if launches_paper["flash_attention"] != 0:
        raise AssertionError("flash_attention launched on the MCMC path")
    # img_log_weights by route: every kernel-mode IMG sweep is one sweep-route
    # launch (ceil(T / n_batch) sweeps of each IMG combiner); the generic
    # route serves weierstrass's final states only
    img_routes = {"paper": dict(img_kernel.route_launches)}
    check_img_routes("PAPER_SPEC", img_routes["paper"], generic=0, sweep=img_sweeps(PAPER_SPEC))
    sample_lr = 2 + PAPER_SPEC.warmup + PAPER_SPEC.resolved_burn_in() + PAPER_SPEC.T
    check_bands(board, CPU_LOGL2)
    paper_errors = dict(board.errors)

    phase("4b all combiners: Pipeline(ALL_SPEC).run() on the card")
    print(f"  spec {ALL_SPEC.to_json()}", flush=True)
    kernels.reset_launches()
    pipe = Pipeline(ALL_SPEC)
    board = pipe.run()
    torch.cuda.synchronize()
    launches = kernels.launch_counts()
    print(board.table(), flush=True)
    print(f"  accept={board.accept:.4f} timings_s={json.dumps(board.timings)}", flush=True)
    print(f"  launches={json.dumps(launches)}", flush=True)
    stage_line("ALL_SPEC", board.timings)
    # the same chains as phase 4 (6,470 likelihood launches); IMG weights
    # once per sweep of a third kernel-scored IMG combiner, semiparametric_w
    # (ceil(T / n_batch) = 75), and once for weierstrass's final states:
    # 150 + 75 + 1 = 226; the KDE kernel once each for importance_pool and
    # weierstrass's init_pool (2)
    options = dict(ALL_SPEC.combiner_options)
    expected = {
        "logreg_loglik_grad": launches_paper["logreg_loglik_grad"],
        "img_log_weights": (launches_paper["img_log_weights"]
                            + -(-ALL_SPEC.T // options["n_batch"]) + 1),
        "machine_kde_log_density": 2,
    }
    for name, n in expected.items():
        if launches[name] <= 0 or launches[name] != n:
            raise AssertionError(f"{name} launched {launches[name]} times on the path, expected {n}")
    if launches["flash_attention"] != 0:
        raise AssertionError("flash_attention launched on the ALL_SPEC path")
    img_routes["all"] = dict(img_kernel.route_launches)
    check_img_routes("ALL_SPEC", img_routes["all"], generic=1, sweep=img_sweeps(ALL_SPEC))
    check_bands(board, CPU_LOGL2_ALL)
    # the second metric beside logL2: logL2 ties nonparametric, pool, rpt and
    # subpost_average (PERF.md §7); does MMD² tell them apart?
    mmd2_all = mmd2_lines("ALL_SPEC", pipe, board)
    for name, err in paper_errors.items():
        if abs(board.errors[name] - err) > 1e-4:
            raise AssertionError(f"logL2({name}) = {board.errors[name]} under ALL_SPEC, "
                                 f"{err} under PAPER_SPEC")
    print(f"  parametric/nonparametric/semiparametric equal phase 4's within 1e-4", flush=True)
    theta = pipe.sample().theta
    combine_s = {}
    for name in ALL_SPEC.combiner_names():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = combine_spec_draws(ALL_SPEC, theta, (name,))[name]
        torch.cuda.synchronize()
        combine_s[name] = time.perf_counter() - t0
        if name == "online":
            all_online = res.moments  # one plain fold of the whole stack
        if name == "importance_pool":
            print(f"  importance_pool ess={float(res.extras['ess']):.2f} of "
                  f"{theta.shape[0] * theta.shape[1]} pooled draws", flush=True)
    print(f"  combine_s_by_combiner={json.dumps(combine_s)}", flush=True)
    all_errors, all_theta, all_pipe = dict(board.errors), theta, pipe

    phase("4c stream: Pipeline(STREAM_SPEC).stream_combine() on the card (fused)")
    print(f"  spec {STREAM_SPEC.to_json()}", flush=True)
    kernels.reset_launches()
    t0 = time.perf_counter()
    pipe = Pipeline(STREAM_SPEC)
    sr = pipe.stream_combine()
    board = pipe.run()  # the stream's finals and groundtruth, scored
    torch.cuda.synchronize()
    stream_wall = time.perf_counter() - t0
    launches_stream = kernels.launch_counts()
    fused = pipe.sample()
    print(f"  backend={fused.backend} wall_s={stream_wall:.3f} "
          f"timings_s={json.dumps(board.timings)}", flush=True)
    print(f"  launches={json.dumps(launches_stream)}", flush=True)
    stage_line("STREAM_SPEC fused", board.timings, wall=stream_wall)
    for row in sr.trajectory:
        print(f"  t={row['t']:5d} {sr.metric}({row['combiner']:15s}) = {row['error']:.4f} "
              f"[{row['elapsed_s']:.3f}s]", flush=True)
    # the same chains and finals as 4b; online_update once per fold chunk
    # (ceil(T / stream_every)); IMG weights once per sweep of every
    # nonparametric estimate (one per boundary, n_estimate draws in batches of
    # max(n_batch, 8)); estimates are taken by the combiners that have one
    every = STREAM_SPEC.stream_every
    n_chunks = -(-STREAM_SPEC.T // every)
    n_batch = max(int(dict(STREAM_SPEC.combiner_options)["n_batch"]), 8)
    from repro_torch.core.combiners import get_streaming_combiner
    estimating = [n for n in STREAM_SPEC.combiner_names()
                  if get_streaming_combiner(n).estimate is not None]
    expected = {
        "logreg_loglik_grad": launches["logreg_loglik_grad"],
        "img_log_weights": launches["img_log_weights"] + n_chunks * -(-sr.n_estimate // n_batch),
        "machine_kde_log_density": launches["machine_kde_log_density"],
        "kde_log_density": 0,
        "online_update": n_chunks,
        "flash_attention": 0,
    }
    for name, n in expected.items():
        if launches_stream[name] != n:
            raise AssertionError(f"{name} launched {launches_stream[name]} times on the stream "
                                 f"path, expected {n}")
    img_routes["stream"] = dict(img_kernel.route_launches)
    # every fold chunk of the path is C = 120 rows of d = 50: the whole route
    online_routes_stream = dict(online_kernel.route_launches)
    if online_routes_stream != {"whole": n_chunks, "slab": 0}:
        raise AssertionError(f"online_update on the stream path by route: {online_routes_stream}")
    check_img_routes("STREAM_SPEC", img_routes["stream"], generic=1,
                     sweep=img_sweeps(ALL_SPEC) + n_chunks * -(-sr.n_estimate // n_batch))
    values = [row["error"] for row in sr.trajectory]
    if len(values) != n_chunks * len(estimating) or not all(math.isfinite(v) for v in values):
        raise AssertionError(f"trajectory: {len(values)} rows for {n_chunks} boundaries x "
                             f"{len(estimating)} estimating combiners, finite: "
                             f"{all(math.isfinite(v) for v in values)}")
    if [r["t"] for r in sr.trajectory] != sorted(r["t"] for r in sr.trajectory):
        raise AssertionError("trajectory rows out of boundary order")
    if not torch.equal(fused.theta, all_theta):
        raise AssertionError("the fused stream's draws differ from the one-shot stage's")
    print(f"  {len(values)} finite trajectory values ({n_chunks} boundaries x {estimating}); "
          f"theta bitwise the one-shot stage's", flush=True)
    # online's moments come from the kernel's fold in ten chunks, 4b's from
    # one plain fold of the whole stack, so its logL2 (~66) moves by merge
    # rounding: 6.1e-5 on an H100 (8 float32 spacings of 7.6e-6 at 66).
    # 1e-3 leaves 16x room over that reading and still catches a fault in
    # the moments that moves logL2 by 1.5e-5 of its value; the moment checks
    # below hold the merge itself much tighter. Every other name: same θ,
    # same generator, so within 1e-4 (bitwise in fact).
    ONLINE_LOGL2_TOL = 1e-3
    for name, err in sorted(board.errors.items()):
        tol = ONLINE_LOGL2_TOL if name == "online" else 1e-4
        diff = abs(err - all_errors[name])
        print(f"  final logL2({name}) = {err:.6f}, 4b {all_errors[name]:.6f}, |diff| {diff:.3e} "
              f"(tol {tol:g}) {'ok' if diff <= tol else 'FAIL'}", flush=True)
        if not diff <= tol:
            raise AssertionError(f"stream final logL2({name}) = {err}, 4b gave {all_errors[name]}")

    # the subscriber path: the host folds (online through its plain chunk
    # merge), the same θ; finals bitwise for the buffered combiners
    kernels.reset_launches()
    t0 = time.perf_counter()
    pipe_sub = Pipeline(STREAM_SPEC)
    sub = pipe_sub.stream_combine(fused=False, score=False)
    torch.cuda.synchronize()
    sub_wall = time.perf_counter() - t0
    launches_sub = kernels.launch_counts()
    print(f"  subscriber: backend={pipe_sub.sample().backend} wall_s={sub_wall:.3f} "
          f"launches={json.dumps(launches_sub)}", flush=True)
    if launches_sub["online_update"] != 0:
        raise AssertionError("the subscriber path launched online_update")
    if [(r["t"], r["combiner"]) for r in sub.trajectory] != \
            [(r["t"], r["combiner"]) for r in sr.trajectory]:
        raise AssertionError("subscriber trajectory rows differ from the fused ones")
    for name in STREAM_SPEC.combiner_names():
        if name == "online":
            continue
        if not torch.equal(sub.combined[name].samples, sr.combined[name].samples):
            raise AssertionError(f"subscriber final {name} differs from the fused one")
    # online: the same generator draws from moments that differ by merge
    # rounding. Limits, each from two readings on an H100: the sound gaps
    # (kernel fold against the host's ten-chunk fold: mean 2.1e-6, cov
    # 4.4e-7 of max|cov|) and a planted merge fault (the δδᵀ·n_a·n_b/n term
    # dropped), which the script measures below and must fail. The product
    # mean within 2e-5·(1 + |mean|), the covariance within 1e-5·max|cov|;
    # they bind the kernel fold against the host's ten-chunk fold and against
    # 4b's single plain fold of the whole stack alike.
    from repro_torch.core.combiners.online import (
        OnlineMoments, online_init, online_product, online_update_chunk)

    mf = sr.combined["online"].moments

    def moment_gap(m):
        mean_rel = float(((mf.mean - m.mean).abs() / (1 + m.mean.abs())).max())
        cov_rel = float((mf.cov - m.cov).abs().max() / m.cov.abs().max())
        return mean_rel, cov_rel

    def within(gap):
        return gap[0] <= 2e-5 and gap[1] <= 1e-5

    # the planted fault: each chunk folded alone, the states summed with no
    # between-chunk δδᵀ term
    parts = [online_update_chunk(online_init(STREAM_SPEC.M, fused.theta.shape[-1],
                                             device=dev), fused.theta[:, t:t + every])
             for t in range(0, STREAM_SPEC.T, every)]
    count = sum(q.count for q in parts)
    faulty = online_product(OnlineMoments(
        count, sum(q.count[:, None] * q.mean for q in parts) / count[:, None],
        sum(q.m2 for q in parts)))
    gaps = {"subscriber (host ten-chunk fold)": moment_gap(sub.combined["online"].moments),
            "4b (one plain fold of the stack)": moment_gap(all_online),
            "planted fault (no δδᵀ merge term)": moment_gap(faulty)}
    for label, gap in gaps.items():
        print(f"  online product vs the fused kernel fold, {label}: mean |diff|/(1+|mean|) "
              f"{gap[0]:.3e}, cov |diff|/max|cov| {gap[1]:.3e} (limits 2e-05, 1e-05) "
              f"{'within' if within(gap) else 'outside'}", flush=True)
    *sound, fault = gaps.values()
    if not all(within(g) for g in sound):
        raise AssertionError("online moments outside merge rounding of the fused ones")
    if within(fault):
        raise AssertionError("the online moment limits let a dropped merge term pass")
    print("  subscriber finals bitwise the fused ones for the ten buffered combiners", flush=True)

    # interrupted at 600 draws, then resumed: the same θ, bitwise
    import tempfile
    with tempfile.TemporaryDirectory() as ckpt:
        t0 = time.perf_counter()
        part = Pipeline(STREAM_SPEC, checkpoint_dir=ckpt, checkpoint_every=every).stream_combine(
            max_steps=STREAM_SPEC.T // 2, score=False)
        pipe_res = Pipeline(STREAM_SPEC, checkpoint_dir=ckpt, checkpoint_every=every)
        full = pipe_res.stream_combine(score=False)
        torch.cuda.synchronize()
        resumed = pipe_res.sample()
        print(f"  resume: first session {part.t_done}/{part.total} complete={part.complete}, "
              f"second {full.t_done}/{full.total} complete={full.complete} "
              f"backend={resumed.backend} wall_s={time.perf_counter() - t0:.3f}", flush=True)
    if part.complete or part.t_done != STREAM_SPEC.T // 2 or not full.complete:
        raise AssertionError("the interrupted run did not stop at max_steps and then finish")
    if not torch.equal(resumed.theta, fused.theta):
        raise AssertionError("the resumed run's θ differs from the fused run's")
    for name in STREAM_SPEC.combiner_names():
        if not torch.equal(full.combined[name].samples, sub.combined[name].samples):
            raise AssertionError(f"resumed final {name} differs from the uninterrupted one")
    print("  resumed θ bitwise the fused run's; resumed finals bitwise the subscriber run's",
          flush=True)

    phase("4d serve: LM sidecar prefill + greedy decode, llama3.2-3b full width, B=2, S=4096")
    serve_argv = ["--arch", "llama3.2-3b", "--batch", "2", "--prompt-len", "4096", "--gen", "16",
                  "--seed", "0"]

    def serve_run(dtype):
        """The CLI's main path with the counts reset: 28 flash launches (one
        per layer's prefill attention; S = 4096 > attn_chunk), nothing else."""
        kernels.reset_launches()
        out = serve.main(serve_argv + ["--dtype", dtype])
        torch.cuda.synchronize()
        counts = kernels.launch_counts()
        n_layers = lm_config("llama3.2-3b").num_layers
        print(f"  {dtype}: prefill_s={out['prefill_s']:.4f} decode_ms_per_tok="
              f"{out['decode_s_per_tok'] * 1e3:.3f} launches={json.dumps(counts)}", flush=True)
        routes = dict(kernels.KERNELS["flash_attention"].route_launches)
        print(f"  {dtype}: flash_attention launches by route {json.dumps(routes)}", flush=True)
        want = {name: (n_layers if name == "flash_attention" else 0) for name in counts}
        if counts != want:
            raise AssertionError(f"serve ({dtype}) launched {counts}, expected {want}")
        # bf16 prefill on the bf16 tensor-core route, float32 on the 3×TF32 one
        want_routes = {"tensor_core": n_layers if dtype == "bfloat16" else 0,
                       "tf32x3": n_layers if dtype == "float32" else 0, "fma": 0}
        if routes != want_routes:
            raise AssertionError(f"serve ({dtype}) flash routes {routes}, expected {want_routes}")
        tokens = out["tokens"]
        if tokens.shape != (2, 16) or not bool(((tokens >= 0) & (tokens < 128_256)).all()):
            raise AssertionError(f"serve ({dtype}): tokens {tuple(tokens.shape)} out of range")
        return out, counts, routes

    def forward_tail(model, out):
        """forward(prompt + generated[:-1])'s logits at the 16 positions whose
        next token the serving run chose (prefill's last, then each decode)."""
        seq = torch.cat([out["prompt"], out["tokens"][:, :-1]], dim=1)
        with torch.inference_mode():
            logits, _ = lm_model.forward(model, seq)
            tail = logits[:, -out["tokens"].shape[1]:].to(torch.float32, copy=True)
        del logits
        torch.cuda.empty_cache()
        return tail

    def invariant(label, out, fwd, tol):
        """Each stage's logits within ``tol`` of forward's; the chosen token
        equal to forward's argmax wherever forward's top-2 gap exceeds tol."""
        gap = float((out["logits"] - fwd).abs().max())
        top2 = fwd.topk(2, dim=-1).values
        clear = (top2[..., 0] - top2[..., 1]) > tol
        agree = out["tokens"] == fwd.argmax(-1)
        ok = gap <= tol and bool(agree[clear].all())
        print(f"  {label}: max |stage logits - forward logits| = {gap:.4e} (tol {tol:.4e}); "
              f"tokens agree at {int(agree[clear].sum())}/{int(clear.sum())} positions whose "
              f"top-2 gap > tol ({int(agree.sum())}/{agree.numel()} overall) "
              f"{'ok' if ok else 'FAIL'}", flush=True)
        if not ok:
            raise AssertionError(f"{label}: decode disagrees with forward")
        return gap

    # float32: decode (einsum over the cache) against forward (flash) differs
    # only by summation order; 2e-3 is the reference's own consistency figure
    # (tests/test_model_consistency.py) on logits of size ~1
    out32, _, routes_serve32 = serve_run("float32")
    _, model32, prompt32 = serve.setup(serve.parse(serve_argv + ["--dtype", "float32"]))
    if not torch.equal(prompt32, out32["prompt"]):
        raise AssertionError("serve.setup drew another prompt from the same seed")
    gap32 = invariant("float32 decode vs forward", out32, forward_tail(model32, out32), 2e-3)
    warm32 = serve.generate(model32, out32["prompt"], 16)  # the same weights, warm
    torch.cuda.synchronize()
    serve32 = {"prefill_s_float32": out32["prefill_s"], "warm_prefill_s_float32": warm32["prefill_s"],
               "warm_decode_s_per_tok_float32": warm32["decode_s_per_tok"],
               "warm_tokens_equal_float32": bool(torch.equal(warm32["tokens"], out32["tokens"]))}
    del out32, warm32
    # bfloat16: the tolerance is bf16's own error at full width, measured on
    # the bf16 run's sequence against the float32 model of the same draws
    # (bf16 weights are the float32 ones rounded): both the stages and
    # forward sit within about that of the float32 logits, so their gap
    # within twice it
    out16, launches_serve, routes_serve16 = serve_run("bfloat16")
    _, model16, _ = serve.setup(serve.parse(serve_argv + ["--dtype", "bfloat16"]))
    fwd16 = forward_tail(model16, out16)
    dev16 = float((fwd16 - forward_tail(model32, out16)).abs().max())
    del model32
    torch.cuda.empty_cache()
    print(f"  bfloat16 forward vs float32 forward on the same tokens: max |diff| = {dev16:.4e}",
          flush=True)
    gap16 = invariant("bfloat16 decode vs forward", out16, fwd16, 2.0 * dev16)
    warm = serve.generate(model16, out16["prompt"], 16)  # the same weights, warm
    torch.cuda.synchronize()
    serve_record = {
        "prefill_s": out16["prefill_s"], "decode_s_per_tok": out16["decode_s_per_tok"],
        "warm_prefill_s": warm["prefill_s"], "warm_decode_s_per_tok": warm["decode_s_per_tok"],
        "warm_tokens_equal": bool(torch.equal(warm["tokens"], out16["tokens"])),
        "invariant_gap_float32": gap32, "invariant_gap_bfloat16": gap16,
        "bfloat16_vs_float32": dev16, **serve32,
    }
    print(f"  serve {json.dumps(serve_record)}", flush=True)
    del model16, warm, out16, fwd16
    torch.cuda.empty_cache()

    phase("4e other experiments: Pipeline(spec).run() for LINEAR_SPEC (mala, gibbs), "
          "POISSON_SPEC, GMM_SPEC")
    from repro_torch.core.metrics import effective_sample_size
    from repro_torch.models.bayes.linear_gaussian import posterior_moments

    other_specs = {"linear mala": LINEAR_SPEC,
                   "linear gibbs": dataclasses.replace(LINEAR_SPEC, sampler="gibbs"),
                   "poisson gibbs": POISSON_SPEC, "gmm rwmh": GMM_SPEC}
    other = {}
    for label, spec in other_specs.items():
        print(f"  spec {label} {spec.to_json()}", flush=True)
        kernels.reset_launches()
        t0 = time.perf_counter()
        pipe = Pipeline(spec)
        board = pipe.run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches_o = kernels.launch_counts()
        routes_o = dict(img_kernel.route_launches)
        print(board.table(), flush=True)
        print(f"  {label}: accept={board.accept:.4f} timings_s={json.dumps(board.timings)}",
              flush=True)
        stage_line(label, board.timings, wall=wall)
        print(f"  {label}: launches={json.dumps(launches_o)}", flush=True)
        # every kernel-mode IMG sweep of the two IMG combiners is one launch
        # of the sweep route; no other kernel lies on these paths
        check_img_routes(label, routes_o, generic=0, sweep=img_sweeps(spec))
        idle = {k: n for k, n in launches_o.items() if k != "img_log_weights" and n}
        if idle:
            raise AssertionError(f"{label}: kernels off this path launched: {idle}")
        check_bands(board, CPU_L2_OTHER[label], DEGENERATE.get(label, ()), pipe)
        mmd = mmd2_lines(label, pipe, board)
        theta = pipe.sample().theta
        if label.startswith("linear"):
            # the parametric combined mean against the closed-form posterior
            # mean, within 5× its Monte Carlo error (each chain's ESS per
            # coordinate), as tests/test_torch_slice_linear.py holds it
            exact = posterior_moments(pipe.partition().data)
            M, T, d = theta.shape
            ess = torch.stack([torch.stack([effective_sample_size(theta[m, :, j])
                                            for j in range(d)]) for m in range(M)])
            sd = (exact.cov.diagonal() * ((1.0 / ess).mean(dim=0) + 1.0 / T)).sqrt()
            z = ((pipe.combine()["parametric"].samples.mean(dim=0) - exact.mean).abs() / sd)
            ok = bool((z <= 5.0).all())
            print(f"  {label}: parametric mean vs the closed form: max |err|/MC error "
                  f"{float(z.max()):.3f} (limit 5; ESS {float(ess.min()):.1f}–"
                  f"{float(ess.max()):.1f} a chain) {'ok' if ok else 'FAIL'}", flush=True)
            if not ok:
                raise AssertionError(f"{label}: parametric mean off the closed form: {z.tolist()}")
        if label.startswith("poisson"):
            # the Gibbs kernel's check reads the unresolved-lane count after
            # every chunk and raises on any: reaching here means none
            print(f"  {label}: no gamma lane left unresolved after {randgamma.ROUNDS} rounds "
                  f"(sampling and groundtruth chains)", flush=True)
            gibbs_moments = check_gibbs_moments(label, pipe, spec, dev)
        img_routes[label] = routes_o
        other[label] = {"theta": theta, "board": board, "launches": launches_o,
                        "routes": routes_o, "mmd2": mmd, "wall_s": wall}
        del pipe
    print(f"  poisson gibbs moments {json.dumps(gibbs_moments)}", flush=True)
    torch.cuda.empty_cache()

    phase("4f serve: the posterior server on SERVE_SPEC (PosteriorServer, 4 TCP probe readers)")
    import tempfile

    import numpy as np
    from repro_torch.api.pipeline import resolve_metric
    from repro_torch.core.combiners import counts_or_full, machine_kde_scores
    from repro_torch.launch.mcmc_run import SERVE_SPEC
    from repro_torch.serve import PosteriorServer, answer

    print(f"  spec {SERVE_SPEC.to_json()}", flush=True)
    fresh_transitions = 2 + SERVE_SPEC.warmup + SERVE_SPEC.resolved_burn_in() + SERVE_SPEC.T
    per_refresh = -(-128 // n_batch)  # the nonparametric estimate's sweeps (n_estimate 128)
    serve_kw = dict(sweeps_per_refresh=per_refresh)

    # fresh, refresh="every": each snapshot scores exactly as the subscriber
    # stream_combine's trajectory row at its boundary
    server = PosteriorServer(Pipeline(SERVE_SPEC), n_estimate=128, queue_depth=8,
                             refresh="every")
    server.state.track_history = True
    posterior_session("every", server, 0, transitions=fresh_transitions, **serve_kw)
    every_state = server.state
    ref_pipe = Pipeline(SERVE_SPEC)
    ref_sr = ref_pipe.stream_combine(fused=False)
    dist, _ = resolve_metric(SERVE_SPEC, all_theta.shape[-1])
    gt_serve = ref_pipe.groundtruth()
    by_row = {(t, name): snap for t, name, snap in every_state.history}
    if len(by_row) != len(ref_sr.trajectory):
        raise AssertionError(f"{len(by_row)} refreshed estimates, {len(ref_sr.trajectory)} rows")
    for row in ref_sr.trajectory:
        got = float(dist(gt_serve, torch.from_numpy(by_row[(row["t"], row["combiner"])]).to(dev)))
        if got != row["error"]:
            raise AssertionError(f"snapshot {row['combiner']}@{row['t']} scores {got}, the "
                                 f"stream_combine row {row['error']}")
    print(f"  every: {len(ref_sr.trajectory)} snapshots ({len(every_state.history)} refreshes "
          f"of a combiner) score exactly as stream_combine(fused=False)'s trajectory rows",
          flush=True)

    # fresh, coalesced refreshes, four TCP probe readers (serve_pipeline's
    # session), then the scoreboard over the served draws as mcmc_run --serve
    server = PosteriorServer(Pipeline(SERVE_SPEC), n_estimate=128, queue_depth=8)
    summary, launches_post, post_wall = posterior_session("coalesce", server, 4,
                                                  transitions=fresh_transitions, **serve_kw)
    st = summary["staleness"]
    if not (st["complete"] and st["chunks_folded"] == SERVE_SPEC.T // SERVE_SPEC.stream_every
            and st["draws_seen"] == SERVE_SPEC.T and st["chunks_replayed"] == 0):
        raise AssertionError(f"coalesce session: staleness {st}")
    post_state = server.state
    board = server.pipeline.run()
    torch.cuda.synchronize()
    for name, err in sorted(board.errors.items()):
        if abs(err - all_errors[name]) > 1e-4:
            raise AssertionError(f"served scoreboard {name} = {err}, 4b {all_errors[name]}")
    print(f"  coalesce: no probe error, staleness monotone, no chunk dropped, complete; the "
          f"scoreboard over the served draws ({board.backend}) equals 4b's within 1e-4 for all "
          f"{len(board.errors)} combiners", flush=True)
    posterior_serve = {"summary": {k: v for k, v in summary.items() if k != "final"},
                       "wall_s": post_wall, "fold_s": server.fold_s,
                       "refresh_s": server.refresh_s, "launches": launches_post}
    print(f"  posterior serving {json.dumps(posterior_serve)}", flush=True)

    # logpdf answers at Q = 1 and 1,000 on the completed buffer: buffer rows
    # plus noise from the seed, both reduce values, against the plain
    # version on a CPU copy of the same buffer (phase 3's KDE tolerance)
    theta_buf, counts_buf = post_state.logpdf_inputs()
    pts_gen = torch.Generator(device=dev).manual_seed(SERVE_SPEC.seed)
    rows_buf = theta_buf.reshape(-1, theta_buf.shape[-1])
    for Q in (1, 1000):
        pts = rows_buf[torch.randint(0, rows_buf.shape[0], (Q,), generator=pts_gen, device=dev)]
        pts = pts + 0.01 * torch.randn(pts.shape, generator=pts_gen, device=dev)
        theta_cpu = theta_buf.cpu()
        h_cpu = masked_silverman(theta_cpu, counts_or_full(theta_cpu, None))
        spread = float((pts * pts).sum(-1).max()) + float((theta_cpu * theta_cpu).sum(-1).max())
        term = eps32 * spread / (2.0 * float(h_cpu.min()) ** 2)
        for reduce in ("product", "mixture"):
            before = kernels.KERNELS["machine_kde_log_density"].launches
            resp = answer(post_state, {"op": "logpdf", "points": pts.tolist(), "reduce": reduce})
            if not resp["ok"] or kernels.KERNELS["machine_kde_log_density"].launches != before + 1:
                raise AssertionError(f"logpdf Q={Q} {reduce}: {resp.get('error')}, or not one launch")
            want = machine_kde_scores(pts.cpu(), theta_cpu, None, h_cpu, reduce=reduce)
            scale = theta_buf.shape[0] if reduce == "product" else 1
            check_lp(f"logpdf answer Q={Q} {reduce} (one kernel launch) vs the plain version on "
                     f"a CPU copy of the buffer", torch.tensor(resp["result"]["log_density"]),
                     want, rtol=1e-5, atol=16.0 * term * scale)

    # restart: sample to 480 draws with checkpoints every 240, stop; a second
    # server on the same directory replays the 4 restored chunks into its
    # folder while its sampler builds and captures the collection loop, with
    # four readers querying (logpdf included) the whole time
    with tempfile.TemporaryDirectory() as ckpt:
        def ckpt_pipe():
            return Pipeline(SERVE_SPEC, checkpoint_dir=ckpt, checkpoint_every=240)

        first = PosteriorServer(ckpt_pipe(), n_estimate=128, queue_depth=8, max_steps=480)
        posterior_session("restart, first session", first, 0,
                  transitions=2 + SERVE_SPEC.warmup + SERVE_SPEC.resolved_burn_in() + 480,
                  **serve_kw)
        if first.state.staleness()["draws_seen"] != 480:
            raise AssertionError(f"first session stopped at {first.state.staleness()}")
        second = PosteriorServer(ckpt_pipe(), n_estimate=128, queue_depth=8)
        summary_r, _, _ = posterior_session("restart, second session", second, 4,
                                    transitions=SERVE_SPEC.T - 480, **serve_kw)
    st = summary_r["staleness"]
    if not (st["complete"] and st["chunks_replayed"] == 4 and st["chunks_folded"] == 10):
        raise AssertionError(f"restart: staleness {st}")
    for name in SERVE_SPEC.combiner_names():
        if get_streaming_combiner(name).estimate is None:
            continue
        if not np.array_equal(second.state.snapshot(name).samples,
                              every_state.snapshot(name).samples):
            raise AssertionError(f"restarted final snapshot of {name} differs")
    print(f"  restart: chunks_replayed 4, chunks_folded 10, complete; every final snapshot "
          f"bitwise the uninterrupted run's", flush=True)
    del server, first, second, ref_pipe, every_state, post_state
    torch.cuda.empty_cache()

    phase("4g tree and matrix: tree_combine on 4b's draws; run_matrix over 8 cells")
    from repro_torch.api import run_matrix
    from repro_torch.core.metrics import mmd2_rbf
    from repro_torch.core.tree_combine import tree_combine

    gt_all = all_pipe.groundtruth()
    ell = mmd_lengthscale(gt_all)
    dist_all, label_all = resolve_metric(ALL_SPEC, all_theta.shape[-1])
    tree_out = {}
    for method in ("parametric", "nonparametric"):
        kernels.reset_launches()
        t0 = time.perf_counter()
        res = tree_combine(torch.Generator(device=dev).manual_seed(0), all_theta, ALL_SPEC.T,
                           method=method)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        launches_t, routes_t = kernels.launch_counts(), dict(img_kernel.route_launches)
        err = float(dist_all(gt_all, res.samples))
        mmd = float(mmd2_rbf(gt_all, res.samples, ell))
        if not (math.isfinite(err) and bool(torch.isfinite(res.samples).all())
                and res.samples.shape == (ALL_SPEC.T, all_theta.shape[-1])):
            raise AssertionError(f"tree_combine {method}: {err}, {tuple(res.samples.shape)}")
        print(f"  tree_combine {method} (M={ALL_SPEC.M}: {ALL_SPEC.M - 1} pairs in 4 rounds, "
              f"{secs:.3f} s): {label_all} {err:.4f} (flat {all_errors[method]:.4f}), mmd2_rbf "
              f"{mmd:.6e} (flat {mmd2_all[method]:.6e}); launches {json.dumps(launches_t)}, "
              f"img_log_weights by route {json.dumps(routes_t)}", flush=True)
        tree_out[method] = {"error": err, "mmd2": mmd, "seconds": secs, "launches": launches_t,
                            "routes": routes_t}

    # two models x two seeds x two step sizes, at LINEAR_SPEC's and
    # POISSON_SPEC's widths under mala (tests/test_api.py's grid): 2 sets of
    # chain loops, each cell a standalone Pipeline's scoreboard
    bases = {"linear": dataclasses.replace(LINEAR_SPEC, sampler="mala"),
             "poisson": dataclasses.replace(POISSON_SPEC, sampler="mala")}
    cells = [dataclasses.replace(base, seed=seed, step_size=step)
             for base in bases.values() for seed in (0, 1) for step in (0.1, 0.2)]
    t0 = time.perf_counter()
    mres = run_matrix(cells)
    torch.cuda.synchronize()
    matrix_s = time.perf_counter() - t0
    print(mres.table(), flush=True)
    if (mres.n_specs, mres.n_executables, mres.n_groundtruth_executables, mres.n_graphs) != \
            (8, 2, 2, 8):
        raise AssertionError(f"run_matrix: {mres.n_specs} cells, {mres.n_executables} sampling "
                             f"and {mres.n_groundtruth_executables} groundtruth executables, "
                             f"{mres.n_graphs} graphs; expected 8, 2, 2, 8")
    t0 = time.perf_counter()
    worst, bitwise = 0.0, True
    for spec in cells:
        board = Pipeline(spec).run()
        rows_m = {r["combiner"]: r["error"] for r in mres.rows if r["spec_id"] == spec.spec_id}
        for name, err in board.errors.items():
            got = rows_m[name]
            same = got == err or (math.isnan(got) and math.isnan(err))
            bitwise &= same
            if not same:
                rel = abs(got - err) / max(abs(err), 1e-30)
                worst = max(worst, rel)
                if not rel <= 1e-4:
                    raise AssertionError(f"matrix cell {spec.spec_id} {name} = {got}, its "
                                         f"Pipeline {err}")
    print(f"  run_matrix: 8 cells in {matrix_s:.3f} s (the 8 standalone Pipelines "
          f"{time.perf_counter() - t0:.3f} s), 2 sampling and 2 groundtruth loop sets, "
          f"{mres.n_graphs} graphs captured; every cell's scoreboard equals its standalone "
          f"Pipeline's {'bit for bit' if bitwise else f'within {worst:.3e} relative'}", flush=True)
    del gt_all, all_pipe
    torch.cuda.empty_cache()

    launches_mesh, launches_mesh_stream, mesh_walls = multi_device_phase(
        dev, kernels, img_kernel, online_kernel, paper_theta=paper_theta,
        paper_errors=paper_errors, paper_timings=paper_timings, paper_lr=want_lr,
        sample_lr=sample_lr, paper_img=img_routes["paper"], stream_sr=sr,
        stream_theta=fused.theta, stream_sub=sub, launches_stream=launches_stream,
        stream_img=img_routes["stream"], n_chunks=n_chunks, cells=cells, mres=mres)
    torch.cuda.empty_cache()

    launches_train, routes_train, routes_train_bwd, train_record = train_phase(dev, kernels,
                                                                               lm_config)
    torch.cuda.empty_cache()

    phase("5 timing (CUDA events)")
    flush_buf = torch.empty(256 * 1024 * 1024 // 4, device=dev)  # 256 MB > 50 MB L2

    def flush():
        flush_buf.zero_()

    rows, lr_rows = [], {}
    for label, (G, N, d, C) in {"sample": (10, 5000, 50, 1), "groundtruth": (1, 50000, 50, 1)}.items():
        X, y, beta = logreg_inputs(G, N, d, C)
        nbytes = 4 * (G * N * d + G * N + G * d * C + G * C + G * d * C)
        flops = 4 * G * N * d * C + 10 * G * N * C
        bound, bound_by = least_ms(nbytes, flops)
        ms, host = device_ms(lambda: logreg_loglik_grad(X, y, beta))
        cold, _ = device_ms(lambda: logreg_loglik_grad(X, y, beta), flush=flush)
        plain, plain_host = device_ms(lambda: logreg_loglik_grad_ref(X, y, beta))
        print(f"  logreg_loglik_grad {label} G={G} N={N} d={d} C={C}: kernel {ms * 1e3:.2f} us "
              f"(cold L2 {cold * 1e3:.2f} us; host enqueue {host * 1e3:.2f} us/call), "
              f"plain {plain * 1e3:.2f} us (host {plain_host * 1e3:.2f} us/call), "
              f"HBM bound {bound * 1e3:.2f} us by {bound_by} (bounds the cold-L2 time)", flush=True)
        lr_rows[label] = {"ms": ms, "cold_ms": cold, "host_ms": host, "plain_ms": plain,
                          "bound_ms": bound, "bound_by": bound_by,
                          "shape": f"G={G} N={N} d={d} C={C}"}
    rows.append({"name": "logreg_loglik_grad", **lr_rows["sample"],
                 "at_groundtruth": lr_rows["groundtruth"]})
    P, M, d = 160, 10, 50
    theta = torch.randn((P, M, d), generator=gen, device=dev)
    h_t = torch.tensor(0.05, device=dev)
    nbytes = 4 * (P * M * d + 1 + P)
    flops = 4 * P * M * d
    bound, bound_by = least_ms(nbytes, flops)
    ms, host = device_ms(lambda: img_log_weights(theta, h_t))
    cold, _ = device_ms(lambda: img_log_weights(theta, h_t), flush=flush)
    plain, plain_host = device_ms(lambda: img_log_weights_ref(theta, h_t))
    print(f"  img_log_weights P={P} M={M} d={d}: kernel {ms * 1e3:.2f} us "
          f"(cold L2 {cold * 1e3:.2f} us; host enqueue {host * 1e3:.2f} us/call), "
          f"plain {plain * 1e3:.2f} us (host {plain_host * 1e3:.2f} us/call), "
          f"HBM bound {bound * 1e3:.3f} us by {bound_by} (bounds the cold-L2 time)", flush=True)
    generic_row = {"ms": ms, "cold_ms": cold, "host_ms": host, "plain_ms": plain,
                   "bound_ms": bound, "bound_by": bound_by, "shape": f"P={P} M={M} d={d}"}

    # the sweep route at the path's shape on the path's own draws (phase 4b's
    # θ), w_t and W_t, beside its plain version and its bound; then whole
    # kernel-mode sweeps of the engine on the host clock (the draws, the W_t
    # factor, one launch) against the eager sweep the sweep route replaced
    # (the draws, the batched W_t callable, the plain sweep body in PyTorch
    # ops scoring through one generic-route launch)
    import unittest.mock
    from repro_torch.kernels.img_weights import ref as img_ref

    M, T, d = all_theta.shape
    B = int(dict(ALL_SPEC.combiner_options)["n_batch"])
    counts_s = torch.full((M,), T, dtype=torch.int32, device=dev)
    sweep_rows = {}
    for wt in (False, True):
        _, _, model, carry, c, u, h = sweep_case(B, M, T, d, wt=wt, samples=all_theta,
                                                 counts=counts_s)
        term = model.state_term(h) if wt else None
        extra_lw = model.extra_logweight(h.expand(B)) if wt else None
        nbytes, flops = sweep_work(B, M, d, wt)
        bound, bound_by = least_ms(nbytes, flops)
        run = lambda: img_sweep(carry, all_theta, c, u, h, aux=model.aux, state_term=term)  # noqa: E731
        ms, host = device_ms(run)
        cold, _ = device_ms(run, flush=flush)
        # one call behind the sleep: the plain sweep is ~300-400 launches
        plain, plain_host = device_ms(
            lambda: img_sweep_ref(carry, all_theta, c, u, h, model.aux, extra_lw), iters=1)

        def this_sweep():
            st = model.state_term(h) if wt else None
            return img_engine._img_kernel_sweep(carry, all_theta, counts_s, h, model.aux,
                                                gen=gen, state_term=st)

        def eager_sweep():
            lw = model.extra_logweight(h.expand(B)) if wt else None
            c_ = img_engine._randint_below(gen, (B, M), counts_s)
            u_ = torch.rand((B, M), generator=gen, device=dev)
            return img_sweep_ref(carry, all_theta, c_, u_, h, model.aux, lw)

        walls = {}
        for which, fn, route in (("this", this_sweep, "sweep"), ("eager", eager_sweep, "generic")):
            with unittest.mock.patch.object(img_ref, "img_log_weights_ref", img_log_weights):
                routes = dict(img_kernel.route_launches)
                walls[which] = sweep_wall_ms(fn, 50)
            moved = {r: n - routes[r] for r, n in img_kernel.route_launches.items()}
            if moved != dict({r: 0 for r in routes}, **{route: 55}):
                raise AssertionError(f"{which} sweeps launched {moved}, not 55 {route} launches")
        form = "W_t" if wt else "w_t"
        print(f"  img_log_weights [sweep] {form} B={B} M={M} T={T} d={d} (phase 4b's draws): kernel "
              f"{ms * 1e3:.2f} us (cold L2 {cold * 1e3:.2f} us; host enqueue {host * 1e3:.2f} "
              f"us/call), plain {plain * 1e3:.2f} us (host {plain_host * 1e3:.2f} us/call), bound "
              f"{bound * 1e3:.4f} us by {bound_by} ({nbytes} bytes, {flops} flop); a whole "
              f"engine sweep {walls['this']:.4f} ms of wall, the eager sweep's {walls['eager']:.4f} ms",
              flush=True)
        sweep_rows[form] = {"ms": ms, "cold_ms": cold, "host_ms": host, "plain_ms": plain,
                            "bound_ms": bound, "bound_by": bound_by,
                            "sweep_wall_ms": walls["this"], "eager_sweep_wall_ms": walls["eager"],
                            "shape": f"sweep {form} B={B} M={M} T={T} d={d}"}
    # the sweep route at phase 4e's widths on its own draws (poisson d=2,
    # linear d=10, gmm d=20), w_t and W_t, beside the plain sweep and the bound
    other_d_rows = {}
    for label in ("poisson gibbs", "linear mala", "gmm rwmh"):
        th = other[label]["theta"]
        M, T, d = th.shape
        counts_o = torch.full((M,), T, dtype=torch.int32, device=dev)
        for wt in (False, True):
            _, _, model, carry, c, u, h = sweep_case(B, M, T, d, wt=wt, samples=th,
                                                     counts=counts_o)
            term = model.state_term(h) if wt else None
            extra_lw = model.extra_logweight(h.expand(B)) if wt else None
            nbytes, flops = sweep_work(B, M, d, wt)
            bound, bound_by = least_ms(nbytes, flops)
            run = lambda: img_sweep(carry, th, c, u, h, aux=model.aux, state_term=term)  # noqa: E731
            ms, host = device_ms(run)
            plain, _ = device_ms(lambda: img_sweep_ref(carry, th, c, u, h, model.aux, extra_lw),
                                 iters=1)
            form = "W_t" if wt else "w_t"
            print(f"  img_log_weights [sweep] {form} B={B} M={M} T={T} d={d} ({label}'s draws): "
                  f"kernel {ms * 1e3:.2f} us (host enqueue {host * 1e3:.2f} us/call), plain "
                  f"{plain * 1e3:.2f} us, bound {bound * 1e3:.4f} us by {bound_by}", flush=True)
            other_d_rows[f"{form} d={d}"] = {"ms": ms, "host_ms": host, "plain_ms": plain,
                                             "bound_ms": bound, "bound_by": bound_by}
    rows.append({"name": "img_log_weights", **sweep_rows["w_t"], "sweep_W_t": sweep_rows["W_t"],
                 "sweep_at_other_d": other_d_rows,
                 "generic_route": generic_row})

    # the KDE kernel at its two shapes on the ALL_SPEC path, and its
    # single-cloud form at one machine of that path (no path calls it). The
    # least time for this work, whatever implements it: the inputs read and
    # the outputs written once over the HBM rate; the three TF32 passes of
    # the cross term (2·Q·Σcounts·d flop each) over the dense TF32
    # tensor-core rate; one exp a query-sample pair over the special-function
    # units' rate (16 a clock an SM, this card's SMs at its maximum SM clock).
    # The direct form's float32 bound (2 flop a pair-dim at 67 TFLOP/s) is
    # printed beside it.
    max_sm_hz = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, timeout=60, check=True).stdout.split()[0]) * 1e6
    mufu_per_s = MUFU_PER_CLOCK_PER_SM * torch.cuda.get_device_properties(0).multi_processor_count * max_sm_hz
    kde_rows = {}
    for name, label, Q, M, T, d, reduce in (
        ("machine_kde_log_density", "importance_pool", 12000, 10, 1200, 50, "product_mixture"),
        ("machine_kde_log_density", "weierstrass init_pool", 1000, 10, 1200, 50, "product"),
        # the posterior server's logpdf on the full draw buffer: a probe
        # reader's one point, and a batch of 1,000 under the mixture reduce
        ("machine_kde_log_density", "serve logpdf Q=1", 1, 10, 1200, 50, "product"),
        ("machine_kde_log_density", "serve logpdf Q=1000 mixture", 1000, 10, 1200, 50, "mixture"),
        ("kde_log_density", "one machine of the path", 12000, 1, 1200, 50, "none"),
    ):
        q, s, h, _ = kde_inputs(Q, M, T, d)
        n_out = {"none": M, "product": 1, "mixture": 1, "product_mixture": 2}[reduce]
        nbytes = (4 * (Q * d + M * T * d + 2 * M) + 4 * M * (reduce in ("mixture", "product_mixture"))
                  + 4 * n_out * Q)
        pairs = Q * M * T  # Q·Σcounts
        by_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        by_mma = 3 * 2 * pairs * d / TF32_FLOPS * 1e3
        by_exp = pairs / mufu_per_s * 1e3
        bound = max(by_bytes, by_mma, by_exp)
        bound_by = "bytes" if bound == by_bytes else "operations"
        bound_fma, _ = least_ms(nbytes, 2 * pairs * d)
        if name == "kde_log_density":
            c, hc = s[0], h[0]
            run = lambda: kde_log_density(q, c, hc)  # noqa: E731
            run_plain = lambda: kde_log_density_ref(q, c, hc)  # noqa: E731
        else:
            run = lambda: machine_kde_log_density(  # noqa: E731
                q, s, h, reduce=reduce, mixture_weights="uniform")
            run_plain = lambda: machine_kde_log_density_ref(  # noqa: E731
                q, s, h, reduce=reduce, mixture_weights="uniform")
        ms, host = device_ms(run, iters=20)
        cold, _ = device_ms(run, iters=10, flush=flush)
        # one call queued behind the sleep: the chunked plain version is
        # hundreds of launches, and more would fill the stream's queue
        plain, plain_host = device_ms(run_plain, iters=1)
        print(f"  {name} {label} Q={Q} M={M} T={T} d={d} {reduce}: kernel {ms * 1e3:.2f} us "
              f"(cold L2 {cold * 1e3:.2f} us; host enqueue {host * 1e3:.2f} us/call), "
              f"plain {plain * 1e3:.2f} us (host {plain_host * 1e3:.2f} us/call), "
              f"bound {bound * 1e3:.2f} us by {bound_by} (bytes {by_bytes * 1e3:.2f} us, three "
              f"TF32 passes {by_mma * 1e3:.2f} us, exps {by_exp * 1e3:.2f} us at "
              f"{mufu_per_s / 1e12:.3f}e12/s; the direct form's float32 bound "
              f"{bound_fma * 1e3:.2f} us)", flush=True)
        kde_rows[label] = {"ms": ms, "cold_ms": cold, "host_ms": host, "plain_ms": plain,
                           "bound_ms": bound, "bound_by": bound_by,
                           "bound_terms_ms": {"bytes": by_bytes, "tf32_passes": by_mma,
                                              "exps": by_exp},
                           "bound_ms_float32_fma": bound_fma,
                           "shape": f"Q={Q} M={M} T={T} d={d} {reduce}"}
    # at Q = 1 the kernel centres and splits the whole buffer every call: the
    # share of that pre-pass, from kde_probe's build with everything after it
    # cut out (KDE_CUT=1), both graph-timed through the C entry point
    from repro_torch.kernels.kde_density import ops as kde_ops
    from repro_torch.launch import kde_probe

    kde_density_entry = kde_ops._entry()[1]
    q1, s1, h1, _ = kde_inputs(1, 10, 1200, 50)
    run1 = kde_probe.launcher(q1, s1, h1, "product")
    cut1 = kde_probe.build_cuts((1,))[1]
    prepass_us = kde_probe.graph_us(lambda: run1(cut1))
    whole_us = kde_probe.graph_us(lambda: run1(kde_density_entry))
    print(f"  machine_kde_log_density serve logpdf Q=1 (graph-timed, C entry point): whole "
          f"{whole_us:.2f} us, the centring pre-pass alone (KDE_CUT=1) {prepass_us:.2f} us = "
          f"{100.0 * prepass_us / whole_us:.1f} % of it", flush=True)
    kde_rows["serve logpdf Q=1"]["graph_us"] = {"whole": whole_us, "prepass": prepass_us}
    rows.append({"name": "machine_kde_log_density", **kde_rows["importance_pool"],
                 "at_init_pool": kde_rows["weierstrass init_pool"],
                 "at_serve_logpdf_q1": kde_rows["serve logpdf Q=1"],
                 "at_serve_logpdf_q1000_mixture": kde_rows["serve logpdf Q=1000 mixture"]})
    rows.append({"name": "kde_log_density", **kde_rows["one machine of the path"]})

    # online_update at the stream path's fold (the whole route) and at the
    # slab route's shape (the whole draw buffer as one chunk, as
    # --stream-every 1200 folds it); beside it the launch floor, the kernel's
    # empty body on the same grid and shared memory (online_update_probe cut
    # 0), timed the same way
    from repro_torch.launch.online_probe import probe_entry, probe_launch

    online_rows = {}
    for label in ("path fold", "slab: the draw buffer as one chunk"):
        count, mean, m2, chunk, _ = case_inputs(label, dev)
        M, C, d = chunk.shape
        plan = online_ops._plan(M, C, d)
        nbytes = 4 * (M * C * d + 2 * (M + M * d + M * d * d))
        # the Gram's upper triangle (all the kernel computes, the rest
        # mirrored), the mean and the centring, the merge
        flops = M * C * d * (d + 1) + 2 * M * C * d + 4 * M * d * d
        bound, bound_by = least_ms(nbytes, flops)
        routes = dict(online_kernel.route_launches)
        ms, host = device_ms(lambda: online_moments_update(count, mean, m2, chunk))
        cold, _ = device_ms(lambda: online_moments_update(count, mean, m2, chunk), flush=flush)
        moved = {r for r, n in online_kernel.route_launches.items() if n != routes[r]}
        if moved != {plan.route}:
            raise AssertionError(f"online_update timing ({label}) took {moved}, not {plan.route}")
        floor, _ = device_ms(probe_launch(probe_entry(), 0, plan.route, count, mean, m2, chunk))
        # ten calls behind the sleep: the plain version is ~30 launches a call,
        # and more would fill the stream's queue
        plain, plain_host = device_ms(lambda: online_moments_update_ref(count, mean, m2, chunk),
                                      iters=10)
        print(f"  online_update [{plan.route}] M={M} C={C} d={d} ({plan.blocks * M} blocks of "
              f"{plan.smem} B): kernel {ms * 1e3:.2f} us (cold L2 {cold * 1e3:.2f} us; host "
              f"enqueue {host * 1e3:.2f} us/call), launch floor {floor * 1e3:.2f} us, plain "
              f"{plain * 1e3:.2f} us (host {plain_host * 1e3:.2f} us/call), bound "
              f"{bound * 1e3:.3f} us by {bound_by} ({nbytes / 1e3:.1f} KB, {flops / 1e6:.2f} MFLOP)",
              flush=True)
        online_rows[label] = {"ms": ms, "cold_ms": cold, "host_ms": host,
                              "launch_floor_ms": floor, "plain_ms": plain, "bound_ms": bound,
                              "bound_by": bound_by, "plan": plan._asdict(),
                              "shape": f"M={M} C={C} d={d}"}
    rows.append({"name": "online_update", **online_rows["path fold"],
                 "slab_route": online_rows["slab: the draw buffer as one chunk"]})

    # flash_attention at the serving path's prefill shape (B=2) and the table's
    # (B=1): 8 KV heads of 3 query heads, hd 128, S = T = 4096, causal. In
    # bf16 on the bf16 tensor-core route (bound over the bf16 tensor-core
    # rate); at B=2 in float32 on the "tf32x3" route (bound over the TF32
    # rate for its three passes: 3× the work) and on the FMA route, reached
    # through a q whose base sits 4 bytes off 16, which no tensor map takes
    # (bound over the float32 FMA rate). Work: 2·(hd + hd_v) flop per visible
    # (query, kv) pair, S(S+1)/2 pairs per head; bytes: q, k, v read once, out
    # written once. PyTorch's scaled_dot_product_attention on the same
    # tensors (q and k/v as (B, heads, S, hd) views, in the same dtype) is
    # the library yardstick; the port never calls it. The FMA row computes
    # the same function on the same shape as the "tf32x3" row, whose plain
    # and library times it shares.
    sdpa = torch.nn.functional.scaled_dot_product_attention
    flash_rows = {}
    for label, B, dtype, route in (("bf16 B=2", 2, torch.bfloat16, "tensor_core"),
                                   ("bf16 B=1", 1, torch.bfloat16, "tensor_core"),
                                   ("float32 B=2", 2, torch.float32, "tf32x3"),
                                   ("float32 B=2 q 4 bytes off 16", 2, torch.float32, "fma")):
        K, G, hd, S = 8, 3, 128, 4096
        if route == "fma":
            flat = torch.randn((B * S * K * G * hd + 1,), generator=gen, device=dev)
            q = flat[1:].view(B, S, K, G, hd)
        else:
            q = torch.randn((B, S, K, G, hd), generator=gen, device=dev).to(dtype)
        k = torch.randn((B, S, K, hd), generator=gen, device=dev).to(dtype)
        v = torch.randn((B, S, K, hd), generator=gen, device=dev).to(dtype)
        is16 = dtype == torch.bfloat16
        nbytes = q.element_size() * (2 * B * S * K * G * hd + 2 * B * S * K * hd)
        flops = 2 * (hd + hd) * B * K * G * S * (S + 1) // 2
        bound32, _ = least_ms(nbytes, flops)  # the float32 FMA rate
        if route == "tensor_core":
            bound, bound_by = least_ms(nbytes, flops, peak=BF16_FLOPS)
        elif route == "tf32x3":
            bound, bound_by = least_ms(nbytes, 3 * flops, peak=TF32_FLOPS)
        else:
            bound, bound_by = least_ms(nbytes, flops)
        run = lambda: flash_attention(q, k, v, causal=True)  # noqa: E731
        routes = dict(flash_kernel.route_launches)
        ms, host = device_ms(run, iters=10)
        cold, _ = device_ms(run, iters=5, flush=flush)
        moved = {r: n - routes[r] for r, n in flash_kernel.route_launches.items() if n != routes[r]}
        if set(moved) != {route}:
            raise AssertionError(f"flash_attention timing ({label}) launched {moved}, not {route}")
        if route != "fma":
            qh, kh_, vh = q.reshape(B, S, K * G, hd).transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
            try:
                sdpa(qh[:, :, :8], kh_[:, :, :8], vh[:, :, :8], is_causal=True, enable_gqa=True)
                lib_run = lambda: sdpa(qh, kh_, vh, is_causal=True, enable_gqa=True)  # noqa: E731
                how = "enable_gqa"
            except TypeError:  # an older PyTorch: repeat the KV heads for it
                k_rep, v_rep = kh_.repeat_interleave(G, dim=1), vh.repeat_interleave(G, dim=1)
                lib_run = lambda: sdpa(qh, k_rep, v_rep, is_causal=True)  # noqa: E731
                how = "KV heads repeated"
            # a reading only: in bf16 the library and the kernel round P alike
            lib_gap = float((flash_attention(q, k, v).float()
                             - lib_run().transpose(1, 2).reshape(B, S, K, G, hd).float()).abs().max())
            lib_ms, lib_host = device_ms(lib_run, iters=20)
            # one plain call behind the sleep: it is ~10 launches over GBs of scores
            plain, plain_host = device_ms(lambda: flash_attention_ref(q, k, v, causal=True), iters=1)
            del qh, kh_, vh, lib_run
        rate = {"tensor_core": "bf16 tensor-core", "tf32x3": "TF32 tensor-core (three passes)",
                "fma": "float32 FMA"}[route]
        print(f"  flash_attention [{route}] B={B} K={K} G={G} S=T={S} hd={hd} causal {label}: "
              f"kernel {ms * 1e3:.2f} us (cold L2 {cold * 1e3:.2f} us; host enqueue "
              f"{host * 1e3:.2f} us/call), plain {plain * 1e3:.2f} us, "
              f"scaled_dot_product_attention ({how}) {lib_ms * 1e3:.2f} us, bound "
              f"{bound * 1e3:.2f} us by {bound_by} at the {rate} rate ({bound32 * 1e3:.2f} us at the "
              f"float32 FMA rate; {flops:.4e} flop, {nbytes / 1e6:.1f} MB); max |kernel - library| "
              f"{lib_gap:.3e}", flush=True)
        flash_rows[label] = {"name": "flash_attention", "ms": ms, "cold_ms": cold,
                             "host_ms": host, "plain_ms": plain, "bound_ms": bound,
                             "bound_by": bound_by, "bound_ms_float32": bound32,
                             "library_ms": lib_ms,
                             "shape": f"B={B} K={K} G={G} S=T={S} hd={hd} causal "
                                      f"{str(dtype).split('.')[-1]}"}
        del q, k, v
        torch.cuda.empty_cache()
    keys = ("ms", "cold_ms", "host_ms", "plain_ms", "bound_ms", "bound_ms_float32", "library_ms")
    flash_row = dict(flash_rows["bf16 B=2"],
                     at_B1={key: flash_rows["bf16 B=1"][key] for key in keys},
                     tf32x3_route={key: flash_rows["float32 B=2"][key] for key in keys + ("shape",)},
                     fma_route={key: flash_rows["float32 B=2 q 4 bytes off 16"][key]
                                for key in keys + ("shape",)})
    rows.append(flash_row)
    rows.append(flash_bwd_timing(dev, gen, flush))

    phase("6 summary")
    print(f"  chip_smoke ran {time.perf_counter() - t_start:.1f} s, the build included", flush=True)
    out = []
    for r in rows:
        name = r.pop("name")
        k = kernels.KERNELS[name]
        # each kernel's launches on its own main path: the serving run for
        # flash_attention, the stream (which runs every MCMC kernel) otherwise
        main_launches = {"flash_attention": launches_serve,
                         "flash_attention_bwd": launches_train}.get(name, launches_stream)
        entry = {
            "name": name, "route": "cuda", "source": os.path.relpath(k.source, root),
            "replaces": k.replaces, "launches": main_launches[name],
            "max_abs_err": errs[name], "library_ms": None, **r,
            "launches_by_path": {"paper": launches_paper[name], "all": launches[name],
                                 "stream": launches_stream[name], "serve": launches_serve[name],
                                 "posterior_serve": launches_post[name],
                                 "mesh_paper": launches_mesh[name],
                                 "mesh_stream": launches_mesh_stream[name],
                                 **{label: o["launches"][name] for label, o in other.items()},
                                 "train": launches_train[name]},
        }
        if name in err32:
            entry["max_abs_err_float32_plain"] = err32[name]
        if name == "img_log_weights":  # the MCMC paths' launches, by route
            entry["launches_by_route"] = img_routes
        if name == "online_update":  # the stream path's launches, by route
            entry["launches_by_route"] = {"stream": online_routes_stream}
        if name == "flash_attention":  # the serving and training runs' launches, by route
            entry["launches_by_route"] = {"serve_bfloat16": routes_serve16,
                                          "serve_float32": routes_serve32,
                                          "train": routes_train}
            entry["max_abs_err_by_route"] = flash_err64
            entry["lse_max_abs_err"] = lse_err
        if name == "flash_attention_bwd":  # the training runs' launches, by route
            entry["launches_by_route"] = {"train": routes_train_bwd}
            entry["max_abs_err_by_route"] = bwd_err64
            entry["train"] = train_record
        out.append(entry)
    print(json.dumps({"kernels": out}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                              "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
