"""One rank of ``tests/test_torch_spmd.py``'s 8-process gloo run (no JAX here).

Every rank builds the same reduced models and data from seeds, runs the
unplaced port step on the whole problem and the placed step on its shards
of a (data 4, model 2) mesh, and rank 0 writes what the test asserts to
``<out>/result.json``:

- ``epmcmc[<arch>]``: the placed ``epmcmc_step`` against the unplaced one
  (per-chain loss and gradient norm, every parameter, v and Welford
  moment): max |Δ|; the collectives the placed step issued and the chain
  check's verdict on them; the same step with chain 1's batch changed:
  which chains' parameters moved;
- ``train[<arch>]``: a placed ``train_step`` (AdamW) on an FSDP config
  against the unplaced one: loss, gradient and parameter max |Δ|;
- ``cross_chain``: the chain check on a hand-made all-reduce over the data
  axis (it must fail).
"""

from __future__ import annotations

import dataclasses
import json
import os
import sys

import torch


def _max_diff(a, b) -> float:
    return max(float((x.detach().float() - y.detach().float()).abs().max())
               for x, y in zip(a, b))


def _whole(t):
    return t.full_tensor() if hasattr(t, "full_tensor") else t


def run(rank: int, world: int, port: int, out: str) -> None:
    torch.set_num_threads(1)
    import logging

    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    logging.getLogger("torch.distributed.tensor._redistribute").setLevel(logging.ERROR)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", rank=rank,
                            world_size=world)
    from repro_torch.configs import get_config
    from repro_torch.data import TokenStream
    from repro_torch.distributed import epmcmc
    from repro_torch.distributed import sharding as shd
    from repro_torch.launch import op_stats
    from repro_torch.models.lm import model as mdl
    from repro_torch.models.lm import steps
    from repro_torch.models.lm.config import reduced

    mesh = init_device_mesh("cpu", (4, 2), mesh_dim_names=("data", "model"))
    result = {"epmcmc": {}, "train": {}}
    # S = 32 > attn_chunk = 16: the GQA config's attention runs flash's plain
    # version on each rank's KV head (2 heads over model 2); Mamba-2's SSD
    # on its heads
    for arch in ("llama3_2_3b", "mamba2_130m"):
        cfg = reduced(get_config(arch), attn_chunk=16)
        n_chains = epmcmc.num_chains(mesh)

        def fresh():
            return epmcmc.init_state(0, cfg, n_chains, device="cpu")

        def data(bump=None):
            batch = {k: torch.stack([TokenStream(cfg.vocab_size, 2, 32, seed=1, shard_index=c,
                                                 device="cpu").batch(0)[k]
                                     for c in range(n_chains)])
                     for k in ("tokens", "labels")}
            if bump is not None:  # chain `bump`'s tokens and labels changed
                batch = {k: v.clone() for k, v in batch.items()}
                for v in batch.values():
                    v[bump] = (v[bump] + 7) % cfg.vocab_size
            return batch

        # ε_rms = 1 keeps the preconditioner 1/(√v + ε) ≤ 1: with the default
        # 1e-4 it reaches 1e4 where a gradient entry is near 0, and a float32
        # rounding of that entry moves θ by a visible amount
        kw = dict(num_shards=n_chains, shard_tokens=64.0, step_size=1e-3, burn_in=0,
                  rmsprop_eps=1.0)
        ref, ref_m = epmcmc.epmcmc_step(fresh(), data(), cfg, **kw)
        placed = epmcmc.place_state(fresh(), cfg, mesh)
        tally = op_stats.Tally()
        with tally:
            placed, m = epmcmc.epmcmc_step(placed, epmcmc.place_batch(data(), mesh), cfg, **kw)
        groups = [(kind, ranks) for kind, ranks, _ in tally.groups]
        try:
            checked = epmcmc.assert_no_cross_chain_collectives(groups, mesh=mesh)
            verdict = "passed"
        except epmcmc.CrossChainError as e:
            checked, verdict = 0, f"failed: {e}"
        rec = {
            "loss": _max_diff([_whole(m["loss_per_chain"])], [ref_m["loss_per_chain"]]),
            "gnorm": _max_diff([_whole(m["gnorm_per_chain"])], [ref_m["gnorm_per_chain"]]),
            "loss_scale": float(ref_m["loss_per_chain"].abs().max()),
            "gnorm_scale": float(ref_m["gnorm_per_chain"].abs().max()),
            "check": verdict, "collectives": len(groups), "checked": checked,
        }
        for key in ("params", "v", "m_mean", "m_var"):
            got, want = getattr(placed, key), getattr(ref, key)
            rec[key] = _max_diff([_whole(got[n]) for n in want], list(want.values()))
        rec["m_count"] = _max_diff([_whole(placed.m_count)], [ref.m_count])
        # chain isolation: chain 1's batch changed moves chain 1 alone
        moved_state, _ = epmcmc.epmcmc_step(epmcmc.place_state(fresh(), cfg, mesh),
                                            epmcmc.place_batch(data(bump=1), mesh), cfg, **kw)
        rec["moved"] = [c for c in range(n_chains) if any(
            not torch.equal(_whole(moved_state.params[n])[c], _whole(placed.params[n])[c])
            for n in ref.params)]
        result["epmcmc"][arch] = rec

    # a placed AdamW step on an FSDP config (deepseek-coder-33b sets fsdp)
    arch = "deepseek_coder_33b"
    cfg = dataclasses.replace(reduced(get_config(arch), attn_chunk=16), fsdp=True)
    gen = torch.Generator().manual_seed(0)
    m0 = mdl.init_params(cfg, generator=gen, device="cpu")
    m1 = mdl.init_params(cfg, device="cpu")
    m1.load_state_dict(m0.state_dict())
    batch = TokenStream(cfg.vocab_size, 4, 32, seed=2, device="cpu").batch(0)
    total0, _ = steps.loss_fn(m0, cfg, batch)
    g0 = steps.grads_of(total0, dict(m0.named_parameters()))
    specs = shd.param_specs(cfg, mesh, m1)
    shd.distribute_model(m1, mesh, specs)
    pbatch = shd.distribute_tree(batch, mesh, shd.batch_specs(cfg, mesh, batch))
    total1, _ = steps.loss_fn(m1, cfg, pbatch)
    g1 = steps.grads_of(total1, dict(m1.named_parameters()))
    grad_diff = _max_diff([_whole(g1[n]) for n in g0], list(g0.values()))
    opt0 = steps.adamw_init(dict(m0.named_parameters()))
    opt1 = steps.adamw_init(dict(m1.named_parameters()))
    _, _, met0 = steps.train_step(m0, opt0, batch, cfg)
    _, _, met1 = steps.train_step(m1, opt1, pbatch, cfg)
    p1 = dict(m1.named_parameters())
    result["train"][arch] = {
        "loss": abs(float(_whole(met1["loss"])) - float(met0["loss"])),
        "grad": grad_diff, "grad_scale": max(float(g.abs().max()) for g in g0.values()),
        "params": _max_diff([_whole(p1[n]) for n, _ in m0.named_parameters()],
                            [p for _, p in m0.named_parameters()]),
        "fsdp_leaves": sum(any(ax is not None and "data" in shd._axes(ax) for ax in s)
                           for s in specs.values()),
    }

    # the check on a hand-made cross-chain all-reduce (over the data axis)
    tally = op_stats.Tally()
    with tally:
        from torch.distributed import _functional_collectives as funcol

        funcol.all_reduce(torch.ones(3), "sum", mesh["data"].get_group()).wait()
    try:
        epmcmc.assert_no_cross_chain_collectives(
            [(k, r) for k, r, _ in tally.groups], mesh=mesh)
        result["cross_chain"] = "passed"
    except epmcmc.CrossChainError as e:
        result["cross_chain"] = f"failed: {e}"

    if rank == 0:
        with open(os.path.join(out, "result.json"), "w") as f:
            json.dump(result, f, indent=1)
    dist.barrier()
    dist.destroy_process_group()


if __name__ == "__main__":
    run(int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])
