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
  axis (it must fail);
- ``sgd``, ``resume``, ``gather``, ``dots``: the placed synchronous
  baseline, placed checkpoints resumed, the placed gather form of MoE
  decode and ``remat="dots"`` placed (each function's docstring below).
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

    result.update(_sgd_and_checkpoints(mesh, rank, out))
    result["gather"] = _gather_decode(mesh)
    result["dots"] = _remat_dots(mesh)

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


def _same(a, b) -> bool:
    """Every tensor of two equal-length lists, whole, the same bits."""
    return all(torch.equal(_whole(x).detach(), _whole(y).detach()) for x, y in zip(a, b))


def _on_every_rank(ok: bool) -> bool:
    """Whether ``ok`` holds on every rank."""
    import torch.distributed as dist

    t = torch.tensor(int(ok))
    dist.all_reduce(t, op=dist.ReduceOp.MIN)
    return bool(t)


def _sgd_and_checkpoints(mesh, rank: int, out: str) -> dict:
    """``sgd``: the placed ``sgd_baseline_step`` against the unplaced one
    (loss, θ and v max |Δ| and their scales). ``resume``: for epmcmc, sgd
    and adamw, two placed steps against one placed step, a checkpoint of
    whole leaves written by rank 0 from the ranks' blocks (``launch.train``'s
    trees and ``save_placed``), a restore of each rank's blocks from the
    memory-mapped files into a fresh placed state and the second step: whether every leaf (and
    the generator of every chain this rank holds) is the same bits."""
    import torch.distributed as dist

    from repro_torch.checkpoint import restore
    from repro_torch.configs import get_config
    from repro_torch.data import TokenStream
    from repro_torch.distributed import epmcmc
    from repro_torch.distributed import sharding as shd
    from repro_torch.launch import train
    from repro_torch.models.lm import model as mdl
    from repro_torch.models.lm import steps
    from repro_torch.models.lm.config import reduced

    cfg = reduced(get_config("llama3_2_3b"), attn_chunk=16)
    n_chains = epmcmc.num_chains(mesh)

    def fresh():
        return epmcmc.init_state(0, cfg, n_chains, device="cpu")

    def data(step):
        return {k: torch.stack([TokenStream(cfg.vocab_size, 2, 32, seed=1, shard_index=c,
                                            device="cpu").batch(step)[k]
                                for c in range(n_chains)])
                for k in ("tokens", "labels")}

    kw = dict(num_shards=n_chains, shard_tokens=64.0, step_size=1e-3, rmsprop_eps=1.0)
    ref, ref_m = epmcmc.sgd_baseline_step(fresh(), data(0), cfg, **kw)
    placed, m = epmcmc.sgd_baseline_step(epmcmc.place_state(fresh(), cfg, mesh),
                                         epmcmc.place_batch(data(0), mesh), cfg, **kw)
    res = {"sgd": {
        "loss": _max_diff([_whole(m["loss_per_chain"])], [ref_m["loss_per_chain"]]),
        "loss_scale": float(ref_m["loss_per_chain"].abs().max()),
        "params": _max_diff([_whole(placed.params[n]) for n in ref.params],
                            list(ref.params.values())),
        "move_scale": max(float((ref.params[n] - t).abs().max())
                          for n, t in fresh().params.items()),
        "v": _max_diff([_whole(placed.v[n]) for n in ref.v], list(ref.v.values())),
        "v_scale": max(float(t.abs().max()) for t in ref.v.values()),
    }, "resume": {}}

    def checkpoint(kind, tree, step):
        path = os.path.join(out, f"ckpt_{kind}")
        train.save_placed(path, step, tree, metadata={"train_step": step})
        return restore(path, mmap=True)[0]

    # the chains this rank holds: it draws their noise (the others'
    # generators it never advances; the checkpoint holds their owners' states)
    per = n_chains // mesh.size(0)
    held = range(per * mesh.get_coordinate()[0], per * (mesh.get_coordinate()[0] + 1))
    for kind in ("epmcmc", "sgd"):
        step = epmcmc.epmcmc_step if kind == "epmcmc" else epmcmc.sgd_baseline_step
        kws = dict(kw, burn_in=0) if kind == "epmcmc" else kw
        state, _ = step(epmcmc.place_state(fresh(), cfg, mesh),
                        epmcmc.place_batch(data(0), mesh), cfg, **kws)
        leaves = checkpoint(kind, train.epmcmc_tree(state), 1)
        full, _ = step(state, epmcmc.place_batch(data(1), mesh), cfg, **kws)
        again = train.restore_epmcmc(leaves, epmcmc.place_state(fresh(), cfg, mesh))
        again, _ = step(again, epmcmc.place_batch(data(1), mesh), cfg, **kws)
        res["resume"][kind] = _on_every_rank(
            again.step == full.step and all(
                _same(list(getattr(again, k).values()), list(getattr(full, k).values()))
                for k in ("params", "v", "m_mean", "m_var"))
            and _same([again.m_count], [full.m_count])
            and all(torch.equal(again.gens[c].get_state(), full.gens[c].get_state())
                    for c in held))

    def placed_model(generator):
        model = mdl.init_params(cfg, generator=generator, device="cpu")
        shd.distribute_model(model, mesh, shd.param_specs(cfg, mesh, model))
        return model, steps.adamw_init(dict(model.named_parameters()))

    def batch(step):
        b = TokenStream(cfg.vocab_size, 4, 32, seed=2, device="cpu").batch(step)
        return shd.distribute_tree(b, mesh, shd.batch_specs(cfg, mesh, b))

    model, opt = placed_model(torch.Generator().manual_seed(0))
    model, opt, _ = steps.train_step(model, opt, batch(0), cfg)
    leaves = checkpoint("adamw", train.adamw_tree(model, opt), 1)
    model, opt, _ = steps.train_step(model, opt, batch(1), cfg)
    model2, opt2 = placed_model(None)
    opt2 = train.restore_adamw(leaves, model2, opt2)
    model2, opt2, _ = steps.train_step(model2, opt2, batch(1), cfg)
    res["resume"]["adamw"] = _on_every_rank(
        opt2.count == opt.count
        and _same([p for _, p in model2.named_parameters()], [p for _, p in model.named_parameters()])
        and all(_same(list(getattr(opt2, k).values()), list(getattr(opt, k).values()))
                for k in ("mu", "nu")))
    return res


def _gather_decode(mesh) -> dict:
    """The gather form of MoE decode (reduced granite, 8 experts top-2, over
    model 2) placed by the sharding rules against the unplaced form on the
    same weights and a (4, 1, d) decode input: max |Δ| of the output and
    whether it is the same bits."""
    from repro_torch.configs import get_config
    from repro_torch.distributed import sharding as shd
    from repro_torch.models.lm import model as mdl
    from repro_torch.models.lm.config import reduced

    cfg = dataclasses.replace(reduced(get_config("granite_moe_1b")), moe_decode_impl="gather")
    m0 = mdl.init_params(cfg, generator=torch.Generator().manual_seed(3), device="cpu")
    m1 = mdl.init_params(cfg, device="cpu")
    m1.load_state_dict(m0.state_dict())
    shd.distribute_model(m1, mesh, shd.param_specs(cfg, mesh, m1))
    x = torch.randn((4, 1, cfg.d_model), generator=torch.Generator().manual_seed(4))
    want, _ = m0.blocks[1].moe.decode(x)
    spec = shd.batch_specs(cfg, mesh, {"x": x})["x"]  # the batch over data
    got, _ = m1.blocks[1].moe.decode(shd.place(x, mesh, spec))
    return {"diff": _max_diff([_whole(got)], [want]), "scale": float(want.abs().max()),
            "bitwise": torch.equal(_whole(got), want),
            "experts_split": m1.blocks[1].moe.experts.w_gate.to_local().shape[0]}


def _remat_dots(mesh) -> dict:
    """``remat="dots"`` placed against ``"none"`` unplaced on the same
    weights and batch, for a GQA config (flash in its region), Mamba-2 (the
    SSD in its region) and granite's MoE (the plan and experts in theirs):
    loss and every gradient max |Δ| and the largest gradient."""
    from repro_torch.configs import get_config
    from repro_torch.data import TokenStream
    from repro_torch.distributed import sharding as shd
    from repro_torch.models.lm import model as mdl
    from repro_torch.models.lm import steps
    from repro_torch.models.lm.config import reduced

    res = {}
    for arch in ("llama3_2_3b", "mamba2_130m", "granite_moe_1b"):
        cfg = reduced(get_config(arch), attn_chunk=16)
        m0 = mdl.init_params(cfg, generator=torch.Generator().manual_seed(5), device="cpu")
        m1 = mdl.init_params(cfg, device="cpu")
        m1.load_state_dict(m0.state_dict())
        batch = TokenStream(cfg.vocab_size, 4, 32, seed=6, device="cpu").batch(0)
        total0, _ = steps.loss_fn(m0, cfg, batch)
        g0 = steps.grads_of(total0, dict(m0.named_parameters()))
        dots = dataclasses.replace(cfg, remat="dots")
        m1.cfg = dots
        shd.distribute_model(m1, mesh, shd.param_specs(dots, mesh, m1))
        pbatch = shd.distribute_tree(batch, mesh, shd.batch_specs(dots, mesh, batch))
        total1, _ = steps.loss_fn(m1, dots, pbatch)
        g1 = steps.grads_of(total1, dict(m1.named_parameters()))
        res[arch] = {"loss": abs(float(_whole(total1)) - float(total0)),
                     "loss_scale": abs(float(total0)),
                     "grad": _max_diff([_whole(g1[n]) for n in g0], list(g0.values())),
                     "grad_scale": max(float(g.abs().max()) for g in g0.values())}
    return res


if __name__ == "__main__":
    run(int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])
