"""Multi-rank jobs of the port's distribution tests, on the CPU.

`run_ranks(job, data, tmp_path, world)` spawns `world` processes, joins
them into a gloo process group through a FileStore in `tmp_path` (no TCP
rendezvous, so parallel test workers cannot collide on a port), runs
`job(rank, world, data)` in each and returns every rank's result. The
jobs live here, in a module that imports torch and the port only, so the
spawned processes do not import JAX.
"""

import os

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from kimera_multi_tpu_torch import convert
from kimera_multi_tpu_torch.dist import (chain, checkpoint, mesh, rounds,
                                         sharded_verify)
from kimera_multi_tpu_torch.solve import rbcd


def _main(rank, world, store, job, data, out):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store, world),
                            rank=rank, world_size=world)
    try:
        res = job(rank, world, data)
        torch.save(res, os.path.join(out, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def run_ranks(job, data, tmp_path, world: int = 2) -> list:
    out = str(tmp_path)
    os.makedirs(out, exist_ok=True)
    mp.spawn(_main, args=(world, os.path.join(out, "store"), job, data, out),
             nprocs=world, join=True)
    return [torch.load(os.path.join(out, f"rank{r}.pt"), weights_only=False)
            for r in range(world)]


def edges_of(d: dict):
    """PoseGraphEdges on the CPU from a dict of numpy fields."""
    return convert.edges_from_numpy(**d, device="cpu")


def rounds_job(rank, world, data):
    """`data["n_rounds"]` rounds of `make_round_fn` from Y0; returns the
    blocks after each round, the final weights and the comm bytes
    counted in the first round."""
    edges = edges_of(data["edges"])
    Y0 = torch.from_numpy(data["Y0"])
    R = Y0.shape[0]
    active = torch.from_numpy(data.get("active", np.ones(R, bool)))
    cfg = rbcd.RbcdConfig(**data.get("cfg", {}))
    with mesh.robot_group(R, "cpu") as group:
        fn = rounds.make_round_fn(group, edges, data["ppr"], cfg,
                                  **data.get("round_kw", {}))
        state = rounds.init_state(Y0, active, edges, data["ppr"])
        comm, Ys = None, []
        for _ in range(data["n_rounds"]):
            received = group.received
            state, _cost = fn(state)
            if comm is None:
                comm = rounds.measured_round_comm_bytes(
                    group.received - received, Y0.shape, world,
                    cfg.inner_iters)
            Ys.append(state.Y.numpy())
    return dict(Ys=Ys, weights=state.gnc_state.weights.numpy(), comm=comm)


def resume_job(rank, world, data):
    """Load the checkpoint `data["load"]`, run one round (the JAX
    package's round settings of tests/test_rbcd_dist.py's checkpoint
    case), save to `data["save"]` (rank 0); returns the blocks."""
    edges = edges_of(data["edges"])
    state = checkpoint.load(data["load"])
    with mesh.robot_group(state.Y.shape[0], "cpu") as group:
        fn = rounds.make_round_fn(group, edges, data["ppr"],
                                  rbcd.RbcdConfig(inner_iters=2))
        state, _ = fn(state)
    if rank == 0:
        checkpoint.save(data["save"], state)
    return dict(Y=state.Y.numpy(), weights=state.gnc_state.weights.numpy(),
                round_idx=state.round_idx)


def chain_job(rank, world, data):
    with mesh.robot_group(world, "cpu") as group:
        solve = chain.make_chain_translation_solver(
            group, data["n"], len(data["lc_src"]), cg_iters=data["cg_iters"])
        t = lambda k: torch.from_numpy(data[k])  # noqa: E731
        w = None if data.get("wc") is None else t("wc")
        return solve(t("d_chain"), t("lc_src"), t("lc_dst"), t("lc_d"),
                     t("lc_w"), w_chain=w).numpy()


def verify_job(rank, world, data):
    with mesh.robot_group(world, "cpu") as group:
        run = sharded_verify.make_sharded_arun(group, n_hyp=data["n_hyp"])
        t = lambda k: torch.from_numpy(data[k])  # noqa: E731
        res = run(t("key"), t("p"), t("q"), t("valid"))
        cand = sharded_verify.arun_slice(t("key"), t("p"), t("q"),
                                         t("valid"), rank, world,
                                         data["n_hyp"])
    return dict({k: v.numpy() for k, v in res.items()}, cand=cand.numpy())


def dryrun_job(rank, world, data):
    from kimera_multi_tpu_torch.entry import dryrun_multichip

    return dryrun_multichip(world, device="cpu")


def pod_rounds_job(rank, world, data):
    """The pods' dpgo rounds (cli/pod.py: `make_round_fn` over the fabric,
    pod k owning every robot r with r % P == k) over `world` gloo ranks
    with contiguous blocks instead: the pod's start, one cycle a round,
    GNC every 2nd round from round 8. Returns the final blocks."""
    from kimera_multi_tpu_torch.cli import pod

    edges = edges_of(data["edges"])
    R, ppr = data["robots"], data["ppr"]
    state = pod.initial_state(edges, R, ppr, data["seed"])
    with mesh.robot_group(R, "cpu") as group:
        fn = rounds.make_round_fn(
            group, edges, ppr, rbcd.RbcdConfig(inner_iters=pod.POD_INNER_ITERS),
            weight_update_every=pod.POD_GNC_EVERY,
            burnin_rounds=pod.POD_BURNIN)
        for _ in range(data["rounds"]):
            state, _ = fn(state)
    return state.Y.numpy()
