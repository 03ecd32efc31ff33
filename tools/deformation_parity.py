"""The port's deformation-graph solve (float64, every operation in a fixed
order) against the JAX package's (float32, and float64 under
`jax.enable_x64`) on the inputs `cli/run.py::write_artifacts` gives it
after a `sim` run: each robot's odometry positions as the nodes (kNN
k = 3) and every max(T // 8, 1)-th node pinned at its optimized position,
4 Gauss-Newton x 30 CG steps. Runs on the CPU. The optimized positions
are read from the run's final TUM dumps, so the run may be made on any
device:

    python -m kimera_multi_tpu_torch.cli.run --mode sim --robots 6 \\
        --steps 1024 --features 704 --seed 0 --log-dir LOGS
    JAX_PLATFORMS=cpu python tools/deformation_parity.py --log-dir LOGS \\
        --robots 6 --steps 1024 --features 704 --seed 0

Prints one JSON object: per robot, the largest difference of the solved
node translations (metres) of the port against JAX float32, of the port
against JAX float64, and of JAX float32 against JAX float64, and each
solve's largest constraint residual."""

import argparse
import json
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--log-dir", required=True)
    p.add_argument("--robots", type=int, default=6)
    p.add_argument("--steps", type=int, default=1024)
    p.add_argument("--features", type=int, default=704)
    p.add_argument("--seed", type=int, default=0)
    args = p.parse_args(argv)

    import jax
    import jax.numpy as jnp
    import torch

    from kimera_multi_tpu.solve import deformation as jdfm
    from kimera_multi_tpu_torch.cli import monitor, run
    from kimera_multi_tpu_torch.io import logs, sim_world
    from kimera_multi_tpu_torch.solve import deformation as dfm

    torch.set_num_threads(1)
    T = args.steps
    world = sim_world.make_world(n_robots=args.robots, n_steps=T,
                                 features_per_kf=args.features,
                                 seed=args.seed)
    t_odo = run._odometry_poses(world)[1]
    con = np.arange(0, T, max(T // 8, 1), dtype=np.int32)
    ok = np.ones(len(con), bool)
    cfg = dfm.DeformationConfig(gn_iters=4, cg_iters=30)
    cfg_j = jdfm.DeformationConfig(gn_iters=4, cg_iters=30)

    def con_residual(t_nodes, pos, target):
        return float(np.linalg.norm(pos[con] + t_nodes[con] - target,
                                    axis=-1).max())

    out = {}
    for r in range(args.robots):
        dumps = monitor.newest_tum(os.path.join(args.log_dir, f"robot{r}"))
        t_est = logs.read_tum(dumps[-1])[1]
        pos = t_odo[r].astype(np.float32)
        target = t_est[con].astype(np.float32)
        st = dfm.solve(
            dfm.identity_state(T, device="cpu"),
            dfm.build_graph_knn(torch.from_numpy(pos), k=3),
            torch.from_numpy(con), torch.from_numpy(target),
            torch.from_numpy(ok), cfg)
        t_port = st.t.numpy().astype(np.float64)
        st_j = jdfm.solve(jdfm.identity_state(T),
                          jdfm.build_graph_knn(jnp.asarray(pos), k=3),
                          jnp.asarray(con), jnp.asarray(target),
                          jnp.asarray(ok), cfg_j)
        t32 = np.asarray(st_j.t, np.float64)
        with jax.enable_x64(True):
            f64 = lambda a: jnp.asarray(np.asarray(a, np.float64))  # noqa
            st_64 = jdfm.solve(jdfm.identity_state(T),
                               jdfm.build_graph_knn(f64(pos), k=3),
                               jnp.asarray(con), f64(target),
                               jnp.asarray(ok), cfg_j)
            t64 = np.asarray(st_64.t, np.float64)
        d = lambda a, b: float(np.abs(a - b).max())  # noqa: E731
        out[r] = {
            "port_vs_jax_f32_m": d(t_port, t32),
            "port_vs_jax_f64_m": d(t_port, t64),
            "jax_f32_vs_jax_f64_m": d(t32, t64),
            "con_residual_m": {
                "port": con_residual(t_port, pos, target),
                "jax_f32": con_residual(t32, pos, target),
                "jax_f64": con_residual(t64, pos, target)},
        }
    print(json.dumps({"deformation_parity": {
        "world": f"make_world({args.robots}, {T}, {args.features}, "
                 f"seed={args.seed})",
        "robots": out}}))


if __name__ == "__main__":
    main()
