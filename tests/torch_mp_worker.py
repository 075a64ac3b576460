"""Worker process of tests/test_torch_distributed.py (not a test module).

Run as: python torch_mp_worker.py <mode> <in.npz> <out.npz> with QTPU_*
set by the parent; gloo on the CPU, one rank a process, one thread.

  stats: a (dp=2, sp=1) mesh; the rank's rows of the 16-scenario batch of
         tests/test_distributed.py::make_batch (arrays in in.npz) go
         through `sharded_solve_stats`; writes the rank's forces and the
         reduced mean |f|, and the rank's forces again with the float64
         inverse in place of `newton_schulz_inverse` (`exact_inverse`).
  sp:    a (dp=1, sp=2) mesh; both ranks pass the same 8 problems of
         tests/test_solver_sp.py::make_probs (in.npz: seed 0, and seed 3
         with its warm start under the suffix _w) to `solve_cone_sp`:
         relaxed, accelerated, and warm-started accelerated; writes the
         solutions.
  fleet: example_fleet_sweep.run for in.npz's `steps` ticks, which starts
         the group itself; writes the rank's rows of the traces.
"""

import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))

import numpy as np  # noqa: E402
import torch  # noqa: E402

torch.set_num_threads(1)

from quadruped_tpu_torch.distributed import runtime  # noqa: E402


def solve_batch(params, yaw, feet, x0, horizon=5):
    """The port's twin of tests/test_distributed.py::solve_batch:
    [B, 4, 3] first-step forces of 30-iteration relaxed solves."""
    from quadruped_tpu_torch.dynamics import srb
    from quadruped_tpu_torch.solvers import condense, cone_qp

    b = yaw.shape[0]
    a, bmat = srb.srb_continuous(yaw, params.total_inertia,
                                 params.total_mass, feet)
    ad, bd = srb.srb_discretize(a, bmat, 0.03)
    x_des = x0[:, None, :].expand(b, horizon, 13)
    w = torch.tensor([10, 10, 5, 40, 60, 100, 0, 0, 0.5, 5, 5, 1, 0.0])
    p, q = condense.condense_cost(ad, bd, x0, x_des, w, 4e-6, horizon)
    fz_hi = params.max_force.expand(b, horizon * 4).clone()
    prob = cone_qp.ConeQP(p=p, q=q, mu=torch.full((b,), 0.45),
                          fz_lo=torch.zeros_like(fz_hi), fz_hi=fz_hi)
    return cone_qp.solve(prob, iters=30).x[:, :12].reshape(b, 4, 3)


def exact_inverse(m, *args, **kwargs):
    """M^{-1} in float64, rounded to float32: the inverse the test patches
    into both packages, so that the sharded solve is held to JAX's
    without the bf16 Newton-Schulz rounding of either."""
    return torch.from_numpy(np.linalg.inv(m.double().numpy())
                            .astype(np.float32))


def cone_problem(data, suffix=""):
    from quadruped_tpu_torch.solvers import cone_qp

    t = {k: torch.from_numpy(data[k + suffix])
         for k in ("p", "q", "fz_lo", "fz_hi")}
    return cone_qp.ConeQP(p=t["p"], q=t["q"],
                          mu=torch.full((t["p"].shape[0],), 0.45),
                          fz_lo=t["fz_lo"], fz_hi=t["fz_hi"])


def fleet(in_path, out_path):
    from quadruped_tpu_torch.examples import example_fleet_sweep

    out = example_fleet_sweep.run(int(np.load(in_path)["steps"]),
                                  device="cpu")
    np.savez(out_path, rank=runtime.process_index(), **{
        k: out[k] for k in ("alive", "base_height_trace", "vel_trace",
                            "first", "devices")})
    torch.distributed.destroy_process_group()


def main():
    mode, in_path, out_path = sys.argv[1:4]
    if mode == "fleet":
        return fleet(in_path, out_path)
    assert runtime.initialize_from_env("cpu"), "expected a multi-process env"
    data = np.load(in_path)
    rank = runtime.process_index()
    if mode == "stats":
        from quadruped_tpu_torch.distributed import shard_batch
        from quadruped_tpu_torch.distributed.scaling import \
            sharded_solve_stats
        from quadruped_tpu_torch.robots import a1_params

        mesh = runtime.global_mesh(dp=2, sp=1, device="cpu")
        ops = shard_batch(mesh, tuple(torch.from_numpy(data[k])
                                      for k in ("yaw", "feet", "x0")))
        params = a1_params("cpu")
        fn = sharded_solve_stats(mesh, lambda o: solve_batch(params, *o))
        forces, stat = fn(ops)
        gathered = runtime.all_gather_batch(mesh, forces)
        from quadruped_tpu_torch.solvers import cone_qp

        cone_qp.newton_schulz_inverse = exact_inverse
        forces_exact, _ = fn(ops)
        np.savez(out_path, forces_local=forces.numpy(), stat=float(stat),
                 gathered=gathered.numpy(), rank=rank,
                 forces_exact_local=forces_exact.numpy())
    else:
        from quadruped_tpu_torch.distributed import solve_cone_sp

        mesh = runtime.global_mesh(dp=1, sp=2, device="cpu")
        prob = cone_problem(data)
        cold = solve_cone_sp(mesh, prob, iters=24, alpha=1.6,
                             accel_restart=0)
        accel = solve_cone_sp(mesh, prob, iters=24)
        warm = solve_cone_sp(mesh, cone_problem(data, "_w"), iters=24,
                             x0=torch.from_numpy(data["x_warm"]),
                             y0=torch.from_numpy(data["y_warm"]))
        np.savez(out_path, cold=cold.x.numpy(), accel=accel.x.numpy(),
                 warm=warm.x.numpy(), warm_y=warm.y.numpy(),
                 prim=warm.prim_res.numpy(), rank=rank)
    torch.distributed.destroy_process_group()
    print(f"rank {rank}: wrote {out_path}", flush=True)


if __name__ == "__main__":
    main()
