"""The port's distributed/ on torch.distributed (gloo, CPU) against the JAX
package's distributed/ and against its own unsharded solves.

* World size 1, in this process: the (dp, sp) mesh's shape, its refusal of
  a mesh of another size than the world, the batch rows of each rank,
  `host_local_to_global` / `global_to_host_local` / `all_gather_batch`,
  `sharded_solve_stats` bit for bit the unsharded solve, `solve_cone_sp`
  at sp = 1 at the solve-quality bound of tests/test_solver_sp.py, and
  `entry.dryrun_multichip(1)` bit for bit the same step with no mesh and
  against the JAX `dryrun_multichip` step's forces.
* Two processes (tests/torch_mp_worker.py, gloo, a free port, one thread
  each): (dp=2, sp=1) `sharded_solve_stats` over the 16 scenarios of
  tests/test_distributed.py::make_batch, stitched from both ranks, against
  the port's unsharded solve (the JAX test's 2e-2) and JAX's
  `solve_batch` (NATIVE_FORCE_TOL; with the same exact inverse in both
  packages, the JAX test's 2e-2), the statistic equal on both ranks and
  within 1e-4 of the unsharded mean; (dp=1, sp=2) `solve_cone_sp` on the 8
  problems of tests/test_solver_sp.py against JAX's `solve_cone_sp` on
  its 8-device (dp=4, sp=2) mesh and the port's `cone_qp.solve`, at that
  file's bounds, relaxed, accelerated and warm-started.

Port against JAX: the production Newton-Schulz inverse (one float32
polish after ten bf16 steps) of each package rounds its bf16 steps'
float32 sums in another order, and the ADMM carries the ~1e-4 relative
gap of M^{-1} into the forces. CPU readings, largest |df| over forces up
to 51 N: 0.222 N on make_batch(16), 0.268 N on the dryrun step. Those two
comparisons are held to NATIVE_FORCE_TOL, 0.5 N (about 2x the larger
reading). With both packages' Newton-Schulz inverse replaced by the same
float64 inverse (rounded to float32) the gaps fall to 5.5e-4 N and
1.5e-3 N, and both are held to EXACT_FORCE_TOL, the JAX sharded test's
2e-2.

Every process group started here is destroyed after its test.
"""

import os
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.distributed as dist

from card_device import cuda_device  # noqa: F401
from quadruped_tpu_torch import entry
from quadruped_tpu_torch.distributed import (batch_sharding, make_mesh,
                                             replicated_sharding,
                                             shard_batch, solve_cone_sp)
from quadruped_tpu_torch.distributed import runtime
from quadruped_tpu_torch.distributed.mesh import mesh_shape
from quadruped_tpu_torch.distributed.scaling import (measure_throughput,
                                                     scaling_report,
                                                     sharded_solve_stats)
from quadruped_tpu_torch.robots import a1_params
from quadruped_tpu_torch.solvers import cone_qp
from torch_mp_worker import exact_inverse, solve_batch

torch.set_num_threads(1)

HERE = Path(__file__).parent
NATIVE_FORCE_TOL = 0.5
EXACT_FORCE_TOL = 2e-2


@pytest.fixture(autouse=True)
def no_group_left():
    """Destroy any process group a test started, so none reaches the
    next test on this worker."""
    yield
    if dist.is_initialized():
        dist.destroy_process_group()


def _operands(b=16):
    """tests/test_distributed.py::make_batch(b) as numpy and as tensors."""
    from test_distributed import make_batch

    params, ops = make_batch(b)
    arrays = dict(zip(("yaw", "feet", "x0"), (np.array(a) for a in ops)))
    return params, ops, arrays


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _run_workers(mode: str, inputs: dict, tmp_path) -> list:
    """Two worker processes of torch_mp_worker.py; returns their outputs."""
    src = tmp_path / "in.npz"
    np.savez(src, **inputs)
    outs = [tmp_path / f"out{i}.npz" for i in range(2)]
    port = _free_port()
    procs = []
    for pid in range(2):
        env = dict(os.environ)
        env.update(QTPU_COORDINATOR=f"127.0.0.1:{port}",
                   QTPU_NUM_PROCESSES="2", QTPU_PROCESS_ID=str(pid),
                   OMP_NUM_THREADS="1")
        procs.append(subprocess.Popen(
            [sys.executable, str(HERE / "torch_mp_worker.py"), mode,
             str(src), str(outs[pid])], env=env, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    logs = []
    for p in procs:
        try:
            logs.append(p.communicate(timeout=240)[0])
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
    assert all(p.returncode == 0 for p in procs), "\n".join(logs)
    return [np.load(o) for o in outs]


def test_mesh_shapes_and_refusal():
    mesh = make_mesh(1, device="cpu")
    assert mesh_shape(mesh) == {"dp": 1, "sp": 1}
    assert mesh_shape(make_mesh(device="cpu")) == {"dp": 1, "sp": 1}
    assert mesh_shape(make_mesh(1, dp=1, device="cpu")) == {"dp": 1,
                                                            "sp": 1}
    with pytest.raises(ValueError, match="one rank per device"):
        make_mesh(8, sp=2, device="cpu")
    assert runtime.process_count() == 1 and runtime.process_index() == 0


def test_no_group_and_many_devices_refused():
    assert not dist.is_initialized()
    with pytest.raises(RuntimeError, match="initialize_from_env"):
        make_mesh(2, device="cpu")
    assert not dist.is_initialized()


def test_initialize_from_env_single_process_is_a_noop(monkeypatch):
    for k in ("QTPU_NUM_PROCESSES", "WORLD_SIZE"):
        monkeypatch.delenv(k, raising=False)
    assert runtime.initialize_from_env("cpu") is False
    monkeypatch.setenv("WORLD_SIZE", "1")
    assert runtime.initialize_from_env("cpu") is False
    monkeypatch.setenv("MASTER_ADDR", "10.0.0.2")
    monkeypatch.setenv("MASTER_PORT", "1234")
    monkeypatch.setenv("WORLD_SIZE", "3")
    monkeypatch.setenv("RANK", "2")
    assert runtime._launch_env() == ("10.0.0.2:1234", 3, 2)
    monkeypatch.setenv("QTPU_NUM_PROCESSES", "2")
    monkeypatch.setenv("QTPU_PROCESS_ID", "1")
    monkeypatch.setenv("QTPU_COORDINATOR", "127.0.0.1:5")
    assert runtime._launch_env() == ("127.0.0.1:5", 2, 1)
    assert not dist.is_initialized()


def test_shardings_and_host_local_plumbing():
    mesh = make_mesh(1, device="cpu")
    assert batch_sharding(mesh).rows(16) == slice(0, 16)
    assert replicated_sharding(mesh).rows(16) == slice(0, 16)
    x = torch.arange(48.0).reshape(16, 3)
    tree = {"a": x, "b": (x[:, 0], 7)}
    got = shard_batch(mesh, tree)
    assert torch.equal(got["a"], x) and got["b"][1] == 7
    assert runtime.host_local_to_global(mesh, x) is not None
    assert runtime.global_to_host_local(mesh, x) is x
    assert torch.equal(runtime.all_gather_batch(mesh, x), x)


def test_sharded_solve_stats_equals_unsharded():
    """World size 1: the sharded solve is the unsharded one, bit for bit,
    and the statistic is its mean |f|."""
    _, _, arrays = _operands()
    params = a1_params("cpu")
    ops = tuple(torch.from_numpy(a) for a in arrays.values())
    want = solve_batch(params, *ops)
    mesh = make_mesh(1, device="cpu")
    fn = sharded_solve_stats(mesh, lambda o: solve_batch(params, *o))
    forces, stat = fn(shard_batch(mesh, ops))
    assert torch.equal(forces, want)
    assert torch.equal(stat, want.abs().sum() / want.numel())
    assert measure_throughput(fn, (ops,), reps=1) > 0


def test_scaling_report_one_device():
    _, _, arrays = _operands()
    params = a1_params("cpu")

    def build(batch, mesh):
        ops = tuple(torch.from_numpy(a[:batch]) for a in arrays.values())
        return sharded_solve_stats(
            mesh, lambda o: solve_batch(params, *o)), (shard_batch(mesh, ops),)

    rep = scaling_report(build, 8, 1, reps=1, device="cpu")
    assert rep["scaling_efficiency"] == 1.0
    assert rep["solves_per_s_1dev"] > 0
    with pytest.raises(ValueError, match="one rank per device"):
        scaling_report(build, 8, 2, reps=1, device="cpu")


def test_solve_cone_sp_one_rank_matches_solve():
    """sp = 1: the solve of tests/test_solver_sp.py's problems at its
    quality bound against the port's cone_qp.solve."""
    from test_solver_sp import make_probs

    prob = _port_probs(make_probs(8))
    mesh = make_mesh(1, device="cpu")
    conv = cone_qp.solve(prob, iters=2000)
    ref = cone_qp.solve(prob, iters=24, alpha=1.0, accel_restart=20)
    got = solve_cone_sp(mesh, prob, iters=24)
    err_ref = (ref.x - conv.x).abs().max().item()
    err_got = (got.x - conv.x).abs().max().item()
    assert err_got < err_ref * 1.2 + 0.5, (err_got, err_ref)
    assert (got.x - ref.x).abs().max().item() < 2.0
    assert got.y.shape == ref.y.shape and got.prim_res.shape == (8,)


def _port_probs(jprob):
    b = jprob.p.shape[0]
    t = lambda a: torch.from_numpy(np.array(a, np.float32))
    return cone_qp.ConeQP(p=t(jprob.p), q=t(jprob.q),
                          mu=torch.full((b,), float(jprob.mu)),
                          fz_lo=t(jprob.fz_lo), fz_hi=t(jprob.fz_hi))


def _patch_exact_inverse_jax(monkeypatch):
    """JAX's Newton-Schulz inverse -> torch_mp_worker.exact_inverse's
    float64 inverse (through a host callback)."""
    import jax

    from quadruped_tpu.solvers import cone_qp as jcq

    def inv(m):
        return np.linalg.inv(np.asarray(m, np.float64)).astype(np.float32)

    monkeypatch.setattr(jcq, "newton_schulz_inverse", lambda m, *a, **k:
                        jax.pure_callback(inv, jax.ShapeDtypeStruct(
                            m.shape, m.dtype), m, vmap_method="sequential"))


def test_two_processes_dp2_sharded_stats(tmp_path, monkeypatch):
    import jax

    from test_distributed import solve_batch as jax_solve_batch

    params, ops, arrays = _operands()
    d0, d1 = _run_workers("stats", arrays, tmp_path)
    assert int(d0["rank"]) == 0 and int(d1["rank"]) == 1
    forces = np.concatenate([d0["forces_local"], d1["forces_local"]])
    np.testing.assert_array_equal(d0["gathered"], forces)
    np.testing.assert_array_equal(d1["gathered"], forces)
    port = solve_batch(a1_params("cpu"), *(torch.from_numpy(a)
                                          for a in arrays.values())).numpy()
    np.testing.assert_allclose(forces, port, atol=2e-2)
    expected = np.asarray(jax.jit(lambda o: jax_solve_batch(params, o))(ops))
    np.testing.assert_allclose(forces, expected, atol=NATIVE_FORCE_TOL)
    _patch_exact_inverse_jax(monkeypatch)
    exact = np.concatenate([d0["forces_exact_local"],
                            d1["forces_exact_local"]])
    expected_exact = np.asarray(jax.jit(
        lambda o: jax_solve_batch(params, o))(ops))
    np.testing.assert_allclose(exact, expected_exact, atol=EXACT_FORCE_TOL)
    assert float(d0["stat"]) == float(d1["stat"])
    np.testing.assert_allclose(float(d0["stat"]),
                               float(np.mean(np.abs(port))), rtol=1e-4)


def test_two_processes_sp2_solve_cone_sp(tmp_path):
    """solve_cone_sp at (dp=1, sp=2) against JAX's solve_cone_sp on its
    8-device (dp=4, sp=2) mesh and the port's cone_qp.solve, at the bounds
    of tests/test_solver_sp.py: relaxed and accelerated from a cold start,
    and warm-started."""
    import jax

    from quadruped_tpu.distributed import make_mesh as jax_make_mesh
    from quadruped_tpu.distributed.solver_sp import \
        solve_cone_sp as jax_solve_cone_sp
    from quadruped_tpu.solvers import cone_qp as jcq
    from test_solver_sp import make_probs

    jprob, jprob_w = make_probs(8), make_probs(8, seed=3)
    jcold = jcq.solve(jprob_w, iters=400, alpha=1.6)
    inputs = {k: np.asarray(getattr(jprob, k))
              for k in ("p", "q", "fz_lo", "fz_hi")}
    inputs.update({k + "_w": np.asarray(getattr(jprob_w, k))
                   for k in ("p", "q", "fz_lo", "fz_hi")})
    inputs.update(x_warm=np.asarray(jcold.x), y_warm=np.asarray(jcold.y))
    d0, d1 = _run_workers("sp", inputs, tmp_path)
    for key in ("cold", "accel", "warm", "warm_y", "prim"):
        np.testing.assert_array_equal(d0[key], d1[key], err_msg=key)

    jmesh = jax_make_mesh(8, sp=2)
    prob, prob_w = _port_probs(jprob), _port_probs(jprob_w)
    conv = cone_qp.solve(prob, iters=2000).x.numpy()
    for key, alpha, accel in (("cold", 1.6, 0), ("accel", 1.0, 20)):
        ref = cone_qp.solve(prob, iters=24, alpha=alpha,
                            accel_restart=accel).x.numpy()
        jgot = np.asarray(jax_solve_cone_sp(jmesh, jprob, iters=24,
                                            alpha=alpha,
                                            accel_restart=accel).x)
        err_ref = np.abs(ref - conv).max()
        for got in (d0[key], jgot):
            assert np.abs(got - conv).max() < err_ref * 1.2 + 0.5, key
            assert np.abs(got - ref).max() < 2.0, key
    conv_w = cone_qp.solve(prob_w, iters=2000).x.numpy()
    ref_w = cone_qp.solve(prob_w, iters=24, alpha=1.0, accel_restart=20,
                          x0=torch.from_numpy(np.array(jcold.x)),
                          y0=torch.from_numpy(np.array(jcold.y))).x.numpy()
    jwarm = np.asarray(jax_solve_cone_sp(jmesh, jprob_w, iters=24,
                                         x0=jcold.x, y0=jcold.y).x)
    err_ref = np.abs(ref_w - conv_w).max()
    assert np.abs(d0["warm"] - conv_w).max() < err_ref * 1.2 + 0.5
    np.testing.assert_allclose(d0["warm"], ref_w, atol=1.0)
    np.testing.assert_allclose(d0["warm"], jwarm, atol=1.0)
    jax.block_until_ready(jwarm)


def _jax_dryrun_forces(batch: int) -> np.ndarray:
    """The forces of the JAX `dryrun_multichip` step (its `_build` and
    the body of its `full_step`) on `batch` scenarios, unsharded."""
    import jax
    import jax.numpy as jnp

    import __graft_entry__ as g
    from quadruped_tpu.control.locomotion import locomotion_step
    from quadruped_tpu.control.mpc import MpcConfig
    from quadruped_tpu.gait.scheduler import stance_contact_mask
    from quadruped_tpu.sim import srb_sim

    prod = MpcConfig()
    params, config, sim, _, ctrl, cmd = g._build(
        batch, horizon=prod.horizon, qp_iters=prod.qp_iters,
        cold_iters=prod.qp_cold_iters)

    def one(sim_s, ctrl_s, cm, tt):
        ob = srb_sim.observe(params, sim_s, stance_contact_mask(ctrl_s.gait))
        _, forces, _ = locomotion_step(config, params, ctrl_s, ob, cm, tt)
        return forces

    t = jnp.full((batch,), 0.002, jnp.float32)
    return np.asarray(jax.jit(jax.vmap(one))(sim, ctrl, cmd, t))


def test_dryrun_multichip_one_rank(monkeypatch):
    """dryrun_multichip(1) at the production MpcConfig(): its forces equal
    the same step with no mesh bit for bit, and JAX's within
    NATIVE_FORCE_TOL; with the same exact inverse in both packages, within
    EXACT_FORCE_TOL."""
    monkeypatch.delenv("QTPU_DRYRUN_TINY", raising=False)
    res = entry.dryrun_multichip(1, device="cpu")
    assert res.rows == slice(0, 2) and res.forces.shape == (2, 4, 3)
    cfg = entry.dryrun_config("cpu")
    assert (cfg.mpc.horizon, cfg.mpc.qp_iters, cfg.mpc.qp_cold_iters) == \
        (10, 24, 400)
    params, sim, ctrl, cmd = entry.dryrun_build(cfg, 2, slice(0, 2), "cpu")
    _, _, forces = entry.dryrun_step(cfg, params, sim, ctrl, cmd)
    assert torch.equal(res.forces, forces)
    assert torch.equal(res.stat, forces.abs().sum() / forces.numel())
    np.testing.assert_allclose(res.forces.numpy(), _jax_dryrun_forces(2),
                               atol=NATIVE_FORCE_TOL)
    dist.destroy_process_group()
    _patch_exact_inverse_jax(monkeypatch)
    monkeypatch.setattr(cone_qp, "newton_schulz_inverse", exact_inverse)
    res = entry.dryrun_multichip(1, device="cpu")
    np.testing.assert_allclose(res.forces.numpy(), _jax_dryrun_forces(2),
                               atol=EXACT_FORCE_TOL)


@pytest.mark.cuda
def test_dryrun_multichip_on_the_card(cuda_device):
    """On the card: a one-rank NCCL group, K1 twice (boot and step), the
    forces bit for bit the same step with no mesh."""
    from quadruped_tpu_torch.solvers import fused_admm

    fused_admm.fused_admm.launches = 0
    res = entry.dryrun_multichip(1)
    assert dist.get_backend() == "nccl"
    assert fused_admm.fused_admm.launches == 2
    cfg = entry.dryrun_config(cuda_device)
    params, sim, ctrl, cmd = entry.dryrun_build(cfg, 2, slice(0, 2),
                                                cuda_device)
    _, _, forces = entry.dryrun_step(cfg, params, sim, ctrl, cmd)
    assert torch.equal(res.forces, forces)


@pytest.mark.cuda
def test_sharded_rollout_on_the_card(cuda_device):
    """The twin of the JAX test_sharded_closed_loop_rollout_matches_unsharded
    on a one-rank NCCL group: B=16, 125 ticks, `shard_batch` over the
    mesh, bit for bit the unsharded rollout, K1 at the boot and once a
    solve, every robot alive."""
    from quadruped_tpu_torch.control import mpc as mpc_mod
    from quadruped_tpu_torch.control import swing as swing_mod
    from quadruped_tpu_torch.control.desired_state import TwistCommand
    from quadruped_tpu_torch.control.locomotion import LocomotionConfig
    from quadruped_tpu_torch.gait import ADVANCED_TROT
    from quadruped_tpu_torch.sim.rollout import rollout
    from quadruped_tpu_torch.solvers import fused_admm

    ticks = 125
    config = LocomotionConfig(
        mpc=mpc_mod.MpcConfig(horizon=10, qp_iters=24, qp_cold_iters=120),
        swing=swing_mod.SwingConfig(), gait=ADVANCED_TROT(cuda_device))
    params = a1_params(cuda_device)
    cmds = TwistCommand.constant(
        vx=np.random.default_rng(7).uniform(0.1, 0.5, 16).astype(np.float32),
        device=cuda_device)
    mesh = make_mesh(1, device=cuda_device)
    assert dist.get_backend() == "nccl"
    before = fused_admm.fused_admm.launches
    got = rollout(config, params, shard_batch(mesh, cmds), ticks)
    torch.cuda.synchronize()
    assert fused_admm.fused_admm.launches - before == \
        1 + -(-ticks // config.mpc.ticks_per_solve)
    want = rollout(config, params, cmds, ticks)
    for a, b in ((got.alive, want.alive), (got.sim.position, want.sim.position),
                 (got.forces_trace, want.forces_trace)):
        assert torch.equal(a, b)
    assert got.alive.min().item() == 1.0


@pytest.mark.cuda
def test_solve_cone_sp_one_rank_on_the_card(cuda_device):
    """sp = 1 on a one-rank NCCL group: `solve_cone_sp` on 8 bench problems
    at the solve-quality bound of tests/test_solver_sp.py against
    `cone_qp.solve`; and one `scaling_report` reading at one rank
    (B=1024)."""
    from quadruped_tpu_torch.solvers import problems

    prob, _ = problems.bench_problems(8, 10, device=cuda_device)
    mesh = make_mesh(1, device=cuda_device)
    conv = cone_qp.solve(prob, iters=2000)
    ref = cone_qp.solve(prob, iters=24, alpha=1.0, accel_restart=20)
    got = solve_cone_sp(mesh, prob, iters=24)
    err_ref = (ref.x - conv.x).abs().max().item()
    err_got = (got.x - conv.x).abs().max().item()
    assert err_got < err_ref * 1.2 + 0.5, (err_got, err_ref)
    assert (got.x - ref.x).abs().max().item() < 2.0

    def build(batch, m):
        p, _ = problems.bench_problems(batch, 10, device=cuda_device)
        boot = cone_qp.solve(p, iters=400, alpha=1.6)

        def solve(pp):
            return cone_qp.solve(pp, iters=24, alpha=1.0, accel_restart=20,
                                 x0=boot.x, y0=boot.y).x[:, :12].reshape(
                                     -1, 4, 3)

        return sharded_solve_stats(m, solve), (shard_batch(m, p),)

    rep = scaling_report(build, 1024, 1, reps=20, device=cuda_device)
    assert rep["solves_per_s_1dev"] > 0
