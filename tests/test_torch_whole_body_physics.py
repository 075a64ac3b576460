"""The twins of the JAX package's physical checks of the whole-body model
and simulator, run on the port (CPU): tests/test_floating_base.py,
test_whole_body_sim.py, test_whole_body_contact.py (without the 1000-tick
cross-simulator trot, which tests/test_torch_loops_whole_body.py runs on
the card) and
test_whole_body_batch.py, with the JAX tests' own limits. The sim checks
share one batched run of 11 scenarios, each with its own start height,
command gains, contact damping (a per-scenario ContactModel) and terrain
pitch (a per-scenario slope); each check reads its scenario over the ticks
its JAX twin runs. Imports no JAX.
"""

import dataclasses
import functools

import numpy as np
import torch

from quadruped_tpu_torch.control.types import HybridCommand
from quadruped_tpu_torch.core import se3
from quadruped_tpu_torch.dynamics import floating_base as fb
from quadruped_tpu_torch.robots import a1_params, kinematics
from quadruped_tpu_torch.sim import terrain
from quadruped_tpu_torch.sim import whole_body as wb

DT = 0.002


def _rand_single(seed, zero_vel=False):
    """One random floating-base state, drawn as the JAX checks draw it."""
    rng = np.random.default_rng(seed)
    rpy = torch.as_tensor(rng.uniform(-0.3, 0.3, 3), dtype=torch.float32)
    q = np.concatenate([rng.uniform([-0.4, 0.3, -2.0], [0.4, 1.1, -0.9])
                        for _ in range(4)])
    dq = np.zeros(12) if zero_vel else rng.normal(size=12) * 2.0
    w = np.zeros(3) if zero_vel else rng.normal(size=3) * 0.5
    v = np.zeros(3) if zero_vel else rng.normal(size=3) * 0.5
    pos = rng.normal(size=3) * 0.1 + [0, 0, 0.3]

    def t(x):
        return torch.as_tensor(np.asarray(x, np.float32))[None]

    return fb.FbState(quat=se3.rpy_to_quat(rpy)[None], position=t(pos),
                      omega_body=t(w), vel_body=t(v), q=t(q), dq=t(dq))


def _body_coms_world(model, state):
    """[B, 13, 3] CoM of each body in world, and [13] masses."""
    rots, poss = fb.world_rotations_positions(model, state)
    masses = model.inertias[:, 5, 5]
    blk = model.inertias[:, 0:3, 3:6]
    mcom = torch.stack([blk[:, 2, 1], blk[:, 0, 2], blk[:, 1, 0]], dim=-1)
    coms = [poss[i] + torch.einsum("bij,j->bi", rots[i], mcom[i] / masses[i])
            for i in range(fb.NUM_BODIES)]
    return torch.stack(coms, dim=1), masses


def _potential(model, state):
    coms, masses = _body_coms_world(model, state)
    return torch.sum(masses * 9.81 * coms[..., 2], dim=-1)


def test_mass_matrix_spd_and_total_mass():
    params = a1_params("cpu")
    model = fb.build_model(params)
    h = fb.mass_matrix(model, _rand_single(0).q)[0].double().numpy()
    np.testing.assert_allclose(h, h.T, atol=1e-4)
    assert np.linalg.eigvalsh(h).min() > 0
    total = float(params.body_mass + 4 * params.links_mass.sum())
    np.testing.assert_allclose(h[3:6, 3:6], np.eye(3) * total, atol=1e-4)


def test_gravity_matches_potential_gradient():
    """G(q) equals the gradient of the potential energy in the joint
    coordinates (autograd), and -m_total R^T g on the base linear rows."""
    params = a1_params("cpu")
    model = fb.build_model(params)
    state = _rand_single(1, zero_vel=True)
    g = fb.gravity_force(model, state)[0]
    q = state.q.clone().requires_grad_(True)
    (dv,) = torch.autograd.grad(_potential(
        model, dataclasses.replace(state, q=q)).sum(), q)
    np.testing.assert_allclose(g[6:].numpy(), dv[0].numpy(), atol=2e-3)
    r = se3.quat_to_rotmat(state.quat)[0]
    total = float(params.body_mass + 4 * params.links_mass.sum())
    expect = -(r.T @ torch.tensor([0.0, 0.0, -9.81])) * total
    np.testing.assert_allclose(g[3:6].numpy(), expect.numpy(), atol=2e-3)


def test_contact_jacobian_finite_difference():
    model = fb.build_model(a1_params("cpu"))
    state = _rand_single(2, zero_vel=True)
    jc, _, p_feet = fb.contact_jacobians(model, state)
    eps = 1e-4
    for ji in [0, 4, 8, 11]:
        dq = torch.zeros(1, 12)
        dq[0, ji] = eps
        p2 = fb.foot_positions_world(model, dataclasses.replace(
            state, q=state.q + dq))
        np.testing.assert_allclose(jc[0, :, :, 6 + ji].numpy(),
                                   ((p2 - p_feet) / eps)[0].numpy(),
                                   atol=1e-2)
    r = se3.quat_to_rotmat(state.quat)[0]
    np.testing.assert_allclose(jc[0, :, :, 3:6].numpy(),
                               r.expand(4, 3, 3).numpy(), atol=1e-5)
    for ax in range(3):
        wb_axis = torch.zeros(3)
        wb_axis[ax] = 1.0
        for leg in range(4):
            r_b = r.T @ (p_feet[0, leg] - state.position[0])
            expect = r @ torch.linalg.cross(wb_axis, r_b)
            np.testing.assert_allclose(jc[0, leg, :, ax].numpy(),
                                       expect.numpy(), atol=1e-4)


def test_forward_inverse_dynamics_roundtrip():
    model = fb.build_model(a1_params("cpu"))
    state = _rand_single(3)
    qdd = torch.as_tensor(np.random.default_rng(4).normal(size=(1, 18)),
                          dtype=torch.float32)
    tau = fb.inverse_dynamics(model, state, qdd)
    np.testing.assert_allclose(fb.forward_dynamics(model, state, tau).numpy(),
                               qdd.numpy(), atol=5e-3)


def test_coriolis_zero_at_rest():
    model = fb.build_model(a1_params("cpu"))
    c = fb.coriolis_force(model, _rand_single(5, zero_vel=True))
    np.testing.assert_allclose(c.numpy(), 0.0, atol=1e-5)


def test_foot_positions_match_analytic_kinematics():
    """Within the 4 mm lateral offset of the contact point."""
    params = a1_params("cpu")
    model = fb.build_model(params)
    state = _rand_single(6, zero_vel=True)
    p_fb = fb.foot_positions_world(model, state)
    p_base = kinematics.foot_positions_in_base_frame(params, state.q)
    r = se3.quat_to_rotmat(state.quat)
    p_world = state.position[:, None, :] + torch.einsum("bij,blj->bli", r,
                                                        p_base)
    np.testing.assert_allclose(p_fb.numpy(), p_world.numpy(), atol=6e-3)


def test_energy_conservation_free_fall():
    """The unactuated model under gravity keeps its energy over 100 steps
    of 0.5 ms."""
    model = fb.build_model(a1_params("cpu"))
    state = _rand_single(7)
    dt = 5e-4

    def energy(st):
        h = fb.mass_matrix(model, st.q)
        vgen = torch.cat([st.omega_body, st.vel_body, st.dq], dim=-1)
        ke = 0.5 * torch.einsum("bi,bij,bj->b", vgen, h, vgen)
        return float(ke + _potential(model, st))

    e0 = energy(state)
    for _ in range(100):
        qdd = fb.forward_dynamics(model, state, torch.zeros(1, 18))
        r = se3.quat_to_rotmat(state.quat)
        state = fb.FbState(
            quat=se3.quat_integrate(state.quat, state.omega_body, dt),
            position=state.position + torch.einsum(
                "bij,bj->bi", r, state.vel_body) * dt,
            omega_body=state.omega_body + qdd[:, 0:3] * dt,
            vel_body=state.vel_body + qdd[:, 3:6] * dt,
            q=state.q + state.dq * dt, dq=state.dq + qdd[:, 6:] * dt)
    assert abs(energy(state) - e0) < 0.05 * abs(e0) + 0.5


# The sim checks' scenarios, run together: (start height, command kp, kd,
# contact damping alpha, slope pitch, initial body rate).
SIM_SCENARIOS = {
    "stand": (None, 100.0, 2.0, 0.5, 0.0, None),
    "free_fall": (1.0, 100.0, 2.0, 0.5, 0.0, None),
    "slope": (None, 100.0, 2.0, 0.5, 0.15, None),
    "airborne": (2.0, 0.0, 0.0, 0.5, 0.0, (0.5, -0.3, 0.8)),
    "batch_0.30": (0.30, 100.0, 2.0, 0.5, 0.0, None),
    "batch_0.32": (0.32, 100.0, 2.0, 0.5, 0.0, None),
    "batch_0.34": (0.34, 100.0, 2.0, 0.5, 0.0, None),
    "batch_0.36": (0.36, 100.0, 2.0, 0.5, 0.0, None),
    "drop_0.5": ("drop", 120.0, 3.0, 0.5, 0.0, None),
    "drop_0.2": ("drop", 120.0, 3.0, 0.2, 0.0, None),
    "drop_0.9": ("drop", 120.0, 3.0, 0.9, 0.0, None),
}
SIM_TICKS = 1000


@functools.lru_cache(maxsize=None)
def _sim_run():
    """(heights [S, T], flags [S, T, 4], states at ticks 100 and T, the
    model and params) of SIM_SCENARIOS, one batch."""
    params = a1_params("cpu")
    model = fb.build_model(params)
    names = list(SIM_SCENARIOS)
    n = len(names)
    stand_h = float(params.body_height)
    heights = [stand_h if v[0] is None else stand_h + 0.05 if v[0] == "drop"
               else v[0] for v in SIM_SCENARIOS.values()]
    sim = wb.whole_body_init(params, n, body_height=torch.as_tensor(heights))
    omega = torch.zeros(n, 3)
    for i, v in enumerate(SIM_SCENARIOS.values()):
        if v[5] is not None:
            omega[i] = torch.as_tensor(v[5])
    sim = dataclasses.replace(sim, fb=dataclasses.replace(sim.fb,
                                                         omega_body=omega))
    col = {k: torch.as_tensor([v[i] for v in SIM_SCENARIOS.values()],
                              dtype=torch.float32)[:, None].expand(n, 12)
           for k, i in (("kp", 1), ("kd", 2))}
    q_cmd = torch.where(col["kp"] > 0, params.stand_angles.expand(n, 12),
                        torch.zeros(n, 12))
    command = HybridCommand(q=q_cmd, kp=col["kp"], dq=torch.zeros(n, 12),
                            kd=col["kd"], tau=torch.zeros(n, 12))
    contact = wb.ContactModel(hc_alpha=torch.as_tensor(
        [v[3] for v in SIM_SCENARIOS.values()]))
    ground = terrain.slope(pitch=torch.as_tensor(
        [v[4] for v in SIM_SCENARIOS.values()]))
    hs, flags, snapshots = [], [], {0: sim}
    for tick in range(1, SIM_TICKS + 1):
        sim, fl = wb.whole_body_step(params, model, sim, command, contact, DT,
                                     terrain_height=ground)
        hs.append(sim.fb.position[:, 2])
        flags.append(fl)
        if tick == 100:
            snapshots[100] = sim
    idx = {name: i for i, name in enumerate(names)}
    return (idx, torch.stack(hs, 1).numpy(), torch.stack(flags, 1).numpy(),
            snapshots, model)


def test_stand_settles():
    idx, h, flags, _, _ = _sim_run()
    i = idx["stand"]
    h, fl = h[i, :500], flags[i, :500]
    assert np.all(np.isfinite(h))
    assert 0.2 < h[-1] < 0.32
    assert abs(h[-1] - h[-100]) < 0.01
    assert np.all(fl[-1] == 1.0)


def test_free_fall_without_contact():
    idx, h, _, _, _ = _sim_run()
    drop = 1.0 - float(h[idx["free_fall"], 49])
    assert 0.03 < drop < 0.07


def test_slope_contact():
    idx, h, flags, _, _ = _sim_run()
    i = idx["slope"]
    h, fl = h[i, :800], flags[i, :800]
    assert np.all(np.isfinite(h))
    assert fl[-1].sum() >= 2
    assert 0.1 < h[-1] < 0.4
    assert abs(h[-1] - h[-100]) < 0.02


def test_momentum_conservation_airborne():
    """Angular momentum about the total CoM holds over 100 ticks of
    flight."""
    idx, _, _, snaps, model = _sim_run()
    i = idx["airborne"]

    def momentum(sim):
        s = sim.fb
        h = fb.mass_matrix(model, s.q[i:i + 1])
        vgen = torch.cat([s.omega_body, s.vel_body, s.dq], dim=-1)[i:i + 1]
        p6 = torch.einsum("bij,bj->bi", h[:, 0:6], vgen)
        rot = se3.quat_to_rotmat(s.quat[i:i + 1])
        l_o = torch.einsum("bij,bj->bi", rot, p6[:, 0:3])
        p_lin = torch.einsum("bij,bj->bi", rot, p6[:, 3:6])
        one = fb.FbState(**{f.name: getattr(s, f.name)[i:i + 1]
                            for f in dataclasses.fields(s)})
        coms, masses = _body_coms_world(model, one)
        c_world = torch.sum(masses[:, None] * coms[0], 0) / masses.sum()
        return (l_o - torch.linalg.cross(c_world - one.position, p_lin))[0]

    np.testing.assert_allclose(momentum(snaps[100]).numpy(),
                               momentum(snaps[0]).numpy(), rtol=0.1,
                               atol=0.05)


def test_batched_whole_body_settle():
    idx, h, _, _, _ = _sim_run()
    rows = h[[idx[f"batch_{x:.2f}"] for x in (0.30, 0.32, 0.34, 0.36)], :400]
    assert np.all(np.isfinite(rows))
    assert np.all(rows[:, -1] > 0.2) and np.all(rows[:, -1] < 0.33)
    assert np.all(np.abs(rows[:, -1] - rows[:, -50]) < 0.01)


def test_drop_dissipates_energy():
    idx, h_all, flags_all, _, _ = _sim_run()
    i = idx["drop_0.5"]
    h, flags = h_all[i], flags_all[i]
    assert np.isfinite(h).all()
    touchdown = int(np.argmax(flags.sum(axis=1) > 0))
    assert touchdown > 0
    assert h[touchdown:].max() < h[0] + 1e-4
    assert np.abs(h[-1] - h[-200]) < 2e-3
    assert 0.2 < h[-1] < 0.32
    apex_after = h[touchdown:touchdown + 400].max()
    assert apex_after < h[0] - 0.5 * (h[0] - h[touchdown])


def test_more_damping_settles_faster():
    idx, h, flags, _, _ = _sim_run()
    osc = {}
    for alpha in ("0.2", "0.9"):
        i = idx[f"drop_{alpha}"]
        td = int(np.argmax(flags[i].sum(axis=1) > 0))
        osc[alpha] = np.ptp(h[i, td:td + 300])
    assert osc["0.9"] < osc["0.2"], osc
