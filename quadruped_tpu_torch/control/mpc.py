"""Convex-MPC stance controller, batched (port of quadruped_tpu/control/mpc.py).

One MPC instance per scenario: `MpcState` tensors carry the leading
scenario axis. A solve builds the SRB model at the current attitude, the
exact ZOH, the condensed cost and the friction-cone QP, and runs
`cone_qp.solve`, whose ADMM loop is the `fused_admm` CUDA kernel on the
card. With `move_block` the tail horizon steps share force variables
(`long_horizon_config`: H=16 at the condensed size of H=10), and the warm
state lives in the reduced space. With stacked parameters (a fleet) each
scenario's QP carries its own robot: mass, inertia, CoM offset, force cap
m*g and friction coefficient reach the cone QP, and so K1, per row.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from quadruped_tpu_torch.control.desired_state import DesiredStateCommand
from quadruped_tpu_torch.control.types import RobotObservation
from quadruped_tpu_torch.core import se3
from quadruped_tpu_torch.dynamics import srb
from quadruped_tpu_torch.gait.scheduler import (GaitConfig, GaitState,
                                                LegState,
                                                predicted_contact_table)
from quadruped_tpu_torch.robots import kinematics
from quadruped_tpu_torch.robots.params import RobotParams, per_scenario
from quadruped_tpu_torch.solvers import condense, cone_qp
from quadruped_tpu_torch.utils import card, tree
from quadruped_tpu_torch.utils.logging import span


@dataclasses.dataclass
class MpcConfig:
    horizon: int = 10
    dt_mpc: float = 0.03
    control_dt: float = 0.002
    # The reference solves every iterations_per_mpc/2 ticks of its 1 kHz
    # loop (15 ms); the cadence here is time-based.
    iterations_per_mpc: int = 30
    qp_iters: int = 24
    qp_accel_restart: int = 20
    qp_alpha: float = 1.0
    qp_cold_iters: int = 400
    qp_cold_alpha: float = 1.6
    qp_rho: float | None = None
    qp_warm_shift: bool = False
    # Move blocking (head, block): `head` individual steps, then groups of
    # `block` sharing one force triple per leg. () disables.
    move_block: tuple = ()
    state_weights: tuple = (10, 10, 5, 40, 60, 100, 0, 0, 0.5, 5, 5, 1, 0.0)
    force_weight: float = 4e-6
    vel_filters: tuple = (0.01, 0.005, 0.03)
    # "cadence" solves every ticks_per_solve ticks inside the tick;
    # "always"/"never" serve the cadence-hoisted rollout.
    solve_mode: str = "cadence"
    boot_solve_ticks: int = 0

    @property
    def ticks_per_solve(self) -> int:
        period_s = (self.iterations_per_mpc / 2) * 0.001
        return max(1, int(round(period_s / self.control_dt)))

    @property
    def n_force_groups(self) -> int:
        if not self.move_block:
            return self.horizon
        return condense.move_block_groups(self.horizon, *self.move_block)[1]


def long_horizon_config(**overrides) -> MpcConfig:
    """The tuned H=16 configuration of the JAX package: move blocking
    (4, 2) (4 single steps + 6 tail pairs = 10 groups, n = 120 as at H=10)
    and force_weight 1e-4 (the H=16 regularizer); everything else at
    MpcConfig defaults."""
    kw = dict(horizon=16, move_block=(4, 2), force_weight=1e-4)
    kw.update(overrides)
    return MpcConfig(**kw)


@dataclasses.dataclass
class MpcState:
    x_vel_des: torch.Tensor        # [B] filtered forward velocity command
    y_vel_des: torch.Tensor        # [B]
    yaw_turn_rate: torch.Tensor    # [B]
    yaw_des: torch.Tensor          # [B] integrated desired yaw
    pos_des_world: torch.Tensor    # [B, 3]
    forces_world: torch.Tensor     # [B, 4, 3] last MPC solution (held)
    warm_primal: torch.Tensor      # [B, 12H]
    warm_dual: torch.Tensor        # [B, 4H, 5]
    warm_pinned: torch.Tensor      # [B, 4H]
    iteration: torch.Tensor        # [B] int32
    first_swing_base: torch.Tensor  # [B, 4]


def mpc_init(config: MpcConfig, batch: int, body_height=0.27,
             device=None) -> MpcState:
    device = card.resolve(device)
    h = config.n_force_groups

    def z(*shape):
        return torch.zeros((batch,) + shape, dtype=torch.float32,
                           device=device)

    pos = z(3)
    pos[:, 2] = torch.as_tensor(body_height, dtype=torch.float32,
                                device=device)
    return MpcState(
        x_vel_des=z(), y_vel_des=z(), yaw_turn_rate=z(), yaw_des=z(),
        pos_des_world=pos, forces_world=z(4, 3), warm_primal=z(12 * h),
        warm_dual=z(4 * h, condense.CONE_ROWS), warm_pinned=z(4 * h),
        iteration=torch.zeros(batch, dtype=torch.int32, device=device),
        first_swing_base=z(4))


def _v_des_world(state: MpcState, r: torch.Tensor) -> torch.Tensor:
    v_body = torch.stack([state.x_vel_des, state.y_vel_des,
                          torch.zeros_like(state.x_vel_des)], -1)
    return torch.einsum("bij,bj->bi", r, v_body)


def setup_command(config: MpcConfig, state: MpcState, obs: RobotObservation,
                  des: DesiredStateCommand) -> MpcState:
    """Velocity filtering + desired-yaw integration (SetupCommand)."""
    fx, fy, fw = config.vel_filters
    x_vel = torch.clamp(state.x_vel_des * (1 - fx) + des.velocity[:, 0] * fx,
                        -1.0, 2.0)
    y_vel = torch.clamp(state.y_vel_des * (1 - fy) + des.velocity[:, 1] * fy,
                        -0.6, 0.6)
    wz = state.yaw_turn_rate * (1 - fw) + des.omega[:, 2] * fw
    yaw_des = se3.wrap_angle(state.yaw_des + config.control_dt * wz)
    yaw_cur = obs.base_rpy[:, 2]
    yaw_des = torch.where((yaw_cur > math.pi / 2) & (yaw_des < 0),
                          yaw_des + 2 * math.pi, yaw_des)
    yaw_des = torch.where((yaw_cur < -math.pi / 2) & (yaw_des > 0),
                          yaw_des - 2 * math.pi, yaw_des)
    return dataclasses.replace(state, x_vel_des=x_vel, y_vel_des=y_vel,
                               yaw_turn_rate=wz, yaw_des=yaw_des)


def _desired_trajectory(config: MpcConfig, state: MpcState,
                        obs: RobotObservation, des: DesiredStateCommand,
                        rpy_comp: torch.Tensor, body_height: torch.Tensor,
                        v_preview: torch.Tensor | None = None,
                        z_preview: torch.Tensor | None = None):
    """[B, H, 13] integrated command trajectory.

    v_preview: optional [B, H] body-frame forward velocity per horizon
    step; z_preview: optional [B, H] desired base height per step.
    """
    h = config.horizon
    r = obs.rot_body_to_world
    b = r.shape[0]
    v_des_world = _v_des_world(state, r)
    start_xy = torch.clamp(state.pos_des_world[:, :2],
                           obs.base_position[:, :2] - 0.1,
                           obs.base_position[:, :2] + 0.1)
    k = torch.arange(h, dtype=torch.float32, device=r.device)[:, None]
    zeros = torch.zeros(b, 2, dtype=torch.float32, device=r.device)
    base = torch.cat([
        rpy_comp[:, :2], state.yaw_des[:, None], start_xy,
        body_height[:, None], zeros, state.yaw_turn_rate[:, None],
        v_des_world[:, :2], zeros[:, :1],
        torch.full((b, 1), srb.GRAVITY, dtype=torch.float32, device=r.device),
    ], dim=-1)
    drift = torch.zeros(b, 13, dtype=torch.float32, device=r.device)
    drift[:, 2] = state.yaw_turn_rate
    drift[:, 3] = v_des_world[:, 0]
    drift[:, 4] = v_des_world[:, 1]
    traj = base[:, None, :] + k * config.dt_mpc * drift[:, None, :]
    if v_preview is not None:
        v_body = torch.stack(
            [v_preview, state.y_vel_des[:, None].expand_as(v_preview),
             torch.zeros_like(v_preview)], dim=-1)            # [B, H, 3]
        v_w = torch.einsum("bij,bhj->bhi", r, v_body)
        csum = torch.cumsum(v_w[..., :2], dim=1)
        traj[:, :, 3:5] = start_xy[:, None, :] \
            + config.dt_mpc * (csum - v_w[..., :2])
        traj[:, :, 9:11] = v_w[..., :2]
    if z_preview is not None:
        vz = torch.diff(z_preview, dim=-1,
                        append=z_preview[:, -1:]) / config.dt_mpc
        traj[:, :, 5] = z_preview
        traj[:, :, 11] = vz
    return traj


def gravity_warm_start(params: RobotParams,
                       contact_table: torch.Tensor) -> torch.Tensor:
    """Primal start for cold solves: body weight split evenly among each
    horizon step's contact legs (fz only). [B, H, 4] -> [B, 12H]."""
    n_c = torch.sum(contact_table, dim=-1, keepdim=True)
    mass = per_scenario(params, params.total_mass, contact_table.ndim)
    fz = contact_table * mass * 9.81 / torch.clamp(n_c, min=1.0)
    x0 = torch.zeros(contact_table.shape + (3,), dtype=torch.float32,
                     device=contact_table.device)
    x0[..., 2] = fz
    return x0.reshape(x0.shape[:-3] + (-1,))


def mpc_problem(config: MpcConfig, params: RobotParams, state: MpcState,
                obs: RobotObservation, des: DesiredStateCommand,
                contact_table: torch.Tensor, rpy_comp: torch.Tensor,
                body_height: torch.Tensor,
                v_preview: torch.Tensor | None = None,
                z_preview: torch.Tensor | None = None):
    """The cone QP of one MPC update for every scenario. Returns (state
    with its desired position re-anchored, ConeQP, pinned force triples
    [B, 4G] as 0/1)."""
    with span("qtpu.mpc.build"):
        h = config.horizon
        r_mat = obs.rot_body_to_world
        b = r_mat.shape[0]
        foot_base = kinematics.foot_positions_in_base_frame(params,
                                                            obs.joint_angles)
        r_feet = torch.einsum(
            "bij,blj->bli", r_mat,
            foot_base - per_scenario(params, params.com_offset, 3))

        # Re-anchor the stored desired position to +/-0.1 m of the actual.
        start_xy = torch.clamp(state.pos_des_world[:, :2],
                               obs.base_position[:, :2] - 0.1,
                               obs.base_position[:, :2] + 0.1)
        state = dataclasses.replace(state, pos_des_world=torch.cat(
            [start_xy, state.pos_des_world[:, 2:]], dim=-1))

        x0 = srb.srb_initial_state(obs.base_rpy, obs.base_position,
                                   obs.base_omega_world, obs.base_vel_world)
        x_des = _desired_trajectory(config, state, obs, des, rpy_comp,
                                    body_height, v_preview, z_preview)
        a_ct, b_ct = srb.srb_continuous(r_mat, params.total_inertia,
                                        params.total_mass, r_feet)
        ad, bd = srb.srb_discretize(a_ct, b_ct, config.dt_mpc)
        weights = torch.as_tensor(config.state_weights, dtype=torch.float32,
                                  device=r_mat.device)
        p_cost, q_cost = condense.condense_cost_structured(
            a_ct, bd, ad, x0, x_des, weights, config.force_weight, h,
            config.dt_mpc)
        fz_hi = (contact_table * per_scenario(params, params.max_force, 3)
                 ).reshape(b, h * 4)
        if config.move_block:
            groups, n_g = condense.move_block_groups(h, *config.move_block)
            p_cost, q_cost, fz_hi = condense.reduce_move_blocking(
                p_cost, q_cost, fz_hi, groups, n_g, h)
        prob = cone_qp.ConeQP(p=p_cost, q=q_cost,
                              mu=params.friction_coef.expand(b),
                              fz_lo=torch.zeros_like(fz_hi), fz_hi=fz_hi)
        return state, prob, (fz_hi < 1e-6).float()


def mpc_solve(config: MpcConfig, params: RobotParams, state: MpcState,
              obs: RobotObservation, des: DesiredStateCommand,
              contact_table: torch.Tensor, rpy_comp: torch.Tensor,
              body_height: torch.Tensor, *, iters: int | None = None,
              x0_warm: torch.Tensor | None = None,
              y0_warm: torch.Tensor | None = None,
              alpha: float | None = None, accel_restart: int | None = None,
              v_preview: torch.Tensor | None = None,
              z_preview: torch.Tensor | None = None) -> MpcState:
    """One full MPC problem build + solve for every scenario."""
    with span("qtpu.mpc.solve"):
        state, prob, pin_new = mpc_problem(
            config, params, state, obs, des, contact_table, rpy_comp,
            body_height, v_preview, z_preview)
        b = prob.q.shape[0]
        rho = cone_qp.RHO_CONE
        if config.qp_rho is not None and x0_warm is None:
            rho = config.qp_rho
        x0 = state.warm_primal if x0_warm is None else x0_warm
        y0 = state.warm_dual if y0_warm is None else y0_warm
        if config.qp_warm_shift and not config.move_block \
                and x0_warm is None:
            # Flip-aware warm start on the per-tick path (the cold boot
            # passes its own gravity-split start).
            x0, y0 = cone_qp.shift_warm_start(x0, y0, state.warm_pinned,
                                              pin_new)
        sol = cone_qp.solve(
            prob, iters=config.qp_iters if iters is None else iters, rho=rho,
            x0=x0, y0=y0, alpha=config.qp_alpha if alpha is None else alpha,
            accel_restart=(config.qp_accel_restart if accel_restart is None
                           else accel_restart))
        # First-step forces, world frame: the first step is its own group.
        forces = sol.x[:, :12].reshape(b, 4, 3)
        return dataclasses.replace(state, forces_world=forces,
                                   warm_primal=sol.x, warm_dual=sol.y,
                                   warm_pinned=pin_new)


def _contact_table(config: MpcConfig, gait_config: GaitConfig,
                   gait_state: GaitState):
    """[B, H, 4] predicted contact table with row 0 pinned to the measured
    contact. Returns (table, stance_now [B, 4])."""
    table = predicted_contact_table(gait_config, gait_state, config.dt_mpc,
                                    config.horizon)
    early = gait_state.leg_state == LegState.EARLY_CONTACT
    table = torch.maximum(table, early.to(table.dtype)[:, None, :])
    stance_now = (gait_state.leg_state == LegState.STANCE) | early
    table[:, 0] = stance_now.to(table.dtype)
    return table, stance_now


def _cold_start_inputs(config: MpcConfig, params: RobotParams,
                       gait_config: GaitConfig, gait_state: GaitState,
                       state: MpcState, obs: RobotObservation,
                       des: DesiredStateCommand):
    """(state, contact table, rpy_comp, body height, gravity-split primal
    start) of the boot solve."""
    state = setup_command(config, state, obs, des)
    body_height = des.position[:, 2]
    rpy_comp = torch.zeros(body_height.shape[0], 2, dtype=torch.float32,
                           device=body_height.device)
    table, _ = _contact_table(config, gait_config, gait_state)
    grav_table = table
    if config.move_block:
        # The warm state lives in the blocked space: split gravity over the
        # per-group contact table, the minimum over the steps each group
        # covers (as reduce_move_blocking bounds fz).
        grav_table = condense.group_min(
            table, *condense.move_block_groups(config.horizon,
                                               *config.move_block))
    return (state, table, rpy_comp, body_height,
            gravity_warm_start(params, grav_table))


def cold_start_problem(config: MpcConfig, params: RobotParams,
                       gait_config: GaitConfig, gait_state: GaitState,
                       state: MpcState, obs: RobotObservation,
                       des: DesiredStateCommand):
    """(ConeQP, primal start) of the boot solve, as `mpc_cold_start` hands
    them to `cone_qp.solve` with a zero dual start, config.qp_cold_iters
    relaxed iterations at alpha config.qp_cold_alpha and no restart."""
    state, table, rpy_comp, body_height, x0 = _cold_start_inputs(
        config, params, gait_config, gait_state, state, obs, des)
    _, prob, _ = mpc_problem(config, params, state, obs, des, table,
                             rpy_comp, body_height)
    return prob, x0


def mpc_cold_start(config: MpcConfig, params: RobotParams,
                   gait_config: GaitConfig, gait_state: GaitState,
                   state: MpcState, obs: RobotObservation,
                   des: DesiredStateCommand) -> MpcState:
    """One high-budget relaxed boot solve seeding the warm-start state."""
    state, table, rpy_comp, body_height, x0 = _cold_start_inputs(
        config, params, gait_config, gait_state, state, obs, des)
    return mpc_solve(config, params, state, obs, des, table, rpy_comp,
                     body_height, iters=config.qp_cold_iters, x0_warm=x0,
                     y0_warm=torch.zeros_like(state.warm_dual),
                     alpha=config.qp_cold_alpha, accel_restart=0)


def height_and_pitch_compensation(gait_state: GaitState,
                                  des: DesiredStateCommand, body_height):
    """Swing-phase body height / backward-walk pitch compensation."""
    swinging = gait_state.desired_leg_state == LegState.SWING
    lobe = torch.sin(gait_state.normalized_phase * math.pi) * swinging
    peak = torch.amax(lobe, dim=-1)
    height = body_height + 0.02 * peak
    pitch_comp = torch.where(des.velocity[:, 0] < -0.01, -0.1 * peak,
                             torch.zeros_like(peak))
    return height, pitch_comp


def solve_mask(config: MpcConfig, state: MpcState) -> torch.Tensor:
    """[B] bool: the scenarios that solve on this tick."""
    if config.solve_mode == "always":
        return torch.ones_like(state.iteration, dtype=torch.bool)
    if config.solve_mode == "never":
        return torch.zeros_like(state.iteration, dtype=torch.bool)
    return ((state.iteration % config.ticks_per_solve == 0)
            | (state.iteration < config.boot_solve_ticks))


def mpc_step(config: MpcConfig, params: RobotParams,
             gait_config: GaitConfig, gait_state: GaitState,
             state: MpcState, obs: RobotObservation,
             des: DesiredStateCommand,
             foot_targets_world: torch.Tensor | None = None,
             v_preview: torch.Tensor | None = None,
             z_preview: torch.Tensor | None = None,
             any_solve: bool | None = None):
    """One control tick of the MPC stance controller.

    Returns (stance torques [B, 12], forces_world [B, 4, 3],
    solved [B] bool, new state). In "cadence" mode the scenarios whose
    cadence falls on this tick solve: the batch is solved once if any does
    and the new state is selected per scenario, as `lax.cond` under
    `vmap` does in the JAX package. Whether any does is one host check of
    `solve_mask`, or `any_solve` when the caller made that check.
    """
    with span("qtpu.ctrl.mpc"):
        state = setup_command(config, state, obs, des)
        body_height, pitch_comp = height_and_pitch_compensation(
            gait_state, des, des.position[:, 2])
        rpy_comp = torch.stack([torch.zeros_like(pitch_comp), pitch_comp], -1)

        r = obs.rot_body_to_world
        v_des_world = _v_des_world(state, r)
        v_des_world[:, 2] = 0.0
        pos_des = state.pos_des_world + config.control_dt * v_des_world
        z_blend = 0.99 * (body_height
                          + (body_height - obs.base_position[:, 2])) \
            + 0.01 * state.pos_des_world[:, 2]
        pos_des[:, 2] = z_blend

        any_first_swing = torch.amax(gait_state.first_swing, dim=-1) > 0.5
        base_planar = torch.stack([obs.base_position[:, 0],
                                   obs.base_position[:, 1],
                                   obs.base_vel_world[:, 0],
                                   obs.base_vel_world[:, 1]], -1)
        first_swing_base = torch.where(any_first_swing[:, None], base_planar,
                                       state.first_swing_base)

        if foot_targets_world is not None:
            # CoM destination: mean of planned footholds (swing legs) and
            # current feet (stance legs), interpolated by the front legs'
            # phase.
            foot_base = kinematics.foot_positions_in_base_frame(
                params, obs.joint_angles)
            foot_world = torch.einsum("bij,blj->bli", r, foot_base) \
                + obs.base_position[:, None, :]
            in_contact = (gait_state.leg_state != LegState.SWING)[:, :, None]
            com_dest = torch.mean(torch.where(in_contact, foot_world,
                                              foot_targets_world), dim=1)
            duty = gait_config.duty_factor[..., 0]
            p0 = gait_state.phase_in_full_cycle[:, 0]
            p1 = gait_state.phase_in_full_cycle[:, 1]
            leg0_sw = gait_state.desired_leg_state[:, 0] == LegState.SWING
            leg1_sw = gait_state.desired_leg_state[:, 1] == LegState.SWING
            t_par = torch.where(
                leg0_sw, p0 - duty,
                torch.where(leg1_sw, p1 - duty,
                            torch.where(p0 < p1, p0 + (1 - duty),
                                        p1 + (1 - duty))))
            t_par = torch.clamp(t_par * 2.0, 0.0, 1.0)[:, None]
            pos_des[:, :2] = (1 - t_par) * first_swing_base[:, :2] \
                + t_par * com_dest[:, :2]

        state = dataclasses.replace(state, pos_des_world=pos_des,
                                    first_swing_base=first_swing_base)
        table, stance_now = _contact_table(config, gait_config, gait_state)

        def do_solve(s):
            return mpc_solve(config, params, s, obs, des, table, rpy_comp,
                             body_height, v_preview=v_preview,
                             z_preview=z_preview)

        should_solve = solve_mask(config, state)
        if config.solve_mode == "always":
            state = do_solve(state)
        elif config.solve_mode == "cadence":
            if any_solve is None:
                with span("qtpu.sync.solve_gate"):
                    any_solve = bool(should_solve.any())
            if any_solve:
                state = tree.where(should_solve, do_solve(state), state)

        # tau = -J^T R^T f per stance leg.
        f_body = torch.einsum("bji,blj->bli", r, state.forces_world)
        tau = kinematics.map_contact_forces_to_torques(
            params, obs.joint_angles, -f_body)
        limit = per_scenario(params, params.torque_limit, 2)
        tau = torch.clamp(tau, -limit, limit)
        tau = tau * torch.repeat_interleave(stance_now.to(tau.dtype), 3,
                                            dim=-1)
        state = dataclasses.replace(state, iteration=state.iteration + 1)
        return tau, state.forces_world, should_solve, state
