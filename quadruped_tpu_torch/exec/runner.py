"""Robot runner: the composition root of one control tick (port of
quadruped_tpu/exec/runner.py).

estimators -> desired-state command -> FSM -> locomotion controller ->
safe hybrid command, batched. The stand-up the reference runs as a
blocking loop at boot is the FSM's STAND_UP state. Two observation paths:
`use_estimators=False` feeds the simulator's ground truth to the
controllers, `True` runs raw sensors through the estimation container
first.

Outside LOCOMOTION the locomotion state is held at its value (as in the
JAX runner, a field-wise select of the new state where the scenario is in
LOCOMOTION after the tick). The JAX runner still runs the locomotion step
on every tick, and since the held MPC iteration stays 0, every STAND_UP
tick solves the MPC and throws the result away. With
`skip_idle_locomotion` (the default) the port skips the locomotion step
on a tick where no scenario is in LOCOMOTION before the FSM's transitions
or after them: the transitions do not depend on the locomotion command,
so the outputs are the same values (tests/test_torch_runner.py holds
them equal across the STAND_UP -> LOCOMOTION switch) and the ramp runs no
MPC solve.
"""

from __future__ import annotations

import dataclasses

import torch

from quadruped_tpu_torch.control import fsm as fsm_mod
from quadruped_tpu_torch.control.desired_state import TwistCommand
from quadruped_tpu_torch.control.locomotion import (LocomotionConfig,
                                                    LocomotionState,
                                                    locomotion_init,
                                                    locomotion_step)
from quadruped_tpu_torch.control.types import RobotObservation
from quadruped_tpu_torch.dynamics.floating_base import FloatingBaseModel
from quadruped_tpu_torch.estimation.container import (EstimatorConfig,
                                                      EstimatorState,
                                                      RawSensors,
                                                      estimator_init,
                                                      estimator_update)
from quadruped_tpu_torch.gait.scheduler import stance_contact_mask
from quadruped_tpu_torch.robots.params import RobotParams
from quadruped_tpu_torch.utils import tree


@dataclasses.dataclass
class RunnerConfig:
    locomotion: LocomotionConfig
    estimator: EstimatorConfig | None = None
    use_estimators: bool = False
    control_dt: float = 0.002
    skip_idle_locomotion: bool = True


@dataclasses.dataclass
class RunnerState:
    fsm: fsm_mod.ControlFsmState
    locomotion: LocomotionState
    estimator: EstimatorState | None
    t: torch.Tensor  # [B]


def runner_init(config: RunnerConfig, params: RobotParams,
                obs: RobotObservation) -> RunnerState:
    """Boot state for the batch of `obs` (on its device): the FSM in
    STAND_UP from the observed joint angles, the locomotion controller
    (with its MPC cold start) and, with `use_estimators`, the estimators."""
    b, device = obs.base_position.shape[0], obs.base_position.device
    est = (estimator_init(config.estimator, b, params.body_height, device)
           if config.use_estimators else None)
    return RunnerState(
        fsm=fsm_mod.fsm_init(obs.joint_angles),
        locomotion=locomotion_init(config.locomotion, params, obs),
        estimator=est,
        t=torch.zeros(b, dtype=torch.float32, device=device))


def runner_step(config: RunnerConfig, params: RobotParams,
                state: RunnerState, cmd: TwistCommand,
                observation: RobotObservation | None = None,
                sensors: RawSensors | None = None,
                model: FloatingBaseModel | None = None,
                fsm_request: torch.Tensor | None = None):
    """One tick: estimators -> FSM -> locomotion -> safe hybrid command.

    Give `observation` (ground truth) or `sensors` (estimator path).
    `fsm_request` ([B] int32 FsmState, optional) is the RC machine's
    request. Returns (HybridCommand, forces_world [B, 4, 3], new state,
    the observation used).
    """
    t = state.t + config.control_dt
    est_state = state.estimator
    if config.use_estimators:
        if sensors is None:
            raise ValueError("use_estimators: pass sensors=RawSensors(...)")
        gait_state = state.locomotion.gait
        est_state, obs = estimator_update(
            config.estimator, params, state.estimator, sensors,
            normalized_phase=gait_state.normalized_phase,
            desired_stance=stance_contact_mask(gait_state),
            dt=config.control_dt)
    else:
        if observation is None:
            raise ValueError("ground-truth path: pass observation=...")
        obs = observation

    run_locomotion = True
    if config.skip_idle_locomotion:
        fsm_in = fsm_mod.with_request(state.fsm, fsm_request)
        after = fsm_mod.next_state(fsm_in, t, fsm_mod.safe_mask(fsm_in, obs))
        loco = fsm_mod.FsmState.LOCOMOTION
        run_locomotion = bool(((fsm_in.state == loco)
                               | (after == loco)).any())
    if run_locomotion:
        loco_cmd, forces, loco_state = locomotion_step(
            config.locomotion, params, state.locomotion, obs, cmd, t,
            model=model)
    else:
        loco_cmd, loco_state = None, state.locomotion
        forces = torch.zeros_like(state.locomotion.mpc.forces_world)
    command, fsm_state, in_loco = fsm_mod.fsm_step(
        params, state.fsm, obs, t, loco_cmd, desired_state=fsm_request)
    # The gait and MPC state advance only in LOCOMOTION; elsewhere the
    # controller state is held.
    loco_state = tree.where(in_loco > 0.5, loco_state, state.locomotion)
    new_state = RunnerState(fsm=fsm_state, locomotion=loco_state,
                            estimator=est_state, t=t)
    return command, forces * in_loco[:, None, None], new_state, obs
