"""Phase-clock gait scheduler, batched (a frozen copy of the port's twin of quadruped_tpu/gait/scheduler.py).

`GaitConfig` is one gait table shared by the batch ([4] leg fields, []
scalars) or one table per scenario ([B, 4] and [B], as
control/gait_transition.py's `active_gait` selects it); `GaitState` is per
scenario ([B, 4] and [B]). The update is the JAX module's masked
arithmetic with the scenario axis written out.
"""

from __future__ import annotations

import dataclasses

import torch

from portbench.reference import card


class LegState:
    """Leg-state codes (reference qr_enum_types.h LegState)."""

    SWING = 0
    STANCE = 1
    EARLY_CONTACT = 2
    LOSE_CONTACT = 3
    USERDEFINED_SWING = 4


@dataclasses.dataclass
class GaitConfig:
    """Static gait table: shared by the batch ([4] leg fields, []
    scalars) or per scenario ([B, 4] and [B])."""

    stance_duration: torch.Tensor     # [4] s
    duty_factor: torch.Tensor         # [4]
    init_phase: torch.Tensor          # [4]
    initial_leg_state: torch.Tensor   # [4] int32
    contact_detection_phase_threshold: torch.Tensor  # []
    wait_time: torch.Tensor           # []
    use_touchdown_wait: torch.Tensor  # [] 0/1

    @property
    def full_cycle_period(self) -> torch.Tensor:
        return self.stance_duration / torch.clamp(self.duty_factor, min=1e-6)

    @property
    def swing_duration(self) -> torch.Tensor:
        return self.full_cycle_period - self.stance_duration

    @property
    def stance_ratio(self) -> torch.Tensor:
        init_stance = self.initial_leg_state == LegState.STANCE
        return torch.where(init_stance, self.duty_factor,
                           1.0 - self.duty_factor)


def per_leg(scalar: torch.Tensor) -> torch.Tensor:
    """A scalar GaitConfig field, [] or [B], shaped to broadcast against
    [B, 4] leg tensors."""
    return scalar[:, None] if scalar.ndim else scalar


def _config(stance, duty, phases, wait_time=0.3, threshold=0.5,
            touchdown_wait=False, device=None) -> GaitConfig:
    device = card.resolve(device)

    def f(x):
        return torch.as_tensor(x, dtype=torch.float32, device=device)

    return GaitConfig(
        stance_duration=f([stance] * 4),
        duty_factor=f([duty] * 4),
        init_phase=f(phases),
        initial_leg_state=torch.full((4,), LegState.STANCE, dtype=torch.int32,
                                     device=device),
        contact_detection_phase_threshold=f(threshold),
        wait_time=f(wait_time),
        use_touchdown_wait=f(1.0 if touchdown_wait else 0.0),
    )


def from_config(gait: dict, device) -> GaitConfig:
    """A gait table from a configuration file's `gait` entry: the keyword
    arguments of `_config` (its `name` is not one)."""
    return _config(device=device, **{k: v for k, v in gait.items()
                                     if k != "name"})


@dataclasses.dataclass
class GaitState:
    """Per-scenario scheduler state."""

    leg_state: torch.Tensor           # [B, 4] int32
    cur_leg_state: torch.Tensor       # [B, 4] int32
    last_leg_state: torch.Tensor      # [B, 4] int32
    desired_leg_state: torch.Tensor   # [B, 4] int32
    normalized_phase: torch.Tensor    # [B, 4]
    phase_in_full_cycle: torch.Tensor  # [B, 4]
    first_swing: torch.Tensor         # [B, 4]
    swing_time_remaining: torch.Tensor  # [B, 4]
    allow_switch: torch.Tensor        # [B, 4]
    reset_time: torch.Tensor          # [B]
    cum_wait: torch.Tensor            # [B]
    last_time: torch.Tensor           # [B]


def gait_init(config: GaitConfig, batch: int) -> GaitState:
    device = config.duty_factor.device
    i4 = torch.full((batch, 4), LegState.STANCE, dtype=torch.int32,
                    device=device)
    z4 = torch.zeros((batch, 4), dtype=torch.float32, device=device)
    z = torch.zeros((batch,), dtype=torch.float32, device=device)
    return GaitState(
        leg_state=config.initial_leg_state.expand(batch, 4).clone(),
        cur_leg_state=i4, last_leg_state=i4.clone(),
        desired_leg_state=i4.clone(), normalized_phase=z4,
        phase_in_full_cycle=z4.clone(), first_swing=z4.clone(),
        swing_time_remaining=z4.clone(), allow_switch=torch.ones_like(z4),
        reset_time=z, cum_wait=z.clone(), last_time=z.clone())


def gait_update(config: GaitConfig, state: GaitState, t: torch.Tensor,
                contact: torch.Tensor) -> GaitState:
    """One scheduler tick. t: [B] time since gait reset; contact: [B, 4]."""
    dt = t - state.last_time
    period = config.full_cycle_period
    ratio = config.stance_ratio

    # Advanced-trot touchdown wait: a leg whose clock wants STANCE but has
    # not touched down freezes the clock, for at most wait_time seconds.
    wants_stance = ((state.cur_leg_state == LegState.SWING)
                    & (state.desired_leg_state == LegState.STANCE)
                    & (contact <= 0.5))
    any_blocked = (torch.amax(wants_stance.float(), dim=-1)
                   * config.use_touchdown_wait)
    cum_wait = torch.where(any_blocked > 0, state.cum_wait + dt,
                           torch.zeros_like(dt))
    still_waiting = (any_blocked > 0) & (cum_wait <= config.wait_time)
    reset_time = torch.where(still_waiting, state.reset_time + dt,
                             state.reset_time)
    allow_switch = ~still_waiting[:, None]
    allow_switch_leg = torch.where(wants_stance & still_waiting[:, None],
                                   0.0, 1.0)

    t_eff = t - reset_time
    aug = config.init_phase * period + t_eff[:, None]
    phase = torch.remainder(aug, period) / period
    in_stance = phase < ratio
    swing_code = torch.full_like(state.leg_state, LegState.SWING)
    desired = torch.where(in_stance, LegState.STANCE, swing_code)
    norm_phase = torch.where(
        in_stance, phase / torch.clamp(ratio, min=1e-6),
        (phase - ratio) / torch.clamp(1.0 - ratio, min=1e-6))

    new_last = torch.where(allow_switch, state.cur_leg_state,
                           state.last_leg_state)
    new_cur = torch.where(allow_switch, state.desired_leg_state,
                          state.cur_leg_state)

    entering_swing = ((desired == LegState.SWING)
                      & (new_cur == LegState.STANCE) & allow_switch)
    first_swing = entering_swing.float()
    swing_remaining = torch.where(
        desired == LegState.SWING,
        torch.where(entering_swing, config.swing_duration,
                    config.swing_duration * (1.0 - norm_phase)),
        state.swing_time_remaining)

    keep_early = ((state.leg_state == LegState.EARLY_CONTACT)
                  & (desired == LegState.SWING))
    leg_state = torch.where(keep_early, state.leg_state, desired)
    detect = norm_phase >= per_leg(config.contact_detection_phase_threshold)
    early = ((leg_state == LegState.SWING) & (contact > 0.5) & detect
             & allow_switch)
    leg_state = torch.where(early, LegState.EARLY_CONTACT, leg_state)
    user = config.initial_leg_state == LegState.USERDEFINED_SWING
    leg_state = torch.where(user, LegState.USERDEFINED_SWING, leg_state)
    desired = torch.where(user, LegState.USERDEFINED_SWING, desired)

    return GaitState(
        leg_state=leg_state.to(torch.int32),
        cur_leg_state=new_cur.to(torch.int32),
        last_leg_state=new_last.to(torch.int32),
        desired_leg_state=desired.to(torch.int32),
        normalized_phase=norm_phase,
        phase_in_full_cycle=phase,
        first_swing=first_swing,
        swing_time_remaining=swing_remaining,
        allow_switch=allow_switch_leg,
        reset_time=reset_time,
        cum_wait=cum_wait,
        last_time=t.expand_as(state.last_time).clone(),
    )


def predicted_contact_table(config: GaitConfig, state: GaitState, dt_mpc,
                            horizon: int) -> torch.Tensor:
    """[B, H, 4] future stance prediction for the MPC contact schedule."""
    period = config.full_cycle_period
    ratio = config.stance_ratio
    k = torch.arange(horizon, dtype=period.dtype, device=period.device)
    future = (state.phase_in_full_cycle[..., None, :]
              + k[:, None] * dt_mpc / period[..., None, :])
    future = torch.remainder(future, 1.0)
    return (future < ratio[..., None, :]).to(period.dtype)


def stance_contact_mask(state: GaitState) -> torch.Tensor:
    """[B, 4] 1.0 where the leg bears load (STANCE, EARLY/LOSE_CONTACT)."""
    s = state.leg_state
    return ((s == LegState.STANCE) | (s == LegState.EARLY_CONTACT)
            | (s == LegState.LOSE_CONTACT)).float()
