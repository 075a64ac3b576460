"""The JAX examples' loops (examples/*.py) at the short lengths the port's
example tests run, returning the traces the port's `run` returns, under
the same keys.

Each function copies its configuration from the JAX script's own lines
and runs the script's loop (`jax.jit` of `lax.scan`, or the script's own
jitted functions where it has them: the teleop chunk and the bridge's
tick). tests/test_torch_examples.py and tests/test_torch_examples_walk.py
hold the port to them; the whole-body and walk loops, whose jit takes
longer than these tests afford, and the ones the tests' `cuda` cases
need on the card, where no JAX is installed, are kept in
tests/data/examples_jax.npz:

    PYTHONPATH=. python tests/examples_jax.py

writes the file (a few minutes, most of it the whole-body and walk
compiles).
"""

from __future__ import annotations

import functools
import importlib.util
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
FIXTURE = ROOT / "tests" / "data" / "examples_jax.npz"
DT = 0.002

# The tests' lengths.
TICKS = {"a1_trot": 200, "aliengo_wbc_trot": 100, "fleet_sweep": 60,
         "whole_body_standup": 200, "viz3d": 100, "lite3_walk": 150,
         "stair_climb": 100, "gap_crossing": 100}
TELEOP_SCRIPT = "wq"          # two chunks
BRIDGE_TICKS = 50
WIRES = ("native", "unitree", "deeprobotics")


def raised(z):
    """z one float32 step up: the start of JAX's own spread (`nudged`)."""
    return np.nextafter(np.float32(z), np.float32(np.inf))


@functools.lru_cache(maxsize=None)
def example_module(name: str):
    """The JAX script examples/example_<name>.py as a module (loaded
    once, so its jitted functions compile once)."""
    path = ROOT / "examples" / f"example_{name}.py"
    spec = importlib.util.spec_from_file_location(f"jax_example_{name}",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _rollout(config, params, cmd, steps, nudge):
    """The scripts' `rollout`; with `nudge` the same run from the base one
    float32 step up (rollout_init, the carry's base raised,
    rollout_segment). Traceable: the scripts jit it."""
    import jax.numpy as jnp

    from quadruped_tpu.sim.rollout import (rollout, rollout_init,
                                           rollout_segment)

    if not nudge:
        return rollout(config, params, cmd, steps=steps)
    carry = rollout_init(config, params)
    pos = carry.sim.position
    pos = pos.at[2].set(jnp.nextafter(pos[2], jnp.inf))
    carry = carry._replace(sim=carry.sim.replace(position=pos))
    return rollout_segment(config, params, cmd, carry, steps)[1]


def a1_trot(steps=TICKS["a1_trot"], vx=0.4, horizon=10, nudge=False):
    import jax

    from quadruped_tpu.control import mpc, swing
    from quadruped_tpu.control.desired_state import TwistCommand
    from quadruped_tpu.control.locomotion import LocomotionConfig
    from quadruped_tpu.gait import ADVANCED_TROT
    from quadruped_tpu.robots import a1_params

    config = LocomotionConfig(
        mpc=mpc.MpcConfig(horizon=horizon, qp_iters=40),
        swing=swing.SwingConfig(), gait=ADVANCED_TROT())
    cmd = TwistCommand.constant(vx=vx, body_height=0.27)
    res = jax.jit(lambda: _rollout(config, a1_params(), cmd, steps,
                                   nudge))()
    return {"base_height_trace": np.asarray(res.base_height_trace),
            "vel_trace": np.asarray(res.vel_trace),
            "forces_trace": np.asarray(res.forces_trace),
            "alive": np.asarray(res.alive),
            "position": np.asarray(res.sim.position)}


def aliengo_wbc_trot(steps=TICKS["aliengo_wbc_trot"], vx=0.3, no_wbc=False,
                     nudge=False):
    import jax

    from quadruped_tpu.control import mpc, swing, wbc
    from quadruped_tpu.control.desired_state import TwistCommand
    from quadruped_tpu.control.locomotion import LocomotionConfig
    from quadruped_tpu.gait import ADVANCED_TROT
    from quadruped_tpu.robots import aliengo_params

    params = aliengo_params()
    config = LocomotionConfig(
        mpc=mpc.MpcConfig(horizon=5, qp_iters=40),
        swing=swing.SwingConfig(), gait=ADVANCED_TROT(),
        wbc=None if no_wbc else wbc.WbcConfig(), use_wbc=not no_wbc)
    cmd = TwistCommand.constant(vx=vx, body_height=float(params.body_height))
    res = jax.jit(lambda: _rollout(config, params, cmd, steps, nudge))()
    return {"base_height_trace": np.asarray(res.base_height_trace),
            "vel_trace": np.asarray(res.vel_trace),
            "forces_trace": np.asarray(res.forces_trace),
            "alive": np.asarray(res.alive),
            "position": np.asarray(res.sim.position)}


def fleet_sweep(steps=TICKS["fleet_sweep"], nudge=False):
    import jax

    from quadruped_tpu.control import mpc, swing
    from quadruped_tpu.control.locomotion import LocomotionConfig
    from quadruped_tpu.sim.scenario import scenario_grid

    params, gaits, cmds, n = scenario_grid(
        robots=("a1", "go1", "aliengo", "lite3"), gaits=("trot",),
        vx_range=(0.0, 0.2, 0.4, 0.6))
    base = LocomotionConfig(mpc=mpc.MpcConfig(horizon=5, qp_iters=30),
                            swing=swing.SwingConfig(),
                            gait=jax.tree.map(lambda x: x[0], gaits))

    def one(p, g, c):
        return _rollout(base.replace(gait=g), p, c, steps, nudge)

    res = jax.jit(jax.vmap(one))(params, gaits, cmds)
    return {"alive": np.asarray(res.alive),
            "base_height_trace": np.asarray(res.base_height_trace),
            "vel_trace": np.asarray(res.vel_trace)}


def keyboard_teleop(script=TELEOP_SCRIPT, nudge=False):
    """The script's scripted mode through its own `make_chunk_step`."""
    import jax
    import jax.numpy as jnp

    from quadruped_tpu.control import mpc, swing, teleop
    from quadruped_tpu.control.desired_state import TwistCommand
    from quadruped_tpu.control.locomotion import (LocomotionConfig,
                                                  locomotion_init)
    from quadruped_tpu.gait import ADVANCED_TROT
    from quadruped_tpu.robots import a1_params
    from quadruped_tpu.sim import srb_sim

    mod = example_module("keyboard_teleop")
    params = a1_params()
    config = LocomotionConfig(mpc=mpc.MpcConfig(horizon=5, qp_iters=40),
                              swing=swing.SwingConfig(),
                              gait=ADVANCED_TROT())
    sim = srb_sim.srb_sim_init(params)
    obs = srb_sim.observe(params, sim, jnp.ones(4))
    state = locomotion_init(config, params, obs)
    if nudge:
        sim = sim.replace(position=sim.position.at[2].set(
            raised(sim.position[2])))
    chunk_step = mod.make_chunk_step(config, params)
    cmd = TwistCommand.constant(body_height=float(params.body_height))
    t0 = jnp.zeros(())
    rows = {"position": [], "vel_world": [], "linear": [], "wz": []}
    for key in script:
        cmd = teleop.apply_key(cmd, key)
        sim, state = chunk_step(sim, state, cmd, t0)
        t0 = t0 + mod.CHUNK * mod.DT
        for k, v in (("position", sim.position), ("vel_world", sim.vel_world),
                     ("linear", cmd.linear), ("wz", cmd.angular_z)):
            rows[k].append(np.asarray(jax.device_get(v)))
    return {k: np.stack(v) for k, v in rows.items()}


def bridge_dry_run():
    """The script's --dry-run through its own `build_controller`."""
    import jax.numpy as jnp

    from quadruped_tpu.control.desired_state import TwistCommand
    from quadruped_tpu.control.locomotion import locomotion_init
    from quadruped_tpu.sim import srb_sim

    params, config, tick = _bridge_controller()
    sim = srb_sim.srb_sim_init(params)
    obs = srb_sim.observe(params, sim, jnp.ones(4))
    ctrl = locomotion_init(config, params, obs)
    out = tick(ctrl, obs, TwistCommand.constant(vx=0.2), jnp.asarray(0.002))
    return {k: np.asarray(getattr(out[0], k))
            for k in ("q", "kp", "dq", "kd", "tau")}


@functools.lru_cache(maxsize=None)
def _bridge_controller():
    """(params, config, jitted tick) of the script's `build_controller`."""
    from quadruped_tpu.robots import a1_params

    params = a1_params()
    return (params,) + example_module("hardware_bridge").build_controller(
        params)


def bridge_loop(rows: np.ndarray, hz: float = 500.0) -> np.ndarray:
    """The script's UDP loop on the state rows it read (rows [T + 1, 51],
    the boot's first; the bridge's state dict is the row's slices) through
    its own `build_controller` and `obs_from_bridge_state`: the commands
    [T, 60] it sends."""
    import jax.numpy as jnp

    from quadruped_tpu.control.desired_state import TwistCommand
    from quadruped_tpu.control.locomotion import locomotion_init

    mod = example_module("hardware_bridge")
    params, config, tick = _bridge_controller()
    fields = (("tick", 0, 1), ("quat", 1, 5), ("gyro", 5, 8), ("acc", 8, 11),
              ("q", 11, 23), ("dq", 23, 35), ("tau", 35, 47),
              ("foot_force", 47, 51))

    def state(row):
        s = {k: row[a:b] for k, a, b in fields}
        s["tick"] = row[0]
        return s

    cmd = TwistCommand.constant(vx=0.0)
    ctrl = locomotion_init(config, params,
                           mod.obs_from_bridge_state(params, state(rows[0])))
    t, dt = 0.0, 1.0 / hz
    sent = []
    for row in rows[1:]:
        obs = mod.obs_from_bridge_state(params, state(row))
        command, _, ctrl = tick(ctrl, obs, cmd, jnp.asarray(t))
        sent.append(np.concatenate([np.asarray(getattr(command, k))
                                    for k in ("q", "kp", "dq", "kd", "tau")]))
        t += dt
    return np.stack(sent).astype(np.float32)


def decoded_row(wire: str, packet: bytes) -> np.ndarray:
    """The [51] state row the JAX package's bridge decodes from `packet`
    in wire mode `wire`."""
    import socket
    import time

    from quadruped_tpu.runtime import RobotBridge

    with socket.socket(socket.AF_INET, socket.SOCK_DGRAM) as probe:
        probe.bind(("127.0.0.1", 0))
        port = probe.getsockname()[1]
    bridge = RobotBridge(recv_port=port, send_port=9, wire_mode=wire)
    tx = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    try:
        deadline, n = time.time() + 2.0, 0
        while n == 0 and time.time() < deadline:
            tx.sendto(packet, ("127.0.0.1", port))
            time.sleep(0.01)
            n, s = bridge.get_state()
        assert n > 0, f"{wire}: no state decoded"
        return np.concatenate([np.atleast_1d(s[k]) for k in (
            "tick", "quat", "gyro", "acc", "q", "dq", "tau", "foot_force")]
        ).astype(np.float32)
    finally:
        bridge.close()
        tx.close()


def bridge_variants(wire: str, packet: bytes) -> dict:
    """The JAX loop of BRIDGE_TICKS ticks on the decoded `packet`, booted
    from it (`boot_packet`) and from the empty snapshot the bridge holds
    before its first packet (`boot_empty`), with the decoded row."""
    row = decoded_row(wire, packet)
    rows = np.tile(row, (BRIDGE_TICKS + 1, 1))
    empty = rows.copy()
    empty[0] = 0.0
    return {"row": row, "boot_packet": bridge_loop(rows),
            "boot_empty": bridge_loop(empty)}


def whole_body_standup(steps=TICKS["whole_body_standup"], vx=0.2,
                       nudge=False):
    import jax
    import jax.numpy as jnp

    import quadruped_tpu.core.se3 as se3
    from quadruped_tpu.control import mpc, swing
    from quadruped_tpu.control.desired_state import TwistCommand
    from quadruped_tpu.control.locomotion import LocomotionConfig
    from quadruped_tpu.dynamics import floating_base as fb
    from quadruped_tpu.estimation.container import (EstimatorConfig,
                                                    RawSensors)
    from quadruped_tpu.estimation.velocity import VelocityEstimatorConfig
    from quadruped_tpu.exec import RunnerConfig, runner_init, runner_step
    from quadruped_tpu.gait import ADVANCED_TROT
    from quadruped_tpu.robots import a1_params
    from quadruped_tpu.sim import whole_body as wb

    params = a1_params()
    model = fb.build_model(params)
    contact_model = wb.ContactModel()
    config = RunnerConfig(
        locomotion=LocomotionConfig(
            mpc=mpc.MpcConfig(horizon=5, qp_iters=40),
            swing=swing.SwingConfig(), gait=ADVANCED_TROT()),
        estimator=EstimatorConfig(velocity=VelocityEstimatorConfig(
            window_size=20, acc_filter_window=5)),
        use_estimators=True)
    cmd = TwistCommand.constant(vx=vx, body_height=0.27)
    sim0 = wb.whole_body_init(params, body_height=0.15)
    sim0 = wb.WholeBodySimState(fb=sim0.fb.replace(q=params.sitdown_angles),
                                t=sim0.t)
    if nudge:
        sim0 = _raise_fb(sim0)
    obs0 = wb.observe(params, model, sim0, contact_model)
    st0 = runner_init(config, params, obs0)

    def step(carry, i):
        sim, st, prev_v = carry
        truth = wb.observe(params, model, sim, contact_model)
        r = se3.quat_to_rotmat(truth.base_quat)
        acc_world = (truth.base_vel_world - prev_v) / 0.002 \
            + jnp.asarray([0.0, 0.0, 9.81])
        sensors = RawSensors(
            quat=truth.base_quat, acc_body=acc_world @ r,
            omega_body=truth.base_omega_body,
            joint_angles=truth.joint_angles,
            joint_velocities=truth.joint_velocities,
            foot_forces=truth.foot_forces)
        command, forces, st, _ = runner_step(config, params, st, cmd,
                                             sensors=sensors)
        sim, _ = wb.whole_body_step(params, model, sim, command,
                                    contact_model, 0.002)
        return (sim, st, truth.base_vel_world), (sim.fb.position,
                                                 st.fsm.state)

    _, (pos, fsm) = jax.jit(lambda: jax.lax.scan(
        step, (sim0, st0, jnp.zeros(3)), jnp.arange(steps)))()
    return {"position": np.asarray(pos), "fsm": np.asarray(fsm)}


def _raise_fb(sim):
    """A whole-body sim state with the base one float32 step higher."""
    pos = np.asarray(sim.fb.position).copy()
    pos[2] = raised(pos[2])
    return sim.replace(fb=sim.fb.replace(position=pos))


def viz3d(steps=TICKS["viz3d"], nudge=False):
    import jax
    import jax.numpy as jnp

    from quadruped_tpu.control import mpc, swing
    from quadruped_tpu.control.desired_state import TwistCommand
    from quadruped_tpu.control.locomotion import (LocomotionConfig,
                                                  locomotion_init,
                                                  locomotion_step)
    from quadruped_tpu.core import se3
    from quadruped_tpu.dynamics import floating_base as fb
    from quadruped_tpu.gait import ADVANCED_TROT
    from quadruped_tpu.robots import a1_params
    from quadruped_tpu.sim import whole_body as wb

    params = a1_params()
    model = fb.build_model(params)
    cm = wb.ContactModel()
    config = LocomotionConfig(
        mpc=mpc.MpcConfig(horizon=5, qp_iters=24, qp_cold_iters=120),
        swing=swing.SwingConfig(), gait=ADVANCED_TROT())
    cmd = TwistCommand.constant(vx=0.3, body_height=0.27)
    sim0 = wb.whole_body_init(params)
    if nudge:
        sim0 = _raise_fb(sim0)
    obs0 = wb.observe(params, model, sim0, cm)
    ctrl0 = locomotion_init(config, params, obs0)

    def step(carry, i):
        sim, ctrl = carry
        obs = wb.observe(params, model, sim, cm)
        command, forces, ctrl = locomotion_step(
            config, params, ctrl, obs, cmd,
            (i + 1).astype(jnp.float32) * 0.002)
        sim, flags = wb.whole_body_step(params, model, sim, command, cm,
                                        0.002)
        return (sim, ctrl), (sim.fb.position, se3.quat_to_rpy(sim.fb.quat),
                             sim.fb.q, flags)

    _, (pos, rpy, q, contact) = jax.jit(lambda: jax.lax.scan(
        step, (sim0, ctrl0), jnp.arange(steps)))()
    return {"position": np.asarray(pos), "rpy": np.asarray(rpy),
            "q": np.asarray(q), "contact": np.asarray(contact)}


def lite3_walk(steps=TICKS["lite3_walk"], vx=0.015, nudge=False):
    import jax
    import jax.numpy as jnp

    from quadruped_tpu.control import stance_force_balance as stance_fb
    from quadruped_tpu.control.desired_state import TwistCommand
    from quadruped_tpu.control.walk_locomotion import (WalkConfig, walk_init,
                                                       walk_step)
    from quadruped_tpu.gait import WALK
    from quadruped_tpu.gait.walk import SubLegState
    from quadruped_tpu.robots import lite3_params
    from quadruped_tpu.sim import srb_sim

    params = lite3_params()
    config = WalkConfig(
        gait=WALK(),
        force_balance=stance_fb.ForceBalanceConfig(
            kp=jnp.asarray([100., 200., 100., 100., 100., 200.]),
            kd=jnp.asarray([40., 30., 10., 10., 10., 30.]),
            qp_iters=300))
    cmd = TwistCommand.constant(vx=vx, body_height=float(params.body_height))
    sim0 = srb_sim.srb_sim_init(params)
    if nudge:
        pos = np.asarray(sim0.position).copy()
        pos[2] = raised(pos[2])
        sim0 = sim0.replace(position=pos)
    obs0 = srb_sim.observe(params, sim0, jnp.ones(4))
    st0 = walk_init(config, params, obs0)

    def step(carry, i):
        sim, st = carry
        support = (st.gait.leg_sub_state
                   != SubLegState.TRUE_SWING).astype(jnp.float32)
        obs = srb_sim.observe(params, sim, support)
        command, forces, st = walk_step(config, params, st, obs, cmd,
                                        (i + 1).astype(jnp.float32) * DT)
        support_new = (st.gait.leg_sub_state
                       != SubLegState.TRUE_SWING).astype(jnp.float32)
        sim = srb_sim.srb_sim_step(
            params, sim, forces, support_new, command.q, command.dq,
            1.0 - jnp.repeat(support_new, 3), DT)
        return (sim, st), (sim.position, st.gait.leg_sub_state)

    _, (pos, subs) = jax.jit(lambda: jax.lax.scan(
        step, (sim0, st0), jnp.arange(steps)))()
    return {"position": np.asarray(pos), "sub_state": np.asarray(subs)}


def _terrain_walk(terr, adjust, force_balance, steps, nudge):
    """The stair and gap scripts' loop (the same lines in both)."""
    import jax
    import jax.numpy as jnp

    from quadruped_tpu.control.desired_state import TwistCommand
    from quadruped_tpu.control.walk_locomotion import (WalkConfig, walk_init,
                                                       walk_step)
    from quadruped_tpu.core import se3
    from quadruped_tpu.dynamics import floating_base as fb
    from quadruped_tpu.gait.scheduler import _config
    from quadruped_tpu.robots import a1_params
    from quadruped_tpu.sim import whole_body as wb

    params = a1_params()
    model = fb.build_model(params)
    cm = wb.ContactModel()
    config = WalkConfig(
        gait=_config(3.7, 0.75, [0.5, 0.0, 0.75, 0.25], threshold=0.1),
        force_balance=force_balance)
    cmd = TwistCommand.constant(vx=0.03, body_height=0.27)
    sim0 = wb.whole_body_init(params)
    if nudge:
        sim0 = _raise_fb(sim0)
    obs0 = wb.observe(params, model, sim0, cm, terrain_height=terr)
    st0 = walk_init(config, params, obs0)

    def step(carry, i):
        sim, st = carry
        obs = wb.observe(params, model, sim, cm, terrain_height=terr)
        command, forces, st = walk_step(
            config, params, st, obs, cmd,
            (i + 1).astype(jnp.float32) * DT,
            terrain_height=terr, foothold_adjust_fn=adjust)
        sim, flags = wb.whole_body_step(params, model, sim, command, cm,
                                        DT, terrain_height=terr)
        return (sim, st), (sim.fb.position, se3.quat_to_rpy(sim.fb.quat),
                           sim.fb.q, flags, st.gait.leg_sub_state)

    _, (pos, rpy, q, contact, subs) = jax.jit(lambda: jax.lax.scan(
        step, (sim0, st0), jnp.arange(steps)))()
    return {"position": np.asarray(pos), "rpy": np.asarray(rpy),
            "q": np.asarray(q), "contact": np.asarray(contact),
            "sub_state": np.asarray(subs)}


def stair_climb(steps=TICKS["stair_climb"], nudge=False):
    import jax.numpy as jnp

    from quadruped_tpu.control import stance_force_balance as stance_fb
    from quadruped_tpu.planner import foot_stepper
    from quadruped_tpu.sim import terrain

    step_height, riser_x = 0.08, 0.25
    terr = terrain.stairs(step_length=5.0, step_height=step_height,
                          start_x=riser_x - 5.0)
    stair = foot_stepper.StairParams(
        start_x=jnp.asarray(riser_x), width=jnp.asarray(5.0),
        height=jnp.asarray(step_height), count=jnp.asarray(1))

    def adjust(target, feet):
        x_adj, _ = foot_stepper.stair_foothold_adjust(
            feet[:, 0], stair, default_delta=0.1)
        return target.at[:, 0].set(x_adj)

    return _terrain_walk(terr, adjust, stance_fb.ForceBalanceConfig(
        kp=jnp.asarray([100., 200., 100., 100., 100., 200.]),
        kd=jnp.asarray([40., 30., 10., 10., 10., 30.]),
        qp_iters=40), steps, nudge)


def gap_crossing(steps=TICKS["gap_crossing"], nudge=False):
    import jax.numpy as jnp

    from quadruped_tpu.control import stance_force_balance as stance_fb
    from quadruped_tpu.planner import foot_stepper
    from quadruped_tpu.sim import terrain

    gap_x, gap_w = 0.25, 0.06
    terr = terrain.gaps(gap_centers=(gap_x,), gap_width=gap_w, depth=0.5)
    centers = jnp.asarray([gap_x])

    def adjust(target, feet):
        x_adj = foot_stepper.gap_foothold_adjust(
            target[:, 0], centers, gap_w, margin=0.02, current_x=feet[:, 0])
        return target.at[:, 0].set(x_adj)

    return _terrain_walk(terr, adjust, stance_fb.ForceBalanceConfig(
        kp=jnp.asarray([100., 200., 100., 100., 100., 200.]),
        kd=jnp.asarray([40., 30., 10., 10., 10., 30.])), steps, nudge)


# The closed loops, whose traces the port is held to within a multiple of
# JAX's own spread: each is also run from the base one float32 step up
# (`<name>/nudged/<key>`).
NUDGED = ("a1_trot", "aliengo_wbc_trot", "fleet_sweep", "keyboard_teleop",
          "whole_body_standup", "viz3d", "lite3_walk", "stair_climb",
          "gap_crossing")


def fixture() -> dict:
    """Every example's JAX traces, flat {example/key: array}."""
    from quadruped_tpu_torch.examples.fixture import wire_state_packet

    runs = {"a1_trot": a1_trot, "aliengo_wbc_trot": aliengo_wbc_trot,
            "fleet_sweep": fleet_sweep, "keyboard_teleop": keyboard_teleop,
            "bridge_dry_run": bridge_dry_run,
            "whole_body_standup": whole_body_standup, "viz3d": viz3d,
            "lite3_walk": lite3_walk, "stair_climb": stair_climb,
            "gap_crossing": gap_crossing}
    out = {}
    for name, fn in runs.items():
        for k, v in fn().items():
            out[f"{name}/{k}"] = np.asarray(v)
        if name in NUDGED:
            for k, v in fn(nudge=True).items():
                out[f"{name}/nudged/{k}"] = np.asarray(v)
    for wire in WIRES:
        for k, v in bridge_variants(wire, wire_state_packet(wire)).items():
            out[f"bridge_{wire}/{k}"] = v
    return out


if __name__ == "__main__":
    import sys

    sys.path.insert(0, str(Path(__file__).parent))
    import conftest  # noqa: F401  (JAX on CPU, float32)

    FIXTURE.parent.mkdir(exist_ok=True)
    np.savez_compressed(FIXTURE, **fixture())
    print("wrote", FIXTURE)
