"""The trot -> walk -> trot closed loop of the JAX test_closed_loop_trot_walk_trot.

ADVANCED_TROT with the 0.45 s walk table as `gait_b`,
`MpcConfig(horizon=5, qp_iters=24, qp_cold_iters=120)`, the SRB sim; a
rising edge of `gait_switch` toggles a scenario's table (decelerate,
stand, swap). tests/test_torch_gait_transition.py::
test_closed_loop_matches_jax runs it, on the CPU and on the card, and
holds it against the JAX package's run of its first three segments
(tests/data/gait_transition_a1.npz) with `fixture_errors`.
"""

from __future__ import annotations

import numpy as np

from quadruped_tpu_torch.control import mpc as mpc_mod
from quadruped_tpu_torch.control import swing as swing_mod
from quadruped_tpu_torch.control.locomotion import LocomotionConfig
from quadruped_tpu_torch.gait.scheduler import ADVANCED_TROT, _config

# The JAX test's segments (ticks); the fixture keeps the first three.
SEGMENTS = (400, 400, 1000, 400, 900)
FIXTURE_SEGMENTS = 3
TRACE_STRIDE = 5
SIM_FIELDS = ("position", "quat", "vel_world", "omega_world", "q", "dq",
              "foot_anchor")
MG = 13.0 * 9.81
# Port vs JAX: test_torch_rollout.py's limits and forces within 1% m*g,
# up to the swap tick. At the swap the new table's clock restarts on a
# tick where every leg's phase boundary falls exactly on a tick of the
# 0.45 s walk table (every 75 ticks); JAX's XLA contracts t - reset_time
# into a fused multiply-add of the unrounded product (i + 1) * dt, which
# leaves a phase of 0.7499999 or 3.9e-9 where the port's is 0.75 or 0, so
# each walk-table swing of a switched scenario starts one tick apart and
# the traces part. After the swap the switched scenarios are held to
# AFTER_SWAP (CPU readings in the comments) and their forces are not
# compared tick by tick.
TOL = {"position": 2e-4, "base_height_trace": 2e-4, "quat": 5e-4,
       "vel_world": 5e-3, "vel_trace": 5e-3, "omega_world": 3e-2,
       "q": 2e-3, "dq": 5e-2, "foot_anchor": 1e-3,
       "forces_trace": 0.01 * MG}
AFTER_SWAP = {"position": 5e-3,           # 8.1e-4 m
              "base_height_trace": 2e-3,  # 1.2e-4 m
              "quat": 2e-3,               # 2.1e-4
              "vel_world": 5e-2,          # 1.2e-4 m/s
              "vel_trace": 1e-1,          # 2.2e-2 m/s
              "omega_world": 1e-1,        # 4.8e-4 rad/s
              "q": 3e-2,                  # 3.4e-3 rad
              "dq": 2e-1,                 # 1.4e-2 rad/s
              "foot_anchor": 5e-3}        # 9.7e-4 m


def walk_table(device=None):
    return _config(0.45, 0.75, [0.5, 0.0, 0.75, 0.25], device=device)


def config(device=None) -> LocomotionConfig:
    return LocomotionConfig(
        mpc=mpc_mod.MpcConfig(horizon=5, qp_iters=24, qp_cold_iters=120),
        swing=swing_mod.SwingConfig(), gait=ADVANCED_TROT(device),
        gait_b=walk_table(device))


def fixture_errors(got: dict, data) -> dict:
    """{quantity: (max |port - JAX|, limit)} of the fixture's view `got`
    (the keys of tests/data/gait_transition_a1.npz: per-tick `loop/phase`
    and `loop/active_idx`, strided traces, the state at each segment's
    end) against `data`; the transition fields must be equal (raises
    AssertionError)."""
    for key in ("loop/phase", "loop/active_idx"):
        np.testing.assert_array_equal(got[key], data[key], err_msg=key)
    idx = data["loop/active_idx"]
    swapped = idx[:, -1] != idx[:, 0]
    swap = np.where(swapped, np.argmax(idx != idx[:, :1], axis=1),
                    idx.shape[1])                       # [B] swap tick
    out = {}

    def held(key, value, ref, before):
        """Max difference over the scenarios and ticks `before` [B, T]
        (True: held to TOL) and the rest (held to AFTER_SWAP)."""
        quantity = key.rsplit("/", 1)[-1]
        d = np.abs(value - ref).reshape(value.shape[:2] + (-1,)).max(-1)
        out[key] = (float(d[before].max()) if before.any() else 0.0,
                    TOL[quantity])
        if quantity in AFTER_SWAP and (~before).any():
            out[key + "@after_swap"] = (float(d[~before].max()),
                                        AFTER_SWAP[quantity])

    ticks = np.arange(TRACE_STRIDE - 1, idx.shape[1], TRACE_STRIDE)
    for key in ("base_height_trace", "vel_trace", "forces_trace"):
        before = ticks[None, :] < swap[:, None]
        held(f"loop/{key}", got[f"loop/{key}"], data[f"loop/{key}"], before)
    ends = np.cumsum(SEGMENTS[:FIXTURE_SEGMENTS]) - 1
    for s, end in enumerate(ends):
        np.testing.assert_array_equal(got[f"loop/end{s}/alive"],
                                      data[f"loop/end{s}/alive"])
        for f in SIM_FIELDS:
            key = f"loop/end{s}/{f}"
            before = (end < swap)[:, None]
            held(key, got[key][:, None], data[key][:, None], before)
    return out
