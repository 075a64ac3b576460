"""Scenario grids: robots x gaits x commands in one batch (port of
quadruped_tpu/sim/scenario.py).

Every robot shares one parameter schema (robots/params.py) and every gait
one clock schema (gait/scheduler.py), so a heterogeneous fleet is one
batch: the parameters stacked one robot per scenario (`stack_params`),
the gait tables one per scenario ([B, 4] and [B]) and the commands [B].
`sim.rollout.rollout` runs it as one closed loop, with one MPC solve (one
K1 launch on the card) for the whole fleet where the JAX package runs
`jax.vmap(rollout)`.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np

from quadruped_tpu_torch.control.desired_state import TwistCommand
from quadruped_tpu_torch.gait.scheduler import named_gait
from quadruped_tpu_torch.robots.params import stack_params
from quadruped_tpu_torch.utils import card, tree


def scenario_grid(robots: Sequence[str] = ("a1",),
                  gaits: Sequence[str] = ("trot",),
                  vx_range: Sequence[float] = (0.0, 0.3, 0.6),
                  wz_range: Sequence[float] = (0.0,),
                  body_height: float = 0.27, device=None):
    """Cartesian product -> (params, gait_configs, commands, n), each with
    the leading scenario axis n = len(robots) * len(gaits) * len(vx_range)
    * len(wz_range), in the JAX loop order (robot, then gait, then vx,
    then wz); on the card unless `device` says otherwise."""
    device = card.resolve(device)
    cells = [(r, g, vx, wz) for r in robots for g in gaits
             for vx in vx_range for wz in wz_range]
    params = stack_params([r for r, _, _, _ in cells], device)
    tables = {g: named_gait(g, device) for g in gaits}
    gait_configs = tree.stack([tables[g] for _, g, _, _ in cells])
    commands = TwistCommand.constant(
        vx=np.asarray([c[2] for c in cells], np.float32),
        wz=np.asarray([c[3] for c in cells], np.float32),
        body_height=body_height, batch=len(cells), device=device)
    return params, gait_configs, commands, len(cells)


def tile_scenarios(value, repeats: int):
    """A stacked scenario tree (dataclasses, NamedTuples, tuples of them)
    repeated `repeats` times along its leading axis, as `jnp.tile` does:
    scenario i of the result is scenario i % n of the input."""
    return tree.map_tensors(
        lambda x: x.repeat((repeats,) + (1,) * (x.ndim - 1)), value)
