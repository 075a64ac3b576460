"""Batches of production-shaped MPC cone QPs for kernel checks and timing.

The state and contact-table distribution of the JAX package's solver
benchmark (bench.py `make_states` and `trot_table`): random base attitude,
perturbed foot positions, a commanded 0.4 m/s forward drift, and a trot
table with a per-scenario phase offset that pins half the force triples.
Drawn with numpy from a seed, then built into the QP by the port's own
SRB, ZOH and condensation code.
"""

from __future__ import annotations

import numpy as np
import torch

from quadruped_tpu_torch.core import se3
from quadruped_tpu_torch.dynamics import srb
from quadruped_tpu_torch.robots.params import a1_params
from quadruped_tpu_torch.solvers import condense
from quadruped_tpu_torch.solvers.cone_qp import ConeQP

DT_MPC = 0.03
STATE_WEIGHTS = (10, 10, 5, 40, 60, 100, 0, 0, 0.5, 5, 5, 1, 0.0)
FORCE_WEIGHT = 4e-6
_FEET = np.array([[0.17, -0.13, -0.28], [0.17, 0.13, -0.28],
                  [-0.17, -0.13, -0.28], [-0.17, 0.13, -0.28]])


def bench_states(batch: int, t: float, rng: np.random.Generator):
    """(rpy [B, 3], feet [B, 4, 3], x0 [B, 13]) as float32 numpy arrays."""
    rpy = (rng.normal(size=(batch, 3)) * 0.1).astype(np.float32)
    feet = (rng.normal(size=(batch, 4, 3)) * 0.05 + _FEET
            + 0.02 * np.sin(5 * t)).astype(np.float32)
    x0 = np.concatenate([rng.normal(size=(batch, 12)) * 0.05,
                         srb.GRAVITY * np.ones((batch, 1))],
                        1).astype(np.float32)
    x0[:, 3] += 0.4 * t
    return rpy, feet, x0


def trot_table(batch: int, t: float, rng: np.random.Generator,
               horizon: int) -> np.ndarray:
    """[B, H, 4] diagonal-pair trot table, row 0 in full stance."""
    offs = rng.uniform(size=(batch, 1))
    phase = (np.arange(horizon)[None, :] * DT_MPC / 0.6 + t / 0.6
             + offs) % 1.0
    diag_a = (phase < 0.6).astype(np.float32)
    table = np.stack([diag_a, 1 - diag_a, 1 - diag_a, diag_a], axis=2)
    table[:, 0, :] = 1.0
    return table.astype(np.float32)


def bench_problems(batch: int, horizon: int = 10, t: float = 0.0,
                   seed: int = 0, device=None):
    """Returns (ConeQP with [B] leading axis, contact table [B, H, 4])."""
    rng = np.random.default_rng(seed)
    rpy, feet, x0 = bench_states(batch, t, rng)
    table = trot_table(batch, t, rng, horizon)
    params = a1_params(device)
    rpy, feet, x0, table = (torch.as_tensor(a, device=device)
                            for a in (rpy, feet, x0, table))
    k = torch.arange(horizon, dtype=torch.float32, device=device)[:, None]
    drift = torch.zeros(13, dtype=torch.float32, device=device)
    drift[3] = 0.4 * DT_MPC
    x_des = x0[:, None, :] + k[None] * drift
    x_des[..., 9] = 0.4
    a, b = srb.srb_continuous(se3.rpy_to_rotmat(rpy), params.total_inertia,
                              params.total_mass, feet)
    ad, bd = srb.srb_discretize(a, b, DT_MPC)
    weights = torch.tensor(STATE_WEIGHTS, dtype=torch.float32, device=device)
    p, q = condense.condense_cost_structured(a, bd, ad, x0, x_des, weights,
                                             FORCE_WEIGHT, horizon, DT_MPC)
    fz_hi = (table * params.max_force).reshape(batch, horizon * 4)
    prob = ConeQP(p=p, q=q, mu=params.friction_coef.expand(batch),
                  fz_lo=torch.zeros_like(fz_hi), fz_hi=fz_hi)
    return prob, table
