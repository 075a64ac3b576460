"""One batched MPC update in plain torch ops: the desired trajectory of a
cadence step, SRB matrices at the attitude, exact ZOH, horizon
condensation and the warm-started cone-QP solve (a frozen copy of the
port's `bench.cadence_problem` and its solve on route `loop`)."""

from __future__ import annotations

import torch

from portbench.reference import condense, cone_qp, se3, srb
from portbench.reference import params as params_mod
from portbench.reference.mpc import MpcConfig
from portbench.reference.rollout import _tuples


def build(config: dict, device) -> tuple:
    """(MpcConfig, RobotParams) from a configuration file."""
    return (MpcConfig(**_tuples(config["mpc"])),
            params_mod.from_config(config["robot"], device))


def cadence_problem(cfg: MpcConfig, params, rpy, feet, x0, contact,
                    mu: float = 0.45):
    """The cone QP of one cadence step (no move blocking)."""
    h = cfg.horizon
    b = x0.shape[0]
    dt = cfg.dt_mpc
    k = torch.arange(h, dtype=torch.float32, device=x0.device)[:, None]
    drift = torch.zeros(13, dtype=torch.float32, device=x0.device)
    drift[3] = 0.4 * dt
    x_des = x0[:, None, :] + k[None] * drift
    x_des[..., 9] = 0.4
    a, bm = srb.srb_continuous(se3.rpy_to_rotmat(rpy), params.total_inertia,
                               params.total_mass, feet)
    ad, bd = srb.srb_discretize(a, bm, dt)
    weights = torch.tensor(cfg.state_weights, dtype=torch.float32,
                           device=x0.device)
    p, q = condense.condense_cost_structured(a, bd, ad, x0, x_des, weights,
                                             cfg.force_weight, h, dt)
    fz_hi = (contact * params.max_force).reshape(b, h * 4)
    mu_b = torch.full((b,), mu, dtype=torch.float32, device=x0.device)
    return cone_qp.ConeQP(p=p, q=q, mu=mu_b, fz_lo=torch.zeros_like(fz_hi),
                          fz_hi=fz_hi)


def update(cfg: MpcConfig, params, rpy, feet, x0, contact, x_warm,
           y_warm) -> tuple:
    """(x [B, 12H], y [B, 4H, 5]) of the warm production solve."""
    prob = cadence_problem(cfg, params, rpy, feet, x0, contact)
    sol = cone_qp.solve(prob, iters=cfg.qp_iters, alpha=cfg.qp_alpha,
                        accel_restart=cfg.qp_accel_restart, x0=x_warm,
                        y0=y_warm)
    return sol.x, sol.y
