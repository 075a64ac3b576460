"""The one traffic generator: it reads a traffic file's parameters and
draws the inputs of a run from `--seed`, on the device, with one
torch.Generator there. Both the program and the reference get what it
draws."""

from __future__ import annotations

import math

import torch

GRAVITY = -9.81
# Nominal A1 foot positions in the base frame and the MPC step of the
# cadence problems (solvers/problems.py of the port, whose draws these
# follow: random attitude, perturbed feet, a 0.4 m/s drift, a trot table
# with a per-scenario phase offset pinning half the force triples).
FEET = ((0.17, -0.13, -0.28), (0.17, 0.13, -0.28), (-0.17, -0.13, -0.28),
        (-0.17, 0.13, -0.28))
DT_MPC = 0.03
TROT_PERIOD_S = 0.6


def generator(seed: int, device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(int(seed) % (2 ** 63))
    return g


def _draw(spec, batch: int, g: torch.Generator, device,
          robot_value: float | None = None) -> torch.Tensor:
    """[B] float32 from a number, {"uniform": [lo, hi]}, {"normal": [mean,
    std]} or "robot" (the robot's own value)."""
    if spec == "robot":
        spec = robot_value
    if isinstance(spec, (int, float)):
        return torch.full((batch,), float(spec), dtype=torch.float32,
                          device=device)
    (kind, (a, b)), = spec.items()
    if kind == "uniform":
        u = torch.rand(batch, generator=g, device=device)
        return (a + (b - a) * u).float()
    if kind == "normal":
        return (a + b * torch.randn(batch, generator=g, device=device)).float()
    raise ValueError(f"unknown draw {spec!r}")


def commands(traffic: dict, robot: dict, seed: int, device) -> dict:
    """Per-scenario twist commands: {"vx", "vy", "wz", "body_height"} [B]."""
    g = generator(seed, device)
    spec = traffic["commands"]
    b = traffic["batch"]
    return {key: _draw(spec.get(key, 0.0), b, g, device,
                       robot.get("body_height"))
            for key in ("vx", "vy", "wz", "body_height")}


def cadence_ring(traffic: dict, seed: int, device) -> dict:
    """The update cell's problems: one ensemble drawn from the seed, seen at
    `ring` successive cadence steps t_k = k * cadence_s (the feet sway with
    sin(5 t), the base drifts 0.4 t forward, the trot table advances).
    Returns {"rpy" [R, B, 3], "feet" [R, B, 4, 3], "x0" [R, B, 13],
    "contact" [R, B, H, 4]}."""
    g = generator(seed, device)
    b, h, r = traffic["batch"], traffic["horizon"], traffic["ring"]
    rpy = 0.1 * torch.randn(b, 3, generator=g, device=device)
    feet0 = 0.05 * torch.randn(b, 4, 3, generator=g, device=device) \
        + torch.tensor(FEET, device=device)
    x0 = torch.cat([0.05 * torch.randn(b, 12, generator=g, device=device),
                    torch.full((b, 1), GRAVITY, device=device)], 1)
    offs = torch.rand(b, 1, generator=g, device=device)
    out = {"rpy": [], "feet": [], "x0": [], "contact": []}
    steps = torch.arange(h, device=device, dtype=torch.float32)[None, :]
    for k in range(r):
        t = k * traffic["cadence_s"]
        xk = x0.clone()
        xk[:, 3] += 0.4 * t
        phase = torch.remainder(steps * DT_MPC / TROT_PERIOD_S
                                + t / TROT_PERIOD_S + offs, 1.0)
        diag = (phase < 0.6).float()
        table = torch.stack([diag, 1 - diag, 1 - diag, diag], dim=2)
        table[:, 0, :] = 1.0
        out["rpy"].append(rpy)
        out["feet"].append(feet0 + 0.02 * math.sin(5 * t))
        out["x0"].append(xk)
        out["contact"].append(table)
    return {k: torch.stack(v).float().contiguous() for k, v in out.items()}


def sample(n_total: int, n_pick: int, seed: int) -> list:
    """`n_pick` distinct indices of range(n_total) drawn from the seed
    (all of them where n_total <= n_pick), sorted; the last index is always
    among them."""
    if n_total <= n_pick:
        return list(range(n_total))
    g = torch.Generator().manual_seed((int(seed) + 1) % (2 ** 63))
    rest = torch.randperm(n_total - 1, generator=g)[:n_pick - 1].tolist()
    return sorted(rest + [n_total - 1])
