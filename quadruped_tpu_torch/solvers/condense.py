"""Horizon condensation of the MPC cost (port of quadruped_tpu/solvers/condense.py).

The dense path (`condense_dynamics`, `condense_cost`, `condense_qp` with
the dense cone matrix of `build_cone_constraints`) stacks the horizon's
powers of Ad into Aqp [13H, 13] and the block Toeplitz Bqp [13H, 12H] and
forms P and q from them, as the reference's condensation does; the
solvers never take the dense cone matrix (cone_qp applies the pyramid per
triple). `condense_cost_structured` folds the horizon into
P = 2 (Bqp^T L Bqp + alpha I), q = 2 Bqp^T L (Aqp x0 - Xd) through the SRB
nilpotency: the Toeplitz blocks are linear in the step offset, so P
collapses to four 12x12 matrices combined with static [H, H] coefficient
tables. Move blocking (`move_block_groups`, `reduce_move_blocking`,
`expand_move_blocking`) shares force variables across tail horizon steps,
the long-horizon configuration's way to keep n = 12 G small.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from quadruped_tpu_torch.dynamics.srb import NX, NU
from quadruped_tpu_torch.utils import card
from quadruped_tpu_torch.utils.logging import span

BIG = 1e8
CONE_ROWS = 5  # per leg per step


class CondensedQP(NamedTuple):
    p: torch.Tensor       # [..., 12H, 12H]
    q: torch.Tensor       # [..., 12H]
    a: torch.Tensor       # [..., 5*4*H, 12H] friction constraint matrix
    l: torch.Tensor       # [..., 5*4*H]
    u: torch.Tensor       # [..., 5*4*H]


def horizon_powers(ad: torch.Tensor, horizon: int) -> torch.Tensor:
    """[..., 13, 13] -> [..., H, 13, 13] with entry k = Ad^(k+1)."""
    powers = [ad]
    for _ in range(horizon - 1):
        powers.append(ad @ powers[-1])
    return torch.stack(powers, dim=-3)


def condense_dynamics(ad: torch.Tensor, bd: torch.Tensor, horizon: int):
    """(Aqp [..., 13H, 13], Bqp [..., 13H, 12H]) from one-step (Ad, Bd):
    Bqp[k, j] = Ad^(k-j) Bd for j <= k (block lower-triangular Toeplitz)."""
    batch = ad.shape[:-2]
    powers = horizon_powers(ad, horizon)
    aqp = powers.reshape(batch + (horizon * NX, NX))
    eye = torch.eye(NX, dtype=ad.dtype, device=ad.device) \
        .expand(batch + (1, NX, NX))
    pow0 = torch.cat([eye, powers[..., :horizon - 1, :, :]], dim=-3)
    blocks = torch.einsum("...dij,...jk->...dik", pow0, bd)  # Ad^d Bd
    zero_block = torch.zeros_like(blocks[..., 0, :, :])
    rows = [torch.cat([blocks[..., k - j, :, :] if j <= k else zero_block
                       for j in range(horizon)], dim=-1)
            for k in range(horizon)]
    return aqp, torch.cat(rows, dim=-2)


def cone_constraint_pattern(dtype=torch.float32, device=None) -> torch.Tensor:
    """Static [5, 3] friction-pyramid row pattern of one (step, leg), mu
    placeholders 1 (scaled by mu at build time); on the card unless
    `device` says otherwise."""
    return torch.tensor([[1.0, 0.0, 1.0],     # fx + mu fz in [0, BIG]
                         [-1.0, 0.0, 1.0],    # -fx + mu fz in [0, BIG]
                         [0.0, 1.0, 1.0],     # fy + mu fz in [0, BIG]
                         [0.0, -1.0, 1.0],    # -fy + mu fz in [0, BIG]
                         [0.0, 0.0, 1.0]],    # fz in [fz_min, contact fmax]
                        dtype=dtype, device=card.resolve(device))


def build_cone_constraints(mu: torch.Tensor, fmax: torch.Tensor,
                           contact_table: torch.Tensor, horizon: int,
                           fz_min: float = 0.0):
    """Dense block-diagonal cone matrix A [..., 20H, 12H] and bounds l, u
    [..., 20H] from mu [...], the per-leg max vertical force fmax [...]
    and the contact table [..., H, 4] (1 stance, 0 swing: fz capped at 0)."""
    batch = contact_table.shape[:-2]
    dtype, device = contact_table.dtype, contact_table.device
    pat = cone_constraint_pattern(dtype, device)
    pat[:4, 2] = 0.0                        # the mu column, filled below
    mu_b = torch.as_tensor(mu, dtype=dtype, device=device) \
        .expand(batch)[..., None, None, None, None]
    mu_col = torch.tensor([1.0, 1.0, 1.0, 1.0, 0.0], dtype=dtype,
                          device=device)[:, None] \
        * torch.tensor([0.0, 0.0, 1.0], dtype=dtype, device=device)
    blocks = pat.expand(batch + (horizon, 4, CONE_ROWS, 3)) + mu_b * mu_col
    n_forces = horizon * 4
    blocks_flat = blocks.reshape(batch + (n_forces, CONE_ROWS, 3))
    eye = torch.eye(n_forces, dtype=dtype, device=device)
    a = torch.einsum("...frc,fg->...frgc", blocks_flat, eye) \
        .reshape(batch + (n_forces * CONE_ROWS, n_forces * 3))
    contact = contact_table.reshape(batch + (n_forces,))
    zero = torch.zeros_like(contact)
    big = torch.full_like(contact, BIG)
    fmax_b = torch.as_tensor(fmax, dtype=dtype, device=device) \
        .expand(batch)[..., None]
    lower = torch.stack([zero, zero, zero, zero,
                         torch.full_like(contact, fz_min) * contact], dim=-1)
    upper = torch.stack([big, big, big, big, contact * fmax_b], dim=-1)
    return (a, lower.reshape(batch + (n_forces * CONE_ROWS,)),
            upper.reshape(batch + (n_forces * CONE_ROWS,)))


def _coefficient_tables(horizon: int) -> np.ndarray:
    """[4, H, H]: sums over k from max(i, j) to H-1 of 1, (k-i), (k-j),
    (k-i)(k-j)."""
    coefs = np.zeros((4, horizon, horizon), np.float32)
    for i in range(horizon):
        for j in range(horizon):
            ks = np.arange(max(i, j), horizon)
            coefs[:, i, j] = (len(ks), np.sum(ks - i), np.sum(ks - j),
                              np.sum((ks - i) * (ks - j)))
    return coefs


def _reverse_cumsum(x: torch.Tensor, dim: int) -> torch.Tensor:
    return torch.flip(torch.cumsum(torch.flip(x, [dim]), dim), [dim])


def condense_cost_structured(a_ct, bd, ad, x0, x_des, state_weights,
                             force_weight, horizon: int, dt: float):
    """(P [..., 12H, 12H], q [..., 12H]) from the continuous A, the discrete
    (Ad, Bd), x0 [..., 13], x_des [..., H, 13] and the [13] state weights."""
    with span("qtpu.condense"):
        batch = x0.shape[:-1]
        dtype, device = bd.dtype, bd.device
        lw = state_weights

        c_mat = dt * torch.einsum("...ij,...jk->...ik", a_ct, bd)
        lb = lw[..., :, None] * bd
        lc = lw[..., :, None] * c_mat
        bt_lb = torch.einsum("...ji,...jk->...ik", bd, lb)
        bt_lc = torch.einsum("...ji,...jk->...ik", bd, lc)
        ct_lb = bt_lc.transpose(-1, -2)
        ct_lc = torch.einsum("...ji,...jk->...ik", c_mat, lc)

        coefs = torch.as_tensor(_coefficient_tables(horizon), dtype=dtype,
                                device=device)
        xs = torch.stack([bt_lb, ct_lb, bt_lc, ct_lc], dim=-3)
        p_blocks = torch.einsum("mhk,...mij->...hikj", coefs, xs)
        p = 2.0 * p_blocks.reshape(batch + (horizon * NU, horizon * NU))
        p = p + (2.0 * force_weight) * torch.eye(horizon * NU, dtype=dtype,
                                                 device=device)

        m_mat = ad - torch.eye(NX, dtype=dtype, device=device)
        a2dt2 = torch.einsum("...ij,...jk->...ik", a_ct, a_ct) * (dt * dt)
        mx = torch.einsum("...ij,...j->...i", m_mat, x0)
        a2x = torch.einsum("...ij,...j->...i", a2dt2, x0)
        k = torch.arange(1, horizon + 1, dtype=dtype, device=device)
        comb = k * (k - 1) * 0.5
        xk = (x0[..., None, :] + k[:, None] * mx[..., None, :]
              + comb[:, None] * a2x[..., None, :])
        resid = lw * (xk - x_des)

        rc0 = _reverse_cumsum(resid, -2)
        kr = torch.arange(horizon, dtype=dtype, device=device)[:, None] * resid
        rc1k = _reverse_cumsum(kr, -2)
        jj = torch.arange(horizon, dtype=dtype, device=device)[:, None]
        s1 = rc1k - jj * rc0
        qb = torch.einsum("...ji,...hj->...hi", bd, rc0)
        qc = torch.einsum("...ji,...hj->...hi", c_mat, s1)
        qvec = 2.0 * (qb + qc).reshape(batch + (horizon * NU,))
        return p, qvec


def condense_cost(ad, bd, x0, x_des, state_weights, force_weight,
                  horizon: int):
    """Cost-only dense condensation: (P [..., 12H, 12H], q [..., 12H]) from
    (Ad [..., 13, 13], Bd [..., 13, 12]), x0 [..., 13], x_des [..., H, 13]
    and the [13] state weights L: P = 2 (Bqp^T L Bqp + alpha I),
    q = 2 Bqp^T L (Aqp x0 - Xd). Equal to `condense_cost_structured` to
    float32 roundoff."""
    batch = x0.shape[:-1]
    aqp, bqp = condense_dynamics(ad, bd, horizon)
    lw = state_weights.repeat(horizon)
    lbqp = lw[..., :, None] * bqp
    p = 2.0 * (bqp.transpose(-1, -2) @ lbqp
               + force_weight * torch.eye(horizon * NU, dtype=bqp.dtype,
                                          device=bqp.device))
    xd = x_des.reshape(batch + (horizon * NX,))
    resid = torch.einsum("...ij,...j->...i", aqp, x0) - xd
    return p, 2.0 * torch.einsum("...ji,...j->...i", lbqp, resid)


def condense_qp(ad, bd, x0, x_des, state_weights, force_weight, mu, fmax,
                contact_table, horizon: int) -> CondensedQP:
    """The full condensed QP: the dense cost and the dense cone rows."""
    p, q = condense_cost(ad, bd, x0, x_des, state_weights, force_weight,
                         horizon)
    a, l, u = build_cone_constraints(mu, fmax, contact_table, horizon)
    return CondensedQP(p=p, q=q, a=a, l=l, u=u)


# ---------------------------------------------------------------------------
# Move blocking: share force variables across tail horizon steps.
# ---------------------------------------------------------------------------

def move_block_groups(horizon: int, head: int, block: int):
    """Static step -> group map: `head` individual steps, then groups of
    `block` (the last one possibly shorter). Returns (groups [H] numpy
    int array, n_groups)."""
    groups = []
    g = 0
    k = 0
    while k < horizon:
        n = 1 if k < head else min(block, horizon - k)
        groups.extend([g] * n)
        g += 1
        k += n
    return np.asarray(groups), g


def _expansion(groups: np.ndarray, n_groups: int, like: torch.Tensor):
    """[H, G] one-hot step -> group map E."""
    return torch.as_tensor(np.eye(n_groups, dtype=np.float32)[groups],
                           dtype=like.dtype, device=like.device)


def reduce_move_blocking(p: torch.Tensor, q: torch.Tensor,
                         fz_hi: torch.Tensor, groups: np.ndarray,
                         n_groups: int, horizon: int):
    """(P [B, 12H, 12H], q [B, 12H], fz_hi [B, 4H]) of the full condensed QP
    -> the blocked QP ([B, 12G, 12G], [B, 12G], [B, 4G]).

    With U = E u (E the per-step one-hot expansion), P_r = E^T P E and
    q_r = E^T q, as [H, G] contractions over the step axes. A shared triple
    takes the MIN fz_hi over its group's steps: feasible for every covered
    step (a group straddling a contact flip pins its force)."""
    b = p.shape[0]
    e = _expansion(groups, n_groups, p)
    p4 = p.reshape(b, horizon, NU, horizon, NU)
    p_r = torch.einsum("hg,bhiwj,wk->bgikj", e, p4, e) \
        .reshape(b, NU * n_groups, NU * n_groups)
    q_r = torch.einsum("hg,bhi->bgi", e, q.reshape(b, horizon, NU)) \
        .reshape(b, NU * n_groups)
    fz_r = group_min(fz_hi.reshape(b, horizon, 4), groups, n_groups)
    return p_r, q_r, fz_r.reshape(b, 4 * n_groups)


def group_min(v: torch.Tensor, groups: np.ndarray,
              n_groups: int) -> torch.Tensor:
    """Per-step values [B, H, k] -> per-group [B, G, k]: the minimum over
    the steps each group covers."""
    covers = _expansion(groups, n_groups, v).T[:, :, None] > 0.5  # [G, H, 1]
    return torch.amin(torch.where(covers, v[:, None], torch.inf), dim=2)


def expand_move_blocking(u_r: torch.Tensor, groups: np.ndarray,
                         horizon: int) -> torch.Tensor:
    """Reduced solution [B, 12G] -> full [B, 12H] (U = E u)."""
    b = u_r.shape[0]
    idx = torch.as_tensor(groups, device=u_r.device)
    return u_r.reshape(b, -1, NU)[:, idx].reshape(b, NU * horizon)
