"""Reprojection residuals and analytic Jacobians, batched over edges.

Counterpart of the reference's ``ops/residuals.py`` (g2o's projection edge
types). One 3-row residual covers mono and stereo: row 2 (the right-image
column u_r) is weight-masked out for mono observations. Where the reference
writes one edge and ``vmap``s it, these functions take a leading edge
dimension. Error convention ``e = obs - pred``; tangent ``[omega, upsilon]``.
"""

from __future__ import annotations

import torch

from . import lie

# chi2 gates at 95%: 2-dof (mono) and 3-dof (stereo)
CHI2_MONO = 5.991
CHI2_STEREO = 7.815


def huber_weight(chi2, delta2):
    """IRLS weight of the Huber kernel: 1 inside, delta/|e| outside."""
    return torch.where(
        chi2 <= delta2, 1.0, torch.sqrt(delta2 / torch.clamp(chi2, min=1e-12))
    )


def _dpred_dpc(x, y, iz, K, bf):
    """[O,3,3] d(u, v, u_r)/d(camera-frame point)."""
    iz2 = iz * iz
    fx, fy = K[0], K[1]
    zero = torch.zeros_like(iz)
    du = torch.stack([fx * iz, zero, -fx * x * iz2], dim=-1)
    dv = torch.stack([zero, fy * iz, -fy * y * iz2], dim=-1)
    dur = du + torch.stack([zero, zero, bf * iz2], dim=-1)
    return torch.stack([du, dv, dur], dim=-2)


def residual_and_jacobians(T_cw, K, bf, p_world, obs_uvr):
    """Residual + analytic Jacobians for O (pose, point, obs) triples.

    Args: T_cw [O,7], K [4], bf scalar, p_world [O,3], obs_uvr [O,3].
    Returns: e [O,3], Jc [O,3,6] (d e / d pose tangent), Jp [O,3,3]
    (d e / d p_world), z [O] camera-frame depth.
    """
    pc = lie.se3_apply(T_cw, p_world)
    x, y, z = pc[..., 0], pc[..., 1], pc[..., 2]
    zs = torch.where(torch.abs(z) < 1e-6, 1e-6, z)
    iz = 1.0 / zs
    u = K[0] * x * iz + K[2]
    v = K[1] * y * iz + K[3]
    ur = u - bf * iz
    e = obs_uvr - torch.stack([u, v, ur], dim=-1)
    dpred = _dpred_dpc(x, y, iz, K, bf)
    eye = torch.eye(3, dtype=pc.dtype, device=pc.device).expand(pc.shape[:-1] + (3, 3))
    dpc_dxi = torch.cat([-lie.hat(pc), eye], dim=-1)          # [O,3,6]
    Jc = -dpred @ dpc_dxi
    Jp = -dpred @ lie.quat_to_matrix(lie.se3_quat(T_cw))
    return e, Jc, Jp, z


def residual_only(T_cw, K, bf, p_world, obs_uvr):
    """Residual + depth without Jacobians (cost-only evaluations)."""
    pc = lie.se3_apply(T_cw, p_world)
    x, y, z = pc[..., 0], pc[..., 1], pc[..., 2]
    zs = torch.where(torch.abs(z) < 1e-6, 1e-6, z)
    iz = 1.0 / zs
    u = K[0] * x * iz + K[2]
    v = K[1] * y * iz + K[3]
    return obs_uvr - torch.stack([u, v, u - bf * iz], dim=-1), z


def chi2_of(e, is_stereo, inv_sigma2):
    """Per-observation chi2 with the stereo row masked off for mono."""
    row_w = torch.stack(
        [torch.ones_like(e[..., 0]), torch.ones_like(e[..., 0]), is_stereo], dim=-1
    )
    return torch.sum(e * e * row_w, dim=-1) * inv_sigma2
