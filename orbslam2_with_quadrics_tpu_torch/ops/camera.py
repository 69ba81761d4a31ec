"""Pinhole camera model: projection, undistortion, DLT triangulation.

Counterpart of the reference's ``ops/camera.py``. Intrinsics are a 4-vector
``[fx, fy, cx, cy]``; distortion a 5-vector ``[k1, k2, p1, p2, k3]``.
Everything broadcasts over leading batch dims.
"""

from __future__ import annotations

import torch

from . import lie


def project(K, p_cam):
    """Camera-frame 3D point -> pixel. Returns (uv[...,2], z[...])."""
    fx, fy, cx, cy = K[..., 0], K[..., 1], K[..., 2], K[..., 3]
    z = p_cam[..., 2]
    zs = torch.where(torch.abs(z) < 1e-8, 1e-8, z)
    u = fx * p_cam[..., 0] / zs + cx
    v = fy * p_cam[..., 1] / zs + cy
    return torch.stack([u, v], dim=-1), z


def project_stereo(K, baseline_fx, p_cam):
    """Stereo projection -> ((u_l, v_l, u_r) [...,3], z). ``baseline_fx`` is
    fx * baseline (the ``bf`` of a stereo camera)."""
    uv, z = project(K, p_cam)
    zs = torch.where(torch.abs(z) < 1e-8, 1e-8, z)
    ur = uv[..., 0] - baseline_fx / zs
    return torch.cat([uv, ur[..., None]], dim=-1), z


def backproject(K, uv, z):
    """Pixel + depth -> camera-frame 3D point."""
    fx, fy, cx, cy = K[..., 0], K[..., 1], K[..., 2], K[..., 3]
    x = (uv[..., 0] - cx) * z / fx
    y = (uv[..., 1] - cy) * z / fy
    return torch.stack([x, y, z], dim=-1)


def distort_normalized(dist, xn):
    """Apply radial-tangential distortion to normalized coords [..., 2]."""
    k1, k2, p1, p2, k3 = (dist[..., i] for i in range(5))
    x, y = xn[..., 0], xn[..., 1]
    r2 = x * x + y * y
    radial = 1.0 + r2 * (k1 + r2 * (k2 + r2 * k3))
    xd = x * radial + 2.0 * p1 * x * y + p2 * (r2 + 2.0 * x * x)
    yd = y * radial + p1 * (r2 + 2.0 * y * y) + 2.0 * p2 * x * y
    return torch.stack([xd, yd], dim=-1)


def undistort_points(K, dist, uv, iters: int = 5):
    """Undistort pixel keypoints (fixed-point inverse of the distortion
    model, OpenCV-compatible)."""
    fx, fy, cx, cy = K[..., 0], K[..., 1], K[..., 2], K[..., 3]
    xd = torch.stack([(uv[..., 0] - cx) / fx, (uv[..., 1] - cy) / fy], dim=-1)
    x = xd
    for _ in range(iters):
        x = xd - (distort_normalized(dist, x) - x)
    return torch.stack([x[..., 0] * fx + cx, x[..., 1] * fy + cy], dim=-1)


def triangulate_dlt(P1, P2, uv1, uv2):
    """Two-view DLT triangulation. P1,P2: [...,3,4] projection matrices,
    uv1/uv2: [...,2] pixels. Returns [...,3] points."""
    rows = torch.stack(
        torch.broadcast_tensors(
            uv1[..., 0, None] * P1[..., 2, :] - P1[..., 0, :],
            uv1[..., 1, None] * P1[..., 2, :] - P1[..., 1, :],
            uv2[..., 0, None] * P2[..., 2, :] - P2[..., 0, :],
            uv2[..., 1, None] * P2[..., 2, :] - P2[..., 1, :],
        ),
        dim=-2,
    )  # [...,4,4]
    # row-normalize for f32 conditioning (pixel-scale rows are ~1e3)
    rows = rows / torch.clamp(torch.linalg.norm(rows, dim=-1, keepdim=True), min=1e-12)
    _, _, vt = torch.linalg.svd(rows)
    Xh = vt[..., 3, :]
    w = Xh[..., 3]
    ws = torch.where(torch.abs(w) < 1e-10, 1e-10, w)
    return Xh[..., :3] / ws[..., None]


def projection_matrix(T_cw, K):
    """Pose + intrinsics -> [...,3,4] projection matrix K [R|t]."""
    M = lie.se3_to_matrix(T_cw)[..., :3, :]
    fx, fy, cx, cy = K[..., 0], K[..., 1], K[..., 2], K[..., 3]
    zeros = torch.zeros_like(fx)
    ones = torch.ones_like(fx)
    Km = torch.stack(
        [fx, zeros, cx, zeros, fy, cy, zeros, zeros, ones], dim=-1
    ).reshape(fx.shape + (3, 3))
    return Km @ M
