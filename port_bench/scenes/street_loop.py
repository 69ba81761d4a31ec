"""A closed drive through a street corridor (the KITTI odometry kind).

The path is a superellipse (``|x/a|^p + |z/b|^p = 1``) scaled to
``length_m``, at the camera's height; the keyframes sit at equal arc
lengths along it and look along its tangent. The points lie in a corridor
around it: on the road (``ground``) and on two facades (``facade``), at
arc lengths drawn uniformly. World axes: y points down, the road is the
plane y = ``camera_height_m``.
"""

from __future__ import annotations

import math

import torch

from .. import geometry


def _path(scene: dict, s: torch.Tensor, dense: int = 200_000):
    """Positions [.., 3] and unit tangents at arc lengths ``s`` (metres)."""
    dev, f64 = s.device, torch.float64
    p = float(scene["corner_power"])
    phi = torch.linspace(0.0, 2.0 * math.pi, dense + 1, dtype=f64, device=dev)
    c, n = torch.cos(phi), torch.sin(phi)
    xz = torch.stack([torch.sign(c) * torch.abs(c) ** (2.0 / p),
                      float(scene["aspect"]) * torch.sign(n) * torch.abs(n) ** (2.0 / p)], -1)
    seg = torch.linalg.norm(xz[1:] - xz[:-1], dim=-1)
    arc = torch.cat([torch.zeros(1, dtype=f64, device=dev), torch.cumsum(seg, 0)])
    xz = xz * (float(scene["length_m"]) / float(arc[-1]))
    arc = arc * (float(scene["length_m"]) / float(arc[-1]))
    s = torch.remainder(s, arc[-1])
    i = torch.clamp(torch.searchsorted(arc, s, right=True) - 1, 0, dense - 1)
    w = ((s - arc[i]) / (arc[i + 1] - arc[i]))[..., None]
    pos2 = xz[i] * (1 - w) + xz[i + 1] * w
    tan2 = xz[i + 1] - xz[i]
    tan2 = tan2 / torch.linalg.norm(tan2, dim=-1, keepdim=True)
    zero = torch.zeros_like(s)
    return (torch.stack([pos2[..., 0], zero, pos2[..., 1]], -1),
            torch.stack([tan2[..., 0], zero, tan2[..., 1]], -1))


def make(scene: dict, gen: torch.Generator, device):
    """(true poses [K, 7], true points [P, 3]), float64 on ``device``."""
    f64 = torch.float64
    L = float(scene["length_m"])
    K, P = int(scene["keyframes"]), int(scene["points"])

    s_kf = torch.arange(K, dtype=f64, device=device) * (L / K)
    C, fwd = _path(scene, s_kf)
    poses = geometry.pose_from_center(C, fwd)

    def u(n, lo, hi):
        return lo + (hi - lo) * torch.rand(n, dtype=f64, device=device, generator=gen)

    s_pt = u(P, 0.0, L)
    base, tan = _path(scene, s_pt)
    right = torch.stack([tan[:, 2], torch.zeros_like(tan[:, 0]), -tan[:, 0]], -1)
    ground = torch.rand(P, dtype=f64, device=device, generator=gen) < float(scene["ground_share"])
    side = torch.where(torch.rand(P, dtype=f64, device=device, generator=gen) < 0.5, -1.0, 1.0)
    g_lat = u(P, -1.0, 1.0) * float(scene["road_half_width_m"])
    f_lat = side * u(P, *scene["facade_offset_m"])
    lateral = torch.where(ground, g_lat, f_lat)
    h = float(scene["camera_height_m"])
    height = torch.where(ground, torch.full_like(s_pt, h), u(P, *scene["facade_y_m"]))
    pts = base + lateral[:, None] * right
    pts[:, 1] = height
    return poses, pts
