"""A handheld sweep over a desk and the wall behind it (the TUM fr1/desk kind).

The camera swings back and forth on an arc in front of the desk, bobbing
in radius and height, and looks at a point that wanders over the desk. The
keyframes sit at equal times along the sweep. The points lie on the desk's
top (the plane y = 0, world y pointing down) and on the wall behind it
(the plane z = ``wall_z_m``). All lengths in metres.
"""

from __future__ import annotations

import math

import torch

from .. import geometry


def _centres(scene: dict, tau: torch.Tensor):
    two_pi = 2.0 * math.pi
    phi = math.radians(float(scene["sweep_deg"])) * torch.sin(two_pi * float(scene["sweeps"]) * tau)
    r = float(scene["radius_m"]) + float(scene["radius_bob_m"]) * torch.sin(two_pi * 3.0 * tau)
    h = float(scene["height_m"]) + float(scene["height_bob_m"]) * torch.sin(two_pi * 2.3 * tau + 1.0)
    C = torch.stack([r * torch.sin(phi), -h, -r * torch.cos(phi)], -1)
    look = torch.stack([0.25 * torch.sin(two_pi * 1.7 * tau), torch.zeros_like(tau),
                        0.15 * torch.cos(two_pi * 1.1 * tau)], -1)
    return C, look


def path_length(scene: dict, device="cpu", dense: int = 100_000) -> float:
    tau = torch.linspace(0.0, 1.0, dense, dtype=torch.float64, device=device)
    C, _ = _centres(scene, tau)
    return float(torch.linalg.norm(C[1:] - C[:-1], dim=-1).sum())


def make(scene: dict, gen: torch.Generator, device):
    """(true poses [K, 7], true points [P, 3]), float64 on ``device``."""
    f64 = torch.float64
    K, P = int(scene["keyframes"]), int(scene["points"])
    tau = torch.linspace(0.0, 1.0, K, dtype=f64, device=device)
    C, look = _centres(scene, tau)
    poses = geometry.pose_from_center(C, look - C)

    def u(n, lo, hi):
        return lo + (hi - lo) * torch.rand(n, dtype=f64, device=device, generator=gen)

    hx, hz = float(scene["desk_m"][0]) / 2, float(scene["desk_m"][1]) / 2
    on_desk = torch.rand(P, dtype=f64, device=device, generator=gen) < float(scene["desk_share"])
    desk = torch.stack([u(P, -hx, hx), torch.zeros(P, dtype=f64, device=device), u(P, -hz, hz)], -1)
    wx = float(scene["wall_width_m"]) / 2
    wall = torch.stack([u(P, -wx, wx), u(P, *scene["wall_y_m"]),
                        torch.full((P,), float(scene["wall_z_m"]), dtype=f64, device=device)], -1)
    return poses, torch.where(on_desk[:, None], desk, wall)
