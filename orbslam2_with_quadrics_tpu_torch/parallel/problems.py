"""Synthetic stereo bundle-adjustment problems, drawn from a seed with
numpy (the same problem on any device), for the distributed-BA checks.

- :func:`dryrun_problem`: the reference's ``dryrun_multichip`` problem
  (``__graft_entry__.py:92-171``): 256 cameras x 256 observations = 65,536
  stereo observations of 8,192 points, a small-baseline rig.
- :func:`kitti_problem`: the reference's ``scripts/dist_ba_multihost.py``
  problem (``:30-62``): KITTI intrinsics, random camera / point pairs and
  0.3 px of measurement noise; 64 cameras, 4,096 points and 32,768
  observations by default, and at KITTI-00 scale C = 1,400, P = 140,000,
  O = 5,000,000.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops import ba, camera, lie

KITTI_K = (718.856, 718.856, 607.19, 185.2)
KITTI_BF = 386.1448


def stereo_problem(n_cams: int, n_pts: int, cam_idx, pnt_idx, K, bf: float, pt_lo, pt_hi,
                   pose_sigma, pt_offset: float, noise: float, rng, device) -> ba.BAProblem:
    """Points uniform in the box [pt_lo, pt_hi], poses exp(N(0, pose_sigma)),
    observations the exact stereo projections plus ``noise`` px; the
    solve starts from the true poses and the points moved by ``pt_offset``
    on every axis. Camera 0 is the fixed gauge."""
    pts = rng.uniform(pt_lo, pt_hi, (n_pts, 3)).astype(np.float32)
    xi = (rng.standard_normal((n_cams, 6)) * np.asarray(pose_sigma)).astype(np.float32)
    O = len(cam_idx)

    def t(a, dtype=torch.float32):
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=device)

    poses = lie.se3_exp(t(xi))
    ci, pi = t(cam_idx, torch.int64), t(pnt_idx, torch.int64)
    Kt = t(K)
    uvr, _ = camera.project_stereo(Kt, bf, lie.se3_apply(poses[ci], t(pts)[pi]))
    if noise:
        uvr = uvr + noise * t(rng.standard_normal((O, 3)))
    fixed_cam = np.zeros(n_cams, np.float32)
    fixed_cam[0] = 1.0
    ones = torch.ones(O, device=device)
    return ba.BAProblem(
        poses=poses, points=t(pts + pt_offset), K=Kt, bf=t(bf), cam_idx=ci, pnt_idx=pi,
        uvr=uvr, is_stereo=ones, inv_sigma2=ones.clone(), valid=ones.clone(),
        fixed_cam=t(fixed_cam), fixed_pnt=torch.zeros(n_pts, device=device))


def dryrun_problem(seed: int = 0, device="cuda") -> ba.BAProblem:
    """256 cameras, 256 observations each over 8,192 points (cam-major)."""
    rng = np.random.default_rng(seed)
    C, P, per_cam = 256, 8192, 256
    cam_idx = np.repeat(np.arange(C), per_cam)
    pnt_idx = rng.integers(0, P, C * per_cam)
    return stereo_problem(C, P, cam_idx, pnt_idx, (260.0, 260.0, 160.0, 120.0), 20.0,
                          (-2.0, -1.5, 4.0), (2.0, 1.5, 8.0), [0.01] * 3 + [0.1] * 3,
                          0.01, 0.0, rng, device)


def kitti_problem(n_cams: int = 64, n_pts: int = 4096, n_obs: int = 32768, seed: int = 0,
                  device="cuda") -> ba.BAProblem:
    """KITTI intrinsics and baseline, random observation pairs, 0.3 px noise."""
    rng = np.random.default_rng(seed)
    cam_idx = rng.integers(0, n_cams, n_obs)
    pnt_idx = rng.integers(0, n_pts, n_obs)
    return stereo_problem(n_cams, n_pts, cam_idx, pnt_idx, KITTI_K, KITTI_BF,
                          (-20.0, -5.0, 5.0), (20.0, 5.0, 60.0), [0.01] * 3 + [0.5, 0.1, 0.5],
                          0.05, 0.3, rng, device)


def problem_to_numpy(prob: ba.BAProblem) -> ba.BAProblem:
    """The same problem as numpy arrays (what a spawned rank is sent)."""
    return ba.BAProblem(*(t.cpu().numpy() for t in prob))
