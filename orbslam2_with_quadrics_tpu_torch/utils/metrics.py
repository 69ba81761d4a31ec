"""Trajectory evaluation: Umeyama alignment + ATE RMSE (numpy only).

Same functions as the reference package's ``utils/metrics.py``, carried
here so that the port and its GPU smoke run need no JAX.
"""

from __future__ import annotations

import numpy as np


def umeyama_align(src: np.ndarray, dst: np.ndarray, with_scale: bool = True):
    """Least-squares similarity transform aligning src -> dst ([N,3] each).

    Returns (s, R, t) with dst ~ s * R @ src + t.
    """
    mu_s = src.mean(0)
    mu_d = dst.mean(0)
    xs = src - mu_s
    xd = dst - mu_d
    cov = xd.T @ xs / len(src)
    U, D, Vt = np.linalg.svd(cov)
    S = np.eye(3)
    if np.linalg.det(U) * np.linalg.det(Vt) < 0:
        S[2, 2] = -1
    R = U @ S @ Vt
    if with_scale:
        var_s = (xs ** 2).sum() / len(src)
        s = np.trace(np.diag(D) @ S) / max(var_s, 1e-12)
    else:
        s = 1.0
    t = mu_d - s * R @ mu_s
    return s, R, t


def ate_rmse(
    est_positions: np.ndarray, gt_positions: np.ndarray, with_scale: bool = True
) -> float:
    """Absolute trajectory error RMSE after Sim3 (mono) or SE3 alignment."""
    s, R, t = umeyama_align(est_positions, gt_positions, with_scale)
    aligned = (s * (R @ est_positions.T)).T + t
    err = np.linalg.norm(aligned - gt_positions, axis=1)
    return float(np.sqrt((err ** 2).mean()))


def camera_centers_from_Tcw(T_list) -> np.ndarray:
    """[N,3] camera centers from 4x4 T_cw matrices."""
    out = []
    for T in T_list:
        R = T[:3, :3]
        t = T[:3, 3]
        out.append(-R.T @ t)
    return np.stack(out)


def se3_vec_to_mat(T7: np.ndarray) -> np.ndarray:
    """[7] quat+trans -> 4x4 (host-side, numpy)."""
    w, x, y, z = T7[:4]
    R = np.array(
        [
            [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
            [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
            [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
        ]
    )
    M = np.eye(4)
    M[:3, :3] = R
    M[:3, 3] = T7[4:7]
    return M
