"""Trajectory export in the TUM and KITTI formats (numpy).

Counterpart of the reference's ``utils/trajectory.py``, byte for byte: the
files are those of the original system's savers (``SaveTrajectoryTUM``,
``SaveKeyFrameTrajectoryTUM``, ``SaveTrajectoryKITTI``), so the standard
evaluation tools read them unchanged.
"""

from __future__ import annotations

import numpy as np


def _Tcw_to_Twc(T):
    R = T[:3, :3]
    t = T[:3, 3]
    Rwc = R.T
    twc = -R.T @ t
    return Rwc, twc


def _R_to_quat(R):
    """Rotation matrix -> (qx, qy, qz, qw), TUM order."""
    tr = np.trace(R)
    if tr > 0:
        s = np.sqrt(tr + 1.0) * 2
        qw = 0.25 * s
        qx = (R[2, 1] - R[1, 2]) / s
        qy = (R[0, 2] - R[2, 0]) / s
        qz = (R[1, 0] - R[0, 1]) / s
    else:
        i = int(np.argmax(np.diag(R)))
        if i == 0:
            s = np.sqrt(1.0 + R[0, 0] - R[1, 1] - R[2, 2]) * 2
            qw = (R[2, 1] - R[1, 2]) / s
            qx = 0.25 * s
            qy = (R[0, 1] + R[1, 0]) / s
            qz = (R[0, 2] + R[2, 0]) / s
        elif i == 1:
            s = np.sqrt(1.0 - R[0, 0] + R[1, 1] - R[2, 2]) * 2
            qw = (R[0, 2] - R[2, 0]) / s
            qx = (R[0, 1] + R[1, 0]) / s
            qy = 0.25 * s
            qz = (R[1, 2] + R[2, 1]) / s
        else:
            s = np.sqrt(1.0 - R[0, 0] - R[1, 1] + R[2, 2]) * 2
            qw = (R[1, 0] - R[0, 1]) / s
            qx = (R[0, 2] + R[2, 0]) / s
            qy = (R[1, 2] + R[2, 1]) / s
            qz = 0.25 * s
    return qx, qy, qz, qw


def save_tum(path: str, items):
    """items: iterable of (timestamp, T_cw 4x4). Writes
    'ts tx ty tz qx qy qz qw' (the camera's pose in the world) per frame."""
    with open(path, "w") as f:
        for ts, T in items:
            Rwc, twc = _Tcw_to_Twc(np.asarray(T))
            qx, qy, qz, qw = _R_to_quat(Rwc)
            f.write(
                f"{ts:.6f} {twc[0]:.7f} {twc[1]:.7f} {twc[2]:.7f} "
                f"{qx:.7f} {qy:.7f} {qz:.7f} {qw:.7f}\n"
            )


def save_kitti(path: str, items):
    """items: iterable of (timestamp, T_cw 4x4). Writes the 3x4 T_wc
    row-major per line."""
    with open(path, "w") as f:
        for _, T in items:
            Rwc, twc = _Tcw_to_Twc(np.asarray(T))
            M = np.concatenate([Rwc, twc[:, None]], axis=1)
            f.write(" ".join(f"{x:.9e}" for x in M.reshape(-1)) + "\n")
