"""End-to-end smoke drive: mono SLAM on a synthetic planar sequence.

    python -m orbslam2_with_quadrics_tpu_torch.scripts.smoke_mono [n_frames] [--device cuda|cpu]

Prints per-frame tracking state and the final ATE RMSE against the ground
truth; PASS when it is under 5% of the trajectory's span (exit code 0).
"""

from __future__ import annotations

import argparse
import time

import numpy as np

from ..models import frontend as fe
from ..models import map_state as ms
from ..models import system as sysm
from ..utils import metrics, synthetic


def main(n_frames=30, h=240, w=320, device="cuda"):
    imgs, poses_gt, K = synthetic.planar_sequence(
        n_frames=n_frames, h=h, w=w, fx=260.0, fy=260.0, seed=3)
    cfg = sysm.SystemConfig(
        frontend=fe.FrontendConfig(
            height=h, width=w, n_features=512, n_levels=4,
            fx=float(K[0]), fy=float(K[1]), cx=float(K[2]), cy=float(K[3])),
        map=ms.MapConfig(max_keyframes=32, max_points=4096, n_features=512, n_levels=4,
                         device=device),
        max_frames_between_kf=10,
    )
    slam = sysm.System(cfg)
    t0 = time.time()
    for i in range(n_frames):
        slam.track_monocular(imgs[i], timestamp=i / 30.0)
        st = {0: "INIT", 1: "OK", 2: "LOST"}[slam.state]
        if i % 5 == 0 or st != "OK":
            inl = slam.metrics[-1]["inliers"] if slam.metrics else -1
            print(f"frame {i:3d} state={st} kfs={int(slam.map.n_kf)} "
                  f"pts={int(slam.map.n_pt)} inliers={inl} t={time.time() - t0:.1f}s",
                  flush=True)
    est, gt = [], []
    for fid, _, T7 in slam.full_trajectory():
        est.append(metrics.se3_vec_to_mat(T7))
        gt.append(poses_gt[fid])
    if len(est) < 10:
        print("FAIL: tracked <10 frames")
        return 1
    c_est, c_gt = metrics.camera_centers_from_Tcw(est), metrics.camera_centers_from_Tcw(gt)
    ate = metrics.ate_rmse(c_est, c_gt)
    span = np.linalg.norm(c_gt.max(0) - c_gt.min(0))
    print(f"tracked {len(est)}/{n_frames} frames  ATE RMSE={ate:.4f} (span {span:.2f})")
    ok = ate < 0.05 * span
    print("PASS" if ok else "FAIL")
    return 0 if ok else 1


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("n_frames", nargs="?", type=int, default=30)
    ap.add_argument("--device", default="cuda")
    a = ap.parse_args()
    raise SystemExit(main(a.n_frames, device=a.device))
