"""Stereo end-to-end smoke drive, at 320x240 or at the KITTI size.

    python -m orbslam2_with_quadrics_tpu_torch.scripts.smoke_stereo [n_frames] \
        [--kitti-scale] [--device cuda|cpu]

Default: a 320x240 quick check. ``--kitti-scale`` runs 1226x370 with 2048
features (the original system's KITTI00-02.yaml workload). PASS when the
metric ATE (no scale alignment) is under 0.15 (exit code 0).
"""

from __future__ import annotations

import argparse
import time

from ..models import frontend as fe
from ..models import map_state as ms
from ..models import system as sysm
from ..utils import metrics, synthetic


def main(n_frames=16, kitti_scale=False, device="cuda"):
    if kitti_scale:
        H, W, FX, NF, NL = 370, 1226, 718.9, 2048, 8
        pools = (128, 32768)
    else:
        H, W, FX, NF, NL = 240, 320, 260.0, 512, 4
        pools = (32, 8192)
    b = 0.2
    imgs_l, imgs_r, poses_gt, _ = synthetic.planar_sequence_stereo(
        n_frames=n_frames, h=H, w=W, fx=FX, fy=FX, baseline=b, seed=5)
    cfg = sysm.SystemConfig(
        frontend=fe.FrontendConfig(height=H, width=W, n_features=NF, n_levels=NL,
                                   fx=FX, fy=FX, cx=W / 2, cy=H / 2, bf=b * FX),
        map=ms.MapConfig(max_keyframes=pools[0], max_points=pools[1], n_features=NF,
                         n_levels=NL, device=device),
        sensor="stereo",
        max_frames_between_kf=5,
    )
    slam = sysm.System(cfg)
    t0 = time.time()
    for i in range(n_frames):
        slam.track_stereo(imgs_l[i], imgs_r[i], timestamp=i / 10.0)
        if i % 4 == 0:
            print(f"frame {i} state={slam.state} kfs={int(slam.map.n_kf)} "
                  f"pts={int(slam.map.n_pt)} t={time.time() - t0:.1f}s", flush=True)
    traj = slam.full_trajectory()
    est = [metrics.se3_vec_to_mat(T7) for _, _, T7 in traj]
    gt = [poses_gt[fid] for fid, _, _ in traj]
    ate = metrics.ate_rmse(metrics.camera_centers_from_Tcw(est),
                           metrics.camera_centers_from_Tcw(gt), with_scale=False)
    print(f"stereo ATE (metric, no scale align): {ate:.4f}")
    ok = ate < 0.15
    print("PASS" if ok else "FAIL")
    return 0 if ok else 1


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("n_frames", nargs="?", type=int, default=16)
    ap.add_argument("--kitti-scale", action="store_true")
    ap.add_argument("--device", default="cuda")
    a = ap.parse_args()
    raise SystemExit(main(a.n_frames, a.kitti_scale, a.device))
