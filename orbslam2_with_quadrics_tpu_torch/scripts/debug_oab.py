"""Focused diagnosis of the out-and-back return-leg match decay.

    python -m orbslam2_with_quadrics_tpu_torch.scripts.debug_oab [frames] [out.json] [--device cuda|cpu]

Runs the mono System on a reduced ``out_and_back`` sequence (320x240, 600
features, 8 levels, 128 / 16,384 slots, loop closing and async global BA
on) and every STRIDE frames reports, from the live map:

- ``n_frustum``: valid points projecting into the current view;
- ``n_reachable``: frustum points observed by >= 1 live keyframe (only these
  can enter the covisibility-vote local map);
- ``n_window``: frustum points inside the top-N covisible window
  (``tracking.select_local_points``, what tracking searches);
- ``matches`` / ``inliers`` of the frame itself, ``kfs_live``, ``pts_live``.

It tells map amnesia (``n_reachable`` collapses: culled keyframes took
their observation rows with them) from matching failure (candidates exist
but are not matched). The counterpart of the reference's
``scripts/debug_oab.py``, with the same configuration and rows.
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from ..models import frontend as fe
from ..models import map_state as ms
from ..models import system as sysm
from ..models import tracking as tr
from ..ops import camera, lie
from ..utils import synthetic

STRIDE = 25
H, W, FX, NF = 240, 320, 260.0, 600


def make_config(device="cuda") -> sysm.SystemConfig:
    return sysm.SystemConfig(
        frontend=fe.FrontendConfig(
            height=H, width=W, n_features=NF, n_levels=8,
            fx=FX, fy=FX, cx=W / 2.0, cy=H / 2.0,
        ),
        map=ms.MapConfig(max_keyframes=128, max_points=16384, n_features=NF, n_levels=8,
                         device=device),
        sensor="mono", max_frames_between_kf=30, kf_idle_frames=3,
        enable_loop_closing=True, async_gba=True, n_local_kf=24,
    )


@torch.no_grad()
def oab_row(slam, frame: int) -> dict:
    """The diagnosis row of ``slam``'s current map and pose (the pipeline
    is drained first)."""
    slam._flush()
    m = slam.map
    fcfg = slam.cfg.frontend
    P = m.pt_pos.shape[0]
    uv, z = camera.project(slam._K, lie.se3_apply(slam.T_cw, m.pt_pos))
    frus = (m.pt_valid & (z > 0.05) & (uv[:, 0] >= 0) & (uv[:, 0] < fcfg.width)
            & (uv[:, 1] >= 0) & (uv[:, 1] < fcfg.height)).cpu().numpy()
    obs = m.kf_obs_point.cpu().numpy()
    kfv = m.kf_valid.cpu().numpy()
    kpv = m.kf_kp_valid.cpu().numpy()
    # points referenced by any live keyframe
    ref = np.zeros(P + 1, bool)
    rows = obs[kfv]
    ref[np.where((rows >= 0) & kpv[kfv], rows, P)] = True
    # the covisible window's union (what tracking searches)
    pt_ids, _ = tr.select_local_points(m, slam.prev_obs, min(slam.cfg.n_local_kf, 128), 4096,
                                       slam._get_obs_A())
    win = np.zeros(P + 1, bool)
    win[pt_ids.cpu().numpy()] = True
    mtr = slam.metrics[-1] if slam.metrics else {}
    return {
        "frame": frame,
        "n_frustum": int(frus.sum()),
        "n_reachable": int((frus & ref[:P]).sum()),
        "n_window": int((frus & win[:P]).sum()),
        "matches": int(mtr.get("matches", -1)),
        "inliers": int(mtr.get("inliers", -1)),
        "kfs_live": int(kfv.sum()),
        "pts_live": int(m.pt_valid.sum()),
    }


def main(frames=800, out=None, device="cuda"):
    cfg = make_config(device)
    slam = sysm.System(cfg)
    stream = synthetic.planar_stream(
        n_frames=frames, h=H, w=W, fx=FX, fy=FX, seed=3,
        motion="out_and_back", plane_half=8.0, relief=True, noise=6.0, tex_size=4000,
    )
    rows = []
    for i, (img, _) in enumerate(stream):
        slam.track_monocular(np.clip(img, 0, 255).astype(np.uint8), timestamp=i / 30.0)
        if i % STRIDE == 0 and slam.state == slam.OK and i > 10:
            rows.append(oab_row(slam, i))
            print(rows[-1], flush=True)
    slam.shutdown()
    if out:
        with open(out, "w") as f:
            json.dump(rows, f, indent=1)
    return rows


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("frames", nargs="?", type=int, default=800)
    ap.add_argument("out", nargs="?", default=None)
    ap.add_argument("--device", default="cuda")
    a = ap.parse_args()
    main(a.frames, a.out, device=a.device)
