"""Per-stage time of the frame hot path, each stage timed in its own loop.

    python -m orbslam2_with_quadrics_tpu_torch.scripts.bench_profile [--device cuda|cpu] [--reps N]

At ``bench.py``'s workload (``common.frame_workload``: 480x640, 1,024
features, 8 levels, an 8,192-point / 64-keyframe map, 8 live keyframes):
the whole frame (extract + ``track_frame``), detection alone, the full
extraction, ``track_frame`` on varying features, ``pose_optimization``
4x5, ``match_by_projection`` at [1024q x 1024t] and [4096q x 1024t], and
``select_local_points``. The counterpart of the reference's
``scripts/bench_profile.py``. Its rules carry over in intent: every timed
call reads inputs that differ from the previous call's (its own image,
features, pose or assignment), and every output is read back after the
clock stops (``common.time_ms``).
"""

from __future__ import annotations

import argparse

import torch

from ..models import frontend as fe
from ..models import tracking as tr
from ..ops import matching, orb, pose_opt
from . import common


def stages(wl: common.FrameWorkload):
    """(name, fn, variants) of each timed stage."""
    cfg, m, dev = wl.cfg, wl.m, wl.device
    P = m.pt_pos.shape[0]
    N = cfg.n_features
    K = common.intrinsics(wl)
    n = len(wl.imgs)
    # a pose and an assignment per call: the identity moved along x in
    # steps of 1e-3, and shifted point ids, so no two calls share their inputs
    poses = [wl.T0 + torch.tensor([0, 0, 0, 0, 1e-3 * i, 0, 0], device=dev) for i in range(n)]
    prevs = [(wl.prev_obs + 7 * i) % P for i in range(n)]
    f0 = wl.feats[0]
    obs_uvr = torch.cat([f0.uv_und, torch.zeros((N, 1), device=dev)], dim=-1)
    ones = torch.ones(N, device=dev)

    def frame(img, T, po):
        return common.track(wl, fe.extract_mono(cfg, img), T, po)

    def detection(img):
        return common.detect(wl, img)

    def extraction(img):
        return orb.extract(img, n_features=N, n_levels=cfg.n_levels)

    def track(f, T, po):
        return common.track(wl, f, T, po)

    def pose(T, uvr):
        return pose_opt.pose_optimization(T, K, 0.0, wl.pts[:N], uvr, torch.zeros(N, device=dev),
                                          ones, ones)

    def match(q, f, T):
        reps = q // N
        return matching.match_by_projection(
            proj_uv=f0.uv_und.repeat(reps, 1) + T[4], proj_valid=torch.ones(q, dtype=torch.bool,
                                                                            device=dev),
            pred_level=torch.zeros(q, dtype=torch.int32, device=dev), query_desc=m.pt_desc[:q],
            query_angle=None, feats_uv=f.uv_und, feats_level=f.level, feats_desc=f.desc,
            feats_angle=f.angle, feats_valid=f.valid, radius=15.0, scale_factors=wl.sf,
            th=matching.TH_HIGH)

    def select(po):
        return tr.select_local_points(m, po, m.kf_valid.shape[0], common.N_LOCAL_PT, wl.obs_A)

    return [
        ("frame = extract + track", frame, list(zip(wl.imgs, poses, prevs))),
        ("extract: detection (uv+score)", detection, [(im,) for im in wl.imgs]),
        ("extract: full (+desc+angle)", extraction, [(im,) for im in wl.imgs]),
        ("track_frame (varying feats)", track, list(zip(wl.feats, poses, prevs))),
        ("pose_optimization 4x5", pose, [(T, obs_uvr + 1e-3 * i) for i, T in enumerate(poses)]),
        (f"match [{N}q x {N}t]", lambda f, T: match(N, f, T), list(zip(wl.feats, poses))),
        (f"match [{4 * N}q x {N}t]", lambda f, T: match(4 * N, f, T), list(zip(wl.feats, poses))),
        ("select_local_points", select, [(po,) for po in prevs]),
    ]


def main(device="cuda", reps: int = 2, workload=None) -> dict:
    """Prints one row per stage; returns {stage name: ms per call}."""
    wl = workload or common.frame_workload(device, n_live_kf=8)
    out = {}
    for name, fn, variants in stages(wl):
        out[name], _ = common.time_ms(fn, variants * reps, device)
        print(common.stage_row(name, out[name], "ms/iter"), flush=True)
    return out


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--reps", type=int, default=2,
                    help="passes over the workload's 8 inputs per timed stage")
    a = ap.parse_args()
    print(f"platform: {common.platform(a.device)}", flush=True)
    with torch.no_grad():
        main(a.device, a.reps)
