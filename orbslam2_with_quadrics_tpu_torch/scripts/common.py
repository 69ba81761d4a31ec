"""What the port's measuring tools share: timing on the card or the CPU,
and the frame-step workload of ``profile_track`` and ``bench_profile``.

Timing (:func:`time_ms`): every timed call reads its own inputs (a list of
argument tuples that differ from one call to the next), and every output is
kept and read after the clock stops, so no call can be skipped or reuse an
earlier result. On the card the calls are timed between two CUDA events
after a ``torch.cuda.synchronize()``; on the CPU by the host's clock.

The frame workload (:func:`frame_workload`) is ``bench.py``'s: 480x640
random images, 1,024 features, 8 levels, an 8,192-point / 64-keyframe-slot
map with random positions and descriptors (the reference's
``scripts/bench_profile.py:57-100`` and ``scripts/profile_track.py:37-80``),
drawn from a numpy ``RandomState`` so that it is the same on any device.
"""

from __future__ import annotations

import time
from typing import NamedTuple

import numpy as np
import torch

from ..models import frontend as fe
from ..models import map_state as ms
from ..models import tracking as tr
from ..ops import camera, lie, matching, orb
from .eval_full import card_line, platform  # noqa: F401  (re-exported for the tools)


def _sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def checksum(out) -> float:
    """Read every tensor of ``out`` (nested tuples / lists) back to the host
    and sum it: what consumes a timed call's outputs."""
    if isinstance(out, torch.Tensor):
        return float(torch.nan_to_num(out.detach().to(torch.float64), posinf=0.0,
                                      neginf=0.0).sum())
    if isinstance(out, (tuple, list)):
        return sum(checksum(o) for o in out)
    return 0.0


def time_ms(fn, variants, device, warmup: int = 1):
    """Mean ms per call of ``fn(*v)`` over ``variants`` (argument tuples,
    one per timed call), after ``warmup`` untimed calls. Returns (ms, the
    outputs' checksum)."""
    for i in range(warmup):
        fn(*variants[i % len(variants)])
    _sync(device)
    cuda = torch.device(device).type == "cuda"
    if cuda:
        ev0, ev1 = (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
        ev0.record()
    else:
        t0 = time.perf_counter()
    outs = [fn(*v) for v in variants]
    if cuda:
        ev1.record()
        torch.cuda.synchronize()
        ms_total = ev0.elapsed_time(ev1)
    else:
        ms_total = 1e3 * (time.perf_counter() - t0)
    return ms_total / len(variants), checksum(outs)


# ---------------------------------------------------------------------------
# the frame-step workload
# ---------------------------------------------------------------------------

H, W, NFEAT, NLEV = 480, 640, 1024, 8
NPTS, NKF = 8192, 64
N_LOCAL_PT = 4096


class FrameWorkload(NamedTuple):
    cfg: fe.FrontendConfig
    m: ms.MapState
    obs_A: torch.Tensor       # [K, P] observation matrix
    imgs: list                # distinct [H, W] float32 images, one per timed call
    feats: list               # their features
    T0: torch.Tensor          # [7] identity pose
    prev_obs: torch.Tensor    # [NFEAT] int32: keypoint i observes point i
    sf: torch.Tensor          # per-level scale factors
    inv_s2: torch.Tensor      # per-level inverse sigma^2
    pts: torch.Tensor         # [P, 3] the map's points
    device: str


def frame_workload(device="cuda", n_live_kf: int = 16, n_images: int = 8, h: int = H,
                   w: int = W, n_features: int = NFEAT, n_levels: int = NLEV,
                   n_pts: int = NPTS, n_kf: int = NKF, seed: int = 0) -> FrameWorkload:
    """The map: ``n_pts`` valid points uniform in [-3, 3] x [-2, 2] x [2, 10]
    with random descriptors, a normal of (0, 0, -1) and a max distance of
    100; ``n_live_kf`` live keyframes of ``n_kf`` slots, keyframe k
    observing points (i + 13 k) mod P at the points' projections from the
    origin. ``n_images`` random images and their features."""
    rng = np.random.RandomState(seed)
    cfg = fe.FrontendConfig(height=h, width=w, n_features=n_features, n_levels=n_levels,
                            fx=520.9, fy=521.0, cx=325.1, cy=249.7)
    m = ms.empty_map(ms.MapConfig(max_keyframes=n_kf, max_points=n_pts,
                                  n_features=n_features, n_levels=n_levels, device=device))
    pts = torch.as_tensor(rng.uniform([-3.0, -2.0, 2.0], [3.0, 2.0, 10.0], (n_pts, 3)),
                          dtype=torch.float32, device=device)
    desc = torch.as_tensor(rng.randint(0, 2**31 - 1, (n_pts, 8)), dtype=torch.int32,
                           device=device)
    K = fe.intrinsics(cfg, str(torch.device(device)))[0]
    uv_all, _ = camera.project(K, pts)
    nf = min(n_features, n_pts)
    live = torch.zeros(n_kf, dtype=torch.bool, device=device)
    live[:n_live_kf] = True
    obs = torch.full((n_kf, n_features), -1, dtype=torch.int32, device=device)
    obs[:n_live_kf, :nf] = ((torch.arange(nf, device=device)[None, :]
                             + 13 * torch.arange(n_live_kf, device=device)[:, None])
                            % n_pts).to(torch.int32)
    kf_uv = m.kf_uv.clone()
    kf_uv[:, :nf] = uv_all[None, :nf]
    kf_desc = m.kf_desc.clone()
    kf_desc[:n_live_kf, :nf] = desc[:nf]
    kp_valid = m.kf_kp_valid.clone()
    kp_valid[:n_live_kf] = True
    m = m._replace(
        pt_pos=pts, pt_valid=torch.ones(n_pts, dtype=torch.bool, device=device),
        pt_desc=desc, pt_max_dist=torch.full((n_pts,), 100.0, device=device),
        pt_normal=torch.tensor([0.0, 0.0, -1.0], device=device).expand(n_pts, 3).clone(),
        n_pt=torch.tensor(n_pts, dtype=torch.int32, device=device),
        kf_valid=live, kf_kp_valid=kp_valid, kf_uv=kf_uv, kf_desc=kf_desc,
        kf_obs_point=obs, n_kf=torch.tensor(n_live_kf, dtype=torch.int32, device=device),
    )
    imgs = [torch.as_tensor(np.random.RandomState(seed + 1 + i).rand(h, w) * 255.0,
                            dtype=torch.float32, device=device) for i in range(n_images)]
    feats = [fe.extract_mono(cfg, im) for im in imgs]
    sf, _, inv_s2 = orb.scale_factors(n_levels, 1.2, device)
    _sync(device)
    return FrameWorkload(cfg, m, ms.observation_matrix(m), imgs, feats,
                         lie.se3_identity(device=device),
                         torch.arange(n_features, dtype=torch.int32, device=device) % n_pts,
                         sf, inv_s2, pts, device)


def intrinsics(wl: FrameWorkload):
    return fe.intrinsics(wl.cfg, str(torch.device(wl.device)))[0]


def stage_a(wl: FrameWorkload, feats, T, prev_obs):
    """``tracking.track_frame``'s stage A (the motion-model match, both radii
    in one launch) alone. Returns the keypoint -> point assignment [N]."""
    m, cfg = wl.m, wl.cfg
    P = m.pt_pos.shape[0]
    N = feats.uv.shape[0]
    dev = m.pt_pos.device
    prev = prev_obs.to(torch.int64)
    qa_ids = torch.where(prev >= 0, prev, P - 1)
    qa_ok = (prev >= 0) & m.pt_valid[qa_ids]
    pa = m.pt_pos[qa_ids]
    uv_a, z_a = camera.project(intrinsics(wl), lie.se3_apply(T, pa))
    in_img = ((uv_a[:, 0] >= 0) & (uv_a[:, 0] < cfg.width) & (uv_a[:, 1] >= 0)
              & (uv_a[:, 1] < cfg.height) & (z_a > 0.1))
    dist_a = torch.linalg.norm(pa - lie.camera_center(T)[None, :], dim=-1)
    lvl_a = tr.predict_scale(dist_a, m.pt_max_dist[qa_ids], 1.2, cfg.n_levels)
    radii = 15.0 * torch.arange(1, 3, dtype=torch.float32, device=dev)[:, None]

    def both(t):
        return t.expand((2,) + t.shape)

    mi2, _ = matching.match_by_projection(
        proj_uv=both(uv_a), proj_valid=both(qa_ok & in_img), pred_level=both(lvl_a),
        query_desc=both(m.pt_desc[qa_ids]), query_angle=None,
        feats_uv=feats.uv_und, feats_level=feats.level, feats_desc=feats.desc,
        feats_angle=feats.angle, feats_valid=feats.valid, radius=radii,
        scale_factors=wl.sf, th=matching.TH_HIGH)
    mi = torch.where(torch.sum((mi2[0] >= 0).to(torch.int32)) < 20, mi2[1], mi2[0])
    obs_a = torch.full((N + 1,), -1, dtype=torch.int64, device=dev)
    obs_a[torch.where(mi >= 0, mi, N)] = torch.where(mi >= 0, qa_ids, -1)
    return obs_a[:N]


def pose_opt_a(wl: FrameWorkload, feats, T, obs, rounds: int = 2, iters: int = 3):
    return tr._pose_opt_from_obs(wl.m, feats, T, obs, intrinsics(wl), 0.0, wl.inv_s2,
                                 rounds=rounds, iters=iters)


def track(wl: FrameWorkload, feats, T, prev_obs):
    cfg = wl.cfg
    return tr.track_frame(wl.m, feats, T, prev_obs, intrinsics(wl), 0.0, height=cfg.height,
                          width=cfg.width, n_levels=cfg.n_levels, n_local_kf=wl.m.kf_valid.shape[0],
                          n_local_pt=N_LOCAL_PT, obs_A=wl.obs_A)


def detect(wl: FrameWorkload, img):
    """Detection alone: the pyramid, then FAST, NMS and the cell top-k per
    level (the first half of ``orb.extract``). Returns [(yx, score, valid)]."""
    cfg = wl.cfg
    shapes = orb.pyramid_shapes(cfg.height, cfg.width, cfg.n_levels, cfg.scale_factor)
    counts = orb.per_level_counts(cfg.n_features, cfg.n_levels, cfg.scale_factor)
    pyr = orb.build_pyramid(img, shapes)
    return [orb.detect_level(pyr[lv], counts[lv], cfg.th_fast, cfg.th_fast_min)
            for lv in range(cfg.n_levels)]


def stage_row(name: str, ms_: float, unit: str = "ms/frame") -> str:
    return f"{name:40s} {ms_:9.3f} {unit}"
