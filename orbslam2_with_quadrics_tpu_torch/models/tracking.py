"""Per-frame tracking: motion-model match -> pose opt -> local-map track.

Counterpart of the reference's ``models/tracking.py`` (TrackWithMotionModel
+ TrackLocalMap): two projection-matching passes, each one launch of the masked
Hamming best-two kernel (the motion-model pass is a batch of two windows),
and two pose optimizations, all on fixed-shape tensors with no host round
trip.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..ops import camera, lie, matching, orb, pose_opt
from . import map_state as ms


class TrackResult(NamedTuple):
    T_cw: torch.Tensor        # [7] optimized pose
    obs_point: torch.Tensor   # [N] kp -> map point id (-1)
    n_inliers: torch.Tensor   # scalar int32
    n_matches: torch.Tensor   # scalar int32 (pre-opt matches)
    visible_pt: torch.Tensor  # [P] bool — in-frustum local points
    found_pt: torch.Tensor    # [P] bool — inlier-tracked points


def predict_scale(dist, max_dist, scale: float, n_levels: int):
    """Octave predicted from distance (MapPoint::PredictScale)."""
    ratio = torch.clamp(max_dist / torch.clamp(dist, min=1e-6), min=1e-6)
    log_scale = torch.log(torch.full((), scale, dtype=torch.float32, device=dist.device))
    lvl = torch.ceil(torch.log(ratio) / log_scale).to(torch.int64)
    return torch.clamp(lvl, 0, n_levels - 1)


def _flag(n: int, idx, ok):
    """[n] bool with True at idx[ok]."""
    out = torch.zeros(n + 1, dtype=torch.bool, device=idx.device)
    out[torch.where(ok, idx, n)] = True
    return out[:n]


def select_local_points(m: ms.MapState, obs_point, n_local_kf: int,
                        n_local_pt: int, obs_A=None):
    """Covisibility vote -> top-K keyframes -> their points, fixed size.
    Returns (pt_ids [n_local_pt] int64 with P = pad, kf_mask [K] bool)."""
    K, N = m.kf_obs_point.shape
    P = m.pt_pos.shape[0]
    if obs_A is None:
        obs_A = ms.observation_matrix(m)
    matched = _flag(P, obs_point.to(torch.int64), obs_point >= 0)
    votes = obs_A @ matched.to(obs_A.dtype)
    top_v, top_i = orb.topk_stable(votes, min(n_local_kf, K))
    kf_mask = torch.zeros(K, dtype=torch.bool, device=votes.device)
    kf_mask[top_i] = top_v > 0
    pmask = ((kf_mask.to(obs_A.dtype) @ obs_A) > 0) & m.pt_valid
    # the selected points in ascending index order, padded with P
    ar = torch.arange(P, dtype=torch.float32, device=votes.device)
    key = torch.where(pmask, 2.0 * P - ar, -ar)
    topv, topi = torch.topk(key, min(n_local_pt, P))
    return torch.where(topv > 0, topi, P), kf_mask


def track_frame(m: ms.MapState, feats, T_pred, prev_obs_point, Kc, bf,
                height: int, width: int, n_levels: int = 8, scale: float = 1.2,
                n_local_kf: int = 64, n_local_pt: int = 4096,
                motion_radius: float = 15.0, local_radius: float = 4.0,
                obs_A=None) -> TrackResult:
    """One full tracking update (TrackWithMotionModel + TrackLocalMap)."""
    P = m.pt_pos.shape[0]
    N = feats.uv.shape[0]
    dev = m.pt_pos.device
    sf, _, inv_sigma2_tab = orb.scale_factors(n_levels, scale, dev)

    # ---------------- stage A: motion-model matching --------------------
    prev = prev_obs_point.to(torch.int64)
    qa_ids = torch.where(prev >= 0, prev, P - 1)
    qa_ok = (prev >= 0) & m.pt_valid[qa_ids]
    pa = m.pt_pos[qa_ids]
    uv_a, z_a = camera.project(Kc, lie.se3_apply(T_pred, pa))
    in_img_a = ((uv_a[:, 0] >= 0) & (uv_a[:, 0] < width)
                & (uv_a[:, 1] >= 0) & (uv_a[:, 1] < height) & (z_a > 0.1))
    dist_a = torch.linalg.norm(pa - lie.camera_center(T_pred)[None, :], dim=-1)
    lvl_a = predict_scale(dist_a, m.pt_max_dist[qa_ids], scale, n_levels)
    # the motion window and its widened retry (the reference doubles the
    # window when matches are scarce) are one batched sweep of two radii,
    # one kernel launch; the choice between them stays on the device
    radii = motion_radius * torch.arange(1, 3, dtype=torch.float32, device=dev)[:, None]

    def both(t):
        return t.expand((2,) + t.shape)

    mi2, _ = matching.match_by_projection(
        proj_uv=both(uv_a), proj_valid=both(qa_ok & in_img_a), pred_level=both(lvl_a),
        query_desc=both(m.pt_desc[qa_ids]), query_angle=None,
        feats_uv=feats.uv_und, feats_level=feats.level,
        feats_desc=feats.desc, feats_angle=feats.angle,
        feats_valid=feats.valid, radius=radii, scale_factors=sf,
        th=matching.TH_HIGH,
    )
    scarce = torch.sum((mi2[0] >= 0).to(torch.int32)) < 20
    mi = torch.where(scarce, mi2[1], mi2[0])
    obs_a = torch.full((N + 1,), -1, dtype=torch.int64, device=dev)
    obs_a[torch.where(mi >= 0, mi, N)] = torch.where(mi >= 0, qa_ids, -1)
    obs_a = obs_a[:N]

    # stage A's pose seeds the local-map projection window: short schedule
    T_a, _, _ = _pose_opt_from_obs(m, feats, T_pred, obs_a, Kc, bf,
                                   inv_sigma2_tab, rounds=2, iters=3)

    # ---------------- stage B: local-map tracking -----------------------
    pt_ids, _ = select_local_points(m, obs_a, n_local_kf, n_local_pt, obs_A)
    pt_ok = pt_ids < P
    pid = torch.clamp(pt_ids, 0, P - 1)
    pb = m.pt_pos[pid]
    uv_b, z_b = camera.project(Kc, lie.se3_apply(T_a, pb))
    vec = pb - lie.camera_center(T_a)[None, :]
    dist_b = torch.linalg.norm(vec, dim=-1)
    # frustum test: in image, depth > 0, distance in the scale band,
    # viewing angle within 60 degrees of the mean normal
    view_cos = torch.sum(vec * m.pt_normal[pid], dim=-1) / torch.clamp(dist_b, min=1e-6)
    in_frustum = (
        pt_ok & m.pt_valid[pid] & (z_b > 0.1)
        & (uv_b[:, 0] >= 0) & (uv_b[:, 0] < width)
        & (uv_b[:, 1] >= 0) & (uv_b[:, 1] < height)
        & (dist_b >= m.pt_min_dist[pid]) & (dist_b <= m.pt_max_dist[pid])
        & (view_cos > 0.5)
    )
    lvl_b = predict_scale(dist_b, m.pt_max_dist[pid], scale, n_levels)
    mib, _ = matching.match_by_projection(
        proj_uv=uv_b, proj_valid=in_frustum, pred_level=lvl_b,
        query_desc=m.pt_desc[pid], query_angle=None,
        feats_uv=feats.uv_und, feats_level=feats.level,
        feats_desc=feats.desc, feats_angle=feats.angle,
        feats_valid=feats.valid, radius=local_radius, scale_factors=sf,
        th=matching.TH_HIGH, ratio=0.8,
    )
    obs_b = torch.full((N + 1,), -1, dtype=torch.int64, device=dev)
    obs_b[torch.where(mib >= 0, mib, N)] = torch.where(mib >= 0, pid, -1)
    # merge: the stage-A assignment wins (tighter prior)
    obs = torch.where(obs_a >= 0, obs_a, obs_b[:N])
    n_matches = torch.sum((obs >= 0).to(torch.int32))

    T_f, inlier, n_inl = _pose_opt_from_obs(m, feats, T_a, obs, Kc, bf,
                                            inv_sigma2_tab)
    obs = torch.where(inlier, obs, -1)
    return TrackResult(
        T_cw=T_f, obs_point=obs.to(torch.int32), n_inliers=n_inl,
        n_matches=n_matches,
        visible_pt=_flag(P, pt_ids, in_frustum),
        found_pt=_flag(P, obs, obs >= 0),
    )


def _pose_opt_from_obs(m, feats, T_init, obs_point, Kc, bf, inv_sigma2_tab,
                       rounds=4, iters=5):
    """Motion-only LM on the kp->point assignment."""
    P = m.pt_pos.shape[0]
    pid = torch.clamp(obs_point.to(torch.int64), 0, P - 1)
    valid = (obs_point >= 0) & m.pt_valid[pid] & feats.valid
    has_stereo = feats.ur > 0
    obs_uvr = torch.cat(
        [feats.uv_und, torch.where(has_stereo, feats.ur, 0.0)[:, None]], dim=-1
    )
    inv_s2 = inv_sigma2_tab[torch.clamp(feats.level.to(torch.int64), 0,
                                        inv_sigma2_tab.shape[0] - 1)]
    return pose_opt.pose_optimization(
        T_init, Kc, bf, m.pt_pos[pid], obs_uvr, has_stereo.to(torch.float32),
        inv_s2, valid.to(torch.float32), rounds=rounds, iters=iters,
    )

