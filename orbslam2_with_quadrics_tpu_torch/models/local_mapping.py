"""Keyframe-rate mapping: triangulate, fuse, cull, local/global BA.

Counterpart of the reference's ``models/local_mapping.py``: each stage is
a pure function MapState -> MapState, called in LocalMapping::Run's order
(ProcessNewKeyFrame -> MapPointCulling -> CreateNewMapPoints ->
SearchInNeighbors -> LocalBA -> KeyFrameCulling). Local BA takes the
dense-Schur Cholesky solver (``ops/ba.ba_solve_dense``) when the map is on
the card, as the reference does on its accelerator, and the segment-sum PCG
solver (``ops/ba.ba_solve``) on the CPU, as the reference does there;
global BA always takes PCG.
"""

from __future__ import annotations

import torch

from ..ops import ba, camera, lie, matching, orb
from ..ops.orb import topk_stable
from ..utils import tracing
from . import map_state as ms
from .tracking import predict_scale


def _kinv_mat(Kc):
    fx, fy, cx, cy = Kc[0], Kc[1], Kc[2], Kc[3]
    zero, one = torch.zeros_like(fx), torch.ones_like(fx)
    Km = torch.stack([torch.stack([fx, zero, cx]), torch.stack([zero, fy, cy]),
                      torch.stack([zero, zero, one])])
    return torch.linalg.inv(Km)


def _relative_fundamental(T1w, T2w, Kc):
    """F21 with x2^T F21 x1 = 0; ``T2w`` may carry a leading batch axis."""
    T21 = lie.se3_compose(T2w, lie.se3_inverse(T1w))
    E = lie.hat(T21[..., 4:7]) @ lie.quat_to_matrix(T21[..., :4])
    Kinv = _kinv_mat(Kc)
    return Kinv.T @ E @ Kinv


def _epipolar_dist2(F21, uv1, uv2):
    """Squared distance of uv2 [T,N2,2] to the epipolar lines of uv1 [N1,2]
    under F21 [T,3,3] -> [T,N1,N2] (T is a batch of neighbors)."""
    F = F21[..., None]                                   # [T,3,3,1]
    a = F[:, 0, 0] * uv1[:, 0] + F[:, 0, 1] * uv1[:, 1] + F[:, 0, 2]
    b = F[:, 1, 0] * uv1[:, 0] + F[:, 1, 1] * uv1[:, 1] + F[:, 1, 2]
    c = F[:, 2, 0] * uv1[:, 0] + F[:, 2, 1] * uv1[:, 1] + F[:, 2, 2]
    num = (a[:, :, None] * uv2[:, None, :, 0] + b[:, :, None] * uv2[:, None, :, 1]
           + c[:, :, None])
    den = torch.clamp(a * a + b * b, min=1e-12)
    return num * num / den[:, :, None]


def create_new_points(m: ms.MapState, kf_id, Kc, bf, n_neighbors: int = 10,
                      n_levels: int = 8, scale: float = 1.2, W=None):
    """Triangulate new points between keyframe ``kf_id`` and its covisible
    neighbors (CreateNewMapPoints): epipolar-gated matching of unmatched
    keypoints, DLT, cheirality / reprojection / scale checks; the best
    neighbor (min Hamming) wins per keypoint. Returns (map, n_new)."""
    K, N = m.kf_obs_point.shape
    dev = m.pt_pos.device
    sf, sigma2_tab, _ = orb.scale_factors(n_levels, scale, dev)
    if W is None:
        W = ms.covisibility(m)
    nb_w, nb_ids = topk_stable(W[kf_id], min(n_neighbors, K))
    nb_ok = nb_w > 0

    T1 = m.kf_pose[kf_id]
    uv1 = m.kf_uv[kf_id]
    d1 = m.kf_desc[kf_id]
    lvl1 = m.kf_level[kf_id].to(torch.int64)
    free1 = m.kf_kp_valid[kf_id] & (m.kf_obs_point[kf_id] < 0)
    c1 = lie.camera_center(T1)

    # every neighbor at once: [T,N,N] epipolar gate and Hamming distances
    T = nb_ids.shape[0]
    T2 = m.kf_pose[nb_ids]                                 # [T,7]
    free2 = m.kf_kp_valid[nb_ids] & (m.kf_obs_point[nb_ids] < 0)
    ed2 = _epipolar_dist2(_relative_fundamental(T1, T2, Kc), uv1, m.kf_uv[nb_ids])
    gate = 3.84 * sigma2_tab[torch.clamp(m.kf_level[nb_ids].to(torch.int64), 0, n_levels - 1)]
    # skip neighbors with a tiny baseline (> 1 cm proxy)
    baseline_ok = torch.linalg.norm(lie.camera_center(T2) - c1, dim=-1) > 0.01
    mask = (free1[None, :, None] & free2[:, None, :] & (ed2 < gate[:, None, :])
            & (nb_ok & baseline_ok)[:, None, None])
    dist = matching.hamming_matrix(d1, m.kf_desc[nb_ids].reshape(T * N, -1))
    bi, bd, b2 = matching.best_two(dist.reshape(N, T, N).transpose(0, 1), mask)
    okm = (bd <= matching.TH_LOW) & (bd.to(torch.float32) <= 0.9 * b2.to(torch.float32))
    nb_match = torch.where(okm, bi, -1)                    # [T,N]
    nb_dist = torch.where(okm, bd, 1 << 20)

    tbest = torch.argmin(nb_dist, dim=0)                   # first min
    rows = torch.arange(N, device=dev)
    match_kp = nb_match[tbest, rows]
    match_nb = nb_ids[tbest]
    have = match_kp >= 0
    kp2 = torch.clamp(match_kp, 0, N - 1)

    T2s = m.kf_pose[match_nb]                              # [N,7]
    P1 = camera.projection_matrix(T1, Kc)
    P2s = camera.projection_matrix(T2s, Kc[None].expand(N, 4))
    uv2m = m.kf_uv[match_nb, kp2]
    X = camera.triangulate_dlt(P1, P2s, uv1, uv2m)

    pc1 = lie.se3_apply(T1, X)
    pc2 = lie.se3_apply(T2s, X)
    uv1p, z1 = camera.project(Kc, pc1)
    uv2p, z2 = camera.project(Kc, pc2)
    lvl2 = m.kf_level[match_nb, kp2].to(torch.int64)
    l1 = torch.clamp(lvl1, 0, n_levels - 1)
    l2 = torch.clamp(lvl2, 0, n_levels - 1)
    e1 = torch.sum((uv1p - uv1) ** 2, dim=-1) / sigma2_tab[l1]
    e2 = torch.sum((uv2p - uv2m) ** 2, dim=-1) / sigma2_tab[l2]
    r1 = X - c1[None, :]
    r2 = X - lie.camera_center(T2s)
    n1 = torch.linalg.norm(r1, dim=-1)
    n2 = torch.linalg.norm(r2, dim=-1)
    cosp = torch.sum(r1 * r2, dim=-1) / torch.clamp(n1 * n2, min=1e-12)
    # scale consistency: distance ratio vs octave ratio
    ratio_d = n1 / torch.clamp(n2, min=1e-9)
    ratio_o = sf[l1] / sf[l2]
    scale_ok = (ratio_d < ratio_o * 1.5 * scale) & (ratio_d > ratio_o / (1.5 * scale))
    good = (have & (z1 > 0.05) & (z2 > 0.05) & (cosp < 0.9998) & (e1 < 5.991)
            & (e2 < 5.991) & scale_ok & torch.all(torch.isfinite(X), dim=-1))

    kf_col = torch.full((N,), 0, dtype=torch.int32, device=dev) + kf_id.to(torch.int32)
    m2, pids = ms.insert_points(m, X, d1, kf_col, good)
    # wire observations into both keyframes
    obs = m2.kf_obs_point.clone()
    obs[kf_id] = torch.where(pids >= 0, pids, obs[kf_id].to(torch.int64)).to(torch.int32)
    flat = ms.scatter_last(obs.reshape(-1), match_nb * N + kp2, pids, pids >= 0)
    m2 = m2._replace(kf_obs_point=flat.reshape(K, N))
    return m2, torch.sum((pids >= 0).to(torch.int32))


def cull_points(m: ms.MapState):
    """MapPointCulling: recently created points (<= 4 keyframes old) with a
    poor found/visible ratio, or too few observations 2-4 keyframes after
    creation, are dropped and detached from the keyframes."""
    obs_cnt = ms.point_obs_count(m)
    age = m.n_kf - 1 - m.pt_first_kf
    ratio = m.pt_found.to(torch.float32) / torch.clamp(m.pt_visible.to(torch.float32), min=1.0)
    recent = age <= 4
    bad = recent & (ratio < 0.25) & (m.pt_visible > 3)
    bad = bad | ((age >= 2) & (age <= 4) & (obs_cnt <= 2))
    valid = m.pt_valid & ~bad
    return m._replace(pt_valid=valid, kf_obs_point=_drop_invalid_obs(m.kf_obs_point, valid))


def _drop_invalid_obs(obs, pt_valid):
    P = pt_valid.shape[0]
    ok = (obs >= 0) & pt_valid[torch.clamp(obs.to(torch.int64), 0, P - 1)]
    return torch.where(ok, obs, -1)


def fuse_neighbors(m: ms.MapState, kf_id, Kc, height: int = 480, width: int = 640,
                   n_neighbors: int = 10, n_levels: int = 8, scale: float = 1.2,
                   W=None):
    """SearchInNeighbors / Fuse in both directions: the new keyframe's
    points into each neighbor and each neighbor's points into the new
    keyframe. A projection onto a free keypoint adds the observation (unless
    that keyframe already sees the point); onto a keypoint holding another
    point it merges the two, keeping the more observed one (the reverse
    sweep merges only when one side has <= 2 observations)."""
    K, N = m.kf_obs_point.shape
    P = m.pt_pos.shape[0]
    dev = m.pt_pos.device
    sf, _, _ = orb.scale_factors(n_levels, scale, dev)
    if W is None:
        W = ms.covisibility(m)
    nb_w, nb_ids = topk_stable(W[kf_id], min(n_neighbors, K))
    nb_ok = nb_w > 0
    obs_cnt = ms.point_obs_count(m)
    ar_n = torch.arange(N, device=dev)
    kf = kf_id.to(torch.int64)

    def project_into(pids, pid_ok, T_obs, into):
        """Visible projections of points ``pids`` [T,N] under poses
        ``T_obs`` into keyframe(s) ``into`` and their matches there
        (match_by_projection, radius 3, TH_LOW), every sweep in one batch:
        ``T_obs`` [T,1,7] with ``into`` [T], or one pose [7] and one
        keyframe shared by the batch. Reads only ``m``. Returns [T,N]."""
        pos = m.pt_pos[pids]
        pc = lie.se3_apply(T_obs, pos)
        uv_p, z = camera.project(Kc, pc)
        dist = torch.linalg.norm(pc, dim=-1)
        band = (dist >= m.pt_min_dist[pids]) & (dist <= m.pt_max_dist[pids])
        vec = pos - lie.camera_center(T_obs)
        view = (torch.sum(vec * m.pt_normal[pids], dim=-1)
                / torch.clamp(torch.linalg.norm(vec, dim=-1), min=1e-6)) > 0.5
        vis = (pid_ok & band & view & (z > 0.05)
               & (uv_p[..., 0] >= 0) & (uv_p[..., 0] < width)
               & (uv_p[..., 1] >= 0) & (uv_p[..., 1] < height))
        mi, _ = matching.match_by_projection(
            proj_uv=uv_p, proj_valid=vis,
            pred_level=predict_scale(dist, m.pt_max_dist[pids], scale, n_levels),
            query_desc=m.pt_desc[pids], query_angle=None,
            feats_uv=m.kf_uv[into], feats_level=m.kf_level[into],
            feats_desc=m.kf_desc[into], feats_angle=m.kf_angle[into],
            feats_valid=m.kf_kp_valid[into], radius=3.0, scale_factors=sf,
            th=matching.TH_LOW, ratio=1.0,
        )
        return mi

    def fuse_step(remap, obs_flat, src, into, mi, mature_merge: bool):
        """Apply one sweep's matches ``mi`` of points ``src`` [N] into
        keyframe ``into``."""
        hit = mi >= 0
        tgt = into * N + torch.clamp(mi, 0, N - 1)
        existing = obs_flat[tgt].to(torch.int64)
        row = obs_flat[into * N + ar_n].to(torch.int64)
        seen = torch.zeros(P + 1, dtype=torch.bool, device=dev)
        seen[torch.where(row >= 0, row, P)] = True
        pid = torch.clamp(src, 0, P - 1)
        add = hit & (existing < 0) & ~seen[pid]
        obs_flat = ms.scatter_last(obs_flat, tgt, src, add)
        ex_cnt = obs_cnt[torch.clamp(existing, 0, P - 1)]
        dup = hit & (existing >= 0) & (existing != src)
        if not mature_merge:
            dup = dup & ((ex_cnt <= 2) | (obs_cnt[pid] <= 2))
        keep_src = obs_cnt[pid] >= ex_cnt
        loser = torch.where(keep_src, existing, src)
        winner = torch.where(keep_src, src, existing)
        remap = ms.scatter_last(remap, torch.clamp(loser, 0, P - 1), winner, dup)
        return remap, obs_flat

    src_pts = m.kf_obs_point[kf].to(torch.int64)
    T = nb_ids.shape[0]
    # the sweeps read only ``m``, never the fuse steps' carry, so all 2T of
    # them are matched up front in two kernel launches:
    # forward, the new keyframe's points into every neighbor ...
    mi_fwd = project_into(torch.clamp(src_pts, 0, P - 1).expand(T, N),
                          (src_pts >= 0) & nb_ok[:, None],
                          m.kf_pose[nb_ids][:, None, :], nb_ids)
    # ... and reverse, every neighbor's points into the new keyframe
    src_nbs = m.kf_obs_point[nb_ids].to(torch.int64)
    mi_rev = project_into(torch.clamp(src_nbs, 0, P - 1),
                          (src_nbs >= 0) & nb_ok[:, None], m.kf_pose[kf], kf)
    remap = torch.arange(P, device=dev)
    obs_flat = m.kf_obs_point.reshape(-1)
    for i in range(T):
        remap, obs_flat = fuse_step(remap, obs_flat, src_pts, nb_ids[i], mi_fwd[i], True)
        remap, obs_flat = fuse_step(remap, obs_flat, src_nbs[i], kf, mi_rev[i], False)

    # resolve merge chains (a->b, b->c => a->c) by pointer jumping
    for _ in range(3):
        remap = remap[remap]
    lost = remap != torch.arange(P, device=dev)
    obs = obs_flat.reshape(K, N).to(torch.int64)
    obs = torch.where(obs >= 0, remap[torch.clamp(obs, 0, P - 1)], obs)
    pt_valid = m.pt_valid & ~lost
    return m._replace(kf_obs_point=_drop_invalid_obs(obs, pt_valid).to(torch.int32),
                      pt_valid=pt_valid)


def cull_keyframes(m: ms.MapState, kf_id, protect=None, W=None, n_levels: int = 8):
    """KeyFrameCulling: a covisible keyframe is redundant if >= 90% of its
    points are observed by >= 3 other keyframes at the same or finer scale;
    at most one is culled per call (never slot 0 or the newest two)."""
    K, N = m.kf_obs_point.shape
    P = m.pt_pos.shape[0]
    dev = m.pt_pos.device
    if W is None:
        W = ms.covisibility(m)
    ar = torch.arange(K, device=dev)
    cand = (W[kf_id] > 0) & m.kf_valid & (ar != 0) & (ar < m.n_kf - 2)
    if protect is not None:
        cand = cand & ~protect
    obs = m.kf_obs_point.to(torch.int64)
    has = (obs >= 0) & m.kf_kp_valid & m.kf_valid[:, None]
    cum = ms.obs_level_cum(m, n_levels)
    lvl_gate = torch.clamp(torch.clamp(m.kf_level.to(torch.int64), 0, n_levels - 1) + 1,
                           max=n_levels - 1)
    n_others = cum[torch.clamp(obs, 0, P - 1), lvl_gate] - 1.0
    n_has = torch.sum(has, dim=1)
    n_red = torch.sum(has & (n_others >= 3), dim=1)
    redundant = cand & (n_red.to(torch.float32)
                        >= 0.9 * torch.clamp(n_has, min=1).to(torch.float32))
    first = torch.argmax(redundant.to(torch.int32))
    do = redundant[first]
    kf_valid = m.kf_valid.clone()
    kf_valid[first] = kf_valid[first] & ~do
    obs_rows = m.kf_obs_point.clone()
    obs_rows[first] = torch.where(do, -1, obs_rows[first])
    # freeze T_child_parent for trajectory re-anchoring
    parent = m.kf_parent[first].to(torch.int64)
    tcp = lie.se3_compose(m.kf_pose[first],
                          lie.se3_inverse(m.kf_pose[torch.clamp(parent, 0, K - 1)]))
    kf_tcp = m.kf_tcp.clone()
    kf_tcp[first] = torch.where(do & (parent >= 0), tcp, kf_tcp[first])
    # live children of the culled keyframe move to its parent
    child = do & (m.kf_parent == first) & (ar != first) & m.kf_valid
    kf_parent = torch.where(child, parent.to(torch.int32), m.kf_parent)
    return m._replace(kf_valid=kf_valid, kf_obs_point=obs_rows, kf_tcp=kf_tcp,
                      kf_parent=kf_parent)


def _edge_table(m: ms.MapState, cams, inv_sigma2_tab):
    """Per-(camera row, keypoint) observation edges of keyframes ``cams``."""
    g_ur = m.kf_ur[cams]
    uvr = torch.cat([m.kf_uv[cams], torch.where(g_ur > 0, g_ur, 0.0)[..., None]], dim=-1)
    lvl = torch.clamp(m.kf_level[cams].to(torch.int64), 0, inv_sigma2_tab.shape[0] - 1)
    C, N = g_ur.shape
    return (uvr.reshape(-1, 3), (g_ur > 0).reshape(-1).to(torch.float32),
            inv_sigma2_tab[lvl].reshape(-1),
            torch.arange(C, device=g_ur.device).repeat_interleave(N))


def _valid_obs(m: ms.MapState):
    P = m.pt_pos.shape[0]
    obs = m.kf_obs_point.to(torch.int64)
    pnt = torch.clamp(obs, 0, P - 1)
    ok = (obs >= 0) & m.kf_kp_valid & m.kf_valid[:, None] & m.pt_valid[pnt]
    return obs, pnt, ok


def _schedule(prob, first_iters: int, second_iters: int):
    """Robust iterations, outlier purge (traced as ``ba.purge``, counting
    the edges it drops), then plain iterations."""
    prob, _ = ba.ba_solve(prob, n_iters=first_iters, cg_iters=40, use_huber=True)
    with tracing.span("ba.purge", prob.poses.device) as sp:
        _, inl = ba.edge_chi2(prob)
        valid = prob.valid * inl.to(torch.float32)
        if sp:
            sp.count(purged=torch.count_nonzero(prob.valid) - torch.count_nonzero(valid))
    return ba.ba_solve(prob._replace(valid=valid), n_iters=second_iters, cg_iters=40,
                       use_huber=False)


def _dense_schedule(prob, cam_grid, first_iters: int, second_iters: int, terms=None):
    """``_schedule`` with the dense-Schur solver over a cam-major [C, N]
    edge table, at most 8192 points coupling the cameras; ``terms`` is the
    route of the solver's per-edge terms (``ba.dense_terms`` where None: the
    kernels on the card)."""
    n_loc = min(prob.points.shape[0], 8192)
    prob, _ = ba.ba_solve_dense(prob, n_iters=first_iters, n_local_pts=n_loc,
                                use_huber=True, cam_grid=cam_grid, terms=terms)
    _, inl = ba.edge_chi2(prob)
    prob = prob._replace(valid=prob.valid * inl.to(torch.float32))
    return ba.ba_solve_dense(prob, n_iters=second_iters, n_local_pts=n_loc,
                             use_huber=False, cam_grid=cam_grid, terms=terms)


def global_ba_problem(m: ms.MapState, Kc, bf, inv_sigma2_tab) -> ba.BAProblem:
    """The global BA's problem: the whole [K, N] observation table, one edge
    a row, the live ones valid; keyframe 0 and empty slots fixed."""
    K = m.kf_obs_point.shape[0]
    _, pnt, okobs = _valid_obs(m)
    ar = torch.arange(K, device=m.pt_pos.device)
    uvr, is_st, is2, cam_idx = _edge_table(m, ar, inv_sigma2_tab)
    return ba.BAProblem(
        poses=m.kf_pose, points=m.pt_pos, K=Kc, bf=bf, cam_idx=cam_idx,
        pnt_idx=pnt.reshape(-1), uvr=uvr, is_stereo=is_st, inv_sigma2=is2,
        valid=okobs.reshape(-1).to(torch.float32),
        fixed_cam=((~m.kf_valid) | (ar == 0)).to(torch.float32),
        fixed_pnt=(~m.pt_valid).to(torch.float32),
    )


def run_global_ba(m: ms.MapState, Kc, bf, inv_sigma2_tab, n_iters: int = 10):
    """Global BA: every valid keyframe free (keyframe 0 fixed as gauge) and
    every valid point free, over the full [K,N] observation table. Traced
    as ``gba.solve`` (``rows``) over ``gba.build`` and the schedule."""
    K, N = m.kf_obs_point.shape
    dev = m.pt_pos.device
    with tracing.span("gba.solve", dev) as sp:
        sp.count(rows=K * N)
        with tracing.span("gba.build", dev):
            prob = global_ba_problem(m, Kc, bf, inv_sigma2_tab)
        prob, cost = _schedule(prob, 5, n_iters)
        ar = torch.arange(K, device=dev)
        kf_pose = torch.where((m.kf_valid & (ar != 0))[:, None], prob.poses, m.kf_pose)
        pt_pos = torch.where(m.pt_valid[:, None], prob.points, m.pt_pos)
        return m._replace(kf_pose=kf_pose, pt_pos=pt_pos), cost


def local_ba_problem(m: ms.MapState, kf_id, Kc, bf, inv_sigma2_tab, window: int = 16,
                     boundary: int = 32, W=None):
    """The local BA problem of ``kf_id``: the top ``window`` covisible
    keyframes + itself free, up to ``boundary`` fixed keyframes that
    co-observe the window's points, the window's points free; a cam-major
    [C, N] edge table. Returns (prob, cams [C], cam_ok [C], g_obs [C,N],
    g_ok [C,N])."""
    K, N = m.kf_obs_point.shape
    P = m.pt_pos.shape[0]
    dev = m.pt_pos.device
    kf = kf_id.to(torch.int64).reshape(1)
    if W is None:
        W = ms.covisibility(m)
    n_w = min(window, K)
    w_w, w_ids = topk_stable(W[kf[0]], n_w)
    in_window = torch.zeros(K, dtype=torch.bool, device=dev)
    in_window[w_ids] = w_w > 0
    in_window[kf] = True
    in_window = in_window & m.kf_valid

    obs, pnt_full, okobs = _valid_obs(m)
    # free points = observed by a window keyframe
    seen = torch.zeros(P + 1, dtype=torch.bool, device=dev)
    seen[torch.where(okobs & in_window[:, None], obs, P).reshape(-1)] = True
    seen = seen[:P]
    # boundary = non-window keyframes observing window points, by overlap
    overlap = torch.sum(okobs & seen[pnt_full], dim=1)
    overlap = torch.where(in_window | ~m.kf_valid, -1, overlap)
    n_b = min(boundary, K)
    b_w, b_ids = topk_stable(overlap, n_b)

    cams = torch.cat([w_ids, kf, b_ids])                               # [C]
    C = cams.shape[0]
    cam_ok = torch.cat([(w_w > 0) & (w_ids != kf), torch.ones(1, dtype=torch.bool, device=dev),
                        b_w > 0]) & m.kf_valid[cams]
    # dedupe among valid rows: the first row naming a slot keeps it
    pos = torch.arange(C, device=dev)
    first_hit = torch.full((K + 1,), C, dtype=torch.int64, device=dev).scatter_reduce(
        0, torch.where(cam_ok, cams, K), pos, reduce="amin")
    cam_ok = cam_ok & (first_hit[cams] == pos)
    fixed_cam = torch.cat([torch.zeros(n_w + 1, device=dev), torch.ones(n_b, device=dev)])
    fixed_cam = torch.clamp(fixed_cam + (cams == 0) + (~cam_ok), 0.0, 1.0)

    g_obs = obs[cams]
    g_ok = okobs[cams] & cam_ok[:, None]
    uvr, is_st, is2, cam_idx = _edge_table(m, cams, inv_sigma2_tab)
    prob = ba.BAProblem(
        poses=m.kf_pose[cams], points=m.pt_pos, K=Kc, bf=bf, cam_idx=cam_idx,
        pnt_idx=torch.clamp(g_obs, 0, P - 1).reshape(-1), uvr=uvr, is_stereo=is_st,
        inv_sigma2=is2, valid=g_ok.reshape(-1).to(torch.float32),
        fixed_cam=fixed_cam, fixed_pnt=(~seen).to(torch.float32),
    )
    return prob, cams, cam_ok, g_obs, g_ok


def on_accelerator(m: ms.MapState) -> bool:
    """Whether the mapping pass takes the accelerator program: the
    dense-Schur local BA and the neighbourhood-local point statistics. The
    map's device decides, as the backend does in the reference (the card:
    yes; the CPU: PCG local BA and the full-pool statistics)."""
    return m.pt_pos.device.type == "cuda"


def run_local_ba(m: ms.MapState, kf_id, Kc, bf, inv_sigma2_tab, window: int = 16,
                 n_iters: int = 10, boundary: int = 32, W=None):
    """Local BA over the covisibility window of ``kf_id``
    (``local_ba_problem``); outlier observations of the gathered rows are
    dropped afterwards."""
    prob, cams, cam_ok, g_obs, g_ok = local_ba_problem(m, kf_id, Kc, bf, inv_sigma2_tab,
                                                       window, boundary, W)
    C, N = g_obs.shape
    if on_accelerator(m):
        prob, cost = _dense_schedule(prob, (C, N), 4, min(n_iters, 6))
    else:
        prob, cost = _schedule(prob, 4, min(n_iters, 6))

    # scatter back: free deduped window poses, all points
    upd = cam_ok & (prob.fixed_cam < 0.5)
    kf_pose = ms.set_rows(m.kf_pose, cams, prob.poses, upd)
    _, inl2 = ba.edge_chi2(prob._replace(valid=g_ok.reshape(-1).to(torch.float32)))
    g_obs_new = torch.where(g_ok & ~inl2.reshape(C, N), -1, g_obs).to(torch.int32)
    obs_new = ms.set_rows(m.kf_obs_point, cams, g_obs_new, cam_ok)
    return m._replace(kf_pose=kf_pose, pt_pos=prob.points, kf_obs_point=obs_new), cost
