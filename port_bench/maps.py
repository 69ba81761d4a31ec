"""The map a cell's global BA starts from, made on the device from a seed.

One general generator for every configuration: the configuration's file
names a scene (``scenes/<kind>.py``: true keyframe poses and true points),
and the generator does the rest in a few vectorised passes:

1. visibility: a point is visible from a keyframe when it lies inside
   ``[min_depth_m, max_depth_m]`` in front of the camera and projects
   inside the image; the keyframes are taken in blocks of
   ``_BLOCK_PAIRS`` keyframe-point pairs to bound the memory;
2. each keyframe keeps at most ``n_features`` of its visible points, the
   nearest (``select: nearest``) or a random draw (``select: random``), in
   its row of the ``[K, N]`` table, nearest first;
3. points seen by fewer than ``min_observations`` keyframes are culled, as
   ORB-SLAM2's map-point culling does, and their observations erased;
4. measurements: the exact stereo projection (u, v, u_r = u - bf / z) plus
   Gaussian noise of ``noise_px`` times the level's scale, a pyramid level
   drawn in ORB's per-level shares, a right-image column where the depth
   gives one inside the image and a draw of ``stereo_share`` allows (else
   u_r = -1, a mono row), and ``outlier_share`` of the observations
   replaced by a uniform pixel (u_r moved with it);
5. the start: every pose but keyframe 0's (the gauge) moved by
   ``exp(N(0, pose_sigma))`` on the left and every point by
   ``N(0, point_sigma_m)``.

``build`` returns the inputs both sides are handed: a dict of float32 /
int32 / bool tensors laid out as the port's ``MapState`` fields (the pools
of the configuration), plus the camera, ``bf`` and the level table.
"""

from __future__ import annotations

import importlib

import torch

from . import geometry

_BLOCK_PAIRS = 1 << 24


def level_table(orb: dict, dtype=torch.float32, device="cpu"):
    """inv_sigma2 by pyramid level: 1 / scale^(2 l)."""
    f = float(orb["scale_factor"]) ** torch.arange(int(orb["n_levels"]), dtype=torch.float64)
    return (1.0 / (f * f)).to(dtype=dtype, device=device)


def level_shares(orb: dict) -> torch.Tensor:
    """ORB's share of features per level: proportional to (1 / scale)^l."""
    inv = 1.0 / float(orb["scale_factor"])
    w = inv ** torch.arange(int(orb["n_levels"]), dtype=torch.float64)
    return w / w.sum()


def _project(T, X, cam):
    """Depth, u and v [B, P] of world points ``X`` [P, 3] seen from poses
    ``T`` [B, 7] (float64)."""
    R = geometry.quat_to_matrix(T[..., :4])
    pc = X @ R.transpose(-1, -2) + T[..., None, 4:]
    z = pc[..., 2]
    u = cam["fx"] * pc[..., 0] / z + cam["cx"]
    v = cam["fy"] * pc[..., 1] / z + cam["cy"]
    return z, u, v


def _select(poses, pts, cfg: dict, gen: torch.Generator):
    """[Kl, N] int64 point ids, -1 where a keyframe sees fewer than N."""
    cam, obs = cfg["camera"], cfg["observations"]
    Kl, P = poses.shape[0], pts.shape[0]
    N = int(cfg["orb"]["n_features"])
    n_keep = min(N, P)
    block = max(1, _BLOCK_PAIRS // P)
    rows = []
    for k0 in range(0, Kl, block):
        T = poses[k0:k0 + block]
        z, u, v = _project(T, pts, cam)
        vis = ((z >= obs["min_depth_m"]) & (z <= obs["max_depth_m"])
               & (u >= 0) & (u < cam["width"]) & (v >= 0) & (v < cam["height"]))
        if obs["select"] == "nearest":
            key = z
        else:
            key = torch.rand(z.shape, dtype=z.dtype, device=z.device, generator=gen)
        key = torch.where(vis, key, torch.inf)
        kv, ki = torch.topk(key, n_keep, dim=1, largest=False, sorted=True)
        if obs["select"] != "nearest":      # the kept points in the row, nearest first
            zk = torch.where(torch.isfinite(kv), torch.gather(z, 1, ki), torch.inf)
            zk, o = torch.sort(zk, dim=1)
            kv, ki = zk, torch.gather(ki, 1, o)
        rows.append(torch.where(torch.isfinite(kv), ki, -1))
    ids = torch.cat(rows, 0)
    if n_keep < N:
        ids = torch.cat([ids, ids.new_full((Kl, N - n_keep), -1)], 1)
    return ids


def build(cfg: dict, seed: int, device) -> dict:
    dev = torch.device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(int(seed))
    scene = importlib.import_module(f"{__package__}.scenes.{cfg['scene']['kind']}")
    poses_t, pts_t = scene.make(cfg["scene"], gen, dev)
    cam, obs, orb = cfg["camera"], cfg["observations"], cfg["orb"]
    Kl, Pn = poses_t.shape[0], pts_t.shape[0]
    K, P = int(cfg["pools"]["max_keyframes"]), int(cfg["pools"]["max_points"])
    N = int(orb["n_features"])
    if Kl > K or Pn > P:
        raise ValueError(f"the scene ({Kl} keyframes, {Pn} points) does not fit the pools")
    f64 = torch.float64

    ids = _select(poses_t, pts_t, cfg, gen)
    seen = ids >= 0
    n_obs = torch.bincount(ids[seen], minlength=Pn)
    pt_ok = n_obs >= int(obs["min_observations"])
    obs_pt = torch.where(seen & pt_ok[ids.clamp(min=0)], ids, -1)

    # exact measurements of every kept row, then levels, noise, outliers
    X = pts_t[ids.clamp(min=0)]                                   # [Kl, N, 3]
    R = geometry.quat_to_matrix(poses_t[:, :4])
    pc = X @ R.transpose(-1, -2) + poses_t[:, None, 4:]
    z = torch.where(seen, pc[..., 2], 1.0)
    u = cam["fx"] * pc[..., 0] / z + cam["cx"]
    v = cam["fy"] * pc[..., 1] / z + cam["cy"]
    ur = u - cam["bf"] / z
    shares = level_shares(orb).to(dev)
    level = torch.multinomial(shares, Kl * N, replacement=True, generator=gen).reshape(Kl, N)
    sigma = float(obs["noise_px"]) * float(orb["scale_factor"]) ** level.to(f64)

    def gauss():
        return torch.randn((Kl, N), dtype=f64, device=dev, generator=gen)

    def unif(hi):
        return hi * torch.rand((Kl, N), dtype=f64, device=dev, generator=gen)

    u_n, v_n, ur_n = u + sigma * gauss(), v + sigma * gauss(), ur + sigma * gauss()
    stereo = (ur > 0) & (torch.rand((Kl, N), dtype=f64, device=dev, generator=gen)
                         < float(obs["stereo_share"]))
    outlier = torch.rand((Kl, N), dtype=f64, device=dev, generator=gen) < float(obs["outlier_share"])
    u_o, v_o = unif(float(cam["width"])), unif(float(cam["height"]))
    ur_o = u_o - (u_n - ur_n)
    u_n, v_n = torch.where(outlier, u_o, u_n), torch.where(outlier, v_o, v_n)
    ur_n = torch.where(outlier, ur_o, ur_n)
    ur_n = torch.where(stereo & (ur_n > 0), ur_n, -1.0)

    # the start: perturbed poses (keyframe 0 exact) and points
    xi = torch.randn((Kl, 6), dtype=f64, device=dev, generator=gen) * float(obs["pose_sigma"])
    xi[0] = 0.0
    poses0 = geometry.se3_retract(poses_t, xi)
    pts0 = pts_t + torch.randn((Pn, 3), dtype=f64, device=dev, generator=gen) * float(obs["point_sigma_m"])

    f32, i32 = torch.float32, torch.int32

    def pool(shape, fill, dtype):
        return torch.full(shape, fill, dtype=dtype, device=dev)

    kf_pose = pool((K, 7), 0.0, f32)
    kf_pose[:, 0] = 1.0
    kf_pose[:Kl] = poses0.to(f32)
    kf_valid = pool((K,), False, torch.bool)
    kf_valid[:Kl] = True
    kf_uv = pool((K, N, 2), 0.0, f32)
    kf_uv[:Kl] = torch.where(seen[..., None], torch.stack([u_n, v_n], -1), 0.0).to(f32)
    kf_ur = pool((K, N), -1.0, f32)
    kf_ur[:Kl] = torch.where(seen, ur_n, -1.0).to(f32)
    kf_level = pool((K, N), 0, i32)
    kf_level[:Kl] = torch.where(seen, level, 0).to(i32)
    kf_kp_valid = pool((K, N), False, torch.bool)
    kf_kp_valid[:Kl] = seen
    kf_obs_point = pool((K, N), -1, i32)
    kf_obs_point[:Kl] = obs_pt.to(i32)
    pt_pos = pool((P, 3), 0.0, f32)
    pt_pos[:Pn] = pts0.to(f32)
    pt_valid = pool((P,), False, torch.bool)
    pt_valid[:Pn] = pt_ok
    return {
        "kf_pose": kf_pose, "kf_valid": kf_valid, "kf_uv": kf_uv, "kf_ur": kf_ur,
        "kf_level": kf_level, "kf_kp_valid": kf_kp_valid, "kf_obs_point": kf_obs_point,
        "pt_pos": pt_pos, "pt_valid": pt_valid,
        "K": torch.tensor([cam["fx"], cam["fy"], cam["cx"], cam["cy"]], dtype=f32, device=dev),
        "bf": float(cam["bf"]),
        "inv_sigma2": level_table(orb, f32, dev),
        "true_pose": poses_t, "true_pos": pts_t,
    }


def live_counts(inp: dict) -> dict:
    """What the inputs hold: live keyframes, points and edges (rows that
    name a live point from a live keyframe), stereo edges, table rows."""
    obs = inp["kf_obs_point"].to(torch.int64)
    P = inp["pt_pos"].shape[0]
    live = (obs >= 0) & inp["kf_kp_valid"] & inp["kf_valid"][:, None] \
        & inp["pt_valid"][obs.clamp(0, P - 1)]
    return {
        "keyframes": int(inp["kf_valid"].sum()),
        "points": int(inp["pt_valid"].sum()),
        "edges": int(live.sum()),
        "stereo_edges": int((live & (inp["kf_ur"] > 0)).sum()),
        "rows": int(obs.numel()),
        "free_cameras": int(inp["kf_valid"].sum()) - int(bool(inp["kf_valid"][0])),
    }
