"""Quadric landmark management: detection association, init, joint BA.

Counterpart of the reference's ``models/quadric_mapping.py``:

- detections: per-keyframe boxes ``(x, y, w, h, prob, class)`` rows (the
  offline detection files' format);
- association: a detection joins the landmark of its class that shares the
  most of the keyframe's map points inside the box (or starts one);
- init: >= ``min_obs_init`` views and >= ``min_points`` member points ->
  SVD dual-quadric fit (``ops/quadrics.quadric_init``);
- refinement: joint camera-point-quadric BA over every keyframe
  (``ops/quadrics.quadric_ba_solve``).

The landmark table stays on the host (Python lists and sets, numpy pose and
scale); each call copies the map rows it reads once.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..ops import ba, quadrics
from . import map_state as ms


@dataclasses.dataclass
class QuadricLandmark:
    class_id: int
    kf_slots: list          # keyframe slots with a bbox observation
    bboxes: list            # [4] xmin, ymin, xmax, ymax per observation
    point_ids: set          # associated map point ids
    initialized: bool = False
    pose: np.ndarray | None = None    # [7]
    scale: np.ndarray | None = None   # [3]


class QuadricManager:
    """Host-side landmark table + the quadric geometry ops."""

    def __init__(self, Kc, min_obs_init: int = 3, min_points: int = 15):
        self.Kc = Kc
        self.landmarks: list[QuadricLandmark] = []
        self.min_obs_init = min_obs_init
        # a landmark is valid with >= 15 associated points (the reference's
        # gate); configurable for sparse synthetic maps
        self.min_points = min_points

    def add_keyframe_detections(self, m: ms.MapState, slot: int, detections):
        """detections: [D,6] (x, y, w, h, prob, class_id) rows.

        Counts this keyframe's map points inside each box, then merges the
        detection into the landmark of its class sharing the most points
        (at least max(3, a quarter of them)), or starts a new one."""
        if detections is None or len(detections) == 0:
            return
        det = np.asarray(detections, np.float32).reshape(-1, 6)
        obs = m.kf_obs_point[slot].cpu().numpy()
        uv = m.kf_uv[slot].cpu().numpy()
        has_pt = obs >= 0
        for x, y, w, h, _prob, cls in det:
            if w <= 2 or h <= 2:
                continue
            bbox = np.array([x, y, x + w, y + h], np.float32)
            inside = (has_pt
                      & (uv[:, 0] >= bbox[0]) & (uv[:, 0] <= bbox[2])
                      & (uv[:, 1] >= bbox[1]) & (uv[:, 1] <= bbox[3]))
            pts = set(obs[inside].tolist())
            if len(pts) < 3:
                continue
            best, best_shared = None, 0
            for lmk in self.landmarks:
                if lmk.class_id != int(cls):
                    continue
                shared = len(pts & lmk.point_ids)
                if shared > best_shared:
                    best, best_shared = lmk, shared
            if best is not None and best_shared >= max(3, len(pts) // 4):
                best.kf_slots.append(slot)
                best.bboxes.append(bbox)
                best.point_ids |= pts
            else:
                self.landmarks.append(QuadricLandmark(
                    class_id=int(cls), kf_slots=[slot], bboxes=[bbox], point_ids=pts))

    def try_initialize(self, m: ms.MapState) -> int:
        """SVD-init every landmark with enough views and points. Views in
        culled keyframes are dropped first (their poses are frozen at cull
        time and miss later corrections). A landmark initialized earlier
        stays initialized, and in joint BA, whatever its live views: the
        reference's behaviour, kept for parity. Returns how many were
        initialized by this call."""
        kf_valid = m.kf_valid.cpu().numpy()
        K = len(kf_valid)
        kf_pose = None
        n_new = 0
        for lmk in self.landmarks:
            kept = [(s, b) for s, b in zip(lmk.kf_slots, lmk.bboxes)
                    if 0 <= s < K and kf_valid[s]]
            lmk.kf_slots = [s for s, _ in kept]
            lmk.bboxes = [b for _, b in kept]
            if (lmk.initialized or len(lmk.kf_slots) < self.min_obs_init
                    or len(lmk.point_ids) < self.min_points):
                continue
            if kf_pose is None:
                kf_pose = m.kf_pose.cpu().numpy()
            dev = m.kf_pose.device
            quad, ok = quadrics.quadric_init(
                torch.as_tensor(kf_pose[lmk.kf_slots], device=dev), self.Kc,
                torch.as_tensor(np.stack(lmk.bboxes), device=dev),
                torch.ones(len(lmk.kf_slots), dtype=torch.bool, device=dev))
            if bool(ok):
                lmk.initialized = True
                lmk.pose = quad.pose.cpu().numpy()
                lmk.scale = quad.scale.cpu().numpy()
                n_new += 1
        return n_new

    def joint_ba(self, m: ms.MapState, inv_sigma2_tab, n_iters: int = 8):
        """Joint camera-point-quadric BA (``ba_problem``). Returns the map
        with keyframe poses and points written back (a new MapState: the old
        one is never written) and updates the landmarks' pose / scale. With
        no bbox edge left (every initialized landmark lost all its views)
        the map is returned unchanged."""
        prob = self.ba_problem(m, inv_sigma2_tab)
        if prob is None:
            return m
        out, _ = quadrics.quadric_ba_solve(prob, self.Kc, n_iters=n_iters)
        qp, qs = out.quad_pose.cpu().numpy(), out.quad_scale.cpu().numpy()
        for qi, lmk in enumerate(lmk for lmk in self.landmarks if lmk.initialized):
            lmk.pose, lmk.scale = qp[qi], qs[qi]
        return m._replace(kf_pose=out.base.poses, pt_pos=out.base.points)

    def ba_problem(self, m: ms.MapState, inv_sigma2_tab):
        """The joint problem over every initialized landmark's bbox edges
        and the whole [K, N] observation table (keyframe 0 and invalid
        keyframes fixed), on the map's device; None without a bbox edge."""
        init_lms = [lmk for lmk in self.landmarks if lmk.initialized]
        qe_cam = [s for lmk in init_lms for s in lmk.kf_slots]
        if not qe_cam:
            return None
        qe_quad = [qi for qi, lmk in enumerate(init_lms) for _ in lmk.kf_slots]
        qe_bbox = np.stack([b for lmk in init_lms for b in lmk.bboxes]).astype(np.float32)
        K_, N = m.kf_obs_point.shape
        P = m.pt_pos.shape[0]
        dev = m.pt_pos.device
        obs = m.kf_obs_point.to(torch.int64)
        pnt = torch.clamp(obs, 0, P - 1)
        okobs = (obs >= 0) & m.kf_kp_valid & m.kf_valid[:, None] & m.pt_valid[pnt]
        ar = torch.arange(K_, device=dev)
        lvl = torch.clamp(m.kf_level.to(torch.int64), 0, inv_sigma2_tab.shape[0] - 1)
        base = ba.BAProblem(
            poses=m.kf_pose, points=m.pt_pos, K=self.Kc,
            bf=torch.zeros((), dtype=torch.float32, device=dev),
            cam_idx=ar.repeat_interleave(N), pnt_idx=pnt.reshape(-1),
            uvr=torch.cat([m.kf_uv, torch.where(m.kf_ur > 0, m.kf_ur, 0.0)[..., None]],
                          dim=-1).reshape(-1, 3),
            is_stereo=(m.kf_ur > 0).reshape(-1).to(torch.float32),
            inv_sigma2=inv_sigma2_tab[lvl].reshape(-1),
            valid=okobs.reshape(-1).to(torch.float32),
            fixed_cam=((ar == 0) | ~m.kf_valid).to(torch.float32),
            fixed_pnt=(~m.pt_valid).to(torch.float32),
        )
        n_e = len(qe_cam)
        return quadrics.QuadricBAProblem(
            base=base,
            quad_pose=torch.as_tensor(np.stack([lmk.pose for lmk in init_lms]), device=dev),
            quad_scale=torch.as_tensor(np.stack([lmk.scale for lmk in init_lms]), device=dev),
            qe_cam=torch.as_tensor(qe_cam, dtype=torch.int64, device=dev),
            qe_quad=torch.as_tensor(qe_quad, dtype=torch.int64, device=dev),
            qe_bbox=torch.as_tensor(qe_bbox, device=dev),
            qe_valid=torch.ones(n_e, device=dev),
            qe_w=torch.full((n_e,), 1e-2, device=dev),
        )


def landmarks_from_numpy(landmarks) -> list[QuadricLandmark]:
    """Copies of another manager's landmarks (any objects with the fields
    of ``QuadricLandmark``; pose / scale as numpy float32)."""
    def arr(a):
        return None if a is None else np.array(a, np.float32)
    return [QuadricLandmark(
        class_id=int(lmk.class_id), kf_slots=[int(s) for s in lmk.kf_slots],
        bboxes=[np.array(b, np.float32) for b in lmk.bboxes],
        point_ids={int(p) for p in lmk.point_ids}, initialized=bool(lmk.initialized),
        pose=arr(lmk.pose), scale=arr(lmk.scale)) for lmk in landmarks]
