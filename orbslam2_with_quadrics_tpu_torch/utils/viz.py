"""Visualization: frame overlays, map snapshots and the per-frame metrics
file.

Counterpart of the reference package's ``utils/viz.py``; host-side and off
every driver's path. In place of the original system's GUI thread it
renders to images, headless:

- ``draw_frame``: keypoints and tracked matches over the frame, with a HUD
  line ("KFs / MPs / Matches");
- ``draw_map``: a top-down render of the map points and keyframe centres,
  with the quadric landmarks' ellipses;
- ``save_metrics_jsonl``: ``System.metrics``, one JSON object per line.

The two draw functions need OpenCV (imported when called); the metrics
writer needs nothing.
"""

from __future__ import annotations

import json

import numpy as np
import torch


def _np(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def draw_frame(img, feats, obs_point, state_text=""):
    """Overlay keypoints on a grayscale frame -> uint8 BGR image."""
    import cv2

    vis = cv2.cvtColor(np.clip(_np(img), 0, 255).astype(np.uint8), cv2.COLOR_GRAY2BGR)
    uv = _np(feats.uv)
    valid = _np(feats.valid)
    matched = _np(obs_point) >= 0
    for i in range(len(uv)):
        if not valid[i]:
            continue
        p = (int(uv[i, 0]), int(uv[i, 1]))
        if matched[i]:
            cv2.rectangle(vis, (p[0] - 3, p[1] - 3), (p[0] + 3, p[1] + 3), (0, 255, 0), 1)
        else:
            cv2.circle(vis, p, 1, (120, 120, 120), -1)
    if state_text:
        cv2.putText(vis, state_text, (8, vis.shape[0] - 8), cv2.FONT_HERSHEY_PLAIN,
                    0.9, (255, 255, 255), 1)
    return vis


def draw_map(m, quadric_landmarks=None, size=800, axes=(0, 1)):
    """Orthographic map render (points, keyframe centres, quadric ellipses)
    -> uint8 BGR image. ``axes`` picks the two world axes to plot."""
    import cv2

    from ..models import map_state as ms

    vis = np.full((size, size, 3), 20, np.uint8)
    pts = _np(m.pt_pos)[_np(m.pt_valid)]
    centers = _np(ms.camera_centers(m))[_np(m.kf_valid)]
    if len(pts) == 0:
        return vis
    a, b = axes
    allxy = np.concatenate([pts[:, [a, b]], centers[:, [a, b]]], axis=0)
    lo = allxy.min(0) - 0.3
    hi = allxy.max(0) + 0.3
    scale = (size - 20) / max(float((hi - lo).max()), 1e-6)

    def to_px(xy):
        return ((xy - lo) * scale + 10).astype(np.int32)

    for p in to_px(pts[:, [a, b]]):
        cv2.circle(vis, tuple(p), 1, (180, 180, 180), -1)
    for c in to_px(centers[:, [a, b]]):
        cv2.circle(vis, tuple(c), 3, (0, 200, 0), -1)
    for lmk in quadric_landmarks or ():
        if not getattr(lmk, "initialized", False):
            continue
        ctr = _np(lmk.pose)[4:7][[a, b]]
        sc = _np(lmk.scale)[[a, b]]
        cv2.ellipse(vis, tuple(to_px(ctr)),
                    (max(int(sc[0] * scale), 2), max(int(sc[1] * scale), 2)),
                    0, 0, 360, (0, 120, 255), 1)
    return vis


def save_metrics_jsonl(path, metrics_list):
    """Per-frame metrics (inliers, state, ...) to JSONL, one object a line."""
    with open(path, "w") as f:
        for row in metrics_list:
            f.write(json.dumps(row) + "\n")
