"""Per-frame perception frontend: ORB extraction + undistortion (mono).

Counterpart of the reference's ``models/frontend.py``: a fixed-capacity
``FrameFeatures`` per frame, on the image's device.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import NamedTuple

import numpy as np
import torch

from ..ops import camera, orb


@dataclasses.dataclass(frozen=True)
class FrontendConfig:
    height: int
    width: int
    n_features: int = 1024
    n_levels: int = 8
    scale_factor: float = 1.2
    th_fast: float = 20.0
    th_fast_min: float = 7.0
    # intrinsics
    fx: float = 500.0
    fy: float = 500.0
    cx: float = 320.0
    cy: float = 240.0
    k1: float = 0.0
    k2: float = 0.0
    p1: float = 0.0
    p2: float = 0.0
    k3: float = 0.0
    bf: float = 0.0          # fx * baseline (0 = mono)
    depth_th: float = 40.0   # ThDepth close/far gate

    @property
    def K(self):
        """[4] float32 intrinsics on the CPU (``.to(device)`` as needed)."""
        return torch.tensor([self.fx, self.fy, self.cx, self.cy], dtype=torch.float32)

    @property
    def dist(self):
        return torch.tensor([self.k1, self.k2, self.p1, self.p2, self.k3],
                            dtype=torch.float32)


class FrameFeatures(NamedTuple):
    uv: torch.Tensor       # [N,2] raw keypoint pixels (level-0)
    uv_und: torch.Tensor   # [N,2] undistorted pixels
    level: torch.Tensor    # [N] int32
    angle: torch.Tensor    # [N]
    score: torch.Tensor    # [N]
    desc: torch.Tensor     # [N,8] int32 (uint32 words' bits)
    valid: torch.Tensor    # [N] bool
    ur: torch.Tensor       # [N] right-image u (<0 where unavailable)
    depth: torch.Tensor    # [N] depth (<=0 where unavailable)


@functools.lru_cache(maxsize=32)
def intrinsics(cfg: FrontendConfig, device: str):
    """(K [4], dist [5]) of ``cfg`` on ``device``, built once per device."""
    return cfg.K.to(device), cfg.dist.to(device)


def extract_mono(cfg: FrontendConfig, img) -> FrameFeatures:
    """ORB features of one grayscale image (any integer or float dtype)."""
    img = img.to(torch.float32)
    dev = img.device
    f = orb.extract(img, n_features=cfg.n_features, n_levels=cfg.n_levels,
                    scale=cfg.scale_factor, th_fast=cfg.th_fast,
                    th_fast_min=cfg.th_fast_min)
    K, dist = intrinsics(cfg, str(dev))
    und = camera.undistort_points(K, dist, f.uv)
    n = f.uv.shape[0]
    return FrameFeatures(
        uv=f.uv, uv_und=und, level=f.level, angle=f.angle, score=f.score,
        desc=f.desc, valid=f.valid,
        ur=torch.full((n,), -1.0, device=dev), depth=torch.zeros(n, device=dev),
    )


def frame_features_from_numpy(src, device="cpu") -> FrameFeatures:
    """``FrameFeatures`` from any object with the same field names holding
    array-likes; uint32 descriptors become their int32 view."""
    out = {}
    for f in FrameFeatures._fields:
        a = np.asarray(getattr(src, f))
        if f == "desc":
            a = np.ascontiguousarray(a.astype(np.uint32)).view(np.int32)
        out[f] = torch.as_tensor(np.array(a), device=device)
    return FrameFeatures(**out)


def frame_features_to_numpy(f: FrameFeatures) -> dict:
    out = {k: getattr(f, k).detach().cpu().numpy() for k in FrameFeatures._fields}
    out["desc"] = out["desc"].view(np.uint32)
    return out
