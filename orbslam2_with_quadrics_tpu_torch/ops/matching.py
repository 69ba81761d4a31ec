"""Descriptor matching: Hamming popcount + masked dense search (torch).

Counterpart of the reference's ``ops/matching.py``. Every search variant is
one masked best/second-best over a [queries x keypoints] distance matrix;
``match_by_projection`` gets that reduction from
``cuda_kernels.masked_hamming_best2`` (the hand-written CUDA kernel for
CUDA tensors, its plain version for CPU tensors).

Descriptors are [.., 8] int32 views of the 256-bit uint32 words.
"""

from __future__ import annotations

import functools
import math

import torch

from . import cuda_kernels
from .orb import topk_stable

TH_LOW = 50
TH_HIGH = 100
HISTO_LENGTH = 30

_BIG = 1 << 20
_INT32_MAX = 2147483647
# rows per chunk of the [rows, Nb, 32] byte-LUT gather (bounds its memory)
_LUT_ELEMS = 1 << 24


@functools.lru_cache(maxsize=8)
def _popcount_lut(device: str):
    return torch.tensor([bin(i).count("1") for i in range(256)],
                        dtype=torch.int32, device=device)


def popcount_words(x):
    """[..., W] int32 -> [...] int32: total set bits over the last axis,
    through a 256-entry byte table on the int32 words' bytes."""
    lut = _popcount_lut(str(x.device))
    b = x.contiguous().view(torch.uint8).to(torch.int64)
    return lut[b].sum(dim=-1, dtype=torch.int32)


def hamming_matrix(desc_a, desc_b):
    """[Na,8] x [Nb,8] int32 -> [Na,Nb] int32 Hamming distances."""
    na, nb = desc_a.shape[0], desc_b.shape[0]
    step = max(1, _LUT_ELEMS // max(32 * nb, 1))
    out = [
        popcount_words(desc_a[i: i + step, None, :] ^ desc_b[None, :, :])
        for i in range(0, na, step)
    ]
    return torch.cat(out) if out else torch.zeros((0, nb), dtype=torch.int32,
                                                  device=desc_a.device)


def best_two(dist, valid_mask):
    """Masked (best_idx, best, second) over the last axis (leading axes are
    batch); a row with no admissible candidate gives (0, _BIG, _BIG).
    argbest is the lowest index reaching the minimum; second masks only
    that column, so exact ties give second == best."""
    d = torch.where(valid_mask, dist, _BIG)
    best_idx = torch.argmin(d, dim=-1, keepdim=True)  # first index reaching the minimum
    best = torch.gather(d, -1, best_idx)
    second = torch.amin(d.scatter(-1, best_idx, _BIG), dim=-1)
    return best_idx[..., 0], best[..., 0], second


def _resolve_one_to_one(ok, best_idx, best, n_targets: int):
    """Each target keypoint keeps exactly one winning query: min over
    (distance, query-index) keys."""
    q = torch.arange(best_idx.shape[0], device=best_idx.device)
    key = (torch.clamp(best.to(torch.int64), 0, (1 << 18) - 1) << 12) | (q & 0xFFF)
    kp_best = torch.full((n_targets + 1,), _INT32_MAX, dtype=torch.int64,
                         device=best_idx.device)
    kp_best = kp_best.scatter_reduce(
        0, torch.where(ok, best_idx, n_targets),
        torch.where(ok, key, _INT32_MAX), reduce="amin",
    )
    return ok & (key == kp_best[best_idx])


def rotation_consistency(angle_q, angle_t, valid):
    """Keep only matches whose q-t angle difference falls in the 3 dominant
    30-bin histogram bins (bins 2/3 dropped below 0.1x the max)."""
    two_pi = 2.0 * math.pi
    rot = torch.remainder(angle_q - angle_t, two_pi)
    b = torch.clamp(torch.round(rot * (HISTO_LENGTH / two_pi)).to(torch.int64),
                    0, HISTO_LENGTH) % HISTO_LENGTH
    hist = torch.zeros(HISTO_LENGTH, dtype=torch.int32, device=b.device)
    hist = hist.index_add(0, b, valid.to(torch.int32))
    top_v, top_i = topk_stable(hist, 3)
    keep = top_v.to(torch.float32) >= 0.1 * top_v[0].to(torch.float32)
    keep[0] = True
    keep_bin = torch.zeros(HISTO_LENGTH, dtype=torch.int32, device=b.device)
    keep_bin = keep_bin.scatter_reduce(0, top_i, keep.to(torch.int32), reduce="amax")
    return valid & (keep_bin[b] > 0)


def _ratio_ok(best, second, th, ratio):
    return (best <= th) & (best.to(torch.float32) <= ratio * second.to(torch.float32))


def match_by_projection(
    proj_uv, proj_valid, pred_level, query_desc, query_angle,
    feats_uv, feats_level, feats_desc, feats_angle, feats_valid,
    radius, scale_factors, th=TH_HIGH, ratio=0.9, level_tol=1,
    check_rotation=False,
):
    """Guided matching: project map points, search nearby keypoints.

    ``radius`` (level-0 pixels, scalar or [Q]) is multiplied by the scale
    factor of each query's predicted level. Returns (match_idx [Q] int64
    keypoint index or -1, match_dist [Q] int32); each keypoint keeps only
    its best query.
    """
    Q = proj_uv.shape[0]
    lvl = torch.clamp(pred_level, 0, scale_factors.shape[0] - 1)
    r = radius * scale_factors[lvl]
    r = torch.broadcast_to(torch.as_tensor(r, dtype=torch.float32,
                                           device=proj_uv.device), (Q,))
    bidx, best, second = cuda_kernels.masked_hamming_best2(
        query_desc.to(torch.int32).contiguous(),
        proj_uv.to(torch.float32).contiguous(),
        r.contiguous(),
        pred_level.to(torch.int32).contiguous(),
        proj_valid.to(torch.bool).contiguous(),
        feats_desc.to(torch.int32).contiguous(),
        feats_uv.to(torch.float32).contiguous(),
        feats_level.to(torch.int32).contiguous(),
        feats_valid.to(torch.bool).contiguous(),
        level_tol=level_tol,
    )
    best_idx = bidx.to(torch.int64)
    ok = _ratio_ok(best, second, th, ratio)
    if check_rotation:
        ok = rotation_consistency(query_angle, feats_angle[best_idx], ok)
    ok = _resolve_one_to_one(ok, best_idx, best, feats_uv.shape[0])
    return torch.where(ok, best_idx, -1), torch.where(ok, best, _BIG)


def match_windowed(
    uv_a, desc_a, angle_a, valid_a, uv_b, desc_b, angle_b, valid_b,
    window: float, th=TH_LOW, ratio=0.9, check_rotation=True,
    level_a=None, level_b=None, level0_only=True,
):
    """SearchForInitialization-style windowed matching between two frames
    (level-0 keypoints only). Returns (match_idx [Na] into B or -1,
    match_dist [Na])."""
    mask = valid_a[:, None] & valid_b[None, :]
    if level0_only and level_a is not None:
        mask = mask & (level_a[:, None] == 0) & (level_b[None, :] == 0)
    du = torch.abs(uv_a[:, 0:1] - uv_b[None, :, 0])
    dv = torch.abs(uv_a[:, 1:2] - uv_b[None, :, 1])
    mask = mask & (du <= window) & (dv <= window)
    best_idx, best, second = best_two(hamming_matrix(desc_a, desc_b), mask)
    ok = _ratio_ok(best, second, th, ratio)
    if check_rotation:
        ok = rotation_consistency(angle_a, angle_b[best_idx], ok)
    ok = _resolve_one_to_one(ok, best_idx, best, uv_b.shape[0])
    return torch.where(ok, best_idx, -1), torch.where(ok, best, _BIG)
