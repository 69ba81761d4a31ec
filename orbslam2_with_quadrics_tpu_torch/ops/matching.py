"""Descriptor matching: Hamming popcount + masked dense search (torch).

Counterpart of the reference's ``ops/matching.py``. Every search variant is
one masked best/second-best over a [queries x keypoints] distance matrix;
``match_by_projection`` gets that reduction from
``cuda_kernels.masked_hamming_best2`` (the hand-written CUDA kernel for
CUDA tensors, its plain version for CPU tensors).

Descriptors are [.., 8] int32 views of the 256-bit uint32 words.
"""

from __future__ import annotations

import math

import torch

from . import cuda_kernels
from .orb import topk_stable

TH_LOW = 50
TH_HIGH = 100
HISTO_LENGTH = 30

_BIG = 1 << 20
_INT32_MAX = 2147483647
# bytes per chunk of hamming_matrix's [rows, Nb, 8] int32 XOR (bounds the
# memory of its temporaries)
_CHUNK_BYTES = 1 << 24


def popcount_words(x):
    """[..., W] int32 -> [...] int32: total set bits over the last axis, by
    bit arithmetic on the words (pairs, nibbles, bytes, then one multiply
    sums the four bytes; the shifts are arithmetic, so each is masked)."""
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return (((x * 0x01010101) >> 24) & 0xFF).sum(dim=-1, dtype=torch.int32)


def hamming_matrix(desc_a, desc_b):
    """[Na,8] x [Nb,8] int32 -> [Na,Nb] int32 Hamming distances."""
    na, nb = desc_a.shape[0], desc_b.shape[0]
    step = max(1, _CHUNK_BYTES // max(32 * nb, 1))
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


def _batch_slots(lead, width: int, device):
    """[*lead, 1] int64 offsets that give every batch entry its own run of
    ``width`` slots in one flat scatter target."""
    n = math.prod(lead)
    return (torch.arange(n, device=device) * width).reshape(tuple(lead) + (1,))


def _resolve_one_to_one(ok, best_idx, best, n_targets: int):
    """Each target keypoint keeps exactly one winning query: min over
    (distance, query-index) keys. Leading axes are a batch: one scatter
    into (n_targets + 1) slots per entry."""
    dev = best_idx.device
    q = torch.arange(best_idx.shape[-1], device=dev)
    key = (torch.clamp(best.to(torch.int64), 0, (1 << 18) - 1) << 12) | (q & 0xFFF)
    slot = _batch_slots(best_idx.shape[:-1], n_targets + 1, dev)
    kp_best = torch.full((slot.numel() * (n_targets + 1),), _INT32_MAX,
                         dtype=torch.int64, device=dev)
    kp_best = kp_best.scatter_reduce(
        0, (slot + torch.where(ok, best_idx, n_targets)).reshape(-1),
        torch.where(ok, key, _INT32_MAX).reshape(-1), reduce="amin",
    )
    return ok & (key == kp_best[slot + best_idx])


def rotation_consistency(angle_q, angle_t, valid):
    """Keep only matches whose q-t angle difference falls in the 3 dominant
    30-bin histogram bins (bins 2/3 dropped below 0.1x the max). Leading
    axes are a batch: one histogram per entry."""
    two_pi = 2.0 * math.pi
    rot = torch.remainder(angle_q - angle_t, two_pi)
    b = torch.clamp(torch.round(rot * (HISTO_LENGTH / two_pi)).to(torch.int64),
                    0, HISTO_LENGTH) % HISTO_LENGTH
    lead = tuple(b.shape[:-1])
    slot = _batch_slots(lead, HISTO_LENGTH, b.device)
    hist = torch.zeros(slot.numel() * HISTO_LENGTH, dtype=torch.int32, device=b.device)
    hist = hist.index_add(0, (slot + b).reshape(-1), valid.to(torch.int32).reshape(-1))
    top_v, top_i = topk_stable(hist.reshape(lead + (HISTO_LENGTH,)), 3)
    keep = top_v.to(torch.float32) >= 0.1 * top_v[..., :1].to(torch.float32)
    keep[..., 0] = True
    keep_bin = torch.zeros(lead + (HISTO_LENGTH,), dtype=torch.int32, device=b.device)
    keep_bin = keep_bin.scatter_reduce(-1, top_i, keep.to(torch.int32), reduce="amax")
    return valid & (torch.gather(keep_bin, -1, b) > 0)


def _ratio_ok(best, second, th, ratio):
    return (best <= th) & (best.to(torch.float32) <= ratio * second.to(torch.float32))


def _laid_out(t, dtype):
    """``t`` as a contiguous tensor of ``dtype``; ``t`` itself when it is one."""
    if t.dtype != dtype:
        t = t.to(dtype)
    return t if t.is_contiguous() else t.contiguous()


def match_by_projection(
    proj_uv, proj_valid, pred_level, query_desc, query_angle,
    feats_uv, feats_level, feats_desc, feats_angle, feats_valid,
    radius, scale_factors, th=TH_HIGH, ratio=0.9, level_tol=1,
    check_rotation=False,
):
    """Guided matching: project map points, search nearby keypoints.

    ``radius`` (level-0 pixels, a scalar or broadcastable to the queries)
    is multiplied by the scale factor of each query's predicted level.
    Returns (match_idx [Q] int64 keypoint index or -1, match_dist [Q]
    int32); each keypoint keeps only its best query. ``query_angle`` and
    ``feats_angle`` are read only with ``check_rotation``.

    A leading batch axis runs B independent searches through one kernel
    launch: queries [B, Q, ...] against keypoints [B, N, ...], or against
    one keypoint set [N, ...] shared by the batch (each entry still
    resolves its keypoints' winners on its own). Returns [B, Q] tensors.
    """
    lvl = torch.clamp(pred_level, 0, scale_factors.shape[0] - 1)
    r = radius * scale_factors[lvl]
    r = torch.broadcast_to(torch.as_tensor(r, dtype=torch.float32,
                                           device=proj_uv.device), pred_level.shape)
    bidx, best, second = cuda_kernels.masked_hamming_best2(
        _laid_out(query_desc, torch.int32), _laid_out(proj_uv, torch.float32),
        _laid_out(r, torch.float32), _laid_out(pred_level, torch.int32),
        _laid_out(proj_valid, torch.bool),
        _laid_out(feats_desc, torch.int32), _laid_out(feats_uv, torch.float32),
        _laid_out(feats_level, torch.int32), _laid_out(feats_valid, torch.bool),
        level_tol=level_tol,
    )
    best_idx = bidx.to(torch.int64)
    ok = _ratio_ok(best, second, th, ratio)
    if check_rotation:
        angle_t = (feats_angle[best_idx] if feats_angle.dim() == 1
                   else torch.gather(feats_angle, -1, best_idx))
        ok = rotation_consistency(query_angle, angle_t, ok)
    ok = _resolve_one_to_one(ok, best_idx, best, feats_uv.shape[-2])
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
