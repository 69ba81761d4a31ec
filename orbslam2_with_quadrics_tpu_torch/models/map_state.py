"""Struct-of-arrays SLAM map state as torch tensors.

Counterpart of the reference's ``models/map_state.py``: one ``MapState``
of fixed-capacity padded tensors with the same fields and layouts;
"insert" bumps a counter and writes a row, "erase" clears a validity bit,
and every cross-reference is an integer index (``kf_obs_point[k, n]`` is
the point keypoint n of keyframe k observes, or -1). Descriptors are the
int32 view of the reference's uint32 words.

The functions are pure: they return a new ``MapState`` and leave their
input untouched (tensors are copied before a row is written), so a
snapshot held elsewhere never changes under its holder. The device is the
one ``MapConfig.device`` names: the card unless the caller asks for the CPU.

Where several writes may land on one slot, the reference's scatter keeps
the last one (XLA applies updates in order); :func:`scatter_last` makes
that rule explicit, since a CUDA ``index_put_`` keeps an arbitrary one.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from ..ops import lie
from ..ops.matching import popcount_words
from ..ops.orb import pack_bits


@dataclasses.dataclass(frozen=True)
class MapConfig:
    max_keyframes: int = 256
    max_points: int = 16384
    n_features: int = 1024      # keypoint capacity per keyframe
    n_levels: int = 8
    scale_factor: float = 1.2
    device: str = "cuda"        # "cpu" only when asked for


class MapState(NamedTuple):
    # --- keyframes ---
    kf_pose: torch.Tensor       # [K,7] T_cw
    kf_valid: torch.Tensor      # [K] bool
    kf_frame_id: torch.Tensor   # [K] int32 source frame index
    kf_parent: torch.Tensor     # [K] int32 spanning-tree parent (-1 root)
    kf_tcp: torch.Tensor        # [K,7] T_child_parent frozen at cull time
    kf_uv: torch.Tensor         # [K,N,2] undistorted keypoints
    kf_ur: torch.Tensor         # [K,N] right-image u (<0 = mono)
    kf_level: torch.Tensor      # [K,N] int32
    kf_angle: torch.Tensor      # [K,N]
    kf_desc: torch.Tensor       # [K,N,8] int32 (uint32 words' bits)
    kf_kp_valid: torch.Tensor   # [K,N] bool
    kf_obs_point: torch.Tensor  # [K,N] int32 map point id or -1
    # --- map points ---
    pt_pos: torch.Tensor        # [P,3]
    pt_valid: torch.Tensor      # [P] bool
    pt_desc: torch.Tensor       # [P,8] int32 representative descriptor
    pt_normal: torch.Tensor     # [P,3] mean viewing direction
    pt_min_dist: torch.Tensor   # [P] scale-invariance band
    pt_max_dist: torch.Tensor   # [P]
    pt_found: torch.Tensor      # [P] int32 (tracking found count)
    pt_visible: torch.Tensor    # [P] int32 (tracking visible count)
    pt_first_kf: torch.Tensor   # [P] int32 creating keyframe
    # --- counters ---
    n_kf: torch.Tensor          # scalar int32 next free keyframe slot
    n_pt: torch.Tensor          # scalar int32 next free point slot


_DESC_FIELDS = ("kf_desc", "pt_desc")


def empty_map(cfg: MapConfig) -> MapState:
    K, P, N = cfg.max_keyframes, cfg.max_points, cfg.n_features
    dev = torch.device(cfg.device)
    f32, i32 = torch.float32, torch.int32

    def full(shape, v, dtype):
        return torch.full(shape, v, dtype=dtype, device=dev)

    return MapState(
        kf_pose=lie.se3_identity((K,), device=dev),
        kf_valid=full((K,), False, torch.bool),
        kf_frame_id=full((K,), -1, i32),
        kf_parent=full((K,), -1, i32),
        kf_tcp=lie.se3_identity((K,), device=dev),
        kf_uv=full((K, N, 2), 0.0, f32),
        kf_ur=full((K, N), -1.0, f32),
        kf_level=full((K, N), 0, i32),
        kf_angle=full((K, N), 0.0, f32),
        kf_desc=full((K, N, 8), 0, i32),
        kf_kp_valid=full((K, N), False, torch.bool),
        kf_obs_point=full((K, N), -1, i32),
        pt_pos=full((P, 3), 0.0, f32),
        pt_valid=full((P,), False, torch.bool),
        pt_desc=full((P, 8), 0, i32),
        pt_normal=full((P, 3), 0.0, f32),
        pt_min_dist=full((P,), 0.0, f32),
        pt_max_dist=full((P,), 1e9, f32),
        pt_found=full((P,), 0, i32),
        pt_visible=full((P,), 0, i32),
        pt_first_kf=full((P,), -1, i32),
        n_kf=full((), 0, i32),
        n_pt=full((), 0, i32),
    )


# ---------------------------------------------------------------------------
# carrying a map across from the reference package (numpy in both directions)
# ---------------------------------------------------------------------------

def _to_tensor(a, device, uint32_view: bool):
    a = np.asarray(a)
    if uint32_view:
        a = np.ascontiguousarray(a.astype(np.uint32)).view(np.int32)
    return torch.as_tensor(np.array(a), device=device)


def map_state_from_numpy(src, device="cpu") -> MapState:
    """A ``MapState`` from any object with the same field names holding
    array-likes (numpy arrays, or the reference package's arrays): uint32
    descriptors become their int32 view, everything else keeps its dtype."""
    return MapState(**{
        f: _to_tensor(getattr(src, f), device, f in _DESC_FIELDS)
        for f in MapState._fields
    })


def map_state_to_numpy(m: MapState) -> dict:
    """Field name -> numpy array, descriptors as uint32 (the reference's
    layout)."""
    out = {f: getattr(m, f).detach().cpu().numpy() for f in MapState._fields}
    for f in _DESC_FIELDS:
        out[f] = out[f].view(np.uint32)
    return out


class HostCopy:
    """A device tensor copied to pinned host memory without blocking; the
    CUDA event says when the copy (and everything queued before it) is
    done. A CPU tensor is its own host copy."""

    def __init__(self, t):
        self.event = None
        if t.is_cuda:
            self.host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            self.host.copy_(t, non_blocking=True)
            self.event = torch.cuda.Event()
            self.event.record()
        else:
            self.host = t

    def ready(self) -> bool:
        return self.event is None or self.event.query()

    def numpy(self):
        if self.event is not None:
            self.event.synchronize()
        return self.host.numpy()


# ---------------------------------------------------------------------------
# scatter helpers
# ---------------------------------------------------------------------------

def scatter_last(dst, idx, vals, ok):
    """dst[idx[i]] = vals[i] for rows with ok[i]; where several rows hit
    one slot the LAST such row wins (the reference's in-order scatter).
    Returns a new tensor."""
    n = dst.shape[0]
    pos = torch.arange(idx.shape[0], device=idx.device)
    tgt = torch.where(ok, idx, n)
    win = torch.full((n + 1,), -1, dtype=torch.int64, device=dst.device)
    win = win.scatter_reduce(0, tgt, pos, reduce="amax")
    keep = ok & (win[torch.clamp(tgt, 0, n)] == pos)
    ext = torch.cat([dst, dst[:1]])
    ext[torch.where(keep, idx, n)] = vals.to(dst.dtype)
    return ext[:n]


def set_rows(dst, idx, vals, ok):
    """dst[idx[i]] = vals[i] for rows with ok[i], where the ok rows' indices
    are distinct (others go to a dropped spare row). Returns a new tensor."""
    n = dst.shape[0]
    ext = torch.cat([dst, dst[:1]])
    ext[torch.where(ok, idx, n)] = vals.to(dst.dtype)
    return ext[:n]


# ---------------------------------------------------------------------------
# derived structure
# ---------------------------------------------------------------------------

def _obs_mask(m: MapState):
    return (m.kf_obs_point >= 0) & m.kf_kp_valid & m.kf_valid[:, None]


def observation_matrix(m: MapState, dtype=torch.float32):
    """Binary [K,P] observation matrix A: A[k,p]=1 iff keyframe k observes
    point p (float32: its products count exactly)."""
    K, N = m.kf_obs_point.shape
    P = m.pt_pos.shape[0]
    mask = _obs_mask(m)
    A = torch.zeros((K, P + 1), dtype=dtype, device=m.pt_pos.device)
    rows = torch.arange(K, device=A.device)[:, None].expand(K, N)
    A[rows, torch.where(mask, m.kf_obs_point.to(torch.int64), P)] = 1.0
    return A[:, :P]


def covisibility(m: MapState):
    """[K,K] int32 covisibility weights (shared-point counts)."""
    A = observation_matrix(m)
    W = (A @ A.T).to(torch.int32)
    return W * (1 - torch.eye(W.shape[0], dtype=torch.int32, device=W.device))


def point_obs_count(m: MapState):
    """[P] number of keyframes observing each point."""
    P = m.pt_pos.shape[0]
    mask = _obs_mask(m)
    idx = torch.where(mask, m.kf_obs_point.to(torch.int64), P).reshape(-1)
    cnt = torch.zeros(P + 1, dtype=torch.int32, device=idx.device)
    return cnt.index_add(0, idx, mask.reshape(-1).to(torch.int32))[:P]


def obs_level_cum(m: MapState, n_levels: int):
    """[P, n_levels] cum[p, l] = #keyframe observations of point p at
    octave <= l (the KeyFrameCulling same-or-finer-scale histogram)."""
    P = m.pt_pos.shape[0]
    has = _obs_mask(m).reshape(-1)
    flat_p = torch.where(has, m.kf_obs_point.reshape(-1).to(torch.int64), P)
    lvl = torch.clamp(m.kf_level, 0, n_levels - 1).reshape(-1).to(torch.int64)
    hist = torch.zeros((P + 1) * n_levels, dtype=torch.float32, device=m.pt_pos.device)
    hist = hist.index_add(0, flat_p * n_levels + lvl, has.to(torch.float32))
    return torch.cumsum(hist.reshape(P + 1, n_levels)[:P], dim=1)


# ---------------------------------------------------------------------------
# insertion / mutation
# ---------------------------------------------------------------------------

def insert_keyframe(m: MapState, pose, frame_id, uv, ur, level, angle, desc,
                    kp_valid, obs_point, parent):
    """Append one keyframe at slot n_kf (no-op if the pool is full).
    Returns (map, slot) with slot a device scalar."""
    k = m.n_kf.to(torch.int64)
    K = m.kf_valid.shape[0]
    ok = k < K
    kc = torch.clamp(k, 0, K - 1).reshape(1)

    def put(arr, row):
        if torch.is_tensor(row):
            row = row.to(arr.dtype)
        else:  # a Python scalar: a device fill, not a host-to-device copy
            row = torch.full((), row, dtype=arr.dtype, device=arr.device)
        out = arr.clone()
        out[kc] = torch.where(ok, row, arr[kc[0]]).unsqueeze(0)
        return out

    return m._replace(
        kf_pose=put(m.kf_pose, pose),
        kf_valid=put(m.kf_valid, True),
        kf_frame_id=put(m.kf_frame_id, frame_id),
        kf_parent=put(m.kf_parent, parent),
        kf_uv=put(m.kf_uv, uv),
        kf_ur=put(m.kf_ur, ur),
        kf_level=put(m.kf_level, level),
        kf_angle=put(m.kf_angle, angle),
        kf_desc=put(m.kf_desc, desc),
        kf_kp_valid=put(m.kf_kp_valid, kp_valid),
        kf_obs_point=put(m.kf_obs_point, obs_point),
        n_kf=(m.n_kf + ok.to(torch.int32)),
    ), kc[0]


def insert_points(m: MapState, pos, desc, first_kf, want):
    """Allocate a batch of map points; returns (map, slot_ids [B] or -1).
    Slots are assigned compactly from n_pt; overflow rows get -1."""
    P = m.pt_pos.shape[0]
    offs = torch.cumsum(want.to(torch.int64), 0) - 1
    slots = m.n_pt.to(torch.int64) + offs
    ok = want & (slots < P)
    B = want.shape[0]
    one = torch.ones(B, dtype=torch.int32, device=want.device)
    m = m._replace(
        pt_pos=set_rows(m.pt_pos, slots, pos, ok),
        pt_desc=set_rows(m.pt_desc, slots, desc, ok),
        pt_valid=set_rows(m.pt_valid, slots, ok, ok),
        pt_first_kf=set_rows(m.pt_first_kf, slots, first_kf, ok),
        pt_found=set_rows(m.pt_found, slots, one, ok),
        pt_visible=set_rows(m.pt_visible, slots, one, ok),
        n_pt=torch.clamp(m.n_pt + torch.sum(want.to(torch.int32)), max=P).to(torch.int32),
    )
    return m, torch.where(ok, slots, -1)


def update_point_stats(m: MapState, scale_factors):
    """Refresh representative descriptors, normals and scale bands from the
    observation table (batched ComputeDistinctiveDescriptors +
    UpdateNormalAndDepth). The representative descriptor is the observation
    closest to the bitwise majority descriptor (ties: the last one)."""
    K, N = m.kf_obs_point.shape
    P = m.pt_pos.shape[0]
    dev = m.pt_pos.device
    mask = _obs_mask(m).reshape(-1)
    flat_p = torch.where(mask, m.kf_obs_point.reshape(-1).to(torch.int64), P)
    w = mask.to(torch.float32)

    # majority descriptor per point (bitwise vote)
    desc = m.kf_desc.reshape(K * N, 8)
    shifts = torch.arange(32, device=dev, dtype=torch.int32)
    bits = ((desc[:, :, None] >> shifts) & 1).to(torch.float32).reshape(K * N, 256)
    votes = torch.zeros((P + 1, 256), device=dev).index_add(0, flat_p, bits * w[:, None])[:P]
    cnt = torch.zeros(P + 1, device=dev).index_add(0, flat_p, w)[:P]
    maj_desc = pack_bits(votes > 0.5 * torch.clamp(cnt, min=1.0)[:, None])   # [P,8]

    # medoid: among observations, the one closest to the majority
    pcl = torch.clamp(flat_p, 0, P - 1)
    d2maj = popcount_words(desc ^ maj_desc[pcl]).to(torch.float32)
    d2maj = torch.where(w > 0, d2maj, 1e9)
    best = torch.full((P + 1,), float("inf"), device=dev).scatter_reduce(
        0, flat_p, d2maj, reduce="amin")[:P]
    is_best = (d2maj <= best[pcl] + 0.5) & (w > 0)
    pt_desc = scatter_last(m.pt_desc, flat_p, desc, is_best)
    pt_desc = torch.where(cnt[:, None] > 0, pt_desc, m.pt_desc)

    # normals & scale band
    centers = camera_centers(m).repeat_interleave(N, dim=0)          # [KN,3]
    vec = m.pt_pos[pcl] - centers
    dist = torch.linalg.norm(vec, dim=-1, keepdim=True)
    nrm = vec / torch.clamp(dist, min=1e-9)
    normal = torch.zeros((P + 1, 3), device=dev).index_add(0, flat_p, nrm * w[:, None])[:P]
    normal = normal / torch.clamp(torch.linalg.norm(normal, dim=-1, keepdim=True), min=1e-9)

    lvl = m.kf_level.reshape(K * N).to(torch.float32)
    den = torch.clamp(cnt, min=1.0)
    mean_lvl = torch.zeros(P + 1, device=dev).index_add(0, flat_p, lvl * w)[:P] / den
    mean_dist = torch.zeros(P + 1, device=dev).index_add(0, flat_p, dist[:, 0] * w)[:P] / den
    n_levels = scale_factors.shape[0]
    sf = scale_factors[torch.clamp(mean_lvl.to(torch.int64), 0, n_levels - 1)]
    max_dist = mean_dist * sf
    min_dist = max_dist / scale_factors[n_levels - 1]

    has = cnt > 0
    return m._replace(
        pt_desc=pt_desc,
        pt_normal=torch.where(has[:, None], normal, m.pt_normal),
        pt_max_dist=torch.where(has, 1.2 * max_dist, m.pt_max_dist),
        pt_min_dist=torch.where(has, 0.8 * min_dist, m.pt_min_dist),
    )


# ---------------------------------------------------------------------------
# capacity: compaction and growth of the pools
# ---------------------------------------------------------------------------

def compact_points(m: MapState):
    """Reclaim culled point slots: stable-compact the valid points to the
    low end of the pool and remap the observation table. Returns
    ``(new_map, new_idx [P] int32)`` where ``new_idx[old_id]`` is the
    point's new slot (meaningful only where the old slot was valid), so
    that callers can remap the ids they hold."""
    P = m.pt_pos.shape[0]
    valid = m.pt_valid
    new_idx = (torch.cumsum(valid.to(torch.int32), 0) - 1).to(torch.int32)
    # perm[r] = old index of the r-th valid point (stable)
    perm = torch.argsort((~valid).to(torch.int32), stable=True)
    obs = m.kf_obs_point
    oc = torch.clamp(obs.to(torch.int64), 0, P - 1)
    ok = (obs >= 0) & valid[oc]
    return m._replace(
        pt_pos=m.pt_pos[perm], pt_valid=valid[perm], pt_desc=m.pt_desc[perm],
        pt_normal=m.pt_normal[perm], pt_min_dist=m.pt_min_dist[perm],
        pt_max_dist=m.pt_max_dist[perm], pt_found=m.pt_found[perm],
        pt_visible=m.pt_visible[perm], pt_first_kf=m.pt_first_kf[perm],
        n_pt=torch.sum(valid.to(torch.int32)).to(torch.int32),
        kf_obs_point=torch.where(ok, new_idx[oc], -1),
    ), new_idx


def compact_keyframes(m: MapState, perm, new_idx):
    """Pack valid keyframes to the low end of the pool. ``perm[r]`` is the
    old slot stored at new slot r and ``new_idx[old]`` the new slot of a
    (valid) old keyframe; both come from the caller, which must FIRST
    re-anchor every keyframe id it holds outside the MapState (see
    ``System._compact_keyframes``)."""
    K = m.kf_valid.shape[0]
    perm = perm.to(torch.int64)
    new_idx = new_idx.to(torch.int32)

    def g(a):
        return a[perm]

    valid_new = g(m.kf_valid)
    parent = g(m.kf_parent)
    # live keyframes' parents are live (culling reparents children), so an
    # id remap suffices; invalid rows clear to -1
    parent = torch.where(valid_new & (parent >= 0),
                         new_idx[torch.clamp(parent.to(torch.int64), 0, K - 1)], -1)
    first = m.pt_first_kf
    first_new = torch.where(first >= 0,
                            new_idx[torch.clamp(first.to(torch.int64), 0, K - 1)], -1)
    return m._replace(
        kf_pose=g(m.kf_pose), kf_valid=valid_new,
        kf_frame_id=torch.where(valid_new, g(m.kf_frame_id), -1),
        kf_parent=parent, kf_tcp=g(m.kf_tcp), kf_uv=g(m.kf_uv), kf_ur=g(m.kf_ur),
        kf_level=g(m.kf_level), kf_angle=g(m.kf_angle), kf_desc=g(m.kf_desc),
        kf_kp_valid=g(m.kf_kp_valid) & valid_new[:, None],
        kf_obs_point=torch.where(valid_new[:, None], g(m.kf_obs_point), -1),
        pt_first_kf=first_new,
        n_kf=torch.sum(valid_new.to(torch.int32)).to(torch.int32),
    )


def grow_map(m: MapState, new_K: int | None = None, new_P: int | None = None):
    """Grow the keyframe and/or point pools by appending empty rows (those
    of ``empty_map``) at the high end: ids are preserved, so nothing needs
    remapping. Callers double the capacity so that growth happens O(log)
    times over a run."""
    K, N = m.kf_obs_point.shape
    P = m.pt_pos.shape[0]
    new_K, new_P = new_K or K, new_P or P
    assert new_K >= K and new_P >= P
    ext = empty_map(MapConfig(max_keyframes=new_K - K, max_points=new_P - P,
                              n_features=N, device=str(m.pt_pos.device)))
    return m._replace(**{f: torch.cat([getattr(m, f), getattr(ext, f)])
                         for f in MapState._fields if f not in ("n_kf", "n_pt")})


def camera_centers(m: MapState):
    """[K,3] camera centers C = -R^T t."""
    R = lie.quat_to_matrix(m.kf_pose[:, :4])
    return -torch.einsum("kij,ki->kj", R, m.kf_pose[:, 4:7])
