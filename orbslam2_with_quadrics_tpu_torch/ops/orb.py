"""ORB feature front end: pyramid, FAST, orientation, rotated BRIEF (torch).

Counterpart of the reference's ``ops/orb.py``; every stage is a dense,
fixed-shape tensor op, so one call per frame yields N padded, masked
keypoints + packed 256-bit descriptors:

- pyramid: 8 levels x 1.2, the reference's antialiased bilinear resize
  (``jax.image.resize``'s separable triangle filter) as two fp32 matmuls
  with the same weight matrices;
- FAST-9/16 score in bf16 (as the reference), 3x3 NMS with a raster-order
  tie-break, per-32x32-cell 20 -> 7 threshold fallback, per-cell top-k and a
  global top-N per level. Top-k uses a stable descending sort, so ties keep
  the lower index first, as ``lax.top_k`` does;
- one 37x37 raw patch per keypoint by a direct gather (the reference's CPU
  branch): IC-angle moments from its 31x31 circular centre, a 7x7 Gaussian
  inside the patch, then 256 rotated-BRIEF tests packed to 8 words.

Descriptors are stored as the int32 view of the reference's uint32 words
(bit-identical; torch has no ``>>`` on uint32).

Detection on a CUDA tensor is one launch per image of the hand-written
kernel ``csrc/orb_detect.cu`` (:func:`detect_levels`): FAST score, NMS,
border, cell fallback and per-cell top-k for every level, bit-exact to the
plain per-level version (:func:`detect_level_plain`, the CPU route). It
replaces the reference's XLA-fused ``detect_level``
(``orbslam2_with_quadrics_tpu/ops/orb.py:176-221``). What bounds it is
launches and latency, not bytes: reading each level once is 1.3 MB per
480x640 image (0.4 us of HBM time), while the plain version dispatches
~100 small ops per level. One block per 32x32 cell of every level keeps
the whole chain in shared memory; each level's global top-``n_out`` and
the keypoint assembly stay PyTorch glue, one padded sort over all levels.

The descriptor stage on a CUDA tensor is one launch per image of
``csrc/orb_describe.cu`` (:func:`describe`): one block per keypoint cuts
its raw patch, reduces its moments, blurs the patch in shared memory and
packs its 256 tests with warp ballots, replacing the reference's one-hot
MXU gathers (``orbslam2_with_quadrics_tpu/ops/orb.py:366-467``); the plain
version (:func:`describe_plain`) is the CPU route.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import NamedTuple

import numpy as np
import torch

from . import cuda_kernels

EDGE_THRESHOLD = 19  # descriptor-safe border
PATCH_RADIUS = 15    # HALF_PATCH_SIZE

# FAST circle of radius 3 (16 points, clockwise from 12 o'clock), (dy, dx)
_CIRCLE = (
    (-3, 0), (-3, 1), (-2, 2), (-1, 3), (0, 3), (1, 3), (2, 2), (3, 1),
    (3, 0), (3, -1), (2, -2), (1, -3), (0, -3), (-1, -3), (-2, -2), (-3, -1),
)


class Features(NamedTuple):
    """Fixed-capacity padded per-frame features (level-0 coordinates)."""

    uv: torch.Tensor        # [N,2] raw pixel coords (x, y) at level-0 scale
    level: torch.Tensor     # [N] int32 pyramid octave
    angle: torch.Tensor     # [N] float32 orientation (radians)
    score: torch.Tensor     # [N] float32 FAST score
    desc: torch.Tensor      # [N,8] int32 view of the packed 256-bit descriptor
    valid: torch.Tensor     # [N] bool


def topk_stable(x, k: int, dim: int = -1):
    """``lax.top_k`` semantics: the k largest values, ties in ascending
    index order (``torch.topk`` gives no such order)."""
    v, i = torch.sort(x, dim=dim, descending=True, stable=True)
    return v.narrow(dim, 0, k), i.narrow(dim, 0, k)


def pack_bits(bits):
    """[..., 256] bool -> [..., 8] int32 (bit j of word w = bits[32w + j])."""
    shifts = torch.arange(32, device=bits.device, dtype=torch.int64)
    words = torch.sum(
        bits.reshape(bits.shape[:-1] + (8, 32)).to(torch.int64) << shifts, dim=-1
    )
    return torch.where(words >= 2 ** 31, words - 2 ** 32, words).to(torch.int32)


def pyramid_shapes(h: int, w: int, n_levels: int, scale: float):
    shapes = []
    for l in range(n_levels):
        s = 1.0 / (scale ** l)
        shapes.append((max(int(round(h * s)), 64), max(int(round(w * s)), 64)))
    return shapes


def per_level_counts(n_features: int, n_levels: int, scale: float):
    """Geometric per-level feature budget."""
    inv = 1.0 / scale
    first = n_features * (1 - inv) / (1 - inv ** n_levels)
    counts = []
    acc = 0
    for l in range(n_levels - 1):
        c = int(round(first * inv ** l))
        counts.append(c)
        acc += c
    counts.append(max(n_features - acc, 0))
    return counts


@functools.lru_cache(maxsize=64)
def _resize_weights(n_in: int, n_out: int) -> np.ndarray:
    """[n_in, n_out] antialiased triangle-filter weights, computed as
    ``jax.image.resize(..., "bilinear")`` computes them (float32)."""
    f32 = np.float32
    scale = n_out / n_in
    inv_scale = f32(1.0 / scale)
    kernel_scale = max(inv_scale, f32(1.0))
    sample_f = (np.arange(n_out, dtype=f32) + f32(0.5)) * inv_scale - f32(0.5)
    x = np.abs(sample_f[None, :] - np.arange(n_in, dtype=f32)[:, None]) / kernel_scale
    w = np.maximum(f32(0.0), f32(1.0) - np.abs(x))
    total = np.sum(w, axis=0, keepdims=True, dtype=f32)
    w = np.where(
        np.abs(total) > 1000.0 * float(np.finfo(np.float32).eps),
        w / np.where(total != 0, total, f32(1.0)), f32(0.0),
    )
    inside = (sample_f >= -0.5) & (sample_f <= n_in - 0.5)
    return np.where(inside[None, :], w, f32(0.0)).astype(f32)


@functools.lru_cache(maxsize=64)
def device_const(fn, *args, device: str = "cpu"):
    """``fn(*args)`` (a numpy constant) as a tensor cached per device, so
    the per-frame path never copies constants host-to-device."""
    return torch.as_tensor(fn(*args), device=device)


def build_pyramid(img, shapes):
    """img [H,W] float32 -> list of per-level images: separable antialiased
    bilinear resize, Wy^T @ img @ Wx."""
    out = [img]
    H, W = img.shape
    dev = str(img.device)
    for (h, w) in shapes[1:]:
        wy = device_const(_resize_weights, H, h, device=dev)
        wx = device_const(_resize_weights, W, w, device=dev)
        out.append((wy.T @ img) @ wx)
    return out


@functools.lru_cache(maxsize=8)
def _gauss7(sigma: float):
    r = np.arange(-3, 4, dtype=np.float64)
    k = np.exp(-0.5 * (r / sigma) ** 2)
    return (k / k.sum()).astype(np.float32)


def gaussian_blur7(img, sigma: float = 2.0):
    """Separable 7x7 Gaussian over the trailing two axes with edge
    replication; batches over leading axes."""
    k = _gauss7(sigma)
    h, w = img.shape[-2:]
    dev = img.device
    iy = torch.clamp(torch.arange(-3, h + 3, device=dev), 0, h - 1)
    padded = img[..., iy, :]
    acc = padded[..., 0:h, :] * float(k[0])
    for i in range(1, 7):
        acc = acc + padded[..., i: i + h, :] * float(k[i])
    ix = torch.clamp(torch.arange(-3, w + 3, device=dev), 0, w - 1)
    padded = acc[..., :, ix]
    out = padded[..., :, 0:w] * float(k[0])
    for i in range(1, 7):
        out = out + padded[..., :, i: i + w] * float(k[i])
    return out


def fast_score(img):
    """Continuous FAST-9/16 corner score at every pixel: max over the 16
    circular windows of length 9 of the window-min contrast, the stronger
    polarity, accumulated in bf16 as the reference does."""
    shifted = torch.stack(
        [torch.roll(img, (-dy, -dx), dims=(-2, -1)) for dy, dx in _CIRCLE]
    )
    diff = (shifted - img[None]).to(torch.bfloat16)
    mn, mx = diff, diff
    for s in (1, 2, 4):
        mn = torch.minimum(mn, torch.roll(mn, -s, dims=0))
        mx = torch.maximum(mx, torch.roll(mx, -s, dims=0))
    d8 = torch.roll(diff, -8, dims=0)
    mn = torch.minimum(mn, d8)
    mx = torch.maximum(mx, d8)
    score = torch.maximum(torch.amax(mn, dim=0), torch.amax(-mx, dim=0))
    return score.to(img.dtype)


def nms3(score):
    """3x3 non-maximum suppression; ties go to the raster-first pixel."""
    h, w = score.shape[-2:]
    p = torch.nn.functional.pad(score, (1, 1, 1, 1), value=-math.inf)
    keep = torch.ones(score.shape, dtype=torch.bool, device=score.device)
    for dy in range(3):
        for dx in range(3):
            if dy == 1 and dx == 1:
                continue
            n = p[..., dy: dy + h, dx: dx + w]
            if (dy, dx) < (1, 1):
                keep = keep & (score > n)
            else:
                keep = keep & (score >= n)
    return keep


def _border_mask(h, w, margin, device):
    ys = torch.arange(h, device=device)[:, None]
    xs = torch.arange(w, device=device)[None, :]
    return (ys >= margin) & (ys < h - margin) & (xs >= margin) & (xs < w - margin)


def detect_level_plain(img, n_out: int, th_high: float = 20.0, th_low: float = 7.0,
                       cell: int = 32):
    """Plain PyTorch version of :func:`detect_level` (the CPU route, and
    what the kernel is held against on the card)."""
    h, w = img.shape
    dev = img.device
    score = fast_score(img)
    keep = nms3(score) & _border_mask(h, w, EDGE_THRESHOLD, dev)

    ncy, ncx = -(-h // cell), -(-w // cell)
    ph, pw = ncy * cell, ncx * cell
    s = torch.where(keep, score, -math.inf)
    s = torch.nn.functional.pad(s, (0, pw - w, 0, ph - h), value=-math.inf)
    cells = s.reshape(ncy, cell, ncx, cell).permute(0, 2, 1, 3)
    cells = cells.reshape(ncy * ncx, cell * cell)

    cell_max = torch.amax(cells, dim=1, keepdim=True)
    eff_th = torch.where(cell_max > th_high, th_high, th_low)
    cells = torch.where(cells > eff_th, cells, -math.inf)

    cap = max(1, min(int(math.ceil(4.0 * n_out / (ncy * ncx))), cell * cell))
    cv, ci = topk_stable(cells, cap)

    cid = torch.arange(ncy * ncx, device=dev)
    yy = (cid // ncx)[:, None] * cell + ci // cell
    xx = (cid % ncx)[:, None] * cell + ci % cell
    topv, topi = topk_stable(cv.reshape(-1), n_out)
    yx = torch.stack([yy.reshape(-1)[topi], xx.reshape(-1)[topi]], dim=-1)
    valid = torch.isfinite(topv)
    return yx, torch.where(valid, topv, 0.0), valid


def detect_level(img, n_out: int, th_high: float = 20.0, th_low: float = 7.0,
                 cell: int = 32):
    """Detect up to ``n_out`` keypoints on one pyramid level. Returns
    (yx [n_out,2] int64, score [n_out], valid [n_out])."""
    return detect_levels([img], [n_out], th_high, th_low, cell)


def detect_levels(pyr, counts, th_high: float = 20.0, th_low: float = 7.0,
                  cell: int = 32):
    """:func:`detect_level` on every level of ``pyr`` with the budgets
    ``counts``, concatenated in level order: (yx [sum,2] int64, score [sum],
    valid [sum]). CPU tensors take :func:`detect_level_plain` per level;
    CUDA tensors one launch of ``csrc/orb_detect.cu`` for all levels."""
    dev = pyr[0].device
    if dev.type == "cpu":
        outs = [detect_level_plain(im, n, th_high, th_low, cell) for im, n in zip(pyr, counts)]
        return tuple(torch.cat(parts) for parts in zip(*outs))
    if dev.type != "cuda":
        raise ValueError(f"detect_levels: unsupported device {dev}")
    return _detect_levels_cuda(pyr, counts, th_high, th_low, cell)


class DetectPlan(NamedTuple):
    table: tuple      # per level (h, w, ncx, ncy, cell_base, cap, out_base)
    n_cells: int
    width: int        # slots in each level's row of the padded [L, width] output
    rows: torch.Tensor   # [sum counts] level of each output keypoint
    cols: torch.Tensor   # [sum counts] its rank within the level
    base: torch.Tensor   # [sum counts] its level's row offset (level * width)


_MAX_LEVELS = 16  # the kernel's parameter block


@functools.lru_cache(maxsize=32)
def detect_plan(shapes, counts, cell: int, device: str) -> DetectPlan:
    """The launch's per-level table and the gather indices that assemble
    the levels' top-``n_out`` from one padded sort (cached per shape)."""
    table, base = [], 0
    for (h, w), n_out in zip(shapes, counts):
        ncy, ncx = -(-h // cell), -(-w // cell)
        cap = max(1, min(int(math.ceil(4.0 * n_out / (ncy * ncx))), cell * cell))
        table.append([h, w, ncx, ncy, base, cap])
        base += ncy * ncx
    width = max(t[3] * t[2] * t[5] for t in table)
    for l, t in enumerate(table):
        t.append(l * width)
    rows = np.concatenate([np.full(n, l) for l, n in enumerate(counts)]).astype(np.int64)
    cols = np.concatenate([np.arange(n) for n in counts]).astype(np.int64)
    as_dev = lambda a: torch.as_tensor(a, device=device)  # noqa: E731
    return DetectPlan(tuple(tuple(t) for t in table), base, width, as_dev(rows),
                       as_dev(cols), as_dev(rows * width))


@functools.lru_cache(maxsize=1)
def _detect_launcher():
    fn = cuda_kernels.library("orb_detect").orb_detect_launch
    fn.argtypes = ([ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_float,
                    ctypes.c_float] + [ctypes.c_void_p] * 3)
    fn.restype = ctypes.c_int
    return fn


def _detect_levels_cuda(pyr, counts, th_high, th_low, cell):
    dev = pyr[0].device
    if cell != 32:
        raise ValueError(f"detect_levels: the kernel takes 32x32 cells, not {cell}")
    if not 1 <= len(pyr) <= _MAX_LEVELS or len(counts) != len(pyr):
        raise ValueError(f"detect_levels: {len(pyr)} levels with {len(counts)} budgets "
                         f"(the kernel takes 1..{_MAX_LEVELS})")
    for l, im in enumerate(pyr):
        if im.device != dev or im.dtype != torch.float32 or im.dim() != 2:
            raise ValueError(f"detect_levels: level {l} is {im.dtype} {tuple(im.shape)} on "
                             f"{im.device}, expected a 2-D float32 image on {dev}")
    imgs = [im.contiguous() for im in pyr]
    plan = detect_plan(tuple(tuple(im.shape) for im in imgs), tuple(int(n) for n in counts),
                       cell, str(dev))
    out_v = torch.full((len(imgs), plan.width), -math.inf, dtype=torch.float32, device=dev)
    out_yx = torch.empty((len(imgs), plan.width, 2), dtype=torch.int32, device=dev)
    orb_detect_launch(imgs, plan, th_high, th_low, out_v, out_yx)
    return assemble_levels(out_v, out_yx, plan)


def orb_detect_launch(imgs, plan: DetectPlan, th_high, th_low, out_v, out_yx):
    """One launch of ``csrc/orb_detect.cu`` over every cell of ``imgs``
    (contiguous float32 levels on one card): each cell's top-``cap`` slots
    into ``out_v`` [L, width] (padding left as it is) and their level
    pixels into ``out_yx`` [L, width, 2] int32."""
    L = len(imgs)
    rows = (ctypes.c_int64 * (8 * L))(*[
        v for im, t in zip(imgs, plan.table) for v in (im.data_ptr(),) + t])
    ctx, index = cuda_kernels.launch_device(imgs[0].device)
    with ctx:
        err = _detect_launcher()(
            rows, L, plan.n_cells, float(th_high), float(th_low), out_v.data_ptr(),
            out_yx.data_ptr(), torch.cuda.current_stream(index).cuda_stream)
    if err != 0:
        raise RuntimeError(f"orb_detect launch failed: cudaError {err}")
    cuda_kernels.LAUNCHES["orb_detect"] += 1


def assemble_levels(out_v, out_yx, plan: DetectPlan):
    """The levels' keypoints from the per-cell top-``cap`` slots: ``out_v``
    [L, width] (each level's cells' slots in cell order, -inf padding after
    them) and ``out_yx`` [L, width, 2] int32 (level pixel of each slot).
    Each level's global top-``n_out`` is one stable sort of the padded rows:
    the padding sorts after every slot of the level, -inf slots included."""
    v, i = torch.sort(out_v, dim=1, descending=True, stable=True)
    topv = v[plan.rows, plan.cols]
    yx = out_yx.view(-1, 2)[i[plan.rows, plan.cols] + plan.base].to(torch.int64)
    valid = torch.isfinite(topv)
    return yx, torch.where(valid, topv, 0.0), valid


@functools.lru_cache()
def brief_pattern(seed: int = 7, n_pairs: int = 256):
    """256 BRIEF test pairs ~ N(0, (patch/5)^2), clipped to radius 13 (the
    reference's own fixed-seed pattern, numpy float32 [512, 2] (x, y))."""
    rng = np.random.RandomState(seed)
    sigma = (2 * PATCH_RADIUS + 1) / 5.0
    pts = rng.randn(n_pairs * 2, 2) * sigma
    norm = np.linalg.norm(pts, axis=1, keepdims=True)
    lim = 13.0
    pts = np.where(norm > lim, pts * (lim / norm), pts)
    return np.round(pts).astype(np.float32)


@functools.lru_cache()
def _moment_weights():
    """[961, 2] circular-patch (m01, m10) weights for a flat 31x31 patch."""
    r = PATCH_RADIUS
    dy, dx = np.mgrid[-r: r + 1, -r: r + 1]
    circ = (dy * dy + dx * dx) <= r * r
    wy = (dy * circ).astype(np.float32).reshape(-1)
    wx = (dx * circ).astype(np.float32).reshape(-1)
    return np.stack([wy, wx], axis=1)


def extract(img, n_features: int = 1000, n_levels: int = 8, scale: float = 1.2,
            th_fast: float = 20.0, th_fast_min: float = 7.0,
            cell: int = 32) -> Features:
    """Full ORB extraction on one grayscale image [H,W] float32 in
    [0,255]; rows grouped by level at the per-level budgets."""
    h, w = img.shape
    shapes = pyramid_shapes(h, w, n_levels, scale)
    return extract_from_pyramid(build_pyramid(img, shapes), n_features, scale,
                                th_fast, th_fast_min, cell)


def extract_from_pyramid(pyr, n_features: int = 1000, scale: float = 1.2,
                         th_fast: float = 20.0, th_fast_min: float = 7.0,
                         cell: int = 32) -> Features:
    """:func:`extract` on given pyramid levels (list of [h_l, w_l])."""
    dev = pyr[0].device
    n_levels = len(pyr)
    counts = per_level_counts(n_features, n_levels, scale)

    yx, kp_s, valid = detect_levels(pyr, counts, th_fast, th_fast_min, cell)
    kp_y, kp_x = yx[:, 0], yx[:, 1]
    lvl_ids = torch.cat(
        [torch.full((counts[l],), l, dtype=torch.int64, device=dev)
         for l in range(n_levels)]
    )
    ang, desc = describe(pyr, kp_y, kp_x, lvl_ids, valid)

    sf = scale_factors(n_levels, scale, dev)[0][lvl_ids]
    uv = torch.stack([kp_x.to(torch.float32) * sf, kp_y.to(torch.float32) * sf], dim=-1)
    return Features(uv=uv, level=lvl_ids.to(torch.int32), angle=ang, score=kp_s,
                    desc=desc, valid=valid)


def describe_plain(pyr, kp_y, kp_x, lvl_ids, valid):
    """Plain PyTorch version of :func:`describe` (the CPU route, and what
    the kernel is held against on the card)."""
    dev = pyr[0].device
    n_levels = len(pyr)
    shapes = [tuple(p.shape) for p in pyr]
    hc, wc = shapes[0]
    kp_yc = torch.where(valid, kp_y, EDGE_THRESHOLD)
    kp_xc = torch.where(valid, kp_x, EDGE_THRESHOLD)

    # one 37x37 RAW patch per keypoint (31x31 + 3 px blur support), cut
    # from a zero-padded [L, H0, W0] canvas by a direct gather, with the
    # start clamped into the canvas as dynamic_slice clamps it
    r = PATCH_RADIUS
    rs = r + 3
    side = 2 * rs + 1
    canvas = torch.stack(
        [torch.nn.functional.pad(pyr[l], (0, wc - shapes[l][1], 0, hc - shapes[l][0]))
         for l in range(n_levels)]
    )
    y0 = torch.clamp(kp_yc - rs, 0, hc - side)
    x0 = torch.clamp(kp_xc - rs, 0, wc - side)
    iota = torch.arange(side, device=dev)
    raw = canvas[
        lvl_ids[:, None, None],
        (y0[:, None] + iota)[:, :, None],
        (x0[:, None] + iota)[:, None, :],
    ]                                                         # [N,37,37]
    n = raw.shape[0]
    flat_raw = raw[:, 3:-3, 3:-3].reshape(n, -1)              # [N,961]

    # IC angle: two-moment matmul on the raw patch
    m = flat_raw @ device_const(_moment_weights, device=str(dev))
    ang = torch.where(valid, torch.atan2(m[:, 0], m[:, 1]), 0.0)

    blur31 = gaussian_blur7(raw)[:, 3:-3, 3:-3]               # [N,31,31]

    # rotated BRIEF: continuous per-keypoint rotation, rounded taps looked
    # up inside the blurred patch
    pat = device_const(brief_pattern, device=str(dev))
    ca, sa = torch.cos(ang)[:, None], torch.sin(ang)[:, None]
    px, py = pat[None, :, 0], pat[None, :, 1]
    rx = torch.round(px * ca - py * sa).to(torch.int64)       # [N,512]
    ry = torch.round(px * sa + py * ca).to(torch.int64)
    oy = torch.clamp(ry + r, 0, 2 * r)
    ox = torch.clamp(rx + r, 0, 2 * r)
    vals = blur31[torch.arange(n, device=dev)[:, None], oy, ox]
    desc = pack_bits(vals[:, 0::2] < vals[:, 1::2])
    return ang, torch.where(valid[:, None], desc, 0)


def describe(pyr, kp_y, kp_x, lvl_ids, valid):
    """Orientation and rotated-BRIEF descriptor of each keypoint: its
    level pixel (``kp_y``, ``kp_x``, int64 [N], as :func:`detect_levels`
    returns them), its level ``lvl_ids`` (int64 [N]) and ``valid`` ([N]
    bool). Returns (angle [N] float32, desc [N, 8] int32; 0 and zero words
    where not valid). CPU tensors take :func:`describe_plain`; CUDA tensors
    one launch of ``csrc/orb_describe.cu`` for all keypoints."""
    dev = pyr[0].device
    if dev.type == "cpu":
        return describe_plain(pyr, kp_y, kp_x, lvl_ids, valid)
    if dev.type != "cuda":
        raise ValueError(f"describe: unsupported device {dev}")
    return _describe_cuda(pyr, kp_y, kp_x, lvl_ids, valid)


@functools.lru_cache(maxsize=1)
def _describe_launcher():
    fn = cuda_kernels.library("orb_describe").orb_describe_launch
    fn.argtypes = ([ctypes.c_void_p] + [ctypes.c_int] * 3
                   + [ctypes.c_void_p, ctypes.c_int64] * 2
                   + [ctypes.c_void_p] * 2 + [ctypes.c_int] + [ctypes.c_void_p] * 5)
    fn.restype = ctypes.c_int
    return fn


def _describe_cuda(pyr, kp_y, kp_x, lvl_ids, valid):
    dev = pyr[0].device
    n = kp_y.shape[0]
    if not 1 <= len(pyr) <= _MAX_LEVELS:
        raise ValueError(f"describe: {len(pyr)} levels (the kernel takes 1..{_MAX_LEVELS})")
    h0, w0 = pyr[0].shape
    if h0 < 2 * PATCH_RADIUS + 7 or w0 < 2 * PATCH_RADIUS + 7:
        raise ValueError(f"describe: level 0 is {h0}x{w0}, smaller than a 37x37 patch")
    for l, im in enumerate(pyr):
        if im.device != dev or im.dtype != torch.float32 or im.dim() != 2:
            raise ValueError(f"describe: level {l} is {im.dtype} {tuple(im.shape)} on "
                             f"{im.device}, expected a 2-D float32 image on {dev}")
    for name, t, dtype in (("kp_y", kp_y, torch.int64), ("kp_x", kp_x, torch.int64),
                           ("lvl_ids", lvl_ids, torch.int64), ("valid", valid, torch.bool)):
        if t.device != dev or t.dtype != dtype or tuple(t.shape) != (n,):
            raise ValueError(f"describe: {name} is {t.dtype} {tuple(t.shape)} on {t.device}, "
                             f"expected {dtype} [{n}] on {dev}")
    imgs = [im.contiguous() for im in pyr]
    lvl_ids, valid = lvl_ids.contiguous(), valid.contiguous()
    angle = torch.empty(n, dtype=torch.float32, device=dev)
    desc = torch.empty((n, 8), dtype=torch.int32, device=dev)
    if n == 0:
        return angle, desc
    levels = (ctypes.c_int64 * (3 * len(imgs)))(*[
        v for im in imgs for v in (im.data_ptr(),) + tuple(im.shape)])
    gauss = (ctypes.c_float * 7)(*_gauss7(2.0).tolist())
    pat = device_const(brief_pattern, device=str(dev))
    ctx, index = cuda_kernels.launch_device(dev)
    with ctx:
        err = _describe_launcher()(
            levels, len(imgs), h0, w0, kp_y.data_ptr(), kp_y.stride(0), kp_x.data_ptr(),
            kp_x.stride(0), lvl_ids.data_ptr(), valid.data_ptr(), n, pat.data_ptr(), gauss,
            angle.data_ptr(), desc.data_ptr(), torch.cuda.current_stream(index).cuda_stream)
    if err != 0:
        raise RuntimeError(f"orb_describe launch failed: cudaError {err}")
    cuda_kernels.LAUNCHES["orb_describe"] += 1
    return angle, desc


@functools.lru_cache(maxsize=16)
def _scale_tables(n_levels: int, scale: float, device: str):
    f = scale ** np.arange(n_levels)
    return tuple(
        torch.as_tensor(a, dtype=torch.float32, device=device)
        for a in (f, f * f, 1.0 / (f * f))
    )


def scale_factors(n_levels: int = 8, scale: float = 1.2, device="cpu"):
    """Per-level (scale, sigma2, inv_sigma2) float32 tables."""
    return _scale_tables(n_levels, scale, str(torch.device(device)))
