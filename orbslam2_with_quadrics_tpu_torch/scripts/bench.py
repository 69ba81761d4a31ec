"""Tracking frames per second of the port on one card: the twin of the
JAX package's ``bench.py``.

    python -m orbslam2_with_quadrics_tpu_torch.scripts.bench [--device cuda|cpu]

Prints progress on stderr and ONE JSON line on stdout, with the reference's
keys (``metric`` = ``tracking_fps_per_chip``, ``value``, ``vs_baseline``
against the measured-i7 45 fps, ``fps_amortized``, ``stage_ms``,
``tracking_achieved_tflops``, ``speed_of_light``, ``device_kind``,
``mfu_estimate``, ``platform``) plus ``power_limit`` (the card's name and
power limit as ``nvidia-smi`` prints them) and ``frame_ms`` {p50, p90}.
Without a card it fails unless ``--device cpu`` asks for the CPU; there
every device reading (``device_ms``, ``sol_ms``, ``pct_of_sol``,
``tracking_minus_extract_ms``, ``tracking_achieved_tflops``,
``mfu_estimate``) is null and ``platform`` is ``"cpu"``.

Workload (``common.frame_workload``, the reference's ``bench.py:75-120``
drawn from a numpy ``RandomState``): 480x640 random images, 1,024
features, 8 levels, an 8,192-point map of 64 keyframe slots with 16 live
keyframes; tracking selects up to 4,096 local points over all 64 slots.
The workload is the reference's, degenerate as it is: every keyframe has
the identity pose, so triangulation finds no parallax and the mapping
stages run on a map they do not grow (for a benchmark to weigh).

- ``value``: 50 dependent frames of ``extract_mono`` + ``track_frame`` in a
  Python loop, each frame's image the next of the workload's images plus
  1e-7 times the previous frame's pose (the reference's
  ``img + T[0] * 1e-7``), between two ``torch.cuda.synchronize()``; so it
  includes host dispatch, what a user of the port gets. ``frame_ms``: the
  same frames again, each timed alone (synchronize before and after).
- ``stage_ms``: each stage alone and warm (``common.time_ms``: CUDA events
  around a loop of calls, each on its own inputs): ``extract``, ``track``,
  ``create_new_points`` (``map_triangulate``), ``fuse_neighbors``,
  ``run_local_ba`` (window 16), ``cull_keyframes`` and
  ``map_pipeline_fused`` = ``system._insert_and_map`` with the reference's
  arguments (features of the first 1,024 projected points, frame 100,
  parent 2, no observations, nothing protected, mono, window 16): on the
  card the accelerator program (dense-Schur local BA, neighbourhood-local
  point statistics). The mapping stages' calls each take the map moved by
  0.1 mm x i (points and keyframes together: the same scene).
  ``fps_amortized = 1 / (frame time + map_pipeline_fused / kf_every)``.
- ``speed_of_light``: ``device_ms`` per frame is the union of the kernel and
  copy intervals under ``torch.profiler`` over a window that cycles through
  the workload's images; ``sol_ms = max(flops / 67 TFLOP/s, bytes / 3.35
  TB/s)`` (NVIDIA's H100 SXM data sheet: fp32 outside the tensor cores, as
  the port computes with TF32 off; HBM3), ``pct_of_sol = sol_ms /
  device_ms``; ``mfu_estimate`` = the frames' model FLOP over the tracking
  loop's wall time, over the same fp32 peak.

The cost model (``cost_basis: "analytic_model"``) counts the function's
work, not any implementation's:

- extract, per image: 8 FLOP per pixel of pyramid levels 1-7 (a bilinear
  sample of four taps); per pixel of every level FAST-9/16's 16
  differences, the 16 arcs' minima over 9 contiguous points (2 x 16 x 8
  compares, brighter and darker) and their maxima (2 x 16): 304 ops, and
  3x3 non-maximum suppression: 8 compares; per keypoint the intensity
  centroid over the 31x31 circle (2 multiply-adds per pixel), the 7x7
  Gaussian of the 31x31 centre as two 7-tap passes (31x37 vertical, 31x31
  horizontal: 14 FLOP per output, fewer than 49 multiply-adds at each of
  the 512 BRIEF taps; the descriptor kernel's way) and 256 tests (two
  rotated taps, 8 multiply-adds, and a compare: 17 ops each). Bytes: the
  image read once, the features written once.
- frame = extract + ``track_frame``: 24 ops (8 XOR, 8 POPC, 7 adds, one
  best-two compare) per Hamming pair that the windows, levels and validity
  admit for these inputs (counted from the kernel wrapper's arguments
  during one frame); 30 FLOP per projected query point (stage A's and
  stage B's); the motion-only LM's 26 steps (2x3 + 4x5) over the 1,024
  observations at 175 FLOP per observation and step (projection 30,
  residual 2, Jacobian 30, JtWJ upper triangle and JtWr 108, Huber weight
  5) and a 100-FLOP 6x6 solve per step. Bytes: extract's, the map fields
  ``track_frame`` reads (``MAP_READS``) and the [K, P] observation matrix,
  pose and previous observations read once, the ``TrackResult`` written
  once.

The frame is latency-bound and bound by launches: expect a share of the
bound in the low single percent or below.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import sys
import time

import numpy as np
import torch

from ..models import frontend as fe
from ..models import local_mapping as lm
from ..models import system as sysm
from ..ops import cuda_kernels, lie, orb
from . import common

BASELINE_FPS = 45.0   # the reference's measured-i7 median tracking (~22 ms)
KF_EVERY = 5          # one keyframe every 5 frames (TUM-typical)
N_FRAMES = 50
H100_FP32_FLOPS = 67e12
H100_HBM_BYTES_PER_S = 3.35e12
MAP_READS = ("pt_pos", "pt_valid", "pt_desc", "pt_max_dist", "pt_min_dist", "pt_normal",
             "kf_valid", "kf_obs_point")
LM_STEPS = 2 * 3 + 4 * 5
LM_FLOP_PER_OBS_STEP = 175
LM_SOLVE_FLOP = 100
PROJECT_FLOP = 30
HAMMING_PAIR_OPS = 24


def _prog(msg):
    print(f"[bench] {msg}", file=sys.stderr, flush=True)


def _nbytes(tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors if torch.is_tensor(t))


# ---------------------------------------------------------------------------
# the cost model
# ---------------------------------------------------------------------------

def extract_cost(cfg: fe.FrontendConfig, img, feats):
    """(FLOP, bytes) of one image's extraction (module docstring)."""
    shapes = orb.pyramid_shapes(cfg.height, cfg.width, cfg.n_levels, cfg.scale_factor)
    px = [h * w for h, w in shapes]
    r = orb.PATCH_RADIUS
    dy, dx = np.mgrid[-r: r + 1, -r: r + 1]
    circle = int(((dy * dy + dx * dx) <= r * r).sum())
    n_taps = 2 * 256
    blur = min(n_taps * 2 * 49, 2 * 7 * ((2 * r + 1) * (2 * r + 7) + (2 * r + 1) ** 2))
    per_kp = 4 * circle + blur + 256 * 17
    flops = 8 * sum(px[1:]) + (304 + 8) * sum(px) + per_kp * cfg.n_features
    return float(flops), float(_nbytes([img]) + _nbytes(feats))


def admitted_pairs(args, level_tol: int = 1) -> int:
    """(query, target) pairs of one masked_hamming_best2 call that the
    pixel window, the level tolerance and validity admit."""
    qdesc, quv, qrad, qlvl, qvalid, tdesc, tuv, tlvl, tvalid = args
    n = tdesc.shape[-2]
    tv = tvalid if tvalid.dim() == qvalid.dim() else tvalid.expand(qvalid.shape[:-1] + (n,))
    tu = tuv if tuv.dim() == quv.dim() else tuv.expand(quv.shape[:-2] + tuv.shape)
    tl = tlvl if tlvl.dim() == qlvl.dim() else tlvl.expand(qlvl.shape[:-1] + (n,))
    return int((
        (torch.abs(quv[..., :, None, 0] - tu[..., None, :, 0]) <= qrad[..., None])
        & (torch.abs(quv[..., :, None, 1] - tu[..., None, :, 1]) <= qrad[..., None])
        & (torch.abs(tl[..., None, :] - qlvl[..., None]) <= level_tol)
        & qvalid[..., None] & tv[..., None, :]).sum())


@contextlib.contextmanager
def hamming_calls():
    """The arguments (and level tolerance) of every masked_hamming_best2 call
    made inside the block."""
    calls = []
    orig = cuda_kernels.masked_hamming_best2

    def record(*a, **k):
        calls.append((a, k.get("level_tol", 1)))
        return orig(*a, **k)

    cuda_kernels.masked_hamming_best2 = record
    try:
        yield calls
    finally:
        cuda_kernels.masked_hamming_best2 = orig


def track_cost(wl: common.FrameWorkload, feats, T, prev_obs):
    """(FLOP, bytes, admitted Hamming pairs) of one ``track_frame`` on these
    inputs (module docstring)."""
    with hamming_calls() as calls:
        res = common.track(wl, feats, T, prev_obs)
    pairs = sum(admitted_pairs(a, tol) for a, tol in calls)
    queries = sum(int(a[4].sum()) for a, _ in calls)
    n_obs = wl.cfg.n_features
    flops = (HAMMING_PAIR_OPS * pairs + PROJECT_FLOP * queries
             + LM_STEPS * (LM_FLOP_PER_OBS_STEP * n_obs + LM_SOLVE_FLOP))
    reads = [getattr(wl.m, f) for f in MAP_READS] + [wl.obs_A, T, prev_obs]
    return float(flops), float(_nbytes(reads) + _nbytes(res)), pairs


def sol_entry(device_ms, flops, nbytes, cuda: bool):
    t_ops = flops / H100_FP32_FLOPS * 1e3
    t_bytes = nbytes / H100_HBM_BYTES_PER_S * 1e3
    sol = max(t_ops, t_bytes)
    return {
        "device_ms": device_ms if cuda else None,
        "gflops": flops / 1e9,
        "mbytes": nbytes / 1e6,
        "cost_basis": "analytic_model",
        "sol_ms": sol if cuda else None,
        "sol_bound": "bandwidth" if t_bytes >= t_ops else "compute",
        "pct_of_sol": 100.0 * sol / device_ms if cuda else None,
    }


# ---------------------------------------------------------------------------
# device time under the profiler
# ---------------------------------------------------------------------------

def union_ms(intervals) -> float:
    """Length of the union of (start, end) intervals in us, as ms."""
    total, end = 0.0, -np.inf
    for s, e in sorted(intervals):
        if e > end:
            total += e - max(s, end)
            end = e
    return total / 1e3


def device_ms_per_call(fn, variants) -> float:
    """Device-busy ms per call of ``fn(*v)`` over ``variants``: the union of
    the kernel and copy intervals ``torch.profiler`` records, / calls."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn(*variants[0])
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for v in variants:
            fn(*v)
        torch.cuda.synchronize()
    iv = [(e.time_range.start, e.time_range.end) for e in prof.events()
          if e.device_type == DeviceType.CUDA]
    if not iv:
        raise RuntimeError("torch.profiler recorded no device activity")
    return union_ms(iv) / len(variants)


# ---------------------------------------------------------------------------
# the benchmark
# ---------------------------------------------------------------------------

def moved_map(m, d: float):
    """The map with its points and keyframes moved by ``d`` along x (the same
    scene: every keyframe has the identity rotation)."""
    shift = torch.tensor([0.0, 0.0, 0.0, 0.0, d, 0.0, 0.0], device=m.pt_pos.device)
    return m._replace(pt_pos=m.pt_pos + torch.tensor([d, 0.0, 0.0], device=m.pt_pos.device),
                      kf_pose=m.kf_pose - shift)


def track_loop(wl: common.FrameWorkload, n_frames: int, each: bool):
    """``n_frames`` dependent frames; returns the loop's seconds and, with
    ``each``, every frame's ms (synchronized before and after it)."""
    cuda = torch.device(wl.device).type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    T, per_frame = wl.T0, []
    sync()
    t0 = time.perf_counter()
    for i in range(n_frames):
        t1 = time.perf_counter()
        img = wl.imgs[i % len(wl.imgs)] + T[0] * 1e-7
        T = common.track(wl, fe.extract_mono(wl.cfg, img), T, wl.prev_obs).T_cw
        if each:
            sync()
            per_frame.append(1e3 * (time.perf_counter() - t1))
    sync()
    return time.perf_counter() - t0, per_frame


def main(device="cuda", n_frames: int = N_FRAMES, workload=None, reps: int = 2) -> dict:
    """Runs the benchmark, prints its JSON line and returns it as a dict."""
    cuda = torch.device(device).type == "cuda"
    if cuda and not torch.cuda.is_available():
        raise RuntimeError("bench: CUDA is not available; pass --device cpu for the CPU")
    _prog(f"platform: {common.platform(device)}")
    wl = workload or common.frame_workload(device, n_live_kf=16)
    cfg, m, dev = wl.cfg, wl.m, wl.device
    n = len(wl.imgs)
    K = common.intrinsics(wl)
    P = m.pt_pos.shape[0]
    nf = cfg.n_features

    _prog(f"tracking: {n_frames} dependent frames (one untimed pass first)")
    track_loop(wl, min(n_frames, n), each=False)
    dt, _ = track_loop(wl, n_frames, each=False)
    fps = n_frames / dt
    t_frame = dt / n_frames
    _, per_frame = track_loop(wl, n_frames, each=True)

    _prog("stages: extract, track")
    poses = [wl.T0 + torch.tensor([0, 0, 0, 0, 1e-3 * i, 0, 0], device=dev) for i in range(n)]
    prevs = [(wl.prev_obs + 7 * i) % P for i in range(n)]
    img_v = [(im,) for im in wl.imgs] * reps
    t_extract, _ = common.time_ms(lambda im: fe.extract_mono(cfg, im), img_v, device)
    track_v = list(zip(wl.feats, poses, prevs)) * reps
    t_track, _ = common.time_ms(lambda f, T, po: common.track(wl, f, T, po), track_v, device)

    _prog("stages: mapping")
    slot = torch.tensor(2, device=dev)
    maps = [moved_map(m, 1e-4 * i) for i in range(n)]
    t_tri, _ = common.time_ms(
        lambda mm: lm.create_new_points(mm, slot, K, 0.0, n_levels=cfg.n_levels, scale=1.2)[0],
        [(mm,) for mm in maps], device)
    maps_tri = [(lm.create_new_points(mm, slot, K, 0.0, n_levels=cfg.n_levels,
                                      scale=1.2)[0],) for mm in maps]
    t_fuse, _ = common.time_ms(
        lambda mm: lm.fuse_neighbors(mm, slot, K, height=cfg.height, width=cfg.width,
                                     n_levels=cfg.n_levels, scale=1.2), maps_tri, device)
    t_lba, _ = common.time_ms(
        lambda mm: lm.run_local_ba(mm, slot, K, 0.0, wl.inv_s2, window=16)[0].kf_pose,
        maps_tri, device)
    t_cull, _ = common.time_ms(lambda mm: lm.cull_keyframes(mm, slot, n_levels=cfg.n_levels).kf_valid, maps_tri,
                               device)
    uv = m.kf_uv[0, :nf]
    bench_feats = fe.FrameFeatures(
        uv=uv, uv_und=uv, level=torch.zeros(nf, dtype=torch.int32, device=dev),
        angle=torch.zeros(nf, device=dev), score=torch.ones(nf, device=dev),
        desc=m.pt_desc[:nf], valid=torch.ones(nf, dtype=torch.bool, device=dev),
        ur=torch.full((nf,), -1.0, device=dev), depth=torch.zeros(nf, device=dev))
    no_obs = torch.full((nf,), -1, dtype=torch.int32, device=dev)
    protect = torch.zeros(m.kf_valid.shape[0], dtype=torch.bool, device=dev)

    def map_pipeline(mm, i):
        T = lie.se3_identity(device=dev) - torch.tensor([0, 0, 0, 0, 1e-4 * i, 0, 0],
                                                        device=dev)
        return sysm._insert_and_map(mm, bench_feats, T, 100, 2, no_obs, protect, wl.inv_s2,
                                    cfg, "mono", 16)[1]

    t_map, _ = common.time_ms(map_pipeline, [(mm, i) for i, mm in enumerate(maps)], device)
    fps_amortized = 1.0 / (t_frame + t_map / 1e3 / KF_EVERY)

    _prog("speed of light")
    f_ext, b_ext = extract_cost(cfg, wl.imgs[0], wl.feats[0])
    f_trk, b_trk, pairs = track_cost(wl, wl.feats[0], wl.T0, wl.prev_obs)
    _prog(f"model: extract {f_ext / 1e9:.4f} GFLOP {b_ext / 1e6:.3f} MB; track "
          f"{f_trk / 1e9:.4f} GFLOP {b_trk / 1e6:.3f} MB, {pairs} admitted Hamming pairs")
    dev_ext = dev_frame = None
    if cuda:
        dev_ext = device_ms_per_call(lambda im: fe.extract_mono(cfg, im), img_v)
        dev_frame = device_ms_per_call(
            lambda im, T, po: common.track(wl, fe.extract_mono(cfg, im), T, po),
            list(zip(wl.imgs, poses, prevs)) * reps)
    sol = {"extract": sol_entry(dev_ext, f_ext, b_ext, cuda),
           "frame": sol_entry(dev_frame, f_ext + f_trk, b_ext + b_trk, cuda)}
    sol["tracking_minus_extract_ms"] = dev_frame - dev_ext if cuda else None
    sol["note"] = (
        "device_ms: union of kernel and copy intervals under torch.profiler per call, "
        "cycling through the workload's images; gflops / mbytes: an analytic model of "
        "the function's work (scripts/bench.py's docstring); sol_ms = max(flops / 67 "
        "TFLOP/s fp32, bytes / 3.35 TB/s HBM3), the H100 SXM data sheet's peaks; the "
        "motion-only LM's 26 dependent steps and the many small launches make the "
        "frame latency-bound, far above its bound")
    achieved = (f_ext + f_trk) * n_frames / dt / 1e12 if cuda else None

    out = {
        "metric": "tracking_fps_per_chip",
        "value": fps,
        "unit": "frames/sec",
        "vs_baseline": fps / BASELINE_FPS,
        "baseline_fps": BASELINE_FPS,
        "baseline_basis": "measured-i7 ~22ms median tracking (ORB-SLAM2 T-RO'17, "
                          "README.md.bk:22)",
        "fps_amortized": fps_amortized,
        "amortized_vs_baseline": fps_amortized / BASELINE_FPS,
        "kf_every": KF_EVERY,
        "frame_ms": {"p50": float(np.percentile(per_frame, 50)),
                     "p90": float(np.percentile(per_frame, 90))},
        "stage_ms": {
            "extract": t_extract, "track": t_track, "map_triangulate": t_tri,
            "map_fuse": t_fuse, "map_local_ba": t_lba, "map_kf_cull": t_cull,
            "map_pipeline_fused": t_map,
            "note": "each stage alone, warm, CUDA events around a loop of calls on "
                    "inputs that differ (host clock on the CPU); value and frame_ms "
                    "are host-clock times of a Python loop of extract_mono + "
                    "track_frame, host dispatch included; map_pipeline_fused is the "
                    "whole _insert_and_map (on the card: dense local BA and local "
                    "point statistics), used for fps_amortized",
        },
        "tracking_achieved_tflops": achieved,
        "speed_of_light": sol,
        "device_kind": torch.cuda.get_device_name(0) if cuda else "cpu",
        "mfu_estimate": achieved * 1e12 / H100_FP32_FLOPS if cuda else None,
        "platform": common.platform(device),
        "power_limit": common.card_line() if cuda else None,
    }
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    a = ap.parse_args()
    with torch.no_grad():
        main(a.device)
