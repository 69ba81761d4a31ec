"""GPU smoke run of the PyTorch/CUDA port (needs one CUDA card).

    python3 chip_smoke.py

Phases (any failure exits non-zero before the result line):
  1. torch version, device name, card name and power limit (nvidia-smi);
  2. build the CUDA kernel(s) from ``orbslam2_with_quadrics_tpu_torch/csrc``;
  3. each kernel against its plain PyTorch version on the card, bit-exact,
     at the main path's shapes (single and batched) plus tie / all-masked /
     ragged cases, and at those shapes four times of it:
       kernel_ms  device time of the kernel alone (20 launches captured in a
                  CUDA graph, the replay timed between two events, / 20);
       call_ms    what a caller pays per call on an idle card, the Python
                  wrapper included (events around one call);
       plain_ms   the plain PyTorch version, timed like call_ms;
       bound_ms   the least time the card could take for this run's inputs
                  (see ``bound_ms``);
  4. the port's paths through ``System``, every map tensor on the card, each
     over a synthetic sequence, checked against ground truth, with the
     kernel's launch counts from that run alone (more than 0, at most 2 per
     tracked frame and 2 per mapping pass):
       mono      ``track_monocular`` at the TUM width: 640x480, 1024 features,
                 8 levels, default map pools, 60 frames;
       rgbd      ``track_rgbd`` at the TUM width with TUM1.yaml's bf = 40 and
                 ThDepth = 40, metric depth maps, 40 frames, a keyframe at
                 least every 10; ATE without scale alignment;
       stereo    ``track_stereo`` at the KITTI width: 1226x370, 2048 features,
                 8 levels, baseline 0.2, 128 keyframe and 32,768 point slots,
                 30 frames; metric ATE;
       capacity  a mono run at 320x240 whose keyframe pool has 10 slots: the
                 pool must compact or double and the run end OK, once
                 through the pipelined path and once through the synchronous
                 one (``ORB_SYNC_TRACK=1``).
The line before the last is a JSON summary of the kernels; the last line is
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

sys.modules["jax"] = None  # the port must never need JAX
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import numpy as np  # noqa: E402
import torch  # noqa: E402

KERNEL_SOURCE = "orbslam2_with_quadrics_tpu_torch/csrc/masked_hamming_best2.cu"
KERNEL_REPLACES = "orbslam2_with_quadrics_tpu/ops/pallas_kernels.py:115"
KITTI = (1226.0, 370.0)


def log(msg):
    print(msg, flush=True)


def cuda_median_ms(fn, reps: int = 30, warmup: int = 3) -> float:
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


def graph_kernel_ms(fn, launches: int = 20, reps: int = 20) -> float:
    """Device time of one launch made by ``fn``: ``launches`` calls captured
    in a CUDA graph on a side stream, the replay timed between two events."""
    fn()  # build and allocator warm-up outside the capture
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=torch.cuda.Stream()):
        for _ in range(launches):
            fn()
    return cuda_median_ms(graph.replay, reps=reps) / launches


def profiler_kernel_ms(fn, name: str, launches: int = 20):
    """Mean device time of the kernels whose name contains ``name`` over
    ``launches`` calls of ``fn``, from torch.profiler (None if it saw none)."""
    from torch.autograd import DeviceType

    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                            torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(launches):
            fn()
        torch.cuda.synchronize()
    ev = [e for e in prof.events() if e.device_type == DeviceType.CUDA and name in e.name]
    return sum(e.time_range.elapsed_us() for e in ev) / 1e3 / len(ev) if ev else None


# NVIDIA H100 SXM data sheet: 3.35 TB/s of HBM; 67 TFLOP/s of fp32 outside
# the tensor cores counts an FMA as two, so an add or a compare runs at
# half of it, and gives the boost clock 67e12 / (132 SMs * 128 lanes * 2).
# POPC: 16 results per clock per SM (NVIDIA's table of arithmetic
# throughput per compute capability, column 9.0).
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12 / 2
POPC_PER_S = 16 * 132 * (67e12 / (132 * 128 * 2))


def bound_ms(args, level_tol: int = 1):
    """The least time the card could take for masked_hamming_best2 on these
    inputs: the largest of (a) every input byte read once and every output
    byte written once over the memory rate, (b) the window test, 2
    subtractions and 2 compares for every (valid query, valid target) pair,
    over the fp32 rate, (c) 8 POPC for every pair that this run's data
    admits over the POPC rate. Returns (bound, bound with every pair
    admitted, what bounds it) in ms."""
    qdesc, quv, qrad, qlvl, qvalid, tdesc, tuv, tlvl, tvalid = args
    rows, n = qrad.numel(), tdesc.shape[-2]
    nbytes = sum(t.numel() * t.element_size() for t in args) + 3 * 4 * rows
    tv = tvalid if tvalid.dim() == qvalid.dim() else tvalid.expand(qvalid.shape[:-1] + (n,))
    tested = int((qvalid.sum(-1) * tv.sum(-1)).sum())
    tu = tuv if tuv.dim() == quv.dim() else tuv.expand(quv.shape[:-2] + tuv.shape)
    tl = tlvl if tlvl.dim() == qlvl.dim() else tlvl.expand(qlvl.shape[:-1] + (n,))
    admitted = int((
        (torch.abs(quv[..., :, None, 0] - tu[..., None, :, 0]) <= qrad[..., None])
        & (torch.abs(quv[..., :, None, 1] - tu[..., None, :, 1]) <= qrad[..., None])
        & (torch.abs(tl[..., None, :] - qlvl[..., None]) <= level_tol)
        & qvalid[..., None] & tv[..., None, :]).sum())
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = max(4 * tested / FP32_OPS_PER_S, 8 * admitted / POPC_PER_S) * 1e3
    all_admitted = max(t_bytes, 8 * rows * n / POPC_PER_S * 1e3)
    return max(t_bytes, t_ops), all_admitted, "bytes" if t_bytes > t_ops else "operations"


def hamming_case(Q, N, seed, ties=False, masked=False, dev="cuda", B=None,
                 shared_targets=False, radius=15.0, extent=(640.0, 480.0)):
    """Inputs of masked_hamming_best2 at (Q, N) drawn from ``seed``; with
    ``B`` a batch of B problems, their targets per entry or one shared set.
    ``radius`` (level-0 px) is a number or one number per batch entry;
    ``extent`` is the image size the keypoints spread over."""
    g = torch.Generator(device=dev).manual_seed(seed)
    ql = () if B is None else (B,)
    tl = () if B is None or shared_targets else (B,)

    def ri(lo, hi, shape):
        return torch.randint(lo, hi, shape, generator=g, device=dev, dtype=torch.int64)

    if ties:  # a few distinct descriptors: exact distance ties everywhere
        pool = ri(-2 ** 31, 2 ** 31, (4, 8)).to(torch.int32)
        qdesc, tdesc = pool[ri(0, 4, ql + (Q,))], pool[ri(0, 4, tl + (N,))]
        radius = 400.0
    else:
        qdesc = ri(-2 ** 31, 2 ** 31, ql + (Q, 8)).to(torch.int32)
        tdesc = ri(-2 ** 31, 2 ** 31, tl + (N, 8)).to(torch.int32)
    scale = torch.tensor(extent, device=dev)
    quv = torch.rand(ql + (Q, 2), generator=g, device=dev) * scale
    tuv = torch.rand(tl + (N, 2), generator=g, device=dev) * scale
    qlvl = ri(0, 8, ql + (Q,)).to(torch.int32)
    tlvl = ri(0, 8, tl + (N,)).to(torch.int32)
    sf = 1.2 ** qlvl.to(torch.float32)
    qrad = torch.as_tensor(radius, dtype=torch.float32, device=dev).reshape(-1, 1) * sf
    qvalid = torch.rand(ql + (Q,), generator=g, device=dev) < (0.0 if masked else 0.9)
    tvalid = torch.rand(tl + (N,), generator=g, device=dev) < 0.9
    return (qdesc.contiguous(), quv, qrad.reshape(ql + (Q,)).contiguous(), qlvl, qvalid,
            tdesc.contiguous(), tuv, tlvl, tvalid)


def stage_a_case(seed, n=1024, **kw):
    """The motion-model sweep: the same n queries and targets under the
    15 px and the 30 px window, as a batch of two."""
    one = hamming_case(n, n, seed, **kw)
    q = [torch.stack([t, t]) for t in one[:5]]
    q[2] = torch.stack([one[2], 2.0 * one[2]])
    return tuple(q) + one[5:]


def kernel_cases():
    """[(name, inputs, timed)]: the cases held against the plain version;
    the timed ones are the main path's shapes."""
    return [
        ("main-A 1024x1024", hamming_case(1024, 1024, 100), True),
        ("main-B 4096x1024", hamming_case(4096, 1024, 101), True),
        ("ties 1024x1024", hamming_case(1024, 1024, 102, ties=True), False),
        ("all-masked 512x512", hamming_case(512, 512, 103, masked=True), False),
        ("ragged 300x200", hamming_case(300, 200, 104), False),
        ("ragged 1x1000", hamming_case(1, 1000, 105), False),
        ("ragged 257x1", hamming_case(257, 1, 106), False),
        ("stageA B=2 1024x1024", stage_a_case(107), True),
        ("fuse-fwd B=10 1024x1024", hamming_case(1024, 1024, 108, B=10, radius=3.0), True),
        ("fuse-rev B=10 1024x1024", hamming_case(1024, 1024, 109, B=10, radius=3.0,
                                                 shared_targets=True), True),
        # equal minima in different lanes, warps and (N > 1024) chunks
        ("ties B=3 1024x2500", hamming_case(1024, 2500, 110, ties=True, B=3), False),
        ("ragged B=3 300x200", hamming_case(300, 200, 111, B=3,
                                            radius=[15.0, 3.0, 400.0]), False),
        # the stereo path: 2048 features are two 1024-target chunks per warp
        ("stereo-A B=2 2048x2048", stage_a_case(114, 2048, extent=KITTI), True),
        ("stereo-B 4096x2048", hamming_case(4096, 2048, 115, extent=KITTI), True),
        ("stereo-fuse-fwd B=10 2048x2048",
         hamming_case(2048, 2048, 116, B=10, radius=3.0, extent=KITTI), True),
        ("stereo-fuse-rev B=10 2048x2048",
         hamming_case(2048, 2048, 117, B=10, radius=3.0, shared_targets=True,
                      extent=KITTI), True),
    ]


def max_abs_diff(got, ref) -> int:
    return max(int((a.to(torch.int64) - b.to(torch.int64)).abs().max())
               for a, b in zip(got, ref))


def phase_kernels(smi):
    from orbslam2_with_quadrics_tpu_torch.ops import cuda_kernels as ck

    t0 = time.time()
    lib = ck.build()
    ck._launcher()
    log(f"[build] {lib.name} in {time.time() - t0:.2f} s")
    for line in open(f"{lib}.ptxas.txt").read().splitlines():
        if "registers" in line or "spill" in line:
            log(f"[build] ptxas: {line.strip()}")
    max_err = 0
    times = {}
    cases = kernel_cases()
    for name, args, timed in cases:
        variants = [(name, args)]
        if args[2].dim() == 1:  # every unbatched case also as a batch of one
            variants.append((name + " as B=1", tuple(t[None] for t in args)))
        for vname, vargs in variants:
            got = ck.masked_hamming_best2(*vargs)
            ref = ck.masked_hamming_best2_plain(*vargs)
            torch.cuda.synchronize()
            err = max_abs_diff(got, ref)
            max_err = max(max_err, err)
            n_adm = int((ref[1] < ck._BIG).sum())
            log(f"[kernel] {vname}: max |kernel - plain| = {err}, tolerance 0 "
                f"(bit-exact; {n_adm}/{ref[1].numel()} rows with a candidate)")
            if err != 0:
                raise AssertionError(
                    f"masked_hamming_best2 disagrees with its plain version on {vname}")
        if timed:
            t = {"kernel_ms": graph_kernel_ms(lambda: ck.masked_hamming_best2(*args)),
                 "call_ms": cuda_median_ms(lambda: ck.masked_hamming_best2(*args)),
                 "plain_ms": cuda_median_ms(lambda: ck.masked_hamming_best2_plain(*args),
                                            reps=10)}
            t["bound_ms"], t["bound_all_admitted_ms"], t["bound_by"] = bound_ms(args)
            times[name] = t
            log(f"[kernel] {name}: kernel_ms {t['kernel_ms']:.5f} (graph replay of 20), "
                f"call_ms {t['call_ms']:.5f} (wrapper + kernel), plain_ms {t['plain_ms']:.4f}, "
                f"bound_ms {t['bound_ms']:.5f} by {t['bound_by']} (this run's inputs; "
                f"{t['bound_all_admitted_ms']:.5f} with every pair admitted) ({smi})")
    # every pair admitted: the kernel against the POPC bound
    q = hamming_case(4096, 1024, 112)
    wide = q[:2] + (torch.full_like(q[2], 1e4),) + q[3:4] + (torch.ones_like(q[4]),) \
        + q[5:8] + (torch.ones_like(q[8]),)
    if max_abs_diff(ck.masked_hamming_best2(*wide, level_tol=8),
                    ck.masked_hamming_best2_plain(*wide, level_tol=8)) != 0:
        raise AssertionError("masked_hamming_best2 disagrees with its plain version "
                             "with every pair admitted")
    k_all = graph_kernel_ms(lambda: ck.masked_hamming_best2(*wide, level_tol=8))
    b_all = bound_ms(wide, level_tol=8)
    log(f"[kernel] all-admitted 4096x1024: bit-exact, kernel_ms {k_all:.5f}, bound_ms "
        f"{b_all[0]:.5f} by {b_all[2]} ({smi})")
    # one query, one target: what a launch costs before any work is done
    tiny = hamming_case(1, 1, 113)
    log(f"[kernel] launch floor 1x1: kernel_ms "
        f"{graph_kernel_ms(lambda: ck.masked_hamming_best2(*tiny)):.5f} ({smi})")
    args_b = cases[1][1]
    prof = profiler_kernel_ms(lambda: ck.masked_hamming_best2(*args_b), "masked_hamming_best2")
    log(f"[kernel] main-B 4096x1024: torch.profiler by kernel name "
        f"{'no device events' if prof is None else f'{prof:.5f} ms per launch'} ({smi})")
    return max_err, times


# the paths chip_smoke drives, by name: the arguments of ``main_path_setup``
# and the run's bar. ``ate_max`` is a share of the ground truth's span after
# a sim(3) alignment (mono) or metres without scale alignment (metric).
PATHS = {
    "mono": dict(sensor="mono", h=480, w=640, n_features=1024, n_levels=8, n_frames=60,
                 fx=520.0, min_tracked=40, min_kf=3, ate_max=0.05, metric=False),
    # the reference's TUM1.yaml: bf = 40, ThDepth = 40; depth maps in metres.
    # The forced keyframe cadence is 10 frames, not the 30 of a 30 fps
    # camera: the sequence is 40 frames long and has to run mapping passes
    "rgbd": dict(sensor="rgbd", h=480, w=640, n_features=1024, n_levels=8, n_frames=40,
                 fx=520.0, bf=40.0, sys_kw=dict(max_frames_between_kf=10),
                 min_tracked=30, min_kf=3, ate_max=0.05, metric=False, scale_free=True),
    # KITTI width (the reference's KITTI00-02.yaml frame), baseline 0.2
    "stereo": dict(sensor="stereo", h=370, w=1226, n_features=2048, n_levels=8,
                   n_frames=30, fx=718.9, bf=0.2 * 718.9, seed=5,
                   map_kw=dict(max_keyframes=128, max_points=32768),
                   sys_kw=dict(max_frames_between_kf=5),
                   min_tracked=25, min_kf=3, ate_max=0.15, metric=True),
    # a keyframe pool of 10 slots under the densest insertion
    "capacity": dict(sensor="mono", h=240, w=320, n_features=512, n_levels=4, n_frames=24,
                     fx=260.0, seed=11, map_kw=dict(max_keyframes=10, max_points=8192),
                     sys_kw=dict(kf_idle_frames=1, max_frames_between_kf=2),
                     min_tracked=18, min_kf=3, ate_max=0.12, metric=False, capacity=True),
}


def main_path_setup(device="cuda", h=480, w=640, n_features=1024, n_levels=8,
                    n_frames=60, fx=520.0, map_kw=None, sensor="mono", bf=0.0, seed=3,
                    sys_kw=None):
    """A path's SystemConfig and its synthetic sequence: (cfg, frames,
    ground-truth T_cw), ``frames[i]`` being the arguments of the sensor's
    track call: (img,), (img, depth) or (left, right)."""
    from orbslam2_with_quadrics_tpu_torch.models import frontend as fe
    from orbslam2_with_quadrics_tpu_torch.models import map_state as ms
    from orbslam2_with_quadrics_tpu_torch.models import system as sysm
    from orbslam2_with_quadrics_tpu_torch.utils import synthetic

    t0 = time.time()
    kw = dict(n_frames=n_frames, h=h, w=w, fx=fx, fy=fx, seed=seed)
    if sensor == "stereo":
        left, right, poses, _ = synthetic.planar_sequence_stereo(baseline=bf / fx, **kw)
        frames = list(zip(left, right))
    else:
        imgs, poses, K = synthetic.planar_sequence(**kw)
        frames = [(im,) for im in imgs]
        if sensor == "rgbd":
            frames = [(im, synthetic.planar_depth(T, K, h, w)) for im, T in zip(imgs, poses)]
    log(f"[{sensor}] rendered {n_frames} frames {w}x{h} in {time.time() - t0:.1f} s")
    cfg = sysm.SystemConfig(
        frontend=fe.FrontendConfig(height=h, width=w, n_features=n_features,
                                   n_levels=n_levels, fx=fx, fy=fx, cx=w / 2.0, cy=h / 2.0,
                                   bf=bf),
        map=ms.MapConfig(n_features=n_features, n_levels=n_levels, device=device,
                         **(map_kw or {})),
        sensor=sensor, **(sys_kw or {}),
    )
    return cfg, frames, poses


def trajectory_error(traj, poses, with_scale=True):
    """(ATE RMSE after a sim(3) alignment, or a rigid one without scale,
    span of the ground-truth camera centres) of ``System.full_trajectory()``
    output; raises on a non-finite pose."""
    from orbslam2_with_quadrics_tpu_torch.utils import metrics

    est = [metrics.se3_vec_to_mat(T) for _, _, T in traj]
    if not all(np.isfinite(T).all() for T in est):
        raise AssertionError("non-finite pose in the trajectory")
    c_est = metrics.camera_centers_from_Tcw(est)
    c_gt = metrics.camera_centers_from_Tcw([poses[f] for f, _, _ in traj])
    return (metrics.ate_rmse(c_est, c_gt, with_scale=with_scale),
            float(np.linalg.norm(c_gt.max(0) - c_gt.min(0))))


def run_main_path(name="mono", device="cuda", sync=False, log_every=5, **overrides):
    """Drive one of ``PATHS`` through ``System.track_*`` (``overrides``
    replace its arguments; ``sync`` takes the synchronous path). The
    kernels' launch counts are set to 0 just before the first frame and read
    just after the last. Returns a dict of the run's numbers; raises on any
    failed check."""
    from orbslam2_with_quadrics_tpu_torch.models import system as sysm
    from orbslam2_with_quadrics_tpu_torch.models import tracking as tr
    from orbslam2_with_quadrics_tpu_torch.ops import cuda_kernels as ck

    spec = {**PATHS[name], **overrides}
    bar = {k: spec.pop(k, None) for k in ("min_tracked", "min_kf", "ate_max", "metric",
                                          "scale_free", "capacity")}
    tag = name + ("-sync" if sync else "")
    cfg, frames, poses = main_path_setup(device, **spec)
    cuda = device == "cuda"
    map_events = []
    n_calls = {"frames": 0, "map_passes": 0}
    # a tracked frame is one track_frame call, a mapping pass one
    # _insert_and_map (pipelined) or _insert_keyframe (synchronous) call
    track_frame = tr.track_frame
    insert_and_map, insert_keyframe = sysm._insert_and_map, sysm.System._insert_keyframe

    def counted_track_frame(*a, **k):
        n_calls["frames"] += 1
        return track_frame(*a, **k)

    def timed(fn):  # device time of each mapping pass
        def call(*a, **k):
            n_calls["map_passes"] += 1
            if not cuda:
                return fn(*a, **k)
            ev = (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
            ev[0].record()
            out = fn(*a, **k)
            ev[1].record()
            map_events.append(ev)
            return out
        return call

    tr.track_frame = counted_track_frame
    sysm._insert_and_map = timed(insert_and_map)
    sysm.System._insert_keyframe = timed(insert_keyframe)
    old_sync = os.environ.get("ORB_SYNC_TRACK")
    os.environ["ORB_SYNC_TRACK"] = "1" if sync else ""
    try:
        slam = sysm.System(cfg)
        step = getattr(slam, {"mono": "track_monocular", "rgbd": "track_rgbd",
                              "stereo": "track_stereo"}[cfg.sensor])
        frame_ms = []
        ck.reset_launch_counts()
        for i, images in enumerate(frames):
            t = time.perf_counter()
            step(*images, timestamp=i / 30.0)
            if cuda:
                torch.cuda.synchronize()
            dt = (time.perf_counter() - t) * 1e3
            if slam.state == sysm.System.OK and i > slam.init_frame_id + 1:
                frame_ms.append(dt)
            if i % log_every == 0:
                log(f"[{tag}] frame {i:3d} state={slam.state} kfs={int(slam.map.n_kf)} "
                    f"pts={int(slam.map.n_pt)} {dt:.1f} ms")
        slam.shutdown()
        traj = slam.full_trajectory()
        launches = dict(ck.LAUNCHES)
    finally:
        tr.track_frame = track_frame
        sysm._insert_and_map, sysm.System._insert_keyframe = insert_and_map, insert_keyframe
        if old_sync is None:
            os.environ.pop("ORB_SYNC_TRACK", None)
        else:
            os.environ["ORB_SYNC_TRACK"] = old_sync
    map_ms = [a.elapsed_time(b) for a, b in map_events]

    metric = bool(bar["metric"] or bar["scale_free"])
    ate, span = trajectory_error(traj, poses, with_scale=not metric)
    tracked = sum(1 for m in slam.metrics if not m.get("lost"))
    out = {
        "path": tag, "sensor": cfg.sensor, "init_frame": slam.init_frame_id,
        "tracked": tracked, "n_kf": int(slam.map.n_kf), "kfs_created": slam.n_kfs_created,
        "n_pt": int(slam.map.n_pt), "ate": ate, "span": span, "ate_scale_aligned": not metric,
        "frame_ms_median": float(np.median(frame_ms)) if frame_ms else float("nan"),
        "map_ms_median": float(np.median(map_ms)) if map_ms else float("nan"),
        "n_map_passes": n_calls["map_passes"], "n_frame_steps": n_calls["frames"],
        "launches": launches,
        "capacity_events": {k: getattr(slam, k) for k in (
            "n_kf_compactions", "n_kf_growths", "n_point_compactions", "n_point_growths")},
        "pools": [slam.map.kf_valid.shape[0], slam.map.pt_pos.shape[0]],
    }
    log(f"[{tag}] {json.dumps(out)}")
    n_frames = len(frames)
    min_tracked = min(bar["min_tracked"], n_frames - 5)
    ate_limit = bar["ate_max"] if bar["metric"] else bar["ate_max"] * span
    checks = [
        (slam.init_frame_id >= 0 and slam.state == sysm.System.OK, "initialized and OK"),
        (cfg.sensor == "mono" or slam.init_frame_id == 0, "initialized on the first frame"),
        (tracked >= min_tracked, f">= {min_tracked} frames tracked"),
        (int(slam.map.n_kf) >= bar["min_kf"], f">= {bar['min_kf']} keyframes"),
        (ate < ate_limit, f"ATE {ate:.5f} < {ate_limit:.5f}"),
    ]
    if bar["capacity"]:
        ev = out["capacity_events"]
        checks.append((ev["n_kf_compactions"] + ev["n_kf_growths"] >= 1,
                       "the keyframe pool compacted or grew"))
        checks.append((len(traj) == n_frames, "every frame has a pose"))
    if cuda:
        n = launches["masked_hamming_best2"]
        most = 2 * n_calls["frames"] + 2 * n_calls["map_passes"]
        checks.append((n > 0, "masked_hamming_best2 launched by the path"))
        checks.append((n <= most, f"at most 2 launches per tracked frame and 2 per mapping "
                                  f"pass ({n} launches, limit {most})"))
    for ok, what in checks:
        if not ok:
            raise AssertionError(f"{tag} path check failed: {what}")
    return out


def main() -> int:
    log(f"[env] torch {torch.__version__} cuda {torch.version.cuda}")
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this run needs one CUDA card",
              file=sys.stderr)
        return 1
    name = torch.cuda.get_device_name(0)
    log(f"[env] device 0: {name}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    log(smi)  # the card's name and power limit, as nvidia-smi prints them

    max_err, times = phase_kernels(smi)
    runs = [run_main_path("mono"), run_main_path("rgbd"), run_main_path("stereo"),
            run_main_path("capacity"), run_main_path("capacity", sync=True)]
    by_path = {}
    for res in runs:
        n = res["launches"]["masked_hamming_best2"]
        by_path[res["path"]] = n
        log(f"[{res['path']}] median frame {res['frame_ms_median']:.2f} ms, median mapping "
            f"pass {res['map_ms_median']:.2f} ms; {n} kernel launches over "
            f"{res['n_frame_steps']} tracked frames and {res['n_map_passes']} mapping "
            f"passes ({smi})")
        log(smi)
    mono = runs[0]
    per_frame = ((by_path["mono"] - 2 * mono["n_map_passes"])
                 / max(mono["n_frame_steps"], 1))
    t = times["main-B 4096x1024"]  # the headline shape: local-map tracking
    print(json.dumps({"kernels": [{
        "name": "masked_hamming_best2", "route": "cuda", "source": KERNEL_SOURCE,
        "replaces": KERNEL_REPLACES, "launches": sum(by_path.values()),
        "launches_by_path": by_path, "launches_per_frame": per_frame,
        "max_abs_err": max_err, "ms": t["kernel_ms"], "kernel_ms": t["kernel_ms"],
        "call_ms": t["call_ms"], "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
        "bound_by": t["bound_by"], "library_ms": None, "shapes": times,
    }]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
