"""Per-stage profile of one of the port's paths on one CUDA card.

    python3 profile_port.py [--path mono|rgbd|stereo|quadric] [--frames N]
                            [--warmup 20] [--profiled 12]

Runs one of ``chip_smoke.PATHS`` (mono: 640x480, 1024 features, 8 levels,
default map pools, 60 frames; stereo: 1226x370, 2048 features, 30 frames;
quadric: mono with ``enable_quadrics`` and the virtual object's boxes; map
on ``cuda``) through ``System.track_*`` in three windows:

1. frames ``[0, warmup)`` run without instrumentation (initialization,
   the kernel build, allocator warm-up);
2. the next ``profiled`` frames run under ``torch.profiler`` with every
   stage inside a ``record_function`` range: device ms per stage (the
   kernels launched inside the range), the device's busy share of the
   window's wall time (union of kernel / copy intervals) and device
   activities per frame; the profiler slows the host, so host times from
   this window are not reported. The hand-written kernels are launched
   through ``ctypes``, outside every PyTorch op, and the profiler does not
   count them in a range's device time: each launch a wrapper counts in
   ``cuda_kernels.LAUNCHES`` is noted with the stages open on the host at
   that moment, the n-th launch of a kernel is paired with its n-th device
   record (one stream: the device runs them in launch order), and its
   device time is added to every stage that was open (the ``hand ms``
   column; a kernel the profiler had already given to a stage is taken out
   of that stage's PyTorch part first, so none counts twice);
3. the remaining frames run with ``torch.cuda.synchronize()`` before and
   after every stage: host ms per stage call (a nested stage's time is
   inside its parent's).

Prints both tables and writes ``chiprun_out/profile/summary_<path>.json`` and
``chiprun_out/profile/key_averages_<path>.txt``.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

sys.modules["jax"] = None  # the port must never need JAX
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import numpy as np  # noqa: E402
import torch  # noqa: E402
from torch.autograd import DeviceType  # noqa: E402

import chip_smoke  # noqa: E402
from orbslam2_with_quadrics_tpu_torch.models import frontend as fe  # noqa: E402
from orbslam2_with_quadrics_tpu_torch.models import local_mapping as lm  # noqa: E402
from orbslam2_with_quadrics_tpu_torch.models import map_state as ms  # noqa: E402
from orbslam2_with_quadrics_tpu_torch.models import quadric_mapping as qm  # noqa: E402
from orbslam2_with_quadrics_tpu_torch.models import system as sysm  # noqa: E402
from orbslam2_with_quadrics_tpu_torch.models import tracking as tr  # noqa: E402
from orbslam2_with_quadrics_tpu_torch.ops import cuda_kernels as ck  # noqa: E402
from orbslam2_with_quadrics_tpu_torch.ops import ba, matching, orb, quadrics, stereo  # noqa: E402
from orbslam2_with_quadrics_tpu_torch.scripts.bench import union_ms  # noqa: E402

# the stages, from the per-frame / per-keyframe programs down; each is
# looked up through its module at call time, so patching the module
# attribute instruments every caller
STAGES = [
    (sysm, "_frame_step"), (fe, "extract_stereo"), (fe, "extract_rgbd"),
    (fe, "extract_mono"), (orb, "extract"), (stereo, "stereo_match"),
    (matching, "hamming_matrix"), (orb, "build_pyramid"),
    (orb, "detect_levels"), (orb, "describe"), (tr, "track_frame"), (tr, "select_local_points"),
    (tr, "_pose_opt_from_obs"), (matching, "match_by_projection"),
    (ck, "masked_hamming_best2"),
    (sysm, "_insert_and_map"), (sysm, "_create_depth_points"), (lm, "cull_points"),
    (lm, "create_new_points"),
    (lm, "fuse_neighbors"), (lm, "run_local_ba"), (ba, "ba_solve_dense"),
    (ba, "dense_terms"),
    (lm, "cull_keyframes"), (qm.QuadricManager, "joint_ba"),
    (quadrics, "quadric_ba_solve"), (quadrics, "quadric_init"),
    (ms, "update_point_stats"), (ms, "update_point_stats_local"), (ms, "covisibility"),
    (ms, "observation_matrix"),
    (ms, "obs_level_cum"),
]
OUT_DIR = "chiprun_out/profile"


class LaunchLog(dict):
    """``cuda_kernels.LAUNCHES`` during the profiled window: each launch a
    wrapper counts is also noted, in order, with the stages open on the
    host (``stack``)."""

    def __init__(self, counts, stack):
        super().__init__(counts)
        self.stack, self.launches = stack, []

    def __setitem__(self, key, value):
        # a wrapper may count several launches at once
        self.launches += [(key, tuple(self.stack))] * (value - self.get(key, 0))
        super().__setitem__(key, value)


def instrument(mode, host_ms, stack):
    """Wrap every stage; ``mode["m"]`` picks the window's behaviour; in the
    profiled window ``stack`` holds the stages open on the host. Returns
    the originals for ``restore``."""
    originals = []
    for mod, name in STAGES:
        fn = getattr(mod, name)
        originals.append((mod, name, fn))

        def call(*a, _fn=fn, _name=name, **k):
            if mode["m"] == "profile":
                stack.append(_name)
                try:
                    with torch.profiler.record_function("S:" + _name):
                        return _fn(*a, **k)
                finally:
                    stack.pop()
            if mode["m"] == "sync":
                torch.cuda.synchronize()
                t = time.perf_counter()
                out = _fn(*a, **k)
                torch.cuda.synchronize()
                host_ms.setdefault(_name, []).append((time.perf_counter() - t) * 1e3)
                return out
            return _fn(*a, **k)

        setattr(mod, name, call)
    return originals


def restore(originals):
    for mod, name, fn in originals:
        setattr(mod, name, fn)


def _hand_kernel(name):
    """The hand-written kernel (a ``cuda_kernels.KERNELS`` name, which each
    of its device functions' names contains) of a device record, or None."""
    return next((k for k in ck.KERNELS if k in name), None)


def _hand_in_subtree(e):
    """Device ms of the hand-written kernels that the profiler itself
    counted in ``e``'s device time (its own kernels and its children's)."""
    own = sum(k.duration for k in getattr(e, "kernels", []) if _hand_kernel(k.name)) / 1e3
    return own + sum(_hand_in_subtree(c) for c in e.cpu_children)


def attribute_hand_kernels(dev, launch_log):
    """{stage: device ms of the hand-written kernels launched while it was
    open}, and {kernel: [launches noted, device records]} where the two
    counts differ (then the pairs up to the shorter are used)."""
    per_stage, mismatched = {}, {}
    for k in ck.KERNELS:
        records = sorted((e for e in dev if _hand_kernel(e.name) == k),
                         key=lambda e: e.time_range.start)
        launched = [stages for key, stages in launch_log.launches if key == k]
        if len(records) != len(launched):
            mismatched[k] = [len(launched), len(records)]
        for e, stages in zip(records, launched):
            for st in set(stages):
                per_stage[st] = per_stage.get(st, 0.0) + e.time_range.elapsed_us() / 1e3
    return per_stage, mismatched


def analyse(prof, wall_ms, n_frames, launch_log):
    events = prof.events()
    dev = [e for e in events
           if e.device_type == DeviceType.CUDA and not e.name.startswith("S:")]
    busy = union_ms([(e.time_range.start, e.time_range.end) for e in dev])
    hand, mismatched = attribute_hand_kernels(dev, launch_log)
    stage_dev = {}
    for e in events:
        if e.device_type == DeviceType.CPU and e.name.startswith("S:"):
            n, d = stage_dev.get(e.name[2:], (0, 0.0))
            stage_dev[e.name[2:]] = (n + 1, d + e.device_time_total / 1e3 - _hand_in_subtree(e))
    kern = {k: [e for e in dev if _hand_kernel(e.name) == k] for k in ck.KERNELS}
    return {
        "window_frames": n_frames, "wall_ms": wall_ms,
        "device_busy_ms": busy, "device_busy_share": busy / wall_ms,
        "device_activities": len(dev), "device_activities_per_frame": len(dev) / n_frames,
        "stage_device_ms": {k: {"calls": n, "ms_per_call": (d + hand.get(k, 0.0)) / n,
                                "hand_ms_per_call": hand.get(k, 0.0) / n}
                            for k, (n, d) in stage_dev.items()},
        "hand_launch_mismatch": mismatched,
        "kernels": {k: {
            "count": len(ev),
            "ms_per_launch": (sum(e.time_range.elapsed_us() for e in ev) / 1e3 / len(ev)
                              if ev else None)} for k, ev in kern.items()},
    }


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--path", choices=("mono", "rgbd", "stereo", "quadric"), default="mono")
    ap.add_argument("--frames", type=int, default=None,
                    help="default: the path's own count in chip_smoke.PATHS")
    ap.add_argument("--warmup", type=int, default=None,
                    help="default: a third of the frames")
    ap.add_argument("--profiled", type=int, default=12)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("profile_port: CUDA is not available; this run needs one CUDA card",
              file=sys.stderr)
        return 1
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(f"[env] torch {torch.__version__}; {smi}", flush=True)

    spec = {k: v for k, v in chip_smoke.PATHS[args.path].items()
            if k not in ("min_tracked", "min_kf", "ate_max", "metric", "scale_free", "quadric")}
    if args.frames is not None:
        spec["n_frames"] = args.frames
    args.frames = spec["n_frames"]
    if args.warmup is None:
        args.warmup = args.frames // 3
    cfg, frames, poses = chip_smoke.main_path_setup(**spec)
    dets = (chip_smoke.object_detections(poses, cfg.frontend.fx, cfg.frontend.width,
                                         cfg.frontend.height)
            if chip_smoke.PATHS[args.path].get("quadric") else [None] * args.frames)
    mode, host_ms, stack = {"m": None}, {}, []
    originals = instrument(mode, host_ms, stack)
    p0, p1 = args.warmup, min(args.warmup + args.profiled, args.frames)
    try:
        slam = sysm.System(cfg)
        step = getattr(slam, {"mono": "track_monocular", "rgbd": "track_rgbd",
                              "stereo": "track_stereo"}[cfg.sensor])
        for i in range(p0):
            step(*frames[i], timestamp=i / 30.0, detections=dets[i])
        torch.cuda.synchronize()
        mode["m"] = "profile"
        launch_log = ck.LAUNCHES = LaunchLog(ck.LAUNCHES, stack)
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                                torch.profiler.ProfilerActivity.CUDA]) as prof:
            t = time.perf_counter()
            for i in range(p0, p1):
                step(*frames[i], timestamp=i / 30.0, detections=dets[i])
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t) * 1e3
        ck.LAUNCHES = dict(launch_log)
        mode["m"] = "sync"
        for i in range(p1, args.frames):
            step(*frames[i], timestamp=i / 30.0, detections=dets[i])
        mode["m"] = None
        traj = slam.full_trajectory()
    finally:
        restore(originals)

    ate, span = chip_smoke.trajectory_error(traj, poses, with_scale=cfg.sensor == "mono")
    tracked = sum(1 for m in slam.metrics if not m.get("lost"))
    summary = analyse(prof, wall_ms, p1 - p0, launch_log)
    summary.update({
        "path": args.path, "card": smi, "torch": torch.__version__, "tracked": tracked,
        "n_kf": int(slam.map.n_kf), "ate": ate, "span": span,
        "stage_host_ms_synced": {k: {"calls": len(v), "median": float(np.median(v))}
                                 for k, v in host_ms.items()},
    })
    os.makedirs(OUT_DIR, exist_ok=True)
    with open(os.path.join(OUT_DIR, f"summary_{args.path}.json"), "w") as f:
        json.dump(summary, f, indent=1)
    with open(os.path.join(OUT_DIR, f"key_averages_{args.path}.txt"), "w") as f:
        f.write(prof.key_averages().table(sort_by="self_device_time_total", row_limit=80))

    print(f"[run] path {args.path}: tracked {tracked}/{args.frames}, keyframes {summary['n_kf']}, "
          f"ATE {ate:.5f} over span {span:.4f}")
    print(f"[profile] frames {p0}-{p1 - 1}: wall {wall_ms:.1f} ms, device busy "
          f"{summary['device_busy_ms']:.1f} ms ({100 * summary['device_busy_share']:.1f}%), "
          f"{summary['device_activities_per_frame']:.0f} device activities per frame")
    print(f"[profile] hand-written kernels: {summary['kernels']}")
    if summary["hand_launch_mismatch"]:
        print(f"[profile] launches noted vs device records differ (paired up to the shorter): "
              f"{summary['hand_launch_mismatch']}")
    print(f"{'stage':28s} {'synced calls':>12s} {'host ms':>9s} {'prof calls':>10s} "
          f"{'device ms':>9s} {'hand ms':>9s}")
    for _, name in STAGES:
        h = summary["stage_host_ms_synced"].get(name)
        d = summary["stage_device_ms"].get(name)
        print(f"{name:28s} {h['calls'] if h else 0:12d} "
              f"{h['median'] if h else float('nan'):9.2f} {d['calls'] if d else 0:10d} "
              f"{d['ms_per_call'] if d else float('nan'):9.3f} "
              f"{d['hand_ms_per_call'] if d else float('nan'):9.3f}")
    print(f"({smi}; host ms = median per call, synced window; device ms = mean "
          f"per call of the kernels launched inside the stage, profiled window, the "
          f"hand-written ones included; hand ms = those alone)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
