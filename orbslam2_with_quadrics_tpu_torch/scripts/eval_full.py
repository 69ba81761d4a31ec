"""Dataset-scale synthetic evaluation of the port: its primary accuracy run.

The counterpart of the reference package's ``scripts/eval_full.py``, with
the same flags and the same JSON fields: 640x480 frames, 1000 features, 8
pyramid levels, 1,500 frames of a path with a long loop (``out_and_back``
leaves the start area and returns; only loop closure reconnects the
revisit), driven frame by frame through ``System`` as the example drivers
drive real data.

Sensors: ``--sensor mono|stereo|rgbd``; ``--quadrics`` adds object
detections rendered from ground-truth ellipsoids and scores the landmarks'
centres and scales.

Frames render on a prefetch thread, so that the host's image synthesis
overlaps the card's work (the original system's drivers likewise time only
the tracking call).

Writes (``--out``) the ATE RMSE (absolute and in % of the trajectory's
span), the loop closures, per-call tracking-time statistics and end-to-end
frames per second, keyframe churn (created, live, culled), capacity events,
the final map size and the card's peak memory. Passes when the ATE is under
2% of the span and at least one loop closed (exit code 0, else 1).

    python -m orbslam2_with_quadrics_tpu_torch.scripts.eval_full --out EVAL_torch_mono.json
    python -m orbslam2_with_quadrics_tpu_torch.scripts.eval_full --sensor stereo ...
    python -m orbslam2_with_quadrics_tpu_torch.scripts.eval_full --device cpu --frames 30 ...
"""

import argparse
import json
import queue
import subprocess
import threading
import time

import numpy as np
import torch


def make_quadric_world(n_objects, plane_half, seed, motion="orbit_big"):
    """Ground-truth ellipsoids resting on the z=0 plane.

    Objects are placed ON the camera's ground track (the nadir view cone
    at altitude 2.5 is only ~±1.5 world units wide, so randomly scattered
    objects are almost never observed — r05's first quadric eval saw 0
    of 4): for orbit motions they sit on the orbit circle, for
    out_and_back on the outbound line, each with small lateral jitter."""
    rng = np.random.RandomState(seed + 555)
    objs = []
    for c in range(n_objects):
        scale = rng.uniform(0.3, 0.65, 3)
        jx, jy = rng.uniform(-0.4, 0.4, 2)
        if motion in ("orbit_big", "orbit_loop"):
            R = 0.5 * plane_half if motion == "orbit_big" else 0.8
            ang = 2 * np.pi * (c + 0.5) / n_objects
            base = np.array([R * np.sin(ang), R * (1 - np.cos(ang))])
        else:  # out_and_back and friends: along the outbound x line
            base = np.array([plane_half * (c + 0.5) / n_objects, 0.0])
        center = np.array([
            base[0] + jx, base[1] + jy,
            scale[2],  # resting on the plane (camera looks down +z world)
        ])
        objs.append({"class_id": c, "center": center, "scale": scale})
    return objs


def gt_detections(objs, T_cw, K4, h, w):
    """Project GT ellipsoids to bbox detections [D,6] (x,y,w,h,prob,cls)."""
    from ..ops import quadrics

    rows = []
    Kc = torch.as_tensor(np.asarray(K4, np.float32))
    T7 = torch.as_tensor(T_cw_to7(T_cw))
    for o in objs:
        # GT ellipsoid: axis-aligned object frame at the world center (T_wo)
        pose = torch.tensor([1.0, 0.0, 0.0, 0.0, *o["center"]], dtype=torch.float32)
        quad = quadrics.Quadric(pose=pose, scale=torch.as_tensor(o["scale"], dtype=torch.float32))
        bb_t, ok = quadrics.project_bbox(quad, T7, Kc)
        if not bool(ok):
            continue
        bb = bb_t.numpy()
        xmin, ymin, xmax, ymax = bb
        if not np.all(np.isfinite(bb)):
            continue
        xmin, xmax = max(xmin, 0.0), min(xmax, w - 1.0)
        ymin, ymax = max(ymin, 0.0), min(ymax, h - 1.0)
        if xmax - xmin < 8 or ymax - ymin < 8:
            continue
        rows.append([xmin, ymin, xmax - xmin, ymax - ymin, 1.0, o["class_id"]])
    return np.asarray(rows, np.float32) if rows else None


def T_cw_to7(T):
    from ..utils.trajectory import _R_to_quat

    qx, qy, qz, qw = _R_to_quat(T[:3, :3])
    return np.concatenate([[qw, qx, qy, qz], T[:3, 3]]).astype(np.float32)


def card_line() -> str:
    """The card's name and power limit as nvidia-smi prints them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]


def platform(device: str) -> str:
    """"cuda" with the card's name and power limit as nvidia-smi prints
    them, or "cpu"."""
    if torch.device(device).type != "cuda":
        return "cpu"
    return f"cuda ({card_line()})"


def main(argv=None):
    ap = argparse.ArgumentParser(description="dataset-scale synthetic evaluation of the port")
    ap.add_argument("--frames", type=int, default=1500)
    ap.add_argument("--sensor", choices=["mono", "stereo", "rgbd"],
                    default="mono")
    ap.add_argument("--quadrics", action="store_true",
                    help="attach synthetic GT-object detections and score "
                         "quadric landmark recovery (BASELINE config #4)")
    ap.add_argument("--n-objects", type=int, default=4)
    ap.add_argument("--features", type=int, default=1000)
    ap.add_argument("--levels", type=int, default=8)
    ap.add_argument("--height", type=int, default=480)
    ap.add_argument("--width", type=int, default=640)
    ap.add_argument("--motion", default="out_and_back")
    ap.add_argument("--plane-half", type=float, default=8.0)
    ap.add_argument("--seed", type=int, default=3)
    ap.add_argument("--noise", type=float, default=6.0,
                    help="sensor noise sigma (gray levels); 0 = clean render")
    ap.add_argument("--tex-size", type=int, default=0,
                    help="texture resolution; 0 = auto (~250 px per world "
                         "unit)")
    ap.add_argument("--baseline", type=float, default=0.2,
                    help="stereo/RGB-D baseline in world units (b*fx = bf); "
                         "with ThDepth=40 the close-point radius is 40*b")
    ap.add_argument("--max-keyframes", type=int, default=128,
                    help="initial pool; growth/compaction must handle the rest")
    ap.add_argument("--max-points", type=int, default=32768)
    ap.add_argument("--n-local-kf", type=int, default=24,
                    help="tracking local-map window (reference caps at 80, "
                         "src/Tracking.cc:1285 — the window must be a strict "
                         "subset of the map for revisits to be loop-closure "
                         "events)")
    ap.add_argument("--out", default=None)
    ap.add_argument("--dump-traj", default=None,
                    help="write est+gt camera centers per frame (npz) for "
                         "offline drift analysis")
    ap.add_argument("--stereo-ref-ratio", type=float, default=0.75,
                    help="stereo/RGB-D thRefRatio (src/Tracking.cc:1021)")
    ap.add_argument("--max-kf-gap", type=int, default=30,
                    help="mMaxFrames (reference Camera.fps): forced "
                         "keyframe cadence; lower = denser keyframes")
    ap.add_argument("--kf-idle-frames", type=int, default=9,
                    help="modeled mapping-thread occupancy in frame periods "
                         "(reference: ~300 ms of LocalMapping per keyframe "
                         "on an i7 at 30 fps camera rate = ~9 frames, "
                         "src/LocalMapping.cc:603-613 AcceptKeyFrames). At "
                         "3 the mono map churned 1 keyframe per 3 frames "
                         "and revisit tracking collapsed (r05 diagnostics: "
                         "ATE 19.75% -> 3.6% from this knob alone)")
    ap.add_argument("--tag", default="")
    ap.add_argument("--progress-every", type=int, default=50)
    ap.add_argument("--no-warmup", action="store_true",
                    help="skip System.warmup() (on by default: it pays the "
                         "first-use costs before the first frame)")
    ap.add_argument("--device", default="cuda",
                    help="where the map and every tensor live (default: cuda)")
    args = ap.parse_args(argv)

    from ..models import frontend as fe
    from ..models import map_state as ms
    from ..models import system as sysm
    from ..utils import metrics, synthetic

    H, W = args.height, args.width
    FX = 520.9 * W / 640.0  # TUM1-like intrinsics scaled to the frame
    bf = 0.0 if args.sensor == "mono" else args.baseline * FX
    cfg = sysm.SystemConfig(
        frontend=fe.FrontendConfig(
            height=H, width=W, n_features=args.features, n_levels=args.levels,
            fx=FX, fy=FX, cx=W / 2.0, cy=H / 2.0, bf=bf,
        ),
        map=ms.MapConfig(
            max_keyframes=args.max_keyframes, max_points=args.max_points,
            n_features=args.features, n_levels=args.levels, device=args.device,
        ),
        sensor=args.sensor,
        depth_factor=1.0 / 5000.0,  # uint16 depth counts -> meters
        max_frames_between_kf=args.max_kf_gap,  # reference mMaxFrames=fps
        kf_idle_frames=args.kf_idle_frames,
        kf_stereo_ref_ratio=args.stereo_ref_ratio,
        # reference close-census constants assume 2000-feature frames
        # (src/Tracking.cc:1016); scale to the configured budget
        kf_close_tracked_th=int(100 * args.features / 2000),
        kf_close_untracked_th=int(70 * args.features / 2000),
        enable_loop_closing=True,
        enable_quadrics=args.quadrics,
        # post-loop global BA on a background thread, like the
        # reference's transient 4th thread (LoopClosing.cc:579) — the
        # r04 inline run stalled tracking ~140 s on the GBA compile+solve
        async_gba=True,
        n_local_kf=args.n_local_kf,
    )
    slam = sysm.System(cfg)
    cuda = slam.device.type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    t_warm = 0.0
    if not args.no_warmup:
        print("[eval] warmup: precompiling pipeline programs...", flush=True)
        t0 = time.time()
        slam.warmup(verbose=True)
        t_warm = time.time() - t0
        print(f"[eval] warmup done in {t_warm:.0f}s", flush=True)

    tex_size = args.tex_size or int(
        min(8192, max(2048, 2 * args.plane_half * 250))
    )
    K4np = np.array([FX, FX, W / 2.0, H / 2.0])
    objs = (
        make_quadric_world(args.n_objects, args.plane_half, args.seed,
                           motion=args.motion)
        if args.quadrics else None
    )

    # ---- producer thread: render frames ahead of the tracking loop ----
    def produce(q):
        stream = synthetic.planar_stream(
            n_frames=args.frames, h=H, w=W, fx=FX, fy=FX, seed=args.seed,
            motion=args.motion, plane_half=args.plane_half, relief=True,
            noise=args.noise, tex_size=tex_size,
        )
        if args.sensor == "stereo":
            tex = synthetic._texture(tex_size, args.seed)
            relief_tex = synthetic._texture(512, args.seed + 77)
            noise_rng = (
                np.random.RandomState(args.seed + 979)
                if args.noise > 0 else None
            )
            K3 = np.array([[FX, 0, W / 2.0], [0, FX, H / 2.0], [0, 0, 1.0]])
        for i, (img, T_gt) in enumerate(stream):
            # uint8 camera frames, as a real sensor delivers them (a 4x
            # smaller upload than float32)
            img = np.clip(img, 0, 255).astype(np.uint8)
            aux = None
            if args.sensor == "stereo":
                aux = np.clip(synthetic.render_plane(
                    tex, synthetic.stereo_right_pose(T_gt, args.baseline),
                    K3, H, W, plane_half=args.plane_half,
                    relief_tex=relief_tex, noise=args.noise,
                    noise_rng=noise_rng,
                ), 0, 255).astype(np.uint8)
            elif args.sensor == "rgbd":
                # uint16 depth counts like the TUM sensor (5000/m)
                aux = np.clip(
                    synthetic.planar_depth(T_gt, K4np, H, W, relief=True)
                    * 5000.0, 0, 65535,
                ).astype(np.uint16)
            det = (
                gt_detections(objs, T_gt, slam.cfg.frontend.K, H, W)
                if objs else None
            )
            q.put((i, img, aux, T_gt, det))
        q.put(None)

    q = queue.Queue(maxsize=8)
    threading.Thread(target=produce, args=(q,), daemon=True).start()

    poses_gt = []
    frame_times = []
    t_start = time.time()
    loops_seen_at = []
    kf_at = []          # frame index of each keyframe insertion
    while True:
        item = q.get()
        if item is None:
            break
        i, img, aux, T_gt, det = item
        poses_gt.append(T_gt)
        loops_before = slam.n_loops_closed
        kfs_before = slam.n_kfs_created
        t0 = time.perf_counter()
        if args.sensor == "mono":
            slam.track_monocular(img, timestamp=i / 30.0, detections=det)
        elif args.sensor == "stereo":
            slam.track_stereo(img, aux, timestamp=i / 30.0, detections=det)
        else:
            slam.track_rgbd(img, aux, timestamp=i / 30.0, detections=det)
        frame_times.append(time.perf_counter() - t0)
        if slam.n_kfs_created > kfs_before:
            kf_at.append(i)
        if slam.n_loops_closed > loops_before:
            loops_seen_at.append(i)
        if i % args.progress_every == 0:
            st = {0: "INIT", 1: "OK", 2: "LOST"}[slam.state]
            inl = slam.metrics[-1]["inliers"] if slam.metrics else -1
            print(
                f"frame {i:5d}/{args.frames} state={st} "
                f"kfs={slam.n_kfs_created}/{slam._kf_live} inl={inl} "
                f"loops={slam.n_loops_closed} "
                f"pool=K{slam.map.kf_valid.shape[0]}/P{slam.map.pt_pos.shape[0]} "
                f"t={time.time()-t_start:.0f}s",
                flush=True,
            )
    slam.shutdown()
    wall = time.time() - t_start
    n_frames_run = len(frame_times)

    est, gt = [], []
    for fid, ts, T7 in slam.full_trajectory():
        est.append(metrics.se3_vec_to_mat(T7))
        gt.append(poses_gt[fid])
    ce = metrics.camera_centers_from_Tcw(est)
    cg = metrics.camera_centers_from_Tcw(gt)
    with_scale = args.sensor == "mono"
    if args.dump_traj:
        fids = np.asarray([fid for fid, _, _ in slam.full_trajectory()])
        inl = np.asarray(
            [m.get("inliers", -1) for m in slam.metrics], np.int32
        )
        mat = np.asarray(
            [m.get("matches", -1) for m in slam.metrics], np.int32
        )
        np.savez(args.dump_traj, est=ce, gt=cg, fids=fids, inliers=inl,
                 matches=mat)
    ate = metrics.ate_rmse(ce, cg, with_scale=with_scale)
    span = float(np.linalg.norm(cg.max(0) - cg.min(0)))
    # ---- frame-time attribution: where does the mean go? ----
    ftall = np.asarray(frame_times)
    kf_mask = np.zeros(n_frames_run, bool)
    kf_mask[[k for k in kf_at if k < n_frames_run]] = True
    skip = min(60, n_frames_run // 4)
    steady = np.arange(n_frames_run) >= skip
    order = np.argsort(-ftall)[:15]
    time_attrib = {
        "kf_frames": int(kf_mask[steady].sum()),
        "kf_frame_mean_ms": round(
            1e3 * float(ftall[steady & kf_mask].mean()), 1
        ) if (steady & kf_mask).any() else None,
        "nonkf_frame_mean_ms": round(
            1e3 * float(ftall[steady & ~kf_mask].mean()), 1
        ) if (steady & ~kf_mask).any() else None,
        "kf_share_of_time": round(
            float(ftall[steady & kf_mask].sum() / ftall[steady].sum()), 3
        ) if steady.any() else None,
        "slowest_frames": [
            {"frame": int(j), "ms": round(1e3 * float(ftall[j]), 1),
             "kf": bool(kf_mask[j])}
            for j in order
        ],
    }
    # skip the compile-dominated head for the per-call stats
    ft = np.asarray(frame_times[min(60, n_frames_run // 4):])
    # steady-state wall fps over the second half (compiles amortized out)
    half = n_frames_run // 2
    fps_steady = (n_frames_run - half) / max(float(np.sum(
        np.asarray(frame_times[half:]))), 1e-9)
    mem = {}
    if cuda:
        mem = {
            "peak_bytes_in_use": int(torch.cuda.max_memory_allocated(slam.device)),
            "peak_bytes_reserved": int(torch.cuda.max_memory_reserved(slam.device)),
            "bytes_limit": int(torch.cuda.get_device_properties(slam.device).total_memory),
        }

    quad_metrics = None
    if args.quadrics and slam.quadrics is not None:
        # align estimated landmark centers to GT through the trajectory's
        # Umeyama (mono maps are up-to-similarity)
        s_align, R_align, t_align = metrics.umeyama_align(
            ce, cg, with_scale
        )
        per_lm = []
        for lm in slam.quadrics.landmarks:
            if not lm.initialized:
                continue
            cen_w = np.asarray(lm.pose, np.float64)[4:7]  # T_wo translation = center
            cen_aligned = s_align * (R_align @ cen_w) + t_align
            gt_obj = next(
                (o for o in objs if o["class_id"] == lm.class_id), None
            )
            if gt_obj is None:
                continue
            per_lm.append({
                "class_id": lm.class_id,
                "center_err": float(
                    np.linalg.norm(cen_aligned - gt_obj["center"])
                ),
                "scale_est": (s_align * np.asarray(lm.scale)).tolist(),
                "scale_gt": gt_obj["scale"].tolist(),
            })
        quad_metrics = {
            "landmarks_gt": len(objs),
            "landmarks_total": len(slam.quadrics.landmarks),
            "landmarks_initialized": len(per_lm),
            "center_err_mean": (
                round(float(np.mean([x["center_err"] for x in per_lm])), 4)
                if per_lm else None
            ),
            "per_landmark": per_lm,
            "uninitialized": [
                {"class_id": lm.class_id, "n_views": len(lm.kf_slots),
                 "n_points": len(lm.point_ids)}
                for lm in slam.quadrics.landmarks if not lm.initialized
            ],
        }

    result = {
        "eval": "full_scale_synthetic",
        "tag": args.tag,
        "platform": platform(args.device),
        "config": {
            "sensor": args.sensor, "frames": args.frames,
            "resolution": [H, W], "features": args.features,
            "levels": args.levels, "motion": args.motion,
            "plane_half": args.plane_half, "noise": args.noise,
            "tex_size": tex_size, "baseline": args.baseline,
            "quadrics": args.quadrics,
            "initial_pool": [args.max_keyframes, args.max_points],
        },
        "ate_rmse": float(ate),
        "ate_pct_of_span": round(100.0 * ate / span, 3),
        "trajectory_span": span,
        "frames_tracked": len(est),
        "n_loops_closed": int(slam.n_loops_closed),
        "n_reloc_corrections": int(slam.n_reloc_corrections),
        "loop_closed_at_frames": loops_seen_at,
        "kf_inserted_at_frames": [int(k) for k in kf_at],
        "keyframes_live": int(slam.map.kf_valid.sum()),
        "keyframes_created": int(slam.n_kfs_created),
        "keyframes_culled": int(slam.n_kfs_culled),
        "points_live": int(slam.map.pt_valid.sum()),
        "pool_final": [int(slam.map.kf_valid.shape[0]),
                       int(slam.map.pt_pos.shape[0])],
        "capacity_events": {
            "point_compactions": slam.n_point_compactions,
            "point_growths": slam.n_point_growths,
            "kf_compactions": slam.n_kf_compactions,
            "kf_growths": slam.n_kf_growths,
        },
        "median_tracking_ms": round(float(np.median(ft)) * 1e3, 2),
        "mean_tracking_ms": round(float(np.mean(ft)) * 1e3, 2),
        "p95_tracking_ms": round(float(np.percentile(ft, 95)) * 1e3, 2),
        "fps_end_to_end": round(n_frames_run / wall, 2),
        "time_attribution": time_attrib,
        "fps_steady_state": round(fps_steady, 2),
        "wall_seconds": round(wall, 1),
        "warmup_seconds": round(t_warm, 1),
        "latency_model": {
            "note": (
                "tracking times are host wall time around each track_* call; "
                "the pipelined steady state leaves frame i's device work "
                "running while the host takes frame i+1, so a call's time "
                "includes waiting for the previous frame's statistics"
            ),
            "device": str(slam.device),
        },
        "memory": mem,
        "quadrics": quad_metrics,
        "pass": bool(ate < 0.02 * span and slam.n_loops_closed >= 1),
    }
    print(json.dumps(result))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)
    return 0 if result["pass"] else 1


if __name__ == "__main__":
    raise SystemExit(main())
