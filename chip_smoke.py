"""GPU smoke run of the PyTorch/CUDA port (needs one CUDA card).

    python3 chip_smoke.py

Phases (any failure exits non-zero before the result line):
  1. torch version, device name, card name and power limit (nvidia-smi);
  2. build the CUDA kernel(s) from ``orbslam2_with_quadrics_tpu_torch/csrc``;
  3. each kernel against its plain PyTorch version on the card, bit-exact,
     at the main path's shapes plus tie / all-masked / ragged cases, with
     median CUDA-event times of both;
  4. the port's monocular main path, ``System.track_monocular``, at full
     width (640x480, 1024 features, 8 levels, default map pools, every map
     tensor on the card) over a 60-frame synthetic sequence, checked against
     ground truth, with kernel launch counts from that run.
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


def hamming_case(Q, N, seed, ties=False, masked=False, dev="cuda"):
    """Inputs of masked_hamming_best2 at (Q, N) drawn from ``seed``."""
    g = torch.Generator(device=dev).manual_seed(seed)

    def ri(lo, hi, shape):
        return torch.randint(lo, hi, shape, generator=g, device=dev, dtype=torch.int64)

    if ties:  # a few distinct descriptors: exact distance ties everywhere
        pool = ri(-2 ** 31, 2 ** 31, (4, 8)).to(torch.int32)
        qdesc, tdesc = pool[ri(0, 4, (Q,))], pool[ri(0, 4, (N,))]
    else:
        qdesc = ri(-2 ** 31, 2 ** 31, (Q, 8)).to(torch.int32)
        tdesc = ri(-2 ** 31, 2 ** 31, (N, 8)).to(torch.int32)
    scale = torch.tensor([640.0, 480.0], device=dev)
    quv = torch.rand((Q, 2), generator=g, device=dev) * scale
    tuv = torch.rand((N, 2), generator=g, device=dev) * scale
    qlvl = ri(0, 8, (Q,)).to(torch.int32)
    tlvl = ri(0, 8, (N,)).to(torch.int32)
    sf = 1.2 ** qlvl.to(torch.float32)
    qrad = (15.0 if not ties else 400.0) * sf
    qvalid = torch.rand(Q, generator=g, device=dev) < (0.0 if masked else 0.9)
    tvalid = torch.rand(N, generator=g, device=dev) < 0.9
    return (qdesc.contiguous(), quv, qrad.contiguous(), qlvl, qvalid,
            tdesc.contiguous(), tuv, tlvl, tvalid)


def phase_kernels():
    from orbslam2_with_quadrics_tpu_torch.ops import cuda_kernels as ck

    t0 = time.time()
    lib = ck.build()
    ck._lib()
    log(f"[build] {lib.name} in {time.time() - t0:.2f} s")
    cases = [
        ("main-A 1024x1024", 1024, 1024, {}),
        ("main-B 4096x1024", 4096, 1024, {}),
        ("ties 1024x1024", 1024, 1024, {"ties": True}),
        ("all-masked 512x512", 512, 512, {"masked": True}),
        ("ragged 300x200", 300, 200, {}),
        ("ragged 1x1000", 1, 1000, {}),
        ("ragged 257x1", 257, 1, {}),
    ]
    max_err = 0
    times = {}
    for i, (name, Q, N, kw) in enumerate(cases):
        args = hamming_case(Q, N, seed=100 + i, **kw)
        got = ck.masked_hamming_best2(*args)
        ref = ck.masked_hamming_best2_plain(*args)
        torch.cuda.synchronize()
        err = max(int((a.to(torch.int64) - b.to(torch.int64)).abs().max()) for a, b in zip(got, ref))
        max_err = max(max_err, err)
        n_adm = int((ref[1] < ck._BIG).sum())
        log(f"[kernel] {name}: max |kernel - plain| = {err}, tolerance 0 "
            f"(bit-exact; {n_adm}/{Q} rows with a candidate)")
        if err != 0:
            raise AssertionError(f"masked_hamming_best2 disagrees with its plain version on {name}")
        if name.startswith("main"):
            ms_k = cuda_median_ms(lambda: ck.masked_hamming_best2(*args))
            ms_p = cuda_median_ms(lambda: ck.masked_hamming_best2_plain(*args), reps=10)
            times[(Q, N)] = (ms_k, ms_p)
            log(f"[kernel] {name}: kernel {ms_k:.4f} ms, plain {ms_p:.4f} ms (median)")
    return max_err, times


def main_path_setup(device="cuda", h=480, w=640, n_features=1024, n_levels=8,
                    n_frames=60, fx=520.0, map_kw=None):
    """The main path's SystemConfig and its synthetic sequence
    (planar_sequence(seed=3)): (cfg, images, ground-truth T_cw)."""
    from orbslam2_with_quadrics_tpu_torch.models import frontend as fe
    from orbslam2_with_quadrics_tpu_torch.models import map_state as ms
    from orbslam2_with_quadrics_tpu_torch.models import system as sysm
    from orbslam2_with_quadrics_tpu_torch.utils import synthetic

    t0 = time.time()
    imgs, poses, _ = synthetic.planar_sequence(n_frames=n_frames, h=h, w=w, fx=fx,
                                               fy=fx, seed=3)
    log(f"[main] rendered {n_frames} frames {w}x{h} in {time.time() - t0:.1f} s")
    cfg = sysm.SystemConfig(
        frontend=fe.FrontendConfig(height=h, width=w, n_features=n_features,
                                   n_levels=n_levels, fx=fx, fy=fx, cx=w / 2.0, cy=h / 2.0),
        map=ms.MapConfig(n_features=n_features, n_levels=n_levels, device=device,
                         **(map_kw or {})),
    )
    return cfg, imgs, poses


def trajectory_error(traj, poses):
    """(ATE RMSE after a sim(3) alignment, span of the ground-truth camera
    centres) of ``System.full_trajectory()`` output; raises on a
    non-finite pose."""
    from orbslam2_with_quadrics_tpu_torch.utils import metrics

    est = [metrics.se3_vec_to_mat(T) for _, _, T in traj]
    if not all(np.isfinite(T).all() for T in est):
        raise AssertionError("non-finite pose in the trajectory")
    c_est = metrics.camera_centers_from_Tcw(est)
    c_gt = metrics.camera_centers_from_Tcw([poses[f] for f, _, _ in traj])
    return metrics.ate_rmse(c_est, c_gt), float(np.linalg.norm(c_gt.max(0) - c_gt.min(0)))


def run_main_path(device="cuda", h=480, w=640, n_features=1024, n_levels=8,
                  n_frames=60, fx=520.0, map_kw=None, log_every=5):
    """Drive System.track_monocular over planar_sequence(seed=3). Returns a
    dict of the run's numbers; raises on any failed check."""
    from orbslam2_with_quadrics_tpu_torch.models import system as sysm
    from orbslam2_with_quadrics_tpu_torch.ops import cuda_kernels as ck

    cfg, imgs, poses = main_path_setup(device, h, w, n_features, n_levels, n_frames,
                                       fx, map_kw)
    cuda = device == "cuda"
    map_events = []
    insert_and_map = sysm._insert_and_map

    def timed_insert_and_map(*a, **k):  # device time of each mapping pass
        if not cuda:
            return insert_and_map(*a, **k)
        ev = (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
        ev[0].record()
        out = insert_and_map(*a, **k)
        ev[1].record()
        map_events.append(ev)
        return out

    sysm._insert_and_map = timed_insert_and_map
    try:
        slam = sysm.System(cfg)
        frame_ms = []
        ck.reset_launch_counts()
        for i in range(n_frames):
            t = time.perf_counter()
            slam.track_monocular(imgs[i], timestamp=i / 30.0)
            if cuda:
                torch.cuda.synchronize()
            dt = (time.perf_counter() - t) * 1e3
            if slam.state == sysm.System.OK and i > slam.init_frame_id + 1:
                frame_ms.append(dt)
            if i % log_every == 0:
                log(f"[main] frame {i:3d} state={slam.state} kfs={int(slam.map.n_kf)} "
                    f"pts={int(slam.map.n_pt)} {dt:.1f} ms")
        traj = slam.full_trajectory()
        launches = dict(ck.LAUNCHES)
    finally:
        sysm._insert_and_map = insert_and_map
    map_ms = [a.elapsed_time(b) for a, b in map_events]

    ate, span = trajectory_error(traj, poses)
    tracked = sum(1 for m in slam.metrics if not m.get("lost"))
    out = {
        "init_frame": slam.init_frame_id, "tracked": tracked,
        "n_kf": int(slam.map.n_kf), "kfs_created": slam.n_kfs_created,
        "n_pt": int(slam.map.n_pt), "ate": ate, "span": span,
        "frame_ms_median": float(np.median(frame_ms)) if frame_ms else float("nan"),
        "map_ms_median": float(np.median(map_ms)) if map_ms else float("nan"),
        "n_map_passes": len(map_ms), "launches": launches,
    }
    log(f"[main] {json.dumps(out)}")
    checks = [
        (slam.init_frame_id >= 0 and slam.state == sysm.System.OK, "initialized and OK"),
        (tracked >= min(40, n_frames - 10), ">= 40 frames tracked"),
        (int(slam.map.n_kf) >= 3, ">= 3 keyframes"),
        (ate < 0.05 * span, "ATE < 5% of span"),
    ]
    if cuda:
        checks.append((launches["masked_hamming_best2"] > 0,
                       "masked_hamming_best2 launched by the main path"))
    for ok, what in checks:
        if not ok:
            raise AssertionError(f"main path check failed: {what}")
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

    max_err, times = phase_kernels()
    res = run_main_path()
    ms_k, ms_p = times[(4096, 1024)]
    log(f"[main] median frame {res['frame_ms_median']:.2f} ms, median mapping pass "
        f"{res['map_ms_median']:.2f} ms ({smi})")
    print(json.dumps({"kernels": [{
        "name": "masked_hamming_best2", "route": "cuda", "source": KERNEL_SOURCE,
        "replaces": KERNEL_REPLACES,
        "launches": res["launches"]["masked_hamming_best2"],
        "max_abs_err": max_err, "ms": ms_k, "plain_ms": ms_p,
    }]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
