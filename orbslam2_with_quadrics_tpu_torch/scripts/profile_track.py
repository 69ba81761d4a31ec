"""Per-stage time of the frame step by prefix ablation.

    python -m orbslam2_with_quadrics_tpu_torch.scripts.profile_track [--device cuda|cpu] [--reps N]

Times progressively longer prefixes of the frame step (extract -> stage-A
match -> pose-opt A (2x3) -> local select -> stage-B match + pose-opt), so
each stage's cost is the difference of two prefixes, at ``bench.py``'s
workload (``common.frame_workload``: 480x640, 1,024 features, 8 levels, an
8,192-point / 64-keyframe map). Then the per-iteration cost of the
motion-only LM from the 4x5 and 1x1 schedules. The counterpart of the
reference's ``scripts/profile_track.py``. Every timed call takes its own
image (and its own features); times are on the card between CUDA events
(``common.time_ms``), or on the CPU by the host's clock.
"""

from __future__ import annotations

import argparse

import torch

from ..models import frontend as fe
from ..models import tracking as tr
from . import common


def prefixes(wl: common.FrameWorkload):
    """The five cumulative prefixes, each a function of (image, pose, prev_obs)."""
    cfg = wl.cfg

    def extract(img, T, po):
        return fe.extract_mono(cfg, img)

    def match_a(img, T, po):
        f = fe.extract_mono(cfg, img)
        return common.stage_a(wl, f, T, po)

    def pose_a(img, T, po):
        f = fe.extract_mono(cfg, img)
        return common.pose_opt_a(wl, f, T, common.stage_a(wl, f, T, po))

    def select(img, T, po):
        f = fe.extract_mono(cfg, img)
        obs_a = common.stage_a(wl, f, T, po)
        T_a = common.pose_opt_a(wl, f, T, obs_a)[0]
        return T_a, tr.select_local_points(wl.m, obs_a, wl.m.kf_valid.shape[0],
                                           common.N_LOCAL_PT, wl.obs_A)

    def full(img, T, po):
        return common.track(wl, fe.extract_mono(cfg, img), T, po)

    return [("extract", extract), ("+ stage-A match", match_a),
            ("+ pose-opt A (2x3)", pose_a), ("+ local select", select), ("full frame", full)]


def pose_chain(wl: common.FrameWorkload, rounds: int, iters: int):
    def run(img, T, po):
        f = fe.extract_mono(wl.cfg, img)
        return common.pose_opt_a(wl, f, T, common.stage_a(wl, f, T, po), rounds, iters)
    return run


DELTAS = ("extract", "stage-A match", "pose-opt A (2x3)", "local select", "stage-B mt + opt")


def main(device="cuda", reps: int = 2, workload=None) -> dict:
    """Prints the cumulative times, the stage deltas and the LM iteration
    cost. Returns {"cumulative_ms": {...}, "stage_ms": {...}, "total_ms",
    "lm_iter_ms"}."""
    wl = workload or common.frame_workload(device)
    variants = [(img, wl.T0, wl.prev_obs) for img in wl.imgs] * reps
    cum = {}
    for name, fn in prefixes(wl):
        cum[name], _ = common.time_ms(fn, variants, device)
        print(common.stage_row(f"{name} (cumulative)", cum[name]), flush=True)
    t = list(cum.values())
    stage = {DELTAS[0]: t[0]}
    stage.update({DELTAS[i]: t[i] - t[i - 1] for i in range(1, len(t))})
    print("\n--- stage deltas (ms/frame) ---")
    for name, v in stage.items():
        print(f"{name:18s}{v:9.3f}")
    print(f"{'TOTAL':18s}{t[-1]:9.3f}")
    ta, _ = common.time_ms(pose_chain(wl, 4, 5), variants, device)
    tb, _ = common.time_ms(pose_chain(wl, 1, 1), variants, device)
    print(common.stage_row("pose-opt 4x5 (chain)", ta))
    print(common.stage_row("pose-opt 1x1 (chain)", tb))
    lm = (ta - tb) / 19
    print(f"{'per-LM-iter cost':18s}{lm:9.3f} ms", flush=True)
    return {"cumulative_ms": cum, "stage_ms": stage, "total_ms": t[-1], "lm_iter_ms": lm,
            "chain_ms": {"4x5": ta, "1x1": tb}}


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--reps", type=int, default=2,
                    help="passes over the workload's 8 images per timed prefix")
    a = ap.parse_args()
    print(f"platform: {common.platform(a.device)}", flush=True)
    with torch.no_grad():
        main(a.device, a.reps)
