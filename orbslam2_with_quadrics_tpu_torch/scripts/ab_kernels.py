"""Time the port's ``pose_lm`` and ``ba_dense_terms`` kernels of one checkout
of the repo, so that two checkouts can be compared on one card in turns.

    python3 orbslam2_with_quadrics_tpu_torch/scripts/ab_kernels.py --save-window FILE
    python3 orbslam2_with_quadrics_tpu_torch/scripts/ab_kernels.py --window FILE [--root DIR]

Run by its path, not with ``-m``: it imports the port package from DIR
(default: this checkout), and the inputs, timers and bounds from this
checkout's ``chip_smoke.py``.

``--save-window`` drives ``chip_smoke.py``'s mono path once and saves the
local-BA window that ``chip_smoke.py`` times the dense terms on
(``chip_smoke.mono_window``: the last keyframe's window of the mono map, its
free poses and points moved off the optimum from a seed). The path's map
differs from run to run, so each checkout is then timed on the one saved
window. ``--window`` prints one JSON line: the card's name and power limit
(nvidia-smi), then

- ``pose_lm`` at stage A (2 x 3) and stage B (4 x 5) on 1,024 mono and
  2,048 stereo rows (``chip_smoke.py``'s timed cases, the same seeds):
  ``chip_smoke.time_pose_lm``'s numbers and the launches of one call;
- ``ba_dense_terms``' LM step on the saved window:
  ``chip_smoke.time_dense_terms``'s numbers (each launch's device time
  among them).

Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import subprocess
import sys

import torch

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def load_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke_helpers",
                                                  os.path.join(REPO, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def save_window(smoke, path):
    prob, grid, L, _ = smoke.mono_window(smoke.run_main_path("mono", log_every=100))
    fields = {k: v.cpu() if torch.is_tensor(v) else v for k, v in prob._asdict().items()}
    torch.save({"fields": fields, "grid": grid, "L": L}, path)


def edge_index(ba, prob, L, grid):
    """The dense terms' per-solve index as this checkout's solver builds it.
    A checkout from before the point-major edge index takes the bare [C, N]
    slots of ``_local_point_table``; that branch exists only so that this
    script can time such a checkout against a later one."""
    if hasattr(ba, "_local_point_index"):
        return ba._local_point_index(prob, L, grid)[1]
    return ba._local_point_table(prob, L, grid)[1]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=REPO, help="the checkout whose package is timed")
    ap.add_argument("--window", help="the saved local-BA window to time the dense terms on")
    ap.add_argument("--save-window", help="drive the mono path and save its window here")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("ab_kernels: needs a CUDA card", file=sys.stderr)
        return 1
    if bool(args.window) == bool(args.save_window):
        ap.error("give one of --window and --save-window")
    root = REPO if args.save_window else os.path.abspath(args.root)
    smoke = load_smoke()  # which puts this checkout first on the path
    sys.path[:0] = [root]
    from orbslam2_with_quadrics_tpu_torch.ops import ba
    from orbslam2_with_quadrics_tpu_torch.ops import cuda_kernels as ck
    from orbslam2_with_quadrics_tpu_torch.ops import pose_opt

    assert os.path.dirname(os.path.abspath(ba.__file__)) == os.path.join(
        root, "orbslam2_with_quadrics_tpu_torch", "ops")
    ck.build_all()
    if args.save_window:
        save_window(smoke, args.save_window)
        return 0
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    out = {"root": root, "card": smi, "pose_lm": {}, "ba_dense_terms": {}}
    cases = [("stageA mono 1024", smoke.lm_case(1024, 200), (2, 3)),
             ("stageB mono 1024", smoke.lm_case(1024, 201), (4, 5)),
             ("stageA stereo 2048", smoke.lm_case(2048, 202, stereo=0.6, extent=smoke.KITTI,
                                                  fx=718.0, bf=387.0), (2, 3)),
             ("stageB stereo 2048", smoke.lm_case(2048, 203, stereo=0.6, extent=smoke.KITTI,
                                                  fx=718.0, bf=387.0), (4, 5))]
    for name, lm_args, (rounds, iters) in cases:
        n0 = ck.LAUNCHES["pose_lm"]
        pose_opt.pose_optimization(*lm_args, rounds=rounds, iters=iters)
        launches = ck.LAUNCHES["pose_lm"] - n0
        out["pose_lm"][name] = {**smoke.time_pose_lm(name, lm_args, rounds, iters, smi),
                                "launches_per_call": launches}
    saved = torch.load(args.window)
    prob = ba.BAProblem(**{k: v.cuda() if torch.is_tensor(v) else v
                           for k, v in saved["fields"].items()})
    grid, L = tuple(saved["grid"]), saved["L"]
    out["ba_dense_terms"]["mono window"] = smoke.time_dense_terms(
        prob, edge_index(ba, prob, L, grid), grid, L, smi)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
