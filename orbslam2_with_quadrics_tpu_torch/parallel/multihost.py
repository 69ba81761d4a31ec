"""N ranks must give the solution of one process: the counterpart of the
reference's ``scripts/dist_ba_multihost.py``. The KITTI-intrinsics problem
(64 cameras, 4,096 points, 32,768 stereo observations, 0.3 px noise; 5 LM
x 30 CG steps) is solved by ``dist_ba_solve`` over N spawned ranks and by
``ba_solve`` in this process, on the same device, and compared with the
reference script's bars: poses within 1e-3, the 99th percentile of the
point differences within 1e-2 and the cost within 1e-4 relative (the ranks
sum in another order, so a deep, weakly constrained point may move more).

    python -m orbslam2_with_quadrics_tpu_torch.parallel.multihost [--procs 2]
        [--device cuda|cpu] [--backend nccl|gloo]

Prints the fields of the reference's ``DIST_BA_MULTIHOST.json`` as one JSON
line (it writes no file); exits 1 when the bars fail.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np

from ..ops import ba
from . import launch, problems

SOLVE = dict(n_iters=5, cg_iters=30)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--procs", type=int, default=2)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--backend", default=None)
    a = ap.parse_args(argv)
    prob = problems.kitti_problem(device="cpu")
    t0 = time.time()
    res = launch.run_ranks(launch.rank_jobs, a.procs, a.device,
                           [(problems.problem_to_numpy(prob), SOLVE)],
                           backend=a.backend, device=a.device)
    wall = time.time() - t0
    for r in res:
        print(json.dumps(r["report"]), flush=True)
    poses, points, cost, _ = res[0]["ba"][0]
    single, cost1 = ba.ba_solve(ba.BAProblem(*(t.to(a.device) for t in prob)), **SOLVE)
    dp = float(np.max(np.abs(poses - single.poses.cpu().numpy())))
    pt_d = np.abs(points - single.points.cpu().numpy())
    dx, dx99 = float(np.max(pt_d)), float(np.percentile(pt_d, 99))
    dcost = abs(cost - float(cost1)) / max(float(cost1), 1e-9)
    ok = dp < 1e-3 and dx99 < 1e-2 and dcost < 1e-4
    print(json.dumps({
        "check": "multi_process_dist_ba_equals_single_process",
        "processes": a.procs, "devices_per_process": 1, "device": a.device,
        "backend": res[0]["report"]["backend"],
        "max_pose_delta": dp, "max_point_delta": dx, "p99_point_delta": dx99,
        "rel_cost_delta": dcost, "cost_multi": cost, "cost_single": float(cost1),
        "wall_multi_s": wall, "pass": bool(ok),
    }), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
