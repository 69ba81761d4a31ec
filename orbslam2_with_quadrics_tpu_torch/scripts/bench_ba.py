"""BA iterations per second (BASELINE.md's "additional metrics").

    python -m orbslam2_with_quadrics_tpu_torch.scripts.bench_ba [n_cams] [n_pts] [obs_per_cam] [--device cuda|cpu]

Times the LM iterations of the Schur / PCG bundle adjuster
(``ops/ba.py::ba_solve``, 10 LM x 40 PCG, Huber, camera 0 fixed) on a
KITTI-local-BA-scale stereo problem: 32 cameras, 8,192 points, 1,024
observations per camera, KITTI-00 intrinsics, bf = 386.1448, 0.3 px of
noise, the poses perturbed by 0.01 in the tangent space and the points by
0.05. Prints one JSON line (``metric``, ``value``, ``unit``, ``platform``,
``final_cost``), then a second for ``ba_solve_dense`` (the card's local-BA
solver) on the same problem, whose observations are laid out camera by
camera as the dense solver takes them.

The counterpart of the reference's ``scripts/bench_ba.py``, which draws
with ``jax.random``; that stream cannot be replayed here, so the problem is
drawn from a numpy ``RandomState(0)`` with the same distributions: the same
sizes and statistics, not the same numbers. Five solves are timed, each
starting from the previous one's poses (the reference's carry), between
CUDA events on the card or by the host's clock on the CPU.
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from ..ops import ba, lie
from ..parallel import problems
from . import common

N_ITERS, CG_ITERS, REPS = 10, 40, 5


def build_problem(n_cams: int = 32, n_pts: int = 8192, obs_per_cam: int = 1024, seed: int = 0,
                  device="cuda") -> ba.BAProblem:
    """The benchmark's problem, cam-major (camera c's edges are rows
    c * obs_per_cam ... (c + 1) * obs_per_cam - 1)."""
    rng = np.random.RandomState(seed)
    O = n_cams * obs_per_cam
    cam_idx = np.repeat(np.arange(n_cams), obs_per_cam)
    pnt_idx = rng.randint(0, n_pts, O)
    prob = problems.stereo_problem(
        n_cams, n_pts, cam_idx, pnt_idx, problems.KITTI_K, problems.KITTI_BF,
        (-20.0, -5.0, 5.0), (20.0, 5.0, 60.0), [0.01] * 3 + [0.5, 0.1, 0.5], 0.05, 0.3,
        rng, device)
    xi = torch.as_tensor(rng.standard_normal((n_cams, 6)) * 0.01, dtype=torch.float32,
                         device=device)
    return prob._replace(poses=lie.se3_retract(prob.poses, xi))


def _lm_rate(solve, prob, device):
    """(LM iterations per second, final cost) of ``REPS`` chained solves."""
    carry = [prob.poses, None]

    def step():
        p, cost = solve(prob._replace(poses=carry[0]))
        carry[:] = [p.poses, cost]
        return p.poses, cost

    solve(prob)  # first use
    ms, _ = common.time_ms(step, [()] * REPS, device, warmup=0)
    return N_ITERS / (ms / 1e3), float(carry[1])


def main(n_cams=32, n_pts=8192, obs_per_cam=1024, device="cuda") -> list[dict]:
    """Prints and returns the two result dicts (PCG, then dense)."""
    prob = build_problem(n_cams, n_pts, obs_per_cam, device=device)
    O = n_cams * obs_per_cam
    plat = common.platform(device)
    out = []
    with torch.no_grad():
        for metric, solver, solve in (
            ("ba_lm_iters_per_sec", f"cg={CG_ITERS}",
             lambda p: ba.ba_solve(p, n_iters=N_ITERS, cg_iters=CG_ITERS, use_huber=True)),
            ("ba_dense_lm_iters_per_sec", "dense Schur + Cholesky",
             lambda p: ba.ba_solve_dense(p, n_iters=N_ITERS, n_local_pts=n_pts, use_huber=True,
                                         cam_grid=(n_cams, obs_per_cam))),
        ):
            ips, cost = _lm_rate(solve, prob, device)
            out.append({"metric": metric, "value": round(ips, 2),
                        "unit": f"LM iters/s ({n_cams}c/{n_pts}p/{O}obs, {solver})",
                        "platform": plat, "final_cost": cost})
            print(json.dumps(out[-1]), flush=True)
    return out


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("sizes", nargs="*", type=int, help="n_cams n_pts obs_per_cam")
    ap.add_argument("--device", default="cuda")
    a = ap.parse_args()
    main(*a.sizes[:3], device=a.device)
