"""Distributed-BA weak scaling over 1, 2, ... ranks.

    python -m orbslam2_with_quadrics_tpu_torch.scripts.bench_dist_ba [obs_per_rank] [--ranks 1,2] [--device cuda|cpu]

Each rank count N solves a problem of N x ``obs_per_rank`` stereo edges
(64 cameras, 16,384 points, KITTI intrinsics, 0.3 px of noise;
``parallel/problems.kitti_problem``) with ``dist_ba_solve`` (5 LM x 30
CG), the edges sharded over N ranks spawned by ``parallel/launch.run_ranks``;
one untimed solve, then three timed ones. Weak-scaling efficiency is
t_1 / t_N. One JSON line with the reference's keys
(``scripts/bench_dist_ba.py``).

Ranks take one card each where there are enough cards (NCCL); on the CPU,
and wherever more ranks than cards are asked for, they are gloo ranks that
share the CPU's cores or the one card: then the times measure the
collectives' cost, not scaling (the output's ``note`` says so). Real
scaling needs a host with more than one card.
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from ..parallel import launch, problems
from . import common

N_LM_ITERS, CG_ITERS, REPS = 5, 30, 3
N_CAMS, N_PTS = 64, 16384


def build(world: int, obs_per_rank: int, n_cams: int = N_CAMS, n_pts: int = N_PTS,
          device="cpu"):
    """The problem that ``world`` ranks share: world x obs_per_rank edges."""
    return problems.kitti_problem(n_cams, n_pts, obs_per_rank * world, seed=0, device=device)


def backend_for(world: int, device) -> str:
    """NCCL where every rank has a card of its own, else gloo."""
    cuda = torch.device(device).type == "cuda"
    return "nccl" if cuda and world <= torch.cuda.device_count() else "gloo"


def run(world: int, obs_per_rank: int, device="cuda", n_cams: int = N_CAMS,
        n_pts: int = N_PTS, reps: int = REPS) -> dict:
    """One rank count: {"seconds" per solve (the slowest rank's, mean of
    the timed solves), "cost", "poses", "points" of rank 0, "backend"}."""
    prob = problems.problem_to_numpy(build(world, obs_per_rank, n_cams, n_pts))
    kw = dict(n_iters=N_LM_ITERS, cg_iters=CG_ITERS)
    backend = backend_for(world, device)
    ranks = launch.run_ranks(launch.rank_jobs, world, device, [(prob, kw)] * (1 + reps), [],
                             backend=backend, device=device)
    ms = [max(r["ba"][j][3] for r in ranks) for j in range(1, 1 + reps)]
    poses, points, cost, _ = ranks[0]["ba"][-1]
    return {"seconds": float(np.mean(ms)) / 1e3, "cost": cost, "poses": poses,
            "points": points, "backend": backend}


def main(obs_per_rank: int = 65536, ranks=(1, 2), device="cuda", n_cams: int = N_CAMS,
         n_pts: int = N_PTS) -> dict:
    counts = sorted(set(ranks))
    res = {n: run(n, obs_per_rank, device, n_cams, n_pts) for n in counts}
    effs = {n: round(res[counts[0]]["seconds"] / res[n]["seconds"], 3)
            for n in counts if n > counts[0]}
    cuda = torch.device(device).type == "cuda"
    shared = (not cuda) or max(counts) > torch.cuda.device_count()
    out = {
        "metric": "dist_ba_weak_scaling_efficiency",
        "value": max(effs.values()) if effs else 1.0,
        "unit": f"t_1/t_N at {obs_per_rank} obs/rank",
        "platform": common.platform(device),
        "device_counts": counts,
        "t_per_solve_s": {str(n): round(r["seconds"], 4) for n, r in res.items()},
        "ba_iters_per_sec": {str(n): round(N_LM_ITERS / r["seconds"], 2)
                             for n, r in res.items()},
        "weak_scaling_efficiency": {str(n): e for n, e in effs.items()},
        "lm_iters_per_solve": N_LM_ITERS,
        "cg_iters": CG_ITERS,
        "backends": {str(n): r["backend"] for n, r in res.items()},
        "final_cost": {str(n): r["cost"] for n, r in res.items()},
        "note": ("ranks share one card or the CPU's cores: no scaling is measured"
                 if shared else "one card per rank"),
    }
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("obs_per_rank", nargs="?", type=int, default=65536)
    ap.add_argument("--ranks", default="1,2", help="comma-separated rank counts")
    ap.add_argument("--device", default="cuda")
    a = ap.parse_args()
    main(a.obs_per_rank, [int(x) for x in a.ranks.split(",")], device=a.device)
