"""One distributed-BA solve over N spawned ranks: the counterpart of the
reference's ``__graft_entry__.dryrun_multichip`` (256 cameras, 65,536
stereo observations of 8,192 points, 2 LM x 5 CG steps; the cost must be
finite). Each rank holds a strict subset of the edges, so a solver that
only works when every shard sees the whole problem cannot pass.

    python -m orbslam2_with_quadrics_tpu_torch.parallel.dryrun [--world 2]
        [--device cuda|cpu] [--backend nccl|gloo]

The device defaults to ``cuda`` and the backend to the device's
(``dist_ba.default_backend``): NCCL needs one card per rank, so ranks that
share a card take ``--backend gloo``. Prints one line per rank's report and
``dryrun_multichip(N): ok, cost=...``; exits 1 on a non-finite cost.
"""

from __future__ import annotations

import argparse
import json
import math
import sys

from . import launch, problems


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--world", type=int, default=2)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--backend", default=None)
    a = ap.parse_args(argv)
    prob = problems.problem_to_numpy(problems.dryrun_problem(device="cpu"))
    res = launch.run_ranks(launch.rank_jobs, a.world, a.device,
                           [(prob, dict(n_iters=2, cg_iters=5))],
                           backend=a.backend, device=a.device)
    for r in res:
        print(json.dumps(r["report"]), flush=True)
    cost = res[0]["ba"][0][2]
    if not math.isfinite(cost):
        print(f"dryrun_multichip({a.world}): non-finite cost {cost}", file=sys.stderr)
        return 1
    print(f"dryrun_multichip({a.world}): ok, cost={cost:.3f}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
