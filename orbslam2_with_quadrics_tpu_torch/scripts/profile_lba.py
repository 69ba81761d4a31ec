"""The dense-Schur local BA broken down into its parts.

    python -m orbslam2_with_quadrics_tpu_torch.scripts.profile_lba [--slope] [--device cuda|cpu]

Times each piece of ``ops/ba.py::ba_solve_dense`` on a local-BA-shaped
problem (C = 49 cameras, N = 1,024 keypoints each, P = 8,192 points,
cam-major): ``_edge_terms``, ``_build_system``, ``_local_point_table``, one
``_dense_schur_step``, ``ba_solve_dense`` at 4 iterations, the O -> P
segment sums (``index_add_``) and the batched 3x3 inverse (``_inv3x3``,
with ``torch.linalg.inv`` beside it). ``--slope`` (also run by default
after the table) adds ``ba_solve_dense`` at 1, 5 and 9 iterations, the
per-iteration slope, and each piece's per-iteration cost from loops of 1
and 9 calls. The problem is the reference's ``scripts/profile_lba.py``
problem, drawn from the same numpy ``RandomState(0)``: the same numbers.
Every timed call reads its own input (the points moved by 1e-6 per call)
and its outputs are read back after the clock stops (``common.time_ms``).
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from ..ops import ba, residuals
from . import common

C, N, P = 49, 1024, 8192


def build_problem(n_cams: int = C, n_kp: int = N, n_pts: int = P, device="cuda") -> ba.BAProblem:
    O = n_cams * n_kp
    rng = np.random.RandomState(0)
    poses = np.tile([1.0, 0, 0, 0, 0, 0, 0], (n_cams, 1)).astype(np.float32)
    poses[:, 4:] += rng.randn(n_cams, 3) * 0.1
    points = rng.uniform([-3, -2, 2], [3, 2, 10], (n_pts, 3)).astype(np.float32)
    fixed_cam = np.zeros(n_cams, np.float32)
    fixed_cam[0] = 1.0

    def t(a, dtype=torch.float32):
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=device)

    return ba.BAProblem(
        poses=t(poses), points=t(points), K=t([520.9, 521.0, 325.1, 249.7]), bf=t(0.0),
        cam_idx=t(np.repeat(np.arange(n_cams), n_kp), torch.int64),
        pnt_idx=t((np.arange(O) * 7919) % n_pts, torch.int64),
        uvr=t(rng.rand(O, 3).astype(np.float32) * 400), is_stereo=t(np.zeros(O)),
        inv_sigma2=t(np.ones(O)), valid=t(np.ones(O)), fixed_cam=t(fixed_cam),
        fixed_pnt=t(np.zeros(n_pts)))


def _variants(prob, n: int = 5):
    return [(prob._replace(points=prob.points + 1e-6 * i),) for i in range(n)]


def pieces(prob):
    """(name, fn of a problem) of every timed piece."""
    Cc, Pp = prob.poses.shape[0], prob.points.shape[0]
    grid = (Cc, prob.cam_idx.shape[0] // Cc)
    h2 = residuals.CHI2_STEREO
    lam = torch.tensor(1e-4, device=prob.points.device)
    loc_ids, ploc = ba._local_point_table(prob, Pp, grid)
    O = prob.cam_idx.shape[0]
    ones33 = torch.ones((O, 3, 3), device=prob.points.device)

    def segsum(vals, idx):
        return torch.zeros((Pp,) + vals.shape[1:], device=vals.device).index_add_(0, idx, vals)

    return [
        ("edge_terms (res+jac+cost)", lambda p: ba._edge_terms(p, h2)[5]),
        ("build_system (Hcc,Hpp-inv,Wcp)", lambda p: ba._build_system(p, h2, lam)[0]),
        ("local_point_table (unique)", lambda p: ba._local_point_table(p, Pp, grid)[1]),
        ("one full dense LM step", lambda p: ba._dense_schur_step(
            p, p.poses, p.points, lam, h2, loc_ids, ploc, grid)[2]),
        ("ba_solve_dense 4 iters", lambda p: ba.ba_solve_dense(
            p, n_iters=4, n_local_pts=Pp, use_huber=True, cam_grid=grid)[1]),
        ("index_add_ O->P [3,3]", lambda p: segsum(ones33 + p.points[0, 0], p.pnt_idx)),
        ("index_add_ O->P [3]", lambda p: segsum(ones33[:, 0] + p.points[0, 0], p.pnt_idx)),
        ("_inv3x3 [P,3,3]", lambda p: ba._inv3x3(
            torch.eye(3, device=p.points.device) * (1 + p.points[:, :1, None]))),
        ("torch.linalg.inv [P,3,3]", lambda p: torch.linalg.inv(
            torch.eye(3, device=p.points.device) * (1 + p.points[:, :1, None]))),
    ]


def table(prob, device) -> dict:
    out = {}
    for name, fn in pieces(prob):
        out[name], _ = common.time_ms(fn, _variants(prob), device)
        print(common.stage_row(name, out[name], "ms"), flush=True)
    return out


def slope(prob, device) -> dict:
    """``ba_solve_dense`` at 1, 5 and 9 iterations and its per-iteration
    slope; each piece's per-iteration cost from loops of 1 and 9 calls."""
    Cc, Pp = prob.poses.shape[0], prob.points.shape[0]
    grid = (Cc, prob.cam_idx.shape[0] // Cc)
    ts = {}
    for n in (1, 5, 9):
        ts[n], _ = common.time_ms(lambda p, n=n: ba.ba_solve_dense(
            p, n_iters=n, n_local_pts=Pp, use_huber=True, cam_grid=grid)[1],
            _variants(prob, 3), device)
        print(f"ba_solve_dense n_iters={n}: {ts[n]:.2f} ms", flush=True)
    per_iter = (ts[9] - ts[1]) / 8
    print(f"per-iter slope: {per_iter:.2f} ms; overhead+1iter: {ts[1]:.2f}", flush=True)
    per_piece = {}
    for name, fn in pieces(prob):
        if name.startswith(("one full", "ba_solve_dense")):
            continue
        a, _ = common.time_ms(lambda p, fn=fn: fn(p), _variants(prob, 3), device)
        b, _ = common.time_ms(lambda p, fn=fn: [fn(p._replace(points=p.points + 1e-7 * i))
                                                for i in range(9)], _variants(prob, 3), device)
        per_piece[name] = (b - a) / 8
        print(f"{name:32s} per-iter {per_piece[name]:8.2f} ms", flush=True)
    return {"ba_solve_dense_ms": ts, "per_iter_ms": per_iter, "per_piece_ms": per_piece}


def main(device="cuda", do_table: bool = True, do_slope: bool = True, prob=None) -> dict:
    prob = prob if prob is not None else build_problem(device=device)
    out = {}
    with torch.no_grad():
        if do_table:
            out["table_ms"] = table(prob, device)
        if do_slope:
            out.update(slope(prob, device))
    return out


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--slope", action="store_true", help="the slope part only")
    ap.add_argument("--device", default="cuda")
    a = ap.parse_args()
    print(f"platform: {common.platform(a.device)}", flush=True)
    main(a.device, do_table=not a.slope)
