"""Bundle adjustment: Schur-complement Levenberg-Marquardt.

Counterpart of the reference's ``ops/ba.py``. The edge list is a flat
fixed-capacity struct-of-arrays; landmarks are marginalized exactly
(per-point 3x3 blocks); Huber robustness as IRLS weights; LM damping with
device-side accept/reject. Two solvers of the reduced camera system
S = Hcc - W Hpp^-1 W^T:

- ``ba_solve``: S applied implicitly by two segment sums over the edges and
  solved by block-Jacobi preconditioned CG (global BA, the quadric joint
  BA, local BA on the CPU, and distributed BA: with a ``group`` every
  segment sum and the cost are summed over the ranks' edge shards, see
  ``parallel/dist_ba.py``);
- ``ba_solve_dense``: S built densely over a cam-major [C, N] edge table
  and Cholesky-solved (local BA on the card, where the window's <= ~50
  cameras make S at most ~300 x 300).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
import torch.distributed as dist

from . import lie, residuals
from .pose_opt import robust_cost


class BAProblem(NamedTuple):
    poses: torch.Tensor       # [C,7] T_cw
    points: torch.Tensor      # [P,3]
    K: torch.Tensor           # [4]
    bf: torch.Tensor          # scalar fx*baseline
    cam_idx: torch.Tensor     # [O] int64
    pnt_idx: torch.Tensor     # [O] int64
    uvr: torch.Tensor         # [O,3]
    is_stereo: torch.Tensor   # [O] float (1.0 stereo row active)
    inv_sigma2: torch.Tensor  # [O]
    valid: torch.Tensor       # [O] float mask
    fixed_cam: torch.Tensor   # [C] float (1.0 = pose constant)
    fixed_pnt: torch.Tensor   # [P] float


def _all_sum(t, group):
    """``t`` summed over the ranks of ``group``, in place (the reference's
    ``psum``); ``t`` itself when ``group`` is None."""
    if group is not None:
        dist.all_reduce(t, op=dist.ReduceOp.SUM, group=group)
    return t


def _edge_terms(prob: BAProblem, huber_delta2: float, group=None):
    """Residuals, weights and weighted Jacobians for every edge; the cost is
    summed over ``group``'s ranks."""
    e, Jc, Jp, z = residuals.residual_and_jacobians(
        prob.poses[prob.cam_idx], prob.K, prob.bf, prob.points[prob.pnt_idx], prob.uvr
    )
    row_w = torch.stack(
        [torch.ones_like(prob.is_stereo), torch.ones_like(prob.is_stereo), prob.is_stereo],
        dim=-1,
    )
    ok = prob.valid * (z > 0.05).to(e.dtype)
    chi2 = torch.sum(e * e * row_w, dim=-1) * prob.inv_sigma2
    hw = residuals.huber_weight(chi2, huber_delta2) if huber_delta2 > 0 else 1.0
    w = ok * prob.inv_sigma2 * hw
    cost = _all_sum(torch.sum(robust_cost(chi2, huber_delta2) * ok), group)
    # gauge: fixed cameras/points contribute no Jacobian
    Jc = Jc * (1.0 - prob.fixed_cam[prob.cam_idx])[:, None, None]
    Jp = Jp * (1.0 - prob.fixed_pnt[prob.pnt_idx])[:, None, None]
    wr = row_w * w[:, None]
    return e, Jc, Jp, Jc * wr[:, :, None], Jp * wr[:, :, None], cost, chi2, ok


def _seg(vals, idx, num: int, group=None):
    return _all_sum(torch.zeros((num,) + vals.shape[1:], dtype=vals.dtype,
                                device=vals.device).index_add(0, idx, vals), group)


def _build_system(prob: BAProblem, huber_delta2: float, lam, group=None):
    C, P = prob.poses.shape[0], prob.points.shape[0]
    e, Jc, Jp, JcW, JpW, cost, _, _ = _edge_terms(prob, huber_delta2, group)
    Hcc = _seg(torch.einsum("ori,orj->oij", JcW, Jc), prob.cam_idx, C, group)
    bc = _seg(-torch.einsum("ori,or->oi", JcW, e), prob.cam_idx, C, group)
    Hpp = _seg(torch.einsum("ori,orj->oij", JpW, Jp), prob.pnt_idx, P, group)
    bp = _seg(-torch.einsum("ori,or->oi", JpW, e), prob.pnt_idx, P, group)
    Wcp = torch.einsum("ori,orj->oij", JcW, Jp)                 # [O,6,3]

    eye6 = torch.eye(6, dtype=Hcc.dtype, device=Hcc.device)
    eye3 = torch.eye(3, dtype=Hpp.dtype, device=Hpp.device)
    # LM damping; fixed cameras and unobserved points get identity blocks
    Hcc_d = Hcc + lam * Hcc * eye6 + (1e-8 + prob.fixed_cam)[:, None, None] * eye6
    observed = torch.abs(torch.einsum("pii->p", Hpp)) > 1e-12
    Hpp_d = Hpp + lam * Hpp * eye3 + torch.where(observed, 1e-8, 1.0)[:, None, None] * eye3
    return Hcc_d, bc, torch.linalg.inv_ex(Hpp_d)[0], bp, Wcp, cost


def _schur_matvec(x, prob, Hcc_d, Hpp_inv, Wcp, group=None):
    """S x = Hcc_d x - W Hpp^-1 W^T x via two edge sweeps."""
    P, C = prob.points.shape[0], prob.poses.shape[0]
    t1 = torch.einsum("oij,oi->oj", Wcp, x[prob.cam_idx])
    y = torch.einsum("pij,pj->pi", Hpp_inv, _seg(t1, prob.pnt_idx, P, group))
    t2 = torch.einsum("oij,oj->oi", Wcp, y[prob.pnt_idx])
    return torch.einsum("cij,cj->ci", Hcc_d, x) - _seg(t2, prob.cam_idx, C, group)


def _pcg(b, matvec, Minv, iters: int):
    """Block-Jacobi preconditioned CG on the reduced camera system. Its dot
    products run over camera vectors, which every rank holds whole, so they
    take no reduction."""
    x = torch.zeros_like(b)
    r = b
    z = torch.einsum("cij,cj->ci", Minv, r)
    p = z
    for _ in range(iters):
        Ap = matvec(p)
        rz = torch.sum(r * z)
        denom = torch.sum(p * Ap)
        alpha = rz / torch.where(torch.abs(denom) < 1e-20, 1e-20, denom)
        x = x + alpha * p
        r = r - alpha * Ap
        z = torch.einsum("cij,cj->ci", Minv, r)
        beta = torch.sum(r * z) / torch.where(torch.abs(rz) < 1e-20, 1e-20, rz)
        p = z + beta * p
    return x


def _schur_rhs(prob, Hpp_inv, bp, Wcp, group=None):
    """W Hpp^-1 bp accumulated per camera."""
    y = torch.einsum("pij,pj->pi", Hpp_inv, bp)
    t = torch.einsum("oij,oj->oi", Wcp, y[prob.pnt_idx])
    return _seg(t, prob.cam_idx, prob.poses.shape[0], group)


def ba_iteration(prob: BAProblem, lam, huber_delta2: float, cg_iters: int, group=None):
    """One damped Gauss-Newton (LM) step. Returns (new_prob, cost, step_ok).
    With a ``group`` the step and its accept test are computed from reduced
    values only, so every rank takes the same step."""
    Hcc_d, bc, Hpp_inv, bp, Wcp, cost = _build_system(prob, huber_delta2, lam, group)
    g = bc - _schur_rhs(prob, Hpp_inv, bp, Wcp, group)
    dc = _pcg(g, lambda x: _schur_matvec(x, prob, Hcc_d, Hpp_inv, Wcp, group),
              torch.linalg.inv_ex(Hcc_d)[0], cg_iters)
    dc = dc * (1.0 - prob.fixed_cam)[:, None]
    # back-substitute points: dp = Hpp^-1 (bp - W^T dc)
    t1 = torch.einsum("oij,oi->oj", Wcp, dc[prob.cam_idx])
    dp = torch.einsum("pij,pj->pi", Hpp_inv,
                      bp - _seg(t1, prob.pnt_idx, prob.points.shape[0], group))
    dp = dp * (1.0 - prob.fixed_pnt)[:, None]
    cand = prob._replace(poses=lie.se3_retract(prob.poses, dc),
                         points=prob.points + dp)
    new_cost = _edge_terms(cand, huber_delta2, group)[5]
    ok = (new_cost < cost) & torch.all(torch.isfinite(dc)) & torch.all(torch.isfinite(dp))
    if group is not None:
        # accepted only where every rank accepts
        flag = ok.to(torch.int32)
        dist.all_reduce(flag, op=dist.ReduceOp.MIN, group=group)
        ok = flag > 0
    out = prob._replace(poses=torch.where(ok, cand.poses, prob.poses),
                        points=torch.where(ok, cand.points, prob.points))
    return out, torch.where(ok, new_cost, cost), ok


def ba_solve(prob: BAProblem, n_iters: int = 10, cg_iters: int = 40,
             use_huber: bool = True, group=None):
    """Run ``n_iters`` LM steps. Returns (prob, final_cost). ``group``: a
    ``torch.distributed`` process group over which ``prob``'s edges are
    sharded (poses and points whole on every rank), or None."""
    huber_delta2 = residuals.CHI2_STEREO if use_huber else 0.0
    cost = _edge_terms(prob, huber_delta2, group)[5]
    lam = torch.full((), 1e-4, dtype=prob.poses.dtype, device=prob.poses.device)
    for _ in range(n_iters):
        prob, cost, ok = ba_iteration(prob, lam, huber_delta2, cg_iters, group)
        lam = torch.clamp(torch.where(ok, lam * 0.5, lam * 4.0), 1e-8, 1e8)
    return prob, cost


def edge_chi2(prob: BAProblem):
    """Per-edge chi2 + inlier flag under the current estimate."""
    _, _, _, _, _, _, chi2, ok = _edge_terms(prob, 0.0)
    gate = torch.where(prob.is_stereo > 0, residuals.CHI2_STEREO, residuals.CHI2_MONO)
    return chi2, (chi2 < gate) & (ok > 0)


def local_ba(prob: BAProblem, cg_iters: int = 40):
    """The reference's LocalBundleAdjustment schedule over :func:`ba_solve`:
    5 robust iterations, purge the outlier edges, 10 more without the
    robust kernel (src/Optimizer.cc:653-707). Returns (prob, final_cost)."""
    prob, _ = ba_solve(prob, n_iters=5, cg_iters=cg_iters, use_huber=True)
    _, inl = edge_chi2(prob)
    prob = prob._replace(valid=prob.valid * inl.to(prob.valid.dtype))
    return ba_solve(prob, n_iters=10, cg_iters=cg_iters, use_huber=False)


_INDEX_FIELDS = ("cam_idx", "pnt_idx")


def ba_problem_from_numpy(src, device="cpu") -> BAProblem:
    """A ``BAProblem`` from any object with the same field names holding
    array-likes (the reference package's arrays): index fields as int64,
    the rest as float32."""
    return BAProblem(**{
        f: torch.as_tensor(np.array(getattr(src, f)),
                           dtype=torch.int64 if f in _INDEX_FIELDS else torch.float32,
                           device=device)
        for f in BAProblem._fields
    })


# ---------------------------------------------------------------------------
# dense-Schur direct solver (local BA on the card)
#
# The edge table is cam-major [C, N] (camera c's edges are one row, as every
# caller gathers it from the [K, N] observation table). Per-edge Jacobians
# are [C, N, 3, 6] / [C, N, 3, 3] blocks; the points that couple cameras are
# compacted into L local slots once per solve, and the per-point blocks
# (Hpp, bp, the coupling V [C, L, 6, 3]) are index_add sums into L + 1 slots
# (slot L collects the edges of points that are not local and is dropped).
# S = Hcc - V Hpp^-1 V^T is one [6C, 3L] @ [3L, 6C] product and is solved by
# Cholesky: a local window has <= ~50 cameras, so S is at most ~300 x 300.
# ---------------------------------------------------------------------------


def _local_point_table(prob: BAProblem, n_local_pts: int, cam_grid):
    """The L smallest point ids that couple cameras (a valid edge, a free
    point) in L local slots. Points past them are treated as fixed this
    solve: they keep their residuals and camera terms but get no coupling,
    no right-hand side and no update. Sort, first occurrences and a running
    count (no host read). Returns (loc_ids [L], point id or P for an empty
    slot; ploc [C, N], the local slot of each edge's point, L = none)."""
    C, N = cam_grid
    P = prob.points.shape[0]
    L = n_local_pts
    dev = prob.points.device
    eligible = (prob.valid > 0) & (prob.fixed_pnt[prob.pnt_idx] < 0.5)
    tagged = torch.where(eligible, prob.pnt_idx, P)
    ts, _ = torch.sort(tagged)
    first = torch.ones_like(ts, dtype=torch.bool)
    first[1:] = ts[1:] != ts[:-1]
    rank = torch.cumsum(first, 0) - 1
    keep = first & (rank < L)
    loc_ids = torch.full((L + 1,), P, dtype=torch.int64, device=dev).scatter(
        0, torch.where(keep, rank, L), torch.where(keep, ts, P))[:L]
    slot = torch.arange(L, device=dev)
    loc_of = torch.full((P + 1,), L, dtype=torch.int64, device=dev).scatter(
        0, loc_ids, torch.where(loc_ids < P, slot, L))
    return loc_ids, loc_of[tagged].reshape(C, N)


def _grid_chi2(prob: BAProblem, e, z, cam_grid):
    """(row weights [C,N,3], inv sigma^2 [C,N], validity [C,N], chi2 [C,N])."""
    C, N = cam_grid
    s = prob.is_stereo.reshape(C, N)
    row_w = torch.stack([torch.ones_like(s), torch.ones_like(s), s], dim=-1)
    is2 = prob.inv_sigma2.reshape(C, N)
    ok = prob.valid.reshape(C, N) * (z > 0.05).to(e.dtype)
    return row_w, is2, ok, torch.sum(e * e * row_w, dim=-1) * is2


def _cost_grid(prob: BAProblem, poses, points, huber_delta2: float, cam_grid):
    """Robust cost of the cam-major edge table (the LM accept test)."""
    C, N = cam_grid
    e, z = residuals.residual_only(poses[:, None, :], prob.K, prob.bf,
                                   points[prob.pnt_idx.reshape(C, N)],
                                   prob.uvr.reshape(C, N, 3))
    _, _, ok, chi2 = _grid_chi2(prob, e, z, cam_grid)
    return torch.sum(robust_cost(chi2, huber_delta2) * ok)


def _inv3x3(A):
    """Closed-form batched 3x3 inverse (adjugate / determinant): no batched
    LU, and a singular block gives large finite numbers, never a host sync."""
    a, b, c = A[..., 0, 0], A[..., 0, 1], A[..., 0, 2]
    d, e, f = A[..., 1, 0], A[..., 1, 1], A[..., 1, 2]
    g, h, i = A[..., 2, 0], A[..., 2, 1], A[..., 2, 2]
    co_a = e * i - f * h
    co_b = -(d * i - f * g)
    co_c = d * h - e * g
    det = a * co_a + b * co_b + c * co_c
    idet = 1.0 / torch.where(torch.abs(det) < 1e-20, 1e-20, det)
    adj = torch.stack([
        torch.stack([co_a, -(b * i - c * h), b * f - c * e], -1),
        torch.stack([co_b, a * i - c * g, -(a * f - c * d)], -1),
        torch.stack([co_c, -(a * h - b * g), a * e - b * d], -1),
    ], -2)
    return adj * idet[..., None, None]


def _cholesky_solve_nan(S, g):
    """x with S x = g by Cholesky; NaN where S is not positive definite
    (XLA's Cholesky gives NaN there, so the step is rejected). Two
    triangular solves and no read of the error flag on the host."""
    L, info = torch.linalg.cholesky_ex(S)
    y = torch.linalg.solve_triangular(L, g[:, None], upper=False)
    x = torch.linalg.solve_triangular(L.mT, y, upper=True)[:, 0]
    return torch.where(info == 0, x, torch.full_like(x, float("nan")))


def _dense_schur_step(prob: BAProblem, poses, points, lam, huber_delta2: float,
                      loc_ids, ploc, cam_grid):
    """One LM step solving the reduced camera system exactly. Returns
    (poses, points, cost, accepted)."""
    C, N = cam_grid
    P = points.shape[0]
    L = loc_ids.shape[0]
    dev, dt = points.device, points.dtype
    pid = prob.pnt_idx.reshape(C, N)
    e, Jc, Jp, z = residuals.residual_and_jacobians(
        poses[:, None, :], prob.K, prob.bf, points[pid], prob.uvr.reshape(C, N, 3))
    row_w, is2, ok, chi2 = _grid_chi2(prob, e, z, cam_grid)
    hw = residuals.huber_weight(chi2, huber_delta2) if huber_delta2 > 0 else 1.0
    w = ok * is2 * hw
    cost = torch.sum(robust_cost(chi2, huber_delta2) * ok)
    # gauge: fixed cameras and points contribute no Jacobian
    Jc = Jc * (1.0 - prob.fixed_cam)[:, None, None, None]
    Jp = Jp * (1.0 - prob.fixed_pnt[pid])[..., None, None]
    wr = (row_w * w[..., None])[..., None]
    JcW, JpW = Jc * wr, Jp * wr

    eye6 = torch.eye(6, dtype=dt, device=dev)
    eye3 = torch.eye(3, dtype=dt, device=dev)
    Hcc = torch.einsum("cnri,cnrj->cij", JcW, Jc)
    bc = -torch.einsum("cnri,cnr->ci", JcW, e)
    Hcc_d = Hcc + lam * Hcc * eye6 + (1e-8 + prob.fixed_cam)[:, None, None] * eye6

    # per-point blocks and the coupling, summed into L + 1 local slots
    flat = ploc.reshape(-1)
    Hpp = torch.zeros((L + 1, 3, 3), dtype=dt, device=dev).index_add_(
        0, flat, torch.einsum("cnri,cnrj->cnij", JpW, Jp).reshape(-1, 3, 3))[:L]
    bp = torch.zeros((L + 1, 3), dtype=dt, device=dev).index_add_(
        0, flat, -torch.einsum("cnri,cnr->cni", JpW, e).reshape(-1, 3))[:L]
    V = torch.zeros((C, L + 1, 6, 3), dtype=dt, device=dev)
    V.index_put_((torch.arange(C, device=dev)[:, None].expand(C, N), ploc),
                 torch.einsum("cnri,cnrj->cnij", JcW, Jp), accumulate=True)
    V = V[:, :L]

    # damped point blocks (an unobserved slot gets the identity)
    trace = torch.diagonal(Hpp, dim1=-2, dim2=-1).sum(-1)
    Hpp_d = Hpp + lam * Hpp * eye3 + torch.where(
        torch.abs(trace) > 1e-12, 1e-8, 1.0)[:, None, None] * eye3
    Hpi = _inv3x3(Hpp_d)

    # S = blockdiag(Hcc_d) - V Hpi V^T; g = bc - V Hpi bp
    VH = torch.einsum("clij,ljk->clik", V, Hpi)
    S_cross = (VH.permute(0, 2, 1, 3).reshape(6 * C, 3 * L)
               @ V.permute(0, 2, 1, 3).reshape(6 * C, 3 * L).T)
    eyeC = torch.eye(C, dtype=dt, device=dev)
    S = (eyeC[:, None, :, None] * Hcc_d[:, :, None, :]).reshape(6 * C, 6 * C) - S_cross
    g = bc - torch.einsum("clij,lj->ci", V, torch.einsum("ljk,lk->lj", Hpi, bp))
    dc = _cholesky_solve_nan(S + 1e-10 * torch.eye(6 * C, dtype=dt, device=dev),
                             g.reshape(-1)).reshape(C, 6)
    dc = dc * (1.0 - prob.fixed_cam)[:, None]

    # back-substitute the local points: dp = Hpi (bp - V^T dc)
    dp_L = torch.einsum("ljk,lk->lj", Hpi, bp - torch.einsum("clij,ci->lj", V, dc))
    new_points = points + torch.zeros((P + 1, 3), dtype=dt, device=dev).index_add_(
        0, loc_ids, dp_L)[:P]
    new_poses = lie.se3_retract(poses, dc)
    new_cost = _cost_grid(prob, new_poses, new_points, huber_delta2, cam_grid)
    acc = ((new_cost < cost) & torch.all(torch.isfinite(dc))
           & torch.all(torch.isfinite(dp_L)))
    return (torch.where(acc, new_poses, poses), torch.where(acc, new_points, points),
            torch.where(acc, new_cost, cost), acc)


def ba_solve_dense(prob: BAProblem, n_iters: int = 10, n_local_pts: int = 8192,
                   use_huber: bool = True, cam_grid=None):
    """``ba_solve`` with the dense-Schur direct step; the same LM damping
    and accept schedule. ``cam_grid = (C, N)`` declares the edge table
    cam-major (``cam_idx`` = arange(C) repeated N times) and is required.
    Returns (prob, final_cost)."""
    if cam_grid is None:
        raise ValueError("ba_solve_dense needs a cam-major edge table (cam_grid=(C, N)); "
                         "use ba_solve for other edge layouts")
    huber_delta2 = residuals.CHI2_STEREO if use_huber else 0.0
    loc_ids, ploc = _local_point_table(prob, n_local_pts, cam_grid)
    poses, points = prob.poses, prob.points
    cost = _cost_grid(prob, poses, points, huber_delta2, cam_grid)
    lam = torch.full((), 1e-4, dtype=poses.dtype, device=poses.device)
    for _ in range(n_iters):
        poses, points, cost, ok = _dense_schur_step(prob, poses, points, lam, huber_delta2,
                                                    loc_ids, ploc, cam_grid)
        lam = torch.clamp(torch.where(ok, lam * 0.5, lam * 4.0), 1e-8, 1e8)
    return prob._replace(poses=poses, points=points), cost
