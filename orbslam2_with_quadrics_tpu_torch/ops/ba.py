"""Bundle adjustment: Schur-complement Levenberg-Marquardt, PCG-solved.

Counterpart of the reference's ``ops/ba.py`` segment-sum path
(``ba_solve``, the one its local BA takes off the TPU): the edge list is a
flat fixed-capacity struct-of-arrays; landmarks are marginalized exactly
(per-point 3x3 blocks), the reduced camera system S = Hcc - W Hpp^-1 W^T is
applied implicitly by two segment sums over the edges and solved by
block-Jacobi preconditioned CG; Huber robustness as IRLS weights; LM
damping with device-side accept/reject.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

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


def _edge_terms(prob: BAProblem, huber_delta2: float):
    """Residuals, weights and weighted Jacobians for every edge."""
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
    cost = torch.sum(robust_cost(chi2, huber_delta2) * ok)
    # gauge: fixed cameras/points contribute no Jacobian
    Jc = Jc * (1.0 - prob.fixed_cam[prob.cam_idx])[:, None, None]
    Jp = Jp * (1.0 - prob.fixed_pnt[prob.pnt_idx])[:, None, None]
    wr = row_w * w[:, None]
    return e, Jc, Jp, Jc * wr[:, :, None], Jp * wr[:, :, None], cost, chi2, ok


def _seg(vals, idx, num: int):
    return torch.zeros((num,) + vals.shape[1:], dtype=vals.dtype,
                       device=vals.device).index_add(0, idx, vals)


def _build_system(prob: BAProblem, huber_delta2: float, lam):
    C, P = prob.poses.shape[0], prob.points.shape[0]
    e, Jc, Jp, JcW, JpW, cost, _, _ = _edge_terms(prob, huber_delta2)
    Hcc = _seg(torch.einsum("ori,orj->oij", JcW, Jc), prob.cam_idx, C)
    bc = _seg(-torch.einsum("ori,or->oi", JcW, e), prob.cam_idx, C)
    Hpp = _seg(torch.einsum("ori,orj->oij", JpW, Jp), prob.pnt_idx, P)
    bp = _seg(-torch.einsum("ori,or->oi", JpW, e), prob.pnt_idx, P)
    Wcp = torch.einsum("ori,orj->oij", JcW, Jp)                 # [O,6,3]

    eye6 = torch.eye(6, dtype=Hcc.dtype, device=Hcc.device)
    eye3 = torch.eye(3, dtype=Hpp.dtype, device=Hpp.device)
    # LM damping; fixed cameras and unobserved points get identity blocks
    Hcc_d = Hcc + lam * Hcc * eye6 + (1e-8 + prob.fixed_cam)[:, None, None] * eye6
    observed = torch.abs(torch.einsum("pii->p", Hpp)) > 1e-12
    Hpp_d = Hpp + lam * Hpp * eye3 + torch.where(observed, 1e-8, 1.0)[:, None, None] * eye3
    return Hcc_d, bc, torch.linalg.inv_ex(Hpp_d)[0], bp, Wcp, cost


def _schur_matvec(x, prob, Hcc_d, Hpp_inv, Wcp):
    """S x = Hcc_d x - W Hpp^-1 W^T x via two edge sweeps."""
    P, C = prob.points.shape[0], prob.poses.shape[0]
    t1 = torch.einsum("oij,oi->oj", Wcp, x[prob.cam_idx])
    y = torch.einsum("pij,pj->pi", Hpp_inv, _seg(t1, prob.pnt_idx, P))
    t2 = torch.einsum("oij,oj->oi", Wcp, y[prob.pnt_idx])
    return torch.einsum("cij,cj->ci", Hcc_d, x) - _seg(t2, prob.cam_idx, C)


def _pcg(b, matvec, Minv, iters: int):
    """Block-Jacobi preconditioned CG on the reduced camera system."""
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


def _schur_rhs(prob, Hpp_inv, bp, Wcp):
    """W Hpp^-1 bp accumulated per camera."""
    y = torch.einsum("pij,pj->pi", Hpp_inv, bp)
    t = torch.einsum("oij,oj->oi", Wcp, y[prob.pnt_idx])
    return _seg(t, prob.cam_idx, prob.poses.shape[0])


def ba_iteration(prob: BAProblem, lam, huber_delta2: float, cg_iters: int):
    """One damped Gauss-Newton (LM) step. Returns (new_prob, cost, step_ok)."""
    Hcc_d, bc, Hpp_inv, bp, Wcp, cost = _build_system(prob, huber_delta2, lam)
    g = bc - _schur_rhs(prob, Hpp_inv, bp, Wcp)
    dc = _pcg(g, lambda x: _schur_matvec(x, prob, Hcc_d, Hpp_inv, Wcp),
              torch.linalg.inv_ex(Hcc_d)[0], cg_iters)
    dc = dc * (1.0 - prob.fixed_cam)[:, None]
    # back-substitute points: dp = Hpp^-1 (bp - W^T dc)
    t1 = torch.einsum("oij,oi->oj", Wcp, dc[prob.cam_idx])
    dp = torch.einsum("pij,pj->pi", Hpp_inv,
                      bp - _seg(t1, prob.pnt_idx, prob.points.shape[0]))
    dp = dp * (1.0 - prob.fixed_pnt)[:, None]
    cand = prob._replace(poses=lie.se3_retract(prob.poses, dc),
                         points=prob.points + dp)
    new_cost = _edge_terms(cand, huber_delta2)[5]
    ok = (new_cost < cost) & torch.all(torch.isfinite(dc)) & torch.all(torch.isfinite(dp))
    out = prob._replace(poses=torch.where(ok, cand.poses, prob.poses),
                        points=torch.where(ok, cand.points, prob.points))
    return out, torch.where(ok, new_cost, cost), ok


def ba_solve(prob: BAProblem, n_iters: int = 10, cg_iters: int = 40,
             use_huber: bool = True):
    """Run ``n_iters`` LM steps. Returns (prob, final_cost)."""
    huber_delta2 = residuals.CHI2_STEREO if use_huber else 0.0
    cost = _edge_terms(prob, huber_delta2)[5]
    lam = torch.full((), 1e-4, dtype=prob.poses.dtype, device=prob.poses.device)
    for _ in range(n_iters):
        prob, cost, ok = ba_iteration(prob, lam, huber_delta2, cg_iters)
        lam = torch.clamp(torch.where(ok, lam * 0.5, lam * 4.0), 1e-8, 1e8)
    return prob, cost


def edge_chi2(prob: BAProblem):
    """Per-edge chi2 + inlier flag under the current estimate."""
    _, _, _, _, _, _, chi2, ok = _edge_terms(prob, 0.0)
    gate = torch.where(prob.is_stereo > 0, residuals.CHI2_STEREO, residuals.CHI2_MONO)
    return chi2, (chi2 < gate) & (ok > 0)
