"""Dual-quadric object landmarks: SVD init, conic projection, joint BA.

Counterpart of the reference's ``ops/quadrics.py``:

- a 9-dof ellipsoid = SE3 pose + 3 semi-axes; dual form
  Q* = T diag(s^2, -1) T^T;
- SVD initialization from >= 3 bbox detections: bbox edges -> image lines
  -> back-projected planes pi = P^T l -> rows of the 10-dim constraint
  pi^T Q* pi = 0 -> least-squares dual quadric;
- conic projection C* = P Q* P^T and the bbox of its tangent-line extremes;
- the bbox reprojection residual with forward-mode Jacobians, and a joint
  camera-point-quadric LM where points are Schur-marginalized (``ops/ba.py``)
  and quadrics join the cameras in the PCG-solved reduced system.

Functions broadcast over leading axes where the reference ``vmap``s them.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from . import ba, camera, lie, residuals

_SYM_IDX = ((0, 1, 2, 3), (1, 4, 5, 6), (2, 5, 7, 8), (3, 6, 8, 9))


class Quadric(NamedTuple):
    pose: torch.Tensor   # [...,7] T_wo (object frame -> world)
    scale: torch.Tensor  # [...,3] semi-axes


def dual_matrix(q: Quadric):
    """Q* = T diag(s^2, -1) T^T, [...,4,4]."""
    T = lie.se3_to_matrix(q.pose)
    d = torch.cat([q.scale ** 2, -torch.ones_like(q.scale[..., :1])], dim=-1)
    return (T * d[..., None, :]) @ T.mT


def from_dual_matrix(Qd):
    """Constrained ellipsoid of a general dual quadric [...,4,4]: scale to
    Q*[3,3] = -1, split off the centre, eigendecompose the shape block.
    The eigenvectors' signs are free; the sign of the determinant makes the
    rotation proper, so the pose may differ from another eigensolver's by a
    diagonal +-1 while the dual matrix it stands for does not change. A
    non-finite matrix gives a NaN quadric (``eigh`` would raise)."""
    Qd = 0.5 * (Qd + Qd.mT)
    q33 = Qd[..., 3, 3]
    Qd = Qd * torch.where(torch.abs(q33) < 1e-12, 1e12, -1.0 / q33)[..., None, None]
    t = -Qd[..., :3, 3]
    E = Qd[..., :3, :3] + t[..., :, None] * t[..., None, :]   # R diag(s^2) R^T
    finite = torch.all(torch.isfinite(E.flatten(-2)), dim=-1)
    eye = torch.eye(3, dtype=E.dtype, device=E.device)
    evals, evecs = torch.linalg.eigh(torch.where(finite[..., None, None], E, eye))
    nan = torch.full_like(evals, float("nan"))
    s = torch.where(finite[..., None], torch.sqrt(torch.clamp(evals, min=1e-9)), nan)
    R = evecs * torch.sign(torch.linalg.det(evecs))[..., None, None]
    return Quadric(pose=lie.se3_make(lie.matrix_to_quat(R), t), scale=s)


def retract(q: Quadric, xi):
    """xi = [omega, upsilon, dlog_s] [...,9] tangent update."""
    return Quadric(pose=lie.se3_retract(q.pose, xi[..., :6]),
                   scale=q.scale * torch.exp(xi[..., 6:9]))


def bbox_to_lines(bbox):
    """bbox (xmin, ymin, xmax, ymax) [...,4] -> the 4 image lines x = xmin,
    y = ymin, x = xmax, y = ymax as [...,4,3]."""
    one, zero = torch.ones_like(bbox[..., 0]), torch.zeros_like(bbox[..., 0])
    return torch.stack([
        torch.stack([one, zero, -bbox[..., 0]], -1),
        torch.stack([zero, one, -bbox[..., 1]], -1),
        torch.stack([one, zero, -bbox[..., 2]], -1),
        torch.stack([zero, one, -bbox[..., 3]], -1),
    ], dim=-2)


def constraint_rows(P, bbox):
    """Projection [...,3,4] and bbox [...,4] -> the 4 rows [...,4,10] of
    the constraint pi^T Q* pi = 0 of the back-projected planes pi = P^T l."""
    planes = bbox_to_lines(bbox) @ P
    a, b, c, d = planes.unbind(-1)
    return torch.stack([a * a, 2 * a * b, 2 * a * c, 2 * a * d,
                        b * b, 2 * b * c, 2 * b * d,
                        c * c, 2 * c * d,
                        d * d], dim=-1)


def vec10_to_sym(q10):
    """[...,10] (row-major upper triangle) -> symmetric [...,4,4]."""
    return q10[..., torch.as_tensor(_SYM_IDX, device=q10.device)]


def quadric_init(T_cws, Kc, bboxes, valid):
    """SVD dual-quadric init from bbox observations.

    Args: T_cws [M,7] camera poses of the observing keyframes, Kc [4],
    bboxes [M,4] (xmin, ymin, xmax, ymax), valid [M] bool (>= 3 needed).
    Returns (Quadric, ok): ok is a device bool, never read here. The right
    singular vector's sign is free; ``from_dual_matrix`` divides it out."""
    rows = constraint_rows(camera.projection_matrix(T_cws, Kc), bboxes)
    A = (rows * valid[:, None, None].to(rows.dtype)).reshape(-1, 10)
    # row normalization for conditioning
    A = A / torch.clamp(torch.linalg.norm(A, dim=-1, keepdim=True), min=1e-12)
    finite = torch.all(torch.isfinite(A))
    _, _, vt = torch.linalg.svd(torch.where(finite, A, torch.zeros_like(A)),
                                full_matrices=False)
    quad = from_dual_matrix(vec10_to_sym(vt[-1]))
    ok = (finite & (torch.sum(valid.to(torch.int32)) >= 3)
          & torch.all(torch.isfinite(quad.pose)) & torch.all(torch.isfinite(quad.scale))
          & torch.all(quad.scale > 1e-4) & torch.all(quad.scale < 1e3))
    return quad, ok


def project_bbox(quad: Quadric, T_cw, Kc):
    """The ellipsoid's bbox under pose T_cw from its dual conic. Returns
    (bbox [...,4], ok [...]); ok is False where the conic is no ellipse
    around the image (the object behind or around the camera)."""
    P = camera.projection_matrix(T_cw, Kc)
    C = P @ dual_matrix(quad) @ P.mT
    c22 = C[..., 2, 2]
    C = C / torch.where(torch.abs(c22) < 1e-12, 1e-12, c22)[..., None, None]
    x0, y0 = C[..., 0, 2], C[..., 1, 2]
    dx2 = x0 * x0 - C[..., 0, 0]
    dy2 = y0 * y0 - C[..., 1, 1]
    ok = (dx2 > 0) & (dy2 > 0)
    dx = torch.sqrt(torch.clamp(dx2, min=1e-9))
    dy = torch.sqrt(torch.clamp(dy2, min=1e-9))
    return torch.stack([x0 - dx, y0 - dy, x0 + dx, y0 + dy], dim=-1), ok


def bbox_residual(quad: Quadric, T_cw, Kc, bbox_meas):
    """e = measured - projected bbox [...,4] (0 where the projection is
    not an ellipse), and that flag."""
    pred, ok = project_bbox(quad, T_cw, Kc)
    return torch.where(ok[..., None], bbox_meas - pred, torch.zeros_like(pred)), ok


# ---------------------------------------------------------------------------
# joint camera-point-quadric BA
# ---------------------------------------------------------------------------

class QuadricBAProblem(NamedTuple):
    """Point-BA problem + quadric landmarks with bbox edges."""

    base: ba.BAProblem         # point edges
    quad_pose: torch.Tensor    # [Q,7]
    quad_scale: torch.Tensor   # [Q,3]
    qe_cam: torch.Tensor       # [QE] int64 camera index
    qe_quad: torch.Tensor      # [QE] int64 quadric index
    qe_bbox: torch.Tensor      # [QE,4] measured bbox
    qe_valid: torch.Tensor     # [QE] float mask
    qe_w: torch.Tensor         # [QE] information weight


def quadric_ba_problem_from_numpy(src, device="cpu") -> QuadricBAProblem:
    """A ``QuadricBAProblem`` (with its ``BAProblem`` base) from any object
    with the same field names holding array-likes."""
    def t(f):
        return torch.as_tensor(np.array(getattr(src, f)), device=device,
                               dtype=torch.int64 if f in ("qe_cam", "qe_quad") else torch.float32)
    return QuadricBAProblem(base=ba.ba_problem_from_numpy(src.base, device),
                            **{f: t(f) for f in QuadricBAProblem._fields[1:]})


def _bbox_errors(prob: QuadricBAProblem, Kc, xi=None):
    """Bbox residuals [..., QE, 4] (0 where the projection is no ellipse)
    of the current estimate, or of its retraction by the tangents xi
    [..., QE, 15] = [camera(6), quadric(9)], and the ellipse flags [..., QE]."""
    quad = Quadric(prob.quad_pose[prob.qe_quad], prob.quad_scale[prob.qe_quad])
    T = prob.base.poses[prob.qe_cam]
    if xi is not None:
        quad, T = retract(quad, xi[..., 6:]), lie.se3_retract(T, xi[..., :6])
    e, ok = bbox_residual(quad, T, Kc, prob.qe_bbox)
    return e * ok[..., None].to(e.dtype), ok


def _bbox_chi2(prob: QuadricBAProblem, e):
    """Weighted bbox chi2 [QE] and its Huber weight (delta^2 = 100)."""
    chi2 = torch.sum(e * e, dim=-1) * prob.qe_valid * prob.qe_w
    return chi2, torch.where(chi2 < 100.0, 1.0, torch.sqrt(100.0 / torch.clamp(chi2, min=1e-9)))


def _quadric_terms(prob: QuadricBAProblem, Kc):
    """Residuals [QE,4], Jacobians d e / d camera tangent [QE,4,6] and
    d e / d quadric tangent [QE,4,9] (one forward-mode pass over the 15
    unit tangents), Huber-weighted information [QE] and the bbox cost."""
    e, _ = _bbox_errors(prob, Kc)
    J = lie.jacobian_at_zero(lambda xi: _bbox_errors(prob, Kc, xi)[0], 15,
                             torch.zeros(e.shape[:-1] + (15,), dtype=e.dtype, device=e.device))
    chi2, hw = _bbox_chi2(prob, e)
    Jc = J[..., :6] * (1.0 - prob.base.fixed_cam[prob.qe_cam])[:, None, None]
    return e, Jc, J[..., 6:], prob.qe_valid * prob.qe_w * hw, torch.sum(chi2 * hw)


def _quadric_cost(prob: QuadricBAProblem, Kc, huber_delta2: float):
    """Point-edge cost + bbox cost (no Jacobians), and per bbox edge whether
    it projects to an ellipse (True for an edge that is not valid)."""
    e, ok = _bbox_errors(prob, Kc)
    chi2, hw = _bbox_chi2(prob, e)
    return (ba._edge_terms(prob.base, huber_delta2)[5] + torch.sum(chi2 * hw),
            ok | (prob.qe_valid <= 0))


def quadric_ba_solve(prob: QuadricBAProblem, Kc, n_iters: int = 10, cg_iters: int = 40):
    """Joint LM over cameras + points + quadrics. Points are
    Schur-marginalized as in ``ops/ba.py``; the 9-dof quadric blocks join
    the cameras in the reduced block-Jacobi PCG system. Every accept /
    reject is a ``torch.where`` on the device. A step that leaves a bbox
    edge with no ellipse is rejected: that edge's residual would drop to 0,
    so the reference accepts such a step as a descent and the landmark can
    end enclosing its cameras, with no residual to bring it back. Returns
    (prob, final_cost)."""
    base = prob.base
    C, Q = base.poses.shape[0], prob.quad_pose.shape[0]
    dt, dev = base.poses.dtype, base.poses.device
    huber_delta2 = residuals.CHI2_STEREO
    eye6 = torch.eye(6, dtype=dt, device=dev)
    eye9 = torch.eye(9, dtype=dt, device=dev)
    cost, proj = _quadric_cost(prob, Kc, huber_delta2)
    lam = torch.full((), 1e-4, dtype=dt, device=dev)
    for _ in range(n_iters):
        base = prob.base
        Hcc_d, bc, Hpp_inv, bp, Wcp, _ = ba._build_system(base, huber_delta2, lam)
        cp = ba.coupling(base, Wcp, Hpp_inv)
        e_q, Jc_q, Jq_q, w_q, _ = _quadric_terms(prob, Kc)
        JcW = Jc_q * w_q[:, None, None]
        JqW = Jq_q * w_q[:, None, None]
        Hcc_q = ba._seg(torch.einsum("eri,erj->eij", JcW, Jc_q), prob.qe_cam, C)
        Hqq = ba._seg(torch.einsum("eri,erj->eij", JqW, Jq_q), prob.qe_quad, Q)
        bc_q = ba._seg(-torch.einsum("eri,er->ei", JcW, e_q), prob.qe_cam, C)
        bq = ba._seg(-torch.einsum("eri,er->ei", JqW, e_q), prob.qe_quad, Q)
        Hcc_d = Hcc_d + Hcc_q + lam * Hcc_q * eye6
        Hqq_d = Hqq + lam * Hqq * eye9 + 1e-6 * eye9
        g_c = ba._schur_rhs(cp, bp, bc + bc_q)
        Minv_c = torch.linalg.inv_ex(Hcc_d)[0]
        Minv_q = torch.linalg.inv_ex(Hqq_d)[0]

        def matvec(x):
            xc, xq = x[:C * 6].reshape(C, 6), x[C * 6:].reshape(Q, 9)
            # camera block: the point Schur part (quadric-edge Hcc folded
            # into Hcc_d) + the camera-quadric coupling sum_e Jc^T w Jq
            yc = ba._schur_matvec(xc, cp, Hcc_d)
            tq = torch.einsum("erj,ej->er", Jq_q, xq[prob.qe_quad])
            yc = yc + ba._seg(torch.einsum("eri,er->ei", JcW, tq), prob.qe_cam, C)
            yq = torch.einsum("qij,qj->qi", Hqq_d, xq)
            tc = torch.einsum("eri,ei->er", Jc_q, xc[prob.qe_cam])
            yq = yq + ba._seg(torch.einsum("erj,er->ej", JqW, tc), prob.qe_quad, Q)
            return torch.cat([yc.reshape(-1), yq.reshape(-1)])

        def precond(r):
            return torch.cat([
                torch.einsum("cij,cj->ci", Minv_c, r[:C * 6].reshape(C, 6)).reshape(-1),
                torch.einsum("qij,qj->qi", Minv_q, r[C * 6:].reshape(Q, 9)).reshape(-1)])

        r = torch.cat([g_c.reshape(-1), bq.reshape(-1)])
        x = torch.zeros_like(r)
        z = precond(r)
        p = z
        for _ in range(cg_iters):
            Ap = matvec(p)
            rz = torch.sum(r * z)
            alpha = rz / torch.clamp(torch.sum(p * Ap), min=1e-20)
            x = x + alpha * p
            r = r - alpha * Ap
            z2 = precond(r)
            beta = torch.sum(r * z2) / torch.clamp(rz, min=1e-20)
            z, p = z2, z2 + beta * p
        dc = x[:C * 6].reshape(C, 6) * (1.0 - base.fixed_cam)[:, None]
        dq = x[C * 6:].reshape(Q, 9)

        # back-substitute the points
        dp = ba._back_substitute(cp, bp, dc, base.fixed_pnt)
        new_q = retract(Quadric(prob.quad_pose, prob.quad_scale), dq)
        cand = prob._replace(
            base=base._replace(poses=lie.se3_retract(base.poses, dc), points=base.points + dp),
            quad_pose=new_q.pose, quad_scale=new_q.scale)
        new_cost, new_proj = _quadric_cost(cand, Kc, huber_delta2)
        ok = (new_cost < cost) & torch.all(torch.isfinite(x)) & torch.all(new_proj | ~proj)
        prob = prob._replace(
            base=base._replace(poses=torch.where(ok, cand.base.poses, base.poses),
                               points=torch.where(ok, cand.base.points, base.points)),
            quad_pose=torch.where(ok, cand.quad_pose, prob.quad_pose),
            quad_scale=torch.where(ok, cand.quad_scale, prob.quad_scale))
        lam = torch.clamp(torch.where(ok, lam * 0.5, lam * 4.0), 1e-8, 1e8)
        cost = torch.where(ok, new_cost, cost)
        proj = torch.where(ok, new_proj, proj)
    return prob, cost
