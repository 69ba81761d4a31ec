"""Sim3 pose-graph (essential graph) optimization (torch).

Counterpart of the reference's ``ops/pose_graph.py::optimize_pose_graph``:
keyframe poses are lifted to Sim3, relative-pose edges (spanning tree, loop
edges, strong covisibility) are optimized with Levenberg-Marquardt. Edge
residual: ``e = log(S_ji * S_iw * S_wj)`` with measurement ``S_ji`` frozen
at its pre-loop value; Jacobians come from forward-mode differentiation of
the retraction at ``xi = 0`` (``lie.jacobian_at_zero``).

The normal equations are solved matrix-free: ``H x`` is two edge sweeps
(gather endpoint blocks, per-edge 7x7 products, summed back by endpoint),
preconditioned CG with the block-diagonal [K,7,7] inverse. Memory is
O(K*49 + E*98).
"""

from __future__ import annotations

import torch

from . import lie


def edge_residual(S_i, S_j, S_meas_ji):
    """e = log( S_meas_ji * S_i * S_j^-1 )  [..,7]."""
    err = lie.sim3_compose(
        S_meas_ji, lie.sim3_compose(S_i, lie.sim3_inverse(S_j))
    )
    return lie.sim3_log(err)


def _segment_sum(src, index, n: int):
    return torch.zeros((n,) + tuple(src.shape[1:]), dtype=src.dtype,
                       device=src.device).index_add(0, index, src)


def _edge_terms(Sp, edge_i, edge_j, S_meas_ji, edge_w, fixed):
    """Per-edge residuals + endpoint Jacobians, gauge-masked."""
    Si, Sj = Sp[edge_i], Sp[edge_j]
    r = edge_residual(Si, Sj, S_meas_ji)
    # both endpoints' retractions in one forward-mode pass of 14 tangents
    J = lie.jacobian_at_zero(
        lambda x: edge_residual(lie.sim3_retract(Si, x[..., :7]),
                                lie.sim3_retract(Sj, x[..., 7:]), S_meas_ji),
        14, Si)
    Ji = J[..., :7] * (1.0 - fixed[edge_i])[:, None, None]
    Jj = J[..., 7:] * (1.0 - fixed[edge_j])[:, None, None]
    cost = torch.sum(torch.sum(r * r, dim=-1) * edge_w)
    return r, Ji, Jj, cost


def _graph_cost(Sp, edge_i, edge_j, S_meas_ji, edge_w):
    r = edge_residual(Sp[edge_i], Sp[edge_j], S_meas_ji)
    return torch.sum(torch.sum(r * r, dim=-1) * edge_w)


def _hess_matvec(x, Ji, Jj, edge_i, edge_j, edge_w, D_lam_only, K):
    """(H + lam*diag(H) + fix) x via edge sweeps; the lam / fix part is
    applied through the precomputed block-diagonal difference."""
    u = torch.einsum("eri,ei->er", Ji, x[edge_i]) + torch.einsum(
        "eri,ei->er", Jj, x[edge_j]
    )  # [E,7] J x in residual space
    wu = u * edge_w[:, None]
    y = _segment_sum(torch.einsum("eri,er->ei", Ji, wu), edge_i, K)
    y = y + _segment_sum(torch.einsum("eri,er->ei", Jj, wu), edge_j, K)
    return y + torch.einsum("kij,kj->ki", D_lam_only, x)


def _safe(d):
    return torch.where(torch.abs(d) < 1e-20, 1e-20, d)


def _pcg(b, matvec, Minv, iters: int):
    """Block-Jacobi preconditioned CG on [K,7] unknowns."""
    x = torch.zeros_like(b)
    r = b
    z = torch.einsum("kij,kj->ki", Minv, r)
    p = z
    for _ in range(iters):
        Ap = matvec(p)
        rz = torch.sum(r * z)
        alpha = rz / _safe(torch.sum(p * Ap))
        x = x + alpha * p
        r = r - alpha * Ap
        z = torch.einsum("kij,kj->ki", Minv, r)
        p = z + (torch.sum(r * z) / _safe(rz)) * p
    return x


def optimize_pose_graph(S_poses, edge_i, edge_j, S_meas_ji, edge_w, fixed,
                        iters: int = 20, cg_iters: int = 60):
    """Optimize Sim3 keyframe poses over relative-pose edges.

    Args:
      S_poses: [K,8] Sim3 world->keyframe.
      edge_i/edge_j: [E] int64 endpoints.
      S_meas_ji: [E,8] measured S_j->S_i relative Sim3 (S_i * S_j^-1).
      edge_w: [E] weights (0 = padding).
      fixed: [K] 1.0 where the pose is held (the loop-origin keyframe).
      iters: LM iterations.
      cg_iters: preconditioned-CG iterations per LM step.

    Returns optimized [K,8] poses.
    """
    K = S_poses.shape[0]
    edge_i = edge_i.to(torch.int64)
    edge_j = edge_j.to(torch.int64)
    eye = torch.eye(7, dtype=S_poses.dtype, device=S_poses.device)
    Sp = S_poses
    lam = torch.as_tensor(1e-6, dtype=S_poses.dtype, device=S_poses.device)
    cost = _graph_cost(Sp, edge_i, edge_j, S_meas_ji, edge_w)
    for _ in range(iters):
        r, Ji, Jj, _ = _edge_terms(Sp, edge_i, edge_j, S_meas_ji, edge_w, fixed)
        wr = r * edge_w[:, None]
        b = -_segment_sum(torch.einsum("eri,er->ei", Ji, wr), edge_i, K)
        b = b - _segment_sum(torch.einsum("eri,er->ei", Jj, wr), edge_j, K)
        # undamped block diagonal, then the damped / fixed version; their
        # difference is exactly the lam*diag + identity-row term the
        # matrix-free matvec must add on top of the pure J^T J sweeps
        Hblk = _segment_sum(torch.einsum("e,eri,erj->eij", edge_w, Ji, Ji), edge_i, K)
        Hblk = Hblk + _segment_sum(torch.einsum("e,eri,erj->eij", edge_w, Jj, Jj), edge_j, K)
        deg = torch.abs(torch.einsum("kii->k", Hblk))
        D = Hblk + lam * Hblk * eye + torch.where(
            (deg < 1e-12) | (fixed > 0.5), 1.0, 1e-8
        )[:, None, None] * eye
        D_extra = D - Hblk
        Minv = torch.linalg.inv(D)

        dx = _pcg(
            b, lambda x: _hess_matvec(x, Ji, Jj, edge_i, edge_j, edge_w, D_extra, K),
            Minv, cg_iters,
        )
        dx = dx * (1.0 - fixed)[:, None]
        S_new = lie.sim3_retract(Sp, dx)
        new_cost = _graph_cost(S_new, edge_i, edge_j, S_meas_ji, edge_w)
        ok = (new_cost < cost) & torch.all(torch.isfinite(dx))
        Sp = torch.where(ok, S_new, Sp)
        lam = torch.clamp(torch.where(ok, lam * 0.5, lam * 4.0), 1e-10, 1e6)
        cost = torch.where(ok, new_cost, cost)
    return Sp
