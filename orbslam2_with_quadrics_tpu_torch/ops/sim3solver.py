"""Sim3 estimation: Horn closed-form alignment + batched RANSAC + LM polish
(torch).

Counterpart of the reference's ``ops/sim3solver.py``:

- Horn 1987 absolute orientation on 3-point minimal sets, quaternion from
  the max eigenvector of the 4x4 N matrix, optional fixed scale for
  stereo / RGB-D.
- RANSAC is one batch of hypotheses scored by two-view reprojection.
- The polish stage is a Levenberg-Marquardt solve of the 7-dof Sim3 with
  forward + inverse projection residuals.
"""

from __future__ import annotations

import math

import torch

from . import camera, lie
from .orb import topk_stable

CHI2_2D = 9.210  # inlier gate on each image's normalized reprojection error


def horn_sim3(p1, p2, w=None, fix_scale: bool = False):
    """Closed-form Sim3 aligning p1 -> p2 ([..,N,3] each, optional weights):
    returns S such that p2 ~ S(p1) = s R p1 + t."""
    if w is None:
        w = torch.ones(p1.shape[:-1], dtype=p1.dtype, device=p1.device)
    wn = w / torch.clamp(torch.sum(w, dim=-1, keepdim=True), min=1e-9)
    c1 = torch.sum(p1 * wn[..., None], dim=-2)
    c2 = torch.sum(p2 * wn[..., None], dim=-2)
    x1 = p1 - c1[..., None, :]
    x2 = p2 - c2[..., None, :]
    # Horn's correlation matrix S_ab = sum w x1_a x2_b (order matters: the
    # max-eigenvector quaternion then rotates frame-1 vectors into frame 2)
    M = torch.einsum("...n,...ni,...nj->...ij", wn, x1, x2)
    Sxx, Sxy, Sxz = M[..., 0, 0], M[..., 0, 1], M[..., 0, 2]
    Syx, Syy, Syz = M[..., 1, 0], M[..., 1, 1], M[..., 1, 2]
    Szx, Szy, Szz = M[..., 2, 0], M[..., 2, 1], M[..., 2, 2]
    N = torch.stack(
        [
            torch.stack([Sxx + Syy + Szz, Syz - Szy, Szx - Sxz, Sxy - Syx], -1),
            torch.stack([Syz - Szy, Sxx - Syy - Szz, Sxy + Syx, Szx + Sxz], -1),
            torch.stack([Szx - Sxz, Sxy + Syx, -Sxx + Syy - Szz, Syz + Szy], -1),
            torch.stack([Sxy - Syx, Szx + Sxz, Syz + Szy, -Sxx - Syy + Szz], -1),
        ],
        dim=-2,
    )
    # eigh raises on a non-finite matrix (a degenerate hypothesis upstream):
    # such a problem gets the identity here and a NaN rotation below, so
    # that it loses every later comparison instead of stopping the batch
    finite = torch.all(torch.isfinite(N.flatten(-2)), dim=-1)
    N = torch.where(finite[..., None, None], N, torch.eye(4, dtype=N.dtype, device=N.device))
    _, evecs = torch.linalg.eigh(N)
    q = evecs[..., :, -1]  # max-eigenvalue eigenvector = [w,x,y,z]
    q = torch.where(finite[..., None], q, torch.full_like(q, float("nan")))
    # the eigenvector's sign is free: fix it by w >= 0
    q = lie.quat_normalize(q * torch.where(q[..., :1] < 0, -1.0, 1.0))
    # scale: s = sum w <x2, R x1> / sum w |x1|^2  (asymmetric Horn scale)
    Rx1 = lie.quat_rotate(q[..., None, :], x1)
    num = torch.sum(wn * torch.sum(x2 * Rx1, dim=-1), dim=-1)
    den = torch.sum(wn * torch.sum(x1 * x1, dim=-1), dim=-1)
    s = torch.ones_like(num) if fix_scale else num / torch.clamp(den, min=1e-12)
    t = c2 - s[..., None] * lie.quat_rotate(q, c1)
    return torch.cat([q, t, s[..., None]], dim=-1)


def sample_minimal_sets(valid, n_hyp: int, size: int,
                        generator: torch.Generator | None = None):
    """[n_hyp, size] indices: ``size`` distinct valid entries per set (Gumbel
    top-k over uniform draws from ``generator``)."""
    u = torch.rand((n_hyp, valid.shape[0]), generator=generator,
                   device=valid.device if generator is None else generator.device)
    u = u.to(valid.device)
    gumbel = -torch.log(-torch.log(u * (1.0 - 1e-9) + 1e-9))
    return topk_stable(torch.where(valid[None, :], gumbel, -math.inf), size)[1]


def _reproj_errors(S12, p1, p2, K1, K2, uv1, uv2):
    """Squared pixel errors of p2 through S21 in image 1 and p1 through S12
    in image 2; S12 [..,8] broadcasts against the [M,3] points."""
    S12 = S12[..., None, :]
    q1, _ = camera.project(K1, lie.sim3_apply(lie.sim3_inverse(S12), p2))
    q2, _ = camera.project(K2, lie.sim3_apply(S12, p1))
    return torch.sum((q1 - uv1) ** 2, dim=-1), torch.sum((q2 - uv2) ** 2, dim=-1)


def ransac_sim3(p1, p2, valid, K1, K2, uv1, uv2, sigma2_1, sigma2_2,
                sel=None, generator: torch.Generator | None = None,
                n_hyp: int = 128, fix_scale: bool = False):
    """RANSAC Sim3 from 3D-3D correspondences, scored by reprojection in
    both images.

    p1/p2: [M,3] matched map points in camera frames 1/2.
    uv1/uv2: [M,2] their observed pixels; sigma2_*: per-obs variances.
    sel: optional [n_hyp, 3] minimal sets (default: drawn from ``generator``).
    Returns (S12 [8], inlier_mask [M], n_inliers).
    """
    if sel is None:
        sel = sample_minimal_sets(valid, n_hyp, 3, generator)
    sel = sel.to(device=p1.device, dtype=torch.int64)
    S_all = horn_sim3(p1[sel], p2[sel], fix_scale=fix_scale)  # [H,8]

    def score(S12):
        e1, e2 = _reproj_errors(S12, p1, p2, K1, K2, uv1, uv2)
        inl = ((e1 / torch.clamp(sigma2_1, min=1e-9) < CHI2_2D)
               & (e2 / torch.clamp(sigma2_2, min=1e-9) < CHI2_2D) & valid)
        return torch.sum(inl, dim=-1, dtype=torch.int32), inl

    n_inl, inls = score(S_all)
    best = torch.argmax(n_inl)
    # refit on inliers
    S_ref = horn_sim3(p1, p2, w=inls[best].to(p1.dtype), fix_scale=fix_scale)
    n_ref, inl_ref = score(S_ref)
    better = n_ref >= n_inl[best]
    return (torch.where(better, S_ref, S_all[best]),
            torch.where(better, inl_ref, inls[best]),
            torch.maximum(n_ref, n_inl[best]))


def optimize_sim3(S12, p1, p2, valid, K1, K2, uv1, uv2, inv_sigma2_1, inv_sigma2_2,
                  iters: int = 10, fix_scale: bool = False):
    """LM polish of a Sim3 with paired forward / inverse projection residuals
    (Huber at chi2 = 10). Returns (S12, inlier_mask, n_inliers)."""
    dtype, dev = p1.dtype, p1.device
    sq1 = torch.sqrt(inv_sigma2_1)[:, None]
    sq2 = torch.sqrt(inv_sigma2_2)[:, None]

    def residuals_fn(S):
        """[.., 2M, 2] for S [.., 8]."""
        S = S[..., None, :]
        q1, _ = camera.project(K1, lie.sim3_apply(lie.sim3_inverse(S), p2))
        q2, _ = camera.project(K2, lie.sim3_apply(S, p1))
        return torch.cat([(uv1 - q1) * sq1, (uv2 - q2) * sq2], dim=-2)

    w_rows = torch.cat([valid, valid]).to(dtype)

    def cost_of(S):
        r = residuals_fn(S)
        chi2 = torch.sum(r * r, dim=-1)
        hw = torch.where(chi2 < 10.0, 1.0, torch.sqrt(10.0 / torch.clamp(chi2, min=1e-12)))
        return torch.sum(chi2 * torch.clamp(hw, max=1.0) * w_rows), hw

    eye = torch.eye(7, dtype=dtype, device=dev)
    S, lam = S12, torch.as_tensor(1e-4, dtype=dtype, device=dev)
    cost, _ = cost_of(S)
    for _ in range(iters):
        J = lie.jacobian_at_zero(
            lambda xi: residuals_fn(lie.sim3_retract(S, xi)).flatten(-2), 7, S)
        r = residuals_fn(S).reshape(-1)
        _, hw = cost_of(S)
        wf = torch.repeat_interleave(w_rows * hw, 2)
        H = J.T @ (J * wf[:, None])
        g = -J.T @ (r * wf)
        if fix_scale:
            H = H.clone()
            H[6, :] = 0.0
            H[:, 6] = 0.0
            H[6, 6] = 1.0
            g = g.clone()
            g[6] = 0.0
        Hd = H + lam * torch.diag(torch.diag(H)) + 1e-8 * eye
        # a singular or non-finite system gives NaN, as XLA's solve does
        # (``linalg.solve`` raises on the card), and the step is rejected
        dx, info = torch.linalg.solve_ex(Hd, g)
        dx = torch.where(info == 0, dx, torch.full_like(dx, float("nan")))
        S_new = lie.sim3_retract(S, dx)
        new_cost, _ = cost_of(S_new)
        ok = (new_cost < cost) & torch.all(torch.isfinite(dx))
        S = torch.where(ok, S_new, S)
        lam = torch.clamp(torch.where(ok, lam * 0.5, lam * 4.0), 1e-8, 1e6)
        cost = torch.where(ok, new_cost, cost)
    # final inliers at chi2 < 9.210
    e1, e2 = _reproj_errors(S, p1, p2, K1, K2, uv1, uv2)
    inl = (e1 * inv_sigma2_1 < CHI2_2D) & (e2 * inv_sigma2_2 < CHI2_2D) & valid
    return S, inl, torch.sum(inl, dtype=torch.int32)
