"""Perspective-n-Point RANSAC for relocalization (torch).

Counterpart of the reference's ``ops/pnp.py``: a batch of EPnP 4-point
minimal-set hypotheses scored in parallel, followed by an EPnP refit on the
inlier set; a fixed hypothesis count instead of an adaptive early exit.

EPnP (Lepetit et al.): 4 control points (centroid + PCA axes), barycentric
coordinates, the null space of the 2n x 12 projection system, beta cases
1-3 seeded from the inter-control-point distance constraints and polished
by Gauss-Newton, then closed-form Horn alignment world->camera. Every stage
has fixed shapes and runs over a leading batch of problems.
"""

from __future__ import annotations

import math

import torch

from . import camera, lie
from .sim3solver import horn_sim3, sample_minimal_sets

_PAIRS = ((0, 1), (0, 2), (0, 3), (1, 2), (1, 3), (2, 3))
_FLIPS = (  # sign variants of the three beta seeds: 1 + 2 + 4 candidates
    (1.0, 1.0, 1.0, 1.0),
    (1.0, 1.0, 1.0, 1.0), (1.0, -1.0, 1.0, 1.0),
    (1.0, 1.0, 1.0, 1.0), (1.0, -1.0, 1.0, 1.0), (1.0, 1.0, -1.0, 1.0), (1.0, -1.0, -1.0, 1.0),
)


def _solve(A, B):
    """``linalg.solve`` that does not raise (nor read back) on a singular
    system: a degenerate minimal set gives a non-finite or wild hypothesis,
    which then loses on reprojection error."""
    return torch.linalg.solve_ex(A, B)[0]


def _ls(Lcols, rho):
    """Least squares for the quadratic beta products; Lcols [B,6,k]."""
    k = Lcols.shape[-1]
    Lt = Lcols.transpose(-1, -2)
    H = Lt @ Lcols + 1e-9 * torch.eye(k, dtype=Lcols.dtype, device=Lcols.device)
    return _solve(H, Lt @ rho[..., None])[..., 0]


def _epnp_batch(pw, uv, Kc, w, gn_iters: int):
    """EPnP over a batch: pw [B,n,3], uv [B,n,2], w [B,n] -> T_cw [B,7]."""
    B, n = pw.shape[:2]
    dtype, dev = pw.dtype, pw.device
    wn = w / torch.clamp(torch.sum(w, dim=-1, keepdim=True), min=1e-9)

    # --- control points: weighted centroid + principal axes -------------
    c0 = torch.sum(pw * wn[..., None], dim=1)                   # [B,3]
    Pc = pw - c0[:, None]
    Cov = torch.einsum("bn,bni,bnj->bij", wn, Pc, Pc)
    ev, evec = torch.linalg.eigh(Cov)
    sd = torch.sqrt(torch.clamp(ev, min=1e-10))
    # bound the control-simplex conditioning: a near-coplanar point set
    # collapses one axis, making the barycentric solve singular
    sd = torch.maximum(sd, 1e-3 * sd[:, -1:])
    A = evec * sd[:, None, :]          # columns = control offsets c_k - c0
    cw = torch.cat([c0[:, None], c0[:, None] + A.transpose(1, 2)], dim=1)  # [B,4,3]

    # --- barycentric coordinates: p - c0 = A @ alpha_{1:4} --------------
    a123 = _solve(A, Pc.transpose(1, 2)).transpose(1, 2)            # [B,n,3]
    alpha = torch.cat([1.0 - torch.sum(a123, dim=2, keepdim=True), a123], dim=2)

    # --- null space of the projection system ----------------------------
    fx, fy, cx, cy = Kc[0], Kc[1], Kc[2], Kc[3]
    du = cx - uv[..., 0]
    dv = cy - uv[..., 1]
    zeros = torch.zeros_like(alpha)
    Mu = torch.stack([alpha * fx, zeros, alpha * du[..., None]], dim=-1).reshape(B, n, 12)
    Mv = torch.stack([zeros, alpha * fy, alpha * dv[..., None]], dim=-1).reshape(B, n, 12)
    sw = torch.sqrt(torch.clamp(w, min=0.0))[..., None]
    M = torch.cat([Mu * sw, Mv * sw], dim=1)                    # [B,2n,12]
    _, V = torch.linalg.eigh(M.transpose(1, 2) @ M)
    # [null_k, ctrl, 3], k=0 = smallest; signs and near-equal bases are free,
    # which the cheirality flip and the seed sweep below absorb
    vs = V[:, :, :4].transpose(1, 2).reshape(B, 4, 4, 3)

    # --- inter-control distance constraints -----------------------------
    pi = torch.as_tensor([p[0] for p in _PAIRS], device=dev)
    pj = torch.as_tensor([p[1] for p in _PAIRS], device=dev)
    rho = torch.sum((cw[:, pi] - cw[:, pj]) ** 2, dim=-1)       # [B,6]
    dvs = vs[:, :, pi, :] - vs[:, :, pj, :]                     # [B,4,6,3]
    lij = torch.einsum("bkpc,blpc->bpkl", dvs, dvs)             # [B,6,4,4]

    l11, l22, l33 = lij[..., 0, 0], lij[..., 1, 1], lij[..., 2, 2]
    l12, l13, l23 = lij[..., 0, 1], lij[..., 0, 2], lij[..., 1, 2]
    zero = torch.zeros((B,), dtype=dtype, device=dev)
    b1_sq = torch.sum(rho * l11, dim=-1) / torch.clamp(torch.sum(l11 * l11, dim=-1), min=1e-12)
    seed1 = torch.stack([torch.sqrt(torch.clamp(b1_sq, min=0.0)), zero, zero, zero], dim=-1)

    B2 = _ls(torch.stack([l11, 2 * l12, l22], dim=-1), rho)  # (b11, b12, b22)
    s2 = torch.where(B2[:, 0] < 0, -1.0, 1.0)  # flip if b11 came out negative
    be1 = torch.sqrt(torch.clamp(s2 * B2[:, 0], min=0.0))
    be2 = torch.sqrt(torch.clamp(s2 * B2[:, 2], min=0.0)) * torch.sign(s2 * B2[:, 1] + 1e-30)
    seed2 = torch.stack([be1, be2, zero, zero], dim=-1)

    B3 = _ls(torch.stack([l11, 2 * l12, l22, 2 * l13, 2 * l23, l33], dim=-1), rho)
    s3 = torch.where(B3[:, 0] < 0, -1.0, 1.0)
    b3_1 = torch.sqrt(torch.clamp(s3 * B3[:, 0], min=0.0))
    b3_2 = torch.sqrt(torch.clamp(s3 * B3[:, 2], min=0.0)) * torch.sign(s3 * B3[:, 1] + 1e-30)
    b3_3 = torch.sqrt(torch.clamp(s3 * B3[:, 5], min=0.0)) * torch.sign(s3 * B3[:, 3] + 1e-30)
    seed3 = torch.stack([b3_1, b3_2, b3_3, zero], dim=-1)

    # sign ambiguity: only products beta_a beta_b are observed, so the
    # relative signs of the seeds are undetermined: run Gauss-Newton from
    # every sign variant and keep the best reprojection
    seeds = torch.stack([seed1, seed2, seed2, seed3, seed3, seed3, seed3], dim=1)
    beta = seeds * torch.as_tensor(_FLIPS, dtype=dtype, device=dev)  # [B,7,4]

    eye4 = 1e-9 * torch.eye(4, dtype=dtype, device=dev)
    for _ in range(gn_iters):
        dcam = torch.einsum("bsk,bkpc->bspc", beta, dvs)           # [B,7,6,3]
        f = torch.sum(dcam * dcam, dim=-1) - rho[:, None]          # [B,7,6]
        J = 2.0 * torch.einsum("bspc,bkpc->bspk", dcam, dvs)       # [B,7,6,4]
        Jt = J.transpose(-1, -2)
        beta = beta + _solve(Jt @ J + eye4, -(Jt @ f[..., None]))[..., 0]

    ccam = torch.einsum("bsk,bkij->bsij", beta, vs)                # [B,7,4,3]
    pc = torch.einsum("bnk,bskj->bsnj", alpha, ccam)               # [B,7,n,3]
    # cheirality: the null vector's global sign is free
    flip = torch.where(torch.sum(wn[:, None] * pc[..., 2], dim=-1) < 0, -1.0, 1.0)
    pc = pc * flip[..., None, None]
    pw7 = pw[:, None].expand(B, 7, n, 3)
    S = horn_sim3(pw7, pc, w=w[:, None].expand(B, 7, n), fix_scale=True)
    Ts = S[..., :7]
    uvp, _ = camera.project(Kc, lie.se3_apply(Ts[:, :, None], pw7))
    errs = torch.sum(w[:, None] * torch.sum((uvp - uv[:, None]) ** 2, dim=-1), dim=-1)
    # degenerate sets can still produce non-finite poses; they must lose
    # the argmin (and never leak NaN into a downstream refit / LM)
    finite = torch.all(torch.isfinite(Ts), dim=-1) & torch.isfinite(errs)
    best = torch.argmin(torch.where(finite, errs, math.inf), dim=-1)
    rows = torch.arange(B, device=dev)
    ident = lie.se3_identity((B,), dtype=dtype, device=dev)
    return torch.where(finite[rows, best][:, None], Ts[rows, best], ident)


def epnp_pose(pw, uv, Kc, w=None, gn_iters: int = 10):
    """EPnP pose from n>=4 2D-3D correspondences (optionally weighted).

    Args:
      pw: [n,3] world points; uv: [n,2] pixels; Kc: [4] intrinsics.
      w: [n] optional weights (0/1 inlier mask for the refit stage).
    A leading batch axis on pw / uv / w solves B problems at once.
    Returns: T_cw [7] (or [B,7]).
    """
    if w is None:
        w = torch.ones(pw.shape[:-1], dtype=pw.dtype, device=pw.device)
    if pw.dim() == 2:
        return _epnp_batch(pw[None], uv[None], Kc, w[None], gn_iters)[0]
    return _epnp_batch(pw, uv, Kc, w, gn_iters)


def ransac_pnp(pw, uv, valid, Kc, inv_sigma2, sel=None,
               generator: torch.Generator | None = None,
               n_hyp: int = 256, chi2_th: float = 5.991):
    """RANSAC pose from 2D-3D matches (minimal sets of 4 through EPnP, a
    fixed hypothesis count). ``sel``: optional [n_hyp, 4] minimal sets
    (default: drawn from ``generator``).

    Returns (T_cw [7], inliers [N] bool, n_inliers).
    """
    if sel is None:
        sel = sample_minimal_sets(valid, n_hyp, 4, generator)
    sel = sel.to(device=pw.device, dtype=torch.int64)
    T_all = epnp_pose(pw[sel], uv[sel], Kc)

    def score(T):
        uvp, z = camera.project(Kc, lie.se3_apply(T[..., None, :], pw))
        e2 = torch.sum((uvp - uv) ** 2, dim=-1) * inv_sigma2
        inl = (e2 < chi2_th) & (z > 0.05) & valid
        return torch.sum(inl, dim=-1, dtype=torch.int32), inl

    n_inl, inls = score(T_all)
    best = torch.argmax(n_inl)
    # refit on inliers
    T_ref = epnp_pose(pw, uv, Kc, w=inls[best].to(pw.dtype))
    n_ref, inl_ref = score(T_ref)
    better = n_ref >= n_inl[best]
    return (torch.where(better, T_ref, T_all[best]),
            torch.where(better, inl_ref, inls[best]),
            torch.maximum(n_ref, n_inl[best]))
