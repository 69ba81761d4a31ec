"""Two-view monocular initialization: batched H/F RANSAC + reconstruction.

Counterpart of the reference's ``ops/init2view.py`` (ORB-SLAM2's
Initializer): 200 eight-point hypothesis sets scored as one batch for both
a homography and a fundamental matrix (Hartley-normalized DLT, symmetric
transfer / epipolar scoring with gates 5.991 / 3.841), one weighted refit
on the winners' inliers, model selection SH/(SH+SF) > 0.40, then
F -> E -> 4 motions or Faugeras' 8-motion homography decomposition, all
scored by one batched cheirality + parallax check.

Sampling: the hypothesis sets come from an explicit ``torch.Generator``
(Gumbel top-k, 8 distinct valid matches per set), or are passed in as
``sel`` so that a test can score exactly the reference's sets.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from . import camera, lie
from .orb import topk_stable

N_HYP = 200
CHI2_H = 5.991
CHI2_F = 3.841
SCORE_TH = 5.991


class InitResult(NamedTuple):
    ok: torch.Tensor          # scalar bool
    T_21: torch.Tensor        # [7] pose of frame2 wrt frame1 (world=frame1)
    points: torch.Tensor      # [M,3] triangulated in frame1
    good: torch.Tensor        # [M] bool triangulation validity
    used_h: torch.Tensor      # scalar bool (homography branch taken)


def _normalize(uv, valid):
    """Hartley normalization over valid points -> (normalized uv, T [3,3])."""
    w = valid.to(uv.dtype)
    n = torch.clamp(torch.sum(w), min=1.0)
    mean = torch.sum(uv * w[:, None], dim=0) / n
    d = torch.abs(uv - mean) * w[:, None]
    s = 1.0 / torch.clamp(torch.sum(d, dim=0) / n, min=1e-6)
    uvn = (uv - mean) * s
    zero = torch.zeros((), dtype=uv.dtype, device=uv.device)
    one = torch.ones((), dtype=uv.dtype, device=uv.device)
    T = torch.stack([
        torch.stack([s[0], zero, -mean[0] * s[0]]),
        torch.stack([zero, s[1], -mean[1] * s[1]]),
        torch.stack([zero, zero, one]),
    ])
    return uvn, T


def _null_vector(A):
    """Right singular vector of the smallest singular value, [..., 9]."""
    return torch.linalg.svd(A, full_matrices=False)[2][..., -1, :]


def _solve_h(uv1, uv2, w=None):
    """DLT homography x2 ~ H x1 over [..., M, 2] points, optional row
    weights [..., M]."""
    x, y = uv1[..., 0], uv1[..., 1]
    u, v = uv2[..., 0], uv2[..., 1]
    z = torch.zeros_like(x)
    o = torch.ones_like(x)
    r1 = torch.stack([z, z, z, -x, -y, -o, v * x, v * y, v], dim=-1)
    r2 = torch.stack([x, y, o, z, z, z, -u * x, -u * y, -u], dim=-1)
    A = torch.cat([r1, r2], dim=-2)
    if w is not None:
        A = A * torch.cat([w, w], dim=-1)[..., None]
    return _null_vector(A).reshape(A.shape[:-2] + (3, 3))


def _solve_f(uv1, uv2, w=None):
    """8-point fundamental with rank-2 projection, optional row weights."""
    x, y = uv1[..., 0], uv1[..., 1]
    u, v = uv2[..., 0], uv2[..., 1]
    o = torch.ones_like(x)
    A = torch.stack([u * x, u * y, u, v * x, v * y, v, x, y, o], dim=-1)
    if w is not None:
        A = A * w[..., None]
    F = _null_vector(A).reshape(A.shape[:-2] + (3, 3))
    uS, sS, vtS = torch.linalg.svd(F)
    sS = torch.cat([sS[..., :2], torch.zeros_like(sS[..., 2:])], dim=-1)
    return uS @ torch.diag_embed(sS) @ vtS


def _homog(a):
    return torch.cat([a, torch.ones_like(a[..., :1])], dim=-1)


def _score_h(H21, uv1, uv2, valid, sigma2: float = 1.0):
    """Symmetric transfer score; H21 [..., 3, 3] over M points.
    Returns (score [...], inliers [..., M])."""
    H12 = torch.linalg.inv(H21)

    def transfer(H, a, b):
        p = _homog(a) @ H.transpose(-1, -2)
        w = torch.where(torch.abs(p[..., 2:3]) < 1e-8, 1e-8, p[..., 2:3])
        return torch.sum((b - p[..., :2] / w) ** 2, dim=-1) / sigma2

    c1 = transfer(H12, uv2, uv1)
    c2 = transfer(H21, uv1, uv2)
    inl = (c1 < CHI2_H) & (c2 < CHI2_H) & valid
    score = torch.sum(torch.where(inl, (SCORE_TH - c1) + (SCORE_TH - c2), 0.0), dim=-1)
    return score, inl


def _score_f(F21, uv1, uv2, valid, sigma2: float = 1.0):
    """Epipolar-distance score both ways."""
    def epi(l, p):
        num = torch.sum(l[..., :2] * p, dim=-1) + l[..., 2]
        den = torch.sum(l[..., :2] ** 2, dim=-1)
        return num * num / torch.clamp(den, min=1e-12) / sigma2

    l2 = _homog(uv1) @ F21.transpose(-1, -2)  # lines in image 2
    l1 = _homog(uv2) @ F21                    # lines in image 1
    c2 = epi(l2, uv2)
    c1 = epi(l1, uv1)
    inl = (c1 < CHI2_F) & (c2 < CHI2_F) & valid
    score = torch.sum(torch.where(inl, (SCORE_TH - c1) + (SCORE_TH - c2), 0.0), dim=-1)
    return score, inl


def _check_rt(Rs, ts, K, uv1, uv2, valid, sigma2: float = 1.0):
    """Triangulate all matches for each candidate (R, t) in [C,3,3]/[C,3];
    count cheirality + reprojection + parallax survivors.
    Returns (n_good [C], good [C,M], parallax_cos [C], points [C,M,3])."""
    C = Rs.shape[0]
    T1 = lie.se3_identity(dtype=uv1.dtype, device=uv1.device)
    T2 = lie.se3_make(lie.matrix_to_quat(Rs), ts)                   # [C,7]
    P1 = camera.projection_matrix(T1, K)                             # [3,4]
    P2 = camera.projection_matrix(T2, K[None].expand(C, 4))          # [C,3,4]
    X = camera.triangulate_dlt(P1, P2[:, None], uv1[None], uv2[None])  # [C,M,3]
    z1 = X[..., 2]
    pc2 = lie.se3_apply(T2[:, None, :], X)
    z2 = pc2[..., 2]

    c2 = -torch.einsum("cji,cj->ci", Rs, ts)                         # -R^T t
    r1 = X
    r2 = X - c2[:, None, :]
    cosp = torch.sum(r1 * r2, dim=-1) / torch.clamp(
        torch.linalg.norm(r1, dim=-1) * torch.linalg.norm(r2, dim=-1), min=1e-12
    )
    uv1p, _ = camera.project(K, X)
    uv2p, _ = camera.project(K, pc2)
    e1 = torch.sum((uv1p - uv1) ** 2, dim=-1) / sigma2
    e2 = torch.sum((uv2p - uv2) ** 2, dim=-1) / sigma2
    good = (valid & (z1 > 0) & (z2 > 0) & (cosp < 0.99998)
            & (e1 < 4.0 * CHI2_H) & (e2 < 4.0 * CHI2_H)
            & torch.all(torch.isfinite(X), dim=-1))
    n_good = torch.sum(good.to(torch.int32), dim=-1)
    # large-parallax proxy: the 50th-best cos (lower = better)
    k = torch.clamp(torch.clamp(n_good, min=1), max=50) - 1
    cs = torch.sort(torch.where(good, cosp, 2.0), dim=-1).values
    parallax_cos = torch.gather(cs, 1, k[:, None].to(torch.int64))[:, 0]
    return n_good, good, parallax_cos, X


def _kmat(K):
    fx, fy, cx, cy = K[0], K[1], K[2], K[3]
    zero, one = torch.zeros_like(fx), torch.ones_like(fx)
    return torch.stack([
        torch.stack([fx, zero, cx]), torch.stack([zero, fy, cy]),
        torch.stack([zero, zero, one]),
    ])


def _reconstruct_f(F21, K, uv1, uv2, inliers):
    """E = K^T F K; 4 candidate (R,t); pick by the batched check."""
    Km = _kmat(K)
    E = Km.T @ F21 @ Km
    U, _, Vt = torch.linalg.svd(E)
    W = torch.tensor([[0.0, -1.0, 0.0], [1.0, 0.0, 0.0], [0.0, 0.0, 1.0]],
                     dtype=E.dtype).to(E.device)

    def fix_det(R):
        return R * torch.sign(torch.linalg.det(R))

    R1 = fix_det(U @ W @ Vt)
    R2 = fix_det(U @ W.T @ Vt)
    t = U[:, 2]
    t = t / torch.clamp(torch.linalg.norm(t), min=1e-12)
    Rs = torch.stack([R1, R1, R2, R2])
    ts = torch.stack([t, -t, t, -t])
    n_good, good, pcos, X = _check_rt(Rs, ts, K, uv1, uv2, inliers)
    best = torch.argmax(n_good)
    n_best = n_good[best]
    n_sorted = torch.sort(n_good).values
    n_total = torch.clamp(torch.sum(inliers.to(torch.int32)), min=1)
    ok = ((n_best.to(torch.float32) > 0.75 * n_total.to(torch.float32))
          & (n_sorted[2] < 0.7 * n_best)
          & (pcos[best] < math.cos(math.radians(1.0))))
    return ok, Rs[best], ts[best], good[best], X[best]


def _reconstruct_h(H21, K, uv1, uv2, inliers):
    """Faugeras SVD decomposition -> 8 motions -> batched check."""
    Km = _kmat(K)
    A = torch.linalg.inv(Km) @ H21 @ Km
    U, s, Vt = torch.linalg.svd(A)
    d1, d2, d3 = s[0], s[1], s[2]
    detUV = torch.linalg.det(U) * torch.linalg.det(Vt)

    denom = torch.clamp(d1 * d1 - d3 * d3, min=1e-12)
    aux1 = torch.sqrt(torch.clamp((d1 * d1 - d2 * d2) / denom, min=0.0))
    aux3 = torch.sqrt(torch.clamp((d2 * d2 - d3 * d3) / denom, min=0.0))
    x1s = torch.stack([aux1, aux1, -aux1, -aux1])
    x3s = torch.stack([aux3, -aux3, aux3, -aux3])
    root = torch.sqrt(torch.clamp((d1 * d1 - d2 * d2) * (d2 * d2 - d3 * d3), min=0.0))
    st_p = root / torch.clamp((d1 + d3) * d2, min=1e-12)
    ct_p = (d2 * d2 + d1 * d3) / torch.clamp((d1 + d3) * d2, min=1e-12)
    st_n = root / torch.clamp((d1 - d3) * d2, min=1e-12)
    ct_n = (d1 * d3 - d2 * d2) / torch.clamp((d1 - d3) * d2, min=1e-12)
    zero, one = torch.zeros_like(d1), torch.ones_like(d1)

    def mat(rows):
        return torch.stack([torch.stack(r) for r in rows])

    Rs, ts = [], []
    signs = (1.0, -1.0, -1.0, 1.0)  # sign(x1*x3) pairing
    for i in range(4):
        st = signs[i] * st_p
        Rp = mat([[ct_p, zero, -st], [zero, one, zero], [st, zero, ct_p]])
        tp = (d1 - d3) * torch.stack([x1s[i], zero, -x3s[i]])
        Rs.append(detUV * (U @ Rp @ Vt))
        ts.append(U @ tp)
        st = signs[i] * st_n
        Rn = mat([[ct_n, zero, st], [zero, -one, zero], [st, zero, -ct_n]])
        tn = (d1 + d3) * torch.stack([x1s[i], zero, x3s[i]])
        Rs.append(detUV * (U @ Rn @ Vt))
        ts.append(U @ tn)
    Rs = torch.stack(Rs)
    ts = torch.stack(ts)
    ts = ts / torch.clamp(torch.linalg.norm(ts, dim=-1, keepdim=True), min=1e-12)
    n_good, good, pcos, X = _check_rt(Rs, ts, K, uv1, uv2, inliers)
    best = torch.argmax(n_good)
    n_best = n_good[best]
    second = torch.sort(n_good).values[-2]
    n_total = torch.clamp(torch.sum(inliers.to(torch.int32)), min=1)
    ok = ((n_best.to(torch.float32) > 0.75 * n_total.to(torch.float32))
          & (second < 0.75 * n_best)
          & (pcos[best] < math.cos(math.radians(1.0))))
    return ok, Rs[best], ts[best], good[best], X[best]


def sample_hypotheses(valid, generator: torch.Generator | None = None):
    """[N_HYP, 8] match indices: 8 distinct valid matches per set (Gumbel
    top-k over uniform draws from ``generator``)."""
    M = valid.shape[0]
    u = torch.rand((N_HYP, M), generator=generator, device=valid.device)
    gumbel = -torch.log(-torch.log(u * (1.0 - 1e-9) + 1e-9))
    scores = torch.where(valid[None, :], gumbel, -math.inf)
    return topk_stable(scores, 8)[1]


def initialize_two_view(K, uv1, uv2, valid, sel=None,
                        generator: torch.Generator | None = None) -> InitResult:
    """Full two-view bootstrap on matched keypoint pairs.

    Args: K [4]; uv1/uv2 [M,2] undistorted matches (padded); valid [M]
    bool; sel optional [N_HYP, 8] hypothesis sets (default: drawn from
    ``generator``).
    """
    if sel is None:
        sel = sample_hypotheses(valid, generator)
    sel = sel.to(device=uv1.device, dtype=torch.int64)
    uv1n, T1 = _normalize(uv1, valid)
    uv2n, T2 = _normalize(uv2, valid)
    T2inv = torch.linalg.inv(T2)

    Hs = T2inv @ _solve_h(uv1n[sel], uv2n[sel]) @ T1                  # [200,3,3]
    Fs = T2.T @ _solve_f(uv1n[sel], uv2n[sel]) @ T1
    shs, _ = _score_h(Hs, uv1, uv2, valid)
    sfs, _ = _score_f(Fs, uv1, uv2, valid)
    bh = torch.argmax(shs)
    bf_ = torch.argmax(sfs)
    H_best, F_best = Hs[bh], Fs[bf_]
    _, h_inl = _score_h(H_best, uv1, uv2, valid)
    _, f_inl = _score_f(F_best, uv1, uv2, valid)

    # refit on the inlier sets (weighted all-point DLT)
    H_ref = T2inv @ _solve_h(uv1n, uv2n, h_inl.to(torch.float32)) @ T1
    F_ref = T2.T @ _solve_f(uv1n, uv2n, f_inl.to(torch.float32)) @ T1
    sh_ref, h_inl_ref = _score_h(H_ref, uv1, uv2, valid)
    sf_ref, f_inl_ref = _score_f(F_ref, uv1, uv2, valid)
    use_h_ref = sh_ref > shs[bh]
    use_f_ref = sf_ref > sfs[bf_]
    H_best = torch.where(use_h_ref, H_ref, H_best)
    F_best = torch.where(use_f_ref, F_ref, F_best)
    h_inl = torch.where(use_h_ref, h_inl_ref, h_inl)
    f_inl = torch.where(use_f_ref, f_inl_ref, f_inl)
    SH = torch.maximum(sh_ref, shs[bh])
    SF = torch.maximum(sf_ref, sfs[bf_])
    use_h = SH / torch.clamp(SH + SF, min=1e-9) > 0.40

    ok_h, R_h, t_h, good_h, X_h = _reconstruct_h(H_best, K, uv1, uv2, h_inl)
    ok_f, R_f, t_f, good_f, X_f = _reconstruct_f(F_best, K, uv1, uv2, f_inl)
    ok = torch.where(use_h, ok_h, ok_f)
    R = torch.where(use_h, R_h, R_f)
    t = torch.where(use_h, t_h, t_f)
    good = torch.where(use_h, good_h, good_f)
    X = torch.where(use_h, X_h, X_f)
    # minimum triangulated support (>= 50 good points)
    ok = ok & (torch.sum(good.to(torch.int32)) >= 50)
    T_21 = lie.se3_make(lie.matrix_to_quat(R), t)
    return InitResult(ok=ok, T_21=T_21, points=X, good=good, used_h=use_h)
