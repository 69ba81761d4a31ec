"""Motion-only pose optimization (the per-frame hot solver), torch.

Counterpart of the reference's ``ops/pose_opt.py`` (``PoseOptimization``):
``rounds`` x ``iters`` Levenberg-Marquardt on one SE3 pose against N fixed
points, chi-square inlier re-classification between rounds (5.991 mono /
7.815 stereo) and the Huber kernel for the first two rounds only. The pose
is carried as (R [3,3], t [3]); each LM step evaluates (H, b, cost) at the
candidate in one pass with deferred accept/reject. Every accept/reject is a
``torch.where`` on the device, so the solve never waits for the host.

On a CUDA tensor the whole solve is one launch of the hand-written kernel
``csrc/pose_lm.cu`` (:func:`pose_optimization`); a CPU tensor takes the
plain PyTorch version (:func:`pose_optimization_plain`), ~100 small ops per
LM step. The kernel replaces the reference's jitted ``fori_loop`` solve
(``orbslam2_with_quadrics_tpu/ops/pose_opt.py:190-280``). What bounds it
on the card is latency, not bytes or FLOPs: the schedule is a chain of
2 * rounds * (iters + 1) + rounds dependent links (52 at 4 x 5), each LM
evaluation a block-wide reduction followed by a serial 6x6 solve. The
kernel keeps that chain inside one block of 256 threads: the observations
in registers for the whole solve, one barrier a reduction (a
lane-transpose reduction in each warp, the warps' partials added in warp
order), and every thread solving and retracting the same step from the
shared sums, so that no second barrier hands it over; the host pays one
launch per solve instead of ~3,000 per frame.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import cuda_kernels, lie, residuals


def solve_spd_small(H, b, eps: float = 1e-12):
    """Solve H x = b for a small SPD H (the damped 6x6 normal matrix) by
    Cholesky of H + ``eps`` I. Where a pivot is not positive the solution
    is NaN, so the LM step that asked for it is rejected (``cholesky_ex``
    alone leaves a partial factor that solves to some finite step). The
    reference floors such a pivot at ``eps`` and takes the huge finite
    step that gives; the port rejects it on purpose."""
    n = H.shape[-1]
    L, info = torch.linalg.cholesky_ex(
        H + eps * torch.eye(n, dtype=H.dtype, device=H.device)
    )
    # two triangular solves: unlike cholesky_solve / solve, nothing here
    # reads an error flag back to the host, so the LM chain never syncs
    y = torch.linalg.solve_triangular(L, b[..., None], upper=False)
    x = torch.linalg.solve_triangular(L.mT, y, upper=True)[..., 0]
    return torch.where((info == 0)[..., None], x, float("nan"))


def _row_weights(is_stereo):
    return torch.stack(
        [torch.ones_like(is_stereo), torch.ones_like(is_stereo), is_stereo], dim=-1
    )


def _project_mat(R, t, K, bf, points):
    """pc, prediction [N,3] (u, v, u_r) and depth in matrix-pose form."""
    pc = points @ R.T + t
    z = pc[:, 2]
    zs = torch.where(torch.abs(z) < 1e-6, 1e-6, z)
    iz = 1.0 / zs
    u = K[0] * pc[:, 0] * iz + K[2]
    v = K[1] * pc[:, 1] * iz + K[3]
    return pc, torch.stack([u, v, u - bf * iz], dim=-1), z, iz


def robust_cost(chi2, huber_delta2: float):
    """Huber rho(chi2) (plain chi2 when ``huber_delta2`` is 0)."""
    if huber_delta2 <= 0:
        return chi2
    return torch.where(
        chi2 > huber_delta2,
        2.0 * torch.sqrt(huber_delta2 * torch.clamp(chi2, min=1e-12)) - huber_delta2,
        chi2,
    )


def _chi2_mat(R, t, K, bf, points, obs, row_w, w_obs):
    """Per-observation chi2 (no robust kernel)."""
    _, pred, z, _ = _project_mat(R, t, K, bf, points)
    e = obs - pred
    return torch.sum(e * e * row_w, dim=-1) * (w_obs * (z > 0.05))


def _normal_eq_mat(R, t, K, bf, points, obs, row_w, w_obs, huber_delta2: float):
    """H [6,6], b [6] and robust cost at (R, t) in one batched pass;
    Jc = [dpred @ hat(pc), -dpred] (g2o's EdgeSE3ProjectXYZOnlyPose)."""
    pc, pred, z, iz = _project_mat(R, t, K, bf, points)
    e = obs - pred
    w_eff = w_obs * (z > 0.05)
    chi2 = torch.sum(e * e * row_w, dim=-1) * w_eff
    if huber_delta2 > 0:
        w = w_eff * residuals.huber_weight(chi2, huber_delta2)
    else:
        w = w_eff
    dpred = residuals._dpred_dpc(pc[:, 0], pc[:, 1], iz, K, bf)   # [N,3,3]
    Jc = torch.cat([dpred @ lie.hat(pc), -dpred], dim=-1)          # [N,3,6]
    Jw = Jc * (row_w[..., None] * w[:, None, None])
    H = torch.einsum("nri,nrj->ij", Jw, Jc)
    b = -torch.einsum("nri,nr->i", Jw, e)
    return H, b, torch.sum(robust_cost(chi2, huber_delta2))


def _retract_mat(R, t, delta):
    """exp(delta) * (R, t) via Rodrigues (Taylor fallbacks near 0)."""
    w, v = delta[:3], delta[3:6]
    W = lie.hat(w)
    W2 = W @ W
    theta2 = torch.sum(w * w)
    theta = torch.sqrt(torch.clamp(theta2, min=1e-16))
    small = theta2 < 1e-8
    safe2 = torch.where(small, 1.0, theta2)
    sA = torch.where(small, 1.0 - theta2 / 6.0, torch.sin(theta) / theta)
    sB = torch.where(small, 0.5 - theta2 / 24.0, (1.0 - torch.cos(theta)) / safe2)
    sC = torch.where(small, 1.0 / 6.0 - theta2 / 120.0,
                     (theta - torch.sin(theta)) / (safe2 * theta))
    eye = torch.eye(3, dtype=R.dtype, device=R.device)
    Rd = eye + sA * W + sB * W2
    V = eye + sB * W + sC * W2
    return Rd @ R, Rd @ t + V @ v


def _lm_round(R, t, K, bf, points, obs, row_w, w_obs, huber_delta2: float,
              iters: int):
    """``iters`` LM steps on a fixed inlier weighting, deferred
    accept/reject (a rejected step re-damps the incumbent's system)."""
    H, b, cost = _normal_eq_mat(R, t, K, bf, points, obs, row_w, w_obs, huber_delta2)
    lam = torch.full((), 1e-4, dtype=R.dtype, device=R.device)
    eye6 = torch.eye(6, dtype=R.dtype, device=R.device)
    for _ in range(iters):
        Hd = H + lam * torch.diag(torch.diagonal(H)) + 1e-10 * eye6
        delta = solve_spd_small(Hd, b)
        R_c, t_c = _retract_mat(R, t, delta)
        H_c, b_c, cost_c = _normal_eq_mat(
            R_c, t_c, K, bf, points, obs, row_w, w_obs, huber_delta2
        )
        ok = (cost_c < cost) & torch.all(torch.isfinite(delta))
        R = torch.where(ok, R_c, R)
        t = torch.where(ok, t_c, t)
        H = torch.where(ok, H_c, H)
        b = torch.where(ok, b_c, b)
        cost = torch.where(ok, cost_c, cost)
        lam = torch.clamp(torch.where(ok, lam * 0.5, lam * 4.0), 1e-10, 1e6)
    return R, t


def pose_optimization_plain(T_init, K, bf, points_w, obs_uvr, is_stereo, inv_sigma2,
                            valid, rounds: int = 4, iters: int = 5):
    """Plain PyTorch version of :func:`pose_optimization` (the CPU route,
    and what the kernel is held against on the card).

    Args: T_init [7]; K [4]; bf scalar (0 for mono); points_w [N,3];
    obs_uvr [N,3]; is_stereo [N] (1.0 where u_r is measured);
    inv_sigma2 [N]; valid [N] (1.0 real, 0.0 padding).
    Returns (T_opt [7], inlier_mask [N] bool, n_inliers int32 scalar).
    """
    row_w = _row_weights(is_stereo)
    chi2_gate = torch.where(is_stereo > 0, residuals.CHI2_STEREO, residuals.CHI2_MONO)
    inlier = valid > 0
    R = lie.quat_to_matrix(T_init[:4])
    t = T_init[4:7]
    w_all = (valid > 0).to(t.dtype) * inv_sigma2
    for r in range(rounds):
        huber_delta2 = residuals.CHI2_STEREO if r < 2 else 0.0
        w_obs = inlier.to(t.dtype) * inv_sigma2
        R, t = _lm_round(R, t, K, bf, points_w, obs_uvr, row_w, w_obs,
                         huber_delta2, iters)
        # re-classify over ALL valid obs so outliers can be rescued
        chi2_all = _chi2_mat(R, t, K, bf, points_w, obs_uvr, row_w, w_all)
        inlier = (chi2_all < chi2_gate) & (valid > 0)
    T = lie.se3_make(lie.matrix_to_quat(R), t)
    return T, inlier, torch.sum(inlier.to(torch.int32))


@functools.lru_cache(maxsize=1)
def _launcher():
    fn = cuda_kernels.library("pose_lm").pose_lm_launch
    fn.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_float] + [ctypes.c_void_p] * 5
                   + [ctypes.c_int] * 3 + [ctypes.c_void_p] * 4)
    fn.restype = ctypes.c_int
    return fn


def _checked(name, t, dev, shape):
    if t.device != dev:
        raise ValueError(f"pose_optimization: {name} on {t.device}, expected {dev}")
    if t.dtype != torch.float32:
        raise ValueError(f"pose_optimization: {name} has dtype {t.dtype}, expected float32")
    if tuple(t.shape) != shape:
        raise ValueError(f"pose_optimization: {name} has shape {tuple(t.shape)}, "
                         f"expected {shape}")
    return t.contiguous()


def pose_optimization(T_init, K, bf, points_w, obs_uvr, is_stereo, inv_sigma2,
                      valid, rounds: int = 4, iters: int = 5):
    """Optimize one camera pose against fixed 3D points: ``rounds`` x
    ``iters`` LM with chi2 re-classification between rounds.

    Args: T_init [7]; K [4]; bf scalar (0 for mono; a number or a 0-dim
    tensor); points_w [N,3]; obs_uvr [N,3]; is_stereo [N] (1.0 where u_r is
    measured); inv_sigma2 [N]; valid [N] (1.0 real, 0.0 padding); all
    float32. Returns (T_opt [7], inlier_mask [N] bool, n_inliers int32
    scalar), on the inputs' device. CPU tensors take
    :func:`pose_optimization_plain`; CUDA tensors one launch of
    ``csrc/pose_lm.cu``."""
    dev = points_w.device
    if dev.type == "cpu":
        return pose_optimization_plain(T_init, K, bf, points_w, obs_uvr, is_stereo,
                                       inv_sigma2, valid, rounds, iters)
    if dev.type != "cuda":
        raise ValueError(f"pose_optimization: unsupported device {dev}")
    n = points_w.shape[0]
    args = [_checked(name, t, dev, shape) for name, t, shape in (
        ("T_init", T_init, (7,)), ("K", K, (4,)), ("points_w", points_w, (n, 3)),
        ("obs_uvr", obs_uvr, (n, 3)), ("is_stereo", is_stereo, (n,)),
        ("inv_sigma2", inv_sigma2, (n,)), ("valid", valid, (n,)))]
    if isinstance(bf, torch.Tensor):
        bf_t, bf_val = _checked("bf", bf.reshape(()), dev, ()), 0.0
    else:
        bf_t, bf_val = None, float(bf)
    if rounds < 0 or iters < 0:
        raise ValueError(f"pose_optimization: rounds={rounds}, iters={iters}")
    T_out = torch.empty(7, dtype=torch.float32, device=dev)
    inlier = torch.empty(n, dtype=torch.bool, device=dev)
    n_inl = torch.empty((), dtype=torch.int32, device=dev)
    ctx, index = cuda_kernels.launch_device(dev)
    with ctx:
        err = _launcher()(
            args[0].data_ptr(), args[1].data_ptr(),
            None if bf_t is None else bf_t.data_ptr(), bf_val,
            *(a.data_ptr() for a in args[2:]), n, int(rounds), int(iters),
            T_out.data_ptr(), inlier.data_ptr(), n_inl.data_ptr(),
            torch.cuda.current_stream(index).cuda_stream)
    if err != 0:
        raise RuntimeError(f"pose_lm launch failed: cudaError {err}")
    cuda_kernels.LAUNCHES["pose_lm"] += 1
    return T_out, inlier, n_inl
