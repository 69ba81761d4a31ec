"""SO3 / SE3 tangent-space operations on quaternion poses (torch).

Counterpart of the reference's ``ops/lie.py`` with the same conventions:

- quaternion layout ``[w, x, y, z]``, unit norm, Hamilton convention;
- SE3 pose = 7-vector ``[qw qx qy qz tx ty tz]`` mapping world->camera;
- SE3 tangent = 6-vector ``[omega(3), upsilon(3)]``; optimizer updates are
  left-multiplicative ``T <- exp(delta) * T``.

Every op broadcasts over leading batch dimensions and keeps its inputs'
device and dtype. Trig uses the reference's Taylor fallbacks near 0.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.autograd.forward_ad as fwAD

_EPS = 1e-8

SE3_IDENTITY = (1.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0)


@functools.lru_cache(maxsize=16)
def _m2q(device: str):
    return torch.as_tensor(_m2q_np(), device=device)


@functools.lru_cache()
def _m2q_np():
    """[4,4,10] Shepperd candidates as a linear map of [vec(R) row-major; 1]
    (the reference's ``_M2Q``)."""
    m2q = np.zeros((4, 4, 10), np.float32)

    def E(i, j):
        return 3 * i + j

    m2q[0, 0, [E(0, 0), E(1, 1), E(2, 2), 9]] = [1, 1, 1, 1]
    m2q[0, 1, [E(2, 1), E(1, 2)]] = [1, -1]
    m2q[0, 2, [E(0, 2), E(2, 0)]] = [1, -1]
    m2q[0, 3, [E(1, 0), E(0, 1)]] = [1, -1]
    m2q[1, 0, [E(2, 1), E(1, 2)]] = [1, -1]
    m2q[1, 1, [E(0, 0), E(1, 1), E(2, 2), 9]] = [1, -1, -1, 1]
    m2q[1, 2, [E(0, 1), E(1, 0)]] = [1, 1]
    m2q[1, 3, [E(0, 2), E(2, 0)]] = [1, 1]
    m2q[2, 0, [E(0, 2), E(2, 0)]] = [1, -1]
    m2q[2, 1, [E(0, 1), E(1, 0)]] = [1, 1]
    m2q[2, 2, [E(0, 0), E(1, 1), E(2, 2), 9]] = [-1, 1, -1, 1]
    m2q[2, 3, [E(1, 2), E(2, 1)]] = [1, 1]
    m2q[3, 0, [E(1, 0), E(0, 1)]] = [1, -1]
    m2q[3, 1, [E(0, 2), E(2, 0)]] = [1, 1]
    m2q[3, 2, [E(1, 2), E(2, 1)]] = [1, 1]
    m2q[3, 3, [E(0, 0), E(1, 1), E(2, 2), 9]] = [-1, -1, 1, 1]
    return m2q


# ---------------------------------------------------------------------------
# quaternions
# ---------------------------------------------------------------------------

def quat_normalize(q):
    return q / torch.clamp(torch.linalg.norm(q, dim=-1, keepdim=True), min=_EPS)


def quat_mul(a, b):
    aw, ax, ay, az = a.unbind(-1)
    bw, bx, by, bz = b.unbind(-1)
    return torch.stack(
        [
            aw * bw - ax * bx - ay * by - az * bz,
            aw * bx + ax * bw + ay * bz - az * by,
            aw * by - ax * bz + ay * bw + az * bx,
            aw * bz + ax * by - ay * bx + az * bw,
        ],
        dim=-1,
    )


def quat_conj(q):
    return torch.cat([q[..., :1], -q[..., 1:]], dim=-1)


def quat_rotate(q, v):
    """Rotate 3-vector(s) v by unit quaternion(s) q."""
    w = q[..., :1]
    xyz, v = torch.broadcast_tensors(q[..., 1:], v)
    t = 2.0 * torch.linalg.cross(xyz, v, dim=-1)
    return v + w * t + torch.linalg.cross(xyz, t, dim=-1)


def quat_to_matrix(q):
    """Unit quaternion -> rotation matrix, R = I + 2w[u]x + 2(uu^T - u.u I)."""
    w = q[..., :1, None]
    u = q[..., 1:]
    uu = u[..., :, None] * u[..., None, :]
    un = torch.sum(u * u, dim=-1)[..., None, None]
    eye = torch.eye(3, dtype=q.dtype, device=q.device)
    return eye + 2.0 * w * hat(u) + 2.0 * (uu - un * eye)


def matrix_to_quat(m):
    """Rotation matrix -> unit quaternion (Shepperd: the largest of the four
    linear candidates), canonical sign w >= 0."""
    v = torch.cat(
        [m.reshape(m.shape[:-2] + (9,)),
         torch.ones(m.shape[:-2] + (1,), dtype=m.dtype, device=m.device)],
        dim=-1,
    )
    m2q = _m2q(str(m.device)).to(m.dtype)
    cands = torch.einsum("kjn,...n->...kj", m2q, v)
    scores = torch.diagonal(cands, dim1=-2, dim2=-1)
    idx = torch.argmax(scores, dim=-1, keepdim=True)
    t = torch.gather(scores, -1, idx)
    q = torch.gather(cands, -2, idx[..., None].expand(idx.shape + (4,)))[..., 0, :]
    q = q / (2.0 * torch.sqrt(torch.clamp(t, min=_EPS)))
    q = q * torch.where(q[..., :1] < 0, -1.0, 1.0)
    return quat_normalize(q)


# ---------------------------------------------------------------------------
# SO3
# ---------------------------------------------------------------------------

def hat(w):
    """3-vector -> skew-symmetric matrix."""
    zeros = torch.zeros_like(w[..., 0])
    wx, wy, wz = w[..., 0], w[..., 1], w[..., 2]
    m = torch.stack([zeros, -wz, wy, wz, zeros, -wx, -wy, wx, zeros], dim=-1)
    return m.reshape(w.shape[:-1] + (3, 3))


def so3_exp_quat(w):
    """so3 tangent -> unit quaternion."""
    theta2 = torch.sum(w * w, dim=-1, keepdim=True)
    theta = torch.sqrt(torch.clamp(theta2, min=_EPS * _EPS))
    small = theta2 < 1e-8
    k = torch.where(small, 0.5 - theta2 / 48.0, torch.sin(0.5 * theta) / theta)
    cw = torch.where(small, 1.0 - theta2 / 8.0, torch.cos(0.5 * theta))
    return quat_normalize(torch.cat([cw, k * w], dim=-1))


def so3_log(q):
    """Unit quaternion -> so3 tangent (rotation vector)."""
    q = q * torch.where(q[..., :1] < 0, -1.0, 1.0)
    w = torch.clamp(q[..., :1], -1.0, 1.0)
    xyz = q[..., 1:]
    n = torch.linalg.norm(xyz, dim=-1, keepdim=True)
    angle = 2.0 * torch.atan2(n, w)
    k = torch.where(
        n < 1e-7, 2.0 / torch.clamp(w, min=_EPS), angle / torch.clamp(n, min=_EPS)
    )
    return k * xyz


def _so3_left_jacobian(w):
    theta2 = torch.sum(w * w, dim=-1)[..., None, None]
    theta = torch.sqrt(torch.clamp(theta2, min=_EPS * _EPS))
    W = hat(w)
    small = theta2 < 1e-8
    a = torch.where(small, 0.5 - theta2 / 24.0, (1.0 - torch.cos(theta)) / theta2)
    b = torch.where(
        small, 1.0 / 6.0 - theta2 / 120.0, (theta - torch.sin(theta)) / (theta2 * theta)
    )
    eye = torch.eye(3, dtype=w.dtype, device=w.device)
    return eye + a * W + b * (W @ W)


def _so3_left_jacobian_inv(w):
    theta2 = torch.sum(w * w, dim=-1)[..., None, None]
    theta = torch.sqrt(torch.clamp(theta2, min=_EPS * _EPS))
    W = hat(w)
    small = theta2 < 1e-8
    cot = torch.where(
        small,
        1.0 / 12.0 + theta2 / 720.0,
        (1.0 - 0.5 * theta * torch.cos(0.5 * theta)
         / torch.clamp(torch.sin(0.5 * theta), min=_EPS)) / theta2,
    )
    eye = torch.eye(3, dtype=w.dtype, device=w.device)
    return eye - 0.5 * W + cot * (W @ W)


# ---------------------------------------------------------------------------
# SE3 (7-vector [q, t])
# ---------------------------------------------------------------------------

def se3_quat(T):
    return T[..., :4]


def se3_trans(T):
    return T[..., 4:7]


def se3_make(q, t):
    return torch.cat([q, t], dim=-1)


def se3_identity(batch_shape=(), dtype=torch.float32, device="cpu"):
    T = torch.zeros(tuple(batch_shape) + (7,), dtype=dtype, device=device)
    T[..., 0] = 1.0
    return T


def se3_apply(T, p):
    """p_out = R p + t."""
    return quat_rotate(se3_quat(T), p) + se3_trans(T)


def se3_compose(A, B):
    """A * B (apply B first, then A)."""
    q = quat_mul(se3_quat(A), se3_quat(B))
    t = quat_rotate(se3_quat(A), se3_trans(B)) + se3_trans(A)
    return se3_make(quat_normalize(q), t)


def se3_inverse(T):
    qi = quat_conj(se3_quat(T))
    return se3_make(qi, -quat_rotate(qi, se3_trans(T)))


def se3_exp(xi):
    """se3 tangent [omega, upsilon] -> SE3 7-vector."""
    w, v = xi[..., :3], xi[..., 3:6]
    t = torch.einsum("...ij,...j->...i", _so3_left_jacobian(w), v)
    return se3_make(so3_exp_quat(w), t)


def se3_log(T):
    w = so3_log(se3_quat(T))
    v = torch.einsum("...ij,...j->...i", _so3_left_jacobian_inv(w), se3_trans(T))
    return torch.cat([w, v], dim=-1)


def se3_retract(T, xi):
    """Left-multiplicative optimizer update: exp(xi) * T."""
    return se3_compose(se3_exp(xi), T)


def se3_to_matrix(T):
    R = quat_to_matrix(se3_quat(T))
    top = torch.cat([R, se3_trans(T)[..., :, None]], dim=-1)
    bottom = torch.zeros(T.shape[:-1] + (1, 4), dtype=T.dtype, device=T.device)
    bottom[..., 3] = 1.0
    return torch.cat([top, bottom], dim=-2)


def se3_from_matrix(M):
    return se3_make(matrix_to_quat(M[..., :3, :3]), M[..., :3, 3])


def camera_center(T):
    """World position of the camera of pose T_cw: C = -R^T t."""
    return -quat_rotate(quat_conj(se3_quat(T)), se3_trans(T))


# ---------------------------------------------------------------------------
# Sim3 (8-vector [q, t, s]): loop closing and the essential graph
# ---------------------------------------------------------------------------

def sim3_make(q, t, s):
    return torch.cat([q, t, s[..., None] if s.ndim == q.ndim - 1 else s], dim=-1)


def sim3_quat(S):
    return S[..., :4]


def sim3_trans(S):
    return S[..., 4:7]


def sim3_scale(S):
    return S[..., 7]


def sim3_identity(batch_shape=(), dtype=torch.float32, device="cpu"):
    S = torch.zeros(tuple(batch_shape) + (8,), dtype=dtype, device=device)
    S[..., 0] = 1.0
    S[..., 7] = 1.0
    return S


def sim3_apply(S, p):
    return sim3_scale(S)[..., None] * quat_rotate(sim3_quat(S), p) + sim3_trans(S)


def sim3_compose(A, B):
    q = quat_mul(sim3_quat(A), sim3_quat(B))
    t = sim3_scale(A)[..., None] * quat_rotate(sim3_quat(A), sim3_trans(B)) + sim3_trans(A)
    s = sim3_scale(A) * sim3_scale(B)
    return torch.cat([quat_normalize(q), t, s[..., None]], dim=-1)


def sim3_inverse(S):
    qi = quat_conj(sim3_quat(S))
    si = 1.0 / sim3_scale(S)
    t = -si[..., None] * quat_rotate(qi, sim3_trans(S))
    return torch.cat([qi, t, si[..., None]], dim=-1)


def sim3_from_se3(T, s=None):
    if s is None:
        s = torch.ones(T.shape[:-1], dtype=T.dtype, device=T.device)
    return torch.cat([T, s[..., None]], dim=-1)


def sim3_to_se3(S):
    """Drop scale into translation: T = [q, t/s] (maps corrected Sim3
    keyframe poses back to SE3)."""
    return se3_make(sim3_quat(S), sim3_trans(S) / sim3_scale(S)[..., None])


def _sim3_W(w, sigma):
    """The Sim3 'W' matrix: integral of exp(sigma u) R(u w) du, which maps
    tangent translation into group translation. Four branches: general, and
    the limits of a small angle, a small log-scale, and both."""
    theta2 = torch.sum(w * w, dim=-1)
    theta = torch.sqrt(torch.clamp(theta2, min=_EPS * _EPS))
    s = sigma
    es = torch.exp(s)
    W_ = hat(w)
    W2 = W_ @ W_
    small_s = torch.abs(s) < 1e-5
    small_t = theta2 < 1e-8
    one = torch.ones_like(s)

    A_ss = torch.where(small_t, 0.5 * one,
                       (1.0 - torch.cos(theta)) / torch.clamp(theta2, min=_EPS))
    B_ss = torch.where(
        small_t, one / 6.0,
        (theta - torch.sin(theta)) / torch.clamp(theta2 * theta, min=_EPS),
    )

    denom = s * s + theta2
    a_gen = es * torch.sin(theta)
    b_gen = es * torch.cos(theta)
    C_gen = (es - 1.0) / torch.where(small_s, one, s)
    A_gen = (a_gen * s + (1.0 - b_gen) * theta) / torch.clamp(theta * denom, min=_EPS)
    B_gen = (
        C_gen - ((b_gen - 1.0) * s + a_gen * theta) / torch.clamp(denom, min=_EPS)
    ) / torch.clamp(theta2, min=_EPS)

    # sigma != 0, theta -> 0 limits
    A_s0 = torch.where(
        small_s, A_ss, ((s - 1.0) * es + 1.0) / torch.where(small_s, one, s * s)
    )
    B_s0 = torch.where(
        small_s, B_ss,
        (es * (0.5 * s * s - s + 1.0) - 1.0) / torch.where(small_s, one, s * s * s),
    )

    A = torch.where(small_s & small_t, A_ss,
                    torch.where(small_t, A_s0, torch.where(small_s, A_ss, A_gen)))
    B = torch.where(small_s & small_t, B_ss,
                    torch.where(small_t, B_s0, torch.where(small_s, B_ss, B_gen)))
    C = torch.where(small_s, one, C_gen)

    eye = torch.eye(3, dtype=w.dtype, device=w.device)
    return C[..., None, None] * eye + A[..., None, None] * W_ + B[..., None, None] * W2


def sim3_exp(xi):
    """sim3 tangent [omega(3), upsilon(3), sigma] -> Sim3 8-vector."""
    w, v, sigma = xi[..., :3], xi[..., 3:6], xi[..., 6]
    t = torch.einsum("...ij,...j->...i", _sim3_W(w, sigma), v)
    return torch.cat([so3_exp_quat(w), t, torch.exp(sigma)[..., None]], dim=-1)


def sim3_log(S):
    w = so3_log(sim3_quat(S))
    sigma = torch.log(torch.clamp(sim3_scale(S), min=_EPS))
    v = torch.linalg.solve(_sim3_W(w, sigma), sim3_trans(S)[..., None])[..., 0]
    return torch.cat([w, v, sigma[..., None]], dim=-1)


def sim3_retract(S, xi):
    return sim3_compose(sim3_exp(xi), S)


def jacobian_at_zero(fn, n: int, like):
    """Exact Jacobian at ``xi = 0`` of ``fn``, which maps tangents
    [..., n] to values [..., m] and broadcasts over leading axes (as every
    op of this module does): one forward-mode pass over a leading axis of
    the n unit tangents. ``like`` [*batch, k] gives the batch shape, dtype
    and device. Returns [*batch, m, n]."""
    batch = tuple(like.shape[:-1])
    eye = torch.eye(n, dtype=like.dtype, device=like.device)
    tangent = eye.reshape((n,) + (1,) * len(batch) + (n,)).expand((n,) + batch + (n,))
    with fwAD.dual_level():
        out = fn(fwAD.make_dual(torch.zeros_like(tangent), tangent))
        primal, jac = fwAD.unpack_dual(out)
        if jac is None:
            jac = torch.zeros_like(primal)
    return jac.movedim(0, -1)
