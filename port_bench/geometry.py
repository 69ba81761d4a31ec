"""Plain SE3 geometry on quaternion poses, for the scenes and the reference.

Conventions (the ones the map's tensors carry): a pose is the 7-vector
``[qw qx qy qz tx ty tz]`` of T_cw (world to camera), unit Hamilton
quaternion; a tangent is ``[omega, upsilon]`` and an update is applied on
the left, ``T <- exp(xi) * T``. Every function broadcasts over leading
dimensions and keeps its inputs' dtype and device. ``mm`` is the one
matrix product the reference uses, so that the control can round its
operands as TF32 does.
"""

from __future__ import annotations

import torch


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """``x`` (float32) rounded to TF32's 10 explicit mantissa bits, to
    nearest with ties away from zero, as the tensor cores read a float32
    operand."""
    bits = x.contiguous().view(torch.int32)
    bits = (bits + 0x1000) & ~0x1FFF
    return bits.view(torch.float32)


def mm(a: torch.Tensor, b: torch.Tensor, tf32: bool = False) -> torch.Tensor:
    """Batched matrix product ``a @ b``; with ``tf32`` both operands are
    rounded to TF32 first and the product accumulates in float32."""
    if tf32:
        a, b = tf32_round(a.to(torch.float32)), tf32_round(b.to(torch.float32))
    return a @ b


def hat(w: torch.Tensor) -> torch.Tensor:
    """[..., 3] -> [..., 3, 3] skew-symmetric matrices."""
    z = torch.zeros_like(w[..., 0])
    x, y, c = w[..., 0], w[..., 1], w[..., 2]
    return torch.stack([z, -c, y, c, z, -x, -y, x, z], dim=-1).reshape(w.shape[:-1] + (3, 3))


def quat_to_matrix(q: torch.Tensor) -> torch.Tensor:
    w, x, y, z = q.unbind(-1)
    return torch.stack([
        1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y),
        2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x),
        2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y),
    ], dim=-1).reshape(q.shape[:-1] + (3, 3))


def matrix_to_quat(R: torch.Tensor) -> torch.Tensor:
    """Rotation matrices -> unit quaternions with w >= 0 (Shepperd: the
    largest of the four diagonal candidates)."""
    m = R.reshape(R.shape[:-2] + (9,))
    m00, m01, m02, m10, m11, m12, m20, m21, m22 = m.unbind(-1)
    cands = torch.stack([
        torch.stack([1 + m00 + m11 + m22, m21 - m12, m02 - m20, m10 - m01], -1),
        torch.stack([m21 - m12, 1 + m00 - m11 - m22, m01 + m10, m02 + m20], -1),
        torch.stack([m02 - m20, m01 + m10, 1 - m00 + m11 - m22, m12 + m21], -1),
        torch.stack([m10 - m01, m02 + m20, m12 + m21, 1 - m00 - m11 + m22], -1),
    ], dim=-2)
    diag = torch.diagonal(cands, dim1=-2, dim2=-1)
    i = torch.argmax(diag, dim=-1)
    q = torch.gather(cands, -2, i[..., None, None].expand(i.shape + (1, 4)))[..., 0, :]
    q = q / (2.0 * torch.sqrt(torch.gather(diag, -1, i[..., None])))
    q = q * torch.where(q[..., :1] < 0, -1.0, 1.0)
    return q / torch.linalg.norm(q, dim=-1, keepdim=True)


def quat_mul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    aw, ax, ay, az = a.unbind(-1)
    bw, bx, by, bz = b.unbind(-1)
    return torch.stack([
        aw * bw - ax * bx - ay * by - az * bz,
        aw * bx + ax * bw + ay * bz - az * by,
        aw * by - ax * bz + ay * bw + az * bx,
        aw * bz + ax * by - ay * bx + az * bw,
    ], dim=-1)


def so3_exp(w: torch.Tensor) -> torch.Tensor:
    """Rotation vector -> unit quaternion."""
    th2 = torch.sum(w * w, dim=-1, keepdim=True)
    small = th2 < 1e-8
    th = torch.sqrt(torch.where(small, 1.0, th2))
    k = torch.where(small, 0.5 - th2 / 48.0, torch.sin(0.5 * th) / th)
    c = torch.where(small, 1.0 - th2 / 8.0, torch.cos(0.5 * th))
    q = torch.cat([c, k * w], dim=-1)
    return q / torch.linalg.norm(q, dim=-1, keepdim=True)


def so3_left_jacobian(w: torch.Tensor) -> torch.Tensor:
    th2 = torch.sum(w * w, dim=-1)[..., None, None]
    small = th2 < 1e-8
    safe = torch.where(small, 1.0, th2)
    th = torch.sqrt(safe)
    a = torch.where(small, 0.5 - th2 / 24.0, (1.0 - torch.cos(th)) / safe)
    b = torch.where(small, 1.0 / 6.0 - th2 / 120.0, (th - torch.sin(th)) / (safe * th))
    W = hat(w)
    eye = torch.eye(3, dtype=w.dtype, device=w.device)
    return eye + a * W + b * (W @ W)


def se3_exp(xi: torch.Tensor) -> torch.Tensor:
    """Tangent [omega, upsilon] -> 7-vector pose."""
    t = (so3_left_jacobian(xi[..., :3]) @ xi[..., 3:, None])[..., 0]
    return torch.cat([so3_exp(xi[..., :3]), t], dim=-1)


def se3_compose(A: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """A * B: apply B, then A."""
    q = quat_mul(A[..., :4], B[..., :4])
    t = (quat_to_matrix(A[..., :4]) @ B[..., 4:, None])[..., 0] + A[..., 4:]
    return torch.cat([q / torch.linalg.norm(q, dim=-1, keepdim=True), t], dim=-1)


def se3_retract(T: torch.Tensor, xi: torch.Tensor) -> torch.Tensor:
    return se3_compose(se3_exp(xi), T)


def pose_from_center(C: torch.Tensor, forward: torch.Tensor) -> torch.Tensor:
    """T_cw of cameras at world points ``C`` looking along ``forward``, the
    image's y axis as near the world's +y (down) as the view allows."""
    z = forward / torch.linalg.norm(forward, dim=-1, keepdim=True)
    down = torch.zeros_like(z)
    down[..., 1] = 1.0
    x = torch.linalg.cross(down, z, dim=-1)
    x = x / torch.linalg.norm(x, dim=-1, keepdim=True)
    y = torch.linalg.cross(z, x, dim=-1)
    R_cw = torch.stack([x, y, z], dim=-2)          # rows: the camera axes in the world
    t = -(R_cw @ C[..., None])[..., 0]
    return torch.cat([matrix_to_quat(R_cw), t], dim=-1)


def camera_center(T: torch.Tensor) -> torch.Tensor:
    R = quat_to_matrix(T[..., :4])
    return -(R.transpose(-1, -2) @ T[..., 4:, None])[..., 0]


def rotation_angle(qa: torch.Tensor, qb: torch.Tensor) -> torch.Tensor:
    """Angle in radians of the rotation between unit quaternions."""
    conj = torch.cat([qa[..., :1], -qa[..., 1:]], dim=-1)
    r = quat_mul(conj, qb)
    return 2.0 * torch.atan2(torch.linalg.norm(r[..., 1:], dim=-1), torch.abs(r[..., 0]))
