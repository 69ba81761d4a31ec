"""Synthetic textured-plane sequences (numpy only).

The counterpart of the reference package's ``utils/synthetic.py``. The
reference renders with OpenCV; the machine that runs the port on the GPU has
no OpenCV, so the three OpenCV calls it uses are rewritten here in numpy,
following OpenCV's own arithmetic:

- ``cv2.resize(..., INTER_NEAREST)`` at integer factors -> ``np.repeat``;
- ``cv2.circle(..., thickness=-1)`` -> :func:`_fill_circle`, OpenCV's
  midpoint span fill for integer centres;
- ``cv2.warpPerspective(..., INTER_LINEAR)`` -> :func:`_warp_perspective`.

The textures are bit-identical to OpenCV's; rendered frames agree with
OpenCV 5's to about 1e-3 grey levels (the test states the bound).
"""

from __future__ import annotations

import numpy as np


def _fill_circle(img: np.ndarray, cx: int, cy: int, r: int, color: float):
    """Filled circle with OpenCV's midpoint rasterization (``Circle`` in
    imgproc/drawing.cpp, fill branch); the centre lies >= r inside."""
    err, dx, dy, plus, minus = 0, r, 0, 1, (r << 1) - 1
    while dx >= dy:
        img[cy - dy, cx - dx: cx + dx + 1] = color
        img[cy + dy, cx - dx: cx + dx + 1] = color
        img[cy - dx, cx - dy: cx + dy + 1] = color
        img[cy + dx, cx - dy: cx + dy + 1] = color
        dy += 1
        err += plus
        plus += 2
        mask = (1 if err <= 0 else 0) - 1
        err -= minus & mask
        dx += mask
        minus -= mask & 2


def _warp_perspective(src, H, w, h, wrap=True, border_value=0.0):
    """``cv2.warpPerspective(src, H, (w, h), INTER_LINEAR, BORDER_WRAP or
    BORDER_CONSTANT)`` for a float32 image: sample positions in float64,
    float32 bilinear weights without OpenCV 4's 1/32-pixel quantization
    (OpenCV 5 dropped it too)."""
    M = np.linalg.inv(np.asarray(H, np.float64))
    sh, sw = src.shape
    ys, xs = np.mgrid[0:h, 0:w].astype(np.float64)
    wd = M[2, 0] * xs + M[2, 1] * ys + M[2, 2]
    X = (M[0, 0] * xs + M[0, 1] * ys + M[0, 2]) / wd
    Y = (M[1, 0] * xs + M[1, 1] * ys + M[1, 2]) / wd
    sx, sy = np.floor(X), np.floor(Y)
    ax = (X - sx).astype(np.float32)
    ay = (Y - sy).astype(np.float32)
    sx, sy = sx.astype(np.int64), sy.astype(np.int64)

    def tap(dy, dx):
        yy, xx = sy + dy, sx + dx
        if wrap:
            return src[yy % sh, xx % sw]
        inside = (yy >= 0) & (yy < sh) & (xx >= 0) & (xx < sw)
        v = src[np.clip(yy, 0, sh - 1), np.clip(xx, 0, sw - 1)]
        return np.where(inside, v, np.float32(border_value))

    p00, p01, p10, p11 = tap(0, 0), tap(0, 1), tap(1, 0), tap(1, 1)
    top = (p01 - p00) * ax + p00
    bot = (p11 - p10) * ax + p10
    return ((bot - top) * ay + top).astype(np.float32)


def _texture(size: int, seed: int) -> np.ndarray:
    """Multi-scale random texture with strong corners for FAST (the
    reference recipe: blocky noise layers down to size//32, then
    high-contrast blobs at constant density per area)."""
    rng = np.random.RandomState(seed)
    img = np.zeros((size, size), np.float32)
    sc = 8
    while sc <= max(64, size // 32):
        layer = rng.rand(sc, sc).astype(np.float32)
        f = size // sc
        img += np.repeat(np.repeat(layer, f, axis=0), f, axis=1)
        sc *= 2
    img = (img - img.min()) / (img.max() - img.min())
    for _ in range(max(size, size * size // 2048)):
        x, y = rng.randint(8, size - 8, 2)
        r = rng.randint(2, 6)
        _fill_circle(img, int(x), int(y), int(r), np.float32(rng.rand()))
    return (img * 255.0).astype(np.float32)


def planar_sequence(
    n_frames: int = 60,
    h: int = 480,
    w: int = 640,
    fx: float = 500.0,
    fy: float = 500.0,
    seed: int = 0,
    motion: str = "strafe",
    plane_half: float = 3.0,
    tex_size: int = 2048,
    relief: bool = False,
):
    """Camera viewing a textured plane z=0 from distance ~2.5; ``relief``
    adds a raised textured platform (z=0.8 over [-1.2,1.2]^2).

    Returns (imgs [T,H,W] float32, poses_true list of 4x4 T_cw, K [4]).
    """
    imgs, poses = [], []
    for img, T in planar_stream(
        n_frames=n_frames, h=h, w=w, fx=fx, fy=fy, seed=seed, motion=motion,
        plane_half=plane_half, tex_size=tex_size, relief=relief,
    ):
        imgs.append(img)
        poses.append(T)
    return np.stack(imgs), poses, np.array([fx, fy, w / 2.0, h / 2.0])


def _camera_path(motion: str, u: float, plane_half: float):
    """(tx, ty, tz, yaw, pitch) of the camera at normalized time u."""
    if motion == "strafe":
        return (1.2 * u, 0.15 * np.sin(2 * np.pi * u),
                2.5 + 0.3 * np.sin(np.pi * u), 0.15 * u,
                0.05 * np.sin(2 * np.pi * u))
    if motion == "orbit_loop":
        ang = 2 * np.pi * u
        return 0.8 * np.sin(ang), 0.8 * (1 - np.cos(ang)), 2.5, 0.10 * np.sin(ang), 0.0
    if motion == "out_and_back":
        v = min(u / 0.85, 1.0)
        tx = plane_half * np.sin(np.pi * v) ** 2 + 0.05 * max(u - 0.85, 0.0) / 0.15
        return tx, 0.1 * np.sin(4 * np.pi * u), 2.5, 0.0, 0.0
    if motion == "survey":
        span = 0.75 * plane_half
        return (span * np.sin(2 * np.pi * 3 * u), (2 * u - 1) * 0.8 * span,
                2.5 + 0.2 * np.sin(2 * np.pi * 5 * u),
                0.1 * np.sin(2 * np.pi * u), 0.03 * np.sin(2 * np.pi * 2 * u))
    raise ValueError(motion)


def planar_stream(
    n_frames: int = 60,
    h: int = 480,
    w: int = 640,
    fx: float = 500.0,
    fy: float = 500.0,
    seed: int = 0,
    motion: str = "strafe",
    plane_half: float = 3.0,
    tex_size: int = 2048,
    relief: bool = False,
    noise: float = 0.0,
):
    """Streaming version of :func:`planar_sequence`: yields one
    (img [H,W] float32, T_cw 4x4) at a time."""
    noise_rng = np.random.RandomState(seed + 4242) if noise > 0 else None
    K3 = np.array([[fx, 0, w / 2.0], [0, fy, h / 2.0], [0, 0, 1.0]])
    tex = _texture(tex_size, seed)
    relief_tex = _texture(512, seed + 77) if relief else None
    for t in range(n_frames):
        u = t / max(n_frames - 1, 1)
        tx, ty, tz, yaw, pitch = _camera_path(motion, u, plane_half)
        R_wc = _rot_z(yaw) @ _rot_x(np.pi + pitch)  # look down at z=0
        R_cw = R_wc.T
        T = np.eye(4)
        T[:3, :3] = R_cw
        T[:3, 3] = -R_cw @ np.array([tx, ty, tz])
        img = render_plane(tex, T, K3, h, w, plane_half=plane_half,
                           relief_tex=relief_tex, noise=noise,
                           noise_rng=noise_rng)
        yield img, T


def render_plane(tex, T_cw, K3, h, w, plane_half=3.0,
                 relief_tex=None, relief_half=1.2, relief_z=0.8,
                 noise=0.0, noise_rng=None):
    """Render the textured z=0 plane (and the optional relief platform)
    from pose T_cw (4x4)."""
    s = tex.shape[0] / (2 * plane_half)
    S = np.array(
        [[s, 0, tex.shape[0] / 2.0], [0, s, tex.shape[0] / 2.0], [0, 0, 1.0]]
    )
    R_cw = T_cw[:3, :3]
    t_cw = T_cw[:3, 3]
    Hwi = K3 @ np.stack([R_cw[:, 0], R_cw[:, 1], t_cw], axis=1)
    img = _warp_perspective(tex, Hwi @ np.linalg.inv(S), w, h, wrap=True)
    if relief_tex is not None:
        n = relief_tex.shape[0]
        Sr = np.array(
            [[n / (2 * relief_half), 0, n / 2.0],
             [0, n / (2 * relief_half), n / 2.0], [0, 0, 1.0]]
        )
        Hr = K3 @ np.stack(
            [R_cw[:, 0], R_cw[:, 1], R_cw[:, 2] * relief_z + t_cw], axis=1
        )
        top = _warp_perspective(relief_tex, Hr @ np.linalg.inv(Sr), w, h,
                                wrap=False, border_value=-1.0)
        img = np.where(top >= 0, top, img).astype(np.float32)
    if noise > 0 and noise_rng is not None:
        img = np.clip(
            img + noise_rng.randn(h, w).astype(np.float32) * noise, 0.0, 255.0
        )
    return img


def _rot_x(a):
    c, s = np.cos(a), np.sin(a)
    return np.array([[1, 0, 0], [0, c, -s], [0, s, c]])


def _rot_z(a):
    c, s = np.cos(a), np.sin(a)
    return np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]])


def stereo_right_pose(T_cw, baseline):
    """Right-camera pose for a rectified pair: the right camera sits at +b
    along the left camera's x-axis, so t_r = t_l - (b,0,0)."""
    T = T_cw.copy()
    T[0, 3] -= baseline
    return T


def planar_sequence_stereo(
    n_frames=40, h=240, w=320, fx=260.0, fy=260.0, baseline=0.1, seed=0,
    motion="strafe", relief=False,
):
    """Stereo version: returns (imgs_l, imgs_r, poses, K)."""
    imgs_l, poses, K = planar_sequence(
        n_frames=n_frames, h=h, w=w, fx=fx, fy=fy, seed=seed, motion=motion,
        relief=relief,
    )
    tex = _texture(2048, seed)
    relief_tex = _texture(512, seed + 77) if relief else None
    K3 = np.array([[K[0], 0, K[2]], [0, K[1], K[3]], [0, 0, 1.0]])
    imgs_r = np.stack(
        [render_plane(tex, stereo_right_pose(T, baseline), K3, h, w,
                      relief_tex=relief_tex) for T in poses]
    )
    return imgs_l, imgs_r, poses, K


def planar_depth(pose_T_cw, K, h, w, relief=False, relief_half=1.2,
                 relief_z=0.8):
    """Exact depth map of the scene for RGB-D runs: the z=0 plane plus,
    with ``relief=True``, the raised platform the renderers draw (the depth
    image must agree pixel for pixel with the rendered frame)."""
    R = pose_T_cw[:3, :3]
    t = pose_T_cw[:3, 3]
    fx, fy, cx, cy = K
    ys, xs = np.mgrid[0:h, 0:w]
    rays = np.stack(
        [(xs - cx) / fx, (ys - cy) / fy, np.ones_like(xs, np.float64)], axis=-1
    )
    # world ray dir = R^T d, origin C = -R^T t; the hit's camera-frame z
    d_w = rays @ R
    C = -R.T @ t
    dz = np.where(np.abs(d_w[..., 2]) < 1e-9, 1e-9, d_w[..., 2])
    lam = (0.0 - C[2]) / dz
    depth = np.where(lam > 0, lam, 0.0)
    if relief:
        lam_r = (relief_z - C[2]) / dz
        hit = C[None, None, :] + lam_r[..., None] * d_w
        on_platform = (
            (lam_r > 0)
            & (np.abs(hit[..., 0]) <= relief_half)
            & (np.abs(hit[..., 1]) <= relief_half)
        )
        depth = np.where(on_platform, lam_r, depth)
    return depth.astype(np.float32)
