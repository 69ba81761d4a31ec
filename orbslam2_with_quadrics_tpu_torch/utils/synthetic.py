"""Synthetic textured-plane sequences (numpy only).

The counterpart of the reference package's ``utils/synthetic.py``. The
reference renders with OpenCV; the machine that runs the port on the GPU has
no OpenCV, so the three OpenCV calls it uses are rewritten here in numpy,
following OpenCV's own arithmetic:

- ``cv2.resize(..., INTER_NEAREST)`` -> an index gather, the source index
  ``floor(x * src / dst)`` as OpenCV computes it;
- ``cv2.circle(..., thickness=-1)`` -> :func:`_fill_circle`, OpenCV's
  midpoint span fill for integer centres;
- ``cv2.warpPerspective(..., INTER_LINEAR)`` -> :func:`_warp_perspective`.

The textures are bit-identical to OpenCV's; rendered frames agree with
OpenCV 5's to about 1e-3 grey levels (the test states the bound).

``write_tum_sequence`` and ``write_kitti_sequence`` write a sequence to disk
in the TUM and KITTI layouts the example drivers read, with the PNGs written
by ``image_io.write_png`` (zlib and struct) in place of ``cv2.imwrite``.
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
        # cv2.resize(INTER_NEAREST): source index floor(x * sc / size)
        idx = np.minimum(np.floor(np.arange(size) * (1.0 / (size / sc))).astype(np.int64),
                         sc - 1)
        img += layer[idx[:, None], idx[None, :]]
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
    if motion == "orbit_big":
        # LARGE circle (radius plane_half/2) that leaves the start's view
        # entirely and closes at the end, with a 12% dwell at home so the
        # loop detector sees several consistent keyframes of the revisited
        # place: mid-orbit views share nothing with home
        R = 0.5 * plane_half
        ang = 2 * np.pi * min(u / 0.88, 1.0)
        dwell = max(u - 0.88, 0.0) / 0.12
        return R * np.sin(ang) + 0.06 * dwell, R * (1 - np.cos(ang)), 2.5, 0.0, 0.0
    if motion == "figure8":
        # two circular lobes through DISTINCT territory (upper then lower),
        # each returning to home: two topological loops. Cycloidal easing
        # gives zero velocity at every junction.
        R8 = plane_half / 3.0

        def _circ(v):
            return 2 * np.pi * v - np.sin(2 * np.pi * v)

        if u < 0.42:
            a = _circ(u / 0.42)
            tx, ty = R8 * np.sin(a), R8 * (1 - np.cos(a))
        elif u < 0.5:
            tx, ty = 0.04 * (u - 0.42) / 0.08, 0.0
        elif u < 0.92:
            a = _circ((u - 0.5) / 0.42)
            tx, ty = 0.04 + R8 * np.sin(a), -R8 * (1 - np.cos(a))
        else:
            tx, ty = 0.04 + 0.04 * (u - 0.92) / 0.08, 0.0
        return tx, ty, 2.5, 0.0, 0.0
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


def write_tum_sequence(
    out_dir: str,
    n_frames: int = 120,
    h: int = 240,
    w: int = 320,
    fx: float = 260.0,
    seed: int = 0,
    motion: str = "strafe",
    plane_half: float = 3.0,
    sensor: str = "mono",
    n_features: int = 600,
    depth_factor: float = 5000.0,
    fps: float = 30.0,
):
    """Write a synthetic sequence to disk in the TUM RGB-D dataset layout
    the reference drivers consume (Examples/Monocular/mono_tum.cc:36-132,
    Examples/RGB-D/rgbd_tum.cc): ``rgb/*.png`` + ``rgb.txt``,
    ``groundtruth.txt`` (T_wc, 'ts tx ty tz qx qy qz qw'), a reference-
    format settings YAML, and for ``sensor='rgbd'`` also ``depth/*.png``
    (16-bit, ``depth_factor`` counts per meter, TUM's 5000) +
    ``depth.txt`` + ``associations.txt``.

    The same files as the reference package's writer: text files byte for
    byte; PNGs through :func:`image_io.write_png` in place of
    ``cv2.imwrite``, their pixels as this module renders them. Returns
    (settings_path, out_dir)."""
    import os

    from .image_io import write_png
    from .trajectory import _R_to_quat

    os.makedirs(os.path.join(out_dir, "rgb"), exist_ok=True)
    if sensor == "rgbd":
        os.makedirs(os.path.join(out_dir, "depth"), exist_ok=True)
    K4 = np.array([fx, fx, w / 2.0, h / 2.0])
    stream = planar_stream(
        n_frames=n_frames, h=h, w=w, fx=fx, fy=fx, seed=seed, motion=motion,
        plane_half=plane_half, relief=True, noise=4.0,
    )
    rgb_lines, depth_lines, assoc_lines, gt_lines = [], [], [], []
    for i, (img, T_cw) in enumerate(stream):
        ts = i / fps
        name = f"{ts:.6f}.png"
        write_png(os.path.join(out_dir, "rgb", name), np.clip(img, 0, 255).astype(np.uint8))
        rgb_lines.append(f"{ts:.6f} rgb/{name}")
        if sensor == "rgbd":
            d = planar_depth(T_cw, K4, h, w, relief=True)
            d16 = np.clip(d * depth_factor, 0, 65535).astype(np.uint16)
            write_png(os.path.join(out_dir, "depth", name), d16)
            depth_lines.append(f"{ts:.6f} depth/{name}")
            assoc_lines.append(f"{ts:.6f} rgb/{name} {ts:.6f} depth/{name}")
        # TUM groundtruth is T_wc (camera pose in world)
        R_wc = T_cw[:3, :3].T
        C = -R_wc @ T_cw[:3, 3]
        qx, qy, qz, qw = _R_to_quat(R_wc)
        gt_lines.append(
            f"{ts:.6f} {C[0]:.6f} {C[1]:.6f} {C[2]:.6f} "
            f"{qx:.6f} {qy:.6f} {qz:.6f} {qw:.6f}"
        )
    hdr = "# synthetic TUM-format sequence\n# timestamp filename\n"
    with open(os.path.join(out_dir, "rgb.txt"), "w") as f:
        f.write(hdr + "\n".join(rgb_lines) + "\n")
    with open(os.path.join(out_dir, "groundtruth.txt"), "w") as f:
        f.write(
            "# ground truth trajectory\n# timestamp tx ty tz qx qy qz qw\n"
            + "\n".join(gt_lines) + "\n"
        )
    if sensor == "rgbd":
        with open(os.path.join(out_dir, "depth.txt"), "w") as f:
            f.write(hdr + "\n".join(depth_lines) + "\n")
        with open(os.path.join(out_dir, "associations.txt"), "w") as f:
            f.write("\n".join(assoc_lines) + "\n")
    settings_path = os.path.join(out_dir, "settings.yaml")
    with open(settings_path, "w") as f:
        f.write(
            "%YAML:1.0\n"  # the reference-format directive
            f"Camera.fx: {fx}\nCamera.fy: {fx}\n"
            f"Camera.cx: {w / 2.0}\nCamera.cy: {h / 2.0}\n"
            "Camera.k1: 0.0\nCamera.k2: 0.0\n"
            "Camera.p1: 0.0\nCamera.p2: 0.0\nCamera.k3: 0.0\n"
            f"Camera.fps: {fps}\nCamera.RGB: 1\n"
            # bf = fx * baseline, which RGB-D and stereo need: the
            # close-point gate is depth < ThDepth * bf / fx
            f"Camera.bf: {0.15 * fx:.1f}\n"
            f"ORBextractor.nFeatures: {n_features}\n"
            "ORBextractor.scaleFactor: 1.2\nORBextractor.nLevels: 8\n"
            "ORBextractor.iniThFAST: 20\nORBextractor.minThFAST: 7\n"
            "ThDepth: 40.0\n"
            f"DepthMapFactor: {depth_factor}\n"
        )
    return settings_path, out_dir


def write_kitti_sequence(
    out_dir: str,
    n_frames: int = 120,
    h: int = 240,
    w: int = 320,
    fx: float = 260.0,
    baseline: float = 0.12,
    seed: int = 0,
    motion: str = "strafe",
    plane_half: float = 3.0,
    n_features: int = 600,
    fps: float = 10.0,
):
    """Write a synthetic stereo sequence in the KITTI odometry layout the
    reference stereo driver consumes (Examples/Stereo/stereo_kitti.cc
    LoadImages): ``image_0/`` + ``image_1/`` grayscale pairs,
    ``times.txt``, a ``poses.txt`` ground truth (3x4 T_wc rows, the KITTI
    devkit format), and a reference-format settings YAML with
    ``Camera.bf = fx * baseline``. Returns (settings_path, out_dir)."""
    import os

    from .image_io import write_png

    os.makedirs(os.path.join(out_dir, "image_0"), exist_ok=True)
    os.makedirs(os.path.join(out_dir, "image_1"), exist_ok=True)
    K3 = np.array([[fx, 0, w / 2.0], [0, fx, h / 2.0], [0, 0, 1.0]])
    tex = _texture(2048, seed)
    relief_tex = _texture(512, seed + 77)
    noise = 4.0
    rng_r = np.random.RandomState(seed + 979)
    stream = planar_stream(
        n_frames=n_frames, h=h, w=w, fx=fx, fy=fx, seed=seed, motion=motion,
        plane_half=plane_half, relief=True, noise=noise,
    )
    times, gt_rows = [], []
    for i, (img_l, T_cw) in enumerate(stream):
        img_r = render_plane(
            tex, stereo_right_pose(T_cw, baseline), K3, h, w,
            plane_half=plane_half, relief_tex=relief_tex,
            noise=noise, noise_rng=rng_r,
        )
        for sub, img in (("image_0", img_l), ("image_1", img_r)):
            write_png(os.path.join(out_dir, sub, f"{i:06d}.png"),
                      np.clip(img, 0, 255).astype(np.uint8))
        times.append(f"{i / fps:.6e}")
        R_wc = T_cw[:3, :3].T
        C = -R_wc @ T_cw[:3, 3]
        M = np.concatenate([R_wc, C[:, None]], axis=1)
        gt_rows.append(" ".join(f"{x:.9e}" for x in M.reshape(-1)))
    with open(os.path.join(out_dir, "times.txt"), "w") as f:
        f.write("\n".join(times) + "\n")
    with open(os.path.join(out_dir, "poses.txt"), "w") as f:
        f.write("\n".join(gt_rows) + "\n")
    settings_path = os.path.join(out_dir, "settings.yaml")
    with open(settings_path, "w") as f:
        f.write(
            "%YAML:1.0\n"
            f"Camera.fx: {fx}\nCamera.fy: {fx}\n"
            f"Camera.cx: {w / 2.0}\nCamera.cy: {h / 2.0}\n"
            "Camera.k1: 0.0\nCamera.k2: 0.0\n"
            "Camera.p1: 0.0\nCamera.p2: 0.0\n"
            f"Camera.fps: {fps}\nCamera.RGB: 1\n"
            f"Camera.bf: {baseline * fx:.4f}\n"
            f"ORBextractor.nFeatures: {n_features}\n"
            "ORBextractor.scaleFactor: 1.2\nORBextractor.nLevels: 8\n"
            "ORBextractor.iniThFAST: 20\nORBextractor.minThFAST: 7\n"
            "ThDepth: 40.0\n"
        )
    return settings_path, out_dir
