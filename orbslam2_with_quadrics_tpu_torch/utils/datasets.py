"""Dataset listers: TUM RGB-D, KITTI odometry, EuRoC (mono and stereo).

Counterpart of the reference package's ``utils/datasets.py``: the listers
follow the original system's example drivers (``LoadImages`` of mono_tum,
stereo_kitti, mono_euroc, stereo_euroc; the RGB-D association files), so
the same on-disk layouts work unchanged, plus the offline object-detection
reader of the quadric extension (``read_obj_detection_txt``). Images are
decoded by ``utils/image_io`` (the native loader, else ``cv2``, else
``PIL``) where the reference calls ``cv2``.
"""

from __future__ import annotations

import os

import numpy as np

from . import image_io


def load_tum_rgb_list(seq_dir: str, fname: str = "rgb.txt"):
    """Parse TUM rgb.txt / depth.txt: lines 'timestamp path'."""
    out = []
    with open(os.path.join(seq_dir, fname)) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            ts, path = line.split()[:2]
            out.append((float(ts), os.path.join(seq_dir, path)))
    return out


def load_tum_associations(seq_dir: str, assoc_file: str):
    """RGB-D association file: 'ts_rgb rgb ts_depth depth' per line
    (reference Examples/RGB-D/associations/)."""
    out = []
    with open(assoc_file) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            p = line.split()
            out.append(
                (float(p[0]), os.path.join(seq_dir, p[1]), os.path.join(seq_dir, p[3]))
            )
    return out


def load_kitti_stereo(seq_dir: str):
    """KITTI odometry layout: image_0/, image_1/, times.txt
    (reference Examples/Stereo/stereo_kitti.cc LoadImages)."""
    times = np.loadtxt(os.path.join(seq_dir, "times.txt"))
    lefts, rights = [], []
    for i in range(len(times)):
        lefts.append(os.path.join(seq_dir, "image_0", f"{i:06d}.png"))
        rights.append(os.path.join(seq_dir, "image_1", f"{i:06d}.png"))
    return times, lefts, rights


def load_euroc_mono(seq_dir: str, cam: str = "cam0"):
    """EuRoC MAV layout: mav0/cam0/data.csv + data/<ts>.png
    (reference Examples/Monocular/mono_euroc.cc LoadImages)."""
    import csv

    base = os.path.join(seq_dir, "mav0", cam)
    out = []
    with open(os.path.join(base, "data.csv")) as f:
        for row in csv.reader(f):
            if not row or row[0].startswith("#"):
                continue
            ts_ns, fname = row[0], row[1].strip()
            out.append((float(ts_ns) * 1e-9, os.path.join(base, "data", fname)))
    return out


def load_kitti_mono(seq_dir: str):
    """KITTI odometry grayscale-left layout: image_0/, times.txt
    (reference Examples/Monocular/mono_kitti.cc LoadImages)."""
    times = np.loadtxt(os.path.join(seq_dir, "times.txt"))
    paths = [
        os.path.join(seq_dir, "image_0", f"{i:06d}.png")
        for i in range(len(times))
    ]
    return times, paths


def load_euroc_stereo(seq_dir: str):
    """EuRoC MAV stereo: cam0/cam1 share hardware-synced timestamps
    (reference Examples/Stereo/stereo_euroc.cc LoadImages). Returns
    (times, left_paths, right_paths) for frames present in both cameras."""
    left = load_euroc_mono(seq_dir, cam="cam0")
    right = load_euroc_mono(seq_dir, cam="cam1")
    rmap = {round(ts, 6): p for ts, p in right}
    times, lefts, rights = [], [], []
    for ts, p in left:
        rp = rmap.get(round(ts, 6))
        if rp is not None:
            times.append(ts)
            lefts.append(p)
            rights.append(rp)
    return np.asarray(times), lefts, rights


def load_gray(path: str) -> np.ndarray:
    """uint8 grey [H, W] (the camera's own dtype: ``System`` uploads it as it
    is and casts on the device)."""
    return np.clip(np.rint(image_io.load_gray(path)), 0, 255).astype(np.uint8)


def load_depth_tum(path: str, factor: float = 1.0 / 5000.0) -> np.ndarray:
    """float32 depth in metres of a 16-bit TUM depth PNG."""
    return image_io.load_raw16(path).astype(np.float32) * factor


def read_obj_detection_txt(path: str, n_cols: int = 6) -> np.ndarray:
    """Offline per-frame detections: rows of (x, y, w, h, prob, class)
    — the quadric extension's input format
    (src/quadric_slam/matrix_utils.cc:287-333)."""
    rows = []
    with open(path) as f:
        for line in f:
            parts = line.split()
            if len(parts) >= n_cols:
                rows.append([float(x) for x in parts[:n_cols]])
    return np.asarray(rows, np.float32).reshape(-1, n_cols)


def load_tum_groundtruth(seq_dir: str):
    """groundtruth.txt: 'ts tx ty tz qx qy qz qw' -> [(ts, T_wc 4x4)]."""
    out = []
    with open(os.path.join(seq_dir, "groundtruth.txt")) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            v = [float(x) for x in line.split()]
            ts, tx, ty, tz, qx, qy, qz, qw = v[:8]
            R = _quat_to_R(qw, qx, qy, qz)
            T = np.eye(4)
            T[:3, :3] = R
            T[:3, 3] = [tx, ty, tz]
            out.append((ts, T))
    return out


def _quat_to_R(w, x, y, z):
    n = np.sqrt(w * w + x * x + y * y + z * z)
    w, x, y, z = w / n, x / n, y / n, z / n
    return np.array(
        [
            [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
            [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
            [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
        ]
    )
