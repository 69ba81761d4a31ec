"""Reference-format settings files: the OpenCV-FileStorage YAML the
original system's example drivers read (``Camera.*``, ``ORBextractor.*``,
``ThDepth``, ``DepthMapFactor``, and EuRoC's ``LEFT.*`` / ``RIGHT.*``
rectification blocks).

Counterpart of the reference package's ``utils/config.py``. That one parses
with PyYAML; this one reads the subset of YAML that ``cv::FileStorage``
writes and reads itself, so that it needs no YAML package:

- the ``%YAML:1.0`` directive, ``---`` and ``#`` comments;
- ``key: value`` and ``key:value`` (EuRoC.yaml's ``data:[``);
- nested block mappings by indentation, ``!!opencv-matrix`` nodes among
  them (``rows``, ``cols``, ``dt``, ``data``);
- flow lists ``[...]`` that span lines;
- numbers and strings, plain or quoted.

A scalar is an ``int`` if it is a decimal integer, a ``float`` if it is a
decimal number (an exponent optional) or ``.inf`` / ``.nan``, else a
string: ``cv::FileStorage``'s rule. PyYAML
follows YAML 1.1 and reads some numbers as strings (``1e-5``, ``1.0e5``:
no dot or no exponent sign); on those the two loaders differ, and this one
follows ``cv::FileStorage``.

Rectification (``euroc_rectify_maps``) and the remap the stereo EuRoC driver
applies (``remap_bilinear``) follow OpenCV's ``initUndistortRectifyMap`` and
``remap(..., INTER_LINEAR)`` in numpy.
"""

from __future__ import annotations

import re

import numpy as np

from ..models.frontend import FrontendConfig

_INT = re.compile(r"[-+]?\d+\Z")
_FLOAT = re.compile(r"[-+]?((\d+\.?\d*|\.\d+)([eE][-+]?\d+)?|\.(inf|Inf|INF|nan|NaN|NAN))\Z")
_KEY = re.compile(r"([^:#\[\]{}]+?)\s*:\s*(.*)\Z")


def _scalar(text: str):
    text = text.strip()
    if len(text) >= 2 and text[0] == text[-1] and text[0] in "\"'":
        return text[1:-1]
    if _INT.match(text):
        return int(text)
    if _FLOAT.match(text):
        return float(text.replace(".", "", 1) if text[-1].isalpha() else text)  # .inf, .nan
    return text


def _strip_comment(line: str) -> str:
    quote = None
    for i, c in enumerate(line):
        if quote:
            quote = None if c == quote else quote
        elif c in "\"'":
            quote = c
        elif c == "#" and (i == 0 or line[i - 1].isspace()):
            return line[:i]
    return line


def _flow_list(text: str):
    body = text.strip()
    if not (body.startswith("[") and body.endswith("]")):
        raise ValueError(f"settings: not a flow list: {text!r}")
    inner = body[1:-1].strip()
    if not inner:
        return []
    if "[" in inner:
        raise ValueError(f"settings: nested flow lists are not supported: {text!r}")
    return [_scalar(x) for x in inner.split(",") if x.strip()]


def parse_settings(text: str) -> dict:
    """The mapping of an OpenCV-FileStorage YAML text (see the module's
    docstring for the subset read)."""
    lines = []
    for raw in text.splitlines():
        if raw.startswith("%") or raw.strip() in ("---", "..."):
            continue
        line = _strip_comment(raw).rstrip()
        if line.strip():
            lines.append((len(line) - len(line.lstrip(" ")), line.strip()))
    # join flow lists that span lines onto their key's line
    joined, i = [], 0
    while i < len(lines):
        ind, body = lines[i]
        while body.count("[") > body.count("]") and i + 1 < len(lines):
            i += 1
            body += " " + lines[i][1]
        joined.append((ind, body))
        i += 1

    root: dict = {}
    stack = [(-1, root)]  # (indent of the mapping's keys' parent, mapping)
    for ind, body in joined:
        m = _KEY.match(body)
        if not m:
            raise ValueError(f"settings: cannot read line {body!r}")
        key, value = m.group(1).strip(), m.group(2).strip()
        while ind <= stack[-1][0]:
            stack.pop()
        parent = stack[-1][1]
        if value.startswith("!!"):  # a tag (!!opencv-matrix): the node follows
            value = value.split(None, 1)[1] if " " in value else ""
        if not value:
            node: dict = {}
            parent[key] = node
            stack.append((ind, node))
        elif value.startswith("["):
            parent[key] = _flow_list(value)
        else:
            parent[key] = _scalar(value)
    return root


def load_settings(path: str) -> dict:
    with open(path) as f:
        return parse_settings(f.read())


def opencv_matrix(settings: dict, key: str):
    """An OpenCV-matrix node as a float64 numpy array (``cv::FileStorage``
    ``>>``), or None where the settings lack ``key``."""
    node = settings.get(key)
    if node is None:
        return None
    return np.asarray(node["data"], np.float64).reshape(int(node["rows"]), int(node["cols"]))


def undistort_rectify_map(K, D, R, P, size):
    """``cv2.initUndistortRectifyMap(K, D, R, P, size, CV_32FC1)`` in numpy:
    for each pixel of the rectified image, the source pixel (map_x, map_y)
    as float32 [H, W] each. Computed in float64 as OpenCV does: the pixel
    ray through ``(P R)^-1``, the radial-tangential distortion (k1, k2,
    p1, p2, k3), then ``K``."""
    w, h = size
    K = np.asarray(K, np.float64)
    d = np.zeros(5)
    dd = np.asarray(D, np.float64).reshape(-1)
    d[:len(dd)] = dd[:5]
    k1, k2, p1, p2, k3 = d
    iR = np.linalg.inv(np.asarray(P, np.float64)[:3, :3] @ np.asarray(R, np.float64))
    jj, ii = np.meshgrid(np.arange(w, dtype=np.float64), np.arange(h, dtype=np.float64))
    X = jj * iR[0, 0] + ii * iR[0, 1] + iR[0, 2]
    Y = jj * iR[1, 0] + ii * iR[1, 1] + iR[1, 2]
    Wh = jj * iR[2, 0] + ii * iR[2, 1] + iR[2, 2]
    x, y = X / Wh, Y / Wh
    x2, y2 = x * x, y * y
    r2 = x2 + y2
    xy2 = 2 * x * y
    kr = 1 + ((k3 * r2 + k2) * r2 + k1) * r2
    u = K[0, 0] * (x * kr + p1 * xy2 + p2 * (r2 + 2 * x2)) + K[0, 2]
    v = K[1, 1] * (y * kr + p1 * (r2 + 2 * y2) + p2 * xy2) + K[1, 2]
    return u.astype(np.float32), v.astype(np.float32)


def euroc_rectify_maps(settings: dict):
    """Stereo rectification maps from the LEFT.* / RIGHT.* blocks (the
    original system's stereo EuRoC driver rectifies each pair with them
    before tracking). Returns ((map_x_l, map_y_l), (map_x_r, map_y_r)), or
    None if the settings carry no blocks."""
    K_l, K_r = opencv_matrix(settings, "LEFT.K"), opencv_matrix(settings, "RIGHT.K")
    if K_l is None or K_r is None:
        return None
    out = []
    for side, K in (("LEFT", K_l), ("RIGHT", K_r)):
        size = (int(settings[f"{side}.width"]), int(settings[f"{side}.height"]))
        out.append(undistort_rectify_map(
            K, opencv_matrix(settings, f"{side}.D"), opencv_matrix(settings, f"{side}.R"),
            opencv_matrix(settings, f"{side}.P"), size))
    return tuple(out)


def _lerp(a, b, t):
    """``a + t * (b - a)`` in float32 with the product and the sum fused, as
    OpenCV's vectorized remap computes it (float64 holds the product
    exactly)."""
    return (t.astype(np.float64) * (b - a) + a).astype(np.float32)


def remap_bilinear(img, map_x, map_y):
    """``cv2.remap(img, map_x, map_y, INTER_LINEAR)`` (a constant border of 0)
    for a single-channel float32 image, as OpenCV 4.11 and later compute it:
    the source coordinates taken as they are, a fused linear interpolation
    along x in the two rows and then along y, neighbours outside the image
    reading 0 (OpenCV 4.10 and earlier rounded each coordinate to 1/32 px
    first). Returns float32 [H, W] of the maps' shape."""
    src = np.asarray(img, np.float32)
    h, w = src.shape
    mx, my = np.asarray(map_x, np.float32), np.asarray(map_y, np.float32)
    fx, fy = np.floor(mx), np.floor(my)
    ax, ay = mx - fx, my - fy
    # one pixel of border all round; coordinates further out read it too
    padded = np.zeros((h + 2, w + 2), np.float32)
    padded[1:-1, 1:-1] = src
    fx = np.clip(fx, -2, w).astype(np.int64)
    fy = np.clip(fy, -2, h).astype(np.int64)
    x0, x1 = np.clip(fx + 1, 0, w + 1), np.clip(fx + 2, 0, w + 1)
    y0, y1 = np.clip(fy + 1, 0, h + 1), np.clip(fy + 2, 0, h + 1)
    top = _lerp(padded[y0, x0], padded[y0, x1], ax)
    bottom = _lerp(padded[y1, x0], padded[y1, x1], ax)
    return _lerp(top, bottom, ay)


def frontend_config_from_settings(settings: dict, height: int, width: int) -> FrontendConfig:
    g = settings.get
    return FrontendConfig(
        height=height,
        width=width,
        n_features=int(g("ORBextractor.nFeatures", 1000)),
        n_levels=int(g("ORBextractor.nLevels", 8)),
        scale_factor=float(g("ORBextractor.scaleFactor", 1.2)),
        th_fast=float(g("ORBextractor.iniThFAST", 20)),
        th_fast_min=float(g("ORBextractor.minThFAST", 7)),
        fx=float(g("Camera.fx", 500.0)),
        fy=float(g("Camera.fy", 500.0)),
        cx=float(g("Camera.cx", width / 2)),
        cy=float(g("Camera.cy", height / 2)),
        k1=float(g("Camera.k1", 0.0)),
        k2=float(g("Camera.k2", 0.0)),
        p1=float(g("Camera.p1", 0.0)),
        p2=float(g("Camera.p2", 0.0)),
        k3=float(g("Camera.k3", 0.0)),
        bf=float(g("Camera.bf", 0.0)),
        depth_th=float(g("ThDepth", 40.0)),
    )


def camera_fps(settings: dict) -> float:
    return float(settings.get("Camera.fps", 30.0))


def depth_map_factor(settings: dict) -> float:
    f = float(settings.get("DepthMapFactor", 1.0))
    return 1.0 / f if abs(f) > 1e-5 else 1.0
