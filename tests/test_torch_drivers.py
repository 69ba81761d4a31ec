"""The port's drivers against the reference package: settings files, image
decoding, dataset listers, the sequence writers, ``viz``, the example
drivers and ``eval_full``.

On the CPU, with one PyTorch thread (module fixture; whole-System runs, see
``tests/test_torch_capacity.py``). Inputs are the settings texts of
``tests/test_utils.py`` (copied), a KITTI00-02-style text, the stock EuRoC
stereo calibration, and sequences made from seeds.

- Settings: the port's reader (no PyYAML) gives the reference loader's dict
  on every text, and the same ``FrontendConfig`` field by field. Where YAML
  1.1 and ``cv::FileStorage`` disagree (``1e-5``, no dot) the port follows
  ``cv::FileStorage`` and reads a number; the reference reads a string.
- Rectification maps against the reference's (``cv2``) on the stock EuRoC
  calibration at 752x480: measured max abs difference 0.0 px (bar 1e-3).
- ``remap_bilinear`` against ``cv2.remap(INTER_LINEAR)`` on a float32
  image, maps inside and outside the image: measured 0.0 grey levels with
  OpenCV 5.0.0 (bar 1e-4).
- Decoders: every decoder of the port equals the reference's native loader
  and ``cv2.imread`` on 8-bit PNG, 16-bit PNG and PGM; on JPEG the port's
  native loader equals the reference's (the same source).
- Writers: text files byte-equal to the reference's; PNG pixels within 1
  grey level, differing in at most 0.028% of the pixels (measured; bar
  0.1%): the renderers agree to about 1e-3 grey levels before rounding.
- ``draw_frame`` / ``draw_map`` bit-equal to the reference's.
- ``mono_tum.main(device="cpu")`` on a 40-frame 320x240 sequence writes the
  trajectory a directly driven ``System`` gives on the same frames, under
  5% ATE. The drivers' map pools (512 keyframes, 65,536 points) take about
  3 minutes of CPU for 40 frames, so the test sets them to 24 / 2,048 (the
  point pool then doubles once, through the driver); the card runs the
  drivers at their own pools (``chip_smoke.py``).
- ``eval_full --device cpu`` at 30 frames emits every key of the
  reference's ``EVAL_r05.json``.
- Slow twins of ``tests/test_drivers.py`` (110 frames, the drivers' own
  pools, through ``python -m``).
"""

import dataclasses
import filecmp
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from orbslam2_with_quadrics_tpu.utils import config as jconfig
from orbslam2_with_quadrics_tpu.utils import datasets as jdatasets
from orbslam2_with_quadrics_tpu.utils import synthetic as jsynthetic
from orbslam2_with_quadrics_tpu_torch.examples import common, mono_tum
from orbslam2_with_quadrics_tpu_torch.models import map_state as ms
from orbslam2_with_quadrics_tpu_torch.models import system as sysm
from orbslam2_with_quadrics_tpu_torch.scripts import eval_full
from orbslam2_with_quadrics_tpu_torch.utils import config, datasets, image_io, metrics
from orbslam2_with_quadrics_tpu_torch.utils import synthetic, trajectory

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

TUM1_YAML = """\
%YAML:1.0
Camera.fx: 517.306408
Camera.fy: 516.469215
Camera.cx: 318.643040
Camera.cy: 255.313989
Camera.k1: 0.262383
Camera.k2: -0.953104
Camera.p1: -0.005358
Camera.p2: 0.002628
Camera.k3: 1.163314
Camera.fps: 30.0
Camera.RGB: 1
ORBextractor.nFeatures: 1000
ORBextractor.scaleFactor: 1.2
ORBextractor.nLevels: 8
ORBextractor.iniThFAST: 20
ORBextractor.minThFAST: 7
DepthMapFactor: 5000.0
"""

EUROC_BLOCK = """%YAML:1.0
Camera.fps: 20.0
Viewer.PointSize:2
LEFT.height: 4
LEFT.width: 6
LEFT.D: !!opencv-matrix
   rows: 1
   cols: 5
   dt: d
   data:[-0.28, 0.07, 0.0, 0.0, 0.0]
LEFT.K: !!opencv-matrix
   rows: 3
   cols: 3
   dt: d
   data: [458.654, 0.0, 3.0, 0.0, 457.296, 2.0, 0.0, 0.0, 1.0]
LEFT.R: !!opencv-matrix
   rows: 3
   cols: 3
   dt: d
   data: [1.0, 0.0, 0.0, 0.0, 1.0, 0.0, 0.0, 0.0, 1.0]
LEFT.P: !!opencv-matrix
   rows: 3
   cols: 4
   dt: d
   data: [435.2, 0, 3.0, 0, 0, 435.2, 2.0, 0, 0, 0, 1, 0]
RIGHT.height: 4
RIGHT.width: 6
RIGHT.D: !!opencv-matrix
   rows: 1
   cols: 5
   dt: d
   data:[-0.28, 0.07, 0.0, 0.0, 0.0]
RIGHT.K: !!opencv-matrix
   rows: 3
   cols: 3
   dt: d
   data: [457.6, 0.0, 3.0, 0.0, 456.1, 2.0, 0.0, 0.0, 1.0]
RIGHT.R: !!opencv-matrix
   rows: 3
   cols: 3
   dt: d
   data: [1.0, 0.0, 0.0, 0.0, 1.0, 0.0, 0.0, 0.0, 1.0]
RIGHT.P: !!opencv-matrix
   rows: 3
   cols: 4
   dt: d
   data: [435.2, 0, 3.0, -47.9, 0, 435.2, 2.0, 0, 0, 0, 1, 0]
"""

KITTI_YAML = """%YAML:1.0

#--------------------------------------------------------------------------------------------
# Camera Parameters. Adjust them!
#--------------------------------------------------------------------------------------------

# Camera calibration and distortion parameters (OpenCV)
Camera.fx: 718.856
Camera.fy: 718.856
Camera.cx: 607.1928
Camera.cy: 185.2157

Camera.k1: 0.0
Camera.k2: 0.0
Camera.p1: 0.0
Camera.p2: 0.0

Camera.width: 1241
Camera.height: 376

# Camera frames per second
Camera.fps: 10.0

# stereo baseline times fx
Camera.bf: 386.1448

# Color order of the images (0: BGR, 1: RGB. It is ignored if images are grayscale)
Camera.RGB: 1

# Close/Far threshold. Baseline times.
ThDepth: 35

# ORB Extractor: Number of features per image
ORBextractor.nFeatures: 2000
ORBextractor.scaleFactor: 1.2
ORBextractor.nLevels: 8
ORBextractor.iniThFAST: 20
ORBextractor.minThFAST: 7

Viewer.KeyFrameSize: 0.6
Viewer.KeyFrameLineWidth: 2
Viewer.PointSize:2
Viewer.ViewpointY: -100
Viewer.ViewpointZ: -0.1
Viewer.ViewpointF: 2000
"""

# the stock EuRoC stereo calibration (the original system's EuRoC.yaml)
EUROC_FULL = """%YAML:1.0
Camera.fx: 435.2046959714599
Camera.fy: 435.2046959714599
Camera.cx: 367.4517211914062
Camera.cy: 252.2008514404297
Camera.k1: 0.0
Camera.k2: 0.0
Camera.p1: 0.0
Camera.p2: 0.0
Camera.width: 752
Camera.height: 480
Camera.fps: 20.0
Camera.bf: 47.90639384423901
Camera.RGB: 1
ThDepth: 35
LEFT.height: 480
LEFT.width: 752
LEFT.D: !!opencv-matrix
   rows: 1
   cols: 5
   dt: d
   data:[-0.28340811, 0.07395907, 0.00019359, 1.76187114e-05, 0.0]
LEFT.K: !!opencv-matrix
   rows: 3
   cols: 3
   dt: d
   data: [458.654, 0.0, 367.215, 0.0, 457.296, 248.375, 0.0, 0.0, 1.0]
LEFT.R:  !!opencv-matrix
   rows: 3
   cols: 3
   dt: d
   data: [0.999966347530033, -0.001422739138722922, 0.008079580483432283,
          0.001365741834644127, 0.9999741760894847, 0.007055629199258132,
          -0.008089410156878961, -0.007044357138835809, 0.9999424675829176]
LEFT.P:  !!opencv-matrix
   rows: 3
   cols: 4
   dt: d
   data: [435.2046959714599, 0, 367.4517211914062, 0,  0, 435.2046959714599, 252.2008514404297, 0,  0, 0, 1, 0]
RIGHT.height: 480
RIGHT.width: 752
RIGHT.D: !!opencv-matrix
   rows: 1
   cols: 5
   dt: d
   data:[-0.28368365, 0.07451284, -0.00010473, -3.555907e-05, 0.0]
RIGHT.K: !!opencv-matrix
   rows: 3
   cols: 3
   dt: d
   data: [457.587, 0.0, 379.999, 0.0, 456.134, 255.238, 0.0, 0.0, 1]
RIGHT.R:  !!opencv-matrix
   rows: 3
   cols: 3
   dt: d
   data: [0.9999633526194376, -0.003625811871560086, 0.007755443660172947, 0.003680398547259526, 0.9999684752771629, -0.007035845251224894, -0.007729688520722713, 0.007064130529506649, 0.999945173484644]
RIGHT.P:  !!opencv-matrix
   rows: 3
   cols: 4
   dt: d
   data: [435.2046959714599, 0, 367.4517211914062, -47.90639384423901, 0, 435.2046959714599, 252.2008514404297, 0, 0, 0, 1, 0]
ORBextractor.nFeatures: 1200
ORBextractor.scaleFactor: 1.2
ORBextractor.nLevels: 8
ORBextractor.iniThFAST: 20
ORBextractor.minThFAST: 7
"""

SETTINGS = {"TUM1": TUM1_YAML, "EuRoC_block": EUROC_BLOCK, "KITTI00-02": KITTI_YAML,
            "EuRoC": EUROC_FULL}


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread while this file runs, restored afterwards."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def write(tmp_path, name, text):
    p = tmp_path / name
    p.write_text(text)
    return str(p)


# ---------------------------------------------------------------- settings


@pytest.mark.parametrize("name", sorted(SETTINGS))
def test_settings_equal_reference(tmp_path, name):
    path = write(tmp_path, name + ".yaml", SETTINGS[name])
    got, ref = config.load_settings(path), jconfig.load_settings(path)
    assert got == ref
    assert {k: type(v) for k, v in got.items()} == {k: type(v) for k, v in ref.items()}
    fc = config.frontend_config_from_settings(got, 480, 640)
    jfc = jconfig.frontend_config_from_settings(ref, 480, 640)
    assert dataclasses.asdict(fc) == dataclasses.asdict(jfc)
    assert config.camera_fps(got) == jconfig.camera_fps(ref)
    assert config.depth_map_factor(got) == jconfig.depth_map_factor(ref)
    for key in ("LEFT.K", "LEFT.D", "LEFT.R", "LEFT.P", "RIGHT.P"):
        a, b = config.opencv_matrix(got, key), jconfig.opencv_matrix(ref, key)
        assert (a is None and b is None) or (a.dtype == b.dtype and np.array_equal(a, b))


def test_settings_numbers_follow_filestorage():
    """``1e-5`` (no dot) and ``1.0e5`` (no exponent sign) are strings to
    YAML 1.1 (PyYAML) and numbers to ``cv::FileStorage``: the port reads
    numbers. ``float()`` of the reference's strings gives the same config."""
    text = "%YAML:1.0\nCamera.k1: 1e-5\nCamera.fx: 5.2e2\nORBextractor.nFeatures: 1000\n" \
           "Camera.bf: 1.0e2\nName: \"cam # 0\" # a comment\n"
    got = config.parse_settings(text)
    assert got == {"Camera.k1": 1e-5, "Camera.fx": 520.0, "ORBextractor.nFeatures": 1000,
                   "Camera.bf": 100.0, "Name": "cam # 0"}
    import yaml

    ref = yaml.safe_load(text.replace("%YAML:1.0\n", ""))
    assert ref["Camera.k1"] == "1e-5" and ref["Camera.bf"] == "1.0e2"
    fc = config.frontend_config_from_settings(got, 480, 640)
    assert fc == config.frontend_config_from_settings(ref, 480, 640)


def test_rectify_maps_match_reference(tmp_path):
    """The stock EuRoC calibration at 752x480 (measured: 0.0 px)."""
    path = write(tmp_path, "EuRoC.yaml", EUROC_FULL)
    got = config.euroc_rectify_maps(config.load_settings(path))
    ref = jconfig.euroc_rectify_maps(jconfig.load_settings(path))
    for (gx, gy), (rx, ry) in zip(got, ref):
        assert gx.shape == rx.shape == (480, 752) and gx.dtype == rx.dtype == np.float32
        assert max(np.abs(gx - rx).max(), np.abs(gy - ry).max()) <= 1e-3
    assert config.euroc_rectify_maps({"Camera.fps": 20}) is None


def test_remap_matches_opencv(tmp_path):
    """cv2.remap(INTER_LINEAR) on a float32 image, the EuRoC maps and maps
    that reach outside the image (measured: 0.0 with OpenCV 5.0.0)."""
    cv2 = pytest.importorskip("cv2")
    path = write(tmp_path, "EuRoC.yaml", EUROC_FULL)
    (mx, my), _ = config.euroc_rectify_maps(config.load_settings(path))
    rng = np.random.RandomState(0)
    img = (rng.rand(480, 752) * 255).astype(np.float32)
    wide = ((rng.rand(480, 752) * 900 - 80).astype(np.float32),
            (rng.rand(480, 752) * 700 - 100).astype(np.float32))
    for bx, by in ((mx, my), wide):
        ref = cv2.remap(img, bx, by, cv2.INTER_LINEAR)
        got = config.remap_bilinear(img, bx, by)
        assert got.dtype == np.float32 and np.abs(got - ref).max() <= 1e-4


# ------------------------------------------------------------------ images


def _image_files(tmp_path):
    cv2 = pytest.importorskip("cv2")
    rng = np.random.RandomState(7)
    a8 = (rng.rand(37, 53) * 255).astype(np.uint8)
    a16 = (rng.rand(37, 53) * 65535).astype(np.uint16)
    files = {"png8": str(tmp_path / "a8.png"), "png16": str(tmp_path / "a16.png"),
             "pgm": str(tmp_path / "a.pgm"), "jpg": str(tmp_path / "a.jpg")}
    image_io.write_png(files["png8"], a8)
    image_io.write_png(files["png16"], a16)
    cv2.imwrite(files["pgm"], a8)
    cv2.imwrite(files["jpg"], (rng.rand(37, 53, 3) * 255).astype(np.uint8))
    return files


@pytest.mark.parametrize("fmt", ["png8", "png16", "pgm", "jpg"])
def test_decoders_equal_reference(tmp_path, fmt):
    cv2 = pytest.importorskip("cv2")
    from orbslam2_with_quadrics_tpu.native import AsyncImageLoader as RefLoader

    path = _image_files(tmp_path)[fmt]
    with RefLoader([path]) as it:
        ref_gray, ref_raw = next(it)
    got = {u: image_io.decode(path, using=u) for u in image_io.DECODERS}
    gray, raw = got["native"]
    assert np.array_equal(gray, ref_gray)
    assert (raw is None) == (ref_raw is None) and (raw is None or np.array_equal(raw, ref_raw))
    if fmt == "jpg":  # a colour JPEG: libjpeg's own luma; the others differ
        return
    im = cv2.imread(path, cv2.IMREAD_UNCHANGED)
    for u, (g, r) in got.items():
        assert g.dtype == np.float32 and np.array_equal(g, im.astype(np.float32)), u
        assert (r is None) == (fmt != "png16") and (r is None or np.array_equal(r, im)), u
    if fmt == "png16":
        assert np.array_equal(image_io.load_raw16(path), im)
        assert np.array_equal(datasets.load_depth_tum(path), jdatasets.load_depth_tum(path))
    else:
        assert np.array_equal(datasets.load_gray(path), jdatasets.load_gray(path))


@pytest.mark.parametrize("using", image_io.DECODERS)
def test_async_loader_in_order(tmp_path, using):
    files = _image_files(tmp_path)
    paths = [files[k] for k in ("png8", "png16", "pgm")] * 5
    with image_io.AsyncImageLoader(paths, n_threads=3, capacity=4, using=using) as it:
        out = list(it)
    assert len(out) == len(paths)
    for p, (g, r) in zip(paths, out):
        ref_g, ref_r = image_io.decode(p, using="native")
        assert np.array_equal(g, ref_g) and (r is None) == (ref_r is None)
    with pytest.raises((ValueError, FileNotFoundError)):
        with image_io.AsyncImageLoader([paths[0], str(tmp_path / "missing.png")],
                                       using=using) as it:
            list(it)


def test_decoder_choice_and_none(monkeypatch):
    """The native loader first; where it cannot build, cv2 with the reason;
    with no decoder at all, an error (no silent fallback)."""
    image_io.decoder.cache_clear()
    try:
        assert image_io.decoder().name == "native"

        def no_native():
            raise RuntimeError("g++ not found")

        monkeypatch.setattr(image_io, "_lib", no_native)
        image_io.decoder.cache_clear()
        d = image_io.decoder()
        assert d.name == "cv2" and "g++ not found" in d.why
        monkeypatch.setattr(image_io.importlib.util, "find_spec", lambda name: None)
        image_io.decoder.cache_clear()
        with pytest.raises(RuntimeError, match="no image decoder"):
            image_io.decoder()
    finally:
        monkeypatch.undo()
        image_io.decoder.cache_clear()


# ----------------------------------------------------------------- listers


def _euroc_layout(root, stamps=((1, 2, 3), (2, 3, 4))):
    for cam, ts in zip(("cam0", "cam1"), stamps):
        (root / "mav0" / cam / "data").mkdir(parents=True)
        with open(root / "mav0" / cam / "data.csv", "w") as f:
            f.write("#timestamp [ns],filename\n")
            for t in ts:
                f.write(f"{t}000000000,{t}.png\n")
    return str(root)


LISTERS = ["tum_rgb", "tum_depth", "associations", "kitti_stereo", "kitti_mono",
           "euroc_mono", "euroc_stereo", "groundtruth", "detections"]


@pytest.fixture(scope="module")
def layouts(tmp_path_factory):
    root = tmp_path_factory.mktemp("layouts")
    tum = str(root / "tum")
    synthetic.write_tum_sequence(tum, n_frames=6, h=48, w=64, fx=50.0, sensor="rgbd")
    kitti = str(root / "kitti")
    synthetic.write_kitti_sequence(kitti, n_frames=6, h=48, w=64, fx=50.0)
    euroc = _euroc_layout(root / "euroc")
    det = root / "det.txt"
    det.write_text("10 20 30 40 0.9 3\n1 2 3\n5.5 6 7 8 0.5 1 extra\n")
    return {"tum": tum, "kitti": kitti, "euroc": euroc, "det": str(det)}


@pytest.mark.parametrize("lister", LISTERS)
def test_listers_equal_reference(layouts, lister):
    tum, kitti, euroc = layouts["tum"], layouts["kitti"], layouts["euroc"]
    calls = {
        "tum_rgb": lambda m: m.load_tum_rgb_list(tum),
        "tum_depth": lambda m: m.load_tum_rgb_list(tum, "depth.txt"),
        "associations": lambda m: m.load_tum_associations(
            tum, os.path.join(tum, "associations.txt")),
        "kitti_stereo": lambda m: m.load_kitti_stereo(kitti),
        "kitti_mono": lambda m: m.load_kitti_mono(kitti),
        "euroc_mono": lambda m: m.load_euroc_mono(euroc, cam="cam1"),
        "euroc_stereo": lambda m: m.load_euroc_stereo(euroc),
        "groundtruth": lambda m: m.load_tum_groundtruth(tum),
        "detections": lambda m: m.read_obj_detection_txt(layouts["det"]),
    }
    got, ref = calls[lister](datasets), calls[lister](jdatasets)

    def same(a, b):
        if isinstance(a, (list, tuple)):
            return type(a) is type(b) and len(a) == len(b) and all(map(same, a, b))
        if isinstance(a, np.ndarray):
            return a.dtype == b.dtype and np.array_equal(a, b)
        return a == b

    assert same(got, ref)
    if lister == "euroc_stereo":
        np.testing.assert_allclose(got[0], [2.0, 3.0])  # the stamps both cameras share


# ----------------------------------------------------------------- writers


@pytest.mark.parametrize("kind", ["mono", "rgbd", "kitti"])
def test_writers_match_reference(tmp_path, kind):
    cv2 = pytest.importorskip("cv2")
    dirs = {}
    for tag, mod in (("port", synthetic), ("ref", jsynthetic)):
        d = str(tmp_path / tag)
        if kind == "kitti":
            s, _ = mod.write_kitti_sequence(d, n_frames=8, h=240, w=320, seed=5)
        else:
            s, _ = mod.write_tum_sequence(d, n_frames=8, h=240, w=320, seed=1, sensor=kind)
        assert s == os.path.join(d, "settings.yaml")
        dirs[tag] = d
    n_files = n_png = 0
    for root, _, files in os.walk(dirs["ref"]):
        for f in files:
            ref = os.path.join(root, f)
            got = ref.replace(dirs["ref"], dirs["port"], 1)
            n_files += 1
            if not f.endswith(".png"):
                assert filecmp.cmp(got, ref, shallow=False), f
                continue
            n_png += 1
            a = cv2.imread(got, cv2.IMREAD_UNCHANGED)
            b = cv2.imread(ref, cv2.IMREAD_UNCHANGED)
            assert a.dtype == b.dtype and a.shape == b.shape
            diff = np.abs(a.astype(np.int64) - b.astype(np.int64))
            assert diff.max() <= 1 and (diff > 0).mean() <= 1e-3, (f, diff.max(),
                                                                   (diff > 0).mean())
    assert n_png == {"mono": 8, "rgbd": 16, "kitti": 16}[kind]
    assert sum(len(fs) for _, _, fs in os.walk(dirs["port"])) == n_files


@pytest.mark.parametrize("size", [4000, 6000])
def test_texture_equals_reference_at_any_size(size):
    """``eval_full``'s textures (2 * plane_half * 250 px) are not a
    multiple of the coarse layers' sizes."""
    assert np.array_equal(synthetic._texture(size, 3), jsynthetic._texture(size, 3))


# --------------------------------------------------------------------- viz


def test_viz_equals_reference(tmp_path):
    pytest.importorskip("cv2")
    import jax.numpy as jnp

    from orbslam2_with_quadrics_tpu.models import frontend as jfe
    from orbslam2_with_quadrics_tpu.models import map_state as jms
    from orbslam2_with_quadrics_tpu.models.quadric_mapping import QuadricLandmark
    from orbslam2_with_quadrics_tpu.utils import viz as jviz
    from orbslam2_with_quadrics_tpu_torch.models import frontend as fe
    from orbslam2_with_quadrics_tpu_torch.utils import viz

    n = 32
    rng = np.random.RandomState(0)
    uv = (rng.rand(n, 2) * 100).astype(np.float32)
    valid = rng.rand(n) > 0.2
    obs = np.full(n, -1, np.int32)
    obs[:5] = 1
    img = np.random.RandomState(1).rand(120, 160) * 255

    def feats(pkg, arr):
        z = lambda *shape: arr.zeros(shape)  # noqa: E731
        return pkg.FrameFeatures(uv=arr.asarray(uv), uv_und=z(n, 2), level=z(n), angle=z(n),
                                 score=z(n), desc=z(n, 8), valid=arr.asarray(valid), ur=z(n),
                                 depth=z(n))

    got = viz.draw_frame(img, feats(fe, torch), torch.as_tensor(obs), "KFs: 3, MPs: 100")
    ref = jviz.draw_frame(img, feats(jfe, jnp), jnp.asarray(obs), "KFs: 3, MPs: 100")
    assert got.shape == (120, 160, 3) and np.array_equal(got, ref)

    pts = np.random.RandomState(2).rand(10, 3).astype(np.float32)
    m = ms.empty_map(ms.MapConfig(max_keyframes=4, max_points=64, n_features=n, n_levels=2,
                                  device="cpu"))
    m = m._replace(pt_pos=m.pt_pos.index_put((torch.arange(10),), torch.as_tensor(pts)),
                   pt_valid=m.pt_valid.index_fill(0, torch.arange(10), True),
                   kf_valid=m.kf_valid.index_fill(0, torch.tensor([0]), True))
    jm = jms.empty_map(jms.MapConfig(max_keyframes=4, max_points=64, n_features=n, n_levels=2))
    jm = jm._replace(pt_pos=jm.pt_pos.at[:10].set(pts), pt_valid=jm.pt_valid.at[:10].set(True),
                     kf_valid=jm.kf_valid.at[0].set(True))
    lm = QuadricLandmark(class_id=1, kf_slots=[0], bboxes=[], point_ids=set(), initialized=True,
                         pose=np.array([1, 0, 0, 0, 0.5, 0.5, 0.2]),
                         scale=np.array([0.2, 0.1, 0.1]))
    got, ref = viz.draw_map(m, [lm]), jviz.draw_map(jm, [lm])
    assert got.shape == (800, 800, 3) and np.array_equal(got, ref)
    viz.save_metrics_jsonl(str(tmp_path / "m.jsonl"), [{"frame": 1, "inliers": 7}])
    jviz.save_metrics_jsonl(str(tmp_path / "r.jsonl"), [{"frame": 1, "inliers": 7}])
    assert filecmp.cmp(tmp_path / "m.jsonl", tmp_path / "r.jsonl", shallow=False)


# ----------------------------------------------------------------- drivers


def test_driver_needs_a_card_unless_asked(tmp_path):
    """The drivers' default device is the card: without one they raise
    (no silent CPU run); ``--device`` parses to ``device``."""
    settings, seq = synthetic.write_tum_sequence(str(tmp_path / "seq"), n_frames=2, h=48, w=64,
                                                 fx=50.0)
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="no CUDA card"):
        mono_tum.main(settings, seq, str(tmp_path / "t.txt"))
    args = common.parse(mono_tum.__doc__, ("settings_path", "seq_dir"),
                        (("traj_out", "x"), ("detections_dir", None)), argv=["s", "q"])
    assert args == {"settings_path": "s", "seq_dir": "q", "traj_out": "x",
                    "detections_dir": None, "device": "cuda"}


def _load_rows(path):
    with open(path) as f:
        return np.asarray([[float(x) for x in line.split()] for line in f
                           if line.strip() and not line.startswith("#")])


def _ate_vs_groundtruth(traj_path, gt_path, with_scale, min_pairs):
    est = _load_rows(traj_path)
    gt = {round(r[0], 4): r[1:4] for r in _load_rows(gt_path)}
    pairs = [(r[1:4], gt[round(r[0], 4)]) for r in est if round(r[0], 4) in gt]
    assert len(pairs) >= min_pairs, f"only {len(pairs)} matched timestamps"
    e = np.asarray([p[0] for p in pairs])
    g = np.asarray([p[1] for p in pairs])
    return metrics.ate_rmse(e, g, with_scale=with_scale), float(np.linalg.norm(g.max(0) - g.min(0)))


# the drivers' pools (512 / 65,536) take minutes of CPU per run; these fill
# and double the point pool once during the run
SMALL_POOLS = (24, 2048)


def test_mono_tum_driver_equals_system(tmp_path, monkeypatch, capsys):
    seq = str(tmp_path / "seq")
    settings_path, _ = synthetic.write_tum_sequence(
        seq, n_frames=40, h=240, w=320, fx=260.0, seed=1, motion="strafe", sensor="mono",
        n_features=600)
    monkeypatch.setattr(common, "POOLS_SMALL", SMALL_POOLS)
    traj = str(tmp_path / "traj.txt")
    out = mono_tum.main(settings_path, seq, traj, device="cpu")
    printed = capsys.readouterr().out
    for line in ("image decoder: native", "median tracking time", "mean tracking time",
                 "keyframes:", f"trajectory saved to {traj}"):
        assert line in printed
    assert len(out["times"]) == 40 and os.path.exists(traj + ".metrics.jsonl")

    # the same frames through a System built as the reference driver builds it
    settings = config.load_settings(settings_path)
    rgb = datasets.load_tum_rgb_list(seq)
    fcfg = config.frontend_config_from_settings(settings, 240, 320)
    slam = sysm.System(sysm.SystemConfig(
        frontend=fcfg,
        map=ms.MapConfig(max_keyframes=SMALL_POOLS[0], max_points=SMALL_POOLS[1],
                         n_features=fcfg.n_features, n_levels=fcfg.n_levels, device="cpu"),
        sensor="mono", max_frames_between_kf=int(config.camera_fps(settings)),
        enable_loop_closing=True))
    for ts, path in rgb:
        slam.track_monocular(image_io.load_gray(path), timestamp=ts)
    direct = str(tmp_path / "direct.txt")
    trajectory.save_tum(direct, [(ts, metrics.se3_vec_to_mat(T7))
                                 for _, ts, T7 in slam.full_trajectory()])
    assert filecmp.cmp(traj, direct, shallow=False)
    ate, span = _ate_vs_groundtruth(traj, os.path.join(seq, "groundtruth.txt"), True, 35)
    assert ate < 0.05 * span, f"mono driver ATE {ate} vs span {span}"


def test_eval_full_emits_reference_fields(tmp_path):
    out = str(tmp_path / "eval.json")
    rc = eval_full.main(["--device", "cpu", "--frames", "30", "--height", "240", "--width",
                         "320", "--features", "512", "--levels", "4", "--max-keyframes", "32",
                         "--max-points", "4096", "--no-warmup", "--progress-every", "10",
                         "--out", out])
    with open(out) as f:
        got = json.load(f)
    with open(os.path.join(REPO, "EVAL_r05.json")) as f:
        ref = json.load(f)
    assert set(ref) <= set(got), set(ref) - set(got)
    assert set(ref["config"]) <= set(got["config"])
    assert got["platform"] == "cpu" and got["frames_tracked"] == 30
    assert rc == (0 if got["pass"] else 1)
    assert np.isfinite(got["ate_rmse"]) and got["keyframes_live"] >= 2


# ----------------------------------------------------- slow twins (110 frames)


def _run_module(module, args, cwd):
    """``python -m module *args --device cpu`` with JAX made unimportable."""
    env = {**os.environ, "PYTHONPATH": REPO}
    r = subprocess.run(
        [sys.executable, "-c",
         "import runpy, sys; sys.modules['jax'] = None; "
         f"sys.argv = {[module, *args, '--device', 'cpu']!r}; "
         f"runpy.run_module({module!r}, run_name='__main__')"],
        cwd=cwd, env=env, capture_output=True, text=True, timeout=3000)
    assert r.returncode == 0, f"{module}\nstdout:{r.stdout[-3000:]}\nstderr:{r.stderr[-3000:]}"
    assert "median tracking time" in r.stdout and "image decoder:" in r.stdout
    return r


@pytest.mark.slow
def test_mono_tum_driver_end_to_end(tmp_path):
    seq = str(tmp_path / "seq")
    settings, _ = synthetic.write_tum_sequence(
        seq, n_frames=110, h=240, w=320, fx=260.0, seed=1, motion="strafe", sensor="mono",
        n_features=600)
    traj = str(tmp_path / "traj.txt")
    _run_module("orbslam2_with_quadrics_tpu_torch.examples.mono_tum", [settings, seq, traj],
                str(tmp_path))
    ate, span = _ate_vs_groundtruth(traj, os.path.join(seq, "groundtruth.txt"), True, 50)
    assert ate < 0.05 * span, f"mono driver ATE {ate} vs span {span}"


@pytest.mark.slow
def test_stereo_kitti_driver_end_to_end(tmp_path):
    seq = str(tmp_path / "seq")
    settings, _ = synthetic.write_kitti_sequence(
        seq, n_frames=110, h=240, w=320, fx=260.0, seed=5, motion="strafe", n_features=600)
    traj = str(tmp_path / "traj_kitti.txt")
    _run_module("orbslam2_with_quadrics_tpu_torch.examples.stereo_kitti", [settings, seq, traj],
                str(tmp_path))
    est, gt = _load_rows(traj), _load_rows(os.path.join(seq, "poses.txt"))
    assert est.shape[1] == 12 and len(est) == len(gt)
    e, g = est[:, [3, 7, 11]], gt[:, [3, 7, 11]]
    ate = metrics.ate_rmse(e, g, with_scale=False)
    span = float(np.linalg.norm(g.max(0) - g.min(0)))
    assert ate < 0.05 * span, f"stereo driver ATE {ate} vs span {span}"


@pytest.mark.slow
def test_rgbd_tum_driver_end_to_end(tmp_path):
    seq = str(tmp_path / "seq")
    settings, _ = synthetic.write_tum_sequence(
        seq, n_frames=110, h=240, w=320, fx=260.0, seed=2, motion="strafe", sensor="rgbd",
        n_features=600)
    traj = str(tmp_path / "traj.txt")
    _run_module("orbslam2_with_quadrics_tpu_torch.examples.rgbd_tum",
                [settings, seq, os.path.join(seq, "associations.txt"), traj], str(tmp_path))
    ate, span = _ate_vs_groundtruth(traj, os.path.join(seq, "groundtruth.txt"), False, 50)
    assert ate < 0.05 * span, f"rgbd driver ATE {ate} vs span {span}"
