"""The port's System lifecycle against the reference package: trajectory
export, ``warmup``, and map and System checkpoints that load in both
packages.

All on the CPU, with one PyTorch thread (module fixture), over
``tests/test_system.py``'s setup (240x320, 512 features, 4 levels,
``planar_sequence(25, seed=3)``, ``max_frames_between_kf=8``, the shipped
vocabulary). One port run of the first 12 frames is shared.

- The TUM / KITTI savers: byte-identical to the reference's on the same
  items, rotations taking each of ``_R_to_quat``'s four branches; the
  System's files byte-identical to the reference savers on its own
  trajectory; twins of ``tests/test_system.py:125-146`` and of the keyframe
  file.
- ``warmup`` leaves every attribute of the System (its loop closer, random
  generator and caches included) and the global random state as they were,
  and a run with it gives the trajectory and the map of a run without it,
  bit for bit.
- Twins of ``tests/test_system.py:83-99`` (``save_map`` / ``load_map``) and
  ``:101-123`` (resume mid-sequence).
- Across the packages: a map the reference saved loads in the port equal,
  bit for bit, to ``map_state_from_numpy`` of the same arrays, and the
  other way round (dtypes included); a port System checkpoint loads into a
  reference System whose fields then equal the port's, and that System's
  own checkpoint loads back into a port System equal to the first (the
  shipped vocabulary's sparse database, and a vocabulary trained during the
  run, which the checkpoint embeds).
"""

import dataclasses
import pickle

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orbslam2_with_quadrics_tpu.models import frontend as jfe
from orbslam2_with_quadrics_tpu.models import map_state as jms
from orbslam2_with_quadrics_tpu.models import system as jsys
from orbslam2_with_quadrics_tpu.utils import serialization as jser
from orbslam2_with_quadrics_tpu.utils import trajectory as jtraj
from orbslam2_with_quadrics_tpu_torch.models import frontend as fe
from orbslam2_with_quadrics_tpu_torch.models import loop_closing as lc
from orbslam2_with_quadrics_tpu_torch.models import map_state as ms
from orbslam2_with_quadrics_tpu_torch.models import system as sysm
from orbslam2_with_quadrics_tpu_torch.ops import lie
from orbslam2_with_quadrics_tpu_torch.ops import vocab as vocab_mod
from orbslam2_with_quadrics_tpu_torch.utils import metrics, synthetic
from orbslam2_with_quadrics_tpu_torch.utils import serialization as ser
from orbslam2_with_quadrics_tpu_torch.utils import trajectory as traj

H, W, FX = 240, 320, 260.0
N_RUN = 12


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread while this file runs (whole-System runs on the
    CPU; see ``tests/test_torch_capacity.py``), restored afterwards."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def make_cfg(pkg_fe, pkg_ms, pkg_sys, map_kw=None, **kw):
    return pkg_sys.SystemConfig(
        frontend=pkg_fe.FrontendConfig(height=H, width=W, n_features=512, n_levels=4,
                                       fx=FX, fy=FX, cx=W / 2, cy=H / 2),
        map=pkg_ms.MapConfig(max_keyframes=32, max_points=4096, n_features=512,
                             n_levels=4, **(map_kw or {})),
        max_frames_between_kf=8, **kw)


def port_system(**kw):
    return sysm.System(make_cfg(fe, ms, sysm, dict(device="cpu"), **kw))


def reference_system(**kw):
    return jsys.System(make_cfg(jfe, jms, jsys, **kw))


@pytest.fixture(scope="module")
def planar_seq():
    return synthetic.planar_sequence(n_frames=25, h=H, w=W, fx=FX, fy=FX, seed=3)


def track(slam, imgs, frames):
    for i in frames:
        slam.track_monocular(imgs[i], timestamp=i / 30.0)


@pytest.fixture(scope="module")
def port_run(planar_seq):
    """The port's System over the first 12 frames, drained."""
    slam = port_system()
    track(slam, planar_seq[0], range(N_RUN))
    slam.shutdown()
    assert slam.state == sysm.System.OK and slam.loop_closer is not None
    return slam


def items_of(slam):
    return [(ts, metrics.se3_vec_to_mat(T7)) for _, ts, T7 in slam.full_trajectory()]


def read(path):
    with open(path, "rb") as f:
        return f.read()


# ---------------------------------------------------------------------------
# trajectory files
# ---------------------------------------------------------------------------

def quat_branch(R):
    """Which of ``_R_to_quat``'s branches a rotation takes."""
    return "trace" if np.trace(R) > 0 else int(np.argmax(np.diag(R)))


def branch_items():
    """T_cw matrices whose R_wc take every branch of ``_R_to_quat``: small
    rotations (trace > 0) and rotations by ~170 deg about axes near x, y
    and z (trace < 0, the largest diagonal entry on that axis)."""
    rng = np.random.RandomState(0)
    out = []
    for axis in (None, 0, 1, 2, None, 0, 1, 2):
        if axis is None:
            w = rng.randn(3) * 0.3
        else:
            a = np.eye(3)[axis] + 0.05 * rng.randn(3)
            w = a / np.linalg.norm(a) * np.deg2rad(170.0)
        T7 = lie.se3_make(lie.so3_exp_quat(torch.as_tensor(w, dtype=torch.float32)),
                          torch.as_tensor(rng.randn(3), dtype=torch.float32))
        out.append((len(out) * 0.0333333, metrics.se3_vec_to_mat(T7.numpy())))
    return out


@pytest.mark.parametrize("saver", ["save_tum", "save_kitti"])
def test_savers_byte_identical_to_reference(saver, tmp_path):
    items = branch_items()
    assert {quat_branch(T[:3, :3].T) for _, T in items} == {"trace", 0, 1, 2}
    getattr(traj, saver)(str(tmp_path / "port.txt"), items)
    getattr(jtraj, saver)(str(tmp_path / "ref.txt"), items)
    assert read(tmp_path / "port.txt") == read(tmp_path / "ref.txt")
    assert len(read(tmp_path / "port.txt").splitlines()) == len(items)


def test_trajectory_export_formats(port_run, tmp_path):
    """Twin of tests/test_system.py:125-146 through the System's savers,
    whose files are the reference savers' on the same trajectory."""
    slam = port_run
    items = items_of(slam)
    assert len(items) == N_RUN
    ptum, pkit = str(tmp_path / "tum.txt"), str(tmp_path / "kitti.txt")
    slam.save_trajectory_tum(ptum)
    slam.save_trajectory_kitti(pkit)
    tum, kit = np.loadtxt(ptum), np.loadtxt(pkit)
    assert tum.shape == (len(items), 8)
    assert kit.shape == (len(items), 12)
    np.testing.assert_allclose(np.linalg.norm(tum[:, 4:8], axis=1), 1.0, atol=1e-5)
    np.testing.assert_allclose(tum[:, 0], [i / 30.0 for i in range(N_RUN)], atol=1e-6)
    jtraj.save_tum(str(tmp_path / "ref_tum.txt"), items)
    jtraj.save_kitti(str(tmp_path / "ref_kitti.txt"), items)
    assert read(ptum) == read(tmp_path / "ref_tum.txt")
    assert read(pkit) == read(tmp_path / "ref_kitti.txt")


def test_keyframe_trajectory(port_run, tmp_path):
    slam = port_run
    kft = slam.keyframe_trajectory()
    valid = slam.map.kf_valid.numpy()
    slots = [s for s in range(int(slam.map.n_kf)) if valid[s]]
    assert len(kft) == len(slots) >= 3
    for (fid, T7), s in zip(kft, slots):
        assert fid == int(slam.map.kf_frame_id[s])
        np.testing.assert_array_equal(T7, slam.map.kf_pose[s].numpy())
    fids = [f for f, _ in kft]
    assert fids == sorted(fids) and fids[0] >= 0
    p = str(tmp_path / "kf.txt")
    slam.save_keyframe_trajectory_tum(p)
    rows = np.loadtxt(p)
    assert rows.shape == (len(kft), 8)
    np.testing.assert_allclose(rows[:, 0], [f / 30.0 for f in fids], atol=1e-6)
    jtraj.save_tum(str(tmp_path / "ref.txt"),
                   [(f / 30.0, metrics.se3_vec_to_mat(T7)) for f, T7 in kft])
    assert read(p) == read(tmp_path / "ref.txt")


# ---------------------------------------------------------------------------
# warmup
# ---------------------------------------------------------------------------

def snapshot(obj, seen=None):
    """A comparable copy of an object's state: tensors and arrays as numpy
    copies (dtype included), generators as their state, containers element
    by element, the package's own objects (loop closer, quadric manager)
    attribute by attribute, anything else (locks, threads, configs) by
    identity."""
    if torch.is_tensor(obj):
        return ("tensor", str(obj.dtype), obj.detach().cpu().numpy().copy())
    if isinstance(obj, torch.Generator):
        return ("generator", obj.get_state().numpy().copy())
    if isinstance(obj, np.ndarray):
        return ("array", str(obj.dtype), obj.copy())
    if isinstance(obj, (bool, int, float, str, type(None), np.generic)):
        return obj
    if isinstance(obj, dict):
        return {k: snapshot(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return (type(obj).__name__, [snapshot(v) for v in obj])
    if isinstance(obj, set):
        return ("set", sorted(obj))
    if (type(obj).__module__.startswith("orbslam2_with_quadrics_tpu_torch")
            and not dataclasses.is_dataclass(obj)) or isinstance(obj, sysm.System):
        return (type(obj).__name__, {k: snapshot(v) for k, v in vars(obj).items()})
    return ("id", id(obj))


def assert_same(a, b, path="slam"):
    if isinstance(a, np.ndarray):
        assert isinstance(b, np.ndarray) and a.dtype == b.dtype, path
        np.testing.assert_array_equal(a, b, err_msg=path)
    elif isinstance(a, dict):
        assert a.keys() == b.keys(), path
        for k in a:
            assert_same(a[k], b[k], f"{path}.{k}")
    elif isinstance(a, (list, tuple)):
        assert type(a) is type(b) and len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            assert_same(x, y, f"{path}[{i}]")
    else:
        assert a == b, path


def test_warmup_leaves_state_unchanged_and_run_identical(planar_seq, port_run):
    slam = port_system()
    track(slam, planar_seq[0], range(7))
    assert slam.state == sysm.System.OK and slam._pend is not None
    before, rng = snapshot(slam), torch.get_rng_state()
    assert slam.warmup() > 0
    assert_same(snapshot(slam), before)
    assert torch.equal(torch.get_rng_state(), rng)
    track(slam, planar_seq[0], range(7, N_RUN))
    slam.shutdown()
    got, ref = slam.full_trajectory(), port_run.full_trajectory()
    assert [e[:2] for e in got] == [e[:2] for e in ref]
    for (_, _, T), (_, _, T_ref) in zip(got, ref):
        np.testing.assert_array_equal(T, T_ref)
    assert_same(ms.map_state_to_numpy(slam.map), ms.map_state_to_numpy(port_run.map))


# ---------------------------------------------------------------------------
# checkpoints
# ---------------------------------------------------------------------------

def assert_maps_equal(got: dict, ref: dict):
    assert got.keys() == ref.keys() == set(ms.MapState._fields)
    for f in ms.MapState._fields:
        a, b = np.asarray(got[f]), np.asarray(ref[f])
        assert a.dtype == b.dtype and a.shape == b.shape, f
        np.testing.assert_array_equal(a, b, err_msg=f)


def reference_dtypes():
    return {f: np.asarray(v).dtype for f, v in jms.empty_map(jms.MapConfig())._asdict().items()}


def test_map_save_load_roundtrip(port_run, tmp_path):
    """Twin of tests/test_system.py:83-99; the file holds the reference's
    dtypes (uint32 descriptors, 0-d int32 counters)."""
    p = str(tmp_path / "map.npz")
    ser.save_map(p, port_run.map)
    with np.load(p) as data:
        assert {k: data[k].dtype for k in data.files} == reference_dtypes()
        assert data["n_kf"].shape == () and data["n_pt"].shape == ()
    m2 = ser.load_map(p, device="cpu")
    assert int(m2.n_kf) == int(port_run.map.n_kf)
    assert m2.kf_desc.dtype == torch.int32
    assert_maps_equal(ms.map_state_to_numpy(m2), ms.map_state_to_numpy(port_run.map))


@pytest.mark.parametrize("direction", ["reference_to_port", "port_to_reference"])
def test_map_checkpoint_loads_across_packages(port_run, tmp_path, direction):
    arrays = ms.map_state_to_numpy(port_run.map)
    p = str(tmp_path / "map.npz")
    if direction == "reference_to_port":
        jser.save_map(p, jms.MapState(**{k: jnp.asarray(v) for k, v in arrays.items()}))
        got = ser.load_map(p, device="cpu")
        want = ms.map_state_from_numpy(jms.MapState(**arrays), device="cpu")
        for f in ms.MapState._fields:
            a, b = getattr(got, f), getattr(want, f)
            assert a.dtype == b.dtype and torch.equal(a, b), f
        assert_maps_equal(ms.map_state_to_numpy(got), arrays)
    else:
        ser.save_map(p, port_run.map)
        got = jser.load_map(p)
        assert_maps_equal({f: np.asarray(getattr(got, f)) for f in jms.MapState._fields},
                          arrays)


def test_system_checkpoint_resume(port_run, planar_seq, tmp_path):
    """Twin of tests/test_system.py:101-123 (saved after 12 frames, not 15):
    the restored System starts from the saved state and keeps tracking
    for 10 more frames."""
    p = str(tmp_path / "ckpt.pkl")
    ser.save_system(p, port_run)
    slam2 = port_system()
    ser.load_system(p, slam2)
    assert slam2.state == sysm.System.OK
    assert int(slam2.map.n_kf) == int(port_run.map.n_kf)
    assert_maps_equal(ms.map_state_to_numpy(slam2.map), ms.map_state_to_numpy(port_run.map))
    assert slam2._pend is None and slam2._obs_A is None and slam2._n_kf_host == int(
        slam2.map.n_kf)
    track(slam2, planar_seq[0], range(N_RUN, N_RUN + 10))
    slam2.shutdown()
    assert slam2.state == sysm.System.OK
    assert [e[0] for e in slam2.trajectory] == list(range(N_RUN + 10))
    assert int(slam2.map.n_kf) > int(port_run.map.n_kf)


def system_fields(slam):
    """The checkpointed fields of a System of either package, as numpy
    arrays (descriptors as uint32) and plain values."""
    if isinstance(slam, sysm.System):
        def to_np(t):
            return t.cpu().numpy()
        arrays = ms.map_state_to_numpy(slam.map)
    else:
        to_np = np.asarray
        arrays = {f: to_np(getattr(slam.map, f)) for f in ms.MapState._fields}
    out = {
        "map": arrays,
        "scalars": (slam.state, slam.frame_id, slam.ref_kf, slam.ref_kf_matches,
                    slam.last_kf_frame),
        "T_cw": to_np(slam.T_cw), "velocity": to_np(slam.velocity),
        "prev_obs": to_np(slam.prev_obs),
        "trajectory": [(int(f), float(ts), int(r), np.asarray(T)) for f, ts, r, T in
                       slam.trajectory],
        "metrics": slam.metrics,
    }
    lcs = slam.loop_closer
    if lcs is not None:
        out["db"] = {k: to_np(getattr(lcs, k)) for k in ("words", "kf_wid", "kf_wval", "bow")
                     if getattr(lcs, k, None) is not None}
        out["loop"] = ([tuple(int(x) for x in e) for e in lcs.loop_edges],
                       int(lcs.last_loop_kf))
    return out


def assert_fields_equal(got, want):
    assert_maps_equal(got["map"], want["map"])
    assert got["scalars"] == want["scalars"]
    for k in ("T_cw", "velocity", "prev_obs"):
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert len(got["trajectory"]) == len(want["trajectory"])
    for a, b in zip(got["trajectory"], want["trajectory"]):
        assert a[:3] == b[:3]
        np.testing.assert_array_equal(a[3], b[3])
    assert got["metrics"] == want["metrics"]
    assert got.get("loop") == want.get("loop")
    assert got.get("db", {}).keys() == want.get("db", {}).keys()
    for k in got.get("db", {}):
        np.testing.assert_array_equal(got["db"][k], want["db"][k], err_msg=k)


def round_trip_through_reference(slam, tmp_path, **cfg_kw):
    """port save_system -> reference load_system -> reference save_system
    -> port load_system; returns (the reference System, the port System)."""
    p1, p2 = str(tmp_path / "port.pkl"), str(tmp_path / "ref.pkl")
    ser.save_system(p1, slam)
    with open(p1, "rb") as f:
        state = pickle.load(f)
    assert all(type(e[0]) is int and type(e[1]) is float and type(e[2]) is int
               and isinstance(e[3], np.ndarray) for e in state["trajectory"])
    assert not any(torch.is_tensor(v) for v in state.values())
    jslam = reference_system(**cfg_kw)
    jser.load_system(p1, jslam)
    jser.save_system(p2, jslam)
    back = port_system(**cfg_kw)
    ser.load_system(p2, back)
    return jslam, back


def test_system_checkpoint_port_reference_port(port_run, tmp_path):
    jslam, back = round_trip_through_reference(port_run, tmp_path)
    want = system_fields(port_run)
    assert jslam.loop_closer.sparse and "kf_wid" in want["db"]
    assert_fields_equal(system_fields(jslam), want)
    assert_fields_equal(system_fields(back), want)
    assert back.state == sysm.System.OK and back._n_kf_host == int(port_run.map.n_kf)


def test_trained_vocabulary_checkpoint_across_packages(port_run, tmp_path):
    """A vocabulary trained during the run is embedded in the checkpoint and
    crosses both ways with its dense database."""
    p = str(tmp_path / "ckpt.pkl")
    ser.save_system(p, port_run)
    slam = port_system(vocab_path=None)
    ser.load_system(p, slam)  # no vocabulary to rebuild the database with
    assert slam.loop_closer is None
    g = torch.Generator().manual_seed(0)
    desc = torch.randint(-2 ** 31, 2 ** 31, (512, 8), generator=g).to(torch.int32)
    slam.loop_closer = lc.LoopCloser(vocab_mod.train(desc, k=4, levels=3), slam.cfg.map)
    for s in range(int(slam.map.n_kf)):
        if bool(slam.map.kf_valid[s]):
            slam.loop_closer.add_keyframe_from_map(slam.map, s)
    jslam, back = round_trip_through_reference(slam, tmp_path, vocab_path=None)
    voc, jvoc, bvoc = slam.loop_closer.voc, jslam.loop_closer.voc, back.loop_closer.voc
    assert (jvoc.k, jvoc.levels, bvoc.k, bvoc.levels) == (4, 3, 4, 3)
    for c, jc, bc in zip(voc.centers, jvoc.centers, bvoc.centers):
        np.testing.assert_array_equal(np.asarray(jc), c.numpy().view(np.uint32))
        assert torch.equal(bc, c)
    assert torch.equal(bvoc.idf, voc.idf)
    want = system_fields(slam)
    assert not jslam.loop_closer.sparse and "bow" in want["db"]
    assert_fields_equal(system_fields(jslam), want)
    assert_fields_equal(system_fields(back), want)
