"""The port's monocular slice against the reference package.

One reference run of ``System.track_monocular`` over ``tests/test_system.py``'s
setup (240x320, 512 features, 4 levels, planar_sequence(25, seed=3),
max_frames_between_kf=8) records the inputs and outputs of one
``_frame_step`` and one ``_insert_and_map``; the port's functions run on the
same carried-across map, image and pose. Then the port's whole System runs
the same frames.

Tolerances:
- ``_frame_step``: keypoints, observations and the integer stats identical,
  descriptors identical on >= 99% of valid keypoints, undistorted points
  within 1e-4 px and poses within 1e-4 (float32 with another op order);
- ``_insert_and_map``: keyframe / point counts identical, observation table
  identical on >= 99.5% of rows, keyframe poses within 1e-3 and points
  within 1e-2 (median 1e-4): PCG bundle adjustment sums edges in another
  order, and its 40 CG steps x 10 LM steps amplify float32 rounding, most
  on weakly constrained fresh points;
- whole slice: the reference test's bar (state OK, >= 2 keyframes, > 50
  points, >= 20 tracked frames, ATE < 5% of span), the same initialization
  frame, tracked-frame count within 2 and per-frame camera centres within
  1% of the trajectory's span.
"""

import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orbslam2_with_quadrics_tpu.models import frontend as jfe
from orbslam2_with_quadrics_tpu.models import local_mapping as jlm
from orbslam2_with_quadrics_tpu.models import map_state as jms
from orbslam2_with_quadrics_tpu.models import system as jsys
from orbslam2_with_quadrics_tpu.utils import metrics, synthetic
from orbslam2_with_quadrics_tpu_torch.models import frontend as fe
from orbslam2_with_quadrics_tpu_torch.models import local_mapping as lm
from orbslam2_with_quadrics_tpu_torch.models import map_state as ms
from orbslam2_with_quadrics_tpu_torch.models import system as sysm

H, W, FX = 240, 320, 260.0
N_FRAMES = 25
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def make_cfg(pkg_fe, pkg_ms, pkg_sys, **map_kw):
    """The test's SystemConfig from either package; ``map_kw`` carries what
    only one side's MapConfig has (the port's ``device``)."""
    return pkg_sys.SystemConfig(
        frontend=pkg_fe.FrontendConfig(height=H, width=W, n_features=512, n_levels=4,
                                       fx=FX, fy=FX, cx=W / 2, cy=H / 2),
        map=pkg_ms.MapConfig(max_keyframes=32, max_points=4096, n_features=512,
                             n_levels=4, **map_kw),
        max_frames_between_kf=8,
    )


def centers(traj):
    return {f: metrics.camera_centers_from_Tcw([metrics.se3_vec_to_mat(np.asarray(T))])[0]
            for f, _, T in traj}


def wait_for_mapping(slam):
    """Make the reference's mapping-idle check wait for the mapping pass
    instead of polling it: the poll's answer depends on how loaded the
    machine is, and with it the keyframe schedule. On the CPU the port's
    check always finds mapping done (a CPU tensor is its own host copy)."""
    consume = slam._consume_map_aux
    slam._consume_map_aux = lambda block: consume(True)


@pytest.fixture(scope="module")
def reference_run():
    """The reference System over the sequence, recording the 8th
    _frame_step call and the 2nd _insert_and_map call."""
    imgs, poses, _ = synthetic.planar_sequence(n_frames=N_FRAMES, h=H, w=W, fx=FX,
                                               fy=FX, seed=3)
    rec = {"_frame_step": [], "_insert_and_map": []}
    orig = {k: getattr(jsys, k) for k in rec}

    def recorder(name):
        def call(*args, **kw):
            out = orig[name](*args, **kw)
            rec[name].append((args, kw, out))
            return out
        return call

    for k in rec:
        setattr(jsys, k, recorder(k))
    try:
        slam = jsys.System(make_cfg(jfe, jms, jsys))
        wait_for_mapping(slam)
        for i in range(N_FRAMES):
            slam.track_monocular(imgs[i], timestamp=i / 30.0)
        traj = slam.full_trajectory()
    finally:
        for k, f in orig.items():
            setattr(jsys, k, f)
    return {"imgs": imgs, "poses": poses, "slam": slam, "traj": traj,
            "frame_step": rec["_frame_step"][7], "insert_and_map": rec["_insert_and_map"][1]}


def port_map(m):
    return ms.map_state_from_numpy(m)


def t(a):
    return torch.as_tensor(np.array(a))


def test_frame_step_matches_reference(reference_run):
    args, kw, out = reference_run["frame_step"]
    (m, obs_A, img, _aux, T_cw, vel, prev_obs, ref_kf, anchor, red_cum,
     fcfg, sensor, min_inl, n_kf, n_pt) = args[:15]
    assert sensor == "mono" and not kw
    # the reference keeps the 0/1 observation matrix in bf16: exact in f32
    obs_A = np.asarray(obs_A).astype(np.float32)
    got = sysm._frame_step(
        port_map(m), t(obs_A), t(img), t(_aux), t(T_cw), t(vel), t(prev_obs), int(ref_kf),
        t(anchor), t(red_cum), make_cfg(fe, ms, sysm, device="cpu").frontend, sensor,
        min_inl, n_kf, n_pt,
    )
    feats, T_new, vel_new, obs_new, pt_vis, pt_fnd, stats, anchor_new = got
    j_feats, jT, jvel, jobs, jvis, jfnd, jstats, janchor = out
    f = fe.frame_features_to_numpy(feats)
    for k in ("uv", "level", "valid"):
        np.testing.assert_array_equal(f[k], np.asarray(getattr(j_feats, k)), err_msg=k)
    # undistortion's float32 fixed-point iteration differs in the last bit
    np.testing.assert_allclose(f["uv_und"], np.asarray(j_feats.uv_und), atol=1e-4)
    same_desc = (f["desc"] == np.asarray(j_feats.desc)).all(1)[f["valid"]]
    assert same_desc.mean() >= 0.99
    np.testing.assert_array_equal(obs_new.numpy(), np.asarray(jobs))
    np.testing.assert_array_equal(pt_vis.numpy(), np.asarray(jvis))
    np.testing.assert_array_equal(pt_fnd.numpy(), np.asarray(jfnd))
    s, js = stats.numpy(), np.asarray(jstats)
    np.testing.assert_array_equal(s[[0, 1, 2, 3, 18]], js[[0, 1, 2, 3, 18]])
    assert s[0] > 100
    np.testing.assert_allclose(s[4:18], js[4:18], atol=1e-4)
    np.testing.assert_allclose(T_new.numpy(), np.asarray(jT), atol=1e-4)
    np.testing.assert_allclose(vel_new.numpy(), np.asarray(jvel), atol=1e-4)
    np.testing.assert_allclose(anchor_new.numpy(), np.asarray(janchor), atol=1e-6)


def test_insert_and_map_matches_reference(reference_run):
    args, kw, out = reference_run["insert_and_map"]
    (m, feats, T_cw, frame_id, parent, obs_row, protect, inv_sigma2, fcfg,
     sensor, window) = args[:11]
    assert sensor == "mono" and not kw
    m2, aux, red_cum = sysm._insert_and_map(
        port_map(m), fe.frame_features_from_numpy(feats), t(T_cw), int(frame_id),
        int(parent), t(obs_row), t(protect), t(inv_sigma2),
        make_cfg(fe, ms, sysm, device="cpu").frontend, sensor, window,
    )
    jm2, jaux, jred = out
    got, ref = ms.map_state_to_numpy(m2), {f: np.asarray(getattr(jm2, f)) for f in jm2._fields}
    for f in ("n_kf", "n_pt", "kf_valid", "kf_parent", "kf_frame_id", "kf_desc"):
        np.testing.assert_array_equal(got[f], ref[f], err_msg=f)
    np.testing.assert_array_equal(aux.numpy()[[1, 4, 6]], np.asarray(jaux)[[1, 4, 6]])
    same_rows = (got["kf_obs_point"] == ref["kf_obs_point"]).all(1)
    assert same_rows.mean() >= 0.995
    assert (got["kf_obs_point"] == ref["kf_obs_point"]).mean() >= 0.995
    assert (got["pt_valid"] == ref["pt_valid"]).mean() >= 0.995
    np.testing.assert_allclose(got["kf_pose"], ref["kf_pose"], atol=1e-3)
    live = got["pt_valid"] & ref["pt_valid"]
    err = np.abs(got["pt_pos"][live] - ref["pt_pos"][live]).max(1)
    assert live.sum() > 200 and err.max() < 1e-2 and np.median(err) < 1e-4


def test_fuse_neighbors_matches_reference(reference_run):
    """The batched sweeps of ``fuse_neighbors`` (two matching launches for
    all neighbours) against the reference's sequential scan, on the map the
    reference left after a mapping pass, with the newest keyframe's row
    emptied so that the sweeps have observations to add back: observation
    table and point validity identical."""
    jm = reference_run["insert_and_map"][2][0]
    kf = int(jm.n_kf) - 1
    obs = np.array(jm.kf_obs_point)
    obs[kf, ::2] = -1
    jm = jm._replace(kf_obs_point=jnp.asarray(obs))
    K = np.array([FX, FX, W / 2, H / 2], np.float32)
    ref = jlm.fuse_neighbors(jm, jnp.asarray(kf, dtype=jnp.int32),
                             jnp.asarray(K), height=H, width=W, n_levels=4, scale=1.2)
    got = lm.fuse_neighbors(port_map(jm), torch.tensor(kf, dtype=torch.int32), t(K),
                            height=H, width=W, n_levels=4, scale=1.2)
    np.testing.assert_array_equal(got.kf_obs_point.numpy(), np.asarray(ref.kf_obs_point))
    np.testing.assert_array_equal(got.pt_valid.numpy(), np.asarray(ref.pt_valid))
    changed = (np.asarray(ref.kf_obs_point) != obs).sum()
    assert changed > 20


def test_whole_slice_matches_reference(reference_run):
    imgs, poses = reference_run["imgs"], reference_run["poses"]
    slam = sysm.System(make_cfg(fe, ms, sysm, device="cpu"))
    for i in range(N_FRAMES):
        slam.track_monocular(imgs[i], timestamp=i / 30.0)
    traj = slam.full_trajectory()
    # the reference test's bar (tests/test_system.py)
    assert slam.state == sysm.System.OK
    assert int(slam.map.n_kf) >= 2 and int(slam.map.n_pt) > 50
    assert len(traj) >= 20
    est = [metrics.se3_vec_to_mat(T) for _, _, T in traj]
    gt = [poses[f] for f, _, _ in traj]
    c_gt = metrics.camera_centers_from_Tcw(gt)
    span = np.linalg.norm(c_gt.max(0) - c_gt.min(0))
    assert metrics.ate_rmse(metrics.camera_centers_from_Tcw(est), c_gt) < 0.05 * span
    # agreement with the reference run
    jslam, jtraj = reference_run["slam"], reference_run["traj"]
    assert slam.init_frame_id == jslam.init_frame_id
    n_tr = sum(1 for m in slam.metrics if not m.get("lost"))
    j_tr = sum(1 for m in jslam.metrics if not m.get("lost"))
    assert n_tr >= 20 and abs(n_tr - j_tr) <= 2
    cp, cj = centers(traj), centers(jtraj)
    cjs = np.stack(list(cj.values()))
    est_span = np.linalg.norm(cjs.max(0) - cjs.min(0))
    common = sorted(set(cp) & set(cj))
    assert len(common) >= 20
    worst = max(np.linalg.norm(cp[f] - cj[f]) for f in common)
    assert worst < 0.01 * est_span


def test_port_imports_without_jax():
    code = (
        "import sys; sys.modules['jax'] = None\n"
        "import orbslam2_with_quadrics_tpu_torch\n"
        "from orbslam2_with_quadrics_tpu_torch.models import system, tracking, local_mapping\n"
        "from orbslam2_with_quadrics_tpu_torch.models import frontend, map_state\n"
        "from orbslam2_with_quadrics_tpu_torch.ops import stereo, camera, cuda_kernels\n"
        "from orbslam2_with_quadrics_tpu_torch.ops import ba, pose_graph\n"
        "from orbslam2_with_quadrics_tpu_torch.utils import synthetic, metrics\n"
        "assert system.System.track_stereo and system.System.track_rgbd\n"
        "assert frontend.extract_stereo and map_state.grow_map and stereo.stereo_match\n"
        "assert map_state.update_point_stats_local and local_mapping.on_accelerator\n"
        "assert ba.local_ba and pose_graph.optimize_pose_graph_dense\n"
        "assert not any(m == 'orbslam2_with_quadrics_tpu' or m.startswith("
        "'orbslam2_with_quadrics_tpu.') for m in sys.modules)\n"
        "print('ok')\n"
    )
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "ok"
