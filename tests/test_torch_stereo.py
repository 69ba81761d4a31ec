"""The port's stereo and RGB-D slice against the reference package.

All on the CPU at 320x240, 512 features, 4 levels; inputs come from numpy
seeds (the synthetic sequences of ``utils/synthetic.py``). One reference
run per sensor (``tests/test_system.py``'s RGB-D setup,
``tests/test_system_extended.py``'s stereo setup) records the inputs and
outputs of one ``_frame_step`` and one ``_insert_and_map``; the port's
functions run on the same carried-across map, images and pose, and then
the port's whole System runs the same frames.

Tolerances:
- synthetic: ``planar_depth`` and ``stereo_right_pose`` identical, the right
  images within 0.05 grey levels (the bound of the left ones in
  ``tests/test_torch_ops.py``);
- ``stereo_match`` on the same features: matched set identical, ``ur``
  within 1e-4 px and depth within 1e-5 relative (float32 SAD sums in another
  order); on integer-valued images every SAD is exact and ``ur`` is
  identical;
- ``extract_rgbd``: keypoints identical, depth identical, ``ur`` within 1e-4;
- ``extract_stereo`` from the raw images: keypoints identical, the matched
  set equal on >= 99% of keypoints (about 1% of the port's descriptors
  differ, see ``tests/test_torch_ops.py``), ``ur`` within 1e-3 px on >= 99%
  of the common matches;
- ``_create_depth_points`` / ``_depth_init``: integer outputs identical,
  points within 1e-4;
- ``_frame_step``: keypoints, observations and the integer stats (with the
  close-point census ``stats[2:4]``) identical, the set of keypoints with a
  depth identical, ``ur`` within 1e-3 px on >= 99% of keypoints (stereo: a
  differing descriptor can move a coarse match), poses within 1e-4;
- ``_insert_and_map`` for a depth sensor: counts identical, observation
  table identical on >= 99.5% of entries, keyframe poses within 1e-3,
  points within 1e-2 (median 1e-4), as for mono;
- whole slice: the reference test's own bar, the same initialization frame,
  tracked-frame count within 2, camera centres within 1% of the span.
"""

import collections
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orbslam2_with_quadrics_tpu.models import frontend as jfe
from orbslam2_with_quadrics_tpu.models import map_state as jms
from orbslam2_with_quadrics_tpu.models import system as jsys
from orbslam2_with_quadrics_tpu.ops import orb as jorb
from orbslam2_with_quadrics_tpu.ops import stereo as jstereo
from orbslam2_with_quadrics_tpu.utils import metrics
from orbslam2_with_quadrics_tpu.utils import synthetic as jsyn
from orbslam2_with_quadrics_tpu_torch.models import frontend as fe
from orbslam2_with_quadrics_tpu_torch.models import map_state as ms
from orbslam2_with_quadrics_tpu_torch.models import system as sysm
from orbslam2_with_quadrics_tpu_torch.ops import stereo
from orbslam2_with_quadrics_tpu_torch.utils import synthetic


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread while this file runs: the suite runs several
    worker processes on a few cores, and the port's CPU path is thousands of
    small ops whose OpenMP barriers stall for minutes once the workers'
    threads outnumber the cores. Restored afterwards: a worker goes on to
    other files."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

H, W, FX = 240, 320, 260.0
BASELINE = 0.1
SENSORS = ("rgbd", "stereo")


def make_cfg(pkg_fe, pkg_ms, pkg_sys, sensor, **map_kw):
    """``tests/test_system.py``'s RGB-D configuration or
    ``tests/test_system_extended.py``'s stereo one, from either package."""
    frontend = pkg_fe.FrontendConfig(
        height=H, width=W, n_features=512, n_levels=4, fx=FX, fy=FX, cx=W / 2, cy=H / 2,
        bf=0.0 if sensor == "mono" else BASELINE * FX)
    if sensor == "stereo":
        return pkg_sys.SystemConfig(
            frontend=frontend,
            map=pkg_ms.MapConfig(max_keyframes=48, max_points=8192, n_features=512,
                                 n_levels=4, **map_kw),
            sensor=sensor, max_frames_between_kf=6, kf_close_tracked_th=250,
            kf_close_untracked_th=40)
    return pkg_sys.SystemConfig(
        frontend=frontend,
        map=pkg_ms.MapConfig(max_keyframes=32, max_points=4096, n_features=512,
                             n_levels=4, **map_kw),
        sensor=sensor, max_frames_between_kf=8)


def t(a):
    return torch.as_tensor(np.array(a))


def track(slam, sensor, seq, i):
    if sensor == "rgbd":
        return slam.track_rgbd(seq["imgs"][i], seq["aux"][i], timestamp=i / 30.0)
    return slam.track_stereo(seq["imgs"][i], seq["aux"][i], timestamp=i / 30.0)


def sequence(sensor):
    if sensor == "rgbd":
        imgs, poses, K = jsyn.planar_sequence(n_frames=25, h=H, w=W, fx=FX, fy=FX, seed=3)
        aux = np.stack([jsyn.planar_depth(T, K, H, W) for T in poses])
    else:
        imgs, aux, poses, K = jsyn.planar_sequence_stereo(
            n_frames=20, h=H, w=W, fx=FX, fy=FX, baseline=BASELINE, seed=5)
    return {"imgs": imgs, "aux": aux, "poses": poses, "K": K}


@pytest.fixture(scope="module")
def reference_runs():
    """The reference System over each sensor's sequence, recording every
    ``_frame_step`` and ``_insert_and_map`` call, and the map right after
    initialization with the features that made it."""
    runs = {}
    for sensor in SENSORS:
        seq = sequence(sensor)
        rec = {"_frame_step": [], "_insert_and_map": []}
        orig = {k: getattr(jsys, k) for k in rec}

        def recorder(name, rec=rec, orig=orig):
            def call(*args, **kw):
                out = orig[name](*args, **kw)
                rec[name].append((args, kw, out))
                return out
            return call

        for k in rec:
            setattr(jsys, k, recorder(k))
        try:
            slam = jsys.System(make_cfg(jfe, jms, jsys, sensor))
            # wait for each mapping pass instead of polling it: the poll's
            # answer, and with it the keyframe schedule, depends on the
            # machine's load; on the CPU the port always finds mapping done
            consume = slam._consume_map_aux
            slam._consume_map_aux = lambda block, consume=consume: consume(True)
            track(slam, sensor, seq, 0)
            init = {"map": slam.map, "feats": slam.last_feats, "state": slam.state}
            for i in range(1, len(seq["imgs"])):
                track(slam, sensor, seq, i)
            traj = slam.full_trajectory()
        finally:
            for k, f in orig.items():
                setattr(jsys, k, f)
        runs[sensor] = dict(seq, slam=slam, traj=traj, init=init,
                            frame_steps=rec["_frame_step"],
                            insert_and_maps=rec["_insert_and_map"])
    return runs


# ---------------------------------------------------------------------------
# synthetic sequences
# ---------------------------------------------------------------------------

def test_synthetic_stereo_and_depth_match_reference():
    kw = dict(n_frames=2, h=120, w=160, fx=130.0, fy=130.0, baseline=0.1, seed=5)
    jl, jr, jp, jk = jsyn.planar_sequence_stereo(**kw)
    pl, pr, pp, pk = synthetic.planar_sequence_stereo(**kw)
    np.testing.assert_array_equal(jk, pk)
    for a, b in zip(jp, pp):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(jsyn.stereo_right_pose(a, 0.1),
                                      synthetic.stereo_right_pose(b, 0.1))
    assert np.abs(jl - pl).max() < 0.05 and np.abs(jr - pr).max() < 0.05
    for relief in (False, True):
        np.testing.assert_array_equal(
            jsyn.planar_depth(jp[1], jk, 120, 160, relief=relief),
            synthetic.planar_depth(pp[1], pk, 120, 160, relief=relief))


# ---------------------------------------------------------------------------
# frontend
# ---------------------------------------------------------------------------

OrbFeatures = collections.namedtuple("OrbFeatures", "uv level desc valid")


def right_features(jr):
    return OrbFeatures(t(jr.uv), t(jr.level), t(np.asarray(jr.desc).view(np.int32)),
                       t(jr.valid))


@pytest.mark.parametrize("integer_images", [False, True], ids=["float", "integer"])
def test_stereo_match_matches_reference(integer_images):
    imgs_l, imgs_r, _, _ = jsyn.planar_sequence_stereo(
        n_frames=2, h=H, w=W, fx=FX, fy=FX, baseline=BASELINE, seed=5)
    left, right = imgs_l[1], imgs_r[1]
    if integer_images:
        left, right = np.round(left), np.round(right)
    jc = make_cfg(jfe, jms, jsys, "stereo").frontend
    jl = jfe.extract_mono(jc, jnp.asarray(left))
    jr = jorb.extract(jnp.asarray(right), n_features=512, n_levels=4, scale=1.2,
                      th_fast=jc.th_fast, th_fast_min=jc.th_fast_min)
    j_ur, j_depth = (np.asarray(a) for a in jstereo.stereo_match(
        jc, jnp.asarray(left), jnp.asarray(right), jl, jr))
    ur, depth = stereo.stereo_match(
        make_cfg(fe, ms, sysm, "stereo", device="cpu").frontend, t(left), t(right),
        fe.frame_features_from_numpy(jl), right_features(jr))
    ur, depth = ur.numpy(), depth.numpy()
    assert (j_ur > 0).sum() > 400
    np.testing.assert_array_equal(ur > 0, j_ur > 0)
    np.testing.assert_array_equal(depth > 0, j_depth > 0)
    if integer_images:  # 121 x 510 < 2^24: every SAD is exact in float32
        np.testing.assert_array_equal(ur, j_ur)
    else:
        np.testing.assert_allclose(ur, j_ur, atol=1e-4)
    np.testing.assert_allclose(depth, j_depth, rtol=1e-5)


def test_extract_rgbd_matches_reference():
    seq = sequence("rgbd")
    img, depth = seq["imgs"][3], seq["aux"][3]
    jf = jfe.extract_rgbd(make_cfg(jfe, jms, jsys, "rgbd").frontend, jnp.asarray(img),
                          jnp.asarray(depth))
    f = fe.frame_features_to_numpy(fe.extract_rgbd(
        make_cfg(fe, ms, sysm, "rgbd", device="cpu").frontend, t(img), t(depth)))
    for k in ("uv", "level", "valid", "depth"):
        np.testing.assert_array_equal(f[k], np.asarray(getattr(jf, k)), err_msg=k)
    assert (f["depth"] > 0).sum() > 400
    np.testing.assert_allclose(f["ur"], np.asarray(jf.ur), atol=1e-4)


def test_extract_stereo_matches_reference():
    seq = sequence("stereo")
    left, right = seq["imgs"][2], seq["aux"][2]
    jf = jfe.extract_stereo(make_cfg(jfe, jms, jsys, "stereo").frontend,
                            jnp.asarray(left), jnp.asarray(right))
    f = fe.frame_features_to_numpy(fe.extract_stereo(
        make_cfg(fe, ms, sysm, "stereo", device="cpu").frontend, t(left), t(right)))
    for k in ("uv", "level", "valid"):
        np.testing.assert_array_equal(f[k], np.asarray(getattr(jf, k)), err_msg=k)
    j_ur = np.asarray(jf.ur)
    assert ((f["ur"] > 0) == (j_ur > 0)).mean() >= 0.99
    both = (f["ur"] > 0) & (j_ur > 0)
    assert both.sum() > 400
    assert (np.abs(f["ur"] - j_ur)[both] < 1e-3).mean() >= 0.99
    rel = np.abs(f["depth"] - np.asarray(jf.depth))[both] / np.asarray(jf.depth)[both]
    assert (rel < 1e-4).mean() >= 0.99


# ---------------------------------------------------------------------------
# depth points and initialization
# ---------------------------------------------------------------------------

def assert_maps_agree(m, jm, pos_atol=1e-4):
    got = ms.map_state_to_numpy(m)
    ref = {f: np.asarray(getattr(jm, f)) for f in jm._fields}
    for f in ("n_kf", "n_pt", "kf_valid", "kf_frame_id", "kf_parent", "kf_obs_point",
              "kf_level", "kf_desc", "kf_kp_valid", "pt_valid", "pt_first_kf", "pt_desc",
              "pt_found", "pt_visible"):
        np.testing.assert_array_equal(got[f], ref[f], err_msg=f)
    for f in ("kf_pose", "kf_uv", "kf_ur", "pt_pos", "pt_normal"):
        np.testing.assert_allclose(got[f], ref[f], atol=pos_atol, err_msg=f)
    np.testing.assert_allclose(got["pt_max_dist"], ref["pt_max_dist"], rtol=1e-5)
    np.testing.assert_allclose(got["pt_min_dist"], ref["pt_min_dist"], rtol=1e-5)


@pytest.mark.parametrize("depth_th", [40.0, 1e9], ids=["close", "all"])
def test_create_depth_points_matches_reference(reference_runs, depth_th):
    """On the reference's map after a mapping pass, with a slice of the
    newest keyframe's row emptied so that there are keypoints to seed."""
    run = reference_runs["rgbd"]
    args, _, out = run["insert_and_maps"][0]
    jm, feats = out[0], args[1]
    kf = int(jm.n_kf) - 1
    obs = np.array(jm.kf_obs_point)
    obs[kf, ::3] = -1
    jm = jm._replace(kf_obs_point=jnp.asarray(obs))
    K = np.array([FX, FX, W / 2, H / 2], np.float32)
    bf = BASELINE * FX
    ref = jsys._create_depth_points(jm, kf, feats, jnp.asarray(K), bf, depth_th)
    got = sysm._create_depth_points(ms.map_state_from_numpy(jm), kf,
                                    fe.frame_features_from_numpy(feats), t(K), bf, depth_th)
    assert int(ref.n_pt) > int(jm.n_pt) + 50
    assert_maps_agree(got, ref)
    # a device scalar as the keyframe id, as _insert_and_map passes it
    got2 = sysm._create_depth_points(ms.map_state_from_numpy(jm), torch.tensor(kf),
                                     fe.frame_features_from_numpy(feats), t(K), bf, depth_th)
    np.testing.assert_array_equal(got2.kf_obs_point.numpy(), got.kf_obs_point.numpy())


@pytest.mark.parametrize("sensor", SENSORS)
def test_depth_init_matches_reference(reference_runs, sensor):
    run = reference_runs[sensor]
    init = run["init"]
    assert init["state"] == jsys.System.OK
    slam = sysm.System(make_cfg(fe, ms, sysm, sensor, device="cpu"))
    slam._track(fe.frame_features_from_numpy(init["feats"]), 0.0)
    assert slam.state == sysm.System.OK and slam.init_frame_id == 0
    assert int(slam.map.n_kf) == 1 and int(slam.map.n_pt) > 400
    assert_maps_agree(slam.map, init["map"])
    np.testing.assert_array_equal(slam.prev_obs.numpy(),
                                  np.asarray(init["map"].kf_obs_point[0]))
    # fewer than 500 features: no initialization
    few = fe.frame_features_from_numpy(init["feats"])
    few = few._replace(valid=few.valid & (torch.arange(512) < 499))
    slam2 = sysm.System(make_cfg(fe, ms, sysm, sensor, device="cpu"))
    slam2._track(few, 0.0)
    assert slam2.state == sysm.System.NOT_INITIALIZED and int(slam2.map.n_kf) == 0


# ---------------------------------------------------------------------------
# the device programs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("sensor", SENSORS)
def test_frame_step_matches_reference(reference_runs, sensor):
    args, kw, out = reference_runs[sensor]["frame_steps"][5]
    (m, obs_A, img, aux, T_cw, vel, prev_obs, ref_kf, anchor, red_cum,
     fcfg, j_sensor, min_inl, n_kf, n_pt, depth_factor) = args
    assert j_sensor == sensor and not kw
    obs_A = np.asarray(obs_A).astype(np.float32)   # 0/1 in bf16: exact in f32
    got = sysm._frame_step(
        ms.map_state_from_numpy(m), t(obs_A), t(img), t(aux), t(T_cw), t(vel), t(prev_obs),
        int(ref_kf), t(anchor), t(red_cum),
        make_cfg(fe, ms, sysm, sensor, device="cpu").frontend, sensor, min_inl, n_kf, n_pt,
        depth_factor,
    )
    feats, T_new, vel_new, obs_new, pt_vis, pt_fnd, stats, _ = got
    j_feats, jT, jvel, jobs, jvis, jfnd, jstats, _ = out
    f = fe.frame_features_to_numpy(feats)
    for k in ("uv", "level", "valid"):
        np.testing.assert_array_equal(f[k], np.asarray(getattr(j_feats, k)), err_msg=k)
    np.testing.assert_array_equal(f["depth"] > 0, np.asarray(j_feats.depth) > 0)
    assert (np.abs(f["ur"] - np.asarray(j_feats.ur)) < 1e-3).mean() >= 0.99
    np.testing.assert_array_equal(obs_new.numpy(), np.asarray(jobs))
    np.testing.assert_array_equal(pt_vis.numpy(), np.asarray(jvis))
    np.testing.assert_array_equal(pt_fnd.numpy(), np.asarray(jfnd))
    s, js = stats.numpy(), np.asarray(jstats)
    np.testing.assert_array_equal(s[[0, 1, 2, 3, 18]], js[[0, 1, 2, 3, 18]])
    assert s[0] > 100 and s[2] + s[3] > 100     # the close-point census is live
    np.testing.assert_allclose(s[4:18], js[4:18], atol=1e-4)
    np.testing.assert_allclose(T_new.numpy(), np.asarray(jT), atol=1e-4)
    np.testing.assert_allclose(vel_new.numpy(), np.asarray(jvel), atol=1e-4)


@pytest.mark.parametrize("sensor", SENSORS)
def test_insert_and_map_depth_sensor_matches_reference(reference_runs, sensor):
    args, kw, out = reference_runs[sensor]["insert_and_maps"][1]
    (m, feats, T_cw, frame_id, parent, obs_row, protect, inv_sigma2, fcfg,
     j_sensor, window) = args
    assert j_sensor == sensor and not kw
    m2, aux, red_cum = sysm._insert_and_map(
        ms.map_state_from_numpy(m), fe.frame_features_from_numpy(feats), t(T_cw),
        int(frame_id), int(parent), t(obs_row), t(protect), t(inv_sigma2),
        make_cfg(fe, ms, sysm, sensor, device="cpu").frontend, sensor, window,
    )
    jm2, jaux, jred = out
    got = ms.map_state_to_numpy(m2)
    ref = {f: np.asarray(getattr(jm2, f)) for f in jm2._fields}
    for f in ("n_kf", "n_pt", "kf_valid", "kf_parent", "kf_frame_id", "kf_desc"):
        np.testing.assert_array_equal(got[f], ref[f], err_msg=f)
    assert int(got["n_pt"]) > int(m.n_pt) + 50          # depth points were seeded
    np.testing.assert_array_equal(aux.numpy()[[1, 4, 6]], np.asarray(jaux)[[1, 4, 6]])
    assert (got["kf_obs_point"] == ref["kf_obs_point"]).mean() >= 0.995
    assert (got["pt_valid"] == ref["pt_valid"]).mean() >= 0.995
    np.testing.assert_allclose(got["kf_pose"], ref["kf_pose"], atol=1e-3)
    live = got["pt_valid"] & ref["pt_valid"]
    err = np.abs(got["pt_pos"][live] - ref["pt_pos"][live]).max(1)
    assert live.sum() > 200 and err.max() < 1e-2 and np.median(err) < 1e-4
    assert (np.abs(red_cum.numpy() - np.asarray(jred)) > 0).mean() < 0.005


# ---------------------------------------------------------------------------
# the whole slice
# ---------------------------------------------------------------------------

def centers(traj):
    return {f: metrics.camera_centers_from_Tcw([metrics.se3_vec_to_mat(np.asarray(T))])[0]
            for f, _, T in traj}


@pytest.mark.parametrize("sensor", SENSORS)
def test_whole_slice_matches_reference(reference_runs, sensor):
    run = reference_runs[sensor]
    n = len(run["imgs"])
    slam = sysm.System(make_cfg(fe, ms, sysm, sensor, device="cpu"))
    for i in range(n):
        track(slam, sensor, run, i)
    traj = slam.full_trajectory()
    # the reference tests' bars (tests/test_system.py:68-80,
    # tests/test_system_extended.py:40-55): metric, so no scale alignment
    assert slam.state == sysm.System.OK
    est = [metrics.se3_vec_to_mat(T) for _, _, T in traj]
    c_gt = metrics.camera_centers_from_Tcw([run["poses"][f] for f, _, _ in traj])
    ate = metrics.ate_rmse(metrics.camera_centers_from_Tcw(est), c_gt, with_scale=False)
    assert ate < (0.08 if sensor == "rgbd" else 0.1)
    # agreement with the reference run
    jslam, jtraj = run["slam"], run["traj"]
    assert slam.init_frame_id == 0 and len(traj) == len(jtraj) == n
    n_tr = sum(1 for m in slam.metrics if not m.get("lost"))
    j_tr = sum(1 for m in jslam.metrics if not m.get("lost"))
    assert n_tr >= n - 3 and abs(n_tr - j_tr) <= 2
    assert abs(slam.n_kfs_created - jslam.n_kfs_created) <= 1 and slam.n_kfs_created >= 2
    cp, cj = centers(traj), centers(jtraj)
    cjs = np.stack(list(cj.values()))
    span = np.linalg.norm(cjs.max(0) - cjs.min(0))
    worst = max(np.linalg.norm(cp[f] - cj[f]) for f in cp)
    assert worst < 0.01 * span


def test_sensor_entry_points_are_checked():
    slam = sysm.System(make_cfg(fe, ms, sysm, "rgbd", device="cpu"))
    img = np.zeros((H, W), np.float32)
    with pytest.raises(AssertionError):
        slam.track_stereo(img, img)
    with pytest.raises(AssertionError):
        slam.track_monocular(img)
    cfg = make_cfg(fe, ms, sysm, "stereo", device="cpu")
    with pytest.raises(ValueError, match="bf > 0"):
        sysm.System(dataclasses.replace(
            cfg, frontend=dataclasses.replace(cfg.frontend, bf=0.0)))


# ---------------------------------------------------------------------------
# the keyframe decision, both kinds, for every sensor
# ---------------------------------------------------------------------------

def decision_systems(sensor):
    kw = dict(kf_close_tracked_th=40, kf_close_untracked_th=20, max_frames_between_kf=8)
    j = jsys.System(dataclasses.replace(make_cfg(jfe, jms, jsys, sensor), **kw))
    p = sysm.System(dataclasses.replace(make_cfg(fe, ms, sysm, sensor, device="cpu"), **kw))
    return j, p


@pytest.mark.parametrize("sensor", ("mono",) + SENSORS)
def test_need_kf_fast_truth_table(sensor):
    """``_need_kf_fast`` over a grid of (frames since the last keyframe,
    inliers, reference-keyframe points, close-point census, redundancy,
    keyframes in the map): the port decides as the reference does."""
    j, p = decision_systems(sensor)
    n, wants = 0, 0
    for since in (1, 3, 8):
        for n_inl in (10, 20, 60, 120, 200):
            for n_ref in (50, 150, 400):
                for close in ((10, 50), (10, 5), (100, 50)):
                    for red in (0.0, 0.95):
                        for n_kf_host in (1, 4):
                            s = np.zeros(19, np.float32)
                            s[0], s[2], s[3], s[18] = n_inl, close[0], close[1], red * n_inl
                            pend = {"frame_id": 20}
                            out = []
                            for slam in (j, p):
                                slam.last_kf_frame = 20 - since
                                slam._n_kf_host = n_kf_host
                                slam._n_ref_vals = {2: n_ref, 3: n_ref}
                                slam._map_aux = None
                                out.append(slam._need_kf_fast(pend, n_inl, s))
                            assert out[0] == out[1], (since, n_inl, n_ref, close, red,
                                                      n_kf_host)
                            n += 1
                            wants += out[1]
    assert n == 540 and 50 < wants < n - 50


@pytest.mark.parametrize("sensor", ("mono",) + SENSORS)
def test_need_new_keyframe_truth_table(sensor, monkeypatch):
    """``_need_new_keyframe`` (the synchronous decision) over a like grid,
    with small synthetic features: the close census and the redundancy
    census come from the frame's own arrays."""
    j, p = decision_systems(sensor)
    N, L = 512, 4
    rng = np.random.RandomState(0)
    level = rng.randint(0, L, N).astype(np.int32)
    valid = rng.rand(N) < 0.9
    Res = collections.namedtuple("Res", "obs_point n_inliers")
    n, wants = 0, 0
    for since in (1, 3, 8):
        for n_inl in (10, 60, 120, 200):
            for n_ref in (50, 150, 400):
                for n_close, n_close_tracked in ((60, 10), (60, 50), (15, 5)):
                    for red in (0.0, 1.0):
                        for n_kfs in (1, 4):
                            depth = np.full(N, 30.0, np.float32)   # far: th is 4.0
                            depth[np.where(valid)[0][:n_close]] = 2.0
                            obs = np.full(N, -1, np.int32)
                            trk = np.where(valid)[0]
                            # tracked: the first n_close_tracked close ones, then far ones
                            sel = np.concatenate([trk[:n_close_tracked],
                                                  trk[n_close:n_close + n_inl]])[:n_inl]
                            obs[sel] = np.arange(len(sel))
                            red_cum = np.full((4096, L), 3.0 * red, np.float32)
                            out = []
                            for slam, arr, F in ((j, jnp.asarray, jfe.FrameFeatures),
                                                 (p, t, fe.FrameFeatures)):
                                z = np.zeros(N, np.float32)
                                feats = F(uv=None, uv_und=None, level=arr(level), angle=None,
                                          score=None, desc=None, valid=arr(valid), ur=arr(z),
                                          depth=arr(depth))
                                slam.frame_id, slam.last_kf_frame = 20, 20 - since
                                slam.map = slam.map._replace(n_kf=arr(np.int32(n_kfs)))
                                slam._red_cum = arr(red_cum)
                                monkeypatch.setattr(slam, "_ref_kf_tracked",
                                                    lambda min_obs, n_ref=n_ref: n_ref)
                                out.append(slam._need_new_keyframe(
                                    n_inl, feats, Res(arr(obs), arr(np.int32(n_inl)))))
                            assert out[0] == out[1], (since, n_inl, n_ref, n_close,
                                                      n_close_tracked, red, n_kfs)
                            n += 1
                            wants += out[1]
    assert n == 432 and 40 < wants < n - 40


def test_close_census_counts():
    """``stats[2:4]`` by hand: close = valid, 0 < depth < depth_th * bf / fx."""
    fcfg = make_cfg(fe, ms, sysm, "rgbd", device="cpu").frontend   # th = 40 * 0.1 = 4.0
    depth = torch.tensor([0.0, 1.0, 3.9, 4.0, 5.0, 2.0, 2.0, -1.0])
    valid = torch.tensor([True, True, True, True, True, False, True, True])
    obs = torch.tensor([3, -1, 7, 2, -1, 5, 9, 1], dtype=torch.int32)
    feats = fe.FrameFeatures(None, None, None, None, None, None, valid, None, depth)
    n_tc, n_nc = sysm._close_census(fcfg, feats, obs)
    assert (int(n_tc), int(n_nc)) == (2, 1)
