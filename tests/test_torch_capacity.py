"""The port's pool compaction / growth and its synchronous path against the
reference package.

All on the CPU; inputs come from numpy and JAX seeds.

- ``compact_points``, ``compact_keyframes``, ``grow_map``: every field of
  the resulting map identical to the reference's on the maps of
  ``tests/test_map_and_mapping.py`` (the functions only move rows);
- ``_np_se3_compose`` / ``_np_se3_inverse``: within 1e-6 of the reference's;
- ``System._compact_keyframes`` and ``_remap_point_ids``: integer ids and
  the map identical to the reference's on the same state, re-anchored
  relative poses within 1e-6, and ``full_trajectory()`` unchanged (1e-5);
- the capacity run of ``tests/test_system_extended.py:228-273`` (a 10-slot
  keyframe pool) on the port, through the pipelined and the synchronous
  path, held to that test's own bar; a point pool of 2048 slots under an
  RGB-D run (up to 2N = 1024 points per keyframe) must compact or grow;
- the synchronous path (``ORB_SYNC_TRACK=1`` on both sides) over
  ``tests/test_torch_slice.py``'s mono sequence: the same initialization
  frame, tracked count within 2, keyframes created within 1, per-frame
  camera centres within 1% of the span; and the port's pipelined run against
  its synchronous one: both under 5% ATE, and an RMSE between them under 5%
  of the span after a sim(3) alignment (read: 2.4%; the pipelined keyframe
  decision lags one frame, so the keyframe schedules differ, and each path
  agrees with the reference's own twin to 1%).
"""

import dataclasses
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from test_map_and_mapping import CFG, make_two_kf_map, rand_desc  # noqa: E402

from orbslam2_with_quadrics_tpu.models import frontend as jfe  # noqa: E402
from orbslam2_with_quadrics_tpu.models import map_state as jms  # noqa: E402
from orbslam2_with_quadrics_tpu.models import system as jsys  # noqa: E402
from orbslam2_with_quadrics_tpu.ops import lie as jlie  # noqa: E402
from orbslam2_with_quadrics_tpu.utils import metrics  # noqa: E402
from orbslam2_with_quadrics_tpu.utils import synthetic as jsyn  # noqa: E402
from orbslam2_with_quadrics_tpu_torch.models import frontend as fe  # noqa: E402
from orbslam2_with_quadrics_tpu_torch.models import map_state as ms  # noqa: E402
from orbslam2_with_quadrics_tpu_torch.models import system as sysm  # noqa: E402


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


def t(a):
    return torch.as_tensor(np.array(a))


def assert_maps_identical(m, jm):
    got = ms.map_state_to_numpy(m)
    for f in jm._fields:
        ref = np.asarray(getattr(jm, f))
        assert got[f].shape == ref.shape and got[f].dtype == ref.dtype, f
        np.testing.assert_array_equal(got[f], ref, err_msg=f)


def culled_points_map():
    """``test_compact_points_preserves_observations``'s map: every third
    point culled, observations of culled points cleared."""
    m, *_ = make_two_kf_map()
    P = m.pt_pos.shape[0]
    kill = np.zeros((P,), bool)
    kill[::3] = True
    valid = np.asarray(m.pt_valid) & ~kill
    obs = np.asarray(m.kf_obs_point)
    obs_ok = (obs >= 0) & valid[np.clip(obs, 0, P - 1)]
    return m._replace(pt_valid=jnp.asarray(valid),
                      kf_obs_point=jnp.asarray(np.where(obs_ok, obs, -1)))


def culled_keyframe_map():
    """``test_compact_keyframes_remaps_graph``'s map: a third keyframe
    parented on #1, then #1 culled and its child re-parented on #0."""
    m, *_ = make_two_kf_map()
    N = CFG.n_features
    m, s2 = jms.insert_keyframe(
        m, jlie.se3_identity(), jnp.asarray(2, jnp.int32), jnp.zeros((N, 2)),
        jnp.full((N,), -1.0), jnp.zeros((N,), jnp.int32), jnp.zeros((N,)),
        rand_desc(jax.random.PRNGKey(5), N), jnp.ones((N,), bool),
        jnp.full((N,), -1, jnp.int32), jnp.asarray(1, jnp.int32))
    return m._replace(
        kf_valid=m.kf_valid.at[1].set(False),
        kf_parent=m.kf_parent.at[int(s2)].set(0),
        kf_obs_point=m.kf_obs_point.at[1].set(jnp.full((N,), -1, jnp.int32)),
        pt_first_kf=jnp.where(m.pt_first_kf == 1, 0, m.pt_first_kf))


def kf_permutation(kf_valid):
    order = np.argsort(np.where(kf_valid, 0, 1), kind="stable").astype(np.int32)
    new_idx = np.cumsum(kf_valid.astype(np.int32)) - 1
    return order, np.where(kf_valid, new_idx, -1).astype(np.int32)


# ---------------------------------------------------------------------------
# map_state
# ---------------------------------------------------------------------------

def test_compact_points_matches_reference():
    jm = culled_points_map()
    ref, ref_idx = jms.compact_points(jm)
    got, got_idx = ms.compact_points(ms.map_state_from_numpy(jm))
    assert_maps_identical(got, ref)
    assert got_idx.dtype == torch.int32
    np.testing.assert_array_equal(got_idx.numpy(), np.asarray(ref_idx))
    assert int(got.n_pt) == int(np.asarray(jm.pt_valid).sum()) < int(jm.n_pt)


def test_compact_keyframes_matches_reference():
    jm = culled_keyframe_map()
    order, new_idx = kf_permutation(np.asarray(jm.kf_valid))
    ref = jms.compact_keyframes(jm, jnp.asarray(order), jnp.asarray(new_idx))
    got = ms.compact_keyframes(ms.map_state_from_numpy(jm), t(order), t(new_idx))
    assert_maps_identical(got, ref)
    assert int(got.n_kf) == 2 and int(got.kf_frame_id[1]) == 2 and int(got.kf_parent[1]) == 0


@pytest.mark.parametrize("grow", [dict(new_K=16), dict(new_P=512), dict(new_K=16, new_P=512),
                                  dict()], ids=["K", "P", "both", "neither"])
def test_grow_map_matches_reference(grow):
    jm, *_ = make_two_kf_map()
    ref = jms.grow_map(jm, **grow)
    got = ms.grow_map(ms.map_state_from_numpy(jm), **grow)
    assert_maps_identical(got, ref)
    # inserting still works after growth, and the carried-across map takes
    # its shapes from the arrays, not from a MapConfig
    ones = jnp.ones((4,), bool)
    ref2, ref_ids = jms.insert_points(ref, jnp.ones((4, 3)), jnp.zeros((4, 8), jnp.uint32),
                                      jnp.zeros((4,), jnp.int32), ones)
    got2, got_ids = ms.insert_points(ms.map_state_from_numpy(ref), torch.ones(4, 3),
                                     torch.zeros(4, 8, dtype=torch.int32),
                                     torch.zeros(4, dtype=torch.int32), t(ones))
    assert_maps_identical(got2, ref2)
    np.testing.assert_array_equal(got_ids.numpy(), np.asarray(ref_ids))


def test_np_se3_helpers_match_reference():
    rng = np.random.RandomState(0)
    for _ in range(20):
        a = np.asarray(jlie.se3_exp(jnp.asarray(rng.uniform(-2, 2, 6), jnp.float32)))
        b = np.asarray(jlie.se3_exp(jnp.asarray(rng.uniform(-2, 2, 6), jnp.float32)))
        np.testing.assert_allclose(sysm._np_se3_compose(a, b), jsys._np_se3_compose(a, b),
                                   atol=1e-6)
        np.testing.assert_allclose(sysm._np_se3_inverse(a), jsys._np_se3_inverse(a),
                                   atol=1e-6)
        assert sysm._np_se3_compose(a, b).dtype == np.float32


# ---------------------------------------------------------------------------
# System: the id fix-ups around a compaction
# ---------------------------------------------------------------------------

def small_systems():
    jcfg = jsys.SystemConfig(
        frontend=jfe.FrontendConfig(height=H, width=W, n_features=64, n_levels=4),
        map=CFG)
    cfg = sysm.SystemConfig(
        frontend=fe.FrontendConfig(height=H, width=W, n_features=64, n_levels=4),
        map=ms.MapConfig(max_keyframes=8, max_points=256, n_features=64, n_levels=4,
                         device="cpu"))
    return jsys.System(jcfg), sysm.System(cfg)


def test_compact_keyframes_reanchors_host_ids_as_reference():
    """A chain 0 <- 1 <- 2 <- 3 with 1 and 2 culled (frozen T_child_parent
    kept), trajectory entries anchored on live and on culled slots."""
    jm = culled_keyframe_map()
    N = CFG.n_features
    rng = np.random.RandomState(3)

    def pose():
        return jlie.se3_exp(jnp.asarray(rng.uniform(-0.3, 0.3, 6), jnp.float32))

    jm, s3 = jms.insert_keyframe(
        jm, pose(), jnp.asarray(3, jnp.int32), jnp.zeros((N, 2)), jnp.full((N,), -1.0),
        jnp.zeros((N,), jnp.int32), jnp.zeros((N,)), rand_desc(jax.random.PRNGKey(6), N),
        jnp.ones((N,), bool), jnp.full((N,), -1, jnp.int32), jnp.asarray(2, jnp.int32))
    jm = jm._replace(
        kf_valid=jm.kf_valid.at[2].set(False),
        kf_parent=jm.kf_parent.at[2].set(1).at[1].set(0).at[int(s3)].set(0),
        kf_tcp=jm.kf_tcp.at[1].set(pose()).at[2].set(pose()),
        pt_first_kf=jm.pt_first_kf.at[:5].set(2).at[5:8].set(1))
    traj = [(i, 0.1 * i, ref, np.array(pose())) for i, ref in enumerate([0, 1, 2, 3, 2])]
    jslam, slam = small_systems()
    jslam.map, slam.map = jm, ms.map_state_from_numpy(jm)
    jslam.trajectory, slam.trajectory = list(traj), list(traj)
    jslam.ref_kf = slam.ref_kf = 2
    before = [T for _, _, T in slam.full_trajectory()]
    jslam._compact_keyframes()
    slam._compact_keyframes()
    assert_maps_identical(slam.map, jslam.map)
    assert slam.ref_kf == jslam.ref_kf == 0
    assert int(slam.map.n_kf) == 2
    for (f, ts, ref, T), (jf, jts, jref, jT) in zip(slam.trajectory, jslam.trajectory):
        assert (f, ts, ref) == (jf, jts, jref)
        np.testing.assert_allclose(T, jT, atol=1e-6)
    after = [T for _, _, T in slam.full_trajectory()]
    for b, a in zip(before, after):
        np.testing.assert_allclose(a, b, atol=1e-5)


def test_remap_point_ids_matches_reference():
    jm = culled_points_map()
    jslam, slam = small_systems()
    old_valid = np.asarray(jm.pt_valid)
    rng = np.random.RandomState(1)
    obs = [np.where(rng.rand(64) < 0.7, rng.randint(0, 40, 64), -1).astype(np.int32)
           for _ in range(3)]
    jslam.prev_obs, jslam._pend, jslam._extra_obs_holders = (
        jnp.asarray(obs[0]), {"obs": jnp.asarray(obs[1])}, [{"obs": jnp.asarray(obs[2])}])
    slam.prev_obs, slam._pend, slam._extra_obs_holders = (
        t(obs[0]), {"obs": t(obs[1])}, [{"obs": t(obs[2])}])
    jm2, jidx = jms.compact_points(jm)
    m2, idx = ms.compact_points(ms.map_state_from_numpy(jm))
    jslam._remap_point_ids(np.asarray(jidx), old_valid)
    slam._remap_point_ids(idx, t(old_valid))
    for got, ref in ((slam.prev_obs, jslam.prev_obs), (slam._pend["obs"], jslam._pend["obs"]),
                     (slam._extra_obs_holders[0]["obs"], jslam._extra_obs_holders[0]["obs"])):
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    assert (slam.prev_obs.numpy() >= 0).sum() > 5
    assert ((obs[0] >= 0) & (slam.prev_obs.numpy() < 0)).sum() > 5   # culled ones dropped


# ---------------------------------------------------------------------------
# capacity runs
# ---------------------------------------------------------------------------

def capacity_cfg(pkg_fe, pkg_ms, pkg_sys, sensor="mono", **map_kw):
    """``tests/test_system_extended.py``'s configuration."""
    return pkg_sys.SystemConfig(
        frontend=pkg_fe.FrontendConfig(
            height=H, width=W, n_features=512, n_levels=4, fx=FX, fy=FX, cx=W / 2,
            cy=H / 2, bf=0.0 if sensor == "mono" else 0.1 * FX),
        map=pkg_ms.MapConfig(**{**dict(max_keyframes=48, max_points=8192, n_features=512,
                                       n_levels=4), **map_kw}),
        sensor=sensor, max_frames_between_kf=6, kf_close_tracked_th=250,
        kf_close_untracked_th=40)


def ate_and_span(traj, poses, with_scale=True):
    est = [metrics.se3_vec_to_mat(np.asarray(T)) for _, _, T in traj]
    c_gt = metrics.camera_centers_from_Tcw([poses[f] for f, _, _ in traj])
    ate = metrics.ate_rmse(metrics.camera_centers_from_Tcw(est), c_gt, with_scale=with_scale)
    return ate, np.linalg.norm(c_gt.max(0) - c_gt.min(0))


@pytest.mark.parametrize("sync", [False, True], ids=["pipelined", "synchronous"])
def test_capacity_growth_and_compaction(sync, monkeypatch):
    """A keyframe pool far smaller than the sequence demands: the pool
    compacts culled slots or doubles, and tracking runs to the end."""
    monkeypatch.setenv("ORB_SYNC_TRACK", "1" if sync else "")
    imgs, poses, _ = jsyn.planar_sequence(n_frames=24, h=H, w=W, fx=FX, fy=FX, seed=11)
    cfg = dataclasses.replace(
        capacity_cfg(fe, ms, sysm, max_keyframes=10, device="cpu"),
        kf_idle_frames=1, max_frames_between_kf=2)
    slam = sysm.System(cfg)
    assert slam._force_sync == sync
    for i in range(len(imgs)):
        slam.track_monocular(imgs[i], timestamp=i / 30.0)
    slam.shutdown()
    assert slam.get_tracking_state() == sysm.System.OK
    assert slam.n_kfs_created + 2 > 10       # + the two initialization keyframes
    assert slam.n_kf_growths + slam.n_kf_compactions >= 1
    pool = slam.map.kf_valid.shape[0]
    assert int(slam.map.n_kf) <= pool and (pool > 10) == (slam.n_kf_growths > 0)
    assert slam._protect_mask().shape[0] == pool
    traj = slam.full_trajectory()
    assert len(traj) == len(imgs)
    ate, span = ate_and_span(traj, poses)
    assert ate < 0.12 * span
    ids, pos = slam.get_tracked_map_points()
    assert len(ids) >= 30 and pos.shape == (len(ids), 3)
    assert slam.get_tracked_keypoints_un().shape[1] == 2


def test_point_pool_fills_under_rgbd():
    """2048 point slots, up to 1024 new points per RGB-D keyframe: the
    pool must compact or double, and the observations held by the
    pipeline must follow the remap."""
    imgs, poses, K = jsyn.planar_sequence(n_frames=20, h=H, w=W, fx=FX, fy=FX, seed=3)
    depths = [jsyn.planar_depth(T, K, H, W) for T in poses]
    cfg = dataclasses.replace(
        capacity_cfg(fe, ms, sysm, sensor="rgbd", max_points=2048, device="cpu"),
        max_frames_between_kf=4)
    slam = sysm.System(cfg)
    for i in range(len(imgs)):
        slam.track_rgbd(imgs[i], depths[i], timestamp=i / 30.0)
    slam.shutdown()
    assert slam.state == sysm.System.OK
    assert slam.n_point_growths + slam.n_point_compactions >= 1
    P = slam.map.pt_pos.shape[0]
    assert (P > 2048) == (slam.n_point_growths > 0) and int(slam.map.n_pt) <= P
    assert slam._red_cum is None or slam._red_cum.shape[0] == P
    assert slam._get_obs_A().shape == (slam.map.kf_valid.shape[0], P)
    ate, _ = ate_and_span(slam.full_trajectory(), poses, with_scale=False)
    assert ate < 0.08


def test_localization_mode_freezes_the_map():
    imgs, _, _ = jsyn.planar_sequence(n_frames=25, h=H, w=W, fx=FX, fy=FX, seed=3)
    cfg = dataclasses.replace(capacity_cfg(fe, ms, sysm, device="cpu"),
                              max_frames_between_kf=8)
    slam = sysm.System(cfg)
    for i in range(12):
        slam.track_monocular(imgs[i], timestamp=i / 30.0)
    slam.shutdown()
    n_kf, n_pt = int(slam.map.n_kf), int(slam.map.n_pt)
    assert slam.get_tracking_state() == sysm.System.OK and n_kf >= 2
    slam.activate_localization_mode()
    for i in range(12, 20):
        slam.track_monocular(imgs[i], timestamp=i / 30.0)
    slam.shutdown()
    assert slam.get_tracking_state() == sysm.System.OK
    assert (int(slam.map.n_kf), int(slam.map.n_pt)) == (n_kf, n_pt)
    slam.deactivate_localization_mode()
    for i in range(20, 25):
        slam.track_monocular(imgs[i], timestamp=i / 30.0)
    slam.shutdown()
    assert int(slam.map.n_kf) > n_kf


# ---------------------------------------------------------------------------
# the synchronous path
# ---------------------------------------------------------------------------

def slice_cfg(pkg_fe, pkg_ms, pkg_sys, **map_kw):
    """``tests/test_torch_slice.py``'s configuration."""
    return pkg_sys.SystemConfig(
        frontend=pkg_fe.FrontendConfig(height=H, width=W, n_features=512, n_levels=4,
                                       fx=FX, fy=FX, cx=W / 2, cy=H / 2),
        map=pkg_ms.MapConfig(max_keyframes=32, max_points=4096, n_features=512,
                             n_levels=4, **map_kw),
        max_frames_between_kf=8)


def centers(traj):
    return {f: metrics.camera_centers_from_Tcw([metrics.se3_vec_to_mat(np.asarray(T))])[0]
            for f, _, T in traj}


@pytest.fixture(scope="module")
def sync_runs():
    """The reference and the port through their synchronous paths, and the
    port through its pipelined one, over the same 25 frames."""
    imgs, poses, _ = jsyn.planar_sequence(n_frames=25, h=H, w=W, fx=FX, fy=FX, seed=3)
    out = {"poses": poses}
    old = os.environ.get("ORB_SYNC_TRACK")
    try:
        for name, flag, make in (
                ("ref_sync", "1", lambda: jsys.System(slice_cfg(jfe, jms, jsys))),
                ("sync", "1", lambda: sysm.System(slice_cfg(fe, ms, sysm, device="cpu"))),
                ("fast", "", lambda: sysm.System(slice_cfg(fe, ms, sysm, device="cpu")))):
            os.environ["ORB_SYNC_TRACK"] = flag
            slam = make()
            calls = {"n": 0}
            if name == "sync":   # the pipelined program must not run at all
                orig = sysm._frame_step
                sysm._frame_step = lambda *a, **k: calls.__setitem__("n", calls["n"] + 1)
            try:
                for i in range(len(imgs)):
                    slam.track_monocular(imgs[i], timestamp=i / 30.0)
                slam.shutdown()
            finally:
                if name == "sync":
                    sysm._frame_step = orig
            out[name] = {"slam": slam, "traj": slam.full_trajectory(), "calls": calls["n"]}
    finally:
        if old is None:
            os.environ.pop("ORB_SYNC_TRACK", None)
        else:
            os.environ["ORB_SYNC_TRACK"] = old
    return out


def test_sync_path_matches_reference_sync_path(sync_runs):
    got, ref = sync_runs["sync"], sync_runs["ref_sync"]
    slam, jslam = got["slam"], ref["slam"]
    assert slam._force_sync and jslam._force_sync and got["calls"] == 0
    assert slam.state == sysm.System.OK
    assert slam.init_frame_id == jslam.init_frame_id
    n_tr = sum(1 for m in slam.metrics if not m.get("lost"))
    j_tr = sum(1 for m in jslam.metrics if not m.get("lost"))
    assert n_tr >= 18 and abs(n_tr - j_tr) <= 2
    # keyframes went in through _insert_keyframe, past initialization
    assert slam.n_kfs_created >= 2 and abs(slam.n_kfs_created - jslam.n_kfs_created) <= 1
    assert len(got["traj"]) == len(ref["traj"]) == 25
    ate, span = ate_and_span(got["traj"], sync_runs["poses"])
    assert ate < 0.05 * span
    cp, cj = centers(got["traj"]), centers(ref["traj"])
    cjs = np.stack(list(cj.values()))
    est_span = np.linalg.norm(cjs.max(0) - cjs.min(0))
    first = slam.init_frame_id + 1
    worst = max(np.linalg.norm(cp[f] - cj[f]) for f in cp if f >= first)
    assert worst < 0.01 * est_span


def test_sync_and_pipelined_paths_agree(sync_runs):
    a, b = sync_runs["sync"], sync_runs["fast"]
    assert not b["slam"]._force_sync
    assert a["slam"].init_frame_id == b["slam"].init_frame_id
    assert abs(a["slam"].n_kfs_created - b["slam"].n_kfs_created) <= 2
    for run in (a, b):
        ate, span = ate_and_span(run["traj"], sync_runs["poses"])
        assert ate < 0.05 * span
    ca, cb = centers(a["traj"]), centers(b["traj"])
    frames = [f for f in ca if f > a["slam"].init_frame_id]
    pa, pb = np.stack([ca[f] for f in frames]), np.stack([cb[f] for f in frames])
    span = np.linalg.norm(pa.max(0) - pa.min(0))
    rmse = metrics.ate_rmse(pb, pa)
    print(f"pipelined vs synchronous: RMSE {rmse / span:.4f} of the span")
    assert rmse < 0.05 * span
