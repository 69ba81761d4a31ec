"""The mapping pass's accelerator branch against the reference's, on the CPU.

- ``map_state.update_point_stats_local`` against the reference's on random
  maps from numpy seeds (16 keyframes x 128 keypoints, 1,024 points), whose
  keyframe 0 shares 12, 10 or 8 points with each other keyframe so that the
  top-10 covisible cut falls inside a tie; once with the touched set under
  ``n_local`` (4,096) and once truncated to 64. ``pt_desc`` bit-equal (the
  votes and counts are integers in float32, exact in any order), normals
  within 1e-5, distances within 1e-5 relative (another order of summation),
  and every point outside the touched set bit-equal to its input;
- ``system._insert_and_map`` as the accelerator program in both packages
  (the reference with ``jax.default_backend`` answering ``"gpu"``, which
  turns on its local statistics and dense local BA together; the port with
  ``local_mapping.on_accelerator`` answering True) on the map of the port's
  System after its second keyframe (``tests/test_torch_slice.py``'s
  sequence and features, 16 / 2,048 slots): ``tests/test_torch_slice.py``'s
  bars for the pass, plus ``pt_desc`` equal on >= 99.5% of live points;
- a map on the CPU takes the full-pool statistics, in the mapping pass and
  everywhere else the System refreshes them.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orbslam2_with_quadrics_tpu.models import frontend as jfe
from orbslam2_with_quadrics_tpu.models import map_state as jms
from orbslam2_with_quadrics_tpu.models import system as jsys
from orbslam2_with_quadrics_tpu.ops import orb as jorb
from orbslam2_with_quadrics_tpu_torch.models import frontend as fe
from orbslam2_with_quadrics_tpu_torch.models import local_mapping as lm
from orbslam2_with_quadrics_tpu_torch.models import map_state as ms
from orbslam2_with_quadrics_tpu_torch.models import system as sysm
from orbslam2_with_quadrics_tpu_torch.ops import orb
from orbslam2_with_quadrics_tpu_torch.utils import synthetic

K, N, P, LEVELS = 16, 128, 1024, 8
STAT_FIELDS = ("pt_desc", "pt_normal", "pt_max_dist", "pt_min_dist")


def tied_map(seed):
    """Keyframe 0 observes points 0..N-1; keyframe k > 0 observes a shared
    count s_k of them (12, 12, then ten of 10, then three of 8, shuffled:
    the 10th and 11th largest weights tie) and the rest of its row among the
    other points. 5% of the unshared keypoints are invalid, 15% of the
    unshared slots empty. Returns the map as numpy arrays."""
    rng = np.random.RandomState(seed)
    m = ms.map_state_to_numpy(ms.empty_map(ms.MapConfig(
        max_keyframes=K, max_points=P, n_features=N, n_levels=LEVELS, device="cpu")))
    shares = rng.permutation([12, 12] + [10] * 10 + [8] * 3)
    obs = np.empty((K, N), np.int32)
    kp_valid = np.ones((K, N), bool)
    obs[0] = np.arange(N)
    for k in range(1, K):
        s = shares[k - 1]
        obs[k, :s] = rng.choice(N, s, replace=False)
        obs[k, s:] = rng.choice(np.arange(N, P), N - s, replace=False)
        kp_valid[k, s:] = rng.rand(N - s) > 0.05
        obs[k, s:][rng.rand(N - s) < 0.15] = -1
    q = rng.randn(K, 4)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    m.update(
        kf_pose=np.concatenate([q, rng.randn(K, 3)], 1).astype(np.float32),
        kf_valid=np.ones(K, bool), kf_kp_valid=kp_valid, kf_obs_point=obs,
        kf_level=rng.randint(0, LEVELS, (K, N)).astype(np.int32),
        kf_desc=rng.randint(0, 2**32, (K, N, 8), dtype=np.uint64).astype(np.uint32),
        pt_pos=(rng.randn(P, 3) * 2 + [0, 0, 6]).astype(np.float32),
        pt_valid=np.ones(P, bool),
        pt_desc=rng.randint(0, 2**32, (P, 8), dtype=np.uint64).astype(np.uint32),
        pt_normal=rng.randn(P, 3).astype(np.float32),
        pt_max_dist=rng.rand(P).astype(np.float32),
        pt_min_dist=rng.rand(P).astype(np.float32),
        n_kf=np.int32(K), n_pt=np.int32(P),
    )
    return m


def touched_ids(m, kf, n_neighbors, n_local):
    """The touched set by numpy: ``kf`` and its top covisible keyframes
    (ties in ascending index), their valid observations' smallest
    ``n_local`` distinct point ids."""
    ok = (m["kf_obs_point"] >= 0) & m["kf_kp_valid"] & m["kf_valid"][:, None]
    A = np.zeros((K, P), np.int64)
    for k in range(K):
        A[k, m["kf_obs_point"][k][ok[k]]] = 1
    w = A @ A[kf]
    w[kf] = 0
    order = np.argsort(-w, kind="stable")[:n_neighbors]
    cams = [kf] + [c for c in order if w[c] > 0]
    ids = np.unique(np.concatenate([m["kf_obs_point"][c][ok[c]] for c in cams]))
    return ids[:n_local], np.sort(w)[::-1]


@pytest.mark.parametrize("n_local", [4096, 64], ids=["under", "truncated"])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_update_point_stats_local_matches_reference(seed, n_local):
    m = tied_map(seed)
    ids, w_sorted = touched_ids(m, 0, 10, n_local)
    assert w_sorted[9] == w_sorted[10] > 0         # the cut falls inside a tie
    assert (len(ids) == n_local) == (n_local == 64)
    jm = jms.MapState(**{f: jnp.asarray(v) for f, v in m.items()})
    ref = jms.update_point_stats_local(jm, jorb.scale_factors(LEVELS, 1.2)[0],
                                       jnp.asarray(0, jnp.int32), n_local=n_local)
    got = ms.map_state_to_numpy(ms.update_point_stats_local(
        ms.map_state_from_numpy(jm), orb.scale_factors(LEVELS, 1.2, "cpu")[0],
        torch.tensor(0), n_local=n_local))
    ref = {f: np.asarray(getattr(ref, f)) for f in STAT_FIELDS}
    np.testing.assert_array_equal(got["pt_desc"], ref["pt_desc"])
    np.testing.assert_allclose(got["pt_normal"], ref["pt_normal"], atol=1e-5)
    for f in ("pt_max_dist", "pt_min_dist"):
        np.testing.assert_allclose(got[f], ref[f], rtol=1e-5, err_msg=f)
    untouched = np.ones(P, bool)
    untouched[ids] = False
    for f in STAT_FIELDS:
        np.testing.assert_array_equal(got[f][untouched], m[f][untouched], err_msg=f)
    # the touched points did change (a majority of random bits is no input row)
    assert (got["pt_desc"][ids] != m["pt_desc"][ids]).any(1).all()


# ---------------------------------------------------------------------------
# the mapping pass
# ---------------------------------------------------------------------------

H, W, FX = 240, 320, 260.0


def make_cfg(pkg_fe, pkg_ms, pkg_sys, **map_kw):
    return pkg_sys.SystemConfig(
        frontend=pkg_fe.FrontendConfig(height=H, width=W, n_features=512, n_levels=4,
                                       fx=FX, fy=FX, cx=W / 2, cy=H / 2),
        map=pkg_ms.MapConfig(max_keyframes=16, max_points=2048, n_features=512,
                             n_levels=4, **map_kw),
        max_frames_between_kf=8,
    )


@pytest.fixture(scope="module")
def second_pass():
    """The port's System (CPU) over ``planar_sequence(seed=3)`` until its
    second mapping pass; returns that call's arguments, and the
    statistics functions the System called on the way (one PyTorch thread
    meanwhile, restored afterwards)."""
    n_threads = torch.get_num_threads()
    torch.set_num_threads(1)
    imgs, _, _ = synthetic.planar_sequence(n_frames=25, h=H, w=W, fx=FX, fy=FX, seed=3)
    calls, stats = [], []
    orig = sysm._insert_and_map, ms.update_point_stats, ms.update_point_stats_local

    def record(*a, **k):
        calls.append(a)
        return orig[0](*a, **k)

    def spy(name, fn):
        def call(*a, **k):
            stats.append(name)
            return fn(*a, **k)
        return call

    sysm._insert_and_map = record
    ms.update_point_stats = spy("full", orig[1])
    ms.update_point_stats_local = spy("local", orig[2])
    try:
        slam = sysm.System(make_cfg(fe, ms, sysm, device="cpu"))
        for i, img in enumerate(imgs):
            slam.track_monocular(img, timestamp=i / 30.0)
            if len(calls) == 2:
                break
    finally:
        sysm._insert_and_map, ms.update_point_stats, ms.update_point_stats_local = orig
        torch.set_num_threads(n_threads)
    assert len(calls) == 2
    return calls[1], stats


def test_insert_and_map_accelerator_program_matches_reference(second_pass, monkeypatch):
    args, _ = second_pass
    (m, feats, T_cw, frame_id, parent, obs_row, protect, inv_sigma2, _fcfg, sensor,
     window) = args
    jm = jms.MapState(**{f: jnp.asarray(v) for f, v in ms.map_state_to_numpy(m).items()})
    jfeats = jfe.FrameFeatures(**{f: jnp.asarray(v)
                                  for f, v in fe.frame_features_to_numpy(feats).items()})
    jax.clear_caches()   # no trace of the other branch is reused, none leaks out
    try:
        with monkeypatch.context() as mp:
            mp.setattr(jax, "default_backend", lambda: "gpu")
            jm2, jaux, _ = jsys._insert_and_map(
                jm, jfeats, jnp.asarray(T_cw.numpy()), np.int32(frame_id), np.int32(parent),
                jnp.asarray(obs_row.numpy()), protect.numpy(), jnp.asarray(inv_sigma2.numpy()),
                make_cfg(jfe, jms, jsys).frontend, sensor, window)
            jax.block_until_ready(jm2)
    finally:
        jax.clear_caches()
    monkeypatch.setattr(lm, "on_accelerator", lambda m: True)
    m2, aux, _ = sysm._insert_and_map(*args)
    got, ref = ms.map_state_to_numpy(m2), {f: np.asarray(getattr(jm2, f)) for f in jm2._fields}
    for f in ("n_kf", "n_pt", "kf_valid", "kf_parent", "kf_frame_id", "kf_desc"):
        np.testing.assert_array_equal(got[f], ref[f], err_msg=f)
    np.testing.assert_array_equal(aux.numpy()[[1, 4, 6]], np.asarray(jaux)[[1, 4, 6]])
    assert (got["kf_obs_point"] == ref["kf_obs_point"]).all(1).mean() >= 0.995
    assert (got["kf_obs_point"] == ref["kf_obs_point"]).mean() >= 0.995
    assert (got["pt_valid"] == ref["pt_valid"]).mean() >= 0.995
    np.testing.assert_allclose(got["kf_pose"], ref["kf_pose"], atol=1e-3)
    live = got["pt_valid"] & ref["pt_valid"]
    err = np.abs(got["pt_pos"][live] - ref["pt_pos"][live]).max(1)
    assert live.sum() > 200 and err.max() < 1e-2 and np.median(err) < 1e-4
    assert (got["pt_desc"][live] == ref["pt_desc"][live]).all(1).mean() >= 0.995


def test_cpu_map_takes_the_full_pool(second_pass, monkeypatch):
    """On the CPU the System refreshed statistics through the full pool
    only; the mapping pass takes the local branch exactly when
    ``on_accelerator`` says so, and then writes other descriptors."""
    args, seen = second_pass
    assert "full" in seen and "local" not in seen
    calls = []
    for name in ("update_point_stats", "update_point_stats_local"):
        fn = getattr(ms, name)
        monkeypatch.setattr(ms, name, lambda *a, _n=name, _f=fn, **k: calls.append(_n)
                            or _f(*a, **k))
    cpu_map = sysm._insert_and_map(*args)[0]
    assert calls == ["update_point_stats"] * 2
    calls.clear()
    monkeypatch.setattr(lm, "on_accelerator", lambda m: True)
    acc_map = sysm._insert_and_map(*args)[0]
    assert calls == ["update_point_stats_local"] * 2
    live = (cpu_map.pt_valid & acc_map.pt_valid).numpy()
    differ = (cpu_map.pt_desc != acc_map.pt_desc).any(1).numpy()[live]
    assert differ.mean() > 0.5
