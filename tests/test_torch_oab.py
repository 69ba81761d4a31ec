"""The out-and-back diagnosis (``scripts/debug_oab.py``) and the mono
out-and-back mechanism, the port against the reference package, on the CPU
with one PyTorch thread (module fixture).

- ``debug_oab.oab_row`` on a map the port's System built (``debug_oab``'s
  configuration, the first frames of its out-and-back sequence), against the
  reference script's computation (``scripts/debug_oab.py:56-94``) redone
  with the reference's ``camera.project`` and ``tracking.select_local_points``
  on the same map carried across: every count exactly equal.
- The mechanism of the mono out-and-back's missed loop closures, which both
  packages share (a mono out-and-back keeps about 10 of 140 keyframes live,
  so a closure needs an outbound keyframe that culling left near the
  revisited place; which survive follows the keyframe schedule and float
  rounding): on the same carried map, ``cull_keyframes`` called for every
  live keyframe gives the same map in both packages (also with three
  keyframes copied, so that some are redundant), the keyframe database and
  loop detection of the newest keyframe give the same words, covisibility,
  common-word counts and candidates, scores within 1e-5, and one closure
  attempt's Sim3 gates agree (``n_pairs`` exact, the rest within 2, the
  reference's RANSAC draw passed to the port, ``tests/test_torch_loop.py``'s
  bar).
"""

import os
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orbslam2_with_quadrics_tpu.models import map_state as jms
from orbslam2_with_quadrics_tpu.models import tracking as jtr
from orbslam2_with_quadrics_tpu.ops import camera as jcam
from orbslam2_with_quadrics_tpu.ops import lie as jlie
from orbslam2_with_quadrics_tpu_torch.models import map_state as ms
from orbslam2_with_quadrics_tpu_torch.models import system as sysm
from orbslam2_with_quadrics_tpu_torch.scripts import debug_oab
from orbslam2_with_quadrics_tpu_torch.utils import synthetic

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread while this file runs (restored afterwards): the
    suite runs several worker processes on a few cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def reference_row(m, T_cw, prev_obs, K, W, H, n_local_kf, frame, metrics):
    """``scripts/debug_oab.py:56-94`` on a reference-package map."""
    P = m.pt_pos.shape[0]
    uv, z = jcam.project(K, jlie.se3_apply(T_cw, m.pt_pos))
    frus = np.asarray(m.pt_valid & (z > 0.05) & (uv[:, 0] >= 0) & (uv[:, 0] < W)
                      & (uv[:, 1] >= 0) & (uv[:, 1] < H))
    obs = np.asarray(m.kf_obs_point)
    kfv = np.asarray(m.kf_valid)
    kpv = np.asarray(m.kf_kp_valid)
    ref = np.zeros(P + 1, bool)
    rowsok = obs[kfv]
    ref[np.where((rowsok >= 0) & kpv[kfv], rowsok, P)] = True
    pt_ids, _ = jtr.select_local_points(m, prev_obs, min(n_local_kf, 128), 4096,
                                        jms.observation_matrix(m))
    win = np.zeros(P + 1, bool)
    win[np.asarray(pt_ids)] = True
    mtr = metrics[-1] if metrics else {}
    return {
        "frame": frame,
        "n_frustum": int(frus.sum()),
        "n_reachable": int((frus & ref[:P]).sum()),
        "n_window": int((frus & win[:P]).sum()),
        "matches": int(mtr.get("matches", -1)),
        "inliers": int(mtr.get("inliers", -1)),
        "kfs_live": int(kfv.sum()),
        "pts_live": int(np.asarray(m.pt_valid).sum()),
    }


@pytest.fixture(scope="module")
def oab_system():
    """The port's System at ``debug_oab``'s configuration after the first
    frames of its sequence (initialized, with keyframes)."""
    slam = sysm.System(debug_oab.make_config("cpu"))
    stream = synthetic.planar_stream(
        n_frames=800, h=debug_oab.H, w=debug_oab.W, fx=debug_oab.FX, fy=debug_oab.FX, seed=3,
        motion="out_and_back", plane_half=8.0, relief=True, noise=6.0, tex_size=4000)
    for i, (img, _) in enumerate(stream):
        slam.track_monocular(np.clip(img, 0, 255).astype(np.uint8), timestamp=i / 30.0)
        if i >= 24 and slam.state == slam.OK and slam.n_kfs_created >= 4:
            break
    yield slam, i
    slam.shutdown()


def test_oab_row_equals_reference_computation(oab_system):
    slam, frame = oab_system
    got = debug_oab.oab_row(slam, frame)
    arrays = ms.map_state_to_numpy(slam.map)
    jm = jms.MapState(**{k: jnp.asarray(v) for k, v in arrays.items()})
    fcfg = slam.cfg.frontend
    want = reference_row(jm, jnp.asarray(slam.T_cw.numpy()), jnp.asarray(slam.prev_obs.numpy()),
                         jnp.asarray(fcfg.K.numpy()), fcfg.width, fcfg.height,
                         slam.cfg.n_local_kf, frame, slam.metrics)
    assert got == want
    assert 0 < got["n_window"] <= got["n_reachable"] <= got["n_frustum"]
    assert got["kfs_live"] >= 3 and got["inliers"] > 0


def with_copies(arrays, slots):
    """The map with the keyframes ``slots`` copied into the next free slots:
    their points gain observers, so culling has redundant keyframes to find."""
    a = {k: np.array(v) for k, v in arrays.items()}
    n = int(a["n_kf"])
    for i, s in enumerate(slots):
        for f in ("kf_pose", "kf_valid", "kf_frame_id", "kf_parent", "kf_tcp", "kf_uv", "kf_ur",
                  "kf_level", "kf_angle", "kf_desc", "kf_kp_valid", "kf_obs_point"):
            a[f][n + i] = a[f][s]
        a["kf_frame_id"][n + i] += 1
    a["n_kf"] = np.asarray(n + len(slots), np.int32)
    return a


def test_culling_and_detection_equal_reference(oab_system):
    """The mechanism of the missed out-and-back closures, on one map
    carried across: keyframe culling decides which
    keyframes of the places already visited survive (on the System's map,
    and on the map with three keyframes copied, where some are redundant),
    and loop detection scores the newest keyframe against the survivors,
    each package's database built from the same map on its own copy of the
    shipped vocabulary."""
    from orbslam2_with_quadrics_tpu.models import local_mapping as jlm
    from orbslam2_with_quadrics_tpu.models import loop_closing as jlc
    from orbslam2_with_quadrics_tpu.ops import vocab as jvocab
    from orbslam2_with_quadrics_tpu_torch.models import local_mapping as lm
    from orbslam2_with_quadrics_tpu_torch.models import loop_closing as lc

    slam, _ = oab_system
    base = ms.map_state_to_numpy(slam.map)
    culled = []
    for arrays in (base, with_copies(base, [2, 3, 4])):
        m = ms.map_state_from_numpy(SimpleNamespace(**arrays))
        jm = jms.MapState(**{k: jnp.asarray(v) for k, v in arrays.items()})
        W = ms.covisibility(m)
        np.testing.assert_array_equal(W.numpy(), np.asarray(jms.covisibility(jm)))
        for s in np.where(arrays["kf_valid"])[0]:
            got = ms.map_state_to_numpy(lm.cull_keyframes(m, torch.tensor(int(s)), None, W))
            want = jlm.cull_keyframes(jm, int(s), None, jms.covisibility(jm))
            for f in ("kf_valid", "kf_parent", "kf_obs_point"):
                np.testing.assert_array_equal(got[f], np.asarray(getattr(want, f)), err_msg=f)
            np.testing.assert_allclose(got["kf_tcp"], np.asarray(want.kf_tcp), atol=1e-5)
            culled.append(int(arrays["kf_valid"].sum() - got["kf_valid"].sum()))
    assert sum(culled) > 0

    m = slam.map
    jm = jms.MapState(**{k: jnp.asarray(v) for k, v in base.items()})
    live = np.where(base["kf_valid"])[0]
    closer = lc.LoopCloser(slam.loop_closer.voc, slam.cfg.map)
    jvoc = jvocab.load(os.path.join(REPO, "orbslam2_with_quadrics_tpu", "assets",
                                    "vocab_100k.npz"))
    jcfg = jms.MapConfig(max_keyframes=m.kf_valid.shape[0], max_points=m.pt_pos.shape[0],
                         n_features=m.kf_obs_point.shape[1], n_levels=8)
    jcl = jlc.LoopCloser(jvoc, jcfg)
    for s in range(int(base["n_kf"])):
        closer.add_keyframe_from_map(m, s)
        jcl.add_keyframe_from_map(jm, s)
    np.testing.assert_array_equal(closer.words.numpy(), np.asarray(jcl.words))
    slot = int(live[np.argmax(base["kf_frame_id"][live])])
    pW, ps_, pc_ = (a.numpy() for a in lc._detect_prep_sparse(
        m, closer.kf_wid, closer.kf_wval, closer.words, closer.voc.idf, slot))
    jW, js_, jc_ = (np.asarray(a) for a in jlc._detect_prep_sparse(
        jm, jcl.kf_wid, jcl.kf_wval, jcl.words, jcl.voc.idf, slot))
    np.testing.assert_array_equal(pW, jW)
    np.testing.assert_allclose(ps_, js_, atol=1e-5)
    np.testing.assert_array_equal(pc_, jc_)
    assert closer._detect_host(slot, pW, ps_, pc_) == jcl._detect_host(slot, jW, js_, jc_)


def reference_draw(jm, slot, cand):
    """The [128, 3] minimal sets the reference's ``_sim3_geometry`` draws
    (``PRNGKey(0)`` over the valid pairs), as ``tests/test_torch_loop.py``
    rebuilds them."""
    import jax

    from orbslam2_with_quadrics_tpu.ops import matching as jmatch

    n = jm.kf_obs_point.shape[1]
    mi, _ = jmatch.mutual_match(jm.kf_desc[slot], jm.kf_kp_valid[slot], jm.kf_desc[cand],
                                jm.kf_kp_valid[cand], th=jmatch.TH_LOW, ratio=0.75)
    pair_ok = ((mi >= 0) & (jm.kf_obs_point[slot] >= 0)
               & (jm.kf_obs_point[cand, jnp.clip(mi, 0, n - 1)] >= 0))
    gum = -jnp.log(-jnp.log(jax.random.uniform(jax.random.PRNGKey(0), (128, n),
                                               minval=1e-9, maxval=1.0)))
    return np.asarray(jax.lax.top_k(jnp.where(pair_ok[None, :], gum, -jnp.inf), 3)[1])


def test_closure_gates_equal_reference(oab_system):
    """One closure attempt's four gates ``[pairs, RANSAC, LM, total]``
    between the newest and the oldest live keyframe of the carried map, the
    reference's RANSAC draw passed to the port: ``n_pairs`` exact, the
    other three within 2 (``tests/test_torch_loop.py``'s bar)."""
    from orbslam2_with_quadrics_tpu.models import loop_closing as jlc
    from orbslam2_with_quadrics_tpu_torch.models import loop_closing as lc

    slam, _ = oab_system
    arrays = ms.map_state_to_numpy(slam.map)
    jm = jms.MapState(**{k: jnp.asarray(v) for k, v in arrays.items()})
    live = np.where(arrays["kf_valid"])[0]
    slot = int(live[np.argmax(arrays["kf_frame_id"][live])])
    cand = int(live[0])
    fcfg = slam.cfg.frontend
    dims = dict(n_levels=fcfg.n_levels, height=fcfg.height, width=fcfg.width)
    ref_g, _, _ = jlc._sim3_geometry(jm, None, np.int32(slot), np.int32(cand),
                                     jnp.asarray(fcfg.K.numpy()), **dims)
    got_g, _, _ = lc._sim3_geometry(slam.map, None, slot, cand, slam._K,
                                    sel=torch.as_tensor(reference_draw(jm, slot, cand)), **dims)
    ref_g, got_g = np.asarray(ref_g), got_g.numpy()
    assert got_g[0] == ref_g[0] > 0
    assert np.all(np.abs(got_g[1:] - ref_g[1:]) <= 2), (got_g, ref_g)
