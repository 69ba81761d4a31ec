"""The port's loop closing, relocalization and async global BA against the
reference package, on the CPU.

- the hand-built drifted loop of ``tests/test_loop_correction.py`` carried
  across with ``map_state_from_numpy``, its JAX-trained vocabulary with
  ``vocabulary_from_numpy`` and its JAX-built database with
  ``loop_closer_state_from_numpy``: the port's own database rows equal the
  carried ones (words exact, BoW 1e-6), both packages score the same
  candidates (1e-5, common words exact); ``gather_loop_points`` and
  ``project_loop_points`` exact; the Sim3 gates with the reference's RANSAC
  draw passed as ``sel``: ``n_pairs`` exact, the other three within 2; after
  ``attempt_close`` keyframe poses within 1e-3, merged-point count within
  2, ``loop_edges`` equal;
- ``_detect_host`` and ``detect_reloc_candidates``: the same lists on the
  same scores;
- the kidnap of ``tests/test_system_extended.py`` at 240x320 / 512 features
  in both packages: both LOST after the noise, both OK again within the
  return frames, camera centres within 2% of the span after the sim(3) that
  removes the monocular gauge (5% without it): the map before the kidnap,
  and the relocalized camera;
- async global BA: ``_launch_global_ba`` + ``_apply_gba_if_ready(wait=True)``
  equals the inline ``run_global_ba`` to 1e-5, also after a ``grow_map`` and
  a keyframe inserted in between (which keeps its pose relative to its
  parent).

The 500-frame orbit is a ``slow``-marked rehearsal of ``chip_smoke.py``'s
``loop`` path at a small size.
"""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from test_loop_correction import K as K_LOOP, build_drifted_loop  # noqa: E402

from orbslam2_with_quadrics_tpu.models import frontend as jfe  # noqa: E402
from orbslam2_with_quadrics_tpu.models import loop_closing as jlc  # noqa: E402
from orbslam2_with_quadrics_tpu.models import map_state as jms  # noqa: E402
from orbslam2_with_quadrics_tpu.models import system as jsys  # noqa: E402
from orbslam2_with_quadrics_tpu.ops import matching as jmatch  # noqa: E402
from orbslam2_with_quadrics_tpu.ops import vocab as jvocab  # noqa: E402
from orbslam2_with_quadrics_tpu.utils import metrics  # noqa: E402
from orbslam2_with_quadrics_tpu.utils import synthetic as jsyn  # noqa: E402
from orbslam2_with_quadrics_tpu_torch.models import frontend as fe  # noqa: E402
from orbslam2_with_quadrics_tpu_torch.models import local_mapping as lm  # noqa: E402
from orbslam2_with_quadrics_tpu_torch.models import loop_closing as lc  # noqa: E402
from orbslam2_with_quadrics_tpu_torch.models import map_state as ms  # noqa: E402
from orbslam2_with_quadrics_tpu_torch.models import system as sysm  # noqa: E402
from orbslam2_with_quadrics_tpu_torch.ops import lie, vocab  # noqa: E402
from orbslam2_with_quadrics_tpu_torch.utils import synthetic, tracing  # noqa: E402


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread while this file runs (restored afterwards): the
    suite runs several worker processes on a few cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def T(a):
    return torch.as_tensor(np.array(a))


def N(a):
    return np.asarray(a.detach().cpu().numpy() if torch.is_tensor(a) else a)


# ---------------------------------------------------------------------------
# the drifted loop, carried across
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def drifted():
    jm, poses_true, _, jcfg = build_drifted_loop()
    n_kf = int(jm.n_kf)
    jvoc = jvocab.train(jm.kf_desc.reshape(-1, 8)[:2048], k=8, levels=3)
    jcloser = jlc.LoopCloser(jvoc, jcfg)
    for s in range(n_kf):
        jcloser.add_keyframe(s, jm.kf_desc[s], jm.kf_kp_valid[s])
    cfg = ms.MapConfig(max_keyframes=16, max_points=2048, n_features=256, n_levels=4,
                       device="cpu")
    voc = vocab.vocabulary_from_numpy(jvoc)
    m = ms.map_state_from_numpy(jm)
    return dict(jm=jm, m=m, jvoc=jvoc, voc=voc, jcloser=jcloser, cfg=cfg, jcfg=jcfg,
                n_kf=n_kf, slot=n_kf - 1, cand=0, poses_true=poses_true)


def carried_closer(d):
    return lc.loop_closer_state_from_numpy(lc.LoopCloser(d["voc"], d["cfg"]), d["jcloser"])


def reference_draw(jm, slot, cand):
    """The [128, 3] minimal sets ``ransac_sim3`` draws inside the
    reference's ``_sim3_geometry`` (PRNGKey(0) over the valid pairs)."""
    n = jm.kf_obs_point.shape[1]
    mi, _ = jmatch.mutual_match(jm.kf_desc[slot], jm.kf_kp_valid[slot], jm.kf_desc[cand],
                                jm.kf_kp_valid[cand], th=jmatch.TH_LOW, ratio=0.75)
    pair_ok = ((mi >= 0) & (jm.kf_obs_point[slot] >= 0)
               & (jm.kf_obs_point[cand, jnp.clip(mi, 0, n - 1)] >= 0))
    gum = -jnp.log(-jnp.log(jax.random.uniform(jax.random.PRNGKey(0), (128, n),
                                               minval=1e-9, maxval=1.0)))
    return np.asarray(jax.lax.top_k(jnp.where(pair_ok[None, :], gum, -jnp.inf), 3)[1])


def test_database_carried_across_scores_like_the_reference(drifted):
    d = drifted
    jm, m, jcl = d["jm"], d["m"], d["jcloser"]
    carried = carried_closer(d)
    own = lc.LoopCloser(d["voc"], d["cfg"])
    assert not own.sparse and own.bow.shape == (16, 512)
    for s in range(d["n_kf"]):
        own.add_keyframe_from_map(m, s)
    np.testing.assert_array_equal(N(own.words), np.asarray(jcl.words))
    np.testing.assert_array_equal(N(carried.words), np.asarray(jcl.words))
    np.testing.assert_allclose(N(own.bow), np.asarray(jcl.bow), atol=1e-6)
    for closer in (own, carried):
        for q in (0, d["slot"], 4):
            gs, gc = closer.score_query(closer.words[q], m.kf_valid)
            rs, rc = jcl.score_query(jcl.words[q], jm.kf_valid)
            np.testing.assert_allclose(N(gs), np.asarray(rs), atol=1e-5)
            np.testing.assert_array_equal(N(gc), np.asarray(rc))
    # the revisited place retrieves its first visit
    gs, _ = own.score_query(own.words[d["slot"]], m.kf_valid)
    assert set(np.argsort(-N(gs))[:2].tolist()) == {d["slot"], d["cand"]}


def test_sparse_database_carried_across(drifted, monkeypatch):
    """The big-vocabulary path on the same data: per-keyframe sorted word
    lists instead of the dense matrix, same scores."""
    d = drifted
    jm, m = d["jm"], d["m"]
    monkeypatch.setattr(jlc, "SPARSE_WORDS_THRESHOLD", 1)
    monkeypatch.setattr(lc, "SPARSE_WORDS_THRESHOLD", 1)
    jcl = jlc.LoopCloser(d["jvoc"], d["jcfg"])
    own = lc.LoopCloser(d["voc"], d["cfg"])
    assert own.sparse and jcl.sparse and own.bow is None
    for s in range(d["n_kf"]):
        jcl.add_keyframe(s, jm.kf_desc[s], jm.kf_kp_valid[s])
        own.add_keyframe_from_map(m, s)
    carried = lc.loop_closer_state_from_numpy(lc.LoopCloser(d["voc"], d["cfg"]), jcl)
    np.testing.assert_array_equal(N(own.kf_wid), np.asarray(jcl.kf_wid))
    np.testing.assert_allclose(N(own.kf_wval), np.asarray(jcl.kf_wval), atol=1e-6)
    dense = d["jcloser"]
    for closer in (own, carried):
        gs, gc = closer.score_query(closer.words[d["slot"]], m.kf_valid)
        for ref in (jcl, dense):
            rs, rc = ref.score_query(ref.words[d["slot"]], jm.kf_valid)
            np.testing.assert_allclose(N(gs), np.asarray(rs), atol=1e-5)
            np.testing.assert_array_equal(N(gc), np.asarray(rc))
    # growth appends empty rows and keeps the old ones
    own.grow(32)
    assert own.words.shape == (32, 256) and own.kf_wid.shape == (32, 256)
    np.testing.assert_array_equal(N(own.kf_wid[:16]), np.asarray(jcl.kf_wid))
    assert int(own.words[16:].max()) == -1


def test_loop_points_gather_and_projection_exact(drifted):
    d = drifted
    jm, m, slot, cand = d["jm"], d["m"], d["slot"], d["cand"]
    ref_ids = jlc.gather_loop_points(jm, np.int32(cand))
    got_ids = lc.gather_loop_points(m, cand)
    assert got_ids.dtype == torch.int32
    np.testing.assert_array_equal(N(got_ids), np.asarray(ref_ids))
    assert 100 < (N(got_ids) < 2048).sum() < 2048
    _, S_corr, _ = jlc._sim3_geometry(jm, d["jcloser"].words, np.int32(slot), np.int32(cand),
                                      K_LOOP, n_levels=4)
    ref_kp = jlc.project_loop_points(jm, np.int32(slot), S_corr, ref_ids, K_LOOP, n_levels=4)
    got_kp = lc.project_loop_points(m, slot, T(S_corr), got_ids, T(K_LOOP), n_levels=4)
    np.testing.assert_array_equal(N(got_kp), np.asarray(ref_kp))
    assert (N(got_kp) >= 0).sum() >= 40


def test_sim3_gates_match_reference(drifted):
    d = drifted
    jm, m, slot, cand = d["jm"], d["m"], d["slot"], d["cand"]
    ref_g, ref_S, _ = jlc._sim3_geometry(jm, d["jcloser"].words, np.int32(slot),
                                         np.int32(cand), K_LOOP, n_levels=4)
    got_g, got_S, _ = lc._sim3_geometry(m, None, slot, cand, T(K_LOOP), n_levels=4,
                                        sel=T(reference_draw(jm, slot, cand)))
    ref_g, got_g = np.asarray(ref_g), N(got_g)
    assert got_g[0] == ref_g[0] >= 20
    assert np.all(np.abs(got_g[1:] - ref_g[1:]) <= 2), (got_g, ref_g)
    np.testing.assert_allclose(N(got_S), np.asarray(ref_S), atol=1e-3)


def test_attempt_close_matches_reference(drifted):
    d = drifted
    jm, m, slot, cand = d["jm"], d["m"], d["slot"], d["cand"]
    jcl = jlc.LoopCloser(d["jvoc"], d["jcfg"])
    jcl.words = d["jcloser"].words
    jm2, jok = jcl.attempt_close(jm, slot, cand, K_LOOP, n_levels=4)
    closer = carried_closer(d)
    with tracing.collect() as spans:
        m2, ok = closer.attempt_close(m, slot, cand, T(K_LOOP), n_levels=4,
                                      sel=T(reference_draw(jm, slot, cand)))
    assert ok and jok
    assert closer.loop_edges == jcl.loop_edges == [(slot, cand)]
    assert closer.last_loop_kf == jcl.last_loop_kf == slot
    live = np.asarray(jm2.kf_valid)
    np.testing.assert_allclose(N(m2.kf_pose)[live], np.asarray(jm2.kf_pose)[live], atol=1e-3)
    n_merged = int(m.pt_valid.sum()) - int(m2.pt_valid.sum())
    j_merged = int(jm.pt_valid.sum()) - int(jm2.pt_valid.sum())
    assert abs(n_merged - j_merged) <= 2 and n_merged >= 60
    both = N(m2.pt_valid) & np.asarray(jm2.pt_valid)
    np.testing.assert_allclose(N(m2.pt_pos)[both], np.asarray(jm2.pt_pos)[both], atol=2e-3)
    assert (N(m2.kf_obs_point) != np.asarray(jm2.kf_obs_point)).mean() < 0.005
    # the input map is untouched (the functions are pure)
    np.testing.assert_array_equal(N(m.kf_pose), np.asarray(jm.kf_pose))
    # the trace: one attempt with the four gates, the scale and every stage
    # under it (host times on the CPU)
    rec = [s for s in spans if s["name"] == "lc.attempt_close"]
    assert len(rec) == 1 and rec[0]["counts"]["closed"] and len(rec[0]["counts"]["gates"]) == 4
    assert rec[0]["counts"]["sim3_scale"] > 0
    stage_ms = {s["name"]: s["host_ms"] for s in spans if s["trace"] == rec[0]["trace"]}
    for key in ("lc.sim3_geometry", "lc.mutual_match", "lc.correct_graph",
                "lc.optimize_pose_graph", "lc.fuse_loop_points"):
        assert stage_ms[key] > 0
    # a pair that is no loop fails the gates and changes nothing
    m3, ok3 = closer.attempt_close(m, 4, 2, T(K_LOOP), n_levels=4)
    assert not ok3 and m3 is m and closer.loop_edges == [(slot, cand)]


def test_fuse_loop_points_matches_reference(drifted):
    """On the corrected map of the reference: the same merges and the same
    observation table."""
    d = drifted
    jm, slot, cand = d["jm"], d["slot"], d["cand"]
    _, S_corr, loop_ids = jlc._sim3_geometry(jm, d["jcloser"].words, np.int32(slot),
                                             np.int32(cand), K_LOOP, n_levels=4)
    jmc = d["jcloser"]._correct_graph(jm, slot, cand, S_corr)
    ref, ref_n = jlc.fuse_loop_points(jmc, jnp.asarray(slot, jnp.int32), loop_ids, K_LOOP,
                                      n_levels=4)
    got, got_n = lc.fuse_loop_points(ms.map_state_from_numpy(jmc), slot, T(loop_ids),
                                     T(K_LOOP), n_levels=4)
    assert int(got_n) == int(ref_n) >= 60
    np.testing.assert_array_equal(N(got.pt_valid), np.asarray(ref.pt_valid))
    np.testing.assert_array_equal(N(got.kf_obs_point), np.asarray(ref.kf_obs_point))
    assert got.kf_obs_point.dtype == torch.int32


# ---------------------------------------------------------------------------
# detection on the host
# ---------------------------------------------------------------------------

def detection_inputs(rng, K=24):
    """A chain of keyframes covisible with their neighbours, the newest
    (``slot``) revisiting the place of keyframes 2-4."""
    W = np.zeros((K, K), np.int32)
    for i in range(K):
        for j in range(K):
            if i != j and abs(i - j) <= 2:
                W[i, j] = 40 - 10 * abs(i - j)
    scores = (0.02 + 0.02 * rng.rand(K)).astype(np.float32)
    common = rng.randint(5, 15, K).astype(np.int32)
    return W, scores, common


def test_detect_host_matches_reference(drifted):
    d = drifted
    rng = np.random.RandomState(0)
    jcl = jlc.LoopCloser(d["jvoc"], d["jcfg"])
    closer = lc.LoopCloser(d["voc"], d["cfg"])
    outs = []
    for step, slot in enumerate(range(19, 24)):
        W, scores, common = detection_inputs(rng)
        W[slot + 1:, :] = 0
        W[:, slot + 1:] = 0
        scores[slot - 2:slot + 1] = [0.08, 0.1, 1.0]
        scores[2:5] = [0.2, 0.3, 0.25]
        common[2:5] = [40, 50, 45]
        if step == 3:
            scores[2:5] = 0.0      # a keyframe without candidates resets the count
        ref = jcl._detect_host(slot, W, scores, common)
        got = closer._detect_host(slot, W, scores, common)
        assert got == ref
        assert [(sorted(g), c) for g, c in closer.consistency] == \
            [(sorted(g), c) for g, c in jcl.consistency]
        outs.append(got)
    assert outs[0] == outs[1] == [] and outs[3] == []
    assert lc._accumulate_covis_groups(scores, np.array([2, 3, 4]), W) == \
        jlc._accumulate_covis_groups(scores, np.array([2, 3, 4]), W)
    # three consecutive consistent detections are needed before one is returned
    closer2, jcl2 = lc.LoopCloser(d["voc"], d["cfg"]), jlc.LoopCloser(d["jvoc"], d["jcfg"])
    last = None
    for slot in range(19, 24):
        W, scores, common = detection_inputs(rng)
        scores[slot - 2:slot + 1] = [0.08, 0.1, 1.0]
        scores[2:5] = [0.2, 0.3, 0.25]
        common[2:5] = [40, 50, 45]
        last = closer2._detect_host(slot, W, scores, common)
        assert last == jcl2._detect_host(slot, W, scores, common)
    assert last == [3]


def test_detect_and_reloc_candidates_match_reference(drifted):
    d = drifted
    jm, m, jcl = d["jm"], d["m"], d["jcloser"]
    closer = carried_closer(d)
    for q in (d["slot"], 0, 5):
        ref = jcl.detect_reloc_candidates(jm, jcl.words[q])
        got = closer.detect_reloc_candidates(m, closer.words[q])
        assert [int(g) for g in got] == [int(r) for r in ref] and q in got
    assert closer.detect_reloc_candidates(m, torch.full((256,), -1, dtype=torch.int32)) == []
    # synchronous DetectLoop on the same map and database: too few live
    # keyframes / inside the cooldown -> structurally skipped in both
    assert closer.detect(m, d["slot"]) == jcl.detect(jm, d["slot"])
    closer.last_loop_kf = jcl.last_loop_kf = d["slot"] - 3
    assert closer.prepare_detect(m, d["slot"], 10) is None
    assert jcl.prepare_detect(jm, d["slot"], 10) is None
    closer.last_loop_kf = jcl.last_loop_kf = -999
    prep = closer.prepare_detect(m, d["slot"], 10)
    jprep = jcl.prepare_detect(jm, d["slot"], 10)
    np.testing.assert_array_equal(prep[1].numpy(), np.asarray(jprep[1]))
    np.testing.assert_allclose(prep[2].numpy(), np.asarray(jprep[2]), atol=1e-5)
    np.testing.assert_array_equal(prep[3].numpy(), np.asarray(jprep[3]))
    assert closer.finish_detect(prep) == jcl.finish_detect(jprep)


# ---------------------------------------------------------------------------
# async global BA
# ---------------------------------------------------------------------------

def gba_system(m, **kw):
    cfg = sysm.SystemConfig(
        frontend=fe.FrontendConfig(height=240, width=320, n_features=256, n_levels=4,
                                   fx=300.0, fy=300.0, cx=160.0, cy=120.0),
        map=ms.MapConfig(max_keyframes=16, max_points=2048, n_features=256, n_levels=4,
                         device="cpu"),
        vocab_path=None, **kw)
    slam = sysm.System(cfg)
    slam.map = m
    slam.state = sysm.System.OK
    slam.ref_kf = 3
    slam.T_cw = m.kf_pose[3]
    return slam


@pytest.mark.parametrize("between", ["nothing", "grow_and_insert"])
def test_async_gba_equals_inline(drifted, between):
    m = drifted["m"]
    # noisy points, so that the BA has something to do
    g = torch.Generator().manual_seed(0)
    m = m._replace(pt_pos=m.pt_pos + 0.01 * torch.randn(m.pt_pos.shape, generator=g))
    slam = gba_system(m, async_gba=True)
    inline, _ = lm.run_global_ba(m, slam._K, 0.0, slam._inv_sigma2, n_iters=10)
    assert float((inline.kf_pose - m.kf_pose).abs().max()) > 1e-4
    slam.map_changed()
    slam._launch_global_ba(9)
    T_child_parent = None
    if between == "grow_and_insert":
        # the map grows and gains a keyframe (child of 9) and a point while
        # the thread runs; ids are preserved
        grown = ms.grow_map(slam.map, new_K=32, new_P=4096)
        kf9 = 9
        pose_new = lie.se3_compose(lie.se3_exp(torch.tensor([0.0, 0.01, 0.0, 0.05, 0.0, 0.0])),
                                   grown.kf_pose[kf9])
        n = 256
        grown, s_new = ms.insert_keyframe(
            grown, pose_new, 99, grown.kf_uv[kf9], grown.kf_ur[kf9], grown.kf_level[kf9],
            grown.kf_angle[kf9], grown.kf_desc[kf9], grown.kf_kp_valid[kf9],
            torch.full((n,), -1, dtype=torch.int32), kf9)
        p_new = torch.tensor([[0.3, 0.2, 5.0]])
        grown, pid = ms.insert_points(grown, p_new, grown.kf_desc[kf9][:1],
                                      torch.full((1,), int(s_new), dtype=torch.int32),
                                      torch.ones(1, dtype=torch.bool))
        slam.map = grown
        T_child_parent = lie.se3_compose(pose_new, lie.se3_inverse(m.kf_pose[kf9]))
        pc_before = lie.se3_apply(pose_new, p_new[0])
    slam._apply_gba_if_ready(wait=True)
    assert slam.n_gba_applied == 1 and slam.map_changed() and slam._gba_thread is None
    K0, P0 = m.kf_valid.shape[0], m.pt_valid.shape[0]
    live, pts = N(m.kf_valid), N(m.pt_valid)
    np.testing.assert_allclose(N(slam.map.kf_pose[:K0])[live], N(inline.kf_pose)[live],
                               atol=1e-5)
    np.testing.assert_allclose(N(slam.map.pt_pos[:P0])[pts], N(inline.pt_pos)[pts], atol=1e-5)
    # the live camera rides on its reference keyframe
    np.testing.assert_allclose(N(slam.T_cw), N(inline.kf_pose[3]), atol=1e-5)
    if between == "grow_and_insert":
        s_new, pid = int(s_new), int(pid[0])
        assert slam.map.kf_valid.shape[0] == 32 and slam.map.pt_valid.shape[0] == 4096
        rel = lie.se3_compose(slam.map.kf_pose[s_new], lie.se3_inverse(inline.kf_pose[9]))
        np.testing.assert_allclose(N(rel), N(T_child_parent), atol=1e-5)
        pc_after = lie.se3_apply(slam.map.kf_pose[s_new], slam.map.pt_pos[pid])
        np.testing.assert_allclose(N(pc_after), N(pc_before), atol=1e-4)
    # a second apply has nothing to do; a reset abandons a running BA
    slam._apply_gba_if_ready(wait=True)
    assert slam.n_gba_applied == 1
    slam._launch_global_ba(9)
    slam.reset()
    slam._apply_gba_if_ready(wait=True)
    assert slam.n_gba_applied == 1 and int(slam.map.n_kf) == 0


def test_gba_after_point_compaction_applies_poses_only(drifted):
    """A point-pool compaction while the BA runs remaps point ids: the
    snapshot's keyframe poses still apply, its point ids do not (every
    point takes its reference keyframe's correction)."""
    m = drifted["m"]
    g = torch.Generator().manual_seed(1)
    m = m._replace(pt_pos=m.pt_pos + 0.01 * torch.randn(m.pt_pos.shape, generator=g))
    slam = gba_system(m, async_gba=True)
    inline, _ = lm.run_global_ba(m, slam._K, 0.0, slam._inv_sigma2, n_iters=10)
    slam._launch_global_ba(9)
    slam._map_epoch += 1
    slam._apply_gba_if_ready(wait=True)
    live = N(m.kf_valid)
    np.testing.assert_allclose(N(slam.map.kf_pose)[live], N(inline.kf_pose)[live], atol=1e-5)
    # points moved rigidly with their first keyframe
    first = N(m.pt_first_kf)
    p = int(np.where(N(m.pt_valid) & (first == 5))[0][0])
    want = lie.se3_apply(lie.se3_inverse(inline.kf_pose[5]), lie.se3_apply(m.kf_pose[5],
                                                                           m.pt_pos[p]))
    np.testing.assert_allclose(N(slam.map.pt_pos[p]), N(want), atol=1e-5)


def test_system_constructs_with_the_shipped_vocabulary():
    """``enable_loop_closing`` and ``async_gba`` no longer raise, the shipped
    100k-word vocabulary loads from the port's own tree and takes the sparse
    path; ``enable_quadrics`` constructs too (nothing raises any more)."""
    base = dict(
        frontend=fe.FrontendConfig(height=120, width=160, n_features=128, n_levels=4,
                                   fx=130.0, fy=130.0, cx=80.0, cy=60.0),
        map=ms.MapConfig(max_keyframes=8, max_points=512, n_features=128, n_levels=4,
                         device="cpu"))
    slam = sysm.System(sysm.SystemConfig(enable_loop_closing=True, async_gba=True, **base))
    asset = sysm._default_vocab_asset()
    assert os.path.basename(asset) == "vocab_100k.npz"
    assert "orbslam2_with_quadrics_tpu_torch" in asset.split(os.sep)
    with open(asset, "rb") as f, open(jsys._default_vocab_asset(), "rb") as g:
        assert f.read() == g.read()
    lcs = slam.loop_closer
    assert lcs is not None and lcs.sparse and lcs.voc.n_words == 100000 and lcs.bow is None
    assert lcs.kf_wid.shape == (8, 128)
    assert slam.map_changed() and not slam.map_changed()
    for name in ("_relocalize", "_reloc_loop_correction", "_run_loop_closing", "map_changed"):
        assert callable(getattr(slam, name))
    slam.reset()
    assert slam.loop_closer is not lcs and slam.loop_closer.voc is lcs.voc
    quad = sysm.System(sysm.SystemConfig(enable_quadrics=True, **base))
    assert quad.quadrics is not None and quad.quadrics.landmarks == []
    assert not hasattr(sysm, "_NOT_PORTED")
    # the shipped vocabulary gives the reference's words
    rng = np.random.RandomState(0)
    desc = rng.randint(0, 2 ** 32, size=(128, 8), dtype=np.uint64).astype(np.uint32)
    jw, _ = jvocab.transform(jvocab.load(asset), jnp.asarray(desc), jnp.ones(128, bool))
    w, _ = vocab.transform(lcs.voc, torch.as_tensor(desc.view(np.int32)),
                           torch.ones(128, dtype=torch.bool))
    np.testing.assert_array_equal(N(w), np.asarray(jw))


def test_lazy_vocabulary_is_trained_from_the_first_keyframes(drifted):
    """Without a pretrained vocabulary the database appears after
    ``vocab_train_kfs`` keyframes and indexes every keyframe so far."""
    m = drifted["m"]
    slam = gba_system(m, vocab_train_kfs=2, vocab_k=4, vocab_levels=2)
    assert slam.loop_closer is None and not slam._relocalize(None)

    class Feats:
        pass

    for s in range(5):   # 120 + 4 x 40 descriptors: training needs >= 256
        assert slam.loop_closer is None
        Feats.desc, Feats.valid = m.kf_desc[s], m.kf_kp_valid[s]
        slam._index_keyframe(Feats, s)
    lcs = slam.loop_closer
    assert lcs is not None and not lcs.sparse and lcs.voc.n_words == 16
    assert bool((lcs.words[:10].max(dim=1).values >= 0).all())
    assert int(lcs.words[10:].max()) == -1


# ---------------------------------------------------------------------------
# synthetic motions
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("motion", ["orbit_big", "figure8"])
def test_synthetic_loop_motions_match_reference(motion):
    kw = dict(n_frames=40, h=60, w=80, fx=65.0, fy=65.0, seed=3, motion=motion,
              plane_half=6.0, relief=True, noise=3.0)
    ref = list(jsyn.planar_stream(**kw))
    got = list(synthetic.planar_stream(**kw))
    for (gi, gT), (ri, rT) in zip(got, ref):
        np.testing.assert_array_equal(gT, rT)
        np.testing.assert_allclose(gi, ri, atol=0.05)   # two warp implementations
    c = np.stack([-T_[:3, :3].T @ T_[:3, 3] for _, T_ in got])
    assert np.linalg.norm(c[-1] - c[0]) < 0.1 and np.ptp(c[:, 0]) > 3.0


# ---------------------------------------------------------------------------
# the slice as a whole: the kidnap
# ---------------------------------------------------------------------------

H, W, FX = 240, 320, 260.0


def kidnap_cfg(pkg_fe, pkg_ms, pkg_sys, **map_kw):
    """``tests/test_system_extended.py::test_relocalization_after_kidnap``'s
    configuration (the shipped vocabulary, a keyframe every 2 frames)."""
    return pkg_sys.SystemConfig(
        frontend=pkg_fe.FrontendConfig(height=H, width=W, n_features=512, n_levels=4,
                                       fx=FX, fy=FX, cx=W / 2, cy=H / 2, bf=0.0),
        map=pkg_ms.MapConfig(max_keyframes=48, max_points=8192, n_features=512, n_levels=4,
                             **map_kw),
        sensor="mono", max_frames_between_kf=2, kf_close_tracked_th=250,
        kf_close_untracked_th=40, enable_loop_closing=True, vocab_train_kfs=2)


def run_kidnap(slam, ok_state, lost_state, imgs):
    rng = np.random.RandomState(3)
    for i in range(30):
        slam.track_monocular(imgs[i], timestamp=i / 30.0)
    slam.shutdown()
    out = {"state_before": slam.state, "n_kf": int(slam.map.n_kf),
           "closer": slam.loop_closer is not None,
           "traj_before": slam.full_trajectory()}   # the map before the kidnap
    for k in range(3):
        slam.track_monocular(rng.rand(H, W).astype(np.float32) * 255.0, timestamp=1.0 + k)
    out["state_noise"] = slam.state
    out["recovered_at"] = None
    for i in range(16, 26):
        slam.track_monocular(imgs[i], timestamp=2.0 + i / 30.0)
        if slam.state == ok_state:
            out["recovered_at"] = i
            break
    slam.shutdown()
    out["T_cw"] = np.asarray(slam.T_cw)
    return out


def test_kidnap_relocalizes_like_the_reference():
    imgs, poses, _ = jsyn.planar_sequence(n_frames=30, h=H, w=W, fx=FX, fy=FX, seed=9,
                                          relief=True)
    jslam = jsys.System(kidnap_cfg(jfe, jms, jsys))
    # the reference waits for each mapping pass instead of polling it: the
    # poll's answer, and with it the keyframe schedule, follows the
    # machine's load; the port's CPU run always finds the pass finished
    consume = jslam._consume_map_aux
    jslam._consume_map_aux = lambda block: consume(True)
    slam = sysm.System(kidnap_cfg(fe, ms, sysm, device="cpu"))
    assert slam.loop_closer.sparse and jslam.loop_closer.sparse
    ref = run_kidnap(jslam, jsys.System.OK, jsys.System.LOST, imgs)
    got = run_kidnap(slam, sysm.System.OK, sysm.System.LOST, imgs)
    for run, pkg in ((ref, jsys), (got, sysm)):
        assert run["state_before"] == pkg.System.OK and run["n_kf"] > 5 and run["closer"]
        assert run["state_noise"] == pkg.System.LOST
        assert run["recovered_at"] is not None
    assert abs(got["recovered_at"] - ref["recovered_at"]) <= 1
    assert slam.state == sysm.System.OK
    assert any(m.get("reloc") for m in slam.metrics)
    # camera centres within 2% of the span: every frame of the map built
    # before the kidnap, and the relocalized camera. (The relocalization's
    # loop correction then takes the teleport for drift and bends the
    # keyframes after it, in both packages: those poses measure nothing.)
    def centre(T7):
        return metrics.camera_centers_from_Tcw([metrics.se3_vec_to_mat(np.asarray(T7))])[0]

    cg = {f: centre(T_) for f, _, T_ in got["traj_before"]}
    cr = {f: centre(T_) for f, _, T_ in ref["traj_before"]}
    frames = sorted(f for f in set(cg) & set(cr) if f >= 6)
    assert len(frames) >= 20
    pr, pg = np.stack([cr[f] for f in frames]), np.stack([cg[f] for f in frames])
    span = np.linalg.norm(pr.max(0) - pr.min(0))
    # a monocular map's scale is free and the two runs settle 1-2% apart
    # (read: 1.7%): the port's centres go through the sim(3) that best maps
    # them onto the reference's, then every frame is held to 2% of the span
    sc, R, t = metrics.umeyama_align(pg, pr)
    worst = np.linalg.norm((sc * (R @ pg.T)).T + t - pr, axis=1).max()
    reloc = np.linalg.norm(sc * R @ centre(got["T_cw"]) + t - centre(ref["T_cw"]))
    raw = np.linalg.norm(pg - pr, axis=1).max()
    print(f"kidnap: worst centre distance before it {worst / span:.4f} of the span "
          f"({raw / span:.4f} unaligned, scale {sc:.4f}), relocalized camera "
          f"{reloc / span:.4f}, recovered at {got['recovered_at']} / {ref['recovered_at']}")
    assert abs(sc - 1.0) < 0.05 and raw < 0.05 * span
    assert worst < 0.02 * span and reloc < 0.02 * span


@pytest.mark.slow
def test_organic_loop_closure_on_orbit_rehearsal():
    """The ``loop`` path of ``chip_smoke.py`` at a small size on the CPU."""
    jax_module = sys.modules["jax"]
    import chip_smoke  # poisons sys.modules["jax"]: the port must not need it
    sys.modules["jax"] = jax_module

    out = chip_smoke.run_main_path(
        "loop", device="cpu", h=H, w=W, n_features=512, n_levels=4, n_frames=500, fx=FX,
        map_kw=dict(max_keyframes=64, max_points=16384))
    assert out["n_loops_closed"] >= 1 and out["ate_frac"] < 0.06
