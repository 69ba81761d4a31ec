"""The port's dual-quadric landmarks against the reference package, on the CPU.

Inputs come from numpy seeds and ``tests/test_quadrics.py``'s scene (an
ellipsoid seen by a ring of six cameras). The sign of the SVD's null vector
and the eigenvector signs of ``eigh`` are free, so quadrics are compared by
their dual matrix normalized to Q*[3,3] = -1 ("dual" below), relative to
its largest entry, and by their projected boxes. Tolerances:
- ``dual_matrix`` / ``from_dual_matrix``: dual within 1e-5;
- ``quadric_init`` on the ring: the same ``ok``, dual within 1e-4; two
  views are rejected by both;
- ``project_bbox`` / ``bbox_residual``: within 1e-3 px (+ 4e-6 relative for
  boxes that reach far outside the image), the same flags;
- ``_quadric_terms``: residuals within 1e-3 px, Jacobians within 1e-3 of
  their scale (against ``jax.jacfwd``), weights and cost within 1e-5
  relative;
- ``quadric_ba_solve`` on ``tests/test_quadrics.py``'s joint problem,
  carried across: poses within 1e-4, duals within 1e-3, cost within 1e-3
  relative to at least 1 (the first step takes the cost from 2043 to 0.22,
  and what is left is the fp32 rounding of the CG solve);
- ``QuadricManager`` on one map carried across: ``class_id``, ``kf_slots``,
  ``point_ids`` and ``initialized`` identical at every step; its joint BA
  from the reference's landmarks (8 LM steps of 40 CG steps over 1,024
  noisy point edges, not converged): keyframe poses within 1e-3, points
  within 1e-2, duals within 1e-3; an initialized landmark whose live views fall
  below the init gate stays initialized in both (a fault of both, kept);
- the port alone: joint BA with no bbox edge left returns the map (the
  reference crashes there); joint BA rejects a step that leaves a box with
  no ellipse (the reference accepts it and loses the landmark); pool
  compaction remaps the landmarks;
- whole ``System``: the port twin of ``tests/test_system_extended.py``'s
  quadric run (its IoU bar) and the reference ``System`` on the same frames
  and detections: the same landmarks, initialized ones and ``kf_slots``,
  boxes re-projected from both packages' landmarks at IoU >= 0.9 to each
  other; a short RGB-D run with detections, pipelined and synchronous.
"""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from test_quadrics import K as K_RING, make_quadric, ring_of_cameras  # noqa: E402

from orbslam2_with_quadrics_tpu.models import frontend as jfe  # noqa: E402
from orbslam2_with_quadrics_tpu.models import map_state as jms  # noqa: E402
from orbslam2_with_quadrics_tpu.models import quadric_mapping as jqm  # noqa: E402
from orbslam2_with_quadrics_tpu.models import system as jsys  # noqa: E402
from orbslam2_with_quadrics_tpu.ops import ba as jba  # noqa: E402
from orbslam2_with_quadrics_tpu.ops import camera as jcam  # noqa: E402
from orbslam2_with_quadrics_tpu.ops import lie as jlie  # noqa: E402
from orbslam2_with_quadrics_tpu.ops import orb as jorb  # noqa: E402
from orbslam2_with_quadrics_tpu.ops import quadrics as jq  # noqa: E402
from orbslam2_with_quadrics_tpu.utils import synthetic as jsyn  # noqa: E402
from orbslam2_with_quadrics_tpu_torch.models import frontend as fe  # noqa: E402
from orbslam2_with_quadrics_tpu_torch.models import map_state as ms  # noqa: E402
from orbslam2_with_quadrics_tpu_torch.models import quadric_mapping as qm  # noqa: E402
from orbslam2_with_quadrics_tpu_torch.models import system as sysm  # noqa: E402
from orbslam2_with_quadrics_tpu_torch.ops import ba, lie, orb, quadrics  # noqa: E402
from orbslam2_with_quadrics_tpu_torch.utils import metrics, synthetic  # noqa: E402


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
    return a.detach().cpu().numpy() if torch.is_tensor(a) else np.asarray(a)


def dual(pose, scale, pkg=quadrics):
    """Dual matrix normalized to Q*[3,3] = -1 (sign and basis free)."""
    Q = N(pkg.dual_matrix(pkg.Quadric(pose, scale)))
    return Q / -Q[..., 3:4, 3:4]


def assert_duals_close(a, b, rtol):
    np.testing.assert_allclose(a, b, rtol=0, atol=rtol * np.abs(b).max())


def iou(p, b):
    ix = max(0.0, min(p[2], b[2]) - max(p[0], b[0]))
    iy = max(0.0, min(p[3], b[3]) - max(p[1], b[1]))
    inter = ix * iy
    union = (p[2] - p[0]) * (p[3] - p[1]) + (b[2] - b[0]) * (b[3] - b[1]) - inter
    return inter / max(union, 1e-9)


def random_quadrics(seed, n=16, depth=6.0):
    rng = np.random.RandomState(seed)
    pose = jlie.se3_make(jlie.so3_exp_quat(jnp.asarray(rng.randn(n, 3) * 0.8, jnp.float32)),
                         jnp.asarray(rng.randn(n, 3) * 2.0 + [0, 0, depth], jnp.float32))
    scale = jnp.asarray(rng.uniform(0.1, 1.5, (n, 3)), jnp.float32)
    return pose, scale


# ---------------------------------------------------------------------------
# geometry
# ---------------------------------------------------------------------------

def test_dual_matrix_roundtrip():
    pose, scale = random_quadrics(0)
    Qj = np.asarray(jnp.stack([jq.dual_matrix(jq.Quadric(p, s)) for p, s in zip(pose, scale)]))
    Qt = quadrics.dual_matrix(quadrics.Quadric(T(pose), T(scale)))
    for k in range(len(Qj)):
        assert_duals_close(N(Qt[k]) / -N(Qt[k])[3, 3], Qj[k] / -Qj[k][3, 3], 1e-5)
    back = quadrics.from_dual_matrix(Qt)
    for k in range(len(Qj)):
        jb = jq.from_dual_matrix(jnp.asarray(Qj[k]))
        assert_duals_close(dual(back.pose[k], back.scale[k]), dual(jb.pose, jb.scale, jq), 1e-5)
        np.testing.assert_allclose(np.sort(N(back.scale[k])), np.sort(np.asarray(scale[k])),
                                   rtol=1e-4)
    # a non-finite matrix gives a NaN quadric, not an exception
    bad = quadrics.from_dual_matrix(torch.full((4, 4), float("nan")))
    assert torch.isnan(bad.scale).all()


def ring_boxes():
    q = make_quadric()
    Ts = ring_of_cameras(6)
    return q, Ts, jnp.stack([jq.project_bbox(q, Ts[i], K_RING)[0] for i in range(6)])


def test_quadric_init_matches_reference():
    _, Ts, boxes = ring_boxes()
    est, ok = jq.quadric_init(Ts, K_RING, boxes, jnp.ones((6,), bool))
    got, ok_t = quadrics.quadric_init(T(Ts), T(K_RING), T(boxes), torch.ones(6, dtype=torch.bool))
    assert bool(ok) and bool(ok_t)
    assert_duals_close(dual(got.pose, got.scale), dual(est.pose, est.scale, jq), 1e-4)


def test_quadric_init_rejects_two_views():
    _, Ts, boxes = ring_boxes()
    valid = np.zeros(6, bool)
    valid[:2] = True
    _, ok = jq.quadric_init(Ts, K_RING, boxes, jnp.asarray(valid))
    _, ok_t = quadrics.quadric_init(T(Ts), T(K_RING), T(boxes), torch.as_tensor(valid))
    assert not bool(ok) and not bool(ok_t)


def test_project_bbox_and_residual_match_reference():
    # centres about the camera plane: some ellipsoids cross it (no ellipse)
    pose, scale = random_quadrics(1, n=24, depth=0.0)
    rng = np.random.RandomState(2)
    Tc = jlie.se3_exp(jnp.asarray(rng.randn(24, 6) * [0.3, 0.3, 0.3, 0.2, 0.2, 0.2],
                                  jnp.float32))
    meas = jnp.asarray(rng.uniform(0, 640, (24, 4)), jnp.float32)
    box_t, ok_t = quadrics.project_bbox(quadrics.Quadric(T(pose), T(scale)), T(Tc), T(K_RING))
    e_t, eok_t = quadrics.bbox_residual(quadrics.Quadric(T(pose), T(scale)), T(Tc), T(K_RING),
                                        T(meas))
    oks = []
    for k in range(24):
        q = jq.Quadric(pose[k], scale[k])
        box, ok = jq.project_bbox(q, Tc[k], K_RING)
        e, eok = jq.bbox_residual(q, Tc[k], K_RING, meas[k])
        assert bool(ok) == bool(ok_t[k]) == bool(eok) == bool(eok_t[k])
        oks.append(bool(ok))
        if bool(ok):
            np.testing.assert_allclose(N(box_t[k]), np.asarray(box), rtol=4e-6, atol=1e-3)
        np.testing.assert_allclose(N(e_t[k]), np.asarray(e), atol=1e-3 + 4e-6 * np.abs(box).max())
    assert 4 <= sum(oks) <= 20  # both branches are exercised


def joint_problem():
    """``tests/test_quadrics.py::test_joint_quadric_ba_improves_both``'s problem."""
    q_true = make_quadric()
    Ts = ring_of_cameras(6)
    n_pts = 64
    pts = jax.random.uniform(jax.random.PRNGKey(0), (n_pts, 3),
                             minval=jnp.asarray([-2.0, -1.5, 4.0]),
                             maxval=jnp.asarray([2.0, 1.5, 9.0]))
    cam_idx = jnp.repeat(jnp.arange(6, dtype=jnp.int32), n_pts)
    pnt_idx = jnp.tile(jnp.arange(n_pts, dtype=jnp.int32), 6)
    uv, _ = jcam.project(K_RING, jlie.se3_apply(Ts[cam_idx], pts[pnt_idx]))
    uvr = jnp.concatenate([uv, jnp.zeros((len(cam_idx), 1))], axis=-1)
    bboxes = jnp.stack([jq.project_bbox(q_true, Ts[i], K_RING)[0] for i in range(6)])
    base = jba.BAProblem(
        poses=Ts, points=pts + 0.02 * jax.random.normal(jax.random.PRNGKey(1), pts.shape),
        K=K_RING, bf=jnp.asarray(0.0), cam_idx=cam_idx, pnt_idx=pnt_idx, uvr=uvr,
        is_stereo=jnp.zeros((len(cam_idx),)), inv_sigma2=jnp.ones((len(cam_idx),)),
        valid=jnp.ones((len(cam_idx),)),
        fixed_cam=jnp.zeros((6,)).at[0].set(1.0).at[1].set(1.0), fixed_pnt=jnp.zeros((n_pts,)))
    q0 = jq.retract(q_true, jnp.asarray([0.05, -0.03, 0.02, 0.1, -0.05, 0.1, 0.1, -0.1, 0.05]))
    return jq.QuadricBAProblem(
        base=base, quad_pose=q0.pose[None], quad_scale=q0.scale[None],
        qe_cam=jnp.arange(6, dtype=jnp.int32), qe_quad=jnp.zeros((6,), jnp.int32),
        qe_bbox=bboxes, qe_valid=jnp.ones((6,)), qe_w=jnp.full((6,), 1e-2))


def test_quadric_terms_match_jacfwd():
    jprob = joint_problem()
    prob = quadrics.quadric_ba_problem_from_numpy(jprob)
    ref = jax.jit(jq._quadric_terms)(jprob, K_RING)
    got = quadrics._quadric_terms(prob, T(K_RING))
    e, Jc, Jq, w, cost = (np.asarray(r) for r in ref)
    np.testing.assert_allclose(N(got[0]), e, atol=1e-3)
    for g, r in ((got[1], Jc), (got[2], Jq)):
        assert g.dtype == torch.float32
        np.testing.assert_allclose(N(g), r, atol=1e-3 * np.abs(r).max())
    assert np.abs(Jc[:2]).max() == 0 and np.abs(Jc[2:]).max() > 0  # fixed cameras
    np.testing.assert_allclose(N(got[3]), w, rtol=1e-5)
    np.testing.assert_allclose(float(got[4]), float(cost), rtol=1e-5)


@pytest.mark.parametrize("n_iters", [3, 10])
def test_quadric_ba_solve_matches_reference(n_iters):
    jprob = joint_problem()
    out, cost = jq.quadric_ba_solve(jprob, K_RING, n_iters=n_iters, cg_iters=30)
    got, cost_t = quadrics.quadric_ba_solve(quadrics.quadric_ba_problem_from_numpy(jprob),
                                            T(K_RING), n_iters=n_iters, cg_iters=30)
    np.testing.assert_allclose(N(got.base.poses), np.asarray(out.base.poses), atol=1e-4)
    np.testing.assert_allclose(N(got.base.points), np.asarray(out.base.points), atol=1e-3)
    assert_duals_close(dual(got.quad_pose[0], got.quad_scale[0]),
                       dual(out.quad_pose[0], out.quad_scale[0], jq), 1e-3)
    assert abs(float(cost_t) - float(cost)) <= 1e-3 * max(float(cost), 1.0)


def flat_landmark_problem():
    """A mono map's first landmark at 640x480 (fx 520): four keyframes with
    a small baseline, the SVD init's flat ellipsoid (its axis along the view
    is poorly observed), made thinner, and 200 points seen by every camera
    with 2 px noise (numpy seed 1); keyframe 0 fixed."""
    Kc = jnp.asarray([520.0, 520.0, 320.0, 240.0])
    Ts = jnp.asarray([
        [0.99989772, -0.01282029, -0.00053737, 0.00632733, -0.03920710, 0.03016699, 0.03034135],
        [0.99977088, -0.01884730, 0.00038336, 0.01014536, -0.06558085, 0.04512546, 0.04732966],
        [0.99964190, -0.02278370, 0.00003999, 0.01403507, -0.08920105, 0.05562427, 0.06299128],
        [0.99953806, -0.02459902, -0.00030902, 0.01784595, -0.11284494, 0.05957688, 0.07745153]])
    boxes = jnp.asarray([[333.39459, 142.68445, 465.37378, 247.93808],
                         [317.70993, 161.40536, 446.50192, 264.15155],
                         [302.60239, 174.24733, 428.64603, 274.89328],
                         [288.04099, 180.43013, 411.73428, 279.29510]])
    pose = jnp.asarray([0.15387669, 0.71997398, -0.07815965, 0.67219830,
                        0.15688284, -0.11903990, 0.74573660])
    rng = np.random.RandomState(1)
    n_pts, M = 200, 4
    pts = np.c_[rng.uniform(-0.6, 0.6, n_pts), rng.uniform(-0.45, 0.45, n_pts),
                rng.uniform(0.8, 1.5, n_pts)].astype(np.float32)
    cam_idx = jnp.repeat(jnp.arange(M, dtype=jnp.int32), n_pts)
    pnt_idx = jnp.tile(jnp.arange(n_pts, dtype=jnp.int32), M)
    uv, _ = jcam.project(Kc, jlie.se3_apply(Ts[cam_idx], jnp.asarray(pts)[pnt_idx]))
    uv = uv + 2.0 * jnp.asarray(rng.randn(*uv.shape).astype(np.float32))
    base = jba.BAProblem(
        poses=Ts, points=jnp.asarray(pts + 0.01 * rng.randn(n_pts, 3).astype(np.float32)),
        K=Kc, bf=jnp.asarray(0.0), cam_idx=cam_idx, pnt_idx=pnt_idx,
        uvr=jnp.concatenate([uv, jnp.zeros((len(cam_idx), 1))], axis=-1),
        is_stereo=jnp.zeros((len(cam_idx),)), inv_sigma2=jnp.ones((len(cam_idx),)),
        valid=jnp.ones((len(cam_idx),)), fixed_cam=jnp.zeros((M,)).at[0].set(1.0),
        fixed_pnt=jnp.zeros((n_pts,)))
    return Kc, jq.QuadricBAProblem(
        base=base, quad_pose=pose[None], quad_scale=jnp.asarray([[0.005, 0.07729647, 0.10004532]]),
        qe_cam=jnp.arange(M, dtype=jnp.int32), qe_quad=jnp.zeros((M,), jnp.int32),
        qe_bbox=boxes, qe_valid=jnp.ones((M,)), qe_w=jnp.full((M,), 1e-2))


def test_quadric_ba_keeps_every_ellipse():
    """The port alone: an LM step that leaves a bbox edge with no ellipse is
    rejected. The reference accepts it (the edge's residual drops to 0) and
    ends with a landmark that projects into none of its keyframes."""
    Kc, jprob = flat_landmark_problem()
    M = jprob.qe_cam.shape[0]
    out, _ = jq.quadric_ba_solve(jprob, Kc, n_iters=8)
    assert not any(bool(jq.project_bbox(jq.Quadric(out.quad_pose[0], out.quad_scale[0]),
                                        out.base.poses[i], Kc)[1]) for i in range(M))
    prob = quadrics.quadric_ba_problem_from_numpy(jprob)
    c0, proj0 = quadrics._quadric_cost(prob, T(Kc), quadrics.residuals.CHI2_STEREO)
    assert bool(proj0.all())
    got, cost = quadrics.quadric_ba_solve(prob, T(Kc), n_iters=8)
    _, ok = quadrics.project_bbox(
        quadrics.Quadric(got.quad_pose[0].expand(M, 7), got.quad_scale[0].expand(M, 3)),
        got.base.poses, T(Kc))
    assert bool(ok.all())
    assert float(cost) < 0.5 * float(c0)  # the points and cameras still converge
    boxes, _ = quadrics.project_bbox(
        quadrics.Quadric(got.quad_pose[0].expand(M, 7), got.quad_scale[0].expand(M, 3)),
        got.base.poses, T(Kc))
    assert min(iou(b, m) for b, m in zip(N(boxes), np.asarray(jprob.qe_bbox))) > 0.9


# ---------------------------------------------------------------------------
# the landmark manager on one map, carried across
# ---------------------------------------------------------------------------

def landmark_map():
    """A reference ``MapState`` of the ring's six keyframes (8 slots, 128
    keypoints each): 40 points inside the ellipsoid and 80 on a wall behind
    it, observed where they project into the 640x480 image; and per
    keyframe the ellipsoid's box (class 1), a wall box (class 2, keyframes 0
    and 1 only) and a box too narrow to use."""
    q = make_quadric()
    Ts = np.asarray(ring_of_cameras(6))
    rng = np.random.RandomState(0)
    u = rng.randn(40, 3)
    u = u / np.linalg.norm(u, axis=1, keepdims=True) * rng.rand(40, 1) ** (1 / 3) * 0.9
    R = np.asarray(jlie.quat_to_matrix(q.pose[:4]))
    inside = np.asarray(q.pose[4:]) + (u * np.asarray(q.scale)) @ R.T
    wall = np.stack([rng.uniform(-4, 4, 80), rng.uniform(-3, 3, 80), rng.uniform(9, 12, 80)], 1)
    pts = np.concatenate([inside, wall]).astype(np.float32)
    Kn, Nn, P = 8, 128, 512
    m = jms.empty_map(jms.MapConfig(max_keyframes=Kn, max_points=P, n_features=Nn, n_levels=4))
    kf_pose = np.array(m.kf_pose)
    kf_uv = np.zeros((Kn, Nn, 2), np.float32)
    kf_obs = np.full((Kn, Nn), -1, np.int32)
    kf_kp = np.zeros((Kn, Nn), bool)
    dets = []
    for i in range(6):
        uv, z = jcam.project(K_RING, jlie.se3_apply(jnp.asarray(Ts[i]), jnp.asarray(pts)))
        uv, z = np.asarray(uv), np.asarray(z)
        ids = np.where((z > 0) & (uv[:, 0] >= 0) & (uv[:, 0] < 640) & (uv[:, 1] >= 0)
                       & (uv[:, 1] < 480))[0][:Nn]
        kf_obs[i, :len(ids)] = ids
        kf_uv[i, :len(ids)] = uv[ids] + rng.randn(len(ids), 2) * 0.3
        kf_kp[i, :len(ids)] = True
        kf_pose[i] = Ts[i]
        b = np.asarray(jq.project_bbox(q, jnp.asarray(Ts[i]), K_RING)[0])
        rows = [[b[0], b[1], b[2] - b[0], b[3] - b[1], 0.9, 1.0], [5, 5, 2, 40, 0.5, 1.0]]
        if i < 2:
            rows.append([20.0, 20.0, 200.0, 150.0, 0.8, 2.0])
        dets.append(np.asarray(rows, np.float32))
    pt_pos = np.array(m.pt_pos)
    pt_pos[:120] = pts + rng.randn(120, 3).astype(np.float32) * 0.01
    pt_valid = np.zeros(P, bool)
    pt_valid[:120] = True
    kf_valid = np.zeros(Kn, bool)
    kf_valid[:6] = True
    m = m._replace(kf_pose=jnp.asarray(kf_pose), kf_valid=jnp.asarray(kf_valid),
                   kf_uv=jnp.asarray(kf_uv), kf_obs_point=jnp.asarray(kf_obs),
                   kf_kp_valid=jnp.asarray(kf_kp), pt_pos=jnp.asarray(pt_pos),
                   pt_valid=jnp.asarray(pt_valid), n_kf=jnp.asarray(6, jnp.int32),
                   n_pt=jnp.asarray(120, jnp.int32))
    return m, dets


def landmark_rows(landmarks):
    return [(lmk.class_id, list(lmk.kf_slots), sorted(lmk.point_ids), lmk.initialized)
            for lmk in landmarks]


def test_quadric_manager_matches_reference():
    jm, dets = landmark_map()
    m = ms.map_state_from_numpy(jm)
    jmgr = jqm.QuadricManager(K_RING)
    mgr = qm.QuadricManager(T(K_RING))
    for slot in range(6):
        jmgr.add_keyframe_detections(jm, slot, dets[slot])
        mgr.add_keyframe_detections(m, slot, dets[slot])
        if slot in (1, 2, 5):
            assert mgr.try_initialize(m) == jmgr.try_initialize(jm)
        assert landmark_rows(mgr.landmarks) == landmark_rows(jmgr.landmarks)
    assert [lmk.class_id for lmk in mgr.landmarks] == [1, 2]
    obj = mgr.landmarks[0]
    assert obj.initialized and obj.kf_slots == list(range(6))
    for a, b in zip(obj.bboxes, jmgr.landmarks[0].bboxes):
        np.testing.assert_array_equal(a, b)
    assert_duals_close(dual(T(obj.pose), T(obj.scale)),
                       dual(jmgr.landmarks[0].pose, jmgr.landmarks[0].scale, jq), 1e-4)

    # joint BA from the reference's landmarks (the same parameterization)
    mgr.landmarks = qm.landmarks_from_numpy(jmgr.landmarks)
    assert landmark_rows(mgr.landmarks) == landmark_rows(jmgr.landmarks)
    inv_s2 = jorb.scale_factors(4, 1.2)[2]
    jm2 = jmgr.joint_ba(jm, jnp.asarray(inv_s2))
    m2 = mgr.joint_ba(m, orb.scale_factors(4, 1.2)[2])
    np.testing.assert_allclose(N(m2.kf_pose), np.asarray(jm2.kf_pose), atol=1e-3)
    np.testing.assert_allclose(N(m2.pt_pos), np.asarray(jm2.pt_pos), atol=1e-2)
    assert torch.equal(m.kf_pose, ms.map_state_from_numpy(jm).kf_pose)  # input untouched
    a, b = mgr.landmarks[0], jmgr.landmarks[0]
    assert_duals_close(dual(T(a.pose), T(a.scale)), dual(b.pose, b.scale, jq), 1e-3)

    # culled views leave the landmark initialized below the init gate, in
    # both packages (kept for parity)
    kf_valid = np.zeros(8, bool)
    kf_valid[:2] = True
    jm3 = jm2._replace(kf_valid=jnp.asarray(kf_valid))
    m3 = m2._replace(kf_valid=torch.as_tensor(kf_valid))
    assert mgr.try_initialize(m3) == jmgr.try_initialize(jm3) == 0
    assert landmark_rows(mgr.landmarks) == landmark_rows(jmgr.landmarks)
    assert mgr.landmarks[0].initialized and mgr.landmarks[0].kf_slots == [0, 1]


def test_joint_ba_without_bbox_edges_returns_the_map():
    """Every initialized landmark lost all its views: the reference's
    ``np.stack`` of an empty list raises; the port returns the map."""
    jm, _ = landmark_map()
    m = ms.map_state_from_numpy(jm)
    mgr = qm.QuadricManager(T(K_RING))
    q = make_quadric()
    mgr.landmarks = [qm.QuadricLandmark(class_id=1, kf_slots=[], bboxes=[], point_ids={1, 2, 3},
                                        initialized=True, pose=np.asarray(q.pose),
                                        scale=np.asarray(q.scale)),
                     qm.QuadricLandmark(class_id=2, kf_slots=[3], bboxes=[np.ones(4, np.float32)],
                                        point_ids={4})]
    assert mgr.joint_ba(m, orb.scale_factors(4, 1.2)[2]) is m
    jmgr = jqm.QuadricManager(K_RING)
    jmgr.landmarks = mgr.landmarks
    with pytest.raises(ValueError):
        jmgr.joint_ba(jm, jnp.asarray(jorb.scale_factors(4, 1.2)[2]))


def small_cfg(sensor="mono", max_keyframes=48, max_points=8192, **kw):
    bf = 0.0 if sensor == "mono" else 0.1 * 260.0
    return sysm.SystemConfig(
        frontend=fe.FrontendConfig(height=240, width=320, n_features=512, n_levels=4, fx=260.0,
                                   fy=260.0, cx=160.0, cy=120.0, bf=bf),
        map=ms.MapConfig(max_keyframes=max_keyframes, max_points=max_points, n_features=512,
                         n_levels=4, device="cpu"),
        sensor=sensor, enable_quadrics=True, vocab_path=None, **kw)


def test_compaction_remaps_landmarks():
    jm, _ = landmark_map()
    slam = sysm.System(small_cfg())
    assert slam.quadrics is not None and slam.quadrics.min_points == 15
    m = ms.map_state_from_numpy(jm)
    kf_valid = m.kf_valid.clone()
    kf_valid[3] = False
    slam.map = m._replace(kf_valid=kf_valid)
    b = [np.full(4, float(i), np.float32) for i in range(3)]
    lmk = qm.QuadricLandmark(class_id=1, kf_slots=[0, 3, 5], bboxes=list(b),
                             point_ids={1, 7, 50, 119})
    slam.quadrics.landmarks = [lmk]
    slam._compact_keyframes()
    assert lmk.kf_slots == [0, 4]
    np.testing.assert_array_equal(np.stack(lmk.bboxes), np.stack([b[0], b[2]]))
    # points: drop 7 and 50, compact, remap the members
    old_valid = slam.map.pt_valid.clone()
    old_valid[[7, 50]] = False
    m = slam.map._replace(pt_valid=old_valid)
    slam.map, new_idx = ms.compact_points(m)
    slam._remap_point_ids(new_idx, old_valid)
    assert lmk.point_ids == {1, 117}
    slam.reset()
    assert slam.quadrics.landmarks == []


# ---------------------------------------------------------------------------
# whole System
# ---------------------------------------------------------------------------

H, W, FX = 240, 320, 260.0
Q_TRUE = dict(pose=[1.0, 0.0, 0.0, 0.0, 0.4, 0.3, 0.6], scale=[0.25, 0.2, 0.15])


def gt_detections(poses):
    """``tests/test_system_extended.py::test_quadric_end_to_end``'s boxes of
    the virtual ellipsoid under the true poses (None where it does not
    project to an ellipse)."""
    q = quadrics.Quadric(torch.tensor(Q_TRUE["pose"]), torch.tensor(Q_TRUE["scale"]))
    Kc = torch.tensor([FX, FX, W / 2, H / 2])
    out = []
    for P in poses:
        b, ok = quadrics.project_bbox(q, torch.as_tensor(metrics.mat_to_se3_vec(P),
                                                         dtype=torch.float32), Kc)
        b = N(b)
        out.append(np.asarray([[b[0], b[1], b[2] - b[0], b[3] - b[1], 0.9, 1.0]], np.float32)
                   if bool(ok) else None)
    return out


def mono_cfg(pkg_fe, pkg_ms, pkg_sys, **map_kw):
    """``tests/test_system_extended.py::make_cfg(enable_quadrics=True,
    quadric_min_points=3)`` from either package."""
    return pkg_sys.SystemConfig(
        frontend=pkg_fe.FrontendConfig(height=H, width=W, n_features=512, n_levels=4, fx=FX,
                                       fy=FX, cx=W / 2, cy=H / 2, bf=0.0),
        map=pkg_ms.MapConfig(max_keyframes=48, max_points=8192, n_features=512, n_levels=4,
                             **map_kw),
        sensor="mono", max_frames_between_kf=6, kf_close_tracked_th=250,
        kf_close_untracked_th=40, enable_quadrics=True, quadric_min_points=3)


@pytest.fixture(scope="module")
def quadric_runs():
    """Both packages' System over the 22-frame sequence with the same
    detections; the reference waits for each mapping pass (its poll's
    answer depends on the machine's load; the port's CPU run always finds
    mapping done)."""
    imgs, poses, _ = synthetic.planar_sequence(n_frames=22, h=H, w=W, fx=FX, fy=FX, seed=3)
    dets = gt_detections(poses)
    jslam = jsys.System(mono_cfg(jfe, jms, jsys))
    consume = jslam._consume_map_aux
    jslam._consume_map_aux = lambda block, consume=consume: consume(True)
    slam = sysm.System(mono_cfg(fe, ms, sysm, device="cpu"))
    for i in range(len(imgs)):
        jslam.track_monocular(imgs[i], timestamp=i / 30.0, detections=dets[i])
        slam.track_monocular(imgs[i], timestamp=i / 30.0, detections=dets[i])
    return dict(jslam=jslam, slam=slam, dets=dets)


def reprojected(lmk, kf_pose, pkg, to_tensor):
    q = pkg.Quadric(to_tensor(lmk.pose), to_tensor(lmk.scale))
    Kc = to_tensor(np.asarray([FX, FX, W / 2, H / 2], np.float32))
    out = {}
    for slot in lmk.kf_slots:
        b, ok = pkg.project_bbox(q, to_tensor(np.asarray(kf_pose[slot])), Kc)
        if bool(ok):
            out[slot] = N(b)
    return out


def test_quadric_end_to_end(quadric_runs):
    """The port twin of ``tests/test_system_extended.py::test_quadric_end_to_end``."""
    slam = quadric_runs["slam"]
    assert slam.state == sysm.System.OK
    inits = [lmk for lmk in slam.quadrics.landmarks if lmk.initialized]
    assert len(inits) >= 1
    lmk = inits[0]
    boxes = reprojected(lmk, N(slam.map.kf_pose), quadrics, T)
    ious = [iou(boxes[s], b) for s, b in zip(lmk.kf_slots, lmk.bboxes) if s in boxes]
    assert len(ious) >= 3
    assert np.median(ious) > 0.5


def test_quadric_system_matches_reference(quadric_runs):
    slam, jslam = quadric_runs["slam"], quadric_runs["jslam"]
    lms, jlms = slam.quadrics.landmarks, jslam.quadrics.landmarks
    assert len(lms) == len(jlms) >= 1
    assert [lmk.initialized for lmk in lms] == [lmk.initialized for lmk in jlms]
    assert [lmk.kf_slots for lmk in lms] == [lmk.kf_slots for lmk in jlms]
    n_cmp = 0
    for a, b in zip(lms, jlms):
        if not a.initialized:
            continue
        pa = reprojected(a, N(slam.map.kf_pose), quadrics, T)
        pb = reprojected(b, np.asarray(jslam.map.kf_pose), jq, jnp.asarray)
        assert pa.keys() == pb.keys()
        for s in pa:
            assert iou(pa[s], pb[s]) >= 0.9, (s, pa[s], pb[s])
            n_cmp += 1
    assert n_cmp >= 3


@pytest.mark.parametrize("sync", [False, True])
def test_rgbd_detections_reach_the_landmarks(sync, monkeypatch):
    """``track_rgbd`` with detections, through the pipelined path and the
    synchronous one: the keyframes' boxes become landmark views."""
    monkeypatch.setenv("ORB_SYNC_TRACK", "1" if sync else "")
    imgs, poses, K = jsyn.planar_sequence(n_frames=9, h=H, w=W, fx=FX, fy=FX, seed=3)
    depth = [jsyn.planar_depth(P, K, H, W) for P in poses]
    dets = gt_detections(poses)
    slam = sysm.System(small_cfg("rgbd", max_keyframes=12, max_points=4096,
                                 quadric_min_points=3, max_frames_between_kf=2,
                                 kf_close_tracked_th=250, kf_close_untracked_th=40))
    inserted = []
    orig = slam._map_quadrics

    def record(slot, detections):
        inserted.append((slot, detections is not None))
        return orig(slot, detections)

    slam._map_quadrics = record
    for i in range(len(imgs)):
        slam.track_rgbd(imgs[i], depth[i], timestamp=i / 30.0, detections=dets[i])
    slam.shutdown()
    assert slam.state == sysm.System.OK and slam.n_kfs_created >= 2
    assert len(inserted) == slam.n_kfs_created and all(d for _, d in inserted)
    lms = slam.quadrics.landmarks
    assert lms and sum(len(lmk.kf_slots) for lmk in lms) >= 2
    assert {s for lmk in lms for s in lmk.kf_slots} <= {s for s, _ in inserted}
