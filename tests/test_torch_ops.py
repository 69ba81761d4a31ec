"""The port's ops against the reference's on the same numpy inputs.

Tolerances (float32 on both sides, different op order):
- lie / camera: 1e-5 absolute on unit-scale quantities, 1e-3 px on pixels;
- residuals: 1e-3 px on residuals, 1e-3 relative on Jacobians and chi2
  (float32 projections of points 2-12 units away);
- pose optimization: same inlier mask, pose within 1e-4;
- matching: indices and distances bit-exact;
- ORB on the reference's own pyramid levels: keypoints (position, level,
  validity) identical, descriptors identical on >= 99% of valid keypoints
  (rounded BRIEF taps can flip when the two frameworks' atan2/sin/cos
  differ in the last bit);
- ORB from the raw image: pyramid within 2e-3 grey levels, >= 97% of the
  keypoints identical (bf16 FAST scores can flip near a rounding boundary);
- two-view init with the reference's hypothesis sets: same ok flag and
  good mask, R within 1e-4, t direction within 1e-4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orbslam2_with_quadrics_tpu.ops import camera as jcam
from orbslam2_with_quadrics_tpu.ops import init2view as jinit
from orbslam2_with_quadrics_tpu.ops import lie as jlie
from orbslam2_with_quadrics_tpu.ops import matching as jmatch
from orbslam2_with_quadrics_tpu.ops import orb as jorb
from orbslam2_with_quadrics_tpu.ops import pose_opt as jpose
from orbslam2_with_quadrics_tpu.ops import residuals as jres
from orbslam2_with_quadrics_tpu.utils import synthetic as jsyn
from orbslam2_with_quadrics_tpu_torch.ops import camera, init2view, lie, matching, orb
from orbslam2_with_quadrics_tpu_torch.ops import pose_opt, residuals
from orbslam2_with_quadrics_tpu_torch.utils import synthetic


def T(a):
    return torch.as_tensor(np.array(a))


def J(a):
    return jnp.asarray(np.asarray(a))


def N(a):
    return np.asarray(a.detach().cpu().numpy() if torch.is_tensor(a) else a)


def random_poses(rng, n):
    xi = (rng.randn(n, 6) * [0.5, 0.5, 0.5, 1.0, 1.0, 1.0]).astype(np.float32)
    return np.array(jlie.se3_exp(jnp.asarray(xi))), xi


# ---------------------------------------------------------------------------
# lie + camera
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("fn", ["compose", "inverse", "apply", "exp", "log",
                                "retract", "to_matrix", "from_matrix",
                                "matrix_to_quat"])
def test_lie_matches_reference(fn):
    rng = np.random.RandomState(0)
    A, xi = random_poses(rng, 64)
    B, _ = random_poses(rng, 64)
    p = rng.randn(64, 3).astype(np.float32)
    if fn == "compose":
        got, ref = lie.se3_compose(T(A), T(B)), jlie.se3_compose(J(A), J(B))
    elif fn == "inverse":
        got, ref = lie.se3_inverse(T(A)), jlie.se3_inverse(J(A))
    elif fn == "apply":
        got, ref = lie.se3_apply(T(A), T(p)), jlie.se3_apply(J(A), J(p))
    elif fn == "exp":
        got, ref = lie.se3_exp(T(xi)), jlie.se3_exp(J(xi))
    elif fn == "log":
        got, ref = lie.se3_log(T(A)), jlie.se3_log(J(A))
    elif fn == "retract":
        d = (0.1 * rng.randn(64, 6)).astype(np.float32)
        got, ref = lie.se3_retract(T(A), T(d)), jlie.se3_retract(J(A), J(d))
    elif fn == "to_matrix":
        got, ref = lie.se3_to_matrix(T(A)), jlie.se3_to_matrix(J(A))
    elif fn == "from_matrix":
        M = np.asarray(jlie.se3_to_matrix(J(A)))
        got, ref = lie.se3_from_matrix(T(M)), jlie.se3_from_matrix(J(M))
    else:
        R = np.asarray(jlie.quat_to_matrix(J(A[:, :4])))
        got, ref = lie.matrix_to_quat(T(R)), jlie.matrix_to_quat(J(R))
    np.testing.assert_allclose(N(got), np.asarray(ref), atol=1e-5)


def test_camera_matches_reference():
    rng = np.random.RandomState(1)
    K = np.array([500.0, 480.0, 320.0, 240.0], np.float32)
    dist = np.array([0.1, -0.05, 0.001, -0.002, 0.01], np.float32)
    pc = (rng.randn(200, 3) + [0, 0, 6]).astype(np.float32)
    uv, z = camera.project(T(K), T(pc))
    juv, jz = jcam.project(J(K), J(pc))
    np.testing.assert_allclose(N(uv), np.asarray(juv), atol=1e-3)
    np.testing.assert_allclose(N(z), np.asarray(jz), atol=1e-6)
    und = camera.undistort_points(T(K), T(dist), uv)
    jund = jcam.undistort_points(J(K), J(dist), juv)
    np.testing.assert_allclose(N(und), np.asarray(jund), atol=1e-3)
    P1 = camera.projection_matrix(lie.se3_identity(), T(K))
    A, _ = random_poses(rng, 1)
    A[0, 4:] *= 0.2
    P2 = camera.projection_matrix(T(A[0]), T(K))
    jP2 = jcam.projection_matrix(J(A[0]), J(K))
    np.testing.assert_allclose(N(P2), np.asarray(jP2), rtol=1e-5, atol=1e-3)
    uv2, _ = camera.project(T(K), lie.se3_apply(T(A[0]), T(pc)))
    X = camera.triangulate_dlt(P1, P2, uv, uv2)
    jX = jax.vmap(jcam.triangulate_dlt, in_axes=(None, None, 0, 0))(
        jcam.projection_matrix(jlie.se3_identity(), J(K)), jP2, J(N(uv)), J(N(uv2)))
    np.testing.assert_allclose(N(X), np.asarray(jX), atol=1e-3)
    np.testing.assert_allclose(N(X), pc, atol=2e-2)


def test_residuals_match_reference():
    rng = np.random.RandomState(6)
    K = np.array([500.0, 480.0, 320.0, 240.0], np.float32)
    A, _ = random_poses(rng, 100)
    A[:, 4:] *= 0.2
    pw = (rng.randn(100, 3) + [0, 0, 7]).astype(np.float32)
    obs = (rng.rand(100, 3) * [640, 480, 600]).astype(np.float32)
    is_st = (rng.rand(100) < 0.5).astype(np.float32)
    is2 = (1.0 / 1.44 ** rng.randint(0, 4, 100)).astype(np.float32)
    bf = 40.0
    got = residuals.residual_and_jacobians(T(A), T(K), bf, T(pw), T(obs))
    ref = jax.vmap(jres.residual_and_jacobians, in_axes=(0, None, None, 0, 0))(
        J(A), J(K), bf, J(pw), J(obs))
    np.testing.assert_allclose(N(got[0]), np.asarray(ref[0]), atol=1e-3)
    for g, r in zip(got[1:], ref[1:]):
        np.testing.assert_allclose(N(g), np.asarray(r), rtol=1e-3, atol=1e-3)
    e_only, z_only = residuals.residual_only(T(A), T(K), bf, T(pw), T(obs))
    np.testing.assert_allclose(N(e_only), N(got[0]), atol=1e-4)
    np.testing.assert_allclose(N(z_only), N(got[3]), atol=1e-6)
    chi2 = residuals.chi2_of(got[0], T(is_st), T(is2))
    jchi2 = jres.chi2_of(ref[0], J(is_st), J(is2))
    np.testing.assert_allclose(N(chi2), np.asarray(jchi2), rtol=1e-3)
    np.testing.assert_allclose(N(residuals.huber_weight(chi2, residuals.CHI2_MONO)),
                               np.asarray(jres.huber_weight(jchi2, jres.CHI2_MONO)),
                               rtol=1e-3)


def test_pose_optimization_matches_reference():
    rng = np.random.RandomState(2)
    K = np.array([500.0, 500.0, 320.0, 240.0], np.float32)
    n = 300
    pw = (rng.rand(n, 3) * [6, 4, 6] + [-3, -2, 4]).astype(np.float32)
    T_true = np.asarray(jlie.se3_exp(jnp.asarray([0.02, -0.03, 0.01, 0.1, -0.05, 0.2])))
    uv, _ = jcam.project(J(K), jlie.se3_apply(J(T_true), J(pw)))
    obs = np.asarray(uv) + rng.randn(n, 2).astype(np.float32) * 0.7
    obs[:30] += rng.randn(30, 2).astype(np.float32) * 40.0  # outliers
    obs3 = np.concatenate([obs, np.zeros((n, 1), np.float32)], 1)
    level = rng.randint(0, 4, n)
    inv_s2 = (1.0 / 1.44 ** level).astype(np.float32)
    valid = (rng.rand(n) < 0.95).astype(np.float32)
    T0 = np.asarray(jlie.se3_retract(J(T_true), jnp.asarray([0.01, 0.01, -0.01, 0.05, 0.05, -0.05])))
    zeros = np.zeros(n, np.float32)
    got = pose_opt.pose_optimization(T(T0), T(K), 0.0, T(pw), T(obs3), T(zeros),
                                     T(inv_s2), T(valid))
    ref = jpose.pose_optimization(J(T0), J(K), 0.0, J(pw), J(obs3), J(zeros),
                                  J(inv_s2), J(valid))
    np.testing.assert_array_equal(N(got[1]), np.asarray(ref[1]))
    assert int(got[2]) == int(ref[2]) > 200
    np.testing.assert_allclose(N(got[0]), np.asarray(ref[0]), atol=1e-4)


# ---------------------------------------------------------------------------
# matching
# ---------------------------------------------------------------------------

def _match_scene(seed, nq=300, nt=350):
    rng = np.random.RandomState(seed)
    tdesc = rng.randint(0, 2 ** 32, (nt, 8), dtype=np.uint64).astype(np.uint32)
    src = rng.permutation(nt)[:nq]
    noise = (rng.rand(nq, 8, 32) < 0.04).astype(np.uint64)
    flips = (noise << np.arange(32, dtype=np.uint64)).sum(-1).astype(np.uint32)
    qdesc = tdesc[src] ^ flips
    tuv = (rng.rand(nt, 2) * [320, 240]).astype(np.float32)
    quv = (tuv[src] + rng.randn(nq, 2) * 2.0).astype(np.float32)
    return rng, qdesc, quv, tdesc, tuv, src


def test_match_by_projection_bit_exact():
    rng, qdesc, quv, tdesc, tuv, src = _match_scene(3)
    nq, nt = len(qdesc), len(tdesc)
    qvalid = rng.rand(nq) < 0.9
    plvl = rng.randint(0, 4, nq).astype(np.int32)
    tlvl = rng.randint(0, 4, nt).astype(np.int32)
    tlvl[src] = np.clip(plvl + rng.randint(-1, 2, nq), 0, 3)
    tvalid = rng.rand(nt) < 0.95
    qang = rng.rand(nq).astype(np.float32) * 6.0
    tang = rng.rand(nt).astype(np.float32) * 6.0
    sf = np.asarray(jorb.scale_factors(4, 1.2)[0])
    for kw in (dict(th=100, ratio=0.9), dict(th=50, ratio=0.8, check_rotation=True),
               dict(th=50, ratio=1.0, level_tol=0)):
        got = matching.match_by_projection(
            T(quv), T(qvalid), T(plvl), T(qdesc.view(np.int32)), T(qang), T(tuv),
            T(tlvl), T(tdesc.view(np.int32)), T(tang), T(tvalid), 6.0, T(sf), **kw)
        ref = jmatch.match_by_projection(
            J(quv), J(qvalid), J(plvl), J(qdesc), J(qang), J(tuv), J(tlvl),
            J(tdesc), J(tang), J(tvalid), 6.0, J(sf), **kw)
        np.testing.assert_array_equal(N(got[0]), np.asarray(ref[0]))
        np.testing.assert_array_equal(N(got[1]), np.asarray(ref[1]))
        assert (np.asarray(ref[0]) >= 0).sum() > 20


def test_match_windowed_bit_exact():
    rng, qdesc, quv, tdesc, tuv, _ = _match_scene(4)
    nq, nt = len(qdesc), len(tdesc)
    la = (rng.rand(nq) < 0.1).astype(np.int32)
    lb = (rng.rand(nt) < 0.1).astype(np.int32)
    va, vb = rng.rand(nq) < 0.9, rng.rand(nt) < 0.9
    aa = rng.rand(nq).astype(np.float32) * 0.3
    ab = rng.rand(nt).astype(np.float32) * 0.3
    got = matching.match_windowed(T(quv), T(qdesc.view(np.int32)), T(aa), T(va), T(tuv),
                                  T(tdesc.view(np.int32)), T(ab), T(vb), window=20.0,
                                  level_a=T(la), level_b=T(lb))
    ref = jmatch.match_windowed(J(quv), J(qdesc), J(aa), J(va), J(tuv), J(tdesc), J(ab),
                                J(vb), window=20.0, level_a=J(la), level_b=J(lb))
    np.testing.assert_array_equal(N(got[0]), np.asarray(ref[0]))
    np.testing.assert_array_equal(N(got[1]), np.asarray(ref[1]))
    assert (np.asarray(ref[0]) >= 0).sum() > 30


def test_best_two_batched_bit_exact():
    """best_two over a leading batch axis (create_new_points' [T,N,N]) is
    the reference's vmapped best_two, bit-exact, with exact ties and fully
    masked rows."""
    rng = np.random.RandomState(5)
    dist = rng.randint(0, 8, (10, 60, 70)).astype(np.int32)   # many exact ties
    mask = rng.rand(10, 60, 70) < 0.3
    mask[:, :5] = False                                       # empty rows
    mask[3] = False                                           # an empty neighbor
    got = matching.best_two(T(dist), T(mask))
    ref = jax.vmap(jmatch.best_two)(J(dist), J(mask))
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(N(g), np.asarray(r))


# ---------------------------------------------------------------------------
# ORB
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def frame():
    imgs, _, _ = jsyn.planar_sequence(n_frames=2, h=240, w=320, fx=260.0, fy=260.0, seed=3)
    return imgs[1]


def _kp_rows(f):
    """Per-row (x, y, level, valid) of a Features tuple."""
    return np.concatenate([N(f.uv), N(f.level)[:, None], N(f.valid)[:, None]], 1)


def test_orb_on_reference_pyramid(frame):
    shapes = jorb.pyramid_shapes(240, 320, 4, 1.2)
    jpyr = jorb.build_pyramid(jnp.asarray(frame), shapes)
    ref = jorb.extract(jnp.asarray(frame), n_features=512, n_levels=4)
    got = orb.extract_from_pyramid([T(np.asarray(p)) for p in jpyr], n_features=512)
    np.testing.assert_array_equal(_kp_rows(got), _kp_rows(ref))
    np.testing.assert_array_equal(N(got.score), np.asarray(ref.score))
    np.testing.assert_allclose(N(got.angle), np.asarray(ref.angle), atol=1e-4)
    v = N(got.valid)
    same = (N(got.desc).view(np.uint32) == np.asarray(ref.desc)).all(1)[v]
    assert v.sum() > 400 and same.mean() >= 0.99


def test_orb_from_raw_image(frame):
    shapes = jorb.pyramid_shapes(240, 320, 4, 1.2)
    jpyr = jorb.build_pyramid(jnp.asarray(frame), shapes)
    pyr = orb.build_pyramid(T(frame), shapes)
    for a, b in zip(pyr, jpyr):
        np.testing.assert_allclose(N(a), np.asarray(b), atol=2e-3)
    got = orb.extract(T(frame), n_features=512, n_levels=4)
    ref = jorb.extract(jnp.asarray(frame), n_features=512, n_levels=4)
    ka, kb = _kp_rows(got), _kp_rows(ref)
    v = kb[:, 3] > 0
    assert (ka == kb).all(1)[v].mean() >= 0.97


def test_synthetic_matches_reference_renderer():
    """The numpy renderer against the OpenCV one: identical textures and
    poses; frames within 0.05 grey levels (OpenCV 5's bilinear weights)."""
    a, pa, ka = jsyn.planar_sequence(n_frames=3, h=120, w=160, fx=130.0, fy=130.0, seed=3)
    b, pb, kb = synthetic.planar_sequence(n_frames=3, h=120, w=160, fx=130.0, fy=130.0, seed=3)
    np.testing.assert_array_equal(jsyn._texture(512, 80), synthetic._texture(512, 80))
    np.testing.assert_array_equal(np.stack(pa), np.stack(pb))
    np.testing.assert_array_equal(ka, kb)
    np.testing.assert_allclose(a, b, atol=0.05)


# ---------------------------------------------------------------------------
# two-view initialization
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("planar", [False, True])
def test_initialize_two_view_same_hypotheses(planar):
    rng = np.random.RandomState(5)
    K = np.array([500.0, 500.0, 320.0, 240.0], np.float32)
    n = 300
    if planar:
        xy = rng.uniform(-3, 3, (n, 2))
        pts = np.concatenate([xy, 6.0 + 0.3 * xy[:, :1] + 0.1 * xy[:, 1:]], 1)
    else:
        pts = rng.uniform([-3, -2, 4], [3, 2, 12], (n, 3))
    pts = pts.astype(np.float32)
    T21 = np.asarray(jlie.se3_exp(jnp.asarray([0.02, -0.04, 0.01, 0.4, 0.03, 0.05])))
    uv1 = np.asarray(jcam.project(J(K), J(pts))[0]) + rng.randn(n, 2).astype(np.float32) * 0.3
    uv2 = np.asarray(jcam.project(J(K), jlie.se3_apply(J(T21), J(pts)))[0])
    uv2 = uv2 + rng.randn(n, 2).astype(np.float32) * 0.3
    valid = rng.rand(n) < 0.9
    # the reference's own hypothesis sets (init2view.py:317-321, PRNGKey(0))
    u = jax.random.uniform(jax.random.PRNGKey(0), (jinit.N_HYP, n), minval=1e-9, maxval=1.0)
    sel = np.asarray(jax.lax.top_k(jnp.where(J(valid)[None], -jnp.log(-jnp.log(u)), -jnp.inf), 8)[1])
    ref = jinit.initialize_two_view(J(K), J(uv1), J(uv2), J(valid))
    got = init2view.initialize_two_view(T(K), T(uv1), T(uv2), T(valid), sel=T(sel))
    assert bool(got.ok) == bool(ref.ok) is True
    assert bool(got.used_h) == bool(ref.used_h)
    np.testing.assert_array_equal(N(got.good), np.asarray(ref.good))
    Rg = N(lie.quat_to_matrix(got.T_21[:4]))
    Rr = np.asarray(jlie.quat_to_matrix(ref.T_21[:4]))
    np.testing.assert_allclose(Rg, Rr, atol=1e-4)
    tg, tr = N(got.T_21[4:]), np.asarray(ref.T_21[4:])
    np.testing.assert_allclose(tg / np.linalg.norm(tg), tr / np.linalg.norm(tr), atol=1e-4)
    # with its own generator the port still recovers the motion
    own = init2view.initialize_two_view(T(K), T(uv1), T(uv2), T(valid),
                                        generator=torch.Generator().manual_seed(0))
    assert bool(own.ok)
    np.testing.assert_allclose(N(lie.quat_to_matrix(own.T_21[:4])), Rr, atol=5e-3)
