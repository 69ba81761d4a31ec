"""The port's dense-Schur local BA (``ops/ba.ba_solve_dense``) against the
reference's, on the CPU.

The problems are ``tests/test_ba.py``'s dense-Schur cases (built with JAX,
carried across with ``ba_problem_from_numpy``). Tolerances:
- ``_local_point_table``: the local slots and each edge's slot identical
  (so the overflow set, the eligible points past the L kept, is too);
- ``ba_solve_dense``: poses within 1e-4, cost within 1e-4 relative; points
  within 1e-4 at the median and 1e-3 + 2e-3 relative at most (a far point
  seen by a mono camera pair is weakly held);
- the dense schedule helper (``local_mapping._dense_schedule``: 4 Huber
  iterations, the ``edge_chi2`` purge, then plain ones) against the
  reference's two ``ba_solve_dense`` calls and purge composed by hand: the
  purged edge set identical, poses within 1e-4, cost within 1e-4 relative;
- the port's dense solver against its own PCG ``ba_solve``: poses within
  1e-4, cost within 1e-3 relative (``tests/test_ba.py``'s bar for the pair);
- ``local_ba`` (the reference's 5 robust + purge + 10 PCG schedule) on
  ``tests/test_ba.py::test_ba_huber_survives_outliers``' problem drawn from
  numpy seeds, 10% of its edges moved by 100 px: poses within 1e-4, the
  purged ``valid`` mask identical, cost within 1e-3 relative;
- ``_inv3x3`` against ``torch.linalg.inv``: 1e-5 relative; a matrix that is
  not positive definite gives a NaN step, which the LM test rejects.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orbslam2_with_quadrics_tpu.ops import ba as jba
from orbslam2_with_quadrics_tpu.ops import camera as jcam
from orbslam2_with_quadrics_tpu.ops import lie as jlie
from orbslam2_with_quadrics_tpu_torch.models import local_mapping as lm
from orbslam2_with_quadrics_tpu_torch.ops import ba


def dense_problem(seed=0, C=16, P=512, O=4096, stereo=True, outliers=0.0):
    """``tests/test_ba.py::test_dense_schur_matches_pcg``'s problem (cam-major
    [C, N] table, each camera seeing N distinct points); ``outliers`` moves
    that share of the observations by 30 px."""
    key = jax.random.PRNGKey(seed)
    Kc = jnp.asarray([500.0, 500.0, 320.0, 240.0])
    bf = jnp.asarray(50.0)
    pts = jax.random.uniform(key, (P, 3), minval=jnp.asarray([-5.0, -3.0, 3.0]),
                             maxval=jnp.asarray([5.0, 3.0, 15.0]))
    poses = jlie.se3_exp(jax.random.normal(key, (C, 6))
                         * jnp.asarray([0.005] * 3 + [0.2, 0.05, 0.2]))
    N = O // C
    ci = jnp.repeat(jnp.arange(C, dtype=jnp.int32), N)
    pi = jnp.concatenate([jax.random.permutation(jax.random.PRNGKey(100 + c), P)[:N]
                          for c in range(C)]).astype(jnp.int32)
    uvr, _ = jcam.project_stereo(Kc, bf, jlie.se3_apply(poses[ci], pts[pi]))
    uvr = uvr + 0.5 * jax.random.normal(key, uvr.shape)
    rng = np.random.RandomState(seed)
    bad = rng.rand(O) < outliers
    uvr = uvr + jnp.asarray(np.where(bad[:, None], 30.0, 0.0), jnp.float32)
    return jba.BAProblem(
        poses=poses, points=pts + 0.03, K=Kc, bf=bf, cam_idx=ci, pnt_idx=pi, uvr=uvr,
        is_stereo=jnp.full((O,), 1.0 if stereo else 0.0), inv_sigma2=jnp.ones((O,)),
        valid=jnp.asarray(rng.rand(O) > 0.05, jnp.float32),
        fixed_cam=jnp.zeros((C,)).at[0].set(1.0),
        fixed_pnt=jnp.asarray(rng.rand(P) < 0.05, jnp.float32),
    ), (C, N)


def overflow_problem():
    """``tests/test_ba.py::test_dense_schur_point_overflow_is_safe``'s
    problem: more active points than local slots."""
    key = jax.random.PRNGKey(2)
    C, P, O = 8, 256, 2048
    Kc = jnp.asarray([400.0, 400.0, 160.0, 120.0])
    pts = jax.random.uniform(key, (P, 3), minval=jnp.asarray([-3.0, -2.0, 3.0]),
                             maxval=jnp.asarray([3.0, 2.0, 9.0]))
    poses = jlie.se3_exp(jax.random.normal(key, (C, 6)) * jnp.asarray([0.004] * 3 + [0.1] * 3))
    N = O // C
    ci = jnp.repeat(jnp.arange(C, dtype=jnp.int32), N)
    pi = jnp.concatenate([jax.random.permutation(jax.random.PRNGKey(300 + c), P)[:N]
                          for c in range(C)]).astype(jnp.int32)
    uvr, _ = jcam.project_stereo(Kc, jnp.asarray(40.0), jlie.se3_apply(poses[ci], pts[pi]))
    return jba.BAProblem(
        poses=poses, points=pts + 0.02, K=Kc, bf=jnp.asarray(40.0), cam_idx=ci, pnt_idx=pi,
        uvr=uvr, is_stereo=jnp.ones((O,)), inv_sigma2=jnp.ones((O,)), valid=jnp.ones((O,)),
        fixed_cam=jnp.zeros((C,)).at[0].set(1.0), fixed_pnt=jnp.zeros((P,)),
    ), (C, N)


def assert_solutions_agree(jp, jc, tp, tc, pose_tol=1e-4, cost_rtol=1e-4):
    np.testing.assert_allclose(tp.poses.numpy(), np.asarray(jp.poses), atol=pose_tol)
    d = np.abs(tp.points.numpy() - np.asarray(jp.points))
    assert np.median(d) < 1e-4
    np.testing.assert_allclose(tp.points.numpy(), np.asarray(jp.points), rtol=2e-3, atol=1e-3)
    assert abs(float(tc) - float(jc)) <= cost_rtol * float(jc)


@pytest.mark.parametrize("case", ["dense", "huber-mono", "overflow"])
def test_ba_solve_dense_matches_reference(case):
    if case == "overflow":
        jprob, grid = overflow_problem()
        L, huber = 128, False
    else:
        jprob, grid = dense_problem(stereo=case == "dense", outliers=0.0 if case == "dense" else 0.05)
        L, huber = jprob.points.shape[0], case != "dense"
    prob = ba.ba_problem_from_numpy(jprob)
    j_ids, j_ploc = jba._local_point_table(jprob, L, grid)
    ids, ploc = ba._local_point_table(prob, L, grid)
    np.testing.assert_array_equal(ids.numpy(), np.asarray(j_ids))
    np.testing.assert_array_equal(ploc.numpy(), np.asarray(j_ploc))
    if case == "overflow":  # eligible points past the L kept: fixed this solve
        active = np.unique(np.asarray(jprob.pnt_idx))
        assert len(active) > L and set(active) - set(ids.numpy().tolist())
    jp, jc = jba.ba_solve_dense(jprob, n_iters=6, n_local_pts=L, use_huber=huber, cam_grid=grid)
    tp, tc = ba.ba_solve_dense(prob, n_iters=6, n_local_pts=L, use_huber=huber, cam_grid=grid)
    # the LM converged (the Huber case keeps its 5% outliers' cost)
    cost0 = float(ba._cost_grid(prob, prob.poses, prob.points, 7.815 if huber else 0.0, grid))
    assert float(tc) < (0.75 if huber else 0.5) * cost0
    assert_solutions_agree(jp, jc, tp, tc)


def test_dense_schedule_matches_reference_composition():
    """``_dense_schedule`` = the reference's dense branch of its local BA
    (``local_mapping.py:672-682``), composed here by hand."""
    jprob, grid = dense_problem(seed=4, C=12, P=384, O=3072, outliers=0.05)
    P = jprob.points.shape[0]
    jp, _ = jba.ba_solve_dense(jprob, n_iters=4, n_local_pts=min(P, 8192), use_huber=True,
                               cam_grid=grid)
    _, inl = jba.edge_chi2(jp)
    jp = jp._replace(valid=jp.valid * inl.astype(jnp.float32))
    jp, jc = jba.ba_solve_dense(jp, n_iters=6, n_local_pts=min(P, 8192), use_huber=False,
                                cam_grid=grid)
    tp, tc = lm._dense_schedule(ba.ba_problem_from_numpy(jprob), grid, 4, 6)
    np.testing.assert_array_equal(tp.valid.numpy(), np.asarray(jp.valid))
    assert 0 < int((np.asarray(jp.valid) == 0).sum()) < len(jp.valid)
    assert_solutions_agree(jp, jc, tp, tc)


def test_dense_matches_pcg():
    """The same LM schedule, an exact solve against 40 CG steps."""
    jprob, grid = dense_problem(seed=1)
    prob = ba.ba_problem_from_numpy(jprob)
    p1, c1 = ba.ba_solve(prob, n_iters=6, cg_iters=40, use_huber=False)
    p2, c2 = ba.ba_solve_dense(prob, n_iters=6, n_local_pts=prob.points.shape[0],
                               use_huber=False, cam_grid=grid)
    np.testing.assert_allclose(p2.poses.numpy(), p1.poses.numpy(), atol=1e-4)
    assert abs(float(c1) - float(c2)) / max(float(c1), 1.0) < 1e-3
    with pytest.raises(ValueError, match="cam_grid"):
        ba.ba_solve_dense(prob)


def test_inv3x3_and_cholesky_nan():
    rng = np.random.RandomState(0)
    A = torch.as_tensor(rng.randn(64, 3, 3).astype(np.float32))
    A = A @ A.mT + 0.1 * torch.eye(3)
    np.testing.assert_allclose(ba._inv3x3(A).numpy(), torch.linalg.inv(A).numpy(),
                               rtol=1e-5, atol=1e-5 * float(torch.linalg.inv(A).abs().max()))
    S = torch.as_tensor(np.diag([2.0, 1.0, 3.0]).astype(np.float32))
    g = torch.tensor([2.0, 1.0, 3.0])
    np.testing.assert_allclose(ba._cholesky_solve_nan(S, g).numpy(), [1.0, 1.0, 1.0], rtol=1e-6)
    assert torch.isnan(ba._cholesky_solve_nan(-S, g)).all()
    # a step through such a matrix is rejected: the LM keeps its state
    jprob, grid = overflow_problem()
    prob = ba.ba_problem_from_numpy(jprob)
    ids, ploc = ba._local_point_table(prob, 128, grid)
    poses, points, cost, acc = ba._dense_schur_step(
        prob, prob.poses, prob.points, torch.tensor(-3.0), 0.0, ids, ploc, grid)
    assert not bool(acc)
    assert torch.equal(poses, prob.poses) and torch.equal(points, prob.points)
    assert torch.isfinite(cost)


def huber_outlier_problem(seed, n_cams=6, n_pts=96, noise_px=0.1, bad_share=0.1):
    """``tests/test_ba.py::make_problem``'s stereo scene (every point seen by
    every camera, the first camera fixed at the truth) from a numpy seed,
    with ``bad_share`` of the observations moved by 100 px of noise."""
    rng = np.random.RandomState(seed)
    Kc = jnp.asarray([500.0, 500.0, 320.0, 240.0])
    bf = jnp.asarray(50.0)
    pts = rng.uniform([-3.0, -2.0, 5.0], [3.0, 2.0, 12.0], (n_pts, 3)).astype(np.float32)
    xi = rng.randn(n_cams, 6) * [0.02, 0.02, 0.02, 0.4, 0.1, 0.1]
    xi[:, 3] += np.linspace(0, 1.5, n_cams)
    poses_true = jlie.se3_exp(jnp.asarray(xi, jnp.float32))
    ci = np.repeat(np.arange(n_cams, dtype=np.int32), n_pts)
    pi = np.tile(np.arange(n_pts, dtype=np.int32), n_cams)
    uvr, _ = jcam.project_stereo(Kc, bf, jlie.se3_apply(poses_true[ci], jnp.asarray(pts)[pi]))
    uvr = np.asarray(uvr) + noise_px * rng.randn(len(ci), 3).astype(np.float32)
    bad = rng.rand(len(ci)) < bad_share
    uvr = np.where(bad[:, None], uvr + 100.0 * rng.randn(len(ci), 3), uvr).astype(np.float32)
    poses0 = jax.vmap(jlie.se3_retract)(
        poses_true, jnp.asarray(rng.randn(n_cams, 6).astype(np.float32) * 0.02))
    poses0 = poses0.at[0].set(poses_true[0])
    pts0 = pts + (0.05 * rng.randn(n_pts, 3)).astype(np.float32)
    O = len(ci)
    return jba.BAProblem(
        poses=poses0, points=jnp.asarray(pts0), K=Kc, bf=bf, cam_idx=jnp.asarray(ci),
        pnt_idx=jnp.asarray(pi), uvr=jnp.asarray(uvr), is_stereo=jnp.ones((O,)),
        inv_sigma2=jnp.ones((O,)), valid=jnp.ones((O,)),
        fixed_cam=jnp.zeros((n_cams,)).at[0].set(1.0), fixed_pnt=jnp.zeros((n_pts,)),
    ), bad


@pytest.mark.parametrize("seed", [0, 1])
def test_local_ba_matches_reference(seed):
    jprob, bad = huber_outlier_problem(seed)
    jp, jc = jba.local_ba(jprob, cg_iters=30)
    tp, tc = ba.local_ba(ba.ba_problem_from_numpy(jprob), cg_iters=30)
    valid = tp.valid.numpy()
    np.testing.assert_array_equal(valid, np.asarray(jp.valid))
    # the purge took most of the corrupted edges and few of the others
    assert valid[bad].mean() < 0.1 and valid[~bad].mean() > 0.9
    np.testing.assert_allclose(tp.poses.numpy(), np.asarray(jp.poses), atol=1e-4)
    assert abs(float(tc) - float(jc)) <= 1e-3 * float(jc)
