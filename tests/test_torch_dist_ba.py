"""The port's distributed BA (``parallel/dist_ba.py``) against the reference
package's and against its own single-process solve.

All on the CPU. One module fixture spawns 2 gloo ranks once (one PyTorch
thread each, no JAX in them) and runs every distributed job there:

- ``dist_ba_solve`` (5 LM x 20 CG steps, no Huber) on the reference test's
  ``_stereo_problem`` (4 cameras x 64 points; ``tests/test_vocab_and_dist.py:74-108``,
  built with JAX and carried across) and on the same recipe at an odd edge
  count (3 cameras x 65 points = 195 edges, so a rank holds a pad), held to
  the port's ``ba_solve`` in this process and to the reference's 8-device
  ``dist_ba_solve`` at that test's bars (``:111-129``): cost within 1e-3
  relative, poses within 5e-4, points within 5e-3; both ranks hold the same
  result, bit for bit;
- ``dist_score_database`` at K = 17 keyframes (odd: the pad row is
  stripped) against the port's and the reference's ``score_database``:
  common-word counts equal, scores within 1e-5 (``:132-146``'s bar).

Also: ``camera.project_stereo`` against the reference's (1e-4 px; the
same float32 formula), ``shard_problem`` at world 2, 3 and 4 (every edge
in exactly one shard, pads invalid), and the not-distributed default of
``initialize_multihost``.
"""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from test_vocab_and_dist import _stereo_problem  # noqa: E402

from orbslam2_with_quadrics_tpu.models import loop_closing as jlc  # noqa: E402
from orbslam2_with_quadrics_tpu.ops import camera as jcam  # noqa: E402
from orbslam2_with_quadrics_tpu.parallel import dist_ba as jdist  # noqa: E402
from orbslam2_with_quadrics_tpu_torch.models import loop_closing as lc  # noqa: E402
from orbslam2_with_quadrics_tpu_torch.ops import ba, camera  # noqa: E402
from orbslam2_with_quadrics_tpu_torch.parallel import dist_ba, launch  # noqa: E402

SOLVE = dict(n_iters=5, cg_iters=20, use_huber=False)
WORLD = 2


def reference_problems():
    """(name, the reference's BAProblem): the test's problem and the odd one."""
    even, _, _ = _stereo_problem(jax.random.PRNGKey(7))
    odd, _, _ = _stereo_problem(jax.random.PRNGKey(11), n_cams=3, n_pts=65)
    return [("even", even), ("odd", odd)]


def score_inputs():
    """``test_dist_retrieval_matches_local``'s database at K = 17."""
    Kn, V = 17, 64
    bow = jax.random.uniform(jax.random.PRNGKey(8), (Kn, V))
    bow = bow * (bow > 0.7)
    bow = bow / jnp.maximum(jnp.sum(jnp.abs(bow), axis=1, keepdims=True), 1e-9)
    valid = np.ones((Kn,), bool)
    valid[5] = False
    return np.array(bow), np.array(bow[3]), valid


@pytest.fixture(scope="module")
def ranks():
    """Every rank's results of the distributed jobs, spawned once."""
    probs = reference_problems()
    jobs = [(ba.BAProblem(*(np.asarray(a) for a in p)), SOLVE) for _, p in probs]
    res = launch.run_ranks(launch.rank_jobs, WORLD, "cpu", jobs, [score_inputs()],
                           device="cpu", timeout=300.0)
    return probs, res


def test_project_stereo_matches_reference():
    rng = np.random.RandomState(0)
    K = np.array([300.0, 310.0, 160.0, 120.0], np.float32)
    p = (rng.randn(50, 3) * [1.0, 1.0, 0.5] + [0.0, 0.0, 5.0]).astype(np.float32)
    p[0, 2] = 0.0  # the |z| < 1e-8 clamp
    uvr, z = camera.project_stereo(torch.as_tensor(K), 30.0, torch.as_tensor(p))
    ruvr, rz = jcam.project_stereo(jnp.asarray(K), 30.0, jnp.asarray(p))
    np.testing.assert_array_equal(z.numpy(), np.asarray(rz))
    np.testing.assert_allclose(uvr.numpy()[1:], np.asarray(ruvr)[1:], rtol=1e-6, atol=1e-4)
    np.testing.assert_allclose(uvr.numpy()[0], np.asarray(ruvr)[0], rtol=1e-6)


@pytest.mark.parametrize("world", [2, 3, 4])
def test_shard_problem_covers_every_edge_once(world):
    """195 edges: a pad of 1 at world 2 and 3 at world 4, none at world 3."""
    _, odd = reference_problems()[1]
    prob = ba.ba_problem_from_numpy(odd)
    O = prob.cam_idx.shape[0]
    shards = [dist_ba.shard_problem(prob, r, world) for r in range(world)]
    n = -(-O // world)
    for f in dist_ba.EDGE_FIELDS:
        got = torch.cat([getattr(s, f) for s in shards])
        assert all(getattr(s, f).shape[0] == n for s in shards)
        torch.testing.assert_close(got[:O], getattr(prob, f), rtol=0, atol=0)
        assert torch.all(got[O:] == 0), f  # pads: index 0, uvr 0, valid 0
    for f in ("poses", "points", "K", "bf", "fixed_cam", "fixed_pnt"):
        assert all(getattr(s, f) is getattr(prob, f) for s in shards)


@pytest.mark.parametrize("case", [0, 1], ids=["even", "odd"])
def test_dist_ba_solve_matches_single_process_and_reference(ranks, case):
    probs, res = ranks
    _, jprob = probs[case]
    poses, points, cost, _ = res[0]["ba"][case]
    for r in res[1:]:  # every rank holds the same state
        np.testing.assert_array_equal(r["ba"][case][0], poses)
        np.testing.assert_array_equal(r["ba"][case][1], points)
        assert r["ba"][case][2] == cost
    one, cost1 = ba.ba_solve(ba.ba_problem_from_numpy(jprob), **SOLVE)
    mesh = jdist.make_ba_mesh(8)
    ref, cost8 = jdist.dist_ba_solve(jdist.shard_problem(jprob, mesh), mesh, **SOLVE)
    for other_poses, other_points, other_cost in (
            (one.poses.numpy(), one.points.numpy(), float(cost1)),
            (np.asarray(ref.poses), np.asarray(ref.points), float(cost8))):
        np.testing.assert_allclose(cost, other_cost, rtol=1e-3)
        np.testing.assert_allclose(poses, other_poses, atol=5e-4)
        np.testing.assert_allclose(points, other_points, atol=5e-3)
    # the solve did converge from its start
    c0 = float(ba._edge_terms(ba.ba_problem_from_numpy(jprob), 0.0)[5])
    assert cost < 0.1 * c0


def test_dist_score_database_matches_both_packages(ranks):
    _, res = ranks
    bow, q, valid = score_inputs()
    s_port, c_port = lc.score_database(*(torch.as_tensor(a) for a in (bow, q, valid)))
    s_ref, c_ref = jlc.score_database(jnp.asarray(bow), jnp.asarray(q), jnp.asarray(valid))
    for r in res:
        s, c = r["score"][0]
        assert s.shape == (17,) and c.shape == (17,)
        np.testing.assert_array_equal(c, c_port.numpy())
        np.testing.assert_array_equal(c, np.asarray(c_ref))
        np.testing.assert_allclose(s, s_port.numpy(), atol=1e-5)
        np.testing.assert_allclose(s, np.asarray(s_ref), atol=1e-5)
    assert res[0]["report"] == {"process_index": 0, "process_count": WORLD,
                                "backend": "gloo", "local_devices": 0, "global_devices": 0}
    assert res[1]["report"]["process_index"] == 1


def test_not_distributed_without_arguments_or_environment(monkeypatch):
    for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR"):
        monkeypatch.delenv(k, raising=False)
    assert dist_ba.initialize_multihost() is None
    assert dist_ba.rank_and_world(None) == (0, 1)
    with pytest.raises(ValueError):
        dist_ba.initialize_multihost(num_processes=2)
    # the group=None path of the retrieval is the local scoring
    bow, q, valid = (torch.as_tensor(a) for a in score_inputs())
    for a, b in zip(dist_ba.dist_score_database(bow, q, valid, None),
                    lc.score_database(bow, q, valid)):
        assert torch.equal(a, b)
