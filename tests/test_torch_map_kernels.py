"""The dense-Schur local BA's per-edge terms and point blocks
(``ops/ba.dense_terms``, kernels ``csrc/ba_dense_terms.cu``).

On the CPU:
- ``dense_terms_plain`` through ``ba_solve_dense`` (the CPU route) against
  the reference's ``ba_solve_dense`` at C = 4-6 cameras, N = 64 edges each
  and L = 128 local slots, on problems drawn from numpy seeds with mixed
  mono / stereo rows, outliers, fixed points, and two edges of one camera
  on one point (their blocks add up; more eligible points than slots is
  ``tests/test_torch_dense_ba.py``'s overflow case):
  ``tests/test_torch_dense_ba.py``'s bars (poses 1e-4, cost 1e-4 relative,
  points 1e-4 at the median and 1e-3 + 2e-3 relative at most);
- a CPU model of the kernels' decomposition (each edge's 27 numbers in the
  table's layout summed per camera and slot in the sorted edge order, the
  camera blocks from their upper triangle, the point pass's damping and
  adjugate inverse, VH) against ``dense_terms_plain``: the sums without
  cancellation (Hcc_d, V, the cost) within 1e-5 relative (max abs
  difference / max(1, max abs of the plain)); the gradients (bc, bp),
  which cancel as the LM converges, and the point blocks' inverses and
  their products (Hpi, Hpi bp, VH), which float32 determines only to about
  a block's condition number times 6e-8, no further from a float64
  evaluation of the plain version than 1e-5 + 4x the plain version's own
  distance to it;
- the terms route chosen by the caller: ``_dense_schur_step``,
  ``ba_solve_dense`` and ``_dense_schedule`` through ``dense_terms_plain``
  equal to the default route on CPU tensors.

On the card (``cuda`` marker; the reference is imported inside
:func:`jax_ref`, so these also run where JAX is not installed:
``python -m pytest -o addopts="" tests/test_torch_map_kernels.py -m cuda``):
``dense_terms`` against ``dense_terms_plain`` with the same bars, three
launches per LM step and one per solve, a second run bit for bit equal;
the solve and the 4 + 6 schedule through both routes (poses 1e-4, cost
1e-3 relative).
"""

import numpy as np
import pytest
import torch

from orbslam2_with_quadrics_tpu_torch.models import local_mapping as lm
from orbslam2_with_quadrics_tpu_torch.ops import ba, residuals
from orbslam2_with_quadrics_tpu_torch.ops import cuda_kernels as ck


def jax_ref():
    import jax.numpy as jnp

    from orbslam2_with_quadrics_tpu.ops import ba as jba

    return jnp, jba


def N(t):
    return t.detach().cpu().numpy()


def _se3_exp(xi):
    """[C,6] tangents -> [C,7] (w, x, y, z, t) poses, in numpy (float64)."""
    out = []
    for w, v in zip(xi[:, :3], xi[:, 3:]):
        th = np.linalg.norm(w)
        k = w / max(th, 1e-12)
        out.append(np.concatenate([[np.cos(th / 2)], np.sin(th / 2) * k, v]))
    return np.asarray(out)


def _rotate(q, p):
    w, u = q[:, :1], q[:, 1:]
    t = 2.0 * np.cross(u, p)
    return p + w * t + np.cross(u, t)


def grid_problem(seed, C=6, n=64, stereo=0.5, outliers=0.05, dup=4):
    """A cam-major [C, n] problem as numpy arrays (BAProblem's fields):
    C n / 4 points 3-12 units ahead, each seen by four neighbouring cameras
    (camera c the points c n / 4 .. c n / 4 + n, shuffled, around the
    ring), poses 0-1 unit apart along x, 0.5 px noise, ``stereo`` of the
    rows measuring u_r, ``outliers`` of them 25 px off, 5% of the rows not
    valid, camera 0 and 5% of the points fixed, and the last ``dup`` edges
    of each camera repeating earlier points of its row."""
    rng = np.random.RandomState(seed)
    K = np.array([500.0, 500.0, 320.0, 240.0])
    bf = 40.0
    P = C * n // 4
    pts = rng.uniform([-4.0, -3.0, 3.0], [4.0, 3.0, 12.0], (P, 3))
    xi = rng.randn(C, 6) * [0.01, 0.01, 0.01, 0.1, 0.05, 0.1]
    xi[:, 3] += np.linspace(0.0, 1.0, C)
    poses = _se3_exp(xi)
    perm = rng.permutation(P)
    pid = np.stack([perm[(c * n // 4 + rng.permutation(n)) % P] for c in range(C)])
    pid[:, n - dup:] = pid[:, :dup][:, ::-1]
    ci = np.repeat(np.arange(C), n)
    pi = pid.reshape(-1)
    pc = _rotate(poses[ci, :4], pts[pi]) + poses[ci, 4:]
    u = K[0] * pc[:, 0] / pc[:, 2] + K[2]
    v = K[1] * pc[:, 1] / pc[:, 2] + K[3]
    uvr = np.stack([u, v, u - bf / pc[:, 2]], 1) + 0.5 * rng.randn(C * n, 3)
    uvr[rng.rand(C * n) < outliers] += 25.0
    is_st = (rng.rand(C * n) < stereo).astype(np.float64)
    uvr[:, 2] *= is_st
    poses0 = poses.copy()
    poses0[1:, 4:] += 0.02 * rng.randn(C - 1, 3)
    f32 = lambda a: np.asarray(a, np.float32)  # noqa: E731
    return dict(
        poses=f32(poses0), points=f32(pts + 0.03 * rng.randn(P, 3)), K=f32(K),
        bf=np.float32(bf), cam_idx=ci.astype(np.int32), pnt_idx=pi.astype(np.int32),
        uvr=f32(uvr), is_stereo=f32(is_st),
        inv_sigma2=f32(1.0 / 1.44 ** rng.randint(0, 4, C * n)),
        valid=f32(rng.rand(C * n) > 0.05), fixed_cam=f32(np.eye(C)[0]),
        fixed_pnt=f32(rng.rand(P) < 0.05)), (C, n)


def to_torch(arrays, device="cpu"):
    return ba.BAProblem(**{
        f: torch.as_tensor(arrays[f], device=device,
                           dtype=torch.int64 if f in ("cam_idx", "pnt_idx") else torch.float32)
        for f in ba.BAProblem._fields})


CASES = {  # seed, C, stereo share, Huber
    "C=4 stereo, plain": (0, 4, 1.0, False),
    "C=6 mixed, Huber": (1, 6, 0.5, True),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_dense_solve_matches_reference(name):
    jnp, jba = jax_ref()
    seed, C, stereo, huber = CASES[name]
    arrays, grid = grid_problem(seed, C=C, stereo=stereo)
    L = 128
    jprob = jba.BAProblem(**{k: jnp.asarray(v) for k, v in arrays.items()})
    prob = to_torch(arrays)
    ids, ploc = ba._local_point_table(prob, L, grid)
    np.testing.assert_array_equal(N(ploc), np.asarray(jba._local_point_table(jprob, L, grid)[1]))
    jp, jc = jba.ba_solve_dense(jprob, n_iters=6, n_local_pts=L, use_huber=huber,
                                cam_grid=grid)
    tp, tc = ba.ba_solve_dense(prob, n_iters=6, n_local_pts=L, use_huber=huber, cam_grid=grid,
                               terms=ba.dense_terms_plain)
    d2 = residuals.CHI2_STEREO if huber else 0.0
    assert float(tc) < 0.5 * float(ba._cost_grid(prob, prob.poses, prob.points, d2, grid))
    np.testing.assert_allclose(N(tp.poses), np.asarray(jp.poses), atol=1e-4)
    d = np.abs(N(tp.points) - np.asarray(jp.points))
    assert np.median(d) < 1e-4
    np.testing.assert_allclose(N(tp.points), np.asarray(jp.points), rtol=2e-3, atol=1e-3)
    assert abs(float(tc) - float(jc)) <= 1e-4 * float(jc)


def terms_kernel_model(prob, poses, points, lam, d2, ploc, grid, L):
    """CPU model of the kernels' decomposition: per edge the 27 numbers
    (Hpp's upper 6 as 00 01 02 11 12 22, bp's 3, V's 18 row-major) summed
    into a [C, L + 1, 27] table in the sorted (slot, edge) order, the camera
    blocks from Hcc's upper triangle, then the point pass: the table summed
    over the cameras in order, the damped diagonal, the adjugate inverse,
    Hpi bp and VH."""
    C, n = grid
    pid = prob.pnt_idx.reshape(C, n)
    e, Jc, Jp, z = residuals.residual_and_jacobians(
        poses[:, None, :], prob.K, prob.bf, points[pid], prob.uvr.reshape(C, n, 3))
    s = prob.is_stereo.reshape(C, n)
    is2 = prob.inv_sigma2.reshape(C, n)
    ok = prob.valid.reshape(C, n) * (z > 0.05).to(torch.float32)
    chi2 = (e[..., 0] ** 2 + e[..., 1] ** 2 + e[..., 2] ** 2 * s) * is2
    hw = residuals.huber_weight(chi2, d2) if d2 > 0 else torch.ones_like(chi2)
    w = ok * is2 * hw
    wr = torch.stack([w, w, s * w], -1)[..., None]
    Jc = Jc * (1.0 - prob.fixed_cam)[:, None, None, None]
    Jp = Jp * (1.0 - prob.fixed_pnt[pid])[..., None, None]
    cw, pw = Jc * wr, Jp * wr
    upper = [(i, j) for i in range(6) for j in range(i, 6)]
    Hu = torch.stack([(cw[..., i] * Jc[..., j]).sum((1, 2)) for i, j in upper], -1)
    Hcc = torch.zeros(C, 6, 6)
    for k, (i, j) in enumerate(upper):
        h = Hu[:, k] + lam * Hu[:, k] + (1e-8 + prob.fixed_cam) if i == j else Hu[:, k]
        Hcc[:, i, j] = Hcc[:, j, i] = h
    bc = -(cw * e[..., None]).sum((1, 2))
    cost = torch.sum(torch.where(chi2 > d2, 2.0 * torch.sqrt(d2 * chi2) - d2, chi2) * ok
                     if d2 > 0 else chi2 * ok)
    rows = torch.cat([
        torch.stack([(pw[..., i] * Jp[..., j]).sum(2) for i in range(3) for j in range(i, 3)], -1),
        -(pw * e[..., None]).sum(2),
        torch.stack([(cw[..., i] * Jp[..., j]).sum(2) for i in range(6) for j in range(3)], -1),
    ], -1)                                                     # [C, n, 27]
    table = torch.zeros(C, L + 1, 27)
    for c in range(C):
        order = torch.argsort(ploc[c] * n + torch.arange(n))
        table[c].index_add_(0, ploc[c][order], rows[c][order])
    h = table[0, :L, :9].clone()
    for c in range(1, C):
        h = h + table[c, :L, :9]
    trace = h[:, 0] + h[:, 3] + h[:, 5]
    add = torch.where(trace.abs() > 1e-12, 1e-8, 1.0)
    Hd = torch.stack([h[:, 0], h[:, 1], h[:, 2], h[:, 1], h[:, 3], h[:, 4],
                      h[:, 2], h[:, 4], h[:, 5]], -1).reshape(L, 3, 3)
    Hd = Hd + torch.diag_embed((lam * Hd.diagonal(dim1=1, dim2=2)) + add[:, None])
    Hpi = ba._inv3x3(Hd)
    V = table[:, :L, 9:].reshape(C, L, 6, 3)
    return ba.DenseTerms(Hcc, bc, cost, V, Hpi, h[:, 6:9], torch.einsum("ljk,lk->lj", Hpi,
                         h[:, 6:9]), torch.einsum("clij,ljk->clik", V, Hpi))


def relative_diff(a, b):
    """max |a - b| / max(1, max |b|)."""
    return float((a.double() - b.double()).abs().max()) / max(1.0, float(b.abs().max()))


def terms_agreement(got, ref, exact):
    """(the fields' relative distances, whether they meet the bars): the sums
    without cancellation (Hcc_d, V, the cost) within 1e-5 of the plain
    version ``ref``; the gradients (bc, bp) and Hpi, Hpib, VH no further
    from the float64 evaluation ``exact`` than 1e-5 + 4x ``ref``'s distance."""
    d = {f: relative_diff(g, r) for f, g, r in zip(ba.DenseTerms._fields, got, ref)}
    ok = all(d[f] <= 1e-5 for f in ("Hcc_d", "V", "cost"))
    for f in ("bc", "bp", "Hpi", "Hpib", "VH"):
        to_exact = relative_diff(getattr(got, f), getattr(exact, f))
        ref_exact = relative_diff(getattr(ref, f), getattr(exact, f))
        d[f + " vs float64"] = (to_exact, ref_exact)
        ok = ok and to_exact <= 1e-5 + 4.0 * ref_exact
    return d, ok


def in_float64(prob):
    return ba.BAProblem(*[x.double() if torch.is_tensor(x) and x.is_floating_point() else x
                          for x in prob])


@pytest.mark.parametrize("name", sorted(CASES))
def test_terms_kernel_model_matches_plain(name):
    seed, C, stereo, huber = CASES[name]
    arrays, grid = grid_problem(seed, C=C, stereo=stereo)
    prob = to_torch(arrays)
    L = 128
    _, ploc = ba._local_point_table(prob, L, grid)
    d2 = residuals.CHI2_STEREO if huber else 0.0
    for lam in (torch.tensor(1e-3), torch.tensor(1e-5)):
        ref = ba.dense_terms_plain(prob, prob.poses, prob.points, d2, grid, lam=lam, ploc=ploc,
                                   n_local=L)
        got = terms_kernel_model(prob, prob.poses, prob.points, lam, d2, ploc, grid, L)
        p64 = in_float64(prob)
        exact = ba.dense_terms_plain(p64, p64.poses, p64.points, d2, grid, lam=lam.double(),
                                     ploc=ploc, n_local=L)
        diffs, ok = terms_agreement(got, ref, exact)
        assert ok, diffs
    # the repeated edges' point blocks add up (a slot two edges of one camera share)
    dup = ploc[:, -1]
    assert bool((dup < L).any())
    assert float(ref.V[torch.arange(C), dup.clamp(max=L - 1)].abs().sum()) > 0


def test_the_caller_picks_the_terms_route():
    arrays, grid = grid_problem(2, C=4)
    prob = to_torch(arrays)
    ids, ploc = ba._local_point_table(prob, 128, grid)
    lam = torch.tensor(1e-4)
    a = ba._dense_schur_step(prob, prob.poses, prob.points, lam, 0.0, ids, ploc, grid)
    b = ba._dense_schur_step(prob, prob.poses, prob.points, lam, 0.0, ids, ploc, grid,
                             terms=ba.dense_terms_plain)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    sa = lm._dense_schedule(prob, grid, 2, 2)
    sb = lm._dense_schedule(prob, grid, 2, 2, terms=ba.dense_terms_plain)
    assert torch.equal(sa[0].poses, sb[0].poses) and torch.equal(sa[1], sb[1])
    with pytest.raises(ValueError, match="unsupported device"):
        ba.dense_terms(prob, prob.poses, prob.points.to("meta"), 0.0, grid)


# ---------------------------------------------------------------------------
# on the card: the kernels against their plain version
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(CASES))
def test_ba_dense_terms_match_plain_on_card(cuda_device, name):
    seed, C, stereo, huber = CASES[name]
    arrays, grid = grid_problem(seed, C=C, stereo=stereo)
    prob = to_torch(arrays, cuda_device)
    L = 128
    _, ploc = ba._local_point_table(prob, L, grid)
    d2 = residuals.CHI2_STEREO if huber else 0.0
    lam = torch.tensor(1e-3, device=cuda_device)
    before = ck.LAUNCHES["ba_dense_terms"]
    got = ba.dense_terms(prob, prob.poses, prob.points, d2, grid, lam=lam, ploc=ploc, n_local=L)
    cost = ba.dense_terms(prob, prob.poses, prob.points, d2, grid)
    assert ck.LAUNCHES["ba_dense_terms"] == before + 3
    ref = ba.dense_terms_plain(prob, prob.poses, prob.points, d2, grid, lam=lam, ploc=ploc,
                               n_local=L)
    p64 = in_float64(prob)
    exact = ba.dense_terms_plain(p64, p64.poses, p64.points, d2, grid, lam=lam.double(),
                                 ploc=ploc, n_local=L)
    diffs, ok = terms_agreement(got, ref, exact)
    assert ok, diffs
    assert abs(float(cost) - float(ref.cost)) <= 1e-5 * max(1.0, float(ref.cost))
    again = ba.dense_terms(prob, prob.poses, prob.points, d2, grid, lam=lam, ploc=ploc,
                           n_local=L)
    assert all(torch.equal(x, y) for x, y in zip(got, again))


@pytest.mark.cuda
def test_ba_solve_dense_kernel_route_on_card(cuda_device):
    arrays, grid = grid_problem(3, C=6)
    prob = to_torch(arrays, cuda_device)
    L = 128
    before = ck.LAUNCHES["ba_dense_terms"]
    kp, kc = ba.ba_solve_dense(prob, n_iters=6, n_local_pts=L, cam_grid=grid)
    assert ck.LAUNCHES["ba_dense_terms"] == before + 3 * 6 + 1
    pp, pc = ba.ba_solve_dense(prob, n_iters=6, n_local_pts=L, cam_grid=grid,
                               terms=ba.dense_terms_plain)
    assert float((kp.poses - pp.poses).abs().max()) <= 1e-4
    assert abs(float(kc) - float(pc)) <= 1e-3 * max(1.0, float(pc))
    before = ck.LAUNCHES["ba_dense_terms"]
    sk = lm._dense_schedule(prob, grid, 4, 6)
    assert ck.LAUNCHES["ba_dense_terms"] == before + 3 * 10 + 2
    sp = lm._dense_schedule(prob, grid, 4, 6, terms=ba.dense_terms_plain)
    assert float((sk[0].poses - sp[0].poses).abs().max()) <= 1e-4
    assert abs(float(sk[1]) - float(sp[1])) <= 1e-3 * max(1.0, float(sp[1]))
    assert float(sk[1]) < float(ba._cost_grid(prob, prob.poses, prob.points, 0.0, grid))
