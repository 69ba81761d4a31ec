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
- a CPU model of the kernels' decomposition (each local edge's 27 numbers
  summed per slot and per (camera, slot) in the order of the point-major
  edge index, the camera blocks from their upper triangle, the slot pass's
  damping and adjugate inverse and VH, the point side in float64) against
  ``dense_terms_plain``: the sums
  without cancellation (Hcc_d, V, the cost) within 1e-5 relative (max abs
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
launches per LM step (terms pass, slot pass, cost) and one per solve, a
second run bit for bit equal, V and VH laid out as the S product reads
them, the cost pass equal to the terms pass's cost, bare slots refused;
the solve and the 4 + 6 schedule through both routes (poses 1e-4, cost
1e-3 relative).
"""

import math
from fractions import Fraction

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


def grid_problem(seed, C=6, n=64, stereo=0.5, outliers=0.05, dup=4, see_all=False):
    """A cam-major [C, n] problem as numpy arrays (BAProblem's fields):
    C n / 4 points 3-12 units ahead, each seen by four neighbouring cameras
    (camera c the points c n / 4 .. c n / 4 + n, shuffled, around the
    ring), or with ``see_all`` n - ``dup`` points each seen by every camera,
    poses 0-1 unit apart along x, 0.5 px noise, ``stereo`` of the
    rows measuring u_r, ``outliers`` of them 25 px off, 5% of the rows not
    valid, camera 0 and 5% of the points fixed, and the last ``dup`` edges
    of each camera repeating earlier points of its row."""
    rng = np.random.RandomState(seed)
    K = np.array([500.0, 500.0, 320.0, 240.0])
    bf = 40.0
    P = n - dup if see_all else C * n // 4
    pts = rng.uniform([-4.0, -3.0, 3.0], [4.0, 3.0, 12.0], (P, 3))
    xi = rng.randn(C, 6) * [0.01, 0.01, 0.01, 0.1, 0.05, 0.1]
    xi[:, 3] += np.linspace(0.0, 1.0, C)
    poses = _se3_exp(xi)
    perm = rng.permutation(P)
    if see_all:
        pid = np.stack([np.concatenate([rng.permutation(P), np.zeros(dup, np.int64)])
                        for _ in range(C)])
    else:
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
    ids, index = ba._local_point_index(prob, L, grid)
    np.testing.assert_array_equal(N(index.ploc),
                                  np.asarray(jba._local_point_table(jprob, L, grid)[1]))
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


def terms_kernel_model(prob, poses, points, lam, d2, index, grid, L):
    """CPU model of the kernels' decomposition: per local edge the 27
    numbers (Hpp's upper 6 as 00 01 02 11 12 22, bp's 3, V's 18 row-major)
    summed per slot and per (camera, slot) in the order of the point-major
    edge index ``index`` (``ba.LocalEdges``), the camera blocks from Hcc's
    upper triangle, then the slot pass: the damped diagonal, the adjugate
    inverse, Hpi bp and VH, the point side in float64 throughout as the
    kernel forms it, and V in float32."""
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
    cw = Jc * wr
    v_rows = torch.stack([(cw[..., i] * Jp[..., j]).sum(2) for i in range(6) for j in range(3)],
                         -1).reshape(C * n, 18)
    upper = [(i, j) for i in range(6) for j in range(i, 6)]
    Hu = torch.stack([(cw[..., i] * Jc[..., j]).sum((1, 2)) for i, j in upper], -1)
    Hcc = torch.zeros(C, 6, 6)
    for k, (i, j) in enumerate(upper):
        h = Hu[:, k] + lam * Hu[:, k] + (1e-8 + prob.fixed_cam) if i == j else Hu[:, k]
        Hcc[:, i, j] = Hcc[:, j, i] = h
    bc = -(cw * e[..., None]).sum((1, 2))
    cost = torch.sum(torch.where(chi2 > d2, 2.0 * torch.sqrt(d2 * chi2) - d2, chi2) * ok
                     if d2 > 0 else chi2 * ok)
    # each edge's point side (V, Hpp, bp) in float64 from the float inputs
    p64 = in_float64(prob)
    e6, Jc6, Jp6, z6 = residuals.residual_and_jacobians(
        p64.poses[:, None, :], p64.K, p64.bf, p64.points[pid], p64.uvr.reshape(C, n, 3))
    s6, is6 = p64.is_stereo.reshape(C, n), p64.inv_sigma2.reshape(C, n)
    ok6 = p64.valid.reshape(C, n) * (z6 > 0.05).to(torch.float64)
    chi6 = (e6[..., 0] ** 2 + e6[..., 1] ** 2 + e6[..., 2] ** 2 * s6) * is6
    hw6 = residuals.huber_weight(chi6, d2) if d2 > 0 else torch.ones_like(chi6)
    w6 = ok6 * is6 * hw6
    wr6 = torch.stack([w6, w6, s6 * w6], -1)[..., None]
    Jc6 = Jc6 * (1.0 - p64.fixed_cam)[:, None, None, None]
    Jp6 = Jp6 * (1.0 - p64.fixed_pnt[pid])[..., None, None]
    cw6, pw6 = Jc6 * wr6, Jp6 * wr6
    rows6 = torch.cat([
        torch.stack([(pw6[..., i] * Jp6[..., j]).sum(2)
                     for i in range(3) for j in range(i, 3)], -1),
        -(pw6 * e6[..., None]).sum(2),
        torch.stack([(cw6[..., i] * Jp6[..., j]).sum(2) for i in range(6) for j in range(3)], -1),
    ], -1).reshape(C * n, 27)
    local = index.order[:int(index.offsets[L])]        # the local edges, slot by slot
    slot = index.ploc.reshape(-1)[local]
    # a slot's sums, its damped block's inverse, Hpi bp and V Hpi in float64
    h = torch.zeros(L, 9, dtype=torch.float64).index_add_(0, slot, rows6[local, :9])
    pair = (local // n) * L + slot
    V = torch.zeros(C * L, 18, dtype=torch.float64).index_add_(0, pair, rows6[local, 9:])
    V32 = torch.zeros(C * L, 18).index_add_(0, pair, v_rows[local]).reshape(C, L, 6, 3)
    trace = h[:, 0] + h[:, 3] + h[:, 5]
    add = torch.where(trace.abs() > 1e-12, 1e-8, 1.0)
    Hd = torch.stack([h[:, 0], h[:, 1], h[:, 2], h[:, 1], h[:, 3], h[:, 4],
                      h[:, 2], h[:, 4], h[:, 5]], -1).reshape(L, 3, 3)
    Hd = Hd + torch.diag_embed((lam.double() * Hd.diagonal(dim1=1, dim2=2)) + add[:, None])
    Hpi = ba._inv3x3(Hd)
    V = V.reshape(C, L, 6, 3)
    return ba.DenseTerms(Hcc, bc, cost, V32, Hpi.float(), h[:, 6:9].float(),
                         torch.einsum("ljk,lk->lj", Hpi, h[:, 6:9]).float(),
                         torch.einsum("clij,ljk->clik", V, Hpi).float())


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
    _, index = ba._local_point_index(prob, L, grid)
    ploc = index.ploc
    d2 = residuals.CHI2_STEREO if huber else 0.0
    for lam in (torch.tensor(1e-3), torch.tensor(1e-5)):
        ref = ba.dense_terms_plain(prob, prob.poses, prob.points, d2, grid, lam=lam, ploc=index,
                                   n_local=L)
        got = terms_kernel_model(prob, prob.poses, prob.points, lam, d2, index, grid, L)
        p64 = in_float64(prob)
        exact = ba.dense_terms_plain(p64, p64.poses, p64.points, d2, grid, lam=lam.double(),
                                     ploc=index, n_local=L)
        diffs, ok = terms_agreement(got, ref, exact)
        assert ok, diffs
    # the repeated edges' point blocks add up (a slot two edges of one camera share)
    dup = ploc[:, -1]
    assert bool((dup < L).any())
    assert float(ref.V[torch.arange(C), dup.clamp(max=L - 1)].abs().sum()) > 0


def test_the_caller_picks_the_terms_route():
    arrays, grid = grid_problem(2, C=4)
    prob = to_torch(arrays)
    ids, index = ba._local_point_index(prob, 128, grid)
    lam = torch.tensor(1e-4)
    a = ba._dense_schur_step(prob, prob.poses, prob.points, lam, 0.0, ids, index, grid)
    b = ba._dense_schur_step(prob, prob.poses, prob.points, lam, 0.0, ids, index, grid,
                             terms=ba.dense_terms_plain)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    sa = lm._dense_schedule(prob, grid, 2, 2)
    sb = lm._dense_schedule(prob, grid, 2, 2, terms=ba.dense_terms_plain)
    assert torch.equal(sa[0].poses, sb[0].poses) and torch.equal(sa[1], sb[1])
    with pytest.raises(ValueError, match="unsupported device"):
        ba.dense_terms(prob, prob.poses, prob.points.to("meta"), 0.0, grid)


# ---------------------------------------------------------------------------
# float32 rounding, modelled exactly in float64 (the card test below holds
# the plain version's ops to the rounding that the kernel copies)
# ---------------------------------------------------------------------------

def _two_sum(a, b):
    s = a + b
    bb = s - a
    return s, (a - (s - bb)) + (b - bb)


def _round32(hi, lo):
    """The float64 pair hi + lo (exact) rounded once to float32 (nearest,
    ties to even), as float64: where hi alone is a tie, lo breaks it."""
    r32 = hi.float()
    r = r32.double()
    up = torch.nextafter(r32, torch.full_like(r32, math.inf)).double()
    dn = torch.nextafter(r32, torch.full_like(r32, -math.inf)).double()
    out = torch.where((hi == (r + up) / 2) & (lo > 0), up, r)
    return torch.where((hi == (r + dn) / 2) & (lo < 0), dn, out)


def mul32(a, b):  # float32 a * b (the float64 product of two float32 values is exact)
    return (a * b).float().double()


def add32(a, b):
    return _round32(*_two_sum(a, b))


def fma32(a, b, c):  # float32 fused multiply-add: a * b + c rounded once
    return _round32(*_two_sum(a * b, c))


def _f32_of(fr):
    """A Fraction rounded to the nearest float32 (ties to even), as a float."""
    if fr == 0:
        return 0.0
    sign, fr = (-1.0 if fr < 0 else 1.0), abs(fr)
    e = fr.numerator.bit_length() - fr.denominator.bit_length()
    if Fraction(2) ** e > fr:
        e -= 1
    scaled = fr / Fraction(2) ** (e - 23)  # in [2^23, 2^24)
    q, rem = divmod(scaled.numerator, scaled.denominator)
    if 2 * rem > scaled.denominator or (2 * rem == scaled.denominator and q % 2):
        q += 1
    return sign * q * 2.0 ** (e - 23)


@pytest.mark.parametrize("op", ["mul", "add", "fma"])
def test_float32_rounding_model_is_exact(op):
    """The float64 model of float32 products, sums and fused multiply-adds
    against exact rational arithmetic, on random operands of mixed
    magnitudes and on ties that a float64 sum alone would round the wrong
    way (an exact a * b on a float32 midpoint, c far below it)."""
    rng = np.random.RandomState(11)
    n = 2000
    a, b, c = (np.float32(rng.randn(n) * 10.0 ** rng.randint(-6, 7, n)) for _ in range(3))
    t = 2.0 ** -12
    a[:4] = b[:4] = np.float32(1.0 + t)   # a b = 1 + 2^-11 + 2^-24: a float32 midpoint
    c[:4] = np.float32([2.0 ** -60, -(2.0 ** -60), 2.0 ** -40, -(2.0 ** -40)])
    A, B, Cc = (torch.as_tensor(x, dtype=torch.float64) for x in (a, b, c))
    a, b, c = ([Fraction(float(v)) for v in x] for x in (a, b, c))
    if op == "mul":
        got, want = mul32(A, B), [_f32_of(x * y) for x, y in zip(a, b)]
    elif op == "add":
        got, want = add32(A, Cc), [_f32_of(x + z) for x, z in zip(a, c)]
    else:
        got = fma32(A, B, Cc)
        want = [_f32_of(x * y + z) for x, y, z in zip(a, b, c)]
        # the ties: a float64 sum rounds them to the midpoint, the model does not
        naive = (A * B + Cc).float().double()
        assert not torch.equal(naive[:4], got[:4])
    assert torch.equal(got, torch.tensor(want, dtype=torch.float64))


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
    terms_on_card(to_torch(arrays, cuda_device), grid, huber)


@pytest.mark.cuda
def test_ba_dense_terms_long_segments_on_card(cuda_device):
    """Every point in each of 20 cameras: a slot's segment holds 20-21
    edges, and the first tile of slots more edges than the slot pass has
    threads."""
    arrays, grid = grid_problem(4, C=20, see_all=True)
    prob = to_torch(arrays, cuda_device)
    _, index = ba._local_point_index(prob, 128, grid)
    assert int(index.offsets[ba._SLOT_TILE]) > 256
    terms_on_card(prob, grid, True)


def terms_on_card(prob, grid, huber):
    """``dense_terms`` on the card against ``dense_terms_plain`` at L = 128:
    three launches, the cost pass equal to the terms pass's cost, V and VH
    views of the S product's matrix, bare slots refused, the bars of
    :func:`terms_agreement`, a second run bit for bit equal."""
    C = grid[0]
    cuda_device = prob.points.device
    L = 128
    _, ploc = ba._local_point_index(prob, L, grid)
    d2 = residuals.CHI2_STEREO if huber else 0.0
    lam = torch.tensor(1e-3, device=cuda_device)
    before = ck.LAUNCHES["ba_dense_terms"]
    got = ba.dense_terms(prob, prob.poses, prob.points, d2, grid, lam=lam, ploc=ploc, n_local=L)
    cost = ba.dense_terms(prob, prob.poses, prob.points, d2, grid)
    assert ck.LAUNCHES["ba_dense_terms"] == before + 3
    # the cost pass sums as the terms pass does; V and VH as the S product reads them
    assert torch.equal(cost, got.cost)
    for x in (got.V, got.VH):
        flat = x.permute(0, 2, 1, 3).reshape(6 * C, 3 * L)
        assert flat._base is not None and flat.data_ptr() == x.data_ptr()
    with pytest.raises(ValueError, match="point-major edge index"):
        ba.dense_terms(prob, prob.poses, prob.points, d2, grid, lam=lam, ploc=ploc.ploc,
                       n_local=L)
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


@pytest.mark.cuda
def test_plain_route_rounds_as_the_kernel_models(cuda_device):
    """The ops of the plain version that decide V's float32 rounding, on the
    card at the mono window's shapes (C = 49 poses, N = 1,024 points each),
    bit for bit against the rounding that ``csrc/ba_dense_terms.cu`` copies
    to hold V within 1e-5 of them: torch.linalg.cross as one fused
    multiply-add a_i b_j - a_j b_i, the 3-term torch.sum outer pair first,
    the product -dpred @ R as fused multiply-adds in k order, -dpred @
    [-hat(pc) | I] as separate products and a sum, and the einsum of V as
    fused multiply-adds in row order. A change here (a torch or cuBLAS
    update) can fail chip_smoke.py's V bar with no change in the port; each
    check also shows that the other rounding differs on these inputs."""
    from orbslam2_with_quadrics_tpu_torch.ops import lie

    rng = np.random.RandomState(12)
    C, n = 49, 1024
    q = rng.randn(C, 4)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    T = np.concatenate([q, rng.randn(C, 3)], 1)[:, None, :]
    p = rng.uniform([-4.0, -3.0, 3.0], [4.0, 3.0, 12.0], (C, n, 3))
    K = np.array([520.0, 518.0, 320.0, 240.0])
    wr = rng.uniform(0.1, 2.0, (C, n, 3, 1))
    card = {k: torch.as_tensor(v, dtype=torch.float32, device=cuda_device)
            for k, v in dict(T=T, p=p, K=K, wr=wr, obs=np.zeros((C, n, 3))).items()}
    f64 = {k: v.cpu().double() for k, v in card.items()}
    ver = f"torch {torch.__version__}, CUDA {torch.version.cuda}"

    def same(got, model, alt, what):
        got = got.cpu().double()
        assert not torch.equal(model, alt), f"{what}: these inputs do not tell the two apart"
        assert torch.equal(got, model), (
            f"{what} rounds otherwise under {ver} ({int((got != model).sum())} of "
            f"{got.numel()} values): ba_dense_terms' float32 V copies this rounding, and "
            f"chip_smoke.py's 1e-5 V bar may fail with no change in the port")

    def cross(a, b, fused=True):
        out = []
        for i, j, k in ((0, 1, 2), (1, 2, 0), (2, 0, 1)):
            neg = -mul32(a[..., k], b[..., j])
            out.append(fma32(a[..., j], b[..., k], neg) if fused
                       else add32(mul32(a[..., j], b[..., k]), neg))
        return torch.stack(out, -1)

    # lie.quat_rotate: t = 2 u x v; v + w t + u x t (+ the translation)
    Tq, v = f64["T"][..., :4], f64["p"]
    w, u = Tq[..., :1].expand(v.shape[:-1] + (1,)), Tq[..., 1:].expand(v.shape)
    ub = card["T"][..., 1:4].expand(card["p"].shape)
    same(torch.linalg.cross(ub, card["p"], dim=-1), cross(u, v), cross(u, v, False),
         "torch.linalg.cross")
    t = 2.0 * cross(u, v)
    pc = add32(add32(add32(v, mul32(w, t)), cross(u, t)), f64["T"][..., 4:].expand(v.shape))
    pc_card = lie.se3_apply(card["T"], card["p"])
    assert torch.equal(pc_card.cpu().double(), pc), f"lie.se3_apply rounds otherwise ({ver})"

    # lie.quat_to_matrix: u.u by torch.sum of three, the outer pair first
    x, y, z, ww = Tq[..., 1], Tq[..., 2], Tq[..., 3], Tq[..., 0]
    xx, yy, zz = mul32(x, x), mul32(y, y), mul32(z, z)
    un = add32(add32(xx, zz), yy)
    u_card = card["T"][..., 1:4]
    same(torch.sum(u_card * u_card, dim=-1), un, add32(add32(xx, yy), zz),
         "torch.sum of three")
    R = torch.stack([
        add32(1.0, 2.0 * add32(xx, -un)), add32(mul32(2.0 * ww, -z), 2.0 * mul32(x, y)),
        add32(mul32(2.0 * ww, y), 2.0 * mul32(x, z)), add32(mul32(2.0 * ww, z), 2.0 * mul32(y, x)),
        add32(1.0, 2.0 * add32(yy, -un)), add32(mul32(2.0 * ww, -x), 2.0 * mul32(y, z)),
        add32(mul32(2.0 * ww, -y), 2.0 * mul32(z, x)), add32(mul32(2.0 * ww, x), 2.0 * mul32(z, y)),
        add32(1.0, 2.0 * add32(zz, -un))], -1).reshape(C, 1, 3, 3)
    R_card = lie.quat_to_matrix(card["T"][..., :4])
    assert torch.equal(R_card.cpu().double(), R), f"lie.quat_to_matrix rounds otherwise ({ver})"

    # residuals.residual_and_jacobians: Jp = -dpred @ R, Jc = -dpred @ [-hat(pc) | I]
    _, Jc_card, Jp_card, _ = residuals.residual_and_jacobians(
        card["T"], card["K"], 40.0, card["p"], card["obs"])
    X, Y, Z = pc_card[..., 0], pc_card[..., 1], pc_card[..., 2]
    iz = 1.0 / torch.where(torch.abs(Z) < 1e-6, 1e-6, Z)
    a = (-residuals._dpred_dpc(X, Y, iz, card["K"], 40.0)).cpu().double()  # -dpred
    Rb = R.expand(C, n, 3, 3)
    Jp = torch.stack(
        [fma32(a[..., r, 2:3], Rb[..., 2, :], fma32(a[..., r, 1:2], Rb[..., 1, :],
                                                    mul32(a[..., r, 0:1], Rb[..., 0, :])))
         for r in range(3)], -2)
    Jp_alt = torch.stack(
        [add32(add32(mul32(a[..., r, 0:1], Rb[..., 0, :]), mul32(a[..., r, 1:2], Rb[..., 1, :])),
               mul32(a[..., r, 2:3], Rb[..., 2, :])) for r in range(3)], -2)
    same(Jp_card, Jp, Jp_alt, "-dpred @ R (torch.matmul, [C, N, 3, 3] @ [C, 1, 3, 3])")
    P = pc_card.cpu().double()
    Xd, Yd, Zd = P[..., 0:1], P[..., 1:2], P[..., 2:3]
    a0, a1, a2 = a[..., 0], a[..., 1], a[..., 2]
    # -hat(pc)'s columns (0, -z, y), (z, 0, -x), (-y, x, 0): two terms an entry
    pairs = [((a1, -Zd), (a2, Yd)), ((a0, Zd), (a2, -Xd)), ((a0, -Yd), (a1, Xd))]
    Jc = torch.stack([add32(mul32(*f), mul32(*g)) for f, g in pairs] + [a0, a1, a2], -1)
    Jc_alt = torch.stack([fma32(*g, mul32(*f)) for f, g in pairs] + [a0, a1, a2], -1)
    same(Jc_card, Jc, Jc_alt, "-dpred @ [-hat(pc) | I] (torch.matmul, [C, N, 3, 3] @ "
                              "[C, N, 3, 6])")

    # dense_terms_plain's V: einsum("cnri,cnrj->cnij", Jc W, Jp)
    JcW_card = Jc_card * card["wr"]
    V_card = torch.einsum("cnri,cnrj->cnij", JcW_card, Jp_card)
    cw, jp = JcW_card.cpu().double(), Jp_card.cpu().double()
    V = fma32(cw[..., 2, :, None], jp[..., 2, None, :], fma32(
        cw[..., 1, :, None], jp[..., 1, None, :], mul32(cw[..., 0, :, None], jp[..., 0, None, :])))
    V_alt = add32(add32(mul32(cw[..., 0, :, None], jp[..., 0, None, :]),
                        mul32(cw[..., 1, :, None], jp[..., 1, None, :])),
                  mul32(cw[..., 2, :, None], jp[..., 2, None, :]))
    same(V_card, V, V_alt, 'torch.einsum("cnri,cnrj->cnij") of V')
