"""The PCG solver's Schur edge sweeps (``ops/ba.sweep_cam_to_point``,
``sweep_point_to_cam``; kernels ``csrc/ba_schur_sweep.cu``).

On the CPU, in float64, on problems whose coupling blocks come from
``ba._build_system`` (so a dead row's block is the solver's own exact 0):
the plain sweeps, ``_schur_matvec`` built from them, ``_schur_rhs`` and the
back-substitution against a dense S = Hcc_d - W Hpp^-1 W^T assembled from
the same blocks, to 1e-9; on a camera-major table with dead rows, a
shuffled camera order, fixed cameras and points, and a point that no live
row touches.

On the card (``cuda`` marker, no JAX: ``python -m pytest -o addopts=""
tests/test_torch_schur_sweep.py -m cuda``): the kernels against a float64
evaluation of the same float32 inputs, within 1e-5 of the sum of the
terms' magnitudes (float32 sums of up to a few hundred terms, in an atomic
order that changes from run to run), where the plain version on the card
is held to the same bar; warps that straddle two and more cameras; dead
rows whose blocks are NaN (never read); the init folded in or not; the
launches per ``ba_solve``; what the kernels do not take raises.
"""

import numpy as np
import pytest
import torch

from orbslam2_with_quadrics_tpu_torch.ops import ba, lie
from orbslam2_with_quadrics_tpu_torch.ops import cuda_kernels as ck

# name: (seed, cameras, rows a camera, points, row order, fixed cameras and points)
CASES = {
    "camera-major, dead rows": (0, 6, 40, 50, "camera", False),
    "shuffled cameras": (1, 5, 37, 40, "shuffled", False),
    "fixed cameras and points": (2, 6, 33, 45, "camera", True),
}
# and on the card, tables whose warps straddle cameras
CARD_CASES = dict(CASES, **{
    "two cameras a warp (N = 45)": (3, 8, 45, 300, "camera", False),
    "many cameras a warp (N = 7)": (4, 40, 7, 120, "camera", False),
    "ragged tail (N = 33, O % 32 = 7)": (5, 7, 33, 90, "camera", True),
})


def problem(name, dtype=torch.float64, device="cpu"):
    """A BAProblem over a [C, N] table in the case's row order: about a
    third of the rows dead, the last point observed only by dead rows."""
    seed, C, N, P, order, fixed = CARD_CASES[name]
    rng = np.random.default_rng(seed)
    xi = 0.02 * rng.standard_normal((C, 6))
    xi[:, 3:] += np.stack([0.3 * np.arange(C), np.zeros(C), np.zeros(C)], 1)
    pts = np.stack([rng.uniform(-2, 3, P), rng.uniform(-1.5, 1.5, P), rng.uniform(4, 9, P)], 1)
    cam = np.repeat(np.arange(C), N)
    pnt = rng.integers(0, P - 1, C * N)
    valid = (rng.random(C * N) > 0.35).astype(np.float64)
    dead = np.flatnonzero(valid == 0)
    pnt[dead[: len(dead) // 3]] = P - 1  # only dead rows see the last point
    if order == "shuffled":
        perm = rng.permutation(C * N)
        cam, pnt, valid = cam[perm], pnt[perm], valid[perm]
    fixed_cam = np.zeros(C)
    fixed_cam[0] = 1.0
    fixed_pnt = np.zeros(P)
    if fixed:
        fixed_cam[2] = 1.0
        fixed_pnt[rng.choice(P - 1, 5, replace=False)] = 1.0
    t = lambda a, dt=dtype: torch.as_tensor(a, dtype=dt, device=device)  # noqa: E731
    poses = lie.se3_exp(t(xi, torch.float64)).to(dtype)
    K = np.array([500.0, 500.0, 320.0, 240.0])
    R_t = lie.se3_apply(lie.se3_exp(t(xi, torch.float64))[cam], t(pts[pnt], torch.float64))
    uv = R_t[:, :2] / R_t[:, 2:] * 500.0 + torch.tensor([320.0, 240.0], dtype=torch.float64,
                                                         device=device)
    ur = uv[:, :1] - 40.0 / R_t[:, 2:]
    uvr = torch.cat([uv, ur], 1) + t(rng.normal(0, 1.0, (C * N, 3)), torch.float64)
    return ba.BAProblem(
        poses=poses, points=t(pts), K=t(K), bf=t(40.0), cam_idx=t(cam, torch.int64),
        pnt_idx=t(pnt, torch.int64), uvr=uvr.to(dtype), is_stereo=t(rng.random(C * N) > 0.5),
        inv_sigma2=t(rng.uniform(0.5, 1.5, C * N)), valid=t(valid), fixed_cam=t(fixed_cam),
        fixed_pnt=t(fixed_pnt))


def step_blocks(prob):
    """(Hcc_d, bc, bp, the Coupling) of one LM step at lam = 1e-3."""
    lam = torch.tensor(1e-3, dtype=prob.poses.dtype, device=prob.poses.device)
    Hcc_d, bc, Hpp_inv, bp, Wcp, _ = ba._build_system(prob, 5.991, lam)
    return Hcc_d, bc, bp, ba.coupling(prob, Wcp, Hpp_inv)


def dense(prob, Hcc_d, cp):
    """(W [6C, 3P], Hpp^-1 [3P, 3P], S [6C, 6C]) in float64, from the blocks."""
    C, P = prob.poses.shape[0], prob.points.shape[0]
    W = torch.zeros(C, 6, P, 3, dtype=torch.float64)
    for o in range(cp.Wcp.shape[0]):
        W[cp.cam_idx[o], :, cp.pnt_idx[o]] += cp.Wcp[o].double().cpu()
    W = W.reshape(6 * C, 3 * P)
    Hinv = torch.block_diag(*cp.Hpp_inv.double().cpu())
    S = torch.block_diag(*Hcc_d.double().cpu()) - W @ Hinv @ W.T
    return W, Hinv, S


def close(a, b, tol=1e-9):
    a, b = a.double().cpu().reshape(-1), b.double().cpu().reshape(-1)
    assert a.shape == b.shape
    scale = max([1.0] + b.abs().tolist())
    err = max([0.0] + (a - b).abs().tolist())
    assert err <= tol * scale, (err, scale)


@pytest.mark.parametrize("name", sorted(CASES))
def test_plain_sweeps_against_dense_schur(name):
    prob = problem(name)
    C, P = prob.poses.shape[0], prob.points.shape[0]
    Hcc_d, bc, bp, cp = step_blocks(prob)
    W, Hinv, S = dense(prob, Hcc_d, cp)
    g = torch.Generator().manual_seed(7)
    x = torch.randn(C, 6, generator=g, dtype=torch.float64)
    s = torch.randn(P, 3, generator=g, dtype=torch.float64)
    close(ba.sweep_cam_to_point_plain(cp, x), (W.T @ x.reshape(-1)).reshape(P, 3))
    close(ba.sweep_cam_to_point(cp, x), (W.T @ x.reshape(-1)).reshape(P, 3))
    close(ba.sweep_point_to_cam_plain(cp, s), (W @ Hinv @ s.reshape(-1)).reshape(C, 6))
    close(ba._schur_matvec(x, cp, Hcc_d), (S @ x.reshape(-1)).reshape(C, 6))
    # with a base, and without
    close(ba.sweep_point_to_cam(cp, s, base=x), x - (W @ Hinv @ s.reshape(-1)).reshape(C, 6))
    close(ba.sweep_point_to_cam(cp, s), -(W @ Hinv @ s.reshape(-1)).reshape(C, 6))


@pytest.mark.parametrize("name", sorted(CASES))
def test_rhs_and_back_substitution_identities(name):
    prob = problem(name)
    C, P = prob.poses.shape[0], prob.points.shape[0]
    Hcc_d, bc, bp, cp = step_blocks(prob)
    W, Hinv, S = dense(prob, Hcc_d, cp)
    g = ba._schur_rhs(cp, bp, bc)
    close(g, bc - (W @ Hinv @ bp.reshape(-1)).reshape(C, 6))
    # the reduced system solved densely, then the points back-substituted:
    # together they solve [[Hcc_d, W], [W^T, Hpp_d]] [dc; dp] = [bc; bp]
    free = (prob.fixed_cam == 0).repeat_interleave(6)
    dc = torch.zeros(6 * C, dtype=torch.float64)
    dc[free] = torch.linalg.solve(S[free][:, free], g.reshape(-1)[free])
    dp = ba._back_substitute(cp, bp, dc.reshape(C, 6), prob.fixed_pnt)
    Hpp = torch.linalg.inv(Hinv)
    free_p = (prob.fixed_pnt == 0).repeat_interleave(3)
    close(dp.reshape(-1)[~free_p], torch.zeros(int((~free_p).sum()), dtype=torch.float64))
    Hcc = torch.block_diag(*Hcc_d)
    close((W.T @ dc + Hpp @ dp.reshape(-1))[free_p], bp.reshape(-1)[free_p], 1e-8)
    close((Hcc @ dc + W @ dp.reshape(-1))[free], bc.reshape(-1)[free], 1e-8)


@pytest.mark.parametrize("name", sorted(CASES))
def test_dead_rows_and_unseen_point(name):
    prob = problem(name)
    P = prob.points.shape[0]
    Hcc_d, bc, bp, cp = step_blocks(prob)
    # a dead row's block is exactly 0 (what lets the kernels skip it), as is
    # a fixed camera's or point's
    dead = (prob.valid == 0) | (prob.fixed_cam[prob.cam_idx] > 0) | (
        prob.fixed_pnt[prob.pnt_idx] > 0)
    assert bool(torch.all(cp.Wcp[dead] == 0)) and bool(torch.any(cp.Wcp[~dead] != 0))
    assert bool(torch.any((prob.pnt_idx == P - 1) & (prob.valid == 0)))
    assert not bool(torch.any((prob.pnt_idx == P - 1) & (prob.valid > 0)))
    x = torch.randn(prob.poses.shape[0], 6, dtype=torch.float64)
    assert bool(torch.all(ba.sweep_cam_to_point(cp, x)[P - 1] == 0))
    dp = ba._back_substitute(cp, bp, x, prob.fixed_pnt)
    assert bool(torch.all(dp[P - 1] == 0))


def test_solve_is_unchanged_by_the_sweeps_on_the_cpu():
    """``ba_solve`` on the CPU is the plain sweeps' arithmetic: one LM step
    equals the step written out with einsum and index_add."""
    prob = problem("camera-major, dead rows", dtype=torch.float32)
    lam = torch.tensor(1e-4)
    Hcc_d, bc, Hpp_inv, bp, Wcp, _ = ba._build_system(prob, 5.991, lam)
    cp = ba.coupling(prob, Wcp, Hpp_inv)
    C, P = prob.poses.shape[0], prob.points.shape[0]
    x = torch.randn(C, 6)
    t1 = torch.einsum("oij,oi->oj", Wcp, x[prob.cam_idx])
    y = torch.einsum("pij,pj->pi", Hpp_inv, ba._seg(t1, prob.pnt_idx, P))
    t2 = torch.einsum("oij,oj->oi", Wcp, y[prob.pnt_idx])
    want = torch.einsum("cij,cj->ci", Hcc_d, x) - ba._seg(t2, prob.cam_idx, C)
    assert torch.equal(ba._schur_matvec(x, cp, Hcc_d), want)


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the sweep kernels have no CPU mode")
    return torch.device("cuda")


def on_cpu(cp, absolute=False):
    """The Coupling's blocks in float64 on the CPU (their magnitudes with
    ``absolute``), for the plain versions."""
    f = (lambda t: t.detach().cpu().double().abs()) if absolute else (
        lambda t: t.detach().cpu().double())
    return cp._replace(Wcp=f(cp.Wcp), Hpp_inv=f(cp.Hpp_inv), cam_idx=cp.cam_idx.cpu(),
                       pnt_idx=cp.pnt_idx.cpu(), valid=cp.valid.cpu(), args=None)


def within_rounding(got, want, mag):
    """``got`` (float32 on the card) within 1e-5 of the terms' magnitudes
    ``mag`` from ``want`` (float64): float32 sums of up to a few hundred
    terms, in an order that the atomics change from run to run."""
    assert bool(torch.all(torch.isfinite(got))), "non-finite output"
    err = (got.detach().cpu().double() - want).abs()
    assert bool(torch.all(err <= 1e-5 * mag + 1e-30)), float((err / (mag + 1e-30)).max())


def to_points(cp, x):
    """(float64 W^T x, its terms' magnitudes)."""
    x = x.detach().cpu().double()
    return (ba.sweep_cam_to_point_plain(on_cpu(cp), x),
            ba.sweep_cam_to_point_plain(on_cpu(cp, True), x.abs()))


def to_cams(cp, s):
    """(float64 W Hpp^-1 s, its terms' magnitudes)."""
    s = s.detach().cpu().double()
    return (ba.sweep_point_to_cam_plain(on_cpu(cp), s),
            ba.sweep_point_to_cam_plain(on_cpu(cp, True), s.abs()))


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(CARD_CASES))
def test_kernels_match_plain_on_card(cuda_device, name):
    prob = problem(name, torch.float32, cuda_device)
    C, P = prob.poses.shape[0], prob.points.shape[0]
    Hcc_d, bc, bp, cp = step_blocks(prob)
    assert cp.args is not None
    g = torch.Generator(device=cuda_device).manual_seed(3)
    x = torch.randn(C, 6, generator=g, device=cuda_device)
    s = torch.randn(P, 3, generator=g, device=cuda_device)
    # the plain versions on the card meet the same bar
    plain = cp._replace(args=None)
    within_rounding(ba.sweep_cam_to_point_plain(plain, x), *to_points(cp, x))
    within_rounding(ba.sweep_point_to_cam_plain(plain, s), *to_cams(cp, s))
    within_rounding(ba.sweep_cam_to_point(cp, x), *to_points(cp, x))
    ref, mag = to_cams(cp, s)
    within_rounding(ba.sweep_point_to_cam(cp, s), -ref, mag)
    # s as the camera -> point sweep hands it on: a [P, 3] view of rows of 4
    s4 = ba.sweep_cam_to_point(cp, x)
    assert s4.stride() == (4, 1)
    within_rounding(ba.sweep_point_to_cam(cp, s4), *(lambda r, m: (-r, m))(*to_cams(cp, s4)))
    # the init folded in: base, and Hcc_d x in S x
    b64 = bc.detach().cpu().double()
    within_rounding(ba.sweep_point_to_cam(cp, s, base=bc), b64 - ref, mag + b64.abs())
    H64, x64 = Hcc_d.detach().cpu().double(), x.detach().cpu().double()
    s64, s_mag = to_points(cp, x)
    want = torch.einsum("cij,cj->ci", H64, x64) - ba.sweep_point_to_cam_plain(on_cpu(cp), s64)
    mag = torch.einsum("cij,cj->ci", H64.abs(), x64.abs()) + ba.sweep_point_to_cam_plain(
        on_cpu(cp, True), s_mag)
    within_rounding(ba._schur_matvec(x, cp, Hcc_d), want, mag)


@pytest.mark.cuda
def test_dead_rows_are_not_read_on_card(cuda_device):
    prob = problem("camera-major, dead rows", torch.float32, cuda_device)
    Hcc_d, bc, bp, cp = step_blocks(prob)
    dead = prob.valid == 0
    nan_cp = ba.coupling(prob, cp.Wcp.masked_fill(dead[:, None, None], float("nan")),
                         cp.Hpp_inv)
    x = torch.randn(prob.poses.shape[0], 6, device=cuda_device)
    s = ba.sweep_cam_to_point(nan_cp, x)
    within_rounding(s, *to_points(cp, x))
    ref, mag = to_cams(cp, s)
    within_rounding(ba.sweep_point_to_cam(nan_cp, s), -ref, mag)


@pytest.mark.cuda
@pytest.mark.parametrize("steps,cg_iters", [(1, 3), (3, 5)])
def test_launches_per_ba_solve_on_card(cuda_device, steps, cg_iters):
    prob = problem("camera-major, dead rows", torch.float32, cuda_device)
    before = dict(ck.LAUNCHES)
    _, cost = ba.ba_solve(prob, n_iters=steps, cg_iters=cg_iters)
    assert bool(torch.isfinite(cost))
    assert ck.LAUNCHES["ba_schur_sweep"] - before["ba_schur_sweep"] == steps * (2 * cg_iters + 2)
    assert all(ck.LAUNCHES[k] == before[k] for k in ck.LAUNCHES if k != "ba_schur_sweep")
    ref_cost = ba.ba_solve(problem("camera-major, dead rows", torch.float32), n_iters=steps,
                           cg_iters=cg_iters)[1]
    assert abs(float(cost) - float(ref_cost)) <= 1e-3 * max(1.0, float(ref_cost))


@pytest.mark.cuda
@pytest.mark.parametrize("what", ["float64 blocks", "int32 indices", "strided blocks",
                                  "x of the wrong width", "s on the CPU"])
def test_kernels_raise_on_what_they_do_not_take(cuda_device, what):
    prob = problem("camera-major, dead rows", torch.float32, cuda_device)
    Hcc_d, bc, bp, cp = step_blocks(prob)
    C, P = prob.poses.shape[0], prob.points.shape[0]
    x, s = torch.zeros(C, 6, device=cuda_device), torch.zeros(P, 3, device=cuda_device)
    with pytest.raises(ValueError):
        if what == "float64 blocks":
            ba.coupling(prob, cp.Wcp.double(), cp.Hpp_inv)
        elif what == "int32 indices":
            ba.coupling(prob._replace(pnt_idx=prob.pnt_idx.int()), cp.Wcp, cp.Hpp_inv)
        elif what == "strided blocks":
            ba.coupling(prob, cp.Wcp.transpose(1, 2).contiguous().transpose(1, 2), cp.Hpp_inv)
        elif what == "x of the wrong width":
            ba.sweep_cam_to_point(cp, torch.zeros(C, 7, device=cuda_device))
        else:
            ba.sweep_point_to_cam(cp, s.cpu())
    assert ba.sweep_cam_to_point(cp, x).shape == (P, 3)  # the same call, taken
