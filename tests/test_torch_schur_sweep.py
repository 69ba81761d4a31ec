"""The PCG solver's Schur edge sweeps (``ops/ba.sweep_cam_to_point``,
``sweep_point_to_cam``; kernels ``csrc/ba_schur_sweep.cu``).

On the CPU, in float64, on problems whose coupling blocks come from
``ba._build_system`` (so a dead row's block is the solver's own exact 0):
the plain sweeps, ``_schur_matvec`` built from them, ``_schur_rhs`` and the
back-substitution against a dense S = Hcc_d - W Hpp^-1 W^T assembled from
the same blocks, to 1e-9; on a camera-major table with dead rows, a
shuffled camera order, fixed cameras and points, and a point that no live
row touches. The PCG as one CUDA graph a solve (``ba.GraphedPCG``): its
buffers' eager body against ``_pcg``, the route each caller takes, and
whole solves by each route with a stand-in for the card and the capture.

On the card (``cuda`` marker, no JAX: ``python -m pytest -o addopts=""
tests/test_torch_schur_sweep.py -m cuda``): the kernels against a float64
evaluation of the same float32 inputs, within 1e-5 of the sum of the
terms' magnitudes (float32 sums of up to a few hundred terms, in an atomic
order that changes from run to run), where the plain version on the card
is held to the same bar; warps that straddle two and more cameras; dead
rows whose blocks are NaN (never read); the init folded in or not; the
launches per ``ba_solve``; what the kernels do not take raises; the
graphed PCG against eager, freed with its solve.
"""

import functools
import types

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
# the PCG as one CUDA graph a solve (ba.GraphedPCG): the body it captures,
# run eagerly over its buffers, and the route each caller takes
# ---------------------------------------------------------------------------

def eager_dc(cp, Hcc_d, g, iters):
    return ba._pcg(g, lambda x: ba._schur_matvec(x, cp, Hcc_d), torch.linalg.inv_ex(Hcc_d)[0],
                   iters)


@pytest.mark.parametrize("name", sorted(CASES))
def test_graphed_pcg_buffers_give_the_eager_dc(name):
    """The buffers filled from a step, then refilled from another step
    (moved poses and points, another damping), give eager ``_pcg``'s dc of
    each step bit for bit: no input is left stale."""
    prob = problem(name, torch.float32)
    pcg = ba.GraphedPCG(25)
    for lam, shift in ((1e-3, 0.0), (4e-2, 0.05)):
        p = prob._replace(points=prob.points + shift, poses=lie.se3_retract(
            prob.poses, torch.full_like(prob.poses[:, :6], shift)))
        Hcc_d, bc, Hpp_inv, bp, Wcp, _ = ba._build_system(p, 5.991, torch.tensor(lam))
        cp = ba.coupling(p, Wcp, Hpp_inv)
        g = ba._schur_rhs(cp, bp, bc)
        pcg.load(cp, Hcc_d, g)
        assert torch.equal(pcg.body(), eager_dc(cp, Hcc_d, g, 25))
        assert not any(t is u for t, u in ((pcg.g, g), (pcg.H, Hcc_d), (pcg.cp.Wcp, Wcp)))
    pcg.close()
    assert pcg.cp is None and pcg.g is None and pcg.x is None


def quadric_problem(base):
    """``base`` with one ellipsoid in front of its cameras, a box in each
    camera (its projection, 2 px off) and the landmark moved off."""
    from orbslam2_with_quadrics_tpu_torch.ops import quadrics

    C = base.poses.shape[0]
    q = quadrics.Quadric(torch.tensor([1.0, 0.0, 0.0, 0.0, 0.75, 0.0, 6.0]),
                         torch.tensor([0.3, 0.2, 0.25]))
    boxes, ok = quadrics.project_bbox(quadrics.Quadric(q.pose.expand(C, 7), q.scale.expand(C, 3)),
                                      base.poses, base.K)
    assert bool(ok.all())
    return quadrics.QuadricBAProblem(
        base=base, quad_pose=(q.pose + torch.tensor([0, 0, 0, 0, 0.05, -0.03, 0.1]))[None],
        quad_scale=q.scale[None] * 1.1, qe_cam=torch.arange(C),
        qe_quad=torch.zeros(C, dtype=torch.int64), qe_bbox=boxes + 2.0, qe_valid=torch.ones(C),
        qe_w=torch.full((C,), 1e-2))


def on_card(prob):
    """``prob`` as :func:`ba.pcg_route` sees a problem on the card: its poses'
    device says cuda (the route reads nothing else of it)."""
    return prob._replace(poses=types.SimpleNamespace(device=torch.device("cuda", 0)))


@pytest.fixture
def pcg_graph_stand_in(monkeypatch):
    """The card's route of ``ba_solve`` off the card: ``ba.pcg_route``
    answers as for a problem on the card (a ``group`` still decides), and
    the CUDA graph of ``GraphedPCG._capture`` is a stand-in whose "replay"
    runs the body the graph would hold, eagerly over the solve's buffers,
    into the one output tensor, as a graph writes its output in place.
    Returns the stand-ins made, one a capture, each with its ``pcg`` and
    ``replays``."""
    made = []

    class Replay:
        def __init__(self, pcg):
            self.pcg, self.replays = pcg, 0
            pcg.x = torch.empty_like(pcg.g)

        def replay(self):
            self.pcg.x.copy_(self.pcg.body())
            self.replays += 1

        def reset(self):
            pass

    def capture(pcg):
        made.append(Replay(pcg))
        return made[-1]

    route = ba.pcg_route
    monkeypatch.setattr(ba, "pcg_route",
                        lambda prob, cg_iters, group=None: route(on_card(prob), cg_iters, group))
    monkeypatch.setattr(ba.GraphedPCG, "_capture", capture)
    return made


@pytest.mark.parametrize("device,group", [("cpu", None), ("cuda", None), ("cuda", "a group"),
                                          ("cpu", "a group")])
def test_pcg_route(device, group):
    """A ``ba_solve`` call's PCG is a graph only for a problem on the card
    without a ``group``; CPU tensors and a group (whose all_reduce a graph
    cannot hold) take the eager ``_pcg``. The device is stubbed: the route
    makes the graph's object, and nothing of it runs until the first step."""
    prob = problem("fixed cameras and points", torch.float32)
    if device == "cuda":
        prob = on_card(prob)
    got = ba.pcg_route(prob, 12, group)
    if device == "cuda" and group is None:
        assert isinstance(got, ba.GraphedPCG) and got.iters == 12 and got.graph is None
    else:
        assert got is None


@pytest.mark.parametrize("route", ["cpu", "card", "card with a group",
                                   "quadric_ba_solve on the card"])
def test_solve_takes_its_pcg_route(route, monkeypatch, request):
    """Whole solves by each route (on the card with the graph's eager
    stand-in): on the card without a group one capture a ``ba_solve`` call,
    a replay a step, freed when the call returns, 2 cg_iters sweep launches
    counted a replay, the ``ba.pcg`` spans' ``graphed`` 1, and the solve
    bit-equal to the eager one. CPU tensors, a ``group`` (a world of one:
    its sums leave a tensor as it is) and ``quadric_ba_solve``'s own CG loop
    take the eager PCG."""
    from orbslam2_with_quadrics_tpu_torch.ops import quadrics
    from orbslam2_with_quadrics_tpu_torch.utils import tracing

    prob = problem("fixed cameras and points", torch.float32)
    steps, iters = 3, 12
    if route.startswith("quadric"):
        qprob = quadric_problem(prob)
        solve = lambda: quadrics.quadric_ba_solve(  # noqa: E731
            qprob, prob.K, n_iters=steps, cg_iters=iters)
    else:
        solve = functools.partial(ba.ba_solve, prob, n_iters=steps, cg_iters=iters)
    want = solve()                                   # eager, on the CPU
    if route.endswith("group"):
        monkeypatch.setattr(ba.dist, "all_reduce", lambda t, op=None, group=None: None)
        solve = functools.partial(solve, group=object())
    made = [] if route == "cpu" else request.getfixturevalue("pcg_graph_stand_in")
    before = ck.LAUNCHES["ba_schur_sweep"]
    with tracing.collect() as spans:
        got = solve()
    graphed = [s["counts"]["graphed"] for s in spans if s["name"] == "ba.pcg"]
    assert all(torch.equal(a, b) for a, b in zip(torch.utils._pytree.tree_leaves(got),
                                                 torch.utils._pytree.tree_leaves(want)))
    if route == "card":
        assert [(r.replays, r.pcg.graph, r.pcg.g) for r in made] == [(steps, None, None)]
        assert ck.LAUNCHES["ba_schur_sweep"] - before == steps * 2 * iters
        assert graphed == [1] * steps
    else:
        assert made == [] and ck.LAUNCHES["ba_schur_sweep"] == before
        assert graphed == ([] if route.startswith("quadric") else [0] * steps)


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


@pytest.mark.cuda
def test_graphed_pcg_on_card(cuda_device):
    """On the card: the solve's graph, captured at its first step and
    replayed at a second step's inputs, gives each step's eager ``_pcg`` dc
    within 1e-4 of its magnitude (the sweeps' atomics reorder float32 sums);
    a ``ba_solve`` call's graph and buffers are freed when it returns (the
    allocated memory back where it was) and its sweeps counted as launched."""
    prob = problem("two cameras a warp (N = 45)", torch.float32, cuda_device)
    pcg = ba.GraphedPCG(30)
    for lam, shift in ((1e-3, 0.0), (4e-2, 0.05)):
        p = prob._replace(points=prob.points + shift, poses=lie.se3_retract(
            prob.poses, torch.full_like(prob.poses[:, :6], shift)))
        Hcc_d, bc, Hpp_inv, bp, Wcp, _ = ba._build_system(
            p, 5.991, torch.tensor(lam, device=cuda_device))
        cp = ba.coupling(p, Wcp, Hpp_inv)
        g = ba._schur_rhs(cp, bp, bc)
        got = pcg(cp, Hcc_d, g).clone()
        close(got, eager_dc(cp, Hcc_d, g, 30), 1e-4)
    pcg.close()
    torch.cuda.synchronize()
    before = (torch.cuda.memory_allocated(cuda_device), dict(ck.LAUNCHES))
    out, cost = ba.ba_solve(prob, n_iters=3, cg_iters=30)
    assert bool(torch.isfinite(cost))
    del out, cost
    torch.cuda.synchronize()
    assert torch.cuda.memory_allocated(cuda_device) == before[0]
    assert ck.LAUNCHES["ba_schur_sweep"] - before[1]["ba_schur_sweep"] == 3 * (2 * 30 + 2)
