"""The frame's CUDA kernels: the motion-only LM
(``pose_opt.pose_optimization``, kernel ``csrc/pose_lm.cu``), ORB detection
(``orb.detect_levels``, kernel ``csrc/orb_detect.cu``) and the ORB
descriptors (``orb.describe``, kernel ``csrc/orb_describe.cu``).

On the CPU:
- the plain LM against the reference's ``pose_optimization``, mono and mixed
  stereo rows, both schedules (2 x 3, 4 x 5), outliers that re-classification
  drops or rescues, 0 and 2 valid observations: same inlier mask, pose
  within 1e-4 (``test_pose_optimization_matches_reference``'s bars);
- ``solve_spd_small`` against the reference's on the damped systems of
  those cases; at a non-positive Cholesky pivot the port gives a NaN step
  (rejected) where the reference floors the pivot: a departure on purpose,
  held on systems made indefinite by a row of negative weight (both end
  at the start pose where every step fails) and shown where the
  reference keeps its floored step;
- the plain ``detect_level`` against the reference's, bit-exact, on a
  quantized tie-heavy image at a ragged level shape and at the stereo width;
- a CPU model of the detection kernel's decomposition (each 32x32 cell from
  its own 40x40 tile, top-cap by rank counting over the compacted finite
  values) through the same assembly as the kernel's output, equal to the
  plain version bit for bit;
- ``describe_plain`` against the reference's ``extract`` on the reference's
  pyramid (angles within 1e-4, >= 99% of the descriptors bit-equal and
  bit-equal wherever the angles are), and a CPU model of the descriptor
  kernel's loop order (``csrc/orb_describe.cu``: the patch cut, the
  moments' float64 block reduction, the blur, the taps, the ballots)
  against it: angles within 1e-6 rad of a float64 evaluation of the
  moments, and within 1e-5 rad of the plain version's plus the plain
  version's own distance to that evaluation (its float32 matmul); >= 99%
  bit-equal, bit-equal wherever the angles are, every keypoint bit-equal
  on a one-level integer image;
- a numpy model of the lane-transpose reduction that ``csrc/pose_lm.cu``
  and ``csrc/ba_dense_terms.cu`` use: lane l ends with value l's warp sum,
  bit for bit the shuffle-xor tree's;
- the wrappers' CPU route launches nothing.

The reference (and with it JAX) is imported inside :func:`jax_ref`, so the
card tests at the end also run where JAX is not installed:
``python -m pytest -o addopts="" tests/test_torch_frame_kernels.py -m cuda``.
"""

import math

import numpy as np
import pytest
import torch

from orbslam2_with_quadrics_tpu_torch.ops import cuda_kernels as ck
from orbslam2_with_quadrics_tpu_torch.ops import lie, orb, pose_opt, residuals


def jax_ref():
    import jax.numpy as jnp

    from orbslam2_with_quadrics_tpu.ops import orb as jorb
    from orbslam2_with_quadrics_tpu.ops import pose_opt as jpose

    return jnp, jorb, jpose


def N(t):
    return t.detach().cpu().numpy()


# ---------------------------------------------------------------------------
# the motion-only LM
# ---------------------------------------------------------------------------

K_CAM = np.array([500.0, 500.0, 320.0, 240.0], np.float32)
BF = 40.0


def _rotation(w):
    th = np.linalg.norm(w)
    k = w / th
    Kx = np.array([[0, -k[2], k[1]], [k[2], 0, -k[0]], [-k[1], k[0], 0]])
    return np.eye(3) + np.sin(th) * Kx + (1 - np.cos(th)) * Kx @ Kx


def _quat(R):
    w = math.sqrt(max(1.0 + np.trace(R), 1e-12)) / 2.0
    return np.array([w, (R[2, 1] - R[1, 2]) / (4 * w), (R[0, 2] - R[2, 0]) / (4 * w),
                     (R[1, 0] - R[0, 1]) / (4 * w)])


def pose_case(seed, n=300, stereo=0.0, outliers=30, n_valid=None, biased=None):
    """numpy inputs of pose_optimization: n points 4-10 units ahead, the
    true pose and a perturbed start; ``stereo`` of the rows measure u_r;
    ``outliers`` rows moved by ~40 px; ``biased`` = (fraction, px) moves
    that fraction of the rows after them by px in u, one way, so that the
    first round's pose is pulled off and drops good rows that later rounds
    rescue; ``n_valid`` keeps only that many valid rows."""
    rng = np.random.RandomState(seed)
    pw = (rng.rand(n, 3) * [6, 4, 6] + [-3, -2, 4]).astype(np.float64)
    R = _rotation(np.array([0.02, -0.03, 0.01]))
    t = np.array([0.1, -0.05, 0.2])
    pc = pw @ R.T + t
    u = K_CAM[0] * pc[:, 0] / pc[:, 2] + K_CAM[2]
    v = K_CAM[1] * pc[:, 1] / pc[:, 2] + K_CAM[3]
    ur = u - BF / pc[:, 2]
    obs = np.stack([u, v, ur], 1) + rng.randn(n, 3) * 0.7
    obs[:outliers] += rng.randn(outliers, 3) * 40.0
    if biased is not None:
        obs[outliers: outliers + int(biased[0] * n), 0] += biased[1]
    is_st = (rng.rand(n) < stereo).astype(np.float32)
    obs[:, 2] *= is_st
    level = rng.randint(0, 4, n)
    inv_s2 = (1.0 / 1.44 ** level).astype(np.float32)
    valid = (rng.rand(n) < 0.95).astype(np.float32)
    if n_valid is not None:
        valid[:] = 0.0
        valid[outliers: outliers + n_valid] = 1.0
    R0 = _rotation(np.array([0.01, 0.01, -0.01])) @ R
    t0 = t + [0.05, 0.05, -0.05]
    T0 = np.concatenate([_quat(R0), t0]).astype(np.float32)
    return (T0, K_CAM, BF if stereo > 0 else 0.0, pw.astype(np.float32),
            obs.astype(np.float32), is_st, inv_s2, valid)


POSE_CASES = {
    "mono": dict(seed=2),
    "stereo-mixed": dict(seed=3, stereo=0.5),
    "mono-rescue": dict(seed=4, biased=(0.3, 15.0)),
    "stereo-rescue": dict(seed=5, stereo=0.6, biased=(0.4, 8.0)),
    "no-valid": dict(seed=6, n_valid=0),
    "two-valid": dict(seed=7, n_valid=2, outliers=0),
    "two-valid-stereo": dict(seed=7, stereo=1.0, n_valid=2, outliers=0),
}


def reproject(T, case):
    """[N,3] predicted (u, v, u_r) of the case's points at pose T."""
    K, bf, pw = case[1], case[2], case[3]
    R = N(lie.quat_to_matrix(torch.tensor(np.asarray(T[:4]))))
    pc = pw @ R.T + T[4:]
    u = K[0] * pc[:, 0] / pc[:, 2] + K[2]
    v = K[1] * pc[:, 1] / pc[:, 2] + K[3]
    return np.stack([u, v, u - bf / pc[:, 2]], 1)


def to_torch(case, device="cpu"):
    T0, K, bf, pw, obs, is_st, inv_s2, valid = case
    t = lambda a: torch.as_tensor(np.ascontiguousarray(a), device=device)  # noqa: E731
    return (t(T0), t(K), bf, t(pw), t(obs), t(is_st), t(inv_s2), t(valid))


@pytest.mark.parametrize("schedule", [(2, 3), (4, 5)])
@pytest.mark.parametrize("name", sorted(POSE_CASES))
def test_pose_optimization_plain_matches_reference(name, schedule):
    jnp, _, jpose = jax_ref()
    case = pose_case(**POSE_CASES[name])
    rounds, iters = schedule
    got = pose_opt.pose_optimization_plain(*to_torch(case), rounds=rounds, iters=iters)
    ref = jpose.pose_optimization(*[jnp.asarray(a) for a in case], rounds=rounds, iters=iters)
    np.testing.assert_array_equal(N(got[1]), np.asarray(ref[1]))
    assert int(got[2]) == int(ref[2])
    valid = case[-1] > 0
    if name.startswith("two-valid"):
        # two points do not fix a pose: the directions they leave free move
        # only by the damping and by rounding, which differ between the two
        # frameworks (1e-4 to 4e-4 over seeds 7-9). What the data determine,
        # the two points' reprojections, agree to 1e-2 px.
        np.testing.assert_allclose(N(got[0]), np.asarray(ref[0]), atol=1e-3)
        np.testing.assert_allclose(reproject(N(got[0]), case)[valid],
                                   reproject(np.asarray(ref[0]), case)[valid], atol=1e-2)
    else:
        np.testing.assert_allclose(N(got[0]), np.asarray(ref[0]), atol=1e-4)
    if name in ("mono", "stereo-mixed"):
        assert int(got[2]) > 200 and not N(got[1])[:30].any()  # the outliers are out
    if name == "no-valid":
        assert int(got[2]) == 0
        np.testing.assert_allclose(N(got[0]), case[0], atol=1e-6)
    if name.startswith("two-valid"):
        assert int(got[2]) <= 2 and not N(got[1])[~valid].any()


def test_pose_rescue_cases_bring_rows_back():
    """The rescue cases are what they say: rows out after the first round
    are back in after the second, at both schedules' inner counts."""
    for name in ("mono-rescue", "stereo-rescue"):
        case = to_torch(pose_case(**POSE_CASES[name]))
        for iters in (3, 5):
            one = pose_opt.pose_optimization_plain(*case, rounds=1, iters=iters)[1]
            two = pose_opt.pose_optimization_plain(*case, rounds=2, iters=iters)[1]
            assert int((two & ~one).sum()) > 0, (name, iters)


def test_failed_cholesky_gives_a_rejected_step():
    """A damped system that is not positive definite solves to NaN, so the
    step is rejected, not to the partial factor's finite answer. This
    departs on purpose from the reference, which floors the pivot at 1e-12
    and takes the finite step that gives."""
    jnp, _, jpose = jax_ref()
    H = torch.tensor([[1.0, 2.0], [2.0, 1.0]])
    assert torch.isnan(pose_opt.solve_spd_small(H, torch.ones(2))).all()
    ref = np.asarray(jpose.solve_spd_small(jnp.asarray(N(H)), jnp.ones(2, jnp.float32)))
    assert np.isfinite(ref).all() and np.abs(ref).max() > 1e5
    x = pose_opt.solve_spd_small(torch.eye(2) * 4.0, torch.ones(2))
    np.testing.assert_allclose(N(x), [0.25, 0.25])


@pytest.mark.parametrize("name", ["mono", "mono-rescue", "no-valid", "stereo-mixed",
                                  "stereo-rescue"])
def test_solve_spd_small_matches_reference(name):
    """The damped system of a case's first LM step (lambda = 1e-4), solved
    as the reference solves it: within 1e-5 of the step's largest entry."""
    jnp, _, jpose = jax_ref()
    T0, K, bf, pw, obs, st, s2, valid = to_torch(pose_case(**POSE_CASES[name]))
    H, b, _ = pose_opt._normal_eq_mat(lie.quat_to_matrix(T0[:4]), T0[4:7], K, bf, pw, obs,
                                      pose_opt._row_weights(st), (valid > 0).float() * s2,
                                      residuals.CHI2_STEREO)
    Hd = H + 1e-4 * torch.diag(torch.diagonal(H)) + 1e-10 * torch.eye(6)
    got = N(pose_opt.solve_spd_small(Hd, b))
    ref = np.asarray(jpose.solve_spd_small(jnp.asarray(N(Hd)), jnp.asarray(N(b))))
    np.testing.assert_allclose(got, ref, atol=1e-5 * max(np.abs(ref).max(), 1e-6))


def indefinite_case(seed, n_valid, weight):
    """:func:`pose_case` (40 rows, the first valid row weighted ``weight`` <
    0) whose damped systems have a non-positive Cholesky pivot. No real input
    has a negative weight; none with real weights reached such a pivot (1-20
    valid rows, depths 0.02-50, schedules up to 1 x 40)."""
    case = list(pose_case(seed=seed, n=40, stereo=float(seed % 2), n_valid=n_valid,
                          outliers=0))
    case[6] = case[6].copy()
    case[6][np.flatnonzero(case[-1])[0]] = weight
    return tuple(case)


INDEFINITE_CASES = {"mono": (4, 2, -0.1), "stereo": (5, 3, -1.0)}


@pytest.mark.parametrize("name", sorted(INDEFINITE_CASES))
def test_pose_optimization_plain_on_indefinite_systems_matches_reference(name, monkeypatch):
    """Every damped system is indefinite: the plain version rejects each NaN
    step, the reference each floored one (its cost is higher), and both end
    at the start pose with the same mask."""
    jnp, _, jpose = jax_ref()
    case = indefinite_case(*INDEFINITE_CASES[name])
    steps, solve = [], pose_opt.solve_spd_small
    monkeypatch.setattr(pose_opt, "solve_spd_small",
                        lambda H, b: steps.append(solve(H, b)) or steps[-1])
    got = pose_opt.pose_optimization_plain(*to_torch(case), rounds=2, iters=3)
    assert len(steps) == 6 and all(torch.isnan(x).all() for x in steps)
    ref = jpose.pose_optimization(*[jnp.asarray(a) for a in case], rounds=2, iters=3)
    np.testing.assert_array_equal(N(got[1]), np.asarray(ref[1]))
    np.testing.assert_allclose(N(got[0]), np.asarray(ref[0]), atol=1e-4)
    np.testing.assert_allclose(N(got[0]), case[0], atol=1e-6)


def test_pose_optimization_plain_departs_where_the_reference_keeps_a_floored_step():
    """The departure of :func:`test_failed_cholesky_gives_a_rejected_step`
    seen in a whole solve: the reference's floored step lowers its cost and
    is kept, which throws the camera ~1e16 away; the plain version (and the
    kernel) reject the step and keep the start pose."""
    jnp, _, jpose = jax_ref()
    case = indefinite_case(3, 6, -0.1)
    got = pose_opt.pose_optimization_plain(*to_torch(case), rounds=2, iters=3)
    ref = jpose.pose_optimization(*[jnp.asarray(a) for a in case], rounds=2, iters=3)
    assert np.abs(np.asarray(ref[0])[4:]).max() > 1e12
    np.testing.assert_allclose(N(got[0]), case[0], atol=1e-6)


# ---------------------------------------------------------------------------
# ORB detection
# ---------------------------------------------------------------------------

def quantized_image(h, w, seed, levels=5):
    """A blocky texture quantized to a few grey levels: equal contrasts and
    equal FAST scores everywhere, so every tie rule is exercised."""
    rng = np.random.RandomState(seed)
    coarse = rng.rand(h // 4 + 2, w // 4 + 2)
    img = np.kron(coarse, np.ones((4, 4)))[:h, :w]
    img = img + 0.3 * rng.rand(h, w)
    return (np.round(img * (levels - 1)) * (240.0 / (levels - 1))).astype(np.float32)


def textured_image(h, w, seed):
    """A smooth random texture (sums of blurred noise), like a rendered frame."""
    rng = np.random.RandomState(seed)
    img = np.zeros((h, w))
    for s in (4, 9, 23):
        c = rng.rand(h // s + 2, w // s + 2)
        up = np.kron(c, np.ones((s, s)))[:h, :w]
        img += up * (255.0 / 3.0)
    return img.astype(np.float32)


@pytest.mark.parametrize("shape,n_out", [((134, 179), 62), ((370, 1226), 445)])
def test_detect_level_plain_matches_reference(shape, n_out):
    jnp, jorb, _ = jax_ref()
    img = quantized_image(*shape, seed=shape[0])
    got = orb.detect_level_plain(torch.as_tensor(img), n_out)
    ref = jorb.detect_level(jnp.asarray(img), n_out)
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(N(g), np.asarray(r))
    assert 0 < int(got[2].sum()) <= n_out


CIRCLE = orb._CIRCLE


def _bf16(x):
    return torch.as_tensor(x).to(torch.bfloat16).to(torch.float32).numpy()


def kernel_model(pyr, counts, th_high=20.0, th_low=7.0):
    """CPU model of ``csrc/orb_detect.cu``: each 32x32 cell scored from its
    own 40x40 tile (pixels outside the level read as 0), NMS over the
    34x34 ring, the border, the cell threshold, and the top-cap by rank
    counting over the finite values compacted in index order, -inf slots
    after them in index order; written into the padded [L, width] layout
    and assembled as the kernel's output is."""
    imgs = [np.asarray(p, np.float32) for p in pyr]
    plan = orb.detect_plan(tuple(i.shape for i in imgs), tuple(counts), 32, "cpu")
    out_v = np.full((len(imgs), plan.width), -np.inf, np.float32)
    out_yx = np.zeros((len(imgs), plan.width, 2), np.int32)
    for lvl, (img, (h, w, ncx, ncy, _, cap, _)) in enumerate(zip(imgs, plan.table)):
        canvas = np.zeros((ncy * 32 + 8, ncx * 32 + 8), np.float32)
        canvas[4:4 + h, 4:4 + w] = img
        for cell in range(ncy * ncx):
            y0, x0 = (cell // ncx) * 32, (cell % ncx) * 32
            tile = canvas[y0:y0 + 40, x0:x0 + 40]
            c = tile[3:37, 3:37]
            d = np.stack([_bf16(tile[3 + dy:37 + dy, 3 + dx:37 + dx] - c)
                          for dy, dx in CIRCLE])
            win = np.stack([d[[(k + j) % 16 for j in range(9)]] for k in range(16)])
            sc = np.max(np.maximum(win.min(1), -win.max(1)), 0)     # [34,34]
            s = sc[1:33, 1:33]
            keep = np.ones((32, 32), bool)
            for dy in range(3):
                for dx in range(3):
                    if (dy, dx) != (1, 1):
                        nb = sc[dy:dy + 32, dx:dx + 32]
                        keep &= (s > nb) if (dy, dx) < (1, 1) else (s >= nb)
            gy = y0 + np.arange(32)[:, None]
            gx = x0 + np.arange(32)[None, :]
            keep &= (gy >= 19) & (gy < h - 19) & (gx >= 19) & (gx < w - 19)
            v = np.where(keep, s, -np.inf).reshape(-1).astype(np.float32)
            th = th_high if v.max() > th_high else th_low
            v = np.where(v > th, v, -np.inf).astype(np.float32)
            finite = v > -np.inf
            fidx = np.nonzero(finite)[0]
            fval = v[fidx]
            nf = len(fidx)
            col = cell * cap
            for j in range(nf):
                rank = int(np.sum((fval > fval[j]) | ((fval == fval[j]) & (np.arange(nf) < j))))
                if rank < cap:
                    out_v[lvl, col + rank] = fval[j]
                    out_yx[lvl, col + rank] = (y0 + fidx[j] // 32, x0 + fidx[j] % 32)
            seen = np.cumsum(finite) - finite   # finite values below each index
            for ci in np.nonzero(~finite)[0]:
                slot = nf + ci - seen[ci]
                if slot < cap:
                    out_yx[lvl, col + slot] = (y0 + ci // 32, x0 + ci % 32)
    return orb.assemble_levels(torch.as_tensor(out_v), torch.as_tensor(out_yx), plan)


MODEL_CASES = {  # image, (h, w), levels, features
    "textured 240x320 4 levels": ("textured", (240, 320), 4, 512),
    "quantized 240x320 4 levels": ("quantized", (240, 320), 4, 512),
    "quantized 134x179": ("quantized", (134, 179), 1, 62),
    "quantized stereo 185x613 3 levels": ("quantized", (185, 613), 3, 1024),
    "sparse budget 96x128": ("textured", (96, 128), 2, 8),
}


@pytest.mark.parametrize("name", sorted(MODEL_CASES))
def test_detect_kernel_model_matches_plain(name):
    kind, (h, w), n_levels, n_feat = MODEL_CASES[name]
    img = (textured_image if kind == "textured" else quantized_image)(h, w, seed=h + w)
    shapes = orb.pyramid_shapes(h, w, n_levels, 1.2)
    pyr = orb.build_pyramid(torch.as_tensor(img), shapes)
    counts = orb.per_level_counts(n_feat, n_levels, 1.2)
    ref = orb.detect_levels(pyr, counts)
    got = kernel_model([N(p) for p in pyr], counts)
    for g, r in zip(got, ref):
        assert g.dtype == r.dtype and g.shape == r.shape
        np.testing.assert_array_equal(N(g), N(r))
    assert int(ref[2].sum()) > 0


def warp_transpose_sum_model(v):
    """[32 lanes, 32 values] float32 -> [32]: what each lane holds after the
    lane-transpose reduction of ``csrc/pose_lm.cu`` and
    ``csrc/ba_dense_terms.cu`` (at each level a lane keeps one half of its
    values, sends the other to the lane ``H`` away and adds what comes back)."""
    lanes = np.arange(32)
    for H in (16, 8, 4, 2, 1):
        upper = ((lanes & H) != 0)[:, None]
        send = np.where(upper, v[:, :H], v[:, H:2 * H])
        keep = np.where(upper, v[:, H:2 * H], v[:, :H])
        v = keep + send[lanes ^ H]
    return v[:, 0]


@pytest.mark.parametrize("seed", [0, 1])
def test_lane_transpose_reduction_model(seed):
    """Lane l ends with the warp's sum of value l, added pair by pair as a
    shuffle-xor tree adds it (so bit for bit the same at every run)."""
    rng = np.random.RandomState(seed)
    v = (rng.randn(32, 32) * 10.0 ** rng.randint(-3, 4, (32, 32))).astype(np.float32)
    got = warp_transpose_sum_model(v)
    lanes = np.arange(32)
    tree = v.copy()  # [lane, value]
    for H in (16, 8, 4, 2, 1):
        tree = tree + tree[lanes ^ H]
    assert got.dtype == np.float32
    assert np.array_equal(got, tree[0])
    np.testing.assert_allclose(got, v.astype(np.float64).sum(0), rtol=1e-5,
                               atol=1e-5 * np.abs(v).sum(0).max())


def test_cpu_routes_launch_nothing():
    from orbslam2_with_quadrics_tpu_torch.ops import ba

    ck.reset_launch_counts()
    case = to_torch(pose_case(seed=2))
    pose_opt.pose_optimization(*case)
    img = torch.as_tensor(textured_image(96, 128, seed=1))
    orb.extract(img, n_features=64, n_levels=2)
    orb.detect_level(img, 16)
    pyr = orb.build_pyramid(img, orb.pyramid_shapes(96, 128, 2, 1.2))
    yx, _, valid = orb.detect_levels(pyr, [40, 24])
    orb.describe(pyr, yx[:, 0], yx[:, 1], torch.arange(64) // 40, valid)
    C, N, P = 3, 16, 40
    g = torch.Generator().manual_seed(0)
    prob = ba.BAProblem(
        poses=lie.se3_exp(0.01 * torch.randn(C, 6, generator=g)),
        points=torch.randn(P, 3, generator=g) + torch.tensor([0.0, 0.0, 6.0]),
        K=torch.tensor([500.0, 500.0, 320.0, 240.0]), bf=torch.tensor(40.0),
        cam_idx=torch.arange(C).repeat_interleave(N),
        pnt_idx=torch.randint(0, P, (C * N,), generator=g),
        uvr=torch.rand(C * N, 3, generator=g) * 300.0, is_stereo=torch.ones(C * N),
        inv_sigma2=torch.ones(C * N), valid=torch.ones(C * N), fixed_cam=torch.zeros(C),
        fixed_pnt=torch.zeros(P))
    ba.ba_solve_dense(prob, n_iters=2, n_local_pts=P, cam_grid=(C, N))
    ba.ba_solve(prob, n_iters=2, cg_iters=3)
    assert all(n == 0 for n in ck.LAUNCHES.values()), ck.LAUNCHES
    assert set(ck.LAUNCHES) == {"masked_hamming_best2", "pose_lm", "orb_detect",
                                "orb_describe", "ba_dense_terms", "ba_schur_sweep"}


def test_detect_level_is_detect_levels_of_one():
    img = torch.as_tensor(quantized_image(134, 179, seed=1))
    one = orb.detect_level(img, 62)
    ref = orb.detect_level_plain(img, 62)
    for a, b in zip(one, ref):
        np.testing.assert_array_equal(N(a), N(b))


# ---------------------------------------------------------------------------
# ORB descriptors
# ---------------------------------------------------------------------------

DESCRIBE_CASES = {  # image, (h, w), levels, features
    "textured 240x320 4 levels": ("textured", (240, 320), 4, 512),
    "quantized stereo 185x613 3 levels": ("quantized", (185, 613), 3, 1024),
    "integer 134x179 1 level": ("quantized", (134, 179), 1, 200),
}


def describe_args(pyr, counts):
    """describe()'s arguments from the detection of ``pyr`` at ``counts``."""
    yx, _, valid = orb.detect_levels(pyr, counts)
    lvl = torch.cat([torch.full((c,), l, dtype=torch.int64, device=pyr[0].device)
                     for l, c in enumerate(counts)])
    return yx[:, 0], yx[:, 1], lvl, valid


def describe_inputs(name, device="cpu"):
    """A case's pyramid and describe()'s arguments."""
    kind, (h, w), n_levels, n_feat = DESCRIBE_CASES[name]
    img = (textured_image if kind == "textured" else quantized_image)(h, w, seed=h + w)
    pyr = orb.build_pyramid(torch.as_tensor(img, device=device),
                            orb.pyramid_shapes(h, w, n_levels, 1.2))
    return pyr, describe_args(pyr, orb.per_level_counts(n_feat, n_levels, 1.2))


def assert_describe_agrees(got, ref, valid, angle_tol, share, all_equal=False):
    """Angles within ``angle_tol`` (a number, or one per keypoint); every
    valid keypoint whose angle is bit-equal has bit-equal words; at least
    ``share`` of the valid ones bit-equal (all of them with ``all_equal``);
    invalid rows zero."""
    v = N(valid).astype(bool)
    ga, ra = N(got[0]), N(ref[0])
    assert (np.abs(ga - ra) <= angle_tol).all(), np.abs(ga - ra).max()
    same = (N(got[1]) == N(ref[1])).all(1)
    assert same[v & (ga == ra)].all()
    assert v.sum() > 50 and same[v].mean() >= (1.0 if all_equal else share)
    assert (N(got[1])[~v] == 0).all() and (ga[~v] == 0).all()


@pytest.mark.parametrize("name", ["planar 240x320 4 levels",
                                  "quantized stereo 185x613 3 levels"])
def test_describe_plain_matches_reference(name):
    """describe_plain on the reference's pyramid against the reference's
    extract (``tests/test_torch_ops.py::test_orb_on_reference_pyramid``'s
    frame and bar): angles within 1e-4, >= 99% of the descriptors
    bit-equal, and bit-equal wherever the angles are."""
    jnp, jorb, _ = jax_ref()
    if name.startswith("planar"):  # test_torch_ops.py's frame
        from orbslam2_with_quadrics_tpu.utils import synthetic as jsyn

        img = np.asarray(jsyn.planar_sequence(n_frames=2, h=240, w=320, fx=260.0, fy=260.0,
                                              seed=3)[0][1], np.float32)
        (h, w), n_levels, n_feat = img.shape, 4, 512
    else:
        kind, (h, w), n_levels, n_feat = DESCRIBE_CASES[name]
        img = quantized_image(h, w, seed=h + w)
    jpyr = jorb.build_pyramid(jnp.asarray(img), jorb.pyramid_shapes(h, w, n_levels, 1.2))
    ref = jorb.extract(jnp.asarray(img), n_features=n_feat, n_levels=n_levels)
    pyr = [torch.tensor(np.asarray(p)) for p in jpyr]
    args = describe_args(pyr, orb.per_level_counts(n_feat, n_levels, 1.2))
    np.testing.assert_array_equal(N(args[3]), np.asarray(ref.valid))
    got = orb.describe_plain(pyr, *args)
    ref_desc = torch.as_tensor(np.asarray(ref.desc).view(np.int32))
    assert_describe_agrees(got, (torch.as_tensor(np.asarray(ref.angle)), ref_desc), args[3],
                           1e-4, 0.99)


def describe_kernel_model(pyr, kp_y, kp_x, lvl_ids, valid):
    """CPU model of ``csrc/orb_describe.cu``: the 37x37 patch read from the
    keypoint's own level (0 outside it) at the start clamped into level 0's
    extent; the moments summed as the block sums them (thread t over the
    indices t, t + 256, ..., the warp's xor butterfly, then the 8 warps in
    order, in float64, then rounded to float32); the vertical then
    horizontal blur of the 31x31 centre; each test's two rotated taps; the
    words as warp ballots."""
    imgs = [N(p) for p in pyr]
    h0, w0 = imgs[0].shape
    ok = N(valid).astype(bool)
    y = np.where(ok, N(kp_y), 19)
    x = np.where(ok, N(kp_x), 19)
    lvl = N(lvl_ids)
    n = len(y)
    y0, x0 = np.clip(y - 18, 0, h0 - 37), np.clip(x - 18, 0, w0 - 37)
    raw = np.zeros((n, 37, 37), np.float32)
    for k in range(n):
        patch = imgs[lvl[k]][y0[k]:y0[k] + 37, x0[k]:x0[k] + 37]
        raw[k, :patch.shape[0], :patch.shape[1]] = patch
    i = np.arange(961)
    dy, dx = i // 31 - 15, i % 31 - 15
    circ = dy * dy + dx * dx <= 225
    centre = raw[:, 3:34, 3:34].reshape(n, 961).astype(np.float64)
    parts = [np.zeros((n, 256)) for _ in range(2)]
    for j in range(0, 961, 256):
        idx = np.minimum(j + np.arange(256), 960)
        take = circ[idx] & (j + np.arange(256) < 961)
        for part, d in zip(parts, (dy, dx)):
            part[:] = np.where(take, part + d[idx] * centre[:, idx], part)

    def block_sum(part):
        v = part.reshape(n, 8, 32)
        lanes = np.arange(32)
        for off in (16, 8, 4, 2, 1):
            v = v + v[:, :, lanes ^ off]
        s = v[:, 0, 0]
        for w in range(1, 8):
            s = s + v[:, w, 0]
        return torch.as_tensor(s).to(torch.float32)

    m01, m10 = (block_sum(p) for p in parts)
    ang = torch.where(torch.as_tensor(ok), torch.atan2(m01, m10), 0.0)
    k = orb._gauss7(2.0)
    r = torch.as_tensor(raw)
    band = r[:, 0:31, :] * float(k[0])
    for t in range(1, 7):
        band = band + r[:, t:t + 31, :] * float(k[t])
    blur = band[:, :, 0:31] * float(k[0])
    for t in range(1, 7):
        blur = blur + band[:, :, t:t + 31] * float(k[t])
    pat = torch.as_tensor(orb.brief_pattern())
    ca, sa = torch.cos(ang)[:, None], torch.sin(ang)[:, None]
    px, py = pat[None, :, 0], pat[None, :, 1]
    ox = torch.clamp(torch.round(px * ca - py * sa).to(torch.int64) + 15, 0, 30)
    oy = torch.clamp(torch.round(px * sa + py * ca).to(torch.int64) + 15, 0, 30)
    vals = blur[torch.arange(n)[:, None], oy, ox]
    bits = N(vals[:, 0::2] < vals[:, 1::2]).reshape(n, 8, 32).astype(np.uint64)
    words = (bits << np.arange(32, dtype=np.uint64)).sum(-1).astype(np.uint32).view(np.int32)
    return ang, torch.as_tensor(np.where(ok[:, None], words, 0))


def angle_f64(pyr, kp_y, kp_x, lvl_ids, valid):
    """Each keypoint's angle from its moments summed in float64 (numpy)."""
    imgs = [N(p).astype(np.float64) for p in pyr]
    h0, w0 = imgs[0].shape
    ok = N(valid).astype(bool)
    y0 = np.clip(np.where(ok, N(kp_y), 19) - 18, 0, h0 - 37) + 3
    x0 = np.clip(np.where(ok, N(kp_x), 19) - 18, 0, w0 - 37) + 3
    W = orb._moment_weights().astype(np.float64)
    out = np.zeros(len(ok))
    for k, (l, y, x) in enumerate(zip(N(lvl_ids), y0, x0)):
        c = np.zeros((31, 31))
        patch = imgs[l][y:y + 31, x:x + 31]
        c[:patch.shape[0], :patch.shape[1]] = patch
        m = c.reshape(-1) @ W
        out[k] = np.arctan2(m[0], m[1]) if ok[k] else 0.0
    return out


@pytest.mark.parametrize("name", sorted(DESCRIBE_CASES))
def test_describe_kernel_model_matches_plain(name):
    pyr, args = describe_inputs(name)
    got = describe_kernel_model(pyr, *args)
    ref = orb.describe_plain(pyr, *args)
    a64 = angle_f64(pyr, *args)
    # the model's moments are float64 sums rounded once: within 1e-6 rad of
    # the float64 angle; the plain version's float32 matmul is up to 3.5e-5
    # rad off it on these cases, so the two agree to 1e-5 plus that error.
    # Exact float32 sums on the one-level integer image: all equal there
    v = N(args[3]).astype(bool)
    assert (np.abs(N(got[0]) - a64)[v] <= 1e-6).all()
    assert_describe_agrees(got, ref, args[3], 1e-5 + np.abs(N(ref[0]) - a64), 0.99,
                           all_equal=name.startswith("integer"))


# ---------------------------------------------------------------------------
# on the card: each kernel against its plain version
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


def near_gate(T, case):
    """Rows whose chi2 at pose T lies within 1e-3 relative of their gate."""
    obs, is_st, inv_s2 = case[4], case[5], case[6]
    e = obs - reproject(T, case)
    chi2 = (e[:, 0] ** 2 + e[:, 1] ** 2 + e[:, 2] ** 2 * is_st) * inv_s2
    gate = np.where(is_st > 0, residuals.CHI2_STEREO, residuals.CHI2_MONO)
    return np.abs(chi2 - gate) <= 1e-3 * gate


@pytest.mark.cuda
@pytest.mark.parametrize("schedule", [(2, 3), (4, 5)])
@pytest.mark.parametrize("name", sorted(POSE_CASES))
def test_pose_lm_matches_plain_on_card(cuda_device, name, schedule):
    case = pose_case(**POSE_CASES[name])
    args = to_torch(case, cuda_device)
    before = ck.LAUNCHES["pose_lm"]
    got = pose_opt.pose_optimization(*args, rounds=schedule[0], iters=schedule[1])
    assert ck.LAUNCHES["pose_lm"] == before + 1
    ref = pose_opt.pose_optimization_plain(*args, rounds=schedule[0], iters=schedule[1])
    if name.startswith("two-valid"):  # as against the reference: what 2 rows fix
        valid = case[-1] > 0
        np.testing.assert_allclose(N(got[0]), N(ref[0]), atol=1e-3)
        np.testing.assert_allclose(reproject(N(got[0]), case)[valid],
                                   reproject(N(ref[0]), case)[valid], atol=1e-2)
    else:
        np.testing.assert_allclose(N(got[0]), N(ref[0]), atol=1e-4)
    differ = N(got[1]) != N(ref[1])
    assert not (differ & ~near_gate(N(ref[0]), case)).any()
    assert abs(int(got[2]) - int(ref[2])) <= int(differ.sum())


@pytest.mark.cuda
@pytest.mark.parametrize("stereo", [0.0, 0.5])
def test_pose_lm_rows_past_the_registers_on_card(cuda_device, stereo):
    """3,000 rows: the kernel keeps 2,048 in registers and reads the rest
    from memory on each pass, their inlier flags with them."""
    case = pose_case(seed=8, n=3000, stereo=stereo, outliers=300)
    args = to_torch(case, cuda_device)
    got = pose_opt.pose_optimization(*args, rounds=4, iters=5)
    ref = pose_opt.pose_optimization_plain(*args, rounds=4, iters=5)
    np.testing.assert_allclose(N(got[0]), N(ref[0]), atol=1e-4)
    differ = N(got[1]) != N(ref[1])
    assert not (differ & ~near_gate(N(ref[0]), case)).any()
    assert abs(int(got[2]) - int(ref[2])) <= int(differ.sum())
    assert 2400 < int(got[2]) < 3000


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["mono", "stereo", "departure"])
def test_pose_lm_rejects_indefinite_steps_on_card(cuda_device, name):
    case = indefinite_case(*INDEFINITE_CASES.get(name, (3, 6, -0.1)))
    args = to_torch(case, cuda_device)
    got = pose_opt.pose_optimization(*args, rounds=2, iters=3)
    ref = pose_opt.pose_optimization_plain(*args, rounds=2, iters=3)
    np.testing.assert_array_equal(N(got[1]), N(ref[1]))
    np.testing.assert_allclose(N(got[0]), N(ref[0]), atol=1e-4)
    np.testing.assert_allclose(N(got[0]), case[0], atol=1e-6)


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(MODEL_CASES))
def test_orb_detect_matches_plain_on_card(cuda_device, name):
    kind, (h, w), n_levels, n_feat = MODEL_CASES[name]
    img = (textured_image if kind == "textured" else quantized_image)(h, w, seed=h + w)
    shapes = orb.pyramid_shapes(h, w, n_levels, 1.2)
    pyr = orb.build_pyramid(torch.as_tensor(img, device=cuda_device), shapes)
    counts = orb.per_level_counts(n_feat, n_levels, 1.2)
    before = ck.LAUNCHES["orb_detect"]
    got = orb.detect_levels(pyr, counts)
    assert ck.LAUNCHES["orb_detect"] == before + 1
    ref = [torch.cat(parts) for parts in zip(*[
        orb.detect_level_plain(p, n) for p, n in zip(pyr, counts)])]
    for g, r in zip(got, ref):
        assert g.dtype == r.dtype and g.shape == r.shape
        assert torch.equal(g, r)


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(DESCRIBE_CASES))
def test_orb_describe_matches_plain_on_card(cuda_device, name):
    pyr, args = describe_inputs(name, device=cuda_device)
    before = ck.LAUNCHES["orb_describe"]
    got = orb.describe(pyr, *args)
    assert ck.LAUNCHES["orb_describe"] == before + 1
    ref = orb.describe_plain(pyr, *args)
    a64 = angle_f64(pyr, *args)
    v = N(args[3]).astype(bool)
    assert (np.abs(N(got[0]) - a64)[v] <= 1e-6).all()
    assert_describe_agrees(got, ref, args[3], 1e-5 + np.abs(N(ref[0]) - a64), 0.995,
                           all_equal=name.startswith("integer"))
    again = orb.describe(pyr, *args)
    assert torch.equal(again[0], got[0]) and torch.equal(again[1], got[1])
