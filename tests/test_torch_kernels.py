"""The port's masked Hamming best-two (plain version and CUDA wrapper)
against the reference's ``_masked_hamming_best2_jnp`` — bit-exact on
(idx, best, second), for one problem and for a batch of them, with a CPU
model of the CUDA kernel's reduction (lane / chunk partials and their
merge) held to the same contract at tolerance 0.

The reference (and with it JAX) is imported inside :func:`reference`, so
that the card tests at the end of this file also run where JAX is not
installed: ``python -m pytest -o addopts="" tests/test_torch_kernels.py -m cuda``.
"""

import numpy as np
import pytest
import torch

from orbslam2_with_quadrics_tpu_torch.ops import cuda_kernels as ck


def make_case(Q, N, seed, ties=False, masked_rows=0.0, level_tol=1):
    """numpy inputs at (Q, N): uint32 descriptors, uv in a 96x80 image so
    windows overlap, radii 6-20 px, 4 levels, ~85% valid."""
    rng = np.random.RandomState(seed)
    if ties:
        pool = rng.randint(0, 2 ** 32, (3, 8), dtype=np.uint64).astype(np.uint32)
        qdesc, tdesc = pool[rng.randint(0, 3, Q)], pool[rng.randint(0, 3, N)]
    else:
        qdesc = rng.randint(0, 2 ** 32, (Q, 8), dtype=np.uint64).astype(np.uint32)
        tdesc = rng.randint(0, 2 ** 32, (N, 8), dtype=np.uint64).astype(np.uint32)
        # near-copies so that many best distances are small
        near = rng.randint(0, N, Q)
        flip = rng.rand(Q) < 0.5
        qdesc[flip] = tdesc[near[flip]] ^ (
            rng.rand(int(flip.sum()), 8) < 0.05).astype(np.uint32)
    quv = (rng.rand(Q, 2) * [96.0, 80.0]).astype(np.float32)
    tuv = (rng.rand(N, 2) * [96.0, 80.0]).astype(np.float32)
    tuv[: min(N, Q) // 2] = np.round(quv[: min(N, Q) // 2])  # exact |du| = r edges
    qrad = rng.choice([6.0, 7.2, 20.0], Q).astype(np.float32)
    qlvl = rng.randint(0, 4, Q).astype(np.int32)
    tlvl = rng.randint(0, 4, N).astype(np.int32)
    qvalid = rng.rand(Q) < 0.85
    qvalid[: int(masked_rows * Q)] = False
    tvalid = rng.rand(N) < 0.85
    return qdesc, quv, qrad, qlvl, qvalid, tdesc, tuv, tlvl, tvalid


def to_torch(case, device="cpu"):
    qdesc, quv, qrad, qlvl, qvalid, tdesc, tuv, tlvl, tvalid = case
    t = lambda a: torch.as_tensor(np.ascontiguousarray(a), device=device)  # noqa: E731
    return (t(qdesc.view(np.int32)), t(quv), t(qrad), t(qlvl), t(qvalid),
            t(tdesc.view(np.int32)), t(tuv), t(tlvl), t(tvalid))


def reference(case, level_tol):
    import jax.numpy as jnp

    from orbslam2_with_quadrics_tpu.ops import pallas_kernels as jpk

    out = jpk._masked_hamming_best2_jnp(
        *[jnp.asarray(a) for a in case], level_tol=level_tol)
    return [np.asarray(o) for o in out]


CASES = {
    "main_shrunk_300x200": dict(Q=300, N=200),
    "ties": dict(Q=200, N=150, ties=True),
    "fully_masked_rows": dict(Q=260, N=300, masked_rows=0.5),
    "ragged_257x1": dict(Q=257, N=1),
    "ragged_1x513": dict(Q=1, N=513),
    "ragged_511x255": dict(Q=511, N=255),
}


@pytest.mark.parametrize("level_tol", [0, 1])
@pytest.mark.parametrize("name", sorted(CASES))
def test_plain_matches_reference_bit_exact(name, level_tol):
    kw = dict(CASES[name])
    case = make_case(kw.pop("Q"), kw.pop("N"), seed=len(name) * 7 + level_tol, **kw)
    got = ck.masked_hamming_best2(*to_torch(case), level_tol=level_tol)
    ref = reference(case, level_tol)
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g.numpy(), r)
    # contract details the kernel must keep
    idx, best, second = ref
    assert np.all(second >= best)
    dead = best == ck._BIG
    assert np.all(idx[dead] == 0) and np.all(second[dead] == ck._BIG)
    if name == "ties":
        assert np.any((second == best) & ~dead)
    if name == "fully_masked_rows":
        assert dead[: 130].all()


def test_cpu_route_does_not_count_launches():
    ck.reset_launch_counts()
    ck.masked_hamming_best2(*to_torch(make_case(20, 30, 1)))
    assert ck.LAUNCHES["masked_hamming_best2"] == 0


@pytest.mark.parametrize(
    "bad",
    ["dtype", "shape", "device", "batch"],
)
def test_wrapper_rejects_bad_inputs(bad):
    args = list(to_torch(make_case(16, 24, 2)))
    if bad == "dtype":
        args[1] = args[1].double()
    elif bad == "shape":
        args[5] = args[5][:, :4].contiguous()
    elif bad == "batch":  # per-entry targets need batched queries
        args[5:] = [a[None] for a in args[5:]]
    else:  # a device that is neither CPU nor CUDA: no silent fallback
        args = [a.to("meta") for a in args]
    with pytest.raises(ValueError):
        ck.masked_hamming_best2(*args)


def make_batch(B, Q, N, seed, shared_targets, **kw):
    """B problems stacked: per-entry queries and either per-entry targets
    or the first entry's target set shared by all."""
    cases = [make_case(Q, N, seed + 31 * b, **kw) for b in range(B)]
    if shared_targets:
        cases = [c[:5] + cases[0][5:] for c in cases]
    stacked = tuple(np.stack([c[i] for c in cases]) for i in range(9))
    batch = stacked[:5] + (cases[0][5:] if shared_targets else stacked[5:])
    return cases, batch


@pytest.mark.parametrize("level_tol", [0, 1])
@pytest.mark.parametrize("shared_targets", [False, True], ids=["per_entry", "shared"])
def test_batched_plain_is_loop_of_unbatched_and_reference(shared_targets, level_tol):
    cases, batch = make_batch(4, 150, 130, seed=11 + level_tol, shared_targets=shared_targets)
    cases[2][4][:] = False  # one problem with no valid query at all
    batch[4][2] = False
    got = ck.masked_hamming_best2(*to_torch(batch), level_tol=level_tol)
    assert all(g.shape == (4, 150) and g.dtype == torch.int32 for g in got)
    for b, case in enumerate(cases):
        one = ck.masked_hamming_best2_plain(*to_torch(case), level_tol=level_tol)
        ref = reference(case, level_tol)
        for g, o, r in zip(got, one, ref):
            np.testing.assert_array_equal(g[b].numpy(), o.numpy())
            np.testing.assert_array_equal(g[b].numpy(), r)
    assert (got[1][2] == ck._BIG).all() and (got[1][0] < ck._BIG).any()


# ---------------------------------------------------------------------------
# a CPU model of the CUDA kernel's reduction
# ---------------------------------------------------------------------------

_IDX_BITS, _NONE_D = 22, 511   # csrc/masked_hamming_best2.cu: kIdxBits, kNoneD


def _merge(k1, s1, k2, s2):
    """merge_partial of the kernel: packed keys (d << 22) | index and
    second-best distances; associative and commutative."""
    loser = torch.maximum(k1, k2) >> _IDX_BITS
    return torch.minimum(k1, k2), torch.minimum(torch.minimum(s1, s2), loser)


def kernel_reduction_model(args, level_tol, lanes, chunk, rng):
    """(idx, best, second) the way the kernel reduces them: targets are cut
    into chunks, a chunk's targets are dealt to ``lanes`` lanes (target j to
    lane j % lanes), a lane folds its admitted pairs one at a time into a
    (key, second) partial, the lane partials are merged, and the chunks'
    results are merged into a running partial — here every fold and merge
    runs in a shuffled order, which the merge rule must not notice."""
    from orbslam2_with_quadrics_tpu_torch.ops.matching import hamming_matrix

    qdesc, quv, qrad, qlvl, qvalid, tdesc, tuv, tlvl, tvalid = args
    Q, N = qdesc.shape[0], tdesc.shape[0]
    d = hamming_matrix(qdesc, tdesc).to(torch.int64)
    mask = ((torch.abs(quv[:, 0:1] - tuv[None, :, 0]) <= qrad[:, None])
            & (torch.abs(quv[:, 1:2] - tuv[None, :, 1]) <= qrad[:, None])
            & (torch.abs(tlvl[None, :] - qlvl[:, None]) <= level_tol)
            & qvalid[:, None] & tvalid[None, :])
    none_key = torch.full((Q,), _NONE_D << _IDX_BITS, dtype=torch.int64)
    none_d = torch.full((Q,), _NONE_D, dtype=torch.int64)
    pair_key = torch.where(mask, (d << _IDX_BITS) | torch.arange(N), none_key[:, None])
    run_k, run_s = none_key, none_d
    for base in rng.permutation(np.arange(0, N, chunk)):
        parts = []
        for lane in range(lanes):
            k, s = none_key, none_d
            for j in rng.permutation(np.arange(base + lane, min(base + chunk, N), lanes)):
                k, s = _merge(k, s, pair_key[:, j], none_d)
            parts.append((k, s))
        # the warp merge: min key, then per lane (second if it holds the
        # winner, else its best distance)
        keys = torch.stack([p[0] for p in parts])
        best = keys.min(dim=0).values
        rest = torch.where(keys == best, torch.stack([p[1] for p in parts]),
                           keys >> _IDX_BITS)
        run_k, run_s = _merge(run_k, run_s, best, rest.min(dim=0).values)
    dist = run_k >> _IDX_BITS
    empty = dist == _NONE_D
    idx = torch.where(empty, 0, run_k & ((1 << _IDX_BITS) - 1))
    return (idx, torch.where(empty, ck._BIG, dist),
            torch.where(run_s == _NONE_D, ck._BIG, run_s))


MODEL_CASES = {
    # ties whose equal minima fall into different lanes and different chunks
    "ties_across_lanes_and_chunks": dict(Q=40, N=150, ties=True, lanes=8, chunk=32),
    "ties_one_chunk": dict(Q=40, N=100, ties=True, lanes=32, chunk=128),
    "empty_rows": dict(Q=60, N=90, masked_rows=0.5, lanes=8, chunk=64),
    "ragged_33x1": dict(Q=33, N=1, lanes=32, chunk=1024),
    "ragged_1x77": dict(Q=1, N=77, lanes=4, chunk=16),
    "random_120x200": dict(Q=120, N=200, lanes=32, chunk=64),
}


@pytest.mark.parametrize("name", sorted(MODEL_CASES))
def test_kernel_reduction_model_matches_best_two(name):
    kw = dict(MODEL_CASES[name])
    lanes, chunk = kw.pop("lanes"), kw.pop("chunk")
    case = make_case(kw.pop("Q"), kw.pop("N"), seed=len(name), **kw)
    if "ties" in name:   # a window that admits nearly every pair
        case = case[:2] + (np.full_like(case[2], 400.0),) + case[3:]
    args = to_torch(case)
    ref = ck.masked_hamming_best2_plain(*args)
    for shuffle_seed in (0, 1):
        got = kernel_reduction_model(args, 1, lanes, chunk,
                                     np.random.RandomState(shuffle_seed))
        for g, r in zip(got, ref):
            np.testing.assert_array_equal(g.numpy(), r.numpy())
    if "ties" in name:
        assert ((ref[2] == ref[1]) & (ref[1] < ck._BIG)).any()
    if name == "empty_rows":
        assert (ref[1][:30] == ck._BIG).all() and (ref[0][:30] == 0).all()


def test_q_per_block_fills_the_card():
    """About two blocks per SM at the main path's shapes on 132 SMs, within
    the kernel's 8..64 queries per block."""
    for rows, want in ((1024, 8), (2048, 8), (4096, 16), (10240, 40), (1, 8), (10 ** 6, 64)):
        assert ck._q_per_block(rows, 132) == want


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(CASES))
def test_kernel_matches_plain_on_card(cuda_device, name):
    kw = dict(CASES[name])
    case = make_case(kw.pop("Q"), kw.pop("N"), seed=3, **kw)
    args = to_torch(case, cuda_device)
    before = ck.LAUNCHES["masked_hamming_best2"]
    got = ck.masked_hamming_best2(*args)
    torch.cuda.synchronize()
    assert ck.LAUNCHES["masked_hamming_best2"] == before + 1
    ref = ck.masked_hamming_best2_plain(*args)
    for g, r in zip(got, ref):
        assert torch.equal(g, r)


BATCHED_CASES = {
    "fuse_fwd_B10": dict(B=10, Q=300, N=260, shared_targets=False),
    "fuse_rev_B10_shared": dict(B=10, Q=300, N=260, shared_targets=True),
    "ties_B3": dict(B=3, Q=200, N=1100, shared_targets=False, ties=True),
    "ragged_B3_300x200": dict(B=3, Q=300, N=200, shared_targets=False, masked_rows=0.3),
    "two_chunks_B2_shared": dict(B=2, Q=70, N=2500, shared_targets=True),
}


@pytest.mark.cuda
@pytest.mark.parametrize("q_per_block", [None, 1, 24, 64])
@pytest.mark.parametrize("name", sorted(BATCHED_CASES))
def test_batched_kernel_matches_plain_on_card(cuda_device, name, q_per_block):
    kw = dict(BATCHED_CASES[name])
    _, batch = make_batch(kw.pop("B"), kw.pop("Q"), kw.pop("N"), seed=5, **kw)
    if "ties" in name:
        batch = batch[:2] + (np.full_like(batch[2], 400.0),) + batch[3:]
    args = to_torch(batch, cuda_device)
    before = ck.LAUNCHES["masked_hamming_best2"]
    got = ck.masked_hamming_best2(*args, q_per_block=q_per_block)
    torch.cuda.synchronize()
    assert ck.LAUNCHES["masked_hamming_best2"] == before + 1
    ref = ck.masked_hamming_best2_plain(*args)
    for g, r in zip(got, ref):
        assert torch.equal(g, r)


@pytest.mark.cuda
def test_stage_a_two_radii_one_launch_on_card(cuda_device):
    """The same queries and targets under two radii as a batch of two equal
    two unbatched launches."""
    case = to_torch(make_case(500, 400, seed=9), cuda_device)
    q = [torch.stack([a, a]) for a in case[:5]]
    q[2] = torch.stack([case[2], 2.0 * case[2]])
    got = ck.masked_hamming_best2(*q, *case[5:])
    for b in range(2):
        one = ck.masked_hamming_best2(case[0], case[1], q[2][b].contiguous(), *case[3:])
        for g, o in zip(got, one):
            assert torch.equal(g[b], o)


# the stereo path's shapes: 2048 features, two 1024-target chunks per warp
STEREO_CASES = {
    "stage_a_B2_2048x2048_shared": dict(B=2, Q=2048, N=2048, shared_targets=True),
    "stage_b_4096x2048": dict(B=1, Q=4096, N=2048, shared_targets=True),
    "fuse_fwd_B10_2048x2048": dict(B=10, Q=2048, N=2048, shared_targets=False),
    "fuse_rev_B10_2048x2048_shared": dict(B=10, Q=2048, N=2048, shared_targets=True),
}


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(STEREO_CASES))
def test_kernel_matches_plain_at_stereo_shapes_on_card(cuda_device, name):
    kw = dict(STEREO_CASES[name])
    _, batch = make_batch(kw.pop("B"), kw.pop("Q"), kw.pop("N"), seed=7, **kw)
    args = to_torch(batch, cuda_device)
    before = ck.LAUNCHES["masked_hamming_best2"]
    got = ck.masked_hamming_best2(*args)
    torch.cuda.synchronize()
    assert ck.LAUNCHES["masked_hamming_best2"] == before + 1
    ref = ck.masked_hamming_best2_plain(*args)
    for g, r in zip(got, ref):
        assert torch.equal(g, r)


@pytest.mark.cuda
def test_default_device_rgbd_system_tracks_on_card(cuda_device):
    """``System(sensor="rgbd")`` with a default ``MapConfig`` keeps its map on
    the card, initializes from the first frame and tracks through the
    kernel: at most 2 launches per tracked frame and 2 per mapping pass."""
    from orbslam2_with_quadrics_tpu_torch.models import frontend as fe
    from orbslam2_with_quadrics_tpu_torch.models import map_state as ms
    from orbslam2_with_quadrics_tpu_torch.models import system as sysm
    from orbslam2_with_quadrics_tpu_torch.utils import synthetic

    h, w, fx, n = 240, 320, 260.0, 12
    imgs, poses, K = synthetic.planar_sequence(n_frames=n, h=h, w=w, fx=fx, fy=fx, seed=3)
    cfg = sysm.SystemConfig(
        frontend=fe.FrontendConfig(height=h, width=w, n_features=512, n_levels=4, fx=fx,
                                   fy=fx, cx=w / 2, cy=h / 2, bf=0.1 * fx),
        map=ms.MapConfig(max_keyframes=32, max_points=8192, n_features=512, n_levels=4),
        sensor="rgbd", max_frames_between_kf=4)
    assert cfg.map.device == "cuda"
    slam = sysm.System(cfg)
    ck.reset_launch_counts()
    for i in range(n):
        slam.track_rgbd(imgs[i], synthetic.planar_depth(poses[i], K, h, w), timestamp=i / 30.0)
    slam.shutdown()
    assert slam.map.pt_pos.is_cuda and slam.state == sysm.System.OK
    assert slam.init_frame_id == 0 and len(slam.trajectory) == n
    launches = ck.LAUNCHES["masked_hamming_best2"]
    assert 0 < launches <= 2 * (n - 1) + 2 * slam.n_kfs_created


# loop closing's shapes: the loop points into a 13-keyframe covisible group
# (per-entry targets, radius 4) and into one keyframe (radius 10)
LOOP_CASES = {
    "loop_fuse_B13_4096x1024": dict(B=13, Q=4096, N=1024, shared_targets=False),
    "loop_fuse_B13_4096x2048": dict(B=13, Q=4096, N=2048, shared_targets=False),
    "loop_proj_B1_4096x1024": dict(B=1, Q=4096, N=1024, shared_targets=False),
}


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(LOOP_CASES))
def test_kernel_matches_plain_at_loop_shapes_on_card(cuda_device, name):
    kw = dict(LOOP_CASES[name])
    _, batch = make_batch(kw.pop("B"), kw.pop("Q"), kw.pop("N"), seed=11, **kw)
    args = to_torch(batch, cuda_device)
    before = ck.LAUNCHES["masked_hamming_best2"]
    got = ck.masked_hamming_best2(*args)
    torch.cuda.synchronize()
    assert ck.LAUNCHES["masked_hamming_best2"] == before + 1
    ref = ck.masked_hamming_best2_plain(*args)
    for g, r in zip(got, ref):
        assert torch.equal(g, r)


def mutual_inputs(na, nb, seed):
    rng = np.random.RandomState(seed)
    a = rng.randint(-2 ** 31, 2 ** 31, (na, 8)).astype(np.int32)
    b = rng.randint(-2 ** 31, 2 ** 31, (nb, 8)).astype(np.int32)
    n = min(na, nb) // 2
    b[:n] = a[rng.permutation(na)[:n]] ^ (1 << rng.randint(0, 31, (n, 8))).astype(np.int32)
    return (torch.as_tensor(a), torch.as_tensor(rng.rand(na) > 0.1),
            torch.as_tensor(b), torch.as_tensor(rng.rand(nb) > 0.1))


def test_mutual_match_cpu_is_best_two_of_the_full_matrix():
    """On CPU tensors ``mutual_match`` takes the plain version: it equals
    ``best_two`` over the whole Hamming matrix in both directions."""
    from orbslam2_with_quadrics_tpu_torch.ops import matching

    a, va, b, vb = mutual_inputs(96, 130, seed=2)
    before = dict(ck.LAUNCHES)
    mi, md = matching.mutual_match(a, va, b, vb, th=matching.TH_HIGH, ratio=0.9)
    assert ck.LAUNCHES == before
    ham = matching.hamming_matrix(a, b)
    mask = va[:, None] & vb[None, :]
    fi, fb, fs = matching.best_two(ham, mask)
    bi, _, _ = matching.best_two(ham.T, mask.T)
    ok = ((fb <= matching.TH_HIGH) & (fb.float() <= 0.9 * fs.float())
          & (bi[fi] == torch.arange(96)))
    assert torch.equal(mi, torch.where(ok, fi, -1)) and int(ok.sum()) >= 30
    assert torch.equal(md, torch.where(ok, fb, 1 << 20).to(md.dtype))


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(1024, 1024), (2048, 2048), (700, 1024)], ids=str)
def test_mutual_match_is_one_launch_and_matches_cpu_on_card(cuda_device, shape):
    from orbslam2_with_quadrics_tpu_torch.ops import matching

    args = mutual_inputs(*shape, seed=4)
    before = ck.LAUNCHES["masked_hamming_best2"]
    got = matching.mutual_match(*(t.to(cuda_device) for t in args))
    torch.cuda.synchronize()
    assert ck.LAUNCHES["masked_hamming_best2"] == before + 1
    ref = matching.mutual_match(*args)
    for g, r in zip(got, ref):
        assert torch.equal(g.cpu(), r)
    assert int((ref[0] >= 0).sum()) > shape[0] // 4


@pytest.mark.cuda
def test_default_device_loop_closing_system_on_card(cuda_device):
    """``System(enable_loop_closing=True, async_gba=True)`` with a default
    ``MapConfig``: the shipped vocabulary and the database live on the card,
    keyframes are indexed there, and a kidnapped camera relocalizes through
    the kernel."""
    from orbslam2_with_quadrics_tpu_torch.models import frontend as fe
    from orbslam2_with_quadrics_tpu_torch.models import map_state as ms
    from orbslam2_with_quadrics_tpu_torch.models import system as sysm
    from orbslam2_with_quadrics_tpu_torch.utils import synthetic

    h, w, fx = 240, 320, 260.0
    imgs, _, _ = synthetic.planar_sequence(n_frames=30, h=h, w=w, fx=fx, fy=fx, seed=9,
                                           relief=True)
    cfg = sysm.SystemConfig(
        frontend=fe.FrontendConfig(height=h, width=w, n_features=512, n_levels=4, fx=fx,
                                   fy=fx, cx=w / 2, cy=h / 2),
        map=ms.MapConfig(max_keyframes=48, max_points=8192, n_features=512, n_levels=4),
        max_frames_between_kf=2, enable_loop_closing=True, async_gba=True)
    assert cfg.map.device == "cuda"
    slam = sysm.System(cfg)
    lcs = slam.loop_closer
    assert lcs.sparse and lcs.kf_wid.is_cuda and lcs.voc.centers[4].is_cuda
    for i in range(30):
        slam.track_monocular(imgs[i], timestamp=i / 30.0)
    slam.shutdown()
    assert slam.state == sysm.System.OK and int(slam.map.n_kf) > 5
    assert slam.loop_closer.words.is_cuda and int((slam.loop_closer.words >= 0).sum()) > 0
    rng = np.random.RandomState(3)
    for k in range(3):
        slam.track_monocular(rng.rand(h, w).astype(np.float32) * 255.0, timestamp=1.0 + k)
    assert slam.state == sysm.System.LOST
    ck.reset_launch_counts()
    for i in range(16, 26):
        slam.track_monocular(imgs[i], timestamp=2.0 + i / 30.0)
        if slam.state == sysm.System.OK:
            break
    slam.shutdown()
    assert slam.state == sysm.System.OK and ck.LAUNCHES["masked_hamming_best2"] >= 3


@pytest.mark.cuda
def test_warmup_and_checkpoint_on_card(cuda_device, tmp_path):
    """``warmup()`` on a default-device mono System before its first frame
    (the map empty: the Sim3 LM meets a non-finite system, which gives a
    rejected step and never an exception) and again once it tracks, leaving
    the map, the pose and the database as they were; then ``save_system`` /
    ``load_system`` restore the map on the card bit for bit and tracking
    goes on."""
    from orbslam2_with_quadrics_tpu_torch.models import frontend as fe
    from orbslam2_with_quadrics_tpu_torch.models import map_state as ms
    from orbslam2_with_quadrics_tpu_torch.models import system as sysm
    from orbslam2_with_quadrics_tpu_torch.utils import serialization as ser
    from orbslam2_with_quadrics_tpu_torch.utils import synthetic

    h, w, fx, n = 240, 320, 260.0, 16
    imgs, _, _ = synthetic.planar_sequence(n_frames=n, h=h, w=w, fx=fx, fy=fx, seed=3)
    cfg = sysm.SystemConfig(
        frontend=fe.FrontendConfig(height=h, width=w, n_features=512, n_levels=4, fx=fx,
                                   fy=fx, cx=w / 2, cy=h / 2),
        map=ms.MapConfig(max_keyframes=32, max_points=4096, n_features=512, n_levels=4),
        max_frames_between_kf=8)
    slam = sysm.System(cfg)
    assert slam.warmup() > 0 and int(slam.map.n_kf) == 0 and slam.trajectory == []
    for i in range(10):
        slam.track_monocular(imgs[i], timestamp=i / 30.0)
    assert slam.state == sysm.System.OK
    before = ms.map_state_to_numpy(slam.map)
    T, words = slam.T_cw.clone(), slam.loop_closer.words.clone()
    slam.warmup()
    after = ms.map_state_to_numpy(slam.map)
    assert all(np.array_equal(before[f], after[f]) for f in ms.MapState._fields)
    assert torch.equal(slam.T_cw, T) and torch.equal(slam.loop_closer.words, words)
    path = str(tmp_path / "system.pkl")
    ser.save_system(path, slam)
    slam2 = sysm.System(cfg)
    ser.load_system(path, slam2)
    saved, got = ms.map_state_to_numpy(slam.map), ms.map_state_to_numpy(slam2.map)
    assert all(np.array_equal(saved[f], got[f]) for f in ms.MapState._fields)
    assert slam2.map.kf_desc.is_cuda and slam2.loop_closer.kf_wid.is_cuda
    for i in range(10, n):
        slam2.track_monocular(imgs[i], timestamp=i / 30.0)
    slam2.shutdown()
    assert slam2.state == sysm.System.OK and len(slam2.full_trajectory()) == n
