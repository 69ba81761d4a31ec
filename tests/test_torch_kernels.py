"""The port's masked Hamming best-two (plain version and CUDA wrapper)
against the reference's ``_masked_hamming_best2_jnp`` — bit-exact on
(idx, best, second).

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
    ["dtype", "shape", "device"],
)
def test_wrapper_rejects_bad_inputs(bad):
    args = list(to_torch(make_case(16, 24, 2)))
    if bad == "dtype":
        args[1] = args[1].double()
    elif bad == "shape":
        args[5] = args[5][:, :4].contiguous()
    else:  # a device that is neither CPU nor CUDA: no silent fallback
        args = [a.to("meta") for a in args]
    with pytest.raises(ValueError):
        ck.masked_hamming_best2(*args)


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
