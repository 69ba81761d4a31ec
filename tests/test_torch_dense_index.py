"""The dense local BA's point-major edge index (``ops/ba._local_point_index``,
built once per solve beside the local slots) and the layout of the coupling
blocks V and VH (``ops/ba.dense_coupling_buffers``), on the CPU.

On ``tests/test_torch_map_kernels.py``'s problems (mixed mono / stereo
rows, outliers, fixed points, two edges of one camera on one point), with
L = 128 slots (more slots than eligible points: empty slots), 40 (fewer:
overflow) and the problem's whole pool:
- the slots equal the JAX package's ``_local_point_table``'s;
- the index covers each valid local edge exactly once and nothing else;
- its segments ascend by slot, and inside a segment the edges are in flat
  edge order (camera order); a slot with no edge has an empty segment;
- ``index_add_`` of the plain version's per-edge Hpp, bp and V in the
  index's order reproduces ``dense_terms_plain``'s Hpi, bp and V within 1e-6
  relative (the same sums in the same order: bit for bit in practice);
- V and VH as the kernels write them: ``permute(0, 2, 1, 3).reshape(6C, 3L)``
  is a view of the buffer (same address, no copy) at L a multiple of the
  slot tile and not, and the S product over those views equals it over
  contiguous copies.
"""

import numpy as np
import pytest
import torch
from test_torch_map_kernels import grid_problem, to_torch

from orbslam2_with_quadrics_tpu_torch.ops import ba, residuals

CASES = {  # seed, C, stereo share, Huber, L (None: the whole pool)
    "C=6 mixed, L=128 (empty slots)": (1, 6, 0.5, True, 128),
    "C=4 stereo, L=40 (overflow)": (0, 4, 1.0, False, 40),
    "C=5 mono, whole pool": (5, 5, 0.0, True, None),
}


def case(name):
    seed, C, stereo, huber, L = CASES[name]
    arrays, grid = grid_problem(seed, C=C, stereo=stereo)
    prob = to_torch(arrays)
    return arrays, prob, grid, (L or prob.points.shape[0]), huber


@pytest.mark.parametrize("name", sorted(CASES))
def test_index_slots_match_reference(name):
    import jax.numpy as jnp

    from orbslam2_with_quadrics_tpu.ops import ba as jba

    arrays, prob, grid, L, _ = case(name)
    ids, index = ba._local_point_index(prob, L, grid)
    jprob = jba.BAProblem(**{k: jnp.asarray(v) for k, v in arrays.items()})
    j_ids, j_ploc = jba._local_point_table(jprob, L, grid)
    np.testing.assert_array_equal(ids.numpy(), np.asarray(j_ids))
    np.testing.assert_array_equal(index.ploc.numpy(), np.asarray(j_ploc))


@pytest.mark.parametrize("name", sorted(CASES))
def test_index_covers_each_local_edge_once_in_order(name):
    _, prob, grid, L, _ = case(name)
    ids, index = ba._local_point_index(prob, L, grid)
    E = grid[0] * grid[1]
    flat = index.ploc.reshape(-1)
    eligible = (prob.valid > 0) & (prob.fixed_pnt[prob.pnt_idx] < 0.5)
    local_edges = torch.nonzero(flat < L)[:, 0]
    assert bool(eligible[local_edges].all())
    n_loc = int(index.offsets[L])
    assert index.offsets.dtype == torch.int32 and index.pos.dtype == torch.int32
    assert int(index.offsets[0]) == 0 and n_loc == local_edges.numel()
    # a permutation of every edge; the local ones first, each exactly once
    assert torch.equal(torch.sort(index.order).values, torch.arange(E))
    assert torch.equal(torch.sort(index.order[:n_loc]).values, local_edges)
    # segments ascend by slot; inside one, flat edge order; pos inverts order
    seg = index.offsets.diff().long()
    assert bool((seg >= 0).all())
    assert torch.equal(flat[index.order[:n_loc]], torch.repeat_interleave(torch.arange(L), seg))
    for s in range(L):
        edges = index.order[int(index.offsets[s]):int(index.offsets[s + 1])]
        assert bool((edges.diff() > 0).all())
    assert torch.equal(index.pos[index.order[:n_loc]], torch.arange(n_loc, dtype=torch.int32))
    assert bool((index.pos[index.order[n_loc:]] == -1).all())
    # an empty slot (no point, or a point with no local edge) has an empty segment
    empty = ids >= prob.points.shape[0]
    assert torch.equal(seg == 0, empty)
    if name.startswith("C=6"):
        assert bool(empty.any())


def per_edge_blocks(prob, grid, d2):
    """The plain version's per-edge Hpp [E, 3, 3], bp [E, 3] and V [E, 6, 3],
    by ``dense_terms_plain``'s own expressions."""
    C, N = grid
    pid = prob.pnt_idx.reshape(C, N)
    e, Jc, Jp, z = residuals.residual_and_jacobians(
        prob.poses[:, None, :], prob.K, prob.bf, prob.points[pid], prob.uvr.reshape(C, N, 3))
    row_w, is2, ok, chi2 = ba._grid_chi2(prob, e, z, grid)
    hw = residuals.huber_weight(chi2, d2) if d2 > 0 else 1.0
    w = ok * is2 * hw
    Jc = Jc * (1.0 - prob.fixed_cam)[:, None, None, None]
    Jp = Jp * (1.0 - prob.fixed_pnt[pid])[..., None, None]
    wr = (row_w * w[..., None])[..., None]
    JcW, JpW = Jc * wr, Jp * wr
    return (torch.einsum("cnri,cnrj->cnij", JpW, Jp).reshape(-1, 3, 3),
            -torch.einsum("cnri,cnr->cni", JpW, e).reshape(-1, 3),
            torch.einsum("cnri,cnrj->cnij", JcW, Jp).reshape(-1, 6, 3))


@pytest.mark.parametrize("name", sorted(CASES))
def test_index_order_sums_reproduce_plain(name):
    _, prob, grid, L, huber = case(name)
    C, N = grid
    d2 = residuals.CHI2_STEREO if huber else 0.0
    lam = torch.tensor(1e-3)
    _, index = ba._local_point_index(prob, L, grid)
    ref = ba.dense_terms_plain(prob, prob.poses, prob.points, d2, grid, lam=lam, ploc=index,
                               n_local=L)
    Hpp_e, bp_e, V_e = per_edge_blocks(prob, grid, d2)
    local = index.order[:int(index.offsets[L])]
    slot = index.ploc.reshape(-1)[local]
    Hpp = torch.zeros(L, 3, 3).index_add_(0, slot, Hpp_e[local])
    bp = torch.zeros(L, 3).index_add_(0, slot, bp_e[local])
    V = torch.zeros(C * L, 6, 3).index_add_(0, (local // N) * L + slot, V_e[local])
    eye3 = torch.eye(3)
    trace = torch.diagonal(Hpp, dim1=-2, dim2=-1).sum(-1)
    Hpi = ba._inv3x3(Hpp + lam * Hpp * eye3 + torch.where(
        torch.abs(trace) > 1e-12, 1e-8, 1.0)[:, None, None] * eye3)

    def rel(a, b):
        return float((a - b).abs().max()) / max(1.0, float(b.abs().max()))

    assert rel(Hpi, ref.Hpi) <= 1e-6
    assert rel(bp, ref.bp) <= 1e-6
    assert rel(V.reshape(C, L, 6, 3), ref.V) <= 1e-6


@pytest.mark.parametrize("L", [128, 37])
def test_coupling_layout_is_the_products_matrix(L):
    C = 5
    V, VH = ba.dense_coupling_buffers(C, L, "cpu")
    assert V.shape == VH.shape == (C, L, 6, 3)
    for x in (V, VH):
        flat = x.permute(0, 2, 1, 3).reshape(6 * C, 3 * L)
        assert flat._is_view() and flat.data_ptr() == x.data_ptr()
        assert flat.stride(1) == 1 and flat.stride(0) % (3 * ba._SLOT_TILE) == 0
    assert VH.data_ptr() - V.data_ptr() == 4 * V.stride(0) * C
    rng = np.random.RandomState(L)
    V.copy_(torch.as_tensor(rng.randn(C, L, 6, 3), dtype=torch.float32))
    VH.copy_(torch.as_tensor(rng.randn(C, L, 6, 3), dtype=torch.float32))
    S = VH.permute(0, 2, 1, 3).reshape(6 * C, 3 * L) @ V.permute(0, 2, 1, 3).reshape(
        6 * C, 3 * L).T
    Vc, VHc = V.contiguous(), VH.contiguous()
    S_ref = torch.einsum("clik,dljk->cidj", VHc, Vc).reshape(6 * C, 6 * C)
    torch.testing.assert_close(S, S_ref, rtol=1e-5, atol=1e-4)
