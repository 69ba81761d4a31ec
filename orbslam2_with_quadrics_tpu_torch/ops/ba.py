"""Bundle adjustment: Schur-complement Levenberg-Marquardt.

Counterpart of the reference's ``ops/ba.py``. The edge list is a flat
fixed-capacity struct-of-arrays; landmarks are marginalized exactly
(per-point 3x3 blocks); Huber robustness as IRLS weights; LM damping with
device-side accept/reject. Two solvers of the reduced camera system
S = Hcc - W Hpp^-1 W^T:

- ``ba_solve``: S applied implicitly by two segment sums over the edges and
  solved by block-Jacobi preconditioned CG (global BA, the quadric joint
  BA, local BA on the CPU, and distributed BA: with a ``group`` every
  segment sum and the cost are summed over the ranks' edge shards, see
  ``parallel/dist_ba.py``). Its edge sweeps over the coupling blocks
  (:func:`sweep_cam_to_point`, :func:`sweep_point_to_cam`) are, on a CUDA
  tensor, the hand-written kernels of ``csrc/ba_schur_sweep.cu``;
- ``ba_solve_dense``: S built densely over a cam-major [C, N] edge table
  and Cholesky-solved (local BA on the card, where the window's <= ~50
  cameras make S at most ~300 x 300). Its per-edge terms, camera blocks
  and point blocks (:func:`dense_terms`) are, on a CUDA tensor, the
  hand-written kernels of ``csrc/ba_dense_terms.cu`` (the reference laid
  them out as [C, N] planes and one-hot MXU matmuls for the TPU); the
  ``S`` product, the Cholesky solve and the update stay PyTorch.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import numpy as np
import torch
import torch.distributed as dist

from ..utils import tracing
from . import cuda_kernels, lie, residuals
from .pose_opt import robust_cost


class BAProblem(NamedTuple):
    poses: torch.Tensor       # [C,7] T_cw
    points: torch.Tensor      # [P,3]
    K: torch.Tensor           # [4]
    bf: torch.Tensor          # scalar fx*baseline
    cam_idx: torch.Tensor     # [O] int64
    pnt_idx: torch.Tensor     # [O] int64
    uvr: torch.Tensor         # [O,3]
    is_stereo: torch.Tensor   # [O] float (1.0 stereo row active)
    inv_sigma2: torch.Tensor  # [O]
    valid: torch.Tensor       # [O] float mask
    fixed_cam: torch.Tensor   # [C] float (1.0 = pose constant)
    fixed_pnt: torch.Tensor   # [P] float


def _all_sum(t, group):
    """``t`` summed over the ranks of ``group``, in place (the reference's
    ``psum``); ``t`` itself when ``group`` is None."""
    if group is not None:
        dist.all_reduce(t, op=dist.ReduceOp.SUM, group=group)
    return t


def _edge_terms(prob: BAProblem, huber_delta2: float, group=None):
    """Residuals, weights and weighted Jacobians for every edge; the cost is
    summed over ``group``'s ranks."""
    e, Jc, Jp, z = residuals.residual_and_jacobians(
        prob.poses[prob.cam_idx], prob.K, prob.bf, prob.points[prob.pnt_idx], prob.uvr
    )
    row_w = torch.stack(
        [torch.ones_like(prob.is_stereo), torch.ones_like(prob.is_stereo), prob.is_stereo],
        dim=-1,
    )
    ok = prob.valid * (z > 0.05).to(e.dtype)
    chi2 = torch.sum(e * e * row_w, dim=-1) * prob.inv_sigma2
    hw = residuals.huber_weight(chi2, huber_delta2) if huber_delta2 > 0 else 1.0
    w = ok * prob.inv_sigma2 * hw
    cost = _all_sum(torch.sum(robust_cost(chi2, huber_delta2) * ok), group)
    # gauge: fixed cameras/points contribute no Jacobian
    Jc = Jc * (1.0 - prob.fixed_cam[prob.cam_idx])[:, None, None]
    Jp = Jp * (1.0 - prob.fixed_pnt[prob.pnt_idx])[:, None, None]
    wr = row_w * w[:, None]
    return e, Jc, Jp, Jc * wr[:, :, None], Jp * wr[:, :, None], cost, chi2, ok


def _seg(vals, idx, num: int, group=None):
    return _all_sum(torch.zeros((num,) + vals.shape[1:], dtype=vals.dtype,
                                device=vals.device).index_add(0, idx, vals), group)


def _build_system(prob: BAProblem, huber_delta2: float, lam, group=None):
    C, P = prob.poses.shape[0], prob.points.shape[0]
    e, Jc, Jp, JcW, JpW, cost, _, _ = _edge_terms(prob, huber_delta2, group)
    Hcc = _seg(torch.einsum("ori,orj->oij", JcW, Jc), prob.cam_idx, C, group)
    bc = _seg(-torch.einsum("ori,or->oi", JcW, e), prob.cam_idx, C, group)
    Hpp = _seg(torch.einsum("ori,orj->oij", JpW, Jp), prob.pnt_idx, P, group)
    bp = _seg(-torch.einsum("ori,or->oi", JpW, e), prob.pnt_idx, P, group)
    Wcp = torch.einsum("ori,orj->oij", JcW, Jp).contiguous()    # [O,6,3]

    eye6 = torch.eye(6, dtype=Hcc.dtype, device=Hcc.device)
    eye3 = torch.eye(3, dtype=Hpp.dtype, device=Hpp.device)
    # LM damping; fixed cameras and unobserved points get identity blocks
    Hcc_d = Hcc + lam * Hcc * eye6 + (1e-8 + prob.fixed_cam)[:, None, None] * eye6
    observed = torch.abs(torch.einsum("pii->p", Hpp)) > 1e-12
    Hpp_d = Hpp + lam * Hpp * eye3 + torch.where(observed, 1e-8, 1.0)[:, None, None] * eye3
    return Hcc_d, bc, torch.linalg.inv_ex(Hpp_d)[0], bp, Wcp, cost


# ---------------------------------------------------------------------------
# the Schur edge sweeps
#
# The PCG's reduced camera system S = Hcc_d - W Hpp^-1 W^T is applied by two
# sweeps over the edge table's coupling blocks W_o [6, 3]: camera -> point
# (s = W^T x, summed into the points) and point -> camera (W Hpp^-1 s,
# summed into the cameras). On the card each is one launch of
# ``csrc/ba_schur_sweep.cu`` that reads only the live rows (``valid > 0``;
# a dead row's block is exactly 0); on the CPU the plain versions below.
# ---------------------------------------------------------------------------


class Coupling(NamedTuple):
    """One LM step's coupling blocks and what the sweeps read beside them.
    On the card (made once per step by :func:`coupling`): Hpp^-1 with its
    rows padded to 16 bytes, and ``args``, the kernels' checked addresses
    and sizes and the context that makes the blocks' card current; both
    None on the CPU."""

    Wcp: torch.Tensor       # [O,6,3] Jc^T w Jp
    Hpp_inv: torch.Tensor   # [P,3,3] inverse of the damped point blocks
    cam_idx: torch.Tensor   # [O] int64
    pnt_idx: torch.Tensor   # [O] int64
    valid: torch.Tensor     # [O] float, the rows the kernels read (> 0)
    n_cams: int
    Hpp_inv4: torch.Tensor | None  # [P,3,4] on the card
    args: tuple | None      # (valid, cam, pnt, W, Hpp_inv4 addresses, O, C, P, ctx, index)


def coupling(prob: BAProblem, Wcp, Hpp_inv) -> Coupling:
    """The :class:`Coupling` of ``prob``'s edge table. On a CUDA tensor it
    checks once what the kernels take and raises on anything else (Wcp
    float32 [O, 6, 3], contiguous and 16-byte aligned; Hpp^-1 float32
    [P, 3, 3]; ``valid`` float32 and the indices int64, [O]; all on one
    card), and pads Hpp^-1's rows to 16 bytes for the point -> camera
    sweep's loads."""
    dev = Wcp.device
    cam, pnt, valid = prob.cam_idx, prob.pnt_idx, prob.valid
    if dev.type == "cpu":
        return Coupling(Wcp, Hpp_inv, cam, pnt, valid, prob.poses.shape[0], None, None)
    if dev.type != "cuda":
        raise ValueError(f"coupling: unsupported device {dev}")
    O, C, P = cam.shape[0], prob.poses.shape[0], prob.points.shape[0]
    cam, pnt, valid = (t.contiguous() for t in (cam, pnt, valid))
    for name, t, dtype, shape in (("Wcp", Wcp, torch.float32, (O, 6, 3)),
                                  ("Hpp_inv", Hpp_inv, torch.float32, (P, 3, 3)),
                                  ("valid", valid, torch.float32, (O,)),
                                  ("cam_idx", cam, torch.int64, (O,)),
                                  ("pnt_idx", pnt, torch.int64, (O,))):
        if t.device != dev or t.dtype != dtype or tuple(t.shape) != shape:
            raise ValueError(f"coupling: {name} is {t.dtype} {tuple(t.shape)} on {t.device}, "
                             f"expected {dtype} {shape} on {dev}")
    if not Wcp.is_contiguous() or Wcp.data_ptr() % 16:
        raise ValueError("coupling: Wcp must be contiguous and 16-byte aligned")
    hinv4 = torch.nn.functional.pad(Hpp_inv, (0, 1))
    args = (valid.data_ptr(), cam.data_ptr(), pnt.data_ptr(), Wcp.data_ptr(), hinv4.data_ptr(),
            O, C, P, *cuda_kernels.launch_device(dev))
    return Coupling(Wcp, Hpp_inv, cam, pnt, valid, C, hinv4, args)


def sweep_cam_to_point_plain(cp: Coupling, x):
    """Plain version of :func:`sweep_cam_to_point` (one rank's sum)."""
    t = torch.einsum("oij,oi->oj", cp.Wcp, x[cp.cam_idx])
    return _seg(t, cp.pnt_idx, cp.Hpp_inv.shape[0])


def sweep_point_to_cam_plain(cp: Coupling, s):
    """Plain version of :func:`sweep_point_to_cam`'s coupling: per camera,
    the sum over its edges of W_o (Hpp^-1 s)[p_o] (one rank's sum)."""
    y = torch.einsum("pij,pj->pi", cp.Hpp_inv, s)
    t = torch.einsum("oij,oj->oi", cp.Wcp, y[cp.pnt_idx])
    return _seg(t, cp.cam_idx, cp.n_cams)


@functools.lru_cache(maxsize=1)
def _sweep_launchers():
    """The C entry points of ``csrc/ba_schur_sweep.cu`` (each sweep, and
    both for S x), typed once."""
    lib = cuda_kernels.library("ba_schur_sweep")
    vp, i64 = ctypes.c_void_p, ctypes.c_longlong
    to_points, to_cams, matvec = (lib.ba_schur_cam_to_point_launch,
                                  lib.ba_schur_point_to_cam_launch, lib.ba_schur_matvec_launch)
    to_points.argtypes = [vp] * 6 + [i64, i64, vp]
    to_cams.argtypes = [vp] * 6 + [i64] + [vp] * 4 + [i64, i64, vp]
    matvec.argtypes = [vp] * 9 + [i64, i64, i64, vp]
    for fn in (to_points, to_cams, matvec):
        fn.restype = ctypes.c_int
    return to_points, to_cams, matvec


def _camera_vector(v, n: int, width: int, dev, what: str):
    if v.device != dev or v.dtype != torch.float32 or tuple(v.shape) != (n, width):
        raise ValueError(f"{what} is {v.dtype} {tuple(v.shape)} on {v.device}, expected "
                         f"float32 {(n, width)} on {dev}")
    return v.contiguous()


def sweep_cam_to_point(cp: Coupling, x, group=None):
    """[P, 3]: s[p] = sum over the edges o of point p of W_o^T x[c_o], for
    camera vectors x [C, 6]; summed over ``group``'s ranks. On the card one
    launch of ``ba_schur_cam_to_point`` (a view of its [P, 4] buffer)."""
    if cp.args is None:
        return _all_sum(sweep_cam_to_point_plain(cp, x), group)
    valid, cam, pnt, W, _, O, C, P, ctx, index = cp.args
    x = _camera_vector(x, C, 6, cp.Wcp.device, "sweep_cam_to_point: x")
    s4 = torch.empty((P, 4), dtype=torch.float32, device=x.device)
    with ctx:
        err = _sweep_launchers()[0](valid, cam, pnt, W, x.data_ptr(), s4.data_ptr(), O, P,
                                    torch.cuda.current_stream(index).cuda_stream)
    if err != 0:
        raise RuntimeError(f"ba_schur_sweep (cam -> point) launch failed: cudaError {err}")
    cuda_kernels.LAUNCHES["ba_schur_sweep"] += 1
    return _all_sum(s4, group)[:, :3]


def sweep_point_to_cam(cp: Coupling, s, base=None, group=None):
    """[C, 6]: ``base`` [C, 6] (or 0) minus, per camera c, the sum over its
    edges o of W_o Hpp^-1[p_o] s[p_o], for point vectors s [P, 3]; the sum
    taken over ``group``'s ranks. On the card one launch of
    ``ba_schur_point_to_cam``, which adds ``base`` itself only without a
    ``group``: with one, the ranks' sums are reduced first and ``base``
    added once after."""
    if cp.args is not None and group is None:
        return _point_to_cam_cuda(cp, s, base)
    if cp.args is None:
        minus = -_all_sum(sweep_point_to_cam_plain(cp, s), group)
    else:
        minus = _all_sum(_point_to_cam_cuda(cp, s, None), group)
    return minus if base is None else base + minus


def _point_to_cam_cuda(cp: Coupling, s, base):
    valid, cam, pnt, W, hinv4, O, C, P, ctx, index = cp.args
    dev = cp.Wcp.device
    if s.device != dev or s.dtype != torch.float32 or tuple(s.shape) != (P, 3) \
            or s.stride(1) != 1:
        raise ValueError(f"sweep_point_to_cam: s is {s.dtype} {tuple(s.shape)} (strides "
                         f"{s.stride()}) on {s.device}, expected float32 ({P}, 3) rows on {dev}")
    if base is not None:
        base = _camera_vector(base, C, 6, dev, "sweep_point_to_cam: base")
    out = torch.empty((C, 6), dtype=torch.float32, device=dev)
    with ctx:
        err = _sweep_launchers()[1](
            valid, cam, pnt, W, hinv4, s.data_ptr(), s.stride(0),
            None if base is None else base.data_ptr(), None, None, out.data_ptr(), O, C,
            torch.cuda.current_stream(index).cuda_stream)
    if err != 0:
        raise RuntimeError(f"ba_schur_sweep (point -> cam) launch failed: cudaError {err}")
    cuda_kernels.LAUNCHES["ba_schur_sweep"] += 1
    return out


def _schur_matvec(x, cp: Coupling, Hcc_d, group=None):
    """S x = Hcc_d x - W Hpp^-1 W^T x via the two edge sweeps; on the card
    without a group one call launches both, the second adding Hcc_d x."""
    if cp.args is None or group is not None:
        return sweep_point_to_cam(cp, sweep_cam_to_point(cp, x, group),
                                  base=torch.einsum("cij,cj->ci", Hcc_d, x), group=group)
    valid, cam, pnt, W, hinv4, O, C, P, ctx, index = cp.args
    dev = cp.Wcp.device
    x = _camera_vector(x, C, 6, dev, "_schur_matvec: x")
    H = _camera_vector(Hcc_d.reshape(C, -1), C, 36, dev, "_schur_matvec: Hcc_d")
    buf = torch.empty(4 * P + 6 * C, dtype=torch.float32, device=dev)  # s4, then S x
    with ctx:
        err = _sweep_launchers()[2](valid, cam, pnt, W, hinv4, H.data_ptr(), x.data_ptr(),
                                    buf.data_ptr(), buf.data_ptr() + 16 * P, O, C, P,
                                    torch.cuda.current_stream(index).cuda_stream)
    if err != 0:
        raise RuntimeError(f"ba_schur_sweep (S x) launch failed: cudaError {err}")
    cuda_kernels.LAUNCHES["ba_schur_sweep"] += 2
    return buf[4 * P:].view(C, 6)


def _schur_rhs(cp: Coupling, bp, base, group=None):
    """The reduced system's right-hand side: ``base`` (bc) - W Hpp^-1 bp,
    per camera."""
    return sweep_point_to_cam(cp, bp, base=base, group=group)


def _back_substitute(cp: Coupling, bp, dc, fixed_pnt, group=None):
    """The points' step dp = Hpp^-1 (bp - W^T dc), 0 at fixed points."""
    dp = torch.einsum("pij,pj->pi", cp.Hpp_inv, bp - sweep_cam_to_point(cp, dc, group))
    return dp * (1.0 - fixed_pnt)[:, None]


def _pcg(b, matvec, Minv, iters: int):
    """Block-Jacobi preconditioned CG on the reduced camera system. Its dot
    products run over camera vectors, which every rank holds whole, so they
    take no reduction."""
    x = torch.zeros_like(b)
    r = b
    z = torch.einsum("cij,cj->ci", Minv, r)
    p = z
    for _ in range(iters):
        Ap = matvec(p)
        rz = torch.sum(r * z)
        denom = torch.sum(p * Ap)
        alpha = rz / torch.where(torch.abs(denom) < 1e-20, 1e-20, denom)
        x = x + alpha * p
        r = r - alpha * Ap
        z = torch.einsum("cij,cj->ci", Minv, r)
        beta = torch.sum(r * z) / torch.where(torch.abs(rz) < 1e-20, 1e-20, rz)
        p = z + beta * p
    return x


def ba_iteration(prob: BAProblem, lam, huber_delta2: float, cg_iters: int, group=None):
    """One damped Gauss-Newton (LM) step. Returns (new_prob, cost, step_ok).
    With a ``group`` the step and its accept test are computed from reduced
    values only, so every rank takes the same step. On the card a step
    launches the sweep kernels 2 cg_iters + 2 times (the right-hand side,
    two a PCG iteration, the back-substitution). Traced as ``ba.step``
    (``rows``, ``live_rows``) over ``ba.system``, ``ba.pcg`` and
    ``ba.update`` (``utils/tracing.py``)."""
    dev = prob.poses.device
    with tracing.span("ba.step", dev) as step:
        if step:
            step.count(rows=prob.valid.shape[0], live_rows=torch.count_nonzero(prob.valid))
        with tracing.span("ba.system", dev):
            Hcc_d, bc, Hpp_inv, bp, Wcp, cost = _build_system(prob, huber_delta2, lam, group)
            cp = coupling(prob, Wcp, Hpp_inv)
            g = _schur_rhs(cp, bp, bc, group)
        with tracing.span("ba.pcg", dev) as sp:
            sp.count(iters=cg_iters)
            dc = _pcg(g, lambda x: _schur_matvec(x, cp, Hcc_d, group),
                      torch.linalg.inv_ex(Hcc_d)[0], cg_iters)
        with tracing.span("ba.update", dev):
            dc = dc * (1.0 - prob.fixed_cam)[:, None]
            dp = _back_substitute(cp, bp, dc, prob.fixed_pnt, group)
            cand = prob._replace(poses=lie.se3_retract(prob.poses, dc),
                                 points=prob.points + dp)
            new_cost = _edge_terms(cand, huber_delta2, group)[5]
            ok = (new_cost < cost) & torch.all(torch.isfinite(dc)) & torch.all(torch.isfinite(dp))
            if group is not None:
                # accepted only where every rank accepts
                flag = ok.to(torch.int32)
                dist.all_reduce(flag, op=dist.ReduceOp.MIN, group=group)
                ok = flag > 0
            out = prob._replace(poses=torch.where(ok, cand.poses, prob.poses),
                                points=torch.where(ok, cand.points, prob.points))
            return out, torch.where(ok, new_cost, cost), ok


def ba_solve(prob: BAProblem, n_iters: int = 10, cg_iters: int = 40,
             use_huber: bool = True, group=None):
    """Run ``n_iters`` LM steps. Returns (prob, final_cost). ``group``: a
    ``torch.distributed`` process group over which ``prob``'s edges are
    sharded (poses and points whole on every rank), or None. Traced as
    ``ba.solve`` (``steps``)."""
    huber_delta2 = residuals.CHI2_STEREO if use_huber else 0.0
    with tracing.span("ba.solve", prob.poses.device) as sp:
        sp.count(steps=n_iters)
        cost = _edge_terms(prob, huber_delta2, group)[5]
        lam = torch.full((), 1e-4, dtype=prob.poses.dtype, device=prob.poses.device)
        for _ in range(n_iters):
            prob, cost, ok = ba_iteration(prob, lam, huber_delta2, cg_iters, group)
            lam = torch.clamp(torch.where(ok, lam * 0.5, lam * 4.0), 1e-8, 1e8)
        return prob, cost


def edge_chi2(prob: BAProblem):
    """Per-edge chi2 + inlier flag under the current estimate."""
    _, _, _, _, _, _, chi2, ok = _edge_terms(prob, 0.0)
    gate = torch.where(prob.is_stereo > 0, residuals.CHI2_STEREO, residuals.CHI2_MONO)
    return chi2, (chi2 < gate) & (ok > 0)


def local_ba(prob: BAProblem, cg_iters: int = 40):
    """The reference's LocalBundleAdjustment schedule over :func:`ba_solve`:
    5 robust iterations, purge the outlier edges, 10 more without the
    robust kernel (src/Optimizer.cc:653-707). Returns (prob, final_cost)."""
    prob, _ = ba_solve(prob, n_iters=5, cg_iters=cg_iters, use_huber=True)
    _, inl = edge_chi2(prob)
    prob = prob._replace(valid=prob.valid * inl.to(prob.valid.dtype))
    return ba_solve(prob, n_iters=10, cg_iters=cg_iters, use_huber=False)


_INDEX_FIELDS = ("cam_idx", "pnt_idx")


def ba_problem_from_numpy(src, device="cpu") -> BAProblem:
    """A ``BAProblem`` from any object with the same field names holding
    array-likes (the reference package's arrays): index fields as int64,
    the rest as float32."""
    return BAProblem(**{
        f: torch.as_tensor(np.array(getattr(src, f)),
                           dtype=torch.int64 if f in _INDEX_FIELDS else torch.float32,
                           device=device)
        for f in BAProblem._fields
    })


# ---------------------------------------------------------------------------
# dense-Schur direct solver (local BA on the card)
#
# The edge table is cam-major [C, N] (camera c's edges are one row, as every
# caller gathers it from the [K, N] observation table). Per-edge Jacobians
# are [C, N, 3, 6] / [C, N, 3, 3] blocks; the points that couple cameras are
# compacted into L local slots once per solve, with a point-major index of
# the edges (``LocalEdges``), and the per-point blocks (Hpp, bp, the coupling
# V [C, L, 6, 3]) are sums into the L slots (the plain version index_adds
# into L + 1 and drops slot L, which collects the edges of points that are
# not local; the kernels sum each slot's segment of the index).
# S = Hcc - V Hpp^-1 V^T is one [6C, 3L] @ [3L, 6C] product and is solved by
# Cholesky: a local window has <= ~50 cameras, so S is at most ~300 x 300.
# ---------------------------------------------------------------------------


class LocalEdges(NamedTuple):
    """A solve's local edges in point-major order, built once per solve by
    :func:`_local_point_index` beside the slots: the edges of slot s are
    ``order[offsets[s]:offsets[s + 1]]``, in flat edge order (``c * N + n``,
    so camera order) inside a slot; the edges of no local slot come last."""

    ploc: torch.Tensor     # [C, N] int64 local slot of each edge's point (L: none)
    order: torch.Tensor    # [C N] int64 flat edge ids, the local ones by slot first
    offsets: torch.Tensor  # [L + 1] int32 each slot's first place in ``order``
    pos: torch.Tensor      # [C N] int32 each local edge's place in ``order``, -1 if none


def _local_point_index(prob: BAProblem, n_local_pts: int, cam_grid):
    """The L smallest point ids that couple cameras (a valid edge, a free
    point) in L local slots. Points past them are treated as fixed this
    solve: they keep their residuals and camera terms but get no coupling,
    no right-hand side and no update. A stable sort of the tagged ids, first
    occurrences and a running count (no host read); the sort's permutation
    is the point-major edge index, and the running count its offsets.
    Returns (loc_ids [L], point id or P for an empty slot; the
    :class:`LocalEdges`)."""
    C, N = cam_grid
    P = prob.points.shape[0]
    L = n_local_pts
    dev = prob.points.device
    eligible = (prob.valid > 0) & (prob.fixed_pnt[prob.pnt_idx] < 0.5)
    tagged = torch.where(eligible, prob.pnt_idx, P)
    ts, order = torch.sort(tagged, stable=True)
    first = torch.ones_like(ts, dtype=torch.bool)
    first[1:] = ts[1:] != ts[:-1]
    rank = torch.cumsum(first, 0) - 1
    keep = first & (rank < L)
    loc_ids = torch.full((L + 1,), P, dtype=torch.int64, device=dev).scatter(
        0, torch.where(keep, rank, L), torch.where(keep, ts, P))[:L]
    slot = torch.arange(L, device=dev)
    loc_of = torch.full((P + 1,), L, dtype=torch.int64, device=dev).scatter(
        0, loc_ids, torch.where(loc_ids < P, slot, L))
    # the slot of each sorted edge, L past the local ones: it never falls
    sorted_slot = torch.where((ts < P) & (rank < L), rank, L)
    offsets = torch.searchsorted(sorted_slot, torch.arange(L + 1, device=dev)).to(torch.int32)
    place = torch.arange(C * N, dtype=torch.int32, device=dev)
    pos = torch.empty_like(place).scatter_(0, order, torch.where(sorted_slot < L, place, -1))
    return loc_ids, LocalEdges(loc_of[tagged].reshape(C, N), order, offsets, pos)



def _grid_chi2(prob: BAProblem, e, z, cam_grid):
    """(row weights [C,N,3], inv sigma^2 [C,N], validity [C,N], chi2 [C,N])."""
    C, N = cam_grid
    s = prob.is_stereo.reshape(C, N)
    row_w = torch.stack([torch.ones_like(s), torch.ones_like(s), s], dim=-1)
    is2 = prob.inv_sigma2.reshape(C, N)
    ok = prob.valid.reshape(C, N) * (z > 0.05).to(e.dtype)
    return row_w, is2, ok, torch.sum(e * e * row_w, dim=-1) * is2


def _inv3x3(A):
    """Closed-form batched 3x3 inverse (adjugate / determinant): no batched
    LU, and a singular block gives large finite numbers, never a host sync."""
    a, b, c = A[..., 0, 0], A[..., 0, 1], A[..., 0, 2]
    d, e, f = A[..., 1, 0], A[..., 1, 1], A[..., 1, 2]
    g, h, i = A[..., 2, 0], A[..., 2, 1], A[..., 2, 2]
    co_a = e * i - f * h
    co_b = -(d * i - f * g)
    co_c = d * h - e * g
    det = a * co_a + b * co_b + c * co_c
    idet = 1.0 / torch.where(torch.abs(det) < 1e-20, 1e-20, det)
    adj = torch.stack([
        torch.stack([co_a, -(b * i - c * h), b * f - c * e], -1),
        torch.stack([co_b, a * i - c * g, -(a * f - c * d)], -1),
        torch.stack([co_c, -(a * h - b * g), a * e - b * d], -1),
    ], -2)
    return adj * idet[..., None, None]


# the terms pass spreads a camera's edges over blocks of 256: N <= 8192
# keeps a camera to 32 blocks
_MAX_TERMS_EDGES = 8192
# the slot pass writes V and VH a tile of 16 slots at a time
_SLOT_TILE = 16


class DenseTerms(NamedTuple):
    """What one dense-Schur LM step needs of its edges: the damped camera
    blocks, the point blocks of the L local slots and their coupling."""

    Hcc_d: torch.Tensor   # [C,6,6] Hcc + lam diag(Hcc) + (1e-8 + fixed_cam) I
    bc: torch.Tensor      # [C,6] -Jc^T W e
    cost: torch.Tensor    # [] robust cost at the step's estimate
    V: torch.Tensor       # [C,L,6,3] Jc^T W Jp summed per (camera, slot)
    Hpi: torch.Tensor     # [L,3,3] inverse of the damped Hpp
    bp: torch.Tensor      # [L,3] -Jp^T W e
    Hpib: torch.Tensor    # [L,3] Hpi bp
    VH: torch.Tensor      # [C,L,6,3] V Hpi


def dense_terms_plain(prob: BAProblem, poses, points, huber_delta2: float, cam_grid,
                      lam=None, ploc=None, n_local: int = 0):
    """Plain PyTorch version of :func:`dense_terms` (the CPU route, and what
    the kernels are held against on the card); ``ploc`` the
    :class:`LocalEdges` of :func:`_local_point_index`, of which it reads the
    [C, N] slots."""
    C, N = cam_grid
    if ploc is None:  # the robust cost alone
        e, z = residuals.residual_only(poses[:, None, :], prob.K, prob.bf,
                                       points[prob.pnt_idx.reshape(C, N)],
                                       prob.uvr.reshape(C, N, 3))
        _, _, ok, chi2 = _grid_chi2(prob, e, z, cam_grid)
        return torch.sum(robust_cost(chi2, huber_delta2) * ok)
    L = n_local
    dev, dt = points.device, points.dtype
    pid = prob.pnt_idx.reshape(C, N)
    e, Jc, Jp, z = residuals.residual_and_jacobians(
        poses[:, None, :], prob.K, prob.bf, points[pid], prob.uvr.reshape(C, N, 3))
    row_w, is2, ok, chi2 = _grid_chi2(prob, e, z, cam_grid)
    hw = residuals.huber_weight(chi2, huber_delta2) if huber_delta2 > 0 else 1.0
    w = ok * is2 * hw
    cost = torch.sum(robust_cost(chi2, huber_delta2) * ok)
    # gauge: fixed cameras and points contribute no Jacobian
    Jc = Jc * (1.0 - prob.fixed_cam)[:, None, None, None]
    Jp = Jp * (1.0 - prob.fixed_pnt[pid])[..., None, None]
    wr = (row_w * w[..., None])[..., None]
    JcW, JpW = Jc * wr, Jp * wr

    eye6 = torch.eye(6, dtype=dt, device=dev)
    eye3 = torch.eye(3, dtype=dt, device=dev)
    Hcc = torch.einsum("cnri,cnrj->cij", JcW, Jc)
    bc = -torch.einsum("cnri,cnr->ci", JcW, e)
    Hcc_d = Hcc + lam * Hcc * eye6 + (1e-8 + prob.fixed_cam)[:, None, None] * eye6

    # per-point blocks and the coupling, summed into L + 1 local slots
    ploc = ploc.ploc
    flat = ploc.reshape(-1)
    Hpp = torch.zeros((L + 1, 3, 3), dtype=dt, device=dev).index_add_(
        0, flat, torch.einsum("cnri,cnrj->cnij", JpW, Jp).reshape(-1, 3, 3))[:L]
    bp = torch.zeros((L + 1, 3), dtype=dt, device=dev).index_add_(
        0, flat, -torch.einsum("cnri,cnr->cni", JpW, e).reshape(-1, 3))[:L]
    V = torch.zeros((C, L + 1, 6, 3), dtype=dt, device=dev)
    V.index_put_((torch.arange(C, device=dev)[:, None].expand(C, N), ploc),
                 torch.einsum("cnri,cnrj->cnij", JcW, Jp), accumulate=True)
    V = V[:, :L]

    # damped point blocks (an unobserved slot gets the identity)
    trace = torch.diagonal(Hpp, dim1=-2, dim2=-1).sum(-1)
    Hpp_d = Hpp + lam * Hpp * eye3 + torch.where(
        torch.abs(trace) > 1e-12, 1e-8, 1.0)[:, None, None] * eye3
    Hpi = _inv3x3(Hpp_d)
    return DenseTerms(Hcc_d, bc, cost, V, Hpi, bp, torch.einsum("ljk,lk->lj", Hpi, bp),
                      torch.einsum("clij,ljk->clik", V, Hpi))


def dense_terms(prob: BAProblem, poses, points, huber_delta2: float, cam_grid,
                lam=None, ploc=None, n_local: int = 0):
    """The per-edge terms of the cam-major [C, N] edge table at (``poses``,
    ``points``). With ``ploc`` (the :class:`LocalEdges` of
    :func:`_local_point_index`, ``n_local`` = L local slots) and the damping
    ``lam``: a
    :class:`DenseTerms`; without: the robust cost alone (the LM accept
    test). CPU tensors take :func:`dense_terms_plain`; CUDA tensors the
    kernels of ``csrc/ba_dense_terms.cu``: two launches for the terms (the
    terms pass, then the slot pass), one for the cost alone."""
    dev = points.device
    if dev.type == "cpu":
        return dense_terms_plain(prob, poses, points, huber_delta2, cam_grid, lam, ploc,
                                 n_local)
    if dev.type != "cuda":
        raise ValueError(f"dense_terms: unsupported device {dev}")
    return _dense_terms_cuda(prob, poses, points, huber_delta2, cam_grid, lam, ploc, n_local)


@functools.lru_cache(maxsize=1)
def _dense_launchers():
    """The three C entry points of ``csrc/ba_dense_terms.cu``, typed once."""
    lib = cuda_kernels.library("ba_dense_terms")
    vp, i32, f32, f64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_double
    terms, slots, cost = (lib.ba_dense_terms_launch, lib.ba_dense_slots_launch,
                          lib.ba_dense_cost_launch)
    terms.argtypes = [vp, f32, f32, f64, i32, i32] + [vp] * 9
    slots.argtypes = [vp, vp, vp, vp, f32, i32, i32, i32] + [vp] * 6
    cost.argtypes = [vp, f32, f64, i32, i32] + [vp] * 4
    for fn in (terms, slots, cost):
        fn.restype = ctypes.c_int
    return terms, slots, cost


def _scalar(x, dev):
    """(address, value) of a scalar argument: a float32 tensor of one
    element on ``dev`` is read by the kernel; a number is passed by value."""
    if torch.is_tensor(x):
        if x.device != dev or x.dtype != torch.float32 or x.numel() != 1:
            raise ValueError(f"dense_terms: scalar {x.dtype} {tuple(x.shape)} on {x.device}, "
                             f"expected float32 of one element on {dev}")
        return x.data_ptr(), 0.0
    return 0, float(x)


def dense_coupling_buffers(C: int, L: int, device, dtype=torch.float32):
    """Uninitialized V and VH as the slot pass writes them: the physical
    layout [C, 6, Lp, 3] (Lp = L rounded up to the slot pass's tile), which
    is the [6C, 3L] matrix of the S product, handed out as the
    ``.permute(0, 2, 1, 3)`` views of shape [C, L, 6, 3]. So
    ``V.permute(0, 2, 1, 3).reshape(6 * C, 3 * L)`` is a view (row stride
    3 Lp), not a copy."""
    Lp = -(-L // _SLOT_TILE) * _SLOT_TILE
    V, VH = torch.empty((2, C, 6, Lp, 3), dtype=dtype, device=device)[:, :, :, :L].unbind(0)
    return V.permute(0, 2, 1, 3), VH.permute(0, 2, 1, 3)


def _dense_terms_cuda(prob, poses, points, huber_delta2, cam_grid, lam, ploc, n_local):
    C, N = cam_grid
    P = points.shape[0]
    dev = points.device
    E = C * N
    want = {"poses": (poses, (C, 7)), "points": (points, (P, 3)), "K": (prob.K, (4,)),
            "uvr": (prob.uvr, (E, 3)), "is_stereo": (prob.is_stereo, (E,)),
            "inv_sigma2": (prob.inv_sigma2, (E,)), "valid": (prob.valid, (E,)),
            "fixed_cam": (prob.fixed_cam, (C,)), "fixed_pnt": (prob.fixed_pnt, (P,)),
            "pnt_idx": (prob.pnt_idx, (E,))}
    L = int(n_local)
    if ploc is not None:
        if not isinstance(ploc, LocalEdges):
            raise ValueError("dense_terms: the kernels take the point-major edge index "
                             "(LocalEdges of _local_point_index), not bare slots")
        want["pos"] = (ploc.pos, (E,))
        want["offsets"] = (ploc.offsets, (L + 1,))
    t = {}
    for name, (x, shape) in want.items():
        dtype = {"pnt_idx": torch.int64, "pos": torch.int32,
                 "offsets": torch.int32}.get(name, torch.float32)
        if x.device != dev or x.dtype != dtype or tuple(x.shape) != shape:
            raise ValueError(f"dense_terms: {name} is {x.dtype} {tuple(x.shape)} on {x.device}, "
                             f"expected {dtype} {shape} on {dev}")
        t[name] = x.contiguous()
    if E == 0:
        raise ValueError(f"dense_terms: an empty edge table {cam_grid}")
    if N > _MAX_TERMS_EDGES:
        raise ValueError(f"dense_terms: N = {N} edges per camera beyond the kernels' limit "
                         f"({_MAX_TERMS_EDGES})")
    bf_ptr, bf = _scalar(prob.bf, dev)
    lam_ptr, lam_val = (0, 0.0) if lam is None else _scalar(lam, dev)
    ptrs = (ctypes.c_int64 * 12)(
        t["poses"].data_ptr(), t["points"].data_ptr(), t["K"].data_ptr(), bf_ptr,
        t["pnt_idx"].data_ptr(), t["uvr"].data_ptr(), t["is_stereo"].data_ptr(),
        t["inv_sigma2"].data_ptr(), t["valid"].data_ptr(), t["fixed_cam"].data_ptr(),
        t["fixed_pnt"].data_ptr(), lam_ptr)
    d2 = float(huber_delta2) if huber_delta2 > 0 else 0.0
    f32 = dict(dtype=torch.float32, device=dev)
    n_blocks = C * -(-N // 256)  # the terms and cost passes' grid
    cost = torch.empty((), **f32)
    # per-block partial sums in float64 (28 a block for the terms, 1 for the
    # cost) and, for the terms, the cameras' costs; C + 1 tickets
    part = torch.empty(n_blocks * (28 if ploc is not None else 1) + C, dtype=torch.float64,
                       device=dev)
    tickets = torch.empty(C + 1, dtype=torch.int32, device=dev)
    launch_terms, launch_slots, launch_cost = _dense_launchers()
    ctx, index = cuda_kernels.launch_device(dev)
    stream = torch.cuda.current_stream(index).cuda_stream
    if ploc is None:
        with ctx:
            err = launch_cost(ptrs, bf, d2, C, N, cost.data_ptr(), part.data_ptr(),
                              tickets.data_ptr(), stream)
        if err != 0:
            raise RuntimeError(f"ba_dense_terms (cost) launch failed: cudaError {err}")
        cuda_kernels.LAUNCHES["ba_dense_terms"] += 1
        return cost
    if L < 1:
        raise ValueError(f"dense_terms: L = {L} local slots")
    Hcc_d = torch.empty((C, 6, 6), **f32)
    bc = torch.empty((C, 6), **f32)
    # each local edge's point side in float64 and its V in float32, in index order
    rows = torch.empty((E, 28), dtype=torch.float64, device=dev)
    vrows = torch.empty((E, 20), **f32)
    Hpi = torch.empty((L, 3, 3), **f32)
    bp = torch.empty((L, 3), **f32)
    Hpib = torch.empty((L, 3), **f32)
    V, VH = dense_coupling_buffers(C, L, dev)
    with ctx:
        err = launch_terms(ptrs, bf, lam_val, d2, C, N, t["pos"].data_ptr(), Hcc_d.data_ptr(),
                           bc.data_ptr(), cost.data_ptr(), part.data_ptr(),
                           tickets.data_ptr(), rows.data_ptr(), vrows.data_ptr(), stream)
        if err != 0:
            raise RuntimeError(f"ba_dense_terms (terms) launch failed: cudaError {err}")
        cuda_kernels.LAUNCHES["ba_dense_terms"] += 1
        err = launch_slots(rows.data_ptr(), vrows.data_ptr(), t["offsets"].data_ptr(), lam_ptr,
                           lam_val, C, L,
                           V.stride(0) // 18, Hpi.data_ptr(), bp.data_ptr(), Hpib.data_ptr(),
                           V.data_ptr(), VH.data_ptr(), stream)
        if err != 0:
            raise RuntimeError(f"ba_dense_terms (slots) launch failed: cudaError {err}")
        cuda_kernels.LAUNCHES["ba_dense_terms"] += 1
    return DenseTerms(Hcc_d, bc, cost, V, Hpi, bp, Hpib, VH)


def _cost_grid(prob: BAProblem, poses, points, huber_delta2: float, cam_grid, terms=None):
    """Robust cost of the cam-major edge table (the LM accept test)."""
    return (terms or dense_terms)(prob, poses, points, huber_delta2, cam_grid)


def _cholesky_solve_nan(S, g):
    """x with S x = g by Cholesky; NaN where S is not positive definite
    (XLA's Cholesky gives NaN there, so the step is rejected). Two
    triangular solves and no read of the error flag on the host."""
    L, info = torch.linalg.cholesky_ex(S)
    y = torch.linalg.solve_triangular(L, g[:, None], upper=False)
    x = torch.linalg.solve_triangular(L.mT, y, upper=True)[:, 0]
    return torch.where(info == 0, x, torch.full_like(x, float("nan")))


def _dense_schur_step(prob: BAProblem, poses, points, lam, huber_delta2: float,
                      loc_ids, ploc, cam_grid, terms=None):
    """One LM step solving the reduced camera system exactly; ``ploc`` the
    :class:`LocalEdges` of :func:`_local_point_index`; ``terms`` is the
    route of its per-edge terms and its accept test's cost
    (:func:`dense_terms` where None, or :func:`dense_terms_plain`). Returns
    (poses, points, cost, accepted)."""
    C, N = cam_grid
    P = points.shape[0]
    L = loc_ids.shape[0]
    dev, dt = points.device, points.dtype
    t = (terms or dense_terms)(prob, poses, points, huber_delta2, cam_grid, lam=lam, ploc=ploc, n_local=L)

    # S = blockdiag(Hcc_d) - V Hpi V^T; g = bc - V Hpi bp, over the [6C, 3L]
    # matrices (views of the kernels' V and VH, which they lay out so)
    V2 = t.V.permute(0, 2, 1, 3).reshape(6 * C, 3 * L)
    S_cross = t.VH.permute(0, 2, 1, 3).reshape(6 * C, 3 * L) @ V2.T
    eyeC = torch.eye(C, dtype=dt, device=dev)
    S = (eyeC[:, None, :, None] * t.Hcc_d[:, :, None, :]).reshape(6 * C, 6 * C) - S_cross
    g = t.bc - (V2 @ t.Hpib.reshape(3 * L)).reshape(C, 6)
    dc = _cholesky_solve_nan(S + 1e-10 * torch.eye(6 * C, dtype=dt, device=dev),
                             g.reshape(-1)).reshape(C, 6)
    dc = dc * (1.0 - prob.fixed_cam)[:, None]

    # back-substitute the local points: dp = Hpi (bp - V^T dc)
    dp_L = torch.einsum("ljk,lk->lj", t.Hpi, t.bp - (dc.reshape(6 * C) @ V2).reshape(L, 3))
    new_points = points + torch.zeros((P + 1, 3), dtype=dt, device=dev).index_add_(
        0, loc_ids, dp_L)[:P]
    new_poses = lie.se3_retract(poses, dc)
    new_cost = _cost_grid(prob, new_poses, new_points, huber_delta2, cam_grid, terms)
    acc = ((new_cost < t.cost) & torch.all(torch.isfinite(dc))
           & torch.all(torch.isfinite(dp_L)))
    return (torch.where(acc, new_poses, poses), torch.where(acc, new_points, points),
            torch.where(acc, new_cost, t.cost), acc)


def ba_solve_dense(prob: BAProblem, n_iters: int = 10, n_local_pts: int = 8192,
                   use_huber: bool = True, cam_grid=None, terms=None):
    """``ba_solve`` with the dense-Schur direct step; the same LM damping
    and accept schedule. ``cam_grid = (C, N)`` declares the edge table
    cam-major (``cam_idx`` = arange(C) repeated N times) and is required;
    ``terms`` is the route of the per-edge terms (:func:`dense_terms` where
    None; see :func:`_dense_schur_step`).
    Returns (prob, final_cost). The point-major edge index
    (:func:`_local_point_index`) is built once per solve. On the card a
    solve launches the ``ba_dense_terms`` kernels 3 n_iters + 1 times: the
    cost at the start, then per step the terms pass, the slot pass and the
    candidate's cost."""
    if cam_grid is None:
        raise ValueError("ba_solve_dense needs a cam-major edge table (cam_grid=(C, N)); "
                         "use ba_solve for other edge layouts")
    huber_delta2 = residuals.CHI2_STEREO if use_huber else 0.0
    loc_ids, index = _local_point_index(prob, n_local_pts, cam_grid)
    poses, points = prob.poses, prob.points
    cost = _cost_grid(prob, poses, points, huber_delta2, cam_grid, terms)
    lam = torch.full((), 1e-4, dtype=poses.dtype, device=poses.device)
    for _ in range(n_iters):
        poses, points, cost, ok = _dense_schur_step(prob, poses, points, lam, huber_delta2,
                                                    loc_ids, index, cam_grid, terms)
        lam = torch.clamp(torch.where(ok, lam * 0.5, lam * 4.0), 1e-8, 1e8)
    return prob._replace(poses=poses, points=points), cost
