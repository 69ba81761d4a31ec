"""``ba_step_roofline_pct``: the BA solver's LM step against the device's roofline.

The least time of one LM step for the cell's inputs, max(FLOP / peak
FLOP/s, bytes / peak bytes/s), divided by the device's busy time per LM
step in the traced window (the union of its activity intervals over the
solves, divided by the LM steps they ran).

The cost model counts what the inputs need, whatever implements the
solver: the live edges (observations of live points by live keyframes;
a mono edge has 2 residual rows, a stereo edge 3), the free cameras and
the free points, and the step's ``cg_iters`` PCG iterations. FLOP (a
multiply and an add are 2):

- per edge: the point into the camera (18), the projection (7), the
  Schur right-hand side (W y: 36), the back-substitution (W^T dc: 36), the
  candidate's cost (25); per PCG iteration the two coupling products
  (W^T x and W y: 72) and their sums into points and cameras (9);
- per residual row: residual and chi2 (3 + 3 for the candidate), the
  Jacobian rows (15 for the rotation part of the camera's, 15 for the
  point's), the weights (9), and the row's share of the normal equations:
  Hcc's 21 distinct entries (42), bc (12), Hpp's 6 (12), bp (6), W (36);
- per free point: the 3x3 inverse (40), Hpp^-1 bp (18), the
  back-substitution (21), the update (3); per PCG iteration Hpp^-1 (18);
- per free camera: the 6x6 preconditioner's inverse (400), the retraction
  (100); per PCG iteration Hcc x (72), its difference (6), the
  preconditioner (72), three dot products and three updates (72).

Bytes: each input read once and each output written once: per edge its
u, v, u_r, level and point id (20); per free camera its pose read and
written (56); per free point its position read and written (24).
"""

from __future__ import annotations

EDGE_FLOP, EDGE_PCG_FLOP = 18 + 7 + 36 + 36 + 25, 72 + 9
ROW_FLOP = 3 + 3 + 15 + 15 + 9 + 42 + 12 + 12 + 6 + 36
POINT_FLOP, POINT_PCG_FLOP = 40 + 18 + 21 + 3, 18
CAMERA_FLOP, CAMERA_PCG_FLOP = 400 + 100, 72 + 6 + 72 + 72
EDGE_BYTES, CAMERA_BYTES, POINT_BYTES = 20, 56, 24


def step_cost(counts: dict, cg_iters: int):
    """(FLOP, bytes) of one LM step on inputs with these live counts."""
    E, S = counts["edges"], counts["stereo_edges"]
    C, P = counts["free_cameras"], counts["points"]
    rows = 2 * E + S
    flop = (E * (EDGE_FLOP + cg_iters * EDGE_PCG_FLOP) + rows * ROW_FLOP
            + P * (POINT_FLOP + cg_iters * POINT_PCG_FLOP)
            + C * (CAMERA_FLOP + cg_iters * CAMERA_PCG_FLOP))
    nbytes = E * EDGE_BYTES + C * CAMERA_BYTES + P * POINT_BYTES
    return flop, nbytes


def least_step_s(counts: dict, cg_iters: int, peak: dict):
    """(least seconds of one step, the term that bounds it)."""
    flop, nbytes = step_cost(counts, cg_iters)
    t_flop, t_bytes = flop / peak["fp32_flop_s"], nbytes / peak["hbm_byte_s"]
    return (t_flop, "flop") if t_flop >= t_bytes else (t_bytes, "bytes")


def read(ctx):
    if ctx.trace is None or ctx.peak is None or ctx.trace.busy_s <= 0:
        return None
    least, bound = least_step_s(ctx.counts, int(ctx.mix["cg_iters"]), ctx.peak)
    busy_per_step = ctx.trace.busy_s / (ctx.calls * ctx.entry.steps_per_call(ctx.mix))
    ctx.notes.append(f"ba_step_roofline_pct: least {least * 1e3:.6f} ms a step, bound by {bound}; "
                     f"busy {busy_per_step * 1e3:.6f} ms a step")
    return 100.0 * least / busy_per_step
