"""The comparison that decides ``correct``.

A solve's answer (``kf_pose``, ``pt_pos``, ``cost``) is held against the
reference's in these numbers, each with its limit from
``limits/<workload>.json``:

- ``cost_gap``: |cost - cost_ref| / cost_ref of the final cost, the largest
  over every solve of the window (each starts from the same map);
- ``kf_rot_gap_rad``, ``kf_pos_gap_m``: the largest rotation angle and
  camera-centre distance between a free keyframe's pose and the reference's;
- ``edge_gap_px``: the largest gap, over the residual rows of the edges that
  the reference's final cost counts, between the projection of the
  answer's point by the answer's pose and the reference's (u, v, and u_r
  on a stereo edge), in pixels. A point is judged where the data fix it:
  a point whose depth no edge fixes may slide along its ray on either side.
  The points of an edge whose chi2 at the purge lies within
  ``PURGE_BAND`` of its gate are left out: rounding in the program's
  precision may purge or keep that edge, and the point then ends a
  gate's residual (up to some 10 px at the coarsest level) from the
  reference's on either side, a different answer that is not a wrong one;
- ``fixed_moved``: the largest change of anything that must not move (the
  gauge keyframe 0, the empty keyframe slots, the culled and empty point
  slots) from the inputs. An exact comparison: its limit is 0.

``numbers`` also returns the cost gap of every solve, from which the
entry counts the solves that failed.
"""

from __future__ import annotations

import torch

from . import geometry

# the share of its gate within which an edge's chi2 at the purge may fall
# on either side in the program's precision (PERF.md, "How correct is
# decided")
PURGE_BAND = 0.1


def numbers(out: dict, ref: dict, inp: dict, costs):
    """(the numbers, the cost gap of each solve): ``out`` is the window's
    last answer, ``costs`` the final cost of every solve of the window."""
    f64 = torch.float64
    C = inp["kf_pose"].shape[0]
    ar = torch.arange(C, device=inp["kf_pose"].device)
    free = inp["kf_valid"] & (ar != 0)
    live = inp["pt_valid"]
    got_T, ref_T = out["kf_pose"].to(f64), ref["kf_pose"].to(f64)
    got_X, ref_X = out["pt_pos"].to(f64), ref["pt_pos"].to(f64)
    rot = geometry.rotation_angle(got_T[free, :4], ref_T[free, :4])
    pos = torch.linalg.norm(geometry.camera_center(got_T[free]) - geometry.camera_center(ref_T[free]), dim=-1)
    gap = (_predict(got_T, got_X, ref, inp) - _predict(ref_T, ref_X, ref, inp)).abs()
    gap = torch.where(ref["kept_stereo"][:, None], gap, gap * torch.tensor([1.0, 1.0, 0.0],
                                                                            dtype=f64, device=gap.device))
    either_way = torch.zeros_like(live)
    either_way[ref["edge_pnt"][(ref["purge_ratio"] - 1.0).abs() < PURGE_BAND]] = True
    gap = gap[~either_way[ref["kept_pnt"]]]
    moved = torch.cat([(out["kf_pose"][~free] - inp["kf_pose"][~free]).abs().reshape(-1),
                       (out["pt_pos"][~live] - inp["pt_pos"][~live]).abs().reshape(-1)])
    gaps = cost_gaps(costs, float(ref["cost"]))

    def mx(t):
        return float(t.max()) if t.numel() else 0.0

    return {
        "cost_gap": max(gaps),
        "kf_rot_gap_rad": mx(rot),
        "kf_pos_gap_m": mx(pos),
        "edge_gap_px": mx(gap),
        "fixed_moved": mx(moved.to(f64)),
    }, gaps


def _predict(T, X, ref, inp):
    """[E, 3] projections (u, v, u_r) of the reference's kept edges."""
    f64 = torch.float64
    fx, fy, cx, cy = inp["K"].to(f64).unbind(0)
    Tk = T[ref["kept_cam"]]
    pc = (geometry.quat_to_matrix(Tk[:, :4]) @ X[ref["kept_pnt"]][:, :, None])[..., 0] + Tk[:, 4:]
    x, y, z = pc.unbind(-1)
    u = fx * x / z + cx
    return torch.stack([u, fy * y / z + cy, u - float(inp["bf"]) / z], -1)


def cost_gaps(costs, ref_cost: float) -> list:
    return [abs(float(c) - ref_cost) / ref_cost for c in costs]

