"""The plain reference of the global bundle adjustment.

It works out, from the inputs alone (the dict of ``maps.build``), the
problem that ORB-SLAM2's global BA solves after a loop closure and the
solve that the port's ``run_global_ba`` is specified to run:

- the problem: one edge per observation of a live point by a live
  keyframe; a stereo row where the observation has a right-image column
  (u_r > 0); the weight 1 / scale^(2 level); keyframe 0 and every empty
  slot fixed, every live point free;
- the solve: ``robust_iters`` Levenberg-Marquardt steps with the Huber
  kernel (delta^2 = 7.815), the edges whose chi2 then exceeds the 95% gate
  (5.991 mono, 7.815 stereo) or whose depth is at most 0.05 m purged, and
  ``n_iters`` plain steps. Each step: the normal equations of the weighted
  residuals, LM damping lambda * diag + 1e-8 (identity blocks for fixed
  cameras and unobserved points), the points eliminated by their 3x3
  blocks, the reduced camera system solved by ``cg_iters`` iterations of
  block-Jacobi preconditioned CG from zero, the points back-substituted,
  the step applied on the left (poses) or added (points) and kept when it
  lowers the cost (lambda halved; else lambda times 4, within 1e-8..1e8).

The edges are a compact list of the live rows only. Every small matrix
product goes through ``geometry.mm``, so the control (``tf32=True``, float32)
rounds their operands as TF32 would. Nothing here imports the program.
"""

from __future__ import annotations

import torch

from . import geometry, maps

HUBER_DELTA2 = 7.815
GATE_MONO, GATE_STEREO = 5.991, 7.815


class Problem:
    def __init__(self, inp: dict, orb: dict, dtype=torch.float64, tf32: bool = False):
        dev = inp["kf_pose"].device
        self.dtype, self.tf32 = dtype, tf32
        obs = inp["kf_obs_point"].to(torch.int64)
        P = inp["pt_pos"].shape[0]
        live = (obs >= 0) & inp["kf_kp_valid"] & inp["kf_valid"][:, None] \
            & inp["pt_valid"][obs.clamp(0, P - 1)]
        k, n = torch.nonzero(live, as_tuple=True)
        self.cam, self.pnt = k, obs[k, n]
        ur = inp["kf_ur"][k, n].to(dtype)
        self.stereo = (ur > 0).to(dtype)
        self.uvr = torch.cat([inp["kf_uv"][k, n].to(dtype),
                              torch.where(ur > 0, ur, 0.0)[:, None]], -1)
        tab = maps.level_table(orb, dtype, dev)
        self.inv_s2 = tab[inp["kf_level"][k, n].to(torch.int64).clamp(0, tab.shape[0] - 1)]
        self.row_w = torch.stack([torch.ones_like(self.stereo), torch.ones_like(self.stereo),
                                  self.stereo], -1)
        Kt = inp["K"].to(dtype)
        self.fx, self.fy, self.cx, self.cy = (Kt[i] for i in range(4))
        self.bf = torch.tensor(float(inp["bf"]), dtype=dtype, device=dev)
        C = inp["kf_pose"].shape[0]
        ar = torch.arange(C, device=dev)
        self.pt_valid = inp["pt_valid"]
        self.free_cam = (inp["kf_valid"] & (ar != 0)).to(dtype)
        self.free_pt = inp["pt_valid"].to(dtype)
        self.C, self.P = C, P
        self.poses0 = inp["kf_pose"].to(dtype)
        self.points0 = inp["pt_pos"].to(dtype)

    # -- residuals and Jacobians -------------------------------------------

    def mm(self, a, b):
        return geometry.mm(a, b, self.tf32).to(self.dtype)

    def terms(self, poses, points, valid, delta2: float, jac: bool = True):
        T = poses[self.cam]
        R = geometry.quat_to_matrix(T[:, :4])
        pc = self.mm(R, points[self.pnt][:, :, None])[..., 0] + T[:, 4:]
        x, y, z = pc.unbind(-1)
        iz = 1.0 / torch.where(torch.abs(z) < 1e-6, 1e-6, z)
        u = self.fx * x * iz + self.cx
        v = self.fy * y * iz + self.cy
        e = self.uvr - torch.stack([u, v, u - self.bf * iz], -1)
        chi2 = torch.sum(e * e * self.row_w, -1) * self.inv_s2
        ok = valid * (z > 0.05).to(self.dtype)
        if delta2 > 0:
            big = chi2 > delta2
            rho = torch.where(big, 2.0 * torch.sqrt(delta2 * chi2.clamp(min=1e-12)) - delta2, chi2)
            hw = torch.where(big, torch.sqrt(delta2 / chi2.clamp(min=1e-12)), 1.0)
        else:
            rho, hw = chi2, 1.0
        cost = torch.sum(rho * ok)
        if not jac:
            return cost, chi2, ok
        zero = torch.zeros_like(iz)
        iz2 = iz * iz
        du = torch.stack([self.fx * iz, zero, -self.fx * x * iz2], -1)
        dv = torch.stack([zero, self.fy * iz, -self.fy * y * iz2], -1)
        dur = du + torch.stack([zero, zero, self.bf * iz2], -1)
        dpred = torch.stack([du, dv, dur], -2)                        # [E, 3, 3]
        eye = torch.eye(3, dtype=self.dtype, device=pc.device).expand(pc.shape[0], 3, 3)
        Jc = -self.mm(dpred, torch.cat([-geometry.hat(pc), eye], -1))
        Jp = -self.mm(dpred, R)
        Jc = Jc * self.free_cam[self.cam][:, None, None]
        Jp = Jp * self.free_pt[self.pnt][:, None, None]
        wr = self.row_w * (ok * self.inv_s2 * hw)[:, None]
        return e, Jc, Jp, wr, cost

    # -- one LM step -----------------------------------------------------------

    def seg(self, vals, idx, num):
        out = torch.zeros((num,) + vals.shape[1:], dtype=vals.dtype, device=vals.device)
        return out.index_add_(0, idx, vals)

    def step(self, poses, points, valid, lam, delta2: float, cg_iters: int, cost):
        e, Jc, Jp, wr, _ = self.terms(poses, points, valid, delta2)
        JcWt = (Jc * wr[:, :, None]).transpose(1, 2)                 # [E, 6, 3]
        JpWt = (Jp * wr[:, :, None]).transpose(1, 2)                 # [E, 3, 3]
        Hcc = self.seg(self.mm(JcWt, Jc), self.cam, self.C)
        bc = self.seg(-self.mm(JcWt, e[:, :, None])[..., 0], self.cam, self.C)
        Hpp = self.seg(self.mm(JpWt, Jp), self.pnt, self.P)
        bp = self.seg(-self.mm(JpWt, e[:, :, None])[..., 0], self.pnt, self.P)
        Wcp = self.mm(JcWt, Jp)                                      # [E, 6, 3]
        Wpc = Wcp.transpose(1, 2)
        eye6 = torch.eye(6, dtype=self.dtype, device=Hcc.device)
        eye3 = torch.eye(3, dtype=self.dtype, device=Hcc.device)
        Hcc_d = Hcc + lam * Hcc * eye6 + (1e-8 + (1.0 - self.free_cam))[:, None, None] * eye6
        observed = torch.abs(torch.diagonal(Hpp, dim1=-2, dim2=-1).sum(-1)) > 1e-12
        Hpp_d = Hpp + lam * Hpp * eye3 + torch.where(observed, 1e-8, 1.0)[:, None, None] * eye3
        Hpp_inv = torch.linalg.inv(Hpp_d)

        def cams_from_points(yp):       # sum over edges of Wcp y[pnt], per camera
            return self.seg(self.mm(Wcp, yp[self.pnt][:, :, None])[..., 0], self.cam, self.C)

        def matvec(xc):
            t1 = self.mm(Wpc, xc[self.cam][:, :, None])[..., 0]
            yp = self.mm(Hpp_inv, self.seg(t1, self.pnt, self.P)[:, :, None])[..., 0]
            return self.mm(Hcc_d, xc[:, :, None])[..., 0] - cams_from_points(yp)

        g = bc - cams_from_points(self.mm(Hpp_inv, bp[:, :, None])[..., 0])
        Minv = torch.linalg.inv(Hcc_d)
        dc = self.pcg(g, matvec, Minv, cg_iters) * self.free_cam[:, None]
        t1 = self.mm(Wpc, dc[self.cam][:, :, None])[..., 0]
        dp = self.mm(Hpp_inv, (bp - self.seg(t1, self.pnt, self.P))[:, :, None])[..., 0]
        dp = dp * self.free_pt[:, None]
        cand_poses = geometry.se3_retract(poses, dc)
        cand_points = points + dp
        new_cost = self.terms(cand_poses, cand_points, valid, delta2, jac=False)[0]
        ok = (new_cost < cost) & torch.all(torch.isfinite(dc)) & torch.all(torch.isfinite(dp))
        return (torch.where(ok, cand_poses, poses), torch.where(ok, cand_points, points),
                torch.where(ok, new_cost, cost), ok)

    def pcg(self, b, matvec, Minv, iters: int):
        def guard(d):
            return torch.where(torch.abs(d) < 1e-20, 1e-20, d)

        x = torch.zeros_like(b)
        r = b
        z = self.mm(Minv, r[:, :, None])[..., 0]
        p = z
        for _ in range(iters):
            Ap = matvec(p)
            rz = torch.sum(r * z)
            alpha = rz / guard(torch.sum(p * Ap))
            x = x + alpha * p
            r = r - alpha * Ap
            z = self.mm(Minv, r[:, :, None])[..., 0]
            p = z + torch.sum(r * z) / guard(rz) * p
        return x

    def lm(self, poses, points, valid, n_iters: int, cg_iters: int, delta2: float):
        cost = self.terms(poses, points, valid, delta2, jac=False)[0]
        lam = torch.tensor(1e-4, dtype=self.dtype, device=poses.device)
        for _ in range(n_iters):
            poses, points, cost, ok = self.step(poses, points, valid, lam, delta2, cg_iters, cost)
            lam = torch.clamp(torch.where(ok, lam * 0.5, lam * 4.0), 1e-8, 1e8)
        return poses, points, cost


def global_ba(inp: dict, orb: dict, robust_iters: int, n_iters: int, cg_iters: int,
              dtype=torch.float64, tf32: bool = False) -> dict:
    """The solved map: ``kf_pose`` [K, 7], ``pt_pos`` [P, 3] (the inputs
    where they are fixed or empty) and the final ``cost``; the edges the
    final cost counts (``kept_cam``, ``kept_pnt``, ``kept_stereo``); and of
    every edge its point (``edge_pnt``) and its chi2 at the purge over its
    gate (``purge_ratio``: the edge is purged where it is 1 or more)."""
    pb = Problem(inp, orb, dtype, tf32)
    valid = torch.ones(pb.cam.shape[0], dtype=dtype, device=pb.cam.device)
    poses, points, _ = pb.lm(pb.poses0, pb.points0, valid, robust_iters, cg_iters, HUBER_DELTA2)
    _, chi2, ok = pb.terms(poses, points, valid, 0.0, jac=False)
    gate = torch.where(pb.stereo > 0, GATE_STEREO, GATE_MONO)
    purge_ratio = chi2 / gate
    valid = valid * ((chi2 < gate) & (ok > 0)).to(dtype)
    poses, points, cost = pb.lm(poses, points, valid, n_iters, cg_iters, 0.0)
    kept = pb.terms(poses, points, valid, 0.0, jac=False)[2] > 0
    kf_pose = torch.where((pb.free_cam > 0)[:, None], poses, pb.poses0)
    pt_pos = torch.where(pb.pt_valid[:, None], points, pb.points0)
    return {"kf_pose": kf_pose, "pt_pos": pt_pos, "cost": cost,
            "edges": int(pb.cam.shape[0]), "purged": int((valid == 0).sum()),
            "kept_cam": pb.cam[kept], "kept_pnt": pb.pnt[kept], "kept_stereo": pb.stereo[kept] > 0,
            "edge_pnt": pb.pnt, "purge_ratio": purge_ratio}
