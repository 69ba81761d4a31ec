"""The reference's LM step against a dense float64 normal-equation step."""

import torch

from port_bench import geometry, maps, reference

ORB = {"n_features": 6, "n_levels": 8, "scale_factor": 1.2}


def tiny_inputs(seed=0):
    """3 keyframes (0 the gauge) looking down +z from x = -0.5, 0, 0.5;
    6 points 4-6 m ahead, each seen by every keyframe; every other
    observation with a right-image column; levels 0-2; the truth's
    projections plus 0.5 px of noise; poses and points then moved."""
    g = torch.Generator().manual_seed(seed)
    f64 = torch.float64
    C = torch.tensor([[-0.5, 0.0, 0.0], [0.0, 0.1, 0.0], [0.5, 0.0, 0.0]], dtype=f64)
    T = geometry.pose_from_center(C, torch.tensor([0.0, 0.0, 1.0], dtype=f64).expand(3, 3))
    X = torch.cat([torch.rand(6, 2, generator=g, dtype=f64) * 2 - 1,
                   4 + 2 * torch.rand(6, 1, generator=g, dtype=f64)], 1)
    K = torch.tensor([500.0, 500.0, 320.0, 240.0], dtype=f64)
    bf = 40.0
    R = geometry.quat_to_matrix(T[:, :4])
    pc = torch.einsum("kij,pj->kpi", R, X) + T[:, None, 4:]
    u = K[0] * pc[..., 0] / pc[..., 2] + K[2]
    v = K[1] * pc[..., 1] / pc[..., 2] + K[3]
    ur = u - bf / pc[..., 2]
    noise = 0.5 * torch.randn((3, 6, 3), generator=g, dtype=f64)
    stereo = (torch.arange(18).reshape(3, 6) % 2) == 0
    xi = 0.01 * torch.randn((3, 6), generator=g, dtype=f64)
    xi[0] = 0
    return {
        "kf_pose": geometry.se3_retract(T, xi).float(), "kf_valid": torch.ones(3, dtype=torch.bool),
        "kf_uv": torch.stack([u + noise[..., 0], v + noise[..., 1]], -1).float(),
        "kf_ur": torch.where(stereo, ur + noise[..., 2], -1.0).float(),
        "kf_level": (torch.arange(18).reshape(3, 6) % 3).to(torch.int32),
        "kf_kp_valid": torch.ones((3, 6), dtype=torch.bool),
        "kf_obs_point": torch.arange(6, dtype=torch.int32).expand(3, 6).clone(),
        "pt_pos": (X + 0.05 * torch.randn((6, 3), generator=g, dtype=f64)).float(),
        "pt_valid": torch.ones(6, dtype=torch.bool),
        "K": K.float(), "bf": bf, "inv_sigma2": maps.level_table(ORB),
    }


def dense_step(pb, poses, points, lam):
    """The damped Gauss-Newton step of the whole system, solved densely."""
    free_c = torch.nonzero(pb.free_cam > 0)[:, 0]
    nc, npnt = len(free_c), points.shape[0]

    def residuals(theta):
        xi = torch.zeros((poses.shape[0], 6), dtype=torch.float64)
        xi = xi.index_copy(0, free_c, theta[:6 * nc].reshape(nc, 6))
        P = geometry.se3_retract(poses, xi)[pb.cam]
        X = (points + theta[6 * nc:].reshape(npnt, 3))[pb.pnt]
        pc = (geometry.quat_to_matrix(P[:, :4]) @ X[:, :, None])[..., 0] + P[:, 4:]
        u = pb.fx * pc[:, 0] / pc[:, 2] + pb.cx
        v = pb.fy * pc[:, 1] / pc[:, 2] + pb.cy
        return (pb.uvr - torch.stack([u, v, u - pb.bf / pc[:, 2]], -1)).reshape(-1)

    theta0 = torch.zeros(6 * nc + 3 * npnt, dtype=torch.float64)
    e = residuals(theta0)
    J = torch.autograd.functional.jacobian(residuals, theta0)
    w = (pb.row_w * pb.inv_s2[:, None]).reshape(-1)
    H = J.T @ (w[:, None] * J)
    b = -J.T @ (w * e)
    Hd = H + lam * torch.diag(torch.diagonal(H)) + 1e-8 * torch.eye(H.shape[0], dtype=torch.float64)
    d = torch.linalg.solve(Hd, b)
    xi = torch.zeros((poses.shape[0], 6), dtype=torch.float64).index_copy(0, free_c, d[:6 * nc].reshape(nc, 6))
    return geometry.se3_retract(poses, xi), points + d[6 * nc:].reshape(npnt, 3)


def test_lm_step_matches_dense_normal_equations():
    inp = tiny_inputs()
    pb = reference.Problem(inp, ORB)
    valid = torch.ones(pb.cam.shape[0], dtype=torch.float64)
    lam = torch.tensor(1e-3, dtype=torch.float64)
    cost = pb.terms(pb.poses0, pb.points0, valid, 0.0, jac=False)[0]
    poses, points, new_cost, ok = pb.step(pb.poses0, pb.points0, valid, lam, 0.0, 60, cost)
    assert bool(ok) and float(new_cost) < float(cost)
    want_T, want_X = dense_step(pb, pb.poses0, pb.points0, float(lam))
    torch.testing.assert_close(poses, want_T, atol=1e-9, rtol=0)
    torch.testing.assert_close(points, want_X, atol=1e-9, rtol=0)


def test_solve_lowers_the_cost_and_holds_the_gauge():
    inp = tiny_inputs(1)
    out = reference.global_ba(inp, ORB, robust_iters=5, n_iters=10, cg_iters=40)
    pb = reference.Problem(inp, ORB)
    start = pb.terms(pb.poses0, pb.points0, torch.ones(pb.cam.shape[0], dtype=torch.float64),
                     0.0, jac=False)[0]
    assert float(out["cost"]) < 0.5 * float(start)
    assert torch.equal(out["kf_pose"][0], inp["kf_pose"][0].double())
    assert out["edges"] == 18


def test_edge_gap_leaves_out_only_points_of_edges_on_the_gate():
    """A point moved 3 px counts in ``edge_gap_px``, unless one of its edges
    sat within ``PURGE_BAND`` of its gate at the purge: such an edge may be
    kept or purged by rounding, and its point may then end elsewhere."""
    from port_bench import compare

    inp = tiny_inputs(2)
    ref = reference.global_ba(inp, ORB, robust_iters=5, n_iters=10, cg_iters=40)
    ans = {"kf_pose": ref["kf_pose"].clone(), "pt_pos": ref["pt_pos"].clone(), "cost": ref["cost"]}
    ans["pt_pos"][4, 0] += 3.0 * 5.0 / 500.0               # about 3 px at 4-6 m
    nums, _ = compare.numbers(ans, ref, inp, [ref["cost"]])
    assert 2.0 < nums["edge_gap_px"] < 4.5
    on_gate = ref["purge_ratio"].clone()
    on_gate[ref["edge_pnt"] == 4] = 0.2
    on_gate[(ref["edge_pnt"] == 4).nonzero()[0]] = 1.0 - 0.5 * compare.PURGE_BAND
    nums, _ = compare.numbers(ans, {**ref, "purge_ratio": on_gate}, inp, [ref["cost"]])
    assert nums["edge_gap_px"] < 1e-9
    on_gate[(ref["edge_pnt"] == 4).nonzero()[0]] = 1.0 - 2.0 * compare.PURGE_BAND
    nums, _ = compare.numbers(ans, {**ref, "purge_ratio": on_gate}, inp, [ref["cost"]])
    assert 2.0 < nums["edge_gap_px"] < 4.5
