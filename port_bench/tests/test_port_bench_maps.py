"""The map generator at a tiny size on the CPU."""

import torch

from port_bench import maps


def test_pools_and_table_as_configured(cell):
    inp = maps.build(cell.cfg, 3, "cpu")
    K, P = cell.cfg["pools"]["max_keyframes"], cell.cfg["pools"]["max_points"]
    N = cell.cfg["orb"]["n_features"]
    assert inp["kf_pose"].shape == (K, 7) and inp["pt_pos"].shape == (P, 3)
    for f in ("kf_ur", "kf_level", "kf_kp_valid", "kf_obs_point"):
        assert inp[f].shape == (K, N)
    assert inp["kf_uv"].shape == (K, N, 2)
    c = maps.live_counts(inp)
    assert c["rows"] == K * N
    assert c["keyframes"] == cell.cfg["scene"]["keyframes"]
    assert 0 < c["points"] <= cell.cfg["scene"]["points"]
    assert 0 < c["stereo_edges"] < c["edges"] <= c["keyframes"] * N
    # every live point is seen by at least min_observations live rows
    obs = inp["kf_obs_point"].to(torch.int64)
    n_obs = torch.bincount(obs[obs >= 0], minlength=P)
    assert bool((n_obs[inp["pt_valid"]] >= cell.cfg["observations"]["min_observations"]).all())
    # keyframe 0 starts at its true pose (the gauge); the others do not
    torch.testing.assert_close(inp["kf_pose"][0].double(), inp["true_pose"][0], atol=1e-6, rtol=0)
    assert float((inp["kf_pose"][1:c["keyframes"]].double() - inp["true_pose"][1:]).abs().max()) > 1e-4
    # the level table is 1 / 1.2^(2 l)
    torch.testing.assert_close(inp["inv_sigma2"][3], torch.tensor(1.2 ** -6, dtype=torch.float32))


def test_same_seed_same_inputs(cell):
    a, b = maps.build(cell.cfg, 2**31 + 7, "cpu"), maps.build(cell.cfg, 2**31 + 7, "cpu")
    assert maps.live_counts(a) == maps.live_counts(b)
    for k, v in a.items():
        if isinstance(v, torch.Tensor):
            assert torch.equal(v, b[k]), k


def test_other_seed_other_inputs(cell):
    a, b = maps.build(cell.cfg, 11, "cpu"), maps.build(cell.cfg, 12, "cpu")
    assert not torch.equal(a["pt_pos"], b["pt_pos"])
    assert not torch.equal(a["kf_uv"], b["kf_uv"])


def test_desk_path_is_the_sequences_length():
    """fr1/desk's camera travels 9.26 m; the configured sweep does too."""
    import json
    from pathlib import Path

    from port_bench.scenes import desk
    cfg = json.loads((Path(maps.__file__).parent / "configs/tum_fr1_desk_rgbd.json").read_text())
    assert abs(desk.path_length(cfg["scene"]) - 9.26) < 0.01
