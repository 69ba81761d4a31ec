"""The LM step's cost model on a problem counted by hand."""

import importlib

import torch

from port_bench import maps

roof = importlib.import_module("port_bench.metrics.ba_step_roofline_pct")


def hand_inputs():
    """3 keyframe slots (0 and 1 live, 2 empty) x 4 keypoints = 12 rows;
    4 point slots (0-2 live, 3 culled). Live edges: keyframe 0 sees points
    0, 1, 2 (point 2 with a right-image column), keyframe 1 sees 0 and 1: 5
    edges, 1 stereo. Rows that count nothing: a keypoint with no point, one
    of the culled point, one whose keypoint is not valid, and the empty
    keyframe's rows, which name live points."""
    K, N, P = 3, 4, 4
    obs = torch.tensor([[0, 1, 2, -1], [0, 1, 3, 2], [0, 1, 2, 0]], dtype=torch.int32)
    kp = torch.tensor([[1, 1, 1, 1], [1, 1, 1, 0], [1, 1, 1, 1]], dtype=torch.bool)
    ur = torch.full((K, N), -1.0)
    ur[0, 2] = 300.0
    ur[2, :] = 300.0
    return {"kf_obs_point": obs, "kf_kp_valid": kp, "kf_ur": ur,
            "kf_valid": torch.tensor([True, True, False]),
            "pt_valid": torch.tensor([True, True, True, False]),
            "pt_pos": torch.zeros(P, 3)}


def test_live_counts_by_hand():
    c = maps.live_counts(hand_inputs())
    assert c == {"keyframes": 2, "points": 3, "edges": 5, "stereo_edges": 1, "rows": 12,
                 "free_cameras": 1}


def test_step_cost_by_hand():
    c = maps.live_counts(hand_inputs())
    flop, nbytes = roof.step_cost(c, cg_iters=40)
    per_edge = (18 + 7 + 36 + 36 + 25) + 40 * (72 + 9)
    per_row = 3 + 3 + 15 + 15 + 9 + 42 + 12 + 12 + 6 + 36
    per_point = (40 + 18 + 21 + 3) + 40 * 18
    per_camera = (400 + 100) + 40 * (72 + 6 + 72 + 72)
    assert flop == 5 * per_edge + (2 * 5 + 1) * per_row + 3 * per_point + 1 * per_camera
    assert nbytes == 5 * 20 + 1 * 56 + 3 * 24


def test_empty_rows_count_zero():
    inp = hand_inputs()
    big = dict(inp)
    # the same live edges in a table four times as wide and twice as tall
    big["kf_obs_point"] = torch.full((6, 16), -1, dtype=torch.int32)
    big["kf_obs_point"][:3, :4] = inp["kf_obs_point"]
    big["kf_kp_valid"] = torch.zeros((6, 16), dtype=torch.bool)
    big["kf_kp_valid"][:3, :4] = inp["kf_kp_valid"]
    big["kf_ur"] = torch.full((6, 16), -1.0)
    big["kf_ur"][:3, :4] = inp["kf_ur"]
    big["kf_valid"] = torch.tensor([True, True, False, False, False, False])
    a, b = maps.live_counts(inp), maps.live_counts(big)
    assert roof.step_cost(a, 40) == roof.step_cost(b, 40)
    assert b["rows"] == 96


def test_least_time_names_its_bound():
    c = {"edges": 2_600_000, "stereo_edges": 2_000_000, "free_cameras": 1399, "points": 130_000}
    peak = {"fp32_flop_s": 67e12, "hbm_byte_s": 3.35e12}
    t, bound = roof.least_step_s(c, 40, peak)
    flop, nbytes = roof.step_cost(c, 40)
    assert bound == "flop" and t == flop / 67e12 and nbytes / 3.35e12 < t
