"""The port's benchmark (``orbslam2_with_quadrics_tpu_torch/scripts/bench.py``)
on the CPU at a tiny size (96x128 frames, 2 images, 64 features, 3 levels,
a 512-point / 16-slot map, 3 frames), with one PyTorch thread:

- the JSON line's keys are the reference ``bench.py``'s printed keys (read
  from its source), at the top, in ``stage_ms`` and in each
  ``speed_of_light`` entry, plus ``power_limit`` and ``frame_ms``;
- on the CPU every device reading is null, ``platform`` is ``"cpu"``, and
  the model's counts and the host times are finite;
- the masked-Hamming wrapper's calls held to ``chip_smoke.launch_checks``'
  rule (on the CPU the wrapper takes the plain version, so its calls stand
  in for the card's launches);
- without a card the default device fails instead of falling back;
- the cost model's pieces: ``admitted_pairs`` against a direct count, and
  the extraction's FLOP at the default workload by hand.
"""

import ast
import contextlib
import json
import os
import sys

import numpy as np
import pytest
import torch

from orbslam2_with_quadrics_tpu_torch.models import frontend as fe
from orbslam2_with_quadrics_tpu_torch.ops import cuda_kernels
from orbslam2_with_quadrics_tpu_torch.scripts import bench, common

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def reference_keys():
    """The keys of the dict literals the reference ``bench.py`` prints: the
    top level (holds "metric"), ``stage_ms`` (holds "map_pipeline_fused")
    and a ``speed_of_light`` entry (holds "device_ms")."""
    with open(os.path.join(REPO, "bench.py")) as f:
        tree = ast.parse(f.read())
    found = {}
    for node in ast.walk(tree):
        if isinstance(node, ast.Dict) and all(isinstance(k, ast.Constant) for k in node.keys):
            keys = [k.value for k in node.keys]
            for marker in ("metric", "map_pipeline_fused", "device_ms"):
                if marker in keys:
                    found[marker] = set(keys)
    return found["metric"], found["map_pipeline_fused"], found["device_ms"]


@contextlib.contextmanager
def wrapper_calls():
    """Counts the masked-Hamming wrapper's calls inside
    ``chip_smoke.counted_calls``; yields (calls, n_calls, chip_smoke)."""
    saved = sys.modules.get("jax")
    try:
        import chip_smoke as cs
    finally:
        sys.modules["jax"] = saved
    calls = [0]
    orig = cuda_kernels.masked_hamming_best2

    def counted(*a, **k):
        calls[0] += 1
        return orig(*a, **k)

    cuda_kernels.masked_hamming_best2 = counted
    try:
        with cs.counted_calls(False) as (n_calls, _):
            yield calls, n_calls, cs
    finally:
        cuda_kernels.masked_hamming_best2 = orig


@pytest.fixture(scope="module")
def cpu_run():
    wl = common.frame_workload("cpu", n_live_kf=16, n_images=2, h=96, w=128, n_features=64,
                               n_levels=3, n_pts=512, n_kf=16)
    with torch.no_grad(), wrapper_calls() as (calls, n_calls, cs):
        out = bench.main("cpu", 3, wl, reps=1)
    return out, calls[0], dict(n_calls), cs


def test_bench_keys_are_the_reference_keys(cpu_run, capsys):
    out = cpu_run[0]
    top, stages, sol_entry = reference_keys()
    assert set(out) == top | {"power_limit", "frame_ms"}
    assert set(out["stage_ms"]) == stages
    assert set(out["speed_of_light"]) == {"extract", "frame", "tracking_minus_extract_ms",
                                          "note"}
    for k in ("extract", "frame"):
        assert set(out["speed_of_light"][k]) == sol_entry
    assert set(out["frame_ms"]) == {"p50", "p90"}
    json.dumps(out)


def test_bench_on_the_cpu_reports_no_device_reading(cpu_run):
    out = cpu_run[0]
    assert out["platform"] == "cpu" and out["device_kind"] == "cpu"
    assert out["power_limit"] is None
    assert out["tracking_achieved_tflops"] is None and out["mfu_estimate"] is None
    sol = out["speed_of_light"]
    assert sol["tracking_minus_extract_ms"] is None
    for k in ("extract", "frame"):
        e = sol[k]
        assert e["device_ms"] is None and e["sol_ms"] is None and e["pct_of_sol"] is None
        assert e["cost_basis"] == "analytic_model"
        assert np.isfinite(e["gflops"]) and e["gflops"] > 0 and e["mbytes"] > 0
    assert sol["frame"]["gflops"] > sol["extract"]["gflops"]
    stages = {k: v for k, v in out["stage_ms"].items() if k != "note"}
    assert all(np.isfinite(v) and v > 0 for v in stages.values())
    assert 0 < out["fps_amortized"] < out["value"]
    assert out["frame_ms"]["p50"] <= out["frame_ms"]["p90"]
    assert out["kf_every"] == bench.KF_EVERY and out["baseline_fps"] == 45.0


def test_bench_launch_rule(cpu_run):
    _, calls, n_calls, cs = cpu_run
    assert n_calls["frames"] > 3 and n_calls["map_passes"] >= 2
    for ok, what in cs.launch_checks(calls, n_calls):
        assert ok, what


def test_bench_needs_the_card_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        bench.main()


def test_admitted_pairs_and_extract_model():
    g = torch.Generator().manual_seed(0)
    Q, N = 40, 30
    args = (torch.zeros(2, Q, 8, dtype=torch.int32), torch.rand(2, Q, 2, generator=g) * 50,
            torch.full((2, Q), 8.0), torch.randint(0, 4, (2, Q), generator=g, dtype=torch.int32),
            torch.rand(2, Q, generator=g) < 0.8, torch.zeros(N, 8, dtype=torch.int32),
            torch.rand(N, 2, generator=g) * 50,
            torch.randint(0, 4, (N,), generator=g, dtype=torch.int32),
            torch.rand(N, generator=g) < 0.8)
    quv, qrad, qlvl, qvalid, tuv, tlvl, tvalid = (a.numpy() for a in args[1:5] + args[6:])
    want = sum(
        1 for b in range(2) for i in range(Q) for j in range(N)
        if qvalid[b, i] and tvalid[j] and abs(quv[b, i, 0] - tuv[j, 0]) <= qrad[b, i]
        and abs(quv[b, i, 1] - tuv[j, 1]) <= qrad[b, i] and abs(int(tlvl[j]) - int(qlvl[b, i])) <= 1)
    assert bench.admitted_pairs(args) == want > 0
    # the default workload: 480x640 over 8 levels of 1.2, 1,024 keypoints
    cfg = fe.FrontendConfig(height=480, width=640, n_features=1024, n_levels=8,
                            fx=520.9, fy=521.0, cx=325.1, cy=249.7)
    img = torch.zeros(480, 640)
    flops, nbytes = bench.extract_cost(cfg, img, ())
    px = [h * w for h, w in [(480, 640), (400, 533), (333, 444), (278, 370), (231, 309),
                             (193, 257), (161, 214), (134, 179)]]
    circle = 709     # pixels of the 31x31 disc of radius 15
    per_kp = 4 * circle + 512 * 98 + 256 * 17
    assert flops == 8 * sum(px[1:]) + 312 * sum(px) + 1024 * per_kp
    assert nbytes == 480 * 640 * 4
