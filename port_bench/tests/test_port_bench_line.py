"""A whole run at a tiny size on the CPU: the result line, the check's
faults, the control, and a cell added by data alone."""

import json
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from orbslam2_with_quadrics_tpu_torch.models import local_mapping
from orbslam2_with_quadrics_tpu_torch.ops import ba
from port_bench import checks, harness
from port_bench.entries import global_ba

ROOT = Path(harness.__file__).resolve().parents[1]
SEED = 2**31 + 99


def run(cell, seed=SEED, traced=False):
    return harness.run(cell, seed, 0.2, traced, "cpu", log=lambda msg: None)


def test_line_keys(cell):
    line = run(cell)
    assert list(line) == ["correct", "attempted", "failed", "metrics", "device", "checks"]
    assert line["correct"] is True and line["failed"] == 0 and line["attempted"] >= 1
    assert set(line["metrics"]) == {"ba_solve_ms", "setup_s"}
    assert line["metrics"]["ba_solve_ms"]["unit"] == "ms" and line["metrics"]["setup_s"]["unit"] == "s"
    assert all(v["value"] > 0 for v in line["metrics"].values())
    assert set(line["device"]) >= {"platform", "kind", "count", "memory_peak_bytes"}
    assert list(line["checks"]) == list(cell.limits)
    assert all(set(c) == {"value", "limit"} for c in line["checks"].values())
    json.dumps(line)


def test_traced_line_keys(cell):
    line = run(cell, traced=True)
    assert list(line) == ["correct", "attempted", "failed", "metrics", "device", "breakdown", "checks"]
    assert set(line["device"]) >= {"busy_s", "window_s"}
    assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
    # no device trace on the CPU: the readers find nothing and the metrics are left out
    assert line["metrics"] == {}


def _unchanged_step(prob, lam, huber_delta2, cg_iters, group=None):
    cost = ba._edge_terms(prob, huber_delta2, group)[5]
    return prob, cost, torch.zeros((), dtype=torch.bool)


def _half_the_edges(orig):
    def terms(prob, huber_delta2, group=None):
        half = (torch.arange(prob.valid.shape[0]) % 2 == 0).to(prob.valid.dtype)
        out = orig(prob._replace(valid=prob.valid * half), huber_delta2, group)
        return out[:5] + (2.0 * out[5],) + out[6:]       # the mean over the rest, times all
    return terms


def _altered_answer(orig):
    def gba(m, *a, **k):
        out, cost = orig(m, *a, **k)
        pose = out.kf_pose.clone()
        pose[1, 4] += 0.3                                # keyframe 1 moved 30 cm
        return out._replace(kf_pose=pose), cost
    return gba


@pytest.mark.parametrize("fault", ["unchanged_step", "half_the_edges", "altered_answer"])
def test_broken_path_is_not_correct(cell, fault, monkeypatch):
    if fault == "unchanged_step":
        monkeypatch.setattr(ba, "ba_iteration", _unchanged_step)
    elif fault == "half_the_edges":
        monkeypatch.setattr(ba, "_edge_terms", _half_the_edges(ba._edge_terms))
    else:
        monkeypatch.setattr(local_mapping, "run_global_ba", _altered_answer(local_mapping.run_global_ba))
    line = run(cell)
    assert line["correct"] is False


def test_control_is_not_correct(cell):
    """The control: the reference in float32 with TF32 operands, in the
    program's place, fails the cell's limits."""
    with torch.no_grad():
        inp = global_ba.inputs(cell.cfg, cell.mix, 5, "cpu")
        ref = global_ba.reference(inp, cell.cfg, cell.mix)
        ctl = global_ba.reference(inp, cell.cfg, cell.mix, "tf32")
        nums, failed = global_ba.judge(ctl, [ctl["cost"]], ref, inp, cell.limits)
    checked, ok = checks.judge(nums, cell.limits)
    assert not ok, checked


def test_a_cell_added_by_data_alone(tmp_path, make_tiny_cell):
    """A new cell needs a configuration file, a limits file and an entry in
    BENCHMARK.json: no code."""
    shutil.copytree(ROOT / "port_bench", tmp_path / "port_bench",
                    ignore=shutil.ignore_patterns("__pycache__", ".cache", "tests"))
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    cfg = json.loads((ROOT / "port_bench/configs/tum_fr1_desk_rgbd.json").read_text())
    cfg["name"] = "tum_fr1_desk_wide"
    cfg["observations"]["select"] = "nearest"
    (tmp_path / "port_bench/configs/tum_fr1_desk_wide.json").write_text(json.dumps(cfg))
    shutil.copy(ROOT / "port_bench/limits/tum_fr1_desk_rgbd.gba.json",
                tmp_path / "port_bench/limits/tum_fr1_desk_wide.gba.json")
    spec["configs"].append({"name": "tum_fr1_desk_wide", "source": spec["configs"][1]["source"],
                            "file": "port_bench/configs/tum_fr1_desk_wide.json", "reduced": [],
                            "why": "a test"})
    spec["workloads"].append({"name": "tum_fr1_desk_wide.gba", "config": "tum_fr1_desk_wide",
                              "traffic": "gba", "chips": 1, "why": "a test"})
    for m in spec["per_layer"]:
        m["workloads"].append("tum_fr1_desk_wide.gba")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))
    cell = make_tiny_cell("tum_fr1_desk_wide.gba", root=tmp_path)
    assert cell.cfg["observations"]["select"] == "nearest"
    assert [m["name"] for m in cell.per_layer] == ["ba_step_roofline_pct", "device_idle_pct"]
    assert run(cell)["correct"] is True


STUB_ENTRY = '''
import numpy as np
import torch


def inputs(cfg, mix, seed, device):
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    n = int(cfg["n"])
    a = torch.randn((n, n), generator=g, device=device, dtype=torch.float64)
    b = torch.randn((n, 1), generator=g, device=device, dtype=torch.float64)
    return {"A": (a @ a.T + n * torch.eye(n, dtype=torch.float64, device=device)).float(),
            "b": b.float()}


def counts(inp):
    return {"n": inp["A"].shape[0]}


def prepare(inp, cfg, mix, device):
    def call():
        x = torch.linalg.solve(inp["A"], inp["b"])
        return {"x": x}, x
    return call


def reference(inp, cfg, mix):
    return {"x": np.linalg.solve(inp["A"].double().numpy(), inp["b"].double().numpy())}


def judge(answer, records, ref, inp, limits):
    gaps = [float(np.abs(r.double().numpy() - ref["x"]).max()) for r in records]
    return {"x_gap": max(gaps)}, sum(g > limits["x_gap"] for g in gaps)
'''


def test_a_mix_and_an_entry_added_by_data_and_new_files(tmp_path):
    """A cell of another entry, with its own inputs, numbers and end-to-end
    metric, takes only new files and new entries in BENCHMARK.json: the
    harness's files are copied as they are."""
    pb = tmp_path / "port_bench"
    shutil.copytree(ROOT / "port_bench", pb,
                    ignore=shutil.ignore_patterns("__pycache__", ".cache", "tests"))
    (pb / "entries/dense_solve.py").write_text(STUB_ENTRY)
    (pb / "traffic/dense.json").write_text(json.dumps({"entry": "dense_solve", "trace_seconds": 1}))
    (pb / "configs/dense64.json").write_text(json.dumps({"name": "dense64", "n": 64, "reduced": []}))
    (pb / "limits/dense64.dense.json").write_text(json.dumps({"x_gap": 1e-4}))
    (pb / "metrics/solve_ms_max.py").write_text("def read(ctx):\n    return 1e3 * max(ctx.call_s)\n")
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    spec["configs"].append({"name": "dense64", "source": "https://example.org/dense64",
                            "file": "port_bench/configs/dense64.json", "reduced": [], "why": "a test"})
    spec["workloads"].append({"name": "dense64.dense", "config": "dense64", "traffic": "dense",
                              "chips": 1, "why": "a test"})
    spec["end_to_end"].append({"name": "solve_ms_max", "unit": "ms", "better": "lower",
                               "bound": 0.01, "source": "host_clock", "workloads": ["dense64.dense"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))
    code = ("import json; from port_bench import harness; "
            "assert harness.__file__.startswith(%r); "
            "c = harness.load_cell('dense64.dense'); "
            "print(json.dumps(harness.run(c, 2**31 + 5, 0.2, False, 'cpu', log=lambda m: None)))"
            % str(tmp_path))
    out = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    line = json.loads(out.stdout.splitlines()[-1])
    assert line["correct"] is True and line["failed"] == 0 and line["attempted"] >= 1
    assert set(line["metrics"]) == {"ba_solve_ms", "setup_s", "solve_ms_max"}
    assert line["metrics"]["solve_ms_max"]["value"] >= line["metrics"]["ba_solve_ms"]["value"]
    assert list(line["checks"]) == ["x_gap"]
    for f in (ROOT / "port_bench").glob("*.py"):
        assert (pb / f.name).read_bytes() == f.read_bytes()


def test_no_jax_in_a_run():
    """A process that imports the harness, one cell's traffic and entry and
    the port loads no module whose top-level name is JAX's or the JAX
    package's (the port's own name begins with the JAX package's)."""
    code = ("import sys; from port_bench import harness; "
            "c = harness.load_cell('kitti00_stereo.gba'); "
            "import importlib; importlib.import_module('port_bench.entries.' + c.mix['entry']); "
            "import orbslam2_with_quadrics_tpu_torch.models.local_mapping; "
            "print(harness.loaded_forbidden()); "
            "print(sorted({m.split('.')[0] for m in sys.modules if m.startswith('orbslam2')}))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                         timeout=300, check=True).stdout.splitlines()
    assert out[-2] == "[]"
    assert out[-1] == "['orbslam2_with_quadrics_tpu_torch']"


def test_forbidden_names_are_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "orbslam2_with_quadrics_tpu.ops", sys)
    monkeypatch.setitem(sys.modules, "jaxlike", sys)
    assert harness.loaded_forbidden() == ["orbslam2_with_quadrics_tpu"]
    line = {"checks": {}}
    assert harness.finish(line, log=lambda msg: None) == 3


def test_benchmark_json_finds_every_file_by_name():
    import importlib
    import re
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    assert list(spec) == ["command", "paths", "run_seconds", "configs", "workloads", "end_to_end",
                          "per_layer"]
    name = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
    assert 1 <= spec["run_seconds"] <= 51
    for c in spec["configs"]:
        assert name.match(c["name"]) and c["file"].startswith("port_bench/")
        assert json.loads((ROOT / c["file"]).read_text())["reduced"] == c["reduced"]
    for w in spec["workloads"]:
        assert name.match(w["name"]) and len(w["why"]) <= 200 and w["chips"] in (1, 4)
        assert (ROOT / "port_bench/traffic" / f"{w['traffic']}.json").exists()
        assert (ROOT / "port_bench/limits" / f"{w['name']}.json").exists()
        harness.load_cell(w["name"])
    for m in spec["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    for m in spec["per_layer"]:
        reader = importlib.import_module(f"port_bench.metrics.{m['name']}")
        assert callable(reader.read) and len(m["layer"]) <= 200
        assert m["moves"] in {e["name"] for e in spec["end_to_end"]}


def test_readings_row(cell):
    """The readings that limits are set from: the port's two calls and the
    reference in float32 hold the limits, the control does not."""
    from port_bench import readings
    row = readings.read_seed(cell, 2**31 + 17, "cpu", ("tf32", "float32"))
    assert row["inputs"]["edges"] > 0 and row["reference_cost"] > 0
    for tag in ("port", "port2", "float32"):
        assert checks.judge(row[tag], cell.limits)[1], (tag, row[tag])
    assert not checks.judge(row["tf32"], cell.limits)[1], row["tf32"]
