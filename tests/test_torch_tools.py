"""The port's measuring tools (``orbslam2_with_quadrics_tpu_torch/scripts``)
against the reference package, on the CPU at small sizes, with one PyTorch
thread (module fixture).

- ``bench_ba``: its problem (4 cameras, 256 points, 64 observations each,
  cam-major) carried into the reference's ``ba_solve``: the two final costs
  within 1e-4 relative after 10 LM x 40 PCG; both JSON lines printed with
  the reference's keys.
- ``profile_lba``, ``profile_track``, ``bench_profile``: every stage row
  present and every time finite, each directly timed one > 0 (a prefix
  ablation's deltas are differences of two host times, so on a shared CPU
  only their finiteness is held); the masked-Hamming wrapper's calls held to
  ``chip_smoke.launch_checks``' rule (on the CPU the wrapper takes the plain
  version, so its calls stand in for the card's launches).
- ``train_vocab``: ``collect_descriptors`` at 12 frames x 200 features: the
  reference script's rows, at least 99.5% of them bit-equal (the ORB parity
  bar; measured: one word of 16,512 differs); ``validate_retrieval`` on the shipped
  100k vocabulary loaded in both packages: the same best frame and hits,
  scores within 1e-6; ``main --out`` at k = 4, 2 levels writes an npz that
  both packages' ``vocab.load`` read, and never the shipped asset.
- ``bench_dist_ba``: 2 gloo ranks against the 1-process ``ba_solve`` of the
  same problem, at ``tests/test_torch_dist_ba.py``'s bars (cost 1e-3
  relative, poses 5e-4, points 5e-3).
- Every new module imports without JAX (a subprocess with ``jax`` poisoned).
"""

import contextlib
import importlib.util
import json
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orbslam2_with_quadrics_tpu.ops import ba as jba
from orbslam2_with_quadrics_tpu.ops import vocab as jvocab
from orbslam2_with_quadrics_tpu_torch.ops import ba, cuda_kernels, vocab
from orbslam2_with_quadrics_tpu_torch.parallel import problems
from orbslam2_with_quadrics_tpu_torch.scripts import (bench_ba, bench_dist_ba, bench_profile,
                                                      common, profile_lba, profile_track,
                                                      train_vocab)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NEW_MODULES = ("debug_oab", "bench_ba", "profile_lba", "profile_track", "bench_profile",
               "train_vocab", "bench_dist_ba", "common", "bench", "ab_kernels")


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread while this file runs (restored afterwards): the
    suite runs several worker processes on a few cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def reference_script(name):
    """The reference package's ``scripts/<name>.py`` as a module."""
    spec = importlib.util.spec_from_file_location(f"ref_{name}",
                                                  os.path.join(REPO, "scripts", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def chip_smoke():
    """``chip_smoke`` imported without leaving JAX poisoned in this process."""
    saved = sys.modules.get("jax")
    try:
        import chip_smoke as cs
    finally:
        sys.modules["jax"] = saved
    return cs


@contextlib.contextmanager
def wrapper_calls():
    """Counts the masked-Hamming wrapper's calls (on the CPU it runs the
    plain version) inside ``chip_smoke.counted_calls``; yields (calls,
    n_calls)."""
    cs = chip_smoke()
    calls = [0]
    orig = cuda_kernels.masked_hamming_best2

    def counted(*a, **k):
        calls[0] += 1
        return orig(*a, **k)

    cuda_kernels.masked_hamming_best2 = counted
    try:
        with cs.counted_calls(False) as (n_calls, _):
            yield calls, n_calls
    finally:
        cuda_kernels.masked_hamming_best2 = orig


def assert_launch_rule(calls, n_calls):
    for ok, what in chip_smoke().launch_checks({"masked_hamming_best2": calls[0]}, n_calls):
        assert ok, what


# ---------------------------------------------------------------------------
# bench_ba
# ---------------------------------------------------------------------------

def test_bench_ba_solve_matches_reference():
    prob = bench_ba.build_problem(4, 256, 64, device="cpu")
    np.testing.assert_array_equal(prob.cam_idx.numpy(), np.repeat(np.arange(4), 64))
    assert prob.fixed_cam.tolist() == [1.0, 0.0, 0.0, 0.0] and prob.uvr.shape == (256, 3)
    arrays = problems.problem_to_numpy(prob)
    jprob = jba.BAProblem(**{f: jnp.asarray(getattr(arrays, f).astype(
        np.int32 if f in ("cam_idx", "pnt_idx") else np.float32)) for f in jba.BAProblem._fields})
    _, jcost = jba.ba_solve(jprob, n_iters=10, cg_iters=40, use_huber=True)
    _, cost = ba.ba_solve(prob, n_iters=10, cg_iters=40, use_huber=True)
    c0 = float(ba._edge_terms(prob, 7.815)[5])
    jcost, cost = float(jcost), float(cost)
    assert cost < 0.5 * c0  # the solve converges from the perturbed start
    assert abs(cost - jcost) <= 1e-4 * jcost, (cost, jcost)


def test_bench_ba_prints_both_lines(capsys):
    out = bench_ba.main(3, 128, 32, device="cpu")
    lines = [json.loads(x) for x in capsys.readouterr().out.splitlines()]
    assert [r["metric"] for r in lines] == ["ba_lm_iters_per_sec", "ba_dense_lm_iters_per_sec"]
    for r in lines:
        assert set(r) == {"metric", "value", "unit", "platform", "final_cost"}
        assert r["value"] > 0 and np.isfinite(r["final_cost"]) and r["platform"] == "cpu"
    # the dense solver reaches the PCG solver's cost on the same problem
    assert abs(out[0]["final_cost"] - out[1]["final_cost"]) <= 1e-3 * out[0]["final_cost"]


# ---------------------------------------------------------------------------
# profile_lba, profile_track, bench_profile
# ---------------------------------------------------------------------------

def test_profile_lba_rows():
    out = profile_lba.main("cpu", prob=profile_lba.build_problem(4, 64, 256, device="cpu"))
    names = [n for n, _ in profile_lba.pieces(profile_lba.build_problem(2, 8, 16, device="cpu"))]
    assert list(out["table_ms"]) == names and len(names) == 9
    assert all(np.isfinite(v) and v > 0 for v in out["table_ms"].values())
    assert set(out["ba_solve_dense_ms"]) == {1, 5, 9}
    assert all(np.isfinite(v) and v > 0 for v in out["ba_solve_dense_ms"].values())
    assert np.isfinite(out["per_iter_ms"])
    assert len(out["per_piece_ms"]) == 7 and all(np.isfinite(v)
                                                 for v in out["per_piece_ms"].values())


def test_profile_lba_problem_is_the_references():
    """The same RandomState(0) draws as ``scripts/profile_lba.py:33-45``."""
    prob = profile_lba.build_problem(5, 16, 64, device="cpu")
    rng = np.random.RandomState(0)
    poses = np.tile([1.0, 0, 0, 0, 0, 0, 0], (5, 1)).astype(np.float32)
    poses[:, 4:] += rng.randn(5, 3) * 0.1
    points = rng.uniform([-3, -2, 2], [3, 2, 10], (64, 3)).astype(np.float32)
    uvr = rng.rand(80, 3).astype(np.float32) * 400
    np.testing.assert_array_equal(prob.poses.numpy(), poses)
    np.testing.assert_array_equal(prob.points.numpy(), points)
    np.testing.assert_array_equal(prob.uvr.numpy(), uvr)
    np.testing.assert_array_equal(prob.pnt_idx.numpy(), (np.arange(80) * 7919) % 64)


def small_workload(n_live_kf):
    return common.frame_workload("cpu", n_live_kf=n_live_kf, n_images=2, h=96, w=128,
                                 n_features=64, n_levels=3, n_pts=512, n_kf=16)


def test_profile_track_rows_and_launch_rule():
    wl = small_workload(16)
    with torch.no_grad(), wrapper_calls() as (calls, n_calls):
        out = profile_track.main("cpu", 1, wl)
    assert list(out["cumulative_ms"]) == [n for n, _ in profile_track.prefixes(wl)]
    assert list(out["stage_ms"]) == list(profile_track.DELTAS)
    assert all(np.isfinite(v) and v > 0 for v in out["cumulative_ms"].values())
    assert all(np.isfinite(v) for v in out["stage_ms"].values())
    assert out["stage_ms"]["extract"] > 0 and np.isfinite(out["lm_iter_ms"])
    assert all(v > 0 for v in out["chain_ms"].values())
    # warm + timed calls: prefixes 2-4 and both chains match once each, the
    # full frame twice (one track_frame)
    assert n_calls["frames"] == 3 and n_calls["match"] == 5 * 3
    assert_launch_rule(calls, n_calls)


def test_bench_profile_rows_and_launch_rule():
    wl = small_workload(8)
    with torch.no_grad(), wrapper_calls() as (calls, n_calls):
        out = bench_profile.main("cpu", 1, wl)
    assert list(out) == [n for n, _, _ in bench_profile.stages(wl)] and len(out) == 8
    assert all(np.isfinite(v) and v > 0 for v in out.values())
    assert n_calls["frames"] == 2 * 3 and n_calls["match"] == 2 * 3
    assert_launch_rule(calls, n_calls)


# ---------------------------------------------------------------------------
# train_vocab
# ---------------------------------------------------------------------------

def test_collect_descriptors_equal_reference():
    """The same unique rows at the ORB parity bar of ``test_torch_ops.py``
    (a BRIEF tap can round across a boundary when the two frameworks' trig
    differs in the last bit): measured 1 word of 16,512 different."""
    ref = reference_script("train_vocab").collect_descriptors(12, 200, 120, 160)
    got = train_vocab.collect_descriptors(12, 200, 120, 160, device="cpu")
    assert got.dtype == np.uint32 and got.shape[1] == 8 and len(got) > 1000
    assert abs(len(got) - len(ref)) <= 0.005 * len(ref)
    rows = {r.tobytes() for r in ref}
    assert sum(r.tobytes() in rows for r in got) >= 0.995 * len(ref)
    # sorted as unsigned words, like the reference's rows
    assert np.all(np.diff(got[:, 0].astype(np.int64)) >= 0)


def test_validate_retrieval_on_shipped_vocabulary_equals_reference():
    asset = "vocab_100k.npz"
    jvoc = jvocab.load(os.path.join(REPO, "orbslam2_with_quadrics_tpu", "assets", asset))
    voc = vocab.load(os.path.join(REPO, "orbslam2_with_quadrics_tpu_torch", "assets", asset))
    ref = reference_script("train_vocab").validate_retrieval(jvoc)
    got = train_vocab.validate_retrieval(voc, device="cpu")
    assert set(got) == set(ref)
    for key in ("revisit_top1_hit", "revisit_top5_hit", "best_match_frame"):
        assert got[key] == ref[key], key
    for key in ("score_best", "score_median", "separation"):
        assert abs(got[key] - ref[key]) <= 1e-6, (key, got[key], ref[key])
    assert got["revisit_top5_hit"]


def test_train_vocab_main_writes_an_asset_both_packages_load(tmp_path):
    shipped = [os.path.join(REPO, pkg, "assets", "vocab_100k.npz")
               for pkg in ("orbslam2_with_quadrics_tpu", "orbslam2_with_quadrics_tpu_torch")]
    stamps = [os.stat(p).st_mtime_ns for p in shipped + [os.path.join(REPO, "VOCAB_TRAIN.json")]]
    out = str(tmp_path / "v.npz")
    rep = train_vocab.main(["--frames", "12", "--features", "200", "--height", "120",
                            "--width", "160", "--k", "4", "--levels", "2", "--out", out,
                            "--device", "cpu"])
    assert set(rep) >= {"asset", "words", "k", "levels", "train_descriptors", "train_seconds",
                        "asset_mb", "retrieval"}
    assert rep["words"] == 16 and rep["train_descriptors"] > 1000
    voc = vocab.load(out)
    jvoc = jvocab.load(out)
    assert voc.k == jvoc.k == 4 and voc.levels == jvoc.levels == 2
    for c, jc in zip(voc.centers, jvoc.centers):
        np.testing.assert_array_equal(c.numpy().view(np.uint32), np.asarray(jc))
    np.testing.assert_array_equal(voc.idf.numpy(), np.asarray(jvoc.idf))
    assert stamps == [os.stat(p).st_mtime_ns
                      for p in shipped + [os.path.join(REPO, "VOCAB_TRAIN.json")]]


# ---------------------------------------------------------------------------
# bench_dist_ba
# ---------------------------------------------------------------------------

def test_bench_dist_ba_two_ranks_match_one_process():
    got = bench_dist_ba.run(2, 1024, device="cpu", n_cams=8, n_pts=256, reps=1)
    assert got["backend"] == "gloo" and got["seconds"] > 0
    prob = bench_dist_ba.build(2, 1024, 8, 256)
    ref, cost = ba.ba_solve(prob, n_iters=bench_dist_ba.N_LM_ITERS,
                            cg_iters=bench_dist_ba.CG_ITERS)
    np.testing.assert_allclose(got["cost"], float(cost), rtol=1e-3)
    np.testing.assert_allclose(got["poses"], ref.poses.numpy(), atol=5e-4)
    np.testing.assert_allclose(got["points"], ref.points.numpy(), atol=5e-3)


# ---------------------------------------------------------------------------
# no JAX
# ---------------------------------------------------------------------------

def test_tools_import_without_jax():
    code = (
        "import sys; sys.modules['jax'] = None\n"
        + "".join(f"from orbslam2_with_quadrics_tpu_torch.scripts import {m}\n"
                  for m in NEW_MODULES)
        + "assert not any(m.split('.')[0] in ('jax', 'jaxlib', 'orbslam2_with_quadrics_tpu') "
          "for m in sys.modules if sys.modules[m] is not None)\n"
          "print('ok')\n"
    )
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "ok"
