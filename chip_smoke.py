"""GPU smoke run of the PyTorch/CUDA port (needs one CUDA card).

    python3 chip_smoke.py

Phases (any failure exits non-zero before the result line):
  1. torch version, device name, card name and power limit (nvidia-smi);
  2. build the six CUDA kernels from ``orbslam2_with_quadrics_tpu_torch/csrc``
     (``masked_hamming_best2``, ``pose_lm``, ``orb_detect``, ``orb_describe``,
     ``ba_dense_terms``, ``ba_schur_sweep``), one ``nvcc`` per source, started
     together;
  3. each kernel against its plain PyTorch version on the card at the main
     path's shapes: the Hamming kernel bit-exact (single and batched, tie /
     all-masked / ragged cases); ``pose_lm`` at stage A's 2 x 3 and stage
     B's 4 x 5 schedules, 1024 mono and 2048 stereo rows (each timed with
     its time a dependent link, ``lm_links``), 3000 rows (past the 2048 it
     keeps in registers), 0-2 valid rows
     and points behind the camera (the pose within 1e-4, masks equal but for
     rows within 1e-3 of their gate; fewer than 3 valid rows within 1e-3
     and 1e-2 px on their reprojections); ``orb_detect`` bit-exact at
     480x640 / 8 levels and 1226x370, rendered and tie-heavy;
     ``orb_describe`` at the same shapes (angles within 1e-5 rad, the words
     bit-equal wherever the angles are, at least 99.5% of the valid
     keypoints bit-equal, every one on a one-level integer image);
     ``ba_schur_sweep``'s two sweeps at the benchmark's tables (KITTI 00's
     4,096,000 rows, 65% live; TUM fr1/desk's 512,000, 5.7% live) within
     1e-4 of the sum of their terms' magnitudes of the plain version, and
     its launches in one ``run_global_ba`` exactly steps x (2 x cg_iters +
     2) = 1,230; the global BA's PCG as one CUDA graph a solve on the
     benchmark's two maps against the eager PCG from the same step inputs
     (dc within ``GRAPH_DC_BAR`` of its magnitude, a dropped iteration and
     each stale buffer caught by that bar), a whole ``run_global_ba`` by
     both routes (final costs within the cell's ``cost_gap``, 1,230
     launches each, no memory left allocated, the graph's repeated with no
     growth of the reserve), and one ``async_gba`` closure on its thread
     (its solves graphed) while tracking runs, against the same BA inline;
     and at the timed shapes
     four times of each:
       kernel_ms  device time of the kernel alone (20 launches captured in a
                  CUDA graph, the replay timed between two events, / 20);
       call_ms    what a caller pays per call on an idle card, the Python
                  wrapper included (events around one call);
       plain_ms   the plain PyTorch version, timed like call_ms;
       bound_ms   the least time the card could take for this run's inputs
                  (see ``bound_ms``);
  4. place recognition's plain-PyTorch ops (vocabulary descent, sparse BoW
     and database sweep on the shipped vocabulary; Sim3 RANSAC and LM; EPnP
     RANSAC) on the card against the same calls on the CPU, and their times;
     after the mono path, local BA's two solvers on a window of its map
     (``ba_solve_dense``, the card's, against the PCG ``ba_solve``: poses
     within 1e-4, costs within 1e-3 relative; both schedules timed) and
     ``ba_dense_terms`` against its plain version there: at every step of
     the 4 + 6 schedule the camera blocks, coupling and cost within 1e-5
     relative, and the gradients and the point blocks' inverses no further
     from a float64 evaluation than 1e-5 + 4x the plain version's own
     distance; the schedule through the kernels against it through the
     plain version (poses within 1e-4, cost within 1e-3 relative); the
     terms of one LM step timed as the kernels above, each of its three
     launches (terms, slots, cost) on its own by the profiler; after
     the quadric path, ``quadric_ba_solve`` at its edge count, timed;
  5. the port's paths through ``System``, every map tensor on the card, each
     over a synthetic sequence, checked against ground truth, with the
     kernels' launch counts from that run alone (the Hamming kernel more
     than 0, at most 2 per tracked frame, 2 per mapping pass and 1 per
     mutual match, loop-point projection and loop fuse; ``pose_lm`` exactly
     2 per tracked frame; ``orb_detect`` and ``orb_describe`` exactly 1 per
     image; ``ba_dense_terms`` exactly 3 per dense LM step and 1 per dense
     solve, two solves per local BA, launched where a mapping pass ran):
       resume    (run first, so that its warmup pays the process's first-use
                 costs) the mono path with ``System.warmup()`` before frame 0,
                 then at frame 30 ``save_system``, a fresh System and
                 ``load_system`` (the restored map's tensors bit-equal to the
                 saved arrays), frames 30-59; the mono bars, and the TUM /
                 KITTI / keyframe trajectory files read back;
       mono      ``track_monocular`` at the TUM width: 640x480, 1024 features,
                 8 levels, default map pools, 60 frames;
       rgbd      ``track_rgbd`` at the TUM width with TUM1.yaml's bf = 40 and
                 ThDepth = 40, metric depth maps, 40 frames, a keyframe at
                 least every 10; ATE without scale alignment;
       stereo    ``track_stereo`` at the KITTI width: 1226x370, 2048 features,
                 8 levels, baseline 0.2, 128 keyframe and 32,768 point slots,
                 30 frames; metric ATE;
       capacity  a mono run at 320x240 whose keyframe pool has 10 slots: the
                 pool must compact or double and the run end OK, once
                 through the pipelined path and once through the synchronous
                 one (``ORB_SYNC_TRACK=1``);
       reloc     the kidnap at the TUM width with the shipped 100k-word
                 vocabulary: 30 frames with a keyframe every 2, 3 frames of
                 white noise (LOST), then frames 16-25 again: ``_relocalize``
                 must bring the state back to OK through the kernel;
       loop      ``enable_loop_closing`` and ``async_gba`` at the TUM width,
                 an 8-keyframe local window, 128 keyframe and 32,768 point
                 slots, over one big orbit that leaves the start's view and
                 returns (500 frames, sensor noise 3 grey levels): at least one
                 loop closes, in the second half; ``shutdown()`` applies the
                 background BA; ATE under 6% of the span. Each closure prints
                 its four gates, the Sim3 scale and the time of every stage;
       quadric   ``enable_quadrics`` on the mono path's sequence, each frame
                 with the box of a virtual ellipsoid (projected by the port's
                 ``project_bbox`` under the true pose): at least one landmark
                 initializes, and its boxes re-projected into its keyframes
                 meet the measured ones at a median IoU above 0.5 over at
                 least 3 keyframes; joint BA and ``quadric_init`` timed.
  6. the example drivers: TUM (mono, RGB-D with 16-bit depth), KITTI stereo
     and EuRoC (over the KITTI pairs) datasets written to disk by the port's
     writers; each driver's ``main()`` at its own map pools, every map tensor
     on the card: mono_tum, rgbd_tum and stereo_kitti under 5% ATE of the
     span on their whole sequences, mono_kitti, mono_euroc and stereo_euroc
     on 40 frames, each trajectory file read back, the kernel's launches
     counted per driver under the rule above; then mono_tum through
     ``python -X importtime -m`` on 30 frames, no JAX module imported;
  7. the measuring tools (``orbslam2_with_quadrics_tpu_torch/scripts``), each
     through its ``main`` on the card: ``bench_ba`` (PCG and dense LM
     iterations per second), ``profile_lba``, ``profile_track`` and
     ``bench_profile`` (their kernel launches held to the rule above, a bare
     ``match_by_projection`` call counting 1), ``train_vocab`` at 48 frames x
     1,000 features and 10^4 words (its retrieval must hit the top 5),
     ``debug_oab`` on 300 frames (every row: ``n_reachable`` and
     ``n_window`` at most ``n_frustum``, a live keyframe) and
     ``bench_dist_ba`` at 1 and 2 ranks (the 2-rank cost against
     ``ba_solve``); the phase's seconds on a line of their own;
  8. the benchmark (``scripts/bench.py``, the twin of the JAX package's
     ``bench.py``) through its ``main``: tracking frames per second over 50
     dependent frames, ``fps_amortized``, each stage, the speed-of-light
     table; every stage finite and positive, ``fps_amortized`` under
     ``value``, each share of the bound at most 100%, the kernel's launches
     held to the rule above; its JSON line logged with the card's name and
     power limit;
  9. distributed BA: a 1-rank NCCL ``dist_ba_solve`` against ``ba_solve`` on
     a KITTI-00-scale problem built on the card (1,400 keyframes, 140,000
     points, 5,000,000 stereo edges), timed, with its peak memory; the
     dryrun problem over 2 spawned gloo ranks on CUDA tensors against one
     process; ``dist_score_database`` over those ranks on a [1023 x 16384]
     database. Multi-GPU NCCL scaling is not measured (one card).
The mapping pass takes the accelerator program on every path (the map is on
the card): dense-Schur local BA, and point statistics refreshed over the new
keyframe's covisible neighbourhood only (``update_point_stats_local``).
The orbit's frames render, and the drivers' datasets are written, in a
worker process during the first phases.
The line before the last is a JSON summary of the kernels; the last line is
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import concurrent.futures
import contextlib
import importlib.util
import json
import multiprocessing
import os
import re
import subprocess
import sys
import tempfile
import time

sys.modules["jax"] = None  # the port must never need JAX
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import numpy as np  # noqa: E402
import torch  # noqa: E402

# each kernel of the main path: its source, and the reference function it
# replaces (the one Pallas kernel, the two jitted loops of the frame, and
# the two stages the reference laid out for the TPU: the descriptor stage
# of extract and the dense-Schur local BA's step)
KERNEL_SOURCE = {
    "masked_hamming_best2": "orbslam2_with_quadrics_tpu_torch/csrc/masked_hamming_best2.cu",
    "pose_lm": "orbslam2_with_quadrics_tpu_torch/csrc/pose_lm.cu",
    "orb_detect": "orbslam2_with_quadrics_tpu_torch/csrc/orb_detect.cu",
    "orb_describe": "orbslam2_with_quadrics_tpu_torch/csrc/orb_describe.cu",
    "ba_dense_terms": "orbslam2_with_quadrics_tpu_torch/csrc/ba_dense_terms.cu",
    "ba_schur_sweep": "orbslam2_with_quadrics_tpu_torch/csrc/ba_schur_sweep.cu",
}
KERNEL_REPLACES = {
    "masked_hamming_best2": "orbslam2_with_quadrics_tpu/ops/pallas_kernels.py:115",
    "pose_lm": "orbslam2_with_quadrics_tpu/ops/pose_opt.py:227",
    "orb_detect": "orbslam2_with_quadrics_tpu/ops/orb.py:176",
    "orb_describe": "orbslam2_with_quadrics_tpu/ops/orb.py:366",
    "ba_dense_terms": "orbslam2_with_quadrics_tpu/ops/ba.py:409",
    # replaces no Pallas kernel: the reference's einsum + segment_sum
    "ba_schur_sweep": "orbslam2_with_quadrics_tpu/ops/ba.py:156",
}
KITTI = (1226.0, 370.0)


def log(msg):
    print(msg, flush=True)


def cuda_median_ms(fn, reps: int = 30, warmup: int = 3) -> float:
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


def graph_kernel_ms(fn, launches: int = 20, reps: int = 20) -> float:
    """Device time of one launch made by ``fn``: ``launches`` calls captured
    in a CUDA graph on a side stream, the replay timed between two events."""
    fn()  # build and allocator warm-up outside the capture
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=torch.cuda.Stream()):
        for _ in range(launches):
            fn()
    return cuda_median_ms(graph.replay, reps=reps) / launches


def profiler_kernels_ms(fn, name: str, launches: int = 20) -> dict:
    """{kernel: mean device ms of one launch} of the kernels whose name
    contains ``name`` over ``launches`` calls of ``fn``, from torch.profiler,
    keyed by the kernel's function name."""
    from torch.autograd import DeviceType

    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                            torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(launches):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA and name in e.name:
            key = re.search(r"(\w+)\(", e.name + "(").group(1)
            n, ms = out.get(key, (0, 0.0))
            out[key] = (n + 1, ms + e.time_range.elapsed_us() / 1e3)
    return {k: ms / n for k, (n, ms) in out.items()}


# NVIDIA H100 SXM data sheet: 3.35 TB/s of HBM; 67 TFLOP/s of fp32 outside
# the tensor cores counts an FMA as two, so an add or a compare runs at
# half of it, and gives the boost clock 67e12 / (132 SMs * 128 lanes * 2).
# POPC: 16 results per clock per SM (NVIDIA's table of arithmetic
# throughput per compute capability, column 9.0).
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12 / 2
POPC_PER_S = 16 * 132 * (67e12 / (132 * 128 * 2))


def bound_ms(args, level_tol: int = 1):
    """The least time the card could take for masked_hamming_best2 on these
    inputs: the largest of (a) every input byte read once and every output
    byte written once over the memory rate, (b) the window test, 2
    subtractions and 2 compares for every (valid query, valid target) pair,
    over the fp32 rate, (c) 8 POPC for every pair that this run's data
    admits over the POPC rate. Returns (bound, bound with every pair
    admitted, what bounds it) in ms."""
    from orbslam2_with_quadrics_tpu_torch.scripts.bench import admitted_pairs

    qdesc, quv, qrad, qlvl, qvalid, tdesc, tuv, tlvl, tvalid = args
    rows, n = qrad.numel(), tdesc.shape[-2]
    nbytes = sum(t.numel() * t.element_size() for t in args) + 3 * 4 * rows
    tv = tvalid if tvalid.dim() == qvalid.dim() else tvalid.expand(qvalid.shape[:-1] + (n,))
    tested = int((qvalid.sum(-1) * tv.sum(-1)).sum())
    admitted = admitted_pairs(args, level_tol)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = max(4 * tested / FP32_OPS_PER_S, 8 * admitted / POPC_PER_S) * 1e3
    all_admitted = max(t_bytes, 8 * rows * n / POPC_PER_S * 1e3)
    return max(t_bytes, t_ops), all_admitted, "bytes" if t_bytes > t_ops else "operations"


def hamming_case(Q, N, seed, ties=False, masked=False, dev="cuda", B=None,
                 shared_targets=False, radius=15.0, extent=(640.0, 480.0)):
    """Inputs of masked_hamming_best2 at (Q, N) drawn from ``seed``; with
    ``B`` a batch of B problems, their targets per entry or one shared set.
    ``radius`` (level-0 px) is a number or one number per batch entry;
    ``extent`` is the image size the keypoints spread over."""
    g = torch.Generator(device=dev).manual_seed(seed)
    ql = () if B is None else (B,)
    tl = () if B is None or shared_targets else (B,)

    def ri(lo, hi, shape):
        return torch.randint(lo, hi, shape, generator=g, device=dev, dtype=torch.int64)

    if ties:  # a few distinct descriptors: exact distance ties everywhere
        pool = ri(-2 ** 31, 2 ** 31, (4, 8)).to(torch.int32)
        qdesc, tdesc = pool[ri(0, 4, ql + (Q,))], pool[ri(0, 4, tl + (N,))]
        radius = 400.0
    else:
        qdesc = ri(-2 ** 31, 2 ** 31, ql + (Q, 8)).to(torch.int32)
        tdesc = ri(-2 ** 31, 2 ** 31, tl + (N, 8)).to(torch.int32)
    scale = torch.tensor(extent, device=dev)
    quv = torch.rand(ql + (Q, 2), generator=g, device=dev) * scale
    tuv = torch.rand(tl + (N, 2), generator=g, device=dev) * scale
    qlvl = ri(0, 8, ql + (Q,)).to(torch.int32)
    tlvl = ri(0, 8, tl + (N,)).to(torch.int32)
    sf = 1.2 ** qlvl.to(torch.float32)
    qrad = torch.as_tensor(radius, dtype=torch.float32, device=dev).reshape(-1, 1) * sf
    qvalid = torch.rand(ql + (Q,), generator=g, device=dev) < (0.0 if masked else 0.9)
    tvalid = torch.rand(tl + (N,), generator=g, device=dev) < 0.9
    return (qdesc.contiguous(), quv, qrad.reshape(ql + (Q,)).contiguous(), qlvl, qvalid,
            tdesc.contiguous(), tuv, tlvl, tvalid)


def stage_a_case(seed, n=1024, **kw):
    """The motion-model sweep: the same n queries and targets under the
    15 px and the 30 px window, as a batch of two."""
    one = hamming_case(n, n, seed, **kw)
    q = [torch.stack([t, t]) for t in one[:5]]
    q[2] = torch.stack([one[2], 2.0 * one[2]])
    return tuple(q) + one[5:]


def mutual_case(n, seed, dev="cuda"):
    """``matching.mutual_match``'s launch: a -> b and b -> a as a batch of
    two, an infinite window and all levels 0, so every valid pair is admitted."""
    a = hamming_case(n, n, seed, dev=dev)
    desc = torch.stack([a[0], a[5]])
    valid = torch.stack([a[4], a[8]])
    uv = torch.zeros((2, n, 2), device=dev)
    rad = torch.full((2, n), float("inf"), device=dev)
    lvl = torch.zeros((2, n), dtype=torch.int32, device=dev)
    return (desc, uv, rad, lvl, valid, desc.flip(0).contiguous(), uv, lvl,
            valid.flip(0).contiguous())


def kernel_cases():
    """[(name, inputs, timed)]: the cases held against the plain version;
    the timed ones are the main path's shapes."""
    return [
        ("main-A 1024x1024", hamming_case(1024, 1024, 100), True),
        ("main-B 4096x1024", hamming_case(4096, 1024, 101), True),
        ("ties 1024x1024", hamming_case(1024, 1024, 102, ties=True), False),
        ("all-masked 512x512", hamming_case(512, 512, 103, masked=True), False),
        ("ragged 300x200", hamming_case(300, 200, 104), False),
        ("ragged 1x1000", hamming_case(1, 1000, 105), False),
        ("ragged 257x1", hamming_case(257, 1, 106), False),
        ("stageA B=2 1024x1024", stage_a_case(107), True),
        ("fuse-fwd B=10 1024x1024", hamming_case(1024, 1024, 108, B=10, radius=3.0), True),
        ("fuse-rev B=10 1024x1024", hamming_case(1024, 1024, 109, B=10, radius=3.0,
                                                 shared_targets=True), True),
        # equal minima in different lanes, warps and (N > 1024) chunks
        ("ties B=3 1024x2500", hamming_case(1024, 2500, 110, ties=True, B=3), False),
        ("ragged B=3 300x200", hamming_case(300, 200, 111, B=3,
                                            radius=[15.0, 3.0, 400.0]), False),
        # the stereo path: 2048 features are two 1024-target chunks per warp
        ("stereo-A B=2 2048x2048", stage_a_case(114, 2048, extent=KITTI), True),
        ("stereo-B 4096x2048", hamming_case(4096, 2048, 115, extent=KITTI), True),
        ("stereo-fuse-fwd B=10 2048x2048",
         hamming_case(2048, 2048, 116, B=10, radius=3.0, extent=KITTI), True),
        ("stereo-fuse-rev B=10 2048x2048",
         hamming_case(2048, 2048, 117, B=10, radius=3.0, shared_targets=True,
                      extent=KITTI), True),
        # loop closing: the loop points into the current keyframe (radius
        # 10), into its 13-keyframe covisible group (radius 4, per-entry
        # targets), and the mutual match of two keyframes (both directions
        # as a batch of two, every valid pair admitted)
        ("loop-proj 4096x1024", hamming_case(4096, 1024, 118, radius=10.0), True),
        ("loop-fuse B=13 4096x1024", hamming_case(4096, 1024, 119, B=13, radius=4.0), True),
        ("loop-fuse B=13 4096x2048",
         hamming_case(4096, 2048, 120, B=13, radius=4.0, extent=KITTI), True),
        ("mutual B=2 1024x1024", mutual_case(1024, 121), True),
        ("mutual B=2 2048x2048", mutual_case(2048, 122), True),
    ]


def max_abs_diff(got, ref) -> int:
    return max(int((a.to(torch.int64) - b.to(torch.int64)).abs().max())
               for a, b in zip(got, ref))


def phase_kernels(smi):
    from orbslam2_with_quadrics_tpu_torch.ops import cuda_kernels as ck

    t0 = time.time()
    libs = ck.build_all()  # one nvcc per source, all started together
    ck._launcher()
    log(f"[build] {', '.join(p.name for p in libs.values())} in {time.time() - t0:.2f} s")
    for name, lib in libs.items():
        for line in open(f"{lib}.ptxas.txt").read().splitlines():
            if "registers" in line or "spill" in line:
                log(f"[build] ptxas {name}: {line.strip()}")
    max_err = 0
    times = {}
    cases = kernel_cases()
    for name, args, timed in cases:
        variants = [(name, args)]
        if args[2].dim() == 1:  # every unbatched case also as a batch of one
            variants.append((name + " as B=1", tuple(t[None] for t in args)))
        for vname, vargs in variants:
            got = ck.masked_hamming_best2(*vargs)
            ref = ck.masked_hamming_best2_plain(*vargs)
            torch.cuda.synchronize()
            err = max_abs_diff(got, ref)
            max_err = max(max_err, err)
            n_adm = int((ref[1] < ck._BIG).sum())
            log(f"[kernel] {vname}: max |kernel - plain| = {err}, tolerance 0 "
                f"(bit-exact; {n_adm}/{ref[1].numel()} rows with a candidate)")
            if err != 0:
                raise AssertionError(
                    f"masked_hamming_best2 disagrees with its plain version on {vname}")
        if timed:
            t = {"kernel_ms": graph_kernel_ms(lambda: ck.masked_hamming_best2(*args)),
                 "call_ms": cuda_median_ms(lambda: ck.masked_hamming_best2(*args)),
                 "plain_ms": cuda_median_ms(lambda: ck.masked_hamming_best2_plain(*args),
                                            reps=10)}
            t["bound_ms"], t["bound_all_admitted_ms"], t["bound_by"] = bound_ms(args)
            times[name] = t
            log(f"[kernel] {name}: kernel_ms {t['kernel_ms']:.5f} (graph replay of 20), "
                f"call_ms {t['call_ms']:.5f} (wrapper + kernel), plain_ms {t['plain_ms']:.4f}, "
                f"bound_ms {t['bound_ms']:.5f} by {t['bound_by']} (this run's inputs; "
                f"{t['bound_all_admitted_ms']:.5f} with every pair admitted) ({smi})")
    # every pair admitted: the kernel against the POPC bound
    q = hamming_case(4096, 1024, 112)
    wide = q[:2] + (torch.full_like(q[2], 1e4),) + q[3:4] + (torch.ones_like(q[4]),) \
        + q[5:8] + (torch.ones_like(q[8]),)
    if max_abs_diff(ck.masked_hamming_best2(*wide, level_tol=8),
                    ck.masked_hamming_best2_plain(*wide, level_tol=8)) != 0:
        raise AssertionError("masked_hamming_best2 disagrees with its plain version "
                             "with every pair admitted")
    k_all = graph_kernel_ms(lambda: ck.masked_hamming_best2(*wide, level_tol=8))
    b_all = bound_ms(wide, level_tol=8)
    log(f"[kernel] all-admitted 4096x1024: bit-exact, kernel_ms {k_all:.5f}, bound_ms "
        f"{b_all[0]:.5f} by {b_all[2]} ({smi})")
    # matching.mutual_match on the card against itself on the CPU
    from orbslam2_with_quadrics_tpu_torch.ops import matching
    mc = mutual_case(1024, 123)
    pair = (mc[0][0], mc[4][0], mc[0][1], mc[4][1])
    before = ck.LAUNCHES["masked_hamming_best2"]
    got = matching.mutual_match(*pair, ratio=0.95, th=matching.TH_HIGH + 20)
    if ck.LAUNCHES["masked_hamming_best2"] != before + 1:
        raise AssertionError("mutual_match on CUDA tensors must be one kernel launch")
    ref = matching.mutual_match(*(t.cpu() for t in pair), ratio=0.95,
                                th=matching.TH_HIGH + 20)
    err = max_abs_diff([g.cpu() for g in got], ref)
    log(f"[kernel] mutual_match 1024x1024 (card vs CPU plain): max |diff| = {err}, "
        f"{int((ref[0] >= 0).sum())} mutual matches, 1 launch")
    if err != 0:
        raise AssertionError("mutual_match on the card disagrees with the CPU")
    # one query, one target: what a launch costs before any work is done
    tiny = hamming_case(1, 1, 113)
    log(f"[kernel] launch floor 1x1: kernel_ms "
        f"{graph_kernel_ms(lambda: ck.masked_hamming_best2(*tiny)):.5f} ({smi})")
    args_b = cases[1][1]
    prof = profiler_kernels_ms(lambda: ck.masked_hamming_best2(*args_b), "masked_hamming_best2")
    log(f"[kernel] main-B 4096x1024: torch.profiler by kernel name "
        f"{json.dumps(prof) if prof else 'no device events'} (ms per launch) ({smi})")
    return max_err, times


# instructions of pose_lm's work, an FMA counted as one (at FP32_OPS_PER_S)
# and the known zeros of d(pred)/d(pc) and of the Jacobian left out. One LM
# evaluation of one row in the round's inlier mask:
LM_EVAL_MONO = (
    18      # camera point R p + t (9 FMA), depth clamp (2), 1/z (1), u, v (4), residuals (2)
    + 5     # chi2: e_u^2 + e_v^2 (2), its weight (1), the z > 0.05 gate (2)
    + 7     # d(u, v)/d(camera point): 1/z^2, fx/z, fy/z (3), -fx x/z^2, -fy y/z^2 (4)
    + 2 * 4   # the 3 rotation entries of each Jacobian row (its translation entries are
              # sign flips of d(pred)/d(pc))
    + 2 * 25  # each row's 5 nonzero entries times the weight (5), H's 15 nonzero upper-
              # triangle products (15 FMA), b's 5 (5 FMA)
    + 1)    # the cost
LM_EVAL_STEREO = LM_EVAL_MONO + (
    2       # u_r (1 FMA), its residual (1)
    + 1     # e_r^2 into chi2 (1 FMA)
    + 1     # d(u_r)/dz
    + 4 + 25)  # the u_r Jacobian row and its products
LM_HUBER = 8  # rounds 0-1: compare, clamp, divide, square root, weight product,
              # rho = 2 sqrt(d2 chi2) - d2 (product, square root, FMA)
# one chi2 re-classification of one valid row: projection and residuals, chi2
# and its weight as above, the row's gate (select, compare, and with valid)
LM_CHI2_MONO = 18 + 5 + 3
LM_CHI2_STEREO = LM_CHI2_MONO + 2 + 1
# (the 6x6 Cholesky, solves and retract, ~300 instructions per step on one
# thread, are under 0.1% of the total at N = 1024 and left out)
# operations of one pixel in orb_detect, as the plain version formulates
# them: 16 subtractions and 16 bf16 roundings, the window min and max by
# doubling (2 x 64), the 33-way max, 8 NMS and 4 border compares, the
# threshold compare and select
DETECT_OPS_PER_PIXEL = 210
# instructions of orb_describe's work for one valid keypoint, each multiply
# and add on its own (the build's -fmad=false): the moments (a multiply and
# an add for m01 and for m10 at each of the 709 pixels of the 31x31
# circle), the blur (7 multiplies and 6 adds per output, 31 x 37 vertical
# and 31 x 31 horizontal), each of the 512 taps (4 multiplies, 2 adds, 2
# roundings, 4 clamps), the 256 compares, and about 100 for atan2, cos, sin
DESCRIBE_OPS_PER_KP = 4 * 709 + 13 * (31 * 37 + 31 * 31) + 12 * 512 + 256 + 100
DESCRIBE_PATCH = 37
# instructions of one dense LM step's terms per edge with a valid
# observation (the function's work: each quantity once, -fmad=false): the
# residual (~40) and the Jacobians (~60), the camera blocks (Hcc's 21 upper
# entries and Jc^T W e's 6, a product and an add for each of 3 rows, and
# the 18 weighted entries: 180), the point blocks (Hpp's 6, bp's 3, V's 18:
# 162 and the 9 weighted entries); the cost at the candidate (~45 per edge);
# per observed local slot the sum and the inverse (~60), per (camera, slot)
# pair with an edge VH's 18 products of 3 (90)
BA_TERMS_OPS_PER_EDGE = 40 + 60 + 180 + 171
BA_COST_OPS_PER_EDGE = 45
BA_SLOT_OPS, BA_PAIR_OPS = 60, 90


def lm_case(n, seed, stereo=0.0, extent=(640.0, 480.0), fx=520.0, bf=40.0, n_valid=None,
            behind=0.0, weight=None, dev="cuda"):
    """Inputs of pose_optimization with n rows, drawn from ``seed``: points
    2-12 m ahead over the image, ~1 px noise, 10% of the rows 30 px off,
    levels 0-7, 90% valid, the start 1 cm / 0.6 degree off the truth;
    ``stereo`` of the rows measure u_r (bf > 0), ``n_valid`` keeps that many
    valid rows, ``behind`` puts that share of the points at camera depth
    -0.5..0.05 at the start, ``weight`` replaces the first valid row's
    inverse sigma^2 (a negative one makes the damped systems indefinite)."""
    rng = np.random.RandomState(seed)
    w, h = extent
    K = np.array([fx, fx, w / 2, h / 2], np.float64)
    z = rng.uniform(2.0, 12.0, n)
    z[: int(behind * n)] = rng.uniform(-0.5, 0.05, int(behind * n))
    u, v = rng.uniform(0, w, n), rng.uniform(0, h, n)
    pc = np.stack([(u - K[2]) / fx * z, (v - K[3]) / fx * z, z], 1)
    a = np.array([0.01, -0.02, 0.015])
    th = np.linalg.norm(a)
    W = np.array([[0, -a[2], a[1]], [a[2], 0, -a[0]], [-a[1], a[0], 0]]) / th
    R = np.eye(3) + np.sin(th) * W + (1 - np.cos(th)) * W @ W
    t = np.array([0.05, -0.02, 0.1])
    pw = (pc - t) @ R  # R^T (pc - t), row-wise
    obs = np.stack([u, v, u - bf / z], 1) + rng.randn(n, 3)
    obs[: n // 10] += rng.randn(n // 10, 3) * 30.0
    is_st = (rng.rand(n) < stereo).astype(np.float32)
    obs[:, 2] *= is_st
    inv_s2 = (1.0 / 1.44 ** rng.randint(0, 8, n)).astype(np.float32)
    valid = (rng.rand(n) < 0.9).astype(np.float32)
    if n_valid is not None:
        valid[:] = 0.0
        valid[n // 10: n // 10 + n_valid] = 1.0
    if weight is not None:
        inv_s2[np.flatnonzero(valid)[0]] = weight
    d = np.array([0.006, 0.004, -0.008])
    thd = np.linalg.norm(d)
    Wd = np.array([[0, -d[2], d[1]], [d[2], 0, -d[0]], [-d[1], d[0], 0]]) / thd
    R0 = (np.eye(3) + np.sin(thd) * Wd + (1 - np.cos(thd)) * Wd @ Wd) @ R
    qw = np.sqrt(1.0 + np.trace(R0)) / 2.0
    q = [qw, (R0[2, 1] - R0[1, 2]) / (4 * qw), (R0[0, 2] - R0[2, 0]) / (4 * qw),
         (R0[1, 0] - R0[0, 1]) / (4 * qw)]
    T0 = np.concatenate([q, t + [0.01, -0.01, 0.01]])
    f = lambda x: torch.as_tensor(np.asarray(x, np.float32), device=dev)  # noqa: E731
    return (f(T0), f(K), bf if stereo > 0 else 0.0, f(pw), f(obs), f(is_st), f(inv_s2),
            f(valid))


def lm_instructions(args, rounds: int, iters: int) -> int:
    """pose_lm's work on these inputs in instructions: every evaluation of
    every row in its round's inlier mask (the masks this run's data gives,
    read from the plain version's rounds) and every chi2 pass over the
    valid rows."""
    from orbslam2_with_quadrics_tpu_torch.ops import pose_opt

    masks, orig = [], pose_opt._lm_round

    def spy(R, t, K, bf, points, obs, row_w, w_obs, *rest):
        masks.append(w_obs > 0)
        return orig(R, t, K, bf, points, obs, row_w, w_obs, *rest)

    pose_opt._lm_round = spy
    try:
        pose_opt.pose_optimization_plain(*args, rounds=rounds, iters=iters)
    finally:
        pose_opt._lm_round = orig
    st, valid = args[5] > 0, args[7] > 0
    total = 0
    for r, m in enumerate(masks):
        n_st, n_mono = int((m & st).sum()), int((m & ~st).sum())
        huber = LM_HUBER if r < 2 else 0
        total += (iters + 1) * (n_mono * (LM_EVAL_MONO + huber)
                                + n_st * (LM_EVAL_STEREO + huber))
    total += rounds * (int((valid & ~st).sum()) * LM_CHI2_MONO
                       + int((valid & st).sum()) * LM_CHI2_STEREO)
    return total


def lm_links(rounds: int, iters: int) -> int:
    """pose_lm's dependent links: per LM evaluation (the first of a round
    and one per step) its block-wide reduction and the serial solve after
    it, and each round's chi2 pass: 2 rounds (iters + 1) + rounds. The
    kernel's time over this count is its time a link, the number to hold
    against a barrier plus a shuffle tree (its operation bound means
    nothing for a chain this short)."""
    return 2 * rounds * (iters + 1) + rounds


def lm_near_gate(T, args):
    """Rows whose chi2 at pose T lies within 1e-3 relative of their gate."""
    from orbslam2_with_quadrics_tpu_torch.ops import lie, pose_opt, residuals

    _, K, bf, pts, obs, is_st, inv_s2, valid = args
    row_w = pose_opt._row_weights(is_st)
    chi2 = pose_opt._chi2_mat(lie.quat_to_matrix(T[:4]), T[4:7], K, bf, pts, obs, row_w,
                              (valid > 0).to(torch.float32) * inv_s2)
    gate = torch.where(is_st > 0, residuals.CHI2_STEREO, residuals.CHI2_MONO)
    return torch.abs(chi2 - gate) <= 1e-3 * gate


def lm_reproj_diff(Ta, Tb, args) -> float:
    """Largest difference in px between the valid rows' predicted (u, v,
    u_r) at the poses Ta and Tb."""
    from orbslam2_with_quadrics_tpu_torch.ops import lie, pose_opt

    _, K, bf, pts, *_, valid = args
    pa, pb = (pose_opt._project_mat(lie.quat_to_matrix(T[:4]), T[4:7], K, bf, pts)[1]
              for T in (Ta, Tb))
    keep = valid > 0
    return float(torch.abs(pa - pb)[keep].max()) if bool(keep.any()) else 0.0


def time_pose_lm(name, args, rounds, iters, smi):
    """``pose_lm`` on the card at these inputs: ``kernel_ms`` (graph replay
    of 20 launches), ``call_ms``, ``plain_ms``, ``bound_ms`` and the time a
    dependent link (``lm_links``)."""
    from orbslam2_with_quadrics_tpu_torch.ops import pose_opt

    n = args[3].shape[0]
    nbytes = sum(a.numel() * a.element_size() for a in args if torch.is_tensor(a))
    nbytes += 7 * 4 + n + 4
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = lm_instructions(args, rounds, iters) / FP32_OPS_PER_S * 1e3
    fn = lambda: pose_opt.pose_optimization(*args, rounds=rounds, iters=iters)  # noqa: E731
    t = {"kernel_ms": graph_kernel_ms(fn), "call_ms": cuda_median_ms(fn),
         "plain_ms": cuda_median_ms(lambda: pose_opt.pose_optimization_plain(
             *args, rounds=rounds, iters=iters), reps=5, warmup=1),
         "bound_ms": max(t_bytes, t_ops),
         "bound_by": "bytes" if t_bytes > t_ops else "operations"}
    t["link_us"] = 1e3 * t["kernel_ms"] / lm_links(rounds, iters)
    log(f"[kernel] pose_lm {name}: kernel_ms {t['kernel_ms']:.5f} (graph replay of 20), "
        f"call_ms {t['call_ms']:.5f}, plain_ms {t['plain_ms']:.4f}, bound_ms "
        f"{t['bound_ms']:.6f} by {t['bound_by']}; {t['link_us']:.3f} us a link "
        f"({lm_links(rounds, iters)} dependent links) ({smi})")
    return t


def quantized_frame(h, w, seed, levels=5):
    """A blocky texture quantized to a few grey levels: ties everywhere."""
    rng = np.random.RandomState(seed)
    img = np.kron(rng.rand(h // 4 + 2, w // 4 + 2), np.ones((4, 4)))[:h, :w]
    img = img + 0.3 * rng.rand(h, w)
    return (np.round(img * (levels - 1)) * (240.0 / (levels - 1))).astype(np.float32)


def phase_frame_kernels(smi, device="cuda"):
    """The main path's two frame kernels against their plain versions on the
    card: ``pose_lm`` at stage A's 2 x 3 and stage B's 4 x 5 schedules, N =
    1024 mono and N = 2048 stereo rows, N = 3000 (rows past those the kernel
    keeps in registers), and the degenerate cases (0, 1, 2
    valid rows; points at or behind the camera; damped systems that are
    indefinite, whose steps both reject): the pose within 1e-4, the
    inlier masks equal but for rows within 1e-3 of their gate, n_inliers
    within that count; ``orb_detect`` bit-exact at 480x640 / 8 levels /
    1,024 features and at 1226x370 / 2,048 features, on a rendered frame and
    on a tie-heavy quantized one. Each launch adds exactly 1 to its count.
    Timed at the main path's shapes: ``kernel_ms`` (CUDA-graph replay of 20
    launches / 20), ``call_ms``, ``plain_ms``, ``bound_ms``. Returns
    {kernel: (max error, {shape: times})}. A rehearsal on the CPU
    (``device="cpu"``) holds the plain versions against themselves and
    times nothing."""
    from orbslam2_with_quadrics_tpu_torch.ops import cuda_kernels as ck
    from orbslam2_with_quadrics_tpu_torch.ops import orb, pose_opt
    from orbslam2_with_quadrics_tpu_torch.utils import synthetic

    t_phase = time.time()
    cuda = device == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    out = {}
    # ---- pose_lm
    lm_cases = [  # name, inputs, schedule, timed
        ("stageA mono 1024", lm_case(1024, 200, dev=device), (2, 3), True),
        ("stageB mono 1024", lm_case(1024, 201, dev=device), (4, 5), True),
        ("stageA stereo 2048", lm_case(2048, 202, stereo=0.6, extent=KITTI, fx=718.0,
                                       bf=387.0, dev=device), (2, 3), True),
        ("stageB stereo 2048", lm_case(2048, 203, stereo=0.6, extent=KITTI, fx=718.0,
                                       bf=387.0, dev=device), (4, 5), True),
        ("0 valid", lm_case(1024, 204, n_valid=0, dev=device), (4, 5), False),
        ("1 valid", lm_case(1024, 205, n_valid=1, dev=device), (4, 5), False),
        ("2 valid", lm_case(1024, 206, n_valid=2, dev=device), (4, 5), False),
        ("2 valid stereo", lm_case(1024, 207, n_valid=2, stereo=1.0, dev=device), (2, 3), False),
        ("points behind 20%", lm_case(1024, 208, behind=0.2, dev=device), (4, 5), False),
        ("indefinite (a row of weight -1)", lm_case(1024, 209, n_valid=3, weight=-1.0,
                                                    dev=device), (2, 3), False),
        ("3000 rows (past the registers)", lm_case(3000, 210, stereo=0.3, dev=device), (4, 5),
         False),
    ]
    max_err, times = 0.0, {}
    for name, args, (rounds, iters), timed in lm_cases:
        n0 = ck.LAUNCHES["pose_lm"]
        got = pose_opt.pose_optimization(*args, rounds=rounds, iters=iters)
        ref = pose_opt.pose_optimization_plain(*args, rounds=rounds, iters=iters)
        sync()
        if ck.LAUNCHES["pose_lm"] != n0 + cuda:
            raise AssertionError("pose_optimization on CUDA tensors must be one pose_lm launch")
        err = float(torch.abs(got[0] - ref[0]).max())
        differ = got[1] != ref[1]
        n_diff, off_gate = int(differ.sum()), int((differ & ~lm_near_gate(ref[0], args)).sum())
        dn = abs(int(got[2]) - int(ref[2]))
        # fewer than 3 valid rows do not fix a pose: the free directions move
        # only by damping and rounding, so the bar is on what the rows fix
        # (their reprojections, 1e-2 px) with the pose within 1e-3
        few = int((args[-1] > 0).sum()) < 3
        tol = 1e-3 if few else 1e-4
        px = lm_reproj_diff(got[0], ref[0], args)
        if not few:
            max_err = max(max_err, err)
        log(f"[kernel] pose_lm {name} {rounds}x{iters}: max |T kernel - plain| = {err:.3g} "
            f"(tolerance {tol:g}), valid rows' reprojections within {px:.3g} px, {n_diff} mask "
            f"rows differ ({off_gate} away from their gate), n_inliers {int(got[2])} vs "
            f"{int(ref[2])}")
        if not (err <= tol and (not few or px <= 1e-2) and off_gate == 0 and dn <= n_diff):
            raise AssertionError(f"pose_lm disagrees with its plain version on {name}")
        if timed and cuda:
            times[name] = time_pose_lm(name, args, rounds, iters, smi)
    out["pose_lm"] = (max_err, times)
    # ---- orb_detect
    img_m = synthetic.planar_sequence(n_frames=1, h=480, w=640, fx=520.0, fy=520.0,
                                      seed=3)[0][0]
    img_s = synthetic.planar_sequence_stereo(n_frames=1, h=370, w=1226, fx=718.0, fy=718.0,
                                             seed=5, baseline=0.2)[0][0]
    det_cases = [  # name, image, n_features, timed
        ("480x640 rendered", img_m, 1024, True),
        ("480x640 quantized", quantized_frame(480, 640, 210), 1024, False),
        ("1226x370 rendered", img_s, 2048, True),
        ("1226x370 quantized", quantized_frame(370, 1226, 211), 2048, False),
    ]
    times, det_err = {}, 0.0
    for name, img, n_feat, timed in det_cases:
        h, w = img.shape
        shapes = orb.pyramid_shapes(h, w, 8, 1.2)
        pyr = orb.build_pyramid(torch.as_tensor(np.asarray(img, np.float32), device=device),
                                shapes)
        counts = orb.per_level_counts(n_feat, 8, 1.2)
        n0 = ck.LAUNCHES["orb_detect"]
        got = orb.detect_levels(pyr, counts)
        ref = [torch.cat(parts) for parts in zip(*[
            orb.detect_level_plain(p, c) for p, c in zip(pyr, counts)])]
        sync()
        if ck.LAUNCHES["orb_detect"] != n0 + cuda:
            raise AssertionError("detect_levels on CUDA tensors must be one orb_detect launch")
        same = all(g.dtype == r.dtype and g.shape == r.shape and torch.equal(g, r)
                   for g, r in zip(got, ref))
        err = max(float(torch.abs(g.double() - r.double()).max()) for g, r in zip(got, ref))
        det_err = max(det_err, err)
        log(f"[kernel] orb_detect {name}: bit-exact {same}, max |kernel - plain| = {err} over "
            f"yx, score and valid (tolerance 0; all {len(ref[2])} slots, "
            f"{int(ref[2].sum())} valid)")
        if not same or err != 0:
            raise AssertionError(f"orb_detect disagrees with its plain version on {name}")
        if timed and cuda:
            plan = orb.detect_plan(tuple(shapes), tuple(counts), 32, "cuda")
            out_v = torch.full((8, plan.width), -float("inf"), device="cuda")
            out_yx = torch.empty((8, plan.width, 2), dtype=torch.int32, device="cuda")
            px = sum(a * b for a, b in shapes)
            slots = sum(t[3] * t[2] * t[5] for t in plan.table)
            t_bytes = (4 * px + 12 * slots) / HBM_BYTES_PER_S * 1e3
            t_ops = DETECT_OPS_PER_PIXEL * px / FP32_OPS_PER_S * 1e3
            t = {"kernel_ms": graph_kernel_ms(
                     lambda: orb.orb_detect_launch(pyr, plan, 20.0, 7.0, out_v, out_yx)),
                 "call_ms": cuda_median_ms(lambda: orb.detect_levels(pyr, counts)),
                 "plain_ms": cuda_median_ms(lambda: [orb.detect_level_plain(p, c) for p, c in
                                                     zip(pyr, counts)], reps=5, warmup=1),
                 "bound_ms": max(t_bytes, t_ops),
                 "bound_by": "bytes" if t_bytes > t_ops else "operations"}
            times[name] = t
            log(f"[kernel] orb_detect {name}: kernel_ms {t['kernel_ms']:.5f} (graph replay of "
                f"20; {plan.n_cells} cells), call_ms {t['call_ms']:.5f} (the kernel and the "
                f"levels' top-n glue), plain_ms {t['plain_ms']:.4f}, bound_ms "
                f"{t['bound_ms']:.6f} by {t['bound_by']} ({smi})")
    out["orb_detect"] = (det_err, times)
    out["orb_describe"] = describe_checks(smi, device, img_m, img_s)
    log(f"[kernel] frame kernels phase seconds {time.time() - t_phase:.1f}")
    return out


def describe_args(pyr, counts):
    """``orb.describe``'s arguments from the detection of ``pyr``."""
    from orbslam2_with_quadrics_tpu_torch.ops import orb

    yx, _, valid = orb.detect_levels(pyr, counts)
    lvl = torch.cat([torch.full((c,), l, dtype=torch.int64, device=pyr[0].device)
                     for l, c in enumerate(counts)])
    return yx[:, 0], yx[:, 1], lvl, valid


def describe_angle_f64(pyr, kp_y, kp_x, lvl_ids, valid):
    """The orientation of each keypoint from its moments summed in float64
    (the patch cut as ``describe_plain`` cuts it): what both routes' float32
    sums approximate."""
    from orbslam2_with_quadrics_tpu_torch.ops import orb

    h0, w0 = pyr[0].shape
    canvas = torch.stack([torch.nn.functional.pad(p, (0, w0 - p.shape[1], 0, h0 - p.shape[0]))
                          for p in pyr]).double()
    # the 31x31 centre of the 37x37 patch, whose start clamps into the canvas
    y0 = torch.clamp(torch.where(valid, kp_y, orb.EDGE_THRESHOLD) - 18, 0, h0 - 37) + 3
    x0 = torch.clamp(torch.where(valid, kp_x, orb.EDGE_THRESHOLD) - 18, 0, w0 - 37) + 3
    i = torch.arange(31, device=canvas.device)
    raw = canvas[lvl_ids[:, None, None], (y0[:, None] + i)[:, :, None],
                 (x0[:, None] + i)[:, None, :]].reshape(-1, 961)
    m = raw @ torch.as_tensor(orb._moment_weights(), device=raw.device).double()
    return torch.where(valid, torch.atan2(m[:, 0], m[:, 1]), 0.0)


def describe_checks(smi, device, img_m, img_s):
    """``orb_describe`` against ``describe_plain`` on the card: at 480x640 /
    8 levels / 1,024 features and 1226x370 / 2,048 on the rendered frames,
    at 480x640 on a tie-heavy quantized frame, and on a one-level integer
    frame, where the float32 moment sums are exact. The kernel sums the
    moments in float64: its angles within 1e-6 rad of a float64 evaluation,
    and within 1e-5 rad of the plain version's plus the plain version's own
    distance to that evaluation (its float32 matmul loses up to ~4e-4 rad
    where the moments nearly cancel); the words bit-equal wherever the
    angles are, >= 99.5% of the valid keypoints bit-equal (every one on the
    integer frame); one launch each. Timed at the rendered shapes. Returns
    (the largest angle difference to the plain version, {shape: times})."""
    from orbslam2_with_quadrics_tpu_torch.ops import cuda_kernels as ck
    from orbslam2_with_quadrics_tpu_torch.ops import orb

    cuda = device == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    cases = [  # name, image, levels, n_features, timed, every keypoint bit-equal
        ("480x640 rendered", img_m, 8, 1024, True, False),
        ("1226x370 rendered", img_s, 8, 2048, True, False),
        ("480x640 quantized", quantized_frame(480, 640, 212), 8, 1024, False, False),
        ("480x640 integer, one level", quantized_frame(480, 640, 213), 1, 1024, False, True),
    ]
    times, max_err = {}, 0.0
    for name, img, n_levels, n_feat, timed, exact in cases:
        h, w = img.shape
        shapes = orb.pyramid_shapes(h, w, n_levels, 1.2)
        pyr = orb.build_pyramid(torch.as_tensor(np.asarray(img, np.float32), device=device),
                                shapes)
        args = describe_args(pyr, orb.per_level_counts(n_feat, n_levels, 1.2))
        n0 = ck.LAUNCHES["orb_describe"]
        got = orb.describe(pyr, *args)
        ref = orb.describe_plain(pyr, *args)
        sync()
        if ck.LAUNCHES["orb_describe"] != n0 + cuda:
            raise AssertionError("describe on CUDA tensors must be one orb_describe launch")
        valid = args[3]
        dk = torch.abs(got[0] - ref[0])[valid]
        err = float(dk.max())
        max_err = max(max_err, err)
        same = (got[1] == ref[1]).all(1)
        share = float(same[valid].double().mean())
        bad = int((valid & (got[0] == ref[0]) & ~same).sum())
        zero = bool((got[1][~valid] == 0).all()) and bool((got[0][~valid] == 0).all())
        a64 = describe_angle_f64(pyr, *args)
        k64, p64 = (torch.abs(a.double() - a64)[valid] for a in (got[0], ref[0]))
        beyond = int((dk > 1e-5).sum())
        log(f"[kernel] orb_describe {name}: max |angle kernel - plain| = {err:.3g} rad, "
            f"{beyond} keypoints past 1e-5 (each within 1e-5 + the plain version's own "
            f"distance to a float64 evaluation: {bool((dk <= 1e-5 + p64).all())}); from the "
            f"float64 evaluation: kernel {float(k64.max()):.3g} (tolerance 1e-6), plain "
            f"{float(p64.max()):.3g} rad; {int(valid.sum())} valid keypoints, {share:.5f} of "
            f"them bit-equal (at least {'1' if exact else '0.995'}), {bad} with equal angles "
            f"and different words")
        # (a rehearsal on the CPU holds the plain version against itself)
        if not ((not cuda or bool((k64 <= 1e-6).all())) and bool((dk <= 1e-5 + p64).all())
                and bad == 0
                and zero and share >= (1.0 if exact else 0.995)):
            raise AssertionError(f"orb_describe disagrees with its plain version on {name}")
        if timed and cuda:
            px = 0  # pixels the patches of the valid keypoints cover, each level once
            h0, w0 = shapes[0]
            for l, (hl, wl) in enumerate(shapes):
                sel = valid & (args[2] == l)
                cover = torch.zeros((h0, w0), dtype=torch.bool, device=device)
                i = torch.arange(DESCRIBE_PATCH, device=device)
                y0 = torch.clamp(args[0][sel] - 18, 0, h0 - DESCRIBE_PATCH)
                x0 = torch.clamp(args[1][sel] - 18, 0, w0 - DESCRIBE_PATCH)
                cover[(y0[:, None] + i)[:, :, None], (x0[:, None] + i)[:, None, :]] = True
                px += int(cover[:hl, :wl].sum())
            n = valid.numel()
            t_bytes = (4 * px + 25 * n + 4 * 1024 + 36 * n) / HBM_BYTES_PER_S * 1e3
            t_ops = DESCRIBE_OPS_PER_KP * int(valid.sum()) / FP32_OPS_PER_S * 1e3
            t = {"kernel_ms": graph_kernel_ms(lambda: orb.describe(pyr, *args)),
                 "call_ms": cuda_median_ms(lambda: orb.describe(pyr, *args)),
                 "plain_ms": cuda_median_ms(lambda: orb.describe_plain(pyr, *args), reps=10),
                 "bound_ms": max(t_bytes, t_ops),
                 "bound_by": "bytes" if t_bytes > t_ops else "operations"}
            times[name] = t
            log(f"[kernel] orb_describe {name}: kernel_ms {t['kernel_ms']:.5f} (graph replay "
                f"of 20; {n} keypoints), call_ms {t['call_ms']:.5f}, plain_ms "
                f"{t['plain_ms']:.4f}, bound_ms {t['bound_ms']:.6f} by {t['bound_by']} ({smi})")
    return max_err, times


def wall_ms(fn, reps: int = 3) -> float:
    """Median host time of ``fn`` with the device drained before and after:
    what a host-bound stage costs its caller."""
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append(1e3 * (time.perf_counter() - t))
    return float(np.median(times))


def phase_solvers(smi):
    """Place recognition's plain-PyTorch ops (no TPU kernel stands behind
    them) at the main path's shapes: each result on the card is held against
    the same call on the CPU, then timed, for a later change to judge them."""
    from orbslam2_with_quadrics_tpu_torch.models import system as sysm
    from orbslam2_with_quadrics_tpu_torch.ops import camera, lie, pnp, sim3solver, vocab

    g = torch.Generator().manual_seed(0)
    n, n_kf = 1024, 256

    def both(fn, *args):
        return fn(*args), fn(*(a.cuda() if torch.is_tensor(a) else a for a in args))

    # the shipped vocabulary: descent, sparse BoW, the database sweep
    asset = sysm._default_vocab_asset()
    voc_c, voc = vocab.load(asset), vocab.load(asset, device="cuda")
    desc = torch.randint(-2 ** 31, 2 ** 31, (n_kf * n, 8), generator=g).to(torch.int32)
    valid = torch.rand(n_kf * n, generator=g) < 0.9
    (w_c, _), (w, _) = (vocab.transform(v, d, ok) for v, d, ok in
                        ((voc_c, desc, valid), (voc, desc.cuda(), valid.cuda())))
    if not torch.equal(w_c, w.cpu()):
        raise AssertionError("vocabulary descent on the card disagrees with the CPU")
    w = w.reshape(n_kf, n)
    bows = [vocab.sparse_bow(row, voc.idf) for row in w]
    wid, wval = torch.stack([b[0] for b in bows]), torch.stack([b[1] for b in bows])
    live = torch.ones(n_kf, dtype=torch.bool)
    sc_c, sc = both(vocab.sparse_l1_scores, wid.cpu(), wval.cpu(), wid[3].cpu(), wval[3].cpu(),
                    live)
    err = float((sc[0].cpu() - sc_c[0]).abs().max())
    if err > 1e-5 or not torch.equal(sc[1].cpu(), sc_c[1]) or int(sc[0].argmax()) != 3:
        raise AssertionError(f"database scores on the card disagree with the CPU ({err})")
    d1, v1 = desc[:n].cuda(), valid[:n].cuda()
    log(f"[solver] vocabulary {voc.n_words} words: transform (1024 descriptors) "
        f"{wall_ms(lambda: vocab.transform(voc, d1, v1)):.3f} ms, sparse_bow "
        f"{wall_ms(lambda: vocab.sparse_bow(w[0], voc.idf)):.3f} ms, sparse_l1_scores over "
        f"{n_kf} keyframes {wall_ms(lambda: vocab.sparse_l1_scores(wid, wval, wid[3], wval[3], live.cuda())):.3f} ms; "
        f"scores within {err:.1e} of the CPU's ({smi})")

    # Sim3 RANSAC and LM on 1024 pairs with 20% outliers, the same draw on both
    K = torch.tensor([520.0, 520.0, 320.0, 240.0])
    p1 = torch.rand(n, 3, generator=g) * torch.tensor([4.0, 3.0, 6.0]) \
        + torch.tensor([-2.0, -1.5, 3.0])
    S_true = lie.sim3_exp(torch.tensor([0.05, -0.03, 0.08, 0.4, -0.1, 0.2, 0.15]))
    p2 = lie.sim3_apply(S_true, p1)
    uv1, uv2 = camera.project(K, p1)[0], camera.project(K, p2)[0]
    p2 = torch.where(torch.rand(n, 1, generator=g) < 0.2,
                     p2 + 2.0 * torch.randn(n, 3, generator=g), p2)
    ok, one = torch.ones(n, dtype=torch.bool), torch.ones(n)
    sel = sim3solver.sample_minimal_sets(ok, 128, 3, g)
    sim_args = (p1, p2, ok, K, K, uv1, uv2, one, one)
    r_c, r = both(lambda *a: sim3solver.ransac_sim3(*a[:-1], sel=a[-1]), *sim_args, sel)
    cu = [a.cuda() for a in sim_args]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    o = sim3solver.optimize_sim3(r[0], cu[0], cu[1], r[1], *cu[3:])
    torch.cuda.synchronize()
    first_ms = 1e3 * (time.perf_counter() - t0)
    o_c = sim3solver.optimize_sim3(r_c[0], p1, p2, r_c[1], K, K, uv1, uv2, one, one)
    err = float((o[0].cpu() - o_c[0]).abs().max())
    off = float(torch.linalg.norm(lie.sim3_log(lie.sim3_compose(
        o_c[0], lie.sim3_inverse(S_true)))))
    if err > 1e-3 or off > 5e-3 or abs(int(o[2]) - int(o_c[2])) > 2:
        raise AssertionError(f"optimize_sim3 on the card: {err} from the CPU's, {off} from truth")
    log(f"[solver] ransac_sim3 (128 x 3 of 1024 pairs) "
        f"{wall_ms(lambda: sim3solver.ransac_sim3(*cu, sel=sel)):.2f} ms; optimize_sim3 "
        f"(10 LM steps): first call in this phase {first_ms:.0f} ms (after the resume path's "
        f"warmup, which set forward-mode AD up), then "
        f"{wall_ms(lambda: sim3solver.optimize_sim3(r[0], cu[0], cu[1], r[1], *cu[3:])):.2f} ms; "
        f"{int(o[2])} inliers, Sim3 within {err:.1e} of the CPU's ({smi})")

    # EPnP RANSAC on 1024 matches with 30% outliers
    T_true = lie.se3_exp(torch.tensor([0.1, -0.05, 0.15, 0.3, -0.2, 0.1]))
    pw = p1 + torch.tensor([0.0, 0.0, 1.0])
    uv = camera.project(K, lie.se3_apply(T_true, pw))[0]
    uv = torch.where(torch.rand(n, 1, generator=g) < 0.3,
                     uv + 60.0 * torch.randn(n, 2, generator=g), uv)
    sel4 = sim3solver.sample_minimal_sets(ok, 256, 4, g)
    q_c, q = both(lambda *a: pnp.ransac_pnp(*a[:-1], sel=a[-1]), pw, uv, ok, K, one, sel4)
    off = float(torch.linalg.norm(lie.se3_log(lie.se3_compose(
        q[0].cpu(), lie.se3_inverse(T_true)))))
    if off > 0.01 or abs(int(q[2]) - int(q_c[2])) > 2:
        raise AssertionError(f"ransac_pnp on the card: {off} from truth, {int(q[2])} inliers "
                             f"against the CPU's {int(q_c[2])}")
    pc = [a.cuda() for a in (pw, uv, ok, K, one)]
    log(f"[solver] ransac_pnp (256 x 4 of 1024 matches, 7 seeds each) "
        f"{wall_ms(lambda: pnp.ransac_pnp(*pc, sel=sel4)):.2f} ms; {int(q[2])} inliers, pose "
        f"{off:.1e} from truth ({smi})")


# the paths chip_smoke drives, by name: the arguments of ``main_path_setup``
# and the run's bar. ``ate_max`` is a share of the ground truth's span after
# a sim(3) alignment (mono) or metres without scale alignment (metric).
PATHS = {
    "mono": dict(sensor="mono", h=480, w=640, n_features=1024, n_levels=8, n_frames=60,
                 fx=520.0, min_tracked=40, min_kf=3, ate_max=0.05, metric=False),
    # the reference's TUM1.yaml: bf = 40, ThDepth = 40; depth maps in metres.
    # The forced keyframe cadence is 10 frames, not the 30 of a 30 fps
    # camera: the sequence is 40 frames long and has to run mapping passes
    "rgbd": dict(sensor="rgbd", h=480, w=640, n_features=1024, n_levels=8, n_frames=40,
                 fx=520.0, bf=40.0, sys_kw=dict(max_frames_between_kf=10),
                 min_tracked=30, min_kf=3, ate_max=0.05, metric=False, scale_free=True),
    # KITTI width (the reference's KITTI00-02.yaml frame), baseline 0.2
    "stereo": dict(sensor="stereo", h=370, w=1226, n_features=2048, n_levels=8,
                   n_frames=30, fx=718.9, bf=0.2 * 718.9, seed=5,
                   map_kw=dict(max_keyframes=128, max_points=32768),
                   sys_kw=dict(max_frames_between_kf=5),
                   min_tracked=25, min_kf=3, ate_max=0.15, metric=True),
    # a keyframe pool of 10 slots under the densest insertion
    "capacity": dict(sensor="mono", h=240, w=320, n_features=512, n_levels=4, n_frames=24,
                     fx=260.0, seed=11, map_kw=dict(max_keyframes=10, max_points=8192),
                     sys_kw=dict(kf_idle_frames=1, max_frames_between_kf=2),
                     min_tracked=18, min_kf=3, ate_max=0.12, metric=False, capacity=True),
    # the kidnap: lost on white noise, relocalized on the way back (the
    # shipped vocabulary; loop closing off, the database is kept regardless)
    "reloc": dict(sensor="mono", h=480, w=640, n_features=1024, n_levels=8, n_frames=30,
                  fx=520.0, seed=9, relief=True, kidnap=(3, 16, 26),
                  sys_kw=dict(max_frames_between_kf=2),
                  min_tracked=25, min_kf=6, ate_max=0.05, metric=False),
    # object landmarks on the mono sequence: the virtual ellipsoid of
    # tests/test_system_extended.py:65-73, its boxes under the true poses
    "quadric": dict(sensor="mono", h=480, w=640, n_features=1024, n_levels=8, n_frames=60,
                    fx=520.0, seed=3, sys_kw=dict(enable_quadrics=True),
                    min_tracked=40, min_kf=3, ate_max=0.05, metric=False, quadric=True),
    # the mono path with warmup() before the first frame and a checkpoint at
    # frame 30: save_system, a fresh System, load_system, frames 30-59
    "resume": dict(sensor="mono", h=480, w=640, n_features=1024, n_levels=8, n_frames=60,
                   fx=520.0, seed=3, warmup=True, resume_at=30,
                   min_tracked=40, min_kf=3, ate_max=0.05, metric=False),
    # one big orbit that closes organically; the global BA runs on a thread
    "loop": dict(sensor="mono", h=480, w=640, n_features=1024, n_levels=8, n_frames=500,
                 fx=520.0, seed=3, relief=True, motion="orbit_big", plane_half=6.0,
                 noise=3.0, map_kw=dict(max_keyframes=128, max_points=32768),
                 sys_kw=dict(enable_loop_closing=True, async_gba=True, n_local_kf=8),
                 min_tracked=450, min_kf=10, ate_max=0.06, metric=False, loop=True),
}


RENDER_ARGS = ("h", "w", "n_frames", "fx", "sensor", "bf", "seed", "relief", "motion",
               "plane_half", "noise", "kidnap")


def render_sequence(h=480, w=640, n_frames=60, fx=520.0, sensor="mono", bf=0.0, seed=3,
                    relief=False, motion="strafe", plane_half=3.0, noise=0.0, kidnap=None):
    """A path's synthetic sequence: (frames, ground-truth T_cw), ``frames[i]``
    being the arguments of the sensor's track call: (img,), (img, depth) or
    (left, right). ``kidnap`` = (n, a, b) appends n frames of white noise
    (ground truth None) and then frames a..b-1 again. Numpy only: ``main``
    renders every path's sequence in worker processes while the card works."""
    from orbslam2_with_quadrics_tpu_torch.utils import synthetic

    t0 = time.time()
    kw = dict(n_frames=n_frames, h=h, w=w, fx=fx, fy=fx, seed=seed)
    if sensor == "stereo":
        left, right, poses, _ = synthetic.planar_sequence_stereo(baseline=bf / fx, **kw)
        frames = list(zip(left, right))
    else:
        imgs, poses = zip(*synthetic.planar_stream(
            relief=relief, motion=motion, plane_half=plane_half, noise=noise, **kw))
        K = np.array([fx, fx, w / 2.0, h / 2.0])
        frames = [(im,) for im in imgs]
        if sensor == "rgbd":
            frames = [(im, synthetic.planar_depth(T, K, h, w)) for im, T in zip(imgs, poses)]
    poses = list(poses)
    if kidnap:
        n_noise, a, b = kidnap
        rng = np.random.RandomState(3)
        frames += [(rng.rand(h, w).astype(np.float32) * 255.0,) for _ in range(n_noise)]
        frames += frames[a:b]
        poses += [None] * n_noise + poses[a:b]
    return frames, poses, time.time() - t0


def render_args(name):
    """``render_sequence``'s arguments among a path's."""
    return {k: v for k, v in PATHS[name].items() if k in RENDER_ARGS}


def main_path_setup(device="cuda", n_features=1024, n_levels=8, map_kw=None, sys_kw=None,
                    rendered=None, **render_kw):
    """A path's SystemConfig and its synthetic sequence: (cfg, frames,
    ground-truth T_cw). ``render_kw`` are ``render_sequence``'s arguments;
    ``rendered`` is its result where the sequence was rendered beforehand."""
    from orbslam2_with_quadrics_tpu_torch.models import frontend as fe
    from orbslam2_with_quadrics_tpu_torch.models import map_state as ms
    from orbslam2_with_quadrics_tpu_torch.models import system as sysm

    frames, poses, seconds = rendered or render_sequence(**render_kw)
    r = {**dict(h=480, w=640, fx=520.0, sensor="mono", bf=0.0), **render_kw}
    h, w, fx, sensor = r["h"], r["w"], r["fx"], r["sensor"]
    log(f"[{sensor}] rendered {len(frames)} frames {w}x{h} in {seconds:.1f} s"
        + (" (beforehand, in a worker process)" if rendered else ""))
    cfg = sysm.SystemConfig(
        frontend=fe.FrontendConfig(height=h, width=w, n_features=n_features,
                                   n_levels=n_levels, fx=fx, fy=fx, cx=w / 2.0, cy=h / 2.0,
                                   bf=r["bf"]),
        map=ms.MapConfig(n_features=n_features, n_levels=n_levels, device=device,
                         **(map_kw or {})),
        sensor=sensor, **(sys_kw or {}),
    )
    return cfg, frames, poses


def trajectory_error(traj, poses, with_scale=True):
    """(ATE RMSE after a sim(3) alignment, or a rigid one without scale,
    span of the ground-truth camera centres) of ``System.full_trajectory()``
    output; raises on a non-finite pose."""
    from orbslam2_with_quadrics_tpu_torch.utils import metrics

    traj = [e for e in traj if poses[e[0]] is not None]
    est = [metrics.se3_vec_to_mat(T) for _, _, T in traj]
    if not all(np.isfinite(T).all() for T in est):
        raise AssertionError("non-finite pose in the trajectory")
    c_est = metrics.camera_centers_from_Tcw(est)
    c_gt = metrics.camera_centers_from_Tcw([poses[f] for f, _, _ in traj])
    return (metrics.ate_rmse(c_est, c_gt, with_scale=with_scale),
            float(np.linalg.norm(c_gt.max(0) - c_gt.min(0))))


def relocalized_error(traj_before, poses, T_cw, kidnap, lost):
    """Distance of the relocalized camera centre, mapped to the ground
    truth's frame by the sim(3) alignment of the pre-kidnap trajectory, to
    the nearest return frame's true centre (the pipeline relocalizes one of
    the last two frames it was given)."""
    from orbslam2_with_quadrics_tpu_torch.utils import metrics

    pre = [e for e in traj_before if e[0] not in lost]
    c_est = metrics.camera_centers_from_Tcw([metrics.se3_vec_to_mat(T) for _, _, T in pre])
    c_gt = metrics.camera_centers_from_Tcw([poses[f] for f, _, _ in pre])
    s, R, t = metrics.umeyama_align(c_est, c_gt)
    c = metrics.camera_centers_from_Tcw([metrics.se3_vec_to_mat(T_cw.cpu().numpy())])[0]
    c = s * R @ c + t
    back = metrics.camera_centers_from_Tcw(poses[kidnap[1]:kidnap[2]])
    return float(np.linalg.norm(back - c, axis=1).min())


def _median(xs):
    return float(np.median(xs)) if len(xs) else float("nan")


VIRTUAL_OBJECT = dict(pose=[1.0, 0.0, 0.0, 0.0, 0.4, 0.3, 0.6], scale=[0.25, 0.2, 0.15])


def object_detections(poses, fx, w, h):
    """Per frame the [1, 6] detection (x, y, w, h, 0.9, class 1) of
    ``VIRTUAL_OBJECT`` under the true pose, by the port's ``project_bbox``
    on the CPU; None where it does not project to an ellipse."""
    from orbslam2_with_quadrics_tpu_torch.ops import quadrics
    from orbslam2_with_quadrics_tpu_torch.utils import metrics

    q = quadrics.Quadric(torch.tensor(VIRTUAL_OBJECT["pose"]),
                         torch.tensor(VIRTUAL_OBJECT["scale"]))
    Kc = torch.tensor([fx, fx, w / 2.0, h / 2.0])
    out = []
    for P in poses:
        if P is None:
            out.append(None)
            continue
        b, ok = quadrics.project_bbox(
            q, torch.as_tensor(metrics.mat_to_se3_vec(P), dtype=torch.float32), Kc)
        b = b.numpy()
        out.append(np.asarray([[b[0], b[1], b[2] - b[0], b[3] - b[1], 0.9, 1.0]], np.float32)
                   if bool(ok) else None)
    return out


def box_iou(p, b) -> float:
    ix = max(0.0, min(p[2], b[2]) - max(p[0], b[0]))
    iy = max(0.0, min(p[3], b[3]) - max(p[1], b[1]))
    union = (p[2] - p[0]) * (p[3] - p[1]) + (b[2] - b[0]) * (b[3] - b[1]) - ix * iy
    return float(ix * iy / max(union, 1e-9))


def landmark_ious(slam):
    """Per initialized landmark, the IoU of its box re-projected into each
    of its keyframes with the box measured there."""
    from orbslam2_with_quadrics_tpu_torch.ops import quadrics

    out = []
    kf_pose = slam.map.kf_pose.cpu()
    Kc = slam._K.cpu()
    for lmk in slam.quadrics.landmarks:
        if not lmk.initialized:
            continue
        q = quadrics.Quadric(torch.as_tensor(lmk.pose), torch.as_tensor(lmk.scale))
        ious = []
        for slot, meas in zip(lmk.kf_slots, lmk.bboxes):
            b, ok = quadrics.project_bbox(q, kf_pose[slot], Kc)
            if bool(ok):
                ious.append(box_iou(b.numpy(), meas))
        out.append(ious)
    return out


def stream_sync():
    """Wait for the current stream's work, not the whole device's: the
    async global BA may be capturing its PCG's CUDA graph on its own thread
    meanwhile, and a device-wide synchronize fails any capture under way."""
    torch.cuda.current_stream().synchronize()


@contextlib.contextmanager
def counted_calls(cuda: bool):
    """While the block runs, count the calls that the per-frame launch rule
    allows for: a tracked frame is one ``track_frame`` call
    (relocalization's included), a mapping pass one ``_insert_and_map``
    (pipelined) or ``_insert_keyframe`` (synchronous) call, each of the
    three loop-closing searches is counted by its own function, and a
    ``match_by_projection`` call made outside all of these (by a tool) is
    one call of its own. The frame kernels' calls: ``images`` counts each
    ``orb.extract`` call and each ``orb.detect_level`` call (a tool's bare
    detection), ``pose`` each ``pose_optimization`` call made outside a
    ``track_frame`` call; ``extracts`` each ``orb.extract`` call alone. The
    dense local BA's: ``local_ba`` each ``run_local_ba`` call,
    ``dense_solves`` each ``ba_solve_dense`` and ``dense_steps`` each
    ``_dense_schur_step`` call. On the card
    each mapping pass is timed by two CUDA events. Yields (the counts, the
    mapping passes' event pairs)."""
    from orbslam2_with_quadrics_tpu_torch.models import local_mapping as lm
    from orbslam2_with_quadrics_tpu_torch.models import loop_closing as lc
    from orbslam2_with_quadrics_tpu_torch.models import system as sysm
    from orbslam2_with_quadrics_tpu_torch.models import tracking as tr
    from orbslam2_with_quadrics_tpu_torch.ops import ba, matching, orb, pose_opt

    n_calls = {"frames": 0, "map_passes": 0, "mutual_match": 0, "loop_proj": 0,
               "loop_fuse": 0, "match": 0, "images": 0, "pose": 0, "extracts": 0,
               "local_ba": 0, "dense_solves": 0, "dense_steps": 0}
    map_events = []
    depth = [0]  # > 0 inside one of the counted calls
    patched = [(tr, "track_frame", "frames"), (matching, "mutual_match", "mutual_match"),
               (lc, "project_loop_points", "loop_proj"), (lc, "fuse_loop_points", "loop_fuse")]
    originals = [(mod, attr, getattr(mod, attr)) for mod, attr, _ in patched]
    originals += [(sysm, "_insert_and_map", sysm._insert_and_map),
                  (sysm.System, "_insert_keyframe", sysm.System._insert_keyframe),
                  (matching, "match_by_projection", matching.match_by_projection),
                  (orb, "extract", orb.extract), (orb, "detect_level", orb.detect_level),
                  (pose_opt, "pose_optimization", pose_opt.pose_optimization),
                  (lm, "run_local_ba", lm.run_local_ba),
                  (ba, "ba_solve_dense", ba.ba_solve_dense),
                  (ba, "_dense_schur_step", ba._dense_schur_step)]

    def counted(fn, key):
        def call(*a, **k):
            n_calls[key] += 1
            depth[0] += 1
            try:
                return fn(*a, **k)
            finally:
                depth[0] -= 1
        return call

    def bare(fn, key="match"):  # a call of a tool, outside every counted call
        def call(*a, **k):
            if depth[0] == 0:
                n_calls[key] += 1
            return fn(*a, **k)
        return call

    def each(fn, *keys):  # every call
        def call(*a, **k):
            for key in keys:
                n_calls[key] += 1
            return fn(*a, **k)
        return call

    def timed(fn):  # device time of each mapping pass
        def call(*a, **k):
            n_calls["map_passes"] += 1
            depth[0] += 1
            try:
                if not cuda:
                    return fn(*a, **k)
                ev = (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
                ev[0].record()
                out = fn(*a, **k)
                ev[1].record()
                map_events.append(ev)
                return out
            finally:
                depth[0] -= 1
        return call

    for mod, attr, key in patched:
        setattr(mod, attr, counted(getattr(mod, attr), key))
    matching.match_by_projection = bare(matching.match_by_projection)
    pose_opt.pose_optimization = bare(pose_opt.pose_optimization, "pose")
    orb.extract = each(orb.extract, "images", "extracts")
    orb.detect_level = each(orb.detect_level, "images")
    lm.run_local_ba = each(lm.run_local_ba, "local_ba")
    ba.ba_solve_dense = each(ba.ba_solve_dense, "dense_solves")
    ba._dense_schur_step = each(ba._dense_schur_step, "dense_steps")
    sysm._insert_and_map = timed(sysm._insert_and_map)
    sysm.System._insert_keyframe = timed(sysm.System._insert_keyframe)
    try:
        yield n_calls, map_events
    finally:
        for mod, attr, fn in originals:
            setattr(mod, attr, fn)


def launch_checks(launches: dict, n_calls: dict):
    """The launch rules for the kernels' ``launches`` over the calls
    ``counted_calls`` counted: (ok, what) pairs. masked_hamming_best2: at
    most 2 per tracked frame, 2 per mapping pass and 1 per loop-closing
    search or bare match; pose_lm: exactly 2 per tracked frame and 1 per
    bare pose_optimization call; orb_detect: exactly 1 per image;
    orb_describe: exactly 1 per ``orb.extract`` call (an image);
    ba_dense_terms: exactly 3 per dense LM step (the terms pass, the slot
    pass, the cost at the candidate) and 1 per dense solve (the cost at its
    start), two solves per local BA (every local BA on the card takes the
    dense schedule), and launched wherever a mapping pass ran. The frame
    and mapping kernels' rules apply where ``launches`` counts them (the
    CPU tests pass the Hamming wrapper's calls alone)."""
    n = launches["masked_hamming_best2"]
    most = (2 * n_calls["frames"] + 2 * n_calls["map_passes"] + n_calls["mutual_match"]
            + n_calls["loop_proj"] + n_calls["loop_fuse"] + n_calls["match"])
    checks = [(n > 0, "masked_hamming_best2 launched by the path"),
              (n <= most, f"at most 2 launches per tracked frame, 2 per mapping pass "
                          f"and 1 per mutual match, loop projection, loop fuse and bare "
                          f"match_by_projection call ({n} launches, limit {most})")]
    if "pose_lm" in launches:
        n_lm, want_lm = launches["pose_lm"], 2 * n_calls["frames"] + n_calls["pose"]
        n_det, want_det = launches["orb_detect"], n_calls["images"]
        checks += [
            (n_lm > 0 and n_lm == want_lm,
             f"pose_lm: 2 launches per tracked frame + 1 per bare pose_optimization call "
             f"({n_lm} launches, {want_lm} expected)"),
            (n_det > 0 and n_det == want_det,
             f"orb_detect: 1 launch per image ({n_det} launches, {want_det} images)")]
    if "orb_describe" in launches:
        n_desc, want_desc = launches["orb_describe"], n_calls["extracts"]
        n_ba = launches["ba_dense_terms"]
        want_ba = 3 * n_calls["dense_steps"] + n_calls["dense_solves"]
        checks += [
            (n_desc > 0 and n_desc == want_desc,
             f"orb_describe: 1 launch per image ({n_desc} launches, {want_desc} images)"),
            (n_ba == want_ba and n_calls["dense_solves"] == 2 * n_calls["local_ba"]
             and (n_ba > 0 or n_calls["map_passes"] == 0),
             f"ba_dense_terms: 3 launches per dense LM step and 1 per dense solve, 2 solves "
             f"per local BA, launched where a mapping pass ran ({n_ba} launches, {want_ba} "
             f"expected; {n_calls['dense_steps']} steps, {n_calls['dense_solves']} solves, "
             f"{n_calls['local_ba']} local BAs, {n_calls['map_passes']} mapping passes)")]
    return checks


def span_ms(s: dict) -> float:
    """A span's time: its device time where it ran on the card, else its
    host time (a stage of host work, or the CPU)."""
    return s["device_ms"] if s["device_ms"] is not None else s["host_ms"]


def closure_attempts(spans: list) -> list:
    """One dict per ``lc.attempt_close`` span: its counts (slot, cand, the
    four gates, the Sim3 scale, closed) and ``<stage>_ms`` of each span
    under it (``n_edges`` from the graph correction)."""
    out = []
    for a in (s for s in spans if s["name"] == "lc.attempt_close"):
        rec, under = dict(a["counts"]), {a["id"]}
        for s in sorted(spans, key=lambda s: s["id"]):
            if s["parent"] in under:
                under.add(s["id"])
                rec[s["name"][3:] + "_ms"] = span_ms(s)
                rec.update(s["counts"])
        out.append(rec)
    return out


def run_main_path(name="mono", device="cuda", sync=False, log_every=5, rendered=None,
                  **overrides):
    """Drive one of ``PATHS`` through ``System.track_*`` (``overrides``
    replace its arguments; ``sync`` takes the synchronous path; ``rendered``
    is the sequence where ``render_sequence`` ran beforehand). The
    kernels' launch counts are set to 0 just before the first frame and read
    just after the last. Returns a dict of the run's numbers; raises on any
    failed check."""
    from orbslam2_with_quadrics_tpu_torch.models import quadric_mapping as qm
    from orbslam2_with_quadrics_tpu_torch.models import system as sysm
    from orbslam2_with_quadrics_tpu_torch.ops import cuda_kernels as ck
    from orbslam2_with_quadrics_tpu_torch.ops import quadrics
    from orbslam2_with_quadrics_tpu_torch.utils import tracing

    spec = {**PATHS[name], **overrides}
    bar = {k: spec.pop(k, None) for k in ("min_tracked", "min_kf", "ate_max", "metric",
                                          "scale_free", "capacity", "loop", "quadric")}
    warm, resume_at = spec.pop("warmup", False), spec.pop("resume_at", None)
    kidnap = spec.get("kidnap")
    tag = name + ("-sync" if sync else "")
    spec.setdefault("n_frames", 60)
    cfg, frames, poses = main_path_setup(device, rendered=rendered, **spec)
    cuda = device == "cuda"
    dets = (object_detections(poses, cfg.frontend.fx, cfg.frontend.width, cfg.frontend.height)
            if bar["quadric"] else [None] * len(frames))
    quad_ms = {"joint_ba": [], "quadric_init": []}  # host ms, device drained
    relocs = []  # per _relocalize call: ms, kernel launches, recovered
    calls = contextlib.ExitStack()
    n_calls, map_events = calls.enter_context(counted_calls(cuda))
    originals = [(sysm.System, "_relocalize", sysm.System._relocalize),
                 (qm.QuadricManager, "joint_ba", qm.QuadricManager.joint_ba),
                 (quadrics, "quadric_init", quadrics.quadric_init)]
    relocalize = sysm.System._relocalize

    def timed_relocalize(self, feats):
        if cuda:
            stream_sync()
        n0, t0 = ck.LAUNCHES["masked_hamming_best2"], time.perf_counter()
        ok = relocalize(self, feats)
        if cuda:
            stream_sync()
        relocs.append({"ms": 1e3 * (time.perf_counter() - t0), "recovered": bool(ok),
                       "launches": ck.LAUNCHES["masked_hamming_best2"] - n0})
        return ok

    def host_timed(fn, key):
        def call(*a, **k):
            if cuda:
                stream_sync()
            t0 = time.perf_counter()
            out = fn(*a, **k)
            if cuda:
                stream_sync()
            quad_ms[key].append(1e3 * (time.perf_counter() - t0))
            return out
        return call

    qm.QuadricManager.joint_ba = host_timed(qm.QuadricManager.joint_ba, "joint_ba")
    quadrics.quadric_init = host_timed(quadrics.quadric_init, "quadric_init")
    sysm.System._relocalize = timed_relocalize
    traced = bool(kidnap or bar["loop"])  # the loop closer's stages and the global BA
    tracer = contextlib.ExitStack()
    spans = tracer.enter_context(tracing.collect()) if traced else []
    old_sync = os.environ.get("ORB_SYNC_TRACK")
    os.environ["ORB_SYNC_TRACK"] = "1" if sync else ""
    try:
        slam = sysm.System(cfg)
        step_name = {"mono": "track_monocular", "rgbd": "track_rgbd",
                     "stereo": "track_stereo"}[cfg.sensor]
        step = getattr(slam, step_name)
        first = slam  # the System that initialized (a checkpoint does not hold the frame)
        ok_at = None  # the frame that initialized: a two-view init may take a few
        frame_ms, all_ms, states, n_kf_at, closed_at = [], [], [], [], []
        traj_before = None
        resumed = {}
        if warm:
            resumed["warmup_s"] = slam.warmup()
            log(f"[{tag}] warmup() {resumed['warmup_s']:.2f} s")
            for k in n_calls:  # the path's counts start at its first frame
                n_calls[k] = 0
            map_events.clear()
        ck.reset_launch_counts()
        for i, images in enumerate(frames):
            if kidnap and i == spec["n_frames"]:
                traj_before = slam.full_trajectory()  # the map before the kidnap
            if i == resume_at:
                slam, resumed["checkpoint"] = resume_from_checkpoint(slam, tag)
                step = getattr(slam, step_name)
            t = time.perf_counter()
            before = slam.n_loops_closed
            step(*images, timestamp=i / 30.0, detections=dets[i])
            if cuda:
                stream_sync()
            dt = (time.perf_counter() - t) * 1e3
            all_ms.append(dt)
            states.append(slam.state)
            n_kf_at.append(slam._n_kf_host)
            if slam.n_loops_closed > before:
                closed_at.append(i)
                log(f"[{tag}] loop closed at frame {i}")
            if slam.state == sysm.System.OK:
                if ok_at is None:
                    ok_at = i
                else:  # steady state: the frames after the initializing one
                    frame_ms.append(dt)
            if i % log_every == 0:
                log(f"[{tag}] frame {i:3d} state={slam.state} kfs={int(slam.map.n_kf)} "
                    f"pts={int(slam.map.n_pt)} {dt:.1f} ms")
            if kidnap and i >= spec["n_frames"] + kidnap[0] and slam.state == sysm.System.OK:
                break  # relocalized: the kidnap is over
        gba_running = slam._gba_thread is not None
        slam.shutdown()
        traj = slam.full_trajectory()
        launches = dict(ck.LAUNCHES)
    finally:
        tracer.close()
        for mod, attr, fn in originals:
            setattr(mod, attr, fn)
        calls.close()
        if old_sync is None:
            os.environ.pop("ORB_SYNC_TRACK", None)
        else:
            os.environ["ORB_SYNC_TRACK"] = old_sync
    map_ms = [a.elapsed_time(b) for a, b in map_events]

    metric = bool(bar["metric"] or bar["scale_free"])
    lost = {m["frame"] - 1 for m in slam.metrics if m.get("lost")}
    # a kidnap is judged on the map built before it and on where the
    # relocalized camera lands: the relocalization's loop correction takes
    # the teleport for drift and bends the keyframes after it (as in the
    # reference), so the later poses are no measure of the map
    ate, span = trajectory_error(
        [e for e in (traj_before or traj) if e[0] not in lost], poses, with_scale=not metric)
    tracked = sum(1 for m in slam.metrics if not m.get("lost"))
    out = {
        "path": tag, "sensor": cfg.sensor, "init_frame": first.init_frame_id,
        "tracked": tracked, "n_kf": int(slam.map.n_kf), "kfs_created": slam.n_kfs_created,
        "n_pt": int(slam.map.n_pt), "ate": ate, "span": span, "ate_frac": ate / span,
        "ate_scale_aligned": not metric,
        "frame_ms_median": _median(frame_ms), "map_ms_median": _median(map_ms),
        "n_map_passes": n_calls["map_passes"], "n_frame_steps": n_calls["frames"],
        "n_calls": dict(n_calls), "launches": launches,
        "capacity_events": {k: getattr(slam, k) for k in (
            "n_kf_compactions", "n_kf_growths", "n_point_compactions", "n_point_growths")},
        "pools": [slam.map.kf_valid.shape[0], slam.map.pt_pos.shape[0]],
        "n_loops_closed": slam.n_loops_closed, "closed_at": closed_at,
        "n_reloc_corrections": slam.n_reloc_corrections,
        "n_gba_applied": slam.n_gba_applied, "relocalizations": relocs,
    }
    if warm:
        out["warmup_s"] = resumed["warmup_s"]
        out["first_frame_ms"], out["init_frame_ms"] = all_ms[0], all_ms[ok_at]
        out["first_tracked_frame_ms"] = frame_ms[0]
        log(f"[{tag}] warmup() {resumed['warmup_s']:.2f} s, then frame 0 {all_ms[0]:.2f} ms, "
            f"the initializing frame {ok_at} {all_ms[ok_at]:.2f} ms, the first steady-state "
            f"frame {frame_ms[0]:.2f} ms, median {_median(frame_ms):.2f} ms")
    if resume_at is not None:
        out["checkpoint"] = resumed["checkpoint"]
        out["trajectory_files"] = check_trajectory_files(slam, traj)
    if bar["quadric"]:
        lms = slam.quadrics.landmarks
        ious = landmark_ious(slam)
        out["quadric"] = {
            "landmarks": len(lms), "initialized": sum(lmk.initialized for lmk in lms),
            "bbox_edges": sum(len(lmk.kf_slots) for lmk in lms if lmk.initialized),
            "views": [len(lmk.kf_slots) for lmk in lms],
            "frames_with_detection": sum(d is not None for d in dets),
            "iou_median": [_median(v) for v in ious], "iou_n": [len(v) for v in ious],
            "joint_ba_ms_median": _median(quad_ms["joint_ba"]),
            "joint_ba_calls": len(quad_ms["joint_ba"]),
            "quadric_init_ms": quad_ms["quadric_init"],
        }
    log(f"[{tag}] {json.dumps(out)}")
    out["slam"] = slam
    if traced:
        for rec in closure_attempts(spans):
            log(f"[{tag}] closure attempt {json.dumps(rec)}")
        for name in ("lc.add_keyframe", "lc.detect_prepare", "lc.detect_finish"):
            key = name[3:] + "_ms"
            v = [span_ms(s) for s in spans if s["name"] == name]
            out[key + "_median"] = _median(v)
            log(f"[{tag}] {key}: median {_median(v):.3f}, max {max(v, default=float('nan')):.3f} "
                f"over {len(v)} keyframes")
        for r in relocs:
            log(f"[{tag}] _relocalize: {json.dumps(r)}")
    n_frames = len(frames)
    min_tracked = min(bar["min_tracked"], n_frames - 5)
    ate_limit = bar["ate_max"] if bar["metric"] else bar["ate_max"] * span
    checks = [
        (first.init_frame_id >= 0 and slam.state == sysm.System.OK, "initialized and OK"),
        (cfg.sensor == "mono" or first.init_frame_id == 0, "initialized on the first frame"),
        (tracked >= min_tracked, f">= {min_tracked} frames tracked"),
        (int(slam.map.n_kf) >= bar["min_kf"], f">= {bar['min_kf']} keyframes"),
        (ate < ate_limit, f"ATE {ate:.5f} < {ate_limit:.5f}"),
    ]
    if bar["capacity"]:
        ev = out["capacity_events"]
        checks.append((ev["n_kf_compactions"] + ev["n_kf_growths"] >= 1,
                       "the keyframe pool compacted or grew"))
        checks.append((len(traj) == n_frames, "every frame has a pose"))
    if kidnap:
        n_base, n_noise = spec["n_frames"], kidnap[0]
        checks += [
            (states[n_base - 1] == sysm.System.OK and n_kf_at[n_base - 1] > 5,
             "OK with more than 5 keyframes before the kidnap"),
            (slam.loop_closer is not None and slam.loop_closer.sparse,
             "a keyframe database on the shipped vocabulary (sparse path)"),
            (states[n_base + n_noise - 1] == sysm.System.LOST, "LOST after the noise frames"),
            (sysm.System.OK in states[n_base + n_noise:], "OK again within the return frames"),
            (any(r["recovered"] for r in relocs), "_relocalize recovered the pose"),
        ]
        err = relocalized_error(traj_before, poses, slam.T_cw, kidnap, lost)
        out["reloc_centre_error_frac"] = err / span
        log(f"[{tag}] relocalized camera centre {err / span:.4f} of the span from the "
            f"nearest return frame's ground truth")
        checks.append((err < 0.05 * span, "the relocalized pose within 5% of the span"))
        if cuda:
            checks.append((sum(r["launches"] for r in relocs) > 0,
                           "kernel launches inside _relocalize"))
    if bar["quadric"]:
        q = out["quadric"]
        checks.append((q["initialized"] >= 1, f"a landmark initialized ({q})"))
        checks.append((any(n >= 3 and med > 0.5 for n, med in zip(q["iou_n"], q["iou_median"])),
                       "an initialized landmark re-projects onto >= 3 of its boxes at a median "
                       "IoU > 0.5"))
    if bar["loop"]:
        checks += [
            (slam.n_loops_closed >= 1, "at least one loop closed"),
            (bool(closed_at) and closed_at[0] > n_frames // 2,
             f"the first closure in the second half (closures at {closed_at})"),
            (gba_running or slam.n_gba_applied >= 1, "the global BA ran in the background"),
            (slam.n_gba_applied >= 1 and slam._gba_thread is None,
             "shutdown() applied the background BA"),
            (slam.loop_closer.sparse, "the sparse database path"),
        ]
    if cuda:
        checks += launch_checks(launches, n_calls)
        per_call = 2 if cfg.sensor == "stereo" else 1
        checks.append((n_calls["images"] == per_call * len(all_ms),
                       f"{per_call} image(s) per track call ({n_calls['images']} images over "
                       f"{len(all_ms)} calls)"))
        if bar["loop"]:
            closures = n_calls["loop_fuse"]
            checks.append((n_calls["mutual_match"] >= closures >= 1
                           and n_calls["loop_proj"] >= closures,
                           "every closure went through its three searches"))
    for ok, what in checks:
        if not ok:
            raise AssertionError(f"{tag} path check failed: {what}")
    return out


def resume_from_checkpoint(slam, tag):
    """``save_system`` of ``slam``, a fresh System of its configuration and
    ``load_system`` into it; the restored map's tensors must equal the saved
    arrays bit for bit. Returns (the fresh System, the checkpoint's numbers)."""
    import pickle

    from orbslam2_with_quadrics_tpu_torch.models import map_state as ms
    from orbslam2_with_quadrics_tpu_torch.models import system as sysm
    from orbslam2_with_quadrics_tpu_torch.utils import serialization as ser

    def sync():
        if slam.device.type == "cuda":
            torch.cuda.synchronize()

    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "system.pkl")
        sync()
        t0 = time.perf_counter()
        ser.save_system(path, slam)
        save_s = time.perf_counter() - t0
        with open(path, "rb") as f:
            saved = pickle.load(f)
        size = os.path.getsize(path)
        fresh = sysm.System(slam.cfg)
        t0 = time.perf_counter()
        ser.load_system(path, fresh)
        sync()
        load_s = time.perf_counter() - t0
    got = ms.map_state_to_numpy(fresh.map)
    bad = [f for f in ms.MapState._fields
           if got[f].dtype != saved["map"][f].dtype or not np.array_equal(got[f], saved["map"][f])]
    if bad or any(getattr(fresh.map, f).device.type != slam.device.type
                  for f in ms.MapState._fields):
        raise AssertionError(f"{tag}: the restored map differs from the saved arrays in {bad}")
    if fresh.state != slam.state or len(fresh.trajectory) != len(slam.trajectory):
        raise AssertionError(f"{tag}: the restored System's state or trajectory differs")
    rec = {"frame": saved["frame_id"], "bytes": size, "save_s": save_s, "load_s": load_s,
           "n_kf": int(saved["map"]["n_kf"]), "n_pt": int(saved["map"]["n_pt"]),
           "sparse_database": "kf_wid" in saved}
    log(f"[{tag}] checkpoint at frame {rec['frame']}: {json.dumps(rec)}; the restored map's "
        f"23 tensors bit-equal to the saved arrays")
    return fresh, rec


def check_trajectory_files(slam, traj):
    """The TUM, KITTI and keyframe files of ``slam``, written and read back:
    the TUM file's timestamps and poses within 1e-6 of ``traj`` (the output
    of ``full_trajectory()``), as many KITTI lines, one keyframe line per
    live keyframe."""
    from orbslam2_with_quadrics_tpu_torch.utils import metrics, trajectory

    with tempfile.TemporaryDirectory() as tmp:
        paths = [os.path.join(tmp, n) for n in ("tum.txt", "kitti.txt", "kf.txt")]
        slam.save_trajectory_tum(paths[0])
        slam.save_trajectory_kitti(paths[1])
        slam.save_keyframe_trajectory_tum(paths[2])
        tum, kitti, kf = (np.loadtxt(p, ndmin=2) for p in paths)
    want = []
    for _, ts, T7 in traj:
        Rwc, twc = trajectory._Tcw_to_Twc(metrics.se3_vec_to_mat(T7))
        want.append([ts, *twc, *trajectory._R_to_quat(Rwc)])
    err = float(np.abs(tum - np.asarray(want)).max())
    n_kf = len(slam.keyframe_trajectory())
    rec = {"tum_lines": len(tum), "kitti_lines": len(kitti), "keyframe_lines": len(kf),
           "tum_max_abs_err": err}
    log(f"[trajectory files] {json.dumps(rec)}")
    if not (err <= 1e-6 and len(kitti) == len(tum) == len(traj) and kitti.shape[1] == 12
            and len(kf) == n_kf):
        raise AssertionError(f"trajectory files disagree with full_trajectory(): {rec}")
    return rec


# the drivers phase's sequences, written to disk by the port's writers at the
# widths of the paths above: TUM (mono, RGB-D with 16-bit depth at 5000
# counts per metre) and KITTI stereo; a EuRoC layout is made from the KITTI
# frames. mono_tum, rgbd_tum and stereo_kitti run the whole sequences, the
# other three drivers DRIVER_SHORT frames; the command-line run CLI_FRAMES.
DRIVER_SEQUENCES = {
    "tum": dict(n_frames=80, h=480, w=640, fx=520.0, seed=1, sensor="mono", n_features=1024),
    "rgbd": dict(n_frames=80, h=480, w=640, fx=520.0, seed=2, sensor="rgbd", n_features=1024),
    "kitti": dict(n_frames=60, h=370, w=1226, fx=718.9, baseline=0.2, seed=5, n_features=2048),
}
DRIVER_SHORT = 40
CLI_FRAMES = 30


def _opencv_matrix_yaml(key, rows, cols, data):
    return (f"{key}: !!opencv-matrix\n   rows: {rows}\n   cols: {cols}\n   dt: d\n"
            f"   data: [{', '.join(repr(float(x)) for x in data)}]\n")


def _link_tree(src, dst, n_lines, listing, header=0):
    """``dst`` holding symbolic links to ``src``'s entries, with the file
    ``listing`` cut to its first ``header + n_lines`` lines."""
    os.makedirs(dst)
    for entry in os.listdir(src):
        if entry != listing:
            os.symlink(os.path.join(src, entry), os.path.join(dst, entry))
    with open(os.path.join(src, listing)) as f:
        lines = f.readlines()[:header + n_lines]
    with open(os.path.join(dst, listing), "w") as f:
        f.writelines(lines)


def write_driver_sequences(root):
    """The drivers phase's datasets under ``root`` (numpy and the standard
    library only: ``main`` runs this in a worker process while the card
    works). Returns ({name: (settings, sequence dir)}, seconds)."""
    from orbslam2_with_quadrics_tpu_torch.utils import synthetic

    t0 = time.time()
    out = {}
    for name in ("tum", "rgbd"):
        d = os.path.join(root, name)
        out[name] = (synthetic.write_tum_sequence(d, **DRIVER_SEQUENCES[name])[0], d)
    kitti = os.path.join(root, "kitti")
    k = DRIVER_SEQUENCES["kitti"]
    out["kitti"] = (synthetic.write_kitti_sequence(kitti, **k)[0], kitti)
    # the short copies: KITTI's first frames, TUM mono's for the command line
    _link_tree(kitti, os.path.join(root, "kitti_short"), DRIVER_SHORT, "times.txt")
    out["kitti_short"] = (out["kitti"][0], os.path.join(root, "kitti_short"))
    _link_tree(out["tum"][1], os.path.join(root, "tum_cli"), CLI_FRAMES, "rgb.txt", header=2)
    out["tum_cli"] = (out["tum"][0], os.path.join(root, "tum_cli"))
    # EuRoC: mav0/cam{0,1}/data.csv over the KITTI pairs, a LEFT/RIGHT block
    # with no distortion and R = I (the rectification maps are the identity)
    euroc = os.path.join(root, "euroc")
    times = np.loadtxt(os.path.join(kitti, "times.txt"))[:DRIVER_SHORT]
    for cam, sub in (("cam0", "image_0"), ("cam1", "image_1")):
        data = os.path.join(euroc, "mav0", cam, "data")
        os.makedirs(data)
        rows = ["#timestamp [ns],filename"]
        for i, t in enumerate(times):
            ns = 1_400_000_000_000_000_000 + int(round(t * 1e9))  # EuRoC-like stamps
            os.symlink(os.path.join(kitti, sub, f"{i:06d}.png"), os.path.join(data, f"{ns}.png"))
            rows.append(f"{ns},{ns}.png")
        with open(os.path.join(euroc, "mav0", cam, "data.csv"), "w") as f:
            f.write("\n".join(rows) + "\n")
    fx, w, h = k["fx"], k["w"], k["h"]
    Kc = [fx, 0, w / 2.0, 0, fx, h / 2.0, 0, 0, 1]
    with open(out["kitti"][0]) as f:
        text = f.read()
    for side, tx in (("LEFT", 0.0), ("RIGHT", -k["baseline"] * fx)):
        text += f"{side}.height: {h}\n{side}.width: {w}\n"
        text += _opencv_matrix_yaml(f"{side}.D", 1, 5, [0.0] * 5)
        text += _opencv_matrix_yaml(f"{side}.K", 3, 3, Kc)
        text += _opencv_matrix_yaml(f"{side}.R", 3, 3, np.eye(3).reshape(-1))
        text += _opencv_matrix_yaml(f"{side}.P", 3, 4, Kc[:3] + [tx] + Kc[3:6] + [0.0]
                                    + Kc[6:] + [0.0])
    settings = os.path.join(euroc, "settings.yaml")
    with open(settings, "w") as f:
        f.write(text)
    out["euroc"] = (settings, euroc)
    return out, time.time() - t0


def _rows(path):
    with open(path) as f:
        return np.asarray([[float(x) for x in line.split()] for line in f
                           if line.strip() and not line.startswith("#")], np.float64)


def driver_error(traj_path, seq_dir, fmt, with_scale):
    """(ATE, span, rows) of a driver's trajectory file against the written
    ground truth: TUM rows matched to ``groundtruth.txt`` by timestamp (as
    ``tests/test_drivers.py`` scores them), or KITTI 3x4 rows against
    ``poses.txt`` frame by frame; sim(3) or rigid alignment."""
    from orbslam2_with_quadrics_tpu_torch.utils import metrics

    est = _rows(traj_path)
    if fmt == "kitti":
        gt = _rows(os.path.join(seq_dir, "poses.txt"))
        if est.shape[1] != 12 or len(est) != len(gt):
            raise AssertionError(f"{traj_path}: {est.shape} KITTI rows for {len(gt)} frames")
        e, g = est[:, [3, 7, 11]], gt[:, [3, 7, 11]]
    else:
        gt = {round(r[0], 4): r[1:4] for r in _rows(os.path.join(seq_dir, "groundtruth.txt"))}
        pairs = [(r[1:4], gt[round(r[0], 4)]) for r in est if round(r[0], 4) in gt]
        if est.shape[1] != 8 or not pairs:
            raise AssertionError(f"{traj_path}: {est.shape} is no TUM trajectory")
        e, g = np.asarray([p[0] for p in pairs]), np.asarray([p[1] for p in pairs])
    return (metrics.ate_rmse(e, g, with_scale=with_scale),
            float(np.linalg.norm(g.max(0) - g.min(0))), len(est))


def phase_drivers(smi, written, out_dir, device="cuda"):
    """Each example driver's ``main()`` on the written datasets, every map
    tensor on the card, at the drivers' own map pools; the kernel's launch
    counts set to 0 before each and read after. mono_tum, rgbd_tum and
    stereo_kitti must score under 5% of the span (sim(3) for mono, rigid
    for the metric sensors); every driver must exit and leave a trajectory
    file that reads back. Then mono_tum once more through ``python -m`` on
    CLI_FRAMES frames, with ``-X importtime`` showing that neither JAX nor
    the JAX package was imported. Returns one dict per driver."""
    from orbslam2_with_quadrics_tpu_torch.examples import (mono_euroc, mono_kitti, mono_tum,
                                                           rgbd_tum, stereo_euroc, stereo_kitti)
    from orbslam2_with_quadrics_tpu_torch.ops import cuda_kernels as ck

    seqs, seconds = written
    cuda = device == "cuda"
    log(f"[drivers] wrote the datasets in {seconds:.1f} s (in a worker process)")
    drivers = [  # name, module, main's arguments, file format, scored (with scale)
        ("mono_tum", mono_tum, ["tum"], "tum", True),
        ("rgbd_tum", rgbd_tum, ["rgbd", "associations.txt"], "tum", False),
        ("stereo_kitti", stereo_kitti, ["kitti"], "kitti", False),
        ("mono_kitti", mono_kitti, ["kitti_short"], "tum", None),
        ("mono_euroc", mono_euroc, ["euroc"], "tum", None),
        ("stereo_euroc", stereo_euroc, ["euroc"], "tum", None),
    ]
    runs = []
    for name, mod, args, fmt, with_scale in drivers:
        settings, seq = seqs[args[0]]
        extra = [os.path.join(seq, a) for a in args[1:]]
        traj = os.path.join(out_dir, f"{name}.txt")
        if cuda:
            torch.cuda.synchronize()
        with counted_calls(cuda) as (n_calls, map_events):
            ck.reset_launch_counts()
            res = mod.main(settings, seq, *extra, traj, device=device)
            if cuda:
                torch.cuda.synchronize()
            launches = dict(ck.LAUNCHES)
        n = launches["masked_hamming_best2"]
        slam = res.pop("system")
        map_ms = [a.elapsed_time(b) for a, b in map_events]
        frame_ms = 1e3 * np.asarray(res["times"])
        if with_scale is None:  # not scored: the file must read back
            ate, span, rows = float("nan"), float("nan"), len(_rows(traj))
        else:
            ate, span, rows = driver_error(traj, seq, fmt, with_scale)
        rec = {
            "path": f"driver:{name}", "decoder": res["decoder"], "frames": len(frame_ms),
            "frame_ms_median": float(np.median(frame_ms)),
            "frame_ms_p90": float(np.percentile(frame_ms, 90)),
            "map_ms_median": _median(map_ms), "n_map_passes": n_calls["map_passes"],
            "n_frame_steps": n_calls["frames"], "n_calls": dict(n_calls),
            "launches": launches, "n_kf": res["n_kf"],
            "kfs_created": res["kfs_created"], "n_loops_closed": res["n_loops_closed"],
            "pools": [slam.map.kf_valid.shape[0], slam.map.pt_pos.shape[0]],
            "trajectory_rows": rows, "ate": ate, "span": span, "ate_frac": ate / span,
            "scored": with_scale is not None,
        }
        del slam, res
        if cuda:
            torch.cuda.empty_cache()
        log(f"[drivers] {name}: decoder {rec['decoder']}, {rec['frames']} frames, frame (host, "
            f"per track call) median {rec['frame_ms_median']:.2f} ms p90 "
            f"{rec['frame_ms_p90']:.2f} ms, mapping pass median {rec['map_ms_median']:.2f} ms "
            f"over {rec['n_map_passes']}, {rec['n_kf']} keyframes, {rec['n_loops_closed']} "
            f"loops, pools {rec['pools']}, {n} kernel launches, ATE {ate / span:.4f} of the "
            f"span, {rows} trajectory rows ({smi})")
        log(f"[drivers] {name} {json.dumps(rec)}")
        checks = [(rows > 0, "a trajectory file that reads back")]
        if cuda:
            checks += launch_checks(launches, n_calls)
        if with_scale is not None:
            checks.append((ate < 0.05 * span, f"ATE {ate:.5f} < 5% of the span {span:.5f}"))
        for ok, what in checks:
            if not ok:
                raise AssertionError(f"driver {name} check failed: {what}")
        runs.append(rec)

    # the command line, in a process of its own
    settings, seq = seqs["tum_cli"]
    traj = os.path.join(out_dir, "mono_tum_cli.txt")
    t0 = time.time()
    r = subprocess.run(
        [sys.executable, "-X", "importtime", "-m",
         "orbslam2_with_quadrics_tpu_torch.examples.mono_tum", settings, seq, traj,
         "--device", device],
        cwd=os.path.dirname(os.path.abspath(__file__)), capture_output=True, text=True,
        timeout=600)
    imported = [line.rsplit("|", 1)[-1].strip() for line in r.stderr.splitlines()
                if line.startswith("import time:")]
    banned = sorted({m for m in imported
                     if m.split(".")[0] in ("jax", "jaxlib", "orbslam2_with_quadrics_tpu")})
    tail = [line for line in r.stdout.splitlines() if line.startswith(("image decoder", "median"))]
    log(f"[drivers] python -m ...examples.mono_tum: exit {r.returncode} in "
        f"{time.time() - t0:.1f} s, {len(imported)} modules imported, JAX or the JAX "
        f"package among them: {banned or 'none'}; {tail}")
    if r.returncode != 0 or banned or len(imported) < 10:
        raise AssertionError(f"the command-line run failed: {r.stdout[-2000:]}\n"
                             f"{[x for x in r.stderr.splitlines() if not x.startswith('import time')][-30:]}")
    if len(_rows(traj)) < CLI_FRAMES // 2:
        raise AssertionError("the command-line run's trajectory does not read back")
    return runs


# the tools phase's sizes: the tools' defaults, except train_vocab (48 frames x
# 1,000 features, 10^4 words) and bench_dist_ba (16,384 edges per rank); a
# rehearsal on the CPU sets smaller ones
TOOL_SIZES = {
    "bench_ba": (32, 8192, 1024),
    "profile_lba": (49, 1024, 8192),
    "frame": {},
    "train_vocab": ["--frames", "48", "--features", "1000", "--k", "10", "--levels", "4"],
    "debug_oab": 300,
    "bench_dist_ba": dict(obs_per_rank=16384),
}


def phase_tools(smi, out_dir, device="cuda"):
    """The port's measuring tools on the card, each through its ``main``:
    ``bench_ba`` (PCG and dense, both JSON lines), ``profile_lba``,
    ``profile_track`` and ``bench_profile`` (the kernel's launches set to 0
    before each and held to the launch rule after), ``train_vocab`` at a
    reduced size into ``out_dir`` (its retrieval must hit the top 5),
    ``debug_oab`` (``n_reachable`` and ``n_window`` within ``n_frustum`` and
    a live keyframe on every row; its launches held to the rule) and
    ``bench_dist_ba`` at 1 and 2 ranks (the 2-rank cost within 1e-3 of
    ``ba_solve`` on the same problem). Returns (the tools' results, the
    kernel's launches by tool)."""
    from orbslam2_with_quadrics_tpu_torch.ops import ba
    from orbslam2_with_quadrics_tpu_torch.ops import cuda_kernels as ck
    from orbslam2_with_quadrics_tpu_torch.scripts import (bench_ba, bench_dist_ba,
                                                          bench_profile, common, debug_oab,
                                                          profile_lba, profile_track,
                                                          train_vocab)

    cuda = device == "cuda"
    t_phase = time.time()
    out, launches = {}, {}

    def sync():
        if cuda:
            torch.cuda.synchronize()

    def require(ok, what):
        if not ok:
            raise AssertionError(f"tools check failed: {what}")

    def counted(name, fn):
        sync()
        with counted_calls(cuda) as (n_calls, _):
            ck.reset_launch_counts()
            res = fn()
            sync()
            n = dict(ck.LAUNCHES)
        launches[f"tool:{name}"] = n
        log(f"[tools] {name}: kernel launches {json.dumps(n)} over {json.dumps(n_calls)}")
        if cuda:
            for ok, what in launch_checks(n, n_calls):
                require(ok, f"{name}: {what}")
        return res

    t0 = time.time()
    out["bench_ba"] = bench_ba.main(*TOOL_SIZES["bench_ba"], device=device)
    for r in out["bench_ba"]:
        require(r["value"] > 0 and np.isfinite(r["final_cost"]), f"bench_ba {r}")
    log(f"[tools] bench_ba in {time.time() - t0:.1f} s ({smi})")

    t0 = time.time()
    with torch.no_grad():
        out["profile_lba"] = profile_lba.main(
            device, prob=profile_lba.build_problem(*TOOL_SIZES["profile_lba"], device=device))
    require(all(v > 0 and np.isfinite(v) for v in out["profile_lba"]["table_ms"].values()),
            f"profile_lba {out['profile_lba']['table_ms']}")
    log(f"[tools] profile_lba in {time.time() - t0:.1f} s ({smi})")

    for name, mod, n_live in (("profile_track", profile_track, 16),
                              ("bench_profile", bench_profile, 8)):
        t0 = time.time()
        with torch.no_grad():
            wl = common.frame_workload(device, n_live_kf=n_live, **TOOL_SIZES["frame"])
            out[name] = counted(name, lambda: mod.main(device, 1, wl))
        del wl
        log(f"[tools] {name} in {time.time() - t0:.1f} s ({smi})")

    t0 = time.time()
    rep = train_vocab.main(TOOL_SIZES["train_vocab"] + [
        "--out", os.path.join(out_dir, "vocab_tool.npz"), "--device", device])
    out["train_vocab"] = rep
    require(rep["retrieval"]["revisit_top5_hit"], f"train_vocab retrieval {rep['retrieval']}")
    log(f"[tools] train_vocab in {time.time() - t0:.1f} s ({smi})")

    t0 = time.time()
    rows = counted("debug_oab", lambda: debug_oab.main(TOOL_SIZES["debug_oab"], device=device))
    require(len(rows) > 0, "debug_oab printed no row")
    for r in rows:
        require(r["n_reachable"] <= r["n_frustum"] and r["n_window"] <= r["n_frustum"]
                and r["kfs_live"] >= 1, f"debug_oab row {r}")
    out["debug_oab"] = rows
    log(f"[tools] debug_oab in {time.time() - t0:.1f} s ({smi})")

    t0 = time.time()
    kw = TOOL_SIZES["bench_dist_ba"]
    dist_out = bench_dist_ba.main(ranks=(1, 2), device=device, **kw)
    ref_prob = bench_dist_ba.build(2, device=device, **kw)
    with torch.no_grad():
        _, ref_cost = ba.ba_solve(ref_prob, n_iters=bench_dist_ba.N_LM_ITERS,
                                  cg_iters=bench_dist_ba.CG_ITERS)
    ref_cost = float(ref_cost)
    dc = abs(dist_out["final_cost"]["2"] - ref_cost) / max(ref_cost, 1.0)
    log(f"[tools] bench_dist_ba: 2 ranks' cost {dist_out['final_cost']['2']:.3f}, one "
        f"process {ref_cost:.3f} ({dc:.2e} relative); in {time.time() - t0:.1f} s ({smi})")
    require(dc <= 1e-3, f"bench_dist_ba's 2-rank cost against ba_solve: {dc}")
    out["bench_dist_ba"] = dist_out
    log(f"[tools] phase seconds {time.time() - t_phase:.1f}")
    return out, launches


BENCH_FRAMES = 50


def phase_bench(smi, device="cuda"):
    """``scripts.bench.main`` (the twin of the JAX package's ``bench.py``) at
    its workload (``TOOL_SIZES["frame"]``, 16 live keyframes),
    ``BENCH_FRAMES`` dependent frames and one pass over the workload's
    images per timed stage, its kernel launches counted and held
    to the launch rule: every stage and ``value`` finite and positive,
    ``fps_amortized`` under ``value``, each ``pct_of_sol`` at most 100.
    Returns (its JSON, the kernel's launches as ``tool:bench``)."""
    from orbslam2_with_quadrics_tpu_torch.ops import cuda_kernels as ck
    from orbslam2_with_quadrics_tpu_torch.scripts import bench, common

    cuda = device == "cuda"
    t0 = time.time()

    def sync():
        if cuda:
            torch.cuda.synchronize()

    def require(ok, what):
        if not ok:
            raise AssertionError(f"bench check failed: {what}")

    with torch.no_grad():
        wl = common.frame_workload(device, n_live_kf=16, **TOOL_SIZES["frame"])
        sync()
        with counted_calls(cuda) as (n_calls, _):
            ck.reset_launch_counts()
            out = bench.main(device, BENCH_FRAMES, wl, reps=1)
            sync()
            n = dict(ck.LAUNCHES)
    log(f"[bench] value {out['value']:.3f} frames/s, fps_amortized "
        f"{out['fps_amortized']:.3f}, frame p50 / p90 {out['frame_ms']['p50']:.2f} / "
        f"{out['frame_ms']['p90']:.2f} ms, map_pipeline_fused "
        f"{out['stage_ms']['map_pipeline_fused']:.2f} ms ({smi}; its JSON line above)")
    log(f"[bench] kernel launches {json.dumps(n)} over {json.dumps(n_calls)}")
    stages = {k: v for k, v in out["stage_ms"].items() if k != "note"}
    for k, v in list(stages.items()) + [("value", out["value"])]:
        require(np.isfinite(v) and v > 0, f"{k} = {v}")
    require(out["fps_amortized"] < out["value"],
            f"fps_amortized {out['fps_amortized']} not under value {out['value']}")
    if cuda:
        for k in ("extract", "frame"):
            pct = out["speed_of_light"][k]["pct_of_sol"]
            require(0 < pct <= 100, f"{k} pct_of_sol = {pct}")
        for ok, what in launch_checks(n, n_calls):
            require(ok, what)
    log(f"[bench] phase seconds {time.time() - t0:.1f} ({smi})")
    return out, {"tool:bench": n}


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def ba_agreement(poses, points, cost, ref_poses, ref_points, ref_cost):
    """(max pose difference, max point difference, cost difference relative
    to the larger of the reference cost and 1) and whether they meet the
    distributed-BA bars: poses 5e-4, points 5e-3, cost 1e-3."""
    dp = float(np.abs(poses - ref_poses).max())
    dx = float(np.abs(points - ref_points).max())
    dc = abs(cost - ref_cost) / max(ref_cost, 1.0)
    return dp, dx, dc, dp <= 5e-4 and dx <= 5e-3 and dc <= 1e-3


def phase_dist(smi, device="cuda", kitti=(1400, 140_000, 5_000_000), db=(1023, 16384)):
    """Distributed BA on the card:
    (a) the KITTI-00-scale problem (C = 1,400 keyframes, P = 140,000 points,
        O = 5,000,000 stereo edges, KITTI intrinsics, 0.3 px noise) built on
        the card from a seed, solved by a 1-rank NCCL ``dist_ba_solve`` and
        by ``ba_solve``, 2 LM x 5 CG steps each, timed, with the peak memory;
    (b) the dryrun problem (256 cameras, 65,536 edges) over 2 spawned gloo
        ranks on CUDA tensors against the 1-process solve on the card;
    (c) ``dist_score_database`` over the same 2 ranks against
        ``score_database`` on a dense [1023 x 16384] database (1023 rows:
        one rank holds a pad row).
    The bars: poses within 5e-4, points within 5e-3, costs within 1e-3 of
    the larger of the cost and 1; retrieval counts equal, scores within 1e-5.
    ``device="cpu"`` (with smaller ``kitti`` = (C, P, O) and ``db`` = (rows,
    words)) rehearses the phase on the CPU, gloo in place of NCCL."""
    import torch.distributed as dist

    from orbslam2_with_quadrics_tpu_torch.models import loop_closing as lc
    from orbslam2_with_quadrics_tpu_torch.ops import ba, residuals
    from orbslam2_with_quadrics_tpu_torch.parallel import dist_ba, launch, problems

    cuda = device == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize()

    out = {}
    C, P, O = kitti
    solve = dict(n_iters=2, cg_iters=5)
    t0 = time.perf_counter()
    prob = problems.kitti_problem(C, P, O, seed=0, device=device)
    sync()
    log(f"[dist] KITTI-00-scale problem C = {C}, P = {P}, O = {O} built on {device} in "
        f"{time.perf_counter() - t0:.2f} s")
    group = dist_ba.initialize_multihost(f"127.0.0.1:{free_port()}", 1, 0,
                                         backend="nccl" if cuda else "gloo", device=device)
    try:
        report = dist_ba.process_local_report(group)
        ba.ba_solve(prob, n_iters=1, cg_iters=1)  # library handles and allocator warm-up
        res = {}
        for name, fn in (("nccl-1", lambda: dist_ba.dist_ba_solve(
                              dist_ba.shard_problem(prob, 0, 1), group, **solve)),
                         ("ba_solve", lambda: ba.ba_solve(prob, **solve)),
                         ("nccl-1 again", lambda: dist_ba.dist_ba_solve(
                              dist_ba.shard_problem(prob, 0, 1), group, **solve)),
                         ("ba_solve again", lambda: ba.ba_solve(prob, **solve))):
            sync()
            if cuda:
                torch.cuda.reset_peak_memory_stats()
            t = time.perf_counter()
            p_out, cost = fn()
            sync()
            ms_ = 1e3 * (time.perf_counter() - t)
            res[name] = (p_out.poses.cpu().numpy(), p_out.points.cpu().numpy(), float(cost),
                         ms_, torch.cuda.max_memory_allocated() if cuda else 0)
    finally:
        dist.destroy_process_group()
    c0 = float(ba._edge_terms(prob, residuals.CHI2_STEREO)[5])
    del prob
    if cuda:
        torch.cuda.empty_cache()
    dp, dx, dc, ok = ba_agreement(*res["nccl-1"][:3], *res["ba_solve"][:3])
    for name, (_, _, cost, ms_, mem) in res.items():
        log(f"[dist] {name}: 2 LM x 5 CG steps in {ms_:.2f} ms = {ms_ / 2:.2f} ms per LM step "
            f"= {2e3 / ms_:.2f} BA iterations per second (5 CG steps each); cost {c0:.1f} -> "
            f"{cost:.1f}; peak memory {mem / 2 ** 30:.2f} GiB ({smi})")
    log(f"[dist] 1-rank NCCL dist_ba_solve against ba_solve: poses within {dp:.2e}, points "
        f"within {dx:.2e}, cost within {dc:.2e} relative; report {json.dumps(report)}")
    out["kitti00"] = {"C": C, "P": P, "O": O, "cost0": c0, "agreement": [dp, dx, dc],
                      **{name: {"ms": r[3], "ms_per_lm": r[3] / 2, "cost": r[2],
                                "peak_bytes": r[4]} for name, r in res.items()}}
    if not ok:
        raise AssertionError(f"1-rank NCCL dist_ba_solve disagrees with ba_solve: poses {dp}, "
                             f"points {dx}, cost {dc}")

    # (b) + (c): 2 gloo ranks on CUDA tensors, one spawn
    dry = problems.dryrun_problem(seed=0, device=device)
    rng = np.random.default_rng(1)
    bow = rng.random(db, dtype=np.float32)
    bow = bow * (bow > 0.99)
    bow = bow / np.maximum(np.abs(bow).sum(1, keepdims=True), 1e-9)
    valid = np.ones(db[0], bool)
    valid[::7] = False
    score_job = (bow, bow[3].copy(), valid)
    t0 = time.perf_counter()
    ranks = launch.run_ranks(launch.rank_jobs, 2, device,
                             [(problems.problem_to_numpy(dry), solve)], [score_job],
                             backend="gloo", device=device, timeout=600.0)
    spawn_s = time.perf_counter() - t0
    one, cost1 = ba.ba_solve(dry, **solve)
    ref = (one.poses.cpu().numpy(), one.points.cpu().numpy(), float(cost1))
    s_ref, c_ref = lc.score_database(*(torch.as_tensor(a, device=device) for a in score_job))
    s_ref, c_ref = s_ref.cpu().numpy(), c_ref.cpu().numpy()
    rows = []
    for r in ranks:
        poses, points, cost, ms_ = r["ba"][0]
        dp, dx, dc, ok = ba_agreement(poses, points, cost, *ref)
        s, c = r["score"][0]
        s_err = float(np.abs(s - s_ref).max())
        rows.append({"report": r["report"], "ms": ms_, "cost": cost, "agreement": [dp, dx, dc],
                     "score_max_abs_err": s_err, "counts_equal": bool(np.array_equal(c, c_ref))})
        log(f"[dist] gloo rank {r['report']['process_index']} of 2 on {device} tensors: dryrun "
            f"problem 2 LM x 5 CG in {ms_:.2f} ms, cost {cost:.6f} (1 process: {ref[2]:.6f}); "
            f"poses within {dp:.2e}, points within {dx:.2e}, cost within {dc:.2e}; "
            f"dist_score_database {list(db)}: scores within {s_err:.2e}, counts "
            f"{'equal' if rows[-1]['counts_equal'] else 'DIFFERENT'} ({smi})")
        if not (ok and s_err <= 1e-5 and rows[-1]["counts_equal"]):
            raise AssertionError(f"2-rank gloo on {device} tensors disagrees: {rows[-1]}")
    if not all(np.array_equal(r["ba"][0][0], ranks[0]["ba"][0][0]) for r in ranks):
        raise AssertionError("the gloo ranks hold different poses")
    log(f"[dist] 2 gloo ranks spawned, solved and scored in {spawn_s:.1f} s")
    log("[dist] multi-GPU NCCL scaling: not measured (this host has one card; NCCL runs "
        "one rank per card)")
    out["gloo_2"] = {"ranks": rows, "spawn_s": spawn_s, "cost_1_process": ref[2]}
    return out


def ba_relative(a, b) -> float:
    """max |a - b| / max(1, max |b|)."""
    return float((a.double() - b.double()).abs().max()) / max(1.0, float(b.abs().max()))


def terms_agreement(got, ref, exact):
    """(distances, whether they meet the bars) of one step's ``dense_terms``
    ``got`` against the plain version ``ref``: the sums without
    cancellation (Hcc_d, V, the cost) within 1e-5 relative; the gradient
    sums (bc, bp), which cancel as the LM converges, and the point blocks'
    inverses and their products (Hpi, Hpi bp, VH), which float32 fixes only
    to about a block's condition number times 6e-8, no further from the
    float64 evaluation ``exact`` than 1e-5 + 4x the plain version's own
    distance to it (on the mono window the plain version is up to 4e-3 off
    it in Hpi, PR 13's chip run; bc and bp differ by 5e-2 and 3e-1 of their
    largest entry between the two float32 routes at converged steps)."""
    from orbslam2_with_quadrics_tpu_torch.ops import ba

    d = {f: ba_relative(g, r) for f, g, r in zip(ba.DenseTerms._fields, got, ref)}
    ok = all(d[f] <= 1e-5 for f in ("Hcc_d", "V", "cost"))
    for f in ("bc", "bp", "Hpi", "Hpib", "VH"):
        k, p = ba_relative(getattr(got, f), getattr(exact, f)), ba_relative(getattr(ref, f),
                                                                             getattr(exact, f))
        d[f + "_float64"] = [k, p]
        ok = ok and k <= 1e-5 + 4.0 * p
    return d, ok


def in_float64(prob):
    from orbslam2_with_quadrics_tpu_torch.ops import ba

    return ba.BAProblem(*[x.double() if torch.is_tensor(x) and x.is_floating_point() else x
                          for x in prob])


def dense_terms_bound(prob, ploc, grid, L):
    """(bound ms, what bounds it, counts) of one dense LM step's terms (the
    terms and slot passes and the cost at a candidate) on these inputs:
    each call reads 32 B per edge (point index, observation, stereo flag,
    weight, validity), the poses and the points it refers to; the terms
    call also the slots (8 B per edge) and writes the camera blocks, the
    dense V and VH [C, L, 6, 3] and the point blocks (60 B per slot); the
    operations of ``BA_*_OPS`` for this run's valid edges, observed slots
    and (camera, slot) pairs."""
    C, N = grid
    dev = prob.points.device
    valid = prob.valid > 0
    n_edges = int(valid.sum())
    n_pts = int(torch.unique(prob.pnt_idx[valid]).numel())
    local = ploc < L
    slots = int(torch.unique(ploc[local]).numel())
    pairs = int(torch.unique((torch.arange(C, device=dev)[:, None] * L + ploc)[local]).numel())
    E = C * N
    nbytes = (2 * (32 * E + 28 * C + 16 * n_pts) + 8 * E + 4 * C + 168 * C
              + 2 * 72 * C * L + 60 * L + 8)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = (n_edges * (BA_TERMS_OPS_PER_EDGE + BA_COST_OPS_PER_EDGE)
             + slots * BA_SLOT_OPS + pairs * BA_PAIR_OPS) / FP32_OPS_PER_S * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes > t_ops else "operations",
            {"n_edges": n_edges, "slots": slots, "pairs": pairs})


def time_dense_terms(prob, index, grid, L, smi):
    """One dense LM step's terms on the card at these inputs (``index`` the
    point-major edge index; the bare [C, N] slots where a checkout from
    before that index is timed, which ``scripts/ab_kernels.py`` does):
    ``kernel_ms`` (graph replay of 20 steps, 3 launches each), each launch's
    own device time (torch.profiler), ``call_ms``, ``plain_ms``,
    ``bound_ms``, the cost alone, the launches of one step and one whole
    ``_dense_schur_step`` (events around the call)."""
    from orbslam2_with_quadrics_tpu_torch.ops import ba, residuals
    from orbslam2_with_quadrics_tpu_torch.ops import cuda_kernels as ck

    C, N = grid
    dev = prob.points.device
    lam = torch.full((), 1e-4, device=dev)
    d2 = residuals.CHI2_STEREO
    loc_ids = torch.arange(L, device=dev)

    def step_terms(fn):
        return (fn(prob, prob.poses, prob.points, d2, grid, lam=lam, ploc=index, n_local=L),
                fn(prob, prob.poses, prob.points, d2, grid))

    n0 = ck.LAUNCHES["ba_dense_terms"]
    step_terms(ba.dense_terms)
    launches = ck.LAUNCHES["ba_dense_terms"] - n0
    bound, by, counts = dense_terms_bound(prob, getattr(index, "ploc", index), grid, L)
    k = {"kernel_ms": graph_kernel_ms(lambda: step_terms(ba.dense_terms)),
         "call_ms": cuda_median_ms(lambda: step_terms(ba.dense_terms)),
         "plain_ms": cuda_median_ms(lambda: step_terms(ba.dense_terms_plain), reps=10),
         "bound_ms": bound, "bound_by": by, "launches_per_step": launches,
         "cost_kernel_ms": graph_kernel_ms(lambda: ba.dense_terms(
             prob, prob.poses, prob.points, d2, grid)),
         "launch_ms": profiler_kernels_ms(lambda: step_terms(ba.dense_terms), "ba_dense"),
         "schur_step_call_ms": cuda_median_ms(lambda: ba._dense_schur_step(
             prob, prob.poses, prob.points, lam, d2, loc_ids, index, grid)), **counts}
    log(f"[kernel] ba_dense_terms one LM step's terms (C = {C}, N = {N}, L = {L}; "
        f"{counts['n_edges']} valid edges, {counts['slots']} local slots observed, "
        f"{counts['pairs']} camera-slot pairs): kernel_ms {k['kernel_ms']:.5f} (graph replay "
        f"of 20 steps; {launches} launches each: "
        f"{json.dumps({n: round(v, 5) for n, v in k['launch_ms'].items()})} by the profiler; "
        f"the cost alone {k['cost_kernel_ms']:.5f}), call_ms {k['call_ms']:.5f}, plain_ms "
        f"{k['plain_ms']:.4f}, bound_ms {k['bound_ms']:.6f} by {k['bound_by']}; one "
        f"_dense_schur_step {k['schur_step_call_ms']:.4f} ms ({smi})")
    return k


# the Schur sweeps at the benchmark's two tables: (cameras, rows a camera,
# points, live cameras, live share of their rows): KITTI 00 in the stereo
# driver's pools doubled once (65% of 4,096,000 rows live), TUM fr1/desk in
# the RGB-D driver's (5.7% of 512,000)
SWEEP_SHAPES = {"kitti 4096000 rows": (2048, 2000, 262_144, 1400, 0.953),
                "tum 512000 rows": (512, 1000, 65_536, 30, 0.969)}
# a sweep reads each live row's block and two int64 indices, and every
# row's valid flag
SWEEP_LIVE_ROW_BYTES, SWEEP_ROW_BYTES = 72 + 16, 4


def sweep_case(shape, seed, dev="cuda"):
    """(Coupling, x [C, 6], s [P, 3]) of a camera-major table at ``shape``
    drawn from ``seed``: whole cameras dead (empty keyframe slots), the
    live cameras' rows live at the shape's share, each a random point; a
    dead row's block 0, as the solver makes it."""
    from orbslam2_with_quadrics_tpu_torch.ops import ba

    C, N, P, live_cams, share = shape
    g = torch.Generator(device=dev).manual_seed(seed)
    cam = torch.arange(C, device=dev).repeat_interleave(N)
    pnt = torch.randint(0, P, (C * N,), generator=g, device=dev)
    cam_live = torch.zeros(C, dtype=torch.bool, device=dev)
    cam_live[torch.randperm(C, generator=g, device=dev)[:live_cams]] = True
    valid = (cam_live[cam] & (torch.rand(C * N, generator=g, device=dev) < share)).float()
    Wcp = torch.randn(C * N, 6, 3, generator=g, device=dev) * valid[:, None, None]
    A = torch.randn(P, 3, 3, generator=g, device=dev)
    Hinv = A @ A.mT + torch.eye(3, device=dev)
    prob = ba.BAProblem(poses=torch.zeros(C, 7, device=dev), points=torch.zeros(P, 3, device=dev),
                        K=None, bf=None, cam_idx=cam, pnt_idx=pnt, uvr=None, is_stereo=None,
                        inv_sigma2=None, valid=valid, fixed_cam=None, fixed_pnt=None)
    return (ba.coupling(prob, Wcp, Hinv), torch.randn(C, 6, generator=g, device=dev),
            torch.randn(P, 3, generator=g, device=dev))


def sweeps_per_global_ba(dev="cuda", seed=2147483911):
    """``ba_schur_sweep``'s launches in one ``run_global_ba`` on the
    benchmark's TUM fr1/desk map (``port_bench``), and the LM steps and PCG
    iterations of the solve."""
    from orbslam2_with_quadrics_tpu_torch.ops import cuda_kernels as ck
    from port_bench import harness, maps
    from port_bench.entries import global_ba

    cell = harness.load_cell("tum_fr1_desk_rgbd.gba")
    solve = global_ba.prepare(maps.build(cell.cfg, seed, dev), cell.cfg, cell.mix, dev)
    before = dict(ck.LAUNCHES)
    solve()
    torch.cuda.synchronize()
    n = {k: ck.LAUNCHES[k] - before[k] for k in ck.LAUNCHES}
    return n, global_ba.steps_per_call(cell.mix), int(cell.mix["cg_iters"])


def phase_schur_sweep(smi, dev="cuda"):
    """``ba_schur_sweep`` against its plain version on the card at the
    benchmark's two tables: each sweep within 1e-4 of the sum of its terms'
    magnitudes of the plain version (float32 sums of up to ~2,000 rows a
    camera, in two orders), timed (``kernel_ms`` by graph replay of 20
    calls, ``call_ms``, ``plain_ms``, ``bound_ms`` by bytes: live rows x
    88 B + rows x 4 B); then the launches of one ``run_global_ba``: exactly
    ``steps x (2 cg_iters + 2)``, and no other kernel's."""
    from orbslam2_with_quadrics_tpu_torch.ops import ba

    out = {}
    for name, shape in SWEEP_SHAPES.items():
        cp, x, s = sweep_case(shape, seed=11, dev=dev)
        plain = cp._replace(args=None)
        absolute = plain._replace(Wcp=plain.Wcp.abs(), Hpp_inv=plain.Hpp_inv.abs())
        # (kernel, plain version, the terms' magnitudes, the kernel's sign)
        pairs = {"cam_to_point": (lambda: ba.sweep_cam_to_point(cp, x),
                                  lambda: ba.sweep_cam_to_point_plain(plain, x),
                                  ba.sweep_cam_to_point_plain(absolute, x.abs()), 1.0),
                 "point_to_cam": (lambda: ba.sweep_point_to_cam(cp, s),
                                  lambda: ba.sweep_point_to_cam_plain(plain, s),
                                  ba.sweep_point_to_cam_plain(absolute, s.abs()), -1.0)}
        live = int((cp.valid > 0).sum())
        rows = cp.valid.shape[0]
        bound = (live * SWEEP_LIVE_ROW_BYTES + rows * SWEEP_ROW_BYTES) / HBM_BYTES_PER_S * 1e3
        for kname, (kernel, plain_fn, mag, sign) in pairs.items():
            err = float(((sign * kernel() - plain_fn()).abs() / (mag + 1e-30)).max())
            if not err <= 1e-4:
                raise AssertionError(f"ba_schur_sweep {kname} at {name}: {err:.3e} of its terms' "
                                     f"magnitudes from the plain version")
            t = {"kernel_ms": graph_kernel_ms(kernel), "call_ms": cuda_median_ms(kernel),
                 "plain_ms": cuda_median_ms(plain_fn, reps=10), "bound_ms": bound,
                 "bound_by": "bytes", "err": err, "live_rows": live, "rows": rows}
            out[f"{kname} {name}"] = t
            log(f"[kernel] ba_schur_sweep {kname} at {name} ({live} live): kernel_ms "
                f"{t['kernel_ms']:.5f}, call_ms {t['call_ms']:.5f}, plain_ms {t['plain_ms']:.4f}, "
                f"bound_ms {bound:.5f} by bytes ({100 * bound / t['kernel_ms']:.1f}% of it); "
                f"{err:.2e} of the terms' magnitudes from the plain version ({smi})")
    n, steps, cg = sweeps_per_global_ba(dev)
    want = steps * (2 * cg + 2)
    log(f"[kernel] ba_schur_sweep launches per run_global_ba: {n['ba_schur_sweep']} "
        f"({steps} LM steps x (2 x {cg} + 2) = {want}); others {json.dumps(n)}")
    if n["ba_schur_sweep"] != want or any(v for k, v in n.items() if k != "ba_schur_sweep"):
        raise AssertionError(f"ba_schur_sweep: {n} launches in one run_global_ba, {want} of "
                             f"the sweeps and none of the other kernels expected")
    return out, n["ba_schur_sweep"]


# the graphed PCG against the eager one from the same step inputs: the
# largest difference of dc, relative to its largest entry. The sweeps add
# float32 terms in an atomic order that changes from call to call, and the
# CG iterations carry that rounding into dc; a dropped iteration or a
# buffer left at another step's values moves dc by more (the phase shows
# both beside the bar)
GRAPH_DC_BAR = 1e-3


def bench_map(cell_name: str, seed: int, dev="cuda"):
    """(cell, MapState, K, bf, level table) of a ``port_bench`` cell, laid out
    as its global BA entry lays the map out for ``run_global_ba``."""
    from orbslam2_with_quadrics_tpu_torch.models import map_state as ms
    from port_bench import harness, maps

    cell = harness.load_cell(cell_name)
    inp = maps.build(cell.cfg, seed, dev)
    pools, orb = cell.cfg["pools"], cell.cfg["orb"]
    mcfg = ms.MapConfig(max_keyframes=int(pools["max_keyframes"]),
                        max_points=int(pools["max_points"]),
                        n_features=int(orb["n_features"]), n_levels=int(orb["n_levels"]),
                        scale_factor=float(orb["scale_factor"]), device=dev)
    fields = ("kf_pose", "kf_valid", "kf_uv", "kf_ur", "kf_level", "kf_kp_valid",
              "kf_obs_point", "pt_pos", "pt_valid")
    m = ms.empty_map(mcfg)._replace(**{f: inp[f] for f in fields})
    return cell, m, inp["K"], float(inp["bf"]), inp["inv_sigma2"]


def pcg_steps(prob):
    """Two LM steps' PCG inputs (Coupling, Hcc_d, g) on ``prob``: its first
    step at lam 1e-4, and the step after it at lam 5e-5."""
    from orbslam2_with_quadrics_tpu_torch.ops import ba, residuals

    out = []
    for lam in (1e-4, 5e-5):
        lam_t = torch.tensor(lam, device=prob.poses.device)
        Hcc_d, bc, Hpp_inv, bp, Wcp, _ = ba._build_system(prob, residuals.CHI2_STEREO, lam_t)
        cp = ba.coupling(prob, Wcp, Hpp_inv)
        out.append((cp, Hcc_d, ba._schur_rhs(cp, bp, bc)))
        prob = ba.ba_iteration(prob, lam_t, residuals.CHI2_STEREO, 40)[0]
    return out


def dc_gap(a, b) -> float:
    return float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))


def phase_graphed_pcg(smi, dev="cuda", seed=2147483917):
    """The global BA's PCG as one CUDA graph a ``ba_solve`` call
    (``ba.GraphedPCG``) on the benchmark's two maps: at two steps' inputs
    the graph's dc against the eager ``_pcg``'s within ``GRAPH_DC_BAR``, where
    eager against eager shows the atomics' part, and a dropped iteration (9
    of 10: 39 of 40 have converged to rounding on TUM) and each buffer left
    at the other step's values fail the bar; a whole
    ``run_global_ba`` by both routes (final costs within the cell's
    ``cost_gap``, exactly 1,230 sweep launches each, peak memory, host ms,
    the allocated memory back after the call, and the reserve after each,
    which three more graph runs must not grow: each solve's graph and its
    memory pool are freed when it returns); the copy of W into the graph's
    buffer timed. Then one ``async_gba`` closure: ``System._launch_global_ba``
    on its thread and stream (its solves graphed) while the main thread
    tracks, against the same BA inline."""
    from orbslam2_with_quadrics_tpu_torch.models import local_mapping as lm
    from orbslam2_with_quadrics_tpu_torch.ops import ba
    from orbslam2_with_quadrics_tpu_torch.ops import cuda_kernels as ck

    out = {}
    for cell_name in ("kitti00_stereo.gba", "tum_fr1_desk_rgbd.gba"):
        cell, m, Kc, bf, tab = bench_map(cell_name, seed, dev)
        prob = lm.global_ba_problem(m, Kc, bf, tab)
        (cp_a, H_a, g_a), (cp_b, H_b, g_b) = pcg_steps(prob)
        eager = [ba._pcg(g, lambda x: ba._schur_matvec(x, cp, H), torch.linalg.inv_ex(H)[0], n)
                 for cp, H, g, n in ((cp_a, H_a, g_a, 40), (cp_a, H_a, g_a, 40),
                                     (cp_a, H_a, g_a, 39), (cp_b, H_b, g_b, 40))]
        # where 40 iterations have converged to float32 rounding, 39 give the
        # same dc: a dropped iteration is shown at 10, where each one counts
        short = ba.GraphedPCG(10)
        ten = [ba._pcg(g_a, lambda x: ba._schur_matvec(x, cp_a, H_a),
                       torch.linalg.inv_ex(H_a)[0], n) for n in (10, 9)]
        pcg = ba.GraphedPCG(40)
        graph_a = pcg(cp_a, H_a, g_a).clone()
        graph_b = pcg(cp_b, H_b, g_b).clone()
        gaps = {"eager twice": dc_gap(eager[1], eager[0]),
                "graph step 1": dc_gap(graph_a, eager[0]),
                "graph step 2": dc_gap(graph_b, eager[3]),
                "graph of 10": dc_gap(short(cp_a, H_a, g_a), ten[0]),
                "39 of 40 iterations": dc_gap(eager[2], eager[0]),
                "9 of 10 iterations": dc_gap(ten[1], ten[0])}
        short.close()
        # each buffer left at step 1's values under step 2's others
        stale = {"g": (g_a, None, None), "Hcc_d": (None, H_a, None), "W": (None, None, cp_a)}
        for what, (g_s, H_s, cp_s) in stale.items():
            pcg.load(cp_b, H_b, g_b)
            if g_s is not None:
                pcg.g.copy_(g_s)
            if H_s is not None:
                pcg.H.copy_(H_s)
            if cp_s is not None:
                pcg.cp.Wcp.copy_(cp_s.Wcp)
            gaps[f"stale {what}"] = dc_gap(pcg.run(), eager[3])
        pcg.load(cp_b, H_b, g_b)
        pcg.Minv.copy_(torch.linalg.inv_ex(H_a)[0])
        gaps["stale Hcc_d^-1"] = dc_gap(pcg.run(), eager[3])
        pcg.load(cp_b, H_b, g_b)
        pcg.cp.Hpp_inv4.copy_(cp_a.Hpp_inv4)
        gaps["stale Hpp^-1"] = dc_gap(pcg.run(), eager[3])
        # the copy of W into the buffer, as each step makes it
        w_copy_ms = cuda_median_ms(lambda: pcg.cp.Wcp.copy_(cp_b.Wcp), reps=10)
        pcg.close()
        log(f"[graph] {cell_name}: dc gaps (of max |dc|) {json.dumps(gaps)}; the bar "
            f"{GRAPH_DC_BAR}; W copy {w_copy_ms:.4f} ms ({cp_b.Wcp.numel() * 4 / 1e6:.1f} MB) "
            f"({smi})")
        if not all(gaps[k] <= GRAPH_DC_BAR for k in ("graph step 1", "graph step 2",
                                                      "graph of 10")):
            raise AssertionError(f"graphed PCG against eager at {cell_name}: {gaps}")
        missed = [k for k, v in gaps.items() if k.startswith(("9 of", "stale")) and
                  not v > GRAPH_DC_BAR]
        if missed:
            raise AssertionError(f"the dc bar {GRAPH_DC_BAR} does not catch {missed}: {gaps}")
        del cp_a, cp_b, H_a, H_b, g_a, g_b, eager, graph_a, graph_b, prob

        # whole run_global_ba by each route; the graph's thrice more, to
        # see its memory pools freed with it: the reserve does not grow
        res = {}
        route = ba.pcg_route
        for name in ("graph", "eager", "graph", "eager", "graph", "graph", "graph"):
            ba.pcg_route = route if name == "graph" else (lambda prob, cg_iters, group=None: None)
            try:
                torch.cuda.synchronize()
                alloc0, n0 = torch.cuda.memory_allocated(), ck.LAUNCHES["ba_schur_sweep"]
                torch.cuda.reset_peak_memory_stats()
                t = time.perf_counter()
                m2, cost = lm.run_global_ba(m, Kc, bf, tab, n_iters=int(cell.mix["n_iters"]))
                torch.cuda.synchronize()
                ms_ = 1e3 * (time.perf_counter() - t)
                r = {"ms": ms_, "cost": float(cost),
                     "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
                     "launches": ck.LAUNCHES["ba_schur_sweep"] - n0}
                del m2, cost
                torch.cuda.synchronize()
                r["alloc_left"] = torch.cuda.memory_allocated() - alloc0
                r["reserved_gb"] = torch.cuda.memory_reserved() / 1e9
            finally:
                ba.pcg_route = route
            res.setdefault(name, []).append(r)
        gap = abs(res["graph"][1]["cost"] - res["eager"][1]["cost"]) / res["eager"][1]["cost"]
        grew = res["graph"][-1]["reserved_gb"] - res["graph"][1]["reserved_gb"]
        log(f"[graph] {cell_name}: run_global_ba graph {json.dumps(res['graph'])} eager "
            f"{json.dumps(res['eager'])}; final cost gap {gap:.3e} (cost_gap limit "
            f"{cell.limits['cost_gap']}); reserve grown over the last three graph runs "
            f"{grew:.6f} GB ({smi})")
        runs = res["graph"] + res["eager"]
        if not gap <= float(cell.limits["cost_gap"]) or any(r["launches"] != 1230 for r in runs) \
                or any(r["alloc_left"] != 0 for r in runs) or grew > 0:
            raise AssertionError(f"run_global_ba by graph and eager at {cell_name}: {res}, "
                                 f"cost gap {gap}")
        out[cell_name] = {"gaps": gaps, "w_copy_ms": w_copy_ms, "runs": res, "cost_gap": gap}
    out["async"] = async_gba_closure(smi, dev)
    return out


def async_gba_closure(smi, dev="cuda"):
    """One ``async_gba`` closure: the rgbd path's System tracks 20 frames,
    launches the global BA on its thread and stream (``_launch_global_ba``,
    as a loop closure does; its 15 LM steps replay their solve's PCG
    graph, by the ``ba.pcg`` spans) and tracks 20 more meanwhile, each followed by a synchronize of
    the tracking stream (the merge held back); the thread's map against
    ``run_global_ba`` of the same snapshot inline, by ``ba_agreement``'s
    bars."""
    from orbslam2_with_quadrics_tpu_torch.models import local_mapping as lm
    from orbslam2_with_quadrics_tpu_torch.models import system as sysm
    from orbslam2_with_quadrics_tpu_torch.utils import tracing

    spec = dict(PATHS["rgbd"])
    cfg, frames, _ = main_path_setup(dev, n_features=spec.pop("n_features"),
                                     n_levels=spec.pop("n_levels"), sys_kw=spec.pop("sys_kw"),
                                     **render_args("rgbd"))
    slam = sysm.System(cfg)
    for i, images in enumerate(frames[:20]):
        slam.track_rgbd(*images, timestamp=i / 30.0)
    slam._apply_gba_if_ready = lambda wait=False: None  # the merge held back
    overlapped = 0
    with tracing.collect() as spans:
        slam._launch_global_ba(0)
        for i, images in enumerate(frames[20:], 20):
            slam.track_rgbd(*images, timestamp=i / 30.0)
            stream_sync()
            overlapped += slam._gba_thread.is_alive()
        slam._gba_thread.join()
    torch.cuda.synchronize()
    graphed = [s["counts"]["graphed"] for s in spans if s["name"] == "ba.pcg"]
    snap, m2, _ = slam._gba_result
    inline, _ = lm.run_global_ba(snap, slam._K, float(cfg.frontend.bf), slam._inv_sigma2,
                                 n_iters=10)
    kf, pt = snap.kf_valid, snap.pt_valid
    dp, dx, _, ok = ba_agreement(m2.kf_pose[kf].cpu().numpy(), m2.pt_pos[pt].cpu().numpy(), 0.0,
                                 inline.kf_pose[kf].cpu().numpy(),
                                 inline.pt_pos[pt].cpu().numpy(), 0.0)
    moved = float((inline.kf_pose[kf] - snap.kf_pose[kf]).abs().max())
    r = {"keyframes": int(kf.sum()), "points": int(pt.sum()), "pose_gap": dp, "point_gap": dx,
         "moved": moved, "frames_during": overlapped, "state": int(slam.state),
         "pcg_graphed": graphed}
    log(f"[graph] async_gba closure on its thread while tracking: {json.dumps(r)} ({smi})")
    slam.shutdown()
    if not ok or r["state"] != sysm.System.OK or moved == 0.0 or graphed != [1] * 15:
        raise AssertionError(f"async global BA against inline: {r}")
    return r


def mono_window(mono):
    """(prob0, (C, N), L, cam_ok): the local-BA problem of the last
    keyframe's window of the mono path's map (``run_main_path("mono")``'s
    result), as ``local_ba_problem`` builds it, its free poses and points
    moved off the optimum from a seed; its edge grid, its local slots and
    which of its keyframe slots are live."""
    from orbslam2_with_quadrics_tpu_torch.models import local_mapping as lm
    from orbslam2_with_quadrics_tpu_torch.ops import lie

    slam = mono["slam"]
    m = slam.map
    dev = m.pt_pos.device
    slot = torch.tensor(slam.ref_kf, device=dev)
    prob0, _, cam_ok, g_obs, _ = lm.local_ba_problem(
        m, slot, slam._K, float(slam.cfg.frontend.bf), slam._inv_sigma2,
        window=slam.cfg.local_ba_window)
    C, N = g_obs.shape
    P = m.pt_pos.shape[0]
    g = torch.Generator(device=dev).manual_seed(0)
    free_c = (1.0 - prob0.fixed_cam)[:, None]
    free_p = (1.0 - prob0.fixed_pnt)[:, None]
    prob0 = prob0._replace(
        poses=lie.se3_retract(prob0.poses, 2e-3 * free_c * torch.randn(
            (C, 6), generator=g, device=dev)),
        points=prob0.points + 5e-3 * free_p * torch.randn((P, 3), generator=g, device=dev))
    return prob0, (C, N), min(P, 8192), cam_ok


def phase_dense_ba(mono, smi):
    """Local BA's two solvers on the card, on the last keyframe's window of
    the mono path's map (the free poses and points moved off the optimum
    from a seed): 6 plain LM steps of the dense-Schur ``ba_solve_dense``
    (the card's local BA) against the PCG ``ba_solve`` on its edges purged
    by ``edge_chi2`` and with a second camera held (the window's live
    keyframes have no fixed boundary camera, and the monocular scale is a
    gauge freedom that each solver would leave wherever its rounding takes
    it), then both local-BA schedules (4 Huber steps, the purge, 6 plain
    steps) timed on the problem as the path builds it. ``ba_dense_terms``
    on the same window with the second camera held: at every step of the
    4 + 6 schedule run through the plain version, the kernels on that step's
    inputs against it (``terms_agreement``); the schedule through the
    kernels against it through the plain version (poses within 1e-4, cost
    within 1e-3 relative); one LM step's terms (the terms pass, the point
    pass and the cost at a candidate: 3 launches) timed as the frame
    kernels are. Returns the timings."""
    from orbslam2_with_quadrics_tpu_torch.models import local_mapping as lm
    from orbslam2_with_quadrics_tpu_torch.ops import ba

    prob0, (C, N), L, cam_ok = mono_window(mono)
    P = prob0.points.shape[0]
    _, inl = ba.edge_chi2(prob0)
    held = prob0.fixed_cam.clone()
    held[torch.nonzero(held < 0.5)[0, 0]] = 1.0
    prob = prob0._replace(valid=prob0.valid * inl.to(torch.float32), fixed_cam=held)
    loc_ids, _ = ba._local_point_index(prob, L, (C, N))
    n_local = int((loc_ids < P).sum())
    pcg, c_pcg = ba.ba_solve(prob, n_iters=6, cg_iters=40, use_huber=False)
    den, c_den = ba.ba_solve_dense(prob, n_iters=6, n_local_pts=L, use_huber=False,
                                   cam_grid=(C, N))
    c0 = float(ba._cost_grid(prob, prob.poses, prob.points, 0.0, (C, N)))
    err = float((den.poses - pcg.poses).abs().max())
    rel = abs(float(c_den) - float(c_pcg)) / max(float(c_pcg), 1.0)
    t = {"ba_solve_dense_ms": wall_ms(lambda: ba.ba_solve_dense(
             prob, n_iters=6, n_local_pts=L, use_huber=False, cam_grid=(C, N))),
         "ba_solve_dense_plain_ms": wall_ms(lambda: ba.ba_solve_dense(
             prob, n_iters=6, n_local_pts=L, use_huber=False, cam_grid=(C, N),
             terms=ba.dense_terms_plain)),
         "ba_solve_ms": wall_ms(lambda: ba.ba_solve(prob, n_iters=6, cg_iters=40,
                                                    use_huber=False)),
         "dense_schedule_ms": wall_ms(lambda: lm._dense_schedule(prob0, (C, N), 4, 6)),
         "dense_schedule_plain_ms": wall_ms(lambda: lm._dense_schedule(
             prob0, (C, N), 4, 6, terms=ba.dense_terms_plain)),
         "pcg_schedule_ms": wall_ms(lambda: lm._schedule(prob0, 4, 6))}
    log(f"[solver] local BA on the mono map's window: C = {C} cameras "
        f"({int(cam_ok.sum())} live, {int((prob.fixed_cam < 0.5).sum())} free in the "
        f"comparison), N = {N}, "
        f"P = {P}, L = {L} ({n_local} local points), {int(prob.valid.sum())} inlier edges; "
        f"cost {c0:.2f} -> dense {float(c_den):.4f} / PCG {float(c_pcg):.4f} (relative "
        f"{rel:.2e}), poses within {err:.2e}; 6 LM steps: ba_solve_dense "
        f"{t['ba_solve_dense_ms']:.2f} ms (through the plain terms "
        f"{t['ba_solve_dense_plain_ms']:.2f} ms), ba_solve {t['ba_solve_ms']:.2f} ms; schedule "
        f"4 + 6: dense {t['dense_schedule_ms']:.2f} ms (through the plain terms "
        f"{t['dense_schedule_plain_ms']:.2f} ms), PCG {t['pcg_schedule_ms']:.2f} ms ({smi})")
    if not (err <= 1e-4 and rel <= 1e-3 and float(c_den) < c0):
        raise AssertionError(f"ba_solve_dense disagrees with ba_solve on the card: poses {err}, "
                             f"cost {rel}")

    # ba_dense_terms at every step of the schedule, on the plain route's states
    held0 = prob0._replace(fixed_cam=held)
    steps = []
    rejected = []  # cost calls at a candidate both routes make non-finite

    def checked(pr, poses, points, d2, grid, lam=None, ploc=None, n_local=0):
        ref = ba.dense_terms_plain(pr, poses, points, d2, grid, lam, ploc, n_local)
        got = ba.dense_terms(pr, poses, points, d2, grid, lam, ploc, n_local)
        if ploc is None:
            # a step whose S is not positive definite gives a NaN candidate
            # (_cholesky_solve_nan), whose cost is NaN in both routes: both
            # then reject it, which is agreement; one route alone non-finite
            # is not
            if not (bool(torch.isfinite(got)) or bool(torch.isfinite(ref))):
                rejected.append(len(steps))
                d = 0.0
            else:
                d = ba_relative(got, ref)
            steps.append(({"cost": d}, d <= 1e-5))
        else:
            p64 = in_float64(pr)
            exact = ba.dense_terms_plain(p64, poses.double(), points.double(), d2, grid,
                                         lam.double(), ploc, n_local)
            steps.append(terms_agreement(got, ref, exact))
        return ref

    lm._dense_schedule(held0, (C, N), 4, 6, terms=checked)
    worst = {}
    for d, _ in steps:
        for k, v in d.items():
            worst[k] = ([max(a, b) for a, b in zip(worst.get(k, v), v)] if isinstance(v, list)
                        else max(worst.get(k, 0.0), v))
    n_bad = sum(not ok for _, ok in steps)
    log(f"[kernel] ba_dense_terms at every step of the 4 + 6 schedule ({len(steps)} calls, "
        f"{n_bad} off the bars; calls {rejected} at a candidate both routes make non-finite, "
        f"so both reject it): largest relative distance to the plain version "
        f"{json.dumps({k: v for k, v in worst.items() if not k.endswith('float64')})}; "
        f"Hpi, Hpib, VH from a float64 evaluation [kernel, plain] "
        f"{json.dumps({k: v for k, v in worst.items() if k.endswith('float64')})}")
    for i, (d, ok) in enumerate(steps):
        if not ok:
            log(f"[kernel] ba_dense_terms call {i} off the bars: {json.dumps(d)}")
    if n_bad:
        raise AssertionError(f"ba_dense_terms disagrees with its plain version on {n_bad} calls")
    sk, ck_cost = lm._dense_schedule(held0, (C, N), 4, 6)
    sp, cp_cost = lm._dense_schedule(held0, (C, N), 4, 6, terms=ba.dense_terms_plain)
    dpose = float((sk.poses - sp.poses).abs().max())
    dcost = abs(float(ck_cost) - float(cp_cost)) / max(float(cp_cost), 1.0)
    log(f"[kernel] ba_dense_terms: the 4 + 6 schedule through the kernels against it through "
        f"the plain version: poses within {dpose:.3g} (tolerance 1e-4), cost {float(ck_cost):.5f} "
        f"vs {float(cp_cost):.5f} ({dcost:.3g} relative, tolerance 1e-3)")
    if not (dpose <= 1e-4 and dcost <= 1e-3):
        raise AssertionError(f"the dense schedule through ba_dense_terms disagrees: poses "
                             f"{dpose}, cost {dcost}")

    # one LM step's terms at the path's shapes: timed, and its bound
    _, index0 = ba._local_point_index(prob0, L, (C, N))
    k = time_dense_terms(prob0, index0, (C, N), L, smi)
    t["ba_dense_terms"] = {"mono window": k}
    t["ba_dense_terms_err"] = max(worst[f] for f in ("Hcc_d", "cost", "V"))
    return t


def phase_quadric_ba(run, smi):
    """``quadric_ba_solve`` (8 LM steps of 40 CG steps, as ``joint_ba``) on
    the quadric path's final map and landmarks, and again with its free
    keyframe poses and points moved off that state from a seed (the cost
    must fall), timed."""
    from orbslam2_with_quadrics_tpu_torch.ops import lie, quadrics, residuals

    slam = run["slam"]
    prob = slam.quadrics.ba_problem(slam.map, slam._inv_sigma2)
    if prob is None:
        raise AssertionError("the quadric path ended with no bbox edge")
    base = prob.base
    dev = base.points.device
    g = torch.Generator(device=dev).manual_seed(0)
    moved = prob._replace(base=base._replace(
        poses=lie.se3_retract(base.poses, 1e-3 * (1.0 - base.fixed_cam)[:, None] * torch.randn(
            base.poses.shape[:1] + (6,), generator=g, device=dev)),
        points=base.points + 2e-3 * (1.0 - base.fixed_pnt)[:, None] * torch.randn(
            base.points.shape, generator=g, device=dev)))
    costs = []
    for p in (prob, moved):
        c0 = float(quadrics._quadric_cost(p, slam._K, residuals.CHI2_STEREO)[0])
        costs.append((c0, float(quadrics.quadric_ba_solve(p, slam._K, n_iters=8)[1])))
    ms_ = wall_ms(lambda: quadrics.quadric_ba_solve(moved, slam._K, n_iters=8))
    log(f"[solver] quadric_ba_solve: {prob.qe_cam.numel()} bbox edges of "
        f"{prob.quad_pose.shape[0]} landmarks, {int(base.valid.sum())} point edges over "
        f"{base.poses.shape[0]} keyframe slots: {ms_:.2f} ms; cost from the path's final state "
        f"{costs[0][0]:.3f} -> {costs[0][1]:.3f}, moved off it {costs[1][0]:.3f} -> "
        f"{costs[1][1]:.3f} ({smi})")
    if not (all(np.isfinite(c) and c <= c0 for c0, c in costs) and costs[1][1] < costs[1][0]):
        raise AssertionError(f"quadric_ba_solve on the card: costs {costs}")
    return ms_


def native_toolchain() -> str:
    """Whether the host has what ``utils/image_io`` builds the native image
    loader with: ``g++`` and the libpng / libjpeg headers."""
    import shutil

    cxx = shutil.which("g++")
    if cxx is None:
        return "g++ absent"
    found = [cxx]
    for header in ("png.h", "jpeglib.h"):
        r = subprocess.run([cxx, "-E", "-x", "c++", "-"], input=f"#include <{header}>\n",
                           capture_output=True, text=True)
        found.append(f"{header} {'present' if r.returncode == 0 else 'absent'}")
    return ", ".join(found)


def main() -> int:
    log(f"[env] torch {torch.__version__} cuda {torch.version.cuda}")
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this run needs one CUDA card",
              file=sys.stderr)
        return 1
    name = torch.cuda.get_device_name(0)
    log(f"[env] device 0: {name}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    log(smi)  # the card's name and power limit, as nvidia-smi prints them
    log("[env] modules the port's drivers may use: " + ", ".join(
        f"{m} {'present' if importlib.util.find_spec(m) else 'absent'}"
        for m in ("yaml", "cv2", "PIL", "imageio")))
    log(f"[env] the native image loader's toolchain: {native_toolchain()}")

    # the orbit's 500 frames take a minute to render: a worker process does
    # it while the kernel and solver phases and the two capacity runs (whose
    # frame times are not quoted) keep this one busy; one worker, so that
    # the host-bound paths after them find the host's cores free
    spawn = multiprocessing.get_context("spawn")
    with concurrent.futures.ProcessPoolExecutor(1, mp_context=spawn) as pool, \
            tempfile.TemporaryDirectory() as tmp:
        orbit = pool.submit(render_sequence, **render_args("loop"))
        datasets = pool.submit(write_driver_sequences, os.path.join(tmp, "datasets"))
        max_err, times = phase_kernels(smi)
        frame_kernels = phase_frame_kernels(smi)
        sweeps, sweeps_per_gba = phase_schur_sweep(smi)
        # first on the card after the kernels: warmup() pays the first-use costs
        runs = [run_main_path("resume")]
        phase_solvers(smi)
        phase_graphed_pcg(smi)
        runs += [run_main_path("capacity"), run_main_path("capacity", sync=True),
                 run_main_path("mono")]
        dense = phase_dense_ba(runs[-1], smi)
        runs += [run_main_path("rgbd"), run_main_path("stereo"), run_main_path("quadric")]
        phase_quadric_ba(runs[-1], smi)
        runs += [run_main_path("reloc"),
                 run_main_path("loop", log_every=50, rendered=orbit.result())]
        runs += phase_drivers(smi, datasets.result(), tmp)
        _, tool_launches = phase_tools(smi, tmp)
        _, bench_launches = phase_bench(smi)
    dist_out = phase_dist(smi)
    log(f"[dist] {json.dumps(dist_out)}")
    by_path = {}  # path -> {kernel: launches}
    for res in runs:
        by_path[res["path"]] = {k: res["launches"][k] for k in KERNEL_SOURCE}
        n = res["launches"]
        log(f"[{res['path']}] median frame {res['frame_ms_median']:.2f} ms, median mapping "
            f"pass {res['map_ms_median']:.2f} ms; kernel launches {json.dumps(n)} over "
            f"{res['n_frame_steps']} tracked frames, {res['n_calls']['images']} images and "
            f"{res['n_map_passes']} mapping passes ({smi})")
        if "quadric" in res:
            q = res["quadric"]
            log(f"[{res['path']}] {q['landmarks']} landmarks, {q['initialized']} initialized, "
                f"{q['bbox_edges']} bbox edges; joint_ba median {q['joint_ba_ms_median']:.2f} ms "
                f"over {q['joint_ba_calls']} keyframes; quadric_init ms "
                f"{[round(x, 2) for x in q['quadric_init_ms']]}; median IoU {q['iou_median']} "
                f"over {q['iou_n']} keyframes ({smi})")
        log(smi)
    for tag, n in list(tool_launches.items()) + list(bench_launches.items()):
        by_path[tag] = {k: n[k] for k in KERNEL_SOURCE}
    mono = next(r for r in runs if r["path"] == "mono")
    headline = {"masked_hamming_best2": "main-B 4096x1024",  # local-map tracking
                "pose_lm": "stageB mono 1024", "orb_detect": "480x640 rendered",
                "orb_describe": "480x640 rendered", "ba_dense_terms": "mono window",
                "ba_schur_sweep": "point_to_cam kitti 4096000 rows"}
    # the largest difference to the plain version: Hamming and detection
    # exact, the pose, the angle in rad, the dense terms' camera blocks,
    # coupling and cost relative
    errors = {"masked_hamming_best2": max_err, "pose_lm": frame_kernels["pose_lm"][0],
              "orb_detect": frame_kernels["orb_detect"][0],
              "orb_describe": frame_kernels["orb_describe"][0],
              "ba_dense_terms": dense["ba_dense_terms_err"],
              "ba_schur_sweep": max(t["err"] for t in sweeps.values())}
    shapes = {"masked_hamming_best2": times, "pose_lm": frame_kernels["pose_lm"][1],
              "orb_detect": frame_kernels["orb_detect"][1],
              "orb_describe": frame_kernels["orb_describe"][1],
              "ba_dense_terms": dense["ba_dense_terms"], "ba_schur_sweep": sweeps}
    per_frame = {  # on the mono path, per tracked frame (the hamming kernel's
        # mapping-pass launches taken out), per image, per mapping pass
        "masked_hamming_best2": (by_path["mono"]["masked_hamming_best2"]
                                 - 2 * mono["n_map_passes"]) / max(mono["n_frame_steps"], 1),
        "pose_lm": by_path["mono"]["pose_lm"] / max(mono["n_frame_steps"], 1),
        "orb_detect": by_path["mono"]["orb_detect"] / max(mono["n_calls"]["images"], 1),
        "orb_describe": by_path["mono"]["orb_describe"] / max(mono["n_calls"]["images"], 1),
        "ba_dense_terms": by_path["mono"]["ba_dense_terms"] / max(mono["n_map_passes"], 1),
        "ba_schur_sweep": sweeps_per_gba}
    per_unit = {"masked_hamming_best2": "tracked frame", "pose_lm": "tracked frame",
                "orb_detect": "image", "orb_describe": "image",
                "ba_dense_terms": "mapping pass", "ba_schur_sweep": "run_global_ba"}
    kernels = []
    for kname in KERNEL_SOURCE:
        t = shapes[kname][headline[kname]]
        kernels.append({
            "name": kname, "route": "cuda", "source": KERNEL_SOURCE[kname],
            "replaces": KERNEL_REPLACES[kname],
            "launches": sum(p[kname] for p in by_path.values()),
            "launches_by_path": {p: v[kname] for p, v in by_path.items()},
            "launches_per_frame": per_frame[kname], "launches_per": per_unit[kname],
            "max_abs_err": errors[kname],
            "ms": t["kernel_ms"], "kernel_ms": t["kernel_ms"], "call_ms": t["call_ms"],
            "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
            "library_ms": None, "shapes": shapes[kname]})
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
