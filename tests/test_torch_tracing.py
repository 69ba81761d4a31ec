"""The port's span tracer (``utils/tracing.py``) and its spans in the global
BA: off it records nothing and launches nothing; on, one ``run_global_ba``
gives the span tree of its problem build, its two solves, their LM steps
and the purge, with their counts, on the profiler's clock, from any
thread. A small map on the CPU; no JAX, so the test marked ``cuda`` runs on
a card as it stands."""

import contextlib
import sys
import threading

import pytest
import torch

from orbslam2_with_quadrics_tpu_torch.models import local_mapping as lm
from orbslam2_with_quadrics_tpu_torch.models import map_state as ms
from orbslam2_with_quadrics_tpu_torch.ops import ba, lie
from orbslam2_with_quadrics_tpu_torch.utils import tracing
from test_torch_schur_sweep import pcg_graph_stand_in  # noqa: F401  (a fixture)

K_SLOTS, N_FEAT, P_SLOTS = 8, 48, 96
CAM = torch.tensor([400.0, 400.0, 160.0, 120.0])
BF = 40.0


def small_map(device="cpu"):
    """6 live keyframes of 8 slots along x, 80 live points of 96 in front of
    them, each keyframe observing 40 (half stereo); one observation in
    twelve moved 25 px (the purge's work) and one of a culled point; poses
    but keyframe 0's and points moved off the truth."""
    g = torch.Generator().manual_seed(7)
    m = ms.empty_map(ms.MapConfig(max_keyframes=K_SLOTS, max_points=P_SLOTS, n_features=N_FEAT,
                                  n_levels=4, device="cpu"))
    n_kf, n_pt = 6, 80
    pts = torch.stack([torch.rand(n_pt, generator=g) * 4 - 2, torch.rand(n_pt, generator=g) * 2 - 1,
                       torch.rand(n_pt, generator=g) * 4 + 4], 1)
    pose = lie.se3_identity((K_SLOTS,))
    pose[:n_kf, 4] = -0.2 * torch.arange(n_kf)
    obs = torch.full((K_SLOTS, N_FEAT), -1, dtype=torch.int32)
    uv = torch.zeros(K_SLOTS, N_FEAT, 2)
    ur = torch.full((K_SLOTS, N_FEAT), -1.0)
    for k in range(n_kf):
        ids = torch.randperm(n_pt, generator=g)[:40]
        pc = lie.se3_apply(pose[k], pts[ids])
        u = CAM[0] * pc[:, 0] / pc[:, 2] + CAM[2] + 0.3 * torch.randn(40, generator=g)
        v = CAM[1] * pc[:, 1] / pc[:, 2] + CAM[3] + 0.3 * torch.randn(40, generator=g)
        u = torch.where(torch.arange(40) % 12 == 5, u + 25.0, u)
        obs[k, :40] = ids.to(torch.int32)
        uv[k, :40] = torch.stack([u, v], 1)
        ur[k, :40] = torch.where(torch.arange(40) % 2 == 0, u - BF / pc[:, 2], -1.0)
    pt_valid = torch.zeros(P_SLOTS, dtype=torch.bool)
    pt_valid[:n_pt] = True
    pt_valid[3] = False
    start = pose.clone()
    start[1:n_kf, 4:] += 0.01 * torch.randn(n_kf - 1, 3, generator=g)
    pos = torch.zeros(P_SLOTS, 3)
    pos[:n_pt] = pts + 0.02 * torch.randn(n_pt, 3, generator=g)
    kf_valid = torch.zeros(K_SLOTS, dtype=torch.bool)
    kf_valid[:n_kf] = True
    m = m._replace(kf_pose=start, kf_valid=kf_valid, kf_uv=uv, kf_ur=ur,
                   kf_level=torch.randint(0, 4, (K_SLOTS, N_FEAT), generator=g, dtype=torch.int32),
                   kf_kp_valid=obs >= 0, kf_obs_point=obs, pt_pos=pos, pt_valid=pt_valid)
    m = ms.MapState(*(t.to(device) for t in m))
    tab = (1.2 ** (-2.0 * torch.arange(4))).to(device)
    return m, CAM.to(device), tab


def solve(m, Kc, tab):
    out, cost = lm.run_global_ba(m, Kc, BF, tab, n_iters=10)
    return out.kf_pose, out.pt_pos, cost


@pytest.fixture
def traced_solve():
    m, Kc, tab = small_map()
    with tracing.collect() as spans:
        out = solve(m, Kc, tab)
    return m, out, spans


def by_name(spans, name):
    return [s for s in spans if s["name"] == name]


def test_off_records_nothing_and_changes_nothing(monkeypatch):
    """Off: no ``record_function``, no CUDA event, no count reduction and
    no record; the solve is bit-identical to a traced one."""
    m, Kc, tab = small_map()
    tracing.clear()

    def boom(*a, **k):
        raise AssertionError("called with the tracer off")

    with monkeypatch.context() as mp:
        mp.setattr(torch.profiler, "record_function", boom)
        mp.setattr(torch.cuda, "Event", boom)
        mp.setattr(torch, "count_nonzero", boom)
        assert tracing.span("ba.x") is tracing.span("ba.y", torch.device("cpu"))
        off = solve(m, Kc, tab)
    assert tracing.spans() == [] and tracing.dropped() == 0
    with tracing.collect() as spans:
        on = solve(m, Kc, tab)
    assert len(spans) > 0
    for a, b in zip(off, on):
        assert torch.equal(a, b)


def test_off_handle_is_false_and_ignores_counts():
    tracing.clear()
    sp = tracing.span("ba.x")
    assert not sp
    with sp as h:
        h.count(rows=3)
    assert tracing.spans() == []


def test_global_ba_span_tree(traced_solve):
    _, _, spans = traced_solve
    names = [s["name"] for s in spans]
    assert {n: names.count(n) for n in set(names)} == {
        "gba.solve": 1, "gba.build": 1, "ba.solve": 2, "ba.purge": 1, "ba.step": 15,
        "ba.system": 15, "ba.pcg": 15, "ba.update": 15}
    root = by_name(spans, "gba.solve")[0]
    assert root["parent"] is None and {s["trace"] for s in spans} == {root["id"]}
    ids = {s["id"]: s for s in spans}
    for name in ("gba.build", "ba.solve", "ba.purge"):
        assert all(s["parent"] == root["id"] for s in by_name(spans, name))
    solves = sorted(by_name(spans, "ba.solve"), key=lambda s: s["id"])
    assert [s["counts"]["steps"] for s in solves] == [5, 10]
    steps = by_name(spans, "ba.step")
    assert [sum(s["parent"] == v["id"] for s in steps) for v in solves] == [5, 10]
    for st in steps:
        kids = sorted((s for s in spans if s["parent"] == st["id"]), key=lambda s: s["id"])
        assert [k["name"] for k in kids] == ["ba.system", "ba.pcg", "ba.update"]
        assert ids[st["parent"]]["name"] == "ba.solve"
        assert by_name(kids, "ba.pcg")[0]["counts"] == {"iters": 40, "graphed": 0}
        # the three children cover the step, one after another, inside it
        bounds = [st["start_ns"]] + [t for k in kids for t in (k["start_ns"], k["end_ns"])] \
            + [st["end_ns"]]
        assert bounds == sorted(bounds)
    assert all(s["device_ms"] is None and s["host_ms"] > 0 for s in spans)   # the CPU


def test_global_ba_counts(traced_solve):
    m, _, spans = traced_solve
    _, _, okobs = lm._valid_obs(m)
    live = int(okobs.sum())
    assert by_name(spans, "gba.solve")[0]["counts"] == {"rows": K_SLOTS * N_FEAT}
    solves = sorted(by_name(spans, "ba.solve"), key=lambda s: s["id"])
    firsts = [min((s for s in by_name(spans, "ba.step") if s["parent"] == v["id"]),
                  key=lambda s: s["id"]) for v in solves]
    purged = by_name(spans, "ba.purge")[0]["counts"]["purged"]
    assert [f["counts"] for f in firsts] == [{"rows": K_SLOTS * N_FEAT, "live_rows": live},
                                             {"rows": K_SLOTS * N_FEAT, "live_rows": live - purged}]
    # the purge's count is the edges it drops: the schedule's first solve
    # and purge made again, untraced
    _, pnt, ok = lm._valid_obs(m)
    ar = torch.arange(K_SLOTS)
    uvr, is_st, is2, cam_idx = lm._edge_table(m, ar, 1.2 ** (-2.0 * torch.arange(4)))
    prob = ba.BAProblem(poses=m.kf_pose, points=m.pt_pos, K=CAM, bf=BF, cam_idx=cam_idx,
                        pnt_idx=pnt.reshape(-1), uvr=uvr, is_stereo=is_st, inv_sigma2=is2,
                        valid=ok.reshape(-1).to(torch.float32),
                        fixed_cam=((~m.kf_valid) | (ar == 0)).to(torch.float32),
                        fixed_pnt=(~m.pt_valid).to(torch.float32))
    prob, _ = ba.ba_solve(prob, n_iters=5, cg_iters=40, use_huber=True)
    _, inl = ba.edge_chi2(prob)
    assert purged == int((prob.valid > 0).sum() - ((prob.valid > 0) & inl).sum()) > 0


@pytest.mark.parametrize("graphed", [0, 1])
def test_pcg_span_says_which_route_ran(graphed, request):
    """``ba.pcg``'s ``graphed`` count: 0 on the eager PCG (the CPU), 1 where
    the step replayed its solve's graph (the card's route, here with the
    graph's eager stand-in: one capture a ``ba_solve`` call); the answer is
    the same either way."""
    m, Kc, tab = small_map()
    want = solve(m, Kc, tab)
    made = request.getfixturevalue("pcg_graph_stand_in") if graphed else []
    with tracing.collect() as spans:
        got = solve(m, Kc, tab)
    assert [s["counts"] for s in by_name(spans, "ba.pcg")] == [
        {"iters": 40, "graphed": graphed}] * 15
    assert len(made) == 2 * graphed
    assert all(torch.equal(a, b) for a, b in zip(got, want))


def test_spans_lie_on_the_profilers_events():
    """Under ``torch.profiler`` each span is a CPU event of its own name,
    inside the span's host stamps (but for the clocks' conversion jitter),
    and the stamps match the events' within 0.1 ms (the median over the
    spans: a thread the OS preempts between a stamp and its event widens
    that one span)."""
    import statistics

    from torch.profiler import ProfilerActivity, profile

    m, Kc, tab = small_map()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with tracing.span("ba.first"):   # a profile's first record_function sets up for ~0.1-1 ms
            pass
        tracing.clear()
        solve(m, Kc, tab)
    spans = tracing.spans()
    tracing.clear()
    assert len(spans) == 65
    events = {}
    for e in prof.profiler.kineto_results.events():
        events.setdefault(e.name(), []).append((e.start_ns(), e.end_ns()))
    gaps = []
    for name in {s["name"] for s in spans}:
        mine = sorted((s["start_ns"], s["end_ns"]) for s in by_name(spans, name))
        theirs = sorted(events[name])
        assert len(mine) == len(theirs), name
        for (a, b), (c, d) in zip(mine, theirs):
            assert c - a > -50_000 and b - d > -50_000, (name, c - a, b - d)
            gaps += [abs(c - a), abs(b - d)]
    assert statistics.median(gaps) < 100_000, sorted(gaps)[-5:]


def test_threads_keep_their_own_parents_and_traces():
    """Spans opened on several threads at once, with the interpreter
    switching threads every few microseconds: each thread's spans nest
    under its own root, and none is lost."""
    n_threads, n_roots = 6, 40
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with tracing.collect() as spans:
            def work(i):
                for _ in range(n_roots):
                    with tracing.span(f"t{i}.root") as root:
                        root.count(thread=i)
                        with tracing.span(f"t{i}.child"):
                            with tracing.span(f"t{i}.leaf"):
                                pass
            threads = [threading.Thread(target=work, args=(i,)) for i in range(n_threads)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=60)
            assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    assert len(spans) == 3 * n_threads * n_roots
    ids = {s["id"]: s for s in spans}
    assert len(ids) == len(spans)
    for s in spans:
        i = s["name"].split(".")[0]
        if s["name"].endswith("root"):
            assert s["parent"] is None and s["trace"] == s["id"]
        else:
            parent = ids[s["parent"]]
            assert parent["name"].split(".")[0] == i and parent["trace"] == s["trace"]
            assert ids[s["trace"]]["name"] == f"{i}.root"


def test_the_store_is_bounded(monkeypatch):
    monkeypatch.setattr(tracing, "BOUND", 5)
    with tracing.collect() as spans:
        for i in range(8):
            with tracing.span(f"ba.n{i}"):
                pass
    assert [s["name"] for s in spans] == [f"ba.n{i}" for i in range(5)]
    assert tracing.dropped() == 3
    tracing.clear()
    assert tracing.spans() == [] and tracing.dropped() == 0


def test_counts_are_read_at_export():
    """A tensor count is kept as the tensor and read by ``spans()``; the
    store is left as it is until ``clear()``."""
    with tracing.collect() as spans:
        with tracing.span("ba.x") as sp:
            t = torch.zeros((), dtype=torch.int64)
            sp.count(n=t, rows=7, gates=torch.tensor([1, 2, 3, 4]))
            t += 5
    assert spans[0]["counts"] == {"n": 5, "rows": 7, "gates": [1, 2, 3, 4]}
    assert tracing.spans() == spans
    tracing.clear()
    assert tracing.spans() == []


def test_the_tracer_never_drains_the_device():
    """No synchronize anywhere in the tracer, and no host read but the
    export's."""
    src = open(tracing.__file__).read()
    assert "synchronize" not in src
    assert src.count(".item()") == 1 and src.count(".tolist()") == 1
    assert ".cpu()" not in src and ".numpy()" not in src


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: device spans time CUDA events")
    return torch.device("cuda")


@pytest.mark.cuda
def test_device_spans_on_a_side_stream_and_thread(cuda_device):
    """On the card: a span on the async global BA's thread and stream times
    that stream's work, and its device counts are read at export."""
    m, Kc, tab = small_map(cuda_device)
    with tracing.collect() as spans:
        box = {}
        stream = torch.cuda.Stream(cuda_device)

        def run():
            with torch.cuda.stream(stream):
                box["out"] = solve(m, Kc, tab)
            stream.synchronize()

        t = threading.Thread(target=run)
        t.start()
        t.join(timeout=300)
        assert not t.is_alive()
    assert len(spans) == 65
    assert all(s["device_ms"] is not None and s["device_ms"] > 0 for s in spans)
    assert [s["counts"]["graphed"] for s in by_name(spans, "ba.pcg")] == [1] * 15
    root = by_name(spans, "gba.solve")[0]
    steps = by_name(spans, "ba.step")
    assert sum(s["device_ms"] for s in steps) < root["device_ms"]
    _, _, okobs = lm._valid_obs(m)
    assert min(steps, key=lambda s: s["id"])["counts"]["live_rows"] == int(okobs.sum())


@pytest.mark.cuda
def test_spans_add_no_synchronize_on_card(cuda_device):
    """On the card, a traced solve makes no more synchronizing calls than an
    untraced one (CUDA's sync debug mode warns at each)."""
    import warnings

    m, Kc, tab = small_map(cuda_device)
    solve(m, Kc, tab)
    torch.cuda.synchronize()
    n = {}
    for on in (False, True):
        torch.cuda.set_sync_debug_mode("warn")
        try:
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                with tracing.collect() if on else contextlib.nullcontext():
                    solve(m, Kc, tab)
                    torch.cuda.set_sync_debug_mode("default")   # the export may read
        finally:
            torch.cuda.set_sync_debug_mode("default")
        n[on] = sum("synchroniz" in str(w.message) for w in caught)
    assert n[True] == n[False]
