"""The readers of the port's own spans (``gba_build_ms``, ``ba_system_ms``,
``ba_pcg_ms``, ``ba_update_ms``, ``ba_live_row_pct``) on hand-made span
lists with known answers, and an idle gap named by a program span."""

import importlib
from types import SimpleNamespace

import pytest
from torch.autograd import DeviceType

from orbslam2_with_quadrics_tpu_torch.utils import tracing
from port_bench import trace

READERS = ("gba_build_ms", "ba_system_ms", "ba_pcg_ms", "ba_update_ms", "ba_live_row_pct")


def reader(name):
    return importlib.import_module(f"port_bench.metrics.{name}").read


def window(steps_per_solve=(3, 2), device=True):
    """Spans of one solve per entry of ``steps_per_solve``, as the port's
    tracer exports them: a step's system, PCG and update take 2, 10 and
    1 ms (x the solve's number); the build 0.5 ms; 1,000 rows a step, 600
    live in the first solve's steps and 500 in the second's."""
    spans, ids = [], iter(range(1, 10_000))

    def add(name, parent, ms, **counts):
        sid = next(ids)
        spans.append({"name": name, "id": sid, "parent": parent, "trace": None, "host_ms": ms,
                      "device_ms": ms if device else None, "start_ns": 0, "end_ns": 0,
                      "counts": counts})
        return sid

    for i, n_steps in enumerate(steps_per_solve, 1):
        root = add("gba.solve", None, 100.0 * i, rows=1000)
        add("gba.build", root, 0.5)
        solve = add("ba.solve", root, 90.0 * i, steps=n_steps)
        for _ in range(n_steps):
            step = add("ba.step", solve, 13.0 * i, rows=1000, live_rows=600 if i == 1 else 500)
            add("ba.system", step, 2.0 * i)
            add("ba.pcg", step, 10.0 * i, iters=40)
            add("ba.update", step, 1.0 * i)
        add("ba.purge", root, 0.25, purged=3)
    return spans


def ctx(calls):
    return SimpleNamespace(calls=calls, window_s=1.0, notes=[],
                           counts={"edges": 600, "rows": 1000})


@pytest.fixture
def store(monkeypatch):
    box = {"spans": []}
    monkeypatch.setattr(tracing, "spans", lambda: box["spans"])
    return box


def test_readers_on_a_known_window(store):
    store["spans"] = window()
    c = ctx(2)
    assert reader("gba_build_ms")(c) == 0.5
    # 3 steps at 2 ms and 2 at 4 ms: 14 ms over 5 steps
    assert reader("ba_system_ms")(c) == pytest.approx(14.0 / 5)
    assert reader("ba_pcg_ms")(c) == pytest.approx(70.0 / 5)
    assert reader("ba_update_ms")(c) == pytest.approx(7.0 / 5)
    assert reader("ba_live_row_pct")(c) == pytest.approx(100.0 * (3 * 600 + 2 * 500) / 5000)
    assert any("gba.solve" in n for n in c.notes)
    assert "inputs 600 edges of 1000 rows; each solve's first step (live_rows, rows) " \
        "[(600, 1000), (500, 1000)]" in c.notes[-1]


@pytest.mark.parametrize("name", READERS)
def test_reader_finds_nothing(store, name):
    assert reader(name)(ctx(2)) is None                  # an empty store
    store["spans"] = window(device=False)                # spans off the card
    assert reader(name)(ctx(2)) is None


@pytest.mark.parametrize("name", READERS)
def test_reader_refuses_spans_of_other_solves(store, name):
    store["spans"] = window()
    for calls in (1, 3):
        with pytest.raises(RuntimeError, match="gba.solve"):
            reader(name)(ctx(calls))


@pytest.mark.parametrize("name", READERS)
def test_reader_of_a_program_without_the_tracer(monkeypatch, name):
    """The parent's program has no ``utils/tracing.py``: nothing to read,
    nothing raised."""
    import sys

    from orbslam2_with_quadrics_tpu_torch import utils

    monkeypatch.delattr(utils, "tracing")
    monkeypatch.setitem(sys.modules, "orbslam2_with_quadrics_tpu_torch.utils.tracing", None)
    assert reader(name)(ctx(2)) is None


class Event:
    def __init__(self, name, dev, s, t, annotation=False):
        self._v = (name, dev, s, t, annotation)

    def name(self):
        return self._v[0]

    def device_type(self):
        return self._v[1]

    def start_ns(self):
        return self._v[2]

    def end_ns(self):
        return self._v[3]

    def is_user_annotation(self):
        return self._v[4]


def test_idle_gap_named_by_a_program_span():
    """A gap whose midpoint finds the host inside ``ba.pcg`` and outside
    any aten op is named by the span; inside an op under it, by the op."""
    cpu, cuda = DeviceType.CPU, DeviceType.CUDA
    events = [
        Event("bench.solve", cpu, 0, 200), Event("gba.solve", cpu, 5, 195),
        Event("ba.step", cpu, 10, 190), Event("ba.pcg", cpu, 20, 180),
        Event("aten::index_add_", cpu, 100, 160), Event("cudaLaunchKernel", cpu, 30, 90),
        Event("ba.pcg", cuda, 20, 180, annotation=True),
        Event("k", cuda, 0, 10), Event("k", cuda, 90, 100), Event("k", cuda, 170, 200),
        Event("bench.sync", cpu, 200, 210),
    ]
    s = trace.summarize(SimpleNamespace(profiler=SimpleNamespace(
        kineto_results=SimpleNamespace(events=lambda: events))))
    gaps = dict((name, t) for name, t in s.idle_gaps)
    assert gaps["bench.solve:ba.pcg"] == 80e-9           # 10-90: midpoint 50, in no op
    assert gaps["bench.solve:aten::index_add_"] == 70e-9  # 100-170: midpoint 135
