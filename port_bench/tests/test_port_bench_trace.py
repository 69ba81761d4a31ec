"""Reading a profiler record: the union of device intervals, the spans'
copies on the device's timeline left out, and idle gaps named by the host."""

from types import SimpleNamespace

import numpy as np
from torch.autograd import DeviceType

from port_bench import trace


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


def fake_prof(events):
    return SimpleNamespace(profiler=SimpleNamespace(
        kineto_results=SimpleNamespace(events=lambda: events)))


def test_merge_is_the_union():
    iv = np.array([[5, 7], [0, 2], [1, 3], [6, 9], [10, 11]], dtype=float)
    assert trace.merge(iv).tolist() == [[0, 3], [5, 9], [10, 11]]


def test_summary():
    cpu, cuda = DeviceType.CPU, DeviceType.CUDA
    events = [
        Event("bench.solve", cpu, 0, 100), Event("aten::index_add_", cpu, 40, 70),
        Event("bench.solve", cuda, 0, 100, annotation=True),     # the span's copy: not work
        Event("k1", cuda, 10, 30), Event("k2", cuda, 20, 40), Event("k1", cuda, 75, 95),
        Event("bench.sync", cpu, 100, 120),
    ]
    s = trace.summarize(fake_prof(events))
    assert s.window_s == 120e-9 and s.busy_s == 50e-9
    assert s.device_ops == [["k1", 40e-9], ["k2", 20e-9]]
    assert s.idle_gaps[0] == ["bench.solve:aten::index_add_", 35e-9]
    assert [g[1] for g in s.idle_gaps] == [35e-9, 25e-9, 10e-9]
