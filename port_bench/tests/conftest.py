"""Shared fixtures of the benchmark's own tests: each cell at a tiny size on
the CPU (its configuration with the scene and pools cut down), so that the
whole of a run, reference and check included, takes seconds."""

import copy

import pytest
import torch

from port_bench import harness

TINY = {
    "street_loop": ({"length_m": 120.0, "keyframes": 40, "points": 6000},
                    {"max_keyframes": 64, "max_points": 8192}, 300),
    "desk": ({"keyframes": 12, "points": 2000}, {"max_keyframes": 32, "max_points": 4096}, 200),
}
CELLS = ("kitti00_stereo.gba", "tum_fr1_desk_rgbd.gba")


def tiny_cell(name: str, root=None):
    cell = harness.load_cell(name) if root is None else harness.load_cell(name, root)
    cfg = copy.deepcopy(cell.cfg)
    scene, pools, n_features = TINY[cfg["scene"]["kind"]]
    cfg["scene"].update(scene)
    cfg["pools"].update(pools)
    cfg["orb"]["n_features"] = n_features
    cell.cfg = cfg
    return cell


@pytest.fixture(params=CELLS)
def cell(request):
    return tiny_cell(request.param)


@pytest.fixture
def make_tiny_cell():
    return tiny_cell


# a few intra-op threads a worker: the tests run in parallel worker processes,
# and a worker with a thread for every core each stalls the others
torch.set_num_threads(min(2, torch.get_num_threads()))
