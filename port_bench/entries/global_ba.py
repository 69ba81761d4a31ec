"""The global BA entry: what the window drives, and its reference.

The window drives the port's ``models.local_mapping.run_global_ba`` on a
``MapState`` laid out from the inputs, exactly as ``System`` calls it after
a loop closure (the camera, ``bf``, the level table and ``n_iters`` from
the mix). Every call starts from the same map, so every solve does the
same work. The inputs are a whole map made from the seed (``maps.py``,
the scene the configuration names). A solve's answer is the map's keyframe
poses and point positions and the final cost; the reference
(``reference.global_ba``) works out the same from the inputs alone, and
``compare.py`` holds the one against the other.
"""

from __future__ import annotations

import torch

from .. import checks, compare, maps
from .. import reference as plain

# the reference's precisions: (dtype, matrix products' operands rounded to TF32)
PRECISIONS = {"float64": (torch.float64, False), "float32": (torch.float32, False),
              "tf32": (torch.float32, True)}


def inputs(cfg: dict, mix: dict, seed: int, device) -> dict:
    return maps.build(cfg, seed, device)


def counts(inp: dict) -> dict:
    return maps.live_counts(inp)


def prepare(inp: dict, cfg: dict, mix: dict, device):
    """A zero-argument callable: one solve, returning (its answer, its final
    cost)."""
    from orbslam2_with_quadrics_tpu_torch.models import local_mapping as lm
    from orbslam2_with_quadrics_tpu_torch.models import map_state as ms

    pools, orb = cfg["pools"], cfg["orb"]
    mcfg = ms.MapConfig(max_keyframes=int(pools["max_keyframes"]),
                        max_points=int(pools["max_points"]),
                        n_features=int(orb["n_features"]), n_levels=int(orb["n_levels"]),
                        scale_factor=float(orb["scale_factor"]), device=str(torch.device(device)))
    fields = ("kf_pose", "kf_valid", "kf_uv", "kf_ur", "kf_level", "kf_kp_valid",
              "kf_obs_point", "pt_pos", "pt_valid")
    m = ms.empty_map(mcfg)._replace(**{f: inp[f].clone() for f in fields})
    Kc, bf, tab = inp["K"].clone(), float(inp["bf"]), inp["inv_sigma2"].clone()
    n_iters = int(mix["n_iters"])

    def solve():
        out, cost = lm.run_global_ba(m, Kc, bf, tab, n_iters=n_iters)
        return {"kf_pose": out.kf_pose, "pt_pos": out.pt_pos, "cost": cost}, cost

    return solve


def reference(inp: dict, cfg: dict, mix: dict, precision: str = "float64") -> dict:
    dtype, tf32 = PRECISIONS[precision]
    return plain.global_ba(inp, cfg["orb"], int(mix["robust_iters"]), int(mix["n_iters"]),
                               int(mix["cg_iters"]), dtype=dtype, tf32=tf32)


def judge(answer: dict, records: list, ref: dict, inp: dict, limits: dict):
    """(the numbers of ``compare.py``, the solves whose final cost is off
    by more than its limit): ``answer`` is the window's last solve's,
    ``records`` every solve's final cost."""
    nums, gaps = compare.numbers(answer, ref, inp, records)
    return nums, sum(not checks.within(g, float(limits["cost_gap"])) for g in gaps)


def steps_per_call(mix: dict) -> int:
    """The LM steps of one solve."""
    return int(mix["robust_iters"]) + int(mix["n_iters"])
