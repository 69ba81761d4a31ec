"""Distributed bundle adjustment over a ``torch.distributed`` process group.

Counterpart of the reference's ``parallel/dist_ba.py``. Observations
(edges) are sharded over the ranks of a group; keyframe poses, points,
intrinsics and the fixed masks stay whole on every rank. Every segment sum
inside the Schur/CG engine (``ops/ba.py``) and the cost become a local
``index_add`` followed by ``all_reduce(SUM)`` (the reference's ``psum``),
so every rank applies the same reduced-system step and the state stays
replicated with no traffic of the map itself: per LM step one [C,6,6] +
[C,6] + [P,3,3] + [P,3] reduction and the costs, plus a [P,3] and a [C,6]
reduction per CG step.

Edges are the axis to shard: their count grows with the trajectory, while
the replicated state is small (a KITTI-00-scale map, C ~ 1,400 keyframes
and P ~ 140,000 points, is ~1.7 MB of poses and points beside O ~ 5,000,000
edges).

The backend follows the tensors' device unless the caller names one: NCCL
for CUDA tensors (one card per rank), gloo for CPU tensors. gloo also takes
CUDA tensors (through the host), which lets several ranks share one card.
"""

from __future__ import annotations

import os

import torch
import torch.distributed as dist

from ..models import loop_closing as lc
from ..ops import ba

EDGE_FIELDS = ("cam_idx", "pnt_idx", "uvr", "is_stereo", "inv_sigma2", "valid")


def default_backend(device) -> str:
    """NCCL for CUDA tensors, gloo for CPU ones."""
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def make_ba_group(init_method: str | None = None, world_size: int | None = None,
                  rank: int | None = None, backend: str | None = None, device="cuda"):
    """The process group the BA reductions run over, or None where the job
    is not distributed (one process, world size 1).

    - An initialized default group is returned as it is (idempotent).
    - With ``init_method`` (``tcp://host:port``, ``file://path``) this
      process joins as ``rank`` of ``world_size``.
    - Without it, the ``torchrun`` environment (``RANK``, ``WORLD_SIZE``,
      ``MASTER_ADDR``) is used where it is set; else the result is None.

    ``backend`` defaults to :func:`default_backend` of ``device``. An NCCL
    rank takes the card ``LOCAL_RANK`` (or ``rank``) modulo the card count.
    A failed initialization raises; NCCL never gives way to gloo."""
    if dist.is_initialized():
        return dist.group.WORLD
    if init_method is None:
        if not all(k in os.environ for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR")):
            return None
        init_method = "env://"
        world_size, rank = int(os.environ["WORLD_SIZE"]), int(os.environ["RANK"])
    if world_size is None or rank is None:
        raise ValueError("make_ba_group: init_method needs world_size and rank")
    backend = backend or default_backend(device)
    if backend == "nccl" and torch.cuda.is_available():
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", rank))
                              % torch.cuda.device_count())
    dist.init_process_group(backend, init_method=init_method, world_size=world_size,
                            rank=rank)
    return dist.group.WORLD


def initialize_multihost(coordinator_address: str | None = None,
                         num_processes: int | None = None, process_id: int | None = None,
                         backend: str | None = None, device="cuda"):
    """Join (or start) a multi-process job and return its BA group.

    With every argument omitted: the ``torchrun`` environment if it is set,
    else not distributed (None), as :func:`make_ba_group`. Otherwise give
    all three: the coordinator (``host:port``, or a URL such as
    ``tcp://host:port``), the number of processes and this process's
    index, one process per card. Idempotent."""
    if coordinator_address is None and num_processes is None and process_id is None:
        return make_ba_group(backend=backend, device=device)
    if coordinator_address is None or num_processes is None or process_id is None:
        raise ValueError("initialize_multihost: give coordinator_address, num_processes "
                         "and process_id together, or none of them")
    url = coordinator_address if "://" in coordinator_address else f"tcp://{coordinator_address}"
    return make_ba_group(url, num_processes, process_id, backend, device)


def rank_and_world(group) -> tuple[int, int]:
    """(rank, world size) in ``group``; (0, 1) for None."""
    if group is None:
        return 0, 1
    return dist.get_rank(group), dist.get_world_size(group)


def shard_problem(prob: ba.BAProblem, rank: int, world: int) -> ba.BAProblem:
    """This rank's contiguous block of the edges (the reference's ``P("ba")``
    layout). The edge arrays are first padded to a multiple of ``world``:
    pads take index 0, ``uvr`` 0 and ``valid`` 0, so they add nothing.
    Poses, points, ``K``, ``bf`` and the fixed masks stay whole."""
    O = prob.cam_idx.shape[0]
    pad = (-O) % world
    n = (O + pad) // world

    def block(x):
        if pad:
            x = torch.cat([x, torch.zeros((pad,) + tuple(x.shape[1:]), dtype=x.dtype,
                                          device=x.device)])
        return x[rank * n:(rank + 1) * n]

    return prob._replace(**{f: block(getattr(prob, f)) for f in EDGE_FIELDS})


def dist_ba_solve(prob: ba.BAProblem, group, n_iters: int = 10, cg_iters: int = 40,
                  use_huber: bool = True):
    """``ops/ba.ba_solve`` on this rank's shard (from :func:`shard_problem`)
    with its sums reduced over ``group``. Every rank returns the same poses,
    points and cost: each step and its accept test come from reduced values
    only. Returns (prob, final_cost)."""
    return ba.ba_solve(prob, n_iters=n_iters, cg_iters=cg_iters, use_huber=use_huber,
                       group=group)


def dist_score_database(bow_mat, query_bow, kf_valid, group):
    """Loop-retrieval scoring with the keyframe database sharded over
    ``group``: each rank scores its contiguous block of keyframe rows (the
    rows padded to a multiple of the world size, pads invalid), then the
    blocks are gathered and the pad rows stripped. Every rank passes the
    whole database and gets every score. Returns (scores [K], common [K]),
    as ``loop_closing.score_database``."""
    if group is None:
        return lc.score_database(bow_mat, query_bow, kf_valid)
    rank, world = rank_and_world(group)
    K = bow_mat.shape[0]
    n = -(-K // world)
    lo, hi = min(rank * n, K), min((rank + 1) * n, K)
    pad = n - (hi - lo)
    rows = torch.cat([bow_mat[lo:hi], bow_mat.new_zeros((pad,) + tuple(bow_mat.shape[1:]))])
    valid = torch.cat([kf_valid[lo:hi], kf_valid.new_zeros((pad,))])
    scores, common = lc.score_database(rows, query_bow, valid)
    out = []
    for part in (scores, common):
        parts = [torch.empty_like(part) for _ in range(world)]
        dist.all_gather(parts, part, group=group)
        out.append(torch.cat(parts)[:K])
    return out[0], out[1]


def process_local_report(group) -> dict:
    """Who this process is in ``group`` and what it holds: its rank, the
    world size, the backend, the cards it sees and the cards the ranks see
    summed (ranks that share a host count its cards once each)."""
    rank, world = rank_and_world(group)
    backend = dist.get_backend(group) if group is not None else None
    local = torch.cuda.device_count()
    total = torch.tensor([local], device="cuda" if backend == "nccl" else "cpu")
    if group is not None:
        dist.all_reduce(total, group=group)
    return {"process_index": rank, "process_count": world, "backend": backend,
            "local_devices": local, "global_devices": int(total.item())}
