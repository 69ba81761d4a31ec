"""Run a function in N spawned ranks of one ``torch.distributed`` group.

:func:`run_ranks` starts ``world`` processes with the ``spawn`` method (no
state is inherited: the function and its arguments are pickled, so the
function must live in an importable module), joins them into one group
through a ``file://`` rendezvous in a fresh temporary directory, runs
``fn(group, *args)`` in each with one PyTorch thread, and returns each
rank's result (which must pickle: numpy arrays and plain values) to the
caller, in rank order.

:func:`rank_jobs` is the function the distributed-BA checks spawn.
"""

from __future__ import annotations

import multiprocessing
import os
import queue
import tempfile
import time
import traceback

import numpy as np
import torch
import torch.distributed as dist

from ..ops import ba
from . import dist_ba


def _rank_main(fn, rank, world, init_method, backend, device, args, results):
    torch.set_num_threads(1)
    try:
        group = dist_ba.make_ba_group(init_method, world, rank, backend, device)
        results.put((rank, True, fn(group, *args)))
    except BaseException:
        results.put((rank, False, traceback.format_exc()))
        raise
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def run_ranks(fn, world: int, *args, backend: str | None = None, device="cuda",
              timeout: float = 900.0):
    """``[fn(group, *args) of rank r for r in range(world)]``, each rank in
    its own spawned process. ``backend`` defaults to the one ``device``
    asks for (:func:`dist_ba.default_backend`). Raises if a rank raises,
    dies or outlasts ``timeout`` seconds; every process is ended before it
    returns."""
    ctx = multiprocessing.get_context("spawn")
    results = ctx.Queue()
    backend = backend or dist_ba.default_backend(device)
    got = {}
    with tempfile.TemporaryDirectory() as tmp:
        init = "file://" + os.path.join(tmp, "rendezvous")
        procs = [ctx.Process(target=_rank_main, daemon=True,
                             args=(fn, r, world, init, backend, device, args, results))
                 for r in range(world)]
        for p in procs:
            p.start()
        try:
            deadline = time.monotonic() + timeout
            while len(got) < world:
                try:
                    rank, ok, out = results.get(timeout=1.0)
                except queue.Empty:
                    dead = [p.exitcode for p in procs if p.exitcode not in (None, 0)]
                    if dead:
                        raise RuntimeError(f"run_ranks: a rank exited with {dead[0]}")
                    if time.monotonic() > deadline:
                        raise TimeoutError(f"run_ranks: no result within {timeout} s")
                    continue
                if not ok:
                    raise RuntimeError(f"run_ranks: rank {rank} failed:\n{out}")
                got[rank] = out
        finally:
            for p in procs:
                p.join(timeout=30.0)
                if p.is_alive():
                    p.terminate()
                    p.join()
    return [got[r] for r in range(world)]


def _sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def rank_jobs(group, device, ba_jobs=(), score_jobs=()):
    """What a rank of the distributed-BA checks does. ``ba_jobs``: (problem
    as numpy arrays, ``dist_ba_solve`` keyword arguments) pairs, each
    sharded by :func:`dist_ba.shard_problem` and solved over ``group``;
    ``score_jobs``: (bow [K, V], query [V], valid [K]) numpy triples scored
    by :func:`dist_ba.dist_score_database`. Returns {"report", "ba": [(poses,
    points, cost, ms)], "score": [(scores, common)]} as numpy arrays and
    numbers; ``ms`` is the solve's wall time, the device drained."""
    rank, world = dist_ba.rank_and_world(group)
    out = {"report": dist_ba.process_local_report(group), "ba": [], "score": []}
    for prob_np, kw in ba_jobs:
        prob = dist_ba.shard_problem(ba.ba_problem_from_numpy(prob_np, device), rank, world)
        _sync(device)
        if group is not None:
            dist.barrier(group=group)
        t0 = time.perf_counter()
        res, cost = dist_ba.dist_ba_solve(prob, group, **kw)
        _sync(device)
        ms = 1e3 * (time.perf_counter() - t0)
        out["ba"].append((res.poses.cpu().numpy(), res.points.cpu().numpy(),
                          float(cost), ms))
    for bow, q, valid in score_jobs:
        s, c = dist_ba.dist_score_database(
            *(torch.as_tensor(np.asarray(a), device=device) for a in (bow, q, valid)), group)
        out["score"].append((s.cpu().numpy(), c.cpu().numpy()))
    return out
