"""Map and System checkpoints, in the reference package's layout.

Counterpart of the reference's ``utils/serialization.py``: a file written
by either package loads in the other.

- A map is one compressed npz of the 23 ``MapState`` fields, which the two
  packages share field for field, with the reference's dtypes: the
  descriptors (``kf_desc``, ``pt_desc``) as ``uint32`` (the port holds their
  ``int32`` view), the counters ``n_kf`` / ``n_pt`` as 0-d ``int32``.
- A System is one pickle of numpy arrays and plain Python values only (no
  torch object): the map's arrays, the tracking state, the trajectory as
  ``(frame_id, timestamp, reference keyframe, T_rel [7])`` tuples, the
  per-frame metrics, the quadric landmarks and the keyframe database, with
  the vocabulary embedded only when it was trained during the run (a
  pretrained one is reloaded from the receiving System's configuration).

Unpickling runs code: load only checkpoints this project wrote.
"""

from __future__ import annotations

import pickle
from types import SimpleNamespace

import numpy as np
import torch

from ..models import map_state as ms


def save_map(path: str, m: ms.MapState) -> None:
    np.savez_compressed(path, **ms.map_state_to_numpy(m))


def load_map(path: str, device="cuda") -> ms.MapState:
    """The map in ``path`` on ``device`` (the card unless the caller asks
    for the CPU)."""
    with np.load(path) as data:
        return ms.map_state_from_numpy(SimpleNamespace(**{k: data[k] for k in data.files}),
                                       device)


def _np(t):
    return t.detach().cpu().numpy()


def _trajectory_entries(traj):
    return [(int(f), float(ts), int(r), np.asarray(T, np.float32)) for f, ts, r, T in traj]


def _plain(v):
    """A metrics value as a Python number."""
    if isinstance(v, (bool, np.bool_)):
        return bool(v)
    if isinstance(v, (int, np.integer)):
        return int(v)
    return float(v)


def save_system(path: str, slam) -> None:
    """Checkpoint the whole System (map, tracking state, trajectory,
    metrics, quadric landmarks, keyframe database). Drains the pipeline
    first: the pending frame and the in-flight mapping pass."""
    from ..ops import vocab as vocab_mod

    slam._flush()
    slam._consume_map_aux(block=True)
    state = {
        "map": ms.map_state_to_numpy(slam.map),
        "state": int(slam.state),
        "frame_id": int(slam.frame_id),
        "T_cw": _np(slam.T_cw),
        "velocity": _np(slam.velocity),
        "prev_obs": _np(slam.prev_obs),
        "ref_kf": int(slam.ref_kf),
        "ref_kf_matches": int(slam.ref_kf_matches),
        "last_kf_frame": int(slam.last_kf_frame),
        "trajectory": _trajectory_entries(slam.trajectory),
        "metrics": [{k: _plain(v) for k, v in rec.items()} for rec in slam.metrics],
        "quadrics": [
            {"class_id": int(lmk.class_id), "kf_slots": [int(s) for s in lmk.kf_slots],
             "bboxes": [np.asarray(b, np.float32) for b in lmk.bboxes],
             "point_ids": sorted(int(p) for p in lmk.point_ids),
             "initialized": bool(lmk.initialized),
             "pose": None if lmk.pose is None else np.asarray(lmk.pose, np.float32),
             "scale": None if lmk.scale is None else np.asarray(lmk.scale, np.float32)}
            for lmk in (slam.quadrics.landmarks if slam.quadrics else [])
        ],
    }
    lcs = slam.loop_closer
    if lcs is not None:
        state["words"] = _np(lcs.words)
        state["loop_edges"] = [(int(i), int(j)) for i, j in lcs.loop_edges]
        state["last_loop_kf"] = int(lcs.last_loop_kf)
        if lcs.sparse:
            state["kf_wid"] = _np(lcs.kf_wid)
            state["kf_wval"] = _np(lcs.kf_wval)
        else:
            state["bow"] = _np(lcs.bow)
        # provenance, not type, decides: a pretrained .npz also loads as a
        # Vocabulary
        if isinstance(lcs.voc, vocab_mod.Vocabulary) and lcs.voc is not slam._pretrained_voc:
            v = vocab_mod.vocabulary_to_numpy(lcs.voc)
            state["vocab"] = {k: v[k] for k in ("k", "levels", "idf", "centers")}
    with open(path, "wb") as f:
        pickle.dump(state, f)


def load_system(path: str, slam) -> None:
    """Restore a checkpoint into a System built with the same configuration,
    on its device. Every host mirror and cache is reset (the pipeline, the
    mapping aux, the pending loop detection, the observation-matrix cache,
    an in-flight global BA) and the host counters are refreshed from the
    restored map."""
    from ..models import loop_closing as lc
    from ..models.quadric_mapping import landmarks_from_numpy
    from ..ops import vocab as vocab_mod

    with open(path, "rb") as f:
        state = pickle.load(f)
    dev = slam.device

    def t(a, dtype):
        return torch.as_tensor(np.array(a), device=dev).to(dtype)

    # abandon a global BA in flight: its snapshot is of another map
    if slam._gba_thread is not None:
        slam._gba_thread.join()
    with slam._gba_lock:
        slam._gba_gen += 1
        slam._gba_result = None
    slam._gba_thread = None

    slam.map = ms.map_state_from_numpy(SimpleNamespace(**state["map"]), dev)
    slam.state = int(state["state"])
    slam.frame_id = int(state["frame_id"])
    slam.T_cw = t(state["T_cw"], torch.float32)
    slam.velocity = t(state["velocity"], torch.float32)
    slam.prev_obs = t(state["prev_obs"], torch.int32)
    slam.ref_kf = int(state["ref_kf"])
    slam.ref_kf_matches = int(state["ref_kf_matches"])
    slam.last_kf_frame = int(state["last_kf_frame"])
    slam.trajectory = _trajectory_entries(state["trajectory"])
    slam.metrics = [dict(rec) for rec in state["metrics"]]
    if slam.quadrics is not None:
        slam.quadrics.landmarks = landmarks_from_numpy(
            SimpleNamespace(**q) for q in state.get("quadrics", []))
    if "words" in state:
        if "vocab" in state:
            voc = vocab_mod.vocabulary_from_numpy(state["vocab"], dev)
        elif slam._pretrained_voc is not None:
            voc = slam._pretrained_voc
        else:
            voc = None
        if voc is not None:
            lcs = lc.LoopCloser(voc, slam.cfg.map)
            lcs.grow(int(np.asarray(state["words"]).shape[0]))
            lcs.words = t(state["words"], torch.int32)
            if lcs.sparse and "kf_wid" in state:
                lcs.kf_wid = t(state["kf_wid"], torch.int32)
                lcs.kf_wval = t(state["kf_wval"], torch.float32)
            elif not lcs.sparse and "bow" in state:
                lcs.bow = t(state["bow"], torch.float32)
            lcs.loop_edges = [(int(i), int(j)) for i, j in state.get("loop_edges", [])]
            lcs.last_loop_kf = int(state.get("last_loop_kf", -999))
            slam.loop_closer = lcs
    # host mirrors and caches of the old map
    slam._pend = None
    slam._map_aux = None
    slam._pending_loop = None
    slam._obs_A = slam._obs_A_src = None
    slam._extra_obs_holders = []
    slam._map_epoch += 1
    slam._vocab_pool = []
    slam.init_feats = None
    slam.last_feats = None
    slam._red_cum = None
    slam._ref_anchor = None
    if slam.state == slam.OK:
        slam._refresh_host_counters()
    else:
        slam._n_kf_host = int(slam.map.n_kf)
        slam._kf_live = int(slam.map.kf_valid.sum())
        slam._n_pt_est = int(slam.map.n_pt)
