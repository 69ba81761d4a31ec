"""System facade: ``System.track_monocular``, ``track_rgbd``, ``track_stereo``.

Counterpart of the reference's ``models/system.py``: monocular two-view
initialization (``_mono_init``) or depth initialization (``_depth_init``),
then the per-frame fused step (``_frame_step``) behind a depth-1 pipeline
(``_track_fast``: frame i's stats are read while frame i+1 runs on the
device) and keyframe-rate mapping (``_insert_and_map``). A device-to-host
copy into pinned memory plus a CUDA event replaces JAX's
``copy_to_host_async`` / ``is_ready``. ``ORB_SYNC_TRACK=1`` forces the
synchronous twin (``_track`` / ``_insert_keyframe``) in the OK state too:
the two paths must agree, and a regression is bisected by diffing them. A
pool that fills is compacted or doubled (``_ensure_capacity``).

Every keyframe is indexed in the place-recognition database
(``loop_closing.LoopCloser``, on the shipped vocabulary or one trained from
the sequence's first keyframes). A lost frame relocalizes against it
(``_relocalize``: BoW candidates, mutual matching, EPnP RANSAC, guided
re-tracking), and with ``enable_loop_closing`` each keyframe is checked for
a loop one keyframe later (``_run_loop_closing``); a closure is followed by
a global BA, inline or (``async_gba``) on a thread with its own CUDA stream.

With ``enable_quadrics`` each keyframe's object detections (the
``detections`` argument of ``track_*``) are associated with dual-quadric
landmarks, which are SVD-initialized and refined by a joint
camera-point-quadric BA (``quadric_mapping.QuadricManager``).
"""

from __future__ import annotations

import dataclasses
import glob
import os
import sys
import threading
import time
from typing import Optional

import numpy as np
import torch

from ..ops import camera, init2view, lie, matching, orb, pnp
from ..ops import vocab as vocab_mod
from ..utils import metrics, trajectory
from . import frontend as fe
from . import local_mapping as lm
from . import loop_closing as lc
from . import map_state as ms
from . import tracking as tr
from .quadric_mapping import QuadricManager


@dataclasses.dataclass
class SystemConfig:
    frontend: fe.FrontendConfig
    map: ms.MapConfig
    sensor: str = "mono"            # mono | stereo | rgbd
    min_frames_between_kf: int = 0
    max_frames_between_kf: int = 30
    kf_idle_frames: int = 3         # mapping occupancy floor after a KF
    kf_ref_ratio: float = 0.9       # thRefRatio (mono)
    kf_stereo_ref_ratio: float = 0.75  # thRefRatio (stereo / RGB-D)
    kf_close_tracked_th: int = 100  # bNeedToInsertClose: insert when fewer
    kf_close_untracked_th: int = 70 # close points are tracked and more are
                                    # untracked than these (the constants
                                    # assume ~2000-feature frames)
    kf_redundancy_th: float = 0.9   # skip c1b insertion when this share of
                                    # tracked points is already covered >= 3x
    kf_strong_inl: int = 100        # ... and only while tracking is strong
    min_inliers_track: int = 30
    min_inliers_kf: int = 15
    local_ba_window: int = 16
    depth_factor: float = 1.0       # RGB-D depth map scaling
    enable_loop_closing: bool = False
    vocab_k: int = 10               # lazily trained vocabulary branching
    vocab_levels: int = 4           # 10^4 words
    vocab_train_kfs: int = 4        # train once this many KFs accumulated
    vocab_path: Optional[str] = "auto"  # pretrained vocabulary: .txt = DBoW2
                                    # text format, else this package's .npz;
                                    # 'auto' = the shipped assets/vocab_*.npz,
                                    # falling back to lazy per-sequence
                                    # training when no asset exists; None =
                                    # always lazy
    enable_quadrics: bool = False
    quadric_min_points: int = 15    # landmark validity gate (member points)
    async_gba: bool = False         # run the post-loop global BA in a
                                    # background thread, with spanning-tree
                                    # propagation to keyframes / points
                                    # created meanwhile; False = inline
    n_local_kf: int = 64            # local-map window
    n_local_pt: int = 4096          # local point budget for tracking


def _default_vocab_asset() -> Optional[str]:
    """The shipped pretrained vocabulary: the largest assets/vocab_*.npz of
    this package; None when it ships without one (lazy training)."""
    adir = os.path.join(os.path.dirname(os.path.dirname(__file__)), "assets")
    cands = sorted(glob.glob(os.path.join(adir, "vocab_*.npz")), key=os.path.getsize)
    return cands[-1] if cands else None


_HostCopy = ms.HostCopy


class System:
    """SLAM facade (System::TrackMonocular / TrackStereo / TrackRGBD)."""

    NOT_INITIALIZED = 0
    OK = 1
    LOST = 2

    def __init__(self, cfg: SystemConfig):
        if cfg.sensor not in ("mono", "stereo", "rgbd"):
            raise ValueError(f"sensor={cfg.sensor!r}: expected mono, stereo or rgbd")
        # metric sensors need bf = fx * baseline: the close-point gates are
        # depth < depth_th * bf / fx, so bf = 0 would create no depth point
        if cfg.sensor in ("stereo", "rgbd") and not cfg.frontend.bf > 0:
            raise ValueError(
                f"sensor={cfg.sensor!r} requires frontend.bf > 0 (fx * baseline); "
                f"got bf={cfg.frontend.bf}")
        self.cfg = cfg
        self.device = torch.device(cfg.map.device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                f"System: MapConfig.device is {cfg.map.device!r} (the default) but no "
                "CUDA card is available; pass MapConfig(device='cpu') to run on the CPU")
        fcfg = cfg.frontend
        self._K = fe.intrinsics(fcfg, str(self.device))[0]
        self._sf, _, self._inv_sigma2 = orb.scale_factors(
            fcfg.n_levels, fcfg.scale_factor, self.device)
        # before initialization the reference extracts 2x the features
        self._init_fe_cfg = dataclasses.replace(fcfg, n_features=2 * fcfg.n_features)
        # two-view RANSAC samples, seeded as the reference's PRNGKey(0)
        self._generator = torch.Generator(device=self.device).manual_seed(0)
        # ORB_SYNC_TRACK=1 forces the synchronous _track path in the OK
        # state too: the fast / sync bisect switch
        self._force_sync = os.environ.get("ORB_SYNC_TRACK", "") == "1"
        self.only_tracking = False   # localization-only mode
        self.frame_id = 0
        self.trajectory = []  # (frame_id, timestamp, ref kf slot, T_rel np [7])
        self.metrics = []
        self.n_kfs_created = 0
        self.n_kfs_culled = 0
        # capacity events
        self.n_point_compactions = 0
        self.n_point_growths = 0
        self.n_kf_compactions = 0
        self.n_kf_growths = 0
        self._extra_obs_holders = []  # frames whose obs need point-id remaps
        self._reset_gen = 0
        # place recognition: a pretrained vocabulary gives a database from
        # the first keyframe on; without one it is trained from the
        # sequence's first keyframes (_maybe_train_vocab)
        self.loop_closer = None
        self.n_loops_closed = 0
        self.n_reloc_corrections = 0  # relocalizations treated as loop closures
        self._pretrained_voc = None
        vocab_path = _default_vocab_asset() if cfg.vocab_path == "auto" else cfg.vocab_path
        if vocab_path:
            load = vocab_mod.load_dbow2_text if vocab_path.endswith(".txt") else vocab_mod.load
            self._pretrained_voc = load(vocab_path, device=self.device)
        # async global BA: the thread optimizes a snapshot while tracking
        # keeps replacing self.map (no function of this package writes a
        # map tensor in place); the merge is pure array surgery
        self._gba_thread = None
        self._gba_result = None
        self._gba_gen = 0
        self.n_gba_applied = 0
        # guards the (gen check -> result store) pair in the worker and the
        # (gen bump -> result clear) pair on the main thread
        self._gba_lock = threading.Lock()
        # bumped by point-pool compaction (point ids are remapped): a
        # snapshot from an older epoch can still apply its keyframe poses
        # but not its point ids
        self._map_epoch = 0
        # big-change counter for map_changed()
        self._big_change_idx = 0
        self._last_big_change_idx = 0
        # quadric object landmarks; detections of the frame being tracked
        self.quadrics = (QuadricManager(self._K, min_points=cfg.quadric_min_points)
                         if cfg.enable_quadrics else None)
        self._pending_detections = None
        self.reset()

    # ------------------------------------------------------------------
    # public per-frame entries
    # ------------------------------------------------------------------

    def _upload(self, img):
        """An image (numpy array or tensor) on the system's device; pinned
        and non-blocking, so the upload does not wait for queued work."""
        img = torch.as_tensor(img)
        if self.device.type == "cuda" and not img.is_cuda:
            return img.pin_memory().to(self.device, non_blocking=True)
        return img.to(self.device)

    def _fast(self) -> bool:
        return self.state == self.OK and not self._force_sync

    def track_monocular(self, img, timestamp=0.0, detections=None):
        """Track one grayscale frame (numpy array or tensor, any integer or
        float dtype). ``detections``: optional [D,6] (x, y, w, h, prob,
        class) object boxes for the quadric landmarks (kept if the frame
        becomes a keyframe). Returns the frame's T_cw [7]."""
        assert self.cfg.sensor == "mono", "called track_monocular but sensor is not mono"
        self._pending_detections = detections
        img = self._upload(img)
        if self._fast():
            return self._track_fast(img, None, timestamp)
        fcfg = (self._init_fe_cfg if self.state == self.NOT_INITIALIZED
                else self.cfg.frontend)
        return self._track(fe.extract_mono(fcfg, img), timestamp)

    def track_rgbd(self, img, depth, timestamp=0.0, detections=None):
        """Track one grayscale frame with its registered depth map (any
        dtype; multiplied by ``depth_factor``). Returns T_cw [7]."""
        assert self.cfg.sensor == "rgbd", "called track_rgbd but sensor is not rgbd"
        self._pending_detections = detections
        img, depth = self._upload(img), self._upload(depth)
        if self._fast():
            return self._track_fast(img, depth, timestamp)
        feats = fe.extract_rgbd(self.cfg.frontend, img,
                                depth.to(torch.float32) * self.cfg.depth_factor)
        return self._track(feats, timestamp)

    def track_stereo(self, img_l, img_r, timestamp=0.0, detections=None):
        """Track one rectified stereo pair. Returns the left camera's T_cw [7]."""
        assert self.cfg.sensor == "stereo", "called track_stereo but sensor is not stereo"
        self._pending_detections = detections
        img_l, img_r = self._upload(img_l), self._upload(img_r)
        if self._fast():
            return self._track_fast(img_l, img_r, timestamp)
        return self._track(fe.extract_stereo(self.cfg.frontend, img_l, img_r), timestamp)

    # ------------------------------------------------------------------
    # mode switches / status getters
    # ------------------------------------------------------------------

    def activate_localization_mode(self):
        """Stop map building, camera tracking only: keyframe insertion and
        all local-mapping work are skipped while set."""
        self.only_tracking = True

    def deactivate_localization_mode(self):
        self.only_tracking = False

    def map_changed(self):
        """True if a big map change (loop closure, global BA, reset)
        happened since the last call."""
        changed = self._big_change_idx != self._last_big_change_idx
        self._last_big_change_idx = self._big_change_idx
        return changed

    def warmup(self, verbose: bool = False) -> float:
        """Run once, on dummy inputs against the current pool shapes, every
        stage the steady state can dispatch, and discard the results: on
        the card this pays the first-use costs before the first frame (the
        kernels' ``nvcc`` builds, the first forward-mode call, the first
        cuSOLVER and cuBLAS calls), as the original system loads its
        vocabulary before tracking starts. The System is left as it was
        found: nothing here writes an attribute, a database row, a cache or
        a random generator of it. Returns the seconds it took."""
        cfg, fcfg, m = self.cfg, self.cfg.frontend, self.map
        K, N = m.kf_obs_point.shape
        dev = self.device
        dims = dict(n_levels=fcfg.n_levels, scale=fcfg.scale_factor, height=fcfg.height,
                    width=fcfg.width)
        g = torch.Generator(device=dev).manual_seed(0)  # never self._generator
        t0 = time.perf_counter()

        def log(name):
            if verbose:
                print(f"[warmup] {name} ({time.perf_counter() - t0:.1f} s)", file=sys.stderr,
                      flush=True)

        if dev.type == "cuda":
            from ..ops import cuda_kernels

            cuda_kernels.build_all()
            log("kernel build")
        # the pipelined frame: a pinned upload, the step, a pinned read-back
        zimg = self._upload(np.zeros((fcfg.height, fcfg.width), np.uint8))
        zaux = zimg.to(torch.float32) if cfg.sensor == "rgbd" else zimg
        out = _frame_step(
            m, ms.observation_matrix(m), zimg, zaux, self.T_cw, self.velocity, self.prev_obs,
            0, m.kf_pose[0], ms.obs_level_cum(m, fcfg.n_levels), fcfg, cfg.sensor,
            cfg.min_inliers_track, *self._local_window(), cfg.depth_factor)
        feats = out[0]
        _HostCopy(out[6]).numpy()
        log("frame_step")
        if cfg.sensor == "mono":
            fe.extract_mono(self._init_fe_cfg, zimg)  # initialization extracts 2x
        _insert_and_map(m, feats, self.T_cw, 0, 0,
                        torch.full((N,), -1, dtype=torch.int32, device=dev),
                        torch.zeros((K,), dtype=torch.bool, device=dev), self._inv_sigma2,
                        fcfg, cfg.sensor, cfg.local_ba_window)
        log("insert_and_map")
        bf = float(fcfg.bf)
        for n_iters in ((10, 20) if cfg.sensor == "mono" else (10,)):
            lm.run_global_ba(m, self._K, bf, self._inv_sigma2, n_iters=n_iters)
        log("global_ba")
        lcs = self.loop_closer
        if lcs is not None:
            # the database update and detection of keyframe 0, into copies
            word, _ = vocab_mod.transform_any(lcs.voc, m.kf_desc[0], m.kf_kp_valid[0])
            if lcs.sparse:
                wid, wval = vocab_mod.sparse_bow(word, lcs.voc.idf)
                kf_wid, kf_wval, words = lc._db_update_sparse(
                    lcs.kf_wid, lcs.kf_wval, lcs.words, wid, wval, word, 0)
                lc._detect_prep_sparse(m, kf_wid, kf_wval, words, lcs.voc.idf, 0)
            else:
                bv = vocab_mod.bow_vector(word, lcs.voc.n_words, lcs.voc.idf)
                bow, words = lc._db_update_dense(lcs.bow, lcs.words, bv, word, 0)
                lc._detect_prep_dense(m, bow, words, lcs.voc.idf, 0, lcs.voc.n_words)
            log("detect_prep")
            _, S_corr, loop_ids = lc._sim3_geometry(
                m, words, 0, 1, self._K, fix_scale=cfg.sensor != "mono", generator=g, **dims)
            log("sim3_geometry")
            from ..ops import pose_graph

            no_kf = torch.zeros((K,), dtype=torch.bool, device=dev)
            for E in (64, 128, 256):
                ei = torch.zeros((E,), dtype=torch.int64, device=dev)
                S_old, S_init, meas = lc._graph_arrays(
                    m, 0, 1, S_corr, no_kf, ei, ei, torch.zeros((E,), dtype=torch.bool,
                                                                device=dev))
                pose_graph.optimize_pose_graph(S_init, ei, ei, meas,
                                               torch.zeros((E,), device=dev),
                                               torch.zeros((K,), device=dev))
            lc._apply_graph(m, S_old, S_init)
            lc.gather_loop_points(m, 0)
            lc.fuse_loop_points(m, 0, loop_ids, self._K, **dims)
            log("graph+fuse")
            # relocalization
            vocab_mod.transform_any(lcs.voc, feats.desc, feats.valid)
            matching.mutual_match(feats.desc, feats.valid, m.kf_desc[0], m.kf_kp_valid[0],
                                  th=matching.TH_LOW, ratio=0.75)
            lvl = torch.clamp(feats.level.to(torch.int64), 0, self._inv_sigma2.shape[0] - 1)
            pnp.ransac_pnp(m.pt_pos[:N], feats.uv_und,
                           torch.zeros((N,), dtype=torch.bool, device=dev), self._K,
                           self._inv_sigma2[lvl], generator=g)
            log("reloc")
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        log("done")
        return time.perf_counter() - t0

    def shutdown(self):
        """Flush all in-flight work: the pending pipelined frame, the
        in-flight mapping pass, the global-BA thread and the device's queue.
        Call before reading trajectories."""
        self._flush()
        self._consume_map_aux(block=True)
        self._apply_gba_if_ready(wait=True)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def get_tracking_state(self):
        """NOT_INITIALIZED / OK / LOST."""
        return self.state

    def get_tracked_map_points(self):
        """(ids, positions [n,3]) of the map points the most recent frame
        observes, as numpy arrays."""
        obs = self.prev_obs.cpu().numpy()
        ids = obs[obs >= 0]
        return ids, self.map.pt_pos.cpu().numpy()[ids]

    def get_tracked_keypoints_un(self):
        """Undistorted keypoints [n,2] of the most recent frame (numpy)."""
        if self.last_feats is None:
            return np.zeros((0, 2), np.float32)
        valid = self.last_feats.valid.cpu().numpy()
        return self.last_feats.uv_und.cpu().numpy()[valid]

    # ------------------------------------------------------------------

    def reset(self):
        """Full reset of the map and tracking state (Tracking::Reset)."""
        cfg = self.cfg
        self.map = ms.empty_map(cfg.map)
        self.state = self.NOT_INITIALIZED
        self.velocity = lie.se3_identity(device=self.device)
        self.T_cw = lie.se3_identity(device=self.device)
        self.prev_obs = torch.full((cfg.map.n_features,), -1, dtype=torch.int32,
                                   device=self.device)
        self.init_feats = None
        self.init_frame_id = -1
        self.last_feats = None
        self.ref_kf = 0
        self.ref_kf_matches = 0
        self.last_kf_frame = -999
        self._obs_A = None
        self._obs_A_src = None
        self._red_cum = None       # [P, L] per-point obs-level histogram
        # depth-1 pipeline state
        self._pend = None          # previous frame awaiting processing
        self._map_aux = None       # in-flight mapping aux (None = idle)
        self._n_kf_host = 0        # host mirror of map.n_kf
        self._kf_live = 0
        self._n_pt_est = 0         # point-pool high-water estimate
        self._n_ref_vals = {2: 1, 3: 1}
        self._ref_anchor = None    # ref KF pose as the track chain saw it
        self._reset_gen += 1
        self.loop_closer = None
        if self._pretrained_voc is not None:
            self.loop_closer = lc.LoopCloser(self._pretrained_voc, cfg.map)
        self._vocab_pool = []
        self._pending_loop = None  # (slot, prefetched detect arrays)
        if self.quadrics is not None:
            self.quadrics.landmarks = []
        # abandon any in-flight global BA (its snapshot is now meaningless)
        with self._gba_lock:
            self._gba_gen += 1
            self._gba_result = None
        self._gba_thread = None
        self._big_change_idx += 1

    def _get_obs_A(self):
        """[K,P] observation matrix, rebuilt only when the observation
        table changes (keyed on tensor identity)."""
        src = (self.map.kf_obs_point, self.map.kf_kp_valid, self.map.kf_valid)
        if self._obs_A is None or any(a is not b for a, b in zip(src, self._obs_A_src)):
            self._obs_A = ms.observation_matrix(self.map)
            self._obs_A_src = src
        return self._obs_A

    def _local_window(self):
        """(n_local_kf, n_local_pt): the local-map budgets. Bounded by the
        configured pool sizes, as in the reference, also after a pool has
        grown (``select_local_points`` bounds them by the map's own shapes)."""
        cfg = self.cfg
        return (min(cfg.n_local_kf, cfg.map.max_keyframes),
                min(cfg.n_local_pt, cfg.map.max_points))

    def _relocalize(self, feats) -> bool:
        """Relocalization: covisibility-group-scored BoW candidates ->
        mutual descriptor matching (>= 15) -> PnP RANSAC (>= 10 to
        continue) -> guided projection rescue against the map -> accept at
        >= 50 final inliers."""
        lcs = self.loop_closer
        if lcs is None:
            return False
        cfg = self.cfg
        fcfg = cfg.frontend
        word, _ = vocab_mod.transform_any(lcs.voc, feats.desc, feats.valid)
        P = self.map.pt_pos.shape[0]
        for cand in lcs.detect_reloc_candidates(self.map, word):
            # dense mutual-best pairing, not exact leaf-word bucketing (see
            # loop_closing._sim3_geometry)
            mi, _ = matching.mutual_match(
                feats.desc, feats.valid,
                self.map.kf_desc[cand], self.map.kf_kp_valid[cand],
                th=matching.TH_LOW, ratio=0.75,
            )
            pt = self.map.kf_obs_point[cand][torch.clamp(mi, 0, mi.shape[0] - 1)]
            ok = (mi >= 0) & (pt >= 0)
            if int(torch.sum(ok)) < 15:
                continue
            pw = self.map.pt_pos[torch.clamp(pt.to(torch.int64), 0, P - 1)]
            lvl = torch.clamp(feats.level.to(torch.int64), 0, self._inv_sigma2.shape[0] - 1)
            T, inl, n_inl = pnp.ransac_pnp(
                pw, feats.uv_und, ok, self._K, self._inv_sigma2[lvl],
                generator=self._generator,
            )
            if int(n_inl) < 10:
                continue
            # guided rescue: seed from the PnP inliers, re-match by
            # projection (motion window then the tight local window) and
            # re-optimize
            obs = torch.where(inl & ok, pt, -1)
            res = tr.track_frame(
                self.map, feats, T, obs, self._K, fcfg.bf,
                height=fcfg.height, width=fcfg.width, n_levels=fcfg.n_levels,
                scale=fcfg.scale_factor, obs_A=self._get_obs_A(),
            )
            if int(res.n_inliers) >= 50:
                T_drift = self.T_cw  # stale prediction in the DRIFTED frame
                self.T_cw = res.T_cw
                self.prev_obs = res.obs_point
                self.velocity = lie.se3_identity(device=self.device)
                self._reloc_loop_correction(cand, T_drift, res.T_cw)
                return True
        return False

    def _reloc_loop_correction(self, cand: int, T_drift, T_new):
        """Treat a relocalization after tracking loss as the loop-closure
        event it topologically is: the jump between the drifted prediction
        ``T_drift`` and the relocalized pose ``T_new`` IS the Sim3
        correction a loop closure would have applied had detection fired
        before tracking broke down. Bends the drifted keyframe chain
        (anchored at the pre-loss reference keyframe) onto the revisited
        map with the essential-graph machinery, the reloc pair as the loop
        pair."""
        lcs = self.loop_closer
        if lcs is None:
            return
        slot = self.ref_kf  # drifted frontier keyframe
        if slot == cand:
            return
        # significance gate: centers differ by > 2 cm or rotation > 1 deg
        Td, Tn = T_drift.cpu(), T_new.cpu()
        jump = float(torch.linalg.norm(lie.camera_center(Td) - lie.camera_center(Tn)))
        dq = float(torch.abs(torch.sum(Td[:4] * Tn[:4])))
        if jump < 0.02 and dq > np.cos(np.deg2rad(1.0) / 2):
            return
        cfg = self.cfg
        fcfg = cfg.frontend
        T_slot = self.map.kf_pose[slot]
        # corrected pose of the drifted frontier:
        # T_slot_corr = (T_slot o T_drift^-1) o T_new
        S_corr = lie.sim3_from_se3(
            lie.se3_compose(lie.se3_compose(T_slot, lie.se3_inverse(T_drift)), T_new))
        if os.environ.get("ORB_DEBUG_LOOPS"):
            print(f"[reloc-loop] slot={slot} cand={cand} jump={jump:.3f}",
                  file=sys.stderr, flush=True)
        self.map = lcs._correct_graph(self.map, slot, cand, S_corr)
        loop_ids = lc.gather_loop_points(self.map, cand)
        self.map, _ = lc.fuse_loop_points(
            self.map, slot, loop_ids, self._K, n_levels=fcfg.n_levels,
            scale=fcfg.scale_factor, height=fcfg.height, width=fcfg.width,
        )
        lcs.loop_edges.append((int(slot), int(cand)))
        lcs.last_loop_kf = max(int(slot), int(cand))
        self.n_loops_closed += 1
        self.n_reloc_corrections += 1
        self._big_change_idx += 1
        # a keyframe insertion pending across this surgery would land a
        # drifted-frame pose in the corrected map: abort it (the generation
        # guard that protects against reset)
        self._reset_gen += 1
        self._ref_anchor = None
        self._red_cum = None  # fuse merged duplicates: histogram stale
        # the relocalized pose itself is already in the (fixed) old-map
        # frame: cand is the essential graph's gauge, so T_new stays valid
        self._global_ba_after_closure(slot)

    def _global_ba_after_closure(self, slot: int):
        """Global refinement after an essential-graph correction: on a
        thread (``async_gba``) or inline."""
        if self.cfg.async_gba:
            self._launch_global_ba(slot)
        else:
            self.map, _ = lm.run_global_ba(
                self.map, self._K, float(self.cfg.frontend.bf), self._inv_sigma2,
                n_iters=10)

    def _close_loops(self, slot: int, cands):
        """Try the detected candidates of keyframe ``slot`` in order; the
        first that passes the Sim3 gates closes the loop."""
        cfg = self.cfg
        fcfg = cfg.frontend
        for cand in cands:
            self.map, ok = self.loop_closer.attempt_close(
                self.map, slot, cand, self._K, n_levels=fcfg.n_levels,
                scale=fcfg.scale_factor, height=fcfg.height, width=fcfg.width,
                # metric sensors fix the Sim3 scale
                fix_scale=cfg.sensor != "mono", generator=self._generator,
            )
            if ok:
                self.n_loops_closed += 1
                self._big_change_idx += 1
                # SearchAndFuse merged duplicate points: the redundancy
                # histogram must see the fused table
                self._red_cum = None
                self._global_ba_after_closure(slot)
                return True
        return False

    def _run_loop_closing(self, slot: int):
        """Loop detection with one-keyframe latency: the database scores +
        covisibility DetectLoop needs are queued and prefetched at
        insertion, consumed at the next keyframe."""
        pend = self._pending_loop
        self._pending_loop = None
        if pend is not None:
            pslot, prep = pend
            self._close_loops(pslot, self.loop_closer.finish_detect(prep))
        prep = self.loop_closer.prepare_detect(self.map, slot, self._kf_live)
        if prep is not None:
            self._pending_loop = (slot, prep)

    def _maybe_train_vocab(self, feats):
        """Without a pretrained vocabulary, train a small one from the
        early keyframes' descriptors and index the keyframes so far."""
        if self.loop_closer is not None:
            return
        cfg = self.cfg
        self._vocab_pool.append(feats.desc[feats.valid])
        if len(self._vocab_pool) < cfg.vocab_train_kfs:
            return
        desc = torch.cat(self._vocab_pool)
        if desc.shape[0] < 256:
            return
        voc = vocab_mod.train(desc, k=cfg.vocab_k, levels=cfg.vocab_levels)
        self.loop_closer = lc.LoopCloser(voc, cfg.map)
        # the keyframe pool may have grown past cfg.map.max_keyframes
        # before training finished: size the database rows from the LIVE pool
        self.loop_closer.grow(self.map.kf_valid.shape[0])
        kf_valid = self.map.kf_valid.cpu().numpy()
        for s_ in range(int(self.map.n_kf)):
            if kf_valid[s_]:
                self.loop_closer.add_keyframe_from_map(self.map, s_)
        self._vocab_pool = []

    def _index_keyframe(self, feats, slot: int):
        """The place-recognition database is always maintained:
        relocalization needs it even with loop closing disabled."""
        self._maybe_train_vocab(feats)
        if self.loop_closer is not None:
            self.loop_closer.add_keyframe_from_map(self.map, slot)

    # ------------------------------------------------------------------
    # async global BA: the thread optimizes a snapshot on its own CUDA
    # stream while tracking keeps replacing self.map; the result is merged
    # at the top of a later frame, with spanning-tree propagation to the
    # keyframes and points created while it ran
    # ------------------------------------------------------------------

    def _launch_global_ba(self, slot: int):
        cfg = self.cfg
        snap = self.map
        with self._gba_lock:
            self._gba_gen += 1
            gen = self._gba_gen
            self._gba_result = None
        epoch = self._map_epoch
        on_card = self.device.type == "cuda"
        if on_card:
            # everything queued so far (the closure's correction) must
            # finish before the thread's stream reads the snapshot
            launched = torch.cuda.Event()
            launched.record(torch.cuda.current_stream(self.device))
            stream = torch.cuda.Stream(self.device)

        def solve():
            return lm.run_global_ba(snap, self._K, float(cfg.frontend.bf),
                                    self._inv_sigma2, n_iters=10)[0]

        def run():
            if on_card:
                with torch.cuda.device(self.device), torch.cuda.stream(stream):
                    stream.wait_event(launched)
                    m2 = solve()
                stream.synchronize()
            else:
                m2 = solve()
            with self._gba_lock:
                if gen == self._gba_gen:  # superseded by a newer loop? drop
                    self._gba_result = (snap, m2, epoch)

        self._gba_thread = threading.Thread(target=run, daemon=True)
        self._gba_thread.start()

    def _apply_gba_if_ready(self, wait: bool = False):
        if self._gba_thread is not None and wait:
            self._gba_thread.join()
        with self._gba_lock:
            if self._gba_result is None:
                return
            snap, gba, epoch = self._gba_result
            self._gba_result = None
        self._gba_thread = None
        m = self.map
        K = m.kf_valid.shape[0]

        # the map may have GROWN since the snapshot (grow_map preserves
        # keyframe / point ids, so pad the snapshot masks with False)
        Ks = snap.kf_valid.shape[0]
        kf_valid = m.kf_valid.cpu().numpy()
        snap_kf_valid = np.zeros((K,), bool)
        snap_kf_valid[:Ks] = snap.kf_valid.cpu().numpy()
        in_gba_kf = snap_kf_valid & kf_valid
        old_pose = m.kf_pose.cpu().numpy()
        new_pose = old_pose.copy()
        new_pose[in_gba_kf] = gba.kf_pose.cpu().numpy()[in_gba_kf[:Ks]]
        # spanning-tree propagation to keyframes created during the BA:
        # Tcw_new = Tcw_old Twc_parent_old Tcw_parent_new, walking until
        # every new keyframe has a corrected parent
        parents = m.kf_parent.cpu().numpy()
        done = in_gba_kf.copy()
        pending = [k for k in range(K) if kf_valid[k] and not done[k]]
        for _ in range(K):
            if not pending:
                break
            rest = []
            for k in pending:
                p = parents[k]
                if p >= 0 and done[p]:
                    T_rel = _np_se3_compose(old_pose[k], _np_se3_inverse(old_pose[p]))
                    new_pose[k] = _np_se3_compose(T_rel, new_pose[p])
                    done[k] = True
                else:
                    rest.append(k)
            if len(rest) == len(pending):
                break  # orphans (no corrected ancestor): keep the old pose
            pending = rest

        # points: the BA result for snapshot points, the reference
        # keyframe's correction for points created meanwhile. If a
        # point-pool compaction remapped ids since the snapshot (epoch
        # bump), snapshot point ids are stale: every point takes the
        # reference-keyframe correction (keyframe ids stay valid).
        P = m.pt_pos.shape[0]
        Ps = snap.pt_valid.shape[0]
        pt_valid = m.pt_valid.cpu().numpy()
        snap_pt_valid = np.zeros((P,), bool)
        if epoch == self._map_epoch:
            snap_pt_valid[:Ps] = snap.pt_valid.cpu().numpy()
        in_gba_pt = snap_pt_valid & pt_valid
        pos = m.pt_pos.cpu().numpy().copy()
        if in_gba_pt.any():
            pos[in_gba_pt] = gba.pt_pos.cpu().numpy()[in_gba_pt[:Ps]]
        new_pt = pt_valid & ~in_gba_pt
        if new_pt.any():
            ref = np.clip(m.pt_first_kf.cpu().numpy(), 0, K - 1)
            idx = np.where(new_pt)[0]
            r = ref[idx]
            corr = lie.se3_apply(
                lie.se3_inverse(torch.as_tensor(new_pose[r])),
                lie.se3_apply(torch.as_tensor(old_pose[r]), torch.as_tensor(pos[idx])))
            pos[idx] = corr.numpy()

        self.map = m._replace(kf_pose=torch.as_tensor(new_pose, device=self.device),
                              pt_pos=torch.as_tensor(pos, device=self.device))
        # re-anchor the live camera on its (possibly corrected) reference KF
        old_ref = torch.as_tensor(old_pose[self.ref_kf], device=self.device)
        new_ref = torch.as_tensor(new_pose[self.ref_kf], device=self.device)
        self.T_cw = lie.se3_compose(
            lie.se3_compose(self.T_cw, lie.se3_inverse(old_ref)), new_ref)
        self._ref_anchor = new_ref
        self._big_change_idx += 1
        self.n_gba_applied += 1

    def _track(self, feats, timestamp):
        """Synchronous path: initialization, and with ``_force_sync`` the
        steady state too (one blocking read of the inlier count per frame)."""
        cfg = self.cfg
        self.last_feats = feats
        self._apply_gba_if_ready()
        if self.state == self.NOT_INITIALIZED:
            if cfg.sensor == "mono":
                self._mono_init(feats)
            else:
                self._depth_init(feats)
            self.frame_id += 1
            return self._record(timestamp)

        # motion-model prediction
        T_pred = lie.se3_compose(self.velocity, self.T_cw)
        n_local_kf, n_local_pt = self._local_window()
        res = tr.track_frame(
            self.map, feats, T_pred, self.prev_obs, self._K, cfg.frontend.bf,
            height=cfg.frontend.height, width=cfg.frontend.width,
            n_levels=cfg.frontend.n_levels, scale=cfg.frontend.scale_factor,
            n_local_kf=n_local_kf, n_local_pt=n_local_pt, obs_A=self._get_obs_A(),
        )
        n_inl = int(res.n_inliers)
        if n_inl < cfg.min_inliers_track:
            # lost right after a weak mono init -> start over
            if cfg.sensor == "mono" and int(self.map.n_kf) <= 5:
                self.reset()
                self.frame_id += 1
                return self._record(timestamp)
            self.state = self.LOST
            self.velocity = lie.se3_identity(device=self.device)
            if self._relocalize(feats):
                self.state = self.OK
                self.frame_id += 1
                self.metrics.append({"frame": self.frame_id, "inliers": n_inl, "reloc": True})
                return self._record(timestamp)
            self.frame_id += 1
            self.metrics.append({"frame": self.frame_id, "inliers": n_inl, "lost": True})
            return self._record(timestamp)

        self.state = self.OK
        self.velocity = lie.se3_compose(res.T_cw, lie.se3_inverse(self.T_cw))
        self.T_cw = res.T_cw
        self.prev_obs = res.obs_point
        # tracking statistics for point culling
        self.map = _bump_stats(self.map, res.visible_pt, res.found_pt)
        # localization-only mode never inserts keyframes
        if not self.only_tracking and self._need_new_keyframe(n_inl, feats, res):
            self._insert_keyframe(feats, res)
        self.frame_id += 1
        self.metrics.append({"frame": self.frame_id, "inliers": n_inl, "lost": False})
        return self._record(timestamp)

    # ------------------------------------------------------------------
    # pipelined steady state
    # ------------------------------------------------------------------

    def _track_fast(self, img, aux_img, timestamp):
        """Dispatch one fused frame step, start the copy of its stats to the
        host, and process the PREVIOUS frame's stats. ``aux_img`` is the
        depth map (RGB-D), the right image (stereo) or None (mono)."""
        cfg = self.cfg
        self._apply_gba_if_ready()
        if self._ref_anchor is None:
            self._ref_anchor = self.map.kf_pose[self.ref_kf]
        if self._red_cum is None:
            self._red_cum = ms.obs_level_cum(self.map, cfg.frontend.n_levels)
        n_local_kf, n_local_pt = self._local_window()
        (feats, T_new, vel_new, obs_new, pt_vis, pt_fnd, stats,
         anchor_new) = _frame_step(
            self.map, self._get_obs_A(), img, img if aux_img is None else aux_img,
            self.T_cw, self.velocity, self.prev_obs, self.ref_kf, self._ref_anchor,
            self._red_cum, cfg.frontend, cfg.sensor, cfg.min_inliers_track,
            n_local_kf, n_local_pt, cfg.depth_factor,
        )
        self._ref_anchor = anchor_new
        self.last_feats = feats
        self.map = self.map._replace(pt_visible=pt_vis, pt_found=pt_fnd)
        self.T_cw, self.velocity, self.prev_obs = T_new, vel_new, obs_new
        prev = self._pend
        self._pend = {
            "frame_id": self.frame_id, "ts": timestamp, "stats": _HostCopy(stats),
            "feats": feats, "obs": obs_new, "T": T_new, "ref_kf": self.ref_kf,
            "detections": self._pending_detections,
        }
        self.frame_id += 1
        if prev is not None:
            self._process_pend(prev)
        return T_new

    def _flush(self, allow_kf: bool = True):
        """Drain the depth-1 pipeline (process the pending frame)."""
        p = self._pend
        self._pend = None
        if p is not None:
            self._process_pend(p, allow_kf=allow_kf)

    def _process_pend(self, p, allow_kf: bool = True):
        s = p["stats"].numpy()
        n_inl = int(s[0])
        if n_inl < self.cfg.min_inliers_track:
            self._handle_lost(p, s)
            return
        self.state = self.OK
        self.metrics.append({"frame": p["frame_id"] + 1, "inliers": n_inl,
                             "matches": int(s[1]), "lost": False})
        self.trajectory.append(
            (p["frame_id"], p["ts"], p["ref_kf"], s[11:18].astype(np.float32)))
        if allow_kf and not self.only_tracking and self._need_kf_fast(p, n_inl, s):
            self._insert_keyframe_fast(p, n_inl)

    def _handle_lost(self, p, s):
        """Deferred-lost handling: when frame i-1's stats reveal a tracking
        failure, frame i is already in flight; its device-side ok-gate kept
        the pose unchanged. Right after a weak mono initialization (<= 5
        keyframes) both frames are recorded lost and the system starts
        over. Otherwise a younger frame that re-tracked on its own stays as
        the pipeline head; else relocalization runs on the newest features."""
        cfg = self.cfg
        young = self._pend
        self._pend = None

        def record(q, qs):
            self.metrics.append({"frame": q["frame_id"] + 1, "inliers": int(qs[0]),
                                 "lost": True})
            self.trajectory.append(
                (q["frame_id"], q["ts"], q["ref_kf"], qs[11:18].astype(np.float32)))

        ys = young["stats"].numpy() if young is not None else None
        if cfg.sensor == "mono" and self._n_kf_host <= 5:
            record(p, s)
            if young is not None:
                record(young, ys)
            self.reset()
            return
        record(p, s)
        feats = p["feats"]
        if young is not None:
            if int(ys[0]) >= cfg.min_inliers_track:
                # it tracked from the unchanged pose: keep a good frame
                self.state = self.OK
                self._pend = young
                return
            record(young, ys)
            self.T_cw = young["T"]
            feats = young["feats"]
        self.state = self.LOST
        self.velocity = lie.se3_identity(device=self.device)
        self._ref_anchor = None
        if self._relocalize(feats):
            self.state = self.OK
            self.metrics.append({"frame": self.frame_id, "inliers": -1, "reloc": True})

    def _consume_map_aux(self, block: bool) -> bool:
        """Read the in-flight mapping pass's aux vector when its copy has
        landed (or wait for it). True when mapping is idle afterwards — the
        reference's AcceptKeyFrames flag."""
        a = self._map_aux
        if a is None:
            return True
        if not block and not a.ready():
            return False
        v = a.numpy()
        self._n_ref_vals = {2: max(int(v[2]), 1), 3: max(int(v[3]), 1)}
        self._n_pt_est = int(v[1])
        self._kf_live = int(v[4])
        if int(v[6]) >= 0:
            self.n_kfs_culled += 1
        self._map_aux = None
        return True

    def _n_ref_current(self) -> int:
        min_obs = 3 if self._n_kf_host > 2 else 2
        return max(self._n_ref_vals.get(min_obs, 1), 1)

    def _ref_ratio(self, n_kfs: int) -> float:
        """thRefRatio: 0.75 stereo / RGB-D, 0.4 while the map has fewer than
        2 keyframes, 0.9 for mono (overrides both)."""
        cfg = self.cfg
        if cfg.sensor == "mono":
            return cfg.kf_ref_ratio
        return 0.4 if n_kfs < 2 else cfg.kf_stereo_ref_ratio

    def _need_kf_fast(self, p, n_inl, s) -> bool:
        """NeedNewKeyFrame with the real mapping-idle gate: c1a = the max
        cadence elapsed, c1c (stereo / RGB-D) = tracking weak or close
        points needed; both first drain mapping. c1b = mapping idle and the
        min gap elapsed. c2 = inliers below thRefRatio of the reference
        keyframe's tracked points (or close points needed), forced by c1a,
        vetoed while tracking is strong and >= kf_redundancy_th of the
        tracked points are already covered (stats[18])."""
        cfg = self.cfg
        since = p["frame_id"] - self.last_kf_frame
        idle = self._consume_map_aux(block=False)
        c1a = since >= cfg.max_frames_between_kf
        if c1a and not idle:
            idle = self._consume_map_aux(block=True)
        n_ref = self._n_ref_current()
        need_close = False
        if cfg.sensor in ("stereo", "rgbd"):
            need_close = bool(s[2] < cfg.kf_close_tracked_th
                              and s[3] > cfg.kf_close_untracked_th)
        c1c = cfg.sensor != "mono" and (n_inl < 0.25 * n_ref or need_close)
        if c1c and not idle:
            idle = self._consume_map_aux(block=True)
            n_ref = self._n_ref_current()
        c1b = idle and since >= max(cfg.min_frames_between_kf, cfg.kf_idle_frames, 1)
        ratio = self._ref_ratio(self._n_kf_host)
        c2 = (n_inl < ratio * n_ref or need_close) and n_inl > cfg.min_inliers_kf
        if c1a and n_inl > cfg.min_inliers_kf:
            c2 = True
        redundancy = int(s[18]) / max(n_inl, 1)
        if (redundancy >= cfg.kf_redundancy_th and not need_close and not c1a
                and n_inl >= cfg.kf_strong_inl):
            c2 = False
        return bool((c1a or c1b or c1c) and c2)

    def _protect_mask(self):
        """[K] keyframes that culling must keep, sized by the map's pool:
        the ends of loop edges (culling one would silently drop its edge
        from every later essential graph)."""
        pm = np.zeros((self.map.kf_valid.shape[0],), bool)
        if self.loop_closer is not None:
            for i, j in self.loop_closer.loop_edges:
                pm[i] = True
                pm[j] = True
        return torch.as_tensor(pm, device=self.device)

    def _ensure_capacity_fast(self, p):
        """Host-estimate capacity check, without a device read in the
        steady state. When the estimate says a pool might fill within one
        keyframe's insertions, drain the pipeline once and run the exact
        ``_ensure_capacity``; ``p`` is the frame about to be inserted."""
        P, K = self.map.pt_pos.shape[0], self.map.kf_valid.shape[0]
        N = self.cfg.map.n_features
        if self._n_pt_est + 3 * N < P and self._n_kf_host + 2 < K:
            return
        self._flush(allow_kf=False)
        self._consume_map_aux(block=True)
        self._extra_obs_holders = [p]
        try:
            self._ensure_capacity()
        finally:
            self._extra_obs_holders = []
        self._n_pt_est = int(self.map.n_pt)
        self._n_kf_host = int(self.map.n_kf)
        self._kf_live = int(self.map.kf_valid.sum())

    def _insert_keyframe_fast(self, p, n_inl):
        """Insert the pending frame as a keyframe and dispatch the whole
        mapping pass; its aux vector is read by later keyframe decisions."""
        cfg = self.cfg
        gen = self._reset_gen
        self._ensure_capacity_fast(p)
        # the capacity drain may have processed a lost frame and reset
        if self.state != self.OK or gen != self._reset_gen:
            return
        slot = self._n_kf_host
        m2, aux, red_cum = _insert_and_map(
            self.map, p["feats"], p["T"], p["frame_id"], self.ref_kf, p["obs"],
            self._protect_mask(), self._inv_sigma2, cfg.frontend, cfg.sensor,
            cfg.local_ba_window,
        )
        self._red_cum = red_cum
        self.map = m2
        self._map_aux = _HostCopy(aux)
        self._n_kf_host += 1
        self._kf_live += 1
        # until aux lands, bound the pool usage by the per-keyframe maximum
        self._n_pt_est += 2 * cfg.map.n_features
        self.ref_kf = slot
        self.ref_kf_matches = n_inl
        self.last_kf_frame = p["frame_id"]
        self.n_kfs_created += 1
        # the chain last saw the new ref KF at its insert pose; local BA's
        # refinement lands through the next frame's re-anchor
        self._ref_anchor = p["T"]
        self._index_keyframe(p["feats"], slot)
        if cfg.enable_loop_closing and self.loop_closer is not None:
            self._run_loop_closing(slot)
        self._map_quadrics(slot, p["detections"])

    def _map_quadrics(self, slot: int, detections):
        """The keyframe's detections -> association, init, joint BA (which
        replaces ``self.map``; an async global BA's merge never writes it)."""
        q = self.quadrics
        if q is None or detections is None:
            return
        q.add_keyframe_detections(self.map, slot, detections)
        q.try_initialize(self.map)
        if any(lmk.initialized for lmk in q.landmarks):
            self.map = q.joint_ba(self.map, self._inv_sigma2)

    def _ref_kf_tracked(self, min_obs: int) -> int:
        """KeyFrame::TrackedMapPoints(minObs) of the reference keyframe."""
        P = self.map.pt_pos.shape[0]
        obs_cnt = ms.point_obs_count(self.map)
        row = self.map.kf_obs_point[self.ref_kf].to(torch.int64)
        return int(torch.sum((row >= 0) & (obs_cnt[torch.clamp(row, 0, P - 1)] >= min_obs)))

    def _refresh_host_counters(self):
        """Make the pipeline's host mirrors exact after a synchronous map
        change (initialization, a synchronous keyframe insertion)."""
        self._red_cum = None
        self._n_kf_host = int(self.map.n_kf)
        self._kf_live = int(self.map.kf_valid.sum())
        self._n_pt_est = int(self.map.n_pt)
        self._ref_anchor = None
        self._n_ref_vals = {2: max(self._ref_kf_tracked(2), 1),
                            3: max(self._ref_kf_tracked(3), 1)}

    # ------------------------------------------------------------------
    # synchronous keyframe decision and insertion
    # ------------------------------------------------------------------

    def _need_new_keyframe(self, n_inl, feats, res) -> bool:
        """NeedNewKeyFrame, synchronous subset: mapping never blocks, so
        c1b holds once kf_idle_frames (the mapping-occupancy model) and the
        min gap have passed."""
        cfg = self.cfg
        since = self.frame_id - self.last_kf_frame
        need_close = False
        if cfg.sensor in ("stereo", "rgbd"):
            n_tc, n_nc = _close_census(cfg.frontend, feats, res.obs_point)
            need_close = (int(n_tc) < cfg.kf_close_tracked_th
                          and int(n_nc) > cfg.kf_close_untracked_th)
        # nRefMatches: the reference keyframe's points with >= minObs
        # observations, recomputed each frame
        n_kfs = int(self.map.n_kf)
        n_ref = max(self._ref_kf_tracked(3 if n_kfs > 2 else 2), 1)
        ratio = self._ref_ratio(n_kfs)
        c1a = since >= cfg.max_frames_between_kf
        c1b = since >= max(cfg.min_frames_between_kf, cfg.kf_idle_frames)
        c1c = cfg.sensor != "mono" and (n_inl < 0.25 * n_ref or need_close)
        c2 = (n_inl < ratio * n_ref or need_close) and n_inl > cfg.min_inliers_kf
        # redundancy veto: the census of _need_kf_fast
        if c2 and not need_close and not c1a and n_inl >= cfg.kf_strong_inl:
            if self._red_cum is None:
                self._red_cum = ms.obs_level_cum(self.map, cfg.frontend.n_levels)
            n_red, n_trk = _frame_redundancy(self._red_cum, res.obs_point, feats.level)
            if int(n_red) / max(int(n_trk), 1) >= cfg.kf_redundancy_th:
                c2 = False
        return bool((c1a or c1b or c1c) and c2)

    def _insert_keyframe(self, feats, res: tr.TrackResult):
        """Synchronous keyframe insertion and the local-mapping pass, stage
        by stage (the twin of ``_insert_and_map``)."""
        cfg = self.cfg
        fcfg = cfg.frontend
        self._ensure_capacity()
        # NOT res.obs_point: _ensure_capacity may have compacted the point
        # pool and remapped every point id; self.prev_obs was set to
        # res.obs_point by _track and remapped with the rest
        self.map, slot = ms.insert_keyframe(
            self.map, self.T_cw, self.frame_id, feats.uv_und, feats.ur, feats.level,
            feats.angle, feats.desc, feats.valid, self.prev_obs, self.ref_kf,
        )
        self.ref_kf = int(slot)
        self.ref_kf_matches = int(res.n_inliers)
        self.last_kf_frame = self.frame_id
        self.n_kfs_created += 1
        bf = float(fcfg.bf)
        if cfg.sensor in ("stereo", "rgbd"):
            self.map = _create_depth_points(self.map, slot, feats, self._K, bf,
                                            fcfg.depth_th)
        # --- local mapping pipeline (LocalMapping::Run order) ---
        dims = dict(n_levels=fcfg.n_levels, scale=fcfg.scale_factor)
        self.map = lm.cull_points(self.map)
        self.map, _ = lm.create_new_points(self.map, slot, self._K, bf, **dims)
        # stats BEFORE fuse: fresh points need real scale bands
        self.map = ms.update_point_stats(self.map, self._sf)
        self.map = lm.fuse_neighbors(self.map, slot, self._K, height=fcfg.height,
                                     width=fcfg.width, **dims)
        self.map = ms.update_point_stats(self.map, self._sf)
        self.map, _ = lm.run_local_ba(self.map, slot, self._K, bf, self._inv_sigma2,
                                      window=cfg.local_ba_window)
        self.map = lm.cull_keyframes(self.map, slot, self._protect_mask(),
                                     n_levels=fcfg.n_levels)
        self._index_keyframe(feats, self.ref_kf)
        if cfg.enable_loop_closing and self.loop_closer is not None:
            self._close_loops(self.ref_kf, self.loop_closer.detect(self.map, self.ref_kf))
        self._map_quadrics(self.ref_kf, self._pending_detections)
        # adopt the BA-refined pose and the surviving observations
        self.T_cw = self.map.kf_pose[self.ref_kf]
        self.prev_obs = self.map.kf_obs_point[self.ref_kf]
        self._refresh_host_counters()

    # ------------------------------------------------------------------
    # capacity
    # ------------------------------------------------------------------

    def _ensure_capacity(self):
        """Never stop mapping at pool capacity. Point pool: compact culled
        slots first (``map_state.compact_points``); when genuinely full,
        double the pool. Keyframe pool: compact when culling freed enough
        slots, else double. Each event is counted; a doubling is announced
        on stderr."""
        m = self.map
        P = m.pt_pos.shape[0]
        N = self.cfg.map.n_features
        # each keyframe can allocate up to ~2N rows (depth spawn + triangulation)
        if P - int(m.n_pt) < 3 * N:
            old_valid = m.pt_valid
            n_valid = int(old_valid.sum())
            if P - n_valid >= max(3 * N, P // 8):
                self.map, new_idx = ms.compact_points(m)
                self._map_epoch += 1
                self.n_point_compactions += 1
                self._remap_point_ids(new_idx, old_valid)
            else:
                print(f"[orbslam2-torch] point pool full ({n_valid}/{P} live): "
                      f"growing to {2 * P}", file=sys.stderr, flush=True)
                self.map = ms.grow_map(m, new_P=2 * P)
                self.n_point_growths += 1
        K = self.map.kf_valid.shape[0]
        n_kf = int(self.map.n_kf)
        if K - n_kf < 2:
            n_live = int(self.map.kf_valid.sum())
            if n_kf - n_live >= max(8, K // 4):
                # culling freed plenty of slots: compact instead of growing
                self._compact_keyframes()
                self.n_kf_compactions += 1
            else:
                print(f"[orbslam2-torch] keyframe pool full ({n_live}/{K} live): "
                      f"growing to {2 * K}", file=sys.stderr, flush=True)
                self.map = ms.grow_map(self.map, new_K=2 * K)
                self.n_kf_growths += 1
                if self.loop_closer is not None:
                    self.loop_closer.grow(2 * K)
        # pool shapes or point ids may have changed: the redundancy
        # histogram is recomputed lazily from the new map
        self._red_cum = None

    def _compact_keyframes(self):
        """Pack valid keyframes to the low end of the pool. Every keyframe
        id held OUTSIDE the MapState is re-anchored first: trajectory
        entries and point reference keyframes walk the spanning tree past
        culled slots (the SaveTrajectoryTUM walk) to a live ancestor, then
        all ids are remapped; the database rows follow the permutation and
        an in-flight async global BA is abandoned (its keyframe ids are
        stale). The walks run on the host in numpy."""
        m = self.map
        K = m.kf_valid.shape[0]
        kf_valid = m.kf_valid.cpu().numpy()
        parent = m.kf_parent.cpu().numpy()
        tcp = m.kf_tcp.cpu().numpy()

        # live ancestor + folded T_slot_ancestor for every slot
        anc = np.arange(K)
        fold = [None] * K  # None = identity
        for s in range(K):
            r, F, hops = s, None, 0
            while 0 <= r < K and not kf_valid[r] and parent[r] >= 0 and hops < K:
                F = tcp[r] if F is None else _np_se3_compose(F, tcp[r])
                r = int(parent[r])
                hops += 1
            anc[s] = r if (0 <= r < K and kf_valid[r]) else -1
            fold[s] = F

        order = np.argsort(np.where(kf_valid, 0, 1), kind="stable")
        new_idx = np.cumsum(kf_valid.astype(np.int32)) - 1
        new_idx = np.where(kf_valid, new_idx, -1).astype(np.int32)

        def live(slot):
            a = anc[slot] if 0 <= slot < K else -1
            return int(new_idx[a]) if a >= 0 else -1

        # 1. trajectory entries: fold culled anchors into T_rel
        kf_pose = m.kf_pose.cpu().numpy()
        fixed = []
        for fid, ts, ref, T_rel in self.trajectory:
            r = int(ref)
            if 0 <= r < K and not kf_valid[r] and fold[r] is not None:
                T_rel = _np_se3_compose(np.asarray(T_rel), fold[r])
            lr = live(r)
            if lr < 0:
                # the whole ancestor chain is culled (rare: slot 0 is
                # protected): re-anchor on slot 0 preserving the absolute
                # pose, T_rel' = T_rel . pose[dead_end] . inv(pose[0])
                dead_end, hops = r, 0
                while (0 <= dead_end < K and not kf_valid[dead_end]
                       and parent[dead_end] >= 0 and hops < K):
                    dead_end = int(parent[dead_end])
                    hops += 1
                if 0 <= dead_end < K:
                    T_rel = _np_se3_compose(
                        _np_se3_compose(np.asarray(T_rel), kf_pose[dead_end]),
                        _np_se3_inverse(kf_pose[0]))
                lr = 0
            fixed.append((fid, ts, lr, np.asarray(T_rel)))
        self.trajectory = fixed

        # 2. point reference keyframes -> live ancestors, so that
        #    compact_keyframes' id remap is valid
        first = m.pt_first_kf.cpu().numpy()
        ok_f = (first >= 0) & (first < K)
        first_live = np.where(ok_f, anc[np.clip(first, 0, K - 1)], -1).astype(np.int32)
        m = m._replace(pt_first_kf=torch.as_tensor(first_live, device=self.device))

        # 3. compact the MapState arrays
        self.map = ms.compact_keyframes(
            m, torch.as_tensor(order, device=self.device),
            torch.as_tensor(new_idx, device=self.device))

        # 4. host-held ids (a pipelined frame's "ref_kf" only reaches the
        #    trajectory, and the pipeline is drained before a compaction)
        self.ref_kf = max(live(self.ref_kf), 0)
        lcs = self.loop_closer
        if lcs is not None:
            lcs.permute(torch.as_tensor(order, device=self.device))
            lcs.loop_edges = [(int(new_idx[i]), int(new_idx[j]))
                              for i, j in lcs.loop_edges if kf_valid[i] and kf_valid[j]]
            lcs.consistency = []
            lcs.last_loop_kf = (
                int(new_idx[lcs.last_loop_kf])
                if 0 <= lcs.last_loop_kf < K and kf_valid[lcs.last_loop_kf] else -999)
        if self.quadrics is not None:
            for lmk in self.quadrics.landmarks:
                kept = [(int(new_idx[s]), b) for s, b in zip(lmk.kf_slots, lmk.bboxes)
                        if 0 <= s < K and kf_valid[s]]
                lmk.kf_slots = [s for s, _ in kept]
                lmk.bboxes = [b for _, b in kept]
        self._pending_loop = None  # its slot and scores predate the remap
        with self._gba_lock:
            self._gba_gen += 1
            self._gba_result = None

    def _remap_point_ids(self, new_idx, old_valid):
        """Point-id fixup after ``compact_points`` for the ids held outside
        the MapState: the last frame's observations, the pipelined frame,
        the frame awaiting insertion and the quadric landmarks' members."""
        P = old_valid.shape[0]

        def remap(obs):
            oc = torch.clamp(obs.to(torch.int64), 0, P - 1)
            ok = (obs >= 0) & old_valid[oc]
            return torch.where(ok, new_idx[oc], -1).to(torch.int32)

        self.prev_obs = remap(self.prev_obs)
        if self._pend is not None:
            self._pend["obs"] = remap(self._pend["obs"])
        for holder in self._extra_obs_holders:
            holder["obs"] = remap(holder["obs"])
        if self.quadrics is not None:
            valid, idx = old_valid.cpu().numpy(), new_idx.cpu().numpy()
            for lmk in self.quadrics.landmarks:
                lmk.point_ids = {int(idx[p]) for p in lmk.point_ids if p < P and valid[p]}

    # ------------------------------------------------------------------
    # initialization
    # ------------------------------------------------------------------

    def _mono_init(self, feats):
        """MonocularInitialization: match against the held first frame,
        two-view reconstruction, two keyframes + points, global BA."""
        cfg = self.cfg
        n_valid = int(feats.valid.sum())
        if self.init_feats is None or n_valid < 100:
            if n_valid >= 100:
                self.init_feats = feats
                self.init_frame_id = self.frame_id
            return
        f0 = self.init_feats
        idx, _ = matching.match_windowed(
            f0.uv_und, f0.desc, f0.angle, f0.valid,
            feats.uv_und, feats.desc, feats.angle, feats.valid,
            window=100.0, th=matching.TH_LOW, check_rotation=True,
            level_a=f0.level, level_b=feats.level,
        )
        if int((idx >= 0).sum()) < 100:
            # stale initializer: restart from this frame
            self.init_feats = feats if n_valid >= 100 else None
            self.init_frame_id = self.frame_id
            return
        M = idx.shape[0]
        tgt = torch.clamp(idx, 0, M - 1)
        res = init2view.initialize_two_view(
            self._K, f0.uv_und, feats.uv_und[tgt], idx >= 0,
            generator=self._generator,
        )
        if not bool(res.ok):
            return

        # median-depth normalization
        good = res.good.cpu().numpy()
        X = res.points.cpu().numpy()
        med = float(np.median(X[good, 2])) if good.any() else 1.0
        inv_med = 1.0 / max(med, 1e-6)
        pts = X * inv_med
        T21 = res.T_21.clone()
        T21[4:7] *= inv_med

        # compact the 2x init rows to the map's per-keyframe budget:
        # triangulated matches first, then other valid keypoints; rows stay
        # aligned between the two keyframes
        Nm = cfg.map.n_features
        valid0 = f0.valid.cpu().numpy()
        tgt_np = tgt.cpu().numpy()
        sel0 = np.argsort(np.where(good, 0, np.where(valid0, 1, 2)), kind="stable")[:Nm]
        good0 = good[sel0]
        valid1 = feats.valid.cpu().numpy()
        sel1 = np.zeros((Nm,), np.int64)
        gi = np.where(good0)[0]
        sel1[gi] = tgt_np[sel0[gi]]
        used = np.zeros(len(valid1), bool)
        used[sel1[gi]] = True
        fill = np.where(valid1 & ~used)[0]
        rest = np.where(~good0)[0]
        k_fill = min(len(rest), len(fill))
        sel1[rest[:k_fill]] = fill[:k_fill]
        row1_ok = np.zeros((Nm,), bool)
        row1_ok[gi] = True
        row1_ok[rest[:k_fill]] = True

        dev = self.device
        s0t = torch.as_tensor(sel0, device=dev)
        s1t = torch.as_tensor(sel1, device=dev)
        no_obs = torch.full((Nm,), -1, dtype=torch.int32, device=dev)
        m, s0 = ms.insert_keyframe(
            self.map, lie.se3_identity(device=dev), self.init_frame_id,
            f0.uv_und[s0t], f0.ur[s0t], f0.level[s0t], f0.angle[s0t], f0.desc[s0t],
            f0.valid[s0t], no_obs, -1,
        )
        m, s1 = ms.insert_keyframe(
            m, T21, self.frame_id,
            feats.uv_und[s1t], feats.ur[s1t], feats.level[s1t], feats.angle[s1t],
            feats.desc[s1t], feats.valid[s1t] & torch.as_tensor(row1_ok, device=dev),
            no_obs, s0,
        )
        m, pids = ms.insert_points(
            m, torch.as_tensor(pts[sel0], dtype=torch.float32, device=dev),
            f0.desc[s0t], torch.zeros(Nm, dtype=torch.int32, device=dev) + s0.to(torch.int32),
            torch.as_tensor(good0, device=dev),
        )
        obs = m.kf_obs_point.clone()
        obs[s0] = pids.to(torch.int32)
        obs[s1] = pids.to(torch.int32)
        m = ms.update_point_stats(m._replace(kf_obs_point=obs), self._sf)
        # full BA on the initial map (GlobalBundleAdjustemnt(20))
        self.map, _ = lm.run_global_ba(m, self._K, float(cfg.frontend.bf),
                                       self._inv_sigma2, n_iters=20)
        s1 = int(s1)
        self.T_cw = self.map.kf_pose[s1]
        self.prev_obs = self.map.kf_obs_point[s1]
        self.ref_kf = s1
        self.ref_kf_matches = int((self.prev_obs >= 0).sum())
        self.last_kf_frame = self.frame_id
        self.velocity = lie.se3_identity(device=dev)
        self.state = self.OK
        self._refresh_host_counters()

    def _depth_init(self, feats):
        """StereoInitialization: the first frame with >= 500 features
        becomes keyframe 0, and every keypoint with a depth spawns a point."""
        if int(feats.valid.sum()) < 500:
            return
        dev = self.device
        N = feats.uv.shape[0]
        self.map, s0 = ms.insert_keyframe(
            self.map, lie.se3_identity(device=dev), self.frame_id, feats.uv_und,
            feats.ur, feats.level, feats.angle, feats.desc, feats.valid,
            torch.full((N,), -1, dtype=torch.int32, device=dev), -1,
        )
        s0 = int(s0)
        self.map = _create_depth_points(self.map, s0, feats, self._K,
                                        float(self.cfg.frontend.bf), 1e9)
        self.map = ms.update_point_stats(self.map, self._sf)
        self.T_cw = lie.se3_identity(device=dev)
        self.prev_obs = self.map.kf_obs_point[s0]
        self.ref_kf = s0
        self.ref_kf_matches = int((self.prev_obs >= 0).sum())
        self.last_kf_frame = self.frame_id
        self.init_frame_id = self.frame_id
        self.state = self.OK
        self._refresh_host_counters()

    # ------------------------------------------------------------------

    def _record(self, timestamp):
        T_rel = lie.se3_compose(self.T_cw, lie.se3_inverse(self.map.kf_pose[self.ref_kf]))
        self.trajectory.append(
            (self.frame_id - 1, timestamp, self.ref_kf, T_rel.cpu().numpy()))
        return self.T_cw

    def full_trajectory(self):
        """Per-frame poses re-anchored on the final keyframe poses, walking
        the spanning tree past culled reference keyframes with their frozen
        T_child_parent (SaveTrajectoryTUM). Returns [(frame_id, ts, T [7])]."""
        self._flush()
        kf_pose = self.map.kf_pose.cpu()
        kf_valid = self.map.kf_valid.cpu().numpy()
        kf_parent = self.map.kf_parent.cpu().numpy()
        kf_tcp = self.map.kf_tcp.cpu()
        K = len(kf_valid)
        out = []
        for fid, ts, ref, T_rel in self.trajectory:
            r = int(ref)
            T = torch.as_tensor(T_rel)
            hops = 0
            while not kf_valid[r] and kf_parent[r] >= 0 and hops < K:
                T = lie.se3_compose(T, kf_tcp[r])
                r = int(kf_parent[r])
                hops += 1
            out.append((fid, ts, lie.se3_compose(T, kf_pose[r]).numpy()))
        return out

    def keyframe_trajectory(self):
        """(frame_id, T_cw [7]) of every live keyframe, in slot order
        (SaveKeyFrameTrajectoryTUM)."""
        self._flush()
        kf_valid = self.map.kf_valid.cpu().numpy()
        kf_pose = self.map.kf_pose.cpu().numpy()
        kf_fid = self.map.kf_frame_id.cpu().numpy()
        return [(int(kf_fid[s]), kf_pose[s]) for s in range(int(self.map.n_kf))
                if kf_valid[s]]

    # the savers write the original system's TUM / KITTI files

    def save_trajectory_tum(self, path: str):
        trajectory.save_tum(path, ((ts, metrics.se3_vec_to_mat(T7))
                                   for _, ts, T7 in self.full_trajectory()))

    def save_keyframe_trajectory_tum(self, path: str):
        """A keyframe's timestamp is its frame's (the frame id where the
        frame has no trajectory entry)."""
        ts_by_fid = {fid: ts for fid, ts, _, _ in self.trajectory}
        trajectory.save_tum(path, ((ts_by_fid.get(fid, float(fid)), metrics.se3_vec_to_mat(T7))
                                   for fid, T7 in self.keyframe_trajectory()))

    def save_trajectory_kitti(self, path: str):
        trajectory.save_kitti(path, ((ts, metrics.se3_vec_to_mat(T7))
                                     for _, ts, T7 in self.full_trajectory()))


def _np_se3_compose(a7, b7):
    """Host-side se3_compose (mat(A) @ mat(B)) for the compaction walks."""
    return metrics.mat_to_se3_vec(
        metrics.se3_vec_to_mat(np.asarray(a7)) @ metrics.se3_vec_to_mat(np.asarray(b7)))


def _np_se3_inverse(a7):
    """Host-side se3_inverse, the counterpart of ``_np_se3_compose``."""
    return metrics.mat_to_se3_vec(np.linalg.inv(metrics.se3_vec_to_mat(np.asarray(a7))))


def _bump_stats(m: ms.MapState, visible, found):
    """Tracking's visible / found counters; the other fields keep their
    tensor identity, which the observation-matrix cache relies on."""
    return m._replace(pt_visible=m.pt_visible + visible.to(torch.int32),
                      pt_found=m.pt_found + found.to(torch.int32))


def _frame_redundancy(red_cum, obs, level):
    """(n_redundant, n_tracked) of a frame's observation row against the
    per-point obs-level histogram: tracked points already observed >= 3
    times at octave <= own + 1 (the KeyFrameCulling criterion, per frame)."""
    P, L = red_cum.shape
    lvl_gate = torch.clamp(torch.clamp(level.to(torch.int64), 0, L - 1) + 1, max=L - 1)
    n_oth = red_cum[torch.clamp(obs.to(torch.int64), 0, P - 1), lvl_gate]
    tracked = obs >= 0
    return torch.sum(tracked & (n_oth >= 3.0)), torch.sum(tracked)


def _close_census(fcfg: fe.FrontendConfig, feats, obs):
    """(tracked, untracked) counts of the frame's close keypoints (depth
    below depth_th baselines): the stereo / RGB-D keyframe decision's input."""
    close_th = fcfg.depth_th * fcfg.bf / max(fcfg.fx, 1e-6)
    close = feats.valid & (feats.depth > 0) & (feats.depth < close_th)
    return torch.sum(close & (obs >= 0)), torch.sum(close & (obs < 0))


# ---------------------------------------------------------------------------
# device programs
# ---------------------------------------------------------------------------

def _frame_step(m: ms.MapState, obs_A, img, aux_img, T_cw, velocity, prev_obs,
                ref_kf, ref_anchor, red_cum, fcfg: fe.FrontendConfig, sensor: str,
                min_inl: int, n_local_kf: int, n_local_pt: int,
                depth_factor: float = 1.0):
    """The whole per-frame hot path: extraction (with the depth lookup or
    the stereo match from ``aux_img``), both matching passes and pose
    optimizations, tracking-stat bumps, the keyframe-decision censuses and
    the trajectory anchor. Nothing in it reads back to the host.

    Returns (feats, T_new, vel_new, obs_new, pt_visible, pt_found,
    stats[19], T_ref_now) with stats = [n_inliers, n_matches,
    n_close_tracked, n_close_untracked (both 0 for mono), T_new(7),
    T_rel(7), n_redundant]."""
    dev = m.pt_pos.device
    if sensor == "mono":
        feats = fe.extract_mono(fcfg, img)
    elif sensor == "rgbd":
        feats = fe.extract_rgbd(fcfg, img, aux_img.to(torch.float32) * depth_factor)
    else:
        feats = fe.extract_stereo(fcfg, img, aux_img)
    # re-anchor on the reference keyframe: any refinement of its pose since
    # the chain last saw it (local BA) moves the live pose along
    T_ref_now = m.kf_pose[ref_kf]
    T_cw = lie.se3_compose(lie.se3_compose(T_cw, lie.se3_inverse(ref_anchor)), T_ref_now)
    T_pred = lie.se3_compose(velocity, T_cw)
    Kc = fe.intrinsics(fcfg, str(dev))[0]
    res = tr.track_frame(
        m, feats, T_pred, prev_obs, Kc, fcfg.bf, height=fcfg.height,
        width=fcfg.width, n_levels=fcfg.n_levels, scale=fcfg.scale_factor,
        n_local_kf=n_local_kf, n_local_pt=n_local_pt, obs_A=obs_A,
    )
    ok = res.n_inliers >= min_inl
    T_new = torch.where(ok, res.T_cw, T_cw)
    vel_new = torch.where(ok, lie.se3_compose(res.T_cw, lie.se3_inverse(T_cw)),
                          lie.se3_identity(device=dev))
    obs_new = torch.where(ok, res.obs_point, -1)
    pt_visible = m.pt_visible + (res.visible_pt & ok).to(torch.int32)
    pt_found = m.pt_found + (res.found_pt & ok).to(torch.int32)

    if sensor in ("stereo", "rgbd"):
        n_tc, n_nc = _close_census(fcfg, feats, obs_new)
    else:
        n_tc = n_nc = torch.zeros((), device=dev)
    n_red = _frame_redundancy(red_cum, obs_new, feats.level)[0]

    T_rel = lie.se3_compose(T_new, lie.se3_inverse(T_ref_now))
    stats = torch.cat([
        torch.stack([c.to(torch.float32) for c in (res.n_inliers, res.n_matches, n_tc, n_nc)]),
        T_new, T_rel, n_red.to(torch.float32)[None],
    ])
    return feats, T_new, vel_new, obs_new, pt_visible, pt_found, stats, T_ref_now


def _insert_and_map(m: ms.MapState, feats, T_cw, frame_id, parent, obs_row, protect,
                    inv_sigma2, fcfg: fe.FrontendConfig, sensor: str, window: int):
    """Keyframe insertion + the whole LocalMapping pass (depth points for
    stereo / RGB-D, cull points, triangulate, stats, fuse, stats, local BA,
    cull keyframes).

    Returns (m2, aux[7], red_cum) with aux = [n_new_points, n_pt,
    n_ref_minobs2, n_ref_minobs3, n_kf_live, n_pt_live, culled_slot or -1]
    and red_cum the post-mapping per-(point, octave) histogram."""
    dev = m.pt_pos.device
    Kc = fe.intrinsics(fcfg, str(dev))[0]
    bf = float(fcfg.bf)
    sf = orb.scale_factors(fcfg.n_levels, fcfg.scale_factor, dev)[0]
    m, slot = ms.insert_keyframe(
        m, T_cw, frame_id, feats.uv_und, feats.ur, feats.level, feats.angle,
        feats.desc, feats.valid, obs_row, parent,
    )
    if sensor in ("stereo", "rgbd"):
        m = _create_depth_points(m, slot, feats, Kc, bf, fcfg.depth_th)
    m = lm.cull_points(m)
    # covisibility built twice per pass, as the reference's
    # UpdateConnections (ProcessNewKeyFrame and after SearchInNeighbors)
    W1 = ms.covisibility(m)
    m, n_new = lm.create_new_points(m, slot, Kc, bf, n_levels=fcfg.n_levels,
                                    scale=fcfg.scale_factor, W=W1)
    # stats BEFORE fuse: fresh points need real scale bands. On the card
    # only the new keyframe's neighbourhood's points (as the reference on its
    # accelerator); on the CPU the full pool (as the reference on its CPU)
    local = lm.on_accelerator(m)

    def stats(mm, W):
        if local:
            return ms.update_point_stats_local(mm, sf, slot, W=W)
        return ms.update_point_stats(mm, sf)

    m = stats(m, W1)
    m = lm.fuse_neighbors(m, slot, Kc, height=fcfg.height, width=fcfg.width,
                          n_levels=fcfg.n_levels, scale=fcfg.scale_factor, W=W1)
    W2 = ms.covisibility(m)
    m = stats(m, W2)
    m, _ = lm.run_local_ba(m, slot, Kc, bf, inv_sigma2, window=window, W=W2)
    valid_before = m.kf_valid
    m = lm.cull_keyframes(m, slot, protect, W=W2, n_levels=fcfg.n_levels)

    P = m.pt_pos.shape[0]
    cnt = ms.point_obs_count(m)[torch.clamp(m.kf_obs_point[slot].to(torch.int64), 0, P - 1)]
    row_ok = m.kf_obs_point[slot] >= 0
    gone = valid_before & ~m.kf_valid
    culled = torch.where(torch.any(gone), torch.argmax(gone.to(torch.int32)), -1)
    aux = torch.stack([
        n_new.to(torch.float32), m.n_pt.to(torch.float32),
        torch.sum(row_ok & (cnt >= 2)).to(torch.float32),
        torch.sum(row_ok & (cnt >= 3)).to(torch.float32),
        torch.sum(m.kf_valid).to(torch.float32),
        torch.sum(m.pt_valid).to(torch.float32),
        culled.to(torch.float32),
    ])
    return m, aux, ms.obs_level_cum(m, fcfg.n_levels)


def _create_depth_points(m: ms.MapState, kf_id, feats, Kc, bf, depth_th):
    """Spawn map points from stereo / RGB-D depth for the keyframe's
    unmatched keypoints closer than ``depth_th`` baselines
    (StereoInitialization and CreateNewKeyFrame). ``kf_id`` is an int or a
    device scalar."""
    dev = m.pt_pos.device
    N = feats.uv.shape[0]
    k = torch.as_tensor(kf_id, device=dev).to(torch.int64).reshape(1)
    th = torch.full((), depth_th, dtype=torch.float32, device=dev) * bf \
        / torch.clamp(Kc[0], min=1e-6)
    want = (feats.valid & (feats.depth > 0) & (feats.depth < th)
            & (m.kf_obs_point[k][0] < 0))
    pc = camera.backproject(Kc, feats.uv_und, feats.depth)
    pw = lie.se3_apply(lie.se3_inverse(m.kf_pose[k][0]), pc)
    m2, pids = ms.insert_points(m, pw, feats.desc, k.to(torch.int32).expand(N), want)
    obs = m2.kf_obs_point.clone()
    obs[k] = torch.where(pids >= 0, pids.to(torch.int32), obs[k][0])[None]
    return m2._replace(kf_obs_point=obs)
