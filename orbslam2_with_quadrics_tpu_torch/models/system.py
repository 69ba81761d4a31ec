"""System facade, monocular subset: ``System.track_monocular``.

Counterpart of the reference's ``models/system.py`` for the monocular main
path: two-view initialization (``_mono_init``), the per-frame fused step
(``_frame_step``) behind a depth-1 pipeline (``_track_fast``: frame i's
stats are read while frame i+1 runs on the device) and keyframe-rate
mapping (``_insert_and_map``). A device-to-host copy into pinned memory
plus a CUDA event replaces JAX's ``copy_to_host_async`` / ``is_ready``.

Not ported yet — each raises ``NotImplementedError`` naming the ROADMAP
item that brings it: stereo and RGB-D, loop closing, quadric landmarks,
asynchronous global BA, relocalization after tracking loss, and pool
compaction or growth. The keyframe database and vocabulary feed only loop
closing and relocalization, so the slice keeps none.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..ops import init2view, lie, matching, orb
from . import frontend as fe
from . import local_mapping as lm
from . import map_state as ms
from . import tracking as tr


@dataclasses.dataclass
class SystemConfig:
    frontend: fe.FrontendConfig
    map: ms.MapConfig
    sensor: str = "mono"
    min_frames_between_kf: int = 0
    max_frames_between_kf: int = 30
    kf_idle_frames: int = 3         # mapping occupancy floor after a KF
    kf_ref_ratio: float = 0.9       # thRefRatio (mono)
    kf_redundancy_th: float = 0.9   # skip c1b insertion when this share of
                                    # tracked points is already covered >= 3x
    kf_strong_inl: int = 100        # ... and only while tracking is strong
    min_inliers_track: int = 30
    min_inliers_kf: int = 15
    local_ba_window: int = 16
    enable_loop_closing: bool = False
    enable_quadrics: bool = False
    async_gba: bool = False
    n_local_kf: int = 64            # local-map window
    n_local_pt: int = 4096          # local point budget for tracking


_NOT_PORTED = {
    "sensor": "stereo and RGB-D tracking (ROADMAP queue 1 item 11)",
    "enable_loop_closing": "loop closing (ROADMAP queue 1 item 12)",
    "enable_quadrics": "quadric object landmarks (ROADMAP queue 1 item 13)",
    "async_gba": "asynchronous global BA (ROADMAP queue 1 item 12)",
}


class _HostCopy:
    """A device tensor copied to pinned host memory without blocking; the
    CUDA event says when the copy (and everything queued before it) is
    done. A CPU tensor is its own host copy."""

    def __init__(self, t):
        self.event = None
        if t.is_cuda:
            self.host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            self.host.copy_(t, non_blocking=True)
            self.event = torch.cuda.Event()
            self.event.record()
        else:
            self.host = t

    def ready(self) -> bool:
        return self.event is None or self.event.query()

    def numpy(self):
        if self.event is not None:
            self.event.synchronize()
        return self.host.numpy()


class System:
    """Monocular SLAM facade (System::TrackMonocular)."""

    NOT_INITIALIZED = 0
    OK = 1
    LOST = 2

    def __init__(self, cfg: SystemConfig):
        if cfg.sensor != "mono":
            raise NotImplementedError(_NOT_PORTED["sensor"])
        for flag in ("enable_loop_closing", "enable_quadrics", "async_gba"):
            if getattr(cfg, flag):
                raise NotImplementedError(_NOT_PORTED[flag])
        self.cfg = cfg
        self.device = torch.device(cfg.map.device)
        fcfg = cfg.frontend
        self._K = fe.intrinsics(fcfg, str(self.device))[0]
        self._sf, _, self._inv_sigma2 = orb.scale_factors(
            fcfg.n_levels, fcfg.scale_factor, self.device)
        # before initialization the reference extracts 2x the features
        self._init_fe_cfg = dataclasses.replace(fcfg, n_features=2 * fcfg.n_features)
        # two-view RANSAC samples, seeded as the reference's PRNGKey(0)
        self._generator = torch.Generator(device=self.device).manual_seed(0)
        self.frame_id = 0
        self.trajectory = []  # (frame_id, timestamp, ref kf slot, T_rel np [7])
        self.metrics = []
        self.n_kfs_created = 0
        self.n_kfs_culled = 0
        self._reset_gen = 0
        self.reset()

    # ------------------------------------------------------------------
    # public per-frame entry
    # ------------------------------------------------------------------

    def track_monocular(self, img, timestamp=0.0, detections=None):
        """Track one grayscale frame (numpy array or tensor, any integer or
        float dtype). Returns the frame's T_cw [7]."""
        if detections is not None:
            raise NotImplementedError(_NOT_PORTED["enable_quadrics"])
        img = torch.as_tensor(img)
        if self.device.type == "cuda" and not img.is_cuda:
            # pinned + non_blocking: the upload does not wait for queued work
            img = img.pin_memory().to(self.device, non_blocking=True)
        else:
            img = img.to(self.device)
        if self.state == self.OK:
            return self._track_fast(img, timestamp)
        fcfg = (self._init_fe_cfg if self.state == self.NOT_INITIALIZED
                else self.cfg.frontend)
        return self._track(fe.extract_mono(fcfg, img), timestamp)

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

    def _get_obs_A(self):
        """[K,P] observation matrix, rebuilt only when the observation
        table changes (keyed on tensor identity)."""
        src = (self.map.kf_obs_point, self.map.kf_kp_valid, self.map.kf_valid)
        if self._obs_A is None or any(a is not b for a, b in zip(src, self._obs_A_src)):
            self._obs_A = ms.observation_matrix(self.map)
            self._obs_A_src = src
        return self._obs_A

    def _track(self, feats, timestamp):
        """Synchronous path: monocular initialization only."""
        self.last_feats = feats
        if self.state != self.NOT_INITIALIZED:
            raise NotImplementedError(
                "synchronous tracking outside initialization (the LOST state "
                "and relocalization): ROADMAP queue 1 item 12")
        self._mono_init(feats)
        self.frame_id += 1
        return self._record(timestamp)

    # ------------------------------------------------------------------
    # pipelined steady state
    # ------------------------------------------------------------------

    def _track_fast(self, img, timestamp):
        """Dispatch one fused frame step, start the copy of its stats to the
        host, and process the PREVIOUS frame's stats."""
        cfg = self.cfg
        if self._ref_anchor is None:
            self._ref_anchor = self.map.kf_pose[self.ref_kf]
        if self._red_cum is None:
            self._red_cum = ms.obs_level_cum(self.map, cfg.frontend.n_levels)
        (feats, T_new, vel_new, obs_new, pt_vis, pt_fnd, stats,
         anchor_new) = _frame_step(
            self.map, self._get_obs_A(), img, self.T_cw, self.velocity,
            self.prev_obs, self.ref_kf, self._ref_anchor, self._red_cum,
            cfg.frontend, cfg.min_inliers_track,
            min(cfg.n_local_kf, cfg.map.max_keyframes),
            min(cfg.n_local_pt, cfg.map.max_points),
        )
        self._ref_anchor = anchor_new
        self.last_feats = feats
        self.map = self.map._replace(pt_visible=pt_vis, pt_found=pt_fnd)
        self.T_cw, self.velocity, self.prev_obs = T_new, vel_new, obs_new
        prev = self._pend
        self._pend = {
            "frame_id": self.frame_id, "ts": timestamp, "stats": _HostCopy(stats),
            "feats": feats, "obs": obs_new, "T": T_new, "ref_kf": self.ref_kf,
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
        if allow_kf and self._need_kf_fast(p, n_inl, s):
            self._insert_keyframe_fast(p, n_inl)

    def _handle_lost(self, p, s):
        """Tracking failure: right after a weak initialization (<= 5
        keyframes) both in-flight frames are recorded lost and the system
        starts over; later, the reference relocalizes — not ported."""
        young = self._pend
        self._pend = None
        if self._n_kf_host > 5:
            raise NotImplementedError(
                "relocalization after tracking loss: ROADMAP queue 1 item 12")
        frames = [(p, s)]
        if young is not None:
            frames.append((young, young["stats"].numpy()))
        for q, qs in frames:
            self.metrics.append({"frame": q["frame_id"] + 1, "inliers": int(qs[0]),
                                 "lost": True})
            self.trajectory.append(
                (q["frame_id"], q["ts"], q["ref_kf"], qs[11:18].astype(np.float32)))
        self.reset()

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

    def _need_kf_fast(self, p, n_inl, s) -> bool:
        """NeedNewKeyFrame (mono): c1a = the max cadence elapsed (waits for
        mapping), c1b = mapping idle and the min gap elapsed; c2 = inliers
        below thRefRatio of the reference keyframe's tracked points, forced
        by c1a, vetoed while tracking is strong and >= kf_redundancy_th of
        the tracked points are already covered (stats[18])."""
        cfg = self.cfg
        since = p["frame_id"] - self.last_kf_frame
        idle = self._consume_map_aux(block=False)
        c1a = since >= cfg.max_frames_between_kf
        if c1a and not idle:
            idle = self._consume_map_aux(block=True)
        n_ref = self._n_ref_current()
        c1b = idle and since >= max(cfg.min_frames_between_kf, cfg.kf_idle_frames, 1)
        c2 = n_inl < cfg.kf_ref_ratio * n_ref and n_inl > cfg.min_inliers_kf
        if c1a and n_inl > cfg.min_inliers_kf:
            c2 = True
        redundancy = int(s[18]) / max(n_inl, 1)
        if (redundancy >= cfg.kf_redundancy_th and not c1a
                and n_inl >= cfg.kf_strong_inl):
            c2 = False
        return bool((c1a or c1b) and c2)

    def _ensure_capacity_fast(self):
        """Host-estimate capacity check; near the pools' end, drain the
        pipeline and check exactly. Compaction and growth are not ported."""
        cfg = self.cfg
        P, K, N = cfg.map.max_points, cfg.map.max_keyframes, cfg.map.n_features
        if self._n_pt_est + 3 * N < P and self._n_kf_host + 2 < K:
            return
        self._flush(allow_kf=False)
        self._consume_map_aux(block=True)
        n_pt, n_kf = int(self.map.n_pt), int(self.map.n_kf)
        if P - n_pt < 3 * N or K - n_kf < 2:
            raise NotImplementedError(
                f"map pool compaction / growth (points {n_pt}/{P}, keyframes "
                f"{n_kf}/{K}): ROADMAP queue 1 item 10")
        self._n_pt_est, self._n_kf_host = n_pt, n_kf
        self._kf_live = int(self.map.kf_valid.sum())

    def _insert_keyframe_fast(self, p, n_inl):
        """Insert the pending frame as a keyframe and dispatch the whole
        mapping pass; its aux vector is read by later keyframe decisions."""
        cfg = self.cfg
        gen = self._reset_gen
        self._ensure_capacity_fast()
        # the capacity drain may have processed a lost frame and reset
        if self.state != self.OK or gen != self._reset_gen:
            return
        slot = self._n_kf_host
        m2, aux, red_cum = _insert_and_map(
            self.map, p["feats"], p["T"], p["frame_id"], self.ref_kf, p["obs"],
            torch.zeros(cfg.map.max_keyframes, dtype=torch.bool, device=self.device),
            self._inv_sigma2, cfg.frontend, cfg.local_ba_window,
        )
        self._red_cum = red_cum
        self.map = m2
        self._map_aux = _HostCopy(aux)
        self._n_kf_host += 1
        self._kf_live += 1
        self._n_pt_est += 2 * cfg.map.n_features
        self.ref_kf = slot
        self.ref_kf_matches = n_inl
        self.last_kf_frame = p["frame_id"]
        self.n_kfs_created += 1
        # the chain last saw the new ref KF at its insert pose; local BA's
        # refinement lands through the next frame's re-anchor
        self._ref_anchor = p["T"]

    def _ref_kf_tracked(self, min_obs: int) -> int:
        """KeyFrame::TrackedMapPoints(minObs) of the reference keyframe."""
        P = self.map.pt_pos.shape[0]
        obs_cnt = ms.point_obs_count(self.map)
        row = self.map.kf_obs_point[self.ref_kf].to(torch.int64)
        return int(torch.sum((row >= 0) & (obs_cnt[torch.clamp(row, 0, P - 1)] >= min_obs)))

    def _refresh_host_counters(self):
        """Make the pipeline's host mirrors exact after a synchronous map
        change (initialization)."""
        self._red_cum = None
        self._n_kf_host = int(self.map.n_kf)
        self._kf_live = int(self.map.kf_valid.sum())
        self._n_pt_est = int(self.map.n_pt)
        self._ref_anchor = None
        self._n_ref_vals = {2: max(self._ref_kf_tracked(2), 1),
                            3: max(self._ref_kf_tracked(3), 1)}

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


# ---------------------------------------------------------------------------
# device programs
# ---------------------------------------------------------------------------

def _frame_step(m: ms.MapState, obs_A, img, T_cw, velocity, prev_obs, ref_kf,
                ref_anchor, red_cum, fcfg: fe.FrontendConfig, min_inl: int,
                n_local_kf: int, n_local_pt: int):
    """The whole per-frame hot path: extraction, both matching passes and
    pose optimizations, tracking-stat bumps, the keyframe-decision census
    and the trajectory anchor. Nothing in it reads back to the host.

    Returns (feats, T_new, vel_new, obs_new, pt_visible, pt_found,
    stats[19], T_ref_now) with stats = [n_inliers, n_matches,
    n_close_tracked, n_close_untracked (0 for mono), T_new(7), T_rel(7),
    n_redundant]."""
    dev = m.pt_pos.device
    feats = fe.extract_mono(fcfg, img)
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

    # redundancy census: tracked points already observed >= 3 times at
    # octave <= own + 1 (the KeyFrameCulling criterion, per frame)
    P, L = red_cum.shape
    lvl_gate = torch.clamp(torch.clamp(feats.level.to(torch.int64), 0, L - 1) + 1, max=L - 1)
    n_oth = red_cum[torch.clamp(obs_new.to(torch.int64), 0, P - 1), lvl_gate]
    n_red = torch.sum((obs_new >= 0) & (n_oth >= 3.0)).to(torch.float32)

    T_rel = lie.se3_compose(T_new, lie.se3_inverse(T_ref_now))
    stats = torch.cat([
        torch.stack([res.n_inliers.to(torch.float32), res.n_matches.to(torch.float32)]),
        torch.zeros(2, device=dev), T_new, T_rel, n_red[None],
    ])
    return feats, T_new, vel_new, obs_new, pt_visible, pt_found, stats, T_ref_now


def _insert_and_map(m: ms.MapState, feats, T_cw, frame_id, parent, obs_row, protect,
                    inv_sigma2, fcfg: fe.FrontendConfig, window: int):
    """Keyframe insertion + the whole LocalMapping pass (cull points,
    triangulate, stats, fuse, stats, local BA, cull keyframes).

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
    m = lm.cull_points(m)
    # covisibility built twice per pass, as the reference's
    # UpdateConnections (ProcessNewKeyFrame and after SearchInNeighbors)
    W1 = ms.covisibility(m)
    m, n_new = lm.create_new_points(m, slot, Kc, bf, n_levels=fcfg.n_levels,
                                    scale=fcfg.scale_factor, W=W1)
    # stats BEFORE fuse: fresh points need real scale bands
    m = ms.update_point_stats(m, sf)
    m = lm.fuse_neighbors(m, slot, Kc, height=fcfg.height, width=fcfg.width,
                          n_levels=fcfg.n_levels, scale=fcfg.scale_factor, W=W1)
    W2 = ms.covisibility(m)
    m = ms.update_point_stats(m, sf)
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
