"""Loop closing: BoW retrieval, Sim3 computation, graph correction (torch).

Counterpart of the reference's ``models/loop_closing.py`` (LoopClosing +
KeyFrameDatabase): the inverted file is a dense [K, V] BoW matrix (small
vocabularies) or per-keyframe sorted (word, value) lists (large ones) scored
in one vectorized sweep; loop geometric verification is the batched Horn /
Sim3 RANSAC (``ops/sim3solver.py``); the essential-graph solve is
``ops/pose_graph.py``. The 3-consecutive-keyframe consistency check is
host-side bookkeeping over tiny sets.

The three descriptor searches of a closure (mutual pairing, the loop
points' projection into the current keyframe, the fuse into its covisible
group) are one ``masked_hamming_best2`` call each.
"""

from __future__ import annotations

import os
import sys

import numpy as np
import torch

from ..ops import camera, lie, matching, orb, pose_graph, sim3solver, vocab
from ..ops.orb import topk_stable
from ..utils import tracing
from . import map_state as ms
from .tracking import predict_scale

def gather_loop_points(m: ms.MapState, cand, n_nb: int = 10, budget: int = 4096):
    """Fixed-size id list of the loop side's map points: everything
    observed by the candidate keyframe and its top covisible neighbors.
    Returns [budget] int32 point ids, P = padding."""
    K, N = m.kf_obs_point.shape
    P = m.pt_pos.shape[0]
    dev = m.pt_pos.device
    W = ms.covisibility(m)
    nb_w, nb_ids = topk_stable(W[cand], min(n_nb, K))
    kf_mask = torch.zeros(K, dtype=torch.bool, device=dev)
    kf_mask[nb_ids] = nb_w > 0
    kf_mask[cand] = True
    kf_mask = kf_mask & m.kf_valid
    obs_ok = (m.kf_obs_point >= 0) & m.kf_kp_valid & kf_mask[:, None]
    pmask = torch.zeros(P + 1, dtype=torch.bool, device=dev)
    pmask[torch.where(obs_ok, m.kf_obs_point.to(torch.int64), P).reshape(-1)] = True
    pmask = pmask[:P] & m.pt_valid
    ar = torch.arange(P, dtype=torch.float32, device=dev)
    key = torch.where(pmask, 2.0 * P - ar, -ar)
    topv, topi = topk_stable(key, min(budget, P))
    return torch.where(topv > 0, topi, P).to(torch.int32)


def project_loop_points(m: ms.MapState, slot, S_cur_w_corr, loop_ids, Kc,
                        n_levels: int = 8, scale: float = 1.2, height: int = 480,
                        width: int = 640, radius: float = 10.0):
    """SearchByProjection of the loop side's points into the current
    keyframe through the CORRECTED Sim3 pose. The scale in Scw cancels in
    the perspective divide.

    Returns match_kp [L] int64: keypoint idx in the current keyframe or -1."""
    P = m.pt_pos.shape[0]
    sf, _, _ = orb.scale_factors(n_levels, scale, m.pt_pos.device)
    pid = torch.clamp(loop_ids.to(torch.int64), 0, P - 1)
    ok = (loop_ids < P) & m.pt_valid[pid]
    pc = lie.sim3_apply(S_cur_w_corr, m.pt_pos[pid])
    uv, z = camera.project(Kc, pc)
    dist = torch.linalg.norm(pc, dim=-1)
    vis = (ok & (z > 0.05)
           & (uv[:, 0] >= 0) & (uv[:, 0] < width)
           & (uv[:, 1] >= 0) & (uv[:, 1] < height))
    # scale prediction from the (unscaled) distance band
    s = lie.sim3_scale(S_cur_w_corr)
    lvl = predict_scale(dist / torch.clamp(s, min=1e-9), m.pt_max_dist[pid],
                        scale, n_levels)
    mi, _ = matching.match_by_projection(
        proj_uv=uv, proj_valid=vis, pred_level=lvl,
        query_desc=m.pt_desc[pid], query_angle=None,
        feats_uv=m.kf_uv[slot], feats_level=m.kf_level[slot],
        feats_desc=m.kf_desc[slot], feats_angle=m.kf_angle[slot],
        feats_valid=m.kf_kp_valid[slot], radius=radius, scale_factors=sf,
        th=matching.TH_LOW, ratio=1.0,
    )
    return mi


def fuse_loop_points(m: ms.MapState, slot, loop_ids, Kc, n_group: int = 12,
                     n_levels: int = 8, scale: float = 1.2, height: int = 480,
                     width: int = 640):
    """SearchAndFuse with 'replace' semantics: project the loop side's map
    points into the corrected covisible group of the current keyframe;
    where the projection lands on a keypoint already holding a different
    point, the LOOP point always wins (the duplicate triangulated on the way
    back is merged away); free keypoints gain an observation.

    Call AFTER the essential-graph correction so group poses / points are
    in the corrected frame. Every group keyframe's search reads only the
    map, so all of them are one batched match; the fuse steps then run in
    order on the results. Returns (map, n_merged)."""
    K, N = m.kf_obs_point.shape
    P = m.pt_pos.shape[0]
    dev = m.pt_pos.device
    sf, _, _ = orb.scale_factors(n_levels, scale, dev)

    W = ms.covisibility(m)
    nb_w, nb_ids = topk_stable(W[slot], min(n_group, K))
    slot_t = torch.as_tensor(slot, device=dev).to(torch.int64).reshape(1)
    group = torch.cat([slot_t, nb_ids])                                   # [G]
    group_ok = torch.cat([torch.ones(1, dtype=torch.bool, device=dev), nb_w > 0]) \
        & m.kf_valid[group]
    G = group.shape[0]

    pid = torch.clamp(loop_ids.to(torch.int64), 0, P - 1)
    src_ok = (loop_ids < P) & m.pt_valid[pid]
    L = loop_ids.shape[0]

    pc = lie.se3_apply(m.kf_pose[group][:, None, :], m.pt_pos[pid])      # [G,L,3]
    uv, z = camera.project(Kc, pc)
    dist = torch.linalg.norm(pc, dim=-1)
    vis = (src_ok & group_ok[:, None] & (z > 0.05)
           & (uv[..., 0] >= 0) & (uv[..., 0] < width)
           & (uv[..., 1] >= 0) & (uv[..., 1] < height))
    lvl = predict_scale(dist, m.pt_max_dist[pid], scale, n_levels)
    mi, _ = matching.match_by_projection(
        proj_uv=uv, proj_valid=vis, pred_level=lvl,
        query_desc=m.pt_desc[pid].expand(G, L, 8), query_angle=None,
        feats_uv=m.kf_uv[group], feats_level=m.kf_level[group],
        feats_desc=m.kf_desc[group], feats_angle=m.kf_angle[group],
        feats_valid=m.kf_kp_valid[group], radius=4.0, scale_factors=sf,
        th=matching.TH_LOW, ratio=1.0,
    )                                                                     # [G,L]

    remap = torch.arange(P, device=dev)
    obs_flat = m.kf_obs_point.reshape(-1).to(torch.int64)
    for i in range(G):
        hit = mi[i] >= 0
        tgt = group[i] * N + torch.clamp(mi[i], 0, N - 1)
        existing = obs_flat[tgt]
        # free keypoint -> add an observation of the loop point
        obs_flat = ms.scatter_last(obs_flat, tgt, pid, hit & (existing < 0))
        # occupied by a different point -> the loop point replaces it
        dup = hit & (existing >= 0) & (existing != pid)
        remap = ms.scatter_last(remap, torch.clamp(existing, 0, P - 1), pid, dup)

    # resolve merge chains (a->b, b->c  =>  a->c) by pointer jumping
    for _ in range(3):
        remap = remap[remap]

    lost = remap != torch.arange(P, device=dev)
    obs = obs_flat.reshape(K, N)
    obs = torch.where(obs >= 0, remap[torch.clamp(obs, 0, P - 1)], obs)
    pt_valid = m.pt_valid & ~lost
    obs_ok2 = (obs >= 0) & pt_valid[torch.clamp(obs, 0, P - 1)]
    return m._replace(
        kf_obs_point=torch.where(obs_ok2, obs, -1).to(torch.int32), pt_valid=pt_valid
    ), torch.sum(lost.to(torch.int32))


def score_database(bow_mat, query_bow, kf_valid):
    """L1 similarity of the query against every keyframe's BoW vector +
    common-word counts (the DetectLoopCandidates word pass)."""
    scores = 1.0 - 0.5 * torch.sum(torch.abs(bow_mat - query_bow[None, :]), dim=-1)
    common = torch.sum((bow_mat > 0) & (query_bow > 0)[None, :], dim=-1, dtype=torch.int32)
    return torch.where(kf_valid, scores, -1.0), torch.where(kf_valid, common, 0)


def _accumulate_covis_groups(scores, cand, W, retain: float = 0.75):
    """Covisibility-group score accumulation shared by loop detection and
    relocalization: each candidate's similarity score is summed over the
    candidates inside its top-10 covisible group; groups within ``retain``
    of the best accumulated score contribute their best-scoring member."""
    is_cand = np.zeros(len(scores), bool)
    is_cand[cand] = True
    groups = []
    for c in cand:
        nb = np.argsort(-W[c])[:10]
        members = np.concatenate([[c], nb[W[c][nb] > 0]])
        memb = members[is_cand[members]]
        acc = float(scores[memb].sum())
        best = int(memb[np.argmax(scores[memb])])
        groups.append((acc, best))
    best_acc = max(a for a, _ in groups)
    return {b for a, b in groups if a >= retain * best_acc}


# above this vocabulary size, per-keyframe sparse BoW lists replace the
# dense [K, V] matrix (the standard ORBvoc has 1M words)
SPARSE_WORDS_THRESHOLD = 65536


def _set_row(a, slot, row):
    """``a`` with row ``slot`` replaced: a new tensor, the old one untouched."""
    out = a.clone()
    out[slot] = row.to(a.dtype)
    return out


def _db_update_sparse(kf_wid, kf_wval, words, wid, wval, word, slot):
    return _set_row(kf_wid, slot, wid), _set_row(kf_wval, slot, wval), \
        _set_row(words, slot, word)


def _db_update_dense(bow, words, bv, word, slot):
    return _set_row(bow, slot, bv), _set_row(words, slot, word)


def _detect_prep_sparse(m, kf_wid, kf_wval, words, idf, slot):
    W = ms.covisibility(m)
    q_wid, q_wval = vocab.sparse_bow(words[slot], idf)
    scores, common = vocab.sparse_l1_scores(kf_wid, kf_wval, q_wid, q_wval, m.kf_valid)
    return W, scores, common


def _detect_prep_dense(m, bow, words, idf, slot, n_words: int):
    W = ms.covisibility(m)
    qbow = vocab.bow_vector(words[slot], n_words, idf)
    scores, common = score_database(bow, qbow, m.kf_valid)
    return W, scores, common


def _sim3_geometry(m: ms.MapState, words, slot, cand, Kc, n_levels: int = 8,
                   scale: float = 1.2, height: int = 480, width: int = 640,
                   fix_scale: bool = False, sel=None, generator=None):
    """ComputeSim3's geometric chain with no host read: descriptor pairing,
    Horn RANSAC, Sim3 LM, and the corrected-projection expansion gate.
    Returns (gates[4] = [n_pairs, n_ransac, n_lm, n_total], S_cur_w_corr,
    loop_ids); the host reads the 4 gate counts in one fetch. ``sel``:
    optional [n_hyp, 3] RANSAC minimal sets. ``words`` is unused: pairing is
    dense (see below)."""
    N = m.kf_obs_point.shape[1]
    P = m.pt_pos.shape[0]
    dev = m.pt_pos.device
    _, sigma2_tab, _ = orb.scale_factors(n_levels, scale, dev)

    # 1. descriptor pairing between the two keyframes (>= 20). Bucketing
    # pairs by vocabulary word is a CPU pruning heuristic; exact leaf-word
    # equality starves the gate on true loops, and the dense mutual-best
    # Hamming search costs the same as any bucketing here, so pair densely.
    with tracing.span("lc.mutual_match", dev):
        mi, _ = matching.mutual_match(
            m.kf_desc[slot], m.kf_kp_valid[slot],
            m.kf_desc[cand], m.kf_kp_valid[cand],
            th=matching.TH_LOW, ratio=0.75,
        )
    mic = torch.clamp(mi, 0, N - 1)
    p_cur = m.kf_obs_point[slot].to(torch.int64)
    p_cnd = m.kf_obs_point[cand][mic].to(torch.int64)
    pair_ok = (mi >= 0) & (p_cur >= 0) & (p_cnd >= 0)
    n_pairs = torch.sum(pair_ok)

    T_cnd = m.kf_pose[cand]
    p2 = lie.se3_apply(m.kf_pose[slot], m.pt_pos[torch.clamp(p_cur, 0, P - 1)])
    p1 = lie.se3_apply(T_cnd, m.pt_pos[torch.clamp(p_cnd, 0, P - 1)])
    uv2 = m.kf_uv[slot]
    uv1 = m.kf_uv[cand][mic]
    s2_2 = sigma2_tab[torch.clamp(m.kf_level[slot].to(torch.int64), 0, n_levels - 1)]
    s2_1 = sigma2_tab[torch.clamp(m.kf_level[cand][mic].to(torch.int64), 0, n_levels - 1)]

    # 2. Horn RANSAC: S maps candidate-camera -> current-camera (stereo /
    #    RGB-D fix the scale)
    with tracing.span("lc.ransac_sim3", dev):
        S, inl, n_ransac = sim3solver.ransac_sim3(
            p1, p2, pair_ok, Kc, Kc, uv1, uv2, s2_1, s2_2, sel=sel,
            generator=generator, fix_scale=fix_scale,
        )
    # 3. LM polish (>= 20 inliers)
    with tracing.span("lc.optimize_sim3", dev):
        S, inl, n_lm = sim3solver.optimize_sim3(
            S, p1, p2, pair_ok & inl, Kc, Kc, uv1, uv2,
            1.0 / torch.clamp(s2_1, min=1e-9), 1.0 / torch.clamp(s2_2, min=1e-9),
            fix_scale=fix_scale,
        )

    # 4. corrected current pose: S_cur_w = S_cur_cand * S_cand_w
    S_cur_w_corr = lie.sim3_compose(S, lie.sim3_from_se3(T_cnd))

    # 5. loop-point expansion gate
    with tracing.span("lc.project_loop_points", dev):
        loop_ids = gather_loop_points(m, cand)
        proj_kp = project_loop_points(
            m, slot, S_cur_w_corr, loop_ids, Kc,
            n_levels=n_levels, scale=scale, height=height, width=width,
        )
    matched_kp = torch.zeros(N + 1, dtype=torch.bool, device=dev)
    matched_kp[torch.where(proj_kp >= 0, proj_kp, N)] = True
    matched_kp = matched_kp[:N] | (pair_ok & inl)
    n_total = torch.sum(matched_kp)

    gates = torch.stack([n_pairs, n_ransac.to(torch.int64), n_lm.to(torch.int64),
                         n_total]).to(torch.int32)
    return gates, S_cur_w_corr, loop_ids


def _graph_arrays(m, slot, cand, S_cur_w_corr, group_mask, ei, ej, is_loop):
    """Sim3 lift + covisible-group propagation + edge measurements (the
    Sim3 propagation of CorrectLoop and the edge measurements of
    OptimizeEssentialGraph)."""
    T_cur = m.kf_pose[slot]
    S_old = lie.sim3_from_se3(m.kf_pose)  # [K,8]
    T_g_cur = lie.se3_compose(m.kf_pose, lie.se3_inverse(T_cur))
    S_g = lie.sim3_compose(lie.sim3_from_se3(T_g_cur), S_cur_w_corr)
    S_new_init = torch.where(group_mask[:, None], S_g, S_old)
    # measurements from pre-correction poses, except the loop edge, which
    # uses the Sim3-corrected relative
    meas = lie.sim3_compose(S_old[ej], lie.sim3_inverse(S_old[ei]))
    loop_meas = lie.sim3_compose(
        lie.sim3_from_se3(m.kf_pose[cand]), lie.sim3_inverse(S_cur_w_corr)
    )
    meas = torch.where(is_loop[:, None], loop_meas[None, :], meas)
    return S_old, S_new_init, meas


def _apply_graph(m, S_old, S_opt):
    """Post-solve writeback: remap points through their first-observing
    keyframe's correction, p' = S_new^-1(S_old(p)), and store the optimized
    keyframe poses."""
    K = m.kf_valid.shape[0]
    ref = torch.clamp(m.pt_first_kf.to(torch.int64), 0, K - 1)
    p_corr = lie.sim3_apply(lie.sim3_inverse(S_opt[ref]), lie.sim3_apply(S_old[ref], m.pt_pos))
    pt_pos = torch.where(m.pt_valid[:, None], p_corr, m.pt_pos)
    kf_pose = torch.where(m.kf_valid[:, None], lie.sim3_to_se3(S_opt), m.kf_pose)
    return m._replace(kf_pose=kf_pose, pt_pos=pt_pos)


def _debug_loops() -> bool:
    return bool(os.environ.get("ORB_DEBUG_LOOPS"))


class LoopCloser:
    """Host orchestrator for detection + correction."""

    def __init__(self, voc, map_cfg: ms.MapConfig):
        """voc: a trained :class:`vocab.Vocabulary` or a
        :class:`vocab.TreeVocabulary` loaded from the DBoW2 text format, on
        the map's device. Large vocabularies (> 2^16 words) use sparse
        per-keyframe BoW lists instead of a dense [K, V] matrix."""
        self.voc = voc
        K, N = map_cfg.max_keyframes, map_cfg.n_features
        dev = torch.device(map_cfg.device)
        self.device = dev
        self.sparse = voc.n_words > SPARSE_WORDS_THRESHOLD
        self.bow = self.kf_wid = self.kf_wval = None
        if self.sparse:
            self.kf_wid = torch.full((K, N), -1, dtype=torch.int32, device=dev)
            self.kf_wval = torch.zeros((K, N), dtype=torch.float32, device=dev)
        else:
            self.bow = torch.zeros((K, voc.n_words), dtype=torch.float32, device=dev)
        self.words = torch.full((K, N), -1, dtype=torch.int32, device=dev)
        self.consistency: list[tuple[set, int]] = []  # (group KFs, count)
        self.covis_th = 3  # consecutive consistent detections required
        self.last_loop_kf = -999
        # persistent loop edges, re-used by every later essential-graph
        # solve: a second closure must not undo the first
        self.loop_edges: list[tuple[int, int]] = []

    def grow(self, new_K: int):
        """Extend the per-keyframe database rows after the map's keyframe
        pool grows (``map_state.grow_map`` preserves slot ids)."""
        K_old = self.words.shape[0]
        if new_K <= K_old:
            return

        def pad(a, fill):
            ext = torch.full((new_K - K_old,) + tuple(a.shape[1:]), fill,
                             dtype=a.dtype, device=a.device)
            return torch.cat([a, ext])

        if self.sparse:
            self.kf_wid = pad(self.kf_wid, -1)
            self.kf_wval = pad(self.kf_wval, 0.0)
        else:
            self.bow = pad(self.bow, 0.0)
        self.words = pad(self.words, -1)

    def permute(self, perm):
        """Reorder the database rows after a keyframe compaction: new row r
        holds old row ``perm[r]``."""
        perm = perm.to(torch.int64)
        self.words = self.words[perm]
        if self.sparse:
            self.kf_wid = self.kf_wid[perm]
            self.kf_wval = self.kf_wval[perm]
        else:
            self.bow = self.bow[perm]

    def add_keyframe_from_map(self, m: ms.MapState, slot: int):
        """Index a keyframe straight from the map."""
        self.add_keyframe(slot, m.kf_desc[slot], m.kf_kp_valid[slot])

    def add_keyframe(self, slot: int, desc, valid):
        with tracing.span("lc.add_keyframe", self.device) as sp:
            sp.count(slot=int(slot))
            word, _ = vocab.transform_any(self.voc, desc, valid)
            if self.sparse:
                wid, wval = vocab.sparse_bow(word, self.voc.idf)
                self.kf_wid, self.kf_wval, self.words = _db_update_sparse(
                    self.kf_wid, self.kf_wval, self.words, wid, wval, word, slot
                )
            else:
                bv = vocab.bow_vector(word, self.voc.n_words, self.voc.idf)
                self.bow, self.words = _db_update_dense(self.bow, self.words, bv, word, slot)

    def score_query(self, word, kf_valid):
        """Database similarity of one frame's word ids against every
        keyframe."""
        if self.sparse:
            qw, qv = vocab.sparse_bow(word, self.voc.idf)
            return vocab.sparse_l1_scores(self.kf_wid, self.kf_wval, qw, qv, kf_valid)
        qbow = vocab.bow_vector(word, self.voc.n_words, self.voc.idf)
        return score_database(self.bow, qbow, kf_valid)

    def detect_reloc_candidates(self, m: ms.MapState, word, max_groups: int = 5) -> list[int]:
        """DetectRelocalizationCandidates: keyframes sharing words with the
        lost frame, gated at 0.8x the max common-word count, then each
        candidate's similarity score is ACCUMULATED over its top-10
        covisible group; groups within 0.75 of the best accumulated score
        return their best-scoring member. Unlike loop detection there is no
        minimum-score floor (the lost frame has no covisible neighborhood
        to derive one from)."""
        scores, common = self.score_query(word, m.kf_valid)
        scores = scores.cpu().numpy()
        common = common.cpu().numpy()
        if common.max(initial=0) <= 0:
            return []
        min_common = 0.8 * float(common.max())
        cand = np.where((common > min_common) & (scores > 0))[0]
        if len(cand) == 0:
            return []
        W = ms.covisibility(m).cpu().numpy()
        keep = _accumulate_covis_groups(scores, cand, W)
        return sorted(keep, key=lambda k: -scores[k])[:max_groups]

    def prepare_detect(self, m: ms.MapState, slot: int, n_live: int):
        """Queue the device work DetectLoop needs (database scores +
        covisibility) and start its copy to the host, without blocking. The
        caller holds the returned handle and passes it to
        :meth:`finish_detect` later (System consumes it at the NEXT
        keyframe). Returns None when detection is structurally skipped."""
        if n_live < 8 or slot - self.last_loop_kf < 10:
            return None
        with tracing.span("lc.detect_prepare", self.device) as sp:
            sp.count(slot=int(slot))
            if self.sparse:
                W, scores, common = _detect_prep_sparse(
                    m, self.kf_wid, self.kf_wval, self.words, self.voc.idf, slot)
            else:
                W, scores, common = _detect_prep_dense(
                    m, self.bow, self.words, self.voc.idf, slot, self.voc.n_words)
        return (slot, ms.HostCopy(W), ms.HostCopy(scores), ms.HostCopy(common))

    def finish_detect(self, prep) -> list[int]:
        """Host half of DetectLoop: score gates + covisibility-group
        accumulation + the 3-consecutive-keyframe consistency check, on
        the prefetched arrays."""
        if prep is None:
            return []
        slot, W, scores, common = prep
        with tracing.span("lc.detect_finish") as sp:  # host work alone
            sp.count(slot=int(slot))
            return self._detect_host(slot, W.numpy(), scores.numpy(), common.numpy())

    def detect(self, m: ms.MapState, slot: int) -> list[int]:
        """DetectLoop: query the database, gate by min covisible score,
        0.8*max common words, and temporal consistency over 3 consecutive
        keyframes. Synchronous wrapper over prepare_detect / finish_detect."""
        # live keyframes, not the insertion high-water mark: culling keeps
        # the live count far below the counter
        n_live = int(m.kf_valid.sum())
        return self.finish_detect(self.prepare_detect(m, slot, n_live))

    def _detect_host(self, slot: int, W, scores, common) -> list[int]:
        if _debug_loops():
            def _log(msg):
                print(f"[detect] slot={slot} {msg}", file=sys.stderr, flush=True)
        else:
            def _log(msg):
                return None
        return self._detect_host_inner(slot, W, scores, common, _log)

    def _detect_host_inner(self, slot, W, scores, common, _log):
        # the covisible set is the *connected graph* (weight >= 15): weakly
        # re-observed places must stay eligible as loop candidates
        covis = W[slot] >= 15
        # min score among covisible neighbors
        nb = np.where(covis & (np.arange(len(covis)) != slot))[0]
        # no >= 15-weight neighbor: minScore stays at its initial 1.0,
        # making candidates require a perfect score
        min_score = float(scores[nb].min()) if len(nb) else 1.0
        # candidates: not covisible, above the covisible-score floor
        cand_mask = (
            (~covis)
            & (np.arange(len(scores)) != slot)
            & (scores >= max(min_score, 0.0))
        )
        if not cand_mask.any():
            _log(f"no candidates above min_score={min_score:.3f} "
                 f"(covis={int(covis.sum())})")
            self.consistency = []
            return []
        max_common = common[cand_mask].max()
        cand_mask &= common > 0.8 * max_common
        cands = np.where(cand_mask)[0]
        if len(cands) == 0:
            _log("all candidates below 0.8*max_common")
            self.consistency = []
            return []

        # covisibility-group score accumulation with 0.75-of-best
        # retention: a lone weak candidate is rejected unless its covisible
        # group collectively scores within 0.75x of the best group; each
        # kept group contributes its best-scoring member
        cands = np.asarray(
            sorted(_accumulate_covis_groups(scores, cands, W)), dtype=np.int64
        )
        if len(cands) == 0:
            _log("group accumulation emptied the candidate set")
            self.consistency = []
            return []

        # consistency groups
        consistent_enough = []
        new_groups = []
        for c in cands:
            group = set(np.where(W[c] >= 15)[0].tolist()) | {int(c)}
            best = 0
            for prev_group, cnt in self.consistency:
                if group & prev_group:
                    best = max(best, cnt + 1)
            new_groups.append((group, best))
            if best >= self.covis_th:
                consistent_enough.append(int(c))
        _log(f"cands={[int(c) for c in cands]} consistency="
             f"{[b for _, b in new_groups]} -> {consistent_enough}")
        self.consistency = new_groups
        return consistent_enough

    def attempt_close(self, m: ms.MapState, slot: int, cand: int, Kc, n_levels=8,
                      scale=1.2, height=480, width=640, fix_scale: bool = False,
                      sel=None, generator=None):
        """ComputeSim3 + CorrectLoop.

        Returns (new_map, ok). On success keyframe poses are pose-graph
        corrected, points remapped, and duplicated landmarks from the
        revisited place fused into the loop side's originals.

        The whole geometric verification chain (pairing -> Sim3 RANSAC ->
        LM polish -> corrected-projection gate) is queued without a host
        read; the four gate counts come back in a single fetch. ``sel``:
        optional RANSAC minimal sets handed to ``ransac_sim3``."""
        dev = m.pt_pos.device
        with tracing.span("lc.attempt_close", dev) as sp:
            sp.count(slot=int(slot), cand=int(cand))
            with tracing.span("lc.sim3_geometry", dev):
                gates, S_cur_w_corr, loop_ids = _sim3_geometry(
                    m, self.words, slot, cand, Kc, n_levels=n_levels, scale=scale,
                    height=height, width=width, fix_scale=fix_scale, sel=sel,
                    generator=generator,
                )
            # [n_pairs, n_ransac_inl, n_lm_inl, n_total, sim3 scale]: the
            # staged >= 20 / >= 20 / >= 20 / >= 40 gates, one host fetch
            fetched = torch.cat([gates.to(torch.float32), S_cur_w_corr[7:8]]).cpu().numpy()
            g = fetched[:4].astype(np.int64)
            ok = not (g[0] < 20 or g[1] < 20 or g[2] < 20 or g[3] < 40)
            sp.count(gates=g.tolist(), sim3_scale=float(fetched[4]), closed=ok)
            if not ok:
                if _debug_loops():
                    print(f"[loop-rej] slot={slot} cand={cand} gates={g.tolist()}",
                          file=sys.stderr, flush=True)
                return m, False
            if _debug_loops():
                print(f"[loop] slot={slot} cand={cand} gates={g.tolist()} "
                      f"sim3_scale={float(fetched[4]):.4f}", file=sys.stderr, flush=True)

            m = self._correct_graph(m, slot, cand, S_cur_w_corr)
            # SearchAndFuse: merge the duplicated landmarks of the revisited
            # place into the loop side's originals
            with tracing.span("lc.fuse_loop_points", dev):
                m, _ = fuse_loop_points(
                    m, slot, loop_ids, Kc,
                    n_levels=n_levels, scale=scale, height=height, width=width,
                )
            self.loop_edges.append((int(slot), int(cand)))
            self.last_loop_kf = slot
            return m, True

    def _correct_graph(self, m: ms.MapState, slot, cand, S_cur_w_corr):
        """Sim3 propagation + essential-graph optimization + point remap
        (CorrectLoop + OptimizeEssentialGraph); traced as
        ``lc.correct_graph`` (``n_edges``).

        Host work is ONE fetch (covisibility, validity, parents) and
        vectorized numpy edge assembly; the rest runs on the device."""
        K = m.kf_valid.shape[0]
        dev = m.pt_pos.device
        with tracing.span("lc.correct_graph", dev) as sp:
            host = torch.cat([ms.covisibility(m), m.kf_valid[None].to(torch.int32),
                              m.kf_parent[None]]).cpu().numpy()
            W, kf_valid, parents = host[:K], host[K] > 0, host[K + 1]

            group_mask = (W[slot] > 0) & kf_valid
            group_mask[slot] = True

            # --- edges: spanning tree + strong covisibility + loop edges ---
            ks = np.where(kf_valid)[0]
            pk = parents[ks]
            tree_ok = (pk >= 0) & kf_valid[np.clip(pk, 0, K - 1)]
            ei = [ks[tree_ok]]
            ej = [pk[tree_ok]]
            w = [np.ones(int(tree_ok.sum()), np.float32)]
            cov_i, cov_j = np.where(
                np.triu(W >= 100, 1) & kf_valid[:, None] & kf_valid[None, :]
            )
            ei.append(cov_i)
            ej.append(cov_j)
            w.append(np.ones(len(cov_i), np.float32))
            # previously closed loops stay as constraints so a later closure
            # cannot re-open them; their measurements come from the CURRENT
            # (already corrected) poses, which satisfy those loops
            prev = [(pi, pj) for pi, pj in self.loop_edges if kf_valid[pi] and kf_valid[pj]]
            if prev:
                pi, pj = np.asarray(prev, np.int64).T
                ei.append(pi)
                ej.append(pj)
                w.append(np.full(len(prev), 5.0, np.float32))
            ei.append(np.asarray([slot]))
            ej.append(np.asarray([cand]))
            w.append(np.asarray([5.0], np.float32))  # the new loop edge
            ei = torch.as_tensor(np.concatenate(ei).astype(np.int64), device=dev)
            ej = torch.as_tensor(np.concatenate(ej).astype(np.int64), device=dev)
            w = torch.as_tensor(np.concatenate(w), device=dev)
            is_loop = torch.zeros(ei.shape[0], dtype=torch.bool, device=dev)
            is_loop[-1] = True

            S_old, S_new_init, meas = _graph_arrays(
                m, slot, cand, S_cur_w_corr, torch.as_tensor(group_mask, device=dev),
                ei, ej, is_loop,
            )
            fixed = torch.zeros(K, dtype=torch.float32, device=dev)
            fixed[cand] = 1.0
            sp.count(n_edges=int(ei.shape[0]))
            with tracing.span("lc.optimize_pose_graph", dev):
                S_opt = pose_graph.optimize_pose_graph(S_new_init, ei, ej, meas, w, fixed)
            return _apply_graph(m, S_old, S_opt)


def loop_closer_state_from_numpy(lcs: LoopCloser, src) -> LoopCloser:
    """Fill ``lcs`` (built on the port's vocabulary and map config) with a
    database built elsewhere: ``src`` is any object with ``words``, ``bow``
    or ``kf_wid`` / ``kf_wval``, ``loop_edges``, ``last_loop_kf`` and
    ``consistency`` holding array-likes and plain Python values."""
    dev = lcs.device

    def t(a, dtype):
        return torch.as_tensor(np.array(np.asarray(a)), device=dev).to(dtype)

    lcs.words = t(src.words, torch.int32)
    if lcs.sparse:
        lcs.kf_wid = t(src.kf_wid, torch.int32)
        lcs.kf_wval = t(src.kf_wval, torch.float32)
    else:
        lcs.bow = t(src.bow, torch.float32)
    lcs.loop_edges = [(int(i), int(j)) for i, j in src.loop_edges]
    lcs.last_loop_kf = int(src.last_loop_kf)
    lcs.consistency = [({int(x) for x in g}, int(c)) for g, c in src.consistency]
    return lcs
