"""Loop closing: detection, Sim3 verification, loop correction, global BA.

JAX redesign of `LoopClosing` (/root/reference/src/backend/LoopClosing.cc):
  * `DetectLoop` (:152-366) — BoW candidates above the min covisible score,
    with covisibility-consistency >= 3 across successive keyframes;
  * `ComputeSim3` (:367-626) — per-candidate Sim3 RANSAC (scale fixed for
    stereo/RGBD :433), `optimize_sim3` refinement (>= 20 inliers :513),
    guided reprojection matching, accept at >= 40 total matches;
  * `ComputeSim3` guided growth — `SearchBySim3` mutual reprojection
    agreement (ORBmatcher.cc:1448) + `SearchByProjection` of the loop
    landmark group under the corrected pose (:597), both as batched
    window-masked Hamming matches;
  * `CorrectLoop` (:627-894) — propagate the corrected Sim3 through the
    current KF's covisibility group AND its landmarks as one batched
    transform, `SearchAndFuse` duplicate landmarks (:895-935), add the loop
    edge + fusion-created LoopConnections, run `OptimizeEssentialGraph`,
    then global BA (:978-1118).

The reference runs this on a dedicated thread with a keyframe queue and
stop/abort protocols against LocalMapping/GBA; here the pipeline is
sequential (deterministic), so the mutex/abort machinery disappears —
the loop correction is a pure array transform on the map snapshot.
"""

from __future__ import annotations

import functools
import threading
from typing import List, NamedTuple, Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..factors.reprojection import Camera
from ..frontend import matching, vocab
from ..geometry import se3, sim3
from ..mapstore import MapStore
from ..optim import schur, schur_bucketed
from . import essential_graph, sim3_solver
from .database import KeyFrameDatabase


class LoopClosingConfig(NamedTuple):
    consistency_threshold: int = 3  # mnCovisibilityConsistencyTh (LoopClosing.cc)
    min_ransac_inliers: int = 20  # OptimizeSim3 acceptance (:513)
    min_total_matches: int = 40  # final acceptance (:560-626)
    fix_scale: bool = True  # stereo/RGBD/fusion => 6-DoF (:433)
    kf_gap: int = 10  # ignore loops to the last 10 KFs (:168)
    covis_edge_weight: int = 100  # essential-graph strong covis edges
    essential_iters: int = 20
    gba_iters: int = 20
    match_cap: int = 512  # fixed capacity of the 3D-3D match buffer
    edge_cap: int = 8192  # essential-graph edge capacity
    run_gba: bool = True
    loop_points_cap: int = 4096  # mvpLoopMapPoints capacity (LoopClosing.cc:554-580)
    sim3_search_radius: float = 7.5  # SearchBySim3 window (ORBmatcher.cc:1448)
    proj_search_radius: float = 10.0  # SearchByProjection th (LoopClosing.cc:597)
    fuse_radius: float = 4.0  # SearchAndFuse Fuse th (LoopClosing.cc:915)
    gba_chunk: int = 5  # LM iterations per dispatch between abort checks
    # Poisoned-constraint gates (round 5). A Sim3 candidate can clear every
    # match-count gate (LoopClosing.cc:367-626) and still be geometrically
    # wrong (aliased place recognition) — the r4 soak had one slip through
    # and seed a divergent GBA. Two checks upstream of the map:
    #  (a) drift plausibility, PRE-mutation: the correction the loop edge
    #      implies on the current pose must be explainable as accumulated
    #      odometry drift over the chain between the two keyframes;
    #  (b) observation-tear veto, POST-essential-graph: if the warp +
    #      SearchAndFuse merges tore the current group's landmark/
    #      observation geometry apart, roll the whole correction back.
    max_loop_rot: float = 0.6  # rad; max plausible heading drift
    drift_frac: float = 0.25  # max translation correction per chain metre
    min_drift_allow: float = 3.0  # m; always allow this much correction
    max_loop_scale_log: float = 0.35  # |log s| cap when scale is free
    max_loop_bad_obs_frac: float = 0.4  # group-observation tear veto


class LoopMatches(NamedTuple):
    """Accepted-loop evidence carried from ComputeSim3 to CorrectLoop: the
    loop-side landmark group (mvpLoopMapPoints) and their matched keypoints
    in the current KF (mvpCurrentMatchedPoints, LoopClosing.cc:554-605)."""

    loop_lms: np.ndarray  # (M,) landmark ids around the loop KF
    cur_kp: np.ndarray  # (M,) matched keypoint index in the current KF
    cur_valid: np.ndarray  # (M,) bool
    n_total: int  # distinct current-KF keypoints matched to loop landmarks


@functools.partial(jax.jit, static_argnames=("cam",))
def _project_match_kernel(
    cam: Camera,
    s, R, t,  # Sim3 S_cw of the target keyframe (world -> camera)
    lm_pos, lm_desc, lm_valid, lm_normal, lm_mind, lm_maxd,
    kp_xy, kp_desc, kp_octave, kp_valid,
    radius,
):
    """Project world landmarks into one KF and descriptor-match in windows.

    Batched form of `ORBmatcher::SearchByProjection(KF, Scw, ...)` /
    `ORBmatcher::Fuse(KF, Scw, ...)` (/root/reference/src/frontend/
    ORBmatcher.cc:1109-1447): depth-range + viewing-angle gates, scale level
    predicted from distance, per-landmark search radius, Hamming best match.
    One fused XLA computation per keyframe instead of per-point grid walks.
    """
    S = sim3.Sim3(s, R, t)
    x_c = sim3.act(S, lm_pos)
    front = x_c[..., 2] > 0.05
    uv = cam.project(x_c)

    # Camera center in world: solve 0 = s R c + t.
    center = -(R.T @ t) / jnp.maximum(s, 1e-9)
    po = lm_pos - center[None, :]
    dist = jnp.linalg.norm(po, axis=-1)
    d_ok = (dist >= 0.8 * lm_mind) & (dist <= 1.3 * jnp.minimum(lm_maxd, 1e6))
    nrm = lm_normal / jnp.maximum(
        jnp.linalg.norm(lm_normal, axis=-1, keepdims=True), 1e-9
    )
    view_ok = jnp.sum(po * nrm, axis=-1) > 0.5 * dist  # < 60 deg view angle

    # Predicted pyramid level from distance (MapPoint::PredictScale).
    ratio = jnp.maximum(lm_maxd, 1e-6) / jnp.maximum(dist, 1e-6)
    octv = jnp.clip(
        jnp.ceil(jnp.log(ratio) / jnp.log(1.2)), 0, 7
    ).astype(jnp.int32)
    rad = radius * 1.2 ** octv.astype(jnp.float32)
    window = matching.projection_window_mask(
        uv, kp_xy, rad, octave_pred=octv, octave_kp=kp_octave, level_slack=1
    )
    res = matching.match_descriptors(
        lm_desc, kp_desc,
        lm_valid & front & d_ok & view_ok, kp_valid,
        window_mask=window, max_dist=matching.TH_LOW, mutual=True,
    )
    return res.idx, res.valid


@functools.partial(jax.jit, static_argnames=("cam",))
def _guided_sim3_kernel(
    cam: Camera,
    s, R, t,  # S12: KF2-camera -> KF1-camera
    x1, v1, desc1, xy1, oct1,
    x2, v2, desc2, xy2, oct2,
    radius,
):
    """SearchBySim3 (/root/reference/src/frontend/ORBmatcher.cc:1448): grow
    KF1<->KF2 landmark matches by mutual guided reprojection through S12/S21,
    keeping only agreements. x1/x2 are keypoint-aligned landmark positions in
    each KF's own camera frame; both match matrices run as one batched
    Hamming computation."""
    S12 = sim3.Sim3(s, R, t)
    S21 = sim3.inverse(S12)
    x1_in_2 = sim3.act(S21, x1)
    x2_in_1 = sim3.act(S12, x2)
    uv2_pred = cam.project(x1_in_2)  # KF1 points into KF2's image
    uv1_pred = cam.project(x2_in_1)

    radA = radius * 1.2 ** oct1.astype(jnp.float32)
    winA = matching.projection_window_mask(uv2_pred, xy2, radA)
    resA = matching.match_descriptors(
        desc1, desc2, v1 & (x1_in_2[..., 2] > 0.05), v2,
        window_mask=winA, max_dist=matching.TH_HIGH, mutual=False,
    )
    radB = radius * 1.2 ** oct2.astype(jnp.float32)
    winB = matching.projection_window_mask(uv1_pred, xy1, radB)
    resB = matching.match_descriptors(
        desc2, desc1, v2 & (x2_in_1[..., 2] > 0.05), v1,
        window_mask=winB, max_dist=matching.TH_HIGH, mutual=False,
    )
    # Agreement check ("CheckAgreement", ORBmatcher.cc:1590-1600).
    iA = jnp.arange(x1.shape[0])
    agree = resA.valid & resB.valid[resA.idx] & (resB.idx[resA.idx] == iA)
    return resA.idx, agree


class LoopCloser:
    """Sequential loop-closing driver over the SoA map store."""

    def __init__(
        self,
        store: MapStore,
        cam: Camera,
        voc: Optional[vocab.Vocabulary] = None,
        cfg: LoopClosingConfig = LoopClosingConfig(),
    ):
        self.store = store
        self.cam = cam
        self.voc = voc
        self.cfg = cfg
        self.db = KeyFrameDatabase(store)
        self.last_loop_kf = -1
        # Consistency groups: list of (set_of_kfs, consistency_count).
        self.consistent_groups: List = []
        self.num_loops_closed = 0
        self.num_loops_rejected = 0  # vetoed by the poisoned-constraint gates
        self.last_fused = 0  # landmarks merged by the last SearchAndFuse
        self.last_reject = None  # (stage, count) of the last ComputeSim3 gate
        self.last_loop_veto = None  # (gate, value) of the last CorrectLoop veto
        self._key = jax.random.PRNGKey(0)
        # Interruptible-GBA protocol (the reference's mbStopGBA/mnFullBAIdx,
        # LoopClosing.cc:649-660): CorrectLoop bumps the generation, a
        # running GBA observes the change between iteration chunks and
        # abandons its stale result before write-back.
        self.gba_generation = 0
        self.map_lock = threading.RLock()  # replaced by the system lock in async mode
        self.async_gba = False
        self._gba_thread: Optional[threading.Thread] = None
        self._gba_tick = lambda: None  # test hook, called between chunks
        self.num_gba_completed = 0
        self.num_gba_aborted = 0

    # ------------------------------------------------------------------
    # Detection
    # ------------------------------------------------------------------

    def insert_keyframe(self, kf: int) -> bool:
        """Process one keyframe; returns True if a loop was closed."""
        cand = self.detect_loop(kf)
        for c in cand:
            ok, S12, matches = self.compute_sim3(kf, c)
            if ok and self.correct_loop(kf, c, S12, matches):
                return True
        return False

    def _fuse_point(self, lm: int, kf: int, kp: int):
        """Merge one projected loop landmark into (kf, kp): replace a
        conflicting landmark by the loop-side one (trusted: it has survived
        more optimization, LoopClosing.cc:888-935) or add the observation."""
        store = self.store
        if not store.lm_valid[lm]:
            return 0
        existing = int(store.kf_obs_lm[kf, kp])
        if existing == lm:
            return 0
        if existing >= 0 and store.lm_valid[existing]:
            store.replace_landmark(existing, lm)
            return 1
        store.add_observation(lm, kf, kp)
        return 0

    def detect_loop(self, kf: int) -> List[int]:
        """BoW candidates + covisibility-consistency >= 3 (LoopClosing.cc:152-366)."""
        store, cfg = self.store, self.cfg
        if kf < cfg.kf_gap or kf - self.last_loop_kf < cfg.kf_gap:
            return []
        min_score = self.db.min_covisible_score(kf)
        candidates = self.db.detect_loop_candidates(kf, min_score)
        if not candidates:
            self.consistent_groups = []
            return []

        enough: List[int] = []
        new_groups = []
        for c in candidates:
            group = {c} | {int(x) for x in store.best_covisible(c, 10)}
            count = 0
            for prev_group, prev_count in self.consistent_groups:
                if group & prev_group:
                    count = max(count, prev_count + 1)
            new_groups.append((group, count))
            if count >= cfg.consistency_threshold:
                enough.append(c)
        self.consistent_groups = new_groups
        return enough

    # ------------------------------------------------------------------
    # Sim3 verification
    # ------------------------------------------------------------------

    def _matched_pairs(self, kf1: int, kf2: int):
        """BoW-gated descriptor match between the two KFs' landmark features.

        Returns per-match landmark ids (lm1, lm2) and keypoint info — the
        3D-3D correspondences fed to the Sim3 solver (ComputeSim3 inputs)."""
        store, cfg = self.store, self.cfg
        d1 = jnp.asarray(store.kf_desc[kf1])
        d2 = jnp.asarray(store.kf_desc[kf2])
        has_lm1 = store.kf_obs_lm[kf1] >= 0
        has_lm2 = store.kf_obs_lm[kf2] >= 0
        v1 = jnp.asarray(store.kf_kp_valid[kf1] & has_lm1)
        v2 = jnp.asarray(store.kf_kp_valid[kf2] & has_lm2)
        w1 = store.kf_words[kf1]
        w2 = store.kf_words[kf2]
        wmask = None
        if (w1 >= 0).any() and (w2 >= 0).any():
            # Deep vocabularies gate on ancestor nodes (DBoW2 direct-index
            # level) so the candidate sets keep ~10^3-node granularity.
            lvl_up = max(0, self.voc.depth - 3) if self.voc is not None else 0
            k = self.voc.k if self.voc is not None else 10
            wmask = vocab.bow_window_mask(
                jnp.asarray(w1), jnp.asarray(w2), levels_up=lvl_up, k=k
            )
        res = matching.match_descriptors(
            d1, d2, v1, v2, window_mask=wmask,
            max_dist=matching.TH_LOW, ratio=0.75, mutual=True,
            angles=(jnp.asarray(store.kf_angle[kf1]), jnp.asarray(store.kf_angle[kf2])),
        )
        sel = np.where(np.asarray(res.valid))[0]
        idx2 = np.asarray(res.idx)[sel]
        lm1 = store.kf_obs_lm[kf1, sel]
        lm2 = store.kf_obs_lm[kf2, idx2]
        good = (lm1 >= 0) & (lm2 >= 0) & store.lm_valid[lm1] & store.lm_valid[lm2]
        return sel[good], idx2[good], lm1[good], lm2[good]

    def _kf_se3(self, kf: int) -> se3.SE3:
        return se3.SE3(
            jnp.asarray(self.store.kf_R[kf]), jnp.asarray(self.store.kf_t[kf])
        )

    def _search_by_sim3(self, kf1: int, kf2: int, S12: sim3.Sim3):
        """Grow kf1<->kf2 landmark matches by guided reprojection through the
        RANSAC Sim3 (ORBmatcher::SearchBySim3, called at LoopClosing.cc:500).
        Returns (kp1, kp2, lm1, lm2) agreement pairs."""
        store, cam = self.store, self.cam

        def kp_points(kf):
            lms = store.kf_obs_lm[kf]
            ok = (lms >= 0) & store.kf_kp_valid[kf]
            ok[ok] &= store.lm_valid[lms[ok]]
            pos = np.zeros((len(lms), 3), np.float32)
            pos[ok] = store.lm_pos[lms[ok]]
            T = self._kf_se3(kf)
            return np.asarray(se3.act(T, jnp.asarray(pos))), ok

        x1, ok1 = kp_points(kf1)
        x2, ok2 = kp_points(kf2)
        idxA, agree = _guided_sim3_kernel(
            cam, S12.s, S12.R, S12.t,
            jnp.asarray(x1), jnp.asarray(ok1),
            jnp.asarray(store.kf_desc[kf1]), jnp.asarray(store.kf_xy[kf1]),
            jnp.asarray(store.kf_octave[kf1]),
            jnp.asarray(x2), jnp.asarray(ok2),
            jnp.asarray(store.kf_desc[kf2]), jnp.asarray(store.kf_xy[kf2]),
            jnp.asarray(store.kf_octave[kf2]),
            jnp.float32(self.cfg.sim3_search_radius),
        )
        kp1 = np.where(np.asarray(agree))[0]
        kp2 = np.asarray(idxA)[kp1]
        return kp1, kp2, store.kf_obs_lm[kf1, kp1], store.kf_obs_lm[kf2, kp2]

    def _loop_point_group(self, kf_loop: int) -> np.ndarray:
        """mvpLoopMapPoints: landmarks of the loop KF + its covisible group
        (LoopClosing.cc:554-580), capacity-bounded."""
        store = self.store
        group = [kf_loop] + [int(x) for x in store.best_covisible(kf_loop, 10)]
        lms = np.unique(store.kf_obs_lm[group])
        lms = lms[lms >= 0]
        lms = lms[store.lm_valid[lms]]
        return lms[: self.cfg.loop_points_cap].astype(np.int64)

    def _project_loop_points(
        self, kf: int, S_cw: sim3.Sim3, loop_lms: np.ndarray, radius: float
    ):
        """Match the loop landmark group into keyframe `kf` under pose S_cw.
        Returns (kp_idx, valid) aligned with loop_lms."""
        store, cfg, cam = self.store, self.cfg, self.cam
        cap = cfg.loop_points_cap
        m = min(len(loop_lms), cap)
        pos = np.zeros((cap, 3), np.float32)
        desc = np.zeros((cap, 8), np.uint32)
        normal = np.tile(np.array([0, 0, 1], np.float32), (cap, 1))
        mind = np.zeros(cap, np.float32)
        maxd = np.full(cap, 1e6, np.float32)
        valid = np.zeros(cap, bool)
        pos[:m] = store.lm_pos[loop_lms[:m]]
        desc[:m] = store.lm_desc[loop_lms[:m]]
        normal[:m] = store.lm_normal[loop_lms[:m]]
        mind[:m] = store.lm_min_dist[loop_lms[:m]]
        maxd[:m] = np.minimum(store.lm_max_dist[loop_lms[:m]], 1e6)
        valid[:m] = store.lm_valid[loop_lms[:m]]
        idx, ok = _project_match_kernel(
            cam, S_cw.s, S_cw.R, S_cw.t,
            jnp.asarray(pos), jnp.asarray(desc), jnp.asarray(valid),
            jnp.asarray(normal), jnp.asarray(mind), jnp.asarray(maxd),
            jnp.asarray(store.kf_xy[kf]), jnp.asarray(store.kf_desc[kf]),
            jnp.asarray(store.kf_octave[kf]), jnp.asarray(store.kf_kp_valid[kf]),
            jnp.float32(radius),
        )
        return (
            np.array(idx[: len(loop_lms)]),
            np.array(ok[: len(loop_lms)]),
        )

    def compute_sim3(self, kf1: int, kf2: int):
        """RANSAC + SearchBySim3 growth + refine + guided-projection
        acceptance for S12 between current kf1 and candidate kf2
        (ComputeSim3, LoopClosing.cc:367-626)."""
        store, cfg, cam = self.store, self.cfg, self.cam
        kp1, kp2, lm1, lm2 = self._matched_pairs(kf1, kf2)
        self.last_reject = ("pairs", len(lm1))  # diagnostics for tuning/tests
        if len(lm1) < 20:  # nmatches<20 discard (LoopClosing.cc ComputeSim3)
            return False, None, None

        cap = cfg.match_cap
        T1 = self._kf_se3(kf1)
        T2 = self._kf_se3(kf2)

        def build_buffers(kp1_, kp2_, lm1_, lm2_):
            n = min(len(lm1_), cap)
            x1 = np.zeros((cap, 3), np.float32)
            x2 = np.zeros((cap, 3), np.float32)
            is2_1 = np.ones(cap, np.float32)
            is2_2 = np.ones(cap, np.float32)
            valid = np.zeros(cap, bool)
            x1[:n] = np.asarray(se3.act(T1, jnp.asarray(store.lm_pos[lm1_[:n]])))
            x2[:n] = np.asarray(se3.act(T2, jnp.asarray(store.lm_pos[lm2_[:n]])))
            is2_1[:n] = 1.0 / (1.2 ** (2 * store.kf_octave[kf1, kp1_[:n]]))
            is2_2[:n] = 1.0 / (1.2 ** (2 * store.kf_octave[kf2, kp2_[:n]]))
            valid[:n] = True
            return x1, x2, is2_1, is2_2, valid

        x1, x2, is2_1, is2_2, valid = build_buffers(kp1, kp2, lm1, lm2)
        self._key, sub = jax.random.split(self._key)
        res = sim3_solver.ransac_sim3(
            sub, jnp.asarray(x1), jnp.asarray(x2), jnp.asarray(valid),
            jnp.asarray(is2_1), jnp.asarray(is2_2), cam,
            fix_scale=cfg.fix_scale,
        )
        self.last_reject = ("ransac", int(res.num_inliers))
        if int(res.num_inliers) < cfg.min_ransac_inliers:
            return False, None, None

        # SearchBySim3 growth: union the BoW matches with guided-agreement
        # pairs (keyed by current-KF keypoint) before refinement.
        g_kp1, g_kp2, g_lm1, g_lm2 = self._search_by_sim3(kf1, kf2, res.S12)
        have = set(kp1.tolist())
        add = [i for i, k in enumerate(g_kp1) if k not in have]
        if add:
            kp1 = np.concatenate([kp1, g_kp1[add]])[:cap]
            kp2 = np.concatenate([kp2, g_kp2[add]])[:cap]
            lm1 = np.concatenate([lm1, g_lm1[add]])[:cap]
            lm2 = np.concatenate([lm2, g_lm2[add]])[:cap]
            x1, x2, is2_1, is2_2, valid = build_buffers(kp1, kp2, lm1, lm2)
        kp1, kp2, lm1, lm2 = kp1[:cap], kp2[:cap], lm1[:cap], lm2[:cap]

        S12, inl, n_inl = sim3_solver.optimize_sim3(
            res.S12, jnp.asarray(x1), jnp.asarray(x2), jnp.asarray(valid),
            jnp.asarray(is2_1), jnp.asarray(is2_2), cam,
            fix_scale=cfg.fix_scale,
        )
        n_inl = int(n_inl)
        self.last_reject = ("optimize", n_inl)
        if n_inl < cfg.min_ransac_inliers:
            return False, None, None

        # Guided projection of the loop-side landmark group into the current
        # KF under the corrected pose S_cw = S12 ∘ T_loop_w, then the >= 40
        # total-matches acceptance (LoopClosing.cc:580-626).
        loop_lms = self._loop_point_group(kf2)
        S_cw = sim3.compose(S12, sim3.from_se3(T2))
        proj_kp, proj_ok = self._project_loop_points(
            kf1, S_cw, loop_lms, cfg.proj_search_radius
        )

        # Seed with the Sim3-inlier matches (mvpCurrentMatchedPoints is
        # initialized from them before SearchByProjection fills more).
        inl_np = np.asarray(inl)[: len(kp1)]
        lm2_pos = {int(lm2[i]): int(kp1[i]) for i in np.where(inl_np)[0]}
        lm_index = {int(l): j for j, l in enumerate(loop_lms)}
        for l, k in lm2_pos.items():
            j = lm_index.get(l)
            if j is not None and not proj_ok[j]:
                proj_kp[j] = k
                proj_ok[j] = True
        # Distinct matched keypoints (mutual matching keeps them 1-1; the
        # seeded entries may collide, count distinct to be exact).
        n_total = len(set(proj_kp[proj_ok].tolist()))
        self.last_reject = ("total", n_total)
        if n_total < cfg.min_total_matches:
            return False, None, None
        matches = LoopMatches(
            loop_lms=loop_lms, cur_kp=proj_kp, cur_valid=proj_ok, n_total=n_total
        )
        return True, S12, matches

    # ------------------------------------------------------------------
    # Correction
    # ------------------------------------------------------------------

    def correct_loop(
        self, kf_cur: int, kf_loop: int, S12: sim3.Sim3,
        matches: Optional[LoopMatches] = None,
    ):
        """Propagate the corrected Sim3, fuse duplicate landmarks, optimize
        the essential graph, GBA.

        S12 maps kf_loop-camera coords -> kf_cur-camera coords, so the
        corrected current pose is ``S_cur_w = S12 ∘ S_loop_w`` (the loop
        KF's pose is trusted; LoopClosing.cc:627-894).

        Returns True iff the loop was committed; False when one of the
        poisoned-constraint gates vetoed it (the map is then exactly as
        before the call, up to the monotonic version counter).
        """
        store, cfg = self.store, self.cfg
        K = store.num_kf

        # Pre-correction poses as Sim3 (scale 1).
        s_all = np.ones(K, np.float32)
        R_all = store.kf_R[:K].copy()
        t_all = store.kf_t[:K].copy()

        S_loop = sim3.Sim3(
            jnp.asarray(1.0), jnp.asarray(R_all[kf_loop]), jnp.asarray(t_all[kf_loop])
        )
        S_cur_corr = sim3.compose(S12, S_loop)

        # ---- Gate (a): drift plausibility (pre-mutation) ----
        # The correction the loop edge applies to the current pose IS the
        # claimed accumulated drift since kf_loop; reject corrections no
        # plausible odometry drift could explain. (The reference has no
        # such gate — LoopClosing.cc accepts on match counts alone — and
        # the r4 soak showed an aliased candidate passing those.)
        T_new = sim3.to_se3(S_cur_corr)
        R_new = np.asarray(T_new.R)
        c_new = -R_new.T @ np.asarray(T_new.t)
        c_old = -R_all[kf_cur].T @ t_all[kf_cur]
        corr_t = float(np.linalg.norm(c_new - c_old))
        cosang = (np.trace(R_new @ R_all[kf_cur].T) - 1.0) / 2.0
        corr_rot = float(np.arccos(np.clip(cosang, -1.0, 1.0)))
        corr_slog = abs(float(np.log(max(float(S12.s), 1e-9))))
        ids = [
            k for k in range(min(kf_loop, kf_cur), max(kf_loop, kf_cur) + 1)
            if store.kf_valid[k]
        ]
        centers = np.stack([-store.kf_R[k].T @ store.kf_t[k] for k in ids])
        chain_dist = float(
            np.sum(np.linalg.norm(np.diff(centers, axis=0), axis=-1))
        )
        t_allow = max(cfg.drift_frac * chain_dist, cfg.min_drift_allow)
        if (
            corr_rot > cfg.max_loop_rot
            or corr_t > t_allow
            or (not cfg.fix_scale and corr_slog > cfg.max_loop_scale_log)
        ):
            self.last_loop_veto = (
                "drift", {"rot": corr_rot, "t": corr_t, "t_allow": t_allow,
                          "slog": corr_slog},
            )
            self.num_loops_rejected += 1
            return False

        # Step 0: a newer loop supersedes any in-flight GBA — bumping the
        # generation makes the stale run abort between chunks (the
        # reference's mbStopGBA + mnFullBAIdx, LoopClosing.cc:649-660).
        self.gba_generation += 1

        # Rollback snapshot for gate (b): everything CorrectLoop mutates
        # before the GBA launch (poses, landmark state, observation wiring,
        # covisibility). Tens of MB, paid only on (rare) loop events.
        snap = self._snapshot_for_rollback(K)

        # Current KF's covisible group gets corrected via its relative pose
        # to the current KF: S_i_corr = (T_iw ∘ T_cur_w^-1) ∘ S_cur_corr.
        group = [kf_cur] + [int(x) for x in store.best_covisible(kf_cur, 30)]
        T_cur = se3.SE3(jnp.asarray(R_all[kf_cur]), jnp.asarray(t_all[kf_cur]))
        corrected = {}
        for i in group:
            T_i = se3.SE3(jnp.asarray(R_all[i]), jnp.asarray(t_all[i]))
            S_rel = sim3.from_se3(se3.compose(T_i, se3.inverse(T_cur)))
            corrected[i] = sim3.compose(S_rel, S_cur_corr)

        # Move the group's landmarks: p' = S_corr^-1( S_old(p) ).
        moved = set()
        for i in group:
            lms = store.kf_obs_lm[i]
            lms = np.unique(lms[lms >= 0])
            lms = [l for l in lms if l not in moved and store.lm_valid[l]]
            if not lms:
                continue
            moved.update(lms)
            p = jnp.asarray(store.lm_pos[lms])
            S_old = sim3.Sim3(
                jnp.asarray(1.0), jnp.asarray(R_all[i]), jnp.asarray(t_all[i])
            )
            p_new = sim3.act(sim3.inverse(corrected[i]), sim3.act(S_old, p))
            store.lm_pos[lms] = np.asarray(p_new)
            store.version += 1

        # Pre-correction snapshot: edge MEASUREMENTS come from these
        # (the reference's NonCorrectedSim3 map, LoopClosing.cc:680-720) —
        # measuring chain edges from partially-corrected poses would bake
        # the loop discontinuity into the measurements.
        s_meas = s_all.copy()
        R_meas = R_all.copy()
        t_meas = t_all.copy()

        # Write corrected group poses (scale folded into translation);
        # these are the INITIAL VALUES for the essential graph.
        for i, S in corrected.items():
            T = sim3.to_se3(S)
            store.set_kf_pose(i, np.asarray(T.R), np.asarray(T.t))
            s_all[i] = float(S.s)
            R_all[i] = np.asarray(S.R)
            t_all[i] = np.asarray(S.t)

        # ---- SearchAndFuse: merge duplicate landmarks across the loop ----
        # Step 3 (LoopClosing.cc:774-800): resolve the precomputed current-KF
        # matches; Step 4 (:888-935): project the loop landmark group into
        # every corrected keyframe and fuse. New covisibility edges created
        # by the fusion become the LoopConnections cross edges.
        pre_neighbors = {
            i: set(np.where(store.covis[i] > 0)[0].tolist()) for i in group
        }
        self.last_fused = 0
        if matches is not None:
            for j in np.where(matches.cur_valid)[0]:
                self.last_fused += self._fuse_point(
                    int(matches.loop_lms[j]), kf_cur, int(matches.cur_kp[j])
                )
            loop_lms = matches.loop_lms
        else:
            loop_lms = self._loop_point_group(kf_loop)
        for i in group:
            proj_kp, proj_ok = self._project_loop_points(
                i, corrected[i], loop_lms, cfg.fuse_radius
            )
            for j in np.where(proj_ok)[0]:
                self.last_fused += self._fuse_point(
                    int(loop_lms[j]), i, int(proj_kp[j])
                )
        # Step 5: refresh covisibility; the new cross-loop connections get
        # essential-graph edges measured from the CORRECTED poses (the
        # reference's LoopConnections, measured from vertex estimates).
        for i in group:
            store.update_connections(i)
        loop_connections = []
        group_set = set(group)
        for i in group:
            now = set(np.where(store.covis[i] > 0)[0].tolist())
            for j in now - pre_neighbors[i] - group_set:
                loop_connections.append((i, int(j)))

        # ---- essential graph over all keyframes ----
        problem = self._build_pose_graph(
            kf_cur, kf_loop, S12, s_all, R_all, t_all,
            s_meas, R_meas, t_meas, loop_connections,
        )
        out, _ = essential_graph.optimize_pose_graph(
            problem, num_iters=cfg.essential_iters
        )
        self._apply_pose_graph(out, K)

        # ---- Gate (b): observation-tear veto (post-essential-graph) ----
        # A good loop moves landmarks WITH their keyframes and fuses true
        # duplicates, so the current group's observations stay reprojection-
        # consistent. A poisoned constraint merges distinct 3D points and
        # warps the group against its own geometry — the exact state that
        # seeded the r4 soak's divergent GBA. Check BEFORE GBA and roll the
        # whole correction back if the group tore.
        bad_frac = self._obs_bad_fraction(set(group))
        if bad_frac > cfg.max_loop_bad_obs_frac:
            self._restore_from_rollback(snap, K)
            self.last_loop_veto = ("tear", {"bad_frac": float(bad_frac)})
            self.num_loops_rejected += 1
            return False

        store.loop_edges.append((kf_cur, kf_loop))
        self.last_loop_kf = kf_cur
        self.num_loops_closed += 1

        # ---- global BA (RunGlobalBundleAdjustment, :978-1118) ----
        if cfg.run_gba:
            gen = self.gba_generation
            if self.async_gba:
                self._gba_thread = threading.Thread(
                    target=self.run_global_ba, args=(gen,), daemon=True
                )
                self._gba_thread.start()
            else:
                self.run_global_ba(gen)
        return True

    def _build_pose_graph(self, kf_cur, kf_loop, S12, s_all, R_all, t_all,
                          s_meas, R_meas, t_meas, loop_connections=()):
        """Edges: spanning tree + previous loop edges + strong covis + the
        new loop edge + fusion-created LoopConnections. Chain-edge
        measurements come from the PRE-correction snapshot (s/R/t_meas);
        LoopConnections are measured from the corrected poses (s/R/t_all),
        matching OptimizeEssentialGraph's NonCorrectedSim3/vertex-estimate
        split (g2oOptimizer.cc:1212-1380). Initial values are the corrected
        poses."""
        store, cfg = self.store, self.cfg
        K = store.num_kf
        E = cfg.edge_cap

        # Collect (i, j, corrected?) index lists on the host, then measure
        # ALL relatives in two batched Sim3 composes: per-edge jnp ops would
        # cost one device dispatch each, thousands per loop closure.
        pre_ij: List = []  # measured from the pre-correction snapshot
        post_ij: List = []  # LoopConnections: measured from corrected poses
        seen = set()

        def add(i, j, bucket):
            i, j = int(i), int(j)
            if i < 0 or j < 0 or i == j:
                return
            pair = (min(i, j), max(i, j))
            if pair in seen:
                return
            seen.add(pair)
            bucket.append((i, j))

        seen.add((min(kf_loop, kf_cur), max(kf_loop, kf_cur)))
        for (i, j) in loop_connections:
            add(i, j, post_ij)
        for (a, b) in store.loop_edges:
            if a < K and b < K:
                add(b, a, pre_ij)
        valid_k = np.where(store.kf_valid[:K])[0]
        for k in valid_k:
            p = store.parent[k]
            if p >= 0 and store.kf_valid[p]:
                add(int(p), k, pre_ij)
            for c in store.covisible_above(int(k), cfg.covis_edge_weight):
                add(int(k), int(c), pre_ij)

        def batched_relatives(ij, s, R, t):
            """S_ji = S_jw ∘ S_iw^-1 for all (i, j) pairs in one compose."""
            if not ij:
                return (np.zeros(0, np.float32), np.zeros((0, 3, 3), np.float32),
                        np.zeros((0, 3), np.float32))
            idx = np.asarray(ij, np.int64)
            S_i = sim3.Sim3(
                jnp.asarray(s[idx[:, 0]]), jnp.asarray(R[idx[:, 0]]),
                jnp.asarray(t[idx[:, 0]]),
            )
            S_j = sim3.Sim3(
                jnp.asarray(s[idx[:, 1]]), jnp.asarray(R[idx[:, 1]]),
                jnp.asarray(t[idx[:, 1]]),
            )
            S = sim3.compose(S_j, sim3.inverse(S_i))
            return np.asarray(S.s), np.asarray(S.R), np.asarray(S.t)

        s_pre, R_pre, t_pre = batched_relatives(pre_ij, s_meas, R_meas, t_meas)
        s_post, R_post, t_post = batched_relatives(post_ij, s_all, R_all, t_all)

        # cfg.edge_cap is a floor, not a ceiling: at KITTI-00-class KF
        # counts the covis+chain edge set outgrows it, and silently
        # truncating constraints weakens the relaxation exactly when it
        # matters most. Round the needed capacity up in 4096 buckets so the
        # (rare) loop-time recompile cost is bounded.
        needed = 1 + len(post_ij) + len(pre_ij)
        E = max(E, -(-needed // 4096) * 4096)
        ei = np.zeros(E, np.int32)
        ej = np.zeros(E, np.int32)
        es = np.ones(E, np.float32)
        eR = np.tile(np.eye(3, dtype=np.float32), (E, 1, 1))
        et = np.zeros((E, 3), np.float32)
        ev = np.zeros(E, bool)
        # New loop edge first (S12 maps loop->cur, i.e. S_cur_loop), then
        # LoopConnections, then chain edges — truncated at capacity.
        all_i = np.concatenate(
            [[kf_loop], [p[0] for p in post_ij], [p[0] for p in pre_ij]]
        ).astype(np.int32)
        all_j = np.concatenate(
            [[kf_cur], [p[1] for p in post_ij], [p[1] for p in pre_ij]]
        ).astype(np.int32)
        all_s = np.concatenate([[float(S12.s)], s_post, s_pre]).astype(np.float32)
        all_R = np.concatenate(
            [np.asarray(S12.R)[None], R_post.reshape(-1, 3, 3), R_pre.reshape(-1, 3, 3)]
        ).astype(np.float32)
        all_t = np.concatenate(
            [np.asarray(S12.t)[None], t_post.reshape(-1, 3), t_pre.reshape(-1, 3)]
        ).astype(np.float32)
        ne = min(len(all_i), E)
        ei[:ne] = all_i[:ne]
        ej[:ne] = all_j[:ne]
        es[:ne] = all_s[:ne]
        eR[:ne] = all_R[:ne]
        et[:ne] = all_t[:ne]
        ev[:ne] = True

        fixed = np.zeros(K, bool)
        fixed[kf_loop] = True
        return essential_graph.PoseGraphProblem(
            s=jnp.asarray(s_all),
            R=jnp.asarray(R_all),
            t=jnp.asarray(t_all),
            fixed=jnp.asarray(fixed),
            valid=jnp.asarray(store.kf_valid[:K]),
            e_i=jnp.asarray(ei),
            e_j=jnp.asarray(ej),
            e_s=jnp.asarray(es),
            e_R=jnp.asarray(eR),
            e_t=jnp.asarray(et),
            e_valid=jnp.asarray(ev),
        )

    # Store fields CorrectLoop mutates before GBA: poses (set_kf_pose),
    # landmark positions/validity/wiring (_apply_pose_graph, _fuse_point ->
    # replace_landmark/add_observation), covisibility (update_connections).
    _ROLLBACK_KF = ("kf_R", "kf_t", "kf_obs_lm")
    _ROLLBACK_LM = (
        "lm_pos", "lm_valid", "lm_desc", "lm_normal", "lm_min_dist",
        "lm_max_dist", "lm_obs_kf", "lm_obs_idx", "lm_n_obs", "lm_visible",
        "lm_found", "lm_first_kf",
    )
    _ROLLBACK_FULL = ("covis", "parent")

    def _snapshot_for_rollback(self, K: int) -> dict:
        store = self.store
        L = store.num_lm
        snap = {f: getattr(store, f)[:K].copy() for f in self._ROLLBACK_KF}
        snap.update({f: getattr(store, f)[:L].copy() for f in self._ROLLBACK_LM})
        snap.update({f: getattr(store, f).copy() for f in self._ROLLBACK_FULL})
        snap["loop_edges"] = list(store.loop_edges)
        return snap

    def _restore_from_rollback(self, snap: dict, K: int):
        store = self.store
        L = snap["lm_pos"].shape[0]
        for f in self._ROLLBACK_KF:
            getattr(store, f)[:K] = snap[f]
        for f in self._ROLLBACK_LM:
            getattr(store, f)[:L] = snap[f]
        for f in self._ROLLBACK_FULL:
            getattr(store, f)[...] = snap[f]
        store.loop_edges = snap["loop_edges"]
        # The version counter stays monotonic: downstream device caches key
        # on it, and silently restoring state under an unchanged version
        # would serve stale gathers.
        store.version += 1

    def _obs_bad_fraction(self, kfs: Optional[set] = None) -> float:
        """Fraction of (optionally KF-restricted) landmark observations
        whose reprojection fails the chi2(0.05, 2dof) gate under the
        CURRENT store state — the tear metric for gate (b)."""
        store, cam = self.store, self.cam
        L = store.num_lm
        lm_sel = np.where(store.lm_valid[:L])[0]
        if len(lm_sel) == 0:
            return 0.0
        O = store.lm_obs_kf.shape[1]
        flat_kf = store.lm_obs_kf[lm_sel].reshape(-1)
        flat_idx = store.lm_obs_idx[lm_sel].reshape(-1)
        flat_lm = np.repeat(lm_sel, O)
        m = (flat_kf >= 0) & (flat_idx >= 0)
        if kfs is not None:
            m &= np.isin(flat_kf, np.fromiter(kfs, dtype=np.int64))
        if not m.any():
            return 0.0
        kf, idx, lm = flat_kf[m], flat_idx[m], flat_lm[m]
        p_c = (
            np.einsum("kij,kj->ki", store.kf_R[kf], store.lm_pos[lm])
            + store.kf_t[kf]
        )
        z = p_c[:, 2]
        zs = np.maximum(z, 1e-6)
        u = cam.fx * p_c[:, 0] / zs + cam.cx
        v = cam.fy * p_c[:, 1] / zs + cam.cy
        xy = store.kf_xy[kf, idx]
        inv_s2 = 1.0 / 1.2 ** (2 * store.kf_octave[kf, idx])
        e2 = ((u - xy[:, 0]) ** 2 + (v - xy[:, 1]) ** 2) * inv_s2
        bad = (z <= 0.05) | (e2 > 5.991)
        return float(bad.mean())

    def _apply_pose_graph(self, out: essential_graph.PoseGraphProblem, K: int):
        """Write back optimized poses and landmark corrections
        (g2oOptimizer.cc:1515-1560: KF t/s, landmarks via their ref KF)."""
        store = self.store
        old_R = store.kf_R[:K].copy()
        old_t = store.kf_t[:K].copy()
        new_s = np.asarray(out.s)
        new_R = np.asarray(out.R)
        new_t = np.asarray(out.t)

        # Landmarks move with their reference (first-observing) keyframe:
        # p' = S_new^-1( S_old(p) ).
        ref_kf = store.lm_first_kf[: store.num_lm].copy()
        lm_sel = np.where(store.lm_valid[: store.num_lm] & (ref_kf >= 0) & (ref_kf < K))[0]
        if len(lm_sel):
            refs = ref_kf[lm_sel]
            p = store.lm_pos[lm_sel]
            p_cam = np.einsum("kij,kj->ki", old_R[refs], p) + old_t[refs]
            s = new_s[refs][:, None]
            Rn = new_R[refs]
            tn = new_t[refs]
            p_new = np.einsum("kji,kj->ki", Rn, (p_cam - tn) / np.maximum(s, 1e-9))
            store.lm_pos[lm_sel] = p_new
            store.version += 1

        for k in range(K):
            if store.kf_valid[k]:
                store.set_kf_pose(
                    k, new_R[k], new_t[k] / max(new_s[k], 1e-9)
                )

    # ------------------------------------------------------------------
    # Global BA
    # ------------------------------------------------------------------

    def run_global_ba(self, generation: Optional[int] = None) -> bool:
        """Interruptible full-map BA via the matrix-free PCG Schur engine.

        RunGlobalBundleAdjustment (LoopClosing.cc:978-1118) redesigned for
        the dispatch model: instead of a per-edge forceStopFlag, the LM/PCG
        iterations run in chunks of `gba_chunk` dispatches and the loop
        generation counter is re-checked between them — a newer CorrectLoop
        bumps it and the stale run returns False without touching the map.
        On completion, keyframes created while GBA ran (async mode) are
        corrected through the spanning tree and late landmarks through
        their reference KF (:1058-1107). Returns True iff written back."""
        cfg = self.cfg
        if generation is None:
            generation = self.gba_generation
        with self.map_lock:
            snap_kf = self.store.num_kf
            snap_lm = self.store.num_lm
            pre_R = self.store.kf_R[:snap_kf].copy()
            pre_t = self.store.kf_t[:snap_kf].copy()
            problem, meta = gather_global_problem_bucketed(self.store)

        survivors = None
        done = 0
        while done < cfg.gba_iters:
            if self.gba_generation != generation:
                self.num_gba_aborted += 1
                return False
            n = min(max(cfg.gba_chunk, 1), cfg.gba_iters - done)
            problem, survivors, _ = schur_bucketed.global_ba_cg(
                problem, self.cam, num_iters=n
            )
            done += n
            self._gba_tick()

        with self.map_lock:
            # Re-check INSIDE the lock: a CorrectLoop holding it may have
            # superseded this run while we waited to acquire.
            if self.gba_generation != generation:
                self.num_gba_aborted += 1
                return False
            # Safety valve (found by the 1000-frame soak, eval/longrun.py):
            # a GBA that failed to converge — e.g. seeded from a bad loop
            # constraint — can flag nearly EVERY observation as an outlier;
            # writing that back erases the whole landmark set and kills
            # tracking permanently. A sane GBA outcome drops a few percent;
            # if over half would drop, discard the result instead of the map
            # (the reference never mass-drops post-GBA either — outlier
            # erasure there happens only in local BA, g2oOptimizer.cc:1119).
            n_obs = int(np.asarray(problem.obs_valid).sum())
            n_surv = int(
                (np.asarray(survivors) & np.asarray(problem.obs_valid)).sum()
            )
            if n_obs > 0 and n_surv < 0.5 * n_obs:
                self.num_gba_aborted += 1
                return False
            write_back_global_bucketed(self.store, problem, survivors, meta)
            self._propagate_to_new_kfs(snap_kf, snap_lm, pre_R, pre_t)
        self.num_gba_completed += 1
        return True

    def wait_gba(self):
        """Join an async GBA thread (System::Shutdown discipline)."""
        t = self._gba_thread
        if t is not None:
            t.join()

    def _propagate_to_new_kfs(
        self, snap_kf: int, snap_lm: int, pre_R: np.ndarray, pre_t: np.ndarray
    ):
        """Correct keyframes/landmarks created during GBA via the spanning
        tree (LoopClosing.cc:1058-1107): T_k' = (T_k T_p^-1)_preGBA ∘ T_p',
        landmarks via their reference keyframe's correction."""
        store = self.store
        if store.num_kf == snap_kf and store.num_lm == snap_lm:
            return
        # Old (pre-write-back) poses: snapshot rows from pre_R/pre_t; rows
        # created during GBA keep their current (uncorrected) pose.
        old_R = np.concatenate([pre_R, store.kf_R[snap_kf:store.num_kf]], axis=0)
        old_t = np.concatenate([pre_t, store.kf_t[snap_kf:store.num_kf]], axis=0)
        for k in range(snap_kf, store.num_kf):
            if not store.kf_valid[k]:
                continue
            p = int(store.parent[k])
            if p < 0:
                continue
            # Parents are older, so by ascending order p is already corrected.
            R_rel = old_R[k] @ old_R[p].T
            t_rel = old_t[k] - R_rel @ old_t[p]
            store.set_kf_pose(
                k, R_rel @ store.kf_R[p], R_rel @ store.kf_t[p] + t_rel
            )
        # Late landmarks move with their reference KF: p' = T'^-1 (T_old p).
        refs = store.lm_first_kf[snap_lm:store.num_lm]
        sel = np.where(store.lm_valid[snap_lm:store.num_lm] & (refs >= 0))[0]
        if len(sel):
            r = refs[sel]
            p = store.lm_pos[snap_lm + sel]
            p_cam = np.einsum("kij,kj->ki", old_R[r], p) + old_t[r]
            Rn = store.kf_R[r]
            tn = store.kf_t[r]
            store.lm_pos[snap_lm + sel] = np.einsum(
                "kji,kj->ki", Rn, p_cam - tn
            )
            store.version += 1


# ----------------------------------------------------------------------
# Whole-map problem gather / write-back (shared with System GBA calls)
# ----------------------------------------------------------------------


def gather_global_problem(store: MapStore):
    """All valid KFs + landmarks -> BAProblem (edge list from lm_obs_*)."""
    K = store.num_kf
    Lc = store.num_lm
    kf_ids = np.where(store.kf_valid[:K])[0]
    lm_ids = np.where(store.lm_valid[:Lc] & (store.lm_n_obs[:Lc] > 0))[0]
    kf_slot = np.full(K, -1, np.int32)
    kf_slot[kf_ids] = np.arange(len(kf_ids), dtype=np.int32)
    lm_slot = np.full(Lc, -1, np.int32)
    lm_slot[lm_ids] = np.arange(len(lm_ids), dtype=np.int32)

    obs_kf = store.lm_obs_kf[lm_ids]  # (l, O)
    obs_idx = store.lm_obs_idx[lm_ids]
    li = np.repeat(np.arange(len(lm_ids), dtype=np.int32), store.obs_per_landmark)
    kfs = obs_kf.reshape(-1)
    kps = obs_idx.reshape(-1)
    ok = (kfs >= 0) & (kfs < K)
    ok[ok] &= kf_slot[kfs[ok]] >= 0
    li, kfs, kps = li[ok], kfs[ok], kps[ok]

    uvr = store.kf_uvr[kfs, kps]
    octv = store.kf_octave[kfs, kps]
    P = len(kf_ids)
    L = max(len(lm_ids), 1)
    E = max(len(li), 1)

    problem = schur.BAProblem(
        pose_R=jnp.asarray(store.kf_R[kf_ids]),
        pose_t=jnp.asarray(store.kf_t[kf_ids]),
        pose_fixed=jnp.asarray(np.arange(P) == 0),  # gauge: first KF
        pose_valid=jnp.ones(P, bool),
        points=jnp.asarray(store.lm_pos[lm_ids]) if len(lm_ids) else jnp.zeros((1, 3)),
        point_valid=jnp.ones(L, bool) if len(lm_ids) else jnp.zeros(1, bool),
        obs_cam=jnp.asarray(kf_slot[kfs]) if len(li) else jnp.zeros(1, jnp.int32),
        obs_pt=jnp.asarray(li) if len(li) else jnp.zeros(1, jnp.int32),
        obs_uvr=jnp.asarray(uvr) if len(li) else jnp.full((1, 3), -1.0),
        obs_inv_sigma2=jnp.asarray((1.0 / 1.2 ** (2 * octv)).astype(np.float32))
        if len(li)
        else jnp.ones(1),
        obs_valid=jnp.ones(E, bool) if len(li) else jnp.zeros(1, bool),
    )
    meta = (kf_ids, lm_ids, kfs, li, kps)
    return problem, meta


def gather_global_problem_bucketed(store: MapStore):
    """All valid KFs + landmarks -> BucketedBAProblem.

    The map store's per-landmark observation table (lm_obs_kf/idx, (L, O)) IS
    the bucketed layout, so the gather is a handful of vectorized numpy
    slices — no per-edge Python loop."""
    K = store.num_kf
    Lc = store.num_lm
    kf_ids = np.where(store.kf_valid[:K])[0]
    lm_ids = np.where(store.lm_valid[:Lc] & (store.lm_n_obs[:Lc] > 0))[0]
    kf_slot = np.full(max(K, 1), -1, np.int32)
    kf_slot[kf_ids] = np.arange(len(kf_ids), dtype=np.int32)

    P = max(len(kf_ids), 1)
    # Pad the landmark axis to a multiple of 128: maps that differ by a few
    # landmarks share one compiled GBA program.
    L_real = max(len(lm_ids), 1)
    L = -(-L_real // 128) * 128
    O = store.obs_per_landmark

    obs_kf = store.lm_obs_kf[lm_ids] if len(lm_ids) else np.full((1, O), -1, np.int32)
    obs_idx = store.lm_obs_idx[lm_ids] if len(lm_ids) else np.full((1, O), -1, np.int32)
    okf = np.clip(obs_kf, 0, K - 1 if K else 0)
    oidx = np.clip(obs_idx, 0, store.kf_uvr.shape[1] - 1)
    valid = (obs_kf >= 0) & (kf_slot[okf] >= 0)
    obs_cam = np.where(valid, kf_slot[okf], 0).astype(np.int32)
    uvr = np.where(valid[..., None], store.kf_uvr[okf, oidx], -1.0).astype(np.float32)
    octv = store.kf_octave[okf, oidx]
    is2 = (1.0 / 1.2 ** (2 * octv)).astype(np.float32)

    def pad_rows(x, fill):
        n = x.shape[0]
        if n >= L:
            return x
        padded = np.full((L,) + x.shape[1:], fill, x.dtype)
        padded[:n] = x
        return padded

    points_np = store.lm_pos[lm_ids] if len(lm_ids) else np.zeros((1, 3), np.float32)
    pv = np.zeros(L, bool)
    pv[: len(lm_ids)] = True

    problem = schur_bucketed.BucketedBAProblem(
        pose_R=jnp.asarray(store.kf_R[kf_ids]) if len(kf_ids) else jnp.eye(3)[None],
        pose_t=jnp.asarray(store.kf_t[kf_ids]) if len(kf_ids) else jnp.zeros((1, 3)),
        pose_fixed=jnp.asarray(np.arange(P) == 0),  # gauge: first KF
        pose_valid=jnp.ones(P, bool),
        points=jnp.asarray(pad_rows(points_np.astype(np.float32), 0.0)),
        point_valid=jnp.asarray(pv),
        obs_cam=jnp.asarray(pad_rows(obs_cam, 0)),
        obs_uvr=jnp.asarray(pad_rows(uvr, -1.0)),
        obs_inv_sigma2=jnp.asarray(pad_rows(is2, 1.0)),
        obs_valid=jnp.asarray(pad_rows(valid, False)),
    )
    meta = (kf_ids, lm_ids, obs_kf, obs_idx)
    return problem, meta


def write_back_global_bucketed(store: MapStore, out, survivors, meta):
    kf_ids, lm_ids, e_kf, e_kp = meta
    new_R = np.asarray(out.pose_R)
    new_t = np.asarray(out.pose_t)
    fixed = np.asarray(out.pose_fixed)
    for i, k in enumerate(kf_ids):
        if not fixed[i]:
            store.set_kf_pose(int(k), new_R[i], new_t[i])
    if len(lm_ids):
        store.lm_pos[lm_ids] = np.asarray(out.points[: len(lm_ids)])
        store.version += 1
    dropped = np.asarray(out.obs_valid) & ~np.asarray(survivors)
    for li, j in zip(*np.nonzero(dropped[: len(lm_ids)])):
        store.erase_observation(int(lm_ids[li]), int(e_kf[li, j]))


def write_back_global(store: MapStore, out: schur.BAProblem, survivors, meta):
    kf_ids, lm_ids, e_kf, e_lm_slot, e_kp = meta
    new_R = np.asarray(out.pose_R)
    new_t = np.asarray(out.pose_t)
    fixed = np.asarray(out.pose_fixed)
    for i, k in enumerate(kf_ids):
        if not fixed[i]:
            store.set_kf_pose(int(k), new_R[i], new_t[i])
    if len(lm_ids):
        store.lm_pos[lm_ids] = np.asarray(out.points[: len(lm_ids)])
        store.version += 1
    surv = np.asarray(survivors)[: len(e_kf)]
    for j in np.where(~surv)[0]:
        store.erase_observation(int(lm_ids[e_lm_slot[j]]), int(e_kf[j]))
