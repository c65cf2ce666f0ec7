"""KITTI-00-class scale: global BA + essential graph on a large map.

Exercises the whole-map path the driver's "global BA at scale" config names
(hundreds of KFs, >=10^4..10^5 landmarks): the pose-side accumulation in
the matrix-free CG engine, the vectorized global gather, and the essential
graph at full trajectory length. benchmarks/bench_scale.py runs the full
600-KF / 1.2e5-landmark shape on the GPU; here a reduced (but still
hundreds-of-KFs) instance keeps CPU runtime testable.
"""

import time

import numpy as np
import pytest

from sqrtlm_slam_tpu.eval.scale import make_scale_store, store_ate
from sqrtlm_slam_tpu.eval.synthetic import DEFAULT_CAM
from sqrtlm_slam_tpu.loop import LoopCloser, LoopClosingConfig


class TestPoseAccumulate:
    def test_pose_sum_matches_numpy(self):
        """Pose-side reduction of slot values (D, K, L) by camera index —
        the accumulation inside every CG matvec at map scale."""
        import jax.numpy as jnp

        from sqrtlm_slam_tpu.optim import schur_bucketed as sb

        rng = np.random.RandomState(0)
        L, K, P = 333, 5, 37
        cam_t = rng.randint(0, P, (K, L))
        X = rng.normal(size=(6, K, L)).astype(np.float32)
        want = np.zeros((P, 6), np.float64)
        np.add.at(want, cam_t.reshape(-1), X.reshape(6, -1).T)
        got = sb._pose_sum(jnp.asarray(X), jnp.asarray(cam_t, jnp.int32), P)
        np.testing.assert_allclose(np.asarray(got), want, atol=1e-4)


@pytest.mark.slow
class TestScaleMap:
    def test_global_ba_at_scale(self):
        store, true_R, true_t = make_scale_store(
            n_kf=256, n_lm=24_000, obs_per_lm=5, drift=3e-4, seed=1
        )
        ate0 = store_ate(store, true_R, true_t)
        lc = LoopCloser(
            store, DEFAULT_CAM, cfg=LoopClosingConfig(gba_iters=4, gba_chunk=2)
        )
        from sqrtlm_slam_tpu.loop.closing import gather_global_problem_bucketed
        from sqrtlm_slam_tpu.optim import schur_bucketed as sb

        problem, _ = gather_global_problem_bucketed(store)
        chi0 = float(sb.chi2_only(problem, DEFAULT_CAM, problem.obs_valid, None))
        t0 = time.time()
        assert lc.run_global_ba() is True
        dt = time.time() - t0
        problem2, _ = gather_global_problem_bucketed(store)
        chi1 = float(sb.chi2_only(problem2, DEFAULT_CAM, problem2.obs_valid, None))
        ate1 = store_ate(store, true_R, true_t)
        print(f"scale GBA: chi2 {chi0:.0f}->{chi1:.0f} ate {ate0:.3f}->{ate1:.3f} in {dt:.0f}s")
        assert chi1 < 0.5 * chi0
        assert ate1 < ate0 * 1.5  # BA must not blow up the trajectory

    def test_essential_graph_at_scale(self):
        from jax import numpy as jnp

        from sqrtlm_slam_tpu.geometry import sim3
        from sqrtlm_slam_tpu.loop import essential_graph

        store, true_R, true_t = make_scale_store(
            n_kf=512, n_lm=30_000, obs_per_lm=5, drift=4e-4, seed=2
        )
        ate0 = store_ate(store, true_R, true_t)
        lc = LoopCloser(
            store, DEFAULT_CAM,
            cfg=LoopClosingConfig(edge_cap=16384, run_gba=False),
        )
        K = store.num_kf
        s_all = np.ones(K, np.float32)
        # True loop-closure measurement between last and first keyframe:
        # S_cur_loop = T_cur_w(true) ∘ T_loop_w(true)^-1, loop = KF 0.
        R_cl = true_R[K - 1] @ true_R[0].T
        t_cl = true_t[K - 1] - R_cl @ true_t[0]
        S12 = sim3.Sim3(
            jnp.asarray(1.0), jnp.asarray(R_cl), jnp.asarray(t_cl)
        )
        t0 = time.time()
        problem = lc._build_pose_graph(
            K - 1, 0, S12,
            s_all, store.kf_R[:K].copy(), store.kf_t[:K].copy(),
            s_all.copy(), store.kf_R[:K].copy(), store.kf_t[:K].copy(),
        )
        t_build = time.time() - t0
        n_edges = int(np.asarray(problem.e_valid).sum())
        assert n_edges >= K  # spanning tree + covis + loop edge
        t0 = time.time()
        out, chi2 = essential_graph.optimize_pose_graph(problem, num_iters=30)
        lc._apply_pose_graph(out, K)
        t_opt = time.time() - t0
        ate1 = store_ate(store, true_R, true_t)
        print(
            f"scale essential graph: K={K} edges={n_edges} build {t_build:.1f}s "
            f"opt {t_opt:.1f}s ate {ate0:.3f}->{ate1:.3f}"
        )
        assert ate1 < ate0 * 0.5  # the loop edge must pull drift back
