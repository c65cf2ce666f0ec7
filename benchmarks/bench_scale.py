"""KITTI-00-class whole-map benchmark: essential graph + global BA at scale.

Builds the 600-KF / 1.2e5-landmark synthetic map (eval/scale.py — the
driver's "KITTI 00-02 global BA at scale" regime), closes the ring with a
true loop edge through the essential graph, then runs the matrix-free PCG
global BA, reporting wall time and Umeyama-aligned ATE at each stage.

Usage:  python benchmarks/bench_scale.py [--kfs 600] [--lms 120000]
        (add JAX_PLATFORMS=cpu for a host check; device numbers come from
        GPU runs and are recorded in PERF.md)
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--kfs", type=int, default=600)
    ap.add_argument("--lms", type=int, default=120_000)
    ap.add_argument("--obs-per-lm", type=int, default=5)
    ap.add_argument("--gba-iters", type=int, default=10)
    args = ap.parse_args()

    import jax

    from sqrtlm_slam_tpu.utils.cache import configure_jax

    configure_jax()

    import numpy as np
    from jax import numpy as jnp

    from sqrtlm_slam_tpu.eval.scale import make_scale_store, store_ate
    from sqrtlm_slam_tpu.eval.synthetic import DEFAULT_CAM
    from sqrtlm_slam_tpu.geometry import sim3
    from sqrtlm_slam_tpu.loop import LoopCloser, LoopClosingConfig, essential_graph
    from sqrtlm_slam_tpu.loop.closing import gather_global_problem_bucketed
    from sqrtlm_slam_tpu.optim import schur_bucketed as sb

    t0 = time.time()
    store, true_R, true_t = make_scale_store(
        n_kf=args.kfs, n_lm=args.lms, obs_per_lm=args.obs_per_lm, drift=4e-4
    )
    ate_drift = store_ate(store, true_R, true_t)
    print(f"[scale] built {args.kfs} KFs / {args.lms} lms in "
          f"{time.time() - t0:.1f}s, drift ATE {ate_drift:.3f} m",
          file=sys.stderr, flush=True)

    lc = LoopCloser(
        store, DEFAULT_CAM,
        cfg=LoopClosingConfig(
            edge_cap=16384, gba_iters=args.gba_iters, gba_chunk=args.gba_iters,
        ),
    )
    K = store.num_kf
    R_cl = true_R[K - 1] @ true_R[0].T
    t_cl = true_t[K - 1] - R_cl @ true_t[0]
    S12 = sim3.Sim3(jnp.asarray(1.0), jnp.asarray(R_cl), jnp.asarray(t_cl))
    s_all = np.ones(K, np.float32)

    t0 = time.time()
    problem = lc._build_pose_graph(
        K - 1, 0, S12,
        s_all, store.kf_R[:K].copy(), store.kf_t[:K].copy(),
        s_all.copy(), store.kf_R[:K].copy(), store.kf_t[:K].copy(),
    )
    t_build = time.time() - t0
    t0 = time.time()
    out, _ = essential_graph.optimize_pose_graph(problem, num_iters=30)
    lc._apply_pose_graph(out, K)
    t_eg = time.time() - t0
    ate_eg = store_ate(store, true_R, true_t)
    print(f"[scale] essential graph: build {t_build:.1f}s opt {t_eg:.1f}s "
          f"ATE {ate_drift:.3f} -> {ate_eg:.3f}", file=sys.stderr, flush=True)

    p0, _ = gather_global_problem_bucketed(store)
    chi0 = float(sb.chi2_only(p0, DEFAULT_CAM, p0.obs_valid, None))
    # Pre-warm the exact jitted GBA graph (same shapes + num_iters) so the
    # recorded wall time is the WARM 10-iteration cost, not the compile.
    t0 = time.time()
    _, _, warm_chi2 = sb.global_ba_cg(p0, DEFAULT_CAM, num_iters=args.gba_iters)
    warm_chi2.block_until_ready()
    t_compile = time.time() - t0
    t0 = time.time()
    ok = lc.run_global_ba()
    t_gba = time.time() - t0
    p1, _ = gather_global_problem_bucketed(store)
    chi1 = float(sb.chi2_only(p1, DEFAULT_CAM, p1.obs_valid, None))
    ate_gba = store_ate(store, true_R, true_t)
    edges = int(p0.obs_valid.sum())
    print(json.dumps({
        "metric": "scale_gba",
        "kfs": args.kfs, "landmarks": args.lms, "edges": edges,
        "gba_iters": args.gba_iters, "gba_s": round(t_gba, 2),
        "gba_compile_s": round(t_compile, 2),
        "gba_completed": bool(ok),
        "chi2_before": round(chi0, 1), "chi2_after": round(chi1, 1),
        "ate_drift_m": round(ate_drift, 4),
        "ate_after_loop_m": round(ate_eg, 4),
        "ate_after_gba_m": round(ate_gba, 4),
        "essential_graph_s": round(t_build + t_eg, 2),
        "device": jax.devices()[0].platform,
    }))


if __name__ == "__main__":
    main()
