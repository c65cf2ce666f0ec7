"""Optimizer facade — interchangeable backends behind one interface.

Mirrors the reference's `Optimizer` facade (`Optimizer.h:50-69`, backend
dispatch at `Optimizer.cc:26-107`) which switches between three backends
(g2o / Ceres / mybackend) by compile-time flags. Here the three backends
are the JAX engines, selected at runtime per instance:

  * ``"bucketed"`` (default) — the landmark-bucketed sqrt-Schur engine with
    its rows-layout assembly (optim/schur_bucketed.py). Plays the
    role of the reference's default g2o path.
  * ``"flat"`` — the flat-edge dense-W Schur engine (optim/schur.py): the
    independently-implemented engine the bucketed one is validated against,
    i.e. the role of the CeresOptimizer alternative backend.
  * ``"cg"`` — matrix-free Schur + block-Jacobi PCG (the whole-map-scale
    path), analogous to mybackend's kept PCG solver (problem.cc:771-801).

All methods take/return the same types regardless of backend; local BA
always speaks `BucketedBAProblem` (the map store's native layout) and
converts for the flat engine internally. Pose optimization, essential-graph
optimization and Sim3 refinement are backend-independent (pose-only
problems solve directly in every reference backend too,
problem.cc:449-454), so they dispatch to the single shared implementation.
"""

from __future__ import annotations

from typing import Optional, Tuple

import jax
import jax.numpy as jnp

from . import pose_opt, schur, schur_bucketed

BACKENDS = ("bucketed", "flat", "cg")


def bucketed_to_flat(problem: schur_bucketed.BucketedBAProblem) -> schur.BAProblem:
    """Flatten a (L, K)-bucketed problem to the flat (E,) edge layout."""
    L, K = problem.obs_cam.shape
    obs_pt = jnp.repeat(jnp.arange(L, dtype=jnp.int32), K)
    return schur.BAProblem(
        pose_R=problem.pose_R,
        pose_t=problem.pose_t,
        pose_fixed=problem.pose_fixed,
        pose_valid=problem.pose_valid,
        points=problem.points,
        point_valid=problem.point_valid,
        obs_cam=problem.obs_cam.reshape(-1),
        obs_pt=obs_pt,
        obs_uvr=problem.obs_uvr.reshape(L * K, 3),
        obs_inv_sigma2=problem.obs_inv_sigma2.reshape(-1),
        obs_valid=problem.obs_valid.reshape(-1),
    )


def _writeback_bucketed(
    problem: schur_bucketed.BucketedBAProblem, flat: schur.BAProblem, survivors
) -> Tuple[schur_bucketed.BucketedBAProblem, jnp.ndarray]:
    """Fold flat-engine results back into the bucketed layout."""
    L, K = problem.obs_cam.shape
    out = problem._replace(
        pose_R=flat.pose_R, pose_t=flat.pose_t, points=flat.points
    )
    return out, survivors.reshape(L, K)


class Optimizer:
    """Runtime-selectable optimization backend (reference: Optimizer.cc:26-28
    chooses g2o/Ceres/mybackend with compile-time constants)."""

    def __init__(self, backend: str = "bucketed"):
        if backend not in BACKENDS:
            raise ValueError(f"unknown backend {backend!r}; pick from {BACKENDS}")
        self.backend = backend

    # -- PoseOptimization (Optimizer.h:56, g2oOptimizer.cc:385-679) ---------

    def pose_optimization(
        self,
        pose0,
        obs: pose_opt.VisualObs,
        cam,
        lidar_obs: Optional[pose_opt.LidarObs] = None,
        **kwargs,
    ) -> pose_opt.PoseOptResult:
        return pose_opt.optimize_pose(pose0, obs, cam, lidar_obs=lidar_obs, **kwargs)

    # -- LocalBundleAdjustment (Optimizer.h:58, g2oOptimizer.cc:704-1191) ---

    def local_bundle_adjustment(
        self,
        problem: schur_bucketed.BucketedBAProblem,
        cam,
        first_iters: int = 5,
        second_iters: int = 10,
    ):
        """Two-phase local BA (5 robust iters -> gate -> 10 iters).

        Returns (problem, survivors (L, K) bool, chi2) for every backend."""
        if self.backend == "flat":
            flat = bucketed_to_flat(problem)
            out, survivors, stats = schur.local_ba(
                flat, cam, first_iters=first_iters, second_iters=second_iters
            )
            out_b, surv_b = _writeback_bucketed(problem, out, survivors)
            return out_b, surv_b, stats.chi2
        if self.backend == "cg":
            return _local_ba_cg(problem, cam, first_iters, second_iters)
        return schur_bucketed.local_ba(
            problem, cam, first_iters=first_iters, second_iters=second_iters
        )

    # -- GlobalBundleAdjustemnt [sic] (Optimizer.h:52, g2oOptimizer.cc:80) --

    def global_bundle_adjustment(
        self,
        problem: schur_bucketed.BucketedBAProblem,
        cam,
        num_iters: int = 20,
    ):
        """Whole-map BA, 20 robust iterations. Returns (problem, survivors,
        chi2)."""
        if self.backend == "flat":
            flat = bucketed_to_flat(problem)
            out, survivors, stats = schur.global_ba(flat, cam, num_iters=num_iters)
            out_b, surv_b = _writeback_bucketed(problem, out, survivors)
            return out_b, surv_b, stats.chi2
        # bucketed + cg both use the matrix-free CG engine at map scale
        # (the dense cross factor does not fit for 10^3 KFs x 10^5 points).
        return schur_bucketed.global_ba_cg(problem, cam, num_iters=num_iters)

    # -- OptimizeEssentialGraph (Optimizer.h:62, g2oOptimizer.cc:1212) ------

    def optimize_essential_graph(self, problem, num_iters: int = 20, **kwargs):
        from ..loop import essential_graph

        return essential_graph.optimize_pose_graph(
            problem, num_iters=num_iters, **kwargs
        )

    # -- OptimizeSim3 (Optimizer.h:66, g2oOptimizer.cc:1560-1796) -----------

    def optimize_sim3(self, *args, **kwargs):
        from ..loop import sim3_solver

        return sim3_solver.optimize_sim3(*args, **kwargs)


def _local_ba_cg(
    problem: schur_bucketed.BucketedBAProblem,
    cam,
    first_iters: int,
    second_iters: int,
):
    """Local-BA protocol on the matrix-free CG step (backend="cg")."""
    import math

    from . import loss as losses

    delta2 = math.sqrt(losses.CHI2_2DOF)
    problem, _, _ = schur_bucketed.ba_iterate_cg(
        problem, cam, problem.obs_valid, first_iters, robust_delta=delta2
    )
    is_stereo = problem.obs_uvr[..., 2] >= 0.0
    gate = jnp.where(is_stereo, losses.CHI2_3DOF, losses.CHI2_2DOF)
    e2, z = schur_bucketed.edge_chi2_and_depth(problem, cam)
    active = problem.obs_valid & (e2 <= gate) & (z > 0)
    problem, chi2, _ = schur_bucketed.ba_iterate_cg(
        problem, cam, active, second_iters, robust_delta=None
    )
    e2, z = schur_bucketed.edge_chi2_and_depth(problem, cam)
    survivors = problem.obs_valid & (e2 <= gate) & (z > 0)
    return problem, survivors, chi2
