"""Relative-pose factors for SE(3) / Sim(3) pose graphs.

JAX equivalent of:
  * the Ceres `EndBackFactor` chain factors used by the LiDAR back-end
    pose graph (/root/reference/include/backend/lidarFactor.h:207-310,
    lidarOdom.cc:2467-2601)
  * g2o `EdgeSim3` edges of the essential-graph optimization
    (/root/reference/src/backend/g2oOptimizer.cc:1212-1560).

Residual convention (g2o EdgeSim3): for poses ``S_iw, S_jw`` (world->frame)
and measurement ``S_ji = S_jw ∘ S_iw^{-1}``,

    r = log( S_ji_meas ∘ S_iw ∘ S_jw^{-1} )

which vanishes when the poses agree with the measurement. Jacobians w.r.t.
the left-multiplicative tangents of both endpoints are obtained by forward-
mode autodiff at delta = 0 (same role as g2o's numeric Jacobians here — the
pose graph is not the per-edge-count hot path, and jacfwd of a 6/7-dim map
is cheap and exact).
"""

from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp

from ..geometry import se3, sim3


def se3_relative_residual(T_iw: se3.SE3, T_jw: se3.SE3, T_ji_meas: se3.SE3) -> jnp.ndarray:
    """r = log(T_ji_meas ∘ T_iw ∘ T_jw^{-1}), shape (..., 6)."""
    return se3.log(se3.compose(T_ji_meas, se3.compose(T_iw, se3.inverse(T_jw))))


def se3_relative_residual_jac(
    T_iw: se3.SE3, T_jw: se3.SE3, T_ji_meas: se3.SE3
) -> Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """Residual + Jacobians w.r.t. left-mult tangents of T_iw and T_jw.

    Returns (r (...,6), J_i (...,6,6), J_j (...,6,6)). Batched inputs are
    vmapped edge-wise (each edge gets its own (6,6) endpoint Jacobians).
    """

    def single(T_i, T_j, T_meas):
        def res(di, dj):
            return se3_relative_residual(
                se3.retract(T_i, di), se3.retract(T_j, dj), T_meas
            )

        zero = jnp.zeros(6, dtype=T_i.t.dtype)
        r = res(zero, zero)
        J_i = jax.jacfwd(res, argnums=0)(zero, zero)
        J_j = jax.jacfwd(res, argnums=1)(zero, zero)
        return r, J_i, J_j

    if T_iw.t.ndim == 1:
        return single(T_iw, T_jw, T_ji_meas)
    fn = single
    for _ in range(T_iw.t.ndim - 1):
        fn = jax.vmap(fn)
    return fn(T_iw, T_jw, T_ji_meas)


def sim3_relative_residual(S_iw: sim3.Sim3, S_jw: sim3.Sim3, S_ji_meas: sim3.Sim3) -> jnp.ndarray:
    """r = log(S_ji_meas ∘ S_iw ∘ S_jw^{-1}), shape (..., 7)."""
    return sim3.log(sim3.compose(S_ji_meas, sim3.compose(S_iw, sim3.inverse(S_jw))))


def sim3_relative_residual_jac(
    S_iw: sim3.Sim3, S_jw: sim3.Sim3, S_ji_meas: sim3.Sim3
) -> Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """Residual + Jacobians w.r.t. left-mult 7-dim tangents of both endpoints.

    Batched inputs (leading dims) are vmapped edge-wise so each edge gets its
    own (7, 7) endpoint Jacobians (no cross-edge terms).
    """

    def single(S_i, S_j, S_meas):
        def res(di, dj):
            return sim3_relative_residual(
                sim3.retract(S_i, di), sim3.retract(S_j, dj), S_meas
            )

        zero = jnp.zeros(7, dtype=S_i.t.dtype)
        r = res(zero, zero)
        J_i = jax.jacfwd(res, argnums=0)(zero, zero)
        J_j = jax.jacfwd(res, argnums=1)(zero, zero)
        return r, J_i, J_j

    if S_iw.t.ndim == 1:
        return single(S_iw, S_jw, S_ji_meas)
    fn = single
    for _ in range(S_iw.t.ndim - 1):
        fn = jax.vmap(fn)
    return fn(S_iw, S_jw, S_ji_meas)
