"""Analytic LiDAR residuals + Jacobians, batched over associated features.

JAX equivalent of:
  * g2o `EdgeLidarFlatPoint` (point-to-plane) and `EdgeLidarCornerPoint`
    (point-to-point) unary edges added by the reference author
    (/root/reference/Thirdparty/g2o/g2o/types/types_six_dof_expmap.h:205-262,
    used in g2oOptimizer.cc:560-641 and :978-1117)
  * Ceres `LidarPlaneNormFactor` / `LidarDistanceFactor` / `LidarEdgeFactor`
    (/root/reference/include/backend/lidarFactor.h:44,153,360) used by the
    LOAM-style odometry (lidarOdom.cc:1369-1572).

Frames & conventions
--------------------
A LiDAR feature point ``p_s`` lives in the *sensor/camera frame of the current
frame* (the reference transforms feature clouds into the camera frame at
Frame construction, Frame.cc:461-466). The local map (targets / planes) lives
in the *world frame*. With the tracked pose ``T_cw`` (world -> camera), the
feature's world position is ``p_w = T_cw^{-1} p_s = R^T (p_s - t)``.

Left-multiplicative update on T_cw (``T <- exp(delta) T``) gives
``d p_w / d rho = -R^T`` and ``d p_w / d phi = R^T hat(p_s)``.
"""

from __future__ import annotations

from typing import Tuple

import jax.numpy as jnp

from ..geometry import se3, so3


def point_world(T_cw: se3.SE3, p_s: jnp.ndarray) -> jnp.ndarray:
    """Map sensor-frame points (..., 3) to world via T_cw^{-1}."""
    Rt = jnp.swapaxes(T_cw.R, -1, -2)
    return jnp.einsum("...ij,...j->...i", Rt, p_s - T_cw.t)


def _dpw_ddelta(T_cw: se3.SE3, p_s: jnp.ndarray) -> jnp.ndarray:
    """d p_w / d delta: (..., 3, 6) = R^T [ -I | hat(p_s) ]."""
    Rt = jnp.swapaxes(T_cw.R, -1, -2)
    left = -jnp.broadcast_to(Rt, p_s.shape[:-1] + (3, 3))
    right = Rt @ so3.hat(p_s)
    return jnp.concatenate([left, right], axis=-1)


def plane_residual_jac(
    T_cw: se3.SE3,
    p_s: jnp.ndarray,
    plane_n: jnp.ndarray,
    plane_d: jnp.ndarray,
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Point-to-plane: r = n . p_w + d (scalar per feature).

    Matches `EdgeLidarFlatPoint` (info = 50 * I in the reference,
    g2oOptimizer.cc:600-620) / `LidarPlaneNormFactor` (lidarFactor.h:153).
    Returns (r (...,), J (..., 6)).
    """
    p_w = point_world(T_cw, p_s)
    r = jnp.sum(plane_n * p_w, axis=-1) + plane_d
    J = jnp.einsum("...i,...ij->...j", plane_n, _dpw_ddelta(T_cw, p_s))
    return r, J


def point_residual_jac(
    T_cw: se3.SE3, p_s: jnp.ndarray, target_w: jnp.ndarray
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Point-to-point: r = p_w - q_w (3-vector per feature).

    Matches `EdgeLidarCornerPoint` (info = 30 * I, g2oOptimizer.cc:560-600) /
    `LidarDistanceFactor` (lidarFactor.h:44). Returns (r (...,3), J (...,3,6)).
    """
    r = point_world(T_cw, p_s) - target_w
    J = _dpw_ddelta(T_cw, p_s)
    return r, J


def edge_line_residual_jac(
    T_cw: se3.SE3,
    p_s: jnp.ndarray,
    line_a: jnp.ndarray,
    line_b: jnp.ndarray,
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Point-to-line (classic LOAM corner): r = |(p-a) x (p-b)| / |a-b| direction.

    Vector form (3-dim residual = cross / |ab|), matching
    `LidarEdgeFactor` (lidarFactor.h:360). Returns (r (...,3), J (...,3,6)).
    """
    p_w = point_world(T_cw, p_s)
    ab = line_a - line_b
    ab_norm = jnp.maximum(jnp.linalg.norm(ab, axis=-1, keepdims=True), 1e-9)
    u = ab / ab_norm  # unit line direction
    r = jnp.cross(p_w - line_a, u)
    # d r / d p_w = -hat(u)  (since r = (p - a) x u)
    J = -so3.hat(u) @ _dpw_ddelta(T_cw, p_s)
    return r, J
