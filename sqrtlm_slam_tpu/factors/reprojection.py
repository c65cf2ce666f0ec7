"""Analytic reprojection residuals + Jacobians, batched over edges.

JAX equivalent of the reference's reprojection edges:
  * g2o `EdgeSE3ProjectXYZOnlyPose` / `EdgeSE3ProjectXYZ`
    (used in /root/reference/src/backend/g2oOptimizer.cc:385-679, :704-1191)
  * mybackend `EdgeReprojectionPoseOnly` / `EdgeReprojectionXYZ` with analytic
    2x6 / 2x3 Jacobians (/root/reference/src/backend/mybackend/edge_reprojection.cc:67-130)
  * stereo variants used for the RGBD/FUSION depth observations.

Conventions
-----------
Pose ``T = T_cw`` maps world -> camera (ORB-SLAM convention). The optimizer
update is left-multiplicative on T_cw: ``T <- exp(delta) T`` with tangent
``delta = [rho(3), phi(3)]`` (se3.retract). All functions broadcast over
leading batch dims; feed them edge-arrays of shape (E, ...).

Jacobian derivation (pose): with ``x_c = R X_w + t`` and the left-mult update,
``d x_c / d rho = I`` and ``d x_c / d phi = -hat(x_c)``; chain with the
projection derivative. Point Jacobian: ``d x_c / d X_w = R``.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import jax.numpy as jnp

from ..geometry import se3, so3

_ZEPS = 1e-6


class Camera(NamedTuple):
    """Pinhole intrinsics (+ stereo baseline*fx, the reference's ``bf``)."""

    fx: float
    fy: float
    cx: float
    cy: float
    bf: float = 0.0  # baseline * fx; KITTI cfg value 386.1448 (cfg/KITTI04-12.yaml)

    def project(self, x_cam: jnp.ndarray) -> jnp.ndarray:
        """Project camera-frame points (..., 3) to pixels (..., 2)."""
        z = jnp.maximum(x_cam[..., 2], _ZEPS)
        u = self.fx * x_cam[..., 0] / z + self.cx
        v = self.fy * x_cam[..., 1] / z + self.cy
        return jnp.stack([u, v], axis=-1)

    def backproject(self, uv: jnp.ndarray, depth: jnp.ndarray) -> jnp.ndarray:
        """Unproject pixels (..., 2) at given depth (...,) to camera frame."""
        x = (uv[..., 0] - self.cx) * depth / self.fx
        y = (uv[..., 1] - self.cy) * depth / self.fy
        return jnp.stack([x, y, depth], axis=-1)


def transform_points(T_cw: se3.SE3, X_w: jnp.ndarray) -> jnp.ndarray:
    return se3.act(T_cw, X_w)


def _proj_jacobian(cam: Camera, x_c: jnp.ndarray) -> jnp.ndarray:
    """d(u,v)/d x_c: (..., 2, 3)."""
    x, y = x_c[..., 0], x_c[..., 1]
    z = jnp.maximum(x_c[..., 2], _ZEPS)
    iz = 1.0 / z
    iz2 = iz * iz
    zero = jnp.zeros_like(x)
    row_u = jnp.stack([cam.fx * iz, zero, -cam.fx * x * iz2], axis=-1)
    row_v = jnp.stack([zero, cam.fy * iz, -cam.fy * y * iz2], axis=-1)
    return jnp.stack([row_u, row_v], axis=-2)


def _pose_chain(x_c: jnp.ndarray) -> jnp.ndarray:
    """d x_c / d delta for the left-mult update: (..., 3, 6) = [I | -hat(x_c)]."""
    eye = jnp.broadcast_to(jnp.eye(3, dtype=x_c.dtype), x_c.shape[:-1] + (3, 3))
    return jnp.concatenate([eye, -so3.hat(x_c)], axis=-1)


def mono_residual_jac(
    T_cw: se3.SE3, X_w: jnp.ndarray, uv_obs: jnp.ndarray, cam: Camera
) -> Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """Monocular reprojection: returns (r (...,2), J_pose (...,2,6), J_point (...,2,3)).

    Residual convention ``r = proj(T X) - uv_obs`` (sign matches a Gauss-Newton
    step ``H dx = -b`` with ``b = J^T W r``).
    """
    x_c = se3.act(T_cw, X_w)
    r = cam.project(x_c) - uv_obs
    dproj = _proj_jacobian(cam, x_c)
    J_pose = dproj @ _pose_chain(x_c)
    J_point = dproj @ T_cw.R
    return r, J_pose, J_point


def stereo_residual_jac(
    T_cw: se3.SE3, X_w: jnp.ndarray, uvr_obs: jnp.ndarray, cam: Camera
) -> Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """Stereo reprojection (u_left, v_left, u_right): (r (...,3), J (...,3,6), (...,3,3)).

    ``u_right = u_left - bf / z`` — the ORB-SLAM2 stereo/RGBD observation model
    used by the reference for LiDAR-depth-initialized keypoints.
    """
    x_c = se3.act(T_cw, X_w)
    x, y = x_c[..., 0], x_c[..., 1]
    z = jnp.maximum(x_c[..., 2], _ZEPS)
    iz = 1.0 / z
    iz2 = iz * iz
    u = cam.fx * x * iz + cam.cx
    v = cam.fy * y * iz + cam.cy
    ur = u - cam.bf * iz
    r = jnp.stack([u, v, ur], axis=-1) - uvr_obs

    zero = jnp.zeros_like(x)
    row_u = jnp.stack([cam.fx * iz, zero, -cam.fx * x * iz2], axis=-1)
    row_v = jnp.stack([zero, cam.fy * iz, -cam.fy * y * iz2], axis=-1)
    row_r = jnp.stack(
        [cam.fx * iz, zero, -cam.fx * x * iz2 + cam.bf * iz2], axis=-1
    )
    dproj = jnp.stack([row_u, row_v, row_r], axis=-2)  # (..., 3, 3)
    J_pose = dproj @ _pose_chain(x_c)
    J_point = dproj @ T_cw.R
    return r, J_pose, J_point


def depth_residual_jac(
    T_cw: se3.SE3, X_w: jnp.ndarray, inv_uvd_obs: jnp.ndarray, cam: Camera
):
    """(u, v, depth) observation variant; kept for RGBD-style direct depth."""
    x_c = se3.act(T_cw, X_w)
    uv = cam.project(x_c)
    r = jnp.concatenate([uv - inv_uvd_obs[..., :2], (x_c[..., 2:] - inv_uvd_obs[..., 2:])], axis=-1)
    dproj = _proj_jacobian(cam, x_c)
    dz = jnp.broadcast_to(
        jnp.array([0.0, 0.0, 1.0], dtype=x_c.dtype), x_c.shape[:-1] + (3,)
    )[..., None, :]
    dfull = jnp.concatenate([dproj, dz], axis=-2)  # (..., 3, 3)
    J_pose = dfull @ _pose_chain(x_c)
    J_point = dfull @ T_cw.R
    return r, J_pose, J_point
