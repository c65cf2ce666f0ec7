"""Batched SO(3) Lie-group operations in JAX.

JAX replacement for the vendored Sophus `SO3d`
(reference: /root/reference/Thirdparty/Sophus/sophus/so3.hpp) and the rotation
parts of `Converter` (/root/reference/include/utils/Converter.h:67-200).

All functions broadcast over arbitrary leading batch dimensions; rotations are
stored as 3x3 matrices (batched 3x3 matmuls fuse well under XLA). Quaternion helpers are provided for compact storage /
interpolation. Small-angle branches use Taylor expansions selected with
`jnp.where` so everything stays jit- and vmap-safe.
"""

from __future__ import annotations

import jax.numpy as jnp

_EPS = 1e-8


def hat(w: jnp.ndarray) -> jnp.ndarray:
    """so(3) hat operator: (..., 3) -> (..., 3, 3) skew-symmetric matrix."""
    wx, wy, wz = w[..., 0], w[..., 1], w[..., 2]
    zero = jnp.zeros_like(wx)
    return jnp.stack(
        [
            jnp.stack([zero, -wz, wy], axis=-1),
            jnp.stack([wz, zero, -wx], axis=-1),
            jnp.stack([-wy, wx, zero], axis=-1),
        ],
        axis=-2,
    )


def vee(W: jnp.ndarray) -> jnp.ndarray:
    """Inverse of `hat`: (..., 3, 3) -> (..., 3)."""
    return jnp.stack([W[..., 2, 1], W[..., 0, 2], W[..., 1, 0]], axis=-1)


def exp(w: jnp.ndarray) -> jnp.ndarray:
    """Exponential map so(3) -> SO(3) via Rodrigues, (..., 3) -> (..., 3, 3).

    Uses Taylor series for ``sin(t)/t`` and ``(1-cos(t))/t^2`` near zero so the
    map is exact and differentiable at the identity.
    """
    theta2 = jnp.sum(w * w, axis=-1)
    theta = jnp.sqrt(theta2 + _EPS * _EPS)
    small = theta2 < 1e-8

    # sin(theta)/theta and (1 - cos(theta))/theta^2 with Taylor fallbacks.
    a = jnp.where(small, 1.0 - theta2 / 6.0, jnp.sin(theta) / theta)
    b = jnp.where(small, 0.5 - theta2 / 24.0, (1.0 - jnp.cos(theta)) / theta2)

    W = hat(w)
    W2 = W @ W
    eye = jnp.broadcast_to(jnp.eye(3, dtype=w.dtype), W.shape)
    return eye + a[..., None, None] * W + b[..., None, None] * W2


def log(R: jnp.ndarray) -> jnp.ndarray:
    """Logarithm map SO(3) -> so(3), (..., 3, 3) -> (..., 3).

    Routed through the quaternion (Shepperd's largest-pivot extraction) which
    is numerically stable in every regime — small angle, generic, and near pi
    — unlike the classic ``theta / (2 sin theta) * vee(R - R^T)`` formula
    whose denominator vanishes at pi.
    """
    q = mat_to_quat(R)  # canonical hemisphere: qw >= 0
    qw, xyz = q[..., 0], q[..., 1:]
    # norm() has a NaN derivative at 0 (the identity rotation — exactly where
    # pose-graph residuals of consistent edges sit); the eps-smoothed sqrt
    # keeps jacfwd finite there.
    sin_half = jnp.sqrt(jnp.sum(xyz * xyz, axis=-1) + _EPS * _EPS)
    theta = 2.0 * jnp.arctan2(sin_half, qw)
    small = sin_half < 1e-6
    # w = (theta / sin(theta/2)) * xyz; Taylor near zero: scale -> 2 + theta^2/12.
    scale = jnp.where(
        small,
        2.0 + theta * theta / 12.0,
        theta / jnp.where(small, 1.0, sin_half),
    )
    return scale[..., None] * xyz


def left_jacobian(w: jnp.ndarray) -> jnp.ndarray:
    """SO(3) left Jacobian J_l(w): (..., 3) -> (..., 3, 3).

    Used by the SE(3) exponential (the `V` matrix in Sophus se3.hpp).
    """
    theta2 = jnp.sum(w * w, axis=-1)
    theta = jnp.sqrt(theta2 + _EPS * _EPS)
    small = theta2 < 1e-8
    b = jnp.where(small, 0.5 - theta2 / 24.0, (1.0 - jnp.cos(theta)) / theta2)
    c = jnp.where(
        small, 1.0 / 6.0 - theta2 / 120.0, (theta - jnp.sin(theta)) / (theta2 * theta)
    )
    W = hat(w)
    W2 = W @ W
    eye = jnp.broadcast_to(jnp.eye(3, dtype=w.dtype), W.shape)
    return eye + b[..., None, None] * W + c[..., None, None] * W2


def left_jacobian_inv(w: jnp.ndarray) -> jnp.ndarray:
    """Inverse SO(3) left Jacobian, (..., 3) -> (..., 3, 3)."""
    theta2 = jnp.sum(w * w, axis=-1)
    theta = jnp.sqrt(theta2 + _EPS * _EPS)
    small = theta2 < 1e-8
    half = 0.5 * theta
    cot = jnp.where(small, 1.0, jnp.cos(half) / jnp.where(small, 1.0, jnp.sin(half)))
    k = jnp.where(
        small,
        1.0 / 12.0 + theta2 / 720.0,
        (1.0 - half * cot) / jnp.where(small, 1.0, theta2),
    )
    W = hat(w)
    W2 = W @ W
    eye = jnp.broadcast_to(jnp.eye(3, dtype=w.dtype), W.shape)
    return eye - 0.5 * W + k[..., None, None] * W2


def normalize(R: jnp.ndarray) -> jnp.ndarray:
    """Re-orthonormalize a rotation matrix via SVD-free Gram-Schmidt.

    Cheap drift correction applied after long chains of composes (the
    reference relies on Sophus/Eigen quaternion renormalization instead).
    """
    x = R[..., :, 0]
    y = R[..., :, 1]
    x = x / jnp.maximum(jnp.linalg.norm(x, axis=-1, keepdims=True), _EPS)
    y = y - jnp.sum(x * y, axis=-1, keepdims=True) * x
    y = y / jnp.maximum(jnp.linalg.norm(y, axis=-1, keepdims=True), _EPS)
    z = jnp.cross(x, y)
    return jnp.stack([x, y, z], axis=-1)


# ----------------------------------------------------------------------------
# Quaternion helpers (w, x, y, z) — compact storage & Sim3/loop-closure code.
# ----------------------------------------------------------------------------


def quat_to_mat(q: jnp.ndarray) -> jnp.ndarray:
    """Unit quaternion (..., 4) [w,x,y,z] -> rotation matrix (..., 3, 3)."""
    q = q / jnp.maximum(jnp.linalg.norm(q, axis=-1, keepdims=True), _EPS)
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    return jnp.stack(
        [
            jnp.stack(
                [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
                axis=-1,
            ),
            jnp.stack(
                [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
                axis=-1,
            ),
            jnp.stack(
                [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
                axis=-1,
            ),
        ],
        axis=-2,
    )


def mat_to_quat(R: jnp.ndarray) -> jnp.ndarray:
    """Rotation matrix (..., 3, 3) -> unit quaternion (..., 4) [w,x,y,z].

    Branch-free Shepperd's method: compute all four candidate quaternions and
    select by the largest pivot (jit/vmap safe).
    """
    m00, m01, m02 = R[..., 0, 0], R[..., 0, 1], R[..., 0, 2]
    m10, m11, m12 = R[..., 1, 0], R[..., 1, 1], R[..., 1, 2]
    m20, m21, m22 = R[..., 2, 0], R[..., 2, 1], R[..., 2, 2]
    tr = m00 + m11 + m22

    def safe_sqrt(x):
        return jnp.sqrt(jnp.maximum(x, _EPS))

    qw0 = safe_sqrt(1.0 + tr)  # 2*w candidates (unnormalized)
    q0 = jnp.stack([qw0 * qw0, (m21 - m12), (m02 - m20), (m10 - m01)], axis=-1)
    qx1 = safe_sqrt(1.0 + m00 - m11 - m22)
    q1 = jnp.stack([(m21 - m12), qx1 * qx1, (m01 + m10), (m02 + m20)], axis=-1)
    qy2 = safe_sqrt(1.0 - m00 + m11 - m22)
    q2 = jnp.stack([(m02 - m20), (m01 + m10), qy2 * qy2, (m12 + m21)], axis=-1)
    qz3 = safe_sqrt(1.0 - m00 - m11 + m22)
    q3 = jnp.stack([(m10 - m01), (m02 + m20), (m12 + m21), qz3 * qz3], axis=-1)

    pivots = jnp.stack(
        [1.0 + tr, 1.0 + m00 - m11 - m22, 1.0 - m00 + m11 - m22, 1.0 - m00 - m11 + m22],
        axis=-1,
    )
    idx = jnp.argmax(pivots, axis=-1)
    qs = jnp.stack([q0, q1, q2, q3], axis=-2)  # (..., 4 candidates, 4)
    q = jnp.take_along_axis(qs, idx[..., None, None], axis=-2)[..., 0, :]
    q = q * jnp.where(q[..., :1] < 0, -1.0, 1.0)  # canonical hemisphere
    return q / jnp.maximum(jnp.linalg.norm(q, axis=-1, keepdims=True), _EPS)
