"""Batched SE(3) rigid transforms in JAX.

JAX replacement for Sophus `SE3d` (reference:
/root/reference/Thirdparty/Sophus/sophus/se3.hpp) and the cv::Mat pose algebra
scattered through the reference's `Converter`
(/root/reference/include/utils/Converter.h:67-200).

Storage convention: a transform is an `(R, t)` pair — rotation `(..., 3, 3)`
and translation `(..., 3)` — broadcastable over leading batch dims. Helpers
convert to/from homogeneous `(..., 4, 4)` matrices. Tangent vectors are 6-dim
``[rho(3), phi(3)]`` (translation first, then rotation), matching the
reference's mybackend `VertexPose::Plus` left-multiplicative update
(/root/reference/src/backend/mybackend/vertex_pose.cc:7-21).
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import jax.numpy as jnp

from . import so3


class SE3(NamedTuple):
    """Batched rigid transform: ``x_out = R @ x + t``."""

    R: jnp.ndarray  # (..., 3, 3)
    t: jnp.ndarray  # (..., 3)

    @property
    def batch_shape(self):
        return self.t.shape[:-1]

    def as_matrix(self) -> jnp.ndarray:
        return rt_to_matrix(self.R, self.t)


def identity(batch_shape: Tuple[int, ...] = (), dtype=jnp.float32) -> SE3:
    R = jnp.broadcast_to(jnp.eye(3, dtype=dtype), batch_shape + (3, 3))
    t = jnp.zeros(batch_shape + (3,), dtype=dtype)
    return SE3(R, t)


def from_matrix(T: jnp.ndarray) -> SE3:
    return SE3(T[..., :3, :3], T[..., :3, 3])


def rt_to_matrix(R: jnp.ndarray, t: jnp.ndarray) -> jnp.ndarray:
    batch = jnp.broadcast_shapes(R.shape[:-2], t.shape[:-1])
    T = jnp.zeros(batch + (4, 4), dtype=R.dtype)
    T = T.at[..., :3, :3].set(R)
    T = T.at[..., :3, 3].set(t)
    T = T.at[..., 3, 3].set(1.0)
    return T


def exp(xi: jnp.ndarray) -> SE3:
    """Exponential map se(3) -> SE(3). ``xi = [rho, phi]`` of shape (..., 6)."""
    rho, phi = xi[..., :3], xi[..., 3:]
    R = so3.exp(phi)
    V = so3.left_jacobian(phi)
    t = jnp.einsum("...ij,...j->...i", V, rho)
    return SE3(R, t)


def log(T: SE3) -> jnp.ndarray:
    """Logarithm map SE(3) -> se(3), returning (..., 6) ``[rho, phi]``."""
    phi = so3.log(T.R)
    Vinv = so3.left_jacobian_inv(phi)
    rho = jnp.einsum("...ij,...j->...i", Vinv, T.t)
    return jnp.concatenate([rho, phi], axis=-1)


def compose(a: SE3, b: SE3) -> SE3:
    """a ∘ b: apply b first, then a."""
    R = a.R @ b.R
    t = jnp.einsum("...ij,...j->...i", a.R, b.t) + a.t
    return SE3(R, t)


def inverse(T: SE3) -> SE3:
    Rinv = jnp.swapaxes(T.R, -1, -2)
    tinv = -jnp.einsum("...ij,...j->...i", Rinv, T.t)
    return SE3(Rinv, tinv)


def act(T: SE3, x: jnp.ndarray) -> jnp.ndarray:
    """Apply transform to points: (..., 3) or (..., N, 3)."""
    if x.ndim >= 2 and x.shape[-2] != 1 and T.t.ndim < x.ndim:
        # (..., N, 3) points with (..., 3, 3) rotation: batched matmul.
        return jnp.einsum("...ij,...nj->...ni", T.R, x) + T.t[..., None, :]
    return jnp.einsum("...ij,...j->...i", T.R, x) + T.t


def retract(T: SE3, delta: jnp.ndarray) -> SE3:
    """Left-multiplicative update ``exp(delta) ∘ T``.

    This is the optimizer's `Plus` (reference mybackend
    `vertex_pose.cc:7-21`: `SE3::exp(δ)·T`).
    """
    return compose(exp(delta), T)


def local_delta(T_new: SE3, T_ref: SE3) -> jnp.ndarray:
    """Inverse of `retract`: log(T_new ∘ T_ref^{-1})."""
    return log(compose(T_new, inverse(T_ref)))


def adjoint(T: SE3) -> jnp.ndarray:
    """SE(3) adjoint: (..., 6, 6) mapping tangent vectors between frames."""
    batch = T.t.shape[:-1]
    A = jnp.zeros(batch + (6, 6), dtype=T.R.dtype)
    A = A.at[..., :3, :3].set(T.R)
    A = A.at[..., 3:, 3:].set(T.R)
    A = A.at[..., :3, 3:].set(so3.hat(T.t) @ T.R)
    return A


def normalize(T: SE3) -> SE3:
    return SE3(so3.normalize(T.R), T.t)


def to_quat_trans(T: SE3) -> jnp.ndarray:
    """Pack to 7-vector [tx,ty,tz, qw,qx,qy,qz] (compact storage)."""
    return jnp.concatenate([T.t, so3.mat_to_quat(T.R)], axis=-1)


def from_quat_trans(v: jnp.ndarray) -> SE3:
    return SE3(so3.quat_to_mat(v[..., 3:]), v[..., :3])
