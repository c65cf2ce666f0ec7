"""Extrinsic calibration between sensor frames — batched GN on SE(3).

JAX equivalent of the reference's `CalibrationFactor`
(/root/reference/include/backend/lidarFactor.h:1551-1598), which refines the
camera<-lidar extrinsic T_ext from corresponding features: a lidar point
``p_l`` should land on its camera-frame target after ``x_c = T_ext p_l``.

Residuals supported (all batched + masked):
  * point-to-point:  r = T p_l - q_c                    (3,)
  * point-to-plane:  r = n . (T p_l) + d                (1,)

The solver is one jitted damped-GN loop over the pooled residual set —
the Ceres autodiff problem of the reference becomes a handful of fused
einsum/6x6 solves.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp

from ..geometry import se3, so3


def _dxc_ddelta(x_c: jnp.ndarray) -> jnp.ndarray:
    """d(T p)/d delta for the left-mult update T <- exp(delta) T: [I | -hat(x_c)]."""
    eye = jnp.broadcast_to(jnp.eye(3, dtype=x_c.dtype), x_c.shape[:-1] + (3, 3))
    return jnp.concatenate([eye, -so3.hat(x_c)], axis=-1)


def point_pair_residual_jac(T: se3.SE3, p_l, q_c):
    """r = T p_l - q_c. Returns (r (...,3), J (...,3,6))."""
    x_c = se3.act(T, p_l)
    return x_c - q_c, _dxc_ddelta(x_c)


def point_plane_residual_jac(T: se3.SE3, p_l, n_c, d_c):
    """r = n . (T p_l) + d. Returns (r (...,), J (...,6))."""
    x_c = se3.act(T, p_l)
    r = jnp.sum(n_c * x_c, axis=-1) + d_c
    J = jnp.einsum("...i,...ij->...j", n_c, _dxc_ddelta(x_c))
    return r, J


class CalibResult(NamedTuple):
    T: se3.SE3
    chi2: jnp.ndarray


@functools.partial(jax.jit, static_argnames=("num_iters",))
def calibrate_extrinsics(
    T0: se3.SE3,
    p_lidar: jnp.ndarray,  # (N, 3) lidar-frame points
    q_cam: jnp.ndarray,  # (N, 3) camera-frame targets
    pair_valid: jnp.ndarray,  # (N,) bool
    plane_p: Optional[jnp.ndarray] = None,  # (M, 3) lidar points on planes
    plane_n: Optional[jnp.ndarray] = None,  # (M, 3) camera-frame normals
    plane_d: Optional[jnp.ndarray] = None,  # (M,)
    plane_valid: Optional[jnp.ndarray] = None,  # (M,) bool
    num_iters: int = 10,
    damping: float = 1e-6,
) -> CalibResult:
    """Refine the extrinsic T (camera <- lidar) from correspondences."""

    def step(T, _):
        r, J = point_pair_residual_jac(T, p_lidar, q_cam)
        w = pair_valid.astype(r.dtype)
        H = jnp.einsum("nki,n,nkj->ij", J, w, J)
        b = jnp.einsum("nki,n,nk->i", J, w, r)
        chi2 = jnp.sum(w * jnp.sum(r * r, axis=-1))
        if plane_p is not None:
            rp, Jp = point_plane_residual_jac(T, plane_p, plane_n, plane_d)
            wp = plane_valid.astype(rp.dtype)
            H = H + jnp.einsum("ni,n,nj->ij", Jp, wp, Jp)
            b = b + jnp.einsum("ni,n,n->i", Jp, wp, rp)
            chi2 = chi2 + jnp.sum(wp * rp * rp)
        lam = damping * jnp.maximum(jnp.max(jnp.abs(jnp.diag(H))), 1e-12)
        dx = jnp.linalg.solve(H + lam * jnp.eye(6, dtype=H.dtype), -b)
        return se3.retract(T, dx), chi2

    T, chi2s = jax.lax.scan(step, T0, None, length=num_iters)
    return CalibResult(T=T, chi2=chi2s[-1])
