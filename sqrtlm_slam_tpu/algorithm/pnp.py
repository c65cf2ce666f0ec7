"""Robust camera-pose estimation from 2D/3D matches — RANSAC, batched.

JAX replacement of `PnPsolver` (EPnP + RANSAC,
/root/reference/src/algorithm/PnPsolver.cc:247-1491), used by
relocalization (Tracking.cc:2334-2554) and as the no-prior fallback in
tracking. Two estimators:

  * `ransac_pose_3d3d` — when the frame keypoint carries (LiDAR/stereo)
    depth, each match is a 3D-3D pair (backprojected camera point vs
    landmark world point) and the minimal solver is Horn's closed form —
    strictly stronger than EPnP's 2D-3D geometry and a single batched SVD
    for the whole hypothesis bank (SURVEY §7.0: vmapped RANSAC).
  * verification is the reference's reprojection chi2 gate (9.21 at 0.01),
    followed by a least-squares refit on the consensus set.

The sequential `iterate()` loop of the reference becomes one device
computation over H hypotheses — no host round-trips.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..factors.reprojection import Camera
from ..geometry import align, se3

CHI2_PNP = 9.210  # reference PnP/Sim3 inlier gate (chi2 2-dof @ 0.01)


class PnPResult(NamedTuple):
    pose: se3.SE3  # T_cw
    inliers: jnp.ndarray  # (N,) bool
    num_inliers: jnp.ndarray  # ()


def _dlt_pose(X_w: jnp.ndarray, uv_n: jnp.ndarray, row_w: jnp.ndarray | None = None):
    """Linear 6-point camera resection (DLT) in NORMALIZED image coords.

    X_w (N, 3), uv_n (N, 2) with K removed. Returns (R (3,3), t (3,)).
    The EPnP control-point machinery of the reference (PnPsolver.cc:664-1491)
    exists to make this well-conditioned for small N; with the batched
    hypothesis bank we can afford the plain DLT + orthonormalization per
    sample and let the consensus refit polish the winner.
    """
    N = X_w.shape[0]
    zero = jnp.zeros((N, 4), X_w.dtype)
    Xh = jnp.concatenate([X_w, jnp.ones((N, 1), X_w.dtype)], axis=-1)
    r1 = jnp.concatenate([Xh, zero, -uv_n[:, :1] * Xh], axis=-1)
    r2 = jnp.concatenate([zero, Xh, -uv_n[:, 1:2] * Xh], axis=-1)
    if row_w is not None:
        r1 = r1 * row_w[:, None]
        r2 = r2 * row_w[:, None]
    A = jnp.concatenate([r1, r2], axis=0)  # (2N, 12)
    _, _, Vt = jnp.linalg.svd(A, full_matrices=False)
    Pm = Vt[-1].reshape(3, 4)
    # P and -P project identically; pick the sign with det(M) > 0 so the
    # nearest orthonormal factor is a PROPER rotation (then cheirality
    # holds for valid configurations; degenerate samples simply score few
    # inliers).
    sgn = jnp.sign(jnp.linalg.det(Pm[:, :3]))
    Pm = Pm * jnp.where(sgn == 0, 1.0, sgn)
    M = Pm[:, :3]
    U, D, Vt2 = jnp.linalg.svd(M)
    R = U @ Vt2  # det = +1 by the sign choice above
    scale = 3.0 / jnp.maximum(jnp.sum(D), 1e-12)
    t = Pm[:, 3] * scale
    return R, t


@functools.partial(jax.jit, static_argnames=("cam", "num_hypotheses"))
def ransac_pnp_2d3d(
    key: jnp.ndarray,
    points_w: jnp.ndarray,  # (N, 3) landmark world positions
    uv: jnp.ndarray,  # (N, 2) observed pixels
    valid: jnp.ndarray,
    inv_sigma2: jnp.ndarray,
    cam: Camera,
    num_hypotheses: int = 256,
) -> PnPResult:
    """2D-3D RANSAC resection (mono relocalization — no depth needed).

    Replaces the reference's sequential EPnP RANSAC (PnPsolver::iterate,
    PnPsolver.cc:247): H 6-point DLT solves as one batched SVD, reprojection
    gate, then a DLT refit on the consensus set."""
    N = points_w.shape[0]
    H = num_hypotheses
    uv_n = jnp.stack(
        [(uv[:, 0] - cam.cx) / cam.fx, (uv[:, 1] - cam.cy) / cam.fy], axis=-1
    )

    g = jax.random.gumbel(key, (H, N))
    g = jnp.where(valid[None, :], g, -jnp.inf)
    _, sel = jax.lax.top_k(g, 6)

    Rs, ts = jax.vmap(_dlt_pose)(points_w[sel], uv_n[sel])
    x_c = jnp.einsum("hij,nj->hni", Rs, points_w) + ts[:, None, :]
    e2 = jnp.sum((cam.project(x_c) - uv[None]) ** 2, axis=-1) * inv_sigma2[None]
    ok = (e2 < CHI2_PNP) & valid[None] & (x_c[..., 2] > 0.1)
    counts = jnp.sum(ok, axis=-1)
    finite = jnp.all(jnp.isfinite(Rs), axis=(-2, -1)) & jnp.all(jnp.isfinite(ts), -1)
    counts = jnp.where(finite, counts, -1)
    best = jnp.argmax(counts)
    inliers = ok[best]

    # Consensus refit: row-weighted DLT, then a short Gauss-Newton polish
    # (DLT's algebraic error is biased; the reference follows its EPnP with
    # `gauss_newton` refinement, PnPsolver.cc:963).
    R_f, t_f = _dlt_pose(points_w, uv_n, row_w=inliers.astype(points_w.dtype))

    from ..factors import reprojection as reproj

    def gn_body(pose, _):
        r, J, _ = reproj.mono_residual_jac(pose, points_w, uv, cam)
        w = inliers.astype(r.dtype) * inv_sigma2
        H = jnp.einsum("nki,n,nkj->ij", J, w, J) + 1e-6 * jnp.eye(6, dtype=r.dtype)
        b = jnp.einsum("nki,n,nk->i", J, w, r)
        return se3.retract(pose, -jnp.linalg.solve(H, b)), None

    pose_f, _ = jax.lax.scan(gn_body, se3.SE3(R_f, t_f), None, length=5)

    x_cf = points_w @ pose_f.R.T + pose_f.t
    e2f = jnp.sum((cam.project(x_cf) - uv) ** 2, axis=-1) * inv_sigma2
    in_f = (e2f < CHI2_PNP) & valid & (x_cf[..., 2] > 0.1)
    use_f = (
        (jnp.sum(in_f) >= jnp.sum(inliers))
        & jnp.all(jnp.isfinite(pose_f.R))
        & jnp.all(jnp.isfinite(pose_f.t))
    )

    R_best = jnp.where(use_f, pose_f.R, Rs[best])
    t_best = jnp.where(use_f, pose_f.t, ts[best])
    inl = jnp.where(use_f, in_f, inliers)
    return PnPResult(
        pose=se3.SE3(R_best, t_best), inliers=inl, num_inliers=jnp.sum(inl)
    )


@functools.partial(jax.jit, static_argnames=("cam", "num_hypotheses"))
def ransac_pose_3d3d(
    key: jnp.ndarray,
    points_w: jnp.ndarray,  # (N, 3) landmark world positions
    points_c: jnp.ndarray,  # (N, 3) backprojected camera-frame points
    uv: jnp.ndarray,  # (N, 2) observed pixels (for the inlier gate)
    valid: jnp.ndarray,  # (N,) bool
    inv_sigma2: jnp.ndarray,  # (N,)
    cam: Camera,
    num_hypotheses: int = 256,
) -> PnPResult:
    """Estimate T_cw with points_c ~ T_cw * points_w; batched-hypothesis
    RANSAC with reprojection verification + consensus refit."""
    N = points_w.shape[0]
    H = num_hypotheses

    g = jax.random.gumbel(key, (H, N))
    g = jnp.where(valid[None, :], g, -jnp.inf)
    _, sel = jax.lax.top_k(g, 3)  # (H, 3) minimal sets

    T_h = align.umeyama(points_w[sel], points_c[sel], with_scale=False)  # Sim3 s=1
    # Reprojection gate per hypothesis.
    x_c = (
        jnp.einsum("hij,nj->hni", T_h.R, points_w) + T_h.t[:, None, :]
    )  # (H, N, 3)
    e2 = jnp.sum((cam.project(x_c) - uv[None]) ** 2, axis=-1) * inv_sigma2[None]
    ok = (e2 < CHI2_PNP) & valid[None] & (x_c[..., 2] > 0.1)
    counts = jnp.sum(ok, axis=-1)

    best = jnp.argmax(counts)
    inliers = ok[best]

    # Consensus refit (weighted Horn on all inliers).
    w = inliers.astype(points_w.dtype)
    T_fit = align.umeyama(points_w, points_c, weights=w, with_scale=False)
    x_cf = jnp.einsum("ij,nj->ni", T_fit.R, points_w) + T_fit.t
    e2f = jnp.sum((cam.project(x_cf) - uv) ** 2, axis=-1) * inv_sigma2
    in_f = (e2f < CHI2_PNP) & valid & (x_cf[..., 2] > 0.1)
    use_fit = jnp.sum(in_f) >= jnp.sum(inliers)

    R_best = jnp.where(use_fit, T_fit.R, T_h.R[best])
    t_best = jnp.where(use_fit, T_fit.t, T_h.t[best])
    inl = jnp.where(use_fit, in_f, inliers)
    return PnPResult(
        pose=se3.SE3(R_best, t_best), inliers=inl, num_inliers=jnp.sum(inl)
    )
