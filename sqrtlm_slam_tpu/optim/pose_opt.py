"""Pose-only optimization (tracking) — jit-compiled, fixed-capacity, masked.

JAX redesign of `Optimizer::PoseOptimization`
(/root/reference/src/backend/g2oOptimizer.cc:385-679, myOptimizer.cc:36-231):

  * 4 rounds x 10 LM iterations; between rounds, edges are re-classified as
    inlier/outlier by the chi-square gate (5.991 at 2 dof mono, 7.815 at
    3 dof stereo) and the robust kernel is dropped after round 2
    (g2oOptimizer.cc:493-552).
  * LiDAR tight-coupling stage: if the LiDAR local map has enough points,
    point-to-plane (weight 50) and point-to-point (weight 30) unary edges on
    the same pose are added and the pose is re-optimized 10 more iterations
    (g2oOptimizer.cc:560-641). Here association (NN search) happens outside;
    this module consumes pre-associated targets with validity masks.

Everything is a fixed-capacity masked tensor: E visual edges and F/C LiDAR
edges are padded arrays; invalid entries carry zero weight. The full
4-round protocol compiles to ONE XLA computation (no host round-trips).
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import jax.numpy as jnp

from ..factors import lidar as lidar_factors
from ..factors import reprojection as reproj
from ..geometry import se3
from . import loss as losses
from .lm import lm_optimize


class VisualObs(NamedTuple):
    """Padded pose-only visual observations (capacity E).

    stereo rows (uvr[...,2] >= 0) use the 3-dof stereo residual; mono rows
    (uvr[...,2] < 0) use the 2-dof residual — mirroring the reference's mixed
    mono/stereo edge sets in PoseOptimization.
    """

    points_w: jnp.ndarray  # (E, 3) landmark world positions (fixed)
    uvr: jnp.ndarray  # (E, 3) [u, v, u_right]; u_right < 0 => mono
    inv_sigma2: jnp.ndarray  # (E,) information scale (pyramid octave)
    valid: jnp.ndarray  # (E,) bool


class LidarObs(NamedTuple):
    """Padded pre-associated LiDAR observations for tight coupling."""

    flat_pts: jnp.ndarray  # (F, 3) sensor-frame flat points
    plane_n: jnp.ndarray  # (F, 3) associated plane normals (world)
    plane_d: jnp.ndarray  # (F,) plane offsets
    flat_valid: jnp.ndarray  # (F,) bool
    corner_pts: jnp.ndarray  # (C, 3) sensor-frame corner points
    corner_target: jnp.ndarray  # (C, 3) associated world targets
    corner_valid: jnp.ndarray  # (C,) bool
    flat_weight: float = 50.0  # info = 50 I (g2oOptimizer.cc:600-620)
    corner_weight: float = 30.0  # info = 30 I (g2oOptimizer.cc:560-600)


class PoseOptResult(NamedTuple):
    pose: se3.SE3
    inlier_mask: jnp.ndarray  # (E,) visual inliers after gating
    num_inliers: jnp.ndarray
    chi2: jnp.ndarray


def _visual_system(pose, obs: VisualObs, cam, active, robust_delta):
    """Accumulate H (6,6), b (6,), chi2 over masked visual edges."""
    is_stereo = obs.uvr[..., 2] >= 0.0
    r3, J3, _ = reproj.stereo_residual_jac(pose, obs.points_w, obs.uvr, cam)
    r2, J2, _ = reproj.mono_residual_jac(pose, obs.points_w, obs.uvr[..., :2], cam)
    # Unify mono as 3-dim with zeroed third row.
    r2f = jnp.concatenate([r2, jnp.zeros_like(r2[..., :1])], axis=-1)
    J2f = jnp.concatenate([J2, jnp.zeros_like(J2[..., :1, :])], axis=-2)
    r = jnp.where(is_stereo[..., None], r3, r2f)
    J = jnp.where(is_stereo[..., None, None], J3, J2f)

    w_info = obs.inv_sigma2 * active.astype(r.dtype)
    e2 = w_info * jnp.sum(r * r, axis=-1)

    if robust_delta is None:
        w_rob = jnp.ones_like(e2)
        rho = e2
    else:
        loss = losses.huber(robust_delta)
        rho, w_rob, _ = loss(e2)
    w = w_info * w_rob

    H = jnp.einsum("eki,e,ekj->ij", J, w, J)
    b = jnp.einsum("eki,e,ek->i", J, w, r)
    chi2 = jnp.sum(jnp.where(active, rho, 0.0))
    return H, b, chi2, e2


def _lidar_system(pose, lobs: LidarObs, robust_delta: Optional[float] = None):
    rf, Jf = lidar_factors.plane_residual_jac(
        pose, lobs.flat_pts, lobs.plane_n, lobs.plane_d
    )
    wf = lobs.flat_weight * lobs.flat_valid.astype(rf.dtype)
    e2f = wf * rf * rf
    if robust_delta is not None:
        _, w_rf, _ = losses.huber(robust_delta)(e2f)
        wf = wf * w_rf
    Hf = jnp.einsum("fi,f,fj->ij", Jf, wf, Jf)
    bf = jnp.einsum("fi,f,f->i", Jf, wf, rf)
    chi2f = jnp.sum(e2f)

    rc, Jc = lidar_factors.point_residual_jac(
        pose, lobs.corner_pts, lobs.corner_target
    )
    wc = lobs.corner_weight * lobs.corner_valid.astype(rc.dtype)
    e2c = wc * jnp.sum(rc * rc, axis=-1)
    if robust_delta is not None:
        _, w_rc, _ = losses.huber(robust_delta)(e2c)
        wc = wc * w_rc
    Hc = jnp.einsum("cki,c,ckj->ij", Jc, wc, Jc)
    bc = jnp.einsum("cki,c,ck->i", Jc, wc, rc)
    chi2c = jnp.sum(e2c)

    return Hf + Hc, bf + bc, chi2f + chi2c


def optimize_pose(
    pose0: se3.SE3,
    obs: VisualObs,
    cam: reproj.Camera,
    lidar_obs: Optional[LidarObs] = None,
    rounds: int = 4,
    iters_per_round: int = 10,
    lidar_iters: int = 10,
    huber_delta: float = math.sqrt(losses.CHI2_2DOF),
) -> PoseOptResult:
    """Full tracking pose optimization (visual rounds + optional LiDAR stage).

    Mirrors g2oOptimizer.cc:385-679. The chi-square gate uses 5.991 for mono
    edges and 7.815 for stereo edges, applied to the information-weighted
    squared error — identical classification semantics to the reference's
    per-round `setLevel(1)` outlier exclusion.
    """
    is_stereo = obs.uvr[..., 2] >= 0.0
    gate = jnp.where(is_stereo, losses.CHI2_3DOF, losses.CHI2_2DOF)

    pose = pose0
    active = obs.valid
    for rnd in range(rounds):
        # Huber kernel for the first two rounds, then plain quadratic
        # (reference drops the kernel after round 2, g2oOptimizer.cc:540-552).
        delta = huber_delta if rnd < 2 else None

        def system_fn(p, _active=active, _delta=delta):
            H, b, chi2, _ = _visual_system(p, obs, cam, _active, _delta)
            return H, b, chi2

        result = lm_optimize(
            pose, system_fn, se3.retract, num_iters=iters_per_round
        )
        pose = result.params
        # Re-classify inliers at the new linearization point.
        _, _, _, e2 = _visual_system(pose, obs, cam, obs.valid, None)
        active = obs.valid & (e2 <= gate)

    if lidar_obs is not None:
        def fused_system(p, _active=active):
            Hv, bv, c2v, _ = _visual_system(p, obs, cam, _active, None)
            Hl, bl, c2l = _lidar_system(p, lidar_obs)
            return Hv + Hl, bv + bl, c2v + c2l

        result = lm_optimize(pose, fused_system, se3.retract, num_iters=lidar_iters)
        pose = result.params

    # Final classification must use the FULL valid mask (not the gated one):
    # an edge excluded in an earlier round would otherwise carry zero weight,
    # zero e2, and be misreported as an inlier.
    _, _, chi2, e2 = _visual_system(pose, obs, cam, obs.valid, None)
    inliers = obs.valid & (e2 <= gate)
    return PoseOptResult(
        pose=pose,
        inlier_mask=inliers,
        num_inliers=jnp.sum(inliers.astype(jnp.int32)),
        chi2=chi2,
    )
