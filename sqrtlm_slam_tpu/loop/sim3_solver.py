"""Sim(3) RANSAC between two keyframes from 3D-3D landmark matches.

JAX redesign of `Sim3Solver`
(/root/reference/src/algorithm/Sim3Solver.cc): the reference iterates
RANSAC hypotheses sequentially (`iterate`, Sim3Solver.cc:207-294), each with
Horn's closed-form (`ComputeSim3`, :319-460) and a two-directional
reprojection inlier check (`CheckInliers`, :462). Here the ENTIRE hypothesis
bank runs as one batched computation (SURVEY.md §2.10 P4 pattern): H minimal
sets -> batched Umeyama SVD -> (H, N) reprojection checks -> argmax inliers.

Also provides `optimize_sim3`, the inner Gauss-Newton refinement mirroring
`Optimizer::OptimizeSim3` (/root/reference/src/backend/g2oOptimizer.cc:1560-1796):
mutual reprojection residuals of both keyframes' landmarks through S12/S21,
Huber-robustified, scale frozen for stereo/RGBD (`bFixScale`,
LoopClosing.cc:433).
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp

from ..factors.reprojection import Camera
from ..geometry import align, sim3

CHI2_SIM3 = 9.210  # 2-dof chi2 at 0.01 (Sim3Solver.cc inlier threshold)


class Sim3RansacResult(NamedTuple):
    S12: sim3.Sim3  # best hypothesis: maps KF2-camera-frame points to KF1
    inliers: jnp.ndarray  # (N,) bool
    num_inliers: jnp.ndarray  # ()


@functools.partial(
    jax.jit, static_argnames=("cam", "num_hypotheses", "fix_scale")
)
def ransac_sim3(
    key: jnp.ndarray,
    x1: jnp.ndarray,  # (N, 3) matched landmarks in KF1 camera frame
    x2: jnp.ndarray,  # (N, 3) same landmarks in KF2 camera frame
    valid: jnp.ndarray,  # (N,) bool
    inv_sigma2_1: jnp.ndarray,  # (N,) pyramid info of the KF1 keypoint
    inv_sigma2_2: jnp.ndarray,
    cam: Camera,
    num_hypotheses: int = 128,
    fix_scale: bool = False,
) -> Sim3RansacResult:
    """Batched-hypothesis RANSAC for S12 (x1 ~ S12 * x2)."""
    N = x1.shape[0]
    H = num_hypotheses

    # Minimal sets: 3 distinct valid indices per hypothesis. Sampling from
    # the valid set via masked gumbel-top-k (jit-safe, no rejection loop).
    g = jax.random.gumbel(key, (H, N))
    g = jnp.where(valid[None, :], g, -jnp.inf)
    _, sel = jax.lax.top_k(g, 3)  # (H, 3)

    src = x2[sel]  # (H, 3, 3)
    dst = x1[sel]
    S_h = align.umeyama(src, dst, with_scale=not fix_scale)  # batched Sim3

    # Two-directional reprojection check (CheckInliers, Sim3Solver.cc:462):
    # project x2 through S12 into KF1's image and x1 through S21 into KF2's.
    x2_in_1 = sim3.act(S_h, x2[None].repeat(H, 0))  # (H, N, 3)
    x1_in_2 = sim3.act(sim3.inverse(S_h), x1[None].repeat(H, 0))
    uv1 = cam.project(x1)
    uv2 = cam.project(x2)
    e1 = jnp.sum((cam.project(x2_in_1) - uv1[None]) ** 2, axis=-1) * inv_sigma2_1[None]
    e2 = jnp.sum((cam.project(x1_in_2) - uv2[None]) ** 2, axis=-1) * inv_sigma2_2[None]
    ok = (e1 < CHI2_SIM3) & (e2 < CHI2_SIM3) & valid[None]
    ok = ok & (x2_in_1[..., 2] > 0) & (x1_in_2[..., 2] > 0)
    counts = jnp.sum(ok, axis=-1)  # (H,)

    # Degenerate hypotheses (scale collapse) are invalidated.
    finite = jnp.isfinite(S_h.s) & (S_h.s > 1e-3) & (S_h.s < 1e3)
    counts = jnp.where(finite, counts, -1)

    best = jnp.argmax(counts)
    S_best = jax.tree_util.tree_map(lambda a: a[best], S_h)
    inliers = ok[best]

    # Final refit on all inliers of the best hypothesis (one extra Umeyama).
    w = inliers.astype(x1.dtype)
    S_refit = align.umeyama(x2, x1, weights=w, with_scale=not fix_scale)
    x2r = sim3.act(S_refit, x2)
    x1r = sim3.act(sim3.inverse(S_refit), x1)
    e1r = jnp.sum((cam.project(x2r) - uv1) ** 2, axis=-1) * inv_sigma2_1
    e2r = jnp.sum((cam.project(x1r) - uv2) ** 2, axis=-1) * inv_sigma2_2
    in_r = (e1r < CHI2_SIM3) & (e2r < CHI2_SIM3) & valid & (x2r[..., 2] > 0) & (x1r[..., 2] > 0)
    use_refit = jnp.sum(in_r) >= jnp.sum(inliers)
    S_out = jax.tree_util.tree_map(
        lambda a, b: jnp.where(use_refit, a, b), S_refit, S_best
    )
    inl = jnp.where(use_refit, in_r, inliers)
    return Sim3RansacResult(S12=S_out, inliers=inl, num_inliers=jnp.sum(inl))


@functools.partial(jax.jit, static_argnames=("cam", "num_iters", "fix_scale"))
def optimize_sim3(
    S12: sim3.Sim3,
    x1: jnp.ndarray,
    x2: jnp.ndarray,
    valid: jnp.ndarray,
    inv_sigma2_1: jnp.ndarray,
    inv_sigma2_2: jnp.ndarray,
    cam: Camera,
    num_iters: int = 10,
    fix_scale: bool = False,
    huber_delta: float = jnp.sqrt(10.0),
):
    """Gauss-Newton refinement of S12 with mutual reprojection residuals.

    Mirrors `OptimizeSim3` (g2oOptimizer.cc:1560-1796): forward edges
    (project S12 x2 vs KF1 obs) + backward edges (project S21 x1 vs KF2
    obs), Huber kernel, 7-dim tangent (sigma row zeroed when fix_scale).
    Returns (S12_refined, inliers, num_inliers).
    """
    uv1 = cam.project(x1)
    uv2 = cam.project(x2)

    def residuals(delta, S):
        Sd = sim3.retract(S, delta)
        r1 = cam.project(sim3.act(Sd, x2)) - uv1  # (N, 2)
        r2 = cam.project(sim3.act(sim3.inverse(Sd), x1)) - uv2
        return r1, r2

    def gn_step(S, active):
        zero = jnp.zeros(7, dtype=x1.dtype)
        (r1, r2) = residuals(zero, S)
        J1, J2 = jax.jacfwd(lambda d: residuals(d, S))(zero)  # (N,2,7) each

        def whiten(r, J, is2):
            e2 = jnp.sum(r * r, axis=-1) * is2
            # Huber weight on the squared error.
            w_rob = jnp.where(e2 > huber_delta**2, huber_delta / jnp.sqrt(jnp.maximum(e2, 1e-12)), 1.0)
            w = is2 * w_rob * active.astype(r.dtype)
            H = jnp.einsum("nki,n,nkj->ij", J, w, J)
            b = jnp.einsum("nki,n,nk->i", J, w, r)
            return H, b

        H1, b1 = whiten(r1, J1, inv_sigma2_1)
        H2, b2 = whiten(r2, J2, inv_sigma2_2)
        H = H1 + H2 + 1e-6 * jnp.eye(7, dtype=x1.dtype)
        b = b1 + b2
        if fix_scale:
            pin = jnp.zeros(7, bool).at[6].set(True)
            H = jnp.where(pin[:, None] | pin[None, :], 0.0, H)
            H = H + jnp.diag(pin.astype(x1.dtype))
            b = jnp.where(pin, 0.0, b)
        delta = -jnp.linalg.solve(H, b)
        return sim3.retract(S, delta)

    # Phase 1: all matches active (the reference's first 5 iterations,
    # g2oOptimizer.cc:1700-1720); phase 2: chi2-gated survivors.
    def body_ungated(S, _):
        return gn_step(S, valid), None

    def body_gated(S, _):
        r1, r2 = residuals(jnp.zeros(7, dtype=x1.dtype), S)
        e1 = jnp.sum(r1 * r1, axis=-1) * inv_sigma2_1
        e2 = jnp.sum(r2 * r2, axis=-1) * inv_sigma2_2
        active = valid & (e1 < CHI2_SIM3) & (e2 < CHI2_SIM3)
        return gn_step(S, active), None

    n1 = max(num_iters // 2, 1)
    S12, _ = jax.lax.scan(body_ungated, S12, None, length=n1)
    S12, _ = jax.lax.scan(body_gated, S12, None, length=max(num_iters - n1, 1))
    r1, r2 = residuals(jnp.zeros(7, dtype=x1.dtype), S12)
    e1 = jnp.sum(r1 * r1, axis=-1) * inv_sigma2_1
    e2 = jnp.sum(r2 * r2, axis=-1) * inv_sigma2_2
    inliers = valid & (e1 < CHI2_SIM3) & (e2 < CHI2_SIM3)
    return S12, inliers, jnp.sum(inliers)
