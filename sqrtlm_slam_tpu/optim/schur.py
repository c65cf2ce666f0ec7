"""Bundle adjustment via landmark Schur elimination — batched, jittable.

JAX redesign of the reference's three BA backends behind one engine:
  * mybackend `Problem::SolveLinearSystem` — Schur complement marginalizing
    landmarks, block-diagonal Hmm inverted 3x3-wise, dense solve of the
    reduced camera system, landmark back-substitution
    (/root/reference/src/backend/mybackend/problem.cc:429-563)
  * g2o `LocalBundleAdjustment` protocol — local KFs + fixed frontier,
    5 iters -> chi2 outlier gate (5.991 mono / 7.815 stereo, negative depth)
    -> 10 iters (/root/reference/src/backend/g2oOptimizer.cc:704-1191)
  * `GlobalBundleAdjustemnt` over all KFs/MPs (g2oOptimizer.cc:80-385).

Design (SURVEY.md §7.0): the pose-landmark problem is a fixed-capacity SoA —
P poses, L landmarks, E observation edges, all padded + masked. One LM
iteration is:

    per-edge residual/Jacobian (vmapped analytic factors)
      -> robust whitening
      -> segment-sum assembly of Hpp (P,6,6), Hll (L,3,3), W (P*6, L, 3), b
      -> batched 3x3 inversion of damped Hll
      -> reduced system  S = Hpp - W Hll^-1 W^T   (one big matmul)
      -> dense Cholesky solve for pose increments (gauge-fixed rows pinned)
      -> landmark back-substitution (batched 3x3)

The dense-W layout costs P*6*L*3 floats (e.g. 64 poses x 8192 landmarks =
37 MB f32) — well within device memory for local BA windows and deliberately
matmul-shaped. This flat engine is the plain reference the bucketed engine
(optim/schur_bucketed.py) and the distributed path (parallel/dist_ba.py) are
tested against.

The LiDAR tight-coupling stage of local BA (g2oOptimizer.cc:978-1117) adds
unary LiDAR edges on the newest keyframe after the visual solve; see
`lidar_stage` below.
"""

from __future__ import annotations

import math

from typing import NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp

from ..factors import reprojection as reproj
from ..geometry import se3
from . import loss as losses
from .edge_kernels import inv3x3


class BAProblem(NamedTuple):
    """Fixed-capacity bundle-adjustment problem (all arrays padded + masked)."""

    # Poses: world->camera, SoA.
    pose_R: jnp.ndarray  # (P, 3, 3)
    pose_t: jnp.ndarray  # (P, 3)
    pose_fixed: jnp.ndarray  # (P,) bool — gauge anchors + frontier KFs
    pose_valid: jnp.ndarray  # (P,) bool
    # Landmarks.
    points: jnp.ndarray  # (L, 3)
    point_valid: jnp.ndarray  # (L,) bool
    # Observations.
    obs_cam: jnp.ndarray  # (E,) int32 pose index
    obs_pt: jnp.ndarray  # (E,) int32 landmark index
    obs_uvr: jnp.ndarray  # (E, 3) [u, v, u_right]; u_right < 0 -> mono
    obs_inv_sigma2: jnp.ndarray  # (E,)
    obs_valid: jnp.ndarray  # (E,) bool

    @property
    def num_poses(self):
        return self.pose_R.shape[0]

    @property
    def num_points(self):
        return self.points.shape[0]

    def poses(self) -> se3.SE3:
        return se3.SE3(self.pose_R, self.pose_t)


class BAStats(NamedTuple):
    chi2: jnp.ndarray
    num_inlier_edges: jnp.ndarray
    iters_accepted: jnp.ndarray


def _edge_terms(problem: BAProblem, cam: reproj.Camera, active, robust_delta):
    """Per-edge (r, Jp, Jl, w, chi2_e) with mono/stereo unified to 3 dof.

    The u,v rows of the stereo residual ARE the mono residual (same pinhole
    projection); mono edges simply zero the disparity row — one evaluation
    instead of the reference's separate mono/stereo edge types."""
    T = se3.SE3(problem.pose_R[problem.obs_cam], problem.pose_t[problem.obs_cam])
    X = problem.points[problem.obs_pt]
    uvr = problem.obs_uvr
    is_stereo = uvr[..., 2] >= 0.0

    r, Jp, Jl = reproj.stereo_residual_jac(T, X, uvr, cam)
    row_mask = jnp.stack(
        [jnp.ones_like(is_stereo), jnp.ones_like(is_stereo), is_stereo],
        axis=-1,
    ).astype(r.dtype)  # (E, 3)
    r = r * row_mask
    Jp = Jp * row_mask[..., None]
    Jl = Jl * row_mask[..., None]

    w_info = problem.obs_inv_sigma2 * active.astype(r.dtype)
    e2 = w_info * jnp.sum(r * r, axis=-1)
    if robust_delta is None:
        w_rob = jnp.ones_like(e2)
        rho = e2
    else:
        rho, w_rob, _ = losses.huber(robust_delta)(e2)
    w = w_info * w_rob
    chi2 = jnp.sum(jnp.where(active, rho, 0.0))
    return r, Jp, Jl, w, chi2, e2


def build_normal_equations(
    problem: BAProblem, cam: reproj.Camera, active, robust_delta
):
    """Assemble (Hpp, Hll, W, bp, bl, chi2). W has shape (P*6, L, 3)."""
    P, L = problem.num_poses, problem.num_points
    r, Jp, Jl, w, chi2, _ = _edge_terms(problem, cam, active, robust_delta)

    # Fixed poses contribute no pose Jacobian (their rows stay empty) —
    # equivalent to g2o's setFixed on frontier keyframes.
    free_pose = (~problem.pose_fixed)[problem.obs_cam]
    Jp = Jp * free_pose[..., None, None].astype(Jp.dtype)

    Hpp = jax.ops.segment_sum(
        jnp.einsum("eki,e,ekj->eij", Jp, w, Jp), problem.obs_cam, num_segments=P
    )
    Hll = jax.ops.segment_sum(
        jnp.einsum("eki,e,ekj->eij", Jl, w, Jl), problem.obs_pt, num_segments=L
    )
    bp = jax.ops.segment_sum(
        jnp.einsum("eki,e,ek->ei", Jp, w, r), problem.obs_cam, num_segments=P
    )
    bl = jax.ops.segment_sum(
        jnp.einsum("eki,e,ek->ei", Jl, w, r), problem.obs_pt, num_segments=L
    )
    # Cross blocks, scattered into the dense (P, L) block layout.
    Wblk = jnp.einsum("eki,e,ekj->eij", Jp, w, Jl)  # (E, 6, 3)
    flat_idx = problem.obs_cam * L + problem.obs_pt
    W = jax.ops.segment_sum(Wblk, flat_idx, num_segments=P * L)
    W = W.reshape(P, L, 6, 3).transpose(0, 2, 1, 3).reshape(P * 6, L, 3)
    return Hpp, Hll, W, bp, bl, chi2


def reduce_and_solve(
    Hpp, Hll, W, bp, bl, pose_fixed, point_valid, mu
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Damp, Schur-reduce, solve poses, back-substitute landmarks.

    Returns (dx_pose (P, 6), dx_point (L, 3)).
    """
    P = Hpp.shape[0]
    L = Hll.shape[0]
    dtype = Hpp.dtype
    eye3 = jnp.eye(3, dtype=dtype)
    eye6 = jnp.eye(6, dtype=dtype)

    # Marquardt (multiplicative) damping — scale-invariant, matching the
    # reference mybackend's add/remove-lambda-on-diagonal scheme
    # (problem.cc:632-676); absolute damping diverges on thin landmark
    # blocks from near-collinear observation rays.
    dll = jnp.diagonal(Hll, axis1=-2, axis2=-1)
    Hll_d = Hll + mu * dll[..., None] * eye3 + 1e-8 * eye3
    # Invalid landmarks get identity blocks (zero rhs => zero update).
    Hll_d = jnp.where(point_valid[:, None, None], Hll_d, eye3)
    Hll_inv = inv3x3(Hll_d)

    WHinv = jnp.einsum("alk,lkm->alm", W, Hll_inv)  # (P6, L, 3)
    S_corr = jnp.einsum("alm,blm->ab", WHinv, W)  # (P6, P6) matmul
    dpp = jnp.diagonal(Hpp, axis1=-2, axis2=-1)
    Hpp_d = Hpp + mu * dpp[..., None] * eye6 + 1e-8 * eye6
    S = _blockdiag(Hpp_d) - S_corr
    rhs = -(bp.reshape(-1) - jnp.einsum("alm,lm->a", WHinv, bl))

    # Gauge fixing: pin rows/cols of fixed poses.
    fixed6 = jnp.repeat(pose_fixed, 6)
    S = jnp.where(fixed6[:, None] | fixed6[None, :], 0.0, S)
    S = S + jnp.diag(fixed6.astype(dtype))
    rhs = jnp.where(fixed6, 0.0, rhs)

    # Cholesky solve of the reduced camera system (SPD by damping).
    dxp_flat = jax.scipy.linalg.cho_solve(jax.scipy.linalg.cho_factor(S), rhs)
    dxp = dxp_flat.reshape(P, 6)

    # Back-substitution: dxl = Hll^-1 (-bl - W^T dxp).
    Wt_dxp = jnp.einsum("alm,a->lm", W, dxp_flat)
    dxl = jnp.einsum("lkm,lm->lk", Hll_inv, -bl - Wt_dxp)
    dxl = jnp.where(point_valid[:, None], dxl, 0.0)
    return dxp, dxl


def _blockdiag(blocks: jnp.ndarray) -> jnp.ndarray:
    """(P, 6, 6) block-diagonal -> (P*6, P*6) dense."""
    P = blocks.shape[0]
    out = jnp.zeros((P * 6, P * 6), dtype=blocks.dtype)
    idx = jnp.arange(P) * 6
    # Scatter each 6x6 block onto the diagonal via one vectorized update.
    rows = jnp.repeat(idx, 36) + jnp.tile(jnp.repeat(jnp.arange(6), 6), P)
    cols = jnp.repeat(idx, 36) + jnp.tile(jnp.tile(jnp.arange(6), 6), P)
    return out.at[rows, cols].add(blocks.reshape(-1))


def _apply_update(problem: BAProblem, dxp, dxl) -> BAProblem:
    poses = se3.retract(problem.poses(), dxp)
    free = (~problem.pose_fixed)[:, None]
    new_R = jnp.where(free[..., None], poses.R, problem.pose_R)
    new_t = jnp.where(free, poses.t, problem.pose_t)
    new_pts = problem.points + dxl
    return problem._replace(pose_R=new_R, pose_t=new_t, points=new_pts)


def chi2_only(problem: BAProblem, cam: reproj.Camera, active, robust_delta):
    """Residual-only chi2 (Jacobians are dead code under jit -> eliminated)."""
    _, _, _, _, chi2, _ = _edge_terms(problem, cam, active, robust_delta)
    return chi2


def ba_iterate(
    problem: BAProblem,
    cam: reproj.Camera,
    active,
    num_iters: int,
    robust_delta: Optional[float],
    tau: float = 1e-5,
) -> Tuple[BAProblem, jnp.ndarray, jnp.ndarray]:
    """Run `num_iters` damped LM iterations on the BA problem (one jit trace).

    Nielsen damping with functional rollback, mirroring problem.cc:92-167.
    The scan carries only the (small) problem state — normal equations are
    rebuilt per iteration; the candidate is scored by a residual-only chi2
    pass (the Jacobian side is dead code there and XLA eliminates it).
    Returns (problem, chi2, accepted_count).
    """
    chi20 = chi2_only(problem, cam, active, robust_delta)
    # Multiplicative damping -> mu is dimensionless (Nielsen start 1e-3).
    mu0 = jnp.asarray(1e-3, dtype=chi20.dtype) + 0.0 * chi20

    def body(carry, _):
        prob, chi2, mu, nu, n_acc = carry
        Hpp, Hll, W, bp, bl, _ = build_normal_equations(
            prob, cam, active, robust_delta
        )
        dxp, dxl = reduce_and_solve(
            Hpp, Hll, W, bp, bl, prob.pose_fixed, prob.point_valid, mu
        )
        candidate = _apply_update(prob, dxp, dxl)
        chi2_c = chi2_only(candidate, cam, active, robust_delta)
        dx_all = jnp.concatenate([dxp.reshape(-1), dxl.reshape(-1)])
        b_all = jnp.concatenate([bp.reshape(-1), bl.reshape(-1)])
        predicted = 0.5 * jnp.sum(dx_all * (mu * dx_all - b_all))
        rho = (chi2 - chi2_c) / jnp.maximum(predicted, 1e-12)
        accept = (rho > 0) & jnp.isfinite(chi2_c)

        prob_new = jax.tree_util.tree_map(
            lambda x, y: jnp.where(accept, x, y), candidate, prob
        )
        chi2_new = jnp.where(accept, chi2_c, chi2)
        factor = jnp.maximum(1.0 / 3.0, 1.0 - (2.0 * rho - 1.0) ** 3)
        mu_new = jnp.where(accept, mu * factor, mu * nu)
        nu_new = jnp.where(accept, 2.0, nu * 2.0)
        return (prob_new, chi2_new, mu_new, nu_new, n_acc + accept), None

    init = (
        problem,
        chi20,
        mu0,
        jnp.asarray(2.0, dtype=chi20.dtype),
        jnp.asarray(0, dtype=jnp.int32),
    )
    (problem, chi2, _, _, n_acc), _ = jax.lax.scan(body, init, None, length=num_iters)
    return problem, chi2, n_acc


def edge_chi2_and_depth(problem: BAProblem, cam: reproj.Camera):
    """Per-edge chi2 (info-weighted) and camera-frame depth, for gating."""
    _, _, _, _, _, e2 = _edge_terms(problem, cam, problem.obs_valid, None)
    T = se3.SE3(problem.pose_R[problem.obs_cam], problem.pose_t[problem.obs_cam])
    z = se3.act(T, problem.points[problem.obs_pt])[..., 2]
    return e2, z


def local_ba(
    problem: BAProblem,
    cam: reproj.Camera,
    first_iters: int = 5,
    second_iters: int = 10,
) -> Tuple[BAProblem, jnp.ndarray, BAStats]:
    """Local BA with the reference's two-phase outlier protocol.

    5 robust iters -> gate (chi2 > 5.991/7.815 or depth <= 0 -> edge out,
    g2oOptimizer.cc:930-976) -> 10 more iters on survivors. Returns the
    optimized problem, the surviving-edge mask (callers erase those
    observations from the map, g2oOptimizer.cc:1119-1189), and stats.
    """
    delta2 = math.sqrt(losses.CHI2_2DOF)
    problem, _, acc1 = ba_iterate(
        problem, cam, problem.obs_valid, first_iters, robust_delta=delta2
    )
    is_stereo = problem.obs_uvr[..., 2] >= 0.0
    gate = jnp.where(is_stereo, losses.CHI2_3DOF, losses.CHI2_2DOF)
    e2, z = edge_chi2_and_depth(problem, cam)
    active = problem.obs_valid & (e2 <= gate) & (z > 0)

    problem, chi2, acc2 = ba_iterate(
        problem, cam, active, second_iters, robust_delta=None
    )
    e2, z = edge_chi2_and_depth(problem, cam)
    survivors = problem.obs_valid & (e2 <= gate) & (z > 0)
    stats = BAStats(
        chi2=chi2,
        num_inlier_edges=jnp.sum(survivors.astype(jnp.int32)),
        iters_accepted=acc1 + acc2,
    )
    return problem, survivors, stats


# ----------------------------------------------------------------------
# Matrix-free Schur + PCG — the whole-map scale path.
#
# The dense-W layout above is ideal for local windows (matmul-shaped) but
# costs P*6*L*3 floats; a full map (10^3 KFs x 10^5 landmarks)
# doesn't fit. Here the reduced camera system S = Hpp - W Hll^-1 W^T is
# never materialized: its action on a vector is three edge-wise batched
# (k x 6)/(k x 3) contractions + segment-sums — O(E) per matvec. Solved by block-Jacobi
# preconditioned CG. This replaces g2o's sparse CHOLMOD factorization in
# `GlobalBundleAdjustemnt` (g2oOptimizer.cc:80-385) with an
# iteration-parallel method that also distributes trivially (one psum of
# the per-shard matvec pieces).
# ----------------------------------------------------------------------


def _edge_data(problem: BAProblem, cam: reproj.Camera, active, robust_delta):
    """Per-edge Jacobians/weights + assembled block-diagonals (no dense W)."""
    P, L = problem.num_poses, problem.num_points
    r, Jp, Jl, w, chi2, _ = _edge_terms(problem, cam, active, robust_delta)
    free_pose = (~problem.pose_fixed)[problem.obs_cam]
    Jp = Jp * free_pose[..., None, None].astype(Jp.dtype)
    Hpp = jax.ops.segment_sum(
        jnp.einsum("eki,e,ekj->eij", Jp, w, Jp), problem.obs_cam, num_segments=P
    )
    Hll = jax.ops.segment_sum(
        jnp.einsum("eki,e,ekj->eij", Jl, w, Jl), problem.obs_pt, num_segments=L
    )
    bp = jax.ops.segment_sum(
        jnp.einsum("eki,e,ek->ei", Jp, w, r), problem.obs_cam, num_segments=P
    )
    bl = jax.ops.segment_sum(
        jnp.einsum("eki,e,ek->ei", Jl, w, r), problem.obs_pt, num_segments=L
    )
    return r, Jp, Jl, w, Hpp, Hll, bp, bl, chi2


def _schur_matvec(v, Jp, Jl, w, obs_cam, obs_pt, Hpp_d, Hll_inv, pose_fixed):
    """S @ v for v (P, 6) without materializing W. Returns (P, 6)."""
    P, L = Hpp_d.shape[0], Hll_inv.shape[0]
    v = jnp.where(pose_fixed[:, None], 0.0, v)
    tmp = jnp.einsum("ekj,ej->ek", Jp, v[obs_cam])  # (E, k)
    Wt_v = jax.ops.segment_sum(
        jnp.einsum("eki,e,ek->ei", Jl, w, tmp), obs_pt, num_segments=L
    )  # (L, 3)
    y = jnp.einsum("lij,lj->li", Hll_inv, Wt_v)
    z = jnp.einsum("ekj,ej->ek", Jl, y[obs_pt])  # (E, k)
    Wy = jax.ops.segment_sum(
        jnp.einsum("eki,e,ek->ei", Jp, w, z), obs_cam, num_segments=P
    )  # (P, 6)
    Sv = jnp.einsum("pij,pj->pi", Hpp_d, v) - Wy
    # Gauge: fixed poses act as identity rows.
    return jnp.where(pose_fixed[:, None], v, Sv)


def _pcg(matvec, b, Minv_blocks, pose_fixed, max_iters: int, tol: float):
    """Block-Jacobi preconditioned CG on the reduced camera system."""
    b = jnp.where(pose_fixed[:, None], 0.0, b)

    def precond(r):
        return jnp.einsum("pij,pj->pi", Minv_blocks, r)

    x0 = jnp.zeros_like(b)
    r0 = b
    z0 = precond(r0)
    p0 = z0
    rz0 = jnp.sum(r0 * z0)
    b2 = jnp.maximum(jnp.sum(b * b), 1e-20)

    def cond(state):
        _, r, _, _, k = state
        return (k < max_iters) & (jnp.sum(r * r) > tol * tol * b2)

    def body(state):
        x, r, p, rz, k = state
        Ap = matvec(p)
        alpha = rz / jnp.maximum(jnp.sum(p * Ap), 1e-20)
        x = x + alpha * p
        r = r - alpha * Ap
        z = precond(r)
        rz_new = jnp.sum(r * z)
        beta = rz_new / jnp.maximum(rz, 1e-20)
        p = z + beta * p
        return (x, r, p, rz_new, k + 1)

    x, _, _, _, n = jax.lax.while_loop(cond, body, (x0, r0, p0, rz0, 0))
    return x, n


def cg_reduce_and_solve(
    problem: BAProblem,
    cam: reproj.Camera,
    active,
    robust_delta,
    mu,
    cg_iters: int = 100,
    cg_tol: float = 1e-6,
):
    """One damped-GN step via matrix-free Schur + PCG.

    Returns (dxp (P,6), dxl (L,3), chi2, bp, bl, cg_n)."""
    P, L = problem.num_poses, problem.num_points
    r, Jp, Jl, w, Hpp, Hll, bp, bl, chi2 = _edge_data(
        problem, cam, active, robust_delta
    )
    dtype = Hpp.dtype
    eye3 = jnp.eye(3, dtype=dtype)
    eye6 = jnp.eye(6, dtype=dtype)
    dll = jnp.diagonal(Hll, axis1=-2, axis2=-1)
    Hll_d = Hll + mu * dll[..., None] * eye3 + 1e-8 * eye3
    Hll_d = jnp.where(problem.point_valid[:, None, None], Hll_d, eye3)
    Hll_inv = inv3x3(Hll_d)
    dpp = jnp.diagonal(Hpp, axis1=-2, axis2=-1)
    Hpp_d = Hpp + mu * dpp[..., None] * eye6 + 1e-8 * eye6

    # rhs = -(bp - W Hll_inv bl), edge-wise.
    y = jnp.einsum("lij,lj->li", Hll_inv, bl)
    z = jnp.einsum("ekj,ej->ek", Jl, y[problem.obs_pt])
    Wy = jax.ops.segment_sum(
        jnp.einsum("eki,e,ek->ei", Jp, w, z), problem.obs_cam, num_segments=P
    )
    rhs = -(bp - Wy)

    matvec = lambda v: _schur_matvec(
        v, Jp, Jl, w, problem.obs_cam, problem.obs_pt, Hpp_d, Hll_inv,
        problem.pose_fixed,
    )
    # Preconditioner: inverse of the damped pose blocks (+identity fallback).
    diag_ok = problem.pose_valid & ~problem.pose_fixed
    M = jnp.where(diag_ok[:, None, None], Hpp_d, eye6)
    Minv = jnp.linalg.inv(M + 1e-8 * eye6)

    dxp, cg_n = _pcg(matvec, rhs, Minv, problem.pose_fixed, cg_iters, cg_tol)
    dxp = jnp.where(problem.pose_fixed[:, None], 0.0, dxp)

    # Back-substitution, edge-wise: dxl = Hll_inv(-bl - W^T dxp).
    tmp = jnp.einsum("ekj,ej->ek", Jp, dxp[problem.obs_cam])
    Wt_dxp = jax.ops.segment_sum(
        jnp.einsum("eki,e,ek->ei", Jl, w, tmp), problem.obs_pt, num_segments=L
    )
    dxl = jnp.einsum("lij,lj->li", Hll_inv, -bl - Wt_dxp)
    dxl = jnp.where(problem.point_valid[:, None], dxl, 0.0)
    return dxp, dxl, chi2, bp, bl, cg_n


def ba_iterate_cg(
    problem: BAProblem,
    cam: reproj.Camera,
    active,
    num_iters: int,
    robust_delta: Optional[float],
    tau: float = 1e-5,
    cg_iters: int = 100,
) -> Tuple[BAProblem, jnp.ndarray, jnp.ndarray]:
    """LM loop using the matrix-free PCG step (whole-map scale)."""
    chi20 = chi2_only(problem, cam, active, robust_delta)
    mu0 = jnp.asarray(1e-3, dtype=chi20.dtype) + 0.0 * chi20

    def body(carry, _):
        prob, chi2, mu, nu, n_acc = carry
        dxp, dxl, _, bp, bl, _ = cg_reduce_and_solve(
            prob, cam, active, robust_delta, mu, cg_iters=cg_iters
        )
        candidate = _apply_update(prob, dxp, dxl)
        chi2_c = chi2_only(candidate, cam, active, robust_delta)
        dx_all = jnp.concatenate([dxp.reshape(-1), dxl.reshape(-1)])
        b_all = jnp.concatenate([bp.reshape(-1), bl.reshape(-1)])
        predicted = 0.5 * jnp.sum(dx_all * (mu * dx_all - b_all))
        rho = (chi2 - chi2_c) / jnp.maximum(predicted, 1e-12)
        accept = (rho > 0) & jnp.isfinite(chi2_c)
        prob_new = jax.tree_util.tree_map(
            lambda x, y: jnp.where(accept, x, y), candidate, prob
        )
        chi2_new = jnp.where(accept, chi2_c, chi2)
        factor = jnp.maximum(1.0 / 3.0, 1.0 - (2.0 * rho - 1.0) ** 3)
        mu_new = jnp.where(accept, mu * factor, mu * nu)
        nu_new = jnp.where(accept, 2.0, nu * 2.0)
        return (prob_new, chi2_new, mu_new, nu_new, n_acc + accept), None

    init = (problem, chi20, mu0, jnp.asarray(2.0, chi20.dtype), jnp.asarray(0, jnp.int32))
    (problem, chi2, _, _, n_acc), _ = jax.lax.scan(body, init, None, length=num_iters)
    return problem, chi2, n_acc


def global_ba_cg(
    problem: BAProblem, cam: reproj.Camera, num_iters: int = 20
) -> Tuple[BAProblem, jnp.ndarray, BAStats]:
    """Whole-map global BA on the matrix-free engine (jit-wrapped by size)."""
    delta2 = math.sqrt(losses.CHI2_2DOF)
    run = jax.jit(
        lambda p: ba_iterate_cg(
            p, cam, p.obs_valid, num_iters, robust_delta=delta2
        ),
        static_argnums=(),
    )
    problem, chi2, acc = run(problem)
    is_stereo = problem.obs_uvr[..., 2] >= 0.0
    gate = jnp.where(is_stereo, losses.CHI2_3DOF, losses.CHI2_2DOF)
    e2, z = edge_chi2_and_depth(problem, cam)
    survivors = problem.obs_valid & (e2 <= gate) & (z > 0)
    stats = BAStats(chi2=chi2, num_inlier_edges=jnp.sum(survivors), iters_accepted=acc)
    return problem, survivors, stats


def global_ba(
    problem: BAProblem, cam: reproj.Camera, num_iters: int = 20
) -> Tuple[BAProblem, jnp.ndarray, BAStats]:
    """Global BA: all KFs + MPs, 20 robust iters (g2oOptimizer.cc:80-385)."""
    delta2 = math.sqrt(losses.CHI2_2DOF)
    problem, chi2, acc = ba_iterate(
        problem, cam, problem.obs_valid, num_iters, robust_delta=delta2
    )
    is_stereo = problem.obs_uvr[..., 2] >= 0.0
    gate = jnp.where(is_stereo, losses.CHI2_3DOF, losses.CHI2_2DOF)
    e2, z = edge_chi2_and_depth(problem, cam)
    survivors = problem.obs_valid & (e2 <= gate) & (z > 0)
    stats = BAStats(chi2=chi2, num_inlier_edges=jnp.sum(survivors), iters_accepted=acc)
    return problem, survivors, stats
