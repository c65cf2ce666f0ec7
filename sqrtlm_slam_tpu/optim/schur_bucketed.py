"""Landmark-bucketed Schur BA engine — the production BA engine.

Same algebra as optim/schur.py (damped LM + landmark Schur elimination,
mirroring the reference's mybackend `Problem::SolveLinearSystem`,
/root/reference/src/backend/mybackend/problem.cc:429-563) but with the
observation edges laid out **bucketed by landmark**: obs arrays have shape
(L, K) where K is the per-landmark observation capacity (the map store
already stores observations this way, mapstore/store.py `lm_obs_kf`).

Inside the engine every per-slot quantity is a (K, L) row with landmarks on
the last axis (`ObsRows`): residuals and Jacobians are elementwise chains
over whole (K, L) arrays, landmark-local reductions (Hll, bl,
back-substitution) are sums over K, and pose-side reductions are
`segment_sum`s over the slot's camera index. The Schur reduction uses the
square-root form

    Hll_d = Lc Lc^T          (closed-form 3x3 Cholesky per landmark)
    V     = U Lc^{-T}        (whitened cross blocks, U = Jp^T w Jl)
    Y     = V placed by camera            (P*6, L*3)
    S     = Hpp_d - Y Y^T                 (banded by covisibility)
    rhs   = -(bp - Y (Lc^{-1} bl))

— the per-edge square-root information factoring that gives the reference
its "SqrtLM" name (edge.h:95-99), applied blockwise. Local windows form S
explicitly (`ba_iterate`); whole-map global BA applies it matrix-free inside
PCG (`ba_iterate_cg`). PERF.md records the timings that chose this layout.
"""

from __future__ import annotations

import functools
import math
from typing import NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp

from ..factors import reprojection as reproj
from ..geometry import se3
from . import loss as losses

HIGHEST = jax.lax.Precision.HIGHEST


class BucketedBAProblem(NamedTuple):
    """Fixed-capacity BA problem with (L, K) landmark-bucketed observations."""

    pose_R: jnp.ndarray  # (P, 3, 3)
    pose_t: jnp.ndarray  # (P, 3)
    pose_fixed: jnp.ndarray  # (P,) bool
    pose_valid: jnp.ndarray  # (P,) bool
    points: jnp.ndarray  # (L, 3)
    point_valid: jnp.ndarray  # (L,) bool
    obs_cam: jnp.ndarray  # (L, K) int32 pose index (0 where invalid)
    obs_uvr: jnp.ndarray  # (L, K, 3) [u, v, u_right]; u_right < 0 -> mono
    obs_inv_sigma2: jnp.ndarray  # (L, K)
    obs_valid: jnp.ndarray  # (L, K) bool

    @property
    def num_poses(self):
        return self.pose_R.shape[0]

    @property
    def num_points(self):
        return self.points.shape[0]

    def poses(self) -> se3.SE3:
        return se3.SE3(self.pose_R, self.pose_t)


def from_flat(problem, K: int) -> BucketedBAProblem:
    """Re-bucket a flat BAProblem (E,) by landmark into (L, K) slots.

    Host-side one-time conversion (numpy); asserts no landmark exceeds K
    observations among valid edges.
    """
    import numpy as np

    L = problem.points.shape[0]
    obs_pt = np.asarray(problem.obs_pt)
    obs_cam = np.asarray(problem.obs_cam)
    obs_uvr = np.asarray(problem.obs_uvr)
    obs_is2 = np.asarray(problem.obs_inv_sigma2)
    obs_val = np.asarray(problem.obs_valid)

    cam_b = np.zeros((L, K), np.int32)
    uvr_b = np.full((L, K, 3), -1.0, np.float32)
    is2_b = np.ones((L, K), np.float32)
    val_b = np.zeros((L, K), bool)
    # Argsort compaction instead of a per-edge Python loop (the loop costs
    # seconds at the 6e5-edge scale shape): stable-sort valid edges by
    # landmark, then slot k of landmark l = rank within its run.
    ev = np.nonzero(obs_val)[0]
    lv = obs_pt[ev]
    order = np.argsort(lv, kind="stable")
    ev, lv = ev[order], lv[order]
    counts = np.bincount(lv, minlength=L)
    if counts.max(initial=0) > K:
        worst = int(np.argmax(counts))
        raise ValueError(f"landmark {worst} has more than K={K} observations")
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
    slot = np.arange(len(ev)) - starts[lv]
    cam_b[lv, slot] = obs_cam[ev]
    uvr_b[lv, slot] = obs_uvr[ev]
    is2_b[lv, slot] = obs_is2[ev]
    val_b[lv, slot] = True
    return BucketedBAProblem(
        pose_R=problem.pose_R,
        pose_t=problem.pose_t,
        pose_fixed=problem.pose_fixed,
        pose_valid=problem.pose_valid,
        points=problem.points,
        point_valid=problem.point_valid,
        obs_cam=jnp.asarray(cam_b),
        obs_uvr=jnp.asarray(uvr_b),
        obs_inv_sigma2=jnp.asarray(is2_b),
        obs_valid=jnp.asarray(val_b),
    )


# ----------------------------------------------------------------------
# Rows layout: per-slot quantities as (K, L) arrays, landmarks last.
# ----------------------------------------------------------------------


class ObsRows(NamedTuple):
    """Observation buffers in rows layout. They are constant over an LM loop
    (the observation graph, weights and pose mask do not change), so loops
    prepare them once."""

    uvr: jnp.ndarray  # (3, K, L) [u, v, u_right]
    w: jnp.ndarray  # (K, L) inv_sigma2 * active
    stereo: jnp.ndarray  # (K, L) 1.0 where the slot has a right-image u
    free: jnp.ndarray  # (K, L) 1.0 where the observing pose is free
    cam: jnp.ndarray  # (K, L) int32 pose index


def prepare_obs(problem: BucketedBAProblem, active) -> ObsRows:
    dtype = problem.points.dtype
    return ObsRows(
        uvr=problem.obs_uvr.transpose(2, 1, 0),
        w=(problem.obs_inv_sigma2 * active.astype(dtype)).T,
        stereo=(problem.obs_uvr[..., 2] >= 0.0).T.astype(dtype),
        free=(~problem.pose_fixed)[problem.obs_cam].T.astype(dtype),
        cam=problem.obs_cam.T,
    )


def _pose_gather(v: jnp.ndarray, cam_t: jnp.ndarray) -> jnp.ndarray:
    """v (P, D) -> (D, K, L): each slot's row of its observing pose."""
    return jnp.take(v.T, cam_t, axis=1)


def _pose_sum(X: jnp.ndarray, cam_t: jnp.ndarray, P: int) -> jnp.ndarray:
    """Sum slot values X (D, K, L) into their pose rows -> (P, D)."""
    D = X.shape[0]
    return jax.ops.segment_sum(
        X.reshape(D, -1).T, cam_t.reshape(-1), num_segments=P
    )


def _project(problem: BucketedBAProblem, obs: ObsRows, cam: reproj.Camera):
    """Gathered poses g (12, K, L) — rows 0-8 R row-major, 9-11 t — the
    camera-frame point rows x_c, 1/z, and the stereo residual rows
    (factors/reprojection.py::stereo_residual_jac; mono slots zero the
    u_right row)."""
    P = problem.num_poses
    pose12 = jnp.concatenate(
        [problem.pose_R.reshape(P, 9), problem.pose_t], axis=1
    )
    g = _pose_gather(pose12, obs.cam)
    X = problem.points.T[:, None, :]  # (3, 1, L) broadcasts over K
    xc = [
        g[3 * i] * X[0] + g[3 * i + 1] * X[1] + g[3 * i + 2] * X[2] + g[9 + i]
        for i in range(3)
    ]
    iz = 1.0 / jnp.maximum(xc[2], reproj._ZEPS)
    u = cam.fx * xc[0] * iz + cam.cx
    v = cam.fy * xc[1] * iz + cam.cy
    r = [
        u - obs.uvr[0],
        v - obs.uvr[1],
        (u - cam.bf * iz - obs.uvr[2]) * obs.stereo,
    ]
    return g, xc, iz, r


def _robust(obs: ObsRows, r, robust_delta):
    """Info-weighted squared error e2, robust cost rho (zero on inactive
    slots) and IRLS weight w (optim/loss.py Huber)."""
    e2 = obs.w * (r[0] * r[0] + r[1] * r[1] + r[2] * r[2])
    if robust_delta is None:
        rho, w = e2, obs.w
    else:
        rho, w_rob, _ = losses.huber(robust_delta)(e2)
        w = obs.w * w_rob
    return e2, jnp.where(obs.w > 0, rho, 0.0), w


def _chi2(problem: BucketedBAProblem, obs: ObsRows, cam, robust_delta):
    _, _, _, r = _project(problem, obs, cam)
    return jnp.sum(_robust(obs, r, robust_delta)[1])


def chi2_only(problem: BucketedBAProblem, cam, active, robust_delta):
    """Robust chi2 over the active slots."""
    return _chi2(problem, prepare_obs(problem, active), cam, robust_delta)


def edge_chi2_and_depth(problem: BucketedBAProblem, cam: reproj.Camera):
    """Per-slot chi2 (info-weighted) and camera-frame depth (L, K), for
    gating."""
    obs = prepare_obs(problem, problem.obs_valid)
    _, xc, _, r = _project(problem, obs, cam)
    e2 = _robust(obs, r, None)[0]
    return e2.T, xc[2].T


class Reductions(NamedTuple):
    """Mu-independent reductions at one linearization point: everything the
    damped step needs that does NOT depend on the LM damping mu, so LM loops
    carry it across iterations and re-damp cheaply on rejection."""

    hll9: jnp.ndarray  # (9, L) rows of Hll (row-major 3x3)
    bl3: jnp.ndarray  # (3, L)
    u18: jnp.ndarray  # (18, K, L) rows of U = Jp^T w Jl: index 3*i+j = U[i, j]
    Hpp: jnp.ndarray  # (P, 6, 6)
    bp: jnp.ndarray  # (P, 6)
    chi2: jnp.ndarray  # ()


def assemble(
    problem: BucketedBAProblem, obs: ObsRows, cam: reproj.Camera, robust_delta
) -> Reductions:
    """Residuals, analytic Jacobians, Huber weights and all reductions in one
    elementwise pass (the reference's `MakeHessian`, problem.cc:429-563).
    Fixed poses get no pose Jacobian (g2o setFixed, g2oOptimizer.cc:760)."""
    P = problem.num_poses
    g, xc, iz, r = _project(problem, obs, cam)
    iz2 = iz * iz
    st = obs.stereo
    zero = jnp.zeros_like(iz)
    # d(u, v, u_right)/d x_c; the stereo row is masked by st.
    d = [
        [cam.fx * iz, zero, -cam.fx * xc[0] * iz2],
        [zero, cam.fy * iz, -cam.fy * xc[1] * iz2],
        [cam.fx * iz * st, zero, (-cam.fx * xc[0] * iz2 + cam.bf * iz2) * st],
    ]
    # Jp = d @ [I | -hat(x_c)] (left-multiplicative update), Jl = d @ R.
    Jp = [
        [
            d[a][0] * obs.free,
            d[a][1] * obs.free,
            d[a][2] * obs.free,
            (-d[a][1] * xc[2] + d[a][2] * xc[1]) * obs.free,
            (d[a][0] * xc[2] - d[a][2] * xc[0]) * obs.free,
            (-d[a][0] * xc[1] + d[a][1] * xc[0]) * obs.free,
        ]
        for a in range(3)
    ]
    Jl = [
        [sum(d[a][m] * g[3 * m + j] for m in range(3)) for j in range(3)]
        for a in range(3)
    ]
    _, rho, w = _robust(obs, r, robust_delta)

    def jtwj(A, i, B, j):
        return sum(A[a][i] * w * B[a][j] for a in range(3))

    def jtwr(A, i):
        return sum(A[a][i] * w * r[a] for a in range(3))

    hll9 = jnp.stack(
        [jnp.sum(jtwj(Jl, i, Jl, j), axis=0) for i in range(3) for j in range(3)]
    )
    bl3 = jnp.stack([jnp.sum(jtwr(Jl, i), axis=0) for i in range(3)])
    u18 = jnp.stack([jtwj(Jp, i, Jl, j) for i in range(6) for j in range(3)])
    hb = jnp.stack(
        [jtwj(Jp, i, Jp, j) for i in range(6) for j in range(6)]
        + [jtwr(Jp, i) for i in range(6)]
    )  # (42, K, L)
    pose_rows = _pose_sum(hb, obs.cam, P)
    return Reductions(
        hll9=hll9,
        bl3=bl3,
        u18=u18,
        Hpp=pose_rows[:, :36].reshape(P, 6, 6),
        bp=pose_rows[:, 36:],
        chi2=jnp.sum(rho),
    )


# ----------------------------------------------------------------------
# Sqrt-Schur pieces, per landmark (rows layout).
# ----------------------------------------------------------------------


def _damped_minv(h9, point_valid, mu):
    """Damped-Hll closed-form Cholesky + lower-triangular inverse:
    (9, L) Hll rows -> (6, L) [m11, m21, m22, m31, m32, m33] of Lc^{-1}
    (Hll_d^{-1} = Minv^T Minv). Marquardt damping, problem.cc:632-676;
    invalid landmarks get identity blocks."""
    pv = point_valid
    eps = 1e-20
    a11 = jnp.where(pv, h9[0] * (1.0 + mu) + 1e-8, 1.0)
    a21 = jnp.where(pv, h9[3], 0.0)
    a31 = jnp.where(pv, h9[6], 0.0)
    a22 = jnp.where(pv, h9[4] * (1.0 + mu) + 1e-8, 1.0)
    a32 = jnp.where(pv, h9[7], 0.0)
    a33 = jnp.where(pv, h9[8] * (1.0 + mu) + 1e-8, 1.0)
    l11 = jnp.sqrt(jnp.maximum(a11, eps))
    l21 = a21 / l11
    l31 = a31 / l11
    l22 = jnp.sqrt(jnp.maximum(a22 - l21 * l21, eps))
    l32 = (a32 - l31 * l21) / l22
    l33 = jnp.sqrt(jnp.maximum(a33 - l31 * l31 - l32 * l32, eps))
    m11 = 1.0 / l11
    m22 = 1.0 / l22
    m33 = 1.0 / l33
    m21 = -l21 * m11 * m22
    m31 = (l21 * l32 - l31 * l22) * m11 * m22 * m33
    m32 = -l32 * m22 * m33
    return jnp.stack([m11, m21, m22, m31, m32, m33])


def _hinv(minv6, b3):
    """Hll_d^{-1} b = Minv^T (Minv b) for b (3, L) -> (3, L)."""
    m11, m21, m22, m31, m32, m33 = minv6
    z0 = m11 * b3[0]
    z1 = m21 * b3[0] + m22 * b3[1]
    z2 = m31 * b3[0] + m32 * b3[1] + m33 * b3[2]
    return jnp.stack(
        [m11 * z0 + m21 * z1 + m31 * z2, m22 * z1 + m32 * z2, m33 * z2]
    )


def _u_times(u18, y3):
    """Per slot U y: (18, K, L) x (3, L) -> (6, K, L)."""
    return jnp.stack(
        [sum(u18[3 * i + m] * y3[m] for m in range(3)) for i in range(6)]
    )


def _ut_times(u18, v6):
    """Sum over slots of U^T v: (18, K, L) x (6, K, L) -> (3, L)."""
    return jnp.stack(
        [
            sum(jnp.sum(u18[3 * i + j] * v6[i], axis=0) for i in range(6))
            for j in range(3)
        ]
    )


def _whiten(u18, minv6):
    """V = U Lc^{-T} per slot: V[i, j] = sum_m U[i, m] Minv[j, m]."""
    m11, m21, m22, m31, m32, m33 = minv6

    def U(i, m):
        return u18[3 * i + m]

    return jnp.stack(
        [
            row
            for i in range(6)
            for row in (
                U(i, 0) * m11,
                U(i, 0) * m21 + U(i, 1) * m22,
                U(i, 0) * m31 + U(i, 1) * m32 + U(i, 2) * m33,
            )
        ]
    )  # (18, K, L)


def _gram(V18, cam_t, P: int):
    """Y Y^T for the slots of V18 (18, K, L): Y[x, p, l] = sum_k
    [cam[k, l] == p] V18[x, k, l]. The placement is an exact 0/1
    selection, hence HIGHEST precision."""
    O = jax.nn.one_hot(cam_t, P, axis=1, dtype=V18.dtype)  # (K, P, L)
    Y6 = jnp.einsum("kpl,xkl->xpl", O, V18, precision=HIGHEST).reshape(
        6, 3, P, -1
    )
    return jnp.einsum("imal,jmbl->aibj", Y6, Y6).reshape(P * 6, P * 6)


class ChunkPlan(NamedTuple):
    """Loop-constant layout for the banded (chunked) S-Gram product.

    The dense reduced-system product S_corr = Y Y^T contracts over ALL
    landmarks for EVERY pose pair — 1.6e10 flops at P=96, L=8192 — yet
    covisibility makes Y block-banded: a landmark's observations touch a
    handful of nearby keyframes (SURVEY §5.7, the locality the reference's
    sparse CHOLMOD exploits implicitly). Chunking landmarks by index (map
    stores create them in keyframe order, so index ≈ pose locality) and
    forming each chunk's Gram over a small local pose WINDOW cuts the
    product to C·(6W)²·3Lc flops (~36x fewer at that shape). Landmarks whose
    observations escape their chunk's window (loop closures) fall back to
    the exact dense product, gated by lax.cond so the common all-covered
    case never pays for it.

    Built once per LM loop from the (loop-constant) observation graph."""

    Ol: jnp.ndarray  # (K, C, W, Lc) local one-hot
    wc: jnp.ndarray  # (C,) int32 window start pose of each chunk
    E6: jnp.ndarray  # (C, P*6, W*6) block-placement one-hot kron(Ec, I6)
    cov: jnp.ndarray  # (L,) bool — landmark fully inside its chunk window
    n_uncovered: jnp.ndarray  # () int32


def plan_chunks(
    cam_t: jnp.ndarray, wvalid: jnp.ndarray, P: int,
    Lc: int = 256, W: int = 16,
) -> Optional[ChunkPlan]:
    """Build the chunked-Gram layout from the (K, L) camera assignment.

    cam_t: (K, L) int32 pose per slot; wvalid: (K, L) bool active slots.
    Returns None when the shape cannot chunk (L not a multiple of Lc, or
    the window would not fit a meaningful band)."""
    K, L = cam_t.shape
    if L % Lc != 0 or P <= W:
        return None
    C = L // Lc
    camc = cam_t.reshape(K, C, Lc)
    act = wvalid.reshape(K, C, Lc)
    cam_for_min = jnp.where(act, camc, P)
    wc = jnp.min(cam_for_min, axis=(0, 2))  # (C,)
    wc = jnp.clip(wc, 0, max(P - W, 0)).astype(jnp.int32)
    rel = camc - wc[None, :, None]
    inwin = (rel >= 0) & (rel < W)
    cov = jnp.all(inwin | ~act, axis=0).reshape(L)  # (L,)
    relc = jnp.clip(rel, 0, W - 1)
    # one_hot appends the class axis last -> (K, C, Lc, W); move W before Lc
    # so landmarks stay on the last axis. Loop-constant.
    Ol = jnp.moveaxis(
        jax.nn.one_hot(relc, W, dtype=jnp.float32), -1, 2
    ) * act[:, :, None, :].astype(jnp.float32)
    # Block placement at 6-dof granularity: E6[c, 6p+i, 6w+j] = (p == wc+w)
    # * (i == j) — i.e. kron(Ec, I6). Loop-constant; places the chunk Grams
    # with two batched matmuls instead of a sequential per-chunk scatter.
    Ec = jnp.swapaxes(
        jax.nn.one_hot(wc[:, None] + jnp.arange(W)[None, :], P), 1, 2
    )  # (C, P, W)
    E6 = jnp.einsum("cpw,ij->cpiwj", Ec, jnp.eye(6)).reshape(
        C, P * 6, W * 6
    )
    n_unc = jnp.sum(~cov)
    return ChunkPlan(Ol=Ol, wc=wc, E6=E6, cov=cov, n_uncovered=n_unc)


def _chunked_S_corr(V18, plan: ChunkPlan, cam_t, P: int):
    """S_corr = Y Y^T via per-chunk local-window Grams + block placement.

    Exact: covered landmarks contribute through their chunk's (6W, 6W)
    Gram placed at the window's block offset; uncovered landmarks (if any)
    contribute through the dense product, executed only when
    n_uncovered > 0 (lax.cond). Every 0/1 selection runs at HIGHEST."""
    K, C, W, Lc = plan.Ol.shape
    covm = plan.cov.astype(V18.dtype)
    V18c = (V18 * covm).reshape(18, K, C, Lc)
    Yc = jnp.einsum(
        "kcwl,xkcl->xcwl", plan.Ol, V18c, precision=HIGHEST
    )  # (18, C, W, Lc)
    Y6c = Yc.reshape(6, 3, C, W, Lc)
    Sc = jnp.einsum("imcal,jmcbl->caibj", Y6c, Y6c).reshape(C, W * 6, W * 6)
    T1 = jnp.einsum("cra,cab->crb", plan.E6, Sc, precision=HIGHEST)
    S_corr = jnp.einsum("crb,csb->rs", T1, plan.E6, precision=HIGHEST)

    def add_uncovered(S):
        return S + _gram(V18 * (~plan.cov).astype(V18.dtype), cam_t, P)

    return jax.lax.cond(
        plan.n_uncovered > 0, add_uncovered, lambda S: S, S_corr
    )


class LocalPieces(NamedTuple):
    """Per-shard contributions to the reduced camera system + backsub ctx.

    All of (S_half, bp, rhs_corr, chi2) sum exactly across landmark
    shards — the distributed path (parallel/dist_ba.py) psums them and
    gets algebra identical to the single-device engine."""

    S_half: jnp.ndarray  # (P*6, P*6) = blockdiag(Hpp_d) - Y Y^T
    bp: jnp.ndarray  # (P, 6)
    rhs_corr: jnp.ndarray  # (P*6,) = Y (Lc^{-1} bl)
    chi2: jnp.ndarray  # ()
    u18: jnp.ndarray  # (18, K, L) backsub context (shard-local)
    minv6: jnp.ndarray  # (6, L)
    bl3: jnp.ndarray  # (3, L)


def _damp_hpp(Hpp, mu):
    eye6 = jnp.eye(6, dtype=Hpp.dtype)
    dpp = jnp.diagonal(Hpp, axis1=-2, axis2=-1)
    return Hpp + (mu * dpp[..., None] + 1e-8) * eye6


def _pieces_tail(
    problem: BucketedBAProblem, red: Reductions, mu, cam_t,
    plan: Optional[ChunkPlan] = None,
) -> LocalPieces:
    """Damping + sqrt-Schur factors from the assembled reductions.

    Damping of Hpp is linear in Hpp's diagonal, so damping per shard and
    psum-ing matches damping the psum (the 1e-8 absolute epsilon is scaled
    by shard count there — harmless)."""
    P = problem.num_poses
    minv6 = _damped_minv(red.hll9, problem.point_valid, mu)
    V18 = _whiten(red.u18, minv6)
    if plan is not None:
        S_corr = _chunked_S_corr(V18, plan, cam_t, P)
    else:
        S_corr = _gram(V18, cam_t, P)
    Hpp_d = _damp_hpp(red.Hpp, mu)
    # Block-diagonal Hpp_d without a scatter (einsum with eye fuses).
    S_half = jnp.einsum(
        "pij,pq->piqj", Hpp_d, jnp.eye(P, dtype=Hpp_d.dtype)
    ).reshape(P * 6, P * 6) - S_corr
    # rhs_corr = Y (Lc^{-1} bl) = sum over slots of U Hll_d^{-1} bl.
    y = _hinv(minv6, red.bl3)
    rhs_corr = _pose_sum(_u_times(red.u18, y), cam_t, P).reshape(-1)
    return LocalPieces(
        S_half=S_half, bp=red.bp, rhs_corr=rhs_corr, chi2=red.chi2,
        u18=red.u18, minv6=minv6, bl3=red.bl3,
    )


def build_local_pieces(
    problem: BucketedBAProblem, cam, active, robust_delta, mu
) -> LocalPieces:
    """Everything up to (but excluding) the global pose solve."""
    obs = prepare_obs(problem, active)
    red = assemble(problem, obs, cam, robust_delta)
    return _pieces_tail(problem, red, mu, obs.cam)


def solve_pose_system(S, rhs, pose_fixed):
    """Gauge-fix + dense Cholesky solve of the reduced camera system
    (cholesky + two triangular solves)."""
    dtype = S.dtype
    fixed6 = jnp.repeat(pose_fixed, 6)
    S = jnp.where(fixed6[:, None] | fixed6[None, :], 0.0, S)
    S = S + jnp.diag(fixed6.astype(dtype))
    rhs = jnp.where(fixed6, 0.0, rhs)
    Lc = jnp.linalg.cholesky(S)
    y = jax.lax.linalg.triangular_solve(
        Lc, rhs[:, None], left_side=True, lower=True
    )
    dxp_flat = jax.lax.linalg.triangular_solve(
        Lc, y, left_side=True, lower=True, transpose_a=True
    )[:, 0]
    return dxp_flat.reshape(-1, 6)


def back_substitute(pieces: LocalPieces, problem: BucketedBAProblem, dxp, cam_t):
    """Landmark back-substitution dxl = Hll_d^{-1}(-bl - W^T dxp) — local."""
    Wt = _ut_times(pieces.u18, _pose_gather(dxp, cam_t))
    dxl = _hinv(pieces.minv6, -pieces.bl3 - Wt).T
    return jnp.where(problem.point_valid[:, None], dxl, 0.0)


def _damped_step(problem, pieces: LocalPieces, cam_t):
    """Solve the reduced system and back-substitute: (dxp, dxl)."""
    rhs = -(pieces.bp.reshape(-1) - pieces.rhs_corr)
    dxp = solve_pose_system(pieces.S_half, rhs, problem.pose_fixed)
    dxp = jnp.where(problem.pose_fixed[:, None], 0.0, dxp)
    return dxp, back_substitute(pieces, problem, dxp, cam_t)


def reduce_and_solve(problem: BucketedBAProblem, cam, active, robust_delta, mu):
    """One damped-GN step. Returns (dxp (P,6), dxl (L,3), chi2, bp, bl)."""
    pieces = build_local_pieces(problem, cam, active, robust_delta, mu)
    dxp, dxl = _damped_step(problem, pieces, problem.obs_cam.T)
    return dxp, dxl, pieces.chi2, pieces.bp, pieces.bl3.T


def _apply_update(problem: BucketedBAProblem, dxp, dxl) -> BucketedBAProblem:
    poses = se3.retract(problem.poses(), dxp)
    free = (~problem.pose_fixed)[:, None]
    new_R = jnp.where(free[..., None], poses.R, problem.pose_R)
    new_t = jnp.where(free, poses.t, problem.pose_t)
    return problem._replace(pose_R=new_R, pose_t=new_t, points=problem.points + dxl)


def ba_iterate(
    problem: BucketedBAProblem,
    cam: reproj.Camera,
    active,
    num_iters: int,
    robust_delta: Optional[float],
) -> Tuple[BucketedBAProblem, jnp.ndarray, jnp.ndarray]:
    """Nielsen-damped LM loop (protocol identical to schur.ba_iterate and
    the reference's problem.cc:92-167 — rejected steps roll back), with
    the banded S-Gram when the window allows it (`plan_chunks`)."""
    obs = prepare_obs(problem, active)
    plan = plan_chunks(obs.cam, obs.w > 0, problem.num_poses)
    return _lm_loop(problem, obs, cam, robust_delta, num_iters, plan)


def _lm_loop(
    problem: BucketedBAProblem, obs: ObsRows, cam, robust_delta,
    num_iters: int, plan: Optional[ChunkPlan],
) -> Tuple[BucketedBAProblem, jnp.ndarray, jnp.ndarray]:
    """The LM scan. It carries the mu-independent reductions of the CURRENT
    linearization point and assembles speculatively at the candidate:
    exactly ONE assembly per iteration — its chi2 is the candidate test,
    and on acceptance it becomes the next carry. A rejected step only
    re-damps the carried reductions (mu enters in `_pieces_tail` only)."""
    dtype = problem.points.dtype

    def body(carry, _):
        pose_R, pose_t, points, red, mu, nu, n_acc = carry
        prob = problem._replace(pose_R=pose_R, pose_t=pose_t, points=points)
        pieces = _pieces_tail(prob, red, mu, obs.cam, plan)
        dxp, dxl = _damped_step(prob, pieces, obs.cam)
        candidate = _apply_update(prob, dxp, dxl)
        red_c = assemble(candidate, obs, cam, robust_delta)
        accept, prob_new, mu_new, nu_new = _lm_accept(
            prob, candidate, red.chi2, red_c.chi2, dxp, dxl, red.bp,
            red.bl3.T, mu, nu,
        )
        red_new = jax.tree.map(lambda c, o: jnp.where(accept, c, o), red_c, red)
        new_carry = (
            prob_new.pose_R,
            prob_new.pose_t,
            prob_new.points,
            red_new,
            mu_new,
            nu_new,
            n_acc + accept,
        )
        return new_carry, None

    init = (
        problem.pose_R,
        problem.pose_t,
        problem.points,
        assemble(problem, obs, cam, robust_delta),
        jnp.asarray(1e-3, dtype=dtype),
        jnp.asarray(2.0, dtype=dtype),
        jnp.asarray(0, dtype=jnp.int32),
    )
    (pose_R, pose_t, points, red, _, _, n_acc), _ = jax.lax.scan(
        body, init, None, length=num_iters
    )
    problem = problem._replace(pose_R=pose_R, pose_t=pose_t, points=points)
    return problem, red.chi2, n_acc


# ----------------------------------------------------------------------
# Matrix-free Schur + PCG — the whole-map scale path.
#
# For global BA (10^3 KFs x 10^5 landmarks) S is applied matrix-free: per
# landmark K-axis reductions plus one pose-side segment_sum per matvec.
# Replaces g2o's sparse CHOLMOD factorization in `GlobalBundleAdjustemnt`
# (g2oOptimizer.cc:80-385).
# ----------------------------------------------------------------------


def _schur_matvec(v, u18, minv6, Hpp_d, cam_t, pose_fixed):
    """S @ v for v (P, 6): Hpp_d v - W Hll_d^{-1} W^T v."""
    P = Hpp_d.shape[0]
    v = jnp.where(pose_fixed[:, None], 0.0, v)
    y = _hinv(minv6, _ut_times(u18, _pose_gather(v, cam_t)))
    Wy = _pose_sum(_u_times(u18, y), cam_t, P)
    Sv = jnp.einsum("pij,pj->pi", Hpp_d, v) - Wy
    return jnp.where(pose_fixed[:, None], v, Sv)


def _pcg(matvec, b, Minv_blocks, pose_fixed, max_iters: int, tol: float):
    """Block-Jacobi preconditioned CG on the reduced camera system.

    `tol` is the inexact-Newton forcing term (stop at ||r|| <= tol ||b||):
    LM steps do not need tight linear solves — the Nielsen accept/reject
    gates step quality — so a tight tol just burns max_iters matvecs per
    step."""
    b = jnp.where(pose_fixed[:, None], 0.0, b)
    precond = lambda r: jnp.einsum("pij,pj->pi", Minv_blocks, r)
    x0 = jnp.zeros_like(b)
    r0 = b
    z0 = precond(r0)
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
        return (x, r, z + beta * p, rz_new, k + 1)

    x, _, _, _, n = jax.lax.while_loop(cond, body, (x0, r0, z0, rz0, 0))
    return x, n


def cg_reduce_and_solve(
    problem: BucketedBAProblem, cam, active, robust_delta, mu,
    cg_iters: int = 100, cg_tol: float = 1e-6, obs: Optional[ObsRows] = None,
):
    """One damped-GN step via matrix-free Schur + PCG.

    The default `cg_tol` is a tight solve; the LM loop (`ba_iterate_cg`)
    passes the inexact-Newton forcing term 1e-2 and its loop-constant `obs`.

    Returns (dxp (P,6), dxl (L,3), chi2, bp, bl, cg_n)."""
    P = problem.num_poses
    if obs is None:
        obs = prepare_obs(problem, active)
    red = assemble(problem, obs, cam, robust_delta)
    minv6 = _damped_minv(red.hll9, problem.point_valid, mu)
    Hpp_d = _damp_hpp(red.Hpp, mu)

    # rhs = -(bp - W Hll_d^{-1} bl).
    Wy = _pose_sum(_u_times(red.u18, _hinv(minv6, red.bl3)), obs.cam, P)
    rhs = -(red.bp - Wy)

    matvec = lambda v: _schur_matvec(
        v, red.u18, minv6, Hpp_d, obs.cam, problem.pose_fixed
    )
    eye6 = jnp.eye(6, dtype=Hpp_d.dtype)
    diag_ok = problem.pose_valid & ~problem.pose_fixed
    M = jnp.where(diag_ok[:, None, None], Hpp_d, eye6)
    Mp = jnp.linalg.inv(M + 1e-8 * eye6)

    dxp, cg_n = _pcg(matvec, rhs, Mp, problem.pose_fixed, cg_iters, cg_tol)
    dxp = jnp.where(problem.pose_fixed[:, None], 0.0, dxp)
    Wt = _ut_times(red.u18, _pose_gather(dxp, obs.cam))
    dxl = _hinv(minv6, -red.bl3 - Wt).T
    dxl = jnp.where(problem.point_valid[:, None], dxl, 0.0)
    return dxp, dxl, red.chi2, red.bp, red.bl3.T, cg_n


def _lm_accept(prob, candidate, chi2, chi2_c, dxp, dxl, bp, bl, mu, nu):
    """Shared Nielsen gain-ratio accept/reject bookkeeping for the LM loops."""
    dx_all = jnp.concatenate([dxp.reshape(-1), dxl.reshape(-1)])
    b_all = jnp.concatenate([bp.reshape(-1), bl.reshape(-1)])
    predicted = 0.5 * jnp.sum(dx_all * (mu * dx_all - b_all))
    rho = (chi2 - chi2_c) / jnp.maximum(predicted, 1e-12)
    accept = (rho > 0) & jnp.isfinite(chi2_c)
    prob_new = prob._replace(
        pose_R=jnp.where(accept, candidate.pose_R, prob.pose_R),
        pose_t=jnp.where(accept, candidate.pose_t, prob.pose_t),
        points=jnp.where(accept, candidate.points, prob.points),
    )
    factor = jnp.maximum(1.0 / 3.0, 1.0 - (2.0 * rho - 1.0) ** 3)
    mu_new = jnp.where(accept, mu * factor, mu * nu)
    nu_new = jnp.where(accept, 2.0, nu * 2.0)
    return accept, prob_new, mu_new, nu_new


def ba_iterate_cg(
    problem: BucketedBAProblem,
    cam: reproj.Camera,
    active,
    num_iters: int,
    robust_delta: Optional[float],
    cg_iters: int = 100,
) -> Tuple[BucketedBAProblem, jnp.ndarray, jnp.ndarray]:
    """LM loop using the matrix-free PCG step (whole-map scale)."""
    obs = prepare_obs(problem, active)
    chi20 = _chi2(problem, obs, cam, robust_delta)
    mu0 = jnp.asarray(1e-3, dtype=chi20.dtype) + 0.0 * chi20

    def body(carry, _):
        pose_R, pose_t, points, chi2, mu, nu, n_acc = carry
        prob = problem._replace(pose_R=pose_R, pose_t=pose_t, points=points)
        dxp, dxl, _, bp, bl, _ = cg_reduce_and_solve(
            prob, cam, active, robust_delta, mu, cg_iters=cg_iters,
            cg_tol=1e-2, obs=obs,
        )
        candidate = _apply_update(prob, dxp, dxl)
        chi2_c = _chi2(candidate, obs, cam, robust_delta)
        accept, prob_new, mu_new, nu_new = _lm_accept(
            prob, candidate, chi2, chi2_c, dxp, dxl, bp, bl, mu, nu
        )
        chi2_new = jnp.where(accept, chi2_c, chi2)
        new_carry = (
            prob_new.pose_R,
            prob_new.pose_t,
            prob_new.points,
            chi2_new,
            mu_new,
            nu_new,
            n_acc + accept,
        )
        return new_carry, None

    init = (
        problem.pose_R,
        problem.pose_t,
        problem.points,
        chi20,
        mu0,
        jnp.asarray(2.0, chi20.dtype),
        jnp.asarray(0, jnp.int32),
    )
    (pose_R, pose_t, points, chi2, _, _, n_acc), _ = jax.lax.scan(
        body, init, None, length=num_iters
    )
    problem = problem._replace(pose_R=pose_R, pose_t=pose_t, points=points)
    return problem, chi2, n_acc


@functools.lru_cache(maxsize=16)
def _global_ba_cg_jit(cam: reproj.Camera, num_iters: int, delta2: float):
    """Cached jitted GBA body — repeated/chunked GBA calls (interruptible
    GBA runs `gba_chunk` iterations per call) must not re-trace."""
    return jax.jit(
        lambda p: ba_iterate_cg(p, cam, p.obs_valid, num_iters, robust_delta=delta2)
    )


def global_ba_cg(
    problem: BucketedBAProblem, cam: reproj.Camera, num_iters: int = 20
):
    """Whole-map global BA on the matrix-free bucketed engine.

    Returns (problem, survivors (L,K), chi2) — the 20-robust-iteration
    protocol of `GlobalBundleAdjustemnt` (g2oOptimizer.cc:80-385)."""
    delta2 = math.sqrt(losses.CHI2_2DOF)
    run = _global_ba_cg_jit(cam, num_iters, delta2)
    problem, chi2, _ = run(problem)
    is_stereo = problem.obs_uvr[..., 2] >= 0.0
    gate = jnp.where(is_stereo, losses.CHI2_3DOF, losses.CHI2_2DOF)
    e2, z = edge_chi2_and_depth(problem, cam)
    survivors = problem.obs_valid & (e2 <= gate) & (z > 0)
    return problem, survivors, chi2


def local_ba(
    problem: BucketedBAProblem,
    cam: reproj.Camera,
    first_iters: int = 5,
    second_iters: int = 10,
):
    """Two-phase local BA protocol (5 robust iters -> chi2/depth gate ->
    10 iters), g2oOptimizer.cc:930-976. Returns (problem, survivors, chi2)."""
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
    return problem, survivors, chi2
