"""Monocular two-view initialization — batched H/F RANSAC + model selection.

JAX redesign of `Initializer`
(/root/reference/src/frontend/Initializer.cc): the reference launches two
CPU threads computing homography and fundamental RANSAC in parallel
(Initializer.cc:186-192); here BOTH hypothesis banks are batched device
computations inside one jit (SURVEY §2.10 P4):

  * `FindFundamental` (:343) -> vmapped normalized 8-point solves;
  * `FindHomography` (:238) -> vmapped normalized 4-point DLT;
  * symmetric-transfer scoring with the reference's chi2 gates
    (`CheckFundamental`/`CheckHomography` :462-640, th 3.841/5.991, score
    offset 5.991);
  * model selection RH = SH/(SH+SF) > 0.40 (:219-232);
  * motion recovery: E-decomposition (4 candidates, `DecomposeE` :1711) or
    SVD homography decomposition (8 candidates, Faugeras-style
    `ReconstructH` :1052), each cheirality-checked by batched triangulation
    (`CheckRT` :1521) — all candidates evaluated at once instead of
    sequential trial loops.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..factors.reprojection import Camera
from ..geometry import se3
from .triangulation import _dlt_triangulate

CHI2_F = 3.841  # 1-dof gate (point-line)
CHI2_H = 5.991  # 2-dof gate (point-point)


class InitResult(NamedTuple):
    success: jnp.ndarray  # () bool
    T_21: se3.SE3  # pose of view 2 w.r.t. view 1 (world = cam1), unit-norm t
    points_w: jnp.ndarray  # (N, 3) triangulated points (world = cam1 frame)
    good: jnp.ndarray  # (N,) bool inlier + cheirality mask
    used_homography: jnp.ndarray  # () bool


def _normalize(xy, valid):
    """Hartley normalization (mean 0, mean abs dev 1) as an affine T."""
    w = valid.astype(xy.dtype)
    n = jnp.maximum(jnp.sum(w), 1.0)
    mu = jnp.sum(xy * w[:, None], axis=0) / n
    d = jnp.sum(jnp.abs(xy - mu) * w[:, None], axis=0) / n
    s = 1.0 / jnp.maximum(d, 1e-8)
    xn = (xy - mu) * s
    T = jnp.array(
        [[s[0], 0.0, -mu[0] * s[0]], [0.0, s[1], -mu[1] * s[1]], [0.0, 0.0, 1.0]],
        dtype=xy.dtype,
    )
    return xn, T


def _eight_point_F(x1n, x2n):
    """(8,2)x2 -> F (3,3) in normalized coords (smallest singular vector +
    rank-2 projection)."""
    u1, v1 = x1n[:, 0], x1n[:, 1]
    u2, v2 = x2n[:, 0], x2n[:, 1]
    one = jnp.ones_like(u1)
    A = jnp.stack(
        [u2 * u1, u2 * v1, u2, v2 * u1, v2 * v1, v2, u1, v1, one], axis=-1
    )  # (8, 9)
    _, _, Vt = jnp.linalg.svd(A, full_matrices=True)
    F = Vt[-1].reshape(3, 3)
    U, D, Vt2 = jnp.linalg.svd(F)
    D = D.at[2].set(0.0)
    return U @ jnp.diag(D) @ Vt2


def _four_point_H(x1n, x2n):
    """(4,2)x2 -> H (3,3) by DLT in normalized coords."""
    u1, v1 = x1n[:, 0], x1n[:, 1]
    u2, v2 = x2n[:, 0], x2n[:, 1]
    zero = jnp.zeros_like(u1)
    one = jnp.ones_like(u1)
    r1 = jnp.stack([zero, zero, zero, -u1, -v1, -one, v2 * u1, v2 * v1, v2], -1)
    r2 = jnp.stack([u1, v1, one, zero, zero, zero, -u2 * u1, -u2 * v1, -u2], -1)
    A = jnp.concatenate([r1, r2], axis=0)  # (8, 9)
    _, _, Vt = jnp.linalg.svd(A, full_matrices=True)
    return Vt[-1].reshape(3, 3)


def _fit_F_masked(x1n, x2n, mask):
    """LS 8-point fit over all inlier rows (masked-out rows zeroed)."""
    u1, v1 = x1n[:, 0], x1n[:, 1]
    u2, v2 = x2n[:, 0], x2n[:, 1]
    one = jnp.ones_like(u1)
    A = jnp.stack(
        [u2 * u1, u2 * v1, u2, v2 * u1, v2 * v1, v2, u1, v1, one], axis=-1
    ) * mask[:, None].astype(x1n.dtype)
    _, _, Vt = jnp.linalg.svd(A, full_matrices=False)
    F = Vt[-1].reshape(3, 3)
    U, D, Vt2 = jnp.linalg.svd(F)
    return U @ jnp.diag(D.at[2].set(0.0)) @ Vt2


def _fit_H_masked(x1n, x2n, mask):
    """LS DLT homography fit over all inlier rows."""
    u1, v1 = x1n[:, 0], x1n[:, 1]
    u2, v2 = x2n[:, 0], x2n[:, 1]
    zero = jnp.zeros_like(u1)
    one = jnp.ones_like(u1)
    r1 = jnp.stack([zero, zero, zero, -u1, -v1, -one, v2 * u1, v2 * v1, v2], -1)
    r2 = jnp.stack([u1, v1, one, zero, zero, zero, -u2 * u1, -u2 * v1, -u2], -1)
    m = mask[:, None].astype(x1n.dtype)
    A = jnp.concatenate([r1 * m, r2 * m], axis=0)
    _, _, Vt = jnp.linalg.svd(A, full_matrices=False)
    return Vt[-1].reshape(3, 3)


def _score_F(F, x1, x2, valid, sigma2=1.0):
    """Symmetric epipolar-distance score (CheckFundamental :540-640)."""
    x1h = jnp.concatenate([x1, jnp.ones_like(x1[:, :1])], -1)
    x2h = jnp.concatenate([x2, jnp.ones_like(x2[:, :1])], -1)
    l2 = x1h @ F.T  # lines in image 2
    l1 = x2h @ F  # lines in image 1
    d2 = (jnp.sum(x2h * l2, -1) ** 2) / (l2[:, 0] ** 2 + l2[:, 1] ** 2 + 1e-12)
    d1 = (jnp.sum(x1h * l1, -1) ** 2) / (l1[:, 0] ** 2 + l1[:, 1] ** 2 + 1e-12)
    c1, c2 = d1 / sigma2, d2 / sigma2
    ok = (c1 < CHI2_F) & (c2 < CHI2_F) & valid
    score = jnp.sum(
        jnp.where(valid & (c1 < CHI2_F), CHI2_H - c1, 0.0)
        + jnp.where(valid & (c2 < CHI2_F), CHI2_H - c2, 0.0)
    )
    return score, ok


def _score_H(H, x1, x2, valid, sigma2=1.0):
    """Symmetric transfer-error score (CheckHomography :462-540)."""
    Hinv = jnp.linalg.inv(H)

    def terr(M, a, b):
        ah = jnp.concatenate([a, jnp.ones_like(a[:, :1])], -1)
        p = ah @ M.T
        p = p[:, :2] / jnp.where(jnp.abs(p[:, 2:]) > 1e-9, p[:, 2:], 1e-9)
        return jnp.sum((p - b) ** 2, -1)

    c1 = terr(Hinv, x2, x1) / sigma2
    c2 = terr(H, x1, x2) / sigma2
    ok = (c1 < CHI2_H) & (c2 < CHI2_H) & valid
    score = jnp.sum(
        jnp.where(valid & (c1 < CHI2_H), CHI2_H - c1, 0.0)
        + jnp.where(valid & (c2 < CHI2_H), CHI2_H - c2, 0.0)
    )
    return score, ok


def _check_RT(R, t, x1, x2, valid, cam: Camera, sigma2=4.0):
    """Triangulate under (R, t) and count good points (CheckRT :1521).

    Returns (n_good, parallax_deg, X, good_mask)."""
    K = jnp.array(
        [[cam.fx, 0, cam.cx], [0, cam.fy, cam.cy], [0, 0, 1.0]], dtype=x1.dtype
    )
    P1 = K @ jnp.concatenate([jnp.eye(3, dtype=x1.dtype), jnp.zeros((3, 1), x1.dtype)], -1)
    P2 = K @ jnp.concatenate([R, t[:, None]], -1)
    X = _dlt_triangulate(x1, x2, P1, P2)

    z1 = X[:, 2]
    x_c2 = X @ R.T + t
    z2 = x_c2[:, 2]
    # Parallax.
    r1 = X
    r2 = X - (-R.T @ t)
    cosp = jnp.sum(r1 * r2, -1) / (
        jnp.linalg.norm(r1, axis=-1) * jnp.linalg.norm(r2, axis=-1) + 1e-9
    )
    # Reprojection.
    uv1 = (X @ K.T)[:, :2] / jnp.maximum(z1, 1e-9)[:, None]
    uv2 = (x_c2 @ K.T)[:, :2] / jnp.maximum(z2, 1e-9)[:, None]
    e1 = jnp.sum((uv1 - x1) ** 2, -1)
    e2 = jnp.sum((uv2 - x2) ** 2, -1)
    good = (
        valid
        & (z1 > 0)
        & (z2 > 0)
        & (cosp < 0.99998)
        & (e1 < sigma2)
        & (e2 < sigma2)
        & jnp.isfinite(X).all(-1)
    )
    # 50th-best parallax as the quality signal (ref takes the 50th smallest).
    cosp_good = jnp.where(good, cosp, 1.0)
    par = jnp.degrees(jnp.arccos(jnp.clip(jnp.sort(cosp_good)[jnp.minimum(50, cosp_good.shape[0] - 1)], -1, 1)))
    return jnp.sum(good), par, X, good


def _decompose_E(E):
    """E -> 4 (R, t) candidates (DecomposeE :1711)."""
    U, _, Vt = jnp.linalg.svd(E)
    # Ensure proper rotations.
    U = U * jnp.sign(jnp.linalg.det(U))
    Vt = Vt * jnp.sign(jnp.linalg.det(Vt))
    W = jnp.array([[0.0, -1.0, 0.0], [1.0, 0.0, 0.0], [0.0, 0.0, 1.0]], E.dtype)
    R1 = U @ W @ Vt
    R2 = U @ W.T @ Vt
    t = U[:, 2]
    t = t / jnp.maximum(jnp.linalg.norm(t), 1e-9)
    return (
        jnp.stack([R1, R1, R2, R2]),
        jnp.stack([t, -t, t, -t]),
    )


def _decompose_H(H, K):
    """Faugeras SVD homography decomposition -> 8 (R, t) candidates
    (ReconstructH :1052)."""
    A = jnp.linalg.inv(K) @ H @ K
    U, w, Vt = jnp.linalg.svd(A)
    s = jnp.linalg.det(U) * jnp.linalg.det(Vt)
    d1, d2, d3 = w[0], w[1], w[2]

    aux1 = jnp.sqrt(jnp.maximum((d1 * d1 - d2 * d2) / jnp.maximum(d1 * d1 - d3 * d3, 1e-12), 0.0))
    aux3 = jnp.sqrt(jnp.maximum((d2 * d2 - d3 * d3) / jnp.maximum(d1 * d1 - d3 * d3, 1e-12), 0.0))
    x1s = jnp.array([aux1, aux1, -aux1, -aux1])
    x3s = jnp.array([aux3, -aux3, aux3, -aux3])

    # d' = d2 case (positive).
    aux_st = jnp.sqrt(
        jnp.maximum((d1 * d1 - d2 * d2) * (d2 * d2 - d3 * d3), 0.0)
    ) / jnp.maximum((d1 + d3) * d2, 1e-12)
    ct = (d2 * d2 + d1 * d3) / jnp.maximum((d1 + d3) * d2, 1e-12)
    st = jnp.array([aux_st, -aux_st, -aux_st, aux_st])

    def mk_pos(i):
        Rp = jnp.array(
            [[ct, 0.0, -st[i]], [0.0, 1.0, 0.0], [st[i], 0.0, ct]]
        )
        tp = (d1 - d3) * jnp.array([x1s[i], 0.0, -x3s[i]])
        R = s * U @ Rp @ Vt
        t = U @ tp
        return R, t / jnp.maximum(jnp.linalg.norm(t), 1e-9)

    # d' = -d2 case.
    aux_sp = jnp.sqrt(
        jnp.maximum((d1 * d1 - d2 * d2) * (d2 * d2 - d3 * d3), 0.0)
    ) / jnp.maximum((d1 - d3) * d2, 1e-12)
    cp = (d1 * d3 - d2 * d2) / jnp.maximum((d1 - d3) * d2, 1e-12)
    sp = jnp.array([aux_sp, -aux_sp, -aux_sp, aux_sp])

    def mk_neg(i):
        Rp = jnp.array(
            [[cp, 0.0, sp[i]], [0.0, -1.0, 0.0], [sp[i], 0.0, -cp]]
        )
        tp = (d1 + d3) * jnp.array([x1s[i], 0.0, x3s[i]])
        R = s * U @ Rp @ Vt
        t = U @ tp
        return R, t / jnp.maximum(jnp.linalg.norm(t), 1e-9)

    Rs, ts = [], []
    for i in range(4):
        R, t = mk_pos(i)
        Rs.append(R)
        ts.append(t)
    for i in range(4):
        R, t = mk_neg(i)
        Rs.append(R)
        ts.append(t)
    return jnp.stack(Rs), jnp.stack(ts)


@functools.partial(jax.jit, static_argnames=("cam", "num_hypotheses"))
def initialize_two_view(
    key: jnp.ndarray,
    xy1: jnp.ndarray,  # (N, 2) matched pixels in frame 1
    xy2: jnp.ndarray,  # (N, 2) matched pixels in frame 2 (same row = match)
    valid: jnp.ndarray,  # (N,) bool
    cam: Camera,
    num_hypotheses: int = 200,
) -> InitResult:
    """Full two-view initialization in one jitted computation."""
    N = xy1.shape[0]
    H_ = num_hypotheses
    x1n, T1 = _normalize(xy1, valid)
    x2n, T2 = _normalize(xy2, valid)

    kF, kH = jax.random.split(key)

    def sample(k, m):
        g = jax.random.gumbel(k, (H_, N))
        g = jnp.where(valid[None, :], g, -jnp.inf)
        _, sel = jax.lax.top_k(g, m)
        return sel

    # --- Fundamental bank ---
    selF = sample(kF, 8)
    Fn = jax.vmap(_eight_point_F)(x1n[selF], x2n[selF])
    F = jnp.einsum("ij,hjk,kl->hil", T2.T, Fn, T1)  # de-normalize
    scoresF, oksF = jax.vmap(lambda f: _score_F(f, xy1, xy2, valid))(F)
    bF = jnp.argmax(scoresF)
    SF, F_best, inF = scoresF[bF], F[bF], oksF[bF]
    # Consensus refit on all inliers (LS 8-point over the masked rows —
    # zeroed rows drop out of A^T A). Keep whichever scores higher.
    F_fit = _fit_F_masked(x1n, x2n, inF)
    F_fit = T2.T @ F_fit @ T1
    SF2, inF2 = _score_F(F_fit, xy1, xy2, valid)
    better = SF2 > SF
    SF = jnp.where(better, SF2, SF)
    F_best = jnp.where(better, F_fit, F_best)
    inF = jnp.where(better, inF2, inF)

    # --- Homography bank ---
    selH = sample(kH, 4)
    Hn = jax.vmap(_four_point_H)(x1n[selH], x2n[selH])
    Hm = jnp.einsum("ij,hjk,kl->hil", jnp.linalg.inv(T2), Hn, T1)
    scoresH, oksH = jax.vmap(lambda h: _score_H(h, xy1, xy2, valid))(Hm)
    bH = jnp.argmax(scoresH)
    SH, H_best, inH = scoresH[bH], Hm[bH], oksH[bH]
    H_fit = _fit_H_masked(x1n, x2n, inH)
    H_fit = jnp.linalg.inv(T2) @ H_fit @ T1
    SH2, inH2 = _score_H(H_fit, xy1, xy2, valid)
    betterH = SH2 > SH
    SH = jnp.where(betterH, SH2, SH)
    H_best = jnp.where(betterH, H_fit, H_best)
    inH = jnp.where(betterH, inH2, inH)

    RH = SH / jnp.maximum(SH + SF, 1e-9)
    use_H = RH > 0.40  # Initializer.cc:230

    K = jnp.array(
        [[cam.fx, 0, cam.cx], [0, cam.fy, cam.cy], [0, 0, 1.0]], dtype=xy1.dtype
    )
    # Candidate motions from both models (padded to 8 each; E gives 4).
    E = K.T @ F_best @ K
    Re, te = _decompose_E(E)
    Re = jnp.concatenate([Re, Re], axis=0)  # pad 4 -> 8 (masked below)
    te = jnp.concatenate([te, te], axis=0)
    Rh, th = _decompose_H(H_best, K)

    Rs = jnp.where(use_H, Rh, Re)
    ts = jnp.where(use_H, th, te)
    inliers = jnp.where(use_H, inH, inF)
    # E decomposition has only 4 real candidates; rows 4-7 are pad copies
    # that must not count as a competing second-best hypothesis.
    cand_valid = jnp.where(use_H, jnp.ones(8, bool), jnp.arange(8) < 4)

    n_good, par, Xs, goods = jax.vmap(
        lambda R, t: _check_RT(R, t, xy1, xy2, inliers, cam)
    )(Rs, ts)
    n_good = jnp.where(cand_valid, n_good, -1)
    best = jnp.argmax(n_good)
    nbest = n_good[best]
    n_inl = jnp.sum(inliers)
    # Acceptance (ReconstructF :886-1052): clear winner, enough points,
    # enough parallax.
    second = jnp.sort(n_good)[-2]
    distinct = jnp.where(use_H, True, second < 0.75 * nbest)
    success = (
        (nbest >= 30)
        & (nbest > 0.8 * n_inl)
        & distinct
        & (par[best] > 0.5)
    )
    return InitResult(
        success=success,
        T_21=se3.SE3(Rs[best], ts[best]),
        points_w=Xs[best],
        good=goods[best],
        used_homography=use_H,
    )
