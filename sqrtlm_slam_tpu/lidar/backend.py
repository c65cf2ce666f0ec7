"""SE(3) pose-graph backend for the LiDAR odometry chain.

JAX redesign of `art::Odom::BackEndForLoop` / `BackEndForGNSS`
(/root/reference/src/algorithm/lidarOdom.cc:2467-2601): the reference builds
a Ceres problem over the frame chain with relative-pose `EndBackFactor`s
(lidarFactor.h:207-310) plus a loop-closure constraint (or a GNSS anchor)
and solves it sequentially. Here the whole graph is one jitted damped-GN
computation: vmapped SE3 relative residuals/Jacobians
(factors/pose_graph.se3_relative_residual_jac), dense blockwise Hessian,
Cholesky solve — same structure as the Sim3 essential graph but 6-DoF.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..factors import pose_graph
from ..geometry import se3


class Se3Graph(NamedTuple):
    """Fixed-capacity SE3 pose graph (padded + masked)."""

    R: jnp.ndarray  # (K, 3, 3) world->frame
    t: jnp.ndarray  # (K, 3)
    fixed: jnp.ndarray  # (K,) bool
    valid: jnp.ndarray  # (K,) bool
    e_i: jnp.ndarray  # (E,)
    e_j: jnp.ndarray  # (E,)
    e_R: jnp.ndarray  # (E, 3, 3) measured T_ji
    e_t: jnp.ndarray  # (E, 3)
    e_info: jnp.ndarray  # (E,) scalar information weight
    e_valid: jnp.ndarray  # (E,)
    # Unary world-position anchors (GNSS): ||C(T_k) - p_k||^2.
    a_idx: jnp.ndarray  # (A,) pose index
    a_pos: jnp.ndarray  # (A, 3) anchor world position (camera/sensor center)
    a_info: jnp.ndarray  # (A,)
    a_valid: jnp.ndarray  # (A,)


def build_chain_graph(
    poses: list,
    loop_edges: list,
    anchors: list = (),
    K_cap: int = 0,
    E_cap: int = 0,
    A_cap: int = 8,
    odom_info: float = 1.0,
    loop_info: float = 2.0,
    anchor_info: float = 10.0,
) -> Se3Graph:
    """Host-side graph assembly from an odometry chain.

    poses: list of se3.SE3 (world->frame); loop_edges: [(i, j, T_ji)];
    anchors: [(k, xyz)] GNSS-style world positions (BackEndForGNSS)."""
    K = len(poses)
    K_cap = K_cap or K
    E_cap = E_cap or (K - 1 + len(loop_edges))
    R = np.tile(np.eye(3, dtype=np.float32), (K_cap, 1, 1))
    t = np.zeros((K_cap, 3), np.float32)
    for k, p in enumerate(poses):
        R[k] = np.asarray(p.R)
        t[k] = np.asarray(p.t)
    valid = np.zeros(K_cap, bool)
    valid[:K] = True
    fixed = np.zeros(K_cap, bool)
    fixed[0] = True

    e_i = np.zeros(E_cap, np.int32)
    e_j = np.zeros(E_cap, np.int32)
    e_R = np.tile(np.eye(3, dtype=np.float32), (E_cap, 1, 1))
    e_t = np.zeros((E_cap, 3), np.float32)
    e_info = np.ones(E_cap, np.float32)
    e_valid = np.zeros(E_cap, bool)
    ne = 0
    for k in range(1, K):
        T_rel = se3.compose(poses[k], se3.inverse(poses[k - 1]))
        e_i[ne], e_j[ne] = k - 1, k
        e_R[ne] = np.asarray(T_rel.R)
        e_t[ne] = np.asarray(T_rel.t)
        e_info[ne] = odom_info
        e_valid[ne] = True
        ne += 1
    for (i, j, T_ji) in loop_edges:
        if ne >= E_cap:
            break
        e_i[ne], e_j[ne] = i, j
        e_R[ne] = np.asarray(T_ji.R)
        e_t[ne] = np.asarray(T_ji.t)
        e_info[ne] = loop_info
        e_valid[ne] = True
        ne += 1

    a_idx = np.zeros(A_cap, np.int32)
    a_pos = np.zeros((A_cap, 3), np.float32)
    a_info = np.ones(A_cap, np.float32)
    a_valid = np.zeros(A_cap, bool)
    for s, (k, xyz) in enumerate(list(anchors)[:A_cap]):
        a_idx[s] = k
        a_pos[s] = xyz
        a_info[s] = anchor_info
        a_valid[s] = True

    return Se3Graph(
        R=jnp.asarray(R), t=jnp.asarray(t),
        fixed=jnp.asarray(fixed), valid=jnp.asarray(valid),
        e_i=jnp.asarray(e_i), e_j=jnp.asarray(e_j),
        e_R=jnp.asarray(e_R), e_t=jnp.asarray(e_t),
        e_info=jnp.asarray(e_info), e_valid=jnp.asarray(e_valid),
        a_idx=jnp.asarray(a_idx), a_pos=jnp.asarray(a_pos),
        a_info=jnp.asarray(a_info), a_valid=jnp.asarray(a_valid),
    )


@functools.partial(jax.jit, static_argnames=("num_iters",))
def optimize_se3_graph(
    g: Se3Graph, num_iters: int = 20, mu: float = 1e-6
) -> Tuple[Se3Graph, jnp.ndarray]:
    """Damped GN over the SE3 pose graph (+ optional position anchors)."""
    K = g.R.shape[0]

    def residuals(gg: Se3Graph):
        poses = se3.SE3(gg.R, gg.t)
        T_i = jax.tree_util.tree_map(lambda a: a[gg.e_i], poses)
        T_j = jax.tree_util.tree_map(lambda a: a[gg.e_j], poses)
        meas = se3.SE3(gg.e_R, gg.e_t)
        return pose_graph.se3_relative_residual_jac(T_i, T_j, meas)

    def anchor_terms(gg: Se3Graph):
        """Camera-center anchors: r = C_k - p with C = -R^T t."""
        Ra = gg.R[gg.a_idx]
        ta = gg.t[gg.a_idx]
        C = -jnp.einsum("aji,aj->ai", Ra, ta)
        r = C - gg.a_pos

        # d C / d delta for left-mult update T <- exp(d) T:
        # C = -R^T t; dR = hat(phi) R, dt = rho + hat(phi) t
        # dC = -R^T hat(phi)^T t - R^T (rho + hat(phi) t) = -R^T rho  ... using
        # hat^T = -hat: -R^T(-hat(phi)) t - R^T rho - R^T hat(phi) t = -R^T rho.
        # So J = [-R^T | 0].
        J = jnp.concatenate(
            [-jnp.swapaxes(Ra, -1, -2), jnp.zeros_like(Ra)], axis=-1
        )  # (A, 3, 6)
        return r, J

    def step(gg: Se3Graph):
        r, J_i, J_j = residuals(gg)
        w = gg.e_info * gg.e_valid.astype(r.dtype)
        Hii = jnp.einsum("eki,e,ekj->eij", J_i, w, J_i)
        Hjj = jnp.einsum("eki,e,ekj->eij", J_j, w, J_j)
        Hij = jnp.einsum("eki,e,ekj->eij", J_i, w, J_j)
        bi = jnp.einsum("eki,e,ek->ei", J_i, w, r)
        bj = jnp.einsum("eki,e,ek->ei", J_j, w, r)

        H = jnp.zeros((K, K, 6, 6), dtype=r.dtype)
        H = H.at[gg.e_i, gg.e_i].add(Hii)
        H = H.at[gg.e_j, gg.e_j].add(Hjj)
        H = H.at[gg.e_i, gg.e_j].add(Hij)
        H = H.at[gg.e_j, gg.e_i].add(jnp.swapaxes(Hij, -1, -2))
        b = jnp.zeros((K, 6), dtype=r.dtype)
        b = b.at[gg.e_i].add(bi)
        b = b.at[gg.e_j].add(bj)

        ra, Ja = anchor_terms(gg)
        wa = gg.a_info * gg.a_valid.astype(r.dtype)
        H = H.at[gg.a_idx, gg.a_idx].add(
            jnp.einsum("aki,a,akj->aij", Ja, wa, Ja)
        )
        b = b.at[gg.a_idx].add(jnp.einsum("aki,a,ak->ai", Ja, wa, ra))

        Hd = H.transpose(0, 2, 1, 3).reshape(K * 6, K * 6)
        bd = b.reshape(-1)
        pin = jnp.repeat(gg.fixed | ~gg.valid, 6)
        Hd = jnp.where(pin[:, None] | pin[None, :], 0.0, Hd)
        Hd = Hd + jnp.diag(pin.astype(r.dtype)) + mu * jnp.eye(K * 6, dtype=r.dtype)
        bd = jnp.where(pin, 0.0, bd)
        dx = jax.scipy.linalg.cho_solve(jax.scipy.linalg.cho_factor(Hd), -bd)
        dx = dx.reshape(K, 6)

        new = se3.retract(se3.SE3(gg.R, gg.t), dx)
        free = ~(gg.fixed | ~gg.valid)
        return gg._replace(
            R=jnp.where(free[:, None, None], new.R, gg.R),
            t=jnp.where(free[:, None], new.t, gg.t),
        )

    def body(gg, _):
        return step(gg), None

    g, _ = jax.lax.scan(body, g, None, length=num_iters)
    r, _, _ = residuals(g)
    chi2 = jnp.sum(
        jnp.where(g.e_valid, g.e_info * jnp.sum(r * r, axis=-1), 0.0)
    )
    return g, chi2
