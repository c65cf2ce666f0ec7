"""Sim(3) essential-graph optimization — the 7-DoF scale-drift correction.

JAX redesign of `Optimizer::OptimizeEssentialGraph`
(/root/reference/src/backend/g2oOptimizer.cc:1212-1560): a pose graph over
ALL keyframes with Sim3 vertices; edges are (a) the new loop edge(s) with
their measured Sim3, (b) spanning-tree parent edges, (c) previous loop
edges, (d) strong covisibility edges (weight >= 100), each with the
relative Sim3 measured from the (pre-correction) poses.

Design: fixed-capacity edge SoA + dense blockwise normal equations. Each GN
iteration is one jitted computation: vmapped 7-dim residual/Jacobian
(factors/pose_graph.sim3_relative_residual_jac), scatter-add of 7x7 blocks
into the dense (7K, 7K) Hessian, Cholesky solve. At reference scale
(~1400 KFs -> 9800x9800) the dense factorization is a single large
matrix workload (~320 GFLOP) — the sparse CSparse factorization the
reference uses brings no advantage on an accelerator at this size.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp

from ..factors import pose_graph
from ..geometry import sim3


class PoseGraphProblem(NamedTuple):
    """Fixed-capacity Sim3 pose graph (padded + masked)."""

    s: jnp.ndarray  # (K,) scales of S_kw (world->kf)
    R: jnp.ndarray  # (K, 3, 3)
    t: jnp.ndarray  # (K, 3)
    fixed: jnp.ndarray  # (K,) bool — loop KF + padding
    valid: jnp.ndarray  # (K,) bool
    e_i: jnp.ndarray  # (E,) int32 endpoint i
    e_j: jnp.ndarray  # (E,) int32 endpoint j
    e_s: jnp.ndarray  # (E,) measured S_ji scale
    e_R: jnp.ndarray  # (E, 3, 3)
    e_t: jnp.ndarray  # (E, 3)
    e_valid: jnp.ndarray  # (E,) bool

    def poses(self) -> sim3.Sim3:
        return sim3.Sim3(self.s, self.R, self.t)

    def measurements(self) -> sim3.Sim3:
        return sim3.Sim3(self.e_s, self.e_R, self.e_t)


def measure_edges(poses: sim3.Sim3, e_i: jnp.ndarray, e_j: jnp.ndarray) -> sim3.Sim3:
    """S_ji = S_jw ∘ S_iw^-1 from current poses — how the reference takes
    edge measurements from the uncorrected graph (g2oOptimizer.cc:1280-1350)."""
    S_i = jax.tree_util.tree_map(lambda a: a[e_i], poses)
    S_j = jax.tree_util.tree_map(lambda a: a[e_j], poses)
    return sim3.compose(S_j, sim3.inverse(S_i))


@functools.partial(jax.jit, static_argnames=("num_iters",))
def optimize_pose_graph(
    problem: PoseGraphProblem, num_iters: int = 20, mu: float = 1e-6
) -> Tuple[PoseGraphProblem, jnp.ndarray]:
    """Damped GN on the Sim3 pose graph. Returns (problem', final chi2).

    The contractions need true f32 products (utils/cache.py sets that
    precision process-wide): with reduced-precision multiplies the K*7
    normal equations lose the small Jacobian couplings and the GN loop
    diverges at a few hundred keyframes."""
    K = problem.s.shape[0]

    def chi2_of(p: PoseGraphProblem):
        poses = p.poses()
        S_i = jax.tree_util.tree_map(lambda a: a[p.e_i], poses)
        S_j = jax.tree_util.tree_map(lambda a: a[p.e_j], poses)
        r = pose_graph.sim3_relative_residual(S_i, S_j, p.measurements())
        return jnp.sum(jnp.where(p.e_valid, jnp.sum(r * r, axis=-1), 0.0))

    def step(p: PoseGraphProblem):
        poses = p.poses()
        S_i = jax.tree_util.tree_map(lambda a: a[p.e_i], poses)
        S_j = jax.tree_util.tree_map(lambda a: a[p.e_j], poses)
        r, J_i, J_j = pose_graph.sim3_relative_residual_jac(
            S_i, S_j, p.measurements()
        )
        w = p.e_valid.astype(r.dtype)
        # Endpoint blocks, scattered into the dense (K,7,K,7) Hessian.
        Hii = jnp.einsum("eki,e,ekj->eij", J_i, w, J_i)
        Hjj = jnp.einsum("eki,e,ekj->eij", J_j, w, J_j)
        Hij = jnp.einsum("eki,e,ekj->eij", J_i, w, J_j)
        bi = jnp.einsum("eki,e,ek->ei", J_i, w, r)
        bj = jnp.einsum("eki,e,ek->ei", J_j, w, r)

        H = jnp.zeros((K, K, 7, 7), dtype=r.dtype)
        H = H.at[p.e_i, p.e_i].add(Hii)
        H = H.at[p.e_j, p.e_j].add(Hjj)
        H = H.at[p.e_i, p.e_j].add(Hij)
        H = H.at[p.e_j, p.e_i].add(jnp.swapaxes(Hij, -1, -2))
        b = jnp.zeros((K, 7), dtype=r.dtype)
        b = b.at[p.e_i].add(bi)
        b = b.at[p.e_j].add(bj)

        Hd = H.transpose(0, 2, 1, 3).reshape(K * 7, K * 7)
        bd = b.reshape(-1)
        pin = jnp.repeat(p.fixed | ~p.valid, 7)
        Hd = jnp.where(pin[:, None] | pin[None, :], 0.0, Hd)
        Hd = Hd + jnp.diag(pin.astype(r.dtype)) + mu * jnp.eye(K * 7, dtype=r.dtype)
        bd = jnp.where(pin, 0.0, bd)
        dx = jax.scipy.linalg.cho_solve(jax.scipy.linalg.cho_factor(Hd), -bd)
        dx = dx.reshape(K, 7)

        new_poses = sim3.retract(poses, dx)
        free = (~(p.fixed | ~p.valid))
        return p._replace(
            s=jnp.where(free, new_poses.s, p.s),
            R=jnp.where(free[:, None, None], new_poses.R, p.R),
            t=jnp.where(free[:, None], new_poses.t, p.t),
        )

    def body(p, _):
        return step(p), None

    problem, _ = jax.lax.scan(body, problem, None, length=num_iters)
    return problem, chi2_of(problem)
