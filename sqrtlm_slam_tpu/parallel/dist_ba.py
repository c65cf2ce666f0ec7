"""Distributed bundle adjustment over a device mesh — shard_map + psum.

The reference has NO distributed backend (single-process pthreads, SURVEY.md
§2.10/§5.8); this module is the fresh design the survey calls for:

  * landmarks (and the observation edges that touch them) are sharded over
    the mesh axis — each landmark's full observation set lives on exactly one
    device, so Hll, bl and the landmark back-substitution are device-local
    with NO communication;
  * poses are replicated (P is small: a local BA window or the keyframe set);
  * each device computes its partial reduced camera system
    S_d = Hpp_d - W_d Hll_d^-1 W_d^T and rhs_d from its edges, and ONE
    `psum` over the mesh produces the exact global (S, rhs) — identical algebra
    to the single-device engine in optim/schur.py;
  * every device solves the (small, dense) reduced system redundantly —
    cheaper than distributing a 6P x 6P Cholesky — and back-substitutes its
    own landmark shard.

Communication per iteration: one psum of (P*6)^2 + P*6 + 1 floats. For
P = 64 that is ~0.6 MB — microseconds over NVLink, so scaling is
compute-bound (the per-edge Jacobian work and the Hll inversions partition
perfectly). This is the §7.1-step-8 "sequence parallelism of this domain":
scaling in trajectory length / map size.

The edge partitioner (`partition_problem`) lives on the host: it groups
edges by landmark shard and compacts per-shard indices. Shard-local landmark
ids are remapped to [0, L/D).
"""

from __future__ import annotations

import math
from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..factors.reprojection import Camera
from ..geometry import se3
from ..optim import schur, schur_bucketed
from ..optim import loss as losses


class ShardedBAProblem(NamedTuple):
    """BAProblem re-laid-out for an `n_shards`-way mesh.

    Leading axis of landmark/edge arrays is the shard axis; poses replicated.
    """

    pose_R: jnp.ndarray  # (P, 3, 3) replicated
    pose_t: jnp.ndarray  # (P, 3)
    pose_fixed: jnp.ndarray  # (P,)
    points: jnp.ndarray  # (D, Ls, 3) sharded
    point_valid: jnp.ndarray  # (D, Ls)
    obs_cam: jnp.ndarray  # (D, Es)
    obs_pt: jnp.ndarray  # (D, Es) — LOCAL landmark slot in [0, Ls)
    obs_uvr: jnp.ndarray  # (D, Es, 3)
    obs_inv_sigma2: jnp.ndarray  # (D, Es)
    obs_valid: jnp.ndarray  # (D, Es)


def partition_problem(problem: schur.BAProblem, n_shards: int) -> Tuple[ShardedBAProblem, np.ndarray]:
    """Host-side partitioner: round-robin landmark blocks -> shards; edges
    follow their landmark. Returns (sharded problem, landmark global ids per
    (shard, slot) for write-back)."""
    L = problem.num_points
    E = problem.obs_cam.shape[0]
    Ls = -(-L // n_shards)  # ceil
    obs_pt = np.asarray(problem.obs_pt)
    obs_valid = np.asarray(problem.obs_valid)

    # Landmark l -> (shard, slot). Round-robin keeps shards balanced.
    shard_of = obs_pt % n_shards
    slot_of = obs_pt // n_shards

    lm_ids = np.full((n_shards, Ls), -1, np.int64)
    for d in range(n_shards):
        ids = np.arange(d, L, n_shards)
        lm_ids[d, : len(ids)] = ids

    points = np.zeros((n_shards, Ls, 3), np.float32)
    point_valid = np.zeros((n_shards, Ls), bool)
    pts = np.asarray(problem.points)
    pv = np.asarray(problem.point_valid)
    for d in range(n_shards):
        ids = lm_ids[d]
        sel = ids >= 0
        points[d, sel] = pts[ids[sel]]
        point_valid[d, sel] = pv[ids[sel]]

    # Edge capacity per shard: pad to the max count.
    counts = np.bincount(shard_of[obs_valid], minlength=n_shards)
    Es = max(int(counts.max()), 1)
    o_cam = np.zeros((n_shards, Es), np.int32)
    o_pt = np.zeros((n_shards, Es), np.int32)
    o_uvr = np.full((n_shards, Es, 3), -1.0, np.float32)
    o_is2 = np.ones((n_shards, Es), np.float32)
    o_val = np.zeros((n_shards, Es), bool)
    cam_np = np.asarray(problem.obs_cam)
    uvr_np = np.asarray(problem.obs_uvr)
    is2_np = np.asarray(problem.obs_inv_sigma2)
    # Argsort compaction (no per-edge Python loop): stable-sort valid edges
    # by shard; the within-shard fill index is the rank inside the run.
    ev = np.nonzero(obs_valid)[0]
    dv = shard_of[ev]
    order = np.argsort(dv, kind="stable")
    ev, dv = ev[order], dv[order]
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
    j = np.arange(len(ev)) - starts[dv]
    o_cam[dv, j] = cam_np[ev]
    o_pt[dv, j] = slot_of[ev]
    o_uvr[dv, j] = uvr_np[ev]
    o_is2[dv, j] = is2_np[ev]
    o_val[dv, j] = True

    sharded = ShardedBAProblem(
        pose_R=problem.pose_R,
        pose_t=problem.pose_t,
        pose_fixed=problem.pose_fixed,
        points=jnp.asarray(points),
        point_valid=jnp.asarray(point_valid),
        obs_cam=jnp.asarray(o_cam),
        obs_pt=jnp.asarray(o_pt),
        obs_uvr=jnp.asarray(o_uvr),
        obs_inv_sigma2=jnp.asarray(o_is2),
        obs_valid=jnp.asarray(o_val),
    )
    return sharded, lm_ids


def _shard_normal_equations(pose_R, pose_t, pose_fixed, points, point_valid,
                            obs_cam, obs_pt, obs_uvr, obs_is2, obs_valid,
                            cam: Camera, robust_delta, axis: str):
    """Per-device: local normal equations + psum'd reduced system pieces.

    Runs INSIDE shard_map; arrays carry the block (no leading shard axis).
    """
    local = schur.BAProblem(
        pose_R=pose_R,
        pose_t=pose_t,
        pose_fixed=pose_fixed,
        pose_valid=jnp.ones(pose_R.shape[0], bool),
        points=points,
        point_valid=point_valid,
        obs_cam=obs_cam,
        obs_pt=obs_pt,
        obs_uvr=obs_uvr,
        obs_inv_sigma2=obs_is2,
        obs_valid=obs_valid,
    )
    Hpp, Hll, W, bp, bl, chi2 = schur.build_normal_equations(
        local, cam, obs_valid, robust_delta
    )
    chi2 = jax.lax.psum(chi2, axis)
    return Hpp, Hll, W, bp, bl, chi2


def make_distributed_ba_step(
    mesh: Mesh, cam: Camera, axis: str = "ba", mu: float = 1e-4,
    robust_delta: float | None = None,
):
    """Build a jitted distributed damped-GN BA step over `mesh`.

    Returns step(sharded_problem) -> (sharded_problem', chi2). The step is
    exactly one LM inner iteration of optim/schur.reduce_and_solve, with the
    reduced system psum'd across shards.
    """

    def device_fn(pose_R, pose_t, pose_fixed, points, point_valid,
                  obs_cam, obs_pt, obs_uvr, obs_is2, obs_valid):
        # Block args arrive with the leading shard axis of size 1 — drop it.
        (points, point_valid, obs_cam, obs_pt, obs_uvr, obs_is2, obs_valid) = (
            x[0] for x in (points, point_valid, obs_cam, obs_pt, obs_uvr, obs_is2, obs_valid)
        )
        Hpp, Hll, W, bp, bl, chi2 = _shard_normal_equations(
            pose_R, pose_t, pose_fixed, points, point_valid,
            obs_cam, obs_pt, obs_uvr, obs_is2, obs_valid,
            cam, robust_delta, axis,
        )
        Pn = pose_R.shape[0]
        dtype = Hpp.dtype
        eye3 = jnp.eye(3, dtype=dtype)

        # Marquardt (multiplicative) damping: scale-invariant, so thin
        # landmark blocks (near-collinear observation rays) stay bounded —
        # absolute damping diverges on sparse-visibility problems.
        dll = jnp.diagonal(Hll, axis1=-2, axis2=-1)  # (Ls, 3)
        Hll_d = Hll + mu * dll[..., None] * eye3 + 1e-8 * eye3
        Hll_d = jnp.where(point_valid[:, None, None], Hll_d, eye3)
        Hll_inv = jnp.linalg.inv(Hll_d)
        WHinv = jnp.einsum("alk,lkm->alm", W, Hll_inv)
        S_corr_local = jnp.einsum("alm,blm->ab", WHinv, W)
        rhs_local = jnp.einsum("alm,lm->a", WHinv, bl)

        # ONE psum each for the reduced system.
        Hpp_g = jax.lax.psum(Hpp, axis)
        bp_g = jax.lax.psum(bp, axis)
        S_corr = jax.lax.psum(S_corr_local, axis)
        rhs_corr = jax.lax.psum(rhs_local, axis)

        dpp = jnp.diagonal(Hpp_g, axis1=-2, axis2=-1)  # (P, 6)
        eye6 = jnp.eye(6, dtype=dtype)
        Hpp_d = Hpp_g + mu * dpp[..., None] * eye6 + 1e-8 * eye6
        S = schur._blockdiag(Hpp_d) - S_corr
        rhs = -(bp_g.reshape(-1) - rhs_corr)
        fixed6 = jnp.repeat(pose_fixed, 6)
        S = jnp.where(fixed6[:, None] | fixed6[None, :], 0.0, S)
        S = S + jnp.diag(fixed6.astype(dtype))
        rhs = jnp.where(fixed6, 0.0, rhs)
        dxp_flat = jax.scipy.linalg.cho_solve(jax.scipy.linalg.cho_factor(S), rhs)
        dxp = dxp_flat.reshape(Pn, 6)

        # Local landmark back-substitution (no communication).
        Wt_dxp = jnp.einsum("alm,a->lm", W, dxp_flat)
        dxl = jnp.einsum("lkm,lm->lk", Hll_inv, -bl - Wt_dxp)
        dxl = jnp.where(point_valid[:, None], dxl, 0.0)

        # Apply updates (poses replicated => identical on all devices).
        new_pose = se3.retract(se3.SE3(pose_R, pose_t), dxp)
        free = (~pose_fixed)[:, None]
        pose_R_new = jnp.where(free[..., None], new_pose.R, pose_R)
        pose_t_new = jnp.where(free, new_pose.t, pose_t)
        points_new = points + dxl
        return pose_R_new, pose_t_new, points_new[None], chi2

    spec_rep = P()
    spec_shard = P(axis)
    fn = jax.shard_map(
        device_fn,
        mesh=mesh,
        in_specs=(spec_rep, spec_rep, spec_rep,
                  spec_shard, spec_shard, spec_shard, spec_shard,
                  spec_shard, spec_shard, spec_shard),
        out_specs=(spec_rep, spec_rep, spec_shard, spec_rep),
        check_vma=False,
    )

    @jax.jit
    def step(sp: ShardedBAProblem):
        pose_R, pose_t, points, chi2 = fn(
            sp.pose_R, sp.pose_t, sp.pose_fixed,
            sp.points, sp.point_valid,
            sp.obs_cam, sp.obs_pt, sp.obs_uvr, sp.obs_inv_sigma2, sp.obs_valid,
        )
        return sp._replace(pose_R=pose_R, pose_t=pose_t, points=points), chi2

    return step


# ----------------------------------------------------------------------
# Bucketed distributed BA — the fast path (optim/schur_bucketed.py).
#
# The (L, K) landmark-bucketed layout shards trivially: round-robin landmark
# ROWS over the mesh axis; every per-landmark quantity (Hll, bl, U, backsub)
# is shard-local by construction, and the per-shard LocalPieces
# (S_half, bp, rhs_corr, chi2) sum exactly — ONE psum yields the global
# reduced camera system, then every device solves it redundantly and
# back-substitutes its own rows.
# ----------------------------------------------------------------------


class ShardedBucketedBA(NamedTuple):
    pose_R: jnp.ndarray  # (P, 3, 3) replicated
    pose_t: jnp.ndarray  # (P, 3)
    pose_fixed: jnp.ndarray  # (P,)
    points: jnp.ndarray  # (D, Ls, 3) sharded
    point_valid: jnp.ndarray  # (D, Ls)
    obs_cam: jnp.ndarray  # (D, Ls, K)
    obs_uvr: jnp.ndarray  # (D, Ls, K, 3)
    obs_inv_sigma2: jnp.ndarray  # (D, Ls, K)
    obs_valid: jnp.ndarray  # (D, Ls, K)


def partition_bucketed(
    b: schur_bucketed.BucketedBAProblem, n_shards: int
) -> Tuple[ShardedBucketedBA, np.ndarray]:
    """Round-robin landmark rows -> shards (pure gather, no edge rework)."""
    L = b.num_points
    Ls = -(-L // n_shards)
    lm_ids = np.full((n_shards, Ls), -1, np.int64)
    for d in range(n_shards):
        ids = np.arange(d, L, n_shards)
        lm_ids[d, : len(ids)] = ids

    def shard_rows(x, fill):
        out = np.full((n_shards, Ls) + x.shape[1:], fill, np.asarray(x).dtype)
        xn = np.asarray(x)
        for d in range(n_shards):
            ids = lm_ids[d]
            sel = ids >= 0
            out[d, sel] = xn[ids[sel]]
        return out

    sharded = ShardedBucketedBA(
        pose_R=b.pose_R,
        pose_t=b.pose_t,
        pose_fixed=b.pose_fixed,
        points=shard_rows(b.points, 0.0),
        point_valid=shard_rows(b.point_valid, False),
        obs_cam=shard_rows(b.obs_cam, 0),
        obs_uvr=shard_rows(b.obs_uvr, -1.0),
        obs_inv_sigma2=shard_rows(b.obs_inv_sigma2, 1.0),
        obs_valid=shard_rows(b.obs_valid, False),
    )
    return sharded, lm_ids


def place_on_mesh(sp: ShardedBucketedBA, mesh: Mesh) -> ShardedBucketedBA:
    """Put each landmark shard on its own device and replicate the poses, so
    the shard_map starts where its blocks run instead of on one device."""
    replicated = NamedSharding(mesh, P())
    sharded = NamedSharding(mesh, P(mesh.axis_names[0]))
    return ShardedBucketedBA(
        *(
            jax.device_put(x, replicated if name.startswith("pose_") else sharded)
            for name, x in zip(ShardedBucketedBA._fields, sp)
        )
    )


def make_bucketed_ba_step(
    mesh: Mesh, cam: Camera, axis: str = "ba", mu: float = 1e-4,
    robust_delta: float | None = None,
):
    """Jitted distributed damped-GN step on the bucketed engine."""

    def device_fn(pose_R, pose_t, pose_fixed, points, point_valid,
                  obs_cam, obs_uvr, obs_is2, obs_valid):
        (points, point_valid, obs_cam, obs_uvr, obs_is2, obs_valid) = (
            x[0] for x in (points, point_valid, obs_cam, obs_uvr, obs_is2, obs_valid)
        )
        local = schur_bucketed.BucketedBAProblem(
            pose_R=pose_R, pose_t=pose_t, pose_fixed=pose_fixed,
            pose_valid=jnp.ones(pose_R.shape[0], bool),
            points=points, point_valid=point_valid,
            obs_cam=obs_cam, obs_uvr=obs_uvr,
            obs_inv_sigma2=obs_is2, obs_valid=obs_valid,
        )
        pieces = schur_bucketed.build_local_pieces(
            local, cam, obs_valid, robust_delta, mu
        )
        # ONE fused psum of the reduced system.
        S, bp, rhs_corr, chi2 = jax.lax.psum(
            (pieces.S_half, pieces.bp, pieces.rhs_corr, pieces.chi2), axis
        )
        rhs = -(bp.reshape(-1) - rhs_corr)
        dxp = schur_bucketed.solve_pose_system(S, rhs, pose_fixed)
        dxp = jnp.where(pose_fixed[:, None], 0.0, dxp)
        dxl = schur_bucketed.back_substitute(pieces, local, dxp, obs_cam.T)

        new_pose = se3.retract(se3.SE3(pose_R, pose_t), dxp)
        free = (~pose_fixed)[:, None]
        pose_R_new = jnp.where(free[..., None], new_pose.R, pose_R)
        pose_t_new = jnp.where(free, new_pose.t, pose_t)
        return pose_R_new, pose_t_new, (points + dxl)[None], chi2

    spec_rep = P()
    spec_shard = P(axis)
    fn = jax.shard_map(
        device_fn,
        mesh=mesh,
        in_specs=(spec_rep, spec_rep, spec_rep,
                  spec_shard, spec_shard, spec_shard,
                  spec_shard, spec_shard, spec_shard),
        out_specs=(spec_rep, spec_rep, spec_shard, spec_rep),
        check_vma=False,
    )

    @jax.jit
    def step(sp: ShardedBucketedBA):
        pose_R, pose_t, points, chi2 = fn(
            sp.pose_R, sp.pose_t, sp.pose_fixed,
            sp.points, sp.point_valid,
            sp.obs_cam, sp.obs_uvr, sp.obs_inv_sigma2, sp.obs_valid,
        )
        return sp._replace(pose_R=pose_R, pose_t=pose_t, points=points), chi2

    return step


def make_bucketed_lm_iterate(
    mesh: Mesh, cam: Camera, axis: str = "ba", num_iters: int = 15,
    robust_delta: float | None = None, mu0: float = 1e-3,
):
    """Jitted distributed Nielsen-LM loop over the mesh.

    The distributed twin of `schur_bucketed.ba_iterate`: the FULL
    accept/reject Levenberg-Marquardt protocol (Nielsen mu/nu adaptation,
    candidate chi2 evaluation, rollback on reject — mybackend
    `Problem::Solve`, /root/reference/src/backend/mybackend/problem.cc) runs
    INSIDE the shard_map as one `lax.scan`: per iteration, one fused psum of
    the reduced camera system + one psum'd candidate chi2. All LM scalars
    (mu, nu, rho) are computed from psum'd quantities, so every device takes
    identical branches — no host round-trips anywhere in the loop.
    """

    def device_fn(pose_R, pose_t, pose_fixed, points, point_valid,
                  obs_cam, obs_uvr, obs_is2, obs_valid):
        (points, point_valid, obs_cam, obs_uvr, obs_is2, obs_valid) = (
            x[0] for x in (points, point_valid, obs_cam, obs_uvr, obs_is2, obs_valid)
        )

        def local_problem(pR, pt, pts):
            return schur_bucketed.BucketedBAProblem(
                pose_R=pR, pose_t=pt, pose_fixed=pose_fixed,
                pose_valid=jnp.ones(pR.shape[0], bool),
                points=pts, point_valid=point_valid,
                obs_cam=obs_cam, obs_uvr=obs_uvr,
                obs_inv_sigma2=obs_is2, obs_valid=obs_valid,
            )

        def global_chi2(pR, pt, pts):
            return jax.lax.psum(
                schur_bucketed.chi2_only(
                    local_problem(pR, pt, pts), cam, obs_valid, robust_delta
                ),
                axis,
            )

        chi20 = global_chi2(pose_R, pose_t, points)

        def body(carry, _):
            pR, pt, pts, chi2, mu, nu, n_acc = carry
            local = local_problem(pR, pt, pts)
            pieces = schur_bucketed.build_local_pieces(
                local, cam, obs_valid, robust_delta, mu
            )
            S, bp, rhs_corr = jax.lax.psum(
                (pieces.S_half, pieces.bp, pieces.rhs_corr), axis
            )
            rhs = -(bp.reshape(-1) - rhs_corr)
            dxp = schur_bucketed.solve_pose_system(S, rhs, pose_fixed)
            dxp = jnp.where(pose_fixed[:, None], 0.0, dxp)
            dxl = schur_bucketed.back_substitute(pieces, local, dxp, obs_cam.T)
            dxl = jnp.where(point_valid[:, None], dxl, 0.0)

            new_pose = se3.retract(se3.SE3(pR, pt), dxp)
            free = (~pose_fixed)[:, None]
            cand_R = jnp.where(free[..., None], new_pose.R, pR)
            cand_t = jnp.where(free, new_pose.t, pt)
            cand_pts = pts + dxl
            chi2_c = global_chi2(cand_R, cand_t, cand_pts)

            # Nielsen gain ratio: pose term is replicated (bp is already the
            # global gradient), landmark term sums across shards.
            t_pose = jnp.sum(dxp * (mu * dxp - bp))
            t_lm = jax.lax.psum(jnp.sum(dxl * (mu * dxl - pieces.bl3.T)), axis)
            predicted = 0.5 * (t_pose + t_lm)
            rho = (chi2 - chi2_c) / jnp.maximum(predicted, 1e-12)
            accept = (rho > 0) & jnp.isfinite(chi2_c)

            pR = jnp.where(accept, cand_R, pR)
            pt = jnp.where(accept, cand_t, pt)
            pts = jnp.where(accept, cand_pts, pts)
            chi2 = jnp.where(accept, chi2_c, chi2)
            factor = jnp.maximum(1.0 / 3.0, 1.0 - (2.0 * rho - 1.0) ** 3)
            mu = jnp.where(accept, mu * factor, mu * nu)
            nu = jnp.where(accept, 2.0, nu * 2.0)
            return (pR, pt, pts, chi2, mu, nu, n_acc + accept), None

        init = (
            pose_R, pose_t, points, chi20,
            jnp.asarray(mu0, chi20.dtype),
            jnp.asarray(2.0, chi20.dtype),
            jnp.asarray(0, jnp.int32),
        )
        (pR, pt, pts, chi2, _, _, n_acc), _ = jax.lax.scan(
            body, init, None, length=num_iters
        )
        return pR, pt, pts[None], chi2, n_acc

    spec_rep = P()
    spec_shard = P(axis)
    fn = jax.shard_map(
        device_fn,
        mesh=mesh,
        in_specs=(spec_rep, spec_rep, spec_rep,
                  spec_shard, spec_shard, spec_shard,
                  spec_shard, spec_shard, spec_shard),
        out_specs=(spec_rep, spec_rep, spec_shard, spec_rep, spec_rep),
        check_vma=False,
    )

    @jax.jit
    def iterate(sp: ShardedBucketedBA):
        pose_R, pose_t, points, chi2, n_acc = fn(
            sp.pose_R, sp.pose_t, sp.pose_fixed,
            sp.points, sp.point_valid,
            sp.obs_cam, sp.obs_uvr, sp.obs_inv_sigma2, sp.obs_valid,
        )
        return (
            sp._replace(pose_R=pose_R, pose_t=pose_t, points=points),
            chi2,
            n_acc,
        )

    return iterate


def distributed_ba_lm(
    b: schur_bucketed.BucketedBAProblem,
    cam: Camera,
    mesh: Mesh,
    num_iters: int = 15,
    robust_delta: float | None = None,
) -> Tuple[schur_bucketed.BucketedBAProblem, jnp.ndarray, jnp.ndarray]:
    """Production distributed BA: partition, run the full Nielsen-LM loop in
    ONE dispatch, gather back. Returns (problem, chi2, n_accepted)."""
    n_shards = mesh.devices.size
    sharded, lm_ids = partition_bucketed(b, n_shards)
    sharded = place_on_mesh(sharded, mesh)
    iterate = make_bucketed_lm_iterate(
        mesh, cam, axis=mesh.axis_names[0], num_iters=num_iters,
        robust_delta=robust_delta,
    )
    sharded, chi2, n_acc = iterate(sharded)

    pts = np.asarray(b.points).copy()
    shard_pts = np.asarray(sharded.points)
    for d in range(n_shards):
        ids = lm_ids[d]
        sel = ids >= 0
        pts[ids[sel]] = shard_pts[d, sel]
    out = b._replace(
        pose_R=sharded.pose_R, pose_t=sharded.pose_t, points=jnp.asarray(pts)
    )
    return out, chi2, n_acc


def distributed_ba_bucketed(
    b: schur_bucketed.BucketedBAProblem,
    cam: Camera,
    mesh: Mesh,
    num_iters: int = 10,
    mu: float = 1e-4,
    robust_delta: float | None = None,
) -> Tuple[schur_bucketed.BucketedBAProblem, jnp.ndarray]:
    """Partition, iterate, gather back (bucketed fast path)."""
    n_shards = mesh.devices.size
    sharded, lm_ids = partition_bucketed(b, n_shards)
    sharded = place_on_mesh(sharded, mesh)
    step = make_bucketed_ba_step(
        mesh, cam, axis=mesh.axis_names[0], mu=mu, robust_delta=robust_delta
    )
    chi2 = None
    for _ in range(num_iters):
        sharded, chi2 = step(sharded)

    pts = np.asarray(b.points).copy()
    shard_pts = np.asarray(sharded.points)
    for d in range(n_shards):
        ids = lm_ids[d]
        sel = ids >= 0
        pts[ids[sel]] = shard_pts[d, sel]
    out = b._replace(
        pose_R=sharded.pose_R, pose_t=sharded.pose_t, points=jnp.asarray(pts)
    )
    return out, chi2


def distributed_ba(
    problem: schur.BAProblem,
    cam: Camera,
    mesh: Mesh,
    num_iters: int = 10,
    mu: float = 1e-4,
) -> Tuple[schur.BAProblem, jnp.ndarray]:
    """Convenience wrapper: partition, iterate, gather back."""
    n_shards = mesh.devices.size
    sharded, lm_ids = partition_problem(problem, n_shards)
    step = make_distributed_ba_step(mesh, cam, axis=mesh.axis_names[0], mu=mu)
    chi2 = None
    for _ in range(num_iters):
        sharded, chi2 = step(sharded)

    # Write landmarks back to the original layout.
    pts = np.asarray(problem.points).copy()
    shard_pts = np.asarray(sharded.points)
    for d in range(n_shards):
        ids = lm_ids[d]
        sel = ids >= 0
        pts[ids[sel]] = shard_pts[d, sel]
    out = problem._replace(
        pose_R=sharded.pose_R, pose_t=sharded.pose_t, points=jnp.asarray(pts)
    )
    return out, chi2
