"""Multi-process distribution layer — jax.distributed over N OS processes.

The reference is a single-process shared-memory system (SURVEY.md §2.10 P7:
its "communication" is the mutex inventory around
/root/reference/include/data_structure/Map.h:144 and the stop/resume flag
protocol in /root/reference/src/backend/LocalMapping.cc:827-931). This module
is the control plane that replaces it at multi-host scale: each host runs one
JAX process, `jax.distributed.initialize` forms the global runtime, and the
*same* shard_map Nielsen-LM used in-process (`dist_ba.make_bucketed_lm_iterate`)
runs unchanged over the global mesh.

It is CPU test scaffolding: processes on the host platform with gloo
collectives stand in for a multi-host cluster. One process drives all the
cards of one GPU host (chip_smoke.py --four), so nothing here starts a
process per card.

Design (also recorded in PERF.md "Multi-process distribution"):

  * Every process holds the full host-side map store (poses, landmark ids,
    bookkeeping) — it is MBs even at KITTI-00 scale, and replicating it makes
    the partitioner deterministic and identical everywhere, so no process
    ever needs to request problem data from a peer.
  * Device state is global jax.Arrays: landmark rows sharded over the mesh
    axis (each process materializes ONLY its addressable shards via
    `jax.make_array_from_callback`), poses replicated.
  * One psum per LM iteration moves the O(P²·36) reduced camera system —
    independent of landmark count and mesh size; everything else is
    shard-local (see dist_ba module docstring).
  * Results return fully replicated (an out_shardings=P() identity jit is an
    all-gather), so every process leaves the call with identical arrays and
    no further synchronization is needed.

Cross-process collectives use the gloo transport of the CPU backend.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from . import dist_ba
from ..factors.reprojection import Camera
from ..optim import schur_bucketed


def initialize(
    coordinator_address: str,
    num_processes: int,
    process_id: int,
) -> None:
    """Join the distributed runtime on the CPU platform. Call BEFORE any
    backend-initializing op; once per process."""
    jax.config.update("jax_platforms", "cpu")
    # Cross-process collectives on the CPU backend need an explicit
    # transport; gloo ships with jaxlib.
    jax.config.update("jax_cpu_collectives_implementation", "gloo")
    jax.distributed.initialize(
        coordinator_address=coordinator_address,
        num_processes=num_processes,
        process_id=process_id,
    )


def global_mesh(axis: str = "ba") -> Mesh:
    """1-D mesh over ALL global devices (across every process)."""
    return Mesh(np.asarray(jax.devices()), (axis,))


def _make_global(sharded: dist_ba.ShardedBucketedBA, mesh: Mesh, axis: str):
    """Host-replicated ShardedBucketedBA (leading axis == n_global_devices)
    -> global jax.Arrays. Each process materializes only its addressable
    shards; replicated leaves are built with a replicated sharding."""
    rep = NamedSharding(mesh, P())
    shd = NamedSharding(mesh, P(axis))

    def to_global(x, spec_sharded: bool):
        x = np.asarray(x)
        sh = shd if spec_sharded else rep
        return jax.make_array_from_callback(x.shape, sh, lambda idx: x[idx])

    return dist_ba.ShardedBucketedBA(
        pose_R=to_global(sharded.pose_R, False),
        pose_t=to_global(sharded.pose_t, False),
        pose_fixed=to_global(sharded.pose_fixed, False),
        points=to_global(sharded.points, True),
        point_valid=to_global(sharded.point_valid, True),
        obs_cam=to_global(sharded.obs_cam, True),
        obs_uvr=to_global(sharded.obs_uvr, True),
        obs_inv_sigma2=to_global(sharded.obs_inv_sigma2, True),
        obs_valid=to_global(sharded.obs_valid, True),
    )


def distributed_ba_lm(
    b: schur_bucketed.BucketedBAProblem,
    cam: Camera,
    mesh: Optional[Mesh] = None,
    num_iters: int = 15,
    robust_delta: Optional[float] = None,
) -> Tuple[schur_bucketed.BucketedBAProblem, jnp.ndarray, jnp.ndarray]:
    """Multi-process twin of `dist_ba.distributed_ba_lm`.

    Every process calls this with the SAME (host-replicated) problem; the
    partitioner is deterministic so all processes agree on the layout. The
    full Nielsen-LM loop runs in ONE dispatch over the global mesh; results
    come back fully replicated on every process.
    """
    mesh = mesh if mesh is not None else global_mesh()
    axis = mesh.axis_names[0]
    n_shards = mesh.devices.size
    sharded_host, lm_ids = dist_ba.partition_bucketed(b, n_shards)
    sharded = _make_global(sharded_host, mesh, axis)

    iterate = dist_ba.make_bucketed_lm_iterate(
        mesh, cam, axis=axis, num_iters=num_iters, robust_delta=robust_delta
    )
    out_sharded, chi2, n_acc = iterate(sharded)

    # Replicate the landmark shards so every process sees the full result:
    # an identity jit with replicated out_shardings is an all-gather.
    gather = jax.jit(
        lambda x: x, out_shardings=NamedSharding(mesh, P())
    )
    shard_pts = np.asarray(jax.device_get(gather(out_sharded.points)))

    pts = np.asarray(b.points).copy()
    for d in range(n_shards):
        ids = lm_ids[d]
        sel = ids >= 0
        pts[ids[sel]] = shard_pts[d, sel]
    out = b._replace(
        pose_R=jnp.asarray(jax.device_get(out_sharded.pose_R)),
        pose_t=jnp.asarray(jax.device_get(out_sharded.pose_t)),
        points=jnp.asarray(pts),
    )
    return out, jax.device_get(chi2), jax.device_get(n_acc)
