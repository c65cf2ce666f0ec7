"""Voxel-hash nearest-neighbor search + voxel downsampling — kd-tree replacement.

JAX substitute for `pcl::KdTreeFLANN` / `pcl::VoxelGrid` used
throughout the reference (tracking LiDAR local map `Tracking.cc:2263-2320`,
scan-to-map association `lidarOdom.cc:1434-1462`, BA tight coupling
`g2oOptimizer.cc:560-641`). Exact kd-trees are pointer-chasing and
sequential; here the same 0.2 m^2-radius association semantics are served
by a **sorted voxel-hash grid**: points sorted by packed voxel key, queries
gather bounded candidate runs from the 27 neighboring cells and reduce with
top-k (SURVEY.md §7.0, §7.3). Recall is exact for any query whose true
neighbors lie within one cell — pick cell >= search radius.

All structures are fixed-capacity and jit-friendly; `build` is one sort,
`knn` is pure gathers + top-k (vmapped over queries).
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

_COORD_BITS = 10
_COORD_MASK = (1 << _COORD_BITS) - 1
_COORD_OFF = 1 << (_COORD_BITS - 1)
_INVALID_KEY = jnp.int32(2**31 - 1)


def _voxel_key(ijk: jnp.ndarray) -> jnp.ndarray:
    """Pack (..., 3) int voxel coords into one int32 key (10 bits/axis)."""
    q = jnp.clip(ijk + _COORD_OFF, 0, _COORD_MASK)
    return (q[..., 0] << (2 * _COORD_BITS)) | (q[..., 1] << _COORD_BITS) | q[..., 2]


class VoxelMap(NamedTuple):
    points: jnp.ndarray  # (M, 3) sorted by voxel key
    keys: jnp.ndarray  # (M,) int32 sorted
    payload: jnp.ndarray  # (M, D) extra per-point data (e.g. normals), sorted
    cell: jnp.ndarray  # scalar cell size
    valid: jnp.ndarray  # (M,) bool, sorted (invalid sink to the end)


def build(
    points: jnp.ndarray,
    valid: jnp.ndarray,
    cell: float,
    payload: jnp.ndarray | None = None,
) -> VoxelMap:
    """Sort points by voxel key. Invalid points get the sentinel key."""
    if payload is None:
        payload = jnp.zeros((points.shape[0], 0), dtype=points.dtype)
    ijk = jnp.floor(points / cell).astype(jnp.int32)
    keys = jnp.where(valid, _voxel_key(ijk), _INVALID_KEY)
    order = jnp.argsort(keys)
    return VoxelMap(
        points=points[order],
        keys=keys[order],
        payload=payload[order],
        cell=jnp.asarray(cell, dtype=points.dtype),
        valid=valid[order],
    )


_NEIGHBOR_OFFSETS = jnp.asarray(
    [[i, j, k] for i in (-1, 0, 1) for j in (-1, 0, 1) for k in (-1, 0, 1)],
    dtype=jnp.int32,
)  # (27, 3)


def knn(
    vm: VoxelMap,
    queries: jnp.ndarray,
    k: int = 1,
    max_per_cell: int = 8,
    max_dist: float = jnp.inf,
):
    """k nearest neighbors for each query among the 27 adjacent voxels.

    queries: (Q, 3). Returns (idx (Q, k) into vm.points, dist2 (Q, k),
    ok (Q, k) bool). Neighbors further than `max_dist` (or absent) have
    ok=False. Candidate runs are capped at `max_per_cell` per voxel —
    matching the bounded-occupancy design (downsampled maps rarely exceed
    a handful of points per 0.4-0.8 m cell).
    """
    M = vm.points.shape[0]
    qijk = jnp.floor(queries / vm.cell).astype(jnp.int32)  # (Q, 3)
    nkeys = _voxel_key(qijk[:, None, :] + _NEIGHBOR_OFFSETS[None, :, :])  # (Q, 27)

    lo = jnp.searchsorted(vm.keys, nkeys, side="left")  # (Q, 27)
    offs = jnp.arange(max_per_cell, dtype=jnp.int32)
    cand = lo[..., None] + offs  # (Q, 27, B)
    cand_clipped = jnp.clip(cand, 0, M - 1)
    cand_keys = vm.keys[cand_clipped]
    in_run = (cand < M) & (cand_keys == nkeys[..., None]) & vm.valid[cand_clipped]

    cand_pts = vm.points[cand_clipped]  # (Q, 27, B, 3)
    d = cand_pts - queries[:, None, None, :]
    dist2 = jnp.sum(d * d, axis=-1)
    dist2 = jnp.where(in_run, dist2, jnp.inf)

    flat_d = dist2.reshape(queries.shape[0], -1)
    flat_i = cand_clipped.reshape(queries.shape[0], -1)
    top_negd, top_pos = jax.lax.top_k(-flat_d, k)
    best_d = -top_negd
    best_i = jnp.take_along_axis(flat_i, top_pos, axis=1)
    ok = jnp.isfinite(best_d) & (best_d <= max_dist * max_dist)
    return best_i, best_d, ok


def voxel_downsample(
    points: jnp.ndarray, valid: jnp.ndarray, cell: float, capacity: int
):
    """Grid downsample: keep one representative per occupied voxel (first in
    key order), up to `capacity` outputs. Replaces pcl::VoxelGrid (0.4 m
    leaf in Tracking.cc:2307, lidarOdom.cc:1528).

    Returns (points (capacity, 3), valid (capacity,) bool).
    """
    ijk = jnp.floor(points / cell).astype(jnp.int32)
    keys = jnp.where(valid, _voxel_key(ijk), _INVALID_KEY)
    order = jnp.argsort(keys)
    skeys = keys[order]
    spts = points[order]
    first = jnp.concatenate(
        [jnp.array([True]), skeys[1:] != skeys[:-1]]
    ) & (skeys != _INVALID_KEY)
    # Compact the selected representatives to the front (stable).
    rank = jnp.cumsum(first) - 1  # output slot per selected point
    slot = jnp.where(first, rank, capacity)
    slot = jnp.clip(slot, 0, capacity)
    out = jnp.zeros((capacity + 1, 3), dtype=points.dtype).at[slot].set(spts)
    out_valid = jnp.zeros((capacity + 1,), dtype=bool).at[slot].set(first)
    return out[:capacity], out_valid[:capacity]
