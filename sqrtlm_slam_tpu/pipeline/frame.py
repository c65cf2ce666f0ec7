"""Frame construction: ORB extraction + depth association.

JAX equivalent of the reference fusion `Frame` constructor
(/root/reference/src/data_structure/Frame.cc:240-470): ORB extraction runs
as one jitted computation, LiDAR depth association samples a projected depth
image over a patch around each keypoint with a stability test (depth range
> 2 m => unstable; Frame.cc:338-402), and stereo-style `u_right = u - bf/z`
pseudo-observations are synthesized for keypoints with depth — exactly how
the reference turns LiDAR depth into RGBD/stereo edges.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp

from ..factors.reprojection import Camera
from ..frontend import orb
from ..lidar import features as lidar_features


class Frame(NamedTuple):
    """Per-frame feature data (fixed capacity = ORBConfig.max_features)."""

    kp: orb.Keypoints
    uvr: jnp.ndarray  # (N, 3) [u, v, u_right]; u_right < 0 -> mono
    depth: jnp.ndarray  # (N,) associated depth (<= 0 -> none)
    inv_sigma2: jnp.ndarray  # (N,) information by pyramid level
    words: Optional[jnp.ndarray] = None  # (N,) vocabulary word ids
    lidar: Optional[lidar_features.LidarFeatures] = None  # fusion coupling


def project_cloud_to_depth_image(
    cloud_cam: jnp.ndarray,
    cam: Camera,
    height: int,
    width: int,
    valid: Optional[jnp.ndarray] = None,
) -> jnp.ndarray:
    """Project a camera-frame cloud to a sparse depth image (keep nearest).

    Mirrors Frame.cc:290-313 (projection through K·T_cam_lidar; the extrinsic
    transform is applied by the caller). Returns (H, W) depth, 0 where empty.
    """
    z = cloud_cam[:, 2]
    u = cam.fx * cloud_cam[:, 0] / jnp.maximum(z, 1e-6) + cam.cx
    v = cam.fy * cloud_cam[:, 1] / jnp.maximum(z, 1e-6) + cam.cy
    ui = jnp.round(u).astype(jnp.int32)
    vi = jnp.round(v).astype(jnp.int32)
    ok = (z > 0.1) & (ui >= 0) & (ui < width) & (vi >= 0) & (vi < height)
    if valid is not None:
        ok = ok & valid
    flat = jnp.where(ok, vi * width + ui, height * width)
    big = jnp.float32(1e9)
    depth = jnp.full(height * width + 1, big).at[flat].min(jnp.where(ok, z, big))
    depth = depth[: height * width]
    return jnp.where(depth < big, depth, 0.0).reshape(height, width)


def associate_depth(
    depth_img: jnp.ndarray,
    xy: jnp.ndarray,
    patch_h: int = 8,
    patch_w: int = 14,
    max_range: float = 2.0,
):
    """Keypoint depth from a patch around each keypoint + stability test.

    Reference semantics (Frame.cc:338-402): look at an 8x14 patch of the
    sparse depth image; take the nearest valid depth; if the patch's depth
    spread exceeds `max_range` (2 m) the association is 'unstable'
    (class_id 2) and rejected here. Returns (depth (N,), stable (N,) bool).
    """
    H, W = depth_img.shape
    ys = jnp.clip(xy[:, 1].astype(jnp.int32), 0, H - 1)
    xs = jnp.clip(xy[:, 0].astype(jnp.int32), 0, W - 1)

    dys = jnp.arange(patch_h) - patch_h // 2
    dxs = jnp.arange(patch_w) - patch_w // 2
    gy = jnp.clip(ys[:, None, None] + dys[None, :, None], 0, H - 1)
    gx = jnp.clip(xs[:, None, None] + dxs[None, None, :], 0, W - 1)
    patch = depth_img[gy, gx].reshape(xy.shape[0], -1)  # (N, ph*pw)

    has = patch > 0
    dmin = jnp.min(jnp.where(has, patch, jnp.inf), axis=-1)
    dmax = jnp.max(jnp.where(has, patch, -jnp.inf), axis=-1)
    any_valid = jnp.any(has, axis=-1)
    stable = any_valid & ((dmax - dmin) < max_range)
    depth = jnp.where(stable, dmin, 0.0)
    return depth, stable


def stereo_match(
    kp_l: orb.Keypoints,
    kp_r: orb.Keypoints,
    bf: float,
    min_depth: float = 0.5,
    max_row_diff: float = 2.0,
):
    """Rectified left-right ORB matching -> per-left-keypoint u_right.

    The reference's `ComputeStereoMatches` (ORB-SLAM2 Frame stereo ctor)
    searches along the epipolar row with a disparity bound and refines;
    here it is one masked Hamming matcher call: row-band window + disparity
    bounds (0 < u_l - u_r <= bf / min_depth). Returns (u_right (N,),
    depth (N,)); u_right < 0 where unmatched.
    """
    import jax.numpy as jnp

    from ..frontend import matching

    dv = jnp.abs(kp_l.xy[:, None, 1] - kp_r.xy[None, :, 1])
    disp = kp_l.xy[:, None, 0] - kp_r.xy[None, :, 0]
    max_disp = bf / min_depth
    window = (dv <= max_row_diff) & (disp > 0.1) & (disp <= max_disp)
    res = matching.match_descriptors(
        kp_l.desc, kp_r.desc, kp_l.valid, kp_r.valid,
        window_mask=window, max_dist=matching.TH_HIGH, ratio=0.9, mutual=True,
    )
    u_r = kp_r.xy[res.idx, 0]
    disparity = kp_l.xy[:, 0] - u_r
    ok = res.valid & (disparity > 0.1)
    u_right = jnp.where(ok, u_r, -1.0)
    depth = jnp.where(ok, bf / jnp.maximum(disparity, 0.1), 0.0)
    return u_right, depth


def refine_stereo_subpixel(
    img_l: jnp.ndarray,
    img_r: jnp.ndarray,
    kp_xy: jnp.ndarray,
    u_right: jnp.ndarray,
    bf: float,
    patch: int = 5,
    search: int = 5,
):
    """Subpixel disparity by sliding-window SAD + parabola fit.

    The reference's `ComputeStereoMatches` correlates a window of the left
    image along the right epipolar row around the descriptor match and
    interpolates the SAD minimum (ORB-SLAM2 Frame.cc). Batched: one gather
    per (keypoint, offset) pair, no loops. Returns (u_right', depth')."""
    H, W = img_l.shape
    half = patch // 2
    ys = jnp.clip(kp_xy[:, 1].astype(jnp.int32), half, H - half - 1)
    xl = jnp.clip(kp_xy[:, 0].astype(jnp.int32), half, W - half - 1)
    dy, dx = jnp.meshgrid(
        jnp.arange(-half, half + 1), jnp.arange(-half, half + 1), indexing="ij"
    )
    patch_l = img_l[
        ys[:, None, None] + dy[None], xl[:, None, None] + dx[None]
    ]  # (N, p, p)

    offs = jnp.arange(-search, search + 1)  # (S,)
    xr0 = jnp.clip(u_right.astype(jnp.int32), half + search, W - half - search - 1)
    xr = xr0[:, None] + offs[None, :]  # (N, S)
    patch_r = img_r[
        ys[:, None, None, None] + dy[None, None],
        xr[:, :, None, None] + dx[None, None],
    ]  # (N, S, p, p)
    sad = jnp.sum(jnp.abs(patch_r - patch_l[:, None]), axis=(-2, -1))  # (N, S)

    best = jnp.argmin(sad, axis=1)
    best_in = jnp.clip(best, 1, 2 * search - 1)
    c0 = jnp.take_along_axis(sad, (best_in - 1)[:, None], 1)[:, 0]
    c1 = jnp.take_along_axis(sad, best_in[:, None], 1)[:, 0]
    c2 = jnp.take_along_axis(sad, (best_in + 1)[:, None], 1)[:, 0]
    denom = c0 + c2 - 2 * c1
    delta = jnp.where(jnp.abs(denom) > 1e-6, 0.5 * (c0 - c2) / denom, 0.0)
    delta = jnp.clip(delta, -1.0, 1.0)
    u_ref = xr0.astype(img_l.dtype) + best_in.astype(img_l.dtype) - search + delta

    valid = u_right >= 0
    disparity = kp_xy[:, 0] - u_ref
    ok = valid & (disparity > 0.1)
    u_out = jnp.where(ok, u_ref, -1.0)
    depth = jnp.where(ok, bf / jnp.maximum(disparity, 0.1), 0.0)
    return u_out, depth


def build_frame_stereo(
    img_left: jnp.ndarray,
    img_right: jnp.ndarray,
    cam: Camera,
    orb_cfg: orb.ORBConfig,
) -> Frame:
    """Stereo frame: ORB on both images, row-constrained matching for depth
    (the reference's STEREO sensor mode, System.h:106)."""
    kp_l = orb.extract(img_left, orb_cfg)
    kp_r = orb.extract(img_right, orb_cfg)
    u_right, depth = stereo_match(kp_l, kp_r, cam.bf)
    u_right, depth = refine_stereo_subpixel(
        img_left, img_right, kp_l.xy, u_right, cam.bf
    )
    uvr = jnp.concatenate([kp_l.xy, u_right[:, None]], axis=-1)
    sigma2 = jnp.asarray(orb.level_sigma2(orb_cfg))
    inv_sigma2 = 1.0 / sigma2[jnp.clip(kp_l.octave, 0, orb_cfg.num_levels - 1)]
    return Frame(kp=kp_l, uvr=uvr, depth=depth, inv_sigma2=inv_sigma2)


def build_frame(
    image: jnp.ndarray,
    cam: Camera,
    orb_cfg: orb.ORBConfig,
    depth_img: Optional[jnp.ndarray] = None,
    cloud_cam: Optional[jnp.ndarray] = None,
    cloud_lidar: Optional[jnp.ndarray] = None,
    T_cam_lidar: Optional[tuple] = None,  # (R (3,3), t (3)) extrinsics
    lidar_cfg: Optional[lidar_features.LidarConfig] = None,
) -> Frame:
    """Extract ORB and associate depth (from a depth image or a camera-frame
    LiDAR cloud). The visual and LiDAR branches are independent device
    computations — XLA overlaps them (reference runs them as two host
    threads, Frame.cc:286,458). With `lidar_cfg`, the full LOAM-style
    feature extraction runs on the cloud too (corner/flat + normals —
    Frame::lidarProcess, Frame.cc:1243), enabling tight coupling in
    tracking and BA."""
    kp = orb.extract(image, orb_cfg)
    H, W = image.shape
    lidar = None
    if cloud_lidar is not None:
        # Extraction runs in the native LiDAR frame (ring geometry assumes
        # x fwd / z up); features + the cloud are then brought into the
        # camera frame with the extrinsics (Frame.cc:461-466).
        R_cl, t_cl = T_cam_lidar if T_cam_lidar is not None else (
            jnp.eye(3), jnp.zeros(3)
        )
        if lidar_cfg is not None:
            feat = lidar_features.extract_features(cloud_lidar, lidar_cfg)
            lidar = lidar_features.transform_features(feat, R_cl, t_cl)
        if cloud_cam is None:
            cloud_cam = cloud_lidar @ R_cl.T + t_cl

    if depth_img is None and cloud_cam is not None:
        depth_img = project_cloud_to_depth_image(cloud_cam, cam, H, W)

    if depth_img is not None:
        depth, stable = associate_depth(depth_img, kp.xy)
    else:
        depth = jnp.zeros(kp.capacity)
        stable = jnp.zeros(kp.capacity, dtype=bool)

    u_right = jnp.where(
        stable & (depth > 0), kp.xy[:, 0] - cam.bf / jnp.maximum(depth, 1e-6), -1.0
    )
    uvr = jnp.concatenate([kp.xy, u_right[:, None]], axis=-1)
    sigma2 = jnp.asarray(orb.level_sigma2(orb_cfg))
    inv_sigma2 = 1.0 / sigma2[jnp.clip(kp.octave, 0, orb_cfg.num_levels - 1)]
    return Frame(kp=kp, uvr=uvr, depth=depth, inv_sigma2=inv_sigma2, lidar=lidar)


# Jit-compiled entry points. Frame construction MUST be a single device
# dispatch: run eagerly, the ORB pyramid alone issues hundreds of ops, each
# its own dispatch with its own host overhead.
build_frame_jit = jax.jit(
    build_frame, static_argnames=("cam", "orb_cfg", "lidar_cfg")
)
build_frame_stereo_jit = jax.jit(
    build_frame_stereo, static_argnames=("cam", "orb_cfg")
)
