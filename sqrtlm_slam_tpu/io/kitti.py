"""KITTI odometry dataset loading: images, velodyne, calibration, poses.

Replacement of `kittiHelper` (/root/reference/Node/kittiHelper.cpp:
37-182 — times.txt, gt poses, image_0/1, velodyne/*.bin readers) and the
calibration parsing of `FusionSystem` (/root/reference/src/fusionsystem.cc:
51-90 — P0/P2 projection rows and the Tr velodyne->cam extrinsic from the
sequence's own calib.txt). No ROS: this is a plain directory-reader feeding
numpy/JAX arrays straight into the pipeline.

Expected layout (KITTI odometry):
    sequences/<seq>/calib.txt, times.txt, image_0/{%06d}.png, velodyne/{%06d}.bin
    poses/<seq>.txt              (ground truth, 3x4 row-major per line)
"""

from __future__ import annotations

import os
import struct
import zlib
from typing import NamedTuple, Optional

import numpy as np

from ..factors.reprojection import Camera


class KittiCalib(NamedTuple):
    cam: Camera  # intrinsics from P0 (+ bf from P1 baseline when present)
    T_cam_velo: np.ndarray  # (4, 4) velodyne -> camera extrinsic ("Tr")


def parse_calib(path: str) -> KittiCalib:
    """Parse a KITTI odometry calib.txt (P0..P3 + Tr rows)."""
    mats = {}
    with open(path) as f:
        for line in f:
            if ":" not in line:
                continue
            k, v = line.split(":", 1)
            vals = np.array([float(x) for x in v.split()])
            mats[k.strip()] = vals.reshape(3, 4)
    P0 = mats["P0"]
    fx, fy, cx, cy = P0[0, 0], P0[1, 1], P0[0, 2], P0[1, 2]
    bf = 0.0
    if "P1" in mats:
        # P1[0,3] = -fx * baseline for the right camera.
        bf = float(-mats["P1"][0, 3])
    T = np.eye(4)
    if "Tr" in mats:
        T[:3] = mats["Tr"]
    return KittiCalib(
        cam=Camera(fx=float(fx), fy=float(fy), cx=float(cx), cy=float(cy), bf=bf),
        T_cam_velo=T,
    )


def read_velodyne_bin(path: str) -> np.ndarray:
    """KITTI velodyne scan: float32 x,y,z,intensity records -> (N, 4)
    (kittiHelper.cpp:25-35)."""
    data = np.fromfile(path, dtype=np.float32)
    return data.reshape(-1, 4)


def read_times(path: str) -> np.ndarray:
    return np.loadtxt(path).reshape(-1)


def read_poses(path: str) -> np.ndarray:
    """GT poses: (F, 4, 4) cam0-to-world."""
    data = np.loadtxt(path).reshape(-1, 3, 4)
    out = np.tile(np.eye(4), (data.shape[0], 1, 1))
    out[:, :3, :] = data
    return out


_PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"


def _png_chunk(tag: bytes, body: bytes) -> bytes:
    return (
        struct.pack(">I", len(body)) + tag + body
        + struct.pack(">I", zlib.crc32(tag + body))
    )


def write_png_gray(path: str, img: np.ndarray) -> None:
    """Write (H, W) uint8 as an 8-bit grayscale PNG, every row Sub-filtered."""
    a = np.asarray(img, np.uint8)
    H, W = a.shape
    sub = a.copy()
    sub[:, 1:] = a[:, 1:] - a[:, :-1]  # uint8 arithmetic wraps mod 256
    raw = np.concatenate([np.ones((H, 1), np.uint8), sub], axis=1).tobytes()
    with open(path, "wb") as f:
        f.write(
            _PNG_SIGNATURE
            + _png_chunk(b"IHDR", struct.pack(">IIBBBBB", W, H, 8, 0, 0, 0, 0))
            + _png_chunk(b"IDAT", zlib.compress(raw, 6))
            + _png_chunk(b"IEND", b"")
        )


def _unfilter_average(row: np.ndarray, prev: np.ndarray) -> np.ndarray:
    out = bytearray(len(row))
    left = 0
    for i, (f, up) in enumerate(zip(row.tolist(), prev.tolist())):
        left = (f + ((left + up) >> 1)) & 0xFF
        out[i] = left
    return np.frombuffer(bytes(out), np.uint8)


def _unfilter_paeth(row: np.ndarray, prev: np.ndarray) -> np.ndarray:
    out = bytearray(len(row))
    left = upleft = 0
    for i, (f, up) in enumerate(zip(row.tolist(), prev.tolist())):
        p = left + up - upleft
        pa, pb, pc = abs(p - left), abs(p - up), abs(p - upleft)
        pred = left if pa <= pb and pa <= pc else (up if pb <= pc else upleft)
        left = (f + pred) & 0xFF
        out[i] = left
        upleft = up
    return np.frombuffer(bytes(out), np.uint8)


def read_png_gray(path: str) -> np.ndarray:
    """Read an 8-bit grayscale, non-interlaced PNG -> (H, W) uint8.

    A stdlib (zlib + struct) decoder covering the five PNG row filters, so
    the KITTI path needs no imaging library. Sub and Up rows decode
    vectorised; Average and Paeth rows decode pixel by pixel."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:8] != _PNG_SIGNATURE:
        raise ValueError(f"{path}: not a PNG file")
    pos, idat, header = 8, [], None
    while pos + 8 <= len(data):
        n, tag = struct.unpack(">I4s", data[pos : pos + 8])
        body = data[pos + 8 : pos + 8 + n]
        pos += 12 + n
        if tag == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif tag == b"IDAT":
            idat.append(body)
        elif tag == b"IEND":
            break
    if header is None:
        raise ValueError(f"{path}: no IHDR chunk")
    W, H, depth, color, _, _, interlace = header
    if depth != 8 or color != 0 or interlace != 0:
        raise ValueError(
            f"{path}: only 8-bit grayscale non-interlaced PNG is supported "
            f"(bit depth {depth}, color type {color}, interlace {interlace})"
        )
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    raw = raw.reshape(H, W + 1)
    out = np.empty((H, W), np.uint8)
    prev = np.zeros(W, np.uint8)
    for y in range(H):
        ftype, row = raw[y, 0], raw[y, 1:]
        if ftype == 0:
            cur = row
        elif ftype == 1:
            cur = np.cumsum(row, dtype=np.uint8)
        elif ftype == 2:
            cur = row + prev
        elif ftype == 3:
            cur = _unfilter_average(row, prev)
        elif ftype == 4:
            cur = _unfilter_paeth(row, prev)
        else:
            raise ValueError(f"{path}: bad PNG filter type {ftype} in row {y}")
        out[y] = cur
        prev = out[y]
    return out


def read_image(path: str) -> np.ndarray:
    """Grayscale image as float32 (H, W) in [0, 255]."""
    return read_png_gray(path).astype(np.float32)


class KittiSequence:
    """Iterator over one KITTI odometry sequence."""

    def __init__(self, root: str, seq: str, camera: str = "image_0"):
        self.seq_dir = os.path.join(root, "sequences", seq)
        self.calib = parse_calib(os.path.join(self.seq_dir, "calib.txt"))
        times_path = os.path.join(self.seq_dir, "times.txt")
        self.times = read_times(times_path) if os.path.exists(times_path) else None
        self.image_dir = os.path.join(self.seq_dir, camera)
        self.velo_dir = os.path.join(self.seq_dir, "velodyne")
        gt_path = os.path.join(root, "poses", seq + ".txt")
        self.gt_poses = read_poses(gt_path) if os.path.exists(gt_path) else None
        if os.path.isdir(self.image_dir):
            self.num_frames = len(
                [f for f in os.listdir(self.image_dir) if f.endswith(".png")]
            )
        elif os.path.isdir(self.velo_dir):
            self.num_frames = len(
                [f for f in os.listdir(self.velo_dir) if f.endswith(".bin")]
            )
        else:
            self.num_frames = 0

    def image(self, i: int) -> np.ndarray:
        return read_image(os.path.join(self.image_dir, f"{i:06d}.png"))

    def velodyne(self, i: int) -> np.ndarray:
        return read_velodyne_bin(os.path.join(self.velo_dir, f"{i:06d}.bin"))

    def cloud_in_cam(self, i: int) -> np.ndarray:
        """Velodyne points transformed into the camera frame via Tr
        (fusionsystem.cc applies K·Tr for the depth image; Frame.cc:461-466
        moves feature clouds to the camera frame)."""
        pts = self.velodyne(i)[:, :3]
        T = self.calib.T_cam_velo
        return pts @ T[:3, :3].T + T[:3, 3]

    def __len__(self):
        return self.num_frames


def write_kitti_poses(path: str, poses: np.ndarray):
    """(F, 4, 4) cam-to-world -> KITTI 3x4 row-major lines."""
    with open(path, "w") as f:
        for T in poses:
            f.write(" ".join(f"{x:.9e}" for x in T[:3].reshape(-1)) + "\n")
