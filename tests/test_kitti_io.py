"""KITTI loader/writer round-trips on a synthetic dataset fixture."""

import os

import numpy as np
import pytest

from sqrtlm_slam_tpu.eval import ate
from sqrtlm_slam_tpu.io import kitti


@pytest.fixture()
def fake_kitti(tmp_path):
    """Minimal KITTI odometry tree: calib, times, velodyne bins, poses."""
    root = tmp_path / "kitti"
    seq = root / "sequences" / "04"
    (seq / "velodyne").mkdir(parents=True)
    (root / "poses").mkdir(parents=True)

    fx, cx, cy, bf = 718.856, 607.1928, 185.2157, 386.1448
    with open(seq / "calib.txt", "w") as f:
        P0 = f"P0: {fx} 0 {cx} 0 0 {fx} {cy} 0 0 0 1 0\n"
        P1 = f"P1: {fx} 0 {cx} {-bf} 0 {fx} {cy} 0 0 0 1 0\n"
        Tr = "Tr: 0 -1 0 0 0 0 -1 0 1 0 0 -0.08\n"
        f.write(P0 + P1 + Tr)
    np.savetxt(seq / "times.txt", np.arange(5) * 0.1)

    rng = np.random.RandomState(0)
    for i in range(5):
        pts = rng.randn(100, 4).astype(np.float32)
        pts.tofile(seq / "velodyne" / f"{i:06d}.bin")

    poses = np.tile(np.eye(4), (5, 1, 1))
    poses[:, 0, 3] = np.arange(5) * 1.5  # move along x
    with open(root / "poses" / "04.txt", "w") as f:
        for T in poses:
            f.write(" ".join(str(x) for x in T[:3].reshape(-1)) + "\n")
    return str(root)


class TestKittiIO:
    def test_calib(self, fake_kitti):
        seq = kitti.KittiSequence(fake_kitti, "04")
        assert abs(seq.calib.cam.fx - 718.856) < 1e-6
        assert abs(seq.calib.cam.bf - 386.1448) < 1e-3
        assert seq.calib.T_cam_velo.shape == (4, 4)

    def test_velodyne_and_cam_transform(self, fake_kitti):
        seq = kitti.KittiSequence(fake_kitti, "04")
        pts = seq.velodyne(0)
        assert pts.shape == (100, 4)
        cam_pts = seq.cloud_in_cam(0)
        # Tr maps velo x-forward to cam z-forward.
        T = seq.calib.T_cam_velo
        manual = pts[:, :3] @ T[:3, :3].T + T[:3, 3]
        np.testing.assert_allclose(cam_pts, manual, atol=1e-6)

    def test_gt_poses_and_times(self, fake_kitti):
        seq = kitti.KittiSequence(fake_kitti, "04")
        assert seq.gt_poses.shape == (5, 4, 4)
        assert len(seq.times) == 5
        assert seq.num_frames == 5

    def test_pose_writer_roundtrip(self, fake_kitti, tmp_path):
        seq = kitti.KittiSequence(fake_kitti, "04")
        out = tmp_path / "out.txt"
        kitti.write_kitti_poses(str(out), seq.gt_poses)
        again = kitti.read_poses(str(out))
        np.testing.assert_allclose(again, seq.gt_poses, atol=1e-6)

    def test_ate_on_perturbed(self, fake_kitti):
        seq = kitti.KittiSequence(fake_kitti, "04")
        est = seq.gt_poses.copy()
        est[:, :3, 3] += 0.05
        rmse, _ = ate.ate_rmse(est, seq.gt_poses, align_scale=False)
        assert rmse < 1e-4  # constant offset is removed by alignment

    def test_rpe_zero_for_identical(self, fake_kitti):
        seq = kitti.KittiSequence(fake_kitti, "04")
        t_err, r_err = ate.rpe(seq.gt_poses, seq.gt_poses)
        assert t_err < 1e-9 and r_err < 1e-3


def _png_with_filters(path, img, filters):
    """Independent PNG encoder: row y filtered with filters[y] (0-4)."""
    import struct
    import zlib

    a = img.astype(np.int64)
    H, W = a.shape
    raw = bytearray()
    for y in range(H):
        ft = filters[y % len(filters)]
        up = a[y - 1] if y else np.zeros(W, np.int64)
        left = np.concatenate([[0], a[y, :-1]])
        upleft = np.concatenate([[0], up[:-1]])
        if ft == 0:
            pred = np.zeros(W, np.int64)
        elif ft == 1:
            pred = left
        elif ft == 2:
            pred = up
        elif ft == 3:
            pred = (left + up) // 2
        else:
            p = left + up - upleft
            pa, pb, pc = np.abs(p - left), np.abs(p - up), np.abs(p - upleft)
            pred = np.where((pa <= pb) & (pa <= pc), left, np.where(pb <= pc, up, upleft))
        raw.append(ft)
        raw.extend(((a[y] - pred) % 256).astype(np.uint8).tobytes())

    def chunk(tag, body):
        return struct.pack(">I", len(body)) + tag + body + struct.pack(
            ">I", zlib.crc32(tag + body)
        )

    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n")
        f.write(chunk(b"IHDR", struct.pack(">IIBBBBB", W, H, 8, 0, 0, 0, 0)))
        f.write(chunk(b"IDAT", zlib.compress(bytes(raw))))
        f.write(chunk(b"IEND", b""))


class TestPngCodec:
    def _image(self, H=37, W=53, seed=0):
        rng = np.random.RandomState(seed)
        yy, xx = np.mgrid[0:H, 0:W]
        smooth = (xx * 3 + yy * 2) % 256
        return ((smooth + rng.randint(0, 40, (H, W))) % 256).astype(np.uint8)

    def test_write_read_roundtrip(self, tmp_path):
        img = self._image()
        path = str(tmp_path / "a.png")
        kitti.write_png_gray(path, img)
        np.testing.assert_array_equal(kitti.read_png_gray(path), img)
        got = kitti.read_image(path)
        assert got.dtype == np.float32 and got.shape == img.shape

    @pytest.mark.parametrize("filters", [[0], [1], [2], [3], [4], [4, 3, 2, 1, 0]])
    def test_reads_every_filter_type(self, tmp_path, filters):
        img = self._image(seed=len(filters) + filters[0])
        path = str(tmp_path / "f.png")
        _png_with_filters(path, img, filters)
        np.testing.assert_array_equal(kitti.read_png_gray(path), img)

    def test_agrees_with_pillow(self, tmp_path):
        Image = pytest.importorskip("PIL.Image")
        img = self._image(H=64, W=80, seed=3)
        ours = str(tmp_path / "ours.png")
        kitti.write_png_gray(ours, img)
        np.testing.assert_array_equal(np.asarray(Image.open(ours)), img)
        theirs = str(tmp_path / "theirs.png")
        Image.fromarray(img).save(theirs)  # Pillow picks its own filters
        np.testing.assert_array_equal(kitti.read_png_gray(theirs), img)

    def test_rejects_non_grayscale(self, tmp_path):
        import struct
        import zlib

        path = tmp_path / "rgb.png"
        ihdr = struct.pack(">IIBBBBB", 2, 2, 8, 2, 0, 0, 0)
        body = b"IHDR" + ihdr
        with open(path, "wb") as f:
            f.write(b"\x89PNG\r\n\x1a\n")
            f.write(struct.pack(">I", len(ihdr)) + body)
            f.write(struct.pack(">I", zlib.crc32(body)))
        with pytest.raises(ValueError, match="grayscale"):
            kitti.read_png_gray(str(path))
