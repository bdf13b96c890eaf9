"""COLMAP scene ingestion (ASCII and binary), numpy only; a copy of the
JAX package's reader.

Minimal reimplementation of the vendored ColmapAsciiReader behavior
(hugs/datasets/neuman_utils/colmap_helper.py:22-149): parse cameras.txt
(PINHOLE/SIMPLE_PINHOLE), images.txt (quaternion+translation extrinsics,
one pose line + one keypoint line per image), and points3D.txt (sparse
point cloud with colors). Returns plain numpy structures.

Beyond the reference: the binary COLMAP format (cameras.bin/images.bin/
points3D.bin — what `colmap mapper` actually writes by default; the
reference requires a prior `colmap model_converter` to TXT) is parsed
natively too, with `read_colmap_scene` auto-detecting whichever is
present. Large binary tables (points3D tracks, image keypoints) go
through the C++ runtime (native/hugs_io.cpp) when built, with pure-
numpy fallbacks here.
"""
from __future__ import annotations

import os
import struct
import warnings
from typing import NamedTuple

import numpy as np

# COLMAP camera model id -> (name, number of params), from COLMAP's
# src/colmap/sensor/models.h (stable public format)
CAMERA_MODELS = {
    0: ("SIMPLE_PINHOLE", 3),
    1: ("PINHOLE", 4),
    2: ("SIMPLE_RADIAL", 4),
    3: ("RADIAL", 5),
    4: ("OPENCV", 8),
    5: ("OPENCV_FISHEYE", 8),
    6: ("FULL_OPENCV", 12),
    7: ("FOV", 5),
    8: ("SIMPLE_RADIAL_FISHEYE", 4),
    9: ("RADIAL_FISHEYE", 5),
    10: ("THIN_PRISM_FISHEYE", 12),
}


class ColmapCamera(NamedTuple):
    width: int
    height: int
    fx: float
    fy: float
    cx: float
    cy: float


class ColmapImage(NamedTuple):
    name: str
    camera_id: int
    R: np.ndarray   # (3, 3) world->cam rotation
    t: np.ndarray   # (3,)


class ColmapScene(NamedTuple):
    cameras: dict          # id -> ColmapCamera
    images: list           # sorted by name
    points: np.ndarray     # (N, 3)
    colors: np.ndarray     # (N, 3) in [0, 1]


def _quat_to_rot(q: np.ndarray) -> np.ndarray:
    w, x, y, z = q
    return np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
    ], np.float32)


_FISHEYE_MODELS = ("SIMPLE_RADIAL_FISHEYE", "RADIAL_FISHEYE",
                   "OPENCV_FISHEYE", "THIN_PRISM_FISHEYE")


def _make_camera(model: str, w: int, h: int, p) -> ColmapCamera:
    if model == "SIMPLE_PINHOLE":
        fx = fy = p[0]
        cx, cy = p[1], p[2]
        dist = ()
    elif model == "PINHOLE":
        fx, fy, cx, cy = p[:4]
        dist = ()
    elif model in ("SIMPLE_RADIAL", "RADIAL") + _FISHEYE_MODELS[:2]:
        fx = fy = p[0]
        cx, cy = p[1], p[2]
        dist = tuple(p[3:])
    elif model in ("OPENCV", "FULL_OPENCV") + _FISHEYE_MODELS[2:]:
        fx, fy, cx, cy = p[:4]
        dist = tuple(p[4:])
    else:
        raise ValueError(f"unsupported camera model {model}")
    if any(abs(d) > 1e-12 for d in dist):
        # The pipeline assumes undistorted pinhole input (as the
        # reference's reader does). A distorted fisheye camera through a
        # pinhole projection is wrong geometry, not an approximation.
        if model in _FISHEYE_MODELS:
            raise ValueError(
                f"camera model {model} has nonzero distortion "
                f"{dist}; undistort the reconstruction first "
                f"(e.g. `colmap image_undistorter`)")
        warnings.warn(
            f"camera model {model}: dropping nonzero distortion "
            f"coefficients {dist}; projected geometry will be "
            f"approximate — prefer an undistorted reconstruction",
            stacklevel=2)
    return ColmapCamera(w, h, fx, fy, cx, cy)


def read_cameras_txt(path: str) -> dict:
    cams = {}
    with open(path) as f:
        for line in f:
            if line.startswith("#") or not line.strip():
                continue
            parts = line.split()
            cam_id, model = int(parts[0]), parts[1]
            w, h = int(parts[2]), int(parts[3])
            p = [float(x) for x in parts[4:]]
            cams[cam_id] = _make_camera(model, w, h, p)
    return cams


def read_cameras_bin(path: str) -> dict:
    """cameras.bin: u64 count; per camera i32 id, i32 model_id, u64 w,
    u64 h, f64 params[n_params(model)] (little-endian)."""
    cams = {}
    with open(path, "rb") as f:
        (n,) = struct.unpack("<Q", f.read(8))
        for _ in range(n):
            cam_id, model_id, w, h = struct.unpack("<iiQQ", f.read(24))
            if model_id not in CAMERA_MODELS:
                raise ValueError(
                    f"unsupported camera model id {model_id} in {path} "
                    f"(known ids: {sorted(CAMERA_MODELS)})")
            name, n_par = CAMERA_MODELS[model_id]
            p = struct.unpack(f"<{n_par}d", f.read(8 * n_par))
            cams[cam_id] = _make_camera(name, int(w), int(h), p)
    return cams


def read_images_txt(path: str) -> list:
    from hugs_tpu_torch.data import native
    res = native.parse_images(path)
    if res is not None:
        quat, trans, cam_ids, names = res
        images = [ColmapImage(name=nm, camera_id=int(cid),
                              R=_quat_to_rot(q), t=t.astype(np.float32))
                  for q, t, cid, nm in zip(quat, trans, cam_ids, names)]
        images.sort(key=lambda im: im.name)
        return images
    images = []
    with open(path) as f:
        lines = [ln for ln in f if not ln.startswith("#")]
    # pose lines alternate with 2D-point lines
    for ln in lines[0::2]:
        parts = ln.split()
        if len(parts) < 10:
            continue
        q = np.array([float(x) for x in parts[1:5]])
        t = np.array([float(x) for x in parts[5:8]], np.float32)
        cam_id = int(parts[8])
        name = parts[9]
        images.append(ColmapImage(name=name, camera_id=cam_id,
                                  R=_quat_to_rot(q), t=t))
    images.sort(key=lambda im: im.name)
    return images


def read_images_bin(path: str) -> list:
    """images.bin: u64 count; per image i32 id, f64 q[4] (wxyz), f64
    t[3], i32 camera_id, name '\\0'-terminated, u64 n_pts2d, then
    n_pts2d * (f64 x, f64 y, i64 point3d_id). Keypoint tables dominate
    the file; the native C++ parser skips them without Python-loop cost,
    and the numpy fallback seeks past them."""
    from hugs_tpu_torch.data import native
    res = native.parse_images_bin(path)
    if res is not None:
        quat, trans, cam_ids, names = res
        images = [ColmapImage(name=nm, camera_id=int(cid),
                              R=_quat_to_rot(q), t=t.astype(np.float32))
                  for q, t, cid, nm in zip(quat, trans, cam_ids, names)]
        images.sort(key=lambda im: im.name)
        return images
    images = []
    with open(path, "rb") as f:
        (n,) = struct.unpack("<Q", f.read(8))
        for _ in range(n):
            data = struct.unpack("<idddddddi", f.read(64))
            q = np.asarray(data[1:5])
            t = np.asarray(data[5:8], np.float32)
            cam_id = data[8]
            name = b""
            while True:
                c = f.read(1)
                if c in (b"\x00", b""):
                    break
                name += c
            (n_pts,) = struct.unpack("<Q", f.read(8))
            f.seek(24 * n_pts, os.SEEK_CUR)
            images.append(ColmapImage(name=name.decode(), camera_id=cam_id,
                                      R=_quat_to_rot(q), t=t))
    images.sort(key=lambda im: im.name)
    return images


def read_points3d_bin(path: str):
    """points3D.bin: u64 count; per point i64 id, f64 xyz[3], u8 rgb[3],
    f64 error, u64 track_len, track_len * (i32 image_id, i32 pt2d_idx)."""
    from hugs_tpu_torch.data import native
    res = native.parse_points3d_bin(path)
    if res is not None:
        return res
    pts, cols = [], []
    with open(path, "rb") as f:
        (n,) = struct.unpack("<Q", f.read(8))
        for _ in range(n):
            rec = struct.unpack("<qdddBBBdQ", f.read(51))
            pts.append(rec[1:4])
            cols.append([rec[4] / 255.0, rec[5] / 255.0, rec[6] / 255.0])
            f.seek(8 * rec[8], os.SEEK_CUR)
    return (np.asarray(pts, np.float32).reshape(-1, 3),
            np.asarray(cols, np.float32).reshape(-1, 3))


def read_points3d_txt(path: str):
    from hugs_tpu_torch.data import native
    res = native.parse_points3d(path)
    if res is not None:
        return res
    pts, cols = [], []
    with open(path) as f:
        for line in f:
            if line.startswith("#") or not line.strip():
                continue
            parts = line.split()
            pts.append([float(x) for x in parts[1:4]])
            cols.append([float(x) / 255.0 for x in parts[4:7]])
    return (np.asarray(pts, np.float32),
            np.asarray(cols, np.float32))


def write_colmap_bin(sparse_dir: str, cameras: dict, images: list,
                     points: np.ndarray, colors: np.ndarray) -> None:
    """Write a minimal binary COLMAP model (PINHOLE cameras, empty
    keypoint/track tables). Inverse of read_colmap_scene for round-trip
    tests and for exporting scenes to COLMAP-ecosystem tools."""
    os.makedirs(sparse_dir, exist_ok=True)
    with open(os.path.join(sparse_dir, "cameras.bin"), "wb") as f:
        f.write(struct.pack("<Q", len(cameras)))
        for cam_id, c in cameras.items():
            f.write(struct.pack("<iiQQ", cam_id, 1, c.width, c.height))
            f.write(struct.pack("<4d", c.fx, c.fy, c.cx, c.cy))
    with open(os.path.join(sparse_dir, "images.bin"), "wb") as f:
        f.write(struct.pack("<Q", len(images)))
        for i, im in enumerate(images):
            q = _rot_to_quat(im.R)
            f.write(struct.pack("<idddddddi", i + 1, *q,
                                *im.t.astype(np.float64), im.camera_id))
            f.write(im.name.encode() + b"\x00")
            f.write(struct.pack("<Q", 0))
    with open(os.path.join(sparse_dir, "points3D.bin"), "wb") as f:
        f.write(struct.pack("<Q", len(points)))
        rgb255 = np.clip(np.round(np.asarray(colors) * 255.0),
                         0, 255).astype(np.uint8)
        for i, (p, c) in enumerate(zip(np.asarray(points, np.float64),
                                       rgb255)):
            f.write(struct.pack("<qdddBBBdQ", i, p[0], p[1], p[2],
                                int(c[0]), int(c[1]), int(c[2]), 0.0, 0))


def _rot_to_quat(R: np.ndarray):
    """(w, x, y, z) from a rotation matrix (branch-stable for writers)."""
    R = np.asarray(R, np.float64)
    t = np.trace(R)
    if t > 0:
        s = np.sqrt(t + 1.0) * 2
        w = 0.25 * s
        x = (R[2, 1] - R[1, 2]) / s
        y = (R[0, 2] - R[2, 0]) / s
        z = (R[1, 0] - R[0, 1]) / s
    else:
        i = int(np.argmax(np.diag(R)))
        j, k = (i + 1) % 3, (i + 2) % 3
        s = np.sqrt(max(R[i, i] - R[j, j] - R[k, k] + 1.0, 1e-12)) * 2
        q = [0.0, 0.0, 0.0]
        q[i] = 0.25 * s
        q[j] = (R[j, i] + R[i, j]) / s
        q[k] = (R[k, i] + R[i, k]) / s
        w = (R[k, j] - R[j, k]) / s
        x, y, z = q
    return w, x, y, z


def read_colmap_scene(sparse_dir: str) -> ColmapScene:
    """Auto-detects the model format: binary (cameras.bin/...) when
    present, ASCII (cameras.txt/...) otherwise. Mixed directories prefer
    binary per-table (COLMAP's own readers do the same)."""
    def pick(base, bin_fn, txt_fn):
        bpath = os.path.join(sparse_dir, base + ".bin")
        if os.path.exists(bpath):
            return bin_fn(bpath)
        return txt_fn(os.path.join(sparse_dir, base + ".txt"))

    cams = pick("cameras", read_cameras_bin, read_cameras_txt)
    images = pick("images", read_images_bin, read_images_txt)
    points, colors = pick("points3D", read_points3d_bin, read_points3d_txt)
    return ColmapScene(cameras=cams, images=images, points=points,
                       colors=colors)
