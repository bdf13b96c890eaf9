"""The benchmark's input sequence: a synthetic NeuMan capture made from
the seed and rendered by the frozen plain renderer.

A copy of chip_smoke.py's write_neuman_sequence (phase 3f) and its
helpers (avatar_scene_points, gt_poses, the orbit of
data/cameras.get_rotating_camera, colmap._rot_to_quat, the PNG writer),
rewritten so that nothing of the program renders or writes its inputs:
the frames come from bench_port/reference/plain, so a change to the
program cannot move them. Each frame is the synthetic body (a stand-in
for SMPL) posed by gt_poses, as striped splats, amid a scene of splats
at the point cloud's points, rendered on white from an orbit about the
origin; the mask is where the body alone leaves less than half the
light. The capture is written in the NeuMan layout that
hugs_tpu_torch/data/neuman.py reads, with COLMAP text files.
"""
from __future__ import annotations

import os
import struct
import zlib
from typing import NamedTuple

import numpy as np
import torch

from bench_port.reference.plain.models.scene_gs import (
    create_from_pcd, scene_forward,
)
from bench_port.reference.plain.models.smpl import (
    SMPLModel, smpl_forward, synthetic_smpl,
)
from bench_port.reference.plain.ops.knn import mean_sq_dist_to_knn
from bench_port.reference.plain.render.renderer import render

SH_C0 = 0.28209479177387814


class Sequence(NamedTuple):
    """What the generator made, for the reference to read as it is: the
    body, the scene's points (exact and as written, with noise), and per
    frame its world-to-view (row-vector), image and mask as written
    (uint8), body pose and orientation."""
    body: SMPLModel
    points: np.ndarray          # (S, 3) float32, the scene's splats
    noisy_points: np.ndarray    # (S, 3) float32, points3D.txt
    colors: np.ndarray          # (S, 3) float32 in [0, 1]
    world_view: np.ndarray      # (F, 4, 4) float32
    images: np.ndarray          # (F, H, W, 3) uint8
    masks: np.ndarray           # (F, H, W) uint8, 255 on the body
    body_pose: np.ndarray       # (F, 69) float32 axis-angle
    global_orient: np.ndarray   # (F, 3) float32
    fov: float
    width: int
    height: int


def scene_points(n: int, seed: int):
    """fps_bench_tpu.py's scene: n points uniform in [-4, 4]^3 pulled
    into the radius-4 ball, and random colours."""
    rng = np.random.RandomState(seed % (1 << 32))
    pts = rng.uniform(-4, 4, (n, 3)).astype(np.float32)
    pts /= np.maximum(np.linalg.norm(pts, axis=1, keepdims=True) / 4.0, 1.0)
    return pts, rng.rand(n, 3).astype(np.float32)


def gt_poses(f: int, n: int):
    """Frame f of n of the ground-truth motion: a swing of the arms and
    legs and a slow twist of the torso (axis-angle body pose (69,) and
    global orient (3,))."""
    t = 2.0 * np.pi * f / n
    pose = np.zeros(69, np.float32)
    pose[0 * 3 + 0] = 0.35 * np.sin(t)
    pose[1 * 3 + 0] = -0.35 * np.sin(t)
    pose[3 * 3 + 0] = 0.5 * max(0.0, np.sin(t))
    pose[4 * 3 + 0] = 0.5 * max(0.0, -np.sin(t))
    pose[15 * 3 + 2] = 0.6 * np.sin(t)
    pose[16 * 3 + 2] = -0.6 * np.sin(t)
    pose[17 * 3 + 1] = 0.4 * np.cos(t)
    pose[18 * 3 + 1] = -0.4 * np.cos(t)
    pose[8 * 3 + 1] = 0.2 * np.sin(2 * t)
    orient = np.array([0.0, 0.15 * np.sin(t), 0.0], np.float32)
    return pose, orient


def orbit(n: int, dist: float) -> np.ndarray:
    """(n, 4, 4) row-vector world-to-view of n cameras on a circle of
    radius dist about the origin, looking at it, y down (the orbit of
    data/cameras.get_rotating_camera over a whole turn)."""
    flip = np.diag([1.0, -1.0, -1.0]).astype(np.float32)
    out = []
    for azim in np.linspace(0.0, 2 * np.pi, n + 1)[:-1]:
        c, s = np.cos(azim), np.sin(azim)
        rot = np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]], np.float32)
        c2w = np.eye(4, dtype=np.float32)
        c2w[:3, :3] = rot @ flip
        c2w[:3, 3] = rot @ np.array([0.0, 0.0, dist], np.float32)
        out.append(np.linalg.inv(c2w).T)
    return np.stack(out).astype(np.float32)


def camera(world_view, fov: float, device):
    """A frozen Camera from a row-vector world-to-view and a square fov,
    as data/cameras._camera_from_w2c builds it."""
    from bench_port.reference.plain.ops.graphics import (
        camera_center, full_projection, projection_matrix,
    )
    from bench_port.reference.plain.render.camera import Camera
    wv = torch.as_tensor(np.asarray(world_view, np.float32), device=device)
    proj = projection_matrix(0.01, 100.0, fov, fov, device=device)
    tan = torch.tensor(np.tan(fov / 2), dtype=torch.float32, device=device)
    return Camera(world_view=wv, full_proj=full_projection(wv, proj),
                  center=camera_center(wv), tan_fovx=tan, tan_fovy=tan)


def rot_to_quat(R: np.ndarray):
    """(w, x, y, z) of a rotation matrix (branch-stable)."""
    R = np.asarray(R, np.float64)
    t = np.trace(R)
    if t > 0:
        s = np.sqrt(t + 1.0) * 2
        return (0.25 * s, (R[2, 1] - R[1, 2]) / s, (R[0, 2] - R[2, 0]) / s,
                (R[1, 0] - R[0, 1]) / s)
    i = int(np.argmax(np.diag(R)))
    j, k = (i + 1) % 3, (i + 2) % 3
    s = np.sqrt(max(R[i, i] - R[j, j] - R[k, k] + 1.0, 1e-12)) * 2
    q = [0.0, 0.0, 0.0]
    q[i] = 0.25 * s
    q[j] = (R[j, i] + R[i, j]) / s
    q[k] = (R[k, i] + R[i, k]) / s
    return ((R[k, j] - R[j, k]) / s, *q)


def write_png(path: str, img: np.ndarray) -> None:
    """uint8 (H, W) gray or (H, W, 3) RGB, every row with filter None."""
    img = np.ascontiguousarray(img)
    h, w = img.shape[:2]
    c = 1 if img.ndim == 2 else img.shape[2]

    def chunk(kind: bytes, body: bytes) -> bytes:
        return (struct.pack(">I", len(body)) + kind + body
                + struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF))
    rows = np.concatenate([np.zeros((h, 1), np.uint8), img.reshape(h, w * c)],
                          1)
    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n")
        f.write(chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8,
                                           {1: 0, 3: 2}[c], 0, 0, 0)))
        f.write(chunk(b"IDAT", zlib.compress(rows.tobytes(), 1)))
        f.write(chunk(b"IEND", b""))


def make_sequence(params: dict, scene_n: int, body_vpb: int, seed: int,
                  device) -> Sequence:
    """The sequence of traffic `params` (frames, width, height, fov,
    distance, pcd_noise) with a scene of scene_n points from `seed` and
    the synthetic body of body_vpb vertices a bone, rendered on the
    device by the frozen plain renderer."""
    n_frames, W, H = params["frames"], params["width"], params["height"]
    fov, dev = float(params["fov"]), torch.device(device)
    body = synthetic_smpl(body_vpb, device=dev)
    vt = body.v_template
    col = torch.stack([0.5 + 0.45 * torch.sin(25.0 * vt[:, 1]),
                       0.5 + 0.45 * torch.sin(20.0 * vt[:, 0] + 2.0),
                       0.5 + 0.45 * torch.cos(18.0 * vt[:, 2] + 4.0)], 1)
    h_shs = torch.zeros((vt.shape[0], 16, 3), device=dev)
    h_shs[:, 0, :] = (torch.clamp(col, 0, 1) - 0.5) / SH_C0
    h_scales = (torch.sqrt(torch.clamp(mean_sq_dist_to_knn(vt, k=3),
                                       min=1e-8)) * 0.9)[:, None].repeat(1, 3)
    h_rotq = torch.tensor([1.0, 0, 0, 0], device=dev).repeat(vt.shape[0], 1)
    h_op = torch.full((vt.shape[0],), 0.95, device=dev)
    pts, cols = scene_points(scene_n, seed)
    with torch.no_grad():
        s_out = scene_forward(create_from_pcd(pts, cols, scene_n,
                                              device=dev))
    s_out["opacity"] = torch.full_like(s_out["opacity"], 0.5)
    wvs = orbit(n_frames, float(params["distance"]))
    zeros3, betas = torch.zeros(3, device=dev), torch.zeros(10, device=dev)
    poses = [gt_poses(f, n_frames) for f in range(n_frames)]
    images = np.zeros((n_frames, H, W, 3), np.uint8)
    masks = np.zeros((n_frames, H, W), np.uint8)
    budget = 1 << 23
    with torch.no_grad():
        for f, (pose, orient) in enumerate(poses):
            cam = camera(wvs[f], fov, dev)
            verts = smpl_forward(body, betas, torch.as_tensor(pose, device=dev),
                                 torch.as_tensor(orient, device=dev),
                                 zeros3).vertices

            def draw(xyz, scales, rotq, op, shs, bg):
                pkg = render(xyz, scales, rotq, op, shs, cam, W, H, bg=bg,
                             active_sh_degree=0, instance_budget=budget)
                if bool(pkg["overflowed"]):
                    raise RuntimeError(f"sequence frame {f} overflowed")
                return pkg["render"]

            human = (verts, h_scales, h_rotq, h_op, h_shs)
            t_map = torch.clamp((draw(*human, torch.ones(3, device=dev))
                                 - draw(*human, zeros3)).mean(0), 0, 1)
            merged = [torch.cat([a, s_out[k]]) for a, k in zip(
                human, ("xyz", "scales", "rotq", "opacity", "shs"))]
            img = draw(*merged, torch.ones(3, device=dev))
            images[f] = (img.permute(1, 2, 0).clamp(0, 1) * 255).round().to(
                torch.uint8).cpu().numpy()
            masks[f] = ((t_map < 0.5).to(torch.uint8) * 255).cpu().numpy()
    noisy = pts + np.random.default_rng(seed + 5).normal(
        scale=float(params["pcd_noise"]), size=pts.shape).astype(np.float32)
    return Sequence(body=body, points=pts, noisy_points=noisy, colors=cols,
                    world_view=wvs, images=images, masks=masks,
                    body_pose=np.stack([p for p, _ in poses]),
                    global_orient=np.stack([o for _, o in poses]), fov=fov,
                    width=W, height=H)


def write_neuman(seq: Sequence, root: str, name: str) -> str:
    """seq in the NeuMan layout as sequence `name` under root (images,
    segmentations, COLMAP text of the orbit and the noisy points, the
    per-frame SMPL parameters). Returns root."""
    path = os.path.join(root, name)
    for sub in ("images", "segmentations", "sparse", "4d_humans"):
        os.makedirs(os.path.join(path, sub))
    lines = []
    for f in range(len(seq.images)):
        write_png(f"{path}/images/{f:05d}.png", seq.images[f])
        write_png(f"{path}/segmentations/{f:05d}.png", seq.masks[f])
        wv = seq.world_view[f].astype(np.float64)
        q = rot_to_quat(wv[:3, :3])
        t = wv[3, :3]
        lines.append(f"{f + 1} {q[0]} {q[1]} {q[2]} {q[3]} {t[0]} {t[1]} "
                     f"{t[2]} 1 {f:05d}.png\n\n")
    W, H = seq.width, seq.height
    fx = W / (2.0 * np.tan(seq.fov / 2.0))
    fy = H / (2.0 * np.tan(seq.fov / 2.0))
    with open(f"{path}/sparse/cameras.txt", "w") as fh:
        fh.write(f"1 PINHOLE {W} {H} {fx} {fy} {W / 2} {H / 2}\n")
    with open(f"{path}/sparse/images.txt", "w") as fh:
        fh.write("".join(lines))
    rgb = np.round(seq.colors * 255).astype(int)
    with open(f"{path}/sparse/points3D.txt", "w") as fh:
        fh.write("".join(f"{i} {p[0]} {p[1]} {p[2]} {c[0]} {c[1]} {c[2]} 0\n"
                         for i, (p, c) in enumerate(zip(seq.noisy_points,
                                                        rgb))))
    n = len(seq.images)
    np.savez(f"{path}/4d_humans/smpl_optimized_aligned_scale.npz",
             betas=np.zeros((n, 10), np.float32),
             global_orient=seq.global_orient, body_pose=seq.body_pose,
             transl=np.zeros((n, 3), np.float32),
             scale=np.ones(n, np.float32))
    return root
