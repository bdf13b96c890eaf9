"""Image saving: PNGs and side-by-side grids through utils/png.py
(reference hugs/utils/image.py:48-95), and frames into a video with
ffmpeg (reference hugs/utils/general.py:86-92)."""
from __future__ import annotations

import os
import shutil
import subprocess

import numpy as np
import torch

from hugs_tpu_torch.utils.png import write_png


def _to_uint8_hwc(img) -> np.ndarray:
    """(3, H, W) or (H, W, 3) float in [0, 1], numpy or a tensor on any
    device -> (H, W, 3) uint8."""
    if isinstance(img, torch.Tensor):
        img = img.detach().cpu().numpy()
    img = np.asarray(img)
    if img.ndim == 3 and img.shape[0] == 3:
        img = img.transpose(1, 2, 0)
    return (np.clip(img, 0.0, 1.0) * 255).astype(np.uint8)


def save_png(img, path: str) -> None:
    """One image, (3, H, W) or (H, W, 3) in [0, 1], as an RGB PNG."""
    write_png(path, _to_uint8_hwc(img))


def save_image_grid(images: list, path: str, pad: int = 2,
                    pad_value: int = 255) -> None:
    """A horizontal grid of images, each padded at the bottom to the
    tallest, with `pad` columns of pad_value between them."""
    arrs = [_to_uint8_hwc(im) for im in images]
    h = max(a.shape[0] for a in arrs)
    cols = []
    for a in arrs:
        if a.shape[0] < h:
            a = np.pad(a, ((0, h - a.shape[0]), (0, 0), (0, 0)),
                       constant_values=pad_value)
        cols.append(a)
        cols.append(np.full((h, pad, 3), pad_value, np.uint8))
    write_png(path, np.concatenate(cols[:-1], axis=1))


_NO_ENCODER_SAID = False


def create_video(img_dir: str, out_path: str, fps: int = 20) -> bool:
    """img_dir/*.png, in name order, into an H.264 video at out_path with
    ffmpeg, where `shutil.which` finds one; returns whether a video was
    written. Without ffmpeg it writes nothing and says so once per
    process (the JAX package's cv2 writer has no counterpart: the GPU
    machine has no cv2)."""
    global _NO_ENCODER_SAID
    if shutil.which("ffmpeg") is None:
        if not _NO_ENCODER_SAID:
            _NO_ENCODER_SAID = True
            print(f"note: no ffmpeg on PATH, so no video is made of the "
                  f"frames (first: {img_dir}); the PNGs stay")
        return False
    cmd = ["ffmpeg", "-y", "-framerate", str(fps), "-pattern_type", "glob",
           "-i", os.path.join(img_dir, "*.png"), "-c:v", "libx264",
           "-pix_fmt", "yuv420p", out_path]
    try:
        subprocess.run(cmd, check=True, capture_output=True, timeout=600)
    except (subprocess.SubprocessError, OSError) as e:
        print(f"note: ffmpeg made no video of {img_dir}: {e}")
        return False
    return True
