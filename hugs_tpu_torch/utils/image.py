"""Image saving: side-by-side grids as PNGs, through utils/png.py
(reference hugs/utils/image.py:48-95). The video helpers come with the
animation slice."""
from __future__ import annotations

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
