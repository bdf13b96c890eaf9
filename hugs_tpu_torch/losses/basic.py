"""Image losses, plain PyTorch: L1, L2, PSNR, windowed SSIM, TV and the
point-cloud Laplacian smoothing term.

SSIM uses an 11x11 Gaussian window, sigma 1.5, zero-padded depthwise
convolution, C1 = 0.01^2, C2 = 0.03^2, computed as two 1-D passes (the
window is rank 1). Images are (3, H, W) in [0, 1]. The convolutions run
with TF32 off: on the card cuDNN would take float32 convolutions in
TF32 (about three decimal digits), and SSIM's variance terms,
blur(x^2) - mu^2, are cancellations that such rounding swamps.
"""
from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F


def l1_loss(pred: torch.Tensor, gt: torch.Tensor,
            mask: torch.Tensor | None = None) -> torch.Tensor:
    """Mean absolute error; with a mask, the sum of absolute error over
    the whole image divided by mask.sum()."""
    if mask is not None:
        return torch.sum(torch.abs(pred - gt)) / torch.clamp(
            torch.sum(mask), min=1.0)
    return torch.mean(torch.abs(pred - gt))


def l2_loss(pred: torch.Tensor, gt: torch.Tensor) -> torch.Tensor:
    return torch.mean((pred - gt) ** 2)


def psnr(pred: torch.Tensor, gt: torch.Tensor) -> torch.Tensor:
    """PSNR over all pixels, for images in [0, 1]."""
    mse = torch.mean((pred - gt) ** 2)
    return 20.0 * torch.log10(1.0 / torch.sqrt(torch.clamp(mse, min=1e-12)))


@functools.lru_cache(maxsize=4)
def _gaussian_window_np(window_size: int, sigma: float) -> np.ndarray:
    xs = np.arange(window_size) - window_size // 2
    g = np.exp(-(xs ** 2) / (2.0 * sigma ** 2))
    return (g / g.sum()).astype(np.float32)


def no_tf32_convs():
    """A context in which cuDNN runs float32 convolutions in float32,
    whatever the caller's global setting; the other cuDNN flags stay."""
    cudnn = torch.backends.cudnn
    return cudnn.flags(enabled=cudnn.enabled, benchmark=cudnn.benchmark,
                       deterministic=cudnn.deterministic, allow_tf32=False)


def _depthwise_blur(img: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """(C, H, W) zero-padded depthwise Gaussian blur, separable: a
    vertical then a horizontal 1-D pass."""
    c, k = img.shape[0], g.shape[0]
    kh = g.reshape(1, 1, k, 1).expand(c, 1, k, 1)
    kw = g.reshape(1, 1, 1, k).expand(c, 1, 1, k)
    with no_tf32_convs():
        out = F.conv2d(img[None], kh, padding=(k // 2, 0), groups=c)
        out = F.conv2d(out, kw, padding=(0, k // 2), groups=c)
    return out[0]


@functools.lru_cache(maxsize=8)
def _gaussian_window(window_size: int, sigma: float,
                     device: torch.device) -> torch.Tensor:
    """The window on a device, copied there once: a copy from host memory
    waits for the card, and a captured step (train/graph_step.py) cannot
    make one."""
    return torch.as_tensor(_gaussian_window_np(window_size, sigma),
                           device=device)


def _ssim_map(img1, img2, window_size, sigma):
    w = _gaussian_window(window_size, sigma, img1.device)
    mu1 = _depthwise_blur(img1, w)
    mu2 = _depthwise_blur(img2, w)
    mu1_sq, mu2_sq, mu1_mu2 = mu1 * mu1, mu2 * mu2, mu1 * mu2
    sigma1_sq = _depthwise_blur(img1 * img1, w) - mu1_sq
    sigma2_sq = _depthwise_blur(img2 * img2, w) - mu2_sq
    sigma12 = _depthwise_blur(img1 * img2, w) - mu1_mu2
    C1, C2 = 0.01 ** 2, 0.03 ** 2
    return ((2 * mu1_mu2 + C1) * (2 * sigma12 + C2)) / (
        (mu1_sq + mu2_sq + C1) * (sigma1_sq + sigma2_sq + C2))


def ssim(img1: torch.Tensor, img2: torch.Tensor, window_size: int = 11,
         sigma: float = 1.5) -> torch.Tensor:
    """Mean SSIM over the image, (C, H, W) inputs."""
    return torch.mean(_ssim_map(img1, img2, window_size, sigma))


def ssim_masked(img1: torch.Tensor, img2: torch.Tensor, valid: torch.Tensor,
                n_valid: torch.Tensor, window_size: int = 11,
                sigma: float = 1.5) -> torch.Tensor:
    """Mean SSIM over a rectangular valid region of (C, H, W) inputs that
    are zero outside `valid` ((1, H, W) or (C, H, W) bool). For a
    rectangle this equals `ssim` of the cropped images, whose windows see
    the same zero padding at the crop's edge; the shape stays fixed."""
    m = _ssim_map(img1, img2, window_size, sigma)
    return torch.sum(torch.where(valid, m, 0.0)) / (
        img1.shape[0] * torch.clamp(torch.as_tensor(n_valid), min=1))


def total_variation_loss(img: torch.Tensor,
                         mask: torch.Tensor | None = None) -> torch.Tensor:
    """Anisotropic total variation, per pixel (or per mask pixel)."""
    d_x = img[..., :, 1:] - img[..., :, :-1]
    d_y = img[..., 1:, :] - img[..., :-1, :]
    tv = torch.sum(torch.abs(d_x)) + torch.sum(torch.abs(d_y))
    if mask is not None:
        return tv / torch.clamp(torch.sum(mask), min=1.0)
    return tv / (img.shape[-1] * img.shape[-2])


def pcd_laplacian_smoothing(verts: torch.Tensor,
                            edges: torch.Tensor) -> torch.Tensor:
    """Uniform-Laplacian smoothing term: mean ||L verts|| with
    L = A / deg - I from the (E, 2) undirected edge list. L depends only
    on the connectivity, so no gradient flows through it."""
    n = verts.shape[0]
    e0, e1 = edges[:, 0].long(), edges[:, 1].long()
    ones = torch.ones(e0.shape[0], dtype=verts.dtype, device=verts.device)
    deg = torch.zeros(n, dtype=verts.dtype, device=verts.device) \
        .index_add(0, e0, ones).index_add(0, e1, ones)
    inv_deg = 1.0 / torch.clamp(deg, min=1.0)
    nb = torch.zeros_like(verts).index_add(0, e0, verts[e1]) \
        .index_add(0, e1, verts[e0])
    lap = nb * inv_deg[:, None] - verts
    return torch.mean(torch.linalg.norm(lap, dim=-1))
