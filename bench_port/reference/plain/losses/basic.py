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


@functools.lru_cache(maxsize=4)
def _gaussian_window_np(window_size: int, sigma: float) -> np.ndarray:
    xs = np.arange(window_size) - window_size // 2
    g = np.exp(-(xs ** 2) / (2.0 * sigma ** 2))
    return (g / g.sum()).astype(np.float32)


# the reference's control sets this to run the convolutions in TF32, the
# precision below the float32 that the configurations state
TF32 = False


def no_tf32_convs():
    """A context in which cuDNN runs float32 convolutions in float32
    (in TF32 where TF32 is set), whatever the caller's global setting;
    the other cuDNN flags stay."""
    cudnn = torch.backends.cudnn
    return cudnn.flags(enabled=cudnn.enabled, benchmark=cudnn.benchmark,
                       deterministic=cudnn.deterministic, allow_tf32=TF32)


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


def _ssim_map(img1, img2, window_size, sigma):
    w = torch.as_tensor(_gaussian_window_np(window_size, sigma),
                        device=img1.device)
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
