"""LPIPS perceptual distance on a VGG16 feature backbone, plain PyTorch.

The published LPIPS design (Zhang et al. 2018): the input rescaled to
[-1, 1] and ImageNet-normalised, VGG16 conv features at 5 taps (the end
of each block), each feature map unit-normalised over channels, the
squared difference weighted by a 1x1 linear head per tap, averaged over
space and summed over taps.

Weights: `LPIPS.create` loads an .npz (13 convs `conv_{i}_w` in HWIO,
`conv_{i}_b`, 5 heads `lin_{t}`, the layout of the JAX package's
converter) if one exists at `weights_path`; otherwise it draws
He-initialised convs and uniform heads from a seeded generator. Random
features still give a multi-scale perceptual distance, but its values
are comparable to published LPIPS only with real weights.

The convs run in float32 with TF32 off, whatever the caller's global
setting (losses/basic.py::no_tf32_convs). The weights are buffers: the
loss trains the image, not the network.
"""
from __future__ import annotations

import os

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from bench_port.reference.plain.losses.basic import no_tf32_convs

# VGG16's features up to conv5_3: (out_channels, convs) per block
VGG_BLOCKS = ((64, 2), (128, 2), (256, 3), (512, 3), (512, 3))
N_CONVS = sum(n for _, n in VGG_BLOCKS)
_SHIFT = (-0.030, -0.088, -0.188)
_SCALE = (0.458, 0.448, 0.450)


class LPIPS(nn.Module):
    """conv_{i}_w (cout, cin, 3, 3), conv_{i}_b (cout,) for the 13 convs,
    lin_{t} (c_t,) for the 5 taps, all buffers."""

    def __init__(self, conv_weights, conv_biases, lin_weights,
                 has_pretrained: bool):
        super().__init__()
        for i, (w, b) in enumerate(zip(conv_weights, conv_biases)):
            self.register_buffer(f"conv_{i}_w", w)
            self.register_buffer(f"conv_{i}_b", b)
        for t, w in enumerate(lin_weights):
            self.register_buffer(f"lin_{t}", w)
        self.register_buffer("shift", torch.tensor(_SHIFT).reshape(1, 3, 1, 1)
                             .to(conv_weights[0].device))
        self.register_buffer("scale", torch.tensor(_SCALE).reshape(1, 3, 1, 1)
                             .to(conv_weights[0].device))
        self.has_pretrained = has_pretrained

    @classmethod
    def from_arrays(cls, arrays, has_pretrained: bool = True,
                    device: torch.device | str = "cuda") -> "LPIPS":
        """From numpy arrays in the .npz layout: conv weights HWIO
        (3, 3, cin, cout), transposed here to torch's OIHW."""
        def f32(a):
            return torch.as_tensor(np.array(a, np.float32), device=device)
        return cls([f32(arrays[f"conv_{i}_w"]).permute(3, 2, 0, 1)
                    .contiguous() for i in range(N_CONVS)],
                   [f32(arrays[f"conv_{i}_b"]) for i in range(N_CONVS)],
                   [f32(arrays[f"lin_{t}"]) for t in range(len(VGG_BLOCKS))],
                   has_pretrained)

    @classmethod
    def create(cls, weights_path: str | None = None, seed: int = 0,
               device: torch.device | str = "cuda") -> "LPIPS":
        """Pretrained weights from `weights_path` if that file exists,
        else He-initialised convs (drawn on the CPU from `seed`) and
        uniform heads 1 / c_t."""
        if weights_path and os.path.exists(weights_path):
            with np.load(weights_path) as z:
                return cls.from_arrays(dict(z), True, device)
        gen = torch.Generator().manual_seed(seed)
        conv_w, conv_b, lin_w = [], [], []
        cin = 3
        for cout, n in VGG_BLOCKS:
            for _ in range(n):
                std = float(np.sqrt(2.0 / (3 * 3 * cin)))
                conv_w.append((torch.randn((cout, cin, 3, 3), generator=gen)
                               * std).to(device))
                conv_b.append(torch.zeros(cout, device=device))
                cin = cout
            lin_w.append(torch.full((cout,), 1.0 / cout, device=device))
        return cls(conv_w, conv_b, lin_w, False)

    def _conv(self, i: int, x: torch.Tensor) -> torch.Tensor:
        """Conv i, 3x3 zero-padded, with its bias added after the sum (the
        JAX package's order), before the ReLU."""
        y = F.conv2d(x, getattr(self, f"conv_{i}_w"), padding=1)
        return y + getattr(self, f"conv_{i}_b")[None, :, None, None]

    def _normalise(self, img: torch.Tensor) -> torch.Tensor:
        return (img * 2.0 - 1.0 - self.shift) / self.scale

    def features(self, img: torch.Tensor) -> list:
        """img (N, 3, H, W) in [0, 1] -> the 5 taps' features, NCHW."""
        x = self._normalise(img)
        taps, ci = [], 0
        with no_tf32_convs():
            for b, (_, n) in enumerate(VGG_BLOCKS):
                if b > 0:
                    x = F.max_pool2d(x, 2, 2)     # VALID: odd edges dropped
                for _ in range(n):
                    x = torch.relu(self._conv(ci, x))
                    ci += 1
                taps.append(x)
        return taps

    @staticmethod
    def _unit(a: torch.Tensor) -> torch.Tensor:
        return a / torch.sqrt(torch.sum(a * a, dim=1, keepdim=True) + 1e-10)

    def forward(self, img1: torch.Tensor, img2: torch.Tensor) -> torch.Tensor:
        """(N, 3, H, W) x 2 -> (N,) LPIPS distances ((3, H, W) -> (1,))."""
        if img1.dim() == 3:
            img1, img2 = img1[None], img2[None]
        total = 0.0
        for t, (a, b) in enumerate(zip(self.features(img1),
                                       self.features(img2))):
            d = (self._unit(a) - self._unit(b)) ** 2
            w = getattr(self, f"lin_{t}")[None, :, None, None]
            total = total + torch.mean(torch.sum(d * w, dim=1), dim=(1, 2))
        return total

    def _masked_features(self, img: torch.Tensor, h, w) -> list:
        """The features of the (h, w) crop at the origin of a fixed
        (H, W) canvas, exactly as if the network ran on the crop alone:
        after every conv the canvas beyond the crop's extent is zeroed
        again (a bias makes the zeros nonzero, which the next conv would
        carry across the crop's edge, where the crop's own padding has
        zeros), and the extent follows the VALID pool (h -> h // 2).
        Returns [(tap, h_t, w_t), ...]."""
        x = self._normalise(img)
        h = torch.as_tensor(h, dtype=torch.int64, device=img.device)
        w = torch.as_tensor(w, dtype=torch.int64, device=img.device)
        taps, ci = [], 0
        with no_tf32_convs():
            for b, (_, n) in enumerate(VGG_BLOCKS):
                if b > 0:
                    x = F.max_pool2d(x, 2, 2)
                    h, w = h // 2, w // 2
                rows = torch.arange(x.shape[2], device=x.device) \
                    [None, None, :, None] < h
                cols = torch.arange(x.shape[3], device=x.device) \
                    [None, None, None, :] < w
                valid = rows & cols
                # an odd extent leaves max(crop row, 0) in the row past the
                # new extent after the pool; the crop has no such row
                x = torch.where(valid, x, 0.0)
                for _ in range(n):
                    x = torch.where(valid, torch.relu(self._conv(ci, x)), 0.0)
                    ci += 1
                taps.append((x, h, w))
        return taps

    def crop_call(self, img1: torch.Tensor, img2: torch.Tensor, h,
                  w) -> torch.Tensor:
        """The exact LPIPS of the (h, w) crops at the origin of fixed
        (N, 3, H, W) canvases: __call__ on the cropped arrays, with the
        spatial means over each tap's valid extent."""
        if img1.dim() == 3:
            img1, img2 = img1[None], img2[None]
        total = 0.0
        for t, ((a, ht, wt), (b, _, _)) in enumerate(zip(
                self._masked_features(img1, h, w),
                self._masked_features(img2, h, w))):
            # both features are 0 outside the crop, so d is 0 there and a
            # plain sum over (ht * wt) is the crop's mean
            d = (self._unit(a) - self._unit(b)) ** 2
            wgt = getattr(self, f"lin_{t}")[None, :, None, None]
            s = torch.sum(torch.sum(d * wgt, dim=1), dim=(1, 2))
            total = total + s / torch.clamp((ht * wt).to(torch.float32),
                                            min=1.0)
        return total
