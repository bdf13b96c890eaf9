"""The work counts against frames counted by hand."""
from __future__ import annotations

import numpy as np
import pytest
import torch

from bench_port.gen.neuman_sequence import camera
from bench_port.work import blend, peaks, step

W, H = 32, 16      # two 16x16 tiles


def frame(depths, opacity):
    """Gaussians on the optical axis at `depths`, wide enough that each
    covers the whole frame at an alpha of about `opacity`."""
    n = len(depths)
    xyz = torch.tensor([[0.0, 0.0, d] for d in depths])
    scales = torch.full((n, 3), 40.0)
    rotq = torch.tensor([[1.0, 0, 0, 0]]).repeat(n, 1)
    op = torch.full((n,), opacity)
    shs = torch.zeros((n, 16, 3))
    return blend.blend_work(xyz, scales, rotq, op, shs, None,
                            camera(np.eye(4, dtype=np.float32), 0.9, "cpu"),
                            W, H, torch.ones(3), 0)


def test_one_gaussian_every_pixel_once():
    w = frame([3.0], 0.5)
    assert (w.tested, w.blended) == (W * H, W * H)
    assert (w.rows, w.instances, w.tiles, w.pixels) == (1, 2, 2, W * H)
    ops, nbytes = w.k1()
    assert ops == (22 + 12) * W * H
    assert nbytes == 1 * 40 + 2 * 4 + 2 * 8 + 12 + W * H * 16
    ops2, nbytes2 = w.k2()
    assert ops2 == (22 + 47) * W * H
    assert nbytes2 == 2 * 40 + 2 * 4 + 2 * 8 + 24 + W * H * 16


def test_transmittance_cutoff_stops_the_walk():
    """Four layers of alpha 0.97: transmittance before each is 1, 0.03,
    9e-4 and 2.7e-5 < 1e-4, so each pixel walks three pairs."""
    w = frame([2.0, 3.0, 4.0, 5.0], 0.97)
    assert (w.tested, w.blended) == (3 * W * H, 3 * W * H)
    assert (w.rows, w.instances) == (4, 8)


def test_behind_the_camera_is_no_work():
    w = frame([-3.0], 0.5)
    assert (w.tested, w.blended, w.rows, w.instances) == (0, 0, 0, 0)


def test_lpips_flops_by_hand():
    """VGG16's convolutions over one 16x16 patch: two at 16^2 (3 -> 64,
    64 -> 64), two at 8^2 (-> 128), three at 4^2 (-> 256), three at 2^2
    and three at 1^2 (-> 512), 2 x 9 x cin x cout a pixel."""
    want = 2 * 9 * (16 * 16 * (3 * 64 + 64 * 64)
                    + 8 * 8 * (64 * 128 + 128 * 128)
                    + 4 * 4 * (128 * 256 + 2 * 256 * 256)
                    + 2 * 2 * (256 * 512 + 2 * 512 * 512)
                    + 1 * 1 * (3 * 512 * 512))
    assert step.lpips_flops(1, 16) == want
    assert step.lpips_flops(4, 16) == 4 * want


def test_decoder_flops_per_row():
    """Appearance 96-64-64-(1, 48), geometry 96-128-128-(3, 6, 3),
    deformation 96-128-128-128-24: 2 x in x out a weight matrix."""
    mm, gather = step.decoder_flops_per_row(32)
    want = 2 * (96 * 64 + 64 * 64 + 64 * 1 + 64 * 48
                + 96 * 128 + 128 * 128 + 128 * (3 + 6 + 3)
                + 96 * 128 + 128 * 128 + 128 * 128 + 128 * 24)
    assert (mm, gather) == (want, 3 * 4 * 32 * 2)


def test_least_time_takes_the_larger_bound():
    assert peaks.least_s(989e12, 0, 0) == pytest.approx((1.0, "operations"))
    assert peaks.least_s(0, 67e12, 3.35e12 * 2) == pytest.approx(
        (2.0, "bytes"))
