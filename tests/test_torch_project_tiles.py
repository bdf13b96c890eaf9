"""hugs_tpu_torch projection and tile binning against hugs_tpu.

Projection: float fields rtol 1e-5 and atol 1e-5 (the same float32
expressions in the same order; only transcendental last bits differ),
radius and mask exact. Binning: identical per-tile instance lists in
identical depth order, and identical n_instances, n_slots and overflowed.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hugs_tpu.render.project import project_gaussians as jax_project
from hugs_tpu.render.tiles import bin_gaussians as jax_bin
from hugs_tpu_torch.render.project import project_gaussians, update_mean2d
from hugs_tpu_torch.render.tiles import bin_gaussians
from torch_parity import (
    H, W, cameras, make_saturating_scene, make_scene, np_of, to_jax,
    to_torch,
)


def _project_both(scene, active=3, alive=None, scaling_modifier=1.0):
    jc, tc = cameras()
    js, ts = to_jax(scene), to_torch(scene)
    args = ("means", "scales", "rotq", "opacity", "shs")
    pj = jax_project(*(js[a] for a in args), jc, W, H, active,
                     scaling_modifier,
                     alive=None if alive is None else jnp.asarray(alive))
    pt = project_gaussians(*(ts[a] for a in args), tc, W, H, active,
                           scaling_modifier,
                           alive=None if alive is None
                           else torch.as_tensor(alive))
    return pj, pt


@pytest.mark.parametrize("seed,active,modifier,with_alive", [
    (0, 3, 1.0, False), (1, 1, 0.7, True), (2, 0, 1.3, False)])
def test_project_matches(seed, active, modifier, with_alive):
    scene = make_scene(n=300, seed=seed)
    # push some Gaussians behind the near plane so the cull is exercised
    scene["means"][:20, 2] = np.linspace(-1.0, 0.3, 20)
    alive = None
    if with_alive:
        alive = np.random.default_rng(seed).uniform(size=300) > 0.2
    pj, pt = _project_both(scene, active, alive, modifier)
    for f in ("mean2d", "conic", "depth", "rgb", "opacity"):
        np.testing.assert_allclose(np_of(getattr(pt, f)),
                                   np_of(getattr(pj, f)),
                                   rtol=1e-5, atol=1e-5, err_msg=f)
    np.testing.assert_array_equal(np_of(pt.radius), np_of(pj.radius))
    np.testing.assert_array_equal(np_of(pt.mask), np_of(pj.mask))
    assert 0 < int(pt.mask.sum()) < 300


def test_update_mean2d_shifts_means():
    pj, pt = _project_both(make_scene(n=50))
    delta = torch.full((50, 2), 0.25)
    out = update_mean2d(pt, delta)
    np.testing.assert_array_equal(np_of(out.mean2d), np_of(pt.mean2d + 0.25))


def _tile_lists(bins):
    gid = np_of(bins.gauss_id)
    return [gid[s:e].tolist()
            for s, e in zip(np_of(bins.starts), np_of(bins.ends))]


@pytest.mark.parametrize("scene_name,budget,align", [
    ("random", 8192, 1),
    ("random", 8192, 128),
    ("saturating", 16384, 1),
    ("saturating", 16384, 128),
    ("random", 300, 1),        # overflows: later instances dropped
    ("random", 1024, 128),     # overflows through alignment padding
])
def test_bin_matches(scene_name, budget, align):
    scene = (make_scene(n=300, seed=4) if scene_name == "random"
             else make_saturating_scene())
    pj, pt = _project_both(scene)
    bj = jax_bin(pj, W, H, budget, 16, tight_cull=True, align=align)
    bt = bin_gaussians(pt, W, H, budget, 16, align=align)
    assert _tile_lists(bt) == _tile_lists(bj)
    np.testing.assert_array_equal(np_of(bt.starts), np_of(bj.starts))
    np.testing.assert_array_equal(np_of(bt.ends), np_of(bj.ends))
    for f in ("n_instances", "n_slots", "overflowed", "aligned_total"):
        assert int(getattr(bt, f)) == int(getattr(bj, f)), f
    overflow_expected = budget < 2048
    assert bool(bt.overflowed) == overflow_expected
    # each list is front to back
    depth = np_of(pt.depth)
    for lst in _tile_lists(bt):
        assert (np.diff(depth[lst]) >= 0).all()
