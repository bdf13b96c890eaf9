"""hugs_tpu_torch/micro/kernel_parity.py: the edge-case scenes of
scripts/kernel_parity_tpu.py, on the CPU.

- Each scene (multichunk_empty, saturating, tile16, tight_budget), drawn
  by the module with numpy, through the port's render path (projection,
  binning at the case's budget, the plain blend: what K1 and K2 are held
  to on the card) against hugs_tpu's `tiled` backend on the same arrays
  (16-px tiles, its tile cap at the densest tile's count, so nothing is
  truncated): the image atol 2e-5, the gradients of the L1 loss against
  the case's target with respect to means, scales, rotations, opacities
  and SH atol 1e-6 + rtol 1e-4 (the render's bars,
  tests/test_pallas_blend.py).
- tight_budget's budget is its exact slot demand (every span slot of
  the binning, before the tight cull): it fits, and one slot less
  overflows.
- The entry point on the CPU: one JSON line per case in the script's
  keys, PASS, exit 0 and the record written; 2 without a card.
"""
import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hugs_tpu_torch.micro import kernel_parity as kp
from hugs_tpu_torch.render.tiles import TILE, bin_gaussians
from torch_parity import few_threads, np_of  # noqa: F401 (autouse)

IMG_ATOL = 2e-5
GRAD_ATOL, GRAD_RTOL = 1e-6, 1e-4


def _port(name):
    """The port's image and gradients of a case on the CPU, and its
    binning's record."""
    inp, leaves, _, pg, bins, budget = kp.case_bins(name, "cpu")
    feat = kp.gauss_features(pg)
    img = kp.cuda_blend.blend_feat(
        feat, bins.gauss_id, bins.starts, bins.ends,
        torch.as_tensor(inp["bg"]), inp["W"], inp["H"])
    grads = kp._grads(img, torch.as_tensor(inp["target"]), leaves)
    return np_of(img), [np_of(g) for g in grads], kp.chunk_stats(bins), \
        budget


@functools.lru_cache(maxsize=None)
def _jax(name, budget, tile_cap):
    """hugs_tpu's tiled render of the same arrays and its gradients."""
    from hugs_tpu.render import make_camera, render
    inp = kp.case_inputs(name)
    cam = make_camera(jnp.asarray(inp["R"]), jnp.asarray(inp["t"]),
                      inp["fovx"], inp["fovy"])
    target = jnp.asarray(inp["target"])

    def loss(*a):
        pkg = render(*a, camera=cam, width=inp["W"], height=inp["H"],
                     bg=jnp.asarray(inp["bg"]), active_sh_degree=3,
                     instance_budget=budget, backend="tiled", tile=TILE,
                     tile_cap=tile_cap)
        return jnp.mean(jnp.abs(pkg["render"] - target)), pkg

    f = jax.jit(jax.value_and_grad(loss, argnums=(0, 1, 2, 3, 4),
                                   has_aux=True))
    (_, pkg), grads = f(*(jnp.asarray(inp["scene"][k]) for k in kp.PARAMS))
    assert not bool(pkg["overflowed"])
    return np.asarray(pkg["render"]), [np.asarray(g) for g in grads]


@pytest.mark.parametrize("name", list(kp.CASES))
def test_scene_matches_jax_tiled(name):
    img, grads, stats, budget = _port(name)
    assert not stats["overflowed"]
    want_img, want_grads = _jax(name, budget,
                                stats["max_instances_per_tile"])
    np.testing.assert_allclose(img, want_img, atol=IMG_ATOL)
    for k, got, want in zip(kp.PARAMS, grads, want_grads):
        assert np.abs(want).max() > 0, k
        np.testing.assert_allclose(got, want, atol=GRAD_ATOL,
                                   rtol=GRAD_RTOL, err_msg=k)
    if name == "multichunk_empty":      # several of K1's batches, and
        assert stats["max_chunks_per_tile"] > 2     # empty tiles
        assert stats["empty_tiles"] > 0


def test_tight_budget_is_the_exact_demand():
    _, _, _, pg, bins, budget = kp.case_bins("tight_budget", "cpu")
    # the demand counts every (Gaussian, tile) span slot before the
    # tight cull drops some: all fit, and one slot less overflows
    assert budget == int(bins.n_slots) == int(bins.n_instances)
    assert not bool(bins.overflowed)
    assert 0 < int(bins.ends.max()) <= budget
    assert bool(bin_gaussians(pg, 96, 64, budget - 1, TILE).overflowed)


def test_entry_point_on_cpu(tmp_path, capsys):
    out = tmp_path / "kp.json"
    assert kp.main(["--device", "cpu", "--out", str(out)]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[-1] == "PASS"
    cases = [json.loads(line) for line in lines[:-1]]
    assert [c["case"] for c in cases] == list(kp.CASES)
    for c in cases:
        assert {"case", "W", "H", "n", "n_instances", "max_chunks_per_tile",
                "max_abs_dimg", "rel_dgrad"} <= set(c)
        assert c["max_abs_dimg"] == 0.0 and c["ok"]     # plain vs plain
    assert json.loads(out.read_text())["pass"] is True
    if not torch.cuda.is_available():
        assert kp.main(["--out", str(out)]) == 2
