"""hugs_tpu_torch scene model, kNN and PLY I/O against hugs_tpu and
numpy, and the slice as a whole: a JAX SceneGS converted to the port
renders the same image through the same entry points.

Tolerances: kNN indices exact and distances rtol 1e-6 (the exact
(a-b)^2 form in float32 against float64, and against hugs_tpu's knn),
exact on integer points, where ties are exact too; PLY round trip exact;
create_from_pcd parameters atol 1e-6; images atol 2e-5 (the render bar
of tests/test_pallas_blend.py).
"""
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hugs_tpu.models import scene_gs as jscene
from hugs_tpu.ops.knn import knn as jax_knn
from hugs_tpu.render import render_human_scene as jax_render_hs
from hugs_tpu.utils import ply as jply
from hugs_tpu_torch.convert import camera_from_numpy, scene_gs_from_numpy
from hugs_tpu_torch.models import scene_gs as tscene
from hugs_tpu_torch.ops.knn import knn, mean_sq_dist_to_knn
from hugs_tpu_torch.render import render_human_scene
from hugs_tpu_torch.utils import ply as tply
from test_torch_knn import tie_case
from torch_parity import H, W, cameras, np_of

ATOL = 2e-5


def _cloud(n, seed, center=(40.0, -25.0, 60.0)):
    rng = np.random.default_rng(seed)
    pts = (rng.normal(size=(n, 3)) * 0.5 + np.array(center)).astype(np.float32)
    return pts


def _knn_case(name):
    """(query, ref) as float32 numpy arrays: two clouds away from the
    origin, or test_torch_knn.tie_case's integer points (exact distances,
    many equal), or 300 query rows at one point (the avatar's dead rows
    at the origin) among a cloud's."""
    if name == "cloud":
        return _cloud(150, 1), _cloud(500, 0)
    if name == "coincident":
        query = np.concatenate([np.zeros((300, 3), np.float32),
                                _cloud(20, 4, center=(0.1, 0.2, 0.0))])
        return query, _cloud(400, 5, center=(0.0, 0.3, 0.1))
    return tuple(np_of(x) for x in tie_case(name))


@pytest.mark.parametrize("case,k", [
    pytest.param("cloud", 1, id="1"), pytest.param("cloud", 4, id="4"),
    ("duplicates", 6), ("sphere", 8), ("coincident", 6)])
def test_knn_matches_numpy(case, k):
    """Indices exact against numpy's stable sort in float64 and against
    hugs_tpu's knn: ascending distance, the lower index first on ties;
    coinciding query rows get one list."""
    query, ref = _knn_case(case)
    d, idx = knn(torch.as_tensor(query), torch.as_tensor(ref), k, chunk=64)
    full = ((query[:, None, :].astype(np.float64)
             - ref[None, :, :].astype(np.float64)) ** 2).sum(-1)
    want_idx = np.argsort(full, axis=1, kind="stable")[:, :k]
    np.testing.assert_array_equal(np_of(idx), want_idx)
    np.testing.assert_allclose(np_of(d),
                               np.take_along_axis(full, want_idx, 1),
                               rtol=1e-6)
    jd, jidx = jax_knn(jnp.asarray(query), jnp.asarray(ref), k, chunk=64)
    np.testing.assert_array_equal(np_of(idx), np.asarray(jidx))
    np.testing.assert_allclose(np_of(d), np.asarray(jd), rtol=1e-6)
    if case == "coincident":
        assert (np_of(idx)[:300] == np_of(idx)[0]).all()
    if case in ("duplicates", "sphere"):     # integer points: exact
        np.testing.assert_array_equal(np_of(d), np.asarray(jd))


def test_mean_sq_dist_to_knn_matches_numpy():
    pts = _cloud(400, 2)
    got = mean_sq_dist_to_knn(torch.as_tensor(pts), k=3, chunk=128)
    full = ((pts[:, None, :].astype(np.float64)
             - pts[None, :, :].astype(np.float64)) ** 2).sum(-1)
    want = np.sort(full, axis=1)[:, 1:4].mean(1)
    np.testing.assert_allclose(np_of(got), want, rtol=1e-6)


def _raw_params(n, seed):
    rng = np.random.default_rng(seed)
    return dict(
        xyz=rng.normal(size=(n, 3)).astype(np.float32),
        features_dc=rng.normal(size=(n, 1, 3)).astype(np.float32),
        features_rest=rng.normal(size=(n, 15, 3)).astype(np.float32),
        opacity=rng.normal(size=(n, 1)).astype(np.float32),
        scaling=rng.normal(size=(n, 3)).astype(np.float32),
        rotation=rng.normal(size=(n, 4)).astype(np.float32))


def test_ply_round_trip_exact(tmp_path):
    raw = _raw_params(37, 3)
    path = os.path.join(tmp_path, "scene.ply")
    tply.save_gaussian_ply(path, raw["xyz"], raw["features_dc"],
                           raw["features_rest"], raw["opacity"],
                           raw["scaling"], raw["rotation"])
    back = tply.load_gaussian_ply(path)
    for f, v in raw.items():
        np.testing.assert_array_equal(back[f], v, err_msg=f)
    # the JAX package reads the port's file identically
    jback = jply.load_gaussian_ply(path)
    for f, v in jback.items():
        np.testing.assert_array_equal(back[f], v, err_msg=f)


def _fields(gs_jax):
    return {f: np.asarray(getattr(gs_jax, f)) for f in gs_jax._fields}


def _assert_same_scene(gs_t, gs_j, atol=1e-6):
    for f in tscene.PARAM_FIELDS + tscene.BUFFER_FIELDS:
        np.testing.assert_allclose(np_of(getattr(gs_t, f)).astype(np.float64),
                                   np.asarray(getattr(gs_j, f), np.float64),
                                   atol=atol, err_msg=f)


@pytest.mark.parametrize("only_rgb", [False, True])
def test_create_from_pcd_matches(only_rgb):
    pts = _cloud(200, 4)
    cols = np.random.default_rng(5).uniform(size=(200, 3)).astype(np.float32)
    gj = jscene.create_from_pcd(jnp.asarray(pts), jnp.asarray(cols), 256,
                                only_rgb=only_rgb)
    gt = tscene.create_from_pcd(pts, cols, 256, only_rgb=only_rgb,
                                device="cpu")
    _assert_same_scene(gt, gj)
    assert isinstance(gt.xyz, torch.nn.Parameter)


def test_create_from_ply_and_compact_match(tmp_path):
    raw = _raw_params(150, 6)
    path = os.path.join(tmp_path, "scene.ply")
    tply.save_gaussian_ply(path, raw["xyz"], raw["features_dc"],
                           raw["features_rest"], raw["opacity"],
                           raw["scaling"], raw["rotation"])
    gj = jscene.create_from_ply(path, capacity=512)
    gt = tscene.create_from_ply(path, capacity=512, device="cpu")
    _assert_same_scene(gt, gj, atol=0.0)
    alive = np.random.default_rng(7).uniform(size=512) > 0.5
    gj = gj._replace(alive=jnp.asarray(alive))
    gt.alive.copy_(torch.as_tensor(alive))
    _assert_same_scene(tscene.compact(gt), jscene.compact(gj), atol=0.0)


def _jax_scene(seed, trained):
    """A JAX SceneGS from create_from_pcd; `trained` gives it the random
    SH rest, opacities and scales of a trained scene and SH degree 3."""
    rng = np.random.default_rng(seed)
    n = 250
    pts = rng.uniform(-1.0, 1.0, (n, 3)).astype(np.float32)
    pts[:, 2] = pts[:, 2] * 2.0 + 4.0
    cols = rng.uniform(size=(n, 3)).astype(np.float32)
    gs = jscene.create_from_pcd(jnp.asarray(pts), jnp.asarray(cols), 256)
    if trained:
        gs = gs._replace(
            features_rest=gs.features_rest.at[:n].set(
                jnp.asarray(rng.normal(size=(n, 15, 3)) * 0.3, jnp.float32)),
            opacity=gs.opacity.at[:n].set(
                jnp.asarray(rng.normal(size=(n, 1)), jnp.float32)),
            rotation=gs.rotation.at[:n].set(
                jnp.asarray(rng.normal(size=(n, 4)), jnp.float32)),
            scaling=gs.scaling.at[:n].add(
                jnp.asarray(rng.normal(size=(n, 3)) * 0.3, jnp.float32)),
            active_sh_degree=jnp.int32(3))
    return gs


@pytest.mark.parametrize("trained", [False, True])
def test_slice_scene_render_matches(trained):
    """The slice as a whole: hugs_tpu create_from_pcd -> scene_forward ->
    render_human_scene(render_mode="scene") against the port's converted
    scene through the same path."""
    gj = _jax_scene(8, trained)
    jc, _ = cameras()
    gt = scene_gs_from_numpy(_fields(gj), device="cpu")
    tc = camera_from_numpy({f: np.asarray(getattr(jc, f))
                            for f in jc._fields}, device="cpu")
    bg = (0.2, 0.3, 0.4)
    ref = jax_render_hs({"camera": jc, "width": W, "height": H}, None,
                        jscene.scene_forward(gj), jnp.asarray(bg),
                        render_mode="scene", backend="tiled",
                        tile_cap=2048, instance_budget=8192)
    out = render_human_scene({"camera": tc, "width": W, "height": H}, None,
                             gt(), torch.tensor(bg), render_mode="scene",
                             instance_budget=8192)
    img = np_of(out["render"])
    assert img.shape == (3, H, W) and np.isfinite(img).all()
    assert img.std() > 0.01
    np.testing.assert_allclose(img, np_of(ref["render"]), atol=ATOL)
    for key in ("scene_visibility_filter", "scene_radii"):
        np.testing.assert_array_equal(np_of(out[key]), np_of(ref[key]))
    assert int(out["n_slots"]) == int(ref["n_slots"])


def test_human_scene_merge_matches():
    """human_scene mode: the human set first, then the scene, one blend;
    the per-set slices of radii and visibility come back."""
    gh, gs = _jax_scene(9, True), _jax_scene(10, True)
    jc, tc = cameras()
    bg = (0.1, 0.1, 0.1)
    ref = jax_render_hs({"camera": jc, "width": W, "height": H},
                        jscene.scene_forward(gh), jscene.scene_forward(gs),
                        jnp.asarray(bg), backend="tiled", tile_cap=2048,
                        instance_budget=16384, render_human_separate=True)
    th = scene_gs_from_numpy(_fields(gh), device="cpu")
    ts = scene_gs_from_numpy(_fields(gs), device="cpu")
    out = render_human_scene({"camera": tc, "width": W, "height": H},
                             th(), ts(), torch.tensor(bg),
                             instance_budget=16384,
                             render_human_separate=True)
    for key in ("render", "human_img"):
        np.testing.assert_allclose(np_of(out[key]), np_of(ref[key]),
                                   atol=ATOL, err_msg=key)
    for key in ("human_radii", "scene_radii", "human_visibility_filter",
                "scene_visibility_filter"):
        np.testing.assert_array_equal(np_of(out[key]), np_of(ref[key]),
                                      err_msg=key)
