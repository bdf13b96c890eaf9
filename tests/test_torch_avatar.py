"""The avatar serving frame as a whole: a JAX avatar and scene converted to
the port render the same image through the same entry points
(canon_forward -> compact_for_inference -> human_forward with the cached
decode -> render_human_scene(render_mode="human_scene")), and the card
computes what the CPU computes.

Tolerances: images atol 2e-5 (the render bar of
tests/test_pallas_blend.py) against the JAX package's `tiled` backend
and its Pallas kernel in interpret mode; the visibility and radii slices
exact; the compacted frame against the uncompacted one atol 1e-6;
human_forward on the card against the CPU atol 1e-5.

The JAX side is imported inside the CPU tests, so that the file
collects where flax, which hugs_tpu's models need, is not installed.
"""
import numpy as np
import pytest
import torch

from hugs_tpu_torch.data.cameras import get_rotating_camera
from hugs_tpu_torch.models import human_gs as th
from hugs_tpu_torch.models.scene_gs import create_from_pcd, scene_forward
from hugs_tpu_torch.models.smpl import synthetic_smpl
from hugs_tpu_torch.render import render_human_scene
from torch_parity import (  # noqa: F401 (cuda_device: a fixture)
    cuda_device, human_to_torch, jax_human, np_of,
)

W, H = 64, 48
ATOL = 2e-5
BG = (0.1, 0.2, 0.3)


def _pose(seed):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=69) * 0.3).astype(np.float32), \
        (rng.normal(size=3) * 0.2).astype(np.float32)


def _scene_points(n, seed):
    """Points around and behind the avatar, seen by the orbit's first
    camera (at z = 3, looking down -z)."""
    rng = np.random.default_rng(seed)
    pts = rng.uniform((-1.5, -1.0, -2.0), (1.5, 1.0, 1.0), (n, 3))
    return pts.astype(np.float32), rng.uniform(size=(n, 3)).astype(np.float32)


def _jax_scene(seed):
    """A JAX scene from create_from_pcd given trained-looking SH rest,
    opacities and SH degree 3."""
    import jax.numpy as jnp
    from hugs_tpu.models import scene_gs as jscene
    pts, cols = _scene_points(200, seed)
    gs = jscene.create_from_pcd(jnp.asarray(pts), jnp.asarray(cols), 256)
    rng = np.random.default_rng(seed + 1)
    return gs._replace(
        features_rest=gs.features_rest.at[:200].set(
            jnp.asarray(rng.normal(size=(200, 15, 3)) * 0.3, jnp.float32)),
        opacity=gs.opacity.at[:200].set(
            jnp.asarray(rng.normal(size=(200, 1)), jnp.float32)),
        active_sh_degree=jnp.int32(3))


@pytest.mark.parametrize("backend", ["tiled", "pallas"])
def test_avatar_frame_matches_jax(backend):
    """The slice: a JAX avatar (with dead rows) and scene, converted; both
    packages decode, compact, skin at a new pose and render the merged
    set at the human's SH degree (0; the scene's is 3). Image atol 2e-5
    against the JAX `tiled` backend or its Pallas kernel (interpret
    mode); human and scene visibility and radii equal."""
    import jax.numpy as jnp
    from hugs_tpu.data.cameras import get_rotating_camera as jax_cameras
    from hugs_tpu.models import human_gs as jh
    from hugs_tpu.models import scene_gs as jscene
    from hugs_tpu.render import render_human_scene as jax_render_hs
    from hugs_tpu_torch.convert import camera_from_numpy, scene_gs_from_numpy

    cfg, smpl, params, state, fixed, _ = jax_human(vpb=12, capacity=384,
                                                   seed=11)
    alive = np.asarray(state.alive) & (
        np.random.default_rng(12).uniform(size=384) > 0.2)
    state = state._replace(alive=jnp.asarray(alive))
    tcfg, tparams, tstate, tfixed = human_to_torch(cfg, smpl, params, state)
    gs = _jax_scene(13)
    tgs = scene_gs_from_numpy({f: np.asarray(getattr(gs, f))
                               for f in gs._fields}, device="cpu")
    jcam = jax_cameras(img_size=(H, W), fov=0.95, dist=3.0, nframes=2)[0]
    tcam = get_rotating_camera(img_size=(H, W), fov=0.95, dist=3.0,
                               nframes=2, device="cpu")[0]
    np.testing.assert_allclose(
        np_of(tcam["camera"].full_proj),
        np.asarray(jcam["camera"].full_proj), atol=1e-6)
    tcam["camera"] = camera_from_numpy(
        {f: np.asarray(getattr(jcam["camera"], f))
         for f in jcam["camera"]._fields}, device="cpu")
    pose, orient = _pose(14)
    kw = dict(compute_gt_lbs=False)

    jp, js, jc = jh.compact_for_inference(
        params, state, jh.canon_forward(params, state, cfg), bucket=320)
    j_out = jh.human_forward(jp, js, fixed, cfg, global_orient=jnp.asarray(
        orient), body_pose=jnp.asarray(pose), betas=jp.betas,
        transl=jnp.zeros(3), smpl_scale=jnp.float32(1.0), canon_out=jc,
        **kw)
    ref = jax_render_hs(jcam, j_out, jscene.scene_forward(gs),
                        jnp.asarray(BG), render_mode="human_scene",
                        backend=backend, instance_budget=32768,
                        **({"tile_cap": 2048} if backend == "tiled" else {}))

    tp, ts, tc = th.compact_for_inference(
        tparams, tstate, th.canon_forward(tparams, tstate, tcfg), bucket=320)
    t_out = th.human_forward(
        tp, ts, tfixed, tcfg, global_orient=torch.as_tensor(orient),
        body_pose=torch.as_tensor(pose), betas=tp.betas,
        transl=torch.zeros(3), smpl_scale=torch.tensor(1.0), canon_out=tc,
        **kw)
    out = render_human_scene(tcam, t_out, tgs(), torch.tensor(BG),
                             render_mode="human_scene",
                             instance_budget=32768)
    img = np_of(out["render"])
    assert img.shape == (3, H, W) and np.isfinite(img).all()
    # the avatar is in the picture: its visible Gaussians changed pixels
    assert int(out["human_visibility_filter"].sum()) > 100
    np.testing.assert_allclose(img, np_of(ref["render"]), atol=ATOL)
    for key in ("human_visibility_filter", "scene_visibility_filter",
                "human_radii", "scene_radii"):
        np.testing.assert_array_equal(np_of(out[key]), np_of(ref[key]),
                                      err_msg=key)
    assert not bool(out["overflowed"])


def _port_avatar(capacity=448, seed=15):
    """A port-only avatar on the CPU (no JAX): synthetic body, nets from a
    seeded generator, a third of the alive rows killed."""
    smpl = synthetic_smpl(12, device="cpu")
    cfg = th.HumanGSConfig(n_features=8, triplane_res=32)
    params, state, fixed, _ = th.init_human_gs(
        torch.Generator().manual_seed(seed), cfg, smpl, smpl,
        np.zeros(10, np.float32), n_frames=1, capacity=capacity)
    keep = torch.as_tensor(np.random.default_rng(seed).uniform(
        size=capacity) > 0.33)
    state = state._replace(alive=state.alive & keep)
    return cfg, params, state, fixed


def _frame(cfg, params, state, fixed, device, compacted):
    pose, orient = _pose(16)
    canon = th.canon_forward(params, state, cfg)
    if compacted:
        params, state, canon = th.compact_for_inference(params, state, canon)
    h_out = th.human_forward(
        params, state, fixed, cfg,
        global_orient=torch.as_tensor(orient, device=device),
        body_pose=torch.as_tensor(pose, device=device),
        transl=torch.zeros(3, device=device), canon_out=canon,
        compute_gt_lbs=False)
    pts, cols = _scene_points(150, 17)
    s_out = scene_forward(create_from_pcd(pts, cols, 160, device=device))
    cam = get_rotating_camera(img_size=(H, W), fov=0.95, dist=3.0,
                              nframes=2, device=device)[0]
    pkg = render_human_scene(cam, h_out, s_out,
                             torch.tensor(BG, device=device),
                             instance_budget=32768)
    return h_out, pkg


def test_compacted_frame_equals_uncompacted():
    """Dead rows render nothing: the frame of the compacted avatar (pad
    rows at row 0's position, alive False) equals the frame of the
    uncompacted one, atol 1e-6, and the live rows' skinned positions
    agree atol 1e-6."""
    cfg, params, state, fixed = _port_avatar()
    h_full, full = _frame(cfg, params, state, fixed, "cpu", compacted=False)
    h_comp, comp = _frame(cfg, params, state, fixed, "cpu", compacted=True)
    live = state.alive
    n = int(live.sum())
    assert h_comp["xyz"].shape[0] == 256 and n < 448 * 0.7
    np.testing.assert_allclose(np_of(h_comp["xyz"][:n]),
                               np_of(h_full["xyz"][live]), atol=1e-6)
    assert not bool(h_comp["alive"][n:].any())
    np.testing.assert_allclose(np_of(comp["render"]), np_of(full["render"]),
                               atol=1e-6)
    assert int(comp["human_visibility_filter"].sum()) == int(
        full["human_visibility_filter"].sum()) > 50
    np.testing.assert_array_equal(np_of(comp["scene_radii"]),
                                  np_of(full["scene_radii"]))


@pytest.mark.cuda
def test_human_forward_on_card_matches_cpu(cuda_device):
    """human_forward on the card equals the same call on the CPU, both
    skinning paths: every output key atol 1e-5; then the merged frame
    through K1 against the CPU's plain blend, atol 2e-5."""
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg, params, state, fixed = _port_avatar()
    card = [th.to_device(x, cuda_device) for x in (params, state, fixed)]
    for use_deformer in (True, False):
        c = cfg._replace(use_deformer=use_deformer)
        pose, orient = _pose(18)
        kw = dict(global_orient=torch.as_tensor(orient),
                  body_pose=torch.as_tensor(pose),
                  smpl_scale=torch.tensor(1.1))
        want = th.human_forward(params, state, fixed, c, **kw)
        got = th.human_forward(*card, c, **th.to_device(kw, cuda_device))
        for k, v in want.items():
            if v is None:
                assert got[k] is None, k
            else:
                np.testing.assert_allclose(
                    np_of(got[k]).astype(np.float64),
                    np_of(v).astype(np.float64), atol=1e-5, err_msg=k)
    _, want = _frame(cfg, params, state, fixed, "cpu", compacted=True)
    _, got = _frame(cfg, *card, cuda_device, compacted=True)
    np.testing.assert_allclose(np_of(got["render"]), np_of(want["render"]),
                               atol=ATOL)
