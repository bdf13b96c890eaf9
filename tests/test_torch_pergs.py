"""The port's per-Gaussian avatar (hugs_tpu_torch/models/human_gs_pergs.py,
the no-triplane ablation) against hugs_tpu/models/human_gs_pergs.py, and
graft_entry.entry()'s frame (ROADMAP Slice F items 7 and 8), on the CPU.

- init_human_pergs' fields (betas drawn from a seed, capacity 512, 3
  frames, initial poses) and human_pergs_forward's outputs on hugs_tpu's
  parameters carried across (convert.human_pergs_from_numpy, the pose
  tables and the Gaussians perturbed from a seed): the learned pose with
  ext_tfs, an explicit pose with smpl_scale, isotropic; every output at
  human_forward's bar, atol 1e-5.
- compact_for_inference keeps the live rows' forward.
- The densify reuses the scene's machinery: scene_densify_step on the
  block, fed hugs_tpu's split noise, gives hugs_tpu's counts and rows.
- The rendered image changes with the pose (K1 on the card, the plain
  blend here).
- entry()'s fn gives a finite (3, 270, 480) frame.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hugs_tpu_torch import convert
from hugs_tpu_torch.models import human_gs_pergs as tp
from hugs_tpu_torch.render.renderer import render
from torch_parity import cameras, np_of, smpl_arrays

ATOL = 1e-5
CAP = 512
N_FRAMES = 3
OUT_KEYS = ("xyz", "xyz_canon", "xyz_offsets", "scales", "scales_canon",
            "rotq", "rotq_canon", "rotmat", "rotmat_canon", "shs", "opacity",
            "normals", "normals_canon", "active_sh_degree", "alive")


def _close(got, want, err_msg=""):
    np.testing.assert_allclose(np_of(got).astype(np.float64),
                               np.asarray(want).astype(np.float64),
                               atol=ATOL, err_msg=err_msg)


def _pergs_numpy(params) -> dict:
    gs = params.gs
    return {"gs": {f: np.asarray(getattr(gs, f)) for f in gs._fields},
            **{f: np.asarray(getattr(params, f))
               for f in ("global_orient", "body_pose", "transl", "betas")}}


@functools.lru_cache(maxsize=None)
def _jax_case():
    """hugs_tpu's avatar on synthetic_smpl(12) with initial poses, and a
    trained-looking copy: the pose tables and the Gaussians perturbed
    from a seed."""
    from hugs_tpu.models import human_gs_pergs as jp
    from hugs_tpu.models.smpl import synthetic_smpl
    rng = np.random.default_rng(4)
    smpl = synthetic_smpl(verts_per_bone=12)
    betas = (rng.normal(size=10) * 0.5).astype(np.float32)
    poses = dict(
        init_body_pose=(rng.normal(size=(N_FRAMES, 69)) * 0.2).astype(
            np.float32),
        init_global_orient=(rng.normal(size=(N_FRAMES, 3)) * 0.2).astype(
            np.float32),
        init_transl=(rng.normal(size=(N_FRAMES, 3)) * 0.1).astype(
            np.float32))
    params, fixed = jp.init_human_pergs(
        smpl, smpl, jnp.asarray(betas), N_FRAMES, capacity=CAP,
        max_sh_degree=3, **{k: jnp.asarray(v) for k, v in poses.items()})
    n = smpl.n_verts
    gs = params.gs
    trained = params._replace(gs=gs._replace(
        xyz=gs.xyz + jnp.asarray(rng.normal(size=(CAP, 3)) * 0.01,
                                 jnp.float32),
        features_rest=jnp.asarray(rng.normal(size=gs.features_rest.shape)
                                  * 0.1, jnp.float32),
        scaling=gs.scaling + jnp.asarray(rng.normal(size=(CAP, 3)) * 0.2,
                                         jnp.float32),
        rotation=gs.rotation.at[:n].add(jnp.asarray(
            rng.normal(size=(n, 4)) * 0.2, jnp.float32)),
        active_sh_degree=jnp.int32(2)))
    return smpl, betas, poses, params, fixed, trained


def _port(params, smpl):
    tsmpl = convert.smpl_model_from_numpy(smpl_arrays(smpl), "cpu")
    tparams = convert.human_pergs_from_numpy(_pergs_numpy(params), "cpu")
    from hugs_tpu_torch.models.human_gs import compute_vitruvian
    return tparams, compute_vitruvian(tsmpl, tparams.betas)


def test_init_matches_jax():
    smpl, betas, poses, params, _, _ = _jax_case()
    tsmpl = convert.smpl_model_from_numpy(smpl_arrays(smpl), "cpu")
    got, _ = tp.init_human_pergs(tsmpl, tsmpl, betas, N_FRAMES,
                                 capacity=CAP, **poses)
    assert int(got.gs.n_alive) == smpl.n_verts
    for f in params.gs._fields:
        want = np.asarray(getattr(params.gs, f))
        if want.dtype == bool or f == "active_sh_degree":
            np.testing.assert_array_equal(np_of(getattr(got.gs, f)), want,
                                          err_msg=f)
        else:
            _close(getattr(got.gs, f), want, err_msg=f)
    for f in ("global_orient", "body_pose", "transl", "betas"):
        _close(getattr(got, f), getattr(params, f), err_msg=f)


@pytest.mark.parametrize("call", ["learned_ext", "explicit", "isotropic"])
def test_forward_matches_jax(call):
    from hugs_tpu.models import human_gs_pergs as jp
    from hugs_tpu.ops.rotations import axis_angle_to_matrix
    smpl, _, _, _, fixed, params = _jax_case()
    tparams, tfixed = _port(params, smpl)
    rng = np.random.default_rng(8)
    if call == "learned_ext":
        rot = np.asarray(axis_angle_to_matrix(jnp.array([0.1, 0.5, -0.2])))
        ext = (np.array([0.3, -0.1, 2.0], np.float32), rot,
               np.float32(1.3))
        jkw = dict(dataset_idx=2, ext_tfs=tuple(jnp.asarray(x)
                                                for x in ext))
        tkw = dict(dataset_idx=2, ext_tfs=tuple(torch.tensor(x)
                                                for x in ext))
    else:
        pose = {"global_orient": rng.normal(size=3) * 0.3,
                "body_pose": rng.normal(size=69) * 0.3,
                "betas": rng.normal(size=10) * 0.5,
                "transl": rng.normal(size=3) * 0.2}
        pose = {k: v.astype(np.float32) for k, v in pose.items()}
        jkw = {k: jnp.asarray(v) for k, v in pose.items()}
        tkw = {k: torch.as_tensor(v) for k, v in pose.items()}
        jkw["smpl_scale"], tkw["smpl_scale"] = jnp.float32(1.2), \
            torch.tensor(1.2)
    iso = call == "isotropic"
    want = jax.jit(functools.partial(jp.human_pergs_forward, fixed=fixed,
                                     isotropic=iso))(params, **jkw)
    got = tp.human_pergs_forward(tparams, tfixed, isotropic=iso, **tkw)
    assert set(got) == set(want)
    for k in ("lbs_weights", "posedirs", "gt_lbs_weights"):
        assert got[k] is None and want[k] is None
    for k in OUT_KEYS:
        _close(got[k], want[k], err_msg=k)


def test_compact_keeps_the_live_rows():
    smpl, _, _, _, _, params = _jax_case()
    tparams, tfixed = _port(params, smpl)
    full = tp.human_pergs_forward(tparams, tfixed, dataset_idx=1)
    small = tp.compact_for_inference(tparams)
    assert small.gs.capacity == 512 and small.body_pose is tparams.body_pose
    got = tp.human_pergs_forward(small, tfixed, dataset_idx=1)
    n = int(tparams.gs.n_alive)
    for k in ("xyz", "scales", "rotq", "opacity", "shs"):
        np.testing.assert_array_equal(np_of(got[k][:n]), np_of(full[k][:n]),
                                      err_msg=k)
    small = tp.compact_for_inference(tparams, bucket=n)
    assert small.gs.capacity == n and bool(small.gs.alive.all())


def test_densify_reuses_scene_machinery():
    """hugs_tpu's test_pergs_densification_reuses_scene_machinery, both
    packages: the first 40 rows hot, scene_densify_step on the block."""
    from hugs_tpu.train import scene_step as jstep
    from hugs_tpu_torch.train import scene_step as tstep
    smpl, _, _, params, _, _ = _jax_case()
    js = jstep.init_scene_train_state(params.gs)
    hot = (jnp.arange(CAP) < 40) & params.gs.alive
    js = js._replace(gs=js.gs._replace(
        xyz_gradient_accum=jnp.where(hot, 1.0, 0.0), denom=jnp.ones(CAP)))
    key = jax.random.PRNGKey(0)
    js2, jinfo = jstep.scene_densify_step(js, key, 2.0, grad_threshold=0.5,
                                          min_opacity=0.001)
    tparams, _ = _port(params, smpl)
    ts = tstep.init_scene_train_state(tparams.gs)
    with torch.no_grad():
        ts.gs.xyz_gradient_accum.copy_(torch.as_tensor(np.asarray(
            js.gs.xyz_gradient_accum)))
        ts.gs.denom.fill_(1.0)
    noise = torch.as_tensor(np.array(jax.random.normal(key, (2, CAP, 3))))
    ts2, tinfo = tstep.scene_densify_step(ts, noise, 2.0, grad_threshold=0.5,
                                          min_opacity=0.001)
    assert int(tinfo["n_cloned"]) + int(tinfo["n_split"]) > 0
    for k, v in jinfo.items():
        assert int(tinfo[k]) == int(v), k
    np.testing.assert_array_equal(np_of(ts2.gs.alive),
                                  np.asarray(js2.gs.alive))
    for f in ("xyz", "scaling", "rotation", "opacity"):
        _close(getattr(ts2.gs, f), getattr(js2.gs, f), err_msg=f)


def test_pose_changes_image():
    """hugs_tpu's test_pergs_pose_changes_image on the port."""
    from hugs_tpu_torch.models.smpl import synthetic_smpl
    smpl = synthetic_smpl(verts_per_bone=12, device="cpu")
    params, fixed = tp.init_human_pergs(smpl, smpl, np.zeros(10, np.float32),
                                        n_frames=1)
    _, cam = cameras(t=np.array([0.0, 0.2, 2.5], np.float32), fovy=0.9)

    def img_of(pose):
        out = tp.human_pergs_forward(
            params, fixed, global_orient=torch.zeros(3), body_pose=pose,
            betas=torch.zeros(10), transl=torch.zeros(3))
        return render(out["xyz"], out["scales"], out["rotq"],
                      out["opacity"], out["shs"], cam, 48, 48,
                      alive=out["alive"], instance_budget=8192)["render"]

    with torch.no_grad():
        i0 = img_of(torch.zeros(69))
        pose = torch.zeros(69)
        pose[2] = 0.9
        i1 = img_of(pose)
    assert float(i0.mean()) > 1e-4
    assert float((i1 - i0).abs().mean()) > 1e-5


def test_entry_renders_on_cpu():
    """graft_entry.entry()'s forward step at its sizes on the CPU."""
    from hugs_tpu_torch import graft_entry
    fn, args = graft_entry.entry("cpu")
    img = fn(*args)
    assert img.shape == (3, 270, 480)
    assert bool(torch.isfinite(img).all()) and float(img.max()) > 0
