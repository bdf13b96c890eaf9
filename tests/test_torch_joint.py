"""The port's joint human + scene training step against hugs_tpu's, on
carried-across states and hugs_tpu's own draws.

The avatar is the parity tests' (tests/torch_parity.py::jax_human:
synthetic_smpl(12), capacity 512, n_features 8, a 32^2 triplane, two
frames of random poses); the scene is hugs_tpu's create_from_pcd of 300
points in a radius-1.5 ball around the body, capacity 512; 64x48 from
the orbit at distance 2.6, random targets and a box mask; config[3]'s
loss weights (cfg_files/neuman/hugs_human_scene.yaml) with LPIPS patches
of 32; hugs_tpu's `tiled` backend, whose 1024 tile cap no tile reaches
here. Both states go across through convert.joint_state_from_numpy.

- One step, for optim_scene in {True, False} and humansep_w in {0, 1}:
  the loss and each term atol 2e-5 plus rtol 2e-6 (the human step's bar
  in tests/test_torch_human_train.py: the LBS term is 1000 times a mean
  of squared skinning-weight differences);
  both sets' parameters, Adam moments and densification statistics at
  the one-step bars of torch_parity.assert_joint_close.
- 5 steps over two frames with new draws each step (the recipe's case:
  scene optimised, humansep 1). The port runs free beside hugs_tpu and
  each step's loss holds the bar above. Each step is also held to the
  one-step bars from hugs_tpu's warm state of that step (Adam moments,
  step count and statistics carried in), with one difference: there the
  parameters are held at atol 1e-6 plus rtol 1e-5. A warm Adam step
  divides the two agreed moments, m / sqrt(v), so rounding inside the
  moments' bars moves it by a share of its rate: 5.4e-6 on a scene
  log-scale of -1.69 at rate 0.005 (3.2e-6 of its value). The free
  run's parameters are not compared: their gradients drift by rounding
  beyond the one-step bars after a few steps (a scene scaling second
  moment by 1.2e-3 relative at step 4), while its loss holds.
- convert.joint_state_from_numpy carries every array across exactly.
"""
import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hugs_tpu.losses.loss import HumanSceneLoss as JaxLoss
from hugs_tpu.losses.lpips import LPIPS as JaxLPIPS
from hugs_tpu.ops.rotations import axis_angle_to_rotation_6d
from hugs_tpu_torch import convert
from hugs_tpu_torch.cfg import load_config
from hugs_tpu_torch.losses.loss import HumanSceneLoss
from hugs_tpu_torch.train import human_step as thst
from hugs_tpu_torch.train import joint_step as tjs
from hugs_tpu_torch.train import scene_step as tss
from torch_parity import (  # noqa: F401 (cuda_device: a fixture)
    H, W, assert_joint_close, cuda_device, flat_group, flat_tree, jax_human,
    jax_joint_to_numpy, jax_loss_draws, jax_lpips_to_torch, np_of,
)

CAP = 512
S_CAP = 512
N_SCENE = 300
BUDGET = 1 << 14
PATCH = 32
EXTENT = 1.5
BG = np.ones(3, np.float32)         # white, as the recipe trains
LOSS_TOL = dict(atol=2e-5, rtol=2e-6)
RECIPE = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "cfg_files", "neuman", "hugs_human_scene.yaml")


def _loss_kw(humansep_w):
    loss = load_config(RECIPE).human.loss
    assert loss.humansep_w == 1.0 and loss.lpips_w == 1.0
    return dict(l_ssim_w=loss.ssim_w, l_l1_w=loss.l1_w,
                l_lpips_w=loss.lpips_w, l_lbs_w=loss.lbs_w,
                l_humansep_w=humansep_w, num_patches=loss.num_patches,
                patch_size=PATCH)


def _jax():
    """hugs_tpu's step modules, imported where they are used:
    hugs_tpu.models needs flax."""
    from hugs_tpu.models import scene_gs as jsg
    from hugs_tpu.train import human_step, joint_step, scene_step
    return jsg, human_step, scene_step, joint_step


@functools.lru_cache(maxsize=None)
def _lpips_pair():
    lp = JaxLPIPS.create(seed=0)
    return lp, jax_lpips_to_torch(lp)


@functools.lru_cache(maxsize=None)
def _frames():
    """Two frames: the orbit's cameras, random targets and masks."""
    from hugs_tpu.data.cameras import get_rotating_camera as jax_cameras
    cams = jax_cameras(img_size=(H, W), fov=0.95, dist=2.6, nframes=3)[:2]
    rng = np.random.default_rng(9)
    out = []
    for c in cams:
        gt = rng.uniform(size=(3, H, W)).astype(np.float32)
        mask = np.zeros((H, W), np.float32)
        mask[6:44, 16:48] = 1.0
        tcam = convert.camera_from_numpy(
            {f: np.asarray(getattr(c["camera"], f))
             for f in c["camera"]._fields}, "cpu")
        out.append((c["camera"], tcam, gt, mask))
    return out


def _lrs():
    """hugs_tpu's rates and the port's, each from its own loader of the
    recipe, which must agree: (human static, human schedules, scene
    static, scene schedules), each schedule pair (hugs_tpu's, port's)."""
    from hugs_tpu.cfg.config import load_config as jax_load
    _, jhst, jss, _ = _jax()
    jcfg, tcfg = jax_load(RECIPE), load_config(RECIPE)
    jh, jh_sched = jhst.make_human_lrs(jcfg.human.lr, optim_pose=True,
                                       optim_trans=True)
    th, th_sched = thst.make_human_lrs(tcfg.human.lr, optim_pose=True,
                                       optim_trans=True)
    js, js_sched = jss.make_scene_lrs(jcfg.scene.lr, EXTENT)
    ts, ts_sched = tss.make_scene_lrs(tcfg.scene.lr, EXTENT)
    assert jh == th and js == ts
    return jh, (jh_sched, th_sched), js, (js_sched, ts_sched)


def _states(seed=0):
    """hugs_tpu's JointTrainState (fresh Adam) with two frames of random
    poses, its fixed body and config, and the port's copy: (jstate,
    fixed, cfg, tstate, tfixed, tcfg)."""
    from torch_parity import human_cfg_to_torch
    from hugs_tpu_torch.models import human_gs as th
    jsg, jhst, jss, jjs = _jax()
    cfg, smpl, params, state, fixed, _ = jax_human(
        vpb=12, capacity=CAP, n_frames=2, seed=seed)
    rng = np.random.default_rng(seed + 1)
    pose = (rng.normal(size=(2, 23, 3)) * 0.2).astype(np.float32)
    orient = (rng.normal(size=(2, 1, 3)) * 0.1).astype(np.float32)
    params = params._replace(
        body_pose=axis_angle_to_rotation_6d(jnp.asarray(pose)).reshape(2, -1),
        global_orient=axis_angle_to_rotation_6d(
            jnp.asarray(orient)).reshape(2, 6),
        transl=jnp.asarray((rng.normal(size=(2, 3)) * 0.05).astype(
            np.float32)))
    pts = rng.normal(size=(N_SCENE, 3))
    pts = (pts / np.linalg.norm(pts, axis=1, keepdims=True)
           * rng.uniform(0.4, 1.5, (N_SCENE, 1))).astype(np.float32)
    cols = rng.uniform(size=(N_SCENE, 3)).astype(np.float32)
    gs = jsg.create_from_pcd(jnp.asarray(pts), jnp.asarray(cols), S_CAP)
    jstate = jjs.JointTrainState(
        human=jhst.init_human_train_state(params, state),
        scene=jss.init_scene_train_state(gs))
    tstate = convert.joint_state_from_numpy(*jax_joint_to_numpy(jstate),
                                            device="cpu")
    from torch_parity import smpl_arrays
    tsmpl = convert.smpl_model_from_numpy(smpl_arrays(smpl), "cpu")
    tfixed = th.compute_vitruvian(tsmpl, tstate.human.params.betas.detach())
    return jstate, fixed, cfg, tstate, tfixed, human_cfg_to_torch(cfg)


def _step_args(frame, step, lrs, humansep_w, hbg):
    jcam, tcam, gt, mask = _frames()[frame]
    h_static, (jh_s, th_s), s_static, (js_s, ts_s) = lrs
    return (jcam, tcam, gt, mask, h_static, jh_s(step), th_s(step),
            s_static, js_s(step), ts_s(step), _loss_kw(humansep_w),
            BG if hbg is None else hbg)


def _jax_step(pair, frame, key, step, lrs, humansep_w, optim_scene,
              hbg=None):
    """hugs_tpu's step from `pair`'s state: (its new state, its aux)."""
    jstate, fixed, cfg = pair[:3]
    jcam, _, gt, mask, h_static, jh_lr, _, s_static, js_lr, _, kw, hbg = \
        _step_args(frame, step, lrs, humansep_w, hbg)
    js2, jaux = _jax()[3].joint_train_step(
        jstate, fixed, jcam, jnp.asarray(gt), jnp.asarray(mask),
        jnp.asarray(BG), jnp.asarray(hbg), jnp.float32(1.0),
        jnp.int32(frame), key, jnp.float32(jh_lr), h_static,
        jnp.float32(js_lr), s_static, _lpips_pair()[0], cfg=cfg,
        loss_fn=JaxLoss(**kw), width=W, height=H, backend="tiled",
        instance_budget=BUDGET, render_human_separate=humansep_w > 0,
        optim_scene=optim_scene)
    assert not bool(jaux["overflowed"])
    return js2, jaux


def _port_step(pair, frame, key, step, lrs, humansep_w, optim_scene,
               hbg=None):
    """The port's step from `pair`'s state, in place, on hugs_tpu's draws
    of `key`: its aux."""
    tstate, tfixed, tcfg = pair[3:]
    _, tcam, gt, mask, h_static, _, th_lr, s_static, _, ts_lr, kw, hbg = \
        _step_args(frame, step, lrs, humansep_w, hbg)
    draws = jax_loss_draws(key, JaxLoss(**kw), (3, H, W), "human_scene")
    _, taux = tjs.joint_train_step(
        tstate, tfixed, tcam, torch.as_tensor(gt), torch.as_tensor(mask),
        torch.as_tensor(BG), torch.as_tensor(hbg), torch.tensor(1.0), frame,
        draws, th_lr, h_static, ts_lr, s_static, _lpips_pair()[1],
        cfg=tcfg, loss_fn=HumanSceneLoss(**kw), width=W, height=H,
        instance_budget=BUDGET, render_human_separate=humansep_w > 0,
        optim_scene=optim_scene)
    assert not bool(taux["overflowed"])
    return taux


def test_joint_state_converts_exactly():
    jstate, _, _, tstate, _, _ = _states()
    for t, j in ((tstate.human, jstate.human), (tstate.scene, jstate.scene)):
        for m in ("mu", "nu"):
            for group, tree in getattr(j.opt, m).items():
                got = flat_group(getattr(t.opt, m)[group])
                for key, want in flat_tree(tree).items():
                    np.testing.assert_array_equal(got[key], want)
    for f in jstate.scene.gs._fields:
        np.testing.assert_array_equal(np_of(getattr(tstate.scene.gs, f)),
                                      np.asarray(getattr(jstate.scene.gs, f)))
    for f in jstate.human.state._fields:
        np.testing.assert_array_equal(
            np_of(getattr(tstate.human.state, f)),
            np.asarray(getattr(jstate.human.state, f)))


@pytest.mark.parametrize("humansep_w", [0.0, 1.0], ids=["no_sep", "humansep"])
@pytest.mark.parametrize("optim_scene", [True, False],
                         ids=["optim_scene", "scene_frozen"])
def test_one_joint_step_matches_jax(optim_scene, humansep_w):
    pair = _states()
    lrs = _lrs()
    # the human pass on its own background, unlike the merged one
    args = (0, jax.random.PRNGKey(3), 0, lrs, humansep_w, optim_scene,
            np.array([0.2, 0.5, 0.8], np.float32))
    js2, jaux = _jax_step(pair, *args)
    taux = _port_step(pair, *args)
    want_terms = {"l1", "ssim", "lpips_patch", "lbs"} | (
        {"l1_human", "ssim_human", "lpips_patch_human"} if humansep_w else
        set())
    assert set(taux["loss_dict"]) == set(jaux["loss_dict"]) == want_terms
    for k, v in jaux["loss_dict"].items():
        np.testing.assert_allclose(float(taux["loss_dict"][k]), float(v),
                                   **LOSS_TOL, err_msg=k)
    np.testing.assert_allclose(float(taux["loss"]), float(jaux["loss"]),
                               **LOSS_TOL)
    for k in ("n_instances", "n_slots"):
        assert int(taux[k]) == int(jaux[k]), k
    np.testing.assert_allclose(np_of(taux["render"]),
                               np.asarray(jaux["render"]), atol=2e-5)
    for k in ("opacity", "scales_canon", "rotmat_canon"):
        np.testing.assert_allclose(np_of(taux[k]), np.asarray(jaux[k]),
                                   atol=1e-6, err_msg=k)
    tstate = pair[3]
    assert int(tstate.scene.opt.step) == (1 if optim_scene else 0)
    # both sets' statistics gathered, each from its own rows of the hook
    assert float(tstate.human.state.denom.sum()) > 0
    assert float(tstate.scene.gs.denom.sum()) > 0
    assert_joint_close(tstate, js2)


def test_joint_trajectory_matches_jax():
    """5 steps over two frames, new draws each step: scene optimised,
    humansep 1. The port runs free beside hugs_tpu, each step's loss at
    the one-step bar; and each step is held to the one-step bars from the
    same warm state (a second port state reloaded from hugs_tpu's before
    the step), its parameters at atol 1e-6 + rtol 1e-5."""
    free = list(_states())
    lrs = _lrs()
    for step in range(5):
        key = jax.random.PRNGKey(100 + step)
        frame = step % 2
        synced = list(free)
        synced[3] = convert.joint_state_from_numpy(
            *jax_joint_to_numpy(free[0]), device="cpu")
        args = (frame, key, step, lrs, 1.0, True)
        js2, jaux = _jax_step(free, *args)
        taux = _port_step(synced, *args)
        assert_joint_close(synced[3], js2, p_rtol=1e-5)
        free_aux = _port_step(free, *args)
        for k, v in jaux["loss_dict"].items():
            np.testing.assert_allclose(float(taux["loss_dict"][k]), float(v),
                                       **LOSS_TOL, err_msg=f"{k} {step}")
        np.testing.assert_allclose(float(free_aux["loss"]),
                                   float(jaux["loss"]), **LOSS_TOL,
                                   err_msg=f"step {step}")
        free[0] = js2
    assert int(free[3].human.opt.step) == int(free[0].human.opt.step) == 5


@pytest.mark.cuda
def test_joint_step_on_card_matches_cpu(cuda_device):
    """One joint step's loss, terms and gradients on the card (K1 and K2,
    the merged frame and the human alone) against the same step on the
    CPU (the plain blend), from the same avatar, scene, state and draws,
    at train/human_check.py's bars."""
    from hugs_tpu_torch.train import human_check
    torch.backends.cuda.matmul.allow_tf32 = False
    human_check.compare_steps(human_check.small_joint_step(cuda_device, 5),
                              human_check.small_joint_step("cpu", 5))
