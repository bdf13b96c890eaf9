"""hugs_tpu_torch scene training against hugs_tpu, on the same numpy
inputs and the same converted states.

- The densification functions from a converted state with hot
  statistics and hugs_tpu's own split noise: alive and the info counts
  exact, every other field and the Adam moments atol 1e-6.
- One scene_train_step from hugs_tpu's create_from_pcd state: the loss
  atol 1e-6; the gradients before Adam atol 1e-6 and rtol 1e-4 (the
  render's bar, tests/test_pallas_blend.py:62); the densification
  statistics atol 1e-6 and rtol 1e-4; the updated parameters atol 1e-6,
  only where |grad| > 1e-6: with eps 1e-15, Adam's first step is
  lr * sign(g), so a gradient within rounding of 0 may step +-lr on
  either side.
- 20 steps with one SH degree increase, one densify (the port fed
  hugs_tpu's split noise) and one opacity reset: the loss trajectory
  rtol 1e-3, n_alive equal after the densify.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hugs_tpu.losses.basic import l1_loss as jax_l1, ssim as jax_ssim
from hugs_tpu.models import scene_gs as jscene
from hugs_tpu.render import render as jax_render
from hugs_tpu.train import scene_step as jstep
from hugs_tpu_torch.convert import (
    adam_state_from_numpy, camera_from_numpy, scene_gs_from_numpy,
)
from hugs_tpu_torch.models import scene_gs as tscene
from hugs_tpu_torch.train import scene_step as tstep
from torch_parity import H, W, np_of

CAP = 256
BUDGET = 8192
TILE_CAP = 1024   # hugs_tpu's tiled blend truncates no tile below this
BOOST = 10.0      # tests/test_scene_training.py's LR boost for short runs


class _SceneLR:
    """hugs_tpu/cfg/config.py's scene.lr values."""
    position_init, position_final = 0.00016, 0.0000016
    position_delay_mult, position_max_steps = 0.01, 30_000
    opacity, scaling, rotation, feature = 0.05, 0.005, 0.001, 0.0025


def _gt_scene(n=120, seed=3):
    rng = np.random.default_rng(seed)
    means = rng.uniform(-1.2, 1.2, (n, 3)).astype(np.float32)
    means[:, 2] += 4.0
    scales = np.exp(rng.normal(size=(n, 3)) * 0.2 - 2.0).astype(np.float32)
    rotq = rng.normal(size=(n, 4)).astype(np.float32)
    rotq /= np.linalg.norm(rotq, axis=-1, keepdims=True)
    opacity = (1.0 / (1.0 + np.exp(-rng.normal(size=n) - 1.0))) \
        .astype(np.float32)
    shs = np.zeros((n, 16, 3), np.float32)
    shs[:, 0, :] = rng.uniform(-1.0, 1.0, (n, 3))
    return means, scales, rotq, opacity, shs


@functools.lru_cache(maxsize=None)
def _setup():
    """Cameras, targets (rendered by hugs_tpu, bg 0) and the trainee's
    point cloud: noisy GT means, grey colours."""
    from hugs_tpu.render import make_camera
    means, scales, rotq, opacity, shs = _gt_scene()
    cams = []
    for ang in (0.0, 0.3, -0.3):
        c, s = np.cos(ang), np.sin(ang)
        R = np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]], np.float32)
        pos = np.array([0, 0, 4.0]) - R.T @ np.array([0, 0, 4.0])
        cams.append(make_camera(jnp.asarray(R),
                                jnp.asarray(-R.T @ pos, jnp.float32),
                                0.9, 0.7))
    draw = jax.jit(lambda cam, *a: jax_render(
        *a, cam, W, H, bg=jnp.zeros(3), active_sh_degree=0,
        backend="tiled", tile_cap=TILE_CAP)["render"])
    targets = [np.asarray(draw(cam, *(jnp.asarray(a) for a in (
        means, scales, rotq, opacity, shs)))) for cam in cams]
    noisy = means + 0.05 * np.random.default_rng(0).normal(
        size=means.shape).astype(np.float32)
    return cams, targets, noisy, np.full((means.shape[0], 3), 0.5, np.float32)


def _fields(gs):
    return {f: np.asarray(getattr(gs, f)) for f in gs._fields}


def _jax_state():
    """hugs_tpu's create_from_pcd state, made anisotropic: random
    rotations and scales. create_from_pcd's Gaussians are isotropic, so
    their rotation gradient is rounding noise (|g| < 1e-9) whose sign
    differs between the packages, and Adam's first step moves each by
    +-lr on that sign."""
    _, _, pts, cols = _setup()
    gs = jscene.create_from_pcd(jnp.asarray(pts), jnp.asarray(cols), CAP)
    n = pts.shape[0]
    rng = np.random.default_rng(1)
    gs = gs._replace(
        rotation=gs.rotation.at[:n].set(jnp.asarray(
            rng.normal(size=(n, 4)).astype(np.float32))),
        scaling=gs.scaling.at[:n].add(jnp.asarray(
            rng.normal(size=(n, 3)).astype(np.float32) * 0.3)))
    return jstep.init_scene_train_state(gs)


def _torch_state(jstate):
    gs = scene_gs_from_numpy(_fields(jstate.gs), device="cpu")
    opt = adam_state_from_numpy(
        {k: np.asarray(v) for k, v in jstate.opt.mu.items()},
        {k: np.asarray(v) for k, v in jstate.opt.nu.items()},
        jstate.opt.step, device="cpu")
    return tstep.SceneTrainState(gs=gs, opt=opt)


def _torch_camera(jc):
    return camera_from_numpy({f: np.asarray(getattr(jc, f))
                              for f in jc._fields}, device="cpu")


def _assert_same_state(tstate, jstate, atol=1e-6, rtol=0.0, fields=None):
    for f in fields or (tscene.PARAM_FIELDS + tscene.BUFFER_FIELDS):
        got = np_of(getattr(tstate.gs, f))
        want = np.asarray(getattr(jstate.gs, f))
        if f == "alive":
            np.testing.assert_array_equal(got, want, err_msg=f)
        else:
            np.testing.assert_allclose(got.astype(np.float64),
                                       want.astype(np.float64), atol=atol,
                                       rtol=rtol, err_msg=f)


def _assert_same_moments(tstate, jstate, atol=1e-6):
    for name in ("mu", "nu"):
        for f in tscene.PARAM_FIELDS:
            np.testing.assert_allclose(
                np_of(getattr(tstate.opt, name)[f]),
                np.asarray(getattr(jstate.opt, name)[f]), atol=atol,
                err_msg=f"{name}[{f}]")


def _hot_state(seed):
    """A converted state with random parameters, Adam moments and
    densification statistics over every row, 85 % of them alive: some
    Gaussians hot, some small (cloned) and some large (split), some
    faint or wide on screen (pruned), and more candidates than free
    rows (dropped)."""
    rng = np.random.default_rng(seed)
    js = _jax_state()

    def draw(shape, scale=1.0, shift=0.0):
        return jnp.asarray((rng.normal(size=shape) * scale + shift)
                           .astype(np.float32))

    gs = js.gs._replace(
        xyz=draw((CAP, 3)), features_dc=draw((CAP, 1, 3)),
        features_rest=draw((CAP, 15, 3), 0.3), scaling=draw((CAP, 3), 0.5,
                                                             -3.2),
        rotation=draw((CAP, 4)), opacity=draw((CAP, 1), 3.0),
        alive=jnp.asarray(rng.uniform(size=CAP) < 0.85),
        xyz_gradient_accum=jnp.asarray(
            rng.uniform(0.0, 2e-3, CAP).astype(np.float32)),
        denom=jnp.asarray(rng.integers(0, 5, CAP).astype(np.float32)),
        max_radii2d=jnp.asarray(rng.uniform(0, 40, CAP).astype(np.float32)))
    mu = {f: draw(v.shape) for f, v in js.opt.mu.items()}
    nu = {f: jnp.asarray(rng.uniform(size=v.shape).astype(np.float32))
          for f, v in js.opt.nu.items()}
    js = js._replace(gs=gs, opt=js.opt._replace(mu=mu, nu=nu))
    return js, _torch_state(js)


@pytest.mark.parametrize("max_screen_size", [None, 20.0])
def test_densify_and_prune_matches_jax(max_screen_size):
    js, ts = _hot_state(1)
    key = jax.random.PRNGKey(5)
    js2, jinfo = jstep.scene_densify_step(
        js, key, 4.0, grad_threshold=0.0002, min_opacity=0.005,
        max_screen_size=max_screen_size)
    # hugs_tpu's own split noise (scene_gs.py:291), handed to the port
    noise = np.asarray(jax.random.normal(key, (2, CAP, 3)))
    _, tinfo = tstep.scene_densify_step(
        ts, torch.as_tensor(noise), 4.0, grad_threshold=0.0002,
        min_opacity=0.005, max_screen_size=max_screen_size)
    for k in ("n_cloned", "n_split", "n_pruned", "n_dropped", "n_alive"):
        assert int(tinfo[k]) == int(jinfo[k]), k
    assert int(jinfo["n_cloned"]) > 0 and int(jinfo["n_split"]) > 0
    assert int(jinfo["n_pruned"]) > 0 and int(jinfo["n_dropped"]) > 0
    _assert_same_state(ts, js2)
    _assert_same_moments(ts, js2)


def test_reset_opacity_and_sh_degree_match_jax():
    js, ts = _hot_state(2)
    gj, moments = jscene.reset_opacity(js.gs, [js.opt.mu, js.opt.nu])
    tscene.reset_opacity(ts.gs, [ts.opt.mu, ts.opt.nu])
    js = js._replace(gs=gj, opt=js.opt._replace(mu=moments[0],
                                                nu=moments[1]))
    _assert_same_state(ts, js)
    _assert_same_moments(ts, js)
    for _ in range(4):          # 0 -> 3, then held at the maximum
        gj = jscene.one_up_sh_degree(gj)
        tscene.one_up_sh_degree(ts.gs)
        assert int(ts.gs.active_sh_degree) == int(gj.active_sh_degree)
    assert int(ts.gs.active_sh_degree) == 3


def test_add_densification_stats_matches_jax():
    js, ts = _hot_state(3)
    rng = np.random.default_rng(4)
    grad = rng.normal(size=(CAP, 2)).astype(np.float32)
    radii = rng.uniform(0, 30, CAP).astype(np.float32)
    vis = rng.uniform(size=CAP) > 0.4
    gj = jscene.add_densification_stats(js.gs, jnp.asarray(grad),
                                        jnp.asarray(radii), jnp.asarray(vis))
    tscene.add_densification_stats(ts.gs, torch.as_tensor(grad),
                                   torch.as_tensor(radii),
                                   torch.as_tensor(vis))
    _assert_same_state(ts, js._replace(gs=gj))


def _lrs():
    static, sched = jstep.make_scene_lrs(_SceneLR, spatial_lr_scale=2.0)
    tstatic, tsched = tstep.make_scene_lrs(_SceneLR, spatial_lr_scale=2.0)
    assert tstatic == static
    return ({k: v * BOOST for k, v in static.items()},
            lambda step: jnp.float32(sched(step) * BOOST),
            lambda step: tsched(step) * BOOST)


def _jax_grads(jstate, cam, target, bg):
    """hugs_tpu's scene_train_step loss and its gradients before Adam
    (scene_step.py:82-98), in the test."""
    gs = jstate.gs

    def loss_fn(params, hook):
        out = jscene.scene_forward(jscene.with_params(gs, params))
        img = jax_render(out["xyz"], out["scales"], out["rotq"],
                         out["opacity"], out["shs"], cam, W, H, bg=bg,
                         active_sh_degree=out["active_sh_degree"],
                         alive=out["alive"], mean2d_grad_hook=hook,
                         backend="tiled", instance_budget=BUDGET,
                         tile_cap=TILE_CAP)["render"]
        return 0.8 * jax_l1(img, target) + 0.2 * (1.0 - jax_ssim(img,
                                                                  target))

    return jax.jit(jax.value_and_grad(loss_fn, argnums=(0, 1)))(
        jscene.params_of(gs), jnp.zeros((CAP, 2)))


_STEP_KW = dict(width=W, height=H, instance_budget=BUDGET)


def test_one_train_step_matches_jax():
    cams, targets, _, _ = _setup()
    static, jsched, tsched = _lrs()
    bg = jnp.zeros(3)
    js = _jax_state()
    ts = _torch_state(js)
    tcam = _torch_camera(cams[0])
    target = torch.as_tensor(targets[0])

    jloss, (jgrads, jhook) = _jax_grads(js, cams[0], jnp.asarray(targets[0]),
                                        bg)
    hook = torch.zeros((CAP, 2), requires_grad=True)
    pkg = tstep.scene_render(ts.gs, tcam, torch.zeros(3), hook, width=W,
                             height=H, instance_budget=BUDGET)
    tloss = tstep.scene_loss(pkg["render"], target)
    tgrads, thook = tstep.scene_grads(tloss, ts.gs, hook)
    np.testing.assert_allclose(float(tloss.detach()), float(jloss), atol=1e-6)
    for f in tscene.PARAM_FIELDS + ("hook",):
        got = np_of(thook if f == "hook" else tgrads[f])
        want = np.asarray(jhook if f == "hook" else jgrads[f])
        # rows past the point cloud sit at the camera centre, where the
        # view direction's norm has no gradient: NaN in both packages
        assert np.nanmax(np.abs(want)) > 0 or f == "features_rest", f
        np.testing.assert_allclose(got, want, atol=1e-6, rtol=1e-4,
                                   err_msg=f)

    js2, jaux = jstep.scene_train_step(js, cams[0], jnp.asarray(targets[0]),
                                       bg, jsched(0), static,
                                       tile_cap=TILE_CAP, **_STEP_KW)
    ts2, taux = tstep.scene_train_step(ts, tcam, target, torch.zeros(3),
                                       tsched(0), static, **_STEP_KW)
    assert not bool(jaux["overflowed"]) and not bool(taux["overflowed"])
    np.testing.assert_allclose(float(taux["loss"]), float(jaux["loss"]),
                               atol=1e-6)
    _assert_same_state(ts2, js2, atol=1e-6, rtol=1e-4,
                       fields=("xyz_gradient_accum", "denom", "max_radii2d",
                               "alive"))
    for f in tscene.PARAM_FIELDS:
        moved = np.abs(np.asarray(jgrads[f])) > 1e-6
        np.testing.assert_allclose(np_of(getattr(ts2.gs, f))[moved],
                                   np.asarray(getattr(js2.gs, f))[moved],
                                   atol=1e-6, err_msg=f)


def test_training_trajectory_matches_jax():
    """20 steps over 3 views: SH degree up at step 5, densify at step 10
    (hugs_tpu's split noise fed to the port), opacity reset at step 15."""
    cams, targets, _, _ = _setup()
    static, jsched, tsched = _lrs()
    bg = jnp.zeros(3)
    js = _jax_state()
    ts = _torch_state(js)
    tcams = [_torch_camera(c) for c in cams]
    jl, tl = [], []
    for step in range(20):
        if step == 5:
            js = js._replace(gs=jscene.one_up_sh_degree(js.gs))
            tscene.one_up_sh_degree(ts.gs)
        if step in (10, 15):
            key = jax.random.PRNGKey(step)
            kw = (dict(grad_threshold=0.0002, min_opacity=0.005)
                  if step == 10 else
                  dict(grad_threshold=np.inf, min_opacity=0.0,
                       do_reset_opacity=True))
            n0 = int(js.gs.n_alive)
            js, jinfo = jstep.scene_densify_step(js, key, 4.0, **kw)
            noise = np.asarray(jax.random.normal(key, (2, CAP, 3)))
            ts, tinfo = tstep.scene_densify_step(
                ts, torch.as_tensor(noise), 4.0, **kw)
            assert int(tinfo["n_alive"]) == int(jinfo["n_alive"])
            if step == 10:
                assert int(jinfo["n_alive"]) > n0
        i = step % len(cams)
        js, jaux = jstep.scene_train_step(
            js, cams[i], jnp.asarray(targets[i]), bg, jsched(step), static,
            tile_cap=TILE_CAP, **_STEP_KW)
        ts, taux = tstep.scene_train_step(
            ts, tcams[i], torch.as_tensor(targets[i]), torch.zeros(3),
            tsched(step), static, **_STEP_KW)
        assert not bool(jaux["overflowed"]) and not bool(taux["overflowed"])
        jl.append(float(jaux["loss"]))
        tl.append(float(taux["loss"]))
    np.testing.assert_allclose(tl, jl, rtol=1e-3)
    # the fit improves before the opacity reset sets it back
    assert np.mean(tl[12:15]) < np.mean(tl[:3]), tl
    assert int(ts.gs.n_alive) == int(js.gs.n_alive)
