"""hugs_tpu_torch/convergence: the convergence recipes against the TPU
scripts and hugs_tpu, on the CPU at the scripts' SMOKE sizes.

- The ground truth's numpy helpers equal the scripts' own: gt_poses of
  both families (human_avatar_tpu.py and joint_scene_tpu.py; the
  flagship's walk), scene_points (joint, flagship) and gt_surface_scene,
  exactly. The definitions are taken from the script sources with ast
  and run alone: importing a script sets JAX's compilation cache
  directory at module level.
- One ground-truth frame at 64x64 (frame 1 of the human recipe's 4)
  equals hugs_tpu's smpl_forward + render(backend="tiled") of the same
  splats: the image atol 2e-5 (the render's bar), the mask exactly.
- One iteration of the human recipe (step 1, a given background) equals
  hugs_tpu's human_train_step on the parity tests' small avatar
  (tests/torch_parity.py::jax_human) carried across by convert: the
  loss and its terms atol 2e-5 + rtol 2e-6, the state at the one-step
  bars of test_torch_human_train.py. The recipe's budget starts at 64
  slots, so its forward overflows, grows the budget once
  (train/budget.py) and runs again before the update.
- eval_held on the carried-across avatar equals hugs_tpu's held-out PSNR
  to 1e-4 dB.

The joint recipe's frame and iteration are
tests/test_torch_convergence_joint.py's, the entry points' runs
tests/test_torch_convergence_cli.py's; both use the helpers here.
"""
import ast
import functools
import os
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import torch

from hugs_tpu_torch.convergence import (
    flagship_release, human_avatar, joint_scene, surface_scene,
)
from hugs_tpu_torch.models.smpl import synthetic_smpl
from hugs_tpu_torch.train.human_step import init_human_train_state
from torch_parity import (  # noqa: F401 (few_threads: autouse)
    few_threads, flat_group, flat_tree, human_to_torch, jax_human, np_of,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
S = 64                      # the SMOKE width and height
F = 4                       # the SMOKE frames
BUDGET = 1 << 14
LOSS_TOL = dict(atol=2e-5, rtol=2e-6)


def _script_fns(script, names, **env):
    """The named top-level functions of scripts/<script>, compiled from
    its source alone and run in a namespace of numpy and `env`."""
    path = os.path.join(REPO, "scripts", script)
    tree = ast.parse(open(path).read(), path)
    body = [n for n in tree.body
            if isinstance(n, ast.FunctionDef) and n.name in names]
    assert sorted(n.name for n in body) == sorted(names)
    ns = {"np": np, **env}
    exec(compile(ast.Module(body=body, type_ignores=[]), path, "exec"), ns)
    return [ns[n] for n in names]


def test_gt_helpers_equal_the_scripts():
    for script, mod in (("human_avatar_tpu.py", human_avatar),
                        ("joint_scene_tpu.py", human_avatar),
                        ("flagship_release_tpu.py", flagship_release)):
        (want,) = _script_fns(script, ["gt_poses"])
        for f, n in [(f, 24) for f in range(24)] + [(a + 0.5, 8)
                                                     for a in range(8)]:
            for a, b in zip(mod.gt_poses(f, n), want(f, n)):
                np.testing.assert_array_equal(a, b, err_msg=script)
    assert joint_scene.gt_poses is human_avatar.gt_poses
    for script, mod, sizes in (
            ("joint_scene_tpu.py", joint_scene,
             dict(N_SPHERE=6000, N_FLOOR=2000)),
            ("flagship_release_tpu.py", flagship_release,
             dict(N_SPHERE=24000, N_FLOOR=8000, N_BOX=2000))):
        (want,) = _script_fns(script, ["scene_points"], **sizes)
        args = [getattr(mod, "SIZES")[k] for k in sizes]
        assert args == list(sizes.values())
        for a, b in zip(mod.scene_points(np.random.RandomState(0)),
                        want(np.random.RandomState(0))):
            np.testing.assert_array_equal(a, b, err_msg=script)
    (want,) = _script_fns("surface_scene.py", ["gt_surface_scene"],
                          jnp=SimpleNamespace(asarray=np.asarray))
    for a, b in zip(surface_scene.gt_surface_scene(), want()):
        np.testing.assert_array_equal(a, b)


# ------------------------------------------------------- ground truth

@functools.lru_cache(maxsize=None)
def _human_gt():
    smpl = synthetic_smpl(verts_per_bone=human_avatar.VPB, device="cpu")
    frames, demands = human_avatar.build_gt(smpl, S, F, "cpu")
    return smpl, frames, demands


@functools.lru_cache(maxsize=None)
def _joint_gt():
    smpl = synthetic_smpl(verts_per_bone=joint_scene.VPB, device="cpu")
    return smpl, joint_scene.build_gt(smpl, S, F, joint_scene.SMOKE, "cpu")


@functools.lru_cache(maxsize=None)
def _jax_cams():
    from hugs_tpu.data.cameras import get_rotating_camera
    return [c["camera"] for c in get_rotating_camera(
        img_size=(S, S), fov=human_avatar.FOV, dist=human_avatar.DIST,
        nframes=F + 1, angle_limit=2 * np.pi)[:-1]]


def _jax_splats(points, mult, col):
    """The script's splats on `points` (a JAX array): kNN scales x mult,
    identity rotations, opacity 0.95, SH0 of col."""
    from hugs_tpu.ops.knn import mean_sq_dist_to_knn
    d2 = mean_sq_dist_to_knn(points, k=3)
    n = points.shape[0]
    return (jnp.tile(jnp.sqrt(jnp.clip(d2, 1e-8))[:, None] * mult, (1, 3)),
            jnp.tile(jnp.array([1.0, 0, 0, 0]), (n, 1)),
            jnp.full(n, 0.95), jnp.asarray(human_avatar.common.sh0(col)))


def check_gt_frame(which):
    """Frame 1 at 64x64 against the script's render_gt in hugs_tpu's
    tiled backend (16-px tiles) on the same arrays."""
    from hugs_tpu.models.smpl import smpl_forward
    from hugs_tpu.models.smpl import synthetic_smpl as jax_smpl
    from hugs_tpu.render import render
    smpl = jax_smpl(verts_per_bone=24)
    vt = np.asarray(smpl.v_template)
    hcol = np.clip(human_avatar.common.stripes(vt), 0, 1)
    pose, orient = human_avatar.gt_poses(1, F)
    cam = _jax_cams()[1]
    if which == "human":
        _, frames, _ = _human_gt()
        spts = np.zeros((0, 3), np.float32)
        scol = np.zeros((0, 3), np.float32)
    else:
        _, (frames, _, (spts, scol), _) = _joint_gt()

    def rend(xyz, sc, q, op, shs, bgv):
        return render(xyz, sc, q, op, shs, cam, S, S,
                      bg=jnp.full(3, bgv), active_sh_degree=0,
                      instance_budget=BUDGET, backend="tiled")["render"]

    @jax.jit
    def gt(pose, orient, spts):
        verts = smpl_forward(smpl, jnp.zeros(10), pose, orient,
                             jnp.zeros(3)).vertices
        h = _jax_splats(jnp.asarray(vt), 0.9, hcol)
        i0, i1 = rend(verts, *h, 0.0), rend(verts, *h, 1.0)
        mask = (jnp.clip((i1 - i0).mean(0), 0, 1) < 0.5).astype(jnp.float32)
        if spts.shape[0] == 0:
            return i0, mask
        s = _jax_splats(spts, 1.2, scol)
        return rend(jnp.concatenate([verts, spts]),
                    *(jnp.concatenate([a, b]) for a, b in zip(h, s)),
                    joint_scene.BG), mask

    want, mask = (np.asarray(a) for a in gt(
        jnp.asarray(pose), jnp.asarray(orient), jnp.asarray(spts)))
    np.testing.assert_allclose(np_of(frames[1]["rgb"]), want, atol=2e-5)
    np.testing.assert_array_equal(np_of(frames[1]["mask"]), mask)
    assert 0.02 < mask.mean() < 0.5


def test_gt_frame_matches_jax():
    check_gt_frame("human")


# ---------------------------------------------------- one iteration

def _jstep():
    from hugs_tpu.train import human_step, joint_step, scene_step
    return human_step, joint_step, scene_step


@functools.lru_cache(maxsize=None)
def _jax_avatar_jax():
    cfg, smpl, params, state, fixed, _ = jax_human(
        vpb=12, capacity=512, n_frames=F, use_deformer=True,
        disable_posedirs=True)
    return cfg, smpl, params, state, fixed


def _jax_avatar():
    """The parity tests' small avatar with F frames' pose tables and the
    recipe's deformer settings: (hugs_tpu's cfg, smpl, params, state,
    fixed), made once, and a fresh port copy (cfg, params, state,
    fixed)."""
    cfg, smpl, params, state, fixed = _jax_avatar_jax()
    return (cfg, smpl, params, state, fixed), human_to_torch(
        cfg, smpl, params, state)


def _jax_rates(scene=False):
    from hugs_tpu.cfg import default_config
    hst, _, sst = _jstep()
    dcfg = default_config()
    out = hst.make_human_lrs(dcfg.human.lr, optim_pose=True,
                             optim_trans=False)
    if scene:
        out += sst.make_scene_lrs(dcfg.scene.lr, joint_scene.SCENE_EXTENT)
    return out


def _assert_human_close(ts, js):
    """A human state at the one-step bars: parameters atol 1e-6 where
    hugs_tpu's first moment is beyond rounding, moments atol 1e-7 / 1e-12
    + rtol 1e-4, statistics atol 1e-6 + rtol 1e-4."""
    from hugs_tpu_torch.models import human_gs as th
    assert int(ts.opt.step) == int(js.opt.step)
    for group in th.PARAM_GROUPS:
        p_t, p_j = flat_group(getattr(ts.params, group)), flat_tree(
            getattr(js.params, group))
        mu_t, mu_j = flat_group(ts.opt.mu[group]), flat_tree(js.opt.mu[group])
        nu_t, nu_j = flat_group(ts.opt.nu[group]), flat_tree(js.opt.nu[group])
        for key in mu_j:
            err = f"{group}.{key}"
            np.testing.assert_allclose(mu_t[key], mu_j[key], atol=1e-7,
                                       rtol=1e-4, err_msg=err)
            np.testing.assert_allclose(nu_t[key], nu_j[key], atol=1e-12,
                                       rtol=1e-4, err_msg=err)
            hot = np.abs(mu_j[key]) > 1e-7
            np.testing.assert_allclose(p_t[key][hot], p_j[key][hot],
                                       atol=1e-6, err_msg=err)
    for f in ("xyz_gradient_accum", "denom", "max_radii2d"):
        np.testing.assert_allclose(np_of(getattr(ts.state, f)),
                                   np.asarray(getattr(js.state, f)),
                                   atol=1e-6, rtol=1e-4, err_msg=f)


def _assert_losses(taux, jaux):
    assert set(taux["loss_dict"]) == set(jaux["loss_dict"])
    for k, v in jaux["loss_dict"].items():
        np.testing.assert_allclose(float(taux["loss_dict"][k]), float(v),
                                   **LOSS_TOL, err_msg=k)
    np.testing.assert_allclose(float(taux["loss"]), float(jaux["loss"]),
                               **LOSS_TOL)


def _human_run():
    (cfg, smpl, params, state, fixed), (tcfg, tp, tst, tfixed) = \
        _jax_avatar()
    _, frames, _ = _human_gt()
    run = human_avatar.make_run(frames, init_human_train_state(tp, tst),
                                tfixed, tcfg, S, BUDGET)
    return (cfg, params, state, fixed), run, frames


def test_human_iteration_matches_jax():
    hst = _jstep()[0]
    from hugs_tpu.losses.loss import HumanSceneLoss as JaxLoss
    (cfg, params, state, fixed), run, frames = _human_run()
    static, sched = _jax_rates()
    assert static == run.static_lrs
    np.testing.assert_allclose(float(run.sched(1)), float(sched(1)),
                               rtol=1e-6)
    bg = np.array([0.3, 0.6, 0.1], np.float32)
    run.budget = 64
    taux = human_avatar.train_iteration(run, 1, torch.as_tensor(bg))
    assert run.budget_grown == 1 and run.budget >= 1 << 16
    i = run.train_i[1 % len(run.train_i)]
    rgb, mask = np_of(frames[i]["rgb"]), np_of(frames[i]["mask"])
    gt = rgb * mask[None] + bg[:, None, None] * (1.0 - mask[None])
    js, jaux = hst.human_train_step(
        hst.init_human_train_state(params, state), fixed, _jax_cams()[i],
        jnp.asarray(gt), jnp.asarray(mask), jnp.asarray(bg), jnp.float32(1.0),
        jnp.int32(i), jax.random.PRNGKey(0), jnp.float32(sched(1)), static,
        cfg=cfg, loss_fn=JaxLoss(**human_avatar.LOSS), width=S, height=S,
        backend="tiled", instance_budget=BUDGET)
    assert not bool(jaux["overflowed"]) and not bool(taux["overflowed"])
    _assert_losses(taux, jaux)
    _assert_human_close(run.tstate, js)


def test_eval_held_matches_jax():
    """The held-out PSNR of the carried-across avatar: the held frame
    (i % 6 == 3) rendered on black with its ground-truth pose."""
    from hugs_tpu.losses.basic import psnr
    from hugs_tpu.models import human_gs as jh
    from hugs_tpu.render import render
    (cfg, params, state, fixed), run, frames = _human_run()
    assert run.held_i == [3]
    pose, orient = human_avatar.gt_poses(3, F)

    @jax.jit
    def held(params, state, fixed, gt):
        out = jh.human_forward(params, state, fixed, cfg,
                               global_orient=jnp.asarray(orient),
                               body_pose=jnp.asarray(pose),
                               betas=jnp.zeros(10), transl=jnp.zeros(3),
                               smpl_scale=jnp.float32(1.0),
                               compute_gt_lbs=False)
        img = render(out["xyz"], out["scales"], out["rotq"], out["opacity"],
                     out["shs"], _jax_cams()[3], S, S, bg=jnp.zeros(3),
                     alive=out["alive"],
                     active_sh_degree=out["active_sh_degree"],
                     instance_budget=BUDGET, backend="tiled")["render"]
        return psnr(img, gt)

    want = float(held(params, state, fixed,
                      jnp.asarray(np_of(frames[3]["rgb"]))))
    got = human_avatar.eval_held(run)
    assert abs(got - want) <= 1e-4 and 5.0 < got < 60.0
