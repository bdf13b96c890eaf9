"""The port's avatar training against hugs_tpu's, on the tests' small
avatar (tests/torch_parity.py::jax_human: synthetic_smpl(12), capacity
512, n_features 8, a 32^2 triplane) carried across by convert, at 64x48
with LPIPS patches of 32 and the draws of hugs_tpu's keys.

- group Adam over nested groups (a module in the port, a nested dict in
  hugs_tpu): parameters and moments atol 1e-7 over three steps.
- masked_mse atol 1e-7; 20 distillation steps: the loss of each step
  rtol 1e-5, and every net parameter after them atol 2e-6 (20 steps of
  at most 1e-3 each, whose Adam directions agree to rounding).
- The plateau rule (`plateau_update`) against a numpy replay of
  hugs_tpu/train/human_step.py:104-109 on a loss sequence that drops the
  rate twice.
- One human_train_step (hugs_tpu's `tiled` backend; no tile can pass
  its 1024 cap with 288 Gaussians): the loss and each term atol 2e-5
  plus rtol 2e-6 (the LBS term is 1000 times a mean of 12,288 squared
  differences of skinning weights from a softmax at temperature 0.1, so
  about 33 here, where float32 rounding alone moves it by ~1e-6 of its
  value);
  the gradients before Adam atol 1e-6 and rtol 1e-4 against hugs_tpu's
  first moments / 0.1 (the same rounding on both sides); the parameters
  after Adam atol 1e-6 where |grad| > 1e-6 (tests/test_torch_train.py's
  rule: with eps 1e-15 Adam's first step is lr * sign(g), so a gradient
  within rounding of 0 may step +-lr either way); the moments atol 1e-7
  and rtol 1e-4 (mu) and 1e-4 relative (nu); the densification
  statistics atol 1e-6 and rtol 1e-4.
- 5 steps over two frames: the loss of each step atol 2e-5 plus rtol
  2e-6, as one step's; after them every parameter atol 1e-6 where the
  first moment is beyond rounding (|mu| > 1e-7, the one-step rule read
  through the moment), the moments and the densification statistics to
  the one-step bars.
- The LBS term after a distillation (1,000 hugs_tpu steps, carried
  across): 8 steps in both with no dead rows (capacity 288), 16 with
  87.5 % dead rows (capacity 2304, the chip path's share): the first
  step's loss and LBS term atol 2e-5 plus rtol 2e-6, every step's rtol
  1e-3 (the skinning softmax at temperature 0.1 amplifies rounding in
  the steps where a row's largest weight changes joint), and the LBS
  term rising at least tenfold in both.
- human_densify_step from a hot state with hugs_tpu's own split noise:
  alive and the counts exact, xyz, the multipliers and the xyz moments
  atol 1e-6.

A card-only test (marker `cuda`) holds one step on the card to the same
step on the CPU (train/human_check.py, at its bars).

The learning rates are the port's `HumanLR` on one side and
cfg_files/neuman/hugs_human.yaml's human.lr, read by hugs_tpu's config
loader, on the other.
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
from hugs_tpu.ops.rotations import axis_angle_to_rotation_6d, quat_to_matrix
from hugs_tpu.train.optim import (
    group_adam_init as jax_adam_init, group_adam_update as jax_adam_update,
)
from hugs_tpu_torch.convert import camera_from_numpy
from hugs_tpu_torch.losses.loss import HumanSceneLoss
from hugs_tpu_torch.models import human_gs as th
from hugs_tpu_torch.models.nets import TriPlane
from hugs_tpu_torch.train import human_check
from hugs_tpu_torch.train import human_step as tstep
from hugs_tpu_torch.train.optim import group_adam_init, group_adam_update
from torch_parity import (  # noqa: F401 (cuda_device: a fixture)
    H, W, cuda_device, human_to_torch, jax_human, jax_loss_draws,
    jax_lpips_to_torch, np_of,
)

CAP = 512
BUDGET = 1 << 14
PATCH = 32
LOSS_KW = dict(l_ssim_w=0.2, l_l1_w=0.8, l_lpips_w=1.0, l_lbs_w=1000.0,
               num_patches=4, patch_size=PATCH)
BG = np.ones(3, np.float32)        # white, as hugs_human.yaml trains
LOSS_TOL = dict(atol=2e-5, rtol=2e-6)
RECIPE = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "cfg_files", "neuman", "hugs_human.yaml")


def _jstep():
    """hugs_tpu's human_step, imported where it is used: hugs_tpu.models
    needs flax, which the GPU machine lacks, and the card test must
    collect there."""
    from hugs_tpu.train import human_step
    return human_step


def _flat(tree, prefix=""):
    """A nested dict of arrays (a JAX group) as {dotted name: numpy}."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}{k}."))
        return out
    return {prefix[:-1]: np.asarray(tree)}


def _tflat(group):
    """A port group (tensor, module, or its moments' dict) likewise."""
    if isinstance(group, torch.nn.Module):
        return {n: np_of(p) for n, p in group.named_parameters()}
    if isinstance(group, dict):
        out = {}
        for k, v in group.items():
            out.update({f"{k}.{n}" if n else k: a
                        for n, a in _tflat(v).items()})
        return out
    return {"": np_of(group)}


def _pair(seed=0, capacity=CAP, distill=0):
    """hugs_tpu's small avatar (cfg, smpl, params, state, fixed,
    init_values) with two frames of random poses, after `distill` steps
    of hugs_tpu's distill_init, and the port's copy of it (cfg, params,
    state, fixed)."""
    cfg, smpl, params, state, fixed, init_values = jax_human(
        vpb=12, capacity=capacity, n_frames=2, seed=seed)
    if distill:
        params = _jstep().distill_init(params, state, init_values, cfg,
                                       num_steps=distill, block=distill)
    rng = np.random.default_rng(seed + 1)
    pose = (rng.normal(size=(2, 23, 3)) * 0.2).astype(np.float32)
    orient = (rng.normal(size=(2, 1, 3)) * 0.1).astype(np.float32)
    params = params._replace(
        body_pose=axis_angle_to_rotation_6d(jnp.asarray(pose)).reshape(2, -1),
        global_orient=axis_angle_to_rotation_6d(
            jnp.asarray(orient)).reshape(2, 6),
        transl=jnp.asarray((rng.normal(size=(2, 3)) * 0.05).astype(
            np.float32)))
    tcfg, tparams, tstate, tfixed = human_to_torch(cfg, smpl, params, state)
    return (cfg, smpl, params, state, fixed, init_values), (
        tcfg, tparams, tstate, tfixed)


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
        tcam = camera_from_numpy({f: np.asarray(getattr(c["camera"], f))
                                  for f in c["camera"]._fields}, "cpu")
        out.append((c["camera"], tcam, gt, mask))
    return out


def _lrs():
    """hugs_tpu's rates from the recipe and the port's from HumanLR,
    which must agree."""
    from hugs_tpu.cfg.config import load_config
    static, sched = _jstep().make_human_lrs(
        load_config(RECIPE).human.lr, optim_pose=True, optim_trans=True)
    tstatic, tsched = tstep.make_human_lrs(optim_pose=True, optim_trans=True)
    assert tstatic == static
    for step in (0, 100, 20_000):
        np.testing.assert_allclose(float(tsched(step)), float(sched(step)),
                                   rtol=1e-6)
    return static, sched, tsched


def test_nested_group_adam_matches_jax():
    """A module group and a nested dict group take their group's rate
    in every leaf."""
    rng = np.random.default_rng(0)

    def draw(*shape):
        return rng.normal(size=shape).astype(np.float32)

    planes = {k: draw(4, 4, 2) for k in ("plane_xy", "plane_xz", "plane_yz")}
    nested = {"a": {"w": draw(3, 2), "b": draw(2)}, "c": draw(5)}
    jparams = {"tri": {k: jnp.asarray(v) for k, v in planes.items()},
               "nested": jax.tree.map(jnp.asarray, nested),
               "flat": jnp.asarray(draw(6))}
    tparams = {"tri": TriPlane(*(torch.as_tensor(planes[k]) for k in
                                 ("plane_xy", "plane_xz", "plane_yz"))),
               "nested": jax.tree.map(torch.as_tensor, nested),
               "flat": torch.as_tensor(np.array(jparams["flat"]))}
    lrs = {"tri": 0.01, "nested": 0.003}        # "flat" absent: frozen
    jopt = jax_adam_init(jparams)
    topt = group_adam_init(tparams)
    for _ in range(3):
        grads = jax.tree.map(lambda x: jnp.asarray(
            rng.normal(size=x.shape).astype(np.float32)), jparams)
        jparams, jopt = jax_adam_update(grads, jopt, jparams, lrs)
        tgrads = {"tri": {k: torch.as_tensor(np.asarray(v))
                          for k, v in grads["tri"].items()},
                  "nested": jax.tree.map(lambda x: torch.as_tensor(
                      np.asarray(x)), grads["nested"]),
                  "flat": torch.as_tensor(np.asarray(grads["flat"]))}
        with torch.no_grad():
            group_adam_update(tgrads, topt, tparams, lrs)
    for k in jparams:
        for name, want in _flat(jparams[k]).items():
            np.testing.assert_allclose(_tflat(tparams[k])[name], want,
                                       atol=1e-7, err_msg=f"{k}.{name}")
        for m in ("mu", "nu"):
            got = _tflat(getattr(topt, m)[k])
            for name, want in _flat(getattr(jopt, m)[k]).items():
                np.testing.assert_allclose(got[name], want, atol=1e-7,
                                           err_msg=f"{m} {k}.{name}")
    assert int(topt.step) == int(jopt.step) == 3
    np.testing.assert_array_equal(np_of(tparams["flat"]),
                                  np.asarray(jparams["flat"]))


def test_masked_mse_and_distillation_match_jax():
    jstep = _jstep()
    (cfg, _, params, state, _, init_values), (tcfg, tparams, tstate, _) = \
        _pair()
    rng = np.random.default_rng(2)
    pred = rng.normal(size=(CAP, 16, 3)).astype(np.float32)
    target = rng.normal(size=(CAP, 16, 3)).astype(np.float32)
    np.testing.assert_allclose(
        float(tstep.masked_mse(torch.as_tensor(pred), torch.as_tensor(target),
                               tstate.alive)),
        float(jstep.masked_mse(jnp.asarray(pred), jnp.asarray(target),
                               state.alive)), atol=1e-7)

    n = 20
    targets = {k: v for k, v in init_values.items() if k != "edges"}
    sched = jnp.array([jnp.inf, 0.0, 1e-3], jnp.float32)
    jts, jsched, jlosses = jstep._distill_block(
        jstep.init_human_train_state(params, state), targets, sched, cfg, n)
    ttargets = {k: torch.as_tensor(np.asarray(v)) for k, v in targets.items()}
    opt = group_adam_init({f: getattr(tparams, f) for f in th.NET_FIELDS})
    best = torch.tensor(float("inf"))
    patience = torch.zeros((), dtype=torch.int32)
    lr = torch.tensor(1e-3)
    losses = []
    for _ in range(n):
        loss = tstep.distill_step(tparams, tstate, opt, ttargets, lr, tcfg)
        best, patience, lr = tstep.plateau_update(best, patience, lr, loss)
        losses.append(float(loss))
    np.testing.assert_allclose(losses, np.asarray(jlosses), rtol=1e-5)
    assert losses[-1] < losses[0]
    np.testing.assert_allclose(
        [float(best), float(patience), float(lr)], np.asarray(jsched),
        rtol=1e-6)
    for f in th.NET_FIELDS:
        got = _tflat(getattr(tparams, f))
        for name, want in _flat(getattr(jts.params, f)).items():
            np.testing.assert_allclose(got[name], want, atol=2e-6,
                                       err_msg=f"{f}.{name}")

    # distill_init runs the same steps from the same start
    _, (_, tparams2, tstate2, _) = _pair()
    tstep.distill_init(tparams2, tstate2, {k: torch.as_tensor(np.asarray(v))
                                           for k, v in init_values.items()
                                           if k != "edges"}, tcfg,
                       num_steps=n)
    for f in th.NET_FIELDS:
        for name, a in _tflat(getattr(tparams2, f)).items():
            np.testing.assert_array_equal(a, _tflat(getattr(tparams, f))[name])


def test_plateau_rule_matches_numpy_replay():
    """hugs_tpu fixes the patience at 1000 inside _distill_block, so its
    rule is replayed here in numpy (human_step.py:104-109) on a loss
    that falls, stalls past the patience twice and rises."""
    losses = np.concatenate([np.linspace(1.0, 0.5, 50),
                             np.full(2100, 0.5) + 1e-10,
                             np.linspace(0.6, 0.7, 20)]).astype(np.float32)
    best, patience, lr = np.float32(np.inf), np.int32(0), np.float32(1e-3)
    want = []
    for loss in losses:
        improved = loss < best - np.float32(1e-9)
        best = np.minimum(best, loss)
        patience = np.int32(0) if improved else np.int32(patience + 1)
        drop = patience > 1000
        lr = np.float32(lr * 0.5) if drop else lr
        patience = np.int32(0) if drop else patience
        want.append((best, patience, lr))
    tb = torch.tensor(float("inf"))
    tp = torch.zeros((), dtype=torch.int32)
    tl = torch.tensor(1e-3)
    for i, loss in enumerate(losses):
        tb, tp, tl = tstep.plateau_update(tb, tp, tl, torch.tensor(loss))
        assert (float(tb), int(tp), float(tl)) == tuple(
            float(x) for x in want[i]), i
    assert tp.dtype == torch.int32
    assert float(tl) == np.float32(2.5e-4)      # dropped twice


def _jax_step(js, fixed, cfg, frame, idx, key, lr, static, lpips):
    jcam, _, gt, mask = _frame_of(frame)
    return _jstep().human_train_step(
        js, fixed, jcam, jnp.asarray(gt), jnp.asarray(mask), jnp.asarray(BG),
        jnp.float32(1.0), jnp.int32(idx), key, jnp.float32(lr), static,
        lpips, cfg=cfg, loss_fn=JaxLoss(**LOSS_KW), width=W, height=H,
        backend="tiled", instance_budget=BUDGET)


def _frame_of(i):
    return _frames()[i]


def _torch_step(ts, fixed, cfg, frame, idx, draws, lr, static, lpips):
    _, tcam, gt, mask = _frame_of(frame)
    return tstep.human_train_step(
        ts, fixed, tcam, torch.as_tensor(gt), torch.as_tensor(mask),
        torch.as_tensor(BG), torch.tensor(1.0), idx, draws, lr, static,
        lpips, cfg=cfg, loss_fn=HumanSceneLoss(**LOSS_KW), width=W,
        height=H, instance_budget=BUDGET)


def test_one_train_step_matches_jax():
    jstep = _jstep()
    (cfg, _, params, state, fixed, _), (tcfg, tparams, tstate, tfixed) = \
        _pair()
    jlp, tlp = _lpips_pair()
    static, jsched, tsched = _lrs()
    key = jax.random.PRNGKey(3)
    js = jstep.init_human_train_state(params, state)
    ts = tstep.init_human_train_state(tparams, tstate)
    draws = jax_loss_draws(key, JaxLoss(**LOSS_KW), (3, H, W), "human")

    # the port's stages: the gradients before Adam
    _, tcam, gt, mask = _frame_of(0)
    hook = torch.zeros((CAP, 2), requires_grad=True)
    pkg, out = tstep.human_render(ts, tfixed, tcam, torch.as_tensor(BG), hook,
                                  torch.tensor(1.0), 0, cfg=tcfg, width=W,
                                  height=H, instance_budget=BUDGET)
    img = pkg["render"].detach()
    assert int(pkg["visibility_filter"].sum()) > 200
    # pixels of exactly 1.0 (white background, no splat) inside the mask
    assert bool(((img == 1.0).all(0) & (torch.as_tensor(mask) > 0)).any())
    loss, loss_dict = tstep.human_loss(HumanSceneLoss(**LOSS_KW), draws,
                                       torch.as_tensor(gt),
                                       torch.as_tensor(mask),
                                       torch.as_tensor(BG), pkg, out, tlp)
    grads, hook_grad = tstep.human_grads(loss, tparams, hook)

    js2, jaux = _jax_step(js, fixed, cfg, 0, 0, key, jsched(0), static, jlp)
    ts2, taux = _torch_step(ts, tfixed, tcfg, 0, 0, draws, tsched(0), static,
                            tlp)
    assert not bool(jaux["overflowed"]) and not bool(taux["overflowed"])
    assert set(taux["loss_dict"]) == set(jaux["loss_dict"]) == {
        "l1", "ssim", "lpips_patch", "lbs"}
    for k, v in jaux["loss_dict"].items():
        np.testing.assert_allclose(float(loss_dict[k].detach()), float(v),
                                   **LOSS_TOL, err_msg=k)
        np.testing.assert_allclose(float(taux["loss_dict"][k]), float(v),
                                   **LOSS_TOL, err_msg=k)
    np.testing.assert_allclose(float(taux["loss"]), float(jaux["loss"]),
                               **LOSS_TOL)
    np.testing.assert_allclose(float(loss.detach()), float(taux["loss"]),
                               atol=0)
    assert int(taux["n_visible"]) == int(jaux["n_visible"])

    # gradients before Adam against hugs_tpu's mu / 0.1, then the step
    for group in th.PARAM_GROUPS:
        g = _tflat(grads[group])
        mu_t = _tflat(ts2.opt.mu[group])
        nu_t = _tflat(ts2.opt.nu[group])
        p_t = _tflat(getattr(ts2.params, group)
                     if isinstance(getattr(ts2.params, group),
                                   torch.nn.Module)
                     else getattr(ts2.params, group))
        mu_j = _flat(getattr(js2.opt, "mu")[group])
        nu_j = _flat(getattr(js2.opt, "nu")[group])
        p_j = _flat(getattr(js2.params, group))
        for name in mu_j:
            tname = name if name in g else ""
            want_g = mu_j[name] / np.float32(0.1)
            err = f"{group}.{name}"
            np.testing.assert_allclose(g[tname], want_g, atol=1e-6,
                                       rtol=1e-4, err_msg=err)
            np.testing.assert_allclose(mu_t[tname], mu_j[name], atol=1e-7,
                                       rtol=1e-4, err_msg=err)
            np.testing.assert_allclose(nu_t[tname], nu_j[name], atol=1e-12,
                                       rtol=1e-4, err_msg=err)
            moved = np.abs(want_g) > 1e-6
            np.testing.assert_allclose(p_t[tname][moved], p_j[name][moved],
                                       atol=1e-6, err_msg=err)
    np.testing.assert_allclose(np_of(hook_grad).sum() != 0, True)
    for f in ("xyz_gradient_accum", "denom", "max_radii2d"):
        np.testing.assert_allclose(np_of(getattr(ts2.state, f)),
                                   np.asarray(getattr(js2.state, f)),
                                   atol=1e-6, rtol=1e-4, err_msg=f)
    for k in ("opacity", "scales_canon", "rotmat_canon"):
        np.testing.assert_allclose(np_of(taux[k]), np.asarray(jaux[k]),
                                   atol=1e-6, err_msg=k)


def _run(js, ts, pair, n, lpips, lrs):
    """n steps over two frames in both, new draws each step. Returns the
    states and each step's (hugs_tpu's, the port's) loss and LBS term."""
    (cfg, _, _, _, fixed, _), (tcfg, _, _, tfixed) = pair
    static, jsched, tsched = lrs
    rows = []
    for step in range(n):
        key = jax.random.PRNGKey(100 + step)
        draws = jax_loss_draws(key, JaxLoss(**LOSS_KW), (3, H, W), "human")
        i = step % 2
        js, jaux = _jax_step(js, fixed, cfg, i, i, key, jsched(step), static,
                             lpips[0])
        ts, taux = _torch_step(ts, tfixed, tcfg, i, i, draws, tsched(step),
                               static, lpips[1])
        assert not bool(jaux["overflowed"]) and not bool(taux["overflowed"])
        rows.append([(float(a["loss"]), float(a["loss_dict"]["lbs"]))
                     for a in (jaux, taux)])
    return js, ts, np.asarray(rows)         # (n, 2 sides, loss / lbs)


def test_training_trajectory_matches_jax():
    """5 steps over two frames, new draws each step."""
    jstep = _jstep()
    pair = _pair()
    (_, _, params, state, _, _), (_, tparams, tstate, _) = pair
    js = jstep.init_human_train_state(params, state)
    ts = tstep.init_human_train_state(tparams, tstate)
    js, ts, rows = _run(js, ts, pair, 5, _lpips_pair(), _lrs())
    for step, (want, got) in enumerate(rows):
        np.testing.assert_allclose(got, want, **LOSS_TOL,
                                   err_msg=f"step {step}")
    assert int(ts.opt.step) == int(js.opt.step) == 5
    for group in th.PARAM_GROUPS:
        p_t = _tflat(getattr(ts.params, group))
        mu_t, nu_t = _tflat(ts.opt.mu[group]), _tflat(ts.opt.nu[group])
        p_j = _flat(getattr(js.params, group))
        mu_j, nu_j = _flat(js.opt.mu[group]), _flat(js.opt.nu[group])
        for name in mu_j:
            tname = name if name in mu_t else ""
            err = f"{group}.{name}"
            np.testing.assert_allclose(mu_t[tname], mu_j[name], atol=1e-7,
                                       rtol=1e-4, err_msg=err)
            np.testing.assert_allclose(nu_t[tname], nu_j[name], atol=1e-12,
                                       rtol=1e-4, err_msg=err)
            moved = np.abs(mu_j[name]) > 1e-7
            np.testing.assert_allclose(p_t[tname][moved], p_j[name][moved],
                                       atol=1e-6, err_msg=err)
    for f in ("xyz_gradient_accum", "denom", "max_radii2d"):
        np.testing.assert_allclose(np_of(getattr(ts.state, f)),
                                   np.asarray(getattr(js.state, f)),
                                   atol=1e-6, rtol=1e-4, err_msg=f)


@pytest.mark.parametrize("capacity,steps", [(288, 8), (2304, 16)],
                         ids=["no_dead_rows", "dead_rows_87pct"])
def test_lbs_term_after_distillation_matches_jax(capacity, steps):
    """After the distillation, hugs_tpu's LBS term rises in the first
    steps of training, with dead rows or without; the port's rises with
    it, step for step."""
    jstep = _jstep()
    pair = _pair(capacity=capacity, distill=1000)
    (_, _, params, state, _, _), (_, tparams, tstate, _) = pair
    assert int(np.asarray(state.alive).sum()) == 288
    js = jstep.init_human_train_state(params, state)
    ts = tstep.init_human_train_state(tparams, tstate)
    _, _, rows = _run(js, ts, pair, steps, _lpips_pair(), _lrs())
    want, got = rows[:, 0], rows[:, 1]
    np.testing.assert_allclose(got[0], want[0], **LOSS_TOL)
    np.testing.assert_allclose(got, want, rtol=1e-3)
    assert want[:, 1].max() > 10 * want[0, 1]       # hugs_tpu's term rises
    assert got[:, 1].max() > 10 * got[0, 1]         # and the port's


def test_densify_step_matches_jax():
    jstep = _jstep()
    (cfg, smpl, params, state, _, _), _ = _pair()
    rng = np.random.default_rng(4)
    alive = rng.uniform(size=CAP) < 0.85
    state = state._replace(
        alive=jnp.asarray(alive),
        scaling_multiplier=jnp.asarray(rng.uniform(0.5, 1.5, (CAP, 1))
                                       .astype(np.float32)),
        xyz_gradient_accum=jnp.asarray(rng.uniform(0, 2e-3, CAP).astype(
            np.float32)),
        denom=jnp.asarray(rng.integers(1, 5, CAP).astype(np.float32)),
        max_radii2d=jnp.asarray(rng.uniform(0, 22, CAP).astype(np.float32)))
    params = params._replace(xyz=jnp.asarray(rng.normal(size=(CAP, 3))
                                             .astype(np.float32)))
    js = jstep.init_human_train_state(params, state)
    mu = rng.normal(size=(CAP, 3)).astype(np.float32)
    nu = rng.uniform(size=(CAP, 3)).astype(np.float32)
    js = js._replace(opt=js.opt._replace(
        mu={**js.opt.mu, "xyz": jnp.asarray(mu)},
        nu={**js.opt.nu, "xyz": jnp.asarray(nu)}))
    _, tparams, tstate, _ = human_to_torch(cfg, smpl, params, state)
    ts = tstep.init_human_train_state(tparams, tstate)
    ts.opt.mu["xyz"].copy_(torch.as_tensor(mu))
    ts.opt.nu["xyz"].copy_(torch.as_tensor(nu))
    # the decoded attributes the criteria read: some faint, some small
    # (cloned), some large and elongated (split)
    scales = np.exp(rng.normal(size=(CAP, 3)) * 0.8 - 4.5).astype(np.float32)
    q = rng.normal(size=(CAP, 4)).astype(np.float32)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    rot = np.asarray(quat_to_matrix(jnp.asarray(q)))
    opac = rng.uniform(0.003, 0.05, CAP).astype(np.float32)
    out = {"opacity": opac, "scales_canon": scales, "rotmat_canon": rot}
    key = jax.random.PRNGKey(6)
    kw = dict(grad_threshold=0.0002, min_opacity=0.005, max_screen_size=20.0,
              percent_dense=0.01, max_n_gaussians=CAP)
    js2, jinfo = jstep.human_densify_step(
        js, {k: jnp.asarray(v) for k, v in out.items()}, key, 1.0, **kw)
    noise = np.asarray(jax.random.normal(key, (2, CAP, 3)))   # human_gs.py:516
    ts2, tinfo = tstep.human_densify_step(
        ts, {k: torch.as_tensor(v) for k, v in out.items()},
        torch.as_tensor(noise), 1.0, **kw)
    for k in ("n_cloned", "n_split", "n_pruned", "n_alive"):
        assert int(tinfo[k]) == int(jinfo[k]), k
    assert int(jinfo["n_cloned"]) > 0 and int(jinfo["n_split"]) > 0
    assert int(jinfo["n_pruned"]) > 0 and int(tinfo["n_dropped"]) > 0
    np.testing.assert_array_equal(np_of(ts2.state.alive),
                                  np.asarray(js2.state.alive))
    np.testing.assert_allclose(np_of(ts2.params.xyz),
                               np.asarray(js2.params.xyz), atol=1e-6)
    np.testing.assert_allclose(np_of(ts2.state.scaling_multiplier),
                               np.asarray(js2.state.scaling_multiplier),
                               atol=1e-6)
    for m in ("mu", "nu"):
        np.testing.assert_allclose(np_of(getattr(ts2.opt, m)["xyz"]),
                                   np.asarray(getattr(js2.opt, m)["xyz"]),
                                   atol=1e-6, err_msg=m)
    for f in ("xyz_gradient_accum", "denom", "max_radii2d"):
        assert not np_of(getattr(ts2.state, f)).any()
    # the SH ramp: up by one, held at the ceiling
    for _ in range(3):
        th.one_up_sh_degree(ts2.state, 2)
    assert int(ts2.state.active_sh_degree) == 2


@pytest.mark.cuda
def test_train_step_on_card_matches_cpu(cuda_device):
    """One human_train_step's loss, terms and gradients on the card (K1
    and K2) against the same step on the CPU (the plain blend), from the
    same port-built avatar, state and draws."""
    torch.backends.cuda.matmul.allow_tf32 = False
    human_check.compare_steps(human_check.small_step(cuda_device, 5),
                              human_check.small_step("cpu", 5))
