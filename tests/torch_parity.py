"""Shared inputs for the parity tests of hugs_tpu_torch against hugs_tpu.

Inputs are drawn with numpy from a seed and handed to both packages, so
both see the same bytes."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

W, H = 64, 48
FOVX, FOVY = 0.9, 0.7


def make_scene(n=300, seed=0):
    """Random Gaussian cloud in front of a camera at the origin looking
    down +z (the distribution of tests/test_pallas_blend.py)."""
    rng = np.random.default_rng(seed)
    means = rng.uniform(-1.0, 1.0, (n, 3)).astype(np.float32)
    means[:, 2] = means[:, 2] * 2.0 + 4.0
    scales = np.exp(rng.normal(size=(n, 3)) * 0.3 - 2.5).astype(np.float32)
    rotq = rng.normal(size=(n, 4)).astype(np.float32)
    rotq /= np.linalg.norm(rotq, axis=-1, keepdims=True)
    opacity = (1.0 / (1.0 + np.exp(-rng.normal(size=n)))).astype(np.float32)
    shs = (rng.normal(size=(n, 16, 3)) * 0.3).astype(np.float32)
    return dict(means=means, scales=scales, rotq=rotq, opacity=opacity,
                shs=shs)


def make_saturating_scene(seed=3):
    """Two depth layers of a dense, near-opaque splat grid over the whole
    image, so every pixel saturates (T < 1e-4) well before its list
    ends and the T_EPS indicator decides the result."""
    rng = np.random.default_rng(seed)
    gx, gy = np.meshgrid(np.linspace(0.0, W - 1.0, 24),
                         np.linspace(0.0, H - 1.0, 16))
    px = np.tile(gx.ravel(), 2)
    py = np.tile(gy.ravel(), 2)
    n = px.shape[0]
    z = np.concatenate([4.0 + rng.uniform(size=n // 2) * 0.2,
                        6.0 + rng.uniform(size=n // 2) * 0.2])
    tx, ty = np.tan(FOVX / 2), np.tan(FOVY / 2)
    mx = z * tx * ((2.0 * px + 1.0) / W - 1.0)
    my = z * ty * ((2.0 * py + 1.0) / H - 1.0)
    return dict(
        means=np.stack([mx, my, z], axis=-1).astype(np.float32),
        scales=np.full((n, 3), 0.4, np.float32),
        rotq=np.tile(np.array([1.0, 0, 0, 0], np.float32), (n, 1)),
        opacity=np.full((n,), 0.97, np.float32),
        shs=(rng.normal(size=(n, 16, 3)) * 0.3).astype(np.float32))


def to_jax(scene):
    return {k: jnp.asarray(v) for k, v in scene.items()}


def to_torch(scene):
    return {k: torch.as_tensor(v) for k, v in scene.items()}


def cameras(R=None, t=None, fovx=FOVX, fovy=FOVY):
    """The same camera in both packages: (hugs_tpu, hugs_tpu_torch)."""
    from hugs_tpu.render import make_camera as jax_camera
    from hugs_tpu_torch.render import make_camera
    R = np.eye(3, dtype=np.float32) if R is None else R
    t = np.zeros(3, np.float32) if t is None else t
    return (jax_camera(jnp.asarray(R), jnp.asarray(t), fovx, fovy),
            make_camera(R, t, fovx, fovy, device="cpu"))


def np_of(x):
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


@pytest.fixture
def cuda_device():
    """The first CUDA device; skips the test where there is none."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the GPU machine)")
    return torch.device("cuda", 0)


def jax_tree(x):
    """A JAX pytree of dicts and arrays as nested dicts of numpy arrays."""
    if isinstance(x, dict):
        return {k: jax_tree(v) for k, v in x.items()}
    return np.asarray(x)


def jax_human(vpb=12, capacity=None, n_frames=2, seed=0, **cfg_kw):
    """A small JAX avatar on synthetic_smpl(vpb): (cfg, smpl, params,
    state, fixed, init_values), betas drawn with numpy from `seed`, the
    nets from PRNGKey(seed), n_features 8 and a 32^2 triplane."""
    import jax
    from hugs_tpu.models import human_gs as jh
    from hugs_tpu.models.smpl import synthetic_smpl
    cfg = jh.HumanGSConfig(n_features=8, triplane_res=32, **cfg_kw)
    smpl = synthetic_smpl(verts_per_bone=vpb)
    betas = (np.random.default_rng(seed).normal(size=10) * 0.5).astype(
        np.float32)
    params, state, fixed, init_values = jh.init_human_gs(
        jax.random.PRNGKey(seed), cfg, smpl, smpl, jnp.asarray(betas),
        n_frames=n_frames, capacity=capacity)
    return cfg, smpl, params, state, fixed, init_values


def smpl_arrays(smpl):
    """The numpy arrays of every field of a JAX SMPLModel."""
    from hugs_tpu_torch.models.smpl import TENSOR_FIELDS
    out = {f: np.asarray(getattr(smpl, f)) for f in TENSOR_FIELDS}
    out.update(parents=smpl.parents, faces=smpl.faces)
    return out


def human_to_torch(cfg, smpl, params, state, device="cpu"):
    """The port's (cfg, params, state, fixed) of a JAX avatar: params and
    state through convert, fixed recomputed by the port from the
    converted body."""
    from hugs_tpu_torch import convert
    from hugs_tpu_torch.models import human_gs as th
    tparams = convert.human_gs_from_numpy(
        {f: jax_tree(getattr(params, f)) for f in params._fields}, device)
    tstate = convert.human_state_from_numpy(
        {f: np.asarray(getattr(state, f)) for f in state._fields}, device)
    tsmpl = convert.smpl_model_from_numpy(smpl_arrays(smpl), device)
    tfixed = th.compute_vitruvian(tsmpl, tparams.betas.detach())
    return human_cfg_to_torch(cfg), tparams, tstate, tfixed


def human_cfg_to_torch(cfg):
    """The port's HumanGSConfig of a JAX one. The JAX fields the port
    does not define (the SH settings of training) must hold their
    defaults: the port could not honour another value."""
    from hugs_tpu_torch.models import human_gs as th
    kw = cfg._asdict()
    ported = th.HumanGSConfig._fields
    for k, v in kw.items():
        if k not in ported and v != type(cfg)._field_defaults[k]:
            raise NotImplementedError(f"HumanGSConfig.{k}={v!r} is not ported")
    return th.HumanGSConfig(**{k: kw[k] for k in ported})


def jax_patch_draws(key, h, w, num_patches, patch_size):
    """The draws hugs_tpu's sample_patches makes from `key`
    (hugs_tpu/losses/sampler.py:33, :50, :57-60), as the port's
    PatchDraws of CPU tensors."""
    import jax
    from hugs_tpu_torch.losses.sampler import PatchDraws
    k_mode, k_pick, k_ux, k_uy = jax.random.split(key, 4)
    return PatchDraws(
        coin=torch.as_tensor(np.array(jax.random.uniform(k_mode))),
        gumbel=torch.as_tensor(np.array(jax.random.gumbel(k_pick,
                                                            (h * w,)))),
        ux=torch.as_tensor(np.array(jax.random.randint(
            k_ux, (num_patches,), 0, max(h - patch_size, 1)))).long(),
        uy=torch.as_tensor(np.array(jax.random.randint(
            k_uy, (num_patches,), 0, max(w - patch_size, 1)))).long())


def jax_loss_draws(key, loss_fn, shape, render_mode, has_lpips=True):
    """The draws hugs_tpu's HumanSceneLoss makes from `key`
    (hugs_tpu/losses/loss.py:85, :88, :106, :114), as the port's
    LossDraws; `loss_fn` is either package's HumanSceneLoss and
    has_lpips says whether the call has an LPIPS."""
    import jax
    from hugs_tpu_torch.losses.loss import LossDraws
    _, h, w = shape
    out = {}

    def draws(k_bg, k_patch):
        return (torch.as_tensor(np.array(jax.random.uniform(k_bg, shape))),
                jax_patch_draws(k_patch, h, w, loss_fn.num_patches,
                                loss_fn.patch_size))

    if loss_fn.l_lpips_w > 0.0 and has_lpips and render_mode != "scene":
        key, k_bg, k_patch = jax.random.split(key, 3)
        out["lpips_bg"], out["patches"] = draws(k_bg, k_patch)
    if loss_fn.l_humansep_w > 0.0 and render_mode == "human_scene":
        key, k_bg2, k_patch2 = jax.random.split(key, 3)
        if has_lpips and loss_fn.l_lpips_w > 0.0:
            out["lpips_bg_human"], out["patches_human"] = draws(k_bg2,
                                                                k_patch2)
    return LossDraws(**out)


def jax_lpips_to_torch(lp, device="cpu"):
    """The port's LPIPS of a JAX LPIPS, through convert."""
    from hugs_tpu_torch import convert
    return convert.lpips_from_numpy(
        [np.asarray(w) for w in lp.conv_weights],
        [np.asarray(b) for b in lp.conv_biases],
        [np.asarray(w) for w in lp.lin_weights], lp.has_pretrained, device)


def flat_tree(tree, prefix=""):
    """A nested dict of arrays (a JAX group) as {dotted name: numpy}; an
    array alone as {"": numpy}."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(flat_tree(v, f"{prefix}{k}."))
        return out
    return {prefix[:-1]: np.asarray(tree)}


def flat_group(group):
    """A port group (tensor, module, or a module's moments' dict) in
    flat_tree's layout."""
    if isinstance(group, torch.nn.Module):
        return {n: np_of(p) for n, p in group.named_parameters()}
    if isinstance(group, dict):
        out = {}
        for k, v in group.items():
            out.update({f"{k}.{n}" if n else k: a
                        for n, a in flat_group(v).items()})
        return out
    return {"": np_of(group)}


def jax_joint_to_numpy(jstate):
    """A hugs_tpu JointTrainState as the numpy trees
    convert.joint_state_from_numpy takes: (human, scene)."""
    def opt(o):
        return {"mu": jax_tree(dict(o.mu)), "nu": jax_tree(dict(o.nu)),
                "step": np.asarray(o.step)}
    h, s = jstate.human, jstate.scene
    human = {"params": {f: jax_tree(getattr(h.params, f))
                        for f in h.params._fields},
             "state": {f: np.asarray(getattr(h.state, f))
                       for f in h.state._fields},
             "opt": opt(h.opt)}
    scene = {"gs": {f: np.asarray(getattr(s.gs, f)) for f in s.gs._fields},
             "opt": opt(s.opt)}
    return human, scene


def _joint_sides(ts, js):
    from hugs_tpu_torch.models import human_gs as th
    from hugs_tpu_torch.models import scene_gs as tsg
    return (("human", ts.human, js.human, th.PARAM_GROUPS,
             lambda s: s.params, lambda s: s.state),
            ("scene", ts.scene, js.scene, tsg.PARAM_FIELDS,
             lambda s: s.gs, lambda s: s.gs))


def assert_joint_close(ts, js, p_rtol=0.0):
    """The port's JointTrainState against hugs_tpu's at the one-step
    bars: every parameter atol 1e-6 (plus p_rtol relative) where hugs_tpu's
    first moment is beyond rounding, 1e-7 (with eps 1e-15 an Adam step of
    a gradient within rounding of 0 moves a parameter by up to its rate
    either way); the first moments atol 1e-7 + rtol 1e-4, the second atol
    1e-12 + rtol 1e-4; the densification statistics atol 1e-6 + rtol
    1e-4; alive and the step counts exact."""
    for name, t, j, groups, params, stats in _joint_sides(ts, js):
        assert int(t.opt.step) == int(j.opt.step), name
        np.testing.assert_array_equal(np_of(stats(t).alive),
                                      np.asarray(stats(j).alive))
        for group in groups:
            p_t = flat_group(getattr(params(t), group))
            mu_t = flat_group(t.opt.mu[group])
            nu_t = flat_group(t.opt.nu[group])
            p_j = flat_tree(getattr(params(j), group))
            mu_j = flat_tree(j.opt.mu[group])
            nu_j = flat_tree(j.opt.nu[group])
            for key in mu_j:
                err = f"{name} {group}.{key}"
                np.testing.assert_allclose(mu_t[key], mu_j[key], atol=1e-7,
                                           rtol=1e-4, err_msg=err)
                np.testing.assert_allclose(nu_t[key], nu_j[key], atol=1e-12,
                                           rtol=1e-4, err_msg=err)
                hot = np.abs(mu_j[key]) > 1e-7
                np.testing.assert_allclose(p_t[key][hot], p_j[key][hot],
                                           atol=1e-6, rtol=p_rtol,
                                           err_msg=err)
        for f in ("xyz_gradient_accum", "denom", "max_radii2d"):
            np.testing.assert_allclose(
                np_of(getattr(stats(t), f)), np.asarray(getattr(stats(j), f)),
                atol=1e-6, rtol=1e-4, err_msg=f"{name} {f}")
