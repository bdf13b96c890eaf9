"""The port's training loss of the avatar against hugs_tpu's, on the same
numpy inputs and the same random draws (recomputed with jax.random from
the key hugs_tpu splits, and handed to the port as tensors).

- sample_patches: the crops exactly equal, in the mask mode (with and
  without dilation, odd and even windows), the uniform mode and the
  fallback to uniform corners where the mask has too few valid centres.
- LPIPS (hugs_tpu's He-initialised arrays carried across by
  convert.lpips_from_numpy, and an .npz loaded by both): values atol
  2e-5, d/d(img1) atol 1e-6 and rtol 1e-4; crop_call likewise, and
  equal to the port's own call on the cropped arrays atol 1e-6.
- HumanSceneLoss in the human, scene and human_scene modes (the last
  with the separate human pass) and with whole-image LPIPS, with the LBS
  term: the total and every term atol 2e-5; the gradients with respect
  to the rendered images and the predicted skinning weights atol 1e-6
  and rtol 1e-4. The rendered image holds pixels of exactly 1.0 inside
  the sampled patches, where the clip's gradient is 0.5.

Card-only tests (marker `cuda`) hold the sampler, LPIPS and the loss on
the card to the CPU.
"""
import copy
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hugs_tpu.losses.loss import HumanSceneLoss as JaxLoss
from hugs_tpu.losses.lpips import LPIPS as JaxLPIPS
from hugs_tpu.losses.sampler import sample_patches as jax_sample_patches
from hugs_tpu_torch.losses.loss import HumanSceneLoss, LossDraws, clip_max1
from hugs_tpu_torch.losses.lpips import LPIPS, VGG_BLOCKS
from hugs_tpu_torch.losses.sampler import (
    draw_patch_randoms, sample_patches,
)
from torch_parity import (  # noqa: F401 (cuda_device: a fixture)
    H, W, cuda_device, jax_loss_draws, jax_lpips_to_torch, jax_patch_draws,
    np_of,
)

PATCH = 32
N_PATCHES = 4
VALUE_ATOL = 2e-5
GRAD_ATOL, GRAD_RTOL = 1e-6, 1e-4


def _mask(kind):
    m = np.zeros((H, W), np.float32)
    if kind == "few":
        # two valid centres only (rows and columns 16..32 and 16..48 are
        # the centres a 32-patch may take)
        m[20, 30] = m[25, 40] = 1.0
    else:
        m[12:38, 18:52] = 1.0
        m[5:8, 2:5] = 1.0       # outside the centres' border
    return m


CASES = {"mask": (1.0, 0, "body"), "mask_dilate5": (1.0, 5, "body"),
         "mask_dilate4": (1.0, 4, "few"), "uniform": (0.0, 0, "body"),
         "fallback": (1.0, 0, "few")}


@pytest.mark.parametrize("case", sorted(CASES))
def test_sample_patches_matches_jax(case):
    ratio, dilate, kind = CASES[case]
    rng = np.random.default_rng(1)
    img = rng.uniform(size=(3, H, W)).astype(np.float32)
    aux = rng.normal(size=(1, H, W)).astype(np.float32)
    mask = _mask(kind)
    key = jax.random.PRNGKey(7)
    want = jax_sample_patches(key, jnp.asarray(mask),
                              [jnp.asarray(img), jnp.asarray(aux)],
                              N_PATCHES, PATCH, ratio, dilate)
    got = sample_patches(jax_patch_draws(key, H, W, N_PATCHES, PATCH),
                         torch.as_tensor(mask), [torch.as_tensor(img),
                                                 torch.as_tensor(aux)],
                         N_PATCHES, PATCH, ratio, dilate)
    for g, w in zip(got, want):
        assert g.shape == w.shape == (N_PATCHES, g.shape[1], PATCH, PATCH)
        np.testing.assert_array_equal(np_of(g), np.asarray(w))
    # the crops are distinct, and in the uniform and fallback cases they
    # sit at the uniform corners
    assert len({np_of(g).tobytes() for g in got[0]}) == N_PATCHES
    if case in ("uniform", "fallback"):
        d = jax_patch_draws(key, H, W, N_PATCHES, PATCH)
        for i in range(N_PATCHES):
            x, y = int(d.ux[i]), int(d.uy[i])
            np.testing.assert_array_equal(
                np_of(got[0][i]), img[:, x:x + PATCH, y:y + PATCH])


def test_draw_patch_randoms_shapes_and_ranges():
    gen = torch.Generator().manual_seed(0)
    d = draw_patch_randoms(gen, H, W, N_PATCHES, PATCH, device="cpu")
    assert d.coin.shape == () and 0.0 <= float(d.coin) < 1.0
    assert d.gumbel.shape == (H * W,) and bool(torch.isfinite(d.gumbel).all())
    assert abs(float(d.gumbel.mean()) - 0.5772) < 0.1   # Euler's gamma
    assert int(d.ux.max()) < H - PATCH and int(d.uy.max()) < W - PATCH
    assert int(d.ux.min()) >= 0 and int(d.uy.min()) >= 0


@functools.lru_cache(maxsize=None)
def _lpips_pair():
    lp = JaxLPIPS.create(seed=0)
    return lp, jax_lpips_to_torch(lp)


def _images(seed, shape=(2, 3, 32, 32)):
    rng = np.random.default_rng(seed)
    return (rng.uniform(size=shape).astype(np.float32),
            rng.uniform(size=shape).astype(np.float32))


def test_lpips_call_and_crop_call_match_jax():
    jlp, tlp = _lpips_pair()
    a, b = _images(2)
    val, grad = jax.jit(jax.value_and_grad(
        lambda x, y: jnp.sum(jlp(x, y) * jnp.array([1.0, 2.0]))))(
        jnp.asarray(a), jnp.asarray(b))
    x = torch.as_tensor(a).requires_grad_()
    tval = torch.sum(tlp(x, torch.as_tensor(b)) * torch.tensor([1.0, 2.0]))
    (tgrad,) = torch.autograd.grad(tval, x)
    np.testing.assert_allclose(float(tval.detach()), float(val),
                               atol=VALUE_ATOL)
    assert float(jnp.abs(grad).max()) > 1e-5
    np.testing.assert_allclose(np_of(tgrad), np.asarray(grad),
                               atol=GRAD_ATOL, rtol=GRAD_RTOL)

    # the exact crop LPIPS at odd extents
    h, w = 27, 21
    cval, cgrad = jax.jit(jax.value_and_grad(
        lambda x, y: jnp.sum(jlp.crop_call(x, y, h, w))))(
        jnp.asarray(a), jnp.asarray(b))
    x = torch.as_tensor(a).requires_grad_()
    tc = tlp.crop_call(x, torch.as_tensor(b), h, w)
    (tcgrad,) = torch.autograd.grad(torch.sum(tc), x)
    np.testing.assert_allclose(float(torch.sum(tc)), float(cval),
                               atol=VALUE_ATOL)
    np.testing.assert_allclose(np_of(tcgrad), np.asarray(cgrad),
                               atol=GRAD_ATOL, rtol=GRAD_RTOL)
    with torch.no_grad():
        alone = tlp(torch.as_tensor(a[:, :, :h, :w]),
                    torch.as_tensor(b[:, :, :h, :w]))
    np.testing.assert_allclose(np_of(tc), np_of(alone), atol=1e-6)
    assert not bool(torch.isclose(tc, tlp(x, torch.as_tensor(b))).any())


def test_lpips_npz_round_trip_and_fallback(tmp_path):
    """An .npz in the JAX package's layout loads into both packages with
    the same values; without one, the port draws He-initialised convs
    and uniform heads and says it has no pretrained weights."""
    rng = np.random.default_rng(3)
    arrays, cin, i = {}, 3, 0
    for t, (cout, n) in enumerate(VGG_BLOCKS):
        for _ in range(n):
            arrays[f"conv_{i}_w"] = (rng.normal(size=(3, 3, cin, cout))
                                     * np.sqrt(2.0 / (9 * cin))).astype(
                                         np.float32)
            arrays[f"conv_{i}_b"] = (rng.normal(size=cout) * 0.1).astype(
                np.float32)
            cin, i = cout, i + 1
        arrays[f"lin_{t}"] = np.abs(rng.normal(size=cout)).astype(np.float32)
    path = str(tmp_path / "lpips.npz")
    np.savez(path, **arrays)
    jlp = JaxLPIPS.create(path)
    tlp = LPIPS.create(path, device="cpu")
    assert jlp.has_pretrained and tlp.has_pretrained
    np.testing.assert_array_equal(np_of(tlp.conv_3_w),
                                  arrays["conv_3_w"].transpose(3, 2, 0, 1))
    np.testing.assert_array_equal(np_of(tlp.lin_4), arrays["lin_4"])
    a, b = _images(4, (1, 3, 24, 40))
    np.testing.assert_allclose(
        np_of(tlp(torch.as_tensor(a), torch.as_tensor(b))),
        np.asarray(jlp(jnp.asarray(a), jnp.asarray(b))), atol=VALUE_ATOL)

    fb = LPIPS.create(str(tmp_path / "missing.npz"), seed=1, device="cpu")
    assert not fb.has_pretrained
    w = np_of(fb.conv_12_w)
    assert w.shape == (512, 512, 3, 3)
    np.testing.assert_allclose(w.std(), np.sqrt(2.0 / (9 * 512)), rtol=0.02)
    np.testing.assert_array_equal(np_of(fb.lin_0), np.full(64, 1.0 / 64,
                                                           np.float32))


def test_clip_max1_gradient_is_half_at_one():
    x = torch.tensor([0.5, 1.0, 1.5], requires_grad=True)
    (g,) = torch.autograd.grad(clip_max1(x).sum(), x)
    want = jax.grad(lambda v: jnp.sum(jnp.clip(v, max=1.0)))(
        jnp.array([0.5, 1.0, 1.5]))
    np.testing.assert_array_equal(np_of(g), np.asarray(want))
    assert float(g[1]) == 0.5


def _loss_inputs(seed=5):
    """A rendered image with a plateau of exactly 1.0 inside the mask (a
    white background where no splat lands), its separate human pass, a
    target, a soft-edged mask and skinning weights."""
    rng = np.random.default_rng(seed)
    pred = rng.uniform(size=(3, H, W)).astype(np.float32)
    pred[:, 14:36, 20:50] = 1.0
    human = rng.uniform(size=(3, H, W)).astype(np.float32)
    human[:, 14:36, 20:50] = 1.0
    gt = rng.uniform(size=(3, H, W)).astype(np.float32)
    mask = _mask("body")
    lbs = rng.dirichlet(np.ones(24), size=50).astype(np.float32)
    gt_lbs = rng.dirichlet(np.ones(24), size=50).astype(np.float32)
    bg = np.array([1.0, 1.0, 1.0], np.float32)
    return pred, human, gt, mask, lbs, gt_lbs, bg


LOSS_MODES = {"human": ("human", True), "scene": ("scene", True),
              "human_scene": ("human_scene", True),
              "human_whole_image": ("human", False)}


@pytest.mark.parametrize("case", sorted(LOSS_MODES))
def test_human_scene_loss_matches_jax(case):
    mode, use_patches = LOSS_MODES[case]
    jlp, tlp = _lpips_pair()
    kw = dict(l_ssim_w=0.2, l_l1_w=0.8, l_lpips_w=1.0, l_lbs_w=1000.0,
              l_humansep_w=0.5 if mode == "human_scene" else 0.0,
              num_patches=N_PATCHES, patch_size=PATCH,
              use_patches=use_patches)
    jloss = JaxLoss(lpips=jlp, **kw)
    tloss = HumanSceneLoss(lpips=tlp, **kw)
    pred, human, gt, mask, lbs, gt_lbs, bg = _loss_inputs()
    key = jax.random.PRNGKey(11)

    def jax_total(p, hi, lw):
        total, ld, _ = jloss(
            key, {"rgb": jnp.asarray(gt), "mask": jnp.asarray(mask)},
            {"render": p, "human_img": hi},
            {"lbs_weights": lw, "gt_lbs_weights": jnp.asarray(gt_lbs)},
            render_mode=mode, bg_color=jnp.asarray(bg),
            human_bg_color=jnp.asarray(bg) * 0.5)
        return total, ld

    (jt, jld), jgrads = jax.jit(jax.value_and_grad(
        jax_total, argnums=(0, 1, 2), has_aux=True))(
        jnp.asarray(pred), jnp.asarray(human), jnp.asarray(lbs))

    draws = jax_loss_draws(key, jloss, pred.shape, mode)
    ins = [torch.as_tensor(a).requires_grad_() for a in (pred, human, lbs)]
    tt, tld, _ = tloss(
        draws, {"rgb": torch.as_tensor(gt), "mask": torch.as_tensor(mask)},
        {"render": ins[0], "human_img": ins[1]},
        {"lbs_weights": ins[2], "gt_lbs_weights": torch.as_tensor(gt_lbs)},
        render_mode=mode, bg_color=torch.as_tensor(bg),
        human_bg_color=torch.as_tensor(bg) * 0.5)
    assert sorted(tld) == sorted(jld)
    expected = {"human": {"l1", "ssim", "lpips_patch", "lbs"},
                "scene": {"l1", "ssim"},
                "human_scene": {"l1", "ssim", "lpips_patch", "lbs",
                                "l1_human", "ssim_human",
                                "lpips_patch_human"},
                "human_whole_image": {"l1", "ssim", "lpips", "lbs"}}[case]
    assert set(tld) == expected
    for k in jld:
        np.testing.assert_allclose(float(tld[k].detach()), float(jld[k]),
                                   atol=VALUE_ATOL, err_msg=k)
    np.testing.assert_allclose(float(tt.detach()), float(jt), atol=VALUE_ATOL)

    tgrads = torch.autograd.grad(tt, ins, allow_unused=True)
    for name, g, want in zip(("render", "human_img", "lbs_weights"), tgrads,
                             jgrads):
        want = np.asarray(want)
        got = np.zeros_like(want) if g is None else np_of(g)
        np.testing.assert_allclose(got, want, atol=GRAD_ATOL, rtol=GRAD_RTOL,
                                   err_msg=name)
    if draws.patches is not None:
        # a sampled patch holds pixels of exactly 1.0 inside the mask,
        # where both packages' clip passes half the gradient
        crops = sample_patches(draws.patches, torch.as_tensor(mask),
                               [torch.as_tensor(pred),
                                torch.as_tensor(mask)[None]],
                               N_PATCHES, PATCH)
        assert bool(((crops[0] == 1.0) & (crops[1] > 0)).any())


@pytest.mark.cuda
def test_sampler_and_lpips_on_card_match_cpu(cuda_device):
    _, tlp = _lpips_pair()
    card = copy.deepcopy(tlp).to(cuda_device)
    a, b = _images(6, (4, 3, 128, 128))
    allow = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = True    # the module turns it off
    try:
        got = card(torch.as_tensor(a, device=cuda_device),
                   torch.as_tensor(b, device=cuda_device))
    finally:
        torch.backends.cudnn.allow_tf32 = allow
    want = tlp(torch.as_tensor(a), torch.as_tensor(b))
    np.testing.assert_allclose(np_of(got), np_of(want), atol=VALUE_ATOL)
    mask = torch.as_tensor(_mask("body"))
    d = draw_patch_randoms(torch.Generator().manual_seed(1), H, W, N_PATCHES,
                           PATCH, device="cpu")
    img = torch.rand((3, H, W))
    on_card = sample_patches(
        type(d)(*(x.to(cuda_device) for x in d)), mask.to(cuda_device),
        [img.to(cuda_device)], N_PATCHES, PATCH)[0]
    np.testing.assert_array_equal(
        np_of(on_card), np_of(sample_patches(d, mask, [img], N_PATCHES,
                                             PATCH)[0]))


@pytest.mark.cuda
def test_loss_on_card_matches_cpu(cuda_device):
    _, tlp = _lpips_pair()
    kw = dict(l_lpips_w=1.0, l_lbs_w=1000.0, num_patches=N_PATCHES,
              patch_size=PATCH)
    pred, _, gt, mask, lbs, gt_lbs, bg = _loss_inputs()
    d = HumanSceneLoss(**kw).draws(torch.Generator().manual_seed(2), H, W,
                                   "human", device="cpu")

    def run(dev):
        lf = HumanSceneLoss(lpips=copy.deepcopy(tlp).to(dev), **kw)
        p = torch.as_tensor(pred, device=dev).requires_grad_()
        dd = LossDraws(d.lpips_bg.to(dev),
                       type(d.patches)(*(x.to(dev) for x in d.patches)))
        total, _, _ = lf(dd, {"rgb": torch.as_tensor(gt, device=dev),
                              "mask": torch.as_tensor(mask, device=dev)},
                         {"render": p},
                         {"lbs_weights": torch.as_tensor(lbs, device=dev),
                          "gt_lbs_weights": torch.as_tensor(gt_lbs,
                                                            device=dev)},
                         "human", bg_color=torch.as_tensor(bg, device=dev))
        return total.detach(), torch.autograd.grad(total, p)[0]

    t_card, g_card = run(cuda_device)
    t_cpu, g_cpu = run("cpu")
    np.testing.assert_allclose(float(t_card), float(t_cpu), atol=VALUE_ATOL)
    np.testing.assert_allclose(np_of(g_card), np_of(g_cpu), atol=GRAD_ATOL,
                               rtol=GRAD_RTOL)
