"""The human / scene training loss (HUGS's HumanSceneLoss), plain PyTorch.

Mode-dependent masking, L1 + SSIM scaled by the mask's area, patch
LPIPS on images composited over a random background, the optional
losses of a separate human pass, and the regression of the predicted
skinning weights to the kNN-transferred ones. `HumanSceneLoss` is a
configuration; calling it computes the loss from the data, the render
and the random draws, which the caller makes (`LossDraws`,
`HumanSceneLoss.draws`) so that a test can hand the JAX package's draws to
the port.

Every clip of a prediction to at most 1 is torch.minimum against 1,
whose gradient at exactly 1 is 0.5, as jnp.clip's is; torch.clamp's is
1. Pixels of exactly 1 are common on a white background.
"""
from __future__ import annotations

from typing import Any, NamedTuple

import torch

from bench_port.reference.plain.losses.basic import l1_loss, ssim
from bench_port.reference.plain.losses.lpips import LPIPS
from bench_port.reference.plain.losses.sampler import (
    PatchDraws, draw_patch_randoms, sample_patches,
)


def clip_max1(x: torch.Tensor) -> torch.Tensor:
    """min(x, 1) with jnp.clip's gradient, 0.5 at exactly 1."""
    return torch.minimum(x, x.new_ones(()))


class LossDraws(NamedTuple):
    """The random draws of one loss call: the LPIPS background (3, H, W)
    uniform [0, 1) and the patch draws, for the main pass and for the
    separate human pass (None where a term does not run)."""
    lpips_bg: torch.Tensor | None = None
    patches: PatchDraws | None = None
    lpips_bg_human: torch.Tensor | None = None
    patches_human: PatchDraws | None = None


class HumanSceneLoss(NamedTuple):
    l_ssim_w: float = 0.2
    l_l1_w: float = 0.8
    l_lpips_w: float = 0.0
    l_lbs_w: float = 0.0
    l_humansep_w: float = 0.0
    num_patches: int = 4
    patch_size: int = 128
    use_patches: bool = True
    lpips: LPIPS | None = None

    def draws(self, generator: torch.Generator, height: int, width: int,
              render_mode: str,
              device: torch.device | str = "cuda") -> LossDraws:
        """The draws one call in `render_mode` reads, from `generator`
        (those of the LPIPS terms whatever the loss's own lpips: the
        training step takes its LPIPS as an argument)."""
        def bg():
            return torch.rand((3, height, width), generator=generator,
                              device=generator.device).to(device)

        def patches():
            return draw_patch_randoms(generator, height, width,
                                      self.num_patches, self.patch_size,
                                      device)

        out = {}
        if self.l_lpips_w > 0.0 and render_mode != "scene":
            out.update(lpips_bg=bg(), patches=patches())
        if self.l_lpips_w > 0.0 and self.l_humansep_w > 0.0 \
                and render_mode == "human_scene":
            out.update(lpips_bg_human=bg(), patches_human=patches())
        return LossDraws(**out)

    def _patch_lpips(self, patches: PatchDraws, mask, pred, gt):
        pred_p, gt_p = sample_patches(patches, mask, [pred, gt],
                                      num_patches=self.num_patches,
                                      patch_size=self.patch_size)
        return torch.mean(self.lpips(clip_max1(pred_p), gt_p))

    def __call__(
        self,
        draws: LossDraws,
        data: dict[str, Any],
        render_pkg: dict[str, Any],
        human_gs_out: dict[str, Any] | None,
        render_mode: str,
        human_gs_init_values: dict[str, Any] | None = None,
        bg_color: torch.Tensor | None = None,
        human_bg_color: torch.Tensor | None = None,
    ):
        """Returns (total, loss_dict, extras). data: {'rgb': (3, H, W),
        'mask': (H, W) or (1, H, W)}; render_pkg: {'render': (3, H, W),
        and 'human_img' for the separate human pass}."""
        loss_dict: dict[str, torch.Tensor] = {}
        extras: dict[str, Any] = {}
        if human_bg_color is None:
            human_bg_color = bg_color

        gt_image = data["rgb"]
        mask = data["mask"]
        if mask.dim() == 2:
            mask = mask[None]
        pred_img = render_pkg["render"]

        if render_mode == "human":
            gt_image = gt_image * mask + human_bg_color[:, None, None] * (
                1.0 - mask)
        elif render_mode == "scene":
            inv = 1.0 - mask
            gt_image = gt_image * inv
            pred_img = pred_img * inv
        extras["gt_img"] = gt_image
        extras["pred_img"] = pred_img

        n_pix = pred_img.shape[-1] * pred_img.shape[-2]

        if self.l_l1_w > 0.0:
            if render_mode == "human":
                ll1 = l1_loss(pred_img, gt_image, mask)
            elif render_mode == "scene":
                ll1 = l1_loss(pred_img, gt_image, 1.0 - mask)
            else:
                ll1 = l1_loss(pred_img, gt_image)
            loss_dict["l1"] = self.l_l1_w * ll1

        if self.l_ssim_w > 0.0:
            ls = 1.0 - ssim(pred_img, gt_image)
            if render_mode == "human":
                ls = ls * (torch.sum(mask) / n_pix)
            elif render_mode == "scene":
                ls = ls * (torch.sum(1.0 - mask) / n_pix)
            loss_dict["ssim"] = self.l_ssim_w * ls

        if self.l_lpips_w > 0.0 and self.lpips is not None \
                and render_mode != "scene":
            if self.use_patches:
                if render_mode == "human":
                    bg_l = draws.lpips_bg
                    image_bg = pred_img * mask + bg_l * (1.0 - mask)
                    gt_bg = gt_image * mask + bg_l * (1.0 - mask)
                else:
                    image_bg, gt_bg = pred_img, gt_image
                lp = self._patch_lpips(draws.patches, mask, image_bg, gt_bg)
                loss_dict["lpips_patch"] = self.l_lpips_w * lp
            else:
                lp = torch.mean(self.lpips(clip_max1(pred_img)[None],
                                           gt_image[None]))
                loss_dict["lpips"] = self.l_lpips_w * lp

        if self.l_humansep_w > 0.0 and render_mode == "human_scene":
            pred_h = render_pkg["human_img"]
            gt_h = gt_image * mask + human_bg_color[:, None, None] * (
                1.0 - mask)
            loss_dict["l1_human"] = (self.l_l1_w * l1_loss(pred_h, gt_h, mask)
                                     * self.l_humansep_w)
            lsh = (1.0 - ssim(pred_h, gt_h)) * (torch.sum(mask) / n_pix)
            loss_dict["ssim_human"] = self.l_ssim_w * lsh * self.l_humansep_w
            if self.lpips is not None and self.l_lpips_w > 0.0:
                bg_l = draws.lpips_bg_human
                image_bg = pred_h * mask + bg_l * (1.0 - mask)
                gt_bg = gt_h * mask + bg_l * (1.0 - mask)
                lph = self._patch_lpips(draws.patches_human, mask, image_bg,
                                        gt_bg)
                loss_dict["lpips_patch_human"] = (self.l_lpips_w * lph
                                                  * self.l_humansep_w)

        if self.l_lbs_w > 0.0 and human_gs_out is not None \
                and human_gs_out.get("lbs_weights") is not None \
                and render_mode != "scene":
            if human_gs_out.get("gt_lbs_weights") is not None:
                target = human_gs_out["gt_lbs_weights"].detach()
            else:
                target = human_gs_init_values["lbs_weights"]
            loss_dict["lbs"] = self.l_lbs_w * torch.mean(
                (human_gs_out["lbs_weights"] - target) ** 2)

        total = sum(loss_dict.values(),
                    torch.zeros((), device=pred_img.device))
        return total, loss_dict, extras
