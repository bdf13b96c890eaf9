from hugs_tpu_torch.losses.basic import (
    l1_loss, l2_loss, pcd_laplacian_smoothing, psnr, ssim, ssim_masked,
    total_variation_loss,
)
from hugs_tpu_torch.losses.loss import HumanSceneLoss, LossDraws
from hugs_tpu_torch.losses.lpips import LPIPS
from hugs_tpu_torch.losses.sampler import (
    PatchDraws, draw_patch_randoms, sample_patches,
)
