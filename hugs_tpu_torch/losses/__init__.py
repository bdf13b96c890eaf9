from hugs_tpu_torch.losses.basic import (
    l1_loss, l2_loss, pcd_laplacian_smoothing, psnr, ssim, ssim_masked,
    total_variation_loss,
)
