from hugs_tpu_torch.ops.graphics import (
    camera_center, focal2fov, fov2focal, full_projection, projection_matrix,
    world_to_view,
)
from hugs_tpu_torch.ops.grid_sample import grid_sample_2d
from hugs_tpu_torch.ops.knn import knn, mean_sq_dist_to_knn
from hugs_tpu_torch.ops.sh import (
    eval_sh, eval_sh_masked, eval_sh_rows, rgb_to_sh, sh_to_rgb,
)
