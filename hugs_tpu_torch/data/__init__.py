from hugs_tpu_torch.data.cameras import (
    get_predefined_pose, get_rotating_camera, get_smpl_canon_params,
    get_smpl_static_params, get_static_camera,
)
from hugs_tpu_torch.data.colmap import read_colmap_scene, write_colmap_bin
from hugs_tpu_torch.data.neuman import NeumanDataset
