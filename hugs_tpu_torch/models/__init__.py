from hugs_tpu_torch.models.scene_gs import (
    SceneGS, compact, create_from_pcd, create_from_ply, scene_forward,
)
