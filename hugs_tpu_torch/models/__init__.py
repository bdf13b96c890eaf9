from hugs_tpu_torch.models.scene_gs import (
    SceneGS, add_densification_stats, compact, create_from_pcd,
    create_from_ply, densify_and_prune, one_up_sh_degree, params_of,
    reset_opacity, scene_forward,
)
