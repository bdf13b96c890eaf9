from hugs_tpu_torch.models.human_gs import (
    HumanGS, HumanGSConfig, HumanGSFixed, HumanGSState, canon_forward,
    compact_for_inference, compute_vitruvian, human_forward, init_human_gs,
    resolve_pose,
)
from hugs_tpu_torch.models.scene_gs import (
    SceneGS, add_densification_stats, compact, create_from_pcd,
    create_from_ply, densify_and_prune, one_up_sh_degree, params_of,
    reset_opacity, scene_forward,
)
from hugs_tpu_torch.models.smpl import (
    SMPLModel, lbs_extra, load_smpl, make_smpl_model, smpl_forward,
    synthetic_smpl, vitruvian_pose,
)
from hugs_tpu_torch.models.subdivide import subdivide_smpl_model
