from hugs_tpu_torch.train.human_step import (
    HumanTrainState, distill_init, human_densify_step, human_train_step,
    init_human_train_state, make_human_lrs,
)
from hugs_tpu_torch.train.joint_step import (
    JointTrainState, joint_train_step,
)
from hugs_tpu_torch.train.optim import (
    GroupAdamState, expon_lr, group_adam_init, group_adam_update,
)
from hugs_tpu_torch.train.scene_step import (
    SceneTrainState, init_scene_train_state, make_scene_lrs,
    scene_densify_step, scene_train_step,
)
