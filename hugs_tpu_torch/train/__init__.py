from hugs_tpu_torch.train.optim import (
    GroupAdamState, expon_lr, group_adam_init, group_adam_update,
)
from hugs_tpu_torch.train.scene_step import (
    SceneTrainState, init_scene_train_state, make_scene_lrs,
    scene_densify_step, scene_train_step,
)
