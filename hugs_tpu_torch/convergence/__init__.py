"""The convergence recipes: the counterparts of the TPU scripts that
record how well the system trains, each on synthetic data it builds
itself, through the port's training steps and trainer with K1 and K2 on
the card.

  human_avatar      scripts/human_avatar_tpu.py: the avatar alone;
  joint_scene       scripts/joint_scene_tpu.py: the avatar in a room,
                    trained jointly (joint_train_step, humansep on);
  surface_scene     scripts/surface_scene.py: a multi-view scene through
                    GaussianTrainer in scene mode, the budget automatic;
  flagship_release  scripts/flagship_release_tpu.py: the release recipe
                    (hugs_human_scene.yaml) through GaussianTrainer on a
                    synthetic NeuMan-lab sequence.

Run one with `python -m hugs_tpu_torch.convergence.<name>`: on the card
at the script's sizes, `--smoke` at its SMOKE sizes, `--device cpu` on
the CPU. Each writes its JSON record and PNGs into --out (default
runs/<name>/).
"""
