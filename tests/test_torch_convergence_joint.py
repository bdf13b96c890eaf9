"""hugs_tpu_torch/convergence/joint_scene.py against the TPU script and
hugs_tpu, on the CPU at the script's SMOKE size (64x64, 4 frames, a room
of 256 + 64 points).

- Frame 1 of the ground truth (the body and the room on grey, the mask
  from the body alone) equals hugs_tpu's smpl_forward +
  render(backend="tiled") of the same splats: the image atol 2e-5, the
  mask exactly.
- One iteration of the joint recipe (step 1, a given human background)
  equals hugs_tpu's joint_train_step (render_human_separate, humansep
  1.0) on the parity tests' small avatar and the room's noisy cloud
  (create_from_pcd, capacity 512) carried across by convert: the loss
  and its terms atol 2e-5 + rtol 2e-6, both states at
  torch_parity.assert_joint_close's one-step bars. The recipe's budget
  starts at 64 slots, so its forward overflows, grows the budget once
  (train/budget.py) and runs again before the update.

Helpers are test_torch_convergence.py's.
"""
import jax
import jax.numpy as jnp
import numpy as np
import torch

from hugs_tpu_torch import convert
from hugs_tpu_torch.convergence import joint_scene
from test_torch_convergence import (
    BUDGET, S, _assert_losses, _jax_avatar, _jax_cams, _jax_rates,
    _joint_gt, _jstep, check_gt_frame,
)
from torch_parity import (  # noqa: F401 (few_threads: autouse)
    assert_joint_close, few_threads, jax_joint_to_numpy, np_of,
)


def test_gt_frame_matches_jax():
    check_gt_frame("joint")


def test_joint_iteration_matches_jax():
    hst, jjs, sst = _jstep()
    from hugs_tpu.losses.loss import HumanSceneLoss as JaxLoss
    from hugs_tpu.models import scene_gs as jsg
    (cfg, _, params, state, fixed), (tcfg, _, _, tfixed) = _jax_avatar()
    _, (frames, _, (spts, scol), _) = _joint_gt()
    rng = np.random.default_rng(5)
    pts = (spts + rng.normal(size=spts.shape) * 0.05).astype(np.float32)
    cols = np.clip(scol + rng.normal(size=scol.shape) * 0.1, 0, 1).astype(
        np.float32)
    js = jjs.JointTrainState(
        human=hst.init_human_train_state(params, state),
        scene=sst.init_scene_train_state(jsg.create_from_pcd(
            jnp.asarray(pts), jnp.asarray(cols), joint_scene.SMOKE[
                "SCENE_CAP"], max_sh_degree=3)))
    ts = convert.joint_state_from_numpy(*jax_joint_to_numpy(js),
                                        device="cpu")
    run = joint_scene.make_run(frames, ts, tfixed, tcfg, S, BUDGET)
    h_static, h_sched, s_static, s_sched = _jax_rates(scene=True)
    assert h_static == run.h_static and s_static == run.s_static
    hbg = np.array([0.7, 0.2, 0.5], np.float32)
    run.budget = 64
    taux = joint_scene.train_iteration(run, 1, torch.as_tensor(hbg))
    assert run.budget_grown == 1 and run.budget >= 1 << 16
    i = run.train_i[1 % len(run.train_i)]
    js2, jaux = jjs.joint_train_step(
        js, fixed, _jax_cams()[i], jnp.asarray(np_of(frames[i]["rgb"])),
        jnp.asarray(np_of(frames[i]["mask"])), jnp.full(3, joint_scene.BG),
        jnp.asarray(hbg), jnp.float32(1.0), jnp.int32(i),
        jax.random.PRNGKey(0), jnp.float32(h_sched(1)), h_static,
        jnp.float32(s_sched(1)), s_static, cfg=cfg,
        loss_fn=JaxLoss(**joint_scene.LOSS), width=S, height=S,
        backend="tiled", instance_budget=BUDGET, render_human_separate=True)
    assert not bool(jaux["overflowed"]) and not bool(taux["overflowed"])
    _assert_losses(taux, jaux)
    assert_joint_close(run.jstate, js2)
