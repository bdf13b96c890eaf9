"""The port's data x tile paths (hugs_tpu_torch/parallel) against the
single-device functions of both packages, on the CPU, with gloo groups of
2 spawned ranks (hugs_tpu_torch/parallel/launch.py::run_ranks; each
group joined under a 60 s timeout, after which its ranks are terminated
and the test fails).

hugs_tpu's own sharded functions run on a CPU device mesh only as slow
tests (a 2-device render_tile_sharded does not finish its first forward
in minutes here), which also show them equal to its single-device ones.
So the port's sharded functions are held to hugs_tpu's single-device
`render`, `joint_train_step` and the batch-1 animate.

The joint case: tests/test_sharded_train.py's (synthetic_smpl(8),
capacity 256, a 16^2 triplane, the deformer on, posedirs off; 128 scene
points in capacity 256), at 64x48 (two bands of 32 rows, the second
running 16 rows past the frame, or three of 16), with a random pose per
frame; L1 0.8, SSIM 0.2, LBS 10, humansep 1, no LPIPS (so the loss draws
nothing); hugs_tpu's `tiled` backend with no tile above its 1024 cap.

- (1) render_band stitched over 2 and 3 bands = the port's render and
  hugs_tpu's render at atol 2e-5; the gradients, summed over the bands,
  = the port's one-band gradients at atol 1e-6 + rtol 1e-4.
- (2) 2 gloo ranks: render_tile_sharded on a (1, 2) mesh = (1);
  make_dp_tile_train_step on a (1, 2) mesh over one frame and on a
  (2, 1) mesh over two: the loss and terms at test_torch_joint.py's bar,
  the state after the step at the one-step bars
  (parallel/check.py::compare_snapshots) against the world-1 step over
  the same frames; the states of the two ranks bit for bit equal.
- (3) The world-1 step over one frame = hugs_tpu's joint_train_step on
  it (torch_parity.assert_joint_close); over two frames its first
  moments = the mean of hugs_tpu's one-step first moments of each frame
  (0.1 of each gradient) and its loss the mean of their losses.
- (4) animate with anim_batch_size 4 on 5 frames = batch 1 at 2e-5; the
  2-rank data split of 8 frames likewise.
- (5) The staged start: scene parameters and moments unchanged before
  scene.opt_start_iter, moved after.
- (6) A band budget between the two bands' demands of the first step's
  frame, on a (1, 2) mesh: one rank's band overflows, both ranks render
  again (one retry each), grow the budget alike and end bit for bit
  equal.
- (7) ValueError outside the joint mode and for a world the batch would
  leave partly idle.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hugs_tpu_torch.cfg import load_config
from hugs_tpu_torch.losses.loss import HumanSceneLoss
from hugs_tpu_torch.parallel import check
from hugs_tpu_torch.parallel.launch import RANK_THREADS, run_ranks
from hugs_tpu_torch.parallel.mesh import Mesh
from hugs_tpu_torch.parallel.shard import band_height, render_band
from hugs_tpu_torch.parallel.train_dp_tile import make_dp_tile_train_step
from hugs_tpu_torch.render.renderer import render
from hugs_tpu_torch.train import human_step as thst
from hugs_tpu_torch.train import scene_step as tsst
from hugs_tpu_torch.train import trainer as ttr
from torch_parity import (
    assert_joint_close, cameras, human_cfg_to_torch, jax_joint_to_numpy,
    make_scene, np_of, smpl_arrays,
)

W, H = 64, 48
BUDGET = 1 << 14
TIMEOUT = 60.0
LOSS_KW = dict(l_ssim_w=0.2, l_l1_w=0.8, l_lpips_w=0.0, l_lbs_w=10.0,
               l_humansep_w=1.0, use_patches=False)
LOSS_TOL = dict(atol=2e-5, rtol=2e-6)
IMAGE_ATOL = 2e-5
GRAD_TOL = dict(atol=1e-6, rtol=1e-4)
# tests/test_torch_trainer.py's small run, LPIPS and humansep off
TRAINER = ["mode=human_scene", "train.num_steps=0", "human.init_steps=3",
           "human.triplane_res=16", "human.n_subdivision=0",
           "human.use_deformer=true", "human.disable_posedirs=true",
           "human.loss.lpips_w=0.0", "human.loss.humansep_w=0.0",
           "human.loss.patch_size=16", "tpu.scene_capacity=256",
           "tpu.human_capacity=512", "tpu.smpl_vpb=8"]


@pytest.fixture(autouse=True, scope="module")
def _rank_threads():
    """torch on RANK_THREADS CPU threads in this module, as in its spawned
    ranks: the suite runs 6 workers on the machine's cores, and more
    threads per worker oversubscribe them."""
    n = torch.get_num_threads()
    torch.set_num_threads(RANK_THREADS)
    yield
    torch.set_num_threads(n)


def _jax():
    """hugs_tpu's modules, imported where they are used (hugs_tpu.models
    needs flax)."""
    from hugs_tpu.cfg import default_config
    from hugs_tpu.models import human_gs as jhg
    from hugs_tpu.models import scene_gs as jsg
    from hugs_tpu.models.smpl import synthetic_smpl
    from hugs_tpu.train import human_step, joint_step, scene_step
    return default_config, jhg, jsg, synthetic_smpl, human_step, \
        scene_step, joint_step


@functools.lru_cache(maxsize=None)
def _joint():
    """hugs_tpu's joint state (a random pose per frame), fixed body and
    config, the two frames and the rates; the numpy arguments of the
    port's workers."""
    default_config, jhg, jsg, synthetic_smpl, jhst, jsst, jjs = _jax()
    smpl = synthetic_smpl(verts_per_bone=8)
    cfg = jhg.HumanGSConfig(n_features=8, triplane_res=16, use_deformer=True,
                            disable_posedirs=True)
    params, state, fixed, _ = jhg.init_human_gs(
        jax.random.PRNGKey(0), cfg, smpl, smpl, jnp.zeros(10), n_frames=2,
        capacity=256)
    from hugs_tpu.ops.rotations import axis_angle_to_rotation_6d
    rng = np.random.default_rng(1)
    pose = (rng.normal(size=(2, 23, 3)) * 0.2).astype(np.float32)
    params = params._replace(body_pose=axis_angle_to_rotation_6d(
        jnp.asarray(pose)).reshape(2, -1))
    pts = np.random.RandomState(1).uniform(-2, 2, (128, 3)).astype(
        np.float32)
    pts[:, 2] = np.abs(pts[:, 2]) * 0.5 + 3.0
    gs = jsg.create_from_pcd(pts, np.full((128, 3), 0.5, np.float32), 256,
                             max_sh_degree=3)
    jstate = jjs.JointTrainState(human=jhst.init_human_train_state(params,
                                                                   state),
                                 scene=jsst.init_scene_train_state(gs))
    from hugs_tpu.render import make_camera
    frames = []
    for i, x in enumerate((0.0, 0.15)):
        cam = make_camera(jnp.eye(3), jnp.array([x, 0.2, 2.5]), 0.9, 0.9)
        frames.append({
            "jcam": cam,
            "camera": {f: np.asarray(getattr(cam, f)) for f in cam._fields},
            "rgb": rng.uniform(size=(3, H, W)).astype(np.float32),
            "mask": (rng.uniform(size=(H, W)) > 0.4).astype(np.float32),
            "bg": np.array([0.3, 0.2, 0.1], np.float32) + 0.1 * i,
            "human_bg": np.array([0.9, 0.8, 0.7], np.float32) - 0.1 * i,
            "dataset_idx": i})
    jd = default_config()
    h_static, h_sched = jhst.make_human_lrs(jd.human.lr)
    s_static, s_sched = jsst.make_scene_lrs(jd.scene.lr, 4.0)
    td = load_config(None)
    th_static, _ = thst.make_human_lrs(td.human.lr)
    ts_static, _ = tsst.make_scene_lrs(td.scene.lr, 4.0)
    assert th_static == h_static and ts_static == s_static
    # step 0's position rates, hugs_tpu's float32 values for both
    lrs = (float(h_sched(0)), th_static, float(s_sched(0)), ts_static)
    state_np = jax_joint_to_numpy(jstate)
    step_args = (state_np, smpl_arrays(smpl),
                 human_cfg_to_torch(cfg)._asdict(), LOSS_KW, lrs, W, H,
                 BUDGET)
    return jstate, fixed, cfg, frames, step_args


def _np_frames(idx):
    return [{k: v for k, v in _joint()[3][i].items() if k != "jcam"}
            for i in idx]


def _port_step(idx):
    """The world-1 data x tile step over frames idx: (jstate, aux)."""
    state_np, smpl_np, cfg_kw, loss_kw, lrs, w, h, budget = _joint()[4]
    jstate, fixed, cfg, frames = check._setup(state_np, smpl_np, cfg_kw,
                                              _np_frames(idx), "cpu")
    step = make_dp_tile_train_step(Mesh(), fixed, cfg, width=w, height=h,
                                   loss_fn=HumanSceneLoss(**loss_kw),
                                   instance_budget=budget)
    return step(jstate, frames, *lrs)


@functools.lru_cache(maxsize=None)
def _port_ref(idx):
    """_port_step's loss, terms and snapshot (the 2-rank runs' bar)."""
    jstate, aux = _port_step(idx)
    return {"loss": float(aux["loss"]),
            "loss_dict": {k: float(v) for k, v in aux["loss_dict"].items()},
            "state": check.snapshot(jstate)}


def _jax_step(i):
    """hugs_tpu's joint_train_step on frame i from the initial state."""
    jstate, fixed, cfg, frames, step_args = _joint()
    _, jhg, _, _, jhst, jsst, jjs = _jax()
    from hugs_tpu.losses.loss import HumanSceneLoss as JaxLoss
    f = frames[i]
    lrs = step_args[4]
    js2, aux = jjs.joint_train_step(
        jstate, fixed, f["jcam"], jnp.asarray(f["rgb"]),
        jnp.asarray(f["mask"]), jnp.asarray(f["bg"]),
        jnp.asarray(f["human_bg"]), jnp.float32(1.0), jnp.int32(i),
        jax.random.PRNGKey(5), jnp.float32(lrs[0]), lrs[1],
        jnp.float32(lrs[2]), lrs[3], cfg=cfg, loss_fn=JaxLoss(**LOSS_KW),
        width=W, height=H, backend="tiled", instance_budget=BUDGET,
        render_human_separate=True)
    assert not bool(aux["overflowed"])
    return js2, aux


@functools.lru_cache(maxsize=None)
def _scene():
    """torch_parity's 300-Gaussian cloud and camera at 64x48."""
    scene = make_scene(n=300, seed=4)
    jcam, tcam = cameras()
    return scene, jcam, tcam


def _render_args():
    scene, _, tcam = _scene()
    cam_np = {f: np_of(getattr(tcam, f)) for f in tcam._fields}
    return scene, cam_np, W, H, BUDGET


def _full_render(requires_grad=False):
    scene, _, tcam = _scene()
    t = {k: torch.tensor(v, requires_grad=requires_grad)
         for k, v in scene.items()}
    img = render(t["means"], t["scales"], t["rotq"], t["opacity"], t["shs"],
                 tcam, W, H, active_sh_degree=3,
                 instance_budget=BUDGET)["render"]
    return img, t


@functools.lru_cache(maxsize=None)
def _parity_ranks():
    return run_ranks(check.parity_worker, 2,
                     (_render_args(), _joint()[4], _np_frames((0, 1)),
                      _np_frames((0,))), timeout=TIMEOUT)


@pytest.fixture(scope="module")
def fake_root(tmp_path_factory):
    from test_data import write_fake_neuman
    root = str(tmp_path_factory.mktemp("neuman"))
    write_fake_neuman(root, n_frames=10, w=48, h=32)
    return root


@pytest.fixture(scope="module")
def trainer_ranks(fake_root):
    return run_ranks(check.trainer_worker, 2, (fake_root, TRAINER),
                     timeout=TIMEOUT)


# ------------------------------------------------------------ (1) bands

def test_band_height():
    assert band_height(48, 2) == 32 and band_height(48, 3) == 16
    assert band_height(540, 4) == 144 and band_height(540, 1) == 544
    assert band_height(64, 3) == 32


@pytest.mark.parametrize("n_bands", [2, 3])
def test_stitched_bands_match_render(n_bands):
    """The bands of render_band stitched and cropped = the port's render
    and hugs_tpu's (tiled), and their gradients summed over the bands =
    the port's one-band gradients."""
    from hugs_tpu.render import render as jax_render
    scene, jcam, tcam = _scene()
    full, tf = _full_render(requires_grad=True)
    t = {k: torch.tensor(v, requires_grad=True) for k, v in scene.items()}
    bands = [render_band(t["means"], t["scales"], t["rotq"], t["opacity"],
                         t["shs"], tcam, W, H, b, n_bands,
                         active_sh_degree=3, instance_budget=BUDGET)
             for b in range(n_bands)]
    assert all(o["render"].shape == (3, band_height(H, n_bands), W)
               for o in bands)
    assert not any(bool(o["overflowed"]) for o in bands)
    stitched = torch.cat([o["render"] for o in bands], dim=1)[:, :H]
    want = jax_render(*(jnp.asarray(scene[k]) for k in (
        "means", "scales", "rotq", "opacity", "shs")), jcam, W, H,
        active_sh_degree=3, instance_budget=BUDGET,
        backend="tiled")["render"]
    np.testing.assert_allclose(np_of(stitched), np_of(full),
                               atol=IMAGE_ATOL)
    np.testing.assert_allclose(np_of(stitched), np.asarray(want),
                               atol=IMAGE_ATOL)
    g = torch.as_tensor(np.random.default_rng(2).normal(
        size=(3, H, W)).astype(np.float32))
    (stitched * g).sum().backward()
    (full * g).sum().backward()
    for k in scene:
        np.testing.assert_allclose(np_of(t[k].grad), np_of(tf[k].grad),
                                   **GRAD_TOL, err_msg=k)
    # the rows past H are rendered, cropped, and get no gradient
    t2 = {k: torch.tensor(v, requires_grad=True) for k, v in scene.items()}
    uncropped = torch.cat([render_band(
        t2["means"], t2["scales"], t2["rotq"], t2["opacity"], t2["shs"],
        tcam, W, H, b, n_bands, active_sh_degree=3,
        instance_budget=BUDGET)["render"] for b in range(n_bands)], dim=1)
    (g_rows,) = torch.autograd.grad((uncropped[:, :H] * g).sum(), uncropped)
    assert float(g_rows[:, H:].abs().sum()) == 0.0


# ------------------------------------------------- (2) two gloo ranks

def test_tile_sharded_render_on_two_ranks():
    full, _ = _full_render()
    for r in _parity_ranks():
        np.testing.assert_allclose(r["render"], np_of(full),
                                   atol=IMAGE_ATOL)


@pytest.mark.parametrize("layout,idx", [("tile", (0,)), ("data", (0, 1))],
                         ids=["mesh_1x2", "mesh_2x1"])
def test_dp_tile_step_on_two_ranks(layout, idx):
    """One step on 2 ranks = the world-1 step over the same frames, and
    the two ranks end bit for bit equal."""
    want = _port_ref(idx)
    got = [r[layout] for r in _parity_ranks()]
    for g in got:
        assert not g["overflowed"]
        np.testing.assert_allclose(g["loss"], want["loss"], **LOSS_TOL)
        assert set(g["loss_dict"]) == set(want["loss_dict"])
        for k, v in want["loss_dict"].items():
            np.testing.assert_allclose(g["loss_dict"][k], v, **LOSS_TOL,
                                       err_msg=k)
        check.compare_snapshots(g["state"], want["state"])
    for k, a in got[0]["state"].items():
        np.testing.assert_array_equal(a, got[1]["state"][k], err_msg=k)
    assert got[0]["loss"] == got[1]["loss"]


# --------------------------------------------------- (3) against hugs_tpu

def test_world1_step_matches_joint_train_step():
    js2, jaux = _jax_step(0)
    tstate, taux = _port_step((0,))
    np.testing.assert_allclose(float(taux["loss"]), float(jaux["loss"]),
                               **LOSS_TOL)
    assert set(taux["loss_dict"]) == set(jaux["loss_dict"])
    for k, v in jaux["loss_dict"].items():
        np.testing.assert_allclose(float(taux["loss_dict"][k]), float(v),
                                   **LOSS_TOL, err_msg=k)
    assert int(taux["n_slots"]) == int(jaux["n_slots"])
    assert_joint_close(tstate, js2)


def test_world1_batch_of_two_is_the_mean():
    """Over two frames: the first moments (0.1 x the gradient) = the mean
    of hugs_tpu's one-step first moments of each frame; the loss the
    mean of their losses."""
    from torch_parity import flat_group, flat_tree
    (j0, a0), (j1, a1) = _jax_step(0), _jax_step(1)
    tstate, taux = _port_step((0, 1))
    np.testing.assert_allclose(
        float(taux["loss"]), 0.5 * (float(a0["loss"]) + float(a1["loss"])),
        **LOSS_TOL)
    for name, t, s0, s1 in (("human", tstate.human, j0.human, j1.human),
                            ("scene", tstate.scene, j0.scene, j1.scene)):
        for group in s0.opt.mu:
            got = flat_group(t.opt.mu[group])
            m0, m1 = flat_tree(s0.opt.mu[group]), flat_tree(s1.opt.mu[group])
            for key in m0:
                np.testing.assert_allclose(
                    got[key], 0.5 * (m0[key] + m1[key]), atol=1e-7,
                    rtol=1e-4, err_msg=f"{name} {group}.{key}")


# ------------------------------------------------------- (4) animate

def test_animate_batched_matches_batch_one(fake_root):
    """anim_batch_size 4 on 5 frames (padded to 8) = one frame at a
    time; train.anim_batch_size selects it."""
    tr = check.small_trainer(fake_root, TRAINER + [
        "train.anim_batch_size=4"], Mesh())
    tr.anim_dataset = check.anim_frames(5)
    batched = tr.animate()
    alone = tr.animate(batch_size=1)
    assert len(batched) == len(alone) == 5
    for a, b in zip(batched, alone):
        np.testing.assert_allclose(np_of(a), np_of(b), atol=IMAGE_ATOL)
    assert float((alone[4] - alone[0]).abs().max()) > 0.01


def test_animate_split_over_two_ranks(trainer_ranks):
    for r in trainer_ranks:
        assert r["anim_frames"] == 8
        assert r["anim_err"] <= IMAGE_ATOL


# --------------------------------------------------- (5) staged start

def test_batched_staged_scene_start(fake_root):
    """scene.opt_start_iter 2, batch 2: steps 0 and 1 train the human
    alone (the scene neither rendered nor moved), step 2 both."""
    tr = check.small_trainer(fake_root, TRAINER + [
        "train.batch_size=2", "train.num_steps=2",
        "scene.opt_start_iter=2"], Mesh())
    seen = []
    inner = tr._batched_step

    def record(t_iter, idxs, sync):
        out = inner(t_iter, idxs, sync)
        seen.append((t_iter, tr._mode(t_iter),
                     tr.scene.gs.xyz.detach().clone(),
                     int(tr.scene.opt.step), int(tr.human.opt.step)))
        return out
    tr._batched_step = record
    xyz0 = tr.scene.gs.xyz.detach().clone()
    tr.train()
    assert [s[:2] for s in seen] == [(0, "human"), (1, "human"),
                                     (2, "human_scene")]
    for _, _, xyz, s_step, _ in seen[:2]:
        assert torch.equal(xyz, xyz0) and s_step == 0
    assert not torch.equal(seen[2][2], xyz0) and seen[2][3] == 1
    assert [s[4] for s in seen] == [1, 2, 3]


# ---------------------------------------- (6) an overflow on one band

def test_one_band_overflow_retries_on_both_ranks(trainer_ranks):
    demands, budget0 = trainer_ranks[0]["demands"], \
        trainer_ranks[0]["budget0"]
    assert sum(d > budget0 for d in demands) == 1, (demands, budget0)
    for r in trainer_ranks:
        assert r["demands"] == demands and r["retries"] == 1
        assert r["budget"] == trainer_ranks[0]["budget"] > max(demands)
        assert r["loss"] == trainer_ranks[0]["loss"]
    for k, a in trainer_ranks[0]["state"].items():
        np.testing.assert_array_equal(a, trainer_ranks[1]["state"][k],
                                      err_msg=k)


# ------------------------------------------------------ (7) refusals

def _bare_trainer(overrides, mesh=None):
    tr = object.__new__(ttr.GaussianTrainer)
    tr.cfg = load_config(None, overrides)
    tr.human = tr.scene = object()
    if mesh is not None:
        tr.mesh = mesh
    return tr


def test_batched_training_needs_the_joint_mode():
    tr = _bare_trainer(["mode=human", "train.batch_size=2"])
    tr.scene = None
    with pytest.raises(ValueError, match="human_scene"):
        tr.train()


def test_batched_training_refuses_idle_ranks():
    """A batch of 3 on a world of 2 would leave a rank idle (hugs_tpu
    idles devices; a rank cannot sit out a collective)."""
    tr = _bare_trainer(["mode=human_scene", "train.batch_size=3"],
                       Mesh(2, 1, 0, groups={}))
    with pytest.raises(ValueError, match="batch_size 3 .* 2 data ranks"):
        tr.train()
