"""The port's GaussianTrainer and CLI against hugs_tpu's, on
tests/test_data.py's fake NeuMan sequence at 48x32 (10 frames: 8 train,
1 val) with synthetic_smpl(8), capacities 512 (human) and 256 (scene).

JAX and torch draw different numbers, so the trainer is held by what
does not depend on the draws, or with hugs_tpu's draws handed across:
- budget_bucket (train/budget.py), _is_sync_step and the iterations at which each model
  densifies or resets its opacity, over every step of the three
  cfg_files/neuman recipes: equal;
- the frame order over 50 steps: equal;
- a forced overflow on a sync step (the budget set to 64 slots before
  step 0): both grow to the same budget, render once more, and the
  states after the step agree at the one-step bars
  (torch_parity.assert_joint_close; the port fed hugs_tpu's backgrounds);
- validate on hugs_tpu's states and LPIPS carried across: the same keys,
  PSNR atol 1e-3 dB, SSIM and LPIPS atol 1e-5;
- the checkpoint round trip: bit-exact; another capacity raises; a
  trainer with another number of frames keeps its per-frame tables and
  warns;
- compact_for_eval and rehearse_budget keep validate's metrics;
- tests/test_trainer_e2e.py's full cycle, and the CLI
  (python -m hugs_tpu_torch.main --device cpu) in a subprocess: train,
  checkpoint, resume, validate.
"""
import json
import os
import subprocess
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hugs_tpu.cfg.config import load_config as jax_load
from hugs_tpu_torch import convert
from hugs_tpu_torch.cfg import load_config
from hugs_tpu_torch.data.neuman import NeumanDataset
from hugs_tpu_torch.models.smpl import synthetic_smpl
from hugs_tpu_torch.train import checkpoint as ckpt_io
from hugs_tpu_torch.train import human_step as thst
from hugs_tpu_torch.train import scene_step as tsst
from hugs_tpu_torch.train import trainer as ttr
from torch_parity import (
    assert_joint_close, jax_joint_to_numpy, jax_lpips_to_torch,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RECIPES = [os.path.join(REPO, "cfg_files", "neuman", f) for f in (
    "hugs_human.yaml", "hugs_human_scene.yaml", "hugs_scene.yaml")]
METRIC_KEYS = {"hugs_psnr", "hugs_ssim", "hugs_lpips_uncalibrated",
               "hugs_human_psnr", "hugs_human_ssim",
               "hugs_human_lpips_uncalibrated"}
# tests/test_trainer_e2e.py's configuration
SMALL = ["mode=human_scene", "train.num_steps=9",
         "train.save_ckpt_interval=8", "train.val_interval=1000",
         "human.triplane_res=16", "human.n_subdivision=0",
         "human.use_deformer=true", "human.disable_posedirs=true",
         "human.loss.lpips_w=0.0", "human.loss.patch_size=16",
         "human.densify_from_iter=4", "human.densification_interval=6",
         "scene.densify_from_iter=4", "scene.densification_interval=6",
         "tpu.scene_capacity=256", "tpu.human_capacity=512",
         "tpu.smpl_vpb=8", "tpu.tile_cap=1024"]


def _jax_trainer_cls():
    """hugs_tpu's trainer, imported where it is used (it needs flax)."""
    from hugs_tpu.train.trainer import GaussianTrainer
    return GaussianTrainer


@pytest.fixture(scope="module")
def fake_root(tmp_path_factory):
    from test_data import write_fake_neuman
    root = str(tmp_path_factory.mktemp("neuman"))
    write_fake_neuman(root, n_frames=10, w=48, h=32)
    return root


def _port_trainer(root, overrides=(), logdir="", **kw):
    cfg = load_config(None, SMALL + list(overrides))
    if logdir:
        cfg.logdir, cfg.logdir_ckpt = logdir, os.path.join(logdir, "ckpt")
        for sub in ("ckpt", "val", "meshes", "train"):
            os.makedirs(os.path.join(logdir, sub), exist_ok=True)
    train = None if cfg.eval else NeumanDataset(
        root, "lab", "train", render_mode=cfg.mode, device="cpu")
    val = NeumanDataset(root, "lab", "val", render_mode=cfg.mode,
                        device="cpu")
    return ttr.GaussianTrainer(cfg, train, val, device="cpu",
                               smpl_model=synthetic_smpl(8, device="cpu"),
                               **kw)


def _jax_trainer(root, overrides=()):
    from hugs_tpu.data import NeumanDataset as JaxDataset
    from hugs_tpu.models.smpl import synthetic_smpl as jax_smpl
    cfg = jax_load(None, SMALL + list(overrides))
    return _jax_trainer_cls()(
        cfg, JaxDataset(root, "lab", "train", render_mode=cfg.mode),
        JaxDataset(root, "lab", "val", render_mode=cfg.mode), None,
        smpl_model=jax_smpl(verts_per_bone=8))


# ------------------------------------------------------------ schedules

def test_budget_bucket_as_jax():
    from hugs_tpu.train.trainer import _budget_bucket

    from hugs_tpu_torch.train.budget import budget_bucket
    for n in [0, 1, 4096, 65536, 100_000, 2_500_000, 10_485_760]:
        assert budget_bucket(n) == _budget_bucket(n)


def _schedule(cls, cfg, scene_step, human_step, key=None):
    """{t_iter: [what fired]} over the recipe's steps for trainer class
    `cls` with its densify functions replaced by recorders, and the sync
    steps."""
    fired = {}

    def rec(kind):
        def f(state, *a, **kw):
            fired.setdefault(t_now[0], []).append(
                (kind, kw.get("grad_threshold"), kw.get("max_screen_size"),
                 kw.get("do_reset_opacity", False)))
            return state, None
        return f

    tr = object.__new__(cls)
    tr.cfg = cfg
    tr.human = object() if cfg.mode != "scene" else None
    tr.scene = object() if cfg.mode != "human" else None
    tr.scene_extent, tr.key = 1.0, key
    tr.bg_color = jnp.ones(3) if cfg.bg_color == "white" else jnp.zeros(3)
    tr._h_cap = tr._s_cap = 1
    tr.gen, tr.device = torch.Generator(), torch.device("cpu")
    aux = {k: None for k in ("opacity", "scales_canon", "rotmat_canon")}
    t_now = [0]
    sync = []
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(*scene_step, rec("scene"))
        mp.setattr(*human_step, rec("human"))
        for t in range(cfg.train.num_steps + 1):
            t_now[0] = t
            if tr._is_sync_step(t):
                sync.append(t)
            if tr.human is not None:
                tr._maybe_densify_human(t, aux)
            if tr.scene is not None:
                tr._maybe_densify_scene(t)
    return fired, sync


@pytest.mark.parametrize("recipe", RECIPES,
                         ids=[os.path.basename(r) for r in RECIPES])
def test_schedules_as_jax(recipe):
    """The sync steps and every densify / opacity reset, with its
    arguments, over all of the recipe's steps."""
    import hugs_tpu.train.trainer as jtr
    jcfg = jax_items_first(recipe)
    tcfg = load_config(recipe)
    from hugs_tpu_torch.cfg import get_cfg_items
    tcfg = get_cfg_items(tcfg)[0]
    want, want_sync = _schedule(
        _jax_trainer_cls(), jcfg, (jtr, "scene_densify_step"),
        (jtr, "human_densify_step"), key=jax.random.PRNGKey(0))
    got, got_sync = _schedule(
        ttr.GaussianTrainer, tcfg, (tsst, "scene_densify_step"),
        (thst, "human_densify_step"))
    assert got_sync == want_sync
    assert got == want
    assert want     # something fires in every recipe


def jax_items_first(recipe):
    from hugs_tpu.cfg.config import get_cfg_items
    return get_cfg_items(jax_load(recipe))[0]


def test_frame_order_as_jax(fake_root):
    """50 steps over the 8 training frames: the same indices, in the same
    order, as hugs_tpu's train loop visits them."""
    def run(cls, cfg, ds, step):
        tr = object.__new__(cls)
        tr.cfg, tr.train_dataset = cfg, ds
        tr.rng = np.random.RandomState(cfg.seed)
        tr.key = jax.random.PRNGKey(0)
        tr.human = tr.scene = None
        tr._ibudget_fixed = False
        seen = []
        tr._train_step = types.MethodType(step(seen), tr)
        tr._periodic = lambda *a, **k: None
        tr._finish_progress_video = lambda: None
        tr._log_jsonl = lambda rec: None
        tr.train()
        return seen

    def jax_step(seen):
        def f(self, t_iter, idx, *a):
            seen.append(idx)
            return {"loss": 0.0}
        return f

    def port_step(seen):
        def f(self, t_iter, idx, data, sync):
            seen.append(idx)
            return {}, (0.0, 0, False, 0)
        return f

    frames = [{"camera": None, "rgb": 0, "mask": 0, "width": 1,
               "height": 1}] * 8
    want = run(_jax_trainer_cls(), jax_load(None, ["train.num_steps=49"]),
               frames, jax_step)
    got = run(ttr.GaussianTrainer, load_config(None, ["train.num_steps=49"]),
              frames, port_step)
    assert got == want and len(got) == 50 and sorted(set(got)) == list(
        range(8))


# ------------------------------------------------- overflow and validate

@pytest.fixture(scope="module")
def pair(fake_root):
    """hugs_tpu's trainer and the port's, the port's states and LPIPS
    carried across from hugs_tpu's."""
    jt = _jax_trainer(fake_root)
    tt = _port_trainer(fake_root)
    from hugs_tpu.train.joint_step import JointTrainState
    js = convert.joint_state_from_numpy(
        *jax_joint_to_numpy(JointTrainState(human=jt.human, scene=jt.scene)),
        device="cpu")
    tt.human, tt.scene = js.human, js.scene
    tt.lpips = jax_lpips_to_torch(jt.lpips)
    return jt, tt


def test_validate_as_jax(pair):
    jt, tt = pair
    want = jt.validate()
    got = tt.validate()
    assert set(got) == set(want) == METRIC_KEYS
    for k, v in want.items():
        atol = 1e-3 if "psnr" in k else 1e-5
        np.testing.assert_allclose(got[k], v, atol=atol, err_msg=k)


def test_validate_overflow_grows_the_frame_budget_alone(fake_root, capsys):
    """An evaluation frame that overflows the automatic budget renders
    again at a budget grown for that frame alone: its image equals the
    render at the frame's demand, and the training budget stays. A fixed
    budget renders once and warns."""
    tt = _port_trainer(fake_root, ["eval=true"])
    data = tt.val_dataset[0]
    bg = torch.zeros(3)
    demand, over = tt.render_frame(data, outputs=("n_slots", "overflowed"),
                                   budget=1 << 16)
    assert not bool(over)
    want = tt.render_frame(data, bg=bg, budget=int(demand))["render"]
    tt._ibudget = 64
    img = tt._val_frame(data, bg)[0]
    assert tt.eval_retries == 1 and tt._ibudget == 64
    torch.testing.assert_close(img, want, atol=0, rtol=0)
    assert "evaluation frame" in capsys.readouterr().out

    tf = _port_trainer(fake_root, ["eval=true", "tpu.instance_budget=64"])
    tf.validate()
    assert tf.eval_retries == 0 and tf._ibudget == 64
    assert "WARNING: an evaluation frame overflowed the fixed instance " \
           "budget 64" in capsys.readouterr().out


def test_overflow_retry_as_jax(pair, monkeypatch):
    """Step 0 (a sync step) at a budget of 64 slots: both trainers grow
    the budget to the same bucket, render the step again, and commit one
    update, the same in both."""
    jt, tt = pair
    key = jt.key
    draws = []

    def jax_draws(mode, height, width):
        # hugs_tpu's train loop: key, k_step, k_bg = split(key, 3); bg;
        # in human_scene, key, k_hbg = split(key); human_bg
        nonlocal key
        key, _, k_bg = jax.random.split(key, 3)
        bg = torch.as_tensor(np.array(jax.random.uniform(k_bg, (3,))))
        key, k_hbg = jax.random.split(key)
        hbg = torch.as_tensor(np.array(jax.random.uniform(k_hbg, (3,))))
        draws.append(bg)
        return bg, hbg, tt.loss_fn.draws(tt.gen, height, width, mode,
                                         device="cpu")

    monkeypatch.setattr(tt, "_step_draws", jax_draws)
    for t, c in ((jt, jt.cfg), (tt, tt.cfg)):
        c.train.num_steps = 0
        t._ibudget = 64
    jt.train()
    tt.train()
    assert len(draws) == 1          # drawn once, rendered twice
    assert tt.retries == 1
    assert tt._ibudget == jt._ibudget == 65536
    from hugs_tpu.train.joint_step import JointTrainState
    from hugs_tpu_torch.train.joint_step import JointTrainState as TJoint
    assert_joint_close(TJoint(human=tt.human, scene=tt.scene),
                       JointTrainState(human=jt.human, scene=jt.scene))


# ------------------------------------------------------------ checkpoints

def test_checkpoint_round_trip(fake_root, tmp_path):
    tt = _port_trainer(fake_root, ["train.num_steps=3"])
    tt.train()
    ckpt = str(tmp_path / "ckpt")
    ckpt_io.save(ckpt, "000003", human=tt.human, scene=tt.scene)
    tt2 = _port_trainer(fake_root, [f"logdir_ckpt={ckpt}"])
    for what in ("human", "scene"):
        a = ckpt_io.flatten(getattr(tt, what))
        b = ckpt_io.flatten(getattr(tt2, what))
        assert set(a) == set(b) and len(a) > 10
        for k in a:
            assert torch.equal(a[k], b[k]), (what, k)
    assert int(tt2.human.opt.step) == 4
    # another capacity is refused, before anything is copied
    with pytest.raises(ValueError, match="capacity"):
        _port_trainer(fake_root, [f"logdir_ckpt={ckpt}",
                                  "tpu.scene_capacity=512"])
    # another number of frames keeps the per-frame tables, with a warning
    with pytest.warns(UserWarning, match="per-frame"):
        tt3 = _port_trainer(fake_root, [f"logdir_ckpt={ckpt}", "eval=true"])
    assert tt3.human.params.body_pose.shape[0] == 1
    assert torch.equal(tt3.scene.gs.xyz, tt.scene.gs.xyz)


def test_latest_checkpoint_order(tmp_path):
    for name in ("human_000100", "human_final", "human_000020", "scene_x"):
        (tmp_path / name).write_bytes(b"")
    assert ckpt_io._latest(str(tmp_path), "human").endswith("human_final")
    os.remove(tmp_path / "human_final")
    assert ckpt_io._latest(str(tmp_path), "human").endswith("human_000100")
    assert ckpt_io._latest(str(tmp_path / "none"), "human") is None


# ------------------------------------------------------------ end to end

def test_trainer_full_cycle(fake_root, tmp_path):
    """tests/test_trainer_e2e.py's cycle on the port: 10 steps with a
    densify of each set and a checkpoint at step 8, validate, the
    checkpoint's PLY, the val images, and a resume."""
    logdir = str(tmp_path / "out")
    tt = _port_trainer(fake_root, logdir=logdir)
    log = tt.train()
    assert np.isfinite([r["loss"] for r in log]).all() and len(log) == 1
    metrics = tt.validate()
    assert set(metrics) == METRIC_KEYS
    assert np.isfinite(list(metrics.values())).all()
    ckpts = os.listdir(os.path.join(logdir, "ckpt"))
    assert {"human_000008", "scene_000008", "human_000009",
            "scene_000009"} <= set(ckpts)
    assert "scene_000008_splat.ply" in os.listdir(
        os.path.join(logdir, "meshes"))
    assert any(f.startswith("full_") for f in os.listdir(
        os.path.join(logdir, "val")))
    tt2 = _port_trainer(fake_root, logdir=logdir)
    assert torch.equal(tt2.scene.gs.xyz, tt.scene.gs.xyz)
    assert np.isfinite(tt2.validate()["hugs_psnr"])


def test_compact_and_rehearse_keep_the_metrics(fake_root):
    """compact_for_eval (2048- / 4096-row buckets) and rehearse_budget
    (the val frames' demand x 1.15) change no metric beyond validate's
    bars, and both refuse to run mid-training."""
    with pytest.raises(RuntimeError, match="cfg.eval"):
        _port_trainer(fake_root, ["train.num_steps=0"]).compact_for_eval()
    tt = _port_trainer(fake_root, ["eval=true"])
    before = tt.validate()
    tt.compact_for_eval()
    assert tt.human.params.xyz.shape[0] % 2048 == 0
    assert tt.scene.gs.capacity % 4096 == 0
    budget = tt.rehearse_budget()
    assert budget == tt._ibudget and budget % 8192 == 0
    after = tt.validate()
    for k, v in before.items():
        atol = 1e-3 if "psnr" in k else 1e-5
        np.testing.assert_allclose(after[k], v, atol=atol, err_msg=k)


def test_cli_trains_checkpoints_resumes_and_validates(fake_root, tmp_path):
    out = str(tmp_path / "out")
    args = [sys.executable, "-m", "hugs_tpu_torch.main", "--cfg_file",
            os.path.join(REPO, "cfg_files", "neuman",
                         "hugs_human_scene.yaml"), "--device", "cpu",
            f"dataset_path={fake_root}", "dataset.seq=lab",
            f"output_path={out}", "exp_name=cli", "train.num_steps=4",
            "human.triplane_res=16", "human.n_subdivision=0",
            "human.init_steps=3", "human.loss.patch_size=16",
            "human.canon_nframes=4", "tpu.scene_capacity=256",
            "tpu.human_capacity=512", "tpu.smpl_vpb=8"]
    env = dict(os.environ, PYTHONPATH=REPO)
    run = subprocess.run(args, capture_output=True, text=True, cwd=REPO,
                         env=env, timeout=300)
    assert run.returncode == 0, run.stderr[-3000:]
    logdir = os.path.join(out, "neuman", "lab", "cli")
    with open(os.path.join(logdir, "results_train.json")) as f:
        assert np.isfinite([r["loss"] for r in json.load(f)]).all()
    with open(os.path.join(logdir, "results_eval.json")) as f:
        first = json.load(f)
    assert set(first) == METRIC_KEYS
    assert {"human_final", "scene_final"} <= set(
        os.listdir(os.path.join(logdir, "ckpt")))
    # the turntable main() renders after validating, 4 frames here
    assert len(os.listdir(os.path.join(logdir, "canon", "final"))) == 4
    # an evaluation run resumes the final checkpoint and validates it
    run = subprocess.run(args + ["eval=true"], capture_output=True,
                         text=True, cwd=REPO, env=env, timeout=300)
    assert run.returncode == 0, run.stderr[-3000:]
    with open(os.path.join(logdir, "results_eval.json")) as f:
        again = json.load(f)
    for k, v in first.items():      # validate's bars (above)
        atol = 1e-3 if "psnr" in k else 1e-5
        np.testing.assert_allclose(again[k], v, atol=atol, err_msg=k)


def test_cli_refuses_a_missing_card(monkeypatch):
    from hugs_tpu_torch import main
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert main.cli(["--device", "cuda"]) == 2
