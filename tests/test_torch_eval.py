"""The port's evaluation command, its tracing hooks and visualization
exports, and the flagship checkpoint carried across from hugs_tpu.

- hugs_tpu_torch.evaluate on a tiny trained output directory (the CLI's
  set-up of tests/test_torch_trainer.py on tests/test_data.py's fake
  NeuMan sequence, plus a fake AMASS clip, --device cpu): it writes
  results_eval.json (validate's metrics of the final checkpoint, within
  validate's bars of main's own), the anim and the canon PNGs; it
  returns 1 without config_train.yaml or a checkpoint, 2 without a card
  unless --device cpu;
- utils/profiling.py and utils/vis.py's OBJ writers;
- evidence/ckpt_flagship (the JAX package's joint checkpoint at step
  14,998): restored by hugs_tpu into an eval trainer with
  scripts/fps_bench_tpu.py:61-80's settings, written in the port's
  layout by convert.save_checkpoint_from_numpy, loaded by the port's
  evaluation path (load_latest_ckpt, compact_for_eval) and rendered,
  human and scene merged, at 160x90 from fps_bench_tpu.py's camera by
  both packages: image atol 2e-5 (hugs_tpu's `tiled` backend at a
  tile_cap above the frame's densest tile).

JAX is imported inside the tests that use it: the card test collects on
a machine without it.
"""
import json
import os
import shutil
import subprocess
import sys
import warnings

import numpy as np
import pytest
import torch

from hugs_tpu_torch import evaluate
from hugs_tpu_torch.cfg import load_config
from hugs_tpu_torch.data.cameras import (
    get_rotating_camera, get_smpl_static_params,
)
from hugs_tpu_torch.models.smpl import synthetic_smpl
from hugs_tpu_torch.render import cuda_blend
from hugs_tpu_torch.train.trainer import GaussianTrainer
from hugs_tpu_torch.utils import profiling, vis

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
METRIC_KEYS = {"hugs_psnr", "hugs_ssim", "hugs_lpips_uncalibrated",
               "hugs_human_psnr", "hugs_human_ssim",
               "hugs_human_lpips_uncalibrated"}
CANON_FRAMES = 3
FLAGSHIP = os.path.join(REPO, "evidence", "ckpt_flagship")


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """A 4-step run of hugs_tpu_torch.main on the fake sequence with a
    12-frame AMASS clip (3 anim frames): its logdir."""
    from hugs_tpu_torch import main
    from test_data import write_fake_neuman
    from test_torch_anim import write_amass
    base = str(tmp_path_factory.mktemp("eval"))
    root = os.path.join(base, "neuman")
    write_fake_neuman(root, n_frames=10, w=48, h=32)
    write_amass(base, 12, 2, root=root)
    cfg = load_config(os.path.join(REPO, "cfg_files", "neuman",
                                   "hugs_human_scene.yaml"), [
        f"dataset_path={root}", "dataset.seq=lab",
        f"output_path={base}/out", "exp_name=eval", "train.num_steps=4",
        "human.triplane_res=16", "human.n_subdivision=0",
        "human.init_steps=3", "human.loss.patch_size=16",
        f"human.canon_nframes={CANON_FRAMES}", "tpu.scene_capacity=256",
        "tpu.human_capacity=512", "tpu.smpl_vpb=8"])
    assert main.main(cfg, device="cpu") == 0
    return cfg.logdir


def _pngs(path):
    return sorted(f for f in os.listdir(path) if f.endswith(".png"))


def test_main_animates_and_renders_the_turntable(trained):
    """main() after validating: the anim split's frames, the canonical
    turntable, and at iteration 0 the PLYs and a turntable."""
    assert _pngs(os.path.join(trained, "anim", "final")) == [
        f"{i:05d}.png" for i in range(3)]
    for it in ("final", "000000"):
        assert len(_pngs(os.path.join(trained, "canon", it))) \
            == CANON_FRAMES
    assert {"human_000000_splat.ply", "scene_000000_splat.ply"} <= set(
        os.listdir(os.path.join(trained, "meshes")))


def test_evaluate_cli_writes_metrics_anim_and_canon(trained):
    """python -m hugs_tpu_torch.evaluate -o LOGDIR --device cpu: the final
    checkpoint's metrics after compaction and rehearsal equal main's
    validate (PSNR atol 1e-3 dB, SSIM and LPIPS 1e-5); new anim and
    canon frames."""
    with open(os.path.join(trained, "results_eval.json")) as f:
        first = json.load(f)
    for sub in ("anim", "canon"):
        shutil.rmtree(os.path.join(trained, sub, "final"))
    run = subprocess.run(
        [sys.executable, "-m", "hugs_tpu_torch.evaluate", "-o", trained,
         "--device", "cpu"], capture_output=True, text=True, cwd=REPO,
        env=dict(os.environ, PYTHONPATH=REPO), timeout=300)
    assert run.returncode == 0, run.stderr[-3000:]
    with open(os.path.join(trained, "results_eval.json")) as f:
        again = json.load(f)
    assert set(again) == set(first) == METRIC_KEYS
    for k, v in first.items():
        np.testing.assert_allclose(again[k], v, atol=1e-3 if "psnr" in k
                                   else 1e-5, err_msg=k)
    assert len(_pngs(os.path.join(trained, "anim", "final"))) == 3
    assert len(_pngs(os.path.join(trained, "canon", "final"))) \
        == CANON_FRAMES


def test_evaluate_stages(trained):
    """evaluate() in-process: 0, each stage's time, and a budget from the
    rehearsal of the val and anim frames, below the training one."""
    seen = {}

    class Spy(GaussianTrainer):
        def rehearse_budget(self, *a, **k):
            seen["before"] = self._ibudget
            seen["after"] = super().rehearse_budget(*a, **k)
            seen["frames"] = len(self.val_dataset) + len(self.anim_dataset)
            return seen["after"]
    times = {}
    assert evaluate.evaluate(trained, "cpu", trainer_cls=Spy,
                             times=times) == 0
    assert set(times) == {"load", "compact", "rehearse", "validate",
                          "animate", "canonical"}
    assert seen["after"] < seen["before"] and seen["frames"] == 4


def test_evaluate_refuses_without_config(tmp_path, capsys):
    assert evaluate.cli(["-o", str(tmp_path), "--device", "cpu"]) == 1
    assert "config_train.yaml" in capsys.readouterr().err


def test_evaluate_refuses_without_checkpoint(trained, tmp_path, capsys):
    shutil.copy(os.path.join(trained, "config_train.yaml"), tmp_path)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        assert evaluate.cli(["-o", str(tmp_path), "--device", "cpu"]) == 1
    assert "no checkpoint" in capsys.readouterr().err


def test_evaluate_refuses_a_missing_card(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert evaluate.cli(["-o", str(tmp_path)]) == 2


# --------------------------------------------------- tracing, vis

def test_step_timer_and_block():
    """block returns the tree it was given (no card here to wait for)."""
    tree = {"a": [torch.ones(3)], "b": (torch.zeros(2),)}
    assert profiling.block(tree) is tree


def test_debug_nans_and_trace(tmp_path):
    profiling.enable_debug_nans(True)
    try:
        assert torch.is_anomaly_enabled()
    finally:
        profiling.enable_debug_nans(False)
    assert not torch.is_anomaly_enabled()
    with profiling.trace(str(tmp_path / "prof")):
        with profiling.span("test.matmul", step=3):
            (torch.ones(64, 64) @ torch.ones(64, 64)).sum()
    with open(tmp_path / "prof" / "trace.json") as f:
        doc = json.load(f)
    spans = [e for e in doc["traceEvents"] if e.get("cat") == "span"]
    assert [(e["name"], e["args"]["step"]) for e in spans] == [
        ("test.matmul", 3)]
    assert spans[0]["dur"] >= 0


def test_obj_writers_as_jax(tmp_path):
    """save_skeleton_obj and save_ellipsoids_obj write hugs_tpu's files,
    byte for byte."""
    from hugs_tpu.utils import vis as jax_vis
    rng = np.random.RandomState(0)
    joints = rng.randn(24, 3).astype(np.float32)
    parents = [-1] + list(range(23))
    xyz = rng.randn(5, 3).astype(np.float32)
    scales = rng.rand(5, 3).astype(np.float32)
    q, _ = np.linalg.qr(rng.randn(5, 3, 3))
    for pkg, name in ((vis, "port"), (jax_vis, "jax")):
        pkg.save_skeleton_obj(joints, parents, str(tmp_path / name / "s.obj"))
        pkg.save_ellipsoids_obj(xyz, scales, q.astype(np.float32),
                                str(tmp_path / name / "e.obj"))
    for f in ("s.obj", "e.obj"):
        assert (tmp_path / "port" / f).read_bytes() \
            == (tmp_path / "jax" / f).read_bytes()
    assert (tmp_path / "port" / "e.obj").read_text().count("v ") == 5 * 36


# --------------------------------------------------------- the card

@pytest.mark.cuda
def test_rehearsal_launches_no_k1_on_the_card():
    """On the card the rehearsal's probes launch no K1 and a render of
    an aligned frame launches one."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the GPU machine)")
    dev = torch.device("cuda", 0)
    cfg = load_config(None, [
        "mode=human_scene", "eval=true", "human.triplane_res=16",
        "human.n_subdivision=0", "tpu.scene_capacity=256",
        "tpu.human_capacity=512", "tpu.smpl_vpb=8"])
    tr = GaussianTrainer(cfg, None, None, None,
                         smpl_model=synthetic_smpl(8, device=dev),
                         device=dev)
    align = {"manual_trans": np.array([0.1, 0.0, 0.2], np.float32),
             "manual_rotmat": np.eye(3, dtype=np.float32),
             "manual_scale": np.float32(1.2)}
    frames = [dict(get_smpl_static_params(np.zeros(10), device=dev), **c,
                   **align)
              for c in get_rotating_camera(img_size=(96, 128), dist=3.0,
                                           nframes=3, device=dev)]
    cuda_blend.LAUNCHES = 0
    budget = tr.rehearse_budget(frames)
    torch.cuda.synchronize()
    assert cuda_blend.LAUNCHES == 0 and budget % 8192 == 0
    img = tr.render_frame(frames[0], ext_tfs=tr.ext_tfs_of(frames[0]))
    torch.cuda.synchronize()
    assert cuda_blend.LAUNCHES == 1
    assert not bool(img["overflowed"])


# ------------------------------------------------------- the flagship

def _flagship_cfg(load):
    """scripts/fps_bench_tpu.py:61-80's evaluation configuration."""
    cfg = load(os.path.join(REPO, "cfg_files", "neuman",
                            "hugs_human_scene.yaml"))
    cfg.eval = True
    cfg.human.n_subdivision = 2
    cfg.human.max_n_gaussians = cfg.scene.max_n_gaussians = 131072
    cfg.tpu.human_capacity = cfg.tpu.scene_capacity = 131072
    cfg.tpu.smpl_vpb = 460
    return cfg


@pytest.fixture(scope="module")
def flagship(tmp_path_factory):
    """(hugs_tpu's eval trainer on the flagship checkpoint, the port's on
    its carried-across copy, that copy's directory)."""
    from hugs_tpu.cfg import load_config as jax_load
    from hugs_tpu.train.joint_step import JointTrainState
    from hugs_tpu.train.trainer import GaussianTrainer as JaxTrainer
    from hugs_tpu_torch import convert
    from test_torch_anim import no_lpips
    from torch_parity import jax_joint_to_numpy
    out = str(tmp_path_factory.mktemp("flagship"))
    jcfg = _flagship_cfg(jax_load)
    jcfg.logdir, jcfg.logdir_ckpt = FLAGSHIP, os.path.join(FLAGSHIP, "ckpt")
    with warnings.catch_warnings(), pytest.MonkeyPatch.context() as mp:
        # the checkpoint's 91 per-frame poses do not fit a trainer with
        # no train split; both keep their own (evaluation poses the body)
        warnings.simplefilter("ignore")
        no_lpips(mp)
        jt = JaxTrainer(jcfg, None, None, None)
        convert.save_checkpoint_from_numpy(
            os.path.join(out, "ckpt"), "014998",
            *jax_joint_to_numpy(JointTrainState(human=jt.human,
                                                scene=jt.scene)),
            device="cpu")
        tcfg = _flagship_cfg(load_config)
        tcfg.logdir, tcfg.logdir_ckpt = out, os.path.join(out, "ckpt")
        tt = GaussianTrainer(tcfg, None, None, None, device="cpu")
        assert tt.load_latest_ckpt()
    return jt, tt, out


def test_flagship_carried_across(flagship):
    """The port's checkpoint layout holds the flagship's step: 4,002
    human and 37,689 scene Gaussians alive, as hugs_tpu restored them,
    before and after compact_for_eval."""
    jt, tt, out = flagship
    assert sorted(os.listdir(os.path.join(out, "ckpt"))) == [
        "human_014998", "scene_014998"]
    assert (int(jt.human.state.alive.sum()), int(jt.scene.gs.alive.sum())) \
        == (int(tt.human.state.alive.sum()), int(tt.scene.gs.alive.sum())) \
        == (4002, 37689)
    assert int(tt.scene.gs.active_sh_degree) == 3
    tt.compact_for_eval()
    jt.compact_for_eval()
    assert tt.human.params.xyz.shape[0] == 4096
    assert tt.scene.gs.capacity == 40960
    assert (int(tt.human.state.alive.sum()),
            int(tt.scene.gs.alive.sum())) == (4002, 37689)


def test_flagship_merged_render_as_jax(flagship):
    """One pose under fps_bench_tpu.py's camera, 160x90, human and scene
    merged, the compacted states: the port's image equals hugs_tpu's."""
    from hugs_tpu.data.cameras import get_rotating_camera as jax_cams
    from hugs_tpu_torch.render import renderer
    jt, tt, _ = flagship
    if tt.scene.gs.capacity != 40960:      # run alone: compact first
        tt.compact_for_eval()
        jt.compact_for_eval()
    w, h = 160, 90
    body = {"global_orient": np.zeros(3, np.float32),
            "body_pose": (0.01 * np.sin(np.arange(69))).astype(np.float32),
            "betas": np.zeros(10, np.float32),
            "transl": np.zeros(3, np.float32),
            "smpl_scale": np.float32(1.0)}
    kw = dict(img_size=(h, w), fov=0.95, dist=3.0, nframes=2)
    tdata = dict(get_rotating_camera(device="cpu", **kw)[0], **body)
    jdata = dict(jax_cams(**kw)[0], **body)
    tt._ibudget = jt._ibudget = 1 << 19
    densest = []
    blend_tiles = renderer.cuda_blend.blend_tiles

    def spy(pg, bins, *a):
        densest.append(int((bins.ends - bins.starts).max()))
        return blend_tiles(pg, bins, *a)
    try:
        renderer.cuda_blend.blend_tiles = spy
        got = tt.render_frame(tdata, render_mode="human_scene")
    finally:
        renderer.cuda_blend.blend_tiles = blend_tiles
    assert not bool(got["overflowed"])
    jt.cfg.tpu.tile_cap = 1 << int(np.ceil(np.log2(densest[0] + 1)))
    want = jt.render_frame(jdata, render_mode="human_scene")
    assert not bool(want["overflowed"])
    np.testing.assert_allclose(got["render"].numpy(),
                               np.asarray(want["render"]), atol=2e-5)
    # the trained body is in the frame: its pass alone covers pixels
    human = tt.render_frame(tdata, render_mode="human",
                            bg=torch.zeros(3))["render"]
    assert float((human.amax(0) > 0.05).float().mean()) > 0.01


def test_warp_cull_counts_and_rows_read():
    """micro.warp_cull_counts and feat_rows_read (the counts behind K1's
    and K2's bounds in chip_smoke.py and serve_bench.py) against a count
    warp by warp on a 300-Gaussian frame, its n_walked the plain blend's
    tested counts."""
    from hugs_tpu_torch import micro
    from hugs_tpu_torch.render.blend import gauss_features, plain_blend
    from hugs_tpu_torch.render.project import project_gaussians
    from hugs_tpu_torch.render.tiles import TILE, bin_gaussians, tile_grid
    from torch_parity import H, W, cameras, make_scene, to_torch
    sc = to_torch(make_scene(300, seed=5))
    pg = project_gaussians(sc["means"], sc["scales"], sc["rotq"],
                           sc["opacity"], sc["shs"], cameras()[1], W, H, 3)
    bins = bin_gaussians(pg, W, H, 1 << 16)
    feat = gauss_features(pg)
    _, _, pairs = plain_blend(feat, bins.gauss_id, bins.starts, bins.ends,
                              torch.zeros(3), W, H)
    n_walked = pairs[0]
    got = micro.warp_cull_counts(feat, bins, n_walked, W, H)
    nx, ny = tile_grid(W, H, TILE)
    nw = np.zeros((ny * TILE, nx * TILE), np.int64)
    nw[:H, :W] = n_walked.numpy()
    want = dict.fromkeys(("tested", "K1", "K2", "K2_kept"), 0)
    rows = set()
    for t in range(nx * ny):
        s0, e0 = int(bins.starts[t]), int(bins.ends[t])
        rows |= set(bins.gauss_id[s0:e0].tolist())
        for r in range(TILE // 2):
            y = (t // nx) * TILE + 2 * r
            walk = nw[y:y + 2, (t % nx) * TILE:(t % nx + 1) * TILE].ravel()
            k1_len = min(-(-int(walk.max()) // 32) * 32, e0 - s0)
            ids = bins.gauss_id[s0:s0 + k1_len]
            keep = cuda_blend.warp_cull(
                feat, ids, torch.full_like(ids, t % nx),
                torch.full_like(ids, (t // nx) * TILE // 2 + r)).numpy()
            want["K1"] += k1_len
            want["K2"] += int(walk.max())
            want["K2_kept"] += int(keep[:walk.max()].sum())
            want["tested"] += sum(int(keep[:n].sum()) for n in walk)
    assert want["tested"] > 0 and want["K1"] > want["K2_kept"]
    assert {k: got[k] for k in want} == want
    assert micro.feat_rows_read(bins) == len(rows)
