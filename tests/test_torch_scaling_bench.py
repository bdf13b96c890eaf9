"""The port's scaling harness (hugs_tpu_torch/scaling_bench.py) against
scripts/scaling_bench.py and hugs_tpu's data x tile step, on the CPU.

A cut of the script's defaults: 32x32, capacity 256 for the human and
the scene, synthetic_smpl(4), a 32^2 triplane of 8 features (the
script's), budget 8192, one timed step after the warm-up. hugs_tpu's
step runs its `tiled` backend at tile_cap 1024 (the script's 128 drops
instances past it in the densest tiles here; the port's kernels truncate
nothing, and tile_cap is not ported): 512 rows in all, so no tile
holds more than the cap.

- (a) The worker on 2 gloo ranks (parallel/launch.py::run_ranks, 60 s),
  its models hugs_tpu's __graft_entry__._build_models carried across
  with convert: the loss after the warm-up and the timed step = hugs_tpu's
  make_dp_tile_train_step on a (2, 1) mesh of the CPU devices over the
  script's frames (each rank's from RandomState(1234 + rank)) at
  test_torch_parallel.py's LOSS_TOL; grad_payload_mb = the script's
  n_grad formula on the JAX models; the JSON keys include the script's;
  both ranks end in the same state.
- (b) The launcher (its runs cut at 60 s here; the one-process run at
  ONE_PROCESS_TIMEOUT): one CPU process end to end (scaling.json
  written, its rank at RANK_THREADS threads); a failing worker, an N
  above the cards and no card each exit non-zero with no JSON line.
"""
import ast
import functools
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hugs_tpu_torch import scaling_bench as sb
from hugs_tpu_torch.parallel.launch import RANK_THREADS, run_ranks
from torch_parity import human_cfg_to_torch, jax_joint_to_numpy, smpl_arrays

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
W = H = 32
CAPACITY = 256
VPB = 4
BUDGET = 8192
ITERS = 1
WORLD = 2
TIMEOUT = 60.0
# The one-process launcher run starts three interpreters (this test's
# launcher, torchrun's agent, the worker), each importing torch, and
# takes one step: 8 s on an idle 8-core machine, 9-29 s beside busy
# processes, 15 s under the suite's 6-worker command; 60 s once expired
# under that command on a more loaded machine. The cut only stops a run
# that hangs: about 4 times the 29 s worst seen, and short enough that a
# hang fails this test inside the suite's time limit.
ONE_PROCESS_TIMEOUT = 120.0
LOSS_TOL = dict(atol=2e-5, rtol=2e-6)
OPTS = dict(width=W, height=H, capacity=CAPACITY, budget=BUDGET, n_tile=1,
            iters=ITERS, verts_per_bone=VPB, triplane_res=32, n_features=8,
            device="cpu")
CLI = ["--device", "cpu", "--width", str(W), "--height", str(H),
       "--capacity", str(CAPACITY), "--verts_per_bone", str(VPB),
       "--iters", str(ITERS)]


@pytest.fixture(autouse=True, scope="module")
def _rank_threads():
    """torch on RANK_THREADS CPU threads, as in the spawned ranks."""
    n = torch.get_num_threads()
    torch.set_num_threads(RANK_THREADS)
    yield
    torch.set_num_threads(n)


def _script_keys() -> set:
    """The keys of the JSON line scripts/scaling_bench.py prints."""
    with open(os.path.join(REPO, "scripts", "scaling_bench.py")) as f:
        tree = ast.parse(f.read())
    for node in ast.walk(tree):
        if (isinstance(node, ast.Call) and getattr(node.func, "attr", "")
                == "dumps" and node.args
                and isinstance(node.args[0], ast.Dict)):
            return {k.value for k in node.args[0].keys}
    raise AssertionError("no json.dumps of a dict in the script")


@functools.lru_cache(maxsize=None)
def _jax_run():
    """hugs_tpu's side: the script's models, frames and step on a (2, 1)
    mesh; warm-up plus ITERS steps. Returns (the last loss, n_grad, the
    models as the port's numpy inputs)."""
    import jax.tree_util as jtu
    from jax.sharding import Mesh

    from __graft_entry__ import _build_models
    from hugs_tpu.cfg import default_config
    from hugs_tpu.losses.loss import HumanSceneLoss
    from hugs_tpu.models.smpl import synthetic_smpl
    from hugs_tpu.parallel.train_dp_tile import make_dp_tile_train_step
    from hugs_tpu.render import make_camera
    from hugs_tpu.train.human_step import (init_human_train_state,
                                           make_human_lrs)
    from hugs_tpu.train.joint_step import JointTrainState
    from hugs_tpu.train.scene_step import (init_scene_train_state,
                                           make_scene_lrs)

    mesh = Mesh(np.array(jax.devices()[:WORLD]).reshape(WORLD, 1),
                ("data", "tile"))
    cfg, hp, hs, fixed, scene = _build_models(
        jax.random.PRNGKey(0), verts_per_bone=VPB, human_capacity=CAPACITY,
        scene_n=CAPACITY, scene_capacity=CAPACITY, triplane_res=32,
        n_features=8, n_frames=WORLD)
    js = JointTrainState(human=init_human_train_state(hp, hs),
                         scene=init_scene_train_state(scene))
    carried = (jax_joint_to_numpy(js), smpl_arrays(synthetic_smpl(VPB)),
               human_cfg_to_torch(cfg)._asdict())
    n_grad = sum(x.size for x in jtu.tree_leaves(
        (hp, [scene.xyz, scene.features_dc, scene.features_rest,
              scene.opacity, scene.scaling, scene.rotation]))) \
        + 2 * (hp.xyz.shape[0] + scene.capacity)
    loss_fn = HumanSceneLoss(l_l1_w=0.8, l_ssim_w=0.2, l_lbs_w=10.0,
                             l_humansep_w=0.0, use_patches=False)
    step = make_dp_tile_train_step(mesh, fixed, cfg, width=W, height=H,
                                   loss_fn=loss_fn, tile_cap=1024,
                                   instance_budget=BUDGET, tile=16,
                                   backend="tiled")
    d = default_config()
    h_static, h_sched = make_human_lrs(d.human.lr)
    s_static, s_sched = make_scene_lrs(d.scene.lr, 1.0)
    # the script's frames, one a rank (local_frames = 1)
    cams, targets, masks = [], [], []
    for rank in range(WORLD):
        rng = np.random.RandomState(1234 + rank)
        cams.append(make_camera(jnp.eye(3), jnp.array([0.1 * rank, 0.2,
                                                       2.5]), 0.9, 0.9))
        targets.append(rng.rand(1, 3, H, W).astype(np.float32))
        masks.append((rng.rand(1, H, W) > 0.3).astype(np.float32))
    cam = jax.tree.map(lambda *x: jnp.stack(x), *cams)
    args = (cam, jnp.asarray(np.concatenate(targets)),
            jnp.asarray(np.concatenate(masks)), jnp.ones((WORLD, 3)),
            jnp.ones((WORLD, 3)), jnp.ones(WORLD),
            jnp.arange(WORLD, dtype=jnp.int32),
            jnp.stack([jax.random.PRNGKey(7)] * WORLD))
    lrs = (jnp.float32(h_sched(0)), h_static, jnp.float32(s_sched(0)),
           s_static)
    with mesh:
        for _ in range(1 + ITERS):
            js, aux = step(js, *args, *lrs)
        loss = float(aux["loss"])
        assert not bool(aux["overflowed"])
    return loss, n_grad, carried


@pytest.fixture(scope="module")
def ranks():
    return run_ranks(sb.worker_rank, WORLD, (OPTS, "cpu", _jax_run()[2]),
                     timeout=TIMEOUT)


def test_worker_loss_matches_jax_dp_tile_step(ranks):
    want = _jax_run()[0]
    for r in ranks:
        assert not r["overflowed"]
        np.testing.assert_allclose(r["loss"], want, **LOSS_TOL)
    assert ranks[0]["state_digests"][0] == ranks[0]["state_digests"][1]


def test_worker_payload_and_keys_are_the_scripts(ranks):
    n_grad = _jax_run()[1]
    r = ranks[0]
    assert r["n_grad"] == n_grad
    assert r["grad_payload_mb"] == round(n_grad * 4 / 1e6, 2)
    assert _script_keys() == set(sb.SCRIPT_KEYS)
    assert set(sb.SCRIPT_KEYS) <= set(r)
    assert r["procs"] == WORLD and r["n_frames"] == WORLD
    assert r["mesh"] == {"data": WORLD, "tile": 1}
    assert r["backend"] == "plain" and r["iters"] == ITERS
    assert r["comm_fraction"] == pytest.approx(
        r["grad_allreduce_ms"] / r["step_ms"])
    assert r["px_per_s"] == pytest.approx(W * H * WORLD * 1e3 / r["step_ms"])


def test_worker_frames_follow_the_ranks():
    """Frame d is the script's process d's: its target from
    RandomState(1234 + d), in the whole batch every rank takes."""
    frames = sb.whole_batch(4, 8, 4, "cpu")
    assert [f["dataset_idx"] for f in frames] == [0, 1, 2, 3]
    rng = np.random.RandomState(1237)
    np.testing.assert_array_equal(frames[3]["rgb"].numpy(),
                                  rng.rand(1, 3, 4, 8).astype(np.float32)[0])
    # t = (0.1 * 3, 0.2, 2.5) with R = I: the centre is -t
    np.testing.assert_allclose(frames[3]["camera"].center.numpy(),
                               [-0.3, -0.2, -2.5], atol=1e-6)


def test_launcher_one_process(tmp_path, capsys, monkeypatch):
    monkeypatch.setattr(sb, "TIMEOUT", ONE_PROCESS_TIMEOUT)
    monkeypatch.delenv("OMP_NUM_THREADS", raising=False)
    envs = []
    run = sb.subprocess.run

    def recorded(cmd, **kw):
        envs.append(kw["env"])
        return run(cmd, **kw)

    monkeypatch.setattr(sb.subprocess, "run", recorded)
    assert sb.main(["launcher", "--procs", "1", "--out", str(tmp_path)]
                   + CLI) == 0
    assert [e["OMP_NUM_THREADS"] for e in envs] == [str(RANK_THREADS)]
    lines = [ln for ln in capsys.readouterr().out.splitlines()
             if ln.startswith("{")]
    with open(tmp_path / "scaling.json") as f:
        recs = json.load(f)
    assert len(recs) == 1 and json.loads(lines[-1]) == recs[0]
    assert recs[0]["procs"] == 1 and recs[0]["mesh"] == {"data": 1,
                                                         "tile": 1}
    assert set(sb.SCRIPT_KEYS) <= set(recs[0])
    assert np.isfinite(recs[0]["loss"])


def test_launcher_fails_with_its_worker(tmp_path, capsys, monkeypatch):
    """n_tile 3 does not divide a 2-rank host: the workers raise."""
    monkeypatch.setattr(sb, "TIMEOUT", TIMEOUT)
    assert sb.main(["launcher", "--procs", "2", "--n_tile", "3", "--out",
                    str(tmp_path)] + CLI) == 1
    cap = capsys.readouterr()
    assert "{" not in cap.out
    assert "exited with" in cap.err
    assert not (tmp_path / "scaling.json").exists()


def test_launcher_refuses_more_ranks_than_cards(tmp_path, capsys,
                                                monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)

    def no_run(*a, **k):
        raise AssertionError("the launcher started a run")

    monkeypatch.setattr(sb.subprocess, "run", no_run)
    assert sb.main(["launcher", "--procs", "1", "2", "--out",
                    str(tmp_path)]) == 1
    cap = capsys.readouterr()
    assert "{" not in cap.out and "[2] exceed the 1 CUDA" in cap.err


def test_no_card_exits_2(capsys, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert sb.main(["worker"]) == 2
    assert sb.main(["launcher"]) == 2
    assert "{" not in capsys.readouterr().out
