"""The port's Gaussian-sharded renderer and scene step (hugs_tpu_torch/
parallel/gauss_shard.py, gauss_train.py), its trainer route
(tpu.gauss_shard), the multi-host helpers and graft_entry, on the CPU.

hugs_tpu's own render_gauss_sharded and gauss scene step run on a CPU
device mesh only as slow tests (one 2-device forward of 64 Gaussians at
48x32 takes over a minute), which show them equal to its single-device
`render` and `scene_train_step`. So the port's sharded path is held to
those single-device functions of hugs_tpu, at tests/test_sharding.py::
make_scene's size (120 Gaussians, 48x32, no tile above the 1024 cap).

Every 2-rank check runs in one gloo group of 2 spawned ranks
(parallel/launch.py::run_ranks under a 60 s timeout, its ranks
terminated on expiry), the workers in parallel/check.py; the rest runs
in this process at world size 1 (a ('gauss',) mesh of one rank with no
group, which runs the whole fragment path).

- (1) world 1: render(gauss_mesh=...) = render() bit for bit, and its
  gradients at the render's bars; frag_counts = the kept instances. On
  the card (marked `cuda`): K1 on the fragment band = K1 on the bins,
  K2's gradients at K2's bars (atol 1e-5 + rtol 1e-3).
- (2) 2 ranks: the frame = hugs_tpu's render at atol 2e-5; the gradients
  of means, opacity and SH (each rank's rows of loss / 2) = hugs_tpu's
  at atol 1e-6 + rtol 1e-4; frag_counts = hugs_tpu's bin_gaussians at
  (W, 2 band_h) split by owner and band; an overflow at frag_cap 8; the
  skew of a clustered scene.
- (3) The step: 4 gauss steps, a densify fed hugs_tpu's split noise, 4
  more, against hugs_tpu's scene_train_step and scene_densify_step: the
  loss each step at test_torch_train.py's bar (rtol 1e-3), the
  statistics at hugs_tpu's sharded bars (rtol 5e-3, atol 2e-6; denom
  exact), n_alive equal.
- (4) The trainer: render_frame with gauss_shard 2 = with 0 (image bar);
  a scene-mode run with gauss_shard 2 and two densifies loses loss and
  equals the world-1 run's losses.
- (5) The multi-host helpers and graft_entry's dryrun on 2 ranks
  (entry()'s frame is in test_torch_pergs.py).
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hugs_tpu_torch.cfg import load_config
from hugs_tpu_torch.parallel import check
from hugs_tpu_torch.parallel.launch import RANK_THREADS, run_ranks
from hugs_tpu_torch.parallel.mesh import Mesh, make_gauss_mesh
from hugs_tpu_torch.parallel.shard import band_height
from hugs_tpu_torch.render.renderer import render
from hugs_tpu_torch.render.tiles import tile_grid
from torch_parity import (  # noqa: F401 (cuda_device: a fixture)
    cameras, cuda_device, make_scene, np_of,
)

W, H = 48, 32
WORLD = 2
BUDGET = 1024            # each rank's slots (hugs_tpu's test's local budget)
TIMEOUT = 60.0
IMAGE_ATOL = 2e-5
GRAD_TOL = dict(atol=1e-6, rtol=1e-4)
LOSS_RTOL = 1e-3
STAT_TOL = dict(rtol=5e-3, atol=2e-6)
BG = np.array([0.1, 0.2, 0.3], np.float32)
CAP = 256
STEPS = (4, 4)
DENSIFY_KW = dict(grad_threshold=2e-5, min_opacity=0.005)
EXTENT = 2.0
# the trainers: test_torch_parallel.py's human_scene one (768 rows in
# all, which 2 ranks divide), and a scene-mode run densified twice
RENDER_TRAINER = ["mode=human_scene", "train.num_steps=0",
                  "human.init_steps=3", "human.triplane_res=16",
                  "human.n_subdivision=0", "human.use_deformer=true",
                  "human.disable_posedirs=true", "human.loss.lpips_w=0.0",
                  "human.loss.humansep_w=0.0", "human.loss.patch_size=16",
                  "tpu.scene_capacity=256", "tpu.human_capacity=512",
                  "tpu.smpl_vpb=8"]
SCENE_TRAINER = ["mode=scene", "train.num_steps=10",
                 "train.val_interval=10000", "scene.densify_from_iter=2",
                 "scene.densification_interval=4",
                 "scene.densify_grad_threshold=0.00001",
                 "tpu.scene_capacity=256", "tpu.instance_budget=32768"]


@pytest.fixture(autouse=True, scope="module")
def _rank_threads():
    """torch on RANK_THREADS CPU threads, as in the spawned ranks."""
    n = torch.get_num_threads()
    torch.set_num_threads(RANK_THREADS)
    yield
    torch.set_num_threads(n)


def _jax_render(scene, jcam, bg, deg=3):
    from hugs_tpu.render import render as jax_render
    return jax_render(*(jnp.asarray(scene[k]) for k in (
        "means", "scales", "rotq", "opacity", "shs")), jcam, W, H,
        bg=jnp.asarray(bg), active_sh_degree=deg, backend="tiled")


@functools.lru_cache(maxsize=None)
def _case():
    """The parity scene, its camera in both packages, the gradient's
    cotangent g, and the clustered scene of test_frag_count_skew."""
    scene = make_scene(n=120, seed=0)
    jcam, tcam = cameras()
    g = np.random.default_rng(2).normal(size=(3, H, W)).astype(np.float32)
    skew = dict(scene)
    skew["means"] = scene["means"].copy()
    skew["means"][:, 1] = np.abs(skew["means"][:, 1]) * 0.2 - 0.8
    cam_np = {f: np_of(getattr(tcam, f)) for f in tcam._fields}
    return scene, jcam, tcam, cam_np, g, skew


@functools.lru_cache(maxsize=None)
def _jax_ref():
    """hugs_tpu's single-device frame and gradients of sum(g x frame)."""
    scene, jcam, _, _, g, _ = _case()

    def loss(m, o, s):
        out = _jax_render(dict(scene, means=m, opacity=o, shs=s), jcam, BG)
        return jnp.sum(out["render"] * g), out
    (_, out), grads = jax.jit(jax.value_and_grad(
        loss, argnums=(0, 1, 2), has_aux=True))(
        *(jnp.asarray(scene[k]) for k in check.GRAD_KEYS))
    return ({k: np.asarray(out[k]) for k in ("render", "radii",
                                             "visibility_filter")},
            dict(zip(check.GRAD_KEYS, (np.asarray(x) for x in grads))))


def _jax_frag_counts(scene, jcam, world):
    """hugs_tpu's bin_gaussians of the whole set at (W, world band_h),
    its kept instances counted by owner (row) and band (column)."""
    from hugs_tpu.render.project import project_gaussians
    from hugs_tpu.render.tiles import bin_gaussians
    band_h = band_height(H, world)

    @jax.jit
    def bins_of(m, s, q, o, c):
        pg = project_gaussians(m, s, q, o, c, jcam, W, H, 3)
        return bin_gaussians(pg, W, world * band_h, 2 * BUDGET, align=1)
    bins = bins_of(*(jnp.asarray(scene[k]) for k in (
        "means", "scales", "rotq", "opacity", "shs")))
    gid = np.asarray(bins.gauss_id)
    starts, ends = np.asarray(bins.starts), np.asarray(bins.ends)
    nx, ny = tile_grid(W, band_h)
    per = scene["means"].shape[0] // world
    counts = np.zeros((world, world), np.int64)
    for t in range(len(starts)):
        for i in gid[starts[t]:ends[t]]:
            counts[i // per, t // (nx * ny)] += 1
    return counts


@functools.lru_cache(maxsize=None)
def _step_case():
    """hugs_tpu's anisotropic create_from_pcd state (128 points in 256
    rows), the target, rates and split noise; the port's numpy
    arguments of check.gauss_steps."""
    from hugs_tpu.models import scene_gs as jscene
    from hugs_tpu.train import scene_step as jstep
    rng = np.random.RandomState(5)
    pts = rng.uniform(-1.5, 1.5, (128, 3)).astype(np.float32)
    pts[:, 2] = np.abs(pts[:, 2]) + 3.0
    gs = jscene.create_from_pcd(jnp.asarray(pts),
                                jnp.asarray(rng.rand(128, 3), jnp.float32),
                                CAP)
    # anisotropic, so that no rotation gradient is rounding noise
    # (test_torch_train.py's _jax_state)
    r2 = np.random.default_rng(1)
    gs = gs._replace(
        rotation=gs.rotation.at[:128].set(jnp.asarray(
            r2.normal(size=(128, 4)).astype(np.float32))),
        scaling=gs.scaling.at[:128].add(jnp.asarray(
            r2.normal(size=(128, 3)).astype(np.float32) * 0.3)))
    js = jstep.init_scene_train_state(gs)
    target = np.random.default_rng(3).uniform(size=(3, H, W)).astype(
        np.float32)
    bg = np.array([0.2, 0.1, 0.3], np.float32)
    from hugs_tpu.cfg import default_config
    static, sched = jstep.make_scene_lrs(default_config().scene.lr, EXTENT)
    key = jax.random.PRNGKey(11)
    noise = np.asarray(jax.random.normal(key, (2, CAP, 3)))
    lrs = [float(sched(i)) for i in range(sum(STEPS))]
    state_np = {"gs": {f: np.asarray(getattr(gs, f)) for f in gs._fields},
                "mu": {k: np.asarray(v) for k, v in js.opt.mu.items()},
                "nu": {k: np.asarray(v) for k, v in js.opt.nu.items()},
                "step": np.asarray(js.opt.step)}
    cam_np = _case()[3]
    args = (state_np, cam_np, target, bg, lrs, static, W, H, BUDGET, noise,
            EXTENT, DENSIFY_KW, STEPS[0])
    return js, key, target, bg, lrs, static, args


@functools.lru_cache(maxsize=None)
def _jax_steps():
    """hugs_tpu's trajectory: losses, statistics before the densify and
    after the last step, the densify's info."""
    from hugs_tpu.train import scene_step as jstep
    js, key, target, bg, lrs, static, _ = _step_case()
    jcam = _case()[1]
    losses, out = [], {}
    for i, lr in enumerate(lrs):
        if i == STEPS[0]:
            out["before"] = {f: np.asarray(getattr(js.gs, f))
                             for f in check.STAT_KEYS + ("alive",)}
            js, info = jstep.scene_densify_step(js, key, EXTENT, **DENSIFY_KW)
            out["info"] = {k: int(v) for k, v in info.items()}
        js, aux = jstep.scene_train_step(
            js, jcam, jnp.asarray(target), jnp.asarray(bg), jnp.float32(lr),
            static, width=W, height=H, instance_budget=8192)
        assert not bool(aux["overflowed"])
        losses.append(float(aux["loss"]))
    out["after"] = {f: np.asarray(getattr(js.gs, f))
                    for f in check.STAT_KEYS + ("alive",)}
    out["losses"] = losses
    return out


@pytest.fixture(scope="module")
def fake_root(tmp_path_factory):
    from test_data import write_fake_neuman
    root = str(tmp_path_factory.mktemp("neuman"))
    write_fake_neuman(root, n_frames=10, w=W, h=H)
    return root


@pytest.fixture(scope="module")
def ranks(fake_root):
    scene, _, _, cam_np, g, skew = _case()
    return run_ranks(check.gauss_worker, WORLD,
                     ((scene, cam_np, W, H, BG, g, BUDGET), skew,
                      _step_case()[-1], fake_root, RENDER_TRAINER,
                      SCENE_TRAINER), timeout=TIMEOUT)


# ------------------------------------------------------------ (1) world 1

def test_world1_equals_render():
    scene, _, tcam, _, g, _ = _case()
    outs, grads = [], []
    for mesh in (None, make_gauss_mesh(1)):
        t = {k: torch.tensor(v, requires_grad=k in check.GRAD_KEYS)
             for k, v in scene.items()}
        out = render(t["means"], t["scales"], t["rotq"], t["opacity"],
                     t["shs"], tcam, W, H, bg=torch.as_tensor(BG),
                     active_sh_degree=3, gauss_mesh=mesh,
                     instance_budget=None if mesh is None else BUDGET)
        (out["render"] * torch.as_tensor(g)).sum().backward()
        outs.append(out)
        grads.append({k: np_of(t[k].grad) for k in check.GRAD_KEYS})
    ref, got = outs
    np.testing.assert_array_equal(np_of(got["render"]), np_of(ref["render"]))
    for k in check.GRAD_KEYS:
        np.testing.assert_allclose(grads[1][k], grads[0][k], **GRAD_TOL,
                                   err_msg=k)
    np.testing.assert_array_equal(np_of(got["radii"]), np_of(ref["radii"]))
    np.testing.assert_array_equal(np_of(got["visibility_filter"]),
                                  np_of(ref["visibility_filter"]))
    assert not bool(got["overflowed"])
    assert int(got["n_instances"]) == int(got["n_slots"]) == 0
    # every kept instance of the frame is one fragment
    from hugs_tpu_torch.render.project import project_gaussians
    from hugs_tpu_torch.render.tiles import bin_gaussians
    with torch.no_grad():
        pg = project_gaussians(*(torch.as_tensor(scene[k]) for k in (
            "means", "scales", "rotq", "opacity", "shs")), tcam, W, H, 3)
        bins = bin_gaussians(pg, W, H, BUDGET)
    assert got["frag_counts"].tolist() == [[int(
        (bins.ends - bins.starts).sum())]]


@pytest.mark.cuda
def test_world1_on_the_card(cuda_device):
    from hugs_tpu_torch import convert
    from hugs_tpu_torch.render import cuda_blend
    scene, _, _, cam_np, g, _ = _case()
    cam = convert.camera_from_numpy(cam_np, cuda_device)
    outs, grads = [], []
    for mesh in (None, make_gauss_mesh(1)):
        t = {k: torch.tensor(v, device=cuda_device,
                             requires_grad=k in check.GRAD_KEYS)
             for k, v in scene.items()}
        n0 = (cuda_blend.LAUNCHES, cuda_blend.K2_LAUNCHES)
        out = render(t["means"], t["scales"], t["rotq"], t["opacity"],
                     t["shs"], cam, W, H,
                     bg=torch.tensor(BG, device=cuda_device),
                     active_sh_degree=3, gauss_mesh=mesh,
                     instance_budget=BUDGET)
        (out["render"] * torch.tensor(g, device=cuda_device)).sum().backward()
        torch.cuda.synchronize()
        assert (cuda_blend.LAUNCHES - n0[0], cuda_blend.K2_LAUNCHES - n0[1]) \
            == (1, 1)
        outs.append(np_of(out["render"]))
        grads.append({k: np_of(t[k].grad) for k in check.GRAD_KEYS})
    np.testing.assert_array_equal(outs[1], outs[0])
    for k in check.GRAD_KEYS:
        np.testing.assert_allclose(grads[1][k], grads[0][k], atol=1e-5,
                                   rtol=1e-3, err_msg=k)


def test_gauss_mesh_refuses_other_worlds():
    with pytest.raises(ValueError, match="none is initialised"):
        make_gauss_mesh(2)
    mesh = make_gauss_mesh(1)
    assert mesh.shape == {"gauss": 1} and not mesh.distributed
    scene, _, tcam, _, _, _ = _case()
    t = {k: torch.as_tensor(v[:119]) for k, v in scene.items()}
    from hugs_tpu_torch.parallel.gauss_shard import render_gauss_sharded
    with pytest.raises(ValueError, match="divisible"):
        render_gauss_sharded(t["means"], t["scales"], t["rotq"],
                             t["opacity"], t["shs"], tcam, W, H,
                             Mesh.line("gauss", 2))


# ------------------------------------------------------- (2) two ranks

def test_two_rank_frame_matches_jax(ranks):
    want = _jax_ref()[0]["render"]
    for r in ranks:
        assert not r["render"]["overflowed"]
        np.testing.assert_allclose(r["render"]["render"], want,
                                   atol=IMAGE_ATOL)
    np.testing.assert_array_equal(ranks[0]["render"]["render"],
                                  ranks[1]["render"]["render"])


def test_two_rank_gradients_match_jax(ranks):
    """Each rank's rows of its gradient of loss / 2, summed over the
    ranks (the other rows are zero on each), = hugs_tpu's gradient."""
    _, want = _jax_ref()
    per = _case()[0]["means"].shape[0] // WORLD
    for k in check.GRAD_KEYS:
        got = sum(r["render"]["grads"][k] for r in ranks)
        np.testing.assert_allclose(got, want[k], **GRAD_TOL, err_msg=k)
        for d, r in enumerate(ranks):
            other = np.ones(got.shape[0], bool)
            other[d * per:(d + 1) * per] = False
            assert not r["render"]["grads"][k][other].any(), k


def test_two_rank_frag_counts_match_jax_binning(ranks):
    scene, jcam = _case()[0], _case()[1]
    want = _jax_frag_counts(scene, jcam, WORLD)
    jr = _jax_ref()[0]
    for r in ranks:
        np.testing.assert_array_equal(r["render"]["frag_counts"], want)
        np.testing.assert_allclose(r["render"]["radii"], jr["radii"],
                                   atol=1e-5)
        np.testing.assert_array_equal(r["render"]["visibility_filter"],
                                      jr["visibility_filter"])


def test_packet_overflow_detected(ranks):
    for r in ranks:
        assert r["overflow"]["overflowed"]
        assert not r["render"]["overflowed"]


def test_frag_count_skew_measured(ranks):
    """A clustered scene: most instances land in the top band."""
    fc = ranks[0]["skew"]["frag_counts"]
    per_band = fc.sum(axis=0)
    assert per_band.max() > 2 * max(per_band.min(), 1)


# ------------------------------------------------------------ (3) step

def test_gauss_step_trajectory_matches_jax(ranks):
    want = _jax_steps()
    assert want["info"]["n_alive"] > 128     # the densify grew the set
    for r in ranks:
        got = r["steps"]
        assert not any(got["overflowed"])
        np.testing.assert_allclose(got["losses"], want["losses"],
                                   rtol=LOSS_RTOL)
        assert got["info"]["n_alive"] == want["info"]["n_alive"]
        for when in ("before", "after"):
            np.testing.assert_array_equal(got[when]["alive"],
                                          want[when]["alive"])
            np.testing.assert_array_equal(got[when]["denom"],
                                          want[when]["denom"])
            np.testing.assert_allclose(got[when]["xyz_gradient_accum"],
                                       want[when]["xyz_gradient_accum"],
                                       **STAT_TOL, err_msg=when)
        assert got["frag_counts"].shape == (WORLD, WORLD)
    assert ranks[0]["steps"]["losses"] == ranks[1]["steps"]["losses"]
    for k, v in ranks[0]["steps"]["after"].items():
        np.testing.assert_array_equal(v, ranks[1]["steps"]["after"][k],
                                      err_msg=k)


def test_world1_step_matches_two_ranks(ranks):
    """The same step at world size 1 in this process."""
    got = check.gauss_steps(make_gauss_mesh(1), *_step_case()[-1])
    np.testing.assert_allclose(ranks[0]["steps"]["losses"], got["losses"],
                               rtol=1e-5)
    assert ranks[0]["steps"]["info"] == got["info"]


# ------------------------------------------------------- (4) trainer

def test_trainer_render_frame_gauss_shard(ranks):
    for r in ranks:
        assert r["trainer"]["render_err"] <= IMAGE_ATOL
        assert r["trainer"]["render_frag_counts"].shape == (WORLD, WORLD)


def test_trainer_scene_mode_gauss_shard(ranks, fake_root):
    """train() in scene mode with gauss_shard 2 and two densifies: the
    loss falls, the population grows, xyz moves, and the logged losses
    equal a world-1 run's."""
    ref = check.small_trainer(fake_root, SCENE_TRAINER, Mesh())
    want = [e["loss"] for e in ref.train()]
    for r in ranks:
        t = r["trainer"]
        assert np.isfinite(t["losses"]).all()
        assert t["losses"][-1] < t["losses"][0]
        assert t["n_alive"][1] > t["n_alive"][0]
        assert t["xyz_moved"] > 0
        np.testing.assert_allclose(t["losses"], want, rtol=LOSS_RTOL)


def test_trainer_gauss_shard_world_mismatch(fake_root):
    with pytest.raises(ValueError, match="process group of 2 ranks"):
        tr = check.small_trainer(fake_root, SCENE_TRAINER
                                 + ["tpu.gauss_shard=2"], Mesh())
        tr.train()


def test_check_supported_gauss_shard():
    from hugs_tpu_torch.cfg import check_supported
    check_supported(load_config(None, ["tpu.gauss_shard=4"]))
    with pytest.raises(ValueError):
        check_supported(load_config(None, ["tpu.gauss_frag_cap=-8"]))


# ------------------------------------------- (5) multi-host, graft_entry

def test_multihost_helpers(ranks):
    for rank, r in enumerate(ranks):
        m = r["multihost"]
        assert m["default"] == {"data": 1, "tile": WORLD}
        assert m["tile1"] == {"data": WORLD, "tile": 1}
        assert m["bad"] is not None and "divide" in m["bad"]
        np.testing.assert_array_equal(m["batch"]["rgb"],
                                      np.full((2, 3, 4, 4), rank))
        np.testing.assert_array_equal(m["batch"]["idx"],
                                      np.arange(2) + 2 * rank)


def test_dryrun_multichip_two_ranks(ranks):
    for r in ranks:
        d = r["dryrun"]
        assert d["mesh"] == (1, 2) and d["gauss_ranks"] == WORLD
        assert d["frag_counts"].shape == (WORLD, WORLD)
    assert ranks[0]["dryrun"]["loss"] == ranks[1]["dryrun"]["loss"]
    assert ranks[0]["dryrun"]["gauss_loss"] == ranks[1]["dryrun"][
        "gauss_loss"]
