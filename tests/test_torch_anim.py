"""The serving half of the port's trainer against hugs_tpu's: the NeuMan
anim split, render_frame with the split's alignment, the binning-only
rehearsal, animate, render_canonical, render_poses, the PLY dumps and
the dump hooks.

The sequence is tests/test_data.py's fake NeuMan one (10 frames at
48x32) with fake AMASS clips: the split test reads test_data.py's clip
(100 frames of N(0, 0.1^2) angles, N(0, 1) translations: 25 anim
frames); the render tests read a 12-frame clip (3 anim frames) whose
translations invert lab's alignment, so that the aligned body stands 8
units in front of the anim cameras' capture. Both trainers run in eval
mode (human_scene, synthetic_smpl(8), capacities 512 and 256), the
port's states and LPIPS carried across from hugs_tpu's through convert.
On CPU tensors the port blends with its plain version; hugs_tpu runs its
`tiled` backend, whose tile_cap of 1024 no tile reaches here (768
Gaussians in all). Images are held at atol 2e-5, PLYs at 1e-6.
"""
import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hugs_tpu.cfg.config import load_config as jax_load
from hugs_tpu_torch import convert
from hugs_tpu_torch.cfg import check_supported, load_config
from hugs_tpu_torch.data import neuman
from hugs_tpu_torch.data.colmap import read_colmap_scene
from hugs_tpu_torch.models.smpl import synthetic_smpl
from hugs_tpu_torch.render import renderer
from hugs_tpu_torch.train import trainer as ttr
from hugs_tpu_torch.utils import image as timage
from hugs_tpu_torch.utils.ply import load_gaussian_ply
from hugs_tpu_torch.utils.png import read_png
from torch_parity import jax_joint_to_numpy, np_of

IMG_ATOL = 2e-5
CANON_FRAMES = 3
SMALL = ["mode=human_scene", "eval=true", "human.triplane_res=16",
         "human.n_subdivision=0", "human.use_deformer=true",
         "human.disable_posedirs=true", "human.loss.lpips_w=0.0",
         f"human.canon_nframes={CANON_FRAMES}", "tpu.scene_capacity=256",
         "tpu.human_capacity=512", "tpu.smpl_vpb=8", "tpu.tile_cap=1024"]


def write_amass(base, n_frames, seed, root=None):
    """A fake AMASS clip at base/SFU/0008 (lab's path): SMPL-H poses of
    N(0, 0.1^2) angles; translations N(0, 1), or, given the sequence's
    root, ones that put the aligned body 8 units in front of the anim
    cameras' capture (lab's alignment inverted), each moved by
    N(0, 0.02^2)."""
    rng = np.random.RandomState(seed)
    poses = rng.randn(n_frames, 156).astype(np.float32) * 0.1
    trans = rng.randn(n_frames, 3).astype(np.float32)
    if root is not None:
        images = read_colmap_scene(os.path.join(root, "lab", "sparse")).images
        im = images[min(neuman.ANIM_CAMS["lab"][0], len(images) - 1)]
        target = -im.R.T @ im.t + 8.0 * im.R.T[:, 2]
        tr, deg, sc = neuman.ALIGNMENTS["lab"]
        rot = neuman.euler_matrix(*np.radians(deg))
        trans = (rot.T @ (target - np.asarray(tr)) / sc)[None] \
            + 0.02 * trans
    path = os.path.join(base, "SFU", "0008")
    os.makedirs(path, exist_ok=True)
    np.savez(os.path.join(path, "0008_ChaCha001_poses.npz"), poses=poses,
             trans=trans.astype(np.float32))
    return base


@pytest.fixture(scope="module")
def seq(tmp_path_factory):
    """(root, the in-view clip's amass_root, test_data.py's clip's)."""
    from test_data import write_fake_neuman
    base = str(tmp_path_factory.mktemp("anim"))
    root = os.path.join(base, "neuman")
    write_fake_neuman(root, n_frames=10, w=48, h=32)
    write_amass(base, 12, 2, root=root)        # root/.. : the default
    rand = write_amass(os.path.join(base, "random"), 100, 1)
    return root, base, rand


@pytest.fixture(scope="module")
def pair(seq):
    """hugs_tpu's eval trainer with its val and anim splits, and the
    port's with its own, its states carried across."""
    from hugs_tpu.data import NeumanDataset as JaxDataset
    from hugs_tpu.models.smpl import synthetic_smpl as jax_smpl
    from hugs_tpu.train.joint_step import JointTrainState
    from hugs_tpu.train.trainer import GaussianTrainer
    root = seq[0]
    jcfg = jax_load(None, SMALL)
    with pytest.MonkeyPatch.context() as mp:
        no_lpips(mp)
        jt = GaussianTrainer(
            jcfg, None, JaxDataset(root, "lab", "val", render_mode=jcfg.mode),
            JaxDataset(root, "lab", "anim", render_mode=jcfg.mode),
            smpl_model=jax_smpl(verts_per_bone=8))
    tcfg = load_config(None, SMALL)
    tt = ttr.GaussianTrainer(
        tcfg, None,
        neuman.NeumanDataset(root, "lab", "val", render_mode=tcfg.mode,
                             device="cpu"),
        neuman.NeumanDataset(root, "lab", "anim", render_mode=tcfg.mode,
                             device="cpu"),
        smpl_model=synthetic_smpl(8, device="cpu"), device="cpu")
    js = convert.joint_state_from_numpy(
        *jax_joint_to_numpy(JointTrainState(human=jt.human, scene=jt.scene)),
        device="cpu")
    tt.human, tt.scene = js.human, js.scene
    return jt, tt


def no_lpips(mp):
    """hugs_tpu's trainer built without its LPIPS network (seconds of
    random VGG weights on the CPU): nothing here evaluates a metric."""
    import hugs_tpu.train.trainer as jtr
    mp.setattr(jtr.LPIPS, "create", staticmethod(lambda *a, **k: None))


def jax_ext(data):
    return (jnp.asarray(data["manual_trans"]),
            jnp.asarray(data["manual_rotmat"]),
            jnp.asarray(data["manual_scale"]).reshape(()))


def assert_images(got, want, what):
    assert len(got) == len(want), what
    for i, (a, b) in enumerate(zip(got, want)):
        np.testing.assert_allclose(np_of(a), np.asarray(b), atol=IMG_ATOL,
                                   err_msg=f"{what} {i}")


def logdirs(pair, tmp_path):
    """Points both trainers' logdir at their own directory under
    tmp_path; returns (hugs_tpu's, the port's)."""
    out = []
    for name, tr in zip(("jax", "port"), pair):
        tr.cfg.logdir = str(tmp_path / name)
        out.append(tr.cfg.logdir)
    return out


@pytest.fixture
def restore_logdir(pair):
    yield
    for tr in pair:
        tr.cfg.logdir = ""


# --------------------------------------------------------------- split

def test_anim_split_as_jax(seq):
    """test_data.py's clip through both loaders: every field of every
    frame, the cameras' too; arrays exact, floats to 1e-6."""
    from hugs_tpu.data import NeumanDataset as JaxDataset
    root, _, rand = seq
    got = neuman.NeumanDataset(root, "lab", "anim", amass_root=rand,
                               device="cpu")
    want = JaxDataset(root, "lab", "anim", amass_root=rand)
    assert len(got) == len(want) == 25
    for a, b in zip(got, want):
        assert set(a) == set(b) and "rgb" not in a
        for k in ("manual_trans", "manual_rotmat", "manual_scale", "betas",
                  "global_orient", "body_pose", "transl", "smpl_scale"):
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
        for k in ("width", "height", "fovx", "fovy", "near", "far"):
            np.testing.assert_allclose(a[k], b[k], atol=1e-6, err_msg=k)
        for f in ("world_view", "full_proj", "center", "tan_fovx",
                  "tan_fovy"):
            np.testing.assert_allclose(np_of(getattr(a["camera"], f)),
                                       np.asarray(getattr(b["camera"], f)),
                                       atol=1e-6, err_msg=f)
    # the alignment is lab's: a rotation and a scale other than 1
    assert abs(float(got[0]["manual_scale"]) - 3.0) < 1e-6
    rot = got[0]["manual_rotmat"]
    np.testing.assert_allclose(rot @ rot.T, np.eye(3), atol=1e-6)
    assert np.abs(rot - np.eye(3)).max() > 0.5


def test_anim_split_default_amass_root(seq, pair):
    """Without amass_root the split reads {root}/../SFU: the in-view
    clip, 12 frames at lab's step 4."""
    root, base, _ = seq
    ds = neuman.NeumanDataset(root, "lab", "anim", device="cpu")
    assert len(ds) == 3 == len(pair[1].anim_dataset)
    np.testing.assert_array_equal(
        ds[2]["transl"], np.load(os.path.join(
            base, "SFU", "0008", "0008_ChaCha001_poses.npz"))["trans"][8])


# ------------------------------------------------------ render_frame

def test_render_frame_with_ext_tfs_as_jax(pair):
    """Each anim frame, aligned by the split's transform, against
    hugs_tpu's; the body is in view and the alignment moves it."""
    jt, tt = pair
    for i in range(len(tt.anim_dataset)):
        td, jd = tt.anim_dataset[i], jt.anim_dataset[i]
        got = tt.render_frame(td, ext_tfs=tt.ext_tfs_of(td))["render"]
        want = jt.render_frame(jd, ext_tfs=jax_ext(jd))["render"]
        assert_images([got], [want], f"anim frame {i}")
    human = tt.render_frame(td, render_mode="human",
                            ext_tfs=tt.ext_tfs_of(td))["render"]
    assert float((human - tt.bg_color[:, None, None]).abs().amax(0)
                 .gt(0.05).float().mean()) > 0.05
    unaligned = tt.render_frame(td)["render"]
    assert float((unaligned - got).abs().max()) > 0.1


def test_forward_models_takes_the_alignment(pair):
    """forward_models(ext_tfs=...) places the body at tr + s R x, as
    human_forward does, and use_dataset_pose=False poses it from the
    learned table."""
    _, tt = pair
    d = tt.anim_dataset[0]
    plain, _ = tt.forward_models(d)
    moved, _ = tt.forward_models(d, ext_tfs=(d["manual_trans"],
                                             d["manual_rotmat"],
                                             d["manual_scale"]))
    tr, rot, sc = (torch.as_tensor(np.asarray(x, np.float32)) for x in (
        d["manual_trans"], d["manual_rotmat"], d["manual_scale"]))
    torch.testing.assert_close(moved["xyz"], tr + sc * plain["xyz"] @ rot.T,
                               atol=1e-5, rtol=1e-5)
    torch.testing.assert_close(moved["scales"], sc * plain["scales"])
    learned, _ = tt.forward_models(d, use_dataset_pose=False)
    assert float((learned["xyz"] - plain["xyz"]).abs().max()) > 1e-3


# ---------------------------------------------------------- rehearsal

def test_probe_slots_as_jax(pair, monkeypatch):
    """The binning-only probe of every val and anim frame: the slot
    demand and overflow hugs_tpu's probe gives, with no blend."""
    jt, tt = pair

    def no_blend(*a, **k):
        raise AssertionError("the probe blended")
    monkeypatch.setattr(renderer.cuda_blend, "blend_tiles", no_blend)
    frames = [(ds[i], jds[i]) for ds, jds in (
        (tt.val_dataset, jt.val_dataset), (tt.anim_dataset, jt.anim_dataset))
        for i in range(len(ds))]
    for td, jd in frames:
        ext = jax_ext(jd) if "manual_trans" in jd else None
        got = tt.render_frame(td, ext_tfs=tt.ext_tfs_of(td),
                              outputs=("n_slots", "overflowed"),
                              budget=1 << 16)
        want = jt.render_frame(jd, ext_tfs=ext,
                               outputs=("n_slots", "overflowed"),
                               budget=1 << 16)
        assert (int(got[0]), bool(got[1])) == (int(want[0]), bool(want[1]))
        assert int(got[0]) > 0


def test_rehearse_budget_as_jax(pair, monkeypatch):
    """rehearse_budget probes the val and the anim frames, the anim ones
    with their alignment, binning only, and sets hugs_tpu's budget."""
    jt, tt = pair
    probed = []
    render_frame = tt.render_frame

    def spy(data, **kw):
        probed.append((kw.get("ext_tfs") is not None, kw.get("outputs")))
        return render_frame(data, **kw)
    monkeypatch.setattr(tt, "render_frame", spy)
    saved = [(t._ibudget, t.__dict__.get("_budget_rehearsed"))
             for t in pair]
    try:
        got, want = tt.rehearse_budget(), jt.rehearse_budget()
    finally:
        for t, (b, r) in zip(pair, saved):
            t._ibudget, t._budget_rehearsed = b, bool(r)
    assert got == want and got % 8192 == 0
    n_val, n_anim = len(tt.val_dataset), len(tt.anim_dataset)
    assert probed == [(False, ("n_slots", "overflowed"))] * n_val \
        + [(True, ("n_slots", "overflowed"))] * n_anim


# ------------------------------------------------- animate, canonical

def test_animate_as_jax(pair, tmp_path, restore_logdir):
    """animate() against hugs_tpu's animate(batch_size=1); the frames
    move; each is written as a PNG to anim/final."""
    jt, tt = pair
    _, port_dir = logdirs(pair, tmp_path)
    jt.cfg.logdir = ""
    got = tt.animate()
    want = jt.animate(batch_size=1)
    assert_images(got, want, "anim frame")
    assert float((got[1] - got[0]).abs().max()) > 0.01
    anim_dir = os.path.join(port_dir, "anim", "final")
    assert sorted(os.listdir(anim_dir)) == [f"{i:05d}.png"
                                            for i in range(len(got))]
    png = read_png(os.path.join(anim_dir, "00002.png"))
    np.testing.assert_array_equal(png, timage._to_uint8_hwc(got[2]))


def test_anim_batch_size_refused(pair):
    """train.anim_batch_size > 1 is no longer refused: animate renders the
    split in batches (hugs_tpu_torch/parallel), each frame as
    hugs_tpu's animate(batch_size=1) renders it."""
    jt, tt = pair
    check_supported(load_config(None, ["train.anim_batch_size=1"]))
    check_supported(load_config(None, ["train.anim_batch_size=2"]))
    assert tt.cfg.logdir == ""
    assert_images(tt.animate(batch_size=2), jt.animate(batch_size=1),
                  "anim frame, batches of 2")


def test_render_canonical_as_jax(pair, tmp_path, restore_logdir):
    jt, tt = pair
    _, port_dir = logdirs(pair, tmp_path)
    jt.cfg.logdir = ""
    got = tt.render_canonical(nframes=CANON_FRAMES)
    want = jt.render_canonical(nframes=CANON_FRAMES)
    assert_images(got, want, "canonical frame")
    assert got[0].shape == (3, 128, 128)
    assert sorted(os.listdir(os.path.join(port_dir, "canon", "final"))) \
        == [f"{i:05d}.png" for i in range(1, CANON_FRAMES + 1)]


def test_render_poses_as_jax(pair, monkeypatch):
    """render_poses on three poses and orbit cameras against hugs_tpu's
    (driven as tests/test_compact.py drives it): the images and the
    budget of the renders."""
    import hugs_tpu.render as jax_render
    from hugs_tpu.data.cameras import get_rotating_camera as jax_cams
    from hugs_tpu.train.trainer import render_poses as jax_render_poses
    from hugs_tpu_torch.data.cameras import get_rotating_camera
    jt, tt = pair
    rng = np.random.RandomState(4)
    poses = [(rng.randn(69) * 0.2).astype(np.float32) for _ in range(3)]
    body = {"global_orient": np.zeros(3, np.float32),
            "betas": np.zeros(10, np.float32),
            "transl": np.zeros(3, np.float32),
            "smpl_scale": np.float32(1.0)}
    kw = dict(img_size=(40, 56), fov=0.9, dist=3.0, nframes=3)
    t_cams = [dict(c, body_pose=p) for c, p in zip(
        get_rotating_camera(device="cpu", **kw), poses)]
    j_cams = [dict(c, body_pose=p) for c, p in zip(jax_cams(**kw), poses)]
    budgets = {"jax": [], "port": []}

    def spy(fn, into):
        def f(*a, **k):
            into.append((k["instance_budget"], k.get("bin_only", False)))
            return fn(*a, **k)
        return f
    monkeypatch.setattr(jax_render, "render_human_scene",
                        spy(jax_render.render_human_scene, budgets["jax"]))
    monkeypatch.setattr(ttr, "render_human_scene",
                        spy(ttr.render_human_scene, budgets["port"]))
    got = ttr.render_poses(tt, t_cams, body)
    want = jax_render_poses(jt, j_cams, body)
    assert_images(got, want, "render_poses frame")
    # hugs_tpu traces its probe and its render once each: the render's
    # budget is the last it saw; the port's renders are its full ones
    renders = {b for b, only in budgets["port"] if not only}
    assert renders == {budgets["jax"][-1][0]}
    assert float((got[1] - got[0]).abs().max()) > 0.01


# ------------------------------------------------------ dumps, hooks

def assert_ply(got, want, what):
    """Every PLY field to 1e-6, the scales (stored as logs, which turn
    the rounding of a scale near 0 into a large difference) as scales;
    the rotations to 1e-5, the bar of human_forward's rotations in
    tests/test_torch_human.py (a quaternion of the decoded 6D rotation
    differs by up to 3.2e-6 here)."""
    for k in want:
        a, b = got[k], want[k]
        if k == "scaling":
            a, b = np.exp(a), np.exp(b)
        np.testing.assert_allclose(a, b, atol=1e-5 if k == "rotation"
                                   else 1e-6, err_msg=f"{what} {k}")


def test_save_human_ply_as_jax(pair, tmp_path, restore_logdir):
    """The canonical human PLY read back equals hugs_tpu's to 1e-6."""
    jt, tt = pair
    jdir, tdir = logdirs(pair, tmp_path)
    jt._save_human_ply(7)
    tt._save_human_ply(7)
    name = os.path.join("meshes", "human_000007_splat.ply")
    got = load_gaussian_ply(os.path.join(tdir, name))
    want = load_gaussian_ply(os.path.join(jdir, name))
    assert got["xyz"].shape[0] == int(tt.human.state.alive.sum()) > 100
    assert_ply(got, want, "human")


def test_iter0_dumps_as_jax(pair, tmp_path, restore_logdir):
    """_iter0_dumps: the scene's and the human's PLYs equal hugs_tpu's to
    1e-6; the turntable's PNGs within one level of 255."""
    jt, tt = pair
    jdir, tdir = logdirs(pair, tmp_path)
    jt._iter0_dumps()
    tt._iter0_dumps()
    for name in ("scene_000000_splat.ply", "human_000000_splat.ply"):
        got = load_gaussian_ply(os.path.join(tdir, "meshes", name))
        want = load_gaussian_ply(os.path.join(jdir, "meshes", name))
        assert_ply(got, want, name)
    canon = os.path.join("canon", "000000")
    names = sorted(os.listdir(os.path.join(tdir, canon)))
    assert names == sorted(os.listdir(os.path.join(jdir, canon)))
    assert len(names) == CANON_FRAMES
    for n in names:
        a = read_png(os.path.join(tdir, canon, n)).astype(int)
        b = read_png(os.path.join(jdir, canon, n))[..., :3].astype(int)
        assert np.abs(a - b).max() <= 1, n


def test_periodic_hooks(pair, tmp_path, monkeypatch, capsys,
                        restore_logdir):
    """_periodic runs the iteration-0 dumps at step 0 and, every
    anim_interval, the human PLY, animate and the turntable; an error in
    either hook is printed as a warning and training goes on."""
    _, tt = pair
    logdirs(pair, tmp_path)
    calls = []
    for name in ("_iter0_dumps", "_save_human_ply", "animate",
                 "render_canonical"):
        monkeypatch.setattr(tt, name, lambda *a, _n=name, **k:
                            calls.append((_n, a, k)))
    for key, v in (("anim_interval", 5), ("save_ckpt_interval", 10 ** 6),
                   ("val_interval", 10 ** 6)):
        monkeypatch.setitem(tt.cfg.train, key, v)
    for t in range(11):
        tt._periodic(t, {})
    assert [c[0] for c in calls] == [
        "_iter0_dumps", "_save_human_ply", "animate", "render_canonical",
        "_save_human_ply", "animate", "render_canonical"]
    assert calls[2][1] == (5,) and calls[3][2] == {"nframes": CANON_FRAMES}

    def fail(*a, **k):
        raise OSError("disk full")
    monkeypatch.setattr(tt, "_iter0_dumps", fail)
    monkeypatch.setattr(tt, "animate", fail)
    tt._periodic(0, {})
    tt._periodic(5, {})
    out = capsys.readouterr().out
    assert "WARNING: iter-0 dumps failed (continuing training): OSError: " \
        "disk full" in out
    assert "WARNING: animate(5) failed" in out


def test_progress_strip_as_jax(pair, tmp_path, restore_logdir):
    """train.save_progress_images: a strip of two canonical views every
    progress_save_interval steps, as hugs_tpu's (within one level of
    255); at the end of training the strips go."""
    jt, tt = pair
    jdir, tdir = logdirs(pair, tmp_path)
    jt._save_progress_frame(3)
    for key, v in (("save_progress_images", True),
                   ("progress_save_interval", 3),
                   ("save_ckpt_interval", 10 ** 6),
                   ("val_interval", 10 ** 6), ("anim_interval", 0)):
        tt.cfg.train[key] = v
    try:
        for t in range(1, 4):
            tt._periodic(t, {})
        strips = os.listdir(os.path.join(tdir, "train_progress"))
        assert strips == ["000003.png"]
        a = read_png(os.path.join(tdir, "train_progress", strips[0]))
        b = read_png(os.path.join(jdir, "train_progress", strips[0]))[..., :3]
        assert a.shape == (128, 2 * 128 + 2, 3)
        assert np.abs(a.astype(int) - b.astype(int)).max() <= 1
        tt._finish_progress_video()
    finally:
        tt.cfg.train["save_progress_images"] = False
    assert not os.path.exists(os.path.join(tdir, "train_progress"))


def test_create_video(tmp_path, monkeypatch, capsys):
    """create_video runs ffmpeg where PATH has one (here a stand-in that
    records its arguments and writes the file); without one it returns
    False and says so once."""
    ffmpeg = tmp_path / "bin" / "ffmpeg"
    ffmpeg.parent.mkdir()
    ffmpeg.write_text(
        f"#!{sys.executable}\nimport os, sys\n"
        "open(os.path.join(os.path.dirname(sys.argv[0]), 'args'), 'w')"
        ".write(' '.join(sys.argv[1:]))\nopen(sys.argv[-1], 'w').close()\n")
    ffmpeg.chmod(0o755)
    out = str(tmp_path / "v.mp4")
    monkeypatch.setenv("PATH", str(ffmpeg.parent))
    assert timage.create_video(str(tmp_path / "frames"), out, fps=7)
    assert os.path.exists(out)
    args = (ffmpeg.parent / "args").read_text().split()
    assert args[:3] == ["-y", "-framerate", "7"] and "libx264" in args
    monkeypatch.setenv("PATH", str(tmp_path / "none"))
    monkeypatch.setattr(timage, "_NO_ENCODER_SAID", False)
    assert not timage.create_video(str(tmp_path / "frames"), out)
    assert not timage.create_video(str(tmp_path / "frames"), out)
    assert capsys.readouterr().out.count("no ffmpeg") == 1
