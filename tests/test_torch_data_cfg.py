"""The port's host side against hugs_tpu's: the configuration loader, the
PNG reader and writer, the COLMAP reader (text and binary, native and
pure Python) and the NeuMan dataset, on tests/test_data.py's fake
sequence at 48x32.

Exact where both compute the same numpy: the configurations' flattened
dicts, the splits, the masks, boxes, SMPL parameters, point clouds and
radius, the PNG pixels; images atol 1e-7 (the same uint8 / 255); camera
matrices atol 1e-6 (float32 products in another order).
"""
import io
import os
import struct
import zlib

import numpy as np
import pytest
import torch
from PIL import Image

from hugs_tpu.cfg.config import (
    flatten as jax_flatten, get_cfg_items as jax_items,
    load_config as jax_load,
)
from hugs_tpu.data import colmap as jax_colmap
from hugs_tpu.data import neuman as jax_neuman
from hugs_tpu_torch.cfg import (
    check_supported, default_config, get_cfg_items, load_config,
)
from hugs_tpu_torch.cfg.config import flatten
from hugs_tpu_torch.data import colmap, native, neuman
from hugs_tpu_torch.utils import png
from torch_parity import np_of

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CFG_FILES = sorted(
    os.path.relpath(os.path.join(d, f), REPO)
    for d, _, fs in os.walk(os.path.join(REPO, "cfg_files"))
    for f in fs if f.endswith(".yaml"))


@pytest.fixture(scope="module")
def fake_root(tmp_path_factory):
    from test_data import write_fake_neuman
    root = str(tmp_path_factory.mktemp("neuman"))
    write_fake_neuman(root, n_frames=10, w=48, h=32)
    return root


# ------------------------------------------------------------ configuration

@pytest.mark.parametrize("path", [None] + CFG_FILES)
def test_config_loads_as_jax(path):
    """The defaults and every cfg_files/**/*.yaml flatten to the same dict
    in both packages, and expand to the same grid."""
    full = os.path.join(REPO, path) if path else None
    assert flatten(load_config(full).to_dict()) == \
        jax_flatten(jax_load(full).to_dict())
    got, want = get_cfg_items(load_config(full)), jax_items(jax_load(full))
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert flatten(a.to_dict()) == jax_flatten(b.to_dict())


def test_dotted_overrides_as_jax():
    ovs = ["mode=human_scene", "train.num_steps=30", "human.init_steps=10",
           "tpu.human_capacity=512", "dataset.seq=lab", "bg_color=black"]
    assert flatten(load_config(None, ovs).to_dict()) == \
        jax_flatten(jax_load(None, ovs).to_dict())


@pytest.mark.parametrize("override,slice_name", [
    ("train.batch_size=2", "Slice G"), ("tpu.gauss_shard=2", "Slice G"),
    ("train.anim_batch_size=2", "Slice G")])
def test_unported_settings_raise(override, slice_name):
    """Every setting of Slice G passes now (hugs_tpu_torch/parallel):
    tpu.gauss_shard = n too (item 3), while a negative one, which hugs_tpu
    cannot run either, raises ValueError; train.batch_size > 1 outside
    mode human_scene makes the trainer raise ValueError, as hugs_tpu's
    does."""
    from hugs_tpu_torch.train.trainer import GaussianTrainer
    check_supported(default_config())
    cfg = load_config(None, [override])
    check_supported(cfg)
    if override.startswith("tpu.gauss_shard"):
        with pytest.raises(ValueError, match="gauss_shard"):
            check_supported(load_config(None, ["tpu.gauss_shard=-1"]))
        return
    if override.startswith("train.batch_size"):
        tr = object.__new__(GaussianTrainer)
        tr.cfg = load_config(None, [override, "mode=human"])
        tr.human, tr.scene = object(), None
        with pytest.raises(ValueError, match="human_scene"):
            tr.train()


# ---------------------------------------------------------------- PNG

def _pil_png(arr, mode):
    buf = io.BytesIO()
    Image.fromarray(arr, mode).save(buf, "PNG")
    return buf.getvalue()


def _row_filters(data: bytes, h: int, stride: int) -> set:
    pos, idat = 8, b""
    while pos < len(data):
        n, kind = struct.unpack(">I4s", data[pos:pos + 8])
        if kind == b"IDAT":
            idat += data[pos + 8:pos + 8 + n]
        pos += 12 + n
    raw = zlib.decompress(idat)
    return {raw[y * (stride + 1)] for y in range(h)}


def _images(h=32, w=48):
    """Noise, ramps and a half-and-half image: PIL picks its row filters
    per row among None, Sub, Up and Paeth for these."""
    rng = np.random.default_rng(0)
    yy, xx = np.mgrid[:h, :w]
    noise = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
    ramp = np.stack([xx * 5, yy * 7, xx + yy], -1).astype(np.uint8)
    return [noise, ramp, np.concatenate([noise[:h // 2], ramp[h // 2:]])]


MODES = {"L": lambda a: a[..., 0], "LA": lambda a: a[..., :2],
         "RGB": lambda a: a, "RGBA": lambda a: np.concatenate(
             [a, a[..., :1]], -1)}


@pytest.mark.parametrize("mode", list(MODES))
def test_png_reads_what_pil_writes(mode, tmp_path):
    seen = set()
    for i, img in enumerate(_images()):
        arr = MODES[mode](img)
        data = _pil_png(arr, mode)
        seen |= _row_filters(data, arr.shape[0],
                             arr.shape[1] * (arr.shape[2] if arr.ndim == 3
                                             else 1))
        path = tmp_path / f"{i}.png"
        path.write_bytes(data)
        np.testing.assert_array_equal(png.read_png(str(path)), arr)
    # PIL's encoder never picks Average; test_png_each_row_filter has it
    assert seen == {0, 1, 2, 4}


@pytest.mark.parametrize("mode", list(MODES))
def test_pil_reads_what_png_writes(mode, tmp_path):
    for i, img in enumerate(_images()):
        arr = MODES[mode](img)
        path = str(tmp_path / f"{i}.png")
        png.write_png(path, arr)
        np.testing.assert_array_equal(np.asarray(Image.open(path)), arr)
        np.testing.assert_array_equal(png.read_png(path), arr)


def _filter_row(kind, row, prior, bpp):
    """PNG's filter `kind` of one row (the encoder side, byte by byte)."""
    out = bytearray(len(row))
    for i, x in enumerate(row):
        a = row[i - bpp] if i >= bpp else 0
        b = prior[i]
        c = prior[i - bpp] if i >= bpp else 0
        if kind == 0:
            pred = 0
        elif kind == 1:
            pred = a
        elif kind == 2:
            pred = b
        elif kind == 3:
            pred = (a + b) // 2
        else:
            p = a + b - c
            pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
            pred = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
        out[i] = (x - pred) & 0xFF
    return bytes(out)


@pytest.mark.parametrize("kind", [0, 1, 2, 3, 4],
                         ids=["none", "sub", "up", "average", "paeth"])
def test_png_each_row_filter(kind, tmp_path):
    """A file whose every row takes one filter, written here: the port
    and PIL read the same pixels."""
    arr = _images()[2]
    h, w, c = arr.shape
    rows, prior = [], bytes(w * c)
    for y in range(h):
        row = arr[y].tobytes()
        rows.append(bytes([kind]) + _filter_row(kind, row, prior, c))
        prior = row
    chunk = png._chunk
    path = tmp_path / "f.png"
    path.write_bytes(png.SIGNATURE + chunk(b"IHDR", struct.pack(
        ">IIBBBBB", w, h, 8, 2, 0, 0, 0)) + chunk(
            b"IDAT", zlib.compress(b"".join(rows))) + chunk(b"IEND", b""))
    np.testing.assert_array_equal(np.asarray(Image.open(path)), arr)
    np.testing.assert_array_equal(png.read_png(str(path)), arr)


def test_png_refuses_what_it_does_not_read(tmp_path):
    path = str(tmp_path / "p.png")
    Image.fromarray(np.zeros((4, 4), np.uint8), "L").convert("P").save(path)
    with pytest.raises(ValueError, match="colour type 3"):
        png.read_png(path)


# ---------------------------------------------------------------- COLMAP

def _same_scene(got, want):
    assert got.cameras == want.cameras
    assert [im.name for im in got.images] == [im.name for im in want.images]
    for a, b in zip(got.images, want.images):
        assert a.camera_id == b.camera_id
        np.testing.assert_array_equal(a.R, b.R)
        np.testing.assert_array_equal(a.t, b.t)
    np.testing.assert_array_equal(got.points, want.points)
    np.testing.assert_array_equal(got.colors, want.colors)


@pytest.mark.parametrize("native_lib", [True, False],
                         ids=["native", "pure_python"])
def test_colmap_text_and_binary_as_jax(fake_root, tmp_path, monkeypatch,
                                       native_lib):
    if native_lib and not native.native_available():
        pytest.skip("native/libhugs_io.so is not built here")
    if not native_lib:
        monkeypatch.setattr(native, "_load", lambda: None)
    sparse = os.path.join(fake_root, "lab", "sparse")
    txt = colmap.read_colmap_scene(sparse)
    _same_scene(txt, jax_colmap.read_colmap_scene(sparse))
    assert len(txt.images) == 10 and txt.points.shape == (50, 3)
    out = str(tmp_path / "bin")
    colmap.write_colmap_bin(out, txt.cameras, txt.images, txt.points,
                            txt.colors)
    binary = colmap.read_colmap_scene(out)
    _same_scene(binary, jax_colmap.read_colmap_scene(out))
    np.testing.assert_allclose(binary.points, txt.points, atol=1e-6)


def test_native_and_python_parsers_agree(fake_root, monkeypatch):
    if not native.native_available():
        pytest.skip("native/libhugs_io.so is not built here")
    sparse = os.path.join(fake_root, "lab", "sparse")
    fast = colmap.read_colmap_scene(sparse)
    monkeypatch.setattr(native, "_load", lambda: None)
    slow = colmap.read_colmap_scene(sparse)
    np.testing.assert_allclose(fast.points, slow.points, atol=1e-6)
    np.testing.assert_allclose(fast.colors, slow.colors, atol=1e-6)
    for a, b in zip(fast.images, slow.images):
        assert a.name == b.name
        np.testing.assert_allclose(a.R, b.R, atol=1e-6)
        np.testing.assert_allclose(a.t, b.t, atol=1e-6)


# ---------------------------------------------------------------- NeuMan

@pytest.mark.parametrize("n", [5, 10, 12, 24, 57])
def test_splits_as_jax(n):
    assert neuman.get_data_splits(n) == jax_neuman.get_data_splits(n)


def test_dilate_mask_as_jax():
    m = (np.random.default_rng(0).uniform(size=(32, 48)) > 0.97).astype(
        np.float32)
    for k in (1, 4, 5, 20):
        np.testing.assert_array_equal(neuman.dilate_mask(m, k),
                                      jax_neuman.dilate_mask(m, k))


@pytest.mark.parametrize("split,mode,bg_points", [
    ("train", "human_scene", False), ("val", "human_scene", True),
    ("test", "scene", False)])
def test_neuman_dataset_as_jax(fake_root, split, mode, bg_points):
    kw = dict(render_mode=mode, add_bg_points=bg_points, num_bg_points=64)
    got = neuman.NeumanDataset(fake_root, "lab", split, device="cpu", **kw)
    want = jax_neuman.NeumanDataset(fake_root, "lab", split, **kw)
    assert got.indices == want.indices and len(got) == len(want)
    assert got.radius == want.radius
    for a, b in zip(got.init_pcd, want.init_pcd):
        np.testing.assert_array_equal(a, b)
    assert got.init_pcd[0].shape[0] == 50 + (64 if bg_points else 0)
    for i in range(len(got)):
        a, b = got[i], want[i]
        np.testing.assert_allclose(np_of(a["rgb"]), b["rgb"], atol=1e-7)
        np.testing.assert_array_equal(np_of(a["mask"]), b["mask"])
        for k in ("bbox", "betas", "global_orient", "body_pose", "transl",
                  "smpl_scale"):
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
        for k in ("width", "height", "fovx", "fovy"):
            assert a[k] == b[k], k
        for f in ("world_view", "full_proj", "center", "tan_fovx",
                  "tan_fovy"):
            np.testing.assert_allclose(np_of(getattr(a["camera"], f)),
                                       np.asarray(getattr(b["camera"], f)),
                                       atol=1e-6, err_msg=f)
        assert isinstance(a["rgb"], torch.Tensor) \
            and a["rgb"].dtype == torch.float32


def test_anim_split_waits(fake_root):
    """The anim split waits for its AMASS clip: without the file under
    amass_root (default {root}/..) it raises FileNotFoundError, which
    main.build_datasets reads as no anim split."""
    with pytest.raises(FileNotFoundError, match="ChaCha"):
        neuman.NeumanDataset(fake_root, "lab", "anim", device="cpu")
