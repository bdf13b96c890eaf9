"""The port stands alone: hugs_tpu_torch and chip_smoke.py import neither
jax nor hugs_tpu, nor PIL or cv2 (the GPU machine has neither; the port
reads and writes PNGs with utils/png.py), and the kernel's launcher
takes CUDA tensors only."""
import ast
import os
import pkgutil
import re
import subprocess
import sys

import pytest
import torch

import hugs_tpu_torch
from hugs_tpu_torch import build
from hugs_tpu_torch.micro import micro_bf16, vpu_peak
from hugs_tpu_torch.render import cuda_blend

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("jax", "jaxlib", "hugs_tpu", "PIL", "cv2")


def _port_modules():
    return sorted(m.name for m in pkgutil.walk_packages(
        hugs_tpu_torch.__path__, "hugs_tpu_torch."))


def test_import_leaves_jax_and_hugs_tpu_out():
    """Import every module of the port in a fresh interpreter in which
    importing jax or hugs_tpu raises, whatever the interpreter loaded at
    start-up."""
    code = f"""
import sys
sys.path.insert(0, {REPO!r})
FORBIDDEN = {FORBIDDEN!r}
def forbidden(name):
    return name.split(".")[0] in FORBIDDEN
for name in [m for m in sys.modules if forbidden(m)]:
    del sys.modules[name]
class Block:
    def find_spec(self, name, path=None, target=None):
        if forbidden(name):
            raise ImportError("the port imported " + name)
sys.meta_path.insert(0, Block())
import importlib
for name in {_port_modules()!r}:
    importlib.import_module(name)
left = sorted(m for m in sys.modules if forbidden(m))
assert not left, left
print("ok", len({_port_modules()!r}))
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, cwd=REPO)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("ok")


def test_human_training_modules_are_among_the_checked():
    """The modules of the human training slice stand alone like the rest:
    the two checks above walk them."""
    modules = _port_modules()
    sources = {os.path.relpath(p, REPO) for p in _port_sources()}
    for name in ("losses.sampler", "losses.lpips", "losses.loss",
                 "train.human_step", "train.human_check"):
        assert f"hugs_tpu_torch.{name}" in modules, name
        assert os.path.join("hugs_tpu_torch", *name.split(".")) + ".py" \
            in sources, name


def test_training_shell_modules_are_among_the_checked():
    """The modules of the joint training slice and of the training shell
    (configuration, data, checkpoints, trainer, CLI) stand alone like the
    rest: the checks around this one walk them."""
    modules = _port_modules()
    sources = {os.path.relpath(p, REPO) for p in _port_sources()}
    for name in ("cfg", "cfg.config", "data.colmap", "data.native",
                 "data.neuman", "utils.png", "utils.image",
                 "train.checkpoint", "train.joint_step", "train.trainer",
                 "main"):
        assert f"hugs_tpu_torch.{name}" in modules, name
        path = os.path.join("hugs_tpu_torch", *name.split("."))
        assert path + ".py" in sources or os.path.join(
            path, "__init__.py") in sources, name


def test_serving_modules_are_among_the_checked():
    """The modules of the serving slice (the evaluate command, the
    visualization exports, the tracing hooks) stand alone like the rest:
    the checks around this one walk them."""
    modules = _port_modules()
    sources = {os.path.relpath(p, REPO) for p in _port_sources()}
    for name in ("evaluate", "utils.vis", "utils.profiling", "utils.image",
                 "data.neuman", "train.trainer", "convert"):
        assert f"hugs_tpu_torch.{name}" in modules, name
        assert os.path.join("hugs_tpu_torch", *name.split(".")) + ".py" \
            in sources, name


def test_parallel_modules_are_among_the_checked():
    """The modules of the scale-out slice (the mesh, the collectives, the
    band and frame renders, the data x tile step, the rank launcher and
    its checks) stand alone like the rest: the checks around this one
    walk them."""
    modules = _port_modules()
    sources = {os.path.relpath(p, REPO) for p in _port_sources()}
    for name in ("parallel", "parallel.mesh", "parallel.collectives",
                 "parallel.shard", "parallel.train_dp_tile",
                 "parallel.launch", "parallel.check"):
        assert f"hugs_tpu_torch.{name}" in modules, name
        path = os.path.join("hugs_tpu_torch", *name.split("."))
        assert path + ".py" in sources or os.path.join(
            path, "__init__.py") in sources, name


def test_gauss_shard_modules_are_among_the_checked():
    """The modules of the Gaussian-sharded slice (the fragment renderer,
    the sharded scene step, the multi-host layout), the per-Gaussian
    avatar and the driver hooks stand alone like the rest: the checks
    around this one walk them."""
    modules = _port_modules()
    sources = {os.path.relpath(p, REPO) for p in _port_sources()}
    for name in ("parallel.gauss_shard", "parallel.gauss_train",
                 "parallel.multihost", "models.human_gs_pergs",
                 "graft_entry"):
        assert f"hugs_tpu_torch.{name}" in modules, name
        assert os.path.join("hugs_tpu_torch", *name.split(".")) + ".py" \
            in sources, name


def _imported_names(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def _port_sources():
    root = os.path.join(REPO, "hugs_tpu_torch")
    for dirpath, _, files in os.walk(root):
        yield from (os.path.join(dirpath, f) for f in files
                    if f.endswith(".py"))
    yield os.path.join(REPO, "chip_smoke.py")


def test_sources_name_no_jax_or_hugs_tpu():
    sources = list(_port_sources())
    assert len(sources) > 15
    for path in sources:
        for name in _imported_names(path):
            assert name.split(".")[0] not in FORBIDDEN, (path, name)
        text = open(path).read()
        assert not re.search(r"import jax|hugs_tpu\.\w", text), path


def test_kernel_launcher_refuses_cpu_tensors():
    feat = torch.zeros((4, 10))
    gid = torch.zeros(8, dtype=torch.int32)
    se = torch.zeros(1, dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA"):
        cuda_blend.blend_fwd(feat, gid, se, se, torch.zeros(3), 16, 16)


def test_k2_launcher_refuses_cpu_tensors():
    """K2 runs on the card only: its launcher refuses CPU tensors, and a
    CPU render differentiates the plain blend instead."""
    feat = torch.zeros((4, 10))
    gid = torch.zeros(8, dtype=torch.int32)
    se = torch.zeros(1, dtype=torch.int32)
    plane = torch.zeros((16, 16))
    with pytest.raises(ValueError, match="K2 runs on CUDA"):
        cuda_blend.blend_bwd(feat, gid, se, se, torch.zeros(3), 16, 16,
                             torch.zeros((3, 16, 16)), plane,
                             plane.to(torch.int32))


def test_build_raises_without_nvcc(monkeypatch, tmp_path):
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc"):
        build.nvcc()


def test_library_path_follows_the_source():
    path = build.library_path(cuda_blend.SOURCE)
    assert path.parent == build.BUILD_DIR
    assert path.name.startswith("blend_fwd-") and path.suffix == ".so"
    assert path == build.library_path(cuda_blend.SOURCE)
    assert build.library_path(cuda_blend.BWD_SOURCE).name.startswith(
        "blend_bwd-")
    for source in (vpu_peak.SOURCE, micro_bf16.SOURCE):
        path = build.library_path(source)
        assert path.parent == build.BUILD_DIR and path.suffix == ".so"
        assert path.name.startswith(f"{source}-")
        assert (build.CSRC / f"{source}.cu").is_file()


def test_library_path_follows_the_shared_header(monkeypatch, tmp_path):
    """An edit to a csrc/*.cuh header moves every kernel's library."""
    for f in build.CSRC.iterdir():
        (tmp_path / f.name).write_bytes(f.read_bytes())
    monkeypatch.setattr(build, "CSRC", tmp_path)
    before = [build.library_path(s)
              for s in (cuda_blend.SOURCE, cuda_blend.BWD_SOURCE)]
    header = tmp_path / "blend_common.cuh"
    header.write_bytes(header.read_bytes() + b"\n// edited\n")
    after = [build.library_path(s)
             for s in (cuda_blend.SOURCE, cuda_blend.BWD_SOURCE)]
    assert before[0] != after[0] and before[1] != after[1]
