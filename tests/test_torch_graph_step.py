"""The trainer's captured step (hugs_tpu_torch/train/graph_step.py), on
tests/test_data.py's fake NeuMan sequence at 48x32 (written here with the
port's PNG writer) with synthetic_smpl(8) and LPIPS on 16-pixel patches:

- on the CPU, where nothing is captured, the step's body fed from the
  static buffers (the trainer's graph path with the graphs' bodies run
  directly) equals the eager _train_step bit for bit, in the scene and
  the joint mode, over three steps on three frames at three position
  learning rates: parameters, Adam's moments and step, the
  densification statistics, and the losses;
- the capture key changes with the instance budget, the SH degree, the
  mode, the loss function a step calls and the blend's mode, and not
  with the frame;
- on the card, three replays against three eager runs of three steps
  from one state on three frames: the losses and every state tensor's
  change within 1e-2 of the nearest eager run's, or within three times
  the eager runs' own spread where that is wider (leaves whose gradient
  is rounding after one step, by the benchmark's rule, left out). At
  this size Adam's moments of near-zero gradients carry K2's atomics
  (replays read up to 1.3e-3 apart where three eager runs agreed
  exactly), while a baked-in input moves a change by tens of percent
  (the rates of iterations 1 and 9,000 differ fourfold); K1, K2 and K3
  counted at each replay; a sync step that overflows a shrunken budget renders
  again eagerly, and the next step captures at the grown budget.
"""
import os

import numpy as np
import pytest
import torch

from hugs_tpu_torch.cfg import load_config
from hugs_tpu_torch.data.neuman import NeumanDataset
from hugs_tpu_torch.models.smpl import synthetic_smpl
from hugs_tpu_torch.render import cuda_blend
from hugs_tpu_torch.train import checkpoint as ckpt_io
from hugs_tpu_torch.train import graph_step as gst
from hugs_tpu_torch.train import scene_step as sst
from hugs_tpu_torch.train import trainer as ttr
from hugs_tpu_torch.utils import png, profiling

TINY = ["train.num_steps=9", "train.val_interval=1000",
        "human.triplane_res=16", "human.n_subdivision=0",
        "human.use_deformer=true", "human.disable_posedirs=true",
        "human.loss.lpips_w=1.0", "human.loss.patch_size=16",
        "human.loss.humansep_w=1.0",
        "tpu.scene_capacity=256", "tpu.human_capacity=512",
        "tpu.smpl_vpb=8", "tpu.tile_cap=1024"]
# three steps: frames, iterations (no densify or reset at any of them),
# the position rates far apart, so that a rate baked into a capture shows
STEPS = ((0, 1), (3, 4000), (5, 9000))


def write_fake_neuman(root, n_frames=10, w=48, h=32):
    """tests/test_data.py's fake sequence `lab`, written with the port's
    PNG writer (the card's machine has neither PIL nor hugs_tpu)."""
    path = os.path.join(root, "lab")
    for d in ("images", "segmentations", "sparse", "4d_humans"):
        os.makedirs(os.path.join(path, d))
    rng = np.random.RandomState(0)
    for i in range(n_frames):
        png.write_png(f"{path}/images/{i:05d}.png",
                      (rng.rand(h, w, 3) * 255).astype(np.uint8))
        msk = np.zeros((h, w), np.uint8)
        msk[8:16, 10:20] = 255
        png.write_png(f"{path}/segmentations/{i:05d}.png", msk)
    with open(f"{path}/sparse/cameras.txt", "w") as f:
        f.write(f"1 PINHOLE {w} {h} {w * 1.2} {h * 1.2} {w / 2} {h / 2}\n")
    with open(f"{path}/sparse/images.txt", "w") as f:
        for i in range(n_frames):
            ang = 0.05 * i
            f.write(f"{i + 1} {np.cos(ang / 2)} 0 {np.sin(ang / 2)} 0 "
                    f"{0.1 * i} 0 4 1 {i:05d}.png\n\n")
    with open(f"{path}/sparse/points3D.txt", "w") as f:
        for i in range(50):
            p = rng.uniform(-1, 1, 3)
            c = rng.randint(0, 255, 3)
            f.write(f"{i} {p[0]} {p[1]} {p[2] + 4} {c[0]} {c[1]} {c[2]} "
                    f"0.5\n")
    np.savez(f"{path}/4d_humans/smpl_optimized_aligned_scale.npz",
             betas=rng.randn(n_frames, 10).astype(np.float32) * 0.1,
             global_orient=rng.randn(n_frames, 3).astype(np.float32) * 0.1,
             body_pose=rng.randn(n_frames, 69).astype(np.float32) * 0.1,
             transl=rng.randn(n_frames, 3).astype(np.float32) * 0.1,
             scale=np.ones(n_frames, np.float32))


@pytest.fixture(scope="module")
def fake_root(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("neuman"))
    write_fake_neuman(root)
    return root


@pytest.fixture
def one_thread():
    """One CPU thread, so that two runs of a step sum in one order."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _trainer(root, mode, device="cpu"):
    cfg = load_config(None, TINY + [f"mode={mode}"])
    train = NeumanDataset(root, "lab", "train", render_mode=cfg.mode,
                          device=device)
    return ttr.GaussianTrainer(cfg, train, None, device=device,
                               smpl_model=synthetic_smpl(8, device=device))


def _state(tr) -> dict:
    return {f"{n}.{k}": v.detach().clone() for n, st in
            (("human", tr.human), ("scene", tr.scene)) if st is not None
            for k, v in ckpt_io.flatten(st).items()}


class BodyOnly(gst.StepGraph):
    """The captured step's two bodies run directly on the static buffers:
    what a capture records, where nothing can be captured."""
    captures = 0

    def capture(self):
        BodyOnly.captures += 1
        self.graphs = {}

    def forward(self):
        if self.graphs is None:
            self.capture()
        self.loss, self.fw = self.forward_body()
        self.aux = self.tr._aux(self.mode, self.loss, self.fw)
        return self.loss, self.fw

    def update(self):
        self.update_body(self.loss, self.fw)


def _run(tr, sync=False, steps=STEPS):
    losses = []
    for idx, t_iter in steps:
        aux, _ = tr._train_step(t_iter, idx, tr.train_dataset[idx], sync)
        losses.append(aux["loss"].clone())
    return losses


@pytest.mark.parametrize("mode", ["scene", "human_scene"])
def test_static_body_equals_eager(fake_root, mode, one_thread, monkeypatch):
    """The graph path's body on its static buffers against the eager
    step, bit for bit over three steps of different frames and rates."""
    eager, body = _trainer(fake_root, mode), _trainer(fake_root, mode)
    lrs = [eager._xyz_lrs(mode, t) for _, t in STEPS]
    assert len({float(lr[1]) for lr in lrs}) == 3     # three scene rates
    want = _run(eager)
    monkeypatch.setattr(gst, "capturable", lambda device: True)
    monkeypatch.setattr(gst, "StepGraph", BodyOnly)
    BodyOnly.captures = 0
    profiling.enable(True)
    try:
        got = _run(body)
        rec = profiling.drain()
    finally:
        profiling.enable(None)
    assert BodyOnly.captures == 1
    assert isinstance(body._graph, BodyOnly)
    # the pose row and the rates came from the buffers
    assert body._graph.idx.dim() == 0 and int(body._graph.idx) == 5
    assert float(body._graph.s_lr) == float(lrs[-1][1])
    assert [rec.steps[t]["graph_replays"] for _, t in STEPS] == [1, 1, 1]
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    a, b = _state(body), _state(eager)
    assert a.keys() == b.keys()
    for k in a:
        assert torch.equal(a[k], b[k]), k
    # an eager step counts no replay
    monkeypatch.undo()
    profiling.enable(True)
    try:
        eager._train_step(2, 2, eager.train_dataset[2], False)
        rec = profiling.drain()
    finally:
        profiling.enable(None)
    assert rec.steps[2]["graph_replays"] == 0


def test_key_changes(fake_root, monkeypatch):
    """The key holds the budget, the SH degree, the mode, the loss
    functions and the blend's mode; another frame keeps it."""
    tr = _trainer(fake_root, "human_scene")
    d0, d1 = tr.train_dataset[0], tr.train_dataset[1]
    key = gst.graph_key(tr, "human_scene", d0)
    assert gst.graph_key(tr, "human_scene", d1) == key
    assert gst.graph_key(tr, "human", d0) != key
    tr._ibudget += 8192
    grown = gst.graph_key(tr, "human_scene", d0)
    assert grown != key
    tr._periodic(1000, None)           # the SH one-up
    assert tr._sh_degrees() == (1, 1)
    raised = gst.graph_key(tr, "human_scene", d0)
    assert raised != grown
    monkeypatch.setattr(sst, "scene_loss", lambda *a, **k: None)
    assert gst.graph_key(tr, "human_scene", d0) != raised
    monkeypatch.undo()
    assert gst.graph_key(tr, "human_scene", d0) == raised
    monkeypatch.setattr(cuda_blend, "POWER_MXU", not cuda_blend.POWER_MXU)
    assert gst.graph_key(tr, "human_scene", d0) != raised


def _nought(state: dict) -> set:
    """The keys of the leaves whose first moment after one step is under
    1e-3 of the median leaf's, with their moments: the benchmark's rule
    for a leaf whose gradient is rounding (bench_port/reference/
    compare.py), such as the rotations of an isotropic scene."""
    mu = {k: float(v.double().norm()) for k, v in state.items()
          if ".opt.mu." in k}
    med = float(np.median(list(mu.values())))
    out = set()
    for k, v in mu.items():
        if v < 1e-3 * med:
            model, leaf = k.split(".opt.mu.")
            out |= {k, f"{model}.opt.nu.{leaf}", f"{model}.params.{leaf}",
                    f"{model}.gs.{leaf}"}
    return out


def _live(tr) -> dict:
    return {f"{n}.{k}": v for n, st in (("human", tr.human),
                                        ("scene", tr.scene)) if st is not None
            for k, v in ckpt_io.flatten(st).items()}


def _from_start(tr, start: dict, gen_state, steps=STEPS) -> dict:
    """`steps` from `start` and the generator's state: the losses and
    each state tensor's change, float64."""
    with torch.no_grad():
        for k, v in _live(tr).items():
            v.copy_(start[k])
    tr.gen.set_state(gen_state)
    out = {"losses": torch.stack(_run(tr, steps=steps)).double()}
    out.update({k: v.detach().double() - start[k].double()
                for k, v in _live(tr).items()})
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["scene", "human_scene"])
def test_replays_match_eager_on_card(fake_root, mode, monkeypatch):
    """Three replays against three eager runs of three steps from one
    state on three frames: the losses and each state tensor's change
    within 1e-2 of the nearest eager run's, or three times the eager
    runs' own spread where it is wider (K2's atomics, through Adam);
    the launches counted at each replay; an overflowing sync step
    renders again eagerly and the next step captures at the grown
    budget."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the GPU machine)")
    dev = torch.device("cuda", 0)
    graph = _trainer(fake_root, mode, dev)
    start = {k: v.detach().clone() for k, v in _live(graph).items()}
    gen0 = graph.gen.get_state()
    with monkeypatch.context() as m:
        m.setattr(gst, "capturable", lambda device: False)
        first = _from_start(graph, start, gen0, steps=STEPS[:1])
        eager = [_from_start(graph, start, gen0) for _ in range(3)]
    before = gst.launch_counts()
    got = _from_start(graph, start, gen0)
    after = gst.launch_counts()
    per_step = [(b - a) / len(STEPS) for a, b in zip(before, after)]
    renders = 1 if mode == "scene" else 2
    # K1, K2, their POWER_MXU counts, K3
    assert per_step == [renders, renders, 0, 0, 0 if mode == "scene" else 1]
    torch.cuda.synchronize()

    def apart(a, b, k):
        return float((a[k] - b[k]).norm()) / max(float(b[k].norm()), 1e-30)

    left_out = _nought(first)
    for k in got.keys() - left_out:
        rel = min(apart(got, e, k) for e in eager)
        spread = max(apart(a, b, k) for i, a in enumerate(eager)
                     for b in eager[i + 1:])
        assert rel <= max(1e-2, 3 * spread), (k, rel, spread)
    first = graph._graph
    assert first is not None and first.graphs
    profiling.enable(True)
    try:
        graph._ibudget = 64
        graph._train_step(10, 0, graph.train_dataset[0], True)
        graph._train_step(11, 1, graph.train_dataset[1], False)
        rec = profiling.drain()
    finally:
        profiling.enable(None)
    assert graph.retries == 1 and graph._ibudget > 64
    assert rec.steps[10]["graph_replays"] == 0
    assert rec.steps[11]["graph_replays"] == 1
    assert graph._graph is not first and graph._graph.key[3] == graph._ibudget
    spans = [s for s in rec.spans if s.step == 11]
    names = {s.name for s in spans}
    assert {"step.render", "render.bin", "step.loss", "step.backward",
            "step.optim"} <= names
    # every span but the host's own (the wait for an earlier step and the
    # periodic work) holds a device time
    assert all(s.device_ms is not None and s.device_ms >= 0 for s in spans
               if s.name not in ("train.wait", "train.periodic"))
    assert np.isfinite(float(graph._graph.loss))
