"""The trainer's steady-state step as two CUDA graphs, captured once and
replayed on every later step whose static inputs match.

What JAX gets from `jit`, the port gets from capture and replay: the
step keeps the JAX package's static shapes (every array padded to its
capacity, the binning over the whole instance budget), so one capture
holds every launch of a step, and a replay costs the host one launch
where the eager step costs it thousands.

Two graphs, in one memory pool (torch.cuda.make_graphed_callables'
pattern):
  1. `forward`: the human forward, the render(s) and the loss
     (GaussianTrainer._forward), the pose row chosen on the device;
  2. `update`: the gradients by autograd through the captured forward,
     group Adam and the densification statistics (_backward_update).
A sync step replays the first, reads back the loss and the binning's
counts, and replays the second unless the budget overflowed (the
trainer then grows it and renders the step again eagerly; the next step
captures at the new budget).

The step's inputs live in static buffers that `load` fills before each
replay: the frame's camera, image, mask and SMPL scale, the frame's row
of the pose tables, the backgrounds, the loss's draws (made eagerly from
the trainer's generator) and the two position learning rates of this
iteration. A value the capture would bake in (a Python int index, a
rate read from a CPU tensor, a tensor made from host memory) is read
from these buffers instead. Parameters, Adam's moments and the
statistics are the trainer's own tensors, updated in place by the
replays, so checkpoints and in-place restores work unchanged; rebinding
a state to new tensors needs a new key (the key holds the states'
identities).

Capture runs on a side stream after one eager forward and backward of
the loaded step on that stream (no update), which builds and loads the
kernels and the libraries' handles; that warm-up's launches are not
counted. The launch counters K1, K2 and K3 keep (cuda_blend.LAUNCHES,
K2_LAUNCHES, their POWER_MXU counts, knn.LAUNCHES) advance at each
replay by the launches its graph holds. The spans inside the step go
into a profiling.Template at capture and are recorded at each replay
while the recorder is on (utils/profiling.py).
"""
from __future__ import annotations

import importlib
from typing import Any

import numpy as np
import torch

from hugs_tpu_torch.render import cuda_blend
from hugs_tpu_torch.render.camera import Camera
from hugs_tpu_torch.utils import profiling

# the module: hugs_tpu_torch.ops exports the function `knn` under its name
knn_ops = importlib.import_module("hugs_tpu_torch.ops.knn")

# the module counters of kernel launches a replay advances
LAUNCH_COUNTERS = ((cuda_blend, "LAUNCHES"), (cuda_blend, "K2_LAUNCHES"),
                   (cuda_blend, "MXU_LAUNCHES"),
                   (cuda_blend, "K2_MXU_LAUNCHES"), (knn_ops, "LAUNCHES"))


def capturable(device: torch.device) -> bool:
    """Whether steps on `device` run as captured graphs: on the card."""
    return device.type == "cuda"


def launch_counts() -> list[int]:
    return [getattr(m, n) for m, n in LAUNCH_COUNTERS]


def _add_launches(deltas) -> None:
    for (m, n), d in zip(LAUNCH_COUNTERS, deltas):
        setattr(m, n, getattr(m, n) + d)


def _set_launches(counts) -> None:
    for (m, n), c in zip(LAUNCH_COUNTERS, counts):
        setattr(m, n, c)


def _like(x):
    """Zero buffers shaped like a tensor, a NamedTuple of them (None
    kept) or None."""
    if x is None:
        return None
    if isinstance(x, torch.Tensor):
        return torch.zeros_like(x)
    return type(x)(*[_like(v) for v in x])


def _detached(x):
    """Tensors detached in nested dicts, lists and tuples."""
    if isinstance(x, torch.Tensor):
        return x.detach()
    if isinstance(x, dict):
        return {k: _detached(v) for k, v in x.items()}
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return type(x)(*[_detached(v) for v in x])
    if isinstance(x, (list, tuple)):
        return type(x)(_detached(v) for v in x)
    return x


def _put(buf, x) -> None:
    """x into its buffer, on the device's stream (no host round trip)."""
    if buf is None:
        return
    if isinstance(buf, torch.Tensor):
        buf.copy_(x)
        return
    for b, v in zip(buf, x):
        _put(b, v)


def _fill(buf: torch.Tensor, x, default) -> None:
    """A scalar input into its 0-d buffer: a tensor on the buffer's
    device copied there, a host value (a number, an array, a CPU tensor)
    as a fill's argument, float32 as a copy would round it."""
    x = default if x is None else x
    if isinstance(x, torch.Tensor) and x.device == buf.device:
        buf.copy_(x.reshape(()))
    else:
        if isinstance(x, torch.Tensor):
            x = x.numpy()
        buf.fill_(float(np.asarray(x, np.float32)))


class StepGraph:
    """One key's static inputs and, once captured, its two graphs."""

    def __init__(self, trainer, key, mode: str, data: dict, human_bg,
                 draws):
        self.tr, self.key, self.mode = trainer, key, mode
        dev = trainer.device
        self.width, self.height = data["width"], data["height"]
        self.camera = Camera(*[torch.zeros_like(x) for x in data["camera"]])
        self.data = {"camera": self.camera, "rgb": torch.zeros_like(
            data["rgb"]), "mask": torch.zeros_like(data["mask"]),
            "smpl_scale": torch.zeros((), dtype=torch.float32, device=dev),
            "width": self.width, "height": self.height}
        self.idx = torch.zeros((), dtype=torch.int64, device=dev)
        self.bg = torch.zeros(3, dtype=torch.float32, device=dev)
        self.human_bg = _like(human_bg)
        self.draws = _like(draws)
        self.h_lr = torch.zeros((), dtype=torch.float32, device=dev)
        self.s_lr = torch.zeros((), dtype=torch.float32, device=dev)
        self.graphs = None
        self.seq = 0

    def load(self, idx: int, data: dict, bg, human_bg, draws, h_lr,
             s_lr) -> None:
        """The step's inputs into the static buffers."""
        d = self.data
        _put(self.camera, data["camera"])
        d["rgb"].copy_(data["rgb"])
        d["mask"].copy_(data["mask"])
        _fill(d["smpl_scale"], data.get("smpl_scale"), 1.0)
        self.idx.fill_(int(idx))
        self.bg.copy_(bg)
        _put(self.human_bg, human_bg)
        _put(self.draws, draws)
        for buf, lr in ((self.h_lr, h_lr), (self.s_lr, s_lr)):
            if lr is not None:
                _fill(buf, lr, None)

    # ------------------------------------------------------------ body

    def forward_body(self):
        """The step's forward on the static inputs: (loss, forward's
        dict), as GaussianTrainer._forward returns them."""
        return self.tr._forward(self.mode, None, self.idx, self.data,
                                self.bg, self.human_bg, self.draws)

    def update_body(self, loss, fw) -> None:
        """Gradients, Adam and the statistics, the rates from the static
        buffers."""
        self.tr._backward_update(self.mode, loss, fw, self.h_lr, self.s_lr,
                                 self.width, self.height)

    # --------------------------------------------------------- capture

    def capture(self) -> None:
        """Warm-up on a side stream, then both graphs (see the module's
        docstring). The loaded inputs are the step's."""
        before = launch_counts()
        stream = torch.cuda.Stream(self.tr.device)
        stream.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(stream), profiling.paused():
            profiling.prepare_capture(self.tr.device)
            loss, fw = self.forward_body()
            self.tr._grads(self.mode, loss, fw)
            del loss, fw
        torch.cuda.current_stream().wait_stream(stream)
        _set_launches(before)
        self.template = profiling.Template()
        g_fwd, g_upd = torch.cuda.CUDAGraph(), torch.cuda.CUDAGraph()
        with torch.cuda.graph(g_fwd, stream=stream), \
                profiling.capturing(self.template, "forward"):
            profiling.next_row()
            self.loss, self.fw = self.forward_body()
        mid = launch_counts()
        with torch.cuda.graph(g_upd, pool=g_fwd.pool(), stream=stream), \
                profiling.capturing(self.template, "update"):
            self.update_body(self.loss, self.fw)
        after = launch_counts()
        self.launches = {"forward": [b - a for a, b in zip(before, mid)],
                         "update": [b - a for a, b in zip(mid, after)]}
        _set_launches(before)
        self.graphs = {"forward": g_fwd, "update": g_upd}
        # the outputs without their autograd graph, which no replay needs:
        # kept, it would hold the leaves' gradient accumulators on the
        # capture's stream for the eager steps too
        self.loss, self.fw = _detached(self.loss), _detached(self.fw)
        self.aux = self.tr._aux(self.mode, self.loss, self.fw)

    # ---------------------------------------------------------- replay

    def forward(self):
        """Replays the forward (capturing both graphs first if needed):
        (loss, forward's dict), the graph's outputs, overwritten by the
        next replay."""
        if self.graphs is None:
            self.capture()
        self.seq = profiling.begin_replay()
        self._replay("forward")
        return self.loss, self.fw

    def update(self) -> None:
        """Replays the gradients, Adam and the statistics of the forward
        last replayed."""
        self._replay("update")

    def _replay(self, part: str) -> None:
        with profiling.replay(self.template, part, self.seq):
            self.graphs[part].replay()
        _add_launches(self.launches[part])


def graph_key(trainer, mode: str, data: dict) -> tuple[Any, ...]:
    """What a captured step bakes in: the mode, the frame's size, the
    instance budget, the SH degrees, the capacities, optim_scene, the
    blend's mode, the loss functions the step calls and the states and
    modules whose tensors it holds."""
    from hugs_tpu_torch.train import human_step as hst
    from hugs_tpu_torch.train import joint_step as jst
    from hugs_tpu_torch.train import scene_step as sst
    tr = trainer
    return (mode, data["width"], data["height"], tr._ibudget,
            tr._sh_degrees(), tr._h_cap, tr._s_cap,
            bool(tr.cfg.train.optim_scene), bool(cuda_blend.POWER_MXU),
            sst.scene_loss, hst.human_loss, jst.joint_loss, tr.loss_fn,
            id(tr.lpips), id(tr.human), id(tr.scene), id(tr.fixed))
