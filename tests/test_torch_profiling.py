"""utils/profiling.py's span and counter recorder on the trainer's steps,
on tests/test_data.py's fake NeuMan sequence at 48x32 with
synthetic_smpl(8):

- off (the default, no profiler running), a joint and a scene step leave
  no records, read no clock, record no CUDA event and make no span, and
  their loss, Adam moments and parameters equal, bit for bit, those of
  the same step with the recorder on;
- on, a joint sync step yields the span tree of the trainer's stages
  under one `train.step` of its iteration, `knn_chunks` of one kNN call
  a forward, the forward's slot demand and budget (the instances at
  sync steps), and the counters' deltas (no K1, K2 or kNN kernel launch
  on the CPU); a step that overflows its
  budget counts its retry and renders twice; a step that is no sync
  step has no read-back span and its slot counts all the same; on the
  CPU every device interval is None;
- `drain` empties the recorder; a count outside a step is dropped;
- a captured step's spans (a template of marks, its stamps emulated on
  the CPU) recorded at each replay: names, parents, steps, the replay's
  host interval, device times from the ring row of each replay, None
  for a row written over, nothing while the recorder is off;
- `idle_by_span` on synthetic gaps and spans;
- a torch.profiler session turns the recorder on by default;
- on the card, the spans' clock is the profiler's.
"""

import pytest
import torch

from hugs_tpu_torch.cfg import load_config
from hugs_tpu_torch.data.neuman import NeumanDataset
from hugs_tpu_torch.models.smpl import synthetic_smpl
from hugs_tpu_torch.train import checkpoint as ckpt_io
from hugs_tpu_torch.train import trainer as ttr
from hugs_tpu_torch.utils import profiling
from hugs_tpu_torch.utils.profiling import OUTSIDE, Span

# a human capacity over one kNN chunk (4,096 query rows)
H_CAP = 4608
TINY = ["train.num_steps=9", "train.val_interval=1000",
        "human.triplane_res=16", "human.n_subdivision=0",
        "human.use_deformer=true", "human.disable_posedirs=true",
        "human.loss.lpips_w=0.0", "human.loss.patch_size=16",
        "human.loss.humansep_w=1.0",
        "tpu.scene_capacity=256", f"tpu.human_capacity={H_CAP}",
        "tpu.smpl_vpb=8", "tpu.tile_cap=1024"]
STAGES = {"step.human_forward", "step.render", "step.loss",
          "step.sync_readback", "step.backward", "step.optim"}
COUNTERS = {"launches", "k2_launches", "mxu_launches", "k2_mxu_launches",
            "knn_launches", "retries", "overflow_persisted"}


@pytest.fixture(scope="module")
def fake_root(tmp_path_factory):
    from test_data import write_fake_neuman
    root = str(tmp_path_factory.mktemp("neuman"))
    write_fake_neuman(root, n_frames=10, w=48, h=32)
    return root


@pytest.fixture
def one_thread():
    """One CPU thread, so that two runs of a step sum in one order."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def recorder_default():
    """Each test starts and ends with the recorder at its default and
    empty (another test's profiler may have left records)."""
    profiling.enable(None)
    profiling.drain()
    yield
    profiling.enable(None)
    profiling.drain()


def _trainer(root, mode):
    cfg = load_config(None, TINY + [f"mode={mode}"])
    train = NeumanDataset(root, "lab", "train", render_mode=cfg.mode,
                          device="cpu")
    return ttr.GaussianTrainer(cfg, train, None, device="cpu",
                               smpl_model=synthetic_smpl(8, device="cpu"))


def _step(tr, t_iter=0, sync=True):
    data = tr.train_dataset[0]
    aux, vals = tr._train_step(t_iter, 0, data, sync)
    tr._periodic(t_iter, aux, data)
    return aux


def _state(tr) -> dict:
    return {f"{n}.{k}": v.detach().clone() for n, st in
            (("human", tr.human), ("scene", tr.scene)) if st is not None
            for k, v in ckpt_io.flatten(st).items()}


class _Forbidden:
    def __getattr__(self, name):
        raise AssertionError(f"the off path touched {name}")


@pytest.mark.parametrize("mode", ["human_scene", "scene"])
def test_off_records_nothing_and_changes_nothing(fake_root, mode,
                                                 one_thread, monkeypatch):
    """Off: no records, no clock, no CUDA event, no span made; the step's
    loss and state equal the recorded step's bit for bit."""
    off, on = _trainer(fake_root, mode), _trainer(fake_root, mode)
    with monkeypatch.context() as m:
        m.setattr(profiling, "time", _Forbidden())
        m.setattr(torch.cuda, "Event", _Forbidden())
        m.setattr(profiling, "_Span", _Forbidden())
        loss_off = _step(off)["loss"]
    assert profiling.drain() == ([], {})
    profiling.enable(True)
    loss_on = _step(on)["loss"]
    rec = profiling.drain()
    assert {s.name for s in rec.spans} >= {"train.step", "train.periodic"}
    assert torch.equal(loss_off, loss_on)
    a, b = _state(off), _state(on)
    assert a.keys() == b.keys()
    for k in a:
        assert torch.equal(a[k], b[k]), k


def test_joint_step_span_tree(fake_root):
    """One joint sync step, one that is no sync step, then one that
    overflows a 64-slot budget: the stages under train.step, the kNN
    under the human forward, each render's binning under step.render,
    the counters; the retry renders twice and counts once."""
    tr = _trainer(fake_root, "human_scene")
    profiling.enable(True)
    _step(tr, t_iter=0)
    _step(tr, t_iter=1, sync=False)
    tr._ibudget = 64
    _step(tr, t_iter=10)
    # a count held until the drain holds 8 bytes, not a view of a buffer
    held = [n for _, _, n in profiling._REC.counts
            if isinstance(n, torch.Tensor)]
    assert held and all(n.untyped_storage().nbytes() <= 8 for n in held)
    rec = profiling.drain()
    chunks = -(-H_CAP // 4096)
    by_step = {}
    for s in rec.spans:
        by_step.setdefault(s.step, []).append(s)
    assert set(by_step) == {0, 1, 10}
    for t, retried in ((0, False), (1, False), (10, True)):
        spans = by_step[t]
        roots = [s for s in spans if s.parent is None]
        assert [s.name for s in roots] == ["train.step", "train.periodic"]
        names = [s.name for s in spans]
        stages = STAGES - {"step.sync_readback"} if t == 1 else STAGES
        assert set(names) == stages | {"train.step", "train.periodic",
                                       "human.knn_targets", "render.bin"}
        attempts = 2 if retried else 1
        for name in ("step.human_forward", "step.render", "step.loss",
                     "human.knn_targets"):
            assert names.count(name) == attempts, (t, name)
        assert names.count("step.sync_readback") == (t != 1) * attempts
        # the merged render and the human alone, each attempt
        assert names.count("render.bin") == 2 * attempts
        for s in spans:
            parent = None if s.parent is None else rec.spans[s.parent].name
            want = {"train.step": None, "train.periodic": None,
                    "human.knn_targets": "step.human_forward",
                    "render.bin": "step.render"}.get(s.name, "train.step")
            assert parent == want, (s.name, parent)
            assert s.device_ms is None
            assert s.start_ns <= s.end_ns
        c = rec.steps[t]
        assert c["knn_chunks"] == attempts * chunks
        assert COUNTERS <= set(c)
        assert c["retries"] == (1 if retried else 0)
        # CPU: no K1, K2 or K3 (the plain kNN)
        assert c["launches"] == c["k2_launches"] == c["knn_launches"] == 0
        if t != 1:      # the instances where the step read them back
            assert 0 < c["n_instances"] <= c["n_slots"]
        assert 0 < c["n_slots"]
    assert rec.steps[0]["budget"] == rec.steps[1]["budget"] > 64
    assert rec.steps[10]["budget"] > 64       # the grown one, rendered last
    assert tr.retries == 1


def test_drain_empties_and_counts_need_a_step():
    profiling.enable(True)
    profiling.count("knn_chunks", 3)          # no open step: dropped
    with profiling.span("train.step", step=7):
        with profiling.span("inner"):
            profiling.count("knn_chunks", 2)
        with pytest.raises(RuntimeError):
            profiling.drain()
    with profiling.span("loose"):
        profiling.count("knn_chunks", 5)      # a span with no step
    rec = profiling.drain()
    assert [(s.name, s.parent, s.step) for s in rec.spans] == [
        ("train.step", None, 7), ("inner", 0, 7), ("loose", None, None)]
    assert rec.steps == {7: {"knn_chunks": 2}}
    assert profiling.drain() == ([], {})
    profiling.enable(False)
    with profiling.span("train.step", step=8):
        profiling.count("knn_chunks", 1)
    assert profiling.drain() == ([], {})


def test_captured_spans_replay(monkeypatch):
    """The template of a two-part captured step, replayed six times on
    a ring of four rows (stamps written by hand where the card's graph
    writes them): steps 0 and 1 read None, the later ones their rows."""
    monkeypatch.setattr(profiling, "RING_ROWS", 4)
    ring = profiling._Ring("cpu")
    monkeypatch.setattr(profiling, "_RING", ring)
    stamped = []
    monkeypatch.setattr(profiling, "_launch_stamp",
                        lambda stamps, row, mark: stamped.append(mark))
    t = profiling.Template()
    profiling.enable(False)       # a capture records whatever the state
    with profiling.capturing(t, "forward"):
        with profiling.span("step.render", device=True):
            with profiling.span("render.bin", device=True):
                pass
        with profiling.span("host.only"):
            pass
    with profiling.capturing(t, "update"):
        with profiling.span("step.backward", device=True):
            pass
    assert stamped == list(range(6)) and t.marks == 6
    assert profiling.drain() == ([], {})
    seq = profiling.begin_replay()                 # recorder off
    with profiling.replay(t, "forward", seq):
        pass
    assert profiling.drain() == ([], {}) and seq == 1
    profiling.enable(True)
    for step in range(6):
        with profiling.span("train.step", step=step):
            seq = profiling.begin_replay()
            # mark m at (step + 1) * m ms
            ring.stamps[seq % 4] = torch.arange(
                profiling.RING_MARKS) * (step + 1) * 1_000_000
            with profiling.replay(t, "forward", seq):
                pass
            with profiling.replay(t, "update", seq):
                pass
    rec = profiling.drain()
    for step in range(6):
        spans = {s.name: s for s in rec.spans if s.step == step}
        assert list(spans) == ["train.step", "step.render", "render.bin",
                               "host.only", "step.backward"]
        root = rec.spans.index(spans["train.step"])
        assert spans["step.render"].parent == root
        assert rec.spans[spans["render.bin"].parent].name == "step.render"
        assert spans["host.only"].parent == root
        assert spans["host.only"].device_ms is None
        assert spans["render.bin"].start_ns == spans["step.render"].start_ns
        written_over = step < 2        # replays 2, 3 of 7 on 4 rows
        for name, marks in (("step.render", 3), ("render.bin", 1),
                            ("step.backward", 1)):
            want = None if written_over else float(marks * (step + 1))
            assert spans[name].device_ms == want, (step, name)


def _span(name, parent, t0, t1, step=0):
    return Span(name, parent, step, t0, t1, None)


def test_idle_by_span():
    """Each gap goes to the innermost span open at its start: inside a
    nested span, after a child closed (its parent), at the window's end
    (the span still open); before the first span and between two steps
    to OUTSIDE."""
    spans = [_span("train.step", None, 100, 400),
             _span("step.render", 0, 110, 200),
             _span("render.bin", 1, 120, 150),
             _span("step.sync_readback", 0, 250, 300),
             _span("train.step", None, 500, 700, step=1),
             _span("step.loss", 4, 520, 560, step=1)]
    kernels = [(130, 135, "a"), (140, 160, "b"), (150, 170, "c"),
               (210, 260, "d"), (320, 520, "e"), (550, 560, "f"),
               (570, 600, "g")]
    got = profiling.idle_by_span(kernels, spans, 90, 800)
    want = {OUTSIDE: 130 - 90,                   # before the first span
            "render.bin": 140 - 135,             # inside render.bin
            "step.render": 210 - 170,            # render.bin closed
            "step.sync_readback": 320 - 260,
            "step.loss": 550 - 520,
            # step.loss closed; the window's end after the last kernel
            "train.step": (570 - 560) + (800 - 600)}
    want = {k: v * 1e-9 for k, v in want.items()}
    assert got.keys() == want.keys()
    for k in want:
        assert got[k] == pytest.approx(want[k]), k
    # between the steps: a gap from 400 to 500 with no span open
    got = profiling.idle_by_span([(390, 400, "x"), (500, 510, "y")], spans)
    assert got == {OUTSIDE: pytest.approx(100e-9)}


@pytest.mark.cuda
def test_span_clock_is_the_profilers():
    """In one profiled window on the card, a span around a large matmul
    and a synchronisation: the matmul's kernel starts no earlier than the
    span and ends less than 1 ms before it."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the GPU machine)")
    from torch.profiler import ProfilerActivity, profile
    a = torch.randn(4096, 4096, device="cuda")
    (a @ a).sum().item()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        with profiling.span("test.matmul", device=True):
            a @ a
            torch.cuda.synchronize()
    rec = profiling.drain()
    (s,) = rec.spans
    assert s.device_ms is not None and s.device_ms > 0
    kernels = [k for k in profiling.device_intervals(prof)
               if "gemm" in k[2].lower() or "sgemm" in k[2].lower()
               or "xmma" in k[2].lower()]
    assert kernels, [k[2] for k in profiling.device_intervals(prof)]
    k0, k1 = kernels[0][0], kernels[-1][1]
    assert k0 >= s.start_ns, (k0 - s.start_ns) * 1e-6
    assert 0 <= s.end_ns - k1 < 1_000_000, (s.end_ns - k1) * 1e-6


def test_profiler_session_turns_the_recorder_on():
    """By default the recorder records inside a torch.profiler session
    and not outside it."""
    from torch.profiler import ProfilerActivity, profile
    with profiling.span("before"):
        pass
    with profile(activities=[ProfilerActivity.CPU]):
        with profiling.span("inside"):
            pass
    with profiling.span("after"):
        pass
    assert [s.name for s in profiling.drain().spans] == ["inside"]
