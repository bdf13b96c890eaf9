"""K3, the kNN kernel (hugs_tpu_torch/csrc/knn.cu through ops/knn.py::knn),
against its plain version ops/knn.py::plain_knn.

On the card (marked cuda) the kernel's distances and indices equal the
plain version's on the same device exactly (torch.equal):
- at the skinning targets' shape: 524,288 rows against the 6,912
  vitruvian vertices of synthetic_smpl(288), k = 6, 455,183 rows at the
  origin;
- at the scene set-up's self-kNN, k = 4, on 100,003 points (no tile
  divides it);
- on hand-built ties: duplicate reference points and points on a sphere
  about the queries, on integer coordinates whose mean is 0, so that
  every distance is exact and equal distances stay equal;
- at k = 1 to 8 on clouds.
`smpl_lbsweight_top_k` on the card equals its result through the plain
version, and counts one launch a call (LAUNCHES) and no `knn_chunks`;
where the points require grad the kernel's distances carry the plain
version's gradient; the kernel refuses k > 8, k > N and float64 points.

On the CPU: `knn` runs the plain version (no launch counted), and
`lbs_points` holds the body's rows and the dead rows at the origin.

No JAX here: this file collects on the card's machine.
"""
import importlib

import pytest
import torch

from hugs_tpu_torch.models import human_gs
from hugs_tpu_torch.models.smpl import smpl_forward, synthetic_smpl
from hugs_tpu_torch.models.subdivide import subdivide_smpl_model
from hugs_tpu_torch.utils import profiling

# the module: hugs_tpu_torch.ops exports the function `knn` under its name
knn_mod = importlib.import_module("hugs_tpu_torch.ops.knn")


def lbs_points(device, vpb: int = 288, capacity: int = 524288,
               seed: int = 0):
    """(query (capacity, 3), ref (V, 3), lbs_weights (V, 24)) of the
    skinning targets' kNN: synthetic_smpl(vpb) subdivided twice, its
    vertices moved by a little noise in the first rows, as a trained
    avatar's live rows, the rest of the capacity at the origin, as its
    dead rows are; the references are the body's vitruvian vertices."""
    smpl = synthetic_smpl(vpb, device=device)
    template = subdivide_smpl_model(smpl, smoothing=True, n_iter=2)
    betas = torch.zeros(10, device=device)
    ref = human_gs.compute_vitruvian(smpl, betas).vitruvian_verts
    alive = smpl_forward(template, betas, human_gs.vitruvian_pose(device),
                         torch.zeros(3, device=device)).vertices
    g = torch.Generator().manual_seed(seed)
    query = torch.zeros((capacity, 3), device=device)
    query[:alive.shape[0]] = alive + 0.01 * torch.randn(
        alive.shape, generator=g).to(device)
    return query, ref, smpl.lbs_weights


def cloud(n: int, device, seed: int = 0, center=(0.3, 1.2, -0.4)):
    """n points of a normal cloud (scale 0.5) about `center`."""
    g = torch.Generator().manual_seed(seed)
    pts = torch.randn((n, 3), generator=g) * 0.5 + torch.tensor(center)
    return pts.to(device)


@pytest.fixture
def cuda_device():
    """The first CUDA device; skips the test where there is none."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the GPU machine)")
    return torch.device("cuda", 0)


def _grid(r: int) -> torch.Tensor:
    """Integer points of [-r, r]^3: symmetric, so their mean is 0."""
    ax = torch.arange(-r, r + 1, dtype=torch.float32)
    return torch.cartesian_prod(ax, ax, ax)


def _sphere() -> torch.Tensor:
    """The 30 integer points at squared distance 9 from the origin."""
    g = _grid(3)
    return g[(g * g).sum(1) == 9]


def tie_case(name: str):
    """(query, ref) of integer points with a zero reference mean."""
    gen = torch.Generator().manual_seed(5)
    if name == "duplicates":
        g = _grid(2)
        ref = torch.cat([g, g, g])[torch.randperm(3 * len(g), generator=gen)]
        query = _grid(3)
    else:                                   # "sphere"
        s = _sphere()
        ref = torch.cat([s, _grid(1)])[torch.randperm(len(s) + 27,
                                                      generator=gen)]
        query = torch.cat([torch.zeros((40, 3)), _grid(2)])
    return query, ref


def _assert_equal(got, want):
    assert torch.equal(got[1], want[1])
    assert torch.equal(got[0], want[0])


@pytest.mark.cuda
def test_knn_kernel_at_skinning_shape(cuda_device):
    query, ref, _ = lbs_points(cuda_device)
    dead = (query == 0).all(1)
    assert query.shape[0] == 524288 and ref.shape[0] == 6912
    assert int(dead.sum()) == 455183
    got = knn_mod.knn(query, ref, 6)
    torch.cuda.synchronize()
    _assert_equal(got, knn_mod.plain_knn(query, ref, 6))
    # every dead row has the same list
    assert torch.equal(got[1][dead], got[1][dead][:1].expand(455183, 6))


@pytest.mark.cuda
def test_knn_kernel_scene_self_knn(cuda_device):
    pts = cloud(100003, cuda_device, seed=3)
    got = knn_mod.knn(pts, pts, 4)
    torch.cuda.synchronize()
    _assert_equal(got, knn_mod.plain_knn(pts, pts, 4))
    assert torch.equal(knn_mod.mean_sq_dist_to_knn(pts, k=3),
                       torch.mean(got[0][:, 1:], dim=-1))


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["duplicates", "sphere"])
@pytest.mark.parametrize("k", [1, 4, 6, 8])
def test_knn_kernel_ties(cuda_device, case, k):
    query, ref = (x.to(cuda_device) for x in tie_case(case))
    got = knn_mod.knn(query, ref, k)
    torch.cuda.synchronize()
    _assert_equal(got, knn_mod.plain_knn(query, ref, k))


@pytest.mark.cuda
@pytest.mark.parametrize("k", range(1, 9))
def test_knn_kernel_every_k(cuda_device, k):
    query = cloud(5000, cuda_device, seed=k, center=(3.0, -1, 2))
    ref = cloud(3001, cuda_device, seed=10 + k, center=(3.0, -1, 2))
    got = knn_mod.knn(query, ref, k)
    torch.cuda.synchronize()
    _assert_equal(got, knn_mod.plain_knn(query, ref, k))


@pytest.mark.cuda
def test_lbsweight_top_k_on_card(cuda_device, monkeypatch):
    query, ref, weights = lbs_points(cuda_device)
    before = knn_mod.LAUNCHES
    profiling.enable(True)
    try:
        with profiling.span("train.step", step=0):
            got = human_gs.smpl_lbsweight_top_k(weights, query, ref)
        rec = profiling.drain()
    finally:
        profiling.enable(None)
    assert knn_mod.LAUNCHES == before + 1
    assert "knn_chunks" not in rec.steps.get(0, {})
    monkeypatch.setattr(human_gs, "knn", knn_mod.plain_knn)
    want = human_gs.smpl_lbsweight_top_k(weights, query, ref)
    for a, b in zip(got, want):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_knn_kernel_gradient_as_plain(cuda_device):
    """Where the points require grad, the kernel's distances carry the
    plain version's gradient in both clouds (index_add's order differs:
    rtol 1e-5)."""
    query = cloud(3000, cuda_device, seed=21).requires_grad_()
    ref = cloud(700, cuda_device, seed=22).requires_grad_()
    w = cloud(3000, cuda_device, seed=23)[:, :2]
    grads = []
    for fn in (knn_mod.knn, knn_mod.plain_knn):
        d, idx = fn(query, ref, 2)
        grads.append((d, idx, *torch.autograd.grad((d * w).sum(),
                                                   (query, ref))))
    (d, idx, gq, gr), (d0, idx0, gq0, gr0) = grads
    _assert_equal((d.detach(), idx), (d0.detach(), idx0))
    torch.testing.assert_close(gq, gq0, rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(gr, gr0, rtol=1e-5, atol=1e-6)


@pytest.mark.cuda
def test_knn_kernel_refuses(cuda_device):
    pts = cloud(100, cuda_device)
    for args in ((pts, pts, 9), (pts, pts[:3], 4), (pts.double(), pts, 4)):
        with pytest.raises(ValueError):
            knn_mod.knn(*args)


def test_knn_on_cpu_counts_chunks_not_launches():
    query, ref = tie_case("duplicates")
    before = knn_mod.LAUNCHES
    profiling.enable(True)
    try:
        with profiling.span("train.step", step=3):
            got = knn_mod.knn(query, ref, 6, chunk=100)
        rec = profiling.drain()
    finally:
        profiling.enable(None)
    assert rec.steps[3] == {"knn_chunks": -(-len(query) // 100)}
    assert knn_mod.LAUNCHES == before
    _assert_equal(got, knn_mod.plain_knn(query, ref, 6))


def test_lbs_points_rows():
    query, ref, weights = lbs_points("cpu", vpb=8, capacity=3000)
    alive = (query != 0).any(1)
    assert ref.shape == (192, 3) and weights.shape == (192, 24)
    assert query.shape == (3000, 3)
    n = int(alive.sum())
    assert 192 < n < 3000 and bool(alive[:n].all())
