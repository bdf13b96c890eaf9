"""The port's fragment-packet sizing (hugs_tpu_torch/gauss_frag_sizing.py)
against scripts/gauss_frag_sizing.py and hugs_tpu's render_gauss_sharded,
on the CPU.

The script's statements are taken from its source with `ast` and run
here (importing the script would set up its own path and devices):
- the scene's points at the script's N = 65,536 equal the port's bit for
  bit, and at a cut N = 2,048 so do the SH; the port's kNN scales are
  within 1e-6 of hugs_tpu's mean_sq_dist_to_knn;
- on that cut scene (hugs_tpu's scales, so both sides take the same
  Gaussians) at 64x48 and 3 orbit cameras, the port's frag_counts over 2
  gloo ranks (parallel/launch.py::run_ranks, 60 s) equal hugs_tpu's
  jitted render_gauss_sharded on a 2-device ('gauss',) mesh exactly, and
  one rank's (no group) its 1-device mesh's;
- the derived fields equal the script's formulas (its record built by
  its own statements), and a budget too small raises.
"""
import ast
import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hugs_tpu_torch import gauss_frag_sizing as gfs
from hugs_tpu_torch.parallel.launch import RANK_THREADS, run_ranks

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N_CUT = 2048
W, H = 64, 48
N_CAMS = 3
WORLD = 2
TIMEOUT = 60.0


@pytest.fixture(autouse=True, scope="module")
def _rank_threads():
    """torch on RANK_THREADS CPU threads, as in the spawned ranks."""
    n = torch.get_num_threads()
    torch.set_num_threads(RANK_THREADS)
    yield
    torch.set_num_threads(n)


@functools.lru_cache(maxsize=None)
def _script_main() -> list:
    """The statements of the script's main()."""
    with open(os.path.join(REPO, "scripts", "gauss_frag_sizing.py")) as f:
        tree = ast.parse(f.read())
    main = next(n for n in tree.body
                if isinstance(n, ast.FunctionDef) and n.name == "main")
    return main.body


def _run_statements(first: str, stop: str, env: dict) -> dict:
    """Runs the script's main() statements from the one that assigns
    `first` up to the one that assigns `stop` (not run) in `env`."""
    body = _script_main()

    def assigns(stmt, name):
        return isinstance(stmt, ast.Assign) and any(
            isinstance(t, ast.Name) and t.id == name for t in stmt.targets)

    i = next(k for k, s in enumerate(body) if assigns(s, first))
    j = next(k for k, s in enumerate(body) if assigns(s, stop))
    code = compile(ast.Module(body=body[i:j], type_ignores=[]),
                   "gauss_frag_sizing.py", "exec")
    exec(code, env)
    return env


@functools.lru_cache(maxsize=None)
def _script_scene(n: int) -> dict:
    """The script's scene at N = n, as its statements compute it (the
    kNN through hugs_tpu)."""
    from hugs_tpu.ops.knn import mean_sq_dist_to_knn
    env = _run_statements("rng", "mesh", {
        "np": np, "jnp": jnp, "N": n,
        "mean_sq_dist_to_knn": mean_sq_dist_to_knn})
    return {"means": env["pts"], "scales": np.asarray(env["scales"]),
            "rotq": np.asarray(env["rotq"], np.float32),
            "opacity": np.asarray(env["opacity"], np.float32),
            "shs": np.asarray(env["shs"])}


def _script_points(n: int) -> np.ndarray:
    return _run_statements("rng", "d2", {"np": np, "N": n})["pts"]


def test_points_are_the_scripts_bit_for_bit():
    pts, _ = gfs.scene_points(gfs.N)
    want = _script_points(gfs.N)
    assert pts.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(pts, want)


def test_cut_scene_matches_the_script():
    got = gfs.sizing_scene(N_CUT, "cpu")
    want = _script_scene(N_CUT)
    for k in ("means", "rotq", "opacity", "shs"):
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    np.testing.assert_allclose(got["scales"], want["scales"], atol=1e-6,
                               rtol=0)


@functools.lru_cache(maxsize=None)
def _jax_counts(world: int = WORLD) -> list:
    """hugs_tpu's render_gauss_sharded (jitted) on a `world`-device mesh:
    each camera's frag_counts."""
    from jax.sharding import Mesh

    from hugs_tpu.data.cameras import get_rotating_camera
    from hugs_tpu.parallel.gauss_shard import render_gauss_sharded
    s = {k: jnp.asarray(v) for k, v in _script_scene(N_CUT).items()}
    mesh = Mesh(np.array(jax.devices()[:world]), ("gauss",))
    f = jax.jit(lambda cam: render_gauss_sharded(
        s["means"], s["scales"], s["rotq"], s["opacity"], s["shs"], cam, W,
        H, mesh, active_sh_degree=3, local_budget=16 * N_CUT // world)
        ["frag_counts"])
    cams = get_rotating_camera(img_size=(H, W), fov=0.95, dist=3.0,
                               nframes=N_CAMS)
    return [np.asarray(f(c["camera"])).tolist() for c in cams]


@pytest.fixture(scope="module")
def ranks():
    return run_ranks(gfs.rank_counts, WORLD,
                     (_script_scene(N_CUT), W, H, N_CAMS, "cpu"),
                     timeout=TIMEOUT)


def test_two_rank_frag_counts_equal_jax(ranks):
    want = _jax_counts()
    for r in ranks:
        assert r["frag_counts_per_camera"] == want
        assert r["local_budget"] == 16 * N_CUT // WORLD
    # every kept instance lands in one packet: the counts are not empty
    assert min(np.sum(m) for m in want) > 0


def test_derived_fields_follow_the_script(ranks):
    mats = ranks[0]["frag_counts_per_camera"]
    got = gfs.summarize(mats, N_CUT, WORLD, W, H)
    per_pair_max = max(int(np.asarray(m).max()) for m in mats)
    per_band_max = max(int(np.asarray(m).sum(axis=0).max()) for m in mats)
    env = _run_statements("mean_pair", "ev", {
        "np": np, "mats": mats, "per_pair_max": per_pair_max,
        "per_band_max": per_band_max, "N": N_CUT, "D": WORLD, "W": W,
        "H": H, "local_budget": 16 * (N_CUT // WORLD)})
    want = dict(env["out"], workload=env["out"]["workload"].replace(
        "6 orbit", f"{N_CAMS} orbit"))
    assert set(got) == set(want)
    for k, v in want.items():
        if k == "mean_per_pair":
            assert round(got[k], 1) == v
        elif k == "skew_max_over_mean":
            assert round(got[k], 2) == v
        else:
            assert got[k] == v, k


def test_overflow_raises(monkeypatch):
    """A local budget of one slot a Gaussian cannot hold the cut scene's
    instances: the sizing raises instead of reporting clipped counts."""
    monkeypatch.setattr(gfs, "BUDGET_PER_ROW", 1)
    with pytest.raises(RuntimeError, match="overflowed"):
        gfs.measure("cpu", 1, N_CUT, W, H, 1, scene=_script_scene(N_CUT))


def test_world1_counts_equal_jax():
    """The one-rank run (chip_smoke.py's on one card): one packet, the
    whole frame's kept instances, = hugs_tpu's on a 1-device mesh."""
    rec = gfs.measure("cpu", 1, N_CUT, W, H, N_CAMS,
                      scene=_script_scene(N_CUT))
    assert rec["ranks"] == 1 and len(rec["k1_launches"]) == 1
    assert rec["frag_counts_per_camera"] == _jax_counts(1)


def test_no_card_exits_2(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert gfs.main([]) == 2
    assert "{" not in capsys.readouterr().out
