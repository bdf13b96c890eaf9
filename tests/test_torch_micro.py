"""The port's micro-benchmarks (hugs_tpu_torch/micro/) against hugs_tpu's
TPU probes under scripts/, on the same inputs.

- S2 (vpu_peak): each mode's plain version against the script's Pallas
  `_kernel` in interpret mode at its smoke size (GRID 8, INNER 4), two
  chained calls, the whole (1024, 128) block: rtol 1e-5, atol 1e-5 times
  the block's largest value. The fused multiply-adds round once on both
  sides (XLA's CPU backend contracts them); blendmix's exp and log1p may
  differ by an ulp between XLA and torch (seen: 1.3e-7 relative).
- S1 (micro_bf16): madd and exp in float32 and bfloat16 through the
  script's `make_fn` (interpret mode, r = 8, K = 20), from the script's
  start (0.5) and from a linspace that moves bf16 madd: float32 rtol 1e-6,
  bfloat16 within one bf16 ulp.
- S3 (micro_bwd): the JAX skeleton cannot run here (its pallas_call uses
  TPU DMAs and has no interpret flag), so each plain variant is held to a
  direct per-(tile, instance, warp) loop in float64 on a tiny scene: rtol
  1e-5 and atol 1e-5 times the largest value (float32 sums of a few
  hundred terms of both signs, in another order); `full`'s plain version
  is plain_blend_bwd itself.
- On the card (marked cuda): each kernel against its plain version, S3
  on the tiny frame to the bar of the pair loop.
"""
import functools
import importlib.util
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from hugs_tpu_torch.micro import micro_bf16, micro_bwd, vpu_peak
from hugs_tpu_torch.render import cuda_blend
from hugs_tpu_torch.render.blend import (
    gauss_features, plain_blend, plain_blend_bwd,
)
from hugs_tpu_torch.render.project import project_gaussians
from hugs_tpu_torch.render.tiles import TILE, bin_gaussians, tile_grid
from torch_parity import (  # noqa: F401 (cuda_device: a fixture)
    H, W, cameras, cuda_device, make_scene, np_of, to_torch,
)

SCRIPTS = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "scripts")


@functools.lru_cache(maxsize=None)
def _script(name):
    """scripts/<name>.py imported by path at its smoke size, leaving the
    compilation-cache settings it sets at import as they were."""
    keys = ("jax_compilation_cache_dir",
            "jax_persistent_cache_min_compile_time_secs")
    saved = {k: getattr(jax.config, k) for k in keys}
    smoke = os.environ.get("VPU_SMOKE")
    os.environ["VPU_SMOKE"] = "1"
    try:
        spec = importlib.util.spec_from_file_location(
            f"_script_{name}", os.path.join(SCRIPTS, f"{name}.py"))
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
    finally:
        for k, v in saved.items():
            jax.config.update(k, v)
        if smoke is None:
            del os.environ["VPU_SMOKE"]
        else:
            os.environ["VPU_SMOKE"] = smoke
    return mod


# ---- S2

def _jax_vpu(mode, x, reps):
    """The script's pallas_call (as its build(), vpu_peak.py:103-111) in
    interpret mode, `reps` calls chained as its fori_loop."""
    vp = _script("vpu_peak")
    call = pl.pallas_call(
        functools.partial(vp._kernel, mode=mode, inner=vp.INNER),
        grid=(vp.GRID,),
        in_specs=[pl.BlockSpec((vp.P, vp.CHUNK), lambda i: (0, 0))],
        out_specs=pl.BlockSpec((vp.P, vp.CHUNK), lambda i: (0, 0)),
        out_shape=jax.ShapeDtypeStruct((vp.P, vp.CHUNK), jnp.float32),
        interpret=True)
    v = jnp.asarray(x)
    for _ in range(reps):
        v = call(v) * 1e-6
    return np.asarray(v)


def test_vpu_peak_script_is_at_its_smoke_size():
    vp = _script("vpu_peak")
    assert (vp.GRID, vp.INNER, vp.P, vp.CHUNK) == (
        vpu_peak.SMOKE_GRID, vpu_peak.SMOKE_INNER, vpu_peak.P,
        vpu_peak.CHUNK)
    assert [vpu_peak.ops_per_elem(m, vp.INNER) for m in vpu_peak.MODES] \
        == [vp.ops_per_elem(m) for m in vpu_peak.MODES]


@pytest.mark.parametrize("mode", vpu_peak.MODES)
def test_vpu_peak_matches_the_script(mode):
    x = np_of(vpu_peak.start_block("cpu"))
    want = _jax_vpu(mode, x, reps=2)
    got = np_of(vpu_peak.run(torch.as_tensor(x), mode, vpu_peak.SMOKE_GRID,
                             vpu_peak.SMOKE_INNER, reps=2))
    assert got.shape == (vpu_peak.P, vpu_peak.CHUNK)
    assert np.abs(want).max() > 0
    np.testing.assert_allclose(got, want, rtol=1e-5,
                               atol=1e-5 * np.abs(want).max())


def _entry_point(module, tmp_path, capsys):
    """module.main with --device cpu: its JSON on stdout and in --out."""
    out = tmp_path / "out.json"
    module.main(["--device", "cpu", "--out", str(out)])
    res = json.loads(out.read_text())
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) \
        == res
    assert res["device"] == "cpu"
    return res


def test_vpu_peak_cpu_entry_point(tmp_path, capsys):
    """--device cpu runs the plain versions at the script's smoke size and
    writes no time."""
    res = _entry_point(vpu_peak, tmp_path, capsys)
    assert (res["grid"], res["inner"], res["reps"]) == (
        vpu_peak.SMOKE_GRID, vpu_peak.SMOKE_INNER, vpu_peak.SMOKE_REPS)
    x = vpu_peak.start_block("cpu")
    for mode in vpu_peak.MODES:
        assert "s_per_rep" not in res[mode]
        want = vpu_peak.run(x, mode, vpu_peak.SMOKE_GRID,
                            vpu_peak.SMOKE_INNER, vpu_peak.SMOKE_REPS)
        assert res[mode]["sum"] == float(want.double().sum())


def test_vpu_peak_kernel_is_built_for_the_full_inner_only():
    """On the card the kernel takes INNER alone; the smoke size is the
    plain version's, on the CPU."""
    x = vpu_peak.start_block("meta")
    with pytest.raises(ValueError, match="inner 64"):
        vpu_peak.vpu_call(x, "fma", 2, vpu_peak.SMOKE_INNER)


def test_sass_opcodes_reads_one_function(tmp_path, monkeypatch):
    """Opcodes of the named function only, in order, predicates dropped,
    the encoding lines skipped."""
    from hugs_tpu_torch import build
    from hugs_tpu_torch import micro
    (tmp_path / "nvcc").write_text("")
    (tmp_path / "cuobjdump").write_text("")
    sass = "\n".join([
        "\t\tFunction : _ZN4a_kernelILi0EEEvPf",
        "        /*0000*/                   MOV R1, c[0x0][0x28] ;   /* 0x1 */",
        "                                                             /* 0x2 */",
        "        /*0010*/                   FFMA R2, R2, R3, R4 ;    /* 0x3 */",
        "        /*0020*/               @!P0 FFMA.FTZ R2, R2, R3, R4 ; /* 0x4 */",
        "        /*0030*/                   EXIT ;                   /* 0x5 */",
        "\t\tFunction : _ZN4b_kernelEv",
        "        /*0000*/                   FFMA R2, R2, R3, R4 ;    /* 0x6 */",
    ])
    monkeypatch.setattr(build, "nvcc", lambda: str(tmp_path / "nvcc"))
    monkeypatch.setattr(micro.subprocess, "run", lambda *a, **k: type(
        "Done", (), {"stdout": sass})())
    assert micro.sass_opcodes(tmp_path / "lib.so", "a_kernelILi0E") == [
        "MOV", "FFMA", "FFMA.FTZ", "EXIT"]
    assert micro.sass_opcodes(tmp_path / "lib.so", "b_kernel") == ["FFMA"]
    with pytest.raises(RuntimeError, match="no function c_kernel"):
        micro.sass_opcodes(tmp_path / "lib.so", "c_kernel")



def test_loop_pipes_of_the_widest_loop(tmp_path, monkeypatch):
    """The widest loop (a backward branch's target through the branch,
    by address or by label) and its instructions per pipe; the bound of
    the fullest pipe at a clock."""
    from hugs_tpu_torch import build
    from hugs_tpu_torch import micro
    (tmp_path / "nvcc").write_text("")
    (tmp_path / "cuobjdump").write_text("")
    sass = "\n".join([
        "\t\tFunction : _ZN4a_kernelILi0EEEvPf",
        "        /*0000*/                   MOV R1, c[0x0][0x28] ;",
        "        /*0010*/                   FFMA R2, R2, R3, R4 ;",
        "        /*0020*/                   MUFU.EX2 R2, R2 ;",
        "        /*0030*/                   FSETP.GT.AND P0, PT, R2, R3, PT ;",
        "        /*0040*/                   ISETP.NE.AND P1, PT, R5, RZ, PT ;",
        "        /*0050*/               @P1 BRA 0x10 ;",
        "        /*0060*/                   FADD R2, R2, R3 ;",
        "        /*0070*/                   BRA 0x60 ;",
        "\t\tFunction : _ZN4b_kernelEv",
        ".L_x_1:",
        "        /*0000*/                   HMUL2.BF16_V2 R2, R2, R3 ;",
        "        /*0010*/                   ULDC UR4, c[0x0][0x0] ;",
        "        /*0020*/               @P0 BRA `(.L_x_1) ;",
    ])
    monkeypatch.setattr(build, "nvcc", lambda: str(tmp_path / "nvcc"))
    monkeypatch.setattr(micro.subprocess, "run", lambda *a, **k: type(
        "Done", (), {"stdout": sass})())
    ops = micro.loop_opcodes(micro.sass_listing(tmp_path / "lib.so",
                                                "a_kernel"))
    assert ops == ["FFMA", "MUFU.EX2", "FSETP.GT.AND", "ISETP.NE.AND",
                   "BRA"]
    n = micro.pipe_counts(ops)
    assert n == {"fp32": 1, "mufu": 1, "alu": 2, "issue": 4}
    b = micro.loop_opcodes(micro.sass_listing(tmp_path / "lib.so",
                                              "b_kernel"))
    assert micro.pipe_counts(b) == {"fp32": 1, "mufu": 0, "alu": 0,
                                    "issue": 1}
    # 16 x 132 x 1000 MHz threads a ms on the special-function units
    ms, pipe = micro.pipe_bound_ms(n, 16 * 132 * 10**6, 1000.0, 132)
    assert pipe == "mufu" and ms == pytest.approx(1.0)

def _sass_text(name, body, before=("MOV R1, c[0x0][0x28]",)):
    """A cuobjdump listing of function `name`: `before`, then `body` as a
    loop closed by a backward branch, then EXIT."""
    lines = [f"\t\tFunction : _ZN10hugs_micro{name}EvPKfPfS2_iiff"]
    ops = list(before) + list(body)
    for i, op in enumerate(ops):
        lines.append(f"        /*{16 * i:04x}*/                   {op} ;")
    n, top = len(ops), 16 * len(before)
    lines.append(f"        /*{16 * n:04x}*/               @P0 BRA {top:#x} ;")
    lines.append(f"        /*{16 * (n + 1):04x}*/                   EXIT ;")
    return "\n".join(lines)


def _serial_step(chains, loop_alu):
    """S2 serial's grid step for `chains` elements a thread, as sm_90a
    compiles it: each chain's FMUL and FADD of v, the 4 INNER FFMA of the
    chains interleaved (k0 and b0 reused), each FADD into o, and
    `loop_alu` ISETP."""
    body = []
    for j in range(chains):
        body += [f"FMUL R{20 + j}, R{10 + j}, c[0x0][0x190]",
                 f"FADD R{20 + j}, R{30 + j}, R{20 + j}"]
    for _ in range(4 * vpu_peak.INNER):
        body += [f"FFMA R{20 + j}, R{20 + j}, R2.reuse, R3.reuse"
                 for j in range(chains)]
    body += [f"FADD R{10 + j}, R{10 + j}, R{20 + j}" for j in range(chains)]
    return body + ["ISETP.NE.AND P0, PT, R8, RZ, PT"] * loop_alu


def test_bound_counts_each_element_pass(tmp_path, monkeypatch):
    """micro.pass_bound over micro.loop_passes reckons the same work
    whatever the design: a loop of four chains with four times one
    chain's instructions gives the one-chain loop's bound; with one loop
    test for the four, the FP32 count a pass stays 259. S2 serial's
    one-chain loop and S1 bf16 madd's loop of 8 passes give the counts
    and bounds of the one-element designs (259 FP32 + 1 ALU a step,
    0.52156 ms; HMUL2 + HADD2 + 0.125 ALU a pass, 0.13641 ms; at 1,980
    MHz on 132 SMs)."""
    from hugs_tpu_torch import build
    from hugs_tpu_torch import micro
    (tmp_path / "nvcc").write_text("")
    (tmp_path / "cuobjdump").write_text("")
    funcs = {
        "serial_one_chain": _serial_step(1, 1),
        "serial_four_chains": _serial_step(4, 4),
        vpu_peak.kernel_name("serial"): _serial_step(4, 1),
        micro_bf16.kernel_name("madd", "bfloat16"): [
            "HMUL2.BF16_V2 R5, R5, R2.H0_H0",
            "HADD2.BF16_V2 R5, R5, R3.H0_H0"] * 8
        + ["IADD3 R8, R8, -0x8, RZ"],
        "madd_bf16_two_pairs": ["HMUL2.BF16_V2 R5, R5, R2.H0_H0",
                                "HMUL2.BF16_V2 R6, R6, R2.H0_H0",
                                "HADD2.BF16_V2 R5, R5, R3.H0_H0",
                                "HADD2.BF16_V2 R6, R6, R3.H0_H0"] * 8
        + ["IADD3 R8, R8, -0x8, RZ"]}
    sass = "\n".join(_sass_text(k, v) for k, v in funcs.items())
    monkeypatch.setattr(build, "nvcc", lambda: str(tmp_path / "nvcc"))
    monkeypatch.setattr(micro.subprocess, "run", lambda *a, **k: type(
        "Done", (), {"stdout": sass})())

    def bound(name, marks, element_passes):
        loop = micro.loop_opcodes(micro.sass_listing(tmp_path / "lib.so",
                                                     name))
        passes = micro.loop_passes(loop, *marks)
        return passes, micro.pass_bound(loop, passes, element_passes,
                                        1980.0, 132)

    s2 = vpu_peak.P * vpu_peak.CHUNK * vpu_peak.GRID
    ffma = (("FFMA",), 4 * vpu_peak.INNER)
    one, b1 = bound("serial_one_chain", ffma, s2)
    four, b4 = bound("serial_four_chains", ffma, s2)
    real, br = bound(vpu_peak.kernel_name("serial"), ffma, s2)
    assert (one, four, real) == (1, 4, 4)
    assert b1["pipes_per_pass"] == {"fp32": 259, "mufu": 0, "alu": 1,
                                    "issue": 260}
    assert b4 == b1
    assert br["pipes_per_pass"]["fp32"] == 259
    assert br["pipes_per_pass"]["alu"] == 0.25
    assert b1["bound_pipe"] == "issue"
    assert b1["bound_ms"] == pytest.approx(0.52156, abs=5e-6)
    assert br["bound_ms"] == pytest.approx(b1["bound_ms"] * 259.25 / 260)
    s1 = micro_bf16.P * micro_bf16.C // 2 * micro_bf16.RS[-1]
    marks = (("HMUL2", "HADD2"), 2)
    p1, m1 = bound(micro_bf16.kernel_name("madd", "bfloat16"), marks, s1)
    p2, m2 = bound("madd_bf16_two_pairs", marks, s1)
    assert (p1, p2) == (8, 16)
    assert m1["pipes_per_pass"] == {"fp32": 2, "mufu": 0, "alu": 0.125,
                                    "issue": 2.125}
    assert m1["bound_ms"] == pytest.approx(0.13641, abs=5e-6)
    assert m2["pipes_per_pass"]["fp32"] == 2
    assert m2["pipes_per_pass"]["alu"] == 0.0625


def test_chain_floor_by_hand():
    """65,536 dependent instructions at 8 clocks and 2,000 MHz take
    0.262144 ms; S2 serial's chain (512 steps of 259) at 4 clocks and
    1,980 MHz 0.267895 ms; chain_latency inverts chain_floor_ms."""
    from hugs_tpu_torch.micro import chain_floor_ms, chain_latency
    assert chain_floor_ms(65_536, 8.0, 2000.0) == pytest.approx(0.262144)
    depth = vpu_peak.chain_depth("serial")
    assert depth == 512 * 259 == 132_608
    assert micro_bf16.chain_depth("madd", "bfloat16") == 65_536
    assert micro_bf16.chain_depth("exp", "float32") == 32_768
    assert vpu_peak.chain_depth("fma") == 512
    assert chain_floor_ms(depth, 4.0, 1980.0) == pytest.approx(
        132_608 * 4 / 1.98e6, rel=1e-12)
    assert chain_floor_ms(depth, 4.0, 1980.0) == pytest.approx(0.267895,
                                                               abs=5e-7)
    assert chain_latency(0.262144, 65_536, 2000.0) == pytest.approx(8.0)


def test_chain_probe_refuses_cpu_tensors():
    """S2's chain probe runs the kernel only: no plain version stands in."""
    before = vpu_peak.LAUNCHES
    with pytest.raises(ValueError, match="CUDA tensors only"):
        vpu_peak.chain_call(vpu_peak.start_block("cpu"))
    assert vpu_peak.LAUNCHES == before


# ---- S1

def _bf16_ulp(v):
    """One bf16 ulp at |v| (8 significant bits)."""
    e = np.floor(np.log2(np.maximum(np.abs(v), 2.0 ** -126)))
    return 2.0 ** (e - 7)


_STARTS = {"script": lambda: np.full((1024, 128), micro_bf16.START,
                                     np.float32),
           "linspace": lambda: np.linspace(-2.0, 3.0, 1024 * 128,
                                           dtype=np.float32)
           .reshape(1024, 128)}


@pytest.mark.parametrize("start", sorted(_STARTS))
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("op", micro_bf16.OPS)
def test_micro_bf16_matches_the_script(op, dtype, start):
    mb = _script("micro_bf16")
    assert mb.K == micro_bf16.K and (mb.P, mb.C) == (micro_bf16.P,
                                                     micro_bf16.C)
    x = _STARTS[start]()
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    c = np.array([[micro_bf16.C_VALUE]], np.float32)
    want = np.asarray(mb.make_fn(jdt, op, 8)(jnp.asarray(c),
                                             jnp.asarray(x).astype(jdt))
                      .astype(jnp.float32))
    got = micro_bf16.block(torch.as_tensor(c),
                           torch.as_tensor(x).to(micro_bf16.DTYPES[dtype]),
                           op, 8)
    assert got.dtype == micro_bf16.DTYPES[dtype]
    got = np_of(got.float())
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=1e-6)
    else:
        assert (np.abs(got - want) <= _bf16_ulp(want)).all()
    moved = np.abs(want - x).max()
    if op == "madd" and dtype == "bfloat16" and start == "script":
        assert moved == 0.0   # 0.9999 is 1.0 in bf16: the block stays
    else:
        assert moved > 1e-3


def test_micro_bf16_cpu_entry_point(tmp_path, capsys):
    """--device cpu runs the plain passes at SMOKE_RS and SMOKE_K."""
    res = _entry_point(micro_bf16, tmp_path, capsys)
    assert (res["rs"], res["K"]) == (list(micro_bf16.SMOKE_RS),
                                     micro_bf16.SMOKE_K)
    c = torch.tensor([[micro_bf16.C_VALUE]])
    for op in micro_bf16.OPS:
        for name, dtype in micro_bf16.DTYPES.items():
            x = torch.full((micro_bf16.P, micro_bf16.C), micro_bf16.START,
                           dtype=dtype)
            want = micro_bf16.block(c, x, op, micro_bf16.SMOKE_RS[-1],
                                    micro_bf16.SMOKE_K)
            assert res[f"{op}_{name}"] == {
                "mean": float(want.double().mean())}


def test_micro_bf16_constants_round_as_jax():
    """c is cast to bf16 from float32, e = 1e-3 rounds to the same bf16 in
    both packages."""
    for v in (micro_bf16.C_VALUE, micro_bf16.E):
        want = float(jnp.asarray(jnp.float32(v)).astype(jnp.bfloat16))
        got = float(torch.tensor(v, dtype=torch.float32)
                    .to(torch.bfloat16))
        assert got == want == float(jnp.full((), v, jnp.bfloat16))
    assert got != micro_bf16.E


# ---- S3

def _small_frame(seed=5, g_seed=9):
    """A tiny frame on the CPU: 200 Gaussians, 64x48, 16x16 tiles, the
    plain forward's final log T and walk, a random d(loss)/d(image)."""
    scene = to_torch(make_scene(n=200, seed=seed))
    _, cam = cameras()
    pg = project_gaussians(scene["means"], scene["scales"], scene["rotq"],
                           scene["opacity"], scene["shs"], cam, W, H, 3)
    bins = bin_gaussians(pg, W, H, 1 << 14)
    feat = gauss_features(pg).detach()
    bg = torch.tensor([0.2, 0.3, 0.4])
    _, log_t, pairs = plain_blend(feat, bins.gauss_id, bins.starts,
                                  bins.ends, bg, W, H)
    g = np.random.default_rng(g_seed).normal(size=(3, H, W))
    return dict(feat=feat, bins=bins, bg=bg, log_t=log_t,
                n_walked=pairs[0].to(torch.int32),
                grad=torch.as_tensor(g.astype(np.float32)), width=W,
                height=H)


def _loop_reference(mode, fr):
    """The variant, pair by pair: for each tile, instance and warp, the
    warp's 32 pixels that walk the instance, in numpy. Which instances a
    warp keeps comes from the port's own cull predicate
    (cuda_blend.warp_cull, on CPU tensors the same tiles._tight_cull_keep
    that plain_variant calls), so this holds how the cull is wired in, not
    what it keeps: test_torch_warp_cull.py holds the predicate itself
    (never dropping a pair with alpha > 0)."""
    b = fr["bins"]
    feat = np_of(fr["feat"]).astype(np.float64)
    gid = np_of(b.gauss_id)
    starts, ends = np_of(b.starts), np_of(b.ends)
    nw, g_r = np_of(fr["n_walked"]), np_of(fr["grad"][0]).astype(np.float64)
    nx, ny = tile_grid(W, H, TILE)
    gf = np.zeros((feat.shape[0], 10))
    pix = np.zeros((H, W))
    chk = np.zeros(nx * ny)
    rows = cuda_blend.WARP_RECT[1]
    for t in range(nx * ny):
        x0, y0 = (t % nx) * TILE, (t // nx) * TILE
        xs = np.arange(x0, min(x0 + TILE, W))
        tile_walk = nw[y0:y0 + TILE, x0:x0 + TILE].max()
        count = ends[t] - starts[t]
        chk[t] = feat[gid[starts[t]:starts[t] + tile_walk]].sum()
        if count == 0:
            continue
        ids = gid[starts[t]:ends[t]]
        keep = np.ones((TILE // rows, count), bool)
        if mode != "skeleton_no_cull":
            for w in range(TILE // rows):
                keep[w] = np_of(cuda_blend.warp_cull(
                    fr["feat"], torch.as_tensor(ids),
                    torch.full((count,), t % nx, dtype=torch.int32),
                    torch.full((count,), (t // nx) * (TILE // rows) + w,
                               dtype=torch.int32)))
        for w in range(TILE // rows):
            for y in range(y0 + rows * w, min(y0 + rows * (w + 1), H)):
                for i in np.nonzero(keep[w])[0]:
                    on = xs[i < nw[y, xs]]
                    if on.size == 0:
                        continue
                    f = feat[ids[i], :9]
                    gf[ids[i], :9] += g_r[y, on].sum() * f
                    pix[y, on] += g_r[y, on] * f.sum()
    return {"staging_only": chk, "skeleton_no_shuffle": pix}.get(mode, gf)


@pytest.mark.parametrize("mode", cuda_blend.SKELETON_MODES)
def test_skeleton_plain_matches_a_pair_loop(mode):
    fr = _small_frame()
    assert int(fr["n_walked"].sum()) > 1000, "the frame needs overlap"
    out, grad_bg = micro_bwd.variant(mode, fr)
    want = _loop_reference(mode, fr)
    assert np.abs(want).max() > 0
    np.testing.assert_allclose(np_of(out), want, rtol=1e-5,
                               atol=1e-5 * np.abs(want).max())
    _, full_bg = plain_blend_bwd(fr["feat"], fr["bins"].gauss_id,
                                 fr["bins"].starts, fr["bins"].ends,
                                 fr["bg"], W, H, fr["grad"])
    np.testing.assert_allclose(np_of(grad_bg), np_of(full_bg), rtol=1e-5)


def test_skeleton_cull_changes_what_it_keeps():
    """The cull drops pairs: with it the skeleton's sums differ from those
    of skeleton_no_cull (so the test above holds both to the cull)."""
    fr = _small_frame()
    a, _ = micro_bwd.variant("skeleton", fr)
    b, _ = micro_bwd.variant("skeleton_no_cull", fr)
    assert not torch.allclose(a, b)


def test_full_plain_is_plain_blend_bwd():
    fr = _small_frame()
    b = fr["bins"]
    got = micro_bwd.variant("full", fr)
    want = plain_blend_bwd(fr["feat"], b.gauss_id, b.starts, b.ends,
                           fr["bg"], W, H, fr["grad"])
    for x, y in zip(got, want):
        assert torch.equal(x, y)


def test_bench_frame_on_cpu():
    """The entry point's frame at a small size: bins within budget, the
    walk within each tile's list, g = ones, and every variant's checksum
    finite."""
    fr = micro_bwd.frame("cpu", n=300, width=64, height=48, seed=1)
    assert not bool(fr["bins"].overflowed)
    assert bool((fr["grad"] == 1.0).all()) and float(fr["bg"].abs().sum()) \
        == 0.0
    res = micro_bwd.measure(fr)
    assert res["device"] == "cpu" and res["instances"] > 0
    assert set(res["variants"]) == set(micro_bwd.TIMED) - {"fwd_bwd"}
    for v in res["variants"].values():
        assert np.isfinite(v["checksum"]) and "ms" not in v


def test_micro_bwd_cpu_entry_point(tmp_path, capsys):
    """--device cpu runs the plain variants on the frame at SMOKE's size,
    from --seed."""
    out = tmp_path / "out.json"
    micro_bwd.main(["--device", "cpu", "--seed", "3", "--out", str(out)])
    res = json.loads(out.read_text())
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) \
        == res
    assert (res["gaussians"], res["width"], res["height"]) == (
        micro_bwd.SMOKE["n"], micro_bwd.SMOKE["width"],
        micro_bwd.SMOKE["height"])
    want = micro_bwd.measure(micro_bwd.frame("cpu", seed=3,
                                             **micro_bwd.SMOKE))
    assert res == json.loads(json.dumps(want))
    assert res != micro_bwd.measure(micro_bwd.frame("cpu", seed=4,
                                                    **micro_bwd.SMOKE))


def test_skeleton_launcher_refuses_cpu_tensors():
    fr = _small_frame()
    b = fr["bins"]
    before = dict(cuda_blend.SKELETON_LAUNCHES)
    with pytest.raises(ValueError, match="S3 runs on CUDA"):
        cuda_blend.blend_bwd_skeleton(
            "skeleton", fr["feat"], b.gauss_id, b.starts, b.ends, fr["bg"],
            W, H, fr["grad"], fr["log_t"], fr["n_walked"])
    with pytest.raises(ValueError, match="unknown skeleton mode"):
        cuda_blend.blend_bwd_skeleton(
            "full", fr["feat"], b.gauss_id, b.starts, b.ends, fr["bg"],
            W, H, fr["grad"], fr["log_t"], fr["n_walked"])
    assert cuda_blend.SKELETON_LAUNCHES == before


# ---- on the card

@pytest.mark.cuda
@pytest.mark.parametrize("mode", vpu_peak.MODES)
def test_vpu_peak_kernel_matches_plain_on_card(cuda_device, mode):
    x = vpu_peak.start_block(cuda_device)
    before = vpu_peak.LAUNCHES
    got = vpu_peak.run(x, mode, 4, vpu_peak.INNER, 2)
    want = vpu_peak.plain_call(
        vpu_peak.plain_call(x, mode, 4, vpu_peak.INNER), mode, 4,
        vpu_peak.INNER)
    assert vpu_peak.LAUNCHES == before + 2
    torch.testing.assert_close(got, want, rtol=1e-5,
                               atol=1e-5 * float(want.abs().max()))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("op", micro_bf16.OPS)
def test_micro_bf16_kernel_matches_plain_on_card(cuda_device, op, dtype):
    c = torch.tensor([[micro_bf16.C_VALUE]], device=cuda_device)
    x = torch.linspace(-2.0, 3.0, 1024 * 128, device=cuda_device).reshape(
        1024, 128).to(micro_bf16.DTYPES[dtype])
    got = micro_bf16.block(c, x, op, 64, 2).float()
    want = x
    for _ in range(2):
        want = micro_bf16.plain_passes(c, want, op, 64)
    want = want.float()
    if dtype == "float32":
        torch.testing.assert_close(got, want, rtol=1e-6, atol=0.0)
    else:
        ulp = torch.as_tensor(_bf16_ulp(np_of(want)), device=cuda_device)
        assert bool(((got - want).abs() <= ulp).all())


# the check sizes of chip_smoke.py's phase 3d: S2 at grid 16 and its REPS
# chained calls, S1 at 256 passes and 2 calls; a ragged count that fills
# neither the designs' threads nor their blocks
S2_CHECK_GRID, S1_CHECK_R, S1_CHECK_K = 16, 256, 2


@pytest.mark.cuda
@pytest.mark.parametrize("n", [vpu_peak.P * vpu_peak.CHUNK, 1000])
@pytest.mark.parametrize("probe", [False, True])
def test_serial_designs_match_plain_on_card(cuda_device, probe, n):
    """S2 serial at the design's elements a thread (vpu_call) and at one
    (chain_call) against plain_call."""
    x = torch.linspace(0.0, 1.0, n, device=cuda_device)
    got = want = x
    for _ in range(vpu_peak.REPS):
        got = vpu_peak.chain_call(got, S2_CHECK_GRID) if probe \
            else vpu_peak.vpu_call(got, "serial", S2_CHECK_GRID)
        want = vpu_peak.plain_call(want, "serial", S2_CHECK_GRID)
    torch.testing.assert_close(got, want, rtol=1e-5,
                               atol=1e-5 * float(want.abs().max()))


@pytest.mark.cuda
@pytest.mark.parametrize("n", [micro_bf16.P * micro_bf16.C, 2 * 1001])
def test_madd_bf16_design_matches_plain_on_card(cuda_device, n):
    """S1 bfloat16 madd (one bf16x2 pair a thread) against plain_passes,
    within one bf16 ulp."""
    c = torch.tensor([[micro_bf16.C_VALUE]], device=cuda_device)
    x = torch.linspace(-2.0, 3.0, n, device=cuda_device).to(torch.bfloat16)
    got = want = x
    for _ in range(S1_CHECK_K):
        got = micro_bf16.passes(c, got, "madd", S1_CHECK_R)
        want = micro_bf16.plain_passes(c, want, "madd", S1_CHECK_R)
    got, want = got.float(), want.float()
    assert float((want - x.float()).abs().max()) > 1e-3
    ulp = torch.as_tensor(_bf16_ulp(np_of(want)), device=cuda_device)
    assert bool(((got - want).abs() <= ulp).all())


@pytest.mark.cuda
def test_skeleton_runs_at_k2_residency_on_card(cuda_device):
    k2 = cuda_blend.blocks_per_sm()["K2"]
    residency = cuda_blend.skeleton_residency()
    assert set(residency) == set(cuda_blend.SKELETON_MODES)
    for mode, r in residency.items():
        assert r["blocks_per_sm"] == k2, mode
        assert r["pad_bytes"] >= 0


@pytest.mark.cuda
@pytest.mark.parametrize("mode", cuda_blend.SKELETON_MODES)
def test_skeleton_kernel_matches_plain_on_card(cuda_device, mode):
    fr = _small_frame()
    card = {k: (v.to(cuda_device) if isinstance(v, torch.Tensor) else v)
            for k, v in fr.items()}
    card["bins"] = type(fr["bins"])(*(v.to(cuda_device)
                                      for v in fr["bins"]))
    before = cuda_blend.SKELETON_LAUNCHES[mode]
    got, got_bg = micro_bwd.variant(mode, card)
    want, want_bg = micro_bwd.variant(mode, fr)
    torch.cuda.synchronize()
    assert cuda_blend.SKELETON_LAUNCHES[mode] == before + 1
    want = np_of(want)
    np.testing.assert_allclose(np_of(got), want, rtol=1e-5,
                               atol=1e-5 * np.abs(want).max())
    np.testing.assert_allclose(np_of(got_bg), np_of(want_bg), rtol=1e-5)
