"""hugs_tpu_torch's avatar modules against hugs_tpu, module by module, on
the same numpy inputs and on JAX parameters carried across by convert.

Tolerances: grid_sample_2d atol 1e-6; the triplane and each decoder atol
1e-5 (float32 matmuls summed in another order); synthetic_smpl, the mesh
helpers, subdivision and the SMPL loader exact (numpy on both sides);
smpl_forward and lbs_extra atol 1e-5; compute_vitruvian atol 1e-4 on the
inverses (LU in another library); canon_forward and human_forward atol
1e-5 on every output key; compact_for_inference exact; cameras atol
1e-6.
"""
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch
import torch.nn.functional as F

from hugs_tpu.data import cameras as jcam
from hugs_tpu.models import human_gs as jh
from hugs_tpu.models import mesh as jmesh
from hugs_tpu.models import nets as jnets
from hugs_tpu.models import smpl as jsmpl
from hugs_tpu.models.subdivide import subdivide_smpl_model as jsubdivide
from hugs_tpu.ops.grid_sample import grid_sample_2d as jgrid_sample
from hugs_tpu.ops.rotations import axis_angle_to_matrix
from hugs_tpu_torch import convert
from hugs_tpu_torch.data import cameras as tcam
from hugs_tpu_torch.models import human_gs as th
from hugs_tpu_torch.models import mesh as tmesh
from hugs_tpu_torch.models import nets as tnets
from hugs_tpu_torch.models import smpl as tsmpl
from hugs_tpu_torch.models.subdivide import subdivide_smpl_model
from hugs_tpu_torch.ops.grid_sample import grid_sample_2d
from hugs_tpu_torch.ops.rotations import rotation_6d_to_matrix
from torch_parity import (
    human_cfg_to_torch, human_to_torch, jax_human, jax_tree, np_of,
    smpl_arrays,
)

ATOL = 1e-5


def _close(got, want, atol=ATOL, err_msg=""):
    np.testing.assert_allclose(np_of(got).astype(np.float64),
                               np.asarray(want, np.float64), atol=atol,
                               rtol=0, err_msg=err_msg)


# ----------------------------------------------------------- grid sample

@pytest.mark.parametrize("where", ["interior", "border", "upper_edge"])
def test_grid_sample_matches_jax(where):
    """atol 1e-6, in the interior, past the border (clamped) and at the
    exact upper edge, where x0 clamps to W-2 and the weight on x1 is 1;
    the upper edge also against F.grid_sample(align_corners=True)."""
    rng = np.random.default_rng(3)
    plane = rng.normal(size=(9, 13, 5)).astype(np.float32)
    if where == "interior":
        coords = rng.uniform(-0.95, 0.95, (200, 2))
    elif where == "border":
        coords = rng.uniform(-1.6, 1.6, (200, 2))
    else:
        coords = np.array([[1.0, 1.0], [1.0, -1.0], [-1.0, 1.0],
                           [1.0, 0.3], [0.3, 1.0], [-1.0, -1.0]])
    coords = coords.astype(np.float32)
    got = grid_sample_2d(torch.as_tensor(plane), torch.as_tensor(coords))
    want = jgrid_sample(jnp.asarray(plane), jnp.asarray(coords))
    _close(got, want, atol=1e-6)
    if where == "upper_edge":
        lib = F.grid_sample(torch.as_tensor(plane).permute(2, 0, 1)[None],
                            torch.as_tensor(coords)[None, None],
                            align_corners=True, padding_mode="border")
        _close(got, np_of(lib[0, :, 0].T), atol=1e-6)


# ---------------------------------------------------------------- nets

def _feats(n, dim, seed):
    return np.random.default_rng(seed).normal(size=(n, dim)).astype(
        np.float32) * 2.0


def test_gelu_is_jax_tanh_form():
    """nets.gelu against jax.nn.gelu's default, atol 1e-6, on [-6, 6]:
    torch's default erf form differs by up to ~5e-4 there and fails."""
    x = np.linspace(-6.0, 6.0, 1201, dtype=np.float32)
    _close(tnets.gelu(torch.as_tensor(x)), jax.nn.gelu(jnp.asarray(x)),
           atol=1e-6)


@pytest.mark.parametrize("name", ["appearance", "geometry", "deformation",
                                  "deformation_posedirs"])
def test_decoder_matches_jax(name):
    """Each decoder on JAX parameters carried across by convert, every
    output atol 1e-5. The blend-shape head is given random weights (it
    is zero-initialised), so its (207, 3N) reshape is exercised."""
    nf, n = 24, 70
    key = jax.random.PRNGKey(5)
    if name == "appearance":
        p = jnets.appearance_decoder_init(key, nf)
        apply_j, apply_t = jnets.appearance_decoder_apply, \
            tnets.appearance_decoder_apply
        cls = tnets.AppearanceDecoder
    elif name == "geometry":
        p = jnets.geometry_decoder_init(key, nf)
        apply_j, apply_t = jnets.geometry_decoder_apply, \
            tnets.geometry_decoder_apply
        cls = tnets.GeometryDecoder
    else:
        p = jnets.deformation_decoder_init(
            key, nf, disable_posedirs=(name == "deformation"))
        if "blendshapes" in p:
            kw, kb = jax.random.split(jax.random.PRNGKey(6))
            p["blendshapes"] = {
                "w": jax.random.normal(kw, (128, 621)) * 0.1,
                "b": jax.random.normal(kb, (621,)) * 0.1}
        apply_j, apply_t = jnets.deformation_decoder_apply, \
            tnets.deformation_decoder_apply
        cls = tnets.DeformationDecoder
    dec = cls(**{k: convert._layer(v, "cpu")
                 for k, v in jax_tree(p).items()})
    x = _feats(n, nf, 7)
    want = apply_j(p, jnp.asarray(x))
    got = apply_t(dec, torch.as_tensor(x))
    assert set(got) == set(want)
    for k, v in want.items():
        if v is None:
            assert got[k] is None, k
            continue
        assert tuple(got[k].shape) == v.shape, k
        _close(got[k], v, err_msg=k)


def test_triplane_and_weight_norm_match_jax():
    """triplane_apply on JAX planes, at points inside and past the
    planes' [-1, 1] box, atol 1e-5; the weight-normalised layer atol
    1e-5, including a zero column (the clamp)."""
    tp = jnets.triplane_init(jax.random.PRNGKey(8), 8, 32)
    x = np.random.default_rng(9).uniform(-1.2, 1.2, (300, 3)).astype(
        np.float32)
    ttp = tnets.TriPlane(*(torch.tensor(np.asarray(tp[k])) for k in
                           ("plane_xy", "plane_xz", "plane_yz")))
    _close(tnets.triplane_apply(ttp, torch.as_tensor(x)),
           jnets.triplane_apply(tp, jnp.asarray(x)))
    wn = jnets.weight_norm_init(jax.random.PRNGKey(10), 16, 12)
    wn["v"] = wn["v"].at[:, 3].set(0.0)
    x = _feats(40, 16, 11)
    _close(tnets.weight_norm_linear(convert._layer(jax_tree(wn), "cpu"),
                                    torch.as_tensor(x)),
           jnets.weight_norm_linear(wn, jnp.asarray(x)))


# -------------------------------------------------- SMPL body and mesh

def test_synthetic_smpl_and_mesh_helpers_exact():
    """synthetic_smpl's fields and the numpy mesh helpers equal the JAX
    package's exactly: both are the same numpy code."""
    js, ts = jsmpl.synthetic_smpl(10, seed=2), tsmpl.synthetic_smpl(
        10, seed=2, device="cpu")
    for f, v in smpl_arrays(js).items():
        got = getattr(ts, f)
        got = got if isinstance(got, (tuple, np.ndarray)) else np_of(got)
        np.testing.assert_array_equal(got, v, err_msg=f)
    verts, faces = np.asarray(js.v_template), js.faces
    np.testing.assert_array_equal(tmesh.unique_edges(faces),
                                  jmesh.unique_edges(faces))
    np.testing.assert_array_equal(tmesh.vertex_normals(verts, faces),
                                  jmesh.vertex_normals(verts, faces))
    attrs = {"w": np.asarray(js.lbs_weights)}
    for a, b in zip(tmesh.subdivide(verts, faces, attrs),
                    jmesh.subdivide(verts, faces, attrs)):
        if isinstance(a, dict):
            a, b = a["w"], b["w"]
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(tmesh.smooth_humphrey(verts, faces),
                                  jmesh.smooth_humphrey(verts, faces))


@pytest.mark.parametrize("smoothing", [False, True])
def test_subdivide_smpl_model_exact(smoothing):
    js = jsmpl.synthetic_smpl(8)
    ts = tsmpl.synthetic_smpl(8, device="cpu")
    jt = jsubdivide(js, smoothing=smoothing, n_iter=2)
    tt = subdivide_smpl_model(ts, smoothing=smoothing, n_iter=2)
    for f, v in smpl_arrays(jt).items():
        got = getattr(tt, f)
        got = got if isinstance(got, (tuple, np.ndarray)) else np_of(got)
        np.testing.assert_array_equal(got, v, err_msg=f)


@pytest.mark.parametrize("fmt", ["pkl", "npz"])
def test_load_smpl_matches_jax(tmp_path, fmt):
    """Both loaders read the same file to the same arrays, exactly: a pkl
    with J_regressor as scipy.sparse under its pre-1.8 module path and a
    uint32 kintree_table (the real file's quirks), and an npz."""
    rng = np.random.RandomState(4)
    V = 40
    kintree = np.stack([np.asarray(jsmpl.SMPL_PARENTS).astype(np.uint32),
                        np.arange(24, dtype=np.uint32)])
    jreg = np.zeros((24, V))
    jreg[np.arange(24), rng.permutation(V)[:24]] = 1.0
    data = {"v_template": rng.randn(V, 3),
            "shapedirs": rng.randn(V, 3, 10) * 0.01,
            "posedirs": rng.randn(V, 3, 207) * 0.001,
            "weights": rng.dirichlet(np.ones(24), V),
            "kintree_table": kintree, "f": rng.randint(0, V, (60, 3))}
    if fmt == "pkl":
        data["J_regressor"] = sp.csc_matrix(jreg)
        blob = pickle.dumps(data, protocol=2).replace(
            b"scipy.sparse._csc", b"scipy.sparse.csc")
        path = tmp_path / "SMPL_NEUTRAL.pkl"
        path.write_bytes(blob)
        where = str(tmp_path)
    else:
        data["J_regressor"] = jreg
        where = str(tmp_path / "body.npz")
        np.savez(where, **data)
    jm = jsmpl.load_smpl(where)
    tm = tsmpl.load_smpl(where, device="cpu")
    for f, v in smpl_arrays(jm).items():
        got = getattr(tm, f)
        got = got if isinstance(got, (tuple, np.ndarray)) else np_of(got)
        np.testing.assert_array_equal(got, v, err_msg=f)


def _pose(seed, scale=0.4):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=69) * scale).astype(np.float32), \
        (rng.normal(size=3) * scale).astype(np.float32), \
        (rng.normal(size=10) * 0.5).astype(np.float32), \
        (rng.normal(size=3) * 0.2).astype(np.float32)


@pytest.mark.parametrize("seed", [0, 1])
def test_smpl_forward_and_lbs_extra_match_jax(seed):
    """smpl_forward (with pose blend-shapes and transl) at a random pose:
    vertices, joints, A, T and the offsets atol 1e-5; lbs_extra with
    random posedirs atol 1e-5."""
    js = jsmpl.synthetic_smpl(12)
    rng = np.random.default_rng(seed + 10)
    js = js.replace(posedirs=jnp.asarray(
        rng.normal(size=js.posedirs.shape).astype(np.float32) * 1e-3))
    ts = convert.smpl_model_from_numpy(smpl_arrays(js), "cpu")
    pose, orient, betas, transl = _pose(seed)
    jo = jsmpl.smpl_forward(js, jnp.asarray(betas), jnp.asarray(pose),
                            jnp.asarray(orient), jnp.asarray(transl))
    to = tsmpl.smpl_forward(ts, torch.as_tensor(betas),
                            torch.as_tensor(pose), torch.as_tensor(orient),
                            torch.as_tensor(transl))
    for f in jo._fields:
        _close(getattr(to, f), getattr(jo, f), err_msg=f)

    n = 50
    pts = rng.normal(size=(n, 3)).astype(np.float32) * 0.5
    w = rng.dirichlet(np.ones(24), n).astype(np.float32)
    pd = (rng.normal(size=(207, 3 * n)) * 1e-2).astype(np.float32)
    for posedirs in (pd, None):
        jd = jsmpl.lbs_extra(jo.A, jnp.asarray(pts), None if posedirs is None
                             else jnp.asarray(posedirs), jnp.asarray(w),
                             jo.full_pose)
        td = tsmpl.lbs_extra(to.A, torch.as_tensor(pts),
                             None if posedirs is None
                             else torch.as_tensor(posedirs),
                             torch.as_tensor(w), to.full_pose)
        for a, b in zip(td, jd):
            _close(a, b)


def test_compute_vitruvian_matches_jax():
    """The port's HumanGSFixed, recomputed from the converted body,
    against the JAX one: inverses atol 1e-4, the rest atol 1e-5."""
    cfg, smpl, params, state, fixed, _ = jax_human(vpb=12, seed=3)
    _, _, _, tfixed = human_to_torch(cfg, smpl, params, state)
    _close(tfixed.vitruvian_verts, fixed.vitruvian_verts)
    _close(tfixed.canonical_offsets, fixed.canonical_offsets)
    _close(tfixed.inv_A_t2vitruvian, fixed.inv_A_t2vitruvian, atol=1e-4)
    _close(tfixed.inv_T_t2vitruvian, fixed.inv_T_t2vitruvian, atol=1e-4)
    np.testing.assert_array_equal(np_of(tsmpl.vitruvian_pose("cpu")),
                                  np.asarray(jsmpl.vitruvian_pose()))


# --------------------------------------------------------- the avatar

def test_human_config_matches_jax():
    """Exact: every field of the port's HumanGSConfig is a JAX field with
    the same default; a JAX config carries over field for field, and one
    that sets a field the port does not define (rotate_sh, the SH degree
    of training) is refused rather than dropped."""
    jdef = jh.HumanGSConfig._field_defaults
    for k, v in th.HumanGSConfig._field_defaults.items():
        assert jdef[k] == v, k
    jcfg = jh.HumanGSConfig(n_features=8, use_deformer=False, isotropic=True)
    assert human_cfg_to_torch(jcfg)._asdict() == {
        k: getattr(jcfg, k) for k in th.HumanGSConfig._fields}
    for bad in (dict(rotate_sh=True), dict(sh_degree=3)):
        with pytest.raises(NotImplementedError):
            human_cfg_to_torch(jh.HumanGSConfig(**bad))


def test_init_human_gs_matches_jax():
    """init_human_gs's deterministic parts (positions, state, distillation
    targets, pose tables) against the JAX package's, on a subdivided
    template: atol 1e-6, edges and alive exact. The Gaussians' initial
    rotations turn +z onto the vertex normals, cross products of ~1 cm
    edges whose ends agree to float32 rounding: the normals (the rotated
    +z) atol 1e-5, and the whole rotation atol 2e-4 where the normal is
    not within 0.05 of -z, where 1 / (1 + n_z) amplifies that rounding.
    The nets come from another generator and are not compared."""
    kw = dict(n_features=8, triplane_res=32, disable_posedirs=False)
    js = jsmpl.synthetic_smpl(8)
    jt = jsubdivide(js, smoothing=True, n_iter=1)
    ts = tsmpl.synthetic_smpl(8, device="cpu")
    tt = subdivide_smpl_model(ts, smoothing=True, n_iter=1)
    betas = np.linspace(-0.5, 0.5, 10).astype(np.float32)
    pose = (np.random.default_rng(0).normal(size=(2, 69)) * 0.3).astype(
        np.float32)
    p, st, _, iv = jh.init_human_gs(
        jax.random.PRNGKey(0), jh.HumanGSConfig(**kw), js, jt,
        jnp.asarray(betas), n_frames=2, capacity=640,
        init_body_pose=jnp.asarray(pose))
    tp, tst, _, tiv = th.init_human_gs(
        torch.Generator().manual_seed(0), th.HumanGSConfig(**kw), ts, tt,
        betas, n_frames=2, capacity=640, init_body_pose=torch.as_tensor(pose))
    for f in ("xyz", "global_orient", "body_pose", "transl", "betas"):
        _close(getattr(tp, f), getattr(p, f), atol=1e-6, err_msg=f)
    for f in st._fields:
        _close(getattr(tst, f), getattr(st, f), atol=0, err_msg=f)
    for k, v in iv.items():
        if k != "rot6d_canon":
            got = tiv[k] if isinstance(tiv[k], np.ndarray) else np_of(tiv[k])
            _close(got, v, atol=1e-6, err_msg=k)
    rot_t = rotation_6d_to_matrix(tiv["rot6d_canon"])
    rot_j = rotation_6d_to_matrix(torch.tensor(np.asarray(
        iv["rot6d_canon"])))
    _close(rot_t[..., 2], np_of(rot_j[..., 2]), err_msg="normals")
    away = np_of(1.0 + rot_j[:, 2, 2]) >= 0.05
    assert away.mean() > 0.9
    _close(rot_t[away], np_of(rot_j[away]), atol=2e-4, err_msg="rotations")
    for name in th.NET_FIELDS:
        assert sum(x.numel() for x in getattr(tp, name).parameters()) == \
            sum(np.asarray(x).size for x in
                jax.tree_util.tree_leaves(getattr(p, name))), name


def test_canon_forward_matches_jax():
    """Every key of the canonical decode, atol 1e-5 (posedirs None with
    disable_posedirs, as in JAX)."""
    cfg, smpl, params, state, _, _ = jax_human(vpb=12, capacity=320, seed=4)
    state = state._replace(scaling_multiplier=jnp.asarray(
        np.random.default_rng(4).uniform(0.5, 2.0, (320, 1)), jnp.float32))
    tcfg, tparams, tstate, _ = human_to_torch(cfg, smpl, params, state)
    want = jh.canon_forward(params, state, cfg)
    got = th.canon_forward(tparams, tstate, tcfg)
    assert set(got) == set(want)
    for k, v in want.items():
        if v is None:
            assert got[k] is None, k
        else:
            _close(got[k], v, err_msg=k)


def _random_pose_tables(params, seed):
    rng = np.random.default_rng(seed)
    F = params.global_orient.shape[0]
    return params._replace(
        global_orient=params.global_orient + jnp.asarray(
            rng.normal(size=(F, 6)) * 0.3, jnp.float32),
        body_pose=params.body_pose + jnp.asarray(
            rng.normal(size=(F, 138)) * 0.2, jnp.float32),
        transl=jnp.asarray(rng.normal(size=(F, 3)) * 0.1, jnp.float32))


CASES = {
    "deformer": dict(cfg=dict(use_deformer=True), call="explicit"),
    "deformer_posedirs": dict(cfg=dict(use_deformer=True,
                                       disable_posedirs=False),
                              call="explicit"),
    "deformer_cached": dict(cfg=dict(use_deformer=True), call="cached"),
    "knn_transfer": dict(cfg=dict(use_deformer=False), call="explicit"),
    "learned_pose_ext_tfs": dict(cfg=dict(use_deformer=True),
                                 call="learned"),
    "knn_learned_pose_cached": dict(cfg=dict(use_deformer=False),
                                    call="learned_cached"),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_human_forward_matches_jax(case):
    """human_forward on both skinning paths, with an explicit pose and
    smpl_scale, with the learned per-frame pose and ext_tfs, with and
    without a cached canonical decode: every output key atol 1e-5
    (gt_lbs_weights, the kNN transfer, included)."""
    spec = CASES[case]
    cfg, smpl, params, state, fixed, _ = jax_human(
        vpb=12, capacity=320, n_frames=3, seed=5, **spec["cfg"])
    params = _random_pose_tables(params, 6)
    if "posedirs" in case:
        dd = dict(params.deformation_dec)
        dd["blendshapes"] = {
            "w": jnp.asarray(np.random.default_rng(7).normal(
                size=(128, 621)) * 0.01, jnp.float32),
            "b": jnp.zeros(621)}
        params = params._replace(deformation_dec=dd)
    tcfg, tparams, tstate, tfixed = human_to_torch(cfg, smpl, params, state)
    pose, orient, betas, transl = _pose(8, scale=0.3)
    call = spec["call"]
    if call.startswith("learned"):
        rot = np.asarray(axis_angle_to_matrix(jnp.array([0.1, 0.5, -0.2])))
        jkw = dict(dataset_idx=2, ext_tfs=(jnp.array([0.3, -0.1, 2.0]),
                                           jnp.asarray(rot),
                                           jnp.float32(1.3)))
        tkw = dict(dataset_idx=2, ext_tfs=(torch.tensor([0.3, -0.1, 2.0]),
                                           torch.as_tensor(rot),
                                           torch.tensor(1.3)))
    else:
        jkw = dict(global_orient=jnp.asarray(orient),
                   body_pose=jnp.asarray(pose), betas=jnp.asarray(betas),
                   transl=jnp.asarray(transl), smpl_scale=jnp.float32(1.2))
        tkw = dict(global_orient=torch.as_tensor(orient),
                   body_pose=torch.as_tensor(pose),
                   betas=torch.as_tensor(betas),
                   transl=torch.as_tensor(transl),
                   smpl_scale=torch.tensor(1.2))
    if call.endswith("cached"):
        jkw["canon_out"] = jh.canon_forward(params, state, cfg)
        tkw["canon_out"] = th.canon_forward(tparams, tstate, tcfg)
    want = jh.human_forward(params, state, fixed, cfg, **jkw)
    got = th.human_forward(tparams, tstate, tfixed, tcfg, **tkw)
    assert set(got) == set(want)
    for k, v in want.items():
        if v is None:
            assert got[k] is None, k
        else:
            _close(got[k], v, err_msg=k)
    if cfg.use_deformer:
        assert got["gt_lbs_weights"] is not None


def test_knn_lbs_transfer_matches_jax():
    """smpl_lbsweight_top_k and smpl_lbsmap_top_k (K = 6), atol 1e-5,
    and their gradients in the points (through the kNN distances, the
    branch of use_deformer=false), atol 1e-6."""
    js = jsmpl.synthetic_smpl(12)
    ts = convert.smpl_model_from_numpy(smpl_arrays(js), "cpu")
    pts = np.asarray(js.v_template)[::3] + np.random.default_rng(2).normal(
        size=(96, 3)).astype(np.float32) * 0.02
    tf = np.random.default_rng(3).normal(size=(js.n_verts, 4, 4)).astype(
        np.float32)
    for jf, tfn, args in (
            (jh.smpl_lbsweight_top_k, th.smpl_lbsweight_top_k, ()),
            (jh.smpl_lbsmap_top_k, th.smpl_lbsmap_top_k, (tf,))):
        want = jf(js.lbs_weights, *(jnp.asarray(a) for a in args),
                  jnp.asarray(pts), js.v_template)
        tpts = torch.as_tensor(pts).requires_grad_()
        got = tfn(ts.lbs_weights, *(torch.as_tensor(a) for a in args),
                  tpts, ts.v_template)
        for a, b in zip(got, want):
            _close(a.detach(), b)

        def jloss(p, jf=jf, args=args):
            dist, out = jf(js.lbs_weights, *(jnp.asarray(a) for a in args),
                           p, js.v_template)
            return jnp.sum(dist) + jnp.sum(jnp.sin(out))
        jgrad = jax.grad(jloss)(jnp.asarray(pts))
        (torch.sum(got[0]) + torch.sum(torch.sin(got[1]))).backward()
        _close(tpts.grad, jgrad, atol=1e-6)


def test_compact_for_inference_matches_jax():
    """compact_for_inference's rows, state and cached decode (posedirs in
    the (207, 3N) layout) equal the JAX package's exactly, at the default
    bucket and at a given one."""
    cfg, smpl, params, state, _, _ = jax_human(
        vpb=12, capacity=448, seed=9, disable_posedirs=False)
    rng = np.random.default_rng(9)
    alive = np.asarray(state.alive) & (rng.uniform(size=448) > 0.3)
    state = state._replace(
        alive=jnp.asarray(alive),
        max_radii2d=jnp.asarray(rng.uniform(size=448), jnp.float32),
        denom=jnp.asarray(rng.integers(0, 5, 448), jnp.float32))
    tcfg, tparams, tstate, _ = human_to_torch(cfg, smpl, params, state)
    jcanon = jh.canon_forward(params, state, cfg)
    # the same decode on both sides, so compaction alone is compared
    tcanon = {k: None if v is None else torch.as_tensor(np.asarray(v))
              for k, v in jcanon.items()}
    for bucket in (None, 256):
        jp, js_, jc = jh.compact_for_inference(params, state, jcanon, bucket)
        tp, ts_, tc = th.compact_for_inference(tparams, tstate, tcanon,
                                               bucket)
        np.testing.assert_array_equal(np_of(tp.xyz), np.asarray(jp.xyz))
        for f in js_._fields:
            np.testing.assert_array_equal(np_of(getattr(ts_, f)),
                                          np.asarray(getattr(js_, f)),
                                          err_msg=f)
        for k, v in jc.items():
            if v is None:
                assert tc[k] is None, k
            else:
                np.testing.assert_array_equal(np_of(tc[k]), np.asarray(v),
                                              err_msg=k)
        assert tp.triplane is tparams.triplane


# -------------------------------------------------------------- cameras

def test_cameras_match_jax():
    """get_rotating_camera (every Camera field, atol 1e-6, non-square),
    get_static_camera, the predefined poses and the canonical turntable
    parameters (atol 1e-6)."""
    jr = jcam.get_rotating_camera(img_size=(48, 64), fov=0.95, dist=3.0,
                                  nframes=5)
    tr = tcam.get_rotating_camera(img_size=(48, 64), fov=0.95, dist=3.0,
                                  nframes=5, device="cpu")
    js, ts = jcam.get_static_camera(32, 0.5), tcam.get_static_camera(
        32, 0.5, device="cpu")
    for a, b in list(zip(tr, jr)) + [(ts, js)]:
        for k in ("width", "height", "fovx", "fovy", "near", "far"):
            assert a[k] == b[k], k
        for f in b["camera"]._fields:
            _close(getattr(a["camera"], f), getattr(b["camera"], f),
                   atol=1e-6, err_msg=f)
    for pose_type in ("da_pose", "a_pose", "t_pose"):
        np.testing.assert_array_equal(
            np_of(tcam.get_predefined_pose(pose_type, "cpu")),
            np.asarray(jcam.get_predefined_pose(pose_type)))
    betas = np.linspace(0.0, 1.0, 10).astype(np.float32)
    for jfn, tfn in ((jcam.get_smpl_static_params,
                      tcam.get_smpl_static_params),
                     (jcam.get_smpl_canon_params,
                      tcam.get_smpl_canon_params)):
        want = jfn(betas)
        got = tfn(betas, device="cpu")
        assert set(got) == set(want)
        for k, v in want.items():
            _close(got[k], v, atol=1e-6, err_msg=k)
