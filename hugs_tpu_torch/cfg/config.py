"""Configuration: a nested attribute dict, YAML files, dotted overrides
and grid expansion.

A copy of the JAX package's configuration system (itself a replacement
for the reference's OmegaConf use: hugs/cfg/config.py:9-155 for the
default tree, hugs/utils/config.py:12-60 for flatten / unflatten and the
cartesian grid over list-valued leaves, main.py:92-108 for the merge
order defaults <- YAML file <- command-line dotlist), with the same keys
and defaults, so every cfg_files/**/*.yaml loads unchanged.

What the port reads differently, by decision:
  - `tpu.render_backend` and `tpu.tile_cap` are read and ignored. The
    port renders through K1 and K2 (render/cuda_blend.py) on the card and
    their plain versions on the CPU; neither truncates a tile, so there is
    no backend to choose and no cap to set.
  - `check_supported` refuses what the port does not run yet:
    `tpu.gauss_shard` > 0 (the Gaussian-sharded renderer, ROADMAP Slice
    G item 3). `train.batch_size` > 1 and `train.anim_batch_size` > 1
    run through hugs_tpu_torch/parallel.
"""
from __future__ import annotations

import copy
import itertools
from typing import Any

import yaml


class Config(dict):
    """dict with attribute access, recursive over nested dicts."""

    def __init__(self, d: dict | None = None):
        super().__init__()
        for k, v in (d or {}).items():
            self[k] = Config(v) if isinstance(v, dict) else v

    def __getattr__(self, k):
        try:
            return self[k]
        except KeyError as e:
            raise AttributeError(k) from e

    def __setattr__(self, k, v):
        self[k] = Config(v) if isinstance(v, dict) and not isinstance(v, Config) else v

    def __deepcopy__(self, memo):
        return Config({k: copy.deepcopy(v, memo) for k, v in self.items()})

    def merge(self, other: dict) -> "Config":
        """Recursive in-place merge; `other` wins."""
        for k, v in other.items():
            if isinstance(v, dict) and isinstance(self.get(k), dict):
                self[k].merge(v)
            else:
                self[k] = Config(v) if isinstance(v, dict) else v
        return self

    def to_dict(self) -> dict:
        return {k: v.to_dict() if isinstance(v, Config) else v
                for k, v in self.items()}

    def to_yaml(self) -> str:
        return yaml.safe_dump(self.to_dict(), sort_keys=False)


def flatten(d: dict, prefix: str = "") -> dict:
    out = {}
    for k, v in d.items():
        kk = f"{prefix}.{k}" if prefix else k
        if isinstance(v, dict):
            out.update(flatten(v, kk))
        else:
            out[kk] = v
    return out


def unflatten(flat: dict) -> Config:
    cfg = Config()
    for k, v in flat.items():
        parts = k.split(".")
        cur = cfg
        for p in parts[:-1]:
            if p not in cur or not isinstance(cur[p], dict):
                cur[p] = Config()
            cur = cur[p]
        cur[parts[-1]] = v
    return cfg


def set_dotted(cfg: Config, key: str, value: Any):
    parts = key.split(".")
    cur = cfg
    for p in parts[:-1]:
        if p not in cur:
            cur[p] = Config()
        cur = cur[p]
    cur[parts[-1]] = value


def parse_value(s: str) -> Any:
    """Parse a CLI override value with YAML semantics (1 -> int, etc.)."""
    try:
        return yaml.safe_load(s)
    except yaml.YAMLError:
        return s


def default_config() -> Config:
    """The default tree (the reference's hugs/cfg/config.py defaults).
    The `tpu.*` keys are the JAX package's: capacities and the instance
    budget, which the port reads too, and the backend and sharding keys,
    which it ignores or refuses (module docstring)."""
    return Config({
        "seed": 0,
        "mode": "human",              # 'human' | 'scene' | 'human_scene'
        "output_path": "output",
        "cfg_file": "",
        "exp_name": "test",
        "dataset_path": "",
        "detect_anomaly": False,
        "debug": False,
        "wandb": False,
        "logdir": "",
        "logdir_ckpt": "",
        "eval": False,
        "bg_color": "white",
        "dataset": {"name": "neuman", "seq": "citron"},
        "train": {
            "batch_size": 1, "num_workers": 0, "num_steps": 30_000,
            "save_ckpt_interval": 4000, "val_interval": 2000,
            "anim_interval": 4000, "anim_batch_size": 1,
            "optim_scene": True,
            "save_progress_images": False, "progress_save_interval": 10,
        },
        "human": {
            "name": "hugs_trimlp", "ckpt": None, "sh_degree": 3,
            "n_subdivision": 0, "only_rgb": False, "use_surface": False,
            "use_deformer": False, "init_2d": False,
            "disable_posedirs": False, "res_offset": False,
            "rotate_sh": False, "isotropic": False,
            "init_scale_multiplier": 1.0, "run_init": False,
            "estimate_delta": True, "triplane_res": 256,
            "optim_pose": False, "optim_betas": False, "optim_trans": False,
            "optim_eps_offsets": False, "activation": "relu",
            "canon_nframes": 60, "canon_pose_type": "da_pose",
            "knn_n_hops": 3,
            "lr": {
                "wd": 0.0, "position": 0.00016, "position_init": 0.00016,
                "position_final": 0.0000016, "position_delay_mult": 0.01,
                "position_max_steps": 30_000, "opacity": 0.05,
                "scaling": 0.005, "rotation": 0.001, "feature": 0.0025,
                "smpl_spatial": 2.0, "smpl_pose": 0.0001,
                "smpl_betas": 0.0001, "smpl_trans": 0.0001,
                "smpl_eps_offset": 0.0001, "lbs_weights": 0.0,
                "posedirs": 0.0, "percent_dense": 0.01,
                "appearance": 1e-3, "geometry": 1e-3, "vembed": 1e-3,
                "deformation": 1e-4, "scale_lr_w_npoints": False,
            },
            "loss": {
                "ssim_w": 0.2, "l1_w": 0.8, "lpips_w": 1.0, "lbs_w": 0.0,
                "humansep_w": 0.0, "num_patches": 4, "patch_size": 128,
                "use_patches": 1,
            },
            "densification_interval": 100, "opacity_reset_interval": 3000,
            "densify_from_iter": 500, "densify_until_iter": 15_000,
            "densify_grad_threshold": 0.0002, "prune_min_opacity": 0.005,
            "densify_extent": 2.0, "max_n_gaussians": 200_000,
        },
        "scene": {
            "name": "scene_gs", "ckpt": None, "sh_degree": 3,
            "add_bg_points": False, "num_bg_points": 204_800,
            "bg_sphere_dist": 5.0, "clean_pcd": False, "opt_start_iter": -1,
            "lr": {
                "percent_dense": 0.01, "spatial_scale": 1.0,
                "position_init": 0.00016, "position_final": 0.0000016,
                "position_delay_mult": 0.01, "position_max_steps": 30_000,
                "opacity": 0.05, "scaling": 0.005, "rotation": 0.001,
                "feature": 0.0025,
            },
            "percent_dense": 0.01, "densification_interval": 100,
            "opacity_reset_interval": 3000, "densify_from_iter": 500,
            "densify_until_iter": 15_000, "densify_grad_threshold": 0.0002,
            "prune_min_opacity": 0.005, "max_n_gaussians": 2_000_000,
            "loss": {"ssim_w": 0.2, "l1_w": 0.8},
        },
        # the JAX package's own keys, kept so that its files load
        "tpu": {
            "render_backend": "tiled",      # read and ignored
            "scene_capacity": 0,            # 0 => scene.max_n_gaussians
            "human_capacity": 0,            # 0 => human.max_n_gaussians
            "instance_budget": 0,           # 0 => auto, grown on demand
            "tile_cap": 1024,               # read and ignored
            "mesh_shape": [1],
            "gauss_shard": 0,               # n > 0: Gaussian-sharded over n
            "gauss_frag_cap": 0,
            "lpips_weights": "",            # path to converted LPIPS .npz
            "smpl_vpb": 32,                 # synthetic SMPL's verts per
            #   bone where no data/smpl exists
        },
    })


def check_supported(cfg: Config) -> None:
    """Raises ValueError for a setting hugs_tpu cannot run either: a
    negative tpu.gauss_shard or tpu.gauss_frag_cap."""
    for key in ("gauss_shard", "gauss_frag_cap"):
        if int(cfg.tpu.get(key, 0) or 0) < 0:
            raise ValueError(f"tpu.{key} must be 0 or more, not "
                             f"{cfg.tpu[key]}")


def load_config(path: str | None = None,
                overrides: list[str] | None = None) -> Config:
    cfg = default_config()
    if path:
        with open(path) as f:
            cfg.merge(yaml.safe_load(f) or {})
        cfg.cfg_file = path
    for ov in overrides or []:
        k, _, v = ov.partition("=")
        set_dotted(cfg, k, parse_value(v))
    return cfg


def get_cfg_items(cfg: Config) -> list[Config]:
    """Cartesian grid expansion: any list-valued leaf becomes a search
    axis; exp_name gets '/<key>-<value>' suffixes (reference
    hugs/utils/config.py:37-60)."""
    flat = flatten(cfg.to_dict())
    list_keys = [k for k, v in flat.items() if isinstance(v, list)
                 and not k.startswith("tpu.mesh_shape")]
    if not list_keys:
        return [cfg]
    out = []
    combos = itertools.product(*[flat[k] for k in list_keys])
    for combo in combos:
        f = dict(flat)
        suffix = []
        for k, v in zip(list_keys, combo):
            f[k] = v
            suffix.append(f"{k.split('.')[-1]}-{v}")
        c = unflatten(f)
        c.exp_name = f"{cfg.exp_name}/{'_'.join(suffix)}"
        out.append(c)
    return out
