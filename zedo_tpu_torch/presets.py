"""The shipped configurations, and config files read without ml_collections.

`configs/optim/*.py` build ml_collections configs. `load_config(path)` runs
any such file, as the JAX package's CLIs and serving do, with a stand-in
`ml_collections` whose ConfigDict is `Config`, so the port never imports
ml_collections. `optim_config(name)` restates, as a plain nested `Config`,
the keys of configs/optim/concat_pose_optimization_<name>.py (through
configs/optim/_base.py and configs/default_pose_gen_configs.py, and for the
infant sets configs/default_mini_configs.py) that the CLIs,
`make_mlp_config`, `build_sde`, `get_sampling_fn`, `ZeDOConfig.from_config`,
the trainer and `run.sample` read; a test holds every preset against its
file, key by key. `model.hidden_dim` / `embed_dim` / `n_blocks` are the
published 1024 / 512 / 2, which the files leave to the CLI's constants, so
that an override can point a CLI at a checkpoint of another width. Of the
infant deltas of default_mini_configs.py the DATASET block and the batch
sizes are restated.

`h36m()` is the serving configuration built from `optim_config("h36m")`.
"""
from __future__ import annotations

import contextlib
import copy
import dataclasses
import importlib.util
import os
import sys
import types

from zedo_tpu_torch.diffusion.sampling import PCSampler, get_sampling_fn
from zedo_tpu_torch.diffusion.sde import SDE, build_sde
from zedo_tpu_torch.models.registry import make_mlp_config
from zedo_tpu_torch.models.score_mlp import ScoreMLPConfig
from zedo_tpu_torch.zeroshot.pipeline import ZeDOConfig


class Config(dict):
    """A nested dict read by key or by attribute: the part of
    ml_collections.ConfigDict that the config files, the entry points and
    `apply_overrides` use. Values of `initial` and `kwargs` that have
    `.items()` become Configs, recursively."""

    def __init__(self, initial=(), /, **kwargs):
        super().__init__()
        for key, value in dict(initial, **kwargs).items():
            self[key] = Config(value) if hasattr(value, "items") else value

    @contextlib.contextmanager
    def unlocked(self):
        """A no-op: a Config is never locked."""
        yield self

    def lock(self):
        """A no-op: a Config is never locked."""
        return self

    def __getattr__(self, name):
        try:
            return self[name]
        except KeyError:
            raise AttributeError(name) from None

    def __setattr__(self, name, value):
        self[name] = value


_ALL_17 = list(range(17))

# the per-dataset ZeDO blocks of configs/optim/concat_pose_optimization_*.py
_ZEDO = {
    "h36m": dict(IPO_keylist=[0, 1, 4], RotAxes="z", IPO_T=3, IPO_minScaleT=0.5,
                 IPO_maxScaleT=2, sample=640, batch=886),
    "3dhp": dict(IPO_keylist=[0, 1, 4], RotAxes="z", IPO_T=3, IPO_minScaleT=0.5,
                 IPO_maxScaleT=2, sample=3, batch=959),
    "3dpw": dict(IPO_keylist=_ALL_17, RotAxes="z", IPO_T=8, IPO_minScaleT=0.2,
                 IPO_maxScaleT=2, sample=35, batch=1015),
    "ski": dict(IPO_keylist=_ALL_17, RotAxes="y", IPO_T=20, IPO_minScaleT=0.5,
                IPO_maxScaleT=2, sample=1, batch=1716),
    "wild": dict(IPO_keylist=[0, 1, 4], RotAxes="z", IPO_T=3, IPO_minScaleT=0.5,
                 IPO_maxScaleT=2, sample=640, batch=886),
    "mini": dict(IPO_keylist=_ALL_17, RotAxes="xyz", IPO_T=1, IPO_minScaleT=0,
                 IPO_maxScaleT=4, sample=640, batch=886),
    "syrip": dict(IPO_keylist=list(range(12)), RotAxes="xyz", IPO_T=1, IPO_minScaleT=0.5,
                  IPO_maxScaleT=8, sample=640, batch=886),
}
OPTIM_PRESETS = tuple(_ZEDO)
# ZeDO-i's sets (configs/default_mini_configs.py) and their joints
_INFANT_JOINTS = {"mini": 17, "syrip": 12}


def optim_config(name: str) -> Config:
    """The configuration of configs/optim/concat_pose_optimization_<name>.py
    (`name` is the dataset: h36m, 3dhp, 3dpw, ski, wild, mini or syrip), a
    fresh copy."""
    if name not in _ZEDO:
        raise KeyError(f"no preset {name!r}; the presets are {', '.join(OPTIM_PRESETS)}")
    if name in _INFANT_JOINTS:
        dataset = {"TRAIN_DATASET": "concate", "TEST_DATASET": "concate",
                   "NUM_JOINT": _INFANT_JOINTS[name]}
        train_batch, eval_batch = 5000, 1024
    else:
        dataset = {"TRAIN_DATASET": "h36m", "TEST_DATASET": "h36m", "NUM_JOINT": 17}
        train_batch, eval_batch = 50000, 10000
    return Config({
        "OUTPUT_DIR": "./output",
        "seed": 42,
        "DATASET": dataset,
        "data": {"dataset": name},
        "training": {"sde": "subvpsde", "continuous": True, "batch_size": train_batch,
                     "snapshot_freq_for_preemption": 10000, "likelihood_weighting": False,
                     "reduce_mean": True, "data_scale": 1, "cond_pose_mask_prob": 0.0,
                     "cond_part_mask_prob": 0.0, "cond_joint_mask_prob": 0.0},
        "sampling": {"method": "pc", "predictor": "euler_maruyama", "corrector": "none",
                     "snr": 0.16, "n_steps_each": 1, "probability_flow": False,
                     "noise_removal": True},
        "eval": {"batch_size": eval_batch},
        "optim": {"weight_decay": 0, "optimizer": "Adam", "lr": 2e-4, "beta1": 0.9,
                  "eps": 1e-8, "warmup": 5000, "grad_clip": 1.0},
        "model": {"name": "ncsnpp", "sigma_min": 0.01, "sigma_max": 50, "num_scales": 1000,
                  "beta_min": 0.1, "beta_max": 20.0, "dropout": 0.1,
                  "embedding_type": "positional", "fourier_scale": 16,
                  "scale_by_sigma": False, "t": 0.1, "ema_rate": 0.9999,
                  "hidden_dim": 1024, "embed_dim": 512, "n_blocks": 2},
        "ZeDO": {"IPO_iterations": 500, "OIL_iterations": 1000, "sampling_eps": 0.01,
                 "score_reuse": 1, "gn_fp32": False, "use_pallas": None,
                 "pallas_interpret": False, **copy.deepcopy(_ZEDO[name])},
    })


# the presets run.opt_main, run.inference and the serving estimator take
EVAL_PRESETS = ("h36m", "3dhp", "3dpw", "ski", "wild")
_STAND_IN = ("configs", "ml_collections")


def read_config_file(path: str) -> Config:
    """Run the config file at `path` and return its get_config() as a
    Config, as the JAX package's CLIs and serving read it. While the file
    runs, `ml_collections` is a stand-in whose ConfigDict is Config; the
    `configs` and `ml_collections` modules loaded before are set aside and
    put back after, those the run loaded are dropped, and sys.path is
    restored (the stock files put the repository's root on it)."""
    if not os.path.isfile(path):
        raise FileNotFoundError(f"config file {path!r} not found")
    mine = [name for name in sys.modules if name.split(".")[0] in _STAND_IN]
    stash = {name: sys.modules.pop(name) for name in mine}
    path_before = list(sys.path)
    stand_in = types.ModuleType("ml_collections")
    stand_in.ConfigDict = Config
    sys.modules["ml_collections"] = stand_in
    try:
        spec = importlib.util.spec_from_file_location("zedo_tpu_torch_config_file", path)
        module = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(module)
        config = module.get_config()
    finally:
        for name in [name for name in sys.modules if name.split(".")[0] in _STAND_IN]:
            del sys.modules[name]
        sys.modules.update(stash)
        sys.path[:] = path_before
    return Config(config)


def load_config(arg: str, names: tuple = EVAL_PRESETS) -> Config:
    """The configuration a CLI's --config names: the path of any config
    file (.py), read as JAX's CLIs read it, or a preset by name; `names`
    are the presets the caller takes."""
    if arg.endswith(".py"):
        return read_config_file(arg)
    if arg in names:
        return optim_config(arg)
    raise ValueError(f"--config {arg!r}: give a preset ({', '.join(names)}) or the path of "
                     "a config file (.py)")


@dataclasses.dataclass(frozen=True)
class Preset:
    model_cfg: ScoreMLPConfig
    sde: SDE
    sampler: PCSampler
    zcfg: ZeDOConfig


def from_optim_config(config) -> Preset:
    """The solver's configuration as the CLIs build it from `config` (the
    probability flow forced on, as the reference's CLIs do), for
    config.DATASET.NUM_JOINT joints."""
    m = config.model
    sde = build_sde(config.training.sde, beta_min=m.beta_min, beta_max=m.beta_max,
                    sigma_min=m.sigma_min, sigma_max=m.sigma_max, n=m.num_scales, t_max=m.t)
    config.sampling.probability_flow = True
    n_joints = config.DATASET.NUM_JOINT
    sampler = get_sampling_fn(config, sde, (config.ZeDO.batch, n_joints, 3), lambda x: x,
                              config.ZeDO.sampling_eps)
    return Preset(model_cfg=make_mlp_config(config, n_joints=n_joints), sde=sde,
                  sampler=sampler,
                  zcfg=ZeDOConfig.from_config(config))


def h36m(**model_dims) -> Preset:
    """The H36M serving configuration. `model_dims` overrides the widths
    (hidden_dim, embed_dim, n_blocks) for checkpoints of another size; the
    published model is the default 1024/512/2."""
    unknown = set(model_dims) - {"hidden_dim", "embed_dim", "n_blocks"}
    if unknown:
        raise TypeError(f"h36m() takes hidden_dim, embed_dim and n_blocks, not {sorted(unknown)}")
    config = optim_config("h36m")
    config.model.update(model_dims)
    return from_optim_config(config)
