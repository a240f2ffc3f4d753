"""The shipped configurations, without ml_collections.

`configs/optim/*.py` build ml_collections configs, which the port does not
depend on. `optim_config(name)` restates, as a plain nested `Config`, the
keys of configs/optim/concat_pose_optimization_<name>.py (through
configs/optim/_base.py and configs/default_pose_gen_configs.py, and for the
infant sets configs/default_mini_configs.py) that the CLIs,
`make_mlp_config`, `build_sde`, `get_sampling_fn` and
`ZeDOConfig.from_config` read; a test holds every preset against its file,
key by key. `model.hidden_dim` / `embed_dim` / `n_blocks` are the published
1024 / 512 / 2, which the files leave to the CLI's constants, so that an
override can point a CLI at a checkpoint of another width. Of the infant
deltas of default_mini_configs.py the DATASET block is restated; the
trainer's batch sizes and flip flag wait for the training port.

`h36m()` is the serving configuration built from `optim_config("h36m")`.
"""
from __future__ import annotations

import copy
import dataclasses

from zedo_tpu_torch.diffusion.sampling import PCSampler, get_sampling_fn
from zedo_tpu_torch.diffusion.sde import SDE, build_sde
from zedo_tpu_torch.models.registry import make_mlp_config
from zedo_tpu_torch.models.score_mlp import ScoreMLPConfig
from zedo_tpu_torch.zeroshot.pipeline import ZeDOConfig


class Config(dict):
    """A nested dict read by key or by attribute: the part of
    ml_collections.ConfigDict that the entry points and `apply_overrides`
    use."""

    def __getattr__(self, name):
        try:
            return self[name]
        except KeyError:
            raise AttributeError(name) from None

    def __setattr__(self, name, value):
        self[name] = value


def _config(tree: dict) -> Config:
    return Config({k: _config(v) if isinstance(v, dict) else v for k, v in tree.items()})


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
    else:
        dataset = {"TRAIN_DATASET": "h36m", "TEST_DATASET": "h36m", "NUM_JOINT": 17}
    return _config({
        "DATASET": dataset,
        "data": {"dataset": name},
        "training": {"sde": "subvpsde", "continuous": True},
        "sampling": {"method": "pc", "predictor": "euler_maruyama", "corrector": "none",
                     "snr": 0.16, "n_steps_each": 1, "probability_flow": False,
                     "noise_removal": True},
        "model": {"sigma_min": 0.01, "sigma_max": 50, "num_scales": 1000,
                  "beta_min": 0.1, "beta_max": 20.0, "dropout": 0.1,
                  "embedding_type": "positional", "fourier_scale": 16,
                  "scale_by_sigma": False, "t": 0.1,
                  "hidden_dim": 1024, "embed_dim": 512, "n_blocks": 2},
        "ZeDO": {"IPO_iterations": 500, "OIL_iterations": 1000, "sampling_eps": 0.01,
                 "score_reuse": 1, "gn_fp32": False, "use_pallas": None,
                 "pallas_interpret": False, **copy.deepcopy(_ZEDO[name])},
    })


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
