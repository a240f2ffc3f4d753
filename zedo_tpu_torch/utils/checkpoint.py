"""Checkpoint I/O: reference torch .pth files and weights from the JAX package.

Port of the .pth half of zedo_tpu/utils/checkpoint.py. The reference ships
checkpoints whose state_dict keys follow ScoreModelFC_Adv's module names,
wrapped in DataParallel's `module.` prefix, inside a dict {epoch,
model_state_dict, optimizer_state_dict, ema, step}. The port's params keep
those names (`[out, in]` weights), so a state_dict loads directly.

`save_native` / `restore_native` are the training checkpoints, the
counterparts of the JAX package's orbax ones: the same .pth layout (so
either package's `load_torch_checkpoint` reads the trained prior), plus
the whole EMA shadow and the Adam state for a resume.

`flat_to_tree` and `tree_to_flat` (the latter defined in models/nn.py)
convert between state-dict names and nested params, as the JAX module's
functions of those names do.
"""
from __future__ import annotations

import os
import pickle

import numpy as np
import torch

from zedo_tpu_torch.models.nn import tree_to_flat
from zedo_tpu_torch.models.score_mlp import ScoreMLPConfig, get_sigmas
from zedo_tpu_torch.utils.config import resolve_device


def _param_order(cfg: ScoreMLPConfig) -> list[str]:
    """torch parameter definition order of ScoreModelFC_Adv: maps the EMA
    shadow_params LIST (trainables only) back to names."""
    names = [
        "pre_dense.weight", "pre_dense.bias",
        "pre_dense_t.weight", "pre_dense_t.bias",
        "pre_gnorm.weight", "pre_gnorm.bias",
        "shared_time_embed.0.weight", "shared_time_embed.0.bias",
    ]
    for idx in range(cfg.n_blocks):
        for layer in ("dense1", "dense1_t", "gnorm1", "dense2", "dense2_t", "gnorm2"):
            names += [f"b{idx + 1}_{layer}.weight", f"b{idx + 1}_{layer}.bias"]
    names += ["post_dense.weight", "post_dense.bias"]
    return names


def strip_module_prefix(state_dict: dict) -> dict:
    """Remove DataParallel's 'module.' prefix."""
    return {(k[7:] if k.startswith("module.") else k): v for k, v in state_dict.items()}


def flat_to_tree(flat: dict, device="cuda") -> dict:
    """{'a.b.c': array} -> nested dicts of tensors on `device`."""
    device = resolve_device(device)
    tree: dict = {}
    for key, value in flat.items():
        parts = key.split(".")
        node = tree
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = torch.as_tensor(np.asarray(value)).to(device)
    return tree


def params_from_torch_state_dict(state_dict: dict, cfg: ScoreMLPConfig,
                                 device="cuda") -> dict:
    """torch state_dict (possibly DataParallel-prefixed) -> params dict."""
    dev = resolve_device(device)
    flat = {k: (v.detach().cpu().numpy() if torch.is_tensor(v) else v)
            for k, v in strip_module_prefix(state_dict).items()}
    tree = flat_to_tree(flat, dev)
    if "sigmas" not in tree:
        tree["sigmas"] = torch.as_tensor(get_sigmas(cfg), dtype=torch.float32,
                                         device=dev)
    return tree


def params_from_numpy(tree: dict, device="cuda") -> dict:
    """Nested dicts of numpy arrays (e.g. a JAX params pytree passed through
    np.asarray) -> the port's params, same keys, same dtypes."""
    dev = resolve_device(device)

    def conv(node):
        if isinstance(node, dict):
            return {k: conv(v) for k, v in node.items()}
        a = np.asarray(node)
        if a.dtype.name == "bfloat16":  # ml_dtypes bf16 has no torch counterpart
            return torch.as_tensor(a.astype(np.float32)).to(dev, torch.bfloat16)
        return torch.tensor(a, device=dev)

    return conv(tree)


def _cpu(flat: dict) -> dict:
    return {k: v.detach().cpu() for k, v in flat.items()}


def save_native(path: str, epoch: int, step: int, params: dict, ema, opt_state: dict,
                cfg: ScoreMLPConfig) -> None:
    """Write a training checkpoint to `path` atomically (a temporary file,
    then a rename): {epoch, step, model_state_dict (the reference's
    `module.`-prefixed state dict), ema {decay, num_updates, shadow_params
    (the reference's positional list of the trainable leaves: ScoreMLP's
    in its definition order), shadow_state_dict (every leaf, by name)},
    optimizer_state_dict}. `ema` is a diffusion.ema.EMAState, `opt_state`
    the optimizer's state_dict()."""
    flat = tree_to_flat(params)
    shadow = _cpu(tree_to_flat(ema.shadow_params))
    order = _param_order(cfg)
    trainable = [n for n in flat if n != "sigmas" and n != "gauss_proj.W"]
    names = order if sorted(order) == sorted(trainable) else trainable
    payload = {
        "epoch": int(epoch), "step": int(step),
        "model_state_dict": {"module." + k: v for k, v in _cpu(flat).items()},
        "ema": {"decay": ema.decay, "num_updates": ema.num_updates,
                "shadow_params": [shadow[n] for n in names], "shadow_state_dict": shadow},
        "optimizer_state_dict": opt_state,
    }
    tmp = f"{path}.tmp{os.getpid()}"
    torch.save(payload, tmp)
    os.replace(tmp, path)


def restore_native(path: str, device="cuda") -> dict:
    """A `save_native` checkpoint -> {epoch, step, params, ema: {decay,
    num_updates, shadow_params (a params dict)}, opt_state} on `device`."""
    dev = resolve_device(device)
    ckpt = torch.load(path, map_location="cpu", weights_only=False)
    ema = ckpt["ema"]
    return {"epoch": int(ckpt["epoch"]), "step": int(ckpt["step"]),
            "params": flat_to_tree(strip_module_prefix(ckpt["model_state_dict"]), dev),
            "ema": {"decay": ema["decay"], "num_updates": ema["num_updates"],
                    "shadow_params": flat_to_tree(ema["shadow_state_dict"], dev)},
            "opt_state": ckpt["optimizer_state_dict"]}


def _merge(base: dict, override: dict) -> dict:
    out = dict(base)
    for k, v in override.items():
        out[k] = _merge(out[k], v) if isinstance(v, dict) and isinstance(out.get(k), dict) else v
    return out


def ema_shadow_to_params(shadow_params: list, cfg: ScoreMLPConfig, device="cuda") -> dict:
    """EMA shadow list (positional, trainables only) -> params tree. Buffers
    (`sigmas`, the fourier `gauss_proj.W`) are not EMA-tracked: callers merge
    this over the model's params."""
    names = _param_order(cfg)
    if len(names) != len(shadow_params):
        raise ValueError(
            f"EMA shadow length {len(shadow_params)} != expected {len(names)}")
    flat = {n: p.detach().cpu().numpy() for n, p in zip(names, shadow_params)}
    return flat_to_tree(flat, resolve_device(device))


def load_torch_checkpoint(path: str, cfg: ScoreMLPConfig, device="cuda") -> dict:
    """Reference .pth -> {params, ema_params (merged over params) or None,
    step, epoch}. The reference loads EMA at inference but never applies
    it, so callers use `params` unless they opt into the shadow weights."""
    dev = resolve_device(device)
    ckpt = torch.load(path, map_location="cpu", weights_only=False)
    params = params_from_torch_state_dict(ckpt["model_state_dict"], cfg, dev)
    ema_params = None
    if ckpt.get("ema") is not None:
        try:
            ema_params = _merge(params, ema_shadow_to_params(
                ckpt["ema"]["shadow_params"], cfg, dev))
        except ValueError as e:
            # other trainable sets (the ControlNet adapters) keep another
            # shadow order; the reference never applies EMA at inference
            print(f"note: EMA shadow list not mapped ({e}); --ema unavailable")
    return {"params": params, "ema_params": ema_params,
            "step": int(ckpt.get("step", 0)), "epoch": int(ckpt.get("epoch", 0))}


def load_any_checkpoint(path: str, cfg: ScoreMLPConfig, use_ema: bool = False, log=print,
                        device="cuda"):
    """Reference `.pth` checkpoint -> (params, step), with the EMA shadow
    weights when `use_ema` and the checkpoint carries them, and a note
    otherwise (the reference loads EMA at inference but never applies it,
    so the raw weights are the default). The JAX package's orbax form is
    not read here."""
    if not path.endswith(".pth"):
        raise NotImplementedError(
            f"{path}: only reference .pth checkpoints are read by the port; orbax "
            "checkpoints are the JAX package's own format (convert with "
            "`python tools/convert_checkpoint.py native2pth`)")
    ckpt = load_torch_checkpoint(path, cfg, device)
    if use_ema and not ckpt["ema_params"]:
        log("note: --ema requested but the checkpoint carries no EMA shadow params; "
            "using the raw weights")
    params = ckpt["ema_params"] if (use_ema and ckpt["ema_params"]) else ckpt["params"]
    return params, ckpt["step"]


def to_flattened_numpy(x) -> np.ndarray:
    """A tensor (on any device) flattened to 1-D numpy."""
    return (x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)).reshape((-1,))


def from_flattened_numpy(x: np.ndarray, shape, device="cuda") -> torch.Tensor:
    """1-D numpy -> a tensor of `shape` on `device`."""
    return torch.as_tensor(np.asarray(x).reshape(shape)).to(resolve_device(device))


def convert_cluster_file(path: str) -> np.ndarray:
    """Cluster init poses from .npy or .pkl (the reference ships both names)."""
    if path.endswith(".npy"):
        return np.load(path, allow_pickle=True)
    with open(path, "rb") as f:
        return np.asarray(pickle.load(f))
