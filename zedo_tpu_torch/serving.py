"""Serving API: load once, predict many times.

Port of zedo_tpu/serving.py, on one device or on a mesh of ranks.

    est = ZeDOEstimator.from_torch_checkpoint(
        "checkpoint_1500.pth", "clusters/h36m_cluster5.npy",
        config_path="configs/optim/concat_pose_optimization_h36m.py", dtype="bf16")
    out = est.predict(kp2d, K)   # poses [N, S, 17, 3], best [N], ...

On a mesh (`mesh=`, parallel/mesh.py) every rank calls `predict` with the
same request (SPMD): each pads it to the bucket, solves its block of the
rows on its device, ranks and packs them there, and the packed blocks are
gathered with one device-to-host copy a rank.

The ranking and packing is compiled (JAX jits `_rank_and_pack`):
`_rank_and_pack_jit` is one CUDA graph on the card, keyed by the shapes
(utils/compiled.py), beside the solve's graphs; `_rank_and_pack` is the
same function eagerly, its oracle.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Optional

import numpy as np
import torch

from zedo_tpu_torch import presets
from zedo_tpu_torch.data.sharding import pad_batch, unpad
from zedo_tpu_torch.models.nn import tree_map
from zedo_tpu_torch.ops.camera import project
from zedo_tpu_torch.parallel import collectives
from zedo_tpu_torch.parallel.mesh import Mesh, mesh_from_spec
from zedo_tpu_torch.utils import compiled
from zedo_tpu_torch.utils.checkpoint import convert_cluster_file, load_any_checkpoint
from zedo_tpu_torch.utils.config import resolve_device
from zedo_tpu_torch.zeroshot import pipeline


def _rank_and_pack(poses, trans, kp2d, k):
    """On-device hypothesis ranking by reprojection error [N, S], packed
    with the poses and translations into ONE f32 buffer so predict() makes
    a single device-to-host copy."""
    n = poses.shape[0]
    proj = project(poses + trans, k[:, None])
    err = (proj - kp2d[:, None, :, :2]).abs().mean(dim=(2, 3))  # [N, S]
    return torch.cat([poses.reshape(n, -1).float(), trans.reshape(n, -1).float(),
                      err.float()], dim=1)


def _rank_and_pack_body(carry, consts, ys, counter, generator, variant):
    return {"packed": _rank_and_pack(consts["poses"], consts["trans"], consts["kp2d"],
                                     consts["k"])}


def _rank_and_pack_jit(poses, trans, kp2d, k):
    """`_rank_and_pack` as one compiled call."""
    out, _ = compiled.step(functools.partial(_rank_and_pack_body), None,
                           {"poses": poses, "trans": trans, "kp2d": kp2d, "k": k},
                           compiled=True)
    return out["packed"]


def _resolve_mesh(mesh, device) -> Optional[Mesh]:
    """A Mesh, or None, from a Mesh, None or a mesh_from_spec string."""
    return mesh_from_spec(mesh, device=device) if isinstance(mesh, str) else mesh


@dataclasses.dataclass
class ZeDOEstimator:
    params: dict
    model_cfg: object
    sde: object
    sampler: object
    zcfg: object
    clusters: np.ndarray  # [S, j, 3]
    device: torch.device
    batch_bucket: int = 256  # pad N up to a multiple
    # the seed of the generator each predict() builds anew (the generic OIL
    # path's noise), as JAX's predict builds PRNGKey(seed) on every call
    seed: int = 0
    # a parallel.mesh.Mesh for multi-GPU serving: the padded batch is
    # sharded over its 'data' axis (pipeline.solve_sharded's placement).
    # Also takes 'auto' or a mesh_from_spec string ('off', 'dpN', ...),
    # resolved on `device`. None = one device
    mesh: object = None

    def __post_init__(self):
        # validated on every construction path, not just from_torch_checkpoint
        self.mesh = _resolve_mesh(self.mesh, self.device)
        if self.mesh is not None:
            if "data" not in self.mesh.axis_names:
                raise ValueError(
                    f"serving mesh needs a 'data' axis, got {self.mesh.axis_names}")
            n_data = self.mesh.shape["data"]
            if self.batch_bucket % n_data:
                raise ValueError(
                    f"batch_bucket {self.batch_bucket} must be divisible by "
                    f"the mesh data-axis size {n_data}")
            self.mesh.require_member()

    @classmethod
    def from_torch_checkpoint(cls, ckpt_path: str, cluster_path: str,
                              preset: Optional[presets.Preset] = None, config=None,
                              hypo: Optional[int] = None, dtype: str = "bf16",
                              use_ema: bool = False, batch_bucket: int = 256,
                              device="cuda", mesh=None,
                              config_path: Optional[str] = None) -> "ZeDOEstimator":
        """preset: the serving configuration (default presets.h36m()); or
        config: a configuration as the CLIs' --config takes it (a preset
        name such as "h36m", or the path of any config file, which is run
        for its get_config() as JAX's serving runs it) or a presets.Config,
        e.g. presets.optim_config("h36m") with other model widths;
        config_path: JAX's name of `config`. Give at most one of the
        three; a file's model widths and schedule are the estimator's.
        hypo: keep the first `hypo` clusters. dtype 'bf16' runs the score network in bf16 (the
        fused CUDA kernel on the card), 'fp32' in full f32. use_ema: the
        checkpoint's EMA shadow weights (the raw weights by default: the
        reference loads EMA at inference but never applies it). mesh: a
        Mesh with a 'data' axis, 'auto' (a data mesh over all ranks when
        there are more than one), a mesh_from_spec string, or None; on a
        mesh the weights load onto this rank's device (mesh.device, from
        `device`). The batch bucket must be divisible by the data-axis
        size."""
        if dtype not in ("bf16", "fp32"):
            raise ValueError(f"dtype must be 'bf16' or 'fp32', got {dtype!r}")
        if config_path is not None:
            if config is not None:
                raise ValueError("config_path is another name of config: give one, not both")
            config = config_path
        if preset is not None and config is not None:
            raise ValueError("give a preset or a config, not both")
        if config is not None:
            if isinstance(config, str):
                config = presets.load_config(config)
            preset = presets.from_optim_config(config)
        preset = preset or presets.h36m()
        mesh = _resolve_mesh(mesh, device)
        dev = mesh.device if mesh is not None else resolve_device(device)
        params, _step = load_any_checkpoint(ckpt_path, preset.model_cfg, use_ema=use_ema,
                                            device=dev)
        if dtype == "bf16":
            params = tree_map(lambda x: x.to(torch.bfloat16), params)
        clusters = np.asarray(convert_cluster_file(cluster_path), np.float32)
        if hypo is not None:
            clusters = clusters[:hypo]
        return cls(params=params, model_cfg=preset.model_cfg, sde=preset.sde,
                   sampler=preset.sampler, zcfg=preset.zcfg, clusters=clusters,
                   device=dev, batch_bucket=batch_bucket, mesh=mesh)

    def with_schedule(self, oil_iterations: Optional[int],
                      ipo_iterations: Optional[int] = None,
                      score_reuse: Optional[int] = None) -> "ZeDOEstimator":
        """Short-schedule variant for latency-bound serving.

        Re-discretizes the reverse schedule: the SAME T->eps annealing is
        integrated with `oil_iterations` larger Euler steps (the SDE's step
        count N is set to `oil_iterations`, so dt = 1/iterations). Naive
        truncation, keeping dt = 1/1000, would integrate only part of the
        annealing. `oil_iterations=None` keeps the current OIL schedule.
        Returns a NEW estimator; the original is untouched."""
        if oil_iterations is None:
            sde, sampler, oil_kw = self.sde, self.sampler, {}
        else:
            sde = dataclasses.replace(self.sde, n=oil_iterations)
            sampler = dataclasses.replace(self.sampler, sde=sde)
            oil_kw = {"iterations": oil_iterations}
        if score_reuse is not None:
            oil_kw["score_reuse"] = score_reuse
        zcfg = dataclasses.replace(
            self.zcfg,
            ipo=(self.zcfg.ipo if ipo_iterations is None else
                 dataclasses.replace(self.zcfg.ipo, iterations=ipo_iterations)),
            oil=dataclasses.replace(self.zcfg.oil, **oil_kw),
        )
        return dataclasses.replace(self, sde=sde, sampler=sampler, zcfg=zcfg)

    def low_latency(self) -> "ZeDOEstimator":
        """The low-latency preset: OIL 200 (re-discretized), IPO 100."""
        return self.with_schedule(200, ipo_iterations=100)

    def predict(self, keypoints_2d: np.ndarray, k: np.ndarray,
                confidence: Optional[np.ndarray] = None) -> dict:
        """keypoints_2d [N, j, 2], k [N, 3, 3], confidence [N, j] or None
        -> dict(poses [N, S, j, 3], translations [N, S, 1, 3], best [N]
        argmin-reprojection hypothesis index, reprojection_error [N, S])."""
        n = len(keypoints_2d)
        padded, mask = pad_batch(
            {"kp": np.asarray(keypoints_2d, np.float32),
             "k": np.asarray(k, np.float32),
             "conf": None if confidence is None else np.asarray(confidence, np.float32)},
            self.batch_bucket)

        clusters = torch.from_numpy(self.clusters).to(self.device)
        buffers = (padded["kp"], padded["k"], padded["conf"])
        if self.mesh is None:
            kp, kk, conf = (None if a is None else torch.from_numpy(a).to(self.device)
                            for a in buffers)
        else:
            # this rank's block of the padded rows, solved, ranked and packed here
            kp, kk, conf = pipeline.shard_rows(self.mesh, "data", len(mask), *buffers)
            pipeline.prebuild_kernel(self.mesh, self.params, self.model_cfg)
        generator = torch.Generator(self.device).manual_seed(self.seed)
        with torch.no_grad():
            result = pipeline.solve_jit(self.params, self.model_cfg, self.sde, self.sampler,
                                        self.zcfg, clusters, kp, conf, kk, generator=generator)
            packed = _rank_and_pack_jit(result.poses, result.translations, kp, kk)
        if self.mesh is None:
            host = packed.cpu()  # the one device-to-host copy
        else:
            host = collectives.all_gather_to_host(packed, self.mesh, "data")
        host = unpad(host.numpy(), mask)
        s, j = len(self.clusters), self.model_cfg.n_joints
        poses = host[:, :s * j * 3].reshape(n, s, j, 3)
        trans = host[:, s * j * 3:s * j * 3 + s * 3].reshape(n, s, 1, 3)
        err = host[:, s * j * 3 + s * 3:]
        return {"poses": poses, "translations": trans, "best": err.argmin(axis=1),
                "reprojection_error": err}


