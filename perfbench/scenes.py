"""The traffic's inputs, made from the seed: a frozen copy of the program's
scene makers, so that a change to the program cannot change the yardstick.

- `h36m`: `zedo_tpu_torch.bench.build_inputs` (synthetic H36M-scale
  scenes): 17-joint poses of N(0, 0.25 m) per coordinate, root-centred, at
  4.5 m before a pinhole of focal 1145 px and centre (512, 512), with
  confidences U(0.3, 1.3) clipped to [0, 1].
- `infant`: `chip_smoke.infant_scenes` with SyRIP's camera
  (`chip_smoke.write_syrip_workspace`): one base pose of N(0, 0.1 m) a
  coordinate per set, 1 cm of jitter a frame, its root at (0.05, 0.02, 3)
  with 2 cm of jitter, seen at focal 2000 px on a 640 x 480 image; the
  ground truth pelvis-centred (mean of joints 0 and 3) as SyRIP's reader
  stores it; the cluster the first training pose, as the infant CLI takes
  it.
- `clusters`: S hypotheses of N(0, 0.25 m) a coordinate (H36M's cluster
  files are not in the repository).
- `request_sizes`: serving's N per request, P(N) proportional to
  ratio^(N - 1) on 1..max.
- `train_poses`: the prior's training set, N(0, 0.3 m) a coordinate, made on
  the device in one draw.

Every stream is its own SeedSequence of (seed, stream, index), so any seed
up to 2**64 gives the same inputs for the same arguments.
"""
from __future__ import annotations

import numpy as np
import torch

STREAMS = {"clusters": 1, "scene": 2, "sizes": 3, "train": 4, "sample": 5}
# scene indices of the set-up's warm-up units, apart from the window's
WARMUP_INDEX = 1 << 40


def rng(seed: int, stream: str, index: int = 0) -> np.random.Generator:
    return np.random.default_rng(np.random.SeedSequence([int(seed), STREAMS[stream],
                                                         int(index)]))


def intrinsics(n: int, focal: float, cx: float, cy: float) -> np.ndarray:
    k = np.zeros((n, 3, 3), np.float32)
    k[:, 0, 0] = k[:, 1, 1] = focal
    k[:, 0, 2], k[:, 1, 2] = cx, cy
    k[:, 2, 2] = 1.0
    return k


def _pixels(cam: np.ndarray, k: np.ndarray) -> np.ndarray:
    q = np.einsum("bij,bnj->bni", k, cam)
    return (q[..., :2] / q[..., 2:]).astype(np.float32)


def h36m(seed: int, index: int, n: int, joints: int = 17) -> dict:
    """One set of n H36M-scale scenes: px [n, j, 2], conf [n, j], k [n, 3, 3],
    gt [n, j, 3] (root-relative, metres)."""
    r = rng(seed, "scene", index)
    k = intrinsics(n, 1145.0, 512.0, 512.0)
    pose = (r.standard_normal((n, joints, 3)) * 0.25).astype(np.float32)
    pose -= pose[:, 0:1]
    cam = pose + np.array([0.0, 0.0, 4.5], np.float32)
    conf = np.clip(r.random((n, joints)).astype(np.float32) + 0.3, 0, 1)
    return {"px": _pixels(cam, k), "conf": conf, "k": k, "gt": pose}


def clusters(seed: int, s: int, joints: int = 17) -> np.ndarray:
    return (rng(seed, "clusters").standard_normal((s, joints, 3)) * 0.25).astype(np.float32)


def infant(seed: int, index: int, n: int, s: int, joints: int = 12, depth: float = 3.0,
           focal: float = 2000.0, width: int = 640, height: int = 480) -> dict:
    """One SyRIP-like set: n test frames and one training frame of one base
    pose. px [n, j, 2], k [n, 3, 3], gt [n, j, 3] pelvis-centred, cluster
    [s, j, 3] (the training pose, pelvis-centred, for every hypothesis)."""
    r = rng(seed, "scene", index)
    base = r.standard_normal((joints, 3)) * 0.1
    pose = base + r.standard_normal((n + 1, joints, 3)) * 0.01
    pose -= pose[:, :1]
    cam = (pose + np.array([0.05, 0.02, depth]) + r.standard_normal((n + 1, 1, 3)) * 0.02)
    cam = cam.astype(np.float32)
    k = intrinsics(n + 1, focal, width / 2, height / 2)
    centred = cam - (cam[:, 0:1] + cam[:, 3:4]) / 2
    return {"px": _pixels(cam, k)[1:], "k": k[1:], "gt": centred[1:],
            "cluster": np.repeat(centred[:1], s, axis=0)}


def request_sizes(seed: int, count: int, largest: int, ratio: float) -> np.ndarray:
    """count request sizes on 1..largest with P(N) ~ ratio^(N - 1)."""
    p = ratio ** np.arange(largest, dtype=np.float64)
    return rng(seed, "sizes").choice(np.arange(1, largest + 1), size=count, p=p / p.sum())


def train_poses(seed: int, rows: int, joints: int, device) -> torch.Tensor:
    """rows training poses [rows, j, 3] of N(0, 0.3 m) a coordinate."""
    gen = torch.Generator(device=device).manual_seed(step_seed(seed, STREAMS["train"]))
    return torch.randn((rows, joints, 3), generator=gen, device=device) * 0.3


def epoch_permutation(seed: int, epoch: int, rows: int) -> np.ndarray:
    """The trainer's shuffle of an epoch: RandomState([seed, epoch]) over
    the rows (`train.trainer.train_loop`), seeded from 32-bit words."""
    words = [int(seed) & 0xFFFFFFFF, int(seed) >> 32, int(epoch)]
    return np.random.RandomState(words).permutation(rows)


def step_seed(*keys: int) -> int:
    """A 63-bit generator seed of (seed, epoch, step): the trainer's
    `step_seed`."""
    return int(np.random.SeedSequence(list(keys)).generate_state(1, np.uint64)[0] >> 1)
