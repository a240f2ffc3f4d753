"""Dataset layer: the adult readers and their device-batched evaluation
(port of zedo_tpu/data/). The infant readers (`mini`, `syrip`) wait for
the infant path (ROADMAP.md Queue 1, item 11)."""
from zedo_tpu_torch.data.base import PoseDataset, flip_data, unflip_data
from zedo_tpu_torch.data.custom import CustomDataset
from zedo_tpu_torch.data.h36m import H36MDataset3D
from zedo_tpu_torch.data.mpii3dhp import MPII3DHP
from zedo_tpu_torch.data.pw3d import PW3D
from zedo_tpu_torch.data.ski import skiPose

DATASETS = {
    "h36m": H36MDataset3D,
    "3dhp": MPII3DHP,
    "3dpw": PW3D,
    "ski": skiPose,
    "wild": CustomDataset,
}

__all__ = [
    "PoseDataset", "H36MDataset3D", "MPII3DHP", "PW3D", "skiPose", "CustomDataset",
    "DATASETS", "flip_data", "unflip_data",
]
