"""Dataset layer: the readers and their device-batched evaluation (port of
zedo_tpu/data/): the five adult readers and the infant readers `mini`
(MINI-RGBD) and `syrip` (SyRIP)."""
from zedo_tpu_torch.data.base import PoseDataset, flip_data, unflip_data
from zedo_tpu_torch.data.custom import CustomDataset
from zedo_tpu_torch.data.h36m import H36MDataset3D
from zedo_tpu_torch.data.mini_rgbd import mini_rgbd
from zedo_tpu_torch.data.mpii3dhp import MPII3DHP
from zedo_tpu_torch.data.pw3d import PW3D
from zedo_tpu_torch.data.ski import skiPose
from zedo_tpu_torch.data.syrip import syrip

DATASETS = {
    "h36m": H36MDataset3D,
    "3dhp": MPII3DHP,
    "3dpw": PW3D,
    "ski": skiPose,
    "mini": mini_rgbd,
    "syrip": syrip,
    "wild": CustomDataset,
}

__all__ = [
    "PoseDataset", "H36MDataset3D", "MPII3DHP", "PW3D", "skiPose", "mini_rgbd", "syrip",
    "CustomDataset", "DATASETS", "flip_data", "unflip_data",
]
