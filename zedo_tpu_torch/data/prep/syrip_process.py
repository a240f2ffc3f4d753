"""SyRIP COCO-json downloads -> .npy maps (port of
zedo_tpu/data/prep/syrip_process.py, the reference's syrip_process.py).

Builds (a) {train,test}_rysip.npy: image-name maps splitting the 700-image
set by membership in the train-200 COCO json, and (b) {train,test}_pose2d.npy:
per-image {h, w, bbox, keypoints [j, 3]} dicts from the validate-500 jsons.

Usage: python -m zedo_tpu_torch.data.prep.syrip_process [data_root [out_dir]]
"""
from __future__ import annotations

import json
import os
import sys

import numpy as np


def _pose_dict(coco: dict) -> dict:
    out = {}
    for i, image in enumerate(coco["images"]):
        ann = coco["annotations"][i]  # the i-th annotation belongs to the i-th image
        out[image["file_name"]] = {
            "h": image["height"],
            "w": image["width"],
            "bbox": ann["bbox"],
            "keypoints": np.array(ann["keypoints"]).reshape((-1, 3)),
        }
    return out


def _load_json(*parts: str) -> dict:
    with open(os.path.join(*parts)) as f:
        return json.load(f)


def process(data_root: str, out_dir: str = "."):
    pose2d = _load_json(data_root, "SyRIP_2d_gt/train200/person_keypoints_train_infant.json")
    name_map = np.load(os.path.join(data_root, "survey_data/img_name700_map.npy"))

    real_test = {image["file_name"].split("/")[-1] for image in pose2d["images"]}
    train, test = {}, {}
    for idx, pair in enumerate(name_map):
        (test if pair[1] in real_test else train)[pair[0]] = [pair[1], idx]
    np.save(os.path.join(out_dir, "test_rysip.npy"), test)
    np.save(os.path.join(out_dir, "train_rysip.npy"), train)

    validate = os.path.join(data_root, "SyRIP_2d_gt/validate500")
    np.save(os.path.join(out_dir, "test_pose2d.npy"),
            _pose_dict(_load_json(validate, "person_keypoints_validate_infant.json")))
    np.save(os.path.join(out_dir, "train_pose2d.npy"),
            _pose_dict(_load_json(validate, "person_keypoints_train_infant.json")))


if __name__ == "__main__":
    root = sys.argv[1] if len(sys.argv) > 1 else "data"
    out = sys.argv[2] if len(sys.argv) > 2 else "."
    process(root, out)
