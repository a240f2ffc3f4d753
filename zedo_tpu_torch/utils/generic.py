"""Logging setup, the port's copy of zedo_tpu/utils/generic.py (reference
lib/utils/generic.py:15-59)."""
from __future__ import annotations

import logging
import time
from pathlib import Path


def create_logger(config, phase: str = "train", folder_name: str = "",
                  log_name: str | None = None):
    """Build OUTPUT_DIR/<train>_<test>/<logname or time>-<folder> tree and a
    file+console logger. Returns (logger, final_output_dir, tb_log_dir)."""
    root = Path(config.OUTPUT_DIR)
    dataset_pair = f"{config.DATASET.TRAIN_DATASET}_{config.DATASET.TEST_DATASET}"
    time_str = time.strftime("%Y-%m-%d-%H-%M")
    name = log_name or time_str
    folder = f"{name}-{folder_name}" if folder_name else name
    final_output_dir = root / dataset_pair / folder
    final_output_dir.mkdir(parents=True, exist_ok=True)

    log_file = final_output_dir / f"{phase}_{time_str}.log"
    logger = logging.getLogger(str(final_output_dir))
    logger.setLevel(logging.INFO)
    logger.handlers.clear()
    fmt = logging.Formatter("%(asctime)-15s %(message)s")
    fh = logging.FileHandler(log_file)
    fh.setFormatter(fmt)
    ch = logging.StreamHandler()
    ch.setFormatter(fmt)
    logger.addHandler(fh)
    logger.addHandler(ch)

    tb_log_dir = final_output_dir / "tb"
    tb_log_dir.mkdir(exist_ok=True)
    return logger, str(final_output_dir), str(tb_log_dir)
