"""Experiment trackers: jsonl, tensorboard, wandb.

Counterpart of `maskbit_tpu/utils/tracker.py` (the original repo's
`accelerator.init_trackers` / `accelerator.log`): `create_tracker` always
adds the JSON-lines tracker (`metrics.jsonl`, one record a log call, images
as PNGs under `images/`), falls back to it alone when tensorboard or wandb
cannot be imported, and makes 'none' a no-op.
"""

from __future__ import annotations

import json
import os
import time
from typing import Mapping, Optional

import numpy as np


class JsonlTracker:
    def __init__(self, output_dir: str, filename: str = "metrics.jsonl"):
        os.makedirs(output_dir, exist_ok=True)
        self._path = os.path.join(output_dir, filename)
        self._file = open(self._path, "a")

    def log(self, values: Mapping[str, float], step: int) -> None:
        record = {"step": int(step), "time": time.time()}
        record.update({k: float(v) for k, v in values.items()})
        self._file.write(json.dumps(record) + "\n")
        self._file.flush()

    def log_image(self, tag: str, image: np.ndarray, step: int) -> None:
        from maskbit_tpu_torch.utils.viz import save_image_grid

        img_dir = os.path.join(os.path.dirname(self._path), "images")
        os.makedirs(img_dir, exist_ok=True)
        save_image_grid(np.asarray(image),
                        os.path.join(img_dir, f"{tag.replace('/', '_')}-{step:09d}.png"))

    def close(self):
        self._file.close()


class TensorBoardTracker:
    def __init__(self, output_dir: str):
        from torch.utils.tensorboard import SummaryWriter

        self._writer = SummaryWriter(output_dir)

    def log(self, values: Mapping[str, float], step: int) -> None:
        for key, value in values.items():
            self._writer.add_scalar(key, float(value), step)

    def log_image(self, tag: str, image: np.ndarray, step: int) -> None:
        self._writer.add_image(tag, np.asarray(image), step, dataformats="HWC")

    def close(self):
        self._writer.close()


class WandbTracker:
    def __init__(self, output_dir: str, project: str, name: str, config: Optional[dict] = None):
        import wandb

        self._wandb = wandb
        self._run = wandb.init(project=project, name=name, dir=output_dir, config=config)

    def log(self, values: Mapping[str, float], step: int) -> None:
        self._wandb.log({k: float(v) for k, v in values.items()}, step=step)

    def log_image(self, tag: str, image: np.ndarray, step: int) -> None:
        self._wandb.log({tag: self._wandb.Image(np.asarray(image))}, step=step)

    def close(self):
        self._run.finish()


class MultiTracker:
    def __init__(self, *trackers):
        self._trackers = [t for t in trackers if t is not None]

    def log(self, values, step):
        for t in self._trackers:
            t.log(values, step)

    def log_image(self, tag, image, step):
        for t in self._trackers:
            t.log_image(tag, image, step)

    def close(self):
        for t in self._trackers:
            t.close()


def create_tracker(logger_name: str, output_dir: str, project: str = "maskbit_tpu",
                   run_name: str = "run", config: Optional[dict] = None):
    """'tensorboard' | 'wandb' | 'jsonl' (each with jsonl); 'none' logs
    nothing."""
    if logger_name == "none":
        return MultiTracker()
    jsonl = JsonlTracker(output_dir)
    if logger_name == "tensorboard":
        try:
            return MultiTracker(TensorBoardTracker(output_dir), jsonl)
        except ImportError:
            return MultiTracker(jsonl)
    if logger_name == "wandb":
        try:
            return MultiTracker(WandbTracker(output_dir, project, run_name, config), jsonl)
        except ImportError:
            return MultiTracker(jsonl)
    return MultiTracker(jsonl)
