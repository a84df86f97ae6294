"""Run artifact logger.

Port of ``proudslam_tpu/utils/logger.py``: creates
``<log_dir>/<exp_name>/<timestamp>/{mesh,ckpt,bak,misc}``, backs up the
config, saves meshes (PLY) and numpy arrays, and appends scalar metrics to
``metrics.jsonl``. The rendered-vs-ground-truth image panels (``imgs/``,
matplotlib) are not ported yet (ROADMAP, with ``render/preview.py``).
"""

from __future__ import annotations

import json
import os
import os.path as osp
import shutil
import time
from typing import Dict, Optional

import numpy as np


class RunLogger:
    def __init__(self, log_dir: str, exp_name: str = "default"):
        stamp = time.strftime("%Y-%m-%d-%H-%M-%S")
        self.dir = osp.join(log_dir, exp_name, stamp)
        self.mesh_dir = osp.join(self.dir, "mesh")
        self.ckpt_dir = osp.join(self.dir, "ckpt")
        self.backup_dir = osp.join(self.dir, "bak")
        self.misc_dir = osp.join(self.dir, "misc")
        for d in (self.mesh_dir, self.ckpt_dir, self.backup_dir,
                  self.misc_dir):
            os.makedirs(d, exist_ok=True)
        self.metrics_path = osp.join(self.dir, "metrics.jsonl")
        open(self.metrics_path, "a").close()

    def log_config(self, config_path: Optional[str] = None,
                   config_dict: Optional[dict] = None) -> None:
        if config_path and osp.exists(config_path):
            shutil.copy(config_path, self.backup_dir)
        if config_dict is not None:
            with open(osp.join(self.backup_dir, "config.json"), "w") as f:
                json.dump(config_dict, f, indent=2, default=str)

    def log_metrics(self, step: int, metrics: Dict[str, float]) -> None:
        rec = {"step": step, "time": time.time()}
        rec.update({k: float(v) for k, v in metrics.items()})
        with open(self.metrics_path, "a") as f:
            f.write(json.dumps(rec) + "\n")

    def log_numpy(self, data: np.ndarray, name: str) -> None:
        np.save(osp.join(self.misc_dir, f"{name}.npy"), np.asarray(data))

    def log_mesh(self, mesh, name: str = "final_mesh.ply") -> None:
        from proudslam_tpu_torch.mesher import save_ply
        save_ply(osp.join(self.mesh_dir, name), mesh)
