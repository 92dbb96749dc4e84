"""Metrics / observability: copy of ``opadpo_tpu/utils/metrics.py``.

The reference reports through accelerate trackers -> wandb (project
"OPA-DPO", ``opadpo_train.py:615-618``) or tensorboard, with per-step
stats flattened by '/' separators (``common_utils.py:64-77``).  The
durable record here is ``train_log.jsonl`` (one line per step), with wandb
/ torch tensorboard attached only when they import.
"""

from __future__ import annotations

import json
import os
import time
from typing import Any, Dict, Optional


def flatten_dict(nested: Dict, sep: str = "/", prefix: str = "") -> Dict:
    """Reference ``common_utils.flatten_dict`` semantics."""
    flat: Dict[str, Any] = {}
    for k, v in nested.items():
        key = f"{prefix}{k}"
        if isinstance(v, dict):
            flat.update(flatten_dict(v, sep=sep, prefix=key + sep))
        else:
            flat[key] = v
    return flat


class MetricsLogger:
    def __init__(self, output_dir: str, project: str = "OPA-DPO",
                 run_name: Optional[str] = None,
                 report_to: str = "jsonl"):
        os.makedirs(output_dir, exist_ok=True)
        self.path = os.path.join(output_dir, "train_log.jsonl")
        self._wandb = None
        self._tb = None
        self._t0 = time.time()
        if "wandb" in report_to:
            try:
                import wandb
                self._wandb = wandb.init(project=project, name=run_name,
                                         dir=output_dir)
            except Exception:
                pass
        if "tensorboard" in report_to:
            try:
                from torch.utils.tensorboard import SummaryWriter
                self._tb = SummaryWriter(os.path.join(output_dir, "tb"))
            except Exception:
                pass

    def log(self, stats: Dict[str, Any], step: int) -> None:
        scalars = {}
        for k, v in flatten_dict(stats).items():
            try:
                scalars[k] = float(v)
            except (TypeError, ValueError):
                continue
        line = {"step": step, "wall_s": round(time.time() - self._t0, 2),
                **scalars}
        with open(self.path, "a") as f:
            f.write(json.dumps(line) + "\n")
        if self._wandb is not None:
            self._wandb.log(scalars, step=step)
        if self._tb is not None:
            for k, v in scalars.items():
                self._tb.add_scalar(k, v, step)

    def close(self) -> None:
        if self._wandb is not None:
            self._wandb.finish()
        if self._tb is not None:
            self._tb.close()
