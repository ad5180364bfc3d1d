"""Metrics logging for optimization runs.

PyTorch counterpart of ``torchoptics_tpu.utils.logging``: a host-side JSONL
metrics logger fed by the loss dicts a step returns (tensors are written as
floats), and its reader.
"""

from __future__ import annotations

import json
import os
import time
from typing import Any, Dict

import numpy as np
import torch


def _number(v):
    """A float for a scalar tensor, array or number (a tensor on the GPU is
    copied to the host); the string otherwise."""
    try:
        if isinstance(v, torch.Tensor):
            return float(v.detach().cpu())
        return float(np.asarray(v))
    except (TypeError, ValueError, RuntimeError):
        return str(v)


class MetricsLogger:
    """Append-only JSONL metrics log.

    Usage::

        logger = MetricsLogger("runs/cooke_opt")
        for step in range(n):
            state, total, loss_dict = optimizer.step(state)
            logger.log(step, loss_dict)
    """

    def __init__(self, run_dir: str, filename: str = "metrics.jsonl",
                 flush_every: int = 50):
        os.makedirs(run_dir, exist_ok=True)
        self.path = os.path.join(run_dir, filename)
        self._fh = open(self.path, "a")
        self._flush_every = flush_every
        self._count = 0
        self._t0 = time.time()

    def log(self, step: int, metrics: Dict[str, Any]) -> None:
        record = {"step": int(step), "wall_s": time.time() - self._t0}
        record.update((k, _number(v)) for k, v in metrics.items())
        self._fh.write(json.dumps(record) + "\n")
        self._count += 1
        if self._count % self._flush_every == 0:
            self._fh.flush()

    def close(self) -> None:
        self._fh.flush()
        self._fh.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def read_metrics(path: str):
    """Load a metrics.jsonl back as a list of dicts."""
    out = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line:
                out.append(json.loads(line))
    return out
