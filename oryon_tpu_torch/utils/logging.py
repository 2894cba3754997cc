"""Structured metric logging on the host.

Counterpart of ``oryon_tpu/utils/logging.py``, the port's own copy: a JSONL
metric stream (one line per logged step, one per epoch with its means)
under the ``{train,valid}_loss/*`` / ``{train,valid}_metric/*`` names.
The JAX module's ``StageTimer`` has no caller there or here and is not
copied.
"""
from __future__ import annotations

import json
import os
import time
from collections import defaultdict
from typing import Dict, Optional


class MetricLogger:
    """Appends to ``<log_dir>/<run_name>.metrics.jsonl``; ``close`` it."""

    def __init__(self, log_dir: str, run_name: str = "run"):
        os.makedirs(log_dir, exist_ok=True)
        self.path = os.path.join(log_dir, f"{run_name}.metrics.jsonl")
        self._fp = open(self.path, "a")
        self._epoch_acc: Dict[str, list] = defaultdict(list)

    def log_step(self, step: int, metrics: Dict[str, float],
                 prefix: Optional[str] = None) -> None:
        """One line ``{"step", "time", <prefix>_<name>: value}``; values may
        be 0-d tensors (read to the host here)."""
        rec = {"step": int(step), "time": time.time()}
        for k, v in metrics.items():
            name = f"{prefix}_{k}" if prefix else k
            v = float(v)
            rec[name] = v
            self._epoch_acc[name].append(v)
        self._fp.write(json.dumps(rec) + "\n")
        self._fp.flush()

    def epoch_summary(self, epoch: int) -> Dict[str, float]:
        """Write and return the means of the values logged since the last
        summary, then reset them."""
        means = {k: sum(v) / len(v) for k, v in self._epoch_acc.items() if v}
        self._fp.write(json.dumps({"epoch": int(epoch), **means}) + "\n")
        self._fp.flush()
        self._epoch_acc.clear()
        return means

    def close(self) -> None:
        self._fp.close()
