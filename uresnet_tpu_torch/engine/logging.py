"""Metrics logging: CSV + JSONL + stdout.

The port's own copy of ``uresnet_tpu/engine/logging.py`` (imports rewritten to
this package); tests/test_torch_data.py holds the two equal.

Capability parity (SURVEY.md §5 observability): the reference writes
`tf.summary` scalars (loss, acc, acc_nonzero) to TensorBoard event files and
prints per-step lines. The rebuild logs the same scalars plus mIoU,
images/sec and decode-queue depth to `metrics.csv` (spreadsheet-friendly)
and `metrics.jsonl` (machine-friendly), with periodic stdout lines.
"""

from __future__ import annotations

import json
import os
import time
from typing import Dict


class MetricsLogger:
    def __init__(self, log_dir: str, *, name: str = "train", echo: bool = True,
                 tensorboard: bool = True):
        os.makedirs(log_dir, exist_ok=True)
        self._csv_path = os.path.join(log_dir, f"{name}_metrics.csv")
        self._jsonl_path = os.path.join(log_dir, f"{name}_metrics.jsonl")
        self._csv = open(self._csv_path, "a", buffering=1)
        self._jsonl = open(self._jsonl_path, "a", buffering=1)
        self._header_written = os.path.getsize(self._csv_path) > 0
        self._echo = echo
        self._t0 = time.time()
        self._tb = None
        if tensorboard:
            from uresnet_tpu_torch.engine.tb_writer import TBWriter

            self._tb = TBWriter(log_dir, name=name)

    def log(self, step: int, metrics: Dict[str, float]):
        row = {"step": int(step), "wall_s": round(time.time() - self._t0, 3)}
        row.update({k: float(v) for k, v in metrics.items()})
        if not self._header_written:
            self._csv.write(",".join(row.keys()) + "\n")
            self._header_written = True
        self._csv.write(",".join(f"{v:.6g}" if isinstance(v, float) else str(v)
                                 for v in row.values()) + "\n")
        self._jsonl.write(json.dumps(row) + "\n")
        if self._tb is not None:
            self._tb.scalars(int(step),
                             {k: v for k, v in row.items() if k != "step"})
        if self._echo:
            body = " ".join(f"{k}={v:.4g}" for k, v in row.items() if k != "step")
            print(f"[step {step}] {body}", flush=True)

    def close(self):
        self._csv.close()
        self._jsonl.close()
        if self._tb is not None:
            self._tb.close()


class NullLogger:
    """No-op logger for non-leader processes under multi-host SPMD: every
    host computes the same replicated metrics, so only process 0 writes
    (shared log/checkpoint paths would otherwise interleave corruptly)."""

    def log(self, step: int, metrics: Dict[str, float]):
        pass

    def close(self):
        pass
