"""JSONL metrics (host-only copy of ``aas_enhancement_tpu/utils/metrics.py``).

One JSON line a record, ``{"step", "t" (seconds since the logger opened),
metrics...}``, numbers rounded to 6 decimals, appended to a file and echoed
to stderr.  ``tensorboard_dir`` mirrors the numbers as TensorBoard scalars
through ``torch.utils.tensorboard.SummaryWriter`` where that imports (it
needs the ``tensorboard`` package); otherwise it prints a note to stderr and
keeps the JSONL, as the JAX logger does without TensorFlow.
"""

from __future__ import annotations

import json
import os
import sys
import time


class MetricsLogger:
    def __init__(self, path: str | None = None, echo: bool = True,
                 tensorboard_dir: str | None = None):
        self.path = path
        self.echo = echo
        self._f = None
        self._tb = None
        if path:
            os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
            self._f = open(path, "a", buffering=1)
        if tensorboard_dir:
            try:
                from torch.utils.tensorboard import SummaryWriter
                self._tb = SummaryWriter(tensorboard_dir)
            except ImportError:
                print("tensorboard_dir given but torch.utils.tensorboard not "
                      "importable; JSONL only", file=sys.stderr)
        self._t0 = time.time()

    def log(self, step: int, **metrics) -> None:
        rec = {"step": int(step), "t": round(time.time() - self._t0, 3)}
        for k, v in metrics.items():
            try:
                rec[k] = round(float(v), 6)
            except (TypeError, ValueError):
                rec[k] = v
        line = json.dumps(rec)
        if self._f:
            self._f.write(line + "\n")
        if self.echo:
            print(line, file=sys.stderr, flush=True)
        if self._tb is not None:
            for k, v in rec.items():
                if k not in ("step", "t") and isinstance(v, (int, float)):
                    self._tb.add_scalar(k, v, int(step))

    def close(self) -> None:
        if self._f:
            self._f.close()
        if self._tb is not None:
            self._tb.close()
