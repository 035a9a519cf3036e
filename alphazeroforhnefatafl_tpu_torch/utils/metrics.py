"""Metrics and observability.

The port's own copy of ``alphazeroforhnefatafl_tpu/utils/metrics.py`` (the
port imports nothing of the JAX package): per-iteration scalar logging
(games/s, loss terms, arena scores), one JSON line per step.
"""

from __future__ import annotations

import json
import math
import sys
import time
from collections import OrderedDict
from typing import Dict, Optional, TextIO


class MetricsLogger:
    """Buffers scalars per step and flushes one JSON line per step."""

    def __init__(self, stream: Optional[TextIO] = None, jsonl_path: Optional[str] = None):
        self.stream = stream or sys.stdout
        self._file = open(jsonl_path, "a") if jsonl_path else None
        self._pending: "OrderedDict[str, float]" = OrderedDict()
        self._pending_step: Optional[int] = None
        self._t0 = time.time()

    def scalar(self, name: str, value, step: Optional[int] = None) -> None:
        # A scalar logged under a different step than the pending buffer
        # flushes the buffer first, so per-step attribution never depends on
        # call ordering relative to flush().
        if (
            step is not None
            and self._pending_step is not None
            and step != self._pending_step
        ):
            self.flush()
        if step is not None:
            self._pending_step = step
        self._pending[name] = float(value)

    def flush(self, step: Optional[int] = None) -> None:
        if not self._pending:
            return
        if step is None:
            step = self._pending_step
        rec = {"step": step, "t": round(time.time() - self._t0, 3)}
        # Non-finite scalars (a diverged loss) become strings: json.dumps
        # would otherwise emit bare NaN/Infinity tokens — invalid JSON that
        # breaks strict scrapers on exactly the lines needed to diagnose
        # the divergence.
        rec.update(
            {
                k: round(v, 6) if math.isfinite(v) else repr(v)
                for k, v in self._pending.items()
            }
        )
        line = json.dumps(rec)
        print(line, file=self.stream, flush=True)
        if self._file:
            self._file.write(line + "\n")
            self._file.flush()
        self._pending.clear()
        self._pending_step = None

    def close(self) -> None:
        if self._file:
            self._file.close()
