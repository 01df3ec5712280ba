"""Metrics and logging of training runs.

PyTorch counterpart of `griduniverse_tpu/utils/metrics.py`: a small logger
on the host, fed at LOW frequency (at the boundaries of chunks of training,
never inside a step loop: the device accumulates, the host reads a few
scalars once a chunk), that keeps an in-memory history (for tests and
plots) and mirrors each row to python `logging` and, optionally, a JSONL
file. `debug_scalar` reads one value to the host at once, for debugging.
"""

from __future__ import annotations

import json
import logging
import os
import time
from typing import Any, Mapping

logger = logging.getLogger("griduniverse_tpu_torch")


class MetricsLogger:
    """Collects {step: {name: value}} rows; mirrors to logging + JSONL."""

    def __init__(self, jsonl_path: str | os.PathLike | None = None, log_every: int = 1,
                 name: str = "train"):
        self.history: list[dict[str, Any]] = []
        self.jsonl_path = os.fspath(jsonl_path) if jsonl_path else None
        self.log_every = max(1, int(log_every))
        self.name = name
        self._t0 = time.perf_counter()
        if self.jsonl_path:
            os.makedirs(os.path.dirname(self.jsonl_path) or ".", exist_ok=True)

    def log(self, step: int, metrics: Mapping[str, Any]) -> None:
        """Add a row; a tensor or number is stored as a float (a tensor on the
        card is read to the host here)."""
        row = {"step": int(step), "wall_s": time.perf_counter() - self._t0}
        for k, v in metrics.items():
            try:
                row[k] = float(v)
            except (TypeError, ValueError):
                row[k] = v
        self.history.append(row)
        if len(self.history) % self.log_every == 0:
            pretty = ", ".join(
                f"{k}={v:.4g}" if isinstance(v, float) else f"{k}={v}"
                for k, v in row.items() if k != "wall_s"
            )
            logger.info("[%s] %s", self.name, pretty)
        if self.jsonl_path:
            with open(self.jsonl_path, "a", encoding="utf-8") as f:
                f.write(json.dumps(row) + "\n")

    def latest(self) -> dict[str, Any]:
        return self.history[-1] if self.history else {}

    def series(self, key: str) -> list[float]:
        return [row[key] for row in self.history if key in row]


def debug_scalar(name: str, value) -> None:
    """Read `value` (a tensor or a number) to the host and log it. For
    debugging only: a host read waits for the device to finish everything
    enqueued before it, so one per step serializes the device; never leave
    this in a hot loop."""
    v = value.item() if hasattr(value, "item") else value
    logger.info("[debug] %s = %s", name, v)
