"""Structured JSONL metrics logging: one JSON record a line, each with a
wall-clock timestamp (the JAX package's `MetricsLogger` without its
TensorBoard mirror)."""

from __future__ import annotations

import json
import os
import time


class MetricsLogger:
    def __init__(self, out_dir: str, name: str = "metrics.jsonl"):
        os.makedirs(out_dir, exist_ok=True)
        self.path = os.path.join(out_dir, name)

    def log(self, record: dict) -> None:
        record = dict(record)
        record.setdefault("ts", time.time())
        with open(self.path, "a") as f:
            f.write(json.dumps(record, default=float) + "\n")

    def read(self) -> list[dict]:
        if not os.path.exists(self.path):
            return []
        with open(self.path) as f:
            return [json.loads(ln) for ln in f if ln.strip()]
