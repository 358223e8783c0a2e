"""Render metrics (the JAX package's ``utils/metrics.py``): Mrays/s,
samples/s, step timing and a JSONL sink.

``Timer`` reads the card's own time: when the timed work runs on a CUDA
device it synchronizes before it reads the clock (PyTorch returns before
the card finishes).
"""

from __future__ import annotations

import json
import time
from dataclasses import dataclass, field
from typing import List, Optional

import torch

from pathtracing_tpu_torch.utils import logging as ptlog


def rays_per_sample(width: int, height: int, max_depth: int,
                    avg_path_length: Optional[float] = None) -> float:
    """Rays traced for one sample of every pixel: ``max_depth`` a path
    (the worst case) unless a measured ``avg_path_length`` is given."""
    per_path = avg_path_length if avg_path_length is not None else max_depth
    return float(width * height) * per_path


@dataclass
class StepMetrics:
    step: int
    seconds: float
    samples_added: int
    total_spp: int
    mrays_per_s: float
    samples_per_s: float


@dataclass
class MetricsLog:
    jsonl_path: Optional[str] = None
    history: List[StepMetrics] = field(default_factory=list)

    def record(self, m: StepMetrics) -> None:
        self.history.append(m)
        ptlog.log_information(
            "step %d: %.3fs  %+d spp (total %d)  %.1f Mrays/s  %.2e samples/s",
            m.step, m.seconds, m.samples_added, m.total_spp,
            m.mrays_per_s, m.samples_per_s,
        )
        if self.jsonl_path:
            with open(self.jsonl_path, "a") as f:
                f.write(json.dumps(m.__dict__) + "\n")


class Timer:
    """Wall-clock context timer. With ``device`` a CUDA device it calls
    ``torch.cuda.synchronize(device)`` before reading the clock at exit,
    so the time covers the work queued on the card inside the block."""

    def __init__(self, device=None) -> None:
        self.device = None if device is None else torch.device(device)

    def __enter__(self):
        self.start = time.perf_counter()
        return self

    def __exit__(self, *exc):
        if self.device is not None and self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.seconds = time.perf_counter() - self.start
        return False
