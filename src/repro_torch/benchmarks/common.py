"""Benchmark helpers of the port (counterpart of ``benchmarks/common.py``):
the CSV row, a median timer that waits for the card, the device line every
record carries, and deterministic algorithms for the bitwise checks."""

from __future__ import annotations

import contextlib
import subprocess
import time
from dataclasses import dataclass
from pathlib import Path
from typing import Any, Callable

import torch

#: the repository root, where the records land by default
ROOT = Path(__file__).resolve().parents[3]


@dataclass
class Row:
    name: str
    us_per_call: float
    derived: Any

    def csv(self) -> str:
        return f"{self.name},{self.us_per_call:.2f},{self.derived}"


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def time_fn(fn: Callable, *args, device: torch.device, warmup: int = 2, reps: int = 5) -> float:
    """Median wall time of ``fn(*args)`` in microseconds, each call ending
    in ``torch.cuda.synchronize()`` on the card."""
    for _ in range(warmup):
        fn(*args)
        sync(device)
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn(*args)
        sync(device)
        ts.append(time.perf_counter() - t0)
    return sorted(ts)[len(ts) // 2] * 1e6


def device_record(device: torch.device) -> dict[str, Any]:
    """The device a record was measured on: on the card its name and, as
    ``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader`` prints
    them, its name and power limit; on the CPU the host times are no device
    metric."""
    if device.type != "cuda":
        return {"device": "cpu", "card": None, "nvidia_smi": "not measured"}
    try:
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             check=True).stdout.strip().splitlines()[device.index or 0]
    except (OSError, subprocess.CalledProcessError, IndexError):
        smi = "not measured"
    return {"device": str(device), "card": torch.cuda.get_device_name(device),
            "nvidia_smi": smi}


@contextlib.contextmanager
def deterministic():
    """Deterministic algorithms for the body (warnings where an operation
    has none): CUDA's embedding backward accumulates with atomics, so two
    runs of one cell differ in the last bit without them."""
    prev, warn = (torch.are_deterministic_algorithms_enabled(),
                  torch.is_deterministic_algorithms_warn_only_enabled())
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(prev, warn_only=warn)
