"""Benchmark helpers of the port (counterpart of ``benchmarks/common.py``):
the CSV row, a median timer that waits for the card, the device line every
record carries, and deterministic algorithms for the bitwise checks."""

from __future__ import annotations

import contextlib
import json
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


def sync(device: str | torch.device) -> None:
    device = torch.device(device)
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


def rows_record(rows: list[Row]) -> list[dict[str, Any]]:
    return [{"name": r.name, "us_per_call": r.us_per_call, "derived": str(r.derived)}
            for r in rows]


def write_record(record: dict[str, Any], out: str | Path | None, default: Path,
                 device: torch.device) -> Path:
    """Write a twin's record, with the device it was measured on, to ``out``
    (default: ``default``, a ``BENCH_torch_*.json`` at the repository root;
    never a reference record)."""
    path = Path(out or default)
    with open(path, "w") as f:
        json.dump({**record, **device_record(device)}, f, indent=2)
    return path


def table_main(run: Callable, doc: str, argv=None, *, no_speedup: bool = False) -> int:
    """The command line of a twin: ``--device`` (default cuda), ``--out``
    and, where ``run`` takes it, ``--no-speedup``; prints the CSV rows."""
    import argparse

    p = argparse.ArgumentParser(description=doc.split("\n\n")[0])
    p.add_argument("--device", default="cuda", help="default cuda; cpu to run without a card")
    p.add_argument("--out", default="", help="the record's path (default: BENCH_torch_*.json "
                                             "at the repository root)")
    if no_speedup:
        p.add_argument("--no-speedup", action="store_true",
                       help="skip the per-cell or loop baseline")
    args = p.parse_args(argv)
    kw = {"no_speedup": args.no_speedup} if no_speedup else {}
    print("name,us_per_call,derived")
    for row in run(args.device, args.out or None, **kw):
        print(row.csv())
    return 0
