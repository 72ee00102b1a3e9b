"""Paper Fig. 4 and Table II on the port (the twin of
``benchmarks/sync_timeline.py``): throughput, staleness, idle and
communication shares of each (architecture x synchronization) cell under a
straggler, 16 workers, 150 steps, a 100 MB message, on the timeline
substrate; All-Reduce has no asynchronous cell (a row says so).  Asserts
the table's relations: ASP beats BSP on a parameter server, local SGD
communicates less, All-Reduce BSP beats PS BSP, ASP is staler than SSP.

    PYTHONPATH=src python -m repro_torch.benchmarks.sync_timeline [--out PATH]

The timeline is an event simulation on the host: ``--device`` is accepted
and unused.  The record goes to ``BENCH_torch_sync.json`` at the
repository root (or ``--out``).
"""

from __future__ import annotations

import sys

import torch

from repro_torch.benchmarks.common import ROOT, Row, rows_record, table_main, write_record
from repro_torch.experiments import expand, grid, run_scenarios

BENCH_PATH = ROOT / "BENCH_torch_sync.json"


def table() -> list[Row]:
    rows: list[Row] = []
    raw = grid(arch=["ps", "allreduce", "gossip"], sync=["bsp", "ssp", "asp", "local"],
               n_workers=16, steps=150, staleness=3, straggler_slowdown=3.0,
               msg_bytes=4 * 25e6)
    valid = expand(raw, substrate="timeline")
    for s in raw:
        if s not in valid:  # Table II: All-Reduce has no async cell
            rows.append(Row(f"tableII/{s.arch}/{s.sync}", 0.0, "n/a (collective)"))

    results = {}
    for res in run_scenarios(valid, "timeline"):
        s, m = res.scenario, res.measured
        results[(s.arch, s.sync)] = m
        rows.append(Row(
            f"tableII/{s.arch}/{s.sync}", 0.0,
            f"thr={m['throughput']:.2f}/s stale={m['mean_staleness']:.1f} "
            f"idle={m['idle_frac']:.2f} comm={m['comm_frac']:.2f} "
            f"GB/w={m['bytes_per_worker']/1e9:.1f} "
            f"(pred {res.predicted['bytes_per_worker']/1e9:.1f})",
        ))

    # Table II's qualitative relations, quantified
    assert results[("ps", "asp")]["throughput"] > results[("ps", "bsp")]["throughput"]
    assert results[("ps", "local")]["comm_frac"] < results[("ps", "bsp")]["comm_frac"]
    assert results[("allreduce", "bsp")]["throughput"] > results[("ps", "bsp")]["throughput"]
    assert results[("ps", "asp")]["mean_staleness"] > results[("ps", "ssp")]["mean_staleness"]
    rows.append(Row("tableII/claims_validated", 0.0, True))
    return rows


def run(device: str | torch.device = "cuda", out: str | None = None) -> list[Row]:
    rows = table()
    write_record({"rows": rows_record(rows)}, out, BENCH_PATH, torch.device(device))
    return rows


if __name__ == "__main__":
    sys.exit(table_main(run, __doc__))
