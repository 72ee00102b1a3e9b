"""Paper Table III on the port (the twin of ``benchmarks/allreduce_table.py``):
the all-reduce algorithms' alpha-beta costs (``core/costmodel.py``) at 16,
256 and 512 workers for a 4 KiB and a 100 MB message, the best algorithm of
each, and the table's structural claims: ring beats the binary tree on
bandwidth at scale, the double binary tree beats ring on latency.

    PYTHONPATH=src python -m repro_torch.benchmarks.allreduce_table [--out PATH]

Pure arithmetic on the host: ``--device`` is accepted and unused.  The
record goes to ``BENCH_torch_allreduce.json`` at the repository root (or
``--out``).
"""

from __future__ import annotations

import sys

import torch

from repro_torch.benchmarks.common import ROOT, Row, rows_record, table_main, write_record
from repro_torch.core.costmodel import TABLE_III_ALGS, Link, allreduce_cost

BENCH_PATH = ROOT / "BENCH_torch_allreduce.json"


def table() -> list[Row]:
    rows: list[Row] = []
    link = Link(alpha=1e-5, beta=1 / 50e9)
    for n in (16, 256, 512):
        for nbytes, tag in ((4 * 1024, "4KiB"), (4 * 25_000_000, "100MB")):
            costs = {alg: allreduce_cost(alg, n, nbytes, link) for alg in TABLE_III_ALGS}
            best = min(costs, key=costs.get)
            for alg, c in costs.items():
                rows.append(Row(f"tableIII/{alg}/n{n}/{tag}", 0.0, f"{c*1e6:.1f}us"))
            rows.append(Row(f"tableIII/best/n{n}/{tag}", 0.0, best))
    # the paper's qualitative statements
    big, small = 4 * 25_000_000, 4 * 1024
    assert allreduce_cost("ring", 256, big, link) < allreduce_cost("binary_tree", 256, big, link)
    assert allreduce_cost("double_binary_tree", 512, small, link) < \
        allreduce_cost("ring", 512, small, link)
    rows.append(Row("tableIII/claims_validated", 0.0, True))
    return rows


def run(device: str | torch.device = "cuda", out: str | None = None) -> list[Row]:
    rows = table()
    write_record({"rows": rows_record(rows)}, out, BENCH_PATH, torch.device(device))
    return rows


if __name__ == "__main__":
    sys.exit(table_main(run, __doc__))
