"""The shape-class batched sweep on the port (the twin of
``benchmarks/sweep.py``): the 45-cell perf-tracking matrix (5 sync and
topology schemes x qsgd levels 4/8/16 x 3 learning rates, qsgd with EF)
over 2 problem seeds, 90 cells in 5 shape classes, 3 replicas, on the
convergence engine.  It must build one class program per class.  Unless
``--no-speedup``, the per-cell path (a fresh program per cell) runs too,
and, as in the reference, the batched sweep must be at least 5x faster and
reproduce it (loss within 2e-4, bits within 1e-6).

    PYTHONPATH=src python -m repro_torch.benchmarks.sweep [--device cpu] [--no-speedup]

The record goes to ``BENCH_torch_sweep.json`` at the repository root (or
``--out``); the reference's ``BENCH_sweep.json`` is never written.
"""

from __future__ import annotations

import sys

import torch

from repro_torch.benchmarks.common import ROOT, Row, table_main, write_record

BENCH_PATH = ROOT / "BENCH_torch_sweep.json"


def measure(device: str | torch.device = "cuda", no_speedup: bool = False) -> dict:
    from repro_torch.experiments.runner import measure_sweep_speedup, sweep_matrix_45

    return measure_sweep_speedup(sweep_matrix_45(problem_seeds=(0, 1)), replicas=3,
                                 percell=not no_speedup, device=device)


def run(device: str | torch.device = "cuda", out: str | None = None,
        no_speedup: bool = False) -> list[Row]:
    device = torch.device(device)
    rec = measure(device, no_speedup)
    rows = [
        Row("sweep/shape_classes", 0.0,
            f"{rec['n_cells']} cells ({rec['n_problem_instances']} problem "
            f"instances) -> {rec['n_shape_classes']} classes "
            f"(were {rec['n_classes_without_shared_problems']} before "
            f"problem-data threading), {rec['compiles_batched']} compiles"),
        Row("sweep/batched", rec["batched_s"] * 1e6,
            f"{rec['cells_per_s_batched']:.1f} cells/s "
            f"({rec['n_cells']} cells x {rec['replicas']} replicas, "
            f"{rec['steps']} steps)"),
    ]
    assert rec["compiles_batched"] == rec["n_shape_classes"], rec
    if not no_speedup:
        rows.append(Row(
            "sweep/speedup_vs_percell", rec["percell_s"] * 1e6,
            f"{rec['speedup']:.1f}x over {rec['compiles_percell']} per-cell "
            f"compiles; max dev loss={rec['max_rel_dev_loss']:.1e} "
            f"bits={rec['max_rel_dev_bits']:.1e}"))
        # the reference's acceptance: >= 5x, per-cell results reproduced
        assert rec["speedup"] >= 5.0, rec
        assert rec["max_rel_dev_loss"] < 2e-4, rec
        assert rec["max_rel_dev_bits"] < 1e-6, rec
    write_record(rec, out, BENCH_PATH, device)
    rows.append(Row("sweep/claims_validated", 0.0, True))
    return rows


if __name__ == "__main__":
    sys.exit(table_main(run, __doc__, no_speedup=True))
