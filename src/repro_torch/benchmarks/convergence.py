"""Paper section VIII on the port (the twin of ``benchmarks/convergence.py``):
convergence against communicated bits for twelve taxonomy cells
(BSP / SSP / ASP / local SGD x PS / all-reduce / gossip x none / quantized
/ sparsified) on the strongly convex testbed, run by the convergence
engine (``core/simulate.py``) on ``--device``, and the O(1/T) rate
exponent fitted to BSP over 600 steps.  Asserts the section's relations:
BSP at least as accurate as ASP and as local SGD (within 0.05).  Unless
``--no-speedup``, the engine is timed against the per-step loop reference
on the fixed speedup cell, and, as in the reference, must be at least 10x
faster warm.

    PYTHONPATH=src python -m repro_torch.benchmarks.convergence [--device cpu] [--no-speedup]

The record goes to ``BENCH_torch_convergence.json`` at the repository root
(or ``--out``).
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from repro_torch.benchmarks.common import ROOT, Row, rows_record, table_main, write_record
from repro_torch.experiments import Scenario
from repro_torch.experiments.runner import measure_engine_speedup, run_scenario, run_scenarios

BENCH_PATH = ROOT / "BENCH_torch_convergence.json"
BASE = dict(n_workers=8, steps=400, lr=0.02, grad_noise=0.05, seed=0)

CELLS = [
    Scenario(sync="bsp", **BASE),
    Scenario(sync="bsp", compressor="qsgd", compressor_kwargs={"levels": 16}, **BASE),
    Scenario(sync="bsp", compressor="qsgd_kernel", error_feedback=True, **BASE),
    Scenario(sync="bsp", compressor="topk", compressor_kwargs={"ratio": 0.05},
             error_feedback=True, **BASE),
    Scenario(sync="bsp", compressor="signsgd_packed", error_feedback=True,
             **{**BASE, "lr": 0.005}),
    Scenario(sync="ssp", staleness=4, arch="ps", **BASE),
    Scenario(sync="asp", staleness=4, arch="ps", **BASE),
    Scenario(sync="asp", staleness=4, arch="ps", compressor="terngrad", **BASE),
    Scenario(sync="local", local_steps=8, **BASE),
    Scenario(sync="local", local_steps=8, compressor="qsgd",
             compressor_kwargs={"levels": 16}, **BASE),
    Scenario(sync="bsp", arch="gossip", **BASE),
    Scenario(sync="bsp", arch="gossip", compressor="topk",
             compressor_kwargs={"ratio": 0.1}, error_feedback=True, **BASE),
]


def cells(device: str | torch.device = "cuda", draws=None) -> list:
    """The twelve cells' results on the engine (``draws``: its noise
    factory, default seeded generators)."""
    return run_scenarios(CELLS, "training", device=device, draws=draws)


def rate_exponent(loss: np.ndarray) -> float:
    """-slope of log(loss - final) against log t over steps 40-299."""
    floor = loss[-1]
    t = np.arange(40, 300)
    y = np.maximum(loss[40:300] - floor, 1e-9)
    return float(-np.polyfit(np.log(t), np.log(y), 1)[0])


def table(device: str | torch.device = "cuda", no_speedup: bool = False
          ) -> tuple[list[Row], dict]:
    rows: list[Row] = []
    errs = {}
    record: dict = {"cells": []}
    for res in cells(device):
        s, m = res.scenario, res.measured
        errs[(s.sync, s.arch, s.compressor)] = m["x_star_err"]
        record["cells"].append({"tag": res.tag, "measured": dict(m)})
        rows.append(Row(
            f"convergence/{res.tag}", 0.0,
            f"x_err={m['x_star_err']:.3f} loss={m['final_loss']:.2f} "
            f"Gbits={m['gbits']:.2f} (pred {res.predicted['bits_per_element']:.1f}b/elem)",
        ))
    # section VIII: BSP best or equal in accuracy; staleness degrades; local
    # SGD trades accuracy for ~8x less communication
    assert errs[("bsp", "allreduce", None)] <= errs[("asp", "ps", None)] + 0.05, errs
    assert errs[("bsp", "allreduce", None)] <= errs[("local", "allreduce", None)] + 0.05, errs
    rows.append(Row("convergence/claims_validated", 0.0, True))

    # O(1/T) rate fit for BSP on the strongly convex problem
    res = run_scenario(Scenario(sync="bsp", **{**BASE, "steps": 600}), "training",
                       device=device)
    p = rate_exponent(res.series["loss"][0])
    record["rate_exponent_bsp"] = p
    rows.append(Row("convergence/rate_exponent_bsp", 0.0, f"{p:.2f}"))

    # the engine against the per-step loop; --no-speedup skips the loop
    if not no_speedup:
        sp = measure_engine_speedup(device=device)
        record["engine_speedup"] = sp
        rows.append(Row(
            "convergence/engine_speedup", sp["engine_s_warm"] * 1e6,
            f"{sp['speedup_warm']:.0f}x warm / {sp['speedup_cold']:.1f}x cold "
            f"vs reference ({sp['reference_s']:.1f}s) on {sp['cell']}",
        ))
        assert sp["speedup_warm"] >= 10.0, sp
    return rows, record


def run(device: str | torch.device = "cuda", out: str | None = None,
        no_speedup: bool = False) -> list[Row]:
    device = torch.device(device)
    rows, record = table(device, no_speedup)
    write_record({**record, "rows": rows_record(rows)}, out, BENCH_PATH, device)
    return rows


if __name__ == "__main__":
    sys.exit(table_main(run, __doc__, no_speedup=True))
