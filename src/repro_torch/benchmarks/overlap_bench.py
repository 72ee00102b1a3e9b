"""Section VII made executable on the port's trainer (the twin of
``benchmarks/overlap_bench.py``): sequential against microbatch-pipelined
bucketed aggregation x two bucket sizes x {none, qsgd, topk} compressors.
Per cell it records the measured step time, the wire bytes and, for a
pipelined cell, the measured overlap saving against its sequential twin
beside the ``simulate_schedule`` prediction.  Asserts, as the reference:

* every pipelined cell's final loss within 1.05x of its sequential twin's,
  the band the engine's ``ssp(s=1)`` reference sits in (also asserted);
* a pipelined cell bit-reproducible across bundle-registry hits;
* at most one bundle build per shape class, and the two knob-traced
  siblings of one pipelined class (qsgd levels, ``stale_scale``) hits.

No gain of the pipelined step is asserted (the reference does not either).

    PYTHONPATH=src python -m repro_torch.benchmarks.overlap_bench [--device cpu] [--out PATH]

The reference runs W = 2 on forced host devices; here the 2 workers are
stacked on ``--device`` (default cuda), under deterministic algorithms.  The
record goes to ``BENCH_torch_overlap.json`` at the repository root (or
``--out``) with the device it was measured on.
"""

from __future__ import annotations

import sys
import time

import numpy as np
import torch

from repro_torch.benchmarks.common import (
    ROOT,
    Row,
    deterministic,
    sync,
    table_main,
    write_record,
)
from repro_torch.experiments.scenario import Scenario

BENCH_PATH = ROOT / "BENCH_torch_overlap.json"

#: the compressor axis: dense, quantized (unbiased, no EF), sparse with EF
FAMILIES = ((None, {}, False),
            ("qsgd", {"levels": 16}, False),
            ("topk", {"ratio": 0.05}, True))


def overlap_matrix(*, steps: int = 16, n_workers: int = 2, microbatch: int = 4,
                   seed: int = 0) -> list[Scenario]:
    """3 compressor families x 2 bucket sizes x {sequential, pipelined} = 12
    cells in 12 shape classes, plus 2 knob-traced siblings of one pipelined
    class (qsgd levels, stale_scale): 14 cells, 12 builds."""
    cells = []
    for comp, kw, ef in FAMILIES:
        for bucket in (0.0, 0.25e6):
            for overlap in ("sequential", "pipelined"):
                cells.append(Scenario(
                    sync="bsp", n_workers=n_workers, steps=steps, lr=0.05, compressor=comp,
                    compressor_kwargs=kw, error_feedback=ef,
                    schedule="mgwfbp" if bucket else "wfbp", bucket_bytes=bucket,
                    overlap=overlap, microbatch=microbatch, seed=seed))
    sib = next(c for c in cells
               if c.overlap == "pipelined" and c.compressor == "qsgd" and c.bucket_bytes == 0)
    cells.append(sib.replace(compressor_kwargs={"levels": 8}))
    cells.append(sib.replace(stale_scale=0.5))
    return cells


def _staleness_reference(device: torch.device) -> dict:
    """The engine's ssp(s=1) convergence reference: staleness 1 leaves the
    final loss within a whisker of the synchronous trajectory."""
    from repro_torch.core.simulate import SimCfg, simulate_training_batch

    bsp = simulate_training_batch(SimCfg(n_workers=8, sync="bsp", steps=200, lr=0.05, seed=0),
                                  device=device)[0]
    ssp = simulate_training_batch(SimCfg(n_workers=8, sync="ssp", staleness=1, steps=200,
                                         lr=0.05, seed=0), device=device)[0]
    return {"sim_bsp_final_loss": float(bsp["loss"][-1]),
            "sim_ssp1_final_loss": float(ssp["loss"][-1]),
            "sim_ssp1_ratio": float(ssp["loss"][-1] / bsp["loss"][-1])}


def measure(device: str | torch.device = "cuda", steps: int = 16) -> dict:
    """The 14-cell sweep of ``steps`` steps and its assertions; returns the
    record."""
    from repro_torch.experiments.trainer_substrate import (
        _overlap_twin,
        run_trainer_scenario,
        run_trainer_sweep,
        stacked_devices,
        trainer_shape_key,
    )
    from repro_torch.train.steps import bundle_cache_clear, bundle_cache_stats

    device = torch.device(device)
    cells = overlap_matrix(steps=steps)
    ndev = stacked_devices(cells)
    classes = {trainer_shape_key(s, data_par=min(s.n_workers, ndev)) for s in cells}
    bundle_cache_clear()
    t0 = time.perf_counter()
    results, skipped = run_trainer_sweep(cells, n_devices=ndev, device=device)
    sync(device)
    sweep_s = time.perf_counter() - t0
    assert not skipped, skipped
    st = bundle_cache_stats()
    assert st.builds <= len(classes), (st, len(classes))
    assert st.hits == len(cells) - st.builds, st

    by_cell = {r.scenario: r for r in results}
    pair_rows, worst_ratio = [], 0.0
    for r in results:
        s = r.scenario
        twin = by_cell.get(_overlap_twin(s)) if s.overlap == "pipelined" else None
        if twin is None:
            continue
        ratio = r.measured["final_loss"] / twin.measured["final_loss"]
        worst_ratio = max(worst_ratio, ratio)
        pair_rows.append({"tag": r.tag, "sequential_tag": twin.tag,
                          "loss_ratio_vs_sequential": ratio,
                          "measured_overlap_saving_s": r.measured.get("overlap_saving_s"),
                          "predicted_overlap_saving_s": r.predicted.get("overlap_saving_s")})

    # staleness 1 costs at most a few percent of final loss, the band of the
    # engine's ssp(s=1) reference
    ref = _staleness_reference(device)
    assert ref["sim_ssp1_ratio"] < 1.05, ref
    assert worst_ratio < 1.05, (worst_ratio, pair_rows)

    # a pipelined cell re-run through the registry's shared build is exact
    cell = next(s for s in cells if s.overlap == "pipelined" and s.compressor is None)
    again = run_trainer_scenario(cell, data_par=min(cell.n_workers, ndev), device=device)
    np.testing.assert_array_equal(again.series["loss_full"], by_cell[cell].series["loss_full"],
                                  err_msg="pipelined cell not bit-reproducible across "
                                          "bundle-registry hits")
    return {
        "n_cells": len(cells),
        "n_shape_classes": len(classes),
        "steps": cells[0].steps,
        "microbatch": cells[0].microbatch,
        "n_workers_stacked": ndev,
        "builds": st.builds,
        "cache_hits": st.hits,
        "sweep_wall_clock_s": sweep_s,
        "worst_pipelined_loss_ratio": worst_ratio,
        "staleness_reference": ref,
        "pairs": pair_rows,
        "cells": [{"tag": r.tag, "measured": dict(r.measured), "predicted": dict(r.predicted)}
                  for r in results],
    }


def run(device: str | torch.device = "cuda", out: str | None = None) -> list[Row]:
    device = torch.device(device)
    with deterministic():
        record = measure(device)
    write_record(record, out, BENCH_PATH, device)
    return [
        Row("overlap/sweep", record["sweep_wall_clock_s"] * 1e6,
            f"{record['n_cells']} cells -> {record['n_shape_classes']} classes, "
            f"{record['builds']} builds ({record['cache_hits']} hits)"),
        Row("overlap/loss_ratio", 0.0,
            f"worst pipelined/sequential={record['worst_pipelined_loss_ratio']:.4f} "
            f"(sim ssp1 ref {record['staleness_reference']['sim_ssp1_ratio']:.4f})"),
        Row("overlap/claims_validated", 0.0, True),
    ]


if __name__ == "__main__":
    sys.exit(table_main(run, __doc__))
