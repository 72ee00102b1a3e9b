"""Paper section VII on the port (the twin of ``benchmarks/schedule_table.py``):
iteration time under sequential, WFBP, MG-WFBP and pipelined (staleness 0
and 1) schedules for a ResNet-50-like and a transformer-like layer
profile, with MG-WFBP's bucket size swept, on the schedule substrate
(``core/schedule.py``), and the reference's assertions: each schedule no
slower than the one it refines, staleness-1 pipelining dominating the
producer-ordered ones, the saving equal to no-overlap minus iteration time.

    PYTHONPATH=src python -m repro_torch.benchmarks.schedule_table [--out PATH]

Pure arithmetic on the host: ``--device`` is accepted and unused.  The
record goes to ``BENCH_torch_schedule.json`` at the repository root (or
``--out``).
"""

from __future__ import annotations

import sys

import torch

from repro_torch.benchmarks.common import ROOT, Row, rows_record, table_main, write_record
from repro_torch.experiments import Scenario
from repro_torch.experiments.runner import run_scenario

BENCH_PATH = ROOT / "BENCH_torch_schedule.json"
LINK = dict(alpha=2e-4, beta=1 / 10e9)


def table() -> list[Row]:
    rows: list[Row] = []
    for profile in ("resnet50", "transformer32"):
        base = None
        times = {}
        saving = {}
        grid = (("sequential", 0, 1), ("wfbp", 0, 1), ("mgwfbp", 8e6, 1),
                ("mgwfbp", 64e6, 1), ("pipelined", 8e6, 0), ("pipelined", 8e6, 1))
        for mode, bucket, stale in grid:
            s = Scenario(schedule=mode, bucket_bytes=bucket, layer_profile=profile,
                         n_workers=64, overlap_staleness=stale, **LINK)
            res = run_scenario(s, "schedule")
            m = res.measured
            times[(mode, bucket, stale)] = m["iter_time"]
            saving[(mode, bucket, stale)] = m["overlap_saving"]
            tag = mode if bucket == 0 else f"{mode}_{int(bucket/1e6)}MB"
            if mode == "pipelined":
                tag += f"_s{stale}"
            if base is None:
                base = m["iter_time"]
            rows.append(Row(
                f"schedule/{profile}/{tag}", 0.0,
                f"iter={m['iter_time']*1e3:.2f}ms msgs={int(m['n_messages'])} "
                f"speedup={base/m['iter_time']:.2f}x "
                f"saving={m['overlap_saving']*1e3:.2f}ms "
                f"(pred no-overlap {res.predicted['no_overlap_time']*1e3:.2f}ms)",
            ))
            # overlap_saving is no_overlap - iter_time
            assert abs((m["bwd_time"] + m["total_comm_time"] - m["iter_time"])
                       - m["overlap_saving"]) < 1e-12
        assert times[("wfbp", 0, 1)] <= times[("sequential", 0, 1)] + 1e-9
        assert times[("mgwfbp", 8e6, 1)] <= times[("wfbp", 0, 1)] + 1e-9
        # staleness-1 pipelining dominates every producer-ordered schedule
        # (messages start at t=0) and its saving caps at min(bwd, comm)
        assert times[("pipelined", 8e6, 1)] <= times[("mgwfbp", 8e6, 1)] + 1e-9
        assert times[("pipelined", 8e6, 1)] <= times[("pipelined", 8e6, 0)] + 1e-9
        assert saving[("pipelined", 8e6, 1)] >= saving[("mgwfbp", 8e6, 1)] - 1e-9
        assert abs(saving[("sequential", 0, 1)]) < 1e-12
    rows.append(Row("schedule/claims_validated", 0.0, True))
    return rows


def run(device: str | torch.device = "cuda", out: str | None = None) -> list[Row]:
    rows = table()
    write_record({"rows": rows_record(rows)}, out, BENCH_PATH, torch.device(device))
    return rows


if __name__ == "__main__":
    sys.exit(table_main(run, __doc__))
