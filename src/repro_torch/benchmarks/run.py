"""The port's benchmark orchestrator (the twin of ``benchmarks/run.py``): one
module per paper table or figure, under the reference's tags.

    PYTHONPATH=src python -m repro_torch.benchmarks.run \\
        [--only tableIII_allreduce,fig6_compression] [--no-speedup] [--device cpu] \\
        [--out-dir DIR]

Prints ``name,us_per_call,derived`` CSV.  Each module asserts its table's
claims (the rows named ``*/claims_validated``) and writes its own
``BENCH_torch_*.json`` at the repository root, or under ``--out-dir``;
never a reference record.  ``--no-speedup`` skips the loop and per-cell
baselines (the convergence and sweep modules' denominators); ``--device``
(default cuda) reaches every module.
"""

from __future__ import annotations

import argparse
import importlib
import inspect
import sys
import time
import traceback
from pathlib import Path

MODULES = (
    ("tableIII_allreduce", "repro_torch.benchmarks.allreduce_table"),
    ("tableIV_comm_cost", "repro_torch.benchmarks.comm_cost_table"),
    ("tableII_fig4_sync", "repro_torch.benchmarks.sync_timeline"),
    ("fig6_compression", "repro_torch.benchmarks.compression_fidelity"),
    ("tableIV_convergence", "repro_torch.benchmarks.convergence"),
    ("sweep_batched", "repro_torch.benchmarks.sweep"),
    ("sec7_schedule", "repro_torch.benchmarks.schedule_table"),
    ("sec7_overlap", "repro_torch.benchmarks.overlap_bench"),
    ("elastic", "repro_torch.benchmarks.churn_bench"),
    ("kernels", "repro_torch.benchmarks.kernels_bench"),
    ("train_micro", "repro_torch.benchmarks.train_micro"),
    ("coldstart", "repro_torch.benchmarks.coldstart_bench"),
)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python -m repro_torch.benchmarks.run",
                                description=__doc__.split("\n\n")[0])
    p.add_argument("--only", default="", help="comma-separated module tags")
    p.add_argument("--no-speedup", action="store_true",
                   help="skip the loop-reference and per-cell baselines (the heavy "
                        "denominators of the convergence and sweep speedup rows), "
                        "forwarded to the modules whose run() takes no_speedup")
    p.add_argument("--device", default="cuda", help="default cuda; cpu to run without a card")
    p.add_argument("--out-dir", default="",
                   help="write each module's record here (default: the repository root)")
    args = p.parse_args(argv)
    only = set(args.only.split(",")) if args.only else None
    unknown = (only or set()) - {tag for tag, _ in MODULES}
    if unknown:
        p.error(f"--only: unknown tags {sorted(unknown)}")

    print("name,us_per_call,derived")
    failures = []
    for tag, modname in MODULES:
        if only and tag not in only:
            continue
        t0 = time.perf_counter()
        try:
            mod = importlib.import_module(modname)
            params = inspect.signature(mod.run).parameters
            kwargs = {"no_speedup": args.no_speedup} if "no_speedup" in params else {}
            out = None
            if args.out_dir:
                out = str(Path(args.out_dir) / Path(mod.BENCH_PATH).name)
            for row in mod.run(args.device, out, **kwargs):
                print(row.csv())
            print(f"# {tag} done in {time.perf_counter() - t0:.1f}s", flush=True)
        except Exception as e:  # noqa: BLE001  (report every module's failure)
            traceback.print_exc()
            failures.append((tag, repr(e)))
    if failures:
        print("# FAILURES:", failures)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
