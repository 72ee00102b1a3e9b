"""Scenario-matrix sweep CLI (the port's counterpart of
``python -m repro.experiments.run``).

    PYTHONPATH=src python -m repro_torch.experiments.run \
        --substrate timeline \
        --grid "sync=bsp,local,asp arch=ps,allreduce,gossip compressor=none,qsgd:levels=16" \
        --workers 16 --steps 120 --replicas 1

``--grid`` is a space-separated list of ``field=v1,v2,...`` axes (any
Scenario field).  Compressor values may carry kwargs after colons:
``topk:ratio=0.05``.  Invalid taxonomy cells (e.g. all-reduce x ASP) are
dropped and reported on stderr.  The default grid sweeps the paper's sync x
architecture x compression matrix and prints a Table II-style comparison of
measured against cost-model-predicted time and bytes.

``--substrate training`` runs the convergence engine on ``--device``
(default ``cuda``), one batch per shape class, however many cells vary the
values (lr, staleness, H, compressor knobs, problem seed); ``--emit-json``
records the class programs built next to the cells/s, and the batched
engine against the loop reference on the fixed speedup cell
(``--no-speedup`` skips it).

``--substrate trainer`` runs the cells through the real trainer on the tiny
workload, on ``--device``, W workers stacked on one device.  The worker
count is selected per cell as in the reference (the largest that fits the
devices and the scenario and divides the batch; cells that cannot run are
skipped with the reason on stderr), reading the reference's own cap,
``min(max n_workers, 8)``, as the devices available.  The sweep is grouped
by trainer shape class, so the cells of a class share one bundle build
(``--emit-json`` gains the ``bundle`` block: classes, builds, hits,
cells/s).  The overlap axis runs here too (``overlap=sequential,pipelined
microbatch=4``): a pipelined cell carries the predicted overlap saving and,
when its sequential twin is in the sweep, the measured one.

``--substrate roofline`` emits the analytic per-cell compute, memory and
collective terms with the H100's constants.

``--cache-dir`` (default ``$REPRO_TORCH_CACHE_DIR``) is the persistent
cache of :mod:`repro_torch.core.compilecache`: the kernel libraries, the
shape-class manifest and the bundles' wire artifacts.  ``--calibration``
names a fitted profile (:mod:`repro_torch.core.calibrate`) for the
predicted columns; by default ``<cache-dir>/calibration.json`` is adopted
when it was fitted on this machine and device, and ``none`` forces the
data-sheet constants.  Every ``--emit-json`` record carries the
``persistent_cache`` counts and whether it was ``calibrated``.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time

from repro_torch.experiments.scenario import Scenario, expand, grid

DEFAULT_GRID = "sync=bsp,local,asp arch=ps,allreduce,gossip compressor=none,qsgd:levels=16"

_FIELD_TYPES = {f.name: f.type for f in dataclasses.fields(Scenario)}


def _num(v: str):
    try:
        return int(v)
    except ValueError:
        try:
            return float(v)
        except ValueError:
            return v


def _coerce(field: str, raw: str):
    t = _FIELD_TYPES.get(field, "str")
    if field == "compressor":
        if raw in ("none", ""):
            return None, ()
        name, _, rest = raw.partition(":")
        kwargs = []
        for part in rest.split(":") if rest else []:
            k, _, v = part.partition("=")
            kwargs.append((k, _num(v)))
        return name, tuple(kwargs)
    if raw in ("true", "True"):
        return True
    if raw in ("false", "False"):
        return False
    if "int" in str(t):
        return int(raw)
    if "float" in str(t):
        return float(raw)
    return raw


def parse_grid(spec: str, **base) -> list[Scenario]:
    """``"sync=bsp,local arch=ps"`` -> the raw scenario cross-product."""
    axes: dict[str, list] = {}
    comp_pairs: list[tuple] | None = None
    for part in spec.split():
        field, _, vals = part.partition("=")
        if not vals:
            raise ValueError(f"malformed grid axis {part!r} (want field=v1,v2)")
        if field == "compressor":
            comp_pairs = [_coerce("compressor", v) for v in vals.split(",")]
        else:
            axes[field] = [_coerce(field, v) for v in vals.split(",")]
    scenarios = grid(**{**{k: [v] for k, v in base.items()}, **axes})
    if comp_pairs is not None:
        # each (name, kwargs) pair is one axis value: one compressor may
        # appear twice with different kwargs
        scenarios = [s.replace(compressor=name, compressor_kwargs=kw)
                     for s in scenarios for name, kw in comp_pairs]
    return scenarios


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m repro_torch.experiments.run",
        description="sweep the survey's taxonomy matrix and emit a comparison table",
    )
    p.add_argument("--grid", default=DEFAULT_GRID, help=f"axis spec (default: {DEFAULT_GRID!r})")
    p.add_argument("--substrate", default="timeline",
                   choices=("timeline", "training", "schedule", "roofline", "trainer"))
    p.add_argument("--workers", type=int, default=16)
    p.add_argument("--steps", type=int, default=120)
    p.add_argument("--replicas", type=int, default=1,
                   help="seeds per scenario (every class batches them)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--lr", type=float, default=0.05)
    p.add_argument("--straggler", type=float, default=1.0,
                   help="multiplicative slowdown of worker 0 (timeline)")
    p.add_argument("--msg-mb", type=float, default=100.0, help="dense gradient size (MB)")
    p.add_argument("--alpha", type=float, default=1e-3, help="link latency (s)")
    p.add_argument("--beta", type=float, default=1e-9, help="link s/byte")
    p.add_argument("--format", default="table", choices=("table", "csv"))
    p.add_argument("--out", default="", help="write the table here as well as stdout")
    p.add_argument("--emit-json", default="", metavar="PATH",
                   help="write a JSON record: per-cell measured metrics, cost-model "
                        "predictions, relative error, sweep wall clock, and (training) "
                        "the batched engine against the loop reference")
    p.add_argument("--no-speedup", action="store_true",
                   help="skip the engine-against-loop measurement in --emit-json")
    p.add_argument("--device", default="cuda",
                   help="the training engine's and the trainer's device (default cuda; cpu to "
                        "run without a card)")
    p.add_argument("--cache-dir", default=os.environ.get("REPRO_TORCH_CACHE_DIR", ""),
                   metavar="DIR",
                   help="persistent cache: kernel libraries, the shape-class manifest and "
                        "the bundles' wire artifacts, reused by later processes (default: "
                        "$REPRO_TORCH_CACHE_DIR)")
    p.add_argument("--calibration", default="", metavar="PATH",
                   help="fitted cost-model profile (repro_torch.core.calibrate) for the "
                        "predicted columns; empty = adopt <cache-dir>/calibration.json when "
                        "it was fitted here; 'none' = the data-sheet constants")
    args = p.parse_args(argv)
    _configure_cache_and_calibration(args)

    base = dict(n_workers=args.workers, steps=args.steps, seed=args.seed, lr=args.lr,
                straggler_slowdown=args.straggler, msg_bytes=args.msg_mb * 1e6,
                alpha=args.alpha, beta=args.beta)
    raw = parse_grid(args.grid, **base)
    scenarios = expand(raw, substrate=args.substrate)
    dropped = [s for s in raw if s not in scenarios]
    for s in dropped:
        print(f"# dropped invalid cell {s.tag()}: {'; '.join(s.violations(args.substrate))}",
              file=sys.stderr)
    if not scenarios:
        print("no valid scenarios in the grid", file=sys.stderr)
        return 1
    print(f"# sweeping {len(scenarios)} scenarios on the {args.substrate} substrate "
          f"({len(dropped)} invalid cells dropped)", file=sys.stderr)

    if args.substrate == "trainer":
        return _trainer_sweep(args, scenarios)

    from repro_torch.core.simulate import engine_cache_stats
    from repro_torch.experiments.runner import (
        measure_engine_speedup,
        run_scenarios,
        training_shape_key,
    )
    from repro_torch.experiments.tables import format_csv, format_table

    st0 = dataclasses.replace(engine_cache_stats())
    t0 = time.perf_counter()
    results = run_scenarios(scenarios, args.substrate, replicas=args.replicas,
                            device=args.device)
    sweep_s = time.perf_counter() - t0
    title = (f"{args.substrate} sweep: {len(results)} cells, "
             f"n={args.workers}, steps={args.steps}")
    text = format_table(results, title=title) if args.format == "table" else format_csv(results)
    print(text)
    if args.out:
        with open(args.out, "w") as f:
            f.write(text)
    if args.emit_json:
        record = emit_json_record(results, sweep_s)
        if args.substrate == "training":
            st1 = engine_cache_stats()
            record["engine"] = {
                "n_shape_classes": len({training_shape_key(s) for s in scenarios}),
                "compiles": st1.compiles - st0.compiles,
                "cache_hits": st1.hits - st0.hits,
                "cells_per_s": len(results) / sweep_s,
                "device": args.device,
                "persistent_cache": st1.persistent_cache,
            }
            if not args.no_speedup:
                record["engine_speedup"] = measure_engine_speedup(device=args.device)
        with open(args.emit_json, "w") as f:
            json.dump(record, f, indent=2)
        print(f"# wrote {args.emit_json}", file=sys.stderr)
    return 0


def _configure_cache_and_calibration(args) -> None:
    """Apply ``--cache-dir`` and ``--calibration``: an explicit path is
    loaded as given, ``none`` deactivates, and by default the profile next
    to the cache is adopted when its fingerprint is this process's on
    ``--device``."""
    from repro_torch.core import calibrate, compilecache

    if args.cache_dir:
        compilecache.configure(args.cache_dir)
    if args.calibration == "none":
        calibrate.set_active(None)
    elif args.calibration:
        calibrate.set_active(calibrate.CalibrationProfile.load(args.calibration))
    else:
        profile = calibrate.load_default(args.device)
        if profile is not None:
            print(f"# calibration: adopted {calibrate.default_path()}", file=sys.stderr)
            calibrate.set_active(profile)


def _trainer_sweep(args, scenarios) -> int:
    """The ``--substrate trainer`` lane: ``run_trainer_sweep`` over the
    cells with the worker count selected per cell, grouped by trainer shape
    class (``bundle_cache_stats`` lands in the ``--emit-json`` record)."""
    from repro_torch.experiments.tables import format_csv, format_table
    from repro_torch.experiments.trainer_substrate import (
        run_trainer_sweep,
        select_trainer_device_count,
        stacked_devices,
        trainer_shape_key,
    )
    from repro_torch.train.steps import bundle_cache_stats

    ndev = stacked_devices(scenarios)
    st0 = dataclasses.replace(bundle_cache_stats())
    t0 = time.perf_counter()
    all_results, skip_reasons = run_trainer_sweep(scenarios, n_devices=ndev, verbose=True,
                                                  device=args.device)
    sweep_s = time.perf_counter() - t0
    for s, why in skip_reasons:
        print(f"# skip {s.tag()}: {why}", file=sys.stderr)
    results = [r for r in all_results if r is not None]
    skipped = len(skip_reasons)
    if not results:
        print(f"# no trainer cells runnable ({skipped} skipped)", file=sys.stderr)
        return 0
    st1 = bundle_cache_stats()
    builds, hits = st1.builds - st0.builds, st1.hits - st0.hits
    n_classes = len({trainer_shape_key(r.scenario,
                                       data_par=select_trainer_device_count(r.scenario, ndev)[0])
                     for r in results})
    print(f"# bundle cache: {len(results)} cells, {builds} builds, {hits} hits", file=sys.stderr)
    title = (f"trainer sweep: {len(results)} cells ({skipped} skipped), at most {ndev} "
             f"workers stacked on {args.device}, steps={args.steps}, {builds} bundle builds")
    text = format_table(results, title=title) if args.format == "table" else format_csv(results)
    print(text)
    if args.out:
        with open(args.out, "w") as f:
            f.write(text)
    if args.emit_json:
        record = emit_json_record(results, sweep_s)
        record["bundle"] = {
            "n_shape_classes": n_classes,
            "builds": builds,
            "cache_hits": hits,
            "cells_per_s": len(results) / sweep_s,
            "device": args.device,
            "persistent_cache": st1.persistent_cache,
        }
        with open(args.emit_json, "w") as f:
            json.dump(record, f, indent=2)
        print(f"# wrote {args.emit_json}", file=sys.stderr)
    return 0


def emit_json_record(results, sweep_s: float) -> dict:
    """Measured against predicted per cell (and the relative error on the
    keys they share) and the sweep wall clock."""
    cells = []
    for r in results:
        rel_err = {
            k: abs(r.measured[k] - r.predicted[k]) / max(abs(r.predicted[k]), 1e-30)
            for k in r.measured
            if k in r.predicted
            and isinstance(r.measured[k], (int, float))
            and isinstance(r.predicted[k], (int, float))
        }
        cells.append({
            "tag": r.tag,
            "replicas": r.replicas,
            "measured": dict(r.measured),
            "predicted": dict(r.predicted),
            "rel_err": rel_err,
        })
    from repro_torch.core import calibrate, compilecache

    return {
        "substrate": results[0].substrate if results else "",
        "n_cells": len(results),
        "sweep_wall_clock_s": sweep_s,
        # on every lane: the persistent cache's hits and misses at each
        # layer's key granularity, and whether the predicted columns used a
        # fitted profile
        "persistent_cache": {"engine": compilecache.record("engine"),
                             "bundle": compilecache.record("bundle")},
        "calibrated": calibrate.get_active() is not None,
        "cells": cells,
    }


if __name__ == "__main__":
    sys.exit(main())
